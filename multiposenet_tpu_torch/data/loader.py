"""Batching data loader, the port of `multiposenet_tpu/data/loader.py`:
records → fixed-shape NumPy batches of padded annotations, augmented on a
prefetching worker thread; targets are made on the device
(data/targets.py). Files are read through `utils/image_io.py` instead of
cv2.

Batch layout (all fixed shapes):
    images:    uint8  [B, S, S, 3]
    keypoints: f32    [B, P, 17, 3]   (x, y, v) in model-input pixels
    boxes:     f32    [B, P, 4]       (y0, x0, y1, x1) model-input pixels
    iscrowd:   bool   [B, P]
    valid:     bool   [B, P]

Random draws follow the JAX package's order, so one seed gives the same
batches bit for bit: the record order from RandomState(seed), the
augmentations from RandomState(seed + 1) on the worker.

Records with segmentation-derived masks (`exclude_mask`/`person_mask`,
from prepare.read_shards) are refused before any work: the coverage maps
need cv2's INTER_AREA and float32 INTER_LINEAR, not ported yet.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

from multiposenet_tpu_torch.data import augment as aug
from multiposenet_tpu_torch.data.coco import pad_record
from multiposenet_tpu_torch.utils.constants import NUM_KEYPOINTS
from multiposenet_tpu_torch.utils.image_io import read_image


def load_image(record: dict, image_dir: str | None) -> np.ndarray:
    """Record → uint8 RGB array. Synthetic records embed the image; COCO
    records reference a file under image_dir (JPEG, PNG or .npy here)."""
    if "image" in record:
        return record["image"]
    if image_dir is None:
        raise ValueError("record has no embedded image and image_dir unset")
    return read_image(Path(image_dir) / record["file_name"])


def check_no_masks(records: list[dict]) -> None:
    """Raise if any record carries segmentation masks."""
    for rec in records:
        if (rec.get("exclude_mask") is not None
                or rec.get("person_mask") is not None):
            raise ValueError(aug.MASKS_NOT_PORTED)


def make_batch(records: list[dict], image_size: int, max_persons: int,
               rng: np.random.RandomState | None = None,
               image_dir: str | None = None,
               train: bool = True) -> dict[str, np.ndarray]:
    """One fixed-shape batch from records (augmented iff train and a rng
    is given, else resized)."""
    check_no_masks(records)
    b = len(records)
    images = np.zeros((b, image_size, image_size, 3), np.uint8)
    keypoints = np.zeros((b, max_persons, NUM_KEYPOINTS, 3), np.float32)
    boxes = np.zeros((b, max_persons, 4), np.float32)
    iscrowd = np.zeros((b, max_persons), bool)
    valid = np.zeros((b, max_persons), bool)
    for i, rec in enumerate(records):
        img = load_image(rec, image_dir)
        kps, bxs = rec["keypoints"], rec["boxes"]
        if train and rng is not None:
            img, kps, bxs, _ = aug.augment_record(rng, img, kps, bxs,
                                                  image_size)
        else:
            img, kps, bxs, _ = aug.resize_to(img, kps, bxs, image_size)
        images[i] = img
        padded = pad_record(
            {"keypoints": kps, "boxes": bxs, "iscrowd": rec["iscrowd"]},
            max_persons)
        keypoints[i] = padded["keypoints"]
        boxes[i] = padded["boxes"]
        iscrowd[i] = padded["iscrowd"]
        valid[i] = padded["valid"]
    return {"images": images, "keypoints": keypoints, "boxes": boxes,
            "iscrowd": iscrowd, "valid": valid}


def batch_iterator(records: list[dict], batch_size: int, image_size: int,
                   max_persons: int, seed: int = 0,
                   image_dir: str | None = None, train: bool = True,
                   augment: bool | None = None,
                   prefetch: int = 2) -> Iterator[dict[str, np.ndarray]]:
    """Infinite (train) or single-pass (eval) prefetching batch iterator.
    `augment` defaults to `train`; augment=False with train=True gives an
    infinite shuffled loop without augmentation. An eval pass pads its
    last batch by repeating the last record. Masked records raise here,
    at the call, before the worker starts."""
    check_no_masks(records)
    if augment is None:
        augment = train
    return _iterate(records, batch_size, image_size, max_persons, seed,
                    image_dir, train, augment, prefetch)


def _iterate(records, batch_size, image_size, max_persons, seed, image_dir,
             train, augment, prefetch):
    rng = np.random.RandomState(seed)

    def gen():
        if train:
            while True:
                idx = rng.permutation(len(records))
                for s in range(0, len(idx) - batch_size + 1, batch_size):
                    yield [records[j] for j in idx[s:s + batch_size]]
        else:
            for s in range(0, len(records), batch_size):
                chunk = [records[j] for j in
                         range(s, min(s + batch_size, len(records)))]
                while len(chunk) < batch_size:
                    chunk.append(chunk[-1])
                yield chunk

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = object()

    def worker():
        wrng = np.random.RandomState(seed + 1)
        try:
            for chunk in gen():
                q.put(make_batch(chunk, image_size, max_persons,
                                 rng=wrng if augment else None,
                                 image_dir=image_dir, train=augment))
        except Exception as exc:  # re-raised in the consumer
            q.put(exc)
            return
        q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        if isinstance(item, Exception):
            raise item
        yield item
