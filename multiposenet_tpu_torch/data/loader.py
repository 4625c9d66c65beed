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
plus, when a record of the batch carries segmentation masks
(`exclude_mask` / `person_mask` bool [H, W], from prepare.read_shards):
    exclude_cov: f32 [B, S/stride, S/stride]  crowd and unlabeled coverage
    person_cov:  f32 [B, S/stride, S/stride]  every person's coverage
    has_mask:    bool [B]                      the image had masks
The masks go through the image's augmentation (cv2's float INTER_LINEAR)
and then cv2's INTER_AREA to the heatmap grid, both bit for bit
(`utils/image_io.py`).

Random draws follow the JAX package's order, so one seed gives the same
batches bit for bit: the record order from RandomState(seed), the
augmentations from RandomState(seed + 1) on the worker.
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
from multiposenet_tpu_torch.utils.image_io import read_image, resize_area


def load_image(record: dict, image_dir: str | None) -> np.ndarray:
    """Record → uint8 RGB array. Synthetic records embed the image; COCO
    records reference a file under image_dir (JPEG, PNG or .npy here)."""
    if "image" in record:
        return record["image"]
    if image_dir is None:
        raise ValueError("record has no embedded image and image_dir unset")
    return read_image(Path(image_dir) / record["file_name"])


def _has_masks(record: dict) -> bool:
    return (record.get("exclude_mask") is not None
            or record.get("person_mask") is not None)


def make_batch(records: list[dict], image_size: int, max_persons: int,
               rng: np.random.RandomState | None = None,
               image_dir: str | None = None, train: bool = True,
               mask_stride: int = 4) -> dict[str, np.ndarray]:
    """One fixed-shape batch from records (augmented iff train and a rng
    is given, else resized). If any record carries masks, the batch gains
    the coverage maps at 1/mask_stride of the image size (zeros and
    has_mask False for a record without masks)."""
    b = len(records)
    hm = image_size // mask_stride
    with_masks = any(_has_masks(r) for r in records)
    images = np.zeros((b, image_size, image_size, 3), np.uint8)
    keypoints = np.zeros((b, max_persons, NUM_KEYPOINTS, 3), np.float32)
    boxes = np.zeros((b, max_persons, 4), np.float32)
    iscrowd = np.zeros((b, max_persons), bool)
    valid = np.zeros((b, max_persons), bool)
    if with_masks:
        exclude_cov = np.zeros((b, hm, hm), np.float32)
        person_cov = np.zeros((b, hm, hm), np.float32)
        has_mask = np.zeros((b,), bool)
    for i, rec in enumerate(records):
        img = load_image(rec, image_dir)
        kps, bxs = rec["keypoints"], rec["boxes"]
        masks = None
        if with_masks and _has_masks(rec):
            zero = np.zeros(img.shape[:2], np.float32)
            exc, per = rec.get("exclude_mask"), rec.get("person_mask")
            masks = np.stack([
                zero if exc is None else exc.astype(np.float32),
                zero if per is None else per.astype(np.float32)], axis=-1)
            has_mask[i] = True
        if train and rng is not None:
            img, kps, bxs, masks = aug.augment_record(rng, img, kps, bxs,
                                                      image_size, masks)
        else:
            img, kps, bxs, masks = aug.resize_to(img, kps, bxs, image_size,
                                                 masks)
        images[i] = img
        if masks is not None:
            cov = resize_area(masks, (hm, hm))
            exclude_cov[i] = cov[..., 0]
            person_cov[i] = cov[..., 1]
        padded = pad_record(
            {"keypoints": kps, "boxes": bxs, "iscrowd": rec["iscrowd"]},
            max_persons)
        keypoints[i] = padded["keypoints"]
        boxes[i] = padded["boxes"]
        iscrowd[i] = padded["iscrowd"]
        valid[i] = padded["valid"]
    out = {"images": images, "keypoints": keypoints, "boxes": boxes,
           "iscrowd": iscrowd, "valid": valid}
    if with_masks:
        out.update(exclude_cov=exclude_cov, person_cov=person_cov,
                   has_mask=has_mask)
    return out


def batch_iterator(records: list[dict], batch_size: int, image_size: int,
                   max_persons: int, seed: int = 0,
                   image_dir: str | None = None, train: bool = True,
                   augment: bool | None = None, prefetch: int = 2,
                   mask_stride: int = 4) -> Iterator[dict[str, np.ndarray]]:
    """Infinite (train) or single-pass (eval) prefetching batch iterator.
    `augment` defaults to `train`; augment=False with train=True gives an
    infinite shuffled loop without augmentation. An eval pass pads its
    last batch by repeating the last record. `mask_stride` is the model's
    output stride (the coverage maps' grid)."""
    if augment is None:
        augment = train
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
                                 image_dir=image_dir, train=augment,
                                 mask_stride=mask_stride))
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
