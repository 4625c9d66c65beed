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

Data parallelism (`batch_iterator(..., rank, world_size)`): each rank of
a process group yields its rows of every global batch, and the ranks'
shards concatenated are the single-process batch bit for bit. The draws
come from one sequential stream whose crop draws depend on each image's
size, so every rank replays the stream: it decodes and augments only its
own rows and, for the others', draws what `augment_record` would draw
from the record's size alone (`augment.draw_augmentation`; a file's size
from its header, `image_io.image_size`). Every rank thus loads 1/world
of the images, where a rank 0 that loaded and scattered would load all.
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
from multiposenet_tpu_torch.utils.image_io import (
    image_size as file_image_size, read_image, resize_area)


def load_image(record: dict, image_dir: str | None) -> np.ndarray:
    """Record → uint8 RGB array. Synthetic records embed the image; COCO
    records reference a file under image_dir (any format `read_image`
    reads)."""
    if "image" in record:
        return record["image"]
    if image_dir is None:
        raise ValueError("record has no embedded image and image_dir unset")
    return read_image(Path(image_dir) / record["file_name"])


def record_size(record: dict, image_dir: str | None) -> tuple[int, int]:
    """(height, width) of the image `load_image` gives for the record,
    without decoding a JPEG."""
    if "image" in record:
        return record["image"].shape[:2]
    if image_dir is None:
        raise ValueError("record has no embedded image and image_dir unset")
    return file_image_size(Path(image_dir) / record["file_name"])


def _has_masks(record: dict) -> bool:
    return (record.get("exclude_mask") is not None
            or record.get("person_mask") is not None)


def make_batch(records: list[dict], image_size: int, max_persons: int,
               rng: np.random.RandomState | None = None,
               image_dir: str | None = None, train: bool = True,
               mask_stride: int = 4,
               with_masks: bool | None = None) -> dict[str, np.ndarray]:
    """One fixed-shape batch from records (augmented iff train and a rng
    is given, else resized). If any record carries masks (or
    `with_masks`, for a shard of a batch that has them), the batch gains
    the coverage maps at 1/mask_stride of the image size (zeros and
    has_mask False for a record without masks)."""
    b = len(records)
    hm = image_size // mask_stride
    if with_masks is None:
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
                   mask_stride: int = 4, rank: int = 0,
                   world_size: int = 1) -> Iterator[dict[str, np.ndarray]]:
    """Infinite (train) or single-pass (eval) prefetching batch iterator.
    `augment` defaults to `train`; augment=False with train=True gives an
    infinite shuffled loop without augmentation. An eval pass pads its
    last batch by repeating the last record. `mask_stride` is the model's
    output stride (the coverage maps' grid). With `world_size` > 1 it
    yields rank `rank`'s batch_size / world_size rows of each global
    batch of `batch_size` (the module docstring)."""
    if augment is None:
        augment = train
    if batch_size % world_size or not 0 <= rank < world_size:
        raise ValueError(f"a batch of {batch_size} does not shard over "
                         f"{world_size} ranks (rank {rank})")
    lo = rank * (batch_size // world_size)
    return _batches(records, batch_size, image_size, max_persons, seed,
                    image_dir, train, augment, prefetch, mask_stride, lo,
                    lo + batch_size // world_size)


def _batches(records, batch_size, image_size, max_persons, seed, image_dir,
             train, augment, prefetch, mask_stride, lo, hi):
    """batch_iterator's generator: rows lo:hi of each global batch."""
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

        def replay(chunk):
            for rec in chunk:
                aug.draw_augmentation(wrng, *record_size(rec, image_dir))

        try:
            for chunk in gen():
                if augment:
                    replay(chunk[:lo])
                batch = make_batch(
                    chunk[lo:hi], image_size, max_persons,
                    rng=wrng if augment else None, image_dir=image_dir,
                    train=augment, mask_stride=mask_stride,
                    with_masks=any(_has_masks(r) for r in chunk))
                if augment:
                    replay(chunk[hi:])
                q.put(batch)
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
