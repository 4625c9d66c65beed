"""Self-contained COCO person-keypoints JSON reader (no pycocotools).
The port's own copy of `multiposenet_tpu/data/coco.py`.

Reference counterpart: `create_tfrecords.py` + pycocotools.COCO parsing
(SURVEY.md §2 "Data prep" row, §3.1). pycocotools is absent in this
environment (SURVEY.md §7), so this module parses the annotation JSON
directly with the stdlib and yields per-image records; there is no tfrecord
stage — the grain/NumPy loader consumes these records directly.

Record layout per image:
    {
      "id": int, "file_name": str, "height": int, "width": int,
      "keypoints": float32 [P, 17, 3]   # (x, y, v) COCO convention
      "boxes":     float32 [P, 4]       # (y0, x0, y1, x1) pixels
      "iscrowd":   bool    [P]
      "area":      float32 [P]
      "segmentation": list [P] of raw COCO segmentation values (polygons /
                      RLE dict / None) — see data/masks.py
    }
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

import numpy as np

from multiposenet_tpu_torch.utils.constants import NUM_KEYPOINTS


def load_coco_keypoints(
    annotations_path: str | Path,
    skip_crowd_only_images: bool = False,
) -> list[dict]:
    """Parse a COCO person_keypoints_*.json into per-image records.

    Images with no person annotation are dropped (the reference "filters
    person images", SURVEY.md §2 Data prep). ALL persons are kept, including
    crowd and keypoint-less ones: crowd is flagged per-person, and persons
    with zero labeled keypoints are masked out of the heatmap loss on device
    (train/steps.py `_device_targets`) rather than filtered here — they still
    train the detector and the segmentation aux head.
    """
    with open(annotations_path) as f:
        data = json.load(f)

    images = {im["id"]: im for im in data.get("images", [])}
    per_image: dict[int, list[dict]] = {}
    for ann in data.get("annotations", []):
        if ann.get("category_id", 1) != 1:
            continue
        per_image.setdefault(ann["image_id"], []).append(ann)

    records = []
    for image_id, anns in sorted(per_image.items()):
        im = images.get(image_id)
        if im is None:
            continue
        kps, boxes, iscrowd, areas, segs = [], [], [], [], []
        for ann in anns:
            k = np.asarray(
                ann.get("keypoints", [0] * NUM_KEYPOINTS * 3),
                dtype=np.float32,
            ).reshape(NUM_KEYPOINTS, 3)
            crowd = bool(ann.get("iscrowd", 0))
            x, y, w, h = ann["bbox"]
            kps.append(k)
            boxes.append([y, x, y + h, x + w])
            iscrowd.append(crowd)
            areas.append(float(ann.get("area", w * h)))
            segs.append(ann.get("segmentation"))
        if skip_crowd_only_images and all(iscrowd):
            continue
        records.append({
            "id": image_id,
            "file_name": im["file_name"],
            "height": int(im["height"]),
            "width": int(im["width"]),
            "keypoints": np.asarray(kps, dtype=np.float32),
            "boxes": np.asarray(boxes, dtype=np.float32),
            "iscrowd": np.asarray(iscrowd, dtype=bool),
            "area": np.asarray(areas, dtype=np.float32),
            # Raw COCO segmentation per person (polygons or RLE dict;
            # None when absent) — decoded lazily by data/masks.py.
            "segmentation": segs,
        })
    return records


def pad_record(
    record: dict, max_persons: int
) -> dict:
    """Pad a record's per-person arrays to a static max_persons with a
    validity mask (fixed shapes for the jitted train step)."""
    p = len(record["boxes"])
    take = min(p, max_persons)
    out = {
        "keypoints": np.zeros((max_persons, NUM_KEYPOINTS, 3), np.float32),
        "boxes": np.zeros((max_persons, 4), np.float32),
        "iscrowd": np.zeros((max_persons,), bool),
        "valid": np.zeros((max_persons,), bool),
    }
    if take:
        # Prefer non-crowd persons when truncating.
        order = np.concatenate([
            np.flatnonzero(~record["iscrowd"][:p]),
            np.flatnonzero(record["iscrowd"][:p]),
        ])[:take]
        out["keypoints"][:take] = record["keypoints"][order]
        out["boxes"][:take] = record["boxes"][order]
        out["iscrowd"][:take] = record["iscrowd"][order]
        out["valid"][:take] = True
    return out
