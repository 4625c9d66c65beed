"""Offline data preparation, the port of `multiposenet_tpu/data/prepare.py`:
COCO JSON + images → sharded compressed npz files, with the same layout
and keys, so that either package reads the other's shards.

Shard layout (npz keys), N records per shard:
    image_bytes:  object array [N] of encoded JPEG / PNG bytes
    file_name:    object array [N]
    height/width: int32 [N]
    keypoints:    float32 [N, P, 17, 3]
    boxes:        float32 [N, P, 4]
    iscrowd:      bool [N, P]
    valid:        bool [N, P]
    area:         float32 [N, P]
    exclude_mask: object array [N] of gray PNG bytes (or b"") — union of
                  crowd and unlabeled persons' segmentations
    person_mask:  object array [N] of gray PNG bytes (or b"") — union of
                  every person's segmentation

COCO images keep their file's bytes; synthetic images and the masks are
PNG-encoded by `utils/image_io.encode_png` (lossless: the pixels read back
are cv2's, the bytes are not). Shards are read back through
`utils/image_io.decode_image` (cv2.imdecode's pixels, Exif applied) and
`decode_gray_png` (IMREAD_GRAYSCALE), masks as pixels > 127.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from multiposenet_tpu_torch.data.coco import load_coco_keypoints, pad_record
from multiposenet_tpu_torch.data.masks import region_masks
from multiposenet_tpu_torch.utils.constants import NUM_KEYPOINTS
from multiposenet_tpu_torch.utils.image_io import (
    decode_gray_png, decode_image, encode_png,
)


def _encode_mask(mask: np.ndarray | None) -> bytes:
    if mask is None or not mask.any():
        return b""
    return encode_png(mask.astype(np.uint8) * 255)


def write_shards(records: Sequence[dict], output_dir: str | Path,
                 image_dir: str | Path | None = None,
                 shard_size: int = 1024,
                 max_persons: int = 32) -> list[Path]:
    """Pack records into npz shards; returns the shard paths. Records
    with an embedded 'image' are PNG-encoded; COCO records take the
    original bytes of `image_dir / file_name`."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for s in range(0, len(records), shard_size):
        chunk = records[s:s + shard_size]
        n = len(chunk)
        image_bytes = np.empty(n, dtype=object)
        file_name = np.empty(n, dtype=object)
        height = np.zeros(n, np.int32)
        width = np.zeros(n, np.int32)
        keypoints = np.zeros((n, max_persons, NUM_KEYPOINTS, 3), np.float32)
        boxes = np.zeros((n, max_persons, 4), np.float32)
        iscrowd = np.zeros((n, max_persons), bool)
        valid = np.zeros((n, max_persons), bool)
        area = np.zeros((n, max_persons), np.float32)
        exclude_mask = np.empty(n, dtype=object)
        person_mask = np.empty(n, dtype=object)
        for i, rec in enumerate(chunk):
            if "image" in rec:
                image_bytes[i] = encode_png(np.ascontiguousarray(rec["image"]))
            else:
                if image_dir is None:
                    raise ValueError(
                        "records reference files; image_dir required")
                image_bytes[i] = (Path(image_dir)
                                  / rec["file_name"]).read_bytes()
            file_name[i] = rec["file_name"]
            height[i] = rec["height"]
            width[i] = rec["width"]
            padded = pad_record(rec, max_persons)
            keypoints[i] = padded["keypoints"]
            boxes[i] = padded["boxes"]
            iscrowd[i] = padded["iscrowd"]
            valid[i] = padded["valid"]
            p = min(len(rec["area"]), max_persons)
            area[i, :p] = rec["area"][:p]
            exclude_mask[i] = person_mask[i] = b""
            if rec.get("segmentation"):
                exc, per = region_masks(
                    rec["segmentation"], rec["iscrowd"], rec["keypoints"],
                    rec["boxes"], rec["height"], rec["width"])
                exclude_mask[i] = _encode_mask(exc)
                person_mask[i] = _encode_mask(per)
        path = output_dir / f"shard-{s // shard_size:05d}.npz"
        np.savez_compressed(
            path, image_bytes=image_bytes, file_name=file_name,
            height=height, width=width, keypoints=keypoints, boxes=boxes,
            iscrowd=iscrowd, valid=valid, area=area,
            exclude_mask=exclude_mask, person_mask=person_mask)
        paths.append(path)
    return paths


def read_shards(directory: str | Path) -> Iterator[dict]:
    """Yield records (coco.py layout, the decoded RGB 'image', and the
    masks as bool [H, W] or None) from npz shards, in shard order; 'id'
    is the index within its shard."""
    for path in sorted(Path(directory).glob("shard-*.npz")):
        shard = np.load(path, allow_pickle=True)
        has_masks = "exclude_mask" in shard

        def decode_mask(buf, name):
            if not buf:
                return None
            return decode_gray_png(bytes(buf), name) > 127

        for i in range(len(shard["height"])):
            v = shard["valid"][i]
            name = str(shard["file_name"][i])
            rec = {
                "id": i,
                "file_name": name,
                "height": int(shard["height"][i]),
                "width": int(shard["width"][i]),
                "keypoints": shard["keypoints"][i][v],
                "boxes": shard["boxes"][i][v],
                "iscrowd": shard["iscrowd"][i][v],
                "area": shard["area"][i][v],
                "image": decode_image(bytes(shard["image_bytes"][i]), name),
            }
            if has_masks:
                rec["exclude_mask"] = decode_mask(shard["exclude_mask"][i],
                                                  name)
                rec["person_mask"] = decode_mask(shard["person_mask"][i],
                                                 name)
            yield rec


def prepare_coco(annotations_path: str | Path, image_dir: str | Path,
                 output_dir: str | Path, shard_size: int = 1024,
                 max_persons: int = 32) -> list[Path]:
    """COCO keypoint JSON + images → shards in one call."""
    return write_shards(load_coco_keypoints(annotations_path), output_dir,
                        image_dir=image_dir, shard_size=shard_size,
                        max_persons=max_persons)
