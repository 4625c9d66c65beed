"""Evaluation data shared by the port's eval and CLI tests (numpy and the
stdlib only, so the card tests import it without JAX).

Ground truth is planted around detections (or detections around ground
truth) with seeded jitter, so that OKS AP lies strictly between 0 and 1
and a comparison of two evaluations is not a comparison of zeros; it is
written as a COCO person-keypoints JSON beside PNG images.
"""

import json
from pathlib import Path

import numpy as np

# Per-person jitter, px: at the planted areas the first matches at every
# OKS threshold, the second at some, the third at none.
JITTER_PX = (0.5, 2.5, 12.0)
# GT areas, px²: one medium and one large, so APM and APL both count.
AREAS = (48.0 ** 2, 120.0 ** 2)


def jitter_people(keypoints: np.ndarray, rng) -> np.ndarray:
    """[P, 17, 3] → a copy with x and y moved by Gaussian noise whose
    sigma is drawn per person from JITTER_PX."""
    out = np.array(keypoints, np.float32)
    for p in range(len(out)):
        sigma = JITTER_PX[rng.randint(len(JITTER_PX))]
        out[p, :, :2] += rng.normal(0.0, sigma, out[p, :, :2].shape)
    return out


def planted_annotations(boxes, keypoints, rng, height: int,
                        width: int) -> list[dict]:
    """COCO annotations (no ids) around one image's detected people
    (boxes [P, 4] as (y0, x0, y1, x1), keypoints [P, 17, 3]): keypoints
    jittered, labeled (v=2) inside the image and one in ten left
    unlabeled, areas from AREAS; every third person left out (its
    detection becomes a false positive), plus one person no detection
    comes near (a miss) and one crowd region."""
    anns = []
    kps = jitter_people(keypoints, rng) if len(keypoints) else keypoints
    for p in range(len(kps)):
        if p % 3 == 2:
            continue
        k = kps[p].copy()
        inside = ((k[:, 0] >= 0) & (k[:, 0] <= width - 1)
                  & (k[:, 1] >= 0) & (k[:, 1] <= height - 1))
        labeled = inside & (rng.rand(len(k)) >= 0.1)
        k[:, 2] = np.where(labeled, 2.0, 0.0)
        k[~labeled, :2] = 0.0
        y0, x0, y1, x1 = (float(v) for v in boxes[p])
        anns.append({"keypoints": k.reshape(-1).tolist(),
                     "bbox": [x0, y0, x1 - x0, y1 - y0],
                     "area": AREAS[p % 2], "iscrowd": 0,
                     "num_keypoints": int(labeled.sum())})
    miss = np.zeros((17, 3), np.float32)
    miss[:, 0] = rng.uniform(0, width - 1, 17)
    miss[:, 1] = rng.uniform(0, height - 1, 17)
    miss[:, 2] = 2.0
    anns.append({"keypoints": miss.reshape(-1).tolist(),
                 "bbox": [0.0, 0.0, width / 2.0, height / 2.0],
                 "area": AREAS[0], "iscrowd": 0, "num_keypoints": 17})
    anns.append({"keypoints": [0.0] * 51,
                 "bbox": [width / 2.0, height / 2.0, width / 4.0,
                          height / 4.0],
                 "area": AREAS[0], "iscrowd": 1, "num_keypoints": 0})
    return anns


def write_coco(directory, images, annotations, write_png,
               suffix: str = ".png"):
    """Images (through `write_png`, or any writer of `suffix` files) and
    a COCO person-keypoints JSON of `annotations` (one list per image).
    Returns (json path, image directory)."""
    directory = Path(directory)
    image_dir = directory / "images"
    image_dir.mkdir(parents=True, exist_ok=True)
    data = {"images": [], "annotations": [],
            "categories": [{"id": 1, "name": "person"}]}
    for i, (image, anns) in enumerate(zip(images, annotations)):
        name = f"{i:06d}{suffix}"
        write_png(image_dir / name, image)
        data["images"].append({"id": i, "file_name": name,
                               "height": image.shape[0],
                               "width": image.shape[1]})
        for ann in anns:
            data["annotations"].append({
                **ann, "id": len(data["annotations"]) + 1, "image_id": i,
                "category_id": 1})
    path = directory / "person_keypoints.json"
    path.write_text(json.dumps(data))
    return str(path), str(image_dir)
