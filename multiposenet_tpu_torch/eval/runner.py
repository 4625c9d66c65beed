"""End-to-end keypoint evaluation runner, the port of
`multiposenet_tpu/eval/runner.py`: for each image predict → collect
results → OKS AP summary, through the single-image path
(`Predictor.predict`) or the batched one (`Predictor.make_batch_runner`,
the batch sharded over every visible card) with host-side resize
bookkeeping; the
host resize is `utils/image_io.resize_linear` (cv2's INTER_LINEAR).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from multiposenet_tpu_torch.data.loader import load_image
from multiposenet_tpu_torch.eval.oks import (
    DetectionKP,
    GroundTruth,
    KeypointEvaluator,
)
from multiposenet_tpu_torch.infer.predictor import Predictor
from multiposenet_tpu_torch.utils.image_io import resize_linear


def record_ground_truths(record: dict) -> list[GroundTruth]:
    gts = []
    for i in range(len(record["boxes"])):
        y0, x0, y1, x1 = np.asarray(record["boxes"][i], np.float32)
        gts.append(GroundTruth(
            keypoints=np.asarray(record["keypoints"][i], np.float32),
            area=float(record["area"][i]),
            iscrowd=bool(record["iscrowd"][i]),
            bbox=np.array([x0, y0, x1 - x0, y1 - y0], np.float32),
        ))
    return gts


def evaluate_predictor(
    predictor: Predictor,
    records: Sequence[dict],
    image_dir: str | None = None,
    max_images: int | None = None,
) -> dict[str, float]:
    """Single-image predict() loop → OKS AP stats."""
    ev = KeypointEvaluator()
    for record in records[:max_images]:
        image = load_image(record, image_dir)
        people = predictor.predict(image)
        dts = [
            DetectionKP(keypoints=p.keypoints.astype(np.float32),
                        score=p.score)
            for p in people
        ]
        ev.add_image(record_ground_truths(record), dts)
    return ev.summarize()


def _host(t: torch.Tensor) -> np.ndarray:
    """A batch runner's output tensor on the host, floats as float32."""
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def evaluate_batched(
    predictor: Predictor,
    records: Sequence[dict],
    batch_size: int,
    image_dir: str | None = None,
    mesh=None,
) -> dict[str, float]:
    """Batched inference loop → OKS AP stats.

    Images are host-resized to the model size (scale tracked per image)
    into the top-left of a zero batch, the last batch padded with its last
    record; keypoints come back divided by the scale and clipped to the
    image. The batches run sharded over `mesh` (default every visible
    card, as the JAX runner's), `batch_size` a multiple of its size.
    """
    run = predictor.make_batch_runner(mesh)
    s = predictor.image_size
    ev = KeypointEvaluator()

    for start in range(0, len(records), batch_size):
        chunk = list(records[start : start + batch_size])
        true_n = len(chunk)
        while len(chunk) < batch_size:
            chunk.append(chunk[-1])
        images = np.zeros((batch_size, s, s, 3), np.uint8)
        scales = np.zeros(batch_size, np.float32)
        for i, rec in enumerate(chunk):
            img = load_image(rec, image_dir)
            h, w = img.shape[:2]
            scale = s / max(h, w)
            nh, nw = int(round(h * scale)), int(round(w * scale))
            images[i, :nh, :nw] = resize_linear(img, (nw, nh))
            scales[i] = scale
        out = run(images)
        scores = _host(out["box_scores"])
        valid = _host(out["box_valid"])
        kps = _host(out["keypoints"])
        for i in range(true_n):
            # Same output contract as Predictor.predict: keypoints in
            # original image coords, clipped to image bounds.
            h = chunk[i].get("height") or chunk[i]["image"].shape[0]
            w = chunk[i].get("width") or chunk[i]["image"].shape[1]
            dts = []
            for j in np.flatnonzero(valid[i]):
                k = kps[i, j].copy()
                k[:, :2] /= scales[i]
                k[:, 0] = np.clip(k[:, 0], 0.0, w - 1.0)
                k[:, 1] = np.clip(k[:, 1], 0.0, h - 1.0)
                dts.append(
                    DetectionKP(keypoints=k, score=float(scores[i, j]))
                )
            ev.add_image(record_ground_truths(chunk[i]), dts)
    return ev.summarize()
