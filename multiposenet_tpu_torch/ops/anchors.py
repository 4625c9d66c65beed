"""Anchor generation for the RetinaNet-style person detector.

Reference counterpart: `generate_anchors()` in the person-detector component
(SURVEY.md §2 "Person detector head" row; PAPER §3.1). Anchors are generated
once per (image_size, config) on the host and cached; the predictor copies
them to the device once.

Convention: boxes are (y0, x0, y1, x1) in absolute input-image pixels.
Anchor centers sit at ((i + 0.5) * stride, (j + 0.5) * stride).
"""

from __future__ import annotations

import functools
import math

import numpy as np

from multiposenet_tpu_torch.config import DetectorConfig


def level_anchors(
    image_size: int,
    level: int,
    num_scales: int,
    aspect_ratios: tuple[float, ...],
    base_scale: float,
) -> np.ndarray:
    """Anchors for one pyramid level → [H_l * W_l * A, 4] float32."""
    stride = 2**level
    feat = int(math.ceil(image_size / stride))
    # Per-cell anchor shapes (A, 2): octave scales x aspect ratios.
    shapes = []
    for s in range(num_scales):
        size = base_scale * stride * (2.0 ** (s / num_scales))
        for ar in aspect_ratios:
            h = size / math.sqrt(ar)
            w = size * math.sqrt(ar)
            shapes.append((h, w))
    shapes = np.asarray(shapes, dtype=np.float32)  # [A, 2]

    cy = (np.arange(feat, dtype=np.float32) + 0.5) * stride
    cx = (np.arange(feat, dtype=np.float32) + 0.5) * stride
    cyx = np.stack(np.meshgrid(cy, cx, indexing="ij"), axis=-1)  # [H, W, 2]

    centers = cyx[:, :, None, :]                       # [H, W, 1, 2]
    half = shapes[None, None, :, :] / 2.0              # [1, 1, A, 2]
    y0x0 = centers - half
    y1x1 = centers + half
    boxes = np.concatenate([y0x0, y1x1], axis=-1)      # [H, W, A, 4]
    return boxes.reshape(-1, 4)


@functools.lru_cache(maxsize=8)
def all_anchors(
    image_size: int, config: DetectorConfig = DetectorConfig()
) -> np.ndarray:
    """Concatenated anchors over all levels, [sum_l H_l*W_l*A, 4].

    Order matches the flattening of per-level head outputs
    (level-major, then row-major spatial, then anchor index) used by
    `ops.detection.flatten_outputs`.
    """
    per_level = [
        level_anchors(
            image_size, lvl, config.num_scales, config.aspect_ratios,
            config.anchor_base_scale,
        )
        for lvl in range(config.min_level, config.max_level + 1)
    ]
    out = np.concatenate(per_level, axis=0).astype(np.float32)
    out.setflags(write=False)
    return out
