"""COCO 17-keypoint constants shared across the framework.

Parity notes: these are the standard COCO person-keypoint definitions the
reference (TropComplique/MultiPoseNet) trains against (SURVEY.md §2 "Data
prep" row: 17 keypoints (x, y, v) per person; §2 "Input pipeline" row:
horizontal flip with L/R keypoint index swap). OKS sigmas are the
pycocotools `COCOeval.params.kpt_oks_sigmas` values, needed because
pycocotools is absent in this environment (SURVEY.md §7) and we ship our own
evaluator in `multiposenet_tpu/eval/oks.py`.
"""

from __future__ import annotations

import numpy as np

NUM_KEYPOINTS = 17

KEYPOINT_NAMES = (
    "nose",
    "left_eye",
    "right_eye",
    "left_ear",
    "right_ear",
    "left_shoulder",
    "right_shoulder",
    "left_elbow",
    "right_elbow",
    "left_wrist",
    "right_wrist",
    "left_hip",
    "right_hip",
    "left_knee",
    "right_knee",
    "left_ankle",
    "right_ankle",
)

# Pairs of (left, right) keypoint indices to swap under horizontal flip.
FLIP_PAIRS = (
    (1, 2),    # eyes
    (3, 4),    # ears
    (5, 6),    # shoulders
    (7, 8),    # elbows
    (9, 10),   # wrists
    (11, 12),  # hips
    (13, 14),  # knees
    (15, 16),  # ankles
)

# Permutation such that keypoints[FLIP_PERMUTATION] gives flipped keypoints.
FLIP_PERMUTATION = np.arange(NUM_KEYPOINTS)
for _l, _r in FLIP_PAIRS:
    FLIP_PERMUTATION[_l], FLIP_PERMUTATION[_r] = _r, _l
FLIP_PERMUTATION.setflags(write=False)

# Per-keypoint OKS falloff constants (pycocotools convention: sigmas = k_i/2,
# OKS uses exp(-d^2 / (2 * s^2 * k_i^2)) with k_i = 2 * sigma_i).
OKS_SIGMAS = np.array(
    [
        0.026, 0.025, 0.025, 0.035, 0.035,
        0.079, 0.079, 0.072, 0.072, 0.062,
        0.062, 0.107, 0.107, 0.087, 0.087,
        0.089, 0.089,
    ],
    dtype=np.float64,
)
OKS_SIGMAS.setflags(write=False)

# COCO skeleton (pairs of keypoint indices, 0-based) for visualization.
SKELETON = (
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12),
    (5, 11), (6, 12), (5, 6), (5, 7), (6, 8),
    (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
)

# Heatmap output stride of the keypoint subnet (SURVEY.md §2 "Input pipeline"
# row: Gaussian target heatmaps at output stride 4).
OUTPUT_STRIDE = 4

# ImageNet per-channel normalization used by MobileNet-style backbones.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
IMAGENET_MEAN.setflags(write=False)
IMAGENET_STD.setflags(write=False)
