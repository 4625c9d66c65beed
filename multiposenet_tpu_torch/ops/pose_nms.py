"""Pose-level OKS NMS, the port of `multiposenet_tpu/ops/pose_nms.py`:
after the PRN, drop detections whose keypoints duplicate a
higher-scoring detection's, by the OKS the evaluator scores
(`OKS_SIGMAS`, scale = the keeper's box area).

Fixed shapes, as in the JAX package: one [B, D, D] OKS tensor and D
greedy rounds over the slots, which are score-descending (the order
ops/nms.py selects them in), so slot order is the greedy order.
"""

from __future__ import annotations

import torch

from multiposenet_tpu_torch.utils.constants import OKS_SIGMAS


def pose_nms(keypoints: torch.Tensor, boxes: torch.Tensor,
             valid: torch.Tensor, oks_threshold: float) -> torch.Tensor:
    """Greedy pose dedup → the updated valid mask [B, D].

    keypoints [B, D, K, 3] rows (x, y, score), boxes [B, D, 4]
    (y0, x0, y1, x1) in the same pixel space, valid [B, D] bool. Slot i,
    if still alive, kills every later slot j whose OKS against it,
    mean_k exp(-d_k² / (2·area_i·(2σ_k)²)) over all K keypoints, exceeds
    `oks_threshold`."""
    d = keypoints.shape[1]
    k2 = torch.as_tensor((2.0 * OKS_SIGMAS) ** 2, dtype=torch.float32,
                         device=keypoints.device)
    x = keypoints[..., 0].float()
    y = keypoints[..., 1].float()
    dx = x[:, :, None, :] - x[:, None, :, :]   # [B, Di, Dj, K]
    dy = y[:, :, None, :] - y[:, None, :, :]
    area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
            ).clamp_min(1e-9).float()          # [B, D]
    e = (dx * dx + dy * dy) / (2.0 * area[:, :, None, None] * k2)
    oks = torch.exp(-e).mean(-1)               # [B, Di, Dj], keeper-i scale
    later = torch.ones(d, d, dtype=torch.bool,
                       device=valid.device).triu(diagonal=1)
    kills = (oks > oks_threshold) & later      # [B, Di, Dj]
    keep = valid.clone()
    for i in range(d):
        keep &= ~(kills[:, i] & (keep[:, i] & valid[:, i])[:, None])
    return keep
