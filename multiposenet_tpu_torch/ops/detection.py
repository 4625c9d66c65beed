"""Detector post-processing, the port of `multiposenet_tpu/ops/detection.py`:
per-level head outputs → anchor decode → pre-NMS top-k → greedy NMS.

With the IoU-aware scoring head (`DetectorConfig.iou_head`) candidates
are ranked by log σ(cls) + p·log σ(iou), the log of the combined score
σ(cls)·σ(iou)^p, which is the score NMS sees and the threshold cuts.

The JAX package's pre-NMS pool may come from `lax.approx_max_k`; the port
takes the exact top-k in `lax.top_k`'s order (value descending, then index
ascending) through a stable sort, since `torch.topk` promises no order
among ties.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from multiposenet_tpu_torch.config import DetectorConfig
from multiposenet_tpu_torch.ops import boxes as box_ops
from multiposenet_tpu_torch.ops.anchors import all_anchors
from multiposenet_tpu_torch.ops.nms import batched_nms


class Detections(NamedTuple):
    """boxes [B, D, 4] (y0, x0, y1, x1) in input pixels; scores [B, D]
    (0 where invalid); valid [B, D] bool."""

    boxes: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor


def flatten_outputs(
    detector_out: dict[str, dict[str, torch.Tensor]],
    min_level: int,
    max_level: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-level {cls [B,H,W,A], box [B,H,W,4A]} → (cls [B, N],
    box [B, N, 4]) in (level, row, column, anchor) order, the order of
    `ops.anchors.all_anchors`. The per-level tensors are NHWC, so this is
    the NHWC row-major flatten whatever their strides."""
    cls_list, box_list = [], []
    for level in range(min_level, max_level + 1):
        out = detector_out[f"P{level}"]
        b = out["cls"].shape[0]
        cls_list.append(out["cls"].reshape(b, -1))
        box_list.append(out["box"].reshape(b, -1, 4))
    return torch.cat(cls_list, dim=1), torch.cat(box_list, dim=1)


def flatten_iou_outputs(
    detector_out: dict[str, dict[str, torch.Tensor]],
    min_level: int,
    max_level: int,
) -> torch.Tensor:
    """Per-level iou [B, H, W, A] logits → [B, N], in the order of
    `flatten_outputs`."""
    return torch.cat(
        [detector_out[f"P{level}"]["iou"].reshape(
            detector_out[f"P{level}"]["iou"].shape[0], -1)
         for level in range(min_level, max_level + 1)], dim=1)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last dim in lax.top_k order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def postprocess_detections(
    detector_out: dict[str, dict[str, torch.Tensor]],
    image_size: int,
    config: DetectorConfig = DetectorConfig(),
    anchors: torch.Tensor | None = None,
) -> Detections:
    """Decode + top-k + NMS for a batch of detector head outputs.
    `anchors` may be passed in to skip copying them to the device."""
    logits, deltas = flatten_outputs(detector_out, config.min_level,
                                     config.max_level)
    logits, deltas = logits.float(), deltas.float()
    if anchors is None:
        anchors = torch.as_tensor(all_anchors(image_size, config).copy(),
                                  device=logits.device)
    iou = config.iou_head and "iou" in detector_out[f"P{config.min_level}"]
    if iou:
        iou_logits = flatten_iou_outputs(detector_out, config.min_level,
                                         config.max_level).float()
        rank = (F.logsigmoid(logits)
                + config.iou_score_power * F.logsigmoid(iou_logits))
    else:
        rank = logits
    k = min(config.pre_nms_top_k, rank.shape[1])
    top_rank, top_idx = top_k(rank, k)
    top_deltas = torch.gather(deltas, 1, top_idx[..., None].expand(-1, -1, 4))
    decoded = box_ops.decode(top_deltas, anchors[top_idx])
    decoded = box_ops.clip_to_image(decoded, float(image_size),
                                    float(image_size))
    # With the IoU head top_rank is the log of the combined score, and the
    # threshold applies to that combined score.
    scores = torch.exp(top_rank) if iou else torch.sigmoid(top_rank)
    scores = torch.where(scores >= config.score_threshold, scores, 0.0)
    out_boxes, out_scores, valid = batched_nms(
        decoded, scores, config.max_detections, config.nms_iou_threshold,
        config.nms_vote_iou, config.soft_nms_sigma,
    )
    return Detections(boxes=out_boxes, scores=out_scores,
                      valid=valid & (out_scores > 0.0))
