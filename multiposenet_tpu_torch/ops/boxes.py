"""Box utilities, the port of `multiposenet_tpu/ops/boxes.py`: (y0, x0, y1,
x1) boxes, their IoU, and the encode and decode of Faster-RCNN deltas
against anchors."""

from __future__ import annotations

import torch

BBOX_XFORM_CLIP = 4.135166556742356  # log(1000/16): clamp decoded log-sizes


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] (y0, x0, y1, x1) → area, clamped at 0."""
    h = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    w = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return h * w


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between a[N, 4] and b[M, 4] → [N, M]."""
    y0 = torch.maximum(a[:, None, 0], b[None, :, 0])
    x0 = torch.maximum(a[:, None, 1], b[None, :, 1])
    y1 = torch.minimum(a[:, None, 2], b[None, :, 2])
    x1 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (y1 - y0).clamp(min=0.0) * (x1 - x0).clamp(min=0.0)
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / union.clamp(min=1e-8)


def to_center(boxes: torch.Tensor) -> torch.Tensor:
    """(y0, x0, y1, x1) → (cy, cx, h, w)."""
    hw = boxes[..., 2:4] - boxes[..., 0:2]
    return torch.cat([boxes[..., 0:2] + hw / 2.0, hw], dim=-1)


def from_center(cboxes: torch.Tensor) -> torch.Tensor:
    """(cy, cx, h, w) → (y0, x0, y1, x1)."""
    half = cboxes[..., 2:4] / 2.0
    return torch.cat([cboxes[..., 0:2] - half, cboxes[..., 0:2] + half],
                     dim=-1)


def encode(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """GT boxes → regression deltas relative to anchors (same leading
    dims)."""
    gt = to_center(boxes)
    an = to_center(anchors)
    tyx = (gt[..., 0:2] - an[..., 0:2]) / an[..., 2:4].clamp(min=1e-8)
    thw = torch.log(gt[..., 2:4].clamp(min=1e-8)
                    / an[..., 2:4].clamp(min=1e-8))
    return torch.cat([tyx, thw], dim=-1)


def decode(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Regression deltas (dy, dx, dh, dw) + anchors → boxes."""
    an = to_center(anchors)
    cyx = deltas[..., 0:2] * an[..., 2:4] + an[..., 0:2]
    hw = torch.exp(deltas[..., 2:4].clamp(max=BBOX_XFORM_CLIP)) * an[..., 2:4]
    return from_center(torch.cat([cyx, hw], dim=-1))


def clip_to_image(boxes: torch.Tensor, height: float,
                  width: float) -> torch.Tensor:
    y = boxes[..., 0::2].clamp(0.0, height)
    x = boxes[..., 1::2].clamp(0.0, width)
    return torch.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]], dim=-1)
