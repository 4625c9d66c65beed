"""Fixed-shape batched greedy NMS, the port of `_nms_greedy` in
`multiposenet_tpu/ops/nms.py` with the batch written out in place of
`vmap`.

`max_out` rounds: pick the live candidate with the highest score (the
first one among ties), record it, then suppress every live candidate with
IoU >= the threshold (hard NMS) or decay the live scores by
exp(-IoU²/σ) (soft-NMS); with box voting, the recorded box is the
score-weighted mean of the live candidates at IoU >= vote_iou. Slots past
the last pick have score 0 and are invalid.
"""

from __future__ import annotations

import torch


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_out: int,
    iou_threshold: float = 0.5,
    vote_iou: float = 0.0,
    soft_sigma: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """boxes [B, N, 4], scores [B, N] → (boxes [B, max_out, 4],
    scores [B, max_out], valid [B, max_out])."""
    bsz, n = scores.shape
    rows = torch.arange(bsz, device=scores.device)
    areas = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
             * (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0))
    scores0 = scores.float()
    live = scores0.clone()
    out_idx = torch.full((bsz, max_out), -1, dtype=torch.long,
                         device=scores.device)
    out_scores = torch.zeros((bsz, max_out), device=scores.device)
    out_boxes = torch.zeros((bsz, max_out, 4), dtype=boxes.dtype,
                            device=boxes.device)
    neg_inf = torch.tensor(-torch.inf, device=scores.device)
    for i in range(max_out):
        best = torch.argmax(live, dim=1)                     # [B]
        best_score = live[rows, best]
        picked = best_score > neg_inf
        out_idx[:, i] = torch.where(picked, best, -1)
        out_scores[:, i] = torch.where(picked, best_score, 0.0)
        b = boxes[rows, best]                                # [B, 4]
        y0 = torch.maximum(b[:, None, 0], boxes[..., 0])
        x0 = torch.maximum(b[:, None, 1], boxes[..., 1])
        y1 = torch.minimum(b[:, None, 2], boxes[..., 2])
        x1 = torch.minimum(b[:, None, 3], boxes[..., 3])
        inter = (y1 - y0).clamp(min=0.0) * (x1 - x0).clamp(min=0.0)
        ious = inter / (areas[rows, best][:, None] + areas - inter).clamp(
            min=1e-8)
        if vote_iou > 0.0:
            w = torch.where((live > neg_inf) & (ious >= vote_iou), scores0,
                            0.0)
            voted = (torch.einsum("bn,bnc->bc", w, boxes)
                     / w.sum(dim=1, keepdim=True).clamp(min=1e-8))
        else:
            voted = b
        out_boxes[:, i] = torch.where(picked[:, None], voted,
                                      torch.zeros_like(voted))
        if soft_sigma > 0.0:
            decay = torch.exp(-(ious * ious) / soft_sigma)
            live = torch.where(picked[:, None], live * decay, live)
        else:
            live = torch.where(picked[:, None] & (ious >= iou_threshold),
                               neg_inf, live)
        live[rows, best] = torch.where(picked, neg_inf, live[rows, best])
    valid = (out_idx >= 0) & (out_scores > 0.0)
    return out_boxes, out_scores, valid
