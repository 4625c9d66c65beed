"""Training targets on the device, the port of
`multiposenet_tpu/data/targets.py`: Gaussian keypoint heatmaps, the loss
mask of crowd and unlabeled regions, the box-union segmentation target,
and RetinaNet anchor labels, all from the loader's padded annotations
(keypoints [B, P, 17, 3], boxes [B, P, 4]) inside the train step.

Ties in an argmax take the first index, as `jnp.argmax` does.
"""

from __future__ import annotations

import torch

from multiposenet_tpu_torch.ops.boxes import encode, pairwise_iou


def keypoint_heatmaps(keypoints: torch.Tensor, hm_height: int,
                      hm_width: int, stride: int,
                      sigma: float = 2.0) -> torch.Tensor:
    """Padded keypoints [P, 17, 3] (x, y, v in input pixels) → target
    heatmaps [hm_height, hm_width, 17]: per channel the max over persons
    of a unit-height Gaussian at the keypoint (v > 0 marks a labeled one);
    coordinates map to heatmap cells as x / stride."""
    return batched_keypoint_heatmaps(keypoints[None], hm_height, hm_width,
                                     stride, sigma)[0]


def batched_keypoint_heatmaps(keypoints: torch.Tensor, hm_height: int,
                              hm_width: int, stride: int,
                              sigma: float = 2.0) -> torch.Tensor:
    """[B, P, 17, 3] → [B, H, W, 17]."""
    kx = keypoints[..., 0] / stride  # [B, P, K]
    ky = keypoints[..., 1] / stride
    vis = keypoints[..., 2] > 0
    dev = keypoints.device
    yy = torch.arange(hm_height, dtype=torch.float32, device=dev)
    xx = torch.arange(hm_width, dtype=torch.float32, device=dev)
    dy2 = (yy[None, :, None, None] - ky[:, None]) ** 2  # [B, H, P, K]
    dx2 = (xx[None, :, None, None] - kx[:, None]) ** 2  # [B, W, P, K]
    d2 = dy2[:, :, None] + dx2[:, None]                # [B, H, W, P, K]
    g = torch.exp(-d2 / (2.0 * sigma ** 2))
    g = torch.where(vis[:, None, None], g, torch.zeros((), device=dev))
    return g.amax(dim=3)


def box_region_mask(boxes: torch.Tensor, flags: torch.Tensor,
                    hm_height: int, hm_width: int,
                    stride: int) -> torch.Tensor:
    """Union of the flagged boxes [..., P, 4] (y0, x0, y1, x1 in input
    pixels; flags [..., P]) on the heatmap grid → [..., H, W] bool."""
    y0, x0, y1, x1 = (boxes[..., i] / stride for i in range(4))
    dev = boxes.device
    yy = torch.arange(hm_height, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(hm_width, dtype=torch.float32, device=dev)
    lead = boxes.shape[:-2]
    e = (slice(None),) * len(lead)
    in_y = (yy[..., None] >= y0[e + (None, None)]) & (
        yy[..., None] <= y1[e + (None, None)])          # [..., H, 1, P]
    in_x = (xx[:, None] >= x0[e + (None, None)]) & (
        xx[:, None] <= x1[e + (None, None)])            # [..., 1, W, P]
    inside = in_y & in_x & flags[e + (None, None)]
    return inside.any(dim=-1)


def loss_mask(crowd_boxes: torch.Tensor, crowd_valid: torch.Tensor,
              hm_height: int, hm_width: int, stride: int) -> torch.Tensor:
    """1.0 everywhere except inside the flagged regions → [..., H, W, 1]."""
    crowd = box_region_mask(crowd_boxes, crowd_valid, hm_height, hm_width,
                            stride)
    return (~crowd).to(torch.float32)[..., None]


def segmentation_target(boxes: torch.Tensor, person_valid: torch.Tensor,
                        hm_height: int, hm_width: int,
                        stride: int) -> torch.Tensor:
    """Union of person boxes as the auxiliary segmentation target
    [..., H, W, 1]."""
    m = box_region_mask(boxes, person_valid, hm_height, hm_width, stride)
    return m.to(torch.float32)[..., None]


def label_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, match_high: float = 0.5,
                  match_low: float = 0.4
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RetinaNet anchor assignment for one image: anchors [N, 4], gt_boxes
    [P, 4] (padded; gt_valid [P] marks real ones) → (cls_target [N] in
    {1 pos, 0 neg, -1 ignore}, box_target [N, 4] deltas toward the
    matched GT, matched_iou [N]). Every valid GT's best anchor is forced
    positive and regresses toward it (between GTs the last one wins);
    padded GTs write nowhere."""
    cls, box, iou = batched_label_anchors(anchors, gt_boxes[None],
                                          gt_valid[None], match_high,
                                          match_low)
    return cls[0], box[0], iou[0]


def _first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """argmax taking the first of equal maxima, as jnp.argmax does."""
    best = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device).view(
        [n if d == dim % x.ndim else 1 for d in range(x.ndim)])
    return torch.where(x == best, idx, n).amin(dim=dim)


def batched_label_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                          gt_valid: torch.Tensor, match_high: float = 0.5,
                          match_low: float = 0.4):
    """gt_boxes [B, P, 4], gt_valid [B, P] → ([B, N], [B, N, 4], [B, N]),
    with no host synchronization."""
    b, p = gt_valid.shape
    n = anchors.shape[0]
    dev = anchors.device
    iou = pairwise_iou(anchors, gt_boxes.reshape(b * p, 4)).reshape(
        n, b, p).permute(1, 0, 2)
    iou = torch.where(gt_valid[:, None, :], iou,
                      torch.full((), -1.0, device=dev))           # [B, N, P]
    best_gt = _first_argmax(iou, 2)                               # [B, N]
    best_iou = iou.amax(dim=2)
    one = torch.ones((), device=dev)
    cls = torch.where(best_iou >= match_high, one,
                      torch.where(best_iou < match_low, 0.0 * one, -one))
    # Force-match: each valid GT's best anchor; where several GTs pick
    # one anchor the last wins (the largest index). Padded GTs write to
    # an overflow slot n.
    best_anchor = _first_argmax(iou, 1)                           # [B, P]
    slot = torch.where(gt_valid, best_anchor, n)
    gt_idx = torch.arange(p, device=dev).expand(b, p)
    forced = torch.full((b, n + 1), -1, dtype=torch.long, device=dev)
    forced.scatter_reduce_(1, slot, gt_idx, reduce="amax")
    forced = forced[:, :n]
    cls = torch.where(forced >= 0, one, cls)
    best_gt = torch.where(forced >= 0, forced, best_gt)
    matched = torch.gather(gt_boxes, 1, best_gt[..., None].expand(b, n, 4))
    return cls, encode(matched, anchors[None].expand(b, n, 4)), best_iou
