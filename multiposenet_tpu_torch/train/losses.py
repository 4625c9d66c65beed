"""Training losses, the port of `multiposenet_tpu/train/losses.py`: masked
heatmap MSE, segmentation BCE, sigmoid focal loss, GIoU and Huber box
losses, and the IoU-aware scoring head's BCE.

optax's `sigmoid_binary_cross_entropy` and `huber_loss` are written out as
optax 0.2.6 computes them, so values and gradients follow the JAX
package's. Where the JAX package takes `jnp.maximum`/`jnp.minimum` this
takes `torch.maximum`/`torch.minimum` (`_at_least`), which split the
gradient at a tie as JAX does; `clamp` would pass all of it.

Under data parallelism (`parallel/mesh.py`) every denominator is the
global batch's: the counts are summed over the ranks, the numerators
stay local, so the ranks' losses sum to the JAX step's loss on the
global batch (plain DistributedDataParallel would average per-rank
losses and divide by the ranks a second time).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multiposenet_tpu_torch.parallel import mesh


def _at_least(x: torch.Tensor, floor: float) -> torch.Tensor:
    """jnp.maximum(x, floor), its gradient halved at a tie."""
    return torch.maximum(x, x.new_tensor(floor))


def _global(count: torch.Tensor) -> torch.Tensor:
    """A count of the local batch → the global batch's (the sum over the
    data-parallel ranks); itself on one process."""
    if mesh.world_size() == 1:
        return count
    return mesh.all_reduce_sum_(count.detach().clone())


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """optax's: -y·log σ(x) - (1-y)·log σ(-x), elementwise."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def huber_loss(predictions: torch.Tensor, targets: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    """optax's: 0.5·min(|e|, δ)² + δ·(|e| - min(|e|, δ)), elementwise."""
    abs_errors = (predictions - targets).abs()
    quadratic = torch.minimum(abs_errors, abs_errors.new_tensor(delta))
    linear = abs_errors - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def masked_heatmap_mse(pred: torch.Tensor, target: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over unmasked heatmap cells: pred/target
    [B, H, W, K], mask [B, H, W, 1] with 0 inside crowd regions."""
    se = (pred - target) ** 2 * mask
    denom = _at_least(_global(mask.sum()) * pred.shape[-1], 1.0)
    return se.sum() / denom


def segmentation_bce(logits: torch.Tensor, target: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Sigmoid cross-entropy of the auxiliary person segmentation."""
    ce = sigmoid_binary_cross_entropy(logits, target) * mask
    return ce.sum() / _at_least(_global(mask.sum()), 1.0)


def focal_loss(logits: torch.Tensor, cls_target: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss over anchors, logits/cls_target [B, N] with
    targets in {1, 0, -1 = ignore}, normalized by the positive count."""
    y = cls_target.clamp(0.0, 1.0)
    p = torch.sigmoid(logits)
    ce = sigmoid_binary_cross_entropy(logits, y)
    p_t = p * y + (1.0 - p) * (1.0 - y)
    alpha_t = alpha * y + (1.0 - alpha) * (1.0 - y)
    fl = alpha_t * (1.0 - p_t) ** gamma * ce
    fl = torch.where(cls_target >= 0.0, fl, torch.zeros_like(fl))
    num_pos = _at_least(_global((cls_target == 1.0).sum().float()), 1.0)
    return fl.sum() / num_pos


def _iou_parts(a: torch.Tensor, b: torch.Tensor):
    """(inter, union) of aligned boxes [..., 4] (y0, x0, y1, x1)."""
    iy0 = torch.maximum(a[..., 0], b[..., 0])
    ix0 = torch.maximum(a[..., 1], b[..., 1])
    iy1 = torch.minimum(a[..., 2], b[..., 2])
    ix1 = torch.minimum(a[..., 3], b[..., 3])
    inter = _at_least(iy1 - iy0, 0.0) * _at_least(ix1 - ix0, 0.0)
    area_a = _at_least(a[..., 2] - a[..., 0], 0.0) * _at_least(
        a[..., 3] - a[..., 1], 0.0)
    area_b = _at_least(b[..., 2] - b[..., 0], 0.0) * _at_least(
        b[..., 3] - b[..., 1], 0.0)
    return inter, area_a + area_b - inter


def _elementwise_giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Generalized IoU between aligned boxes [..., 4] (y0, x0, y1, x1)."""
    inter, union = _iou_parts(a, b)
    iou = inter / _at_least(union, 1e-8)
    hy0 = torch.minimum(a[..., 0], b[..., 0])
    hx0 = torch.minimum(a[..., 1], b[..., 1])
    hy1 = torch.maximum(a[..., 2], b[..., 2])
    hx1 = torch.maximum(a[..., 3], b[..., 3])
    hull = _at_least(hy1 - hy0, 0.0) * _at_least(hx1 - hx0, 0.0)
    return iou - (hull - union) / _at_least(hull, 1e-8)


def box_giou_loss(pred_boxes: torch.Tensor, target_boxes: torch.Tensor,
                  cls_target: torch.Tensor) -> torch.Tensor:
    """Mean (1 - GIoU) over positive anchors, on decoded boxes [B, N, 4];
    cls_target [B, N]."""
    pos = cls_target == 1.0
    g = _elementwise_giou(pred_boxes, target_boxes)
    loss = torch.where(pos, 1.0 - g, torch.zeros_like(g))
    return loss.sum() / _at_least(_global(pos.sum().float()), 1.0)


def iou_pred_loss(iou_logits: torch.Tensor, pred_boxes: torch.Tensor,
                  target_boxes: torch.Tensor,
                  cls_target: torch.Tensor) -> torch.Tensor:
    """BCE between σ(iou_logits) and the IoU of each positive anchor's
    decoded box with its matched GT (the IoU detached), over the
    positives."""
    inter, union = _iou_parts(pred_boxes, target_boxes)
    iou = (inter / _at_least(union, 1e-8)).clamp(0.0, 1.0).detach()
    pos = cls_target == 1.0
    bce = sigmoid_binary_cross_entropy(iou_logits, iou)
    bce = torch.where(pos, bce, torch.zeros_like(bce))
    return bce.sum() / _at_least(_global(pos.sum().float()), 1.0)


def box_huber_loss(pred_deltas: torch.Tensor, target_deltas: torch.Tensor,
                   cls_target: torch.Tensor,
                   delta: float = 0.1) -> torch.Tensor:
    """Huber loss on box deltas [B, N, 4] over positives, the mean per
    coordinate."""
    pos = (cls_target == 1.0)[..., None]
    err = huber_loss(pred_deltas, target_deltas, delta)
    err = torch.where(pos, err, torch.zeros_like(err))
    num = _at_least(_global(pos.sum().float()) * 4.0, 1.0)
    return err.sum() / num
