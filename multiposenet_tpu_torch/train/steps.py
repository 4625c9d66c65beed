"""Train and eval steps, the port of `multiposenet_tpu/train/steps.py`:
targets made on the device from the loader's padded annotations, the
forward in training mode, the losses, the backward, then optax's
`chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule))` and the
EMA of the parameters with its warmup ramp.

The optimizer and the EMA are written out, not taken from torch.optim:
`xla_arith.adam_step` and `ema_step` round them as XLA compiles optax
0.2.6's chain and the JAX step's EMA (folded constants, fused
multiply-adds, subnormals flushed; float32 bit for bit with `jax.jit`,
tests/test_torch_train_arith.py), in one kernel pass on the card, so
that their traps hold:
- the schedule's count starts at 0, so with `init_value` 0 the first
  update has lr 0: step 1 leaves the parameters as they are but moves the
  Adam moments, the batch statistics and the EMA;
- clip_by_global_norm keeps g where ‖g‖ < max_norm, else g / ‖g‖ ·
  max_norm (torch's clip_grad_norm_ scales by max_norm / (‖g‖ + 1e-6));
- adamw (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) decays every parameter,
  BatchNorm scale and bias included: p - lr·(m̂ / (√v̂ + eps) + wd·p);
- the EMA covers the parameters only, with decay min(ema_decay,
  (1 + s) / (10 + s)) at s = step + 1 and weight 1 - decay; batch
  statistics are not averaged;
- Adam's bias corrections 1 - b^n and the EMA's scalars are float32, as
  the JAX step forms them, and float64 for float64 parameters (the
  float64 runs that hold the port to the JAX package with every float32
  read as float64, tests/test_torch_train_curves.py).

The state lives on one device and the step updates it in place.
`metrics` hold 0-d tensors on that device under the JAX package's keys,
with `grad_norm` of the unclipped gradients; reading them synchronizes.

In a data-parallel process group (`parallel/mesh.py`, one rank per
device, each with its shard of the global batch) the step is the JAX
step on the global batch: BatchNorm and the loss denominators take
global-batch sums (`models/layers.py`, `train/losses.py`), the gradients
are summed over the ranks in one flat bucket after the backward, and
clipping, AdamW and the EMA then run alike on every rank. The metrics are
summed over the ranks too (each rank's loss is its share of the global
loss), and `grad_norm` is the reduced gradients'.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch

from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.data import targets as targets_lib
from multiposenet_tpu_torch.models.posenet import MultiPoseNet
from multiposenet_tpu_torch.ops import boxes as boxes_lib
from multiposenet_tpu_torch.ops.anchors import all_anchors
from multiposenet_tpu_torch.ops.detection import (
    flatten_iou_outputs, flatten_outputs,
)
from multiposenet_tpu_torch.ops.image import normalize
from multiposenet_tpu_torch.parallel import mesh
from multiposenet_tpu_torch.train import losses as losses_lib
from multiposenet_tpu_torch.train import xla_arith

@dataclasses.dataclass
class TrainState:
    """step (updates applied), the model (its parameters and BatchNorm
    running statistics are `params` and `batch_stats`), the EMA of the
    parameters and the Adam moments, all tensors on the model's device
    and keyed by parameter name."""

    step: int
    model: MultiPoseNet
    ema_params: dict[str, torch.Tensor]
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())

    def state_dict(self) -> dict[str, Any]:
        """Everything a checkpoint holds, as CPU tensors."""
        def cpu(d):
            return {k: v.detach().cpu().clone() for k, v in d.items()}
        return {"step": self.step, "params": cpu(self.params),
                "batch_stats": cpu(self.batch_stats),
                "ema_params": cpu(self.ema_params), "mu": cpu(self.mu),
                "nu": cpu(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, sd: dict[str, Any]) -> None:
        """Copy a `state_dict()` into this state (same model)."""
        self.step = int(sd["step"])
        for name, dest in (("params", self.params),
                           ("batch_stats", self.batch_stats),
                           ("ema_params", self.ema_params),
                           ("mu", self.mu), ("nu", self.nu)):
            src = sd[name]
            if sorted(src) != sorted(dest):
                raise ValueError(f"checkpoint {name} do not match the "
                                 "model's names")
            for k, t in dest.items():
                t.copy_(src[k])


def make_learning_rate(config: Config):
    """optax.warmup_cosine_decay_schedule(init_value=0, peak lr,
    warmup_steps, decay_steps=max(num_steps, warmup_steps + 1), end lr)
    as a function of the update count (from 0), in float32 as XLA compiles
    it into the JAX package's jitted step (`xla_arith`):
    - warmup: 1 - c · f32(1 / warmup) and then · (-peak) + peak, each a
      fused multiply-add;
    - cosine: min(c, D) · f32(f32(π) · f32(1 / D)), glibc's cosf, + 1,
      then · f32(0.5 · (1 - α)) + f32(α) fused, then · peak, where D is
      the decay's length and α = end lr / peak."""
    t = config.train
    f32 = np.float32
    peak, warmup = t.learning_rate, t.warmup_steps
    decay_steps = max(t.num_steps, warmup + 1) - warmup
    alpha = 0.0 if peak == 0.0 else t.end_learning_rate / peak
    recip = float(f32(1) / f32(max(warmup, 1)))
    top, slope = float(f32(peak)), float(f32(0.0 - peak))
    angle = f32(f32(math.pi) * (f32(1) / f32(decay_steps)))
    half_span = float(f32(0.5) * f32(1 - alpha))
    floor = float(f32(alpha))

    def schedule(count: int) -> float:
        if count < warmup:
            c = float(f32(min(max(count, 0), warmup)))
            frac = xla_arith.fma_host(-c, recip, 1.0)
            return float(xla_arith.fma_host(float(frac), slope, top))
        c = min(f32(count - warmup), f32(decay_steps))
        lift = f32(xla_arith.cosf(f32(c * angle)) + f32(1))
        decayed = xla_arith.fma_host(float(lift), half_span, floor)
        return float(f32(decayed * f32(top)))

    return schedule


class Optimizer:
    """optax.chain(clip_by_global_norm(clip), adamw(schedule, wd)) over
    named tensors, in place, rounded as the JAX package's compiled step
    rounds it. `count` is the number of updates taken."""

    def __init__(self, config: Config):
        t = config.train
        self.schedule = make_learning_rate(config)
        self.clip, self.wd = t.gradient_clip_norm, t.weight_decay

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               mu: list[torch.Tensor], nu: list[torch.Tensor],
               count: int) -> torch.Tensor:
        """Apply one update; returns the gradients' global norm (before
        clipping) as a 0-d tensor."""
        return xla_arith.adam_step(params, grads, mu, nu, xla_arith.Adam(
            count=count + 1, lr=self.schedule(count), clip=self.clip,
            weight_decay=self.wd, nu_fuses_moment=True))


def ema_decay(config: Config, step: int, f: type = np.float32) -> float:
    """min(ema_decay, (1 + s) / (10 + s)) at s = step + 1, in `f`."""
    s = f(step) + f(1.0)
    return float(min(f(config.train.ema_decay), (f(1.0) + s) / (f(10.0) + s)))


def ema_weight(decay: float, f: type = np.float32) -> float:
    """1 - decay in `f`, as the JAX step forms it."""
    return float(f(1.0) - f(decay))


def create_train_state(config: Config, seed: int = 0,
                       model: MultiPoseNet | None = None,
                       device: str | torch.device = "cuda") -> TrainState:
    """The model from the port's seeded init (or `model` as given), moved
    to `device` and put in training mode, with zero Adam moments and the
    EMA equal to the parameters."""
    if model is None:
        model = MultiPoseNet(config)
        model.init_weights(torch.Generator().manual_seed(seed))
    model.to(device).train()
    params = dict(model.named_parameters())
    return TrainState(
        step=0, model=model,
        ema_params={k: p.detach().clone() for k, p in params.items()},
        mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()})


def _device_targets(batch: dict[str, torch.Tensor], config: Config,
                    anchors: torch.Tensor):
    """Padded annotations → heatmap, mask, segmentation and anchor
    targets, on the batch's device; the loss mask and segmentation target
    come from the coverage maps of images with segmentation masks."""
    m = config.model
    hm = config.train.image_size // m.output_stride
    stride = m.output_stride
    person = batch["valid"] & ~batch["iscrowd"]
    heatmaps = targets_lib.batched_keypoint_heatmaps(
        batch["keypoints"], hm, hm, stride)
    # Crowd regions and persons with no labeled keypoint are masked out of
    # the heatmap loss; they still supervise the detector and seg head.
    unlabeled = ~(batch["keypoints"][..., 2] > 0).any(dim=-1)
    mask = targets_lib.loss_mask(
        batch["boxes"], batch["valid"] & (batch["iscrowd"] | unlabeled),
        hm, hm, stride)
    seg = targets_lib.segmentation_target(batch["boxes"], person, hm, hm,
                                          stride)
    if "exclude_cov" in batch:
        # Segmentation coverage from the loader (persons without a
        # segmentation already gave their box on the host): where an image
        # has masks, the heatmap loss is weighted by 1 - the crowd and
        # unlabeled coverage and the seg target is the person coverage;
        # elsewhere the box unions above stay.
        flag = batch["has_mask"][:, None, None, None]
        mask = torch.where(flag, 1.0 - batch["exclude_cov"][..., None], mask)
        seg = torch.where(flag, batch["person_cov"][..., None], seg)
    d = config.detector
    cls_t, box_t, _ = targets_lib.batched_label_anchors(
        anchors, batch["boxes"], person, d.match_high, d.match_low)
    return heatmaps, mask, seg, cls_t, box_t


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or float64 where the model computes in float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def compute_losses(model_out: dict, batch: dict[str, torch.Tensor],
                   config: Config, anchors: torch.Tensor
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """All training losses from the model's outputs and the batch's raw
    annotations; `anchors` are `all_anchors(image_size, detector)` on
    the device."""
    t, d = config.train, config.detector
    heatmaps_t, mask, seg_t, cls_t, box_t = _device_targets(
        batch, config, anchors)
    hm_loss = losses_lib.masked_heatmap_mse(model_out["heatmaps"],
                                            heatmaps_t, mask)
    total = t.heatmap_loss_weight * hm_loss
    metrics = {"heatmap_loss": hm_loss}
    if "segmentation" in model_out:
        seg_loss = losses_lib.segmentation_bce(model_out["segmentation"],
                                               seg_t, mask)
        total = total + t.segmentation_loss_weight * seg_loss
        metrics["segmentation_loss"] = seg_loss
    if "detector" in model_out:
        logits, deltas = flatten_outputs(model_out["detector"], d.min_level,
                                         d.max_level)
        logits, deltas = _at_least_f32(logits), _at_least_f32(deltas)
        cls_loss = losses_lib.focal_loss(logits, cls_t, d.focal_alpha,
                                         d.focal_gamma)
        pred_boxes = tgt_boxes = None
        if d.box_loss == "giou" or d.iou_head:
            pred_boxes = boxes_lib.decode(deltas, anchors)
            tgt_boxes = boxes_lib.decode(box_t, anchors)
        if d.box_loss == "giou":
            box_loss = losses_lib.box_giou_loss(pred_boxes, tgt_boxes, cls_t)
            det_loss = cls_loss + d.giou_loss_weight * box_loss
        else:
            box_loss = losses_lib.box_huber_loss(deltas, box_t, cls_t)
            det_loss = cls_loss + d.box_loss_weight * box_loss
        metrics.update(cls_loss=cls_loss, box_loss=box_loss)
        if d.iou_head:
            iou_logits = _at_least_f32(flatten_iou_outputs(
                model_out["detector"], d.min_level, d.max_level))
            iou_loss = losses_lib.iou_pred_loss(iou_logits, pred_boxes,
                                                tgt_boxes, cls_t)
            det_loss = det_loss + d.iou_loss_weight * iou_loss
            metrics["iou_pred_loss"] = iou_loss
        total = total + t.detector_loss_weight * det_loss
        metrics["detector_loss"] = det_loss
    metrics["total_loss"] = total
    return total, metrics


def model_images(images: torch.Tensor, config: Config) -> torch.Tensor:
    """uint8 [B, S, S, 3] → the model's input: float32 pixels where the
    input norm is folded into the stem, else normalized."""
    if config.model.fold_input_norm:
        return images.float()
    return normalize(images)


def batch_to(batch: dict[str, np.ndarray],
             device: torch.device) -> dict[str, torch.Tensor]:
    """The loader's numpy batch → tensors on `device`."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def _anchors(config: Config, device) -> torch.Tensor:
    return torch.tensor(all_anchors(config.train.image_size, config.detector),
                        dtype=torch.float32, device=device)


def _reduce(grads, metrics: dict[str, torch.Tensor]):
    """The gradients summed over the ranks (one flat bucket), and the
    metrics too (each rank holds its share of the global loss)."""
    flat = mesh.all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]))
    grads = [piece.view_as(g) for piece, g in
             zip(flat.split([g.numel() for g in grads]), grads)]
    values = mesh.all_reduce_sum_(
        torch.stack([v.detach().double() for v in metrics.values()]))
    metrics = {k: values[i].to(v.dtype)
               for i, (k, v) in enumerate(metrics.items())}
    return grads, metrics


def make_train_step(config: Config):
    """Returns train_step(state, batch) → (state, metrics): `batch` holds
    tensors on the state's device (`batch_to`); the state is updated in
    place and returned."""
    opt = Optimizer(config)
    anchors: dict[str, torch.Tensor] = {}

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        model = state.model
        device = batch["images"].device
        key = str(device)
        if key not in anchors:
            anchors[key] = _anchors(config, device)
        model.train()
        names, params = zip(*model.named_parameters())
        out = model(model_images(batch["images"], config))
        total, metrics = compute_losses(out, batch, config, anchors[key])
        grads = torch.autograd.grad(total, params)
        if mesh.world_size() > 1:
            grads, metrics = _reduce(grads, metrics)
        grad_norm = opt.update(list(params), list(grads),
                               [state.mu[n] for n in names],
                               [state.nu[n] for n in names], state.step)
        f = xla_arith.scalar_type(params[0])
        decay = ema_decay(config, state.step, f)
        xla_arith.ema_step([state.ema_params[n] for n in names],
                           list(params), decay, ema_weight(decay, f))
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """The model with the EMA in place of its parameters, in eval mode;
    parameters and mode are restored after."""
    model = state.model
    was_training = model.training
    with torch.no_grad():
        saved = {k: p.detach().clone() for k, p in model.named_parameters()}
        for k, p in model.named_parameters():
            p.copy_(state.ema_params[k])
    model.eval()
    try:
        yield model
    finally:
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(saved[k])
        model.train(was_training)


def make_eval_step(config: Config):
    """Returns eval_step(state, batch) → (outputs, metrics): the forward
    with the EMA parameters and the running statistics, and the losses."""
    anchors: dict[str, torch.Tensor] = {}

    def eval_step(state: TrainState, batch: dict[str, torch.Tensor]):
        device = batch["images"].device
        key = str(device)
        if key not in anchors:
            anchors[key] = _anchors(config, device)
        with ema_weights(state) as model, torch.no_grad():
            out = model(model_images(batch["images"], config))
            _, metrics = compute_losses(out, batch, config, anchors[key])
        return out, metrics

    return eval_step
