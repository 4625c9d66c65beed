"""PRN training, the port of `multiposenet_tpu/train/prn_train.py`: the
pose residual network learns on ground-truth boxes, from heatmaps
synthesized on the device from every person's ground-truth keypoints
(Gaussians at the keypoints of all persons, so that the PRN learns to
pick the box's own person), cropped and resized to the PRN grid, with a
softmax cross-entropy against the one-hot ground-truth cell, masked by
visibility and validity, and Adam.

- Adam is optax.adam(1e-3): b1 0.9, b2 0.999, eps 1e-8, eps_root 0, no
  weight decay, a constant rate, in optax's order of operations.
- The cell index rounds half to even (jnp.round) and is column-major,
  j * crop_height + i, the PRN's channel-major layout.
- Window jitter (config.prn.window_jitter) moves each box edge by
  Uniform(±jitter × side), drawn from a generator seeded by
  (train.seed + 1, step), so that a resumed run draws what the
  uninterrupted one would. `prn_loss_fn` takes the draws as an argument.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch

from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.data import targets as targets_lib
from multiposenet_tpu_torch.infer import predictor as predictor_lib
from multiposenet_tpu_torch.models.prn import PRN
from multiposenet_tpu_torch.ops import prn_ops

ADAM_LR, ADAM_B1, ADAM_B2, ADAM_EPS = 1e-3, 0.9, 0.999, 1e-8
# The batch keys a PRN step reads.
BATCH_KEYS = ("keypoints", "boxes", "valid", "iscrowd")


@dataclasses.dataclass
class PRNTrainState:
    """step (updates applied), the PRN (its parameters on its device) and
    the Adam moments keyed by parameter name."""

    step: int
    model: PRN
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def state_dict(self) -> dict[str, Any]:
        """Everything a checkpoint holds, as CPU tensors."""
        def cpu(d):
            return {k: v.detach().cpu().clone() for k, v in d.items()}
        return {"step": self.step, "params": cpu(self.params),
                "mu": cpu(self.mu), "nu": cpu(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, sd: dict[str, Any]) -> None:
        """Copy a `state_dict()` into this state (same PRN)."""
        self.step = int(sd["step"])
        for name, dest in (("params", self.params), ("mu", self.mu),
                           ("nu", self.nu)):
            if sorted(sd[name]) != sorted(dest):
                raise ValueError(f"checkpoint {name} do not match the "
                                 "PRN's names")
            for k, t in dest.items():
                t.copy_(sd[name][k])


def make_prn(config: Config, dtype: torch.dtype = torch.float32) -> PRN:
    return PRN(config.prn.crop_height, config.prn.crop_width,
               config.model.num_keypoints, config.prn.hidden_units,
               dtype=dtype)


def crop_cell_targets(keypoints: torch.Tensor, boxes: torch.Tensor,
                      crop_height: int, crop_width: int,
                      stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth keypoints [..., 17, 3] and boxes [..., 4] (input
    pixels) → (cell [..., 17], the nearest crop cell's column-major flat
    index j * crop_height + i; weight [..., 17], 1 where the keypoint is
    visible and inside the box's crop). Inverts prn_ops.interp_matrix:
    cell i samples y0 + (i + 0.5) * bh / ch - 0.5."""
    y0 = boxes[..., 0:1] / stride
    x0 = boxes[..., 1:2] / stride
    bh = ((boxes[..., 2:3] - boxes[..., 0:1]) / stride).clamp(min=1e-3)
    bw = ((boxes[..., 3:4] - boxes[..., 1:2]) / stride).clamp(min=1e-3)
    ky = keypoints[..., 1] / stride
    kx = keypoints[..., 0] / stride
    fi = (ky - y0 + 0.5) * crop_height / bh - 0.5
    fj = (kx - x0 + 0.5) * crop_width / bw - 0.5
    i = torch.round(fi).clamp(0, crop_height - 1).long()
    j = torch.round(fj).clamp(0, crop_width - 1).long()
    inside = ((fi >= -0.5) & (fi <= crop_height - 0.5)
              & (fj >= -0.5) & (fj <= crop_width - 0.5))
    weight = ((keypoints[..., 2] > 0) & inside).to(torch.float32)
    return j * crop_height + i, weight


def jitter_draws(config: Config, step: int,
                 boxes: torch.Tensor) -> torch.Tensor:
    """Uniform(-jitter, jitter) of the boxes' shape for update `step`, from
    a CPU generator seeded by (train.seed + 1, step)."""
    j = config.prn.window_jitter
    # torch's CPU generator keeps 32 bits of a seed: mix the pair first.
    seed = np.random.SeedSequence([config.train.seed + 1, step])
    gen = torch.Generator().manual_seed(int(seed.generate_state(1)[0]))
    u = torch.rand(boxes.shape, generator=gen, dtype=torch.float64)
    return (u * (2 * j) - j).to(boxes.dtype).to(boxes.device)


def prn_loss_fn(prn: PRN, batch: dict[str, torch.Tensor], config: Config,
                u: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Softmax cross-entropy of the PRN's output against the one-hot
    ground-truth cell, masked (returns (loss, metrics)). `u` are the
    window jitter's draws in [-jitter, jitter], boxes-shaped; the jitter
    applies where config.prn.window_jitter > 0 and `u` is given."""
    m, p_cfg = config.model, config.prn
    stride = m.output_stride
    hm = config.train.image_size // stride
    heatmaps = targets_lib.batched_keypoint_heatmaps(
        batch["keypoints"], hm, hm, stride)                 # [B, H, W, K]
    boxes = batch["boxes"]
    if p_cfg.window_jitter > 0.0 and u is not None:
        # The inference windows are detector boxes, not exact ground
        # truth: move each edge; the cell targets below use the same
        # moved box, and keypoints pushed out of it are masked.
        h = boxes[..., 2:3] - boxes[..., 0:1]
        w = boxes[..., 3:4] - boxes[..., 1:2]
        boxes = boxes + u * torch.cat([h, w, h, w], dim=-1)
    # The crop margin of inference (predictor._prn_assign).
    boxes = prn_ops.expand_boxes(boxes, p_cfg.crop_margin)
    crops = prn_ops.batched_crop_heatmaps(
        heatmaps, boxes / stride, p_cfg.crop_height, p_cfg.crop_width)
    b, p = crops.shape[:2]
    crops_km = prn_ops.to_channel_major(crops, m.num_keypoints)
    logits = prn(crops_km, return_logits=True)  # [B*P, K, hw]
    log_probs = torch.log_softmax(logits, dim=-1)

    cell, weight = crop_cell_targets(batch["keypoints"], boxes,
                                     p_cfg.crop_height, p_cfg.crop_width,
                                     stride)
    cell = cell.reshape(b * p, m.num_keypoints)
    person_ok = (batch["valid"] & ~batch["iscrowd"]).reshape(b * p)
    weight = weight.reshape(b * p, m.num_keypoints) * person_ok[:, None]
    picked = torch.gather(log_probs, -1, cell[..., None])[..., 0]
    count = weight.sum().clamp(min=1.0)
    ce = -(picked * weight).sum() / count
    hit = (torch.argmax(logits, dim=-1) == cell).to(weight.dtype)
    acc = (hit * weight).sum() / count
    return ce, {"prn_loss": ce, "prn_accuracy": acc}


def create_prn_state(config: Config, device: str | torch.device = "cuda",
                     dtype: torch.dtype = torch.float32,
                     prn: PRN | None = None) -> PRNTrainState:
    """The PRN from the port's init seeded by train.seed (or `prn` as
    given), on `device`, with zero Adam moments."""
    if prn is None:
        prn = make_prn(config, dtype)
        prn.init_weights(torch.Generator().manual_seed(config.train.seed))
    prn.to(device=device, dtype=dtype).train()
    params = dict(prn.named_parameters())
    return PRNTrainState(
        step=0, model=prn,
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()})


@torch.no_grad()
def adam_update(state: PRNTrainState, grads: dict[str, torch.Tensor]) -> None:
    """optax.adam(1e-3) on the state's parameters, in place: the moments,
    then p + (-lr) · (m / (1 - b1^n)) / (√(v / (1 - b2^n)) + eps) at
    n = step + 1."""
    n = state.step + 1
    bc1, bc2 = 1.0 - ADAM_B1 ** n, 1.0 - ADAM_B2 ** n
    for k, p in state.params.items():
        g, mu, nu = grads[k], state.mu[k], state.nu[k]
        mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        nu.mul_(ADAM_B2).add_(g * g, alpha=1.0 - ADAM_B2)
        upd = (mu / bc1) / ((nu / bc2).sqrt() + ADAM_EPS)
        p.add_(upd * -ADAM_LR)


def make_prn_train_step(config: Config):
    """Returns step(state, batch) → (state, metrics): `batch` holds the
    BATCH_KEYS tensors on the PRN's device; the state updates in place."""

    def step(state: PRNTrainState, batch: dict[str, torch.Tensor]):
        u = (jitter_draws(config, state.step, batch["boxes"])
             if config.prn.window_jitter > 0.0 else None)
        loss, metrics = prn_loss_fn(state.model, batch, config, u)
        names, params = zip(*state.model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        adam_update(state, dict(zip(names, grads)))
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def train_prn(config: Config, batches: Iterator[dict], num_steps: int,
              log_fn: Callable[[dict], None] | None = None,
              checkpoint_dir: str | None = None,
              save_interval_steps: int = 500, max_to_keep: int = 2,
              device: str | torch.device | None = None,
              prn: PRN | None = None) -> PRNTrainState:
    """Standalone PRN training on `device` (the CUDA card unless given),
    from the port's init or `prn`, with optional checkpoint and resume
    under `checkpoint_dir`; metrics (prn_loss, prn_accuracy, step) go to
    `log_fn` every 50 steps."""
    device = predictor_lib.resolve_device(device)
    state = create_prn_state(config, device, prn=prn)
    mgr = None
    done = 0
    if checkpoint_dir:
        from multiposenet_tpu_torch.train.checkpoints import CheckpointManager

        mgr = CheckpointManager(checkpoint_dir, save_interval_steps,
                                max_to_keep)
        state, done = mgr.restore(state)
    step_fn = make_prn_train_step(config)
    # Checked before a batch is pulled: a finished run reads none.
    it = iter(batches)
    while done < num_steps:
        batch = next(it, None)
        if batch is None:
            break
        batch = {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
                 for k in BATCH_KEYS}
        state, metrics = step_fn(state, batch)
        done += 1
        if log_fn and done % 50 == 0:
            log_fn({k: float(v) for k, v in metrics.items()} | {"step": done})
        if mgr and mgr.should_save(done):
            mgr.save(state)
    if mgr:
        mgr.save(state, force=True)
    return state
