"""Checkpoint and resume, the port of `multiposenet_tpu/train/checkpoints.py`
with orbax's save policy: a step is saved when no checkpoint exists yet
or when it falls on `save_interval_steps`, never at or before the latest
saved step (unless forced past it), and the newest `max_to_keep` are
kept.

A checkpoint is one `torch.save` file of a whole state's `state_dict()`
(TrainState: step, parameters, EMA, batch statistics, Adam moments;
PRNTrainState of `train/prn_train.py`: step, parameters, Adam moments),
written to a temporary name and renamed into place. Orbax's format
cannot be read without JAX, so the two packages exchange models through
the export (`infer/export.py`), not through checkpoints.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from multiposenet_tpu_torch.train.steps import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Saves and restores training states (anything with `step`,
    `state_dict()` and `load_state_dict()`) under `directory` as
    `ckpt_<step>.pt`."""

    def __init__(self, directory: str | Path,
                 save_interval_steps: int = 1000, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        """orbax's decision: the first checkpoint, then every
        `save_interval_steps`, and only past the latest saved step."""
        latest = self.latest_step()
        if latest is None:
            return True
        return latest < step and step % self.save_interval_steps == 0

    def save(self, state: TrainState, force: bool = False) -> bool:
        """Save `state` if the policy (or `force`) says so; False if its
        step is already the latest saved."""
        step = int(state.step)
        latest = self.latest_step()
        if latest == step or not (force or self.should_save(step)):
            return False
        path = self.directory / f"ckpt_{step}.pt"
        tmp = path.with_suffix(".pt.tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            (self.directory / f"ckpt_{old}.pt").unlink()
        return True

    def restore(self, state: TrainState) -> tuple[TrainState, int]:
        """Load the latest checkpoint into `state` (same model). Returns
        (state, step); (state, 0) untouched if none exists."""
        step = self.latest_step()
        if step is None:
            return state, 0
        sd = torch.load(self.directory / f"ckpt_{step}.pt",
                        map_location="cpu", weights_only=True)
        state.load_state_dict(sd)
        return state, step
