"""The training loop on one device, the port of
`multiposenet_tpu/train/loop.py`: create the state (or restore the
latest checkpoint under `train.checkpoint_dir`), run the train step over
the loader's batches, append metrics to `metrics.jsonl` there every
`log_interval_steps` and at the last step (the JAX package's keys, plus
`step` and `images_per_sec`), and save checkpoints on the interval and
at the end.

Data parallelism over several devices (the JAX package's mesh,
`parallel/mesh.py`) is not ported: asking for more than one device
raises.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Iterator

import torch

from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.infer import predictor as predictor_lib
from multiposenet_tpu_torch.train import steps as steps_lib
from multiposenet_tpu_torch.train.checkpoints import CheckpointManager


def train(
    config: Config,
    batches: Iterator[dict],
    num_steps: int | None = None,
    log_fn: Callable[[dict], None] | None = None,
    checkpoint: bool = True,
    device: str | torch.device | None = None,
    num_devices: int = 1,
) -> steps_lib.TrainState:
    """Run training on `device` (the CUDA card unless given); returns the
    final TrainState."""
    if num_devices != 1:
        raise NotImplementedError(
            f"training on {num_devices} devices needs data parallelism "
            "(DDP, the port of parallel/mesh.py), which is not ported; "
            "train on one device")
    t = config.train
    num_steps = num_steps if num_steps is not None else t.num_steps
    device = predictor_lib.resolve_device(device)
    state = steps_lib.create_train_state(config, t.seed, device=device)
    start_step = 0
    mgr = None
    if checkpoint:
        mgr = CheckpointManager(t.checkpoint_dir, t.save_interval_steps,
                                t.max_to_keep)
        state, start_step = mgr.restore(state)
    train_step = steps_lib.make_train_step(config)

    metrics_path = Path(t.checkpoint_dir) / "metrics.jsonl"
    metrics_path.parent.mkdir(parents=True, exist_ok=True)
    t_last = time.time()
    step = start_step
    with metrics_path.open("a") as metrics_file:
        for batch in batches:
            if step >= num_steps:
                break
            state, metrics = train_step(state,
                                        steps_lib.batch_to(batch, device))
            step += 1
            if step % t.log_interval_steps == 0 or step == num_steps:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                metrics.update(
                    step=step,
                    images_per_sec=(t.log_interval_steps * t.batch_size
                                    / max(now - t_last, 1e-9)),
                )
                t_last = now
                metrics_file.write(json.dumps(metrics) + "\n")
                metrics_file.flush()
                if log_fn:
                    log_fn(metrics)
            if mgr is not None and mgr.should_save(step):
                mgr.save(state)
        if mgr is not None:
            mgr.save(state, force=True)
    return state
