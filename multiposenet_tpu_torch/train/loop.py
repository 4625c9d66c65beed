"""The training loop, the port of `multiposenet_tpu/train/loop.py`:
create the state (or restore the latest checkpoint under
`train.checkpoint_dir`), run the train step over the loader's batches,
append metrics to `metrics.jsonl` there every `log_interval_steps` and at
the last step (the JAX package's keys, plus `step` and `images_per_sec`
of the global batch), and save checkpoints on the interval and at the
end.

Like the JAX loop, which trains on every device through
`make_mesh_for_batch`, it trains data-parallel over every visible card
that divides the batch (`num_devices` takes the first n;
`CUDA_VISIBLE_DEVICES` narrows them): one process a card in a process
group (`parallel/mesh.py`), this process rank 0 and one spawned process
for each other card, or inside a group already launched with ranks. The
step is the JAX step on the global batch (`train/steps.py`). Rank 0
alone writes metrics and checkpoints; every rank restores the same
checkpoint, at any world size. On several devices `batches` is a
callable `batches(rank=, world_size=)` that gives each rank its shard
iterator (`data/loader.batch_iterator` takes those arguments), since an
iterator cannot be handed to another process.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Callable, Iterator, Sequence

import torch
import torch.distributed as dist

from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.infer import predictor as predictor_lib
from multiposenet_tpu_torch.parallel import mesh as mesh_lib
from multiposenet_tpu_torch.train import steps as steps_lib
from multiposenet_tpu_torch.train.checkpoints import CheckpointManager

Batches = Iterator[dict] | Callable[..., Iterator[dict]]


def training_mesh(config: Config, device: str | torch.device | None = None,
                  num_devices: int | None = None) -> list[torch.device]:
    """The devices `train` runs on: the CPU `num_devices` times (default
    once) when the CPU is asked for, the one card asked for by its index
    ("cuda:1"), else the first `num_devices` visible cards (default all)
    cut to the largest count that divides the batch."""
    device = predictor_lib.resolve_device(device)
    if device.type == "cpu":
        return [device] * (num_devices or 1)
    if device.index is not None and num_devices is None:
        return [device]
    cards = mesh_lib.make_mesh()
    if num_devices is not None:
        if not 1 <= num_devices <= len(cards):
            raise ValueError(f"num_devices={num_devices}: {len(cards)} "
                             "cards are visible")
        cards = cards[:num_devices]
    return mesh_lib.make_mesh_for_batch(config.train.batch_size, cards)


def train(
    config: Config,
    batches: Batches,
    num_steps: int | None = None,
    log_fn: Callable[[dict], None] | None = None,
    checkpoint: bool = True,
    device: str | torch.device | None = None,
    num_devices: int | None = None,
    mesh: Sequence[torch.device] | None = None,
) -> steps_lib.TrainState:
    """Train data-parallel over `mesh` (default `training_mesh(config,
    device, num_devices)`); returns rank 0's final TrainState (every
    rank's is the same). In a process group launched with ranks it trains
    as this rank on `device` (default its card)."""
    if mesh_lib.world_size() > 1:
        rank, world = mesh_lib.rank(), mesh_lib.world_size()
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return _train_rank(config, _shards(batches, rank, world), num_steps,
                           log_fn, checkpoint, torch.device(device))
    mesh = list(mesh) if mesh is not None else training_mesh(
        config, device, num_devices)
    if len(mesh) == 1:
        return _train_rank(config, _shards(batches, 0, 1), num_steps, log_fn,
                           checkpoint, mesh[0])
    if not callable(batches):
        raise TypeError(f"training on {len(mesh)} devices takes batches as "
                        "a callable batches(rank=, world_size=) giving each "
                        "rank its shards (e.g. functools.partial of "
                        "data.loader.batch_iterator); an iterator cannot be "
                        "handed to the other ranks' processes")
    return _train_spawned(config, batches, num_steps, log_fn, checkpoint,
                          mesh)


class GlobalBatches:
    """A batch source over a list of global batches, for `train` on any
    number of devices: `batches(rank=, world_size=)` iterates over each
    batch's rows of that rank. It pickles with its batches."""

    def __init__(self, batches: Sequence[dict]):
        self.batches = list(batches)

    def __call__(self, rank: int = 0, world_size: int = 1
                 ) -> Iterator[dict]:
        return _shards(iter(self.batches), rank, world_size)


def _shards(batches: Batches, rank: int, world: int) -> Iterator[dict]:
    """This rank's shard iterator: the callable's, or (an iterator of
    global batches) its rows of each batch."""
    if callable(batches):
        return batches(rank=rank, world_size=world)
    if world == 1:
        return batches
    return ({k: mesh_lib.chunks(v, world)[rank] for k, v in b.items()}
            for b in batches)


def _train_spawned(config, batches, num_steps, log_fn, checkpoint, mesh):
    """Rank 0 here, ranks 1.. in spawned processes; every process is
    joined (and stopped if it outlives rank 0 by a minute)."""
    world, port = len(mesh), mesh_lib.free_port()
    backend = mesh_lib.backend_for(mesh)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, mesh, port, backend, config, batches,
                               num_steps, checkpoint, _torch_settings()))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        _join_group(0, mesh, port, backend)
        state = _train_rank(config, batches(rank=0, world_size=world),
                            num_steps, log_fn, checkpoint, mesh[0])
    finally:
        mesh_lib.destroy_process_group()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    failed = [r for r, p in enumerate(procs, 1) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"training ranks {failed} failed (exit codes "
                           f"{[procs[r - 1].exitcode for r in failed]})")
    return state


def _join_group(rank: int, mesh, port: int, backend: str) -> None:
    if mesh[rank].type == "cuda":
        torch.cuda.set_device(mesh[rank])
    mesh_lib.init_process_group(rank, len(mesh), port, backend)


def _torch_settings() -> tuple:
    """What a spawned rank takes from this process: torch's threads,
    default dtype, and TF32 for cuDNN convolutions and cuBLAS matmuls."""
    return (torch.get_num_threads(), torch.get_default_dtype(),
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _rank_main(rank, mesh, port, backend, config, batches, num_steps,
               checkpoint, settings) -> None:
    """A spawned rank (with the parent's torch settings): join the group,
    train on its shards, leave."""
    threads, dtype, cudnn_tf32, matmul_tf32 = settings
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    _join_group(rank, mesh, port, backend)
    try:
        _train_rank(config, batches(rank=rank, world_size=len(mesh)),
                    num_steps, None, checkpoint, mesh[rank])
    finally:
        mesh_lib.destroy_process_group()


def _train_rank(config: Config, batches: Iterator[dict],
                num_steps: int | None, log_fn, checkpoint: bool,
                device: torch.device) -> steps_lib.TrainState:
    t = config.train
    num_steps = num_steps if num_steps is not None else t.num_steps
    lead = mesh_lib.rank() == 0
    state = steps_lib.create_train_state(config, t.seed, device=device)
    start_step = 0
    mgr = None
    if checkpoint:
        mgr = CheckpointManager(t.checkpoint_dir, t.save_interval_steps,
                                t.max_to_keep)
        state, start_step = mgr.restore(state)
        if mesh_lib.world_size() > 1:
            dist.barrier()  # every rank restored before rank 0 saves
    train_step = steps_lib.make_train_step(config)

    metrics_path = Path(t.checkpoint_dir) / "metrics.jsonl"
    if lead:
        metrics_path.parent.mkdir(parents=True, exist_ok=True)
    t_last = time.time()
    step = start_step
    with (metrics_path.open("a") if lead else contextlib.nullcontext()
          ) as metrics_file:
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
                if lead:
                    metrics_file.write(json.dumps(metrics) + "\n")
                    metrics_file.flush()
                    if log_fn:
                        log_fn(metrics)
            if lead and mgr is not None and mgr.should_save(step):
                mgr.save(state)
        if lead and mgr is not None:
            mgr.save(state, force=True)
    return state
