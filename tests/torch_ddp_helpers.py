"""Multi-process harness of the port's data-parallel tests
(tests/test_torch_ddp.py): `run_ranks` starts `world` CPU processes in a
gloo process group, runs one of the jobs below as each rank, and returns
what each rank saved. The module imports torch and the port only, so that
the spawned processes start quickly; they inherit the parent's sys.path.
"""

from __future__ import annotations

import multiprocessing
from pathlib import Path

import torch

from multiposenet_tpu_torch.models.layers import BatchNorm
from multiposenet_tpu_torch.parallel import mesh
from multiposenet_tpu_torch.train import loop

CPU = torch.device("cpu")


def checksum(state_dict: dict) -> float:
    """One number for a TrainState's parameters, statistics and moments."""
    return float(sum(v.double().sum() for key in
                     ("params", "batch_stats", "ema_params", "mu", "nu")
                     for v in state_dict[key].values()))


def job_steps(cfg, batches, steps):
    """Train `steps` steps as this rank (the loop inside a launched group,
    from the checkpoint under cfg.train.checkpoint_dir) with float64
    parameters (torch's default dtype float64), then run BatchNorm on this
    rank's rows of a batch whose shards have different channel means."""
    logged = []
    torch.set_default_dtype(torch.float64)
    state = loop.train(cfg, loop.GlobalBatches(batches), steps,
                       log_fn=logged.append, device=CPU)
    sd = state.state_dict()
    bn = BatchNorm(3).double().train()
    x = bn_input()
    part = mesh.chunks(x, mesh.world_size())[mesh.rank()].requires_grad_()
    y = bn(part)
    (y * y).sum().backward()
    grads = torch.cat([bn.weight.grad, bn.bias.grad]).double()
    return {"state": sd, "checksum": checksum(sd), "metrics": logged,
            "bn_out": y.detach(), "bn_stats": (bn.running_mean.clone(),
                                               bn.running_var.clone()),
            "bn_grads": mesh.all_reduce_sum_(grads)}


def bn_input() -> torch.Tensor:
    """[8, 3, 5, 4] float64 whose quarters of the batch have channel means
    0, 3, -2 and 7."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 3, 5, 4, generator=g, dtype=torch.float64)
    return x + torch.tensor([0.0, 3.0, -2.0, 7.0],
                            dtype=torch.float64).repeat_interleave(2)[
        :, None, None, None]


def _worker(rank: int, world: int, port: int, job, args, out: str) -> None:
    torch.set_num_threads(1)
    mesh.init_process_group(rank, world, port, "gloo")
    try:
        torch.save(job(*args), Path(out) / f"rank{rank}.pt")
    finally:
        mesh.destroy_process_group()


def run_ranks(world: int, job, args, out: Path) -> list[dict]:
    """Run job(*args) as each of `world` CPU ranks; their results in rank
    order. A rank that fails fails the call."""
    ctx = multiprocessing.get_context("spawn")
    port = mesh.free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, world, port, job, args, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        if p.is_alive():
            p.terminate()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"ranks exited with {codes}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
