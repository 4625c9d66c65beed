"""Data parallelism over several devices, the port of
`multiposenet_tpu/parallel/mesh.py`.

The JAX package's mesh is a 1-D `Mesh(('data',))`: the batch is sharded
over it and the parameters are replicated, and a sharded step is the same
function as the one-device step on the whole global batch. Here a mesh is
a list of `torch.device`s, one per shard:

- `make_mesh` takes every visible CUDA card (the CPU only when the caller
  passes it), `make_mesh_for_batch` the largest count of them that
  divides the batch, as the JAX function does;
- `shard_batch` splits the leading dimension into per-device chunks in
  order, `replicate` copies a module onto every device of the mesh.

Training runs one process per device in a `torch.distributed` process
group (`init_process_group`, `destroy_process_group`, `rank`,
`world_size`): NCCL where every rank has a card of its own, gloo for CPU
ranks and for ranks that share a card (gloo reduces CUDA tensors through
the host). `all_reduce_sum` is the sum over ranks with its gradient (the
sum of the ranks' gradients), which the global-batch BatchNorm statistics
and the loss denominators take; `all_reduce_sum_` sums in place without
one (gradients, metrics). Without a process group both return their input.
"""

from __future__ import annotations

import copy
import datetime
import socket
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def canonical(device: torch.device | str) -> torch.device:
    """The device with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices: Sequence[torch.device | str] | None = None
              ) -> list[torch.device]:
    """Every visible CUDA card, or the given devices. Raises without a
    card: CPU meshes are asked for by passing CPU devices."""
    if devices is not None:
        return [canonical(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA card is visible; pass the "
                           "devices (e.g. [torch.device('cpu')] * n) to run "
                           "on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh_for_batch(batch_size: int,
                        devices: Sequence[torch.device | str] | None = None
                        ) -> list[torch.device]:
    """The mesh over the largest device count that divides batch_size:
    batch 2 on an 8-card host uses 2 cards."""
    devices = make_mesh(devices)
    n = len(devices)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return devices[:n]


def chunks(x: Any, n: int) -> list[Any]:
    """n equal chunks of x's leading dimension, in order; raises where n
    does not divide it."""
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not shard evenly "
                         f"over {n} devices")
    size = x.shape[0] // n
    return [x[i * size:(i + 1) * size] for i in range(n)]


def shard_batch(batch: Any, mesh: Sequence[torch.device]) -> list[Any]:
    """A tensor or array (or a dict of them) → one chunk of its leading
    dimension per device, in order, each moved to its device as a tensor.
    A batch the mesh does not divide raises."""
    n = len(mesh)
    if isinstance(batch, dict):
        parts = {k: shard_batch(v, mesh) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    parts = chunks(batch if isinstance(batch, torch.Tensor)
                   else torch.as_tensor(np.asarray(batch)), n)
    return [c.to(d, non_blocking=True) for c, d in zip(parts, mesh)]


def replicate(module: nn.Module, mesh: Sequence[torch.device]
              ) -> list[nn.Module]:
    """One copy of `module` on each device of the mesh, all holding the
    same state_dict as `module` (which serves its own device when it lies
    on the mesh)."""
    own = next(module.parameters()).device
    return [module if d == own else copy.deepcopy(module).to(d)
            for d in mesh]


def backend_for(mesh: Sequence[torch.device]) -> str:
    """NCCL when every rank has a CUDA card of its own, else gloo."""
    cards = [d for d in mesh if d.type == "cuda"]
    if len(cards) == len(mesh) and len({d.index for d in cards}) == len(mesh):
        return "nccl"
    return "gloo"


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(rank: int, world: int, port: int, backend: str,
                       timeout: datetime.timedelta = datetime.timedelta(
                           minutes=5)) -> None:
    """Join a process group of `world` ranks at tcp://localhost:port; a
    rank waits `timeout` for the others at a collective. A group that
    does not form raises."""
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world, timeout=timeout)


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x; the gradient of x is Σ_ranks (the gradient of y)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks, differentiable: its gradient on each
    rank is the sum of the ranks' gradients of the result."""
    if world_size() == 1:
        return x
    return _AllReduceSum.apply(x)


@torch.no_grad()
def all_reduce_sum_(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks in place (no gradient)."""
    if world_size() > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x
