"""Tracing, timing and NaN hunting, the port of
`multiposenet_tpu/utils/profiling.py`: a device fence, a `torch.profiler`
trace written as a Chrome trace, a steady-state timer (median of
repeats), the paths of non-finite leaves in nested weights, and a scoped
trap for the first non-finite value.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) in jax.tree_util's order and `keystr` format: dict
    keys sorted, ['key'] for a key, [i] for a list or tuple index, .name
    for a dataclass field (a TrainState), tensor and array leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, torch.nn.Module):
        yield from _leaves(dict(tree.state_dict()), path)
    elif tree is not None:
        yield path, tree


def fence(tree: Any) -> None:
    """Wait for the device: synchronize the stream of the first CUDA tensor
    in `tree` (all queued work on it finishes first), else fetch one
    element of the first tensor to the host."""
    for _, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.current_stream(leaf.device).synchronize()
            elif leaf.numel():
                leaf.reshape(-1)[:1].cpu()
            return


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the block with CPU and (where present) CUDA
    activities; on exit writes `trace.json` (Chrome trace format, for
    Perfetto or chrome://tracing) under `log_dir`. Yields the profiler
    (its `key_averages()` and `events()` after the block)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def timeit(fn: Callable[[], Any], n_iters: int = 10, n_warmup: int = 2,
           n_repeats: int = 3) -> float:
    """Median steady-state seconds per call of `fn` (warm-up excluded),
    each repeat fenced on its last output."""
    out = None
    for _ in range(n_warmup):
        out = fn()
    fence(out)
    times = []
    for _ in range(n_repeats):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            out = fn()
        fence(out)
        times.append((time.perf_counter() - t0) / n_iters)
    return sorted(times)[len(times) // 2]


def find_nans(tree: Any, prefix: str = "") -> list[str]:
    """Paths (jax.tree_util.keystr format) of floating leaves holding NaN
    or Inf, in nested dicts, lists, dataclasses such as TrainState, and
    modules (their state_dict)."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            ok = (not leaf.is_floating_point()
                  or bool(torch.isfinite(leaf).all()))
        else:
            arr = np.asarray(leaf)
            ok = arr.dtype.kind != "f" or bool(np.isfinite(arr).all())
        if not ok:
            bad.append(prefix + path)
    return bad


class NonFiniteError(FloatingPointError):
    """A module's output held NaN or Inf under `debug_nans`."""


@contextlib.contextmanager
def debug_nans(module: torch.nn.Module | None = None,
               enable: bool = True) -> Iterator[None]:
    """Trap the first non-finite value in the block:
    `torch.autograd.set_detect_anomaly` (a backward op that returns NaN
    raises, naming the forward op that made it) and, with `module`, a
    forward hook on it and every submodule that raises NonFiniteError
    naming the first one whose output holds NaN or Inf.

    Unlike `jax_debug_nans`, which checks the output of every primitive,
    the forward check sees module outputs only (a NaN made and consumed
    inside one module is named by that module), and Inf raises too."""
    if not enable:
        yield
        return
    handles = []

    def hook(name):
        def check(mod, inputs, output):
            for path, leaf in _leaves(output):
                if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                        and not bool(torch.isfinite(leaf).all())):
                    raise NonFiniteError(
                        f"non-finite output{path} of module "
                        f"{name or type(mod).__name__}")
        return check

    if module is not None:
        for name, mod in module.named_modules():
            handles.append(mod.register_forward_hook(hook(name)))
    try:
        with torch.autograd.set_detect_anomaly(True):
            yield
    finally:
        for h in handles:
            h.remove()
