"""Where the port's trainer and the JAX package's part, at the recipe of
the JAX smoke gate (tests/test_integration_smoke.py).

    python tests/torch_trainer_gap.py curves [--steps 16] [--port-schedule]
    python tests/torch_trainer_gap.py onestep [--steps 100]
    python tests/torch_trainer_gap.py seeds [--seeds 0 1 2 3 4] [--procs 5]

`curves` runs both training steps side by side, float64 all the way, from
the JAX package's init on the same numpy batches, and prints one JSON line
a step: every loss, the gradient norm, and the largest parameter, EMA and
batch-statistic difference, each over its tensor's largest magnitude.
Float64 all the way means:
- the JAX step under jax.enable_x64 with its state cast to float64 and the
  model at compute_dtype float64, and the float32 its modules name
  (`models/posenet.py`'s heatmap and segmentation casts, `train/steps.py`'s
  logit, delta and EMA-count casts) read as float64 (`float64_jax`);
- the port at compute_dtype float64 with float64 parameters, whose step
  forms its scalars in float64;
- the batches' float32 arrays as float64;
- the one float32 left on both sides is optax's learning-rate schedule:
  the port is handed the JAX package's compiled values, which its own
  float32 schedule now equals bit for bit (`--port-schedule` keeps the
  port's own; the first line counts the counts where the two differ).

`onestep` trains the JAX package in float32 at the smoke recipe from
PRNGKey(0) on one device, and at every step k carries its whole state
(parameters, batch statistics, Adam's moments, the EMA, the count) into
the port and takes one port float32 step on the same batch. Beside it, the
JAX step's own spread under another reduction order: the same step from
the same state on the 8 host devices' data-parallel mesh. Each prints,
per step, its relative gap to the one-device JAX step in every loss, the
gradient norm and the batch statistics, and its parameter update's gap
over the learning rate, |Δp - Δp_jax| / lr (largest and mean, and the
tensor with the largest mean); a last line sums each up over the steps.

`seeds` trains each package at the smoke recipe from PRNGKey(s), the port
from the JAX init carried across (tests/torch_quality_helpers.py), each
run in its own process on one torch thread, and prints each one's gate
statistics; `--runs` adds the same training with another reduction order
(`RUNS`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

if __name__ == "__main__":
    # The test environment of tests/conftest.py: the CPU, 8 devices.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(1, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.data.loader import batch_iterator
from multiposenet_tpu.data.synthetic import make_dataset
from multiposenet_tpu.models import posenet as jposenet
from multiposenet_tpu.parallel import mesh as jmesh
from multiposenet_tpu.train import steps as jsteps
from multiposenet_tpu_torch import weights
from multiposenet_tpu_torch.models.posenet import MultiPoseNet
from multiposenet_tpu_torch.train import steps as tsteps

import torch_quality_helpers as quality

CPU = torch.device("cpu")


class _Float64Numpy:
    """jax.numpy with `float32` read as float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def float64_jax():
    """The JAX package's posenet and train-step modules with every float32
    they name read as float64, and jax_enable_x64 on, for tracing."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for module in (jposenet, jsteps):
            mp.setattr(module, "jnp", _Float64Numpy())
        yield


def _f64(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float64)
                        if x.dtype == jnp.float32 else x, tree)


def smoke_batches(steps: int) -> list[dict]:
    """The smoke gate's first `steps` batches (its records, its loader),
    float32 arrays as float64."""
    records = quality.gate_records(make_dataset, 48, 0)
    it = batch_iterator(records, 8, quality.SIZE, 4, train=True,
                        augment=False)
    return [{k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in next(it).items()} for _ in range(steps)]


def _rel(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want)


def _port_names(tree) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in weights.posenet_state_dict(
        {"params": tree}).items()}


def _port_stats(tree) -> dict[str, np.ndarray]:
    flat = weights._flatten(tree)
    return {f"{k.rsplit('.', 1)[0]}.running_{k.rsplit('.', 1)[1]}": v
            for k, v in flat.items()}


def curves(steps: int, port_schedule: bool = False, seed: int = 0
           ) -> list[dict]:
    """Both steps over the smoke gate's first `steps` batches, float64
    all the way (module docstring). One row a step: each metric as
    (JAX, port, relative difference), and the largest relative
    difference of the parameters, EMA and batch statistics."""
    cfg = quality.gate_config("smoke", seed, compute_dtype="float64")
    batches = smoke_batches(steps)
    with float64_jax():
        state = _f64(jsteps.create_train_state(cfg, jax.random.PRNGKey(seed)))
        init = jax.tree.map(np.asarray, {"params": state.params,
                                         "batch_stats": state.batch_stats})
        step = jax.jit(jsteps.make_train_step(cfg))
        schedule = jax.jit(jsteps.make_learning_rate(cfg))
        lr = [float(schedule(jnp.asarray(c, jnp.int32)))
              for c in range(steps)]
        jax_rows = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()})
            jax_rows.append(({k: float(x) for k, x in m.items()},
                             jax.tree.map(np.asarray, (
                                 state.params, state.ema_params,
                                 state.batch_stats))))
    tcfg = quality.gate_config("smoke", seed, package=quality.torch_config,
                               compute_dtype="float64")
    model = MultiPoseNet(tcfg).double()
    weights.load_posenet(model, init)
    ts = tsteps.create_train_state(tcfg, model=model, device=CPU)
    with contextlib.ExitStack() as stack:
        if not port_schedule:
            mp = stack.enter_context(pytest.MonkeyPatch.context())
            mp.setattr(tsteps, "make_learning_rate",
                       lambda config: lr.__getitem__)
        tstep = tsteps.make_train_step(tcfg)
    rows = []
    for i, b in enumerate(batches):
        ts, m = tstep(ts, tsteps.batch_to(b, CPU))
        jm, (jp, je, jb) = jax_rows[i]
        row = {"step": i + 1}
        for k, want in jm.items():
            got = float(m[k])
            row[k] = [want, got, abs(got - want) / max(abs(want), 1e-30)]
        row["params"] = _rel({k: v.detach().numpy()
                              for k, v in ts.params.items()}, _port_names(jp))
        row["ema_params"] = _rel({k: v.numpy()
                                  for k, v in ts.ema_params.items()},
                                 _port_names(je))
        row["batch_stats"] = _rel({k: v.numpy()
                                   for k, v in ts.batch_stats.items()},
                                  _port_stats(jb))
        rows.append(row)
    return rows


def _jax_step(cfg, devices: int):
    """The JAX package's train step as its loop jits it, on a mesh of the
    first `devices` devices, and a function that puts a batch there."""
    mesh = jmesh.make_mesh(jax.devices()[:devices])
    repl = jmesh.replicated(mesh)
    step = jax.jit(jsteps.make_train_step(cfg),
                   in_shardings=(repl, jmesh.batch_sharding(mesh)),
                   out_shardings=(repl, repl))

    def run(state, batch):
        batch = jmesh.shard_batch({k: jnp.asarray(v)
                                   for k, v in batch.items()}, mesh)
        state, metrics = step(jmesh.replicate(state, mesh), batch)
        return jax.device_get(state), {k: float(v) for k, v in
                                       jax.device_get(metrics).items()}

    return run


def _carry(ts, state) -> None:
    """The JAX package's float32 TrainState into the port's `ts`."""
    weights.load_posenet(ts.model, {"params": state.params,
                                    "batch_stats": state.batch_stats})
    adam = state.opt_state[1][0]
    with torch.no_grad():
        for dest, tree in ((ts.ema_params, state.ema_params),
                           (ts.mu, adam.mu), (ts.nu, adam.nu)):
            for k, v in _port_names(tree).items():
                dest[k].copy_(torch.as_tensor(v))
    ts.step = int(state.step)


def _gaps(metrics: dict, want_metrics: dict, before: dict, after: dict,
          want_after: dict, stats: dict, want_stats: dict,
          lr: float) -> dict:
    """One step's gaps to the one-device JAX step (module docstring)."""
    row = {k: abs(metrics[k] - w) / max(abs(w), 1e-30)
           for k, w in want_metrics.items()}
    row["batch_stats"] = _rel(stats, want_stats)
    if lr > 0:
        per = {k: np.abs((after[k] - before[k]) - (want_after[k]
                                                   - before[k])) / lr
               for k in before}
        worst = max(per, key=lambda k: per[k].mean())
        row["update_max"] = max(float(v.max()) for v in per.values())
        row["update_mean"] = float(
            sum(v.sum() for v in per.values())
            / sum(v.size for v in per.values()))
        row["update_worst_tensor"] = worst
        row["update_worst_tensor_mean"] = float(per[worst].mean())
    return row


def onestep(steps: int, seed: int = 0) -> list[dict]:
    """`onestep` (module docstring): one row a step, the last the
    summary over the steps."""
    cfg = quality.gate_config("smoke", seed)
    records = quality.gate_records(make_dataset, 48, 0)
    it = batch_iterator(records, 8, quality.SIZE, cfg.prn.max_persons,
                        train=True, augment=False)
    batches = [next(it) for _ in range(steps)]
    one, eight = _jax_step(cfg, 1), _jax_step(cfg, 8)
    schedule = jax.jit(jsteps.make_learning_rate(cfg))
    tcfg = quality.gate_config("smoke", seed, package=quality.torch_config)
    state = jax.device_get(jsteps.create_train_state(
        cfg, jax.random.PRNGKey(seed)))
    ts = tsteps.create_train_state(tcfg, model=MultiPoseNet(tcfg),
                                   device=CPU)
    tstep = tsteps.make_train_step(tcfg)
    rows = []
    for k, batch in enumerate(batches):
        lr = float(schedule(jnp.asarray(k, jnp.int32)))
        before = _port_names(state.params)
        nxt, jm = one(state, batch)
        want_after = _port_names(nxt.params)
        want_stats = _port_stats(nxt.batch_stats)
        e8, m8 = eight(state, batch)
        _carry(ts, state)
        ts, pm = tstep(ts, tsteps.batch_to(batch, CPU))
        port = {k2: float(v) for k2, v in pm.items()}
        rows.append({
            "step": k + 1, "lr": lr,
            "port": _gaps(port, jm, before, {
                n: v.detach().numpy() for n, v in ts.params.items()},
                want_after, {n: v.numpy() for n, v in
                             ts.batch_stats.items()}, want_stats, lr),
            "jax_8_devices": _gaps(m8, jm, before, _port_names(e8.params),
                                   want_after, _port_stats(e8.batch_stats),
                                   want_stats, lr)})
        state = nxt
    summary = {"summary": True, "steps": steps}
    for run in ("port", "jax_8_devices"):
        keys = [k for k, v in rows[-1][run].items()
                if isinstance(v, float)]
        summary[run] = {k: {"median": float(np.median(
            [r[run][k] for r in rows if k in r[run]])),
            "max": float(max(r[run][k] for r in rows if k in r[run]))}
            for k in keys}
    rows.append(summary)
    return rows


# The runs `seeds` takes: each package as the smoke gate trains it, and
# one change of reduction order each (the JAX package on its 8-device
# data-parallel mesh, as the slow gate trains; the port on 4 torch threads).
RUNS = {
    "jax": lambda seed: quality.jax_gate("smoke", seed),
    "jax_8_devices": lambda seed: quality.jax_gate("smoke", seed,
                                                   devices=8),
    "port": lambda seed: quality.port_gate("smoke", seed),
    "port_4_threads": lambda seed: quality.port_gate("smoke", seed,
                                                     threads=4),
}


def schedule_ulps(cfg) -> dict:
    """The port's float32 schedule against the JAX package's compiled
    one at every count up to num_steps: how many differ, and by how many
    float32 ulps at most."""
    compiled = jax.jit(jsteps.make_learning_rate(cfg))
    port = tsteps.make_learning_rate(quality.torch_config.Config.from_dict(
        cfg.to_dict()))
    counts = range(cfg.train.num_steps + 1)
    ulps = [abs(int(np.float32(port(c)).view(np.int32))
                - int(np.asarray(compiled(jnp.asarray(c, jnp.int32)),
                                 np.float32).view(np.int32)))
            for c in counts]
    return {"schedule_counts": len(ulps),
            "schedule_counts_differing": sum(u > 0 for u in ulps),
            "schedule_max_ulps": max(ulps)}


def _seed_run(task: tuple[str, int]) -> dict:
    run, seed = task
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    stats = RUNS[run](seed)
    return {"run": run, "seed": seed,
            "seconds": time.perf_counter() - t0, **stats}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="what", required=True)
    c = sub.add_parser("curves")
    c.add_argument("--steps", type=int, default=16)
    c.add_argument("--port-schedule", action="store_true")
    o = sub.add_parser("onestep")
    o.add_argument("--steps", type=int, default=100)
    s = sub.add_parser("seeds")
    s.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    s.add_argument("--runs", nargs="+", default=["jax", "port"],
                   choices=sorted(RUNS))
    s.add_argument("--procs", type=int, default=5)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    if args.what == "curves":
        torch.set_num_threads(1)
        print(json.dumps(schedule_ulps(quality.gate_config("smoke"))))
        for row in curves(args.steps, args.port_schedule):
            print(json.dumps(row), flush=True)
        return
    if args.what == "onestep":
        torch.set_num_threads(1)
        for row in onestep(args.steps):
            print(json.dumps(row), flush=True)
        return
    import multiprocessing

    tasks = [(r, s) for s in args.seeds for r in args.runs]
    with multiprocessing.get_context("spawn").Pool(args.procs) as pool:
        for row in pool.imap(_seed_run, tasks):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
