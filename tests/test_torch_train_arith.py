"""The port's training arithmetic outside the model against the JAX
package's as `jax.jit` compiles it on the CPU, which is how its train step
runs it (`multiposenet_tpu_torch/train/xla_arith.py` says what the
compiler does): bit for bit on identical float32 inputs.

- the learning-rate schedule at every count of the smoke and slow gates'
  recipes, and at every warmup count and a seeded sample of the cosine of
  `Config()` and `Config.fast()`;
- the optimizer (clip_by_global_norm, adamw, apply_updates) on random
  trees of the tiny config's parameter shapes, with the gradients' global
  norm below and above the clip, at counts in the warmup, at the peak and
  late in the cosine. The global norm itself is held to a bound: the JAX
  step sums 1.3 M float32 squares in float32 in XLA's order and the port
  in float64, and no float32 order of the port's would be XLA's;
- the EMA update, and the PRN's Adam (`optax.adam(1e-3)`);
- Adam's bias corrections and the EMA's decay and weight, to count 2000;
- `xla_arith.cosf` against the C library's cosf, which is the cosine that
  XLA's compiled schedule calls;
- that the JAX train step computes its rate with the instructions of the
  schedule jitted alone;
- the update kernel's table (csrc/train_update.cu), its wrapper's refusals
  before a build, and that CPU tensors take the plain versions
  (tests/test_torch_cuda.py holds the kernel to them on the card).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _tiny_config
from multiposenet_tpu.config import Config
from multiposenet_tpu.train import steps as jsteps
from multiposenet_tpu_torch.train import prn_train as tprn
from multiposenet_tpu_torch.train import steps as tsteps
from multiposenet_tpu_torch.train import xla_arith

import torch_quality_helpers as quality
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, torch_config_of,
)

# How far the port's global norm may be from the JAX step's, in float32
# ulps. JAX sums each leaf's squares through reduce-windows of 32, then
# the windows, then the leaves one after another, all in float32; the
# port's float64 sum is within half an ulp of the exact one. Over 30
# seeded trees of the tiny config the two were -2 to 7 ulps apart: each of
# the thousands of float32 additions rounds by half an ulp of its partial
# sum at most, and those roundings do not all fall one way.
NORM_ULPS = 16


def _bits(x) -> np.ndarray:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.array(x, np.float32).reshape(-1).view(np.int32)


def _assert_bits_equal(got, want, what: str) -> None:
    differ = int((_bits(got) != _bits(want)).sum())
    assert differ == 0, f"{what}: {differ} elements differ"


def _configs() -> dict[str, Config]:
    return {"smoke": quality.gate_config("smoke"),
            "ap": quality.gate_config("ap"), "default": Config(),
            "fast": Config.fast()}


def _counts(cfg: Config) -> list[int]:
    """Every count to num_steps + 1 where that is at most 1000; else every
    warmup count, 2000 seeded cosine counts and the last two."""
    t = cfg.train
    if t.num_steps <= 1000:
        return list(range(t.num_steps + 2))
    rng = np.random.RandomState(0)
    sample = rng.choice(np.arange(t.warmup_steps + 1, t.num_steps),
                        2000, replace=False)
    return sorted({*range(t.warmup_steps + 1), *map(int, sample),
                   t.num_steps, t.num_steps + 1})


@pytest.mark.parametrize("name", ["smoke", "ap", "default", "fast"])
def test_schedule_bit_for_bit_with_jit(name):
    cfg = _configs()[name]
    want = jax.jit(jsteps.make_learning_rate(cfg))
    got = tsteps.make_learning_rate(torch_config_of(cfg))
    counts = _counts(cfg)
    assert len(counts) >= min(cfg.train.num_steps + 2, 3000)
    differ = [c for c in counts if np.float32(got(c)) != np.asarray(
        want(jnp.asarray(c, jnp.int32)), np.float32)]
    assert not differ, (len(differ), differ[:5])


_SCALAR = re.compile(r"= ([fs]32)\[\] (\w+)\(([^)]*)\)")


def _schedule_ops(hlo: str) -> list[list[tuple[str, str, str]]]:
    """For each fusion of compiled HLO text that calls `cosine`, its
    scalar instructions up to the warmup/cosine select: (type, opcode,
    the constant's value)."""
    fusions = []
    for comp in re.split(r"\n(?=%|ENTRY)", hlo):
        if "cosine(" not in comp:
            continue
        ops = []
        for kind, op, arg in _SCALAR.findall(comp):
            ops.append((kind, op, arg if op == "constant" else ""))
            if op == "select":
                break
        fusions.append(ops)
    return fusions


def test_the_train_step_compiles_the_schedule_as_jit_alone():
    """The JAX package's jitted train step (the tiny config at 64²)
    computes its learning rate with the very instructions and constants
    of the schedule jitted alone, in every fusion that reads it: the
    values the bit-for-bit tests compare with are the step's."""
    from multiposenet_tpu.data.loader import make_batch
    from multiposenet_tpu.data.synthetic import make_dataset

    cfg = _tiny_config(image_size=64, batch_size=2)
    state = jax.eval_shape(lambda: jsteps.create_train_state(
        cfg, jax.random.PRNGKey(0)))
    batch = make_batch(make_dataset(2, img_h=64, img_w=64, seed=0), 64,
                       cfg.prn.max_persons, np.random.RandomState(0))
    batch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in batch.items()}
    step = jax.jit(jsteps.make_train_step(cfg)).lower(
        state, batch).compile().as_text()
    alone = jax.jit(jsteps.make_learning_rate(cfg)).lower(
        jnp.asarray(0, jnp.int32)).compile().as_text()
    (want,) = _schedule_ops(alone)
    assert ("f32", "cosine", "") in want and want[-1][1] == "select"
    got = _schedule_ops(step)
    assert got and all(ops == want for ops in got), len(got)


@functools.lru_cache(maxsize=None)
def _tree_shapes():
    cfg = _tiny_config()
    shapes = jax.eval_shape(lambda: jsteps.create_train_state(
        cfg, jax.random.PRNGKey(0)).params)
    return cfg, jax.tree.flatten(shapes)


@functools.lru_cache(maxsize=None)
def _jax_optimizer():
    """The tiny config's `make_optimizer` update, apply_updates and the
    gradients' global norm, in one jitted program as the step has them."""
    cfg, _ = _tree_shapes()
    tx = jsteps.make_optimizer(cfg)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state,
                optax.global_norm(grads))

    return tx, update


def _random_state(leaves, seed: int, grad_norm: float):
    """params, grads scaled to `grad_norm`, mu and nu (nu >= 0), float32
    leaves of the given shapes, each leaf at its own scale."""
    rng = np.random.RandomState(seed)

    def draw(scale):
        return [(scale * 10.0 ** rng.uniform(-2, 1)
                 * rng.randn(*x.shape)).astype(np.float32) for x in leaves]

    params = draw(0.1)
    grads = draw(1.0)
    total = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                        for g in grads))
    grads = [(g * (grad_norm / total)).astype(np.float32) for g in grads]
    mu = draw(1e-3)
    nu = [np.abs(x).astype(np.float32) for x in draw(1e-6)]
    # One element in 50 of each at a scale where the products and the
    # moments fall below float32's normal range, which XLA flushes.
    for xs, tiny in ((grads, 1e-21), (mu, 1e-38), (nu, 1e-40),
                     (params, 1e-38)):
        for x in xs:
            pick = rng.rand(*x.shape) < 0.02
            x[pick] = (tiny * rng.randn(int(pick.sum()))).astype(
                np.float32)
    for x in nu:
        np.abs(x, out=x)
    return params, grads, mu, nu


def _with_count(opt_state, count: int, mu, nu):
    """optax chain state with every count set and Adam's moments given."""
    def fix(s):
        if hasattr(s, "_fields") and "count" in s._fields:
            s = s._replace(count=jnp.asarray(count, jnp.int32))
            if "mu" in s._fields:
                s = s._replace(mu=mu, nu=nu)
        return s
    return jax.tree.map(fix, opt_state, is_leaf=lambda s: hasattr(
        s, "_fields") and "count" in s._fields)


# (grad norm, count) of the tiny config (clip 10, warmup 2, 10 steps).
OPT_CASES = {"below_clip-warmup": (3.0, 1), "below_clip-peak": (3.0, 2),
             "below_clip-late": (3.0, 9), "above_clip-warmup": (300.0, 1),
             "above_clip-peak": (300.0, 2), "above_clip-late": (300.0, 9)}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_update_bit_for_bit_with_jit(case, record_property,
                                               monkeypatch):
    grad_norm, count = OPT_CASES[case]
    cfg, (leaves, treedef) = _tree_shapes()
    params, grads, mu, nu = _random_state(leaves, count, grad_norm)
    tree = lambda xs: jax.tree.unflatten(  # noqa: E731
        treedef, [jnp.asarray(x) for x in xs])
    tx, jax_update = _jax_optimizer()
    state = _with_count(tx.init(tree(params)), count, tree(mu), tree(nu))
    jp, jstate, jnorm = jax_update(tree(grads), state, tree(params))
    adam = jstate[1][0]
    assert int(adam.count) == count + 1
    assert (float(jnorm) < cfg.train.gradient_clip_norm) == (grad_norm < 10)

    opt = tsteps.Optimizer(torch_config_of(cfg))
    tp, tmu, tnu = ([torch.tensor(x) for x in xs] for xs in (params, mu, nu))
    tg = [torch.tensor(x) for x in grads]
    own = xla_arith.global_norm(xla_arith.flat(tg))
    # The update from the JAX step's own norm (the bound below is the
    # norm's).
    monkeypatch.setattr(xla_arith, "global_norm",
                        lambda g: torch.tensor(np.asarray(jnorm)))
    norm = opt.update(tp, tg, tmu, tnu, count)
    assert float(norm) == float(jnorm)
    for what, got, want in (("params", tp, jp), ("mu", tmu, adam.mu),
                            ("nu", tnu, adam.nu)):
        for g, w in zip(got, jax.tree.leaves(want)):
            _assert_bits_equal(g, w, what)

    ulps = _bits(own).item() - _bits(jnorm).item()
    record_property("global_norm_ulps", ulps)
    assert abs(ulps) <= NORM_ULPS, ulps


@pytest.mark.parametrize("step", [0, 5, 500, 9000])
def test_ema_update_bit_for_bit_with_jit(step):
    """The JAX step's EMA (multiposenet_tpu/train/steps.py, train_step)
    under jax.jit against `xla_arith.ema_step`."""
    cfg, (leaves, treedef) = _tree_shapes()
    ema, new_params, _, _ = _random_state(leaves, step, 1.0)
    new_params = [(e + 1e-2 * p).astype(np.float32)
                  for e, p in zip(ema, new_params)]
    ema_decay = cfg.train.ema_decay

    @jax.jit
    def jax_ema(ema, params, step):
        s = step.astype(jnp.float32) + 1.0
        eff_decay = jnp.minimum(ema_decay, (1.0 + s) / (10.0 + s))
        return jax.tree_util.tree_map(
            lambda e, p: e * eff_decay + p * (1.0 - eff_decay), ema, params)

    want = jax_ema([jnp.asarray(x) for x in ema],
                   [jnp.asarray(x) for x in new_params],
                   jnp.asarray(step, jnp.int32))
    got = [torch.tensor(x) for x in ema]
    decay = tsteps.ema_decay(torch_config_of(cfg), step)
    xla_arith.ema_step(got, [torch.tensor(x) for x in new_params], decay,
                       tsteps.ema_weight(decay))
    for g, w in zip(got, want):
        _assert_bits_equal(g, w, "ema")


@pytest.mark.parametrize("count", [0, 3, 100])
def test_prn_adam_bit_for_bit_with_jit(count):
    """`prn_train.adam_update` against optax.adam(1e-3) and apply_updates
    under jax.jit, on the tiny config's PRN."""
    tcfg = torch_config_of(_tiny_config())
    state = tprn.create_prn_state(tcfg, "cpu")
    names = list(state.params)
    shapes = [state.params[k].shape for k in names]
    params, grads, mu, nu = _random_state(
        [np.zeros(s) for s in shapes], 100 + count, 1.0)
    tx = optax.adam(1e-3)

    @jax.jit
    def jax_update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    tree = lambda xs: dict(zip(names, map(jnp.asarray, xs)))  # noqa: E731
    jp, jstate = jax_update(tree(grads), _with_count(
        tx.init(tree(params)), count, tree(mu), tree(nu)), tree(params))
    with torch.no_grad():
        for k, p, m, v in zip(names, params, mu, nu):
            state.params[k].copy_(torch.tensor(p))
            state.mu[k].copy_(torch.tensor(m))
            state.nu[k].copy_(torch.tensor(v))
    state.step = count
    tprn.adam_update(state, {k: torch.tensor(g)
                             for k, g in zip(names, grads)})
    for k in names:
        _assert_bits_equal(state.params[k].detach(), jp[k], k)
        _assert_bits_equal(state.mu[k], jstate[0].mu[k], k)
        _assert_bits_equal(state.nu[k], jstate[0].nu[k], k)


def test_bias_corrections_and_ema_decay_bit_for_bit_to_2000():
    cfg = _tiny_config()
    bias = jax.jit(lambda c: (1 - 0.9 ** c, 1 - 0.999 ** c))

    @jax.jit
    def decay(step):
        s = step.astype(jnp.float32) + 1.0
        d = jnp.minimum(cfg.train.ema_decay, (1.0 + s) / (10.0 + s))
        return d, 1.0 - d

    tcfg = torch_config_of(cfg)
    for n in range(2001):
        b1, b2 = bias(jnp.asarray(max(n, 1), jnp.int32))
        assert xla_arith.bias_correction(0.9, max(n, 1)) == float(b1), n
        assert xla_arith.bias_correction(0.999, max(n, 1)) == float(b2), n
        d, w = decay(jnp.asarray(n, jnp.int32))
        got = tsteps.ema_decay(tcfg, n)
        assert got == float(d) and tsteps.ema_weight(got) == float(w), n


def test_cosf_is_the_c_librarys():
    """`xla_arith.cosf` against the C library's cosf on seeded arguments
    in [0, 3.5] and on every argument the four schedules reach (the whole
    of [0, 3.5] was checked against glibc 2.36 in C)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.restype, libm.cosf.argtypes = ctypes.c_float, [ctypes.c_float]
    rng = np.random.RandomState(0)
    args = list(rng.uniform(0.0, 3.5, 20000).astype(np.float32))
    for cfg in _configs().values():
        t = cfg.train
        span = max(t.num_steps, t.warmup_steps + 1) - t.warmup_steps
        angle = np.float32(np.float32(np.pi) * (np.float32(1)
                                                / np.float32(span)))
        args += [np.float32(np.float32(c) * angle)
                 for c in range(0, span + 1, max(1, span // 5000))]
    differ = [x for x in args
              if xla_arith.cosf(x) != np.float32(libm.cosf(float(x)))]
    assert not differ, differ[:5]


def test_fma_rounds_once():
    """`xla_arith.fma` and `fma_host` against the exact a·b + c rounded
    to the nearest float32 (ties to even), by rationals."""
    from fractions import Fraction

    rng = np.random.RandomState(0)
    n = 3000
    a, b = (rng.randn(n).astype(np.float32) for _ in range(2))
    c = (rng.randn(n) * 10.0 ** rng.uniform(-8, 8, n)).astype(np.float32)
    got = xla_arith.fma(torch.tensor(a), torch.tensor(b),
                        torch.tensor(c)).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        near = np.float32(float(exact))
        cands = [near, np.nextafter(near, np.float32(np.inf)),
                 np.nextafter(near, np.float32(-np.inf))]
        want = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         _bits(v).item() & 1))
        assert _bits(got[i]) == _bits(want), i
        assert _bits(xla_arith.fma_host(float(a[i]), float(b[i]),
                                        float(c[i]))) == _bits(want), i


def test_chip_smoke_update_check_rehearses_on_cpu():
    """chip_smoke.py's `update_card_vs_cpu` with the CPU in the card's
    place, at the tiny config's parameter shapes: every result is
    reported, and the CPU against itself differs nowhere."""
    from multiposenet_tpu_torch.config import Config as TorchConfig
    from multiposenet_tpu_torch.models.posenet import MultiPoseNet

    from torch_port_helpers import chip_smoke_module

    smoke = chip_smoke_module()
    cfg = smoke.tiny_train_config(TorchConfig)
    shapes = [tuple(p.shape) for p in MultiPoseNet(cfg).parameters()]
    out = smoke.update_card_vs_cpu(cfg, shapes, tsteps,
                                   torch.device("cpu"), seed=1)
    assert out["params"] == sum(int(np.prod(s)) for s in shapes)
    rows = [out["ema"], out["prn_adam"]]
    for case in ("optimizer_below_clip", "optimizer_above_clip"):
        rows += [out[case][k] for k in ("params", "mu", "nu", "grad_norm")]
    assert out["optimizer_above_clip"]["grad_norm_cpu"] > 10.0
    assert out["optimizer_below_clip"]["grad_norm_cpu"] < 10.0
    for row in rows:
        assert row["elements"] > 0 and row["differ"] == 0, row


def test_update_table_layout():
    """The table csrc/train_update.cu reads (`xla_arith._table`): for T
    tensors the pointers of each list, the gradients' flat offsets, the
    sizes, then the first block of each tensor and the total, CHUNK
    elements a block; a tensor of no element has no block."""
    sizes = [3, 0, xla_arith.CHUNK, xla_arith.CHUNK + 1, 1]
    cols = [[torch.zeros(n) for n in sizes] for _ in range(3)]
    table, blocks = xla_arith._table("adam", cols, offsets=True)
    t = len(sizes)
    rows = table.tolist()
    assert rows[:3 * t] == [x.data_ptr() for col in cols for x in col]
    assert rows[3 * t:4 * t] == [0, 3, 3, 3 + xla_arith.CHUNK,
                                 4 + 2 * xla_arith.CHUNK]
    assert rows[4 * t:5 * t] == sizes
    assert rows[5 * t:] == [0, 1, 1, 2, 4, 5] and blocks == 5
    again, _ = xla_arith._table("adam", cols, offsets=True)
    assert again is table
    ema, blocks = xla_arith._table("ema", cols[:2], offsets=False)
    assert ema.tolist()[2 * t:] == sizes + [0, 1, 1, 2, 4, 5]


@pytest.mark.parametrize("case", ["float64", "strided", "shape", "length",
                                  "device"])
def test_update_kernel_refuses_before_building(case):
    """The update kernels take contiguous float32 tensors on one device,
    alike across the lists; anything else raises before a build (CPU
    tensors stand in for the card's)."""
    def col():
        return [torch.zeros(4, 3), torch.zeros(5)]
    params, grads, mu, nu = col(), col(), col(), col()
    if case == "float64":
        nu[1] = nu[1].double()
    elif case == "strided":
        mu[0] = torch.zeros(3, 4).t()
    elif case == "shape":
        grads[1] = torch.zeros(6)
    elif case == "length":
        nu = nu[:1]
    else:
        mu[1] = torch.zeros(5, device="meta")
    with pytest.raises((TypeError, ValueError)):
        xla_arith._adam_cuda(params, grads, mu, nu,
                             xla_arith.Adam(count=1, lr=1e-3))
    with pytest.raises((TypeError, ValueError)):
        xla_arith._ema_cuda(mu, grads if case == "shape" else nu, 0.5, 0.5)


def test_update_on_cpu_runs_the_plain_version():
    """On CPU tensors `adam_step` and `ema_step` are their plain
    versions, bit for bit, and launch nothing."""
    from multiposenet_tpu_torch import kernels

    gen = torch.Generator().manual_seed(3)
    shapes = [(7, 5), (11,), (2, 3, 4)]

    def draw(scale):
        return [scale * torch.randn(s, generator=gen) for s in shapes]

    params, grads, mu = draw(0.1), draw(1.0), draw(1e-3)
    nu = [x.abs() for x in draw(1e-6)]
    hp = xla_arith.Adam(count=4, lr=1e-3, clip=1.0, weight_decay=1e-4,
                        nu_fuses_moment=True)
    kernels.reset_launches()
    runs = []
    for fn in (xla_arith.adam_step, xla_arith.adam_step_plain):
        state = [[x.clone() for x in xs] for xs in (params, mu, nu)]
        norm = fn(state[0], grads, state[1], state[2], hp)
        e = [x.clone() for x in mu]
        (xla_arith.ema_step if fn is xla_arith.adam_step
         else xla_arith.ema_step_plain)(e, params, 0.75, 0.25)
        runs.append((state, norm, e))
    (got, gnorm, ge), (want, wnorm, we) = runs
    assert kernels.LAUNCHES == {}
    _assert_bits_equal(gnorm, wnorm, "norm")
    for g, w in zip([*got[0], *got[1], *got[2], *ge],
                    [*want[0], *want[1], *want[2], *we]):
        _assert_bits_equal(g, w, "update")
