"""The train step's float32 arithmetic outside the model, rounded as the
JAX package's compiled train step rounds it on the CPU, where XLA
compiles it through LLVM; and the one update that applies that policy,
`adam_step` and `ema_step`, with its kernel for the card.

What that compiler does to the step's elementwise arithmetic, read from the
optimized HLO (`jax.jit(f).lower(...).compile().as_text()`) and checked
value for value against `jax.jit` (tests/test_torch_train_arith.py):
- it folds constants: a division by a constant becomes a multiply by its
  float32 reciprocal, and constant factors merge (π · (1/D) in the
  cosine schedule, 0.5 · (1 − α) after it);
- LLVM contracts a multiply feeding an add into one fused multiply-add,
  rounded once (`fma`); which product it takes where both operands of the
  add are products is fixed by the expression: data in `Adam`;
- the compiled program runs with subnormals flushed to zero, on inputs
  and on results (`ftz`);
- `cos` is the C library's `cosf` (glibc's, `cosf` below), and `sqrt`
  is correctly rounded.

`adam_step` (optax's adam, optionally after clip_by_global_norm and with
adamw's decoupled decay) and `ema_step` update lists of tensors in place.
On a CUDA tensor they launch `csrc/train_update.cu` (kernels `adam_update`
and `ema_update`): one pass over each tensor, the card's single-rounding
float32 fused multiply-add, the flush in registers; it takes float32 and
raises on anything else. On a CPU tensor they run their plain versions,
`adam_step_plain` and `ema_step_plain`, over the tensors laid end to end.
There the fused multiply-add is computed in float64: the product of two
float32 values is exact, the sum's rounding error is recovered exactly
(TwoSum) and folded into the last bit (rounding to odd), so that the one
rounding to float32 that follows is the rounding of the exact a·b + c.
Float64 tensors (the float64 runs that hold the port to the JAX package
at a tolerance) take a·b + c with two roundings and keep their
subnormals.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from multiposenet_tpu_torch import kernels

FLT_MIN = float(np.finfo(np.float32).tiny)
# optax.adam's b1, b2 and eps.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
SOURCE = "train_update"      # csrc/train_update.cu
ADAM_KERNEL, EMA_KERNEL = "adam_update", "ema_update"
CHUNK = 1024                # csrc/train_update.cu: elements per block


def ftz(x: torch.Tensor) -> torch.Tensor:
    """x with float32 subnormals flushed to zero of the same sign."""
    if x.dtype != torch.float32:
        return x
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as XLA's: torch's float32 sqrt
    on the CPU is not (it differs from it on about 0.6% of arguments);
    the float64 root of a float32, rounded to float32, is."""
    if x.dtype != torch.float32:
        return x.sqrt()
    return x.double().sqrt().float()


def fma(a, b, c) -> torch.Tensor:
    """a·b + c rounded once to float32, flushed (`ftz`); each operand a
    float32 tensor or a float that a float32 holds exactly. Float64
    tensors: a·b + c."""
    t = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    if t.dtype != torch.float32:
        return a * b + c
    # c stays float32: each operation below reads it promoted.
    p = (a.double() if isinstance(a, torch.Tensor) else a) * (
        b.double() if isinstance(b, torch.Tensor) else b)
    s = p + c
    # TwoSum: s + e == p + c exactly.
    pp = s - c
    e = p.sub_(pp).add_((s - pp).neg_().add_(c))
    inexact_even = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    s = torch.where(inexact_even, torch.nextafter(s, e.mul_(math.inf)), s)
    return ftz(s.float())


def fma_host(a: float, b: float, c: float) -> np.float32:
    """`fma` on host floats that float32 holds exactly."""
    p = a * b
    s = p + c
    pp = s - c
    cc = s - pp
    e = (p - pp) + (c - cc)
    if e != 0 and int(np.float64(s).view(np.int64)) & 1 == 0:
        s = math.nextafter(s, math.copysign(math.inf, e))
    r = np.float32(s)
    return np.float32(0.0) * r if abs(r) < FLT_MIN else r


# glibc's single-precision cosine (sysdeps/ieee754/flt-32/s_cosf.c and
# sincosf.h, the ARM optimized-routines code, as in glibc 2.28 and later):
# the argument reduced by a multiple of π/2 in double, a polynomial in
# double, one rounding to float. Its tables, as glibc 2.36's libm holds
# them: 2/π · 2^24, π/2, then c0, c1, s1, c2, s2, c3, s3, c4 for the
# quadrants 0-1 and 2-3.
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p+0")
_POLY = [dict(zip(("c0", "c1", "s1", "c2", "s2", "c3", "s3", "c4"),
                  map(float.fromhex, row))) for row in (
    ("0x1p+0", "-0x1.ffffffd0c621cp-2", "-0x1.555545995a603p-3",
     "0x1.55553e1068f19p-5", "0x1.1107605230bc4p-7",
     "-0x1.6c087e89a359dp-10", "-0x1.994eb3774cf24p-13",
     "0x1.99343027bf8c3p-16"),
    ("-0x1p+0", "0x1.ffffffd0c621cp-2", "-0x1.555545995a603p-3",
     "-0x1.55553e1068f19p-5", "0x1.1107605230bc4p-7",
     "0x1.6c087e89a359dp-10", "-0x1.994eb3774cf24p-13",
     "-0x1.99343027bf8c3p-16"))]
_SIGN = (1.0, -1.0, -1.0, 1.0)


def _abstop12(x: np.float32) -> int:
    return (int(np.float32(x).view(np.uint32)) >> 20) & 0x7FF


def _sinf_poly(x: float, x2: float, p: dict, n: int) -> np.float32:
    if n & 1 == 0:
        x3 = x * x2
        s1 = p["s2"] + x2 * p["s3"]
        x7 = x3 * x2
        s = x + x3 * p["s1"]
        return np.float32(s + x7 * s1)
    x4 = x2 * x2
    c2 = p["c3"] + x2 * p["c4"]
    c1 = p["c0"] + x2 * p["c1"]
    x6 = x4 * x2
    c = c1 + x4 * p["c2"]
    return np.float32(c + x6 * c2)


def cosf(y: np.float32) -> np.float32:
    """glibc's cosf for |y| < 120, bit for bit: every float32 in [0, 3.5]
    was checked against glibc 2.36's (tests/test_torch_train_arith.py
    checks a sample against the C library's)."""
    y = np.float32(y)
    x = float(y)
    if _abstop12(y) < _abstop12(np.float32(float.fromhex("0x1.921fb6p-1"))):
        if _abstop12(y) < _abstop12(np.float32(2.0 ** -12)):
            return np.float32(1.0)
        return _sinf_poly(x, x * x, _POLY[0], 1)
    if _abstop12(y) >= _abstop12(np.float32(120.0)):
        raise ValueError(f"cosf is followed for |y| < 120 only, got {y}")
    n = (int(x * _HPI_INV) + 0x800000) >> 24
    x = x - n * _HPI
    p = _POLY[1] if n & 2 else _POLY[0]
    return _sinf_poly(x * _SIGN[n & 3], x * x, p, n ^ 1)


def flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The tensors end to end in one vector."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflat_(tensors: list[torch.Tensor], vector: torch.Tensor) -> None:
    """Copy `vector` (as `flat` lays it out) back into the tensors."""
    pieces = vector.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [v.view_as(t)
                                   for v, t in zip(pieces, tensors)])


def scalar_type(param: torch.Tensor) -> type:
    """The numpy type of the step's scalars for these parameters:
    float64 for float64 ones, else float32."""
    return np.float64 if param.dtype == torch.float64 else np.float32


def bias_correction(decay: float, count: int, f: type = np.float32
                    ) -> float:
    """Adam's 1 - decay^count in `f`, as the compiled update forms it."""
    return float(f(1) - f(decay) ** f(count))


def global_norm(grads: torch.Tensor) -> torch.Tensor:
    """optax.global_norm of the gradients laid end to end (`flat`), a 0-d
    tensor: the squares in the gradients' type, summed in float64, the
    sum rounded to that type, its square root. The JAX step sums its
    float32 squares in float32, in an order of XLA's own (a reduce-window
    of 32 per leaf, then the windows, then the leaves); the two differ in
    the last bits (bound in tests/test_torch_train_arith.py). A subnormal
    gradient's square is 0, so the gradients need no flush first."""
    return sqrt(ftz(grads * grads).double().sum().to(grads.dtype))


@dataclasses.dataclass(frozen=True)
class Adam:
    """One Adam update as the compiled optax update takes it: the
    `count`-th (bias corrections 1 - b^count), at rate `lr`; `clip`
    clips by the global norm first (clip_by_global_norm) and
    `weight_decay` decays as adamw does (None: neither). In the second
    moment g²·(1 - b2) + nu·b2 the add fuses nu's product where
    `nu_fuses_moment` (the chain with clipping), else g²'s (plain adam)."""

    count: int
    lr: float
    clip: float | None = None
    weight_decay: float | None = None
    nu_fuses_moment: bool = False

    def scalars(self, f: type) -> dict[str, float]:
        """The scalars the update reads, each in `f`."""
        def r(x):
            return float(f(x))
        return {"b1": r(ADAM_B1), "c1": r(1 - ADAM_B1), "b2": r(ADAM_B2),
                "c2": r(1 - ADAM_B2),
                "bc1": bias_correction(ADAM_B1, self.count, f),
                "bc2": bias_correction(ADAM_B2, self.count, f),
                "eps": r(ADAM_EPS), "neg_lr": -r(self.lr),
                "wd": r(self.weight_decay or 0.0), "clip": r(self.clip or 0.0)}


@torch.no_grad()
def adam_step(params: list[torch.Tensor], grads: list[torch.Tensor],
              mu: list[torch.Tensor], nu: list[torch.Tensor], adam: Adam
              ) -> torch.Tensor | None:
    """One Adam update of `params` and its moments in place; returns the
    gradients' global norm (before clipping) where `adam.clip` is set.
    On the card the kernel, on the CPU the plain version."""
    if params[0].device.type == "cpu":
        return adam_step_plain(params, grads, mu, nu, adam)
    return _adam_cuda(params, grads, mu, nu, adam)


@torch.no_grad()
def ema_step(ema: list[torch.Tensor], params: list[torch.Tensor],
             decay: float, weight: float) -> None:
    """ema ← ema · decay + params · weight in place, the first product
    fused into the add, as the JAX step's EMA compiles; decay and weight
    are taken in the tensors' scalar type. On the card the kernel, on
    the CPU the plain version."""
    f = scalar_type(ema[0])
    decay, weight = float(f(decay)), float(f(weight))
    if ema[0].device.type == "cpu":
        ema_step_plain(ema, params, decay, weight)
    else:
        _ema_cuda(ema, params, decay, weight)


def adam_step_plain(params: list[torch.Tensor], grads: list[torch.Tensor],
                    mu: list[torch.Tensor], nu: list[torch.Tensor],
                    adam: Adam) -> torch.Tensor | None:
    """`adam_step` in PyTorch over the tensors laid end to end, on any
    device: g clipped to g / ‖g‖ · clip where ‖g‖ is not below the clip;
    mu' = g·c1 + mu·b1 (g's product fused), nu' as `Adam` says, d =
    mu' / (bc1 · (√(nu' / bc2) + eps)) (true divisions), then p + (p·wd
    + d)·(-lr), or p + d·(-lr) without the decay, each product fused."""
    f = scalar_type(params[0])
    s = adam.scalars(f)
    g = ftz(flat(grads))
    norm = None
    if adam.clip is not None:
        norm = global_norm(g)
        g = torch.where(norm < s["clip"], g,
                        ftz(ftz(g / norm) * s["clip"]))
    m = fma(g, s["c1"], ftz(ftz(flat(mu)) * s["b1"]))
    g2, v = ftz(g * g), ftz(flat(nu))
    if adam.nu_fuses_moment:
        v = fma(v, s["b2"], ftz(g2 * s["c2"]))
    else:
        v = fma(g2, s["c2"], ftz(v * s["b2"]))
    # A true division, by a tensor: torch on CUDA multiplies by the
    # reciprocal of a host scalar.
    bc2 = torch.full((), s["bc2"], dtype=v.dtype, device=v.device)
    d = ftz(m / ((sqrt(v / bc2) + s["eps"]) * s["bc1"]))
    p = ftz(flat(params))
    if adam.weight_decay is not None:
        d = fma(p, s["wd"], d)
    p = fma(s["neg_lr"], d, p)
    for tensors, vector in ((mu, m), (nu, v), (params, p)):
        unflat_(tensors, vector)
    return norm


def ema_step_plain(ema: list[torch.Tensor], params: list[torch.Tensor],
                   decay: float, weight: float) -> None:
    """`ema_step` in PyTorch over the tensors laid end to end."""
    unflat_(ema, fma(ftz(flat(ema)), decay,
                     ftz(ftz(flat(params)) * weight)))


def _check_cuda(what: str, columns: list[list[torch.Tensor]]) -> None:
    """The kernel's operands: contiguous float32 tensors on one CUDA
    device, alike in shape across the columns; raises otherwise."""
    first = columns[0]
    if not first:
        raise ValueError(f"{what}: no tensors")
    device = first[0].device
    for col in columns:
        if len(col) != len(first):
            raise ValueError(f"{what}: the lists differ in length")
        for t, like in zip(col, first):
            if t.dtype != torch.float32:
                raise TypeError(f"{what} kernel takes float32, got "
                                f"{t.dtype}")
            if t.device != device or not t.is_contiguous():
                raise ValueError(f"{what} kernel takes contiguous tensors "
                                 f"on one CUDA device, got {t.device}")
            if t.shape != like.shape:
                raise ValueError(f"{what}: shapes {tuple(t.shape)} and "
                                 f"{tuple(like.shape)} differ")


# The kernels' tables (csrc/train_update.cu) by the pointers and sizes
# they hold: the state's tensors keep their storage from step to step.
_TABLES: dict[tuple, tuple[torch.Tensor, int]] = {}
_TABLES_KEPT = 16


def _table(what: str, columns: list[list[torch.Tensor]], offsets: bool
           ) -> tuple[torch.Tensor, int]:
    """The table csrc/train_update.cu reads for these tensors, on their
    device, and its number of blocks. The tensors are checked
    (`_check_cuda`) when their pointers and sizes are new; the host work
    of a step is then one pass over them."""
    pointers = [t.data_ptr() for col in columns for t in col]
    sizes = [t.numel() for col in columns for t in col]
    key = (offsets, *pointers, *sizes)
    if key not in _TABLES:
        _check_cuda(what, columns)
        numel = sizes[:len(columns[0])]
        first = np.cumsum([0] + [-(-n // CHUNK) for n in numel])
        rows = pointers + (list(np.cumsum([0] + numel[:-1])) if offsets
                           else []) + numel + list(first)
        table = torch.tensor([int(x) for x in rows], dtype=torch.int64)
        if len(_TABLES) >= _TABLES_KEPT:
            del _TABLES[next(iter(_TABLES))]
        _TABLES[key] = (table.to(columns[0][0].device), int(first[-1]))
    return _TABLES[key]


def _stream(device: torch.device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def _adam_cuda(params, grads, mu, nu, adam: Adam) -> torch.Tensor | None:
    """Launch `adam_update` of csrc/train_update.cu and count it."""
    table, blocks = _table(ADAM_KERNEL, [params, mu, nu], offsets=True)
    device = params[0].device
    g = flat(grads)
    if (g.dtype != torch.float32 or g.device != device
            or [x.numel() for x in grads] != [x.numel() for x in params]):
        raise ValueError(f"{ADAM_KERNEL}: the gradients are not float32 "
                         "tensors of the parameters' sizes on their device")
    s = adam.scalars(np.float32)
    norm = global_norm(g) if adam.clip is not None else None
    fn = kernels.load(SOURCE).adam_update
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_float] * 10 \
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    err = fn(table.data_ptr(), len(params), blocks, g.data_ptr(),
             None if norm is None else norm.data_ptr(),
             *(s[k] for k in ("b1", "c1", "b2", "c2", "bc1", "bc2", "eps",
                              "wd", "neg_lr", "clip")),
             int(adam.weight_decay is not None), int(adam.nu_fuses_moment),
             _stream(device))
    if err != 0:
        raise RuntimeError(f"adam_update launch failed: CUDA error {err}")
    kernels.count_launch(ADAM_KERNEL, device)
    return norm


def _ema_cuda(ema, params, decay: float, weight: float) -> None:
    """Launch `ema_update` of csrc/train_update.cu and count it."""
    table, blocks = _table(EMA_KERNEL, [ema, params], offsets=False)
    fn = kernels.load(SOURCE).ema_update
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    device = ema[0].device
    err = fn(table.data_ptr(), len(ema), blocks, decay, weight,
             _stream(device))
    if err != 0:
        raise RuntimeError(f"ema_update launch failed: CUDA error {err}")
    kernels.count_launch(EMA_KERNEL, device)
