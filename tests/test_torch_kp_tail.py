"""The port's fused keypoint tail (`multiposenet_tpu_torch.ops.kp_tail`)
against the JAX package's `kp_tail_cm`, run in interpret mode as
tests/test_kp_tail_pallas.py runs it, and the keypoint head that takes it
against the JAX model with `kp_tail_pallas.FORCE_INTERPRET` on.

Tolerances: in float32 both sides form the same sum and accumulate 9C
products in float32 in other orders, a few ulps on outputs of order 1:
1e-5 absolute + 1e-5 relative. In bfloat16 the sum is rounded at the same
point on both sides, the products of bf16 values are exact in float32,
and only the order of the float32 sum differs before the one rounding to
bf16: at most 1 bf16 ulp at the output's scale (2**-7 of its largest
magnitude).

On the CPU the port runs its plain version; on a card the same entry
point launches `csrc/kp_tail.cu`, which test_torch_cuda.py holds against
the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.ops import kp_tail_pallas
from multiposenet_tpu_torch import kernels, weights
from multiposenet_tpu_torch.models.posenet import MultiPoseNet
from multiposenet_tpu_torch.models.layers import BatchNorm
from multiposenet_tpu_torch.ops import kp_tail

from torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (autouse)
    max_abs_err,
    posenet_variables,
    tiny_crowd_config,
    to_numpy,
    torch_config_of,
)

F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(shape, dtype, seed):
    b, h, w, c, k = shape
    rng = np.random.RandomState(seed)
    l2 = rng.randn(b, h, w, c).astype(np.float32)
    z8 = rng.randn(b, h // 2, w // 2, c).astype(np.float32)
    kernel = (rng.randn(3, 3, c, k) / np.sqrt(9 * c)).astype(np.float32)
    bias = rng.randn(k).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = kp_tail_pallas.kp_tail_cm(
        jnp.asarray(l2, jdt), jnp.asarray(z8, jdt), jnp.asarray(kernel),
        jnp.asarray(bias), interpret=True)
    port = (torch.as_tensor(l2).permute(0, 3, 1, 2).contiguous().to(tdt),
            torch.as_tensor(z8).permute(0, 3, 1, 2).contiguous().to(tdt),
            torch.as_tensor(kernel).permute(3, 2, 0, 1).contiguous(),
            torch.as_tensor(bias))
    return port, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("shape", [(2, 32, 32, 16, 17), (1, 32, 64, 8, 5)],
                         ids=["32x32c16k17", "32x64c8k5"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_tail_matches_jax_kernel(shape, dtype):
    (l2, z8, weight, bias), want = _inputs(shape, dtype, seed=sum(shape))
    kernels.reset_launches()
    got = kp_tail.kp_tail_cm(l2, z8, weight, bias)
    assert kernels.LAUNCHES == {}  # CPU tensors: the plain version
    assert got.dtype == l2.dtype
    b, h, w, c, k = shape
    assert tuple(got.shape) == want.shape == (b, k, h, w)
    if dtype == "float32":
        np.testing.assert_allclose(to_numpy(got), want, **F32_TOL)
    else:
        ulp = 2.0 ** -7 * float(np.abs(want).max())
        assert max_abs_err(got, want) <= ulp


@pytest.mark.parametrize("case", ["z8_height", "z8_channels", "odd_width",
                                  "weight_channels", "bias"])
def test_shape_mismatch_raises(case):
    l2, z8 = torch.zeros(1, 8, 32, 32), torch.zeros(1, 8, 16, 16)
    weight, bias = torch.zeros(17, 8, 3, 3), torch.zeros(17)
    if case == "z8_height":
        z8 = torch.zeros(1, 8, 15, 16)
    elif case == "z8_channels":
        z8 = torch.zeros(1, 4, 16, 16)
    elif case == "odd_width":
        l2, z8 = torch.zeros(1, 8, 32, 31), torch.zeros(1, 8, 16, 15)
    elif case == "weight_channels":
        weight = torch.zeros(17, 4, 3, 3)
    else:
        bias = torch.zeros(16)
    with pytest.raises(ValueError, match="shape mismatch"):
        kp_tail.kp_tail_cm(l2, z8, weight, bias)


def _jax_tail_forward(cfg, variables, x):
    """The JAX model with its tail kernel forced on (interpret mode), in a
    fresh trace so that the forced switch is read."""
    from multiposenet_tpu.models.posenet import MultiPoseNet as JaxModel

    model = JaxModel(config=cfg, with_detector=True)
    old = kp_tail_pallas.FORCE_INTERPRET
    kp_tail_pallas.FORCE_INTERPRET = True
    try:
        return jax.jit(lambda v, a: model.apply(v, a, train=False))(
            variables, x)
    finally:
        kp_tail_pallas.FORCE_INTERPRET = old


def _port_model(cfg, variables):
    model = MultiPoseNet(torch_config_of(cfg))
    weights.load_posenet(model, jax.tree.map(np.asarray, variables))
    return model.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_with_tail_matches_jax_model(dtype):
    cfg = tiny_crowd_config(dtype)
    variables = posenet_variables(cfg)
    x = np.random.RandomState(7).randint(0, 256, (2, 128, 128, 3)).astype(
        np.float32)
    want = _jax_tail_forward(cfg, variables, jnp.asarray(x))["heatmaps_cm"]
    with torch.no_grad():
        out = _port_model(cfg, variables)(torch.as_tensor(x))
    assert "segmentation" not in out  # the tail emits the heatmaps only
    got, want = to_numpy(out["heatmaps_cm"]), np.asarray(want, np.float32)
    assert got.shape == want.shape == (2, 17, 32, 32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-5)
    else:
        # Activations before the tail round at the same points but sum in
        # other orders (test_torch_models.py's bf16 bound).
        np.testing.assert_allclose(got, want, atol=0.04, rtol=0.02)
        assert np.mean(np.abs(got - want)) < 4e-3


def test_tail_taken_only_in_eval_mode_and_on_tiled_heights():
    """Training mode, and heatmap heights the TPU kernel's 16-row tile
    does not divide (a 96² input gives 24² maps), keep the 18-channel
    conv, as the JAX package does; there the two heads agree to f32
    rounding. In training mode BatchNorm normalizes with the batch's
    statistics; its layers are held in eval mode here so that only the
    keypoint head's choice differs."""
    cfg = tiny_crowd_config("float32")
    variables = posenet_variables(cfg)
    model = _port_model(cfg, variables)
    rng = np.random.RandomState(8)
    x = torch.as_tensor(rng.randint(0, 256, (1, 128, 128, 3)).astype(
        np.float32))
    with torch.no_grad():
        tail = model(x)
        model.train()
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.eval()
        conv = model(x)
        model.eval()
        odd = model(torch.as_tensor(rng.randint(0, 256, (1, 96, 96, 3))
                                    .astype(np.float32)))
    assert "segmentation" not in tail and "segmentation" in conv
    assert "segmentation" in odd
    np.testing.assert_allclose(to_numpy(tail["heatmaps_cm"]),
                               to_numpy(conv["heatmaps_cm"]), atol=3e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("k", [1, 17, 32])
@pytest.mark.parametrize("c", [3, 64])
def test_weight_packing_matches_plain(k, c):
    """The packed [9C, N] matrix, N = K rounded up to a multiple of 8,
    as an im2col matmul in float32 equals kp_tail_plain (the same
    products summed in another order: 1e-5), its padding columns read
    zero, and the kernel's B-fragment order holds each element where the
    mma.sync m16n8k16 layout reads it."""
    rng = np.random.RandomState(k + c)
    b, h, w = 1, 8, 6
    l2 = torch.as_tensor(rng.randn(b, c, h, w).astype(np.float32))
    z8 = torch.as_tensor(rng.randn(b, c, h // 2, w // 2).astype(np.float32))
    weight = torch.as_tensor(
        (rng.randn(k, c, 3, 3) / np.sqrt(9 * c)).astype(np.float32))
    bias = torch.as_tensor(rng.randn(k).astype(np.float32))
    wmat = kp_tail.tail_weight_matrix(weight, torch.float32)
    n = -(-k // 8) * 8
    assert tuple(wmat.shape) == (9 * c, n)
    assert torch.count_nonzero(wmat[:, k:]) == 0
    x = l2 + torch.nn.functional.interpolate(z8, scale_factor=2)
    cols = torch.nn.functional.unfold(x, 3, padding=1)      # [B, C*9, HW]
    cols = cols.view(b, c, 9, h * w).permute(0, 3, 2, 1).reshape(
        b, h * w, 9 * c)                                     # rows (tap, c)
    got = (cols @ wmat)[..., :k] + bias
    got = got.permute(0, 2, 1).reshape(b, k, h, w)
    want = kp_tail.kp_tail_plain(l2, z8, weight, bias)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)

    frags = kp_tail.tail_weight_fragments(wmat, c)
    chunks = -(-c // 16)
    assert tuple(frags.shape) == (chunks, 9, n // 8, 32, 4)
    for ch in range(chunks):
        for tap in range(9):
            for nt in range(n // 8):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for e in range(4):
                        kk = 16 * ch + 2 * t + (e % 2) + 8 * (e // 2)
                        want_e = (wmat[tap * c + kk, 8 * nt + g]
                                  if kk < c else 0.0)
                        assert frags[ch, tap, nt, lane, e] == want_e


def test_phase_tool_refuses_without_a_card(monkeypatch, capsys):
    """tools/kp_tail_phases.py measures on a card only: without one it
    exits non-zero and prints no result."""
    from multiposenet_tpu_torch.tools import kp_tail_phases

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kp_tail_phases.main() == 2
    assert capsys.readouterr().out == ""
