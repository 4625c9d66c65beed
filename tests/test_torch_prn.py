"""The port's PRN crops, PRN forward, keypoint readout and peak snapping
against the JAX package, on the same numpy inputs and weights.

Tolerances: f32 crops and PRN outputs 1e-5 absolute + 1e-5 relative (the
interpolation einsums and the Dense layers sum in another order); bf16
crops 2 bf16 ulps relative (0.008) + 1e-3 absolute, since the
intermediate of the two crop einsums is rounded to bf16 on both sides
but accumulated in different orders. The readout and the snap are
selections plus f32 elementwise arithmetic in the same order, compared
to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.models.prn import PRN as JaxPRN
from multiposenet_tpu.ops import prn_ops as jax_prn_ops
from multiposenet_tpu_torch import weights
from multiposenet_tpu_torch.models.prn import PRN
from multiposenet_tpu_torch.ops import prn_ops

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import prn_variables, tiny_config, to_numpy

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-3, rtol=8e-3)
CH, CW, K = 14, 10, 17


def _boxes(rng, b, d, h, w):
    y0 = rng.uniform(-3, h * 0.7, (b, d))
    x0 = rng.uniform(-3, w * 0.7, (b, d))
    bh = rng.uniform(0.0, h * 0.6, (b, d))  # some degenerate (0-height)
    bw = rng.uniform(1.0, w * 0.6, (b, d))
    bh[:, 0] = 0.0
    return np.stack([y0, x0, y0 + bh, x0 + bw], -1).astype(np.float32)


def test_expand_boxes_and_interp_matrix_match():
    rng = np.random.RandomState(0)
    bx = _boxes(rng, 2, 5, 32, 40)
    for margin in (0.0, 0.1):
        np.testing.assert_allclose(
            prn_ops.expand_boxes(torch.as_tensor(bx), margin).numpy(),
            np.asarray(jax_prn_ops.expand_boxes(jnp.asarray(bx), margin)),
            **F32_TOL)
    starts, sizes = bx[0, :, 0], np.maximum(bx[0, :, 2] - bx[0, :, 0], 1e-3)
    np.testing.assert_allclose(
        prn_ops.interp_matrix(torch.as_tensor(starts), torch.as_tensor(sizes),
                              CH, 32).numpy(),
        np.asarray(jax_prn_ops.interp_matrix(jnp.asarray(starts),
                                             jnp.asarray(sizes), CH, 32)),
        **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crops_match(dtype):
    rng = np.random.RandomState(1)
    hm = rng.rand(2, K, 32, 40).astype(np.float32)
    bx = _boxes(rng, 2, 6, 32, 40)
    want = jax_prn_ops.to_channel_major(
        jax_prn_ops.batched_crop_heatmaps_cm(
            jnp.asarray(hm, dtype), jnp.asarray(bx), CH, CW), K)
    got = prn_ops.to_channel_major(
        prn_ops.crop_heatmaps_cm(torch.as_tensor(hm).to(getattr(torch, dtype)),
                                 torch.as_tensor(bx), CH, CW), K)
    assert got.shape == (12, K, CH * CW) == want.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prn_forward_matches(dtype):
    cfg = tiny_config(dtype)
    variables = prn_variables(cfg)
    p = cfg.prn
    jprn = JaxPRN(crop_height=p.crop_height, crop_width=p.crop_width,
                  num_keypoints=K, hidden_units=p.hidden_units,
                  dtype=jnp.dtype(dtype))
    tprn = PRN(p.crop_height, p.crop_width, K, p.hidden_units,
               dtype=getattr(torch, dtype))
    weights.load_prn(tprn, jax.tree.map(np.asarray, variables))
    crops = np.random.RandomState(2).rand(
        5, K, p.crop_height * p.crop_width).astype(np.float32)
    for logits in (True, False):
        want = jprn.apply(variables, jnp.asarray(crops, dtype),
                          return_logits=logits)
        with torch.no_grad():
            got = tprn(torch.as_tensor(crops).to(getattr(torch, dtype)),
                       return_logits=logits)
        tol = F32_TOL if dtype == "float32" else dict(atol=0.03, rtol=0.02)
        np.testing.assert_allclose(to_numpy(got), to_numpy(want), **tol)


def test_keypoints_from_prn_matches():
    rng = np.random.RandomState(3)
    n = 6
    prn_out = rng.randn(n, K, CH * CW).astype(np.float32)
    prn_out[0, 0, :] = 1.0  # a tie: the first index wins on both sides
    crops = rng.rand(n, K, CH * CW).astype(np.float32)
    bx = _boxes(rng, 1, n, 32, 40)[0]
    want = jax_prn_ops.keypoints_from_prn(
        jnp.asarray(prn_out), jnp.asarray(crops), jnp.asarray(bx), CH, CW)
    got = prn_ops.keypoints_from_prn(
        torch.as_tensor(prn_out), torch.as_tensor(crops), torch.as_tensor(bx),
        CH, CW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_snap_to_peaks_matches():
    rng = np.random.RandomState(4)
    b, d, p = 2, 5, 8
    bx = _boxes(rng, b, d, 32, 40)
    kps = np.concatenate([
        rng.uniform(0, 40, (b, d, K, 1)), rng.uniform(0, 32, (b, d, K, 1)),
        rng.rand(b, d, K, 1)], -1).astype(np.float32)
    # Peaks near the keypoints (some within the snap radius), some invalid,
    # and one exact duplicate so the first-of-ties rule matters.
    near = kps[:, 0, :, None, 1::-1] + rng.randn(b, K, p, 2) * 1.5
    pos = near.astype(np.float32)
    pos[:, :, 1] = pos[:, :, 0]
    scores = rng.rand(b, K, p).astype(np.float32)
    valid = rng.rand(b, K, p) > 0.3
    args_np = (kps, bx, pos, scores, valid)
    want = jax_prn_ops.snap_to_peaks(*map(jnp.asarray, args_np), CH, CW, 1.0)
    got = prn_ops.snap_to_peaks(*map(torch.as_tensor, args_np), CH, CW, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
