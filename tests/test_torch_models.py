"""The PyTorch port's MultiPoseNet forward against the JAX package's
`MultiPoseNet.apply`, on the same numpy inputs and the same weights.

Tolerances:
  * float32: 3e-5 absolute + 1e-5 relative. Both sides compute in f32 but
    sum the conv taps in different orders (XLA's CPU convs vs PyTorch's);
    about twenty layers deep that leaves ~2e-6 on outputs of order 1, and
    the bound keeps a tenfold margin over it.
  * bfloat16: 0.04 absolute + 2% relative, and a mean error under 4e-3.
    One bf16 ulp is 2**-8 relative (0.0078 at 2.0); the two frameworks
    round activations at the same points but accumulate in different
    orders, so single elements may differ by a few ulps while the mean
    stays far below one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.config import Config as JaxConfig
from multiposenet_tpu.models.mobilenet import (
    stem_kernel_to_s4 as jax_stem_kernel_to_s4,
)
from multiposenet_tpu.models.posenet import MultiPoseNet as JaxMultiPoseNet
from multiposenet_tpu.ops.image import normalize as jax_normalize
from multiposenet_tpu.ops.image import space_to_depth_flat4 as jax_s2d4
from multiposenet_tpu_torch import weights
from multiposenet_tpu_torch.models.layers import same_pad
from multiposenet_tpu_torch.models.mobilenet import stem_kernel_to_s4
from multiposenet_tpu_torch.models.posenet import MultiPoseNet
from multiposenet_tpu_torch.ops.image import (
    s4_flat_to_cells,
    space_to_depth_flat4,
)

from torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (autouse)
    jax_apply,
    posenet_variables,
    tiny_config,
    to_numpy,
    torch_config_of,
)

TOL = {
    "float32": dict(atol=3e-5, rtol=1e-5, mean=1e-6),
    "bfloat16": dict(atol=0.04, rtol=0.02, mean=4e-3),
}


def _torch_model(cfg, variables):
    model = MultiPoseNet(torch_config_of(cfg))
    weights.load_posenet(model, jax.tree.map(np.asarray, variables))
    return model.eval()


def _assert_close(got, want, dtype, what):
    got, want = to_numpy(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, atol=tol["atol"], rtol=tol["rtol"],
                               err_msg=what)
    assert np.mean(np.abs(got - want)) < tol["mean"], what


def _compare_outputs(out_t, out_j, dtype):
    for key in ("heatmaps", "heatmaps_cm", "segmentation"):
        _assert_close(out_t[key], out_j[key], dtype, key)
    assert set(out_t["detector"]) == set(out_j["detector"])
    for level, pair in out_j["detector"].items():
        for kind in ("cls", "box"):
            _assert_close(out_t["detector"][level][kind], pair[kind], dtype,
                          f"{level}.{kind}")


@pytest.mark.parametrize("dtype,size,staging", [
    ("float32", 128, "pixels"),
    ("float32", 128, "s4_cells"),
    # 96² gives a 3x3 P5, so P6 pads (1, 1) and P7 (0, 1) under SAME.
    ("float32", 96, "pixels"),
    ("bfloat16", 128, "s4_cells"),
    ("bfloat16", 96, "pixels"),
])
def test_forward_matches_jax(dtype, size, staging):
    cfg = tiny_config(dtype)
    variables = posenet_variables(cfg)
    rng = np.random.RandomState(size)
    pixels = rng.randint(0, 256, (2, size, size, 3)).astype(np.uint8)
    if staging == "pixels":
        x = pixels.astype(np.float32)
    else:
        flat = space_to_depth_flat4(pixels)
        np.testing.assert_array_equal(flat, jax_s2d4(pixels))
        x = np.asarray(s4_flat_to_cells(torch.as_tensor(flat)))
    out_j = jax_apply(cfg)(variables, jnp.asarray(x))
    with torch.no_grad():
        out_t = _torch_model(cfg, variables)(torch.as_tensor(x))
    assert out_t["heatmaps_cm"].dtype == (
        torch.float32 if dtype == "float32" else torch.bfloat16)
    assert out_t["heatmaps"].dtype == torch.float32
    _compare_outputs(out_t, out_j, dtype)


def test_forward_matches_jax_without_folded_input_norm():
    """fold_input_norm=False: the stem takes normalized pixels and keeps
    its kernel as it is."""
    cfg = tiny_config("float32")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                fold_input_norm=False))
    variables = posenet_variables(cfg)
    pixels = np.random.RandomState(4).randint(0, 256, (2, 128, 128, 3)).astype(
        np.uint8)
    x = np.array(jax_normalize(jnp.asarray(pixels)), np.float32)
    out_j = jax_apply(cfg)(variables, jnp.asarray(x))
    with torch.no_grad():
        out_t = _torch_model(cfg, variables)(torch.as_tensor(x))
    _compare_outputs(out_t, out_j, "float32")


def test_forward_matches_jax_from_flax_init():
    """Weights straight from the JAX model's own `init` (lecun-normal
    kernels, zero biases, identity BatchNorm statistics)."""
    cfg = tiny_config("float32")
    model = JaxMultiPoseNet(config=cfg, with_detector=True)
    x = np.random.RandomState(3).randint(0, 256, (1, 128, 128, 3)).astype(
        np.float32)
    variables = jax.jit(lambda key, img: model.init(key, img, train=False))(
        jax.random.PRNGKey(7), jnp.asarray(x))
    out_j = jax_apply(cfg)(variables, jnp.asarray(x))
    with torch.no_grad():
        out_t = _torch_model(cfg, variables)(torch.as_tensor(x))
    _compare_outputs(out_t, out_j, "float32")


@pytest.mark.parametrize("n,k,s", [
    (128, 3, 2), (64, 3, 2), (3, 3, 2), (2, 3, 2), (1, 3, 2), (5, 3, 2),
    (32, 3, 1), (17, 1, 1), (512, 4, 4),
])
def test_same_pad_matches_lax(n, k, s):
    want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert same_pad(n, k, s) == tuple(want)


def test_stem_kernel_remap_matches_jax():
    kernel = np.random.RandomState(0).randn(4, 4, 3, 5).astype(np.float32)
    want = np.asarray(jax_stem_kernel_to_s4(jnp.asarray(kernel)))
    got = stem_kernel_to_s4(torch.as_tensor(kernel)).numpy()
    np.testing.assert_array_equal(got, want)


def test_full_width_fast_weights_load():
    """Config.fast() at full width: every flax parameter of the JAX model
    has a slot of the same size in the port (strict load), and the
    backbone widths are the documented ones."""
    cfg = JaxConfig.fast()
    variables = posenet_variables(cfg)
    model = _torch_model(cfg, variables)
    b = model.backbone
    assert b.stem.conv.kernel.shape == (4, 4, 3, 24)
    widths = {name: getattr(b, f"block_{i}").pointwise.conv.weight.shape[0]
              for i, name in ((2, "C2"), (4, "C3"), (10, "C4"), (12, "C5"))}
    assert widths == {"C2": 48, "C3": 128, "C4": 256, "C5": 256}
    n_flax = sum(np.size(v) for v in jax.tree.leaves(variables))
    n_port = sum(t.numel() for t in model.state_dict().values())
    assert n_port == n_flax


def test_batchnorm_uses_config_epsilon():
    cfg = tiny_config("float32")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, bn_epsilon=0.5))
    model = MultiPoseNet(torch_config_of(cfg))
    assert model.backbone.stem.bn.eps == 0.5
    assert MultiPoseNet(torch_config_of(tiny_config())).backbone.stem.bn.eps \
        == 1e-3
