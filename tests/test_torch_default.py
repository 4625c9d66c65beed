"""The port's MultiPoseNet for the repo's default architecture (Config():
the 3x3/s2 stem over 2x2 space-to-depth cells, towers over the smoothed
P2..P5, the fuse conv and the stride-4 output conv) and for each option
of it taken alone into the fast() architecture, against the JAX
package's `MultiPoseNet.apply` on the same numpy inputs and weights.

Both stems run on every input they take: raw pixels, space-to-depth
cells, and sides that are not multiples of the stride, where both
packages fall back to the plain strided conv (with the input normalize
applied explicitly when it is folded into the stem). Sides of 127 and
125 keep the FPN's top-down sizes consistent (C2 a multiple of 8 cells).

Tolerances are those of test_torch_models.py: float32 3e-5 absolute +
1e-5 relative with a mean under 1e-6, bfloat16 0.04 + 2% with a mean
under 4e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.config import Config as JaxConfig
from multiposenet_tpu.infer.folding import fold_batch_norm as jax_fold
from multiposenet_tpu.models.mobilenet import (
    stem_kernel_to_s2d as jax_stem_kernel_to_s2d,
)
from multiposenet_tpu.ops.image import normalize as jax_normalize
from multiposenet_tpu_torch.models.mobilenet import stem_kernel_to_s2d
from multiposenet_tpu_torch.ops import decode, image

from torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (autouse)
    MODEL_TOL,
    assert_model_close,
    jax_apply,
    port_model,
    posenet_variables,
    tiny_config,
    tiny_default_config,
    torch_config_of,
)


def _compare(out_t, out_j, tol):
    for key in ("heatmaps", "heatmaps_cm", "segmentation"):
        assert_model_close(out_t[key], out_j[key], tol, key)
    assert set(out_t["detector"]) == set(out_j["detector"])
    for level, pair in out_j["detector"].items():
        for kind in ("cls", "box"):
            assert_model_close(out_t["detector"][level][kind], pair[kind],
                               tol, f"{level}.{kind}")


def _input(staging, size, fold, stem_stride, seed):
    """uint8 images staged as the model takes them: pixels (normalized
    unless the stem folds the normalize), or 2x2 / 4x4 cells."""
    pixels = np.random.RandomState(seed).randint(
        0, 256, (2, size, size, 3)).astype(np.uint8)
    if staging == "pixels":
        if fold:
            return pixels.astype(np.float32)
        return np.array(jax_normalize(jnp.asarray(pixels)), np.float32)
    if staging == "s2d_cells":
        flat = torch.as_tensor(image.space_to_depth_flat(pixels))
        cells = (image.s2d_flat_to_cells(flat) if fold
                 else image.normalize_s2d_flat(flat))
        return cells.numpy()
    assert stem_stride == 4
    flat = torch.as_tensor(image.space_to_depth_flat4(pixels))
    cells = (image.s4_flat_to_cells(flat) if fold
             else image.normalize_s4_flat(flat))
    return cells.numpy()


def _check(cfg, staging, size, seed=0):
    m = cfg.model
    variables = posenet_variables(cfg)
    x = _input(staging, size, m.fold_input_norm, m.stem_stride, seed)
    out_j = jax_apply(cfg)(variables, jnp.asarray(x))
    with torch.no_grad():
        out_t = port_model(cfg, variables)(torch.as_tensor(x))
    assert out_t["heatmaps"].shape == out_j["heatmaps"].shape
    _compare(out_t, out_j, MODEL_TOL[m.compute_dtype])


@pytest.mark.parametrize("dtype,fold,staging,size", [
    ("float32", False, "pixels", 128),
    ("float32", False, "s2d_cells", 128),
    ("float32", False, "pixels", 127),     # odd: the plain 3x3/s2 conv
    ("float32", True, "pixels", 128),
    ("float32", True, "s2d_cells", 128),
    ("float32", True, "pixels", 127),      # odd, normalize applied first
    ("bfloat16", False, "s2d_cells", 128),
    ("bfloat16", True, "pixels", 127),
])
def test_default_architecture_matches_jax(dtype, fold, staging, size):
    _check(tiny_default_config(dtype, fold_input_norm=fold), staging, size)


def test_default_architecture_without_s2d_stem_matches_jax():
    """s2d_stem=False: the plain 3x3/s2 conv at every size."""
    _check(tiny_default_config("float32", s2d_stem=False), "pixels", 128)


@pytest.mark.parametrize("fold,staging,size", [
    (True, "pixels", 126),    # fast(): raw pixels, sides not % 4
    (False, "pixels", 125),   # normalized pixels, odd sides
    (True, "s2d_cells", 128),  # 2x2 cells into the s4 matmul stem
    (False, "s2d_cells", 128),
])
def test_s4_stem_off_the_matmul_path_matches_jax(fold, staging, size):
    """The stride-4 stem where its matmul over 4x4 cells does not apply:
    the plain 4x4/s4 SAME conv on sides that are not multiples of 4, and
    the matmul over 2x2 cells regrouped into 4x4 ones."""
    cfg = tiny_config("float32")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                fold_input_norm=fold))
    _check(cfg, staging, size)


@pytest.mark.parametrize("field,value,dtype", [
    ("kp_smooth_pyramid", True, "float32"),
    ("kp_p2_late", False, "float32"),
    ("kp_fuse_conv", True, "float32"),
    ("stem_stride", 2, "float32"),
    ("head_channels", 48, "float32"),
    ("head_channels", 48, "bfloat16"),
])
def test_each_default_option_in_fast_matches_jax(field, value, dtype):
    """Each of the options that set Config() apart from fast(), alone in
    the tiny fast() architecture: the head then keeps its p2_late entry
    on the smoothed P2 (no L2), towers at stride 4 with an upsample-add
    on the raw T2, the fuse conv at stride 8, the stride-2 stem, or a
    head wider than the FPN (its P2 through `p2_lateral`)."""
    cfg = tiny_config(dtype)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **{field: value}))
    _check(cfg, "pixels", 128, seed=1)


def test_default_head_wider_than_fpn_matches_jax():
    """Config() with a 48-wide head over the 32-wide FPN: the towers' first
    convs take the FPN's width."""
    _check(tiny_default_config("float32", head_channels=48), "pixels", 128)


@pytest.mark.parametrize("folded", [False, True])
def test_full_width_default_weights_load(folded):
    """Config() at full width, its flax tree and its BN-folded tree: every
    parameter of the JAX package's tree has a slot of the same size in the
    port (strict load), and the widths are the paper's (32 at the
    stride-2 stem, 64 in block_0 above stride 4, 1024 at C5)."""
    cfg = JaxConfig()
    variables = posenet_variables(cfg)
    if folded:
        variables = jax_fold(variables, epsilon=cfg.model.bn_epsilon)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    bn_folded=True))
    model = port_model(cfg, variables)
    b = model.backbone
    assert b.stem.conv.kernel.shape == (3, 3, 3, 32)
    assert (b.stem.bn is None) == folded
    assert b.block_0.pointwise.conv.weight.shape[0] == 64
    assert b.block_12.pointwise.conv.weight.shape[0] == 1024
    assert model.fpn.smooth_P2.weight.shape == (128, 128, 3, 3)
    assert model.keypoint_head.fuse.weight.shape == (128, 128, 3, 3)
    n_flax = sum(np.size(v) for v in jax.tree.leaves(variables))
    assert sum(t.numel() for t in model.state_dict().values()) == n_flax


def test_stem_kernel_s2d_remap_matches_jax():
    kernel = np.random.RandomState(0).randn(3, 3, 3, 5).astype(np.float32)
    want = np.asarray(jax_stem_kernel_to_s2d(jnp.asarray(kernel)))
    got = stem_kernel_to_s2d(torch.as_tensor(kernel)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,staging,size", [
    ("default", "pixels", 128),
    ("default", "s2d_cells", 128),
    ("default", "pixels", 127),
    ("fast", "pixels", 126),
    ("fast", "s2d_cells", 128),
])
def test_every_stem_keeps_the_maps_in_b1_layout(arch, staging, size):
    """Whatever the stem runs, the activations stay NCHW in memory, so the
    head's channel-major heatmaps are contiguous [K, H, W] blocks, which
    B1 takes on a card (channels-last maps would be routed to the generic
    decode kernel)."""
    cfg = (tiny_default_config("float32") if arch == "default"
           else tiny_config("float32"))
    x = _input(staging, size, cfg.model.fold_input_norm,
               cfg.model.stem_stride, 0)
    with torch.no_grad():
        hm_cm = port_model(cfg, posenet_variables(cfg))(
            torch.as_tensor(x))["heatmaps_cm"]
    b, k, h, w = hm_cm.shape
    assert hm_cm.stride()[1:] == (h * w, w, 1)
    assert decode.route(hm_cm, torch_config_of(cfg).decode) == decode.KERNEL
