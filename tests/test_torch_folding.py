"""BatchNorm folding in the port (`multiposenet_tpu_torch.infer.folding`,
the `bn_folded` model flavour) against the JAX package's
`fold_batch_norm` and its `bn_folded` model, on the same weights.

Tolerances: the two folds are the same float32 numpy arithmetic, 1e-6.
The folded models compare as the unfolded ones do in test_torch_models.py
(float32 3e-5 + 1e-5 relative; bfloat16 0.04 + 2% with a mean under
4e-3). Folded against unfolded in the port is the same float32 function
computed with the BN affine moved into the conv weights, a few ulps
after some twenty layers: 3e-5 + 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.infer.folding import fold_batch_norm as jax_fold
from multiposenet_tpu.ops.image import normalize as jax_normalize
from multiposenet_tpu_torch.infer import folding

from torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (autouse)
    MODEL_TOL,
    assert_model_close,
    jax_apply,
    port_model,
    posenet_variables,
    tiny_crowd_config,
    tiny_default_config,
)


def _folded_cfg(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, bn_folded=True))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _compare(out_t, out_j, tol):
    for key in ("heatmaps", "heatmaps_cm"):
        assert_model_close(out_t[key], out_j[key], tol, key)
    for level, pair in out_j["detector"].items():
        for kind in ("cls", "box", "iou"):
            assert_model_close(out_t["detector"][level][kind], pair[kind],
                               tol, f"{level}.{kind}")


def test_fold_matches_jax_fold():
    cfg = tiny_crowd_config()
    variables = posenet_variables(cfg)
    want = jax_fold(variables, epsilon=cfg.model.bn_epsilon)
    got = folding.fold_batch_norm(_numpy_tree(variables),
                                  epsilon=cfg.model.bn_epsilon)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    assert not any("bn" in jax.tree_util.keystr(p) for p, _ in flat_g)
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-6,
                                   rtol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_model_matches_jax_folded_model(dtype):
    """The bn_folded flavour on one folded tree: conv with a bias and no
    BN, the depthwise conv's fused bias + ReLU6, the s4 stem's fold-norm
    bias and folded BN bias added one after the other."""
    cfg = tiny_crowd_config(dtype, tail=False)
    folded = jax_fold(posenet_variables(cfg), epsilon=cfg.model.bn_epsilon)
    cfg_f = _folded_cfg(cfg)
    x = np.random.RandomState(21).randint(0, 256, (2, 128, 128, 3)).astype(
        np.float32)
    out_j = jax_apply(cfg_f)(folded, jnp.asarray(x))
    with torch.no_grad():
        out_t = port_model(cfg_f, folded)(torch.as_tensor(x))
    _compare(out_t, out_j, MODEL_TOL[dtype])
    assert_model_close(out_t["segmentation"], out_j["segmentation"],
                       MODEL_TOL[dtype], "segmentation")


def test_folded_matches_unfolded():
    cfg = tiny_crowd_config(tail=False)
    variables = posenet_variables(cfg)
    x = torch.as_tensor(np.random.RandomState(22).randint(
        0, 256, (2, 128, 128, 3)).astype(np.float32))
    unfolded = port_model(cfg, variables)
    folded = port_model(_folded_cfg(cfg),
                        folding.fold_batch_norm(_numpy_tree(variables)))
    with torch.no_grad():
        a, b = unfolded(x), folded(x)
    tol = MODEL_TOL["float32"]
    for key in ("heatmaps", "segmentation"):
        assert_model_close(b[key], a[key], tol, key)
    for level in a["detector"]:
        for kind in ("cls", "box", "iou"):
            assert_model_close(b["detector"][level][kind],
                               a["detector"][level][kind], tol, kind)


def test_in_place_fold_equals_tree_fold():
    """Folding the loaded modules in place leaves the modules and the
    state_dict of the bn_folded model loaded from the folded tree."""
    cfg = tiny_crowd_config()
    variables = posenet_variables(cfg)
    model = folding.fold_batch_norm_(port_model(cfg, variables))
    want = port_model(_folded_cfg(cfg),
                      folding.fold_batch_norm(_numpy_tree(variables)))
    got_sd, want_sd = model.state_dict(), want.state_dict()
    assert list(got_sd) == list(want_sd)
    assert not any(".bn." in name for name in got_sd)
    for name, t in want_sd.items():
        torch.testing.assert_close(got_sd[name], t, atol=1e-6, rtol=1e-6,
                                   msg=name)


def test_folded_tree_loads_strictly_at_full_width():
    """Config.crowd() folded at full width: every parameter of the JAX
    package's folded tree has a slot of the same size in the port."""
    from multiposenet_tpu.config import Config as JaxConfig

    cfg = JaxConfig.crowd()
    folded = jax_fold(posenet_variables(cfg), epsilon=cfg.model.bn_epsilon)
    model = port_model(_folded_cfg(cfg), folded)
    assert model.backbone.stem.bn is None
    assert model.backbone.stem.conv.bias.shape == (24,)
    assert model.detector_head.iou_out.weight.shape == (9, 64, 3, 3)
    n_flax = sum(np.size(v) for v in jax.tree.leaves(folded))
    assert sum(t.numel() for t in model.state_dict().values()) == n_flax


@pytest.mark.parametrize("fold_input_norm", [False, True])
def test_default_fold_matches_jax_fold(fold_input_norm):
    """Config() at test widths: every BatchNorm site (the 3x3/s2 stem, with
    the input normalize folded into it or not, and each block) folds in
    the numpy fold as in the JAX package's, and the in-place fold of the
    loaded modules gives the state_dict of the folded tree."""
    cfg = tiny_default_config(fold_input_norm=fold_input_norm)
    variables = posenet_variables(cfg)
    want = jax_fold(variables, epsilon=cfg.model.bn_epsilon)
    got = folding.fold_batch_norm(_numpy_tree(variables),
                                  epsilon=cfg.model.bn_epsilon)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-6,
                                   rtol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    model = folding.fold_batch_norm_(port_model(cfg, variables))
    assert not any(".bn." in name for name in model.state_dict())
    assert model.backbone.stem.conv.kernel.shape == (3, 3, 3, 8)
    want_sd = port_model(_folded_cfg(cfg), got).state_dict()
    got_sd = model.state_dict()
    assert list(got_sd) == list(want_sd)
    for name, t in want_sd.items():
        torch.testing.assert_close(got_sd[name], t, atol=1e-6, rtol=1e-6,
                                   msg=name)


@pytest.mark.parametrize("fold_input_norm,size", [(False, 128), (True, 128),
                                                  (True, 127)])
def test_default_folded_model_matches_jax_folded_model(fold_input_norm,
                                                       size):
    """The bn_folded flavour of Config(): the s2 stem's kernel and bias
    folded (on 2x2 cells, and at an odd size on the plain 3x3/s2 conv
    with the explicit normalize), against the JAX package's folded model
    on the same folded tree, float32."""
    cfg = tiny_default_config(fold_input_norm=fold_input_norm)
    folded = jax_fold(posenet_variables(cfg), epsilon=cfg.model.bn_epsilon)
    cfg_f = _folded_cfg(cfg)
    x = np.random.RandomState(23).randint(0, 256, (2, size, size, 3)).astype(
        np.float32)
    if not fold_input_norm:
        x = np.array(jax_normalize(jnp.asarray(x)))
    out_j = jax_apply(cfg_f)(folded, jnp.asarray(x))
    with torch.no_grad():
        out_t = port_model(cfg_f, folded)(torch.as_tensor(x))
    tol = MODEL_TOL["float32"]
    for key in ("heatmaps", "heatmaps_cm", "segmentation"):
        assert_model_close(out_t[key], out_j[key], tol, key)
    for level, pair in out_j["detector"].items():
        for kind in ("cls", "box"):
            assert_model_close(out_t["detector"][level][kind], pair[kind],
                               tol, f"{level}.{kind}")
