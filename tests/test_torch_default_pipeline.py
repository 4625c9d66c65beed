"""The port's Predictor on the default architecture (Config()) and with the
options the JAX `Predictor` serves beyond the fast() path: every uint8
batch layout of `_batch_forward_impl`, flip test-time augmentation (on
pixels, 2x2 cells and 4x4 cells), pose-level OKS NMS and the one-card
batch runner, against the JAX `Predictor` on the same weights and the
same uint8 inputs.

The JAX side runs its jnp decode (its Pallas decode is off off the TPU);
the port runs its plain decode (CPU tensors). Tolerances are those of
test_torch_predictor.py (float32 compute): boxes 2e-3 (exp-decoded in
input pixels up to 128), box scores 1e-5, decoded peaks valid exactly,
positions exact on valid slots and scores 1e-5, keypoints (PRN cells
snapped to those peaks) 1e-3. bfloat16 keeps that file's agreement
bounds: valid detections exactly, boxes to 1 px, two thirds of the JAX
peaks found at the same pixel.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.ops import image as jax_image
from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.ops import decode, image

from torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (autouse)
    JaxPredictor,
    PortPredictor,
    planted_images,
    posenet_variables,
    prn_variables,
    tiny_config,
    tiny_default_config,
    to_numpy,
    torch_config_of,
)

BOX_TOL = dict(atol=2e-3, rtol=1e-5)
SCORE_TOL = dict(atol=1e-5, rtol=1e-5)
KP_TOL = dict(atol=1e-3, rtol=1e-5)
SIZE = 128

ARCH = {"default": tiny_default_config, "fast": tiny_config}


def _config(arch, dtype="float32", pose_nms_oks=0.0):
    cfg = ARCH[arch](dtype)
    return cfg.replace(detector=dataclasses.replace(
        cfg.detector, pose_nms_oks=pose_nms_oks))


@functools.lru_cache(maxsize=None)
def _predictors(cfg, flip=False):
    variables, prn_vars = posenet_variables(cfg), prn_variables(cfg)
    jax_pred = JaxPredictor(config=cfg, variables=variables,
                            prn_variables=prn_vars, image_size=SIZE,
                            use_pallas_decode=False, flip_tta=flip)
    port = PortPredictor(torch_config_of(cfg),
                         variables=jax.tree.map(np.asarray, variables),
                         prn_variables=jax.tree.map(np.asarray, prn_vars),
                         image_size=SIZE, device="cpu", flip_tta=flip)
    return jax_pred, port


# uint8 batch layouts of `_batch_forward_impl`, each from the same scenes.
LAYOUTS = {
    "s4_flat": image.space_to_depth_flat4,
    "s4_flat_t": image.space_to_depth_flat4_t,
    "s2d_flat": image.space_to_depth_flat,
    "pixels": lambda imgs: imgs,
}


def _batch(layout, seed=0):
    if layout == "staging":  # a fixed staging size, resized on the device
        return planted_images(np.random.RandomState(seed), 2, 100, 150)
    imgs = planted_images(np.random.RandomState(seed), 2, SIZE, SIZE)
    staged = LAYOUTS[layout](imgs)
    if layout != "pixels":
        np.testing.assert_array_equal(
            staged, getattr(jax_image, LAYOUTS[layout].__name__)(imgs))
    return staged


def _jax_batch_forward(jax_pred, batch):
    out = jax.jit(jax_pred._batch_forward_impl)(
        jax_pred.variables, jax_pred.prn_variables, jnp.asarray(batch))
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_batch_outputs(got, want):
    valid = want["box_valid"]
    assert valid.any() and want["peak_valid"].any()
    np.testing.assert_array_equal(to_numpy(got["box_valid"]).astype(bool),
                                  valid)
    np.testing.assert_allclose(to_numpy(got["boxes"]), want["boxes"],
                               **BOX_TOL)
    np.testing.assert_allclose(to_numpy(got["box_scores"]),
                               want["box_scores"], **SCORE_TOL)
    pv = want["peak_valid"]
    np.testing.assert_array_equal(to_numpy(got["peak_valid"]).astype(bool),
                                  pv)
    np.testing.assert_allclose(to_numpy(got["peak_scores"]),
                               want["peak_scores"], **SCORE_TOL)
    np.testing.assert_array_equal(to_numpy(got["peak_positions"])[pv],
                                  want["peak_positions"][pv])
    np.testing.assert_allclose(to_numpy(got["keypoints"]), want["keypoints"],
                               **KP_TOL)


def _check_batch(cfg, layout, flip=False):
    jax_pred, port = _predictors(cfg, flip)
    batch = _batch(layout)
    want = _jax_batch_forward(jax_pred, batch)
    kernels.reset_launches()
    got = port.batch_forward(batch)
    assert kernels.LAUNCHES == {}  # CPU tensors: the plain decode
    _assert_batch_outputs(got, want)
    return got, want


def _assert_people(got, want):
    assert len(want) > 0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.box, w.box, **BOX_TOL)
        assert abs(g.score - w.score) <= 1e-5
        np.testing.assert_allclose(g.keypoints, w.keypoints, **KP_TOL)


def _image():
    return planted_images(np.random.RandomState(2), 1, 96, 150)[0]


@pytest.mark.parametrize("arch,layout", [
    ("default", "s2d_flat"),
    ("default", "staging"),
    ("fast", "s4_flat_t"),
])
def test_batch_layouts_match_jax(arch, layout):
    """The layouts the earlier slices did not take (s4-flat and
    letterboxed pixels are held in test_torch_predictor.py)."""
    _check_batch(_config(arch), layout)


@pytest.mark.parametrize("arch,layout", [
    ("default", "s2d_flat"),   # 2x2 cells: mirrored column phases
    ("fast", "s4_flat"),       # 4x4 cells: both column phases mirrored
])
def test_flip_tta_batch_forward_matches_jax(arch, layout):
    _check_batch(_config(arch), layout, flip=True)


def test_flip_tta_predict_matches_jax():
    """Flip TTA on letterboxed pixels, through `predict`."""
    jax_pred, port = _predictors(_config("default"), True)
    _assert_people(port.predict(_image()), jax_pred.predict(_image()))


@pytest.mark.parametrize("entry", ["predict_heatmaps", "predict_keypoints",
                                   "predict_given_boxes"])
def test_flip_tta_entry_points_match_jax(entry):
    """The keypoint-only and given-box entry points read the averaged
    maps too: heatmaps at the model tolerance (3e-5 + 1e-5 relative),
    peaks by the decode contract, keypoints 1e-3."""
    jax_pred, port = _predictors(_config("default"), True)
    boxes = np.array([[10, 20, 80, 70], [5, 60, 90, 140]], np.float32)
    args = (_image(),) + ((boxes,) if entry == "predict_given_boxes" else ())
    got, want = getattr(port, entry)(*args), getattr(jax_pred, entry)(*args)
    if entry == "predict_heatmaps":
        np.testing.assert_allclose(got, np.asarray(want), atol=3e-5,
                                   rtol=1e-5)
    elif entry == "predict_keypoints":
        pos, scores, valid = got
        w_pos, w_scores, w_valid = (np.asarray(t) for t in want)
        assert w_valid.any()
        np.testing.assert_array_equal(valid, w_valid)
        np.testing.assert_allclose(scores, w_scores, **SCORE_TOL)
        np.testing.assert_array_equal(pos[valid], w_pos[valid])
    else:
        np.testing.assert_allclose(got, np.asarray(want), **KP_TOL)


def test_flip_tta_decodes_contiguous_maps():
    """The averaged maps reach the decode as a contiguous [B, K, H, W]
    copy in the compute dtype, which B1 takes on a card (a strided view
    would be routed to the generic decode kernel)."""
    _, port = _predictors(_config("default"), True)
    with torch.inference_mode():
        out = port._forward(port._model_input(
            torch.as_tensor(_batch("s2d_flat"))))
    assert "heatmaps_cm" not in out
    hm_cm = port._heatmaps_cm(out)
    assert hm_cm.is_contiguous() and hm_cm.dtype == port.dtype
    assert tuple(hm_cm.shape) == (2, 17, SIZE // 4, SIZE // 4)
    assert decode.route(hm_cm, port.config.decode) == decode.KERNEL
    np.testing.assert_array_equal(
        hm_cm.numpy(), out["heatmaps"].permute(0, 3, 1, 2).numpy())


def test_default_predict_matches_jax():
    jax_pred, port = _predictors(_config("default"))
    _assert_people(port.predict(_image()), jax_pred.predict(_image()))


@pytest.mark.parametrize("entry", ["batch_forward", "predict"])
def test_pose_nms_matches_jax(entry):
    """Pose-level OKS NMS at a threshold where it drops detections of
    this scene: the same ones as the JAX package."""
    cfg = _config("default", pose_nms_oks=0.1)
    if entry == "predict":
        jax_pred, port = _predictors(cfg)
        got, want = port.predict(_image()), jax_pred.predict(_image())
        unsuppressed = _predictors(_config("default"))[1].predict(_image())
        assert len(want) < len(unsuppressed)
        _assert_people(got, want)
        return
    got, want = _check_batch(cfg, "s2d_flat")
    plain = _predictors(_config("default"))[1].batch_forward(
        _batch("s2d_flat"))
    assert want["box_valid"].sum() < to_numpy(plain["box_valid"]).sum()


def test_default_batch_forward_bf16_agrees_with_jax():
    """bf16 compute on the s2d-flat layout, held to the agreement bounds
    of test_torch_crowd.py's bf16 test: the sums run in other orders, and
    with random weights the 4-conv detector towers give candidates of
    near-equal scores, so a flipped NMS pick moves a slot's box. The valid
    slots agree exactly, the slot scores to 0.02 (4.7e-4 observed), at
    least half of the JAX boxes are found within 1 px among the port's
    boxes of the same image (14 of 16 observed), and at least two thirds
    of its peaks at the same pixel (159 of 194 observed)."""
    jax_pred, port = _predictors(_config("default", "bfloat16"))
    batch = _batch("s2d_flat", seed=3)
    want = _jax_batch_forward(jax_pred, batch)
    got = {k: to_numpy(v) for k, v in port.batch_forward(batch).items()}
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert np.isfinite(got[key]).all(), key
    valid = want["box_valid"]
    np.testing.assert_array_equal(got["box_valid"].astype(bool), valid)
    np.testing.assert_allclose(got["box_scores"], want["box_scores"],
                               atol=0.02)
    near = [np.abs(want["boxes"][b][valid[b], None]
                   - got["boxes"][b][None]).max(-1).min(-1) <= 1.0
            for b in range(valid.shape[0])]
    assert np.concatenate(near).mean() >= 0.5
    pos_w, val_w = want["peak_positions"], want["peak_valid"]
    pos_g, val_g = got["peak_positions"], got["peak_valid"].astype(bool)
    found = 0
    for b, k in np.ndindex(val_w.shape[:2]):
        mine = {tuple(p) for p in pos_g[b, k][val_g[b, k]]}
        found += sum(tuple(p) in mine for p in pos_w[b, k][val_w[b, k]])
    assert found >= 2 / 3 * val_w.sum() > 0


def test_default_predict_bf16_agrees_with_jax():
    """bf16 `predict` on one non-square image, with the bounds of the bf16
    batch test: as many people, scores in slot order to 0.02 (4.7e-4
    observed), at least half of the JAX boxes found within 1 px among the
    port's (8 of 8 observed)."""
    jax_pred, port = _predictors(_config("default", "bfloat16"))
    want, got = jax_pred.predict(_image()), port.predict(_image())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert abs(g.score - w.score) <= 0.02
        assert np.isfinite(g.keypoints).all() and g.keypoints.shape == (17, 3)
    box_w = np.stack([w.box for w in want])
    box_g = np.stack([g.box for g in got])
    near = np.abs(box_w[:, None] - box_g[None]).max(-1).min(-1) <= 1.0
    assert near.mean() >= 0.5


def test_make_batch_runner_is_batch_forward():
    """On the predictor's one device the runner is `batch_forward`; a
    mesh that does not divide the batch is refused (the sharded runner:
    tests/test_torch_mesh.py)."""
    _, port = _predictors(_config("default"))
    run = port.make_batch_runner()
    assert run == port.batch_forward
    batch = _batch("s2d_flat")
    a, b = run(batch), port.batch_forward(batch)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    with pytest.raises(ValueError, match="shard"):
        port.make_batch_runner([torch.device("cpu")] * (len(batch) + 1))(
            batch)
