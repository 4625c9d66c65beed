"""The port's inference pipeline as a whole against the JAX `Predictor`,
with the same weights and the same uint8 inputs: `batch_forward` on
s4-flat batches (the counterpart of `_batch_forward_impl`, the path
`bench.py` times) and `predict` on one non-square image.

The JAX side runs once with its jnp decode and once with the Pallas decode
kernel in interpret mode; the port runs its plain decode (CPU tensors).

Tolerances (float32 compute): the model outputs agree to ~2e-6
(test_torch_models.py). Boxes are exp-decoded from them in input pixels
(up to 128) and get 2e-3; box scores are sigmoids, 1e-5. Decoded peaks
are compared as in test_torch_decode.py (valid exact, positions exact on
valid slots, scores 1e-5). Keypoints are PRN argmax cells snapped to
those peaks, so positions are selections of exact values, 1e-3 absolute.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.infer.predictor import Predictor as JaxPredictor
from multiposenet_tpu.ops.image import space_to_depth_flat4 as jax_s2d4
from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.infer.predictor import Predictor
from multiposenet_tpu_torch.ops.image import space_to_depth_flat4

from torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (autouse)
    planted_images,
    posenet_variables,
    prn_variables,
    tiny_config,
    to_numpy,
    torch_config_of,
)

BOX_TOL = dict(atol=2e-3, rtol=1e-5)
SCORE_TOL = dict(atol=1e-5, rtol=1e-5)
KP_TOL = dict(atol=1e-3, rtol=1e-5)
SIZE = 128


def _predictors(dtype, pallas):
    cfg = tiny_config(dtype)
    variables = posenet_variables(cfg)
    prn_vars = prn_variables(cfg)
    jax_pred = JaxPredictor(config=cfg, variables=variables,
                            prn_variables=prn_vars, image_size=SIZE,
                            use_pallas_decode=pallas, pallas_interpret=pallas)
    port = Predictor(torch_config_of(cfg),
                     variables=jax.tree.map(np.asarray, variables),
                     prn_variables=jax.tree.map(np.asarray, prn_vars),
                     image_size=SIZE, device="cpu")
    return jax_pred, port


def _batch():
    return space_to_depth_flat4(
        planted_images(np.random.RandomState(0), 2, SIZE, SIZE))


def _image():
    return planted_images(np.random.RandomState(2), 1, 96, 150)[0]


@functools.lru_cache(maxsize=None)
def _jax_batch_forward(pallas):
    jax_pred, _ = _predictors("float32", pallas)
    out = jax.jit(jax_pred._batch_forward_impl)(
        jax_pred.variables, jax_pred.prn_variables, jnp.asarray(_batch()))
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _jax_predict(pallas):
    jax_pred, _ = _predictors("float32", pallas)
    return jax_pred.predict(_image())


def _where_reference_self_consistent(want_kp, jnp_kp):
    """The JAX package's whole programs with the interpret-mode decode
    kernel set the snapped x of a few keypoints to 0, though the peaks
    they decode equal the jnp decode's on every valid slot, and their
    decode and PRN stages compiled without the rest of the program give
    the values the jnp-decode program gives (ROADMAP queue C). Where the
    two JAX programs disagree, the port is held to the jnp-decode one."""
    differ = np.abs(jnp_kp - want_kp).max(-1) > KP_TOL["atol"]
    assert differ.mean() < 0.05
    return np.where(differ[..., None], jnp_kp, want_kp)


def _assert_peaks(got, want):
    valid = want["peak_valid"]
    np.testing.assert_array_equal(to_numpy(got["peak_valid"]).astype(bool),
                                  valid)
    np.testing.assert_allclose(to_numpy(got["peak_scores"]),
                               want["peak_scores"], **SCORE_TOL)
    np.testing.assert_array_equal(to_numpy(got["peak_positions"])[valid],
                                  want["peak_positions"][valid])


@pytest.mark.parametrize("pallas", [False, True],
                         ids=["jnp_decode", "pallas_interpret"])
def test_batch_forward_matches_jax(pallas):
    _, port = _predictors("float32", pallas)
    images = planted_images(np.random.RandomState(0), 2, SIZE, SIZE)
    np.testing.assert_array_equal(space_to_depth_flat4(images),
                                  jax_s2d4(images))
    want = _jax_batch_forward(pallas)
    kernels.reset_launches()
    got = port.batch_forward(_batch())
    assert kernels.LAUNCHES == {}  # CPU tensors: the plain decode

    valid = want["box_valid"]
    assert valid.any()
    np.testing.assert_array_equal(to_numpy(got["box_valid"]).astype(bool),
                                  valid)
    np.testing.assert_allclose(to_numpy(got["boxes"]), want["boxes"],
                               **BOX_TOL)
    np.testing.assert_allclose(to_numpy(got["box_scores"]),
                               want["box_scores"], **SCORE_TOL)
    assert want["peak_valid"].any()
    _assert_peaks(got, want)
    want_kp = want["keypoints"]
    if pallas:
        want_kp = _where_reference_self_consistent(
            want_kp, _jax_batch_forward(False)["keypoints"])
    np.testing.assert_allclose(to_numpy(got["keypoints"]), want_kp, **KP_TOL)


def test_batch_forward_square_pixels_match_s4_flat():
    """The two uint8 layouts `batch_forward` takes give one answer."""
    _, port = _predictors("float32", False)
    images = planted_images(np.random.RandomState(1), 2, SIZE, SIZE)
    a = port.batch_forward(space_to_depth_flat4(images))
    b = port.batch_forward(images)
    for key in a:
        np.testing.assert_allclose(to_numpy(a[key]), to_numpy(b[key]),
                                   atol=1e-4, err_msg=key)


@pytest.mark.parametrize("pallas", [False, True],
                         ids=["jnp_decode", "pallas_interpret"])
def test_predict_non_square_matches_jax(pallas):
    _, port = _predictors("float32", pallas)
    want = _jax_predict(pallas)
    got = port.predict(_image())
    assert len(want) > 0
    assert len(got) == len(want)
    want_kp = np.stack([w.keypoints for w in want])
    if pallas:
        want_kp = _where_reference_self_consistent(
            want_kp, np.stack([w.keypoints for w in _jax_predict(False)]))
    for g, w, kp in zip(got, want, want_kp):
        np.testing.assert_allclose(g.box, w.box, **BOX_TOL)
        assert abs(g.score - w.score) <= 1e-5
        np.testing.assert_allclose(g.keypoints, kp, **KP_TOL)


def test_batch_forward_bf16_agrees_with_jax():
    """bf16 compute, as Config.fast() runs. Activations round at the same
    points on both sides but accumulate in other orders, so selections
    among near-equal values can flip: with random weights a channel has
    many maxima of similar height, and the tail of its top-8 differs.
    The detections agree (valid exactly, boxes to 1 px: a few bf16 ulps
    of the decoded box size), and at least two thirds of the peaks the
    JAX package finds are found at the same pixel by the port (about
    three quarters were, when this was written)."""
    jax_pred, port = _predictors("bfloat16", False)
    images = planted_images(np.random.RandomState(3), 2, SIZE, SIZE)
    flat = space_to_depth_flat4(images)
    want = jax.jit(jax_pred._batch_forward_impl)(
        jax_pred.variables, jax_pred.prn_variables, jnp.asarray(flat))
    got = port.batch_forward(flat)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert np.isfinite(to_numpy(got[key])).all(), key
    np.testing.assert_array_equal(to_numpy(got["box_valid"]).astype(bool),
                                  np.asarray(want["box_valid"]))
    np.testing.assert_allclose(to_numpy(got["boxes"]),
                               np.asarray(want["boxes"]), atol=1.0)
    pos_w, pos_g = (np.asarray(want["peak_positions"]),
                    to_numpy(got["peak_positions"]))
    val_w, val_g = (np.asarray(want["peak_valid"]),
                    to_numpy(got["peak_valid"]).astype(bool))
    found = 0
    for b, k in np.ndindex(val_w.shape[:2]):
        mine = {tuple(p) for p in pos_g[b, k][val_g[b, k]]}
        found += sum(tuple(p) in mine for p in pos_w[b, k][val_w[b, k]])
    assert found >= 2 / 3 * val_w.sum() > 0


@pytest.mark.parametrize("entry", ["batch_forward", "predict"])
def test_window5_decode_matches_jax(entry):
    """A peak window of 5, which the JAX predictor decodes with its jnp
    decode (its Pallas kernel is off off the TPU): the port's plain decode
    on the CPU gives the same peaks, detections and keypoints. On a card
    the same config goes through the generic decode kernel."""
    cfg = tiny_config("float32")
    cfg = cfg.replace(decode=dataclasses.replace(cfg.decode, nms_window=5))
    variables, prn_vars = posenet_variables(cfg), prn_variables(cfg)
    jax_pred = JaxPredictor(config=cfg, variables=variables,
                            prn_variables=prn_vars, image_size=SIZE,
                            use_pallas_decode=False)
    port = Predictor(torch_config_of(cfg),
                     variables=jax.tree.map(np.asarray, variables),
                     prn_variables=jax.tree.map(np.asarray, prn_vars),
                     image_size=SIZE, device="cpu")
    if entry == "predict":
        want, got = jax_pred.predict(_image()), port.predict(_image())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.box, w.box, **BOX_TOL)
            np.testing.assert_allclose(g.keypoints, w.keypoints, **KP_TOL)
        return
    want = {k: np.asarray(v) for k, v in jax.jit(
        jax_pred._batch_forward_impl)(jax_pred.variables,
                                      jax_pred.prn_variables,
                                      jnp.asarray(_batch())).items()}
    got = port.batch_forward(_batch())
    assert want["peak_valid"].any()
    _assert_peaks(got, want)
    np.testing.assert_array_equal(to_numpy(got["box_valid"]).astype(bool),
                                  want["box_valid"])
    np.testing.assert_allclose(to_numpy(got["boxes"]), want["boxes"],
                               **BOX_TOL)
    np.testing.assert_allclose(to_numpy(got["keypoints"]), want["keypoints"],
                               **KP_TOL)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(torch_config_of(tiny_config()), image_size=SIZE)


@pytest.mark.parametrize("section,field,value", [
    ("predictor", "flip_tta", True),
    ("model", "kp_smooth_pyramid", True),
    ("model", "kp_p2_late", False),
    ("model", "kp_fuse_conv", True),
    ("model", "stem_stride", 2),
    ("model", "head_channels", 64),
    ("detector", "pose_nms_oks", 0.5),
])
def test_formerly_unported_options_match_jax(section, field, value):
    """Each option the port once refused, set alone on the tiny fast()
    config: `batch_forward` on letterboxed uint8 pixels (a layout every
    stem takes) gives the JAX package's outputs, to this file's
    tolerances."""
    cfg = tiny_config("float32")
    kwargs = {}
    if section == "predictor":
        kwargs[field] = value
    else:
        cfg = cfg.replace(**{section: dataclasses.replace(
            getattr(cfg, section), **{field: value})})
    variables, prn_vars = posenet_variables(cfg), prn_variables(cfg)
    jax_pred = JaxPredictor(config=cfg, variables=variables,
                            prn_variables=prn_vars, image_size=SIZE,
                            use_pallas_decode=False, **kwargs)
    port = Predictor(torch_config_of(cfg),
                     variables=jax.tree.map(np.asarray, variables),
                     prn_variables=jax.tree.map(np.asarray, prn_vars),
                     image_size=SIZE, device="cpu", **kwargs)
    images = planted_images(np.random.RandomState(7), 2, SIZE, SIZE)
    want = {k: np.asarray(v) for k, v in jax.jit(
        jax_pred._batch_forward_impl)(jax_pred.variables,
                                      jax_pred.prn_variables,
                                      jnp.asarray(images)).items()}
    got = port.batch_forward(images)
    assert want["box_valid"].any()
    np.testing.assert_array_equal(to_numpy(got["box_valid"]).astype(bool),
                                  want["box_valid"])
    np.testing.assert_allclose(to_numpy(got["boxes"]), want["boxes"],
                               **BOX_TOL)
    np.testing.assert_allclose(to_numpy(got["box_scores"]),
                               want["box_scores"], **SCORE_TOL)
    valid = want["peak_valid"]
    assert valid.any()
    np.testing.assert_array_equal(to_numpy(got["peak_valid"]).astype(bool),
                                  valid)
    np.testing.assert_allclose(to_numpy(got["peak_scores"]),
                               want["peak_scores"], **SCORE_TOL)
    # Positions exact, but for the sign of a quarter-pixel refinement
    # where a peak's two neighbours tie to a few ulps (2 input pixels at
    # stride 4): 1 of 396 valid slots with the fuse conv when this was
    # written, its two scores 1e-7 apart.
    off = np.abs(to_numpy(got["peak_positions"]) - want["peak_positions"])
    off = off[valid]
    assert np.isin(off, (0.0, 2.0)).all()
    assert (off.max(-1) > 0).mean() <= 0.01
    np.testing.assert_allclose(to_numpy(got["keypoints"]), want["keypoints"],
                               **KP_TOL)
