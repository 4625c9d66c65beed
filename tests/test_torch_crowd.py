"""Config.crowd() in the port against the JAX package: the IoU-aware
scoring head and its detection post-processing, and the serving pipeline
as a whole, with BN folded (`fold_bn=True`), the fused keypoint tail
(`kp_tail_pallas`) and the maps-on-lanes decode (`DECODE_LANES`).

The JAX side runs as its own tests run it on the CPU: the tail kernel and
the lanes decode in interpret mode (`kp_tail_pallas.FORCE_INTERPRET` and
`decode_pallas.DECODE_LANES` switched on while its programs are traced,
`Predictor(use_pallas_decode=True, pallas_interpret=True)`), and once more
with its jnp decode. The port runs its plain versions (CPU tensors).

Tolerances are those of test_torch_predictor.py (float32): boxes 2e-3,
scores 1e-5, peaks valid and positions exact with scores 1e-5, keypoints
1e-3; detection post-processing alone as in test_torch_detection.py
(boxes 1e-4, scores 1e-6). Where the two JAX programs disagree on a
keypoint, the port is held to the jnp-decode one (ROADMAP queue C).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.ops.detection import (
    postprocess_detections as jax_postprocess,
)
from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.infer.predictor import Predictor
from multiposenet_tpu_torch.ops.detection import postprocess_detections
from multiposenet_tpu_torch.ops.image import space_to_depth_flat4

from torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (autouse)
    MODEL_TOL,
    SIZE,
    assert_model_close,
    crowd_predictors,
    jax_apply,
    jax_kernels_interpreted,
    planted_images,
    port_lanes,
    port_model,
    posenet_variables,
    tiny_crowd_config,
    to_numpy,
    torch_config_of,
)

BOX_TOL = dict(atol=2e-3, rtol=1e-5)
SCORE_TOL = dict(atol=1e-5, rtol=1e-5)
KP_TOL = dict(atol=1e-3, rtol=1e-5)


def _batch(seed=0):
    return space_to_depth_flat4(
        planted_images(np.random.RandomState(seed), 2, SIZE, SIZE))


def image():
    return planted_images(np.random.RandomState(2), 1, 96, 150)[0]


@functools.lru_cache(maxsize=None)
def _jax_batch_forward(pallas):
    jax_pred, _ = crowd_predictors("float32", pallas)
    with jax_kernels_interpreted():
        out = jax.jit(jax_pred._batch_forward_impl)(
            jax_pred.variables, jax_pred.prn_variables, jnp.asarray(_batch()))
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _jax_predict(pallas):
    jax_pred, _ = crowd_predictors("float32", pallas)
    with jax_kernels_interpreted():
        return jax_pred.predict(image())


def where_reference_self_consistent(want_kp, jnp_kp):
    """Where the JAX whole program with the interpret-mode decode kernel
    disagrees with its jnp-decode program (ROADMAP queue C), hold the port
    to the latter."""
    differ = np.abs(jnp_kp - want_kp).max(-1) > KP_TOL["atol"]
    assert differ.mean() < 0.05
    return np.where(differ[..., None], jnp_kp, want_kp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_iou_head_matches_jax(dtype):
    cfg = tiny_crowd_config(dtype, tail=False)
    variables = posenet_variables(cfg)
    x = np.random.RandomState(31).randint(0, 256, (2, 128, 128, 3)).astype(
        np.float32)
    out_j = jax_apply(cfg)(variables, jnp.asarray(x))
    with torch.no_grad():
        out_t = port_model(cfg, variables)(torch.as_tensor(x))
    assert set(out_t["detector"]) == set(out_j["detector"])
    for level, pair in out_j["detector"].items():
        assert set(out_t["detector"][level]) == {"cls", "box", "iou"}
        for kind in ("cls", "box", "iou"):
            assert_model_close(out_t["detector"][level][kind], pair[kind],
                               MODEL_TOL[dtype], f"{level}.{kind}")


@pytest.mark.parametrize("threshold", [0.0, 0.2, 0.4])
def test_iou_scoring_postprocess_matches_jax(threshold):
    """Ranked by log σ(cls) + p·log σ(iou), scored by its exp, the
    threshold cutting that combined score; then crowd's soft-NMS with
    box voting. Logits of spread 0.5 put the combined scores around 0.125
    and under 0.5, so the thresholds cut none of the pool, most of it, and
    all but a few candidates, leaving output slots invalid."""
    cfg = tiny_crowd_config()
    d = dataclasses.replace(cfg.detector, score_threshold=threshold,
                            approx_top_k=False)
    rng = np.random.RandomState(int(threshold * 100))
    out = {}
    for level in range(d.min_level, d.max_level + 1):
        n = SIZE // 2 ** level
        out[f"P{level}"] = {
            "cls": rng.randn(2, n, n, 9).astype(np.float32) * 0.5,
            "box": rng.randn(2, n, n, 36).astype(np.float32) * 0.2,
            "iou": rng.randn(2, n, n, 9).astype(np.float32) * 0.5,
        }
    want = jax_postprocess(jax.tree.map(jnp.asarray, out), SIZE, d)
    got = postprocess_detections(
        jax.tree.map(torch.as_tensor, out), SIZE,
        torch_config_of(cfg.replace(detector=d)).detector)
    valid = np.asarray(want.valid)
    assert valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=1e-4,
                               rtol=1e-5)
    if threshold == 0.4:
        assert not valid.all()


@pytest.mark.parametrize("pallas", [False, True],
                         ids=["jnp_decode", "pallas_interpret"])
def test_crowd_batch_forward_matches_jax(pallas):
    _, port = crowd_predictors("float32", pallas)
    assert port.config.model.bn_folded
    want = _jax_batch_forward(pallas)
    kernels.reset_launches()
    with port_lanes():
        got = port.batch_forward(_batch())
    assert kernels.LAUNCHES == {}  # CPU tensors: the plain versions

    valid = want["box_valid"]
    assert valid.any() and got["boxes"].shape[1] == 12
    np.testing.assert_array_equal(to_numpy(got["box_valid"]).astype(bool),
                                  valid)
    np.testing.assert_allclose(to_numpy(got["boxes"]), want["boxes"],
                               **BOX_TOL)
    np.testing.assert_allclose(to_numpy(got["box_scores"]),
                               want["box_scores"], **SCORE_TOL)
    peak_valid = want["peak_valid"]
    assert peak_valid.any()
    np.testing.assert_array_equal(to_numpy(got["peak_valid"]).astype(bool),
                                  peak_valid)
    np.testing.assert_allclose(to_numpy(got["peak_scores"]),
                               want["peak_scores"], **SCORE_TOL)
    np.testing.assert_array_equal(
        to_numpy(got["peak_positions"])[peak_valid],
        want["peak_positions"][peak_valid])
    want_kp = want["keypoints"]
    if pallas:
        want_kp = where_reference_self_consistent(
            want_kp, _jax_batch_forward(False)["keypoints"])
    np.testing.assert_allclose(to_numpy(got["keypoints"]), want_kp, **KP_TOL)


@pytest.mark.parametrize("pallas", [False, True],
                         ids=["jnp_decode", "pallas_interpret"])
def test_crowd_predict_matches_jax(pallas):
    _, port = crowd_predictors("float32", pallas)
    want = _jax_predict(pallas)
    with port_lanes():
        got = port.predict(image())
    assert len(want) > 0
    assert len(got) == len(want)
    want_kp = np.stack([w.keypoints for w in want])
    if pallas:
        want_kp = where_reference_self_consistent(
            want_kp, np.stack([w.keypoints for w in _jax_predict(False)]))
    for g, w, kp in zip(got, want, want_kp):
        np.testing.assert_allclose(g.box, w.box, **BOX_TOL)
        assert abs(g.score - w.score) <= 1e-5
        np.testing.assert_allclose(g.keypoints, kp, **KP_TOL)


def test_crowd_batch_forward_bf16_agrees_with_jax():
    """bf16 compute, as Config.crowd() serves. As in
    test_torch_predictor.py's bf16 test, the sums run in other orders, so
    selections among near-equal values can flip. With random weights the
    combined scores of the candidates lie close together, and a flipped
    soft-NMS pick changes the later decays and votes: the valid slots
    agree exactly, the slot scores to 0.02 (0.011 observed), at least half
    of the JAX package's boxes are found within 1 px among the port's
    boxes of the same image (19 of 24 observed), and at least two thirds
    of its peaks at the same pixel (177 of 233 observed)."""
    jax_pred, port = crowd_predictors("bfloat16", True)
    flat = _batch(seed=3)
    with jax_kernels_interpreted():
        want = jax.jit(jax_pred._batch_forward_impl)(
            jax_pred.variables, jax_pred.prn_variables, jnp.asarray(flat))
    with port_lanes():
        got = port.batch_forward(flat)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert np.isfinite(to_numpy(got[key])).all(), key
    np.testing.assert_array_equal(to_numpy(got["box_valid"]).astype(bool),
                                  np.asarray(want["box_valid"]))
    np.testing.assert_allclose(to_numpy(got["box_scores"]),
                               np.asarray(want["box_scores"]), atol=0.02)
    box_w, box_g = np.asarray(want["boxes"]), to_numpy(got["boxes"])
    box_val = np.asarray(want["box_valid"])
    near = [np.abs(box_w[b][box_val[b], None] - box_g[b][None]).max(-1)
            .min(-1) <= 1.0 for b in range(box_w.shape[0])]
    assert np.concatenate(near).mean() >= 0.5
    pos_w, pos_g = (np.asarray(want["peak_positions"]),
                    to_numpy(got["peak_positions"]))
    val_w, val_g = (np.asarray(want["peak_valid"]),
                    to_numpy(got["peak_valid"]).astype(bool))
    found = 0
    for b, k in np.ndindex(val_w.shape[:2]):
        mine = {tuple(p) for p in pos_g[b, k][val_g[b, k]]}
        found += sum(tuple(p) in mine for p in pos_w[b, k][val_w[b, k]])
    assert found >= 2 / 3 * val_w.sum() > 0


def test_fold_bn_of_the_seeded_init():
    """Without a flax tree the predictor folds its own seeded init in
    place: the config says bn_folded, no BN is left, and the pipeline
    gives what the unfolded predictor on the same seed gives."""
    cfg = torch_config_of(tiny_crowd_config())
    folded = Predictor(cfg, image_size=SIZE, device="cpu", fold_bn=True)
    plain = Predictor(cfg, image_size=SIZE, device="cpu")
    assert folded.config.model.bn_folded and not cfg.model.bn_folded
    assert not any(".bn." in n for n in folded.model.state_dict())
    a, b = folded.batch_forward(_batch(4)), plain.batch_forward(_batch(4))
    np.testing.assert_array_equal(a["box_valid"].numpy(),
                                  b["box_valid"].numpy())
    for key in ("boxes", "box_scores", "keypoints", "peak_scores"):
        np.testing.assert_allclose(to_numpy(a[key]), to_numpy(b[key]),
                                   atol=2e-3, rtol=1e-4, err_msg=key)


def test_crowd_options_construct():
    """The crowd path's switches no longer raise."""
    cfg = Config.crowd()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, kp_tail_pallas=True, bn_folded=True))
    assert cfg.detector.iou_head
    Predictor(cfg.replace(model=dataclasses.replace(
        cfg.model, backbone_width=0.25, backbone_max_channels=64,
        backbone_stage_caps=(16, 32, 0, 0))), image_size=64, device="cpu",
        fold_bn=True)
