"""The port's keypoint-only and given-box entry points
(`Predictor.predict_heatmaps`, `predict_keypoints`, `predict_given_boxes`)
against the JAX `Predictor`'s, on the crowd path (BN folded, the fused
keypoint tail, the maps-on-lanes decode), with the same weights and the
same uint8 image.

The JAX side runs its tail and decode kernels in interpret mode, as
test_torch_crowd.py does. Its `predict_heatmaps` and `predict_keypoints`
read the NHWC heatmaps of the head's plain conv, which XLA keeps beside
the tail's channel-major ones; the port's come from the tail. In float32
the two differ by a few ulps (heatmaps 3e-5 + 1e-5 relative, as in
test_torch_models.py), the decoded peaks keep the decode contract (valid
exact, positions exact on valid slots, scores 1e-5), and keypoints from
given boxes get the pipeline's 1e-3; where the JAX program with the
interpret-mode decode disagrees with its jnp-decode program on a keypoint,
the port is held to the latter (ROADMAP queue C).
"""

import functools

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (autouse)
    crowd_predictors,
    jax_kernels_interpreted,
    planted_images,
    port_lanes,
)

SCORE_TOL = dict(atol=1e-5, rtol=1e-5)
KP_TOL = dict(atol=1e-3, rtol=1e-5)


def _image():
    """A wide image: its letterbox leaves the lower 40% of the model
    input as zero padding."""
    return planted_images(np.random.RandomState(5), 1, 75, 128)[0]


def _boxes():
    """19 person boxes, more than the 8 PRN slots of the tiny config."""
    rng = np.random.RandomState(6)
    y0, x0 = rng.uniform(0, 50, 19), rng.uniform(0, 100, 19)
    h, w = rng.uniform(10, 40, 19), rng.uniform(8, 30, 19)
    return np.stack([y0, x0, y0 + h, x0 + w], -1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax(pallas, entry):
    jax_pred, _ = crowd_predictors("float32", pallas)
    with jax_kernels_interpreted():
        if entry == "heatmaps":
            return jax_pred.predict_heatmaps(_image())
        if entry == "keypoints":
            return jax_pred.predict_keypoints(_image())
        return jax_pred.predict_given_boxes(_image(), _boxes())


def _port():
    return crowd_predictors("float32", True)[1]


def test_predict_heatmaps_matches_jax():
    with port_lanes():
        got = _port().predict_heatmaps(_image())
    want = np.asarray(_jax(True, "heatmaps"))
    assert got.shape == want.shape == (32, 32, 17)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-5)


def test_predict_heatmaps_bf16_agrees_with_jax():
    """bf16 compute: the JAX heatmaps come from the plain conv rounded to
    bf16 before the bf16 bias is added, the port's from the tail's one
    rounding after the float32 bias, on activations that round at the same
    points but sum in other orders. Elements keep test_torch_models.py's
    bf16 bound (0.04 + 2%); the two roundings against one put the mean
    error near one bf16 ulp at the maps' mean magnitude (1.02 ulp when
    this was written), so the mean is held under two."""
    jax_pred, port = crowd_predictors("bfloat16", True)
    with jax_kernels_interpreted():
        want = np.asarray(jax_pred.predict_heatmaps(_image()), np.float32)
    got = port.predict_heatmaps(_image())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.04, rtol=0.02)
    ulp = 2.0 ** -7 * np.abs(want).mean()
    assert np.abs(got - want).mean() < 2 * ulp


@pytest.mark.parametrize("pallas", [False, True],
                         ids=["jnp_decode", "pallas_interpret"])
def test_predict_keypoints_matches_jax(pallas):
    with port_lanes():
        positions, scores, valid = _port().predict_keypoints(_image())
    w_pos, w_scores, w_valid = (np.asarray(t) for t in _jax(pallas,
                                                            "keypoints"))
    assert positions.shape == w_pos.shape == (17, 8, 2)
    assert w_valid.any()
    np.testing.assert_array_equal(valid, w_valid)
    np.testing.assert_allclose(scores, w_scores, **SCORE_TOL)
    np.testing.assert_array_equal(positions[valid], w_pos[valid])


def test_predict_keypoints_invalidates_the_padding():
    """Peaks the decode finds in the letterbox padding, below the image's
    75 rows, come back invalid."""
    port = _port()
    h = _image().shape[0]
    positions, scores, valid = port.predict_keypoints(_image())
    assert valid.any()
    assert (positions[valid][:, 0] <= h - 1).all()
    # The decode did find valid peaks there, which the entry point drops.
    with torch.no_grad():
        x, scale = port._letterbox(_image())
        peaks = port._decode(port.model(x)["heatmaps"])
    rows = peaks.positions[0, ..., 0].numpy() * 4 / scale
    below = (rows > h - 1) & peaks.valid[0].numpy()
    assert below.any() and not (valid & below).any()


@pytest.mark.parametrize("pallas", [False, True],
                         ids=["jnp_decode", "pallas_interpret"])
def test_predict_given_boxes_matches_jax(pallas):
    with port_lanes():
        got = _port().predict_given_boxes(_image(), _boxes())
    want = np.asarray(_jax(pallas, "given_boxes"))
    assert got.shape == want.shape == (19, 17, 3)
    if pallas:
        jnp_kp = np.asarray(_jax(False, "given_boxes"))
        differ = np.abs(jnp_kp - want).max(-1) > KP_TOL["atol"]
        assert differ.mean() < 0.05
        want = np.where(differ[..., None], jnp_kp, want)
    np.testing.assert_allclose(got, want, **KP_TOL)


def test_predict_given_boxes_chunks_without_truncating():
    """19 boxes run as chunks of 8 PRN slots: every box gets keypoints,
    each the same as when its box is given in a chunk of its own."""
    port = _port()
    boxes = _boxes()
    got = port.predict_given_boxes(_image(), boxes)
    assert got.shape == (19, 17, 3)
    for s in (0, 8, 16):
        alone = port.predict_given_boxes(_image(), boxes[s:s + 3])
        np.testing.assert_array_equal(got[s:s + 3], alone)
    none = port.predict_given_boxes(_image(), np.zeros((0, 4)))
    assert none.shape == (0, 17, 3)


@pytest.mark.parametrize("entry", ["predict_heatmaps", "predict_keypoints",
                                   "predict_given_boxes"])
def test_entry_points_refuse_non_rgb(entry):
    port = _port()
    args = (np.zeros((4, 4), np.uint8),)
    if entry == "predict_given_boxes":
        args += (np.zeros((1, 4)),)
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        getattr(port, entry)(*args)
