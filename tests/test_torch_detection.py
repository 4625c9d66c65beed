"""The port's anchors, box coding, NMS and detection post-processing
against the JAX package, on the same numpy inputs.

All of it is f32 elementwise arithmetic in the same order on both sides,
so boxes get 1e-4 absolute (pixel coordinates up to 512, a few f32 ulps)
and scores 1e-6; selections (indices, `valid`) are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.config import Config as JaxConfig
from multiposenet_tpu.ops import anchors as jax_anchors
from multiposenet_tpu.ops import boxes as jax_boxes
from multiposenet_tpu.ops import detection as jax_detection
from multiposenet_tpu.ops import nms as jax_nms
from multiposenet_tpu_torch.ops import anchors, boxes, detection, nms

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import tiny_config, torch_config_of

BOX_TOL = dict(atol=1e-4, rtol=1e-6)
SCORE_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("image_size", [128, 512])
def test_anchors_match(image_size):
    cfg = JaxConfig.fast()
    want = jax_anchors.all_anchors(image_size, cfg.detector)
    got = anchors.all_anchors(image_size, torch_config_of(cfg).detector)
    np.testing.assert_array_equal(got, want)


def _random_boxes(rng, n, size=128.0):
    yx = rng.uniform(0, size * 0.8, (n, 2))
    hw = rng.uniform(2.0, size * 0.4, (n, 2))
    return np.concatenate([yx, yx + hw], -1).astype(np.float32)


def test_box_decode_and_clip_match():
    rng = np.random.RandomState(0)
    anc = _random_boxes(rng, 64)
    deltas = rng.randn(64, 4).astype(np.float32)
    deltas[:4, 2:] = 9.0  # past BBOX_XFORM_CLIP
    want = jax_boxes.clip_to_image(
        jax_boxes.decode(jnp.asarray(deltas), jnp.asarray(anc)), 100.0, 90.0)
    got = boxes.clip_to_image(
        boxes.decode(torch.as_tensor(deltas), torch.as_tensor(anc)),
        100.0, 90.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BOX_TOL)


def _detector_outputs(rng, image_size, levels=range(3, 8), a=9):
    out = {}
    for level in levels:
        s = -(-image_size // 2 ** level)
        out[f"P{level}"] = {
            "cls": rng.randn(2, s, s, a).astype(np.float32) * 2 - 3,
            "box": rng.randn(2, s, s, 4 * a).astype(np.float32) * 0.5,
        }
    return out


def _as_torch_nchw_views(out):
    """The port's head hands over NHWC views of NCHW conv outputs; build
    the same strides here so the flatten order is tested on them."""
    return {
        lvl: {k: torch.as_tensor(v).permute(0, 3, 1, 2).contiguous()
              .permute(0, 2, 3, 1) for k, v in d.items()}
        for lvl, d in out.items()
    }


def test_flatten_outputs_order_on_nchw_strides():
    rng = np.random.RandomState(1)
    out = _detector_outputs(rng, 128)
    t_out = _as_torch_nchw_views(out)
    assert not t_out["P3"]["cls"].is_contiguous()
    want = jax_detection.flatten_outputs(
        jax.tree.map(jnp.asarray, out), 3, 7)
    got = detection.flatten_outputs(t_out, 3, 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_top_k_breaks_ties_by_index_like_lax():
    x = np.array([[3, 1, 3, 2, 3, 2, 0, 1]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 6)
    got_v, got_i = detection.top_k(torch.as_tensor(x), 6)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def _clustered(rng, b, n):
    """Boxes in a few overlapping clusters with random scores, plus some
    zero scores (below the detector's threshold)."""
    centers = _random_boxes(rng, 4)
    pick = rng.randint(0, 4, (b, n))
    jitter = rng.randn(b, n, 4).astype(np.float32) * 4.0
    bx = (centers[pick] + jitter).astype(np.float32)
    sc = rng.uniform(0.0, 1.0, (b, n)).astype(np.float32)
    sc[:, -5:] = 0.0
    return bx, sc


@pytest.mark.parametrize("mode", ["hard", "soft", "vote", "soft_vote"])
@pytest.mark.parametrize("max_out", [5, 40])
def test_batched_nms_matches_jax(mode, max_out):
    rng = np.random.RandomState(2)
    bx, sc = _clustered(rng, 3, 30)
    kw = {"hard": {}, "soft": dict(soft_sigma=0.5),
          "vote": dict(vote_iou=0.75),
          "soft_vote": dict(soft_sigma=0.5, vote_iou=0.75)}[mode]
    want = jax_nms.batched_nms(jnp.asarray(bx), jnp.asarray(sc), max_out,
                               0.5, **kw)
    got = nms.batched_nms(torch.as_tensor(bx), torch.as_tensor(sc), max_out,
                          0.5, **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **BOX_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **SCORE_TOL)


@pytest.mark.parametrize("score_threshold", [0.0, 0.05])
@pytest.mark.parametrize("image_size", [128, 96])
def test_postprocess_detections_matches_jax(score_threshold, image_size):
    """Anchor decode, pre-NMS pool, greedy NMS, under the fast() detector
    settings (the JAX side's `approx_max_k` is exact on the CPU)."""
    cfg = tiny_config()
    cfg = cfg.replace(detector=dataclasses.replace(
        cfg.detector, score_threshold=score_threshold))
    assert cfg.detector.approx_top_k
    rng = np.random.RandomState(image_size)
    out = _detector_outputs(rng, image_size)
    want = jax_detection.postprocess_detections(
        jax.tree.map(jnp.asarray, out), image_size, cfg.detector)
    got = detection.postprocess_detections(
        _as_torch_nchw_views(out), image_size, torch_config_of(cfg).detector)
    v = np.asarray(want.valid)
    assert v.any()
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **SCORE_TOL)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               **BOX_TOL)

