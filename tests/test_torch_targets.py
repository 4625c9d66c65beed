"""The port's on-device training targets (`multiposenet_tpu_torch/data/
targets.py`) against the JAX package's (`multiposenet_tpu/data/
targets.py`) on the same seeded inputs, mirroring tests/test_targets.py's
cases: heatmaps to 1e-6, masks, segmentation and anchor classes exactly,
box targets to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.config import Config as JaxConfig
from multiposenet_tpu.data import targets as jt
from multiposenet_tpu.ops.anchors import all_anchors
from multiposenet_tpu_torch.data import targets as tt

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _boxes(rng, shape, limit):
    """Valid (y0, x0, y1, x1) boxes of the given leading shape."""
    a = rng.uniform(0, limit, shape + (2, 2)).astype(np.float32)
    a.sort(axis=-2)
    return np.ascontiguousarray(a.transpose(*range(len(shape)), -1, -2)
                                .reshape(shape + (4,)))


def _keypoints(rng, b, p, limit):
    kps = rng.uniform(-4, limit + 4, (b, p, 17, 3)).astype(np.float32)
    kps[..., 2] = rng.randint(0, 3, (b, p, 17))
    return kps


def test_keypoint_heatmaps_peak_location_and_max_combine():
    kps = np.zeros((2, 17, 3), np.float32)
    kps[0, 0] = [40.0, 24.0, 2.0]
    kps[1, 0] = [80.0, 24.0, 1.0]
    kps[0, 1] = [20.0, 20.0, 0.0]
    want = np.asarray(jt.keypoint_heatmaps(jnp.asarray(kps), 32, 32, 4, 1.5))
    got = tt.keypoint_heatmaps(_t(kps), 32, 32, 4, 1.5).numpy()
    assert got.shape == (32, 32, 17)
    assert got[6, 10, 0] > 0.99 and got[6, 20, 0] > 0.99
    assert got[:, :, 1].max() == 0.0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("size", [(16, 16, 4), (32, 24, 4), (20, 20, 8)])
def test_batched_keypoint_heatmaps_match_jax(seed, size):
    h, w, stride = size
    rng = np.random.RandomState(seed)
    kps = _keypoints(rng, 3, 5, max(h, w) * stride)
    want = np.asarray(jt.batched_keypoint_heatmaps(jnp.asarray(kps), h, w,
                                                   stride))
    got = tt.batched_keypoint_heatmaps(_t(kps), h, w, stride).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", range(3))
def test_box_region_mask_loss_mask_and_segmentation_match_jax(seed):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, (3, 6), 64)
    flags = rng.rand(3, 6) < 0.5
    for j_fn, t_fn in ((jt.box_region_mask, tt.box_region_mask),
                       (jt.loss_mask, tt.loss_mask),
                       (jt.segmentation_target, tt.segmentation_target)):
        want = np.asarray(jax.vmap(lambda b, f: j_fn(b, f, 16, 16, 4))(
            jnp.asarray(boxes), jnp.asarray(flags)))
        got = t_fn(_t(boxes), _t(flags), 16, 16, 4).numpy()
        np.testing.assert_array_equal(got, want)
        one = t_fn(_t(boxes[0]), _t(flags[0]), 16, 16, 4).numpy()
        np.testing.assert_array_equal(one, want[0])


def test_loss_mask_zeroes_crowd():
    boxes = np.array([[8.0, 8.0, 24.0, 24.0], [0.0, 0.0, 0.0, 0.0]],
                     np.float32)
    flags = np.array([True, False])
    mask = tt.loss_mask(_t(boxes), _t(flags), 16, 16, 4).numpy()
    assert mask.shape == (16, 16, 1)
    assert mask[3, 3, 0] == 0.0 and mask[0, 0, 0] == 1.0
    np.testing.assert_array_equal(mask, np.asarray(jt.loss_mask(
        jnp.asarray(boxes), jnp.asarray(flags), 16, 16, 4)))


def _assert_labels_match(anchors, gt, valid):
    want = jt.label_anchors(jnp.asarray(anchors), jnp.asarray(gt),
                            jnp.asarray(valid))
    got = tt.label_anchors(_t(anchors), _t(gt), _t(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    return got


def test_label_anchors_pos_neg_ignore_and_force_match():
    anchors = np.array([[0, 0, 10, 10], [0, 5, 10, 15], [0, 2, 10, 12],
                        [100, 100, 110, 110]], np.float32)
    gt = np.array([[0, 0, 10, 10], [102, 102, 111, 111], [0, 0, 0, 0]],
                  np.float32)
    cls, _, _ = _assert_labels_match(anchors, gt,
                                     np.array([True, True, False]))
    assert cls.tolist() == [1.0, 0.0, 1.0, 1.0]


def test_label_anchors_all_invalid_gt():
    cls, _, _ = _assert_labels_match(np.array([[0, 0, 10, 10]], np.float32),
                                     np.zeros((2, 4), np.float32),
                                     np.array([False, False]))
    assert cls.tolist() == [0.0]


def test_label_anchors_invalid_gt_cannot_clobber_anchor_zero():
    anchors = np.array([[0, 0, 10, 10], [100, 100, 110, 110]], np.float32)
    gt = np.concatenate([np.array([[0, 2, 10, 13]], np.float32),
                         np.zeros((6, 4), np.float32)])
    cls, _, _ = _assert_labels_match(anchors, gt,
                                     np.array([True] + [False] * 6))
    assert cls[0] == 1.0


def test_label_anchors_ties_take_the_first_index():
    """Two GTs equally good for every anchor: jnp.argmax's first index
    wins the match; both force the same best anchor, the last GT wins its
    regression target."""
    anchors = np.array([[0, 0, 10, 10], [0, 0, 10, 10], [50, 50, 60, 60]],
                       np.float32)
    gt = np.array([[0, 0, 10, 10], [0, 0, 10, 10]], np.float32)
    _assert_labels_match(anchors, gt, np.array([True, True]))


@pytest.mark.parametrize("seed", range(4))
def test_batched_label_anchors_match_jax(seed):
    rng = np.random.RandomState(seed)
    anchors = np.asarray(all_anchors(128, JaxConfig().detector), np.float32)
    gt = _boxes(rng, (3, 8), 128)
    valid = rng.rand(3, 8) < 0.6
    valid[0] = False  # an image with no person
    want = jt.batched_label_anchors(jnp.asarray(anchors), jnp.asarray(gt),
                                    jnp.asarray(valid))
    got = tt.batched_label_anchors(_t(anchors), _t(gt), _t(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-7, rtol=0)
