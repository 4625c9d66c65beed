"""The port's pose-level OKS NMS (`multiposenet_tpu_torch.ops.pose_nms`)
against the JAX package's `ops/pose_nms.py` on the same numpy inputs:
the kept masks must be equal, element for element.

The inputs plant duplicate skeletons (a detection's keypoints copied
into later slots with a jitter of a few pixels, so their OKS against it
lies far above any threshold here) among random ones, whose OKS against
each other lies near zero: no pair sits at a threshold within float
rounding, so the masks are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.ops.pose_nms import pose_nms as jax_pose_nms
from multiposenet_tpu_torch.ops.pose_nms import pose_nms


def _scene(seed, b=3, d=12, k=17):
    """keypoints [B, D, K, 3], boxes [B, D, 4] and valid [B, D]; slots 3,
    5 and 9 duplicate slots 0, 2 and 4 (a few px of jitter), and slot 7
    duplicates slot 3 (itself a duplicate, so it dies only through slot
    0 when slot 3 is suppressed first)."""
    rng = np.random.RandomState(seed)
    y0, x0 = rng.uniform(0, 300, (b, d)), rng.uniform(0, 300, (b, d))
    h, w = rng.uniform(60, 160, (b, d)), rng.uniform(40, 120, (b, d))
    boxes = np.stack([y0, x0, y0 + h, x0 + w], -1).astype(np.float32)
    kx = x0[..., None] + rng.uniform(0, 1, (b, d, k)) * w[..., None]
    ky = y0[..., None] + rng.uniform(0, 1, (b, d, k)) * h[..., None]
    kp = np.stack([kx, ky, rng.uniform(0, 1, (b, d, k))], -1)
    for dup, src in ((3, 0), (5, 2), (9, 4), (7, 3)):
        kp[:, dup, :, :2] = kp[:, src, :, :2] + rng.uniform(-2, 2,
                                                            (b, k, 2))
        boxes[:, dup] = boxes[:, src] + rng.uniform(-2, 2, (b, 4))
    valid = rng.uniform(size=(b, d)) > 0.15
    valid[:, :6] = True
    return kp.astype(np.float32), boxes, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.9])
def test_pose_nms_masks_match_jax(seed, threshold):
    kp, boxes, valid = _scene(seed)
    want = np.asarray(jax_pose_nms(jnp.asarray(kp), jnp.asarray(boxes),
                                   jnp.asarray(valid), threshold))
    got = pose_nms(torch.as_tensor(kp), torch.as_tensor(boxes),
                   torch.as_tensor(valid), threshold)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # The planted duplicates of live keepers are gone; no slot revives.
    assert not got[:, [3, 5]].any()
    assert not (got.numpy() & ~valid).any()


def test_pose_nms_keeps_distinct_poses_and_invalid_keepers_kill_nothing():
    """Without duplicates nothing is dropped; a duplicate whose keeper is
    invalid survives, as in the JAX package."""
    kp, boxes, valid = _scene(3)
    valid[:] = True
    valid[:, 0] = False   # slot 3 duplicates the invalid slot 0
    want = np.asarray(jax_pose_nms(jnp.asarray(kp), jnp.asarray(boxes),
                                   jnp.asarray(valid), 0.5))
    got = pose_nms(torch.as_tensor(kp), torch.as_tensor(boxes),
                   torch.as_tensor(valid), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, 3].all() and not got[:, 7].any()
    distinct = [i for i in range(12) if i not in (0, 3, 5, 7, 9)]
    assert got[:, distinct].all()
