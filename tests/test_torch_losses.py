"""The port's training losses (`multiposenet_tpu_torch/train/losses.py`)
against the JAX package's (`multiposenet_tpu/train/losses.py`), on seeded
inputs with masked, ignored and positive-free cases and degenerate boxes:
gradients (autograd against `jax.grad`) to 1e-5 relative, values to 1e-6
relative against the port's own float64 evaluation and to 4e-6 against
the JAX package's float32 (sums of a few thousand float32 terms taken in
another order differ by that much)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multiposenet_tpu.train import losses as jl
from multiposenet_tpu_torch.train import losses as tl

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _value_and_grads(j_fn, t_fn, args, wrt):
    """Loss values and gradients w.r.t. the arguments at `wrt`, both
    packages."""
    want = float(j_fn(*[jnp.asarray(a) for a in args]))
    jgrads = jax.grad(lambda *x: j_fn(*x), argnums=tuple(wrt))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=i in wrt) for i, a in
             enumerate(args)]
    loss = t_fn(*targs)
    tgrads = torch.autograd.grad(loss, [targs[i] for i in wrt],
                                 allow_unused=True)
    tgrads = [torch.zeros_like(targs[i]) if g is None else g
              for i, g in zip(wrt, tgrads)]
    return float(loss.detach()), want, [g.numpy() for g in tgrads], [
        np.asarray(g) for g in jgrads]


def _check(j_fn, t_fn, args, wrt):
    got, want, tg, jg = _value_and_grads(j_fn, t_fn, args, wrt)
    exact = float(t_fn(*[torch.tensor(a, dtype=torch.float64)
                         for a in args]))
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, want, rtol=4e-6, atol=1e-7)
    for a, b in zip(tg, jg):
        scale = max(np.abs(b).max(), 1e-12)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale)


def _cls_target(rng, shape, pos=0.05, ign=0.1):
    u = rng.rand(*shape)
    return np.where(u < pos, 1.0, np.where(u < pos + ign, -1.0, 0.0)
                    ).astype(np.float32)


def _boxes(rng, shape):
    a = rng.uniform(0, 100, shape + (2, 2)).astype(np.float32)
    a.sort(axis=-2)
    return np.ascontiguousarray(np.swapaxes(a, -1, -2).reshape(shape + (4,)))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("masked", [False, True])
def test_masked_heatmap_mse(seed, masked):
    rng = np.random.RandomState(seed)
    pred = rng.randn(2, 8, 8, 17).astype(np.float32)
    target = rng.rand(2, 8, 8, 17).astype(np.float32)
    mask = (rng.rand(2, 8, 8, 1) < 0.7 if masked
            else np.ones((2, 8, 8, 1))).astype(np.float32)
    _check(jl.masked_heatmap_mse, tl.masked_heatmap_mse,
           [pred, target, mask], [0])


def test_masked_heatmap_mse_all_masked():
    rng = np.random.RandomState(0)
    args = [rng.randn(1, 4, 4, 17).astype(np.float32),
            rng.rand(1, 4, 4, 17).astype(np.float32),
            np.zeros((1, 4, 4, 1), np.float32)]
    _check(jl.masked_heatmap_mse, tl.masked_heatmap_mse, args, [0])


@pytest.mark.parametrize("seed", range(3))
def test_segmentation_bce(seed):
    rng = np.random.RandomState(seed)
    logits = (4 * rng.randn(2, 8, 8, 1)).astype(np.float32)
    target = (rng.rand(2, 8, 8, 1) < 0.3).astype(np.float32)
    mask = (rng.rand(2, 8, 8, 1) < 0.8).astype(np.float32)
    _check(jl.segmentation_bce, tl.segmentation_bce,
           [logits, target, mask], [0])


def test_sigmoid_bce_matches_optax_far_out():
    x = np.array([-60.0, -20.0, -1.0, 0.0, 1.0, 20.0, 60.0], np.float32)
    for y in (0.0, 0.3, 1.0):
        labels = np.full_like(x, y)
        want = np.asarray(optax.sigmoid_binary_cross_entropy(
            jnp.asarray(x), jnp.asarray(labels)))
        got = tl.sigmoid_binary_cross_entropy(torch.tensor(x),
                                              torch.tensor(labels)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("delta", [0.1, 1.0])
def test_huber_matches_optax(delta):
    rng = np.random.RandomState(1)
    p, t = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    want = np.asarray(optax.losses.huber_loss(jnp.asarray(p), jnp.asarray(t),
                                              delta=delta))
    got = tl.huber_loss(torch.tensor(p), torch.tensor(t), delta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("positives", [True, False])
def test_focal_loss(seed, positives):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(2, 300)).astype(np.float32)
    cls = _cls_target(rng, (2, 300), pos=0.05 if positives else 0.0)
    _check(jl.focal_loss, tl.focal_loss, [logits, cls], [0])


@pytest.mark.parametrize("seed", range(3))
def test_elementwise_giou(seed):
    rng = np.random.RandomState(seed)
    a, b = _boxes(rng, (50,)), _boxes(rng, (50,))
    a[:5] = b[:5]          # identical boxes
    a[5:8, 2:] = a[5:8, :2]  # empty boxes
    _check(lambda x, y: jl._elementwise_giou(x, y).sum(),
           lambda x, y: tl._elementwise_giou(x, y).sum(), [a, b], [0, 1])


@pytest.mark.parametrize("seed", range(3))
def test_box_giou_loss(seed):
    rng = np.random.RandomState(seed)
    pred, tgt = _boxes(rng, (2, 200)), _boxes(rng, (2, 200))
    cls = _cls_target(rng, (2, 200), pos=0.2)
    _check(jl.box_giou_loss, tl.box_giou_loss, [pred, tgt, cls], [0])


@pytest.mark.parametrize("seed", range(3))
def test_iou_pred_loss(seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(2, 200).astype(np.float32)
    pred, tgt = _boxes(rng, (2, 200)), _boxes(rng, (2, 200))
    cls = _cls_target(rng, (2, 200), pos=0.2)
    # The IoU target is detached: no gradient to the boxes in either.
    _check(jl.iou_pred_loss, tl.iou_pred_loss, [logits, pred, tgt, cls],
           [0, 1])


@pytest.mark.parametrize("seed", range(3))
def test_box_huber_loss(seed):
    rng = np.random.RandomState(seed)
    pred = (0.3 * rng.randn(2, 200, 4)).astype(np.float32)
    tgt = (0.3 * rng.randn(2, 200, 4)).astype(np.float32)
    cls = _cls_target(rng, (2, 200), pos=0.1)
    _check(jl.box_huber_loss, tl.box_huber_loss, [pred, tgt, cls], [0])


def test_box_losses_without_positives_are_zero():
    rng = np.random.RandomState(0)
    cls = np.zeros((1, 50), np.float32)
    b = _boxes(rng, (1, 50))
    for fn, args in ((tl.box_giou_loss, (b, b, cls)),
                     (tl.box_huber_loss, (b, b, cls))):
        assert float(fn(*[torch.tensor(a) for a in args])) == 0.0
