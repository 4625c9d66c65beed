"""The port's image preprocessing against the JAX package's compiled
functions (`jax.jit`, as its programs run them), on the same uint8
inputs: the s4-flat host staging and its device-side readers, and the
letterbox resize of `predict`.

Everything here is bit for bit: the port computes the normalization and
the letterbox's bilinear blends with the fused multiply-adds XLA compiles
them into (tests/test_torch_normalize.py).
"""

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.ops import image as jax_image
from multiposenet_tpu_torch.ops import image



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s4_flat_readers_match(dtype):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    flat = image.space_to_depth_flat4(imgs)
    np.testing.assert_array_equal(flat, jax_image.space_to_depth_flat4(imgs))
    t = torch.as_tensor(flat)
    for port_fn, jax_fn in ((image.s4_flat_to_cells,
                             jax_image.s4_flat_to_cells),
                            (image.normalize_s4_flat,
                             jax_image.normalize_s4_flat)):
        got = port_fn(t, getattr(torch, dtype)).float().numpy()
        want = np.asarray(jax.jit(jax_fn, static_argnums=1)(
            jnp.asarray(flat), jnp.dtype(dtype)), np.float32)
        # bf16 output: both round the same f32 value once.
        np.testing.assert_array_equal(got, want)


def test_normalize_matches():
    px = np.random.RandomState(1).randint(0, 256, (4, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        image.normalize(torch.as_tensor(px)).numpy(),
        np.asarray(jax.jit(jax_image.normalize)(jnp.asarray(px))))


@pytest.mark.parametrize("shape", [(128, 128), (96, 150), (150, 96),
                                   (7, 9), (1333, 97)])
@pytest.mark.parametrize("normalize_out", [True, False])
def test_resize_pad_normalize_matches(shape, normalize_out):
    img = np.random.RandomState(2).randint(0, 256, (*shape, 3)).astype(
        np.uint8)
    want, want_scale = jax_image.resize_pad_normalize(
        jnp.asarray(img), 128, normalize_out=normalize_out)
    got, scale = image.resize_pad_normalize(torch.as_tensor(img), 128,
                                            normalize_out=normalize_out)
    assert scale == float(want_scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_host_staging_matches():
    """The three host stagings, byte for byte."""
    imgs = np.random.RandomState(3).randint(0, 256, (2, 32, 48, 3)).astype(
        np.uint8)
    for name in ("space_to_depth_flat", "space_to_depth_flat4",
                 "space_to_depth_flat4_t"):
        got = getattr(image, name)(imgs)
        want = getattr(jax_image, name)(imgs)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s2d_flat_readers_match(dtype):
    imgs = np.random.RandomState(4).randint(0, 256, (2, 32, 48, 3)).astype(
        np.uint8)
    flat = image.space_to_depth_flat(imgs)
    t = torch.as_tensor(flat)
    for port_fn, jax_fn in ((image.s2d_flat_to_cells,
                             jax_image.s2d_flat_to_cells),
                            (image.normalize_s2d_flat,
                             jax_image.normalize_s2d_flat)):
        got = port_fn(t, getattr(torch, dtype)).float().numpy()
        want = np.asarray(jax.jit(jax_fn, static_argnums=1)(
            jnp.asarray(flat), jnp.dtype(dtype)), np.float32)
        assert got.shape == want.shape == (2, 16, 24, 12)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(300, 200), (64, 64), (37, 211)])
def test_resize_matrix_matches(size):
    np.testing.assert_array_equal(image._resize_matrix(*size),
                                  jax_image._resize_matrix(*size))


@pytest.mark.parametrize("staging", [(96, 160), (200, 200), (50, 41)])
@pytest.mark.parametrize("normalize_out", [True, False])
def test_resize_normalize_batch_matches(staging, normalize_out):
    """Two constant-matrix products on both sides, each output a two-tap
    blend of two-tap blends, then `(x - mean) * f32(1/std)` as jit
    compiles the normalize: bit for bit against the compiled function."""
    imgs = np.random.RandomState(5).randint(0, 256, (2, *staging, 3)).astype(
        np.uint8)
    want = np.asarray(jax.jit(
        jax_image.resize_normalize_batch, static_argnums=1,
        static_argnames="normalize_out")(jnp.asarray(imgs), 64,
                                         normalize_out=normalize_out))
    got = image.resize_normalize_batch(torch.as_tensor(imgs), 64,
                                       normalize_out=normalize_out)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
