"""The port's ImageNet normalization against the JAX package's compiled
functions, bit for bit.

XLA on the CPU compiles `(x / 255 - mean) / std` into
`fma(x, f32(1/255), -mean) * f32(1/std)`; the JAX package's programs
(`jax.jit`) run that, and an eager call runs the source's true divisions,
which differ on 570 of the 768 (value, channel) pairs. The port computes
what the compiled programs compute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.ops import image as jax_image
from multiposenet_tpu_torch.ops import image
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

ALL_VALUES = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


@pytest.mark.parametrize("name,cell", [("normalize", 3),
                                       ("normalize_s2d_flat", 12),
                                       ("normalize_s4_flat", 48)])
def test_every_value_of_every_channel_is_the_compiled_reference(name, cell):
    """All 256 values in each channel, laid out as each function takes
    them (the flat layouts interleave R, G, B along the row)."""
    if name == "normalize":
        x = ALL_VALUES
        want = np.asarray(_jit(jax_image.normalize)(jnp.asarray(x)))
        got = image.normalize(torch.as_tensor(x)).numpy()
    else:
        # [1, 16, 16*cell]: each row holds 16 values of each channel.
        flat = ALL_VALUES.reshape(1, 16, 16 * 3)
        flat = np.ascontiguousarray(np.tile(flat, (1, 1, cell // 3)))
        want = np.asarray(_jit(getattr(jax_image, name), 1)(
            jnp.asarray(flat), jnp.float32))
        got = getattr(image, name)(torch.as_tensor(flat)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # The eager JAX call differs: the port follows the compiled program.
    eager = np.asarray(jax_image.normalize(jnp.asarray(ALL_VALUES)))
    assert (image.normalize(torch.as_tensor(ALL_VALUES)).numpy()
            != eager).sum() == 570


def test_seeded_float_pixels_are_the_compiled_reference():
    """Float input (letterboxed pixels, the raw pixels the plain stem
    normalizes) takes the multiply-add in float64, rounded once."""
    x = (np.random.RandomState(0).rand(4096, 3) * 255).astype(np.float32)
    x[:3] = [[0, 0, 0], [255, 255, 255], [0.5, 1e-30, 254.99998]]
    want = np.asarray(_jit(jax_image.normalize)(jnp.asarray(x)))
    np.testing.assert_array_equal(
        image.normalize(torch.as_tensor(x)).numpy(), want)


def test_normalize_table_is_built_once_a_device():
    cpu = torch.device("cpu")
    table = image.normalize_table(cpu)
    assert table is image.normalize_table(cpu)
    assert table.shape == (256, 3) and table.dtype == torch.float32
    np.testing.assert_array_equal(
        table.numpy(), np.asarray(_jit(jax_image.normalize)(ALL_VALUES)))


@pytest.mark.parametrize("shape", [(37, 53), (100, 30), (7, 9), (480, 640),
                                   (1333, 97)])
def test_letterbox_is_the_compiled_reference(shape):
    """`resize_pad_normalize` (jitted in the JAX package), raw and
    normalized: XLA compiles the grid coordinates into fma(i + 0.5, f,
    -0.5) and each bilinear blend into fma(near, 1 - w, far * w); the
    port computes those and equals it bit for bit (true multiplies and
    adds differed by up to 8.4e-4 on raw pixels, 3.7e-6 normalized)."""
    img = np.random.RandomState(7).randint(0, 256, (*shape, 3)).astype(
        np.uint8)
    for normalize_out in (False, True):
        want, _ = jax_image.resize_pad_normalize(
            jnp.asarray(img), 128, normalize_out=normalize_out)
        got, _ = image.resize_pad_normalize(torch.as_tensor(img), 128,
                                            normalize_out=normalize_out)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("staging", [(96, 160), (50, 41), (24, 40)])
def test_resize_normalize_batch_is_the_compiled_reference(staging, dtype):
    """The two constant-matrix products agree exactly on the CPU, and
    the normalize is `(x - mean) * f32(1/std)` as jit compiles it: the
    bound this earns is 0."""
    imgs = np.random.RandomState(5).randint(0, 256, (2, *staging, 3)).astype(
        np.uint8)
    want = np.asarray(_jit(jax_image.resize_normalize_batch, 1, 2)(
        jnp.asarray(imgs), 64, jnp.dtype(dtype)), np.float32)
    got = image.resize_normalize_batch(torch.as_tensor(imgs), 64,
                                       getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(), want)
