"""The port's maps-on-lanes decode route (`ops.decode.decode_heatmaps_lanes`,
the switch `ops.decode.DECODE_LANES`) against the JAX package's lanes
kernel `decode_heatmaps_pallas_lanes` in interpret mode, and against the
port's own channel-major route.

Contract: `valid` equal everywhere, positions equal on valid slots, scores
within 1e-5 absolute + 1e-5 relative. The JAX lanes kernel blurs H with a
banded matmul and W with shifted adds, an order no other implementation
repeats, and it fills the slots of exhausted maps with other positions
than the port (it re-picks flat index 0 at -inf), so only valid slots are
compared for position.

On the CPU the route runs the plain version `decode_maps_plain`; on a card
it launches `csrc/decode_lanes.cu`, which test_torch_cuda.py holds bit for
bit against the plain version and against `csrc/decode_peaks.cu`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.config import DecodeConfig as JaxDecodeConfig
from multiposenet_tpu.ops.decode_pallas import decode_heatmaps_pallas_lanes
from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.config import DecodeConfig
from multiposenet_tpu_torch.infer.predictor import Predictor
from multiposenet_tpu_torch.ops import decode

from decode_maps import CONFIGS, MAKERS, planted_maps
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import tiny_crowd_config, torch_config_of

SCORE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 32, 32, 17), (3, 24, 40, 5)],
                         ids=["2x17x32x32", "3x5x24x40"])
@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_lanes_route_matches_jax_lanes_kernel(kind, shape):
    hm = MAKERS[kind](np.random.RandomState(13), shape)  # [B, H, W, K]
    b, k = shape[0], shape[3]
    hm_cm = np.ascontiguousarray(hm.transpose(0, 3, 1, 2))
    want = decode_heatmaps_pallas_lanes(
        jnp.asarray(hm_cm), (b, k), JaxDecodeConfig(**CONFIGS[kind]),
        interpret=True)
    kernels.reset_launches()
    got = decode.decode_heatmaps_lanes(torch.as_tensor(hm_cm),
                                       DecodeConfig(**CONFIGS[kind]))
    assert kernels.LAUNCHES == {}  # CPU tensors: the plain version
    valid = np.asarray(want.valid)
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **SCORE_TOL)
    np.testing.assert_array_equal(got.positions.numpy()[valid],
                                  np.asarray(want.positions)[valid])


@pytest.mark.parametrize("layout", ["channel_major", "channels_last",
                                    "head_slice"])
def test_lanes_and_channel_major_routes_agree(layout):
    """The lanes route reads any layout; the channel-major route reads a
    contiguous copy. Both give the same outputs, -inf fillers included."""
    hm = planted_maps(np.random.RandomState(3), (2, 24, 32, 18))
    nhwc = torch.as_tensor(hm)
    if layout == "channel_major":
        x = nhwc[..., :17].permute(0, 3, 1, 2).contiguous()
    elif layout == "channels_last":
        x = nhwc[..., :17].contiguous().permute(0, 3, 1, 2)
        assert x.stride(1) == 1
    else:  # the first 17 of the keypoint head's 18 output channels
        x = nhwc.permute(0, 3, 1, 2).contiguous()[:, :17]
    cfg = DecodeConfig()
    lanes = decode.decode_maps_lanes(x, cfg)
    cm = decode.decode_maps(x.contiguous(), cfg)
    for a, b in zip(lanes, cm):
        assert torch.equal(a, b)
    for a, b in zip(decode.decode_heatmaps_lanes(x, cfg),
                    decode.decode_heatmaps_cm(x.contiguous(), cfg)):
        assert torch.equal(a, b)


def test_predictor_decode_switch(monkeypatch):
    """DECODE_LANES switches Predictor._decode_cm to the lanes route,
    which gives the channel-major route's peaks."""
    port = Predictor(torch_config_of(tiny_crowd_config()), image_size=128,
                     device="cpu")
    hm_cm = torch.as_tensor(planted_maps(np.random.RandomState(4),
                                         (2, 32, 32, 17))).permute(0, 3, 1, 2)
    calls = []
    real = decode.decode_maps_lanes
    monkeypatch.setattr(decode, "decode_maps_lanes",
                        lambda *a: calls.append(1) or real(*a))
    off = port._decode_cm(hm_cm)
    assert calls == []
    monkeypatch.setattr(decode, "DECODE_LANES", True)
    on = port._decode_cm(hm_cm)
    assert calls == [1]
    for a, b in zip(on, off):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["dtype", "peaks", "taps", "width"])
def test_lanes_wrapper_validates_before_building(case, monkeypatch):
    """The wrapper refuses what the kernel does not take before it builds
    or launches anything (CPU tensors stand in for CUDA ones here)."""
    monkeypatch.setattr(kernels, "load", pytest.fail)
    cfg = DecodeConfig()
    x = torch.zeros(2, 3, 16, 16)
    if case == "dtype":
        x, err = x.half(), TypeError
    elif case == "peaks":
        cfg, err = DecodeConfig(max_peaks_per_channel=17), ValueError
    elif case == "taps":
        cfg, err = DecodeConfig(smooth_kernel_size=17), ValueError
    else:
        x, err = torch.zeros(1, 1, 4, 1024), ValueError
    with pytest.raises(err):
        decode._decode_maps_lanes_cuda(x, cfg)
    assert kernels.LAUNCHES.get(decode.LANES_KERNEL, 0) == 0

