"""Tests of the port that need an NVIDIA GPU: the hand-written kernels
(`csrc/decode_peaks.cu` B1, `csrc/decode_lanes.cu` B2,
`csrc/decode_generic.cu`, `csrc/kp_tail.cu` B3) against their plain
PyTorch versions on the same card, B2 against B1,
the inference pipelines (Config.fast()-like and Config.crowd()-like)
on the card against the same weights on the CPU, and the default
architecture (Config()): its forward against the CPU, flip TTA decoding
through B1, an exported model loaded onto the card, and B1 on Config()'s
float32 maps; B4 (`csrc/column_topk.cu`, the decode micro-benchmark's
per-column top-8 of the 3x3 peak mask) against its plain version on
column 0 and on every column; the train step's update
(`csrc/train_update.cu`) against its plain version on the CPU, bit for
bit; the command line on the card: `eval
--batched` against the CPU's stats, on PNG scenes and on the committed
JPEG fixtures (tests/fixtures/images), and `predict` without `--device`.
Without a GPU every test here skips.

This file imports neither JAX nor the JAX package, so on a machine that
has no JAX it runs without the repository's conftest:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib
import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from multiposenet_tpu_torch import cli, kernels
from multiposenet_tpu_torch.config import Config, DecodeConfig
from multiposenet_tpu_torch.data.synthetic import make_dataset
from multiposenet_tpu_torch.infer import export
from multiposenet_tpu_torch.infer.predictor import Predictor
from multiposenet_tpu_torch.ops import column_topk, decode, kp_tail
from multiposenet_tpu_torch.ops.image import space_to_depth_flat4
from multiposenet_tpu_torch.utils.image_io import read_image, write_png

from decode_maps import (CONFIGS, GENERIC_CARD_PLANS, MAKERS, planted_maps,
                         straddle_maps, with_nans)
from eval_fixtures import planted_annotations, write_coco

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _assert_kernel_equals_plain(x, cfg):
    """Bit-for-bit: both accumulate the blur taps in one order without
    fused multiply-adds. Scores (and -inf fillers) everywhere, positions
    on valid slots."""
    b, k, h, w = x.shape
    kernels.reset_launches()
    got = decode.decode_maps(x, cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {decode.KERNEL: 1}
    want = decode.decode_maps_plain(x.reshape(b * k, h, w), cfg)
    scores, ys, xs = (t.cpu() for t in got)
    w_scores, w_ys, w_xs = (t.cpu() for t in want)
    assert torch.equal(scores, w_scores)
    valid = w_scores > cfg.score_threshold
    assert torch.equal(ys[valid], w_ys[valid])
    assert torch.equal(xs[valid], w_xs[valid])


@pytest.mark.parametrize("kind", sorted(MAKERS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, kind, dtype):
    hm = MAKERS[kind](np.random.RandomState(3), (4, 128, 128, 17))
    x = torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous().to(
        cuda_device, dtype)
    _assert_kernel_equals_plain(x, DecodeConfig(**CONFIGS[kind]))


@pytest.mark.parametrize("shape,peaks,sigma", [
    ((2, 3, 37, 53), 1, 1.0),
    ((1, 5, 9, 130), 16, 1.0),
    ((3, 2, 64, 32), 8, 0.0),
    ((1, 1, 3, 3), 8, 1.0),
])
def test_kernel_odd_shapes(cuda_device, shape, peaks, sigma):
    b, k, h, w = shape
    hm = planted_maps(np.random.RandomState(4), (b, h, w, k))
    x = torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous().to(cuda_device)
    _assert_kernel_equals_plain(
        x, DecodeConfig(max_peaks_per_channel=peaks, smooth_sigma=sigma))


def test_kernel_reads_channel_slice_of_head_output(cuda_device):
    """The keypoint head's heatmaps_cm is the first 17 of 18 channels of
    one conv output: a view whose batch stride is 18*H*W."""
    hm = planted_maps(np.random.RandomState(5), (3, 64, 64, 18))
    full = torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous().to(
        cuda_device, torch.bfloat16)
    x = full[:, :17]
    assert not x.is_contiguous()
    kernels.reset_launches()
    got = decode.decode_maps(x, DecodeConfig())
    want = decode.decode_maps(x.contiguous(), DecodeConfig())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {decode.KERNEL: 2}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["dtype", "strides", "width"])
def test_kernel_wrapper_refuses_on_card(cuda_device, case):
    """B1 refuses f16 maps (as every decode kernel does). Transposed maps
    and maps wider than 512, which B1 does not take, decode through the
    generic kernel, equal to the plain version on every slot."""
    x = torch.rand(2, 3, 16, 16, device=cuda_device)
    if case == "dtype":
        with pytest.raises(TypeError):
            decode.decode_maps(x.half(), DecodeConfig())
        return
    if case == "strides":
        x = x.permute(0, 1, 3, 2)
    else:
        x = torch.rand(1, 2, 4, decode.MAX_WIDTH + 1, device=cuda_device)
    _assert_generic_equals_plain(x, DecodeConfig())


def _assert_generic_equals_plain(x, cfg, lanes=False):
    """One launch of the generic kernel, bit for bit against the plain
    version on every slot, -inf fillers and their positions included."""
    b, k, h, w = x.shape
    kernels.reset_launches()
    got = (decode.decode_maps_lanes if lanes else decode.decode_maps)(x, cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {decode.GENERIC_KERNEL: 1}
    want = decode.decode_maps_plain(x.reshape(b * k, h, w), cfg)
    for a, c in zip(got, want):
        assert torch.equal(a.cpu(), c.cpu())


# What only the generic kernel takes: peak windows other than 3, more than
# 16 peaks (up to H*W), maps wider than 512, more than 15 taps; on
# channel-major and channels-last maps, through both entry points.
@pytest.mark.parametrize("shape,kwargs", [
    ((2, 3, 40, 56), dict(nms_window=1)),
    ((2, 3, 40, 56), dict(nms_window=2, max_peaks_per_channel=17)),
    ((2, 3, 40, 56), dict(nms_window=4, max_peaks_per_channel=64)),
    ((2, 3, 37, 53), dict(nms_window=5, max_peaks_per_channel=1)),
    ((4, 17, 128, 128), dict(nms_window=5)),
    ((1, 2, 9, 513), dict(max_peaks_per_channel=17)),
    ((1, 2, 20, 700), dict(nms_window=4, max_peaks_per_channel=64)),
    ((2, 3, 40, 56), dict(smooth_sigma=3.0, smooth_kernel_size=17)),
    ((2, 2, 3, 3), dict(nms_window=2, max_peaks_per_channel=9)),
], ids=["w1", "w2p17", "w4p64", "w5p1", "w5path", "width513p17",
        "width700w4p64", "taps17", "p_eq_hw"])
@pytest.mark.parametrize("layout", ["channel_major", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generic_kernel_matches_plain(cuda_device, shape, kwargs, layout,
                                      dtype):
    b, k, h, w = shape
    hm = planted_maps(np.random.RandomState(21), (b, h, w, k))
    x = _layout(hm, layout, cuda_device, dtype)
    cfg = DecodeConfig(**{**CONFIGS["planted"], **kwargs})
    _assert_generic_equals_plain(x, cfg, lanes=layout == "channels_last")


def _assert_equal_nan(got, want):
    """Bit for bit, where a NaN must be NaN in both (its bits may differ)."""
    for a, c in zip(got, want):
        a, c = a.cpu(), c.cpu()
        assert torch.equal(a.isnan(), c.isnan())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(c))


def _nan_input(layout, device, dtype, shape=(2, 17, 128, 128)):
    b, k, h, w = shape
    rng = np.random.RandomState(23)
    hm = with_nans(rng, planted_maps(rng, (b, h, w, k)), 0.003)
    return _layout(hm, layout, device, dtype)


# NaNs in the maps: a window that holds one has no peak (max.NaN), a NaN
# neighbour makes the step NaN; every kernel as the plain version does.
@pytest.mark.parametrize("kernel,layout,kwargs", [
    ("decode_peaks", "channel_major", {}),
    ("decode_lanes", "channel_major", {}),
    ("decode_lanes", "channels_last", {}),
    ("decode_generic", "channel_major", dict(nms_window=1)),
    ("decode_generic", "channel_major", dict(nms_window=5)),
    ("decode_generic", "channels_last", dict(nms_window=2,
                                             max_peaks_per_channel=40)),
], ids=["b1", "b2_cm", "b2_cl", "generic_w1", "generic_w5",
        "generic_w2p40_cl"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_on_nan_maps(cuda_device, kernel, layout, kwargs, dtype):
    x = _nan_input(layout, cuda_device, dtype)
    cfg = DecodeConfig(**{**CONFIGS["planted"], **kwargs})
    lanes = kernel == decode.LANES_KERNEL or layout == "channels_last"
    assert decode.route(x, cfg, lanes=lanes) == kernel
    kernels.reset_launches()
    got = (decode.decode_maps_lanes if lanes else decode.decode_maps)(x, cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {kernel: 1}
    b, k, h, w = x.shape
    want = decode.decode_maps_plain(x.reshape(b * k, h, w), cfg)
    assert torch.isnan(x).any()
    _assert_equal_nan(got, want)
    if kwargs.get("nms_window", 3) <= 2:  # peaks next to a NaN
        valid = want[0] > cfg.score_threshold
        assert want[1][valid].isnan().any() or want[2][valid].isnan().any()


def _last_tile_maps(rng, shape):
    """Low noise with the 20 best peaks, 3 apart, all in the last 15 rows
    and columns of each map: the last tile of the plan holds them."""
    b, h, w, k = shape
    hm = 0.2 * rng.rand(*shape).astype(np.float32)
    for i in range(20):
        y, x = h - 15 + (i % 5) * 3, w - 14 + (i // 5) * 3
        hm[:, y, x] = 0.9 - 0.01 * i
    return hm


def _generic_case_maps(kind, shape, cfg):
    b, k, h, w = shape
    rng = np.random.RandomState(sum(shape))
    if kind == "straddle":  # plateaus across this launch's tile edges
        plan = decode.generic_launch_plan(
            b * k, h, w, len(decode.smoothing_taps(cfg)), cfg.nms_window,
            cfg.max_peaks_per_channel)
        rows = list(range(plan["tile_rows"], h, plan["tile_rows"]))
        cols = list(range(plan["tile_cols"], w, plan["tile_cols"]))
        return straddle_maps(rng, (b, h, w, k), rows, cols)
    if kind == "last_tile":
        return _last_tile_maps(rng, (b, h, w, k))
    if kind == "ramp":  # one peak: the rest of the slots are fillers
        return np.broadcast_to(np.arange(h * w, dtype=np.float32).reshape(
            1, h, w, 1) / (h * w), (b, h, w, k)).copy()
    return MAKERS[kind](rng, (b, h, w, k))


# The tile design's edges: ties across tile edges, the best peaks in the
# last tile, heights below and off the tiles' rows, W = 1 and W = 4097 (33
# column tiles for 8 blocks), taps too wide for shared memory (the
# workspace path), window 7, one map and 133 maps, P = 1, P at and just
# above the lists' 8 and 32, P = H * W, fewer peaks than P, channels-last
# and transposed strides.
GENERIC_DESIGN_CASES = {
    "straddle": ((1, 3, 40, 300), "straddle", dict(smooth_sigma=0.0,
                                                    nms_window=5)),
    "straddle_p32": ((1, 3, 64, 260), "straddle", dict(
        smooth_sigma=0.0, nms_window=5, max_peaks_per_channel=32)),
    "straddle_batch": ((64, 17, 128, 128), "straddle", dict(
        smooth_sigma=0.0, nms_window=5)),
    "last_tile": ((1, 17, 128, 128), "last_tile", dict(
        nms_window=5, max_peaks_per_channel=20, score_threshold=0.5)),
    "h7_batch": ((64, 17, 7, 128), "planted", dict(nms_window=5)),
    "h37": ((1, 17, 37, 128), "planted", dict(nms_window=5)),
    "w1": ((1, 3, 64, 1), "planted", dict(nms_window=5)),
    "w4097": ((1, 3, 13, 4097), "planted", dict(nms_window=5)),
    "taps401": ((2, 3, 20, 40), "planted", dict(smooth_sigma=60.0,
                                                 smooth_kernel_size=401)),
    "window7": ((2, 3, 40, 56), "planted", dict(nms_window=7)),
    "n1": ((1, 1, 37, 53), "planted", dict(nms_window=5)),
    "n133": ((7, 19, 37, 53), "planted", dict(nms_window=5)),
    "p1": ((2, 3, 40, 56), "planted", dict(nms_window=5,
                                            max_peaks_per_channel=1)),
    "p8": ((2, 3, 40, 56), "plateau", dict(smooth_sigma=0.0, nms_window=5)),
    "p9": ((2, 3, 40, 56), "plateau", dict(smooth_sigma=0.0, nms_window=5,
                                            max_peaks_per_channel=9)),
    "p32": ((2, 3, 40, 56), "planted", dict(nms_window=5,
                                             max_peaks_per_channel=32)),
    "p33": ((2, 3, 40, 56), "planted", dict(nms_window=5,
                                             max_peaks_per_channel=33)),
    "p_eq_hw": ((1, 6, 8, 8), "plateau", dict(
        smooth_sigma=0.0, nms_window=5, max_peaks_per_channel=64)),
    "ramp_p40": ((1, 3, 24, 40), "ramp", dict(
        smooth_sigma=0.0, nms_window=5, max_peaks_per_channel=40)),
}


@pytest.mark.parametrize("layout", ["channel_major", "channels_last",
                                    "transposed"])
@pytest.mark.parametrize("case", sorted(GENERIC_DESIGN_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generic_tiles_match_plain(cuda_device, case, layout, dtype):
    shape, kind, kwargs = GENERIC_DESIGN_CASES[case]
    b, k, h, w = shape
    cfg = DecodeConfig(**{**CONFIGS["planted"], **kwargs})
    hm = _generic_case_maps(kind, shape, cfg)
    if layout == "transposed":  # [B, K, W, H] strides: a map transposed
        x = torch.as_tensor(hm).permute(0, 3, 2, 1).to(cuda_device, dtype)
        x = x.contiguous().permute(0, 1, 3, 2)
        assert x.stride(3) == h
    else:
        x = _layout(hm, layout, cuda_device, dtype)
    _assert_generic_equals_plain(x, cfg, lanes=layout == "channels_last")


def test_generic_plan_matches_launch_plan(cuda_device):
    """The plan the C entry point launches equals ops/decode.py
    generic_launch_plan's (which the CPU tests check), at the card tests'
    launches and this card's SM count."""
    import ctypes
    lib = kernels.load(decode.GENERIC_KERNEL)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    out = (ctypes.c_int * len(decode.GENERIC_PLAN_FIELDS))()
    fn = lib.decode_generic_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    for shape in GENERIC_CARD_PLANS:
        assert fn(*shape, 0, out) == 0
        assert (dict(zip(decode.GENERIC_PLAN_FIELDS, out))
                == decode.generic_launch_plan(*shape, sms)), shape


@pytest.mark.parametrize("shape,window", [((64, 17, 128, 128), 5),
                                          ((1, 17, 128, 128), 5),
                                          ((2, 3, 36, 300), 2)])
def test_counted_generic_build_equals_plain_build(cuda_device, shape,
                                                  window):
    """The -DDECODE_GENERIC_PROFILE build (tools/decode_phases.py --kernel
    generic) gives the plain build's outputs bit for bit."""
    from multiposenet_tpu_torch.tools import decode_phases

    b, k, h, w = shape
    x = decode_phases.phase_maps(b * k, h, w, cuda_device).view(b, k, h, w)
    cfg = DecodeConfig(nms_window=window)
    counted = decode.launch_generic_cuda(
        x, cfg, decode_phases.build_profiled("generic"))
    plain = decode.launch_generic_cuda(x, cfg)
    for a, c in zip(counted, plain):
        assert torch.equal(a, c)


# Edges of the warp-per-map design: widths that are not a multiple of the
# 4 or 16 columns of a lane or of the 32 lanes, maps lower than the 7 taps,
# 1 and 16 peaks (the path's 128x128 maps then take the kernel's generic
# instantiation), fewer peaks than P, plateau ties, one request's 17 maps
# (split into bands of rows) and a full fast() batch of 2176 maps.
@pytest.mark.parametrize("shape,peaks,kind", [
    ((2, 3, 17, 9), 8, "planted"),
    ((1, 4, 20, 36), 8, "random"),
    ((2, 3, 37, 53), 8, "planted"),
    ((1, 5, 9, 130), 8, "random"),
    ((1, 2, 70, 512), 8, "planted"),
    ((2, 3, 3, 3), 8, "planted"),
    ((3, 2, 1, 1), 1, "random"),
    ((4, 17, 128, 128), 1, "planted"),
    ((4, 17, 128, 128), 16, "planted"),
    ((1, 17, 128, 128), 8, "planted"),
    ((1, 17, 128, 128), 8, "plateau"),
    ((3, 17, 64, 64), 16, "plateau"),
    ((2, 3, 6, 40), 16, "ramp"),
    ((1, 17, 128, 128), 8, "ramp"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_edges(cuda_device, shape, peaks, kind, dtype):
    b, k, h, w = shape
    rng = np.random.RandomState(11)
    if kind == "ramp":  # values rise with the flat index: one peak
        hm = np.broadcast_to(np.arange(h * w, dtype=np.float32).reshape(
            1, h, w, 1), (b, h, w, k)).copy()
        cfg = DecodeConfig(max_peaks_per_channel=peaks, smooth_sigma=0.0)
    else:
        hm = MAKERS[kind](rng, (b, h, w, k))
        cfg = DecodeConfig(**{**CONFIGS[kind],
                              "max_peaks_per_channel": peaks})
    x = torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous().to(
        cuda_device, dtype)
    _assert_kernel_equals_plain(x, cfg)
    if kind == "ramp" and h * w <= 256:  # exact in bf16: P - 1 fillers
        scores = decode.decode_maps(x, cfg)[0]
        assert torch.isneginf(scores[:, 1:]).all()


@pytest.mark.parametrize("size", [128, 40])
def test_kernel_reads_channel_slice_at_path_size(cuda_device, size):
    """The first 17 of 18 channels (batch stride 18*H*W) at the fast()
    path's 128x128 (its cp.async instantiation) and at another size, bit
    for bit against the plain version on every slot."""
    hm = planted_maps(np.random.RandomState(12), (3, size, size, 18))
    full = torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous().to(
        cuda_device, torch.bfloat16)
    x = full[:, :17]
    assert x.stride(0) == 18 * size * size
    cfg = DecodeConfig()
    got = decode.decode_maps(x, cfg)
    want = decode.decode_maps_plain(x.reshape(-1, size, size), cfg)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_full_fast_batch(cuda_device, dtype):
    """2176 maps of 128x128, as a fast() batch of 128 gives the kernel,
    every slot bit for bit (the -inf fillers included)."""
    hm = planted_maps(np.random.RandomState(13), (8, 128, 128, 17))
    x = torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous().to(
        cuda_device, dtype).repeat(16, 1, 1, 1)
    x = x + torch.linspace(0, 0.5, 128, device=cuda_device,
                           dtype=dtype)[:, None, None, None]
    cfg = DecodeConfig()
    got = decode.decode_maps(x, cfg)
    want = decode.decode_maps_plain(x.reshape(-1, 128, 128), cfg)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


@pytest.mark.parametrize("shape", [(128, 17, 128, 128), (1, 17, 128, 128),
                                   (2, 3, 36, 52)])
def test_counted_build_equals_plain_build(cuda_device, shape):
    """The -DDECODE_PEAKS_PROFILE build (tools/decode_phases.py) gives the
    plain build's outputs bit for bit: the counters change no result."""
    from multiposenet_tpu_torch.tools import decode_phases

    b, k, h, w = shape
    x = decode_phases.phase_maps(b * k, h, w, cuda_device).view(b, k, h, w)
    cfg = DecodeConfig()
    counted = decode.launch_cuda(x, cfg, decode_phases.build_profiled())
    plain = decode.launch_cuda(x, cfg)
    for a, c in zip(counted, plain):
        assert torch.equal(a, c)


def test_batch_forward_on_card_matches_cpu(cuda_device):
    """A narrow fast()-like model in float32 with TF32 off: the card (with
    the decode kernel) and the CPU (with the plain decode) give the same
    detections and peaks on the same weights. Heatmaps differ in the last
    f32 bits between cuDNN and the CPU, so peaks are compared where both
    are valid and away from ties: positions to a quarter pixel."""
    cfg = Config.fast()
    cfg = cfg.replace(
        model=dataclasses.replace(
            cfg.model, backbone_width=0.25, fpn_channels=32,
            head_channels=32, backbone_stage_caps=(16, 32, 0, 0),
            backbone_max_channels=64, compute_dtype="float32"),
        detector=dataclasses.replace(cfg.detector, score_threshold=0.0,
                                     head_channels=32))
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = Predictor(cfg, image_size=256, device=cuda_device)
        cpu = Predictor(cfg, image_size=256, device="cpu")
        rng = np.random.RandomState(6)
        flat = space_to_depth_flat4(
            rng.randint(0, 256, (4, 256, 256, 3)).astype(np.uint8))
        kernels.reset_launches()
        got = gpu.batch_forward(flat)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == {decode.KERNEL: 1}
        want = cpu.batch_forward(flat)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    got = {k: v.cpu() for k, v in got.items()}
    assert torch.equal(got["box_valid"], want["box_valid"])
    torch.testing.assert_close(got["boxes"], want["boxes"], atol=1e-2,
                               rtol=1e-4)
    both = got["peak_valid"] & want["peak_valid"]
    assert both.sum() >= 0.9 * want["peak_valid"].sum()
    near = (got["peak_positions"] - want["peak_positions"]).abs() <= 1.0
    assert near.all(-1)[both].float().mean() >= 0.9


@contextlib.contextmanager
def no_tf32():
    """Full float32 convs and matmuls (cuDNN would run f32 in TF32)."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


# --- B3: the fused keypoint tail ------------------------------------------


def _tail_inputs(shape, dtype, device, seed=0):
    b, c, h, w, k = shape
    g = torch.Generator().manual_seed(seed)
    l2 = torch.randn(b, c, h, w, generator=g)
    z8 = torch.randn(b, c, h // 2, w // 2, generator=g)
    weight = torch.randn(k, c, 3, 3, generator=g) / (9 * c) ** 0.5
    bias = torch.randn(k, generator=g)
    return (l2.to(device, dtype), z8.to(device, dtype), weight.to(device),
            bias.to(device))


@pytest.mark.parametrize("shape", [
    (2, 64, 128, 128, 17),   # the crowd path's per-image shapes
    (1, 8, 48, 70, 5),       # ragged row and column tiles
    (3, 20, 18, 34, 32),     # channels not a multiple of the stage, K max
    (1, 3, 2, 2, 1),
    # Edges of the bf16 tensor-core tiling (16-channel chunks, 4 x 128
    # pixel tiles, n8 output tiles):
    (2, 16, 32, 130, 8),     # one full chunk, ragged column tile, 1 n-tile
    (1, 72, 22, 36, 24),     # ragged chunk, narrow ragged width, 3 n-tiles
    (1, 72, 16, 130, 25),    # ragged chunk and columns, 4 n-tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_kernel_matches_plain(cuda_device, shape, dtype):
    """f32: the kernel and cuDNN sum 9C products in other orders, 1e-5.
    bf16: the products are exact in f32 on both sides and only the sum's
    order differs before the one rounding: 1 bf16 ulp at the output's
    scale."""
    l2, z8, weight, bias = _tail_inputs(shape, dtype, cuda_device)
    kernels.reset_launches()
    got = kp_tail.kp_tail_cm(l2, z8, weight, bias)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {kp_tail.KERNEL: 1}
    with no_tf32():
        want = kp_tail.kp_tail_plain(l2, z8, weight, bias)
    assert got.dtype == dtype and got.shape == want.shape
    got, want = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert (got - want).abs().max() <= 2.0 ** -7 * want.abs().max()


@pytest.mark.parametrize("case", ["dtype", "layout", "channels"])
def test_tail_wrapper_refuses_on_card(cuda_device, case):
    l2, z8, weight, bias = _tail_inputs((1, 8, 16, 16, 17), torch.float32,
                                        cuda_device)
    if case == "dtype":
        l2, z8, err = l2.half(), z8.half(), TypeError
    elif case == "layout":
        l2, err = l2.contiguous(memory_format=torch.channels_last), ValueError
    else:
        weight, bias = torch.zeros(33, 8, 3, 3, device=cuda_device), \
            torch.zeros(33, device=cuda_device)
        err = ValueError
    with pytest.raises(err):
        kp_tail.kp_tail_cm(l2, z8, weight, bias)


# --- B2: the maps-on-lanes decode -----------------------------------------


def _layout(hm: np.ndarray, layout: str, device, dtype) -> torch.Tensor:
    """[B, H, W, K] maps → a [B, K, H, W] view in the asked layout."""
    nhwc = torch.as_tensor(hm).to(device, dtype)
    if layout == "channel_major":
        return nhwc.permute(0, 3, 1, 2).contiguous()
    if layout == "channels_last":
        return nhwc.permute(0, 3, 1, 2)
    # The first 17 of the keypoint head's 18 output channels.
    pad = torch.cat([nhwc, nhwc[..., :1]], -1)
    return pad.permute(0, 3, 1, 2).contiguous()[:, :nhwc.shape[-1]]


def _assert_lanes_equal_plain_and_b1(x, cfg):
    """Bit for bit on every slot, -inf fillers and their positions
    included: against the plain version and against B1."""
    b, k, h, w = x.shape
    kernels.reset_launches()
    got = decode.decode_maps_lanes(x, cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {decode.LANES_KERNEL: 1}
    b1 = decode.decode_maps(x.contiguous(), cfg)
    plain = decode.decode_maps_plain(x.reshape(b * k, h, w), cfg)
    for a, p, q in zip(got, b1, plain):
        assert torch.equal(a, p)
        assert torch.equal(a, q)


@pytest.mark.parametrize("layout", ["channel_major", "channels_last",
                                    "head_slice"])
@pytest.mark.parametrize("kind", sorted(MAKERS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lanes_kernel_matches_plain_and_b1(cuda_device, dtype, kind, layout):
    hm = MAKERS[kind](np.random.RandomState(7), (4, 128, 128, 17))
    _assert_lanes_equal_plain_and_b1(_layout(hm, layout, cuda_device, dtype),
                                     DecodeConfig(**CONFIGS[kind]))


@pytest.mark.parametrize("shape,peaks,sigma", [
    ((2, 3, 37, 53), 1, 1.0),
    ((1, 5, 9, 130), 16, 1.0),
    ((3, 2, 64, 32), 8, 0.0),
    ((1, 1, 3, 3), 8, 1.0),
    ((2, 9, 20, 7), 8, 1.0),     # narrower than a warp
    ((1, 3, 6, 400), 4, 2.0),    # wide maps, 13 taps
])
@pytest.mark.parametrize("layout", ["channel_major", "channels_last"])
def test_lanes_kernel_odd_shapes(cuda_device, shape, peaks, sigma, layout):
    b, k, h, w = shape
    hm = planted_maps(np.random.RandomState(9), (b, h, w, k))
    cfg = DecodeConfig(max_peaks_per_channel=peaks, smooth_sigma=sigma,
                       smooth_kernel_size=13 if sigma == 2.0 else 7)
    _assert_lanes_equal_plain_and_b1(
        _layout(hm, layout, cuda_device, torch.float32), cfg)


@pytest.mark.parametrize("layout", ["channel_major", "channels_last",
                                    "head_slice"])
@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lanes_kernel_crowd_shapes(cuda_device, dtype, batch, layout):
    """The crowd path's shapes: a batch of 128 images of 17 maps of
    128x128 (channels-last then takes the span kernel, a block per image)
    and one request (channels-last then takes plain strided loads), every
    slot bit for bit against the plain version and B1."""
    hm = planted_maps(np.random.RandomState(14), (8, 128, 128, 17))
    hm = np.concatenate([hm + 0.5 * i / 16 for i in range(16)])[:batch]
    _assert_lanes_equal_plain_and_b1(_layout(hm, layout, cuda_device, dtype),
                                     DecodeConfig())


@pytest.mark.parametrize("shape", [(128, 17, 128, 128), (1, 17, 128, 128),
                                   (2, 3, 36, 52)])
@pytest.mark.parametrize("layout", ["channel_major", "channels_last"])
def test_counted_lanes_build_equals_plain_build(cuda_device, shape, layout):
    """The -DDECODE_LANES_PROFILE build (tools/decode_phases.py --kernel
    lanes) gives the plain build's outputs bit for bit."""
    from multiposenet_tpu_torch.tools import decode_phases

    b, k, h, w = shape
    x = decode_phases.phase_maps(b * k, h, w, cuda_device).view(b, k, h, w)
    if layout == "channels_last":
        x = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    cfg = DecodeConfig()
    counted = decode.launch_lanes_cuda(
        x, cfg, decode_phases.build_profiled("lanes"))
    plain = decode.launch_lanes_cuda(x, cfg)
    for a, c in zip(counted, plain):
        assert torch.equal(a, c)


# --- the crowd path on the card -------------------------------------------


def _tiny_crowd(compute_dtype="float32"):
    cfg = Config.crowd()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, backbone_width=0.25, fpn_channels=32,
            head_channels=32, backbone_stage_caps=(16, 32, 0, 0),
            backbone_max_channels=64, compute_dtype=compute_dtype,
            kp_tail_pallas=True),
        detector=dataclasses.replace(cfg.detector, score_threshold=0.0,
                                     head_channels=32))


@contextlib.contextmanager
def _lanes():
    old = decode.DECODE_LANES
    decode.DECODE_LANES = True
    try:
        yield
    finally:
        decode.DECODE_LANES = old


def test_crowd_batch_forward_on_card_matches_cpu(cuda_device):
    """Config.crowd()-like in float32 with BN folded, the tail and the
    lanes decode, TF32 off: one B3 and one B2 launch per batch and no B1;
    the card and the CPU give the same detections and peaks on the same
    weights. Heatmaps differ in the last f32 bits, and soft-NMS with
    voting can reorder near-equal candidates, so boxes are matched as
    sets (to 0.5 px) and peaks where both are valid (to 1 px)."""
    cfg = _tiny_crowd()
    with no_tf32(), _lanes():
        gpu = Predictor(cfg, image_size=256, device=cuda_device, fold_bn=True)
        cpu = Predictor(cfg, image_size=256, device="cpu", fold_bn=True)
        rng = np.random.RandomState(6)
        flat = space_to_depth_flat4(
            rng.randint(0, 256, (4, 256, 256, 3)).astype(np.uint8))
        kernels.reset_launches()
        got = gpu.batch_forward(flat)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == {kp_tail.KERNEL: 1,
                                    decode.LANES_KERNEL: 1}
        want = cpu.batch_forward(flat)
    got = {k: v.cpu() for k, v in got.items()}
    assert torch.equal(got["box_valid"], want["box_valid"])
    torch.testing.assert_close(got["box_scores"], want["box_scores"],
                               atol=1e-4, rtol=1e-3)
    near = (got["boxes"][:, :, None] - want["boxes"][:, None]).abs().amax(
        -1).amin(-1) <= 0.5
    assert near[want["box_valid"]].float().mean() >= 0.9
    both = got["peak_valid"] & want["peak_valid"]
    assert both.sum() >= 0.9 * want["peak_valid"].sum()
    close = (got["peak_positions"] - want["peak_positions"]).abs() <= 1.0
    assert close.all(-1)[both].float().mean() >= 0.9


def test_crowd_entry_points_on_card(cuda_device):
    """predict and predict_given_boxes take B3 and B2, predict_keypoints
    B3 and B1, once per request; their outputs are finite and shaped."""
    cfg = _tiny_crowd("bfloat16")
    pred = Predictor(cfg, image_size=256, device=cuda_device, fold_bn=True)
    img = np.random.RandomState(1).randint(0, 256, (200, 300, 3)).astype(
        np.uint8)
    with _lanes():
        kernels.reset_launches()
        people = pred.predict(img)
        assert kernels.LAUNCHES == {kp_tail.KERNEL: 1,
                                    decode.LANES_KERNEL: 1}
        kernels.reset_launches()
        pos, scores, valid = pred.predict_keypoints(img)
        assert kernels.LAUNCHES == {kp_tail.KERNEL: 1, decode.KERNEL: 1}
        kernels.reset_launches()
        boxes = np.array([[10, 10, 150, 90]] * 30, np.float32)
        kps = pred.predict_given_boxes(img, boxes)
        assert kernels.LAUNCHES == {kp_tail.KERNEL: 1,
                                    decode.LANES_KERNEL: 1}
    assert all(np.isfinite(p.keypoints).all() for p in people)
    assert pos.shape == (17, 8, 2) and np.isfinite(pos).all()
    assert kps.shape == (30, 17, 3) and np.isfinite(kps).all()


# --- the default architecture (Config()) on the card ------------------------


def _tiny_default(**detector):
    cfg = Config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, backbone_width=0.25,
                                  fpn_channels=32, head_channels=32),
        detector=dataclasses.replace(cfg.detector, score_threshold=0.0,
                                     head_channels=32, **detector))


def test_default_forward_on_card_matches_cpu(cuda_device):
    """Config() at full width in float32 with TF32 off, on normalized 2x2
    cells of two 256² images: the card's forward against the CPU's on the
    same module, to 1e-3 of each output's scale (chip_smoke.py's
    parity_f32 bound)."""
    from multiposenet_tpu_torch.models.posenet import MultiPoseNet
    from multiposenet_tpu_torch.ops import image

    model = MultiPoseNet(Config())
    model.init_weights(torch.Generator().manual_seed(0))
    model.eval()
    imgs = np.random.RandomState(8).randint(0, 256, (2, 256, 256, 3)).astype(
        np.uint8)
    cells = image.normalize_s2d_flat(
        torch.as_tensor(image.space_to_depth_flat(imgs)))
    with no_tf32(), torch.inference_mode():
        want = model(cells)
        got = model.to(cuda_device)(cells.to(cuda_device))
        torch.cuda.synchronize()
    pairs = [(got["heatmaps_cm"], want["heatmaps_cm"]),
             (got["segmentation"], want["segmentation"])]
    pairs += [(got["detector"][lv][kind], want["detector"][lv][kind])
              for lv in want["detector"] for kind in ("cls", "box")]
    for g, w in pairs:
        g = g.float().cpu()
        assert g.shape == w.shape and torch.isfinite(g).all()
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 1e-3 * scale


def test_flip_tta_decodes_through_b1(cuda_device):
    """Flip TTA on Config(): the averaged maps reach the decode as a
    contiguous channel-major copy, so batch_forward, predict and
    predict_keypoints each launch B1 once and the generic kernel never;
    pose NMS runs after the PRN on the card."""
    from multiposenet_tpu_torch.ops.image import space_to_depth_flat

    pred = Predictor(_tiny_default(pose_nms_oks=0.5), image_size=256,
                     device=cuda_device, flip_tta=True)
    imgs = np.random.RandomState(9).randint(0, 256, (2, 256, 256, 3)).astype(
        np.uint8)
    kernels.reset_launches()
    out = pred.batch_forward(space_to_depth_flat(imgs))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {decode.KERNEL: 1}
    assert out["keypoints"].is_cuda and out["box_valid"].any()
    for entry in ("predict", "predict_keypoints"):
        kernels.reset_launches()
        getattr(pred, entry)(imgs[0, :200])
        assert kernels.LAUNCHES == {decode.KERNEL: 1}, entry


def test_load_predictor_onto_card(cuda_device, tmp_path):
    """An exported Config() model loads onto the card (the default device)
    and serves the outputs of the predictor it was saved from, bit for
    bit."""
    from multiposenet_tpu_torch.infer import export
    from multiposenet_tpu_torch.ops.image import space_to_depth_flat

    cfg = _tiny_default()
    pred = Predictor(cfg, image_size=256, device=cuda_device)
    export.save_model(tmp_path, pred.config, pred.variables,
                      pred.prn_variables)
    loaded = export.load_predictor(tmp_path, image_size=256)
    assert loaded.device.type == "cuda"
    flat = space_to_depth_flat(np.random.RandomState(10).randint(
        0, 256, (2, 256, 256, 3)).astype(np.uint8))
    want, got = pred.batch_forward(flat), loaded.batch_forward(flat)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_kernel_f32_default_batch(cuda_device):
    """B1 on float32 maps at [64, 17, 128, 128], what a Config() batch of
    64 at 512² gives it, every slot bit for bit (the -inf fillers
    included)."""
    hm = planted_maps(np.random.RandomState(14), (8, 128, 128, 17))
    x = torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous().to(
        cuda_device).repeat(8, 1, 1, 1)
    x = x + torch.linspace(0, 0.5, 64, device=cuda_device)[:, None, None,
                                                           None]
    cfg = DecodeConfig()
    assert decode.route(x, cfg) == decode.KERNEL
    got = decode.decode_maps(x, cfg)
    want = decode.decode_maps_plain(x.reshape(-1, 128, 128), cfg)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def _column_maps(kind: str, shape, seed: int) -> torch.Tensor:
    """bf16 [N, H, W] maps of one of decode_maps' kinds (noise, bumps,
    2x2 plateaus), made a row and a column larger and cropped, so that odd
    sizes keep their plateaus."""
    n, h, w = shape
    maps = MAKERS[kind](np.random.RandomState(seed), (n, h + 1, w + 1, 1))
    return torch.as_tensor(maps[:, :h, :w, 0]).to(torch.bfloat16)


def _assert_column_topk_equals_plain(x):
    """One launch of B4, bit for bit against the plain version: column 0's
    lists (its outputs) and every column's (through columns_out), the
    (-inf, 5) slots of exhausted columns included."""
    n, h, w = x.shape
    cols = (torch.empty(n, 8, w, device=x.device),
            torch.empty(n, 8, w, dtype=torch.int32, device=x.device))
    kernels.reset_launches()
    scores, rows = column_topk.column_topk(x, columns_out=cols)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {column_topk.KERNEL: 1}
    want_s, want_p = column_topk.column_topk_plain(x, columns=True)
    assert torch.equal(scores, want_s[:, :, 0])
    assert torch.equal(rows, want_p[:, :, 0])
    assert torch.equal(cols[0], want_s)
    assert torch.equal(cols[1], want_p)


@pytest.mark.parametrize("shape", [
    (2176, 128, 128),   # the decode micro-benchmark's maps
    (1, 128, 128),
    (4, 1, 128),
    (4, 128, 1),
    (4, 127, 128),
    (4, 128, 130),      # plain loads (W % 8 != 0) in two chunks of rows
    (3, 128, 256),      # cp.async in two chunks of rows
    (2, 20, 1024),      # the widest, two chunks
], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_column_topk_matches_plain(cuda_device, shape, kind):
    _assert_column_topk_equals_plain(
        _column_maps(kind, shape, sum(shape)).to(cuda_device))


@pytest.mark.parametrize("case", ["constant", "nan", "unaligned"])
def test_column_topk_special_inputs(cuda_device, case):
    """A constant map (every element a peak, ties to the lower row), NaNs
    (NaN windows are no peaks, as in the plain version's max_pool2d), and
    maps that start 2 bytes past a 16-byte boundary (plain loads)."""
    if case == "constant":
        x = torch.full((4, 128, 128), 0.5, dtype=torch.bfloat16,
                       device=cuda_device)
    elif case == "nan":
        x = _column_maps("random", (8, 64, 64), 3).to(cuda_device)
        x[torch.rand(x.shape, device=cuda_device) < 0.01] = float("nan")
    else:
        flat = _column_maps("planted", (4, 128, 128), 4).reshape(-1)
        buf = torch.empty(flat.numel() + 1, dtype=torch.bfloat16,
                          device=cuda_device)
        buf[1:] = flat
        x = buf[1:].view(4, 128, 128)
        assert x.data_ptr() % 16 == 2 and x.is_contiguous()
    _assert_column_topk_equals_plain(x)


@pytest.mark.parametrize("shape", [
    (3, 31, 128),       # H not a multiple of the 16-row strip
    (3, 33, 128),
    (3, 65, 96),
    (2, 4097, 128),     # a tall map: 33 tiles of 128 rows
    (2, 7, 200),        # H smaller than one strip, two warps of columns
    (1, 128, 128),      # N = 1 on the fast path
    (793, 128, 128),    # one map more than the persistent grid of 792
    (1, 300, 1024),     # N = 1, the widest, 19 tiles of 16 rows
], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_column_topk_bands_match_plain(cuda_device, shape, kind):
    """The redesign's tiles and 16-row strips at their edges: heights off
    the strip, a map shorter than a strip, many tiles, one map, and a map
    count one past the grid."""
    _assert_column_topk_equals_plain(
        _column_maps(kind, shape, sum(shape) + 1).to(cuda_device))


def _strip_edge_maps(case: str, device) -> torch.Tensor:
    """[6, 128, 128] bf16 maps (the fast path: tiles of 64 rows, strips of
    16) built around the strips' and tiles' edges."""
    rng = np.random.RandomState(5)
    x = 0.5 * rng.rand(6, 128, 128).astype(np.float32)
    if case == "plateau_across_strips":
        # Equal values over rows 14..17 and 61..66 (across a strip edge
        # and the tile edge at 64): every row a peak, ties to the lower.
        x[:, 14:18, 10:20] = 0.875
        x[:, 61:67, 40:52] = 0.9375
        x[:, 60:68, 100] = 0.9375  # one column: 8 equal peaks over 2 tiles
    elif case == "best_in_last_strip":
        # Every column's 8 best peaks lie in rows 112..127: even rows
        # there hold one value a row across all columns, above the rest.
        x[:, 112:128] = 0.0
        for r in range(112, 128, 2):
            x[:, r] = 0.75 + r / 1024
    else:  # nan_on_halo: NaNs on rows other strips and tiles read as halo
        for r in (15, 16, 63, 64, 127):
            x[:, r, rng.randint(0, 128, 12)] = np.nan
    return torch.from_numpy(x).to(torch.bfloat16).to(device)


@pytest.mark.parametrize("case", ["plateau_across_strips",
                                  "best_in_last_strip", "nan_on_halo"])
def test_column_topk_strip_edges(cuda_device, case):
    _assert_column_topk_equals_plain(_strip_edge_maps(case, cuda_device))


def test_column_topk_plan_matches_launch_plan(cuda_device):
    """The plan the C entry point launches equals ops/column_topk.py
    launch_plan's (which the CPU tests check), at the card tests' shapes
    and this card's SM count."""
    import ctypes
    lib = kernels.load(column_topk.KERNEL)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    out = (ctypes.c_int * len(column_topk.PLAN_FIELDS))()
    for shape in [(2176, 128, 128), (1, 128, 128), (793, 128, 128),
                  (4, 1, 128), (4, 128, 1), (4, 128, 130), (2, 20, 1024),
                  (2, 4097, 128), (2, 7, 200), (1, 300, 1024)]:
        assert lib.column_topk_plan(*shape, 0, out) == 0
        assert (dict(zip(column_topk.PLAN_FIELDS, out))
                == column_topk.launch_plan(*shape, sms)), shape


@pytest.mark.parametrize("case", ["dtype", "width", "device"])
def test_column_topk_refuses_on_card(cuda_device, case):
    """f32 maps, maps wider than 1024 and columns_out on the CPU are
    refused before any launch."""
    x = torch.zeros(2, 16, 16, dtype=torch.bfloat16, device=cuda_device)
    cols, err = None, ValueError
    if case == "dtype":
        x, err = x.float(), TypeError
    elif case == "width":
        x = torch.zeros(1, 2, column_topk.MAX_WIDTH + 1, dtype=torch.bfloat16,
                        device=cuda_device)
    else:
        cols = (torch.empty(2, 8, 16), torch.empty(2, 8, 16,
                                                   dtype=torch.int32))
    kernels.reset_launches()
    with pytest.raises(err):
        column_topk.column_topk(x, columns_out=cols)
    assert kernels.LAUNCHES == {}


# --- eval and the command line on the card ----------------------------------


@pytest.fixture
def cli_workdir(cuda_device, tmp_path):
    """A tiny float32 fast()-like model exported from a CPU predictor
    (score threshold 0, heatmap bias raised so peaks are found), six PNG
    scenes and a COCO JSON of ground truth planted around the CPU
    predictor's detections on them (tests/eval_fixtures.py)."""
    cfg = Config.fast()
    cfg = cfg.replace(
        model=dataclasses.replace(
            cfg.model, backbone_width=0.25, fpn_channels=32,
            head_channels=32, backbone_stage_caps=(16, 32, 0, 0),
            backbone_max_channels=64, compute_dtype="float32"),
        detector=dataclasses.replace(cfg.detector, score_threshold=0.0,
                                     max_detections=8, head_channels=32),
        train=dataclasses.replace(cfg.train, image_size=128))
    pred = Predictor(cfg, device="cpu")
    with torch.no_grad():
        pred.model.keypoint_head.output.bias[:17].fill_(0.25)
    model_dir = tmp_path / "model"
    export.save_model(model_dir, pred.config, pred.variables,
                      pred.prn_variables)
    records = make_dataset(6, img_h=100, img_w=140, seed=11)
    rng = np.random.RandomState(12)
    anns = []
    for rec in records:
        people = pred.predict(rec["image"])
        anns.append(planted_annotations(
            np.stack([p.box for p in people]),
            np.stack([p.keypoints for p in people]), rng, 100, 140))
    coco_json, image_dir = write_coco(tmp_path / "coco",
                                      [r["image"] for r in records], anns,
                                      write_png)
    return {"model": str(model_dir), "coco": coco_json,
            "images": image_dir, "image": f"{image_dir}/000000.png"}


def _cli_stdout(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def test_cli_eval_batched_on_card_matches_cpu(cli_workdir):
    """`eval --batched` on the card (the default device; TF32 off) gives
    the CPU's stats within 0.01 (tests/test_torch_eval.py explains the
    bound), with one B1 launch a batch and no other kernel."""
    argv = ["eval", "--model-dir", cli_workdir["model"], "--coco-json",
            cli_workdir["coco"], "--image-dir", cli_workdir["images"],
            "--batched", "--batch-size", "4"]
    want = json.loads(_cli_stdout(argv + ["--device", "cpu"]))
    with no_tf32():
        kernels.reset_launches()
        got = json.loads(_cli_stdout(argv))
        assert kernels.LAUNCHES == {decode.KERNEL: 2}
    assert 0.0 < want["AP"] < 1.0
    assert list(got) == list(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 0.01, (key, got, want)


def test_cli_predict_defaults_to_card(cli_workdir, tmp_path):
    """`predict` without --device runs on the card: one B1 launch, people
    printed, the drawing written."""
    out_png = tmp_path / "out.png"
    kernels.reset_launches()
    people = json.loads(_cli_stdout(
        ["predict", "--model-dir", cli_workdir["model"], "--image",
         cli_workdir["image"], "--output", str(out_png)]))
    assert kernels.LAUNCHES == {decode.KERNEL: 1}
    assert people and all(len(p["keypoints"]) == 17 for p in people)
    drawn, image = read_image(out_png), read_image(cli_workdir["image"])
    assert drawn.shape == image.shape and (drawn != image).any()


FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"


def test_cli_eval_batched_on_jpeg_fixtures_matches_cpu(cli_workdir):
    """`eval --batched` on the committed JPEG scenes (every sampling cv2
    writes; read through the host C library) on the card, TF32 off: the
    CPU's stats within 0.01, with exactly one B1 launch a batch of 8 (10
    images: 2) and no other kernel."""
    argv = ["eval", "--model-dir", cli_workdir["model"], "--coco-json",
            str(FIXTURES / "annotations.json"), "--image-dir",
            str(FIXTURES), "--batched", "--batch-size", "8"]
    want = json.loads(_cli_stdout(argv + ["--device", "cpu"]))
    with no_tf32():
        kernels.reset_launches()
        got = json.loads(_cli_stdout(argv))
        assert kernels.LAUNCHES == {decode.KERNEL: 2}
    assert list(got) == list(want)
    for key in want:
        assert np.isfinite(got[key])
        assert abs(got[key] - want[key]) <= 0.01, (key, got, want)


# --- training on the card ------------------------------------------------------


def _tiny_train_config(dtype="float32", **train):
    """`__graft_entry__._tiny_config`'s shapes at 128², batch 8."""
    cfg = Config()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, backbone_width=0.25, fpn_channels=32,
            head_channels=32, kp_head_convs=1, kp_smooth_pyramid=False,
            kp_p2_late=True, stem_stride=4, compute_dtype=dtype),
        detector=dataclasses.replace(cfg.detector, pre_nms_top_k=100,
                                     max_detections=8, score_threshold=0.0),
        prn=dataclasses.replace(cfg.prn, crop_height=14, crop_width=10,
                                hidden_units=64, max_persons=8),
        decode=dataclasses.replace(cfg.decode, max_peaks_per_channel=4),
        train=dataclasses.replace(cfg.train, image_size=128, batch_size=8,
                                  num_steps=10, warmup_steps=2, **train))


def _train_batches(n):
    from multiposenet_tpu_torch.data.loader import make_batch

    records = make_dataset(8 * n, img_h=160, img_w=192, seed=2)
    rng = np.random.RandomState(0)
    return [make_batch(records[8 * i:8 * i + 8], 128, 8, rng)
            for i in range(n)]


@contextlib.contextmanager
def _no_tf32():
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def test_train_step_on_card_matches_cpu(cuda_device):
    """Two steps of the tiny float32 config (the same parameters: lr is 0
    at the first update), TF32 off: losses to 1e-4 relative, batch
    statistics to 1e-5, the gradient norm to 1e-2 (chip_smoke.py's
    `phase_train_parity` says why)."""
    import copy

    from multiposenet_tpu_torch.models.posenet import MultiPoseNet
    from multiposenet_tpu_torch.train import steps

    cfg = _tiny_train_config()
    model = MultiPoseNet(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    batches = _train_batches(2)
    runs = []
    with _no_tf32():
        for device in (cuda_device, torch.device("cpu")):
            state = steps.create_train_state(cfg, model=copy.deepcopy(model),
                                             device=device)
            step = steps.make_train_step(cfg)
            out = []
            for b in batches:
                state, m = step(state, steps.batch_to(b, device))
                out.append(({k: float(v) for k, v in m.items()},
                            {k: v.cpu().clone() for k, v in
                             state.batch_stats.items()}))
            runs.append(out)
    for (gm, gs), (wm, ws) in zip(*runs):
        for k, v in wm.items():
            tol = 1e-2 if k == "grad_norm" else 1e-4
            assert abs(gm[k] - v) <= tol * abs(v), k
        for k, v in ws.items():
            assert float((gs[k] - v).abs().max()) <= 1e-5, k


def test_train_step_bf16_on_card_is_finite(cuda_device):
    from multiposenet_tpu_torch.train import steps

    cfg = _tiny_train_config("bfloat16")
    state = steps.create_train_state(cfg, 0, device=cuda_device)
    step = steps.make_train_step(cfg)
    for b in _train_batches(2):
        state, m = step(state, steps.batch_to(b, cuda_device))
        assert all(np.isfinite(float(v)) for v in m.values())
    assert state.step == 2


def test_checkpoint_resume_on_card(cuda_device, tmp_path):
    from multiposenet_tpu_torch.train import loop
    from multiposenet_tpu_torch.train.checkpoints import CheckpointManager

    cfg = _tiny_train_config(checkpoint_dir=str(tmp_path / "ckpt"),
                             save_interval_steps=100)
    batches = _train_batches(3)
    first = loop.train(cfg, iter(batches[:2]), 2)
    assert first.params["backbone.stem.conv.kernel"].is_cuda
    saved = {k: v.cpu() for k, v in first.ema_params.items()}
    resumed = loop.train(cfg, iter(batches[2:]), 2)   # nothing left to do
    assert resumed.step == 2
    for k, v in resumed.ema_params.items():
        assert torch.equal(v.cpu(), saved[k]), k
    third = loop.train(cfg, iter(batches[2:]), 3)
    assert third.step == 3
    assert CheckpointManager(tmp_path / "ckpt").all_steps() == [1, 2, 3]


def test_cli_train_then_predict_launches_b1_once(cuda_device, tmp_path):
    cfg = _tiny_train_config(checkpoint_dir=str(tmp_path / "ckpt"),
                             log_interval_steps=1)
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["train", "--synthetic", "16", "--steps", "2", "--config",
                  str(tmp_path / "cfg.json"), "--model-dir",
                  str(tmp_path / "model")])
    assert [json.loads(line)["step"] for line in out.getvalue().splitlines()
            if line.startswith("{")] == [1, 2]
    pred = export.load_predictor(tmp_path / "model")
    assert pred.device.type == "cuda"
    image = make_dataset(1, img_h=200, img_w=240, seed=9)[0]["image"]
    kernels.reset_launches()
    pred.predict(image)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {decode.KERNEL: 1}


def test_c_decoder_reads_past_baseline_fixtures_as_cv2():
    """The progressive, Adobe RGB, CMYK, YCCK and truncated fixtures, and
    the arithmetic-coded, lossless and block-smoothed ones, decode to
    cv2's committed digests (this machine may have no cv2)."""
    import hashlib

    fixtures = Path(__file__).resolve().parent / "fixtures" / "images"
    digests = json.loads((fixtures / "digests.json").read_text())
    names = [n for n in digests if n.startswith("c3_")]
    assert len(names) == 14
    for name in names:
        rgb = read_image(fixtures / name)
        assert list(rgb.shape) == digests[name]["shape"], name
        assert hashlib.sha256(rgb.tobytes()).hexdigest() \
            == digests[name]["rgb_sha256"], name


def test_jpeg_encode_matches_the_cv2_digest():
    """The JPEG writer on the timing photo's pixels: the host C library and
    the plain NumPy encoder write the bytes whose sha256 cv2.imencode's
    had (recorded by tests/make_image_fixtures.py; no cv2 is needed)."""
    import hashlib

    from multiposenet_tpu_torch.utils import image_io, jpeg

    fixtures = Path(__file__).resolve().parent / "fixtures" / "images"
    name = "photo_480x640_q95_420.jpg"
    want = json.loads((fixtures / "digests.json").read_text())[name][
        "imencode_sha256"]
    rgb = read_image(fixtures / name)
    data = image_io.encode_jpeg(rgb)
    assert hashlib.sha256(data).hexdigest() == want
    assert jpeg.encode_pixels(rgb) == data


def test_normalization_on_card_equals_cpu(cuda_device):
    """The input normalization computes the JAX package's compiled
    arithmetic (uint8 through the table, floats through a float64
    multiply-add, the letterbox's fused blends) and gives the card the
    CPU's bits: every uint8 value of every channel, s2d- and s4-flat
    batches, and a letterboxed 480x640 image."""
    from multiposenet_tpu_torch.ops import image

    imgs = np.random.RandomState(9).randint(0, 256, (2, 64, 96, 3)).astype(
        np.uint8)
    photo = torch.as_tensor(np.random.RandomState(10).randint(
        0, 256, (480, 640, 3)).astype(np.uint8))
    cases = [
        (image.normalize, torch.arange(256, dtype=torch.uint8)[:, None]
         .repeat(1, 3)),
        (image.normalize_s2d_flat,
         torch.as_tensor(image.space_to_depth_flat(imgs))),
        (image.normalize_s4_flat,
         torch.as_tensor(image.space_to_depth_flat4(imgs))),
        (lambda x: image.resize_pad_normalize(x, 512)[0], photo),
        (lambda x: image.resize_pad_normalize(x, 512, False)[0], photo)]
    for fn, x in cases:
        got = fn(x.to(cuda_device))
        assert got.is_cuda and torch.equal(got.cpu(), fn(x))


def test_decode_kernel_on_a_second_card(cuda_device):
    """B1 on cuda:1 (the SM count asked of that card, not cached from the
    first): equal to the plain version, counted on card 1."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card")
    cfg = DecodeConfig()
    x = torch.as_tensor(planted_maps(np.random.RandomState(0),
                                     (2, 128, 128, 17)))
    x = x.permute(0, 3, 1, 2).contiguous().to(torch.device("cuda", 1))
    kernels.reset_launches()
    got = decode.decode_maps(x, cfg)
    torch.cuda.synchronize(1)
    assert kernels.LAUNCHES_BY_DEVICE == {(decode.KERNEL, 1): 1}
    want = decode.decode_maps_plain(x.reshape(-1, 128, 128), cfg)
    assert torch.equal(got[0].cpu(), want[0].cpu())


def test_sharded_runner_launches_on_every_card(cuda_device):
    """`make_batch_runner()` over every visible card: one B1 launch a card
    and batch, the outputs those of `batch_forward` (exactly, on one
    card)."""
    from multiposenet_tpu_torch.config import ModelConfig

    cfg = Config(model=ModelConfig(backbone_width=0.25, fpn_channels=32,
                                   head_channels=32))
    pred = Predictor(cfg, image_size=128)
    cards = torch.cuda.device_count()
    images = np.random.RandomState(0).randint(
        0, 255, (2 * cards, 128, 128, 3), dtype=np.uint8)
    run = pred.make_batch_runner()
    kernels.reset_launches()
    got = run(images)
    for i in range(cards):
        torch.cuda.synchronize(i)
    assert kernels.LAUNCHES_BY_DEVICE == {(decode.KERNEL, i): 1
                                          for i in range(cards)}
    if cards == 1:
        want = pred.batch_forward(images)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def _update_state(gen, shapes, scale):
    """Seeded float32 tensors, one element in 50 a float32 subnormal."""
    out = []
    for s in shapes:
        x = scale * torch.randn(s, generator=gen)
        tiny = torch.rand(s, generator=gen) < 0.02
        out.append(torch.where(tiny, 1e-39 * torch.randn(s, generator=gen),
                               x))
    return out


@pytest.mark.parametrize("case", ["adamw_above_clip", "adamw_below_clip",
                                  "adam"])
def test_train_update_kernels_equal_the_cpu(cuda_device, case):
    """csrc/train_update.cu (`xla_arith.adam_step`, `ema_step` on the
    card) against the plain versions on the CPU from the same float32
    inputs, bit for bit: one launch each."""
    from multiposenet_tpu_torch.train import xla_arith

    gen = torch.Generator().manual_seed(5)
    shapes = [(3,), (0,), (32, 3, 3, 3), (xla_arith.CHUNK + 7,), (64, 1000)]
    params, grads, mu = (_update_state(gen, shapes, s)
                         for s in (0.1, 1e-2, 1e-3))
    nu = [x.abs() for x in _update_state(gen, shapes, 1e-6)]
    hp = xla_arith.Adam(count=7, lr=1e-3)
    if case != "adam":
        hp = xla_arith.Adam(count=7, lr=1e-3, weight_decay=1e-4,
                            clip=0.5 if case == "adamw_above_clip" else 50.0,
                            nu_fuses_moment=True)
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        state = [[x.clone().to(device) for x in xs]
                 for xs in (params, mu, nu)]
        ema = [x.clone().to(device) for x in mu]
        kernels.reset_launches()
        norm = xla_arith.adam_step(state[0], [g.to(device) for g in grads],
                                   state[1], state[2], hp)
        xla_arith.ema_step(ema, state[0], 42 / 51, 9 / 51)
        torch.cuda.synchronize()
        runs.append(([x.cpu() for xs in state for x in xs]
                     + [x.cpu() for x in ema],
                     None if norm is None else norm.cpu(),
                     dict(kernels.LAUNCHES)))
    (got, gnorm, glaunch), (want, wnorm, wlaunch) = runs
    assert glaunch == {xla_arith.ADAM_KERNEL: 1, xla_arith.EMA_KERNEL: 1}
    assert wlaunch == {}
    if case != "adam":
        assert (float(wnorm) > hp.clip) == (case == "adamw_above_clip")
        assert gnorm.view(torch.int32) == wnorm.view(torch.int32)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_train_update_kernel_refuses_float64_on_card(cuda_device):
    from multiposenet_tpu_torch.train import xla_arith

    xs = [torch.zeros(4, dtype=torch.float64, device=cuda_device)]
    with pytest.raises(TypeError):
        xla_arith.adam_step(xs, xs, xs, xs, xla_arith.Adam(count=1, lr=1.0))
    with pytest.raises(TypeError):
        xla_arith.ema_step(xs, xs, 0.5, 0.5)
