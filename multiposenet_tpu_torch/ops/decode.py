"""Heatmap decoding: Gaussian smoothing → 3x3 peak NMS → top-P → ¼ px.

Counterpart of `multiposenet_tpu/ops/decode.py` (the jnp reference) and
`ops/decode_pallas.py` (the TPU kernel). Conventions, as there:
  * the Gaussian blur is a truncated, normalized, zero-padded separable
    filter;
  * peak NMS keeps plateau ties (value >= its 3x3 max, -inf borders);
  * the top-P per map is ordered by value descending, then flat index
    ascending (`lax.top_k`'s order); fewer than P peaks leave -inf slots;
  * the sub-pixel shift is ±`subpixel_shift` toward the larger of two
    border-clipped neighbours, per axis;
  * `valid = score > score_threshold`, and invalid scores are zeroed.

`decode_maps` is the one entry point to the work: on a CUDA tensor it
launches the hand-written kernel `csrc/decode_peaks.cu` (B1), on a CPU
tensor it runs the plain PyTorch version `decode_maps_plain`, which
repeats the kernel's arithmetic in the same order so the two agree bit for
bit. `decode_maps_lanes` computes the same function with the maps-on-lanes
kernel `csrc/decode_lanes.cu` (B2), which reads [B, K, H, W] through any
strides and is laid out for channels-last maps; it has the same plain
version and agrees with B1 bit for bit. `DECODE_LANES` selects it at the
predictor's channel-major decode, as `decode_pallas.DECODE_LANES` does in
the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.config import DecodeConfig

KERNEL = "decode_peaks"
LANES_KERNEL = "decode_lanes"
MAX_PEAKS = 16          # csrc/decode_{peaks,lanes}.cu MAX_PEAKS
MAX_TAPS = 15           # csrc/decode_{peaks,lanes}.cu MAX_TAPS
# Both kernels carry flat indices under 2**28 in their order keys.
# decode_peaks gives a lane at most 16 columns of a 32-lane warp.
# Hopper gives a block at most 232448 bytes of shared memory, less the
# kernels' small static arrays; decode_lanes keeps ntaps + 4 f32 rows of
# W + 1 for each of its 8 maps.
MAX_MAP_ELEMENTS = 2 ** 28 - 1
MAX_WIDTH = 512
SMEM_BYTES = 232448 - 1024
LANES_MAPS_PER_BLOCK = 8

# Decode the predictor's channel-major heatmaps with the maps-on-lanes
# kernel (the JAX package's decode_pallas.DECODE_LANES).
DECODE_LANES = False


class DecodedPeaks(NamedTuple):
    """Top-P peaks per keypoint channel.

    positions: [B, K, P, 2] (y, x) in heatmap coordinates, sub-pixel.
    scores:    [B, K, P] smoothed value at the peak, 0 where invalid.
    valid:     [B, K, P] bool.
    """

    positions: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor


def gaussian_kernel_1d(sigma: float, size: int) -> np.ndarray:
    """Normalized 1-D Gaussian taps of odd length `size`."""
    if size % 2 != 1:
        raise ValueError(f"smoothing kernel size must be odd; got {size}")
    half = size // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / max(sigma, 1e-8)) ** 2)
    return (k / k.sum()).astype(np.float32)


def smoothing_taps(config: DecodeConfig) -> np.ndarray:
    """The blur's taps; sigma <= 0 means no blur (one unit tap)."""
    if config.smooth_sigma <= 0:
        return np.ones((1,), np.float32)
    return gaussian_kernel_1d(config.smooth_sigma, config.smooth_kernel_size)


def _check_config(config: DecodeConfig) -> None:
    if config.nms_window != 3:
        raise ValueError(
            "the decode implements the reference 3x3 NMS window; got "
            f"nms_window={config.nms_window}"
        )


def gaussian_smooth(maps: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Zero-padded separable blur of f32 maps [N, H, W]: the vertical taps,
    then the horizontal ones, each accumulated tap by tap from a zero
    start with a separate multiply and add (the kernel's order)."""
    n, h, w = maps.shape
    half = len(taps) // 2
    xp = F.pad(maps, (0, 0, half, half))
    acc = torch.zeros_like(maps)
    for j, tap in enumerate(taps.tolist()):
        acc = acc + xp[:, j:j + h, :] * tap
    xp = F.pad(acc, (half, half))
    acc = torch.zeros_like(maps)
    for j, tap in enumerate(taps.tolist()):
        acc = acc + xp[:, :, j:j + w] * tap
    return acc


def decode_maps_plain(
    maps: torch.Tensor, config: DecodeConfig = DecodeConfig()
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: maps [N, H, W] (any float
    dtype, read as f32) → raw (scores, ys, xs), each [N, P] f32, with -inf
    scores where a map has fewer than P peaks."""
    _check_config(config)
    n, h, w = maps.shape
    p = config.max_peaks_per_channel
    sm = gaussian_smooth(maps.float(), smoothing_taps(config))
    m9 = F.max_pool2d(sm[:, None], 3, stride=1, padding=1)[:, 0]
    masked = torch.where(sm >= m9, sm, torch.full_like(sm, -torch.inf))
    vals, idx = torch.sort(masked.reshape(n, h * w), dim=1,
                           descending=True, stable=True)
    scores, idx = vals[:, :p], idx[:, :p]
    y, x = idx // w, idx % w
    flat = sm.reshape(n, h * w)

    def at(yy, xx):
        return torch.gather(flat, 1, yy.clamp(0, h - 1) * w
                            + xx.clamp(0, w - 1))

    shift = float(config.subpixel_shift)
    dy = torch.sign(at(y + 1, x) - at(y - 1, x)) * shift
    dx = torch.sign(at(y, x + 1) - at(y, x - 1)) * shift
    return scores, y.float() + dy, x.float() + dx


@functools.lru_cache(maxsize=32)
def _kernel_taps(config: DecodeConfig) -> ctypes.Array:
    """The blur's taps as the C entry points take them, made once per
    config: a request's decode should not pay for them again."""
    taps = smoothing_taps(config)
    if len(taps) > MAX_TAPS:
        raise ValueError(f"decode kernel takes at most {MAX_TAPS} taps")
    return (ctypes.c_float * len(taps))(*taps.tolist())


def _bind(fn, argtypes: list) -> None:
    """Declare a C entry point's signature, once."""
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes


def _check_kernel_args(hm: torch.Tensor,
                       config: DecodeConfig) -> ctypes.Array:
    """What both decode kernels refuse; returns the blur's taps."""
    h, w = hm.shape[2:]
    p = config.max_peaks_per_channel
    if hm.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode kernel takes f32 or bf16, got {hm.dtype}")
    if not 1 <= p <= min(MAX_PEAKS, h * w):
        raise ValueError(f"decode kernel takes 1..{MAX_PEAKS} peaks per "
                         f"map (and at most H*W); got {p}")
    return _kernel_taps(config)


def launch_cuda(
    hm_cm: torch.Tensor, config: DecodeConfig, lib: ctypes.CDLL | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check hm_cm [B, K, H, W] and launch the C entry point `decode_peaks`
    of `lib`, a build of csrc/decode_peaks.cu (the package's own, built
    after the checks pass, when None); raises on a launch error. Counts no
    launch."""
    b, k, h, w = hm_cm.shape
    p = config.max_peaks_per_channel
    taps = _check_kernel_args(hm_cm, config)
    # Strides of size-1 dims are arbitrary and never used.
    if any(n > 1 and stride != want for n, stride, want in zip(
            (k, h, w), hm_cm.stride()[1:], (h * w, w, 1))):
        raise ValueError(
            "decode kernel needs each [K, H, W] block contiguous; got "
            f"strides {hm_cm.stride()}"
        )
    if w > MAX_WIDTH or h * w > MAX_MAP_ELEMENTS:
        raise ValueError(f"decode kernel takes maps at most {MAX_WIDTH} "
                         f"wide with flat indices under 2**28; got {h}x{w}")
    fn = (lib or kernels.load(KERNEL)).decode_peaks
    _bind(fn, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ])
    out = torch.empty((3, b * k, p), dtype=torch.float32,
                      device=hm_cm.device)
    ptr, plane = out.data_ptr(), b * k * p * 4
    with torch.cuda.device(hm_cm.device):
        stream = torch.cuda.current_stream(hm_cm.device).cuda_stream
        err = fn(
            hm_cm.data_ptr(), 1 if hm_cm.dtype == torch.bfloat16 else 0,
            hm_cm.stride(0), b, k, h, w, taps, len(taps),
            float(config.subpixel_shift), p, ptr, ptr + plane,
            ptr + 2 * plane, stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_peaks launch failed: CUDA error {err}")
    return out[0], out[1], out[2]


def _decode_maps_cuda(
    hm_cm: torch.Tensor, config: DecodeConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/decode_peaks.cu on hm_cm [B, K, H, W] and count it."""
    out = launch_cuda(hm_cm, config)
    kernels.count_launch(KERNEL)
    return out


def decode_maps(
    hm_cm: torch.Tensor, config: DecodeConfig = DecodeConfig()
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Channel-major heatmaps [B, K, H, W] → raw (scores, ys, xs), each
    [B*K, P] f32. On a CUDA tensor this launches the kernel (or raises);
    on a CPU tensor it runs the plain version."""
    _check_config(config)
    if hm_cm.is_cuda:
        return _decode_maps_cuda(hm_cm, config)
    b, k, h, w = hm_cm.shape
    return decode_maps_plain(hm_cm.reshape(b * k, h, w), config)


def _decode_maps_lanes_cuda(
    hm: torch.Tensor, config: DecodeConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/decode_lanes.cu on hm [B, K, H, W], any strides."""
    b, k, h, w = hm.shape
    p = config.max_peaks_per_channel
    taps = _check_kernel_args(hm, config)
    if h * w > MAX_MAP_ELEMENTS:
        raise ValueError(f"map {h}x{w} has flat indices over 2**28")
    if (len(taps) + 4) * LANES_MAPS_PER_BLOCK * (w + 1) * 4 > SMEM_BYTES:
        raise ValueError(f"map width {w} does not fit the lanes kernel's "
                         "shared memory")
    # Rows are read along the maps where the map stride is the smaller.
    lanes_load = int(k > 1 and hm.stride(1) < hm.stride(3))
    fn = kernels.load(LANES_KERNEL).decode_lanes
    _bind(fn, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ])
    out = torch.empty((3, b * k, p), dtype=torch.float32, device=hm.device)
    with torch.cuda.device(hm.device):
        stream = torch.cuda.current_stream(hm.device).cuda_stream
        err = fn(
            hm.data_ptr(), 1 if hm.dtype == torch.bfloat16 else 0,
            *hm.stride(), b, k, h, w, taps, len(taps),
            float(config.subpixel_shift), p, lanes_load,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_lanes launch failed: CUDA error {err}")
    kernels.count_launch(LANES_KERNEL)
    return out[0], out[1], out[2]


def decode_maps_lanes(
    hm: torch.Tensor, config: DecodeConfig = DecodeConfig()
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Heatmaps [B, K, H, W] in any layout (channels-last is the kernel's
    fast one) → raw (scores, ys, xs), each [B*K, P] f32, equal to
    `decode_maps`. On a CUDA tensor this launches the maps-on-lanes kernel
    (or raises); on a CPU tensor it runs the plain version."""
    _check_config(config)
    if hm.is_cuda:
        return _decode_maps_lanes_cuda(hm, config)
    b, k, h, w = hm.shape
    return decode_maps_plain(hm.reshape(b * k, h, w), config)


def _peaks(raw: tuple[torch.Tensor, torch.Tensor, torch.Tensor], b: int,
           k: int, config: DecodeConfig) -> DecodedPeaks:
    """Raw [B*K, P] kernel outputs → DecodedPeaks, with the threshold
    applied as decode_pallas.decode_heatmaps_pallas_t does."""
    scores, ys, xs = (t.reshape(b, k, -1) for t in raw)
    valid = scores > config.score_threshold
    return DecodedPeaks(
        positions=torch.stack([ys, xs], dim=-1),
        scores=torch.where(valid, scores, torch.zeros_like(scores)),
        valid=valid,
    )


def decode_heatmaps_cm(
    hm_cm: torch.Tensor, config: DecodeConfig = DecodeConfig()
) -> DecodedPeaks:
    """Decode channel-major heatmaps [B, K, H, W] → DecodedPeaks (B1)."""
    return _peaks(decode_maps(hm_cm, config), *hm_cm.shape[:2], config)


def decode_heatmaps_lanes(
    hm: torch.Tensor, config: DecodeConfig = DecodeConfig()
) -> DecodedPeaks:
    """Decode heatmaps [B, K, H, W] in any layout with the maps-on-lanes
    kernel (B2) → DecodedPeaks, equal to `decode_heatmaps_cm`."""
    return _peaks(decode_maps_lanes(hm, config), *hm.shape[:2], config)


def decode_heatmaps(
    heatmaps: torch.Tensor, config: DecodeConfig = DecodeConfig()
) -> DecodedPeaks:
    """Decode [B, H, W, K] heatmaps (the JAX package's layout)."""
    return decode_heatmaps_cm(heatmaps.permute(0, 3, 1, 2).contiguous(),
                              config)
