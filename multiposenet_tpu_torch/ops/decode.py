"""Heatmap decoding: Gaussian smoothing → peak NMS → top-P → ¼ px.

Counterpart of `multiposenet_tpu/ops/decode.py` (the jnp reference) and
`ops/decode_pallas.py` (the TPU kernel). Conventions, as there:
  * the Gaussian blur is a truncated, normalized, zero-padded separable
    filter;
  * peak NMS keeps plateau ties (value >= the max of its `nms_window`
    square, -inf borders; an even window reaches one cell further right
    and down than left and up, as XLA's SAME padding does);
  * the top-P per map is ordered by value descending, then flat index
    ascending (`lax.top_k`'s order); fewer than P peaks leave -inf slots;
  * the sub-pixel shift is ±`subpixel_shift` toward the larger of two
    border-clipped neighbours, per axis;
  * `valid = score > score_threshold`, and invalid scores are zeroed;
  * NaN propagates as in the JAX package: a window that holds a NaN has a
    NaN max, so its centre is no peak, and a NaN neighbour makes the
    sub-pixel step NaN.

`decode_maps` is the one entry point to the work: on a CPU tensor it runs
the plain PyTorch version `decode_maps_plain`; on a CUDA tensor it
launches a hand-written kernel, chosen by `route` from the config and the
shape before anything is built: `csrc/decode_peaks.cu` (B1) where B1
takes the input, else `csrc/decode_generic.cu`, which takes every config
the plain version takes (its launch plan is `generic_launch_plan`).
`decode_maps_lanes` computes the same function with the maps-on-lanes
kernel `csrc/decode_lanes.cu` (B2), which reads
[B, K, H, W] through any strides (channel-major and channels-last are its
fast layouts), or with the generic kernel where B2 does not take the
input. `DECODE_LANES` selects it at the predictor's channel-major decode,
as `decode_pallas.DECODE_LANES` does in the JAX package. Every kernel
repeats the plain version's arithmetic in the same order, so all of them
agree with it bit for bit.
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
GENERIC_KERNEL = "decode_generic"
MAX_PEAKS = 16          # csrc/decode_rows.cuh MAX_PEAKS (B1 and B2)
MAX_TAPS = 15           # csrc/decode_rows.cuh MAX_TAPS
# Every decode kernel carries flat indices under 2**28 in its order keys.
# B1 and B2 give a lane at most 16 columns of a 32-lane warp.
MAX_MAP_ELEMENTS = 2 ** 28 - 1
MAX_WIDTH = 512
# csrc/decode_generic.cu's launch plan: its constants (the names after `k`
# there) and the order of the fields `decode_generic_plan` returns (struct
# Plan).
GENERIC_PLAN_FIELDS = ("path", "tile_rows", "tile_cols", "row_tiles",
                       "col_tiles", "cluster", "grid", "cap", "rounds",
                       "smem_bytes")
MAX_CLUSTER = 8
CTAS_PER_SM = 16
TILE_COLS = 128
TILE_ELEMS = 4096
TILE_ELEMS_LONG = 8192
MAX_DYN_SMEM = 228352
MAX_CLUSTERS = 2 ** 26
LIST_SHORT = 8
LIST_LONG = 32
H100_SMS = 132

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
    if config.nms_window < 1:
        raise ValueError(
            f"nms_window must be at least 1; got {config.nms_window}")


def window_max(sm: torch.Tensor, window: int) -> torch.Tensor:
    """Max of each element's `window` square in f32 maps [N, H, W], -inf
    outside the map: rows and columns -(window-1)//2 .. window//2 around
    it (XLA's SAME padding of the JAX package's reduce_window)."""
    lo, hi = (window - 1) // 2, window // 2
    padded = F.pad(sm[:, None], (lo, hi, lo, hi), value=-torch.inf)
    return F.max_pool2d(padded, window, stride=1)[:, 0]


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
    peak = sm >= window_max(sm, config.nms_window)
    masked = torch.where(peak, sm, torch.full_like(sm, -torch.inf))
    vals, idx = torch.sort(masked.reshape(n, h * w), dim=1,
                           descending=True, stable=True)
    scores, idx = vals[:, :p], idx[:, :p]
    y, x = idx // w, idx % w
    flat = sm.reshape(n, h * w)

    def at(yy, xx):
        return torch.gather(flat, 1, yy.clamp(0, h - 1) * w
                            + xx.clamp(0, w - 1))

    def sign(d):  # jnp.sign's: NaN stays NaN (torch.sign gives 0)
        return torch.where(d.isnan(), d, torch.sign(d))

    shift = float(config.subpixel_shift)
    dy = sign(at(y + 1, x) - at(y - 1, x)) * shift
    dx = sign(at(y, x + 1) - at(y, x - 1)) * shift
    return scores, y.float() + dy, x.float() + dx


def _tile_smem(th: int, tw: int, n_taps: int, window: int) -> int:
    """Dynamic shared memory of a th x tw tile of the generic kernel: the
    taps, the raw region with its halos (then the blurred one) and the
    vertical pass (then the row max), f32, and a byte of mask an
    element."""
    half = n_taps // 2
    bl, bh = max((window - 1) // 2, 1), max(window // 2, 1)
    sh, sw = th + bl + bh, tw + bl + bh
    rh, rw = sh + 2 * half, sw + 2 * half
    return 4 * (-(-n_taps // 4) * 4 + rh * rw + sh * rw) + th * tw


@functools.lru_cache(maxsize=256)
def generic_launch_plan(n_maps: int, h: int, w: int, n_taps: int,
                        window: int, p: int, sms: int = H100_SMS) -> dict:
    """The launch plan csrc/decode_generic.cu (`make_plan`) takes for
    n_maps maps of h x w with n_taps taps, the peak window and p peaks on
    a card of `sms` SMs. A map is cut into tiles of at most 128 columns
    (evenly) and of rows, at most 4096 elements a tile (8192 for p > 8,
    whose lists of 32 keys hold a block to 2 an SM), into as many tiles
    as the cluster that shares the map wants: about 16 blocks an SM over
    all maps, at most 8 a map. Tiles too big for shared memory with their
    halos are halved, rows first; where even one element does not fit
    (taps or windows of a few hundred), path 1 decodes a map a block
    through a workspace. Lists hold 8 keys for p <= 8, else 32, taken in
    ceil(p / 32) rounds. The grid is clusters of `cluster` blocks, at most
    one cluster a map."""
    want = min(max(-(-(sms * CTAS_PER_SM) // n_maps), 1), MAX_CLUSTER)
    tile_elems = TILE_ELEMS if p <= LIST_SHORT else TILE_ELEMS_LONG
    col_tiles = -(-w // TILE_COLS)
    tw = -(-w // col_tiles)
    max_rows = max(1, tile_elems // tw)
    row_tiles = max(-(-h // max_rows), min(h, -(-want // col_tiles)))
    th = -(-h // row_tiles)
    while (_tile_smem(th, tw, n_taps, window) > MAX_DYN_SMEM
           and (th > 1 or tw > 1)):
        if th > 1:
            th = (th + 1) // 2
        else:
            tw = (tw + 1) // 2
    if _tile_smem(th, tw, n_taps, window) > MAX_DYN_SMEM:
        return {"path": 1, "tile_rows": h, "tile_cols": w, "row_tiles": 1,
                "col_tiles": 1, "cluster": 1, "grid": n_maps, "cap": 0,
                "rounds": p, "smem_bytes": 0}
    row_tiles, col_tiles = -(-h // th), -(-w // tw)
    cluster = min(row_tiles * col_tiles, want)
    cap = LIST_SHORT if p <= LIST_SHORT else LIST_LONG
    return {"path": 0, "tile_rows": th, "tile_cols": tw,
            "row_tiles": row_tiles, "col_tiles": col_tiles,
            "cluster": cluster,
            "grid": min(n_maps, MAX_CLUSTERS) * cluster, "cap": cap,
            "rounds": -(-p // cap),
            "smem_bytes": _tile_smem(th, tw, n_taps, window)}


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=32)
def _kernel_taps(config: DecodeConfig) -> ctypes.Array:
    """The blur's taps as the C entry points take them, made once per
    config: a request's decode should not pay for them again."""
    taps = smoothing_taps(config)
    return (ctypes.c_float * len(taps))(*taps.tolist())


def _bind(fn, argtypes: list) -> None:
    """Declare a C entry point's signature, once."""
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes


@functools.lru_cache(maxsize=32)
def _n_taps(config: DecodeConfig) -> int:
    return len(smoothing_taps(config))


def _refusal(hm: torch.Tensor, config: DecodeConfig,
             kernel: str) -> Exception | None:
    """Why `kernel` does not take maps hm [B, K, H, W] with `config`, or
    None where it does. Decided from the dtype, the shape, the strides and
    the config alone. The generic kernel takes f32 or bf16 maps of any
    layout with 1 <= P <= H*W and flat indices under 2**28; B1 and B2 take
    the 3x3 peak window, at most 16 peaks and 15 taps and maps at most 512
    wide besides, B1 in contiguous [K, H, W] blocks only."""
    b, k, h, w = hm.shape
    p = config.max_peaks_per_channel
    if hm.dtype not in (torch.float32, torch.bfloat16):
        return TypeError(f"decode kernel takes f32 or bf16, got {hm.dtype}")
    if h * w > MAX_MAP_ELEMENTS:
        return ValueError(f"decode kernel takes flat indices under 2**28; "
                          f"got {h}x{w}")
    if kernel == GENERIC_KERNEL:
        if not 1 <= p <= h * w:
            return ValueError(f"decode kernel takes 1..H*W peaks per map; "
                              f"got {p} for {h}x{w}")
        return None
    if config.nms_window != 3:
        return ValueError("decode kernel implements the 3x3 peak window; "
                          f"got nms_window={config.nms_window}")
    if not 1 <= p <= min(MAX_PEAKS, h * w):
        return ValueError(f"decode kernel takes 1..{MAX_PEAKS} peaks per "
                          f"map (and at most H*W); got {p}")
    if _n_taps(config) > MAX_TAPS:
        return ValueError(f"decode kernel takes at most {MAX_TAPS} taps")
    if kernel == KERNEL:
        # Strides of size-1 dims are arbitrary and never used.
        if any(n > 1 and stride != want for n, stride, want in zip(
                (k, h, w), hm.stride()[1:], (h * w, w, 1))):
            return ValueError(
                "decode kernel needs each [K, H, W] block contiguous; got "
                f"strides {hm.stride()}")
    if w > MAX_WIDTH:
        return ValueError(f"decode kernel takes maps at most {MAX_WIDTH} "
                          f"wide; got {h}x{w}")
    return None


def route(hm: torch.Tensor, config: DecodeConfig,
          lanes: bool = False) -> str:
    """The kernel that decodes CUDA maps hm [B, K, H, W] with `config`:
    B1 (`decode_maps`) or B2 (`decode_maps_lanes`, lanes=True) where it
    takes them, else the generic kernel. Nothing is built to decide."""
    kernel = LANES_KERNEL if lanes else KERNEL
    return GENERIC_KERNEL if _refusal(hm, config, kernel) else kernel


def _raise_refusal(hm: torch.Tensor, config: DecodeConfig,
                   kernel: str) -> None:
    err = _refusal(hm, config, kernel)
    if err is not None:
        raise err


def launch_cuda(
    hm_cm: torch.Tensor, config: DecodeConfig, lib: ctypes.CDLL | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check hm_cm [B, K, H, W] and launch the C entry point `decode_peaks`
    of `lib`, a build of csrc/decode_peaks.cu (the package's own, built
    after the checks pass, when None); raises on a launch error. Counts no
    launch."""
    b, k, h, w = hm_cm.shape
    p = config.max_peaks_per_channel
    _raise_refusal(hm_cm, config, KERNEL)
    taps = _kernel_taps(config)
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
    kernels.count_launch(KERNEL, hm_cm.device)
    return out


def launch_lanes_cuda(
    hm: torch.Tensor, config: DecodeConfig, lib: ctypes.CDLL | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check hm [B, K, H, W] (any strides) and launch the C entry point
    `decode_lanes` of `lib`, a build of csrc/decode_lanes.cu (the
    package's own, built after the checks pass, when None); raises on a
    launch error. Counts no launch."""
    b, k, h, w = hm.shape
    p = config.max_peaks_per_channel
    _raise_refusal(hm, config, LANES_KERNEL)
    taps = _kernel_taps(config)
    # Rows are read along the maps where the map stride is the smaller.
    lanes_load = int(k > 1 and hm.stride(1) < hm.stride(3))
    fn = (lib or kernels.load(LANES_KERNEL)).decode_lanes
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
    return out[0], out[1], out[2]


def _decode_maps_lanes_cuda(
    hm: torch.Tensor, config: DecodeConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/decode_lanes.cu on hm [B, K, H, W] and count it."""
    out = launch_lanes_cuda(hm, config)
    kernels.count_launch(LANES_KERNEL, hm.device)
    return out


@functools.lru_cache(maxsize=32)
def _device_taps(config: DecodeConfig, device: torch.device) -> torch.Tensor:
    """The blur's taps in device memory, made once per config and card."""
    return torch.as_tensor(smoothing_taps(config), device=device)


def launch_generic_cuda(
    hm: torch.Tensor, config: DecodeConfig, lib: ctypes.CDLL | None = None,
    workspace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check hm [B, K, H, W] (any strides) and launch the C entry point
    `decode_generic` of `lib`, a build of csrc/decode_generic.cu (the
    package's own, built after the checks pass, when None); raises on a
    launch error. Counts no launch. It takes every config the plain
    version takes; only plans of path 1 (taps or windows too wide for
    shared memory) get a workspace of two f32 [B*K, H, W] planes, or
    every launch with workspace=True (a build of the design before the
    tiles, which always needed it, for tools/decode_phases.py)."""
    b, k, h, w = hm.shape
    p = config.max_peaks_per_channel
    _raise_refusal(hm, config, GENERIC_KERNEL)
    fn = (lib or kernels.load(GENERIC_KERNEL)).decode_generic
    _bind(fn, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ])
    taps = _device_taps(config, hm.device)
    plan = generic_launch_plan(b * k, h, w, len(taps), config.nms_window, p,
                               _sm_count(hm.device))
    work = (torch.empty((2, b * k, h, w), dtype=torch.float32,
                        device=hm.device)
            if workspace or plan["path"] == 1 else None)
    out = torch.empty((3, b * k, p), dtype=torch.float32, device=hm.device)
    with torch.cuda.device(hm.device):
        stream = torch.cuda.current_stream(hm.device).cuda_stream
        err = fn(
            hm.data_ptr(), 1 if hm.dtype == torch.bfloat16 else 0,
            *hm.stride(), b, k, h, w, taps.data_ptr(), len(taps),
            config.nms_window, float(config.subpixel_shift), p,
            None if work is None else work.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_generic launch failed: CUDA error {err}")
    return out[0], out[1], out[2]


def _decode_maps_generic_cuda(
    hm: torch.Tensor, config: DecodeConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch csrc/decode_generic.cu on hm [B, K, H, W] and count it."""
    out = launch_generic_cuda(hm, config)
    kernels.count_launch(GENERIC_KERNEL, hm.device)
    return out


# The counting wrapper of each kernel that `route` names.
_CUDA_DECODES = {KERNEL: _decode_maps_cuda,
                 LANES_KERNEL: _decode_maps_lanes_cuda,
                 GENERIC_KERNEL: _decode_maps_generic_cuda}


def decode_maps(
    hm_cm: torch.Tensor, config: DecodeConfig = DecodeConfig()
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Channel-major heatmaps [B, K, H, W] → raw (scores, ys, xs), each
    [B*K, P] f32. On a CUDA tensor this launches B1 or, where B1 does not
    take the input, the generic kernel (or raises); on a CPU tensor it
    runs the plain version."""
    _check_config(config)
    if hm_cm.is_cuda:
        return _CUDA_DECODES[route(hm_cm, config)](hm_cm, config)
    b, k, h, w = hm_cm.shape
    return decode_maps_plain(hm_cm.reshape(b * k, h, w), config)


def decode_maps_lanes(
    hm: torch.Tensor, config: DecodeConfig = DecodeConfig()
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Heatmaps [B, K, H, W] in any layout (channels-last is the kernel's
    fast one) → raw (scores, ys, xs), each [B*K, P] f32, equal to
    `decode_maps`. On a CUDA tensor this launches the maps-on-lanes kernel
    or, where it does not take the input, the generic kernel (or raises);
    on a CPU tensor it runs the plain version."""
    _check_config(config)
    if hm.is_cuda:
        return _CUDA_DECODES[route(hm, config, lanes=True)](hm, config)
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
