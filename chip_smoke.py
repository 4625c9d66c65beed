"""Smoke test of the PyTorch port (`multiposenet_tpu_torch`) on one NVIDIA
GPU: builds the hand-written CUDA kernels from `csrc/` (B1 decode_peaks,
B2 decode_lanes, decode_generic, B3 kp_tail, B4 column_topk), holds each
against its plain PyTorch version at the shapes its paths give it (B2
also against B1, bit for bit; B1 on bf16 and on float32 maps; B4 at the
decode micro-benchmark's 2176 maps, on column 0 and on every column, in
phase `column_topk_kernel`), holds the float32 forwards of
Config.fast(), of the served Config.crowd() model (BN folded, fused
tail) and of Config() on the card against the same weights on the CPU,
then drives three paths at full width (512² input, 128²
heatmaps) through `Predictor.batch_forward`: Config.fast() (B1, batch
128), Config.crowd() with BN folded, the fused tail and the
maps-on-lanes decode (B3 and B2, batch 128), and Config() in float32 on
s2d-flat batches of 64 (B1). It serves `predict` requests on the first,
`predict`, `predict_keypoints` and `predict_given_boxes` on the second,
`predict` with a 5x5 peak window through the generic decode kernel, and
`predict` on Config() with flip test-time augmentation and pose NMS (B1);
the Config() predictor is exported and loaded back onto the card, bit
for bit. Phase `dbench2` drives the decode micro-benchmark's path,
`multiposenet_tpu_torch.tools.dbench2.run` (B4 and B1 on 2176 maps).
Last, the command line in this process on an exported full-width
Config.fast() model: `eval` over 256 synthetic images, batched (host
resize, batches of 128, two B1 launches) and through `predict` (32
images, 32 launches), with images per second and the batched loop's
split (phases `eval_batched`, `eval_predict`), then `predict --output`
on a 480x640 PNG, read back (phase `cli_predict`, one launch). Before
them, phase `image_codec` builds the host C library (`csrc/image_codec.c`)
and holds its JPEG decode and letterbox resize, and the plain NumPy
versions, to cv2's digests of the committed fixtures
(tests/fixtures/images); after them, phase `eval_jpeg` runs `eval
--batched` on those JPEGs (two launches), `predict` on the 480x640 JPEG
(one launch) and checks that `--output x.jpg` exits. Then training, which
reaches no TPU kernel (the fused tail is off in training and the decodes
are inference only): phase `train_parity` holds 3 steps of the tiny
config in float32 on the card against the CPU and fits one batch in 20
steps; `train_default` times Config() at 512², batch 32, fed by the
port's `batch_iterator` with augmentation, and `train_fast` Config.fast()
in bfloat16 at batch 64; `train_cli` runs `train` in this process, resumes
it, and serves the exported model with one `predict` (one B1 launch).
Then the segmentation masks and the PRN trainer: `prepare_masks` runs
`prepare --coco-json` on the segmentation fixture, reads the shards back
and trains 3 steps of Config() at 512², batch 32, on masked batches
through `train.loop.train` (the tiny config's masked steps held card
against CPU in lockstep); `train_prn` runs `train-prn` at the default
PRN into `train_cli`'s export and serves it with one `predict` (one B1
launch), times the PRN step at full width and holds the tiny PRN card
against CPU; `profile_train` traces 2 steps of `train_default` with
`utils/profiling.trace` and prints the 10 device kernels with the most
time and the device's idle share.

    python3 chip_smoke.py

Each phase prints one JSON line; the line before the last lists every
kernel with its launches on the main path, its error against the plain
version and its times; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": <card>, "count": N}}.
Any failed check raises, so the script then exits non-zero without that
line. It needs a CUDA device and the repository beside it; it imports no
JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the dense bf16
# tensor-core rate (the tail's products are bf16 operations). The data
# sheet's 67 TFLOP/s of float32 counts an FMA as two operations; the
# decode kernels may not fuse (each tap is a separate multiply and add),
# so their operations issue at most one per lane and clock: 132 SMs x 128
# lanes x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
F32_NO_FMA_OPS_PER_S = 132 * 128 * 1.98e9
BF16_OPS_PER_S = 989e12
BATCH, IMAGE = 128, 512
# Config()'s batch: BASELINE.json config 5 runs the default model at 64.
DEFAULT_BATCH = 64


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, rounds: int) -> float:
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    from CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def planted_scenes(rng: np.random.RandomState, n: int, h: int,
                   w: int) -> np.ndarray:
    """uint8 [n, h, w, 3]: dark noise plus ten bright Gaussian blobs per
    image, so the decode finds real peaks and the PRN has work."""
    imgs = rng.randint(0, 40, (n, h, w, 3)).astype(np.float32)
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    for i in range(n):
        for _ in range(10):
            cy, cx = rng.uniform(0.06, 0.94) * h, rng.uniform(0.06, 0.94) * w
            sig = rng.uniform(8, 20)
            imgs[i] += 215.0 * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))[..., None]
    return np.clip(imgs, 0, 255).astype(np.uint8)


def test_maps(n: int, h: int, w: int, device,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[n, h, w] maps in `dtype`: a third uniform noise, a third Gaussian
    bumps on low noise, a third plateaus of 256 levels in 2x2 blocks
    (exact ties that only the (value desc, flat asc) order resolves)."""
    g = torch.Generator(device=device).manual_seed(0)
    third = n // 3
    noise = torch.rand(third, h, w, generator=g, device=device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    bumps = 0.05 * torch.rand(third, h, w, generator=g, device=device)
    for _ in range(5):
        cy = torch.rand(third, 1, 1, generator=g, device=device) * h
        cx = torch.rand(third, 1, 1, generator=g, device=device) * w
        amp = torch.rand(third, 1, 1, generator=g, device=device)
        sig = 1 + 2 * torch.rand(third, 1, 1, generator=g, device=device)
        bumps += amp * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                 / (2 * sig ** 2))
    rest = n - 2 * third
    levels = torch.randint(0, 256, (rest, h // 2, w // 2), generator=g,
                           device=device).float() / 256
    plateaus = levels.repeat_interleave(2, 1).repeat_interleave(2, 2)
    return torch.cat([noise, bumps, plateaus]).to(dtype)


def compare_raw(got, want, threshold: float,
                what: str = "decode kernel") -> tuple[float, int]:
    """Kernel vs plain (scores, ys, xs), bit for bit on every slot: both
    rank the same f32 values in the same (value desc, flat asc) order, the
    -inf fillers of maps with fewer than P peaks included. Returns (max
    abs error, number of valid slots)."""
    scores, ys, xs = got
    w_scores, w_ys, w_xs = want
    if not (torch.equal(scores, w_scores) and torch.equal(ys, w_ys)
            and torch.equal(xs, w_xs)):
        raise AssertionError(f"{what} disagrees with its reference")
    finite = torch.isfinite(w_scores)
    err = max(float((scores[finite] - w_scores[finite]).abs().max()),
              float((ys - w_ys).abs().max()), float((xs - w_xs).abs().max()))
    return err, int((w_scores > threshold).sum())


def nan_maps(n: int, h: int, w: int, device, frac: float = 0.003,
             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The test maps with a seeded `frac` of their elements set to NaN, as
    a diverged model's heatmaps hold them."""
    maps = test_maps(n, h, w, device, torch.float32)
    g = torch.Generator(device=device).manual_seed(1)
    maps[torch.rand(maps.shape, generator=g, device=device) < frac] = \
        float("nan")
    return maps.to(dtype)


def compare_nan(got, want, what: str) -> int:
    """Kernel vs plain (scores, ys, xs) on maps that hold NaNs, bit for bit
    where a NaN must be NaN in both (equal_nan; a NaN's bits may differ).
    Returns the number of NaN positions."""
    for a, b in zip(got, want):
        if not (torch.equal(a.isnan(), b.isnan())
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))):
            raise AssertionError(f"{what} disagrees with its reference on "
                                 "NaN maps")
    return int(want[1].isnan().sum() + want[2].isnan().sum())


def graph_ms(fn, reps: int, rounds: int) -> float:
    """The device time of one call of fn: `reps` calls captured in a CUDA
    graph, replayed `rounds` times between CUDA events (median per call),
    so the host's work per call does not set the time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    """The host's time per call of fn, on the host clock, calls back to
    back (the device may still run when the loop ends)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def decode_bound(n: int, h: int, w: int, p: int, n_taps: int,
                 elem_bytes: int, window: int = 3) -> dict:
    """The least time of a decode kernel (B1, B2 or the generic one) on n
    maps of h x w: each map read once and P (score, y, x) f32 written per
    map, over the HBM rate; per element a multiply and an add per tap in
    each blur pass, window² - 1 maxima and one comparison for the peak
    test, over the rate of unfused float32 operations."""
    bytes_moved = n * h * w * elem_bytes + 3 * n * p * 4
    ops = n * h * w * (4 * n_taps + window ** 2)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_NO_FMA_OPS_PER_S * 1e3
    return {"bytes": bytes_moved, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def column_topk_bound(n: int, h: int, w: int) -> dict:
    """The least time of B4 (the per-column top-8 of the 3x3 peak mask) on
    n bf16 maps of h x w: each map read once and column 0's 8 (score f32,
    packed row int32) written per map, over the HBM rate; per element 8
    maxima and one comparison, over the rate of unfused float32
    operations."""
    bytes_moved = n * h * w * 2 + 2 * n * 8 * 4
    ops = 9 * n * h * w
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_NO_FMA_OPS_PER_S * 1e3
    return {"bytes": bytes_moved, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_decode_kernel(decode, kernels, cfg, device) -> dict:
    """B1 on the 2176 test maps of 128² (a fast() batch) against its plain
    version, bit for bit, and timed; then at one `predict` request's 17
    maps, exact and timed too; then on float32 maps at [64, 17, 128, 128],
    the shape and dtype of a Config() batch (pipeline_default), exact and
    timed against its own bound."""
    n, h, w = BATCH * 17, 128, 128
    maps = test_maps(n, h, w, device)
    x = maps.view(BATCH, 17, h, w)
    got = decode.decode_maps(x, cfg)
    want = decode.decode_maps_plain(maps, cfg)
    torch.cuda.synchronize()
    err, n_valid = compare_raw(got, want, cfg.score_threshold)
    kernel_ms = cuda_ms(lambda: decode.decode_maps(x, cfg), reps=20, rounds=5)
    plain_ms = cuda_ms(lambda: decode.decode_maps_plain(maps, cfg), reps=3,
                       rounds=3)
    one = x[:1].contiguous()
    compare_raw(decode.decode_maps(one, cfg),
                decode.decode_maps_plain(maps[:17], cfg), cfg.score_threshold)
    batch1_ms = cuda_ms(lambda: decode.decode_maps(one, cfg), reps=50,
                        rounds=5)
    p = cfg.max_peaks_per_channel
    bound = decode_bound(n, h, w, p, len(decode.smoothing_taps(cfg)),
                         maps.element_size())
    f32 = phase_decode_f32(decode, cfg, device)
    nan = nan_maps(2 * 17, h, w, device)
    if decode.route(nan.view(2, 17, h, w), cfg) != decode.KERNEL:
        raise AssertionError("decode_kernel: NaN maps routed elsewhere")
    nan_positions = compare_nan(decode.decode_maps(nan.view(2, 17, h, w), cfg),
                                decode.decode_maps_plain(nan, cfg),
                                "decode kernel (NaN maps)")
    row = {
        "name": decode.KERNEL, "route": "cuda",
        "design": "warp per map (8 row bands when few), cp.async row ring, "
                  "two rows a step, warp-wide insertion floor",
        "source": "multiposenet_tpu_torch/csrc/decode_peaks.cu",
        "replaces": "multiposenet_tpu/ops/decode_pallas.py:70",
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None, "held_against_plain": True,
        "float32": {k: f32[k] for k in ("maps", "ms", "plain_ms",
                                        "bound_ms", "bound_by")},
    }
    emit({"phase": "decode_kernel", "maps": [n, h, w], "dtype": "bfloat16",
          "exact": True, "valid_slots": n_valid, "max_abs_err": err,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "batch1_maps": [1, 17, h, w], "batch1_exact": True,
          "batch1_kernel_ms": batch1_ms, "design": row["design"], **bound,
          "float32": f32, "nan_maps": [2, 17, h, w], "nan_exact": True,
          "nan_positions": nan_positions})
    return row


def phase_decode_f32(decode, cfg, device) -> dict:
    """B1 on float32 test maps at [64, 17, 128, 128] (what a Config() batch
    of 64 at 512² gives it), bit for bit against its plain version, timed,
    with its bound."""
    b, k, h, w = DEFAULT_BATCH, 17, IMAGE // 4, IMAGE // 4
    maps = test_maps(b * k, h, w, device, torch.float32)
    x = maps.view(b, k, h, w)
    if decode.route(x, cfg) != decode.KERNEL:
        raise AssertionError("decode_kernel: f32 maps routed elsewhere")
    err, n_valid = compare_raw(decode.decode_maps(x, cfg),
                               decode.decode_maps_plain(maps, cfg),
                               cfg.score_threshold, "decode kernel (f32)")
    bound = decode_bound(b * k, h, w, cfg.max_peaks_per_channel,
                         len(decode.smoothing_taps(cfg)),
                         maps.element_size())
    return {"maps": [b, k, h, w], "dtype": "float32", "exact": True,
            "valid_slots": n_valid, "max_abs_err": err,
            "ms": cuda_ms(lambda: decode.decode_maps(x, cfg), reps=20,
                          rounds=5),
            "plain_ms": cuda_ms(lambda: decode.decode_maps_plain(maps, cfg),
                                reps=3, rounds=3), **bound}


GENERIC_DESIGN = ("tiles of a map across a cluster of up to 8 blocks, "
                  "blur and separable max.NaN window max in shared memory, "
                  "marked peaks into per-thread top-P key lists merged per "
                  "warp, block and cluster (DSMEM); rounds of 32 above P = "
                  "32; a block per map through a workspace for taps or "
                  "windows too wide for shared memory")


def generic_c_plan(decode, kernels, n_maps: int, h: int, w: int, cfg,
                   device) -> dict:
    """The launch plan the generic kernel's C entry point takes on this
    card, held against ops/decode.py generic_launch_plan."""
    import ctypes
    fn = kernels.load(decode.GENERIC_KERNEL).decode_generic_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    out = (ctypes.c_int * len(decode.GENERIC_PLAN_FIELDS))()
    args = (n_maps, h, w, len(decode.smoothing_taps(cfg)), cfg.nms_window,
            cfg.max_peaks_per_channel)
    if fn(*args, 0, out):
        raise RuntimeError(f"decode_generic_plan refused {args}")
    plan = dict(zip(decode.GENERIC_PLAN_FIELDS, out))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if plan != decode.generic_launch_plan(*args, sms):
        raise AssertionError(f"decode_generic: the C plan {plan} is not "
                             "generic_launch_plan's")
    return plan


def phase_decode_generic_kernel(decode, kernels, cfg, device,
                                ptxas: dict) -> dict:
    """The generic decode kernel on what B1 and B2 do not take: a 5x5 peak
    window on 1088 test maps of 128² (64 images of 17) and on one
    `predict` request's 17 maps, and 20 peaks on maps 600 wide (as a
    2400-pixel image gives). Bit for bit against the plain version and
    timed (CUDA events around back-to-back calls); the request also by a
    CUDA graph of the calls (the kernel without the host's work) and on
    the host clock per call (the wrapper's work). Then NaN maps at windows
    1 and 5, equal with NaN where the plain version has NaN. Each case
    with the C launch plan, held to generic_launch_plan. The bound and the
    row are those of the first shape; decode_bound counts window² an
    element for a direct window max, which the kernel takes separably
    (2 x window)."""
    cases = {"window5": ((64, 17, 128, 128), dataclasses.replace(
                 cfg, nms_window=5)),
             "peaks20_width600": ((4, 17, 160, 600), dataclasses.replace(
                 cfg, max_peaks_per_channel=20)),
             "request_window5": ((1, 17, 128, 128), dataclasses.replace(
                 cfg, nms_window=5))}
    out, err = {}, 0.0
    for name, ((b, k, h, w), c) in cases.items():
        maps = test_maps(b * k, h, w, device)
        x = maps.view(b, k, h, w)
        if decode.route(x, c) != decode.GENERIC_KERNEL:
            raise AssertionError(f"decode_generic: {name} routed elsewhere")
        e, n_valid = compare_raw(decode.decode_maps(x, c),
                                 decode.decode_maps_plain(maps, c),
                                 c.score_threshold, f"decode_generic {name}")
        err = max(err, e)
        request = b == 1
        out[name] = {
            "maps": [b, k, h, w], "config": dataclasses.asdict(c),
            "exact": True, "valid_slots": n_valid,
            "launch_plan": generic_c_plan(decode, kernels, b * k, h, w, c,
                                          device),
            "kernel_ms": cuda_ms(lambda: decode.decode_maps(x, c),
                                 reps=50 if request else 3,
                                 rounds=5 if request else 3),
            "plain_ms": cuda_ms(lambda: decode.decode_maps_plain(maps, c),
                                reps=1, rounds=3),
            **decode_bound(b * k, h, w, c.max_peaks_per_channel,
                           len(decode.smoothing_taps(c)),
                           maps.element_size(), c.nms_window)}
        if request:
            out[name]["graph_kernel_ms"] = graph_ms(
                lambda: decode.launch_generic_cuda(x, c), reps=50, rounds=5)
            out[name]["host_ms_per_call"] = host_ms(
                lambda: decode.decode_maps(x, c), reps=200)
    nan = {}
    for window in (1, 5):
        c = dataclasses.replace(cfg, nms_window=window)
        maps = nan_maps(2 * 17, 128, 128, device)
        nan[f"window{window}"] = compare_nan(
            decode.decode_maps(maps.view(2, 17, 128, 128), c),
            decode.decode_maps_plain(maps, c),
            f"decode_generic (NaN maps, window {window})")
    first = out["window5"]
    row = {
        "name": decode.GENERIC_KERNEL, "route": "cuda",
        "design": GENERIC_DESIGN,
        "source": "multiposenet_tpu_torch/csrc/decode_generic.cu",
        "replaces": "multiposenet_tpu/ops/decode.py:164 (jnp decode, no "
                    "Pallas kernel)",
        "max_abs_err": err, "ms": first["kernel_ms"],
        "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"], "library_ms": None,
        "held_against_plain": True,
        "request_ms": out["request_window5"]["graph_kernel_ms"],
    }
    emit({"phase": "decode_generic_kernel", "dtype": "bfloat16",
          "max_abs_err": err, "cases": out, "nan_maps": [2, 17, 128, 128],
          "nan_exact": True, "nan_positions": nan, "design": GENERIC_DESIGN,
          "window_max": "separable (rows, then columns); decode_bound "
                        "counts window² a direct window max takes",
          "ptxas": ptxas.get(decode.GENERIC_KERNEL)})
    return row


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


@contextlib.contextmanager
def decode_lanes_on(decode):
    """ops.decode.DECODE_LANES on for a phase, restored after."""
    old = decode.DECODE_LANES
    decode.DECODE_LANES = True
    try:
        yield
    finally:
        decode.DECODE_LANES = old


def phase_tail_kernel(kp_tail, layers, device) -> dict:
    """B3 at the crowd path's shapes in bf16 (the tensor-core kernel)
    against its plain version (TF32 off for the plain version's f32 conv),
    with cuDNN's bf16 conv of the already-summed input as the library
    yardstick; the eager upsample-add-conv tail of the plain head and the
    f32 (CUDA-core) kernel at the same shapes are timed for information."""
    import torch.nn.functional as F

    b, c, h, w, k = BATCH, 64, IMAGE // 4, IMAGE // 4, 17
    g = torch.Generator(device=device).manual_seed(1)
    bf16 = torch.bfloat16
    l2 = torch.randn(b, c, h, w, generator=g, device=device).to(bf16)
    z8 = torch.randn(b, c, h // 2, w // 2, generator=g, device=device).to(bf16)
    weight = torch.randn(k, c, 3, 3, generator=g, device=device) / (9 * c) ** .5
    bias = torch.randn(k, generator=g, device=device)
    with no_tf32():
        got = kp_tail.kp_tail_cm(l2, z8, weight, bias)
        want = kp_tail.kp_tail_plain(l2, z8, weight, bias)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        # The bf16 products are exact in f32 on both sides; only the order
        # of the f32 sum differs before the one rounding to bf16.
        tol = 2.0 ** -7 * float(want.float().abs().max())
        if not torch.isfinite(got.float()).all() or err > tol:
            raise AssertionError(f"tail kernel differs by {err} (tol {tol})")
        kernel_ms = cuda_ms(lambda: kp_tail.kp_tail_cm(l2, z8, weight, bias),
                            reps=10, rounds=5)
        plain_ms = cuda_ms(lambda: kp_tail.kp_tail_plain(l2, z8, weight, bias),
                           reps=3, rounds=3)
        # The f32 instantiation (CUDA cores) at the same shapes, for
        # information: the f32 crowd forward of parity_f32 runs it.
        l2f, z8f = l2.float(), z8.float()
        f32_ms = cuda_ms(lambda: kp_tail.kp_tail_cm(l2f, z8f, weight, bias),
                         reps=3, rounds=3)
        del l2f, z8f
    x = l2 + layers.upsample2x(z8)
    wb, bb = weight.to(bf16), bias.to(bf16)
    library_ms = cuda_ms(lambda: F.conv2d(x, wb, bb, padding=1), reps=10,
                         rounds=5)
    eager_ms = cuda_ms(lambda: F.conv2d(l2 + layers.upsample2x(z8), wb, bb,
                                        padding=1), reps=10, rounds=5)
    bytes_moved = (l2.numel() + z8.numel() + b * k * h * w) * 2 \
        + weight.numel() * 2 + k * 4
    ops = 2 * b * h * w * 9 * c * k
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    row = {
        "name": kp_tail.KERNEL, "route": "cuda",
        "design": "mma.sync bf16, CUDA-core f32",
        "source": "multiposenet_tpu_torch/csrc/kp_tail.cu",
        "replaces": "multiposenet_tpu/ops/kp_tail_pallas.py:67",
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "held_against_plain": True,
    }
    emit({"phase": "tail_kernel", "l2": [b, c, h, w], "z8": [b, c, h // 2,
          w // 2], "out": [b, k, h, w], "dtype": "bfloat16",
          "tolerance": "2**-7 x max|plain| (1 bf16 ulp at the output's "
                       "scale)", "tol": tol, "max_abs_err": err,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "library_ms": library_ms,
          "library": "F.conv2d(l2 + up2(z8) precomputed, bf16, cuDNN)",
          "eager_tail_ms": eager_ms, "f32_kernel_ms": f32_ms,
          "design": row["design"], "bound_ms": row["bound_ms"],
          "bound_by": row["bound_by"], "bytes": bytes_moved, "ops": ops})
    return row


def phase_decode_lanes_kernel(decode, cfg, device) -> dict:
    """B2 on the 2176 test maps of 128² in both layouts it is built for:
    channel-major (as B3 writes the crowd path's heatmaps) and
    channels-last; bit for bit against its plain version and against B1,
    and timed; then at one `predict` request's 17 maps in both layouts,
    exact and timed too."""
    n, h, w = BATCH * 17, 128, 128
    maps = test_maps(n, h, w, device)
    cm = maps.view(BATCH, 17, h, w)

    def layouts(x):
        return {"channel_major": x,
                "channels_last": x.permute(0, 2, 3, 1).contiguous()
                .permute(0, 3, 1, 2)}

    want = decode.decode_maps_plain(maps, cfg)
    b1 = decode.decode_maps(cm, cfg)
    want1 = decode.decode_maps_plain(maps[:17], cfg)
    ms, batch1_ms, err, n_valid = {}, {}, 0.0, 0
    for name, x in layouts(cm).items():
        got = decode.decode_maps_lanes(x, cfg)
        torch.cuda.synchronize()
        e, n_valid = compare_raw(got, want, cfg.score_threshold,
                                 f"lanes decode ({name}) vs plain")
        compare_raw(got, b1, cfg.score_threshold,
                    f"lanes decode ({name}) vs decode_peaks")
        err = max(err, e)
        ms[name] = cuda_ms(lambda: decode.decode_maps_lanes(x, cfg), reps=20,
                           rounds=5)
    for name, x in layouts(cm[:1].contiguous()).items():
        compare_raw(decode.decode_maps_lanes(x, cfg), want1,
                    cfg.score_threshold,
                    f"lanes decode ({name}, one request) vs plain")
        batch1_ms[name] = cuda_ms(lambda: decode.decode_maps_lanes(x, cfg),
                                  reps=50, rounds=5)
    plain_ms = cuda_ms(lambda: decode.decode_maps_plain(maps, cfg), reps=3,
                       rounds=3)
    nan = nan_maps(2 * 17, h, w, device)
    nan_want = decode.decode_maps_plain(nan, cfg)
    for name, x in layouts(nan.view(2, 17, h, w)).items():
        if decode.route(x, cfg, lanes=True) != decode.LANES_KERNEL:
            raise AssertionError(f"decode_lanes: NaN maps ({name}) routed "
                                 "elsewhere")
        compare_nan(decode.decode_maps_lanes(x, cfg), nan_want,
                    f"lanes decode ({name}, NaN maps)")
    bound = decode_bound(n, h, w, cfg.max_peaks_per_channel,
                         len(decode.smoothing_taps(cfg)), maps.element_size())
    row = {
        "name": decode.LANES_KERNEL, "route": "cuda",
        "design": "B1's warp-per-map rows (cp.async ring, two rows a step, "
                  "insertion floor); channels-last: a block per image "
                  "sharing a cp.async ring of row spans",
        "source": "multiposenet_tpu_torch/csrc/decode_lanes.cu",
        "replaces": "multiposenet_tpu/ops/decode_pallas.py:366",
        "max_abs_err": err, "ms": ms["channel_major"],
        "ms_by_layout": ms, "batch1_ms_by_layout": batch1_ms,
        "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None,
        "held_against_plain": True,
    }
    emit({"phase": "decode_lanes_kernel", "maps": [n, h, w],
          "dtype": "bfloat16", "exact_vs_plain": True,
          "exact_vs_decode_peaks": True, "valid_slots": n_valid,
          "max_abs_err": err, "kernel_ms": ms, "batch1_maps": [1, 17, h, w],
          "batch1_exact": True, "batch1_kernel_ms": batch1_ms,
          "plain_ms": plain_ms, "design": row["design"],
          "nan_maps": [2, 17, h, w], "nan_exact_by_layout": sorted(
              layouts(cm)), **bound})
    return row


def compare_columns(column_topk, x, what: str) -> float:
    """B4 on maps x [N, H, W] against its plain version, bit for bit:
    column 0's lists (the kernel's outputs) and every column's, through
    `columns_out`. Returns the largest error over finite scores (0)."""
    n, h, w = x.shape
    cols = (torch.empty(n, 8, w, dtype=torch.float32, device=x.device),
            torch.empty(n, 8, w, dtype=torch.int32, device=x.device))
    scores, rows = column_topk.column_topk(x, columns_out=cols)
    want = column_topk.column_topk_plain(x, columns=True)
    torch.cuda.synchronize()
    if not (torch.equal(scores, want[0][:, :, 0])
            and torch.equal(rows, want[1][:, :, 0])):
        raise AssertionError(f"column_topk ({what}): column 0 disagrees "
                             "with the plain version")
    if not all(torch.equal(a, b) for a, b in zip(cols, want)):
        raise AssertionError(f"column_topk ({what}): columns_out disagrees "
                             "with the plain version")
    finite = torch.isfinite(want[0])
    return float((cols[0][finite] - want[0][finite]).abs().max())


def column_topk_c_plan(column_topk, kernels, shape, device) -> dict:
    """The launch plan B4's C entry point takes for `shape` on this card,
    held against ops/column_topk.py launch_plan."""
    import ctypes
    out = (ctypes.c_int * len(column_topk.PLAN_FIELDS))()
    if kernels.load(column_topk.KERNEL).column_topk_plan(*shape, 0, out):
        raise RuntimeError("column_topk_plan refused its shape")
    plan = dict(zip(column_topk.PLAN_FIELDS, out))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if plan != column_topk.launch_plan(*shape, sms):
        raise AssertionError(f"column_topk: the C plan {plan} is not "
                             "launch_plan's")
    return plan


def phase_column_topk_kernel(column_topk, dbench2, kernels, device,
                             ptxas: dict) -> dict:
    """B4 at [2176, 128, 128] bf16 (the decode micro-benchmark's shape),
    on dbench2's maps (seeded noise) and on the test maps (noise, bumps,
    plateaus), bit for bit against its plain version on column 0 and on
    every column; timed beside the plain version, with its bound, launch
    plan, registers and shared memory."""
    n, h, w = dbench2.N_MAPS, dbench2.H, dbench2.W
    inputs = {"dbench2": dbench2.make_maps(n, device),
              "test_maps": test_maps(n, h, w, device)}
    err = max(compare_columns(column_topk, x, name)
              for name, x in inputs.items())
    x = inputs["dbench2"]
    kernel_ms = cuda_ms(lambda: column_topk.column_topk(x), reps=20,
                        rounds=5)
    plain_ms = cuda_ms(lambda: column_topk.column_topk_plain(x), reps=3,
                       rounds=3)
    bound = column_topk_bound(n, h, w)
    plan = column_topk_c_plan(column_topk, kernels, (n, h, w), device)
    row = {
        "name": column_topk.KERNEL, "route": "cuda",
        "design": "persistent blocks, 64-row tiles in a ring of two by "
                  "bulk copy, warps find 16-row strips' peaks in bf16x2 "
                  "as bit masks, a thread per column inserts only the "
                  "peaks into a keyed top-8",
        "source": "multiposenet_tpu_torch/csrc/column_topk.cu",
        "replaces": "benchmarks/ab/dbench2.py:37",
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None, "held_against_plain": True,
    }
    emit({"phase": "column_topk_kernel", "maps": [n, h, w],
          "dtype": "bfloat16", "inputs": sorted(inputs),
          "exact_column0": True, "exact_every_column": True,
          "max_abs_err": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "share_of_bound": bound["bound_ms"] / kernel_ms,
          "design": row["design"], "launch_plan": plan,
          "ptxas": ptxas.get(column_topk.KERNEL), **bound})
    return row


def phase_dbench2(dbench2, column_topk, decode, kernels) -> int:
    """The decode micro-benchmark's path, `tools/dbench2.run` on the card:
    B4 and B1 each launched 61 times (one warm-up and 3 rounds of 20) and
    no other kernel, B4's last outputs bit for bit against its plain
    version. Returns B4's launches."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    summary, (scores, rows) = dbench2.run()
    launches = dict(kernels.LAUNCHES)
    calls = dbench2.WARMUP + dbench2.ROUNDS * dbench2.REPS
    want = {column_topk.KERNEL: calls, decode.KERNEL: calls}
    if launches != want:
        raise AssertionError(f"dbench2: launches {launches}, want {want}")
    plain = column_topk.column_topk_plain(
        dbench2.make_maps(dbench2.N_MAPS, scores.device))
    if not (torch.equal(scores, plain[0]) and torch.equal(rows, plain[1])):
        raise AssertionError("dbench2: B4's outputs disagree with the "
                             "plain version")
    emit({"phase": "dbench2", "launches": launches, "exact": True,
          **summary})
    return launches[column_topk.KERNEL]


def parity_f32_pairs(model, cells, device) -> dict:
    """(card, CPU) output pairs of one float32 module on the same cells,
    TF32 off."""
    model_gpu = copy.deepcopy(model).to(device)
    with no_tf32(), torch.inference_mode():
        ref = model(cells)
        out = model_gpu(cells.to(device))
        torch.cuda.synchronize()
    pairs = {"heatmaps_cm": (out["heatmaps_cm"], ref["heatmaps_cm"])}
    for level, d in ref["detector"].items():
        for kind in d:
            pairs[f"{level}.{kind}"] = (out["detector"][level][kind], d[kind])
    return pairs


def phase_parity_f32(Config, MultiPoseNet, folding, kp_tail, kernels,
                     image_ops, device) -> None:
    """Config.fast(), the served Config.crowd() model (BN folded in place,
    fused tail on, so B3 runs inside it at full width) and Config() (the
    stride-2 stem on 2x2 cells, smoothed P2..P5 towers, fuse conv) in
    float32: the card's forward against the CPU forward of the same
    module. TF32 is switched off for this phase and restored."""
    imgs = planted_scenes(np.random.RandomState(1), 2, IMAGE, IMAGE)
    s4_cells = image_ops.s4_flat_to_cells(
        torch.as_tensor(image_ops.space_to_depth_flat4(imgs)))
    s2d_cells = image_ops.normalize_s2d_flat(
        torch.as_tensor(image_ops.space_to_depth_flat(imgs)))
    pairs = {}
    for name, cfg, cells in (("fast", Config.fast(), s4_cells),
                             ("crowd", Config.crowd(), s4_cells),
                             ("default", Config(), s2d_cells)):
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype="float32",
            kp_tail_pallas=name == "crowd"))
        model = MultiPoseNet(cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        model.eval()
        if name == "crowd":
            folding.fold_batch_norm_(model)
        kernels.reset_launches()
        for key, pair in parity_f32_pairs(model, cells, device).items():
            pairs[f"{name}.{key}"] = pair
        if name == "crowd" and kernels.LAUNCHES.get(kp_tail.KERNEL) != 1:
            raise AssertionError(f"parity_f32: crowd forward launched "
                                 f"{kernels.LAUNCHES}")
    # cuDNN and the CPU sum the same f32 products in other orders over
    # about twenty layers: allow 1e-3 of each output's scale, orders of
    # magnitude below what a wrong layout or weight would give.
    errs = {}
    for name, (got, want) in pairs.items():
        got = got.float().cpu()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"parity_f32: bad output {name}")
        scale = max(1.0, float(want.abs().max()))
        errs[name] = float((got - want).abs().max())
        if errs[name] > 1e-3 * scale:
            raise AssertionError(
                f"parity_f32: {name} differs by {errs[name]} (scale {scale})")
    emit({"phase": "parity_f32", "tf32": False, "batch": 2, "image": IMAGE,
          "models": ["Config.fast()", "Config.crowd() BN folded, tail on",
                     "Config() on normalized 2x2 cells"],
          "tolerance": "1e-3 x max(1, max|cpu|)", "max_abs_err": errs})


def staged_batches(rng, n: int, stage, device) -> list[torch.Tensor]:
    """Two batches of n planted 512² scenes, staged on the host by `stage`
    (an ops.image space-to-depth function) and moved to the device."""
    return [torch.as_tensor(stage(planted_scenes(rng, n, IMAGE, IMAGE)))
            .to(device) for _ in range(2)]


def drive_batches(pred, cfg, kernels, batches, expect: dict,
                  staging: str) -> dict:
    """Drive `pred.batch_forward` on full-size uint8 batches on the
    device, with the launch counts set to 0 just before and read just
    after; each kernel in `expect` must launch that many times per batch,
    and no other. Checks the outputs' shapes and that some detections and
    peaks are valid."""
    k, p, d = cfg.model.num_keypoints, cfg.decode.max_peaks_per_channel, \
        cfg.detector.max_detections
    n = batches[0].shape[0]
    # Random weights also leave every smoothed heatmap under the decode's
    # 0.2 threshold, so no peak would be valid and the PRN snap would go
    # unexercised: the heatmap channels' output bias is set to 0.25.
    with torch.no_grad():
        pred.model.keypoint_head.output.bias[:k].fill_(0.25)
    n_warm, n_timed = 2, 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for i in range(n_warm + n_timed):
        t0 = time.perf_counter()
        out = pred.batch_forward(batches[i % 2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    calls = n_warm + n_timed
    want = {name: per * calls for name, per in expect.items()}
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    peak_mem = torch.cuda.max_memory_allocated() / 2 ** 30

    shapes = {"boxes": (n, d, 4), "box_scores": (n, d),
              "box_valid": (n, d), "keypoints": (n, d, k, 3),
              "peak_positions": (n, k, p, 2), "peak_scores": (n, k, p),
              "peak_valid": (n, k, p)}
    for name, shape in shapes.items():
        t = out[name]
        if tuple(t.shape) != shape or not torch.isfinite(t.float()).all():
            raise AssertionError(f"pipeline: bad {name} {tuple(t.shape)}")
    if not (bool(out["box_valid"].any()) and bool(out["peak_valid"].any())):
        raise AssertionError("pipeline: no valid detection or peak")
    ms = statistics.mean(times[n_warm:]) * 1e3
    return {"out": out, "launches": launches, "last": batches[(calls - 1) % 2],
            "summary": {
                "batch": n, "image": IMAGE,
                "staging": f"{staging} uint8 on the device", "ms_per_iter": ms,
                "img_per_s": n / ms * 1e3,
                "iter_ms": [t * 1e3 for t in times], "launches": launches,
                "valid_detections": int(out["box_valid"].sum()),
                "valid_peaks": int(out["peak_valid"].sum()),
                "peak_mem_gib": peak_mem}}


def pipeline_checks(pred, cfg, batch, decode, detection, plain_name) -> dict:
    """The decode the pipeline took, on the pipeline's own heatmaps,
    against the plain version (bit for bit), and the stage times."""
    with torch.inference_mode():
        x = pred._model_input(batch)
        hm_cm = pred.model(x)["heatmaps_cm"]
        route = (decode.decode_maps_lanes if decode.DECODE_LANES
                 else decode.decode_maps)
        err, n_valid = compare_raw(
            route(hm_cm, cfg.decode),
            decode.decode_maps_plain(hm_cm.reshape(-1, *hm_cm.shape[2:]),
                                     cfg.decode),
            cfg.decode.score_threshold, plain_name)
        stages = stage_times(pred, cfg, x, hm_cm, detection)
    return {"kernel_vs_plain_on_pipeline_heatmaps": {
                "kernel": plain_name, "exact": True, "max_abs_err": err,
                "valid_slots": n_valid},
            "stage_ms": stages}


def phase_pipeline(Config, Predictor, decode, kernels, image_ops,
                   detection, card: str) -> int:
    """Config.fast() (bf16) at full width through Predictor.batch_forward
    on s4-flat uint8 batches. Random-init weights start the class bias at
    the 0.01 prior, under fast()'s 0.05 score threshold, so the threshold
    is set to 0.0 here to give NMS and the PRN real detections (and the
    heatmap bias raised, see drive_batches)."""
    cfg = Config.fast()
    cfg = cfg.replace(detector=dataclasses.replace(cfg.detector,
                                                   score_threshold=0.0))
    pred = Predictor(cfg, image_size=IMAGE)
    rng = np.random.RandomState(2)
    run = drive_batches(
        pred, cfg, kernels,
        staged_batches(rng, BATCH, image_ops.space_to_depth_flat4,
                       pred.device),
        {decode.KERNEL: 1}, "s4-flat")
    emit({"phase": "pipeline", "card": card, "config": "Config.fast()",
          "score_threshold_override": 0.0, "heatmap_bias_override": 0.25,
          **run["summary"],
          **pipeline_checks(pred, cfg, run["last"], decode, detection,
                            decode.KERNEL)})

    k = cfg.model.num_keypoints
    sizes = [(480, 640), (512, 512), (300, 700)]
    images = [planted_scenes(rng, 1, h, w)[0] for h, w in sizes]
    pred.predict(images[0])  # warm-up, outside the counted window
    torch.cuda.synchronize()
    kernels.reset_launches()
    latencies, persons = [], []
    for img in images:
        t0 = time.perf_counter()
        people = pred.predict(img)
        latencies.append((time.perf_counter() - t0) * 1e3)
        check_people(people, k)
        persons.append(len(people))
    predict_launches = kernels.LAUNCHES.get(decode.KERNEL, 0)
    if predict_launches != len(images) or not all(persons):
        raise AssertionError(
            f"predict: launches {predict_launches}, persons {persons}")
    emit({"phase": "predict", "card": card, "sizes": sizes,
          "persons": persons, "latency_ms": latencies,
          "launches": predict_launches})
    return run["launches"][decode.KERNEL]


def phase_predict_generic(Config, Predictor, decode, kernels,
                          card: str) -> int:
    """`predict` requests on Config.fast() with a 5x5 peak window, which
    only the generic decode kernel takes: one launch of it per request
    and no other kernel. Returns its launches."""
    cfg = Config.fast()
    cfg = cfg.replace(
        detector=dataclasses.replace(cfg.detector, score_threshold=0.0),
        decode=dataclasses.replace(cfg.decode, nms_window=5))
    pred = Predictor(cfg, image_size=IMAGE)
    k = cfg.model.num_keypoints
    with torch.no_grad():
        pred.model.keypoint_head.output.bias[:k].fill_(0.25)
    rng = np.random.RandomState(4)
    sizes = [(480, 640), (512, 512), (300, 700)]
    images = [planted_scenes(rng, 1, h, w)[0] for h, w in sizes]
    pred.predict(images[0])  # warm-up, outside the counted window
    torch.cuda.synchronize()
    kernels.reset_launches()
    latencies, persons = [], []
    for img in images:
        t0 = time.perf_counter()
        people = pred.predict(img)
        latencies.append((time.perf_counter() - t0) * 1e3)
        check_people(people, k)
        persons.append(len(people))
    launches = dict(kernels.LAUNCHES)
    if launches != {decode.GENERIC_KERNEL: len(images)} or not all(persons):
        raise AssertionError(
            f"predict_generic: launches {launches}, persons {persons}")
    emit({"phase": "predict_generic", "card": card,
          "config": "Config.fast(), decode.nms_window=5", "sizes": sizes,
          "persons": persons, "latency_ms": latencies,
          "launches": launches})
    return launches[decode.GENERIC_KERNEL]


def phase_pipeline_default(Config, Predictor, decode, kernels, image_ops,
                           detection, card: str):
    """Config() (the paper's architecture: MobileNet-v1 at width 1.0 with
    the stride-2 stem over 2x2 cells, the 128-wide FPN, 2-conv keypoint
    towers on the smoothed P2..P5, the fuse conv and the stride-4 output
    conv, 4-conv detector towers, a 512-candidate pre-NMS pool, a 56x36
    PRN with 1024 hidden units) at full width in float32 through
    Predictor.batch_forward, on s2d-flat uint8 batches of 64 at 512²: one
    B1 launch per batch (its maps are float32) and no other kernel. The
    score threshold and heatmap bias are overridden as on the fast()
    path. TF32 is left as PyTorch sets it and recorded. Returns the
    predictor, its last batch and its B1 launches."""
    cfg = Config()
    cfg = cfg.replace(detector=dataclasses.replace(cfg.detector,
                                                   score_threshold=0.0))
    pred = Predictor(cfg, image_size=IMAGE)
    tf32 = {"torch.backends.cudnn.allow_tf32":
            torch.backends.cudnn.allow_tf32,
            "torch.backends.cuda.matmul.allow_tf32":
            torch.backends.cuda.matmul.allow_tf32}
    rng = np.random.RandomState(5)
    run = drive_batches(
        pred, cfg, kernels,
        staged_batches(rng, DEFAULT_BATCH, image_ops.space_to_depth_flat,
                       pred.device),
        {decode.KERNEL: 1}, "s2d-flat")
    emit({"phase": "pipeline_default", "card": card, "config": "Config()",
          "compute_dtype": cfg.model.compute_dtype, "tf32": tf32,
          "score_threshold_override": 0.0, "heatmap_bias_override": 0.25,
          **run["summary"],
          **pipeline_checks(pred, cfg, run["last"], decode, detection,
                            decode.KERNEL)})
    return pred, run["last"], run["launches"][decode.KERNEL]


def phase_predict_default(Config, Predictor, decode, kernels,
                          card: str) -> int:
    """`predict` requests on Config() with flip test-time augmentation and
    pose-level OKS NMS at 0.5: two forwards a request, the averaged maps
    decoded once by B1 (a contiguous channel-major copy), no other
    kernel, and people found. Returns B1's launches."""
    cfg = Config()
    cfg = cfg.replace(detector=dataclasses.replace(
        cfg.detector, score_threshold=0.0, pose_nms_oks=0.5))
    pred = Predictor(cfg, image_size=IMAGE, flip_tta=True)
    k = cfg.model.num_keypoints
    with torch.no_grad():
        pred.model.keypoint_head.output.bias[:k].fill_(0.25)
    rng = np.random.RandomState(6)
    sizes = [(480, 640), (512, 512), (300, 700)]
    images = [planted_scenes(rng, 1, h, w)[0] for h, w in sizes]
    pred.predict(images[0])  # warm-up, outside the counted window
    torch.cuda.synchronize()
    kernels.reset_launches()
    latencies, persons = [], []
    for img in images:
        t0 = time.perf_counter()
        people = pred.predict(img)
        latencies.append((time.perf_counter() - t0) * 1e3)
        check_people(people, k)
        persons.append(len(people))
    launches = dict(kernels.LAUNCHES)
    if launches != {decode.KERNEL: len(images)} or not all(persons):
        raise AssertionError(
            f"predict_default: launches {launches}, persons {persons}")
    emit({"phase": "predict_default", "card": card,
          "config": "Config(), flip_tta=True, detector.pose_nms_oks=0.5",
          "score_threshold_override": 0.0, "heatmap_bias_override": 0.25,
          "sizes": sizes, "persons": persons, "max_detections":
          cfg.detector.max_detections, "latency_ms": latencies,
          "launches": launches})
    return launches[decode.KERNEL]


def phase_export(pred, batch, export, kernels, card: str) -> None:
    """`save_model` of the pipeline_default predictor, then
    `load_predictor` of the directory onto the card: its batch_forward
    equals the original's bit for bit."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="export_",
                                     dir=kernels.BUILD_DIR) as directory:
        t0 = time.perf_counter()
        export.save_model(directory, pred.config, pred.variables,
                          pred.prn_variables)
        save_s = time.perf_counter() - t0
        files = {p.name: p.stat().st_size
                 for p in sorted(Path(directory).iterdir())}
        t0 = time.perf_counter()
        loaded = export.load_predictor(directory, image_size=pred.image_size)
        load_s = time.perf_counter() - t0
    if loaded.device != pred.device:
        raise AssertionError(f"export: loaded onto {loaded.device}")
    want = pred.batch_forward(batch)
    got = loaded.batch_forward(batch)
    torch.cuda.synchronize()
    for key, value in want.items():
        if not torch.equal(got[key], value):
            raise AssertionError(f"export: {key} differs after the reload")
    emit({"phase": "export", "card": card, "config": "Config()",
          "device": str(loaded.device), "files_bytes": files,
          "save_s": save_s, "load_s": load_s, "batch": batch.shape[0],
          "outputs_equal": sorted(want)})


def check_people(people, k: int) -> None:
    for person in people:
        if not (np.isfinite(person.box).all()
                and np.isfinite(person.keypoints).all()
                and person.keypoints.shape == (k, 3)):
            raise AssertionError("predict: bad person")


def phase_pipeline_crowd(Config, Predictor, decode, kp_tail, kernels,
                         image_ops, detection, card: str) -> dict:
    """Config.crowd() served as an exported model is: bf16, BN folded
    (fold_bn=True), the fused keypoint tail (kp_tail_pallas, B3) and the
    maps-on-lanes decode (DECODE_LANES, B2, on for this phase only), at
    full width through Predictor.batch_forward: one B3 and one B2 launch
    per batch and no B1. With random weights the IoU-aware score is about
    0.01 x 0.5² = 0.0025, under crowd's 0.05 threshold, which is set to
    0.0 here; the heatmap bias is raised as on the fast() path. Then a few
    requests through predict, predict_keypoints and predict_given_boxes,
    each with its launch counts. Returns the batch path's launches."""
    cfg = Config.crowd()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, kp_tail_pallas=True),
        detector=dataclasses.replace(cfg.detector, score_threshold=0.0))
    pred = Predictor(cfg, image_size=IMAGE, fold_bn=True)
    if not pred.config.model.bn_folded:
        raise AssertionError("crowd: the served model is not folded")
    rng = np.random.RandomState(3)
    with decode_lanes_on(decode):
        run = drive_batches(
            pred, cfg, kernels,
            staged_batches(rng, BATCH, image_ops.space_to_depth_flat4,
                           pred.device),
            {kp_tail.KERNEL: 1, decode.LANES_KERNEL: 1}, "s4-flat")
        emit({"phase": "pipeline_crowd", "card": card,
              "config": "Config.crowd(kp_tail_pallas=True), fold_bn=True, "
                        "DECODE_LANES=True",
              "score_threshold_override": 0.0, "heatmap_bias_override": 0.25,
              **run["summary"],
              **pipeline_checks(pred, cfg, run["last"], decode, detection,
                                decode.LANES_KERNEL)})
        requests = phase_predict_crowd(pred, cfg, decode, kp_tail, kernels,
                                       rng)
    emit({"phase": "predict_crowd", "card": card, **requests})
    return run["launches"]


def phase_predict_crowd(pred, cfg, decode, kp_tail, kernels, rng) -> dict:
    """Requests on the crowd predictor: predict and predict_given_boxes
    take B3 and B2, predict_keypoints B3 and B1 (its NHWC decode), once
    per request. 30 given boxes run as three chunks of crowd's 12 PRN
    slots."""
    k = cfg.model.num_keypoints
    sizes = [(480, 640), (512, 512), (300, 700)]
    images = [planted_scenes(rng, 1, h, w)[0] for h, w in sizes]
    boxes = np.array([[40 + 9 * i, 30 + 13 * i, 200 + 9 * i, 120 + 13 * i]
                      for i in range(30)], np.float32)
    requests = {
        "predict": lambda img: check_people(pred.predict(img), k) or 1,
        "predict_keypoints": lambda img: pred.predict_keypoints(img),
        "predict_given_boxes": lambda img: pred.predict_given_boxes(img,
                                                                    boxes),
    }
    expect = {"predict": {kp_tail.KERNEL: 1, decode.LANES_KERNEL: 1},
              "predict_keypoints": {kp_tail.KERNEL: 1, decode.KERNEL: 1},
              "predict_given_boxes": {kp_tail.KERNEL: 1,
                                      decode.LANES_KERNEL: 1}}
    out = {"sizes": sizes, "given_boxes": len(boxes)}
    for name, fn in requests.items():
        fn(images[0])  # warm-up, outside the counted window
        torch.cuda.synchronize()
        kernels.reset_launches()
        latencies = []
        for img in images:
            t0 = time.perf_counter()
            res = fn(img)
            latencies.append((time.perf_counter() - t0) * 1e3)
        launches = dict(kernels.LAUNCHES)
        want = {n: c * len(images) for n, c in expect[name].items()}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        if name == "predict_keypoints":
            pos, _, valid = res
            if pos.shape != (k, cfg.decode.max_peaks_per_channel, 2) or \
                    not np.isfinite(pos).all():
                raise AssertionError("predict_keypoints: bad peaks")
        elif name == "predict_given_boxes":
            if res.shape != (len(boxes), k, 3) or not np.isfinite(res).all():
                raise AssertionError("predict_given_boxes: bad keypoints")
        out[name] = {"latency_ms": latencies, "launches": launches}
    return out


def stage_times(pred, cfg, x, hm_cm, detection) -> dict:
    """CUDA-event times of the pipeline's stages on one batch (each run
    alone, so the sum omits the overlap of the whole program); the decode
    is the one the predictor takes."""
    out = pred.model(x)
    det = detection.postprocess_detections(out["detector"], IMAGE,
                                           cfg.detector, anchors=pred.anchors)
    peaks = pred._decode_cm(hm_cm)
    stride = float(cfg.model.output_stride)
    return {
        "model": cuda_ms(lambda: pred.model(x), reps=3, rounds=3),
        "decode": cuda_ms(lambda: pred._decode_cm(hm_cm), reps=10, rounds=3),
        "detection": cuda_ms(lambda: detection.postprocess_detections(
            out["detector"], IMAGE, cfg.detector, anchors=pred.anchors),
            reps=3, rounds=3),
        "prn": cuda_ms(lambda: pred._prn_assign(hm_cm, det.boxes / stride,
                                                peaks), reps=3, rounds=3),
    }


@contextlib.contextmanager
def eval_timers(cli, runner, Predictor):
    """Host-clock times of the eval command's parts, each ended by a
    synchronize: the runner's loop (`loop_s`, without making the
    records: `records_s`), each `batch_forward` of the batched loop and
    each `predict` of the other, and the OKS accumulation (the
    evaluator's `add_image` and `summarize`). Patched in for the block
    and restored after."""
    t = {"records_s": 0.0, "loop_s": 0.0, "forward_s": [], "predict_s": [],
         "oks_s": 0.0}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if isinstance(t[key], list):
                t[key].append(dt)
            else:
                t[key] += dt
            return out
        return wrapper

    make_runner = Predictor.make_batch_runner

    def make_batch_runner(self, mesh=None):
        return timed(make_runner(self, mesh), "forward_s")

    class TimedEvaluator(runner.KeypointEvaluator):
        add_image = timed(runner.KeypointEvaluator.add_image, "oks_s")
        summarize = timed(runner.KeypointEvaluator.summarize, "oks_s")

    patches = [(cli, "_load_records", timed(cli._load_records, "records_s")),
               (runner, "evaluate_batched",
                timed(runner.evaluate_batched, "loop_s")),
               (runner, "evaluate_predictor",
                timed(runner.evaluate_predictor, "loop_s")),
               (runner, "KeypointEvaluator", TimedEvaluator),
               (Predictor, "make_batch_runner", make_batch_runner),
               (Predictor, "predict", timed(Predictor.predict, "predict_s"))]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        yield t
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def cli_stdout(cli, argv: list[str]) -> str:
    """`cli.main(argv)` in this process; its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


EVAL_IMAGES, EVAL_BATCH, EVAL_PREDICT_IMAGES = 256, 128, 32
STAT_KEYS = ["AP", "AP50", "AP75", "AR", "AR50", "APM", "ARM", "APL", "ARL"]


def phase_eval(Config, Predictor, export, cli, runner, decode, kernels,
               directory: Path, card: str) -> dict:
    """`python -m multiposenet_tpu_torch eval` in this process on a
    full-width Config.fast() model exported to `directory` (random
    weights; score threshold 0.0 and heatmap bias 0.25, as on the
    pipeline path), over 256 synthetic 256² images: the batched loop
    (host resize into batches of 128 at 512², `batch_forward`: exactly
    one B1 launch a batch, 2) and the predict loop on 32 images (one B1
    launch a request, 32), no other kernel. Prints the stats, images per
    second on the host clock (records excluded) and, for the batched
    loop, the split into host resize and batch assembly, batch_forward
    and OKS accumulation. Returns B1's launches by loop."""
    cfg = Config.fast()
    cfg = cfg.replace(detector=dataclasses.replace(cfg.detector,
                                                   score_threshold=0.0))
    pred = Predictor(cfg, image_size=IMAGE)
    with torch.no_grad():
        pred.model.keypoint_head.output.bias[:cfg.model.num_keypoints] \
            .fill_(0.25)
    export.save_model(directory, pred.config, pred.variables,
                      pred.prn_variables)
    del pred
    base = ["eval", "--model-dir", str(directory), "--synthetic",
            str(EVAL_IMAGES)]
    loops = {"eval_batched": (base + ["--batched", "--batch-size",
                                      str(EVAL_BATCH)],
                              EVAL_IMAGES, -(-EVAL_IMAGES // EVAL_BATCH)),
             "eval_predict": (base + ["--max-images",
                                      str(EVAL_PREDICT_IMAGES)],
                              EVAL_PREDICT_IMAGES, EVAL_PREDICT_IMAGES)}
    launches = {}
    for name, (argv, n_images, n_b1) in loops.items():
        torch.cuda.synchronize()
        with eval_timers(cli, runner, Predictor) as t:
            kernels.reset_launches()
            t0 = time.perf_counter()
            text = cli_stdout(cli, argv)
            total_s = time.perf_counter() - t0
            counted = dict(kernels.LAUNCHES)
        stats = json.loads(text)
        if list(stats) != STAT_KEYS or not all(
                np.isfinite(v) and -1.0 <= v <= 1.0 for v in stats.values()):
            raise AssertionError(f"{name}: bad stats {stats}")
        if counted != {decode.KERNEL: n_b1}:
            raise AssertionError(f"{name}: launches {counted}, want "
                                 f"{{{decode.KERNEL!r}: {n_b1}}}")
        launches[name] = n_b1
        row = {"phase": name, "card": card, "argv": argv,
               "config": "Config.fast(), exported; score_threshold 0.0, "
                         "heatmap bias 0.25",
               "images": n_images, "stats": stats, "launches": counted,
               "img_per_s": n_images / t["loop_s"], "loop_s": t["loop_s"],
               "records_s": t["records_s"], "command_s": total_s,
               "oks_s": t["oks_s"]}
        if name == "eval_batched":
            forward = sum(t["forward_s"])
            row.update({"batch": EVAL_BATCH, "forward_s": t["forward_s"],
                        "host_resize_and_assembly_s":
                            t["loop_s"] - forward - t["oks_s"],
                        "split": "host resize and batch assembly = loop - "
                                 "batch_forward - OKS"})
        else:
            row.update({"predict_ms": [x * 1e3 for x in t["predict_s"]]})
        emit(row)
    return launches


def phase_cli_predict(cli, image_io, visualize, synthetic, decode, kernels,
                      directory: Path, card: str) -> int:
    """`python -m multiposenet_tpu_torch predict --output` in this process
    on the model `phase_eval` exported: a synthetic 480x640 scene written
    with `image_io.write_png`, one B1 launch and no other kernel, people
    printed, and the drawing read back: its shape, the drawing of the
    printed people bit for bit, and a pixel other than the input's at
    every drawn keypoint centre. Returns B1's launches."""
    scene = synthetic.make_dataset(1, img_h=480, img_w=640, seed=7)[0]
    image_path, out_path = directory / "scene.png", directory / "drawn.png"
    image_io.write_png(image_path, scene["image"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    text = cli_stdout(cli, ["predict", "--model-dir", str(directory),
                            "--image", str(image_path), "--output",
                            str(out_path)])
    command_s = time.perf_counter() - t0
    counted = dict(kernels.LAUNCHES)
    if counted != {decode.KERNEL: 1}:
        raise AssertionError(f"cli_predict: launches {counted}")
    people = [argparse.Namespace(box=np.asarray(p["box"]), score=p["score"],
                                 keypoints=np.asarray(p["keypoints"]))
              for p in json.loads(text)]
    if not people or not all(
            p.box.shape == (4,) and p.keypoints.shape == (17, 3)
            and np.isfinite(p.box).all() and np.isfinite(p.keypoints).all()
            for p in people):
        raise AssertionError("cli_predict: bad people")
    image = image_io.read_image(image_path)
    drawn = image_io.read_image(out_path)
    if not np.array_equal(image, scene["image"]) or \
            drawn.shape != (480, 640, 3):
        raise AssertionError(f"cli_predict: image read back as "
                             f"{drawn.shape}")
    if not np.array_equal(drawn, visualize.draw_predictions(image, people)):
        raise AssertionError("cli_predict: the PNG is not the drawing of "
                             "the printed people")
    centres = {(int(round(x)), int(round(y)))
               for p in people for x, y, s in p.keypoints if s > 0.05}
    same = [c for c in centres if (drawn[c[1], c[0]] == image[c[1], c[0]])
            .all()]
    if not centres or same:
        raise AssertionError(f"cli_predict: {len(same)} of {len(centres)} "
                             "keypoint centres left as the input")
    emit({"phase": "cli_predict", "card": card, "image": [480, 640],
          "persons": len(people), "keypoint_centres_drawn": len(centres),
          "changed_pixels": int((drawn != image).any(-1).sum()),
          "command_s": command_s, "launches": counted})
    return counted[decode.KERNEL]


FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "images"
TIMING_FIXTURE = "photo_480x640_q95_420.jpg"
PLAIN_FIXTURE = "scene_00_420_q75.jpg"


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def letterbox_size(h: int, w: int, s: int = 512) -> tuple[int, int]:
    """The eval runner's resize target (w, h) at model size s (the
    digests hold 512, the full-width models' size)."""
    scale = s / max(h, w)
    return int(round(w * scale)), int(round(h * scale))


def median_ms(fn, reps: int) -> float:
    """Median host time of `reps` calls of a host-only fn, after one."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_image_codec(image_io, image_codec, jpeg, card: str) -> None:
    """The host C library `csrc/image_codec.c`: its build (cc, timed),
    then every committed fixture (tests/fixtures/images, written by cv2
    on another machine) decoded by the C library and by the plain NumPy
    version: equal to each other and to cv2's digest (shape and sha256 of
    its RGB decode, Exif orientation applied), and the eval letterbox to
    512 by the C library and the plain version, equal to cv2's digest.
    Times on the host clock: the C decode of the 480x640 4:2:0 q95
    fixture (ms and MB/s of file), the plain decode of it and of one
    192x256 scene, and the C and plain letterbox resize of it."""
    t0 = time.perf_counter()
    image_codec.library()
    build_s = time.perf_counter() - t0
    digests = json.loads((FIXTURES / "digests.json").read_text())
    checked = {}
    for name, want in sorted(digests.items()):
        data = (FIXTURES / name).read_bytes()
        got = image_io.read_image(FIXTURES / name)
        if [list(got.shape), sha256(got)] != [want["shape"],
                                               want["rgb_sha256"]]:
            raise AssertionError(f"image_codec: {name} decodes to "
                                 f"{got.shape}, not cv2's digest")
        if name.startswith("c3_truncated"):
            try:
                image_io.decode_image(data, name)
            except ValueError:
                pass
            else:
                raise AssertionError(f"image_codec: {name}: bytes cut "
                                     "short decode (imdecode refuses)")
        if name.endswith(".jpg") and not name.startswith("c3_"):
            plain = image_io.apply_orientation(
                jpeg.decode_pixels(data),
                image_io.exif_orientation(jpeg.exif_block(data)))
            if not np.array_equal(plain, got):
                raise AssertionError(f"image_codec: {name}: the C library "
                                     "and the plain decoder differ")
        size = letterbox_size(*got.shape[:2])
        for how, fn in (("c", image_io.resize_linear),
                        ("plain", image_io.resize_linear_plain)):
            if sha256(fn(got, size)) != want["letterbox_sha256"]:
                raise AssertionError(f"image_codec: {name}: {how} letterbox "
                                     "is not cv2's")
        checked[name] = list(got.shape)
    data = (FIXTURES / TIMING_FIXTURE).read_bytes()
    rgb = image_io.decode_image(data)
    size = letterbox_size(*rgb.shape[:2])
    c_ms = median_ms(lambda: image_codec.decode_jpeg(data), 50)
    small = (FIXTURES / PLAIN_FIXTURE).read_bytes()
    t0 = time.perf_counter()
    jpeg.decode_pixels(data)
    plain_big_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jpeg.decode_pixels(small)
    plain_small_s = time.perf_counter() - t0
    emit({"phase": "image_codec", "card": card, "build_s": build_s,
          "fixtures": checked,
          "equal": "C = cv2 digest (imread), decode and letterbox, every "
                   "fixture; plain = C on the baseline ones; c3_truncated "
                   "bytes refused as imdecode refuses them",
          "timing_fixture": TIMING_FIXTURE, "timing_bytes": len(data),
          "c_decode_ms": c_ms,
          "c_decode_mb_per_s": len(data) / 1e6 / (c_ms / 1e3),
          "plain_decode_s": {TIMING_FIXTURE: plain_big_s,
                             PLAIN_FIXTURE: plain_small_s},
          "letterbox": [size[1], size[0]],
          "resize_c_ms": median_ms(
              lambda: image_io.resize_linear(rgb, size), 50),
          "resize_plain_ms": median_ms(
              lambda: image_io.resize_linear_plain(rgb, size), 5),
          "clock": "host perf_counter, median"})


def phase_eval_jpeg(cli, image_io, visualize, decode, kernels,
                    directory: Path, card: str) -> dict:
    """The command line on the committed JPEG fixtures with the model
    `phase_eval` exported: `eval --coco-json annotations.json --image-dir
    tests/fixtures/images --batched --batch-size 8` (10 scenes: exactly
    2 B1 launches and no other kernel; finite stats in [-1, 1]), `predict
    --image` the 480x640 JPEG `--output drawn.png` (1 B1 launch, people
    printed, the PNG read back equals the drawing of the printed people
    on the decoded JPEG) and `--output drawn.jpg`, which exits naming the
    suffix before the model runs. Returns B1's launches by command."""
    n_images = len(json.loads(
        (FIXTURES / "annotations.json").read_text())["images"])
    argv = ["eval", "--model-dir", str(directory), "--coco-json",
            str(FIXTURES / "annotations.json"), "--image-dir",
            str(FIXTURES), "--batched", "--batch-size", "8"]
    n_b1 = -(-n_images // 8)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    text = cli_stdout(cli, argv)
    eval_s = time.perf_counter() - t0
    counted = dict(kernels.LAUNCHES)
    stats = json.loads(text)
    if list(stats) != STAT_KEYS or not all(
            np.isfinite(v) and -1.0 <= v <= 1.0 for v in stats.values()):
        raise AssertionError(f"eval_jpeg: bad stats {stats}")
    if counted != {decode.KERNEL: n_b1}:
        raise AssertionError(f"eval_jpeg: launches {counted}, want "
                             f"{{{decode.KERNEL!r}: {n_b1}}}")
    launches = {"eval_jpeg_batched": n_b1}

    image_path = FIXTURES / TIMING_FIXTURE
    out_path = directory / "drawn_jpeg.png"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    text = cli_stdout(cli, ["predict", "--model-dir", str(directory),
                            "--image", str(image_path), "--output",
                            str(out_path)])
    predict_s = time.perf_counter() - t0
    predict_counted = dict(kernels.LAUNCHES)
    if predict_counted != {decode.KERNEL: 1}:
        raise AssertionError(f"eval_jpeg: predict launches "
                             f"{predict_counted}")
    people = [argparse.Namespace(box=np.asarray(p["box"]), score=p["score"],
                                 keypoints=np.asarray(p["keypoints"]))
              for p in json.loads(text)]
    if not people or not all(np.isfinite(p.box).all()
                             and np.isfinite(p.keypoints).all()
                             for p in people):
        raise AssertionError("eval_jpeg: predict printed no people")
    image = image_io.read_image(image_path)
    if not np.array_equal(image_io.read_image(out_path),
                          visualize.draw_predictions(image, people)):
        raise AssertionError("eval_jpeg: the PNG is not the drawing of the "
                             "printed people")
    launches["cli_predict_jpeg"] = 1

    kernels.reset_launches()
    jpg_out = directory / "drawn.jpg"
    try:
        cli_stdout(cli, ["predict", "--model-dir", str(directory), "--image",
                         str(image_path), "--output", str(jpg_out)])
    except SystemExit as exc:
        message = str(exc.code)
    else:
        raise AssertionError("eval_jpeg: --output drawn.jpg did not exit")
    if ".jpg" not in message or "PNG" not in message or kernels.LAUNCHES \
            or jpg_out.exists():
        raise AssertionError(f"eval_jpeg: --output drawn.jpg: {message!r}, "
                             f"launches {kernels.LAUNCHES}")
    emit({"phase": "eval_jpeg", "card": card, "argv": argv,
          "images": n_images, "stats": stats, "launches": counted,
          "eval_command_s": eval_s,
          "img_per_s_command": n_images / eval_s,
          "predict_image": TIMING_FIXTURE, "persons": len(people),
          "predict_command_s": predict_s, "predict_launches":
              predict_counted, "output_jpg_exit": message})
    return launches


# --- training ----------------------------------------------------------------

TRAIN_IMAGE, TRAIN_BATCH, FAST_BATCH = 512, 32, 64
TINY_IMAGE, TINY_BATCH = 128, 8
# The JAX package's loop logs its step's metrics plus these two.
TRAIN_METRIC_KEYS = sorted(["heatmap_loss", "segmentation_loss", "cls_loss",
                            "box_loss", "detector_loss", "total_loss",
                            "grad_norm", "step", "images_per_sec"])


def tiny_train_config(Config, **train):
    """`__graft_entry__._tiny_config`'s shapes (the JAX package's train
    smoke): Config.fast()'s architecture family at test widths, float32."""
    cfg = Config()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, backbone_width=0.25, fpn_channels=32,
            head_channels=32, kp_head_convs=1, kp_smooth_pyramid=False,
            kp_p2_late=True, stem_stride=4),
        detector=dataclasses.replace(cfg.detector, pre_nms_top_k=100,
                                     max_detections=8, score_threshold=0.0),
        prn=dataclasses.replace(cfg.prn, crop_height=14, crop_width=10,
                                hidden_units=64, max_persons=8),
        decode=dataclasses.replace(cfg.decode, max_peaks_per_channel=4),
        train=dataclasses.replace(
            cfg.train, image_size=TINY_IMAGE, batch_size=TINY_BATCH,
            num_steps=10, warmup_steps=2, **train))


def seeded_model(MultiPoseNet, cfg, seed: int = 0):
    model = MultiPoseNet(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def card_cpu_steps(cfg, model, batches, steps_lib, device,
                   lockstep: bool = False) -> dict:
    """3 steps of `cfg` in float32 with TF32 off, on the card and on the
    CPU from the same weights and batches: each step's metrics and batch
    statistics, and their errors card against CPU. Steps 1 and 2 run on
    the same parameters (lr is 0 at the first update): losses to 1e-4
    relative and batch statistics to 1e-5, grad_norm to 1e-2 (float32
    gradients of this tiny model flip ReLU gates on its 1x1 and 2x2 maps:
    on the card and on the CPU alike they part from the float64 gradient
    by up to 1e-3 in the global norm and 2.5% on single leaves). Step 3
    follows the first real update, where Adam moves elements of
    near-zero gradient by about ±lr on the sign of their rounding: 1e-2
    there for the losses, and its batch statistics are reported, not
    held. With `lockstep`, the card's state is set to the CPU's after
    every step, so each step starts from the same state on both, and
    every step is held as steps 1 and 2 are."""
    wheres = (device, torch.device("cpu"))
    runs = ([], []), ([], [])  # (metrics, batch statistics): card, CPU
    with no_tf32():
        states = [steps_lib.create_train_state(
            cfg, model=copy.deepcopy(model), device=where)
            for where in wheres]
        step = steps_lib.make_train_step(cfg)
        for b in batches:
            for state, where, (metrics, stats) in zip(states, wheres, runs):
                state, m = step(state, steps_lib.batch_to(b, where))
                metrics.append({k: float(v) for k, v in m.items()})
                stats.append({k: v.detach().cpu().clone()
                              for k, v in state.batch_stats.items()})
            if lockstep:
                states[0].load_state_dict(states[1].state_dict())
    (card_m, card_s), (cpu_m, cpu_s) = runs
    errs = []
    for i in range(len(batches)):
        loss_err = max(rel_err(card_m[i][k], cpu_m[i][k]) for k in cpu_m[i]
                       if k != "grad_norm")
        norm_err = rel_err(card_m[i]["grad_norm"], cpu_m[i]["grad_norm"])
        stat_err = max(float((card_s[i][k] - v).abs().max())
                       for k, v in cpu_s[i].items())
        errs.append({"step": i + 1, "max_rel_err_losses": loss_err,
                     "rel_err_grad_norm": norm_err,
                     "max_abs_err_batch_stats": stat_err})
        tight = i < 2 or lockstep
        ok = (loss_err <= (1e-4 if tight else 1e-2) and norm_err <= 1e-2
              and (stat_err <= 1e-5 or not tight))
        if not ok:
            raise AssertionError(f"card against CPU: step {i + 1}: "
                                 f"{errs[-1]}")
    return {"card_vs_cpu": errs, "lockstep": lockstep,
            "card_metrics": card_m}


def phase_train_parity(Config, MultiPoseNet, synthetic, loader, steps_lib,
                       device, card: str) -> dict:
    """The tiny config in float32, TF32 off: 3 steps on the card and 3 on
    the CPU from the same seeded weights and batches (`card_cpu_steps`).
    Then 20 steps with warmup 2 on one batch on the card: total_loss
    falls by at least half."""
    cfg = tiny_train_config(Config)
    records = synthetic.make_dataset(3 * TINY_BATCH, img_h=192, img_w=160,
                                     seed=5)
    rng = np.random.RandomState(11)
    batches = [loader.make_batch(records[i * TINY_BATCH:(i + 1) * TINY_BATCH],
                                 TINY_IMAGE, cfg.prn.max_persons, rng)
               for i in range(3)]
    model = seeded_model(MultiPoseNet, cfg)
    parity = card_cpu_steps(cfg, model, batches, steps_lib, device)
    fit_cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_steps=20))
    state = steps_lib.create_train_state(
        fit_cfg, model=copy.deepcopy(model), device=device)
    step = steps_lib.make_train_step(fit_cfg)
    one = steps_lib.batch_to(batches[0], device)
    curve = []
    for _ in range(20):
        state, m = step(state, one)
        curve.append(float(m["total_loss"]))
    if not (np.isfinite(curve).all() and curve[-1] <= 0.5 * curve[0]):
        raise AssertionError(f"train_parity: 20 steps on one batch: {curve}")
    emit({"phase": "train_parity", "card": card, "config": "tiny f32",
          "image": TINY_IMAGE, "batch": TINY_BATCH, "tf32": False,
          **parity, "fit_one_batch_total_loss": curve})
    return {"steps": 3}


def loader_img_per_s(loader, records, cfg, batches: int) -> float:
    """The loader's own rate: `batches` batches from a fresh iterator
    with augmentation (and the coverage maps of records with masks), host
    clock, nothing else running."""
    it = loader.batch_iterator(records, cfg.train.batch_size,
                               cfg.train.image_size, cfg.prn.max_persons,
                               seed=1, train=True,
                               mask_stride=cfg.model.output_stride)
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    return batches * cfg.train.batch_size / (time.perf_counter() - t0)


def timed_train(cfg, MultiPoseNet, synthetic, loader, steps_lib, device,
                warm: int, timed: int) -> dict:
    """`warm` + `timed` steps of `cfg` fed by `batch_iterator` over the
    synthetic scenes `train --synthetic` reads (64 at 256²), augmented.
    Step times on CUDA events around each call (host to device copy of
    the batch included); peak device memory over the steps."""
    records = synthetic.make_dataset(64, img_h=256, img_w=256, seed=0)
    batches = loader.batch_iterator(records, cfg.train.batch_size,
                                    cfg.train.image_size,
                                    cfg.prn.max_persons, train=True)
    state = steps_lib.create_train_state(
        cfg, model=seeded_model(MultiPoseNet, cfg), device=device)
    step = steps_lib.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(warm + timed):
        b = next(batches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, steps_lib.batch_to(b, device))
        end.record()
        end.synchronize()
        losses.append({k: float(v) for k, v in m.items()})
        if i >= warm:
            times.append(start.elapsed_time(end))
    if not all(np.isfinite(list(m.values())).all() for m in losses):
        raise AssertionError(f"training: losses not finite: {losses}")
    step_ms = statistics.median(times)
    return {"step_ms": step_ms, "step_ms_each": times,
            "train_img_per_s": cfg.train.batch_size * 1e3 / step_ms,
            "loader_img_per_s": loader_img_per_s(loader, records, cfg, 3),
            "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "last_metrics": losses[-1]}


def phase_train_default(Config, MultiPoseNet, synthetic, loader, steps_lib,
                        device, card: str) -> None:
    """Config() (the command line's default: float32, full width and
    depth) at 512², batch 32: 2 warm-up and 5 timed steps."""
    flags = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, image_size=TRAIN_IMAGE, batch_size=TRAIN_BATCH))
    out = timed_train(cfg, MultiPoseNet, synthetic, loader, steps_lib,
                      device, 2, 5)
    emit({"phase": "train_default", "card": card, "config": "Config() f32",
          "image": TRAIN_IMAGE, "batch": TRAIN_BATCH, "tf32_flags": flags,
          "clock": "CUDA events per step; loader on the host clock", **out})


def phase_train_fast(Config, MultiPoseNet, synthetic, loader, steps_lib,
                     device, card: str) -> None:
    """Config.fast() (bfloat16) at 512², batch 64: 3 steps, the last 2
    timed."""
    cfg = Config.fast()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, image_size=TRAIN_IMAGE, batch_size=FAST_BATCH))
    out = timed_train(cfg, MultiPoseNet, synthetic, loader, steps_lib,
                      device, 1, 2)
    emit({"phase": "train_fast", "card": card, "config": "Config.fast() bf16",
          "image": TRAIN_IMAGE, "batch": FAST_BATCH, **out})


def phase_train_cli(Config, cli, export, train_ckpt, decode, kernels,
                    device, directory: Path, card: str, prn=None) -> int:
    """`train --synthetic 16 --steps 3 --config <tiny> --model-dir <dir>`
    in this process on the card: metrics.jsonl has the JAX loop's keys
    at steps 1..3; `--steps 5` again resumes from the checkpoint at step
    3 (logs steps 4 and 5 only); the exported EMA model loads into the
    port's Predictor on the card and one `predict` launches B1 exactly
    once. Returns that launch. The tiny config keeps `prn` (the default
    PRNConfig unless given), so that `train_prn` can train that PRN into
    the same directory."""
    ckpt = directory / "train_ckpt"
    cfg = tiny_train_config(Config, checkpoint_dir=str(ckpt),
                            log_interval_steps=1, save_interval_steps=100)
    cfg = cfg.replace(prn=prn or Config().prn)
    cfg_path = directory / "train_cfg.json"
    cfg_path.write_text(cfg.to_json())
    model_dir = directory / "trained"
    argv = ["train", "--synthetic", "16", "--config", str(cfg_path),
            "--model-dir", str(model_dir)]
    t0 = time.perf_counter()
    first = cli_stdout(cli, argv + ["--steps", "3"])
    first_s = time.perf_counter() - t0
    second = cli_stdout(cli, argv + ["--steps", "5"])
    logged = [json.loads(line) for text in (first, second)
              for line in text.splitlines() if line.startswith("{")]
    lines = [json.loads(line) for line in
             (ckpt / "metrics.jsonl").read_text().splitlines()]
    if [m["step"] for m in lines] != [1, 2, 3, 4, 5] or lines != logged \
            or any(sorted(m) != TRAIN_METRIC_KEYS for m in lines):
        raise AssertionError(f"train_cli: metrics {lines}")
    if train_ckpt.CheckpointManager(ckpt).latest_step() != 5:
        raise AssertionError("train_cli: no checkpoint at step 5")
    pred = export.load_predictor(model_dir)
    if pred.device.type != device.type:
        raise AssertionError("train_cli: the predictor is not on the card")
    image = planted_scenes(np.random.RandomState(3), 1, 200, 240)[0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    people = pred.predict(image)
    torch.cuda.synchronize()
    if dict(kernels.LAUNCHES) != {decode.KERNEL: 1}:
        raise AssertionError(f"train_cli: predict launches "
                             f"{kernels.LAUNCHES}")
    emit({"phase": "train_cli", "card": card, "argv": argv,
          "steps_logged": [m["step"] for m in lines],
          "first_command_s": first_s, "persons": len(people),
          "predict_launches": {decode.KERNEL: 1}})
    return 1


SEGMENTATION_FIXTURE = FIXTURES / "annotations_segs.json"
# The segmentation fixture's 10 scenes, repeated to fill batches of 32.
MASK_RECORD_REPEATS = 4
PRN_STEPS, PRN_TIMED = 50, 10


def masked_records(prepare, directory: Path) -> list[dict]:
    """The shards `prepare --coco-json <segmentation fixture>` wrote under
    `directory`, read back, MASK_RECORD_REPEATS times over."""
    records = list(prepare.read_shards(directory))
    if sum(r["person_mask"] is not None for r in records) != len(records):
        raise AssertionError("prepare_masks: records without masks")
    return records * MASK_RECORD_REPEATS


def phase_prepare_masks(Config, MultiPoseNet, cli, prepare, loader,
                        train_loop, steps_lib, device, directory: Path,
                        card: str) -> None:
    """`prepare --coco-json <segmentation fixture> --image-dir
    tests/fixtures/images` in this process writes the shards; read_shards
    → batch_iterator(mask_stride=4) → train.loop.train takes 3 steps of
    Config() f32 at 512², batch 32, every image with masks (the soft-mask
    targets). Step ms from the loop's images_per_sec (host clock, logged
    every step; the loop fetches the metrics, which waits for the card),
    the loader's img/s with masks, peak device memory. Then the tiny
    config on masked batches, card against CPU in lockstep
    (`card_cpu_steps`: every step from the same state, every step held
    as train_parity holds its first two)."""
    shards = directory / "shards"
    t0 = time.perf_counter()
    out = json.loads(cli_stdout(cli, [
        "prepare", "--coco-json", str(SEGMENTATION_FIXTURE), "--image-dir",
        str(FIXTURES), "--output-dir", str(shards)]).strip())
    prepare_s = time.perf_counter() - t0
    records = masked_records(prepare, shards)
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, image_size=TRAIN_IMAGE, batch_size=TRAIN_BATCH,
        checkpoint_dir=str(directory / "masks_ckpt"), log_interval_steps=1))
    batches = loader.batch_iterator(
        records, cfg.train.batch_size, cfg.train.image_size,
        cfg.prn.max_persons, train=True,
        mask_stride=cfg.model.output_stride)
    first = next(batches)
    hm = TRAIN_IMAGE // cfg.model.output_stride
    if not first["has_mask"].all() or first["exclude_cov"].shape != (
            TRAIN_BATCH, hm, hm):
        raise AssertionError("prepare_masks: the batch has no coverage maps")

    def with_first():
        yield first
        yield from batches

    logged = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_loop.train(cfg, with_first(), num_steps=3, log_fn=logged.append,
                     checkpoint=False, device=device)
    if [m["step"] for m in logged] != [1, 2, 3] or not all(
            np.isfinite(m["total_loss"]) for m in logged):
        raise AssertionError(f"prepare_masks: metrics {logged}")
    step_ms = [TRAIN_BATCH * 1e3 / m["images_per_sec"] for m in logged]
    peak = torch.cuda.max_memory_allocated() / 1e9
    tiny = tiny_train_config(Config)
    rng = np.random.RandomState(11)
    tiny_batches = [loader.make_batch(
        records[i * TINY_BATCH:(i + 1) * TINY_BATCH], TINY_IMAGE,
        tiny.prn.max_persons, rng, mask_stride=tiny.model.output_stride)
        for i in range(3)]
    parity = card_cpu_steps(tiny, seeded_model(MultiPoseNet, tiny),
                            tiny_batches, steps_lib, device, lockstep=True)
    emit({"phase": "prepare_masks", "card": card,
          "shards": [Path(p).name for p in out["shards"]],
          "prepare_s": prepare_s, "records": len(records),
          "config": "Config() f32", "image": TRAIN_IMAGE,
          "batch": TRAIN_BATCH,
          "clock": "host, the loop's images_per_sec per step",
          "step_ms_each": step_ms, "step_ms": statistics.median(step_ms[1:]),
          "train_img_per_s": TRAIN_BATCH * 1e3
          / statistics.median(step_ms[1:]),
          "loader_img_per_s_masks": loader_img_per_s(loader, records, cfg, 3),
          "peak_device_mem_gb": peak, "last_metrics": logged[-1],
          "tiny_masked": {"config": "tiny f32", "tf32": False, **parity}})


def prn_step_ms(Config, prn_train, loader, synthetic, device,
                cfg=None) -> dict:
    """The PRN step of `cfg` (Config() unless given: 56x36 crops, 1024
    hidden units, 32 persons, 512², batch 64) on one batch, CUDA events
    around each call: 3 warm-up, PRN_TIMED timed."""
    cfg = cfg or Config()
    t = cfg.train
    records = synthetic.make_dataset(t.batch_size, img_h=256, img_w=256,
                                     seed=3)
    b = loader.make_batch(records, t.image_size, cfg.prn.max_persons,
                          train=False)
    batch = {k: torch.as_tensor(b[k]).to(device)
             for k in prn_train.BATCH_KEYS}
    state = prn_train.create_prn_state(cfg, device)
    step = prn_train.make_prn_train_step(cfg)
    times = []
    for i in range(3 + PRN_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        end.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    return {"prn_step_ms": statistics.median(times),
            "prn_step_ms_each": times, "batch": t.batch_size,
            "image": t.image_size,
            "crop": [cfg.prn.crop_height, cfg.prn.crop_width],
            "hidden_units": cfg.prn.hidden_units,
            "persons": cfg.prn.max_persons,
            "prn_loss_last": float(m["prn_loss"])}


def prn_card_cpu(Config, prn_train, loader, synthetic, device) -> list:
    """3 PRN steps of a tiny config (14x10 crops, 64 hidden units, 8
    persons, 128², batch 8) in float32 with TF32 off, on the card and on
    the CPU from the same seeded init and batches, in lockstep (the
    card's state set to the CPU's after every step): each step's loss,
    card against CPU, to 1e-4 relative; the accuracy (an argmax count)
    is reported."""
    cfg = tiny_train_config(Config)
    records = synthetic.make_dataset(3 * TINY_BATCH, img_h=192, img_w=160,
                                     seed=7)
    batches = [loader.make_batch(records[i * TINY_BATCH:(i + 1) * TINY_BATCH],
                                 TINY_IMAGE, cfg.prn.max_persons,
                                 train=False) for i in range(3)]
    wheres = (device, torch.device("cpu"))
    rows = []
    with no_tf32():
        states = [prn_train.create_prn_state(cfg, w) for w in wheres]
        step = prn_train.make_prn_train_step(cfg)
        for i, b in enumerate(batches):
            got = []
            for state, where in zip(states, wheres):
                _, m = step(state, {k: torch.as_tensor(b[k]).to(where)
                                    for k in prn_train.BATCH_KEYS})
                got.append({k: float(v) for k, v in m.items()})
            states[0].load_state_dict(states[1].state_dict())
            err = rel_err(got[0]["prn_loss"], got[1]["prn_loss"])
            rows.append({"step": i + 1, "card": got[0], "cpu": got[1],
                         "rel_err_loss": err})
            if err > 1e-4:
                raise AssertionError(f"train_prn: card against CPU {rows}")
    return rows


def phase_train_prn(Config, cli, export, prn_train, loader, synthetic,
                    decode, kernels, device, directory: Path, card: str,
                    prn_config=None) -> int:
    """`train-prn --synthetic 64 --steps PRN_STEPS --model-dir <train_cli's
    export> --device cuda` in this process (Config(), or `prn_config`
    through --config): prn.msgpack written there, its loss logged at step
    50; `predict` with that directory launches B1 once (the exported
    model with the trained PRN). Then the PRN step's time at full width
    and the tiny config's losses card against CPU. Returns the launch."""
    model_dir = directory / "trained"
    argv = ["train-prn", "--synthetic", "64", "--steps", str(PRN_STEPS),
            "--model-dir", str(model_dir), "--device", device.type]
    if prn_config is not None:
        path = directory / "prn_cfg.json"
        path.write_text(prn_config.to_json())
        argv += ["--config", str(path)]
    t0 = time.perf_counter()
    text = cli_stdout(cli, argv)
    command_s = time.perf_counter() - t0
    logged = [json.loads(line) for line in text.splitlines()
              if line.startswith("{")]
    if [m["step"] for m in logged] != [50] or sorted(logged[0]) != [
            "prn_accuracy", "prn_loss", "step"]:
        raise AssertionError(f"train_prn: logged {logged}")
    pred = export.load_predictor(model_dir)
    trained = export.load_model(model_dir)[2]
    got = pred.prn_variables["params"]["out_cm"]["kernel"]
    if not np.array_equal(got, trained["params"]["out_cm"]["kernel"]):
        raise AssertionError("train_prn: the predictor's PRN is not the "
                             "trained one")
    image = planted_scenes(np.random.RandomState(4), 1, 200, 240)[0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    people = pred.predict(image)
    torch.cuda.synchronize()
    if dict(kernels.LAUNCHES) != {decode.KERNEL: 1}:
        raise AssertionError(f"train_prn: predict launches "
                             f"{kernels.LAUNCHES}")
    emit({"phase": "train_prn", "card": card, "argv": argv,
          "command_s": command_s, "logged": logged,
          "persons": len(people), "predict_launches": {decode.KERNEL: 1},
          **prn_step_ms(Config, prn_train, loader, synthetic, device,
                        prn_config),
          "clock": "CUDA events per step",
          "tiny_card_vs_cpu": prn_card_cpu(Config, prn_train, loader,
                                           synthetic, device)})
    return 1


def trace_summary(prof, window_ms: float) -> dict:
    """The traced window's device kernels: the 10 with the most time
    (summed over launches) and the device's idle share, 1 - the union of
    the kernels' intervals over the window on the host clock."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"device_trace": False, "idle_share": "not measured",
                "top_device_ops": []}
    by_name: dict[str, list] = {}
    for e in kernels:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us()
        entry[1] += 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_trace": True, "window_ms": window_ms,
            "device_busy_ms": busy / 1e3,
            "idle_share": max(0.0, 1.0 - busy / 1e3 / window_ms),
            "kernel_ms_total": total / 1e3, "kernel_launches": len(kernels),
            "top_device_ops": [
                {"name": name[:120], "ms": us / 1e3, "calls": n,
                 "share": us / total} for name, (us, n) in top]}


def phase_profile_train(Config, MultiPoseNet, synthetic, loader, steps_lib,
                        profiling, device, directory: Path,
                        card: str) -> None:
    """`utils.profiling.trace` around 2 steps of `train_default`'s
    Config() f32 at 512², batch 32, after 2 warm-up steps, the batches
    already on the card: the 10 device operations with the most time and
    the device's idle share in the traced window."""
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, image_size=TRAIN_IMAGE, batch_size=TRAIN_BATCH))
    records = synthetic.make_dataset(64, img_h=256, img_w=256, seed=0)
    it = loader.batch_iterator(records, TRAIN_BATCH, TRAIN_IMAGE,
                               cfg.prn.max_persons, train=True)
    batches = [steps_lib.batch_to(next(it), device) for _ in range(4)]
    state = steps_lib.create_train_state(
        cfg, model=seeded_model(MultiPoseNet, cfg), device=device)
    step = steps_lib.make_train_step(cfg)
    for b in batches[:2]:
        state, m = step(state, b)
    torch.cuda.synchronize()
    with profiling.trace(directory / "profile_train") as prof:
        t0 = time.perf_counter()
        for b in batches[2:]:
            state, m = step(state, b)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    trace_bytes = (directory / "profile_train" / "trace.json").stat().st_size
    emit({"phase": "profile_train", "card": card, "config": "Config() f32",
          "image": TRAIN_IMAGE, "batch": TRAIN_BATCH, "steps": 2,
          "trace_json_bytes": trace_bytes,
          "clock": "profiler kernel intervals; window on the host clock",
          **trace_summary(prof, window_ms)})


def ptxas_summary(log: str) -> dict:
    """Registers, stack frame, spills and shared memory that `nvcc -Xptxas
    -v` reports for the instantiations the main paths take: every
    instantiation of the decode kernels (B1, B2 and the generic one,
    whatever their template arguments), the f32 tail's 17 outputs padded
    to 20 (KP), the bf16 tail's three n8 tiles (kp_tail_mma, NT = 3) and
    B4 (column_topk)."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return {k: v for k, v in out.items()
            if "decode_" in k or "column_topk" in k or "Li20E" in k
            or ("kp_tail_mma" in k and "Li3E" in k)}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    try:
        from multiposenet_tpu_torch import cli, kernels
        from multiposenet_tpu_torch.config import Config
        from multiposenet_tpu_torch.data import loader, synthetic
        from multiposenet_tpu_torch.eval import runner
        from multiposenet_tpu_torch.infer import export, folding
        from multiposenet_tpu_torch.infer.predictor import Predictor
        from multiposenet_tpu_torch.models import layers
        from multiposenet_tpu_torch.models.posenet import MultiPoseNet
        from multiposenet_tpu_torch.ops import (column_topk, decode,
                                                detection, kp_tail)
        from multiposenet_tpu_torch.ops import image as image_ops
        from multiposenet_tpu_torch.tools import dbench2
        from multiposenet_tpu_torch.data import prepare
        from multiposenet_tpu_torch.train import checkpoints as train_ckpt
        from multiposenet_tpu_torch.train import loop as train_loop
        from multiposenet_tpu_torch.train import prn_train
        from multiposenet_tpu_torch.train import steps as steps_lib
        from multiposenet_tpu_torch.utils import (image_codec, image_io, jpeg,
                                                  profiling, visualize)
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"{smi} (nvidia-smi name, power.limit)"
    t0 = time.perf_counter()
    kernels.load_all(list(kernels.KERNEL_NAMES))
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_summary(log)
             for name, log in kernels.BUILD_LOGS.items()}
    emit({"phase": "device", "card": card,
          "torch_device_name": torch.cuda.get_device_name(0),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernels_built": sorted(ptxas),
          "build_s": build_s, "ptxas": ptxas})

    rows = [phase_decode_kernel(decode, kernels, Config.fast().decode, device),
            phase_decode_lanes_kernel(decode, Config.crowd().decode, device),
            phase_decode_generic_kernel(decode, kernels, Config.fast().decode,
                                        device, ptxas),
            phase_tail_kernel(kp_tail, layers, device),
            phase_column_topk_kernel(column_topk, dbench2, kernels,
                                     device, ptxas)]
    phase_parity_f32(Config, MultiPoseNet, folding, kp_tail, kernels,
                     image_ops, device)
    # Each path's launches, counted from 0 just before it runs.
    b1_paths = {"pipeline": phase_pipeline(
        Config, Predictor, decode, kernels, image_ops, detection, card)}
    launches = phase_pipeline_crowd(
        Config, Predictor, decode, kp_tail, kernels, image_ops, detection,
        card)
    launches[decode.GENERIC_KERNEL] = phase_predict_generic(
        Config, Predictor, decode, kernels, card)
    pred, batch, b1_paths["pipeline_default"] = phase_pipeline_default(
        Config, Predictor, decode, kernels, image_ops, detection, card)
    phase_export(pred, batch, export, kernels, card)
    del pred, batch
    b1_paths["predict_default"] = phase_predict_default(
        Config, Predictor, decode, kernels, card)
    launches[column_topk.KERNEL] = phase_dbench2(dbench2, column_topk,
                                                 decode, kernels)
    phase_image_codec(image_io, image_codec, jpeg, card)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="cli_",
                                     dir=kernels.BUILD_DIR) as directory:
        b1_paths.update(phase_eval(Config, Predictor, export, cli, runner,
                                   decode, kernels, Path(directory), card))
        b1_paths["cli_predict"] = phase_cli_predict(
            cli, image_io, visualize, synthetic, decode, kernels,
            Path(directory), card)
        b1_paths.update(phase_eval_jpeg(cli, image_io, visualize, decode,
                                        kernels, Path(directory), card))
        phase_train_parity(Config, MultiPoseNet, synthetic, loader,
                           steps_lib, device, card)
        phase_train_default(Config, MultiPoseNet, synthetic, loader,
                            steps_lib, device, card)
        phase_train_fast(Config, MultiPoseNet, synthetic, loader, steps_lib,
                         device, card)
        b1_paths["train_cli_predict"] = phase_train_cli(
            Config, cli, export, train_ckpt, decode, kernels, device,
            Path(directory), card)
        phase_prepare_masks(Config, MultiPoseNet, cli, prepare, loader,
                            train_loop, steps_lib, device, Path(directory),
                            card)
        b1_paths["train_prn_predict"] = phase_train_prn(
            Config, cli, export, prn_train, loader, synthetic, decode,
            kernels, device, Path(directory), card)
        phase_profile_train(Config, MultiPoseNet, synthetic, loader,
                            steps_lib, profiling, device, Path(directory),
                            card)
    launches[decode.KERNEL] = sum(b1_paths.values())
    rows[0]["launches_by_path"] = b1_paths
    for row in rows:
        row["launches"] = launches[row["name"]]
        if not row["launches"]:
            raise AssertionError(f"{row['name']} never ran on its path")
    emit({"phase": "done", "elapsed_s": time.perf_counter() - t_start})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
