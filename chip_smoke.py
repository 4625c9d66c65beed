"""Smoke test of the PyTorch port (`multiposenet_tpu_torch`) on one NVIDIA
GPU: builds the hand-written CUDA kernels from `csrc/` (B1 decode_peaks,
B2 decode_lanes, decode_generic, B3 kp_tail, B4 column_topk, and the
train step's update, adam_update and ema_update of train_update), holds
each against its plain PyTorch version at the shapes its paths give it
(the update bit for bit, phase `train_update_kernel`; B2
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
on a 480x640 PNG, read back (phase `cli_predict`, one launch),
`--image scene.webp --output drawn.webp`, `--image scene_jpeg.tif
--output drawn.hdr`, a damaged JPEG, the photo with stray bytes before
an Exif APP1 of orientation 6 (read turned), the committed gray JPEG
2000 file, the photo as cv2.imwrite writes it in AVIF, a crop of it
cv2.imwrite writes in lossless AVIF (quality 100), one it writes in
10-bit AVIF (IMWRITE_AVIF_DEPTH 10), a limited-range BT.709 AVIF
crop from libavif's encoder, the container forms (a grid, a sequence)
and libaom's film grain and segmentation (a `film-grain-test` still, an
`aq-mode=1` sequence) (one launch each).
Before them, phase `image_codec`
builds the host C libraries (`csrc/image_codec.c`, `csrc/webp.c`,
`csrc/jpeg2000.c`, `csrc/av1.c`, `csrc/av1_encode.c`) and holds their
JPEG, WebP, TIFF (JPEG,
CCITT, CMYK, YCbCr, CIELab), Radiance HDR, JPEG 2000 and AVIF decodes
and letterbox resize, and the plain versions, to cv2's digests of the
committed fixtures (tests/fixtures/images), the
HDR and GIF writers, C and plain, to cv2's bytes, the JPEG 2000 writer,
C on every fixture of both sides at least 32 and the photo, plain on the
smallest, to cv2's bytes (the JP2 boxes alone for the others), the
AVIF writer, C on the photo, to cv2's bytes (the committed fixture), and
plain = C on a crop, the
lossless WebP
writer, C and plain, to a round trip within 1.5 times cv2's size on each
fixture, and recorded corruptions (changed scan bytes, stray bytes before
each JPEG header segment, every sampling factor of the block-smoothed
files) to cv2's digests of them; after them, phase `eval_jpeg` runs `eval --batched` on those
JPEGs (two launches), `predict` on the 480x640 JPEG with `--output` a
PNG, `drawn.jpg`, `drawn.gif` (one launch each; each file the plain
writer's bytes of the drawing), `drawn.jp2` (one launch; the plain
JPEG 2000 writer's bytes of the drawing) and `drawn.avif` (one launch;
an in-process encode of the drawing, read back by the port's decoder).
Then training, which
reaches no TPU kernel (the fused tail is off in training and the decodes
are inference only) but runs the update kernels: phase `train_parity`
holds 3 steps of the tiny config in float32 on the card against the CPU
and fits one batch in 20 steps, and holds the update card against CPU
bit for bit (again at Config()'s shapes in `train_default`); `train_default` times Config() at 512², batch 32, fed by the
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
against CPU; `train_to_ap` trains from the port's init to the JAX
package's quality, the slow AP gate's recipe at 96² (500 + 150 steps, its
floors; the update kernels' launches on the main path are counted
there) and Config.fast() at 512² through
`tools/train_synthetic_512.py --style v1` (1200 + 400 steps, half the JAX
package's AP), each eval `predict` and `predict_given_boxes` one B1
launch; `train_ddp` holds data-parallel training against one rank;
`profile_train` traces 2 steps of `train_default` with
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
import functools
import hashlib
import io
import json
import math
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
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
BATCH, IMAGE = 128, 512
# Config()'s batch: BASELINE.json config 5 runs the default model at 64.
DEFAULT_BATCH = 64


# Host clock at import: each phase's line carries the seconds since
# (`t_s`), so the script's time splits by phase.
T0 = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
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
          "tolerance": "1e-3 x max(1, max|cpu|)", "max_abs_err": errs,
          "normalize_bit_equal": normalize_checks(image_ops, imgs, device)})


def normalize_checks(image_ops, imgs: np.ndarray, device) -> dict:
    """The input normalization on the card against the CPU, bit for bit:
    every uint8 value of every channel, the s2d-flat and s4-flat cells of
    uint8 batches, and one letterboxed 480x640 `predict` input (float
    pixels, the float64 multiply-add path). Both compute what the JAX
    package's compiled programs compute (tests/test_torch_normalize.py)."""
    values = torch.arange(256, dtype=torch.uint8)[:, None].repeat(1, 3)
    photo = planted_scenes(np.random.RandomState(3), 1, 480, 640)[0]
    cases = {
        "normalize_all_values": (image_ops.normalize, values),
        "normalize_s2d_flat": (image_ops.normalize_s2d_flat, torch.as_tensor(
            image_ops.space_to_depth_flat(imgs))),
        "normalize_s4_flat": (image_ops.normalize_s4_flat, torch.as_tensor(
            image_ops.space_to_depth_flat4(imgs))),
        "letterbox_480x640": (lambda x: image_ops.resize_pad_normalize(
            x, IMAGE)[0], torch.as_tensor(photo)),
    }
    out = {}
    for name, (fn, x) in cases.items():
        want, got = fn(x), fn(x.to(device))
        torch.cuda.synchronize()
        if got.device.type != device.type or not torch.equal(got.cpu(),
                                                             want):
            raise AssertionError(f"parity_f32: {name} on the card is not "
                                 "the CPU's bit for bit")
        out[name] = list(want.shape)
    return out


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
            sync_all()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync_all()
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
    (host resize into batches of 128 at 512², `make_batch_runner` over
    every visible card: one B1 launch a batch and card, 2 on one card) and the predict loop on 32 images (one B1
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
                              EVAL_IMAGES, -(-EVAL_IMAGES // EVAL_BATCH)
                              * torch.cuda.device_count()),
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
    every drawn keypoint centre; then `--output drawn.bmp` and `drawn.tif`
    (one B1 launch each) read back as that drawing, in the bytes of the
    plain writers, and `--image` the scene as a lossless WebP `--output
    drawn.webp` (one B1 launch), a RIFF…WEBPVP8L file read back as that
    drawing; then `--image` the scene as a JPEG-compressed TIFF `--output
    drawn.hdr` (one B1 launch), the drawing of the people printed for it
    in the plain HDR writer's bytes; then `--image damaged.jpg`, the
    480x640 photo fixture with two bytes of its scan changed (its recipe
    in the digests), one B1 launch, people printed, the image read as
    cv2 reads it (the recipe's digest); then `--image turned.jpg`, the
    photo with stray bytes and an Exif APP1 of orientation 6 put before
    its DQT (`exif_stray` in the digests), read turned to 640x480 as cv2
    reads it, one B1 launch, people printed; then `--image` the committed
    reversible gray JPEG 2000 file, read to cv2's digest, one B1 launch,
    people printed, its size and letterbox to the model's size reported;
    then `--image` the committed AVIF of the 480x640 photo (cv2.imwrite's
    file), the lossless one of its 128x160 crop (quality 100: 4:4:4,
    the identity matrix), the 10-bit one of a 96x128 crop
    (IMWRITE_AVIF_DEPTH 10), a limited-range BT.709 one of a 96x128
    crop (the libavif encoder's, as a video tool writes a frame), a grid
    of 2x2 cells of 64x64 cropped to 128x96 with an Exif item of
    orientation 6 (the libavif encoder's; read turned to 96x128, and
    `image_size` gives the turned sides) and a 3-frame Pillow image
    sequence of 48x64 (its first frame read), a 96x128 crop with libaom's
    film grain (`film-grain-test` 1) and a 2-frame `aq-mode=1` sequence
    of 48x64 (its first frame segmented), each read to cv2's digest,
    one B1 launch, people printed; the grid's and the sequence's form,
    and the median host time of their decode, and the grain and the
    segmentation reached (the C decoder's counters), reported. Returns
    B1's launches."""
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
    # The same drawing in cv2's BMP and TIFF, each from a predict of its
    # own (one B1 launch each), read back equal to the PNG's.
    written = {}
    for suffix in (".bmp", ".tif"):
        path = directory / f"drawn{suffix}"
        kernels.reset_launches()
        cli_stdout(cli, ["predict", "--model-dir", str(directory), "--image",
                         str(image_path), "--output", str(path)])
        if kernels.LAUNCHES != {decode.KERNEL: 1}:
            raise AssertionError(f"cli_predict: --output {suffix} launches "
                                 f"{kernels.LAUNCHES}")
        counted[decode.KERNEL] += 1
        if not np.array_equal(image_io.read_image(path), drawn) or \
                path.read_bytes() != image_io.encode_image_plain(drawn,
                                                                 suffix):
            raise AssertionError(f"cli_predict: drawn{suffix} is not the "
                                 "drawing in cv2's bytes")
        written[suffix] = path.stat().st_size
    # The scene in as WebP (lossless: the same pixels) and the drawing out
    # as WebP, one B1 launch.
    webp_in, path = directory / "scene.webp", directory / "drawn.webp"
    webp_in.write_bytes(image_io.encode_image(scene["image"], ".webp"))
    kernels.reset_launches()
    cli_stdout(cli, ["predict", "--model-dir", str(directory), "--image",
                     str(webp_in), "--output", str(path)])
    if kernels.LAUNCHES != {decode.KERNEL: 1}:
        raise AssertionError(f"cli_predict: --image scene.webp --output "
                             f"drawn.webp launches {kernels.LAUNCHES}")
    counted[decode.KERNEL] += 1
    data = path.read_bytes()
    if data[:4] != b"RIFF" or data[8:16] != b"WEBPVP8L" or \
            not np.array_equal(image_io.read_image(path), drawn):
        raise AssertionError("cli_predict: drawn.webp is not a lossless "
                             "WebP of the drawing")
    written[".webp"] = len(data)
    # The scene as a JPEG-compressed TIFF (the port's cv2 JPEG bytes as a
    # YCbCr 4:2:0 strip) in, the drawing of the people printed for it out
    # as Radiance HDR in the plain writer's bytes, one B1 launch.
    from multiposenet_tpu_torch.tools import image_samples as samples

    stream = image_io.encode_jpeg(scene["image"])
    tif_in, path = directory / "scene_jpeg.tif", directory / "drawn.hdr"
    tif_in.write_bytes(samples.tiff_bytes(
        scene["image"], 6, compression=7, chunks=[stream],
        tags=((530, 3, [2, 2]),)))
    tif_rgb = image_io.read_image(tif_in)
    if not np.array_equal(tif_rgb, image_io.decode_image(stream)):
        raise AssertionError("cli_predict: the JPEG TIFF does not read as "
                             "its JPEG stream")
    kernels.reset_launches()
    hdr_people = [argparse.Namespace(
        box=np.asarray(p["box"]), score=p["score"],
        keypoints=np.asarray(p["keypoints"])) for p in json.loads(
            cli_stdout(cli, ["predict", "--model-dir", str(directory),
                             "--image", str(tif_in), "--output",
                             str(path)]))]
    if kernels.LAUNCHES != {decode.KERNEL: 1}:
        raise AssertionError(f"cli_predict: --image scene_jpeg.tif --output "
                             f"drawn.hdr launches {kernels.LAUNCHES}")
    counted[decode.KERNEL] += 1
    data = path.read_bytes()
    if not hdr_people or data != image_io.encode_image_plain(
            visualize.draw_predictions(tif_rgb, hdr_people), ".hdr"):
        raise AssertionError("cli_predict: drawn.hdr is not the drawing of "
                             "the printed people in cv2's bytes")
    written[".hdr"] = len(data)
    # A JPEG whose scan holds damaged bytes, read as cv2 reads it (the
    # reference's predict reads it too), one B1 launch.
    recipe = json.loads((FIXTURES / "digests.json").read_text())[
        TIMING_FIXTURE]["corrupt"][0]
    damaged = directory / "damaged.jpg"
    damaged.write_bytes(samples.corrupted(
        (FIXTURES / TIMING_FIXTURE).read_bytes(), recipe["at"]))
    if sha256(image_io.read_image(damaged)) != recipe["rgb_sha256"]:
        raise AssertionError("cli_predict: damaged.jpg does not read as cv2 "
                             "reads it")
    kernels.reset_launches()
    damaged_people = json.loads(cli_stdout(
        cli, ["predict", "--model-dir", str(directory), "--image",
              str(damaged)]))
    if kernels.LAUNCHES != {decode.KERNEL: 1}:
        raise AssertionError(f"cli_predict: --image damaged.jpg launches "
                             f"{kernels.LAUNCHES}")
    counted[decode.KERNEL] += 1
    if not all(np.isfinite(p["box"]).all() and
               np.isfinite(p["keypoints"]).all() for p in damaged_people):
        raise AssertionError("cli_predict: bad people on damaged.jpg")
    # The photo with stray bytes and an Exif APP1 of orientation 6 before
    # its DQT (its recipe in the digests): read turned to 640x480 as cv2
    # reads it, image_size says so, one B1 launch, people printed.
    recipe = json.loads((FIXTURES / "digests.json").read_text())[
        TIMING_FIXTURE]["exif_stray"]
    turned = directory / "turned.jpg"
    turned.write_bytes(samples.corrupted(
        (FIXTURES / TIMING_FIXTURE).read_bytes(), recipe["at"]))
    turned_rgb = image_io.read_image(turned)
    if turned_rgb.shape != (640, 480, 3) or \
            sha256(turned_rgb) != recipe["rgb_sha256"] or \
            image_io.image_size(turned) != (640, 480):
        raise AssertionError("cli_predict: turned.jpg does not read turned "
                             "as cv2 reads it")
    kernels.reset_launches()
    turned_people = json.loads(cli_stdout(
        cli, ["predict", "--model-dir", str(directory), "--image",
              str(turned)]))
    if kernels.LAUNCHES != {decode.KERNEL: 1}:
        raise AssertionError(f"cli_predict: --image turned.jpg launches "
                             f"{kernels.LAUNCHES}")
    counted[decode.KERNEL] += 1
    if not turned_people or not all(
            np.isfinite(p["box"]).all() and np.isfinite(p["keypoints"]).all()
            for p in turned_people):
        raise AssertionError("cli_predict: bad people on turned.jpg")
    # The committed reversible gray JPEG 2000 file, read as cv2 reads it
    # (its digest), letterboxed to the model's size, one B1 launch.
    jp2 = FIXTURES / JP2_PREDICT
    want = json.loads((FIXTURES / "digests.json").read_text())[JP2_PREDICT]
    jp2_rgb = image_io.read_image(jp2)
    if [list(jp2_rgb.shape), sha256(jp2_rgb)] != [want["shape"],
                                                  want["rgb_sha256"]]:
        raise AssertionError(f"cli_predict: {JP2_PREDICT} does not read as "
                             "cv2 reads it")
    kernels.reset_launches()
    jp2_people = json.loads(cli_stdout(
        cli, ["predict", "--model-dir", str(directory), "--image",
              str(jp2)]))
    if kernels.LAUNCHES != {decode.KERNEL: 1}:
        raise AssertionError(f"cli_predict: --image {JP2_PREDICT} launches "
                             f"{kernels.LAUNCHES}")
    counted[decode.KERNEL] += 1
    if not isinstance(jp2_people, list) or not all(
            np.isfinite(p["box"]).all() and np.isfinite(p["keypoints"]).all()
            for p in jp2_people):
        raise AssertionError(f"cli_predict: bad people on {JP2_PREDICT}")
    # The 480x640 photo as cv2.imwrite writes it in AVIF, a crop of it in
    # lossless AVIF, one in 10-bit AVIF and one in limited-range BT.709
    # (a video tool's frame), each read to cv2's digest, one B1 launch
    # each.
    digests = json.loads((FIXTURES / "digests.json").read_text())
    avif_rows = {}
    for name in AVIF_PREDICT_FILES:
        avif_path = FIXTURES / name
        want = digests[name]
        avif_rgb = image_io.read_image(avif_path)
        if [list(avif_rgb.shape), sha256(avif_rgb)] != [want["shape"],
                                                        want["rgb_sha256"]] \
                or list(image_io.image_size(avif_path)) != want["shape"][:2]:
            raise AssertionError(f"cli_predict: {name} does not read as cv2 "
                                 "reads it")
        kernels.reset_launches()
        avif_people = json.loads(cli_stdout(
            cli, ["predict", "--model-dir", str(directory), "--image",
                  str(avif_path)]))
        if kernels.LAUNCHES != {decode.KERNEL: 1}:
            raise AssertionError(f"cli_predict: --image {name} launches "
                                 f"{kernels.LAUNCHES}")
        counted[decode.KERNEL] += 1
        if not avif_people or not all(
                np.isfinite(p["box"]).all()
                and np.isfinite(p["keypoints"]).all() for p in avif_people):
            raise AssertionError(f"cli_predict: bad people on {name}")
        avif_rows[name] = {"size": list(avif_rgb.shape[:2]),
                           "persons": len(avif_people)}
        if name in AVIF_CONTAINERS:
            data = avif_path.read_bytes()
            form = image_io.avif.read_image(data)
            turned = image_io.exif_orientation(form.exif)
            if (form.form, form.grid, turned) != AVIF_CONTAINERS[name]:
                raise AssertionError(f"cli_predict: {name} is {form.form}, "
                                     f"grid {form.grid}, orientation "
                                     f"{turned}")
            avif_rows[name].update(
                form=form.form, grid=form.grid, orientation=turned,
                host_decode_ms=median_ms(
                    lambda: image_io.decode_image(data, name), 20))
        if name in AVIF_GRAIN:
            data = avif_path.read_bytes()
            frame = image_io.avif.read_image(data).frame
            stats = image_io.avif.decode_planes_c(frame)[3]
            counter = AVIF_GRAIN[name]
            reached = int(stats[image_io.avif.STAT_NAMES.index(counter)])
            if not reached:
                raise AssertionError(f"cli_predict: {name} reaches no "
                                     f"{counter}")
            avif_rows[name].update({counter: reached, "host_decode_ms":
                                    median_ms(lambda: image_io.decode_image(
                                        data, name), 20)})
    emit({"phase": "cli_predict", "card": card, "image": [480, 640],
          "persons": len(people), "keypoint_centres_drawn": len(centres),
          "changed_pixels": int((drawn != image).any(-1).sum()),
          "command_s": command_s, "launches": counted,
          "also_written": written,
          "damaged_jpeg_persons": len(damaged_people),
          "turned_jpeg": {"size": list(turned_rgb.shape[:2]),
                          "persons": len(turned_people)},
          "jpeg2000": {"file": JP2_PREDICT,
                       "size": list(jp2_rgb.shape[:2]),
                       "letterbox": list(letterbox_size(
                           *jp2_rgb.shape[:2], IMAGE))[::-1],
                       "persons": len(jp2_people)},
          "avif": avif_rows})
    return counted[decode.KERNEL]


FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "images"
TIMING_FIXTURE = "photo_480x640_q95_420.jpg"
PLAIN_FIXTURE = "scene_00_420_q75.jpg"
WEBP_TIMING = ("webp_photo_480x640_q90.webp",
               "webp_scene_480x640_lossless.webp")
PLAIN_WEBP_PIXELS = 40_000  # the plain WebP coders run up to this size
JP2_PREDICT = "j2k_rev_gray_37x53.jp2"
AVIF_PREDICT = "avif_photo_480x640.avif"
AVIF_LOSSLESS = "avif_lossless_q100_128x160.avif"
# cv2.imwrite's files at IMWRITE_AVIF_DEPTH 10 and 12 (4:2:0; the 12-bit
# one profile 2), the smaller of them also through the plain decoder.
AVIF_10BIT = "avif_10bit_96x128.avif"
AVIF_DEPTHS = {AVIF_10BIT: 10, "avif_12bit_64x80.avif": 12}
# The files other encoders than cv2 write (the wheel's libavif encoder):
# (ssx, ssy, bit depth, matrix coefficients, full range) of each.
AVIF_BT709 = "avif_bt709_limited_96x128.avif"
AVIF_FORMS = {"avif_444_lossy_96x128.avif": (0, 0, 8, 6, 1),
              "avif_422_cdef_96x128.avif": (1, 0, 8, 6, 1),
              "avif_422_10bit_64x80.avif": (1, 0, 10, 6, 1),
              AVIF_BT709: (1, 1, 8, 1, 0)}
# The container forms past one still item: (form, grid (rows, columns,
# output width, output height) or None, Exif orientation) of each.
AVIF_CONTAINERS = {"avif_grid2x2_exif6_128x96.avif": ("grid", (2, 2, 96, 128),
                                                      6),
                   "avif_sequence3_48x64.avif": ("sequence", None, 1)}
# libaom's film grain and segmentation (the wheel's libavif encoder with
# `film-grain-test` 1 and 15, and `aq-mode=1`): the counter (csrc/av1.c's)
# that shows each reached.
AVIF_GRAIN_STILL = "avif_grain_96x128.avif"
AVIF_SEGMENTED = "avif_aq_sequence2_48x64.avif"
AVIF_GRAIN = {AVIF_GRAIN_STILL: "grain_frames",
              "avif_grain_csfl_10bit_444_64x80.avif": "grain_blocks",
              AVIF_SEGMENTED: "seg_feature_alt_q"}
AVIF_PREDICT_FILES = (AVIF_PREDICT, AVIF_LOSSLESS, AVIF_10BIT, AVIF_BT709,
                      *AVIF_CONTAINERS, AVIF_GRAIN_STILL, AVIF_SEGMENTED)
# The AVIF fixtures of the tools cv2's files reach at quality 100 and at
# speeds below 9, and libaom's film grain and segmentation, and the
# counter (csrc/av1.c's) that shows each reached.
AVIF_TOOLS = {AVIF_LOSSLESS: "lossless_blocks",
              "avif_photo_speed2_480x640.avif": "lr_wiener",
              "avif_palette_speed6_64x96.avif": "palette_y",
              "avif_intrabc_speed6_200x300.avif": "intrabc_blocks",
              **AVIF_GRAIN}


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR in dB of uint8 pixels against others (inf where equal)."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


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
    The JPEG writer on the 480x640 photo's pixels: C and plain equal to
    each other and to cv2.imencode's digest. The WebP fixtures go through
    `csrc/webp.c` and, up to 40,000 pixels, the plain decoders too; the
    WebP writer is held in `webp_checks`. Times on the host clock: the
    C decode of the 480x640 4:2:0 q95 fixture (ms and MB/s of file), the
    plain decode of it and of one 192x256 scene, the C encode of it (ms)
    and the plain one (s), and the C and plain letterbox resize of it.
    The JPEG 2000 codestreams are held in `jpeg2000_checks`, the JPEG
    2000 writer in `jpeg2000_write_checks`, the AVIF files in
    `avif_checks`, the AVIF writer in `avif_write_checks`."""
    t0 = time.perf_counter()
    image_codec.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    image_io.webp.library()
    webp_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    image_io.jpeg2000.library()
    jpeg2000_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    image_io.avif.library()
    avif_build_s = time.perf_counter() - t0
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
        if name.endswith(".webp") and \
                got.shape[0] * got.shape[1] <= PLAIN_WEBP_PIXELS:
            if not np.array_equal(image_io.decode_image_plain(data, name),
                                  got):
                raise AssertionError(f"image_codec: {name}: the C library "
                                     "and the plain WebP decoders differ")
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
    # The JPEG writer: the photo's pixels encoded as cv2.imencode(".jpg")
    # encodes them (its sha256, recorded by tests/make_image_fixtures.py),
    # by the C library and by the plain NumPy encoder.
    encoded = image_io.encode_jpeg(rgb)
    want_encode = digests[TIMING_FIXTURE]["imencode_sha256"]
    if hashlib.sha256(encoded).hexdigest() != want_encode:
        raise AssertionError("image_codec: the JPEG encode of the photo is "
                             "not cv2.imencode's")
    t0 = time.perf_counter()
    plain_encoded = jpeg.encode_pixels(rgb)
    plain_encode_s = time.perf_counter() - t0
    if plain_encoded != encoded:
        raise AssertionError("image_codec: the plain JPEG encoder and the C "
                             "library differ")
    encode_ms = median_ms(lambda: image_io.encode_jpeg(rgb), 20)
    t0 = time.perf_counter()
    jpeg.decode_pixels(small)
    plain_small_s = time.perf_counter() - t0
    emit({"phase": "image_codec", "card": card, "build_s": build_s,
          "webp_build_s": webp_build_s, "fixtures": checked,
          "equal": "C = cv2 digest (imread), decode and letterbox, every "
                   "fixture (arithmetic, lossless and smoothed ones, and "
                   "WebP, too); plain = C on the baseline JPEGs and the "
                   "WebPs up to 40,000 pixels; c3_truncated bytes refused "
                   "as imdecode refuses them",
          "timing_fixture": TIMING_FIXTURE, "timing_bytes": len(data),
          "c_decode_ms": c_ms,
          "c_decode_mb_per_s": len(data) / 1e6 / (c_ms / 1e3),
          "plain_decode_s": {TIMING_FIXTURE: plain_big_s,
                             PLAIN_FIXTURE: plain_small_s},
          "encode": {"bytes": len(encoded), "sha256": want_encode,
                     "equal": "C = plain = cv2.imencode's digest",
                     "c_encode_ms": encode_ms,
                     "plain_encode_s": plain_encode_s},
          "letterbox": [size[1], size[0]],
          "resize_c_ms": median_ms(
              lambda: image_io.resize_linear(rgb, size), 50),
          "resize_plain_ms": median_ms(
              lambda: image_io.resize_linear_plain(rgb, size), 5),
          "formats": image_format_checks(image_io, image_codec, rgb),
          "webp": webp_checks(image_io, digests, rgb),
          "tiff_hdr": tiff_hdr_checks(image_io, digests, data, rgb),
          "gif": gif_checks(image_io, digests, rgb),
          "jpeg2000": jpeg2000_checks(image_io, digests, jpeg2000_build_s),
          "jpeg2000_write": jpeg2000_write_checks(image_io, digests, rgb),
          "avif": avif_checks(image_io, digests, avif_build_s),
          "avif_write": avif_write_checks(image_io, rgb),
          "corrupt": corrupt_checks(image_io, image_codec, digests, data,
                                    rgb),
          "clock": "host perf_counter, median"})


def corrupt_checks(image_io, image_codec, digests: dict, photo: bytes,
                   photo_rgb: np.ndarray) -> dict:
    """Phase image_codec.corrupt: every `corrupt` recipe of the digests
    (byte changes in the scan data of a JPEG of each mode, in the LZW,
    deflate and JPEG strips of TIFFs, and, under the photo's entry as
    `gif_corrupt`, in the LZW data of the photo's quantised GIF), applied
    to its file and read by `decode_image` (cv2.imdecode), `read_image`
    (cv2.imread of a file) and the plain decoders where they read the
    mode (all but the c3_ JPEGs): each equal to the sha256 of cv2's
    decode recorded by tests/make_image_fixtures.py, or each raising a
    ValueError where cv2 returned no image; the stray-byte and sampling
    recipe sets (`recipe_set_checks`) and the photo's `exif_stray`
    recipe (`exif_stray_check`). Times on the host clock (median): the C
    decode of the 480x640 photo, clean and with its recipe's two changed
    scan bytes."""
    from multiposenet_tpu_torch import kernels
    from multiposenet_tpu_torch.tools import image_samples as samples

    files = {name: (FIXTURES / name).read_bytes() for name in digests}
    gif = samples.quantised_gif(photo_rgb)
    cases = [(name, files[name], r) for name in sorted(digests)
             for r in digests[name].get("corrupt", [])]
    cases += [("photo GIF", gif, r)
              for r in digests[TIMING_FIXTURE]["gif_corrupt"]]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    counts = {"read": 0, "refused": 0, "plain": 0}
    with tempfile.TemporaryDirectory(prefix="corrupt_",
                                     dir=kernels.BUILD_DIR) as directory:
        path = Path(directory) / "damaged"
        for name, data, recipe in cases:
            damaged = samples.corrupted(data, recipe["at"])
            path.write_bytes(damaged)
            readers = [image_io.decode_image,
                       lambda d: image_io.read_image(path)]
            if not name.startswith("c3_"):
                readers.append(image_io.decode_image_plain)
                counts["plain"] += 1
            for read in readers:
                try:
                    got = sha256(read(damaged))
                except ValueError:
                    got = None
                if got != recipe["rgb_sha256"]:
                    raise AssertionError(
                        f"image_codec.corrupt: {name} changed at "
                        f"{recipe['at']} reads to {got}, not cv2's "
                        f"{recipe['rgb_sha256']}")
            counts["read" if recipe["rgb_sha256"] else "refused"] += 1
        sets = recipe_set_checks(image_io, samples, digests, files, path)
        turned = exif_stray_check(image_io, samples, digests, photo, path)
    damaged = samples.corrupted(photo,
                                digests[TIMING_FIXTURE]["corrupt"][0]["at"])
    return {"recipes": len(cases), **counts, "sets": sets,
            "exif_stray": turned,
            "equal": "decode_image = read_image = plain (where it reads "
                     "the mode) = cv2's digest, or all refuse where cv2 "
                     "returns no image",
            "photo_c_decode_ms": median_ms(
                lambda: image_codec.decode_jpeg(photo), 50),
            "photo_corrupt_c_decode_ms": median_ms(
                lambda: image_codec.decode_jpeg(damaged), 50)}


def recipe_set_checks(image_io, samples, digests: dict, files: dict,
                      path: Path) -> dict:
    """The recipe sets of the digests, each replayed whole: bytes that are
    no marker segment before each header segment of the two Exif fixtures
    (`stray_sha256`), and every sampling factor of each component of the
    block-smoothed progressive fixtures (`sampling_sha256`). Each case is
    read by `decode_image`, `read_image` (written to `path`) and, on the
    baseline files, `decode_image_plain`, all to one outcome, which
    `image_size` of the file agrees with; the set's outcomes hash to the
    digest of cv2's decodes. Returns each set's cases, reads and host
    seconds."""
    out = {}
    for key, recipes in (("stray_sha256", samples.stray_recipes),
                         ("sampling_sha256", samples.sampling_recipes)):
        for name in sorted(n for n in digests if key in digests[n]):
            t0 = time.perf_counter()
            outcomes = []
            for recipe in recipes(files[name]):
                data = samples.corrupted(files[name], recipe)
                path.write_bytes(data)
                readers = [image_io.decode_image,
                           lambda d: image_io.read_image(path)]
                if not name.startswith("c3_"):
                    readers.append(image_io.decode_image_plain)
                got = set()
                for read in readers:
                    try:
                        got.add(samples.outcome(read(data)))
                    except ValueError:
                        got.add("none")
                try:
                    size = "x".join(map(str, image_io.image_size(path)))
                except ValueError:
                    size = "none"
                if len(got) != 1 or not next(iter(got)).startswith(
                        size if size == "none" else size + "x"):
                    raise AssertionError(
                        f"image_codec.corrupt: {name} {recipe}: readers "
                        f"{sorted(got)}, image_size {size}")
                outcomes.append(got.pop())
            if samples.outcomes_sha256(outcomes) != digests[name][key]:
                raise AssertionError(f"image_codec.corrupt: {name}'s "
                                     f"{key} set is not cv2's")
            out[name] = {"cases": len(outcomes),
                         "read": sum(o != "none" for o in outcomes),
                         "host_s": time.perf_counter() - t0}
    return out


def exif_stray_check(image_io, samples, digests: dict, photo: bytes,
                     path: Path) -> dict:
    """The photo's `exif_stray` recipe (stray bytes and an Exif APP1 of
    orientation 6 before its DQT): C, `read_image` and plain equal to
    cv2's digest, 640x480, and `image_size` of the file says so; the C
    decode's host time (median)."""
    recipe = digests[TIMING_FIXTURE]["exif_stray"]
    data = samples.corrupted(photo, recipe["at"])
    path.write_bytes(data)
    for read in (image_io.decode_image, lambda d: image_io.read_image(path),
                 image_io.decode_image_plain):
        rgb = read(data)
        if rgb.shape != (640, 480, 3) or sha256(rgb) != recipe["rgb_sha256"]:
            raise AssertionError("image_codec.corrupt: the photo's "
                                 "exif_stray recipe is not read turned as "
                                 "cv2 reads it")
    if image_io.image_size(path) != (640, 480):
        raise AssertionError("image_codec.corrupt: image_size of the "
                             "photo's exif_stray recipe")
    return {"shape": [640, 480, 3],
            "c_decode_ms": median_ms(lambda: image_io.decode_image(data),
                                     20)}


def webp_checks(image_io, digests: dict, photo: np.ndarray) -> dict:
    """The lossless WebP writer (`csrc/webp.c`) on every committed
    fixture's pixels: a RIFF…WEBPVP8L file that the port reads back
    exactly, C bytes = plain bytes up to 40,000 pixels, and at most 1.5
    times the size of cv2.imencode(".webp") of those pixels (recorded in
    the digests by tests/make_image_fixtures.py). Times on the host clock
    (median): the C decode of the 480x640 lossy (q 90) and lossless
    fixtures, the C encode of the photo's pixels with its bytes against
    cv2's, and the C decode of that file."""
    ratios = {}
    for name, want in sorted(digests.items()):
        rgb = image_io.read_image(FIXTURES / name)
        data = image_io.encode_image(rgb, ".webp")
        if data[:4] != b"RIFF" or data[8:16] != b"WEBPVP8L" or \
                not np.array_equal(image_io.decode_image(data), rgb):
            raise AssertionError(f"image_codec: the WebP of {name} does not "
                                 "read back as its pixels")
        if rgb.shape[0] * rgb.shape[1] <= PLAIN_WEBP_PIXELS and \
                data != image_io.encode_image_plain(rgb, ".webp"):
            raise AssertionError(f"image_codec: the C and plain WebP writers "
                                 f"differ on {name}")
        ratios[name] = len(data) / want["imencode_webp_bytes"]
        if ratios[name] > 1.5:
            raise AssertionError(f"image_codec: the WebP of {name} is "
                                 f"{ratios[name]:.3f} times cv2's size")
    times = {}
    for name in WEBP_TIMING:
        data = (FIXTURES / name).read_bytes()
        times[name] = {"bytes": len(data), "c_decode_ms": median_ms(
            lambda: image_io.decode_image(data), 20)}
    encoded = image_io.encode_image(photo, ".webp")
    cv2_bytes = digests[TIMING_FIXTURE]["imencode_webp_bytes"]
    times["photo_lossless_written"] = {
        "c_encode_ms": median_ms(
            lambda: image_io.encode_image(photo, ".webp"), 10),
        "bytes": len(encoded), "cv2_bytes": cv2_bytes,
        "ratio": len(encoded) / cv2_bytes,
        "c_decode_ms": median_ms(lambda: image_io.decode_image(encoded), 20)}
    worst = max(ratios, key=ratios.get)
    return {"fixtures_written": len(ratios),
            "ratio_max": [worst, ratios[worst]],
            "ratio_min": min(ratios.values()),
            "equal": "written file read back = pixels, every fixture; C = "
                     "plain bytes up to 40,000 pixels; size <= 1.5 x "
                     "cv2.imencode('.webp')",
            "times_480x640": times}


G4_PAGE = "tiff_g4_page_2292x1728.tif"


def tiff_hdr_checks(image_io, digests: dict, photo_jpeg: bytes,
                    photo: np.ndarray) -> dict:
    """The TIFF codecs (JPEG, CCITT, CMYK, YCbCr, CIELab) and Radiance
    HDR on the host C library and their plain versions: every committed
    `tiff_*` and `hdr_*` fixture decoded by the plain readers equal to the
    C readers (which the main loop holds to cv2's digests), and written
    as .hdr by the C and plain writers in the bytes of cv2.imencode
    (their sha256 in the digests); the 480x640 TIFFs `timing_tiffs`
    builds from the photo (its JPEG as a YCbCr 4:2:0 strip, CMYK, 2x2
    YCbCr) and the photo written as .hdr and read back, C = plain = cv2's
    digest. Times on the host clock (median): the C decode of each of
    those, of the 1728x2292 group 4 page and the C encode of the .hdr;
    the plain ones once."""
    from multiposenet_tpu_torch.tools import image_samples as samples

    checked = []
    for name, want in sorted(digests.items()):
        if not name.startswith(("tiff_", "hdr_")):
            continue
        data = (FIXTURES / name).read_bytes()
        got = image_io.decode_image(data, name)
        if sha256(got) != want["rgb_sha256"] or not np.array_equal(
                image_io.decode_image_plain(data, name), got):
            raise AssertionError(f"image_codec: {name}: C, plain and cv2's "
                                 "digest differ")
        for encode in (image_io.encode_image, image_io.encode_image_plain):
            if hashlib.sha256(encode(got, ".hdr")).hexdigest() \
                    != want["imencode_hdr_sha256"]:
                raise AssertionError(f"image_codec: the .hdr of {name} is "
                                     "not cv2.imencode's")
        checked.append(name)
    want = digests[TIMING_FIXTURE]
    files = samples.timing_tiffs(photo_jpeg, photo)
    t0 = time.perf_counter()
    files["hdr"] = image_io.encode_image_plain(photo, ".hdr")
    plain_encode_s = time.perf_counter() - t0
    if hashlib.sha256(files["hdr"]).hexdigest() \
            != want["imencode_hdr_sha256"] or files["hdr"] \
            != image_io.encode_image(photo, ".hdr"):
        raise AssertionError("image_codec: the .hdr of the photo is not "
                             "cv2.imencode's, C and plain")
    files["g4_page"] = (FIXTURES / G4_PAGE).read_bytes()
    times = {}
    for kind, data in files.items():
        got = image_io.decode_image(data)
        digest = (digests[G4_PAGE]["rgb_sha256"] if kind == "g4_page"
                  else want["timing_sha256"][kind])
        t0 = time.perf_counter()
        plain = image_io.decode_image_plain(data)
        plain_s = time.perf_counter() - t0
        if sha256(got) != digest or not np.array_equal(plain, got):
            raise AssertionError(f"image_codec: the {kind} file: C, plain "
                                 "and cv2's digest differ")
        times[kind] = {"shape": list(got.shape), "bytes": len(data),
                       "c_decode_ms": median_ms(
                           lambda: image_io.decode_image(data), 10),
                       "plain_decode_s": plain_s}
    times["hdr"]["c_encode_ms"] = median_ms(
        lambda: image_io.encode_image(photo, ".hdr"), 10)
    times["hdr"]["plain_encode_s"] = plain_encode_s
    return {"fixtures": len(checked),
            "equal": "every tiff_/hdr_ fixture C = plain = cv2's digest and "
                     "its .hdr C = plain = cv2.imencode's bytes; the timed "
                     "files C = plain = cv2's digest",
            "times": times}


def gif_checks(image_io, digests: dict, photo: np.ndarray) -> dict:
    """The GIF writer (`utils/gif.py`: cv2's 3-3-2 palette, Floyd-Steinberg
    dithering, LZW and framing) on the host C library and its plain
    version: every committed fixture's pixels, and the 480x640 photo's,
    written as .gif by both in the bytes of cv2.imencode (their sha256 in
    the digests). Times on the host clock: the C encode of the photo
    (median) and the plain one (once)."""
    for name, want in sorted(digests.items()):
        got = image_io.read_image(FIXTURES / name)
        for encode in (image_io.encode_image, image_io.encode_image_plain):
            if hashlib.sha256(encode(got, ".gif")).hexdigest() \
                    != want["imencode_gif_sha256"]:
                raise AssertionError(f"image_codec: the .gif of {name} is "
                                     "not cv2.imencode's")
    want = digests[TIMING_FIXTURE]["imencode_gif_sha256"]
    t0 = time.perf_counter()
    plain = image_io.encode_image_plain(photo, ".gif")
    plain_encode_s = time.perf_counter() - t0
    if hashlib.sha256(plain).hexdigest() != want \
            or image_io.encode_image(photo, ".gif") != plain:
        raise AssertionError("image_codec: the .gif of the photo is not "
                             "cv2.imencode's, C and plain")
    return {"fixtures": len(digests),
            "equal": "every fixture's and the photo's .gif C = plain = "
                     "cv2.imencode's bytes",
            "times": {"gif": {
                "shape": list(photo.shape), "bytes": len(plain),
                "c_encode_ms": median_ms(
                    lambda: image_io.encode_image(photo, ".gif"), 10),
                "plain_encode_s": plain_encode_s}}}


def jpeg2000_checks(image_io, digests: dict, build_s: float) -> dict:
    """JPEG 2000 (`utils/jpeg2000.py` over the host C library
    `csrc/jpeg2000.c`, built from the sources at the start of the phase
    in `build_s`, before any fixture is read): each committed
    codestream (`j2k_*`: a reversible gray JP2, an irreversible RGB
    codestream of three layers in RPCL order) decoded by the C library
    and by the plain Python tiers, both equal to cv2's digest; their
    `corrupt` recipes (packet bytes changed, cuts) are replayed in
    `corrupt_checks`. Times on the host clock: the C decode (median) and
    the plain one (once) of each."""
    times = {}
    for name in sorted(n for n in digests if n.startswith("j2k_")):
        data = (FIXTURES / name).read_bytes()
        got = image_io.decode_image(data, name)
        t0 = time.perf_counter()
        plain = image_io.decode_image_plain(data, name)
        plain_s = time.perf_counter() - t0
        want = digests[name]
        if [list(got.shape), sha256(got)] != [want["shape"],
                                               want["rgb_sha256"]] \
                or not np.array_equal(plain, got):
            raise AssertionError(f"image_codec: {name}: C and plain JPEG 2000"
                                 " decodes are not cv2's digest")
        times[name] = {"bytes": len(data), "shape": list(got.shape[:2]),
                       "c_decode_ms": median_ms(
                           lambda: image_io.decode_image(data, name), 20),
                       "plain_decode_s": plain_s}
    if len(times) != 2:
        raise AssertionError("image_codec: JPEG 2000 fixtures "
                             f"{sorted(times)}")
    return {"build_s": build_s, "fixtures": times,
            "equal": "C = plain = cv2's digest"}


def avif_checks(image_io, digests: dict, build_s: float) -> dict:
    """AVIF (`utils/avif.py` over the host C library `csrc/av1.c`, built
    from the sources at the start of the phase in `build_s`, before any
    fixture is read): every committed `.avif` file (cv2.imwrite's:
    noise, gray, an odd-sided crop, a TX_MODE_SELECT drawing, a BGRA crop
    with its alpha item, the 480x640 photo, a lossless crop at quality
    100, the photo at speed 2 with loop restoration, a palette drawing
    and an intra block copy drawing at speed 6, crops at 10 and 12 bits
    a sample; and the libavif encoder's 4:4:4 lossy, 4:2:2 with CDEF's
    chroma filter, 10-bit 4:2:2 and limited-range BT.709 crops; and the
    container forms: a grid with an Exif item of orientation 6, read
    turned, and a Pillow image sequence; and libaom's film grain and
    segmentation: `film-grain-test` 1 and 15 stills, an `aq-mode=1`
    sequence) decoded
    by the C library to cv2's digest, and by the plain decoder
    (`utils/av1.py`) too on the two smallest, on the smaller high-depth
    file, on the smallest of the other encoders' files and on the
    smallest film grain or segmentation file. Each tool
    file reaches its tool (`AVIF_TOOLS`, the C decoder's counters), each
    high-depth file holds its depth, each other encoder's file its form
    (`AVIF_FORMS`; the 4:2:2 CDEF file filters chroma). Times on the host
    clock: the C decode of each (median), the plain decode of the files
    it runs on (once), the time of the tiles and filters alone
    (`decode_planes_c`, rather than the container, the headers and
    libavif's YUV to RGB) of the photo and of the tool files, and, side
    by side, the C decode of the high-depth files, of the other
    encoders' forms (`forms`) and of the 8-bit photo again (`depths`:
    microseconds a pixel), so that a cost of the 16-bit samples to 8-bit
    files, or of a form, shows; for the film grain and segmentation files
    (`grain`) the C decode beside the photo's, the tiles and filters (the
    grain included), the grain pass alone (`avif.film_grain_c` on the
    planes before it) and its share of the C decode."""
    names = sorted(n for n in digests if n.endswith(".avif"))
    if len(names) != 21 or not set(AVIF_TOOLS) | set(AVIF_DEPTHS) | set(
            AVIF_FORMS) | set(AVIF_CONTAINERS) <= set(names):
        raise AssertionError(f"image_codec: AVIF fixtures {names}")
    files = {n: (FIXTURES / n).read_bytes() for n in names}

    def pixels(n):
        return digests[n]["shape"][0] * digests[n]["shape"][1]

    smallest = sorted(names, key=pixels)[:2]
    plain_on = smallest + [min(AVIF_DEPTHS, key=pixels),
                           min(AVIF_FORMS, key=pixels),
                           min(AVIF_GRAIN, key=pixels)]
    times = {}
    for name in names:
        data, want = files[name], digests[name]
        got = image_io.decode_image(data, name)
        if [list(got.shape), sha256(got)] != [want["shape"],
                                               want["rgb_sha256"]]:
            raise AssertionError(f"image_codec: {name}: the C AVIF decode is "
                                 "not cv2's digest")
        entry = {"bytes": len(data), "shape": list(got.shape[:2]),
                 "c_decode_ms": median_ms(
                     lambda: image_io.decode_image(data, name), 20)}
        if name in plain_on:
            t0 = time.perf_counter()
            plain = image_io.decode_image_plain(data, name)
            entry["plain_decode_s"] = time.perf_counter() - t0
            if not np.array_equal(plain, got):
                raise AssertionError(f"image_codec: {name}: the plain AVIF "
                                     "decoder and the C library differ")
        times[name] = entry
    frame = image_io.avif.read_image(files[AVIF_PREDICT]).frame
    tiles_ms = median_ms(lambda: image_io.avif.decode_planes_c(frame), 20)
    tools = {}
    for name, counter in AVIF_TOOLS.items():
        tool_frame = image_io.avif.read_image(files[name]).frame
        stats = image_io.avif.decode_planes_c(tool_frame)[3]
        reached = int(stats[image_io.avif.STAT_NAMES.index(counter)])
        if not reached:
            raise AssertionError(f"image_codec: {name} reaches no {counter}")
        tools[name] = {counter: reached, "tiles_and_filters_ms": median_ms(
            lambda: image_io.avif.decode_planes_c(tool_frame), 20)}
    depths = {}
    for name in list(AVIF_DEPTHS) + [AVIF_PREDICT]:
        data = files[name]
        depth = image_io.avif.read_image(data).frame.seq.bit_depth
        if depth != AVIF_DEPTHS.get(name, 8):
            raise AssertionError(f"image_codec: {name} is {depth}-bit")
        ms = median_ms(lambda: image_io.decode_image(data, name), 20)
        depths[name] = {"bit_depth": depth, "c_decode_ms": ms,
                        "c_decode_us_per_pixel": 1e3 * ms / pixels(name)}
    forms = {}
    for name, want in AVIF_FORMS.items():
        data = files[name]
        image = image_io.avif.read_image(data)
        s = image.frame.seq
        got = (s.ssx, s.ssy, s.bit_depth, image.matrix, image.full_range)
        if got != want or image.frame.header.lossless:
            raise AssertionError(f"image_codec: {name} is {got}")
        stats = image_io.avif.decode_planes_c(image.frame)[3]
        cdef_blocks = int(stats[image_io.avif.STAT_NAMES.index(
            "cdef_blocks")])
        if name == "avif_422_cdef_96x128.avif" and not (
                cdef_blocks and any(p for p, _ in image.frame.header.cdef_uv)):
            raise AssertionError(f"image_codec: {name} filters no chroma "
                                 "by CDEF")
        ms = median_ms(lambda: image_io.decode_image(data, name), 20)
        forms[name] = {"form": dict(zip(("ssx", "ssy", "bit_depth", "matrix",
                                         "full_range"), got)),
                       "cdef_blocks": cdef_blocks, "c_decode_ms": ms,
                       "c_decode_us_per_pixel": 1e3 * ms / pixels(name)}
    forms[AVIF_PREDICT] = depths[AVIF_PREDICT]
    grain = {AVIF_PREDICT: depths[AVIF_PREDICT]}
    for name in AVIF_GRAIN:
        frame = image_io.avif.read_image(files[name]).frame
        ms = times[name]["c_decode_ms"]
        row = {"c_decode_ms": ms,
               "c_decode_us_per_pixel": 1e3 * ms / pixels(name),
               "tiles_and_filters_ms": tools[name]["tiles_and_filters_ms"],
               "grain_ms": 0.0, "grain_share_of_c_decode": 0.0}
        if frame.header.grain is not None:
            y, u, v, _ = image_io.avif.decode_planes_c(frame, grain=False)
            u = np.zeros_like(y) if u is None else u

            def add_grain():
                image_io.avif.film_grain_c(frame, y.copy(), u.copy(),
                                           (v if v is not None else u).copy())

            row["grain_ms"] = median_ms(add_grain, 20)
            row["grain_share_of_c_decode"] = row["grain_ms"] / ms
        grain[name] = row
    return {"build_s": build_s, "fixtures": times,
            "photo_tiles_and_filters_ms": tiles_ms, "tools": tools,
            "depths": depths, "forms": forms, "grain": grain,
            "plain_on": plain_on,
            "equal": "C = cv2's digest on every fixture; plain = C on the "
                     "two smallest, the smaller high-depth file, the "
                     "smallest of the other encoders' files and the "
                     "smallest film grain or segmentation file"}


# The plain JPEG 2000 writer runs on the fixtures up to this many pixels.
PLAIN_JP2_PIXELS = 2_100


def jpeg2000_write_checks(image_io, digests: dict, photo: np.ndarray) -> dict:
    """The JPEG 2000 writer (`utils/jpeg2000_write.py`: OpenJPEG 2.5.3 at
    cv2's defaults, its tiers and rate allocation in the host C library
    `csrc/jpeg2000_write.c`): every committed fixture's pixels with both
    sides at least 32, and the 480x640 photo's, written as .jp2 by the C
    library in the bytes of cv2.imencode (their sha256 in the digests),
    and by the plain Python writer too on the fixtures up to 2,100
    pixels; the fixtures with a side under 32, for which cv2.imencode
    writes nothing, go through `write_image`, which returns False with
    only the JP2 boxes in the file, as cv2.imwrite leaves it. Times on
    the host clock: the C encode of the photo (median) and one plain
    encode of the smallest fixture."""
    writer = image_io.jpeg2000_write
    plain_checked, skipped = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for name, want in sorted(digests.items()):
            got = image_io.read_image(FIXTURES / name)
            digest = want["imencode_jp2_sha256"]
            if min(got.shape[:2]) < writer.MIN_SIDE:
                path = Path(tmp) / "small.jp2"
                if digest is not None or image_io.write_image(path, got) \
                        or path.read_bytes() != writer.jp2_header(
                            *got.shape[:2]):
                    raise AssertionError(f"image_codec: {name} is written "
                                         "as .jp2 (cv2 writes only the "
                                         "JP2 boxes)")
                skipped.append(name)
                continue
            encoders = [image_io.encode_image]
            if got.shape[0] * got.shape[1] <= PLAIN_JP2_PIXELS:
                encoders.append(image_io.encode_image_plain)
                plain_checked.append(name)
            for encode in encoders:
                if hashlib.sha256(encode(got, ".jp2")).hexdigest() != digest:
                    raise AssertionError(f"image_codec: the .jp2 of {name} "
                                         "is not cv2.imencode's")
    want = digests[TIMING_FIXTURE]["imencode_jp2_sha256"]
    data = image_io.encode_image(photo, ".jp2")
    if hashlib.sha256(data).hexdigest() != want:
        raise AssertionError("image_codec: the .jp2 of the photo is not "
                             "cv2.imencode's")
    small = min(plain_checked, key=lambda n: digests[n]["shape"][0]
                * digests[n]["shape"][1])
    small_rgb = image_io.read_image(FIXTURES / small)
    t0 = time.perf_counter()
    image_io.encode_image_plain(small_rgb, ".jp2")
    plain_encode_s = time.perf_counter() - t0
    return {"fixtures": len(digests) - len(skipped),
            "plain_fixtures": plain_checked, "boxes_only": skipped,
            "equal": "every fixture's with both sides >= 32 and the "
                     "photo's .jp2 C = cv2.imencode's bytes, plain = C = "
                     "cv2's on the fixtures up to 2,100 pixels; the "
                     "others write only the JP2 boxes and return False",
            "times": {"photo": {
                "shape": list(photo.shape), "bytes": len(data),
                "c_encode_ms": median_ms(
                    lambda: image_io.encode_image(photo, ".jp2"), 5)},
                small: {"shape": list(small_rgb.shape),
                        "plain_encode_s": plain_encode_s}}}


AVIF_WRITE_PLAIN = (48, 80)  # the crop the plain AVIF writer encodes


def avif_write_checks(image_io, photo: np.ndarray) -> dict:
    """The AVIF writer (`utils/avif_write.py`: libavif 1.4.2 over libaom
    3.14.1 at cv2's defaults, the encoder in the host C library
    `csrc/av1_encode.c`): its build (cc, timed), then the 480x640
    photo's pixels (the decoded JPEG fixture) written as .avif, byte for
    byte the committed `avif_photo_480x640.avif`, which cv2.imencode
    wrote of them, and read back by the port's decoder; a 48x80 crop of
    them written by the C library and by the plain Python encoder, the
    same bytes. Times on the host clock: the C encode of the photo
    (median) and the plain encode of the crop."""
    writer = image_io.avif_write
    t0 = time.perf_counter()
    writer.library()
    build_s = time.perf_counter() - t0
    want = (FIXTURES / AVIF_PREDICT).read_bytes()
    data = image_io.encode_image(photo, ".avif")
    if data != want:
        raise AssertionError("image_codec: the .avif of the photo is not "
                             f"cv2.imencode's {AVIF_PREDICT}")
    if not np.array_equal(image_io.decode_image(data),
                          image_io.read_image(FIXTURES / AVIF_PREDICT)):
        raise AssertionError("image_codec: the .avif of the photo does not "
                             "read back")
    h, w = AVIF_WRITE_PLAIN
    crop = np.ascontiguousarray(photo[100:100 + h, 200:200 + w])
    t0 = time.perf_counter()
    plain = image_io.encode_image_plain(crop, ".avif")
    plain_s = time.perf_counter() - t0
    if plain != image_io.encode_image(crop, ".avif"):
        raise AssertionError("image_codec: the C and plain AVIF writers "
                             "differ")
    return {"build_s": build_s, "photo_bytes": len(data),
            "equal": f"C = {AVIF_PREDICT} (cv2.imencode's bytes of the "
                     "photo's pixels); plain = C on a 48x80 crop",
            "times": {"photo": {"shape": list(photo.shape),
                                "c_encode_ms": median_ms(
                                    lambda: image_io.encode_image(
                                        photo, ".avif"), 5)},
                      "crop": {"shape": list(crop.shape),
                               "plain_encode_s": plain_s}}}


def image_format_checks(image_io, image_codec, rgb: np.ndarray) -> dict:
    """The simple formats and WebP on the host C libraries, from bytes the
    port writes itself (the card's machine has no cv2): the C and plain
    writers of every cv2 suffix give equal bytes, read back (C and plain)
    as the pixels; the C and plain readers give equal pixels on crafted
    BMP RLE4/RLE8, TIFF LZW (planar, predictor, 16-bit, palette, old
    style) and PackBits, and GIF (interlace, transparency) files, and the
    C and plain coders equal outputs on random streams. Times on the host
    clock (median): the C decode and encode of the 480x640 photo in BMP,
    PPM and TIFF-LZW, and the C decode of a 256-colour GIF of it (LZW
    compressed as an encoder writes it)."""
    from multiposenet_tpu_torch.tools import image_samples as samples
    from multiposenet_tpu_torch.utils import gif, tiff

    written = {}
    for suffix in (".bmp", ".ppm", ".pam", ".pfm", ".sr", ".tif", ".webp"):
        data = image_io.encode_image(rgb, suffix)
        if data != image_io.encode_image_plain(rgb, suffix):
            raise AssertionError(f"image_codec: the C and plain {suffix} "
                                 "writers differ")
        for read in (image_io.decode_image, image_io.decode_image_plain):
            if not np.array_equal(read(data), rgb):
                raise AssertionError(f"image_codec: {suffix} does not read "
                                     "back as the pixels")
        written[suffix] = len(data)
    rng = np.random.default_rng(0)
    small = rgb[:37, :45]
    r16 = rng.integers(0, 65536, (9, 11, 3)).astype(np.uint16)
    pal = rng.integers(0, 256, (256, 4), dtype=np.uint8)
    idx = rng.integers(0, 16, (17, 6))
    crafted = {
        "bmp_rle8": samples.bmp_bytes(6, 3, 8, 1, bytes(
            [2, 5, 0, 2, 2, 1, 1, 9, 0, 0, 0, 3, 1, 2, 3, 0, 0, 1]), pal),
        "bmp_rle4": samples.bmp_bytes(5, 2, 4, 2, bytes(
            [5, 0x12, 0, 0, 0, 3, 0x34, 0x50, 0, 0, 0, 1]), pal[:16]),
        "tiff_lzw_planar_predictor": samples.tiff_bytes(
            small, 2, compression=5, predictor=2, planar=2,
            rows_per_strip=8),
        "tiff_lzw_16bit_predictor": samples.tiff_bytes(
            r16, 2, bps=16, compression=5, predictor=2),
        "tiff_lzw_palette_16bit_map": samples.tiff_bytes(
            small[..., 0], 3, compression=5,
            colormap=rng.integers(0, 65536, (3, 256))),
        "tiff_packbits_tiles": samples.tiff_bytes(
            small, 2, compression=32773, tile=(16, 32)),
        "gif_compressed_table_full": samples.gif_bytes(
            (45, 37), [dict(idx=small[..., 0] >> 4, lzw=samples.gif_lzw(
                (small[..., 0] >> 4).reshape(-1), 4))], pal[:16, :3]),
        "gif_interlaced_transparent": samples.gif_bytes(
            (8, 19), [dict(idx=idx, interlace=True, transp=3, left=1,
                           top=2)], pal[:16, :3], bg=5),
    }
    for name, data in crafted.items():
        if not np.array_equal(image_io.decode_image(data),
                              image_io.decode_image_plain(data)):
            raise AssertionError(f"image_codec: C and plain differ on "
                                 f"{name}")
    for _ in range(100):
        data = rng.integers(0, 256, int(rng.integers(1, 300)),
                            dtype=np.uint8).tobytes()
        want = int(rng.integers(1, 1500))
        pairs = ((image_codec.tiff_lzw, tiff.lzw_decode_plain, ()),
                 (image_codec.packbits, tiff.packbits_plain, ()),
                 (image_codec.gif_lzw, gif.lzw_decode_plain, (4,)))
        for c_fn, plain_fn, extra in pairs:
            got = []
            for fn in (c_fn, plain_fn):
                try:
                    got.append(fn(data, *extra, want))
                except ValueError:
                    got.append(None)
            if got[0] != got[1]:
                raise AssertionError(f"image_codec: {c_fn.__name__} and its "
                                     "plain version differ")
    q = ((rgb[..., 0] >> 5) << 5) | ((rgb[..., 1] >> 5) << 2) | (
        rgb[..., 2] >> 6)
    levels = np.arange(256)
    gif_pal = np.stack([(levels >> 5) * 36, ((levels >> 2) & 7) * 36,
                        (levels & 3) * 85], -1).astype(np.uint8)
    gif_data = samples.quantised_gif(rgb)
    if not np.array_equal(image_io.decode_image(gif_data), gif_pal[q]):
        raise AssertionError("image_codec: the GIF of the photo does not "
                             "read back")
    times = {}
    for suffix, key in ((".bmp", "bmp"), (".ppm", "ppm"),
                        (".tif", "tiff_lzw")):
        data = image_io.encode_image(rgb, suffix)
        times[key] = {
            "c_decode_ms": median_ms(lambda: image_io.decode_image(data), 20),
            "c_encode_ms": median_ms(
                lambda: image_io.encode_image(rgb, suffix), 20),
            "bytes": len(data)}
    times["gif"] = {"c_decode_ms": median_ms(
        lambda: image_io.decode_image(gif_data), 20),
        "bytes": len(gif_data)}
    return {"written_bytes": written, "crafted": sorted(crafted),
            "equal": "writers C = plain, read back = pixels; crafted files "
                     "C = plain; coders C = plain on 100 random streams",
            "times_480x640": times}


def phase_eval_jpeg(cli, image_io, visualize, jpeg, decode, kernels,
                    directory: Path, card: str) -> dict:
    """The command line on the committed JPEG fixtures with the model
    `phase_eval` exported: `eval --coco-json annotations.json --image-dir
    tests/fixtures/images --batched --batch-size 8` (10 scenes: exactly
    2 B1 launches and no other kernel; finite stats in [-1, 1]), `predict
    --image` the 480x640 JPEG `--output drawn.png` (1 B1 launch, people
    printed, the PNG read back equals the drawing of the printed people
    on the decoded JPEG), `--output drawn.jpg` (1 B1 launch, the file
    equals the plain encoder's JPEG of that drawing), `--output
    drawn.gif` (1 B1 launch, the file equals the plain GIF encoder's bytes
    of that drawing and reads back as its dithered palette colours),
    `--output drawn.jp2` (1 B1 launch, the file equals the plain JPEG 2000
    writer's bytes of that drawing and reads back) and `--output
    drawn.avif` (1 B1 launch, the file equals an in-process encode of
    that drawing and the port's decoder reads it back at over 20 dB
    PSNR of it). The batched eval runs over every visible card: its B1 launches
    are the batches times the cards. Returns B1's launches by command."""
    n_images = len(json.loads(
        (FIXTURES / "annotations.json").read_text())["images"])
    argv = ["eval", "--model-dir", str(directory), "--coco-json",
            str(FIXTURES / "annotations.json"), "--image-dir",
            str(FIXTURES), "--batched", "--batch-size", "8"]
    n_b1 = -(-n_images // 8) * torch.cuda.device_count()
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

    jpg_out = directory / "drawn.jpg"
    torch.cuda.synchronize()
    kernels.reset_launches()
    text = cli_stdout(cli, ["predict", "--model-dir", str(directory),
                            "--image", str(image_path), "--output",
                            str(jpg_out)])
    if kernels.LAUNCHES != {decode.KERNEL: 1}:
        raise AssertionError(f"eval_jpeg: predict --output drawn.jpg "
                             f"launches {kernels.LAUNCHES}")
    jpg_people = [argparse.Namespace(box=np.asarray(p["box"]),
                                     score=p["score"],
                                     keypoints=np.asarray(p["keypoints"]))
                  for p in json.loads(text)]
    if jpg_out.read_bytes() != jpeg.encode_pixels(
            visualize.draw_predictions(image, jpg_people)):
        raise AssertionError("eval_jpeg: drawn.jpg is not the JPEG of the "
                             "drawing of the printed people")
    launches["cli_predict_jpeg_output"] = 1

    gif_out = directory / "drawn.gif"
    torch.cuda.synchronize()
    kernels.reset_launches()
    text = cli_stdout(cli, ["predict", "--model-dir", str(directory),
                            "--image", str(image_path), "--output",
                            str(gif_out)])
    if kernels.LAUNCHES != {decode.KERNEL: 1}:
        raise AssertionError(f"eval_jpeg: predict --output drawn.gif "
                             f"launches {kernels.LAUNCHES}")
    gif_drawing = visualize.draw_predictions(image, [
        argparse.Namespace(box=np.asarray(p["box"]), score=p["score"],
                           keypoints=np.asarray(p["keypoints"]))
        for p in json.loads(text)])
    gif_bytes = gif_out.read_bytes()
    if gif_bytes != image_io.encode_image_plain(gif_drawing, ".gif"):
        raise AssertionError("eval_jpeg: drawn.gif is not the GIF of the "
                             "drawing of the printed people")
    if not np.array_equal(image_io.read_image(gif_out), image_io.gif.PALETTE[
            image_io.gif.dither_plain(gif_drawing)]):
        raise AssertionError("eval_jpeg: drawn.gif does not read back as "
                             "the dithered drawing")
    launches["cli_predict_gif_output"] = 1

    jp2_out = directory / "drawn.jp2"
    torch.cuda.synchronize()
    kernels.reset_launches()
    text = cli_stdout(cli, ["predict", "--model-dir", str(directory),
                            "--image", str(image_path), "--output",
                            str(jp2_out)])
    if kernels.LAUNCHES != {decode.KERNEL: 1}:
        raise AssertionError(f"eval_jpeg: predict --output drawn.jp2 "
                             f"launches {kernels.LAUNCHES}")
    jp2_drawing = visualize.draw_predictions(image, [
        argparse.Namespace(box=np.asarray(p["box"]), score=p["score"],
                           keypoints=np.asarray(p["keypoints"]))
        for p in json.loads(text)])
    jp2_bytes = jp2_out.read_bytes()
    t0 = time.perf_counter()
    jp2_plain = image_io.encode_image_plain(jp2_drawing, ".jp2")
    jp2_plain_s = time.perf_counter() - t0
    if jp2_bytes != jp2_plain:
        raise AssertionError("eval_jpeg: drawn.jp2 is not the plain "
                             "writer's JPEG 2000 of the drawing of the "
                             "printed people")
    if image_io.read_image(jp2_out).shape != jp2_drawing.shape:
        raise AssertionError("eval_jpeg: drawn.jp2 does not read back")
    launches["cli_predict_jp2_output"] = 1

    avif_out = directory / "drawn.avif"
    torch.cuda.synchronize()
    kernels.reset_launches()
    text = cli_stdout(cli, ["predict", "--model-dir", str(directory),
                            "--image", str(image_path), "--output",
                            str(avif_out)])
    if kernels.LAUNCHES != {decode.KERNEL: 1}:
        raise AssertionError(f"eval_jpeg: predict --output drawn.avif "
                             f"launches {kernels.LAUNCHES}")
    avif_drawing = visualize.draw_predictions(image, [
        argparse.Namespace(box=np.asarray(p["box"]), score=p["score"],
                           keypoints=np.asarray(p["keypoints"]))
        for p in json.loads(text)])
    avif_bytes = avif_out.read_bytes()
    if avif_bytes != image_io.encode_image(avif_drawing, ".avif"):
        raise AssertionError("eval_jpeg: drawn.avif is not the AVIF of the "
                             "drawing of the printed people")
    avif_back = image_io.read_image(avif_out)
    if avif_back.shape != avif_drawing.shape:
        raise AssertionError("eval_jpeg: drawn.avif does not read back")
    avif_psnr = psnr(avif_back, avif_drawing)
    if not avif_psnr > 20.0:
        raise AssertionError(f"eval_jpeg: drawn.avif reads back at "
                             f"{avif_psnr:.1f} dB of the drawing")
    launches["cli_predict_avif_output"] = 1
    emit({"phase": "eval_jpeg", "card": card, "argv": argv,
          "images": n_images, "stats": stats, "launches": counted,
          "eval_command_s": eval_s,
          "img_per_s_command": n_images / eval_s,
          "predict_image": TIMING_FIXTURE, "persons": len(people),
          "predict_command_s": predict_s, "predict_launches":
              predict_counted, "output_jpg_bytes": jpg_out.stat().st_size,
          "output_gif_bytes": len(gif_bytes),
          "output_jp2_bytes": len(jp2_bytes),
          "output_jp2_plain_encode_s": jp2_plain_s,
          "output_avif_bytes": len(avif_bytes),
          "output_avif_psnr_db": avif_psnr})
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


def ulp_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How many float32 elements of `got` differ from `want`, and by how
    many ulps at most (signed zeros one apart)."""
    def ordered(t):
        i = t.detach().float().cpu().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF) - 1, i)
    d = (ordered(got) - ordered(want)).abs()
    return {"elements": d.numel(), "differ": int((d != 0).sum()),
            "max_ulps": int(d.max()) if d.numel() else 0}


def update_card_vs_cpu(cfg, shapes, steps_lib, device, seed: int) -> dict:
    """The optimizer's update (`steps.Optimizer`), the EMA's
    (`xla_arith.ema_step`) and the PRN's Adam (`prn_train.adam_update`)
    on the card (the kernels of csrc/train_update.cu) and on the CPU (the
    plain versions) from identical float32 inputs (seeded parameters,
    gradients, moments and EMA of the given parameter shapes, and of
    `cfg`'s PRN): for each result, the elements that differ and the
    largest gap in ulps. Two optimizer cases: the gradients' norm below
    the clip at the end of the warmup, and above it late in the cosine.
    Raises if any element or the global norm differs: both sides round
    every operation once, as `xla_arith` says, and the norm's float64
    sums, in two orders, round to one float32."""
    from multiposenet_tpu_torch.train import prn_train, xla_arith

    gen = torch.Generator().manual_seed(seed)

    def draw(scale, like=shapes):
        return [scale * torch.randn(s, generator=gen) for s in like]

    def merge(rows):
        return {"elements": sum(r["elements"] for r in rows),
                "differ": sum(r["differ"] for r in rows),
                "max_ulps": max(r["max_ulps"] for r in rows)}

    cpu = torch.device("cpu")
    opt = steps_lib.Optimizer(cfg)
    t = cfg.train
    out = {"params": sum(int(np.prod(s)) for s in shapes)}
    for case, norm, count in (("below_clip", 0.3, t.warmup_steps),
                              ("above_clip", 30.0, t.num_steps - 2)):
        params, grads = draw(0.05), draw(1.0)
        total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
        grads = [g * (norm * t.gradient_clip_norm / total) for g in grads]
        mu, nu = draw(1e-3), [x.abs() for x in draw(1e-6)]
        results = []
        for where in (device, cpu):
            p, m, v = ([x.clone().to(where) for x in xs]
                       for xs in (params, mu, nu))
            n = opt.update(p, [g.to(where) for g in grads], m, v, count)
            results.append((p, m, v, n))
        (cp, cm, cv, cn), (hp, hm, hv, hn) = results
        out[f"optimizer_{case}"] = {
            "count": count, "grad_norm_card": float(cn),
            "grad_norm_cpu": float(hn),
            "grad_norm": ulp_gap(cn, hn),
            **{k: merge([ulp_gap(a, b) for a, b in zip(x, y)])
               for k, x, y in (("params", cp, hp), ("mu", cm, hm),
                               ("nu", cv, hv))}}
    ema, params = draw(0.05), draw(0.05)
    decay = steps_lib.ema_decay(cfg, 40)
    results = []
    for where in (device, cpu):
        e = [x.clone().to(where) for x in ema]
        xla_arith.ema_step(e, [x.to(where) for x in params], decay,
                           steps_lib.ema_weight(decay))
        results.append(e)
    out["ema"] = merge([ulp_gap(a, b) for a, b in zip(*results)])
    states = [prn_train.create_prn_state(cfg, where)
              for where in (device, cpu)]
    names = list(states[1].params)
    like = [tuple(states[1].params[k].shape) for k in names]
    mu, nu, grads = draw(1e-3, like), [x.abs() for x in draw(1e-6, like)], \
        draw(1e-2, like)
    with torch.no_grad():
        for state in states:
            state.step = 5
            for k, m, v in zip(names, mu, nu):
                state.mu[k].copy_(m)
                state.nu[k].copy_(v)
    for state in states:
        where = state.params[names[0]].device
        prn_train.adam_update(state, {k: g.to(where)
                                      for k, g in zip(names, grads)})
    out["prn_adam"] = merge(
        [ulp_gap(states[0].params[k], states[1].params[k]) for k in names]
        + [ulp_gap(states[0].mu[k], states[1].mu[k]) for k in names]
        + [ulp_gap(states[0].nu[k], states[1].nu[k]) for k in names])
    rows = {"ema": out["ema"], "prn_adam": out["prn_adam"]}
    for case in ("optimizer_below_clip", "optimizer_above_clip"):
        rows.update({f"{case}.{k}": out[case][k]
                     for k in ("params", "mu", "nu", "grad_norm")})
    parted = {k: r for k, r in rows.items() if r["differ"]}
    if parted:
        raise AssertionError(f"update card against CPU: {parted}")
    return out


def seeded_state(shapes, gen, device, scale: float) -> list[torch.Tensor]:
    """Seeded float32 tensors of `shapes` on `device`, one element in 50
    at a scale float32 holds only as a subnormal (which the update
    flushes)."""
    out = []
    for shape in shapes:
        x = scale * torch.randn(shape, generator=gen, device=device)
        tiny = torch.rand(shape, generator=gen, device=device) < 0.02
        out.append(torch.where(tiny, 1e-39 * torch.randn(
            shape, generator=gen, device=device), x))
    return out


def update_gap(got: list[torch.Tensor], want: list[torch.Tensor]) -> dict:
    """ulp_gap over tensor lists, and the largest absolute difference."""
    rows = [ulp_gap(a, b) for a, b in zip(got, want)]
    return {"elements": sum(r["elements"] for r in rows),
            "differ": sum(r["differ"] for r in rows),
            "max_ulps": max(r["max_ulps"] for r in rows),
            "max_abs_err": max(float((a - b).abs().max())
                               for a, b in zip(got, want))}


def phase_train_update_kernel(Config, MultiPoseNet, prn_train, xla_arith,
                              device) -> list[dict]:
    """`adam_update` and `ema_update` (csrc/train_update.cu) at the main
    path's shapes against their plain versions (`xla_arith`'s, run on the
    card) on the same seeded inputs: Config()'s parameters with the
    optimizer's clip and adamw decay, the norm above the clip, at count
    3; the EMA at step 40; Config()'s PRN with plain adam. Held bit for
    bit (tolerance 0: both round each operation once, as XLA's compiled
    step does). Timed on CUDA events: the entry point (the gradients laid
    end to end, the global norm where it clips, the launch), the plain
    version, and torch's fused Adam / foreach lerp on the same tensors as
    the library call (they compute the same update without the clip,
    rounded their own way)."""
    gen = torch.Generator(device=device).manual_seed(21)
    cfg = Config()
    t = cfg.train
    model_shapes = [tuple(p.shape) for p in MultiPoseNet(cfg).parameters()]
    prn_shapes = [tuple(p.shape) for p in
                  prn_train.make_prn(cfg, torch.float32).parameters()]
    adamw = xla_arith.Adam(count=3, lr=t.learning_rate,
                           clip=t.gradient_clip_norm,
                           weight_decay=t.weight_decay, nu_fuses_moment=True)
    adam = xla_arith.Adam(count=3, lr=prn_train.ADAM_LR)
    out, rows = {}, []
    for name, shapes, hp in (("model", model_shapes, adamw),
                             ("prn", prn_shapes, adam)):
        params, grads, mu = (seeded_state(shapes, gen, device, s)
                             for s in (0.05, 1e-2, 1e-3))
        nu = [x.abs() for x in seeded_state(shapes, gen, device, 1e-6)]
        runs = []
        for fn in (xla_arith.adam_step, xla_arith.adam_step_plain):
            state = [[x.clone() for x in xs] for xs in (params, mu, nu)]
            norm = fn(state[0], grads, state[1], state[2], hp)
            runs.append((state, norm))
        torch.cuda.synchronize()
        gaps = {k: update_gap(a, b) for k, a, b in zip(
            ("params", "mu", "nu"), runs[0][0], runs[1][0])}
        if hp.clip is not None:
            gaps["grad_norm"] = update_gap([runs[0][1]], [runs[1][1]])
        if any(g["differ"] for g in gaps.values()):
            raise AssertionError(f"adam_update ({name}) differs from its "
                                 f"plain version: {gaps}")
        state = runs[0][0]
        n = sum(x.numel() for x in params)
        ms = cuda_ms(lambda: xla_arith.adam_step(
            state[0], grads, state[1], state[2], hp), reps=10, rounds=5)
        plain_ms = cuda_ms(lambda: xla_arith.adam_step_plain(
            state[0], grads, state[1], state[2], hp), reps=2, rounds=3)
        library = torch._fused_adamw_ if hp.weight_decay is not None \
            else torch._fused_adam_
        counts = [torch.tensor(3.0, device=device) for _ in params]
        try:
            library_ms = cuda_ms(lambda: library(
                state[0], grads, state[1], state[2], [], counts, lr=hp.lr,
                beta1=xla_arith.ADAM_B1, beta2=xla_arith.ADAM_B2,
                weight_decay=hp.weight_decay or 0.0, eps=xla_arith.ADAM_EPS,
                amsgrad=False, maximize=False), reps=10, rounds=5)
        except (RuntimeError, TypeError) as exc:  # another torch's signature
            library_ms = None
            out[f"{name}_library_error"] = str(exc)[:200]
        # Each of g, p, mu and nu read once, p, mu and nu written once;
        # about 20 float32 operations an element (the norm's square and
        # add, the clip, both moments, the direction, the decay, the step).
        bytes_moved, ops = 28 * n, 20 * n
        out[name] = {**out.get(name, {}), "tensors": len(shapes),
                     "elements": n,
                     "clip": hp.clip, "weight_decay": hp.weight_decay,
                     "nu_fuses_moment": hp.nu_fuses_moment, **gaps,
                     "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "bytes": bytes_moved, "ops": ops}
        del params, grads, mu, nu, runs, state
    ema, params = (seeded_state(model_shapes, gen, device, 0.05)
                   for _ in range(2))
    # The EMA's decay and weight at step 40: (1 + 41) / (10 + 41).
    decay = float(np.float32(42) / np.float32(51))
    weight = float(np.float32(1) - np.float32(decay))
    runs = []
    for fn in (xla_arith.ema_step, xla_arith.ema_step_plain):
        e = [x.clone() for x in ema]
        fn(e, params, decay, weight)
        runs.append(e)
    torch.cuda.synchronize()
    gap = update_gap(*runs)
    if gap["differ"]:
        raise AssertionError(f"ema_update differs from its plain version: "
                             f"{gap}")
    e = runs[0]
    n = sum(x.numel() for x in params)
    out["ema"] = {"tensors": len(model_shapes), "elements": n,
                  "decay": decay, **gap,
                  "ms": cuda_ms(lambda: xla_arith.ema_step(
                      e, params, decay, weight), reps=10, rounds=5),
                  "plain_ms": cuda_ms(lambda: xla_arith.ema_step_plain(
                      e, params, decay, weight), reps=3, rounds=3),
                  "library_ms": cuda_ms(lambda: torch._foreach_lerp_(
                      e, params, weight), reps=10, rounds=5),
                  "bytes": 12 * n, "ops": 3 * n}
    emit({"phase": "train_update_kernel", "tolerance": "0 ulps",
          "library": "torch._fused_adamw_ (model), torch._fused_adam_ "
                     "(PRN), torch._foreach_lerp_ (EMA): no clip",
          "clock": "CUDA events", **out})
    for name, key in ((xla_arith.ADAM_KERNEL, "prn"),
                      (xla_arith.EMA_KERNEL, "ema")):
        r = out[key]
        bytes_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = r["ops"] / F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "design": "one pass, a block per 1024 elements of one tensor "
                      "(a table of the tensors), fmaf and flush in "
                      "registers",
            "source": "multiposenet_tpu_torch/csrc/train_update.cu",
            "replaces": ("multiposenet_tpu/train/steps.py:223 and "
                         "train/prn_train.py:186 (optax's update, "
                         "XLA-fused, no Pallas kernel)"
                         if key == "prn" else
                         "multiposenet_tpu/train/steps.py:231 (the EMA, "
                         "XLA-fused, no Pallas kernel)"),
            "shapes": "Config()'s PRN" if key == "prn"
                      else "Config()'s parameters",
            "max_abs_err": r["max_abs_err"] if key == "ema" else max(
                out[key][k]["max_abs_err"] for k in ("params", "mu", "nu")),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": r["library_ms"], "held_against_plain": True})
    return rows


def phase_train_parity(Config, MultiPoseNet, synthetic, loader, steps_lib,
                       device, card: str) -> dict:
    """The tiny config in float32, TF32 off: 3 steps on the card and 3 on
    the CPU from the same seeded weights and batches (`card_cpu_steps`).
    Then 20 steps with warmup 2 on one batch on the card: total_loss
    falls by at least half. Last, the optimizer's, the EMA's and the PRN
    Adam's updates card against CPU on identical inputs of the tiny
    model's shapes (`update_card_vs_cpu`), reported."""
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
    update = update_card_vs_cpu(
        cfg, [tuple(p.shape) for p in model.parameters()], steps_lib,
        device, seed=1)
    emit({"phase": "train_parity", "card": card, "config": "tiny f32",
          "image": TINY_IMAGE, "batch": TINY_BATCH, "tf32": False,
          **parity, "fit_one_batch_total_loss": curve,
          "update_card_vs_cpu": update})
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
    depth) at 512², batch 32: 2 warm-up and 5 timed steps; then
    `update_card_vs_cpu` at Config()'s parameter shapes, reported."""
    flags = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, image_size=TRAIN_IMAGE, batch_size=TRAIN_BATCH))
    out = timed_train(cfg, MultiPoseNet, synthetic, loader, steps_lib,
                      device, 2, 5)
    update = update_card_vs_cpu(
        cfg, [tuple(p.shape) for p in MultiPoseNet(cfg).parameters()],
        steps_lib, device, seed=2)
    emit({"phase": "train_default", "card": card, "config": "Config() f32",
          "image": TRAIN_IMAGE, "batch": TRAIN_BATCH, "tf32_flags": flags,
          "clock": "CUDA events per step; loader on the host clock", **out,
          "update_card_vs_cpu": update})


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


# Phase `train_to_ap`: the JAX package's slow AP gate
# (tests/test_integration_ap.py) at its recipe, and its quality script at
# 512² (benchmarks/train_synthetic_512.py) through the port's counterpart.
AP_IMAGE = 96
AP_RECIPE = {"train_records": 64, "eval_records": 12, "steps": 500,
             "warmup": 20, "prn_steps": 150}
AP_FLOORS = {"gtbox": {"AP50": 0.8, "AP": 0.35, "AP75": 0.45},
             "e2e": {"AP50": 0.35, "AR50": 0.35}, "mean_err_hm_px": 1.0}
FAST_512_ARGV = ["--style", "v1"]
# Half of the JAX package's measurement, e2e AP 0.695 and GT-box AP 0.907
# (README.md, "Round 3 — quality at the shipped 512² operating point").
FAST_512_FLOORS = {"e2e_512": 0.35, "gtbox_512": 0.45}
FAST_512_REFERENCE = {
    "source": "README.md round-3 table: the JAX package's "
              "benchmarks/train_synthetic_512.py --style v1 on one TPU v5e",
    "e2e_512": {"AP": 0.695, "AP50": 0.910, "AP75": 0.747, "AR": 0.727},
    "e2e_512_pool256": {"AP": 0.710, "AP50": 0.935, "AP75": 0.768,
                        "AR": 0.748},
    "gtbox_512": {"AP": 0.907, "AP50": 1.0, "AP75": 1.0, "AR": 0.935}}
# The port's own earlier reading of this part on an NVIDIA H100 80GB HBM3
# at 700 W, before its optimizer, schedule and EMA rounded as the JAX
# package's compiled step (PERF.md §6).
FAST_512_EARLIER = {"e2e_512": {"AP": 0.669}, "gtbox_512": {"AP": 0.896}}


def ap_gate_config(config):
    """test_integration_ap.py's `_config()` in the port's config module."""
    r = AP_RECIPE
    return config.Config(
        model=config.ModelConfig(backbone_width=0.25, fpn_channels=32,
                                 head_channels=32, bn_momentum=0.9),
        detector=config.DetectorConfig(score_threshold=0.05,
                                       max_detections=6, pre_nms_top_k=100),
        prn=config.PRNConfig(crop_height=14, crop_width=10,
                             hidden_units=128, max_persons=4),
        decode=config.DecodeConfig(score_threshold=0.1),
        train=config.TrainConfig(image_size=AP_IMAGE, batch_size=8,
                                 num_steps=r["steps"],
                                 warmup_steps=r["warmup"],
                                 learning_rate=3e-3, seed=0))


def gate_records(synthetic, n: int, seed: int) -> list[dict]:
    """The gates' fixtures v1 scenes at 96², scale floor 0.3."""
    return synthetic.make_dataset(n, img_h=AP_IMAGE, img_w=AP_IMAGE,
                                  min_persons=1, max_persons=2, seed=seed,
                                  style="v1", min_size=0.3, max_size=0.65)


def ap_gate_stats(pred, records, oks, runner) -> dict:
    """The slow gate's statistics: GT-box OKS stats with the mean matched
    keypoint error in heatmap pixels, and the detector-driven e2e stats."""
    ev = oks.KeypointEvaluator()
    errs = []
    for rec in records:
        kps = pred.predict_given_boxes(rec["image"], rec["boxes"])
        for p in range(len(rec["boxes"])):
            gt = rec["keypoints"][p]
            vis = gt[:, 2] > 0
            errs.append(np.linalg.norm(kps[p][vis, :2] - gt[vis, :2],
                                       axis=-1))
        ev.add_image(runner.record_ground_truths(rec), [
            oks.DetectionKP(keypoints=kps[p].astype(np.float32), score=1.0)
            for p in range(len(rec["boxes"]))])
    return {"gtbox": ev.summarize(),
            "mean_err_hm_px": float(np.concatenate(errs).mean()) / 4.0,
            "e2e": runner.evaluate_predictor(pred, records)}


def missed_floors(stats: dict, floors: dict) -> list[str]:
    """The floors `stats` misses (the error is a ceiling)."""
    missed = []
    for group, want in floors.items():
        if group == "mean_err_hm_px":
            if not stats[group] < want:
                missed.append(f"{group} {stats[group]} >= {want}")
            continue
        for k, floor in want.items():
            if not stats[group][k] >= floor:
                missed.append(f"{group} {k} {stats[group][k]} < {floor}")
    return missed


def phase_train_to_ap(config, synthetic, loader, train_loop, prn_train,
                      steps_lib, weights, Predictor, oks, runner, tool512,
                      decode, kernels, device, directory: Path,
                      card: str, update_launches: dict | None = None
                      ) -> dict:
    """Training to quality on the card from the port's own init, two
    parts. `train_to_ap_96`: the slow gate's recipe (its `_config()`, 64
    fixtures v1 scenes at 96², 500 steps through `train.loop.train`, 150
    PRN steps, the EMA model in the Predictor, 12 eval scenes) held to
    its floors (AP_FLOORS). `train_to_ap_512`: Config.fast() at 512²
    through `tools/train_synthetic_512.run` (FAST_512_ARGV, its defaults:
    1200 + 400 steps, batch 16, 192 training scenes of 1-8 persons, 32
    eval scenes of 2-8, float32, bn_momentum 0.95) held to half of the
    JAX package's e2e and GT-box AP (FAST_512_FLOORS). B1 launches are
    counted from 0 at the start of each part (training launches none;
    each eval `predict` and `predict_given_boxes` launches one); the
    update kernels' launches, from 0 at part 1's start through its two
    trainers, go into `update_launches` where given. A missed floor
    raises. Returns the B1 launches by part."""
    from multiposenet_tpu_torch.train import xla_arith

    update_launches = {} if update_launches is None else update_launches
    flags = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    launches = {}
    # Part 1: the slow gate's recipe at 96².
    t_phase = time.perf_counter()
    kernels.reset_launches()
    cfg = ap_gate_config(config)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(directory / "train_to_ap_96")))
    r = AP_RECIPE
    records = gate_records(synthetic, r["train_records"], 0)
    batches = functools.partial(loader.batch_iterator, records, 8, AP_IMAGE,
                                cfg.prn.max_persons, train=True,
                                augment=False)
    logs = []
    t0 = time.perf_counter()
    state = train_loop.train(cfg, batches, checkpoint=False,
                             log_fn=logs.append, mesh=[device])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prn_state = prn_train.train_prn(cfg, batches(), num_steps=r["prn_steps"],
                                    device=device)
    torch.cuda.synchronize()
    prn_s = time.perf_counter() - t0
    # The update kernels' launches on this path (the trainers' own).
    for name in (xla_arith.ADAM_KERNEL, xla_arith.EMA_KERNEL):
        update_launches[name] = kernels.LAUNCHES.get(name, 0)
    with steps_lib.ema_weights(state) as model:
        variables = weights.posenet_variables(model)
    pred = Predictor(cfg, variables=variables,
                     prn_variables=weights.prn_variables(prn_state.model),
                     image_size=AP_IMAGE, device=device)
    t0 = time.perf_counter()
    stats = ap_gate_stats(pred, gate_records(synthetic, r["eval_records"],
                                             77), oks, runner)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches["train_to_ap_96"] = kernels.LAUNCHES.get(decode.KERNEL, 0)
    missed = missed_floors(stats, AP_FLOORS)
    emit({"phase": "train_to_ap", "part": "train_to_ap_96", "card": card,
          "recipe": "tests/test_integration_ap.py _config(), fixtures v1, "
                    "from the port's init",
          "image": AP_IMAGE, **r, "tf32_flags": flags, **stats,
          "floors": AP_FLOORS, "missed": missed,
          "last_metrics": logs[-1] if logs else None,
          "steps_per_s": r["steps"] / train_s, "train_s": train_s,
          "prn_s": prn_s, "eval_s": eval_s,
          "b1_launches": launches["train_to_ap_96"],
          "update_launches": {name: update_launches[name] for name in (
              xla_arith.ADAM_KERNEL, xla_arith.EMA_KERNEL)},
          "seconds": time.perf_counter() - t_phase,
          "clock": "host perf_counter, the card synchronized"})
    if missed:
        raise AssertionError(f"train_to_ap_96: missed {missed}")
    if launches["train_to_ap_96"] != 2 * r["eval_records"]:
        raise AssertionError(f"train_to_ap_96: B1 launches {launches}")
    del state, prn_state, pred
    # Part 2: Config.fast() at 512² through the tool.
    t_phase = time.perf_counter()
    kernels.reset_launches()
    args = tool512.parse_args(FAST_512_ARGV + ["--device", str(device)])
    lines = []
    out = tool512.run(args, emit=lines.append)
    torch.cuda.synchronize()
    launches["train_to_ap_512"] = kernels.LAUNCHES.get(decode.KERNEL, 0)
    fast_cfg = tool512.make_config(args, str(directory))
    loader_rate = loader_img_per_s(
        loader, synthetic.make_dataset(32, img_h=tool512.SIZE,
                                       img_w=tool512.SIZE, min_persons=1,
                                       max_persons=8, seed=0,
                                       style=args.style), fast_cfg, 3)
    got = {k: out[k]["AP"] for k in FAST_512_FLOORS}
    missed = [f"{k} AP {got[k]} < {floor}"
              for k, floor in FAST_512_FLOORS.items() if not got[k] >= floor]
    emit({"phase": "train_to_ap", "part": "train_to_ap_512", "card": card,
          "argv": FAST_512_ARGV, "config": "Config.fast(), float32 "
          "training, bn_momentum 0.95", "steps": args.steps,
          "prn_steps": args.prn_steps, "batch": args.batch_size,
          "train_images": args.train_images,
          "eval_images": args.eval_images, "tf32_flags": flags,
          **{k: out[k] for k in ("e2e_512", "gtbox_512",
                                 "e2e_512_pool256")},
          "reference": FAST_512_REFERENCE, "earlier": FAST_512_EARLIER,
          "floors_AP": FAST_512_FLOORS,
          "missed": missed,
          "last_metrics": next((m for m in reversed(lines)
                                if "total_loss" in m), None),
          "steps_per_s": args.steps / out["train_s"],
          "train_img_per_s": args.steps * args.batch_size / out["train_s"],
          "loader_img_per_s": loader_rate, "train_s": out["train_s"],
          "prn_s": out["prn_s"], "eval_s": out["eval_s"],
          "b1_launches": launches["train_to_ap_512"],
          "seconds": time.perf_counter() - t_phase,
          "clock": "host perf_counter, the card synchronized"})
    if missed:
        raise AssertionError(f"train_to_ap_512: missed {missed}")
    if launches["train_to_ap_512"] != 3 * args.eval_images:
        raise AssertionError(f"train_to_ap_512: B1 launches {launches}")
    return launches


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


# --- several cards ------------------------------------------------------------


def sync_all() -> None:
    """Wait for every visible card."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def agreement(got: dict, want: dict) -> dict:
    """Outputs of one pipeline computed in other batch splits: the share
    of peak and detection slots whose validity agrees, of valid peaks on
    the same pixel, of valid boxes within 1 px and of valid scores within
    0.02 (the bf16 agreement bounds of ROADMAP's rounding contracts)."""
    pv, bv = want["peak_valid"], want["box_valid"]
    both = pv & got["peak_valid"]
    boxes = bv & got["box_valid"]
    return {
        "peak_valid_agree": float((pv == got["peak_valid"]).float().mean()),
        "box_valid_agree": float((bv == got["box_valid"]).float().mean()),
        "peaks_same_pixel": float((got["peak_positions"][both]
                                   == want["peak_positions"][both])
                                  .all(-1).float().mean()),
        "boxes_within_1px": float(((got["boxes"][boxes] - want["boxes"][
            boxes]).abs().amax(-1) <= 1.0).float().mean()),
        "scores_within_0.02": float(((got["box_scores"][boxes].float()
                                      - want["box_scores"][boxes].float())
                                     .abs() <= 0.02).float().mean())}


def phase_batch_runner_mesh(Config, Predictor, decode, kp_tail, kernels,
                            image_ops, mesh_lib, card: str) -> dict:
    """`Predictor.make_batch_runner()` over every visible card
    (parallel/mesh.py): Config.fast() (B1) and the served crowd model (BN
    folded, B3 and B2), batches of BATCH s4-flat uint8 scenes on the host,
    each card's chunk through the same pipeline on its replica. Launches
    per card, counted from 0 just before 3 batches: one of each kernel a
    batch and card. The outputs against `batch_forward` of the whole batch
    on card 0: identical on a one-card mesh (the runner is batch_forward),
    else the bf16 agreement bounds (valid slots, peaks, boxes, scores).
    img/s on the host clock around the batches, every card synchronized.
    Returns the path's launches by kernel, summed over the cards."""
    mesh = mesh_lib.make_mesh()
    cards = len(mesh)
    rng = np.random.RandomState(4)
    batch = image_ops.space_to_depth_flat4(
        planted_scenes(rng, BATCH, IMAGE, IMAGE))
    fast = Config.fast()
    fast = fast.replace(detector=dataclasses.replace(fast.detector,
                                                     score_threshold=0.0))
    crowd = Config.crowd()
    crowd = crowd.replace(
        model=dataclasses.replace(crowd.model, kp_tail_pallas=True),
        detector=dataclasses.replace(crowd.detector, score_threshold=0.0))
    totals, rows = {}, {}
    for name, cfg, fold, expect in (
            ("fast", fast, False, {decode.KERNEL: 1}),
            ("crowd", crowd, True, {kp_tail.KERNEL: 1,
                                    decode.LANES_KERNEL: 1})):
        pred = Predictor(cfg, image_size=IMAGE, fold_bn=fold)
        with torch.no_grad():
            pred.model.keypoint_head.output.bias[
                :cfg.model.num_keypoints].fill_(0.25)
        lanes = decode_lanes_on(decode) if name == "crowd" \
            else contextlib.nullcontext()
        with lanes:
            want = pred.batch_forward(batch)
            run = pred.make_batch_runner(mesh)
            run(batch)
            sync_all()
            kernels.reset_launches()
            t0 = time.perf_counter()
            for _ in range(3):
                got = run(batch)
            sync_all()
            seconds = time.perf_counter() - t0
            per_card = dict(kernels.LAUNCHES_BY_DEVICE)
        want_launches = {(k, d.index): 3 * n for k, n in expect.items()
                         for d in mesh}
        if per_card != want_launches:
            raise AssertionError(f"batch_runner_mesh {name}: launches "
                                 f"{per_card}, want {want_launches}")
        for k, n in expect.items():
            totals[k] = totals.get(k, 0) + 3 * n * cards
        if cards == 1:
            if run != pred.batch_forward or not all(
                    torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"batch_runner_mesh {name}: one card "
                                     "is not batch_forward")
            agree = "identical (the runner is batch_forward)"
        else:
            agree = agreement(got, want)
            if not (agree["peak_valid_agree"] >= 0.99
                    and agree["box_valid_agree"] >= 0.99
                    and agree["peaks_same_pixel"] >= 2 / 3
                    and agree["boxes_within_1px"] >= 0.5
                    and agree["scores_within_0.02"] >= 0.99):
                raise AssertionError(f"batch_runner_mesh {name}: {agree}")
        rows[name] = {"img_per_s": 3 * BATCH / seconds,
                      "ms_per_batch": seconds / 3 * 1e3,
                      "launches_per_card": {f"{k}@{c}": n for (k, c), n
                                            in sorted(per_card.items(),
                                                      key=str)},
                      "vs_batch_forward": agree}
        del pred, run, got, want
    emit({"phase": "batch_runner_mesh", "card": card, "cards": cards,
          "batch": BATCH, "image": IMAGE, "staging": "s4-flat uint8 on the "
          "host, each card's chunk copied to it", **rows,
          "clock": "host perf_counter around 3 batches, every card "
                   "synchronized"})
    return totals


DDP_STEPS = 3
DDP_TOL = 1e-5  # losses (relative) and weights (of scale, scale_err)


def allreduce_worker(rank: int, mesh, port: int, backend: str, numel: int,
                     reps: int):
    """One rank of the all-reduce timing: `reps` sums of a float32
    gradient bucket of `numel` elements after 3 warm-ups; ms each on the
    host clock, the card synchronized."""
    from multiposenet_tpu_torch.parallel import mesh as mesh_lib

    on_card = mesh[rank].type == "cuda"
    if on_card:
        torch.cuda.set_device(mesh[rank])
    mesh_lib.init_process_group(rank, len(mesh), port, backend)
    try:
        bucket = torch.ones(numel, device=mesh[rank])
        for _ in range(3):
            mesh_lib.all_reduce_sum_(bucket)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            mesh_lib.all_reduce_sum_(bucket)
        if on_card:
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3
    finally:
        mesh_lib.destroy_process_group()


def allreduce_ms(mesh_lib, mesh, numel: int, reps: int = 20) -> float:
    """Rank 0 of allreduce_worker here, the other ranks spawned."""
    import multiprocessing

    port = mesh_lib.free_port()
    backend = mesh_lib.backend_for(mesh)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=allreduce_worker,
                         args=(r, mesh, port, backend, numel, reps))
             for r in range(1, len(mesh))]
    for p in procs:
        p.start()
    try:
        ms = allreduce_worker(0, mesh, port, backend, numel, reps)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError("train_ddp: an all-reduce rank failed")
    return ms


def scale_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the tensor's scale, max(1, max |want|): an
    absolute error for parameters below 1 (a bias that starts at 0 moves
    by about the lr in its first updates, and Adam moves an element of
    near-zero gradient by about ±lr on the sign of its rounding), a
    relative one above (BatchNorm's running variances)."""
    scale = max(float(want.abs().max()), 1.0)
    return float((got.double() - want.double()).abs().max()) / scale


def phase_train_ddp(Config, synthetic, loader, train_loop, mesh_lib,
                    device, card: str) -> None:
    """Data-parallel training through `train.loop.train` (parallel/mesh.py):
    DDP_STEPS steps of Config() in float32 (TF32 off) at 512², global
    batch 32, on the largest count up to 4 of the visible cards that
    divides the batch with NCCL, or with one card on two ranks sharing it
    over gloo (gloo reduces CUDA tensors through the host), against the
    one-rank run on the same global batches (augmented once, every rank
    its rows): the losses of steps 1 and 2 within DDP_TOL = 1e-5
    relative (10x at step 3, after the first real update), parameters
    and BatchNorm statistics after the last within 1e-5 of each tensor's
    scale (scale_err). This process is rank
    0; the others are spawned. A group that does not form fails the run.
    Prints the world size, the backend, step ms on the loop's host clock
    (both runs), the all-reduce ms of the gradient bucket, and the
    loader's img/s per rank (its rows decoded and augmented, the others'
    draws replayed)."""
    cards = torch.cuda.device_count()
    mesh = (mesh_lib.make_mesh_for_batch(TRAIN_BATCH,
                                         mesh_lib.make_mesh()[:4])
            if cards >= 2 else [device, device])
    world, backend = len(mesh), mesh_lib.backend_for(mesh)
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, image_size=TRAIN_IMAGE, batch_size=TRAIN_BATCH,
        log_interval_steps=1))
    records = synthetic.make_dataset(TRAIN_BATCH * DDP_STEPS, img_h=256,
                                     img_w=256, seed=5)
    rng = np.random.RandomState(6)
    batches = [loader.make_batch(records[TRAIN_BATCH * i:
                                         TRAIN_BATCH * (i + 1)],
                                 TRAIN_IMAGE, cfg.prn.max_persons, rng)
               for i in range(DDP_STEPS)]
    source = train_loop.GlobalBatches(batches)
    logs = {"one": [], "ddp": []}
    with no_tf32():
        one = train_loop.train(cfg, source, DDP_STEPS, checkpoint=False,
                               log_fn=logs["one"].append, mesh=[device])
        ddp = train_loop.train(cfg, source, DDP_STEPS, checkpoint=False,
                               log_fn=logs["ddp"].append, mesh=mesh)
    if [m["step"] for m in logs["ddp"]] != list(range(1, DDP_STEPS + 1)):
        raise AssertionError(f"train_ddp: logged {logs['ddp']}")
    loss_errs = [{k: rel_err(d[k], o[k]) for k in o if k.endswith("loss")}
                 for d, o in zip(logs["ddp"], logs["one"])]
    want, got = one.state_dict(), ddp.state_dict()
    param_err = max(scale_err(got["params"][k], v)
                    for k, v in want["params"].items())
    stats_err = max(scale_err(got["batch_stats"][k], v)
                    for k, v in want["batch_stats"].items())
    # Steps 1 and 2 run on the same parameters (lr 0 at the first
    # update); step 3 follows the first real update, where Adam moves an
    # element of near-zero gradient by about ±lr on the sign of its
    # rounding: 10x there.
    bounds = [DDP_TOL] * 2 + [10 * DDP_TOL] * (DDP_STEPS - 2)
    ok = (all(max(e.values()) <= b for e, b in zip(loss_errs, bounds))
          and max(param_err, stats_err) <= DDP_TOL)
    numel = sum(v.numel() for v in want["params"].values())
    bucket_ms = allreduce_ms(mesh_lib, mesh, numel)
    loader_rates = []
    for r in range(world):
        it = loader.batch_iterator(records, TRAIN_BATCH, TRAIN_IMAGE,
                                   cfg.prn.max_persons, seed=1, rank=r,
                                   world_size=world)
        next(it)
        t0 = time.perf_counter()
        for _ in range(3):
            next(it)
        loader_rates.append(3 * TRAIN_BATCH / world
                            / (time.perf_counter() - t0))

    def step_ms(log):
        return [TRAIN_BATCH / m["images_per_sec"] * 1e3 for m in log]

    emit({"phase": "train_ddp", "card": card, "cards": cards,
          "world_size": world, "backend": backend,
          "mesh": [str(d) for d in mesh], "config": "Config() f32, TF32 off",
          "image": TRAIN_IMAGE, "global_batch": TRAIN_BATCH,
          "steps": DDP_STEPS,
          "max_rel_err": {"losses": max(max(e.values())
                                        for e in loss_errs),
                          "params_of_scale": param_err,
                          "batch_stats_of_scale": stats_err},
          "loss_rel_err_by_step": loss_errs, "held_ok": ok,
          "step_ms": step_ms(logs["ddp"]), "one_rank_step_ms":
              step_ms(logs["one"]),
          "allreduce_ms": bucket_ms, "allreduce_numel": numel,
          "allreduce_what": "sum of a float32 bucket of every parameter, "
                            "host clock after synchronize, mean of 20",
          "loader_img_per_s_per_rank": loader_rates,
          "clock": "step ms from the loop's images_per_sec (host clock, "
                   "each step's metrics read back)"})
    if not ok:
        raise AssertionError(f"train_ddp: losses {loss_errs}, parameters "
                             f"{param_err}, statistics {stats_err}")


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
        from multiposenet_tpu_torch import cli, kernels, weights
        from multiposenet_tpu_torch import config as config_mod
        from multiposenet_tpu_torch.config import Config
        from multiposenet_tpu_torch.data import loader, synthetic
        from multiposenet_tpu_torch.eval import oks, runner
        from multiposenet_tpu_torch.infer import export, folding
        from multiposenet_tpu_torch.infer.predictor import Predictor
        from multiposenet_tpu_torch.models import layers
        from multiposenet_tpu_torch.models.posenet import MultiPoseNet
        from multiposenet_tpu_torch.ops import (column_topk, decode,
                                                detection, kp_tail)
        from multiposenet_tpu_torch.ops import image as image_ops
        from multiposenet_tpu_torch.parallel import mesh as mesh_lib
        from multiposenet_tpu_torch.tools import dbench2
        from multiposenet_tpu_torch.tools import train_synthetic_512
        from multiposenet_tpu_torch.data import prepare
        from multiposenet_tpu_torch.train import checkpoints as train_ckpt
        from multiposenet_tpu_torch.train import loop as train_loop
        from multiposenet_tpu_torch.train import prn_train
        from multiposenet_tpu_torch.train import steps as steps_lib
        from multiposenet_tpu_torch.train import xla_arith
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
                                     device, ptxas),
            *phase_train_update_kernel(Config, MultiPoseNet, prn_train,
                                       xla_arith, device)]
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
    mesh_launches = phase_batch_runner_mesh(Config, Predictor, decode,
                                            kp_tail, kernels, image_ops,
                                            mesh_lib, card)
    b1_paths["batch_runner_mesh"] = mesh_launches.pop(decode.KERNEL)
    for name, n in mesh_launches.items():
        launches[name] += n
    phase_image_codec(image_io, image_codec, jpeg, card)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="cli_",
                                     dir=kernels.BUILD_DIR) as directory:
        b1_paths.update(phase_eval(Config, Predictor, export, cli, runner,
                                   decode, kernels, Path(directory), card))
        b1_paths["cli_predict"] = phase_cli_predict(
            cli, image_io, visualize, synthetic, decode, kernels,
            Path(directory), card)
        b1_paths.update(phase_eval_jpeg(cli, image_io, visualize, jpeg,
                                        decode, kernels, Path(directory),
                                        card))
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
        b1_paths.update(phase_train_to_ap(
            config_mod, synthetic, loader, train_loop, prn_train, steps_lib,
            weights, Predictor, oks, runner, train_synthetic_512, decode,
            kernels, device, Path(directory), card, launches))
        phase_train_ddp(Config, synthetic, loader, train_loop, mesh_lib,
                        device, card)
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
