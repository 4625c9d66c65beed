"""Smoke test of the PyTorch port (`multiposenet_tpu_torch`) on one NVIDIA
GPU: builds the hand-written CUDA kernels from `csrc/`, holds each against
its plain PyTorch version, holds the float32 model forward on the card
against the same weights on the CPU, then drives the Config.fast()
inference pipeline at full width (512² input, 128² heatmaps, batch 128)
through `Predictor.batch_forward` and serves three `predict` requests.

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

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 outside
# the tensor cores, the rate of the decode kernel's scalar arithmetic.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BATCH, IMAGE = 128, 512


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


def test_maps(n: int, h: int, w: int, device) -> torch.Tensor:
    """bf16 [n, h, w] maps: a third uniform noise, a third Gaussian bumps
    on low noise, a third plateaus of 256 levels in 2x2 blocks (exact ties
    that only the (value desc, flat asc) order resolves)."""
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
    return torch.cat([noise, bumps, plateaus]).to(torch.bfloat16)


def compare_raw(got, want, threshold: float) -> tuple[float, int]:
    """Kernel vs plain (scores, ys, xs), bit for bit on every slot: both
    rank the same f32 values in the same (value desc, flat asc) order, the
    -inf fillers of maps with fewer than P peaks included. Returns (max
    abs error, number of valid slots)."""
    scores, ys, xs = got
    w_scores, w_ys, w_xs = want
    if not (torch.equal(scores, w_scores) and torch.equal(ys, w_ys)
            and torch.equal(xs, w_xs)):
        raise AssertionError("decode kernel disagrees with its plain version")
    finite = torch.isfinite(w_scores)
    err = max(float((scores[finite] - w_scores[finite]).abs().max()),
              float((ys - w_ys).abs().max()), float((xs - w_xs).abs().max()))
    return err, int((w_scores > threshold).sum())


def phase_decode_kernel(decode, kernels, cfg, device) -> dict:
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
    p = cfg.max_peaks_per_channel
    n_taps = len(decode.smoothing_taps(cfg))
    bytes_moved = n * h * w * maps.element_size() + 3 * n * p * 4
    # Per element: a multiply and an add per tap in each blur pass, eight
    # maxima and one comparison for the 3x3 peak test.
    ops = n * h * w * (4 * n_taps + 9)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    row = {
        "name": decode.KERNEL, "route": "cuda",
        "source": "multiposenet_tpu_torch/csrc/decode_peaks.cu",
        "replaces": "multiposenet_tpu/ops/decode_pallas.py:70",
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "held_against_plain": True,
    }
    emit({"phase": "decode_kernel", "maps": [n, h, w], "dtype": "bfloat16",
          "exact": True, "valid_slots": n_valid, "max_abs_err": err,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
          "bytes": bytes_moved, "ops": ops})
    return row


def phase_parity_f32(Config, MultiPoseNet, image_ops, device) -> None:
    """Config.fast() in float32 at full width: the card's forward against
    the CPU forward of the same module. TF32 is switched off for this
    phase (cuDNN would otherwise run f32 convs in TF32) and restored."""
    cfg = Config.fast()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="float32"))
    model = MultiPoseNet(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model.eval()
    model_gpu = copy.deepcopy(model).to(device)
    imgs = planted_scenes(np.random.RandomState(1), 2, IMAGE, IMAGE)
    cells = image_ops.s4_flat_to_cells(
        torch.as_tensor(image_ops.space_to_depth_flat4(imgs)))
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            ref = model(cells)
            out = model_gpu(cells.to(device))
            torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    pairs = {"heatmaps_cm": (out["heatmaps_cm"], ref["heatmaps_cm"])}
    for level, d in ref["detector"].items():
        for kind in ("cls", "box"):
            pairs[f"{level}.{kind}"] = (out["detector"][level][kind], d[kind])
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
          "tolerance": "1e-3 x max(1, max|cpu|)", "max_abs_err": errs})


def phase_pipeline(Config, Predictor, decode, kernels, image_ops,
                   detection, card: str) -> int:
    """Config.fast() (bf16) at full width through Predictor.batch_forward
    on s4-flat uint8 batches. Random-init weights start the class bias at
    the 0.01 prior, under fast()'s 0.05 score threshold, so the threshold
    is set to 0.0 here to give NMS and the PRN real detections (and the
    heatmap bias raised, see below)."""
    cfg = Config.fast()
    cfg = cfg.replace(detector=dataclasses.replace(cfg.detector,
                                                   score_threshold=0.0))
    pred = Predictor(cfg, image_size=IMAGE)
    k, p, d = cfg.model.num_keypoints, cfg.decode.max_peaks_per_channel, \
        cfg.detector.max_detections
    # Random weights also leave every smoothed heatmap under the decode's
    # 0.2 threshold, so no peak would be valid and the PRN snap would go
    # unexercised: the heatmap channels' output bias is set to 0.25.
    with torch.no_grad():
        pred.model.keypoint_head.output.bias[:k].fill_(0.25)
    rng = np.random.RandomState(2)
    batches = [torch.as_tensor(image_ops.space_to_depth_flat4(
        planted_scenes(rng, BATCH, IMAGE, IMAGE))).to(pred.device)
        for _ in range(2)]
    n_warm, n_timed = 2, 5
    torch.cuda.synchronize()
    kernels.reset_launches()
    times = []
    for i in range(n_warm + n_timed):
        t0 = time.perf_counter()
        out = pred.batch_forward(batches[i % 2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    calls = n_warm + n_timed
    if launches.get(decode.KERNEL, 0) != calls:
        raise AssertionError(
            f"expected one decode launch per batch ({calls}), got {launches}")

    shapes = {"boxes": (BATCH, d, 4), "box_scores": (BATCH, d),
              "box_valid": (BATCH, d), "keypoints": (BATCH, d, k, 3),
              "peak_positions": (BATCH, k, p, 2), "peak_scores": (BATCH, k, p),
              "peak_valid": (BATCH, k, p)}
    for name, shape in shapes.items():
        t = out[name]
        if tuple(t.shape) != shape or not torch.isfinite(t.float()).all():
            raise AssertionError(f"pipeline: bad {name} {tuple(t.shape)}")
    if not (bool(out["box_valid"].any()) and bool(out["peak_valid"].any())):
        raise AssertionError("pipeline: no valid detection or peak")

    # The pipeline's own heatmaps through the kernel and the plain version.
    with torch.inference_mode():
        x = pred._model_input(batches[(calls - 1) % 2])
        hm_cm = pred.model(x)["heatmaps_cm"]
        err, n_valid = compare_raw(
            decode.decode_maps(hm_cm, cfg.decode),
            decode.decode_maps_plain(hm_cm.reshape(-1, *hm_cm.shape[2:]),
                                     cfg.decode),
            cfg.decode.score_threshold)
        stages = stage_times(pred, cfg, x, hm_cm, decode, detection)

    ms = statistics.mean(times[n_warm:]) * 1e3
    emit({"phase": "pipeline", "card": card, "config": "Config.fast()",
          "score_threshold_override": 0.0, "heatmap_bias_override": 0.25,
          "batch": BATCH, "image": IMAGE,
          "staging": "s4-flat uint8 on the device", "ms_per_iter": ms,
          "img_per_s": BATCH / ms * 1e3,
          "iter_ms": [t * 1e3 for t in times], "launches": launches,
          "valid_detections": int(out["box_valid"].sum()),
          "valid_peaks": int(out["peak_valid"].sum()),
          "kernel_vs_plain_on_pipeline_heatmaps": {
              "exact": True, "max_abs_err": err, "valid_slots": n_valid},
          "stage_ms": stages,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})

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
        for person in people:
            if not (np.isfinite(person.box).all()
                    and np.isfinite(person.keypoints).all()
                    and person.keypoints.shape == (k, 3)):
                raise AssertionError("predict: bad person")
        persons.append(len(people))
    predict_launches = kernels.LAUNCHES.get(decode.KERNEL, 0)
    if predict_launches != len(images) or not all(persons):
        raise AssertionError(
            f"predict: launches {predict_launches}, persons {persons}")
    emit({"phase": "predict", "card": card, "sizes": sizes,
          "persons": persons, "latency_ms": latencies,
          "launches": predict_launches})
    return launches[decode.KERNEL]


def stage_times(pred, cfg, x, hm_cm, decode, detection) -> dict:
    """CUDA-event times of the pipeline's stages on one batch (each run
    alone, so the sum omits the overlap of the whole program)."""
    out = pred.model(x)
    det = detection.postprocess_detections(out["detector"], IMAGE,
                                           cfg.detector, anchors=pred.anchors)
    peaks = decode.decode_heatmaps_cm(hm_cm, cfg.decode)
    stride = float(cfg.model.output_stride)
    return {
        "model": cuda_ms(lambda: pred.model(x), reps=3, rounds=3),
        "decode": cuda_ms(lambda: decode.decode_heatmaps_cm(hm_cm, cfg.decode),
                          reps=10, rounds=3),
        "detection": cuda_ms(lambda: detection.postprocess_detections(
            out["detector"], IMAGE, cfg.detector, anchors=pred.anchors),
            reps=3, rounds=3),
        "prn": cuda_ms(lambda: pred._prn_assign(hm_cm, det.boxes / stride,
                                                peaks), reps=3, rounds=3),
    }


def ptxas_summary(log: str) -> dict:
    """Registers and spills that `nvcc -Xptxas -v` reports for the
    8-peak instantiations (the main path's P)."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return {k: v for k, v in out.items() if "Li8E" in k}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    try:
        from multiposenet_tpu_torch import kernels
        from multiposenet_tpu_torch.config import Config
        from multiposenet_tpu_torch.infer.predictor import Predictor
        from multiposenet_tpu_torch.models.posenet import MultiPoseNet
        from multiposenet_tpu_torch.ops import decode, detection
        from multiposenet_tpu_torch.ops import image as image_ops
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

    row = phase_decode_kernel(decode, kernels, Config.fast().decode, device)
    phase_parity_f32(Config, MultiPoseNet, image_ops, device)
    row["launches"] = phase_pipeline(Config, Predictor, decode, kernels,
                                     image_ops, detection, card)
    emit({"phase": "done", "elapsed_s": time.perf_counter() - t_start})
    emit({"kernels": [row]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
