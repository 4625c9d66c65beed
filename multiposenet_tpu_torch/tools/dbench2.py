"""The decode micro-benchmark, the counterpart of `benchmarks/ab/dbench2.py`
and of its sibling `dbench.py`: on 2176 bf16 maps of 128x128 (a fast()
batch of 128 images x 17 keypoints; uniform noise from numpy seed 0, as
`dbench2.py` makes them) it times B4, the per-column top-8 of the 3x3 peak
mask (`ops/column_topk.py`, `csrc/column_topk.cu`), and B1, the whole
heatmap decode of Config.fast() (`ops/decode.py decode_maps`,
`csrc/decode_peaks.cu`), as the two scripts time them: one warm-up call,
then 3 rounds of 20 calls, each round timed by the host clock around a
synchronize. Prints one JSON line with each round's mean time per call,
on the card also on its clock (CUDA events around the same calls), the
card's name and power limit, and B4's bound.

    python -m multiposenet_tpu_torch.tools.dbench2 [--device cpu] [--maps N]

It runs on the CUDA device and raises without one; `--device cpu` runs
the plain PyTorch versions instead, at `--maps` maps, to rehearse it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.ops import column_topk, decode

N_MAPS, H, W = 2176, 128, 128
WARMUP, ROUNDS, REPS = 1, 3, 20
# H100 SXM peaks (NVIDIA data sheet), as chip_smoke.py takes them: HBM
# bandwidth, and float32 operations at one a lane and clock.
HBM_BYTES_PER_S = 3.35e12
F32_NO_FMA_OPS_PER_S = 132 * 128 * 1.98e9


def make_maps(n: int, device) -> torch.Tensor:
    """dbench2.py's input: bf16 [n, 128, 128] uniform noise from
    np.random.RandomState(0), rounded from f32 to bf16."""
    x = np.random.RandomState(0).rand(n, H, W).astype(np.float32)
    return torch.from_numpy(x).to(device).to(torch.bfloat16)


def column_topk_bound(n: int, h: int, w: int) -> dict:
    """The least time of B4 on n bf16 maps of h x w: each map read once and
    column 0's (score f32, row int32) x 8 written per map, over the HBM
    rate; per element 8 maxima and a comparison, over the rate of f32
    operations."""
    bytes_moved = n * h * w * 2 + 2 * n * column_topk.TOP * 4
    ops = 9 * n * h * w
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_NO_FMA_OPS_PER_S * 1e3
    return {"bytes": bytes_moved, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def host_rounds_ms(fn, sync, events: bool = False
                   ) -> tuple[list[float], list[float] | None, object]:
    """WARMUP calls, then ROUNDS rounds of REPS calls: each round's mean ms
    per call on the host clock around `sync`, with `events` also on the
    card's clock (CUDA events recorded around the same calls, so no extra
    launch; they count the card's idle time between calls too, where the
    host issues slower than the kernel runs), and the last call's result."""
    for _ in range(WARMUP):
        out = fn()
    sync()
    rounds, event_rounds = [], [] if events else None
    for _ in range(ROUNDS):
        if events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = fn()
        if events:
            end.record()
        sync()
        rounds.append((time.perf_counter() - t0) / REPS * 1e3)
        if events:
            event_rounds.append(start.elapsed_time(end) / REPS)
    return rounds, event_rounds, out


def run(device=None, maps: int = N_MAPS
        ) -> tuple[dict, tuple[torch.Tensor, torch.Tensor]]:
    """Time B4 and B1 on `maps` of dbench2.py's maps on `device` (the CUDA
    device where None; raises without one). Returns the summary and B4's
    last outputs (column 0's scores and packed rows)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dbench2 times the CUDA kernels: no CUDA "
                               "device (pass device='cpu' to rehearse)")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    x = make_maps(maps, device)
    cfg = Config.fast().decode
    hm = x.view(1, maps, H, W)
    b4_rounds, b4_events, out = host_rounds_ms(
        lambda: column_topk.column_topk(x), sync, on_card)
    b1_rounds, b1_events, _ = host_rounds_ms(
        lambda: decode.decode_maps(hm, cfg), sync, on_card)
    ran = "kernel" if on_card else "plain PyTorch version on the CPU"
    summary = {
        "tool": "dbench2", "device": str(device),
        "card": card_name() if on_card else None,
        "maps": [maps, H, W], "dtype": "bfloat16",
        "timing": f"host clock around synchronize; {WARMUP} warm-up call, "
                  f"{ROUNDS} rounds of {REPS} calls, ms per call",
        "column_topk": {"ran": ran, "rounds_ms": b4_rounds,
                        "ms": min(b4_rounds), "event_rounds_ms": b4_events,
                        **column_topk_bound(maps, H, W)},
        "decode_peaks": {"ran": ran, "config": "Config.fast().decode",
                         "rounds_ms": b1_rounds, "ms": min(b1_rounds),
                         "event_rounds_ms": b1_events},
    }
    return summary, out


def main(argv: list[str] | None = None) -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--device", default=None,
                      help="cpu to rehearse with the plain versions "
                           "(default: the CUDA device)")
    args.add_argument("--maps", type=int, default=N_MAPS)
    opts = args.parse_args(argv)
    summary, _ = run(opts.device, opts.maps)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
