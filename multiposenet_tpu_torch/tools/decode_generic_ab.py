"""The generic decode kernel against an earlier design of it, in one
process on one card: builds `csrc/decode_generic.cu` and the copy at
`--old` (a source of the design that needs its two f32 workspace planes
on every launch, e.g. the parent commit's, unpacked by `git archive`
beside its own `decode_rows.cuh`) into `_build/`, holds both to the
plain version bit for bit, then times both at three shapes on the test
maps of `chip_smoke.py` (bf16): a 5x5 window on a `Config()` batch of 64
(1088 maps of 128x128), 20 peaks on [4, 17, 160, 600], and a 5x5 window
on one `predict` request's 17 maps. Each time is the median over rounds
that take the two builds in turns (old, new, new, old): CUDA events
around back-to-back calls (`events_ms`) and a CUDA graph of the calls
(`graph_ms`, the kernel without the host's work per call). Prints the
card's name and power limit, then one JSON line. Needs a CUDA device and
nvcc.

    python -m multiposenet_tpu_torch.tools.decode_generic_ab --old PATH \\
        [--rounds N]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.ops import decode
from multiposenet_tpu_torch.tools.decode_phases import phase_maps

# name: ([B, K, H, W], config changes from Config.fast().decode)
SHAPES = {
    "window5": ((64, 17, 128, 128), dict(nms_window=5)),
    "peaks20_width600": ((4, 17, 160, 600), dict(max_peaks_per_channel=20)),
    "request_window5": ((1, 17, 128, 128), dict(nms_window=5)),
}


def build(src: Path, tag: str) -> ctypes.CDLL:
    """src built into _build/libdecode_generic_<tag>.so."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = kernels.BUILD_DIR / f"libdecode_generic_{tag}.so"
    proc = subprocess.run(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def events_ms(fn, reps: int) -> float:
    """Mean time of `reps` back-to-back calls between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(graph: torch.cuda.CUDAGraph, reps: int) -> float:
    """Time per call of a graph of `reps` calls, replayed once."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: list[str] | None = None) -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--old", type=Path, required=True)
    args.add_argument("--rounds", type=int, default=5)
    opts = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_generic_ab: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    libs = {"old": build(opts.old, "old"), "new": kernels.load(
        decode.GENERIC_KERNEL)}
    base = Config.fast().decode
    result = {}
    for name, ((b, k, h, w), change) in SHAPES.items():
        cfg = dataclasses.replace(base, **change)
        maps = phase_maps(b * k, h, w, device)
        x = maps.view(b, k, h, w)
        want = decode.decode_maps_plain(maps, cfg)
        calls = {
            "old": lambda: decode.launch_generic_cuda(x, cfg, libs["old"],
                                                      workspace=True),
            "new": lambda: decode.launch_generic_cuda(x, cfg, libs["new"]),
        }
        for which, fn in calls.items():
            if not all(torch.equal(a, c) for a, c in zip(fn(), want)):
                raise AssertionError(f"{which} build disagrees with the "
                                     f"plain version at {name}")
        reps = 50 if b == 1 else 5
        graphs = {}
        for which, fn in calls.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            graphs[which] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[which]):
                for _ in range(reps):
                    fn()
        times = {which: {"events_ms": [], "graph_ms": []} for which in calls}
        for _ in range(opts.rounds):
            for which in ("old", "new", "new", "old"):
                times[which]["events_ms"].append(events_ms(calls[which],
                                                           reps))
                times[which]["graph_ms"].append(graph_ms(graphs[which],
                                                         reps))
        del graphs
        result[name] = {
            "maps": [b, k, h, w], "exact": True,
            **{f"{which}_{kind}": statistics.median(v)
               for which, t in times.items() for kind, v in t.items()},
            "launch_plan": decode.generic_launch_plan(
                b * k, h, w, len(decode.smoothing_taps(cfg)),
                cfg.nms_window, cfg.max_peaks_per_channel,
                torch.cuda.get_device_properties(device)
                .multi_processor_count),
        }
    print(smi, flush=True)
    print(json.dumps({"tool": "decode_generic_ab", "card": smi,
                      "old": str(opts.old), "dtype": "bfloat16",
                      "rounds": opts.rounds, "shapes": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
