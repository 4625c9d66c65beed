"""Where a heatmap decode kernel spends its time, from clock64 counters of
thread 0 in every block: builds `csrc/decode_peaks.cu` (B1, `--kernel
peaks`, with -DDECODE_PEAKS_PROFILE), `csrc/decode_lanes.cu` (B2,
`--kernel lanes`, with -DDECODE_LANES_PROFILE) or `csrc/decode_generic.cu`
(`--kernel generic`, with -DDECODE_GENERIC_PROFILE; `--source` profiles a
copy of it, such as an older design, and `--workspace` hands that copy
the two f32 planes the design before the tiles needed) into `_build/`,
runs it at the fast() path's shapes (batch 128 of 17 bf16 maps of
128x128, seeded noise, bumps and plateaus; `--batch 1` gives a `predict`
request's shapes; B2 reads them channel-major or, with `--layout
channels_last`, channels-last; `--window` and `--peaks` change the
config, which only the generic kernel takes), checks that its outputs
equal those of the plain build, and prints one JSON line with each
phase's share of thread 0's cycles and the time of the counted and of
the plain build. Needs a CUDA device and nvcc.

    python -m multiposenet_tpu_torch.tools.decode_phases \\
        [--kernel peaks|lanes|generic] [--batch N] \\
        [--layout channel_major|channels_last] [--window N] [--peaks N] \\
        [--source PATH [--workspace]]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.ops import decode
from multiposenet_tpu_torch.tools.kp_tail_phases import cuda_ms

# The phases of B1 and B2 (decode_rows.cuh PhaseClock::tick, kPhases).
PHASES = ("load", "vertical_blur", "horizontal_blur", "peak_mask_and_top_p",
          "merge", "subpixel_and_store")
# The generic kernel's (csrc/decode_generic.cu `enum Phase`, DG_MARK).
GENERIC_PHASES = ("load", "vertical_blur", "horizontal_blur",
                  "window_max_and_peak_mask", "selection", "merge", "store")
# --kernel: (source name, profile macro, launcher taking a build, phases).
KERNELS = {
    "peaks": (decode.KERNEL, "DECODE_PEAKS_PROFILE", decode.launch_cuda,
              PHASES),
    "lanes": (decode.LANES_KERNEL, "DECODE_LANES_PROFILE",
              decode.launch_lanes_cuda, PHASES),
    "generic": (decode.GENERIC_KERNEL, "DECODE_GENERIC_PROFILE",
                decode.launch_generic_cuda, GENERIC_PHASES),
}


def build_profiled(kernel: str = "peaks",
                   source: Path | None = None) -> ctypes.CDLL:
    """The counted build of the kernel's source (or of `source`, a copy),
    built into _build/."""
    name, macro, _, _ = KERNELS[kernel]
    src = Path(source) if source else kernels.CSRC / f"{name}.cu"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "" if source is None else "_" + src.parent.name
    lib = kernels.BUILD_DIR / f"lib{name}_profile{tag}.so"
    proc = subprocess.run(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, f"-D{macro}", "-o",
         str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} -D{macro} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def phase_maps(n: int, h: int, w: int, device) -> torch.Tensor:
    """bf16 [n, h, w]: a third uniform noise, a third Gaussian bumps on low
    noise, a third plateaus of 256 levels in 2x2 blocks."""
    g = torch.Generator(device=device).manual_seed(0)
    third = n // 3
    noise = torch.rand(third, h, w, generator=g, device=device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    bumps = 0.05 * torch.rand(third, h, w, generator=g, device=device)
    for _ in range(5):
        cy, cx, amp, sig = torch.rand(4, third, 1, 1, generator=g,
                                      device=device)
        bumps += amp * torch.exp(-((yy - cy * h) ** 2 + (xx - cx * w) ** 2)
                                 / (2 * (1 + 2 * sig) ** 2))
    rest = n - 2 * third
    levels = torch.randint(0, 256, (rest, h // 2, w // 2), generator=g,
                           device=device).float() / 256
    plateaus = levels.repeat_interleave(2, 1).repeat_interleave(2, 2)
    return torch.cat([noise, bumps, plateaus]).to(torch.bfloat16)


def main(argv: list[str] | None = None) -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--kernel", choices=sorted(KERNELS), default="peaks")
    args.add_argument("--batch", type=int, default=128)
    args.add_argument("--layout", choices=("channel_major", "channels_last"),
                      default="channel_major")
    args.add_argument("--window", type=int, default=3)
    args.add_argument("--peaks", type=int, default=8)
    args.add_argument("--source", type=Path, default=None)
    args.add_argument("--workspace", action="store_true")
    opts = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_phases: no CUDA device", file=sys.stderr)
        return 2
    if opts.kernel == "peaks" and opts.layout != "channel_major":
        print("decode_phases: B1 reads channel-major maps only",
              file=sys.stderr)
        return 2
    if opts.kernel != "generic" and (
            (opts.window, opts.peaks) != (3, 8) or opts.source is not None):
        print("decode_phases: --window, --peaks and --source are the "
              "generic kernel's", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    k, h, w = 17, 128, 128
    cfg = dataclasses.replace(Config.fast().decode, nms_window=opts.window,
                              max_peaks_per_channel=opts.peaks)
    x = phase_maps(opts.batch * k, h, w, device).view(opts.batch, k, h, w)
    if opts.layout == "channels_last":
        x = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)

    name, _, launch, phases = KERNELS[opts.kernel]
    lib = build_profiled(opts.kernel, opts.source)
    read = getattr(lib, f"{name}_phase_cycles")
    read.restype = ctypes.c_int
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counts = (ctypes.c_ulonglong * (len(phases) + 1))()
    plain = kernels.load(name)

    def run(which):
        if which is lib and opts.workspace:
            return launch(x, cfg, which, workspace=True)
        return launch(x, cfg, which)

    torch.cuda.synchronize()
    if read(counts, 1) != 0:
        raise RuntimeError("decode_phases: cannot reset the counters")
    got = run(lib)
    torch.cuda.synchronize()
    if read(counts, 1) != 0:
        raise RuntimeError("decode_phases: cannot read the counters")
    want = run(plain)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the counted build differs from the plain one")
    cycles = [int(v) for v in counts[:len(phases)]]
    total = sum(cycles)
    print(smi, flush=True)
    print(json.dumps({
        "tool": "decode_phases", "kernel": name, "card": smi,
        "source": str(opts.source or kernels.CSRC / f"{name}.cu"),
        "maps": [opts.batch, k, h, w], "layout": opts.layout,
        "dtype": "bfloat16", "window": opts.window, "peaks": opts.peaks,
        "blocks": int(counts[len(phases)]),
        "thread0_cycles": dict(zip(phases, cycles)),
        "thread0_share": {p: n / total for p, n in zip(phases, cycles)},
        "counted_ms": cuda_ms(lambda: run(lib)),
        "plain_build_ms": cuda_ms(lambda: run(plain)),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
