"""Where a heatmap decode kernel spends its time, from clock64 counters of
thread 0 in every block: builds `csrc/decode_peaks.cu` (B1, `--kernel
peaks`, with -DDECODE_PEAKS_PROFILE) or `csrc/decode_lanes.cu` (B2,
`--kernel lanes`, with -DDECODE_LANES_PROFILE) into `_build/`, runs it at
the fast() path's shapes (batch 128 of 17 bf16 maps of 128x128, seeded
noise, bumps and plateaus; `--batch 1` gives a `predict` request's
shapes; B2 reads them channel-major or, with `--layout channels_last`,
channels-last), checks that its outputs equal those of the plain build,
and prints one JSON line with each phase's share of thread 0's cycles and
the time of the counted and of the plain build. Needs a CUDA device and
nvcc.

    python -m multiposenet_tpu_torch.tools.decode_phases \\
        [--kernel peaks|lanes] [--batch N] \\
        [--layout channel_major|channels_last]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.ops import decode
from multiposenet_tpu_torch.tools.kp_tail_phases import cuda_ms

# The kernels' DP_MARK phases, in order (kPhases in both sources).
PHASES = ("load", "vertical_blur", "horizontal_blur", "peak_mask_and_top_p",
          "merge", "subpixel_and_store")
# --kernel: (source name, profile macro, launcher taking a build).
KERNELS = {
    "peaks": (decode.KERNEL, "DECODE_PEAKS_PROFILE", decode.launch_cuda),
    "lanes": (decode.LANES_KERNEL, "DECODE_LANES_PROFILE",
              decode.launch_lanes_cuda),
}


def build_profiled(kernel: str = "peaks") -> ctypes.CDLL:
    name, macro, _ = KERNELS[kernel]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = kernels.BUILD_DIR / f"lib{name}_profile.so"
    proc = subprocess.run(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, f"-D{macro}", "-o",
         str(lib), str(kernels.CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu -D{macro} (exit "
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
    opts = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_phases: no CUDA device", file=sys.stderr)
        return 2
    if opts.kernel == "peaks" and opts.layout != "channel_major":
        print("decode_phases: B1 reads channel-major maps only",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    k, h, w = 17, 128, 128
    cfg = Config.fast().decode
    x = phase_maps(opts.batch * k, h, w, device).view(opts.batch, k, h, w)
    if opts.layout == "channels_last":
        x = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)

    name, _, launch = KERNELS[opts.kernel]
    lib = build_profiled(opts.kernel)
    read = getattr(lib, f"{name}_phase_cycles")
    read.restype = ctypes.c_int
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counts = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    plain = kernels.load(name)

    def run(which):
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
    cycles = [int(v) for v in counts[:len(PHASES)]]
    total = sum(cycles)
    print(smi, flush=True)
    print(json.dumps({
        "tool": "decode_phases", "kernel": name, "card": smi,
        "maps": [opts.batch, k, h, w], "layout": opts.layout,
        "dtype": "bfloat16", "blocks": int(counts[len(PHASES)]),
        "thread0_cycles": dict(zip(PHASES, cycles)),
        "thread0_share": {p: n / total for p, n in zip(PHASES, cycles)},
        "counted_ms": cuda_ms(lambda: run(lib)),
        "plain_build_ms": cuda_ms(lambda: run(plain)),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
