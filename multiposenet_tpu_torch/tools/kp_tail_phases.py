"""Where the bf16 fused-tail kernel (`csrc/kp_tail.cu`, kp_tail_mma)
spends its time, from clock64 counters of warp 0 in every block: builds
the kernel with -DKP_TAIL_PROFILE into `_build/`, runs it at the crowd
path's shapes (B=128, C=64, 128x128, K=17, bf16, seeded inputs) and
prints one JSON line with each phase's share of warp 0's cycles and the
time of the counted and of the plain build. Needs a CUDA device and nvcc.

    python -m multiposenet_tpu_torch.tools.kp_tail_phases
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import torch

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.ops import kp_tail

# The kernel's KP_MARK phases, in order (csrc/kp_tail.cu kPhases).
PHASES = ("prologue", "tensor_cores", "staging_next_chunk",
          "barrier_and_weight_copy", "epilogue")


def build_profiled() -> ctypes.CDLL:
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = kernels.BUILD_DIR / "libkp_tail_profile.so"
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS,
                    "-DKP_TAIL_PROFILE", "-o", str(lib),
                    str(kernels.CSRC / "kp_tail.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def cuda_ms(fn, reps: int = 10, rounds: int = 5) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kp_tail_phases: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    b, c, h, w, k = 128, 64, 128, 128, 17
    g = torch.Generator(device=device).manual_seed(1)
    l2 = torch.randn(b, c, h, w, generator=g, device=device).bfloat16()
    z8 = torch.randn(b, c, h // 2, w // 2, generator=g,
                     device=device).bfloat16()
    weight = torch.randn(k, c, 3, 3, generator=g, device=device) / (9 * c) ** .5
    bias = torch.randn(k, generator=g, device=device)

    lib = build_profiled()
    read = lib.kp_tail_phase_cycles
    read.restype = ctypes.c_int
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counts = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    plain = kernels.load(kp_tail.KERNEL)

    def run(which):
        return kp_tail.launch_cuda(l2, z8, weight, bias, which)

    torch.cuda.synchronize()
    if read(counts, 1) != 0:
        raise RuntimeError("kp_tail_phases: cannot reset the counters")
    got = run(lib)
    torch.cuda.synchronize()
    if read(counts, 1) != 0:
        raise RuntimeError("kp_tail_phases: cannot read the counters")
    want = run(plain)
    if not torch.equal(got, want):
        raise AssertionError("the counted build differs from the plain one")
    cycles = [int(v) for v in counts[:len(PHASES)]]
    total = sum(cycles)
    print(smi, flush=True)
    print(json.dumps({
        "tool": "kp_tail_phases", "card": smi,
        "shapes": {"l2": [b, c, h, w], "z8": [b, c, h // 2, w // 2],
                   "out": [b, k, h, w]},
        "blocks": int(counts[len(PHASES)]),
        "warp0_cycles": dict(zip(PHASES, cycles)),
        "warp0_share": {p: n / total for p, n in zip(PHASES, cycles)},
        "counted_ms": cuda_ms(lambda: run(lib)),
        "plain_build_ms": cuda_ms(lambda: run(plain)),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
