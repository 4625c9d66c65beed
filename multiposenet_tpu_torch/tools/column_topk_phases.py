"""Where B4, the per-column top-8 of the 3x3 peak mask
(`csrc/column_topk.cu`), spends its time, from clock64 counters of thread
0 in every block: builds the kernel with -DCOLUMN_TOPK_PROFILE into
`_build/`, runs it at the decode micro-benchmark's shape (2176 bf16 maps
of 128x128) on dbench2's maps (seeded uniform noise) and on seeded noise,
bumps and plateaus (`tools/decode_phases.py phase_maps`), checks that the
counted build's outputs, column 0 and every column, equal those of the
plain build, and prints one JSON line with each phase's share of thread
0's cycles on each input and the time of the counted and of the plain
build. Needs a CUDA device and nvcc.

    python -m multiposenet_tpu_torch.tools.column_topk_phases \\
        [--source PATH]

`--source` profiles another copy of the kernel (an older design, say)
that has the same marks and entry points; the plain build is then built
from that copy too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.ops import column_topk
from multiposenet_tpu_torch.tools import dbench2
from multiposenet_tpu_torch.tools.decode_phases import phase_maps
from multiposenet_tpu_torch.tools.kp_tail_phases import cuda_ms

# The kernel's CT_MARK phases, in order (`enum Phase` in the source).
PHASES = ("load", "peak_test", "insertion", "merge", "store")
MACRO = "COLUMN_TOPK_PROFILE"


def build(source: Path, profile: bool) -> ctypes.CDLL:
    """nvcc `source` into _build/, with the profile macro or without."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "profile" if profile else "plain"
    lib = kernels.BUILD_DIR / f"lib{column_topk.KERNEL}_{tag}_{source.stem}.so"
    flags = [f"-D{MACRO}"] if profile else []
    proc = subprocess.run(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *flags, "-o", str(lib),
         str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} {' '.join(flags)} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main(argv: list[str] | None = None) -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--source", type=Path,
                      default=kernels.CSRC / f"{column_topk.KERNEL}.cu")
    opts = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("column_topk_phases: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = dbench2.card_name()
    n, h, w = dbench2.N_MAPS, dbench2.H, dbench2.W
    inputs = {"dbench2": dbench2.make_maps(n, device),
              "phase_maps": phase_maps(n, h, w, device)}
    source = opts.source.resolve()
    lib, plain = build(source, True), build(source, False)
    read = lib.column_topk_phase_cycles
    read.restype = ctypes.c_int
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counts = (ctypes.c_ulonglong * (len(PHASES) + 1))()

    def run(which, x, cols=None):
        return column_topk.launch_build(x, which, cols)

    out = {"tool": "column_topk_phases", "card": smi,
           "source": str(source), "maps": [n, h, w], "dtype": "bfloat16"}
    for name, x in inputs.items():
        got_cols = tuple(torch.empty(n, column_topk.TOP, w, dtype=dt,
                                     device=device)
                         for dt in (torch.float32, torch.int32))
        want_cols = tuple(torch.empty_like(t) for t in got_cols)
        torch.cuda.synchronize()
        if read(counts, 1) != 0:
            raise RuntimeError("column_topk_phases: cannot reset the "
                               "counters")
        got = run(lib, x, got_cols)
        torch.cuda.synchronize()
        if read(counts, 1) != 0:
            raise RuntimeError("column_topk_phases: cannot read the "
                               "counters")
        want = run(plain, x, want_cols)
        if not all(torch.equal(a, b) for a, b in
                   zip((*got, *got_cols), (*want, *want_cols))):
            raise AssertionError(f"the counted build differs from the "
                                 f"plain one on {name}")
        cycles = [int(v) for v in counts[:len(PHASES)]]
        total = sum(cycles)
        out[name] = {
            "blocks": int(counts[len(PHASES)]),
            "thread0_cycles": dict(zip(PHASES, cycles)),
            "thread0_share": {p: c / total for p, c in zip(PHASES, cycles)},
            "counted_ms": cuda_ms(lambda: run(lib, x)),
            "plain_build_ms": cuda_ms(lambda: run(plain, x)),
        }
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
