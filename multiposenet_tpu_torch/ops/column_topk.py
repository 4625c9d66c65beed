"""Per-column top-8 of the 3x3 peak mask: phase A of the heatmap decode
without the blur, the port of the decode micro-benchmark's TPU kernel
(`benchmarks/ab/dbench2.py` `kern_reduce`).

Per bf16 map [H, W], read as f32: an element is a peak where it is >= the
max of its 3x3 window (-inf outside the map; plateau maxima all count).
Each column then takes 8 rounds, each of which takes the column's largest
peak, the least packed row `row * 16 + 5` holding it, and removes it. So a
column's list is its top 8 peaks by value, ties to the lower row, and a
column with fewer than 8 peaks fills the rest with (-inf, 5). The outputs
are column 0's lists, as the TPU kernel stores them: scores [N, 8] f32 and
packed rows [N, 8] int32.

`column_topk` is the one entry point: on a CPU tensor it runs the plain
PyTorch version `column_topk_plain`; on a CUDA tensor it launches the
hand-written kernel `csrc/column_topk.cu` (or raises). The kernel computes
every column's lists, and writes them to `columns_out` where it is given.
"""

from __future__ import annotations

import ctypes

import torch

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.ops.decode import window_max

KERNEL = "column_topk"
TOP = 8                 # peaks per column
MAX_WIDTH = 1024        # csrc/column_topk.cu: a thread per column
MAX_ROWS = 2 ** 27      # packed rows row * 16 + 5 fit int32
# csrc/column_topk.cu's launch plan: its constants (the names after `k`
# there) and the order of the fields `column_topk_plan` returns (struct
# Plan).
PLAN_FIELDS = ("fast", "threads", "chunk_rows", "chunks", "pitch",
               "smem_bytes", "blocks_per_sm", "grid")
STRIP = 16              # rows per peak mask
STAGES = 2              # tiles staged at once
CHUNK_BYTES = 32768     # off the fast path: a tile's rows
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 1024   # reserved by the runtime
FAST_SIZE = 128         # the fast path's H and W
FAST_CHUNK = 64
FAST_THREADS = 128
FAST_REGS = 80
GENERIC_REGS = 64
H100_SMS = 132


def launch_plan(n: int, h: int, w: int, sms: int = H100_SMS) -> dict:
    """The launch plan csrc/column_topk.cu (`make_plan`) takes for n maps
    of h x w on a card of `sms` SMs: 128x128 maps take the fast
    instantiation (tiles of 64 rows, 128 threads, at most 80 registers);
    other sizes a thread per column (at least 128, at most 64 registers)
    and tiles of about 32 KB of rows, a multiple of 16. Each tile is staged
    with a halo row above and below, in a ring of STAGES (the next tile
    loads while this one is walked), beside a 16-bit peak mask per strip
    of 16 rows and column. The grid is persistent: as many blocks as fit
    on the SMs by registers, threads and shared memory, at most n."""
    fast = h == FAST_SIZE and w == FAST_SIZE
    pitch = -(-w // 8) * 8
    threads = FAST_THREADS if fast else max(128, -(-w // 32) * 32)
    if fast:
        chunk_rows = FAST_CHUNK
    else:
        fit = CHUNK_BYTES // (2 * pitch) // STRIP * STRIP
        chunk_rows = max(STRIP, min(fit, -(-h // STRIP) * STRIP))
    smem = (STAGES * (chunk_rows + 2) * pitch * 2
            + chunk_rows // STRIP * pitch * 2)
    regs = FAST_REGS if fast else GENERIC_REGS
    blocks_per_sm = min(65536 // (threads * regs), 2048 // threads,
                        SMEM_PER_SM // (smem + SMEM_PER_BLOCK), 32)
    return {"fast": int(fast), "threads": threads, "chunk_rows": chunk_rows,
            "chunks": -(-h // chunk_rows), "pitch": pitch,
            "smem_bytes": smem, "blocks_per_sm": blocks_per_sm,
            "grid": min(n, sms * blocks_per_sm)}


def column_topk_plain(
    x: torch.Tensor, columns: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: x [N, H, W] (any float dtype, read as f32)
    → column 0's (scores [N, 8] f32, packed rows [N, 8] int32), or every
    column's ([N, 8, W] each) with columns=True. The 8 rounds are those of
    the TPU kernel's `keepdims` variant."""
    n, h, w = x.shape
    sm = x.float()
    neg_inf = torch.full_like(sm, -torch.inf)
    masked = torch.where(sm >= window_max(sm, 3), sm, neg_inf)
    pmap = (torch.arange(h, dtype=torch.int32, device=x.device) * 16
            + 5)[:, None]
    big = torch.iinfo(torch.int32).max
    scores, rows = [], []
    for _ in range(TOP):
        colmax = masked.amax(dim=1, keepdim=True)
        pk = torch.where(masked == colmax, pmap, big).amin(dim=1,
                                                          keepdim=True)
        scores.append(colmax)
        rows.append(pk)
        masked = torch.where(pmap == pk, neg_inf, masked)
    scores, rows = torch.cat(scores, dim=1), torch.cat(rows, dim=1)
    if columns:
        return scores, rows
    return scores[:, :, 0].contiguous(), rows[:, :, 0].contiguous()


def _check(x: torch.Tensor, columns_out) -> None:
    """Raise where the kernel does not take x (and columns_out), from
    dtypes, shapes and strides alone."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"column_topk kernel takes bf16 maps, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"column_topk kernel takes [N, H, W] maps, got "
                          f"shape {tuple(x.shape)}")
    n, h, w = x.shape
    if not x.is_contiguous():
        raise ValueError(f"column_topk kernel takes contiguous maps, got "
                          f"strides {x.stride()}")
    if n < 1 or not 1 <= h <= MAX_ROWS or not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"column_topk kernel takes N >= 1, 1 <= H <= "
                          f"2**27 and 1 <= W <= {MAX_WIDTH}; got {n}x{h}x{w}")
    if columns_out is not None and (
            [(tuple(t.shape), t.dtype) for t in columns_out]
            != [((n, TOP, w), torch.float32), ((n, TOP, w), torch.int32)]
            or not all(t.is_contiguous() for t in columns_out)):
        raise ValueError(
            f"columns_out must be contiguous [{n}, {TOP}, {w}] float32 and "
            f"int32 tensors; got "
            f"{[(tuple(t.shape), t.dtype) for t in columns_out]}")


def _check_cuda(x: torch.Tensor, columns_out) -> None:
    """_check, and all tensors on x's CUDA device."""
    _check(x, columns_out)
    tensors = (x, *(columns_out or ()))
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("column_topk kernel takes tensors on one CUDA "
                         "device")


def _launch(x: torch.Tensor, lib: ctypes.CDLL, columns_out
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the C entry point `column_topk` of `lib` on checked tensors;
    raises on a refusal or a launch error."""
    n, h, w = x.shape
    fn = lib.column_topk
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    # One allocation: the scores are the first plane's bits as float32.
    out = torch.empty((2, n, TOP), dtype=torch.int32, device=x.device)
    scores, rows = out[0].view(torch.float32), out[1]
    cols = [t.data_ptr() for t in columns_out] if columns_out else [None] * 2
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), n, h, w, scores.data_ptr(), rows.data_ptr(),
                  *cols, stream)
    if code != 0:
        raise RuntimeError(f"column_topk launch failed: CUDA error {code}")
    return scores, rows


def launch_build(
    x: torch.Tensor, lib: ctypes.CDLL,
    columns_out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Check x [N, H, W] (and columns_out), then launch a build `lib` of
    csrc/column_topk.cu (a profiled one, say) without counting the launch;
    raises on a refusal or a launch error."""
    _check_cuda(x, columns_out)
    return _launch(x, lib, columns_out)


def launch_cuda(
    x: torch.Tensor,
    columns_out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Check x [N, H, W] (and columns_out), then build csrc/column_topk.cu
    on first use, launch its C entry point `column_topk` and count the
    launch; raises on a refusal or a launch error."""
    _check_cuda(x, columns_out)
    out = _launch(x, kernels.load(KERNEL), columns_out)
    kernels.count_launch(KERNEL, x.device)
    return out


def column_topk(
    x: torch.Tensor,
    columns_out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 maps [N, H, W] → column 0's (scores [N, 8] f32, packed rows
    [N, 8] int32); every column's lists are also written to `columns_out`
    ([N, 8, W] float32 and int32) where it is given. On a CUDA tensor this
    launches the kernel (or raises); on a CPU tensor it runs the plain
    version."""
    if x.is_cuda:
        return launch_cuda(x, columns_out)
    _check(x, columns_out)
    scores, rows = column_topk_plain(x, columns=True)
    if columns_out is not None:
        columns_out[0].copy_(scores)
        columns_out[1].copy_(rows)
    return scores[:, :, 0].contiguous(), rows[:, :, 0].contiguous()
