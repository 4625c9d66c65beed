"""Fused stride-4 keypoint-head tail, the port of
`multiposenet_tpu/ops/kp_tail_pallas.py` (`kp_tail_cm`):

    out = conv3x3_SAME(l2 + nearest_up2(z8), weight) + bias

written channel-major [B, K, H, W]. The sum is formed in the inputs' dtype
(rounded there, as the TPU kernel does), the conv accumulates in float32,
the float32 bias is added to the accumulator and the result is rounded
once to the inputs' dtype. SAME padding is one ring of zeros around the
sum.

`kp_tail_cm` is the one entry point: on a CUDA tensor it launches the
hand-written kernel `csrc/kp_tail.cu` (or raises), on a CPU tensor it runs
the plain PyTorch version `kp_tail_plain`. The kernel's bf16 path runs on
the tensor cores and reads its weights as `mma.sync` B fragments, packed
here by `tail_weight_matrix` and `tail_weight_fragments`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.models.layers import upsample2x

KERNEL = "kp_tail"
MAX_OUT_CHANNELS = 32   # csrc/kp_tail.cu: accumulators per pixel
CHUNK = 16              # input channels per tensor-core reduction step
N_TILE = 8              # output channels per tensor-core n-tile


def check_shapes(l2: torch.Tensor, z8: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor) -> None:
    """l2 [B, C, H, W], z8 [B, C, H/2, W/2], weight [K, C, 3, 3], bias [K];
    raises ValueError otherwise."""
    if l2.ndim != 4 or z8.ndim != 4:
        raise ValueError(
            f"kp_tail_cm shape mismatch: l2 {tuple(l2.shape)}, "
            f"z8 {tuple(z8.shape)}")
    b, c, h, w = l2.shape
    if (h % 2 or w % 2 or tuple(z8.shape) != (b, c, h // 2, w // 2)
            or weight.ndim != 4 or tuple(weight.shape[1:]) != (c, 3, 3)
            or tuple(bias.shape) != (weight.shape[0],)):
        raise ValueError(
            f"kp_tail_cm shape mismatch: l2 {tuple(l2.shape)}, "
            f"z8 {tuple(z8.shape)}, weight {tuple(weight.shape)}, "
            f"bias {tuple(bias.shape)}")


def kp_tail_plain(l2: torch.Tensor, z8: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the conv of the rounded sum in float32 plus
    the float32 bias, rounded once."""
    check_shapes(l2, z8, weight, bias)
    x = l2 + upsample2x(z8)
    y = F.conv2d(x.float(), weight.to(l2.dtype).float(), padding=1)
    return (y + bias.float()[:, None, None]).to(l2.dtype)


def tail_weight_matrix(weight: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """weight [K, C, 3, 3] → the im2col matrix [9C, N] in `dtype`: rows
    ordered (dy, dx, c) as the TPU kernel's weight matrix, columns the K
    outputs and N - K zero columns, N = K rounded up to a multiple of 8."""
    k, c = weight.shape[:2]
    n = -(-k // N_TILE) * N_TILE
    wmat = torch.zeros(9 * c, n, dtype=dtype, device=weight.device)
    wmat[:, :k] = weight.detach().permute(2, 3, 1, 0).reshape(9 * c, k)
    return wmat


def tail_weight_fragments(wmat: torch.Tensor, c: int) -> torch.Tensor:
    """The [9C, N] matrix of `tail_weight_matrix` in the order the bf16
    kernel reads its mma.sync m16n8k16 B fragments:
    [ceil(C/16), 9, N/8, 32, 4], zero for channels beyond C. Element
    [chunk, tap, nt, lane, e] is wmat[tap*C + 16*chunk + kk, 8*nt + lane//4]
    with kk = 2*(lane%4) + (e%2) + 8*(e//2): lane's two 32-bit B registers,
    the lower channel of each pair in the low half."""
    n = wmat.shape[1]
    chunks = -(-c // CHUNK)
    w = torch.zeros(9, chunks * CHUNK, n, dtype=wmat.dtype,
                    device=wmat.device)
    w[:, :c] = wmat.view(9, c, n)
    # kk = 8*hi + 2*t + lo, n = 8*nt + g, lane = 4*g + t, e = 2*hi + lo.
    w = w.view(9, chunks, 2, 4, 2, n // N_TILE, N_TILE)
    return w.permute(1, 0, 5, 6, 3, 2, 4).reshape(
        chunks, 9, n // N_TILE, 32, 4).contiguous()


def launch_cuda(l2: torch.Tensor, z8: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, lib: ctypes.CDLL) -> torch.Tensor:
    """Check the operands, pack the weights and launch the C entry point
    `kp_tail` of `lib` (a build of csrc/kp_tail.cu); raises on a launch
    error. Counts no launch."""
    b, c, h, w = l2.shape
    k = weight.shape[0]
    if l2.dtype not in (torch.float32, torch.bfloat16) or z8.dtype != l2.dtype:
        raise TypeError("kp_tail kernel takes l2 and z8 of one dtype, f32 or "
                        f"bf16; got {l2.dtype}, {z8.dtype}")
    if not (l2.is_contiguous() and z8.is_contiguous()):
        raise ValueError("kp_tail kernel needs contiguous NCHW l2 and z8")
    if not 1 <= k <= MAX_OUT_CHANNELS:
        raise ValueError(f"kp_tail kernel takes 1..{MAX_OUT_CHANNELS} output "
                         f"channels; got {k}")
    if not (z8.device == weight.device == bias.device == l2.device):
        raise ValueError("kp_tail: l2, z8, weight and bias must share a "
                         "device")
    wmat = tail_weight_matrix(weight, l2.dtype)
    if l2.dtype == torch.bfloat16:  # the tensor-core kernel's fragments
        wmat = tail_weight_fragments(wmat, c)
    else:  # the CUDA-core kernel's [9C, K] matrix
        wmat = wmat[:, :k].contiguous()
    bias32 = bias.detach().float().contiguous()
    out = torch.empty((b, k, h, w), dtype=l2.dtype, device=l2.device)
    fn = lib.kp_tail
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(l2.device):
        stream = torch.cuda.current_stream(l2.device).cuda_stream
        err = fn(l2.data_ptr(), z8.data_ptr(), wmat.data_ptr(),
                 bias32.data_ptr(), out.data_ptr(),
                 1 if l2.dtype == torch.bfloat16 else 0, b, c, h, w, k,
                 stream)
    if err != 0:
        raise RuntimeError(f"kp_tail launch failed: CUDA error {err}")
    return out


def _kp_tail_cuda(l2: torch.Tensor, z8: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Launch csrc/kp_tail.cu and count the launch."""
    out = launch_cuda(l2, z8, weight, bias, kernels.load(KERNEL))
    kernels.count_launch(KERNEL, l2.device)
    return out


def kp_tail_cm(l2: torch.Tensor, z8: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """conv3x3_SAME(l2 + nearest_up2(z8), weight) + bias → [B, K, H, W] in
    l2's dtype.

    l2: [B, C, H, W] stride-4 lateral (FPN L2); z8: [B, C, H/2, W/2]
    stride-8 context (P3 raw + summed towers); weight: [K, C, 3, 3] (cast
    to l2's dtype); bias: [K] (added in float32). On a CUDA tensor this
    launches the kernel (or raises); on a CPU tensor it runs the plain
    version."""
    check_shapes(l2, z8, weight, bias)
    if l2.is_cuda:
        return _kp_tail_cuda(l2, z8, weight, bias)
    return kp_tail_plain(l2, z8, weight, bias)
