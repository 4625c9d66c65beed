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
the plain PyTorch version `kp_tail_plain`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.models.layers import upsample2x

KERNEL = "kp_tail"
MAX_OUT_CHANNELS = 32   # csrc/kp_tail.cu: accumulators per pixel


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


def _kp_tail_cuda(l2: torch.Tensor, z8: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Launch csrc/kp_tail.cu."""
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
    # [(dy, dx, c), k] rows in the inputs' dtype, the im2col order of the
    # TPU kernel's weight matrix.
    wmat = weight.detach().permute(2, 3, 1, 0).reshape(9 * c, k).to(
        l2.dtype).contiguous()
    bias32 = bias.detach().float().contiguous()
    out = torch.empty((b, k, h, w), dtype=l2.dtype, device=l2.device)
    fn = kernels.load(KERNEL).kp_tail
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
    kernels.count_launch(KERNEL)
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
