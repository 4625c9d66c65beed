"""MobileNet-v1-style depthwise-separable backbone, the port of
`multiposenet_tpu/models/mobilenet.py` for the stride-4 matmul stem
(`stem_stride=4`, as Config.fast() sets it), with BN or in its
`bn_folded` inference flavour (conv with a bias, no BN).

Inputs are NHWC (raw pixels [B, H, W, 3] or 4x4 space-to-depth cells
[B, H/4, W/4, 48]); features come out NCHW. Module and parameter names
follow the flax tree (`stem`, `block_<i>`, `depthwise`/`pointwise`,
`conv`/`bn`) so `weights.py` maps one onto the other by name; a folded
block has `conv.bias` and no `bn`, as the folded flax tree has.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from multiposenet_tpu_torch.models.layers import (
    BatchNorm, Conv2d, lecun_normal_, relu6,
)
from multiposenet_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD


def _make_divisible(v: float, divisor: int = 8) -> int:
    """Round channel counts like the standard MobileNet width multiplier."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def space_to_depth_2x(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] → [B, H/2, W/2, 4C]; channel order (dy, dx, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def stem_kernel_to_s4(kernel: torch.Tensor) -> torch.Tensor:
    """Remap a [4, 4, C, O] stride-4 stem kernel to the [16C, O] matmul
    weight over double space-to-depth cells: pixel (4i+dy, 4j+dx) sits at
    composed channel ((dy//2)*2 + dx//2)*4C + ((dy%2)*2 + dx%2)*C + c."""
    rows = [kernel[2 * py1 + py0, 2 * px1 + px0]
            for py1 in (0, 1) for px1 in (0, 1)
            for py0 in (0, 1) for px0 in (0, 1)]
    return torch.cat(rows, dim=0)


class S4StemConv(nn.Module):
    """4x4/s4 stem as one matmul over the composed 4x4 cells. The raw
    kernel [4, 4, C, O] is kept and remapped at forward time; with
    fold_norm the (x/255 - mean)/std affine is composed into it in f32.
    With a bias (the bn_folded flavour) the fold-norm bias and then this
    bias are added, each rounded to the compute dtype, as the JAX package
    does: one merged bias would round differently in bf16."""

    def __init__(self, in_ch: int, features: int, fold_norm: bool,
                 bias: bool = False):
        super().__init__()
        self.fold_norm = fold_norm
        self.kernel = nn.Parameter(torch.zeros(4, 4, in_ch, features))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def seeded_init(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel[..., 0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    @torch.no_grad()
    def fold_affine_(self, s: torch.Tensor, shift: torch.Tensor) -> None:
        """Fold a following per-output-channel y*s + shift into the kernel
        and a new bias."""
        assert self.bias is None, "fold into a stem without a bias"
        self.kernel.mul_(s)
        self.bias = nn.Parameter(shift.clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: raw [B, H, W, C<=4] or s4 cells [B, H/4, W/4, 16C], already
        in the compute dtype → [B, O, H/4, W/4]."""
        if x.shape[-1] <= 4:
            if x.shape[1] % 4 or x.shape[2] % 4:
                raise NotImplementedError(
                    "the s4 stem needs H and W divisible by 4; got "
                    f"{tuple(x.shape[1:3])}")
            x = space_to_depth_2x(space_to_depth_2x(x))
        elif x.shape[-1] <= 16:
            raise NotImplementedError("2x2 space-to-depth cells are not "
                                      "ported; stage 4x4 cells")
        c = self.kernel.shape[2]
        k = stem_kernel_to_s4(self.kernel)  # [16C, O] f32
        norm_bias = None
        if self.fold_norm:
            reps = 16 * c // 3
            std = torch.tensor(IMAGENET_STD, device=k.device)
            mean = torch.tensor(IMAGENET_MEAN, device=k.device)
            a = (1.0 / (255.0 * std)).repeat(reps)
            b = (-mean / std).repeat(reps)
            norm_bias = torch.einsum("co,c->o", k, b)
            k = k * a[:, None]
        y = torch.matmul(x, k.to(x.dtype))
        if norm_bias is not None:
            y = y + norm_bias.to(y.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y.permute(0, 3, 1, 2).contiguous()


class ConvBN(nn.Module):
    """conv → BatchNorm → ReLU6 (the MobileNet building block); in the
    bn_folded flavour (`bn is None`) the conv carries the folded bias."""

    def __init__(self, conv: nn.Module, channels: int, eps: float,
                 folded: bool = False):
        super().__init__()
        self.conv = conv
        self.bn = None if folded else BatchNorm(channels, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return relu6(y if self.bn is None else self.bn(y))

    def fold_bn_(self) -> None:
        """Fold the BN into the conv in place (infer/folding.py)."""
        if self.bn is not None:
            self.conv.fold_affine_(*self.bn.scale_shift())
            self.bn = None


class DepthwiseSeparable(nn.Module):
    """conv-dw 3x3 + conv-pw 1x1, each with BN (or its folded bias) +
    ReLU6."""

    def __init__(self, in_ch: int, features: int, stride: int, eps: float,
                 folded: bool = False):
        super().__init__()
        self.depthwise = ConvBN(
            Conv2d(in_ch, in_ch, 3, stride, groups=in_ch, bias=folded),
            in_ch, eps, folded)
        self.pointwise = ConvBN(
            Conv2d(in_ch, features, 1, bias=folded), features, eps, folded)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


# (features, stride) per depthwise-separable block; taps mark C2..C5.
_MOBILENET_V1_BLOCKS: Sequence[tuple[int, int]] = (
    (64, 1),
    (128, 2),
    (128, 1),   # -> C2 (stride 4)
    (256, 2),
    (256, 1),   # -> C3 (stride 8)
    (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),  # -> C4 (stride 16)
    (1024, 2),
    (1024, 1),  # -> C5 (stride 32)
)
_TAP_AFTER = {2: "C2", 4: "C3", 10: "C4", 12: "C5"}


class MobileNetV1(nn.Module):
    """Images → {'C2','C3','C4','C5'} NCHW features at strides 4..32."""

    def __init__(self, width: float = 1.0, min_channels: int = 8,
                 max_channels: int = 0,
                 stage_caps: tuple[int, int, int, int] = (0, 0, 0, 0),
                 bn_epsilon: float = 1e-3, bn_folded: bool = False,
                 fold_input_norm: bool = False, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        stem_stride = 4

        def ch(c: int, stride: int) -> int:
            """Width multiplier, the global cap, then the cap of the stage
            at this output stride (stage_caps[0] is stride 4)."""
            out = max(min_channels, _make_divisible(c * width))
            if max_channels:
                out = min(out, max_channels)
            cap = stage_caps[min(stride.bit_length() - 3, 3)]
            return min(out, cap) if cap else out

        stem_ch = ch(32, stem_stride)
        self.stem = ConvBN(
            S4StemConv(in_channels, stem_ch, fold_input_norm, bn_folded),
            stem_ch, bn_epsilon, bn_folded)
        in_ch, stride = stem_ch, stem_stride
        self.block_names = []
        # Channels of the C2..C5 taps, for the FPN's laterals.
        self.out_channels: dict[str, int] = {}
        for i, (c, s) in enumerate(_MOBILENET_V1_BLOCKS):
            if i == 1:
                s = 1  # the stem already took the /4 step
            stride *= s
            out_ch = ch(c, stride)
            self.add_module(f"block_{i}",
                            DepthwiseSeparable(in_ch, out_ch, s, bn_epsilon,
                                               bn_folded))
            self.block_names.append(f"block_{i}")
            if i in _TAP_AFTER:
                self.out_channels[_TAP_AFTER[i]] = out_ch
            in_ch = out_ch

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.stem(x.to(self.dtype))
        features = {}
        for i, name in enumerate(self.block_names):
            x = getattr(self, name)(x)
            tap = _TAP_AFTER.get(i)
            if tap is not None:
                features[tap] = x
        return features
