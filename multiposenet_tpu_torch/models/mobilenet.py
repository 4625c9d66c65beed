"""MobileNet-v1-style depthwise-separable backbone, the port of
`multiposenet_tpu/models/mobilenet.py`: the 3x3/s2 stem of the defaults
(over 2x2 space-to-depth cells) or the 4x4/s4 matmul stem of
Config.fast() (`stem_stride=4`, over 4x4 cells), each with its plain
strided-conv fallback for odd sizes, with BN or in its `bn_folded`
inference flavour (conv with a bias, no BN).

Inputs are NHWC (raw pixels [B, H, W, 3], 2x2 space-to-depth cells
[B, H/2, W/2, 12] or 4x4 cells [B, H/4, W/4, 48]); features come out
NCHW. Module and parameter names
follow the flax tree (`stem`, `block_<i>`, `depthwise`/`pointwise`,
`conv`/`bn`) so `weights.py` maps one onto the other by name; a folded
block has `conv.bias` and no `bn`, as the folded flax tree has.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multiposenet_tpu_torch.models.layers import (
    BatchNorm, Conv2d, conv2d_same, lecun_normal_, relu6,
)
from multiposenet_tpu_torch.ops.image import normalize
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


def stem_kernel_to_s2d(kernel: torch.Tensor) -> torch.Tensor:
    """Remap a [3, 3, C, O] stride-2 SAME stem kernel to the [2, 2, 4C, O]
    kernel over 2x2 space-to-depth cells: tap (dy, dx) lives at cell
    (dy//2, dx//2), phase channel ((dy%2)*2 + dx%2)*C + c; the (1, 1)
    phase of cell (1, 1) stays zero."""
    c, o = kernel.shape[2], kernel.shape[3]
    out = kernel.new_zeros(2, 2, 4 * c, o)
    for dy in range(3):
        for dx in range(3):
            gy, py = divmod(dy, 2)
            gx, px = divmod(dx, 2)
            ph = py * 2 + px
            out[gy, gx, ph * c:(ph + 1) * c] = kernel[dy, dx]
    return out


def _norm_affine(reps: int, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (scale, offset) of (x/255 - mean)/std over `reps`
    repeats of the RGB channels."""
    std = torch.tensor(IMAGENET_STD, device=device)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    return (1.0 / (255.0 * std)).repeat(reps), (-mean / std).repeat(reps)


class StemConv(nn.Module):
    """The backbone's stem conv, its kernel kept as flax holds it ([3, 3,
    C, O] at stride 2, [4, 4, C, O] at stride 4) and remapped at forward
    time, as the JAX package's `ConvBNRelu6` picks:

    * stride 4 on 4x4 cells (48 channels), 2x2 cells (12) with even sides
      or raw pixels with sides divisible by 4: one matmul over the 4x4
      cells (`stem_kernel_to_s4`);
    * stride 2 (with `s2d`) on raw pixels with even sides or 2x2 cells
      with an even cell grid: a 2x2/s1 conv over the cells
      (`stem_kernel_to_s2d`), SAME's one trailing zero row and column at
      stride 2 being one trailing zero cell;
    * elsewhere (odd sizes, or `s2d` off): the plain k x k strided conv
      with SAME padding (bottom/right first, `layers.same_pad`).

    With fold_norm the (x/255 - mean)/std affine is composed into the
    kernel in f32 on the matmul and cell paths; the plain conv applies it
    to the pixels explicitly. With a bias (the bn_folded flavour) the
    fold-norm bias and then this bias are added, each rounded to the
    compute dtype, as the JAX package does: one merged bias would round
    differently in bf16."""

    def __init__(self, in_ch: int, features: int, stride: int,
                 fold_norm: bool, bias: bool = False, s2d: bool = True):
        super().__init__()
        assert stride in (2, 4), stride
        self.stride, self.fold_norm, self.s2d = stride, fold_norm, s2d
        k = 4 if stride == 4 else 3
        self.kernel = nn.Parameter(torch.zeros(k, k, in_ch, features))
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

    def _add_biases(self, y: torch.Tensor, norm_bias: torch.Tensor | None,
                    shape: tuple[int, ...]) -> torch.Tensor:
        if norm_bias is not None:
            y = y + norm_bias.to(y.dtype).view(shape)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(shape)
        return y

    def _matmul_s4(self, cells: torch.Tensor) -> torch.Tensor:
        """4x4 cells [B, H/4, W/4, 16C] → [B, O, H/4, W/4]."""
        k = stem_kernel_to_s4(self.kernel)  # [16C, O] f32
        norm_bias = None
        if self.fold_norm:
            a, b = _norm_affine(k.shape[0] // 3, k.device)
            norm_bias = torch.einsum("co,c->o", k, b)
            k = k * a[:, None]
        y = torch.matmul(cells, k.to(cells.dtype))
        y = self._add_biases(y, norm_bias, (-1,))
        return y.permute(0, 3, 1, 2).contiguous()

    def _conv_s2d(self, cells: torch.Tensor) -> torch.Tensor:
        """2x2 cells [B, H/2, W/2, 4C] → [B, O, H/2, W/2]."""
        k = stem_kernel_to_s2d(self.kernel)  # [2, 2, 4C, O] f32
        norm_bias = None
        if self.fold_norm:
            a, b = _norm_affine(k.shape[2] // 3, k.device)
            norm_bias = torch.einsum("hwco,c->o", k, b)
            k = k * a[None, None, :, None]
        # NCHW in memory, as every later layer runs (a permuted view would
        # carry the channels-last layout through the whole network).
        x = F.pad(cells.permute(0, 3, 1, 2).contiguous(), (0, 1, 0, 1))
        y = F.conv2d(x, k.permute(3, 2, 0, 1).to(cells.dtype))
        return self._add_biases(y, norm_bias, (-1, 1, 1))

    def _conv_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Raw pixels [B, H, W, C] (any size) → [B, O, ceil(H/s),
        ceil(W/s)] by the plain strided SAME conv."""
        if self.fold_norm:
            x = normalize(x).to(x.dtype)
        y = conv2d_same(x.permute(0, 3, 1, 2).contiguous(),
                        self.kernel.permute(3, 2, 0, 1), None, self.stride)
        return self._add_biases(y, None, (-1, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: raw pixels [B, H, W, C<=4], 2x2 cells [B, H/2, W/2, 4C] or
        (stride 4) 4x4 cells [B, H/4, W/4, 16C], already in the compute
        dtype → NCHW features at the stem's stride."""
        c, h, w = x.shape[-1], x.shape[1], x.shape[2]
        if self.stride == 4:
            if c > 16:
                return self._matmul_s4(x)
            if c > 4 and h % 2 == 0 and w % 2 == 0:
                return self._matmul_s4(space_to_depth_2x(x))
            if c <= 4 and h % 4 == 0 and w % 4 == 0:
                return self._matmul_s4(
                    space_to_depth_2x(space_to_depth_2x(x)))
        elif self.s2d and h % 2 == 0 and w % 2 == 0:
            return self._conv_s2d(space_to_depth_2x(x) if c <= 4 else x)
        return self._conv_plain(x)


class ConvBN(nn.Module):
    """conv → BatchNorm → ReLU6 (the MobileNet building block); in the
    bn_folded flavour (`bn is None`) the conv carries the folded bias."""

    def __init__(self, conv: nn.Module, channels: int, eps: float,
                 folded: bool = False, momentum: float = 0.997):
        super().__init__()
        self.conv = conv
        self.bn = None if folded else BatchNorm(channels, eps, momentum)

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
                 folded: bool = False, momentum: float = 0.997):
        super().__init__()
        self.depthwise = ConvBN(
            Conv2d(in_ch, in_ch, 3, stride, groups=in_ch, bias=folded),
            in_ch, eps, folded, momentum)
        self.pointwise = ConvBN(
            Conv2d(in_ch, features, 1, bias=folded), features, eps, folded,
            momentum)

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
                 stem_stride: int = 2, bn_epsilon: float = 1e-3,
                 bn_momentum: float = 0.997, bn_folded: bool = False, s2d_stem: bool = True,
                 fold_input_norm: bool = False, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        assert stem_stride in (2, 4), stem_stride
        self.dtype = dtype

        def ch(c: int, stride: int) -> int:
            """Width multiplier, the global cap, then the cap of the stage
            at this output stride (stage_caps[0] is stride 4; the
            stride-2 stem and block_0 above it are uncapped)."""
            out = max(min_channels, _make_divisible(c * width))
            if max_channels:
                out = min(out, max_channels)
            if stride < 4:
                return out
            cap = stage_caps[min(stride.bit_length() - 3, 3)]
            return min(out, cap) if cap else out

        stem_ch = ch(32, stem_stride)
        self.stem = ConvBN(
            StemConv(in_channels, stem_ch, stem_stride, fold_input_norm,
                     bn_folded, s2d_stem),
            stem_ch, bn_epsilon, bn_folded, bn_momentum)
        in_ch, stride = stem_ch, stem_stride
        self.block_names = []
        # Channels of the C2..C5 taps, for the FPN's laterals.
        self.out_channels: dict[str, int] = {}
        for i, (c, s) in enumerate(_MOBILENET_V1_BLOCKS):
            if stem_stride == 4 and i == 1:
                s = 1  # the stem already took the /4 step
            stride *= s
            out_ch = ch(c, stride)
            self.add_module(f"block_{i}",
                            DepthwiseSeparable(in_ch, out_ch, s, bn_epsilon,
                                               bn_folded, bn_momentum))
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
