"""Building blocks shared by the port's models: SAME-padded convolution,
BatchNorm with flax's cast points (inference, and training on batch
statistics), nearest 2x upsampling and seeded initializers.

Tensors are NCHW inside the models. Parameters live in float32 and are
cast to the activation dtype at use, as flax does with `dtype=bfloat16`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multiposenet_tpu_torch.parallel import mesh


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """(before, after) padding of TF/JAX "SAME" for one spatial dim: the
    extra element goes after, so a stride-2 3x3 conv on an even input
    pads (0, 1)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """NCHW conv with SAME padding; weight [O, I/groups, kh, kw] and bias
    are cast to x's dtype."""
    kh, kw = weight.shape[2:]
    top, bottom = same_pad(x.shape[2], kh, stride)
    left, right = same_pad(x.shape[3], kw, stride)
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if top == bottom and left == right:
        return F.conv2d(x, w, b, stride, (top, left), groups=groups)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, b, stride, 0, groups=groups)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of NCHW (one broadcast copy)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(
        b, c, 2 * h, 2 * w)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at ±2 std, rescaled so the
    variance is 1/fan_in."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class Conv2d(nn.Module):
    """SAME-padded conv with float32 parameters: weight [O, I/groups, k, k]
    and an optional bias."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True, bias_init: float = 0.0):
        super().__init__()
        self.stride, self.groups, self.bias_init = stride, groups, bias_init
        self.weight = nn.Parameter(
            torch.zeros(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.constant_(self.bias, self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.weight, self.bias, self.stride,
                           self.groups)

    @torch.no_grad()
    def fold_affine_(self, s: torch.Tensor, shift: torch.Tensor) -> None:
        """Fold a following per-output-channel y*s + shift into the weight
        and a new bias (the conv must have none)."""
        assert self.bias is None, "fold into a conv without a bias"
        self.weight.mul_(s.view(-1, 1, 1, 1))
        self.bias = nn.Parameter(shift.clone())


class BatchNorm(nn.Module):
    """BatchNorm over NCHW channels, computed as flax's nn.BatchNorm does:
    in float32, `(x - mean) * (rsqrt(var + eps) * scale) + bias`, then cast
    back to x's dtype.

    In eval mode mean and var are the running statistics. In training mode
    (`module.train()`) they are the batch's, as flax 0.12's _compute_stats
    with use_fast_variance: over N, H and W in float32 (float64 for
    float64 input), var = max(0,
    E[x²] - E[x]²), the biased variance, with gradients through both; the
    running statistics then move to `momentum * running + (1 - momentum)
    * batch` (flax's momentum, 0.997 in ModelConfig.bn_momentum), the
    variance kept biased. torch's BatchNorm2d would keep the unbiased
    one.

    In a data-parallel process group (`parallel/mesh.py`) the statistics
    are the global batch's, as the JAX step's under a mesh: Σx, Σx² and
    the count are summed over the ranks, with gradients through the sum,
    before mean and var are formed, so every rank moves its running
    statistics alike. torch's SyncBatchNorm would take Welford's variance
    and keep the unbiased one."""

    def __init__(self, channels: int, eps: float = 1e-3,
                 momentum: float = 0.997):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._forward_train(x)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = x.to(torch.float32, copy=True)
        y.sub_(self.running_mean[:, None, None]).mul_(mul[:, None, None])
        return y.add_(self.bias[:, None, None]).to(x.dtype)

    def _forward_train(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if mesh.world_size() > 1:
            c = xf.shape[1]
            sums = mesh.all_reduce_sum(torch.cat([
                xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                xf.new_full((1,), float(xf.numel() // c))]))
            mean = sums[:c] / sums[2 * c]
            var = sums[c:2 * c] / sums[2 * c] - mean * mean
        else:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
        var = torch.maximum(var, var.new_tensor(0.0))  # jnp.maximum's grad
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.detach() * (1.0 - m))
            self.running_var.mul_(m).add_(var.detach() * (1.0 - m))
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias.to(xf.dtype)[:, None, None]).to(x.dtype)

    def scale_shift(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(s, beta - mean*s) with s = gamma / sqrt(var + eps), in float32:
        this BN as the affine y*s + shift that folds into the conv before
        it (infer/folding.py)."""
        s = self.weight / torch.sqrt(self.running_var + self.eps)
        return s, self.bias - self.running_mean * s


def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 6.0)


def reset_all(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialization of every Conv2d (and other module that
    defines `seeded_init`) in registration order; BatchNorm keeps flax's
    init (scale 1, bias 0, mean 0, var 1)."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.reset_parameters(generator)
        elif hasattr(m, "seeded_init"):
            m.seeded_init(generator)
