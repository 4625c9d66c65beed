"""Keypoint subnet, the port of `multiposenet_tpu/models/keypoint_head.py`
(NCHW).

Per-level towers run at their own strides and are summed coarse to fine,
then the optional 3x3 fuse conv, then one 3x3 output conv emits the 17
heatmap channels and the segmentation channel together. Towers over
P5..P2 (the defaults) leave the sum at stride 4. With `p2_late`
(Config.fast()) the towers stop at P3, the sum stays at stride 8 and
stride 4 sees only an upsample-add onto P2 and the output conv: where the
pyramid carries the raw stride-4 lateral L2 and the widths line up, the
two stride-4 upsample-adds merge into one, `L2 + up(P3 + x)` (exact for
nearest upsampling); elsewhere P2 is added, through a 1x1 `p2_lateral`
when the head is wider or narrower than the FPN. The JAX package writes
two output convs and lets XLA drop the one a program does not read;
eagerly both would run, so here the conv runs once and the channel-major
heatmaps are the first K channels of its output.

With the fused tail (`ModelConfig.kp_tail_pallas`) in eval mode the
merged stride-4 upsample-add and the output conv's first K channels run
as one kernel (`ops/kp_tail.py`, `csrc/kp_tail.cu`) on (L2, P3 + summed),
and only the heatmaps come out: segmentation is not read at inference,
and the 18-channel conv does not also run. As in the JAX package, the
tail is taken only on the merged path, where the heatmap height is a
multiple of the TPU kernel's row tile (16) and the width even; elsewhere
the head keeps its conv.
"""

from __future__ import annotations

import torch
from torch import nn

from multiposenet_tpu_torch.models.layers import Conv2d, upsample2x
from multiposenet_tpu_torch.ops import kp_tail

# The JAX package's tail kernel tiles the heatmap rows by this many
# (kp_tail_pallas.TILE_ROWS) and is taken only where they divide H.
TAIL_TILE_ROWS = 16


class KeypointHead(nn.Module):
    """Pyramid (NCHW: P2..P5 and, on the raw top-down maps, the stride-4
    lateral L2) → {'heatmaps_cm' [B, K, H, W] in the compute dtype,
    'segmentation_cm' [B, 1, H, W]} at stride 4 (the heatmaps only with
    the fused tail in eval mode)."""

    def __init__(self, channels: int, in_channels: int,
                 num_keypoints: int = 17, num_convs: int = 2,
                 with_segmentation: bool = True, p2_late: bool = False,
                 fuse_conv: bool = True, tail_kernel: bool = False):
        super().__init__()
        self.channels, self.num_keypoints = channels, num_keypoints
        self.num_convs, self.tail_kernel = num_convs, tail_kernel
        self.p2_late = p2_late
        self.levels = ("P5", "P4", "P3") + (() if p2_late else ("P2",))
        # Width of the summed towers (the pyramid's, without towers).
        width = channels if num_convs else in_channels
        for level in self.levels:
            for i in range(num_convs):
                self.add_module(
                    f"tower_{level}_conv{i}",
                    Conv2d(in_channels if i == 0 else channels, channels, 3))
        self.fuse = Conv2d(width, channels, 3) if fuse_conv else None
        # The unmerged p2_late entry projects P2 to the head's width.
        self.p2_lateral = (Conv2d(in_channels, channels, 1)
                           if p2_late and in_channels != channels else None)
        # Heatmap channels first, then segmentation (weights.py
        # concatenates the flax tree's heatmaps_* and segmentation_*).
        self.output = Conv2d(channels if fuse_conv else width,
                             num_keypoints + int(with_segmentation), 3)

    def forward(self, pyramid: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        summed = None
        for level in self.levels:
            x = pyramid[level]
            for i in range(self.num_convs):
                x = torch.relu(getattr(self, f"tower_{level}_conv{i}")(x))
            summed = x if summed is None else x + upsample2x(summed)
        x = summed if self.fuse is None else torch.relu(self.fuse(summed))
        k = self.num_keypoints
        if self.p2_late:
            l2 = pyramid.get("L2")
            if (l2 is not None and l2.shape[1] == self.channels
                    and pyramid["P3"].shape[1] == self.channels):
                z8 = pyramid["P3"] + x
                h, w = l2.shape[2:]
                if (self.tail_kernel and not self.training
                        and h % TAIL_TILE_ROWS == 0 and w % 2 == 0):
                    return {"heatmaps_cm": kp_tail.kp_tail_cm(
                        l2, z8, self.output.weight[:k],
                        self.output.bias[:k])}
                x = l2 + upsample2x(z8)
            else:
                p2 = pyramid["P2"]
                if self.p2_lateral is not None:
                    p2 = self.p2_lateral(p2)
                x = p2 + upsample2x(x)
        y = self.output(x)
        out = {"heatmaps_cm": y[:, :k]}
        if y.shape[1] > k:
            out["segmentation_cm"] = y[:, k:]
        return out
