"""Keypoint subnet, the port of `multiposenet_tpu/models/keypoint_head.py`
on its `p2_late` path without the fuse conv (Config.fast()).

Per-level towers run at strides 32..8 and are summed coarse to fine; the
stride-4 entry merges the two stride-4 upsample-adds into one,
`L2 + up(P3 + x)` (exact for nearest upsampling), and one 3x3 output conv
emits the 17 heatmap channels and the segmentation channel together, in
NCHW. The JAX package writes two convs and lets XLA drop the one a program
does not read; eagerly both would run, so here the conv runs once and the
channel-major heatmaps are the first K channels of its output.

With the fused tail (`ModelConfig.kp_tail_pallas`) in eval mode the
stride-4 upsample-add and the output conv's first K channels run as one
kernel (`ops/kp_tail.py`, `csrc/kp_tail.cu`) on (L2, P3 + summed), and
only the heatmaps come out: segmentation is not read at inference, and
the 18-channel conv does not also run. As in the JAX package, the tail is
taken where the heatmap height is a multiple of the TPU kernel's row tile
(16) and the width even; elsewhere the head keeps its conv.
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
    """Pyramid (NCHW: towers' inputs P3..P5 and the stride-4 lateral L2)
    → {'heatmaps_cm' [B, K, H, W] in the compute dtype, 'segmentation_cm'
    [B, 1, H, W]} at stride 4 (the heatmaps only with the fused tail in
    eval mode)."""

    def __init__(self, channels: int, num_keypoints: int = 17,
                 num_convs: int = 2, with_segmentation: bool = True,
                 tail_kernel: bool = False):
        super().__init__()
        self.num_keypoints, self.num_convs = num_keypoints, num_convs
        self.tail_kernel = tail_kernel
        for level in ("P5", "P4", "P3"):
            for i in range(num_convs):
                self.add_module(f"tower_{level}_conv{i}",
                                Conv2d(channels, channels, 3))
        # Heatmap channels first, then segmentation (weights.py
        # concatenates the flax tree's heatmaps_* and segmentation_*).
        self.output = Conv2d(channels,
                             num_keypoints + int(with_segmentation), 3)

    def forward(self, pyramid: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        summed = None
        for level in ("P5", "P4", "P3"):
            x = pyramid[level]
            for i in range(self.num_convs):
                x = torch.relu(getattr(self, f"tower_{level}_conv{i}")(x))
            summed = x if summed is None else x + upsample2x(summed)
        l2, z8 = pyramid["L2"], pyramid["P3"] + summed
        k = self.num_keypoints
        h, w = l2.shape[2:]
        if (self.tail_kernel and not self.training
                and h % TAIL_TILE_ROWS == 0 and w % 2 == 0):
            return {"heatmaps_cm": kp_tail.kp_tail_cm(
                l2, z8, self.output.weight[:k], self.output.bias[:k])}
        y = self.output(l2 + upsample2x(z8))
        out = {"heatmaps_cm": y[:, :k]}
        if y.shape[1] > k:
            out["segmentation_cm"] = y[:, k:]
        return out
