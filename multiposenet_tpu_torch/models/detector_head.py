"""RetinaNet-style single-class person detection head, the port of
`multiposenet_tpu/models/detector_head.py`.

The class and box towers share their weights across levels. Outputs keep
the JAX package's layout: per level, cls [B, H, W, A], box [B, H, W, 4A]
and, with the IoU-aware scoring head (`with_iou`), iou [B, H, W, A]: an
A-channel 3x3 conv on the box tower's features (NHWC views of the NCHW
conv outputs).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from multiposenet_tpu_torch.models.layers import Conv2d


class DetectorHead(nn.Module):

    def __init__(self, in_channels: int, min_level: int = 3,
                 max_level: int = 7, anchors_per_cell: int = 9,
                 channels: int = 128, num_convs: int = 4,
                 prior_prob: float = 0.01, with_iou: bool = False):
        super().__init__()
        self.min_level, self.max_level = min_level, max_level
        self.num_convs = num_convs
        for kind in ("cls", "box"):
            c_in = in_channels
            for i in range(num_convs):
                self.add_module(f"{kind}_conv{i}", Conv2d(c_in, channels, 3))
                c_in = channels
        self.cls_out = Conv2d(
            channels, anchors_per_cell, 3,
            bias_init=-math.log((1.0 - prior_prob) / prior_prob))
        self.box_out = Conv2d(channels, anchors_per_cell * 4, 3)
        self.iou_out = (Conv2d(channels, anchors_per_cell, 3) if with_iou
                        else None)

    def forward(self, pyramid: dict[str, torch.Tensor]
                ) -> dict[str, dict[str, torch.Tensor]]:
        outputs = {}
        for level in range(self.min_level, self.max_level + 1):
            x = pyramid[f"P{level}"]
            c = b = x
            for i in range(self.num_convs):
                c = torch.relu(getattr(self, f"cls_conv{i}")(c))
                b = torch.relu(getattr(self, f"box_conv{i}")(b))
            out = {"cls": self.cls_out(c).permute(0, 2, 3, 1),
                   "box": self.box_out(b).permute(0, 2, 3, 1)}
            if self.iou_out is not None:
                out["iou"] = self.iou_out(b).permute(0, 2, 3, 1)
            outputs[f"P{level}"] = out
        return outputs
