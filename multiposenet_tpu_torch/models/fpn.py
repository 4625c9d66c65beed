"""Feature Pyramid Network neck, the port of
`multiposenet_tpu/models/fpn.py` (NCHW).

1x1 laterals of C2..C5, nearest top-down upsample-adds (raw maps T2..T5
and the stride-4 lateral L2 for the keypoint head), 3x3 smoothing convs
for P3..P5 and, with `smooth_p2` (`kp_smooth_pyramid`), for P2, and the
detector's P6/P7 as stride-2 SAME convs.

The JAX package emits every map and lets XLA drop what a program does
not read; eagerly each would run, so the stride-4 top-down map T2 is
computed only where it is read: for smooth_P2 or, with `emit_t2`, by a
keypoint head that takes the raw T2 itself.
"""

from __future__ import annotations

import torch
from torch import nn

from multiposenet_tpu_torch.models.layers import Conv2d, upsample2x


class FPN(nn.Module):

    def __init__(self, in_channels: dict[str, int], channels: int = 128,
                 smooth_p2: bool = False, emit_t2: bool = False):
        super().__init__()
        self.smooth_p2, self.emit_t2 = smooth_p2, emit_t2
        for level in ("C2", "C3", "C4", "C5"):
            self.add_module(f"lateral_{level}",
                            Conv2d(in_channels[level], channels, 1))
        names = ("P2", "P3", "P4", "P5") if smooth_p2 else ("P3", "P4", "P5")
        for name in names:
            self.add_module(f"smooth_{name}", Conv2d(channels, channels, 3))
        self.p6 = Conv2d(channels, channels, 3, stride=2)
        self.p7 = Conv2d(channels, channels, 3, stride=2)

    def forward(self, features: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        lat = {level: getattr(self, f"lateral_{level}")(features[level])
               for level in ("C2", "C3", "C4", "C5")}
        p5 = lat["C5"]
        p4 = lat["C4"] + upsample2x(p5)
        p3 = lat["C3"] + upsample2x(p4)
        out = {"T3": p3, "T4": p4, "T5": p5, "L2": lat["C2"]}
        levels = [("P3", p3), ("P4", p4), ("P5", p5)]
        if self.smooth_p2 or self.emit_t2:
            out["T2"] = lat["C2"] + upsample2x(p3)
        if self.smooth_p2:
            levels.insert(0, ("P2", out["T2"]))
        for name, p in levels:
            out[name] = getattr(self, f"smooth_{name}")(p)
        out["P6"] = self.p6(out["P5"])
        out["P7"] = self.p7(torch.relu(out["P6"]))
        return out
