"""Pose Residual Network, the port of `multiposenet_tpu/models/prn.py`.

[N, K, hw] channel-major crops (flat = j*ch + i, see ops/prn_ops.py) →
one hidden Dense with ReLU, an output Dense, a residual add of the input,
and (unless logits are asked for) a per-channel spatial softmax.
"""

from __future__ import annotations

import torch
from torch import nn

from multiposenet_tpu_torch.models.layers import lecun_normal_


class PRN(nn.Module):

    def __init__(self, crop_height: int = 56, crop_width: int = 36,
                 num_keypoints: int = 17, hidden_units: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_keypoints, self.dtype = num_keypoints, dtype
        self.hw = crop_height * crop_width
        flat = self.hw * num_keypoints
        # Names follow the flax tree's layout-versioned Dense names.
        self.hidden_cm = nn.Linear(flat, hidden_units)
        self.out_cm = nn.Linear(hidden_units, flat)

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in (self.hidden_cm, self.out_cm):
            lecun_normal_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, crops: torch.Tensor,
                return_logits: bool = False) -> torch.Tensor:
        n = crops.shape[0]
        x = crops.to(self.dtype).reshape(n, -1)
        h = torch.relu(nn.functional.linear(
            x, self.hidden_cm.weight.to(self.dtype),
            self.hidden_cm.bias.to(self.dtype)))
        out = nn.functional.linear(h, self.out_cm.weight.to(self.dtype),
                                   self.out_cm.bias.to(self.dtype))
        out = (out + x).reshape(n, self.num_keypoints, self.hw)
        return out if return_logits else torch.softmax(out, dim=-1)
