"""Assembled MultiPoseNet: backbone + FPN + keypoint and detector heads,
the port of `multiposenet_tpu/models/posenet.py`."""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.models.detector_head import DetectorHead
from multiposenet_tpu_torch.models.fpn import FPN
from multiposenet_tpu_torch.models.keypoint_head import KeypointHead
from multiposenet_tpu_torch.models.layers import reset_all
from multiposenet_tpu_torch.models.mobilenet import MobileNetV1


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float64": torch.float64}[name]


class MultiPoseNet(nn.Module):
    """NHWC images (raw pixels, 2x2 or 4x4 space-to-depth cells) →
    heatmaps + detector outputs, for every ModelConfig the JAX package
    builds.

    In training mode (`model.train()`) BatchNorm normalizes with the
    batch's statistics and updates its running ones, as flax's
    `apply(..., train=True, mutable=["batch_stats"])`; the fused keypoint
    tail is off. Parameters stay float32 and are cast to the compute dtype
    at use (flax's param_dtype float32 with dtype bfloat16).

    Outputs, in the JAX package's layouts: `heatmaps` [B, H, W, K] f32
    (f64 in float64), `heatmaps_cm` [B, K, H, W] in the compute dtype,
    `segmentation` [B, H, W, 1] likewise (not with the fused keypoint tail in eval mode: it
    emits the heatmaps only) and `detector` {P3..P7: {cls, box[, iou]}}
    NHWC."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        m, d = config.model, config.detector
        self.dtype = torch_dtype(m.compute_dtype)
        self.backbone = MobileNetV1(
            width=m.backbone_width, min_channels=m.min_backbone_channels,
            max_channels=m.backbone_max_channels,
            stage_caps=m.backbone_stage_caps, stem_stride=m.stem_stride,
            bn_epsilon=m.bn_epsilon, bn_momentum=m.bn_momentum,
            bn_folded=m.bn_folded,
            s2d_stem=m.s2d_stem, fold_input_norm=m.fold_input_norm,
            dtype=self.dtype,
        )
        # The head reads the raw T2 where it has towers at stride 4 or
        # cannot merge its p2_late upsample-adds through L2.
        merged = m.kp_p2_late and m.head_channels == m.fpn_channels
        self.fpn = FPN(self.backbone.out_channels, m.fpn_channels,
                       smooth_p2=m.kp_smooth_pyramid,
                       emit_t2=not (m.kp_smooth_pyramid or merged))
        self.keypoint_head = KeypointHead(
            m.head_channels, in_channels=m.fpn_channels,
            num_keypoints=m.num_keypoints, num_convs=m.kp_head_convs,
            with_segmentation=m.with_segmentation, p2_late=m.kp_p2_late,
            fuse_conv=m.kp_fuse_conv, tail_kernel=m.kp_tail_pallas,
        )
        self.detector_head = DetectorHead(
            m.fpn_channels, d.min_level, d.max_level,
            d.num_scales * len(d.aspect_ratios), d.head_channels,
            d.num_convs, with_iou=d.iou_head,
        )

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random init with flax's initializers (lecun-normal
        kernels, zero biases, the detector's 0.01 class prior)."""
        reset_all(self, generator)

    def forward(self, images: torch.Tensor) -> dict[str, Any]:
        feats = self.backbone(images)
        pyramid = self.fpn(feats)
        if self.config.model.kp_smooth_pyramid:
            # The smoothed P2..P5, without L2: the merged stride-4
            # upsample-add (P2 == L2 + up(P3)) holds only for the raw maps.
            kp_pyramid = {f"P{i}": pyramid[f"P{i}"] for i in (2, 3, 4, 5)}
        else:
            # The raw top-down maps (the towers' first conv subsumes the
            # smoothing conv), with L2 for the merged p2_late entry.
            kp_pyramid = {f"P{i}": pyramid[f"T{i}"] for i in (2, 3, 4, 5)
                          if f"T{i}" in pyramid}
            kp_pyramid["L2"] = pyramid["L2"]
        out: dict[str, Any] = self.keypoint_head(kp_pyramid)
        out["detector"] = self.detector_head(pyramid)
        # float32 for the losses and the decode; float64 stays float64.
        f32 = torch.promote_types(self.dtype, torch.float32)
        out["heatmaps"] = out["heatmaps_cm"].permute(0, 2, 3, 1).to(f32)
        if "segmentation_cm" in out:
            out["segmentation"] = out.pop("segmentation_cm").permute(
                0, 2, 3, 1).to(f32)
        return out
