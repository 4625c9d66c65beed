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


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for the options the port does not have:
    it runs the Config.fast() / Config.crowd() architecture (with or
    without folded BN, the fused keypoint tail and the IoU head)."""
    m = cfg.model
    unported = {
        "keypoint towers on the smoothed pyramid (kp_smooth_pyramid)":
            m.kp_smooth_pyramid,
        "the stride-4 keypoint head (kp_p2_late=False)": not m.kp_p2_late,
        "the keypoint head's fuse conv (kp_fuse_conv)": m.kp_fuse_conv,
        "a keypoint head wider or narrower than the FPN "
        "(head_channels != fpn_channels)": m.head_channels != m.fpn_channels,
        "the stride-2 stem (stem_stride=2)": m.stem_stride != 4,
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported")


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class MultiPoseNet(nn.Module):
    """NHWC images (raw pixels or 4x4 cells) → heatmaps + detector outputs.

    Outputs, in the JAX package's layouts: `heatmaps` [B, H, W, K] f32,
    `heatmaps_cm` [B, K, H, W] in the compute dtype, `segmentation`
    [B, H, W, 1] f32 (not with the fused keypoint tail in eval mode: it
    emits the heatmaps only) and `detector` {P3..P7: {cls, box[, iou]}}
    NHWC."""

    def __init__(self, config: Config):
        super().__init__()
        check_supported(config)
        self.config = config
        m, d = config.model, config.detector
        self.dtype = torch_dtype(m.compute_dtype)
        self.backbone = MobileNetV1(
            width=m.backbone_width, min_channels=m.min_backbone_channels,
            max_channels=m.backbone_max_channels,
            stage_caps=m.backbone_stage_caps, bn_epsilon=m.bn_epsilon,
            bn_folded=m.bn_folded, fold_input_norm=m.fold_input_norm,
            dtype=self.dtype,
        )
        self.fpn = FPN(self.backbone.out_channels, m.fpn_channels)
        self.keypoint_head = KeypointHead(
            m.head_channels, num_keypoints=m.num_keypoints,
            num_convs=m.kp_head_convs, with_segmentation=m.with_segmentation,
            tail_kernel=m.kp_tail_pallas,
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
        kp_pyramid = {f"P{i}": pyramid[f"T{i}"] for i in (3, 4, 5)}
        kp_pyramid["L2"] = pyramid["L2"]
        out: dict[str, Any] = self.keypoint_head(kp_pyramid)
        out["detector"] = self.detector_head(pyramid)
        out["heatmaps"] = out["heatmaps_cm"].permute(0, 2, 3, 1).float()
        if "segmentation_cm" in out:
            out["segmentation"] = out.pop("segmentation_cm").permute(
                0, 2, 3, 1).float()
        return out
