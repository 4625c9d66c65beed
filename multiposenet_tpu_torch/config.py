"""Frozen-dataclass configuration, the port's own copy.

Field for field and default for default the same as
`multiposenet_tpu/config.py`
(tests/test_torch_package.py::test_config_matches_jax_package holds the
two equal), so a config serialised by one package loads in the other. The
comments keep only what a field means; speed figures measured on other
hardware do not carry over to this port.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Backbone + FPN + keypoint subnet."""

    num_keypoints: int = 17
    # MobileNet-v1 style depthwise-separable backbone.
    backbone_width: float = 1.0
    min_backbone_channels: int = 8
    # FPN lateral/common width.
    fpn_channels: int = 128
    # Keypoint subnet per-level conv channels.
    head_channels: int = 128
    # Convs per keypoint-subnet level tower.
    kp_head_convs: int = 2
    # Heatmap output stride relative to the input image.
    output_stride: int = 4
    # Emit an auxiliary 1-channel person segmentation output.
    with_segmentation: bool = True
    # BatchNorm hyperparameters (TF convention: eps 1e-3).
    bn_momentum: float = 0.997
    bn_epsilon: float = 1e-3
    # Compute dtype for inference. Parameters always live in float32 and
    # are cast at use.
    compute_dtype: str = "float32"
    # Inference-only: BatchNorm folded into conv kernel+bias.
    bn_folded: bool = False
    # Compute the stride-2 stem as a 2x2 conv over the 2x2
    # space-to-depth input (same arithmetic, same param tree).
    s2d_stem: bool = True
    # Keypoint towers consume the smoothed pyramid (P2..P5) when True, the
    # raw top-down maps (T2..T5) when False, which skips smooth_P2.
    kp_smooth_pyramid: bool = True
    # Stem stride: 2 = the MobileNet-v1 3x3/s2 stem; 4 = a 4x4/s4 stem
    # computed as one dense matmul over 4x4 space-to-depth cells, with
    # block_1's stride dropped so C2..C5 keep their strides.
    stem_stride: int = 2
    # Keypoint towers run at stride 8; stride 4 sees only the final
    # upsample-add + output conv.
    kp_p2_late: bool = False
    # Keep the keypoint head's 3x3 fuse conv.
    kp_fuse_conv: bool = True
    # Cap on backbone channel widths (0 = uncapped).
    backbone_max_channels: int = 0
    # Inference-only: fused stride-4 tail kernel for the channel-major
    # heatmap output (ops/kp_tail.py, csrc/kp_tail.cu).
    kp_tail_pallas: bool = False
    # Per-stage channel caps by output stride (4, 8, 16, 32); 0 = no cap.
    # Applied after backbone_width.
    backbone_stage_caps: tuple[int, int, int, int] = (0, 0, 0, 0)
    # Fold (x/255 - mean)/std into the stem kernel + a bias; the model
    # then consumes raw 0-255 pixels. The stem's zero padding pads
    # raw-black instead of normalized-zero.
    fold_input_norm: bool = False


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """RetinaNet-style single-class person detector head."""

    # FPN levels used for detection anchors (strides 8..128).
    min_level: int = 3
    max_level: int = 7
    num_scales: int = 3
    aspect_ratios: tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_base_scale: float = 4.0
    head_channels: int = 128
    num_convs: int = 4
    # Focal loss.
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    # Box regression loss weight.
    box_loss_weight: float = 50.0
    # Pose-level OKS NMS after the PRN; 0 = off.
    pose_nms_oks: float = 0.0
    # Gaussian soft-NMS sigma; 0 = hard greedy NMS.
    soft_nms_sigma: float = 0.0
    # Box regression loss form: "huber" or "giou".
    box_loss: str = "huber"
    giou_loss_weight: float = 2.0
    # IoU-aware scoring head (changes the param tree when enabled).
    iou_head: bool = False
    iou_loss_weight: float = 1.0
    iou_score_power: float = 1.0
    # Matching thresholds for anchor assignment.
    match_high: float = 0.5
    match_low: float = 0.4
    # Inference-time decoding (fixed shapes).
    pre_nms_top_k: int = 512
    # The JAX package's approximate pre-NMS top-k; the port always takes
    # the exact top-k.
    approx_top_k: bool = True
    # 20 = COCOeval keypoints maxDets.
    max_detections: int = 20
    nms_iou_threshold: float = 0.5
    # Box voting IoU; 0 = plain greedy NMS.
    nms_vote_iou: float = 0.0
    # Pre-NMS score floor.
    score_threshold: float = 0.05


@dataclasses.dataclass(frozen=True)
class PRNConfig:
    """Pose Residual Network: crop the heatmaps inside each person box,
    resize to a fixed grid, one hidden FC with a residual add."""

    # Fixed crop grid.
    crop_height: int = 56
    crop_width: int = 36
    hidden_units: int = 1024
    # Static max persons per image.
    max_persons: int = 32
    # Snap each PRN argmax cell to the nearest decoded peak within this
    # many crop-cell pitches; 0 disables snapping.
    snap_radius_cells: float = 1.0
    # Expand person boxes by this fraction of each side before the crop.
    crop_margin: float = 0.0
    # PRN training-time window jitter.
    window_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Heatmap decoding: Gaussian smoothing → peak NMS → channelwise
    top-k → sub-pixel refinement."""

    # Gaussian smoothing kernel.
    smooth_sigma: float = 1.0
    smooth_kernel_size: int = 7
    # Peak NMS window.
    nms_window: int = 3
    # Per-channel candidate peaks kept.
    max_peaks_per_channel: int = 8
    # Minimum peak score.
    score_threshold: float = 0.2
    # Sub-pixel shift magnitude toward the larger neighbor (¼ px).
    subpixel_shift: float = 0.25


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training harness."""

    image_size: int = 512
    batch_size: int = 64
    num_steps: int = 150_000
    learning_rate: float = 1e-3
    end_learning_rate: float = 1e-5
    warmup_steps: int = 1_000
    weight_decay: float = 1e-5
    ema_decay: float = 0.999
    gradient_clip_norm: float = 10.0
    # Loss weights.
    heatmap_loss_weight: float = 1.0
    segmentation_loss_weight: float = 1.0
    detector_loss_weight: float = 1.0
    # Checkpointing.
    checkpoint_dir: str = "/tmp/multiposenet_tpu/checkpoints"
    save_interval_steps: int = 1_000
    max_to_keep: int = 3
    log_interval_steps: int = 100
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh: a 1-D data-parallel axis."""

    data_axis: str = "data"


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    detector: DetectorConfig = DetectorConfig()
    prn: PRNConfig = PRNConfig()
    decode: DecodeConfig = DecodeConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    @classmethod
    def fast(cls, **overrides: Any) -> "Config":
        """The benchmarked operating point: s4 matmul stem, capped
        backbone at width 0.75, stride-8 keypoint head on the raw
        top-down maps without a fuse conv, 1-conv 64-ch detector towers,
        a 128-candidate pre-NMS pool, a 28x18 PRN crop with hidden 512,
        bf16 compute."""
        cfg = cls(
            model=ModelConfig(compute_dtype="bfloat16", kp_head_convs=1,
                              kp_smooth_pyramid=False, head_channels=64,
                              fpn_channels=64, fold_input_norm=True,
                              kp_p2_late=True, stem_stride=4,
                              backbone_max_channels=256,
                              backbone_width=0.75,
                              backbone_stage_caps=(48, 128, 0, 0),
                              kp_fuse_conv=False),
            detector=DetectorConfig(num_convs=1, head_channels=64,
                                    pre_nms_top_k=128),
            prn=PRNConfig(hidden_units=512, crop_height=28, crop_width=18),
        )
        return dataclasses.replace(cfg, **overrides) if overrides else cfg

    @classmethod
    def crowd(cls, **overrides: Any) -> "Config":
        """Crowded-scene operating point: `fast()` plus GIoU box loss,
        soft-NMS with box voting, a 0.1 PRN crop margin, 12 detection/PRN
        slots and the IoU-aware scoring head."""
        cfg = cls.fast()
        cfg = cfg.replace(
            detector=dataclasses.replace(
                cfg.detector, box_loss="giou", giou_loss_weight=5.0,
                soft_nms_sigma=0.5, nms_vote_iou=0.75,
                max_detections=12,
                iou_head=True, iou_loss_weight=1.0, iou_score_power=2.0),
            prn=dataclasses.replace(
                cfg.prn, crop_margin=0.1, max_persons=12),
        )
        return dataclasses.replace(cfg, **overrides) if overrides else cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        def build(dc_cls, sub):
            fields = {f.name: f for f in dataclasses.fields(dc_cls)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    raise KeyError(f"unknown config key {dc_cls.__name__}.{k}")
                f = fields[k]
                if dataclasses.is_dataclass(f.type) or (
                    isinstance(f.default, tuple) and isinstance(v, list)
                ):
                    v = tuple(v) if isinstance(v, list) else v
                kwargs[k] = v
            return dc_cls(**kwargs)

        return cls(
            model=build(ModelConfig, d.get("model", {})),
            detector=build(DetectorConfig, d.get("detector", {})),
            prn=build(PRNConfig, d.get("prn", {})),
            decode=build(DecodeConfig, d.get("decode", {})),
            train=build(TrainConfig, d.get("train", {})),
            mesh=build(MeshConfig, d.get("mesh", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))
