"""multiposenet_tpu_torch — the PyTorch/CUDA port of multiposenet_tpu.

A second package beside the JAX one, which stays the reference: the same
MobileNet/FPN model, heatmap decode, person detection and PRN assignment,
in PyTorch, with the TPU kernels rewritten by hand for NVIDIA Hopper
(`csrc/`). It imports nothing of JAX or of `multiposenet_tpu`.
"""

from multiposenet_tpu_torch.config import (
    Config,
    DecodeConfig,
    DetectorConfig,
    MeshConfig,
    ModelConfig,
    PRNConfig,
    TrainConfig,
)

__all__ = [
    "Config",
    "ModelConfig",
    "DetectorConfig",
    "PRNConfig",
    "DecodeConfig",
    "TrainConfig",
    "MeshConfig",
]
