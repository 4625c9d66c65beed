"""Tests of the port that need an NVIDIA GPU: the hand-written decode
kernel (`csrc/decode_peaks.cu`) against its plain PyTorch version on the
same card, and the inference pipeline on the card against the same
weights on the CPU. Without a GPU every test here skips.

This file imports neither JAX nor the JAX package, so on a machine that
has no JAX it runs without the repository's conftest:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.config import Config, DecodeConfig
from multiposenet_tpu_torch.infer.predictor import Predictor
from multiposenet_tpu_torch.ops import decode
from multiposenet_tpu_torch.ops.image import space_to_depth_flat4

from decode_maps import CONFIGS, MAKERS, planted_maps

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _assert_kernel_equals_plain(x, cfg):
    """Bit-for-bit: both accumulate the blur taps in one order without
    fused multiply-adds. Scores (and -inf fillers) everywhere, positions
    on valid slots."""
    b, k, h, w = x.shape
    kernels.reset_launches()
    got = decode.decode_maps(x, cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {decode.KERNEL: 1}
    want = decode.decode_maps_plain(x.reshape(b * k, h, w), cfg)
    scores, ys, xs = (t.cpu() for t in got)
    w_scores, w_ys, w_xs = (t.cpu() for t in want)
    assert torch.equal(scores, w_scores)
    valid = w_scores > cfg.score_threshold
    assert torch.equal(ys[valid], w_ys[valid])
    assert torch.equal(xs[valid], w_xs[valid])


@pytest.mark.parametrize("kind", sorted(MAKERS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, kind, dtype):
    hm = MAKERS[kind](np.random.RandomState(3), (4, 128, 128, 17))
    x = torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous().to(
        cuda_device, dtype)
    _assert_kernel_equals_plain(x, DecodeConfig(**CONFIGS[kind]))


@pytest.mark.parametrize("shape,peaks,sigma", [
    ((2, 3, 37, 53), 1, 1.0),
    ((1, 5, 9, 130), 16, 1.0),
    ((3, 2, 64, 32), 8, 0.0),
    ((1, 1, 3, 3), 8, 1.0),
])
def test_kernel_odd_shapes(cuda_device, shape, peaks, sigma):
    b, k, h, w = shape
    hm = planted_maps(np.random.RandomState(4), (b, h, w, k))
    x = torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous().to(cuda_device)
    _assert_kernel_equals_plain(
        x, DecodeConfig(max_peaks_per_channel=peaks, smooth_sigma=sigma))


def test_kernel_reads_channel_slice_of_head_output(cuda_device):
    """The keypoint head's heatmaps_cm is the first 17 of 18 channels of
    one conv output: a view whose batch stride is 18*H*W."""
    hm = planted_maps(np.random.RandomState(5), (3, 64, 64, 18))
    full = torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous().to(
        cuda_device, torch.bfloat16)
    x = full[:, :17]
    assert not x.is_contiguous()
    kernels.reset_launches()
    got = decode.decode_maps(x, DecodeConfig())
    want = decode.decode_maps(x.contiguous(), DecodeConfig())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {decode.KERNEL: 2}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["dtype", "strides"])
def test_kernel_wrapper_refuses_on_card(cuda_device, case):
    x = torch.rand(2, 3, 16, 16, device=cuda_device)
    if case == "dtype":
        x, err = x.half(), TypeError
    else:
        x, err = x.permute(0, 1, 3, 2), ValueError
    with pytest.raises(err):
        decode.decode_maps(x, DecodeConfig())


def test_batch_forward_on_card_matches_cpu(cuda_device):
    """A narrow fast()-like model in float32 with TF32 off: the card (with
    the decode kernel) and the CPU (with the plain decode) give the same
    detections and peaks on the same weights. Heatmaps differ in the last
    f32 bits between cuDNN and the CPU, so peaks are compared where both
    are valid and away from ties: positions to a quarter pixel."""
    cfg = Config.fast()
    cfg = cfg.replace(
        model=dataclasses.replace(
            cfg.model, backbone_width=0.25, fpn_channels=32,
            head_channels=32, backbone_stage_caps=(16, 32, 0, 0),
            backbone_max_channels=64, compute_dtype="float32"),
        detector=dataclasses.replace(cfg.detector, score_threshold=0.0,
                                     head_channels=32))
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = Predictor(cfg, image_size=256, device=cuda_device)
        cpu = Predictor(cfg, image_size=256, device="cpu")
        rng = np.random.RandomState(6)
        flat = space_to_depth_flat4(
            rng.randint(0, 256, (4, 256, 256, 3)).astype(np.uint8))
        kernels.reset_launches()
        got = gpu.batch_forward(flat)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == {decode.KERNEL: 1}
        want = cpu.batch_forward(flat)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    got = {k: v.cpu() for k, v in got.items()}
    assert torch.equal(got["box_valid"], want["box_valid"])
    torch.testing.assert_close(got["boxes"], want["boxes"], atol=1e-2,
                               rtol=1e-4)
    both = got["peak_valid"] & want["peak_valid"]
    assert both.sum() >= 0.9 * want["peak_valid"].sum()
    near = (got["peak_positions"] - want["peak_positions"]).abs() <= 1.0
    assert near.all(-1)[both].float().mean() >= 0.9
