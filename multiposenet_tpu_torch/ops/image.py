"""Image preprocessing, the port of `multiposenet_tpu/ops/image.py`.

Host staging (`space_to_depth_flat4`, numpy) turns uint8 [B, H, W, 3]
batches into 4x4 space-to-depth cells laid flat, [B, H/4, (W/4)*48]; on
the device the cells are a free reshape (`s4_flat_to_cells`) or a
normalize pass (`normalize_s4_flat`). `resize_pad_normalize` letterboxes
one image for `Predictor.predict`: an aspect-preserving bilinear resize to
a (target, target) grid with the region beyond the image's extent zeroed.
"""

from __future__ import annotations

import numpy as np
import torch

from multiposenet_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD


def normalize(images: torch.Tensor) -> torch.Tensor:
    """[..., 3] pixels in [0, 255] → ImageNet-normalized float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


def space_to_depth_flat4(images: np.ndarray) -> np.ndarray:
    """Host staging: uint8 [B, H, W, 3] → [B, H/4, (W/4)*48], 4x4 cells in
    the composed channel order (py1, px1, py0, px0, c) with full-res
    offsets dy = 2*py1 + py0, dx = 2*px1 + px0 (the s4 stem's order)."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // 4, 2, 2, w // 4, 2, 2, c)
    x = np.ascontiguousarray(x.transpose(0, 1, 4, 2, 5, 3, 6, 7))
    return x.reshape(b, h // 4, (w // 4) * 16 * c)


def s4_flat_to_cells(flat: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """s4-flat uint8 [B, Hq, Wq*48] → raw-pixel cells [B, Hq, Wq, 48] in
    `dtype` (for fold_input_norm models)."""
    b, hq, wf = flat.shape
    return flat.reshape(b, hq, wf // 48, 48).to(dtype)


def normalize_s4_flat(flat: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """s4-flat uint8 [B, Hq, Wq*48] → normalized cells [B, Hq, Wq, 48]."""
    b, hq, wf = flat.shape
    mean = torch.as_tensor(np.tile(IMAGENET_MEAN, wf // 3),
                           device=flat.device)
    std = torch.as_tensor(np.tile(IMAGENET_STD, wf // 3), device=flat.device)
    x = (flat.float() / 255.0 - mean) / std
    return x.to(dtype).reshape(b, hq, wf // 48, 48)


def _bilinear_sample_2d(img: torch.Tensor, yy: torch.Tensor,
                        xx: torch.Tensor) -> torch.Tensor:
    """Sample img [H, W, C] at the outer product of row coords yy and
    column coords xx (border-clamped bilinear)."""
    h, w = img.shape[0], img.shape[1]
    y0 = torch.floor(yy).clamp(0, h - 1)
    x0 = torch.floor(xx).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (yy - y0).clamp(0.0, 1.0)
    wx = (xx - x0).clamp(0.0, 1.0)
    y0i, y1i, x0i, x1i = (t.long() for t in (y0, y1, x0, x1))
    wx0, wx1 = (1 - wx)[None, :, None], wx[None, :, None]
    top = img[y0i][:, x0i] * wx0 + img[y0i][:, x1i] * wx1
    bot = img[y1i][:, x0i] * wx0 + img[y1i][:, x1i] * wx1
    return top * (1 - wy)[:, None, None] + bot * wy[:, None, None]


def resize_pad_normalize(
    image: torch.Tensor, target_size: int, normalize_out: bool = True
) -> tuple[torch.Tensor, float]:
    """One uint8 [H, W, 3] image → ([target, target, 3] float32, scale).

    The image is sampled bilinearly (half-pixel convention) on the
    aspect-preserving extent round(h*s) x round(w*s), s = target/max(h, w),
    and zeroed beyond it. normalize_out=False returns raw 0-255 pixels
    (fold_input_norm models normalize inside the stem). The scale follows
    the JAX package's float32 arithmetic."""
    h, w = int(image.shape[0]), int(image.shape[1])
    scale = np.float32(target_size) / np.float32(max(h, w))
    out_h = int(np.round(np.float32(h) * scale))
    out_w = int(np.round(np.float32(w) * scale))
    fy = np.float32(h) / np.float32(max(out_h, 1))
    fx = np.float32(w) / np.float32(max(out_w, 1))
    grid = torch.arange(target_size, dtype=torch.float32,
                        device=image.device) + 0.5
    yy = grid * float(fy) - 0.5
    xx = grid * float(fx) - 0.5
    sampled = _bilinear_sample_2d(image.float(), yy, xx)
    idx = torch.arange(target_size, device=image.device)
    mask = (idx[:, None] < out_h) & (idx[None, :] < out_w)
    sampled = torch.where(mask[..., None], sampled,
                          torch.zeros((), device=image.device))
    return (normalize(sampled) if normalize_out else sampled), float(scale)
