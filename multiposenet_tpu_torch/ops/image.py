"""Image preprocessing, the port of `multiposenet_tpu/ops/image.py`.

Host staging (numpy) turns uint8 [B, H, W, 3] batches into space-to-depth
cells laid flat: 2x2 cells [B, H/2, (W/2)*12] for the stride-2 stem
(`space_to_depth_flat`), 4x4 cells [B, H/4, (W/4)*48] for the stride-4
one (`space_to_depth_flat4`, or its transpose `space_to_depth_flat4_t`).
On the device the cells are a free reshape (`s2d_flat_to_cells`,
`s4_flat_to_cells`) or a normalize pass (`normalize_s2d_flat`,
`normalize_s4_flat`). Batches of any other fixed staging size are
resized to the model's size by two constant-matrix products
(`resize_normalize_batch`). `resize_pad_normalize` letterboxes
one image for `Predictor.predict`: an aspect-preserving bilinear resize to
a (target, target) grid with the region beyond the image's extent zeroed.

The normalization is the arithmetic of the JAX package's compiled
programs, not of its source: XLA turns `(x / 255 - mean) / std` into
`fma(x, f32(1/255), -mean) * f32(1/std)`, one rounding for the
multiply-add. Here the multiply-add runs in float64 (the product of two
float32 values is exact there) and is rounded once to float32; uint8
input gathers from a 256x3 table built that way, so the card needs no
float64 pass for it. `resize_normalize_batch`'s `(x - mean) / std`
compiles to `(x - mean) * f32(1/std)`. The letterbox of
`resize_pad_normalize` takes the fused multiply-adds of its compiled
program too (`_fma`, the same float64 device).
"""

from __future__ import annotations

import numpy as np
import torch

from multiposenet_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD


_INV_255 = np.float32(1.0) / np.float32(255.0)
_INV_STD = (np.float32(1.0) / IMAGENET_STD).astype(np.float32)
_TABLES: dict[str, torch.Tensor] = {}


def _normalize_np(x: np.ndarray) -> np.ndarray:
    """float64 pixels [..., 3] → normalized float32, one rounding for
    `x * f32(1/255) - mean`, then the float32 multiply by f32(1/std)."""
    t = x * np.float64(_INV_255) - IMAGENET_MEAN.astype(np.float64)
    return t.astype(np.float32) * _INV_STD


def normalize_table(device: torch.device) -> torch.Tensor:
    """float32 [256, 3]: every uint8 value of every channel normalized
    (built once a device)."""
    key = str(torch.device(device))
    if key not in _TABLES:
        v = np.arange(256, dtype=np.float64)[:, None]
        _TABLES[key] = torch.as_tensor(_normalize_np(v), device=device)
    return _TABLES[key]


def normalize(images: torch.Tensor) -> torch.Tensor:
    """[..., 3] pixels in [0, 255] → ImageNet-normalized float32 (any last
    dim that interleaves R, G, B, as the flat layouts do)."""
    chan = torch.arange(images.shape[-1], device=images.device) % 3
    if images.dtype == torch.uint8:
        return normalize_table(images.device)[images.long(), chan]
    mean = torch.as_tensor(IMAGENET_MEAN.astype(np.float64),
                           device=images.device)[chan]
    inv_std = torch.as_tensor(_INV_STD, device=images.device)[chan]
    t = images.float().double() * float(_INV_255) - mean
    return t.float() * inv_std


def space_to_depth_flat(images: np.ndarray) -> np.ndarray:
    """Host staging: uint8 [B, H, W, 3] → [B, H/2, (W/2)*12], 2x2 cells in
    the channel order (py, px, c) of the stride-2 stem's cells."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // 2, 2, w // 2, 2, c)
    x = np.ascontiguousarray(x.transpose(0, 1, 3, 2, 4, 5))
    return x.reshape(b, h // 2, (w // 2) * 4 * c)


def space_to_depth_flat4(images: np.ndarray) -> np.ndarray:
    """Host staging: uint8 [B, H, W, 3] → [B, H/4, (W/4)*48], 4x4 cells in
    the composed channel order (py1, px1, py0, px0, c) with full-res
    offsets dy = 2*py1 + py0, dx = 2*px1 + px0 (the s4 stem's order)."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // 4, 2, 2, w // 4, 2, 2, c)
    x = np.ascontiguousarray(x.transpose(0, 1, 4, 2, 5, 3, 6, 7))
    return x.reshape(b, h // 4, (w // 4) * 16 * c)


def space_to_depth_flat4_t(images: np.ndarray) -> np.ndarray:
    """Host staging: uint8 [B, H, W, 3] → [B, (W/4)*48, H/4], the s4-flat
    layout with its two minor dims swapped (`batch_forward` tells it by
    its shape: shape[1] == shape[2] * 48)."""
    return np.ascontiguousarray(
        space_to_depth_flat4(images).transpose(0, 2, 1))


def s2d_flat_to_cells(flat: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """s2d-flat uint8 [B, Hh, Wh*12] → raw-pixel cells [B, Hh, Wh, 12] in
    `dtype` (for fold_input_norm models)."""
    b, hh, wf = flat.shape
    return flat.reshape(b, hh, wf // 12, 12).to(dtype)


def normalize_s2d_flat(flat: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """s2d-flat uint8 [B, Hh, Wh*12] → normalized cells [B, Hh, Wh, 12]."""
    b, hh, wf = flat.shape
    x = normalize(flat)
    return x.to(dtype).reshape(b, hh, wf // 12, 12)


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
    x = normalize(flat)
    return x.to(dtype).reshape(b, hq, wf // 48, 48)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return (a.double() * b + c.double()).float()


def _bilinear_sample_2d(img: torch.Tensor, yy: torch.Tensor,
                        xx: torch.Tensor) -> torch.Tensor:
    """Sample img [H, W, C] at the outer product of row coords yy and
    column coords xx (border-clamped bilinear), with the fused
    multiply-adds XLA's compiled letterbox uses: each blend is
    fma(near, 1 - w, far * w)."""
    h, w = img.shape[0], img.shape[1]
    y0 = torch.floor(yy).clamp(0, h - 1)
    x0 = torch.floor(xx).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (yy - y0).clamp(0.0, 1.0)
    wx = (xx - x0).clamp(0.0, 1.0)
    y0i, y1i, x0i, x1i = (t.long() for t in (y0, y1, x0, x1))
    wx0, wx1 = (1 - wx)[None, :, None], wx[None, :, None]
    top = _fma(img[y0i][:, x0i], wx0.double(), img[y0i][:, x1i] * wx1)
    bot = _fma(img[y1i][:, x0i], wx0.double(), img[y1i][:, x1i] * wx1)
    return _fma(top, (1 - wy)[:, None, None].double(),
                bot * wy[:, None, None])


def resize_pad_normalize(
    image: torch.Tensor, target_size: int, normalize_out: bool = True
) -> tuple[torch.Tensor, float]:
    """One uint8 [H, W, 3] image → ([target, target, 3] float32, scale).

    The image is sampled bilinearly (half-pixel convention) on the
    aspect-preserving extent round(h*s) x round(w*s), s = target/max(h, w),
    and zeroed beyond it. normalize_out=False returns raw 0-255 pixels
    (fold_input_norm models normalize inside the stem). The scale follows
    the JAX package's float32 arithmetic, and the sampling its compiled
    arithmetic: grid coordinates fma(i + 0.5, f, -0.5) and fused blends,
    bit for bit with `jax.jit` on the CPU."""
    h, w = int(image.shape[0]), int(image.shape[1])
    scale = np.float32(target_size) / np.float32(max(h, w))
    out_h = int(np.round(np.float32(h) * scale))
    out_w = int(np.round(np.float32(w) * scale))
    fy = np.float32(h) / np.float32(max(out_h, 1))
    fx = np.float32(w) / np.float32(max(out_w, 1))
    grid = torch.arange(target_size, dtype=torch.float32,
                        device=image.device) + 0.5
    half = torch.full_like(grid, -0.5)
    yy = _fma(grid, float(fy), half)
    xx = _fma(grid, float(fx), half)
    sampled = _bilinear_sample_2d(image.float(), yy, xx)
    idx = torch.arange(target_size, device=image.device)
    mask = (idx[:, None] < out_h) & (idx[None, :] < out_w)
    sampled = torch.where(mask[..., None], sampled,
                          torch.zeros((), device=image.device))
    return (normalize(sampled) if normalize_out else sampled), float(scale)


def _resize_matrix(out_size: int, in_size: int) -> np.ndarray:
    """[out, in] bilinear interpolation matrix, half-pixel convention,
    border-clamped (the JAX package's, computed in float64 and stored in
    float32)."""
    i = np.arange(out_size, dtype=np.float64)
    coords = (i + 0.5) * (in_size / out_size) - 0.5
    lo = np.floor(coords)
    frac = coords - lo
    lo0 = np.clip(lo, 0, in_size - 1).astype(np.int64)
    lo1 = np.clip(lo + 1, 0, in_size - 1).astype(np.int64)
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), lo0] += (1.0 - frac).astype(np.float32)
    m[np.arange(out_size), lo1] += frac.astype(np.float32)
    return m


def resize_normalize_batch(
    images: torch.Tensor, target_size: int,
    dtype: torch.dtype = torch.float32, normalize_out: bool = True,
) -> torch.Tensor:
    """uint8 [B, Hs, Ws, 3] staging batch → [B, target, target, 3] in
    `dtype`: bilinear resize as two constant-matrix products (rows, then
    columns), then the ImageNet normalize unless normalize_out is False.
    The host letterboxes to the staging size; the scale per image is the
    caller's."""
    b, hs, ws, c = images.shape
    ry = torch.as_tensor(_resize_matrix(target_size, hs),
                         device=images.device).to(dtype)
    rx = torch.as_tensor(_resize_matrix(target_size, ws),
                         device=images.device).to(dtype)
    x = images.to(dtype)
    # rows[b, i, w, c] = sum_h ry[i, h] x[b, h, w, c]
    x = torch.einsum("ih,bhwc->biwc", ry, x)
    x = torch.einsum("jw,biwc->bijc", rx, x)
    if not normalize_out:
        return x
    mean = torch.as_tensor(IMAGENET_MEAN * 255.0, device=x.device).to(dtype)
    if dtype != torch.float32:
        std = torch.as_tensor(IMAGENET_STD * 255.0,
                              device=x.device).to(dtype)
        return (x - mean) / std
    inv_std = np.float32(1.0) / (IMAGENET_STD * 255.0).astype(np.float32)
    return (x - mean) * torch.as_tensor(inv_std, device=x.device)
