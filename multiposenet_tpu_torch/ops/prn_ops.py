"""PRN box-conditional crop-resize and keypoint readout, the port of
`multiposenet_tpu/ops/prn_ops.py`.

Each box's bilinear crop-resize is two interpolation matrices,
R_y [P, ch, H] and R_x [P, cw, W], applied as batched matmuls:
crops[p] = R_y[p] @ heatmap @ R_x[p]^T per channel. Crops are laid out
[..., cw, ch, K] (column, row, channel); the PRN consumes them
channel-major as [N, K, cw*ch] with the column-major flat index
flat = j*ch + i, the order the PRN's Dense weights were trained in.
"""

from __future__ import annotations

import torch


def expand_boxes(boxes: torch.Tensor, margin: float) -> torch.Tensor:
    """Expand (y0, x0, y1, x1) boxes by `margin` × side length per side;
    margin 0 is the identity."""
    if margin == 0.0:
        return boxes
    y0, x0, y1, x1 = boxes.unbind(-1)
    dy = (y1 - y0) * margin
    dx = (x1 - x0) * margin
    return torch.stack([y0 - dy, x0 - dx, y1 + dy, x1 + dx], dim=-1)


def interp_matrix(starts: torch.Tensor, sizes: torch.Tensor, out_size: int,
                  in_size: int) -> torch.Tensor:
    """Bilinear sampling matrices [..., out_size, in_size]: output cell i of
    a crop covering [start, start + size) samples
    c = start + (i + 0.5) * size / out_size - 0.5 with border-clamped
    weights (half-pixel convention)."""
    i = torch.arange(out_size, dtype=torch.float32, device=starts.device)
    coords = (starts[..., None] + (i + 0.5) * sizes[..., None] / out_size
              - 0.5)
    lo = torch.floor(coords)
    frac = coords - lo
    lo0 = lo.clamp(0, in_size - 1).long()
    lo1 = (lo + 1).clamp(0, in_size - 1).long()
    grid = torch.arange(in_size, device=starts.device)
    w0 = (grid == lo0[..., None]) * (1.0 - frac)[..., None]
    w1 = (grid == lo1[..., None]) * frac[..., None]
    return (w0 + w1).float()


def crop_heatmaps_cm(heatmaps_cm: torch.Tensor, boxes: torch.Tensor,
                     crop_height: int, crop_width: int) -> torch.Tensor:
    """Channel-major heatmaps [B, K, H, W] (in the compute dtype) and boxes
    [B, P, 4] in heatmap coords → crops [B, P, cw, ch, K]; the
    x-contraction runs first (the smaller intermediate)."""
    h, w = heatmaps_cm.shape[2:]
    y0, x0, y1, x1 = boxes.unbind(-1)
    ry = interp_matrix(y0, (y1 - y0).clamp(min=1e-3), crop_height, h)
    rx = interp_matrix(x0, (x1 - x0).clamp(min=1e-3), crop_width, w)
    ry, rx = ry.to(heatmaps_cm.dtype), rx.to(heatmaps_cm.dtype)
    cols = torch.einsum("bpjx,bkyx->bpkyj", rx, heatmaps_cm)
    return torch.einsum("bpiy,bpkyj->bpjik", ry, cols)


def to_channel_major(crops: torch.Tensor, num_keypoints: int) -> torch.Tensor:
    """[..., cw, ch, K] crops → [N, K, cw*ch] (flat = j*ch + i)."""
    hw = crops.shape[-3] * crops.shape[-2]
    return crops.reshape(-1, hw, num_keypoints).transpose(1, 2)


def keypoints_from_prn(prn_out: torch.Tensor, crops_km: torch.Tensor,
                       boxes: torch.Tensor, crop_height: int,
                       crop_width: int) -> torch.Tensor:
    """PRN maps (softmax or logits) [P, K, hw] → keypoints [P, K, 3] rows
    (x, y, score) in heatmap coords. The argmax cell (first among ties)
    maps back through the inverse of interp_matrix; the score is the input
    crop's value there."""
    ch, cw = crop_height, crop_width
    idx = torch.argmax(prn_out, dim=-1)                   # [P, K]
    iy = (idx % ch).float()
    ix = (idx // ch).float()
    score = torch.gather(crops_km, -1, idx[..., None])[..., 0].float()
    y0, x0, y1, x1 = boxes.unbind(-1)
    bh = (y1 - y0).clamp(min=1e-3)[:, None]
    bw = (x1 - x0).clamp(min=1e-3)[:, None]
    hy = y0[:, None] + (iy + 0.5) * bh / ch - 0.5
    hx = x0[:, None] + (ix + 0.5) * bw / cw - 0.5
    return torch.stack([hx, hy, score], dim=-1)


def snap_to_peaks(keypoints: torch.Tensor, boxes: torch.Tensor,
                  peak_pos: torch.Tensor, peak_scores: torch.Tensor,
                  peak_valid: torch.Tensor, crop_height: int,
                  crop_width: int, radius_cells: float = 1.0) -> torch.Tensor:
    """Snap each PRN keypoint to the nearest valid decoded peak of its
    channel (first among ties) when it lies within `radius_cells` crop-cell
    pitches of this box (at least half a heatmap pixel), adopting the
    peak's position and score.

    keypoints [B, D, K, 3] (x, y, score); boxes [B, D, 4]; peak_pos
    [B, K, P, 2] (y, x); peak_scores, peak_valid [B, K, P]."""
    cx, cy = keypoints[..., 0], keypoints[..., 1]          # [B, D, K]
    px_all = peak_pos[:, None, :, :, 1]                    # [B, 1, K, P]
    py_all = peak_pos[:, None, :, :, 0]
    d2 = (px_all - cx[..., None]) ** 2 + (py_all - cy[..., None]) ** 2
    d2 = torch.where(peak_valid[:, None], d2, torch.inf)
    best_d2, best = torch.min(d2, dim=-1)                  # [B, D, K]
    bh = (boxes[..., 2] - boxes[..., 0]).clamp(min=1e-3)
    bw = (boxes[..., 3] - boxes[..., 1]).clamp(min=1e-3)
    pitch = torch.maximum(bh / crop_height, bw / crop_width)
    radius = (radius_cells * pitch).clamp(min=0.5)[..., None]  # [B, D, 1]
    ok = torch.isfinite(best_d2) & (best_d2 <= radius ** 2)

    def pick(t: torch.Tensor) -> torch.Tensor:
        return torch.gather(t.expand_as(d2), -1, best[..., None])[..., 0]

    out_x = torch.where(ok, pick(px_all), cx)
    out_y = torch.where(ok, pick(py_all), cy)
    out_s = torch.where(ok, pick(peak_scores[:, None]).to(keypoints.dtype),
                        keypoints[..., 2])
    return torch.stack([out_x, out_y, out_s], dim=-1)
