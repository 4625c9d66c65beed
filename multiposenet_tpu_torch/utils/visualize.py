"""Skeleton/heatmap visualization, the port of
`multiposenet_tpu/utils/visualize.py` without cv2: the same colours,
skeleton pairs, score threshold and drawing order, rasterized in NumPy.

Lines of thickness 2 cover the band of half-width 1 around the segment
as cv2 rasterizes it (`_line`), filled circles the pixels within the
radius of the centre, and boxes are four such lines: close to cv2's
drawing but not pixel for pixel (tests/test_torch_cli.py bounds the
difference).
"""

from __future__ import annotations

import numpy as np

from multiposenet_tpu_torch.utils.constants import SKELETON
from multiposenet_tpu_torch.utils.image_io import resize_linear

_COLORS = np.array([
    [230, 60, 60], [60, 180, 75], [60, 120, 230], [240, 160, 30],
    [145, 60, 230], [70, 210, 210], [240, 80, 170], [160, 210, 60],
], dtype=np.uint8)
# How far past its band cv2's rasterization of a thick line reaches, in
# pixels on each axis (fitted against cv2.line at thickness 2).
EDGE_REACH = 0.4


def _window(out: np.ndarray, points, reach: float):
    """The region of `out` within `reach` of the (x, y) points' bounding
    box, and its pixel-centre coordinates (None when it is empty)."""
    h, w = out.shape[:2]
    xs, ys = [p[0] for p in points], [p[1] for p in points]
    r = int(np.ceil(reach))
    x0, x1 = max(min(xs) - r, 0), min(max(xs) + r, w - 1)
    y0, y1 = max(min(ys) - r, 0), min(max(ys) + r, h - 1)
    if x0 > x1 or y0 > y1:
        return None, None, None
    yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
    return out[y0:y1 + 1, x0:x1 + 1], xx, yy


def _disc(out: np.ndarray, c, radius: float, col) -> None:
    """Fill the pixels whose centres lie within `radius` of c (cv2's filled
    circle for the radii drawn here)."""
    region, xx, yy = _window(out, [c], radius)
    if region is not None:
        region[(xx - c[0]) ** 2 + (yy - c[1]) ** 2 <= radius * radius] = col


def _line(out: np.ndarray, pa, pb, col, thickness: int) -> None:
    """cv2's thick line: the band of half-width thickness/2 around the
    segment, which cv2 fills by scanlines with its edges rasterized, so
    it reaches about EDGE_REACH px further on each axis (taken as the
    pixel squares of that half-side that meet the band), and round caps
    of radius thickness/2 at both ends."""
    half = thickness / 2.0
    region, xx, yy = _window(out, [pa, pb], half + 1)
    if region is None:
        return
    (ax, ay), (bx, by) = pa, pb
    dx, dy = float(bx - ax), float(by - ay)
    length = np.hypot(dx, dy)
    mask = np.zeros(xx.shape, bool)
    if length > 0:
        # Separating axes of a pixel square and the band: x, y, the
        # segment's direction u and its normal n.
        ux, uy = dx / length, dy / length
        px, py = xx - (ax + bx) / 2, yy - (ay + by) / 2
        m = EDGE_REACH
        m_rot = m * (abs(ux) + abs(uy))
        mask = ((np.abs(px) <= m + abs(ux) * length / 2 + abs(uy) * half)
                & (np.abs(py) <= m + abs(uy) * length / 2 + abs(ux) * half)
                & (np.abs(px * ux + py * uy) <= length / 2 + m_rot)
                & (np.abs(py * ux - px * uy) <= half + m_rot))
    for ex, ey in (pa, pb):
        mask |= (xx - ex) ** 2 + (yy - ey) ** 2 <= half * half
    region[mask] = col


def draw_skeleton(
    image: np.ndarray,
    keypoints: np.ndarray,
    score_threshold: float = 0.05,
    color: tuple[int, int, int] | None = None,
    radius: int = 3,
) -> np.ndarray:
    """Draw one person's keypoints[17, 3] (x, y, score) on a copy of image."""
    out = np.ascontiguousarray(image.copy())
    col = tuple(int(c) for c in (color or _COLORS[0]))
    ok = keypoints[:, 2] > score_threshold
    for a, b in SKELETON:
        if ok[a] and ok[b]:
            pa = (int(round(keypoints[a, 0])), int(round(keypoints[a, 1])))
            pb = (int(round(keypoints[b, 0])), int(round(keypoints[b, 1])))
            _line(out, pa, pb, col, 2)
    for i in np.flatnonzero(ok):
        c = (int(round(keypoints[i, 0])), int(round(keypoints[i, 1])))
        _disc(out, c, radius, col)
    return out


def draw_predictions(
    image: np.ndarray, people, score_threshold: float = 0.05
) -> np.ndarray:
    """Draw all PersonPredictions (box + skeleton), one color per person."""
    out = np.ascontiguousarray(image.copy())
    for i, person in enumerate(people):
        col = tuple(int(c) for c in _COLORS[i % len(_COLORS)])
        y0, x0, y1, x1 = [int(round(v)) for v in person.box]
        for pa, pb in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)),
                       ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0))):
            _line(out, pa, pb, col, 2)
        out = draw_skeleton(out, person.keypoints, score_threshold, col)
    return out


def heatmap_overlay(
    image: np.ndarray, heatmaps: np.ndarray, alpha: float = 0.5
) -> np.ndarray:
    """Overlay the channel-max heatmap (resized to the image) in red."""
    h, w = image.shape[:2]
    hm = heatmaps.max(axis=-1)
    hm = np.clip(hm / max(hm.max(), 1e-6), 0, 1)
    hm = resize_linear(hm.astype(np.float32), (w, h))
    overlay = image.astype(np.float32).copy()
    overlay[..., 0] = np.clip(
        overlay[..., 0] + alpha * 255.0 * hm, 0, 255
    )
    return overlay.astype(np.uint8)
