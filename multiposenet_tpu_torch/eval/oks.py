"""Pure-NumPy COCO keypoint evaluation (OKS AP) — pycocotools equivalent.
The port's own copy of `multiposenet_tpu/eval/oks.py`: the same operations
in the same order, so the stats come out bit for bit
(tests/test_torch_eval.py holds them against the JAX package's).

Reference counterpart: `COCOeval(iouType='keypoints')` driven by the eval
notebook (SURVEY.md §2 "COCO eval" row, §3.5). pycocotools is NOT installed
in this environment (verified, SURVEY.md §7), so this module reimplements the
published COCO keypoint evaluation protocol from its specification:

  * OKS(dt, gt) = mean over labeled gt keypoints of
        exp( -d_i^2 / (2 * s^2 * k_i^2) ),
    with k_i = 2 * sigma_i (constants.OKS_SIGMAS), s^2 = gt area.
    GTs with NO labeled keypoints (typical for crowd regions) fall back to
    pycocotools' expanded-bbox distance: d_i is how far the detection
    keypoint lies outside the gt box grown by its own width/height on each
    side — this is what lets keypoint-less crowds absorb detections.
  * Greedy matching per image: detections sorted by score; each detection
    takes the not-yet-taken GT with the highest OKS >= the threshold
    (equal OKS: later GT index wins, matching pycocotools' replace-on->=
    scan). Non-ignored GTs are preferred over ignored ones; crowd GTs can
    absorb any number of detections; detections matched only to ignored
    GTs are excluded from scoring.
  * Unmatched detections whose own area (keypoint extent, as computed by
    pycocotools' loadRes) falls outside the evaluated area range are
    ignored rather than counted as false positives.
  * Precision/recall accumulated over OKS thresholds 0.50:0.05:0.95,
    area ranges (all / medium / large), maxDets=20; AP is the mean of
    precision interpolated at 101 recall points.

Matches pycocotools' documented behavior; validated against hand-computed
cases in tests/test_oks.py (the JAX package's copy). All O(D*G*17) work is vectorized NumPy; the only
Python loop left is the greedy scan over <=maxDets detections per image.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from multiposenet_tpu_torch.utils.constants import NUM_KEYPOINTS, OKS_SIGMAS

OKS_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)
# pycocotools' exact areaRng values: bounds are INCLUSIVE on both ends
# (its tests are `area < a0 or area > a1`), and the upper limit is 1e10,
# not inf — an area of exactly 96^2 belongs to BOTH medium and large.
AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = 20


@dataclasses.dataclass
class GroundTruth:
    """One GT person: keypoints[17, 3] (x, y, v), area, iscrowd.

    `bbox` is (x, y, w, h) in pixels; it is only consulted when the GT has
    no labeled keypoints (pycocotools' expanded-bbox OKS branch). Without it
    such GTs score 0 against everything, exactly like a gt record lacking a
    bbox would in pycocotools.
    """

    keypoints: np.ndarray
    area: float
    iscrowd: bool = False
    bbox: np.ndarray | None = None


@dataclasses.dataclass
class DetectionKP:
    """One detected person: keypoints[17, 3] (x, y, score), score.

    `area` defaults to the keypoint-extent area — the same quantity
    pycocotools' loadRes computes for keypoint result files — and is used
    to ignore unmatched detections outside the evaluated area range.
    """

    keypoints: np.ndarray
    score: float
    area: float | None = None


def _dt_area(dt: DetectionKP) -> float:
    if dt.area is not None:
        return float(dt.area)
    x = dt.keypoints[:, 0]
    y = dt.keypoints[:, 1]
    return float((x.max() - x.min()) * (y.max() - y.min()))


def _oks_matrix(
    dts: Sequence[DetectionKP], gts: Sequence[GroundTruth]
) -> np.ndarray:
    """OKS for every detection/GT pair → [D, G]."""
    d_count, g_count = len(dts), len(gts)
    if d_count == 0 or g_count == 0:
        return np.zeros((d_count, g_count))
    dt = np.stack([d.keypoints for d in dts]).astype(np.float64)  # [D,17,3]
    gt = np.stack([g.keypoints for g in gts]).astype(np.float64)  # [G,17,3]
    areas = np.array([max(g.area, 1e-9) for g in gts])            # [G]
    k2 = (2.0 * OKS_SIGMAS) ** 2                                  # [17]

    labeled = gt[:, :, 2] > 0                                     # [G,17]
    n_labeled = labeled.sum(axis=1)                               # [G]
    dx = dt[:, None, :, 0] - gt[None, :, :, 0]                    # [D,G,17]
    dy = dt[:, None, :, 1] - gt[None, :, :, 1]
    e = (dx**2 + dy**2) / (2.0 * areas[None, :, None] * k2)
    oks = (
        (np.exp(-e) * labeled[None]).sum(axis=2)
        / np.maximum(n_labeled[None], 1)
    )                                                             # [D,G]

    # pycocotools branch for GTs with zero labeled keypoints: measure each
    # detection keypoint's distance OUTSIDE the gt bbox expanded by its own
    # width/height on every side.
    for gi in np.flatnonzero(n_labeled == 0):
        bb = gts[gi].bbox
        if bb is None:
            oks[:, gi] = 0.0
            continue
        x0, x1 = bb[0] - bb[2], bb[0] + 2.0 * bb[2]
        y0, y1 = bb[1] - bb[3], bb[1] + 2.0 * bb[3]
        dxz = np.clip(x0 - dt[:, :, 0], 0, None) + np.clip(
            dt[:, :, 0] - x1, 0, None
        )
        dyz = np.clip(y0 - dt[:, :, 1], 0, None) + np.clip(
            dt[:, :, 1] - y1, 0, None
        )
        ez = (dxz**2 + dyz**2) / (2.0 * areas[gi] * k2[None, :])
        oks[:, gi] = np.exp(-ez).mean(axis=1)
    return oks


def compute_oks(dt_keypoints: np.ndarray, gt: GroundTruth) -> float:
    """OKS between one detection and one GT."""
    return float(
        _oks_matrix([DetectionKP(dt_keypoints, 0.0)], [gt])[0, 0]
    )


def _evaluate_image(
    dts: Sequence[DetectionKP],
    gts: Sequence[GroundTruth],
    area_range: tuple[float, float],
    max_dets: int,
    oks_full: np.ndarray | None = None,
):
    """Greedy OKS matching for one image over all thresholds at once.

    Returns (dt_scores[D], dt_matched[T, D], dt_ignore[T, D],
    num_gt_not_ignored). GTs are 'ignored' if crowd, unlabeled, or outside
    the area range; detections matched only to ignored GTs — or unmatched
    with their own area outside the range — are excluded from scoring
    (pycocotools semantics).
    """
    order = np.argsort([-d.score for d in dts], kind="stable")[:max_dets]
    dts = [dts[i] for i in order]

    gt_ignore = np.array([
        g.iscrowd
        or not (g.keypoints[:, 2] > 0).any()
        or g.area < area_range[0] or g.area > area_range[1]
        for g in gts
    ], dtype=bool)
    # Evaluate non-ignored GTs first in the greedy scan.
    gt_order = np.argsort(gt_ignore, kind="stable")
    gts = [gts[i] for i in gt_order]
    gt_ignore = gt_ignore[gt_order]
    gt_crowd = np.array([g.iscrowd for g in gts], dtype=bool)

    # The OKS matrix is area-range independent; callers evaluating several
    # ranges pass the precomputed full matrix (original dt/gt order).
    if oks_full is None:
        oks = _oks_matrix(dts, gts)
    else:
        oks = oks_full[np.ix_(order, gt_order)]
    t_count = len(OKS_THRESHOLDS)
    d_count = len(dts)
    g_count = len(gts)
    dt_matched = np.zeros((t_count, d_count), dtype=bool)
    dt_ignore = np.zeros((t_count, d_count), dtype=bool)

    thr = OKS_THRESHOLDS[:, None]                    # [T, 1]
    t_idx = np.arange(t_count)
    gt_taken = np.zeros((t_count, g_count), dtype=bool)

    def last_argmax(vals):
        """Per-row argmax; ties pick the LAST index (pycocotools' >= scan).
        Rows that are all -inf return -1."""
        mx = vals.max(axis=1)
        last = (
            vals.shape[1] - 1
            - np.argmax(vals[:, ::-1] == mx[:, None], axis=1)
        )
        return np.where(np.isfinite(mx), last, -1), mx

    for di in range(d_count if g_count else 0):
        avail = ~gt_taken | gt_crowd[None]
        vals = np.where(avail & (oks[di][None] >= thr), oks[di][None],
                        -np.inf)                     # [T, G]
        real_best, real_mx = last_argmax(
            np.where(~gt_ignore[None], vals, -np.inf)
        )
        ign_best, ign_mx = last_argmax(
            np.where(gt_ignore[None], vals, -np.inf)
        )
        # Prefer any qualifying non-ignored GT over ignored ones.
        best = np.where(real_best >= 0, real_best, ign_best)
        hit = best >= 0
        chosen = np.where(hit, best, 0)
        gt_taken[t_idx[hit], chosen[hit]] = True
        dt_matched[:, di] = hit
        dt_ignore[:, di] = hit & gt_ignore[chosen]

    # Unmatched detections outside the area range are ignored, not FPs.
    if d_count:
        dt_areas = np.array([_dt_area(d) for d in dts])
        outside = (dt_areas < area_range[0]) | (dt_areas > area_range[1])
        dt_ignore |= ~dt_matched & outside[None]

    dt_scores = np.array([d.score for d in dts])
    num_gt = int((~gt_ignore).sum())
    return dt_scores, dt_matched, dt_ignore, num_gt


def _accumulate(per_image: list) -> tuple[np.ndarray, np.ndarray]:
    """Combine per-image match results → (precision[T, R], recall[T])."""
    t_count = len(OKS_THRESHOLDS)
    scores = np.concatenate([r[0] for r in per_image]) if per_image else (
        np.zeros(0)
    )
    matched = (
        np.concatenate([r[1] for r in per_image], axis=1)
        if per_image else np.zeros((t_count, 0), bool)
    )
    ignored = (
        np.concatenate([r[2] for r in per_image], axis=1)
        if per_image else np.zeros((t_count, 0), bool)
    )
    num_gt = sum(r[3] for r in per_image)

    precision = -np.ones((t_count, len(RECALL_THRESHOLDS)))
    recall = -np.ones(t_count)
    if num_gt == 0:
        return precision, recall

    order = np.argsort(-scores, kind="mergesort")
    matched = matched[:, order]
    ignored = ignored[:, order]

    for ti in range(t_count):
        keep = ~ignored[ti]
        tp = np.cumsum(matched[ti][keep])
        fp = np.cumsum(~matched[ti][keep])
        if len(tp) == 0:
            recall[ti] = 0.0
            precision[ti] = 0.0
            continue
        rc = tp / num_gt
        pr = tp / np.maximum(tp + fp, 1e-12)
        recall[ti] = rc[-1]
        # Monotone-decreasing envelope, then 101-point interpolation.
        pr = np.maximum.accumulate(pr[::-1])[::-1]
        idx = np.searchsorted(rc, RECALL_THRESHOLDS, side="left")
        p = np.zeros(len(RECALL_THRESHOLDS))
        valid = idx < len(pr)
        p[valid] = pr[idx[valid]]
        precision[ti] = p
    return precision, recall


class KeypointEvaluator:
    """End-to-end OKS AP evaluation over a dataset.

    Usage:
        ev = KeypointEvaluator()
        ev.add_image(gts=[GroundTruth(...)], dts=[DetectionKP(...)])
        stats = ev.summarize()   # {"AP": ..., "AP50": ..., ...}
    """

    def __init__(self, max_dets: int = MAX_DETS):
        self.max_dets = max_dets
        self._images: list[tuple[list, list]] = []

    def add_image(
        self, gts: Sequence[GroundTruth], dts: Sequence[DetectionKP]
    ) -> None:
        self._images.append((list(gts), list(dts)))

    def summarize(self) -> dict[str, float]:
        stats: dict[str, float] = {}
        oks_cache = [
            _oks_matrix(dts, gts) for gts, dts in self._images
        ]
        for area_name, rng in AREA_RANGES.items():
            per_image = [
                _evaluate_image(dts, gts, rng, self.max_dets,
                                oks_full=oks_cache[i])
                for i, (gts, dts) in enumerate(self._images)
            ]
            precision, recall = _accumulate(per_image)

            def mean_valid(x):
                x = x[x > -1]
                return float(x.mean()) if x.size else -1.0

            if area_name == "all":
                stats["AP"] = mean_valid(precision)
                stats["AP50"] = mean_valid(
                    precision[OKS_THRESHOLDS == 0.5]
                )
                stats["AP75"] = mean_valid(
                    precision[OKS_THRESHOLDS == 0.75]
                )
                stats["AR"] = mean_valid(recall)
                stats["AR50"] = mean_valid(recall[OKS_THRESHOLDS == 0.5])
            else:
                suffix = "M" if area_name == "medium" else "L"
                stats[f"AP{suffix}"] = mean_valid(precision)
                stats[f"AR{suffix}"] = mean_valid(recall)
        return stats
