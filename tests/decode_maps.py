"""Heatmap test maps shared by the decode tests (numpy only, so the tests
that run on the card import it without JAX)."""

import numpy as np


def random_maps(rng, shape):
    return rng.rand(*shape).astype(np.float32)


def planted_maps(rng, shape):
    """Gaussian bumps of random height on low noise, some near borders."""
    b, h, w, k = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    hm = 0.05 * rng.rand(*shape).astype(np.float32)
    for i in range(b):
        for c in range(k):
            for _ in range(5):
                cy, cx = rng.uniform(-1, h), rng.uniform(-1, w)
                amp, sig = rng.uniform(0.1, 1.0), rng.uniform(1.0, 3.0)
                hm[i, :, :, c] += amp * np.exp(
                    -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
    return hm


def plateau_maps(rng, shape):
    """Values quantised to 256 levels in 2x2 blocks: plateaus and exact
    ties, which only the (value desc, flat asc) order resolves."""
    b, h, w, k = shape
    coarse = rng.randint(0, 256, (b, h // 2, w // 2, k)).astype(np.float32)
    return np.repeat(np.repeat(coarse / 256.0, 2, axis=1), 2, axis=2)


def with_nans(rng, hm, frac=0.01):
    """hm with a seeded `frac` of its elements set to NaN, as a diverged
    model's heatmaps hold them."""
    hm = hm.copy()
    hm[rng.rand(*hm.shape) < frac] = np.nan
    return hm


def straddle_maps(rng, shape, rows, cols):
    """[B, H, W, K] low noise under plateaus of one value that straddle
    each row boundary in `rows` and each column boundary in `cols` (the
    generic kernel's tile edges), a higher plateau wholly inside the
    last tile, and a column of equal values across a row boundary: exact
    ties across tiles that only the (value desc, flat asc) order resolves.
    Decode them without the blur (smooth_sigma=0) so the ties stay exact."""
    b, h, w, k = shape
    hm = 0.25 * rng.rand(*shape).astype(np.float32)
    for r in rows:
        hm[:, max(r - 2, 0):r + 2, 3:9] = 0.75
    for c in cols:
        hm[:, 1:4, max(c - 3, 0):c + 3] = 0.75
        hm[:, h - 3:h - 1, max(c - 2, 0):c + 2] = 0.625
    hm[:, h - 2:h, w - 2:w] = 0.875
    if rows:
        hm[:, max(rows[0] - 4, 0):rows[0] + 4, w // 2] = 0.5
    return hm


MAKERS = {"random": random_maps, "planted": planted_maps,
          "plateau": plateau_maps}
# Plateaus are decoded without the blur so that their ties stay exact in
# every implementation (a blurred plateau ties only up to summation order).
# Thresholds split each kind's top-8 scores into valid and invalid slots.
CONFIGS = {
    "random": dict(max_peaks_per_channel=8, score_threshold=0.7),
    "planted": dict(max_peaks_per_channel=8, score_threshold=0.2),
    "plateau": dict(max_peaks_per_channel=8, score_threshold=0.99,
                    smooth_sigma=0.0),
}


# The generic decode kernel's launches in the card tests
# (tests/test_torch_cuda.py), where the CPU tests check its launch plan
# and the card holds the C plan to it: (n_maps, h, w, taps, window, p).
GENERIC_CARD_PLANS = [
    (6, 40, 56, 7, 1, 8), (6, 40, 56, 7, 2, 17), (6, 40, 56, 7, 4, 64),
    (6, 37, 53, 7, 5, 1), (68, 128, 128, 7, 5, 8), (2, 9, 513, 7, 3, 17),
    (2, 20, 700, 7, 4, 64), (6, 40, 56, 17, 3, 8), (4, 3, 3, 7, 2, 9),
    (3, 40, 300, 1, 5, 8), (3, 64, 260, 1, 5, 32), (1088, 128, 128, 1, 5, 8),
    (17, 128, 128, 7, 5, 20), (1088, 7, 128, 7, 5, 8), (17, 37, 128, 7, 5, 8),
    (3, 64, 1, 7, 5, 8), (3, 13, 4097, 7, 5, 8), (6, 20, 40, 401, 3, 8),
    (6, 40, 56, 7, 7, 8), (1, 37, 53, 7, 5, 8), (133, 37, 53, 7, 5, 8),
    (6, 40, 56, 7, 5, 1), (6, 40, 56, 1, 5, 8), (6, 40, 56, 1, 5, 9),
    (6, 40, 56, 7, 5, 32), (6, 40, 56, 7, 5, 33), (6, 8, 8, 1, 5, 64),
    (3, 24, 40, 1, 5, 40), (34, 128, 128, 7, 1, 8), (34, 128, 128, 7, 5, 8),
    (34, 128, 128, 7, 2, 40), (17, 128, 128, 7, 5, 8),
    (1088, 128, 128, 7, 5, 8), (6, 36, 300, 7, 2, 8),
    (68, 160, 600, 7, 3, 20), (6, 16, 16, 7, 3, 8), (2, 4, 513, 7, 3, 8),
]
