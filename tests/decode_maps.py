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
