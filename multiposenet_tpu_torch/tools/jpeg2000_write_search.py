"""Searches seeded images for one whose `.jp2` the port writes otherwise
than cv2 5.0 (OpenJPEG 2.5.3): each image, of sides drawn from 32 to 129
and of one of a few kinds of content (noise, flat colour, ramps, smooth
ramps with a little noise, crops of the photo fixture, blocks of flat
colour, thin stripes, mostly flat with a few marks, the extremes 0 and
255, low-amplitude noise), is written by `jpeg2000_write.encode` (the
host C library) and, where both sides are at most 48, by `encode_plain`,
and each file is compared byte for byte with `cv2.imencode(".jp2")`'s.
The kinds cover files the rate does not bind (they are lossless) and
files it truncates.

    python -m multiposenet_tpu_torch.tools.jpeg2000_write_search \
        [--count 200] [--seed 0] [--workers 6] [--out FILE]

prints one JSON line: cases, differences ([kind, h, w, seed, writers])
and seconds. cv2's bytes come from the function `imencode(suffix, rgb)`
of a reference file (`--reference`, by default
tests/make_image_fixtures.py, which calls cv2), so the search runs where
cv2 is installed, not on the card's machine. The CPU tests run `search`
on the first cases of a seed.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from multiposenet_tpu_torch.tools.jpeg_cut_search import load_reference

TESTS = Path(__file__).resolve().parents[2] / "tests"
REFERENCE = TESTS / "make_image_fixtures.py"
PHOTO = TESTS / "fixtures" / "images" / "photo_480x640_q95_420.jpg"
KINDS = ("noise", "flat", "ramps", "smooth", "photo", "blocks", "stripes",
         "marks", "extremes", "faint")
MIN_SIDE, MAX_SIDE = 32, 129
PLAIN_MAX_SIDE = 48  # the plain writer runs on images up to this


def image(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    """A seeded uint8 RGB [h, w, 3] image of one of `KINDS`."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8),
                               (h, w, 3)).copy()
    if kind in ("ramps", "smooth"):
        a, b = rng.integers(1, 6, 2)
        img = np.stack([x * a, y * b, (x + y) * 255 // (h + w)], -1)
        if kind == "smooth":
            img = img + rng.integers(-4, 5, img.shape)
        return np.clip(img, 0, 255).astype(np.uint8)
    if kind == "photo":
        from multiposenet_tpu_torch.utils import image_io

        photo = image_io.read_image(PHOTO)
        y0 = int(rng.integers(0, photo.shape[0] - h + 1))
        x0 = int(rng.integers(0, photo.shape[1] - w + 1))
        return np.ascontiguousarray(photo[y0:y0 + h, x0:x0 + w])
    if kind == "blocks":
        img = np.empty((h, w, 3), np.uint8)
        size = int(rng.integers(3, 24))
        colours = rng.integers(0, 256, (h // size + 1, w // size + 1, 3))
        img[:] = colours[y // size, x // size]
        return img
    if kind == "stripes":
        period = int(rng.integers(2, 6))
        on = rng.integers(0, 256, 3)
        off = rng.integers(0, 256, 3)
        return np.where(((x + y * int(rng.integers(0, 2))) % period
                         < period // 2)[..., None], on, off).astype(np.uint8)
    if kind == "marks":
        img = np.broadcast_to(rng.integers(0, 256, 3),
                              (h, w, 3)).astype(np.uint8)
        for _ in range(int(rng.integers(1, 6))):
            py, px = rng.integers(0, h - 4), rng.integers(0, w - 4)
            img[py:py + int(rng.integers(1, 5)),
                px:px + int(rng.integers(1, 5))] = rng.integers(0, 256, 3)
        return img
    if kind == "extremes":
        return (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)
    if kind == "faint":
        base = rng.integers(0, 250, 3)
        return (base + rng.integers(0, 4, (h, w, 3))).astype(np.uint8)
    raise ValueError(f"unknown kind {kind}")


def cases(count: int, seed: int = 0) -> list[tuple[str, int, int, int]]:
    """(kind, h, w, image seed) of `count` seeded images, the kinds in
    turn."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        h, w = (int(v) for v in rng.integers(MIN_SIDE, MAX_SIDE + 1, 2))
        out.append((KINDS[i % len(KINDS)], h, w, int(rng.integers(2**31))))
    return out


def compare(rgb: np.ndarray, reference, plain: bool) -> list[str]:
    """The writers whose bytes differ from `reference.imencode(".jp2")`'s
    (none: [])."""
    from multiposenet_tpu_torch.utils import jpeg2000_write

    want = reference.imencode(".jp2", rgb)
    differ = []
    if jpeg2000_write.encode(rgb) != want:
        differ.append("encode")
    if plain and jpeg2000_write.encode_plain(rgb) != want:
        differ.append("encode_plain")
    return differ


def _run(batch: list[tuple[str, int, int, int]], reference: str) -> list:
    module = load_reference(Path(reference))
    return [(kind, h, w, seed,
             compare(image(kind, h, w, seed), module,
                     max(h, w) <= PLAIN_MAX_SIDE))
            for kind, h, w, seed in batch]


def search(batch: list[tuple[str, int, int, int]], workers: int = 0,
           reference: Path = REFERENCE) -> dict:
    """Every case compared (in this process, or over `workers`
    processes): the cases, the differences and the seconds."""
    t0 = time.perf_counter()
    if workers:
        chunks = [batch[i::workers * 4] for i in range(workers * 4)]
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) \
                as pool:
            done = [r for part in pool.map(
                _run, chunks, [str(reference)] * len(chunks)) for r in part]
    else:
        done = _run(batch, str(reference))
    differences = sorted([kind, h, w, seed, differ]
                         for kind, h, w, seed, differ in done if differ)
    return {"cases": len(done),
            "plain_cases": sum(max(h, w) <= PLAIN_MAX_SIDE
                               for _, h, w, _, _ in done),
            "differences": differences,
            "seconds": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", type=Path, default=REFERENCE,
                    help="a file with imencode(suffix, rgb)")
    ap.add_argument("--count", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON here")
    args = ap.parse_args(argv)
    result = search(cases(args.count, args.seed), args.workers,
                    args.reference)
    line = json.dumps(result)
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 1 if result["differences"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
