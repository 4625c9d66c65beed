"""Searches seeded images for one whose `.avif` the port writes otherwise
than cv2 5.0 (libavif 1.4.2 over libaom 3.14.1) at its defaults: crops of
the photo fixture, drawings of people (`utils/visualize.draw_predictions`)
on a crop, text and shapes drawn by cv2 (`tests/avif_reference.py
drawing`), noise, flat colour and ramps, of sides from 1 to 700
(log-uniform), and, first, a few strips wider than 4096 (two and four
tile columns) and frames from 720p to 4K. Each image is written by
`avif_write.encode` (the host C library) and, up to `PLAIN_PIXELS`
pixels, by `encode_plain` (Python), and each file is compared byte for
byte with `cv2.imencode(".avif")`'s.
Where one differs, the decisions the port's plain decoder reads from
both files locate the first block that differs and what in it (the
superblock's qindex, the partition, the luma mode or a transform block's
levels).

    python -m multiposenet_tpu_torch.tools.avif_write_search \\
        [--count 1000] [--seed 0] [--workers 6] [--out FILE]

prints one JSON line: the cases, the images the plain writer also wrote,
the bytes written, the differences ([kind, h, w, seed, writers, first
differing block]) and the seconds. cv2's bytes come from the function
`imencode(suffix, rgb)` of a reference file (`--reference`, by default
tests/make_image_fixtures.py, which calls cv2), so the search runs where
cv2 is installed, not on the card's machine. The CPU tests run `search`
on a slice of the cases.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from multiposenet_tpu_torch.tools.jpeg_cut_search import load_reference

TESTS = Path(__file__).resolve().parents[2] / "tests"
REFERENCE = TESTS / "make_image_fixtures.py"
DRAWINGS = TESTS / "avif_reference.py"
PHOTO = TESTS / "fixtures" / "images" / "photo_480x640_q95_420.jpg"
KINDS = ("photo", "drawn", "text", "noise", "flat", "ramps")
WIDE = ((8, 4100), (16, 4500), (8, 8200))
# Large frames: the partition's thresholds change at 1280 x 720 pixels,
# the rates' refresh at a shorter side of 2160.
LARGE = ((720, 1280), (1080, 1920), (2160, 2160), (2160, 3840))
MAX_SIDE = 700
PLAIN_PIXELS = 20_000  # the plain writer runs on images up to this


def _photo() -> np.ndarray:
    from multiposenet_tpu_torch.utils import image_io

    return image_io.read_image(PHOTO)


def _person(rng, h: int, w: int):
    y0, x0 = rng.uniform(0, h), rng.uniform(0, w)
    box = np.array([y0, x0, rng.uniform(y0, h), rng.uniform(x0, w)])
    kps = np.stack([rng.uniform(0, h, 17), rng.uniform(0, w, 17),
                    rng.uniform(0, 1, 17)], -1)
    return argparse.Namespace(box=box, score=1.0, keypoints=kps)


def image(kind: str, h: int, w: int, seed: int, drawings=None) -> np.ndarray:
    """A seeded uint8 RGB [h, w, 3] image of one of `KINDS` (`drawings`:
    the module with cv2's `drawing(h, w, seed)`, for "text")."""
    from multiposenet_tpu_torch.utils import visualize

    rng = np.random.default_rng(seed)
    if kind in ("photo", "drawn"):
        photo = _photo()
        reps = (-(-h // photo.shape[0]), -(-w // photo.shape[1]), 1)
        big = np.tile(photo, reps)
        y = int(rng.integers(0, big.shape[0] - h + 1))
        x = int(rng.integers(0, big.shape[1] - w + 1))
        crop = np.ascontiguousarray(big[y:y + h, x:x + w])
        if kind == "photo":
            return crop
        people = [_person(rng, h, w) for _ in range(int(rng.integers(1, 4)))]
        return visualize.draw_predictions(crop, people)
    if kind == "text":
        return np.ascontiguousarray(drawings.drawing(h, w, seed))
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8),
                               (h, w, 3)).copy()
    yy, xx = np.mgrid[0:h, 0:w]
    a, b = rng.integers(1, 6, 2)
    img = np.stack([xx * a, yy * b, (xx + yy) * 255 // (h + w)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def cases(count: int, seed: int = 0,
          large: bool = True) -> list[tuple[str, int, int, int]]:
    """(kind, h, w, image seed) of `count` seeded images: the strips of
    `WIDE` and (with `large`) the frames of `LARGE` first, then sides
    log-uniform in 1 .. MAX_SIDE, the kinds in turn."""
    rng = np.random.default_rng(seed)
    out = []
    fixed = WIDE + LARGE if large else WIDE
    for i in range(count):
        if i < len(fixed):
            h, w = fixed[i]
        else:
            h, w = (int(math.exp(v)) for v in
                    rng.uniform(0, math.log(MAX_SIDE + 1), 2))
        out.append((KINDS[i % len(KINDS)], max(h, 1), max(w, 1),
                    int(rng.integers(2**31))))
    return out


def first_difference(got: bytes, want: bytes) -> str:
    """Where the decisions the plain decoder reads from two files of one
    image first differ: the block (mode-info row, column, size) and what
    in it, or the header."""
    from multiposenet_tpu_torch.utils import av1_encode, avif

    frames = [avif.read_image(data).frame for data in (got, want)]
    heads = [(f.header.delta_q_present, f.header.tx_mode_select)
             for f in frames]
    if heads[0] != heads[1]:
        return f"header (delta q, TX_MODE_SELECT) {heads[0]} vs {heads[1]}"
    mine, theirs = (av1_encode.decisions(f) for f in frames)
    for a, b in zip(mine, theirs):
        at = f"block ({a.r}, {a.c}, size {a.bsize})"
        if (a.r, a.c, a.bsize) != (b.r, b.c, b.bsize):
            return f"{at}: the partition ({b.r}, {b.c}, size {b.bsize})"
        if a.q != b.q:
            return f"{at}: the qindex {a.q} vs {b.q}"
        if a.y_mode != b.y_mode:
            return f"{at}: the luma mode {a.y_mode} vs {b.y_mode}"
        for plane in range(3):
            for i, (x, y) in enumerate(zip(a.coeffs[plane],
                                           b.coeffs[plane])):
                if x != y:
                    return f"{at}: plane {plane} transform block {i}"
    return "the blocks agree (the symbols differ)"


def _run(batch: list[tuple[str, int, int, int]], reference: str) -> list:
    from multiposenet_tpu_torch.utils import avif_write

    module = load_reference(Path(reference))
    drawings = load_reference(DRAWINGS)
    done = []
    for kind, h, w, seed in batch:
        rgb = image(kind, h, w, seed, drawings)
        want = module.imencode(".avif", rgb)
        writers = [("c", avif_write.encode)]
        if h * w <= PLAIN_PIXELS:
            writers.append(("plain", avif_write.encode_plain))
        wrong, where = [], None
        for name, encode in writers:
            got = encode(rgb)
            if got != want:
                wrong.append(name)
                where = where or first_difference(got, want)
        done.append((kind, h, w, seed, len(writers) > 1, len(want), wrong,
                     where))
    return done


def search(batch: list[tuple[str, int, int, int]], workers: int = 0,
           reference: Path = REFERENCE) -> dict:
    """Every case (in this process, or over `workers` processes): the
    cases, those the plain writer also wrote, the bytes, the differences
    and the seconds."""
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
    differences = sorted([kind, h, w, seed, wrong, where]
                         for kind, h, w, seed, _, _, wrong, where in done
                         if wrong)
    return {"cases": len(done), "plain_cases": sum(r[4] for r in done),
            "bytes": sum(r[5] for r in done), "differences": differences,
            "seconds": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", type=Path, default=REFERENCE,
                    help="a file with imencode(suffix, rgb)")
    ap.add_argument("--count", type=int, default=1000)
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
