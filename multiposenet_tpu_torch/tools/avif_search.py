"""Searches seeded images for an AVIF file cv2.imencode(".avif") writes
that the port reads otherwise than cv2 5.0 (libavif 1.4.2 over libaom
3.14.1): each image (of sides drawn from 1 to 160, one case in 16 a strip
over 4096 wide, which libaom splits into tile columns; of one of the kinds
of `tools/jpeg2000_write_search.py` or a drawing of flat shapes and text
up to 320 a side, which libaom codes as screen content; in colour, gray or
with an alpha channel) is written at an IMWRITE_AVIF_DEPTH drawn from 8,
10 and 12 (uint16 pixels for 10 and 12: the uint8 image's values
shifted up, with seeded noise in the new low bits, or, for drawings,
their own bits repeated, so flat colours stay flat), an
IMWRITE_AVIF_QUALITY drawn from 0 to 100 (100, lossless, in one case in
six of the rest) and an IMWRITE_AVIF_SPEED drawn from 0 to 10, each
cv2's default in one case in three. Then the host C library's Y, U and V
planes are compared with libaom's (`tests/avif_reference.py`, libaom
over ctypes), the port's RGB with cv2.imdecode's, and, where the image
has at most 4,096 pixels, the plain decoder's planes with the C
library's. One case in four is written by Pillow's AVIF writer instead
(libavif 1.3.0, speeds 5 to 10, 8 bits), whose files reach AV1 tools
cv2's do not: the port reads those files as cv2 does or refuses them by
name (a refusal is a difference only for a cv2 file, or where cv2
returns no image).

    python -m multiposenet_tpu_torch.tools.avif_search \\
        [--count 300] [--seed 0] [--workers 6] [--out FILE]

prints one JSON line: cases (and cases at each depth), differences
([writer, kind, h, w, channels, depth, quality, speed, seed], what
differs), the refusals of Pillow files and of cv2 files, the count of
each tool the C decoder reached over all cases
(`csrc/av1.c`'s counters: transform sizes and types, intra modes, filter
intra, angle deltas, edge filtering and upsampling, delta q and lf,
tiles, partitions, palette, lossless blocks, restoration units, intra
block copy; and the frames in TX_MODE_SELECT), the tools no case reached
and those no cv2 file reached (over all cases and at each depth), and
seconds. It needs cv2 and the wheel's
libaom, so it runs where they are installed, not on the card's machine.
The CPU tests run `search` on the first cases of a seed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from multiposenet_tpu_torch.tools.jpeg2000_write_search import KINDS, image
from multiposenet_tpu_torch.utils.avif import STAT_NAMES

TESTS = Path(__file__).resolve().parents[2] / "tests"
REFERENCE = TESTS / "avif_reference.py"
MAX_SIDE = 160
DRAWING_MAX_SIDE = 320  # intra block copy needs room to copy from
WIDE = 4500
PLAIN_PIXELS = 4096
AVIF_KINDS = KINDS + ("drawing",)


def load_reference(path: Path = REFERENCE):
    spec = importlib.util.spec_from_file_location("avif_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


DEPTHS = (8, 10, 12)


def cases(count: int, seed: int = 0) -> list[tuple]:
    """(writer, kind, h, w, channels, depth, quality or None, speed or
    None, image seed) of `count` seeded images, the kinds in turn; one
    case in four written by Pillow (at 8 bits and a speed from 5 to 10
    drawn from the image seed) rather than cv2."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        kind = AVIF_KINDS[i % len(AVIF_KINDS)]
        side = DRAWING_MAX_SIDE if kind == "drawing" else MAX_SIDE
        h, w = (int(v) for v in rng.integers(1, side + 1, 2))
        if i % 16 == 15:
            h, w = int(rng.integers(1, 9)), WIDE
        channels = (3, 3, 1, 4)[int(rng.integers(0, 4))]
        quality = None if rng.integers(0, 3) == 0 else 100 if \
            rng.integers(0, 6) == 0 else int(rng.integers(0, 101))
        speed = None if rng.integers(0, 3) == 0 else int(rng.integers(0, 11))
        depth = DEPTHS[int(rng.integers(0, 3))]
        writer = "pillow" if i % 4 == 3 else "cv2"
        if writer == "pillow":
            quality = 75 if quality is None else min(quality, 99)
            speed, depth = None, 8
        out.append((writer, kind, h, w, channels, depth, quality, speed,
                    int(rng.integers(2**31))))
    return out


def encode(reference, writer: str, pixels_: np.ndarray, depth: int, quality,
           speed, seed: int) -> bytes:
    if writer == "cv2":
        return reference.imencode_avif(pixels_, quality, speed,
                                       None if depth == 8 else depth)
    return reference.pillow_avif(pixels_, quality, 5 + seed % 6)


def pixels(kind: str, h: int, w: int, channels: int, seed: int,
           reference, depth: int = 8) -> np.ndarray:
    """The case's pixels: RGB, gray (the RGB's mean) or RGBA, uint8 at 8
    bits, else uint16 of `depth` bits (`avif_reference.widen`). The
    kind's image is made at least 8 on each side and cropped (photo
    crops wider than the photo come from the photo tiled; drawings are
    the reference module's, cv2's shapes)."""
    out = _pixels8(kind, h, w, channels, seed, reference)
    if depth == 8:
        return out
    return reference.widen(out, depth, None if kind == "drawing" else seed)


def _pixels8(kind: str, h: int, w: int, channels: int, seed: int,
             reference) -> np.ndarray:
    if kind == "drawing":
        rgb = reference.drawing(h, w, seed)
    elif kind == "photo" and (h > 480 or w > 640):
        rgb = np.tile(image(kind, 480, 640, seed),
                      (-(-h // 480), -(-w // 640), 1))[:h, :w]
    else:
        rgb = image(kind, max(h, 8), max(w, 8), seed)[:h, :w]
    if channels == 1:
        return rgb.mean(axis=2).astype(np.uint8)
    if channels == 4:
        alpha = np.random.default_rng(seed).integers(0, 256, (h, w),
                                                     dtype=np.uint8)
        return np.dstack([rgb, alpha])
    return np.ascontiguousarray(rgb)


def compare(data: bytes, reference, plain: bool) -> tuple[list, np.ndarray,
                                                          int]:
    """(what differs, the C decoder's counters, TX_MODE_SELECT or not)."""
    from multiposenet_tpu_torch.utils import avif

    differ = []
    image_ = avif.read_image(data)
    y, u, v, stats = avif.decode_planes_c(image_.frame)
    ref = reference.aom_planes(reference.primary_obus(data))
    for name, got, want in zip("yuv", (y, u, v), ref):
        if (got is None) != (want is None) or (
                want is not None and not np.array_equal(got, want)):
            differ.append(f"plane_{name}")
    if not np.array_equal(avif.decode(data), reference.imdecode_rgb(data)):
        differ.append("rgb")
    if plain:
        p = avif.decode_planes_plain(image_.frame)
        if not all((a is None and b is None) or np.array_equal(a, b)
                   for a, b in zip(p, (y, u, v))):
            differ.append("plain")
    return differ, stats, image_.frame.header.tx_mode_select


def _run(batch: list[tuple], reference: str) -> list:
    """(case, what differs, counters, TX_MODE_SELECT, refusal) of each
    case. A refusal by name is no difference for a Pillow file (it may
    use what the contract leaves out) and is one for a cv2 file."""
    module = load_reference(Path(reference))
    out = []
    for case in batch:
        writer, kind, h, w, channels, depth, quality, speed, seed = case
        data = encode(module, writer,
                      pixels(kind, h, w, channels, seed, module, depth),
                      depth, quality, speed, seed)
        try:
            differ, stats, txsel = compare(data, module,
                                           h * w <= PLAIN_PIXELS)
            refusal = None
        except ValueError as exc:
            differ, stats, txsel = [], np.zeros(len(STAT_NAMES), np.int64), 0
            refusal = str(exc)
            if writer == "cv2" or module.imdecode_rgb(data) is None:
                differ = [f"refused: {refusal}"]
        out.append((case, differ, stats.tolist(), txsel, refusal))
    return out


def search(batch: list[tuple], workers: int = 0,
           reference: Path = REFERENCE) -> dict:
    """Every case compared (in this process, or over `workers`
    processes): the cases, the differences, the tools reached and the
    seconds."""
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

    def tools(rows):
        totals = np.sum([r[2] for r in rows], axis=0)
        out = {name: int(n) for name, n in zip(STAT_NAMES, totals)}
        out["tx_mode_select_frames"] = int(sum(r[3] for r in rows))
        # A maximum, not a count: the largest eob.
        out["eob_max"] = int(max(r[2][STAT_NAMES.index("eob_max")]
                                 for r in rows))
        return out

    cv2_rows = [r for r in done if r[0][0] == "cv2"]
    reached = tools(done)
    reached_cv2 = tools(cv2_rows)
    by_depth = {d: [r for r in done if r[0][5] == d] for d in DEPTHS}
    return {"cases": len(done), "cv2_cases": len(cv2_rows),
            "cases_by_depth": {d: len(rows) for d, rows in by_depth.items()},
            "plain_cases": sum(r[0][2] * r[0][3] <= PLAIN_PIXELS
                               for r in done),
            "differences": sorted([list(r[0]), r[1]] for r in done if r[1]),
            "cv2_refused": sorted({r[4] for r in cv2_rows if r[4]}),
            "pillow_refused": sorted({r[4] for r in done
                                      if r[4] and not r[1]}),
            "tools": reached,
            "tools_not_reached": sorted(k for k, n in reached.items()
                                        if not n),
            "tools_not_reached_by_cv2_files": sorted(
                k for k, n in reached_cv2.items() if not n),
            "tools_not_reached_by_depth": {
                d: sorted(k for k, n in tools(rows).items() if not n)
                for d, rows in by_depth.items() if rows},
            "seconds": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", type=Path, default=REFERENCE,
                    help="tests/avif_reference.py or a file like it")
    ap.add_argument("--count", type=int, default=300)
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
