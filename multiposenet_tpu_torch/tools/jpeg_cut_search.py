"""Searches the cuts of JPEG files for one that the port reads otherwise
than cv2 5.0 (libjpeg-turbo 3.1): each file cut after every byte of its
last scan, from that scan's SOS marker to the end, and the 480x640
timing photo (152,282 bytes) cut at every byte within 600 of its first
three and its last three 4096-byte boundaries after its SOS, where
`cv2.imread`'s stdio source refills its buffer and libjpeg-turbo's
Huffman decoder leaves and takes up its fast path. Each cut is read as a
file by `image_io.read_image` against `cv2.imread` and as bytes by
`image_io.decode_image` against `cv2.imdecode`, and for the files the
plain decoder reads of up to 64x64 pixels by `decode_image_plain` against
both (with `eof_fill` against `cv2.imread`): the same pixels, or a
refusal where cv2 returns no image.

    python -m multiposenet_tpu_torch.tools.jpeg_cut_search \
        [--fixtures tests/fixtures/images] [--workers 6] [--out FILE]

prints one JSON line: cuts, differences and seconds for each mode.
The port imports no cv2: cv2's decodes come from the functions
`imread_rgb(path)` and `imdecode_rgb(data)` of a reference file
(`--reference`, by default tests/make_image_fixtures.py, which calls
cv2), so the search runs where cv2 is installed, not on the card's
machine. The CPU tests run `search` on a seeded subset of the cuts
(`cut_cases(..., per_file=)`).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

TESTS = Path(__file__).resolve().parents[2] / "tests"
FIXTURES = TESTS / "fixtures" / "images"
REFERENCE = TESTS / "make_image_fixtures.py"
PHOTO = "photo_480x640_q95_420.jpg"
REFILL = 4096  # the stdio source's buffer (jdatasrc.c INPUT_BUF_SIZE)
WINDOW = 600
# The JPEG fixtures by the mode of their last scan.
MODES = {
    "baseline": (
        "kind_noise_37x53_420_q95.jpg", "kind_noise_37x53_444_q100.jpg",
        "kind_orient3_le_40x64.jpg", "kind_orient6_be_40x64.jpg",
        "kind_tex_3x3_420_q95.jpg", "kind_tex_4x4_422_q50.jpg",
        "kind_tex_97x133_411_q95.jpg",
        "kind_tex_97x133_420_q75_optimize.jpg",
        "kind_tex_97x133_422_q50.jpg", "kind_tex_97x133_440_q75.jpg",
        "kind_tex_97x133_gray_q100.jpg", "c3_truncated_48x64_420.jpg",
        "c3_adobe_rgb_48x64.jpg", "c3_cmyk_48x64.jpg", "c3_ycck_48x64.jpg",
        "scene_00_420_q75.jpg", "scene_01_422_q95.jpg",
        "scene_02_444_q50.jpg", "scene_03_440_q95.jpg",
        "scene_04_411_q75.jpg", "scene_05_420_q95.jpg",
        "scene_06_gray_q95.jpg", "scene_07_420_q50.jpg",
        "scene_08_444_q75.jpg", "scene_09_422_q75.jpg"),
    "baseline_restarts": ("kind_tex_97x133_420_q95_rst3.jpg",),
    "progressive": ("c3_progressive_48x64_gray_q50.jpg",
                    "c3_truncated_progressive_48x64_444.jpg"),
    "progressive_restarts": ("c3_progressive_48x64_420_q95_rst2.jpg",),
    "progressive_smoothing": ("c3_smooth_dc_40x48_420.jpg",
                              "c3_smooth_ac1_40x48_420.jpg"),
    "arithmetic": ("c3_arith_32x32_420.jpg",),
    "arithmetic_progressive_restarts": (
        "c3_arith_progressive_32x32_444_rst.jpg",),
    "lossless": ("c3_lossless_p1_24x24.jpg",
                 "c3_lossless_p7_pt2_24x24_420.jpg",
                 "c3_lossless_cmyk_p4_16x16.jpg"),
    "baseline_refill": (PHOTO,),
}
PLAIN_MAX = 64 * 64  # the plain decoder reads baseline files up to this


def refill_cuts(data: bytes) -> list[int]:
    """Every cut within WINDOW bytes of the first three and the last three
    multiples of REFILL after the last SOS (each cut once)."""
    sos = data.rindex(b"\xff\xda")
    edges = [k * REFILL for k in range(1, len(data) // REFILL + 1)
             if k * REFILL > sos]
    cuts = {c for e in edges[:3] + edges[-3:]
            for c in range(e - WINDOW, e + WINDOW + 1)
            if sos < c < len(data)}
    return sorted(cuts)


def cut_cases(fixtures: Path = FIXTURES, seed: int | None = None,
              per_file: int = 0) -> list[tuple[str, str, int]]:
    """(mode, file name, cut) for every cut of every file of MODES, or
    with `seed` `per_file` of each file's cuts drawn at random."""
    rng = np.random.RandomState(seed) if seed is not None else None
    cases = []
    for mode, names in MODES.items():
        for name in names:
            data = (fixtures / name).read_bytes()
            cuts = (refill_cuts(data) if mode == "baseline_refill" else
                    list(range(data.rindex(b"\xff\xda"), len(data))))
            if rng is not None and per_file < len(cuts):
                cuts = sorted(rng.choice(cuts, per_file, replace=False))
            cases += [(mode, name, int(c)) for c in cuts]
    return cases


def load_reference(path: Path):
    """The module in the file `path`: its `imread_rgb(path)` and
    `imdecode_rgb(data)` return cv2's uint8 RGB decode or None."""
    spec = importlib.util.spec_from_file_location("jpeg_cut_reference",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def compare_cut(data: bytes, path: Path, plain: bool, reference) -> list[str]:
    """The readers that read `data` otherwise than `reference` (cv2) does
    (none: [])."""
    from multiposenet_tpu_torch.utils import image_io

    def outcome(read, arg):
        try:
            return read(arg)
        except ValueError:
            return None

    def same(got, want):
        return (got is None) == (want is None) and (
            want is None or (got.shape == want.shape
                             and np.array_equal(got, want)))

    path.write_bytes(data)
    want_file = reference.imread_rgb(path)
    want = reference.imdecode_rgb(data)
    differ = []
    if not same(outcome(image_io.read_image, path), want_file):
        differ.append("read_image")
    if not same(outcome(image_io.decode_image, data), want):
        differ.append("decode_image")
    if plain and not same(outcome(image_io.decode_image_plain, data), want):
        differ.append("decode_image_plain")
    if plain and not same(outcome(lambda d: image_io.decode_image_plain(
            d, eof_fill=True), data), want_file):
        differ.append("decode_image_plain(eof_fill)")
    return differ


def plain_reads(data: bytes) -> bool:
    """Whether the plain decoder reads the file's mode and size (parsed
    as `read_image` fills it, for the files that are cut already)."""
    from multiposenet_tpu_torch.utils import jpeg

    try:
        frame, _ = jpeg.parse(data, eof_fill=True)
    except ValueError:
        return False
    return frame.width * frame.height <= PLAIN_MAX


def _run(batch: list[tuple[str, str, int]], fixtures: str,
         reference: str) -> list:
    """A worker's share: [(mode, name, cut, readers that differ)]."""
    files, plain, out = {}, {}, []
    module = load_reference(Path(reference))
    fd, tmp = tempfile.mkstemp(suffix=".jpg")
    os.close(fd)
    try:
        for mode, name, cut in batch:
            if name not in files:
                files[name] = (Path(fixtures) / name).read_bytes()
                plain[name] = plain_reads(files[name])
            differ = compare_cut(files[name][:cut], Path(tmp), plain[name],
                                 module)
            out.append((mode, name, cut, differ))
    finally:
        os.remove(tmp)
    return out


def search(cases: list[tuple[str, str, int]], fixtures: Path = FIXTURES,
           workers: int = 0, reference: Path = REFERENCE) -> dict:
    """Every case compared (in this process, or over `workers` processes):
    for each mode its files, cuts, the differences ([name, cut, readers])
    and seconds."""
    t0 = time.perf_counter()
    if workers:
        chunks = [cases[i::workers * 8] for i in range(workers * 8)]
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) \
                as pool:
            done = [r for part in pool.map(
                _run, chunks, [str(fixtures)] * len(chunks),
                [str(reference)] * len(chunks)) for r in part]
    else:
        done = _run(cases, str(fixtures), str(reference))
    modes: dict = {}
    for mode, name, cut, differ in done:
        m = modes.setdefault(mode, {"files": set(), "cuts": 0,
                                    "differences": []})
        m["files"].add(name)
        m["cuts"] += 1
        if differ:
            m["differences"].append([name, cut, differ])
    for m in modes.values():
        m["files"] = sorted(m["files"])
        m["differences"].sort()
    return {"modes": modes, "cuts": len(done),
            "differences": sum(len(m["differences"])
                               for m in modes.values()),
            "seconds": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fixtures", type=Path, default=FIXTURES)
    ap.add_argument("--reference", type=Path, default=REFERENCE,
                    help="a file with imread_rgb(path), imdecode_rgb(data)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON here")
    args = ap.parse_args(argv)
    cases = cut_cases(args.fixtures)
    result = search(cases, args.fixtures, args.workers, args.reference)
    line = json.dumps(result)
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 1 if result["differences"] else 0


if __name__ == "__main__":
    sys.exit(main())
