"""Searches cut and damaged JPEG 2000 files for one that the port reads
otherwise than cv2 5.0 (OpenJPEG 2.5.3): each file of a small corpus
(JP2 and bare codestreams written by Pillow and by cv2 from seeded
images: both wavelets, layers, tiles, precincts, every progression order,
gray, RGBA and 16-bit; and files edited by `tools/j2k_samples.py`: SOP
and EPH markers, PPM headers over tile parts, a code-block style, a
palette with channel definitions) cut after every byte, and every byte
of it XORed
with 0x01, 0x10 and 0x80. Each case is read as bytes by
`image_io.decode_image` against `cv2.imdecode` and as a file by
`image_io.read_image` against `cv2.imread`, and where the header gives
at most 32x32 pixels by `decode_image_plain` too: the same pixels, or a
refusal where cv2 returns no image (or raises, as it does past its size
limits).

    python -m multiposenet_tpu_torch.tools.jpeg2000_cut_search \
        [--workers 6] [--out FILE]

prints one JSON line: cases, differences and seconds for each file. cv2's
decodes and its own file come from the functions `imread_rgb(path)`,
`imdecode_rgb(data)` and `imencode(suffix, rgb)` of a reference file
(`--reference`, by default tests/make_image_fixtures.py, which calls
cv2), and the rest of the corpus from Pillow, so the search runs where
both are installed, not on the card's machine. The CPU tests run
`search` on a seeded subset of the cases (`cases(..., per_file=)`).
"""

from __future__ import annotations

import argparse
import io
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from multiposenet_tpu_torch.tools import j2k_samples
from multiposenet_tpu_torch.tools.jpeg_cut_search import load_reference

TESTS = Path(__file__).resolve().parents[2] / "tests"
REFERENCE = TESTS / "make_image_fixtures.py"
FLIPS = (0x01, 0x10, 0x80)
PLAIN_MAX = 32 * 32  # the plain decoders run on files up to this


def smooth(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """A seeded image of ramps and a little noise: small when coded."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    planes = [x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
              (x + y) * 5 % 256, (x * y) % 256]
    img = np.stack(planes[:channels], -1).astype(np.int64)
    img += rng.integers(-6, 7, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8).squeeze()


def pillow_j2k(pixels: np.ndarray, mode: str | None = None,
               **options) -> bytes:
    """Pillow's JPEG 2000 writer (OpenJPEG) on `pixels`."""
    from PIL import Image

    buf = io.BytesIO()
    image = Image.fromarray(pixels)
    if mode is not None:
        image = image.convert(mode) if mode != "I;16" else \
            Image.frombytes("I;16", image.size,
                            pixels.astype("<u2").tobytes())
    image.save(buf, "JPEG2000", **options)
    return buf.getvalue()


def corpus(reference=None) -> dict[str, bytes]:
    """The files searched, by name (cv2's own through the reference's
    `imencode(suffix, rgb)`)."""
    reference = reference or load_reference(REFERENCE)
    files = {
        "rev_lrcp_rgb_21x27.jp2": pillow_j2k(smooth(21, 27, 3, 1)),
        "irr_rpcl_layers3_rgb_24x19.j2k": pillow_j2k(
            smooth(24, 19, 3, 2), irreversible=True, progression="RPCL",
            quality_mode="rates", quality_layers=[30, 15, 8], no_jp2=True),
        "rev_pcrl_tiles8_gray_19x23.jp2": pillow_j2k(
            smooth(19, 23, 1, 3), progression="PCRL", tile_size=(8, 8)),
        "rev_cprl_precincts_rgba_17x29.jp2": pillow_j2k(
            smooth(17, 29, 4, 4), progression="CPRL", num_resolutions=3,
            precinct_size=(16, 16), codeblock_size=(8, 8)),
        "irr_rlcp_dB_rgb_16x16.j2k": pillow_j2k(
            smooth(16, 16, 3, 5), irreversible=True, progression="RLCP",
            quality_mode="dB", quality_layers=[28, 36], no_jp2=True),
        "rev_i16_gray_13x17.jp2": pillow_j2k(
            smooth(13, 17, 1, 6).astype(np.uint16) * 257 + 3, "I;16"),
        "cv2_rgb_37x53.jp2": reference.imencode(".jp2",
                                                smooth(37, 53, 3, 7)),
    }
    # Edited as tests/test_torch_jpeg2000.py edits them: packet markers,
    # packed headers, tile parts, a code-block style, a palette.
    layered = pillow_j2k(smooth(19, 23, 3, 8), tile_size=(8, 8),
                         progression="RPCL", quality_mode="rates",
                         quality_layers=[20, 8])
    main, parts, tail = j2k_samples.split(layered[
        layered.index(b"\xff\x4f\xff\x51"):])
    files["sop_eph_tiles_rpcl_19x23.j2k"] = j2k_samples.with_sop_eph(
        j2k_samples.join(main, parts, tail))
    files["ppm_tile_parts_19x23.j2k"] = j2k_samples.with_ppm(
        j2k_samples.join(main, [dict(p, tn=2) for p in j2k_samples.in_parts(
            parts, 3)], tail))
    styled = pillow_j2k(smooth(17, 23, 3, 9), codeblock_size=(8, 8),
                        no_jp2=True)
    at = styled.index(b"\xff\x52") + 9  # the COD's code-block style
    files["styles_bypass_reset_vsc_17x23.j2k"] = (
        styled[:at] + bytes([0x0B]) + styled[at + 1:])
    gray = pillow_j2k(smooth(15, 21, 1, 10))
    table = np.random.default_rng(10).integers(0, 256, (256, 3))
    files["palette_cdef_15x21.jp2"] = j2k_samples.with_jp2h(
        gray, lambda h: [b for b in h if b[0] != b"colr"] + [
            j2k_samples.colr_box(16), j2k_samples.pclr_box(table, [8] * 3),
            j2k_samples.cmap_box([(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
            [b"cdef", bytes.fromhex("0003000000000003000100000002"
                                    "000200000001")]])
    return files


def cases(files: dict[str, bytes], seed: int | None = None,
          per_file: int = 0) -> list[tuple[str, str, int, int]]:
    """(file, "cut" or "flip", position, XOR value) for every cut and
    flip of every file, or with `seed` `per_file` of each file's cases
    drawn at random."""
    rng = np.random.RandomState(seed) if seed is not None else None
    out = []
    for name, data in sorted(files.items()):
        mine = [(name, "cut", n, 0) for n in range(1, len(data))]
        mine += [(name, "flip", at, x) for at in range(len(data))
                 for x in FLIPS]
        if rng is not None and per_file < len(mine):
            pick = sorted(rng.choice(len(mine), per_file, replace=False))
            mine = [mine[i] for i in pick]
        out += mine
    return out


def damaged(data: bytes, kind: str, at: int, value: int) -> bytes:
    if kind == "cut":
        return data[:at]
    out = bytearray(data)
    out[at] ^= value
    return bytes(out)


def compare(data: bytes, path: Path, plain: bool, reference) -> list[str]:
    """The readers that read `data` otherwise than `reference` (cv2) does
    (none: [])."""
    from multiposenet_tpu_torch.utils import image_io

    def outcome(read, arg):
        try:
            return read(arg)
        except ValueError:
            return None

    def cv2_outcome(read, arg):
        try:
            return read(arg)
        except Exception:  # cv2.error: imread's size limits raise
            return None

    def same(got, want):
        return (got is None) == (want is None) and (
            want is None or (got.shape == want.shape
                             and np.array_equal(got, want)))

    path.write_bytes(data)
    want = cv2_outcome(reference.imdecode_rgb, data)
    differ = []
    if not same(outcome(image_io.read_image, path),
                cv2_outcome(reference.imread_rgb, path)):
        differ.append("read_image")
    if not same(outcome(image_io.decode_image, data), want):
        differ.append("decode_image")
    if plain and not same(outcome(image_io.decode_image_plain, data), want):
        differ.append("decode_image_plain")
    return differ


def _small(data: bytes) -> bool:
    """Whether the header reads and gives at most PLAIN_MAX pixels."""
    from multiposenet_tpu_torch.utils import jpeg2000

    try:
        h, w = jpeg2000.image_size(data)
    except ValueError:
        return False
    return h * w <= PLAIN_MAX


def _run(batch: list[tuple[str, str, int, int]], reference: str) -> list:
    """A worker's share: [(name, kind, at, value, readers that differ)]."""
    module = load_reference(Path(reference))
    files = corpus(module)
    fd, tmp = tempfile.mkstemp(suffix=".jp2")
    os.close(fd)
    out = []
    try:
        for name, kind, at, value in batch:
            data = damaged(files[name], kind, at, value)
            out.append((name, kind, at, value,
                        compare(data, Path(tmp), _small(data), module)))
    finally:
        os.remove(tmp)
    return out


def search(batch: list[tuple[str, str, int, int]], workers: int = 0,
           reference: Path = REFERENCE) -> dict:
    """Every case compared (in this process, or over `workers` processes):
    for each file its cases and differences ([kind, at, value, readers]),
    and the seconds."""
    t0 = time.perf_counter()
    if workers:
        chunks = [batch[i::workers * 8] for i in range(workers * 8)]
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) \
                as pool:
            done = [r for part in pool.map(
                _run, chunks, [str(reference)] * len(chunks)) for r in part]
    else:
        done = _run(batch, str(reference))
    per: dict = {}
    for name, kind, at, value, differ in done:
        f = per.setdefault(name, {"cases": 0, "differences": []})
        f["cases"] += 1
        if differ:
            f["differences"].append([kind, at, value, differ])
    for f in per.values():
        f["differences"].sort()
    return {"files": per, "cases": len(done),
            "differences": sum(len(f["differences"]) for f in per.values()),
            "seconds": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", type=Path, default=REFERENCE,
                    help="a file with imread_rgb(path), imdecode_rgb(data)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON here")
    args = ap.parse_args(argv)
    result = search(cases(corpus(load_reference(args.reference))),
                    args.workers, args.reference)
    line = json.dumps(result)
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 1 if result["differences"] else 0


if __name__ == "__main__":
    sys.exit(main())
