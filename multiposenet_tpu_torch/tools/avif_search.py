"""Searches seeded images for an AVIF file that the port reads otherwise
than cv2 5.0 (libavif 1.4.2 over libaom 3.14.1): each image (of sides
drawn from 1 to 160, one case in 16 a strip over 4096 wide, which libaom
splits into tile columns; of one of the kinds of
`tools/jpeg2000_write_search.py` or a drawing of flat shapes and text up
to 320 a side, which libaom codes as screen content; in colour, gray or
with an alpha channel) is written by one of three writers:
- cv2.imencode(".avif") (two cases in four) at an IMWRITE_AVIF_DEPTH
  drawn from 8, 10 and 12 (uint16 pixels for 10 and 12: the uint8
  image's values shifted up, with seeded noise in the new low bits, or,
  for drawings, their own bits repeated, so flat colours stay flat), an
  IMWRITE_AVIF_QUALITY drawn from 0 to 100 (100, lossless, in one case
  in six of the rest) and an IMWRITE_AVIF_SPEED drawn from 0 to 10, each
  cv2's default in one case in three;
- the wheel's libavif encoder over ctypes (one case in four), at a depth
  drawn from 8, 10 and 12 and a subsampling drawn from 4:2:0, 4:2:2 and
  4:4:4 (4:0:0 for gray), at the quality and speed drawn;
- Pillow's AVIF writer (one case in four; libavif 1.3.0, speeds 5 to 10,
  8 bits) at a subsampling drawn from 4:2:0, 4:2:2 and 4:4:4.
In one case in two the colour description is then rewritten: matrix
coefficients drawn from 0 to 19 and 255, the range, and for
chroma-derived NCL (12) the colour primaries, in the `colr` nclx box, or,
in one such case in three (one item, no alpha), in the AV1 sequence
header with the `colr` box dropped. Then the host C library's Y, U and V
planes are compared with libaom's (`tests/avif_reference.py`, libaom over
ctypes), the port's RGB with cv2.imdecode's, and, where the image has at
most 4,096 pixels, the plain decoder's planes with the C library's. The
port must read every file cv2 reads, to cv2's pixels, and refuse every
file cv2 returns no image for.

    python -m multiposenet_tpu_torch.tools.avif_search \\
        [--count 300] [--seed 0] [--workers 6] [--out FILE]
        [--forms still|container|tools]

prints one JSON line: cases (and cases by writer, depth, subsampling and
colour rewrite), the cases cv2 returns no image for, differences
([writer, kind, h, w, channels, depth, quality, speed, seed,
subsampling, colour], what differs: a plane, the pixels, the plain
decoder, "refused where cv2 reads" or "read where cv2 returns none"),
the refusals by writer, the count of each tool the C decoder reached
over all cases (`csrc/av1.c`'s counters: transform sizes and types,
intra modes, filter intra, angle deltas, edge filtering and upsampling,
delta q and lf, tiles, partitions, palette, lossless blocks, CDEF,
restoration units, intra block copy; and the frames in TX_MODE_SELECT),
the tools no case reached (over all cases, by cv2's files, at each depth
and at each subsampling), and seconds. With `--forms container` it
draws the container forms past one still item instead
(`container_cases`: grids, Exif items and image sequences from the
wheel's libavif encoder and Pillow, and surgery on their files), holds
the port's pixels (C, and plain up to 8,192 pixels) and `image_size` to
cv2's and its refusals to cv2's None, and prints the cases and cv2's
refusals by form, the differences, the refusals' messages by form and
seconds. With `--forms tools` it draws libaom's film grain and
segmentation (`tool_cases`: `film-grain-test`, `denoise-noise-level` and
drawn `film-grain-table` parameters on stills, grids and sequences, and
`aq-mode=1` sequences), holds the port's pixels to cv2's, its planes
before and after the grain to libaom's and the plain decoder to the C
library (up to 4,096 pixels), and prints the cases by tool, form, depth
and subsampling, the differences, the refusals, and the segmentation
and grain counters and flags reached and not reached. It needs cv2,
Pillow and the wheel's libaom and libavif, so it runs where they are
installed, not on
the card's machine. The CPU tests run `search` on the first cases of a
seed.
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
SUBSAMPLINGS = ("420", "422", "444")
MATRICES = tuple(range(20)) + (255,)
CHROMA_DERIVED_PRIMARIES = (1, 2, 4, 5, 6, 9, 10, 22)


def cases(count: int, seed: int = 0) -> list[tuple]:
    """(writer, kind, h, w, channels, depth, quality or None, speed or
    None, image seed, subsampling, colour) of `count` seeded images, the
    kinds in turn; writers cv2, libavif and Pillow in the proportions 2,
    1, 1 (Pillow at 8 bits and a speed from 5 to 10 drawn from the image
    seed; cv2 at its own subsampling, "420" here); colour None or
    (where: "colr" or "seq", matrix, full range, primaries)."""
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
        writer = ("cv2", "cv2", "libavif", "pillow")[i % 4]
        sub = SUBSAMPLINGS[int(rng.integers(0, 3))]
        if writer == "pillow":
            quality = 75 if quality is None else min(quality, 99)
            speed, depth = None, 8
        elif writer == "libavif":
            quality = 50 if quality is None else quality
            speed = 6 if speed is None else speed
        else:
            sub = "420"
        if channels == 1:
            sub = "400"
        colour = None
        if rng.integers(0, 2):
            matrix = int(MATRICES[int(rng.integers(0, len(MATRICES)))])
            full = int(rng.integers(0, 2))
            primaries = int(CHROMA_DERIVED_PRIMARIES[int(rng.integers(
                0, len(CHROMA_DERIVED_PRIMARIES)))]) if matrix == 12 else 1
            where = "seq" if channels != 4 and rng.integers(0, 3) == 0 \
                else "colr"
            colour = (where, matrix, full, primaries)
        out.append((writer, kind, h, w, channels, depth, quality, speed,
                    int(rng.integers(2**31)), sub, colour))
    return out


YUV_FORMATS = {"400": 4, "420": 3, "422": 2, "444": 1}


def encode(reference, writer: str, pixels_: np.ndarray, depth: int, quality,
           speed, seed: int, sub: str, colour) -> bytes:
    """The case's file, its colour description rewritten by `colour`."""
    if writer == "cv2":
        data = reference.imencode_avif(pixels_, quality, speed,
                                       None if depth == 8 else depth)
    elif writer == "pillow":
        data = reference.pillow_avif(pixels_, quality, 5 + seed % 6,
                                     subsampling=sub[0] + ":" + sub[1] + ":"
                                     + sub[2])
    else:
        alpha = None
        rgb = pixels_
        if pixels_.ndim == 3 and pixels_.shape[2] == 4:
            rgb, alpha = pixels_[:, :, :3], pixels_[:, :, 3]
        if rgb.ndim == 2:
            rgb = np.repeat(rgb[:, :, None], 3, axis=2)
        data = reference.avif_encode(
            reference.planes_of(rgb, depth, YUV_FORMATS[sub]), depth,
            YUV_FORMATS[sub], quality, speed, alpha=alpha)
    if colour is None:
        return data
    where, matrix, full, primaries = colour
    if where == "seq":
        obus = reference.rewrite_frame(
            reference.primary_obus(data),
            {"matrix": matrix, "full_range": full, "primaries": primaries,
             "transfer": 1})
        return reference.edit_avif(data, drop_props=(b"colr",), color=obus)
    return reference.patch_colr(data, matrix, full, primaries)


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
    want_rgb = reference.imdecode_rgb(data)
    if want_rgb is None:
        return ["read where cv2 returns none"], stats, \
            image_.frame.header.tx_mode_select
    ref = reference.aom_planes(reference.primary_obus(data))
    for name, got, want in zip("yuv", (y, u, v), ref):
        if (got is None) != (want is None) or (
                want is not None and not np.array_equal(got, want)):
            differ.append(f"plane_{name}")
    if not np.array_equal(avif.decode(data), want_rgb):
        differ.append("rgb")
    if plain and not _same(avif.decode_planes_plain(image_.frame),
                           (y, u, v)):
        differ.append("plain")
    return differ, stats, image_.frame.header.tx_mode_select


def _run(batch: list[tuple], reference: str) -> list:
    """(case, what differs, counters, TX_MODE_SELECT, refusal, whether
    cv2 returns no image) of each case. A refusal is a difference where
    cv2 reads the file."""
    module = load_reference(Path(reference))
    out = []
    for case in batch:
        (writer, kind, h, w, channels, depth, quality, speed, seed, sub,
         colour) = case
        data = encode(module, writer,
                      pixels(kind, h, w, channels, seed, module, depth),
                      depth, quality, speed, seed, sub, colour)
        none = module.imdecode_rgb(data) is None
        try:
            differ, stats, txsel = compare(data, module,
                                           h * w <= PLAIN_PIXELS)
            refusal = None
        except ValueError as exc:
            differ, stats, txsel = [], np.zeros(len(STAT_NAMES), np.int64), 0
            refusal = str(exc)
            if not none:
                differ = [f"refused where cv2 reads: {refusal}"]
        out.append((case, differ, stats.tolist(), txsel, refusal, none))
    return out


def _map(run, batch: list[tuple], workers: int, reference: Path) -> list:
    """`run(cases, reference)` over the batch, in this process or over
    `workers` spawned processes (4 chunks each)."""
    if not workers:
        return run(batch, str(reference))
    chunks = [batch[i::workers * 4] for i in range(workers * 4)]
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return [r for part in pool.map(run, chunks,
                                       [str(reference)] * len(chunks))
                for r in part]


def _same(got, want) -> bool:
    """Planes (Y, U, V; U and V None for monochrome) equal."""
    return all((a is None and b is None) or np.array_equal(a, b)
               for a, b in zip(got, want))


def search(batch: list[tuple], workers: int = 0,
           reference: Path = REFERENCE) -> dict:
    """Every case compared (in this process, or over `workers`
    processes): the cases, the differences, the tools reached and the
    seconds."""
    t0 = time.perf_counter()
    done = _map(_run, batch, workers, reference)

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
    by_sub = {s: [r for r in done if r[0][9] == s]
              for s in SUBSAMPLINGS + ("400",)}
    differences = sorted([list(r[0]), r[1]] for r in done if r[1])

    def count(key):
        return {k: sum(key(r) == k for r in done)
                for k in sorted({key(r) for r in done}, key=str)}

    return {"cases": len(done),
            "cases_by_writer": count(lambda r: r[0][0]),
            "cases_by_depth": {d: len(rows) for d, rows in by_depth.items()},
            "cases_by_subsampling": {s: len(rows)
                                     for s, rows in by_sub.items()},
            "cases_by_colour": count(lambda r: r[0][10] and r[0][10][0]),
            "plain_cases": sum(r[0][2] * r[0][3] <= PLAIN_PIXELS
                               for r in done),
            "cv2_returns_none": sum(r[5] for r in done),
            "refused": sum(r[4] is not None for r in done),
            "differences": differences,
            "refused_where_cv2_reads": sum(
                d[0].startswith("refused where") for _, d in differences),
            "read_where_cv2_returns_none": sum(
                d == ["read where cv2 returns none"] for _, d in differences),
            "refusals": {wr: sorted({r[4] for r in done
                                     if r[4] and r[0][0] == wr})
                         for wr in ("cv2", "libavif", "pillow")},
            "tools": reached,
            "tools_not_reached": sorted(k for k, n in reached.items()
                                        if not n),
            "tools_not_reached_by_cv2_files": sorted(
                k for k, n in reached_cv2.items() if not n),
            "tools_not_reached_by_depth": {
                d: sorted(k for k, n in tools(rows).items() if not n)
                for d, rows in by_depth.items() if rows},
            "tools_not_reached_by_subsampling": {
                s: sorted(k for k, n in tools(rows).items() if not n)
                for s, rows in by_sub.items() if rows},
            "seconds": time.perf_counter() - t0}


# --- container forms -------------------------------------------------------

FORMS = ("grid", "exif", "sequence")
CELL_SIDES = (64, 64, 66, 72, 80, 96)
ODD_CELL_SIDES = (32, 48, 63, 65, 67)
EXIF_VARIANTS = ("plain", "plain", "plain", "prefix", "bad_offset",
                 "no_tiff", "short", "corrupt", "xmp")
SEQUENCE_EDITS = ("none", "none", "idat", "co64", "no_items", "top_exif")


def container_cases(count: int, seed: int = 0) -> list[tuple]:
    """(form, image seed, spec) of `count` seeded files of the container
    forms in turn: grids ("grid": 1 to 4 rows and columns of cells of
    sides from CELL_SIDES, one case in eight a side from ODD_CELL_SIDES;
    a depth of 8, 10 or 12 and a subsampling of 4:2:0, 4:2:2, 4:4:4 or
    4:0:0; an alpha grid in one case in four; the output cropped in one
    case in two, at times past the cells' span or short of the last
    row's or column's; an Exif orientation in one case in three), Exif
    items on a still ("exif": orientations 0 to 9 in either byte order,
    and the payloads of EXIF_VARIANTS; the item before or after the
    image, the meta box padded by 0 to 400 bytes, so that its data
    falls on either side of byte 500) and image sequences ("sequence":
    1 to 4 frames from Pillow or the wheel's libavif encoder, an alpha
    track in one case in four, and the edits of SEQUENCE_EDITS)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        form = FORMS[i % len(FORMS)]
        sub = ("420", "422", "444", "400")[int(rng.integers(0, 4))]
        depth = DEPTHS[int(rng.integers(0, 3))]
        spec = {"sub": sub, "depth": depth,
                "quality": int(rng.integers(0, 101)),
                "speed": int(rng.integers(6, 11))}
        if form == "grid":
            sides = ODD_CELL_SIDES if rng.integers(0, 8) == 0 \
                else CELL_SIDES
            ch, cw = (int(sides[int(rng.integers(0, len(sides)))])
                      for _ in range(2))
            rows, cols = (int(v) for v in rng.integers(1, 5, 2))
            w, h = cw * cols, ch * rows
            if rng.integers(0, 2):
                w = int(rng.integers(max(cw * (cols - 1) - 1, 1), w + 2))
                h = int(rng.integers(max(ch * (rows - 1) - 1, 1), h + 2))
            spec.update(rows=rows, cols=cols, cell=(ch, cw), out=(w, h),
                        alpha=bool(rng.integers(0, 4) == 0),
                        exif=int(rng.integers(1, 9))
                        if rng.integers(0, 3) == 0 else None)
        elif form == "exif":
            spec.update(size=tuple(int(v) for v in rng.integers(1, 97, 2)),
                        orientation=int(rng.integers(0, 10)),
                        little=bool(rng.integers(0, 2)),
                        variant=EXIF_VARIANTS[int(rng.integers(
                            0, len(EXIF_VARIANTS)))],
                        after=bool(rng.integers(0, 2)),
                        pad=int(rng.integers(0, 401)))
        else:
            spec.update(writer=("pillow", "libavif")[int(rng.integers(0, 2))],
                        frames=int(rng.integers(1, 5)),
                        size=tuple(int(v) for v in rng.integers(8, 97, 2)),
                        alpha=bool(rng.integers(0, 4) == 0),
                        edit=SEQUENCE_EDITS[int(rng.integers(
                            0, len(SEQUENCE_EDITS)))])
            if spec["writer"] == "pillow":
                spec.update(depth=8, sub="420" if sub == "400" else sub)
        out.append((form, int(rng.integers(2**31)), spec))
    return out


def _planes(reference, rgb: np.ndarray, depth: int, sub: str, seed: int):
    if depth > 8:
        rgb = reference.widen(rgb, depth, seed)
    return reference.planes_of(rgb, depth, YUV_FORMATS[sub])


def _alpha(reference, h: int, w: int, depth: int, seed: int) -> np.ndarray:
    a = np.random.default_rng(seed + 1).integers(0, 256, (h, w),
                                                dtype=np.uint8)
    return a if depth == 8 else reference.widen(a, depth, seed)


def _tiff(reference, spec: dict) -> bytes:
    return reference.tiff_orientation(spec["orientation"], spec["little"])


def encode_container(reference, form: str, seed: int, spec: dict) -> bytes:
    """The case's file."""
    depth, sub = spec["depth"], spec["sub"]
    enc = {"quality": spec["quality"], "speed": spec["speed"]}
    if form == "grid":
        rows, cols, (ch, cw) = spec["rows"], spec["cols"], spec["cell"]
        rgb = reference.drawing(ch * rows, cw * cols, seed)
        cells = [_planes(reference, np.ascontiguousarray(
            rgb[r * ch:(r + 1) * ch, k * cw:(k + 1) * cw]), depth, sub, seed)
            for r in range(rows) for k in range(cols)]
        alpha = [_alpha(reference, ch, cw, depth, seed + k)
                 for k in range(rows * cols)] if spec["alpha"] else None
        exif = None if spec["exif"] is None else \
            reference.tiff_orientation(spec["exif"])
        try:
            data = reference.avif_grid(cells, cols, rows, depth,
                                       YUV_FORMATS[sub], alpha=alpha,
                                       exif=exif, **enc)
            parts = reference.heif_parts(data)
            if next(it["type"] for it in parts["items"]
                    if it["id"] == parts["primary"]) != b"grid":
                raise RuntimeError("one cell: the encoder writes no grid")
        except RuntimeError:  # the encoder refuses such cells: surgery
            files = [reference.avif_encode(
                p, depth, YUV_FORMATS[sub],
                alpha=None if alpha is None else alpha[k], **enc)
                for k, p in enumerate(cells)]
            data = reference.grid_of_items(files, rows, cols, cw * cols,
                                           ch * rows)
        w, h = spec["out"]
        if (w, h) != (cw * cols, ch * rows):
            data = reference.patch_grid(data, w, h)
        return data
    if form == "exif":
        h, w = spec["size"]
        planes = _planes(reference, reference.drawing(h, w, seed), depth,
                         sub, seed)
        tiff = _tiff(reference, spec)
        data = reference.avif_encode(planes, depth, YUV_FORMATS[sub],
                                     exif=tiff, **enc)
        parts = reference.heif_parts(data)
        item = next(it for it in parts["items"] if it["type"] == b"Exif")
        variant = spec["variant"]
        rng = np.random.default_rng(seed)
        if variant == "prefix":
            item["data"] = b"\0\0\0\x06Exif\0\0" + tiff
        elif variant == "bad_offset":
            item["data"] = int(rng.integers(1, 9)).to_bytes(4, "big") + tiff
        elif variant == "no_tiff":
            item["data"] = b"\0\0\0\0" + tiff[2:]
        elif variant == "short":
            item["data"] = item["data"][:int(rng.integers(0, 9))]
        elif variant == "corrupt":
            body = bytearray(item["data"])
            for _ in range(int(rng.integers(1, 4))):
                body[int(rng.integers(4, len(body)))] = int(
                    rng.integers(0, 256))
            item["data"] = bytes(body)
        elif variant == "xmp":
            parts["items"].append({
                "id": 9, "type": b"mime", "name": b"", "data": b"<x:xmpmeta/>",
                "props": [], "idat": False,
                "content_type": b"application/rdf+xml", "at": 1 << 30})
            parts["refs"].append((b"cdsc", 9, [parts["primary"]]))
        order = [it["id"] for it in sorted(
            parts["items"], key=lambda it: (it["type"] == b"av01")
            != spec["after"])]
        return reference.heif_write(parts, order=order, meta_pad=spec["pad"])
    h, w = spec["size"]
    frames = [reference.drawing(h, w, seed + k) for k in range(spec["frames"])]
    if spec["writer"] == "pillow":
        if spec["alpha"]:
            frames = [np.dstack([f, _alpha(reference, h, w, 8, seed + k)])
                      for k, f in enumerate(frames)]
        data = reference.pillow_avis(frames, min(spec["quality"], 99),
                                     spec["speed"],
                                     sub[0] + ":" + sub[1] + ":" + sub[2])
    else:
        alpha = [_alpha(reference, h, w, depth, seed + k)
                 for k in range(len(frames))] if spec["alpha"] else None
        data = reference.avif_sequence(
            [_planes(reference, f, depth, sub, seed) for f in frames], depth,
            YUV_FORMATS[sub], alpha=alpha, **enc)
    edit = spec["edit"]
    if b"moov" not in dict(reference._children(data, 0, len(data))):
        return data  # one frame: the writers make a still image
    if edit == "idat":
        data = reference.avis_meta(data)
    elif edit == "co64":
        data = reference.to_co64(data)
    elif edit == "no_items":
        data = reference.avis_meta(
            data, lambda p: p["items"].clear() or p["refs"].clear())
    elif edit == "top_exif":
        def add(parts):
            parts["items"].append({
                "id": 9, "type": b"Exif", "name": b"", "idat": True,
                "data": b"\0\0\0\0" + reference.tiff_orientation(6),
                "props": [], "content_type": b""})
            parts["refs"].append((b"cdsc", 9, [parts["primary"]]))
        data = reference.avis_meta(data, add)
    return data


def compare_container(data: bytes, want: np.ndarray | None,
                      plain: bool) -> list:
    """What differs between the port and cv2's pixels `want` (None where
    cv2 returns no image) on one file: "rgb", "plain" (with `plain`),
    "size", or a read where cv2 returns none (raises ValueError where
    the port refuses)."""
    import tempfile

    from multiposenet_tpu_torch.utils import image_io

    got = image_io.decode_image(data)
    if want is None:
        return ["read where cv2 returns none"]
    differ = []
    if got.shape != want.shape or not np.array_equal(got, want):
        differ.append("rgb")
    if plain and not np.array_equal(image_io.decode_image_plain(data), want):
        differ.append("plain")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "x.avif"
        path.write_bytes(data)
        if image_io.image_size(path) != want.shape[:2]:
            differ.append("size")
    return differ


def _run_container(batch: list[tuple], reference: str) -> list:
    """(case, what differs, refusal, whether cv2 returns no image) of
    each container case."""
    module = load_reference(Path(reference))
    out = []
    for case in batch:
        form, seed, spec = case
        data = encode_container(module, form, seed, spec)
        want = module.imdecode_rgb(data)
        none = want is None
        try:
            differ = compare_container(
                data, want, not none and want.size <= 3 * 2 * PLAIN_PIXELS)
            refusal = None
        except ValueError as exc:
            refusal = str(exc)
            differ = [] if none else [f"refused where cv2 reads: {refusal}"]
        out.append((case, differ, refusal, none))
    return out


def search_containers(batch: list[tuple], workers: int = 0,
                      reference: Path = REFERENCE) -> dict:
    """Every container case compared: cases by form, the cases cv2
    returns no image for, the refusals by form, the differences and the
    seconds."""
    t0 = time.perf_counter()
    done = _map(_run_container, batch, workers, reference)
    differences = sorted(([r[0][0], r[0][1], r[0][2]], r[1])
                         for r in done if r[1])
    return {"cases": len(done),
            "cases_by_form": {f: sum(r[0][0] == f for r in done)
                              for f in FORMS},
            "cv2_returns_none": sum(r[3] for r in done),
            "cv2_returns_none_by_form": {
                f: sum(r[3] for r in done if r[0][0] == f) for f in FORMS},
            "refused": sum(r[2] is not None for r in done),
            "differences": [list(d) for d in differences],
            "refused_where_cv2_reads": sum(
                d[0].startswith("refused where") for _, d in differences),
            "read_where_cv2_returns_none": sum(
                d == ["read where cv2 returns none"] for _, d in differences),
            "refusals": {f: sorted({r[2].split(": ", 1)[-1] for r in done
                                    if r[2] and r[0][0] == f})
                         for f in FORMS},
            "seconds": time.perf_counter() - t0}


# --- film grain and segmentation --------------------------------------------

TOOLS = ("grain_test", "grain_test", "grain_dnl", "grain_table",
         "grain_table", "aq")
TOOL_FORMS = ("still", "still", "grid", "sequence")
# The film grain's flags and fields, reached where a frame's header holds
# them (besides the C decoder's grain_frames and grain_blocks).
GRAIN_FLAGS = (
    [f"grain_lag_{k}" for k in range(4)]
    + ["grain_no_luma", "grain_luma_only", "grain_chroma_points",
       "grain_csfl", "grain_overlap", "grain_clip", "grain_clip_identity"]
    + [f"grain_scaling_shift_{k}" for k in range(8, 12)]
    + [f"grain_ar_shift_{k}" for k in range(6, 10)]
    + [f"grain_scale_shift_{k}" for k in range(4)])


def grain_flags(frame) -> dict:
    """GRAIN_FLAGS reached by a frame's film grain (none without)."""
    g, s = frame.header.grain, frame.seq
    out = dict.fromkeys(GRAIN_FLAGS, 0)
    if g is None:
        return out
    out[f"grain_lag_{g.ar_coeff_lag}"] = 1
    out["grain_no_luma"] = int(not g.y_points)
    out["grain_luma_only"] = int(bool(g.y_points) and not (
        g.cb_points or g.cr_points or g.chroma_scaling_from_luma))
    out["grain_chroma_points"] = int(bool(g.cb_points or g.cr_points))
    out["grain_csfl"] = g.chroma_scaling_from_luma
    out["grain_overlap"] = g.overlap
    out["grain_clip"] = g.clip_to_restricted_range
    out["grain_clip_identity"] = int(g.clip_to_restricted_range
                                     and s.matrix == 0)
    out[f"grain_scaling_shift_{g.scaling_shift}"] = 1
    out[f"grain_ar_shift_{g.ar_coeff_shift}"] = 1
    out[f"grain_scale_shift_{g.grain_scale_shift}"] = 1
    return out


def tool_cases(count: int, seed: int = 0) -> list[tuple]:
    """(tool, form, image seed, spec) of `count` seeded files of libaom's
    film grain and segmentation, through the wheel's libavif encoder:
    `film-grain-test` 1 to 16 ("grain_test"), `denoise-noise-level` 5 to
    60 on noisy pictures ("grain_dnl"), a `film-grain-table` of drawn
    parameters (`avif_reference.draw_grain`: every lag, no luma points,
    chroma scaling from luma, overlap, shifts and seeds; "grain_table"),
    as stills, grids and 2- or 3-frame sequences; and `aq-mode=1`
    sequences ("aq", whose first frame libaom segments, at times with
    film grain too). Depths 8, 10 and 12, subsamplings 4:0:0, 4:2:0,
    4:2:2 and 4:4:4, sides 1 to 96 (grid cells 64 to 80), qualities 0 to
    99, speeds 0 to 10, an alpha plane in one case in eight, limited
    range (where libaom's grain clips to it) in one case in three, and
    at 4:4:4 the identity matrix in one case in four."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        tool = TOOLS[i % len(TOOLS)]
        form = "sequence" if tool == "aq" else \
            TOOL_FORMS[int(rng.integers(0, len(TOOL_FORMS)))]
        spec = {"sub": ("400", "420", "422", "444")[int(rng.integers(0, 4))],
                "depth": DEPTHS[int(rng.integers(0, 3))],
                "quality": int(rng.integers(0, 100)),
                "speed": int(rng.integers(0, 11)),
                "size": tuple(int(v) for v in rng.integers(1, 97, 2)),
                "alpha": bool(rng.integers(0, 8) == 0),
                "frames": int(rng.integers(2, 4)),
                "full_range": int(rng.integers(0, 3) > 0)}
        if spec["sub"] == "444" and rng.integers(0, 4) == 0:
            spec["matrix"] = 0  # the identity, where the clip differs
        if form == "grid":
            spec["cell"] = tuple(int(v) for v in rng.integers(64, 81, 2))
            spec["grid"] = tuple(int(v) for v in rng.integers(1, 3, 2))
        if tool == "grain_test" or (tool == "aq" and rng.integers(0, 3) == 0):
            spec["film_grain_test"] = int(rng.integers(1, 17))
        elif tool == "grain_dnl":
            spec["denoise_noise_level"] = int(rng.integers(5, 61))
        elif tool == "grain_table":
            spec["table_seed"] = int(rng.integers(2**31))
        if tool == "aq":
            spec["speed"] = int(rng.integers(0, 7))
        out.append((tool, form, int(rng.integers(2**31)), spec))
    return out


def encode_tool(reference, tool: str, form: str, seed: int, spec: dict,
                scratch: Path) -> bytes:
    """The case's file (`scratch`: a directory for its grain table)."""
    depth, sub = spec["depth"], spec["sub"]
    opts = {"quality": spec["quality"], "speed": spec["speed"],
            "full_range": spec["full_range"], "matrix": spec.get("matrix", 6)}
    for key in ("film_grain_test", "denoise_noise_level"):
        if key in spec:
            opts[key] = spec[key]
    if "table_seed" in spec:
        g = reference.draw_grain(np.random.default_rng(spec["table_seed"]))
        opts["film_grain_table"] = reference.grain_table(
            scratch / f"grain_{seed}.tbl", g)
    if tool == "aq":
        opts["aq_mode"] = 1
    h, w = spec["size"]
    if form == "grid":
        h, w = spec["cell"]
    rng = np.random.default_rng(seed)

    def picture(k):
        rgb = reference.drawing(h, w, seed + k).astype(np.int64)
        noise = 24 if tool == "grain_dnl" else 6
        rgb += rng.integers(-noise, noise + 1, rgb.shape)
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        if depth > 8:
            rgb = reference.widen(rgb, depth, seed)
        return reference.planes_of(rgb, depth, fmt,
                                   full_range=spec["full_range"])

    fmt = YUV_FORMATS[sub]
    alpha = _alpha(reference, h, w, depth, seed) if spec["alpha"] else None
    if form == "grid":
        rows, cols = spec["grid"]
        cells = [picture(k) for k in range(rows * cols)]
        return reference.avif_grid(
            cells, cols, rows, depth, fmt,
            alpha=None if alpha is None else [alpha] * len(cells), **opts)
    if form == "sequence":
        frames = [picture(k) for k in range(spec["frames"])]
        return reference.avif_sequence(
            frames, depth, fmt,
            alpha=None if alpha is None else [alpha] * len(frames), **opts)
    return reference.avif_encode(picture(0), depth, fmt, alpha=alpha, **opts)


def compare_tool(data: bytes, reference, form: str, plain: bool) -> tuple:
    """(what differs, the C decoder's counters, GRAIN_FLAGS reached) of a
    file cv2 reads: the port's RGB against cv2's, and for a still or a
    sequence the C planes before and after the film grain against
    libaom's, and with `plain` the plain decoder's against the C's."""
    from multiposenet_tpu_torch.utils import avif

    image_ = avif.read_image(data)
    differ = []
    if not np.array_equal(avif.decode(data), reference.imdecode_rgb(data)):
        differ.append("rgb")
    cells = [avif.decode_planes_c(f) for f in image_.cells]
    if form != "grid":
        obus = reference.sequence_obus(data) if image_.form == "sequence" \
            else reference.primary_obus(data)
        if not _same(avif.decode_planes_c(image_.frame, grain=False)[:3],
                     reference.aom_planes(obus, skip_film_grain=True)):
            differ.append("planes_before_grain")
        if not _same(cells[0][:3], reference.aom_planes(obus)):
            differ.append("planes")
    if plain and not all(_same(avif.decode_planes_plain(f), c[:3])
                         for f, c in zip(image_.cells, cells)):
        differ.append("plain")
    stats = np.sum([c[3] for c in cells], axis=0)
    flags = [grain_flags(f) for f in image_.cells]
    return differ, stats, {k: max(d[k] for d in flags) for k in GRAIN_FLAGS}


def _run_tools(batch: list[tuple], reference: str) -> list:
    """(case, what differs, counters, grain flags, refusal, whether cv2
    returns no image) of each case; a case whose options the encoder
    refuses has the refusal "encoder: ..." and no file."""
    import tempfile

    module = load_reference(Path(reference))
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for case in batch:
            tool, form, seed, spec = case
            try:
                data = encode_tool(module, tool, form, seed, spec, Path(tmp))
            except RuntimeError as exc:  # the encoder refuses the options
                out.append((case, [], None, None, f"encoder: {exc}", False))
                continue
            none = module.imdecode_rgb(data) is None
            h, w = spec["cell"] if form == "grid" else spec["size"]
            try:
                if none:
                    from multiposenet_tpu_torch.utils import avif
                    avif.decode(data)
                    differ, stats, flags = ["read where cv2 returns none"], \
                        None, None
                else:
                    differ, stats, flags = compare_tool(
                        data, module, form, h * w <= PLAIN_PIXELS)
                    stats = stats.tolist()
                refusal = None
            except ValueError as exc:
                differ, stats, flags = [], None, None
                refusal = str(exc)
                if not none:
                    differ = [f"refused where cv2 reads: {refusal}"]
            out.append((case, differ, stats, flags, refusal, none))
    return out


def search_tools(batch: list[tuple], workers: int = 0,
                 reference: Path = REFERENCE) -> dict:
    """Every film grain and segmentation case compared: the cases by
    tool, form, depth and subsampling, the cases cv2 returns no image
    for, the differences, the refusals, the tools reached (the C
    decoder's counters and GRAIN_FLAGS) and those no case reached, and
    the seconds."""
    t0 = time.perf_counter()
    done = _map(_run_tools, batch, workers, reference)

    def encoder(r):
        return r[4] is not None and r[4].startswith("encoder: ")

    read = [r for r in done if r[2] is not None]
    totals = np.sum([r[2] for r in read], axis=0) if read else \
        np.zeros(len(STAT_NAMES), np.int64)
    reached = {n: int(v) for n, v in zip(STAT_NAMES, totals)
               if n.startswith(("seg", "lossless", "grain"))}
    for k in GRAIN_FLAGS:
        reached[k] = sum(r[3][k] for r in read)
    differences = sorted(([r[0][0], r[0][1], r[0][2], r[0][3]], r[1])
                         for r in done if r[1])

    def count(i):
        return {k: sum(r[0][i] == k for r in done)
                for k in sorted({r[0][i] for r in done})}

    return {"cases": len(done),
            "cases_by_tool": count(0),
            "cases_by_form": count(1),
            "cases_by_depth": {d: sum(r[0][3]["depth"] == d for r in done)
                               for d in DEPTHS},
            "cases_by_subsampling": {
                s: sum(r[0][3]["sub"] == s for r in done)
                for s in ("400",) + SUBSAMPLINGS},
            "encoder_refused": sum(encoder(r) for r in done),
            "cv2_returns_none": sum(r[5] for r in done),
            "refused": sum(r[4] is not None and not encoder(r)
                           for r in done),
            "differences": [list(d) for d in differences],
            "refused_where_cv2_reads": sum(
                d[0].startswith("refused where") for _, d in differences),
            "read_where_cv2_returns_none": sum(
                d == ["read where cv2 returns none"] for _, d in differences),
            "refusals": sorted({r[4] for r in done if r[4]}),
            "tools": reached,
            "tools_not_reached": sorted(k for k, n in reached.items()
                                        if not n),
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
    ap.add_argument("--forms", choices=("still", "container", "tools"),
                    default="still",
                    help="still images (the AV1 tools), the container "
                         "forms (grids, Exif items, image sequences) or "
                         "libaom's film grain and segmentation")
    args = ap.parse_args(argv)
    if args.forms == "tools":
        result = search_tools(tool_cases(args.count, args.seed),
                              args.workers, args.reference)
    elif args.forms == "container":
        result = search_containers(container_cases(args.count, args.seed),
                                   args.workers, args.reference)
    else:
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
