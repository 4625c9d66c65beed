"""AVIF as OpenCV 5.0 reads it through libavif 1.4.2 over libaom 3.14.1
(`grfmt_avif.cpp`: `avifDecoderParse`, `avifDecoderNextImage`, then
`avifImageYUVToRGB` into 8-bit BGR or BGRA at libavif's default chroma
upsampling, or, for a monochrome file, its Y plane narrowed by cv2).

The contract. For every file `cv2.imencode(".avif", img,
[cv2.IMWRITE_AVIF_DEPTH, d, cv2.IMWRITE_AVIF_QUALITY, q,
cv2.IMWRITE_AVIF_SPEED, s])` writes, with `img` of 1, 3 or 4 channels,
uint8 (d 8) or uint16 of values below 2^d (d 10 or 12), at any size cv2
accepts (1x1 up, odd sides, widths over 4096, which libaom splits into
tile columns), `q` from 0 to 100 and `s` from 0 to 10 (any of cv2's
defaults included), and for every file other encoders write in the
forms below (libavif's encoder, Pillow's, video tools, `avifenc`: 4:4:4
lossy and 4:2:2 frames, any colour description, grid images, Exif items,
image sequences), `decode_with_exif(data)` gives the pixels and the Exif
bytes from which `image_io` turns them to `cv2.imdecode(data,
cv2.IMREAD_COLOR)` reversed to RGB, pixel for pixel, and the Y, U and V
planes before the colour conversion (`decode_planes`: uint8 at 8 bits,
uint16 at 10 and 12) equal libaom's; where cv2 returns no image, a
ValueError names the form. What such files use, and what is read here:
- the container (ISOBMFF, `read_container`), walked as libavif's
  avifParse walks it (`_top_level`: box by box until it has an `ftyp`
  naming `avif` or `avis` and the `meta` or `moov` those need): `meta`
  with `hdlr` `pict`, `pitm`, `iloc` (construction methods 0, file
  offsets, and 1, `idat`), `iinf`/`infe`, `iprp` with `ipco` and `ipma`
  (item IDs increasing), and `iref`; every av01 or grid item has an
  `ispe` (alpha items excepted). cv2's AVIF decoder first parses the
  file's first 500 bytes alone (`signature_refusal`): where a read of
  that parse (a grid payload, an Exif or XMP item, the image's first
  bytes where there is no `colr` nclx) starts past byte 500 while the
  boxes it needs lie within them, cv2 returns no image, and the port
  refuses. The picture (libavif's AVIF_DECODER_SOURCE_AUTO): the
  primary item where the major brand is avif, the first sample of the
  colour track of `moov` where it is avis or where another major brand
  comes with a `moov` the walk read. The primary item's properties:
  `av1C` (its configuration OBUs read before the item's), `ispe` (equal
  to the frame's size), `colr` nclx (its colour primaries, transfer
  characteristics, matrix coefficients and range; without one, the AV1
  sequence header's; an ICC `colr` beside it is not applied, as cv2 does
  not apply it; two nclx or two ICC boxes are refused, as libavif
  refuses them), and `irot`, `imir` and `clap`, which cv2 does not apply
  and which are ignored here. An alpha auxiliary item (`auxl`, `auxC`:
  cv2 writes one for 4-channel input) is decoded and dropped, as cv2
  returns no image where it does not decode (and none for a monochrome
  image with one, nor for one of another size);
- grid items (`grid`, `_grid_frames`): the ImageGrid payload (version
  0, 16- or 32-bit output sizes), the `dimg` cells in reference order,
  row by row, checked as libavif 1.4.2 checks them (rows x columns
  cells, one av1C, one size, depth, subsampling, range and colour
  description, the output within the cells' span and past all but the
  last row and column, cells of 64 and more, even output and cell sides
  where the chroma is subsampled, the grid's `ispe` equal to its
  output), each decoded as an item, then stitched and cropped before
  the colour conversion (`stitch`); the grid item's `colr`, else the
  first cell's sequence header; an alpha grid decoded and dropped;
- Exif items (`cdsc` to the primary item, or for a sequence the
  track's own `meta`): the payload after its 4-byte TIFF header offset,
  which must be where libavif finds the header, as cv2 reads the
  orientation from it (`image_io.exif_orientation`);
- image sequences (`moov`/`trak`: `tkhd`, `stsd` av01 with its `av1C`
  and `colr`, `stco`/`co64`, `stsc`, `stsz`; `_sequence_image`): the
  colour track's first sample (a shown key frame; its alpha track's
  first sample decoded and dropped);
- the OBUs (`read_obus`: uleb128 sizes; temporal delimiters, metadata
  and padding skipped), the sequence header and the uncompressed header
  of one shown key frame in full syntax (`SequenceHeader`,
  `FrameHeader`), and the tile groups that follow it;
- the tiles, in the host C library `csrc/av1.c` or, with `plain=True`,
  in its plain twin `utils/av1.py`: profile 0 at 8 or 10 bits (4:2:0 or
  monochrome), profile 1 at 8 or 10 bits (4:4:4) and profile 2 at 8,
  10 or 12 bits (4:2:2; at 12 bits also 4:2:0, monochrome and 4:4:4;
  cv2's 12-bit files disable loop restoration), lossless or lossy, 64x64
  or 128x128 superblocks, every partition, the 13 intra modes with angle
  deltas, edge filtering and upsampling, filter intra, chroma from luma
  (its luma averaged 2x2, 2x1 or not at all), palette (screen content:
  the colour cache, coded and delta-coded colours, the colour-index
  maps), intra block copy (the DV stack, the DV, whole- and half-sample
  copies, the inter transform tree and sets), delta q and delta lf, the
  largest or a selected transform size, the intra transform sets, the
  quantiser matrices, lossless frames (the Walsh-Hadamard transform on
  4x4 blocks), segmentation (each block's segment id, predicted from its
  neighbours' and read before or after its skip flag, its qindex,
  lossless or not, and its deblocking levels by the segment's features;
  a segment id past the last active one is refused, as libaom refuses
  it), then the deblocking filter, CDEF (4x8 chroma blocks at
  4:2:2, their direction mapped through libaom's conv422) and loop
  restoration (Wiener and self-guided units in 64-row stripes offset 8
  rows up), and the film grain libaom adds to the frames it outputs
  (its parameters checked as libaom checks them; the seeded templates,
  the auto-regressive filter, the scaling functions, the 32x32 blocks
  and their overlap, the clip to the full or the restricted range), to
  each still, grid cell and sequence's first frame. A tile whose symbols
  run past its bytes, or that does not end in its trailing bits, or a DV
  that libaom's av1_is_dv_valid rejects, is refused, as libaom reports
  such a frame corrupt;
- libavif's YUV to RGB (`yuv_to_rgb`): for BT.601, BT.709 and BT.2020
  NCL at limited and full range (and chroma-derived NCL of those
  primaries) libyuv's fixed-point constants with its bilinear 4:2:0 and
  linear 4:2:2 upsampling, at 10 and 12 bits after the planes are
  narrowed to 8 (cv2's BGR) or at the depth itself (BGRA, which cv2
  reads where the file has an alpha item: bilinear or linear at 10 bits,
  each chroma sample over its 2x2 pixels at 12-bit 4:2:0); libavif's own
  float32 path for the other matrices it converts (FCC, SMPTE 240M,
  YCgCo, YCgCo-Re at 10 bits, chroma-derived NCL of other primaries, the
  identity at 4:4:4); a monochrome image is its Y plane in each channel,
  rounded to 8 bits as cv2 rounds it, whatever its colour description.

cv2's own files reach most of the AV1 tools (`tools/avif_search.py` lists
what no file reached: the rest is held to libaom's own C functions stage
by stage and on files Pillow's AVIF writer and libavif's encoder make).

What lies outside it is refused by a ValueError that names it, where the
stream uses it: superres (which libavif 1.4.2's encoder refuses to
write), frames other than
one shown key frame, an `ispe` or `tkhd` other than the frame's size
(cv2 returns the frame scaled to it); and, as cv2 returns no image for
them, the colour forms libavif does not convert (`colour_refusal`) and
the container forms libavif's parse or its grid checks refuse.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from dataclasses import dataclass, field

import numpy as np

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.utils.av1 import (SEG_LVL_ALT_Q,
                                              decode_planes_plain)

AVIF_BRANDS = (b"avif", b"avis")


def is_avif(data: bytes) -> bool:
    """An ISOBMFF file whose `ftyp` names `avif` or `avis` as its major
    brand or among its compatible brands (libavif's
    avifPeekCompatibleFileType)."""
    if data[4:8] != b"ftyp" or len(data) < 16:
        return False
    size = int.from_bytes(data[:4], "big")
    end = min(len(data), size) if size >= 16 else 16
    brands = [data[8:12]] + [data[i:i + 4] for i in range(16, end - 3, 4)]
    return any(b in AVIF_BRANDS for b in brands)


# --- the container -----------------------------------------------------------


def _boxes(data: bytes, start: int, end: int):
    """(type, payload start, payload end) of each box in data[start:end]."""
    pos = start
    while pos < end:
        if pos + 8 > end:
            raise ValueError("AVIF: a box header runs past its parent")
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError("AVIF: a box header runs past its parent")
            (size,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            head = 16
        elif size == 0:
            size = end - pos
        if kind == b"uuid":
            head += 16
        if size < head or pos + size > end:
            raise ValueError(f"AVIF: box {kind!r} runs past its parent")
        yield kind, pos + head, pos + size
        pos += size


class _Reader:
    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end

    def u(self, n: int) -> int:
        if self.pos + n > self.end:
            raise ValueError("AVIF: a box ends early")
        v = int.from_bytes(self.data[self.pos:self.pos + n], "big")
        self.pos += n
        return v

    def full(self) -> tuple[int, int]:
        v = self.u(4)
        return v >> 24, v & 0xFFFFFF


@dataclass
class Item:
    id: int
    type: bytes = b""
    extents: list = field(default_factory=list)
    method: int = 0
    base: int = 0
    props: list = field(default_factory=list)
    essential: list = field(default_factory=list)
    content_type: bytes = b""


@dataclass
class Track:
    """What libavif 1.4.2 reads of a `trak` box to find a sequence's first
    frame: its ID and size (`tkhd`), whether it has a sample table, its
    sample entries (`stsd`: format and child boxes), chunk offsets
    (`stco`/`co64`), sample-to-chunk runs (`stsc`), sample sizes
    (`stsz`), the track it is auxiliary to (`tref/auxl`) and its own
    `meta`. (libavif takes the first sample as a sync sample whatever
    `stss` says, and reads no handler.)"""
    id: int = 0
    width: int = 0
    height: int = 0
    table: bool = False
    entries: list = field(default_factory=list)
    chunks: list = field(default_factory=list)
    stsc: list = field(default_factory=list)
    sample_size: int = 0
    sizes: list = field(default_factory=list)
    aux_for: int = 0
    meta: "Container | None" = None


@dataclass
class Container:
    primary: int | None
    items: dict
    properties: list
    idat: bytes
    refs: list
    major: bytes = b""
    brands: tuple = ()
    tracks: list = field(default_factory=list)


# cv2's AvifDecoder::checkSignature hands libavif the file's first
# SIGNATURE_BYTES bytes (its signatureLength) with io->sizeHint set to
# 1e9, and takes the file where avifDecoderParse returns OK or
# AVIF_RESULT_TRUNCATED_DATA; otherwise no decoder claims it.
SIGNATURE_BYTES = 500
SIGNATURE_SIZE_HINT = 10 ** 9


class _Truncated(Exception):
    """Where libavif returns AVIF_RESULT_TRUNCATED_DATA."""


def _top_level(data: bytes, avail: int, size_hint: int) -> tuple:
    """libavif 1.4.2's avifParse over data[:avail] with io->sizeHint
    `size_hint`: the top-level boxes in order until it has an `ftyp`
    and what its brands need (`meta` for avif, `moov` for avis).
    Returns (major brand, brands, meta span, moov span); raises
    _Truncated where a needed box ends past the data, ValueError on
    other failures (a read that starts past the data is libavif's
    AVIF_RESULT_IO_ERROR)."""
    pos = 0
    ftyp = meta = moov = None
    needs_meta = needs_moov = False
    while True:
        if pos > size_hint:
            raise ValueError("AVIF: a box runs past the end of the file")
        if pos > avail:
            raise ValueError("AVIF: a box starts past the data read")
        head = data[pos:min(pos + 32, avail)]
        if not head:
            break
        if len(head) < 8:
            raise ValueError("AVIF: a box header is cut short")
        size, kind = struct.unpack(">I4s", head[:8])
        head_len = 8
        if size == 1:
            if len(head) < 16:
                raise ValueError("AVIF: a box header is cut short")
            (size,) = struct.unpack(">Q", head[8:16])
            head_len = 16
        if kind == b"uuid":
            head_len += 16
            if len(head) < head_len:
                raise ValueError("AVIF: a box header is cut short")
        if size == 0:
            size = size_hint - pos
        elif size < head_len:
            raise ValueError(f"AVIF: box {kind!r} is smaller than its header")
        start, end = pos + head_len, pos + size
        if kind in (b"ftyp", b"meta", b"moov") and end > avail:
            raise _Truncated(kind.decode())
        pos = end
        if kind == b"ftyp":
            if ftyp is not None:
                raise ValueError("AVIF: two ftyp boxes")
            if end - start < 8 or (end - start) % 4:
                raise ValueError("AVIF: a malformed ftyp box")
            brands = (data[start:start + 4],) + tuple(
                data[i:i + 4] for i in range(start + 8, end, 4))
            needs_meta, needs_moov = b"avif" in brands, b"avis" in brands
            if not (needs_meta or needs_moov):
                raise ValueError("AVIF: the ftyp box names neither avif nor "
                                 "avis")
            ftyp = brands
        elif kind == b"meta":
            if meta is not None:
                raise ValueError("AVIF: two meta boxes")
            meta = (start, end)
        elif kind == b"moov":
            if moov is not None:
                raise ValueError("AVIF: two moov boxes")
            moov = (start, end)
        if ftyp and (meta or not needs_meta) and (moov or not needs_moov):
            return ftyp[0], ftyp, meta, moov
    if ftyp is None:
        raise ValueError("AVIF: no ftyp box")
    raise _Truncated("meta" if needs_meta and meta is None else "moov")


def read_container(data: bytes) -> Container:
    """The boxes libavif's avifParse reads (`_top_level`): `ftyp`, the
    file's `meta` (items) and, where it reads that far, `moov` (the
    tracks of an image sequence)."""
    try:
        major, brands, meta, moov = _top_level(data, len(data), len(data))
    except _Truncated as exc:
        brand = "avif" if str(exc) == "meta" else "avis"
        raise ValueError(f"AVIF: no {exc} box (the file ends before the "
                         f"{exc} box its {brand} brand needs)") from None
    c = read_meta(data, *meta) if meta else Container(None, {}, [], b"", [])
    c.major, c.brands = major, brands
    c.tracks = _read_moov(data, *moov) if moov else []
    return c


def read_meta(data: bytes, s: int, e: int) -> Container:
    """A `meta` box's items, properties, `idat` and references; items in
    the order libavif makes them (the first box that names each)."""
    items: dict[int, Item] = {}
    properties: list = []
    idat = b""
    refs: list = []
    primary = None
    handler = None
    for kind, ps, pe in _boxes(data, s + 4, e):
        r = _Reader(data, ps, pe)
        if kind == b"hdlr":
            r.full()
            r.u(4)
            handler = r.u(4).to_bytes(4, "big")
        elif kind == b"pitm":
            version, _ = r.full()
            primary = r.u(2 if version == 0 else 4)
        elif kind == b"iloc":
            _read_iloc(r, items)
        elif kind == b"iinf":
            version, _ = r.full()
            r.u(2 if version == 0 else 4)  # entry_count
            for ik, is_, ie in _boxes(data, r.pos, pe):
                if ik != b"infe":
                    continue
                ir = _Reader(data, is_, ie)
                iv, _ = ir.full()
                if iv < 2:
                    raise ValueError(f"AVIF: infe version {iv} is not read "
                                     "here")
                iid = ir.u(2 if iv == 2 else 4)
                ir.u(2)
                item = items.setdefault(iid, Item(iid))
                item.type = ir.u(4).to_bytes(4, "big")
                if item.type == b"mime":
                    rest = data[ir.pos:ie].split(b"\0")
                    item.content_type = rest[1] if len(rest) > 1 else b""
        elif kind == b"iprp":
            _read_iprp(data, ps, pe, items, properties)
        elif kind == b"idat":
            idat = data[ps:pe]
        elif kind == b"iref":
            version, _ = r.full()
            for rk, rs, re_ in _boxes(data, r.pos, pe):
                rr = _Reader(data, rs, re_)
                src = rr.u(2 if version == 0 else 4)
                n = rr.u(2)
                dst = [rr.u(2 if version == 0 else 4) for _ in range(n)]
                for iid in [src] + dst:
                    items.setdefault(iid, Item(iid))
                refs.append((rk, src, dst))
    if handler != b"pict":
        raise ValueError(f"AVIF: handler {handler!r}, not pict")
    return Container(primary, items, properties, idat, refs)


def _read_moov(data: bytes, s: int, e: int) -> list:
    tracks = []
    for kind, ps, pe in _boxes(data, s, e):
        if kind == b"trak":
            tracks.append(_read_trak(data, ps, pe))
    return tracks


def _read_trak(data: bytes, s: int, e: int) -> Track:
    t = Track()
    for kind, ps, pe in _boxes(data, s, e):
        r = _Reader(data, ps, pe)
        if kind == b"tkhd":
            version, _ = r.full()
            r.u(16 if version == 1 else 8)
            t.id = r.u(4)
            r.u(4)
            r.u(8 if version == 1 else 4)
            r.u(52)
            t.width, t.height = r.u(4) >> 16, r.u(4) >> 16
            if not (t.width and t.height):
                raise ValueError(f"AVIF: track {t.id} of size "
                                 f"{t.width}x{t.height}")
        elif kind == b"meta":
            t.meta = read_meta(data, ps, pe)
        elif kind == b"tref":
            for rk, rs, re_ in _boxes(data, ps, pe):
                if rk == b"auxl" and re_ - rs >= 4:
                    t.aux_for = int.from_bytes(data[rs:rs + 4], "big")
        elif kind == b"mdia":
            for mk, ms, me in _boxes(data, ps, pe):
                if mk == b"minf":
                    for nk, ns, ne in _boxes(data, ms, me):
                        if nk == b"stbl":
                            _read_stbl(data, ns, ne, t)
    return t


def _read_stbl(data: bytes, s: int, e: int, t: Track) -> None:
    t.table = True
    for kind, ps, pe in _boxes(data, s, e):
        r = _Reader(data, ps, pe)
        if kind in (b"stco", b"co64"):
            r.full()
            n = 8 if kind == b"co64" else 4
            t.chunks += [r.u(n) for _ in range(r.u(4))]
        elif kind == b"stsc":
            r.full()
            for _ in range(r.u(4)):
                first, per = r.u(4), r.u(4)
                r.u(4)
                t.stsc.append((first, per))
        elif kind == b"stsz":
            r.full()
            t.sample_size = r.u(4)
            count = r.u(4)
            if not t.sample_size:
                t.sizes = [r.u(4) for _ in range(count)]
        elif kind == b"stsd":
            r.full()
            r.u(4)  # entry_count
            for fk, fs, fe in _boxes(data, r.pos, pe):
                # VisualSampleEntry: 78 bytes before the child boxes.
                kids = [] if fe - fs < 78 else [
                    (k, data[a:b]) for k, a, b in _boxes(data, fs + 78, fe)]
                t.entries.append((fk, kids))


def _read_iloc(r: _Reader, items: dict) -> None:
    version, _ = r.full()
    if version > 2:
        raise ValueError(f"AVIF: iloc version {version}")
    sizes = r.u(2)
    off_size, len_size = sizes >> 12, (sizes >> 8) & 15
    base_size, index_size = (sizes >> 4) & 15, sizes & 15
    count = r.u(2 if version < 2 else 4)
    for _ in range(count):
        iid = r.u(2 if version < 2 else 4)
        item = items.setdefault(iid, Item(iid))
        if version in (1, 2):
            item.method = r.u(2) & 15
        r.u(2)
        item.base = r.u(base_size)
        n = r.u(2)
        item.extents = []
        for _ in range(n):
            if version in (1, 2) and index_size:
                r.u(index_size)
            off = r.u(off_size)
            length = r.u(len_size)
            item.extents.append((off, length))


def _read_iprp(data: bytes, s: int, e: int, items: dict,
               properties: list) -> None:
    for kind, ps, pe in _boxes(data, s, e):
        if kind == b"ipco":
            for pk, qs, qe in _boxes(data, ps, pe):
                properties.append((pk, data[qs:qe]))
        elif kind == b"ipma":
            r = _Reader(data, ps, pe)
            version, flags = r.full()
            last = 0
            for _ in range(r.u(4)):
                iid = r.u(2 if version < 1 else 4)
                if iid <= last:
                    raise ValueError("AVIF: ipma's item IDs are not in "
                                     "increasing order")
                last = iid
                item = items.setdefault(iid, Item(iid))
                for _ in range(r.u(1)):
                    v = r.u(2 if flags & 1 else 1)
                    index = v & (0x7FFF if flags & 1 else 0x7F)
                    if index:
                        item.props.append(index - 1)
                        item.essential.append(bool(v >> (15 if flags & 1
                                                         else 7)))


def item_data(data: bytes, c: Container, item: Item) -> bytes:
    if item.method not in (0, 1):
        raise ValueError(f"AVIF: iloc construction method {item.method}")
    src = data if item.method == 0 else c.idat
    parts = []
    for off, length in item.extents:
        start = item.base + off
        if length == 0:
            length = len(src) - start
        if start < 0 or start + length > len(src):
            raise ValueError("AVIF: an item's extent lies outside the file")
        parts.append(src[start:start + length])
    return b"".join(parts)


def item_properties(c: Container, item: Item) -> dict:
    out = {}
    for index in item.props:
        if index >= len(c.properties):
            raise ValueError("AVIF: ipma names a property ipco lacks")
        kind, payload = c.properties[index]
        out.setdefault(kind, payload)
    return out


# --- OBUs and the bit reader -------------------------------------------------

OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER, OBU_FRAME_HEADER = 1, 2, 3
OBU_TILE_GROUP, OBU_METADATA, OBU_FRAME = 4, 5, 6
OBU_REDUNDANT_FRAME_HEADER, OBU_TILE_LIST, OBU_PADDING = 7, 8, 15


def _leb128(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    for i in range(8):
        if pos >= len(data):
            raise ValueError("AV1: an OBU size runs past the data")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return value, pos
    return value, pos


def read_obus(data: bytes) -> list[tuple[int, bytes]]:
    """(type, payload) of each OBU of a low-overhead bitstream."""
    out, pos = [], 0
    while pos < len(data):
        h = data[pos]
        if h & 0x80:
            raise ValueError("AV1: the forbidden bit of an OBU header is set")
        kind, ext, has_size = (h >> 3) & 15, (h >> 2) & 1, (h >> 1) & 1
        pos += 1 + ext
        if has_size:
            size, pos = _leb128(data, pos)
        else:
            size = len(data) - pos
        if pos + size > len(data):
            raise ValueError("AV1: an OBU runs past the data")
        out.append((kind, data[pos:pos + size]))
        pos += size
    return out


class BitReader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise ValueError("AV1: a header runs past its OBU")
            v = (v << 1) | ((self.data[byte] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        zeros = 0
        while not self.f(1):
            zeros += 1
            if zeros >= 32:
                return (1 << 32) - 1
        return self.f(zeros) + (1 << zeros) - 1

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7


SELECT = 2


@dataclass
class SequenceHeader:
    profile: int = 0
    reduced: int = 0
    timing_info: int = 0
    decoder_model_info: int = 0
    equal_picture_interval: int = 0
    buffer_removal_time_length: int = 0
    frame_presentation_time_length: int = 0
    op_idc: list = field(default_factory=list)
    decoder_model_for_op: list = field(default_factory=list)
    frame_width_bits: int = 0
    frame_height_bits: int = 0
    max_width: int = 0
    max_height: int = 0
    frame_id_numbers: int = 0
    frame_id_length: int = 0
    sb128: int = 0
    filter_intra: int = 0
    intra_edge_filter: int = 0
    order_hint_bits: int = 0
    force_screen_content_tools: int = SELECT
    force_integer_mv: int = SELECT
    superres: int = 0
    cdef: int = 0
    restoration: int = 0
    bit_depth: int = 8
    mono: int = 0
    ssx: int = 1
    ssy: int = 1
    primaries: int = 2
    transfer: int = 2
    matrix: int = 2
    full_range: int = 0
    separate_uv_delta_q: int = 0
    film_grain: int = 0


def parse_sequence_header(payload: bytes) -> SequenceHeader:
    r = BitReader(payload)
    s = SequenceHeader()
    s.profile = r.f(3)
    r.f(1)  # still_picture
    s.reduced = r.f(1)
    if s.reduced:
        s.op_idc = [0]
        s.decoder_model_for_op = [0]
        r.f(5)
    else:
        s.timing_info = r.f(1)
        buffer_delay_length = 0
        if s.timing_info:
            r.f(32)
            r.f(32)
            s.equal_picture_interval = r.f(1)
            if s.equal_picture_interval:
                r.uvlc()
            s.decoder_model_info = r.f(1)
            if s.decoder_model_info:
                buffer_delay_length = r.f(5) + 1
                r.f(32)
                s.buffer_removal_time_length = r.f(5) + 1
                s.frame_presentation_time_length = r.f(5) + 1
        initial_display_delay = r.f(1)
        for _ in range(r.f(5) + 1):
            s.op_idc.append(r.f(12))
            if r.f(5) > 7:
                r.f(1)
            present = 0
            if s.decoder_model_info:
                present = r.f(1)
                if present:
                    r.f(buffer_delay_length)
                    r.f(buffer_delay_length)
                    r.f(1)
            s.decoder_model_for_op.append(present)
            if initial_display_delay and r.f(1):
                r.f(4)
    s.frame_width_bits = r.f(4) + 1
    s.frame_height_bits = r.f(4) + 1
    s.max_width = r.f(s.frame_width_bits) + 1
    s.max_height = r.f(s.frame_height_bits) + 1
    if not s.reduced:
        s.frame_id_numbers = r.f(1)
    if s.frame_id_numbers:
        delta = r.f(4) + 2
        s.frame_id_length = r.f(3) + 1 + delta
    s.sb128 = r.f(1)
    s.filter_intra = r.f(1)
    s.intra_edge_filter = r.f(1)
    if not s.reduced:
        r.f(4)  # interintra, masked compound, warped motion, dual filter
        order_hint = r.f(1)
        if order_hint:
            r.f(2)  # jnt_comp, ref_frame_mvs
        if r.f(1):
            s.force_screen_content_tools = SELECT
        else:
            s.force_screen_content_tools = r.f(1)
        if s.force_screen_content_tools > 0:
            s.force_integer_mv = SELECT if r.f(1) else r.f(1)
        else:
            s.force_integer_mv = SELECT
        if order_hint:
            s.order_hint_bits = r.f(3) + 1
    s.superres = r.f(1)
    s.cdef = r.f(1)
    s.restoration = r.f(1)
    # color_config
    high = r.f(1)
    if s.profile == 2 and high:
        s.bit_depth = 12 if r.f(1) else 10
    else:
        s.bit_depth = 10 if high else 8
    s.mono = 0 if s.profile == 1 else r.f(1)
    if r.f(1):
        s.primaries, s.transfer, s.matrix = r.f(8), r.f(8), r.f(8)
    if s.mono:
        s.full_range = r.f(1)
        s.ssx = s.ssy = 1
    elif s.primaries == 1 and s.transfer == 13 and s.matrix == 0:
        s.full_range = 1
        s.ssx = s.ssy = 0
    else:
        s.full_range = r.f(1)
        if s.profile == 0:
            s.ssx = s.ssy = 1
        elif s.profile == 1:
            s.ssx = s.ssy = 0
        elif s.bit_depth == 12:
            s.ssx = r.f(1)
            s.ssy = r.f(1) if s.ssx else 0
        else:
            s.ssx, s.ssy = 1, 0
        if s.ssx and s.ssy:
            r.f(2)
    if not s.mono:
        s.separate_uv_delta_q = r.f(1)
    s.film_grain = r.f(1)
    return s


def check_sequence(s: SequenceHeader) -> None:
    """The sequence-level refusals. Read: profile 0 at 8 or 10 bits
    (4:2:0, monochrome), profile 1 at 8 or 10 bits (4:4:4) and profile 2
    at 8, 10 or 12 bits (4:2:2; at 12 bits also 4:2:0, monochrome and
    4:4:4), lossless or lossy. Refused: profiles past 2."""
    if s.profile > 2:
        raise ValueError(f"AVIF: AV1 profile {s.profile} is not read here")


@dataclass
class FilmGrain:
    """film_grain_params of a shown key frame whose apply_grain is 1, as
    libaom keeps them (aom_film_grain_t): the AR coefficients and the
    multipliers less 128, the offsets less 256, the shifts with their
    bases added."""
    seed: int = 0
    y_points: tuple = ()  # (value, scaling) pairs
    cb_points: tuple = ()
    cr_points: tuple = ()
    chroma_scaling_from_luma: int = 0
    scaling_shift: int = 8
    ar_coeff_lag: int = 0
    ar_y: tuple = ()
    ar_cb: tuple = ()
    ar_cr: tuple = ()
    ar_coeff_shift: int = 6
    grain_scale_shift: int = 0
    cb_mult: int = 0
    cb_luma_mult: int = 0
    cb_offset: int = 0
    cr_mult: int = 0
    cr_luma_mult: int = 0
    cr_offset: int = 0
    overlap: int = 0
    clip_to_restricted_range: int = 0


# Segmentation_Feature_Bits, _Signed and _Max: SEG_LVL_ALT_Q, the four
# SEG_LVL_ALT_LF_*, SEG_LVL_REF_FRAME, SEG_LVL_SKIP, SEG_LVL_GLOBALMV.
SEG_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_MAX = (255, 63, 63, 63, 63, 7, 0, 0)
SEG_LVL_REF_FRAME = 5  # features from here on are read before the skip flag


@dataclass
class FrameHeader:
    width: int = 0
    height: int = 0
    disable_cdf_update: int = 0
    screen_content: int = 0
    allow_intrabc: int = 0
    tile_cols: int = 1
    tile_rows: int = 1
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    col_starts: list = field(default_factory=list)
    row_starts: list = field(default_factory=list)
    tile_size_bytes: int = 4
    base_q: int = 0
    dq: tuple = (0, 0, 0, 0, 0)  # y dc, u dc, u ac, v dc, v ac
    using_qm: int = 0
    qm: tuple = (15, 15, 15)
    delta_q_present: int = 0
    delta_q_res: int = 0
    delta_lf_present: int = 0
    delta_lf_res: int = 0
    delta_lf_multi: int = 0
    lf_level: tuple = (0, 0, 0, 0)
    lf_sharpness: int = 0
    lf_delta_enabled: int = 0
    lf_ref_deltas: tuple = (1, 0, 0, 0, -1, 0, -1, -1)
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y: tuple = ((0, 0),)
    cdef_uv: tuple = ((0, 0),)
    lossless: int = 0  # CodedLossless (and AllLossless: no superres)
    # segmentation_params: each segment's feature mask (bit j: feature
    # j, SEG_LVL_ALT_Q .. SEG_LVL_GLOBALMV) and data, LastActiveSegId,
    # SegIdPreSkip, and per segment get_qindex(1, segment) and
    # LosslessArray
    segmentation: int = 0
    seg_mask: tuple = (0,) * 8
    seg_data: tuple = ((0,) * 8,) * 8
    seg_last_active: int = 0
    seg_preskip: int = 0
    seg_qindex: tuple = (0,) * 8
    seg_lossless: tuple = (0,) * 8
    grain: FilmGrain | None = None  # film_grain_params with apply_grain
    lr_type: tuple = (0, 0, 0)  # RESTORE_NONE, _WIENER, _SGRPROJ, _SWITCHABLE
    lr_unit_size: tuple = (256, 256, 256)
    tx_mode_select: int = 0
    reduced_tx_set: int = 0
    header_bytes: int = 0


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def parse_frame_header(payload: bytes, s: SequenceHeader) -> FrameHeader:
    """The uncompressed header of a shown key frame; refusals where the
    frame uses what this decoder does not follow."""
    r = BitReader(payload)
    h = FrameHeader()
    if not s.reduced:
        if r.f(1):
            raise ValueError("AVIF: a frame shown again (show_existing_frame)"
                             " is not read here")
        frame_type = r.f(2)
        show_frame = r.f(1)
        if frame_type != 0 or not show_frame:
            raise ValueError("AVIF: only a shown key frame is read here "
                             f"(frame type {frame_type})")
        if s.decoder_model_info and not s.equal_picture_interval:
            r.f(s.frame_presentation_time_length)
    h.disable_cdf_update = r.f(1)
    if s.force_screen_content_tools == SELECT:
        h.screen_content = r.f(1)
    else:
        h.screen_content = s.force_screen_content_tools
    if h.screen_content and s.force_integer_mv == SELECT:
        r.f(1)
    if s.frame_id_numbers:
        r.f(s.frame_id_length)
    override = 0 if s.reduced else r.f(1)
    r.f(s.order_hint_bits)
    if s.decoder_model_info:
        if r.f(1):
            for idc, present in zip(s.op_idc, s.decoder_model_for_op):
                if present and (idc == 0 or ((idc & 1) and (idc >> 8) & 1)):
                    r.f(s.buffer_removal_time_length)
    if override:
        h.width = r.f(s.frame_width_bits) + 1
        h.height = r.f(s.frame_height_bits) + 1
    else:
        h.width, h.height = s.max_width, s.max_height
    if s.superres and r.f(1):
        raise ValueError("AVIF: superres is not read here")
    if r.f(1):  # render_and_frame_size_different
        r.f(16)
        r.f(16)
    if h.screen_content:
        h.allow_intrabc = r.f(1)
    if not (s.reduced or h.disable_cdf_update):
        r.f(1)  # disable_frame_end_update_cdf
    mi_cols = 2 * ((h.width + 7) >> 3)
    mi_rows = 2 * ((h.height + 7) >> 3)
    _tile_info(r, h, mi_cols, mi_rows, 5 if s.sb128 else 4)
    # quantization_params
    h.base_q = r.f(8)

    def delta():
        return r.su(7) if r.f(1) else 0

    y_dc = delta()
    u_dc = u_ac = v_dc = v_ac = 0
    if not s.mono:
        diff_uv = r.f(1) if s.separate_uv_delta_q else 0
        u_dc, u_ac = delta(), delta()
        v_dc, v_ac = (delta(), delta()) if diff_uv else (u_dc, u_ac)
    h.dq = (y_dc, u_dc, u_ac, v_dc, v_ac)
    h.using_qm = r.f(1)
    if h.using_qm:
        qy, qu = r.f(4), r.f(4)
        qv = r.f(4) if s.separate_uv_delta_q else qu
        h.qm = (qy, qu, qv)
    if r.f(1):
        _segmentation_params(r, h)
    if h.base_q > 0:
        h.delta_q_present = r.f(1)
        if h.delta_q_present:
            h.delta_q_res = r.f(2)
    if h.delta_q_present and not h.allow_intrabc:
        h.delta_lf_present = r.f(1)
        if h.delta_lf_present:
            h.delta_lf_res = r.f(2)
            h.delta_lf_multi = r.f(1)
    qindex = []
    for i in range(8):
        q = h.base_q
        if h.seg_mask[i] & (1 << SEG_LVL_ALT_Q):
            q = min(max(q + h.seg_data[i][SEG_LVL_ALT_Q], 0), 255)
        qindex.append(q)
    h.seg_qindex = tuple(qindex)
    h.seg_lossless = tuple(int(q == 0 and not any(h.dq)) for q in qindex)
    h.lossless = int(all(h.seg_lossless) if h.segmentation
                     else h.seg_lossless[0])
    if not (h.lossless or h.allow_intrabc):
        _loop_filter_params(r, h, s)
    if s.cdef and not (h.lossless or h.allow_intrabc):
        _cdef_params(r, h, s)
    if s.restoration and not (h.lossless or h.allow_intrabc):
        _lr_params(r, h, s)
    h.tx_mode_select = 0 if h.lossless else r.f(1)
    h.reduced_tx_set = r.f(1)
    if s.film_grain and r.f(1):
        h.grain = _film_grain_params(r, s)
    r.byte_align()
    h.header_bytes = r.pos >> 3
    return h


def _segmentation_params(r: BitReader, h: FrameHeader) -> None:
    """segmentation_params of a key frame (primary_ref_frame none: the
    map and the data are both coded), as libaom's setup_segmentation
    reads them."""
    h.segmentation = 1
    mask, data = [0] * 8, [[0] * 8 for _ in range(8)]
    for i in range(8):
        for j in range(8):
            if not r.f(1):
                continue
            mask[i] |= 1 << j
            if SEG_SIGNED[j]:
                v = r.su(1 + SEG_BITS[j])
            else:
                v = r.f(SEG_BITS[j])
            data[i][j] = min(max(v, -SEG_MAX[j]), SEG_MAX[j])
            h.seg_last_active = i
            if j >= SEG_LVL_REF_FRAME:
                h.seg_preskip = 1
    h.seg_mask = tuple(mask)
    h.seg_data = tuple(tuple(d) for d in data)


def _grain_points(r: BitReader, n: int, most: int, which: str) -> tuple:
    """num_*_points (at most `most`, as libaom refuses more) scaling
    points, their values increasing (libaom refuses others)."""
    if n > most:
        raise ValueError(f"AVIF: film grain: {n} {which} scaling points "
                         f"(libaom refuses more than {most})")
    points = []
    for i in range(n):
        x = r.f(8)
        if i and points[-1][0] >= x:
            raise ValueError(f"AVIF: film grain: the {which} scaling points "
                             "do not increase (libaom refuses them)")
        points.append((x, r.f(8)))
    return tuple(points)


def _film_grain_params(r: BitReader, s: SequenceHeader) -> FilmGrain:
    """film_grain_params after apply_grain 1 in a shown key frame
    (update_grain implied), as libaom's read_film_grain_params reads and
    checks them."""
    g = FilmGrain(seed=r.f(16))
    g.y_points = _grain_points(r, r.f(4), 14, "luma")
    g.chroma_scaling_from_luma = 0 if s.mono else r.f(1)
    if not (s.mono or g.chroma_scaling_from_luma
            or (s.ssx and s.ssy and not g.y_points)):
        g.cb_points = _grain_points(r, r.f(4), 10, "Cb")
        g.cr_points = _grain_points(r, r.f(4), 10, "Cr")
        if s.ssx and s.ssy and bool(g.cb_points) != bool(g.cr_points):
            raise ValueError("AVIF: film grain on one chroma plane of a "
                             "4:2:0 frame (libaom refuses it)")
    g.scaling_shift = r.f(2) + 8
    g.ar_coeff_lag = r.f(2)
    n = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1)
    if g.y_points:
        g.ar_y = tuple(r.f(8) - 128 for _ in range(n))
    n_chroma = n + (1 if g.y_points else 0)
    if g.cb_points or g.chroma_scaling_from_luma:
        g.ar_cb = tuple(r.f(8) - 128 for _ in range(n_chroma))
    if g.cr_points or g.chroma_scaling_from_luma:
        g.ar_cr = tuple(r.f(8) - 128 for _ in range(n_chroma))
    g.ar_coeff_shift = r.f(2) + 6
    g.grain_scale_shift = r.f(2)
    if g.cb_points:
        g.cb_mult, g.cb_luma_mult = r.f(8) - 128, r.f(8) - 128
        g.cb_offset = r.f(9) - 256
    if g.cr_points:
        g.cr_mult, g.cr_luma_mult = r.f(8) - 128, r.f(8) - 128
        g.cr_offset = r.f(9) - 256
    g.overlap = r.f(1)
    g.clip_to_restricted_range = r.f(1)
    return g


def _loop_filter_params(r: BitReader, h: FrameHeader,
                        s: SequenceHeader) -> None:
    l0, l1 = r.f(6), r.f(6)
    l2 = l3 = 0
    if not s.mono and (l0 or l1):
        l2, l3 = r.f(6), r.f(6)
    h.lf_level = (l0, l1, l2, l3)
    h.lf_sharpness = r.f(3)
    h.lf_delta_enabled = r.f(1)
    if h.lf_delta_enabled and r.f(1):
        ref = list(h.lf_ref_deltas)
        for i in range(8):
            if r.f(1):
                ref[i] = r.su(7)
        h.lf_ref_deltas = tuple(ref)
        for _ in range(2):
            if r.f(1):
                r.su(7)  # mode deltas: inter blocks only


def _cdef_params(r: BitReader, h: FrameHeader, s: SequenceHeader) -> None:
    h.cdef_damping = r.f(2) + 3
    h.cdef_bits = r.f(2)
    ys, uvs = [], []
    for _ in range(1 << h.cdef_bits):
        p, sec = r.f(4), r.f(2)
        ys.append((p, sec + (sec == 3)))
        if not s.mono:
            p, sec = r.f(4), r.f(2)
            uvs.append((p, sec + (sec == 3)))
        else:
            uvs.append((0, 0))
    h.cdef_y, h.cdef_uv = tuple(ys), tuple(uvs)


# lr_type's 2 bits to RESTORE_NONE (0), _WIENER (1), _SGRPROJ (2) and
# _SWITCHABLE (3), as libaom numbers them.
LR_TYPES = (0, 3, 1, 2)


def _lr_params(r: BitReader, h: FrameHeader, s: SequenceHeader) -> None:
    types = [LR_TYPES[r.f(2)] for _ in range(1 if s.mono else 3)]
    h.lr_type = tuple(types + [0] * (3 - len(types)))
    if not any(types):
        return
    size = (128 if s.sb128 else 64) << r.f(1)
    if size > 64 and not s.sb128:
        size <<= r.f(1)
    uv = size
    if not s.mono and s.ssx and s.ssy and any(types[1:]):
        uv = size >> r.f(1)
    h.lr_unit_size = (size, uv, uv)


def _tile_info(r: BitReader, h: FrameHeader, mi_cols: int, mi_rows: int,
               sb_shift: int) -> None:
    """tile_info at superblocks of 2^sb_shift 4x4 units a side."""
    sb_cols = (mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (mi_rows + (1 << sb_shift) - 1) >> sb_shift
    max_tile_width_sb = 4096 >> (sb_shift + 2)
    max_tile_area_sb = (4096 * 2304) >> (2 * (sb_shift + 2))
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2 = max(min_log2_cols, _tile_log2(max_tile_area_sb,
                                             sb_rows * sb_cols))
    cols, rows = [], []
    if r.f(1):  # uniform_tile_spacing_flag
        h.tile_cols_log2 = min_log2_cols
        while h.tile_cols_log2 < max_log2_cols and r.f(1):
            h.tile_cols_log2 += 1
        w = (sb_cols + (1 << h.tile_cols_log2) - 1) >> h.tile_cols_log2
        cols = [sb << sb_shift for sb in range(0, sb_cols, w)]
        h.tile_rows_log2 = max(min_log2 - h.tile_cols_log2, 0)
        while h.tile_rows_log2 < max_log2_rows and r.f(1):
            h.tile_rows_log2 += 1
        th = (sb_rows + (1 << h.tile_rows_log2) - 1) >> h.tile_rows_log2
        rows = [sb << sb_shift for sb in range(0, sb_rows, th)]
    else:
        widest, start = 0, 0
        while start < sb_cols:
            cols.append(start << sb_shift)
            size = r.ns(min(sb_cols - start, max_tile_width_sb)) + 1
            widest = max(widest, size)
            start += size
        h.tile_cols_log2 = _tile_log2(1, len(cols))
        area = (sb_rows * sb_cols) >> (min_log2 + 1) if min_log2 > 0 \
            else sb_rows * sb_cols
        max_height = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            rows.append(start << sb_shift)
            start += r.ns(min(sb_rows - start, max_height)) + 1
        h.tile_rows_log2 = _tile_log2(1, len(rows))
    h.tile_cols, h.tile_rows = len(cols), len(rows)
    if h.tile_cols > 64 or h.tile_rows > 64:
        raise ValueError("AV1: more than 64 tile columns or rows")
    h.col_starts = cols + [mi_cols]
    h.row_starts = rows + [mi_rows]
    if h.tile_cols_log2 or h.tile_rows_log2:
        r.f(h.tile_rows_log2 + h.tile_cols_log2)  # context_update_tile_id
        h.tile_size_bytes = r.f(2) + 1


def tile_ranges(h: FrameHeader, groups: list[bytes]) -> tuple[bytes, list]:
    """The tile groups' bytes joined, and (offset, size) of each tile in
    raster order."""
    n = h.tile_cols * h.tile_rows
    tiles: list = [None] * n
    data = b""
    for g in groups:
        r = BitReader(g)
        start, end = 0, n - 1
        if n > 1 and r.f(1):
            bits = h.tile_cols_log2 + h.tile_rows_log2
            start, end = r.f(bits), r.f(bits)
        r.byte_align()
        pos = r.pos >> 3
        for t in range(start, end + 1):
            if t >= n or tiles[t] is not None:
                raise ValueError("AV1: a tile group names a tile twice or "
                                 "one past the grid")
            if t == end:
                size = len(g) - pos
            else:
                if pos + h.tile_size_bytes > len(g):
                    raise ValueError("AV1: a tile size runs past its OBU")
                size = int.from_bytes(g[pos:pos + h.tile_size_bytes],
                                      "little") + 1
                pos += h.tile_size_bytes
            if size <= 0 or pos + size > len(g):
                raise ValueError("AV1: a tile runs past its OBU")
            tiles[t] = (len(data) + pos, size)
            pos += size
        data += g
    if any(t is None for t in tiles):
        raise ValueError("AV1: the frame's tile groups leave tiles out")
    return data, tiles


@dataclass
class Frame:
    seq: SequenceHeader
    header: FrameHeader
    data: bytes
    tiles: list


def read_frame(obus: bytes, config_obus: bytes = b"") -> Frame:
    """The sequence header, the key frame's header and its tiles."""
    seq = None
    header = None
    groups: list[bytes] = []
    for kind, payload in read_obus(config_obus) + read_obus(obus):
        if kind == OBU_SEQUENCE_HEADER:
            if seq is None or header is None:
                seq = parse_sequence_header(payload)
                check_sequence(seq)
        elif kind in (OBU_FRAME_HEADER, OBU_FRAME):
            if header is not None:
                if kind == OBU_FRAME_HEADER:
                    continue
                break
            if seq is None:
                raise ValueError("AV1: a frame before its sequence header")
            header = parse_frame_header(payload, seq)
            if kind == OBU_FRAME:
                groups.append(payload[header.header_bytes:])
        elif kind == OBU_TILE_GROUP:
            if header is None:
                raise ValueError("AV1: a tile group before its frame header")
            groups.append(payload)
        if header is not None and groups and _complete(header, groups):
            break
    if header is None:
        raise ValueError("AVIF: the item holds no frame")
    data, tiles = tile_ranges(header, groups)
    return Frame(seq, header, data, tiles)


def _complete(h: FrameHeader, groups: list[bytes]) -> bool:
    try:
        tile_ranges(h, groups)
        return True
    except ValueError:
        return False


# --- the tile decoder (host C) -----------------------------------------------

NSTATS = 19 + 16 + 13 + 14 + 5 + 7 + 11 + 10 + 12 + 21
STAT_NAMES = (
    [f"tx_size_{n}" for n in ("4x4", "8x8", "16x16", "32x32", "64x64",
                              "4x8", "8x4", "8x16", "16x8", "16x32", "32x16",
                              "32x64", "64x32", "4x16", "16x4", "8x32",
                              "32x8", "16x64", "64x16")]
    + [f"tx_type_{i}" for i in range(16)]
    + [f"y_mode_{i}" for i in range(13)]
    + [f"uv_mode_{i}" for i in range(14)]
    + [f"filter_intra_{i}" for i in range(5)]
    + [f"angle_delta_{i - 3}" for i in range(7)]
    + ["edge_upsample", "edge_filter", "tx_depth", "delta_q", "delta_lf",
       "tiles", "blocks", "eob_max", "golomb", "cdef_blocks", "lf_edges"]
    + [f"partition_{i}" for i in range(10)]
    + ["palette_y", "palette_uv", "palette_cache", "palette_delta_v",
       "lossless_blocks", "lr_none", "lr_wiener", "lr_sgrproj",
       "lr_switchable", "intrabc_blocks", "intrabc_halfpel", "vartx_splits",
       "segmented_frames"]
    + [f"segment_{i}" for i in range(8)]
    + [f"seg_feature_{n}" for n in ("alt_q", "alt_lf_y_v", "alt_lf_y_h",
                                    "alt_lf_u", "alt_lf_v", "ref_frame",
                                    "skip", "globalmv")]
    + ["seg_id_predicted", "lossless_segment_blocks", "grain_frames",
       "grain_blocks"])
# csrc/av1.c's AV1_SSX .. AV1_TILES.
PLAN_SSX, PLAN_NO_CDEF, PLAN_LR_TYPE, PLAN_LR_UNIT = 75, 79, 80, 83
PLAN_SB128, PLAN_NO_LR, PLAN_BIT_DEPTH = 86, 87, 88
PLAN_SEG, PLAN_SEG_DATA, PLAN_SEG_LOSSLESS = 89, 100, 164
PLAN_SEG_QINDEX = 172
PLAN_COL_STARTS = 180
PLAN_ROW_STARTS = PLAN_COL_STARTS + 65
PLAN_TILES = PLAN_ROW_STARTS + 65
_ERR_LEN = 256


@functools.cache
def library() -> ctypes.CDLL:
    """The host C library csrc/av1.c, built on first use."""
    lib = kernels.load_host("av1")
    i32p = ctypes.POINTER(ctypes.c_int32)
    vp = ctypes.c_void_p
    lib.av1_decode_frame.argtypes = [i32p, ctypes.c_char_p, ctypes.c_long,
                                     vp, vp, vp, i32p, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.av1_decode_frame.restype = ctypes.c_int
    lib.av1_film_grain.argtypes = [i32p, vp, vp, vp] + [ctypes.c_int] * 6 \
        + [i32p]
    lib.av1_film_grain.restype = ctypes.c_int
    return lib


def plan(frame: Frame, cdef: bool = True,
         restoration: bool = True) -> np.ndarray:
    """The int32 plan `av1_decode_frame` reads (csrc/av1.c's AV1_*);
    without `cdef`, it returns the deblocked frame (before CDEF and loop
    restoration), without `restoration` the frame before loop
    restoration."""
    s, h = frame.seq, frame.header
    enable_cdef = s.cdef and not (h.lossless or h.allow_intrabc)
    head = [h.width, h.height, s.mono, s.filter_intra, s.intra_edge_filter,
            enable_cdef, h.screen_content, h.disable_cdf_update, h.base_q,
            *h.dq, h.using_qm, *h.qm, h.delta_q_present, h.delta_q_res,
            h.delta_lf_present, h.delta_lf_res, h.delta_lf_multi,
            *h.lf_level, h.lf_sharpness, h.lf_delta_enabled,
            *h.lf_ref_deltas, h.cdef_damping, h.cdef_bits]
    strengths = np.zeros((4, 8), np.int32)
    for i, ((yp, ys), (up, us)) in enumerate(zip(h.cdef_y, h.cdef_uv)):
        strengths[:, i] = (yp, ys, up, us)
    head += strengths.ravel().tolist()
    head += [h.tx_mode_select, h.reduced_tx_set, h.tile_cols, h.tile_rows,
             s.ssx, s.ssy, h.lossless, h.allow_intrabc]
    out = np.zeros(PLAN_TILES + 2 * len(frame.tiles), np.int32)
    out[:len(head)] = head
    out[PLAN_NO_CDEF] = 0 if cdef else 1
    out[PLAN_LR_TYPE:PLAN_LR_TYPE + 3] = h.lr_type
    out[PLAN_LR_UNIT:PLAN_LR_UNIT + 3] = h.lr_unit_size
    out[PLAN_SB128] = s.sb128
    out[PLAN_NO_LR] = 0 if restoration else 1
    out[PLAN_BIT_DEPTH] = s.bit_depth
    out[PLAN_SEG:PLAN_SEG + 3] = (h.segmentation, h.seg_preskip,
                                  h.seg_last_active)
    out[PLAN_SEG + 3:PLAN_SEG_DATA] = h.seg_mask
    out[PLAN_SEG_DATA:PLAN_SEG_LOSSLESS] = np.array(h.seg_data).ravel()
    out[PLAN_SEG_LOSSLESS:PLAN_SEG_QINDEX] = h.seg_lossless
    out[PLAN_SEG_QINDEX:PLAN_SEG_QINDEX + 8] = h.seg_qindex
    out[PLAN_COL_STARTS:PLAN_COL_STARTS + len(h.col_starts)] = h.col_starts
    out[PLAN_ROW_STARTS:PLAN_ROW_STARTS + len(h.row_starts)] = h.row_starts
    out[PLAN_TILES:] = np.array(frame.tiles, np.int64).ravel()
    return out


# csrc/av1.c's G_* (the film grain parameters).
GRAIN_PLAN_SIZE = 160


def grain_plan(g: FilmGrain, mc_identity: int) -> np.ndarray:
    """The int32 parameters `av1_film_grain` reads (csrc/av1.c's G_*)."""
    out = np.zeros(GRAIN_PLAN_SIZE, np.int32)
    at = 0

    def put(values, room=None):
        nonlocal at
        values = list(values)
        out[at:at + len(values)] = values
        at += len(values) if room is None else room

    put([g.seed])
    for points, most in ((g.y_points, 14), (g.cb_points, 10),
                         (g.cr_points, 10)):
        put([len(points)])
        put([v for pt in points for v in pt], 2 * most)
    put([g.chroma_scaling_from_luma, g.scaling_shift, g.ar_coeff_lag])
    put(g.ar_y, 24)
    put(g.ar_cb, 25)
    put(g.ar_cr, 25)
    put([g.ar_coeff_shift, g.grain_scale_shift, g.cb_mult, g.cb_luma_mult,
         g.cb_offset, g.cr_mult, g.cr_luma_mult, g.cr_offset, g.overlap,
         g.clip_to_restricted_range, mc_identity])
    assert at == GRAIN_PLAN_SIZE
    return out


def film_grain_c(frame: Frame, y: np.ndarray, u: np.ndarray,
                 v: np.ndarray, stats: np.ndarray | None = None) -> None:
    """Adds the frame's film grain to its output planes in place through
    the host C library (`av1_film_grain`; U and V are allocated, unused,
    for a monochrome stream), counting into `stats`."""
    h, s = frame.header, frame.seq
    i32p = ctypes.POINTER(ctypes.c_int32)
    g = grain_plan(h.grain, int(s.matrix == 0))
    if stats is None:
        stats = np.zeros(NSTATS, np.int32)
    if library().av1_film_grain(
            g.ctypes.data_as(i32p), y.ctypes.data, u.ctypes.data,
            v.ctypes.data, h.width, h.height, s.ssx, s.ssy, s.mono,
            s.bit_depth, stats.ctypes.data_as(i32p)):
        raise MemoryError("AV1: out of memory")


def decode_planes_c(frame: Frame, cdef: bool = True,
                    restoration: bool = True, grain: bool = True):
    """(Y, U, V, stats) of the frame through the host C library, its film
    grain added; U and V are None for a monochrome stream. The planes
    are uint8 at 8 bits, else uint16 at the stream's depth. Without
    `cdef`, the deblocked planes, before CDEF and loop restoration;
    without `restoration`, the planes before loop restoration; without
    `grain`, the planes before the film grain (stages for the tests)."""
    h, s = frame.header, frame.seq
    dtype = np.uint8 if s.bit_depth == 8 else np.uint16
    y = np.empty((h.height, h.width), dtype)
    cw, ch = (h.width + s.ssx) >> s.ssx, (h.height + s.ssy) >> s.ssy
    u = np.empty((ch, cw), dtype)
    v = np.empty((ch, cw), dtype)
    stats = np.zeros(NSTATS, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    p = plan(frame, cdef, restoration)
    rc = library().av1_decode_frame(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), frame.data,
        len(frame.data), y.ctypes.data, u.ctypes.data, v.ctypes.data,
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), err, _ERR_LEN)
    if rc == 2:
        raise MemoryError(err.value.decode())
    if rc:
        raise ValueError(err.value.decode())
    if grain and cdef and restoration and h.grain is not None:
        film_grain_c(frame, y, u, v, stats)
    if frame.seq.mono:
        return y, None, None, stats
    return y, u, v, stats


# --- libavif's YUV to RGB ----------------------------------------------------

# libyuv's YuvConstants as libavif 1.4.2 carries them: the U and V weights
# of B, G and R, Y's gain and bias (x86 layout: kUVToB[0], kUVToG[0],
# kUVToG[1], kUVToR[1], kYToRgb[0], kYBiasToRgb[0]).
LIBYUV_CONSTANTS = {
    "I601": (128, 25, 52, 102, 18997, -1160),
    "JPEG": (113, 22, 46, 90, 16320, 32),
    "H709": (128, 14, 34, 115, 18997, -1160),
    "F709": (119, 12, 30, 101, 16320, 32),
    "2020": (128, 12, 42, 107, 19003, -1160),
    "V2020": (120, 11, 37, 94, 16320, 32),
}
# libavif's getLibYUVConstants: (family, full range) to the constants, the
# family by matrix coefficients, or for chroma-derived NCL (12) by colour
# primaries; every other matrix goes to libavif's own float path.
LIBYUV_NAMES = {("601", 0): "I601", ("601", 1): "JPEG", ("709", 0): "H709",
                ("709", 1): "F709", ("2020", 0): "2020", ("2020", 1): "V2020"}
LIBYUV_MATRICES = {1: "709", 2: "601", 5: "601", 6: "601", 9: "2020"}
LIBYUV_PRIMARIES = {1: "709", 2: "709", 5: "601", 6: "601", 9: "2020"}
# avifCalcYUVCoefficients's Kr and Kb (float32) by matrix coefficients;
# any other matrix takes BT.601's.
KR_KB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 5: (0.299, 0.114),
         6: (0.299, 0.114), 7: (0.212, 0.087), 9: (0.2627, 0.0593)}
# avifColorPrimariesTables (float32): red, green, blue and white x and y
# by colour primaries; any other value takes BT.709's.
PRIMARIES = {
    1: (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.329),
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290),
}
MATRIX_NAMES = {0: "identity", 1: "BT.709", 2: "unspecified", 3: "reserved",
                4: "FCC", 5: "BT.470BG", 6: "BT.601", 7: "SMPTE 240M",
                8: "YCgCo", 9: "BT.2020 NCL", 10: "BT.2020 CL",
                11: "SMPTE 2085", 12: "chroma-derived NCL",
                13: "chroma-derived CL", 14: "ICtCp", 15: "IPT-C2",
                16: "YCgCo-Re", 17: "YCgCo-Ro"}
_F32 = np.float32


def colour_refusal(matrix: int, full_range: int, ssx: int, ssy: int,
                   depth: int) -> str | None:
    """Why libavif 1.4.2 refuses to convert planes of this colour
    description to RGB (avifGetYUVColorSpaceInfo; cv2 then returns no
    image), or None where it converts them."""
    name = f"matrix coefficients {matrix} " \
        f"({MATRIX_NAMES.get(matrix, 'reserved')})"
    if matrix == 3 or matrix >= 18 or matrix in (10, 11, 13, 14, 17):
        return f"{name} are not converted to RGB"
    if matrix == 0 and (ssx or ssy):
        return f"{name} needs 4:4:4"
    if matrix == 8 and not full_range:
        return f"{name} at limited range is not converted to RGB"
    if matrix == 16 and not (full_range and depth == 10):
        return f"{name} is converted at full range and 10 bits only"
    return None


def _up2_linear(c: np.ndarray, width: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear_Any_C (or _16) on each row of c."""
    c = c.astype(np.int32)
    out = np.empty(c.shape[:-1] + (width,), np.int32)
    out[..., 0] = c[..., 0]
    n = (width - 1) // 2
    if n:
        a, b = c[..., :n], c[..., 1:n + 1]
        out[..., 1:2 * n:2] = (3 * a + b + 2) >> 2
        out[..., 2:2 * n + 1:2] = (a + 3 * b + 2) >> 2
    out[..., width - 1] = c[..., (width - 1) // 2]
    return out


def _up2_bilinear(s: np.ndarray, t: np.ndarray, width: int):
    """libyuv's ScaleRowUp2_Bilinear_Any_C: the rows nearer s and t."""
    d = np.empty(s.shape[:-1] + (width,), np.int32)
    e = np.empty_like(d)
    d[..., 0] = (3 * s[..., 0] + t[..., 0] + 2) >> 2
    e[..., 0] = (s[..., 0] + 3 * t[..., 0] + 2) >> 2
    n = (width - 1) // 2
    if n:
        s0, s1, t0, t1 = s[..., :n], s[..., 1:n + 1], t[..., :n], t[..., 1:n + 1]
        d[..., 1:2 * n:2] = (9 * s0 + 3 * s1 + 3 * t0 + t1 + 8) >> 4
        d[..., 2:2 * n + 1:2] = (3 * s0 + 9 * s1 + t0 + 3 * t1 + 8) >> 4
        e[..., 1:2 * n:2] = (3 * s0 + s1 + 9 * t0 + 3 * t1 + 8) >> 4
        e[..., 2:2 * n + 1:2] = (s0 + 3 * s1 + 3 * t0 + 9 * t1 + 8) >> 4
    k = (width - 1) // 2
    d[..., width - 1] = (3 * s[..., k] + t[..., k] + 2) >> 2
    e[..., width - 1] = (s[..., k] + 3 * t[..., k] + 2) >> 2
    return d, e


def upsample_420(c: np.ndarray, height: int, width: int) -> np.ndarray:
    """A 4:2:0 chroma plane at full size as libyuv's
    I420ToRGB24MatrixBilinear upsamples it."""
    c = c.astype(np.int32)
    out = np.empty((height, width), np.int32)
    out[0] = _up2_linear(c[0], width)
    n = (height - 1) // 2  # the loop's iterations: rows 2k+1 and 2k+2
    if n:
        d, e = _up2_bilinear(c[:n], c[1:n + 1], width)
        out[1:2 * n:2] = d
        out[2:2 * n + 1:2] = e
    if height % 2 == 0 and height > 1:
        out[height - 1] = _up2_linear(c[n], width)
    return out


def _gray8(x: np.ndarray, depth: int) -> np.ndarray:
    """A monochrome plane to 8 bits as cv2 narrows it
    (Mat.convertTo(CV_8U, 1 / 2^(depth - 8)): the nearest integer, ties
    to even, saturated)."""
    if depth == 8:
        return x
    s = depth - 8
    x = x.astype(np.int64)
    q, r = x >> s, x & ((1 << s) - 1)
    q += (r > 1 << (s - 1)) | ((r == 1 << (s - 1)) & (q & 1))
    return np.minimum(q, 255).astype(np.uint8)


def libyuv_constants(matrix: int, full_range: int,
                     primaries: int) -> tuple | None:
    """The YuvConstants libavif hands libyuv (getLibYUVConstants), or
    None where it converts with its own float path."""
    family = LIBYUV_PRIMARIES.get(primaries) if matrix == 12 \
        else LIBYUV_MATRICES.get(matrix)
    if family is None:
        return None
    return LIBYUV_CONSTANTS[LIBYUV_NAMES[family, full_range]]


def _libyuv_rows(y: np.ndarray, uu: np.ndarray, vv: np.ndarray, depth: int,
                 constants: tuple) -> np.ndarray:
    """libyuv's YuvPixel (8 bits), YuvPixel10_16 or YuvPixel12_16 with the
    given constants, on full-size planes of `depth` bits: Y widened to 16
    bits by repeating its top bits, U and V narrowed to 8 (x >> (depth -
    8), saturated)."""
    ub, ug, vg, vr, yg, yb = constants
    y = y.astype(np.int32)  # y32 * yg < 2^31 for every constant set
    if depth == 8:
        y32, uu, vv = y * 0x0101, uu - 128, vv - 128
    else:
        y32 = (y << (16 - depth)) | (y >> (2 * depth - 16))
        uu = np.minimum(uu.astype(np.int32) >> (depth - 8), 255) - 128
        vv = np.minimum(vv.astype(np.int32) >> (depth - 8), 255) - 128
    y1 = ((y32 * yg) >> 16) + yb
    b = y1 + uu * ub
    g = y1 - (uu * ug + vv * vg)
    r = y1 + vv * vr
    rgb = np.stack([r, g, b], axis=-1) >> 6
    return np.clip(rgb, 0, 255).astype(np.uint8)


def kr_kb(matrix: int, primaries: int) -> tuple:
    """Kr and Kb (float32) as avifCalcYUVCoefficients gives them: from
    the table, or for chroma-derived NCL (12) from the colour primaries
    (avifColorPrimariesComputeYCoeffs, H.273's equations 32-37)."""
    if matrix != 12:
        return tuple(_F32(k) for k in KR_KB.get(matrix, KR_KB[6]))
    rx, ry, gx, gy, bx, by, wx, wy = (
        _F32(v) for v in PRIMARIES.get(primaries, PRIMARIES[1]))
    one = _F32(1)
    rz, gz, bz, wz = (one - (rx + ry), one - (gx + gy), one - (bx + by),
                      one - (wx + wy))
    den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz)
                + bx * (ry * gz - gy * rz))
    kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz)
                + wz * (gx * by - bx * gy))) / den
    kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz)
                + wz * (rx * gy - gx * ry))) / den
    return _F32(kr), _F32(kb)


def _float_chroma(c: np.ndarray, table: np.ndarray, height: int, width: int,
                  ssx: int, ssy: int) -> np.ndarray:
    """A chroma plane as floats at full size, as libavif's
    avifImageYUVAnyToRGBAnySlow upsamples it (bilinear: 9/16 of the
    nearest sample, 3/16 of each neighbour across a subsampled axis,
    1/16 of the diagonal one; none past the edge)."""
    if not (ssx or ssy):
        return table[c]

    def near(n, sub):
        i = np.arange(n)
        if not sub:
            return i, np.zeros(n, np.int64)
        adj = np.where(i % 2 == 1, 1, -1)
        adj[(i == 0) | ((i == n - 1) & (i % 2 == 1))] = 0
        return i >> 1, adj

    ci, dc = near(width, ssx)
    cj, dr = near(height, ssy)
    r0, r1 = cj[:, None], (cj + dr)[:, None]
    c0, c1 = ci[None, :], (ci + dc)[None, :]
    return (table[c[r0, c0]] * _F32(9 / 16) + table[c[r0, c1]] * _F32(3 / 16)
            + table[c[r1, c0]] * _F32(3 / 16)
            + table[c[r1, c1]] * _F32(1 / 16))


def _float_rows(y: np.ndarray, u: np.ndarray, v: np.ndarray, matrix: int,
                full_range: int, primaries: int, ssx: int, ssy: int,
                depth: int) -> np.ndarray:
    """libavif's own YUV to 8-bit RGB in float32 (avifImageYUV8ToRGB8Color,
    avifImageYUV16ToRGB8Color at 4:4:4, avifImageYUVAnyToRGBAnySlow
    otherwise): the samples through its unorm tables, (x - bias) /
    range, then the identity (G = Y, B = U, R = V, Y's bias and range for
    all three), YCgCo, YCgCo-Re (in integers, Cg and Co rounded back
    from the floats) or Kr/Kb's equations, clamped to [0, 1] and stored
    as (uint8)(0.5 + x * 255)."""
    h, w = y.shape
    top = (1 << depth) - 1
    if full_range:
        bias_y, range_y, range_uv = _F32(0), _F32(top), _F32(top)
    else:
        bias_y = _F32(16 << (depth - 8))
        range_y, range_uv = _F32(219 << (depth - 8)), _F32(224 << (depth - 8))
    bias_uv = _F32(1 << (depth - 1))
    if matrix == 0:
        bias_uv, range_uv = bias_y, range_y
    cps = np.arange(top + 1, dtype=_F32)
    table_y = (cps - bias_y) / range_y
    table_uv = (cps - bias_uv) / range_uv
    cb = _float_chroma(u, table_uv, h, w, ssx, ssy)
    cr = _float_chroma(v, table_uv, h, w, ssx, ssy)
    if matrix == 16:
        cg = np.floor(cb * _F32(top) + _F32(0.5)).astype(np.int64)
        co = np.floor(cr * _F32(top) + _F32(0.5)).astype(np.int64)
        t = y.astype(np.int64) - (cg >> 1)
        g = np.clip(t + cg, 0, 255)
        b = np.clip(t - (co >> 1), 0, 255)
        return np.stack([np.clip(b + co, 0, 255), g, b], -1).astype(np.uint8)
    luma = table_y[y]
    if matrix == 0:
        r, g, b = cr, luma, cb
    elif matrix == 8:
        t = luma - cb
        r, g, b = t + cr, luma + cb, t - cr
    else:
        kr, kb = kr_kb(matrix, primaries)
        one, two = _F32(1), _F32(2)
        kg = (one - kr) - kb
        r = luma + (two * (one - kr)) * cr
        b = luma + (two * (one - kb)) * cb
        g = luma - ((two * ((kr * (one - kr) * cr) + (kb * (one - kb) * cb)))
                    / kg)
    rgb = np.clip(np.stack([r, g, b], -1), _F32(0), _F32(1))
    return (_F32(0.5) + rgb * _F32(255)).astype(np.uint8)


def yuv_to_rgb(y: np.ndarray, u: np.ndarray | None, v: np.ndarray | None,
               matrix: int = 6, full_range: int = 1, ss: tuple = (1, 1),
               depth: int = 8, alpha: bool = False,
               primaries: int = 2) -> np.ndarray:
    """uint8 RGB [H, W, 3] of planes of `depth` bits, chroma subsampled
    by `ss` = (ssx, ssy), as cv2 reads them with IMREAD_COLOR. cv2 reads
    a file with an alpha item into BGRA and drops A, one without into
    BGR, both through libavif 1.4.2's avifImageYUVToRGB into 8 bits,
    which refuses the forms `colour_refusal` names (ValueError here) and
    takes one of two routes:
    - libyuv, where it has constants for the colour description
      (`libyuv_constants`: BT.601, BT.709 and BT.2020 NCL at limited and
      full range, chroma-derived NCL by its primaries), through
      `_libyuv_rows`: 4:2:0 by I420To{RGB24,ARGB}MatrixFilter
      (kFilterBilinear, `upsample_420`), 4:2:2 by
      I422To{RGB24,ARGB}MatrixFilter (linear across, `_up2_linear`),
      4:4:4 by I444To{RGB24,ARGB}Matrix; at 10 and 12 bits into BGR the
      planes first narrowed to 8 (avifImageDownshiftTo8bpc, libyuv's
      Convert16To8Plane: x >> (depth - 8)), then as at 8 bits; 10 bits
      into BGRA by I010ToARGBMatrixFilter, I210ToARGBMatrixFilter (the
      chroma upsampled at 10 bits) or I410ToARGBMatrix; 12 bits into BGRA
      by I012ToARGBMatrix at 4:2:0 (each chroma sample over its 2x2
      pixels), narrowed to 8 bits first at 4:2:2 and 4:4:4 (libyuv has
      no 12-bit function for them);
    - its own float path otherwise (`_float_rows`: FCC, SMPTE 240M,
      YCgCo, YCgCo-Re, chroma-derived NCL of other primaries, the
      identity at 4:4:4, IPT-C2 and unlisted values as BT.601), at the
      planes' own depth.
    A monochrome file cv2 reads as one channel and widens with
    COLOR_GRAY2BGR, narrowed by `_gray8` (no libavif conversion, so the
    colour description is not read); with an alpha item cv2 returns no
    image."""
    if u is None:
        if alpha:
            raise ValueError("AVIF: a monochrome image with an alpha item is "
                             "not read (cv2 returns no image)")
        return np.repeat(_gray8(y, depth)[:, :, None], 3, axis=2)
    ssx, ssy = ss
    why = colour_refusal(matrix, full_range, ssx, ssy, depth)
    if why:
        raise ValueError(f"AVIF: {why}")
    constants = libyuv_constants(matrix, full_range, primaries)
    if constants is None:
        return _float_rows(y, u, v, matrix, full_range, primaries, ssx, ssy,
                           depth)
    h, w = y.shape
    if depth > 8 and (not alpha or (depth == 12 and (ssx, ssy) != (1, 1))):
        y, u, v = (p >> (depth - 8) for p in (y, u, v))  # Convert16To8Plane
        depth = 8
    if not ssx:
        uu, vv = u.astype(np.int32), v.astype(np.int32)
    elif not ssy:
        uu, vv = _up2_linear(u, w), _up2_linear(v, w)
    elif depth == 12:
        uu, vv = (c.astype(np.int32).repeat(2, 0).repeat(2, 1)[:h, :w]
                  for c in (u, v))
    else:
        uu, vv = upsample_420(u, h, w), upsample_420(v, h, w)
    return _libyuv_rows(y, uu, vv, depth, constants)


# --- the file ----------------------------------------------------------------


ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
XMP_CONTENT_TYPE = b"application/rdf+xml"


@dataclass
class Image:
    """What cv2 decodes of a file: the frames of the primary item (one,
    or a grid's cells row by row) or of an image sequence's first sample
    (`frame` is the first), the grid (rows, columns, output width and
    height) or None, the colour description (H.273's colour primaries,
    transfer characteristics and matrix coefficients, and the range),
    the alpha frames (or None), the Exif bytes cv2 reads the orientation
    from (or None) and the form: "item", "grid" or "sequence"."""
    frame: Frame
    matrix: int
    full_range: int
    alpha: Frame | None
    primaries: int = 2
    transfer: int = 2
    cells: list = field(default_factory=list)
    alpha_cells: list = field(default_factory=list)
    grid: tuple | None = None
    exif: bytes | None = None
    form: str = "item"

    @property
    def height(self) -> int:
        return self.grid[3] if self.grid else self.frame.header.height

    @property
    def width(self) -> int:
        return self.grid[2] if self.grid else self.frame.header.width


def _ispe(props: dict) -> tuple | None:
    ispe = props.get(b"ispe")
    if ispe is None or len(ispe) < 12:
        return None
    return struct.unpack(">II", ispe[4:12])


def _item_frame(data: bytes, c: Container, item: Item) -> Frame:
    props = item_properties(c, item)
    if b"av1C" not in props:
        raise ValueError("AVIF: an av01 item without its av1C property")
    frame = _frame(item_data(data, c, item), props[b"av1C"])
    ispe = _ispe(props)
    if ispe is None:
        raise ValueError("AVIF: an item without its ispe property")
    _check_size(ispe, frame, "ispe")
    return frame


def _frame(obus: bytes, av1c: bytes) -> Frame:
    if len(av1c) < 4 or av1c[0] != 0x81:
        raise ValueError("AVIF: a malformed av1C property")
    return read_frame(obus, av1c[4:])


def _check_size(size: tuple, frame: Frame, what: str) -> None:
    w, h = size
    if (w, h) != (frame.header.width, frame.header.height):
        raise ValueError(f"AVIF: {what} {w}x{h} differs from the AV1 frame's "
                         f"{frame.header.width}x{frame.header.height}")


def _source(c: Container) -> str:
    """libavif's AVIF_DECODER_SOURCE_AUTO: the tracks where the major
    brand is avis, the primary item where it is avif, else the tracks
    where avifParse read a `moov` with a track."""
    if c.major == b"avis" or (c.major != b"avif" and c.tracks):
        return "tracks"
    return "items"


def _is_alpha(props: dict) -> bool:
    return props.get(b"auxC", b"")[4:].rstrip(b"\0") in ALPHA_URNS


def _ref_targets(c: Container, kind: bytes, src: int) -> list:
    out = []
    for k, s, dst in c.refs:
        if k == kind and s == src:
            out += dst
    return out


def _described(c: Container, kind: bytes) -> dict:
    """item ID -> the item its last `kind` reference points at, as
    libavif's descForID and auxForID keep them."""
    out = {}
    for k, src, dst in c.refs:
        if k == kind and dst:
            out[src] = dst[-1]
    return out


def _has_data(item: Item) -> bool:
    """Whether the item's extents hold any bytes (libavif skips items
    of size 0)."""
    return any(n for _, n in item.extents)


def _metadata_items(c: Container, target: int | None) -> list:
    """The Exif and XMP items libavif's avifDecoderFindMetadata reads, in
    item order: those with data, described (`cdsc`) as `target` (any,
    where target is None)."""
    desc = _described(c, b"cdsc")
    out = []
    for item in c.items.values():
        if not _has_data(item):
            continue
        if target is not None and desc.get(item.id) != target:
            continue
        if item.type == b"Exif" or (item.type == b"mime" and
                                    item.content_type == XMP_CONTENT_TYPE):
            out.append(item)
    return out


def _exif(data: bytes, c: Container, items: list) -> bytes | None:
    """The Exif bytes libavif 1.4.2 hands cv2: each Exif item's payload
    after its 4-byte exif_tiff_header_offset, which must be where
    avifGetExifTiffHeaderOffset finds the first TIFF header ("II*\\0"
    or "MM\\0*" with a byte after it); the last item's."""
    out = None
    for item in items:
        if item.type != b"Exif":
            continue
        payload = item_data(data, c, item)
        if len(payload) < 4:
            raise ValueError("AVIF: an Exif item shorter than its TIFF header"
                             " offset (cv2 returns no image)")
        declared = int.from_bytes(payload[:4], "big")
        body = payload[4:]
        found = next((i for i in range(len(body) - 4)
                      if body[i:i + 4] in (b"II*\0", b"MM\0*")), None)
        if found is None:
            raise ValueError("AVIF: an Exif item without a TIFF header (cv2 "
                             "returns no image)")
        if found != declared:
            raise ValueError(f"AVIF: an Exif item whose TIFF header offset "
                             f"{declared} is not the header's {found} (cv2 "
                             "returns no image)")
        out = body
    return out


def _grid_payload(payload: bytes) -> tuple:
    """(rows, columns, output width, output height) of an ImageGrid
    payload, as libavif's avifParseImageGridBox reads it."""
    if len(payload) < 4 or payload[0] != 0:
        raise ValueError("AVIF: a grid item of another version than 0")
    rows, cols = payload[2] + 1, payload[3] + 1
    field_len = 4 if payload[1] & 1 else 2
    if len(payload) != 4 + 2 * field_len:
        raise ValueError("AVIF: a grid item of the wrong length")
    w = int.from_bytes(payload[4:4 + field_len], "big")
    h = int.from_bytes(payload[4 + field_len:], "big")
    if not (w and h) or w > 32768 or h > 32768 or w * h > 16384 * 16384:
        raise ValueError(f"AVIF: a grid of output size {w}x{h}")
    return rows, cols, w, h


def _signature_reads(c: Container, source: str) -> list:
    """The reads of item and sample data libavif 1.4.2's
    avifDecoderParse makes, in order, as (file offset, length, what):
    a grid's payload, the Exif and XMP items, an alpha grid's payload,
    and, where the colour item has no `colr` nclx, the first 64 bytes of
    its first tile's first sample (where it looks for the AV1 sequence
    header's colour description). Data in `idat` is no read."""
    reads: list = []

    def item_reads(item, what, limit=None):
        if item.method == 1:
            return
        left = limit
        for off, n in item.extents:
            n = n if left is None else min(n, left)
            reads.append((item.base + off, n, what))
            if left is not None:
                left -= n
                if left <= 0:
                    return

    if source == "tracks":
        track = _colour_track(c)
        if track is None:
            return reads
        if track.meta is not None:
            for item in _metadata_items(track.meta, None):
                item_reads(item, "the track's XMP item" if item.type ==
                           b"mime" else "the track's Exif item")
        if _nclx_of(_sample_entry(track)[1]) is None:
            offset, size = _samples(track)[0]
            reads.append((offset, min(64, size), "the first sample"))
        return reads
    item = c.items.get(c.primary)
    if item is None:
        return reads
    if item.type == b"grid":
        item_reads(item, "the grid item")
    for meta in _metadata_items(c, c.primary):
        item_reads(meta, "the XMP item" if meta.type == b"mime"
                   else "the Exif item")
    alpha = _alpha_item(c, item)
    if alpha is not None and alpha.type == b"grid":
        item_reads(alpha, "the alpha grid item")
    if _nclx(c, item) is None:
        first = item
        if item.type == b"grid":
            cells = _ref_targets(c, b"dimg", item.id)
            first = c.items.get(cells[0]) if cells else None
        if first is not None:
            item_reads(first, "the first tile's sequence header", 64)
    return reads


def signature_refusal(data: bytes, c: Container) -> str | None:
    """Why cv2 5.0 returns no image for a file libavif could read: its
    AVIF decoder claims a file only where avifDecoderParse of the first
    500 bytes (io->sizeHint 1e9) returns OK or TRUNCATED_DATA, so a box
    header cut at byte 500, or a read by the parse (`_signature_reads`)
    that starts past byte 500 while the boxes it needs lie within them,
    leaves the file unread. None where cv2 takes the file."""
    avail = min(len(data), SIGNATURE_BYTES)
    try:
        _top_level(data, avail, SIGNATURE_SIZE_HINT)
    except _Truncated:
        return None
    except ValueError as exc:
        return f"{str(exc)[6:]} within the first {SIGNATURE_BYTES} bytes"
    for offset, length, what in _signature_reads(c, _source(c)):
        if offset > avail:
            return f"{what} starts at byte {offset}, past the first " \
                f"{SIGNATURE_BYTES} its metadata lies in"
        if offset + length > avail:
            return None
    return None


def _alpha_item(c: Container, item: Item) -> Item | None:
    aux = _described(c, b"auxl")
    for other in c.items.values():
        if aux.get(other.id) != item.id or other.type not in (
                b"av01", b"grid") or not _has_data(other):
            continue
        if _is_alpha(item_properties(c, other)):
            return other
    return None


def _check_items(c: Container) -> None:
    """avifDecoderParse's walk over the items: every av01 or grid item
    with data has an ispe of non-zero sides, alpha auxiliary items
    excepted."""
    for item in c.items.values():
        if item.type not in (b"av01", b"grid") or not _has_data(item):
            continue
        props = item_properties(c, item)
        ispe = _ispe(props)
        if ispe is None:
            if _is_alpha(props):
                continue
            raise ValueError(f"AVIF: item {item.id} has no ispe property")
        if not (ispe[0] and ispe[1]):
            raise ValueError(f"AVIF: item {item.id} has an ispe of size "
                             f"{ispe[0]}x{ispe[1]}")


def _grid_frames(data: bytes, c: Container, item: Item, what: str):
    """(rows, columns, width, height) of a grid item and its cells'
    frames, checked as libavif 1.4.2 checks them."""
    rows, cols, w, h = _grid_payload(item_data(data, c, item))
    ids = _ref_targets(c, b"dimg", item.id)
    cells = []
    for iid in ids:
        cell = c.items.get(iid)
        if cell is None or cell.type != b"av01":
            kind = None if cell is None else cell.type
            raise ValueError(f"AVIF: {what} names a cell of type {kind!r} "
                             "(cv2 returns no image)")
        cells.append(cell)
    if len(cells) != rows * cols:
        raise ValueError(f"AVIF: {what} of {rows}x{cols} cells has "
                         f"{len(cells)} (cv2 returns no image)")
    configs = [item_properties(c, cell).get(b"av1C", b"")[1:3]
               for cell in cells]
    if any(cfg != configs[0] for cfg in configs):
        raise ValueError(f"AVIF: {what} has cells whose av1C differ (profile, "
                         "level, tier, depth, subsampling; cv2 returns no "
                         "image)")
    frames = [_item_frame(data, c, cell) for cell in cells]
    first = frames[0]
    cw, ch = first.header.width, first.header.height
    s = first.seq
    for f in frames[1:]:
        t = f.seq
        if ((f.header.width, f.header.height, t.bit_depth, t.mono, t.ssx,
             t.ssy, t.full_range, t.primaries, t.transfer, t.matrix)
                != (cw, ch, s.bit_depth, s.mono, s.ssx, s.ssy, s.full_range,
                    s.primaries, s.transfer, s.matrix)):
            raise ValueError(f"AVIF: {what} has cells that differ in size, "
                             "depth, subsampling, range or colour "
                             "description (cv2 returns no image)")
    if cw * cols < w or ch * rows < h:
        raise ValueError(f"AVIF: {what}'s cells do not cover its output "
                         f"{w}x{h} (cv2 returns no image)")
    if cw * (cols - 1) >= w or ch * (rows - 1) >= h:
        raise ValueError(f"AVIF: {what}'s last row or column of cells lies "
                         f"outside its output {w}x{h} (cv2 returns no image)")
    if cw < 64 or ch < 64:
        raise ValueError(f"AVIF: {what}'s cells of {cw}x{ch} are under 64 "
                         "(cv2 returns no image)")
    if not s.mono and ((s.ssx and (cw | w) & 1) or (s.ssy and (ch | h) & 1)):
        raise ValueError(f"AVIF: {what}'s output {w}x{h} or cells {cw}x{ch} "
                         "are odd where the chroma is subsampled (cv2 returns "
                         "no image)")
    return (rows, cols, w, h), frames


def read_image(data: bytes) -> Image:
    """The container and the headers of what cv2 decodes (no tile is
    decoded): what `decode` and `size` start from."""
    c = read_container(data)
    _check_items(c)
    why = signature_refusal(data, c)
    if why:
        raise ValueError(f"AVIF: cv2 returns no image: its AVIF signature "
                         f"check finds that {why}")
    if _source(c) == "tracks":
        return _sequence_image(data, c)
    if c.primary is None or c.primary not in c.items:
        raise ValueError("AVIF: no primary item")
    item = c.items[c.primary]
    if item.type not in (b"av01", b"grid"):
        raise ValueError(f"AVIF: a primary item of type {item.type!r} is not "
                         "read here")
    exif = _exif(data, c, _metadata_items(c, c.primary))
    grid = None
    if item.type == b"grid":
        grid, frames = _grid_frames(data, c, item, "the grid item")
        ispe = _ispe(item_properties(c, item))
        if ispe != grid[2:]:
            raise ValueError(f"AVIF: the grid item's ispe {ispe} differs from "
                             f"its output size {grid[2]}x{grid[3]}")
    else:
        frames = [_item_frame(data, c, item)]
    alpha_frames = []
    alpha = _alpha_item(c, item)
    if alpha is not None:
        if alpha.type == b"grid":
            agrid, alpha_frames = _grid_frames(data, c, alpha,
                                               "the alpha grid item")
            size = agrid[2:]
        else:
            alpha_frames = [_item_frame(data, c, alpha)]
            size = (alpha_frames[0].header.width,
                    alpha_frames[0].header.height)
        want = grid[2:] if grid else (frames[0].header.width,
                                      frames[0].header.height)
        if size != want:
            raise ValueError(f"AVIF: an alpha item of size {size} for an "
                             f"image of {want} (cv2 returns no image)")
    s = frames[0].seq
    if s.mono and alpha_frames:
        raise ValueError("AVIF: a monochrome image with an alpha item is not "
                         "read (cv2 returns no image)")
    primaries, transfer, matrix, full = _nclx(c, item) or (
        s.primaries, s.transfer, s.matrix, s.full_range)
    if not s.mono:
        why = colour_refusal(matrix, full, s.ssx, s.ssy, s.bit_depth)
        if why:
            raise ValueError(f"AVIF: {why}")
    return Image(frames[0], matrix, full,
                 alpha_frames[0] if alpha_frames else None, primaries,
                 transfer, frames, alpha_frames, grid, exif,
                 "grid" if grid else "item")


def _sample_entry(t: Track) -> tuple:
    """(format, child boxes) of the track's first av01 sample entry."""
    return next(e for e in t.entries if e[0] == b"av01")


def _is_image_track(t: Track) -> bool:
    return bool(t.table and t.id and t.chunks and
                any(fmt == b"av01" for fmt, _ in t.entries))


def _colour_track(c: Container) -> Track | None:
    """The track libavif decodes: the first with a sample table, an ID,
    chunks and an av01 sample entry that is auxiliary to no track (its
    handler is not read)."""
    for t in c.tracks:
        if _is_image_track(t) and not t.aux_for:
            return t
    return None


def _samples(t: Track) -> list:
    """(file offset, size) of each sample, as libavif's
    avifCodecDecodeInputFillFromSampleTable lays them out: each chunk's
    samples (`stsc`'s last run that starts at or before the chunk) one
    after another from the chunk's offset."""
    out, k = [], 0
    for index, offset in enumerate(t.chunks):
        count = next((per for first, per in reversed(t.stsc)
                      if first <= index + 1), 0)
        if not count:
            raise ValueError("AVIF: a chunk of the sample table with no "
                             "samples")
        for _ in range(count):
            size = t.sample_size
            if not size:
                if k >= len(t.sizes):
                    raise ValueError("AVIF: the sample table has fewer sizes "
                                     "than samples")
                size = t.sizes[k]
            out.append((offset, size))
            offset += size
            k += 1
    return out


def _sequence_image(data: bytes, c: Container) -> Image:
    """An image sequence (`moov`) as cv2 reads it: the first sample of
    the colour track, its alpha track's first sample decoded and
    dropped, the Exif of the track's own `meta`."""
    track = _colour_track(c)
    if track is None:
        raise ValueError("AVIF: an image sequence without a colour track of "
                         "av01 samples (cv2 returns no image)")
    boxes = _sample_entry(track)[1]
    props = dict(reversed(boxes))
    if b"av1C" not in props:
        raise ValueError("AVIF: an av01 sample entry without its av1C")
    exif = None
    if track.meta is not None:
        exif = _exif(data, track.meta, _metadata_items(track.meta, None))
    frames = []
    alpha_track = next((t for t in c.tracks if t.aux_for == track.id and
                        _is_image_track(t)), None)
    for t in (track, alpha_track):
        if t is None:
            continue
        samples = _samples(t)
        for offset, size in samples:
            if not size or offset + size > len(data):
                raise ValueError("AVIF: a sample of the image sequence lies "
                                 "outside the file (cv2 returns no image)")
        av1c = dict(reversed(_sample_entry(t)[1])).get(b"av1C")
        if av1c is None:
            raise ValueError("AVIF: an av01 sample entry without its av1C")
        offset, size = samples[0]
        try:
            frame = _frame(data[offset:offset + size], av1c)
        except ValueError as exc:
            raise ValueError(f"AVIF: the image sequence's first sample: "
                             f"{exc}") from None
        _check_size((t.width, t.height), frame, "tkhd")
        frames.append(frame)
    frame = frames[0]
    s = frame.seq
    if s.mono and alpha_track is not None:
        raise ValueError("AVIF: a monochrome image with an alpha track is not "
                         "read (cv2 returns no image)")
    primaries, transfer, matrix, full = _nclx_of(boxes) or (
        s.primaries, s.transfer, s.matrix, s.full_range)
    if not s.mono:
        why = colour_refusal(matrix, full, s.ssx, s.ssy, s.bit_depth)
        if why:
            raise ValueError(f"AVIF: {why}")
    return Image(frame, matrix, full, frames[1] if alpha_track else None,
                 primaries, transfer, [frame], frames[1:], None, exif,
                 "sequence")


def _nclx(c: Container, item: Item) -> tuple | None:
    """(primaries, transfer, matrix, full range) of the item's `colr`
    nclx property, or None without one (libavif then takes the AV1
    sequence header's)."""
    return _nclx_of([c.properties[i] for i in item.props])


def _nclx_of(boxes) -> tuple | None:
    """The nclx of (kind, payload) properties or sample entry boxes. As
    libavif: an ICC `colr` (prof, rICC) beside it is ignored, other
    colour types are skipped, and two nclx or two ICC properties, or a
    short nclx, are refused."""
    nclx, icc = [], 0
    for kind, payload in boxes:
        if kind != b"colr":
            continue
        if payload[:4] == b"nclx":
            if len(payload) < 11:
                raise ValueError("AVIF: a colr nclx property ends early")
            nclx.append(struct.unpack(">HHH", payload[4:10])
                        + (payload[10] >> 7,))
        icc += payload[:4] in (b"prof", b"rICC")
    if len(nclx) > 1 or icc > 1:
        raise ValueError("AVIF: an item with two colr properties of one "
                         "kind (nclx or ICC)")
    return nclx[0] if nclx else None


def size(data: bytes) -> tuple[int, int]:
    """(height, width) of the image `decode` returns, from the headers
    (a grid's output size; the Exif orientation is not applied)."""
    image = read_image(data)
    return image.height, image.width


def decode_planes(frame: Frame, plain: bool = False):
    """(Y, U, V, stats) of a frame: the host C library, or with `plain`
    the plain decoder of this module (stats then None)."""
    if plain:
        return decode_planes_plain(frame) + (None,)
    return decode_planes_c(frame)


def stitch(planes: list, grid: tuple, ssx: int, ssy: int) -> tuple:
    """A grid's Y, U and V planes from its cells' (row by row), cropped to
    its output size, as libavif copies each cell into the output before
    it converts to RGB (U and V None for monochrome cells)."""
    rows, cols, w, h = grid
    out = []
    for p in range(3):
        if planes[0][p] is None:
            out.append(None)
            continue
        full = np.block([[planes[r * cols + k][p] for k in range(cols)]
                         for r in range(rows)])
        if p == 0:
            out.append(full[:h, :w])
        else:
            out.append(full[:(h + ssy) >> ssy, :(w + ssx) >> ssx])
    return tuple(np.ascontiguousarray(x) if x is not None else None
                 for x in out)


def decode_with_exif(data: bytes, plain: bool = False) -> tuple:
    """(uint8 RGB [H, W, 3], Exif bytes or None) of an AVIF file: the
    pixels as cv2.imdecode(..., IMREAD_COLOR) decodes them before it
    applies the Exif orientation, reversed to RGB. Alpha, where there is
    one, is decoded (cv2 returns no image where it cannot be) and
    dropped; a grid's cells are stitched and cropped before the colour
    conversion."""
    image = read_image(data)
    for frame in image.alpha_cells:
        decode_planes(frame, plain)
    planes = [decode_planes(frame, plain)[:3] for frame in image.cells]
    s = image.frame.seq
    y, u, v = stitch(planes, image.grid, s.ssx, s.ssy) if image.grid \
        else planes[0]
    rgb = yuv_to_rgb(y, u, v, image.matrix, image.full_range,
                     (s.ssx, s.ssy), s.bit_depth, image.alpha is not None,
                     image.primaries)
    return rgb, image.exif


def decode(data: bytes, plain: bool = False) -> np.ndarray:
    """uint8 RGB [H, W, 3] of an AVIF file as cv2 decodes it, before the
    Exif orientation (`decode_with_exif`)."""
    return decode_with_exif(data, plain)[0]
