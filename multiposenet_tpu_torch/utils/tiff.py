"""TIFF as OpenCV 5.0 reads and writes it through libtiff 4.7
(`grfmt_tiff.cpp`).

`decode` reads the first image (IFD0) of a classic TIFF, either byte
order: 8 and 16-bit samples; gray (MinIsBlack, MinIsWhite inverted),
RGB, RGB with an alpha sample and palette (a colormap with any entry
past 255 is taken as 16-bit and keeps its high bytes, as libtiff's
checkcmap decides); 1-bit gray and 1 and 4-bit palette indices (cv2
returns no image for 2-bit samples or 4-bit gray); CMYK, YCbCr and
CIELab (below); chunky or planar; strips or tiles; compression none,
LZW, PackBits, deflate (8 and 32946), JPEG (7) and CCITT (2, 3 and 4);
the horizontal predictor (2) where the compression takes one (LZW and
deflate; libtiff ignores it under none and PackBits); FillOrder 2, whose
bytes libtiff reverses bit by bit before any decoder but the JPEG and
fax ones; signed 8 and 16-bit samples (SampleFormat 2) as if unsigned,
as cv2 reads them. What cv2 makes of the samples:
- 16-bit gray keeps the high byte (`v >> 8`); 16-bit RGB is rounded,
  `(v * 255 + 32767) // 65535`. On 16-bit gray tiles cv2's conversion
  steps through a tile of which only part lies in the image by the
  wrong row length (`_gray16_tile_rows`), and that is reproduced (with
  an extra sample it is refused by name);
- an unassociated alpha (ExtraSamples 2) premultiplies the colour,
  `(c * a + 127) // 255` on 8-bit values, as libtiff's RGBA reader does;
  any other alpha is dropped;
- everything else goes through libtiff's RGBA reader (`tif_getimage.c`):
  CMYK (InkSet CMYK, 4 samples of 8 bits, chunky or planar) as
  `(255 - k) * (255 - c) // 255`; YCbCr of 8 bits, chunky, in data units
  of YCbCrSubsampling 4x4, 4x2, 4x1, 2x2, 2x1, 1x2 or 1x1 (planar: 1x1),
  each pixel taking its unit's Cb and Cr, through `TIFFYCbCrToRGB`'s
  fixed-point tables from ReferenceBlackWhite and YCbCrCoefficients. Two
  quirks of 4x4 units are reproduced: a strip whose rows hold an odd
  number of units is read short by the last unit's chroma (libtiff sizes
  the read by a scanline of 18 * units // 4 bytes; the chroma stays 0),
  and in a tile the image covers only partly the units skipped at a
  row's end count 10 bytes each, not 18 (putcontig8bitYCbCr44tile);
  CIELab of 8 or 16 bits through `TIFFCIELabToXYZ` and `TIFFXYZToRGB` to
  the sRGB display, in libtiff's float arithmetic, with the WhitePoint
  (default D50);
- a JPEG strip or tile (its JPEGTables in front) is decoded as libtiff's
  JPEG codec has libjpeg-turbo decode it: YCbCr converted to RGB by
  libjpeg (JPEGCOLORMODE_RGB, fancy upsampling), every other photometric
  (gray, RGB, CMYK) left as its components are, whatever the stream's
  markers say, then through the rules above. Without YCbCrSubsampling a
  YCbCr file takes it from its first stream, as libtiff's JPEGFixupTags
  does. A stream whose sampling differs from what the TIFF says gives no
  image; one with fewer rows than its strip or tile leaves the rest 0; one
  of another width, or taller than its chunk but for the last strip, is
  refused by name;
- a CCITT strip or tile is decoded as `utils/ccitt.py` says;
- the Exif orientation of IFD0 (tag 274) is applied as for a JPEG. On
  tiles read through libtiff's RGBA tile reader (8-bit samples and
  everything it converts), each tile of orientations 2, 3, 6 and 7 is
  mirrored in place before cv2 mirrors the image: the columns of tiles
  come out reversed.
The LZW, PackBits, JPEG and fax streams are run by the host C library
(`image_codec.tiff_lzw`, `packbits`, `decode_jpeg_tiff`, `fax_decode`);
`lzw_decode_plain`, `packbits_plain`, `jpeg.decode_planes` (baseline
streams) and `ccitt.decode` are their plain versions; the colour
conversions are NumPy on both paths. LZW codes are read MSB first with
libtiff's early change of code width; a strip that starts with the bytes
00 and an odd byte is libtiff's old-style LZW (codes LSB first, the width
changing one code later). Where LZW, PackBits or deflate data fails or
ends before a chunk's rows are filled, libtiff's RGBA reader keeps what
the codec wrote and zeros after it, without the predictor or the byte
swap of big-endian 16-bit samples (a strip left uncompressed and cut
short gives no image); a single strip whose byte count is 0 (or a
file without StripByteCounts) takes libtiff's estimate, the rest of the
file less the directory.

Refused by name, as cv2 returns no image for them: tiles without
compression (libtiff's RGBA reader rejects their byte counts), old-style
JPEG (6), LZMA, ZSTD, WebP and the other compressions cv2's libtiff is
not built with, floating-point and signed samples, sample depths and
photometric interpretations other than the above (ICCLab, ITULab, CMYK
of another ink set or depth, YCbCr of another subsampling or depth),
BigTIFF.

`encode` writes what `cv2.imencode(".tif")` writes for a 3-channel image
(the plain version of `image_codec.encode_tiff`): LZW with the
horizontal predictor, `RowsPerStrip` = max(1, min(H, 8192 // (3 W))),
strips from byte 8, then IFD0 at an even offset with 12 entries, then
BitsPerSample, StripByteCounts, StripOffsets and SampleFormat. As
libtiff 4.7 decides, StripByteCounts is SHORT when there are several
strips and an uncompressed strip is below 65535 / 10 bytes, else LONG.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from multiposenet_tpu_torch.utils import ccitt, image_codec, jpeg
from multiposenet_tpu_torch.utils.inflate import inflate_partial

# IFD entry types read (the numeric ones a reader needs): struct codes.
# RATIONAL pairs become float32 as libtiff's float fields take them;
# UNDEFINED stays bytes.
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 5: "II", 6: "b", 8: "h", 9: "i",
             11: "f", 12: "d"}
# TIFFDataWidth of every classic type, for libtiff's byte-count estimate.
_TYPE_WIDTH = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 13: 4}
COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT group 3",
                4: "CCITT group 4", 5: "LZW", 6: "old JPEG", 7: "JPEG",
                8: "deflate", 32773: "PackBits", 32946: "deflate",
                34712: "JPEG 2000", 34925: "LZMA", 50000: "ZSTD",
                50001: "WebP", 34887: "LERC", 32771: "CCITT RLEW"}
_READ = (1, 2, 3, 4, 5, 7, 8, 32773, 32946)
_FAX = (2, 3, 4)
_PREDICTED = (5, 8, 32946)
PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "palette",
               4: "mask", 5: "CMYK", 6: "YCbCr", 8: "CIELab", 9: "ICCLab",
               10: "ITULab", 32844: "LogL", 32845: "LogLuv"}
# YCbCrSubsampling (horizontal, vertical) libtiff's RGBA reader takes.
_SUBSAMPLINGS = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                     np.uint8)


def _tags(data: bytes, name) -> tuple[str, dict]:
    if len(data) < 8:
        raise ValueError(f"{name}: TIFF header ends early")
    e = "<" if data[:2] == b"II" else ">"
    magic, ifd = struct.unpack(e + "HI", data[2:8])
    if magic == 43:
        raise ValueError(f"{name}: BigTIFF is not read here")
    if ifd + 2 > len(data):
        raise ValueError(f"{name}: TIFF directory past the end")
    (count,) = struct.unpack(e + "H", data[ifd:ifd + 2])
    tags = {}
    for i in range(count):
        at = ifd + 2 + 12 * i
        if at + 12 > len(data):
            raise ValueError(f"{name}: TIFF directory ends early")
        tag, typ, n = struct.unpack(e + "HHI", data[at:at + 8])
        if typ not in _TYPE_FMT and typ != 7:
            continue
        size = _TYPE_WIDTH[typ] * n
        where = at + 8 if size <= 4 else struct.unpack(
            e + "I", data[at + 8:at + 12])[0]
        if where + size > len(data):
            raise ValueError(f"{name}: TIFF tag {tag} past the end")
        if typ == 7:
            tags[tag] = bytes(data[where:where + size])
            continue
        values = list(struct.unpack(e + _TYPE_FMT[typ] * n,
                                    data[where:where + size]))
        if typ == 5:  # (float)num / (float)den, 0 for a zero denominator
            values = [np.float32(a) / np.float32(b) if b else np.float32(0)
                      for a, b in zip(values[0::2], values[1::2])]
        elif typ in (11, 12):
            with np.errstate(over="ignore"):  # out of range: inf, as in C
                values = [np.float32(v) for v in values]
        tags[tag] = values
    return e, tags


def _one(tags: dict, tag: int, default=None):
    return tags[tag][0] if tag in tags else default


def _directory_space(data: bytes, e: str) -> int:
    """The bytes libtiff's EstimateStripByteCounts takes the directory to
    hold: header, entries and their out-of-line values."""
    (ifd,) = struct.unpack(e + "I", data[4:8])
    (count,) = struct.unpack(e + "H", data[ifd:ifd + 2])
    space = 8 + 2 + 12 * count + 4
    for i in range(count):
        typ, n = struct.unpack(e + "HI", data[ifd + 4 + 12 * i:
                                              ifd + 10 + 12 * i])
        size = _TYPE_WIDTH.get(typ, 0) * n
        if typ not in _TYPE_WIDTH:
            raise ValueError("TIFF tag of an unknown type (libtiff cannot "
                             "estimate the strip sizes)")
        space += size if size > 4 else 0
    return space


def _unpredict(block: np.ndarray) -> np.ndarray:
    """Undo the horizontal predictor on [rows, cols, samples] of uint8 or
    uint16 (the sums wrap at the sample's width)."""
    return np.cumsum(block, axis=1, dtype=block.dtype)


class _Layout:
    """What a chunk (strip or tile) holds, from the tags: the image's
    geometry and samples as the reader decodes them."""

    def __init__(self, data: bytes, e: str, tags: dict, name):
        self.name, self.e = name, e
        self.width, self.height = _one(tags, 256, 0), _one(tags, 257, 0)
        self.spp = _one(tags, 277, 1)
        self.bps_all = tags.get(258, [1])
        self.bps = self.bps_all[0]
        self.comp = _one(tags, 259, 1)
        self.photometric = _one(tags, 262)
        self.planar = _one(tags, 284, 1)
        self.predictor = _one(tags, 317, 1)
        self.fill_order = _one(tags, 266, 1)
        self.t4options = _one(tags, 292, 0)
        self.fmt = tags.get(339, [1])
        self.tiled = 322 in tags
        self.jpeg_tables = bytes(tags[347]) if 347 in tags else None
        self.subsampling = tuple(tags.get(530, (2, 2))[:2])
        self.has_subsampling = 530 in tags
        self.codec: dict = {}  # the fax decoder's state across chunks
        if self.tiled:
            self.cw, self.ch = _one(tags, 322), _one(tags, 323)
            offsets, counts = tags.get(324), tags.get(325)
        else:
            self.cw = self.width
            self.ch = min(_one(tags, 278, 2**32 - 1), self.height)
            offsets, counts = tags.get(273), tags.get(279)
        if not offsets or not self.cw or not self.ch:
            raise ValueError(f"{name}: TIFF without its data offsets")
        self.offsets = list(offsets)
        self.counts = self._byte_counts(data, e, counts)

    def _byte_counts(self, data: bytes, e: str, counts) -> list:
        """StripByteCounts, or libtiff's estimate where it makes one: no
        such tag, or a single strip of a compressed image counted 0."""
        n = len(self.offsets)
        if counts is not None and not (
                n == 1 and not self.tiled and self.offsets[0]
                and counts[0] == 0 and self.comp != 1):
            return list(counts)
        if self.comp == 1:
            raise ValueError(f"{self.name}: uncompressed TIFF without "
                             "StripByteCounts is not read here")
        space = max(0, len(data) - _directory_space(data, e))
        if self.planar == 2:
            space //= self.spp
        out = [space] * n
        last = self.offsets[-1]
        if last + out[-1] > len(data):
            out[-1] = 0 if last >= len(data) else len(data) - last
        return out


def decode(data: bytes, name="<bytes>", plain: bool = False) -> np.ndarray:
    """TIFF bytes → uint8 RGB [H, W, 3] as `cv2.imdecode(buf,
    IMREAD_COLOR)` reversed to RGB (see the module docstring). `plain`
    runs the coders in Python instead of C."""
    e, tags = _tags(data, name)
    lay = _Layout(data, e, tags, name)
    _check(lay, tags)
    planes = lay.spp if lay.planar == 2 else 1
    per = 1 if lay.planar == 2 else lay.spp
    across, down = -(-lay.width // lay.cw), -(-lay.height // lay.ch)
    if len(lay.offsets) < planes * across * down \
            or len(lay.counts) < len(lay.offsets):
        raise ValueError(f"{name}: TIFF lists {len(lay.offsets)} chunks, "
                         f"want {planes * across * down}")
    if lay.comp == 7 and lay.photometric == 6 and not lay.has_subsampling:
        # JPEGFixupTags: the subsampling of the first stream's luma.
        sampling = _stream_sampling(_jpeg_stream(lay, data, 0))
        lay.subsampling = sampling[0] if sampling else (2, 2)
    photometric = lay.photometric
    if lay.comp == 7 and photometric == 6:
        photometric = 2  # libjpeg converts: the RGBA reader takes RGB
    samples = np.zeros((lay.height, lay.width, lay.spp), np.int32)
    k = 0
    for p in range(planes):
        chunks = []
        for ty in range(down):
            for tx in range(across):
                rows = lay.ch if lay.tiled else min(lay.ch,
                                                    lay.height - ty * lay.ch)
                chunks.append((ty * lay.ch, tx * lay.cw, rows,
                               _chunk(lay, data, k, rows, tx * lay.cw, per,
                                      plain)))
                k += 1
        for y0, x0, rows, block in chunks:
            if lay.tiled and lay.bps == 16 and lay.photometric in (0, 1) \
                    and lay.width - x0 < lay.cw:
                if lay.spp > 1:
                    raise ValueError(
                        f"{name}: 16-bit gray TIFF with an extra sample in "
                        "tiles the image only partly covers is not read "
                        "here (cv2 fills them from other rows by a rule "
                        "not reproduced)")
                block = _gray16_tile_rows(block, lay.width - x0)
            part = block[:lay.height - y0, :lay.width - x0]
            samples[y0:y0 + part.shape[0], x0:x0 + part.shape[1],
                    p * per:(p + 1) * per] = part
    rgb = _to_rgb(samples, lay.bps, photometric, tags)
    from multiposenet_tpu_torch.utils.image_io import (apply_orientation,
                                                        exif_orientation)
    orientation = exif_orientation(data)
    if lay.tiled and orientation in (2, 3, 6, 7):
        # libtiff's RGBA tile reader mirrors each tile's columns in place;
        # cv2's mirror of the whole image then leaves the tiles' columns
        # in file order but the columns of tiles reversed.
        rgb = np.concatenate([rgb[:, x:x + lay.cw] for x in
                              range(0, lay.width, lay.cw)][::-1], axis=1)
    return apply_orientation(rgb, orientation)


def _check(lay: _Layout, tags: dict) -> None:
    """Refuse by name what cv2 returns no image for (or what is not
    reproduced)."""
    name, comp, bps, spp, ph = (lay.name, lay.comp, lay.bps, lay.spp,
                                lay.photometric)
    if comp not in _READ:
        why = ("cv2 returns no image" if comp in (6, 32771) else
               "cv2's libtiff is not built with it")
        raise ValueError(f"{name}: TIFF with "
                         f"{COMPRESSIONS.get(comp, f'compression {comp}')} "
                         f"compression is not read here ({why})")
    packed = (bps == 1 and ph in (0, 1, 3) and spp == 1) or (
        bps == 4 and ph == 3 and spp == 1)
    # Signed 8 and 16-bit samples (SampleFormat 2) are read as unsigned.
    if (bps not in (8, 16) and not packed) \
            or any(b != bps for b in lay.bps_all) \
            or any(f != 1 and not (f == 2 and bps in (8, 16))
                   for f in lay.fmt):
        raise ValueError(f"{name}: TIFF with {lay.bps_all}-bit samples of "
                         f"format {lay.fmt} and photometric "
                         f"{PHOTOMETRIC.get(ph, ph)} is not read here (8 "
                         "and 16-bit unsigned, 1-bit gray and palette, "
                         "4-bit palette; cv2 returns no image for 2-bit "
                         "samples, 4-bit gray, 32-bit and floating-point "
                         "samples)")
    colour = {5: spp == 4 and bps == 8 and _one(tags, 332, 1) == 1,
              6: spp == 3 and bps == 8,
              8: spp == 3 and lay.planar == 1 and 338 not in tags}
    if ph not in (0, 1, 2, 3, 5, 6, 8) or (ph == 2 and spp < 3) \
            or (ph == 3 and (spp != 1 or bps == 16 or 320 not in tags)) \
            or not colour.get(ph, True):
        raise ValueError(f"{name}: TIFF of photometric "
                         f"{PHOTOMETRIC.get(ph, ph)} with {spp} samples of "
                         f"{bps} bits is not read here (cv2 returns no "
                         "image)")
    if not (0 < lay.width <= 1 << 20 and 0 < lay.height <= 1 << 20
            and lay.width * lay.height <= 1 << 30):
        raise ValueError(f"{name}: TIFF of {lay.width}x{lay.height} (cv2 "
                         "reads up to 2^20 a side and 2^30 pixels)")
    if lay.tiled and comp == 1:
        raise ValueError(f"{name}: uncompressed tiled TIFF is not read (cv2 "
                         "returns no image: libtiff's RGBA reader rejects "
                         "its tile byte counts)")
    if comp in _FAX and not packed:
        raise ValueError(f"{name}: CCITT compression of {spp} samples of "
                         f"{bps} bits is not read (libtiff's fax codec "
                         "takes 1-bit samples only)")
    if comp == 7 and (bps != 8 or ph not in (0, 1, 2, 5, 6)
                      or (ph == 6 and lay.planar != 1)):
        raise ValueError(f"{name}: JPEG-compressed TIFF of photometric "
                         f"{PHOTOMETRIC.get(ph, ph)} with {bps}-bit samples "
                         "is not read here")
    if ph == 6 and comp != 7:
        hs, vs = lay.subsampling
        if (hs, vs) not in (_SUBSAMPLINGS if lay.planar == 1 else ((1, 1),)):
            raise ValueError(f"{name}: YCbCr TIFF with subsampling {hs}x{vs}"
                             " is not read (cv2 returns no image)")
        if lay.predictor == 2 and (hs, vs) != (1, 1):
            raise ValueError(f"{name}: subsampled YCbCr TIFF with a "
                             "predictor is not read here")


def _jpeg_stream(lay: _Layout, data: bytes, k: int) -> bytes:
    """Chunk k's JPEG stream with the JPEGTables in front, as libjpeg
    reads the tables and then the abbreviated stream."""
    raw = bytes(data[lay.offsets[k]:lay.offsets[k] + lay.counts[k]])
    tables = lay.jpeg_tables
    if tables and len(tables) >= 4 and tables[:2] == b"\xff\xd8" \
            and raw[:2] == b"\xff\xd8":
        end = len(tables) - 2 if tables[-2:] == b"\xff\xd9" else len(tables)
        return tables[:end] + raw[2:]
    return raw


def _chunk(lay: _Layout, data: bytes, k: int, rows: int, x0: int, per: int,
           plain: bool) -> np.ndarray:
    """Chunk k (its first column x0) decoded to integer samples [rows,
    chunk width, per]: the rows a strip holds, or a whole tile (or as much
    of it as a quirk keeps)."""
    name, cw = lay.name, lay.cw
    if lay.counts[k] == 0:
        raise ValueError(f"{name}: TIFF chunk {k} of 0 bytes (cv2 returns "
                         "no image)")
    if lay.comp == 7:
        return _jpeg_chunk(lay, data, k, rows, plain)
    raw = data[lay.offsets[k]:lay.offsets[k] + lay.counts[k]]
    if lay.comp in _FAX:
        fax = ccitt.decode if plain else image_codec.fax_decode
        bits, _ = fax(raw, cw, rows, lay.comp, lay.t4options,
                      lay.fill_order, lay.codec)
        return bits[..., None].astype(np.int32)
    if lay.fill_order == 2:
        raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
    dtype = np.dtype(lay.e + ("u2" if lay.bps == 16 else "u1"))
    if lay.photometric == 6 and lay.subsampling != (1, 1) \
            and lay.planar == 1:
        hs, vs = lay.subsampling
        units_w, units_h = -(-cw // hs), -(-rows // vs)
        unit = hs * vs + 2
        full = units_w * units_h * unit
        # libtiff reads units_h * vs rows of (units_w * unit) // vs bytes.
        want = units_h * vs * (units_w * unit // vs)
        raw = np.frombuffer(_inflate(raw, lay.comp, want, name, plain)[0]
                            [:want].ljust(full, b"\0"), np.uint8)
        npix = min(cw, lay.width - x0)
        if (hs, vs) == (4, 4) and npix < cw:
            # putcontig8bitYCbCr44tile skips (cw - npix) // 4 units of 10
            # bytes at each unit row's end.
            used = -(-npix // 4)
            stride = used * unit + (cw - npix) // 4 * 10
            at = (np.arange(units_h)[:, None] * stride
                  + np.arange(used * unit)[None, :])
            raw, units_w = raw[np.minimum(at, full - 1)].reshape(-1), used
        return _ycbcr_units(raw, units_h, units_w, hs, vs)[:rows, :cw]
    row_bytes = (cw * per * lay.bps + 7) // 8
    want = rows * row_bytes
    raw, ok = _inflate(raw, lay.comp, want, name, plain)
    failed = not ok
    if failed:
        # libtiff's decode failed: the buffer is zero past what the codec
        # wrote, and neither the predictor nor the byte swap of a
        # big-endian file (postdecode) runs on it.
        raw = raw.ljust(want, b"\0")
        dtype = np.dtype("<u2" if lay.bps == 16 else "u1")
    block = _samples(raw, rows, row_bytes, cw, per, lay.bps, dtype)
    if lay.predictor == 2 and lay.comp in _PREDICTED and not failed:
        block = _unpredict(block)
    return block.astype(np.int32)


def _jpeg_chunk(lay: _Layout, data: bytes, k: int, rows: int,
                plain: bool) -> np.ndarray:
    """A JPEG strip or tile as libtiff's JPEG codec hands it on."""
    name = lay.name
    stream = _jpeg_stream(lay, data, k)
    ycc = lay.photometric == 6
    sampling = _stream_sampling(stream)
    if sampling and len(sampling) != lay.spp:
        raise ValueError(f"{name}: JPEG of {len(sampling)} components in a "
                         f"TIFF of {lay.spp} samples")
    want = (lay.subsampling if ycc else (1, 1),) + ((1, 1),) * (
        len(sampling) - 1)
    if sampling and tuple(sampling) != want:
        raise ValueError(f"{name}: JPEG sampling factors {sampling} in a "
                         f"TIFF that wants {want} (libtiff refuses them)")
    try:
        if not plain:
            out = image_codec.decode_jpeg_tiff(stream, lay.spp, ycc)
        else:
            out = jpeg.decode_planes(stream)
            if ycc:
                out = jpeg.ycc_to_rgb(*(out[..., i].astype(np.int64)
                                        for i in range(3)))
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None
    last = not lay.tiled and (k + 1) * lay.ch >= lay.height
    want_h = lay.ch if lay.tiled else rows
    if out.shape[1] != lay.cw or (out.shape[0] > want_h and not last):
        raise ValueError(f"{name}: JPEG of {out.shape[1]}x{out.shape[0]} "
                         f"in a TIFF chunk of {lay.cw}x{want_h} is not read "
                         "here")
    # A stream with fewer rows than its chunk: libjpeg stops there and the
    # rest of libtiff's buffer stays 0.
    block = np.zeros((want_h,) + out.shape[1:], np.int32)
    block[:min(want_h, out.shape[0])] = out[:want_h]
    return block


def _stream_sampling(stream: bytes) -> list:
    """Every component's (h, v) sampling factors in a JPEG's SOF ([] if
    none is found)."""
    pos = 2
    while pos + 4 <= len(stream) and stream[pos] == 0xFF:
        marker = stream[pos + 1]
        length = (stream[pos + 2] << 8) | stream[pos + 3]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            nc = stream[pos + 9] if pos + 9 < len(stream) else 0
            if pos + 10 + 3 * nc > len(stream):
                return []  # a cut SOF: the decoder names it
            return [(stream[pos + 11 + 3 * i] >> 4,
                     stream[pos + 11 + 3 * i] & 15) for i in range(nc)]
        pos += 2 + length
    return []


def _ycbcr_units(raw: np.ndarray, units_h: int, units_w: int, hs: int,
                 vs: int) -> np.ndarray:
    """YCbCr data units (hs * vs luma samples row by row, then Cb and Cr)
    → [units_h * vs, units_w * hs, 3], each pixel with its unit's
    chroma, as tif_getimage.c's putcontig8bitYCbCr*tile lays them out."""
    unit = hs * vs + 2
    u = raw[:units_h * units_w * unit].reshape(units_h, units_w, unit)
    y = u[..., :hs * vs].reshape(units_h, units_w, vs, hs) \
        .transpose(0, 2, 1, 3).reshape(units_h * vs, units_w * hs)
    cb = np.repeat(np.repeat(u[..., -2], vs, 0), hs, 1)
    cr = np.repeat(np.repeat(u[..., -1], vs, 0), hs, 1)
    return np.stack([y, cb, cr], -1).astype(np.int32)


def _samples(raw: bytes, rows: int, row_bytes: int, cw: int, per: int,
             bps: int, dtype: np.dtype) -> np.ndarray:
    """Decoded bytes of `rows` rows → integer samples [rows, cw, per]
    (1 and 4-bit samples unpacked, most significant bits first)."""
    if bps < 8:
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(
            rows, row_bytes), axis=1)[:, :cw * bps]
        return (bits.reshape(rows, cw, bps)
                @ (1 << np.arange(bps - 1, -1, -1)).astype(np.uint8)
                )[..., None]
    return np.frombuffer(raw, dtype).astype(dtype.newbyteorder("=")) \
        .reshape(rows, cw, per)


def _gray16_tile_rows(block: np.ndarray, valid: int) -> np.ndarray:
    """What cv2 makes of a 16-bit gray tile [rows, tile_width, 1] `valid`
    columns of which lie in the image: its 16-to-8-bit conversion steps
    through the tile's native (little-endian) bytes by tile_width + valid
    bytes a row, taking the byte at 2x + 1 of each row as column x's
    high byte. Full tiles come out as they are; a partial tile's rows
    after the first take bytes of the rows before them. Returned as
    16-bit values whose high byte is that byte."""
    rows, cw = block.shape[:2]
    buf = np.frombuffer(block.astype("<u2").tobytes(), np.uint8)
    at = (np.arange(rows)[:, None] * (cw + valid)
          + 2 * np.arange(valid)[None, :] + 1)
    out = np.zeros((rows, cw, 1), np.uint16)
    out[:, :valid, 0] = buf[at].astype(np.uint16) << 8
    return out


def _inflate(raw: bytes, comp: int, want: int, name, plain: bool
             ) -> tuple[bytes, bool]:
    """A chunk's first `want` bytes decoded, and whether libtiff's codec
    succeeded. Where LZW, PackBits or deflate data fails or ends first,
    the codec's output up to there, which libtiff keeps (its buffer is
    zero past it). zlib also fails a strip it has filled where what it
    reads before it would write again is wrong (the check value at the
    stream's end, say). An uncompressed chunk too short is refused."""
    if comp == 1:
        out = raw[:want]
        if len(out) < want:
            raise ValueError(f"{name}: TIFF none data of {len(out)} bytes, "
                             f"want {want} (cv2 returns no image)")
        return out, True
    if comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, want)
        except zlib.error:
            return inflate_partial(raw, want), False
    elif plain:
        out = (lzw_decode_plain if comp == 5 else packbits_plain)(raw, want)
    else:
        out = (image_codec.tiff_lzw if comp == 5
               else image_codec.packbits)(raw, want)
    return out, len(out) == want


def _to_rgb(samples: np.ndarray, bps: int, photometric: int,
            tags: dict) -> np.ndarray:
    if photometric in (0, 1):
        g = samples[:, :, 0] >> 8 if bps == 16 else samples[:, :, 0]
        if bps == 1:
            g = g * 255
        if photometric == 0:
            g = 255 - g
        return np.ascontiguousarray(
            np.repeat(g[:, :, None], 3, axis=2).astype(np.uint8))
    if photometric == 3:
        cmap = np.asarray(tags[320], np.int64).reshape(3, -1)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        full = np.zeros((3, 256), np.int64)
        full[:, :min(256, cmap.shape[1])] = cmap[:, :256]
        return np.ascontiguousarray(
            full[:, samples[:, :, 0]].transpose(1, 2, 0).astype(np.uint8))
    if photometric == 5:
        # putRGBcontig8bitCMYKtile / putCMYKseparate8bittile.
        k = 255 - samples[:, :, 3:4]
        return np.ascontiguousarray(
            (k * (255 - samples[:, :, :3]) // 255).astype(np.uint8))
    if photometric == 6:
        return ycbcr_to_rgb(samples, tags)
    if photometric == 8:
        return cielab_to_rgb(samples, bps, tags)
    v = samples
    if bps == 16:
        v = (v * 255 + 32767) // 65535
    rgb = v[:, :, :3]
    if samples.shape[2] >= 4 and tags.get(338, [0])[0] == 2:
        rgb = (rgb * v[:, :, 3:4] + 127) // 255
    return np.ascontiguousarray(rgb.astype(np.uint8))


# --- libtiff's colour conversions (tif_color.c) ----------------------------

_F = np.float32


def _fix(x) -> int:
    """tif_color.c FIX: (int32_t)(x * (1L << 16) + 0.5), the product in
    float."""
    return int(float(_F(x) * _F(65536)) + 0.5)


def _clampw(f, lo: float, hi: float):
    return np.where(f < _F(lo), _F(lo), np.where(f > _F(hi), _F(hi), f))


def _code2v(c: np.ndarray, rb, rw, cr: int) -> np.ndarray:
    """Code2V: ((c - (int32_t)RB) * (float)CR) / (float)(RW - RB or 1)."""
    rb, rw = _F(rb), _F(rw)
    span = rw - rb
    return ((c - int(rb)).astype(_F) * _F(cr)) / (span if span != 0
                                                    else _F(1))


def ycbcr_tables(tags: dict) -> tuple:
    """TIFFYCbCrToRGBInit's tables (Cr_r, Cb_b, Cr_g, Cb_g, Y) for the
    file's YCbCrCoefficients and ReferenceBlackWhite, or their defaults
    (libtiff's 0.299, 0.587, 0.114 and 0, 255, 128, 255, 128, 255)."""
    luma = [_F(v) for v in tags.get(529, (0.299, 0.587, 0.114))]
    rbw = [_F(v) for v in tags.get(532, (0, 255, 128, 255, 128, 255))]
    if len(luma) < 3 or len(rbw) < 6 or np.isnan(luma).any() \
            or luma[1] == 0 or not all(
                _F(-0x7FFFFFFF + 128) < v < _F(0x7FFFFFFF) for v in rbw):
        raise ValueError("TIFF with invalid YCbCrCoefficients or "
                         "ReferenceBlackWhite (cv2 returns no image)")
    lr, lg, lb = luma[:3]
    f1 = _F(2) - _F(2) * lr
    d1 = _fix(min(max(f1, _F(0)), _F(2)))
    f2 = lr * f1 / lg
    d2 = -_fix(min(max(f2, _F(0)), _F(2)))
    f3 = _F(2) - _F(2) * lb
    d3 = _fix(min(max(f3, _F(0)), _F(2)))
    f4 = lb * f3 / lg
    d4 = -_fix(min(max(f4, _F(0)), _F(2)))
    x = np.arange(-128, 128, dtype=np.int64)
    cr = np.trunc(_clampw(_code2v(x, rbw[4] - _F(128), rbw[5] - _F(128),
                                  127), -4096, 4096)).astype(np.int64)
    cb = np.trunc(_clampw(_code2v(x, rbw[2] - _F(128), rbw[3] - _F(128),
                                  127), -4096, 4096)).astype(np.int64)
    y = np.trunc(_clampw(_code2v(x + 128, rbw[0], rbw[1], 255),
                         -4096, 4096)).astype(np.int64)
    half = 1 << 15
    return ((d1 * cr + half) >> 16, (d3 * cb + half) >> 16, d2 * cr,
            d4 * cb + half, y)


def ycbcr_to_rgb(samples: np.ndarray, tags: dict) -> np.ndarray:
    """TIFFYCbCrtoRGB on full-size Y, Cb, Cr samples [H, W, 3+]."""
    cr_r, cb_b, cr_g, cb_g, ytab = ycbcr_tables(tags)
    y = ytab[samples[:, :, 0]]
    cb, cr = samples[:, :, 1], samples[:, :, 2]
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.ascontiguousarray(
        np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8))


# tif_getimage.c display_sRGB.
_SRGB_MATRIX = np.array([[3.2410, -1.5374, -0.4986],
                         [-0.9692, 1.8760, 0.0416],
                         [0.0556, -0.2040, 1.0570]], _F)
_D50 = (_F(96.4250), _F(100.0), _F(82.4680))


def cielab_to_rgb(samples: np.ndarray, bps: int, tags: dict) -> np.ndarray:
    """putcontig8bitCIELab8 / 16: TIFFCIELab16ToXYZ (8-bit L scaled by
    257, a and b by 256) and TIFFXYZToRGB onto display_sRGB, in float32
    as libtiff computes (no fused multiply-add), with the file's
    WhitePoint or the D50 default."""
    white = tags.get(318)
    if white is None:
        total = _D50[0] + _D50[1] + _D50[2]
        white = (_D50[0] / total, _D50[1] / total)
    wx, wy = _F(white[0]), _F(white[1])
    if wy == 0:
        raise ValueError("TIFF with a WhitePoint of y = 0 (cv2 returns no "
                         "image)")
    y0 = _F(100)
    x0 = wx / wy * y0
    z0 = (_F(1) - wx - wy) / wy * y0
    if bps == 8:
        l16 = samples[:, :, 0].astype(np.int64) * 257
        a16 = samples[:, :, 1].astype(np.int8).astype(np.int64) * 256
        b16 = samples[:, :, 2].astype(np.int8).astype(np.int64) * 256
    else:
        l16 = samples[:, :, 0].astype(np.int64)
        a16 = samples[:, :, 1].astype(np.int16).astype(np.int64)
        b16 = samples[:, :, 2].astype(np.int16).astype(np.int64)
    L = l16.astype(_F) * _F(100) / _F(65535)
    small = L < _F(8.856)
    y_small = (L * y0) / _F(903.292)
    cby_small = _F(7.787) * (y_small / y0) + _F(16) / _F(116)
    cby_big = (L + _F(16)) / _F(116)
    y_big = y0 * cby_big * cby_big * cby_big
    Y = np.where(small, y_small, y_big)
    cby = np.where(small, cby_small, cby_big)

    def axis(t, ref):
        return np.where(t < _F(0.2069), ref * (t - _F(0.13793)) / _F(7.787),
                        ref * t * t * t)

    X = axis(a16.astype(_F) / _F(256) / _F(500) + cby, x0)
    Z = axis(cby - b16.astype(_F) / _F(256) / _F(200), z0)
    m = _SRGB_MATRIX
    rng = 1500
    step = (_F(100) - _F(1)) / _F(rng)
    table = (_F(255) * np.power(np.arange(rng + 1) / rng,
                                1.0 / float(_F(2.4))).astype(_F))
    out = []
    for row in m:
        lum = row[0] * X + row[1] * Y + row[2] * Z
        lum = np.minimum(np.maximum(lum, _F(1)), _F(100))
        i = np.minimum(((lum - _F(1)) / step).astype(np.int64), rng)
        v = table[i].astype(np.float64)
        out.append(np.minimum(np.where(v > 0, v + 0.5, v - 0.5)
                              .astype(np.int64), 255))
    return np.ascontiguousarray(np.stack(out, -1).astype(np.uint8))


# --- the coders' plain versions ---------------------------------------------


def lzw_decode_plain(raw: bytes, want: int) -> bytes:
    """libtiff's LZWDecode (or LZWDecodeCompat for old-style streams) of
    one strip or tile, up to `want` bytes. A code before the first clear
    code, past the table, or after the table is full is an error at which
    libtiff stops: what came before it is returned."""
    old = len(raw) >= 2 and raw[0] == 0 and raw[1] & 1
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits, pos, bitbuf, nbuf = 9, 0, 0, 0
    prev = None
    cleared = False
    total_bits = len(raw) * 8
    consumed = 0
    while len(out) < want:
        if total_bits - consumed < nbits:
            break  # libtiff: a strip not ended by EOI ends here
        if old:
            while nbuf < nbits:
                bitbuf |= raw[pos] << nbuf
                pos += 1
                nbuf += 8
            code = bitbuf & ((1 << nbits) - 1)
            bitbuf >>= nbits
        else:
            while nbuf < nbits:
                bitbuf = (bitbuf << 8) | raw[pos]
                pos += 1
                nbuf += 8
            code = (bitbuf >> (nbuf - nbits)) & ((1 << nbits) - 1)
            bitbuf &= (1 << (nbuf - nbits)) - 1
        nbuf -= nbits
        consumed += nbits
        if code == 257:
            break
        if code == 256:
            del table[258:]
            nbits, prev, cleared = 9, None, True
            continue
        if not cleared or len(table) >= 4096 and prev is not None:
            break
        if prev is None:
            if code > 256:
                break
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(table[prev] + entry[:1])
        elif code == len(table):
            entry = table[prev] + table[prev][:1]
            table.append(entry)
        else:
            break
        out += entry
        prev = code
        if len(table) > (1 << nbits) - (1 if old else 2) and nbits < 12:
            nbits += 1
    return bytes(out[:want])


def packbits_plain(raw: bytes, want: int) -> bytes:
    """libtiff's PackBitsDecode of one strip or tile, up to `want`
    bytes."""
    out = bytearray()
    i, n_raw = 0, len(raw)
    while i < n_raw and len(out) < want:
        n = raw[i]
        i += 1
        if n >= 128:
            n -= 256
        if n < 0:
            if n == -128:
                continue
            n = min(-n + 1, want - len(out))
            if i >= n_raw:
                break
            out += bytes([raw[i]]) * n
            i += 1
        else:
            n = min(n + 1, want - len(out))
            if n_raw - i < n:
                break
            out += raw[i:i + n]
            i += n
    return bytes(out)


def lzw_encode_plain(data: bytes) -> bytes:
    """libtiff's LZWEncode of one strip, LZWPostEncode included: codes MSB
    first from 9 bits, a clear code first, the table reset at 4094
    entries, and after 10000 input bytes whenever the compression ratio
    stops improving."""
    out = bytearray()
    state = {"data": 0, "bits": 0, "outcount": 0}
    nbits, maxcode, free_ent = 9, 511, 258
    incount, checkpoint, ratio = 0, 10000, 0
    table: dict[tuple[int, int], int] = {}

    def put(code: int) -> None:
        state["data"] = ((state["data"] << nbits) | code) & 0xFFFFFFFF
        state["bits"] += nbits
        while state["bits"] >= 8:
            out.append((state["data"] >> (state["bits"] - 8)) & 0xFF)
            state["bits"] -= 8
        state["outcount"] += nbits

    def reset() -> None:
        nonlocal nbits, maxcode, free_ent, incount, ratio
        table.clear()
        ratio = incount = 0
        state["outcount"] = 0
        free_ent = 258
        put(256)
        nbits, maxcode = 9, 511

    ent = -1
    if data:
        put(256)
        ent, incount = data[0], 1
    for c in data[1:]:
        incount += 1
        code = table.get((ent, c))
        if code is not None:
            ent = code
            continue
        put(ent)
        table[(ent, c)] = free_ent
        free_ent += 1
        ent = c
        if free_ent == 4094:
            reset()
        elif free_ent > maxcode:
            nbits += 1
            maxcode = (1 << nbits) - 1
        elif incount >= checkpoint:
            checkpoint = incount + 10000
            rat = (incount << 8) // state["outcount"]
            if rat <= ratio:
                reset()
            else:
                ratio = rat
    if ent != -1:
        put(ent)
        free_ent += 1
        if free_ent == 4094:
            state["outcount"] = 0
            put(256)
            nbits = 9
        elif free_ent > maxcode:
            nbits += 1
    put(257)
    if state["bits"]:
        out.append((state["data"] << (8 - state["bits"])) & 0xFF)
    return bytes(out)


def rows_per_strip(height: int, width: int) -> int:
    """cv2's RowsPerStrip for a 3-channel 8-bit image."""
    return max(1, min(height, 8192 // (width * 3)))


def encode(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] → the bytes `cv2.imencode(".tif", bgr)` writes
    (see the module docstring)."""
    h, w = rgb.shape[:2]
    rps = rows_per_strip(h, w)
    strips = []
    for y in range(0, h, rps):
        block = rgb[y:y + rps].astype(np.int16)
        diff = block.copy()
        diff[:, 1:] -= block[:, :-1]
        strips.append(lzw_encode_plain((diff & 0xFF).astype(np.uint8)
                                       .tobytes()))
    return _assemble(strips, h, w, rps)


def _assemble(strips: list[bytes], h: int, w: int, rps: int) -> bytes:
    """Header, strips, IFD0 and its out-of-line values as libtiff lays
    them out for cv2's 3-channel LZW TIFF."""
    body = bytearray(b"II*\x00\x00\x00\x00\x00")
    offsets = []
    for s in strips:
        offsets.append(len(body))
        body += s
    if len(body) & 1:
        body += b"\x00"
    ifd = len(body)
    body[4:8] = struct.pack("<I", ifd)
    n = len(strips)
    short_counts = n > 1 and rps * w * 3 < 0xFFFF // 10
    tail = ifd + 2 + 12 * 12 + 4
    extra = bytearray()

    def out_of_line(fmt: str, values) -> int:
        nonlocal extra
        at = tail + len(extra)
        extra += struct.pack("<" + fmt * len(values), *values)
        return at

    bits_at = out_of_line("H", [8, 8, 8])
    counts = [len(s) for s in strips]
    if n > 1:
        counts_at = out_of_line("H" if short_counts else "I", counts)
        offsets_at = out_of_line("I", offsets)
    formats_at = out_of_line("H", [1, 1, 1])

    def entry(tag, typ, count, value) -> bytes:
        return struct.pack("<HHII", tag, typ, count, value)

    entries = [
        entry(256, 3, 1, w), entry(257, 3, 1, h),
        entry(258, 3, 3, bits_at), entry(259, 3, 1, 5), entry(262, 3, 1, 2),
        entry(273, 4, n, offsets_at if n > 1 else offsets[0]),
        entry(277, 3, 1, 3), entry(278, 3, 1, rps),
        entry(279, 3 if short_counts else 4, n,
              counts_at if n > 1 else counts[0]),
        entry(284, 3, 1, 1), entry(317, 3, 1, 2),
        entry(339, 3, 3, formats_at)]
    return bytes(body + struct.pack("<H", 12) + b"".join(entries)
                 + b"\x00\x00\x00\x00" + extra)
