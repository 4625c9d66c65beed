"""TIFF as OpenCV 5.0 reads and writes it through libtiff
(`grfmt_tiff.cpp`).

`decode` reads the first image (IFD0) of a classic TIFF, either byte
order: 8 and 16-bit samples; gray (MinIsBlack, MinIsWhite inverted),
RGB, RGB with an alpha sample and palette (a colormap with any entry
past 255 is taken as 16-bit and keeps its high bytes, as libtiff's
checkcmap decides); 1-bit gray and 1 and 4-bit palette indices (cv2
returns no image for 2-bit samples or 4-bit gray); chunky or planar;
strips or tiles;
compression none, LZW, PackBits and deflate (8 and 32946); the
horizontal predictor (2) where the compression takes one (LZW and
deflate; libtiff ignores it under none and PackBits). What cv2 makes of
the samples:
- 16-bit gray keeps the high byte (`v >> 8`); 16-bit RGB is rounded,
  `(v * 255 + 32767) // 65535`. On 16-bit gray tiles cv2's conversion
  steps through a tile of which only part lies in the image by the
  wrong row length (`_gray16_tile_rows`), and that is reproduced (with
  an extra sample it is refused by name);
- an unassociated alpha (ExtraSamples 2) premultiplies the colour,
  `(c * a + 127) // 255` on 8-bit values, as libtiff's RGBA reader does;
  any other alpha is dropped;
- the Exif orientation of IFD0 (tag 274) is applied as for a JPEG. On
  8-bit tiles cv2 reads through libtiff's RGBA tile reader, which
  mirrors each tile of orientations 2, 3, 6 and 7 in place before cv2
  mirrors the image: the columns of tiles come out reversed.
The LZW and PackBits streams are run by the host C library
(`image_codec.tiff_lzw`, `image_codec.packbits`); `lzw_decode_plain` and
`packbits_plain` are their plain versions. LZW codes are read MSB first
with libtiff's early change of code width; a strip that starts with the
bytes 00 and an odd byte is libtiff's old-style LZW (codes LSB first,
the width changing one code later). A strip that ends before its rows
are filled gives no image, as in libtiff.

Refused by name: tiles without compression (libtiff's RGBA reader, which
cv2 uses for 8-bit tiles, rejects their byte counts, so cv2 returns no
image), JPEG, CCITT and the other compressions (C9b in the roadmap),
sample depths and photometric interpretations other than the above
(CMYK, YCbCr, CIELab), BigTIFF.

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

from multiposenet_tpu_torch.utils import image_codec

# IFD entry types read (the numeric ones a reader needs): struct codes.
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i"}
COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT group 3",
                4: "CCITT group 4", 5: "LZW", 6: "old JPEG", 7: "JPEG",
                8: "deflate", 32773: "PackBits", 32946: "deflate",
                34712: "JPEG 2000", 34925: "LZMA", 50000: "ZSTD",
                50001: "WebP", 34887: "LERC"}
_PREDICTED = (5, 8, 32946)
PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "palette",
               4: "mask", 5: "CMYK", 6: "YCbCr", 8: "CIELab"}


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
        if typ not in _TYPE_FMT:
            continue
        size = struct.calcsize(_TYPE_FMT[typ]) * n
        where = at + 8 if size <= 4 else struct.unpack(
            e + "I", data[at + 8:at + 12])[0]
        if where + size > len(data):
            raise ValueError(f"{name}: TIFF tag {tag} past the end")
        tags[tag] = list(struct.unpack(e + _TYPE_FMT[typ] * n,
                                       data[where:where + size]))
    return e, tags


def _one(tags: dict, tag: int, default=None):
    return tags[tag][0] if tag in tags else default


def _unpredict(block: np.ndarray) -> np.ndarray:
    """Undo the horizontal predictor on [rows, cols, samples] of uint8 or
    uint16 (the sums wrap at the sample's width)."""
    return np.cumsum(block, axis=1, dtype=block.dtype)


def decode(data: bytes, name="<bytes>", plain: bool = False) -> np.ndarray:
    """TIFF bytes → uint8 RGB [H, W, 3] as `cv2.imdecode(buf,
    IMREAD_COLOR)` reversed to RGB (see the module docstring). `plain`
    runs LZW and PackBits in Python instead of C."""
    e, tags = _tags(data, name)
    width, height = _one(tags, 256, 0), _one(tags, 257, 0)
    spp = _one(tags, 277, 1)
    bps_all = tags.get(258, [1])
    bps = bps_all[0]
    comp = _one(tags, 259, 1)
    photometric = _one(tags, 262)
    planar = _one(tags, 284, 1)
    predictor = _one(tags, 317, 1)
    fmt = tags.get(339, [1])
    if comp not in (1, 5, 8, 32773, 32946):
        raise ValueError(f"{name}: TIFF with "
                         f"{COMPRESSIONS.get(comp, f'compression {comp}')} "
                         "compression is not read here")
    packed = (bps == 1 and photometric in (0, 1, 3) and spp == 1) or (
        bps == 4 and photometric == 3 and spp == 1)
    if (bps not in (8, 16) and not packed) \
            or any(b != bps for b in bps_all) or any(f != 1 for f in fmt):
        raise ValueError(f"{name}: TIFF with {bps_all}-bit samples of format "
                         f"{fmt} and photometric "
                         f"{PHOTOMETRIC.get(photometric, photometric)} is not "
                         "read here (8 and 16-bit unsigned, 1-bit gray and "
                         "palette, 4-bit palette; cv2 returns no image for "
                         "2-bit samples and 4-bit gray)")
    if photometric not in (0, 1, 2, 3) or (photometric == 2 and spp < 3) \
            or (photometric == 3 and (spp != 1 or bps == 16
                                      or 320 not in tags)):
        raise ValueError(f"{name}: TIFF of photometric "
                         f"{PHOTOMETRIC.get(photometric, photometric)} with "
                         f"{spp} samples of {bps} bits is not read here")
    if width <= 0 or height <= 0:
        raise ValueError(f"{name}: TIFF of {width}x{height}")
    tiled = 322 in tags
    if tiled and comp == 1:
        raise ValueError(f"{name}: uncompressed tiled TIFF is not read (cv2 "
                         "returns no image: libtiff's RGBA reader rejects "
                         "its tile byte counts)")
    if tiled:
        cw, ch = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        cw, ch = width, min(_one(tags, 278, 2**32 - 1), height)
        offsets, counts = tags.get(273), tags.get(279)
    if not offsets or not counts or not cw or not ch:
        raise ValueError(f"{name}: TIFF without its data offsets")
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp
    dtype = np.dtype(e + ("u2" if bps == 16 else "u1"))
    row_bytes = (cw * per * bps + 7) // 8
    across, down = -(-width // cw), -(-height // ch)
    if len(offsets) < planes * across * down or len(counts) < len(offsets):
        raise ValueError(f"{name}: TIFF lists {len(offsets)} chunks, want "
                         f"{planes * across * down}")
    samples = np.zeros((height, width, spp), np.int32)
    k = 0
    for p in range(planes):
        # A plane's strips decode into one band of rows; tiles one by one.
        chunks = []
        for ty in range(down):
            for tx in range(across):
                rows = ch if tiled else min(ch, height - ty * ch)
                raw = data[offsets[k]:offsets[k] + counts[k]]
                k += 1
                chunks.append((ty * ch, tx * cw, rows, _inflate(
                    raw, comp, rows * row_bytes, name, plain)))
        if not tiled:
            chunks = [(0, 0, height, b"".join(c[3] for c in chunks))]
        for y0, x0, rows, raw in chunks:
            block = _samples(raw, rows, row_bytes, cw, per, bps, dtype)
            if predictor == 2 and comp in _PREDICTED:
                block = _unpredict(block)
            if tiled and bps == 16 and photometric in (0, 1) \
                    and width - x0 < cw:
                if spp > 1:
                    raise ValueError(
                        f"{name}: 16-bit gray TIFF with an extra sample in "
                        "tiles the image only partly covers is not read "
                        "here (cv2 fills them from other rows by a rule "
                        "not reproduced)")
                block = _gray16_tile_rows(block, width - x0)
            part = block[:height - y0, :width - x0]
            samples[y0:y0 + part.shape[0], x0:x0 + part.shape[1],
                    p * per:(p + 1) * per] = part
    rgb = _to_rgb(samples, bps, photometric, tags)
    from multiposenet_tpu_torch.utils.image_io import (apply_orientation,
                                                        exif_orientation)
    orientation = exif_orientation(data)
    if tiled and orientation in (2, 3, 6, 7):
        # libtiff's RGBA tile reader mirrors each tile's columns in place;
        # cv2's mirror of the whole image then leaves the tiles' columns
        # in file order but the columns of tiles reversed.
        rgb = np.concatenate([rgb[:, x:x + cw] for x in
                              range(0, width, cw)][::-1], axis=1)
    return apply_orientation(rgb, orientation)


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


def _inflate(raw: bytes, comp: int, want: int, name, plain: bool) -> bytes:
    if comp == 1:
        out = raw[:want]
    elif comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, want)
        except zlib.error as exc:
            raise ValueError(f"{name}: corrupt TIFF deflate data ({exc})") \
                from None
    elif plain:
        out = (lzw_decode_plain if comp == 5 else packbits_plain)(raw, want)
    else:
        out = (image_codec.tiff_lzw if comp == 5
               else image_codec.packbits)(raw, want)
    if len(out) < want:
        raise ValueError(f"{name}: TIFF {COMPRESSIONS[comp]} data of "
                         f"{len(out)} bytes, want {want} (cv2 returns no "
                         "image)")
    return out


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
    v = samples
    if bps == 16:
        v = (v * 255 + 32767) // 65535
    rgb = v[:, :, :3]
    if samples.shape[2] >= 4 and tags.get(338, [0])[0] == 2:
        rgb = (rgb * v[:, :, 3:4] + 127) // 255
    return np.ascontiguousarray(rgb.astype(np.uint8))


# --- the coders' plain versions ---------------------------------------------


def lzw_decode_plain(raw: bytes, want: int) -> bytes:
    """libtiff's LZWDecode (or LZWDecodeCompat for old-style streams) of
    one strip or tile, up to `want` bytes; an error in the codes raises."""
    old = len(raw) >= 2 and raw[0] == 0 and raw[1] & 1
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits, pos, bitbuf, nbuf = 9, 0, 0, 0
    prev = None
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
            nbits, prev = 9, None
            continue
        if prev is None:
            if code > 256:
                raise ValueError("LZW code before any entry")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(table[prev] + entry[:1])
        elif code == len(table):
            entry = table[prev] + table[prev][:1]
            table.append(entry)
        else:
            raise ValueError("corrupted LZW table")
        out += entry
        prev = code
        if len(table) > (1 << nbits) - (1 if old else 2) and nbits < 12:
            nbits += 1
        if len(table) > 4096:
            raise ValueError("LZW table overflow")
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
