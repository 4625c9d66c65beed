"""Image files of the simple formats built byte by byte, for checking the
readers where no cv2 or Pillow is at hand (the card's machine) and for
the CPU tests that hold them to cv2.

`tiff_bytes` lays out a classic TIFF of any sample layout the reader
takes (strips or tiles, chunky or planar, 1, 2, 4, 8 or 16 bits, compression
none, LZW, PackBits or deflate, the horizontal predictor, a colormap,
ExtraSamples, an orientation); `gif_bytes` a GIF of frames with global
or local palettes, interlace and transparency, coded with literal LZW
codes and a clear code before the width would grow (or with any stream,
such as `gif_lzw`'s compressed codes); `bmp_bytes` a BMP
of a given header, depth, compression and pixel data (RLE streams are
passed as bytes); `packbits_encode` a PackBits stream. The LZW strips
come from `utils/tiff.py lzw_encode_plain`, libtiff's encoder.
`quantised_gif` is the 3-3-2 palette GIF of an RGB image, and
`corrupted` applies a recorded corruption (the `corrupt` recipes of
tests/fixtures/images/digests.json: bytes set or inserted, or a cut). `stray_recipes` puts bytes that are
no marker segment before each segment of a JPEG's header, and
`sampling_recipes` sets each component's sampling factors to every
value; `outcomes_sha256` is the digest the fixtures record for the
decodes of such a set.
"""

from __future__ import annotations

import hashlib
import struct
import zlib

import numpy as np

from multiposenet_tpu_torch.utils import tiff


def packbits_encode(data: bytes) -> bytes:
    """A PackBits stream of `data`: runs of 2-128 equal bytes, literals
    of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n
                                              and data[j] == data[j + 1]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_bytes(img: np.ndarray, photometric: int, bps: int = 8,
               compression: int = 1, predictor: int = 1, planar: int = 1,
               rows_per_strip: int | None = None,
               tile: tuple[int, int] | None = None, colormap=None,
               extra=None, orientation: int | None = None,
               big_endian: bool = False, chunks: list[bytes] | None = None,
               tags: tuple = ()) -> bytes:
    """A TIFF of `img` ([h, w] or [h, w, samples] integer sample values).
    `chunks` replaces the coded strips or tiles (in file order) by the
    bytes given, e.g. JPEG or CCITT streams; `tags` adds (tag, type,
    values) entries: type 3 or 4 integers, 5 (RATIONAL) (numerator,
    denominator) pairs, 7 (UNDEFINED) bytes."""
    e = ">" if big_endian else "<"
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    dt = np.dtype(e + ("u2" if bps == 16 else "u1"))

    def encode(block: np.ndarray) -> bytes:
        b = block.astype(np.int64)
        if predictor == 2:
            b[:, 1:] = b[:, 1:] - block[:, :-1].astype(np.int64)
        if bps < 8:  # samples packed MSB first, each row to a byte
            bits = (b.reshape(len(b), -1, 1) >> np.arange(bps - 1, -1, -1)) & 1
            raw = np.packbits(bits.reshape(len(b), -1).astype(np.uint8),
                              axis=1).tobytes()
        else:
            raw = (b % (1 << bps)).astype(dt).tobytes()
        if compression == 5:
            return tiff.lzw_encode_plain(raw)
        if compression == 32773:
            return packbits_encode(raw)
        if compression in (8, 32946):
            return zlib.compress(raw)
        return raw

    planes = [img] if planar == 1 else [img[..., k:k + 1]
                                        for k in range(spp)]
    given, chunks = chunks, []
    for p in planes if given is None else ():
        if tile is None:
            rps = rows_per_strip or h
            chunks += [encode(p[y:y + rps]) for y in range(0, h, rps)]
            continue
        th, tw = tile
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                blk = np.zeros((th, tw, p.shape[2]), p.dtype)
                part = p[ty:ty + th, tx:tx + tw]
                blk[:part.shape[0], :part.shape[1]] = part
                chunks.append(encode(blk))
    if given is not None:
        chunks = list(given)
    out = bytearray((b"MM\x00*" if big_endian else b"II*\x00") + b"\0" * 4)
    offsets = []
    for c in chunks:
        offsets.append(len(out))
        out += c
        if len(out) & 1:
            out += b"\0"
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bps] * spp),
               (259, 3, [compression]), (262, 3, [photometric]),
               (273 if tile is None else 324, 4, offsets), (277, 3, [spp]),
               (279 if tile is None else 325, 4, [len(c) for c in chunks]),
               (284, 3, [planar])]
    if orientation:
        entries.append((274, 3, [orientation]))
    if tile is None:
        entries.append((278, 4, [rows_per_strip or h]))
    else:
        entries += [(322, 4, [tile[1]]), (323, 4, [tile[0]])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, list(np.asarray(colormap).reshape(-1))))
    if extra is not None:
        entries.append((338, 3, list(extra)))
    entries = sorted([x for x in entries if x[0] not in {t[0] for t in tags}]
                     + list(tags))
    ifd = len(out)
    out[4:8] = struct.pack(e + "I", ifd)
    tail_at = ifd + 2 + 12 * len(entries) + 4
    tail, table = bytearray(), bytearray(struct.pack(e + "H", len(entries)))
    for tag, typ, vals in entries:
        if typ == 7:
            data, count = bytes(vals), len(vals)
        else:
            flat = [int(v) for v in np.asarray(vals).reshape(-1)]
            data = struct.pack(e + {3: "H", 4: "I", 5: "I"}[typ] * len(flat),
                               *flat)
            count = len(flat) // (2 if typ == 5 else 1)
        if len(data) <= 4:
            table += struct.pack(e + "HHI", tag, typ, count) + \
                data.ljust(4, b"\0")
        else:
            table += struct.pack(e + "HHII", tag, typ, count,
                                 tail_at + len(tail))
            tail += data + b"\0" * (len(data) & 1)
    return bytes(out + table + b"\0" * 4 + tail)


def ycbcr_units(ycc: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """Full-size Y, Cb, Cr samples [h, w, 3] → TIFF YCbCr data units
    [ceil(h / vs), ceil(w / hs), hs * vs + 2]: the unit's luma row by row
    (edges repeated), then the Cb and Cr of its top-left sample."""
    h, w = ycc.shape[:2]
    uh, uw = -(-h // vs), -(-w // hs)
    full = np.pad(ycc, ((0, uh * vs - h), (0, uw * hs - w), (0, 0)),
                  mode="edge")
    y = full[..., 0].reshape(uh, vs, uw, hs).transpose(0, 2, 1, 3) \
        .reshape(uh, uw, vs * hs)
    return np.concatenate([y, full[::vs, ::hs, 1:]], -1).astype(np.uint8)


def timing_tiffs(photo_jpeg: bytes, rgb: np.ndarray) -> dict[str, bytes]:
    """The TIFFs timed at a photo's size: "jpeg_ycc420", the JPEG photo
    (a JFIF 4:2:0 stream) as the one strip of a YCbCr JPEG TIFF;
    "cmyk", its pixels as CMYK with the gray component taken out (k =
    min(255 - r, 255 - g, 255 - b)), uncompressed in strips of 16 rows;
    "ycbcr22", its pixels as 2x2-subsampled YCbCr units (JPEG's integer
    RGB -> YCbCr), uncompressed in strips of 16 rows."""
    rgb = np.asarray(rgb, np.int64)
    h, w = rgb.shape[:2]
    out = {"jpeg_ycc420": tiff_bytes(rgb, 6, compression=7,
                                     chunks=[photo_jpeg],
                                     tags=((530, 3, [2, 2]),))}
    cmy = 255 - rgb
    k = cmy.min(-1, keepdims=True)
    out["cmyk"] = tiff_bytes(np.concatenate([cmy - k, k], -1), 5,
                             rows_per_strip=16)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    ycc = np.stack([(19595 * r + 38470 * g + 7471 * b + 32768) >> 16,
                    ((-11059 * r - 21709 * g + 32768 * b + 32767) >> 16)
                    + 128,
                    ((32768 * r - 27439 * g - 5329 * b + 32767) >> 16)
                    + 128], -1).clip(0, 255)
    chunks = [ycbcr_units(ycc[y:y + 16], 2, 2).tobytes()
              for y in range(0, h, 16)]
    out["ycbcr22"] = tiff_bytes(ycc, 6, rows_per_strip=16, chunks=chunks,
                                tags=((530, 3, [2, 2]),))
    return out


def gif_lzw_literal(indices, min_size: int) -> bytes:
    """GIF LZW codes of `indices`, each a literal, with a clear code
    before the table would widen the codes."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    width = min_size + 1
    limit = (1 << width) - (1 << min_size) - 2
    codes, n = [clear], 0
    for v in indices:
        if n == limit:
            codes.append(clear)
            n = 0
        codes.append(int(v))
        n += 1
    codes.append(eoi)
    acc = bits = 0
    out = bytearray()
    for c in codes:
        acc |= c << bits
        bits += width
        while bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            bits -= 8
    if bits:
        out.append(acc & 0xFF)
    return bytes(out)


def gif_lzw(indices, min_size: int, clear_when_full: bool = False) -> bytes:
    """GIF LZW codes of `indices`, compressed: the longest known string
    each code, the width growing one code after the table reaches
    1 << width (as decoders read it), up to 12 bits; at 4096 entries the
    table stops growing, or is cleared with `clear_when_full`."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    width, nxt, table = min_size + 1, eoi + 1, {}
    codes = [(clear, width)]
    indices = [int(v) for v in indices]
    w = (indices[0],)
    for v in indices[1:]:
        wc = w + (v,)
        if wc in table:
            w = wc
            continue
        codes.append((table[w] if len(w) > 1 else w[0], width))
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
            if nxt > 1 << width and width < 12:
                width += 1
        elif clear_when_full:
            codes.append((clear, width))
            width, nxt, table = min_size + 1, eoi + 1, {}
        w = (v,)
    codes += [(table[w] if len(w) > 1 else w[0], width), (eoi, width)]
    acc = bits = 0
    out = bytearray()
    for c, n in codes:
        acc |= c << bits
        bits += n
        while bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            bits -= 8
    if bits:
        out.append(acc & 0xFF)
    return bytes(out)


def _palette_bits(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def gif_bytes(screen: tuple[int, int], frames: list[dict], gpal=None,
              bg: int = 0, version: bytes = b"89a") -> bytes:
    """A GIF of `frames` on a (width, height) screen. Each frame is a
    dict: idx [h, w], left, top, lpal, interlace, transp, lzw (the coded
    stream instead of literal codes) and min_size."""
    sw, sh = screen
    out = bytearray(b"GIF" + version)
    flags, table = 0, b""
    if gpal is not None:
        bits = _palette_bits(len(gpal))
        flags = 0x80 | ((bits - 1) << 4) | (bits - 1)
        p = np.zeros((1 << bits, 3), np.uint8)
        p[:len(gpal)] = gpal
        table = p.tobytes()
    out += struct.pack("<HHBBB", sw, sh, flags, bg, 0) + table
    for f in frames:
        if f.get("transp") is not None:
            out += b"\x21\xf9\x04\x01\x00\x00" + bytes([f["transp"]]) + b"\0"
        idx = np.asarray(f["idx"])
        h, w = idx.shape
        lflags, lp = 0, b""
        pal = gpal
        if f.get("lpal") is not None:
            pal = f["lpal"]
            bits = _palette_bits(len(pal))
            p = np.zeros((1 << bits, 3), np.uint8)
            p[:len(pal)] = pal
            lflags, lp = 0x80 | (bits - 1), p.tobytes()
        rows = idx
        if f.get("interlace"):
            lflags |= 0x40
            order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                    np.arange(2, h, 4), np.arange(1, h, 2)])
            rows = idx[order]
        min_size = f.get("min_size", max(2, _palette_bits(len(pal))))
        data = f.get("lzw") or gif_lzw_literal(rows.reshape(-1), min_size)
        out += b"\x2c" + struct.pack("<HHHHB", f.get("left", 0),
                                     f.get("top", 0), w, h, lflags) + lp
        out += bytes([min_size])
        for i in range(0, len(data), 255):
            out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
        out += b"\0"
    return bytes(out + b"\x3b")


def bmp_bytes(width: int, height: int, bpp: int, compression: int,
              pixels: bytes, palette=None, masks=None, header: int = 40,
              used: int = 0) -> bytes:
    """A BMP with a BITMAPINFOHEADER of `header` bytes (40 or longer; 12
    for an OS/2 core header, whose palette entries are 3 bytes)."""
    pal = b"" if palette is None else np.asarray(palette, np.uint8).tobytes()
    extra = b"" if masks is None else struct.pack("<III", *masks)
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, height, 1, bpp,
                           compression, len(pixels), 0, 0, used, 0)
        info += b"\0" * (header - 40)
    off = 14 + len(info) + len(extra) + len(pal)
    return (struct.pack("<2sIHHI", b"BM", off + len(pixels), 0, 0, off)
            + info + extra + pal + bytes(pixels))


def padded_rows(rows, pitch: int) -> bytes:
    """Byte rows, each padded with zeros to `pitch`."""
    return b"".join(bytes(r).ljust(pitch, b"\0") for r in rows)


def corrupted(data: bytes, at: str) -> bytes:
    """`data` with the changes of a recipe, "offset:byte offset+hex ..."
    (decimal offsets into `data`): "offset:byte" sets the byte there,
    "offset+hex" puts the bytes `hex` before it, "offset/" cuts the data
    there. The byte changes come first, then the insertions from the last
    offset back, so that every offset is one of `data`, then the cut."""
    out, inserts, cut = bytearray(data), [], None
    for change in at.split():
        if change.endswith("/"):
            cut = int(change[:-1])
        elif "+" in change:
            offset, hexbytes = change.split("+")
            inserts.append((int(offset), bytes.fromhex(hexbytes)))
        else:
            offset, value = change.split(":")
            out[int(offset)] = int(value)
    for offset, extra in sorted(inserts, key=lambda x: -x[0]):
        out[offset:offset] = extra
    return bytes(out if cut is None else out[:cut])


# What `stray_recipes` puts before a JPEG header segment (hex): stray
# bytes, FF 00 pairs, the parameterless markers TEM, RST0 and RST7 (one
# after a fill byte), and a marker libjpeg refuses (JPG0, with a length).
STRAY_JPEG_BYTES = ("00", "ab", "001122", "ff00", "12ff0034", "ff01",
                    "ffd0", "ffd7", "ffff01", "fff00004ab")


def jpeg_header_offsets(data: bytes) -> list[int]:
    """The offset of every marker segment of a JPEG's header, from the
    one after SOI to the first SOS (segments back to back, as encoders
    write them)."""
    offsets, pos = [], 2
    while True:
        if data[pos] != 0xFF:
            raise ValueError(f"no marker at byte {pos}")
        offsets.append(pos)
        if data[pos + 1] == 0xDA:
            return offsets
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]


def stray_recipes(data: bytes) -> list[str]:
    """"offset+hex" recipes: each of STRAY_JPEG_BYTES before each header
    segment of the JPEG `data`, segment by segment."""
    return [f"{at}+{extra}" for at in jpeg_header_offsets(data)
            for extra in STRAY_JPEG_BYTES]


def sampling_recipes(data: bytes) -> list[str]:
    """"offset:byte" recipes: the sampling byte of each component of the
    JPEG's frame header set to every h << 4 | v, h and v in 1..4."""
    sof = next(at for at in jpeg_header_offsets(data)
               if data[at + 1] in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA))
    return [f"{sof + 11 + 3 * i}:{h << 4 | v}"
            for i in range(data[sof + 9]) for h in range(1, 5)
            for v in range(1, 5)]


def outcome(rgb: np.ndarray | None) -> str:
    """A decode as one line: "HxWxC sha256" of the pixels, or "none"."""
    if rgb is None:
        return "none"
    rgb = np.ascontiguousarray(rgb)
    return ("x".join(map(str, rgb.shape)) + " "
            + hashlib.sha256(rgb.tobytes()).hexdigest())


def outcomes_sha256(outcomes: list[str]) -> str:
    """The sha256 of a recipe set's `outcome` lines, in order."""
    return hashlib.sha256("\n".join(outcomes).encode()).hexdigest()


def quantised_gif(rgb: np.ndarray) -> bytes:
    """A GIF of `rgb` [h, w, 3] in a 3-3-2 palette (red and green to 3
    bits, blue to 2), coded with `gif_lzw`'s compressed codes."""
    q = ((rgb[..., 0] >> 5) << 5) | ((rgb[..., 1] >> 5) << 2) | (
        rgb[..., 2] >> 6)
    levels = np.arange(256)
    pal = np.stack([(levels >> 5) * 36, ((levels >> 2) & 7) * 36,
                    (levels & 3) * 85], -1).astype(np.uint8)
    return gif_bytes((rgb.shape[1], rgb.shape[0]),
                     [dict(idx=q, lzw=gif_lzw(q.reshape(-1), 8))], pal)
