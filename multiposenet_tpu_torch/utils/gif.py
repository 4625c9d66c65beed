"""GIF as OpenCV 5.0's own GIF decoder (`grfmt_gif.cpp`) reads it.

`decode` returns the first frame composed on the logical screen, uint8
RGB as `cv2.imdecode(buf, IMREAD_COLOR)` reversed to RGB: the screen
starts as the global palette's background colour (black without a
global palette); the frame's pixels, interlaced or not, take its local
palette or else the global one, and a pixel of the frame's transparent
index keeps the screen's colour. cv2 returns no image for a frame that
leaves the screen, an index past its palette, a background index past
the global palette, image data that ends before the frame's last pixel,
or a file without its trailer; each raises a ValueError here.

The LZW codes (variable width, least significant bit first, from the
stream's minimum code size plus one to 12 bits) are decoded as OpenCV's
`GifDecoder::lzwDecode` decodes them, by the host C library
(`image_codec.gif_lzw`); `lzw_decode_plain` is the plain version. There
the end-of-information code starts a new table, as a clear code does,
and decoding goes on to the end of the data (or to that code in the
data's last byte, where cv2 stops); the frame is read only if
the codes give exactly its pixels. cv2 returns no image, and a
ValueError here names it, for a code past the table, a string longer
than the pixels left, a pixel code after the last pixel (unless it lies
in the data's last byte, where cv2 stops), and data that ends before
the last pixel. Writing GIF (cv2 quantises colours with a palette of its own)
is not done here.
"""

from __future__ import annotations

import struct

import numpy as np

from multiposenet_tpu_torch.utils import image_codec


def _blocks(data: bytes, pos: int, name) -> tuple[bytes, int]:
    """Concatenated data sub-blocks from pos → (payload, position after
    the terminator)."""
    out = bytearray()
    while True:
        if pos >= len(data):
            raise ValueError(f"{name}: GIF data ends early")
        n = data[pos]
        pos += 1
        if n == 0:
            return bytes(out), pos
        if pos + n > len(data):
            raise ValueError(f"{name}: GIF data ends early")
        out += data[pos:pos + n]
        pos += n


def _palette(data: bytes, pos: int, flags: int, name):
    size = 2 << (flags & 7)
    if pos + 3 * size > len(data):
        raise ValueError(f"{name}: GIF palette ends early")
    return np.frombuffer(data, np.uint8, 3 * size, pos).reshape(size, 3), \
        pos + 3 * size


def decode(data: bytes, name="<bytes>", plain: bool = False) -> np.ndarray:
    """GIF bytes → uint8 RGB [H, W, 3] of the first frame (see the module
    docstring). `plain` runs the LZW codes in Python instead of C."""
    if len(data) < 13:
        raise ValueError(f"{name}: GIF header ends early")
    sw, sh, flags, bg = struct.unpack("<HHBB", data[6:12])
    pos = 13
    gpal = None
    if flags & 0x80:
        gpal, pos = _palette(data, pos, flags, name)
    screen = np.zeros((sh, sw, 3), np.uint8)
    if gpal is not None:
        if bg >= len(gpal):
            raise ValueError(f"{name}: GIF background index {bg} past its "
                             f"palette of {len(gpal)}")
        screen[:] = gpal[bg]
    transparent, frame = None, None
    while True:
        if pos >= len(data):
            raise ValueError(f"{name}: GIF without its trailer")
        kind = data[pos]
        pos += 1
        if kind == 0x3B:
            break
        if kind == 0x21:
            if pos >= len(data):
                raise ValueError(f"{name}: GIF data ends early")
            label = data[pos]
            payload, pos = _blocks(data, pos + 1, name)
            if label == 0xF9 and frame is None and len(payload) >= 4:
                transparent = payload[3] if payload[0] & 1 else None
        elif kind == 0x2C:
            if pos + 9 > len(data):
                raise ValueError(f"{name}: GIF image descriptor ends early")
            left, top, w, h, lflags = struct.unpack("<HHHHB",
                                                    data[pos:pos + 9])
            pos += 9
            pal = gpal
            if lflags & 0x80:
                pal, pos = _palette(data, pos, lflags, name)
            if pos >= len(data):
                raise ValueError(f"{name}: GIF data ends early")
            min_size = data[pos]
            lzw, pos = _blocks(data, pos + 1, name)
            if frame is None:
                frame = (left, top, w, h, lflags, pal, min_size, lzw,
                         transparent)
        else:
            raise ValueError(f"{name}: GIF block {kind:#x}")
    if frame is None:
        raise ValueError(f"{name}: GIF without an image")
    left, top, w, h, lflags, pal, min_size, lzw, transparent = frame
    if left + w > sw or top + h > sh:
        raise ValueError(f"{name}: GIF frame {w}x{h} at ({left}, {top}) "
                         f"leaves the {sw}x{sh} screen")
    if pal is None:
        raise ValueError(f"{name}: GIF frame without a palette")
    if not 2 <= min_size <= 11:
        raise ValueError(f"{name}: GIF LZW minimum code size {min_size}")
    try:
        if plain:
            idx = lzw_decode_plain(lzw, min_size, w * h)
        else:
            idx = image_codec.gif_lzw(lzw, min_size, w * h)
    except ValueError as exc:
        raise ValueError(f"{name}: GIF {exc} (cv2 returns no image)") \
            from None
    idx = np.frombuffer(idx, np.uint8, w * h).reshape(h, w)
    if lflags & 0x40:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    if int(idx.max(initial=0)) >= len(pal):
        raise ValueError(f"{name}: GIF index past its palette of {len(pal)}")
    region = screen[top:top + h, left:left + w]
    keep = idx == transparent if transparent is not None else False
    screen[top:top + h, left:left + w] = np.where(
        np.asarray(keep)[..., None], region, pal[idx])
    return screen


def lzw_decode_plain(data: bytes, min_size: int, count: int) -> bytes:
    """GIF LZW → exactly `count` palette indices, as OpenCV's
    GifDecoder::lzwDecode decodes them (see the module docstring), or a
    ValueError naming one of `image_codec.GIF_LZW_ERRORS`. Codes LSB first; the width grows
    when the table reaches 1 << width, up to 12 bits; the table stops
    growing at 4096 entries until a clear or end-of-information code."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    width = min_size + 1
    # Literal codes past 255 (minimum code sizes of 9 to 11) come out as
    # their low byte, as cv2 stores them.
    table: list[bytes] = [bytes([i & 0xFF]) for i in range(clear)] + [
        b"", b""]
    out = bytearray()
    acc = bits = pos = 0
    prev = None
    while True:
        while bits < width and pos < len(data):
            acc |= data[pos] << bits
            pos += 1
            bits += 8
        if bits < width:
            if len(out) == count:
                return bytes(out)
            raise ValueError(image_codec.GIF_LZW_ERRORS[3])
        code = acc & ((1 << width) - 1)
        acc >>= width
        bits -= width
        if code in (clear, eoi):
            del table[eoi + 1:]
            width, prev = min_size + 1, None
            # At the end-of-information code with the data all read, cv2
            # reads the terminator and stops, leaving the bits after it.
            if code == eoi and pos == len(data):
                if len(out) == count:
                    return bytes(out)
                raise ValueError(image_codec.GIF_LZW_ERRORS[3])
            continue
        if len(out) >= count:
            if len(out) == count and pos == len(data):
                return bytes(out)
            raise ValueError(image_codec.GIF_LZW_ERRORS[2])
        if len(table) < 4096:
            # cv2's table size: one short of the next entry after a reset
            if code >= clear and code > (len(table) if prev is not None
                                         else eoi):
                raise ValueError(image_codec.GIF_LZW_ERRORS[0])
            if prev is not None:
                base = table[prev] if code == len(table) else table[code]
                table.append(table[prev] + base[:1])
        entry = table[code]
        if len(out) + len(entry) > count:
            raise ValueError(image_codec.GIF_LZW_ERRORS[1])
        out += entry
        prev = code
        if len(table) == 1 << width and width < 12:
            width += 1
