"""GIF as OpenCV 5.0's own GIF codec (`grfmt_gif.cpp`) reads and writes it.

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
the last pixel.

`encode` writes the bytes `cv2.imencode(".gif", bgr)` (and `cv2.imwrite`)
writes at its defaults, for sides of 1 to 65535 pixels (cv2 writes no
file past that): `GIF89a` with a global table of the fixed 3-3-2 palette
(entry i: R (i >> 5) * 36, G ((i >> 2) & 7) * 36, B (i & 3) * 85), a
`NETSCAPE2.0` block looping forever, a graphic control extension of
disposal 3 and delay 100 without transparency, and one frame at (0, 0)
of LZW codes (minimum code size 8) in sub-blocks of 255 bytes. These
rules were found against cv2 5.0 with seeded images:
- the pixels are dithered onto the palette by Floyd-Steinberg, each
  channel on its own, rows from the top and each row left to right (not
  serpentine). A pixel's value v is its byte plus the error it has
  gathered, in float32, the errors kept apart from the pixels in rows of
  float32 that start at 0. Adding the errors into a float32 or float64
  copy of the image instead, or dividing by a step through its
  reciprocal, turns a level on some 480x640 images, and the error then
  carries the change on. The pixel's level is
  `int(clamp(v, 0, 255) / step + 0.5) * step` (steps 36, 36 and 85:
  halves round up, half to even does not match), and the error
  `v - level` of the unclamped v (a clamped one does not match) goes
  7/16 to the right and 3/16, 5/16 and 1/16 to the pixels below left,
  below and below right;
- the codes start with a clear code. Their width grows when the
  decoder's table, one entry behind the encoder's, reaches 1 << width
  entries, up to 12 bits; when the encoder's next free code reaches 4096
  it sends a clear at 12 bits (so a clear is every 3839th code) and
  starts again at 9 bits, but not after the last string's code, which
  the end-of-information code follows at the width the decoder then
  reads.
The C coder is `image_codec.encode_image(rgb, "gif")`; `encode_plain` is
its plain version, the same float32 arithmetic in the same order.
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


# --- writing ------------------------------------------------------------------

MAX_SIDE = 65535
_LEVELS = np.arange(256)
PALETTE = np.stack([(_LEVELS >> 5) * 36, ((_LEVELS >> 2) & 7) * 36,
                    (_LEVELS & 3) * 85], -1).astype(np.uint8)
_STEPS = np.array([36, 36, 85], np.float32)
# NETSCAPE2.0 looping forever, then the graphic control extension.
_EXTENSIONS = (b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
               b"\x21\xf9\x04\x0c\x64\x00\x00\x00")


def _check_encodable(rgb: np.ndarray) -> np.ndarray:
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"GIF writing takes uint8 RGB [H, W, 3]; got "
                         f"{rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    if not (1 <= h <= MAX_SIDE and 1 <= w <= MAX_SIDE):
        raise ValueError(f"GIF holds at most {MAX_SIDE} pixels a side; got "
                         f"{h}x{w}")
    return np.ascontiguousarray(rgb)


def encode(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] → the bytes cv2.imencode(".gif", bgr) writes
    (see the module docstring), by the host C library."""
    return image_codec.encode_image(_check_encodable(rgb), "gif")


def encode_plain(rgb: np.ndarray) -> bytes:
    """The plain version of `encode`."""
    rgb = _check_encodable(rgb)
    h, w = rgb.shape[:2]
    data = lzw_encode_plain(dither_plain(rgb).tobytes())
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0)
            + PALETTE.tobytes() + _EXTENSIONS
            + b"\x2c" + struct.pack("<HHHHBB", 0, 0, w, h, 0x07, 8)
            + blocks + b"\x00\x3b")


def dither_plain(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB [H, W, 3] → the palette indices [H, W] cv2 dithers it to
    (see the module docstring). The three channels go together, and so do
    the pixels of one line x + 2y = t: a pixel's error goes only to
    pixels of later lines (x + 1 on its row is line t + 1; x - 1, x and
    x + 1 on the row below are t + 1, t + 2 and t + 3), so the lines in
    order are the row scan's order, and each pixel gathers its four
    errors in the scan's order: from above left, above, above right (in
    its line's turn before the left neighbour's), then left."""
    h, w = rgb.shape[:2]
    pixels = rgb.astype(np.float32)
    # One column of slack on each side and one row below take the error
    # that falls off the image; column x of the image is column x + 1.
    err = np.zeros((h + 1, w + 2, 3), np.float32)
    levels = np.zeros((h, w, 3), np.int64)
    rows = np.arange(h)
    sixteen = np.float32(16)
    for t in range(w + 2 * (h - 1)):
        ys = rows[(2 * rows <= t) & (t - 2 * rows < w)]
        xs = t - 2 * ys
        v = pixels[ys, xs] + err[ys, xs + 1]
        q = np.floor(np.clip(v, np.float32(0), np.float32(255)) / _STEPS
                     + np.float32(0.5))
        e = v - q * _STEPS
        levels[ys, xs] = q
        err[ys + 1, xs] += e * np.float32(3) / sixteen
        err[ys, xs + 2] += e * np.float32(7) / sixteen
        err[ys + 1, xs + 1] += e * np.float32(5) / sixteen
        err[ys + 1, xs + 2] += e * np.float32(1) / sixteen
    return (levels[..., 0] << 5 | levels[..., 1] << 2
            | levels[..., 2]).astype(np.uint8)


def lzw_encode_plain(indices: bytes) -> bytes:
    """Palette indices → cv2's LZW codes at minimum code size 8, packed
    least significant bit first (see the module docstring)."""
    out = bytearray()
    acc = bits = 0

    def put(code: int, width: int) -> None:
        nonlocal acc, bits
        acc |= code << bits
        bits += width
        while bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            bits -= 8

    table: dict[tuple[int, int], int] = {}
    free, width = 258, 9
    put(256, width)
    ent = indices[0]
    for c in indices[1:]:
        code = table.get((ent, c))
        if code is not None:
            ent = code
            continue
        put(ent, width)
        table[(ent, c)] = free
        free += 1
        if free > 1 << width and width < 12:
            width += 1
        if free == 4096:
            put(256, width)
            table.clear()
            free, width = 258, 9
        ent = c
    put(ent, width)
    if free + 1 > 1 << width and width < 12:
        width += 1
    put(257, width)
    if bits:
        out.append(acc & 0xFF)
    return bytes(out)
