"""Radiance HDR (`.hdr`, `.pic`) as OpenCV 5.0 reads and writes it
(`grfmt_hdr.cpp` over its `rgbe.cpp`, Bruce Walter's RGBE code).

`decode` reads what `cv2.imdecode(buf, IMREAD_COLOR)` returns an image
for, pixel for pixel:
- a file that starts with `#?RGBE` or `#?RADIANCE` (and has at least 10
  bytes: cv2's signature check);
- a header read as `RGBE_ReadHeader` reads it, line by line through
  `fgets` into 128 bytes (a longer line comes in pieces of 127, and a
  piece that is only its newline ends the header): it must hold the line
  `FORMAT=32-bit_rle_rgbe` (exactly, LF-terminated) before a blank line,
  and the line after that must scan as `-Y %d +X %d` with both sides
  positive and within cv2's limits (2^20 a side, 2^30 pixels; other
  orientations, `GAMMA` and `EXPOSURE` are not applied; cv2 reads those
  files as this one);
- pixels as `RGBE_ReadPixels_RLE` reads them: widths 8 to 32767 as
  new-style run-length scanlines (`02 02 hi lo`, then each of R, G, B and E
  as runs `128 + n, v` and literals `n, v...`), switching to flat pixels for
  the rest of the file at the first scanline that does not start so;
  other widths flat. Old-style runs (a pixel 1, 1, 1, n) are not expanded,
  as in that code. A read past the end or a bad run gives no image;
- each pixel `rint(m * 255 * 2^(e - 136))` saturated to [0, 255] (`e` 0:
  black), cv2's float image scaled by 255 to uint8; a value of 2^31 or more
  comes out 0, as cvRound turns it into INT_MIN.

`encode` writes the bytes `cv2.imencode(".hdr")` (or `.pic`) writes for
uint8 pixels: the header `#?RADIANCE`, `FORMAT=32-bit_rle_rgbe`, a blank
line and `-Y H +X W`, then each pixel scaled to float32 by 1/255 and coded
by `float2rgbe` (the largest channel's frexp exponent; each channel times
2^(8 - e), truncated), as new-style run-length scanlines for widths 8 to
32767 (`RGBE_WriteBytes_RLE`: runs of 4 to 127, shorter runs of 2 or 3
before a long one, literals of up to 128) and flat pixels otherwise.

The pixel coders run in the host C library (`image_codec.hdr_pixels`,
and `image_codec.encode_image(rgb, "hdr")` for the writer);
`decode_pixels_plain` and `encode_plain` are their plain versions.
"""

from __future__ import annotations

import re

import numpy as np

from multiposenet_tpu_torch.utils import image_codec

MAGICS = (b"#?RGBE", b"#?RADIANCE")
HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
_SIZE = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")


def is_hdr(data: bytes) -> bool:
    """cv2's HdrDecoder::checkSignature."""
    return len(data) >= 10 and data.startswith(MAGICS)


def _fgets(data: bytes, pos: int) -> tuple[bytes | None, int]:
    """fgets(buf, 128, fp): up to 127 bytes, through the first newline;
    None at the end of the data."""
    if pos >= len(data):
        return None, pos
    end = data.find(b"\n", pos, pos + 127)
    end = min(pos + 127, len(data)) if end < 0 else end + 1
    return data[pos:end], end


def _cstr(line: bytes) -> bytes:
    """What the C string functions see: the line up to its first NUL."""
    nul = line.find(b"\0")
    return line if nul < 0 else line[:nul]


def parse_header(data: bytes, name="<bytes>") -> tuple[int, int, int]:
    """(height, width, offset of the pixels) as RGBE_ReadHeader and
    HdrDecoder::readHeader take them; raises ValueError where cv2 returns
    no image."""
    line, pos = _fgets(data, 0)
    has_format = False
    while True:
        if line is None:
            raise ValueError(f"{name}: Radiance HDR header ends early")
        s = _cstr(line)
        if not s or s[:1] == b"\n":
            break
        if s == b"FORMAT=32-bit_rle_rgbe\n":
            has_format = True
        line, pos = _fgets(data, pos)
    if not has_format:
        raise ValueError(f"{name}: Radiance HDR without the line "
                         "FORMAT=32-bit_rle_rgbe (cv2 reads no other)")
    if _cstr(line) != b"\n":
        raise ValueError(f"{name}: Radiance HDR header not ended by a blank "
                         "line")
    line, pos = _fgets(data, pos)
    m = _SIZE.match(_cstr(line)) if line is not None else None
    if m is None:
        raise ValueError(f"{name}: Radiance HDR without a '-Y H +X W' size "
                         "line (cv2 reads no other orientation)")
    height, width = int(m.group(1)), int(m.group(2))
    if not (0 < height <= 1 << 20 and 0 < width <= 1 << 20
            and height * width <= 1 << 30):
        raise ValueError(f"{name}: Radiance HDR of {width}x{height} (cv2 "
                         "reads up to 2^20 a side and 2^30 pixels)")
    # A scanline takes 4 bytes a pixel flat, or 4 and 2 a run of up to 127
    # for each of R, G, B and E: fewer bytes cannot be read.
    least = 4 * width if not 8 <= width <= 0x7FFF else min(
        4 * width, 4 + 8 * -(-width // 127))
    if len(data) - pos < height * least:
        raise ValueError(f"{name}: Radiance HDR pixels end early")
    return height, width, pos


def decode(data: bytes, name="<bytes>", plain: bool = False) -> np.ndarray:
    """Radiance HDR bytes → uint8 RGB [H, W, 3] as cv2.imdecode reversed
    to RGB (see the module docstring). `plain` runs the pixel decoder in
    Python instead of C."""
    height, width, pos = parse_header(bytes(data), name)
    read = decode_pixels_plain if plain else image_codec.hdr_pixels
    try:
        return read(bytes(data[pos:]), height, width)
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None


def to_rgb8(rgbe: np.ndarray) -> np.ndarray:
    """RGBE pixels [..., 4] → uint8 RGB: rgbe2float's m * 2^(e - 136) as
    cv2 converts it to uint8 (times 255, rounded to even, saturated; a
    value of 2^31 or more is INT_MIN to cvRound, so 0); every product is
    exact in float32, so float64 gives the same."""
    e = rgbe[..., 3].astype(np.int64)
    scale = np.where(e > 0, np.ldexp(255.0, e - 136), 0.0)
    v = rgbe[..., :3].astype(np.float64) * scale[..., None]
    v = np.where(v >= 2.0**31, 0.0, v)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def decode_pixels_plain(body: bytes, height: int, width: int) -> np.ndarray:
    """RGBE_ReadPixels_RLE of the bytes after the header → uint8 RGB
    [height, width, 3] (the plain version of `image_codec.hdr_pixels`)."""
    out = np.zeros((height * width, 4), np.uint8)
    pos, n = 0, len(body)
    if 8 <= width <= 0x7FFF:
        line = bytearray(4 * width)
        for y in range(height):
            if pos + 4 > n:
                raise ValueError("Radiance HDR pixels end early")
            head = body[pos:pos + 4]
            pos += 4
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                out[y * width] = list(head)
                pos = _flat(body, pos, out, y * width + 1)
                return to_rgb8(out.reshape(height, width, 4))
            if (head[2] << 8) | head[3] != width:
                raise ValueError("Radiance HDR scanline of the wrong width")
            at = 0
            for c in range(4):
                end = (c + 1) * width
                while at < end:
                    if pos + 2 > n:
                        raise ValueError("Radiance HDR pixels end early")
                    count, value = body[pos], body[pos + 1]
                    pos += 2
                    run = count > 128
                    if run:
                        count -= 128
                    if count == 0 or count > end - at:
                        raise ValueError("bad Radiance HDR scanline data")
                    if run:
                        line[at:at + count] = bytes([value]) * count
                    else:
                        line[at] = value
                        if count > 1:
                            if pos + count - 1 > n:
                                raise ValueError("Radiance HDR pixels end "
                                                 "early")
                            line[at + 1:at + count] = body[pos:pos + count - 1]
                            pos += count - 1
                    at += count
            out[y * width:(y + 1) * width] = np.frombuffer(
                bytes(line), np.uint8).reshape(4, width).T
        return to_rgb8(out.reshape(height, width, 4))
    _flat(body, pos, out, 0)
    return to_rgb8(out.reshape(height, width, 4))


def _flat(body: bytes, pos: int, out: np.ndarray, first: int) -> int:
    """RGBE_ReadPixels: 4 bytes a pixel from out[first] on."""
    count = len(out) - first
    if pos + 4 * count > len(body):
        raise ValueError("Radiance HDR pixels end early")
    out[first:] = np.frombuffer(body, np.uint8, 4 * count, pos).reshape(-1, 4)
    return pos + 4 * count


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """cv2's uint8 → float32 (times the float 1/255) and float2rgbe →
    RGBE bytes [..., 4]."""
    v = rgb.astype(np.float32) * np.float32(1 / 255)
    top = v.max(-1)
    mant, exp = np.frexp(top.astype(np.float64))
    live = top.astype(np.float64) >= 1e-32
    scale = np.where(live, (mant * 256.0) / np.where(live, top, 1),
                     0).astype(np.float32)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.where(live[..., None],
                            (v * scale[..., None]).astype(np.int64), 0)
    out[..., 3] = np.where(live, exp + 128, 0)
    return out


def _rle_bytes(data: bytes) -> bytes:
    """RGBE_WriteBytes_RLE of one channel of a scanline."""
    out = bytearray()
    cur, n = 0, len(data)
    while cur < n:
        beg = cur
        run = old_run = 0
        while run < 4 and beg < n:
            beg += run
            old_run = run
            run = 1
            while beg + run < n and run < 127 and data[beg] == data[beg + run]:
                run += 1
        if old_run > 1 and old_run == beg - cur:
            out += bytes([128 + old_run, data[cur]])
            cur = beg
        while cur < beg:
            k = min(beg - cur, 128)
            out += bytes([k]) + data[cur:cur + k]
            cur += k
        if run >= 4:
            out += bytes([128 + run, data[beg]])
            cur += run
    return bytes(out)


def encode_plain(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] → the bytes cv2.imencode(".hdr", bgr) writes
    (the plain version of `image_codec.encode_image(rgb, "hdr")`)."""
    rgb = np.ascontiguousarray(rgb)
    h, w = rgb.shape[:2]
    rgbe = float_to_rgbe(rgb)
    out = bytearray(HEADER + b"-Y %d +X %d\n" % (h, w))
    if not 8 <= w <= 0x7FFF:
        return bytes(out + rgbe.tobytes())
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            out += _rle_bytes(rgbe[y, :, c].tobytes())
    return bytes(out)
