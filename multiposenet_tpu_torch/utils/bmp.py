"""BMP / DIB as OpenCV 5.0 reads and writes it (`grfmt_bmp.cpp`).

`decode` reads what cv2 reads: BITMAPINFOHEADER and its longer forms
(the rest of a longer header is skipped), and OS/2 core headers (12
bytes, 3-byte palette entries); 1, 4 and 8-bit palette rows (an index
past the palette is black), 16-bit 555 (BI_RGB, or BI_BITFIELDS with
masks 7C00/3E0/1F) and 565 (BI_BITFIELDS F800/7E0/1F) expanded by
shifting (no bit replication), 24-bit, 32-bit with the fourth byte
dropped whatever its masks say, RLE4 and RLE8, bottom-up or top-down.
The RLE streams are run by the host C library (`image_codec.bmp_rle`);
`rle_plain` is their plain version: pixels an escape skips take palette
entry 0; in RLE8 the end-of-bitmap escape fills the rest so, and a
delta skips dx + dy rows; in RLE4 cv2 5.0 takes no rows from either (an
end of bitmap ends the row, a delta skips dx pixels).

`encode` writes what `cv2.imencode(".bmp")` writes for a 3-channel
image: a 54-byte header (BITMAPINFOHEADER, image size 0), BGR rows
bottom-up, each padded with zeros to 4 bytes.
"""

from __future__ import annotations

import struct

import numpy as np

from multiposenet_tpu_torch.utils import image_codec

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
MASKS_555 = (0x7C00, 0x3E0, 0x1F)
MASKS_565 = (0xF800, 0x7E0, 0x1F)


class _Stream:
    """Bytes read as cv2's stream reads them: past the end raises."""

    def __init__(self, data: bytes, name):
        self.data, self.pos, self.name = data, 0, name

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"{self.name}: BMP data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]


def _header(data: bytes, name):
    """(offset, width, height, bpp, compression, palette [256, 3] RGB)
    as cv2's readHeader finds them; bpp 15 is 555."""
    s = _Stream(data, name)
    s.take(10)
    offset = s.i32()
    size = s.i32()
    palette = np.zeros((256, 3), np.uint8)
    if size >= 36:
        width, height = s.i32(), s.i32()
        bpp = (s.i32() >> 16) & 0xFFFF
        comp = s.i32()
        s.take(12)
        used = s.i32()
        s.take(size - 36)
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == BI_RGB)
            or (bpp in (16, 32) and comp in (BI_RGB, BI_BITFIELDS))
            or (bpp == 4 and comp == BI_RLE4)
            or (bpp == 8 and comp == BI_RLE8))
        if not ok:
            raise ValueError(f"{name}: BMP with {bpp}-bit samples and "
                             f"compression {comp} is not read (cv2 returns "
                             "no image)")
        if bpp <= 8:
            if not 0 <= used <= 256:
                raise ValueError(f"{name}: BMP palette of {used} colours")
            n = used or 1 << bpp
            entries = np.frombuffer(s.take(4 * n), np.uint8).reshape(n, 4)
            palette[:n] = entries[:, 2::-1]
        elif bpp == 16 and comp == BI_BITFIELDS:
            masks = tuple(s.i32() & 0xFFFFFFFF for _ in range(3))
            if masks == MASKS_555:
                bpp = 15
            elif masks != MASKS_565:
                raise ValueError(f"{name}: 16-bit BMP with masks "
                                 f"{tuple(hex(m) for m in masks)} is not "
                                 "read (cv2 returns no image)")
        elif bpp == 16:
            bpp = 15
    elif size == 12:
        width, height = s.u16(), s.u16()
        bpp = (s.i32() >> 16) & 0xFFFF
        comp = BI_RGB
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise ValueError(f"{name}: OS/2 BMP with {bpp}-bit samples is "
                             "not read (cv2 returns no image)")
        if bpp <= 8:
            n = 1 << bpp
            palette[:n] = np.frombuffer(s.take(3 * n), np.uint8).reshape(
                n, 3)[:, ::-1]
    else:
        raise ValueError(f"{name}: BMP header of {size} bytes is not read "
                         "(cv2 returns no image)")
    return offset, width, height, bpp, comp, palette


def _rows(data: bytes, offset: int, width: int, height: int, bpp: int,
          name) -> np.ndarray:
    """The uncompressed rows [height, pitch] in file order."""
    pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
    if offset < 0 or offset + pitch * height > len(data):
        raise ValueError(f"{name}: BMP data ends early")
    return np.frombuffer(data, np.uint8, pitch * height, offset).reshape(
        height, pitch)


def _pixels(rows: np.ndarray, width: int, bpp: int,
            palette: np.ndarray) -> np.ndarray:
    """Rows → RGB [h, width, 3] for an uncompressed layout."""
    h = rows.shape[0]
    if bpp in (1, 4, 8):
        bits = np.unpackbits(rows, axis=1)[:, :width * bpp]
        idx = bits.reshape(h, width, bpp) @ (1 << np.arange(bpp - 1, -1, -1))
        return palette[idx]
    if bpp in (15, 16):
        t = rows[:, :2 * width].view("<u2").astype(np.int32)
        if bpp == 15:
            rgb = ((t >> 7) & 0xF8, (t >> 2) & 0xF8, (t << 3) & 0xF8)
        else:
            rgb = ((t >> 8) & 0xF8, (t >> 3) & 0xFC, (t << 3) & 0xF8)
        return np.stack(rgb, axis=-1).astype(np.uint8)
    n = bpp // 8
    return rows[:, :width * n].reshape(h, width, n)[:, :, 2::-1]


def decode(data: bytes, name="<bytes>", plain: bool = False) -> np.ndarray:
    """BMP bytes → uint8 RGB [H, W, 3] as `cv2.imdecode(buf,
    IMREAD_COLOR)` reversed to RGB; ValueError where cv2 returns no
    image. `plain` runs the RLE streams in Python instead of C."""
    offset, width, height, bpp, comp, palette = _header(data, name)
    h = abs(height)
    if comp in (BI_RLE4, BI_RLE8):
        if plain:
            rgb = rle_plain(data, offset, 4 if comp == BI_RLE4 else 8,
                            palette, h, width, name)
        else:
            rgb = image_codec.bmp_rle(data, offset,
                                      4 if comp == BI_RLE4 else 8,
                                      palette, h, width, name)
    else:
        rgb = _pixels(_rows(data, offset, width, h, bpp, name), width, bpp,
                      palette)
    if height > 0:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


def rle_plain(data: bytes, offset: int, bits: int, palette: np.ndarray,
              height: int, width: int, name="<bytes>") -> np.ndarray:
    """An RLE4 or RLE8 stream from `offset` → RGB rows [height, width, 3]
    in file order (the first row is the bottom one when the height is
    positive), as cv2's readData runs it: an encoded or absolute run
    past the row's end, or a stream that ends before the last row, gives
    no image."""
    out = np.zeros((height * width, 3), np.uint8)
    s = _Stream(data, name)
    s.pos = offset
    pos, y, line_end = 0, 0, width
    line_end_flag = 0

    def fill(count, colour):
        """cv2's FillUniColor: `count` pixels of `colour` from pos,
        wrapping to the next row at its end."""
        nonlocal pos, y, line_end
        while True:
            end = min(pos + count, line_end)
            count -= end - pos
            out[pos:end] = colour
            pos = end
            if pos >= line_end:
                line_end += width
                pos = line_end - width
                y += 1
                if y >= height:
                    break
            if count <= 0:
                break

    def bad():
        raise ValueError(f"{name}: BMP RLE{bits} run past the end of a row")

    while True:
        length, code = s.take(2)
        if length:
            if bits == 4:
                if pos + length > line_end:
                    bad()
                pair = (palette[code >> 4], palette[code & 15])
                for t in range(length):
                    out[pos + t] = pair[t & 1]
                pos += length
            else:
                prev = y
                if pos + length > line_end:
                    bad()
                fill(length, palette[code])
                line_end_flag = y - prev
                if y >= height:
                    break
        elif code > 2:
            if pos + code > line_end:
                bad()
            if bits == 4:
                raw = s.take((((code + 1) >> 1) + 1) & ~1)
                idx = np.unpackbits(np.frombuffer(raw, np.uint8))
                idx = idx.reshape(-1, 4) @ np.array([8, 4, 2, 1])
            else:
                idx = np.frombuffer(s.take((code + 1) & ~1), np.uint8)
            out[pos:pos + code] = palette[idx[:code]]
            pos += code
            line_end_flag = 0
        else:
            x_shift = line_end - pos
            y_shift = height - y
            if bits == 8 and not (code or not line_end_flag
                                  or x_shift < width):
                line_end_flag = 0
                continue
            if code == 2:
                x_shift, y_shift = s.take(2)
            count = x_shift + (y_shift * width if code and bits == 8 else 0)
            if bits == 8 and y >= height:
                break
            fill(count, palette[0])
            line_end_flag = 0
            if y >= height:
                break
    return out.reshape(height, width, 3)


def encode(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] → the bytes `cv2.imencode(".bmp", bgr)` writes
    (the plain version of `image_codec.encode_bmp`)."""
    h, w = rgb.shape[:2]
    pitch = (w * 3 + 3) & -4
    rows = np.zeros((h, pitch), np.uint8)
    rows[:, :w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)
    header = struct.pack("<2sIHHI", b"BM", 54 + pitch * h, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, 0, 0, 0, 0, 0)
    return header + info + rows.tobytes()
