"""Sun raster images as OpenCV 5.0 reads and writes them
(`grfmt_sunras.cpp`).

`decode` reads RT_OLD and RT_STANDARD files of depth 1, 8, 24 and 32:
rows padded to 16 bits; depth 1 and 8 through an RMT_EQUAL_RGB colormap
(planes of R, G, then B; an index past it is black) or, without one, as
gray (depth 1: 0 black, 1 white); depth 24 as B, G, R; depth 32 as X, B,
G, R. cv2 5.0 returns no image for RT_BYTE_ENCODED (Sun's RLE) or
RT_FORMAT_RGB files, whatever their data (checked over every stream of
up to six bytes drawn from the RLE escape's values), nor for a colormap
on depth 24 or 32 or of type RMT_RAW, so those are refused by name.

`encode` writes what `cv2.imencode(".sr")` writes for a 3-channel image
(the plain version of `image_codec.encode_sunras`): a 32-byte header
(depth 24, RT_STANDARD, no colormap, length = padded row x height), B,
G, R rows padded to an even length. cv2 pads a row with the byte that
follows it in memory: the next row's first byte, and for the last row a
byte past the image, which is not the image's; here that one is 0.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"\x59\xa6\x6a\x95"
RT_OLD, RT_STANDARD, RT_BYTE_ENCODED, RT_FORMAT_RGB = 0, 1, 2, 3
RMT_NONE, RMT_EQUAL_RGB = 0, 1


def decode(data: bytes, name="<bytes>") -> np.ndarray:
    """Sun raster bytes → uint8 RGB [H, W, 3] as `cv2.imdecode(buf,
    IMREAD_COLOR)` reversed to RGB; ValueError naming what cv2 returns no
    image for."""
    if len(data) < 32:
        raise ValueError(f"{name}: Sun raster header ends early")
    _, width, height, depth, _, kind, maptype, maplength = struct.unpack(
        ">8i", data[:32])
    if kind == RT_BYTE_ENCODED:
        raise ValueError(f"{name}: run-length encoded Sun raster "
                         "(RT_BYTE_ENCODED) is not read: cv2 5.0 returns no "
                         "image for it")
    if kind == RT_FORMAT_RGB:
        raise ValueError(f"{name}: Sun raster of type RT_FORMAT_RGB is not "
                         "read: cv2 5.0 returns no image for it")
    pal_size = (1 << depth) * 3 if 0 < depth <= 8 else 0
    if not (width > 0 and height > 0 and depth in (1, 8, 24, 32)
            and kind in (RT_OLD, RT_STANDARD)
            and ((maptype == RMT_NONE and maplength == 0)
                 or (maptype == RMT_EQUAL_RGB and 0 < maplength <= pal_size
                     and depth <= 8))):
        raise ValueError(f"{name}: Sun raster of depth {depth}, type {kind}, "
                         f"colormap type {maptype} of {maplength} bytes is "
                         "not read (cv2 returns no image)")
    palette = np.zeros((256, 3), np.uint8)
    if maplength:
        n = maplength // 3
        cmap = np.frombuffer(data, np.uint8, maplength, 32)
        palette[:n] = cmap[:3 * n].reshape(3, n).T
    else:
        levels = 1 << depth if depth <= 8 else 0
        ramp = np.arange(levels) * 255 // max(levels - 1, 1)
        palette[:levels] = ramp[:, None]
    pitch = ((width * depth + 7) // 8 + 1) & -2
    offset = 32 + maplength
    if offset + pitch * height > len(data):
        raise ValueError(f"{name}: Sun raster data ends early")
    rows = np.frombuffer(data, np.uint8, pitch * height, offset).reshape(
        height, pitch)
    if depth <= 8:
        bits = np.unpackbits(rows, axis=1)[:, :width * depth]
        idx = bits.reshape(height, width, depth) @ (
            1 << np.arange(depth - 1, -1, -1))
        return np.ascontiguousarray(palette[idx])
    n = depth // 8
    px = rows[:, :width * n].reshape(height, width, n)
    return np.ascontiguousarray(px[:, :, :n - 4:-1] if n == 4
                                else px[:, :, ::-1])


def encode(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] → the bytes `cv2.imencode(".sr", bgr)` writes,
    but for the last row's pad byte (see the module docstring)."""
    h, w = rgb.shape[:2]
    pitch = (w * 3 + 1) & -2
    flat = np.zeros(h * w * 3 + 1, np.uint8)
    flat[:-1] = rgb[:, :, ::-1].reshape(-1)
    rows = np.stack([flat[y * w * 3:y * w * 3 + pitch] for y in range(h)]) \
        if h else np.zeros((0, pitch), np.uint8)
    header = struct.pack(">8I", 0x59A66A95, w, h, 24, pitch * h,
                         RT_STANDARD, RMT_NONE, 0)
    return header + rows.tobytes()
