"""Image files and resizing without cv2, for the port's eval and command
line (the JAX package reads and writes images through cv2, which the
card's machine does not have).

`read_image` decodes PNG (non-interlaced, 8 bits a sample: gray,
gray+alpha, RGB, RGBA) with zlib and struct, and reads `.npy` arrays; it
returns uint8 RGB [H, W, 3] as `cv2.imread(path, cv2.IMREAD_COLOR)`
reversed to RGB does: gray is repeated into three channels and alpha is
dropped. Any other format raises a ValueError that names it. `write_png`
writes uint8 RGB as an 8-bit PNG. `resize_linear` is cv2's INTER_LINEAR:
bilinear with half-pixel centres, no antialias, edge pixels repeated.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
NPY_MAGIC = b"\x93NUMPY"
# Magic bytes of formats the reader refuses, to name them in the error.
_OTHER_FORMATS = {
    b"\xff\xd8\xff": "JPEG",
    b"GIF8": "GIF",
    b"BM": "BMP",
    b"RIFF": "WebP/RIFF",
    b"II*\x00": "TIFF",
    b"MM\x00*": "TIFF",
}
# PNG colour type → channels (only 8-bit samples are read).
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_PNG_COLOUR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                     6: "RGBA"}


def read_image(path: str | Path) -> np.ndarray:
    """File → uint8 RGB [H, W, 3]: a PNG or a `.npy` array ([H, W, 3] or
    gray [H, W], uint8). Raises FileNotFoundError for a missing file and
    ValueError for any other format."""
    data = Path(path).read_bytes()
    if data.startswith(PNG_SIGNATURE):
        return _gray_to_rgb(_decode_png(data, path))
    if data.startswith(NPY_MAGIC):
        return _npy_image(path)
    for magic, name in _OTHER_FORMATS.items():
        if data.startswith(magic):
            raise ValueError(f"{path}: {name} images are not read here "
                             "(PNG and .npy only)")
    raise ValueError(f"{path}: not a PNG or .npy file (suffix "
                     f"{Path(path).suffix or 'none'}); PNG and .npy only")


def _npy_image(path) -> np.ndarray:
    arr = np.load(path, allow_pickle=False)
    if arr.dtype != np.uint8 or not (
            arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] == 3)):
        raise ValueError(f"{path}: a .npy image must be uint8 [H, W, 3] or "
                         f"[H, W]; got {arr.dtype} {arr.shape}")
    return _gray_to_rgb(arr)


def _gray_to_rgb(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    return np.ascontiguousarray(arr)


def _chunks(data: bytes, path):
    """(type, payload) of each PNG chunk, CRC checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc_at = pos + 8 + length
        if len(payload) != length or crc_at + 4 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[crc_at:crc_at + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = crc_at + 4
    raise ValueError(f"{path}: PNG without IEND")


def _decode_png(data: bytes, path) -> np.ndarray:
    """PNG bytes → uint8 [H, W] (gray) or [H, W, 3] (colour; alpha
    dropped)."""
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _PNG_CHANNELS or depth != 8 or interlace:
        raise ValueError(
            f"{path}: PNG with {depth}-bit "
            f"{_PNG_COLOUR_NAMES.get(colour, f'colour type {colour}')} "
            f"samples{', interlaced' if interlace else ''} is not read "
            "here (8-bit gray, gray+alpha, RGB or RGBA, not interlaced)")
    channels = _PNG_CHANNELS[colour]
    stride = width * channels
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: PNG image data of {len(raw)} bytes, "
                         f"want {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    pixels = _unfilter(rows[:, 0], rows[:, 1:], channels, path)
    pixels = pixels.reshape(height, width, channels)
    if channels <= 2:
        return pixels[:, :, 0].copy()
    return pixels[:, :, :3].copy()


def _unfilter(filters: np.ndarray, rows: np.ndarray, bpp: int,
              path) -> np.ndarray:
    """Undo PNG's per-row filters (None, Sub, Up, Average, Paeth) in
    modulo-256 arithmetic; None, Sub and Up vectorised, Average and Paeth
    (which depend on the pixel just decoded) a byte at a time."""
    height, stride = rows.shape
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        f, cur = int(filters[y]), rows[y]
        if f == 0:
            out[y] = cur
        elif f == 1:
            out[y] = np.cumsum(cur.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif f == 2:
            out[y] = cur + prev
        elif f in (3, 4):
            out[y] = _unfilter_row(f, cur.tolist(), prev.tolist(), bpp)
        else:
            raise ValueError(f"{path}: PNG row filter {f} is not defined")
        prev = out[y]
    return out


def _unfilter_row(f: int, cur: list, prev: list, bpp: int) -> list:
    row = [0] * len(cur)
    for i, x in enumerate(cur):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        if f == 3:
            row[i] = (x + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (x + pred) & 0xFF
    return row


def write_png(path: str | Path, rgb: np.ndarray) -> None:
    """uint8 RGB [H, W, 3] → an 8-bit RGB PNG (rows unfiltered)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError("write_png takes uint8 RGB [H, W, 3]; got "
                         f"{rgb.dtype} {rgb.shape}")
    height, width = rgb.shape[:2]
    rows = np.zeros((height, width * 3 + 1), np.uint8)
    rows[:, 1:] = rgb.reshape(height, width * 3)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    Path(path).write_bytes(
        PNG_SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0,
                                     0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b""))


def resize_linear(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR) for uint8
    or float32 [H, W] / [H, W, C] arrays: bilinear with half-pixel
    centres, no antialias, edge pixels repeated; uint8 is rounded to the
    nearest level (cv2's fixed-point weights can land one level away)."""
    w, h = size
    arr = np.asarray(image)
    if arr.dtype not in (np.uint8, np.float32) or arr.ndim not in (2, 3):
        raise ValueError("resize_linear takes uint8 or float32 [H, W] or "
                         f"[H, W, C]; got {arr.dtype} {arr.shape}")
    if w < 1 or h < 1:
        raise ValueError(f"resize_linear: bad size {size}")
    x = torch.from_numpy(np.ascontiguousarray(arr)).float()
    x = x[None, None] if arr.ndim == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=False)[0]
    y = y[0] if arr.ndim == 2 else y.permute(1, 2, 0)
    if arr.dtype == np.uint8:
        y = y.round().clamp(0, 255).to(torch.uint8)
    return np.ascontiguousarray(y.numpy())
