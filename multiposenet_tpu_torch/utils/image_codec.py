"""ctypes binding of the host C library `csrc/image_codec.c`: JPEG
decoding (`utils/jpeg.py` is the plain version of its baseline part),
cv2's INTER_LINEAR resize on uint8 and on two-channel float32 and its
INTER_AREA on float32 (`utils/image_io.resize_linear_plain` and
`resize_area_plain` are their plain versions), and cv2.fillPoly
(`data/masks.fill_polygons_plain`). The library is built by `kernels.load_host` on first use; a
build that fails raises, and nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from multiposenet_tpu_torch import kernels

_ERR_LEN = 256
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with its argument and result types declared."""
    lib = kernels.load_host("image_codec")
    intp = ctypes.POINTER(ctypes.c_int)
    lib.jpeg_size.argtypes = [ctypes.c_char_p, ctypes.c_long, intp, intp,
                              ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_size.restype = ctypes.c_int
    lib.decode_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_long, _u8p,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_char_p, ctypes.c_int]
    lib.decode_jpeg.restype = ctypes.c_int
    lib.resize_linear_u8.argtypes = [_u8p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, _u8p, ctypes.c_int,
                                     ctypes.c_int]
    lib.resize_linear_u8.restype = ctypes.c_int
    for name in ("resize_linear_f32", "resize_area_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       _f32p, ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.fill_polygons.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _i32p,
                                  _i32p, ctypes.c_int, ctypes.c_uint8]
    lib.fill_polygons.restype = ctypes.c_int
    return lib


def _check(rc: int, err: ctypes.Array) -> None:
    if rc == 1:
        raise ValueError(err.value.decode(errors="replace"))
    if rc:
        raise MemoryError("image_codec: out of memory")


def decode_jpeg(data: bytes, eof_fill: bool = False) -> np.ndarray:
    """JPEG bytes → uint8 RGB [H, W, 3], before any Exif orientation;
    raises ValueError naming what it does not read. A stream whose data
    ends early is refused, as `cv2.imdecode` refuses it, unless
    `eof_fill` (`cv2.imread` of a file): then the rest is filled as
    libjpeg-turbo fills it."""
    lib = library()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w = ctypes.c_int(), ctypes.c_int()
    _check(lib.jpeg_size(data, len(data), ctypes.byref(h), ctypes.byref(w),
                         err, _ERR_LEN), err)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(lib.decode_jpeg(data, len(data), out.ctypes.data_as(_u8p),
                           h.value, w.value, int(eof_fill), err, _ERR_LEN),
           err)
    return out


def resize_linear_u8(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] → [h, w(, C)] for size (w, h), as
    cv2.resize(image, size, interpolation=cv2.INTER_LINEAR)."""
    w, h = size
    src = np.ascontiguousarray(image)
    cn = 1 if src.ndim == 2 else src.shape[2]
    out = np.empty((h, w) + src.shape[2:], np.uint8)
    if library().resize_linear_u8(src.ctypes.data_as(_u8p), src.shape[0],
                                  src.shape[1], cn, out.ctypes.data_as(_u8p),
                                  h, w):
        raise MemoryError("image_codec: out of memory")
    return out


def _resize_f32(name: str, image: np.ndarray,
                size: tuple[int, int]) -> np.ndarray:
    w, h = size
    src = np.ascontiguousarray(image, np.float32)
    cn = 1 if src.ndim == 2 else src.shape[2]
    out = np.empty((h, w) + src.shape[2:], np.float32)
    if getattr(library(), name)(src.ctypes.data_as(_f32p), src.shape[0],
                                src.shape[1], cn, out.ctypes.data_as(_f32p),
                                h, w):
        raise MemoryError("image_codec: out of memory")
    return out


def resize_linear_f32(image: np.ndarray,
                      size: tuple[int, int]) -> np.ndarray:
    """float32 [H, W, 2] → [h, w, 2] for size (w, h), as
    cv2.resize(image, size, interpolation=cv2.INTER_LINEAR)."""
    return _resize_f32("resize_linear_f32", image, size)


def resize_area_f32(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """float32 [H, W] or [H, W, C] → [h, w(, C)] for size (w, h) no larger,
    as cv2.resize(image, size, interpolation=cv2.INTER_AREA)."""
    return _resize_f32("resize_area_f32", image, size)


def fill_polygons(img: np.ndarray, polygons: list, value: int = 1) -> None:
    """cv2.fillPoly(img, polygons, value) on a C-contiguous uint8 [h, w]
    array, in place: integer (x, y) point arrays, filled in one call."""
    if img.dtype != np.uint8 or img.ndim != 2 or not img.flags.c_contiguous:
        raise ValueError("fill_polygons takes a C-contiguous uint8 [h, w]")
    parts = [np.asarray(p, np.int64).reshape(-1, 2) for p in polygons]
    counts = np.array([len(p) for p in parts], np.int32)
    pts = np.ascontiguousarray(
        np.concatenate(parts) if parts else np.zeros((0, 2)), np.int32)
    if library().fill_polygons(img.ctypes.data_as(_u8p), img.shape[0],
                               img.shape[1], pts.ctypes.data_as(_i32p),
                               counts.ctypes.data_as(_i32p), len(parts),
                               int(value)):
        raise MemoryError("image_codec: out of memory")
