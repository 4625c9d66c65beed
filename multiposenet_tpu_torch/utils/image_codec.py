"""ctypes binding of the host C library `csrc/image_codec.c`: JPEG
decoding (`utils/jpeg.py` is the plain version of its baseline part) and cv2's uint8
INTER_LINEAR resize (`utils/image_io.resize_linear_plain` is its plain
version). The library is built by `kernels.load_host` on first use; a
build that fails raises, and nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from multiposenet_tpu_torch import kernels

_ERR_LEN = 256
_u8p = ctypes.POINTER(ctypes.c_uint8)


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
