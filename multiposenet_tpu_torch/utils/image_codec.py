"""ctypes binding of the host C library `csrc/image_codec.c`: JPEG
decoding (`utils/jpeg.py` is the plain version of its baseline part) and
encoding as cv2.imencode does (`utils/jpeg.py encode_pixels`),
cv2's INTER_LINEAR resize on uint8 and on two-channel float32 and its
INTER_AREA on float32 (`utils/image_io.resize_linear_plain` and
`resize_area_plain` are their plain versions), cv2.fillPoly
(`data/masks.fill_polygons_plain`), the byte coders of the simple formats
(TIFF LZW and PackBits: `utils/tiff.py`; TIFF's JPEG strips:
`jpeg.decode_planes`; CCITT fax: `utils/ccitt.py`; GIF LZW:
`utils/gif.py`; BMP RLE4 and RLE8: `utils/bmp.py`; Radiance HDR pixels:
`utils/hdr.py`) and cv2.imencode's writers for .bmp, .ppm/.pam/.pfm, .sr,
.tif, .hdr/.pic and .gif (plain versions `bmp.encode`, `pxm.encode`,
`sunras.encode`, `tiff.encode`, `hdr.encode_plain`, `gif.encode_plain`).
The library is built by `kernels.load_host` on first use; a build that
fails raises, and nothing falls back to the plain versions.
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
    lib.jpeg_size.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                              intp, intp, ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_size.restype = ctypes.c_int
    lib.decode_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_long, _u8p,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_char_p, ctypes.c_int]
    lib.decode_jpeg.restype = ctypes.c_int
    lib.encode_jpeg.argtypes = [_u8p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, _u8p, ctypes.c_long,
                                ctypes.POINTER(ctypes.c_long)]
    lib.encode_jpeg.restype = ctypes.c_int
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
    for name in ("tiff_lzw", "packbits"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_long, _u8p, ctypes.c_long]
        fn.restype = ctypes.c_long
    lib.gif_lzw.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                            _u8p, ctypes.c_long]
    lib.gif_lzw.restype = ctypes.c_long
    lib.bmp_rle.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                            ctypes.c_int, _u8p, ctypes.c_int, ctypes.c_int,
                            _u8p, ctypes.c_char_p, ctypes.c_int]
    lib.bmp_rle.restype = ctypes.c_int
    sized = [_u8p, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_long,
             ctypes.POINTER(ctypes.c_long)]
    for name in ("encode_bmp", "encode_sunras", "encode_tiff", "encode_hdr",
                 "encode_gif"):
        getattr(lib, name).argtypes = sized
        getattr(lib, name).restype = ctypes.c_int
    lib.encode_pxm.argtypes = [ctypes.c_int] + sized
    lib.encode_pxm.restype = ctypes.c_int
    lib.decode_jpeg_tiff.argtypes = [ctypes.c_char_p, ctypes.c_long, _u8p,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.decode_jpeg_tiff.restype = ctypes.c_int
    lib.fax_runs.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fax_runs.restype = ctypes.c_long
    lib.fax_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
                               ctypes.POINTER(ctypes.c_int), _u8p]
    lib.fax_decode.restype = ctypes.c_int
    lib.hdr_pixels.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                               ctypes.c_int, _u8p]
    lib.hdr_pixels.restype = ctypes.c_int
    return lib


def _check(rc: int, err: ctypes.Array) -> None:
    if rc == 1:
        raise ValueError(err.value.decode(errors="replace"))
    if rc:
        raise MemoryError("image_codec: out of memory")


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(height, width) from a JPEG file's frame header, before any Exif
    orientation; the header is walked up to the first SOS (a header the
    data cuts is filled as `decode_jpeg` with `eof_fill` fills it), and
    a bad one raises ValueError as decode_jpeg does."""
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w = ctypes.c_int(), ctypes.c_int()
    _check(library().jpeg_size(data, len(data), 1,
                               ctypes.byref(h), ctypes.byref(w), err,
                               _ERR_LEN), err)
    return h.value, w.value


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
    _check(lib.jpeg_size(data, len(data), int(eof_fill), ctypes.byref(h),
                         ctypes.byref(w), err, _ERR_LEN), err)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(lib.decode_jpeg(data, len(data), out.ctypes.data_as(_u8p),
                           h.value, w.value, int(eof_fill), err, _ERR_LEN),
           err)
    return out


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """uint8 RGB [H, W, 3] → the bytes `cv2.imencode(".jpg", bgr,
    [cv2.IMWRITE_JPEG_QUALITY, quality])` writes (95 is cv2's default)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError("encode_jpeg takes uint8 RGB [H, W, 3]; got "
                         f"{rgb.dtype} {rgb.shape}")
    src = np.ascontiguousarray(rgb)
    h, w = src.shape[:2]
    size = ctypes.c_long()
    cap = 1024 + ((h + 15) // 16) * ((w + 15) // 16) * 6 * 256
    while True:
        out = np.empty(cap, np.uint8)
        rc = library().encode_jpeg(src.ctypes.data_as(_u8p), h, w, quality,
                                   out.ctypes.data_as(_u8p), cap,
                                   ctypes.byref(size))
        if rc != 1:
            break
        cap = size.value
    if rc == 3:
        raise ValueError(f"cannot encode {h}x{w} at quality {quality}")
    if rc:
        raise MemoryError("image_codec: out of memory")
    return out[:size.value].tobytes()


def decode_jpeg_tiff(data: bytes, channels: int,
                     ycc_to_rgb: bool) -> np.ndarray:
    """A TIFF strip's or tile's JPEG stream (JPEGTables in front) as
    libtiff's JPEG codec decodes it → uint8 [H, W, channels]: RGB from
    YCbCr with `ycc_to_rgb` (channels 3), else every component as it is
    (channels the stream's components; `jpeg.decode_planes` is the plain
    version of the baseline part)."""
    lib = library()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w = ctypes.c_int(), ctypes.c_int()
    _check(lib.jpeg_size(data, len(data), 1, ctypes.byref(h),
                         ctypes.byref(w), err, _ERR_LEN), err)
    out = np.empty((h.value, w.value, channels), np.uint8)
    _check(lib.decode_jpeg_tiff(data, len(data), out.ctypes.data_as(_u8p),
                                h.value, w.value, channels, int(ycc_to_rgb),
                                err, _ERR_LEN), err)
    return out


def fax_decode(data: bytes, width: int, rows: int, compression: int,
               t4options: int, fill_order: int,
               codec: dict) -> tuple[np.ndarray, bool]:
    """libtiff's CCITT decoding of one strip or tile (`ccitt.decode`, the
    plain version, says what and how): → (rows [rows, width] of 0/1, 1
    black; False where libtiff's decoder fails). `codec` carries libtiff's
    state from one strip of an image to the next."""
    lib = library()
    data = bytes(data)
    two_d = int(compression == 4 or (compression == 3 and t4options & 1))
    n = 2 * lib.fax_runs(width, two_d)
    state = codec.get("c")
    if state is None or len(state[0]) != n:
        state = codec["c"] = (np.zeros(n, np.uint32), ctypes.c_int(0))
    runs, noeol = state
    out = np.zeros((rows, width), np.uint8)
    rc = lib.fax_decode(data, len(data), width, rows, compression, t4options,
                        fill_order,
                        runs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                        ctypes.byref(noeol), out.ctypes.data_as(_u8p))
    if rc == 2:
        raise MemoryError("image_codec: out of memory")
    return out, rc == 1


def hdr_pixels(body: bytes, height: int, width: int) -> np.ndarray:
    """OpenCV's RGBE_ReadPixels_RLE of a Radiance HDR file's pixels (the
    bytes after its header) → uint8 RGB [height, width, 3] as cv2 scales
    them (`hdr.decode_pixels_plain`)."""
    body = bytes(body)
    out = np.empty((height, width, 3), np.uint8)
    rc = library().hdr_pixels(body, len(body), height, width,
                              out.ctypes.data_as(_u8p))
    if rc == 2:
        raise MemoryError("image_codec: out of memory")
    if rc:
        raise ValueError("Radiance HDR pixels end early or hold a bad run "
                         "(cv2 returns no image)")
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


def _stream(fn: str, data: bytes, want: int) -> bytes:
    data = bytes(data)
    out = np.empty(max(want, 1), np.uint8)
    n = getattr(library(), fn)(data, len(data), out.ctypes.data_as(_u8p),
                               want)
    return out[:n].tobytes()


def tiff_lzw(data: bytes, want: int) -> bytes:
    """libtiff's LZW decode of one strip or tile, up to `want` bytes, or
    fewer where the codes fail or end first (`tiff.lzw_decode_plain`)."""
    return _stream("tiff_lzw", data, want)


def packbits(data: bytes, want: int) -> bytes:
    """libtiff's PackBits decode, up to `want` bytes
    (`tiff.packbits_plain`)."""
    return _stream("packbits", data, want)


# What GIF LZW decoding refuses, as cv2's decoder gives up: the C
# library's return values -1..-4 (`gif.lzw_decode_plain` raises the same).
GIF_LZW_ERRORS = ("LZW code past its table",
                  "LZW string past the frame's last pixel",
                  "LZW data past the frame's last pixel",
                  "LZW data that ends before the frame's last pixel")


def gif_lzw(data: bytes, min_size: int, count: int) -> bytes:
    """GIF LZW → exactly `count` palette indices as OpenCV's decoder
    gives them, or a ValueError naming what it refuses
    (`gif.lzw_decode_plain`)."""
    data = bytes(data)
    out = np.empty(max(count, 1), np.uint8)
    n = library().gif_lzw(data, len(data), min_size,
                          out.ctypes.data_as(_u8p), count)
    if n < 0:
        raise ValueError(GIF_LZW_ERRORS[-n - 1])
    return out[:n].tobytes()


def bmp_rle(data: bytes, offset: int, bits: int, palette: np.ndarray,
            height: int, width: int, name="<bytes>") -> np.ndarray:
    """A BMP RLE4 or RLE8 stream → RGB rows [height, width, 3] in file
    order, as cv2 runs it (`bmp.rle_plain`)."""
    data = bytes(data)
    pal = np.ascontiguousarray(palette, np.uint8)
    out = np.empty((height, width, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().bmp_rle(data, len(data), offset, bits,
                         pal.ctypes.data_as(_u8p), height, width,
                         out.ctypes.data_as(_u8p), err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    return out


_PXM_KINDS = {"ppm": 0, "pam": 1, "pfm": 2}


def encode_image(rgb: np.ndarray, kind: str) -> bytes:
    """uint8 RGB [H, W, 3] → what `cv2.imencode` writes for `kind`: one of
    "bmp", "ppm", "pam", "pfm", "sunras", "tiff", "hdr", "gif" (sides of
    at most 65535 pixels for "gif", as `utils/gif.py encode` checks)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"encode_image takes uint8 RGB [H, W, 3]; got "
                         f"{rgb.dtype} {rgb.shape}")
    src = np.ascontiguousarray(rgb)
    h, w = src.shape[:2]
    lib = library()
    if kind in _PXM_KINDS:
        fn = functools.partial(lib.encode_pxm, _PXM_KINDS[kind])
    else:
        fn = getattr(lib, "encode_" + kind)
    size = ctypes.c_long()
    # A GIF's size is the C's own bound (12 bits a pixel at most, less
    # than a tenth of this), which a first call with no room returns.
    cap = 0 if kind == "gif" else 1024 + h * w * 13 + h * 16
    while True:
        out = np.empty(cap, np.uint8)
        rc = fn(src.ctypes.data_as(_u8p), h, w, out.ctypes.data_as(_u8p),
                cap, ctypes.byref(size))
        if rc != 1:
            break
        cap = size.value
    if rc:
        raise MemoryError("image_codec: out of memory")
    return out[:size.value].tobytes()
