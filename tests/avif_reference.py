"""libaom's own decode of an AV1 stream, for tests and `tools/` only.

The opencv-python wheel carries the libaom that cv2's AVIF reader decodes
through (`opencv_python.libs/libaom-*.so.3.14.1`). Its decoder is exported,
so ctypes can drive it: `aom_planes(obus)` returns the Y, U and V planes
(uint8, or uint16 at 10 and 12 bits, cropped to the frame's size; U and V
are None for a monochrome stream) that libaom decodes from a stream of
OBUs. `LIBAOM` is the library's path, or None where the wheel is absent
(tests then skip). `avif_yuv_to_rgb` drives the wheel's libavif 1.4.2
(`LIBAVIF`): its avifImageYUVToRGB on given planes.

The ABI facts (aom_codec_dec_init_ver's ABI version 22, the offsets in
aom_image_t) are libaom 3.14.1's.
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct
from pathlib import Path

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - the card's machine has no cv2
    cv2 = None


def _find_libaom() -> str | None:
    if cv2 is None:
        return None
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")
    found = sorted(glob.glob(os.path.join(libs, "libaom-*.so.3.14.1")))
    return found[0] if found else None


LIBAOM = _find_libaom()
AOM_DECODER_ABI_VERSION = 22
AOM_IMG_FMT_HIGHBITDEPTH = 0x800
# av1_dx_iface.c's decoder_ctrl_maps: 267 -> ctrl_set_skip_loop_filter,
# which in libaom 3.14.1 skips CDEF only (the deblocking filter still runs:
# tests/test_torch_avif.py::test_planes_before_cdef_equal_libaoms).
AV1D_SET_SKIP_LOOP_FILTER = 267
# decoder_ctrl_maps: 282 -> ctrl_set_skip_film_grain (libaom applies the
# film grain to the frames it outputs unless this is set).
AV1D_SET_SKIP_FILM_GRAIN = 282

_lib = None


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        if LIBAOM is None:
            raise RuntimeError("the opencv-python wheel's libaom is absent")
        lib = ctypes.CDLL(LIBAOM)
        lib.aom_codec_av1_dx.restype = ctypes.c_void_p
        lib.aom_codec_dec_init_ver.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_int]
        lib.aom_codec_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_size_t, ctypes.c_void_p]
        lib.aom_codec_get_frame.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.aom_codec_get_frame.restype = ctypes.c_void_p
        lib.aom_codec_destroy.argtypes = [ctypes.c_void_p]
        lib.aom_codec_control.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int]
        _lib = lib
    return _lib


def aom_planes(obus: bytes, skip_loop_filter: bool = False,
               skip_film_grain: bool = False):
    """(Y, U, V) as libaom decodes the OBU stream `obus`, its film grain
    applied; U, V None for a monochrome stream. With `skip_loop_filter`,
    control 267 is set first: the planes before CDEF; with
    `skip_film_grain`, control 282: the planes before the film grain."""
    lib = library()
    ctx = ctypes.create_string_buffer(256)
    # aom_codec_dec_cfg_t: threads, w, h, allow_lowbitdepth.
    cfg = (ctypes.c_uint * 4)(1, 0, 0, 1)
    rc = lib.aom_codec_dec_init_ver(ctx, lib.aom_codec_av1_dx(), cfg, 0,
                                    AOM_DECODER_ABI_VERSION)
    if rc:
        raise RuntimeError(f"aom_codec_dec_init_ver: {rc}")
    try:
        if skip_loop_filter:
            lib.aom_codec_control(ctx, AV1D_SET_SKIP_LOOP_FILTER, 1)
        if skip_film_grain:
            lib.aom_codec_control(ctx, AV1D_SET_SKIP_FILM_GRAIN, 1)
        rc = lib.aom_codec_decode(ctx, obus, len(obus), None)
        if rc:
            raise RuntimeError(f"aom_codec_decode: {rc}")
        it = ctypes.c_void_p(0)
        img = lib.aom_codec_get_frame(ctx, ctypes.byref(it))
        if not img:
            raise RuntimeError("aom_codec_get_frame: no frame")
        head = ctypes.string_at(img, 112)
        fmt, = np.frombuffer(head[0:4], np.uint32)
        mono, = np.frombuffer(head[16:20], np.int32)
        d_w, d_h, _, _, xs, ys = np.frombuffer(head[40:64], np.int32)
        planes = np.frombuffer(head[64:88], np.uint64)
        strides = np.frombuffer(head[88:100], np.int32)
        size = 2 if fmt & AOM_IMG_FMT_HIGHBITDEPTH else 1
        out = []
        for p in range(3):
            if p and mono:
                out.append(None)
                continue
            w = (d_w + xs) >> xs if p else d_w
            h = (d_h + ys) >> ys if p else d_h
            raw = ctypes.string_at(int(planes[p]), int(strides[p]) * h)
            a = np.frombuffer(raw, np.uint8 if size == 1 else np.uint16)
            a = a.reshape(h, int(strides[p]) // size)[:, :w]
            out.append(a.copy())
        return tuple(out)
    finally:
        lib.aom_codec_destroy(ctx)


# --- libavif's YUV to RGB ----------------------------------------------------

# libavif 1.4.2's ABI (avif.h): offsets in avifImage (width, height,
# depth, yuvFormat, yuvRange, then yuvPlanes[3], yuvRowBytes[3], ...,
# alphaPlane, alphaRowBytes, ..., colorPrimaries, transferCharacteristics,
# matrixCoefficients), avifRGBImage (depth, format, ..., pixels, rowBytes)
# and avifEncoder (speed, quality); avifPixelFormat 1 (4:4:4), 2 (4:2:2),
# 3 (4:2:0), 4 (4:0:0); avifRGBFormat 3 (BGR), 4 (BGRA).
_IMG_RANGE, _IMG_PLANES, _IMG_ROW_BYTES = 16, 24, 48
_IMG_ALPHA, _IMG_ALPHA_ROW_BYTES = 64, 72
_IMG_PRIMARIES, _IMG_TRANSFER, _IMG_MATRIX = 104, 106, 108
_RGB_DEPTH, _RGB_FORMAT, _RGB_PIXELS, _RGB_ROW_BYTES = 8, 12, 48, 56
_ENC_SPEED, _ENC_QUALITY = 8, 32
_ADD_IMAGE_SINGLE = 2  # AVIF_ADD_IMAGE_FLAG_SINGLE
YUV444, YUV422, YUV420, YUV400 = 1, 2, 3, 4
# (ssx, ssy) of each avifPixelFormat with chroma planes.
SUBSAMPLING = {YUV444: (0, 0), YUV422: (1, 0), YUV420: (1, 1)}
_libavif = []


def _find_libavif() -> str | None:
    if LIBAOM is None:
        return None
    found = sorted(glob.glob(os.path.join(os.path.dirname(LIBAOM),
                                          "libavif-*.so.16.4.2")))
    return found[0] if found else None


LIBAVIF = _find_libavif()


def libavif() -> ctypes.CDLL:
    """The wheel's libavif 1.4.2, which cv2's AVIF reader converts
    through (and cv2's writer encodes through)."""
    if not _libavif:
        lib = ctypes.CDLL(LIBAVIF)
        u32, vp = ctypes.c_uint32, ctypes.c_void_p
        lib.avifImageCreate.restype = vp
        lib.avifImageCreate.argtypes = [u32] * 4
        lib.avifImageAllocatePlanes.argtypes = [vp, u32]
        lib.avifImageDestroy.argtypes = [vp]
        lib.avifRGBImageSetDefaults.argtypes = [vp, vp]
        lib.avifRGBImageAllocatePixels.argtypes = [vp]
        lib.avifRGBImageFreePixels.argtypes = [vp]
        lib.avifImageYUVToRGB.argtypes = [vp, vp]
        lib.avifEncoderCreate.restype = vp
        lib.avifEncoderDestroy.argtypes = [vp]
        lib.avifEncoderSetCodecSpecificOption.argtypes = [
            vp, ctypes.c_char_p, ctypes.c_char_p]
        lib.avifEncoderWrite.argtypes = [vp, vp, vp]
        lib.avifEncoderAddImage.argtypes = [vp, vp, ctypes.c_uint64, u32]
        lib.avifEncoderAddImageGrid.argtypes = [vp, u32, u32, vp, u32]
        lib.avifEncoderFinish.argtypes = [vp, vp]
        lib.avifImageSetMetadataExif.argtypes = [vp, ctypes.c_char_p,
                                                 ctypes.c_size_t]
        lib.avifRWDataFree.argtypes = [vp]
        _libavif.append(lib)
    return _libavif[0]


def _at(base, off, kind=ctypes.c_uint32):
    return kind.from_address(base + off)


def _avif_image(planes, depth: int, yuv_format: int, matrix: int,
                full_range: int, primaries: int, transfer: int,
                alpha: np.ndarray | None) -> int:
    """An avifImage (the caller destroys it) holding the planes."""
    lib = libavif()
    h, w = planes[0].shape
    img = lib.avifImageCreate(w, h, depth, yuv_format)
    assert (_at(img, 0).value, _at(img, 4).value, _at(img, 8).value,
            _at(img, 12).value) == (w, h, depth, yuv_format)
    _at(img, _IMG_RANGE).value = full_range  # AVIF_RANGE_FULL is 1
    assert lib.avifImageAllocatePlanes(img, 0xFF if alpha is not None
                                       else 1) == 0
    for off, v in ((_IMG_PRIMARIES, primaries), (_IMG_TRANSFER, transfer),
                   (_IMG_MATRIX, matrix)):
        _at(img, off, ctypes.c_uint16).value = v
    dtype = np.uint8 if depth == 8 else np.uint16
    fields = [(_IMG_PLANES + 8 * p, _IMG_ROW_BYTES + 4 * p)
              for p in range(3)] + [(_IMG_ALPHA, _IMG_ALPHA_ROW_BYTES)]
    for (ptr, row_bytes), a in zip(fields, list(planes) + [alpha]):
        if a is None:
            continue
        a = np.ascontiguousarray(a, dtype)
        base = ctypes.c_void_p.from_address(img + ptr).value
        stride = _at(img, row_bytes).value
        for r in range(a.shape[0]):
            ctypes.memmove(base + r * stride, a[r].ctypes.data,
                           a.shape[1] * a.itemsize)
    return img


def avif_yuv_to_rgb(planes, depth: int, yuv_format: int, matrix: int,
                    alpha: np.ndarray | None = None, full_range: int = 1,
                    primaries: int = 2, transfer: int = 2
                    ) -> np.ndarray | None:
    """uint8 RGB [H, W, 3] from libavif's avifImageYUVToRGB on the
    planes (Y, U, V; U and V None for 4:0:0) at `depth` bits, in the
    colour description given (CICP and range), into an 8-bit avifRGBImage
    at libavif's defaults: BGR, or BGRA with the `alpha` plane (as cv2
    reads a file with an alpha item). None where libavif refuses the
    conversion."""
    lib = libavif()
    h, w = planes[0].shape
    img = _avif_image(planes, depth, yuv_format, matrix, full_range,
                      primaries, transfer, alpha)
    try:
        rgb = ctypes.create_string_buffer(128)
        ra = ctypes.addressof(rgb)
        lib.avifRGBImageSetDefaults(rgb, img)
        _at(ra, _RGB_DEPTH).value = 8
        _at(ra, _RGB_FORMAT).value = 3 if alpha is None else 4
        assert lib.avifRGBImageAllocatePixels(rgb) == 0
        try:
            if lib.avifImageYUVToRGB(img, rgb):
                return None
            n = 3 if alpha is None else 4
            stride = _at(ra, _RGB_ROW_BYTES).value
            raw = ctypes.string_at(
                ctypes.c_void_p.from_address(ra + _RGB_PIXELS).value,
                stride * h)
            out = np.frombuffer(raw, np.uint8).reshape(h, stride)
            return out[:, :n * w].reshape(h, w, n)[:, :, 2::-1].copy()
        finally:
            lib.avifRGBImageFreePixels(rgb)
    finally:
        lib.avifImageDestroy(img)


def avif_encode(planes, depth: int, yuv_format: int, quality: int = 50,
                speed: int = 6, matrix: int = 6, full_range: int = 1,
                primaries: int = 1, transfer: int = 13,
                alpha: np.ndarray | None = None, exif: bytes | None = None,
                **options) -> bytes:
    """The AVIF file the wheel's libavif 1.4.2 encoder (over its libaom
    3.14.1, as cv2.imwrite calls it) writes for the given planes (Y, U,
    V; U and V None for 4:0:0) of `depth` bits in `yuv_format`, with the
    colour description given in its `colr` box and sequence header, an
    alpha item where `alpha` is given and an Exif item where `exif` (the
    TIFF bytes, or any bytes avifImageSetMetadataExif takes) is given;
    `options` are aom's (`enable_cdef="1"`: underscores for dashes)."""
    return _encode([planes], depth, yuv_format, quality, speed, matrix,
                   full_range, primaries, transfer,
                   None if alpha is None else [alpha], exif, options)


def avif_grid(cells, columns: int, rows: int, depth: int, yuv_format: int,
              quality: int = 50, speed: int = 6, matrix: int = 6,
              full_range: int = 1, primaries: int = 1, transfer: int = 13,
              alpha=None, exif: bytes | None = None, **options) -> bytes:
    """A grid image from the wheel's libavif 1.4.2 encoder
    (avifEncoderAddImageGrid, then avifEncoderFinish): `cells` are the
    planes of each cell (row by row, all of one size), `alpha` the alpha
    plane of each cell or None; output size the cells' span (crop it with
    `patch_grid`). The rest as for `avif_encode`."""
    assert len(cells) == columns * rows
    return _encode(cells, depth, yuv_format, quality, speed, matrix,
                   full_range, primaries, transfer, alpha, exif, options,
                   grid=(columns, rows))


def avif_sequence(frames, depth: int, yuv_format: int, quality: int = 50,
                  speed: int = 6, matrix: int = 6, full_range: int = 1,
                  primaries: int = 1, transfer: int = 13, alpha=None,
                  exif: bytes | None = None, **options) -> bytes:
    """An image sequence (brand avis) from the wheel's libavif 1.4.2
    encoder: avifEncoderAddImage for each frame's planes (one timescale
    unit each), then avifEncoderFinish. The rest as for `avif_encode`."""
    return _encode(frames, depth, yuv_format, quality, speed, matrix,
                   full_range, primaries, transfer, alpha, exif, options,
                   sequence=True)


def _encode(images, depth, yuv_format, quality, speed, matrix, full_range,
            primaries, transfer, alpha, exif, options, grid=None,
            sequence=False) -> bytes:
    lib = libavif()
    imgs = [_avif_image(p, depth, yuv_format, matrix, full_range, primaries,
                        transfer, None if alpha is None else alpha[i])
            for i, p in enumerate(images)]
    if exif is not None:
        assert lib.avifImageSetMetadataExif(imgs[0], exif, len(exif)) == 0
    enc = lib.avifEncoderCreate()
    out = (ctypes.c_void_p * 2)()
    try:
        _at(enc, _ENC_SPEED, ctypes.c_int).value = speed
        _at(enc, _ENC_QUALITY, ctypes.c_int).value = quality
        for key, value in options.items():
            assert lib.avifEncoderSetCodecSpecificOption(
                enc, key.replace("_", "-").encode(), str(value).encode()) == 0
        if grid is not None:
            cells = (ctypes.c_void_p * len(imgs))(*imgs)
            rc = lib.avifEncoderAddImageGrid(enc, grid[0], grid[1], cells,
                                             _ADD_IMAGE_SINGLE)
        elif sequence:
            rc = 0
            for img in imgs:
                rc = rc or lib.avifEncoderAddImage(enc, img, 1, 0)
        else:
            rc = lib.avifEncoderWrite(enc, imgs[0], out)
            if rc:
                raise RuntimeError(f"avifEncoderWrite: {rc}")
            return ctypes.string_at(out[0], out[1])
        if rc:
            raise RuntimeError(f"avifEncoderAddImage(Grid): {rc}")
        rc = lib.avifEncoderFinish(enc, out)
        if rc:
            raise RuntimeError(f"avifEncoderFinish: {rc}")
        return ctypes.string_at(out[0], out[1])
    finally:
        lib.avifRWDataFree(out)
        lib.avifEncoderDestroy(enc)
        for img in imgs:
            lib.avifImageDestroy(img)


# Kr and Kb of the matrix coefficients `planes_of` writes.
KR_KB = {1: (0.2126, 0.0722), 6: (0.299, 0.114), 9: (0.2627, 0.0593)}


def planes_of(rgb: np.ndarray, depth: int, yuv_format: int, matrix: int = 6,
              full_range: int = 1):
    """Y, U and V planes of `depth` bits (U, V None at 4:0:0) made from
    RGB pixels (uint8, or uint16 of `depth` bits) by the equations of
    matrix coefficients 1 (BT.709), 6 (BT.601) or 9 (BT.2020) at limited
    or full range, the chroma averaged over each subsampled block: input
    for `avif_encode`."""
    x = rgb.astype(np.float64)
    top = (1 << depth) - 1
    x /= 255 if rgb.dtype == np.uint8 else top
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    kr, kb = KR_KB[matrix]
    y = kr * r + (1 - kr - kb) * g + kb * b
    u, v = (b - y) / (2 - 2 * kb), (r - y) / (2 - 2 * kr)
    half = 1 << (depth - 1)
    if full_range:
        y, u, v = y * top, u * top + half, v * top + half
    else:
        s = 1 << (depth - 8)
        y, u, v = (16 + 219 * y) * s, (224 * u) * s + half, (224 * v) * s \
            + half

    def q(a):
        return np.clip(np.rint(a), 0, top).astype(
            np.uint8 if depth == 8 else np.uint16)

    if yuv_format == YUV400:
        return q(y), None, None
    ssx, ssy = SUBSAMPLING[yuv_format]
    h, w = y.shape

    def sub(c):
        hh, ww = (h + ssy) >> ssy, (w + ssx) >> ssx
        pad = np.pad(c, ((0, hh * (1 + ssy) - h), (0, ww * (1 + ssx) - w)),
                     mode="edge")
        return pad.reshape(hh, 1 + ssy, ww, 1 + ssx).mean(axis=(1, 3))

    return q(y), q(sub(u)), q(sub(v))


# --- hand-edited files -------------------------------------------------------


def _box(kind: bytes, payload: bytes) -> bytes:
    return (8 + len(payload)).to_bytes(4, "big") + kind + payload


def _children(data: bytes, start: int, end: int) -> list[tuple[bytes, bytes]]:
    out, pos = [], start
    while pos < end:
        size = int.from_bytes(data[pos:pos + 4], "big")
        out.append((data[pos + 4:pos + 8], data[pos + 8:pos + size]))
        pos += size
    return out


def edit_avif(data: bytes, add_props=(), drop_props=(), exif: bytes | None
              = None, alpha: bytes | None = None, brand: bytes | None = None,
              primary_type: bytes | None = None, idat: bool = False,
              color: bytes | None = None) -> bytes:
    """A copy of a cv2-written AVIF file (one item, iloc version 0) with
    properties added to the primary item ((kind, payload, essential)
    each), properties dropped by kind, an Exif item (`exif`: the TIFF
    bytes, behind a 4-byte offset of 0, linked by `cdsc`), an alpha
    auxiliary item (`alpha`: its AV1 OBUs, with an `auxC` and an `auxl`
    reference), another major brand, another item type for the primary
    item, or the image data moved into an `idat` box (construction
    method 1), or the primary item's AV1 stream replaced by `color`.
    Everything else is kept in cv2's order."""
    top = _children(data, 0, len(data))
    ftyp = dict(top)[b"ftyp"]
    meta = dict(top)[b"meta"]
    mdat = dict(top)[b"mdat"]
    kids = _children(meta, 4, len(meta))
    box = dict(kids)
    iloc = box[b"iloc"]
    off = int.from_bytes(iloc[14:18], "big")
    length = int.from_bytes(iloc[18:22], "big")
    mdat_start = len(data) - len(mdat)
    if color is None:
        color = mdat[off - mdat_start:off - mdat_start + length]
    iprp = _children(box[b"iprp"], 0, len(box[b"iprp"]))
    ipco = _children(dict(iprp)[b"ipco"], 0, len(dict(iprp)[b"ipco"]))
    ipma = dict(iprp)[b"ipma"]
    n_assoc = ipma[10]
    assoc = list(ipma[11:11 + n_assoc])
    kinds = [k for k, _ in ipco]
    keep = [i for i, k in enumerate(kinds) if k not in drop_props]
    remap = {old: new for new, old in enumerate(keep)}
    props = [ipco[i] for i in keep]
    assoc = [(a & 0x80) | (remap[(a & 0x7F) - 1] + 1) for a in assoc
             if (a & 0x7F) - 1 in remap]
    for kind, payload, essential in add_props:
        props.append((kind, payload))
        assoc.append((0x80 if essential else 0) | len(props))
    items = [(1, primary_type or b"av01", b"Color", color, assoc)]
    refs = []
    if alpha is not None:
        props.append((b"auxC", b"\0\0\0\0urn:mpeg:mpegB:cicp:systems:"
                      b"auxiliary:alpha\0"))
        av1c = [i for i, (k, _) in enumerate(props) if k == b"av1C"][0]
        ispe = [i for i, (k, _) in enumerate(props) if k == b"ispe"][0]
        items.append((2, b"av01", b"Alpha", alpha,
                      [ispe + 1, 0x80 | (av1c + 1), len(props)]))
        refs.append((b"auxl", 2, 1))
    if exif is not None:
        items.append((len(items) + 1, b"Exif", b"Exif", b"\0\0\0\0" + exif,
                      []))
        refs.append((b"cdsc", len(items), 1))
    ipco_b = b"".join(_box(k, p) for k, p in props)
    ipma_b = b"\0\0\0\0" + sum(1 for it in items if it[4]).to_bytes(4, "big")
    for iid, _, _, _, a in items:
        if a:
            ipma_b += iid.to_bytes(2, "big") + bytes([len(a)]) + bytes(a)
    iinf_b = b"\0\0\0\0" + len(items).to_bytes(2, "big") + b"".join(
        _box(b"infe", b"\x02\0\0\0" + iid.to_bytes(2, "big") + b"\0\0" + t
             + name + b"\0") for iid, t, name, _, _ in items)
    iref_b = b"\0\0\0\0" + b"".join(
        _box(k, src.to_bytes(2, "big") + b"\0\x01" + dst.to_bytes(2, "big"))
        for k, src, dst in refs)

    def build(offsets, version):
        iloc_b = bytes([version, 0, 0, 0, 0x44, 0]) + len(items).to_bytes(
            2, "big")
        for (iid, _, _, payload, _), o in zip(items, offsets):
            iloc_b += iid.to_bytes(2, "big")
            if version:
                iloc_b += (1 if idat and iid == 1 else 0).to_bytes(2, "big")
            iloc_b += b"\0\0\0\x01" + o.to_bytes(4, "big") + len(
                payload).to_bytes(4, "big")
        parts = [_box(b"hdlr", box[b"hdlr"]), _box(b"pitm", box[b"pitm"]),
                 _box(b"iloc", iloc_b), _box(b"iinf", iinf_b)]
        if refs:
            parts.append(_box(b"iref", iref_b))
        parts.append(_box(b"iprp", _box(b"ipco", ipco_b)
                          + _box(b"ipma", ipma_b)))
        if idat:
            parts.append(_box(b"idat", color))
        return _box(b"meta", meta[:4] + b"".join(parts))

    version = 1 if idat else 0
    ftyp_b = _box(b"ftyp", (brand or ftyp[:4]) + ftyp[4:])
    payloads = [p for iid, _, _, p, _ in items if not (idat and iid == 1)]
    meta_b = build([0] * len(items), version)
    start = len(ftyp_b) + len(meta_b) + 8
    offsets, pos = [], start
    for iid, _, _, p, _ in items:
        if idat and iid == 1:
            offsets.append(0)
        else:
            offsets.append(pos)
            pos += len(p)
    meta_b = build(offsets, version)
    return ftyp_b + meta_b + _box(b"mdat", b"".join(payloads))


def heif_parts(data: bytes) -> dict:
    """An AVIF file's items as a dict `heif_write` writes back: brands
    (major, then compatible), primary item ID, items (id, type, name,
    data, props as (kind, payload, essential), idat: stored in `idat`,
    content_type of a mime item) in file order, and references (kind,
    from ID, to IDs). Tracks are not kept."""
    from multiposenet_tpu_torch.utils import avif

    c = avif.read_container(data)
    items = []
    for item in c.items.values():
        if not item.type:
            continue
        props = [(*c.properties[i], e) for i, e in zip(item.props,
                                                       item.essential)]
        items.append({"id": item.id, "type": item.type, "name": b"",
                      "data": avif.item_data(data, c, item),
                      "at": item.base + (item.extents or [(0, 0)])[0][0],
                      "props": props, "idat": item.method == 1,
                      "content_type": item.content_type})
    return {"brands": list(c.brands), "primary": c.primary, "items": items,
            "refs": [(k, s, list(d)) for k, s, d in c.refs]}


def heif_write(parts: dict, order=None, meta_pad: int = 0,
               before_meta: bytes = b"") -> bytes:
    """An AVIF file of `heif_parts`' form: ftyp, `before_meta` (whole
    boxes), meta (hdlr pict, pitm, iloc, iinf, iref, iprp with
    properties shared by value, idat; a `free` box of `meta_pad` bytes
    at its end), then mdat with the items' data in `order` (item IDs;
    default: the order of their data in the file `heif_parts` read)."""
    items = parts["items"]
    props: list = []
    assoc = {}
    for it in items:
        a = []
        for kind, payload, essential in it["props"]:
            if (kind, payload) not in props:
                props.append((kind, payload))
            a.append((props.index((kind, payload)) + 1, essential))
        assoc[it["id"]] = a
    wide = len(props) > 127
    ipma = b"\0\0\0" + bytes([1 if wide else 0]) + sum(
        1 for a in assoc.values() if a).to_bytes(4, "big")
    for iid, a in sorted(assoc.items()):
        if not a:
            continue
        ipma += iid.to_bytes(2, "big") + bytes([len(a)])
        for index, essential in a:
            if wide:
                ipma += ((0x8000 if essential else 0) | index).to_bytes(2,
                                                                        "big")
            else:
                ipma += bytes([(0x80 if essential else 0) | index])
    ipco = b"".join(_box(k, p) for k, p in props)
    iinf = b"\0\0\0\0" + len(items).to_bytes(2, "big")
    for it in items:
        body = b"\x02\0\0\0" + it["id"].to_bytes(2, "big") + b"\0\0" \
            + it["type"] + it["name"] + b"\0"
        if it["type"] == b"mime":
            body += it["content_type"] + b"\0"
        iinf += _box(b"infe", body)
    iref = b"\0\0\0\0" + b"".join(
        _box(k, s.to_bytes(2, "big") + len(d).to_bytes(2, "big")
             + b"".join(x.to_bytes(2, "big") for x in d))
        for k, s, d in parts["refs"])
    idat_items = [it for it in items if it["idat"]]
    version = 1 if idat_items else 0
    order = order or [it["id"] for it in sorted(
        (it for it in items if not it["idat"]), key=lambda i: i.get("at", 0))]
    by_id = {it["id"]: it for it in items}
    brands = parts["brands"]
    ftyp = _box(b"ftyp", brands[0] + b"\0\0\0\0" + b"".join(brands[1:]))

    def meta(offsets):
        iloc = bytes([version, 0, 0, 0, 0x44, 0]) + len(items).to_bytes(
            2, "big")
        for it in items:
            iloc += it["id"].to_bytes(2, "big")
            if version:
                iloc += (1 if it["idat"] else 0).to_bytes(2, "big")
            iloc += b"\0\0\0\x01" + offsets[it["id"]].to_bytes(4, "big") \
                + len(it["data"]).to_bytes(4, "big")
        kids = [_box(b"hdlr", b"\0" * 8 + b"pict" + b"\0" * 13),
                _box(b"pitm", b"\0\0\0\0" + parts["primary"].to_bytes(2,
                                                                   "big")),
                _box(b"iloc", iloc), _box(b"iinf", iinf)]
        if parts["refs"]:
            kids.append(_box(b"iref", iref))
        kids.append(_box(b"iprp", _box(b"ipco", ipco) + _box(b"ipma", ipma)))
        if idat_items:
            kids.append(_box(b"idat", b"".join(it["data"]
                                               for it in idat_items)))
        if meta_pad:
            kids.append(_box(b"free", b"\0" * meta_pad))
        return _box(b"meta", b"\0\0\0\0" + b"".join(kids))

    offsets = {it["id"]: 0 for it in items}
    pos = 0
    for it in idat_items:
        offsets[it["id"]] = pos
        pos += len(it["data"])
    start = len(ftyp) + len(before_meta) + len(meta(offsets)) + 8
    for iid in order:
        offsets[iid] = start
        start += len(by_id[iid]["data"])
    mdat = b"".join(by_id[iid]["data"] for iid in order)
    return ftyp + before_meta + meta(offsets) + _box(b"mdat", mdat)


def grid_from_rgb(rgb: np.ndarray, rows: int, columns: int, cell_h: int,
                  cell_w: int, depth: int = 8, yuv_format: int = YUV420,
                  alpha: np.ndarray | None = None, exif: bytes | None = None,
                  **kw) -> bytes:
    """A grid file from the wheel's libavif encoder: uint8 RGB pixels
    (and an alpha plane) padded by repeating their edges to rows x
    columns cells of cell_h x cell_w, the output cropped back to the
    pixels' size (`patch_grid`); `kw` as for `avif_grid`."""
    h, w = rgb.shape[:2]
    ph, pw = rows * cell_h - h, columns * cell_w - w
    big = np.pad(rgb, ((0, ph), (0, pw), (0, 0)), mode="edge")
    if depth > 8:
        big = widen(big, depth)
    cells, alphas = [], None
    for r in range(rows):
        for k in range(columns):
            cell = np.ascontiguousarray(big[r * cell_h:(r + 1) * cell_h,
                                            k * cell_w:(k + 1) * cell_w])
            cells.append(planes_of(cell, depth, yuv_format))
    if alpha is not None:
        a = np.pad(alpha, ((0, ph), (0, pw)), mode="edge")
        alphas = [np.ascontiguousarray(a[r * cell_h:(r + 1) * cell_h,
                                         k * cell_w:(k + 1) * cell_w])
                  for r in range(rows) for k in range(columns)]
    data = avif_grid(cells, columns, rows, depth, yuv_format, alpha=alphas,
                     exif=exif, **kw)
    return data if (ph, pw) == (0, 0) else patch_grid(data, w, h)


def grid_of_items(files, rows: int, columns: int, width: int, height: int,
                  grid_props=None, big: bool = False) -> bytes:
    """A grid file made of the primary items of single-item AVIF files
    (`files`, row by row) as its cells, each with its own properties,
    and a grid item (its payload in `idat`) of output `width` x `height`
    (32-bit fields with `big`) with an ispe of that size and
    `grid_props` ((kind, payload, essential) each; default: the first
    cell's `colr`)."""
    items, refs = [], []
    for k, data in enumerate(files):
        parts = heif_parts(data)
        cell = next(it for it in parts["items"]
                    if it["id"] == parts["primary"])
        items.append({**cell, "id": k + 2, "idat": False, "at": k})
    n = 4 if big else 2
    payload = bytes([0, int(big), rows - 1, columns - 1]) + width.to_bytes(
        n, "big") + height.to_bytes(n, "big")
    ispe = b"\0\0\0\0" + width.to_bytes(4, "big") + height.to_bytes(4, "big")
    if grid_props is None:
        grid_props = [p for p in items[0]["props"] if p[0] == b"colr"]
    grid = {"id": 1, "type": b"grid", "name": b"", "data": payload,
            "props": [(b"ispe", ispe, False), *grid_props], "idat": True,
            "content_type": b""}
    refs.append((b"dimg", 1, [it["id"] for it in items]))
    return heif_write({"brands": [b"avif", b"avif", b"mif1", b"miaf"],
                       "primary": 1, "items": [grid] + items, "refs": refs})


def patch_grid(data: bytes, width: int, height: int, rows: int | None = None,
               columns: int | None = None) -> bytes:
    """A grid file with its ImageGrid payload rewritten: output size
    (32-bit fields where a side passes 65535), and rows and columns where
    given; its ispe set to the new size."""
    parts = heif_parts(data)
    grid = next(it for it in parts["items"] if it["id"] == parts["primary"])
    old = grid["data"]
    big = width > 0xFFFF or height > 0xFFFF
    n = 4 if big else 2
    grid["data"] = bytes([0, int(big), old[2] if rows is None else rows - 1,
                          old[3] if columns is None else columns - 1]) \
        + width.to_bytes(n, "big") + height.to_bytes(n, "big")
    ispe = b"\0\0\0\0" + width.to_bytes(4, "big") + height.to_bytes(4, "big")
    grid["props"] = [(k, ispe if k == b"ispe" else p, e)
                     for k, p, e in grid["props"]]
    return heif_write(parts)


def tiff_orientation(orientation: int, little: bool = True,
                     prefix: bytes = b"") -> bytes:
    """Exif TIFF bytes of one IFD0 entry, the orientation, after
    `prefix`."""
    e = "<" if little else ">"
    return prefix + (b"II" if little else b"MM") + struct.pack(
        e + "HIHHHIHHI", 42, 8, 1, 0x0112, 3, 1, orientation, 0, 0)


# --- cv2's side --------------------------------------------------------------


def imencode_avif(pixels: np.ndarray, quality: int | None = None,
                  speed: int | None = None, depth: int | None = None) -> bytes:
    """The bytes cv2.imencode(".avif") writes for RGB, RGBA or gray
    pixels (at `quality` and `speed`, or cv2's defaults): uint8, or
    uint16 of `depth` bits (IMWRITE_AVIF_DEPTH 10 or 12; every value
    below 2^depth)."""
    if pixels.ndim == 3:
        order = [2, 1, 0, 3][:pixels.shape[2]]
        pixels = pixels[:, :, order]
    params = [] if quality is None else [cv2.IMWRITE_AVIF_QUALITY, quality]
    if speed is not None:
        params += [cv2.IMWRITE_AVIF_SPEED, speed]
    if depth is not None:
        params += [cv2.IMWRITE_AVIF_DEPTH, depth]
    ok, buf = cv2.imencode(".avif", np.ascontiguousarray(pixels), params)
    assert ok
    return buf.tobytes()


def drawing(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded uint8 RGB [h, w, 3] drawing: 2 to 8 flat colours in
    filled rectangles and circles, lines and text (cv2's shapes)."""
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (int(rng.integers(2, 9)), 3))
    img = np.empty((h, w, 3), np.uint8)
    img[:] = colours[0]

    def colour():
        return tuple(int(v) for v in colours[rng.integers(0, len(colours))])

    for _ in range(int(rng.integers(2, 8))):
        p = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        q = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        shape = int(rng.integers(0, 3))
        if shape == 0:
            cv2.rectangle(img, p, q, colour(), -1)
        elif shape == 1:
            cv2.circle(img, p, int(rng.integers(2, 30)), colour(), -1)
        else:
            cv2.line(img, p, q, colour(), int(rng.integers(1, 4)))
    for _ in range(int(rng.integers(1, 4))):
        cv2.putText(img, f"AbC {seed % 1000}", (int(rng.integers(0, w)),
                                                int(rng.integers(8, h + 8))),
                    cv2.FONT_HERSHEY_SIMPLEX, float(rng.uniform(0.3, 1.2)),
                    colour(), 1, cv2.LINE_8)
    return img


def widen(pixels: np.ndarray, depth: int, seed: int | None = None
          ) -> np.ndarray:
    """uint8 pixels as uint16 of `depth` bits: each value's bits
    repeated into the low ones (flat areas stay flat), or, with a
    `seed`, seeded noise in the low depth - 8 bits."""
    x = pixels.astype(np.uint16)
    if seed is None:
        return (x << (depth - 8)) | (x >> (16 - depth))
    noise = np.random.default_rng(seed).integers(
        0, 1 << (depth - 8), x.shape, dtype=np.uint16)
    return (x << (depth - 8)) | noise


def imdecode_rgb(data: bytes) -> np.ndarray | None:
    """cv2.imdecode(..., IMREAD_COLOR) reversed to RGB, or None."""
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[:, :, ::-1]


def patch_colr(data: bytes, matrix: int, full_range: int,
               primaries: int = 1, transfer: int = 13) -> bytes:
    """A copy of an AVIF file with the CICP and range of its first `colr`
    nclx box rewritten in place (the AV1 sequence header unchanged)."""
    at = data.index(b"colrnclx") + 8
    return (data[:at] + struct.pack(">HHHB", primaries, transfer, matrix,
                                    full_range << 7) + data[at + 7:])


def primary_obus(data: bytes) -> bytes:
    """The AV1 stream of an AVIF file's primary item (the port's container
    reader finds it; libaom decodes it)."""
    from multiposenet_tpu_torch.utils import avif

    c = avif.read_container(data)
    return avif.item_data(data, c, c.items[c.primary])


def sequence_obus(data: bytes) -> bytes:
    """The AV1 stream of an image sequence's first colour sample, its
    av1C configuration OBUs first (as the port reads it)."""
    from multiposenet_tpu_torch.utils import avif

    c = avif.read_container(data)
    track = avif._colour_track(c)
    offset, size = avif._samples(track)[0]
    av1c = dict(reversed(avif._sample_entry(track)[1]))[b"av1C"]
    return av1c[4:] + data[offset:offset + size]


def with_obus(data: bytes, obus: bytes) -> bytes:
    """A still AVIF file (`heif_parts` form) with its primary item's AV1
    data replaced by `obus`."""
    parts = heif_parts(data)
    for item in parts["items"]:
        if item["id"] == parts["primary"]:
            item["data"] = obus
    return heif_write(parts)


def grain_table(path, g, end: int = 10 ** 12) -> str:
    """Writes libaom's film grain table (the text `film-grain-table`
    reads: aom_film_grain_table_write's form) of one entry from time 0
    to `end` holding the parameters of an `avif.FilmGrain` `g` (all but
    its clip_to_restricted_range, which the table does not carry);
    returns the path."""
    n = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1)

    def pts(points):
        return f"{len(points)}" + "".join(f" {x} {y}" for x, y in points)

    def coeffs(values, count):
        return "".join(f" {v}" for v in (list(values) + [0] * count)[:count])

    text = ("filmgrn1\n"
            f"E 0 {end} 1 {g.seed} 1\n"
            f"\tp {g.ar_coeff_lag} {g.ar_coeff_shift} {g.grain_scale_shift} "
            f"{g.scaling_shift} {g.chroma_scaling_from_luma} {g.overlap} "
            f"{g.cb_mult + 128} {g.cb_luma_mult + 128} {g.cb_offset + 256} "
            f"{g.cr_mult + 128} {g.cr_luma_mult + 128} {g.cr_offset + 256}\n"
            f"\tsY {pts(g.y_points)}\n\tsCb {pts(g.cb_points)}\n"
            f"\tsCr {pts(g.cr_points)}\n\tcY{coeffs(g.ar_y, n)}\n"
            f"\tcCb{coeffs(g.ar_cb, n + 1)}\n\tcCr{coeffs(g.ar_cr, n + 1)}\n")
    Path(path).write_text(text)
    return str(path)


def draw_grain(rng, lag: int | None = None, luma: bool | None = None,
               csfl: bool | None = None, chroma: bool = True):
    """Seeded `avif.FilmGrain` parameters libaom accepts: a lag, 0 to 14
    increasing luma points (or `luma`), chroma scaling from luma or 0 to
    10 points per chroma plane (both or neither), every coefficient,
    multiplier and offset, shift and flag drawn."""
    from multiposenet_tpu_torch.utils import avif

    def points(most):
        n = int(rng.integers(1, most + 1))
        xs = sorted(rng.choice(256, n, replace=False).tolist())
        return tuple((x, int(rng.integers(0, 256))) for x in xs)

    lag = int(rng.integers(0, 4)) if lag is None else lag
    if luma is None:
        luma = bool(rng.integers(0, 4))
    g = avif.FilmGrain(seed=int(rng.integers(0, 1 << 16)))
    g.y_points = points(14) if luma else ()
    g.chroma_scaling_from_luma = int(rng.integers(0, 3) == 0) \
        if csfl is None else int(csfl)
    if chroma and not g.chroma_scaling_from_luma and rng.integers(0, 4):
        g.cb_points, g.cr_points = points(10), points(10)
    g.scaling_shift = int(rng.integers(8, 12))
    g.ar_coeff_lag = lag
    n = 2 * lag * (lag + 1)
    g.ar_y = tuple(int(v) for v in rng.integers(-128, 128, n)) \
        if g.y_points else ()
    n_chroma = n + (1 if g.y_points else 0)
    if g.cb_points or g.chroma_scaling_from_luma:
        g.ar_cb = tuple(int(v) for v in rng.integers(-128, 128, n_chroma))
        g.ar_cr = tuple(int(v) for v in rng.integers(-128, 128, n_chroma))
    g.ar_coeff_shift = int(rng.integers(6, 10))
    g.grain_scale_shift = int(rng.integers(0, 4))
    if g.cb_points:
        g.cb_mult, g.cb_luma_mult = (int(v) for v in rng.integers(-128, 128,
                                                                   2))
        g.cb_offset = int(rng.integers(-256, 256))
        g.cr_mult, g.cr_luma_mult = (int(v) for v in rng.integers(-128, 128,
                                                                   2))
        g.cr_offset = int(rng.integers(-256, 256))
    g.overlap = int(rng.integers(0, 2))
    g.clip_to_restricted_range = int(rng.integers(0, 2))
    return g


# --- header writers ----------------------------------------------------------


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def f(self, n: int, v: int) -> None:
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def su(self, n: int, v: int) -> None:
        self.f(n, v & ((1 << n) - 1))

    def trailing(self) -> bytes:
        self.bits.append(1)
        return self.aligned()

    def aligned(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                     for i in range(0, len(bits), 8))


def obu(kind: int, payload: bytes) -> bytes:
    """An OBU with its size field (uleb128)."""
    size, n = b"", len(payload)
    while True:
        byte = n & 0x7F
        n >>= 7
        size += bytes([byte | (0x80 if n else 0)])
        if not n:
            break
    return bytes([(kind << 3) | 2]) + size + payload


def sequence_header(s, level: int = 0) -> bytes:
    """The payload of a sequence header OBU with the fields of an
    `avif.SequenceHeader` `s` (reduced still picture syntax or, with
    s.reduced 0, the full syntax with one operating point and no timing
    or decoder model information)."""
    w = BitWriter()
    w.f(3, s.profile)
    w.f(1, 1)
    w.f(1, s.reduced)
    if s.reduced:
        w.f(5, level)
    else:
        w.f(1, 0)  # timing_info_present_flag
        w.f(1, 0)  # initial_display_delay_present_flag
        w.f(5, 0)  # operating_points_cnt_minus_1
        w.f(12, 0)
        w.f(5, level)
    w.f(4, s.frame_width_bits - 1)
    w.f(4, s.frame_height_bits - 1)
    w.f(s.frame_width_bits, s.max_width - 1)
    w.f(s.frame_height_bits, s.max_height - 1)
    if not s.reduced:
        w.f(1, 0)  # frame_id_numbers_present_flag
    w.f(1, s.sb128)
    w.f(1, s.filter_intra)
    w.f(1, s.intra_edge_filter)
    if not s.reduced:
        w.f(5, 0)  # interintra .. dual filter, enable_order_hint 0
        w.f(1, 1)  # seq_choose_screen_content_tools
        w.f(1, 1)  # seq_choose_integer_mv
    w.f(1, s.superres)
    w.f(1, s.cdef)
    w.f(1, s.restoration)
    w.f(1, int(s.bit_depth > 8))
    if s.profile == 2 and s.bit_depth > 8:
        w.f(1, int(s.bit_depth == 12))
    if s.profile != 1:
        w.f(1, s.mono)
    w.f(1, 1)
    w.f(8, s.primaries)
    w.f(8, s.transfer)
    w.f(8, s.matrix)
    if s.mono:
        w.f(1, s.full_range)
    elif not (s.primaries == 1 and s.transfer == 13 and s.matrix == 0):
        w.f(1, s.full_range)
        if s.profile == 2 and s.bit_depth == 12:
            w.f(1, s.ssx)
            if s.ssx:
                w.f(1, s.ssy)
        if s.ssx and s.ssy:
            w.f(2, 0)
    if not s.mono:
        w.f(1, s.separate_uv_delta_q)
    w.f(1, s.film_grain)
    return w.trailing()


def frame_header(s, h, extra=None) -> bytes:
    """The uncompressed header (byte-aligned) of a shown key frame with
    the fields of an `avif.FrameHeader` `h` under sequence header `s`
    (uniform tiles; segmentation_params from h.segmentation, h.seg_mask
    and h.seg_data; a lossless frame when every segment's qindex and dq
    are 0, with no loop filter, CDEF, restoration or tx mode fields;
    film_grain_params from h.grain where the sequence allows grain).
    `extra` names tools to signal: "superres" (refused by the port),
    "segmentation" (enabled, with h's features), "film_grain" (h.grain,
    or default parameters), "restoration" (switchable units on luma) and
    "intrabc" (allow_intrabc)."""
    extra = extra or ()
    w = BitWriter()
    if not s.reduced:
        w.f(1, 0)  # show_existing_frame
        w.f(2, 0)  # KEY_FRAME
        w.f(1, 1)  # show_frame
    w.f(1, h.disable_cdf_update)
    intrabc = h.allow_intrabc or "intrabc" in extra
    screen = 1 if intrabc else h.screen_content
    w.f(1, screen)
    if screen:
        w.f(1, 0)  # force_integer_mv
    if not s.reduced:
        w.f(1, 0)  # frame_size_override_flag
    if s.superres:
        w.f(1, int("superres" in extra))
        if "superres" in extra:
            w.f(3, 0)
    w.f(1, 0)  # render_and_frame_size_different
    if screen:
        w.f(1, int(intrabc))
    if not (s.reduced or h.disable_cdf_update):
        w.f(1, 0)  # disable_frame_end_update_cdf
    mi_cols = 2 * ((h.width + 7) >> 3)
    mi_rows = 2 * ((h.height + 7) >> 3)
    sb_cols, sb_rows = (mi_cols + 15) >> 4, (mi_rows + 15) >> 4

    def log2(blk, target):
        k = 0
        while (blk << k) < target:
            k += 1
        return k

    min_cols = log2(64, sb_cols)
    max_cols = log2(1, min(sb_cols, 64))
    max_rows = log2(1, min(sb_rows, 64))
    min_log2 = max(min_cols, log2((4096 * 2304) >> 12, sb_rows * sb_cols))
    w.f(1, 1)  # uniform_tile_spacing_flag
    k = min_cols
    while k < max_cols:
        more = int(k < h.tile_cols_log2)
        w.f(1, more)
        if not more:
            break
        k += 1
    k = max(min_log2 - h.tile_cols_log2, 0)
    while k < max_rows:
        more = int(k < h.tile_rows_log2)
        w.f(1, more)
        if not more:
            break
        k += 1
    if h.tile_cols_log2 or h.tile_rows_log2:
        w.f(h.tile_cols_log2 + h.tile_rows_log2, 0)
        w.f(2, h.tile_size_bytes - 1)
    w.f(8, h.base_q)

    def delta(v):
        w.f(1, int(v != 0))
        if v:
            w.su(7, v)

    delta(h.dq[0])
    if not s.mono:
        diff = int(h.dq[1:3] != h.dq[3:5])
        if s.separate_uv_delta_q:
            w.f(1, diff)
        delta(h.dq[1])
        delta(h.dq[2])
        if diff:
            delta(h.dq[3])
            delta(h.dq[4])
    w.f(1, h.using_qm)
    if h.using_qm:
        w.f(4, h.qm[0])
        w.f(4, h.qm[1])
        if s.separate_uv_delta_q:
            w.f(4, h.qm[2])
    from multiposenet_tpu_torch.utils import av1, avif

    segmented = int(h.segmentation or "segmentation" in extra)
    w.f(1, segmented)
    qindex = [h.base_q] * 8
    if segmented:
        for i in range(8):
            for j in range(8):
                on = h.seg_mask[i] >> j & 1
                w.f(1, on)
                if not on:
                    continue
                v = h.seg_data[i][j]
                if avif.SEG_SIGNED[j]:
                    w.su(1 + avif.SEG_BITS[j], v)
                else:
                    w.f(avif.SEG_BITS[j], v)
                if j == av1.SEG_LVL_ALT_Q:
                    qindex[i] = min(max(h.base_q + v, 0), 255)
    if h.base_q > 0:
        w.f(1, h.delta_q_present)
        if h.delta_q_present:
            w.f(2, h.delta_q_res)
    if h.delta_q_present and not intrabc:
        w.f(1, h.delta_lf_present)
        if h.delta_lf_present:
            w.f(2, h.delta_lf_res)
            w.f(1, h.delta_lf_multi)
    lossless = all(q == 0 for q in qindex[:8 if segmented else 1]) \
        and not any(h.dq)
    if not (lossless or intrabc):
        w.f(6, h.lf_level[0])
        w.f(6, h.lf_level[1])
        if not s.mono and (h.lf_level[0] or h.lf_level[1]):
            w.f(6, h.lf_level[2])
            w.f(6, h.lf_level[3])
        w.f(3, h.lf_sharpness)
        w.f(1, h.lf_delta_enabled)
        if h.lf_delta_enabled:
            w.f(1, 0)  # loop_filter_delta_update
    if s.cdef and not (lossless or intrabc):
        w.f(2, h.cdef_damping - 3)
        w.f(2, h.cdef_bits)
        for (yp, ys), (up, us) in zip(h.cdef_y, h.cdef_uv):
            w.f(4, yp)
            w.f(2, ys - (ys == 4))
            if not s.mono:
                w.f(4, up)
                w.f(2, us - (us == 4))
    if s.restoration and not (lossless or intrabc):
        types = list(h.lr_type)
        if "restoration" in extra:
            types[0] = 3  # RESTORE_SWITCHABLE
        for plane in range(1 if s.mono else 3):
            w.f(2, (0, 2, 3, 1)[types[plane]])  # lr_type's bits
        if any(types):
            size = h.lr_unit_size[0]
            if s.sb128:
                w.f(1, int(size > 128))
            else:
                w.f(1, int(size > 64))
                if size > 64:
                    w.f(1, int(size > 128))
            if not s.mono and s.ssx and s.ssy and any(types[1:]):
                w.f(1, int(h.lr_unit_size[1] < size))
    if not lossless:
        w.f(1, h.tx_mode_select)
    w.f(1, h.reduced_tx_set)
    if s.film_grain:
        grain = h.grain or (avif.FilmGrain() if "film_grain" in extra
                            else None)
        w.f(1, int(grain is not None))
        if grain is not None:
            film_grain_params(w, s, grain)
    return w.aligned()


def film_grain_params(w: BitWriter, s, g) -> None:
    """film_grain_params after apply_grain 1 of a shown key frame, for an
    `avif.FilmGrain` `g` (its points written as given: the counts in 4
    bits, whatever libaom's limits)."""
    w.f(16, g.seed)

    def points(pts):
        w.f(4, len(pts))
        for x, y in pts:
            w.f(8, x)
            w.f(8, y)

    points(g.y_points)
    if not s.mono:
        w.f(1, g.chroma_scaling_from_luma)
    if not (s.mono or g.chroma_scaling_from_luma
            or (s.ssx and s.ssy and not g.y_points)):
        points(g.cb_points)
        points(g.cr_points)
    w.f(2, g.scaling_shift - 8)
    w.f(2, g.ar_coeff_lag)
    n = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1)
    if g.y_points:
        for v in g.ar_y[:n]:
            w.f(8, v + 128)
    n_chroma = n + (1 if g.y_points else 0)
    if g.cb_points or g.chroma_scaling_from_luma:
        for v in g.ar_cb[:n_chroma]:
            w.f(8, v + 128)
    if g.cr_points or g.chroma_scaling_from_luma:
        for v in g.ar_cr[:n_chroma]:
            w.f(8, v + 128)
    w.f(2, g.ar_coeff_shift - 6)
    w.f(2, g.grain_scale_shift)
    if g.cb_points:
        w.f(8, g.cb_mult + 128)
        w.f(8, g.cb_luma_mult + 128)
        w.f(9, g.cb_offset + 256)
    if g.cr_points:
        w.f(8, g.cr_mult + 128)
        w.f(8, g.cr_luma_mult + 128)
        w.f(9, g.cr_offset + 256)
    w.f(1, g.overlap)
    w.f(1, g.clip_to_restricted_range)


def rewrite_frame(obus: bytes, seq_changes: dict | None = None,
                  frame_changes: dict | None = None, extra=None) -> bytes:
    """An AV1 stream of a cv2-written item rewritten: a temporal
    delimiter, its sequence header with `seq_changes` (fields of
    `avif.SequenceHeader`) and its frame, as one frame OBU whose header
    carries `frame_changes` and `extra` (see `frame_header`) before the
    original tile data."""
    import dataclasses

    from multiposenet_tpu_torch.utils import avif

    seq = frame = None
    for kind, payload in avif.read_obus(obus):
        if kind == avif.OBU_SEQUENCE_HEADER:
            seq = avif.parse_sequence_header(payload)
        elif kind == avif.OBU_FRAME:
            frame = payload
    h = avif.parse_frame_header(frame, seq)
    tiles = frame[h.header_bytes:]
    seq2 = dataclasses.replace(seq, **(seq_changes or {}))
    h2 = dataclasses.replace(h, **(frame_changes or {}))
    return (obu(avif.OBU_TEMPORAL_DELIMITER, b"")
            + obu(avif.OBU_SEQUENCE_HEADER, sequence_header(seq2))
            + obu(avif.OBU_FRAME, frame_header(seq2, h2, extra) + tiles))


# --- re-coded tiles ----------------------------------------------------------


class SymbolEncoder:
    """libaom's od_ec_enc (the precarry form of entenc.c): symbols of
    inverse CDFs and booleans in, the tile's bytes out (od_ec_enc_done's,
    which end in the trailing bits the decoder checks)."""

    def __init__(self):
        self.low, self.rng, self.cnt = 0, 0x8000, -9
        self.precarry: list[int] = []

    def _normalize(self, low: int, rng: int) -> None:
        d = 16 - rng.bit_length()
        c = self.cnt
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.precarry.append(low >> c)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append(low >> c)
            s = c + d - 24
            low &= m
        self.low, self.rng, self.cnt = low << d, rng << d, s

    def symbol(self, icdf, s: int, nsyms: int) -> None:
        fl = icdf[s - 1] if s > 0 else 32768
        fh = icdf[s]
        r, n = self.rng, nsyms - 1
        if fl < 32768:
            u = ((r >> 8) * (fl >> 6) >> 1) + 4 * (n - (s - 1))
            v = ((r >> 8) * (fh >> 6) >> 1) + 4 * (n - s)
            self._normalize(self.low + r - u, u - v)
        else:
            self._normalize(self.low,
                            r - (((r >> 8) * (fh >> 6) >> 1) + 4 * (n - s)))

    def bool(self, val: int, f: int) -> None:
        r = self.rng
        v = ((r >> 8) * (f >> 6) >> 1) + 4
        self._normalize(self.low + (r - v if val else 0),
                        v if val else r - v)

    def done(self) -> bytes:
        c, m = self.cnt, 0x3FFF
        e = ((self.low + m) & ~m) | (m + 1)
        s = c + 10
        buf = list(self.precarry)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while s > 0:
                buf.append(e >> (c + 16))
                e &= n
                s -= 8
                c -= 8
                n >>= 8
        out = bytearray(len(buf))
        carry = 0
        for i in range(len(buf) - 1, -1, -1):
            carry += buf[i]
            out[i] = carry & 0xFF
            carry >>= 8
        return bytes(out)


def _recorded_symbols(frame) -> tuple[list[int], list[tuple]]:
    """Every symbol and boolean the plain decoder reads from a frame's
    single tile, in order, and for each block (mi_row, mi_col, the index
    of its skip flag, and the indices its residual's symbols start and
    end at)."""
    from multiposenet_tpu_torch.utils import av1

    values: list[int] = []
    blocks: list[list] = []

    class Recorder(av1.SymbolDecoder):
        def decode_cdf(self, icdf, nsyms):
            values.append(super().decode_cdf(icdf, nsyms))
            return values[-1]

        def bool(self, f):
            values.append(super().bool(f))
            return values[-1]

    def mode_info(t):
        blocks.append([t.mi_row, t.mi_col, len(values), 0, 0])
        real["_mode_info"](t)

    def residual(t):
        blocks[-1][3] = len(values)
        real["_residual"](t)
        blocks[-1][4] = len(values)

    real = {"SymbolDecoder": av1.SymbolDecoder, "_mode_info": av1._mode_info,
            "_residual": av1._residual}
    av1.SymbolDecoder, av1._mode_info, av1._residual = Recorder, mode_info, \
        residual
    try:
        av1.decode_planes_plain(frame, cdef=False)
    finally:
        for k, v in real.items():
            setattr(av1, k, v)
    return values, [tuple(b) for b in blocks]


def recode_segmented(obus: bytes, frame_changes: dict, segment_of=None,
                     skip_segment=None, skip_block=None,
                     seq_changes: dict | None = None) -> bytes:
    """A coded-lossless still's stream (a temporal delimiter, its sequence
    header and one frame OBU of one tile) re-coded as a frame that is not
    lossless but whose blocks all lie in lossless segments: its header
    with `frame_changes` (fields of `avif.FrameHeader`: base_q above 0,
    segmentation with SEG_LVL_ALT_Q taking each used segment's qindex to
    0, loop filter and CDEF strengths, ...), `seq_changes` edit its
    sequence header (enable_cdef, say, which a lossless frame never
    reads). Its tile's symbols are the original's, with each block's
    segment id coded where the new header reads one: `segment_of(mi_row,
    mi_col)` (default 0; an id past LastActiveSegId ends the tile there,
    as libaom stops at it). Blocks for which `skip_block(mi_row, mi_col)`
    holds become skipped blocks (their residual's symbols dropped): with
    `skip_segment` (a segment with SEG_LVL_SKIP, SegIdPreSkip set) they
    take that segment and their skip flag goes, else their flag is 1 and
    they take the predicted id. Lossless blocks parse alike in both
    frames (4x4 transforms, no transform type at qindex 0), and a
    block's symbols do not depend on its neighbours' residual, so the
    rest of the symbols carry over (each coded with the new frame's
    adapted CDFs); base_q at or under 20 keeps the coefficient CDFs."""
    import dataclasses

    from multiposenet_tpu_torch.utils import av1, avif

    frame = avif.read_frame(obus)
    assert frame.header.lossless and len(frame.tiles) == 1
    values, blocks = _recorded_symbols(frame)
    seg_of = segment_of or (lambda r, c: 0)
    dropped = [False] * len(values)
    forced = []
    for r, c, skip_at, res0, res1 in blocks:
        force = bool(skip_block and skip_block(r, c))
        forced.append(force)
        if force:
            values[skip_at] = 1
            dropped[res0:res1] = [True] * (res1 - res0)
            if skip_segment is not None:
                dropped[skip_at] = True
    seq = None
    for kind, payload in avif.read_obus(obus):
        if kind == avif.OBU_SEQUENCE_HEADER:
            seq = dataclasses.replace(avif.parse_sequence_header(payload),
                                      **(seq_changes or {}))
    h2 = dataclasses.replace(frame.header, **frame_changes)
    header = frame_header(seq, h2)
    new = avif.read_frame(obu(avif.OBU_TEMPORAL_DELIMITER, b"")
                          + obu(avif.OBU_SEQUENCE_HEADER,
                                sequence_header(seq))
                          + obu(avif.OBU_FRAME, header + b"\0"))
    assert not new.header.lossless
    enc = SymbolEncoder()
    state = {"at": 0, "seg": [], "block": -1}

    def take():
        while dropped[state["at"]]:
            state["at"] += 1
        state["at"] += 1
        return values[state["at"] - 1]

    class Replayer(av1.SymbolDecoder):
        def __init__(self, data, allow_update):
            self.allow_update = allow_update

        def decode_cdf(self, icdf, nsyms):
            if any(icdf is c for c in state["seg"]):
                return self._segment(icdf, nsyms)
            v = take()
            enc.symbol(icdf, v, nsyms)
            return v

        def _segment(self, icdf, nsyms):
            t = state["tile"]
            r, c = t.mi_row, t.mi_col
            want = skip_segment if forced[state["block"]] and \
                skip_segment is not None else seg_of(r, c)
            pred = av1.segment_prediction(t)[1]
            most = h2.seg_last_active + 1
            coded = next(k for k in range(8)
                         if av1.neg_deinterleave(k, pred, most) == want)
            enc.symbol(icdf, coded, nsyms)
            return coded

        def bool(self, f):
            v = take()
            enc.bool(v, f)
            return v

        def overflowed(self):
            return False

        def trailing_bits_ok(self):
            return True

    def init(base_q):
        c = real["init_cdfs"](base_q)
        state["seg"] = c["spatial_seg"]
        return c

    def mode_info(t):
        state["tile"] = t
        state["block"] += 1
        real["_mode_info"](t)

    real = {"SymbolDecoder": av1.SymbolDecoder, "init_cdfs": av1.init_cdfs,
            "_mode_info": av1._mode_info}
    av1.SymbolDecoder, av1.init_cdfs, av1._mode_info = Replayer, init, \
        mode_info
    try:
        av1.decode_planes_plain(new, cdef=False)
        assert all(dropped[state["at"]:])
    except ValueError:  # a segment id past the last active: cut there
        pass
    finally:
        for k, v in real.items():
            setattr(av1, k, v)
    return (obu(avif.OBU_TEMPORAL_DELIMITER, b"")
            + obu(avif.OBU_SEQUENCE_HEADER, sequence_header(seq))
            + obu(avif.OBU_FRAME, header + enc.done()))


# --- libaom's stage functions ------------------------------------------------


def libaom_address(name: str) -> int:
    """The address in this process of a `.symtab` symbol of the wheel's
    libaom (local symbols included; the first where there are several)."""
    lib = library()
    elf = _elf()
    base = ctypes.cast(lib.aom_codec_av1_dx, ctypes.c_void_p).value \
        - elf.symbol("aom_codec_av1_dx")[0]
    return base + sorted(elf.symbols[name])[0][0]


def libaom_function(name: str, restype, *argtypes):
    """A C function of the wheel's libaom by its `.symtab` name (local
    symbols included: the C reference versions of the transforms and
    filters), callable once its run-time dispatch tables are set up (a
    decoder has been created)."""
    _elf().symbol(name)  # one definition
    return ctypes.CFUNCTYPE(restype, *argtypes)(libaom_address(name))


_elf_cache = {}


def _elf(path: str | None = None):
    from multiposenet_tpu_torch.tools.av1_tables import Elf

    path = path or LIBAOM
    if path not in _elf_cache:
        _elf_cache[path] = Elf(path)
    return _elf_cache[path]


def libavif_table(name: str) -> bytes:
    """The bytes of a `.symtab` data symbol of the wheel's libavif (its
    constant tables, and libyuv's, which it carries)."""
    elf = _elf(LIBAVIF)
    return elf.bytes_at(*elf.symbol(name))


def libavif_function(name: str, restype, *argtypes):
    """A C function of the wheel's libavif by its `.symtab` name (local
    symbols included), at its address in this process."""
    return ctypes.CFUNCTYPE(restype, *argtypes)(libavif_address(name))


def libavif_address(name: str) -> int:
    """The address in this process of a libavif `.symtab` symbol."""
    lib, elf = libavif(), _elf(LIBAVIF)
    return ctypes.cast(lib.avifImageYUVToRGB, ctypes.c_void_p).value \
        - elf.symbol("avifImageYUVToRGB")[0] + elf.symbol(name)[0]


def pillow_avif(pixels: np.ndarray, quality: int, speed: int,
                subsampling: str = "4:2:0", **advanced) -> bytes:
    """The bytes Pillow's AVIF writer (libavif 1.3.0 over its own aom,
    in `pillow.libs`) writes for uint8 RGB, RGBA or gray pixels, at
    other encoder settings than cv2's: its `subsampling` ("4:2:0",
    "4:2:2" or "4:4:4") and aom options (`advanced`, e.g.
    tune-content="screen": screen content tools on any image)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "AVIF", quality=quality, speed=speed,
                                 subsampling=subsampling,
                                 advanced=advanced or None)
    return buf.getvalue()


# Boxes whose payload is child boxes after a header of this many bytes.
_CONTAINERS = {b"moov": 0, b"trak": 0, b"mdia": 0, b"minf": 0, b"stbl": 0,
               b"meta": 4, b"stsd": 8, b"av01": 78, b"dinf": 0, b"edts": 0}


def box_edit(data: bytes, path, fn, every: bool = False) -> bytes:
    """`data` with the payload of the first box at `path` (box types from
    the top level down; with `every`, each such box) replaced by
    fn(payload), its ancestors' sizes fixed. Offsets into the data that
    moves are not fixed (`shift_chunk_offsets`)."""
    found = []

    def walk(buf: bytes, skip: int, kinds) -> bytes:
        out, pos = buf[:skip], skip
        while pos < len(buf):
            size = int.from_bytes(buf[pos:pos + 4], "big")
            kind = buf[pos + 4:pos + 8]
            box = buf[pos:pos + size]
            if kind == kinds[0] and (every or not found):
                payload = box[8:]
                if len(kinds) == 1:
                    found.append(kind)
                    box = _box(kind, fn(payload))
                else:
                    box = _box(kind, walk(payload, _CONTAINERS[kind],
                                          kinds[1:]))
            out += box
            pos += size
        return out

    out = walk(data, 0, list(path))
    if not found:
        raise KeyError(path[-1])
    return out


def shift_chunk_offsets(data: bytes, delta: int, start: int) -> bytes:
    """`data` with every stco/co64 chunk offset (of every track) at or
    past `start` moved by `delta`."""
    def fix(kind):
        def fn(payload):
            n = int.from_bytes(payload[4:8], "big")
            w = 8 if kind == b"co64" else 4
            out = bytearray(payload)
            for i in range(n):
                at = 8 + w * i
                v = int.from_bytes(payload[at:at + w], "big")
                if v >= start:
                    out[at:at + w] = (v + delta).to_bytes(w, "big")
            return bytes(out)
        return fn

    for kind in (b"stco", b"co64"):
        try:
            data = box_edit(data, (b"moov", b"trak", b"mdia", b"minf",
                                   b"stbl", kind), fix(kind), every=True)
        except KeyError:
            pass
    return data


def avis_meta(data: bytes, edit=None) -> bytes:
    """An image sequence whose file-level `meta` is rewritten with every
    item's data in its `idat` (after `edit(parts)` on `heif_parts`), the
    chunk offsets moved with the data behind it."""
    parts = heif_parts(data)
    for it in parts["items"]:
        it["idat"] = True
    if edit is not None:
        edit(parts)
    whole = heif_write(parts)
    top = _children(whole, 0, len(whole))
    new_meta = _box(b"meta", dict(top)[b"meta"])
    pos, out = 0, b""
    delta = start = None
    while pos < len(data):
        size = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"meta":
            out += new_meta
            delta, start = len(new_meta) - size, pos + size
        else:
            out += data[pos:pos + size]
        pos += size
    return shift_chunk_offsets(out, delta, start)


def avis_track_edit(data: bytes, path, fn) -> bytes:
    """An image sequence (its items first moved into `idat` by
    `avis_meta`) with the payload of the box at `path` under
    moov/trak rewritten by `fn`, the chunk offsets fixed."""
    data = avis_meta(data)
    moov_at = data.index(b"moov") - 4
    new = box_edit(data, (b"moov", b"trak", *path), fn)
    delta = len(new) - len(data)
    return shift_chunk_offsets(new, delta, moov_at + 8)


def to_co64(data: bytes) -> bytes:
    """An image sequence with its tracks' `stco` boxes written as
    `co64`."""
    data = avis_meta(data)
    path = (b"moov", b"trak", b"mdia", b"minf", b"stbl")
    stbl = [data]

    def fn(payload):
        out, pos = b"", 0
        while pos < len(payload):
            size = int.from_bytes(payload[pos:pos + 4], "big")
            kind = payload[pos + 4:pos + 8]
            body = payload[pos + 8:pos + size]
            if kind == b"stco":
                n = int.from_bytes(body[4:8], "big")
                offs = [int.from_bytes(body[8 + 4 * i:12 + 4 * i], "big")
                        for i in range(n)]
                stbl.append(offs)
                body = body[:8] + b"".join(o.to_bytes(8, "big") for o in offs)
                kind = b"co64"
            out += _box(kind, body)
            pos += size
        return out

    new = box_edit(data, path, fn, every=True)
    delta = len(new) - len(data)
    return shift_chunk_offsets(new, delta, data.index(b"moov") + 4)


def pillow_avis(frames, quality: int = 75, speed: int = 8,
                subsampling: str = "4:2:0") -> bytes:
    """The image sequence (brand avis) Pillow's AVIF writer makes of
    uint8 RGB or RGBA frames (`save_all=True`). (Pillow's Exif path
    crashes in a process that has loaded cv2's libavif: write Exif with
    `avif_encode` instead.)"""
    import io

    from PIL import Image

    buf = io.BytesIO()
    images = [Image.fromarray(f) for f in frames]
    images[0].save(buf, "AVIF", save_all=True, append_images=images[1:],
                   quality=quality, speed=speed, subsampling=subsampling,
                   duration=100)
    return buf.getvalue()
