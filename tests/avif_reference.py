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


def aom_planes(obus: bytes, skip_loop_filter: bool = False):
    """(Y, U, V) as libaom decodes the OBU stream `obus`; U, V None for a
    monochrome stream. With `skip_loop_filter`, control 267 is set first:
    the planes before CDEF."""
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
                alpha: np.ndarray | None = None, **options) -> bytes:
    """The AVIF file the wheel's libavif 1.4.2 encoder (over its libaom
    3.14.1, as cv2.imwrite calls it) writes for the given planes (Y, U,
    V; U and V None for 4:0:0) of `depth` bits in `yuv_format`, with the
    colour description given in its `colr` box and sequence header, and
    an alpha item where `alpha` is given; `options` are aom's
    (`enable_cdef="1"`: underscores for dashes)."""
    lib = libavif()
    img = _avif_image(planes, depth, yuv_format, matrix, full_range,
                      primaries, transfer, alpha)
    enc = lib.avifEncoderCreate()
    out = (ctypes.c_void_p * 2)()
    try:
        _at(enc, _ENC_SPEED, ctypes.c_int).value = speed
        _at(enc, _ENC_QUALITY, ctypes.c_int).value = quality
        for key, value in options.items():
            assert lib.avifEncoderSetCodecSpecificOption(
                enc, key.replace("_", "-").encode(), str(value).encode()) == 0
        rc = lib.avifEncoderWrite(enc, img, out)
        if rc:
            raise RuntimeError(f"avifEncoderWrite: {rc}")
        return ctypes.string_at(out[0], out[1])
    finally:
        lib.avifRWDataFree(out)
        lib.avifEncoderDestroy(enc)
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
    (uniform tiles; a lossless frame when its base_q and dq are 0, with
    no loop filter, CDEF, restoration or tx mode fields). `extra` names
    tools to signal: "superres", "segmentation", "film_grain" (refused
    by the port), "restoration" (switchable units on luma) and "intrabc"
    (allow_intrabc)."""
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
    w.f(1, int("segmentation" in extra))
    if "segmentation" in extra:
        return w.aligned()
    if h.base_q > 0:
        w.f(1, h.delta_q_present)
        if h.delta_q_present:
            w.f(2, h.delta_q_res)
    if h.delta_q_present and not intrabc:
        w.f(1, h.delta_lf_present)
        if h.delta_lf_present:
            w.f(2, h.delta_lf_res)
            w.f(1, h.delta_lf_multi)
    lossless = h.base_q == 0 and not any(h.dq)
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
        w.f(1, int("film_grain" in extra))
    return w.aligned()


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
