"""AVIF files of 10 and 12 bits a sample, as cv2.imencode(".avif") writes
them from uint16 pixels with IMWRITE_AVIF_DEPTH (profile 0 at 10 bits:
4:2:0 and monochrome; profile 1 at 10 bits: lossless 4:4:4; profile 2 at
12 bits: all three), read as cv2.imdecode(..., IMREAD_COLOR) reads them
into 8-bit BGR. Each file decodes in the host C library `csrc/av1.c` to
libaom 3.14.1's own Y, U and V planes (uint16, libaom over ctypes,
`tests/avif_reference.py`), through `decode_image` to cv2's pixels
reversed to RGB, and the plain decoder (`utils/av1.py`) to the C
library's planes, with tolerance 0. The stages whose arithmetic follows
the depth equal libaom's high-bit-depth C functions on seeded blocks at
10 and 12 bits (the inverse transforms and the WHT, the intra predictors
and edge upsampling, chroma from luma, deblocking, the CDEF direction,
the Wiener and self-guided filters, the intra block copy filter; filter
intra, which libaom inlines, and the CDEF filter C = plain), and
`avif.yuv_to_rgb` equals libavif's avifImageYUVToRGB on seeded planes.
cv2's 12-bit files signal no loop restoration (libaom's encoder leaves
enable_restoration 0 at 12 bits): the 12-bit filters are held to libaom's
functions only.
"""

import ctypes
from pathlib import Path

import cv2
import numpy as np
import pytest

import avif_reference as ar
from multiposenet_tpu_torch.utils import av1, avif, image_io
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(ar.LIBAOM is None,
                                reason="the opencv-python wheel's libaom "
                                       "is absent")

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
PHOTO = cv2.imread(str(FIXTURES / "photo_480x640_q95_420.jpg"))[:, :, ::-1]
DEPTHS = (10, 12)


def _stat(stats, name: str) -> int:
    return int(stats[avif.STAT_NAMES.index(name)])


def _check(data: bytes, depth: int, plain: bool = True) -> np.ndarray:
    """C planes = libaom's (uint16), pixels = cv2's, and, with `plain`,
    the plain decoder's planes and pixels = C's; returns the counters."""
    image = avif.read_image(data)
    assert image.frame.seq.bit_depth == depth
    y, u, v, stats = avif.decode_planes_c(image.frame)
    for got, ref in zip((y, u, v), ar.aom_planes(ar.primary_obus(data))):
        assert (got is None) == (ref is None)
        if ref is not None:
            assert got.dtype == ref.dtype == np.uint16
            np.testing.assert_array_equal(got, ref)
    rgb = ar.imdecode_rgb(data)
    np.testing.assert_array_equal(image_io.decode_image(data), rgb)
    if plain:
        for a, b in zip((y, u, v), av1.decode_planes_plain(image.frame)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(image_io.decode_image_plain(data), rgb)
    return stats


def _pixels(h: int, w: int, channels: int, depth: int) -> np.ndarray:
    """A photo crop of `depth` bits (seeded noise in the low bits): RGB,
    gray or RGBA."""
    rgb = np.ascontiguousarray(PHOTO[100:100 + h, 200:200 + w])
    if channels == 1:
        rgb = rgb.mean(axis=2).astype(np.uint8)
    elif channels == 4:
        rng = np.random.default_rng(h * w)
        rgb = np.dstack([rgb, rng.integers(0, 256, (h, w), dtype=np.uint8)])
    return ar.widen(rgb, depth, h * 1000 + w)


# --- cv2's files -------------------------------------------------------------


@pytest.mark.parametrize("side", [1, 7, 33, 97])
@pytest.mark.parametrize("quality", [None, 0, 50, 100], ids=str)
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("depth", DEPTHS)
def test_cv2_files_equal_libaom_and_cv2(depth, channels, quality, side):
    """Gray, colour and BGRA at cv2's default quality, 0, 50 and 100
    (lossless: 4:4:4 with the identity matrix in colour), at sides 1 to
    97: the profile, depth and sampling cv2 writes, read as cv2 reads
    them. The plain decoder is held to C on sides up to 33 and, at 97,
    on colour at the default quality (about a second a file there)."""
    data = ar.imencode_avif(_pixels(side, side, channels, depth), quality,
                            None, depth)
    image = avif.read_image(data)
    seq = image.frame.seq
    assert seq.profile == (2 if depth == 12 else 1 if (
        quality == 100 and channels != 1) else 0)
    assert seq.mono == (channels == 1)
    assert image.frame.header.lossless == (quality == 100)
    if channels != 1:
        assert seq.ssx == (quality != 100)
    assert (image.alpha is not None) == (channels == 4)
    if image.alpha is not None:
        assert image.alpha.seq.bit_depth == depth
        assert image.alpha.seq.mono
    _check(data, depth, plain=side <= 33 or (channels, quality) == (3, None))


def test_lossless_gray_reads_as_cv2_narrows_it():
    """Lossless gray at 10 and 12 bits: the planes are the pixels
    written, and cv2's 8 bits are each value scaled by 2^(8 - depth),
    rounded to nearest with ties to even (values at every remainder)."""
    for depth in DEPTHS:
        gray = np.arange(64 * 64, dtype=np.uint16).reshape(64, 64) % (
            1 << depth)
        data = ar.imencode_avif(gray, 100, None, depth)
        np.testing.assert_array_equal(
            avif.decode_planes_c(avif.read_image(data).frame)[0], gray)
        got = image_io.decode_image(data)
        np.testing.assert_array_equal(got, ar.imdecode_rgb(data))
        exact = gray / (1 << (depth - 8))
        np.testing.assert_array_equal(
            got[:, :, 0], np.minimum(np.round(exact), 255).astype(np.uint8))


# (y0, x0, h, w, speed, quality): photo crops at speeds 0, 2 and 4, whose
# 10-bit files reach loop restoration (Wiener and self-guided units).
LR_CASES = [(200, 100, 64, 160, 0, 60), (200, 100, 64, 160, 2, 60),
            (0, 0, 64, 160, 2, 60), (200, 100, 96, 128, 4, 90)]


@pytest.mark.parametrize("case", LR_CASES,
                         ids=lambda c: "{}x{}-s{}-q{}".format(*c[2:]))
@pytest.mark.parametrize("depth", DEPTHS)
def test_photo_crops_at_speeds_0_to_4_equal_libaom_and_cv2(depth, case):
    """Photo crops at speeds 0, 2 and 4 (CDEF, and loop restoration at
    10 bits; the 12-bit sequence header disables restoration)."""
    y0, x0, h, w, speed, quality = case
    img = ar.widen(np.ascontiguousarray(PHOTO[y0:y0 + h, x0:x0 + w]), depth,
                   speed + 7)
    data = ar.imencode_avif(img, quality, speed, depth)
    frame = avif.read_image(data).frame
    assert frame.seq.restoration == (depth == 10)
    stats = _check(data, depth)
    assert _stat(stats, "cdef_blocks") > 0
    if any(frame.header.lr_type):
        before = avif.decode_planes_c(frame, restoration=False)[:3]
        want = ar.aom_planes(ar.primary_obus(data))
        assert any(not np.array_equal(a, b) for a, b in zip(before, want)
                   if a is not None)


def test_photo_crops_reach_wiener_and_self_guided_units_at_10_bits():
    totals = 0
    for y0, x0, h, w, speed, quality in LR_CASES:
        img = ar.widen(np.ascontiguousarray(PHOTO[y0:y0 + h, x0:x0 + w]), 10,
                       speed + 7)
        data = ar.imencode_avif(img, quality, speed, 10)
        totals = totals + avif.decode_planes_c(avif.read_image(data).frame)[3]
    assert _stat(totals, "lr_wiener") > 0
    assert _stat(totals, "lr_sgrproj") > 0


@pytest.mark.parametrize("depth", DEPTHS)
def test_drawing_at_speed_6_reaches_palette_and_intra_block_copy(depth):
    """Flat shapes and text at speed 6, each colour's bits repeated into
    the low ones: screen content with palette blocks (colours of `depth`
    bits, deltas of depth - 3 bits and more, V modulo 2^depth) and intra
    block copy (whole and half-sample copies)."""
    img = ar.widen(ar.drawing(200, 300, 0)[:, :, ::-1].copy(), depth)
    data = ar.imencode_avif(img, None, 6, depth)
    header = avif.read_image(data).frame.header
    assert header.screen_content and header.allow_intrabc
    stats = _check(data, depth)
    for name in ("palette_y", "palette_uv", "intrabc_blocks",
                 "intrabc_halfpel"):
        assert _stat(stats, name) > 0, name


@pytest.mark.parametrize("depth", DEPTHS)
def test_palette_without_intra_block_copy(depth):
    """A drawing at speed 4 of 6 colours: palette blocks whose colours
    come from the neighbours' cache and from the stream at `depth`
    bits."""
    img = ar.widen(ar.drawing(64, 96, 5)[:, :, ::-1].copy(), depth)
    data = ar.imencode_avif(img, 40, 4, depth)
    stats = _check(data, depth)
    assert _stat(stats, "palette_y") + _stat(stats, "palette_uv") > 0


# --- libavif's YUV to RGB ----------------------------------------------------


@pytest.mark.parametrize("layout", ["420", "420_alpha", "444", "444_alpha"])
@pytest.mark.parametrize("depth", (8,) + DEPTHS)
def test_yuv_to_rgb_equals_libavif(depth, layout):
    """avif.yuv_to_rgb on seeded planes (every value of the depth
    reached) = libavif's avifImageYUVToRGB into the 8-bit BGR or, with
    an alpha plane, BGRA image cv2 reads: 4:2:0 at matrix 6 (libyuv,
    after the planes are narrowed to 8 bits for BGR; I010ToARGBMatrix-
    Filter or I012ToARGBMatrix for BGRA) and 4:4:4 at the identity
    matrix (libavif's own float path), at odd and even sides."""
    rng = np.random.default_rng(depth * 10 + len(layout))
    top = 1 << depth
    dtype = np.uint8 if depth == 8 else np.uint16
    sub = layout.startswith("420")
    for h, w in ((1, 1), (2, 3), (9, 11), (33, 17), (64, 80)):
        ch, cw = ((h + 1) // 2, (w + 1) // 2) if sub else (h, w)
        y = rng.integers(0, top, (h, w)).astype(dtype)
        u, v = (rng.integers(0, top, (ch, cw)).astype(dtype)
                for _ in range(2))
        alpha = rng.integers(0, top, (h, w)).astype(dtype) \
            if layout.endswith("alpha") else None
        matrix = 6 if sub else 0
        want = ar.avif_yuv_to_rgb([y, u, v], depth,
                                  ar.YUV420 if sub else ar.YUV444, matrix,
                                  alpha)
        got = avif.yuv_to_rgb(y, u, v, matrix, 1, (1, 1) if sub else (0, 0),
                              depth, alpha is not None)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")


# --- stages at 10 and 12 bits ------------------------------------------------


@pytest.fixture(scope="module")
def lib():
    """The C library with the high-bit-depth stages' signatures, once
    libaom's dispatch tables are set (a decoder has been created)."""
    ar.aom_planes(ar.primary_obus(
        (FIXTURES / "avif_odd_33x17.avif").read_bytes()))
    lib = avif.library()
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.av1_inverse_transform_add_hbd.argtypes = [vp, i, i, vp, i, i]
    lib.av1_iwht4x4_add_hbd.argtypes = [vp, vp, i, i]
    lib.av1_edge_upsample_hbd.argtypes = [vp, i, i]
    lib.av1_dr_predict_hbd.argtypes = [vp, i, i, i, vp, vp, i, i, i]
    lib.av1_filter_intra_predict_hbd.argtypes = [vp, i, i, i, vp, vp, i, i]
    lib.av1_nondir_predict_hbd.argtypes = [vp, i, i, i, vp, vp, i, i, i, i]
    lib.av1_cfl_predict_ss_hbd.argtypes = [vp, i, vp] + [i] * 9
    lib.av1_lf_line_hbd.argtypes = [vp] + [i] * 6
    lib.av1_cdef_find_dir_hbd.argtypes = [vp, i, vp, i]
    lib.av1_cdef_block_hbd.argtypes = [vp] + [i] * 11 + [vp, i, i]
    lib.av1_wiener_filter_hbd.argtypes = [vp, i, i, i, vp, vp, vp, i, i]
    lib.av1_sgr_filter_hbd.argtypes = [vp] + [i] * 6 + [vp, i, i]
    lib.av1_intrabc_predict_hbd.argtypes = [vp] + [i] * 5 + [vp, i]
    return lib


def _short(a: np.ndarray) -> int:
    """libaom's CONVERT_TO_BYTEPTR of a uint16 array."""
    return a.ctypes.data >> 1


TX_NAMES = ("4x4", "8x8", "16x16", "32x32", "64x64", "4x8", "8x4", "8x16",
            "16x8", "16x32", "32x16", "32x64", "64x32", "4x16", "16x4",
            "8x32", "32x8", "16x64", "64x16")


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("tx", range(19), ids=TX_NAMES)
def test_inverse_transforms_at_depth(tx, depth, lib):
    """Every transform type a size allows, on sparse and dense seeded
    coefficients up to the depth's clamps (rows bd + 8 bits, columns
    max(bd + 6, 16)): C = plain = av1_inv_txfm2d_add_<size>_c at bd.
    Where a 4-point ADST runs, the coefficients stay within 2^(bd + 4):
    libaom's av1_iadst4 multiplies in int32, which larger ones overflow
    (no encoder writes them)."""
    w, h = map(int, TX_NAMES[tx].split("x"))
    ref = ar.libaom_function(f"av1_inv_txfm2d_add_{TX_NAMES[tx]}_c", None,
                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int)
    cw, ch = min(w, 32), min(h, 32)
    types = [0] if max(w, h) == 64 else [0, 9] if max(w, h) == 32 \
        else list(range(16))
    rng = np.random.default_rng(tx * 100 + depth)
    top = 1 << (depth + 7)
    for tx_type in types:
        adst4 = (w == 4 and av1.TX_HORZ[tx_type] in (1, 2)) or (
            h == 4 and av1.TX_VERT[tx_type] in (1, 2))
        for amp in (60 << (depth - 8), top // 16,
                    top // 8 if adst4 else top + 5000):
            coef = np.zeros(cw * ch, np.int32)
            k = int(rng.integers(1, min(cw * ch, 24) + 1))
            coef[rng.choice(cw * ch, k, replace=False)] = np.clip(
                rng.integers(-amp, amp + 1, k), -top, top - 1)
            dst = rng.integers(0, 1 << depth, (h, w)).astype(np.uint16)
            want = dst.copy()
            ref(coef.ctypes.data, want.ctypes.data, w, tx_type, depth)
            got = dst.copy()
            lib.av1_inverse_transform_add_hbd(coef.ctypes.data, tx, tx_type,
                                              got.ctypes.data, w, depth)
            plain = dst.copy()
            av1.inverse_transform_add(coef, tx, tx_type, plain, depth)
            np.testing.assert_array_equal(got, want, err_msg=str(tx_type))
            np.testing.assert_array_equal(plain, got, err_msg=str(tx_type))


@pytest.mark.parametrize("depth", DEPTHS)
def test_inverse_wht_at_depth(depth, lib):
    """The lossless transform (C = plain = av1_highbd_iwht4x4_16_add_c)."""
    wht = ar.libaom_function("av1_highbd_iwht4x4_16_add_c", None,
                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int)
    rng = np.random.default_rng(depth)
    for trial in range(60):
        coef = np.zeros(16, np.int32)
        k = int(rng.integers(1, 17))
        amp = (8, 400, 8000)[trial % 3] << (depth - 8)
        coef[rng.choice(16, k, replace=False)] = 4 * rng.integers(
            -amp, amp + 1, k)
        dst = rng.integers(0, 1 << depth, (4, 4)).astype(np.uint16)
        want = dst.copy()
        wht(coef.ctypes.data, _short(want), 4, depth)
        got = dst.copy()
        lib.av1_iwht4x4_add_hbd(coef.ctypes.data, got.ctypes.data, 4, depth)
        plain = dst.copy()
        av1.iwht_add(coef, plain, depth)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(plain, got)


class _Edges:
    """An intra edge as uint16 for libaom (index 0 at entry 16) and int32
    for csrc/av1.c, and the plain decoder's view."""

    def __init__(self, values: np.ndarray):
        self.u16 = np.zeros(len(values) + 48, np.uint16)
        self.u16[16:16 + len(values)] = values
        self.i32 = self.u16.astype(np.int32)

    def ptr(self, kind: str = "u16"):
        arr = self.u16 if kind == "u16" else self.i32
        return arr.ctypes.data + 16 * arr.itemsize

    def plain(self):
        edge = av1._Edge(len(self.i32))
        edge.a[:len(self.i32)] = self.i32.tolist()
        return edge


def _edge(rng, n: int, depth: int, smooth: bool) -> np.ndarray:
    top = (1 << depth) - 1
    if smooth:
        return np.clip(rng.integers(0, top + 1) + np.cumsum(
            rng.integers(-6 << (depth - 8), 7 << (depth - 8), n)), 0, top)
    return rng.integers(0, top + 1, n)


@pytest.mark.parametrize("depth", DEPTHS)
def test_intra_edge_upsampling_at_depth(depth, lib):
    """The 2x upsampling clipped to the depth (C = plain =
    av1_highbd_upsample_intra_edge_c)."""
    up = ar.libaom_function("av1_highbd_upsample_intra_edge_c", None,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int)
    rng = np.random.default_rng(depth + 1)
    for trial in range(40):
        n = int(rng.integers(1, 17))
        e = _Edges(_edge(rng, n, depth, trial % 2 == 0))
        e.u16[15] = e.i32[15] = int(rng.integers(0, 1 << depth))
        plain = e.plain()
        up(e.ptr(), n, depth)
        lib.av1_edge_upsample_hbd(e.ptr("i32"), n, depth)
        av1.edge_upsample(plain, n, depth)
        np.testing.assert_array_equal(e.u16, e.i32)
        np.testing.assert_array_equal(e.i32, plain.a[:len(e.i32)])


BLOCKS = [(w, h) for w in (4, 8, 16, 32, 64) for h in (4, 8, 16, 32, 64)
          if max(w, h) <= 4 * min(w, h)]
ANGLES = (42, 45, 67, 87, 93, 113, 135, 157, 177, 183, 203, 222)


@pytest.mark.parametrize("depth", DEPTHS)
def test_directional_prediction_at_depth(depth, lib):
    """Zones 1-3 at every block shape, with and without upsampled edges
    (C = plain = av1_highbd_dr_prediction_z1/z2/z3_c)."""
    deriv = av1.table("dr_intra_derivative")
    args = [ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
    refs = {zone: ar.libaom_function(
        f"av1_highbd_dr_prediction_z{zone}_c", None, *args,
        *[ctypes.c_int] * (5 if zone == 2 else 4)) for zone in (1, 2, 3)}
    rng = np.random.default_rng(depth + 2)
    for angle in ANGLES:
        zone = 1 if angle < 90 else 2 if angle < 180 else 3
        dx = int(deriv[angle] if angle < 90 else deriv[180 - angle]
                 if angle < 180 else 1)
        dy = int(deriv[angle - 90] if 90 < angle < 180
                 else deriv[270 - angle] if angle > 180 else 1)
        for w, h in BLOCKS:
            up_a = int(w + h <= 16 and angle < 180 and rng.random() < 0.5)
            up_l = int(w + h <= 16 and angle > 90 and rng.random() < 0.5)
            above = _Edges(_edge(rng, 2 * (w + h) + 32, depth, True))
            left = _Edges(_edge(rng, 2 * (w + h) + 32, depth, False))
            for e in (above, left):
                e.u16[:16] = e.i32[:16] = rng.integers(0, 1 << depth, 16)
            got = np.zeros((h, w), np.uint16)
            lib.av1_dr_predict_hbd(got.ctypes.data, w, w, h,
                                   above.ptr("i32"), left.ptr("i32"), up_a,
                                   up_l, angle)
            plain = av1.dr_predict(above.plain(), left.plain(), w, h, up_a,
                                   up_l, angle)
            np.testing.assert_array_equal(got, plain, err_msg=f"{w}x{h}")
            want = np.zeros((h, w), np.uint16)
            tail = (up_a, up_l, dx, dy, depth) if zone == 2 else (
                up_a if zone == 1 else up_l, dx, dy, depth)
            refs[zone](want.ctypes.data, w, w, h, above.ptr(), left.ptr(),
                       *tail)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{angle} {w}x{h}")


@pytest.mark.parametrize("depth", DEPTHS)
def test_other_intra_modes_at_depth(depth, lib):
    """DC (each availability: 2^(depth-1) without edges), smooth, smooth
    V, smooth H and Paeth at every block shape (C = plain =
    aom_highbd_*_predictor_<w>x<h>_c); filter intra's five modes up to
    32x32, clipped to the depth (C = plain; libaom inlines its own)."""
    rng = np.random.default_rng(depth + 3)
    names = {av1.DC_PRED: ("dc", 1, 1), 100: ("dc_left", 1, 0),
             101: ("dc_top", 0, 1), 102: ("dc_128", 0, 0),
             av1.SMOOTH_PRED: ("smooth", 1, 1),
             av1.SMOOTH_V_PRED: ("smooth_v", 1, 1),
             av1.SMOOTH_H_PRED: ("smooth_h", 1, 1),
             av1.PAETH_PRED: ("paeth", 1, 1)}
    for w, h in BLOCKS:
        above = _Edges(_edge(rng, w + h + 16, depth, True))
        left = _Edges(_edge(rng, w + h + 16, depth, False))
        above.u16[15] = above.i32[15] = left.u16[15] = left.i32[15] = \
            int(rng.integers(0, 1 << depth))
        if max(w, h) <= 32:
            for mode in range(5):
                got = np.zeros((h, w), np.uint16)
                lib.av1_filter_intra_predict_hbd(
                    got.ctypes.data, w, w, h, above.ptr("i32"),
                    left.ptr("i32"), mode, depth)
                plain = av1.filter_intra_predict(above.plain(), left.plain(),
                                                 w, h, mode, depth)
                np.testing.assert_array_equal(got, plain)
        for mode, (name, have_left, have_above) in names.items():
            ref = ar.libaom_function(
                f"aom_highbd_{name}_predictor_{w}x{h}_c", None,
                ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int)
            m = av1.DC_PRED if mode >= 100 else mode
            got = np.zeros((h, w), np.uint16)
            lib.av1_nondir_predict_hbd(got.ctypes.data, w, w, h,
                                       above.ptr("i32"), left.ptr("i32"), m,
                                       have_left, have_above, depth)
            want = np.zeros((h, w), np.uint16)
            ref(want.ctypes.data, w, above.ptr(), left.ptr(), depth)
            plain = av1.nondir_predict(above.plain(), left.plain(), w, h, m,
                                       have_left, have_above, depth)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {w}x{h}")
            np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("ss", [(1, 1), (0, 0)], ids=["420", "444"])
def test_chroma_from_luma_at_depth(ss, depth, lib):
    """CFL over fully decoded luma at every alpha, clipped to the depth
    (C = plain = libaom's cfl_subsample_hbd_*, subtract-average and
    cfl_predict_hbd functions)."""
    ssx, ssy = ss
    for w, h in ((4, 4), (8, 8), (16, 16), (8, 4), (4, 16)):
        lw, lh = w << ssx, h << ssy
        kind = "420" if ssx else "444"
        sub = ar.libaom_function(f"cfl_subsample_hbd_{kind}_{lw}x{lh}_c",
                                 None, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p)
        avg = ar.libaom_function(f"cfl_subtract_average_{w}x{h}_c", None,
                                 ctypes.c_void_p, ctypes.c_void_p)
        pred = ar.libaom_function(f"cfl_predict_hbd_{w}x{h}_c", None,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int)
        rng = np.random.default_rng(w * 100 + h + depth)
        luma = rng.integers(0, 1 << depth, (lh, lw)).astype(np.uint16)
        q3 = np.zeros(32 * 32, np.uint16)
        ac = np.zeros(32 * 32, np.int16)
        sub(luma.ctypes.data, lw, q3.ctypes.data)
        avg(q3.ctypes.data, ac.ctypes.data)
        for alpha in range(-16, 17, 3):
            dc = np.full((h, w), int(rng.integers(0, 1 << depth)), np.uint16)
            got, want = dc.copy(), dc.copy()
            lib.av1_cfl_predict_ss_hbd(got.ctypes.data, w, luma.ctypes.data,
                                       lw, w, h, lw, lh, alpha, ssx, ssy,
                                       depth)
            pred(ac.ctypes.data, want.ctypes.data, w, alpha, depth)
            np.testing.assert_array_equal(got, want, err_msg=str(alpha))
            np.testing.assert_array_equal(av1.cfl_predict(
                dc, luma, lw, lh, alpha, ssx, ssy, depth), got)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("plane,size,ref_name",
                         [(0, 4, "4"), (0, 8, "8"), (0, 16, "14"),
                          (1, 4, "4"), (1, 8, "6")])
def test_deblocking_at_depth(plane, size, ref_name, depth, lib):
    """One edge's lines at every level and sharpness, the limits shifted
    by depth - 8 and the samples offset and clamped by 2^(depth-1): C =
    plain = aom_highbd_lpf_vertical_<n>_c."""
    ref = ar.libaom_function(f"aom_highbd_lpf_vertical_{ref_name}_c", None,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int)
    rng = np.random.default_rng(size + plane + depth)
    sh = depth - 8
    for trial in range(60):
        lvl, sharp = int(rng.integers(1, 64)), int(rng.integers(0, 8))
        shift = 2 if sharp > 4 else 1 if sharp > 0 else 0
        limit = min(max(lvl >> shift, 1), 9 - sharp) if sharp else \
            max(1, lvl >> shift)
        blimit, thresh = 2 * (lvl + 2) + limit, lvl >> 4
        base = int(rng.integers(0, 1 << depth))
        spread = (1, 4, 20, 90)[trial % 4] << sh
        line = np.clip(base + rng.integers(-spread, spread + 1, 16)
                       + (np.arange(16) >= 8) * (int(rng.integers(-12, 13))
                                                 << sh),
                       0, (1 << depth) - 1).astype(np.uint16)
        got = line.copy()
        lib.av1_lf_line_hbd(got.ctypes.data, plane, limit, blimit, thresh,
                            size, depth)
        plain = av1.lf_edge(line.tolist(), plane, limit, blimit, thresh,
                            size, depth)
        rows = np.tile(line, (4, 1))
        lim, bl, th = (np.array([v], np.uint8) for v in (limit, blimit,
                                                         thresh))
        ref(rows[:, 8:].ctypes.data, 16, bl.ctypes.data, lim.ctypes.data,
            th.ctypes.data, depth)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, rows[0])


@pytest.mark.parametrize("depth", DEPTHS)
def test_cdef_at_depth(depth, lib):
    """The direction search on samples shifted down by depth - 8 (C =
    plain = cdef_find_dir_c at that coeff_shift), and the filter at
    strengths and damping shifted up by it, the primary taps chosen by
    the strength shifted back (C = plain)."""
    find_dir = ar.libaom_function("cdef_find_dir_c", ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int)
    cs = depth - 8
    rng = np.random.default_rng(depth + 4)
    for trial in range(40):
        img = rng.integers(0, 1 << depth, (8, 8)).astype(np.uint16)
        if trial % 2:
            img = ((np.add.outer(np.arange(8) * rng.integers(-9, 10),
                                 np.arange(8) * rng.integers(-9, 10)) + 128)
                   << cs) + rng.integers(-3 << cs, 4 << cs, (8, 8))
            img = img.clip(0, (1 << depth) - 1).astype(np.uint16)
        var = ctypes.c_int32()
        d = lib.av1_cdef_find_dir_hbd(img.ctypes.data, 8, ctypes.byref(var),
                                      cs)
        var_ref = ctypes.c_int32()
        assert find_dir(img.ctypes.data, 8, ctypes.byref(var_ref), cs) == d
        assert var.value == var_ref.value
        assert av1.cdef_find_dir(img, cs) == (d, var.value)
    for trial in range(24):
        src = rng.integers(0, 1 << depth, (20, 20)).astype(np.uint16)
        size = 8 if trial % 3 else 4
        y0, x0 = (int(v) for v in rng.integers(0, 20 - size + 1, 2))
        pri = int(rng.integers(0, 16)) << cs
        sec = int((0, 1, 2, 4)[trial % 4]) << cs
        damping, d = int(rng.integers(2, 7)) + cs, int(rng.integers(0, 8))
        out = np.zeros((size, size), np.uint16)
        lib.av1_cdef_block_hbd(src.ctypes.data, 20, 18, 19, y0, x0, size,
                               size, pri, sec, damping, d, out.ctypes.data,
                               size, cs)
        plain = av1.cdef_block(src, y0, x0, size, size, pri, sec, damping, d,
                               (18, 19), cs)
        np.testing.assert_array_equal(out, plain)


def _taps(rng) -> list:
    c = [int(rng.integers(lo, hi + 1))
         for lo, hi in zip(av1.WIENER_MIN, av1.WIENER_MAX)]
    return [c[0], c[1], c[2], -2 * sum(c), c[2], c[1], c[0]]


@pytest.mark.parametrize("depth", DEPTHS)
def test_wiener_filter_at_depth(depth, lib):
    """Every tap within its coded range, on seeded blocks (C = plain =
    av1_highbd_wiener_convolve_add_src_c at get_conv_params_wiener(bd):
    InterRound0 and InterRound1 3 and 11 at 10 bits, 5 and 9 at 12)."""
    conv = ar.libaom_function(
        "av1_highbd_wiener_convolve_add_src_c", None, ctypes.c_void_p,
        ctypes.c_ssize_t, ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int)

    def aligned(taps):  # libaom finds the filter at a 16-byte boundary
        buf = np.zeros(32, np.int16)
        out = buf[(-buf.ctypes.data % 16) // 2:][:8]
        out[:7] = taps
        return out

    rng = np.random.default_rng(depth + 5)
    rounds = np.array([5, 9] if depth == 12 else [3, 11], np.int32)
    for trial in range(24):
        w, h = ((16, 8), (64, 64), (32, 17), (48, 5))[trial % 4]
        src = rng.integers(0, 1 << depth, (h + 7, w + 8)).astype(np.uint16)
        if trial % 2:
            src = (src >> (depth - 2) << (depth - 2)) + 20
        vf, hf = _taps(rng), _taps(rng)
        want = np.zeros((h, w), np.uint16)
        fx, fy = aligned(hf), aligned(vf)
        conv(_short(src[3:, 3:]), src.shape[1], _short(want), w,
             fx.ctypes.data, 16, fy.ctypes.data, 16, w, h,
             rounds.ctypes.data, depth)
        got = np.zeros((h, w), np.uint16)
        v32, h32 = np.array(vf, np.int32), np.array(hf, np.int32)
        assert lib.av1_wiener_filter_hbd(
            src[3:, 3:].ctypes.data, src.shape[1], w, h, v32.ctypes.data,
            h32.ctypes.data, got.ctypes.data, w, depth) == 0
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            av1.wiener_filter(src[:h + 6, :w + 6], vf, hf, depth), got)


@pytest.mark.parametrize("depth", DEPTHS)
def test_self_guided_filter_at_depth(depth, lib):
    """Every parameter set and projection on rough and flat seeded
    blocks, the box sums rounded down by the depth for the variance (C =
    plain = av1_apply_selfguided_restoration_c at bit_depth, highbd)."""
    sgr = ar.libaom_function(
        "av1_apply_selfguided_restoration_c", ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int)
    tmp = np.zeros(1 << 18, np.int32)
    params = av1.table("sgr_params")
    rng = np.random.default_rng(depth + 6)
    for trial in range(32):
        w, h = ((64, 64), (17, 9), (33, 56), (8, 1))[trial % 4]
        sgr_set = trial % 16
        src = rng.integers(0, 1 << depth, (h + 6, w + 6)).astype(np.uint16)
        if trial % 3 == 0:
            src = (src // (40 << (depth - 8)) * (40 << (depth - 8))).astype(
                np.uint16)
        xqd = np.array([int(rng.integers(-96, 32)),
                        int(rng.integers(-32, 96))], np.int32)
        if params[sgr_set][0] == 0:
            xqd[0] = 0
        if params[sgr_set][1] == 0:
            xqd[1] = min(95, max(-32, 128 - int(xqd[0])))
        want = np.zeros((h, w), np.uint16)
        assert sgr(_short(src[3:, 3:]), w, h, src.shape[1], sgr_set,
                   xqd.ctypes.data, _short(want), w, tmp.ctypes.data, depth,
                   1) == 0
        got = np.zeros((h, w), np.uint16)
        assert lib.av1_sgr_filter_hbd(
            src[3:, 3:].ctypes.data, src.shape[1], w, h, sgr_set,
            int(xqd[0]), int(xqd[1]), got.ctypes.data, w, depth) == 0
        np.testing.assert_array_equal(got, want, err_msg=str(sgr_set))
        np.testing.assert_array_equal(av1.sgr_filter(
            src, sgr_set, tuple(int(v) for v in xqd), depth), got)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("fy,fx", [(8, 8), (0, 8), (8, 0)])
def test_intra_block_copy_filter_at_depth(fy, fx, depth, lib):
    """Half-sample copies of seeded blocks (C = plain = libaom's
    av1_highbd_convolve_{2d,x,y}_sr_intrabc_c at get_conv_params_no_round
    of the depth: ROUND0_BITS 3, or 5 at 12 bits)."""

    class ConvolveParams(ctypes.Structure):
        _fields_ = [("do_average", ctypes.c_int), ("dst", ctypes.c_void_p),
                    ("dst_stride", ctypes.c_int), ("round_0", ctypes.c_int),
                    ("round_1", ctypes.c_int), ("plane", ctypes.c_int),
                    ("is_compound", ctypes.c_int),
                    ("use_dist_wtd_comp_avg", ctypes.c_int),
                    ("fwd_offset", ctypes.c_int),
                    ("bck_offset", ctypes.c_int)]

    r0 = 5 if depth == 12 else 3
    params = ConvolveParams(0, None, 0, r0, 14 - r0, 0, 0, 0, 0, 0)
    filter_params = ar.libaom_address("av1_intrabc_filter_params")
    vp, i = ctypes.c_void_p, ctypes.c_int
    if fx and fy:
        ref = ar.libaom_function("av1_highbd_convolve_2d_sr_intrabc_c", None,
                                 vp, i, vp, i, i, i, vp, vp, i, i, vp, i)
    elif fx:
        ref = ar.libaom_function("av1_highbd_convolve_x_sr_intrabc_c", None,
                                 vp, i, vp, i, i, i, vp, i, vp, i)
    else:  # the vertical filter takes no ConvolveParams
        ref = ar.libaom_function("av1_highbd_convolve_y_sr_intrabc_c", None,
                                 vp, i, vp, i, i, i, vp, i, i)
    rng = np.random.default_rng(fy * 2 + fx + depth)
    for w, h in ((4, 4), (8, 16), (32, 8), (64, 64), (16, 4)):
        src = rng.integers(0, 1 << depth, (h + 1, w + 1)).astype(np.uint16)
        want = np.zeros((h, w), np.uint16)
        if fx and fy:
            ref(src.ctypes.data, w + 1, want.ctypes.data, w, w, h,
                filter_params, filter_params, 8, 8, ctypes.byref(params),
                depth)
        elif fx:
            ref(src.ctypes.data, w + 1, want.ctypes.data, w, w, h,
                filter_params, 8, ctypes.byref(params), depth)
        else:
            ref(src.ctypes.data, w + 1, want.ctypes.data, w, w, h,
                filter_params, 8, depth)
        got = np.zeros((h, w), np.uint16)
        lib.av1_intrabc_predict_hbd(src.ctypes.data, w + 1, w, h, fy, fx,
                                    got.ctypes.data, w)
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h}")
        np.testing.assert_array_equal(av1.intrabc_predict(
            src[:h + (fy > 0), :w + (fx > 0)], fy, fx), got)
