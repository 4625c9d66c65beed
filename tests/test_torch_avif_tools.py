"""AVIF files cv2.imencode(".avif") writes with IMWRITE_AVIF_QUALITY 100
and with IMWRITE_AVIF_SPEED 0 to 8, and the AV1 tools they reach:
lossless frames (the Walsh-Hadamard transform, 4:4:4 with the identity
matrix, 128x128 superblocks at speed 0), palette (screen content),
loop restoration (Wiener, self-guided and switchable units in 64-row
stripes) and intra block copy. Each file decodes in the host C library
`csrc/av1.c` to libaom 3.14.1's own Y, U and V planes (libaom driven over
ctypes, `tests/avif_reference.py`) and through `decode_image` to
`cv2.imdecode` reversed to RGB, with tolerance 0; the plain decoder
(`utils/av1.py`) equals the C library on the smaller files. The new
stages of both sides equal libaom's C functions on seeded blocks: the
inverse WHT, the Wiener and self-guided filters, the palette colour
context, chroma from luma at 4:4:4 and the intra block copy filter.
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


def _stat(stats, name: str) -> int:
    return int(stats[avif.STAT_NAMES.index(name)])


def _check(data: bytes, plain: bool) -> np.ndarray:
    """C planes = libaom's, pixels = cv2's (C and, with `plain`, the
    plain decoder, whose planes equal C's); returns the C counters."""
    image = avif.read_image(data)
    y, u, v, stats = avif.decode_planes_c(image.frame)
    want = ar.aom_planes(ar.primary_obus(data))
    for got, ref in zip((y, u, v), want):
        assert (got is None) == (ref is None)
        if ref is not None:
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


def _pixels(h: int, w: int, channels: int) -> np.ndarray:
    rgb = np.ascontiguousarray(
        PHOTO[:h, :w] if w <= 640 else cv2.resize(PHOTO, (w, h)))
    if channels == 1:
        return rgb.mean(axis=2).astype(np.uint8)
    if channels == 4:
        rng = np.random.default_rng(h * w)
        return np.dstack([rgb, rng.integers(0, 256, (h, w), dtype=np.uint8)])
    return rgb


# --- quality 100: lossless -----------------------------------------------

SIDES = {1: 0, 7: 6, 33: 0, 64: 0, 97: None, "strip": None}  # side: speed


@pytest.mark.parametrize("side", list(SIDES), ids=str)
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_quality_100_is_read_lossless(channels, side):
    """Gray (profile 0 monochrome), colour (profile 1, 4:4:4, identity
    matrix) and BGRA (its alpha item lossless too) at quality 100:
    lossless frames, the WHT on every 4x4 block; 128x128 superblocks at
    speed 0."""
    h, w = (16, 4500) if side == "strip" else (side, side)
    speed = SIDES[side]
    data = ar.imencode_avif(_pixels(h, w, channels), 100, speed)
    image = avif.read_image(data)
    assert image.frame.header.lossless
    assert image.frame.seq.mono == (channels == 1)
    if channels != 1:
        assert (image.frame.seq.ssx, image.matrix) == (0, 0)
    if image.alpha is not None:
        assert image.alpha.header.lossless
    assert image.frame.seq.sb128 == (speed == 0)
    stats = _check(data, plain=h * w <= 64 * 64)
    assert _stat(stats, "lossless_blocks") > 0
    assert _stat(stats, "tx_size_4x4") and all(
        not _stat(stats, n) for n in avif.STAT_NAMES
        if n.startswith("tx_size_") and n != "tx_size_4x4")


def test_quality_100_pixels_are_the_image():
    """Lossless: cv2 and the port read back the very pixels written."""
    for channels in (1, 3):
        img = _pixels(40, 56, channels)
        data = ar.imencode_avif(img, 100)
        rgb = image_io.decode_image(data)
        want = np.repeat(img[:, :, None], 3, 2) if channels == 1 else img
        np.testing.assert_array_equal(rgb, want)


# --- palette (screen content) ---------------------------------------------


def _drawing(h: int, w: int, colours: int, seed: int) -> np.ndarray:
    """Flat shapes and text in `colours` colours."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (colours, 3))
    img = np.empty((h, w, 3), np.uint8)
    img[:] = palette[0]
    for k in range(1, colours):
        c = tuple(int(v) for v in palette[k])
        x0, y0 = int(rng.integers(0, w - 8)), int(rng.integers(0, h - 8))
        if k % 2:
            cv2.rectangle(img, (x0, y0), (x0 + int(rng.integers(6, 40)),
                                          y0 + int(rng.integers(6, 30))),
                          c, -1)
        else:
            cv2.circle(img, (x0, y0), int(rng.integers(4, 20)), c, -1)
    cv2.putText(img, "Text 42", (2, h - 6), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                tuple(int(v) for v in palette[-1]), 1, cv2.LINE_8)
    return img


PALETTE_CASES = [(0, 2, 60, 3), (4, 3, 40, 3), (6, 5, 80, 3), (8, 8, 20, 3),
                 (6, 4, 100, 3), (4, 6, 70, 1), (8, 7, 50, 4)]


@pytest.mark.parametrize("case", PALETTE_CASES,
                         ids=lambda c: "s{}-c{}-q{}-ch{}".format(*c))
def test_palette_files_equal_libaom_and_cv2(case):
    """Drawings of 2 to 8 flat colours at speeds 0 to 8: libaom codes
    them as screen content with palette blocks (colours from the cache
    of the neighbours' palettes, coded and delta-coded, the colour-index
    maps in wavefront order)."""
    speed, colours, quality, channels = case
    img = _drawing(64, 96, colours, speed * 10 + colours)
    if channels == 1:
        img = img.mean(axis=2).astype(np.uint8)
    elif channels == 4:
        img = np.dstack([img, np.full(img.shape[:2], 200, np.uint8)])
    data = ar.imencode_avif(img, quality, speed)
    assert avif.read_image(data).frame.header.screen_content
    stats = _check(data, plain=True)
    assert _stat(stats, "palette_y") + _stat(stats, "palette_uv") > 0


def test_palette_cases_reach_the_cache_chroma_and_delta_v():
    totals = sum(avif.decode_planes_c(avif.read_image(ar.imencode_avif(
        _drawing(64, 96, c, s * 10 + c), q, s)).frame)[3]
        for s, c, q, ch in PALETTE_CASES if ch == 3)
    for name in ("palette_y", "palette_uv", "palette_cache",
                 "palette_delta_v"):
        assert _stat(totals, name) > 0, name


# --- loop restoration ------------------------------------------------------

# (y0, x0, h, w, speed, quality or None): crops of the photo and the photo
LR_CASES = [(200, 100, 160, 200, 0, None), (200, 100, 160, 200, 2, 60),
            (0, 0, 240, 320, 2, 20), (200, 100, 160, 200, 4, 90),
            (0, 0, 480, 640, 4, None), (0, 0, 64, 160, 2, 60)]


@pytest.fixture(scope="module")
def lr_files():
    return {case: ar.imencode_avif(np.ascontiguousarray(
        PHOTO[case[0]:case[0] + case[2], case[1]:case[1] + case[3]]),
        case[5], case[4]) for case in LR_CASES}


@pytest.mark.parametrize("case", LR_CASES,
                         ids=lambda c: "{}x{}-s{}-q{}".format(*c[2:]))
def test_loop_restoration_files_equal_libaom_and_cv2(case, lr_files):
    """Photos at speeds 0 to 4: restoration units read per superblock,
    filtered after CDEF in 64-row stripes offset 8 rows up, whose rows
    above and below are the deblocked frame's. Without the restoration
    the planes differ from libaom's."""
    data = lr_files[case]
    frame = avif.read_image(data).frame
    assert any(frame.header.lr_type)
    small = case[2] * case[3] <= 64 * 160
    _check(data, plain=small)
    want = ar.aom_planes(ar.primary_obus(data))
    before = avif.decode_planes_c(frame, restoration=False)[:3]
    assert any(not np.array_equal(a, b) for a, b in zip(before, want)
               if a is not None)
    if small:
        for a, b in zip(before, av1.decode_planes_plain(
                frame, restoration=False)):
            np.testing.assert_array_equal(a, b)


def test_loop_restoration_cases_reach_each_unit_type(lr_files):
    totals = sum(avif.decode_planes_c(avif.read_image(d).frame)[3]
                 for d in lr_files.values())
    for name in ("lr_wiener", "lr_sgrproj", "lr_switchable"):
        assert _stat(totals, name) > 0, name
    sizes = {avif.read_image(d).frame.header.lr_unit_size
             for d in lr_files.values()}
    assert len(sizes) >= 2  # 256 and 128 sample units


# --- intra block copy ------------------------------------------------------


def test_intra_block_copy_file_equals_libaom_and_cv2():
    """A drawing at speed 6 that libaom codes with intra block copy: DVs
    from the neighbours' stack, whole-sample copies in luma and half-
    sample BILINEAR ones in 4:2:0 chroma."""
    data = ar.imencode_avif(ar.drawing(200, 300, 0)[:, :, ::-1].copy(),
                            None, 6)
    assert avif.read_image(data).frame.header.allow_intrabc
    stats = _check(data, plain=True)
    assert _stat(stats, "intrabc_blocks") > 0
    assert _stat(stats, "intrabc_halfpel") > 0


def test_intra_block_copy_dv_outside_the_allowed_area_is_refused(
        monkeypatch):
    """The intra block copy file with each block's reference DV moved 64
    rows down, into rows not decoded yet: libaom's av1_is_dv_valid
    rejects such a DV and reports the frame corrupt, so cv2 returns no
    image; the plain decoder refuses it by name."""
    data = ar.imencode_avif(ar.drawing(200, 300, 0)[:, :, ::-1].copy(),
                            None, 6)
    stack = av1._dv_stack
    monkeypatch.setattr(av1, "_dv_stack",
                        lambda t: [(8 * 64, 0)] + stack(t))
    with pytest.raises(ValueError, match="intra block copy DV points "
                                         "outside the area libaom allows"):
        av1.decode_planes_plain(avif.read_image(data).frame)


# --- stages ------------------------------------------------------------------


@pytest.fixture(scope="module")
def lib():
    """The C library with the stages' signatures, once libaom's dispatch
    tables are set (a decoder has been created)."""
    ar.aom_planes(ar.primary_obus(
        (FIXTURES / "avif_odd_33x17.avif").read_bytes()))
    lib = avif.library()
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.av1_iwht4x4_add.argtypes = [vp, vp, i]
    lib.av1_wiener_filter.argtypes = [vp, i, i, i, vp, vp, vp, i]
    lib.av1_sgr_filter.argtypes = [vp] + [i] * 6 + [vp, i]
    lib.av1_palette_color_context.argtypes = [vp] + [i] * 4 + [vp]
    lib.av1_intrabc_predict.argtypes = [vp] + [i] * 5 + [vp, i]
    lib.av1_dv_valid.argtypes = [i] * 14
    lib.av1_cfl_predict_ss.argtypes = [vp, i, vp] + [i] * 8
    return lib


def test_inverse_wht_c_plain_and_libaom_agree(lib):
    """The lossless transform on sparse and dense coefficients (C =
    plain = av1_highbd_iwht4x4_16_add_c)."""
    wht = ar.libaom_function("av1_highbd_iwht4x4_16_add_c", None,
                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int)
    rng = np.random.default_rng(1)
    for trial in range(120):
        coef = np.zeros(16, np.int32)
        k = int(rng.integers(1, 17))
        amp = (8, 400, 8000)[trial % 3]
        coef[rng.choice(16, k, replace=False)] = 4 * rng.integers(
            -amp, amp + 1, k)
        dst = rng.integers(0, 256, (4, 4)).astype(np.uint8)
        want = dst.astype(np.uint16)
        wht(coef.ctypes.data, want.ctypes.data >> 1, 4, 8)  # a short ptr
        got = dst.copy()
        lib.av1_iwht4x4_add(coef.ctypes.data, got.ctypes.data, 4)
        plain = dst.copy()
        av1.iwht_add(coef, plain)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(plain, got)


def _taps(rng) -> list:
    c = [int(rng.integers(lo, hi + 1))
         for lo, hi in zip(av1.WIENER_MIN, av1.WIENER_MAX)]
    return [c[0], c[1], c[2], -2 * sum(c), c[2], c[1], c[0]]


def test_wiener_filter_c_plain_and_libaom_agree(lib):
    """Every tap within its coded range, on seeded blocks (C = plain =
    av1_wiener_convolve_add_src_c at get_conv_params_wiener(8))."""
    conv = ar.libaom_function(
        "av1_wiener_convolve_add_src_c", None, ctypes.c_void_p,
        ctypes.c_ssize_t, ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p)

    def aligned(taps):  # libaom finds the filter at a 16-byte boundary
        buf = np.zeros(32, np.int16)
        out = buf[(-buf.ctypes.data % 16) // 2:][:8]
        out[:7] = taps
        return out

    rng = np.random.default_rng(2)
    rounds = np.array([3, 11], np.int32)  # WienerConvolveParams at 8 bits
    for trial in range(40):
        w, h = ((16, 8), (64, 64), (32, 17), (48, 5))[trial % 4]
        src = rng.integers(0, 256, (h + 7, w + 8)).astype(np.uint8)
        if trial % 2:
            src = (src // 64 * 64 + 20).astype(np.uint8)
        vf, hf = _taps(rng), _taps(rng)
        want = np.zeros((h, w), np.uint8)
        fx, fy = aligned(hf), aligned(vf)
        conv(src[3:, 3:].ctypes.data, src.shape[1], want.ctypes.data, w,
             fx.ctypes.data, 16, fy.ctypes.data, 16, w, h, rounds.ctypes.data)
        got = np.zeros((h, w), np.uint8)
        v32, h32 = np.array(vf, np.int32), np.array(hf, np.int32)
        assert lib.av1_wiener_filter(src[3:, 3:].ctypes.data, src.shape[1],
                                     w, h, v32.ctypes.data, h32.ctypes.data,
                                     got.ctypes.data, w) == 0
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            av1.wiener_filter(src[:h + 6, :w + 6], vf, hf), got)


def test_self_guided_filter_c_plain_and_libaom_agree(lib):
    """Every parameter set (both radii, radius 2 only, radius 1 only)
    and projection, on rough and flat seeded blocks (C = plain =
    av1_apply_selfguided_restoration_c)."""
    sgr = ar.libaom_function(
        "av1_apply_selfguided_restoration_c", ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int)
    tmp = np.zeros(1 << 18, np.int32)
    params = av1.table("sgr_params")
    rng = np.random.default_rng(3)
    for trial in range(48):
        w, h = ((64, 64), (17, 9), (33, 56), (8, 1))[trial % 4]
        sgr_set = trial % 16
        src = rng.integers(0, 256, (h + 6, w + 6)).astype(np.uint8)
        if trial % 3 == 0:
            src = (src // 40 * 40).astype(np.uint8)
        xqd = np.array([int(rng.integers(-96, 32)),
                        int(rng.integers(-32, 96))], np.int32)
        if params[sgr_set][0] == 0:
            xqd[0] = 0
        if params[sgr_set][1] == 0:
            xqd[1] = min(95, max(-32, 128 - int(xqd[0])))
        want = np.zeros((h, w), np.uint8)
        assert sgr(src[3:, 3:].ctypes.data, w, h, src.shape[1], sgr_set,
                   xqd.ctypes.data, want.ctypes.data, w, tmp.ctypes.data, 8,
                   0) == 0
        got = np.zeros((h, w), np.uint8)
        assert lib.av1_sgr_filter(src[3:, 3:].ctypes.data, src.shape[1], w,
                                  h, sgr_set, int(xqd[0]), int(xqd[1]),
                                  got.ctypes.data, w) == 0
        np.testing.assert_array_equal(got, want, err_msg=str(sgr_set))
        np.testing.assert_array_equal(
            av1.sgr_filter(src, sgr_set, tuple(int(v) for v in xqd)), got)


def test_palette_color_context_c_plain_and_libaom_agree(lib):
    """The context and colour order of seeded map entries for 2 to 8
    colours (C = plain = av1_get_palette_color_index_context)."""
    ref = ar.libaom_function("av1_get_palette_color_index_context",
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p)
    rng = np.random.default_rng(4)
    for trial in range(300):
        n = int(rng.integers(2, 9))
        colour_map = rng.integers(0, n, (8, 8)).astype(np.uint8)
        r, c = int(rng.integers(0, 8)), int(rng.integers(0, 8))
        if r == c == 0:
            c = 1
        want_order, got_order = np.zeros(8, np.uint8), np.zeros(8, np.uint8)
        index = np.zeros(1, np.int32)
        want = ref(colour_map.ctypes.data, 8, r, c, n, want_order.ctypes.data,
                   index.ctypes.data)
        got = lib.av1_palette_color_context(colour_map.ctypes.data, 8, r, c,
                                            n, got_order.ctypes.data)
        ctx, order = av1.palette_color_context(colour_map, r, c, n)
        assert want == got == ctx
        np.testing.assert_array_equal(got_order[:n], want_order[:n])
        assert order[:n] == got_order[:n].tolist()


@pytest.mark.parametrize("sb4", [16, 32])
def test_intra_block_copy_dv_check_c_and_plain_agree(sb4, lib):
    """av1_is_dv_valid on seeded blocks, tiles and DVs around them, sub-
    sample and out-of-range DVs among them (C = plain); both verdicts
    reached, and the hand-picked cases decided as libaom decides them."""
    rng = np.random.default_rng(sb4)
    verdicts = []
    for _ in range(3000):
        bw4, bh4 = (int(v) for v in rng.choice([1, 2, 4, 8, 16], 2))
        tile = [int(v) * sb4 for v in rng.integers(0, 3, 2)]
        tile = (tile[0], tile[0] + sb4 * int(rng.integers(1, 6)),
                tile[1], tile[1] + sb4 * int(rng.integers(1, 8)))
        mi_row = int(rng.integers(tile[0], tile[1] - bh4 + 1)) // bh4 * bh4
        mi_col = int(rng.integers(tile[2], tile[3] - bw4 + 1)) // bw4 * bw4
        span = 8 * 4 * sb4 * int(rng.choice([1, 4, 100]))
        dv = tuple(int(v) // 8 * 8 + (int(rng.random() < 0.05) << 2)
                   for v in rng.integers(-span, span // 4, 2))
        ssx, ssy, chroma = (int(v) for v in rng.integers(0, 2, 3))
        want = av1.dv_valid(dv, mi_row, mi_col, bw4, bh4, sb4, tile, ssx,
                            ssy, chroma)
        got = lib.av1_dv_valid(*dv, mi_row, mi_col, bw4, bh4, sb4, *tile,
                               ssx, ssy, chroma)
        assert got == want, (dv, mi_row, mi_col, bw4, bh4, tile)
        verdicts.append(want)
    assert 0 < sum(verdicts) < len(verdicts)
    tile, side = (0, 4 * sb4, 0, 40 * sb4), 4 * sb4  # 4 x 40 superblocks
    for dv, want in (
            ((0, 0), False),                      # the block itself
            ((-8 * side, 0), True),               # the superblock above
            ((-8 * side, 4), False),              # a sub-sample part
            ((0, -8 * (256 + side)), True),       # past the 256 delay
            ((0, -8 * 256), False),               # within the delay
            ((-8 * side, 8 * 64 * 8), False),     # past the wavefront
            ((-(1 << 14), 0), False)):            # out of is_mv_valid
        args = (dv, sb4, 8 * sb4, 4, 4, sb4, tile, 1, 1, 1)  # 16x16
        assert av1.dv_valid(*args) is want, dv
        assert lib.av1_dv_valid(*dv, *args[1:6], *tile, 1, 1, 1) == want


@pytest.mark.parametrize("fy,fx", [(8, 8), (0, 8), (8, 0)])
def test_intra_block_copy_filter_c_plain_and_libaom_agree(fy, fx, lib):
    """Half-sample copies of seeded blocks (C = plain = libaom's
    av1_convolve_{2d,x,y}_sr_intrabc_c at ROUND0_BITS 3)."""

    class ConvolveParams(ctypes.Structure):
        _fields_ = [("do_average", ctypes.c_int), ("dst", ctypes.c_void_p),
                    ("dst_stride", ctypes.c_int), ("round_0", ctypes.c_int),
                    ("round_1", ctypes.c_int), ("plane", ctypes.c_int),
                    ("is_compound", ctypes.c_int),
                    ("use_dist_wtd_comp_avg", ctypes.c_int),
                    ("fwd_offset", ctypes.c_int),
                    ("bck_offset", ctypes.c_int)]

    params = ConvolveParams(0, None, 0, 3, 11, 0, 0, 0, 0, 0)
    filter_params = ar.libaom_address("av1_intrabc_filter_params")
    vp, i = ctypes.c_void_p, ctypes.c_int
    if fx and fy:
        ref = ar.libaom_function("av1_convolve_2d_sr_intrabc_c", None, vp, i,
                                 vp, i, i, i, vp, vp, i, i, vp)
    else:
        ref = ar.libaom_function("av1_convolve_{}_sr_intrabc_c".format(
            "x" if fx else "y"), None, vp, i, vp, i, i, i, vp, i, vp)
    rng = np.random.default_rng(fy * 2 + fx)
    for w, h in ((4, 4), (8, 16), (32, 8), (64, 64), (16, 4)):
        src = rng.integers(0, 256, (h + 1, w + 1)).astype(np.uint8)
        want = np.zeros((h, w), np.uint8)
        if fx and fy:
            ref(src.ctypes.data, w + 1, want.ctypes.data, w, w, h,
                filter_params, filter_params, 8, 8, ctypes.byref(params))
        else:
            ref(src.ctypes.data, w + 1, want.ctypes.data, w, w, h,
                filter_params, 8, ctypes.byref(params))
        got = np.zeros((h, w), np.uint8)
        lib.av1_intrabc_predict(src.ctypes.data, w + 1, w, h, fy, fx,
                                got.ctypes.data, w)
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h}")
        np.testing.assert_array_equal(av1.intrabc_predict(
            src[:h + (fy > 0), :w + (fx > 0)], fy, fx), got)


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32), (4, 8),
                                 (8, 4), (16, 32), (32, 8)])
def test_chroma_from_luma_444_c_plain_and_libaom_agree(w, h, lib):
    """CFL at 4:4:4 at every alpha (C = plain = libaom's
    cfl_subsample_lbd_444, subtract-average and predict functions)."""
    sub = ar.libaom_function(f"cfl_subsample_lbd_444_{w}x{h}_c", None,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
    avg = ar.libaom_function(f"cfl_subtract_average_{w}x{h}_c", None,
                             ctypes.c_void_p, ctypes.c_void_p)
    pred = ar.libaom_function(f"cfl_predict_lbd_{w}x{h}_c", None,
                              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int)
    rng = np.random.default_rng(w * 100 + h)
    luma = rng.integers(0, 256, (h, w)).astype(np.uint8)
    q3 = np.zeros(32 * 32, np.uint16)
    ac = np.zeros(32 * 32, np.int16)
    sub(luma.ctypes.data, w, q3.ctypes.data)
    avg(q3.ctypes.data, ac.ctypes.data)
    for alpha in range(-16, 17):
        dc = np.full((h, w), int(rng.integers(0, 256)), np.uint8)
        got, want = dc.copy(), dc.copy()
        lib.av1_cfl_predict_ss(got.ctypes.data, w, luma.ctypes.data, w, w, h,
                               w, h, alpha, 0, 0)
        pred(ac.ctypes.data, want.ctypes.data, w, alpha)
        np.testing.assert_array_equal(got, want, err_msg=str(alpha))
        np.testing.assert_array_equal(
            av1.cfl_predict(dc, luma, w, h, alpha, 0, 0), got)
