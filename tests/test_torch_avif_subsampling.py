"""AVIF files in 4:4:4 lossy frames (profile 1 at 8 and 10 bits, profile
2 at 12) and in 4:2:2 (profile 2 at 8, 10 and 12 bits), as other
encoders than cv2 write them: Pillow's AVIF writer (libavif 1.3.0,
8 bits) across qualities and speeds, and the wheel's libavif 1.4.2
encoder over ctypes at 10 and 12 bits (`tests/avif_reference.py
avif_encode`). Each file decodes in the host C library `csrc/av1.c` to
libaom 3.14.1's own Y, U and V planes, before CDEF too where no loop
restoration follows, the plain decoder (`utils/av1.py`) to the C
library's planes, and both through `image_io` to cv2.imdecode reversed
to RGB, with tolerance 0. Chroma from luma, palette, CDEF, loop
restoration and intra block copy are each reached at both subsamplings
(the C library's counters). The stages that exist only at 4:2:2 equal
libaom's C functions on seeded blocks: chroma from luma's 2x1 luma
averaging (cfl_subsample_*_422) and CDEF's 4x8 chroma blocks, whose
direction is the luma one mapped through libaom's conv422
(av1_cdef_filter_fb).
"""

import ctypes
from pathlib import Path

import cv2
import numpy as np
import pytest

import avif_reference as ar
from multiposenet_tpu_torch.utils import av1, avif, image_io
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(ar.LIBAVIF is None,
                                reason="the opencv-python wheel's libaom "
                                       "and libavif are absent")

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
PHOTO = cv2.imread(str(FIXTURES / "photo_480x640_q95_420.jpg"))[:, :, ::-1]
FORMATS = {"444": ar.YUV444, "422": ar.YUV422}
PLAIN_PIXELS = 4096

# (writer, subsampling, depth, content, h, w, quality, speed, aom options)
CASES = [("pillow", sub, 8, content, 48, 64, q, speed, opts)
         for sub in FORMATS
         for content, q, speed, opts in (
             ("photo", 50, 2, {}), ("photo", 30, 1, {}),
             ("drawing", 60, 6, {"tune-content": "screen"}),
             ("photo", 15, 6, {"enable-cdef": "1"}),
             ("photo", 70, 4, {"enable-cdef": "1"}),
             ("photo", 90, 8, {}))]
CASES += [("libavif", sub, depth, content, h, w, q, speed, opts)
          for sub in FORMATS for depth in (8, 10, 12)
          for content, h, w, q, speed, opts in (
              ("drawing", 48, 64, 50, 6, {}),
              ("photo", 48, 64, 30, 4, {}),
              ("drawing", 48, 64, 20, 2, {"enable_restoration": "1"}),
              ("drawing", 200, 300, 95, 6, {}))]


def _id(case) -> str:
    writer, sub, depth, content, h, w, q, speed, opts = case
    return "-".join([writer, sub, str(depth), content, f"{h}x{w}", f"q{q}",
                     f"s{speed}"] + [k for k in opts])


def _pixels(content: str, h: int, w: int, seed: int) -> np.ndarray:
    if content == "drawing":
        return ar.drawing(h, w, seed)
    return np.ascontiguousarray(PHOTO[seed:seed + h, 2 * seed:2 * seed + w])


def encode(case) -> bytes:
    writer, sub, depth, content, h, w, q, speed, opts = case
    rgb = _pixels(content, h, w, 0 if h > 64 else q + speed)
    if writer == "pillow":
        return ar.pillow_avif(rgb, q, speed,
                              subsampling=":".join(sub[0] + sub[1:]),
                              **opts)
    return ar.avif_encode(ar.planes_of(rgb, depth, FORMATS[sub]), depth,
                          FORMATS[sub], q, speed, **opts)


@pytest.fixture(scope="module")
def files():
    return {_id(c): encode(c) for c in CASES}


def _stat(stats, name: str) -> int:
    return int(stats[avif.STAT_NAMES.index(name)])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_files_equal_libaom_and_cv2(case, files):
    """C planes = libaom's, after CDEF and (without restoration) before;
    pixels = cv2's; the plain decoder's planes and pixels = C's on the
    small files."""
    writer, sub, depth, *_ = case
    data = files[_id(case)]
    image = avif.read_image(data)
    s, h = image.frame.seq, image.frame.header
    assert (s.ssx, s.ssy, s.bit_depth) == ((0, 0) if sub == "444"
                                           else (1, 0)) + (depth,)
    assert not h.lossless
    obus = ar.primary_obus(data)
    y, u, v, _ = avif.decode_planes_c(image.frame)
    for got, want in zip((y, u, v), ar.aom_planes(obus)):
        np.testing.assert_array_equal(got, want)
    if not any(h.lr_type):
        for got, want in zip(avif.decode_planes_c(image.frame, cdef=False),
                             ar.aom_planes(obus, skip_loop_filter=True)):
            np.testing.assert_array_equal(got, want)
    rgb = ar.imdecode_rgb(data)
    np.testing.assert_array_equal(image_io.decode_image(data), rgb)
    if h.width * h.height <= PLAIN_PIXELS:
        for a, b in zip((y, u, v), av1.decode_planes_plain(image.frame)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(image_io.decode_image_plain(data), rgb)


@pytest.mark.parametrize("sub", FORMATS)
def test_files_reach_each_tool_at_each_subsampling(sub, files):
    """Chroma from luma, palette (luma and chroma), CDEF with a chroma
    primary strength, loop restoration on chroma and intra block copy are
    each reached by the files of each subsampling."""
    totals = {}
    cdef_uv_pri = lr_uv = 0
    for case in CASES:
        if case[1] != sub:
            continue
        frame = avif.read_image(files[_id(case)]).frame
        stats = avif.decode_planes_c(frame)[3]
        for name in avif.STAT_NAMES:
            totals[name] = totals.get(name, 0) + _stat(stats, name)
        if _stat(stats, "cdef_blocks"):
            cdef_uv_pri += any(p for p, _ in frame.header.cdef_uv)
        lr_uv += any(frame.header.lr_type[1:])
    for name in ("uv_mode_13", "palette_y", "palette_uv", "cdef_blocks",
                 "lr_wiener", "intrabc_blocks"):
        assert totals[name] > 0, name
    assert cdef_uv_pri and lr_uv


def test_header_of_every_profile_and_subsampling():
    """The sequence headers these writers give: profile 1 for 4:4:4 at 8
    and 10 bits, profile 2 for 4:4:4 at 12 bits and for 4:2:2 at every
    depth."""
    for sub in FORMATS:
        for depth in (8, 10, 12):
            rgb = ar.drawing(8, 8, depth)
            data = ar.avif_encode(ar.planes_of(rgb, depth, FORMATS[sub]),
                                  depth, FORMATS[sub], 50, 9)
            s = avif.read_image(data).frame.seq
            want = 1 if sub == "444" and depth < 12 else 2
            assert (s.profile, s.bit_depth, s.ssx, s.ssy) == (
                want, depth, int(sub == "422"), 0)
            np.testing.assert_array_equal(image_io.decode_image(data),
                                          ar.imdecode_rgb(data))


# --- stages that exist only at 4:2:2 ----------------------------------------


@pytest.fixture(scope="module")
def lib():
    """The C library with the stages' signatures, once libaom's dispatch
    tables are set (a decoder has been created)."""
    ar.aom_planes(ar.primary_obus(
        (FIXTURES / "avif_odd_33x17.avif").read_bytes()))
    lib = avif.library()
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.av1_cfl_predict_ss_hbd.argtypes = [vp, i, vp] + [i] * 9
    lib.av1_cdef_block_hbd.argtypes = [vp] + [i] * 11 + [vp, i, i]
    return lib


CFL_422 = [(4, 4), (4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16),
           (16, 32), (4, 16), (8, 32)]


@pytest.mark.parametrize("depth", (8, 10, 12))
@pytest.mark.parametrize("w,h", CFL_422)
def test_chroma_from_luma_422_c_plain_and_libaom_agree(w, h, depth, lib):
    """CFL on a 4:2:2 chroma block (its luma 2w x h, each pair of a row
    averaged) at every alpha: C = plain = libaom's cfl_subsample_*_422,
    subtract-average and predict functions; with the luma cut short, C =
    plain."""
    bd = "lbd" if depth == 8 else "hbd"
    vp, i = ctypes.c_void_p, ctypes.c_int
    sub = ar.libaom_function(f"cfl_subsample_{bd}_422_{2 * w}x{h}_c", None,
                             vp, i, vp)
    avg = ar.libaom_function(f"cfl_subtract_average_{w}x{h}_c", None, vp, vp)
    pred = ar.libaom_function(f"cfl_predict_{bd}_{w}x{h}_c", None, vp, vp, i,
                              i, *([i] if depth > 8 else []))
    rng = np.random.default_rng(w * 100 + h + depth)
    dtype = np.uint8 if depth == 8 else np.uint16
    luma = rng.integers(0, 1 << depth, (h, 2 * w)).astype(dtype)
    q3 = np.zeros(32 * 32, np.uint16)
    ac = np.zeros(32 * 32, np.int16)
    sub(luma.ctypes.data, 2 * w, q3.ctypes.data)
    avg(q3.ctypes.data, ac.ctypes.data)
    luma16 = luma.astype(np.uint16)
    for alpha in range(-16, 17):
        dc = np.full((h, w), int(rng.integers(0, 1 << depth)), dtype)
        want = dc.copy()
        pred(ac.ctypes.data, want.ctypes.data, w, alpha,
             *([depth] if depth > 8 else []))
        got = dc.astype(np.uint16)
        lib.av1_cfl_predict_ss_hbd(got.ctypes.data, w, luma16.ctypes.data,
                                   2 * w, w, h, 2 * w, h, alpha, 1, 0, depth)
        np.testing.assert_array_equal(got, want, err_msg=str(alpha))
        np.testing.assert_array_equal(
            av1.cfl_predict(dc, luma, 2 * w, h, alpha, 1, 0, depth), got)
    cut = (max(2, 2 * w - 4), max(1, h - 3))
    got = dc.astype(np.uint16)
    lib.av1_cfl_predict_ss_hbd(got.ctypes.data, w, luma16.ctypes.data, 2 * w,
                               w, h, cut[0], cut[1], 5, 1, 0, depth)
    np.testing.assert_array_equal(
        av1.cfl_predict(dc, luma, *cut, 5, 1, 0, depth), got)


# libaom's CDEF_BSTRIDE and the borders of its 16-bit input block.
CDEF_BSTRIDE, CDEF_VBORDER, CDEF_HBORDER = 144, 3, 8


@pytest.mark.parametrize("depth", (8, 10, 12))
def test_cdef_422_chroma_equals_libaoms(depth, lib):
    """av1_cdef_filter_fb on a 4:2:2 chroma plane (xdec 1, ydec 0) maps
    each block's luma direction through conv422 (read back from its
    direction array) = av1.CDEF_CONV422 = csrc/av1.c's av1_cdef_conv422,
    and filters 4x8 blocks at the chroma damping (one less than luma's)
    as the port's CDEF block filter does (C = plain) with that
    direction, at every luma direction and several strengths."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    fb = ar.libaom_function("av1_cdef_filter_fb", None, vp, vp, i, vp, i, i,
                            vp, vp, vp, i, vp, i, i, i, i, i)
    conv = (ctypes.c_int * 8).in_dll(lib, "av1_cdef_conv422")
    assert tuple(conv) == av1.CDEF_CONV422
    rng = np.random.default_rng(depth)
    cs = depth - 8
    rows, cols = 2 * CDEF_VBORDER + 64, CDEF_BSTRIDE
    blocks = [(by, bx) for by in range(8) for bx in range(0, 8, 2)]
    for level, sec, damping in ((5, 2, 3), (15, 4, 6), (1, 0, 4), (9, 1, 5)):
        src = rng.integers(0, 1 << depth, (rows, cols)).astype(np.uint16)
        dirs = np.zeros((16, 16), np.int32)
        var = np.zeros((16, 16), np.int32)
        dlist = bytearray()
        for k, (by, bx) in enumerate(blocks):
            dirs[by, bx] = k % 8
            dlist += bytes((by, bx))
        luma_dirs = dirs.copy()
        dst = np.zeros((64, 64), np.uint16)
        dlist = (ctypes.c_uint8 * len(dlist)).from_buffer(dlist)
        at = src.ctypes.data + 2 * (CDEF_VBORDER * cols + CDEF_HBORDER)
        fb(None, dst.ctypes.data, 64, at, 1, 0, dirs.ctypes.data, None,
           var.ctypes.data, 1, ctypes.addressof(dlist), len(blocks), level,
           sec, damping, cs)
        for by, bx in blocks:
            d = av1.CDEF_CONV422[luma_dirs[by, bx]]
            assert dirs[by, bx] == d
            y0, x0 = CDEF_VBORDER + 8 * by, CDEF_HBORDER + 4 * bx
            want = dst[8 * by:8 * by + 8, 4 * bx:4 * bx + 4]
            got = np.zeros((8, 4), np.uint16)
            lib.av1_cdef_block_hbd(src.ctypes.data, cols, rows, cols, y0, x0,
                                   4, 8, level << cs, sec << cs,
                                   damping - 1 + cs, d, got.ctypes.data, 4,
                                   cs)
            np.testing.assert_array_equal(got, want, err_msg=f"{by},{bx}")
            np.testing.assert_array_equal(av1.cdef_block(
                src, y0, x0, 4, 8, level << cs, sec << cs, damping - 1 + cs,
                d, (rows, cols), cs), got)
