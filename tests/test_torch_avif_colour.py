"""AVIF files in every colour form cv2.imread converts, read as
cv2.imdecode(..., IMREAD_COLOR) reads them: libavif 1.4.2's
avifImageYUVToRGB at every matrix coefficients value (0 to 19 and values
past them), at limited and full range, at 8, 10 and 12 bits, in 4:0:0,
4:2:0, 4:2:2 and 4:4:4, with and without an alpha item. The files are
the wheel's libavif encoder's (`tests/avif_reference.py avif_encode`)
with their `colr` nclx box rewritten (`patch_colr`), or without one and
the AV1 sequence header rewritten. Where cv2 returns an image,
`image_io.decode_image` (the host C library) and `decode_image_plain`
(the plain decoder) return it reversed to RGB, with tolerance 0; where
cv2 returns none, both raise a ValueError that names the form.
`avif.yuv_to_rgb` equals libavif's own conversion on seeded planes, and
the port's tables (libyuv's YuvConstants, Kr/Kb, the colour primaries,
the route to libyuv) equal the wheel's.
"""

import ctypes
import struct

import numpy as np
import pytest

import avif_reference as ar
from multiposenet_tpu_torch.utils import avif, image_io
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(ar.LIBAVIF is None,
                                reason="the opencv-python wheel's libavif "
                                       "is absent")

LAYOUTS = {"400": ar.YUV400, "420": ar.YUV420, "422": ar.YUV422,
           "444": ar.YUV444}
MATRICES = tuple(range(20)) + (20, 100, 255)
CHROMA_DERIVED_PRIMARIES = (1, 2, 4, 5, 6, 9, 10, 22)


def _file(depth: int, layout: str, alpha: bool, h: int = 13, w: int = 11,
          seed: int = 7) -> bytes:
    """A small drawing written by the wheel's libavif encoder."""
    img = ar.drawing(h, w, seed)
    planes = ar.planes_of(img, depth, LAYOUTS[layout])
    a = np.full((h, w), (1 << depth) - 4) if alpha else None
    return ar.avif_encode(planes, depth, LAYOUTS[layout], quality=40,
                          speed=8, alpha=a)


def _reads_as_cv2(data: bytes, form: str) -> bool:
    """Both decoders return cv2's pixels, or, where cv2 returns none,
    refuse the file naming `form`; whether cv2 read it."""
    want = ar.imdecode_rgb(data)
    for read in (image_io.decode_image, image_io.decode_image_plain):
        if want is None:
            with pytest.raises(ValueError, match=form):
                read(data)
        else:
            np.testing.assert_array_equal(read(data), want, err_msg=form)
    return want is not None


@pytest.mark.parametrize("alpha", [False, True], ids=["", "alpha"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("depth", (8, 10, 12))
def test_every_matrix_and_range_reads_as_cv2(depth, layout, alpha):
    """The colr box rewritten to each matrix at each range (chroma-derived
    NCL at several primaries): read exactly where cv2 reads, to cv2's
    pixels. cv2 reads a monochrome file's Y plane whatever its colour
    description, and returns no image for one with an alpha item."""
    data = _file(depth, layout, alpha)
    read = set()
    for full in (0, 1):
        for matrix in MATRICES:
            for primaries in (CHROMA_DERIVED_PRIMARIES if matrix == 12
                              else (1,)):
                edited = ar.patch_colr(data, matrix, full, primaries)
                form = "monochrome image with an alpha" \
                    if layout == "400" and alpha else \
                    rf"matrix coefficients {matrix} \("
                if _reads_as_cv2(edited, form):
                    read.add((matrix, full))
    if layout == "400":
        assert len(read) == (0 if alpha else 2 * len(MATRICES))
        return
    # What cv2 reads at 4:2:0 (the forms the port once refused among them).
    expect = {(m, f) for m in (1, 2, 4, 5, 6, 7, 9, 12, 15) for f in (0, 1)}
    expect |= {(8, 1)} | ({(0, 0), (0, 1)} if layout == "444" else set())
    expect |= {(16, 1)} if depth == 10 else set()
    assert read == expect


@pytest.mark.parametrize("layout", ["420", "422", "444"])
def test_colour_of_the_sequence_header_without_nclx(layout):
    """Without a colr nclx box (none, or an ICC one) cv2 takes the
    matrix, range and primaries of the AV1 sequence header."""
    data = _file(8, layout, False, 16, 20, 3)
    obus = ar.primary_obus(data)
    icc = [(b"colr", b"prof" + bytes(100), False)]
    for matrix, full, primaries in ((1, 0, 1), (9, 1, 9), (4, 0, 1),
                                    (6, 0, 6), (12, 1, 9), (12, 0, 4),
                                    (8, 0, 1), (0, 1, 1), (3, 1, 1)):
        stream = ar.rewrite_frame(obus, {"matrix": matrix, "full_range": full,
                                         "primaries": primaries,
                                         "transfer": 1})
        for props in ((), icc):
            edited = ar.edit_avif(data, add_props=props,
                                  drop_props=(b"colr",), color=stream)
            if _reads_as_cv2(edited, rf"matrix coefficients {matrix} \("):
                image = avif.read_image(edited)
                assert (image.matrix, image.full_range, image.primaries,
                        image.transfer) == (matrix, full, primaries, 1)


def test_colr_boxes_as_libavif_takes_them():
    """An nclx box beside an ICC one (either order) is read; two nclx or
    two ICC boxes, or an nclx box cut short, are no image to cv2 and
    refused by name; a colr box of another colour type is skipped."""
    data = _file(8, "420", False, 16, 20, 3)

    def nclx(matrix, full):
        return b"colr", b"nclx" + struct.pack(">HHHB", 1, 1, matrix,
                                              full << 7), False

    prof = (b"colr", b"prof" + bytes(100), False)
    for props, read in (([prof, nclx(1, 0)], True),
                        ([nclx(9, 1), prof], True),
                        ([(b"colr", b"rICC" + bytes(10), False),
                          nclx(1, 0)], True),
                        ([(b"colr", b"abcd" + bytes(10), False)], True),
                        ([nclx(1, 0), nclx(9, 1)], False),
                        ([nclx(1, 0), nclx(1, 0)], False),
                        ([prof, prof], False),
                        ([(b"colr", b"nclx" + bytes(3), False)], False)):
        edited = ar.edit_avif(data, add_props=props, drop_props=(b"colr",))
        assert _reads_as_cv2(edited, "colr") == read, props


@pytest.mark.parametrize("layout", ["420", "422", "444"])
@pytest.mark.parametrize("depth", (8, 10, 12))
def test_yuv_to_rgb_equals_libavif_on_every_route(depth, layout):
    """avif.yuv_to_rgb on seeded planes (every value of the depth
    reached) = libavif's avifImageYUVToRGB into BGR and, with an alpha
    plane, BGRA, at every matrix and range, at odd and even sides: the
    libyuv routes (BT.601, BT.709, BT.2020 NCL, chroma-derived NCL of
    their primaries) and libavif's float path (the rest); a ValueError
    where libavif refuses the conversion."""
    rng = np.random.default_rng(depth * 10 + LAYOUTS[layout])
    ssx, ssy = ar.SUBSAMPLING[LAYOUTS[layout]]
    top = 1 << depth
    dtype = np.uint8 if depth == 8 else np.uint16
    for h, w in ((1, 1), (2, 3), (6, 8), (9, 11)):
        y = rng.integers(0, top, (h, w)).astype(dtype)
        u, v = (rng.integers(0, top, ((h + ssy) >> ssy, (w + ssx) >> ssx))
                .astype(dtype) for _ in range(2))
        a = rng.integers(0, top, (h, w)).astype(dtype)
        for alpha in (None, a):
            for full in (0, 1):
                for matrix in MATRICES:
                    for primaries in (CHROMA_DERIVED_PRIMARIES
                                      if matrix == 12 else (2,)):
                        want = ar.avif_yuv_to_rgb(
                            [y, u, v], depth, LAYOUTS[layout], matrix, alpha,
                            full, primaries)
                        args = (y, u, v, matrix, full, (ssx, ssy), depth,
                                alpha is not None, primaries)
                        if want is None:
                            with pytest.raises(ValueError, match=str(matrix)):
                                avif.yuv_to_rgb(*args)
                            continue
                        np.testing.assert_array_equal(
                            avif.yuv_to_rgb(*args), want,
                            err_msg=f"{h}x{w} {matrix} {full} {primaries}")


def test_conversion_tables_are_libavifs():
    """The port's copies of libavif's tables equal the wheel's bytes:
    libyuv's six YuvConstants (x86 layout), avifCalcYUVCoefficients's Kr
    and Kb (matrixCoefficientsTables) and the colour primaries
    (avifColorPrimariesTables); `libyuv_constants` picks what
    getLibYUVConstants picks, and `kr_kb` gives what
    avifCalcYUVCoefficients gives, for every matrix and primaries."""
    names = {}
    for name, (ub, ug, vg, vr, yg, yb) in avif.LIBYUV_CONSTANTS.items():
        raw = ar.libavif_table(f"kYuv{name}Constants")
        assert (raw[0], raw[32], raw[33], raw[65]) == (ub, ug, vg, vr), name
        assert struct.unpack_from("<hh", raw, 96)[0] == yg
        assert struct.unpack_from("<hh", raw, 128)[0] == yb
        names[ar.libavif_address(f"kYuv{name}Constants")] = name
    raw = ar.libavif_table("matrixCoefficientsTables")
    table = {struct.unpack_from("<i", raw, i)[0]:
             struct.unpack_from("<ff", raw, i + 16)
             for i in range(0, len(raw), 24)}
    assert table == {m: tuple(float(np.float32(k)) for k in kk)
                     for m, kk in avif.KR_KB.items()}
    raw = ar.libavif_table("avifColorPrimariesTables")
    table = {struct.unpack_from("<i", raw, i)[0]:
             struct.unpack_from("<8f", raw, i + 16)
             for i in range(0, len(raw), 48)}
    assert table == {p: tuple(float(np.float32(v)) for v in vv)
                     for p, vv in avif.PRIMARIES.items()}
    lib = ar.libavif()
    vp = ctypes.c_void_p
    pick = ar.libavif_function("getLibYUVConstants", ctypes.c_int, vp, vp, vp)
    calc = ar.libavif_function("avifCalcYUVCoefficients", None, vp, vp, vp,
                               vp)
    for matrix in MATRICES:
        for primaries in list(range(24)) + [255]:
            for full in (0, 1):
                img = lib.avifImageCreate(2, 2, 8, ar.YUV420)
                try:
                    ctypes.c_uint32.from_address(img + 16).value = full
                    ctypes.c_uint16.from_address(img + 104).value = primaries
                    ctypes.c_uint16.from_address(img + 108).value = matrix
                    yuv, yvu = vp(0), vp(0)
                    pick(img, ctypes.byref(yuv), ctypes.byref(yvu))
                    k = (ctypes.c_float * 3)()
                    calc(img, ctypes.byref(k, 0), ctypes.byref(k, 4),
                         ctypes.byref(k, 8))
                finally:
                    lib.avifImageDestroy(img)
                got = avif.libyuv_constants(matrix, full, primaries)
                want = names.get(yuv.value)
                assert got == (want and avif.LIBYUV_CONSTANTS[want]), (
                    matrix, full, primaries)
                kr, kb = avif.kr_kb(matrix, primaries)
                assert (kr, kb) == (np.float32(k[0]), np.float32(k[2])), (
                    matrix, primaries)
