"""AVIF against cv2 5.0 (libavif 1.4.2 over libaom 3.14.1): files
`cv2.imencode(".avif")` writes for seeded NumPy images (noise, flat,
ramps, a drawing, crops of the photo fixture; gray, colour and with an
alpha channel; sides 1 to 130 and a strip 4500 wide, which libaom splits
into tile columns; cv2's default quality and 0, 30, 70, 99) decode in the
host C library `csrc/av1.c` to libaom's own Y, U and V planes (libaom
driven over ctypes, `tests/avif_reference.py`), and `decode_image`,
`read_image` and `image_size` give `cv2.imdecode` / `cv2.imread` reversed
to RGB with tolerance 0. The plain decoder (`utils/av1.py`) equals the C
library on the smallest files; the inverse transforms, CDEF's direction
search and filter, and the deblocking filters of the C and plain sides
equal each other and libaom's C reference functions on seeded blocks.
What lies outside the contract (`utils/avif.py`'s docstring) is refused
by a ValueError that names it, on files cv2 writes (10 and 12 bits) and
on hand-edited containers and headers. A 20-case slice of
`tools/avif_search.py` runs here. Quality 100, palette, loop restoration
and intra block copy: `tests/test_torch_avif_tools.py`.
"""

import ctypes
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

import avif_reference as ar
from multiposenet_tpu_torch.tools import avif_search
from multiposenet_tpu_torch.utils import av1, avif, image_io
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(ar.LIBAOM is None,
                                reason="the opencv-python wheel's libaom "
                                       "is absent")

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
AVIF_FIXTURES = sorted(n for n in DIGESTS if n.endswith(".avif"))
PHOTO = cv2.imread(str(FIXTURES / "photo_480x640_q95_420.jpg"))[:, :, ::-1]


def _pixels(kind: str, h: int, w: int, channels: int = 3,
            seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "noise":
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    elif kind == "flat":
        rgb = np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8),
                              (h, w, 3)).copy()
    elif kind == "ramps":
        rgb = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                        (x + y) % 256], -1).astype(np.uint8)
    elif kind == "drawing":
        rgb = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
        for _ in range(5):
            p1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            p2 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            cv2.line(rgb, p1, p2, tuple(int(c) for c in
                                        rng.integers(0, 256, 3)), 2)
    elif kind == "photo_top":  # the photo's top left corner
        rgb = np.ascontiguousarray(PHOTO[:h, :w])
    else:  # a crop of the photo
        y0 = int(rng.integers(0, 480 - h + 1)) if h <= 480 else 0
        x0 = int(rng.integers(0, 640 - w + 1)) if w <= 640 else 0
        rgb = np.ascontiguousarray(
            cv2.resize(PHOTO, (w, h)) if h > 480 or w > 640
            else PHOTO[y0:y0 + h, x0:x0 + w])
    if channels == 1:
        return rgb.mean(axis=2).astype(np.uint8)
    if channels == 4:
        return np.dstack([rgb, rng.integers(0, 256, (h, w), dtype=np.uint8)])
    return rgb


# (kind, h, w, channels, quality or None for cv2's default)
CASES = (
    [("noise", s, s, 3, None) for s in (1, 2, 7, 8, 63, 64, 65, 97, 130)]
    + [("photo", 1, 97, 3, None), ("photo", 63, 2, 3, None),
       ("photo", 130, 65, 3, None), ("ramps", 7, 64, 3, None),
       ("noise", 97, 8, 3, None)]
    + [(k, 72, 88, 3, None) for k in ("noise", "flat", "ramps", "drawing",
                                      "photo")]
    + [(k, 72, 88, 3, q) for k in ("photo", "ramps") for q in (0, 30, 70, 99)]
    + [("photo", 65, 97, 1, None), ("photo", 40, 56, 1, 30),
       ("photo", 40, 56, 4, None), ("photo", 16, 4500, 3, None)])


def _case_id(case) -> str:
    kind, h, w, channels, q = case
    return f"{kind}-{h}x{w}x{channels}-q{'d' if q is None else q}"


@pytest.fixture(scope="module")
def files():
    return {case: ar.imencode_avif(_pixels(*case[:4]), case[4])
            for case in CASES}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_planes_and_pixels_equal_libaom_and_cv2(case, files, tmp_path):
    data = files[case]
    frame = avif.read_image(data).frame
    y, u, v, _ = avif.decode_planes_c(frame)
    want = ar.aom_planes(ar.primary_obus(data))
    for got, ref in zip((y, u, v), want):
        assert (got is None) == (ref is None)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
    rgb = ar.imdecode_rgb(data)
    np.testing.assert_array_equal(image_io.decode_image(data), rgb)
    path = tmp_path / "x.avif"
    path.write_bytes(data)
    np.testing.assert_array_equal(image_io.read_image(path),
                                  cv2.imread(str(path))[:, :, ::-1])
    assert image_io.image_size(path) == rgb.shape[:2]


def test_cases_reach_tile_columns_tx_select_gray_and_alpha(files):
    """The cases hold what they are there for: a frame in tile columns,
    frames coded with TX_MODE_SELECT, monochrome streams, an alpha item
    and delta q."""
    images = [avif.read_image(d) for d in files.values()]
    assert max(i.frame.header.tile_cols for i in images) >= 2
    assert sum(i.frame.header.tx_mode_select for i in images) >= 3
    assert sum(i.frame.seq.mono for i in images) == 2
    assert sum(i.alpha is not None for i in images) == 1
    assert any(i.frame.header.delta_q_present for i in images)
    drawing = avif.read_image(
        (FIXTURES / "avif_drawing_txsel_80x88.avif").read_bytes())
    assert drawing.frame.header.tx_mode_select


# Pillow's AVIF writer (libavif 1.3.0): (kind, h, w, channels, quality,
# speed). Its files reach tools cv2's files reach only below cv2's default
# speed 9 (directional modes with angle deltas and edge filtering and
# upsampling, filter intra, CFL, Paeth, ADST and identity transform types,
# 64-point transforms).
PILLOW_CASES = [("photo", 64, 80, 3, 60, 6), ("photo", 97, 65, 3, 80, 8),
                ("photo", 33, 17, 3, 90, 6), ("photo", 120, 72, 1, 40, 7),
                ("ramps", 72, 88, 3, 20, 9), ("noise", 40, 56, 4, 50, 10),
                ("photo", 160, 144, 3, 30, 5), ("noise", 48, 64, 3, 20, 6),
                ("photo_top", 61, 164, 3, 67, 5)]


@pytest.mark.parametrize("case", PILLOW_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_pillow_files_equal_libaom_and_cv2(case):
    """Files cv2 did not write, for the tools they reach: C planes =
    libaom's, pixels = cv2's (and plain = C on the small ones)."""
    kind, h, w, channels, quality, speed = case
    data = ar.pillow_avif(_pixels(kind, h, w, channels), quality, speed)
    frame = avif.read_image(data).frame
    y, u, v, _ = avif.decode_planes_c(frame)
    for got, ref in zip((y, u, v), ar.aom_planes(ar.primary_obus(data))):
        assert (got is None) == (ref is None)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(image_io.decode_image(data),
                                  ar.imdecode_rgb(data))
    if h * w <= 2400:
        for a, b in zip((y, u, v), av1.decode_planes_plain(frame)):
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_pillow_files_reach_tools_cv2_files_do_not():
    """The Pillow cases hold what they are there for."""
    totals = 0
    for kind, h, w, channels, quality, speed in PILLOW_CASES:
        data = ar.pillow_avif(_pixels(kind, h, w, channels), quality, speed)
        totals = totals + avif.decode_planes_c(avif.read_image(data).frame)[3]
    reached = {n for n, v in zip(avif.STAT_NAMES, totals) if v}
    assert {"uv_mode_13", "edge_filter", "edge_upsample", "y_mode_12",
            "tx_type_3", "tx_type_11"} <= reached, reached
    assert any(n.startswith("filter_intra_") for n in reached)
    assert any(n.startswith("y_mode_") and int(n[7:]) in range(3, 9)
               for n in reached)


def test_palette_is_refused_by_name_on_a_screen_content_file():
    """Pillow's writer tuned for screen content uses palette mode; cv2
    reads the file, and the port reads it as cv2 does (palette is read
    since cv2's own files use it: C planes = libaom's, C = plain)."""
    rng = np.random.default_rng(3)
    colours = rng.integers(0, 256, (4, 3), dtype=np.uint8)
    img = colours[rng.integers(0, 4, (16, 16)).repeat(4, 0).repeat(4, 1)]
    data = ar.pillow_avif(img, 60, 6, **{"tune-content": "screen"})
    frame = avif.read_image(data).frame
    assert frame.header.screen_content
    y, u, v, stats = avif.decode_planes_c(frame)
    assert stats[avif.STAT_NAMES.index("palette_y")] > 0
    for got, want, plain in zip((y, u, v),
                                ar.aom_planes(ar.primary_obus(data)),
                                av1.decode_planes_plain(frame)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(plain, got)
    np.testing.assert_array_equal(image_io.decode_image(data),
                                  ar.imdecode_rgb(data))
    np.testing.assert_array_equal(image_io.decode_image_plain(data),
                                  ar.imdecode_rgb(data))


@pytest.mark.parametrize("name", ["avif_photo_480x640.avif",
                                  "avif_drawing_txsel_80x88.avif",
                                  "avif_gray_40x56.avif"])
def test_planes_before_cdef_equal_libaoms(name):
    """The deblocked frame before CDEF (C, and plain on the small files)
    equals libaom's decode with CDEF skipped (its control 267)."""
    data = (FIXTURES / name).read_bytes()
    frame = avif.read_image(data).frame
    got = avif.decode_planes_c(frame, cdef=False)[:3]
    want = ar.aom_planes(ar.primary_obus(data), skip_loop_filter=True)
    full = ar.aom_planes(ar.primary_obus(data))
    assert not np.array_equal(want[0], full[0])  # CDEF changed the frame
    planes = [got]
    if len(data) < 2000:
        planes.append(av1.decode_planes_plain(frame, cdef=False))
    for decoded in planes:
        for a, b in zip(decoded, want):
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[1] * c[2] <= 1000 or c[3] == 4],
                         ids=_case_id)
def test_plain_decoder_equals_c(case, files):
    frame = avif.read_image(files[case]).frame
    c = avif.decode_planes_c(frame)[:3]
    plain = av1.decode_planes_plain(frame)
    for a, b in zip(c, plain):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", AVIF_FIXTURES)
def test_fixtures_decode_to_cv2_digest(name):
    """The committed files (written by cv2; their digests are what the
    card's machine checks): C = digest, and plain = C on the smallest."""
    import hashlib

    data = (FIXTURES / name).read_bytes()
    rgb = image_io.decode_image(data)
    assert list(rgb.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
        DIGESTS[name]["rgb_sha256"]
    if rgb.shape[0] * rgb.shape[1] <= 2400:
        np.testing.assert_array_equal(image_io.decode_image_plain(data), rgb)


# --- stages ------------------------------------------------------------------


def _c_lib():
    lib = avif.library()
    lib.av1_inverse_transform_add.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_int]
    lib.av1_cdef_block.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p, ctypes.c_int]
    lib.av1_cdef_find_dir.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.av1_lf_line.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    lib.av1_edge_filter.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
    lib.av1_edge_upsample.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.av1_dr_predict.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.av1_filter_intra_predict.argtypes = [
        ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [
        ctypes.c_int]
    lib.av1_nondir_predict.argtypes = [
        ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 3
    lib.av1_cfl_predict.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p] + [ctypes.c_int] * 6
    return lib


@pytest.fixture(scope="module")
def aom_ready():
    """libaom's dispatch tables are set when a decoder is created."""
    ar.aom_planes(ar.primary_obus(
        (FIXTURES / "avif_odd_33x17.avif").read_bytes()))


TX_NAMES = ("4x4", "8x8", "16x16", "32x32", "64x64", "4x8", "8x4", "8x16",
            "16x8", "16x32", "32x16", "32x64", "64x32", "4x16", "16x4",
            "8x32", "32x8", "16x64", "64x16")


@pytest.mark.parametrize("tx", range(19), ids=TX_NAMES)
def test_inverse_transforms_c_plain_and_libaom_agree(tx, aom_ready):
    """Every transform type a size allows (16 up to 16 points, DCT and
    identity at 32, DCT at 64), on sparse and dense seeded coefficients
    up to the 16-bit clamps: C = plain = av1_inv_txfm2d_add_<size>_c."""
    lib = _c_lib()
    w, h = map(int, TX_NAMES[tx].split("x"))
    ref = ar.libaom_function(f"av1_inv_txfm2d_add_{TX_NAMES[tx]}_c", None,
                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int)
    cw, ch = min(w, 32), min(h, 32)
    types = [0] if max(w, h) == 64 else [0, 9] if max(w, h) == 32 \
        else list(range(16))
    rng = np.random.default_rng(tx)
    for tx_type in types:
        for amp in (60, 3000, 40000):
            coef = np.zeros(cw * ch, np.int32)
            k = int(rng.integers(1, min(cw * ch, 24) + 1))
            coef[rng.choice(cw * ch, k, replace=False)] = rng.integers(
                -amp, amp + 1, k)
            dst = rng.integers(0, 256, (h, w)).astype(np.uint8)
            want = dst.astype(np.uint16)
            ref(coef.ctypes.data, want.ctypes.data, w, tx_type, 8)
            got = dst.copy()
            lib.av1_inverse_transform_add(coef.ctypes.data, tx, tx_type,
                                          got.ctypes.data, w)
            plain = dst.copy()
            av1.inverse_transform_add(coef, tx, tx_type, plain)
            np.testing.assert_array_equal(got, want, err_msg=str(tx_type))
            np.testing.assert_array_equal(plain, got, err_msg=str(tx_type))


def test_cdef_c_plain_and_libaom_agree(aom_ready):
    """The direction search (C = plain = cdef_find_dir_c) and the filter
    of 8x8 luma and 4x4 chroma blocks at every strength, damping and
    direction on seeded blocks, next to the frame's edges too (C =
    plain)."""
    lib = _c_lib()
    find_dir = ar.libaom_function("cdef_find_dir_c", ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int)
    rng = np.random.default_rng(7)
    for trial in range(40):
        img = rng.integers(0, 256, (8, 8)).astype(np.uint8)
        if trial % 2:
            img = (np.add.outer(np.arange(8) * rng.integers(-9, 10),
                                np.arange(8) * rng.integers(-9, 10)) + 128
                   + rng.integers(-3, 4, (8, 8))).clip(0, 255).astype(
                np.uint8)
        var = ctypes.c_int32()
        d = lib.av1_cdef_find_dir(img.ctypes.data, 8, ctypes.byref(var))
        var_ref = ctypes.c_int32()
        img16 = img.astype(np.uint16)
        assert find_dir(img16.ctypes.data, 8, ctypes.byref(var_ref), 0) == d
        assert var.value == var_ref.value
        assert av1.cdef_find_dir(img) == (d, var.value)
    for trial in range(24):
        src = rng.integers(0, 256, (20, 20)).astype(np.uint8)
        size = 8 if trial % 3 else 4
        y0, x0 = (int(v) for v in rng.integers(0, 20 - size + 1, 2))
        pri, sec = int(rng.integers(0, 16)), int((0, 1, 2, 4)[trial % 4])
        damping, d = int(rng.integers(2, 7)), int(rng.integers(0, 8))
        out = np.zeros((size, size), np.uint8)
        lib.av1_cdef_block(src.ctypes.data, 20, 18, 19, y0, x0, size, size,
                           pri, sec, damping, d, out.ctypes.data, size)
        plain = av1.cdef_block(src, y0, x0, size, size, pri, sec, damping, d,
                               (18, 19))
        np.testing.assert_array_equal(out, plain)


@pytest.mark.parametrize("plane,size,ref_name",
                         [(0, 4, "aom_lpf_vertical_4_c"),
                          (0, 8, "aom_lpf_vertical_8_c"),
                          (0, 16, "aom_lpf_vertical_14_c"),
                          (1, 4, "aom_lpf_vertical_4_c"),
                          (1, 8, "aom_lpf_vertical_6_c")])
def test_deblocking_c_plain_and_libaom_agree(plane, size, ref_name,
                                             aom_ready):
    """One edge's lines at every level and sharpness, on seeded smooth
    and rough lines: C = plain = libaom's aom_lpf_vertical_<n>_c."""
    lib = _c_lib()
    ref = ar.libaom_function(ref_name, None, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p)
    rng = np.random.default_rng(size + plane)
    for trial in range(60):
        lvl, sharp = int(rng.integers(1, 64)), int(rng.integers(0, 8))
        shift = 2 if sharp > 4 else 1 if sharp > 0 else 0
        limit = min(max(lvl >> shift, 1), 9 - sharp) if sharp else \
            max(1, lvl >> shift)
        blimit, thresh = 2 * (lvl + 2) + limit, lvl >> 4
        base = int(rng.integers(0, 256))
        spread = (1, 4, 20, 90)[trial % 4]
        line = np.clip(base + rng.integers(-spread, spread + 1, 16)
                       + (np.arange(16) >= 8) * int(rng.integers(-12, 13)),
                       0, 255).astype(np.uint8)
        got = line.copy()
        lib.av1_lf_line(got.ctypes.data, plane, limit, blimit, thresh, size)
        plain = av1.lf_edge(line.tolist(), plane, limit, blimit, thresh,
                            size)
        rows = np.tile(line, (4, 1))
        lim = np.array([limit], np.uint8)
        bl = np.array([blimit], np.uint8)
        th = np.array([thresh], np.uint8)
        ref(rows[:, 8:].ctypes.data, 16, bl.ctypes.data, lim.ctypes.data,
            th.ctypes.data)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, rows[0])


class _Edges:
    """An intra edge as both sides hold it: uint8 for libaom (a pointer
    at index 0, 16 entries before it) and int32 for csrc/av1.c, and the
    plain decoder's view."""

    def __init__(self, values: np.ndarray):
        self.u8 = np.zeros(len(values) + 48, np.uint8)
        self.u8[16:16 + len(values)] = values
        self.i32 = self.u8.astype(np.int32)

    def ptr(self, kind: str = "u8"):
        arr = self.u8 if kind == "u8" else self.i32
        return arr.ctypes.data + 16 * arr.itemsize

    def plain(self):
        edge = av1._Edge(len(self.i32))
        edge.a[:len(self.i32)] = self.i32.tolist()
        return edge


def _edge_values(rng, n: int, smooth: bool) -> np.ndarray:
    if smooth:
        return np.clip(rng.integers(0, 256) + np.cumsum(
            rng.integers(-6, 7, n)), 0, 255).astype(np.uint8)
    return rng.integers(0, 256, n).astype(np.uint8)


def test_intra_edge_filter_and_upsampling_c_plain_and_libaom_agree(
        aom_ready):
    """The edge filter at strengths 1-3 and the 2x upsampling (C = plain
    = av1_filter_intra_edge_c, av1_upsample_intra_edge_c)."""
    lib = _c_lib()
    filt = ar.libaom_function("av1_filter_intra_edge_c", None,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_int)
    up = ar.libaom_function("av1_upsample_intra_edge_c", None,
                            ctypes.c_void_p, ctypes.c_int)
    rng = np.random.default_rng(11)
    for trial in range(60):
        n = int(rng.integers(2, 129))
        e = _Edges(_edge_values(rng, n + 1, trial % 2 == 0))
        strength = trial % 3 + 1
        plain = e.plain()
        filt(e.ptr() - 1, n, strength)
        lib.av1_edge_filter(e.ptr("i32"), n, strength)
        av1.edge_filter(plain, n, strength)
        np.testing.assert_array_equal(e.u8, e.i32)
        np.testing.assert_array_equal(e.i32, plain.a[:len(e.i32)])
    for trial in range(40):
        n = int(rng.integers(1, 17))  # w + h <= 16 where edges upsample
        e = _Edges(_edge_values(rng, n + 1, trial % 2 == 0)[1:])
        e.u8[15] = e.i32[15] = int(rng.integers(0, 256))
        plain = e.plain()
        up(e.ptr(), n)
        lib.av1_edge_upsample(e.ptr("i32"), n)
        av1.edge_upsample(plain, n)
        np.testing.assert_array_equal(e.u8, e.i32)
        np.testing.assert_array_equal(e.i32, plain.a[:len(e.i32)])


# Every angle the 8 directional modes reach with their deltas.
ANGLES = sorted({a + 3 * d for a in (45, 67, 90, 113, 135, 157, 180, 203)
                 for d in range(-3, 4)})
BLOCKS = [(w, h) for w in (4, 8, 16, 32, 64) for h in (4, 8, 16, 32, 64)
          if max(w, h) <= 4 * min(w, h)]


@pytest.mark.parametrize("angle", ANGLES)
def test_directional_prediction_c_plain_and_libaom_agree(angle, aom_ready):
    """Zones 1-3 at every block shape, with and without upsampled edges
    (C = plain = av1_dr_prediction_z1/z2/z3_c)."""
    lib = _c_lib()
    deriv = av1.table("dr_intra_derivative")
    args = [ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
    if angle < 90:
        ref = ar.libaom_function("av1_dr_prediction_z1_c", None, *args,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int)
    elif 90 < angle < 180:
        ref = ar.libaom_function("av1_dr_prediction_z2_c", None, *args,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int)
    elif angle > 180:
        ref = ar.libaom_function("av1_dr_prediction_z3_c", None, *args,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int)
    else:
        ref = None
    dx = int(deriv[angle] if angle < 90 else deriv[180 - angle]
             if 90 < angle < 180 else 1)
    dy = int(deriv[angle - 90] if 90 < angle < 180 else deriv[270 - angle]
             if angle > 180 else 1)
    rng = np.random.default_rng(angle)
    for w, h in BLOCKS:
        for up_a, up_l in ((0, 0), (1, 0), (0, 1), (1, 1)):
            if (up_a or up_l) and w + h > 16:
                continue
            up_a = up_a if angle < 180 else 0
            up_l = up_l if angle > 90 else 0
            above = _Edges(_edge_values(rng, 2 * (w + h) + 32, True))
            left = _Edges(_edge_values(rng, 2 * (w + h) + 32, False))
            for e in (above, left):
                e.u8[:16] = e.i32[:16] = rng.integers(0, 256, 16)
            got = np.zeros((h, w), np.uint8)
            lib.av1_dr_predict(got.ctypes.data, w, w, h, above.ptr("i32"),
                               left.ptr("i32"), up_a, up_l, angle)
            plain = av1.dr_predict(above.plain(), left.plain(), w, h, up_a,
                                   up_l, angle)
            np.testing.assert_array_equal(got, plain, err_msg=f"{w}x{h}")
            if ref is None:
                continue
            want = np.zeros((h, w), np.uint8)
            if angle < 90:
                ref(want.ctypes.data, w, w, h, above.ptr(), left.ptr(), up_a,
                    dx, dy)
            elif angle < 180:
                ref(want.ctypes.data, w, w, h, above.ptr(), left.ptr(), up_a,
                    up_l, dx, dy)
            else:
                ref(want.ctypes.data, w, w, h, above.ptr(), left.ptr(), up_l,
                    dx, dy)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{w}x{h} {up_a}{up_l}")


def test_filter_intra_and_other_modes_c_plain_and_libaom_agree(aom_ready):
    """Filter intra's five modes up to 32x32 (av1_filter_intra_predictor_c)
    and DC (each availability), smooth, smooth V, smooth H and Paeth at
    every block shape (aom_*_predictor_<w>x<h>_c): C = plain = libaom."""
    lib = _c_lib()
    rng = np.random.default_rng(5)
    tx_of = {tuple(map(int, n.split("x"))): i for i, n in enumerate(TX_NAMES)}
    fi = ar.libaom_function("av1_filter_intra_predictor_c", None,
                            ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int)
    names = {av1.DC_PRED: ("dc", 1, 1), 100: ("dc_left", 1, 0),
             101: ("dc_top", 0, 1), 102: ("dc_128", 0, 0),
             av1.SMOOTH_PRED: ("smooth", 1, 1),
             av1.SMOOTH_V_PRED: ("smooth_v", 1, 1),
             av1.SMOOTH_H_PRED: ("smooth_h", 1, 1),
             av1.PAETH_PRED: ("paeth", 1, 1)}
    for w, h in BLOCKS:
        above = _Edges(_edge_values(rng, w + h + 16, True))
        left = _Edges(_edge_values(rng, w + h + 16, False))
        above.u8[15] = above.i32[15] = left.u8[15] = left.i32[15] =             int(rng.integers(0, 256))
        if max(w, h) <= 32:
            for mode in range(5):
                got = np.zeros((h, w), np.uint8)
                lib.av1_filter_intra_predict(got.ctypes.data, w, w, h,
                                             above.ptr("i32"),
                                             left.ptr("i32"), mode)
                want = np.zeros((h, w), np.uint8)
                fi(want.ctypes.data, w, tx_of[(w, h)], above.ptr(),
                   left.ptr(), mode)
                plain = av1.filter_intra_predict(above.plain(), left.plain(),
                                                 w, h, mode)
                np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h}")
                np.testing.assert_array_equal(got, plain)
        for mode, (name, have_left, have_above) in names.items():
            ref = ar.libaom_function(f"aom_{name}_predictor_{w}x{h}_c", None,
                                     ctypes.c_void_p, ctypes.c_ssize_t,
                                     ctypes.c_void_p, ctypes.c_void_p)
            m = av1.DC_PRED if mode >= 100 else mode
            got = np.zeros((h, w), np.uint8)
            lib.av1_nondir_predict(got.ctypes.data, w, w, h, above.ptr("i32"),
                                   left.ptr("i32"), m, have_left, have_above)
            want = np.zeros((h, w), np.uint8)
            ref(want.ctypes.data, w, above.ptr(), left.ptr())
            plain = av1.nondir_predict(above.plain(), left.plain(), w, h, m,
                                       have_left, have_above)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {w}x{h}")
            np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (4, 8), (8, 4),
                                 (8, 16), (16, 8), (4, 16), (16, 4)])
def test_chroma_from_luma_c_plain_and_libaom_agree(w, h, aom_ready):
    """CFL on a chroma block over fully decoded luma, at every alpha
    (C = plain = libaom's subsample, subtract-average and predict
    functions), and with the luma cut short (C = plain)."""
    lib = _c_lib()
    sub = ar.libaom_function(f"cfl_subsample_lbd_420_{2 * w}x{2 * h}_c",
                             None, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_void_p)
    avg = ar.libaom_function(f"cfl_subtract_average_{w}x{h}_c", None,
                             ctypes.c_void_p, ctypes.c_void_p)
    pred = ar.libaom_function(f"cfl_predict_lbd_{w}x{h}_c", None,
                              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int)
    rng = np.random.default_rng(w * 100 + h)
    luma = rng.integers(0, 256, (2 * h, 2 * w)).astype(np.uint8)
    q3 = np.zeros(32 * 32, np.uint16)
    ac = np.zeros(32 * 32, np.int16)
    sub(luma.ctypes.data, 2 * w, q3.ctypes.data)
    avg(q3.ctypes.data, ac.ctypes.data)
    for alpha in range(-16, 17):
        dc = np.full((h, w), int(rng.integers(0, 256)), np.uint8)
        got, want = dc.copy(), dc.copy()
        lib.av1_cfl_predict(got.ctypes.data, w, luma.ctypes.data, 2 * w, w, h,
                            2 * w, 2 * h, alpha)
        pred(ac.ctypes.data, want.ctypes.data, w, alpha)
        np.testing.assert_array_equal(got, want, err_msg=str(alpha))
        np.testing.assert_array_equal(
            av1.cfl_predict(dc, luma, 2 * w, 2 * h, alpha), got)
    cut = (max(2, 2 * w - 4), max(2, 2 * h - 6))
    got = dc.copy()
    lib.av1_cfl_predict(got.ctypes.data, w, luma.ctypes.data, 2 * w, w, h,
                        cut[0], cut[1], 5)
    np.testing.assert_array_equal(av1.cfl_predict(dc, luma, *cut, 5), got)


# --- refusals and the container ----------------------------------------------


def _refused(data: bytes, name: str) -> None:
    with pytest.raises(ValueError, match=name):
        image_io.decode_image(data)
    with pytest.raises(ValueError, match=name):
        image_io.decode_image_plain(data)


def test_cv2_files_outside_the_contract_are_refused_by_name():
    """Files once outside the contract, now read as cv2 reads them:
    quality 100 (profile 1, 4:4:4, lossless; gray lossless; the rest of
    it in tests/test_torch_avif_tools.py) and 10 or 12 bits from uint16
    pixels (here values past 2^depth - 1, which cv2's colour writer
    takes; tests/test_torch_avif_highbd.py has the rest)."""
    rgb = _pixels("photo", 24, 40)
    for data in (ar.imencode_avif(rgb, 100), ar.imencode_avif(rgb[:, :, 0],
                                                               100)):
        assert avif.read_image(data).frame.header.lossless
        np.testing.assert_array_equal(image_io.decode_image(data),
                                      ar.imdecode_rgb(data))
        np.testing.assert_array_equal(image_io.decode_image_plain(data),
                                      ar.imdecode_rgb(data))
    for depth in (10, 12):
        ok, buf = cv2.imencode(".avif", rgb.astype(np.uint16) * 257,
                               [cv2.IMWRITE_AVIF_DEPTH, depth])
        assert ok and cv2.imdecode(buf, cv2.IMREAD_COLOR) is not None
        data = buf.tobytes()
        assert avif.read_image(data).frame.seq.bit_depth == depth
        np.testing.assert_array_equal(image_io.decode_image(data),
                                      ar.imdecode_rgb(data))
        np.testing.assert_array_equal(image_io.decode_image_plain(data),
                                      ar.imdecode_rgb(data))


# The headers that signal what the port now reads (cv2's own files use
# each): the field that shows the rewritten header parsed. Only the header
# is checked here; real cv2 files that use each are decoded to libaom's
# planes and cv2's pixels in tests/test_torch_avif_tools.py (restoration:
# test_loop_restoration_files_equal_libaom_and_cv2; intrabc:
# test_intra_block_copy_file_equals_libaom_and_cv2; lossless, 444 and
# sb128: test_quality_100_is_read_lossless; profile 2 at 12 bits:
# tests/test_torch_avif_highbd.py, test_cv2_files_equal_libaom_and_cv2;
# 4:4:4 lossy frames and 4:2:2: tests/test_torch_avif_subsampling.py;
# segmentation and film grain: tests/test_torch_avif_grain.py).
READ_HEADERS = {"segmentation": lambda f: f.header.segmentation == 1,
                "film_grain": lambda f: f.header.grain is not None,
                "restoration": lambda f: f.header.lr_type == (3, 0, 0),
                "intrabc": lambda f: f.header.allow_intrabc == 1,
                "lossless": lambda f: f.header.lossless == 1,
                "sb128": lambda f: f.seq.sb128 == 1,
                "444": lambda f: (f.seq.ssx, f.header.lossless) == (0, 1),
                "profile2_12bit": lambda f: (f.seq.profile, f.seq.bit_depth,
                                             f.seq.ssx, f.seq.ssy)
                == (2, 12, 1, 1),
                "444_lossy": lambda f: (f.seq.ssx, f.seq.ssy,
                                        f.header.lossless) == (0, 0, 0),
                "profile2_422": lambda f: (f.seq.profile, f.seq.ssx,
                                           f.seq.ssy) == (2, 1, 0)}


@pytest.mark.parametrize("what", ["superres", "segmentation", "restoration",
                                  "film_grain", "intrabc", "lossless",
                                  "profile2_12bit", "sb128", "444",
                                  "inter_frame", "show_existing",
                                  "444_lossy", "profile2_422"])
def test_headers_outside_the_contract_are_refused_by_name(what):
    """A cv2 file's stream with one header rewritten (the rest kept):
    each feature outside the contract refused where the header signals
    its use; the headers of segmentation, film grain, loop restoration,
    intra block copy, lossless frames, 128x128 superblocks, lossless and
    lossy 4:4:4, profile 2 at 12 bits and 4:2:2 (READ_HEADERS) parse (the
    files that use them are decoded in test_torch_avif_grain.py,
    test_torch_avif_tools.py, test_torch_avif_highbd.py and
    test_torch_avif_subsampling.py)."""
    obus = ar.primary_obus((FIXTURES / "avif_odd_33x17.avif").read_bytes())
    seq, frame, extra = {}, {}, ()
    name = {"superres": "superres",
            "inter_frame": "only a shown key frame",
            "show_existing": "show_existing_frame"}.get(what)
    if what in ("superres", "restoration", "film_grain"):
        seq = {what: 1}
        extra = (what,)
    elif what in ("segmentation", "intrabc"):
        extra = (what,)
    elif what == "lossless":
        frame = {"base_q": 0, "dq": (0, 0, 0, 0, 0)}
    elif what == "profile2_12bit":
        seq = {"profile": 2, "bit_depth": 12}
    elif what == "profile2_422":
        seq = {"profile": 2, "ssx": 1, "ssy": 0}
    elif what == "sb128":
        seq = {"sb128": 1}
    elif what == "444":
        seq = {"profile": 1, "ssx": 0, "ssy": 0}
        frame = {"base_q": 0, "dq": (0, 0, 0, 0, 0)}
    elif what == "444_lossy":
        seq = {"profile": 1, "ssx": 0, "ssy": 0}
    stream = ar.rewrite_frame(obus, seq, frame, extra)
    if what in READ_HEADERS:
        assert READ_HEADERS[what](avif.read_frame(stream))
        return
    if what in ("inter_frame", "show_existing"):
        stream = ar.rewrite_frame(obus, {"reduced": 0})
        kinds = avif.read_obus(stream)
        payload = bytearray(kinds[-1][1])
        payload[0] = 0x80 if what == "show_existing" else 0x30
        stream = stream[:-len(payload)] + bytes(payload)
    with pytest.raises(ValueError, match=name):
        avif.read_frame(stream)


@pytest.mark.parametrize("name", ["avif_noise_64x80.avif",
                                  "avif_odd_33x17.avif",
                                  "avif_photo_480x640.avif"])
def test_damaged_tile_bytes_read_or_refused_as_cv2(name):
    """A byte of a fixture's AV1 data changed, at seeded places: cv2 reads
    the file (then the port reads the same pixels) or returns no image
    (then the port refuses it: libaom's reader overflow and trailing-bits
    checks); plain = C where the file is small."""
    data = (FIXTURES / name).read_bytes()
    start = data.index(b"mdat") + 4
    rng = np.random.default_rng(len(data))
    refused = 0
    for pos in rng.integers(start, len(data), 12):
        damaged = bytearray(data)
        damaged[int(pos)] ^= int(rng.integers(1, 256))
        damaged = bytes(damaged)
        want = ar.imdecode_rgb(damaged)
        readers = [image_io.decode_image]
        if len(data) < 3000:
            readers.append(image_io.decode_image_plain)
        for read in readers:
            if want is None:
                with pytest.raises(ValueError):
                    read(damaged)
            else:
                np.testing.assert_array_equal(read(damaged), want)
        refused += want is None
    assert refused >= 8


def test_full_syntax_headers_read_as_the_reduced_ones():
    """The same frame under a sequence header and a frame header in full
    syntax (reduced_still_picture_header 0): libaom's planes."""
    for name in ("avif_drawing_txsel_80x88.avif", "avif_gray_40x56.avif"):
        obus = ar.primary_obus((FIXTURES / name).read_bytes())
        full = ar.rewrite_frame(obus, {"reduced": 0})
        assert full != obus
        y, u, v, _ = avif.decode_planes_c(avif.read_frame(full))
        for got, want in zip((y, u, v), ar.aom_planes(full)):
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_array_equal(got, want)


def test_container_edits_as_cv2_reads_them():
    """What cv2 does with hand-edited containers: irot, imir and clap are
    not applied; the data in an idat box (construction method 1) and a
    file whose major brand is mif1 read as the original; an Exif item
    (its TIFF header at byte 481, within the 500 bytes cv2's signature
    check parses) is read with its orientation applied, as cv2 reads it;
    an alpha item that does not decode, an item retyped grid with no
    grid payload and the avis brand with no moov box are no image to
    cv2, and the port refuses each by name, as it refuses an ispe that
    differs from the frame (cv2 returns an image of the ispe's size).
    Real grids, Exif items and sequences:
    tests/test_torch_avif_container.py."""
    data = (FIXTURES / "avif_odd_33x17.avif").read_bytes()
    want = ar.imdecode_rgb(data)
    clap = b"".join(x.to_bytes(4, "big") for x in (9, 1, 8, 1, 0, 1, 0, 1))
    for edited in (ar.edit_avif(data, add_props=[(b"irot", b"\x01", True)]),
                   ar.edit_avif(data, add_props=[(b"imir", b"\x01", True)]),
                   ar.edit_avif(data, add_props=[(b"clap", clap, True)]),
                   ar.edit_avif(data, idat=True),
                   ar.edit_avif(data, brand=b"mif1")):
        np.testing.assert_array_equal(ar.imdecode_rgb(edited), want)
        np.testing.assert_array_equal(image_io.decode_image(edited), want)
    tiff = (b"II*\x00\x08\x00\x00\x00\x01\x00\x12\x01\x03\x00\x01\x00\x00"
            b"\x00\x06\x00\x00\x00\x00\x00\x00\x00")
    ispe = b"\0\0\0\0" + (16).to_bytes(4, "big") + (8).to_bytes(4, "big")
    edited = ar.edit_avif(data, exif=tiff)
    assert edited.index(tiff) == 481
    turned = ar.imdecode_rgb(edited)
    assert turned.shape == (want.shape[1], want.shape[0], 3)
    np.testing.assert_array_equal(image_io.decode_image(edited), turned)
    np.testing.assert_array_equal(image_io.decode_image_plain(edited),
                                  turned)
    for edited, name in (
            (ar.edit_avif(data, alpha=data[-30:]), "AV1"),
            (ar.edit_avif(data, primary_type=b"grid"), "grid"),
            (ar.edit_avif(data, brand=b"avis"), "avis"),
            (ar.edit_avif(data, drop_props=(b"ispe",),
                          add_props=[(b"ispe", ispe, False)]), "ispe")):
        if name != "ispe":
            assert ar.imdecode_rgb(edited) is None, name
        with pytest.raises(ValueError, match=name):
            image_io.decode_image(edited)


def test_search_slice_finds_no_difference():
    """The first 20 cases of tools/avif_search.py's default seed."""
    result = avif_search.search(avif_search.cases(20, 0))
    assert result["cases"] == 20
    assert result["differences"] == []
