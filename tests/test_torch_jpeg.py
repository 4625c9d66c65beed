"""The port's JPEG decoders against cv2: `utils/jpeg.py` (plain NumPy) and
`csrc/image_codec.c decode_jpeg` (the host C library, through
`utils/image_codec.py`) both equal `cv2.imdecode(buf, IMREAD_COLOR)`
reversed to RGB bit for bit, on cv2-written JPEGs of every sampling it
writes (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, gray), several qualities and
sizes down to 1x1, optimised Huffman tables and restart intervals; and on
streams whose quantisation tables were scaled up until the IDCT leaves
its range, where libjpeg-turbo's SIMD arithmetic (which OpenCV 5.0 runs
on x86) and its C version part ways. `read_image` applies the Exif
orientation as cv2 does, from a JPEG APP1 block or a PNG eXIf chunk, in
both byte orders, and takes a malformed block as orientation 1. Past
baseline the C library alone reads progressive JPEGs (every sampling,
restart intervals), Adobe RGB, CMYK and YCCK, bit for bit with cv2, and
a file cut inside its scan data as `cv2.imread` fills it, while bytes
cut so are refused as `cv2.imdecode` refuses them. Each mode not read
raises a ValueError that names it. The committed fixtures
(tests/fixtures/images) still equal the installed cv2, and the host
library is built into `_build/` and raises with the compiler's log when
the source does not compile. NumPy decodes stay at 64x64 or less; larger
sizes go through the C library only.
"""

import hashlib
import json
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.utils import image_codec, image_io, jpeg

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}
SIZES = [(3, 3), (4, 4), (16, 16), (37, 53), (97, 133)]
PLAIN_MAX = 64 * 64  # the NumPy decoder's largest image in these tests


def _content(h: int, w: int, kind: str, seed: int) -> np.ndarray:
    """`noise`: uniform noise; `edges`: gradients with hard-edged stripes
    of 0 and 255, which ring past the sample range at low quality."""
    rng = np.random.RandomState(seed)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(np.sin(xx / (3.0 + c)) + np.cos(yy / (5.0 + c))) * 60
                    + 128 + rng.randint(0, 20, (h, w)) for c in range(3)],
                   -1)
    img[(yy // 7 + xx // 5) % 3 == 0] = 255
    img[(yy // 5 + xx // 9) % 4 == 0] = 0
    return np.clip(img, 0, 255).astype(np.uint8)


def _encode(img: np.ndarray, quality: int, sampling: str, *extra) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, *extra]
    if sampling == "gray":
        img = img[..., 0]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _cv2(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR)[:, :, ::-1]


def _assert_decoders_match_cv2(data: bytes, plain: bool = True) -> None:
    want = _cv2(data)
    got = image_codec.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if plain:
        np.testing.assert_array_equal(jpeg.decode_pixels(data), want)


@pytest.mark.parametrize("kind", ["edges", "noise"])
@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING) + ["gray"])
def test_decoders_match_cv2(sampling, quality, kind):
    for h, w in SIZES:
        img = _content(h, w, kind, seed=h * w + quality)
        data = _encode(img, quality, sampling)
        _assert_decoders_match_cv2(data, plain=h * w <= PLAIN_MAX)


@pytest.mark.parametrize("extra", [
    (cv2.IMWRITE_JPEG_OPTIMIZE, 1),
    (cv2.IMWRITE_JPEG_RST_INTERVAL, 1),
    (cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
    (cv2.IMWRITE_JPEG_RST_INTERVAL, 2, cv2.IMWRITE_JPEG_OPTIMIZE, 1),
], ids=["optimize", "rst1", "rst3", "rst2_optimize"])
@pytest.mark.parametrize("sampling", ["420", "422", "gray"])
def test_decoders_match_cv2_optimised_tables_and_restarts(sampling, extra):
    for h, w in [(16, 16), (37, 53), (61, 45), (97, 133)]:
        img = _content(h, w, "edges", seed=h + w)
        data = _encode(img, 90, sampling, *extra)
        if extra[:2] != (cv2.IMWRITE_JPEG_OPTIMIZE, 1) and h * w > 256:
            assert b"\xff\xd0" in data  # restart markers really written
        _assert_decoders_match_cv2(data, plain=h * w <= PLAIN_MAX)


@pytest.mark.parametrize("sampling", list(SAMPLING) + ["gray"])
def test_c_decoder_matches_cv2_at_480x640(sampling):
    img = _content(480, 640, "edges", seed=1)
    for quality in (75, 95):
        _assert_decoders_match_cv2(_encode(img, quality, sampling),
                                   plain=False)


def _dqt_tables(data: bytes):
    """(payload start, payload end) of each DQT segment before SOS."""
    pos, out = 2, []
    while data[pos + 1] != 0xDA:
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] == 0xDB:
            out.append((pos + 4, pos + 2 + length))
        pos += 2 + length
    return out


def _scaled_tables(data: bytes, factor: int, sixteen_bit: bool) -> bytes:
    """`data` with every quantisation value multiplied by `factor`
    (clipped), as 8-bit tables or rewritten as 16-bit ones."""
    out, last = bytearray(), 0
    for start, end in _dqt_tables(data):
        body = bytearray()
        pos = start
        while pos < end:
            tq, values = data[pos] & 15, data[pos + 1:pos + 65]
            if sixteen_bit:
                body += bytes([0x10 | tq]) + b"".join(
                    struct.pack(">H", min(65535, v * factor))
                    for v in values)
            else:
                body += bytes([tq]) + bytes(min(255, v * factor)
                                            for v in values)
            pos += 65
        out += data[last:start - 2] + struct.pack(">H", len(body) + 2) + body
        last = end
    return bytes(out + data[last:])


def _c_version_idct(coefs, qtable):
    """jpeg_idct_islow as libjpeg-turbo's C code computes it: 32-bit
    sums with no 16-bit wrap, and the range_limit table that wraps."""
    blocks = coefs.reshape(-1, 8, 8) * qtable.reshape(8, 8)
    saved = jpeg._i16
    jpeg._i16 = lambda x: x
    try:
        ws = (np.stack(jpeg._idct_1d(np.moveaxis(blocks, 1, 0))) + 1024) >> 11
        v = (np.stack(jpeg._idct_1d(np.moveaxis(ws, 2, 0)))
             + (1 << 17)) >> 18
    finally:
        jpeg._i16 = saved
    table = np.zeros(1024, np.int64)
    table[:128] = np.arange(128, 256)
    table[128:384] = 255
    table[896:] = np.arange(128)
    return table[v & 1023].transpose(2, 1, 0).reshape(
        *coefs.shape[:-1], 8, 8).astype(np.uint8)


@pytest.mark.parametrize("sixteen_bit", [False, True],
                         ids=["dqt8_x80", "dqt16_x300"])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_out_of_range_idct_follows_the_simd_code(sampling, sixteen_bit,
                                                 monkeypatch):
    """Quantisation tables scaled until dequantised coefficients and the
    IDCT's sums leave 16 bits: both decoders equal cv2, and the C
    version's arithmetic (no 16-bit wrap, range_limit wrapping) does not,
    so the test tells the two apart."""
    img = _content(37, 53, "noise", seed=3)
    data = _scaled_tables(_encode(img, 90, sampling),
                          300 if sixteen_bit else 80, sixteen_bit)
    _assert_decoders_match_cv2(data)
    monkeypatch.setattr(jpeg, "idct_islow", _c_version_idct)
    assert (jpeg.decode_pixels(data) != _cv2(data)).mean() > 0.5


def test_huffman_lookup_table_holds_16_bit_codes():
    """The plain decoder's 16-bit lookahead table of a code with one
    symbol at each length 1..16 (the C decoder's codes longer than 9
    bits, its slow path, are exercised by the optimised and q100
    streams above)."""
    counts = [1] * 15 + [1]
    values = list(range(16))
    table = jpeg._lookup_table(counts, values)
    assert table[0] == (1, 0)
    assert table[0xFFFE] == (16, 15)
    assert table[0xFFFF] == (0, 0)


# --- Exif orientation ----------------------------------------------------


def _tiff(orientation: int, order: bytes, entries=(), ifd: int = 8,
          value_type: int = 3) -> bytes:
    e = "<" if order == b"II" else ">"
    items = sorted([*entries, (0x0112, value_type, 1, orientation)])
    out = order + struct.pack(e + "HI", 42, ifd) + b"\x00" * (ifd - 8)
    out += struct.pack(e + "H", len(items))
    for tag, kind, count, value in items:
        field = (struct.pack(e + "HH", value, 0) if kind == 3
                 else struct.pack(e + "I", value))
        out += struct.pack(e + "HHI", tag, kind, count) + field
    return out + struct.pack(e + "I", 0)


def _jpeg_with_app1(base: bytes, *payloads: bytes) -> bytes:
    segs = b"".join(b"\xff\xe1" + struct.pack(">H", len(p) + 2) + p
                    for p in payloads)
    return base[:2] + segs + base[2:]


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _png_with_exif(tiff: bytes, img: np.ndarray, after_idat=False) -> bytes:
    ok, buf = cv2.imencode(".png", img[..., ::-1])
    data = buf.tobytes()
    at = data.rindex(b"IEND") - 4 if after_idat else 8 + 25
    return data[:at] + _png_chunk(b"eXIf", tiff) + data[at:]


@pytest.fixture(scope="module")
def small():
    return np.random.RandomState(0).randint(0, 256, (4, 6, 3)) \
        .astype(np.uint8)


@pytest.mark.parametrize("fmt", ["jpeg", "png"])
@pytest.mark.parametrize("order", [b"II", b"MM"], ids=["le", "be"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(tmp_path, small, orientation, order,
                                      fmt):
    tiff = _tiff(orientation, order)
    if fmt == "jpeg":
        data = _jpeg_with_app1(_encode(small, 95, "444"),
                               b"Exif\x00\x00" + tiff)
    else:
        data = _png_with_exif(tiff, small)
    path = tmp_path / f"o.{'jpg' if fmt == 'jpeg' else 'png'}"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)[:, :, ::-1]
    got = image_io.read_image(path)
    assert got.shape == want.shape
    assert got.shape[:2] == ((6, 4) if orientation >= 5 else (4, 6))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_io.decode_image(data), want)
    if fmt == "jpeg":
        assert image_io.exif_orientation(jpeg.exif_block(data)) \
            == orientation


_MALFORMED = {
    # name: (Exif TIFF bytes, orientation cv2 applies)
    "bad_magic": (b"II\x2b\x00" + _tiff(6, b"II")[4:], 1),
    "bad_order": (b"XX" + _tiff(6, b"II")[2:], 1),
    "truncated": (_tiff(6, b"II")[:14], 1),
    "ifd_past_the_end": (b"II*\x00" + struct.pack("<I", 1000)
                         + _tiff(6, b"II")[8:], 1),
    "value_0": (_tiff(0, b"MM"), 1),
    "value_9": (_tiff(9, b"II"), 1),
    "long_be": (_tiff(6, b"MM", value_type=4), 1),
    "long_le": (_tiff(6, b"II", value_type=4), 6),
    "ifd_at_20": (_tiff(6, b"II", ifd=20), 6),
    "string_out_of_range": (_tiff(6, b"II", [(0x010F, 2, 10, 5000)]), 1),
    "string_in_range": (_tiff(6, b"II", [(0x010F, 2, 10, 8)]), 6),
    "rational_after": (_tiff(6, b"II", [(0x011A, 5, 1, 5000)]), 6),
    "entries_cut_after_it": (
        _tiff(6, b"II", [(0x010F, 2, 3, 0)])[:8] + struct.pack("<H", 5)
        + _tiff(6, b"II", [(0x010F, 2, 3, 0)])[10:-4], 6),
}


@pytest.mark.parametrize("case", list(_MALFORMED))
def test_malformed_exif_matches_cv2(small, case):
    tiff, orientation = _MALFORMED[case]
    data = _jpeg_with_app1(_encode(small, 95, "444"), b"Exif\x00\x00" + tiff)
    want = _cv2(data)
    assert image_io.exif_orientation(tiff) == orientation
    np.testing.assert_array_equal(image_io.decode_image(data), want)
    png = _png_with_exif(tiff, small)
    want_png = cv2.imdecode(np.frombuffer(png, np.uint8),
                            cv2.IMREAD_COLOR)[:, :, ::-1]
    np.testing.assert_array_equal(image_io.decode_image(png), want_png)


def test_exif_block_choice_matches_cv2(small):
    """The first APP1 Exif block counts; an XMP APP1 before it, an APP1
    without the `Exif\\0\\0` prefix and an eXIf chunk after IDAT are
    read as cv2 reads them."""
    base = _encode(small, 95, "444")
    exif = lambda o: b"Exif\x00\x00" + _tiff(o, b"II")  # noqa: E731
    xmp = b"http://ns.adobe.com/xap/1.0/\x00<x/>"
    cases = [_jpeg_with_app1(base, exif(3), exif(6)),
             _jpeg_with_app1(base, xmp, exif(6)),
             _jpeg_with_app1(base, b"Exif\x00\xff" + _tiff(6, b"II")),
             _jpeg_with_app1(base, b"Exif" + _tiff(6, b"II"))]
    for data in cases:
        np.testing.assert_array_equal(image_io.decode_image(data),
                                      _cv2(data))
    png = _png_with_exif(_tiff(6, b"MM"), small, after_idat=True)
    want = cv2.imdecode(np.frombuffer(png, np.uint8),
                        cv2.IMREAD_COLOR)[:, :, ::-1]
    assert want.shape == (6, 4, 3)
    np.testing.assert_array_equal(image_io.decode_image(png), want)


# --- past baseline: the C library against cv2 (ROADMAP C3) ---------------


def _imread(tmp_path, data: bytes):
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[:, :, ::-1]


@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING) + ["gray"])
def test_c_decoder_matches_cv2_on_progressive(sampling, quality):
    """cv2-written progressive JPEGs (DC and AC first and refine scans,
    EOB runs), without and with restart intervals of 1 and 3 MCUs."""
    for h, w in SIZES:
        for rst in (0, 1, 3):
            extra = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
            if rst:
                extra += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
            data = _encode(_content(h, w, "edges", seed=h + rst), quality,
                           sampling, *extra)
            np.testing.assert_array_equal(image_codec.decode_jpeg(data),
                                          _cv2(data), err_msg=str((h, w, rst)))


def _pil_jpeg(rgb: np.ndarray, mode: str, **options) -> bytes:
    import io

    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(rgb).convert(mode).save(out, "JPEG", quality=90,
                                            **options)
    return out.getvalue()


def _adobe_transform(data: bytes, transform: int) -> bytes:
    at = data.index(b"Adobe") + 11
    return data[:at] + bytes([transform]) + data[at + 1:]


@pytest.mark.parametrize("case", [
    "rgb_444", "rgb_progressive", "cmyk_444", "cmyk_420", "cmyk_progressive",
    "ycck", "cmyk_transform1"])
def test_c_decoder_matches_cv2_on_adobe_colour(case):
    """RGB (PIL's keep_rgb: Adobe transform 0), CMYK (PIL), YCCK and an
    unknown transform (1, which libjpeg takes as YCCK), through OpenCV's
    CMYK -> BGR."""
    img = _content(37, 53, "edges", seed=3)
    if case.startswith("rgb"):
        data = _pil_jpeg(img, "RGB", keep_rgb=True, subsampling=0,
                         progressive=case.endswith("progressive"))
    else:
        data = _pil_jpeg(img, "CMYK", subsampling=2 if case == "cmyk_420"
                         else 0, progressive=case.endswith("progressive"))
        if case == "ycck":
            data = _adobe_transform(data, 2)
        elif case == "cmyk_transform1":
            data = _adobe_transform(data, 1)
    np.testing.assert_array_equal(image_codec.decode_jpeg(data), _cv2(data))


@pytest.mark.parametrize("rst", [0, 1])
@pytest.mark.parametrize("sampling", ["420", "444", "gray"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_truncated_files_match_cv2_imread(tmp_path, progressive, sampling,
                                          rst):
    """Files cut at several offsets of their scan data (and a file cut
    just before its EOI): `read_image` returns `cv2.imread`'s pixels, the
    rows decoded and the rest of the scan mid-gray; the same bytes are
    refused by `decode_image`, as `cv2.imdecode` refuses them. A
    progressive file cut before its last scan would take libjpeg's
    inter-block smoothing and is refused by that name; cut inside its
    last scan it is read."""
    extra = [cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if rst:
        extra += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    data = _encode(_content(37, 53, "noise", seed=2), 95, sampling, *extra)
    sos = data.index(b"\xff\xda")
    read = 0
    for frac in (0.1, 0.3, 0.5, 0.7, 0.9, 0.97, 0.999, None):
        cut = len(data) - 2 if frac is None else int(
            sos + (len(data) - sos) * frac)
        part = data[:cut]
        want = _imread(tmp_path, part)
        assert cv2.imdecode(np.frombuffer(part, np.uint8),
                            cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="truncated"):
            image_io.decode_image(part)
        path = tmp_path / "cut.jpg"
        path.write_bytes(part)
        if want is None:  # a progressive file cut inside a table
            with pytest.raises(ValueError):
                image_io.read_image(path)
            continue
        try:
            got = image_io.read_image(path)
        except ValueError as exc:
            assert progressive, (frac, exc)
            assert "smoothing" in str(exc) or "marker segment" in str(exc)
            continue
        np.testing.assert_array_equal(got, want, err_msg=str(frac))
        read += 1
    assert read >= (8 if not progressive else 2)


# --- refusals ------------------------------------------------------------


def _sof_offset(data: bytes) -> int:
    pos = 2
    while not 0xC0 <= data[pos + 1] <= 0xCF or data[pos + 1] in (0xC4,
                                                                 0xCC):
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return pos


def _refused(case: str) -> tuple[bytes, str]:
    img = _content(16, 24, "edges", seed=5)
    base = bytearray(_encode(img, 90, "420"))
    sof = _sof_offset(bytes(base))
    if case == "progressive":
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        return buf.tobytes(), "progressive"
    if case in ("sof3", "sof9", "sof10", "sof5"):
        base[sof + 1] = {"sof3": 0xC3, "sof9": 0xC9, "sof10": 0xCA,
                         "sof5": 0xC5}[case]
        return bytes(base), {"sof3": "lossless", "sof9": "arithmetic",
                             "sof10": "arithmetic", "sof5": "differential"
                             }[case]
    if case == "12bit":
        base[sof + 4] = 12
        return bytes(base), "12-bit"
    if case == "cmyk":
        return _pil_jpeg(img, "CMYK"), "CMYK"
    if case == "adobe_rgb":
        adobe = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
        app0 = bytes(base).index(b"\xff\xe0")
        length = struct.unpack(">H", base[app0 + 2:app0 + 4])[0]
        no_jfif = bytes(base[:app0]) + bytes(base[app0 + 2 + length:])
        return (no_jfif[:2] + b"\xff\xee" + struct.pack(">H", len(adobe) + 2)
                + adobe + no_jfif[2:]), "RGB JPEGs"
    if case == "rgb_ids":
        data = bytes(base)
        app0 = data.index(b"\xff\xe0")
        length = struct.unpack(">H", data[app0 + 2:app0 + 4])[0]
        data = bytearray(data[:app0] + data[app0 + 2 + length:])
        sof = _sof_offset(bytes(data))
        for i, cid in enumerate(b"RGB"):
            data[sof + 10 + 3 * i] = cid
        sos = bytes(data).index(b"\xff\xda")
        for i, cid in enumerate(b"RGB"):
            data[sos + 5 + 2 * i] = cid
        return bytes(data), "RGB JPEGs"
    if case == "truncated":  # in the middle of the entropy-coded data
        sos = bytes(base).index(b"\xff\xda")
        return bytes(base[:(sos + len(base)) // 2]), "truncated"
    if case == "no_eoi":
        return bytes(base[:-2]), "truncated"
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "progressive", "sof3", "sof5", "sof9", "sof10", "12bit", "cmyk",
    "adobe_rgb", "rgb_ids", "truncated", "no_eoi"])
def test_refusals_name_the_mode(tmp_path, case):
    """The plain decoder refuses every mode past baseline by name; the C
    library and `read_image` still refuse arithmetic-coded, lossless,
    differential and 12-bit JPEGs, and the C library, like
    `cv2.imdecode`, bytes that end early."""
    data, match = _refused(case)
    with pytest.raises(ValueError, match=match):
        jpeg.decode_pixels(data)
    if case in ("progressive", "cmyk", "adobe_rgb", "rgb_ids"):
        return  # read by the C library: test_cv2_reads_what_is_refused
    with pytest.raises(ValueError, match=match):
        image_codec.decode_jpeg(data)
    if case in ("truncated", "no_eoi"):
        return  # read_image fills these as cv2.imread does
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        image_io.read_image(path)


@pytest.mark.parametrize("case", [
    "progressive", "cmyk", "adobe_rgb", "rgb_ids", "truncated", "no_eoi"])
def test_cv2_reads_what_is_refused(tmp_path, case):
    """What the plain decoder refuses and cv2 reads (ROADMAP C3), the C
    library reads as cv2 does: a progressive, a CMYK and two RGB JPEGs as
    `imdecode` does, and `read_image` a file cut in its scan data or
    before its EOI as `imread` does (`imdecode` refuses those bytes)."""
    data, _ = _refused(case)
    if case in ("truncated", "no_eoi"):
        assert cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_COLOR) is None
        want = _imread(tmp_path, data)
        assert want.shape == (16, 24, 3)
        np.testing.assert_array_equal(image_codec.decode_jpeg(data, True),
                                      want)
        np.testing.assert_array_equal(
            image_io.read_image(tmp_path / "x.jpg"), want)
        return
    want = _cv2(data)
    assert want.shape == (16, 24, 3)
    np.testing.assert_array_equal(image_codec.decode_jpeg(data), want)
    np.testing.assert_array_equal(image_io.decode_image(data), want)


def test_other_formats_name_themselves(tmp_path):
    for magic, kind in ((b"GIF89a", "GIF"), (b"BM\x00\x00", "BMP"),
                        (b"RIFF\x00\x00\x00\x00WEBP", "WebP"),
                        (b"II*\x00\x08\x00", "TIFF")):
        with pytest.raises(ValueError, match=kind):
            image_io.decode_image(magic + b"\x00" * 32)


# --- fixtures and the build ------------------------------------------------


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _letterbox_size(h: int, w: int, s: int = 512) -> tuple[int, int]:
    scale = s / max(h, w)
    return int(round(w * scale)), int(round(h * scale))


def test_committed_digests_equal_cv2_and_the_port():
    digests = json.loads((FIXTURES / "digests.json").read_text())
    files = sorted(p.name for p in FIXTURES.iterdir()
                   if p.suffix in (".jpg", ".png"))
    assert sorted(digests) == files
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 500_000
    for name, want in digests.items():
        path = FIXTURES / name
        rgb = cv2.imread(str(path), cv2.IMREAD_COLOR)[:, :, ::-1]
        assert [list(rgb.shape), _sha(rgb)] == [want["shape"],
                                                want["rgb_sha256"]], name
        size = _letterbox_size(*rgb.shape[:2])
        box = cv2.resize(np.ascontiguousarray(rgb), size,
                         interpolation=cv2.INTER_LINEAR)
        assert _sha(box) == want["letterbox_sha256"], name
        got = image_io.read_image(path)
        assert _sha(got) == want["rgb_sha256"], name
        assert _sha(image_io.resize_linear(got, size)) \
            == want["letterbox_sha256"], name
        if (name.endswith(".jpg") and not name.startswith("c3_")
                and rgb.shape[0] * rgb.shape[1] <= 40_000):
            data = path.read_bytes()
            plain = image_io.apply_orientation(
                jpeg.decode_pixels(data),
                image_io.exif_orientation(jpeg.exif_block(data)))
            assert _sha(plain) == want["rgb_sha256"], name


def test_fixture_annotations_load():
    from multiposenet_tpu_torch.data.coco import load_coco_keypoints

    records = load_coco_keypoints(FIXTURES / "annotations.json")
    assert len(records) == 10
    for rec in records:
        assert (FIXTURES / rec["file_name"]).exists()
        assert len(rec["boxes"]) >= 1


def test_host_library_loads_from_the_build_dir():
    lib = image_codec.library()
    assert Path(lib._name).parent == kernels.BUILD_DIR
    assert Path(lib._name).name == "libimage_codec.so"
    assert "image_codec" not in kernels.KERNEL_NAMES
    assert kernels.LAUNCHES.get("image_codec") is None


def test_host_build_of_a_broken_source_raises_with_the_log(tmp_path):
    source = tmp_path / "broken.c"
    source.write_text("int f(void) { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        kernels.build_host("broken_codec_test", source)
    assert not (kernels.BUILD_DIR / "libbroken_codec_test.so").exists()


def test_corrupt_streams_agree_between_the_decoders():
    """Seeded random byte changes and cuts in cv2-written JPEGs (headers,
    tables and entropy-coded data alike): for each, the C library and the
    plain version either both raise a ValueError or both return the same
    pixels, or, where a change made a stream past baseline that only the
    C library reads (a frame byte turned progressive, say), the C library
    returns cv2's pixels; neither crashes or raises anything else."""
    rng = np.random.RandomState(0)
    bases = [_encode(_content(24, 40, "edges", 1), 80, sampling, *extra)
             for sampling, extra in (
                 ("420", ()), ("422", (cv2.IMWRITE_JPEG_RST_INTERVAL, 1)),
                 ("gray", ()), ("444", (cv2.IMWRITE_JPEG_OPTIMIZE, 1)))]
    outcomes = {"decoded": 0, "refused": 0}
    for trial in range(400):
        data = bytearray(bases[trial % len(bases)])
        for _ in range(rng.randint(1, 4)):
            data[rng.randint(2, len(data))] = rng.randint(0, 256)
        if rng.rand() < 0.2:
            data = data[:rng.randint(2, len(data))]
        results = []
        for decode in (jpeg.decode_pixels, image_codec.decode_jpeg):
            try:
                results.append(decode(bytes(data)))
            except ValueError:
                results.append(None)
        plain, c = results
        if plain is None and c is not None:
            np.testing.assert_array_equal(c, _cv2(bytes(data)),
                                          err_msg=str(trial))
            outcomes["c_only"] = outcomes.get("c_only", 0) + 1
            continue
        assert (plain is None) == (c is None), trial
        if c is None:
            outcomes["refused"] += 1
        else:
            np.testing.assert_array_equal(c, plain, err_msg=str(trial))
            outcomes["decoded"] += 1
    assert min(outcomes["decoded"], outcomes["refused"]) > 50, outcomes
