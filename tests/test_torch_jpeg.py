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
restart intervals), Adobe RGB, CMYK and YCCK, arithmetic-coded frames,
lossless RGB and CMYK frames and progressive files whose scans stop
early (libjpeg's block smoothing), bit for bit with cv2 on files that
libjpeg-turbo 3.1 itself writes (tests/make_image_fixtures.py
libjpeg_jpeg), and a file cut anywhere as `cv2.imread` fills it, while
bytes cut so are refused as `cv2.imdecode` refuses them. Each mode cv2
returns no image for raises a ValueError that names it. Both encoders
write the bytes `cv2.imencode(".jpg")` writes. The committed fixtures
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

from make_image_fixtures import (
    libjpeg_jpeg, textured_scene, until_scan, with_adobe_transform)
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
    progressive file cut before its last scan is read through libjpeg's
    inter-block smoothing, as cut inside its last scan it is read
    without."""
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
        np.testing.assert_array_equal(image_io.read_image(path), want,
                                      err_msg=str(frac))
        read += 1
    assert read >= (8 if not progressive else 2)


# --- encoding -------------------------------------------------------------

ENCODE_SIZES = [(1, 1), (3, 5), (16, 16), (37, 53), (97, 133), (480, 640)]


@pytest.mark.parametrize("encoder", ["c", "plain"])
@pytest.mark.parametrize("kind", ["noise", "edges"])
@pytest.mark.parametrize("size", ENCODE_SIZES,
                         ids=[f"{h}x{w}" for h, w in ENCODE_SIZES])
def test_encoders_match_cv2_imencode(size, kind, encoder):
    """`image_io.encode_jpeg` (host C) and `jpeg.encode_pixels` (NumPy)
    write the bytes `cv2.imencode(".jpg", bgr)` writes at its defaults,
    byte for byte, down to partial MCUs and dummy blocks."""
    img = _content(*size, kind, seed=size[0] * 7 + size[1])
    want = cv2.imencode(".jpg", np.ascontiguousarray(img[:, :, ::-1]))[1]
    got = (image_io.encode_jpeg(img) if encoder == "c"
           else jpeg.encode_pixels(img))
    assert got == want.tobytes()


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 100])
def test_encoders_match_cv2_at_other_qualities(quality):
    """Other qualities scale the standard tables as cv2's does."""
    img = _content(37, 53, "edges", seed=quality)
    want = cv2.imencode(".jpg", np.ascontiguousarray(img[:, :, ::-1]),
                        [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
    assert image_codec.encode_jpeg(img, quality) == want
    assert jpeg.encode_pixels(img, quality) == want


def test_written_jpeg_reads_back_as_cv2_reads_it(tmp_path):
    """`write_jpeg` writes what `cv2.imwrite` writes for a .jpg path, and
    the port decodes it as cv2 decodes it."""
    img = _content(61, 45, "noise", seed=3)
    ours, theirs = tmp_path / "ours.jpg", tmp_path / "cv2.jpg"
    image_io.write_jpeg(ours, img)
    assert cv2.imwrite(str(theirs), np.ascontiguousarray(img[:, :, ::-1]))
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(image_io.read_image(ours),
                                  _imread(tmp_path, ours.read_bytes()))


def test_encoders_refuse_what_they_do_not_write():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float32)):
        with pytest.raises(ValueError, match="uint8 RGB"):
            image_io.encode_jpeg(bad)
        with pytest.raises(ValueError, match="uint8 RGB"):
            jpeg.encode_pixels(bad)
    with pytest.raises(ValueError, match="quality"):
        image_codec.encode_jpeg(np.zeros((4, 4, 3), np.uint8), 0)


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
    """The plain decoder refuses every mode past baseline by name. The C
    library and `read_image` refuse what cv2 returns no image for, by
    name: a differential frame, 12-bit samples, and a baseline stream
    relabelled lossless or arithmetic-coded progressive (its scan
    parameters are wrong for those frames); and the C library, like
    `cv2.imdecode`, bytes that end early. A baseline stream relabelled
    arithmetic-coded sequential is read, as cv2 reads it
    (test_cv2_reads_what_is_refused)."""
    data, match = _refused(case)
    with pytest.raises(ValueError, match=match):
        jpeg.decode_pixels(data)
    if case in ("progressive", "sof9", "cmyk", "adobe_rgb", "rgb_ids"):
        return  # read by the C library: test_cv2_reads_what_is_refused
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match=match):
        image_codec.decode_jpeg(data)
    if case in ("truncated", "no_eoi"):
        return  # read_image fills these as cv2.imread does
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        image_io.read_image(path)


@pytest.mark.parametrize("case", [
    "progressive", "sof9", "cmyk", "adobe_rgb", "rgb_ids", "truncated",
    "no_eoi"])
def test_cv2_reads_what_is_refused(tmp_path, case):
    """What the plain decoder refuses and cv2 reads (ROADMAP C3), the C
    library reads as cv2 does: a progressive, a CMYK and two RGB JPEGs,
    and Huffman-coded data read as arithmetic-coded (SOF9), as `imdecode`
    does, and `read_image` a file cut in its scan data or before its EOI
    as `imread` does (`imdecode` refuses those bytes)."""
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


# --- past the rest of baseline: arithmetic, lossless, smoothing -----------
# The files are written by libjpeg-turbo 3.1 itself (Pillow's build,
# tests/make_image_fixtures.py libjpeg_jpeg); cv2 5.0's libjpeg-turbo 3.1
# is the oracle.

LUMA = {"420": 0x22, "444": 0x11, "422": 0x21, "440": 0x12}


def _scene(h: int, w: int, seed: int) -> np.ndarray:
    return textured_scene(np.full((h, w, 3), 128, np.uint8), seed=seed)


def _all_readers_match_cv2(tmp_path, data: bytes) -> None:
    """decode_jpeg, decode_image and read_image against cv2.imdecode."""
    want = _cv2(data)
    np.testing.assert_array_equal(image_codec.decode_jpeg(data), want)
    np.testing.assert_array_equal(image_io.decode_image(data), want)
    path = tmp_path / "mode.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(image_io.read_image(path), want)


@pytest.mark.parametrize("options", ["plain", "restarts_conditioning"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
@pytest.mark.parametrize("sampling", list(LUMA) + ["gray"])
@pytest.mark.parametrize("size", [(16, 16), (37, 53)],
                         ids=["16x16", "37x53"])
def test_arithmetic_coding_matches_cv2(tmp_path, size, sampling,
                                       progressive, options):
    """SOF9 and SOF10 (jdarith.c's Q-coder, DC and AC conditioning from
    DAC, restarts): bit for bit with cv2, and refused by the plain
    decoder by name."""
    img = (_content(*size, "noise", seed=size[0]) if size == (16, 16)
           else _scene(*size, seed=3))
    if sampling == "gray":
        img = img[..., 1]
    extra = ({"restart_rows": 1, "conditioning": True}
             if options != "plain" else {})
    data = libjpeg_jpeg(img, arith=True, progressive=progressive,
                        sampling=LUMA.get(sampling, 0x22), **extra)
    assert (b"\xff\xca" if progressive else b"\xff\xc9") in data
    _all_readers_match_cv2(tmp_path, data)
    with pytest.raises(ValueError, match="arithmetic"):
        jpeg.decode_pixels(data)


def test_arithmetic_table_is_libjpeg_turbos():
    """The Q-coder's state table (T.81 Table D.2) in the C library equals
    the `jpeg_aritab` that Pillow's libjpeg-turbo 3.1 exports."""
    import ctypes

    import PIL

    libs = sorted((Path(PIL.__file__).parent.parent / "pillow.libs").glob(
        "libjpeg-*.so*"))
    theirs = (ctypes.c_long * 114).in_dll(ctypes.CDLL(str(libs[0])),
                                          "jpeg_aritab")
    ours = (ctypes.c_int32 * 114).in_dll(image_codec.library(),
                                         "jpeg_arith_table")
    assert list(ours) == list(theirs)


@pytest.mark.parametrize("point_transform", [0, 2])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_matches_cv2(tmp_path, predictor, point_transform):
    """SOF3 at 8 bits, RGB (what libjpeg-turbo writes from RGB): each
    predictor, a point transform, 4:2:0 (box upsampling: lossless frames
    take no fancy upsampling)."""
    data = libjpeg_jpeg(_scene(37, 53, seed=predictor), predictor=predictor,
                        point_transform=point_transform)
    _all_readers_match_cv2(tmp_path, data)
    with pytest.raises(ValueError, match="lossless"):
        jpeg.decode_pixels(data)


@pytest.mark.parametrize("case", ["444_restarts", "422_restarts2",
                                  "cmyk", "cmyk_420"])
def test_lossless_restarts_and_cmyk_match_cv2(tmp_path, case):
    img = _content(29, 41, "noise", seed=7)
    if case.startswith("cmyk"):
        img = np.concatenate([img, img[..., :1] ^ 0x55], -1)
    sampling = {"444_restarts": 0x11, "422_restarts2": 0x21, "cmyk": 0x11,
                "cmyk_420": 0x22}[case]
    rows = {"444_restarts": 1, "422_restarts2": 2}.get(case, 0)
    data = libjpeg_jpeg(img, predictor=6, sampling=sampling,
                        restart_rows=rows)
    _all_readers_match_cv2(tmp_path, data)


@pytest.mark.parametrize("scans", range(1, 10))
@pytest.mark.parametrize("sampling", ["420", "444", "arith_420"])
def test_block_smoothing_matches_cv2(tmp_path, sampling, scans):
    """A progressive file ended after each of its first scans: libjpeg
    reads it through its inter-block smoothing (the 5x5 DC neighbourhood,
    its estimates of coefficients 1-9, the DC itself before any AC scan;
    rows clamped as libjpeg-turbo's buffer clamps them)."""
    img = _content(41, 77, "edges", seed=scans)
    full = libjpeg_jpeg(img, progressive=True, quality=75,
                        arith=sampling.startswith("arith"),
                        sampling=LUMA[sampling[-3:]])
    _all_readers_match_cv2(tmp_path, until_scan(full, scans))


@pytest.mark.parametrize("scans", range(1, 6))
def test_block_smoothing_of_gray_and_narrow_images_matches_cv2(tmp_path,
                                                               scans):
    for h, w in ((9, 9), (40, 16), (16, 40), (8, 8)):
        data = libjpeg_jpeg(_content(h, w, "noise", seed=h + w)[..., 0],
                            progressive=True)
        _all_readers_match_cv2(tmp_path, until_scan(data, scans))


@pytest.mark.parametrize("mode", ["arithmetic", "arithmetic_progressive",
                                  "arithmetic_restarts", "lossless",
                                  "lossless_restarts", "progressive_420",
                                  "progressive_444_restarts"])
def test_cut_files_match_cv2_imread_in_every_mode(tmp_path, mode):
    """Files cut at 23 offsets of their data, headers between scans
    included: `read_image` returns `cv2.imread`'s pixels where it returns
    any (arithmetic decoding on zero bytes up to a bad code, lossless rows
    on zero differences from a reset predictor, smoothing with the
    previous scan's coefficient bits below the cut) and refuses the file
    where cv2 returns None; `decode_image` refuses the bytes, as
    `cv2.imdecode` does."""
    options = {
        "arithmetic": {"arith": True},
        "arithmetic_progressive": {"arith": True, "progressive": True},
        "arithmetic_restarts": {"arith": True, "restart_rows": 1},
        "lossless": {"predictor": 1, "sampling": 0x11},
        "lossless_restarts": {"predictor": 2, "restart_rows": 1},
        "progressive_420": {"progressive": True},
        "progressive_444_restarts": {"progressive": True, "sampling": 0x11,
                                     "restart_rows": 1},
    }[mode]
    data = libjpeg_jpeg(_content(37, 53, "noise", seed=11), **options)
    sos = data.index(b"\xff\xda")
    read = 0
    for frac in np.linspace(0.02, 0.999, 23):
        part = data[:int(sos + (len(data) - sos) * frac)]
        assert cv2.imdecode(np.frombuffer(part, np.uint8),
                            cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError):
            image_io.decode_image(part)
        want = _imread(tmp_path, part)
        path = tmp_path / "cut.jpg"
        path.write_bytes(part)
        if want is None:
            with pytest.raises(ValueError):
                image_io.read_image(path)
            continue
        np.testing.assert_array_equal(image_io.read_image(path), want,
                                      err_msg=f"{mode} {frac}")
        read += 1
    assert read >= 12


def _relabel(data: bytes, marker: int) -> bytes:
    sof = _sof_offset(data)
    return data[:sof + 1] + bytes([marker]) + data[sof + 2:]


def _not_read(case: str) -> tuple[bytes, str]:
    """Files of modes cv2 5.0 returns no image for, and the name the port's
    refusal gives."""
    img = _scene(24, 32, seed=4)
    deep = np.random.RandomState(5).randint(0, 4096, (24, 32, 3))
    if case == "lossless_gray":
        return libjpeg_jpeg(img[..., 0], predictor=1), "gray lossless"
    if case == "lossless_ycbcr":
        return (with_adobe_transform(libjpeg_jpeg(img, predictor=1), 1),
                "lossless JPEGs in YCbCr")
    if case == "lossless_ycck":
        cmyk = np.concatenate([img, img[..., :1]], -1)
        return (with_adobe_transform(libjpeg_jpeg(cmyk, predictor=1), 2),
                "lossless JPEGs in YCbCr or YCCK")
    if case == "lossless_12bit":
        return libjpeg_jpeg(deep, precision=12, predictor=1), "12-bit lossless"
    if case == "lossless_16bit":
        return (libjpeg_jpeg(deep * 16, precision=16, predictor=1),
                "16-bit lossless")
    if case == "sequential_12bit":
        return libjpeg_jpeg(deep, precision=12), "12-bit DCT"
    if case == "progressive_12bit":
        return libjpeg_jpeg(deep, precision=12, progressive=True), "12-bit DCT"
    if case == "arithmetic_12bit":
        return libjpeg_jpeg(deep, precision=12, arith=True), "12-bit DCT"
    if case == "sof11":  # libjpeg-turbo writes no arithmetic lossless
        return (_relabel(libjpeg_jpeg(img, predictor=1), 0xCB),
                r"arithmetic-coded lossless \(SOF11\)")
    marker = int(case[3:], 16) + 0xC0 if case.startswith("sof") else None
    name = {0xC5: "differential sequential", 0xC6: "differential progressive",
            0xC7: "differential lossless",
            0xCD: "arithmetic-coded differential sequential",
            0xCE: "arithmetic-coded differential progressive",
            0xCF: "arithmetic-coded differential lossless"}[marker]
    return _relabel(_encode(img, 90, "420"), marker), name


@pytest.mark.parametrize("case", [
    "lossless_gray", "lossless_ycbcr", "lossless_ycck", "lossless_12bit",
    "lossless_16bit", "sequential_12bit", "progressive_12bit",
    "arithmetic_12bit", "sof11", "sof5", "sof6", "sof7", "sofd", "sofe",
    "soff"])
def test_modes_cv2_does_not_read_are_refused_by_name(tmp_path, case):
    """Not a fault: cv2 5.0 returns no image for these (`imdecode` and
    `imread`), and the port refuses them with a ValueError naming the
    mode: lossless frames that would need a colour conversion (gray,
    YCbCr, YCCK: libjpeg-turbo converts none in lossless mode), samples
    wider than 8 bits (OpenCV calls only the 8-bit functions),
    arithmetic-coded lossless and the hierarchical (differential)
    frames, which libjpeg-turbo does not read."""
    data, match = _not_read(case)
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR) is None
    assert _imread(tmp_path, data) is None
    with pytest.raises(ValueError, match=match):
        image_codec.decode_jpeg(data)
    with pytest.raises(ValueError, match=match):
        image_io.read_image(tmp_path / "x.jpg")
    with pytest.raises(ValueError):
        jpeg.decode_pixels(data)


MODE_FIXTURES = sorted(p.name for p in FIXTURES.glob("c3_*.jpg")
                       if p.name.split("_")[1] in ("arith", "lossless",
                                                   "smooth"))


@pytest.mark.parametrize("name", MODE_FIXTURES)
def test_mode_fixtures_read_as_cv2_reads_them(tmp_path, name):
    """The committed fixtures of these modes, which the card's machine
    holds to their digests: every reader equals cv2, and the plain
    decoder refuses them."""
    data = (FIXTURES / name).read_bytes()
    _all_readers_match_cv2(tmp_path, data)
    with pytest.raises(ValueError):
        jpeg.decode_pixels(data)


def test_other_formats_name_themselves(tmp_path):
    """What is still refused: an `avis` ftyp box with no moov box behind
    it (AVIF stills, grids and image sequences are read:
    tests/test_torch_avif*.py), OpenEXR (cv2 is built without it) and
    RIFF files other than WebP, each by its name
    (WebP, Radiance HDR, JPEG-in-TIFF and JPEG 2000 are read:
    tests/test_torch_webp.py, test_torch_hdr.py,
    test_torch_tiff_codecs.py, test_torch_jpeg2000.py). An `avif` ftyp
    box, a JP2 box or a bare codestream signature followed by zeros is no
    image to cv2, and the port refuses it too."""
    for data, kind in (
            (b"RIFF\x24\x00\x00\x00AVI LIST" + b"\x00" * 32, "RIFF b'AVI '"),
            (b"\x00\x00\x00\x1cftypavis" + b"\x00" * 32, "avis"),
            (b"\x00\x00\x00\x1cftypavif" + b"\x00" * 32, "AVIF: no meta"),
            (b"\x76\x2f\x31\x01" + b"\x00" * 32, "OpenEXR")):
        with pytest.raises(ValueError, match=kind):
            image_io.decode_image(data)
    for data in (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + b"\x00" * 32,
                 b"\xff\x4f\xff\x51" + b"\x00" * 32):
        assert cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError):
            image_io.decode_image(data)


# --- fixtures and the build ------------------------------------------------


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _letterbox_size(h: int, w: int, s: int = 512) -> tuple[int, int]:
    scale = s / max(h, w)
    return int(round(w * scale)), int(round(h * scale))


def test_committed_digests_equal_cv2_and_the_port():
    digests = json.loads((FIXTURES / "digests.json").read_text())
    files = sorted(p.name for p in FIXTURES.iterdir()
                   if p.suffix in (".jpg", ".png", ".webp", ".tif", ".hdr",
                                   ".pic", ".jp2", ".j2k", ".avif"))
    assert sorted(digests) == files
    # 510,000 bytes, 300,000 more for the WebP fixtures (their own budget
    # is held in tests/test_torch_webp.py), 6,000 more for the digests
    # of cv2's .jp2 of each fixture, 36,000 more for the AVIF fixtures
    # (the 480x640 photo's .avif is 27,949 bytes of them) and 54,000 more
    # for the AVIF fixtures of quality 100, speed 2, palette and intra
    # block copy (the 128x160 lossless crop is 38,149 bytes of them), and
    # 3,000 more for the 10- and 12-bit AVIF fixtures (2,384 bytes
    # together, rounded up to the next 1,000), and 5,494 more for the four
    # AVIF fixtures of other encoders (4:4:4 lossy, 4:2:2, 10-bit 4:2:2,
    # limited-range BT.709: 3,802 bytes and their digests' lines), and
    # 3,455 more for the two AVIF container fixtures (a grid with an Exif
    # item, a sequence: 2,608 bytes and their digests' lines), and 3,595
    # more for the three AVIF film grain and segmentation fixtures (two
    # grain stills, an aq-mode sequence: 2,322 bytes and their digests'
    # lines).
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 921_544
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
        if "imencode_sha256" in want:
            bgr = np.ascontiguousarray(rgb[:, :, ::-1])
            ours = hashlib.sha256(image_io.encode_jpeg(rgb)).hexdigest()
            theirs = hashlib.sha256(cv2.imencode(".jpg", bgr)[1]).hexdigest()
            assert ours == theirs == want["imencode_sha256"], name
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
    returns cv2's pixels; neither crashes or raises anything else. Every
    stream the C library decodes, it decodes to cv2.imdecode's pixels, and
    where cv2 returns no image it raises."""
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
        want = cv2.imdecode(np.frombuffer(bytes(data), np.uint8),
                            cv2.IMREAD_COLOR)
        want = None if want is None else want[:, :, ::-1]
        assert (c is None) == (want is None), trial
        if c is not None:
            np.testing.assert_array_equal(c, want, err_msg=str(trial))
        if plain is None and c is not None:
            outcomes["c_only"] = outcomes.get("c_only", 0) + 1
            continue
        assert (plain is None) == (c is None), trial
        if c is None:
            outcomes["refused"] += 1
        else:
            np.testing.assert_array_equal(c, plain, err_msg=str(trial))
            outcomes["decoded"] += 1
    assert min(outcomes["decoded"], outcomes["refused"]) > 50, outcomes
