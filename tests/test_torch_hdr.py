"""Radiance HDR (`.hdr`, `.pic`) against cv2 5.0 (its `rgbe.cpp`): the
committed `hdr_*` fixtures, header variants, and cut and corrupted
files read by `decode_image` (the host C library), `decode_image_plain`
(`utils/hdr.py`) and `read_image` as `cv2.imdecode(buf, IMREAD_COLOR)`
reads them, or refused with a ValueError where cv2 returns no image; the
writer's bytes, C and plain, equal to `cv2.imencode` at every size
tested (run-length and flat scanlines, both suffixes, a hypothesis
property on random images) and `write_image` equal to `cv2.imwrite`.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from multiposenet_tpu_torch.utils import hdr, image_io
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
HDR_FIXTURES = sorted(n for n in DIGESTS if n.startswith("hdr_"))
RNG = np.random.default_rng(21)
FORMAT = b"FORMAT=32-bit_rle_rgbe\n"


def _cv2(data: bytes):
    try:
        r = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None
    return None if r is None else r[:, :, ::-1]


def _readers_match_cv2(data: bytes, tmp_path):
    want = _cv2(data)
    path = tmp_path / "x.hdr"
    path.write_bytes(data)
    for read in (image_io.decode_image, image_io.decode_image_plain,
                 lambda d: image_io.read_image(path)):
        if want is None:
            with pytest.raises(ValueError):
                read(data)
            continue
        got = read(data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    return want


def _cv2_bytes(rgb: np.ndarray, suffix: str = ".hdr") -> bytes:
    ok, buf = cv2.imencode(suffix, np.ascontiguousarray(rgb[:, :, ::-1]))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("name", HDR_FIXTURES)
def test_fixtures_read_as_cv2(name, tmp_path):
    assert _readers_match_cv2((FIXTURES / name).read_bytes(),
                              tmp_path) is not None


PIXELS = RNG.integers(0, 256, (3, 5, 4), dtype=np.uint8)
PIXELS[..., 3] = RNG.integers(118, 140, (3, 5))
HEADERS = {
    "radiance": b"#?RADIANCE\n" + FORMAT + b"\n",
    "rgbe": b"#?RGBE\n" + FORMAT + b"\n",
    "exposure_gamma_comment": b"#?RADIANCE\n# x\nEXPOSURE=2\nGAMMA=2.2\n"
                              + FORMAT + b"\n",
    "xyze": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n",
    "no_format": b"#?RADIANCE\n\n",
    "crlf": b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n",
    "line_of_126": b"#?RADIANCE\n" + b"X" * 126 + b"\n" + FORMAT + b"\n",
    "line_of_127": b"#?RADIANCE\n" + b"X" * 127 + b"\n" + FORMAT + b"\n",
    "line_of_300": b"#?RADIANCE\n" + b"X" * 300 + b"\n" + FORMAT + b"\n",
    "blank_before_format": b"#?RGBE\n\n" + FORMAT + b"\n",
    "nul_in_a_line": b"#?RADIANCE\nA\x00B\n" + FORMAT + b"\n",
    "format_with_nul": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\x00\n\n",
    "space_line_after_format": b"#?RADIANCE\n" + FORMAT + b" \n",
}
SIZES = {
    "minus_y_plus_x": b"-Y 3 +X 5\n", "plus_y": b"+Y 3 +X 5\n",
    "minus_x": b"-Y 3 -X 5\n", "tight": b"-Y3 +X5\n",
    "spaced_and_more": b"-Y  3\t+X  5 more\n", "no_newline": b"-Y 3 +X 5",
    "negative": b"-Y -3 +X 5\n", "plus_sign": b"-Y 3 +X +5\n",
    "leading_space": b" -Y 3 +X 5\n", "too_wide": b"-Y 3 +X 4\n",
    "swapped": b"+X 5 -Y 3\n",
}


@pytest.mark.parametrize("header", sorted(HEADERS))
def test_header_variants_read_as_cv2(header, tmp_path):
    """Each header with each size line over flat pixels: read as cv2
    reads them (header lines through 127-byte fgets pieces, only the
    exact FORMAT line, only -Y H +X W), or refused."""
    for size in SIZES.values():
        _readers_match_cv2(HEADERS[header] + size + PIXELS.tobytes(),
                           tmp_path)


def test_signature_and_short_files(tmp_path):
    for data in (b"#?RADIANCE", b"#?RGBE\n" + FORMAT, b"#?RGBE",
                 HEADERS["rgbe"] + SIZES["minus_y_plus_x"]):
        assert _readers_match_cv2(data, tmp_path) is None
    with pytest.raises(ValueError, match="not an image file"):
        image_io.decode_image(b"#?RGBE\n\n")


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (4, 8), (5, 9), (2, 200),
                                   (3, 130), (9, 33)])
def test_cut_and_corrupt_files_read_as_cv2(shape, tmp_path):
    """cv2-written files (flat under 8 wide, else run-length) cut at
    seeded points and with seeded bits flipped past the header: cv2's
    pixels (a scanline that does not start 02 02 turns the rest flat; a
    pixel that scales to 2^31 or more comes out 0) or no image."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    rgb[:, :shape[1] // 2] = 9
    data = _cv2_bytes(rgb)
    head = data.index(b"+X") + data[data.index(b"+X"):].index(b"\n") + 1
    outcomes = {"image": 0, "none": 0}
    for cut in sorted({head, head + 1, len(data) - 1, len(data) // 2,
                       int(rng.integers(head, len(data)))}):
        want = _readers_match_cv2(data[:cut], tmp_path)
        outcomes["none" if want is None else "image"] += 1
    for _ in range(20):
        flipped = bytearray(data)
        flipped[int(rng.integers(head, len(data)))] ^= \
            1 << int(rng.integers(8))
        want = _readers_match_cv2(bytes(flipped), tmp_path)
        outcomes["none" if want is None else "image"] += 1
    assert outcomes["image"] > 0 and outcomes["none"] > 0, outcomes


def test_large_values_come_out_as_cv2_converts_them(tmp_path):
    """m * 255 * 2^(e - 136) of 2^31 or more is INT_MIN to cv2's
    rounding and saturates to 0 (255 * 2^23 and 510 * 2^22 lie just
    below it, 65025 * 2^23 above); the rest saturate to 255."""
    px = np.zeros((1, 8, 4), np.uint8)
    px[0, :, 0] = [1, 255, 1, 255, 2, 0, 128, 1]
    px[0, :, 3] = [150, 150, 159, 159, 158, 200, 255, 1]
    data = HEADERS["radiance"] + b"-Y 1 +X 8\n" + px.tobytes()
    want = _readers_match_cv2(data, tmp_path)
    assert want[0, :, 0].tolist() == [255, 255, 255, 0, 255, 0, 0, 0]


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (2, 8), (3, 9), (17, 23),
                                   (5, 130), (2, 300), (1, 32767),
                                   (1, 32768)])
def test_writer_bytes_equal_cv2(shape):
    """Flat scanlines under 8 and over 32767 wide, run-length ones
    between, on noise, runs, black and white: C and plain bytes equal
    cv2.imencode's, for .hdr and .pic."""
    rng = np.random.default_rng(sum(shape))
    rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    rgb[:, : shape[1] // 3] = rng.integers(0, 256, 3)
    rgb[-1, -2:] = 0
    rgb[0, :1] = 255
    want = _cv2_bytes(rgb)
    assert want == _cv2_bytes(rgb, ".pic")
    for suffix in (".hdr", ".pic", ".HDR"):
        assert image_io.encode_image(rgb, suffix) == want
    assert image_io.encode_image_plain(rgb, ".pic") == want
    assert hdr.encode_plain(rgb) == want


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 6), w=st.integers(1, 40),
       levels=st.sampled_from([0, 2, 3, 256]), seed=st.integers(0, 2**16))
def test_writer_bytes_equal_cv2_on_random_images(h, w, levels, seed):
    """Random uint8 images (`levels` 0: all black; 2 and 3: few values,
    long runs): C and plain bytes equal cv2.imencode's, and what they
    write reads back as cv2 reads it."""
    rng = np.random.default_rng(seed)
    if levels:
        rgb = (rng.integers(0, levels, (h, w, 3)) * (255 // max(
            levels - 1, 1))).astype(np.uint8)
    else:
        rgb = np.zeros((h, w, 3), np.uint8)
    want = _cv2_bytes(rgb)
    assert image_io.encode_image(rgb, ".hdr") == want
    assert image_io.encode_image_plain(rgb, ".hdr") == want
    np.testing.assert_array_equal(image_io.decode_image(want), _cv2(want))


def test_write_image_writes_what_cv2_imwrite_writes(tmp_path):
    rgb = RNG.integers(0, 256, (11, 19, 3), dtype=np.uint8)
    for suffix in (".hdr", ".pic"):
        ours, theirs = tmp_path / f"ours{suffix}", tmp_path / f"cv2{suffix}"
        assert image_io.write_image(ours, rgb)
        assert cv2.imwrite(str(theirs), np.ascontiguousarray(rgb[:, :, ::-1]))
        assert ours.read_bytes() == theirs.read_bytes()
        np.testing.assert_array_equal(image_io.read_image(ours),
                                      cv2.imread(str(theirs))[:, :, ::-1])
