"""GIF writing against cv2 5.0 (`grfmt_gif.cpp`'s encoder at its
defaults): the C coder (`gif.encode`, `image_io.encode_image`) and the
plain one (`gif.encode_plain`, `image_io.encode_image_plain`) give the
bytes of `cv2.imencode(".gif", bgr)` for every image here: thin, odd and
tiny sizes, flat colours on the dithering's half-steps, saturated noise
whose diffused error passes 0 and 255, a gradient, noise whose LZW table
clears several times, rows whose codes end just as the table reaches a
new code width or 4096 entries, seeded random images and every committed
fixture (against the `imencode_gif_sha256` digests the card's machine
checks). `write_image` writes what `cv2.imwrite` writes, and past 65535
pixels a side neither writes a file.
"""

import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from multiposenet_tpu_torch.utils import gif, image_io
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
PLAIN_PIXELS = 40_000


def _cv2_bytes(rgb: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".gif", np.ascontiguousarray(rgb[:, :, ::-1]))
    assert ok
    return buf.tobytes()


def _all_equal_cv2(rgb: np.ndarray) -> bytes:
    want = _cv2_bytes(rgb)
    assert gif.encode(rgb) == want
    assert gif.encode_plain(rgb) == want
    assert image_io.encode_image(rgb, ".gif") == want
    return want


def _lzw_codes(data: bytes) -> tuple[list[int], int]:
    """The codes of a file's one frame, read at the widths a GIF decoder
    reads them, and the decoder's table size after the last code before
    the end code."""
    pos = data.index(b"\x2c", 13 + 3 * 256 + 27) + 10
    assert data[pos] == 8
    payload, _ = gif._blocks(data, pos + 1, "gif")
    acc = int.from_bytes(payload, "little")
    codes, size, width, first = [], 258, 9, True
    while True:
        code = acc & ((1 << width) - 1)
        acc >>= width
        codes.append(code)
        if code == 257:
            return codes, size
        if code == 256:
            size, width, first = 258, 9, True
            continue
        if not first and size < 4096:
            size += 1
        first = False
        if size == 1 << width and width < 12:
            width += 1


def _noise(shape, seed, values=None):
    rng = np.random.default_rng(seed)
    if values is None:
        return rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    return rng.choice(np.asarray(values, np.uint8), shape + (3,))


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 1), (1, 300),
                                   (300, 1), (5, 7), (31, 17), (17, 23)])
def test_sizes_equal_cv2(shape):
    data = _all_equal_cv2(_noise(shape, sum(shape)))
    h, w = shape
    assert data[6:10] == bytes([w & 255, w >> 8, h & 255, h >> 8])


@pytest.mark.parametrize("bgr", [(42, 18, 54), (128, 90, 162), (85, 36, 18),
                                 (212, 126, 234)])
def test_flat_half_steps_round_up(bgr):
    """Red and green half a step of 36 over a level (18, 54, 90, 126,
    162, 234) go up, as halves to even would not; blue (steps of 85) lies
    just under (42) and over (128) its half-step, or on a level (85)."""
    rgb = np.broadcast_to(np.asarray(bgr[::-1], np.uint8), (9, 13, 3))
    data = _all_equal_cv2(np.ascontiguousarray(rgb))
    back = image_io.decode_image(data)
    np.testing.assert_array_equal(back, cv2.imdecode(
        np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1])


@pytest.mark.parametrize("shape,values", [
    ((24, 30), (0, 255)), ((40, 40), (0, 1, 254, 255)),
    ((23, 37), (0, 18, 54, 127, 128, 212, 255))])
def test_saturated_noise_equal_cv2(shape, values):
    """Pixels at 0 and 255 push the diffused value past the clamp: the
    level comes from the clamped value, the error from the unclamped
    one."""
    _all_equal_cv2(_noise(shape, len(values), values))


def test_gradient_equal_cv2():
    y, x = np.mgrid[0:64, 0:96]
    rgb = np.stack([x * 255 // 95, y * 4, (x + y) * 255 // 158], -1)
    _all_equal_cv2(rgb.astype(np.uint8))


def test_noise_clears_the_table_every_3839_codes():
    data = _all_equal_cv2(_noise((120, 160), 5))
    codes, _ = _lzw_codes(data)
    clears = [i for i, c in enumerate(codes) if c == 256]
    assert len(clears) >= 5
    assert clears == list(range(0, 3839 * len(clears), 3839))


def _wide(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    if kind == "levels":
        return rng.choice(np.array([0, 18, 42, 54, 90, 126, 128, 162, 212,
                                    255], np.uint8), (480, 640, 3))
    y, x = np.mgrid[0:480, 0:640]
    base = 128 + 100 * np.sin(x[..., None] / (20 + 7 * np.arange(3))
                              + y[..., None] / 31)
    return np.clip(base + rng.normal(0, 4, (480, 640, 3)), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("kind,seed", [("levels", 6), ("smooth", 4),
                                       ("noise", 2)])
def test_float32_error_rows_at_480x640(kind, seed):
    """Seeded 480x640 images picked because another width or order of the
    dithering's arithmetic turns a level on them: the errors added into a
    float32 or float64 copy of the image, error rows in float64, or a
    step taken through its reciprocal."""
    _all_equal_cv2(_wide(kind, seed))


# Widths of one seeded noise row whose codes end with the decoder's table
# one short of, or at, 512, 1024, 2048 and 4096 entries: the end code's
# width and the clear that does not follow the last code.
ROW = np.random.RandomState(11).randint(0, 256, (1, 4002, 3)).astype(
    np.uint8)


@pytest.mark.parametrize("width,table", [
    (254, 511), (255, 512), (776, 1023), (778, 1024), (1827, 2047),
    (1828, 2048), (4001, 4094), (4002, 4095)])
def test_code_width_and_table_edges_at_the_end(width, table):
    data = _all_equal_cv2(np.ascontiguousarray(ROW[:, :width]))
    codes, size = _lzw_codes(data)
    assert size == table and codes.count(256) == 1


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 8), w=st.integers(1, 40),
       levels=st.sampled_from([0, 2, 3, 7, 256]), seed=st.integers(0, 2**16))
def test_random_images_equal_cv2(h, w, levels, seed):
    rng = np.random.default_rng(seed)
    if levels:
        rgb = (rng.integers(0, levels, (h, w, 3)) * (255 // max(
            levels - 1, 1))).astype(np.uint8)
    else:
        rgb = np.full((h, w, 3), seed & 255, np.uint8)
    _all_equal_cv2(rgb)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixtures_equal_cv2_digest(name):
    """Every committed fixture's pixels, as the card's machine checks them
    (C always, plain up to 40,000 pixels), against cv2's bytes and the
    recorded digest."""
    rgb = image_io.read_image(FIXTURES / name)
    want = _cv2_bytes(rgb)
    assert hashlib.sha256(want).hexdigest() == \
        DIGESTS[name]["imencode_gif_sha256"]
    assert image_io.encode_image(rgb, ".gif") == want
    if rgb.shape[0] * rgb.shape[1] <= PLAIN_PIXELS:
        assert image_io.encode_image_plain(rgb, ".gif") == want


def test_write_image_writes_what_cv2_imwrite_writes(tmp_path):
    """Also at the largest side cv2 writes; the file reads back, through
    the port's reader, as cv2 reads it: the dithered palette colours."""
    for rgb in (_noise((11, 19), 3), _noise((1, 65535), 4)):
        for suffix in (".gif", ".GIF"):
            ours, theirs = tmp_path / f"ours{suffix}", tmp_path / "cv2.gif"
            assert image_io.write_image(ours, rgb)
            assert cv2.imwrite(str(theirs),
                               np.ascontiguousarray(rgb[:, :, ::-1]))
            assert ours.read_bytes() == theirs.read_bytes()
            np.testing.assert_array_equal(
                image_io.read_image(ours), cv2.imread(str(theirs))[:, :, ::-1])
    assert gif.encode_plain(rgb) == theirs.read_bytes()


@pytest.mark.parametrize("shape", [(1, 65536), (65536, 1)])
def test_past_65535_a_side_nothing_is_written(shape, tmp_path):
    rgb = np.zeros(shape + (3,), np.uint8)
    assert not cv2.imwrite(str(tmp_path / "cv2.gif"), rgb)
    assert not (tmp_path / "cv2.gif").exists()
    assert image_io.write_image(tmp_path / "ours.gif", rgb) is False
    assert not (tmp_path / "ours.gif").exists()
    for encode in (gif.encode, gif.encode_plain):
        with pytest.raises(ValueError, match="65535"):
            encode(rgb)
