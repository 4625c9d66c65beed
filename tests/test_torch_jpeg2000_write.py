"""JPEG 2000 writing against cv2 5.0 (OpenJPEG 2.5.3 at cv2's defaults):
`jpeg2000_write.encode` (the host C library, `image_io.encode_image`)
gives the bytes of `cv2.imencode(".jp2", bgr)` at the sides 32, 33, 47,
64, 65 and 97 crossed with noise, flat colour, ramps and crops of the
photo fixture (lossless where the rate does not bind, truncated where it
does), on a drawing of a scene fixture, on every committed fixture (the
`imencode_jp2_sha256` digests the card's machine checks) and on a
seeded slice of `tools/jpeg2000_write_search.py`; the plain Python tiers
(`encode_plain`, `image_io.encode_image_plain`) give the same bytes on a
few of them and on images at the writer's corners (no coefficient to
code, one, full-swing checkers and stripes). The forward 5/3 inverts
exactly through the decoder's inverse on every size from 32 to 97, the
distortion tables are `t1_generate_luts.c`'s, and with a side under 32
`write_image` returns False and leaves in its file the 77 bytes of JP2
boxes that cv2.imwrite leaves (OpenJPEG writes them before it refuses
the size).
"""

import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from multiposenet_tpu_torch.tools import jpeg2000_write_search as search
from multiposenet_tpu_torch.utils import (image_io, jpeg2000, jpeg2000_write,
                                          visualize)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
SIDES = (32, 33, 47, 64, 65, 97)
KINDS = ("noise", "flat", "ramps", "photo")


def _cv2_bytes(rgb: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".jp2", np.ascontiguousarray(rgb[:, :, ::-1]))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("side", SIDES)
def test_c_writer_equals_cv2(side, kind):
    """Square images of each kind: the C writer's file is cv2's, byte for
    byte. Noise is cut to the budget (cv2 reads its own file back lossy),
    flat colour fits it whole (lossless)."""
    rgb = search.image(kind, side, side, side)
    want = _cv2_bytes(rgb)
    assert image_io.encode_image(rgb, ".jp2") == want
    back = cv2.imdecode(np.frombuffer(want, np.uint8), cv2.IMREAD_COLOR)
    lossless = np.array_equal(back[:, :, ::-1], rgb)
    assert lossless if kind == "flat" else True
    assert not lossless if kind == "noise" else True


def _edge_image(kind: str, h: int, w: int) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    if kind == "mid_gray":  # every coefficient 0: no coding pass at all
        return np.full((h, w, 3), 128, np.uint8)
    if kind in ("black", "white"):
        return np.full((h, w, 3), 0 if kind == "black" else 255, np.uint8)
    if kind == "dot":
        rgb = np.full((h, w, 3), 128, np.uint8)
        rgb[h // 2, w // 3] = (255, 0, 7)
        return rgb
    period = {"checker": 1, "checker2": 2}.get(kind)
    if period:
        cells = (x // period + y // period) % 2
    else:  # "stripes": rows
        cells = y % 2
    return np.repeat((cells * 255)[..., None], 3, 2).astype(np.uint8)


@pytest.mark.parametrize("shape", [(32, 32), (40, 77)])
@pytest.mark.parametrize("kind", ["mid_gray", "black", "white", "dot",
                                  "checker", "checker2", "stripes"])
def test_edge_images_equal_cv2(kind, shape):
    """Images that reach the writer's corners: no coefficient to code,
    one coefficient, the highest frequencies at full swing. C and plain
    equal cv2."""
    rgb = _edge_image(kind, *shape)
    want = _cv2_bytes(rgb)
    assert jpeg2000_write.encode(rgb) == want
    assert jpeg2000_write.encode_plain(rgb) == want


@pytest.mark.parametrize("kind, h, w", [("noise", 32, 33), ("photo", 47, 32),
                                        ("ramps", 33, 47), ("flat", 32, 32)])
def test_plain_writer_equals_c_and_cv2(kind, h, w):
    rgb = search.image(kind, h, w, h * w)
    want = _cv2_bytes(rgb)
    assert jpeg2000_write.encode_plain(rgb) == want
    assert image_io.encode_image_plain(rgb, ".jp2") == want
    assert jpeg2000_write.encode(rgb) == want


def test_scene_drawing_equals_cv2(tmp_path):
    """A scene fixture with people drawn on it, written by write_image
    as cv2.imwrite writes it."""
    scene = image_io.read_image(FIXTURES / "scene_00_420_q75.jpg")
    h, w = scene.shape[:2]
    rng = np.random.default_rng(3)
    people = []
    for _ in range(3):
        kp = np.concatenate([rng.uniform((0, 0), (w, h), (17, 2)),
                             rng.uniform(0.2, 1.0, (17, 1))], 1)
        x0, y0 = kp[:, :2].min(0)
        x1, y1 = kp[:, :2].max(0)
        people.append(type("Person", (), {
            "box": np.array([x0, y0, x1, y1]), "score": 0.9,
            "keypoints": kp}))
    drawn = visualize.draw_predictions(scene, people)
    assert not np.array_equal(drawn, scene)
    path = tmp_path / "drawn.jp2"
    assert image_io.write_image(path, drawn)
    assert cv2.imwrite(str(tmp_path / "cv2.jp2"),
                       np.ascontiguousarray(drawn[:, :, ::-1]))
    assert path.read_bytes() == (tmp_path / "cv2.jp2").read_bytes()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixtures_equal_cv2_digest(name, tmp_path):
    """Every committed fixture's pixels, as the card's machine checks them:
    the C writer's .jp2 is cv2's (its recorded digest), or, with a side
    under 32, cv2.imencode writes nothing (digest null) and write_image
    returns False."""
    rgb = image_io.read_image(FIXTURES / name)
    digest = DIGESTS[name]["imencode_jp2_sha256"]
    if min(rgb.shape[:2]) < 32:
        assert digest is None
        assert not cv2.imencode(".jp2", np.ascontiguousarray(
            rgb[:, :, ::-1]))[0]
        assert not image_io.write_image(tmp_path / "x.jp2", rgb)
        return
    want = _cv2_bytes(rgb)
    assert hashlib.sha256(want).hexdigest() == digest
    assert image_io.encode_image(rgb, ".jp2") == want


@pytest.mark.parametrize("shape", [(31, 64), (64, 31), (17, 23), (33, 31),
                                   (1, 1)])
def test_side_under_32_writes_only_the_jp2_boxes(shape, tmp_path):
    """cv2.imwrite returns False and leaves the JP2 boxes OpenJPEG wrote
    before it refused the size; write_image does the same, and the
    encoders raise where cv2.imencode fails."""
    rgb = search.image("noise", shape[0] + 4, shape[1] + 4,
                       0)[:shape[0], :shape[1]]
    ours, theirs = tmp_path / "x.jp2", tmp_path / "cv2.jp2"
    assert not cv2.imwrite(str(theirs), np.ascontiguousarray(rgb[:, :, ::-1]))
    assert not image_io.write_image(ours, rgb)
    assert ours.read_bytes() == theirs.read_bytes() \
        == jpeg2000_write.jp2_header(*shape)
    assert len(ours.read_bytes()) == 77
    assert not cv2.imencode(".jp2", np.ascontiguousarray(rgb[:, :, ::-1]))[0]
    for encode in (jpeg2000_write.encode, jpeg2000_write.encode_plain):
        with pytest.raises(ValueError, match="under 32"):
            encode(rgb)


def test_write_image_writes_what_cv2_imwrite_writes(tmp_path):
    """At the smallest sides cv2 writes and in upper case; the port's
    decoder reads the file back as cv2 does."""
    for shape in ((32, 32), (32, 130), (130, 32)):
        rgb = search.image("photo", *shape, 7)
        for suffix in (".jp2", ".JP2"):
            ours, theirs = tmp_path / f"ours{suffix}", tmp_path / "cv2.jp2"
            assert image_io.write_image(ours, rgb)
            assert cv2.imwrite(str(theirs),
                               np.ascontiguousarray(rgb[:, :, ::-1]))
            assert ours.read_bytes() == theirs.read_bytes()
            np.testing.assert_array_equal(
                image_io.read_image(ours),
                cv2.imread(str(theirs), cv2.IMREAD_COLOR)[:, :, ::-1])


def test_forward_53_inverts_exactly_through_the_decoder():
    """Every size from 32 to 97 (each height against a width of its own),
    extreme and random samples: `forward_dwt` then the decoder's
    `inverse_dwt` gives the level-shifted samples back."""
    rng = np.random.default_rng(0)
    for n in range(32, 98):
        h, w = n, 129 - n
        geometry = jpeg2000.tile_geometry((0, 0, w, h),
                                          jpeg2000_write._Params)
        for plane in (rng.integers(-128, 128, (h, w)),
                      np.where(rng.random((h, w)) < 0.5, -128, 127)):
            coeffs = jpeg2000_write.forward_dwt(plane, geometry)
            back = coeffs.astype(np.int32)
            jpeg2000.inverse_dwt(back, geometry, jpeg2000_write.NUMRES, True)
            np.testing.assert_array_equal(back, plane)


def test_distortion_tables_are_t1_generate_luts():
    """The formula's tables where OpenJPEG's t1_luts.h can be checked by
    hand: no decrease below 0.75 of a step on significance, the half-step
    values at the step, and refinement's decrease 0 at bit-plane 0 for a
    set bit."""
    sig, sig0, ref, ref0 = jpeg2000_write.nmsedec_tables()
    assert sig[:49] == [0] * 49 and sig[49] == 0x0180
    assert sig[64] == 6144 and sig0[64] == 8192 and sig0[0] == 0
    assert ref0[64] == 0 and ref0[0] == 8192
    assert ref[64] == 0 and ref[96] == 2048
    assert all(v % 128 == 0 for t in (sig, sig0, ref, ref0) for v in t)


def test_seeded_search_slice_equals_cv2():
    """`jpeg2000_write_search` on the first 20 cases of seed 0 (every kind
    twice, sides 32 to 129): no difference. The full search is the
    script's."""
    result = search.search(search.cases(20, seed=0))
    assert result["cases"] == 20
    assert result["differences"] == [], result


def test_c_library_reports_the_size_a_short_buffer_needs():
    """`j2k_encode_tile` writes nothing into a buffer too small for the
    packets and returns 3 with the size they need; given that size it
    writes them."""
    import ctypes

    rgb = search.image("noise", 40, 40, 1)
    maxlen = jpeg2000_write.budget(40, 40, jpeg2000_write.header_bytes(40,
                                                                       40))
    want = jpeg2000_write.tile_data_c(rgb, maxlen)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib = jpeg2000.library()
    for cap, rc in ((16, 3), (len(want), 0)):
        out = np.zeros(cap, np.uint8)
        n = ctypes.c_long(0)
        assert lib.j2k_encode_tile(rgb.ctypes.data_as(u8p), 40, 40, maxlen,
                                   out.ctypes.data_as(u8p), cap,
                                   ctypes.byref(n)) == rc
        assert n.value == len(want)
    assert out.tobytes() == want
