"""The Exif orientation of a JPEG whose header holds bytes that are no
marker segment, against cv2 5.0 (libjpeg-turbo 3.1). OpenCV takes the
Exif from the APP1 segments libjpeg saved while it walked the header
(jdmarker.c read_markers / next_marker): stray bytes and FF 00 pairs are
skipped with a warning, TEM and RST0-7 pass as markers without a length,
fill bytes are skipped, and a marker libjpeg does not know (JPG0) or a
second SOI refuses the file. Each case puts one such insertion
(`image_samples.STRAY_JPEG_BYTES`) before one header segment of the two
`kind_orient*` fixtures (APP1 right after SOI), of a Pillow JPEG (APP1
after APP0) and of the Pillow JPEG's segments rearranged (the APP1 after
DQT, SOF or DHT; DRI, COM and APP2 around it; two APP1s, or an XMP APP1
before the Exif one), and holds `decode_image` and `decode_image_plain`
to `cv2.imdecode`, `read_image` to `cv2.imread` and `image_size` to the
shape cv2.imread returns: the same pixels, turned or not, or a refusal
everywhere where cv2 returns no image. The committed `stray_sha256`
digests and the photo's `exif_stray` recipe (which the smoke script
replays) are held to cv2 too.
"""

import io
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from multiposenet_tpu_torch.tools import image_samples as samples
from multiposenet_tpu_torch.utils import image_io, jpeg
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
ORIENTED = ("kind_orient3_le_40x64.jpg", "kind_orient6_be_40x64.jpg")


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
        + payload


def _exif(orientation: int, order: bytes = b"MM") -> bytes:
    e = ">" if order == b"MM" else "<"
    return _segment(0xE1, b"Exif\x00\x00" + order
                    + struct.pack(e + "HIHHHIHHI", 42, 8, 1, 0x0112, 3, 1,
                                  orientation, 0, 0))


def _pillow_jpeg() -> bytes:
    """A 24x40 Pillow JPEG with Exif orientation 6: SOI, APP0, APP1, two
    DQT, SOF0, four DHT, SOS."""
    rgb = np.random.RandomState(0).randint(0, 256, (24, 40, 3)) \
        .astype(np.uint8)
    exif = Image.Exif()
    exif[0x0112] = 6
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", exif=exif.tobytes())
    return buf.getvalue()


PILLOW = _pillow_jpeg()


def _segments(data: bytes) -> tuple[dict, bytes]:
    """The header segments by kind (lists, in order) and the rest from
    the first SOS on."""
    offsets = samples.jpeg_header_offsets(data)
    kinds: dict = {}
    for a, b in zip(offsets, offsets[1:]):
        kinds.setdefault(data[a + 1], []).append(data[a:b])
    return kinds, data[offsets[-1]:]


def _arranged(order: str) -> bytes:
    """The Pillow JPEG's segments in `order` (names joined by spaces)."""
    kinds, rest = _segments(PILLOW)
    named = {"APP0": kinds[0xE0][0], "APP1": kinds[0xE1][0],
             "DQT": b"".join(kinds[0xDB]), "SOF": kinds[0xC0][0],
             "DHT": b"".join(kinds[0xC4]),
             "DRI": _segment(0xDD, b"\x00\x00"),
             "COM": _segment(0xFE, b"written by hand"),
             "APP2": _segment(0xE2, b"ICC_PROFILE\x00\x01\x01"),
             "XMP": _segment(0xE1, b"http://ns.adobe.com/xap/1.0/\x00<x/>"),
             "EXIF3": _exif(3, b"II")}
    return b"\xff\xd8" + b"".join(named[n] for n in order.split()) + rest


ARRANGEMENTS = {
    "app1_after_dqt": "APP0 DQT APP1 SOF DHT",
    "app1_after_sof": "APP0 DQT SOF APP1 DHT",
    "app1_before_sos": "APP0 DQT SOF DHT APP1",
    "dri_com_app2_around_app1": "APP0 DRI COM APP1 APP2 COM DQT SOF DHT",
    "two_app1": "APP0 APP1 EXIF3 DQT SOF DHT",
    "two_app1_other_first": "APP0 EXIF3 APP1 DQT SOF DHT",
    "xmp_app1_first": "APP0 XMP APP1 DQT SOF DHT",
}


def _cv2(data: bytes, path: Path | None = None):
    if path is not None:
        path.write_bytes(data)
        bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    else:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[:, :, ::-1]


def _outcome(read, *args):
    try:
        return read(*args)
    except ValueError:
        return None


def _same(got, want) -> bool:
    return (got is None) == (want is None) and (
        want is None or (got.shape == want.shape
                         and np.array_equal(got, want)))


def _hold(data: bytes, path: Path) -> np.ndarray | None:
    """Every reader and image_size against cv2 on `data`; cv2's decode."""
    want = _cv2(data)
    want_file = _cv2(data, path)
    assert _same(_outcome(image_io.decode_image, data), want)
    assert _same(_outcome(image_io.decode_image_plain, data), want)
    assert _same(_outcome(image_io.read_image, path), want_file)
    size = _outcome(image_io.image_size, path)
    assert size == (None if want_file is None else want_file.shape[:2])
    return want


def _insertions(data: bytes, extra: str, path: Path) -> list:
    """`extra` before every header segment of `data`, each held to cv2;
    cv2's decodes."""
    return [_hold(samples.corrupted(data, f"{at}+{extra}"), path)
            for at in samples.jpeg_header_offsets(data)]


@pytest.mark.parametrize("extra", samples.STRAY_JPEG_BYTES)
@pytest.mark.parametrize("name", [*ORIENTED, "pillow"])
def test_stray_bytes_before_each_header_segment_match_cv2(tmp_path, name,
                                                          extra):
    data = PILLOW if name == "pillow" else (FIXTURES / name).read_bytes()
    clean = _hold(data, tmp_path / "x.jpg")
    assert clean.shape[:2] == {"pillow": (40, 24)}.get(name, (
        (64, 40) if "orient6" in name else (40, 64)))
    wants = _insertions(data, extra, tmp_path / "x.jpg")
    if extra.startswith("fff0"):
        # JPG0 is refused wherever it stands.
        assert all(w is None for w in wants)
        return
    # Wherever it stands, the image reads as without the insertion, but
    # right after SOI only a marker keeps the file a JPEG to cv2 (whose
    # signature is FF D8 FF).
    assert all(_same(w, clean) for w in wants[1:])
    assert _same(wants[0], clean if extra.startswith("ff") else None)


@pytest.mark.parametrize("extra", samples.STRAY_JPEG_BYTES[:-1])
@pytest.mark.parametrize("order", list(ARRANGEMENTS))
def test_stray_bytes_around_app1_anywhere_in_the_header_match_cv2(
        tmp_path, order, extra):
    """The Exif APP1 after DQT, SOF or DHT, among DRI, COM and APP2, after
    another Exif APP1 or an XMP one: an insertion before each APP1 and
    before the segment after it leaves cv2's choice of block and
    orientation as it was."""
    data = _arranged(ARRANGEMENTS[order])
    clean = _hold(data, tmp_path / "x.jpg")
    want_turned = order != "two_app1_other_first"
    assert clean.shape[:2] == ((40, 24) if want_turned else (24, 40))
    offsets = samples.jpeg_header_offsets(data)
    around = sorted({offsets[i + k] for i, at in enumerate(offsets)
                     if data[at + 1] == 0xE1 for k in (0, 1)})
    for at in around:
        want = _hold(samples.corrupted(data, f"{at}+{extra}"),
                     tmp_path / "x.jpg")
        assert _same(want, clean)


@pytest.mark.parametrize("marker", ["ffd8", "ffd9", "ffc8", "ffde",
                                    "fff7", "ff4f"])
def test_markers_libjpeg_refuses_before_each_header_segment_refuse(
        tmp_path, marker):
    """A second SOI, an EOI before the first SOS, and markers libjpeg does
    not take there (JPG, DHP, JPG7, a reserved code), put before any
    header segment after the first: cv2 returns no image, and every
    reader and `image_size` refuse."""
    data = (FIXTURES / ORIENTED[1]).read_bytes()
    assert all(w is None for w in
               _insertions(data, marker, tmp_path / "x.jpg")[1:])


@pytest.mark.parametrize("length", [0, 1, 2])
def test_app_segments_of_bogus_length_before_app1_match_cv2(tmp_path,
                                                            length):
    """An APPn whose length field is below 2 is read as an empty segment
    (libjpeg's save_marker and skip_variable), so the Exif APP1 after it
    still counts; so does one after an empty APP1."""
    for marker in (0xE1, 0xE2, 0xEF):
        bogus = bytes([0xFF, marker]) + struct.pack(">H", length)
        data = PILLOW[:20] + bogus + PILLOW[20:]
        want = _hold(data, tmp_path / "x.jpg")
        assert want.shape[:2] == (40, 24)
        assert image_io.exif_orientation(jpeg.exif_block(data)) == 6


def test_exif_block_walks_the_header_as_libjpeg(tmp_path):
    """`exif_block` finds the block behind every insertion cv2 skips and
    none behind those it refuses, or after the first SOS."""
    data = (FIXTURES / ORIENTED[1]).read_bytes()
    for extra in samples.STRAY_JPEG_BYTES:
        block = jpeg.exif_block(samples.corrupted(data, f"2+{extra}"))
        if extra.startswith("fff0"):
            assert block is None
        else:
            assert image_io.exif_orientation(block) == 6
    sos = data.index(b"\xff\xda")
    app1, rest = data[2:38], data[:2] + data[38:]
    before_sos = data[:2] + data[38:sos] + b"\x00" + app1 + data[sos:]
    assert image_io.exif_orientation(jpeg.exif_block(before_sos)) == 6
    assert _hold(before_sos, tmp_path / "x.jpg").shape[:2] == (64, 40)
    after_scan = rest[:-2] + app1 + rest[-2:]
    assert jpeg.exif_block(after_scan) is None
    assert _hold(after_scan, tmp_path / "x.jpg").shape[:2] == (40, 64)


@pytest.mark.parametrize("name", ORIENTED)
def test_committed_stray_digests_equal_cv2(name):
    data = (FIXTURES / name).read_bytes()
    outcomes = [samples.outcome(_cv2(samples.corrupted(data, r)))
                for r in samples.stray_recipes(data)]
    assert samples.outcomes_sha256(outcomes) == DIGESTS[name]["stray_sha256"]


def test_committed_photo_exif_recipe_equals_cv2(tmp_path):
    """The smoke script's `predict` input: the photo with stray bytes and
    an Exif APP1 of orientation 6 put before its DQT."""
    name = "photo_480x640_q95_420.jpg"
    recipe = DIGESTS[name]["exif_stray"]
    data = samples.corrupted((FIXTURES / name).read_bytes(), recipe["at"])
    want = _cv2(data)
    assert want.shape == (640, 480, 3)
    assert samples.outcome(want).split()[1] == recipe["rgb_sha256"]
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(image_io.read_image(path), want)
    assert image_io.image_size(path) == (640, 480)
