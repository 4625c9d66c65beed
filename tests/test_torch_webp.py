"""WebP against cv2 5.0 (libwebp 1.6): every committed `webp_*` fixture and
every variant made here from numpy seeds (cv2's and Pillow's writers,
containers spliced byte by byte, truncations and flipped bits) read by
`decode_image` (the C decoders of `csrc/webp.c`), `decode_image_plain`
(`utils/vp8l.py` and `utils/vp8.py`) and `read_image` (a file), equal to
`cv2.imdecode(buf, IMREAD_COLOR)` reversed to RGB, and refused with a
ValueError wherever cv2 returns no image; the lossless writer, C and
plain to the same bytes, read back exactly by cv2 and the port at no more
than 1.5 times cv2's size; `predict --output x.webp` and `--image
x.webp` against the JAX CLI; and the loader and `prepare` on a .webp.
"""

import hashlib
import io
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from make_image_fixtures import (exif_tiff, vp8x_chunk, webp_chunk,
                                 webp_chunks, webp_file)
from multiposenet_tpu_torch.utils import image_io, vp8l, webp
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
WEBP_FIXTURES = sorted(n for n in DIGESTS if n.endswith(".webp"))
PLAIN_PIXELS = 40_000  # the plain decoders and writer run up to this size
RNG = np.random.default_rng(17)


def _cv2(data: bytes):
    try:
        r = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None
    return None if r is None else r[:, :, ::-1]


def _readers_match_cv2(data: bytes, tmp_path, plain: bool = True):
    """decode_image, decode_image_plain and read_image against cv2: equal
    pixels, or all raise a ValueError where cv2 returns no image."""
    want = _cv2(data)
    path = tmp_path / "x.webp"
    path.write_bytes(data)
    readers = [image_io.decode_image, lambda d: image_io.read_image(path)]
    if plain:
        readers.append(image_io.decode_image_plain)
    for read in readers:
        if want is None:
            with pytest.raises(ValueError):
                read(data)
            continue
        got = read(data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    return want


def _texture(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = [128 + 70 * np.sin(xx / (2 + c) + yy / (5 + 2 * c))
              + rng.uniform(-25, 25, (h, w)) for c in range(3)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def _cv2_webp(rgb: np.ndarray, quality: int | None = None) -> bytes:
    params = [] if quality is None else [cv2.IMWRITE_WEBP_QUALITY, quality]
    ok, buf = cv2.imencode(".webp", np.ascontiguousarray(rgb[:, :, ::-1]),
                           params)
    assert ok
    return buf.tobytes()


def _pil_webp(pixels: np.ndarray, **options) -> bytes:
    out = io.BytesIO()
    Image.fromarray(pixels).save(out, "WEBP", **options)
    return out.getvalue()


# --- the committed fixtures ------------------------------------------------


def test_webp_fixtures_are_listed_and_within_budget():
    files = sorted(p.name for p in FIXTURES.glob("*.webp"))
    assert files == WEBP_FIXTURES and len(files) >= 20
    assert sum((FIXTURES / n).stat().st_size for n in files) <= 300_000


@pytest.mark.parametrize("name", WEBP_FIXTURES)
def test_fixture_reads_as_cv2(name, tmp_path):
    """cv2's decode equals the committed digest (what chip_smoke holds the
    card's build to), and every reader of the port equals cv2's."""
    data = (FIXTURES / name).read_bytes()
    want = _cv2(data)
    assert hashlib.sha256(want.tobytes()).hexdigest() \
        == DIGESTS[name]["rgb_sha256"]
    _readers_match_cv2(data, tmp_path,
                       plain=want.shape[0] * want.shape[1] <= PLAIN_PIXELS)


def test_fixtures_cover_the_bitstream_features():
    """The fixtures reach every feature of each bitstream: VP8L's colour
    cache, meta codes, bundled palettes and all four transforms between
    them; VP8's simple and normal filters, 4 and 8 partitions, segments
    and an ALPH plane."""
    from multiposenet_tpu_torch.utils import vp8

    seen = set()
    real_undo, real_data = vp8l._undo_transform, vp8l._entropy_data

    def spy_undo(kind, bits, width, data, pixels):
        seen.add(("transform", kind, bits if kind == 3 else None))
        return real_undo(kind, bits, width, data, pixels)

    def spy_data(br, xsize, ysize, cache_bits, codes, meta, meta_bits):
        seen.add(("cache", cache_bits > 0))
        seen.add(("meta", meta is not None))
        return real_data(br, xsize, ysize, cache_bits, codes, meta,
                         meta_bits)

    for name in WEBP_FIXTURES:
        data = (FIXTURES / name).read_bytes()
        if "anim" in name or "480x640" in name:
            continue
        hd = webp.parse_headers(data, full=True)
        body = data[hd.offset:]
        if hd.lossless:
            vp8l._undo_transform, vp8l._entropy_data = spy_undo, spy_data
            try:
                vp8l.decode(body)
            finally:
                vp8l._undo_transform, vp8l._entropy_data = (real_undo,
                                                            real_data)
        else:
            h = vp8._parse_header(body)
            seen.update({("filter", h.filter_type), ("parts", len(h.parts)),
                         ("segments", h.use_segment),
                         ("alpha", hd.alpha is not None)})
    for want in [("cache", True), ("meta", True), ("transform", 0, None),
                 ("transform", 1, None), ("transform", 2, None),
                 ("transform", 3, 1), ("transform", 3, 2),
                 ("transform", 3, 3), ("filter", 1), ("filter", 2),
                 ("parts", 4), ("parts", 8), ("segments", 1),
                 ("alpha", True)]:
        assert want in seen, want


# --- variants made here ----------------------------------------------------


def _encoded_cases():
    tex = _texture(41, 57, 1)
    cases = {}
    for q in (0, 5, 35, 75, 97, 100):
        cases[f"cv2_q{q}"] = _cv2_webp(tex, q)
    for h, w in ((1, 1), (2, 2), (1, 17), (17, 1), (15, 16), (16, 17),
                 (31, 33), (33, 31)):
        cases[f"cv2_lossy_{h}x{w}"] = _cv2_webp(_texture(h, w, h * w), 70)
        cases[f"cv2_lossless_{h}x{w}"] = _cv2_webp(_texture(h, w, h + w))
    rgba = np.concatenate([tex, RNG.integers(0, 256, (41, 57, 1),
                                             dtype=np.uint8)], -1)
    rgba[:10, :, 3] = 0
    cases["pil_lossy_alpha"] = _pil_webp(rgba, quality=60)
    cases["pil_lossy_alpha_lossy_plane"] = _pil_webp(rgba, quality=60,
                                                     alpha_quality=40)
    cases["pil_lossless_alpha_exact"] = _pil_webp(rgba, lossless=True,
                                                  exact=True)
    for method in (0, 3, 6):
        cases[f"pil_lossless_m{method}"] = _pil_webp(tex, lossless=True,
                                                     method=method)
        cases[f"pil_lossy_m{method}"] = _pil_webp(tex, quality=80,
                                                  method=method)
    for n in (1, 2, 4, 5, 16, 17, 200):
        palette = RNG.integers(0, 256, (n, 3), dtype=np.uint8)
        cases[f"pil_palette{n}"] = _pil_webp(
            palette[RNG.integers(0, n, (23, 29))], lossless=True)
    return cases


ENCODED = _encoded_cases()


@pytest.mark.parametrize("name", sorted(ENCODED))
def test_encoded_variants_read_as_cv2(name, tmp_path):
    assert _readers_match_cv2(ENCODED[name], tmp_path) is not None


def _riff(chunks, extra: bytes = b"") -> bytes:
    """A RIFF/WEBP file of `chunks`, with `extra` bytes inside the RIFF
    after them."""
    body = webp_file(chunks)[12:] + extra
    return b"RIFF" + struct.pack("<I", len(body) + 4) + b"WEBP" + body


def _anmf(x: int, y: int, w: int, h: int, chunks) -> tuple:
    """An ANMF chunk holding `chunks` as they are (corrupt ones too)."""
    head = b"".join(v.to_bytes(3, "little") for v in (
        x // 2, y // 2, w - 1, h - 1, 100)) + b"\x00"
    return b"ANMF", head + b"".join(webp_chunk(t, p) for t, p in chunks)


def _container_cases():
    tex = _texture(20, 30, 5)
    ll = _cv2_webp(tex)
    ly = _cv2_webp(tex, 70)
    (vp8l_chunk,) = webp_chunks(ll)
    (vp8_chunk,) = webp_chunks(ly)
    rgba = np.concatenate([tex, _texture(20, 30, 6)[:, :, :1]], -1)
    vp8x_a, alph, vp8_a = webp_chunks(_pil_webp(rgba, quality=70))
    bad_alph = (b"ALPH", bytes([3]) + alph[1][1:])
    anim = (b"ANIM", struct.pack("<IH", 0xFF00FF00, 0))
    second = webp_chunks(_cv2_webp(_texture(30, 40, 7), 50))
    cases = {
        "simple_lossless": ll, "simple_lossy": ly,
        "trailing_4_inside_riff": _riff([vp8l_chunk], b"\0" * 4),
        "unknown_chunk_after": _riff([vp8l_chunk, (b"ABCD", b"xyz")]),
        "garbage_after_riff": ll + b"garbage",
        "riff_size_past_data": ll[:4] + struct.pack("<I", len(ll)) + ll[8:],
        "riff_size_short": ll[:4] + struct.pack("<I", len(ll) - 10) + ll[8:],
        "vp8x": _riff([vp8x_chunk(0, 30, 20), vp8l_chunk]),
        "vp8x_canvas_wrong": _riff([vp8x_chunk(0, 31, 20), vp8l_chunk]),
        "vp8x_unknown_flag": _riff([vp8x_chunk(1, 30, 20), vp8l_chunk]),
        "vp8x_size_11": _riff([(b"VP8X", vp8x_chunk(0, 30, 20)[1] + b"\0"),
                               vp8l_chunk]),
        "vp8x_animation_without_frames": _riff([vp8x_chunk(2, 30, 20),
                                                vp8l_chunk]),
        "raw_vp8l": vp8l_chunk[1], "raw_vp8": vp8_chunk[1],
        "exif6_after": _riff([vp8x_chunk(8, 30, 20), vp8_chunk,
                              (b"EXIF", exif_tiff(6, False))]),
        "exif6_before": _riff([vp8x_chunk(8, 30, 20),
                               (b"EXIF", exif_tiff(6, False)), vp8l_chunk]),
        "exif3_big_endian": _riff([vp8x_chunk(8, 30, 20), vp8l_chunk,
                                   (b"EXIF", exif_tiff(3, True))]),
        "exif_without_flag": _riff([vp8x_chunk(0, 30, 20), vp8l_chunk,
                                    (b"EXIF", exif_tiff(6, False))]),
        "exif_with_jpeg_prefix": _riff([
            vp8x_chunk(8, 30, 20), vp8l_chunk,
            (b"EXIF", b"Exif\0\0" + exif_tiff(6, False))]),
        "exif_demux_refuses_flags": _riff([
            vp8x_chunk(9, 30, 20), vp8l_chunk,
            (b"EXIF", exif_tiff(6, False))]),
        "exif_demux_refuses_trailer": _riff(
            [vp8x_chunk(8, 30, 20), vp8l_chunk,
             (b"EXIF", exif_tiff(6, False))], b"\0" * 4),
        "two_exif_first_wins": _riff([vp8x_chunk(8, 30, 20), vp8l_chunk,
                                      (b"EXIF", exif_tiff(8, False)),
                                      (b"EXIF", exif_tiff(6, False))]),
        "alpha": _riff([vp8x_a, alph, vp8_a]),
        "alpha_corrupt": _riff([vp8x_a, bad_alph, vp8_a]),
        "alpha_corrupt_without_flag": _riff([vp8x_chunk(0, 30, 20), bad_alph,
                                             vp8_a]),
        "alpha_good_then_corrupt": _riff([vp8x_a, alph, bad_alph, vp8_a]),
        "alpha_corrupt_then_good": _riff([vp8x_a, bad_alph, alph, vp8_a]),
        "alpha_after_image": _riff([vp8x_a, vp8_a, bad_alph]),
        "alpha_raw_plane": _riff([vp8x_a, (b"ALPH", b"\0" * 601), vp8_a]),
        "alpha_raw_plane_short": _riff([vp8x_a, (b"ALPH", b"\0" * 600),
                                        vp8_a]),
        "alpha_one_byte": _riff([vp8x_a, (b"ALPH", b"\1"), vp8_a]),
        "alpha_cut": _riff([vp8x_a, (b"ALPH", alph[1][:len(alph[1]) // 2]),
                            vp8_a]),
        "alpha_filter_3": _riff([vp8x_a, (b"ALPH", bytes([alph[1][0] | 12])
                                          + alph[1][1:]), vp8_a]),
        "alpha_reserved_bits": _riff([vp8x_a, (b"ALPH", bytes(
            [alph[1][0] | 0x40]) + alph[1][1:]), vp8_a]),
        "anim_first_frame_offset": _riff([
            vp8x_chunk(2, 40, 30), anim, _anmf(4, 6, 30, 20, [vp8l_chunk]),
            _anmf(0, 0, 40, 30, second)]),
        "anim_lossy_alpha_blend": _riff([
            vp8x_chunk(0x12, 40, 30), anim,
            _anmf(6, 2, 30, 20, [alph, vp8_a])]),
        "anim_frame_past_canvas": _riff([
            vp8x_chunk(2, 40, 30), anim, _anmf(12, 6, 30, 20, [vp8l_chunk])]),
        "anim_without_anim_chunk": _riff([
            vp8x_chunk(2, 40, 30), _anmf(0, 0, 30, 20, [vp8l_chunk])]),
        "anim_corrupt_first_frame": _riff([
            vp8x_chunk(2, 40, 30), anim,
            _anmf(0, 0, 30, 20, [(b"VP8L", vp8l_chunk[1][:60])])]),
        "anim_corrupt_second_frame": _riff([
            vp8x_chunk(2, 40, 30), anim, _anmf(0, 0, 30, 20, [vp8l_chunk]),
            _anmf(0, 0, 30, 20, [(b"VP8L", b"\x2f" + b"\0" * 12)])]),
        "anim_exif6": _riff([
            vp8x_chunk(0x0A, 40, 30), anim, _anmf(4, 6, 30, 20, [vp8l_chunk]),
            (b"EXIF", exif_tiff(6, False))]),
        "anim_alpha_before_vp8l": _riff([
            vp8x_chunk(2, 40, 30), anim, _anmf(0, 0, 30, 20, [alph,
                                                         vp8l_chunk])]),
    }
    return cases


CONTAINERS = _container_cases()


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_container_variants_read_as_cv2(name, tmp_path):
    _readers_match_cv2(CONTAINERS[name], tmp_path)


def test_cuts_and_flipped_bits_refused_exactly_where_cv2_refuses(tmp_path):
    """Every cut of a lossless, a lossy and an alpha file (its RIFF size
    left as written, and made to agree), and single flipped bits at
    seeded places: the port reads what cv2 reads and refuses the rest."""
    tex = _texture(13, 21, 9)
    rgba = np.concatenate([tex, _texture(13, 21, 10)[:, :, :1]], -1)
    files = [_cv2_webp(tex), _cv2_webp(tex, 80), _pil_webp(rgba, quality=70)]
    rng = np.random.default_rng(3)
    for data in files:
        for cut in range(32, len(data), 3):
            part = data[:cut]
            _readers_match_cv2(part, tmp_path)
            body = part[8:]
            _readers_match_cv2(b"RIFF" + struct.pack("<I", len(body)) + body,
                               tmp_path)
        for _ in range(60):
            flipped = bytearray(data)
            flipped[rng.integers(20, len(data))] ^= 1 << rng.integers(8)
            _readers_match_cv2(bytes(flipped), tmp_path)


@pytest.mark.parametrize("seed,shape,quality,flips", [
    (2, (38, 40), 80, [(402, 4)]), (3, (45, 45), 50, [(159, 0), (648, 3)])])
def test_corrupt_coefficients_take_libwebps_simd_transform(
        seed, shape, quality, flips, tmp_path, monkeypatch):
    """Flipped bits that make coefficients near +-30000: libwebp's x86
    decoder runs such blocks through Transform_SSE2, whose 16-bit sums
    wrap. cv2's pixels are that arithmetic's, and both decoders give them;
    the integer transform alone would not."""
    from multiposenet_tpu_torch.utils import vp8

    data = bytearray(_cv2_webp(_texture(*shape, seed), quality))
    for at, bit in flips:
        data[at] ^= 1 << bit
    want = _readers_match_cv2(bytes(data), tmp_path)
    assert want is not None
    monkeypatch.setattr(vp8, "_idct_add_simd", vp8._idct_add)
    assert not np.array_equal(image_io.decode_image_plain(bytes(data)), want)


def test_vp8l_c_equals_plain_on_corrupt_streams():
    """The C and plain VP8L decoders agree, pixels or refusal, on streams
    with bytes overwritten at random."""
    streams = [webp_chunks(_cv2_webp(_texture(9, 11, s)))[0][1]
               for s in range(3)]
    rng = np.random.default_rng(5)
    for k in range(300):
        data = bytearray(streams[k % 3])
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(5, len(data)))] = int(rng.integers(256))
        results = []
        for decode in (webp.vp8l_decode_c, vp8l.decode):
            try:
                results.append(decode(bytes(data)))
            except ValueError:
                results.append(None)
        if results[0] is None:
            assert results[1] is None
        else:
            np.testing.assert_array_equal(results[0], results[1])


def test_what_cv2_does_not_take_for_webp_is_refused_by_name():
    short = _cv2_webp(_texture(1, 1, 0))[:31]
    with pytest.raises(ValueError, match="WebP of 31 bytes"):
        image_io.decode_image(short)
    avi = b"RIFF" + struct.pack("<I", 36) + b"AVI LIST" + b"\0" * 32
    with pytest.raises(ValueError, match="RIFF b'AVI '"):
        image_io.decode_image(avi)
    assert _cv2(avi) is None


# --- the writer --------------------------------------------------------------


def _written_round_trip(rgb: np.ndarray, plain: bool = True) -> bytes:
    data = image_io.encode_image(rgb, ".webp")
    assert data[:4] == b"RIFF" and data[8:16] == b"WEBPVP8L"
    np.testing.assert_array_equal(_cv2(data), rgb)
    np.testing.assert_array_equal(image_io.decode_image(data), rgb)
    if plain:
        assert image_io.encode_image_plain(rgb, ".WEBP") == data
    return data


@pytest.mark.parametrize("name", sorted(n for n in DIGESTS
                                        if DIGESTS[n]["shape"][0]
                                        * DIGESTS[n]["shape"][1] <= 320_000))
def test_writer_on_fixtures_round_trips_within_1_5_of_cv2(name):
    """Each fixture's pixels, written: exact through cv2 and the port, C
    bytes = plain bytes (up to 40,000 pixels), and at most 1.5 times the
    size of cv2.imencode(".webp"), recorded in the digests."""
    rgb = cv2.imread(str(FIXTURES / name), cv2.IMREAD_COLOR)[:, :, ::-1]
    data = _written_round_trip(rgb, plain=rgb.shape[0] * rgb.shape[1]
                               <= PLAIN_PIXELS)
    theirs = DIGESTS[name]["imencode_webp_bytes"]
    assert theirs == len(_cv2_webp(rgb))
    assert len(data) <= 1.5 * theirs, (len(data), theirs)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24),
       colours=st.sampled_from([1, 2, 3, 5, 16, 17, 256, 257, 0]),
       seed=st.integers(0, 2**16))
def test_writer_round_trips_random_images_and_palettes(h, w, colours, seed):
    """Random pixels (`colours` 0: any) or palettes of 1 to 257 colours:
    exact round trip, C bytes = plain bytes."""
    rng = np.random.default_rng(seed)
    if colours:
        palette = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
        rgb = palette[rng.integers(0, colours, (h, w))]
    else:
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    _written_round_trip(rgb)


def test_writer_refuses_what_cv2_does_not_write(tmp_path):
    """cv2.imwrite of a side over 16383 pixels returns False and leaves no
    file; so does write_image, and encode_image raises."""
    rgb = np.zeros((2, 16384, 3), np.uint8)
    path = tmp_path / "wide.webp"
    assert not cv2.imwrite(str(path), rgb) and not path.exists()
    assert image_io.write_image(path, rgb) is False and not path.exists()
    with pytest.raises(ValueError, match="16383"):
        image_io.encode_image(rgb, ".webp")
    assert len(image_io.encode_image(np.zeros((2, 16383, 3), np.uint8),
                                     ".webp")) < 200


# --- the data pipeline -------------------------------------------------------


def test_loader_and_prepare_take_webp(tmp_path):
    """The loader's read_image and prepare's shards (decode_image) take a
    .webp as the JAX package's cv2 does."""
    from multiposenet_tpu.data import prepare as jprepare
    from multiposenet_tpu_torch.data import loader, prepare

    names = ["webp_lossy_q90_97x133.webp", "webp_lossless_cv2_97x133.webp"]
    images = [{"id": i, "file_name": n, "height": 97, "width": 133}
              for i, n in enumerate(names)]
    anns = [{"id": i + 1, "image_id": i, "category_id": 1, "iscrowd": 0,
             "bbox": [10.0, 10.0, 40.0, 50.0], "area": 2000.0,
             "keypoints": [20, 20, 2] * 17, "num_keypoints": 17}
            for i in range(len(names))]
    coco = tmp_path / "ann.json"
    coco.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": 1,
                                                "name": "person"}]}))
    for name in names:
        want = _cv2((FIXTURES / name).read_bytes())
        got = loader.load_image({"file_name": name}, str(FIXTURES))
        np.testing.assert_array_equal(got, want)
    prepare.prepare_coco(coco, FIXTURES, tmp_path / "port")
    jprepare.prepare_coco(coco, FIXTURES, tmp_path / "jax")
    got = list(prepare.read_shards(tmp_path / "port"))
    want = list(jprepare.read_shards(tmp_path / "jax"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
