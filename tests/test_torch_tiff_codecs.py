"""TIFF's JPEG (7) and CCITT (2, 3 and 4) compressions and its CMYK, YCbCr
and CIELab photometrics against cv2 5.0 (libtiff 4.7.1, libjpeg-turbo
3.1): every committed `tiff_*` fixture and every seeded variant read by
`decode_image` (the host C library), `decode_image_plain` (the plain
versions: `utils/ccitt.py`, `utils/jpeg.py decode_planes`, the NumPy
colour conversions) and `read_image`, equal to `cv2.imdecode(buf,
IMREAD_COLOR)` reversed to RGB, and refused with a ValueError that names
the variant wherever cv2 returns no image; cut and corrupted fax strips
decode, or fail, where cv2's do; the fax coders, C and plain, agree on
random streams; the 480x640 files the smoke script times read as cv2
reads them; and the formats cv2 itself does not read or write (the
"not a fault" list of ROADMAP.md) are refused by name.

Variants are made here from numpy seeds, with Pillow (its libtiff writes
JPEG and CCITT TIFFs, CMYK, YCbCr and LAB) and byte by byte
(`multiposenet_tpu_torch/tools/image_samples.py tiff_bytes`, with the
strips given as coded bytes) for YCbCr data units, JPEG streams of other
samplings, tiles, ReferenceBlackWhite, YCbCrCoefficients, WhitePoint and
FillOrder.
"""

import hashlib
import io
import json
import re
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from multiposenet_tpu_torch.tools import image_samples as samples
from multiposenet_tpu_torch.utils import ccitt, image_codec, image_io, tiff
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
TIFF_FIXTURES = sorted(n for n in DIGESTS if n.startswith("tiff_"))
RNG = np.random.default_rng(18)


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
    path = tmp_path / "x.tif"
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


def _pil(img, mode: str, **options) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).convert(mode).save(b, "TIFF", **options)
    return b.getvalue()


def _jpeg(rgb, subsampling: int, quality: int = 90) -> bytes:
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, "JPEG", quality=quality,
                              subsampling=subsampling)
    return b.getvalue()


def _smooth(shape) -> np.ndarray:
    return cv2.GaussianBlur(RNG.integers(0, 256, shape, np.uint8), (5, 5),
                            1.5)


def _tiles(img, tile, code) -> list:
    out = []
    for ty in range(0, img.shape[0], tile[0]):
        for tx in range(0, img.shape[1], tile[1]):
            blk = np.zeros(tile + img.shape[2:], img.dtype)
            part = img[ty:ty + tile[0], tx:tx + tile[1]]
            blk[:part.shape[0], :part.shape[1]] = part
            out.append(code(blk))
    return out


@pytest.mark.parametrize("name", TIFF_FIXTURES)
def test_fixtures_read_as_cv2(name, tmp_path):
    want = _readers_match_cv2((FIXTURES / name).read_bytes(), tmp_path)
    assert want is not None


def _variants() -> dict:
    t = samples.tiff_bytes
    cases = {}
    # JPEG: the colour space from the photometric, not from the markers.
    for h, w in ((37, 53), (1, 1), (16, 17)):
        img = _smooth((h, w, 3))
        for mode in ("RGB", "L", "CMYK", "YCbCr"):
            cases[f"jpeg_pil_{mode}_{h}x{w}"] = _pil(img, mode,
                                                     compression="jpeg")
        cases[f"jpeg_rgb_photometric_444_stream_{h}x{w}"] = t(
            img, 2, compression=7, chunks=[_jpeg(img, 0)])
        for sub, ss in ((2, (2, 2)), (1, (2, 1))):
            cases[f"jpeg_ycc_{ss[0]}{ss[1]}_{h}x{w}"] = t(
                img, 6, compression=7, chunks=[_jpeg(img, sub)],
                tags=((530, 3, list(ss)),))
            cases[f"jpeg_ycc_{ss[0]}{ss[1]}_tiles_{h}x{w}"] = t(
                img, 6, compression=7, tile=(16, 32),
                chunks=_tiles(img, (16, 32), lambda b: _jpeg(b, sub)),
                tags=((530, 3, list(ss)),), orientation=6)
    img = _smooth((37, 53, 3))
    cases["jpeg_ycc_strips_16"] = t(
        img, 6, compression=7, rows_per_strip=16, tags=((530, 3, [2, 2]),),
        chunks=[_jpeg(img[y:y + 16], 2) for y in range(0, 37, 16)])
    cases["jpeg_ycc_without_subsampling_tag"] = t(
        img, 6, compression=7, chunks=[_jpeg(img, 0)])
    cases["jpeg_rgb_photometric_420_stream"] = t(
        img, 2, compression=7, chunks=[_jpeg(img, 2)])
    cases["jpeg_ycc_subsampling_tag_differs"] = t(
        img, 6, compression=7, chunks=[_jpeg(img, 2)],
        tags=((530, 3, [2, 1]),))
    cases["jpeg_stream_shorter_than_strip"] = t(
        img, 6, compression=7, chunks=[_jpeg(img[:29], 0)],
        tags=((530, 3, [1, 1]),))
    stream = _jpeg(img, 2)
    cases["jpeg_stream_cut"] = t(img, 6, compression=7,
                                 chunks=[stream[:len(stream) * 2 // 3]],
                                 tags=((530, 3, [2, 2]),))
    cases["jpeg_16bit"] = t(img.astype(np.uint16), 2, bps=16, compression=7,
                            chunks=[_jpeg(img, 0)])
    gray = np.ascontiguousarray(img[..., 0])
    gray_stream = cv2.imencode(".jpg", gray)[1].tobytes()
    for ph in (0, 1):
        cases[f"jpeg_gray_photometric_{ph}"] = t(gray, ph, compression=7,
                                                 chunks=[gray_stream])
    # CCITT: each compression, fill order, photometric, several strips.
    bits = RNG.random((29, 61)) > 0.6
    bits[5:12, 3:40] = True
    for comp in ("tiff_ccitt", "group3", "group4"):
        for options in ({}, {292: 1}, {266: 2}, {262: 1, 278: 8}):
            key = "_".join(f"{k}-{v}" for k, v in options.items())
            cases[f"ccitt_{comp}_{key}"] = _pil(bits, "1", compression=comp,
                                                tiffinfo=options)
    cases["ccitt_group4_tiles"] = t(
        bits, 0, bps=1, compression=4, tile=(16, 16), orientation=2,
        chunks=_tiles(bits, (16, 16), _fax_strip))
    for t4 in (0, 1):  # no EOL found: decoded again as if it had none
        cases[f"ccitt_group3_all_ones_t4_{t4}"] = t(
            np.zeros((6, 20)), 0, bps=1, compression=3,
            chunks=[b"\xff" * 6], tags=((292, 4, [t4]),))
    cases["ccitt_8bit"] = t(bits.astype(np.uint8), 1, compression=4,
                            chunks=[b"\x00" * 8])
    # CMYK.
    cmyk = RNG.integers(0, 256, (9, 13, 4), np.uint8)
    for comp in (1, 5, 32773):
        for planar in (1, 2):
            cases[f"cmyk_c{comp}_planar{planar}"] = t(
                cmyk, 5, compression=comp, planar=planar, rows_per_strip=4)
    cases["cmyk_lzw_tiles"] = t(cmyk, 5, compression=5, tile=(16, 16))
    cases["cmyk_extra_sample_tag"] = t(cmyk, 5, extra=[2])
    cases["cmyk_inkset_2"] = t(cmyk, 5, tags=((332, 3, [2]),))
    cases["cmyk_16bit"] = t(cmyk.astype(np.uint16) * 257, 5, bps=16)
    cases["cmyk_3_samples"] = t(cmyk[..., :3], 5)
    cases["cmyk_5_samples"] = t(np.concatenate([cmyk, cmyk[..., :1]], -1),
                                5)
    # YCbCr: every subsampling the RGBA reader takes, and two it does not.
    for h, w in ((9, 13), (5, 8), (4, 4)):
        ycc = RNG.integers(0, 256, (h, w, 3), np.uint8)
        for hs, vs in ((2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2),
                       (2, 4)):
            cases[f"ycbcr_{hs}{vs}_lzw_{h}x{w}"] = t(
                ycc, 6, compression=5, rows_per_strip=4,
                chunks=[tiff.lzw_encode_plain(samples.ycbcr_units(
                    ycc[y:y + 4], hs, vs).tobytes())
                    for y in range(0, h, 4)], tags=((530, 3, [hs, vs]),))
            cases[f"ycbcr_{hs}{vs}_tiles_{h}x{w}"] = t(
                ycc, 6, compression=8, tile=(16, 16),
                chunks=_tiles(ycc, (16, 16), lambda b: zlib.compress(
                    samples.ycbcr_units(b, hs, vs).tobytes())),
                tags=((530, 3, [hs, vs]),))
    ycc = RNG.integers(0, 256, (9, 13, 3), np.uint8)
    for i, rbw in enumerate(([0, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1],
                             [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1],
                             [15, 2, 470, 2, 100, 1, 300, 1, 60, 1, 200,
                              1])):
        cases[f"ycbcr_reference_black_white_{i}"] = t(
            ycc, 6, tags=((530, 3, [1, 1]), (532, 5, rbw)))
    for i, coef in enumerate(([2126, 10000, 7152, 10000, 722, 10000],
                              [1, 3, 1, 3, 1, 3])):
        cases[f"ycbcr_coefficients_{i}"] = t(
            ycc, 6, tags=((530, 3, [1, 1]), (529, 5, coef)))
    cases["ycbcr_planar_11"] = t(ycc, 6, planar=2, tags=((530, 3, [1, 1]),))
    cases["ycbcr_planar_22"] = t(ycc, 6, planar=2, tags=((530, 3, [2, 2]),))
    cases["ycbcr_predictor_11"] = t(ycc, 6, compression=5, predictor=2,
                                    tags=((530, 3, [1, 1]),))
    cases["ycbcr_pil"] = _pil(ycc, "YCbCr")
    # CIELab.
    lab = RNG.integers(0, 256, (9, 13, 3), np.uint8)
    cases["cielab_lzw"] = t(lab, 8, compression=5)
    cases["cielab_tiles"] = t(lab, 8, compression=5, tile=(16, 16))
    cases["cielab16_big_endian"] = t(
        RNG.integers(0, 65536, (9, 13, 3)).astype(np.uint16), 8, bps=16,
        big_endian=True)
    for i, wp in enumerate(([3127, 10000, 3290, 10000], [1, 3, 1, 3])):
        cases[f"cielab_white_point_{i}"] = t(lab, 8, tags=((318, 5, wp),))
    cases["cielab_planar"] = t(lab, 8, planar=2)
    cases["cielab_alpha"] = t(np.concatenate([lab, lab[..., :1]], -1), 8,
                              extra=[2])
    cases["cielab_pil"] = _pil(lab, "LAB")
    # Signed samples, read as unsigned.
    for bps in (8, 16):
        v = RNG.integers(0, 1 << bps, (7, 9, 3)).astype(
            np.uint16 if bps == 16 else np.uint8)
        for ph, img in ((1, v[..., 0]), (2, v)):
            cases[f"signed_{bps}bit_photometric_{ph}"] = t(
                img, ph, bps=bps, compression=5,
                tags=((339, 3, [2] * (1 if ph == 1 else 3)),))
    # FillOrder 2: bytes reversed bit by bit before the codec.
    cases["fill_order_2_none"] = t(lab, 2, tags=((266, 3, [2]),))
    cases["fill_order_2_packbits_1bit"] = t(
        RNG.integers(0, 2, (11, 17)), 1, bps=1, compression=32773,
        tags=((266, 3, [2]),))
    return cases


def _fax_strip(block) -> bytes:
    """The one strip Pillow's libtiff writes for a bilevel block, as
    group 4."""
    data = _pil(block.astype(bool), "1", compression="group4")
    e, tags = tiff._tags(data, "x")
    return data[tags[273][0]:tags[273][0] + tags[279][0]]


VARIANTS = _variants()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variants_read_as_cv2(name, tmp_path):
    """Every variant through the C library and the plain versions alike
    (a JPEG strip cut short is filled as libtiff's source manager fills
    it, by both)."""
    _readers_match_cv2(VARIANTS[name], tmp_path, plain=True)


def test_refusals_name_the_variant():
    """Where cv2 returns no image the reader says what it does not read."""
    for name, what in (("cmyk_inkset_2", "CMYK with 4 samples"),
                       ("cmyk_16bit", "CMYK with 4 samples of 16"),
                       ("ycbcr_24_lzw_9x13", "subsampling 2x4"),
                       ("cielab_alpha", "CIELab with 4 samples"),
                       ("ccitt_8bit", "CCITT compression of 1 samples of 8"),
                       ("jpeg_rgb_photometric_420_stream",
                        "JPEG sampling factors"),
                       ("jpeg_16bit", "16-bit samples")):
        assert _cv2(VARIANTS[name]) is None, name
        with pytest.raises(ValueError, match=what):
            image_io.decode_image(VARIANTS[name])


def _set_byte_count(data: bytes, k: int, count: int) -> bytes:
    """`data` with StripByteCounts[k] set to `count` (Pillow's little-endian
    files)."""
    (ifd,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[ifd:ifd + 2])
    out = bytearray(data)
    for i in range(n):
        at = ifd + 2 + 12 * i
        tag, _, num, value = struct.unpack("<HHII", data[at:at + 12])
        if tag == 279:
            where = at + 8 if num == 1 else value + 4 * k
            out[where:where + 4] = struct.pack("<I", count)
    return bytes(out)


def test_cut_and_corrupt_fax_strips_decode_where_cv2_does(tmp_path):
    """Seeded cuts (a strip's byte count lowered, to 0 too: libtiff then
    estimates a single strip's from the file) and flipped bits in Pillow's
    RLE, group 3 (1-D, 2-D) and group 4 files of several strips: every
    reader gives cv2's pixels (the rows a failing strip decoded and 0
    after them; a group 3 strip whose EOL search runs out of data decoded
    again without EOLs, and every later strip so too), or refuses where
    cv2 returns no image."""
    rng = np.random.default_rng(5)
    outcomes = {"image": 0, "none": 0}
    for trial in range(24):
        h, w = int(rng.integers(2, 30)), int(rng.integers(2, 50))
        bits = rng.random((h, w)) > rng.random()
        comp = ("tiff_ccitt", "group3", "group4")[trial % 3]
        info = {278: int(rng.integers(1, 12)), 292: trial % 2,
                266: 1 + trial % 4 // 2}
        data = _pil(bits, "1", compression=comp, tiffinfo=info)
        e, tags = tiff._tags(data, "x")
        k = int(rng.integers(len(tags[273])))
        for cut in (0, 1, tags[279][k] // 2):
            want = _readers_match_cv2(_set_byte_count(data, k, cut),
                                      tmp_path)
            outcomes["none" if want is None else "image"] += 1
        for _ in range(3):
            flipped = bytearray(data)
            flipped[tags[273][k] + int(rng.integers(tags[279][k]))] ^= \
                1 << int(rng.integers(8))
            want = _readers_match_cv2(bytes(flipped), tmp_path)
            outcomes["none" if want is None else "image"] += 1
    assert min(outcomes.values()) > 5, outcomes


def test_fax_coders_c_equal_plain_on_random_streams():
    """The C fax decoder and its plain version on random bytes, each
    compression and fill order, one codec state across strips: the same
    rows and the same outcome."""
    rng = np.random.default_rng(7)
    for trial in range(60):
        width, rows = int(rng.integers(1, 90)), int(rng.integers(1, 12))
        comp = (2, 3, 4)[trial % 3]
        t4, fill = trial % 2, 1 + trial % 4 // 2
        states = ({}, {})
        for _ in range(3):
            data = rng.integers(0, 256, int(rng.integers(0, 40)),
                                dtype=np.uint8).tobytes()
            plain = ccitt.decode(data, width, rows, comp, t4, fill,
                                 states[0])
            c = image_codec.fax_decode(data, width, rows, comp, t4, fill,
                                       states[1])
            assert plain[1] == c[1], trial
            np.testing.assert_array_equal(plain[0], c[0], err_msg=trial)


def test_timing_files_read_as_cv2_reads_them():
    """The 480x640 TIFFs the smoke script times (`timing_tiffs`: the JPEG
    photo as a YCbCr 4:2:0 strip, CMYK, 2x2 YCbCr) read by cv2 to the
    digests committed for the card's machine, and by the port (C) to the
    same pixels; the JPEG strip as the JPEG file itself reads."""
    name = "photo_480x640_q95_420.jpg"
    photo = (FIXTURES / name).read_bytes()
    rgb = image_io.decode_image(photo)
    want = DIGESTS[name]["timing_sha256"]
    for kind, data in samples.timing_tiffs(photo, rgb).items():
        theirs = _cv2(data)
        sha = hashlib.sha256(np.ascontiguousarray(theirs).tobytes())
        assert sha.hexdigest() == want[kind], kind
        np.testing.assert_array_equal(image_io.decode_image(data), theirs)
    np.testing.assert_array_equal(
        _cv2(samples.timing_tiffs(photo, rgb)["jpeg_ycc420"]), rgb)


NOT_A_FAULT = {
    "tiff_lzma": (samples.tiff_bytes(np.zeros((4, 4, 3), np.uint8), 2,
                                     compression=34925,
                                     chunks=[b"\xfd7zXZ\x00" + bytes(32)]),
                  "LZMA compression"),
    "tiff_zstd": (samples.tiff_bytes(np.zeros((4, 4, 3), np.uint8), 2,
                                     compression=50000,
                                     chunks=[b"\x28\xb5\x2f\xfd" + bytes(32)]),
                  "ZSTD compression"),
    "tiff_webp": (samples.tiff_bytes(np.zeros((4, 4, 3), np.uint8), 2,
                                     compression=50001,
                                     chunks=[b"RIFF" + bytes(32)]),
                  "WebP compression"),
    "tiff_old_jpeg": (samples.tiff_bytes(
        np.zeros((8, 8, 3), np.uint8), 6, compression=6,
        chunks=[b"\xff\xd8\xff\xd9"], tags=((513, 4, [8]), (514, 4, [4]))),
        "old JPEG compression"),
    "tiff_float32": (samples.tiff_bytes(
        np.zeros((4, 4), np.uint8), 1, tags=((258, 3, [32]),
                                             (339, 3, [3]))), "format"),
    "tiff_int32": (samples.tiff_bytes(
        np.zeros((4, 4), np.uint8), 1, tags=((258, 3, [32]),
                                             (339, 3, [2]))), "format"),
    "tiff_icclab": (samples.tiff_bytes(np.zeros((4, 4, 3), np.uint8), 9),
                    "ICCLab"),
    "tiff_itulab": (samples.tiff_bytes(np.zeros((4, 4, 3), np.uint8), 10),
                    "ITULab"),
    "openexr": (b"\x76\x2f\x31\x01" + bytes(64), "OpenEXR"),
}


@pytest.mark.parametrize("name", sorted(NOT_A_FAULT))
def test_not_a_fault_cv2_reads_none_and_the_port_names_it(name):
    """ROADMAP.md's "Pinned, not a fault": cv2 5.0 returns no image for
    these (its libtiff is built without LZMA, ZSTD and WebP and reads no
    old-style JPEG, 32-bit or float samples, ICCLab or ITULab; cv2 is built
    without OpenEXR and has no writer for .exr), and the port refuses each
    by name."""
    data, what = NOT_A_FAULT[name]
    assert _cv2(data) is None
    if name == "openexr":
        with pytest.raises(cv2.error):
            cv2.imencode(".exr", np.zeros((2, 2, 3), np.float32))
        assert re.search(r"OpenEXR:\s+NO", cv2.getBuildInformation())
    with pytest.raises(ValueError, match=what):
        image_io.decode_image(data)
    with pytest.raises(ValueError, match=what):
        image_io.decode_image_plain(data)
