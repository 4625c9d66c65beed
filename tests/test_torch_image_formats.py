"""The simple image formats against cv2 5.0: every variant of BMP/DIB,
PBM/PGM/PPM/PAM/PFM, Sun raster, TIFF and GIF that the port reads, read
by `decode_image` (the C coders), `decode_image_plain` (their Python
versions) and `read_image` (a file), equal to `cv2.imdecode(buf,
IMREAD_COLOR)` reversed to RGB (a one-channel cv2 result repeated), and
refused with a ValueError wherever cv2 returns no image; the writers'
bytes, C and plain, equal to `cv2.imencode`'s; `predict --output` for
those suffixes against the JAX CLI's bytes, and `.pgm` as it behaves.

Inputs are made here from numpy seeds: with Pillow (BMP, TIFF, GIF),
with cv2 (its own writers), and byte by byte
(`multiposenet_tpu_torch/tools/image_samples.py`) for the RLE, 16-bit,
OS/2, tiled, planar and predictor variants.
"""

import contextlib
import dataclasses
import io
import json
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from multiposenet_tpu import cli as jax_cli
from multiposenet_tpu.infer import export as jax_export
from multiposenet_tpu_torch import cli
from multiposenet_tpu_torch.tools import image_samples as samples
from multiposenet_tpu_torch.utils import gif, image_codec, image_io, tiff
from torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (autouse)
    posenet_variables,
    prn_variables,
    tiny_config,
)

RNG = np.random.default_rng(0)
RGB = RNG.integers(0, 256, (37, 45, 3), dtype=np.uint8)
RGB[10:20] = 7  # runs for the coders
PAL = RNG.integers(0, 256, (256, 4), dtype=np.uint8)


def _cv2(data: bytes):
    try:
        r = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None
    if r is None:
        return None
    if r.ndim == 2:
        r = np.repeat(r[:, :, None], 3, axis=2)
    return r[:, :, ::-1]


def _readers_match_cv2(data: bytes, tmp_path, suffix: str = ".img"):
    """decode_image, decode_image_plain and read_image against cv2: equal
    pixels, or all raise a ValueError where cv2 returns no image."""
    want = _cv2(data)
    path = tmp_path / f"x{suffix}"
    path.write_bytes(data)
    readers = (image_io.decode_image, image_io.decode_image_plain,
               lambda d: image_io.read_image(path))
    for read in readers:
        if want is None:
            with pytest.raises(ValueError):
                read(data)
            continue
        got = read(data)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    return want


# --- BMP ---------------------------------------------------------------------


def _pil(mode: str, fmt: str, shape=(7, 9), **kw) -> bytes:
    arr = RNG.integers(0, 256, (*shape, 3), dtype=np.uint8)
    arr[:2] = 11
    im = Image.fromarray(arr)
    im = im.quantize(16) if mode == "P" else im.convert(mode)
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def _rows(arr: np.ndarray, pitch: int) -> bytes:
    return samples.padded_rows([r.tobytes() for r in arr], pitch)


def _bmp_cases():
    w, h = 5, 3
    t16 = RNG.integers(0, 65536, (h, w)).astype("<u2")
    p16 = _rows(t16, 12)
    p32 = RNG.integers(0, 256, (h, w, 4), dtype=np.uint8)
    idx = RNG.integers(0, 256, (h, w), dtype=np.uint8)
    i4 = RNG.integers(0, 16, (h, w), dtype=np.uint8)
    packed4 = [bytes((r[i] << 4) | (r[i + 1] if i + 1 < w else 0)
                     for i in range(0, w, 2)) for r in i4]
    bmp = samples.bmp_bytes

    def rle8(ww, hh, stream, used=0):
        return bmp(ww, hh, 8, 1, bytes(stream), PAL[:used or 256],
                   used=used)

    def rle4(ww, hh, stream):
        return bmp(ww, hh, 4, 2, bytes(stream), PAL[:16])

    cases = {f"pillow_{m}": _pil(m, "BMP", (13, 33))
             for m in ("1", "L", "P", "RGB", "RGBA")}
    cases.update({
        "16_rgb_555": bmp(w, h, 16, 0, p16),
        "16_bitfields_555": bmp(w, h, 16, 3, p16,
                                masks=(0x7C00, 0x3E0, 0x1F)),
        "16_bitfields_565": bmp(w, h, 16, 3, p16,
                                masks=(0xF800, 0x7E0, 0x1F)),
        "16_other_masks": bmp(w, h, 16, 3, p16, masks=(0xF000, 0xF00, 0xF0)),
        "32_rgb": bmp(w, h, 32, 0, p32.tobytes()),
        "32_bitfields": bmp(w, h, 32, 3, p32.tobytes(),
                            masks=(0xFF, 0xFF00, 0xFF0000)),
        "32_v5_header": bmp(w, h, 32, 3, p32.tobytes(), header=124),
        "24_top_down": bmp(w, -h, 24, 0, _rows(p32[..., :3], 16)),
        "24_v4_header": bmp(w, h, 24, 0, _rows(p32[..., :3], 16), header=108),
        "8_palette": bmp(w, h, 8, 0, _rows(idx, 8), PAL),
        "8_palette_of_10": bmp(w, h, 8, 0, _rows(idx, 8), PAL[:10], used=10),
        "4_palette": bmp(w, h, 4, 0, samples.padded_rows(packed4, 4),
                         PAL[:16]),
        "os2_24": bmp(w, h, 24, 0, _rows(p32[..., :3], 16), header=12),
        "os2_8": bmp(w, h, 8, 0, _rows(idx, 8), PAL[:, :3], header=12),
        "os2_4": bmp(w, h, 4, 0, samples.padded_rows(packed4, 4),
                     PAL[:16, :3], header=12),
        "rle8": rle8(4, 2, [2, 5, 2, 7, 0, 0, 0, 3, 1, 2, 3, 0, 0, 1]),
        "rle8_eol_after_full_row": rle8(4, 2, [4, 5, 0, 0, 4, 7, 0, 1]),
        "rle8_delta": rle8(6, 3, [2, 5, 0, 2, 2, 1, 1, 9, 0, 1]),
        "rle8_early_end_of_bitmap": rle8(6, 3, [2, 5, 0, 1]),
        "rle8_no_end_of_bitmap": rle8(2, 2, [2, 5, 0, 0, 2, 6, 0, 0]),
        "rle8_run_past_row": rle8(4, 2, [5, 5, 0, 1]),
        "rle8_absolute_past_row": rle8(4, 2, [0, 5, 1, 2, 3, 4, 5, 0, 0, 1]),
        "rle8_cut": rle8(4, 2, [2, 5]),
        "rle8_top_down": bmp(4, -2, 8, 1, bytes([2, 5, 2, 7, 0, 0, 0, 3, 1,
                                                 2, 3, 0, 0, 1]), PAL),
        "rle8_index_past_palette": rle8(4, 2, [4, 9, 0, 0, 4, 1, 0, 1],
                                        used=4),
        "rle4": rle4(5, 2, [5, 0x12, 0, 0, 0, 3, 0x34, 0x50, 0, 0, 0, 1]),
        "rle4_absolute": rle4(4, 1, [0, 4, 0x12, 0x34, 0, 1]),
        "rle4_run_past_row": rle4(4, 1, [5, 0x12, 0, 1]),
        "rle4_end_of_bitmap_last_row": rle4(6, 2, [6, 0x12, 0, 0, 2, 0x34,
                                                   0, 1]),
        "rle4_end_of_bitmap_ends_row": rle4(6, 2, [2, 0x34, 0, 1]),
        "rle4_delta_in_row": rle4(6, 1, [0, 2, 1, 0, 5, 0x12, 0, 0]),
        "rle4_delta_rows_not_taken": rle4(6, 2, [2, 0x12, 0, 2, 0, 1, 0, 0,
                                                 0, 0]),
        "rle4_delta_then_short": rle4(6, 2, [2, 0x12, 0, 2, 0, 1, 0, 0]),
    })
    return cases


BMP_CASES = _bmp_cases()


@pytest.mark.parametrize("name", sorted(BMP_CASES))
def test_bmp_variants_read_as_cv2(name, tmp_path):
    _readers_match_cv2(BMP_CASES[name], tmp_path, ".bmp")


def test_bmp_rle_c_equals_plain_on_random_streams():
    """The C and plain RLE runs agree on random streams: the same pixels
    or the same refusal."""
    from multiposenet_tpu_torch.utils import bmp
    rng = np.random.default_rng(5)
    for trial in range(300):
        bits = (4, 8)[trial % 2]
        stream = rng.choice([0, 0, 1, 2, 3, 5, 9, 0x12], 40).astype(np.uint8)
        data = samples.bmp_bytes(7, 3, bits, 2 if bits == 4 else 1,
                                 stream.tobytes(), PAL[:16 if bits == 4
                                                       else 256])
        out = []
        for plain in (False, True):
            try:
                out.append(bmp.decode(data, plain=plain))
            except ValueError:
                out.append(None)
        assert (out[0] is None) == (out[1] is None), trial
        if out[0] is not None:
            np.testing.assert_array_equal(out[0], out[1])


# --- PBM / PGM / PPM / PAM / PFM ---------------------------------------------


def _pam(w, h, d, maxval, tupltype, data, extra=b""):
    head = f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {d}\nMAXVAL {maxval}\n"
    if tupltype:
        head += f"TUPLTYPE {tupltype}\n"
    return head.encode() + extra + b"ENDHDR\n" + bytes(data)


def _pxm_cases():
    cases = {}
    for mv in (1, 7, 100, 255):
        vals = np.arange(mv + 1)
        cases[f"P2_maxval_{mv}"] = (f"P2\n{mv + 1} 1\n{mv}\n".encode()
                                    + " ".join(map(str, vals)).encode()
                                    + b"\n")
        cases[f"P5_maxval_{mv}"] = (f"P5\n{mv + 1} 1\n{mv}\n".encode()
                                    + bytes(vals.astype(np.uint8)))
    v16 = RNG.integers(0, 65536, 12).astype(">u2")
    for mv in (256, 1000, 65535):
        text = " ".join(map(str, v16.astype(int))).encode() + b"\n"
        cases[f"P5_16bit_{mv}"] = f"P5\n12 1\n{mv}\n".encode() + v16.tobytes()
        cases[f"P6_16bit_{mv}"] = f"P6\n4 1\n{mv}\n".encode() + v16.tobytes()
        cases[f"P2_16bit_{mv}"] = f"P2\n12 1\n{mv}\n".encode() + text
        cases[f"P3_16bit_{mv}"] = f"P3\n4 1\n{mv}\n".encode() + text
    img = RNG.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    px = RNG.integers(0, 256, (3, 4, 3), dtype=np.uint8)
    cases.update({
        "P6": b"P6\n7 5\n255\n" + img.tobytes(),
        "P3": b"P3\n7 5\n255\n" + " ".join(map(str, img.reshape(-1)))
        .encode() + b"\n",
        "P1": b"P1\n5 2\n1 0 1 0 1\n0 0 1 1 0\n",
        "P1_digits_unspaced": b"P1\n5 2\n10101\n00110",
        "P1_value_2": b"P1\n3 1\n1 2 0\n",
        "P4": b"P4\n10 2\n" + bytes([0b10101010, 0b11000000, 0b01010101,
                                     0b00111111]),
        "P3_comments": b"P3\n# hi\n2 1 # c\n255\n1 2 3 4 5 6\n",
        "P2_last_number_ends_file": b"P2\n2 1\n255\n1 2",
        "P5_cut": b"P5\n3 1\n255\n\x01",
        "P5_longer": b"P5\n1 1\n255\n\x01\x02",
        "P3_junk": b"P3\n1 1\n255\n1 x 3\n",
        "P5_comment_after_number": b"P5\n1#x\n 1\n255\n\x05",
        "P5_maxval_0": b"P5\n1 1\n0\n\x00",
        "P5_maxval_65536": b"P5\n1 1\n65536\n\x00\x00",
        "P2_negative": b"P2\n2 1\n255\n-1 3\n",
        "pam_rgb": _pam(4, 3, 3, 255, "RGB", px.tobytes()),
        "pam_no_tupltype_depth_3": _pam(4, 3, 3, 255, None, px.tobytes()),
        "pam_grayscale": _pam(4, 3, 1, 255, "GRAYSCALE",
                              px[..., 0].tobytes()),
        "pam_blackandwhite_maxval_255": _pam(3, 1, 1, 255, "BLACKANDWHITE",
                                             [0, 1, 200]),
        "pam_blackandwhite_alpha": _pam(3, 1, 2, 1, "BLACKANDWHITE_ALPHA",
                                        [0, 1, 1, 0, 1, 1]),
        "pam_grayscale_maxval_100": _pam(2, 1, 1, 100, "GRAYSCALE",
                                         [50, 100]),
        "pam_rgb_16bit": _pam(2, 1, 3, 65535, "RGB",
                              RNG.integers(0, 256, 12)),
        "pam_grayscale_16bit": _pam(2, 1, 1, 300, "GRAYSCALE",
                                    [0, 0, 1, 0x2C]),
        "pam_comment": _pam(1, 1, 3, 255, "RGB", [1, 2, 3], b"# c\n"),
        "pam_depth_4_no_tupltype": _pam(1, 1, 4, 255, None, [1, 2, 3, 4]),
        "pam_unknown_tupltype": _pam(1, 1, 3, 255, "FOO", [1, 2, 3]),
        "pam_grayscale_depth_3": _pam(1, 1, 3, 255, "GRAYSCALE", [1, 2, 3]),
        "pam_cut": _pam(2, 1, 3, 255, "RGB", [1, 2, 3]),
    })
    vals = np.array([-1, 0, 0.4, 0.5, 0.6, 1.5, 2.5, 254.5, 255.5, 300,
                     1e10, np.nan, np.inf, -np.inf, 0.001, 1.0], np.float32)
    cases["Pf_little_endian"] = b"Pf\n16 1\n-1\n" + vals.astype("<f4") \
        .tobytes()
    cases["Pf_big_endian"] = b"Pf\n16 1\n1\n" + vals.astype(">f4").tobytes()
    cases["Pf_scale_2.5"] = b"Pf\n16 1\n-2.5\n" + vals.astype("<f4") \
        .tobytes()
    f = (RNG.random((3, 4, 3)) * 300).astype(np.float32)
    for scale in ("-1", "1", "-3.7", "0.01"):
        order = "<f4" if scale.startswith("-") else ">f4"
        cases[f"PF_scale_{scale}"] = (f"PF\n4 3\n{scale}\n".encode()
                                      + f.astype(order).tobytes())
    cases.update({
        "PF_spaces_only": b"PF 2 1 -1\n" + f.tobytes()[:24],
        "PF_scale_0": b"PF\n2 1\n0\n" + f.tobytes()[:24],
        "PF_cut": b"PF\n2 1\n-1\n" + f.tobytes()[:23],
        "PF_crlf": b"PF\r\n2 1\r\n-1\r\n" + f.tobytes()[:24],
    })
    return cases


PXM_CASES = _pxm_cases()


@pytest.mark.parametrize("name", sorted(PXM_CASES))
def test_netpbm_variants_read_as_cv2(name, tmp_path):
    _readers_match_cv2(PXM_CASES[name], tmp_path, ".pnm")


@pytest.mark.parametrize("tupltype,depth,maxval", [
    ("BLACKANDWHITE", 1, 1), ("GRAYSCALE_ALPHA", 2, 255),
    ("RGB_ALPHA", 4, 255)])
def test_pam_variants_cv2_fills_from_outside_the_file_are_refused(
        tupltype, depth, maxval):
    """cv2 5.0 returns an image here, but its pixels past the first few
    of a row do not come from the file (they change from call to call):
    the port refuses them by name."""
    data = _pam(8, 2, depth, maxval, tupltype,
                RNG.integers(0, maxval + 1, 16 * depth))
    assert _cv2(data) is not None
    for read in (image_io.decode_image, image_io.decode_image_plain):
        with pytest.raises(ValueError, match="not the file's"):
            read(data)


# --- Sun raster --------------------------------------------------------------


def _sunras(w, h, depth, kind, maptype, cmap, data):
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind,
                       maptype, len(cmap)) + bytes(cmap) + bytes(data)


def _sunras_cases():
    cmap = bytes(range(10, 13)) + bytes(range(20, 23)) + bytes(range(30, 33))
    px = RNG.integers(0, 256, (2, 3, 3), dtype=np.uint8)
    p4 = RNG.integers(0, 256, (2, 3, 4), dtype=np.uint8)
    return {
        "8_gray": _sunras(3, 2, 8, 1, 0, b"", [1, 2, 3, 0, 4, 5, 6, 0]),
        "8_old_type": _sunras(3, 1, 8, 0, 0, b"", [1, 2, 3, 0]),
        "8_colormap": _sunras(3, 1, 8, 1, 1, cmap, [0, 1, 2, 0]),
        "8_index_past_colormap": _sunras(3, 1, 8, 1, 1, cmap, [0, 5, 2, 0]),
        "1_gray": _sunras(10, 2, 1, 1, 0, b"", [0b10100000, 0b11000000,
                                                 0b01010101, 0b01000000]),
        "1_colormap": _sunras(3, 1, 1, 1, 1, bytes([10, 200, 20, 100, 30,
                                                    50]), [0b10100000, 0]),
        "24": _sunras(3, 2, 24, 1, 0, b"", _rows(px, 10)),
        "32": _sunras(3, 2, 32, 1, 0, b"", p4.tobytes()),
        "rle_8": _sunras(4, 1, 8, 2, 0, b"", [0x80, 2, 9, 7]),
        "rle_24": _sunras(3, 2, 24, 2, 0, b"", _rows(px, 10)),
        "format_rgb_24": _sunras(3, 2, 24, 3, 0, b"", _rows(px, 10)),
        "colormap_on_24": _sunras(3, 1, 24, 1, 1, cmap, [1, 2, 3] * 3 + [0]),
        "raw_colormap": _sunras(3, 1, 8, 1, 2, cmap, [1, 2, 3, 0]),
        "cut": _sunras(3, 2, 24, 1, 0, b"", _rows(px, 10))[:-3],
        "cv2_written_odd_width": cv2.imencode(".sr", RGB)[1].tobytes(),
    }


SUNRAS_CASES = _sunras_cases()


@pytest.mark.parametrize("name", sorted(SUNRAS_CASES))
def test_sun_raster_variants_read_as_cv2(name, tmp_path):
    _readers_match_cv2(SUNRAS_CASES[name], tmp_path, ".ras")


def test_refused_sun_rasters_name_why():
    for name, what in (("rle_8", "RT_BYTE_ENCODED"),
                       ("format_rgb_24", "RT_FORMAT_RGB")):
        with pytest.raises(ValueError, match=what):
            image_io.decode_image(SUNRAS_CASES[name])


# --- TIFF --------------------------------------------------------------------


def _tiff_cases():
    t = samples.tiff_bytes
    g = RGB[..., 0]
    r16 = RNG.integers(0, 65536, (9, 11, 3)).astype(np.uint16)
    rgba = RNG.integers(0, 256, (9, 11, 4), dtype=np.uint8)
    cases = {}
    for comp in (1, 5, 32773, 8, 32946):
        for pred in (1, 2):
            key = f"c{comp}_p{pred}"
            cases[f"rgb_strips_{key}"] = t(RGB, 2, compression=comp,
                                           predictor=pred, rows_per_strip=5)
            cases[f"rgb_planar_{key}"] = t(RGB, 2, compression=comp,
                                           predictor=pred, planar=2,
                                           rows_per_strip=8)
            cases[f"rgb_tiles_{key}"] = t(RGB, 2, compression=comp,
                                          predictor=pred, tile=(16, 32))
    for comp in (1, 5, 8):
        for pred in (1, 2):
            key = f"c{comp}_p{pred}"
            cases[f"rgb16_{key}"] = t(r16, 2, bps=16, compression=comp,
                                      predictor=pred)
            cases[f"rgb16_big_endian_{key}"] = t(r16, 2, bps=16,
                                                 compression=comp,
                                                 predictor=pred,
                                                 big_endian=True)
            cases[f"gray16_{key}"] = t(r16[..., 0], 1, bps=16,
                                       compression=comp, predictor=pred)
    for ex in (None, 0, 1, 2):
        extra = None if ex is None else [ex]
        cases[f"rgba_extra_{ex}"] = t(rgba, 2, extra=extra, compression=5)
        cases[f"rgba16_extra_{ex}"] = t(np.repeat(r16, 2, -1)[..., :4], 2,
                                        bps=16, extra=extra)
        cases[f"rgba_planar_extra_{ex}"] = t(rgba, 2, extra=extra, planar=2,
                                             compression=32773)
    for o in range(1, 9):
        cases[f"orientation_{o}"] = t(RGB, 2, orientation=o, compression=5)
        cases[f"orientation16_{o}"] = t(r16, 2, bps=16, orientation=o)
        cases[f"orientation_one_tile_{o}"] = t(RGB[:12, :14], 2,
                                               orientation=o, tile=(16, 16),
                                               compression=8)
    for bps, ph in ((1, 0), (1, 1), (1, 3), (4, 3), (4, 1), (2, 3)):
        v = RNG.integers(0, 1 << bps, (17, 31))
        cm = RNG.integers(0, 65536, (3, 1 << bps)) if ph == 3 else None
        for layout, kw in (("strips", dict(rows_per_strip=4)),
                           ("tiles", dict(tile=(16, 16), compression=5))):
            cases[f"{bps}bit_photometric_{ph}_{layout}"] = t(
                v, ph, bps=bps, colormap=cm, **kw)
    for o in (2, 6):
        cases[f"1bit_tiles_orientation_{o}"] = t(
            RNG.integers(0, 2, (20, 37)), 0, bps=1, tile=(16, 16),
            compression=32773, orientation=o)
    for o in (1, 2, 3, 6, 7):
        cases[f"orientation_tiles_{o}"] = t(RGB, 2, orientation=o,
                                            tile=(16, 32), compression=5)
        cases[f"gray16_partial_tiles_orientation_{o}"] = t(
            r16[..., 0], 1, bps=16, tile=(16, 16), compression=8,
            orientation=o)
    cases["gray16_min_is_white_partial_tiles"] = t(
        np.tile(r16[..., 0], (3, 3)), 0, bps=16, tile=(16, 16),
        compression=5, predictor=2, big_endian=True)
    cases.update({
        "rgb_big_endian_lzw": t(RGB, 2, big_endian=True, compression=5,
                                predictor=2),
        "gray": t(g, 1),
        "gray_min_is_white": t(g, 0, compression=5),
        "gray16_min_is_white": t(r16[..., 0], 0, bps=16),
        "gray_alpha": t(rgba[..., :2], 1, extra=[2]),
        "palette_8bit_colormap": t(g, 3, colormap=RNG.integers(0, 256,
                                                               (3, 256))),
        "palette_16bit_colormap": t(g, 3, colormap=RNG.integers(
            0, 65536, (3, 256)), compression=5, predictor=2),
        "tiles_uncompressed": t(RGB, 2, tile=(16, 16)),
        "lzw_cut": t(RGB, 2, compression=5)[:200],
    })
    for mode in ("1", "L", "RGB", "RGBA", "P", "I;16"):
        for comp in (None, "tiff_lzw", "packbits", "tiff_adobe_deflate"):
            if mode == "I;16":
                im = Image.fromarray(RGB[..., 0].astype(np.uint16) * 250)
            elif mode == "P":
                im = Image.fromarray(RGB).quantize(40)
            else:
                im = Image.fromarray(RGB).convert(mode)
            b = io.BytesIO()
            im.save(b, "TIFF", compression=comp)
            cases[f"pillow_{mode}_{comp}"] = b.getvalue()
    b = io.BytesIO()
    Image.fromarray(RGB).save(b, "TIFF", compression="tiff_lzw",
                              tiffinfo={274: 6})
    cases["pillow_orientation_6"] = b.getvalue()
    for shape in ((17, 23, 3), (480, 640, 3)):
        img = RNG.integers(0, 256, shape, dtype=np.uint8)
        cases[f"cv2_written_{shape[0]}x{shape[1]}"] = cv2.imencode(
            ".tif", img)[1].tobytes()
    return cases


TIFF_CASES = _tiff_cases()


@pytest.mark.parametrize("name", sorted(TIFF_CASES))
def test_tiff_variants_read_as_cv2(name, tmp_path):
    _readers_match_cv2(TIFF_CASES[name], tmp_path, ".tif")


def test_tiff_refusals_name_what_is_not_read():
    """Old-style JPEG (6) and LZMA compression, 2-bit samples and
    uncompressed tiles (cv2 returns no image), each named."""
    old_jpeg = samples.tiff_bytes(
        RGB, 6, compression=6, chunks=[b"\xff\xd8\xff\xd9"],
        tags=((513, 4, [8]), (514, 4, [4])))
    assert _cv2(old_jpeg) is None
    with pytest.raises(ValueError, match="old JPEG compression"):
        image_io.decode_image(old_jpeg)
    lzma = samples.tiff_bytes(RGB, 2, compression=34925,
                              chunks=[b"\xfd7zXZ\x00" + b"\x00" * 64])
    assert _cv2(lzma) is None
    with pytest.raises(ValueError, match="LZMA compression"):
        image_io.decode_image(lzma)
    two_bit = samples.tiff_bytes(RNG.integers(0, 4, (5, 7)), 1, bps=2)
    assert _cv2(two_bit) is None
    with pytest.raises(ValueError, match=r"\[2\]-bit samples"):
        image_io.decode_image(two_bit)
    with pytest.raises(ValueError, match="uncompressed tiled"):
        image_io.decode_image(TIFF_CASES["tiles_uncompressed"])
    # cv2 returns an image here, its rows past the first of a partly
    # covered tile taken from elsewhere in the tile by a rule not
    # reproduced: refused by name.
    gray_alpha = samples.tiff_bytes(
        RNG.integers(0, 65536, (9, 11, 2)).astype(np.uint16), 1, bps=16,
        tile=(16, 16), compression=8, extra=[2])
    assert _cv2(gray_alpha) is not None
    with pytest.raises(ValueError, match="extra sample"):
        image_io.decode_image(gray_alpha)


def test_tiff_old_style_lzw_and_coders_c_equal_plain():
    """libtiff's old-style LZW (codes LSB first, the width one code
    later) decodes; the C and plain LZW and PackBits decoders agree on
    random bytes, and round-trip the writers' streams."""
    raw = RNG.integers(0, 4, 3000, dtype=np.uint8).tobytes()
    # An old-style stream: clear code, literals, growing at 512.
    codes, size, width = [256], 258, 9
    for i, c in enumerate(raw[:600]):
        codes.append(c)
        if i:
            size += 1
            if size > (1 << width) - 1 and width < 12:
                width += 1
    codes.append(257)
    acc = bits = 0
    stream = bytearray()
    width, size = 9, 258
    for i, c in enumerate(codes):
        acc |= c << bits
        bits += width
        while bits >= 8:
            stream.append(acc & 0xFF)
            acc >>= 8
            bits -= 8
        if 2 <= i < len(codes) - 1:
            size += 1
            if size > (1 << width) - 1 and width < 12:
                width += 1
    stream.append(acc & 0xFF)
    stream = bytes(stream)
    assert stream[0] == 0 and stream[1] & 1
    for decode in (image_codec.tiff_lzw, tiff.lzw_decode_plain):
        assert decode(stream, 600) == raw[:600]
    enc = tiff.lzw_encode_plain(raw)
    assert image_codec.tiff_lzw(enc, len(raw)) == raw
    assert image_codec.packbits(samples.packbits_encode(raw), len(raw)) == raw
    rng = np.random.default_rng(9)
    for _ in range(200):
        data = rng.integers(0, 256, int(rng.integers(1, 300)),
                            dtype=np.uint8).tobytes()
        want = int(rng.integers(1, 1500))
        assert image_codec.packbits(data, want) == tiff.packbits_plain(
            data, want)
        results = []
        for decode in (image_codec.tiff_lzw, tiff.lzw_decode_plain):
            try:
                results.append(decode(data, want))
            except ValueError:
                results.append(None)
        assert results[0] == results[1]


# --- GIF ---------------------------------------------------------------------


def _gif_cases():
    pal = RNG.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = RNG.integers(0, 16, (5, 6))
    idx[0, :3] = 3
    idx9 = RNG.integers(0, 16, (17, 6))
    g = samples.gif_bytes
    cases = {
        "plain": g((6, 5), [dict(idx=idx)], pal, bg=5),
        "transparent_bg_0": g((6, 5), [dict(idx=idx, transp=3)], pal, bg=0),
        "transparent_bg_5": g((6, 5), [dict(idx=idx, transp=3)], pal, bg=5),
        "offset_frame": g((10, 8), [dict(idx=idx, left=2, top=1)], pal, bg=5),
        "local_palette": g((6, 5), [dict(idx=idx, lpal=pal[::-1])], pal,
                           bg=5),
        "local_palette_only": g((8, 7), [dict(idx=idx, lpal=pal, left=1,
                                              top=2, transp=3)], None, bg=5),
        "interlaced": g((6, 17), [dict(idx=idx9, interlace=True)], pal),
        "gif87a": g((6, 5), [dict(idx=idx)], pal, version=b"87a"),
        "two_frames": g((6, 5), [dict(idx=idx, transp=3),
                                 dict(idx=15 - idx)], pal, bg=5),
        "index_past_palette": g((6, 5), [dict(idx=idx)], pal[:8], bg=2),
        "background_past_palette": g((6, 5), [dict(idx=idx)], pal[:4], bg=5),
        "frame_past_screen": g((4, 3), [dict(idx=idx)], pal, bg=5),
        "image_data_short": g((6, 5), [dict(
            idx=idx, lzw=samples.gif_lzw_literal(idx.reshape(-1)[:10], 4))],
            pal, bg=5),
    }
    many = RNG.integers(0, 16, (120, 150))
    many[:30] %= 3
    for full in (False, True):
        cases[f"compressed_table_full_clear_{full}"] = g(
            (150, 120), [dict(idx=many, lzw=samples.gif_lzw(
                many.reshape(-1), 4, clear_when_full=full))], pal)
    whole = cases["plain"]
    cases["cut"] = whole[:-3]
    cases["no_trailer"] = whole[:-1]
    for shape, n, interlace in (((40, 53), 256, False), ((33, 70), 7, True),
                                ((64, 64), 2, False)):
        arr = RNG.integers(0, 256, (*shape, 3), dtype=np.uint8)
        arr[5:15] = 9
        im = Image.fromarray(arr).quantize(n)
        for kw in ({}, {"transparency": 1}):
            b = io.BytesIO()
            im.save(b, "GIF", interlace=interlace, **kw)
            cases[f"pillow_{shape[0]}x{shape[1]}_{n}_{interlace}_{len(kw)}"] \
                = b.getvalue()
    frames = [Image.fromarray(RNG.integers(0, 256, (30, 40, 3),
                                           dtype=np.uint8)).quantize(64)
              for _ in range(3)]
    b = io.BytesIO()
    frames[0].save(b, "GIF", save_all=True, append_images=frames[1:],
                   duration=50, loop=0)
    cases["pillow_animated"] = b.getvalue()
    return cases


GIF_CASES = _gif_cases()


@pytest.mark.parametrize("name", sorted(GIF_CASES))
def test_gif_variants_read_as_cv2(name, tmp_path):
    _readers_match_cv2(GIF_CASES[name], tmp_path, ".gif")


def test_gif_lzw_c_equals_plain_on_random_bytes():
    rng = np.random.default_rng(3)
    for _ in range(300):
        data = rng.integers(0, 256, int(rng.integers(1, 300)),
                            dtype=np.uint8).tobytes()
        size, count = int(rng.integers(2, 9)), int(rng.integers(1, 2000))
        results = []
        for decode in (image_codec.gif_lzw, gif.lzw_decode_plain):
            try:
                results.append(decode(data, size, count))
            except ValueError:
                results.append(None)
        assert results[0] == results[1]


# --- writers -----------------------------------------------------------------

SUFFIXES = (".bmp", ".dib", ".ppm", ".pnm", ".pam", ".pfm", ".sr", ".ras",
            ".tif", ".tiff")


@pytest.mark.parametrize("shape", [(17, 23), (480, 640)])
@pytest.mark.parametrize("suffix", SUFFIXES)
def test_writers_are_cv2_imencode(suffix, shape):
    """C and plain bytes equal cv2.imencode's, but for the pad byte after
    an odd-length Sun raster's last row, which cv2 reads from past the
    image."""
    rgb = np.random.default_rng(len(suffix)).integers(
        0, 256, (*shape, 3), dtype=np.uint8)
    ok, want = cv2.imencode(suffix, np.ascontiguousarray(rgb[:, :, ::-1]))
    want = want.tobytes()
    c = image_io.encode_image(rgb, suffix)
    plain = image_io.encode_image_plain(rgb, suffix)
    np.testing.assert_array_equal(image_io.decode_image(c), _cv2(c))
    if suffix in (".sr", ".ras") and shape[1] % 2:
        assert c[-1] == plain[-1] == 0
        want, c, plain = want[:-1], c[:-1], plain[:-1]
    assert ok and c == want and plain == want


@pytest.mark.parametrize("shape", [(1000, 1500), (64, 2000), (200, 2)])
def test_tiff_writer_strip_layout_at_larger_sizes(shape):
    """RowsPerStrip, SHORT or LONG StripByteCounts and the out-of-line
    values as libtiff lays them out, beyond predict's 480x640."""
    rgb = np.random.default_rng(shape[0]).integers(
        0, 256, (*shape, 3), dtype=np.uint8)
    want = cv2.imencode(".tif", np.ascontiguousarray(rgb[:, :, ::-1]))[1]
    assert image_io.encode_image(rgb, ".tif") == want.tobytes()


def test_cv2_writes_no_pgm_or_pbm_of_three_channels(tmp_path):
    for suffix in (".pgm", ".pbm"):
        path = tmp_path / f"x{suffix}"
        assert not cv2.imwrite(str(path), RGB)
        assert not path.exists()
        assert image_io.write_image(path, RGB) is False
        assert not path.exists()


# --- predict --output against the JAX CLI ------------------------------------


@pytest.fixture(scope="module")
def model_and_image(tmp_path_factory):
    root = tmp_path_factory.mktemp("formats_cli")
    cfg = tiny_config("float32")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, image_size=128))
    jax_export.save_model(root / "model", cfg, posenet_variables(cfg),
                          prn_variables(cfg))
    image = root / "scene.bmp"
    image.write_bytes(image_io.encode_image(
        np.random.default_rng(4).integers(0, 256, (60, 84, 3),
                                          dtype=np.uint8), ".bmp"))
    return root / "model", image


def _predict(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        main(argv)
    return out.getvalue()


def test_predict_output_formats_match_jax_cli_bytes(model_and_image,
                                                    tmp_path, monkeypatch):
    """Both CLIs read the BMP scene and write `--output` in each format
    from the same pixels (each drawing replaced by the input image, as
    the JPEG test does): equal bytes; `.pgm` writes no file from either
    and both print their people."""
    from multiposenet_tpu.utils import visualize as jax_visualize
    from multiposenet_tpu_torch.utils import visualize

    for module in (jax_visualize, visualize):
        monkeypatch.setattr(module, "draw_predictions",
                            lambda rgb, people: rgb.copy())
    model, image = model_and_image
    for suffix in (".bmp", ".tif", ".ppm", ".pam", ".pfm", ".sr", ".pgm"):
        files, printed = {}, {}
        for name, main, extra in (("jax", jax_cli.main, []),
                                  ("port", cli.main, ["--device", "cpu"])):
            files[name] = tmp_path / f"{name}{suffix}"
            printed[name] = json.loads(_predict(
                main, ["predict", "--model-dir", str(model), "--image",
                       str(image), "--output", str(files[name])] + extra))
        assert len(printed["port"]) == len(printed["jax"]), suffix
        if suffix == ".pgm":
            assert not files["jax"].exists() and not files["port"].exists()
            continue
        assert files["port"].read_bytes() == files["jax"].read_bytes(), \
            suffix
