"""JPEG 2000 against cv2 5.0 (OpenJPEG 2.5.3): files made here from seeded
NumPy images by Pillow's writer and by cv2.imencode, and those files
edited box by box and marker by marker (`tools/j2k_samples.py`), read by
`decode_image` (the C tiers of `csrc/jpeg2000.c`) and by `read_image` (a
file), equal to `cv2.imdecode` / `cv2.imread` reversed to RGB with
tolerance 0, and refused with a ValueError wherever cv2 returns no image:
both wavelets with and without the component transform, the five
progression orders with tiles, resolutions, code-block and precinct
sizes, quality layers, PLT, comments, gray, RGB, RGBA and 16-bit, cv2's
own files, odd sizes, the JP2 boxes (colour spaces, channel definitions,
palettes), the markers (TLM, CAP, CPF, CRG, MCT, unknown ones, RGN, POC,
SOP and EPH, PPT and PPM, precisions), tile parts (split, interleaved,
Psot 0, TNsot 0, a missing EOC, OpenJPEG's TPsot == TNsot correction),
every code-block style bit, what cv2 refuses, and a seeded subset of
`tools/jpeg2000_cut_search.py`'s cuts and flipped bits. The plain Python
tiers (`decode_image_plain`) equal the C library on six small files; the
committed fixtures read to their digests. What no fixture can be made of
is refused by name.
"""

import functools
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from multiposenet_tpu_torch.tools import j2k_samples as js
from multiposenet_tpu_torch.tools import jpeg2000_cut_search as search
from multiposenet_tpu_torch.utils import image_io, jpeg2000
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
J2K_FIXTURES = sorted(n for n in DIGESTS if n.startswith("j2k_"))


def _cv2(data: bytes):
    try:
        r = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None
    return None if r is None else r[:, :, ::-1]


def _cv2_file(path: Path):
    try:
        r = cv2.imread(str(path), cv2.IMREAD_COLOR)
    except cv2.error:
        return None
    return None if r is None else r[:, :, ::-1]


def _readers_match_cv2(data: bytes, tmp_path, plain: bool = False):
    """decode_image and read_image (and, with `plain`, decode_image_plain)
    against cv2: equal pixels, or a ValueError where cv2 returns no image.
    Returns cv2's decode."""
    want = _cv2(data)
    path = tmp_path / "x.jp2"
    path.write_bytes(data)
    assert (_cv2_file(path) is None) == (want is None)
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


smooth = search.smooth


def _pil(pixels, mode=None, **options) -> bytes:
    return search.pillow_j2k(pixels, mode, **options)


RGB = functools.partial(smooth, 37, 53, 3)


# --- what the writers make ---------------------------------------------------


def _encoded_cases() -> dict:
    cases = {}
    for irr in (False, True):
        for mct in (0, 1):
            cases[f"wavelet_irr{int(irr)}_mct{mct}"] = \
                lambda irr=irr, mct=mct: _pil(RGB(1), irreversible=irr,
                                              mct=mct)
    for prog in jpeg2000.PROGRESSIONS:
        cases[f"progression_{prog}"] = lambda p=prog: _pil(RGB(2),
                                                           progression=p)
        cases[f"progression_{prog}_tiles16_irr"] = lambda p=prog: _pil(
            RGB(3), progression=p, tile_size=(16, 16), irreversible=True)
    cases["tile_offset_0_tiles16x24"] = lambda: _pil(
        RGB(4), tile_size=(16, 24), tile_offset=(0, 0))
    for n in range(1, 7):
        cases[f"resolutions_{n}"] = lambda n=n: _pil(
            smooth(65, 129, 3, n), num_resolutions=n, irreversible=n % 2 == 0)
    for cb in ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 64)):
        cases[f"codeblock_{cb[0]}x{cb[1]}"] = lambda cb=cb: _pil(
            smooth(65, 129, 3, 5), codeblock_size=cb)
    for pr, n in (((16, 16), 2), ((16, 16), 3), ((32, 32), 6),
                  ((64, 64), 3), ((128, 128), 6), ((32, 64), 4)):
        cases[f"precinct_{pr[0]}x{pr[1]}_res{n}"] = lambda pr=pr, n=n: _pil(
            smooth(65, 129, 3, 6), precinct_size=pr, num_resolutions=n,
            progression="RPCL")
    for mode, layers in (("rates", [40, 20, 10]), ("rates", [80]),
                         ("dB", [30, 40, 50]), ("dB", [25]),
                         ("rates", [100, 10])):
        for irr in (False, True):
            cases[f"layers_{mode}_{len(layers)}_irr{int(irr)}_" + "_".join(
                map(str, layers))] = lambda m=mode, q=layers, i=irr: _pil(
                RGB(7), quality_mode=m, quality_layers=q, irreversible=i,
                progression="LRCP" if i else "CPRL")
    cases["plt"] = lambda: _pil(RGB(8), plt=True)
    cases["comment"] = lambda: _pil(RGB(8), comment=b"made in a test")
    cases["gray"] = lambda: _pil(smooth(37, 53, 1, 9))
    cases["gray_alpha"] = lambda: _pil(smooth(37, 53, 2, 9))
    cases["rgba"] = lambda: _pil(smooth(37, 53, 4, 9))
    cases["i16"] = lambda: _pil(
        smooth(37, 53, 1, 9).astype(np.uint16) * 257 + 3, "I;16")
    cases["codestream_rgb"] = lambda: _pil(RGB(10), no_jp2=True)
    cases["codestream_rgba"] = lambda: _pil(smooth(37, 53, 4, 10),
                                            no_jp2=True)
    cases["codestream_gray_refused"] = lambda: _pil(smooth(37, 53, 1, 10),
                                                    no_jp2=True)
    for h, w in ((37, 53), (64, 48)):
        cases[f"cv2_{h}x{w}"] = lambda h=h, w=w: cv2.imencode(
            ".jp2", smooth(h, w, 3, 11))[1].tobytes()
    for h, w in ((1, 17), (17, 1), (1, 1), (2, 3), (37, 53), (65, 129)):
        cases[f"size_{h}x{w}"] = lambda h=h, w=w: _pil(
            smooth(h, w, 3, 12), irreversible=h * w % 2 == 1)
    # What cv2 returns no image for.
    cases["refused_signed"] = lambda: _pil(RGB(13), signed=True)
    cases["refused_image_offset"] = lambda: _pil(
        RGB(13), tile_size=(16, 16), offset=(5, 7), tile_offset=(5, 7))
    cases["refused_precinct_16_res6"] = lambda: _pil(
        RGB(13), precinct_size=(16, 16))
    for frac in (0.3, 0.6, 0.9, 0.99):
        cases[f"refused_cut_{int(frac * 100)}"] = lambda f=frac: (
            lambda d: d[:int(len(d) * f)])(_pil(RGB(14)))
    return cases


ENCODED = _encoded_cases()


@pytest.mark.parametrize("name", sorted(ENCODED))
def test_encoded_variants_read_as_cv2(name, tmp_path):
    want = _readers_match_cv2(ENCODED[name](), tmp_path)
    assert (want is None) == name.startswith(("refused", "codestream_gray"))


# --- the JP2 boxes -----------------------------------------------------------


def _colr(enumcs: int):
    return lambda h: [b for b in h if b[0] != b"colr"] + [js.colr_box(enumcs)]


def _cdef(*entries):
    box = [b"cdef", struct.pack(">H", len(entries)) + b"".join(
        struct.pack(">HHH", *e) for e in entries)]
    return lambda h: [b for b in h if b[0] != b"cdef"] + [box]


def _palette(table, sizes, cmap, enumcs: int = 16):
    return lambda h: _colr(enumcs)(h) + [js.pclr_box(table, sizes),
                                         js.cmap_box(cmap)]


TABLE = np.random.default_rng(0).integers(0, 256, (256, 3))
RGB3 = [(0, 1, 0), (0, 1, 1), (0, 1, 2)]
BOXES = {
    **{f"colr_enumcs_{cs}": ("rgb", _colr(cs))
       for cs in (16, 17, 18, 14, 0, 99)},
    "colr_enumcs_12_cmyk_refused": ("rgb", _colr(12)),
    "colr_enumcs_24_eycc_refused": ("rgb", _colr(24)),
    "colr_enumcs_17_gray": ("gray", _colr(17)),
    "colr_enumcs_16_gray_refused": ("gray", _colr(16)),
    "colr_enumcs_18_gray_refused": ("gray", _colr(18)),
    "colr_icc": ("rgb", lambda h: [b for b in h if b[0] != b"colr"]
                 + [[b"colr", b"\x02\x00\x00" + bytes(20)]]),
    "colr_method_3": ("rgb", lambda h: [b for b in h if b[0] != b"colr"]
                      + [[b"colr", b"\x03\x00\x00" + bytes(4)]]),
    "colr_none": ("rgb", lambda h: [b for b in h if b[0] != b"colr"]),
    "colr_cielab_of_10_bytes": ("rgb", lambda h: [
        b for b in h if b[0] != b"colr"] + [[b"colr", bytes([1, 0, 0, 0, 0,
                                                               0, 14, 1, 2,
                                                               3])]]),
    "colr_twice": ("rgb", lambda h: h + [js.colr_box(17)]),
    "colr_6_bytes_refused": ("rgb", lambda h: [
        b for b in h if b[0] != b"colr"] + [[b"colr", bytes([1, 0, 0, 0, 0,
                                                               0])]]),
    "cdef_reversed": ("rgb", _cdef((0, 0, 3), (1, 0, 2), (2, 0, 1))),
    "cdef_alpha_first": ("rgba", _cdef((3, 0, 1), (1, 0, 2), (2, 0, 3),
                                       (0, 1, 0))),
    "cdef_incomplete_refused": ("rgb", _cdef((0, 0, 1), (1, 0, 2))),
    "cdef_channel_past_refused": ("rgb", _cdef((0, 0, 1), (1, 0, 2),
                                               (2, 0, 3), (3, 0, 4))),
    "palette_rgb": ("gray", _palette(TABLE, [8, 8, 8], RGB3)),
    "palette_short": ("gray", _palette(TABLE[:40], [8, 8, 8], RGB3)),
    "palette_16_bit": ("gray", _palette(TABLE * 251, [16, 16, 16], RGB3)),
    "palette_direct_column": ("gray", _palette(
        TABLE, [8, 8, 8], [(0, 0, 0), (0, 1, 1), (0, 1, 2)])),
    "palette_odd_map_corrected": ("gray", _palette(TABLE, [8, 8, 8],
                                                   [(0, 0, 0)] * 3)),
    "palette_sycc": ("gray", _palette(TABLE, [8, 8, 8], RGB3, 18)),
    "palette_map_wrong_refused": ("gray", _palette(
        TABLE, [8, 8, 8], [(0, 1, 1), (0, 1, 0), (0, 1, 2)])),
    "palette_without_cmap_refused": ("gray", lambda h: _colr(16)(h) + [
        js.pclr_box(TABLE, [8, 8, 8])]),
    "cmap_before_pclr_refused": ("gray", lambda h: h + [
        js.cmap_box(RGB3), js.pclr_box(TABLE, [8, 8, 8])]),
    "ihdr_size_differs_refused": ("rgb", lambda h: [
        [b"ihdr", b[1][:4] + struct.pack(">I", 54) + b[1][8:]]
        if b[0] == b"ihdr" else b for b in h]),
    "ihdr_missing_refused": ("rgb", lambda h: [b for b in h
                                               if b[0] != b"ihdr"]),
    "ihdr_twice": ("rgb", lambda h: h + [h[0]]),
}


@functools.cache
def _base(kind: str) -> bytes:
    channels = {"rgb": 3, "rgba": 4, "gray": 1}[kind]
    return _pil(smooth(37, 53, channels, 15))


@pytest.mark.parametrize("name", sorted(BOXES))
def test_box_edits_read_as_cv2(name, tmp_path):
    kind, edit = BOXES[name]
    want = _readers_match_cv2(js.with_jp2h(_base(kind), edit), tmp_path)
    assert (want is None) == name.endswith("refused")


def _top_boxes(edit):
    return lambda d: js.jp2_file(edit(js.jp2_boxes(d)))


TOP_BOXES = {
    "unknown_box_before_jp2h": _top_boxes(
        lambda b: b[:2] + [[b"xml ", b"<a/>"]] + b[2:]),
    "unknown_box_after_jp2c": _top_boxes(lambda b: b + [[b"uuid",
                                                         bytes(20)]]),
    "ftyp_first_refused": _top_boxes(lambda b: [b[1], b[0]] + b[2:]),
    "jp2c_before_jp2h_refused": _top_boxes(
        lambda b: b[:2] + [b[3], b[2]]),
    "jp2h_missing_refused": _top_boxes(lambda b: b[:2] + b[3:]),
    "jp2c_length_0": lambda d: d[:len(d) - len(js.jp2_boxes(d)[-1][1]) - 8]
    + struct.pack(">I", 0) + b"jp2c" + js.jp2_boxes(d)[-1][1],
    "jp2c_missing_refused": _top_boxes(lambda b: b[:3]),
}


@pytest.mark.parametrize("name", sorted(TOP_BOXES))
def test_top_level_box_edits_read_as_cv2(name, tmp_path):
    want = _readers_match_cv2(TOP_BOXES[name](_base("rgb")), tmp_path)
    assert (want is None) == name.endswith("refused")


# --- the markers -------------------------------------------------------------


def _main(edit):
    def apply(data):
        boxes, cs = js.codestream(data)
        main, parts, tail = js.split(cs)
        return js.with_codestream(boxes, js.join(edit(main), parts, tail))
    return apply


def _insert(marker: int, body: bytes, at: int = 1):
    return _main(lambda m: m[:at] + [[marker, body]] + m[at:])


def _siz_precision(ssiz):
    def edit(main):
        out = []
        for m, b in main:
            if m == jpeg2000.SIZ:
                b = bytearray(b)
                for i in range(b[35]):
                    b[36 + 3 * i] = ssiz[i] if isinstance(ssiz, list) else ssiz
                b = bytes(b)
            out.append([m, b])
        return out
    return _main(edit)


def _cod_style(style: int):
    return _main(lambda m: [[k, b[:8] + bytes([style]) + b[9:]
                             if k == jpeg2000.COD else b] for k, b in m])


MARKERS = {
    "com": _insert(jpeg2000.COM, b"\x00\x01hello"),
    "cap": _insert(jpeg2000.CAP, b"\x00\x02\x00\x00\x00\x20"),
    "cpf": _insert(jpeg2000.CPF, b"\x00\x01"),
    "tlm": _insert(jpeg2000.TLM, b"\x00\x50" + bytes(6)),
    "tlm_st_3": _insert(jpeg2000.TLM, b"\x00\x30" + bytes(4)),
    "tlm_short_refused": _insert(jpeg2000.TLM, b"\x00"),
    "plm": _insert(jpeg2000.PLM, b"\x00\x00"),
    "crg": _insert(jpeg2000.CRG, b"\x00\x01\x00\x01" * 3),
    "crg_wrong_size_refused": _insert(jpeg2000.CRG, b"\x00\x01" * 4),
    "mct_zmct_1": _insert(jpeg2000.MCT, b"\x00\x01abcdef"),
    "mct_short_refused": _insert(jpeg2000.MCT, b"\x00\x00\x00\x00"),
    "unknown_marker": _insert(0xFF6F, b"abcd"),
    "unknown_marker_odd_length_refused": _insert(0xFF6F, b"abc"),
    "unknown_marker_before_siz": _insert(0xFF30, b"abcd", 0),
    "sop_in_main_header_refused": _insert(jpeg2000.SOP, b"\x00\x00"),
    "cod_before_siz_refused": _main(lambda m: [m[1], m[0]] + m[2:]),
    "qcd_before_cod": _main(lambda m: [m[0], m[2], m[1]] + m[3:]),
    "qcd_missing_refused": _main(lambda m: [x for x in m
                                            if x[0] != jpeg2000.QCD]),
    "cod_twice": _main(lambda m: m + [x for x in m
                                      if x[0] == jpeg2000.COD]),
    **{f"rgn_shift_{s}": _insert(jpeg2000.RGN, bytes([0, 0, s]), 2)
       for s in (1, 3, 20)},
    "rgn_shift_31_refused": _insert(jpeg2000.RGN, bytes([0, 0, 31]), 2),
    "rgn_component_5_refused": _insert(jpeg2000.RGN, bytes([5, 0, 2]), 2),
    **{f"precision_{p}": _siz_precision(p - 1) for p in (9, 12, 16, 31)},
    "precision_4_refused": _siz_precision(3),
    "precisions_8_12_8": _siz_precision([7, 11, 7]),
    "signed_component_1_refused": _siz_precision([7, 0x87, 7]),
}


@pytest.mark.parametrize("name", sorted(MARKERS))
def test_marker_edits_read_as_cv2(name, tmp_path):
    want = _readers_match_cv2(MARKERS[name](_base("rgb")), tmp_path)
    assert (want is None) == name.endswith("refused")


@pytest.mark.parametrize("style", list(range(1, 0x40)))
def test_every_code_block_style_reads_as_cv2(style, tmp_path):
    """The COD's code-block style byte set to each combination of BYPASS,
    RESET, TERMALL, VSC, PTERM and SEGSYM on data coded with style 0: cv2
    reads or refuses each as OpenJPEG decodes the passes under it."""
    data = _cod_style(style)(_pil(smooth(17, 23, 3, 16),
                                  codeblock_size=(8, 8)))
    _readers_match_cv2(data, tmp_path)


def _tiles() -> bytes:
    return _pil(RGB(17), tile_size=(16, 16), progression="PCRL")


def _parts(edit, base=_tiles, **join):
    def make():
        boxes, cs = js.codestream(base())
        main, parts, tail = js.split(cs)
        return js.with_codestream(boxes, js.join(main, *edit(parts, tail),
                                                 **join))
    return make


TILE_PARTS = {
    "split_2": _parts(lambda p, t: (js.in_parts(p, 2), t)),
    "split_3_interleaved": _parts(lambda p, t: (sorted(
        js.in_parts(p, 3), key=lambda q: (q["tp"], q["tile"])), t)),
    "tnsot_0": _parts(lambda p, t: ([dict(q, tn=0) for q in p], t)),
    "psot_0_last": _parts(lambda p, t: (p, t), psot0_last=True),
    "psot_0_last_no_eoc_refused": _parts(lambda p, t: (p, b""),
                                         psot0_last=True),
    "no_eoc_refused": _parts(lambda p, t: (p, b"")),
    "junk_after_eoc": _parts(lambda p, t: (p, t + b"junk")),
    "junk_instead_of_eoc": _parts(lambda p, t: (p, b"ju")),
    "tiles_reversed": _parts(lambda p, t: (p[::-1], t)),
    "tile_1_missing": _parts(lambda p, t: (p[:1] + p[2:], t)),
    "tile_0_twice_refused": _parts(lambda p, t: (p[:1] + p, t)),
    "tpsot_tnsot_corrected": _parts(
        lambda p, t: ([dict(q, tn=2) for q in js.in_parts(p, 3)], t)),
    "tpsot_tnsot_first_part_refused": _parts(
        lambda p, t: ([dict(q, tn=1) for q in js.in_parts(p, 2)], t)),
    "single_tile_tnsot_0_no_eoc": _parts(
        lambda p, t: ([dict(q, tn=0) for q in p], b""),
        base=lambda: _pil(RGB(17))),
    "header_cod_qcd_com_plt": _parts(lambda p, t: ([dict(
        q, segs=[[jpeg2000.COM, b"\x00\x01x"], [jpeg2000.PLT,
                                                 b"\x00\x05\x81\x02"]])
        if i == 1 else q for i, q in enumerate(p)], t)),
    "header_rgn": _parts(lambda p, t: ([dict(q, segs=[[
        jpeg2000.RGN, b"\x00\x00\x02"]]) if i == 1 else q
        for i, q in enumerate(p)], t)),
    "header_plt_unfinished_refused": _parts(lambda p, t: ([dict(
        q, segs=[[jpeg2000.PLT, b"\x00\x85"]]) if i == 1 else q
        for i, q in enumerate(p)], t)),
    "header_unknown_marker_refused": _parts(lambda p, t: ([dict(
        q, segs=[[0xFF6F, b"ab"]]) if i == 1 else q
        for i, q in enumerate(p)], t)),
}


@pytest.mark.parametrize("name", sorted(TILE_PARTS))
def test_tile_part_layouts_read_as_cv2(name, tmp_path):
    want = _readers_match_cv2(TILE_PARTS[name](), tmp_path)
    assert (want is None) == name.endswith("refused")


def _layered(progression="LRCP", **options) -> bytes:
    return _pil(RGB(18), quality_mode="rates", quality_layers=[40, 20, 10],
                progression=progression, **options)


PACKETS = {
    "sop_eph": lambda: js.with_sop_eph(_layered()),
    "sop_only_tiles": lambda: js.with_sop_eph(_layered(
        "RPCL", tile_size=(16, 16)), eph=False),
    "eph_only_irr": lambda: js.with_sop_eph(_layered(irreversible=True),
                                            sop=False),
    "sop_damaged": lambda: (lambda d: d.replace(b"\xff\x91\x00\x04\x00\x05",
                                                b"\xff\x90\x00\x04\x00\x05"))(
        js.with_sop_eph(_layered(), eph=False)),
    "eph_damaged_refused": lambda: (lambda d: d.replace(
        b"\xff\x92", b"\xff\x93", 1))(js.with_sop_eph(_layered(),
                                                    sop=False)),
    "ppt": lambda: js.with_ppt(_layered("RPCL", tile_size=(16, 16))),
    "ppt_chunks_13": lambda: js.with_ppt(_layered(), 13),
    "ppm": lambda: js.with_ppm(_layered("CPRL", tile_size=(32, 32))),
    "ppm_chunks_29": lambda: js.with_ppm(_layered(irreversible=True), 29),
    "ppm_sop_eph": lambda: js.with_ppm(js.with_sop_eph(_layered())),
    "poc_restating_lrcp": lambda: js.with_poc(_layered(),
                                              [(0, 0, 3, 6, 3, 0)]),
    "poc_layers_split": lambda: js.with_poc(
        _layered(), [(0, 0, 1, 6, 3, 0), (0, 0, 3, 6, 3, 0)]),
    "poc_in_tile_header": lambda: js.with_poc(
        _layered(), [(0, 0, 1, 6, 3, 0), (0, 0, 3, 6, 3, 0)], in_tile=True),
    "poc_partial_resolutions": lambda: js.with_poc(_layered(),
                                                   [(0, 0, 3, 3, 3, 0)]),
    "poc_two_components": lambda: js.with_poc(_layered(),
                                              [(0, 0, 3, 6, 2, 0)]),
    "poc_unknown_order": lambda: js.with_poc(_layered(),
                                             [(0, 0, 3, 6, 3, 7)]),
    "poc_rpcl_resolutions_split": lambda: js.with_poc(
        _layered("RPCL", tile_size=(32, 32)),
        [(0, 0, 3, 3, 3, 2), (3, 0, 3, 6, 3, 2)]),
    "poc_cprl_per_component": lambda: js.with_poc(
        _layered("CPRL"), [(0, 0, 3, 6, 1, 4), (0, 1, 3, 6, 3, 4)]),
    "poc_rlcp_over_lrcp_refused": lambda: js.with_poc(
        _layered(), [(0, 0, 3, 6, 3, 1)]),
}


@pytest.mark.parametrize("name", sorted(PACKETS))
def test_packet_edits_read_as_cv2(name, tmp_path):
    want = _readers_match_cv2(PACKETS[name](), tmp_path)
    assert (want is None) == name.endswith("refused")


def test_what_no_fixture_can_be_made_of_is_refused_by_name():
    """HT code-blocks and the Part 2 multi-component markers MCC, MCO and
    CBD: OpenJPEG may decode them, no encoder here makes them, and the
    port names them (ROADMAP C9b-J2K-rest)."""
    base = _base("rgb")
    with pytest.raises(ValueError, match="HT code-blocks"):
        image_io.decode_image(_cod_style(0x40)(base))
    for marker, name in ((jpeg2000.MCC, "MCC"), (jpeg2000.MCO, "MCO"),
                         (jpeg2000.CBD, "CBD")):
        with pytest.raises(ValueError, match=name):
            image_io.decode_image(_insert(marker, b"\x00\x00\x00")(base))


# --- the plain tiers, the fixtures and the search ----------------------------


PLAIN_CASES = {
    "fixture_rev_gray": lambda: (FIXTURES / J2K_FIXTURES[1]).read_bytes(),
    "fixture_irr_rpcl_layers3": lambda: (FIXTURES
                                         / J2K_FIXTURES[0]).read_bytes(),
    "styles_all_but_termall": lambda: _cod_style(0x3B)(_pil(
        smooth(17, 23, 3, 16), codeblock_size=(8, 8))),
    "ppm_sop_eph_tiles_parts": lambda: _parts(
        lambda p, t: (js.in_parts(p, 2), t),
        base=lambda: js.with_ppm(js.with_sop_eph(_pil(
            smooth(21, 27, 3, 19), tile_size=(8, 8), progression="RPCL",
            quality_mode="rates", quality_layers=[30, 10]))))(),
    "poc_rgn_irr_cdef": lambda: js.with_jp2h(_insert(
        jpeg2000.RGN, b"\x01\x00\x03", 2)(js.with_poc(_pil(
            smooth(19, 25, 3, 20), irreversible=True, quality_mode="dB",
            quality_layers=[30, 40]), [(0, 0, 1, 6, 3, 0),
                                       (0, 0, 2, 6, 3, 0)])),
        _cdef((0, 0, 2), (1, 0, 1), (2, 0, 3))),
    "palette_16_bit_sycc": lambda: js.with_jp2h(
        _pil(smooth(23, 19, 1, 21)), _palette(TABLE * 251, [16, 16, 16],
                                              RGB3, 18)),
}


@pytest.mark.parametrize("name", sorted(PLAIN_CASES))
def test_plain_tiers_equal_the_c_library(name, tmp_path):
    """decode_image_plain (tiers 1 and 2, the transforms and the level
    shift in Python) against decode_image (csrc/jpeg2000.c) and cv2 on
    six small files between them carrying every feature read."""
    want = _readers_match_cv2(PLAIN_CASES[name](), tmp_path, plain=True)
    assert want is not None


@pytest.mark.parametrize("name", J2K_FIXTURES)
def test_committed_fixtures_read_to_their_digests(name):
    """What the card's machine holds the port to without cv2 or Pillow."""
    want = DIGESTS[name]
    data = (FIXTURES / name).read_bytes()
    for rgb in (image_io.decode_image(data), image_io.decode_image_plain(data),
                image_io.read_image(FIXTURES / name)):
        assert [list(rgb.shape), _sha(rgb)] == [want["shape"],
                                                 want["rgb_sha256"]]
    assert image_io.image_size(FIXTURES / name) == tuple(want["shape"][:2])


def _sha(a) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_fixtures_carry_what_they_are_named_for():
    rev, irr = ((FIXTURES / n).read_bytes() for n in reversed(J2K_FIXTURES))
    assert rev.startswith(jpeg2000.JP2_SIGNATURE) \
        and irr.startswith(jpeg2000.J2K_SIGNATURE)
    for data, qmfbid, prg, layers, comps in ((rev, 1, 0, 1, 1),
                                             (irr, 0, 2, 3, 3)):
        cs = jpeg2000._header(data)[1]
        tcp = cs.default
        assert (tcp.tccps[0].qmfbid, tcp.prg, tcp.numlayers,
                len(cs.image.comps)) == (qmfbid, prg, layers, comps)


def test_seeded_cuts_and_flips_read_as_cv2():
    """`jpeg2000_cut_search` on 40 seeded cases of each corpus file (cuts
    after a byte, bytes XORed with 0x01, 0x10 or 0x80): every reader
    agrees with cv2. The full search is the script's."""
    files = search.corpus()
    result = search.search(search.cases(files, seed=0, per_file=40))
    assert result["cases"] == 40 * len(files)
    assert result["differences"] == 0, result["files"]


def test_write_jp2_stays_refused(tmp_path):
    """Of the JPEG 2000 suffixes cv2 5.0 writes only .jp2
    (`cv2.haveImageWriter` is False for .j2k and .jpx): those two are
    refused by name, and no file is written. The .jp2 writer is held in
    tests/test_torch_jpeg2000_write.py."""
    for suffix in (".j2k", ".jpx"):
        assert not cv2.haveImageWriter("x" + suffix)
        with pytest.raises(ValueError, match=suffix):
            image_io.write_image(tmp_path / f"x{suffix}", smooth(40, 40, 3, 0))
        assert not (tmp_path / f"x{suffix}").exists()


def test_loader_and_prepare_take_jpeg2000(tmp_path):
    """The loader's read_image and prepare's shards (decode_image) take
    JPEG 2000 files as the JAX package's cv2 does."""
    from multiposenet_tpu.data import prepare as jprepare
    from multiposenet_tpu_torch.data import loader, prepare

    names = ["scene.jp2", "scene.j2k"]
    scene = smooth(48, 64, 3, 22)
    (tmp_path / "img").mkdir()
    (tmp_path / "img" / names[0]).write_bytes(_pil(scene))
    (tmp_path / "img" / names[1]).write_bytes(_pil(
        scene, irreversible=True, no_jp2=True))
    images = [{"id": i, "file_name": n, "height": 48, "width": 64}
              for i, n in enumerate(names)]
    anns = [{"id": i + 1, "image_id": i, "category_id": 1, "iscrowd": 0,
             "bbox": [10.0, 10.0, 20.0, 30.0], "area": 600.0,
             "keypoints": [20, 20, 2] * 17, "num_keypoints": 17}
            for i in range(len(names))]
    coco = tmp_path / "ann.json"
    coco.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": 1,
                                                "name": "person"}]}))
    for name in names:
        want = _cv2((tmp_path / "img" / name).read_bytes())
        got = loader.load_image({"file_name": name}, str(tmp_path / "img"))
        np.testing.assert_array_equal(got, want)
    prepare.prepare_coco(coco, tmp_path / "img", tmp_path / "port")
    jprepare.prepare_coco(coco, tmp_path / "img", tmp_path / "jax")
    got = list(prepare.read_shards(tmp_path / "port"))
    want = list(jprepare.read_shards(tmp_path / "jax"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
