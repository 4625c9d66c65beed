"""AVIF container forms against cv2 5.0 (libavif 1.4.2): grid images,
Exif items and image sequences (brand avis), made at test time by the
wheel's libavif encoder (`tests/avif_reference.py` avif_grid, avif_encode
with Exif, avif_sequence) and Pillow (save_all), and by surgery on them
(heif_parts / heif_write, avis_meta, to_co64, box_edit). Every file cv2
reads decodes through `image_io.decode_image` (the host C library) and
`decode_image_plain` (the plain decoder, on the smaller files) to
`cv2.imdecode(..., IMREAD_COLOR)` reversed to RGB, Exif orientation
applied, with tolerance 0, and `image_size` gives cv2's shape; every file
cv2 returns no image for is refused by a ValueError that names the form.

cv2's AVIF decoder claims a file only where libavif's parse of its first
500 bytes succeeds or runs out of data (`avif.signature_refusal`): an
Exif item, a grid payload or (without a `colr` nclx) the image data that
the parse reads and that starts past byte 500 while the metadata lies
within it leaves the file unread. The Exif-offset sweep holds that rule
on both layouts. A 20-case slice of `tools/avif_search.py --forms
container` runs here.
"""

import struct
from pathlib import Path

import numpy as np
import pytest

import avif_reference as ar
from multiposenet_tpu_torch.tools import avif_search
from multiposenet_tpu_torch.utils import avif, image_io
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(ar.LIBAVIF is None,
                                reason="the opencv-python wheel's libavif "
                                       "is absent")

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"


def _size(tmp_path, data: bytes) -> tuple:
    path = tmp_path / "x.avif"
    path.write_bytes(data)
    return image_io.image_size(path)


def _equal_cv2(data: bytes, tmp_path, plain: bool = True) -> np.ndarray:
    """The port's pixels (C, and plain where asked) and image_size equal
    cv2's; returns cv2's."""
    want = ar.imdecode_rgb(data)
    assert want is not None
    np.testing.assert_array_equal(image_io.decode_image(data), want)
    if plain:
        np.testing.assert_array_equal(image_io.decode_image_plain(data),
                                      want)
    assert _size(tmp_path, data) == want.shape[:2]
    return want


def _refused(data: bytes, name: str) -> None:
    """cv2 returns no image; the port refuses, naming `name`."""
    assert ar.imdecode_rgb(data) is None
    with pytest.raises(ValueError, match=name):
        image_io.decode_image(data)
    with pytest.raises(ValueError, match=name):
        image_io.decode_image_plain(data)


def _cells(h: int, w: int, seed: int, depth: int = 8,
           fmt: int = ar.YUV420, **kw) -> bytes:
    """A single-item file of a seeded drawing (a grid cell)."""
    px = ar.drawing(h, w, seed)
    if depth > 8:
        px = ar.widen(px, depth)
    return ar.avif_encode(ar.planes_of(px, depth, fmt), depth, fmt, **kw)


# --- grids -------------------------------------------------------------------

# (rows, columns, cell height, cell width, output height, output width,
# depth, avifPixelFormat, alpha, plain): the wheel's encoder's grids.
GRIDS = [(2, 2, 64, 64, 128, 128, 8, ar.YUV420, False, True),
         (1, 3, 64, 96, 64, 288, 8, ar.YUV420, False, True),
         (3, 2, 128, 128, 384, 256, 8, ar.YUV420, False, False),
         (2, 2, 64, 64, 126, 100, 8, ar.YUV420, False, True),
         (2, 2, 64, 64, 127, 65, 8, ar.YUV444, False, True),
         (2, 1, 64, 64, 127, 64, 8, ar.YUV422, False, True),
         (2, 2, 64, 64, 101, 99, 8, ar.YUV400, False, True),
         (1, 2, 64, 66, 64, 131, 10, ar.YUV444, False, True),
         (2, 1, 64, 64, 128, 64, 12, ar.YUV420, False, True),
         (1, 3, 64, 64, 64, 192, 8, ar.YUV420, True, True),
         (4, 4, 64, 64, 256, 256, 10, ar.YUV420, True, False)]


@pytest.mark.parametrize("case", GRIDS, ids=lambda c: "x".join(
    map(str, c[:6])) + f"-{c[6]}bit-fmt{c[7]}" + ("-alpha" if c[8] else ""))
def test_grids_equal_cv2(case, tmp_path):
    """Grids of every depth and subsampling the writers make (4:0:0,
    4:2:0, 4:2:2, 4:4:4 at 8, 10 and 12 bits), from the smallest cells
    (64) up, their outputs cropped inside the last row and column (odd
    sides at 4:4:4, 4:0:0 and, in height, 4:2:2), with an alpha grid
    (decoded and dropped): the cells stitched, cropped, then converted,
    as cv2 returns them."""
    rows, cols, ch, cw, h, w, depth, fmt, alpha, plain = case
    rgb = ar.drawing(h, w, rows * 10 + cols)
    a = np.random.default_rng(h).integers(0, 256, (h, w), np.uint8) \
        if alpha else None
    if a is not None and depth > 8:
        a = ar.widen(a, depth)
    data = ar.grid_from_rgb(rgb, rows, cols, ch, cw, depth, fmt, alpha=a,
                            quality=60, speed=9)
    image = avif.read_image(data)
    assert image.form == "grid" and image.grid == (rows, cols, w, h)
    assert len(image.cells) == rows * cols
    assert len(image.alpha_cells) == (rows * cols if alpha else 0)
    want = _equal_cv2(data, tmp_path, plain)
    assert want.shape == (h, w, 3)


def test_grid_with_exif_orientation_6_is_turned(tmp_path):
    """A 2x2 grid of 64x64 cells with an Exif item of orientation 6 (the
    wheel's encoder puts it before the image and adds an irot, which cv2
    does not apply): cv2 turns the stitched image 90 degrees clockwise,
    and so does the port; image_size swaps the sides."""
    rgb = ar.drawing(128, 100, 5)
    data = ar.grid_from_rgb(rgb, 2, 2, 64, 64,
                            exif=ar.tiff_orientation(6), quality=50,
                            speed=9)
    image = avif.read_image(data)
    assert image.form == "grid" and image.exif is not None
    want = _equal_cv2(data, tmp_path, plain=False)
    assert want.shape == (100, 128, 3)


def test_grid_colour_as_libavif_takes_it(tmp_path):
    """The colour description of a grid: the grid item's own `colr`
    (range included, whatever the cells' sequence headers say), else the
    first cell's sequence header (a `colr` on the cells is not read);
    the cells in `dimg` reference order, not item order."""
    base = [_cells(64, 64, i) for i in range(2)]
    nclx = [(b"colr", b"nclx" + bytes([0, 1, 0, 13, 0, m, r << 7]), False)
            for m, r in ((1, 0), (6, 0))]
    for files, props in ((base, None), (base, []),
                         ([ar.patch_colr(b, 1, 0) for b in base], []),
                         (base, nclx[:1]), (base, nclx[1:]),
                         ([_cells(64, 64, i, full_range=0)
                           for i in range(2)], nclx[1:])):
        data = ar.grid_of_items(files, 1, 2, 128, 64, grid_props=props)
        _equal_cv2(data, tmp_path, plain=False)
    data = ar.grid_of_items(base, 1, 2, 128, 64)
    parts = ar.heif_parts(data)
    parts["refs"] = [(b"dimg", 1, [3, 2])]
    swapped = ar.heif_write(parts)
    want = _equal_cv2(swapped, tmp_path, plain=False)
    assert not np.array_equal(want, ar.imdecode_rgb(data))


def _grid_payload(data: bytes, payload: bytes) -> bytes:
    parts = ar.heif_parts(data)
    next(it for it in parts["items"] if it["type"] == b"grid")["data"] = \
        payload
    return ar.heif_write(parts)


def _grid_refusals():
    """(name, file, what the refusal names) of grids cv2 returns no
    image for, each found by probing cv2 (its libavif diagnostics)."""
    base = [_cells(64, 64, i) for i in range(4)]
    two = base[:2]
    grid = ar.grid_of_items(two, 1, 2, 128, 64)

    def retyped(parts):
        parts["items"][1]["type"] = b"av02"
        return ar.heif_write(parts)

    def ispe(parts):
        parts["items"][0]["props"] = [
            (k, b"\0" * 4 + struct.pack(">II", 100, 64) if k == b"ispe"
             else p, e) for k, p, e in parts["items"][0]["props"]]
        return ar.heif_write(parts)

    yield "cells_under_64", ar.grid_of_items(
        [_cells(32, 32, i) for i in range(4)], 2, 2, 64, 64), "under 64"
    yield "odd_output_420", ar.grid_of_items(two, 1, 2, 127, 64), "odd"
    yield "odd_output_422_width", ar.grid_of_items(
        [_cells(64, 64, i, fmt=ar.YUV422) for i in range(2)], 1, 2, 127,
        64), "odd"
    yield "output_past_cells", ar.grid_of_items(two, 1, 2, 129, 64), \
        "do not cover"
    yield "last_column_outside", ar.grid_of_items(two, 1, 2, 64, 64), \
        "outside its output"
    yield "too_few_cells", ar.grid_of_items(base[:3], 2, 2, 128, 128), \
        "has 3"
    yield "too_many_cells", ar.grid_of_items(base, 1, 2, 128, 64), "has 4"
    yield "cell_monochrome", ar.grid_of_items(
        [base[0], _cells(64, 64, 9, fmt=ar.YUV400)], 1, 2, 128, 64), "av1C"
    yield "cell_10_bit", ar.grid_of_items(
        [base[0], _cells(64, 64, 9, depth=10)], 1, 2, 128, 64), "av1C"
    yield "cell_other_size", ar.grid_of_items(
        [base[0], _cells(64, 80, 9)], 1, 2, 128, 64), "differ in size"
    yield "cell_other_matrix", ar.grid_of_items(
        [base[0], _cells(64, 64, 9, matrix=1)], 1, 2, 128, 64), \
        "colour description"
    yield "cell_other_range", ar.grid_of_items(
        [base[0], _cells(64, 64, 9, full_range=0)], 1, 2, 128, 64), "range"
    yield "cell_type_av02", retyped(ar.heif_parts(grid)), "type"
    yield "grid_ispe_differs", ispe(ar.heif_parts(grid)), "ispe"
    yield "payload_version_1", _grid_payload(
        grid, b"\x01\x00\x00\x01\x00\x80\x00\x40"), "version"
    yield "payload_trailing_byte", _grid_payload(
        grid, b"\x00\x00\x00\x01\x00\x80\x00\x40\x00"), "length"
    yield "payload_short", _grid_payload(grid, b"\x00\x00\x00\x01\x00\x80"), \
        "length"
    rgb = ar.drawing(64, 128, 3)
    yield "monochrome_with_alpha", ar.avif_grid(
        [ar.planes_of(np.ascontiguousarray(rgb[:, 64 * k:64 * (k + 1)]), 8,
                      ar.YUV400) for k in range(2)], 2, 1, 8, ar.YUV400,
        alpha=[np.full((64, 64), 99, np.uint8)] * 2, speed=9), "monochrome"
    alpha = ar.avif_grid(
        [ar.planes_of(np.ascontiguousarray(rgb[:, 64 * k:64 * (k + 1)]), 8,
                      ar.YUV420) for k in range(2)], 2, 1, 8, ar.YUV420,
        alpha=[np.full((64, 64), 99, np.uint8)] * 2, speed=9)
    yield "alpha_grid_other_size", ar.patch_grid(alpha, 126, 62), "alpha"
    # The payload in mdat past byte 500, the metadata within it.
    parts = ar.heif_parts(grid)
    parts["items"][0]["idat"] = False
    parts["items"][0]["at"] = 1 << 30
    yield "payload_past_byte_500", ar.heif_write(parts), "500"


@pytest.mark.parametrize("name", [n for n, _, _ in _grid_refusals()])
def test_grid_refusals_where_cv2_returns_none(name):
    """Each of libavif 1.4.2's grid checks that cv2 meets (cell count,
    cells of one av1C and of one size, depth, subsampling, range and
    colour description, the output within the cells' span and over
    their last row and column, cells of 64 and more, even sides where
    the chroma is subsampled, the grid's ispe, the payload's form, alpha
    of the image's size, the 500 bytes cv2's signature check parses):
    cv2 returns no image, the port refuses by name."""
    data, what = next((d, w) for n, d, w in _grid_refusals() if n == name)
    _refused(data, what)


# --- Exif --------------------------------------------------------------------


@pytest.mark.parametrize("orientation", range(10))
def test_exif_orientations_equal_cv2(orientation, tmp_path):
    """An Exif item of each orientation (0 and 9 are none) on a 48x80
    still from the wheel's encoder, little- and big-endian: cv2 applies
    it as it does for JPEG, so does the port; image_size swaps the sides
    for 5 to 8. A TIFF behind an "Exif\\0\\0" prefix (offset 6) is read,
    its orientation not (OpenCV's Exif reader wants the TIFF header
    first)."""
    planes = ar.planes_of(ar.drawing(48, 80, orientation), 8, ar.YUV420)
    for little in (True, False):
        data = ar.avif_encode(planes, 8, ar.YUV420, speed=9,
                              exif=ar.tiff_orientation(orientation, little))
        want = _equal_cv2(data, tmp_path, plain=little)
        turned = orientation in (5, 6, 7, 8)
        assert want.shape[:2] == ((80, 48) if turned else (48, 80))
    data = ar.avif_encode(planes, 8, ar.YUV420, speed=9,
                          exif=ar.tiff_orientation(orientation,
                                                   prefix=b"Exif\0\0"))
    assert _equal_cv2(data, tmp_path, plain=False).shape == (48, 80, 3)


def _with_exif(data: bytes, payload: bytes) -> bytes:
    parts = ar.heif_parts(data)
    next(it for it in parts["items"] if it["type"] == b"Exif")["data"] = \
        payload
    return ar.heif_write(parts)


def test_exif_payloads_as_cv2_reads_them(tmp_path):
    """libavif checks the Exif item's 4-byte TIFF header offset against
    the first "II*\\0" or "MM\\0*" with a byte after it: a mismatch, no
    header, or fewer than 4 bytes is no image to cv2 and refused here;
    an empty item is skipped; a damaged IFD reads with orientation 1; an
    irot or imir beside the Exif is still not applied; an Exif item that
    describes no item is not read."""
    planes = ar.planes_of(ar.drawing(40, 64, 1), 8, ar.YUV420)
    t6 = ar.tiff_orientation(6)
    data = ar.avif_encode(planes, 8, ar.YUV420, speed=9, exif=t6)
    for payload in (b"\0\0\0\x02" + t6, b"\0\0\0\0Exif\0\0" + t6, b"\0\0\0",
                    b"\0\0\0\0", b"\0\0\0\0II*\0", b"\0\0\0\0" + t6[2:]):
        _refused(_with_exif(data, payload), "Exif")
    for payload, shape in ((b"", (40, 64)), (b"\0\0\0\0II*\0\x08", (40, 64)),
                           (b"\0\0\0\0II*\0\xff\0\0\0", (40, 64)),
                           (b"\0\0\0\0" + t6[:16], (40, 64)),
                           (b"\0\0\0\x06Exif\0\0" + t6, (40, 64)),
                           (b"\0\0\0\0" + t6, (64, 40))):
        assert _equal_cv2(_with_exif(data, payload), tmp_path,
                          plain=False).shape[:2] == shape
    for prop in (b"irot", b"imir"):
        parts = ar.heif_parts(data)
        parts["items"][0]["props"].append((prop, b"\x01", True))
        assert _equal_cv2(ar.heif_write(parts), tmp_path,
                          plain=False).shape[:2] == (64, 40)
    parts = ar.heif_parts(data)
    parts["refs"] = []
    assert _equal_cv2(ar.heif_write(parts), tmp_path,
                      plain=False).shape[:2] == (40, 64)


def test_exif_offset_sweep_holds_cv2s_rule():
    """The sweep that found the rule: the fixture's 33x17 image with an
    Exif item of orientation 6 after the image (`edit_avif`) or before it
    (`heif_write`), its meta box grown by a property or padding so that
    the TIFF header moves from byte 335 to past 1200. cv2 reads and turns
    the image where the Exif item starts within the first 500 bytes or
    the meta box ends past them (libavif's parse of cv2's 500-byte
    signature then runs out of data before it reads the item), and
    returns no image where the item starts past byte 500 and the meta box
    ends within it; the port does the same, naming the 500 bytes."""
    data = (FIXTURES / "avif_odd_33x17.avif").read_bytes()
    tiff = ar.tiff_orientation(6)
    seen = {}
    files = [ar.edit_avif(data, exif=tiff, add_props=[
        (b"free", b"\0" * pad, False)] if pad else []) for pad in
        range(0, 760, 5)]
    parts = ar.heif_parts(ar.edit_avif(data, exif=tiff))
    exif_id = next(it["id"] for it in parts["items"] if it["type"] == b"Exif")
    files += [ar.heif_write(parts, order=[exif_id, parts["primary"]],
                            meta_pad=pad) for pad in range(0, 920, 7)]
    for edited in files:
        at = edited.index(tiff)
        meta_end = edited.index(b"mdat") - 4
        want = ar.imdecode_rgb(edited)
        rule = at - 4 <= 500 or meta_end > 500
        assert (want is not None) == rule, at
        if want is None:
            with pytest.raises(ValueError, match="500"):
                image_io.decode_image(edited)
        else:
            assert want.shape == (17, 33, 3)
            np.testing.assert_array_equal(image_io.decode_image(edited), want)
        seen[want is None, at < 500] = True
    offsets = [f.index(tiff) for f in files]
    assert len(seen) == 3 and min(offsets) < 340 and max(offsets) > 1200


def test_parse_reads_past_byte_500_as_cv2():
    """The same rule for the other reads of libavif's parse: without a
    `colr` nclx it reads the start of the image's data for the AV1
    sequence header, so a file whose image data starts past byte 500
    (its metadata within) is no image to cv2; an XMP item (mime,
    application/rdf+xml) past it, likewise; a box header cut at byte 500
    by the top-level walk, likewise."""
    planes = ar.planes_of(ar.drawing(24, 40, 2), 8, ar.YUV420)
    data = ar.avif_encode(planes, 8, ar.YUV420, speed=9)
    parts = ar.heif_parts(data)
    parts["items"][0]["props"] = [p for p in parts["items"][0]["props"]
                                  if p[0] != b"colr"]
    near = ar.heif_write(parts)
    assert ar.imdecode_rgb(near) is not None
    meta_end = near.index(b"mdat") - 4
    padded = ar.heif_write(parts, meta_pad=492 - meta_end)
    assert padded.index(b"mdat") - 4 == 500
    _refused(padded, "500")
    parts = ar.heif_parts(data)
    parts["items"].append({"id": 9, "type": b"mime", "name": b"",
                           "data": b"<x:xmpmeta/>", "props": [],
                           "idat": False, "at": 1 << 30,
                           "content_type": b"application/rdf+xml"})
    parts["refs"].append((b"cdsc", 9, [parts["primary"]]))
    far = ar.heif_write(parts, meta_pad=100)
    assert far.index(b"<x:xmpmeta/>") > 500 > far.index(b"mdat")
    _refused(far, "XMP")
    cut = ar.heif_write(ar.heif_parts(data), before_meta=ar._box(
        b"free", b"\0" * (496 - 8 - len(data[:data.index(b"meta") - 4]))))
    _refused(cut, "cut short")


# --- image sequences ---------------------------------------------------------


def _frames(n: int, h: int = 64, w: int = 96):
    return [ar.drawing(h, w, 20 + k) for k in range(n)]


def _sequences():
    frames = _frames(3)
    planes = [ar.planes_of(f, 8, ar.YUV420) for f in frames]
    yield "pillow_3", ar.pillow_avis(frames)
    yield "pillow_2_444", ar.pillow_avis(_frames(2, 40, 56),
                                         subsampling="4:4:4")
    yield "pillow_rgba", ar.pillow_avis(
        [np.dstack([f, np.full(f.shape[:2], 150, np.uint8)])
         for f in frames])
    libavif = ar.avif_sequence(planes, 8, ar.YUV420, speed=9)
    yield "libavif_3", libavif
    yield "libavif_4_10bit", ar.avif_sequence(
        [ar.planes_of(ar.widen(f, 10), 10, ar.YUV420)
         for f in _frames(4, 32, 48)], 10, ar.YUV420, speed=9)
    yield "libavif_alpha", ar.avif_sequence(
        planes, 8, ar.YUV420, speed=9,
        alpha=[np.full((64, 96), 90, np.uint8)] * 3)
    yield "co64", ar.to_co64(libavif)
    yield "items_in_idat", ar.avis_meta(libavif)
    yield "no_items", ar.avis_meta(
        libavif, lambda p: p["items"].clear() or p["refs"].clear())

    def top_exif(parts):
        parts["items"].append({
            "id": 9, "type": b"Exif", "name": b"", "idat": True,
            "content_type": b"",
            "data": b"\0\0\0\0" + ar.tiff_orientation(6), "props": []})
        parts["refs"].append((b"cdsc", 9, [parts["primary"]]))

    yield "file_exif_not_read", ar.avis_meta(libavif, top_exif)
    yield "stss_without_sample_1", ar.avis_track_edit(
        libavif, (b"mdia", b"minf", b"stbl", b"stss"),
        lambda p: p[:4] + struct.pack(">II", 1, 2))


@pytest.mark.parametrize("name", [n for n, _ in _sequences()])
def test_sequences_equal_cv2(name, tmp_path):
    """Image sequences from Pillow (3 frames, 4:4:4, RGBA) and the
    wheel's libavif encoder (3 and 4 frames, 10 bits, an alpha track),
    and edits of them (co64 chunk offsets, the items moved into idat or
    dropped: no pitm; an Exif item of the file's meta, which cv2 does not
    read for a sequence; an stss without sample 1, which libavif treats
    as a sync sample all the same): cv2 returns the colour track's first
    frame, and so does the port."""
    data = next(d for n, d in _sequences() if n == name)
    image = avif.read_image(data)
    assert image.form == "sequence"
    _equal_cv2(data, tmp_path)


def _swap_still(data: bytes, major: bytes, compatible=None) -> bytes:
    """A sequence whose still item holds another image (appended) than
    the first frame, under another major brand."""
    other = _cells(64, 96, 99)
    c = avif.read_container(other)
    obus = avif.item_data(other, c, c.items[c.primary])

    def edit(parts):
        next(it for it in parts["items"]
             if it["id"] == parts["primary"])["data"] = obus

    out = ar.avis_meta(data, edit)
    brands = [major] + list(compatible or avif.read_container(out).brands[1:])
    ftyp = ar._box(b"ftyp", major + b"\0\0\0\0" + b"".join(brands[1:]))
    old = int.from_bytes(out[:4], "big")
    moved = ar.shift_chunk_offsets(ftyp + out[old:], len(ftyp) - old, old)
    return moved


def test_the_picture_cv2_returns_from_a_sequence(tmp_path):
    """libavif's AVIF_DECODER_SOURCE_AUTO on a sequence whose still item
    differs from its first frame: the track where the major brand is
    avis, the still item where it is avif, and where it is another brand,
    the track if its parse read the moov box (avis among the brands) and
    the item if not."""
    data = ar.avif_sequence([ar.planes_of(f, 8, ar.YUV420)
                             for f in _frames(2)], 8, ar.YUV420, speed=9)
    first = ar.imdecode_rgb(data)
    still = ar.imdecode_rgb(_cells(64, 96, 99))
    for major, compatible, want in (
            (b"avis", None, first), (b"avif", None, still),
            (b"mif1", [b"avif", b"avis", b"mif1"], first),
            (b"mif1", [b"avif", b"mif1"], still)):
        edited = _swap_still(data, major, compatible)
        got = _equal_cv2(edited, tmp_path, plain=False)
        np.testing.assert_array_equal(got, want)
        assert avif.read_image(edited).form == (
            "sequence" if want is first else "item")


def test_sequence_refusals_where_cv2_returns_none():
    """A monochrome sequence with an alpha track, a first sample that is
    not a key frame, a sample past the end of the file: cv2 returns no
    image, the port refuses by name. A tkhd of another size than the
    frame: cv2 returns the frame scaled to it, the port refuses naming
    the tkhd (as it refuses an ispe of another size)."""
    frames = _frames(3, 32, 48)
    gray = [ar.planes_of(f, 8, ar.YUV400) for f in frames]
    _refused(ar.avif_sequence(gray, 8, ar.YUV400, speed=9,
                              alpha=[np.full((32, 48), 9, np.uint8)] * 3),
             "monochrome")
    data = ar.avif_sequence([ar.planes_of(f, 8, ar.YUV420) for f in frames],
                            8, ar.YUV420, speed=9)
    t = avif.read_container(data).tracks[0]
    sizes = avif._samples(t)

    def sizes_from_2(payload):
        n = len(sizes) - 1
        return payload[:8] + struct.pack(">I", n) + b"".join(
            struct.pack(">I", s) for _, s in sizes[1:])

    def stsc_n(payload):
        return payload[:4] + struct.pack(">IIII", 1, 1, len(sizes) - 1, 1)

    edited = ar.avis_track_edit(data, (b"mdia", b"minf", b"stbl", b"stsz"),
                                sizes_from_2)
    edited = ar.avis_track_edit(edited, (b"mdia", b"minf", b"stbl",
                                         b"stsc"), stsc_n)
    moved = avif.read_container(edited).tracks[0].chunks[0] + sizes[0][1]
    edited = ar.avis_track_edit(edited, (b"mdia", b"minf", b"stbl",
                                         b"stco"),
                                lambda p: p[:8] + struct.pack(">I", moved))
    _refused(edited, "first sample")
    cut = data[:-10]
    _refused(cut, "outside the file")
    tk = ar.avis_track_edit(data, (b"tkhd",), lambda p: p[:-8] + struct.pack(
        ">II", 40 << 16, 32 << 16))
    assert ar.imdecode_rgb(tk).shape == (32, 40, 3)
    with pytest.raises(ValueError, match="tkhd"):
        image_io.decode_image(tk)


def test_container_search_slice_finds_no_difference():
    """The first 20 cases of tools/avif_search.py --forms container at
    its default seed."""
    result = avif_search.search_containers(avif_search.container_cases(20))
    assert result["cases"] == 20
    assert result["differences"] == []
