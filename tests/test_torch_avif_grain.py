"""Film grain synthesis and segmentation in the port's AV1 decoder,
against libaom 3.14.1 (the opencv-python wheel's, over ctypes) and cv2
5.0 (libavif 1.4.2 over that libaom).

Files are made at test time by the wheel's libavif encoder with libaom's
own options: `film-grain-test` 1 to 16 (libaom's test vectors),
`film-grain-table` (a parameter file of drawn values: every lag, no luma
points, chroma scaling from luma, overlap, the shifts, the seeds),
`aq-mode=1` (variance AQ: the first frame of a sequence is segmented),
at 8, 10 and 12 bits and 4:0:0, 4:2:0, 4:2:2 and 4:4:4, odd sides, as
stills, grid cells and a sequence's first frame. Each file is held three
ways: the C planes before the grain to libaom's with its grain skipped
(control 282), the planes after it (C and plain) to libaom's output, and
the port's RGB (C and plain) to cv2's, with tolerance 0.

What libaom's encoder never writes is made by editing its streams: grain
parameters drawn and written into a frame header
(`avif_reference.rewrite_frame`, the clip to the restricted range and
the identity matrix included), and segment features libaom's encoder
does not use (SEG_LVL_ALT_LF_*, SEG_LVL_SKIP, SEG_LVL_REF_FRAME,
SEG_LVL_GLOBALMV, skipped blocks that take the predicted id, segments
whose qindex clamps to 0 in a frame that is not lossless: the per-block
Walsh-Hadamard transform) by re-coding a lossless file's tile
(`avif_reference.recode_segmented`). Streams libaom refuses (too many
or unordered scaling points, grain on one chroma plane of a 4:2:0
frame, a segment id past the last active one) are refused by name, and
cv2 returns no image for them. A 20-case slice of
`tools/avif_search.py --forms tools` runs here.
"""

import ctypes
import dataclasses

import numpy as np
import pytest

import avif_reference as ar
from multiposenet_tpu_torch.tools import avif_search
from multiposenet_tpu_torch.utils import av1, avif, image_io
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(ar.LIBAVIF is None,
                                reason="the opencv-python wheel's libavif "
                                       "is absent")

FORMATS = (ar.YUV420, ar.YUV444, ar.YUV422, ar.YUV400)


def _picture(h: int, w: int, seed: int, depth: int, fmt: int,
             noise: int = 6, full_range: int = 1):
    rgb = ar.drawing(h, w, seed).astype(np.int64)
    rgb += np.random.default_rng(seed).integers(-noise, noise + 1, rgb.shape)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    if depth > 8:
        rgb = ar.widen(rgb, depth, seed)
    return ar.planes_of(rgb, depth, fmt, full_range=full_range)


def _same(got, want) -> bool:
    return all((a is None and b is None) or np.array_equal(a, b)
               for a, b in zip(got, want))


def _equal_libaom(obus: bytes, frame, plain: bool = True) -> np.ndarray:
    """The C planes before and after the grain, and the plain ones, equal
    libaom's; returns the C counters."""
    c = avif.decode_planes_c(frame)
    assert _same(avif.decode_planes_c(frame, grain=False)[:3],
                 ar.aom_planes(obus, skip_film_grain=True))
    assert _same(c[:3], ar.aom_planes(obus))
    if plain:
        assert _same(av1.decode_planes_plain(frame), c[:3])
    return c[3]


def _equal_cv2(data: bytes, plain: bool = True) -> None:
    want = ar.imdecode_rgb(data)
    assert want is not None
    np.testing.assert_array_equal(image_io.decode_image(data), want)
    if plain:
        np.testing.assert_array_equal(image_io.decode_image_plain(data), want)


def _stat(stats, name: str) -> int:
    return int(stats[avif.STAT_NAMES.index(name)])


# --- film grain --------------------------------------------------------------


@pytest.mark.parametrize("vector", range(1, 17))
def test_film_grain_test_vectors_equal_libaom_and_cv2(vector):
    """libaom's 16 test vectors (`film-grain-test`) on odd-sided stills
    at each depth and subsampling, at full or limited range (where the
    grain of the vectors that clip clips to it: 5 here)."""
    depth = (8, 10, 12)[vector % 3]
    fmt = FORMATS[vector % 4]
    full = int(vector % 5 != 0)
    h, w = 17 + 2 * vector, 61 - 2 * vector
    data = ar.avif_encode(_picture(h, w, vector, depth, fmt, full_range=full),
                          depth, fmt, quality=30 + 3 * vector, speed=8,
                          full_range=full, film_grain_test=vector)
    frame = avif.read_image(data).frame
    g = frame.header.grain
    assert g is not None
    if full:  # libaom's encoder clips only at limited range
        assert g.clip_to_restricted_range == 0
    stats = _equal_libaom(ar.primary_obus(data), frame)
    assert _stat(stats, "grain_frames") == 1
    _equal_cv2(data)


def _grain_cases():
    """(seed, depth, avifPixelFormat, matrix): the drawn parameters'
    frames, the identity matrix at 4:4:4 among them."""
    out = []
    for i in range(12):
        fmt = FORMATS[i % 4]
        out.append((i, (8, 10, 12)[i % 3], fmt,
                    0 if fmt == ar.YUV444 and i % 3 == 1 else 6))
    return out


@pytest.mark.parametrize("seed,depth,fmt,matrix", _grain_cases())
def test_drawn_grain_parameters_equal_libaom_and_cv2(seed, depth, fmt,
                                                     matrix):
    """Seeded parameters libaom accepts (`draw_grain`: each lag, no luma
    points, chroma scaling from luma, every shift, overlap and clip)
    written into a still's frame header: the grain templates, the
    scaling, the blocks and their overlap equal libaom's output, and cv2
    reads the file to the port's pixels."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    planes = _picture(h, w, seed, depth, fmt)
    data = ar.avif_encode(planes, depth, fmt, quality=40, speed=9,
                          matrix=matrix)
    mono = fmt == ar.YUV400
    g = ar.draw_grain(rng, lag=seed % 4, luma=seed % 5 != 3,
                      csfl=False if mono else None,
                      chroma=not mono and (fmt != ar.YUV420 or seed % 5 != 3))
    if matrix == 0:  # the clip to luma's range on every plane
        g = dataclasses.replace(g, clip_to_restricted_range=1)
    obus = ar.rewrite_frame(ar.primary_obus(data), {"film_grain": 1},
                            {"grain": g})
    frame = avif.read_frame(obus)
    assert frame.header.grain == g
    _equal_libaom(obus, frame, plain=h * w <= 2500)
    _equal_cv2(ar.with_obus(data, obus), plain=h * w <= 2500)


def test_grain_c_and_plain_agree_on_seeded_planes():
    """The C pass (`av1_film_grain`) and the plain one (`av1.film_grain`)
    on seeded planes and parameters, at every depth and subsampling and
    at odd sides past one 32-row stripe and 32-column block."""
    rng = np.random.default_rng(7)
    for i in range(8):
        bd = (8, 10, 12)[i % 3]
        ssx, ssy = ((1, 1), (0, 0), (1, 0), (1, 1))[i % 4]
        mono = i % 4 == 3
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        dtype = np.uint8 if bd == 8 else np.uint16
        y = rng.integers(0, 1 << bd, (h, w)).astype(dtype)
        cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
        u = None if mono else rng.integers(0, 1 << bd, (ch, cw)).astype(dtype)
        v = None if mono else rng.integers(0, 1 << bd, (ch, cw)).astype(dtype)
        g = ar.draw_grain(rng, chroma=not mono)
        want = av1.film_grain(g, y, u, v, bd, ssx, ssy, i % 2)
        yc = y.copy()
        uc = np.zeros((ch, cw), dtype) if mono else u.copy()
        vc = np.zeros((ch, cw), dtype) if mono else v.copy()
        stats = np.zeros(avif.NSTATS, np.int32)
        plan = avif.grain_plan(g, i % 2)
        i32p = ctypes.POINTER(ctypes.c_int32)
        assert avif.library().av1_film_grain(
            plan.ctypes.data_as(i32p), yc.ctypes.data, uc.ctypes.data,
            vc.ctypes.data, w, h, ssx, ssy, int(mono), bd,
            stats.ctypes.data_as(i32p)) == 0
        assert np.array_equal(yc, want[0])
        if not mono:
            assert np.array_equal(uc, want[1]) and np.array_equal(vc,
                                                                  want[2])


@pytest.mark.parametrize("form", ["grid", "sequence", "table_444"])
def test_grain_table_files_equal_cv2(form, tmp_path):
    """`film-grain-table` through libavif's options: a grid (each cell's
    grain from its own stream, stitched after), a 3-frame sequence (the
    first frame's grain) and a 10-bit 4:4:4 still without luma points."""
    rng = np.random.default_rng(len(form))
    if form == "table_444":
        g = ar.draw_grain(rng, lag=3, luma=False)
        table = ar.grain_table(tmp_path / "g.tbl", g)
        data = ar.avif_encode(_picture(37, 29, 5, 10, ar.YUV444), 10,
                              ar.YUV444, quality=50, speed=8,
                              film_grain_table=table)
    elif form == "grid":
        g = ar.draw_grain(rng, lag=1, csfl=True)
        table = ar.grain_table(tmp_path / "g.tbl", g)
        cells = [_picture(64, 66, k, 8, ar.YUV422) for k in range(2)]
        data = ar.avif_grid(cells, 2, 1, 8, ar.YUV422, quality=50, speed=9,
                            film_grain_table=table)
        assert len(avif.read_image(data).cells) == 2
    else:
        g = ar.draw_grain(rng, lag=2, luma=True)
        table = ar.grain_table(tmp_path / "g.tbl", g)
        frames = [_picture(23, 41, k, 12, ar.YUV420) for k in range(3)]
        data = ar.avif_sequence(frames, 12, ar.YUV420, quality=50, speed=9,
                                film_grain_table=table)
        assert avif.read_image(data).form == "sequence"
        frame = avif.read_image(data).frame
        _equal_libaom(ar.sequence_obus(data), frame)
    got = avif.read_image(data).frame.header.grain
    assert got is not None and got.seed == g.seed
    assert (got.ar_coeff_lag, got.y_points) == (g.ar_coeff_lag, g.y_points)
    _equal_cv2(data)


def _refused_as_libaom(obus: bytes, data: bytes, name: str) -> None:
    with pytest.raises(RuntimeError):
        ar.aom_planes(obus)
    edited = ar.with_obus(data, obus)
    assert ar.imdecode_rgb(edited) is None
    with pytest.raises(ValueError, match=name):
        image_io.decode_image(edited)
    with pytest.raises(ValueError, match=name):
        image_io.decode_image_plain(edited)


@pytest.mark.parametrize("what", ["15_luma_points", "11_cb_points",
                                  "points_not_increasing", "one_chroma_plane"])
def test_grain_parameters_libaom_refuses_are_refused_by_name(what):
    """The checks of libaom's read_film_grain_params: at most 14 luma and
    10 chroma points, each point's value above the last, and in 4:2:0
    grain on both chroma planes or neither."""
    fmt = ar.YUV420 if what == "one_chroma_plane" else ar.YUV444
    data = ar.avif_encode(_picture(20, 24, 1, 8, fmt), 8, fmt, quality=50,
                          speed=9)
    g = ar.draw_grain(np.random.default_rng(3), lag=1, luma=True, csfl=False)
    g = dataclasses.replace(g, cb_points=((10, 20), (90, 40)),
                            cr_points=((30, 50),))
    n = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1) + 1
    g = dataclasses.replace(g, ar_cb=(1,) * n, ar_cr=(2,) * n)
    name = {"15_luma_points": "15 luma scaling points",
            "11_cb_points": "11 Cb scaling points",
            "points_not_increasing": "do not increase",
            "one_chroma_plane": "one chroma plane"}[what]
    if what == "15_luma_points":
        g = dataclasses.replace(g, y_points=tuple((8 * i, i)
                                                  for i in range(15)))
    elif what == "11_cb_points":
        g = dataclasses.replace(g, cb_points=tuple((9 * i, i)
                                                   for i in range(11)))
    elif what == "points_not_increasing":
        g = dataclasses.replace(g, y_points=((40, 1), (40, 2)))
    else:
        g = dataclasses.replace(g, cr_points=())
    obus = ar.rewrite_frame(ar.primary_obus(data), {"film_grain": 1},
                            {"grain": g})
    _refused_as_libaom(obus, data, name)


def test_encoder_stream_libaom_cannot_read_is_refused(tmp_path):
    """A grain table with chroma points but none for luma on a 4:2:0
    frame: libaom's encoder writes the chroma fields its decoder does not
    read there, so the header's fields shift and the tile fails libaom's
    checks; cv2 returns no image, and the port refuses."""
    g = ar.draw_grain(np.random.default_rng(3), lag=0, luma=False,
                      csfl=False)
    g = dataclasses.replace(g, cb_points=((10, 20), (90, 40)),
                            cr_points=((30, 50),), ar_cb=(3,), ar_cr=(4,))
    data = ar.avif_encode(_picture(40, 56, 1, 8, ar.YUV420), 8, ar.YUV420,
                          quality=60, speed=6,
                          film_grain_table=ar.grain_table(tmp_path / "g.tbl",
                                                          g))
    assert ar.imdecode_rgb(data) is None
    with pytest.raises(RuntimeError):
        ar.aom_planes(ar.primary_obus(data))
    with pytest.raises(ValueError, match="AV1: a tile"):
        image_io.decode_image(data)


# --- segmentation ------------------------------------------------------------


@pytest.mark.parametrize("i", range(8))
def test_aq_mode_sequences_equal_libaom_and_cv2(i):
    """`aq-mode=1` sequences (libaom's good-quality usage segments their
    first frame, SEG_LVL_ALT_Q on every segment) at each depth and
    subsampling and at drawn qualities up to 99 (the encoder refuses
    aq-mode at 100), one with film grain too."""
    rng = np.random.default_rng(100 + i)
    depth, fmt = (8, 10, 12)[i % 3], FORMATS[i % 4]
    h, w = (int(v) for v in rng.integers(9, 56, 2))
    quality = 99 if i == 7 else int(rng.integers(0, 99))
    frames = [_picture(h, w, 10 * i + k, depth, fmt, noise=20)
              for k in range(2)]
    opts = {"film_grain_test": 4} if i == 5 else {}
    data = ar.avif_sequence(frames, depth, fmt, quality=quality,
                            speed=int(rng.integers(0, 7)), aq_mode=1, **opts)
    frame = avif.read_image(data).frame
    assert frame.header.segmentation == 1
    stats = _equal_libaom(ar.sequence_obus(data), frame)
    assert _stat(stats, "segmented_frames") == 1
    assert _stat(stats, "seg_feature_alt_q") == _stat(stats, "blocks")
    _equal_cv2(data)


def test_alt_q_and_alt_lf_rewritten_on_a_segmented_frame_equal_libaom():
    """A segmented frame's segment data rewritten (the tile as it was):
    other qindex offsets for SEG_LVL_ALT_Q (none reaching 0, where the
    syntax would change) and SEG_LVL_ALT_LF_* on every segment, which
    libaom's encoder never sets: the per-block dequantisation and the
    per-segment deblocking levels."""
    frames = [_picture(40, 48, k, 8, ar.YUV420, noise=20) for k in range(2)]
    data = ar.avif_sequence(frames, 8, ar.YUV420, quality=40, speed=6,
                            aq_mode=1)
    obus = ar.sequence_obus(data)
    h = avif.read_frame(obus).header
    rng = np.random.default_rng(4)
    mask = tuple(m | 0b11110 for m in h.seg_mask)
    seg = tuple((max(d[0] + int(rng.integers(-8, 9)), 1 - h.base_q),)
                + tuple(int(v) for v in rng.integers(-20, 21, 4)) + d[5:]
                for d in h.seg_data)
    new = ar.rewrite_frame(obus, {}, {"seg_mask": mask, "seg_data": seg,
                                      "lf_level": (8, 12, 6, 4)})
    frame = avif.read_frame(new)
    stats = _equal_libaom(new, frame)
    for j in ("alt_lf_y_v", "alt_lf_y_h", "alt_lf_u", "alt_lf_v"):
        assert _stat(stats, f"seg_feature_{j}") > 0


def _lossless_obus(h: int, w: int, seed: int, depth: int, fmt: int):
    data = ar.avif_encode(_picture(h, w, seed, depth, fmt, noise=0), depth,
                          fmt, quality=100, speed=6)
    return data, ar.primary_obus(data)


def _segments(*features) -> dict:
    """FrameHeader fields of segments 0.. with the given {feature: value}
    (SEG_LVL_ALT_Q at -255 added to each: qindex 0, lossless)."""
    mask, data = [0] * 8, [[0] * 8 for _ in range(8)]
    for i, f in enumerate(features):
        f = {0: -255, **f}
        for j, v in f.items():
            mask[i] |= 1 << j
            data[i][j] = v
    return {"segmentation": 1, "seg_mask": tuple(mask),
            "seg_data": tuple(map(tuple, data)),
            "seg_last_active": len(features) - 1,
            "seg_preskip": int(any(j >= 5 for f in features for j in f))}


LOSSY = {"base_q": 12, "lf_level": (10, 20, 5, 7), "lf_sharpness": 2,
         "cdef_bits": 0, "cdef_damping": 4, "cdef_y": ((5, 2),),
         "cdef_uv": ((3, 1),), "lr_type": (0, 0, 0), "tx_mode_select": 1}


@pytest.mark.parametrize("depth,fmt,variant", [
    (8, ar.YUV444, "skip_segment"), (10, ar.YUV400, "predicted"),
    (12, ar.YUV444, "skip_segment"), (8, ar.YUV444, "predicted")])
def test_lossless_segments_in_a_lossy_frame_equal_libaom_and_cv2(
        depth, fmt, variant):
    """Segments whose qindex clamps to 0 (base 12, SEG_LVL_ALT_Q -255) in
    a frame that is not lossless (segments 2..7 are not): the
    Walsh-Hadamard transform per block, deblocked and CDEF-filtered with
    per-segment levels (SEG_LVL_ALT_LF_*); with SegIdPreSkip (a segment
    with SEG_LVL_SKIP, SEG_LVL_REF_FRAME, SEG_LVL_GLOBALMV) the ids read
    before the skip flag, else skipped blocks taking the predicted id."""
    data, obus = _lossless_obus(48 + depth, 70 - depth, depth, depth, fmt)
    if variant == "skip_segment":
        changes = dict(LOSSY, **_segments({1: 9, 5: 3}, {6: 0, 3: -5, 7: 0},
                                          {}))
        new = ar.recode_segmented(
            obus, changes, skip_segment=1,
            skip_block=lambda r, c: (7 * r + 3 * c) % 5 == 0,
            segment_of=lambda r, c: 2 * ((r + c) % 3 == 0),
            seq_changes={"cdef": 1})
    else:
        changes = dict(LOSSY, **_segments({4: 11}, {2: -7}))
        new = ar.recode_segmented(
            obus, changes, segment_of=lambda r, c: (r // 2 + c // 4) % 2,
            skip_block=lambda r, c: (r + c) % 3 == 1,
            seq_changes={"cdef": 1})
    frame = avif.read_frame(new)
    h = frame.header
    assert not h.lossless and h.seg_lossless[:2] == (1, 1)
    assert h.seg_qindex[0] == 0 and h.seg_qindex[7] == 12
    stats = _equal_libaom(new, frame)
    assert _stat(stats, "lossless_segment_blocks") == _stat(stats, "blocks")
    assert _stat(stats, "lf_edges") > 0 and _stat(stats, "cdef_blocks") > 0
    if variant == "skip_segment":
        assert _stat(stats, "seg_feature_skip") > 0
        assert _stat(stats, "seg_feature_globalmv") > 0
        assert _stat(stats, "seg_feature_ref_frame") > 0
    else:
        assert _stat(stats, "seg_id_predicted") > 0
    _equal_cv2(ar.with_obus(data, new))


def test_segment_id_past_the_last_active_is_refused_by_name():
    """A coded segment id past LastActiveSegId: libaom reports the frame
    corrupt ("Corrupted segment_ids") and cv2 returns no image; the port
    refuses it."""
    data, obus = _lossless_obus(32, 40, 2, 8, ar.YUV444)
    changes = dict(LOSSY, **_segments({}, {}))
    new = ar.recode_segmented(obus, changes,
                              segment_of=lambda r, c: 3 if r + c > 6 else 0)
    _refused_as_libaom(new, data, "segment id past the last active")


def test_tools_search_slice_finds_no_difference():
    """The first 20 cases of tools/avif_search.py --forms tools."""
    result = avif_search.search_tools(avif_search.tool_cases(20, 0))
    assert result["cases"] == 20
    assert result["differences"] == []
    assert result["tools"]["grain_frames"] > 0
    assert result["tools"]["segmented_frames"] > 0
