"""Block smoothing of progressive JPEGs at every sampling factor, and
files cut anywhere in their last scan, against cv2 5.0 (libjpeg-turbo
3.1). Smoothing (jdcoefct.c decompress_smooth_data) clamps its 5x5 block
neighbourhood with a row number of its own, which in a partial last iMCU
row is not the block's: each component's SOF sampling byte is set to
every h, v in 1..4 (`image_samples.sampling_recipes`) on the two
block-smoothed fixtures (96 cases), on the progressive fixtures that do
not smooth, and on progressive 4:2:0 files with restart intervals written
by libjpeg-turbo itself, whole, ended after each scan and cut; the C
decoder (`decode_image`, `read_image`) equals cv2 bit for bit in each.
Cuts: a file cut inside its last SOS segment is filled by cv2.imread's
source with FF D9 over and over, and where the segment ends on an FF the
scan starts on the D9, a data byte; cv2.imdecode refuses a file whose
data ends early exactly where libjpeg-turbo's own bit buffer asks for a
byte past the end, which a file without its EOI may never do;
`tools/jpeg_cut_search.py` searches every cut of every fixture's last
scan and the timing photo's around its 4096-byte refills, here on a
seeded subset.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from multiposenet_tpu_torch.tools import image_samples as samples
from multiposenet_tpu_torch.tools import jpeg_cut_search
from multiposenet_tpu_torch.utils import image_io

from make_image_fixtures import libjpeg_jpeg, until_scan
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
SMOOTHED = ("c3_smooth_dc_40x48_420.jpg", "c3_smooth_ac1_40x48_420.jpg")
NOT_SMOOTHED = ("c3_progressive_48x64_420_q95_rst2.jpg",
                "c3_progressive_48x64_gray_q50.jpg",
                "c3_truncated_progressive_48x64_444.jpg",
                "c3_arith_progressive_32x32_444_rst.jpg")
# The sampling bytes that read otherwise than cv2 before the row clamp
# followed libjpeg-turbo's numbering: (file, component, byte).
WERE_OFF = [(SMOOTHED[0], 0, 0x13), (SMOOTHED[0], 0, 0x14),
            (SMOOTHED[0], 0, 0x23), (SMOOTHED[0], 0, 0x24),
            (SMOOTHED[0], 1, 0x14), (SMOOTHED[0], 2, 0x14),
            (SMOOTHED[1], 0, 0x13), (SMOOTHED[1], 0, 0x14),
            (SMOOTHED[1], 0, 0x23), (SMOOTHED[1], 1, 0x14),
            (SMOOTHED[1], 2, 0x14)]


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
    """`decode_image` against cv2.imdecode and `read_image` against
    cv2.imread on `data`; cv2.imread's decode."""
    assert _same(_outcome(image_io.decode_image, data), _cv2(data))
    want = _cv2(data, path)
    assert _same(_outcome(image_io.read_image, path), want)
    return want


def _sweep(data: bytes, path: Path, component: int | None = None) -> int:
    """Every sampling recipe of `data` (of one component, or all) held to
    cv2; how many cv2 read."""
    recipes = samples.sampling_recipes(data)
    if component is not None:
        recipes = recipes[16 * component:16 * component + 16]
    return sum(_hold(samples.corrupted(data, r), path) is not None
               for r in recipes)


@pytest.mark.parametrize("component", range(3))
@pytest.mark.parametrize("name", SMOOTHED)
def test_smoothing_at_every_sampling_factor_matches_cv2(tmp_path, name,
                                                        component):
    data = (FIXTURES / name).read_bytes()
    assert _sweep(data, tmp_path / "x.jpg", component) >= 6


@pytest.mark.parametrize("name,component,byte", WERE_OFF)
def test_partial_last_imcu_rows_smooth_as_libjpeg_turbo(tmp_path, name,
                                                        component, byte):
    """A vertical factor of 3 or 4 leaves the last iMCU row partial."""
    data = (FIXTURES / name).read_bytes()
    recipe = samples.sampling_recipes(data)[16 * component
                                            + 4 * ((byte >> 4) - 1)
                                            + (byte & 15) - 1]
    assert recipe.endswith(f":{byte}")
    assert _hold(samples.corrupted(data, recipe),
                 tmp_path / "x.jpg").shape == (40, 48, 3)


@pytest.mark.parametrize("name", NOT_SMOOTHED)
def test_progressive_files_without_smoothing_at_every_sampling_factor(
        tmp_path, name):
    _sweep((FIXTURES / name).read_bytes(), tmp_path / "x.jpg")


@pytest.mark.parametrize("size", [(40, 48), (75, 61), (130, 37)])
def test_restart_intervals_at_every_sampling_factor_whole_ended_and_cut(
        tmp_path, size):
    """A progressive 4:2:0 file with a restart interval per MCU row, whole
    (no smoothing), ended after scans 1-3 and cut in its first and its
    last scan (smoothed with each scan's coefficient bits)."""
    rng = np.random.RandomState(size[0])
    img = np.clip(rng.normal(128, 60, (*size, 3)), 0, 255).astype(np.uint8)
    full = libjpeg_jpeg(img, progressive=True, quality=75, sampling=0x22,
                        restart_rows=1)
    sos = [i for i in range(len(full) - 1)
           if full[i] == 0xFF and full[i + 1] == 0xDA]
    variants = [full, *(until_scan(full, k) for k in (1, 2, 3)),
                full[:sos[1] - 20],
                full[:(sos[-1] + len(full)) // 2]]
    for data in variants:
        _sweep(data, tmp_path / "x.jpg")


@pytest.mark.parametrize("name", SMOOTHED)
def test_committed_sampling_digests_equal_cv2_and_the_port(name):
    data = (FIXTURES / name).read_bytes()
    cases = [samples.corrupted(data, r)
             for r in samples.sampling_recipes(data)]
    want = samples.outcomes_sha256([samples.outcome(_cv2(d)) for d in cases])
    got = samples.outcomes_sha256([
        samples.outcome(_outcome(image_io.decode_image, d)) for d in cases])
    assert want == got == DIGESTS[name]["sampling_sha256"]


@pytest.mark.parametrize("name", [
    "kind_tex_3x3_420_q95.jpg", "kind_noise_37x53_420_q95.jpg",
    "kind_tex_97x133_420_q95_rst3.jpg", "c3_progressive_48x64_gray_q50.jpg",
    "c3_smooth_dc_40x48_420.jpg", "c3_arith_32x32_420.jpg",
    "c3_arith_progressive_32x32_444_rst.jpg", "c3_lossless_p1_24x24.jpg"])
def test_cuts_inside_the_last_sos_segment_match_cv2_imread(tmp_path, name):
    """Every cut from the last SOS marker to two bytes into its data:
    where the cut leaves the segment ending on an FF of the fill, the
    scan's first byte is the fill's D9 (read_image and the plain decoder
    with eof_fill); decode_image is held to cv2.imdecode."""
    data = (FIXTURES / name).read_bytes()
    sos = data.rindex(b"\xff\xda")
    end = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big") + 2
    path = tmp_path / "x.jpg"
    plain = jpeg_cut_search.plain_reads(data)
    read = 0
    for cut in range(sos, end + 1):
        part = data[:cut]
        want = _hold(part, path)
        read += want is not None
        if plain:
            assert _same(_outcome(image_io.decode_image_plain, part, "x",
                                  True), want)
    assert read >= 3


def test_files_without_their_eoi_read_as_cv2_imdecode_reads_them():
    """cv2.imdecode's source suspends where libjpeg-turbo's own bit buffer
    asks for a byte past the end, which refuses the stream; a file whose
    data ends without its EOI reads where the last MCU needed none (its
    fast path reads 6 bytes at a time while 512 bytes a block are left,
    its slow path tops up to 57 bits where a code finds too few). Seeded
    cv2 JPEGs up to 120x120 (restart intervals, every sampling) without
    the last byte or two: the C decoder and, up to 64x64, the plain one
    read or refuse as cv2.imdecode does."""
    rng = np.random.RandomState(21)
    reads = 0
    for _ in range(200):
        h, w = rng.randint(8, 121, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        if rng.rand() < 0.5:
            img = cv2.GaussianBlur(img, (0, 0), rng.uniform(0.5, 3))
        params = [cv2.IMWRITE_JPEG_QUALITY,
                  int(rng.choice([50, 75, 90, 95, 100]))]
        if rng.rand() < 0.3:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, int(rng.randint(1, 8))]
        if rng.rand() < 0.5:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, int(rng.choice(
                [0x411111, 0x211111, 0x221111, 0x121111, 0x111111]))]
        data = cv2.imencode(".jpg", img, params)[1].tobytes()
        for k in (1, 2):
            part = data[:-k]
            want = _cv2(part)
            reads += want is not None
            assert _same(_outcome(image_io.decode_image, part), want)
            if h * w <= 64 * 64:
                assert _same(_outcome(image_io.decode_image_plain, part),
                             want)
    assert reads >= 6


def test_seeded_cuts_of_every_mode_match_cv2():
    """`jpeg_cut_search` on 6 cuts of each file (the photo's near its
    4096-byte refills): no reader differs from cv2."""
    cases = jpeg_cut_search.cut_cases(seed=0, per_file=6)
    result = jpeg_cut_search.search(cases)
    assert set(result["modes"]) == set(jpeg_cut_search.MODES)
    assert result["differences"] == 0, result["modes"]
