"""The port's training augmentation and batch loader
(`multiposenet_tpu_torch/data/augment.py`, `data/loader.py`) against the
JAX package's and cv2: RGB -> HSV and HSV -> RGB equal cv2.cvtColor on
every uint8 input (HSV -> RGB both in OpenCV's vector code, which takes a
row's first multiple of 32 pixels, and in its scalar code, which takes
the rest), the colour jitter in the host C library against its NumPy
version, and every augmentation, `make_batch` and the first batches of
`batch_iterator` equal the JAX package's bit for bit from the same seeds,
with segmentation masks too."""

import cv2
import numpy as np
import pytest

from multiposenet_tpu.data import augment as ja
from multiposenet_tpu.data import loader as jloader
from multiposenet_tpu.data.synthetic import make_dataset
from multiposenet_tpu_torch.data import augment as ta
from multiposenet_tpu_torch.data import loader as tloader
from multiposenet_tpu_torch.utils import avif

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def records():
    return make_dataset(8, img_h=96, img_w=80, seed=0)


def _all_rgb() -> np.ndarray:
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8)


def test_rgb_to_hsv_equals_cv2_on_every_input():
    rgb = _all_rgb().reshape(4096, 4096, 3)
    np.testing.assert_array_equal(ta.rgb_to_hsv(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


def test_rgb_to_hsv_equals_cv2_one_pixel_a_row():
    rgb = _all_rgb()[::7].reshape(-1, 1, 3)
    np.testing.assert_array_equal(ta.rgb_to_hsv(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


def _all_hsv() -> np.ndarray:
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                          indexing="ij")
    return np.stack([h, s, v], -1).astype(np.uint8)


@pytest.mark.parametrize("width", [256, 1], ids=["vector", "scalar"])
def test_hsv_to_rgb_equals_cv2_on_every_input(width):
    hsv = _all_hsv().reshape(-1, width, 3)
    np.testing.assert_array_equal(ta.hsv_to_rgb(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_hsv_to_rgb_rows_split_at_multiples_of_32():
    rng = np.random.RandomState(0)
    for w in [*range(1, 70), 95, 96, 97, 255, 640]:
        hsv = np.stack([rng.randint(0, 180, (3, w)),
                        rng.randint(0, 256, (3, w)),
                        rng.randint(0, 256, (3, w))], -1).astype(np.uint8)
        np.testing.assert_array_equal(
            ta.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB),
            err_msg=str(w))


def _assert_same(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("index", range(4))
def test_hflip(records, index):
    r = records[index]
    _assert_same(ta.hflip(r["image"], r["keypoints"], r["boxes"]),
                 ja.hflip(r["image"], r["keypoints"], r["boxes"]))


@pytest.mark.parametrize("seed", range(4))
def test_random_crop(records, seed):
    r = records[seed]
    _assert_same(
        ta.random_crop(np.random.RandomState(seed), r["image"],
                       r["keypoints"], r["boxes"]),
        ja.random_crop(np.random.RandomState(seed), r["image"],
                       r["keypoints"], r["boxes"]))


@pytest.mark.parametrize("seed", range(6))
def test_color_jitter(records, seed):
    image = records[seed]["image"][seed:, 2 * seed:]
    got = ta.color_jitter(np.random.RandomState(seed), image)
    want = ja.color_jitter(np.random.RandomState(seed), image)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("factors", [
    (1.0, 0.0, 0.0, 1.0), (0.75, -0.25, -0.05, 0.75),
    (1.25, 0.25, 0.05, 1.25), (0.9, 0.1, -0.03, 1.2), (1.1, -0.1, None, None),
    "drawn"])
def test_jitter_in_c_equals_its_plain_version(factors):
    """The host C jitter (`utils/image_codec.jitter_rgb`) against
    `augment.jitter_plain` on every RGB value in steps of 3 (rows of 600
    pixels: 576 in cv2's vector code, 24 in its scalar code), at the draws'
    extremes, without the HSV moves, and on 40 drawn factor sets and
    shapes."""
    v = np.arange(0, 256, 3)
    rgb = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
    rgb = np.concatenate([rgb, np.zeros((-len(rgb) % 600, 3), int)])
    cases = [(rgb.reshape(-1, 600, 3).astype(np.uint8), factors)]
    if factors == "drawn":
        rng = np.random.RandomState(5)
        cases = [(rng.randint(0, 256, (rng.randint(1, 20), w, 3)).astype(
            np.uint8), ta.jitter_factors(rng))
            for w in rng.choice([1, 31, 32, 33, 64, 97, 512], 40)]
    for image, f in cases:
        np.testing.assert_array_equal(ta.jitter(image, f),
                                      ta.jitter_plain(image, f))


@pytest.mark.parametrize("target", [64, 100, 128])
@pytest.mark.parametrize("mode", ["max_side", "min_side"])
def test_resize_to(records, mode, target):
    r = records[1]
    _assert_same(
        ta.resize_to(r["image"], r["keypoints"], r["boxes"], target,
                     mode=mode),
        ja.resize_to(r["image"], r["keypoints"], r["boxes"], target,
                     mode=mode))


def test_resize_to_refuses_an_unknown_mode(records):
    r = records[0]
    with pytest.raises(ValueError, match="unknown resize mode"):
        ta.resize_to(r["image"], r["keypoints"], r["boxes"], 64, mode="x")


@pytest.mark.parametrize("seed", range(8))
def test_augment_record(records, seed):
    r = records[seed]
    _assert_same(
        ta.augment_record(np.random.RandomState(seed), r["image"],
                          r["keypoints"], r["boxes"], 64),
        ja.augment_record(np.random.RandomState(seed), r["image"],
                          r["keypoints"], r["boxes"], 64))


@pytest.mark.parametrize("train", [True, False])
def test_make_batch(records, train):
    got = tloader.make_batch(records[:4], 64, 8, np.random.RandomState(1),
                             train=train)
    want = jloader.make_batch(records[:4], 64, 8, np.random.RandomState(1),
                              train=train)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_batch_iterator_first_batches(records, train):
    kw = dict(batch_size=3, image_size=64, max_persons=8, seed=5,
              train=train)
    got = tloader.batch_iterator(records, **kw)
    want = jloader.batch_iterator(records, **kw)
    for _ in range(3):
        g, w = next(got), next(want)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_batch_iterator_eval_pass_ends_with_a_padded_batch(records):
    batches = list(tloader.batch_iterator(records[:5], 2, 64, 8,
                                          train=False))
    assert len(batches) == 3
    np.testing.assert_array_equal(batches[2]["images"][0],
                                  batches[2]["images"][1])


def test_loader_reads_image_files(tmp_path, records):
    from multiposenet_tpu_torch.utils.image_io import write_png

    rec = dict(records[0])
    write_png(tmp_path / "a.png", rec.pop("image"))
    rec["file_name"] = "a.png"
    got = tloader.make_batch([rec], 64, 8, image_dir=str(tmp_path),
                             train=False)
    want = tloader.make_batch([records[0]], 64, 8, train=False)
    np.testing.assert_array_equal(got["images"], want["images"])


def _damaged_jpeg(rgb: np.ndarray, seed: int = 0) -> bytes:
    """cv2's JPEG of `rgb` with two bytes of its scan changed (seeded),
    the first such change cv2.imdecode still reads to other pixels."""
    data = cv2.imencode(".jpg", np.ascontiguousarray(rgb[:, :, ::-1]))[1]
    data = data.tobytes()
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    clean = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    rs = np.random.RandomState(seed)
    while True:
        out = bytearray(data)
        for _ in range(2):
            out[rs.randint(start, len(out) - 2)] = rs.randint(0, 255)
        got = cv2.imdecode(np.frombuffer(bytes(out), np.uint8),
                           cv2.IMREAD_COLOR)
        if got is not None and not np.array_equal(got, clean):
            return bytes(out)


@pytest.mark.parametrize("train", [True, False])
def test_make_batch_of_a_damaged_jpeg_matches_jax(tmp_path, records, train):
    """A record whose file is a JPEG with damaged scan bytes: the port's
    batch equals the JAX package's (which reads it with cv2.imread) with
    the same image_dir and seed."""
    recs = []
    for i, rec in enumerate(records[:2]):
        rec = dict(rec)
        (tmp_path / f"{i}.jpg").write_bytes(_damaged_jpeg(rec.pop("image"),
                                                          i))
        rec["file_name"] = f"{i}.jpg"
        recs.append(rec)
    got = tloader.make_batch(recs, 64, 8, np.random.RandomState(3),
                             image_dir=str(tmp_path), train=train)
    want = jloader.make_batch(recs, 64, 8, np.random.RandomState(3),
                              image_dir=str(tmp_path), train=train)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_make_batch_of_jpeg2000_records_matches_jax(tmp_path, records,
                                                     train):
    """Records whose files are JPEG 2000 (a reversible JP2 and an
    irreversible bare codestream): the port's batch equals the JAX
    package's (which reads them with cv2.imread) with the same image_dir
    and seed."""
    import io

    from PIL import Image

    recs = []
    for i, rec in enumerate(records[:2]):
        rec = dict(rec)
        name = f"{i}.jp2" if i == 0 else f"{i}.j2k"
        buf = io.BytesIO()
        Image.fromarray(rec.pop("image")).save(
            buf, "JPEG2000", irreversible=i == 1, no_jp2=i == 1)
        (tmp_path / name).write_bytes(buf.getvalue())
        rec["file_name"] = name
        recs.append(rec)
    got = tloader.make_batch(recs, 64, 8, np.random.RandomState(3),
                             image_dir=str(tmp_path), train=train)
    want = jloader.make_batch(recs, 64, 8, np.random.RandomState(3),
                              image_dir=str(tmp_path), train=train)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# Files other encoders write, as (depth, avifPixelFormat, matrix
# coefficients, full range): 4:2:2 limited-range BT.709, 10-bit 4:4:4
# BT.2020 and 4:2:0 limited-range FCC (libavif's float conversion).
OTHER_AVIF = ((8, 2, 1, 0), (10, 1, 9, 1), (8, 3, 4, 0))


@pytest.mark.parametrize("train,writer", [(True, "cv2"), (False, "cv2"),
                                          (True, "libavif"),
                                          (True, "container"),
                                          (True, "grain")],
                         ids=["True", "False", "True-libavif",
                              "True-container", "True-grain"])
def test_make_batch_of_avif_records_matches_jax(tmp_path, records, train,
                                                writer):
    """Records whose files are AVIF as cv2.imwrite writes them (one at
    its default quality, one at quality 30, one at 10 bits from uint16
    with seeded low bits), or as the wheel's libavif encoder writes them
    in other colour forms and subsamplings (OTHER_AVIF), or in the
    container forms (a grid of 2x2 cells of 64x64 cropped to the image
    with an Exif item of orientation 6, a 2-frame Pillow sequence, a
    still with an Exif item of orientation 8), or with libaom's film
    grain and segmentation (a `film-grain-test` still, an `aq-mode=1`
    sequence whose first frame is segmented, a 10-bit 4:4:4 still with
    `film-grain-test` 15, chroma scaled from luma): the port's batch
    equals the JAX package's (which reads them with cv2.imread) with the
    same image_dir and seed."""
    import cv2

    import avif_reference as ar

    recs = []
    for i, rec in enumerate(records[:3]):
        rec = dict(rec)
        name = f"{i}.avif"
        rgb = rec.pop("image")
        bgr = np.ascontiguousarray(rgb[:, :, ::-1])
        params = [] if i == 0 else [cv2.IMWRITE_AVIF_QUALITY, 30]
        if writer == "grain":
            if i == 1:
                data = ar.avif_sequence(
                    [ar.planes_of(x, 8, ar.YUV420) for x in (rgb, rgb[::-1])],
                    8, ar.YUV420, 50, 6, aq_mode=1)
                assert avif.read_image(data).frame.header.segmentation
            else:
                depth, fmt = ((8, ar.YUV420), None, (10, ar.YUV444))[i]
                px = rgb if depth == 8 else ar.widen(rgb, depth)
                data = ar.avif_encode(ar.planes_of(px, depth, fmt), depth,
                                      fmt, 50, 8,
                                      film_grain_test=(1, 0, 15)[i])
                assert avif.read_image(data).frame.header.grain
            (tmp_path / name).write_bytes(data)
        elif writer == "container":
            data = (ar.grid_from_rgb(rgb, 2, 2, 64, 64,
                                     exif=ar.tiff_orientation(6), speed=9),
                    ar.pillow_avis([rgb, rgb[::-1]]),
                    ar.avif_encode(ar.planes_of(rgb, 8, ar.YUV420), 8,
                                   ar.YUV420, speed=9,
                                   exif=ar.tiff_orientation(8)))[i]
            (tmp_path / name).write_bytes(data)
        elif writer == "libavif":
            depth, fmt, matrix, full = OTHER_AVIF[i]
            (tmp_path / name).write_bytes(ar.avif_encode(
                ar.planes_of(rgb, depth, fmt, matrix if matrix != 4 else 6,
                             full), depth, fmt, 50, 6, matrix=matrix,
                full_range=full, primaries=1, transfer=1))
        else:
            if i == 2:
                low = np.random.RandomState(i).randint(0, 4, bgr.shape)
                bgr = (bgr.astype(np.uint16) << 2) | low.astype(np.uint16)
                params = [cv2.IMWRITE_AVIF_DEPTH, 10]
            assert cv2.imwrite(str(tmp_path / name), bgr, params)
        rec["file_name"] = name
        recs.append(rec)
    got = tloader.make_batch(recs, 64, 8, np.random.RandomState(3),
                             image_dir=str(tmp_path), train=train)
    want = jloader.make_batch(recs, 64, 8, np.random.RandomState(3),
                              image_dir=str(tmp_path), train=train)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _masked(records, seed=0, drop=None):
    """Records with seeded segmentation masks (bool [H, W]); `drop` names
    a key left out (None) on the second record, the third has none."""
    rng = np.random.RandomState(seed)
    out = []
    for i, rec in enumerate(records):
        rec = dict(rec)
        h, w = rec["image"].shape[:2]
        if i != 2:
            rec["exclude_mask"] = rng.rand(h, w) > 0.7
            rec["person_mask"] = rng.rand(h, w) > 0.4
            if i == 1 and drop:
                rec[drop] = None
        out.append(rec)
    return out


@pytest.mark.parametrize("fn", ["hflip", "random_crop", "resize_max_side",
                                "resize_min_side", "augment_record"])
def test_masks_follow_the_image_as_in_jax(records, fn):
    """Every augmentation moves a [H, W, 2] float32 mask stack as the JAX
    package's does (cv2's float INTER_LINEAR in the resizes), bit for
    bit, from the same draws."""
    r = records[1]
    rng = np.random.RandomState(3)
    masks = (rng.rand(96, 80, 2) > 0.5).astype(np.float32)
    args = (r["image"], r["keypoints"], r["boxes"])
    calls = {
        "hflip": lambda m: m.hflip(*args, masks),
        "random_crop": lambda m: m.random_crop(np.random.RandomState(5),
                                               *args, masks),
        "resize_max_side": lambda m: m.resize_to(*args, 72, masks),
        "resize_min_side": lambda m: m.resize_to(*args, 72, masks,
                                                 mode="min_side"),
        "augment_record": lambda m: m.augment_record(
            np.random.RandomState(7), *args, 64, masks),
    }
    got, want = calls[fn](ta), calls[fn](ja)
    assert got[3] is not None and got[3].dtype == np.float32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size,stride,train,drop", [
    (64, 4, True, None), (64, 4, False, "person_mask"),
    (130, 4, True, "exclude_mask"), (96, 8, True, None)])
def test_make_batch_with_masks_equals_jax(records, size, stride, train,
                                          drop):
    """The coverage maps (float INTER_LINEAR through the augmentation,
    then INTER_AREA to the heatmap grid: an integer ratio at 64 and 96, a
    non-integer one at 130 → 32), `has_mask` (False for the record
    without masks, whose maps stay zero) and every other key equal the
    JAX package's `make_batch` bit for bit for one seed, augmentation on
    and off."""
    recs = _masked(records[:4], seed=size, drop=drop)
    got = tloader.make_batch(recs, size, 6, rng=np.random.RandomState(5),
                             train=train, mask_stride=stride)
    want = jloader.make_batch(recs, size, 6, rng=np.random.RandomState(5),
                              train=train, mask_stride=stride)
    assert sorted(got) == sorted(want)
    assert got["exclude_cov"].shape == (4, size // stride, size // stride)
    np.testing.assert_array_equal(got["has_mask"], [True, True, False, True])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_batch_iterator_with_masks_equals_jax(records):
    """The first batches of `batch_iterator` with mask_stride 8 on masked
    records, against the JAX package's."""
    recs = _masked(records)
    got = tloader.batch_iterator(recs, 3, 64, 6, seed=2, mask_stride=8)
    want = jloader.batch_iterator(recs, 3, 64, 6, seed=2, mask_stride=8)
    for _ in range(3):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
