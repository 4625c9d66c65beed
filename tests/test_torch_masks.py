"""The port's segmentation masks (`multiposenet_tpu_torch/data/masks.py`)
and the cv2 calls of the mask path (`utils/image_io.py`) against the JAX
package and cv2 5.0:

- the RLE hand cases of tests/test_masks.py, run through both packages;
- `fill_polygons` (the host C library) and `fill_polygons_plain` equal
  `cv2.fillPoly` bit for bit on a seeded fuzz of 600 polygon sets:
  several parts that overlap, self-intersections, points off the image,
  repeated points, parts of 1 and 2 points; and the even-odd trap of
  two overlapping squares;
- `region_masks` equals the JAX package's pixel for pixel on every image
  of tests/fixtures/images/annotations_segs.json;
- float32 INTER_LINEAR on two channels and INTER_AREA, C and plain,
  equal cv2.resize bit for bit on the loader's shapes and on seeded
  random shapes, up and down;
- gray PNG bytes round-trip as cv2 reads them.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from multiposenet_tpu.data import masks as jmasks
from multiposenet_tpu_torch.data import coco as tcoco
from multiposenet_tpu_torch.data import masks as tmasks
from multiposenet_tpu_torch.utils import image_io

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"


# --- RLE --------------------------------------------------------------------


@pytest.mark.parametrize("lib", [jmasks, tmasks], ids=["jax", "port"])
def test_uncompressed_rle_hand_case(lib):
    m = lib.rle_counts_to_mask([2, 3, 4, 3], 3, 4)
    want = np.array([0, 0, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1],
                    bool).reshape((3, 4), order="F")
    np.testing.assert_array_equal(m, want)


def test_rle_counts_roundtrip_and_equal_jax():
    rng = np.random.RandomState(0)
    for _ in range(5):
        mask = rng.rand(17, 23) > 0.6
        counts = tmasks.mask_to_rle_counts(mask)
        assert counts == jmasks.mask_to_rle_counts(mask)
        np.testing.assert_array_equal(
            tmasks.rle_counts_to_mask(counts, 17, 23), mask)
    assert tmasks.mask_to_rle_counts(np.ones((2, 2), bool)) == [0, 4]


def test_rle_counts_bad_total_raises():
    with pytest.raises(ValueError, match="counts sum"):
        tmasks.rle_counts_to_mask([2, 3], 3, 4)


def test_compressed_rle_string_hand_case():
    """rleToString of counts [6, 1, 40, 4, 5]: 6 → '6', 1 → '1', 40 →
    'X1' (two 5-bit groups, the first with the continuation bit), then
    deltas against counts[i - 2] from i = 3: 4 - 1 = 3 → '3', 5 - 40 =
    -35 → 'mN'."""
    counts = [6, 1, 40, 4, 5]
    s = tmasks.encode_rle_string(counts)
    assert s == jmasks.encode_rle_string(counts)
    assert s == "61X13mN"
    assert tmasks.decode_rle_string(s) == counts


def test_compressed_rle_string_roundtrip_random():
    rng = np.random.RandomState(1)
    for _ in range(10):
        counts = rng.randint(0, 5000, rng.randint(1, 30)).tolist()
        s = tmasks.encode_rle_string(counts)
        assert s == jmasks.encode_rle_string(counts)
        assert tmasks.decode_rle_string(s) == counts


def test_compressed_rle_mask_roundtrip():
    mask = np.random.RandomState(2).rand(31, 19) > 0.5
    seg = {"size": [31, 19],
           "counts": tmasks.encode_rle_string(tmasks.mask_to_rle_counts(mask))}
    np.testing.assert_array_equal(tmasks.annotation_mask(seg, 31, 19), mask)
    with pytest.raises(ValueError, match="RLE size"):
        tmasks.annotation_mask(seg, 19, 31)


def test_polygon_square_and_empty():
    seg = [[2.0, 3.0, 5.0, 3.0, 5.0, 6.0, 2.0, 6.0]]
    m = tmasks.polygons_to_mask(seg, 10, 10)
    assert m[4, 3] and m[3, 2] and m[6, 5]
    assert not m[0, 0] and not m[9, 9] and not m[2, 2] and not m[7, 5]
    np.testing.assert_array_equal(m, jmasks.polygons_to_mask(seg, 10, 10))
    assert tmasks.annotation_mask(None, 4, 4) is None
    assert tmasks.annotation_mask([], 4, 4) is None
    # Parts under 6 numbers are dropped, as the JAX package drops them.
    assert not tmasks.polygons_to_mask([[1, 1, 3, 3]], 5, 5).any()


# --- cv2.fillPoly -------------------------------------------------------------


@pytest.mark.parametrize("fill", ["c", "plain"])
def test_overlapping_parts_leave_the_overlap_empty(fill):
    """One call with two overlapping squares: cv2 fills even-odd across
    the parts, so the overlap's interior stays 0 and its edges are drawn
    (a union of per-part fills would be wrong)."""
    sq = np.array([[1, 1], [6, 1], [6, 6], [1, 6]], np.int32)
    parts = [sq, sq + 2]
    want = np.zeros((10, 10), np.uint8)
    cv2.fillPoly(want, parts, 1)
    got = np.zeros((10, 10), np.uint8)
    (tmasks.fill_polygons if fill == "c"
     else tmasks.fill_polygons_plain)(got, parts, 1)
    np.testing.assert_array_equal(got, want)
    assert got[4:6, 4:6].sum() == 0 and got[3, 4] == 1 and got[6, 4] == 1


def _polygon_sets(n: int, seed: int):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        h, w = (int(v) for v in rng.randint(1, 48, 2))
        parts = []
        for _ in range(rng.randint(1, 5)):
            k = rng.randint(1, 12)
            span = int(rng.choice([0, 6, 40]))
            pts = np.stack([rng.randint(-span, w + span + 1, k),
                            rng.randint(-span, h + span + 1, k)], 1)
            if k > 2 and rng.rand() < 0.3:
                pts[rng.randint(k)] = pts[rng.randint(k)]
            parts.append(pts.astype(np.int32))
        yield h, w, parts


@pytest.mark.parametrize("seed", range(4))
def test_fill_polygons_equals_cv2_fuzz(seed):
    """150 seeded polygon sets a seed, 600 in all, each filled in one
    call by cv2, the C library and the plain version."""
    for h, w, parts in _polygon_sets(150, seed):
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, parts, 1)
        got = np.zeros((h, w), np.uint8)
        tmasks.fill_polygons(got, parts, 1)
        plain = np.zeros((h, w), np.uint8)
        tmasks.fill_polygons_plain(plain, parts, 1)
        np.testing.assert_array_equal(got, want, err_msg=repr(parts))
        np.testing.assert_array_equal(plain, want, err_msg=repr(parts))


def test_polygons_to_mask_equals_jax_on_coco_sized_polygons():
    """Float COCO polygons of 60 points on 480x640 (rounded half to even
    before the fill in both packages)."""
    rng = np.random.RandomState(4)
    for _ in range(10):
        t = np.sort(rng.rand(60)) * 2 * np.pi
        r = 150 * (0.6 + 0.4 * rng.rand(60))
        poly = np.stack([320 + r * np.cos(t), 240 + r * np.sin(t)], 1)
        parts = [poly.reshape(-1).tolist(),
                 (poly[::3] + 40.5).reshape(-1).tolist()]
        np.testing.assert_array_equal(
            tmasks.polygons_to_mask(parts, 480, 640),
            jmasks.polygons_to_mask(parts, 480, 640))


def test_region_masks_equal_jax_on_the_segmentation_fixture():
    """Every image of annotations_segs.json: overlapping multi-part
    polygons, both RLE forms, crowd regions, a person with no labelled
    keypoint and persons with no segmentation (their boxes)."""
    data = json.loads((FIXTURES / "annotations_segs.json").read_text())
    kinds = {type(a.get("segmentation")).__name__
             for a in data["annotations"]}
    assert kinds == {"list", "dict", "NoneType"}
    assert any(a["iscrowd"] for a in data["annotations"])
    records = tcoco.load_coco_keypoints(FIXTURES / "annotations_segs.json")
    excluded = 0
    for r in records:
        args = (r["segmentation"], r["iscrowd"], r["keypoints"], r["boxes"],
                r["height"], r["width"])
        got, want = tmasks.region_masks(*args), jmasks.region_masks(*args)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].any()
        excluded += got[0].any()
    assert excluded == 3  # the two crowds and the unlabelled person


# --- the mask path's resizes and PNGs ------------------------------------


def _resizes(kind):
    if kind == "linear":
        return (image_io.resize_linear, image_io.resize_linear_plain,
                cv2.INTER_LINEAR)
    return image_io.resize_area, image_io.resize_area_plain, cv2.INTER_AREA


@pytest.mark.parametrize("kind,src,dst", [
    ("linear", (480, 640), (750, 1000)), ("linear", (480, 640), (240, 320)),
    ("linear", (97, 133), (512, 512)), ("linear", (640, 480), (130, 98)),
    ("area", (512, 512), (128, 128)), ("area", (130, 130), (32, 32)),
    ("area", (96, 96), (12, 12)), ("area", (64, 64), (32, 32))])
def test_float_resizes_equal_cv2_on_the_loaders_shapes(kind, src, dst):
    """[H, W, 2] float32: random values and 0/1 masks; the halving case
    of INTER_LINEAR is cv2's INTER_AREA; INTER_AREA at an integer ratio
    (512 → 128) and not (130 → 32)."""
    fn, plain, interp = _resizes(kind)
    rng = np.random.RandomState(src[0] + dst[0])
    for x in (rng.rand(*src, 2).astype(np.float32),
              (rng.rand(*src, 2) > 0.5).astype(np.float32)):
        want = cv2.resize(x, dst[::-1], interpolation=interp)
        np.testing.assert_array_equal(fn(x, dst[::-1]), want)
        np.testing.assert_array_equal(plain(x, dst[::-1]), want)


@pytest.mark.parametrize("kind", ["linear", "area"])
def test_float_resizes_equal_cv2_on_random_shapes(kind):
    """200 seeded shapes, up and down for INTER_LINEAR (two channels),
    down for INTER_AREA (one, two and three channels), some at integer
    ratios."""
    fn, plain, interp = _resizes(kind)
    rng = np.random.RandomState(0 if kind == "linear" else 1)
    done = 0
    while done < 200:
        sh, sw = (int(v) for v in rng.randint(1, 90, 2))
        if kind == "linear":
            dh, dw = (int(v) for v in rng.randint(1, 180, 2))
            cn = 2
        else:
            dh, dw = int(rng.randint(1, sh + 1)), int(rng.randint(1, sw + 1))
            if rng.rand() < 0.25:
                k = int(rng.randint(3, 6))
                dh, dw = max(sh // k, 1), max(sw // k, 1)
                sh, sw = dh * k, dw * k
            cn = int(rng.choice([1, 2, 3]))
        if (sh, sw) == (2 * dh, 2 * dw) and cn != 2:
            continue  # cv2's vector code: refused (see below)
        x = (rng.rand(sh, sw, cn) * rng.choice([1.0, 255.0])).astype(
            np.float32)
        want = cv2.resize(x, (dw, dh), interpolation=interp)
        want = want.reshape(dh, dw, cn)
        np.testing.assert_array_equal(fn(x, (dw, dh)), want)
        np.testing.assert_array_equal(plain(x, (dw, dh)), want)
        done += 1


def test_area_refuses_what_it_does_not_reproduce():
    x = np.zeros((8, 8, 1), np.float32)
    with pytest.raises(ValueError, match="vector code"):
        image_io.resize_area(x, (4, 4))
    with pytest.raises(ValueError, match="shrinks only"):
        image_io.resize_area(x, (16, 16))


def test_gray_png_roundtrip_as_cv2_reads_it():
    rng = np.random.RandomState(5)
    mask = rng.rand(37, 45) > 0.5
    data = image_io.encode_png(mask.astype(np.uint8) * 255)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(image_io.decode_gray_png(data), want)
    ok, buf = cv2.imencode(".png", mask.astype(np.uint8) * 255)
    np.testing.assert_array_equal(
        image_io.decode_gray_png(buf.tobytes()) > 127, mask)
    rgb = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    data = image_io.encode_png(rgb)
    np.testing.assert_array_equal(image_io.decode_image(data), rgb)
    with pytest.raises(ValueError, match="colour PNG"):
        image_io.decode_gray_png(data)
