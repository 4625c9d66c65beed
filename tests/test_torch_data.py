"""The port's data and image modules against the JAX package and cv2:
`data/synthetic.py` and `data/coco.py` give the JAX package's records bit
for bit; `utils/image_io.py` reads PNGs as cv2 reads them (every colour
type, bit depth and row filter, palettes, 16-bit samples and Adam7
interlace), writes what cv2 reads back exactly, and resizes uint8 bit for
bit as cv2's INTER_LINEAR (its fixed-point arithmetic, through the C
library and the plain NumPy version); `data/loader.py load_image` reads
records through it. JPEG decoding is tested in test_torch_jpeg.py.
"""

import json
import struct
import zlib

import cv2
import numpy as np
import pytest

from multiposenet_tpu.data import coco as jax_coco
from multiposenet_tpu.data import loader as jax_loader
from multiposenet_tpu.data import synthetic as jax_synthetic
from multiposenet_tpu_torch.data import coco, loader, synthetic
from multiposenet_tpu_torch.utils import image_io

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            if isinstance(w[key], np.ndarray):
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            else:
                assert g[key] == w[key], key


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("style", ["v2", "v1", "v2flat"])
def test_make_dataset_matches_jax(style, seed):
    kwargs = dict(img_h=72, img_w=96, seed=seed, style=style,
                  max_persons=5)
    _assert_records_equal(synthetic.make_dataset(4, **kwargs),
                          jax_synthetic.make_dataset(4, **kwargs))


def test_make_dataset_gate_options_match_jax():
    kwargs = dict(img_h=64, img_w=64, seed=2, overhang=0.0, min_size=0.2,
                  max_size=0.6)
    _assert_records_equal(synthetic.make_dataset(3, **kwargs),
                          jax_synthetic.make_dataset(3, **kwargs))


def _coco_json(path):
    rng = np.random.RandomState(0)
    kps = lambda: np.c_[rng.uniform(0, 60, (17, 2)),  # noqa: E731
                        rng.randint(0, 3, 17)].reshape(-1).tolist()
    data = {
        "images": [{"id": i, "file_name": f"{i}.png", "height": 48 + i,
                    "width": 64} for i in (3, 1, 2, 7)],
        "annotations": [
            {"image_id": 1, "category_id": 1, "bbox": [1, 2, 30, 40],
             "keypoints": kps(), "iscrowd": 0, "area": 900.5,
             "segmentation": [[1, 2, 3, 4, 5, 6]]},
            {"image_id": 1, "bbox": [5, 5, 10, 10], "iscrowd": 1,
             "segmentation": {"counts": [1, 2], "size": [49, 64]}},
            {"image_id": 3, "category_id": 1, "bbox": [0, 0, 20, 25],
             "keypoints": kps()},
            {"image_id": 3, "category_id": 2, "bbox": [0, 0, 5, 5]},
            {"image_id": 2, "category_id": 1, "bbox": [4, 4, 8, 8],
             "iscrowd": 1},
            {"image_id": 99, "category_id": 1, "bbox": [0, 0, 1, 1]},
        ],
    }
    path.write_text(json.dumps(data))
    return path


@pytest.mark.parametrize("skip_crowd_only", [False, True])
def test_load_coco_keypoints_matches_jax(tmp_path, skip_crowd_only):
    path = _coco_json(tmp_path / "ann.json")
    got = coco.load_coco_keypoints(path, skip_crowd_only)
    want = jax_coco.load_coco_keypoints(path, skip_crowd_only)
    assert len(want) == (2 if skip_crowd_only else 3)
    _assert_records_equal(got, want)
    for max_persons in (1, 4):
        for g, w in zip(got, want):
            gp = coco.pad_record(g, max_persons)
            wp = jax_coco.pad_record(w, max_persons)
            for key in wp:
                np.testing.assert_array_equal(gp[key], wp[key])


# --- image files ------------------------------------------------------------


def _scene(h: int, w: int, channels: int) -> np.ndarray:
    """Smooth gradients plus noise, so libpng's adaptive filtering picks
    a mix of row filters."""
    rng = np.random.RandomState(h * w + channels)
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [(np.sin(xx / (3.0 + c)) + np.cos(yy / (5.0 + c))) * 60 + 128
              + rng.randint(0, 4, (h, w)) for c in range(channels)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_image_matches_cv2_on_cv2_pngs(tmp_path, channels):
    path = str(tmp_path / "x.png")
    img = _scene(37, 53, channels)
    assert cv2.imwrite(path, img if channels > 1 else img[..., 0])
    want = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
    got = image_io.read_image(path)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, want)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Byte rows [H, stride] filtered as the PNG specification defines,
    with the given filter types cycled."""
    h, stride = rows.shape
    raw = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y].astype(np.int32)
        left = np.r_[np.zeros(bpp, np.int32), cur[:-bpp]]
        upleft = np.r_[np.zeros(bpp, np.int32), prev[:-bpp]]
        if f == 0:
            pred = np.zeros(stride, np.int32)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    return bytes(raw)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """Integer samples [H, W, C] → byte rows [H, stride] at `depth`."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[:, :, None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(h, -1), axis=1)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _png_samples(samples: np.ndarray, colour: int, depth: int, filters,
                 interlace: bool = False, extra: bytes = b"") -> bytes:
    """A PNG of integer samples [H, W, C], filtered (each Adam7 pass on
    its own when interlaced)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = image_io.ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for y0, x0, dy, dx in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack(sub, depth), bpp, filters)
    return (image_io.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                          0, 0, int(interlace)))
            + extra + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def _png(rows: np.ndarray, colour: int, filters) -> bytes:
    """An 8-bit PNG of `rows` [H, W*channels] with the given row filter
    types (cycled)."""
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    h = rows.shape[0]
    return _png_samples(rows.reshape(h, -1, channels), colour, 8, filters)


@pytest.mark.parametrize("colour", [0, 2, 4, 6],
                         ids=["gray", "rgb", "gray_alpha", "rgba"])
def test_read_image_every_row_filter_matches_cv2(tmp_path, colour):
    """Every colour type, gray+alpha (which cv2 does not write) included,
    with each of the five row filters, against cv2.imread."""
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    img = _scene(23, 31, channels)
    path = tmp_path / "f.png"
    path.write_bytes(_png(img.reshape(23, -1), colour, [0, 1, 2, 3, 4]))
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)[:, :, ::-1]
    np.testing.assert_array_equal(image_io.read_image(path), want)


def test_read_image_npy(tmp_path):
    img = _scene(9, 11, 3)
    np.save(tmp_path / "a.npy", img)
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "a.npy"),
                                  img)
    np.save(tmp_path / "g.npy", img[..., 0])
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "g.npy"),
                                  np.repeat(img[..., :1], 3, -1))
    np.save(tmp_path / "f.npy", img.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        image_io.read_image(tmp_path / "f.npy")


@pytest.mark.parametrize("case", ["unknown", "bad_crc", "missing"])
def test_read_image_refuses(tmp_path, case):
    path = tmp_path / "x.img"
    rows = _scene(4, 5, 3).reshape(4, -1)
    err, match = ValueError, None
    if case == "unknown":
        path.write_bytes(b"hello world")
        match = "TIFF and GIF only"
    elif case == "bad_crc":
        data = bytearray(_png(rows, 2, [0]))
        data[-20] ^= 0xFF  # inside the IDAT payload
        path.write_bytes(bytes(data))
        match = "CRC"
    else:
        err = FileNotFoundError
    with pytest.raises(err, match=match):
        image_io.read_image(path)


def _cv2_read(path) -> np.ndarray:
    return cv2.imread(str(path), cv2.IMREAD_COLOR)[:, :, ::-1]


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["progressive_rows", "adam7"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_read_image_palette_png_matches_cv2(tmp_path, depth, interlace):
    """Palette PNGs at every depth, tRNS dropped; one index past a short
    palette reads as black, as libpng pads it."""
    rng = np.random.RandomState(depth)
    n = 1 << depth
    palette = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    idx = rng.randint(0, n, (13, 19, 1))
    trns = _chunk(b"tRNS", bytes(rng.randint(0, 256, n).astype(np.uint8)))
    path = tmp_path / "p.png"
    for pal in (palette, palette[:max(1, n - 1)]):
        path.write_bytes(_png_samples(
            idx, 3, depth, [0, 1, 2, 3, 4], interlace,
            _chunk(b"PLTE", pal.tobytes()) + trns))
        np.testing.assert_array_equal(image_io.read_image(path),
                                      _cv2_read(path))


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["progressive_rows", "adam7"])
@pytest.mark.parametrize("depth", [1, 2, 4, 16])
def test_read_image_gray_png_matches_cv2(tmp_path, depth, interlace):
    """Gray at 1, 2 and 4 bits (libpng's png_set_expand_gray_1_2_4_to_8)
    and 16 bits (its high byte), with a tRNS chunk."""
    rng = np.random.RandomState(depth)
    samples = rng.randint(0, 1 << depth, (17, 23, 1))
    path = tmp_path / "g.png"
    path.write_bytes(_png_samples(
        samples, 0, depth, [0, 1, 2, 3, 4], interlace,
        _chunk(b"tRNS", struct.pack(">H", int(samples[0, 0, 0])))))
    np.testing.assert_array_equal(image_io.read_image(path),
                                  _cv2_read(path))


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["progressive_rows", "adam7"])
@pytest.mark.parametrize("colour", [0, 2, 4, 6],
                         ids=["gray", "rgb", "gray_alpha", "rgba"])
def test_read_image_16bit_png_matches_cv2(tmp_path, colour, interlace):
    """16-bit samples of every colour type: cv2 keeps the high byte
    (libpng's png_set_strip_16), not the rounded value."""
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    rng = np.random.RandomState(colour)
    samples = rng.randint(0, 65536, (11, 14, channels))
    path = tmp_path / "s.png"
    path.write_bytes(_png_samples(samples, colour, 16, [0, 1, 2, 3, 4],
                                  interlace))
    want = _cv2_read(path)
    np.testing.assert_array_equal(image_io.read_image(path), want)
    rounded = (samples[..., :3] * 255 + 32895) >> 16
    if channels >= 3:
        assert not np.array_equal(want, rounded)


@pytest.mark.parametrize("size", [(1, 1), (3, 2), (9, 13), (17, 5)])
@pytest.mark.parametrize("colour,depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
    (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_read_image_adam7_matches_cv2(tmp_path, colour, depth, size):
    """Adam7 interlace for every colour type and depth, at sizes where
    some passes are empty."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    rng = np.random.RandomState(colour * 100 + depth)
    samples = rng.randint(0, 1 << depth, (*size, channels))
    extra = b""
    if colour == 3:
        extra = _chunk(b"PLTE", rng.randint(0, 256, (1 << depth, 3))
                       .astype(np.uint8).tobytes())
    path = tmp_path / "i.png"
    path.write_bytes(_png_samples(samples, colour, depth, [0, 4, 1],
                                  True, extra))
    np.testing.assert_array_equal(image_io.read_image(path),
                                  _cv2_read(path))


def test_write_png_reads_back_through_cv2(tmp_path):
    img = _scene(41, 29, 3)
    image_io.write_png(tmp_path / "w.png", img)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "w.png"), cv2.IMREAD_COLOR)[:, :, ::-1],
        img)
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "w.png"),
                                  img)
    with pytest.raises(ValueError):
        image_io.write_png(tmp_path / "g.png", img[..., 0])


@pytest.mark.parametrize("src,dst", [
    ((37, 53), (74, 106)),    # up x2
    ((37, 53), (111, 159)),   # up x3
    ((37, 53), (50, 91)),     # up, non-integer
    ((64, 64), (32, 32)),     # down x2
    ((63, 81), (21, 27)),     # down x3
    ((41, 29), (17, 13)),     # down, non-integer, odd
    ((100, 140), (91, 128)),  # the eval runner's letterbox at 128
    ((480, 640), (750, 1000)),  # heights upscaled: cv2 leaves the rows
    ((480, 640), (960, 1280)),  # past the edges unclamped
    ((480, 640), (500, 700)),
    ((480, 640), (960, 100)),
])
def test_resize_linear_matches_cv2(src, dst):
    """uint8 bit for bit (the C library; the plain version too up to
    100x140); float32 within 1e-5 on the first seven pairs. The 480x640
    pairs hold uint8 only: there cv2's float32 path is up to 4.6e-5 from
    bilinear, which the float path does not follow."""
    rng = np.random.RandomState(src[0] * dst[1])
    img = rng.randint(0, 256, (*src, 3)).astype(np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = image_io.resize_linear(img, dst[::-1])
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if src[0] * src[1] > 100 * 140:
        return
    np.testing.assert_array_equal(
        image_io.resize_linear_plain(img, dst[::-1]), want)
    flat = rng.rand(*src).astype(np.float32)
    np.testing.assert_allclose(
        image_io.resize_linear(flat, dst[::-1]),
        cv2.resize(flat, dst[::-1], interpolation=cv2.INTER_LINEAR),
        atol=1e-5)


def test_resize_linear_matches_cv2_on_random_shapes():
    """Seeded sizes from 1 to 130 a side, 1 to 4 channels, up and down:
    the C library and the plain version equal cv2 on every one."""
    rng = np.random.RandomState(5)
    for _ in range(150):
        h, w = rng.randint(1, 60, 2)
        c = int(rng.choice([1, 2, 3, 4]))
        size = tuple(int(v) for v in rng.randint(1, 130, 2))
        img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
        if c == 1:
            img = img[..., 0]
        want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(image_io.resize_linear(img, size),
                                      want)
        np.testing.assert_array_equal(
            image_io.resize_linear_plain(img, size), want)


def test_load_image_matches_jax(tmp_path):
    rec = synthetic.make_dataset(1, img_h=40, img_w=50, seed=1)[0]
    assert loader.load_image(rec, None) is rec["image"]
    image_io.write_png(tmp_path / rec["file_name"], rec["image"])
    file_rec = {k: v for k, v in rec.items() if k != "image"}
    np.testing.assert_array_equal(
        loader.load_image(file_rec, str(tmp_path)),
        jax_loader.load_image(file_rec, str(tmp_path)))
    with pytest.raises(ValueError, match="image_dir"):
        loader.load_image(file_rec, None)


@pytest.mark.parametrize("size", [(480, 640), (300, 700), (97, 1333),
                                  (64, 48)])
def test_heatmap_overlay_matches_jax(size):
    """`utils/visualize.py heatmap_overlay` against the JAX package's:
    the float32 resize runs in torch in the port and in cv2 in the JAX
    package, so a red value rounds to the other grey level where the two
    land either side of an integer: measured at most 1 level on at most
    5.2e-6 of the pixels at these seeds, held to 1 level on at most
    1e-5."""
    from multiposenet_tpu.utils import visualize as jax_visualize
    from multiposenet_tpu_torch.utils import visualize

    h, w = size
    rng = np.random.RandomState(h)
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    heatmaps = rng.rand(h // 4 + 1, w // 4 + 1, 17).astype(np.float32)
    got = visualize.heatmap_overlay(image, heatmaps)
    want = jax_visualize.heatmap_overlay(image, heatmaps)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-5
    np.testing.assert_array_equal(got[..., 1:], image[..., 1:])
