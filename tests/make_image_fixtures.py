"""Writes the image fixtures under tests/fixtures/images/ with cv2, for
the card's machine, which can neither encode JPEG nor run cv2. The tests
do not run this script; they check that its digests still equal the
installed cv2's decode.

    python tests/make_image_fixtures.py

- `scene_*.jpg`: `data/synthetic.make_dataset` scenes with texture laid
  over them (the flat scenes alone compress to a few KB and barely
  exercise the IDCT or the upsampling), at several samplings and
  qualities; `annotations.json` is a COCO person-keypoints JSON of their
  persons, for `eval --coco-json ... --image-dir`;
  `annotations_segs.json` is the same persons with COCO segmentations
  (`segmentation_annotations`), for `prepare --coco-json`: multi-part
  polygons whose parts overlap (with a part off the image and a part
  under 6 numbers), uncompressed and compressed RLE, crowd regions in
  both RLE forms, a person with no labelled keypoint and persons with no
  segmentation (the box fallback).
- `photo_480x640_q95_420.jpg`: the timing fixture (and `predict`'s input).
- `kind_*.jpg`: textured and noise content covering 4:4:4, 4:2:2, 4:2:0,
  4:4:0, 4:1:1 and gray, q 50, 75, 95 and 100, optimised Huffman tables,
  restart intervals, odd sizes (97x133, 37x53, 3x3) and Exif orientations
  3 and 6 spliced into APP1 (little- and big-endian).
- `c3_*.jpg`: the modes past baseline that cv2 reads and the plain
  decoder refuses: progressive (with restart intervals, and gray), Adobe
  RGB (PIL's keep_rgb), CMYK (PIL) and YCCK (the CMYK stream with its
  Adobe transform set to 2), and files cut inside their scan data, one
  baseline and one progressive cut in its last scan (which `cv2.imread`
  fills and reads).
- `png_palette4.png`, `png_rgb16.png`, `png_interlaced.png`: PNG kinds
  the port decodes without cv2 (palette, 16-bit, Adam7).
- `digests.json`: for each file, the shape and sha256 of cv2's RGB decode
  (`cv2.imread(path, IMREAD_COLOR)[..., ::-1]`) and of cv2's INTER_LINEAR
  letterbox of it to 512 (the eval runner's resize: scale 512 / max(h, w),
  rounded sizes).
"""

from __future__ import annotations

import hashlib
import json
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "fixtures" / "images"
LETTERBOX = 512
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}


def texture(h: int, w: int, seed: int, noise: int = 24) -> np.ndarray:
    """Stripes, a checkerboard and uniform noise: detail at every
    frequency, float [h, w, 3] around 0."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = []
    for c in range(3):
        wave = 40 * np.sin(xx / (2.5 + c) + yy / (7.0 + 2 * c))
        check = 30 * (((yy // (4 + c)) + (xx // (5 + c))) % 2 - 0.5)
        planes.append(wave + check + rng.uniform(-noise, noise, (h, w)))
    return np.stack(planes, -1)


def textured_scene(image: np.ndarray, seed: int,
                   noise: int = 24) -> np.ndarray:
    h, w = image.shape[:2]
    return np.clip(image * 0.8 + 25 + 0.6 * texture(h, w, seed, noise), 0,
                   255).astype(np.uint8)


def encode_jpeg(rgb: np.ndarray, quality: int, sampling: str | None,
                extra=()) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, *extra]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    image = rgb[..., ::-1] if rgb.ndim == 3 else rgb
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(image), params)
    assert ok
    return buf.tobytes()


def exif_tiff(orientation: int, big_endian: bool) -> bytes:
    """A TIFF header and IFD0 holding only the orientation tag."""
    e = ">" if big_endian else "<"
    return ((b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))


def with_exif(jpeg: bytes, tiff: bytes) -> bytes:
    """`jpeg` with an APP1 Exif segment right after SOI."""
    payload = b"Exif\x00\x00" + tiff
    return (jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2)
            + payload + jpeg[2:])


def pil_jpeg(rgb: np.ndarray, mode: str, **options) -> bytes:
    """`rgb` converted to `mode` and written by PIL (libjpeg), q 90."""
    import io

    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(rgb).convert(mode).save(out, "JPEG", quality=90,
                                            **options)
    return out.getvalue()


def with_adobe_transform(jpeg: bytes, transform: int) -> bytes:
    """`jpeg` with the transform byte of its APP14 Adobe block replaced."""
    at = jpeg.index(b"Adobe") + 11
    return jpeg[:at] + bytes([transform]) + jpeg[at + 1:]


def cut_scan_data(jpeg: bytes, fraction: float) -> bytes:
    """`jpeg` cut `fraction` of the way from its first SOS to its end."""
    sos = jpeg.index(b"\xff\xda")
    return jpeg[:sos + int((len(jpeg) - sos) * fraction)]


def png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(samples: np.ndarray, colour: int, depth: int,
               interlace: bool = False, extra: bytes = b"") -> bytes:
    """A PNG of integer samples [H, W, C] (rows unfiltered), Adam7
    interlaced if asked."""
    h, w, ch = samples.shape

    def rows(block):
        out = b""
        for row in block.reshape(block.shape[0], -1):
            if depth == 16:
                data = row.astype(">u2").tobytes()
            elif depth == 8:
                data = row.astype(np.uint8).tobytes()
            else:
                bits = (row[:, None] >> np.arange(depth - 1, -1, -1)) & 1
                data = np.packbits(bits.astype(np.uint8).reshape(-1)) \
                    .tobytes()
            out += b"\x00" + data
        return out

    if interlace:
        raw = b""
        for y0, x0, dy, dx in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4),
                               (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
                               (1, 0, 2, 1)):
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += rows(sub)
    else:
        raw = rows(samples)
    return (b"\x89PNG\r\n\x1a\n"
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                             0, 0, int(interlace)))
            + extra + png_chunk(b"IDAT", zlib.compress(raw, 9))
            + png_chunk(b"IEND", b""))


def coco_annotations(records, names) -> dict:
    data = {"images": [], "annotations": [],
            "categories": [{"id": 1, "name": "person"}]}
    for i, (rec, name) in enumerate(zip(records, names)):
        h, w = rec["image"].shape[:2]
        data["images"].append({"id": i, "file_name": name, "height": h,
                               "width": w})
        for p in range(len(rec["boxes"])):
            y0, x0, y1, x1 = (float(v) for v in rec["boxes"][p])
            kps = np.asarray(rec["keypoints"][p], np.float64)
            data["annotations"].append({
                "id": len(data["annotations"]) + 1, "image_id": i,
                "category_id": 1, "iscrowd": 0,
                "bbox": [x0, y0, x1 - x0, y1 - y0],
                "area": float(rec["area"][p]),
                "keypoints": [round(float(v), 3) for v in kps.reshape(-1)],
                "num_keypoints": int((kps[:, 2] > 0).sum())})
    return data


def _outline(box, n: int, rng) -> list[float]:
    """An n-point ellipse-like polygon inside a (y0, x0, y1, x1) box, as
    flat COCO [x0, y0, x1, y1, ...] rounded to 2 decimals."""
    y0, x0, y1, x1 = box
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = 0.5 * (0.8 + 0.2 * rng.rand(n))
    xs = (x0 + x1) / 2 + r * (x1 - x0) * np.cos(t)
    ys = (y0 + y1) / 2 + r * (y1 - y0) * np.sin(t)
    return [round(float(v), 2) for v in np.stack([xs, ys], 1).reshape(-1)]


def _rle(poly_parts, h: int, w: int, compressed: bool) -> dict:
    from multiposenet_tpu_torch.data import masks

    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [np.round(np.asarray(p, np.float64).reshape(-1, 2))
                        .astype(np.int32) for p in poly_parts], 1)
    counts = masks.mask_to_rle_counts(mask.astype(bool))
    return {"size": [h, w], "counts": (masks.encode_rle_string(counts)
                                       if compressed else counts)}


def segmentation_annotations(records, names) -> dict:
    """`coco_annotations` with a `segmentation` on the persons and crowd
    regions added: person k of the fixture gets, by k % 5, overlapping
    multi-part polygons (body, head square and a part off the image, plus
    a dropped part of 4 numbers), uncompressed RLE, compressed RLE, one
    polygon, or no segmentation (the box fallback). Image 0 gains a
    crowd region in uncompressed RLE, image 1 one in compressed RLE, and
    image 2's first person loses its keypoints (unlabelled)."""
    data = coco_annotations(records, names)
    rng = np.random.RandomState(11)
    for k, ann in enumerate(data["annotations"]):
        im = data["images"][ann["image_id"]]
        h, w = im["height"], im["width"]
        x, y, bw, bh = ann["bbox"]
        box = (y, x, y + bh, x + bw)
        body = _outline(box, 14, rng)
        cx, top = x + bw / 2, y + 0.12 * bh
        s = 0.18 * bw
        head = [round(v, 2) for v in (cx - s, top - s, cx + s, top - s,
                                      cx + s, top + s, cx - s, top + s)]
        kind = k % 5
        if kind == 0:
            off = [round(v, 2) for v in (x - 20, y + bh / 2, x + 0.3 * bw,
                                         y + 0.4 * bh, x + 0.3 * bw,
                                         y + 0.7 * bh)]
            ann["segmentation"] = [body, head, off, [x, y, x + 1, y + 1]]
        elif kind in (1, 2):
            ann["segmentation"] = _rle([body, head], h, w, kind == 2)
        elif kind == 3:
            ann["segmentation"] = [body]
    for image_id, compressed in ((0, False), (1, True)):
        im = data["images"][image_id]
        h, w = im["height"], im["width"]
        crowd = [10.0, h - 60.0, 90.0, h - 70.0, 100.0, h - 10.0, 5.0,
                 h - 5.0]
        data["annotations"].append({
            "id": len(data["annotations"]) + 1, "image_id": image_id,
            "category_id": 1, "iscrowd": 1,
            "bbox": [5.0, h - 70.0, 95.0, 65.0], "area": 5000.0,
            "keypoints": [0] * 51, "num_keypoints": 0,
            "segmentation": _rle([crowd], h, w, compressed)})
    first = next(a for a in data["annotations"] if a["image_id"] == 2)
    first["keypoints"] = [0] * 51
    first["num_keypoints"] = 0
    return data


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def digest(path: Path) -> dict:
    rgb = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
    h, w = rgb.shape[:2]
    scale = LETTERBOX / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    box = cv2.resize(np.ascontiguousarray(rgb), (nw, nh),
                     interpolation=cv2.INTER_LINEAR)
    return {"shape": list(rgb.shape), "rgb_sha256": sha256(rgb),
            "letterbox_shape": list(box.shape),
            "letterbox_sha256": sha256(box)}


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from multiposenet_tpu_torch.data.synthetic import make_dataset

    OUT.mkdir(parents=True, exist_ok=True)
    for old in OUT.iterdir():
        old.unlink()
    files: dict[str, bytes] = {}

    # Scenes with persons, for eval.
    kinds = [("420", 75), ("422", 95), ("444", 50), ("440", 95),
             ("411", 75), ("420", 95), (None, 95), ("420", 50),
             ("444", 75), ("422", 75)]
    records = make_dataset(len(kinds), img_h=192, img_w=256, seed=21)
    names = []
    for i, (rec, (sampling, q)) in enumerate(zip(records, kinds)):
        rgb = textured_scene(rec["image"], seed=100 + i)
        if sampling is None:
            rgb = rgb[..., 1]
        name = f"scene_{i:02d}_{sampling or 'gray'}_q{q}.jpg"
        files[name] = encode_jpeg(rgb, q, sampling)
        names.append(name)

    # The timing fixture.
    big = make_dataset(1, img_h=480, img_w=640, seed=7)[0]["image"]
    files["photo_480x640_q95_420.jpg"] = encode_jpeg(
        textured_scene(big, seed=5, noise=6), 95, "420")

    # Coverage of the decoder's modes.
    rng = np.random.RandomState(3)
    noise = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    tex = textured_scene(np.full((97, 133, 3), 128, np.uint8), seed=9)
    files["kind_noise_37x53_444_q100.jpg"] = encode_jpeg(noise, 100, "444")
    files["kind_noise_37x53_420_q95.jpg"] = encode_jpeg(noise, 95, "420")
    files["kind_tex_97x133_422_q50.jpg"] = encode_jpeg(tex, 50, "422")
    files["kind_tex_97x133_440_q75.jpg"] = encode_jpeg(tex, 75, "440")
    files["kind_tex_97x133_411_q95.jpg"] = encode_jpeg(tex, 95, "411")
    files["kind_tex_97x133_gray_q100.jpg"] = encode_jpeg(tex[..., 0], 100,
                                                         None)
    files["kind_tex_97x133_420_q75_optimize.jpg"] = encode_jpeg(
        tex, 75, "420", (cv2.IMWRITE_JPEG_OPTIMIZE, 1))
    files["kind_tex_97x133_420_q95_rst3.jpg"] = encode_jpeg(
        tex, 95, "420", (cv2.IMWRITE_JPEG_RST_INTERVAL, 3))
    files["kind_tex_3x3_420_q95.jpg"] = encode_jpeg(tex[:3, :3], 95, "420")
    files["kind_tex_4x4_422_q50.jpg"] = encode_jpeg(tex[:4, :4], 50, "422")
    base = encode_jpeg(tex[:40, :64], 95, "420")
    files["kind_orient3_le_40x64.jpg"] = with_exif(base, exif_tiff(3, False))
    files["kind_orient6_be_40x64.jpg"] = with_exif(base, exif_tiff(6, True))

    # Past baseline (ROADMAP C3).
    small = np.ascontiguousarray(tex[:48, :64])
    progressive = (cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    files["c3_progressive_48x64_420_q95_rst2.jpg"] = encode_jpeg(
        small, 95, "420", progressive + (cv2.IMWRITE_JPEG_RST_INTERVAL, 2))
    files["c3_progressive_48x64_gray_q50.jpg"] = encode_jpeg(
        small[..., 1], 50, None, progressive)
    files["c3_adobe_rgb_48x64.jpg"] = pil_jpeg(small, "RGB", keep_rgb=True,
                                               subsampling=0)
    cmyk = pil_jpeg(small, "CMYK")
    files["c3_cmyk_48x64.jpg"] = cmyk
    files["c3_ycck_48x64.jpg"] = with_adobe_transform(cmyk, 2)
    files["c3_truncated_48x64_420.jpg"] = cut_scan_data(
        encode_jpeg(small, 95, "420"), 0.6)
    files["c3_truncated_progressive_48x64_444.jpg"] = cut_scan_data(
        encode_jpeg(small, 95, "444", progressive), 0.97)

    # PNG kinds.
    palette = rng.randint(0, 256, (16, 3)).astype(np.uint8)
    idx = rng.randint(0, 16, (29, 41, 1))
    files["png_palette4.png"] = encode_png(
        idx, 3, 4, extra=png_chunk(b"PLTE", palette.tobytes())
        + png_chunk(b"tRNS", bytes(range(0, 256, 16))))
    files["png_rgb16.png"] = encode_png(
        rng.randint(0, 65536, (23, 31, 3)), 2, 16)
    files["png_interlaced.png"] = encode_png(
        tex[:27, :35].astype(np.int64), 2, 8, interlace=True)

    for name, data in files.items():
        (OUT / name).write_bytes(data)
    digests = {name: digest(OUT / name) for name in sorted(files)}
    (OUT / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    (OUT / "annotations.json").write_text(
        json.dumps(coco_annotations(records, names)) + "\n")
    (OUT / "annotations_segs.json").write_text(json.dumps(
        segmentation_annotations(records, names), separators=(",", ":"))
        + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(files)} images, {total} bytes in {OUT}")


if __name__ == "__main__":
    main()
