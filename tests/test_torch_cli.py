"""The port's command line (`python -m multiposenet_tpu_torch eval|predict`)
against the JAX package's on one JAX export of a tiny float32 fast()
config (score threshold 0), and the port's TF checkpoint import against
the JAX package's.

`eval` runs on a COCO JSON and images that the test writes, as PNG and
as JPEG (cv2-written), with ground truth planted around the port's own
detections (seeded jitter), so that AP lies strictly between 0 and 1;
the stats agree within 0.01 (test_torch_eval.py explains the bound). The
port reads both formats and resizes on the host bit for bit as cv2 does
(test_torch_jpeg.py, test_torch_data.py), so the two batched loops see
the same pixels. `predict` prints the same people on a PNG and on a
JPEG: boxes to 2e-3 px, scores to 1e-5, keypoints to 1e-3 px
(test_torch_predictor.py); its `--output` PNG is drawn without cv2 and
agrees with cv2's drawing on at least 90% of the pixels either one
changed; its `--output` JPEG holds the bytes cv2.imwrite writes for the
port's drawing, and the JAX CLI's bytes where both draw the same pixels;
`--output` in the simple formats is held to the JAX CLI's bytes in
test_torch_image_formats.py; any other suffix exits before the model
runs.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import struct
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from multiposenet_tpu import cli as jax_cli
from multiposenet_tpu.infer import export as jax_export
from multiposenet_tpu_torch import cli
from multiposenet_tpu_torch.data.synthetic import make_dataset
from multiposenet_tpu_torch.infer import export
from multiposenet_tpu_torch.utils import avif, image_io, visualize

from eval_fixtures import planted_annotations, write_coco
from torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (autouse)
    posenet_variables,
    prn_variables,
    tiny_config,
    tiny_default_config,
)

SIZE = 128
STAT_TOL = 0.01


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """One JAX export, six 100x140 scenes as PNG and a COCO JSON of ground
    truth planted around the port's detections on them."""
    root = tmp_path_factory.mktemp("cli")
    cfg = tiny_config("float32")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, image_size=SIZE))
    model_dir = root / "model"
    jax_export.save_model(model_dir, cfg, posenet_variables(cfg),
                          prn_variables(cfg))
    pred = export.load_predictor(model_dir, device="cpu")
    records = make_dataset(6, img_h=100, img_w=140, seed=11)
    rng = np.random.RandomState(12)
    images, anns = [], []
    for rec in records:
        people = pred.predict(rec["image"])
        images.append(rec["image"])
        anns.append(planted_annotations(
            np.stack([p.box for p in people]),
            np.stack([p.keypoints for p in people]), rng, 100, 140))
    coco_json, image_dir = write_coco(root / "coco", images, anns,
                                      image_io.write_png)
    jpeg_json, jpeg_dir = write_coco(root / "coco_jpeg", images, anns,
                                     _write_jpeg, suffix=".jpg")
    return {"root": root, "model": str(model_dir), "coco": coco_json,
            "images": image_dir, "image": f"{image_dir}/000000.png",
            "coco_jpeg": jpeg_json, "images_jpeg": jpeg_dir,
            "image_jpeg": f"{jpeg_dir}/000000.jpg"}


def _write_jpeg(path, rgb):
    """A 4:2:0 q90 JPEG, as cv2 writes it."""
    assert cv2.imwrite(str(path), np.ascontiguousarray(rgb[:, :, ::-1]),
                       [cv2.IMWRITE_JPEG_QUALITY, 90])


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
@pytest.mark.parametrize("batched", [False, True],
                         ids=["predict_loop", "batched"])
def test_eval_matches_jax_cli(workdir, batched, fmt):
    suffix = "" if fmt == "png" else "_jpeg"
    argv = ["eval", "--model-dir", workdir["model"], "--coco-json",
            workdir["coco" + suffix], "--image-dir",
            workdir["images" + suffix]]
    if batched:
        argv += ["--batched", "--batch-size", "8"]  # 6 images: one padded
    want_text = _run(jax_cli.main, argv)
    got_text = _run(cli.main, argv + ["--device", "cpu"])
    want, got = json.loads(want_text), json.loads(got_text)
    assert got_text.count("\n") == want_text.count("\n")  # indent=2
    assert list(got) == list(want)
    assert 0.0 < want["AP"] < 1.0
    for key in want:
        assert abs(got[key] - want[key]) <= STAT_TOL, (key, got, want)


@pytest.fixture(scope="module")
def predicted(workdir):
    """Both CLIs' `predict --output` on one scene."""
    runs = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out_png = str(workdir["root"] / f"{name}.png")
        text = _run(main, ["predict", "--model-dir", workdir["model"],
                           "--image", workdir["image"], "--output",
                           out_png] + extra)
        runs[name] = (json.loads(text), out_png)
    runs["input"] = image_io.read_image(workdir["image"])
    return runs


def test_predict_json_matches_jax_cli(predicted):
    got, want = predicted["port"][0], predicted["jax"][0]
    assert len(want) > 0 and len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == ["box", "score", "keypoints"]
        np.testing.assert_allclose(g["box"], w["box"], atol=2e-3, rtol=1e-5)
        assert abs(g["score"] - w["score"]) <= 1e-5
        np.testing.assert_allclose(g["keypoints"], w["keypoints"],
                                   atol=1e-3, rtol=1e-5)


def test_predict_png_agrees_with_cv2_drawing(predicted):
    image = predicted["input"]
    got = image_io.read_image(predicted["port"][1])
    want = cv2.imread(predicted["jax"][1], cv2.IMREAD_COLOR)[:, :, ::-1]
    assert got.shape == want.shape == image.shape
    changed = (got != image).any(-1) | (want != image).any(-1)
    assert changed.sum() > 100
    agree = (got == want).all(-1)[changed].mean()
    assert agree >= 0.9, agree


def test_predict_png_keypoint_centres_have_their_colour(predicted):
    """Each visible keypoint's centre pixel has its person's colour, unless
    a person drawn later covers that pixel."""
    image = predicted["input"]
    got = image_io.read_image(predicted["port"][1])
    people = [_person(p) for p in predicted["port"][0]]
    h, w = image.shape[:2]
    checked = 0
    for i, person in enumerate(people):
        colour = visualize._COLORS[i % len(visualize._COLORS)]
        later = visualize.draw_predictions(np.zeros_like(image),
                                           people[i + 1:])
        for x, y, s in person.keypoints:
            if s <= 0.05:
                continue
            cx, cy = int(round(x)), int(round(y))
            if not (0 <= cx < w and 0 <= cy < h) or later[cy, cx].any():
                continue
            np.testing.assert_array_equal(got[cy, cx], colour)
            checked += 1
    assert checked > 0


def _person(p):
    """A printed person as the drawing functions take it."""
    return argparse.Namespace(box=np.asarray(p["box"]), score=p["score"],
                              keypoints=np.asarray(p["keypoints"]))


def test_load_records_synthetic_matches_jax():
    ns = argparse.Namespace(coco_json=None, synthetic=2)
    got, want = cli._load_records(ns), jax_cli._load_records(ns)
    for g, w in zip(got, want, strict=True):
        assert g["image"].shape == (256, 256, 3)
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]))


@pytest.mark.parametrize("preset", [None, "default", "fast", "crowd"])
def test_load_config_matches_jax(preset):
    ns = argparse.Namespace(config=None, preset=preset)
    want = jax_cli._load_config(ns).to_dict()
    assert cli._load_config(ns).to_dict() == want


def test_device_defaults_to_the_card(workdir, monkeypatch):
    """Without --device the CLI asks for the CUDA card, and raises where
    there is none: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["predict", "--image", workdir["image"]],
                 ["eval", "--synthetic", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv + ["--model-dir", workdir["model"]])


def test_predict_on_a_jpeg_matches_jax_cli(workdir):
    """`predict --image x.jpg` prints the JAX CLI's people."""
    argv = ["predict", "--model-dir", workdir["model"], "--image",
            workdir["image_jpeg"]]
    want = json.loads(_run(jax_cli.main, argv))
    got = json.loads(_run(cli.main, argv + ["--device", "cpu"]))
    assert len(want) > 0 and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["box"], w["box"], atol=2e-3, rtol=1e-5)
        assert abs(g["score"] - w["score"]) <= 1e-5
        np.testing.assert_allclose(g["keypoints"], w["keypoints"],
                                   atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("suffix", [".jp2", ".j2k"])
def test_predict_on_jpeg2000_matches_jax_cli(workdir, tmp_path, suffix):
    """`predict --image x.jp2` (a JP2 file, reversible) and `x.j2k` (a
    bare codestream, irreversible, three layers): the port reads them as
    cv2.imread does (tests/test_torch_jpeg2000.py) and prints the JAX
    CLI's people."""
    from PIL import Image

    scene = image_io.read_image(workdir["image"])
    buf = io.BytesIO()
    options = ({} if suffix == ".jp2" else dict(
        irreversible=True, no_jp2=True, quality_mode="rates",
        quality_layers=[20, 10, 5]))
    Image.fromarray(scene).save(buf, "JPEG2000", **options)
    image = tmp_path / f"scene{suffix}"
    image.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(
        image_io.read_image(image), cv2.imread(str(image))[:, :, ::-1])
    argv = ["predict", "--model-dir", workdir["model"], "--image", str(image)]
    want = json.loads(_run(jax_cli.main, argv))
    got = json.loads(_run(cli.main, argv + ["--device", "cpu"]))
    assert len(want) > 0 and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["box"], w["box"], atol=2e-3, rtol=1e-5)
        assert abs(g["score"] - w["score"]) <= 1e-5
        np.testing.assert_allclose(g["keypoints"], w["keypoints"],
                                   atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("depth", [8, 10, 12, "444_bt709_limited",
                                   "grid_exif6", "sequence", "film_grain"])
def test_predict_on_avif_matches_jax_cli(workdir, tmp_path, depth):
    """`predict --image x.avif` (the scene as cv2.imwrite writes it at its
    default quality, from uint8 or, with IMWRITE_AVIF_DEPTH 10 or 12,
    from uint16 with the low bits repeated; or as a video tool writes a
    frame: 4:4:4 lossy, limited-range BT.709, by the wheel's libavif
    encoder; or as a grid of 2x2 cells of 64x72 cropped to the scene
    with an Exif item of orientation 6, by the wheel's libavif encoder,
    or as the first frame of a 3-frame sequence from Pillow; or with
    libaom's film grain, `film-grain-test` 1, by the wheel's libavif
    encoder): the port reads it as cv2.imread does
    (tests/test_torch_avif*.py) and prints the JAX CLI's people."""
    import avif_reference as ar

    scene = image_io.read_image(workdir["image"])
    image = tmp_path / "scene.avif"
    bgr = np.ascontiguousarray(scene[:, :, ::-1])
    params = []
    if depth == "grid_exif6":
        image.write_bytes(ar.grid_from_rgb(
            scene, 2, 2, 64, 72, exif=ar.tiff_orientation(6), quality=70,
            speed=8))
        form = avif.read_image(image.read_bytes())
        assert form.grid == (2, 2, 140, 100) and form.exif is not None
        assert image_io.image_size(image) == (140, 100)
    elif depth == "sequence":
        image.write_bytes(ar.pillow_avis(
            [scene, scene[::-1], scene[:, ::-1]], quality=80))
        assert avif.read_image(image.read_bytes()).form == "sequence"
    elif depth == "film_grain":
        image.write_bytes(ar.avif_encode(
            ar.planes_of(scene, 8, ar.YUV420), 8, ar.YUV420, 60, 8,
            film_grain_test=1))
        assert avif.read_image(image.read_bytes()).frame.header.grain
    elif depth == "444_bt709_limited":
        image.write_bytes(ar.avif_encode(
            ar.planes_of(scene, 8, ar.YUV444, 1, 0), 8, ar.YUV444, 60, 6,
            matrix=1, full_range=0, primaries=1, transfer=1))
        form = avif.read_image(image.read_bytes())
        assert (form.frame.seq.ssx, form.frame.header.lossless, form.matrix,
                form.full_range) == (0, 0, 1, 0)
    else:
        if depth > 8:
            wide = bgr.astype(np.uint16)
            bgr = (wide << (depth - 8)) | (wide >> (16 - depth))
            params = [cv2.IMWRITE_AVIF_DEPTH, depth]
        assert cv2.imwrite(str(image), bgr, params)
    np.testing.assert_array_equal(
        image_io.read_image(image), cv2.imread(str(image))[:, :, ::-1])
    argv = ["predict", "--model-dir", workdir["model"], "--image", str(image)]
    want = json.loads(_run(jax_cli.main, argv))
    got = json.loads(_run(cli.main, argv + ["--device", "cpu"]))
    assert len(want) > 0 and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["box"], w["box"], atol=2e-3, rtol=1e-5)
        assert abs(g["score"] - w["score"]) <= 1e-5
        np.testing.assert_allclose(g["keypoints"], w["keypoints"],
                                   atol=1e-3, rtol=1e-5)


def test_predict_on_a_damaged_jpeg_matches_jax_cli(workdir, tmp_path):
    """`predict --image` of the scene's JPEG with two bytes of its scan
    changed (cv2 reads it, libjpeg-turbo warning and going on) prints the
    JAX CLI's people."""
    data = Path(workdir["image_jpeg"]).read_bytes()
    sos = data.index(b"\xff\xda")
    start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    clean = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    rs = np.random.RandomState(4)
    while True:
        damaged = bytearray(data)
        for _ in range(2):
            damaged[rs.randint(start, len(data) - 2)] = rs.randint(0, 255)
        got = cv2.imdecode(np.frombuffer(bytes(damaged), np.uint8),
                           cv2.IMREAD_COLOR)
        if got is not None and (got != clean).mean() > 0.05:
            break
    image = tmp_path / "damaged.jpg"
    image.write_bytes(bytes(damaged))
    argv = ["predict", "--model-dir", workdir["model"], "--image", str(image)]
    want = json.loads(_run(jax_cli.main, argv))
    got = json.loads(_run(cli.main, argv + ["--device", "cpu"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["box"], w["box"], atol=2e-3, rtol=1e-5)
        assert abs(g["score"] - w["score"]) <= 1e-5
        np.testing.assert_allclose(g["keypoints"], w["keypoints"],
                                   atol=1e-3, rtol=1e-5)


def test_predict_on_a_gif_cv2_refuses_exits_in_both_clis(workdir, tmp_path):
    """A GIF whose LZW data holds a string past the frame's last pixel:
    cv2 returns no image, and both CLIs exit naming the file."""
    from multiposenet_tpu_torch.tools import image_samples

    scene = image_io.read_image(workdir["image"])
    data = bytearray(image_samples.quantised_gif(scene))
    rs = np.random.RandomState(0)
    start = data.index(b"\x2c", 13 + 3 * 256) + 11
    while True:
        damaged = bytearray(data)
        damaged[rs.randint(start, len(data) - 2)] = rs.randint(0, 256)
        if cv2.imdecode(np.frombuffer(bytes(damaged), np.uint8),
                        cv2.IMREAD_COLOR) is None:
            break
    image = tmp_path / "damaged.gif"
    image.write_bytes(bytes(damaged))
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="cannot read image"):
            _run(main, ["predict", "--model-dir", workdir["model"], "--image",
                        str(image)] + extra)


@pytest.mark.parametrize("output", ["drawn.exr", "drawn"])
def test_predict_output_other_than_png_exits(workdir, tmp_path, monkeypatch,
                                             output):
    """The reference writes by suffix through cv2.imwrite; the port
    writes every suffix cv2 5.0 writes (PNG and APNG, JPEG, BMP, PPM/PNM,
    PAM, PFM, Sun raster, TIFF, WebP, Radiance HDR, GIF, JPEG 2000 (.jp2)
    and AVIF, and, as cv2, no file for .pgm and .pbm), so on any other
    suffix (.exr, which cv2 is built without, or none) it exits naming
    the suffix before the model is loaded, and writes nothing."""
    from multiposenet_tpu_torch.infer import export as port_export

    def no_model(*args, **kwargs):
        raise AssertionError("the model was loaded")

    monkeypatch.setattr(port_export, "load_predictor", no_model)
    suffix = output.rpartition(".")[2] if "." in output else "none"
    with pytest.raises(SystemExit, match=f"suffix .?{suffix}.*PNG, JPEG"):
        cli.main(["predict", "--model-dir", workdir["model"], "--image",
                  workdir["image_jpeg"], "--output", str(tmp_path / output),
                  "--device", "cpu"])
    assert not (tmp_path / output).exists()


@pytest.mark.parametrize("output", ["drawn.jpg", "drawn.JPEG", "drawn.jpe"])
def test_predict_output_jpeg_is_what_cv2_writes(workdir, tmp_path, output):
    """`--output` with a JPEG suffix writes the bytes cv2.imwrite writes
    for the port's drawing of the printed people."""
    path = tmp_path / output
    text = _run(cli.main, ["predict", "--model-dir", workdir["model"],
                           "--image", workdir["image"], "--output", str(path),
                           "--device", "cpu"])
    people = [_person(p) for p in json.loads(text)]
    assert people
    drawn = visualize.draw_predictions(
        image_io.read_image(workdir["image"]), people)
    ok, want = cv2.imencode(".jpg", np.ascontiguousarray(drawn[:, :, ::-1]))
    assert ok and path.read_bytes() == want.tobytes()


def test_predict_output_jpeg_matches_jax_cli_bytes(workdir, tmp_path,
                                                   monkeypatch):
    """Both CLIs write `--output x.jpg` from the same pixels (each drawing
    replaced by the input image, since the port draws without cv2 and
    its drawing agrees with cv2's on most pixels only): the files are
    equal byte for byte."""
    from multiposenet_tpu.utils import visualize as jax_visualize

    for module in (jax_visualize, visualize):
        monkeypatch.setattr(module, "draw_predictions",
                            lambda rgb, people: rgb.copy())
    files = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        files[name] = tmp_path / f"{name}.jpg"
        _run(main, ["predict", "--model-dir", workdir["model"], "--image",
                    workdir["image_jpeg"], "--output", str(files[name])]
             + extra)
    assert files["port"].read_bytes() == files["jax"].read_bytes()


def test_predict_output_gif_matches_jax_cli_bytes(workdir, tmp_path,
                                                  monkeypatch):
    """`--output drawn.gif`: the port writes the bytes cv2.imwrite writes
    for its drawing of the printed people, and, with each drawing replaced
    by the input image (as the JPEG test does), the same file as the JAX
    CLI, byte for byte, which both readers read back alike."""
    from multiposenet_tpu.utils import visualize as jax_visualize

    path = tmp_path / "drawn.gif"
    text = _run(cli.main, ["predict", "--model-dir", workdir["model"],
                           "--image", workdir["image_jpeg"], "--output",
                           str(path), "--device", "cpu"])
    people = [_person(p) for p in json.loads(text)]
    assert people
    drawn = visualize.draw_predictions(
        image_io.read_image(workdir["image_jpeg"]), people)
    ok, want = cv2.imencode(".gif", np.ascontiguousarray(drawn[:, :, ::-1]))
    assert ok and path.read_bytes() == want.tobytes()
    for module in (jax_visualize, visualize):
        monkeypatch.setattr(module, "draw_predictions",
                            lambda rgb, people: rgb.copy())
    files = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        files[name] = tmp_path / f"{name}.gif"
        _run(main, ["predict", "--model-dir", workdir["model"], "--image",
                    workdir["image_jpeg"], "--output", str(files[name])]
             + extra)
    assert files["port"].read_bytes() == files["jax"].read_bytes()
    np.testing.assert_array_equal(
        image_io.read_image(files["port"]),
        cv2.imread(str(files["jax"]), cv2.IMREAD_COLOR)[:, :, ::-1])


def test_predict_output_jp2_matches_jax_cli_bytes(workdir, tmp_path,
                                                  monkeypatch):
    """`--output drawn.jp2`: the port writes the bytes cv2.imwrite writes
    for its drawing of the printed people, and, with each drawing replaced
    by the input image (as the JPEG test does), the same file as the JAX
    CLI, byte for byte."""
    from multiposenet_tpu.utils import visualize as jax_visualize

    path = tmp_path / "drawn.jp2"
    text = _run(cli.main, ["predict", "--model-dir", workdir["model"],
                           "--image", workdir["image_jpeg"], "--output",
                           str(path), "--device", "cpu"])
    people = [_person(p) for p in json.loads(text)]
    assert people
    drawn = visualize.draw_predictions(
        image_io.read_image(workdir["image_jpeg"]), people)
    ok, want = cv2.imencode(".jp2", np.ascontiguousarray(drawn[:, :, ::-1]))
    assert ok and path.read_bytes() == want.tobytes()
    for module in (jax_visualize, visualize):
        monkeypatch.setattr(module, "draw_predictions",
                            lambda rgb, people: rgb.copy())
    files = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        files[name] = tmp_path / f"{name}.jp2"
        _run(main, ["predict", "--model-dir", workdir["model"], "--image",
                    workdir["image_jpeg"], "--output", str(files[name])]
             + extra)
    assert files["port"].read_bytes() == files["jax"].read_bytes()


def test_predict_output_avif_matches_jax_cli_bytes(workdir, tmp_path,
                                                   monkeypatch):
    """`--output drawn.avif`: the port writes the bytes cv2.imwrite writes
    for its drawing of the printed people, and, with each drawing replaced
    by the input image (as the JPEG test does), the same file as the JAX
    CLI, byte for byte."""
    from multiposenet_tpu.utils import visualize as jax_visualize

    path = tmp_path / "drawn.avif"
    text = _run(cli.main, ["predict", "--model-dir", workdir["model"],
                           "--image", workdir["image_jpeg"], "--output",
                           str(path), "--device", "cpu"])
    people = [_person(p) for p in json.loads(text)]
    assert people
    drawn = visualize.draw_predictions(
        image_io.read_image(workdir["image_jpeg"]), people)
    ok, want = cv2.imencode(".avif", np.ascontiguousarray(drawn[:, :, ::-1]))
    assert ok and path.read_bytes() == want.tobytes()
    for module in (jax_visualize, visualize):
        monkeypatch.setattr(module, "draw_predictions",
                            lambda rgb, people: rgb.copy())
    files = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        files[name] = tmp_path / f"{name}.avif"
        _run(main, ["predict", "--model-dir", workdir["model"], "--image",
                    workdir["image_jpeg"], "--output", str(files[name])]
             + extra)
    assert files["port"].read_bytes() == files["jax"].read_bytes()


def test_predict_output_apng_matches_jax_cli_pixels(workdir, tmp_path,
                                                    monkeypatch):
    """`--output drawn.apng`: cv2.imwrite writes a PNG for the suffix
    (its APNG encoder writes one still image as the PNG encoder does), so
    the port writes its PNG, which cv2 reads back to the port's drawing of
    the printed people; with each drawing replaced by the input image (as
    the JPEG test does), cv2 reads the port's file and the JAX CLI's to the
    same pixels."""
    from multiposenet_tpu.utils import visualize as jax_visualize

    path = tmp_path / "drawn.apng"
    text = _run(cli.main, ["predict", "--model-dir", workdir["model"],
                           "--image", workdir["image_jpeg"], "--output",
                           str(path), "--device", "cpu"])
    people = [_person(p) for p in json.loads(text)]
    assert people
    drawn = visualize.draw_predictions(
        image_io.read_image(workdir["image_jpeg"]), people)
    assert path.read_bytes().startswith(image_io.PNG_SIGNATURE)
    np.testing.assert_array_equal(
        cv2.imread(str(path), cv2.IMREAD_COLOR)[:, :, ::-1], drawn)
    for module in (jax_visualize, visualize):
        monkeypatch.setattr(module, "draw_predictions",
                            lambda rgb, people: rgb.copy())
    files = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        files[name] = tmp_path / f"{name}.apng"
        _run(main, ["predict", "--model-dir", workdir["model"], "--image",
                    workdir["image_jpeg"], "--output", str(files[name])]
             + extra)
    np.testing.assert_array_equal(
        cv2.imread(str(files["port"]), cv2.IMREAD_COLOR),
        cv2.imread(str(files["jax"]), cv2.IMREAD_COLOR))


def test_predict_output_jp2_under_32_pixels_in_both_clis(workdir, tmp_path,
                                                         capsys):
    """A 24x40 image: cv2.imwrite refuses a .jp2 with a side under 32
    after OpenJPEG has written the JP2 boxes, so the JAX CLI's file holds
    those 77 bytes and no codestream; the port's holds the same bytes,
    and both print "wrote"."""
    scene = image_io.read_image(workdir["image"])
    image = tmp_path / "small.png"
    image_io.write_png(image, np.ascontiguousarray(scene[:24, :40]))
    files = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        files[name] = tmp_path / f"{name}.jp2"
        _run(main, ["predict", "--model-dir", workdir["model"], "--image",
                    str(image), "--output", str(files[name])] + extra)
        assert f"wrote {files[name]}" in capsys.readouterr().err
    assert files["port"].read_bytes() == files["jax"].read_bytes()
    assert len(files["port"].read_bytes()) == 77
    assert b"jp2c" not in files["port"].read_bytes()


def test_predict_webp_in_and_out_matches_jax_cli_pixels(workdir, tmp_path,
                                                        monkeypatch):
    """Both CLIs read a lossless .webp scene and write `--output x.webp`
    from the same pixels (each drawing replaced by the input image, as
    the JPEG test does): cv2 reads both files to equal pixels, the
    scene's own; the port's is a lossless RIFF…WEBPVP8L file (its bytes
    are not libwebp's)."""
    from multiposenet_tpu.utils import visualize as jax_visualize

    for module in (jax_visualize, visualize):
        monkeypatch.setattr(module, "draw_predictions",
                            lambda rgb, people: rgb.copy())
    scene = image_io.read_image(workdir["image"])
    image = tmp_path / "scene.webp"
    ok, buf = cv2.imencode(".webp", np.ascontiguousarray(scene[:, :, ::-1]))
    image.write_bytes(buf.tobytes())
    files, printed = {}, {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        files[name] = tmp_path / f"{name}.webp"
        printed[name] = json.loads(_run(
            main, ["predict", "--model-dir", workdir["model"], "--image",
                   str(image), "--output", str(files[name])] + extra))
    assert ok and len(printed["port"]) == len(printed["jax"]) > 0
    data = files["port"].read_bytes()
    assert data[:4] == b"RIFF" and data[8:16] == b"WEBPVP8L"
    for name in ("jax", "port"):
        np.testing.assert_array_equal(
            cv2.imread(str(files[name]), cv2.IMREAD_COLOR)[:, :, ::-1],
            scene)


def test_predict_jpeg_tiff_in_hdr_out_matches_jax_cli(workdir, tmp_path,
                                                     monkeypatch):
    """Both CLIs read a JPEG-compressed TIFF (cv2's JPEG of the scene as a
    YCbCr 4:2:0 strip) and print the same people; with each drawing
    replaced by the input image (as the JPEG test does), `--output x.hdr`
    is the same file byte for byte, cv2.imwrite's."""
    from multiposenet_tpu.utils import visualize as jax_visualize
    from multiposenet_tpu_torch.tools import image_samples

    scene = image_io.read_image(workdir["image"])
    ok, stream = cv2.imencode(".jpg", np.ascontiguousarray(scene[:, :, ::-1]))
    image = tmp_path / "scene.tif"
    image.write_bytes(image_samples.tiff_bytes(
        scene, 6, compression=7, chunks=[stream.tobytes()],
        tags=((530, 3, [2, 2]),)))
    printed = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        printed[name] = json.loads(_run(
            main, ["predict", "--model-dir", workdir["model"], "--image",
                   str(image)] + extra))
    assert ok and len(printed["port"]) == len(printed["jax"]) > 0
    for g, w in zip(printed["port"], printed["jax"]):
        np.testing.assert_allclose(g["box"], w["box"], atol=2e-3, rtol=1e-5)
        assert abs(g["score"] - w["score"]) <= 1e-5
        np.testing.assert_allclose(g["keypoints"], w["keypoints"],
                                   atol=1e-3, rtol=1e-5)
    for module in (jax_visualize, visualize):
        monkeypatch.setattr(module, "draw_predictions",
                            lambda rgb, people: rgb.copy())
    files = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        files[name] = tmp_path / f"{name}.hdr"
        _run(main, ["predict", "--model-dir", workdir["model"], "--image",
                    str(image), "--output", str(files[name])] + extra)
    assert files["port"].read_bytes() == files["jax"].read_bytes()
    np.testing.assert_array_equal(
        image_io.read_image(files["port"]),
        cv2.imread(str(files["jax"]), cv2.IMREAD_COLOR)[:, :, ::-1])


@pytest.mark.parametrize("command,flags", [
    ("prepare", ["--output-dir", "--shard-size", "--max-persons",
                 "--coco-json", "--image-dir", "--synthetic", "--device"]),
    ("train-prn", ["--steps", "--model-dir", "--synthetic", "--config",
                   "--device"])])
def test_train_commands_are_registered(command, flags):
    """`prepare` and `train-prn` take the JAX package's flags (and
    `--device`); `prepare` without --output-dir exits as the JAX
    package's does (runs: tests/test_torch_prepare.py and
    tests/test_torch_prn_train.py)."""
    out = io.StringIO()
    with pytest.raises(SystemExit) as exit_, contextlib.redirect_stdout(out):
        cli.main([command, "--help"])
    assert exit_.value.code == 0
    for flag in flags:
        assert flag in out.getvalue()
    if command == "prepare":
        with pytest.raises(SystemExit), contextlib.redirect_stderr(
                io.StringIO()):
            cli.main([command])


# --- TF checkpoint import ---------------------------------------------------


def _params(cfg):
    return jax.tree.map(np.asarray, posenet_variables(cfg, 64)["params"])


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(dict(want))
    assert list(got) == list(want)
    for path in want:
        assert got[path].dtype == np.asarray(want[path]).dtype, path
        np.testing.assert_array_equal(got[path], np.asarray(want[path]),
                                      err_msg=path)


@pytest.mark.parametrize("name", ["default", "fast"])
def test_slim_name_map_matches_jax_on_every_path(name):
    cfg = tiny_default_config() if name == "default" else tiny_config()
    paths = list(_flat(_params(cfg)))
    mapped = [p for p in paths if export.mobilenet_v1_slim_name_map(p)]
    assert len(mapped) > 20
    for path in paths:
        assert (export.mobilenet_v1_slim_name_map(path)
                == jax_export.mobilenet_v1_slim_name_map(path)), path


def test_import_tf_checkpoint_by_name_matches_jax(tmp_path):
    tf = pytest.importorskip("tensorflow")
    params = _params(tiny_config())
    shape = params["backbone"]["stem"]["conv"]["kernel"].shape
    value = np.random.RandomState(0).rand(*shape).astype(np.float32)
    ckpt = tf.train.Checkpoint(w=tf.Variable(value))
    path = ckpt.save(str(tmp_path / "ck"))
    name_map = {"backbone/stem/conv/kernel": "w/.ATTRIBUTES/VARIABLE_VALUE"}
    got = export.import_tf_checkpoint(path, params, name_map)
    want = jax_export.import_tf_checkpoint(path, params, name_map)
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(got["backbone"]["stem"]["conv"]["kernel"],
                                  value)


def test_import_slim_checkpoint_matches_jax(tmp_path):
    """A TF-slim MobileNetV1 checkpoint (depthwise kernels stored
    (H, W, C, 1)) imported through `mobilenet_v1_slim_name_map`: the
    JAX package's tree, every backbone leaf replaced."""
    tf = pytest.importorskip("tensorflow")
    params = _params(tiny_config())
    rng = np.random.RandomState(1)
    tensors = {}
    for path, value in _flat(params).items():
        name = export.mobilenet_v1_slim_name_map(path)
        if name is None:
            continue
        arr = rng.rand(*value.shape).astype(np.float32)
        if name.endswith("depthwise_weights"):
            arr = arr.transpose(0, 1, 3, 2)
        tensors[name] = arr
    graph = tf.Graph()
    with graph.as_default():
        variables = [tf.compat.v1.get_variable(n, initializer=t)
                     for n, t in tensors.items()]
        saver = tf.compat.v1.train.Saver(variables)
        with tf.compat.v1.Session(graph=graph) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            path = saver.save(sess, str(tmp_path / "model.ckpt"))
    got = export.import_tf_checkpoint(path, params,
                                      export.mobilenet_v1_slim_name_map)
    want = jax_export.import_tf_checkpoint(
        path, params, jax_export.mobilenet_v1_slim_name_map)
    _assert_trees_equal(got, want)
    flat_got, flat_in = _flat(got), _flat(params)
    replaced = [p for p in flat_in
                if not np.array_equal(flat_got[p], flat_in[p])]
    assert len(replaced) == len(tensors)


def test_import_tf_checkpoint_shape_mismatch_raises(tmp_path):
    tf = pytest.importorskip("tensorflow")
    params = _params(tiny_config())
    ckpt = tf.train.Checkpoint(w=tf.Variable(np.zeros((1, 2), np.float32)))
    path = ckpt.save(str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="shape mismatch"):
        export.import_tf_checkpoint(
            path, params,
            {"backbone/stem/conv/kernel": "w/.ATTRIBUTES/VARIABLE_VALUE"})


def test_import_tf_checkpoint_without_tensorflow_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="tensorflow"):
        export.import_tf_checkpoint("unused", {"a": np.zeros(1)}, {})


def test_chip_smoke_cli_phases_rehearse_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's `eval_batched`, `eval_predict` and `cli_predict`
    phases at a small size on the CPU: the card's synchronize is a no-op,
    the predictor's default device the CPU, and each decode counts the
    kernel `route` picks for it, as the card's wrapper would. Their launch
    counts (one B1 a batch and a request) and checks hold."""
    from multiposenet_tpu_torch import kernels
    from multiposenet_tpu_torch.config import Config
    from multiposenet_tpu_torch.data import synthetic
    from multiposenet_tpu_torch.eval import runner
    from multiposenet_tpu_torch.infer import predictor
    from multiposenet_tpu_torch.ops import decode

    from torch_port_helpers import chip_smoke_module

    smoke = chip_smoke_module()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(predictor, "resolve_device",
                        lambda device: torch.device(device or "cpu"))
    plain = decode.decode_maps

    def counted(hm, config=decode.DecodeConfig()):
        kernels.count_launch(decode.route(hm, config))
        return plain(hm, config)

    monkeypatch.setattr(decode, "decode_maps", counted)
    restored = (runner.KeypointEvaluator, runner.evaluate_batched,
                predictor.Predictor.predict, cli._load_records)
    monkeypatch.setattr(smoke, "IMAGE", 64)
    monkeypatch.setattr(smoke, "EVAL_IMAGES", 5)
    monkeypatch.setattr(smoke, "EVAL_BATCH", 4)
    monkeypatch.setattr(smoke, "EVAL_PREDICT_IMAGES", 2)
    paths = smoke.phase_eval(Config, predictor.Predictor, export, cli,
                             runner, decode, kernels, tmp_path, "cpu")
    paths["cli_predict"] = smoke.phase_cli_predict(
        cli, image_io, visualize, synthetic, decode, kernels, tmp_path,
        "cpu")
    assert paths == {"eval_batched": 2, "eval_predict": 2, "cli_predict": 16}
    assert restored == (runner.KeypointEvaluator, runner.evaluate_batched,
                        predictor.Predictor.predict, cli._load_records)


def test_chip_smoke_image_phases_rehearse_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's `image_codec` and `eval_jpeg` phases on the CPU,
    after `phase_eval` exported its model at a small size: the fixtures
    decode and resize to cv2's digests through the C library and the
    plain versions, their corruption recipes read as cv2 read them (the
    `corrupt` part), the photo encodes to cv2's digest (JPEG, and GIF with
    every fixture, and JPEG 2000 with every fixture of both sides at
    least 32), the AVIF files decode through the C and plain decoders, and
    the JPEG eval and the five predicts count their B1 launches (2, 1, 1,
    1, 1 and 1) as the card's wrapper would, the third writing
    `drawn.gif`, the fourth `drawn.jp2`, the fifth `drawn.avif`; the AVIF
    writer encodes the photo to the committed cv2 file, C and plain
    equal on a crop."""
    from multiposenet_tpu_torch import kernels
    from multiposenet_tpu_torch.config import Config
    from multiposenet_tpu_torch.eval import runner
    from multiposenet_tpu_torch.infer import predictor
    from multiposenet_tpu_torch.ops import decode
    from multiposenet_tpu_torch.utils import image_codec, jpeg

    from torch_port_helpers import chip_smoke_module

    smoke = chip_smoke_module()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(predictor, "resolve_device",
                        lambda device: torch.device(device or "cpu"))
    plain = decode.decode_maps

    def counted(hm, config=decode.DecodeConfig()):
        kernels.count_launch(decode.route(hm, config))
        return plain(hm, config)

    monkeypatch.setattr(decode, "decode_maps", counted)
    monkeypatch.setattr(smoke, "IMAGE", 64)
    monkeypatch.setattr(smoke, "EVAL_IMAGES", 2)
    monkeypatch.setattr(smoke, "EVAL_BATCH", 2)
    monkeypatch.setattr(smoke, "EVAL_PREDICT_IMAGES", 1)
    lines = []
    monkeypatch.setattr(smoke, "emit", lines.append)
    smoke.phase_image_codec(image_io, image_codec, jpeg, "cpu")
    smoke.phase_eval(Config, predictor.Predictor, export, cli, runner,
                     decode, kernels, tmp_path, "cpu")
    paths = smoke.phase_eval_jpeg(cli, image_io, visualize, jpeg, decode,
                                  kernels, tmp_path, "cpu")
    assert paths == {"eval_jpeg_batched": 2, "cli_predict_jpeg": 1,
                     "cli_predict_jpeg_output": 1,
                     "cli_predict_gif_output": 1,
                     "cli_predict_jp2_output": 1,
                     "cli_predict_avif_output": 1}
    codec, jpeg_row = lines[0], lines[-1]
    assert codec["phase"] == "image_codec" and len(codec["fixtures"]) == 116
    assert codec["webp"]["fixtures_written"] == 116
    assert codec["tiff_hdr"]["fixtures"] == 30
    assert codec["gif"]["fixtures"] == 116
    assert codec["gif"]["times"]["gif"]["c_encode_ms"] > 0
    j2k = codec["jpeg2000"]
    assert sorted(j2k["fixtures"]) == ["j2k_irr_rpcl_layers3_37x53.j2k",
                                       "j2k_rev_gray_37x53.jp2"]
    assert j2k["build_s"] > 0 and all(
        t["c_decode_ms"] > 0 and t["plain_decode_s"] > 0
        for t in j2k["fixtures"].values())
    corrupt = codec["corrupt"]
    assert corrupt["recipes"] == 49 and corrupt["read"] > 0 \
        and corrupt["refused"] > 0 and corrupt["plain"] > 0
    assert corrupt["photo_corrupt_c_decode_ms"] > 0
    assert codec["webp"]["ratio_max"][1] <= 1.5
    assert codec["c_decode_ms"] > 0 and codec["letterbox"] == [384, 512]
    assert codec["encode"]["c_encode_ms"] > 0
    jp2 = codec["jpeg2000_write"]
    assert jp2["fixtures"] == 80 and len(jp2["boxes_only"]) == 36
    assert len(jp2["plain_fixtures"]) >= 4
    assert jp2["times"]["photo"]["c_encode_ms"] > 0
    avif = codec["avif"]
    assert len(avif["fixtures"]) == 21 and avif["build_s"] > 0
    assert all(avif["tools"][n][c] > 0 and avif["tools"][n][
        "tiles_and_filters_ms"] > 0 for n, c in smoke.AVIF_TOOLS.items())
    assert avif["plain_on"] == ["avif_odd_33x17.avif",
                                "avif_alpha_24x32.avif",
                                "avif_12bit_64x80.avif",
                                "avif_422_10bit_64x80.avif",
                                "avif_aq_sequence2_48x64.avif"]
    assert sorted(avif["grain"]) == sorted(
        list(smoke.AVIF_GRAIN) + ["avif_photo_480x640.avif"])
    assert all(avif["grain"][n]["grain_ms"] > 0
               and avif["grain"][n]["grain_share_of_c_decode"] > 0
               for n in ("avif_grain_96x128.avif",
                         "avif_grain_csfl_10bit_444_64x80.avif"))
    assert sorted(avif["forms"]) == sorted(
        list(smoke.AVIF_FORMS) + ["avif_photo_480x640.avif"])
    assert all(t["c_decode_us_per_pixel"] > 0
               for t in avif["forms"].values())
    assert {n: t["bit_depth"] for n, t in avif["depths"].items()} == {
        "avif_10bit_96x128.avif": 10, "avif_12bit_64x80.avif": 12,
        "avif_photo_480x640.avif": 8}
    assert all(t["c_decode_us_per_pixel"] > 0
               for t in avif["depths"].values())
    assert all(t["c_decode_ms"] > 0 for t in avif["fixtures"].values())
    assert all(avif["fixtures"][n]["plain_decode_s"] > 0
               for n in avif["plain_on"])
    assert jpeg_row["phase"] == "eval_jpeg" and jpeg_row["images"] == 10
    assert jpeg_row["output_avif_bytes"] > 0
    assert jpeg_row["output_avif_psnr_db"] > 20
    avif_write = codec["avif_write"]
    assert avif_write["build_s"] > 0 and avif_write["photo_bytes"] == len(
        (smoke.FIXTURES / smoke.AVIF_PREDICT).read_bytes())
    assert avif_write["times"]["photo"]["c_encode_ms"] > 0
    assert avif_write["times"]["crop"]["plain_encode_s"] > 0
    assert jpeg_row["output_jp2_bytes"] > 0
    assert jpeg_row["output_gif_bytes"] > 0
    assert jpeg_row["output_jpg_bytes"] > 0
