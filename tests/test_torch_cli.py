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
changed, and any other `--output` suffix exits before the model runs.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import sys

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
from multiposenet_tpu_torch.utils import image_io, visualize

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


@pytest.mark.parametrize("output", ["drawn.jpg", "drawn.JPEG", "drawn"])
def test_predict_output_other_than_png_exits(workdir, tmp_path, monkeypatch,
                                             output):
    """The reference writes by suffix through cv2.imwrite; the port
    writes PNG only, so it exits naming the suffix before the model is
    loaded, and writes nothing."""
    from multiposenet_tpu_torch.infer import export as port_export

    def no_model(*args, **kwargs):
        raise AssertionError("the model was loaded")

    monkeypatch.setattr(port_export, "load_predictor", no_model)
    suffix = output.rpartition(".")[2] if "." in output else "none"
    with pytest.raises(SystemExit, match=f"suffix .?{suffix}.*only PNG"):
        cli.main(["predict", "--model-dir", workdir["model"], "--image",
                  workdir["image_jpeg"], "--output", str(tmp_path / output),
                  "--device", "cpu"])
    assert not (tmp_path / output).exists()


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
    assert paths == {"eval_batched": 2, "eval_predict": 2, "cli_predict": 1}
    assert restored == (runner.KeypointEvaluator, runner.evaluate_batched,
                        predictor.Predictor.predict, cli._load_records)


def test_chip_smoke_image_phases_rehearse_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's `image_codec` and `eval_jpeg` phases on the CPU,
    after `phase_eval` exported its model at a small size: the fixtures
    decode and resize to cv2's digests through the C library and the
    plain versions, and the JPEG eval and predict count their B1 launches
    (2 and 1) as the card's wrapper would."""
    from multiposenet_tpu_torch import kernels
    from multiposenet_tpu_torch.config import Config
    from multiposenet_tpu_torch.eval import runner
    from multiposenet_tpu_torch.infer import predictor
    from multiposenet_tpu_torch.ops import decode
    from multiposenet_tpu_torch.utils import image_codec, jpeg

    from torch_port_helpers import chip_smoke_module

    smoke = chip_smoke_module()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
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
    paths = smoke.phase_eval_jpeg(cli, image_io, visualize, decode, kernels,
                                  tmp_path, "cpu")
    assert paths == {"eval_jpeg_batched": 2, "cli_predict_jpeg": 1}
    codec, jpeg_row = lines[0], lines[-1]
    assert codec["phase"] == "image_codec" and len(codec["fixtures"]) == 33
    assert codec["c_decode_ms"] > 0 and codec["letterbox"] == [384, 512]
    assert jpeg_row["phase"] == "eval_jpeg" and jpeg_row["images"] == 10
    assert ".jpg" in jpeg_row["output_jpg_exit"]
