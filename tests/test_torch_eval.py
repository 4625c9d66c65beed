"""The port's evaluation (`multiposenet_tpu_torch.eval`) against the JAX
package's `eval/oks.py` and `eval/runner.py`.

- `KeypointEvaluator`: the same operations in the same order, so the
  stats are equal exactly on seeded ground truths and detections (crowd
  GTs, unlabeled keypoints, zero-area boxes, keypoint-less GTs with and
  without a box, more detections than maxDets, images without GT or
  without detections).
- Both runner loops fed by one stub predictor (the same planted outputs,
  ground truth jittered so that AP lies strictly between 0 and 1): equal
  stats exactly, through the batched loop's padded last chunk, its
  per-image scales and its clipping.
- `evaluate_predictor` on real tiny fast() predictors loaded from one
  JAX export (float32; the JAX side runs its jnp decode, as on any CPU).
  Their detections agree to 1e-3 px and 1e-5 in score
  (test_torch_predictor.py), so an OKS moves by less than 1e-4 and only
  a match within that of a threshold can flip; one flip at one of the 10
  thresholds among the ~50 ground truths here moves a stat by at most
  1/(10 x 10) of its range: the stats are held to 0.01, and the
  detections themselves to those tolerances.
- The batched loop's assembled uint8 batches on the committed JPEG
  fixtures: the JAX runner's (cv2 read and resize) bit for bit.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from multiposenet_tpu.eval import oks as jax_oks
from multiposenet_tpu.eval import runner as jax_runner
from multiposenet_tpu.infer import export as jax_export
from multiposenet_tpu.infer.predictor import PersonPrediction as JaxPerson
from multiposenet_tpu_torch.data.synthetic import make_dataset
from multiposenet_tpu_torch.eval import oks, runner
from multiposenet_tpu_torch.infer import export
from multiposenet_tpu_torch.infer.predictor import PersonPrediction

from eval_fixtures import jitter_people, planted_annotations
from torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (autouse)
    posenet_variables,
    prn_variables,
    tiny_config,
)

STAT_KEYS = {"AP", "AP50", "AP75", "AR", "AR50", "APM", "ARM", "APL",
             "ARL"}


def _random_image(rng, n_gt: int, n_dt: int):
    """(gt args, dt args) of one image, as plain tuples for both
    packages' dataclasses."""
    gts, dts = [], []
    for g in range(n_gt):
        k = np.zeros((17, 3), np.float32)
        k[:, 0] = rng.uniform(0, 200, 17)
        k[:, 1] = rng.uniform(0, 150, 17)
        k[:, 2] = rng.choice([0.0, 1.0, 2.0], 17, p=[0.2, 0.2, 0.6])
        kind = g % 6
        if kind == 4:          # no labeled keypoint: the bbox branch
            k[:, 2] = 0.0
        area = [0.0, 30.0 ** 2, 96.0 ** 2, 200.0 ** 2, 64.0 ** 2,
                50.0 ** 2][kind]
        bbox = (None if kind == 5 and g % 2 else
                np.array([k[:, 0].min(), k[:, 1].min(), 40.0, 60.0],
                         np.float32))
        gts.append((k, area, kind == 3 or g % 7 == 6, bbox))
    for d in range(n_dt):
        if gts and d < 2 * len(gts):
            base = gts[d % len(gts)][0][:, :2]
            xy = base + rng.normal(0, [0.5, 3.0, 10.0][d % 3], base.shape)
        else:
            xy = np.c_[rng.uniform(0, 200, 17), rng.uniform(0, 150, 17)]
        k = np.c_[xy, rng.rand(17)].astype(np.float32)
        dts.append((k, float(rng.rand()), None if d % 4 else 2000.0))
    return gts, dts


def _evaluate(mod, images):
    ev = mod.KeypointEvaluator()
    for gts, dts in images:
        ev.add_image(
            [mod.GroundTruth(keypoints=k, area=a, iscrowd=c, bbox=b)
             for k, a, c, b in gts],
            [mod.DetectionKP(keypoints=k, score=s, area=a)
             for k, s, a in dts])
    return ev.summarize()


@pytest.mark.parametrize("seed", range(4))
def test_keypoint_evaluator_matches_jax(seed):
    rng = np.random.RandomState(seed)
    counts = [(3, 5), (0, 4), (4, 0), (6, 25), (1, 1), (12, 30), (2, 3)]
    images = [_random_image(rng, g, d) for g, d in counts]
    want = _evaluate(jax_oks, images)
    got = _evaluate(oks, images)
    assert set(got) == STAT_KEYS
    assert got == want
    assert 0.0 < want["AP"] < 1.0


def test_compute_oks_matches_jax():
    rng = np.random.RandomState(9)
    for (k, a, c, b), (dk, _, _) in zip(*_random_image(rng, 6, 6)):
        want = jax_oks.compute_oks(dk, jax_oks.GroundTruth(k, a, c, b))
        assert oks.compute_oks(dk, oks.GroundTruth(k, a, c, b)) == want


def test_empty_evaluator_matches_jax():
    assert oks.KeypointEvaluator().summarize() == \
        jax_oks.KeypointEvaluator().summarize()


# --- the runner loops on one stub predictor --------------------------------

SIZE = 64


def _records():
    """Non-square images larger and smaller than SIZE (down- and
    upscaled), 7 of them so a batch of 3 ends padded."""
    return (make_dataset(3, img_h=90, img_w=70, seed=1)
            + make_dataset(2, img_h=40, img_w=56, seed=2)
            + make_dataset(2, img_h=64, img_w=100, seed=3))


def _planted(records, seed: int):
    """Per record: (keypoints [P, 17, 3] in image coordinates, some pushed
    outside it, scores [P], boxes [P, 4]): the GT jittered, plus a false
    positive."""
    rng = np.random.RandomState(seed)
    out = []
    for rec in records:
        kps = jitter_people(rec["keypoints"], rng)
        fp = np.stack([rng.uniform(-10, rec["width"] + 10, 17),
                       rng.uniform(-10, rec["height"] + 10, 17),
                       rng.rand(17)], -1)[None].astype(np.float32)
        kps = np.concatenate([kps, fp]).astype(np.float32)
        kps[:, :, 2] = rng.rand(*kps.shape[:2])
        boxes = np.concatenate([rec["boxes"], [[0, 0, 10, 10]]])
        out.append((kps, rng.rand(len(kps)).astype(np.float32),
                    boxes.astype(np.float32)))
    return out


class StubPredictor:
    """Serves planted outputs in the order the runners ask for them:
    `predict` per record in original coordinates, and the batch runner
    per chunk in model-input coordinates (scaled by SIZE / max(h, w), as
    the runner will undo), as numpy for the JAX runner and as tensors for
    the port's."""

    image_size = SIZE

    def __init__(self, records, planted, batch_size, port: bool):
        self.records, self.planted = records, planted
        self.batch_size, self.port = batch_size, port
        self.calls = 0

    def predict(self, image):
        kps, scores, boxes = self.planted[self.calls]
        assert image.shape[:2] == self.records[self.calls]["image"].shape[:2]
        self.calls += 1
        person = PersonPrediction if self.port else JaxPerson
        return [person(box=boxes[i], score=float(scores[i]),
                       keypoints=kps[i].copy()) for i in range(len(kps))]

    def make_batch_runner(self, mesh=None):
        assert mesh is None
        return self._run

    def _run(self, images):
        b = self.batch_size
        assert images.shape == (b, SIZE, SIZE, 3)
        start = self.calls * b
        self.calls += 1
        d = max(len(p[0]) for p in self.planted)
        out = {"box_scores": np.zeros((b, d), np.float32),
               "box_valid": np.zeros((b, d), bool),
               "keypoints": np.zeros((b, d, 17, 3), np.float32)}
        for i, r in enumerate(range(start, min(start + b,
                                               len(self.records)))):
            kps, scores, _ = self.planted[r]
            rec = self.records[r]
            scale = np.float32(SIZE / max(rec["height"], rec["width"]))
            n = len(kps)
            out["keypoints"][i, :n] = kps
            out["keypoints"][i, :n, :, :2] *= scale
            out["box_scores"][i, :n] = scores
            out["box_valid"][i, :n] = np.arange(n) % 4 != 3
        if self.port:
            return {k: torch.as_tensor(v) for k, v in out.items()}
        return out


@pytest.mark.parametrize("loop", ["predict", "batched"])
def test_runner_loops_match_jax_on_a_stub(loop):
    records = _records()
    planted = _planted(records, seed=4)
    stats = {}
    for name, mod in (("jax", jax_runner), ("port", runner)):
        stub = StubPredictor(records, planted, 3, port=name == "port")
        if loop == "predict":
            stats[name] = mod.evaluate_predictor(stub, records)
        else:
            stats[name] = mod.evaluate_batched(stub, records, batch_size=3)
        assert stub.calls == (len(records) if loop == "predict" else 3)
    assert set(stats["port"]) == STAT_KEYS
    assert stats["port"] == stats["jax"]
    assert 0.0 < stats["jax"]["AP"] < 1.0


def test_predict_loop_honours_max_images():
    records = _records()
    planted = _planted(records, seed=5)
    got = runner.evaluate_predictor(
        StubPredictor(records, planted, 3, port=True), records,
        max_images=4)
    want = jax_runner.evaluate_predictor(
        StubPredictor(records, planted, 3, port=False), records,
        max_images=4)
    assert got == want


def test_record_ground_truths_match_jax():
    rec = _records()[0]
    for g, w in zip(runner.record_ground_truths(rec),
                    jax_runner.record_ground_truths(rec)):
        np.testing.assert_array_equal(g.keypoints, w.keypoints)
        np.testing.assert_array_equal(g.bbox, w.bbox)
        assert (g.area, g.iscrowd) == (w.area, w.iscrowd)


# --- evaluate_predictor on real predictors from one JAX export -------------

REAL_SIZE = 128


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    cfg = tiny_config("float32")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                image_size=REAL_SIZE))
    directory = tmp_path_factory.mktemp("export")
    jax_export.save_model(directory, cfg, posenet_variables(cfg),
                          prn_variables(cfg))
    return directory


def _spied(evaluator_cls, seen: list):
    class Spy(evaluator_cls):
        def add_image(self, gts, dts):
            seen.append(dts)
            super().add_image(gts, dts)
    return Spy


def test_evaluate_predictor_on_real_predictors_matches_jax(exported,
                                                           monkeypatch):
    port = export.load_predictor(exported, device="cpu")
    jax_pred = jax_export.load_predictor(exported)
    assert port.image_size == jax_pred.image_size == REAL_SIZE
    records = make_dataset(4, img_h=100, img_w=140, seed=6)
    rng = np.random.RandomState(7)
    for rec in records:  # ground truth planted around the detections
        people = port.predict(rec["image"])
        anns = planted_annotations(
            np.stack([p.box for p in people]),
            np.stack([p.keypoints for p in people]), rng, 100, 140)
        rec["keypoints"] = np.array([a["keypoints"] for a in anns],
                                    np.float32).reshape(-1, 17, 3)
        rec["boxes"] = np.array([[y, x, y + h, x + w] for x, y, w, h in
                                 (a["bbox"] for a in anns)], np.float32)
        rec["iscrowd"] = np.array([a["iscrowd"] for a in anns], bool)
        rec["area"] = np.array([a["area"] for a in anns], np.float32)
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jax_runner, "KeypointEvaluator",
                        _spied(jax_oks.KeypointEvaluator, seen["jax"]))
    monkeypatch.setattr(runner, "KeypointEvaluator",
                        _spied(oks.KeypointEvaluator, seen["port"]))
    want = jax_runner.evaluate_predictor(jax_pred, records)
    got = runner.evaluate_predictor(port, records)

    assert sum(map(len, seen["jax"])) > 0
    for dts_got, dts_want in zip(seen["port"], seen["jax"], strict=True):
        assert len(dts_got) == len(dts_want)
        for g, w in zip(dts_got, dts_want):
            assert abs(g.score - w.score) <= 1e-5
            np.testing.assert_allclose(g.keypoints, w.keypoints, atol=1e-3,
                                       rtol=1e-5)
    assert 0.0 < want["AP"] < 1.0
    assert set(got) == STAT_KEYS
    for key in STAT_KEYS:
        assert abs(got[key] - want[key]) <= 0.01, key


# --- the batched loop's pixels ---------------------------------------------

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"


class CapturingPredictor:
    """Keeps every uint8 batch the batched loop assembles and answers
    with no detections."""

    def __init__(self, size: int, port: bool):
        self.image_size, self.port = size, port
        self.batches = []

    def make_batch_runner(self, mesh=None):
        return self._run

    def _run(self, images):
        self.batches.append(np.array(images))
        b = len(images)
        out = {"box_scores": np.zeros((b, 2), np.float32),
               "box_valid": np.zeros((b, 2), bool),
               "keypoints": np.zeros((b, 2, 17, 3), np.float32)}
        if self.port:
            return {k: torch.as_tensor(v) for k, v in out.items()}
        return out


@pytest.mark.parametrize("size", [64, 300, 512])
def test_batched_loop_assembles_the_jax_runners_pixels(size):
    """The committed JPEG scenes (every sampling cv2 writes, gray, q 50 to
    95) through both runners' batched loops: the port reads them with
    `read_image` and resizes with `resize_linear`, the JAX package with
    cv2.imread and cv2.resize; the uint8 batches are equal bit for bit,
    down- and upscaled (512: the heights upscaled 192 → 384)."""
    from multiposenet_tpu_torch.data.coco import load_coco_keypoints

    records = load_coco_keypoints(FIXTURES / "annotations.json")
    assert len(records) == 10
    got = CapturingPredictor(size, port=True)
    want = CapturingPredictor(size, port=False)
    runner.evaluate_batched(got, records, batch_size=4,
                            image_dir=str(FIXTURES))
    jax_runner.evaluate_batched(want, records, batch_size=4,
                                image_dir=str(FIXTURES))
    assert len(got.batches) == len(want.batches) == 3
    for g, w in zip(got.batches, want.batches):
        assert g.dtype == np.uint8 and g.shape == (4, size, size, 3)
        np.testing.assert_array_equal(g, w)
    assert got.batches[0].any()
