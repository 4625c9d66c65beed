"""chip_smoke.py's `train_to_ap` phase rehearsed on the CPU at a few steps,
and the two training tools (`multiposenet_tpu_torch/tools/
train_synthetic_demo.py`, `train_synthetic_512.py`) at a few steps against
the JAX package's scripts (`benchmarks/train_synthetic_demo.py`,
`benchmarks/train_synthetic_512.py`): the same flags (the port adds
`--device`), the same JSON keys, the statistics under the JAX
evaluator's keys and the training lines under the JAX loop's."""

import contextlib
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multiposenet_tpu.eval.oks import KeypointEvaluator as JaxEvaluator
from multiposenet_tpu_torch import config as config_mod
from multiposenet_tpu_torch import kernels, weights
from multiposenet_tpu_torch.data import loader, synthetic
from multiposenet_tpu_torch.eval import oks, runner
from multiposenet_tpu_torch.infer.predictor import Predictor
from multiposenet_tpu_torch.ops import decode
from multiposenet_tpu_torch.tools import train_synthetic_512 as tool512
from multiposenet_tpu_torch.tools import train_synthetic_demo as demo
from multiposenet_tpu_torch.train import loop, prn_train, steps

from test_torch_train_loop import _rehearsal
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    chip_smoke_module, one_torch_thread,
)

ROOT = Path(__file__).resolve().parent.parent
STAT_KEYS = sorted(JaxEvaluator().summarize())
TRAIN_KEYS = sorted(["heatmap_loss", "segmentation_loss", "cls_loss",
                     "box_loss", "detector_loss", "total_loss", "grad_norm",
                     "step", "images_per_sec"])
TINY_RECIPE = {"train_records": 16, "eval_records": 2, "steps": 3,
               "warmup": 1, "prn_steps": 2}
TINY_512_ARGV = ["--style", "v1", "--steps", "2", "--prn-steps", "1",
                 "--batch-size", "2", "--train-images", "4",
                 "--eval-images", "1"]
OPEN_FLOORS = {"gtbox": {"AP50": -1.0, "AP": -1.0, "AP75": -1.0},
               "e2e": {"AP50": -1.0, "AR50": -1.0},
               "mean_err_hm_px": float("inf")}


def _jax_script(name: str) -> str:
    return (ROOT / "benchmarks" / f"{name}.py").read_text()


def _flags(source: str) -> list[str]:
    return sorted(re.findall(r'add_argument\(\s*"(--[\w-]+)"', source))


def _json_keys(source: str) -> list[str]:
    """The first keys of the dicts the script prints with json.dumps."""
    return re.findall(r'json\.dumps\(\{\s*"(\w+)"', source)


def _phase(monkeypatch, tmp_path, floors=OPEN_FLOORS, floors_512=None):
    smoke, lines, _ = _rehearsal(monkeypatch)
    monkeypatch.setattr(smoke, "AP_RECIPE", TINY_RECIPE)
    monkeypatch.setattr(smoke, "FAST_512_ARGV", TINY_512_ARGV)
    monkeypatch.setattr(smoke, "AP_FLOORS", floors)
    monkeypatch.setattr(smoke, "FAST_512_FLOORS", floors_512 or {
        "e2e_512": -1.0, "gtbox_512": -1.0})
    kernels.reset_launches()
    launches = smoke.phase_train_to_ap(
        config_mod, synthetic, loader, loop, prn_train, steps, weights,
        Predictor, oks, runner, tool512, decode, kernels,
        torch.device("cpu"), tmp_path, "cpu")
    return launches, lines


def test_chip_smoke_train_to_ap_rehearses_on_cpu(monkeypatch, tmp_path):
    """Both parts at a few steps with the floors open: one line each with
    the statistics under the JAX evaluator's keys, and B1 counted once for
    each eval `predict` and `predict_given_boxes` (2 eval scenes at 96²;
    1 at 512², through pool 128, the GT boxes and pool 256)."""
    launches, lines = _phase(monkeypatch, tmp_path)
    assert launches == {"train_to_ap_96": 4, "train_to_ap_512": 3}
    r96, r512 = lines
    assert r96["phase"] == r512["phase"] == "train_to_ap"
    assert r96["part"] == "train_to_ap_96" and r96["b1_launches"] == 4
    for k in ("gtbox", "e2e"):
        assert sorted(r96[k]) == STAT_KEYS
    assert np.isfinite(r96["mean_err_hm_px"]) and r96["missed"] == []
    assert r96["steps"] == 3 and r96["steps_per_s"] > 0
    assert sorted(r96["last_metrics"]) == TRAIN_KEYS
    assert r512["part"] == "train_to_ap_512" and r512["b1_launches"] == 3
    for k in ("e2e_512", "gtbox_512", "e2e_512_pool256"):
        assert sorted(r512[k]) == STAT_KEYS
        assert k in r512["reference"]
    for k in ("steps_per_s", "loader_img_per_s", "train_img_per_s",
              "train_s", "prn_s", "eval_s", "seconds"):
        assert r512[k] > 0, k
    assert set(r512["tf32_flags"]) == {"cudnn.allow_tf32",
                                       "cuda.matmul.allow_tf32"}


@pytest.mark.parametrize("part", ["train_to_ap_96", "train_to_ap_512"])
def test_chip_smoke_train_to_ap_raises_on_a_missed_floor(monkeypatch,
                                                         tmp_path, part):
    """A few steps miss the real floors: the part raises, after printing
    its line with what it missed."""
    real = chip_smoke_module()
    floors = real.AP_FLOORS if part == "train_to_ap_96" else OPEN_FLOORS
    with pytest.raises(AssertionError, match=f"{part}: missed"):
        _phase(monkeypatch, tmp_path, floors, real.FAST_512_FLOORS)


def _run_main(main, argv) -> list[dict]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]


def test_train_synthetic_512_main_prints_the_jax_scripts_keys():
    source = _jax_script("train_synthetic_512")
    parser_flags = _flags(Path(tool512.__file__).read_text())
    assert sorted(set(parser_flags) - {"--device"}) == _flags(source)
    lines = _run_main(tool512.main, TINY_512_ARGV + ["--device", "cpu"])
    results = [m for m in lines if "total_loss" not in m]
    assert [next(iter(m)) for m in results] == _json_keys(source) == [
        "e2e_512", "gtbox_512", "e2e_512_pool256"]
    assert results[0]["pool"] == 128
    for m in results:
        assert sorted(m[next(iter(m))]) == STAT_KEYS
    train_lines = [m for m in lines if "total_loss" in m]
    assert [m["step"] for m in train_lines] == [2]
    assert sorted(train_lines[0]) == TRAIN_KEYS


def test_train_synthetic_demo_main_prints_the_jax_scripts_keys():
    source = _jax_script("train_synthetic_demo")
    parser_flags = _flags(Path(demo.__file__).read_text())
    assert sorted(set(parser_flags) - {"--device"}) == _flags(source)
    lines = _run_main(demo.main, ["--steps", "2", "--prn-steps", "1",
                                  "--image-size", "64", "--eval-images", "2",
                                  "--device", "cpu"])
    assert list(lines[-1]) == _json_keys(source) == ["eval"]
    assert sorted(lines[-1]["eval"]) == STAT_KEYS
    assert [m["step"] for m in lines[:-1]] == [2]
    assert sorted(lines[0]) == TRAIN_KEYS
