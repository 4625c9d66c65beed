"""The port's training loop, checkpoints and `train` command
(`multiposenet_tpu_torch/train/loop.py`, `train/checkpoints.py`,
`cli.py`) on the CPU, at the tiny shapes of `__graft_entry__._tiny_config`
(64² images, batch 4): the checkpoint manager's decisions equal orbax's
(the JAX package's manager) step for step; four steps straight equal two,
a restart from the checkpoint and two more, bit for bit; the loop writes
the JAX loop's metric keys at the JAX loop's steps; more than one device
is refused; and `train --device cpu --synthetic 8 --steps 2 --model-dir`
exports a model that the JAX package's `infer/export.py` reads, its
Predictor's outputs on it within tests/test_torch_predictor.py's
tolerances of the port's."""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from multiposenet_tpu.data.synthetic import make_dataset
from multiposenet_tpu.infer import export as jax_export
from multiposenet_tpu.infer.predictor import Predictor as JaxPredictor
from multiposenet_tpu.train import steps as jsteps
from multiposenet_tpu_torch import cli
from multiposenet_tpu_torch.data.loader import make_batch
from multiposenet_tpu_torch.infer import export as port_export
from multiposenet_tpu_torch.infer.predictor import Predictor
from multiposenet_tpu_torch.ops.image import space_to_depth_flat4
from multiposenet_tpu_torch.train import loop, steps
from multiposenet_tpu_torch.train.checkpoints import CheckpointManager

from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, planted_images, to_numpy, torch_config_of,
)

SIZE, BATCH = 64, 4
BOX_TOL = dict(atol=2e-3, rtol=1e-5)   # tests/test_torch_predictor.py
SCORE_TOL = dict(atol=1e-5, rtol=1e-5)
KP_TOL = dict(atol=1e-3, rtol=1e-5)


def _jax_config(box_loss="huber", **train):
    cfg = _tiny_config(image_size=SIZE, batch_size=BATCH)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="float32"),
                      train=dataclasses.replace(cfg.train, **train))
    if box_loss == "giou":
        cfg = cfg.replace(detector=dataclasses.replace(
            cfg.detector, box_loss="giou", iou_head=True))
    return cfg


def _config(tmp_path, box_loss="huber", **train):
    train.setdefault("checkpoint_dir", str(tmp_path / "ckpt"))
    return torch_config_of(_jax_config(box_loss, **train))


@pytest.fixture(scope="module")
def batches():
    records = make_dataset(16, img_h=96, img_w=80, seed=4)
    rng = np.random.RandomState(0)
    return [make_batch(records[BATCH * i:BATCH * (i + 1)], SIZE, 8, rng)
            for i in range(4)]


# --- checkpoints ---------------------------------------------------------------


def test_checkpoint_round_trip(tmp_path, batches):
    cfg = _config(tmp_path)
    state = steps.create_train_state(cfg, 3, device="cpu")
    steps.make_train_step(cfg)(state, steps.batch_to(batches[0], "cpu"))
    mgr = CheckpointManager(tmp_path / "c", 5, 2)
    assert mgr.save(state)
    assert not (tmp_path / "c" / "ckpt_1.pt.tmp").exists()
    fresh = steps.create_train_state(cfg, 9, device="cpu")
    fresh, step = mgr.restore(fresh)
    assert step == 1 and fresh.step == 1
    want, got = state.state_dict(), fresh.state_dict()
    for key in ("params", "batch_stats", "ema_params", "mu", "nu"):
        for k, v in want[key].items():
            assert torch.equal(got[key][k], v), (key, k)


def test_restore_without_a_checkpoint_keeps_the_state(tmp_path):
    cfg = _config(tmp_path)
    state = steps.create_train_state(cfg, 0, device="cpu")
    same, step = CheckpointManager(tmp_path / "none").restore(state)
    assert same is state and step == 0


class _Tiny:
    def __init__(self, step):
        self.step = step

    def state_dict(self):
        return {"step": self.step}


def test_save_decisions_equal_orbax(tmp_path):
    """Interval 3, keep 2, steps 1..11 saved where should_save says,
    then forced saves: the same decisions and kept steps as orbax's
    CheckpointManager (the JAX package's)."""
    import orbax.checkpoint as ocp

    ours = CheckpointManager(tmp_path / "ours", 3, 2)
    theirs = ocp.CheckpointManager(
        tmp_path / "orbax", options=ocp.CheckpointManagerOptions(
            save_interval_steps=3, max_to_keep=2,
            enable_async_checkpointing=False))
    tree = {"a": np.zeros(2)}
    for step in range(1, 12):
        decision = theirs.should_save(step)
        assert ours.should_save(step) == decision, step
        if decision:
            theirs.save(step, args=ocp.args.StandardSave(tree))
            assert ours.save(_Tiny(step))
    assert ours.all_steps() == list(theirs.all_steps()) == [6, 9]
    assert not ours.save(_Tiny(9), force=True)   # already the latest
    theirs.save(11, args=ocp.args.StandardSave(tree), force=True)
    assert ours.save(_Tiny(11), force=True)
    assert ours.all_steps() == list(theirs.all_steps()) == [9, 11]
    assert ours.latest_step() == 11
    theirs.close()


# --- the loop ----------------------------------------------------------------


def _train(cfg, batches, num_steps, **kw):
    return loop.train(cfg, iter(batches), num_steps=num_steps,
                      device="cpu", **kw)


def test_resume_equals_a_straight_run(tmp_path, batches):
    straight = _train(_config(tmp_path / "a", save_interval_steps=100),
                      batches, 4)
    cfg = _config(tmp_path / "b", save_interval_steps=100)
    first = _train(cfg, batches[:2], 2)
    assert first.step == 2
    resumed = _train(cfg, batches[2:], 4)
    assert resumed.step == 4 == straight.step
    want, got = straight.state_dict(), resumed.state_dict()
    for key in ("params", "batch_stats", "ema_params", "mu", "nu"):
        for k, v in want[key].items():
            assert torch.equal(got[key][k], v), (key, k)
    assert CheckpointManager(cfg.train.checkpoint_dir).all_steps() == [1, 2,
                                                                       4]


@pytest.mark.parametrize("box_loss", ["huber", "giou"])
def test_metric_keys_and_steps_equal_the_jax_loops(tmp_path, batches,
                                                   box_loss):
    """The JAX loop logs its train step's metrics plus `step` and
    `images_per_sec` where step % log_interval_steps == 0 and at the last
    step; the step's keys come from tracing it (no compile)."""
    jcfg = _jax_config(box_loss)
    state = jsteps.create_train_state(jcfg, jax.random.PRNGKey(0))
    jb = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
          for k, v in batches[0].items()}
    _, metrics = jax.eval_shape(jsteps.make_train_step(jcfg), state, jb)
    want = sorted([*metrics, "step", "images_per_sec"])
    cfg = _config(tmp_path, box_loss, log_interval_steps=2)
    logged = []
    _train(cfg, batches[:3], 3, log_fn=logged.append)
    lines = [json.loads(line) for line in
             (tmp_path / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [2, 3]
    assert lines == logged
    for m in lines:
        assert sorted(m) == want
        assert all(np.isfinite(v) for v in m.values())


def test_more_than_one_device_is_refused(tmp_path, batches):
    with pytest.raises(NotImplementedError, match="DDP"):
        _train(_config(tmp_path), batches, 1, num_devices=4)


def test_training_needs_the_card_unless_asked_for_the_cpu(tmp_path,
                                                          monkeypatch,
                                                          batches):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.train(_config(tmp_path), iter(batches), 1)


# --- the command ----------------------------------------------------------------


def _run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def test_train_command_is_registered():
    with pytest.raises(SystemExit) as exit_info, contextlib.redirect_stdout(
            io.StringIO()) as out:
        cli.main(["train", "--help"])
    assert exit_info.value.code == 0
    for flag in ("--config", "--coco-json", "--image-dir", "--synthetic",
                 "--steps", "--model-dir", "--device"):
        assert flag in out.getvalue()


def test_cli_train_exports_what_the_jax_package_reads(tmp_path):
    cfg = _config(tmp_path, log_interval_steps=1)
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    out = _run_cli(["train", "--device", "cpu", "--synthetic", "8",
                    "--steps", "2", "--config", str(tmp_path / "cfg.json"),
                    "--model-dir", str(tmp_path / "model")])
    logs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    assert [m["step"] for m in logs] == [1, 2]
    assert "exported EMA model" in out
    # Again with --steps 3: resumes from the checkpoint at step 2.
    out = _run_cli(["train", "--device", "cpu", "--synthetic", "8",
                    "--steps", "3", "--config", str(tmp_path / "cfg.json")])
    assert [json.loads(line)["step"] for line in out.splitlines()
            if line.startswith("{")] == [3]

    jcfg, variables, prn = jax_export.load_model(tmp_path / "model")
    assert prn is None
    assert jcfg.to_dict() == cfg.replace(train=dataclasses.replace(
        cfg.train, num_steps=2)).to_dict()
    template = JaxPredictor(config=jcfg, image_size=SIZE,
                            use_pallas_decode=False)
    prn_vars = jax.tree.map(np.asarray, template.prn_variables)
    jax_pred = JaxPredictor(config=jcfg, variables=variables,
                            prn_variables=prn_vars, image_size=SIZE,
                            use_pallas_decode=False)
    pcfg, pvars, _ = port_export.load_model(tmp_path / "model")
    port = Predictor(pcfg, variables=pvars, prn_variables=prn_vars,
                     image_size=SIZE, device="cpu")
    flat = space_to_depth_flat4(
        planted_images(np.random.RandomState(0), 2, SIZE, SIZE))
    want = {k: np.asarray(v) for k, v in jax.jit(
        jax_pred._batch_forward_impl)(jax_pred.variables,
                                      jax_pred.prn_variables,
                                      jnp.asarray(flat)).items()}
    got = port.batch_forward(flat)
    valid = want["box_valid"]
    assert valid.any()
    np.testing.assert_array_equal(to_numpy(got["box_valid"]).astype(bool),
                                  valid)
    np.testing.assert_allclose(to_numpy(got["boxes"]), want["boxes"],
                               **BOX_TOL)
    np.testing.assert_allclose(to_numpy(got["box_scores"]),
                               want["box_scores"], **SCORE_TOL)
    np.testing.assert_array_equal(to_numpy(got["peak_valid"]).astype(bool),
                                  want["peak_valid"])
    np.testing.assert_allclose(to_numpy(got["keypoints"]), want["keypoints"],
                               **KP_TOL)


# --- chip_smoke.py's training phases -----------------------------------------


class _Event:
    """torch.cuda.Event on the host clock."""

    def __init__(self, enable_timing=True):
        self.t = 0.0

    def record(self):
        import time

        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _rehearsal(monkeypatch):
    """chip_smoke.py as a module with the card faked for the CPU: CUDA
    events on the host clock, synchronize and the memory counters no-ops,
    the predictor's default device the CPU, each decode counting the
    kernel `route` picks, the training shapes shrunk (64² batches of 2
    to 4) and `emit` collecting the phases' lines. Returns (module,
    lines, TinyConfig)."""
    from multiposenet_tpu_torch import kernels
    from multiposenet_tpu_torch.config import Config
    from multiposenet_tpu_torch.infer import predictor
    from multiposenet_tpu_torch.ops import decode

    from torch_port_helpers import chip_smoke_module

    smoke = chip_smoke_module()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(predictor, "resolve_device",
                        lambda device: torch.device(device or "cpu"))
    plain = decode.decode_maps

    def counted(hm, config=decode.DecodeConfig()):
        kernels.count_launch(decode.route(hm, config))
        return plain(hm, config)

    monkeypatch.setattr(decode, "decode_maps", counted)
    for name, value in (("TINY_IMAGE", 64), ("TINY_BATCH", 4),
                        ("TRAIN_IMAGE", 64), ("TRAIN_BATCH", 2),
                        ("FAST_BATCH", 2)):
        monkeypatch.setattr(smoke, name, value)
    lines = []
    monkeypatch.setattr(smoke, "emit", lines.append)

    class TinyConfig:
        """Config() and Config.fast() at the tiny shapes, both in float32:
        on the CPU this torch build's bfloat16 weight gradient of a
        strided conv on a 1x1 map (fpn.p7 at 64²) changes from run to run
        and may be NaN; the card runs fast() in bfloat16."""

        def __new__(cls):
            return smoke.tiny_train_config(Config)

        @staticmethod
        def fast():
            return smoke.tiny_train_config(Config)

    return smoke, lines, TinyConfig


def test_chip_smoke_train_phases_rehearse_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's `train_parity`, `train_default`, `train_fast` and
    `train_cli` on the CPU at small sizes (Config() and Config.fast()
    swapped for the tiny config in float32, 64² batches of 2 to 4). The
    checks hold: the 20 steps on one batch halve the loss, the command
    logs the JAX loop's keys and resumes, and the exported model's
    `predict` launches B1 once."""
    from multiposenet_tpu_torch import kernels
    from multiposenet_tpu_torch.config import Config
    from multiposenet_tpu_torch.data import loader, synthetic
    from multiposenet_tpu_torch.models.posenet import MultiPoseNet
    from multiposenet_tpu_torch.ops import decode
    from multiposenet_tpu_torch.train import checkpoints

    smoke, lines, TinyConfig = _rehearsal(monkeypatch)
    cpu = torch.device("cpu")
    args = (MultiPoseNet, synthetic, loader, steps, cpu, "cpu")
    smoke.phase_train_parity(Config, *args)
    smoke.phase_train_default(TinyConfig, *args)
    smoke.phase_train_fast(TinyConfig, *args)
    kernels.reset_launches()
    assert smoke.phase_train_cli(Config, cli, port_export, checkpoints,
                                 decode, kernels, cpu, tmp_path, "cpu") == 1
    assert [row["phase"] for row in lines] == [
        "train_parity", "train_default", "train_fast", "train_cli"]
    curve = lines[0]["fit_one_batch_total_loss"]
    assert curve[-1] <= 0.5 * curve[0]
    for row in lines[1:3]:
        assert row["step_ms"] > 0 and row["loader_img_per_s"] > 0
    assert lines[3]["steps_logged"] == [1, 2, 3, 4, 5]
    config = json.loads((tmp_path / "trained" / "config.json").read_text())
    assert config["prn"] == dataclasses.asdict(Config().prn)


def test_chip_smoke_mask_prn_profile_phases_rehearse_on_cpu(monkeypatch,
                                                           tmp_path):
    """chip_smoke.py's `prepare_masks`, `train_prn` and `profile_train` on
    the CPU at small sizes: the segmentation fixture's shards train 3
    steps with masks on every image and the tiny masked config holds
    card (here the CPU) against the CPU; `train-prn` (a tiny PRN, trained
    into `train_cli`'s export) logs step 50 and the exported model with
    that PRN launches B1 once; the profiler traces 2 steps (no device
    here, so no idle share)."""
    from multiposenet_tpu_torch import kernels
    from multiposenet_tpu_torch.config import Config
    from multiposenet_tpu_torch.data import loader, prepare, synthetic
    from multiposenet_tpu_torch.models.posenet import MultiPoseNet
    from multiposenet_tpu_torch.ops import decode
    from multiposenet_tpu_torch.train import checkpoints, prn_train
    from multiposenet_tpu_torch.utils import profiling

    smoke, lines, TinyConfig = _rehearsal(monkeypatch)
    monkeypatch.setattr(smoke, "MASK_RECORD_REPEATS", 1)
    monkeypatch.setattr(smoke, "PRN_TIMED", 2)
    cpu = torch.device("cpu")
    smoke.phase_prepare_masks(TinyConfig, MultiPoseNet, cli, prepare, loader,
                              loop, steps, cpu, tmp_path, "cpu")
    tiny = smoke.tiny_train_config(Config)
    assert smoke.phase_train_cli(Config, cli, port_export, checkpoints,
                                 decode, kernels, cpu, tmp_path, "cpu",
                                 prn=tiny.prn) == 1
    assert smoke.phase_train_prn(Config, cli, port_export, prn_train, loader,
                                 synthetic, decode, kernels, cpu, tmp_path,
                                 "cpu", prn_config=tiny) == 1
    smoke.phase_profile_train(TinyConfig, MultiPoseNet, synthetic, loader,
                              steps, profiling, cpu, tmp_path, "cpu")
    masks_row, _, prn_row, profile_row = lines
    assert masks_row["phase"] == "prepare_masks"
    assert masks_row["shards"] == ["shard-00000.npz"]
    assert masks_row["records"] == 10 and masks_row["step_ms"] > 0
    assert masks_row["loader_img_per_s_masks"] > 0
    assert len(masks_row["tiny_masked"]["card_vs_cpu"]) == 3
    assert prn_row["phase"] == "train_prn"
    assert prn_row["logged"][0]["step"] == 50
    assert prn_row["prn_step_ms"] > 0 and prn_row["crop"] == [14, 10]
    assert [r["step"] for r in prn_row["tiny_card_vs_cpu"]] == [1, 2, 3]
    assert (tmp_path / "trained" / "prn.msgpack").exists()
    assert profile_row["phase"] == "profile_train"
    assert profile_row["device_trace"] is False
    assert profile_row["idle_share"] == "not measured"
    assert profile_row["trace_json_bytes"] > 0
