"""The port's PRN training (`multiposenet_tpu_torch/train/prn_train.py`,
`ops/prn_ops.batched_crop_heatmaps`) and its `train-prn` command against
the JAX package's `train/prn_train.py` on the CPU, at tiny shapes (crop
14x10, 32 hidden units, 64² images).

Both PRNs run in float64 (built with a float64 dtype, the JAX side under
`jax.enable_x64`, the batch's keypoints and boxes float64 in both, the
JAX package's flax init loaded into the port): `prn_loss_fn`,
`prn_accuracy` and the parameters after 3 Adam steps agree within 1e-9
of each tensor's largest magnitude, for window jitter 0 and 0.1 (the JAX
package's draws handed to the port's `prn_loss_fn`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multiposenet_tpu.config import Config, ModelConfig
from multiposenet_tpu.data.loader import make_batch
from multiposenet_tpu.data.synthetic import make_dataset
from multiposenet_tpu.infer import export as jexport
from multiposenet_tpu.models.prn import PRN as JaxPRN
from multiposenet_tpu.ops import prn_ops as jprn_ops
from multiposenet_tpu.train import prn_train as jpt
from multiposenet_tpu_torch import cli, weights
from multiposenet_tpu_torch.infer import export as texport
from multiposenet_tpu_torch.ops import prn_ops
from multiposenet_tpu_torch.train import prn_train as tpt

from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, tiny_config, torch_config_of,
)

CH, CW, HIDDEN, SIZE, PERSONS = 14, 10, 32, 64, 6
KEYS = ("keypoints", "boxes", "valid", "iscrowd")


def _tiny(cfg, jitter: float = 0.0):
    """`cfg` with the PRN and train sizes of these tests."""
    return cfg.replace(
        prn=dataclasses.replace(cfg.prn, crop_height=CH, crop_width=CW,
                                hidden_units=HIDDEN, max_persons=PERSONS,
                                window_jitter=jitter),
        train=dataclasses.replace(cfg.train, image_size=SIZE, batch_size=3,
                                  seed=0))


def _configs(jitter: float = 0.0):
    cfg = _tiny(Config(model=ModelConfig(backbone_width=0.25)), jitter)
    return cfg, torch_config_of(cfg)


def _batch(seed: int = 4):
    records = make_dataset(3, img_h=80, img_w=64, min_persons=2,
                           max_persons=5, seed=seed)
    b = make_batch(records, SIZE, PERSONS, train=False)
    return {k: b[k].astype(np.float64) if b[k].dtype == np.float32 else b[k]
            for k in KEYS}


def _jax_prn():
    return JaxPRN(crop_height=CH, crop_width=CW, num_keypoints=17,
                  hidden_units=HIDDEN, dtype=jnp.float64)


def _port_prn(cfg, params):
    prn = tpt.make_prn(cfg, torch.float64)
    weights.load_prn(prn, jax.tree.map(np.asarray, params))
    return prn.double()


def _close(got, want, rel=1e-9):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, (
        float(np.abs(got - want).max()), scale)


def test_crop_cell_targets_roundtrip_and_equal_jax():
    """A keypoint at a crop cell's sampling position maps to that cell
    (column-major, j * ch + i); on random keypoints and boxes the cells
    and weights equal the JAX package's, half-way cases rounding to even."""
    box = np.array([[16.0, 24.0, 80.0, 72.0]])
    hy = 16 / 4 + 5.5 * (64 / 4) / 28 - 0.5
    hx = 24 / 4 + 7.5 * (48 / 4) / 18 - 0.5
    kp = np.zeros((1, 17, 3))
    kp[0, 3] = [hx * 4, hy * 4, 2.0]
    cell, weight = tpt.crop_cell_targets(torch.as_tensor(kp),
                                         torch.as_tensor(box), 28, 18, 4)
    assert int(cell[0, 3]) == 7 * 28 + 5 and weight[0, 3] == 1
    assert weight[0, 0] == 0
    rng = np.random.RandomState(0)
    kps = rng.rand(2, 5, 17, 3) * 80 - 8
    kps[..., 2] = rng.rand(2, 5, 17) > 0.3
    y0x0 = rng.rand(2, 5, 2) * 40
    boxes = np.concatenate([y0x0, y0x0 + rng.rand(2, 5, 2) * 40 + 1], -1)
    kps[0, 0, 0, :2] = [boxes[0, 0, 1] + 2.0, boxes[0, 0, 0] + 2.0]
    with jax.enable_x64(True):
        want = jax.vmap(lambda k, b: jpt.crop_cell_targets(
            k, b, CH, CW, 4))(jnp.asarray(kps), jnp.asarray(boxes))
    got = tpt.crop_cell_targets(torch.as_tensor(kps), torch.as_tensor(boxes),
                                CH, CW, 4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_crop_heatmaps_match_jax(dtype):
    """Channels-last maps [B, H, W, K] cropped into [B, P, cw, ch, K]:
    1e-6 relative in float32, 1e-12 in float64."""
    rng = np.random.RandomState(1)
    maps = rng.rand(2, 16, 16, 17).astype(dtype)
    y0x0 = rng.rand(2, 4, 2) * 10 - 2
    boxes = np.concatenate([y0x0, y0x0 + rng.rand(2, 4, 2) * 8 + 0.5],
                           -1).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jprn_ops.batched_crop_heatmaps(
            jnp.asarray(maps), jnp.asarray(boxes), CH, CW))
    got = prn_ops.batched_crop_heatmaps(torch.as_tensor(maps),
                                        torch.as_tensor(boxes), CH, CW)
    assert got.shape == (2, 4, CW, CH, 17) and got.dtype == getattr(
        torch, dtype)
    _close(got.numpy(), want, 1e-6 if dtype == "float32" else 1e-12)
    one = prn_ops.crop_heatmaps(torch.as_tensor(maps[1]),
                                torch.as_tensor(boxes[1]), CH, CW)
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())


class _Run:
    """The JAX loss and 3 optax Adam steps, and the port's from the same
    init, batch and (with jitter) draws."""

    def __init__(self, jitter):
        cfg, tcfg = _configs(jitter)
        batch = _batch()
        with jax.enable_x64(True):
            prn = _jax_prn()
            params = jax.tree.map(
                lambda x: x.astype(jnp.float64),
                prn.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 17, CH * CW))))
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            base = jax.random.PRNGKey(cfg.train.seed + 1)
            tx = optax.adam(1e-3)
            opt, p = tx.init(params), params
            self.jax_metrics, self.draws = [], []
            for step in range(3):
                rng = jax.random.fold_in(base, step)
                self.draws.append(np.array(jax.random.uniform(
                    rng, jb["boxes"].shape, minval=-jitter, maxval=jitter)))
                grads, m = jax.grad(
                    lambda q: jpt.prn_loss_fn(prn, q, jb, cfg, rng),
                    has_aux=True)(p)
                self.jax_metrics.append({k: float(v) for k, v in m.items()})
                updates, opt = tx.update(grads, opt)
                p = optax.apply_updates(p, updates)
            self.jax_params = jax.tree.map(np.asarray, p)["params"]
        tprn = _port_prn(tcfg, params)
        state = tpt.PRNTrainState(
            0, tprn, {k: torch.zeros_like(v)
                      for k, v in tprn.named_parameters()},
            {k: torch.zeros_like(v) for k, v in tprn.named_parameters()})
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        self.port_metrics = []
        for step in range(3):
            u = torch.as_tensor(self.draws[step]) if jitter else None
            loss, m = tpt.prn_loss_fn(state.model, tb, tcfg, u)
            names, prm = zip(*state.model.named_parameters())
            grads = torch.autograd.grad(loss, prm)
            self.port_metrics.append({k: float(v.detach())
                                      for k, v in m.items()})
            tpt.adam_update(state, dict(zip(names, grads)))
            state.step += 1
        self.port_state = state


@pytest.fixture(scope="module", params=[0.0, 0.1], ids=["jitter0",
                                                         "jitter0.1"])
def run(request):
    return _Run(request.param)


def test_prn_loss_and_accuracy_match_jax(run):
    for jm, tm in zip(run.jax_metrics, run.port_metrics):
        assert sorted(jm) == sorted(tm) == ["prn_accuracy", "prn_loss"]
        for k in jm:
            _close(tm[k], jm[k])
    # The PRN learns on this batch: the loss falls over the 3 steps.
    assert run.port_metrics[2]["prn_loss"] < run.port_metrics[0]["prn_loss"]


def test_params_after_three_adam_steps_match_jax(run):
    for name in ("hidden_cm", "out_cm"):
        layer = getattr(run.port_state.model, name)
        _close(layer.weight.detach().numpy().T,
               run.jax_params[name]["kernel"])
        _close(layer.bias.detach().numpy(), run.jax_params[name]["bias"])


def test_jitter_moves_the_loss():
    """Jitter 0.1 with draws gives another loss than no draws; without
    draws the jitter does nothing, as in the JAX package (rng None)."""
    _, tcfg = _configs(0.1)
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    prn = tpt.create_prn_state(tcfg, "cpu", torch.float64).model
    plain = float(tpt.prn_loss_fn(prn, batch, tcfg)[0])
    u = tpt.jitter_draws(tcfg, 0, batch["boxes"])
    assert u.shape == batch["boxes"].shape and float(u.abs().max()) <= 0.1
    assert float(tpt.prn_loss_fn(prn, batch, tcfg, u)[0]) != plain


def test_jitter_draws_depend_on_seed_and_step_only():
    _, tcfg = _configs(0.1)
    boxes = torch.zeros(2, 3, 4)
    a = tpt.jitter_draws(tcfg, 5, boxes)
    np.testing.assert_array_equal(a, tpt.jitter_draws(tcfg, 5, boxes))
    assert not torch.equal(a, tpt.jitter_draws(tcfg, 6, boxes))
    other = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, seed=1))
    assert not torch.equal(a, tpt.jitter_draws(other, 5, boxes))


def _batches(n: int):
    for i in range(n):
        yield _batch(seed=10 + i)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """4 steps with jitter, against 2 steps, a checkpoint, then 2 more
    resumed from it (the draws fold in the step): equal parameters; a
    finished run pulls no batch."""
    _, tcfg = _configs(0.1)
    whole = tpt.train_prn(tcfg, _batches(4), 4, device="cpu")
    ckpt = tmp_path / "ckpt"
    tpt.train_prn(tcfg, _batches(2), 2, checkpoint_dir=str(ckpt),
                  save_interval_steps=1, device="cpu")
    batches = _batches(4)
    next(batches), next(batches)
    resumed = tpt.train_prn(tcfg, batches, 4, checkpoint_dir=str(ckpt),
                            save_interval_steps=1, device="cpu")
    assert resumed.step == whole.step == 4
    for k, v in whole.params.items():
        torch.testing.assert_close(resumed.params[k], v, rtol=0, atol=0)

    def no_batches():
        raise AssertionError("a batch was pulled")
        yield

    done = tpt.train_prn(tcfg, no_batches(), 4, checkpoint_dir=str(ckpt),
                         device="cpu")
    assert done.step == 4


def test_metrics_are_logged_every_50_steps():
    _, tcfg = _configs()
    logged = []
    tpt.train_prn(tcfg, (_batch() for _ in range(100)), 100,
                  log_fn=logged.append, device="cpu")
    assert [m["step"] for m in logged] == [50, 100]
    assert sorted(logged[0]) == ["prn_accuracy", "prn_loss", "step"]
    assert logged[1]["prn_loss"] < logged[0]["prn_loss"]


def test_train_prn_command_exports_a_prn_both_packages_load(tmp_path,
                                                            capsys):
    """`train-prn --device cpu --model-dir D` on a directory holding an
    exported model: `prn.msgpack` in the JAX format, read by the JAX
    `load_model` and by the port's `load_predictor`, equal to the
    trained weights."""
    from multiposenet_tpu_torch.infer.predictor import Predictor

    tcfg = torch_config_of(_tiny(tiny_config("float32")))
    model_dir = tmp_path / "model"
    base = Predictor(config=tcfg, device="cpu")
    texport.save_model(model_dir, tcfg, base.variables)
    (tmp_path / "cfg.json").write_text(tcfg.to_json())
    cli.main(["train-prn", "--config", str(tmp_path / "cfg.json"),
              "--synthetic", "6", "--steps", "3", "--model-dir",
              str(model_dir), "--device", "cpu"])
    assert f"exported PRN to {model_dir}" in capsys.readouterr().out
    _, _, jax_prn = jexport.load_model(model_dir)
    port = texport.load_predictor(model_dir, device="cpu")
    got = port.prn_variables["params"]
    assert sorted(jax_prn["params"]) == ["hidden_cm", "out_cm"]
    for name in ("hidden_cm", "out_cm"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(
                np.asarray(jax_prn["params"][name][leaf]), got[name][leaf])
    trained = np.asarray(got["out_cm"]["kernel"])
    assert not np.array_equal(
        trained, base.prn_variables["params"]["out_cm"]["kernel"])
