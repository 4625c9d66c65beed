"""The port's training step (`multiposenet_tpu_torch/train/steps.py`,
`models/layers.py BatchNorm` in training mode) against the JAX package's
`make_train_step` on the CPU, from the same weights (the JAX package's
flax init, loaded through `weights.load_posenet`) and the same batches,
at the tiny shapes of `__graft_entry__._tiny_config`, for two configs:
the default Huber detector, and GIoU with the IoU head as in
`Config.crowd()`.

Both packages run the model in float64 for the parity held here
(ModelConfig.compute_dtype "float64"; the JAX package under
`jax.enable_x64`, its parameters and optimizer state still float32; the
batches and so the targets float32 in both, as anchor labels at IoU
thresholds may flip with the precision): one step's losses to 1e-5 relative, batch statistics
to 1e-5, per-parameter gradient norms (from the first moments after the
first update) to 1e-4, the parameters after two steps at 1e-5 and after
three within the bounds their tests explain. In float32 the
two differ by more than that at these shapes: training-mode BatchNorm
over a few values a channel amplifies rounding through the network, and
the JAX package's float32 step is itself the further from the float64
one (heatmap loss 1.6e-5 against the port's 3e-6). The port's float32
step is held to its float64 one: 1e-4 on losses and batch statistics,
1e-3 on the gradient norm.

Also held: BatchNorm's training forward, gradients and running statistics
against flax's; the model in training mode against `apply(train=True,
mutable=["batch_stats"])`; the schedule against optax; the optimizer
update against optax from identical gradients and state (1e-6
relative); the EMA ramp; and the eval step on the EMA parameters.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from multiposenet_tpu.data.loader import make_batch
from multiposenet_tpu.data.synthetic import make_dataset
from multiposenet_tpu.models.posenet import MultiPoseNet as JaxMultiPoseNet
from multiposenet_tpu.ops.image import normalize as jax_normalize
from multiposenet_tpu.train import steps as jsteps
from multiposenet_tpu_torch import weights
from multiposenet_tpu_torch.models.layers import BatchNorm
from multiposenet_tpu_torch.models.posenet import MultiPoseNet
from multiposenet_tpu_torch.train import steps as tsteps

from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, torch_config_of,
)

SIZE, BATCH, STEPS = 64, 4, 3
CPU = torch.device("cpu")


def _config(name: str):
    cfg = _tiny_config(image_size=SIZE, batch_size=BATCH)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="float32"))
    if name == "giou_iou":
        cfg = cfg.replace(detector=dataclasses.replace(
            cfg.detector, box_loss="giou", giou_loss_weight=5.0,
            iou_head=True))
    return cfg


def _batches(cfg):
    records = make_dataset(BATCH * STEPS, img_h=96, img_w=80, seed=3)
    rng = np.random.RandomState(7)
    return [make_batch(records[BATCH * i:BATCH * (i + 1)], SIZE,
                       cfg.prn.max_persons,
                       rng) for i in range(STEPS)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(tree) -> dict[str, np.ndarray]:
    """A flax params tree → port names → numpy."""
    return {k: v.numpy() for k, v in weights.posenet_state_dict(
        {"params": _np(tree)}).items()}


def _stats(tree) -> dict[str, np.ndarray]:
    flat = weights._flatten(_np(tree))
    return {f"{k.rsplit('.', 1)[0]}.running_{k.rsplit('.', 1)[1]}": v
            for k, v in flat.items()}


def _port_model(cfg, variables):
    model = MultiPoseNet(torch_config_of(cfg))
    weights.load_posenet(model, _np(variables))
    return model


class _Run:
    """Both packages' states after each of STEPS steps on the same
    batches, in `dtype` ("float64" or "float32")."""

    def __init__(self, name, dtype):
        cfg = _config(name)
        self.dtype = dtype
        if dtype == "float64":
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, compute_dtype="float64"))
        self.cfg = cfg
        self.batches = _batches(cfg)
        with jax.enable_x64(dtype == "float64"):
            state = jsteps.create_train_state(cfg, jax.random.PRNGKey(0))
            self.variables = v = {"params": state.params,
                                  "batch_stats": state.batch_stats}
            step = jax.jit(jsteps.make_train_step(cfg))
            self.jax_states, self.jax_metrics = [state], []
            for b in self.batches:
                state, m = step(state,
                                {k: jnp.asarray(x) for k, x in b.items()})
                self.jax_states.append(jax.tree.map(np.asarray, state))
                self.jax_metrics.append({k: float(x) for k, x in m.items()})
        tcfg = self.tcfg = torch_config_of(cfg)
        tdt = torch.float64 if dtype == "float64" else torch.float32
        model = _port_model(cfg, v).to(tdt)
        ts = tsteps.create_train_state(tcfg, model=model, device=CPU)
        tstep = tsteps.make_train_step(tcfg)
        self.port_states, self.port_metrics = [ts.state_dict()], []
        for b in self.batches:
            ts, m = tstep(ts, tsteps.batch_to(b, CPU))
            self.port_states.append(ts.state_dict())
            self.port_metrics.append({k: float(x) for k, x in m.items()})
        self.port_final = ts


@pytest.fixture(scope="module", params=["huber", "giou_iou"])
def run(request):
    return _Run(request.param, "float64")


# --- BatchNorm ----------------------------------------------------------------


def _bn_inputs(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 4, 6) * 2 + 1).astype(np.float32)
    x[..., 2] = 0.75  # a constant channel: variance 0, clamped
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    mean = rng.randn(6).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    return x.astype(dtype), scale, bias, mean, var


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_training_forward_and_stats_match_flax(dtype):
    x, scale, bias, mean, var = _bn_inputs(np.float32)
    jdt = jnp.dtype(dtype)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.997,
                      epsilon=1e-3, dtype=jdt)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    y, mut = bn.apply(variables, jnp.asarray(x, jdt), mutable=["batch_stats"])
    port = BatchNorm(6, 1e-3, 0.997)
    with torch.no_grad():
        port.weight.copy_(torch.tensor(scale))
        port.bias.copy_(torch.tensor(bias))
        port.running_mean.copy_(torch.tensor(mean))
        port.running_var.copy_(torch.tensor(var))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    xt = torch.tensor(x).permute(0, 3, 1, 2).to(tdt)
    got = port.train()(xt)
    assert got.dtype == tdt
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(
        atol=0.02, rtol=0.01)
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).detach()
                               .numpy(), np.asarray(y, np.float32), **tol)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               atol=1e-6, rtol=1e-6)


def test_batchnorm_training_gradients_match_flax():
    x, scale, bias, mean, var = _bn_inputs(np.float32)
    w = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.997,
                      epsilon=1e-3)

    def loss(x, scale, bias):
        y, _ = bn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": mean, "var": var}}, x,
                        mutable=["batch_stats"])
        return jnp.sum(y * w)

    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), scale, bias)
    port = BatchNorm(6).train()
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    with torch.no_grad():
        port.weight.copy_(torch.tensor(scale))
        port.bias.copy_(torch.tensor(bias))
    y = port(xt)
    tg = torch.autograd.grad((y * torch.tensor(w).permute(0, 3, 1, 2)).sum(),
                             [xt, port.weight, port.bias])
    np.testing.assert_allclose(tg[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(jg[0]), atol=2e-4, rtol=1e-4)
    for a, b in zip(tg[1:], jg[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-5)


def test_batchnorm_eval_mode_keeps_the_running_stats():
    port = BatchNorm(4)
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    port.eval()(x)
    assert torch.equal(port.running_mean, torch.zeros(4))
    port.train()(x)
    assert not torch.equal(port.running_mean, torch.zeros(4))


# --- the model in training mode ---------------------------------------------


def test_model_training_forward_matches_flax(run):
    """In float64: the outputs (the JAX package casts heatmaps and
    segmentation to float32, the port keeps them float64 in float64)
    and the batch statistics."""
    cfg, b = run.cfg, run.batches[0]
    model = JaxMultiPoseNet(config=cfg, with_detector=True)
    with jax.enable_x64(True):
        images = jnp.asarray(b["images"]).astype(jnp.float64)
        if not cfg.model.fold_input_norm:
            images = jax.jit(jax_normalize)(jnp.asarray(b["images"])).astype(
                jnp.float64)
        out, mut = jax.jit(lambda v, x: model.apply(
            v, x, train=True, mutable=["batch_stats"]))(run.variables,
                                                        images)
        out, mut = jax.tree.map(np.asarray, (out, mut))
    port = _port_model(cfg, run.variables).double().train()
    got = port(tsteps.model_images(torch.as_tensor(b["images"]), run.tcfg))
    for key in ("heatmaps", "segmentation"):
        assert got[key].dtype == torch.float64
        np.testing.assert_allclose(got[key].detach().numpy(), out[key],
                                   atol=1e-6, rtol=1e-6, err_msg=key)
    for level, heads in out["detector"].items():
        for k, v in heads.items():
            np.testing.assert_allclose(
                got["detector"][level][k].detach().numpy(), v, atol=1e-9,
                rtol=1e-9, err_msg=f"{level}.{k}")
    want = _stats(mut["batch_stats"])
    for k, v in port.named_buffers():
        # The JAX package keeps batch statistics in float32.
        np.testing.assert_allclose(v.numpy(), want[k], atol=1e-7,
                                   rtol=1e-7, err_msg=k)


def test_bn_folded_model_trains_with_conv_biases():
    cfg = torch_config_of(_config("huber"))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, bn_folded=True))
    model = MultiPoseNet(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    assert not any(isinstance(m, BatchNorm) for m in model.modules())
    state = tsteps.create_train_state(cfg, model=model, device=CPU)
    batch = tsteps.batch_to(_batches(_config("huber"))[0], CPU)
    _, metrics = tsteps.make_train_step(cfg)(state, batch)
    assert np.isfinite(float(metrics["total_loss"]))
    assert "backbone.stem.conv.bias" in state.mu
    assert float(state.mu["backbone.stem.conv.bias"].abs().sum()) > 0


# --- one step -------------------------------------------------------------------


def test_step_losses_match(run):
    """Steps 1 and 2 run on the same parameters (lr is 0 at the first
    update), step 3 after the first real update: their losses and
    gradient norm to 1e-5. The port normalizes as the compiled JAX step
    does, so Adam's first update sees the same gradient signs."""
    for i, (jm, tm) in enumerate(zip(run.jax_metrics, run.port_metrics)):
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k],
                                       rtol=1e-5,
                                       atol=1e-9, err_msg=f"{k} step {i}")


def test_batch_stats_after_each_step_match(run):
    for js, ts in zip(run.jax_states[1:], run.port_states[1:]):
        want = _stats(js.batch_stats)
        for k, v in ts["batch_stats"].items():
            np.testing.assert_allclose(v.numpy(), want[k], atol=1e-5,
                                       rtol=1e-5, err_msg=k)


def test_gradient_norms_per_leaf_match(run):
    """The first update's first moments are 0.1 x the clipped gradients:
    their norms per parameter to 1e-4, and the unclipped global norm."""
    want = _adam_mu(run.jax_states[1])
    got = run.port_states[1]["mu"]
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = np.linalg.norm(want[k])
        rel = abs(float(g.norm()) - w) / max(w, 1e-30)
        assert rel < 1e-4, (k, rel)
    np.testing.assert_allclose(run.port_metrics[0]["grad_norm"],
                               run.jax_metrics[0]["grad_norm"], rtol=1e-4)


def test_float32_step_stays_near_float64(run):
    """The port's float32 step against its float64 one (the same
    weights, batches and float32 targets) over steps 1 and 2, which run on
    the same parameters: losses and batch statistics to 1e-4, the gradient
    norm to 1e-3."""
    cfg32 = _config("huber" if run.cfg.detector.box_loss == "huber"
                    else "giou_iou")
    tcfg = torch_config_of(cfg32)
    state = tsteps.create_train_state(
        tcfg, model=_port_model(cfg32, run.variables), device=CPU)
    step = tsteps.make_train_step(tcfg)
    for i, b in enumerate(run.batches[:2]):
        state, m = step(state, tsteps.batch_to(b, CPU))
        for k, v in m.items():
            np.testing.assert_allclose(
                float(v), run.port_metrics[i][k],
                rtol=1e-3 if k == "grad_norm" else 1e-4, err_msg=k)
        for k, v in state.batch_stats.items():
            np.testing.assert_allclose(
                v.numpy(), run.port_states[i + 1]["batch_stats"][k].numpy(),
                atol=1e-4, rtol=1e-4, err_msg=k)


# --- the optimizer, the schedule, the EMA --------------------------------


@pytest.mark.parametrize("warmup,num_steps", [(2, 10), (0, 10), (5, 5),
                                              (1000, 150000)])
def test_schedule_matches_optax(warmup, num_steps):
    cfg = _config("huber")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, warmup_steps=warmup, num_steps=num_steps))
    want = jsteps.make_learning_rate(cfg)
    got = tsteps.make_learning_rate(torch_config_of(cfg))
    counts = sorted({*range(0, 12), warmup - 1, warmup, warmup + 1,
                     num_steps - 1, num_steps, num_steps + 7, 2 * num_steps})
    for c in counts:
        if c < 0:
            continue
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(c))
    assert got(0) == 0.0 or warmup == 0


@pytest.mark.parametrize("grad_scale", [1e-3, 1e3], ids=["kept", "clipped"])
def test_optimizer_update_matches_optax_from_identical_state(grad_scale):
    """Five updates from identical parameters, gradients and moments:
    parameters and moments to 1e-6 of each leaf's largest magnitude;
    small gradients are kept and large ones scaled to the clip norm 10."""
    cfg = _config("huber")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, warmup_steps=2, num_steps=20, weight_decay=1e-2))
    rng = np.random.RandomState(0)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = jsteps.make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    opt = tsteps.Optimizer(torch_config_of(cfg))
    tp = [torch.tensor(params[k]) for k in shapes]
    mu = [torch.zeros_like(p) for p in tp]
    nu = [torch.zeros_like(p) for p in tp]
    for count in range(5):
        grads = {k: (grad_scale * rng.randn(*s)).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        norm = opt.update(tp, [torch.tensor(grads[k]) for k in shapes], mu,
                          nu, count)
        want_norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                for g in grads.values()))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        adam = jstate[1][0]
        for i, k in enumerate(shapes):
            for got, want in ((tp[i], jp[k]), (mu[i], adam.mu[k]),
                              (nu[i], adam.nu[k])):
                want = np.asarray(want)
                err = np.abs(got.numpy() - want).max()
                assert err <= 1e-6 * np.abs(want).max(), (k, count, err)
        if count == 0:  # lr 0 at the first update
            for i, k in enumerate(shapes):
                np.testing.assert_array_equal(tp[i].numpy(), params[k])


def test_ema_ramp_matches_the_jax_formula():
    cfg = torch_config_of(_config("huber"))
    for step in [0, 1, 2, 5, 10, 100, 1000, 8990, 8991, 20000]:
        s = jnp.float32(step) + 1.0
        want = float(jnp.minimum(0.999, (1.0 + s) / (10.0 + s)))
        assert tsteps.ema_decay(cfg, step) == want, step


def test_first_step_keeps_params_and_moves_the_rest(run):
    """lr is 0 at the first update: the parameters stay, while the Adam
    moments, the batch statistics and the EMA move (the EMA toward the
    unchanged parameters, so it stays too, as in the JAX package)."""
    before, after = run.port_states[0], run.port_states[1]
    for k, v in before["params"].items():
        assert torch.equal(after["params"][k], v), k
    assert any(float(m.abs().sum()) > 0 for m in after["mu"].values())
    assert any(not torch.equal(after["batch_stats"][k], v)
               for k, v in before["batch_stats"].items())
    js = run.jax_states[1]
    want = _sd(js.ema_params)
    for k, v in after["ema_params"].items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=1e-7, rtol=1e-7)
    assert after["step"] == 1 and int(js.step) == 1


def _adam_mu(state) -> dict[str, np.ndarray]:
    return _sd(state.opt_state[1][0].mu)


def _small_gradients(run, steps: int) -> dict[str, np.ndarray]:
    """Elements whose gradient at some update up to `steps` is below 1e-3
    of its leaf's largest in either run (recovered from the first
    moments: g = (mu_t - 0.9 mu_(t-1)) / 0.1)."""
    small = {k: np.zeros(v.shape, bool)
             for k, v in _adam_mu(run.jax_states[0]).items()}
    for step in range(1, steps + 1):
        for mus in ((_adam_mu(run.jax_states[step - 1]),
                     _adam_mu(run.jax_states[step])),
                    ({k: v.numpy() for k, v in
                      run.port_states[step - 1]["mu"].items()},
                     {k: v.numpy() for k, v in
                      run.port_states[step]["mu"].items()})):
            for k in small:
                g = (mus[1][k] - 0.9 * mus[0][k]) / 0.1
                small[k] |= np.abs(g) < 1e-3 * np.abs(g).max()
    return small


def _param_diffs(run, steps: int):
    want_p = _sd(run.jax_states[steps].params)
    want_e = _sd(run.jax_states[steps].ema_params)
    got = run.port_states[steps]
    for k, want in want_p.items():
        yield k, np.abs(got["params"][k].numpy() - want), np.abs(
            got["ema_params"][k].numpy() - want_e[k])


def _lr_sum(run, steps: int) -> float:
    sched = jsteps.make_learning_rate(run.cfg)
    return sum(float(sched(c)) for c in range(steps))


def test_params_after_two_steps(run, record_property):
    """After the first real update (step 2; step 1 has lr 0), parameters
    and EMA at atol 1e-5. Adam moves an element by lr·m̂/√v̂, a ratio of
    its own gradients, so an element whose gradient is small against its
    leaf's largest carries the float32 rounding of the JAX package's
    gradients (its parameters are float32) into a large relative error,
    up to a flipped sign: where its gradient is below 1e-3 of the leaf's
    largest in either run it may differ by up to 2x the summed lr. Fewer
    than 1e-5 of the elements use that allowance (1 of 1.3 M at these
    shapes); the count is recorded."""
    small = _small_gradients(run, 2)
    bound_small = 2 * _lr_sum(run, 2) + 1e-5
    used = total = 0
    for k, dp, de in _param_diffs(run, 2):
        for diff in (dp, de):
            bound = np.where(small[k], bound_small, 1e-5)
            assert (diff <= bound).all(), (k, float(diff.max()))
        used += int((dp > 1e-5).sum())
        total += dp.size
    assert used <= 1e-5 * total, (used, total)
    record_property("elements_beyond_1e-5", used)


def test_params_after_three_steps(run, record_property):
    """After the third step the elements that differed reach the third
    gradient, and the trajectories part further: every element within 2x
    the summed lr (how far two Adam paths can part), the mean difference
    below 5e-6 and fewer than 1e-3 of the elements beyond 1e-4 (at these
    shapes: mean 1.4e-6 and 368 of 1.3 M with the Huber detector). The
    count beyond 1e-5 is recorded."""
    bound = 2 * _lr_sum(run, 3) + 1e-5
    beyond4 = beyond5 = total = 0
    mean = 0.0
    for k, dp, de in _param_diffs(run, 3):
        assert (dp <= bound).all() and (de <= bound).all(), k
        beyond4 += int((dp > 1e-4).sum())
        beyond5 += int((dp > 1e-5).sum())
        mean += float(dp.sum())
        total += dp.size
    assert mean / total < 5e-6, mean / total
    assert beyond4 < 1e-3 * total, (beyond4, total)
    record_property("elements_beyond_1e-5", beyond5)


def test_eval_step_on_ema_params_matches_jax(run):
    """From the JAX package's state after three steps, loaded into the
    port: the eval forward on the EMA parameters and the running
    statistics, and its losses; the model's parameters and training mode
    come back after."""
    cfg, b = run.cfg, run.batches[-1]
    js = run.jax_states[-1]
    with jax.enable_x64(True):
        out, metrics = jax.jit(jsteps.make_eval_step(cfg))(
            js, {k: jnp.asarray(x) for k, x in b.items()})
        out, metrics = jax.tree.map(np.asarray, (out, metrics))
    model = _port_model(cfg, {"params": js.params,
                              "batch_stats": js.batch_stats}).double()
    state = tsteps.create_train_state(run.tcfg, model=model, device=CPU)
    ema = _sd(js.ema_params)
    with torch.no_grad():
        for k, v in state.ema_params.items():
            v.copy_(torch.as_tensor(ema[k]))
    params_before = {k: v.clone() for k, v in state.params.items()}
    got_out, got_m = tsteps.make_eval_step(run.tcfg)(
        state, tsteps.batch_to(b, CPU))
    assert sorted(got_m) == sorted(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got_m[k]), float(v), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(got_out["heatmaps"].numpy(), out["heatmaps"],
                               atol=1e-6, rtol=1e-6)
    assert state.model.training
    for k, v in state.params.items():
        assert torch.equal(v, params_before[k]), k


# --- segmentation masks ---------------------------------------------------------


@pytest.mark.parametrize("with_masks", [(True, True, False, True),
                                        (False, False, False, True)])
def test_soft_mask_device_targets_match_jax(with_masks):
    """A batch whose records carry segmentation masks (the loader's
    coverage maps): where `has_mask`, the loss mask is 1 - exclude_cov and
    the segmentation target person_cov; elsewhere the box unions stay.
    Heatmaps, mask, segmentation and anchor targets equal the JAX
    package's `_device_targets` to 1e-6."""
    cfg = _config("huber")
    records = make_dataset(BATCH, img_h=96, img_w=80, seed=5)
    rng = np.random.RandomState(9)
    for rec, on in zip(records, with_masks):
        if on:
            rec["exclude_mask"] = rng.rand(96, 80) > 0.8
            rec["person_mask"] = rng.rand(96, 80) > 0.3
    batch = make_batch(records, SIZE, cfg.prn.max_persons,
                       np.random.RandomState(2),
                       mask_stride=cfg.model.output_stride)
    np.testing.assert_array_equal(batch["has_mask"], with_masks)
    want = jsteps._device_targets({k: jnp.asarray(v)
                                   for k, v in batch.items()}, cfg)
    tcfg = torch_config_of(cfg)
    got = tsteps._device_targets(tsteps.batch_to(batch, CPU), tcfg,
                                 tsteps._anchors(tcfg, CPU))
    for name, g, w in zip(("heatmaps", "mask", "seg", "cls", "box"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   err_msg=name)
    mask, seg = got[1].numpy(), got[2].numpy()
    for i, on in enumerate(with_masks):
        if on:
            np.testing.assert_array_equal(
                mask[i, ..., 0], 1.0 - batch["exclude_cov"][i])
            np.testing.assert_array_equal(seg[i, ..., 0],
                                          batch["person_cov"][i])
    # Soft values reach the loss: coverage is fractional somewhere.
    cov = batch["exclude_cov"][np.asarray(with_masks)]
    assert ((cov > 0) & (cov < 1)).any()
