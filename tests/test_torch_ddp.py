"""Data-parallel training of the port (`parallel/mesh.py`, the global-batch
BatchNorm of `models/layers.py`, the global loss denominators of
`train/losses.py`, the reduced step of `train/steps.py`, the rank-aware
`data/loader.batch_iterator` and `train/loop.py`) on the CPU: 2 and 4
gloo ranks in spawned processes (tests/torch_ddp_helpers.py), at the tiny
shapes of `__graft_entry__._tiny_config` (64², global batch 8) in
float64, from the JAX package's flax init written as a step-0 checkpoint
that every rank restores.

Held:
- two steps on N ranks equal the one-process step on the global batch:
  parameters, batch statistics, EMA and Adam moments (float64 here,
  torch's default dtype) within 1e-10; the losses within 1e-6 relative,
  as the model's heatmaps and the detector losses are float32 (as in the
  JAX package) and their sums run in another order over the shards; the
  second batch's last half holds no person, so the last ranks' shards
  have no positives;
- every rank's state has the same checksum, and metrics.jsonl and the
  checkpoints are written once (by rank 0);
- the ranks' runs equal the JAX step sharded over the 8-device mesh (the
  tests/test_train.py pattern, float64 under jax.enable_x64 with float32
  parameters there) at tests/test_torch_train.py's tolerances: losses
  and batch statistics 1e-5, the parameters and EMA after two steps
  within 2x the summed lr + 1e-5, and the gradient norm 5e-3, as on these
  batches the jitted JAX step's norm parts from its own eager value by
  0.3% (the test says more);
- BatchNorm over shards whose channel means differ gives the statistics,
  outputs and gradients of the whole batch, where per-shard statistics
  would not;
- the ranks' shards of `batch_iterator` concatenate to the single-process
  batches bit for bit (augmented, with masks in some batches, JPEG files
  turned by their Exif orientation);
- a run checkpointed on 2 ranks resumes on 4 (the spawning entry point,
  this process rank 0) and ends where the one-process run ends.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from make_image_fixtures import exif_tiff, with_exif
from multiposenet_tpu.parallel import mesh as jax_mesh
from multiposenet_tpu.train import steps as jsteps
from multiposenet_tpu_torch import weights
from multiposenet_tpu_torch.data.loader import batch_iterator, make_batch
from multiposenet_tpu_torch.data.synthetic import make_dataset
from multiposenet_tpu_torch.models.layers import BatchNorm
from multiposenet_tpu_torch.models.posenet import MultiPoseNet
from multiposenet_tpu_torch.train import loop
from multiposenet_tpu_torch.train import steps as tsteps
from multiposenet_tpu_torch.train.checkpoints import CheckpointManager
from multiposenet_tpu_torch.utils import image_io

import torch_ddp_helpers as ddp
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, torch_config_of,
)

SIZE, BATCH, STEPS = 64, 8, 2
CPU = torch.device("cpu")
STATE_KEYS = ("params", "batch_stats", "ema_params", "mu", "nu")


def _jax_config():
    cfg = _tiny_config(image_size=SIZE, batch_size=BATCH)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="float64"),
        train=dataclasses.replace(cfg.train, log_interval_steps=1,
                                  save_interval_steps=1))


def _port_config(ckpt_dir):
    cfg = torch_config_of(_jax_config())
    return cfg.replace(train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(ckpt_dir)))


@pytest.fixture(scope="module")
def setup():
    """The global batches, the JAX package's initial state and the same
    state as the port's step-0 checkpoint."""
    jcfg = _jax_config()
    records = make_dataset(BATCH * STEPS, img_h=96, img_w=80, seed=3)
    rng = np.random.RandomState(7)
    batches = [make_batch(records[BATCH * i:BATCH * (i + 1)], SIZE,
                          jcfg.prn.max_persons, rng) for i in range(STEPS)]
    empty = batches[1]
    for key in ("keypoints", "boxes", "iscrowd", "valid"):
        empty[key][BATCH // 2:] = 0
    with jax.enable_x64(True):
        jstate = jsteps.create_train_state(jcfg, jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, {"params": jstate.params,
                                          "batch_stats": jstate.batch_stats})
    model = MultiPoseNet(torch_config_of(jcfg))
    weights.load_posenet(model, variables)
    start = tsteps.create_train_state(torch_config_of(jcfg), model=model,
                                      device=CPU)
    return {"jcfg": jcfg, "batches": batches, "jstate": jstate,
            "start": start}


def _checkpoint_dir(setup, path):
    CheckpointManager(path).save(setup["start"], force=True)
    return path


@pytest.fixture(scope="module")
def one_rank(setup, tmp_path_factory):
    """The one-process run on the global batches, float64 parameters."""
    cfg = _port_config(_checkpoint_dir(setup, tmp_path_factory.mktemp("one")))
    logged = []
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        state = loop.train(cfg, loop.GlobalBatches(setup["batches"]), STEPS,
                           log_fn=logged.append, device=CPU)
        bn = BatchNorm(3).double().train()
        x = ddp.bn_input().requires_grad_()
        y = bn(x)
        (y * y).sum().backward()
    finally:
        torch.set_default_dtype(default)
    return {"state": state.state_dict(), "metrics": logged,
            "bn_out": y.detach(), "bn_stats": (bn.running_mean,
                                               bn.running_var),
            "bn_grads": torch.cat([bn.weight.grad, bn.bias.grad])}


@pytest.fixture(scope="module", params=[2, 4], ids=["2_ranks", "4_ranks"])
def ranks(request, setup, tmp_path_factory):
    world = request.param
    ckpt = _checkpoint_dir(setup, tmp_path_factory.mktemp(f"ckpt{world}"))
    results = ddp.run_ranks(world, ddp.job_steps,
                            (_port_config(ckpt), setup["batches"], STEPS),
                            tmp_path_factory.mktemp(f"out{world}"))
    return {"world": world, "results": results, "ckpt": ckpt}


def _max_state_err(got, want) -> float:
    return max(float((got[key][k].double() - v.double()).abs().max())
               for key in STATE_KEYS for k, v in want[key].items())


def test_steps_equal_the_one_process_step_on_the_global_batch(ranks,
                                                              one_rank):
    got = ranks["results"][0]
    assert _max_state_err(got["state"], one_rank["state"]) <= 1e-10
    assert len(got["metrics"]) == len(one_rank["metrics"]) == STEPS
    for g, w in zip(got["metrics"], one_rank["metrics"]):
        assert sorted(g) == sorted(w)
        for k in w:
            if k != "images_per_sec":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-12,
                                           err_msg=k)


def test_ranks_states_stay_identical(ranks):
    sums = [r["checksum"] for r in ranks["results"]]
    assert sums == [sums[0]] * ranks["world"]
    first = ranks["results"][0]["state"]
    for r in ranks["results"][1:]:
        assert _max_state_err(r["state"], first) == 0.0


def test_metrics_and_checkpoints_are_written_once(ranks):
    lines = (ranks["ckpt"] / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == STEPS
    assert CheckpointManager(ranks["ckpt"]).all_steps() == [0, 1, 2]


def test_shards_without_positives_give_the_global_loss(ranks, one_rank):
    """Step 2's last shards hold no person: their ranks' focal and box
    denominators are still the global batch's."""
    got, want = ranks["results"][0]["metrics"][1], one_rank["metrics"][1]
    for k in ("cls_loss", "box_loss", "heatmap_loss", "total_loss"):
        assert want[k] > 0
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_batchnorm_takes_the_global_batch_statistics(ranks, one_rank):
    """Shards with channel means 0, 3, -2 and 7: the ranks' outputs,
    running statistics and summed parameter gradients are the whole
    batch's; per-shard statistics would be far from them."""
    results = ranks["results"]
    out = torch.cat([r["bn_out"] for r in results])
    np.testing.assert_allclose(out.numpy(), one_rank["bn_out"].numpy(),
                               atol=1e-12)
    for r in results:
        for got, want in zip(r["bn_stats"], one_rank["bn_stats"]):
            np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                       atol=1e-12)
        np.testing.assert_allclose(r["bn_grads"].numpy(),
                                   one_rank["bn_grads"].numpy(), rtol=1e-10,
                                   atol=1e-10)
    per_shard = torch.cat([BatchNorm(3).double().train()(part) for part in
                           ddp.bn_input().chunk(ranks["world"])])
    assert float((per_shard - one_rank["bn_out"]).abs().max()) > 0.5


def _jax_run(setup, step, shard):
    """Two JAX steps from the initial state: metrics and final weights."""
    state, metrics = setup["jstate"], []
    for b in setup["batches"]:
        state, m = step(state, shard({k: jnp.asarray(v) for k, v in b.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    host = jax.tree.map(np.asarray, state)
    return {"metrics": metrics,
            "params": weights.posenet_state_dict(
                {"params": host.params, "batch_stats": host.batch_stats}),
            "ema": weights.posenet_state_dict({"params": host.ema_params})}


@pytest.fixture(scope="module")
def jax_sharded(setup):
    """tests/test_train.py's sharded JAX step (the batch over the 8-device
    mesh, the state replicated), two steps."""
    with jax.enable_x64(True):
        mesh = jax_mesh.make_mesh()
        assert mesh.devices.size == 8
        step = jax.jit(jsteps.make_train_step(setup["jcfg"]),
                       in_shardings=(jax_mesh.replicated(mesh),
                                     jax_mesh.batch_sharding(mesh)),
                       out_shardings=(jax_mesh.replicated(mesh),) * 2)
        return _jax_run(setup, step, lambda b: jax_mesh.shard_batch(b, mesh))


def _assert_weights_within(sd, want, tol: float) -> None:
    """Every parameter and EMA element within `tol` of the JAX step's."""
    for k, v in sd["params"].items():
        for mine, theirs in ((v, want["params"][k]),
                             (sd["ema_params"][k], want["ema"][k])):
            diff = (mine.double() - theirs.double()).abs()
            assert float(diff.max()) <= tol, (k, float(diff.max()))


def test_ranks_equal_the_jax_step_sharded_over_eight_devices(
        ranks, jax_sharded):
    """Losses, gradient norm and batch statistics of both steps, and every
    parameter and EMA element, at tests/test_torch_train.py's 1e-5. The
    port normalizes as the JAX step compiled by jit does (one rounding
    for the multiply-add), so the ranks see the JAX step's input bits."""
    got, want = ranks["results"][0], jax_sharded
    for jm, tm in zip(want["metrics"], got["metrics"]):
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-9,
                                       err_msg=k)
    for k, v in got["state"]["batch_stats"].items():
        np.testing.assert_allclose(v.numpy(), want["params"][k].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    _assert_weights_within(got["state"], want, 1e-5)


def test_resume_on_four_ranks_after_two(setup, one_rank, tmp_path):
    """`train(..., mesh=2 CPUs)` spawns one rank, checkpoints step 1;
    `train(..., mesh=4 CPUs)` restores it on every rank and takes step 2:
    the state equals the one-process run's at 1e-10 (float64 parameters
    in this process and, through the loop, in the ranks it spawns)."""
    cfg = _port_config(_checkpoint_dir(setup, tmp_path / "ckpt"))
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        first = loop.train(cfg, loop.GlobalBatches(setup["batches"]), 1,
                           mesh=[CPU] * 2)
        assert first.step == 1
        second = loop.train(cfg, loop.GlobalBatches(setup["batches"][1:]),
                            STEPS, mesh=[CPU] * 4)
    finally:
        torch.set_default_dtype(default)
    assert second.step == STEPS
    assert _max_state_err(second.state_dict(), one_rank["state"]) <= 1e-10
    assert CheckpointManager(cfg.train.checkpoint_dir).all_steps() == [0, 1,
                                                                       2]


def test_spawning_needs_a_batch_source_per_rank(setup, tmp_path):
    with pytest.raises(TypeError, match="batches"):
        loop.train(_port_config(tmp_path), iter(setup["batches"]), 1,
                   mesh=[CPU] * 2)


# --- the loader's shards ------------------------------------------------------


def _loader_records(tmp_path):
    """Synthetic records, every third with segmentation masks, and JPEG
    files whose Exif orientation (6) turns them."""
    records = make_dataset(10, img_h=70, img_w=90, seed=5)
    for i, rec in enumerate(records):
        if i % 3 == 0:
            h, w = rec["image"].shape[:2]
            rec["person_mask"] = np.zeros((h, w), bool)
            rec["person_mask"][h // 4:h // 2, w // 3:] = True
    files = make_dataset(6, img_h=60, img_w=100, seed=6)
    for i, rec in enumerate(files):
        name = f"img{i}.jpg"
        data = image_io.encode_jpeg(rec.pop("image"))
        (tmp_path / name).write_bytes(with_exif(data, exif_tiff(6, False)))
        rec["file_name"] = name
    return records + files


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_batches_concatenate_to_batch_iterators(tmp_path, world):
    records = _loader_records(tmp_path)
    kw = dict(batch_size=BATCH, image_size=SIZE, max_persons=4, seed=11,
              image_dir=str(tmp_path), mask_stride=4)
    whole = batch_iterator(records, **kw)
    shards = [batch_iterator(records, rank=r, world_size=world, **kw)
              for r in range(world)]
    with_masks = 0
    for _ in range(4):
        want = next(whole)
        parts = [next(s) for s in shards]
        assert sorted(parts[0]) == sorted(want)
        with_masks += "has_mask" in want
        for k, v in want.items():
            got = np.concatenate([p[k] for p in parts])
            assert got.dtype == v.dtype
            np.testing.assert_array_equal(got, v, err_msg=k)
    assert with_masks >= 2


def test_batch_iterator_refuses_a_batch_the_ranks_do_not_divide():
    with pytest.raises(ValueError, match="shard"):
        batch_iterator([], batch_size=6, image_size=SIZE, max_persons=4,
                       world_size=4)


def test_training_mesh(monkeypatch):
    cfg = torch_config_of(_jax_config())
    assert loop.training_mesh(cfg, "cpu") == [CPU]
    assert loop.training_mesh(cfg, "cpu", 4) == [CPU] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = [torch.device("cuda", i) for i in range(3)]
    assert loop.training_mesh(cfg) == cards[:2]  # 3 does not divide 8
    assert loop.training_mesh(cfg, "cuda") == cards[:2]
    assert loop.training_mesh(cfg, "cuda:2") == cards[2:]
    assert loop.training_mesh(cfg, num_devices=1) == cards[:1]
    with pytest.raises(ValueError, match="visible"):
        loop.training_mesh(cfg, num_devices=5)


def test_spawned_ranks_arguments_pickle():
    """What a spawned rank receives pickles: its entry point, the config,
    a batch source, and the parent's torch settings (threads, default
    dtype, TF32)."""
    import pickle

    args = (1, [CPU] * 2, 1234, "gloo", torch_config_of(_jax_config()),
            loop.GlobalBatches([]), 1, False, loop._torch_settings())
    fn, back = pickle.loads(pickle.dumps((loop._rank_main, args)))
    assert fn is loop._rank_main
    assert back[-1] == (torch.get_num_threads(), torch.get_default_dtype(),
                        torch.backends.cudnn.allow_tf32,
                        torch.backends.cuda.matmul.allow_tf32)
