"""The JAX package's AP gates (tests/test_integration_smoke.py and
tests/test_integration_ap.py) for both packages: their `_config()`, their
fixtures v1 records at 96², each package's training through its own
loader, trainer, PRN trainer and Predictor, and the gates' statistics
through each package's own OKS evaluator.

The port starts from the JAX package's flax init carried across
(`weights.load_posenet`, `weights.load_prn`): the model and the PRN from
PRNGKey(seed), as the JAX trainers draw them with train.seed = seed.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import torch

from multiposenet_tpu import config as jax_config
from multiposenet_tpu.data import loader as jloader
from multiposenet_tpu.data import synthetic as jsynthetic
from multiposenet_tpu.eval import oks as joks
from multiposenet_tpu.eval import runner as jrunner
from multiposenet_tpu.infer.predictor import Predictor as JaxPredictor
from multiposenet_tpu.parallel import mesh as jmesh
from multiposenet_tpu.train import loop as jloop
from multiposenet_tpu.train import prn_train as jprn
from multiposenet_tpu.train import steps as jsteps
from multiposenet_tpu_torch import config as torch_config
from multiposenet_tpu_torch import weights
from multiposenet_tpu_torch.data import loader as tloader
from multiposenet_tpu_torch.data import synthetic as tsynthetic
from multiposenet_tpu_torch.eval import oks as toks
from multiposenet_tpu_torch.eval import runner as trunner
from multiposenet_tpu_torch.infer.predictor import Predictor as PortPredictor
from multiposenet_tpu_torch.models.posenet import MultiPoseNet
from multiposenet_tpu_torch.train import loop as tloop
from multiposenet_tpu_torch.train import prn_train as tprn
from multiposenet_tpu_torch.train import steps as tsteps

SIZE = 96
# Records, steps and PRN steps of each gate; the eval records come from
# seed 77, the training records from seed 0.
RECIPES = {
    "smoke": dict(train_records=48, eval_records=8, steps=100, warmup=12,
                  prn_steps=56),
    "ap": dict(train_records=64, eval_records=12, steps=500, warmup=20,
               prn_steps=150),
}
# The JAX gates' calibration (their docstrings): GT-box and e2e stats.
CALIBRATION = {
    "smoke": {"gtbox": {"AP50": 1.0, "AP": 0.652},
              "e2e": {"AP50": 0.601, "AR50": 0.769}},
    "ap": {"gtbox": {"AP50": 1.0, "AP": 0.687, "AP75": 0.937},
           "e2e": {"AP50": 0.738, "AR50": 0.765}},
}


def gate_config(recipe: str, seed: int = 0, package=jax_config, **model):
    """The JAX gate's `_config()` for `package` (either package's config
    module), train.seed = seed; `model` overrides ModelConfig fields."""
    r = RECIPES[recipe]
    return package.Config(
        model=package.ModelConfig(backbone_width=0.25, fpn_channels=32,
                                  head_channels=32, bn_momentum=0.9,
                                  **model),
        detector=package.DetectorConfig(score_threshold=0.05,
                                        max_detections=6, pre_nms_top_k=100),
        prn=package.PRNConfig(crop_height=14, crop_width=10,
                              hidden_units=128, max_persons=4),
        decode=package.DecodeConfig(score_threshold=0.1),
        train=package.TrainConfig(image_size=SIZE, batch_size=8,
                                  num_steps=r["steps"],
                                  warmup_steps=r["warmup"],
                                  learning_rate=3e-3, seed=seed),
    )


def gate_records(make_dataset, n: int, seed: int) -> list[dict]:
    """The gates' fixtures v1 scenes, scale floor 0.3."""
    return make_dataset(n, img_h=SIZE, img_w=SIZE, min_persons=1,
                        max_persons=2, seed=seed, style="v1",
                        min_size=0.3, max_size=0.65)


def jax_init(cfg, seed: int) -> tuple[dict, dict]:
    """The JAX package's init from PRNGKey(seed): the model's variables
    and the PRN's, as numpy trees."""
    state = jsteps.create_train_state(cfg, jax.random.PRNGKey(seed))
    prn = jprn.create_prn_state(cfg, jax.random.PRNGKey(seed))
    tree = functools.partial(jax.tree.map, np.asarray)
    return ({"params": tree(state.params),
             "batch_stats": tree(state.batch_stats)}, tree(prn.params))


def train_jax(recipe: str, seed: int = 0, devices: int = 1) -> JaxPredictor:
    """The JAX gate's fixture on the first `devices` devices (one, as the
    smoke gate trains; the slow gate's mesh is all 8)."""
    r = RECIPES[recipe]
    cfg = gate_config(recipe, seed)
    records = gate_records(jsynthetic.make_dataset, r["train_records"], 0)
    state = jloop.train(
        cfg, jloader.batch_iterator(records, 8, SIZE, cfg.prn.max_persons,
                                    train=True, augment=False),
        checkpoint=False, mesh=jmesh.make_mesh(jax.devices()[:devices]))
    prn_state = jprn.train_prn(
        cfg, jloader.batch_iterator(records, 8, SIZE, cfg.prn.max_persons,
                                    train=True, augment=False),
        num_steps=r["prn_steps"])
    state = jax.device_get(state)
    return JaxPredictor(
        config=cfg, variables={"params": state.ema_params,
                               "batch_stats": state.batch_stats},
        prn_variables=jax.device_get(prn_state.params), image_size=SIZE)


def train_port(recipe: str, seed: int = 0, checkpoint_dir: str | None = None,
               num_devices: int = 1, init: tuple | None = None
               ) -> PortPredictor:
    """The same fixture through the port on the CPU, from the JAX
    package's init (`init`, else `jax_init` of the gate's config):
    `loop.train` on `num_devices` ranks (gloo), `prn_train.train_prn`,
    and the Predictor on the EMA parameters."""
    r = RECIPES[recipe]
    jcfg = gate_config(recipe, seed)
    cfg = gate_config(recipe, seed, package=torch_config)
    if checkpoint_dir is not None:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, checkpoint_dir=checkpoint_dir))
    variables, prn_variables = init or jax_init(jcfg, seed)
    model = MultiPoseNet(cfg)
    weights.load_posenet(model, variables)
    prn = tprn.make_prn(cfg)
    weights.load_prn(prn, prn_variables)
    records = gate_records(tsynthetic.make_dataset, r["train_records"], 0)
    batches = functools.partial(tloader.batch_iterator, records, 8, SIZE,
                                cfg.prn.max_persons, train=True,
                                augment=False)
    state = tloop.train(cfg, batches, checkpoint=False, device="cpu",
                        num_devices=num_devices, model=model)
    prn_state = tprn.train_prn(cfg, batches(), num_steps=r["prn_steps"],
                               device="cpu", prn=prn)
    with tsteps.ema_weights(state) as ema:
        ema_variables = weights.posenet_variables(ema)
    return PortPredictor(config=cfg, variables=ema_variables,
                         prn_variables=weights.prn_variables(prn_state.model),
                         image_size=SIZE, device="cpu")


def gate_stats(predictor, eval_records: list[dict], oks=toks,
               runner=trunner) -> dict:
    """The gates' statistics through `oks` and `runner` (either
    package's): GT-box OKS stats, the mean matched keypoint error in
    heatmap pixels, and the detector-driven e2e stats."""
    ev = oks.KeypointEvaluator()
    errs = []
    for rec in eval_records:
        kps = predictor.predict_given_boxes(rec["image"], rec["boxes"])
        dts = []
        for p in range(len(rec["boxes"])):
            dts.append(oks.DetectionKP(keypoints=kps[p].astype(np.float32),
                                       score=1.0))
            gt = rec["keypoints"][p]
            vis = gt[:, 2] > 0
            errs.append(np.linalg.norm(kps[p][vis, :2] - gt[vis, :2],
                                       axis=-1))
        ev.add_image(runner.record_ground_truths(rec), dts)
    return {"gtbox": ev.summarize(),
            "mean_err_hm_px": float(np.concatenate(errs).mean()) / 4.0,
            "e2e": runner.evaluate_predictor(predictor, eval_records)}


def port_gate(recipe: str, seed: int = 0, threads: int = 1, **kw) -> dict:
    """`gate_stats` of `train_port` on the port's eval records, on
    `threads` torch threads (one: the tests' reduction order)."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        predictor = train_port(recipe, seed, **kw)
        records = gate_records(tsynthetic.make_dataset,
                               RECIPES[recipe]["eval_records"], 77)
        return gate_stats(predictor, records)
    finally:
        torch.set_num_threads(before)


def jax_gate(recipe: str, seed: int = 0, devices: int = 1) -> dict:
    """`gate_stats` of `train_jax` through the JAX package's evaluator."""
    records = gate_records(jsynthetic.make_dataset,
                           RECIPES[recipe]["eval_records"], 77)
    return gate_stats(train_jax(recipe, seed, devices), records, joks,
                      jrunner)
