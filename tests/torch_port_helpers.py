"""Shared fixtures for the PyTorch port's parity tests (test_torch_*.py).

Both packages get the same inputs and the same weights: flax variables are
shaped by `jax.eval_shape` of the JAX model's init (no compile) and filled
from a numpy seed, then handed to the JAX model as they are and to the port
through `multiposenet_tpu_torch.weights`. The fill gives every BatchNorm
non-trivial statistics and every bias a non-zero value, so a transposed or
misnamed parameter cannot hide behind an init of zeros and ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu import config as jax_config
from multiposenet_tpu.infer.predictor import Predictor as JaxPredictor
from multiposenet_tpu.models.posenet import MultiPoseNet as JaxMultiPoseNet
from multiposenet_tpu.models.prn import PRN as JaxPRN
from multiposenet_tpu.ops import decode_pallas, kp_tail_pallas
from multiposenet_tpu_torch import config as torch_config
from multiposenet_tpu_torch import weights
from multiposenet_tpu_torch.infer.predictor import Predictor as PortPredictor
from multiposenet_tpu_torch.models.posenet import MultiPoseNet
from multiposenet_tpu_torch.ops import decode

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch ops of a test module on one CPU thread. The suite runs in
    several worker processes on a few cores, and torch's default of one
    OpenMP thread per core in every worker oversubscribes them (the whole
    run took about twice as long); these tensors are too small to gain
    from more. Test modules take it by importing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# Input size of the predictor parity tests: 32² heatmaps, a multiple of
# the JAX tail kernel's 16-row tile, so the JAX side really takes it.
SIZE = 128


def tiny_config(compute_dtype: str = "bfloat16", package=jax_config):
    """Config.fast() at test widths, for either package's Config class.
    Keeps the fast() structure: s4 stem with the input norm folded in,
    p2_late head on raw top-down maps without a fuse conv."""
    cfg = package.Config.fast()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, backbone_width=0.25, fpn_channels=32,
            head_channels=32, backbone_stage_caps=(16, 32, 0, 0),
            backbone_max_channels=64, compute_dtype=compute_dtype),
        detector=dataclasses.replace(
            cfg.detector, score_threshold=0.0, pre_nms_top_k=100,
            max_detections=8, head_channels=32),
        prn=dataclasses.replace(
            cfg.prn, crop_height=14, crop_width=10, hidden_units=64,
            max_persons=8),
    )


def tiny_crowd_config(compute_dtype: str = "float32", package=jax_config,
                      tail: bool = True):
    """Config.crowd() at the widths of `tiny_config`, keeping crowd's IoU
    head, soft-NMS with box voting and PRN crop margin; the fused
    keypoint tail (kp_tail_pallas) on unless `tail` is False."""
    cfg = package.Config.crowd()
    tiny = tiny_config(compute_dtype, package)
    return cfg.replace(
        model=dataclasses.replace(tiny.model, kp_tail_pallas=tail),
        detector=dataclasses.replace(
            cfg.detector, score_threshold=0.0, pre_nms_top_k=100,
            head_channels=32),
        prn=dataclasses.replace(
            cfg.prn, crop_height=14, crop_width=10, hidden_units=64,
            max_persons=8),
    )


def tiny_default_config(compute_dtype: str = "float32", package=jax_config,
                        **model):
    """Config() at test widths: the stride-2 s2d stem, towers over the
    smoothed P2..P5, the fuse conv and the stride-4 output conv, 4-conv
    detector towers; `model` overrides ModelConfig fields."""
    cfg = package.Config()
    fields = dict(backbone_width=0.25, fpn_channels=32, head_channels=32,
                  compute_dtype=compute_dtype)
    fields.update(model)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **fields),
        detector=dataclasses.replace(
            cfg.detector, score_threshold=0.0, pre_nms_top_k=100,
            max_detections=8, head_channels=32),
        prn=dataclasses.replace(
            cfg.prn, crop_height=14, crop_width=10, hidden_units=64,
            max_persons=8),
    )


def torch_config_of(cfg):
    """The port's Config with the same fields as a JAX package Config."""
    return torch_config.Config.from_dict(cfg.to_dict())


def port_model(cfg, variables):
    """The port's MultiPoseNet for a JAX package Config, in eval mode,
    with the flax variables loaded."""
    model = MultiPoseNet(torch_config_of(cfg))
    weights.load_posenet(model, jax.tree.map(np.asarray, variables))
    return model.eval()


# Model outputs, port against JAX package (test_torch_models.py explains).
MODEL_TOL = {
    "float32": dict(atol=3e-5, rtol=1e-5, mean=1e-6),
    "bfloat16": dict(atol=0.04, rtol=0.02, mean=4e-3),
}


def assert_model_close(got, want, tol, what):
    got, want = to_numpy(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol["atol"], rtol=tol["rtol"],
                               err_msg=what)
    assert np.mean(np.abs(got - want)) < tol["mean"], what


def _fill(path: tuple[str, ...], shape: tuple[int, ...],
          rng: np.random.RandomState) -> np.ndarray:
    name, parent = path[-1], path[-2] if len(path) > 1 else ""
    if name in ("kernel", "heatmaps_kernel", "segmentation_kernel"):
        fan_in = int(np.prod(shape[:-1]))
        return rng.randn(*shape) / np.sqrt(fan_in)
    if parent == "bn" and name == "scale":
        return rng.uniform(0.5, 1.5, shape)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape)
    if name == "heatmaps_bias":
        # Lifts some smoothed maps above the 0.2 peak threshold.
        return 0.3 + 0.05 * rng.randn(*shape)
    return 0.1 * rng.randn(*shape)


def fill_tree(shapes, seed: int):
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = [
        _fill(tuple(k.key for k in path), s.shape, rng).astype(np.float32)
        for path, s in flat
    ]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@functools.lru_cache(maxsize=None)
def posenet_variables(cfg, image_size: int = 128, seed: int = 0):
    model = JaxMultiPoseNet(config=cfg, with_detector=True)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, image_size, image_size, 3)),
                           train=False))
    return fill_tree(shapes, seed)


@functools.lru_cache(maxsize=None)
def prn_variables(cfg, seed: int = 1):
    p = cfg.prn
    prn = JaxPRN(crop_height=p.crop_height, crop_width=p.crop_width,
                 num_keypoints=cfg.model.num_keypoints,
                 hidden_units=p.hidden_units)
    shapes = jax.eval_shape(lambda: prn.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.model.num_keypoints,
                   p.crop_height * p.crop_width))))
    return fill_tree(shapes, seed)


@functools.lru_cache(maxsize=None)
def jax_apply(cfg):
    """Jitted MultiPoseNet.apply for `cfg` (eager apply is far slower)."""
    model = JaxMultiPoseNet(config=cfg, with_detector=True)
    return jax.jit(lambda v, x: model.apply(v, x, train=False))


def planted_images(rng: np.random.RandomState, n: int, h: int,
                   w: int) -> np.ndarray:
    """uint8 [n, h, w, 3]: dark noise plus a few bright Gaussian blobs."""
    imgs = rng.randint(0, 40, (n, h, w, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        for _ in range(4):
            cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
            sig = rng.uniform(0.05, 0.12) * min(h, w)
            imgs[i] += 215.0 * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))[..., None]
    return np.clip(imgs, 0, 255).astype(np.uint8)


def chip_smoke_module():
    """chip_smoke.py at the repository root, imported as a module (its
    main() runs only as a script)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def max_abs_err(got, want) -> float:
    return float(np.max(np.abs(to_numpy(got) - to_numpy(want))))


@contextlib.contextmanager
def jax_kernels_interpreted():
    """The JAX package's tail kernel and lanes decode switched on (they
    run in interpret mode on the CPU) while its programs are traced."""
    old = kp_tail_pallas.FORCE_INTERPRET, decode_pallas.DECODE_LANES
    kp_tail_pallas.FORCE_INTERPRET = decode_pallas.DECODE_LANES = True
    try:
        yield
    finally:
        kp_tail_pallas.FORCE_INTERPRET, decode_pallas.DECODE_LANES = old


@contextlib.contextmanager
def port_lanes():
    """The port's maps-on-lanes decode switched on."""
    old = decode.DECODE_LANES
    decode.DECODE_LANES = True
    try:
        yield
    finally:
        decode.DECODE_LANES = old


def crowd_predictors(dtype, pallas):
    """The JAX and the port predictors of the crowd path at 128², on one
    unfolded tree that both fold (fold_bn=True); the JAX one with its
    Pallas decode in interpret mode when `pallas`."""
    cfg = tiny_crowd_config(dtype)
    variables = posenet_variables(cfg)
    prn_vars = prn_variables(cfg)
    jax_pred = JaxPredictor(config=cfg, variables=variables,
                            prn_variables=prn_vars, image_size=SIZE,
                            use_pallas_decode=pallas,
                            pallas_interpret=pallas, fold_bn=True)
    port = PortPredictor(torch_config_of(cfg),
                         variables=jax.tree.map(np.asarray, variables),
                         prn_variables=jax.tree.map(np.asarray, prn_vars),
                         image_size=SIZE, device="cpu", fold_bn=True)
    return jax_pred, port
