"""Export in the port (`multiposenet_tpu_torch.infer.export` and its
msgpack codec `infer/msgpack_io.py`) against the JAX package's
`infer/export.py` and flax's serialization: a directory the JAX package
writes serves through the port's `load_predictor`, and a directory the
port writes reads back through the JAX package's `load_model`.

Nothing here has a tolerance: weights are float32 arrays copied through
bytes, so the trees are equal element for element, the files byte for
byte, and a predictor loaded from a directory gives the outputs of one
built from the same variables bit for bit.
"""

import dataclasses
import struct

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from multiposenet_tpu.infer import export as jax_export
from multiposenet_tpu_torch import weights
from multiposenet_tpu_torch.infer import export, msgpack_io
from multiposenet_tpu_torch.infer.predictor import Predictor

from torch_port_helpers import (
    one_torch_thread,  # noqa: F401 (autouse)
    planted_images,
    posenet_variables,
    prn_variables,
    tiny_default_config,
    torch_config_of,
)

SIZE = 128


def _config():
    """Config() at test widths, its train image size at the test's (the
    JAX `load_model` builds its template at that size)."""
    cfg = tiny_default_config("float32")
    return cfg.replace(train=dataclasses.replace(cfg.train, image_size=SIZE))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got, want):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def _assert_same_outputs(a: Predictor, b: Predictor):
    batch = planted_images(np.random.RandomState(0), 2, SIZE, SIZE)
    out_a, out_b = a.batch_forward(batch), b.batch_forward(batch)
    assert out_a["box_valid"].any()
    for key in out_a:
        assert torch.equal(out_a[key], out_b[key]), key


@pytest.mark.parametrize("fold_bn", [False, True])
def test_jax_export_serves_through_port_load_predictor(tmp_path, fold_bn):
    """One call from the JAX package's export directory to a serving port
    predictor, folding the BatchNorms on the way when asked: the outputs
    of a predictor built from the same variables, bit for bit."""
    cfg = _config()
    variables, prn_vars = posenet_variables(cfg), prn_variables(cfg)
    jax_export.save_model(tmp_path, cfg, variables, prn_vars)
    loaded = export.load_predictor(tmp_path, image_size=SIZE, device="cpu",
                                   fold_bn=fold_bn)
    assert loaded.config.model.bn_folded == fold_bn
    built = Predictor(torch_config_of(cfg), variables=_numpy(variables),
                      prn_variables=_numpy(prn_vars), image_size=SIZE,
                      device="cpu", fold_bn=fold_bn)
    assert loaded.config == built.config
    _assert_same_outputs(loaded, built)
    _assert_trees_equal(loaded.prn_variables, _numpy(prn_vars))
    if not fold_bn:
        assert loaded.config == torch_config_of(cfg)
        _assert_trees_equal(loaded.variables, _numpy(variables))


@pytest.mark.parametrize("fold_bn", [False, True])
def test_port_export_reads_back_through_jax_load_model(tmp_path, fold_bn):
    """The port's own seeded predictor (BN folded or not) saved by the
    port: the JAX package's load_model reads every array back unchanged,
    the files equal flax's bytes for the same trees, and the port's
    load_predictor serves the same outputs."""
    cfg = torch_config_of(_config())
    pred = Predictor(cfg, image_size=SIZE, device="cpu", fold_bn=fold_bn)
    export.save_model(tmp_path, pred.config, pred.variables,
                      pred.prn_variables)
    config, variables, prn_vars = jax_export.load_model(tmp_path)
    assert config.model.bn_folded == fold_bn
    assert ("batch_stats" in variables) != fold_bn
    _assert_trees_equal(_numpy(variables), pred.variables)
    _assert_trees_equal(_numpy(prn_vars), pred.prn_variables)
    assert (tmp_path / "model.msgpack").read_bytes() == \
        flax.serialization.to_bytes(jax.device_get(variables))
    _assert_same_outputs(export.load_predictor(tmp_path, image_size=SIZE,
                                               device="cpu"), pred)


def test_variables_round_trip_the_weight_bridge():
    """posenet_state_dict ∘ posenet_variables is the identity on the port
    model's state_dict (Config(): s2 stem, smooth_P2, P2 towers, fuse)."""
    pred = Predictor(torch_config_of(_config()), image_size=SIZE,
                     device="cpu")
    sd = weights.posenet_state_dict(pred.variables)
    want = pred.model.state_dict()
    assert sd.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(sd[key], value), key


def test_msgpack_bytes_equal_flax():
    """A tree with every leaf kind flax writes (arrays of several dtypes
    and ranks, numpy scalars, long and short keys, a 20-key map) packs to
    flax's bytes (both keep the tree's key order), and each side reads
    the other's back."""
    rng = np.random.RandomState(0)
    tree = {
        "a": rng.randn(3, 4).astype(np.float32),
        "b": {"ints": np.arange(300, dtype=np.int64).reshape(3, 100),
              "u8": rng.randint(0, 256, (7,)).astype(np.uint8),
              "flag": np.array([True, False]),
              "scalar": np.float32(2.5), "half": np.float16(-1.0)},
        "k" * 40: np.zeros((0, 3), np.float64),
        "wide": {f"key_{i:02d}": np.full((i,), i, np.int32)
                 for i in range(20)},
    }
    want = flax.serialization.to_bytes(tree)
    assert msgpack_io.pack(tree) == want
    _assert_trees_equal(msgpack_io.unpack(want), tree)
    _assert_trees_equal(flax.serialization.msgpack_restore(
        msgpack_io.pack(tree)), tree)


def test_chunked_arrays_round_trip(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes (lowered here on both sides to 64)
    are written as flax chunks them and joined again on reading."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(1)
    tree = {"big": rng.randn(10, 7).astype(np.float32),
            "small": rng.randn(3).astype(np.float32),
            "nested": {"big": np.arange(50, dtype=np.int64)}}
    want = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in want
    assert msgpack_io.pack(tree) == want
    _assert_trees_equal(msgpack_io.unpack(want), tree)
    _assert_trees_equal(flax.serialization.msgpack_restore(
        msgpack_io.pack(tree)), tree)


def _ext(code: int, payload: bytes) -> bytes:
    """A one-entry map {'x': ext(code, payload)}."""
    return (b"\x81\xa1x\xc7" + bytes([len(payload)])
            + struct.pack(">b", code) + payload)


@pytest.mark.parametrize("case", ["complex_ext", "unknown_ext",
                                  "bfloat16", "complex64", "write_complex64"])
def test_unknown_ext_codes_and_dtypes_raise(case):
    """Reading raises on flax's complex ext (2), on an ext code flax never
    writes, and on dtypes outside msgpack_io.DTYPES (bfloat16 has no numpy
    dtype here); writing raises on such a dtype too."""
    if case == "complex_ext":       # flax's native complex
        data = flax.serialization.to_bytes({"x": 1 + 2j})
    elif case == "unknown_ext":
        data = _ext(5, b"\x00" * 4)
    elif case == "bfloat16":
        data = flax.serialization.to_bytes(
            {"x": np.asarray(jax.numpy.ones(3, jax.numpy.bfloat16))})
    elif case == "complex64":
        data = flax.serialization.to_bytes(
            {"x": np.ones(3, np.complex64)})
    else:
        with pytest.raises(msgpack_io.MsgpackError):
            msgpack_io.pack({"x": np.ones(2, np.complex64)})
        return
    with pytest.raises(msgpack_io.MsgpackError):
        msgpack_io.unpack(data)
