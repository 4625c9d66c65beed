"""The port's profiling helpers (`multiposenet_tpu_torch/utils/profiling.py`)
on the CPU: `find_nans` names the same paths as the JAX package's on
nested weights (jax.tree_util.keystr format) and reaches into a
TrainState; `fence`, `timeit` (median of repeats), `trace` (a Chrome
trace of the block) and `debug_nans` (the first non-finite module
output raises, named)."""

import json

import numpy as np
import pytest
import torch

from multiposenet_tpu.utils import profiling as jprofiling
from multiposenet_tpu_torch.utils import profiling

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)


def _tree():
    return {
        "good": np.ones(3, np.float32),
        "bad": np.asarray([1.0, np.nan], np.float32),
        "ints": np.ones(2, np.int32),
        "block": {"kernel": np.asarray([np.inf], np.float32),
                  "bias": np.zeros(2, np.float32),
                  "layers": [np.ones(1), np.asarray([np.nan])]},
    }


@pytest.mark.parametrize("prefix", ["", "params"])
def test_find_nans_paths_equal_jax(prefix):
    want = jprofiling.find_nans(_tree(), prefix)
    assert want == [prefix + "['bad']", prefix + "['block']['kernel']",
                    prefix + "['block']['layers'][1]"]
    assert profiling.find_nans(_tree(), prefix) == want
    tensors = {k: v if not isinstance(v, np.ndarray) else torch.as_tensor(v)
               for k, v in _tree().items()}
    assert profiling.find_nans(tensors, prefix) == want


def test_find_nans_in_a_train_state():
    from multiposenet_tpu_torch.models.prn import PRN
    from multiposenet_tpu_torch.train.prn_train import PRNTrainState

    prn = PRN(4, 3, 2, 5)
    state = PRNTrainState(0, prn, {"a": torch.zeros(2)},
                          {"a": torch.zeros(2)})
    assert profiling.find_nans(state) == []
    state.nu["a"][1] = float("nan")
    with torch.no_grad():
        prn.out_cm.bias[0] = float("inf")
    assert profiling.find_nans(state) == [".model['out_cm.bias']",
                                          ".nu['a']"]


def test_fence_and_timeit():
    x = torch.ones(64, 64)
    sec = profiling.timeit(lambda: x @ x, n_iters=3, n_warmup=1,
                           n_repeats=3)
    assert sec > 0
    profiling.fence({"y": x @ x})
    profiling.fence(None)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_debug_nans_names_the_first_module():
    model = torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.ReLU())
    with torch.no_grad():
        model[0].bias[1] = float("nan")
    with pytest.raises(profiling.NonFiniteError, match="module 0"):
        with profiling.debug_nans(model):
            model(torch.ones(1, 3))
    # The hooks are gone after the block; anomaly mode is restored.
    assert model(torch.ones(1, 3)).isnan().any()
    assert not torch.is_anomaly_enabled()
    with profiling.debug_nans(model, enable=False):
        model(torch.ones(1, 3))


def test_debug_nans_traps_a_nan_gradient():
    x = torch.tensor([0.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with profiling.debug_nans():
            torch.sqrt(x * 0 - 1).sum().backward()
