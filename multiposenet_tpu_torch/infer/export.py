"""Model export and import, the port of `multiposenet_tpu/infer/export.py`:
a directory of `config.json` and flax msgpack weights (`model.msgpack`,
optionally `prn.msgpack`), the format the JAX package's `save_model`
writes and its `load_model` reads.

The msgpack is read and written by `infer/msgpack_io.py` (no `msgpack`,
`flax` or JAX needed); the trees are flax variables as nested dicts of
numpy arrays, which `weights.py` maps onto the port's modules and back.
The JAX package's `load_model` fills a template tree built by its own
Predictor; here the tree is taken as it is and the strict state_dict
load of `weights.py` checks it against the model the config builds.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np

from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.infer import msgpack_io
from multiposenet_tpu_torch.infer.predictor import Predictor


def _flax_ordered(tree: Any) -> Any:
    """The tree with its dict keys sorted and its leaves numpy, as the JAX
    package's `save_model` hands it to flax (`jax.device_get` rebuilds
    the dicts in jax.tree_util's sorted key order)."""
    if isinstance(tree, Mapping):
        return {str(k): _flax_ordered(tree[k]) for k in sorted(tree)}
    return tree if isinstance(tree, np.generic) else np.asarray(tree)


def save_model(
    directory: str | Path,
    config: Config,
    variables: Any,
    prn_variables: Any | None = None,
) -> None:
    """Export config + weights (flax variables as nested dicts of numpy
    arrays, e.g. a port Predictor's `variables` and `prn_variables`)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "config.json").write_text(config.to_json())
    (directory / "model.msgpack").write_bytes(
        msgpack_io.pack(_flax_ordered(variables)))
    if prn_variables is not None:
        (directory / "prn.msgpack").write_bytes(
            msgpack_io.pack(_flax_ordered(prn_variables)))


def load_model(directory: str | Path):
    """Returns (config, variables, prn_variables | None)."""
    directory = Path(directory)
    config = Config.from_json((directory / "config.json").read_text())
    variables = msgpack_io.unpack((directory / "model.msgpack").read_bytes())
    prn_variables = None
    prn_path = directory / "prn.msgpack"
    if prn_path.exists():
        prn_variables = msgpack_io.unpack(prn_path.read_bytes())
    return config, variables, prn_variables


def load_predictor(directory: str | Path, **kwargs):
    """One call from an exported directory to a serving Predictor;
    `kwargs` go to the Predictor (device, fold_bn, flip_tta, ...)."""
    config, variables, prn_variables = load_model(directory)
    return Predictor(config=config, variables=variables,
                     prn_variables=prn_variables, **kwargs)
