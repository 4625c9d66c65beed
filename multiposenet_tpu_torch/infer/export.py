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

`import_tf_checkpoint` loads TF checkpoint tensors into such a tree by
name (`mobilenet_v1_slim_name_map` for a TF-slim MobileNetV1 backbone).
It needs `tensorflow`, which it imports when called: it runs where that
package is installed (a CPU machine), not on the card's machine.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Mapping

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
        save_prn(directory, prn_variables)


def save_prn(directory: str | Path, prn_variables: Any) -> None:
    """Write the PRN's flax variables as `prn.msgpack` under `directory`
    (what the JAX package's `train-prn` writes there)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
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


def mobilenet_v1_slim_name_map(path: str) -> str | None:
    """Best-effort flax-path → TF-slim MobileNetV1 variable-name mapping.

    Covers the backbone warm start the reference used ("warm-started from
    an ImageNet ckpt", SURVEY.md §2 Backbone row). Block order matches
    slim's Conv2d_0 (stem) + Conv2d_{i}_depthwise/pointwise numbering.
    Only backbone weights map; heads keep their init. Verify shapes — the
    importer raises on mismatch.
    """
    parts = path.split("/")
    if parts[0] != "backbone":
        return None

    def bn_suffix(leaf: str) -> str | None:
        return {
            "scale": "BatchNorm/gamma",
            "bias": "BatchNorm/beta",
            "mean": "BatchNorm/moving_mean",
            "var": "BatchNorm/moving_variance",
        }.get(leaf)

    leaf = parts[-1]
    if parts[1] == "stem":
        if parts[2] == "conv" and leaf == "kernel":
            return "MobilenetV1/Conv2d_0/weights"
        if parts[2] == "bn" and bn_suffix(leaf):
            return f"MobilenetV1/Conv2d_0/{bn_suffix(leaf)}"
        return None
    if parts[1].startswith("block_"):
        i = int(parts[1].split("_")[1]) + 1  # slim numbers from 1
        kind = {"depthwise": "depthwise", "pointwise": "pointwise"}.get(
            parts[2]
        )
        if kind is None:
            return None
        base = f"MobilenetV1/Conv2d_{i}_{kind}"
        if parts[3] == "conv" and leaf == "kernel":
            w = "depthwise_weights" if kind == "depthwise" else "weights"
            return f"{base}/{w}"
        if parts[3] == "bn" and bn_suffix(leaf):
            return f"{base}/{bn_suffix(leaf)}"
    return None


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    """Nested dicts → {"a/b/c": leaf}, in the tree's key order."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = value
    return flat


def _unflatten(flat: Mapping[str, Any]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def import_tf_checkpoint(
    checkpoint_path: str,
    flax_params: Mapping[str, Any],
    name_map: Callable[[str], str | None] | Mapping[str, str],
) -> dict[str, Any]:
    """Load a TF checkpoint's tensors into a flax param tree (nested dicts
    of numpy arrays, e.g. `Predictor.variables["params"]`) by name.

    `name_map` maps a flax param path (e.g.
    'backbone/block_0/depthwise/conv/kernel') to the TF variable name, or
    None to keep the tree's value. TF and flax both store dense conv
    kernels HWIO; TF-slim *depthwise* kernels are (H, W, C, 1) where
    flax's grouped-conv kernel is (H, W, 1, C) — those are adapted
    automatically when the transposed shape matches exactly. Returns a new
    tree; raises on any other shape mismatch so silent mis-mapping is
    impossible. Needs `tensorflow` (CPU only; not on the card's machine).
    """
    try:
        import tensorflow as tf
    except ImportError as exc:
        raise ImportError(
            "import_tf_checkpoint needs the 'tensorflow' package, which is "
            "not installed here") from exc

    reader = tf.train.load_checkpoint(checkpoint_path)
    out = {}
    for path, value in _flatten(flax_params).items():
        value = np.asarray(value)
        tf_name = (
            name_map(path) if callable(name_map) else name_map.get(path)
        )
        if tf_name is None:
            out[path] = value
            continue
        tensor = np.asarray(reader.get_tensor(tf_name))
        if (
            tensor.shape != value.shape
            and tensor.ndim == 4
            and 1 in tensor.shape[-2:]
            and tensor.transpose(0, 1, 3, 2).shape == tuple(value.shape)
        ):
            # slim depthwise (H, W, C, 1) <-> flax grouped (H, W, 1, C)
            tensor = tensor.transpose(0, 1, 3, 2)
        if tensor.shape != value.shape:
            raise ValueError(
                f"shape mismatch importing {tf_name} -> {path}: "
                f"{tensor.shape} vs {value.shape}"
            )
        out[path] = tensor.astype(value.dtype)
    return _unflatten(out)
