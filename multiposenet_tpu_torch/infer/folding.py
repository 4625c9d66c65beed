"""BatchNorm folding for inference, the port of
`multiposenet_tpu/infer/folding.py`.

At inference BN is the affine y = (conv(x) - mean) * s + beta with
s = gamma / sqrt(var + eps), which folds into the convolution:
    kernel' = kernel * s   (per output channel)
    bias'   = beta - mean * s
computed in float32. `fold_batch_norm` rewrites a flax variables tree
(nested dicts of numpy arrays) into the tree of the same model built with
`ModelConfig(bn_folded=True)`; `fold_batch_norm_` does the same in place
to a port module, for weights that never were a flax tree.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
from torch import nn


def _fold_one(conv: Mapping[str, Any], bn_params: Mapping[str, Any],
              bn_stats: Mapping[str, Any], epsilon: float) -> dict:
    kernel = np.asarray(conv["kernel"], np.float32)
    gamma, beta, mean, var = (np.asarray(t, np.float32) for t in (
        bn_params["scale"], bn_params["bias"], bn_stats["mean"],
        bn_stats["var"]))
    s = gamma / np.sqrt(var + np.float32(epsilon))
    # Flax kernels keep the output channel last (HWIO, the s4 stem's
    # [4, 4, C, O] and the depthwise (3, 3, 1, C) alike).
    return {"kernel": kernel * s, "bias": beta - mean * s}


def fold_batch_norm(variables: Mapping[str, Any],
                    epsilon: float = 1e-3) -> dict:
    """{params, batch_stats} → folded {params} for the bn_folded model:
    every module holding both a 'conv' and a 'bn' is folded; everything
    else passes through unchanged."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def walk(p: Any, s: Any) -> Any:
        if not isinstance(p, Mapping):
            return p
        if "conv" in p and "bn" in p and isinstance(s, Mapping) and "bn" in s:
            folded = {k: v for k, v in p.items() if k != "bn"}
            folded["conv"] = _fold_one(p["conv"], p["bn"], s["bn"], epsilon)
            return folded
        return {k: walk(v, s.get(k, {}) if isinstance(s, Mapping) else {})
                for k, v in p.items()}

    return {"params": walk(params, stats)}


def fold_batch_norm_(model: nn.Module) -> nn.Module:
    """Fold every conv → BN pair of a port model in place (each
    `models.mobilenet.ConvBN`'s `fold_bn_`), leaving the modules and the
    state_dict of the same model built with `ModelConfig(bn_folded=True)`.
    Returns the model."""
    for m in list(model.modules()):
        if hasattr(m, "fold_bn_"):
            m.fold_bn_()
    return model
