"""Weight bridge between the JAX package's flax variables and the port's
modules, both ways.

The flax `variables` / `prn_variables` are nested dicts of numpy arrays
(for example `jax.tree.map(np.asarray, variables)`, or what
`infer/export.py load_model` reads); nothing here imports JAX.
`posenet_variables` and `prn_variables` give a port module's weights back
as that tree, which `infer/export.py save_model` writes. Conversions:
  * conv kernels HWIO → OIHW, which maps the depthwise (3, 3, 1, C) to
    (C, 1, 3, 3) and the pointwise (1, 1, C, O) to (O, C, 1, 1);
  * the stem kernel ([3, 3, C, O] at stride 2, [4, 4, C, O] at stride 4)
    stays as it is (remapped at forward time, models/mobilenet.py);
  * BatchNorm scale/bias → weight/bias, batch_stats mean/var →
    running_mean/running_var (eps stays the config's 1e-3); a BN-folded
    tree (infer/folding.py) has no `bn` and no batch_stats, and each
    folded `conv` carries a `bias`, which maps like any conv bias (the s4
    stem's included) onto the bn_folded model;
  * the IoU head's `iou_out` conv maps like the detector's other convs;
  * the keypoint head's bare heatmaps_* and segmentation_* params →
    one output conv, heatmap channels first;
  * Dense (in, out) → Linear (out, in) for the PRN.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from multiposenet_tpu_torch.models.layers import BatchNorm, Conv2d
from multiposenet_tpu_torch.models.mobilenet import StemConv


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _conv_kernel(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


def posenet_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax MultiPoseNet variables → a state_dict for models.posenet:
    float64 arrays stay float64, every other one becomes float32."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    sd: dict[str, np.ndarray] = {}
    kp = "keypoint_head."
    for name, v in params.items():
        if name.startswith(kp + "heatmaps_") or name.startswith(
                kp + "segmentation_"):
            continue
        stem, leaf = name.rsplit(".", 1)
        if leaf == "kernel":
            if stem == "backbone.stem.conv":
                sd[name] = v
            else:
                sd[f"{stem}.weight"] = _conv_kernel(v)
        elif leaf == "scale":
            sd[f"{stem}.weight"] = v
        else:
            sd[name] = v
    for name, v in stats.items():
        stem, leaf = name.rsplit(".", 1)
        sd[f"{stem}.running_{leaf}"] = v
    hm_k, hm_b = params[kp + "heatmaps_kernel"], params[kp + "heatmaps_bias"]
    if kp + "segmentation_kernel" in params:
        hm_k = np.concatenate([hm_k, params[kp + "segmentation_kernel"]], -1)
        hm_b = np.concatenate([hm_b, params[kp + "segmentation_bias"]])
    sd[kp + "output.weight"] = _conv_kernel(hm_k)
    sd[kp + "output.bias"] = hm_b
    return {k: torch.as_tensor(np.array(
        v, np.float64 if v.dtype == np.float64 else np.float32))
        for k, v in sd.items()}


def prn_state_dict(prn_variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax PRN variables → a state_dict for models.prn."""
    sd = {}
    for name, v in _flatten(prn_variables["params"]).items():
        stem, leaf = name.rsplit(".", 1)
        if leaf == "kernel":
            sd[f"{stem}.weight"] = np.ascontiguousarray(v.T)
        else:
            sd[name] = v
    return {k: torch.as_tensor(np.array(v, np.float32)) for k, v in sd.items()}


def load_posenet(model: nn.Module, variables: Mapping[str, Any]) -> None:
    """Load flax variables into a models.posenet.MultiPoseNet (strict)."""
    model.load_state_dict(posenet_state_dict(variables), strict=True)


def load_prn(model: nn.Module, prn_variables: Mapping[str, Any]) -> None:
    """Load flax variables into a models.prn.PRN (strict)."""
    model.load_state_dict(prn_state_dict(prn_variables), strict=True)


def _put(tree: dict, path: str, value: torch.Tensor | np.ndarray) -> None:
    *parents, leaf = path.split(".")
    for key in parents:
        tree = tree.setdefault(key, {})
    # A copy: the tree must not alias the module's parameters.
    tree[leaf] = torch.as_tensor(value).detach().cpu().numpy().astype(
        np.float32)


def posenet_variables(model: nn.Module) -> dict[str, Any]:
    """A models.posenet.MultiPoseNet's weights as the flax variables of the
    JAX model with the same config: {'params'[, 'batch_stats']} (the
    inverse of posenet_state_dict; a folded model has no batch_stats)."""
    params: dict = {}
    stats: dict = {}
    k = model.keypoint_head.num_keypoints
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            _put(params, f"{name}.scale", mod.weight)
            _put(params, f"{name}.bias", mod.bias)
            _put(stats, f"{name}.mean", mod.running_mean)
            _put(stats, f"{name}.var", mod.running_var)
            continue
        if isinstance(mod, StemConv):
            kernel = mod.kernel
        elif isinstance(mod, Conv2d):
            kernel = mod.weight.permute(2, 3, 1, 0)
        else:
            continue
        if name == "keypoint_head.output":
            head = name.rsplit(".", 1)[0]
            _put(params, f"{head}.heatmaps_kernel", kernel[..., :k])
            _put(params, f"{head}.heatmaps_bias", mod.bias[:k])
            if kernel.shape[-1] > k:
                _put(params, f"{head}.segmentation_kernel", kernel[..., k:])
                _put(params, f"{head}.segmentation_bias", mod.bias[k:])
            continue
        _put(params, f"{name}.kernel", kernel)
        if mod.bias is not None:
            _put(params, f"{name}.bias", mod.bias)
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def prn_variables(model: nn.Module) -> dict[str, Any]:
    """A models.prn.PRN's weights as the JAX PRN's flax variables."""
    params: dict = {}
    for name in ("hidden_cm", "out_cm"):
        layer = getattr(model, name)
        _put(params, f"{name}.kernel", layer.weight.T)
        _put(params, f"{name}.bias", layer.bias)
    return {"params": params}
