"""Inference API, the port of `multiposenet_tpu/infer/predictor.py`:
batched images or one image → joint forward → heatmap decode → person
detection + NMS → PRN keypoint assignment.

`Predictor.batch_forward` is the counterpart of `_batch_forward_impl`
(the path `bench.py` times; every uint8 batch layout it takes),
`predict` of `predict`; `predict_heatmaps`, `predict_keypoints` and
`predict_given_boxes` are the keypoint-only and given-box entry points,
and `make_batch_runner` hands out `batch_forward` on the one card.
`flip_tta` averages the heatmaps with those of the horizontally flipped
input, and `detector.pose_nms_oks > 0` drops duplicate poses after the
PRN (`ops/pose_nms.py`), as in the JAX package. On a CUDA device every
heatmap decode goes through a hand-written kernel: the channel-major
decode of the pipeline through `csrc/decode_peaks.cu` (B1), or
`csrc/decode_lanes.cu` (B2) when
`ops.decode.DECODE_LANES` is set, and the NHWC decode of
`predict_keypoints` through B1, as the JAX package's `_decode` goes
through its B1; a decode config that B1 and B2 do not take (a peak
window other than 3, more than 16 peaks or 15 taps, maps wider than 512)
goes through `csrc/decode_generic.cu`, as the JAX package decodes it
with its jnp decode. `fold_bn=True` serves the model with its BatchNorms
folded into the convs (`infer/folding.py`), as an exported model is
served; `infer/export.py` saves and loads the weights in the JAX
package's export format (`variables`, `prn_variables`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from multiposenet_tpu_torch import weights
from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.infer import folding
from multiposenet_tpu_torch.models.posenet import MultiPoseNet, torch_dtype
from multiposenet_tpu_torch.models.prn import PRN
from multiposenet_tpu_torch.ops import decode as decode_ops
from multiposenet_tpu_torch.ops import image as image_ops
from multiposenet_tpu_torch.ops import prn_ops
from multiposenet_tpu_torch.ops.anchors import all_anchors
from multiposenet_tpu_torch.ops.detection import postprocess_detections
from multiposenet_tpu_torch.ops.pose_nms import pose_nms
from multiposenet_tpu_torch.parallel import mesh as mesh_lib
from multiposenet_tpu_torch.utils.constants import FLIP_PERMUTATION


@dataclasses.dataclass
class PersonPrediction:
    """One detected person: box (y0, x0, y1, x1), score, keypoints[17, 3]
    rows of (x, y, score) in original image coordinates."""

    box: np.ndarray
    score: float
    keypoints: np.ndarray


def _check_image(image: np.ndarray) -> np.ndarray:
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(
            "predict expects an RGB image of shape [H, W, 3], got "
            f"{image.shape}")
    return image


def _flip_channels() -> dict[int, list[int]]:
    """The channel permutation that mirrors a cell's columns, by the cell
    layout's channel count: 2x2 cells (py, px, c) swap px; 4x4 cells
    (py1, px1, py0, px0, c) swap both column phases."""
    s2d = [(py * 2 + (1 - px)) * 3 + c
           for py in (0, 1) for px in (0, 1) for c in range(3)]
    s4 = [((py1 * 2 + (1 - px1)) * 4 + py0 * 2 + (1 - px0)) * 3 + c
          for py1 in (0, 1) for px1 in (0, 1)
          for py0 in (0, 1) for px0 in (0, 1) for c in range(3)]
    return {12: s2d, 48: s4}


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The caller's device, or CUDA when none is given. Without a GPU the
    caller must ask for the CPU: there is no silent fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Predictor:
    """Holds the model and PRN weights on one device and serves
    predictions. Weights come from the JAX package's flax variables
    (nested dicts of numpy arrays, see weights.py; folded or not) or, when
    none are given, from a seeded random init. With fold_bn the
    BatchNorms are folded into the convs, before the load for a flax tree
    and in place after the init otherwise, and the config says
    bn_folded."""

    def __init__(
        self,
        config: Config | None = None,
        variables: Any | None = None,
        prn_variables: Any | None = None,
        image_size: int | None = None,
        rng_seed: int = 0,
        device: str | torch.device | None = None,
        fold_bn: bool = False,
        flip_tta: bool = False,
    ):
        cfg = config or Config()
        self.flip_tta = flip_tta
        self.device = resolve_device(device)
        self.image_size = image_size or cfg.train.image_size
        self.dtype = torch_dtype(cfg.model.compute_dtype)
        fold = fold_bn and not cfg.model.bn_folded
        folded_cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                           bn_folded=True))
        generator = torch.Generator().manual_seed(rng_seed)
        if variables is None:
            self.model = MultiPoseNet(cfg)
            self.model.init_weights(generator)
            if fold:
                folding.fold_batch_norm_(self.model)
                self.model.config = folded_cfg
        else:
            if fold:
                variables = folding.fold_batch_norm(variables,
                                                    cfg.model.bn_epsilon)
            self.model = MultiPoseNet(folded_cfg if fold else cfg)
            weights.load_posenet(self.model, variables)
        self.config = cfg = folded_cfg if fold else cfg
        self.prn = PRN(cfg.prn.crop_height, cfg.prn.crop_width,
                       cfg.model.num_keypoints, cfg.prn.hidden_units,
                       dtype=self.dtype)
        if prn_variables is None:
            self.prn.init_weights(generator)
        else:
            weights.load_prn(self.prn, prn_variables)
        self.model.to(self.device).eval()
        self.prn.to(self.device).eval()
        self.anchors = torch.as_tensor(
            all_anchors(self.image_size, cfg.detector).copy(),
            device=self.device)
        self._flip = {c: torch.as_tensor(perm, device=self.device)
                      for c, perm in _flip_channels().items()}
        self._flip_keypoints = torch.as_tensor(np.array(FLIP_PERMUTATION),
                                               device=self.device)

    @property
    def variables(self) -> dict[str, Any]:
        """The model's weights as the JAX package's flax variables (numpy),
        folded when the predictor serves the model folded."""
        return weights.posenet_variables(self.model)

    @property
    def prn_variables(self) -> dict[str, Any]:
        """The PRN's weights as the JAX package's flax variables."""
        return weights.prn_variables(self.prn)

    def _forward(self, x: torch.Tensor) -> dict[str, Any]:
        """Model forward; with flip_tta the NHWC float32 heatmaps are
        averaged with those of the horizontally flipped input, flipped
        back and with the left/right keypoint channels swapped. The input
        flips in its own layout: for cells, the cell columns reverse and
        the column phases inside each cell swap. The head's channel-major
        maps are then stale and dropped (`_heatmaps_cm` remakes them)."""
        out = self.model(x)
        if not self.flip_tta:
            return out
        out.pop("heatmaps_cm", None)
        xf = torch.flip(x, [2])
        if x.shape[-1] in self._flip:
            xf = xf[..., self._flip[x.shape[-1]]]
        hm_f = torch.flip(self.model(xf)["heatmaps"], [2])
        hm_f = hm_f[..., self._flip_keypoints]
        out["heatmaps"] = 0.5 * (out["heatmaps"] + hm_f)
        return out

    def _heatmaps_cm(self, out: dict[str, Any]) -> torch.Tensor:
        """Channel-major heatmaps [B, K, H, W] in the compute dtype: the
        head's own output, or (flip TTA) a contiguous copy of the averaged
        NHWC maps, which B1 takes (a strided view would go to the generic
        decode kernel)."""
        if "heatmaps_cm" in out:
            return out["heatmaps_cm"]
        return out["heatmaps"].to(self.dtype).permute(0, 3, 1, 2).contiguous()

    # ------------------------------------------------------------------ #

    def _decode_cm(self, hm_cm: torch.Tensor) -> decode_ops.DecodedPeaks:
        """Decode the channel-major heatmaps; on a CUDA tensor this is one
        launch of B1, or of B2 when DECODE_LANES is set (of the generic
        kernel where the config is one they do not take)."""
        if decode_ops.DECODE_LANES:
            return decode_ops.decode_heatmaps_lanes(hm_cm, self.config.decode)
        return decode_ops.decode_heatmaps_cm(hm_cm, self.config.decode)

    def _decode(self, heatmaps: torch.Tensor) -> decode_ops.DecodedPeaks:
        """Decode NHWC heatmaps [B, H, W, K] with B1 through their
        channel-major copy in the compute dtype (lossless unless flip TTA
        averaged them: the model computed them in it), as
        decode_heatmaps_pallas does."""
        return decode_ops.decode_heatmaps(heatmaps.to(self.dtype),
                                          self.config.decode)

    def _prn_assign(self, heatmaps_cm: torch.Tensor, hm_boxes: torch.Tensor,
                    peaks: decode_ops.DecodedPeaks | None) -> torch.Tensor:
        """Channel-major heatmaps + person boxes (heatmap coords) → per-person
        keypoints [B, D, K, 3] (x, y, score) in heatmap coordinates, snapped
        to the decoded peaks."""
        cfg = self.config
        hm_boxes = prn_ops.expand_boxes(hm_boxes, cfg.prn.crop_margin)
        b, d = hm_boxes.shape[:2]
        crops = prn_ops.crop_heatmaps_cm(heatmaps_cm, hm_boxes,
                                         cfg.prn.crop_height,
                                         cfg.prn.crop_width)
        crops_km = prn_ops.to_channel_major(crops, cfg.model.num_keypoints)
        prn_out = self.prn(crops_km, return_logits=True)
        keypoints = prn_ops.keypoints_from_prn(
            prn_out, crops_km, hm_boxes.reshape(b * d, 4),
            cfg.prn.crop_height, cfg.prn.crop_width,
        ).reshape(b, d, cfg.model.num_keypoints, 3)
        if peaks is not None and cfg.prn.snap_radius_cells > 0:
            keypoints = prn_ops.snap_to_peaks(
                keypoints, hm_boxes, peaks.positions, peaks.scores,
                peaks.valid, cfg.prn.crop_height, cfg.prn.crop_width,
                cfg.prn.snap_radius_cells,
            )
        return keypoints

    def _pipeline(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """Model input (NHWC pixels or cells) → boxes, keypoints and peaks
        in model-input coordinates; duplicate poses dropped from
        box_valid when pose_nms_oks > 0."""
        cfg = self.config
        out = self._forward(x)
        hm_cm = self._heatmaps_cm(out)
        peaks = self._decode_cm(hm_cm)
        det = postprocess_detections(out["detector"], self.image_size,
                                     cfg.detector, anchors=self.anchors)
        stride = float(cfg.model.output_stride)
        keypoints = self._prn_assign(hm_cm, det.boxes / stride, peaks)
        keypoints[..., :2] *= stride
        box_valid = det.valid
        if cfg.detector.pose_nms_oks > 0.0:
            box_valid = pose_nms(keypoints, det.boxes, box_valid,
                                 cfg.detector.pose_nms_oks)
        return {
            "boxes": det.boxes,
            "box_scores": det.scores,
            "box_valid": box_valid,
            "keypoints": keypoints,
            "peak_positions": peaks.positions * stride,
            "peak_scores": peaks.scores,
            "peak_valid": peaks.valid,
        }

    def _model_input(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 batch → model input, by its layout (the JAX package's
        `_batch_forward_impl` dispatch):
          * [B, S/4, S*12] s4-flat → 4x4 cells;
          * [B, S*12, S/4] transposed s4-flat → 4x4 cells;
          * [B, S/2, S*6] s2d-flat → 2x2 cells;
          * [B, S, S, 3] → pixels;
          * [B, Hs, Ws, 3] → pixels resized to S (two constant-matrix
            products).
        Normalized unless the stem folds the normalize."""
        raw = self.config.model.fold_input_norm
        if images.ndim == 3 and images.shape[2] == images.shape[1] * 48:
            return (image_ops.s4_flat_to_cells(images, self.dtype) if raw
                    else image_ops.normalize_s4_flat(images, self.dtype))
        if images.ndim == 3 and images.shape[1] == images.shape[2] * 48:
            flat = images.transpose(1, 2)
            return (image_ops.s4_flat_to_cells(flat, self.dtype) if raw
                    else image_ops.normalize_s4_flat(flat, self.dtype))
        if images.ndim == 3:
            return (image_ops.s2d_flat_to_cells(images, self.dtype) if raw
                    else image_ops.normalize_s2d_flat(images, self.dtype))
        if images.ndim != 4:
            raise ValueError("batch_forward takes [B, H, W, 3] images or a "
                             f"flat staging; got {tuple(images.shape)}")
        if images.shape[1:3] == (self.image_size, self.image_size):
            return images.float() if raw else image_ops.normalize(images)
        return image_ops.resize_normalize_batch(images, self.image_size,
                                                normalize_out=not raw)

    @torch.inference_mode()
    def batch_forward(self, images: np.ndarray | torch.Tensor
                      ) -> dict[str, torch.Tensor]:
        """uint8 batch → per-image detections and keypoints (tensors on the
        predictor's device, model-input coordinates).

        images: [B, S/4, S*12] staged by ops.image.space_to_depth_flat4
        (the stride-4 stem's fast path), its transpose [B, S*12, S/4]
        (space_to_depth_flat4_t), [B, S/2, S*6] staged by
        space_to_depth_flat (the stride-2 stem's), [B, S, S, 3] already
        letterboxed to S, or [B, Hs, Ws, 3] at any fixed staging size,
        resized to S on the device."""
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        return self._pipeline(self._model_input(images))

    def _replica(self, device: torch.device) -> "Predictor":
        """This predictor on another device: the model and PRN copied
        there from the same state (`parallel/mesh.replicate`)."""
        rep = copy.copy(self)
        rep.device = device
        rep.model = mesh_lib.replicate(self.model, [device])[0]
        rep.prn = mesh_lib.replicate(self.prn, [device])[0]
        rep.anchors = self.anchors.to(device)
        rep._flip = {c: t.to(device) for c, t in self._flip.items()}
        rep._flip_keypoints = self._flip_keypoints.to(device)
        return rep

    def make_batch_runner(self, mesh: Sequence[torch.device] | None = None):
        """fn(uint8 batch) → output dict, the JAX package's runner with the
        batch sharded over `mesh` (default every visible card,
        `parallel/mesh.make_mesh`, or the CPU for a predictor on the CPU):
        a replica of the model on each device
        runs its chunk of the batch (in order) through the same pipeline,
        so B1, B2 and B3 launch on every card; every device's work is
        issued before anything waits, and the outputs come back
        concatenated in batch order on the first device. A batch the mesh
        does not divide raises. On a one-device mesh of this predictor's
        device the runner is `batch_forward` itself."""
        own = mesh_lib.canonical(self.device)
        mesh = mesh_lib.make_mesh(
            [own] if mesh is None and own.type == "cpu" else mesh)
        if mesh == [own]:
            return self.batch_forward
        replicas = [self if d == own else self._replica(d) for d in mesh]

        @torch.inference_mode()
        def run(images: np.ndarray | torch.Tensor) -> dict[str, torch.Tensor]:
            images = torch.as_tensor(images)
            outs = [rep._pipeline(rep._model_input(chunk)) for rep, chunk in
                    zip(replicas, mesh_lib.shard_batch(images, mesh))]
            return {k: torch.cat([o[k].to(mesh[0], non_blocking=True)
                                  for o in outs]) for k in outs[0]}

        return run

    def _letterbox(self, image: np.ndarray) -> tuple[torch.Tensor, float]:
        """uint8 [H, W, 3] → model input [1, S, S, 3] on the device and the
        letterbox scale."""
        x, scale = image_ops.resize_pad_normalize(
            torch.as_tensor(image, device=self.device), self.image_size,
            normalize_out=not self.config.model.fold_input_norm,
        )
        return x[None], scale

    @torch.inference_mode()
    def predict_heatmaps(self, image: np.ndarray) -> np.ndarray:
        """uint8 [H, W, 3] → [S/4, S/4, K] f32 heatmaps (model-input
        coordinates of the letterboxed image)."""
        x, _ = self._letterbox(_check_image(image))
        return self._forward(x)["heatmaps"][0].cpu().numpy()

    @torch.inference_mode()
    def predict_keypoints(
        self, image: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """uint8 [H, W, 3] → per-channel candidate peaks in original image
        coordinates: (positions [K, P, 2] as (y, x), scores [K, P],
        valid [K, P]). Peaks in the letterbox padding, beyond the image's
        extent, are invalid."""
        image = _check_image(image)
        x, scale = self._letterbox(image)
        peaks = self._decode(self._forward(x)["heatmaps"])
        stride = float(self.config.model.output_stride)
        positions = (peaks.positions[0] * stride).cpu().numpy() / scale
        h, w = image.shape[:2]
        inside = (positions[..., 0] <= h - 1) & (positions[..., 1] <= w - 1)
        valid = peaks.valid[0].cpu().numpy() & inside
        return positions, peaks.scores[0].cpu().numpy(), valid

    @torch.inference_mode()
    def predict_given_boxes(self, image: np.ndarray,
                            boxes: np.ndarray) -> np.ndarray:
        """Per-person keypoints for caller-supplied person boxes ([P, 4]
        (y0, x0, y1, x1) in original image pixels) in place of the
        detector's: keypoints [P, K, 3] rows (x, y, score) in original
        image coordinates. The forward and the decode run once; the PRN
        runs on chunks of `prn.max_persons` boxes (the JAX package's static
        slot count, zero-padded), so no box is dropped."""
        image = _check_image(image)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        x, scale = self._letterbox(image)
        hm_cm = self._heatmaps_cm(self._forward(x))
        peaks = self._decode_cm(hm_cm)
        stride = float(self.config.model.output_stride)
        slots = self.config.prn.max_persons
        pieces = []
        for s in range(0, max(len(boxes), 1), slots):
            chunk = boxes[s:s + slots]
            padded = torch.zeros((1, slots, 4), device=self.device)
            padded[0, :len(chunk)] = torch.as_tensor(chunk)
            kps = self._prn_assign(hm_cm, padded * scale / stride, peaks)
            kps[..., :2] *= stride
            pieces.append(kps[0, :len(chunk)])
        kps = torch.cat(pieces).float().cpu().numpy()
        kps[..., :2] /= scale
        h, w = image.shape[:2]
        kps[..., 0] = np.clip(kps[..., 0], 0.0, w - 1)
        kps[..., 1] = np.clip(kps[..., 1], 0.0, h - 1)
        return kps

    @torch.inference_mode()
    def predict(self, image: np.ndarray) -> list[PersonPrediction]:
        """uint8 [H, W, 3] RGB → per-person predictions in original image
        coordinates."""
        image = _check_image(image)
        x, scale = self._letterbox(image)
        out = self._pipeline(x)
        boxes = out["boxes"][0].float().cpu().numpy() / scale
        scores = out["box_scores"][0].float().cpu().numpy()
        valid = out["box_valid"][0].cpu().numpy()
        kps = out["keypoints"][0].float().cpu().numpy()
        kps[..., :2] /= scale
        h, w = image.shape[:2]
        results = []
        for i in np.flatnonzero(valid):
            box = np.clip(boxes[i], 0.0, [h - 1, w - 1, h - 1, w - 1])
            kp = kps[i].copy()
            kp[:, 0] = np.clip(kp[:, 0], 0.0, w - 1)
            kp[:, 1] = np.clip(kp[:, 1], 0.0, h - 1)
            results.append(PersonPrediction(box=box, score=float(scores[i]),
                                            keypoints=kp))
        return results
