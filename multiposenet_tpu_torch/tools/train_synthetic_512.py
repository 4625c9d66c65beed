"""Quality at the shipped 512x512 operating point, the port of
`benchmarks/train_synthetic_512.py`: train the exact Config.fast()
architecture (same widths, kp_p2_late head, backbone trim) at 512² on
synthetic scenes of up to 8 persons, train the PRN, then report OKS AP
from the real `predict()` path (detector-driven, at the shipped pre-NMS
pool of 128 and at 256) and from the GT-box PRN protocol.

The only deltas from the served config are training knobs that leave the
inference graph as it is: bn_momentum 0.95 (short-run BatchNorm stat
tracking) and the compute dtype (float32 by default; the served bf16
inference would run on the same weights).

Flags, defaults and JSON keys are the JAX script's; `--device` (the CUDA
card unless given) is the port's own. Prints the training metrics every 50
steps, then one JSON line each: {"e2e_512": stats, "pool": 128},
{"gtbox_512": stats}, {"e2e_512_pool256": stats}.

    python -m multiposenet_tpu_torch.tools.train_synthetic_512 \\
        [--style v1] [--steps 1200] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import tempfile
import time
from typing import Callable

import numpy as np

from multiposenet_tpu_torch.config import Config, DecodeConfig, TrainConfig
from multiposenet_tpu_torch.data.loader import batch_iterator
from multiposenet_tpu_torch.data.synthetic import make_dataset
from multiposenet_tpu_torch.eval.oks import DetectionKP, KeypointEvaluator
from multiposenet_tpu_torch.eval.runner import (
    evaluate_predictor,
    record_ground_truths,
)
from multiposenet_tpu_torch.infer.predictor import Predictor
from multiposenet_tpu_torch.train import prn_train
from multiposenet_tpu_torch.train.loop import train
from multiposenet_tpu_torch.train.steps import ema_weights
from multiposenet_tpu_torch.weights import posenet_variables, prn_variables

SIZE = 512


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=1200)
    parser.add_argument("--prn-steps", type=int, default=400)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--eval-images", type=int, default=32)
    parser.add_argument("--train-images", type=int, default=192)
    parser.add_argument(
        "--stage-caps", type=str, default="",
        help="comma-separated backbone_stage_caps override, e.g. 48,128,0,0")
    parser.add_argument(
        "--prn-crop-margin", type=float, default=None,
        help="config.prn.crop_margin override (the PRN trains and infers "
             "with the same margin)")
    parser.add_argument(
        "--style", type=str, default="v2", choices=("v1", "v2", "v2flat"),
        help="fixtures distribution (data/synthetic.make_dataset); v1 is "
             "the calibrated quality-control distribution")
    parser.add_argument(
        "--compute-dtype", type=str, default="float32",
        choices=("float32", "bfloat16"),
        help="model compute dtype for training (losses and optimizer stay "
             "float32)")
    parser.add_argument(
        "--checkpoint-dir", type=str, default="",
        help="checkpoint and resume in this directory (chunked runs: "
             "--steps N --skip-eval, then --steps 2N); a resumed chunk "
             "restarts the shuffled epoch stream")
    parser.add_argument("--skip-eval", action="store_true",
                        help="train only: no PRN training, no eval")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    return parser.parse_args(argv)


def make_config(args: argparse.Namespace, checkpoint_dir: str) -> Config:
    cfg = Config.fast()
    caps = (tuple(int(c) for c in args.stage_caps.split(","))
            if args.stage_caps else cfg.model.backbone_stage_caps)
    if args.prn_crop_margin is not None:
        cfg = cfg.replace(prn=dataclasses.replace(
            cfg.prn, crop_margin=args.prn_crop_margin))
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, compute_dtype=args.compute_dtype, bn_momentum=0.95,
            backbone_stage_caps=caps),
        decode=DecodeConfig(score_threshold=0.1),
        train=TrainConfig(
            image_size=SIZE, batch_size=args.batch_size,
            num_steps=args.steps, warmup_steps=50, learning_rate=2e-3,
            log_interval_steps=50, checkpoint_dir=checkpoint_dir,
            save_interval_steps=max(args.steps // 4, 1)),
    )


def gt_box_stats(predictor: Predictor, records: list[dict]) -> dict:
    """OKS AP of `predict_given_boxes` on the ground-truth boxes, each
    person scored 1 (the reference's PRN evaluation)."""
    ev = KeypointEvaluator()
    for rec in records:
        kps = predictor.predict_given_boxes(rec["image"], rec["boxes"])
        dts = [DetectionKP(keypoints=kps[p].astype(np.float32), score=1.0)
               for p in range(len(rec["boxes"]))]
        ev.add_image(record_ground_truths(rec), dts)
    return ev.summarize()


def run(args: argparse.Namespace,
        emit: Callable[[dict], None] = lambda m: print(json.dumps(m),
                                                       flush=True)) -> dict:
    """Train, train the PRN, evaluate; each result line goes to `emit`.
    Returns the results and the seconds of each part."""
    with tempfile.TemporaryDirectory(prefix="train_synthetic_512_") as tmp:
        cfg = make_config(args, args.checkpoint_dir or tmp)
        # Crowded scenes: up to 8 persons.
        train_records = make_dataset(args.train_images, img_h=SIZE,
                                     img_w=SIZE, min_persons=1, max_persons=8,
                                     seed=0, style=args.style)
        eval_records = make_dataset(args.eval_images, img_h=SIZE, img_w=SIZE,
                                    min_persons=2, max_persons=8, seed=999,
                                    style=args.style)
        t0 = time.perf_counter()
        state = train(
            cfg,
            functools.partial(batch_iterator, train_records,
                              cfg.train.batch_size, SIZE,
                              cfg.prn.max_persons, train=True),
            checkpoint=bool(args.checkpoint_dir), log_fn=emit,
            device=args.device)
        train_s = time.perf_counter() - t0
        print(f"# trained {args.steps} steps in {train_s:.0f}s", flush=True)
        out = {"train_s": train_s, "steps": args.steps}
        if args.skip_eval:
            return out
        t0 = time.perf_counter()
        prn_state = prn_train.train_prn(
            cfg,
            batch_iterator(train_records, cfg.train.batch_size, SIZE,
                           cfg.prn.max_persons, train=True, augment=False),
            num_steps=args.prn_steps, log_fn=emit, device=args.device)
        out["prn_s"] = time.perf_counter() - t0
    with ema_weights(state) as model:
        variables = posenet_variables(model)
    prn_vars = prn_variables(prn_state.model)
    del state, prn_state, train_records
    gc.collect()
    t0 = time.perf_counter()
    predictor = Predictor(config=cfg, variables=variables,
                          prn_variables=prn_vars, image_size=SIZE,
                          device=args.device)
    # Detector-driven AP at the shipped pre-NMS pool, then the GT-box
    # protocol on the same predictor, then a pool-256 control (the pool is
    # an inference-only knob).
    out["e2e_512"] = evaluate_predictor(predictor, eval_records)
    emit({"e2e_512": out["e2e_512"], "pool": cfg.detector.pre_nms_top_k})
    out["gtbox_512"] = gt_box_stats(predictor, eval_records)
    emit({"gtbox_512": out["gtbox_512"]})
    del predictor
    gc.collect()
    cfg256 = cfg.replace(detector=dataclasses.replace(cfg.detector,
                                                      pre_nms_top_k=256))
    out["e2e_512_pool256"] = evaluate_predictor(
        Predictor(config=cfg256, variables=variables, prn_variables=prn_vars,
                  image_size=SIZE, device=args.device), eval_records)
    emit({"e2e_512_pool256": out["e2e_512_pool256"]})
    out["eval_s"] = time.perf_counter() - t0
    return out


def main(argv: list[str] | None = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
