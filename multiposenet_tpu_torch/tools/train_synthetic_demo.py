"""End-to-end demo, the port of `benchmarks/train_synthetic_demo.py`: train
on synthetic scenes, train the PRN, then evaluate OKS AP through the real
`predict()` path and the NumPy OKS evaluator. The synthetic fixtures draw
keypoints as Gaussian blobs (data/synthetic.py), so a small model learns
to localize them in a few hundred steps; the detector learns person boxes
from the focal-loss targets; the PRN trains on heatmaps made from the
ground truth.

Flags, defaults and the final JSON key are the JAX script's; `--device`
(the CUDA card unless given) is the port's own. Prints the training
metrics as JSON lines and then {"eval": stats}.

    python -m multiposenet_tpu_torch.tools.train_synthetic_demo \\
        [--steps 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import tempfile
import time
from typing import Callable

from multiposenet_tpu_torch.config import (
    Config, DecodeConfig, DetectorConfig, ModelConfig, PRNConfig,
    TrainConfig,
)
from multiposenet_tpu_torch.data.loader import batch_iterator
from multiposenet_tpu_torch.data.synthetic import make_dataset
from multiposenet_tpu_torch.eval.runner import evaluate_predictor
from multiposenet_tpu_torch.infer.predictor import Predictor
from multiposenet_tpu_torch.train import prn_train
from multiposenet_tpu_torch.train.loop import train
from multiposenet_tpu_torch.train.steps import ema_weights
from multiposenet_tpu_torch.weights import posenet_variables, prn_variables


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--prn-steps", type=int, default=150)
    parser.add_argument("--image-size", type=int, default=128)
    parser.add_argument("--eval-images", type=int, default=24)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    return parser.parse_args(argv)


def make_config(args: argparse.Namespace, checkpoint_dir: str) -> Config:
    return Config(
        # bn_momentum 0.9: the default 0.997 needs ~2k steps before the
        # running statistics track the activations; after a few hundred
        # steps eval-mode BatchNorm would still hold its init statistics.
        model=ModelConfig(backbone_width=0.5, fpn_channels=64,
                          head_channels=64, bn_momentum=0.9),
        detector=DetectorConfig(score_threshold=0.05, max_detections=8,
                                pre_nms_top_k=200),
        prn=PRNConfig(crop_height=28, crop_width=18, hidden_units=512,
                      max_persons=6),
        decode=DecodeConfig(score_threshold=0.1),
        train=TrainConfig(
            image_size=args.image_size, batch_size=8, num_steps=args.steps,
            warmup_steps=20, learning_rate=2e-3, log_interval_steps=25,
            checkpoint_dir=checkpoint_dir),
    )


def run(args: argparse.Namespace,
        emit: Callable[[dict], None] = lambda m: print(json.dumps(m),
                                                       flush=True)) -> dict:
    """Train, train the PRN, evaluate; returns {"eval": stats}."""
    size = args.image_size
    train_records = make_dataset(128, img_h=size, img_w=size,
                                 min_persons=1, max_persons=3, seed=0)
    eval_records = make_dataset(args.eval_images, img_h=size, img_w=size,
                                min_persons=1, max_persons=3, seed=999)
    with tempfile.TemporaryDirectory(prefix="train_synthetic_demo_") as tmp:
        cfg = make_config(args, tmp)
        t0 = time.perf_counter()
        state = train(
            cfg,
            functools.partial(batch_iterator, train_records,
                              cfg.train.batch_size, size,
                              cfg.prn.max_persons, train=True),
            checkpoint=False, log_fn=emit, device=args.device)
        print(f"# trained {args.steps} steps in "
              f"{time.perf_counter() - t0:.0f}s", flush=True)
    prn_state = prn_train.train_prn(
        cfg,
        # The infinite shuffled loop without augmentation (a single-pass
        # eval iterator would cap PRN training at one epoch).
        batch_iterator(train_records, cfg.train.batch_size, size,
                       cfg.prn.max_persons, train=True, augment=False),
        num_steps=args.prn_steps, log_fn=emit, device=args.device)
    with ema_weights(state) as model:
        variables = posenet_variables(model)
    predictor = Predictor(config=cfg, variables=variables,
                          prn_variables=prn_variables(prn_state.model),
                          image_size=size, device=args.device)
    out = {"eval": evaluate_predictor(predictor, eval_records)}
    emit(out)
    return out


def main(argv: list[str] | None = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
