"""Command-line entry points of the port, the counterparts of
`multiposenet_tpu/cli.py`'s `prepare`, `train`, `train-prn`, `eval` and
`predict`, with the same flags, defaults and output, plus `--device` (by
default the card; without one the command raises unless `--device cpu`
is given; `prepare` runs on the host only).

Usage:
    python -m multiposenet_tpu_torch prepare --coco-json ann.json \
        --image-dir images/ --output-dir shards/
    python -m multiposenet_tpu_torch train --config cfg.json \
        --coco-json ann.json --image-dir images/ [--synthetic N] \
        [--steps N] [--model-dir out/]
    python -m multiposenet_tpu_torch train-prn --synthetic 512 \
        --steps 1000 [--model-dir out/]
    python -m multiposenet_tpu_torch eval --model-dir out/ \\
        [--coco-json ... --image-dir ...] [--synthetic N] [--batched]
    python -m multiposenet_tpu_torch predict --model-dir out/ \\
        --image in.png --output out.png

Images are read through `utils/image_io.py` (JPEG, PNG, WebP, BMP,
Netpbm, Sun raster, TIFF, GIF, Radiance HDR and .npy, as cv2 reads them,
without cv2); `predict --output` writes what `image_io.write_image` writes
(PNG, JPEG, BMP, PPM/PNM, PAM, PFM, Sun raster, TIFF, WebP, Radiance HDR
and GIF, the bytes cv2.imwrite writes but for PNG and WebP) and exits
before the model runs on any other suffix.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _load_config(args) -> "Config":
    from multiposenet_tpu_torch.config import Config

    if args.config:
        return Config.from_json(Path(args.config).read_text())
    preset = getattr(args, "preset", None) or "default"
    if preset == "fast":
        return Config.fast()
    if preset == "crowd":
        return Config.crowd()
    return Config()


def _load_records(args):
    if args.coco_json:
        from multiposenet_tpu_torch.data.coco import load_coco_keypoints

        return load_coco_keypoints(args.coco_json)
    from multiposenet_tpu_torch.data.synthetic import make_dataset

    n = args.synthetic or 64
    return make_dataset(n, img_h=256, img_w=256, seed=0)


def _load_predictor(args):
    """The exported model under --model-dir, else a seeded random init of
    the --config/--preset model, on --device."""
    from multiposenet_tpu_torch.infer.export import load_predictor
    from multiposenet_tpu_torch.infer.predictor import Predictor

    if args.model_dir and (Path(args.model_dir) / "config.json").exists():
        return load_predictor(args.model_dir, device=args.device)
    return Predictor(config=_load_config(args), device=args.device)


def cmd_prepare(args) -> None:
    """COCO JSON + images (or --synthetic N scenes) → npz shards with the
    segmentation union masks (data/prepare.py); prints the shard paths."""
    from multiposenet_tpu_torch.data.prepare import (
        prepare_coco, write_shards,
    )

    if args.coco_json:
        paths = prepare_coco(args.coco_json, args.image_dir, args.output_dir,
                             shard_size=args.shard_size,
                             max_persons=args.max_persons)
    else:
        from multiposenet_tpu_torch.data.synthetic import make_dataset

        paths = write_shards(make_dataset(args.synthetic or 64, seed=0),
                             args.output_dir, shard_size=args.shard_size,
                             max_persons=args.max_persons)
    print(json.dumps({"shards": [str(p) for p in paths]}))


def _train_batches(args, config):
    """The training batches as `batches(rank=, world_size=)`, each rank's
    shards of the global batches (one rank: the whole batches)."""
    import functools

    from multiposenet_tpu_torch.data.loader import batch_iterator

    return functools.partial(
        batch_iterator, _load_records(args), config.train.batch_size,
        config.train.image_size, config.prn.max_persons,
        image_dir=args.image_dir, train=True,
        mask_stride=config.model.output_stride)


def _print_json(metrics: dict) -> None:
    print(json.dumps(metrics))


def cmd_train(args) -> None:
    """Train data-parallel on every visible card that divides the batch,
    as the JAX CLI trains on every device (CUDA_VISIBLE_DEVICES narrows
    them; --device cpu trains on one CPU process); checkpoints and
    metrics.jsonl under the config's train.checkpoint_dir; with
    --model-dir export the EMA weights and the batch statistics in the
    JAX package's format."""
    from multiposenet_tpu_torch.train.loop import train

    config = _load_config(args)
    if args.steps:
        import dataclasses

        config = config.replace(
            train=dataclasses.replace(config.train, num_steps=args.steps))
    state = train(config, _train_batches(args, config), log_fn=_print_json,
                  device=args.device)
    if args.model_dir:
        from multiposenet_tpu_torch.infer.export import save_model
        from multiposenet_tpu_torch.train.steps import ema_weights
        from multiposenet_tpu_torch.weights import posenet_variables

        with ema_weights(state) as model:
            variables = posenet_variables(model)
        save_model(args.model_dir, config, variables)
        print(f"exported EMA model to {args.model_dir}")


def cmd_train_prn(args) -> None:
    """Train the PRN alone (--steps, default 1000); with --model-dir write
    its weights there as prn.msgpack, the JAX package's format."""
    from multiposenet_tpu_torch.train.prn_train import train_prn

    config = _load_config(args)
    state = train_prn(config, _train_batches(args, config)(),
                      num_steps=args.steps or 1000,
                      log_fn=_print_json, device=args.device)
    if args.model_dir:
        from multiposenet_tpu_torch.infer.export import save_prn
        from multiposenet_tpu_torch.weights import prn_variables

        save_prn(args.model_dir, prn_variables(state.model))
        print(f"exported PRN to {args.model_dir}")


def cmd_eval(args) -> None:
    from multiposenet_tpu_torch.eval import runner

    predictor = _load_predictor(args)
    records = _load_records(args)
    if args.batched:
        stats = runner.evaluate_batched(
            predictor, records, batch_size=args.batch_size,
            image_dir=args.image_dir,
        )
    else:
        stats = runner.evaluate_predictor(
            predictor, records, image_dir=args.image_dir,
            max_images=args.max_images,
        )
    print(json.dumps(stats, indent=2))


def cmd_predict(args) -> None:
    from multiposenet_tpu_torch.utils.image_io import (
        PNG_SUFFIXES, UNWRITTEN_SUFFIXES, WRITTEN_SUFFIXES, read_image,
        write_image)
    from multiposenet_tpu_torch.utils.visualize import draw_predictions

    suffix = Path(args.output).suffix.lower() if args.output else None
    known = (*PNG_SUFFIXES, ".jpg", ".jpeg", ".jpe", *WRITTEN_SUFFIXES,
             *UNWRITTEN_SUFFIXES)
    if args.output and suffix not in known:
        shown = Path(args.output).suffix or "none"
        sys.exit(f"--output {args.output}: suffix {shown} is not written "
                 "here; PNG, JPEG, BMP, PPM/PNM, PAM, PFM, Sun raster, TIFF, "
                 "WebP, Radiance HDR, GIF, JPEG 2000 (.jp2) and AVIF are")
    predictor = _load_predictor(args)
    try:
        rgb = read_image(args.image)
    except (OSError, ValueError) as exc:
        sys.exit(f"cannot read image: {args.image} ({exc})")
    people = predictor.predict(rgb)
    print(json.dumps([
        {"box": p.box.tolist(), "score": p.score,
         "keypoints": p.keypoints.tolist()}
        for p in people
    ]))
    if args.output:
        # As the reference's cv2.imwrite: .pgm and .pbm write no file for
        # 3-channel pixels, .jp2 only its JP2 boxes for a side under 32,
        # and "wrote" is printed all the same.
        write_image(args.output, draw_predictions(rgb, people))
        print(f"wrote {args.output}", file=sys.stderr)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="multiposenet_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--config", help="config JSON path")
        p.add_argument("--preset", choices=("default", "fast", "crowd"),
                       help="named operating point when no --config is "
                            "given: 'fast' = the batched-throughput "
                            "point, 'crowd' = fast + the crowded-scene "
                            "knobs (README)")
        p.add_argument("--coco-json", help="COCO person_keypoints json")
        p.add_argument("--image-dir", help="image directory for COCO "
                                           "(JPEG, PNG, BMP, PxM, Sun "
                                           "raster, TIFF, GIF or .npy)")
        p.add_argument("--synthetic", type=int,
                       help="use N synthetic images instead of COCO")
        p.add_argument("--model-dir", help="export/load directory")
        p.add_argument("--device",
                       help="torch device (default: the CUDA card; "
                            "raises without one unless 'cpu' is given)")

    p = sub.add_parser(
        "prepare", help="COCO JSON + images → packed npz shards")
    common(p)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--shard-size", type=int, default=1024)
    p.add_argument("--max-persons", type=int, default=32)
    p.set_defaults(fn=cmd_prepare)

    p = sub.add_parser("train", help="train the pose network")
    common(p)
    p.add_argument("--steps", type=int)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("train-prn", help="train the PRN separately")
    common(p)
    p.add_argument("--steps", type=int)
    p.set_defaults(fn=cmd_train_prn)

    p = sub.add_parser("eval", help="COCO keypoint OKS evaluation")
    common(p)
    p.add_argument("--batched", action="store_true")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-images", type=int)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("predict", help="predict one image")
    common(p)
    p.add_argument("--image", required=True,
                   help="JPEG, PNG, WebP, BMP, Netpbm, Sun raster, TIFF, "
                   "GIF, Radiance HDR or .npy image")
    p.add_argument("--output", help="write the visualization here, as "
                   "cv2.imwrite writes it (.png, .apng, .jpg, .bmp, .ppm, "
                   ".pam, .pfm, .sr, .tif, .webp, .hdr, .gif, .jp2, .avif "
                   "and their other suffixes)")
    p.set_defaults(fn=cmd_predict)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
