"""Parent against change on one card: the PRN step of `Config()` (56x36
crops, 1024 hidden units, 32 persons, batch 64) and its train step at
512², batch 32, as `chip_smoke.py` times them (`prn_step_ms`,
`timed_train`: CUDA events around each step), each checkout in its own
process, in the order given:

    python -m multiposenet_tpu_torch.tools.train_step_ab PARENT . . PARENT

Each argument is the root of a checkout (a directory holding
`chip_smoke.py` and `multiposenet_tpu_torch/`); one JSON line a run. It
needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# Run in a fresh interpreter with the checkout's root first on sys.path.
_RUN = r"""
import dataclasses, json, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from multiposenet_tpu_torch.config import Config
from multiposenet_tpu_torch.data import loader, synthetic
from multiposenet_tpu_torch.models.posenet import MultiPoseNet
from multiposenet_tpu_torch.train import prn_train, steps

device = torch.device("cuda", 0)
prn = cs.prn_step_ms(Config, prn_train, loader, synthetic, device)
cfg = Config()
cfg = cfg.replace(train=dataclasses.replace(
    cfg.train, image_size=cs.TRAIN_IMAGE, batch_size=cs.TRAIN_BATCH))
train = cs.timed_train(cfg, MultiPoseNet, synthetic, loader, steps, device,
                       2, 5)
print(json.dumps({"prn_step_ms": prn["prn_step_ms"],
                  "prn_step_ms_each": prn["prn_step_ms_each"],
                  "train_step_ms": train["step_ms"],
                  "train_step_ms_each": train["step_ms_each"]}))
"""


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="+",
                        help="checkout roots, timed in this order")
    args = parser.parse_args(argv)
    for root in args.roots:
        run = subprocess.run([sys.executable, "-c", _RUN,
                              str(Path(root).resolve())],
                             capture_output=True, text=True, check=False)
        lines = [x for x in run.stdout.splitlines() if x.startswith("{")]
        if run.returncode != 0 or not lines:
            print(run.stderr[-3000:], file=sys.stderr)
            return 1
        print(json.dumps({"root": root, **json.loads(lines[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
