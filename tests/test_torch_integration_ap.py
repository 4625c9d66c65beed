"""The port's counterpart of tests/test_integration_ap.py, the slow AP gate:
its `_config()`, its 64 fixtures v1 scenes at 96², 500 training steps and
150 PRN steps, then the GT-box floors with the localization bound and the
detector-driven e2e floors, unchanged (GT-box AP50 0.8, AP 0.35, AP75
0.45; mean matched keypoint error under 1.0 heatmap px; e2e AP50 0.35 and
AR50 0.35), through the port's loader, `train.loop.train`,
`train.prn_train.train_prn`, Predictor and OKS evaluator on the CPU.

As the JAX gate trains data-parallel on its 8 devices, this trains through
the port's data-parallel `train`: two gloo ranks on the CPU (this process
and one spawned, as tests/test_torch_ddp.py launches them), each with its
half of every batch. The model and the PRN start from the JAX package's
init from PRNGKey(0), carried across. It prints its statistics beside the
JAX gate's calibration.
"""

import json

import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_quality_helpers import CALIBRATION, port_gate

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def stats(tmp_path_factory):
    got = port_gate("ap", 0, checkpoint_dir=str(
        tmp_path_factory.mktemp("ap_gate")), num_devices=2)
    print(json.dumps({"port": got, "jax_calibration": CALIBRATION["ap"]}))
    return got


def test_gt_box_ap_floor_and_localization(stats):
    gt = stats["gtbox"]
    assert gt["AP50"] >= 0.8, gt
    assert gt["AP"] >= 0.35, gt
    assert gt["AP75"] >= 0.45, gt
    assert stats["mean_err_hm_px"] < 1.0, stats["mean_err_hm_px"]


def test_detector_e2e_ap_floor(stats):
    e2e = stats["e2e"]
    assert e2e["AP50"] >= 0.35, e2e
    assert e2e["AR50"] >= 0.35, e2e
