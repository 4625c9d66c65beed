"""The port's trainer against the JAX package's over the first 10 steps of
the JAX smoke gate's recipe (tests/test_integration_smoke.py `_config()`,
its fixtures v1 records and loader), float64 all the way, from the JAX
package's init on the same batches (`tests/torch_trainer_gap.py curves`,
whose docstring says what float64 all the way takes on each side).

The 10 steps run through the warmup's first updates, the first real Adam
updates and the gradient-norm peaks of steps 5 and 8, and stop before the
recipe's largest early peak (step 13, norm 526). Held at every step: each
loss and the gradient norm to 1e-7 relative, the batch statistics to 1e-8
of each tensor's largest magnitude, the parameters and their EMA to 1e-6
of it. At step 10 they agree to 1.5e-9, 1e-8, 6e-10, 3e-8 and 2e-8.

Before float64 reached every scalar of the port's step, its Adam bias
corrections stayed float32 for float64 parameters: the parameters then
differed by 1e-5 of their scale after the first real update (step 2).
"""

import numpy as np
import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_trainer_gap import curves

STEPS = 10
LOSS_TOL, STATS_TOL, PARAM_TOL = 1e-7, 1e-8, 1e-6


@pytest.fixture(scope="module")
def rows():
    return curves(STEPS)


def test_losses_and_grad_norm_agree_in_float64(rows):
    assert [r["step"] for r in rows] == list(range(1, STEPS + 1))
    keys = {"heatmap_loss", "segmentation_loss", "cls_loss", "box_loss",
            "detector_loss", "total_loss", "grad_norm"}
    for r in rows:
        assert keys <= set(r), sorted(r)
        for k in keys:
            jax_value, port_value, rel = r[k]
            assert np.isfinite(port_value), (r["step"], k)
            assert rel <= LOSS_TOL, (r["step"], k, jax_value, port_value)


def test_batch_stats_agree_in_float64(rows):
    for r in rows:
        assert r["batch_stats"] <= STATS_TOL, (r["step"], r["batch_stats"])


def test_params_and_ema_agree_in_float64(rows):
    """Step 1 has lr 0: the parameters stay as the init, in both."""
    assert rows[0]["params"] == 0.0
    for r in rows:
        assert r["params"] <= PARAM_TOL, (r["step"], r["params"])
        assert r["ema_params"] <= PARAM_TOL, (r["step"], r["ema_params"])


def test_the_curves_move(rows):
    """The 10 steps are training, not a standstill: the total loss falls
    and the gradient norm peaks above 50 at least once."""
    total = [r["total_loss"][1] for r in rows]
    assert total[-1] < 0.8 * total[0], total
    assert max(r["grad_norm"][1] for r in rows) > 50.0
