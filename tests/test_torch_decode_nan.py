"""The port's decode on heatmaps that hold NaNs, against the JAX package's
jnp decode (`multiposenet_tpu/ops/decode.py decode_heatmaps`).

In the JAX package a NaN spreads through the blur, a peak window that
holds one has a NaN maximum (`reduce_window(lax.max)`), so its centre is
no peak, and a peak next to one gets a NaN coordinate (`jnp.sign(NaN)` is
NaN). Windows 1 and 2 leave neighbours outside the window, so there a
valid peak can sit next to a NaN. The contract is test_torch_decode.py's:
`valid` equal, scores to 1e-5, positions exact on valid slots, where a
NaN position must be NaN in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.config import DecodeConfig as JaxDecodeConfig
from multiposenet_tpu.ops import decode as jax_decode
from multiposenet_tpu_torch.config import DecodeConfig
from multiposenet_tpu_torch.ops import decode

from decode_maps import CONFIGS, planted_maps, with_nans
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

SCORE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [1, 2, 3, 5])
def test_nan_maps_match_jnp_reference(window):
    rng = np.random.RandomState(31)
    hm = with_nans(rng, planted_maps(rng, (2, 24, 20, 3)))
    kwargs = {**CONFIGS["planted"], "nms_window": window}
    want = jax_decode.decode_heatmaps(jnp.asarray(hm),
                                      JaxDecodeConfig(**kwargs))
    got = decode.decode_heatmaps_cm(
        torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous(),
        DecodeConfig(**kwargs))
    valid = np.asarray(want.valid)
    assert valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], **SCORE_TOL)
    np.testing.assert_array_equal(got.positions.numpy()[valid],
                                  np.asarray(want.positions)[valid])
    if window <= 2:  # the case the repair is for: NaN next to a peak
        assert np.isnan(np.asarray(want.positions)[valid]).any()
