"""The port's heatmap decode (`multiposenet_tpu_torch.ops.decode`) against
the JAX package's jnp reference and its Pallas kernel in interpret mode.

Contract, as between the JAX package's own two decoders
(`decode_pallas._decode_kernel` docstring): `valid` is equal everywhere,
scores are equal everywhere, positions are equal on valid slots. Scores
get 1e-5 absolute + 1e-5 relative: the blur sums seven taps per axis in
another order than XLA's depthwise conv and banded matmul do, a few f32
ulps on values of order 1. Positions are whole pixels plus a ±¼ shift
from a sign, so they are compared exactly.

On the CPU the port runs its plain PyTorch version; on a card the same
entry point launches `csrc/decode_peaks.cu`, which test_torch_cuda.py
holds against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.config import DecodeConfig as JaxDecodeConfig
from multiposenet_tpu.ops import decode as jax_decode
from multiposenet_tpu.ops.decode_pallas import decode_heatmaps_pallas
from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.config import DecodeConfig
from multiposenet_tpu_torch.ops import decode

from decode_maps import CONFIGS, MAKERS, planted_maps
from torch_port_helpers import chip_smoke_module
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

SCORE_TOL = dict(atol=1e-5, rtol=1e-5)


def _configs(kind):
    return JaxDecodeConfig(**CONFIGS[kind]), DecodeConfig(**CONFIGS[kind])


def _assert_contract(got, want):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **SCORE_TOL)
    np.testing.assert_array_equal(got.positions.numpy()[valid],
                                  np.asarray(want.positions)[valid])


@pytest.mark.parametrize("kind", sorted(MAKERS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jnp_reference(kind, dtype):
    rng = np.random.RandomState(11)
    hm = MAKERS[kind](rng, (2, 40, 56, 5))
    jcfg, tcfg = _configs(kind)
    if dtype == "bfloat16":
        x_t = torch.as_tensor(hm).to(torch.bfloat16)
        x_j = jnp.asarray(hm, jnp.bfloat16)
    else:
        x_t, x_j = torch.as_tensor(hm), jnp.asarray(hm)
    want = jax_decode.decode_heatmaps(x_j, jcfg)
    got = decode.decode_heatmaps(x_t, tcfg)
    assert np.asarray(want.valid).any() and not np.asarray(want.valid).all()
    _assert_contract(got, want)


@pytest.mark.parametrize("kind", ["random", "planted", "plateau"])
def test_plain_matches_pallas_interpret(kind):
    """Same inputs through the TPU kernel, run as
    tests/test_decode_pallas.py runs it (interpret=True)."""
    rng = np.random.RandomState(5)
    hm = MAKERS[kind](rng, (1, 32, 128, 3))
    jcfg, tcfg = _configs(kind)
    want = decode_heatmaps_pallas(jnp.asarray(hm), jcfg, interpret=True)
    got = decode.decode_heatmaps(torch.as_tensor(hm), tcfg)
    _assert_contract(got, want)


def test_channel_major_entry_matches_nhwc():
    rng = np.random.RandomState(2)
    hm = planted_maps(rng, (2, 32, 32, 4))
    cfg = DecodeConfig()
    a = decode.decode_heatmaps(torch.as_tensor(hm), cfg)
    b = decode.decode_heatmaps_cm(
        torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous(), cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_fewer_peaks_than_slots_fill_with_invalid():
    """A 3x3 map with a bump in the middle has one peak (every cell sees
    the centre): slot 0 holds it, the other slots are -inf (invalid, score
    0), as the TPU kernel emits them."""
    hm = np.zeros((1, 3, 3, 1), np.float32)
    hm[0, 1, 1, 0] = 4.0
    got = decode.decode_heatmaps(torch.as_tensor(hm), DecodeConfig())
    raw_scores, _, _ = decode.decode_maps(
        torch.as_tensor(hm).permute(0, 3, 1, 2).contiguous(), DecodeConfig())
    assert got.valid[0, 0].tolist() == [True] + [False] * 7
    assert torch.isneginf(raw_scores[0, 1:]).all()
    assert (got.scores[0, 0, 1:] == 0).all()
    assert got.positions[0, 0, 0].tolist() == [1.0, 1.0]


# Configs the jnp decode takes beyond the kernels B1 and B2: peak windows
# other than 3 (even ones reach one cell further right and down, as XLA's
# SAME padding does), more than 16 peaks on maps at least that wide, and
# more than 15 taps.
WIDE_CONFIGS = {
    "window1": dict(nms_window=1),
    "window2": dict(nms_window=2),
    "window4": dict(nms_window=4),
    "window5": dict(nms_window=5),
    "window7": dict(nms_window=7),
    "peaks20": dict(max_peaks_per_channel=20),
    "taps17": dict(smooth_sigma=3.0, smooth_kernel_size=17),
}


@pytest.mark.parametrize("case", sorted(WIDE_CONFIGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jnp_reference_wide_configs(case, dtype):
    rng = np.random.RandomState(17)
    hm = planted_maps(rng, (2, 40, 56, 5))
    kwargs = {**CONFIGS["planted"], **WIDE_CONFIGS[case]}
    jcfg, tcfg = JaxDecodeConfig(**kwargs), DecodeConfig(**kwargs)
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jax_decode.decode_heatmaps(jnp.asarray(hm, jdtype), jcfg)
    got = decode.decode_heatmaps(
        torch.as_tensor(hm).to(getattr(torch, dtype)), tcfg)
    assert np.asarray(want.valid).any()
    _assert_contract(got, want)


def test_rejects_unsupported_window():
    """Every window of at least one cell decodes as the jnp reference
    does (window 5 here); a window of 0 is refused."""
    hm = planted_maps(np.random.RandomState(8), (1, 16, 16, 2))
    want = jax_decode.decode_heatmaps(jnp.asarray(hm),
                                      JaxDecodeConfig(nms_window=5))
    _assert_contract(decode.decode_heatmaps(torch.as_tensor(hm),
                                            DecodeConfig(nms_window=5)),
                     want)
    with pytest.raises(ValueError, match="nms_window"):
        decode.decode_heatmaps(torch.zeros(1, 8, 8, 1),
                               DecodeConfig(nms_window=0))


class Built(Exception):
    """Raised by a patched kernels.load: the wrapper got as far as
    building the named kernel."""


# (maps, config) → the kernel decode_maps and decode_maps_lanes take on a
# card: B1 and B2 where they take the input, the generic kernel else.
def _cl(b, k, h, w):
    return torch.zeros(b, h, w, k).permute(0, 3, 1, 2)


ROUTES = {
    "path": (torch.zeros(2, 17, 16, 16), {}, "decode_peaks",
             "decode_lanes"),
    "channels_last": (_cl(2, 17, 16, 16), {}, "decode_generic",
                      "decode_lanes"),
    "head_slice": (torch.zeros(2, 18, 16, 16)[:, :17], {}, "decode_peaks",
                   "decode_lanes"),
    "transposed": (torch.zeros(2, 3, 16, 16).permute(0, 1, 3, 2), {},
                   "decode_generic", "decode_lanes"),
    "window5": (torch.zeros(2, 3, 16, 16), dict(nms_window=5),
                "decode_generic", "decode_generic"),
    "window1": (torch.zeros(2, 3, 16, 16), dict(nms_window=1),
                "decode_generic", "decode_generic"),
    "peaks17": (torch.zeros(2, 3, 16, 16), dict(max_peaks_per_channel=17),
                "decode_generic", "decode_generic"),
    "taps17": (torch.zeros(2, 3, 16, 16), dict(smooth_kernel_size=17),
               "decode_generic", "decode_generic"),
    "width700": (torch.zeros(1, 2, 4, 700), {}, "decode_generic",
                 "decode_generic"),
}


@pytest.mark.parametrize("lanes", [False, True], ids=["cm", "lanes"])
@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_picks_kernel(case, lanes, monkeypatch):
    """The kernel is chosen from the config and the shape before anything
    is built, and the chosen kernel's wrapper is the one that builds (CPU
    tensors stand in for CUDA ones; kernels.load stops the wrapper)."""
    x, kwargs, want_cm, want_lanes = ROUTES[case]
    want = want_lanes if lanes else want_cm
    cfg = DecodeConfig(**kwargs)

    def load(name):
        raise Built(name)

    monkeypatch.setattr(kernels, "load", load)
    assert decode.route(x, cfg, lanes=lanes) == want
    with pytest.raises(Built, match=want):
        decode._CUDA_DECODES[want](x, cfg)


@pytest.mark.parametrize("case", ["dtype", "peaks", "elements"])
def test_generic_wrapper_validates_before_building(case, monkeypatch):
    """The generic kernel takes f32 or bf16 maps, 1..H*W peaks and flat
    indices under 2**28, and its wrapper refuses the rest before it builds
    or launches anything."""
    monkeypatch.setattr(kernels, "load", pytest.fail)
    cfg = DecodeConfig(nms_window=5)
    x = torch.zeros(2, 3, 4, 4)
    if case == "dtype":
        x, err = x.half(), TypeError
    elif case == "peaks":
        cfg, err = DecodeConfig(max_peaks_per_channel=17), ValueError
    else:  # on the meta device: no memory of 2**29 elements is needed
        x, err = torch.empty(1, 1, 2 ** 20, 512, device="meta"), ValueError
    with pytest.raises(err):
        decode._decode_maps_generic_cuda(x, cfg)
    assert kernels.LAUNCHES.get(decode.GENERIC_KERNEL, 0) == 0


def test_cpu_tensor_takes_plain_version_without_launch():
    kernels.reset_launches()
    decode.decode_heatmaps_cm(torch.rand(1, 2, 16, 16), DecodeConfig())
    assert kernels.LAUNCHES == {}


@pytest.mark.parametrize("elem_bytes,bound_ms,bound_by", [
    # bf16, the fast() batch: 2176 * 128**2 * 37 = 1.319e9 unfused f32
    # operations over 132 * 128 * 1.98e9 per second = 0.0394 ms, above
    # the 71.5 MB over 3.35 TB/s = 0.0213 ms of bytes.
    (2, 0.039431, "operations"),
    # f32 maps move twice the bytes: 142.8 MB, 0.0426 ms.
    (4, 0.042631, "bytes"),
])
def test_decode_bound_matches_hand_count(elem_bytes, bound_ms, bound_by):
    bound = chip_smoke_module().decode_bound(2176, 128, 128, 8, 7, elem_bytes)
    assert bound["ops"] == 2176 * 128 * 128 * 37 == 1_319_108_608
    assert bound["bytes"] == 2176 * 128 * 128 * elem_bytes + 2176 * 8 * 12
    assert bound["bound_by"] == bound_by
    assert bound["bound_ms"] == pytest.approx(bound_ms, abs=1e-6)


def test_decode_bound_counts_the_window():
    """The peak test takes window² operations an element (window² - 1
    maxima and a comparison): 9 at window 3, 25 at window 5."""
    smoke = chip_smoke_module()
    b3 = smoke.decode_bound(1088, 128, 128, 8, 7, 2)
    b5 = smoke.decode_bound(1088, 128, 128, 8, 7, 2, window=5)
    assert b3["ops"] == 1088 * 128 * 128 * 37
    assert b5["ops"] == 1088 * 128 * 128 * (28 + 25)
    assert b5["bytes"] == b3["bytes"]


def test_decode_phase_tool_refuses_without_a_card(monkeypatch, capsys):
    """tools/decode_phases.py measures on a card only: without one it
    exits non-zero and prints no result."""
    from multiposenet_tpu_torch.tools import decode_phases

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert decode_phases.main([]) == 2
    assert capsys.readouterr().out == ""


def test_decode_phase_tool_refuses_lanes_without_a_card(monkeypatch, capsys):
    """The same for B2's counters (`--kernel lanes`)."""
    from multiposenet_tpu_torch.tools import decode_phases

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert decode_phases.main(["--kernel", "lanes", "--layout",
                               "channels_last"]) == 2
    assert capsys.readouterr().out == ""
