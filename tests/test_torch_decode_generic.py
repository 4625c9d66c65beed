"""The generic decode kernel's design on the CPU (`csrc/decode_generic.cu`,
which runs only on a card): its launch plan (`ops/decode.py
generic_launch_plan`, the mirror of the source's `make_plan`) and a
pure-torch model of its selection, held to `decode_maps_plain`.

The plan's tiles must cover every element of every map once, each with
the halo the blur, the window and the sub-pixel step read, inside the
card's shared memory and a cluster of at most 8 blocks. The model takes
the kernel's route to the top-P: per tile the peaks' 64-bit keys (value
bits, then FLAT_MASK - flat) and the first others in flat order, a
block's list of its peaks then its others, the cluster's merge of the
blocks' lists, and rounds of 32 keys below the last round's last key for
P > 32. It must equal the plain version's stable sort bit for bit,
plateau ties across tile edges included.
"""

import re

import numpy as np
import pytest
import torch

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.config import DecodeConfig
from multiposenet_tpu_torch.ops import decode

from decode_maps import (GENERIC_CARD_PLANS, planted_maps, plateau_maps,
                         straddle_maps, with_nans)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FLAT_MASK = 0x0FFFFFFF
THREADS = 256



def _tiles(plan, h, w):
    """(rank, first row, first column, rows, columns) of each tile of a
    map under a plan of path 0: block `rank` of the map's cluster takes
    tiles rank, rank + cluster, ... in row-major tile order."""
    th, tw = plan["tile_rows"], plan["tile_cols"]
    for t in range(plan["row_tiles"] * plan["col_tiles"]):
        r0 = t // plan["col_tiles"] * th
        c0 = t % plan["col_tiles"] * tw
        yield (t % plan["cluster"], r0, c0, min(th, h - r0),
               min(tw, w - c0))


@pytest.mark.parametrize("shape", GENERIC_CARD_PLANS,
                         ids=lambda s: "_".join(map(str, s)))
def test_plan_covers_every_element_once(shape):
    """Every element of a map lies in exactly one tile; every rank of the
    cluster has a tile; the staged region holds the blur's and the
    window's halos within shared memory; the grid is whole clusters of at
    most 8 blocks, at most one cluster a map."""
    n, h, w, taps, window, p = shape
    plan = decode.generic_launch_plan(n, h, w, taps, window, p)
    if plan["path"] == 1:  # a map a block, through a workspace
        assert decode._tile_smem(1, 1, taps, window) > decode.MAX_DYN_SMEM
        assert plan["grid"] == n and plan["rounds"] == p
        return
    assert 1 <= plan["cluster"] <= 8
    assert plan["grid"] % plan["cluster"] == 0
    assert plan["grid"] // plan["cluster"] == min(n, decode.MAX_CLUSTERS)
    assert plan["tile_rows"] * plan["tile_cols"] <= (
        16 if p <= 8 else 32) * THREADS
    assert plan["smem_bytes"] == decode._tile_smem(
        plan["tile_rows"], plan["tile_cols"], taps, window)
    assert plan["smem_bytes"] <= decode.MAX_DYN_SMEM
    assert plan["cap"] * (plan["rounds"] - 1) < p <= plan["cap"] * plan[
        "rounds"]
    cover = np.zeros((h, w), np.int64)
    ranks = set()
    for rank, r0, c0, rows, cols in _tiles(plan, h, w):
        assert rows >= 1 and cols >= 1
        cover[r0:r0 + rows, c0:c0 + cols] += 1
        ranks.add(rank)
    assert (cover == 1).all()
    assert ranks == set(range(plan["cluster"]))
    # The staged raw region reaches every tap of every element the peak
    # test and the sub-pixel step read: rows -(window-1)//2 - 1 .. window//2
    # + 1 around the tile at most, each with taps // 2 rows of blur.
    half, lo, hi = taps // 2, (window - 1) // 2, window // 2
    bl, bh = max(lo, 1), max(hi, 1)
    sh, sw = plan["tile_rows"] + bl + bh, plan["tile_cols"] + bl + bh
    assert sh >= plan["tile_rows"] + lo + hi and sw >= plan["tile_cols"] + 2
    assert plan["smem_bytes"] >= 4 * (sh + 2 * half) * (sw + 2 * half)


def test_plan_at_the_path_shapes():
    """One request's 17 maps of 128² at window 5: 8 tiles of 16 rows, a
    cluster of 8 a map, 136 blocks; Config()'s batch of 64 (1088 maps):
    tiles of 32 rows, 2 blocks a map; the 20-peak maps 600 wide: 3 x 5
    tiles of 54 x 120 (lists of 32 take tiles of up to 8192 elements) in
    one round."""
    plan = decode.generic_launch_plan
    assert plan(17, 128, 128, 7, 5, 8) == {
        "path": 0, "tile_rows": 16, "tile_cols": 128, "row_tiles": 8,
        "col_tiles": 1, "cluster": 8, "grid": 136, "cap": 8, "rounds": 1,
        "smem_bytes": 27472}
    assert plan(1088, 128, 128, 7, 5, 8)["tile_rows"] == 32
    assert plan(1088, 128, 128, 7, 5, 8)["grid"] == 2176
    got = plan(68, 160, 600, 7, 3, 20)
    assert (got["tile_rows"], got["tile_cols"], got["row_tiles"],
            got["col_tiles"], got["cluster"], got["cap"],
            got["rounds"]) == (54, 120, 3, 5, 8, 32, 1)


def test_plan_constants_match_the_source():
    """generic_launch_plan's constants are those of csrc/decode_generic.cu,
    read as text (`constexpr int kName = value;`, 1 << 26 as 2**26)."""
    text = (kernels.CSRC / "decode_generic.cu").read_text()
    consts = dict(re.findall(r"constexpr int k(\w+) = ([\d <]+);", text))
    for name in ("MAX_CLUSTER", "CTAS_PER_SM", "TILE_COLS", "TILE_ELEMS",
                 "TILE_ELEMS_LONG",
                 "MAX_DYN_SMEM", "MAX_CLUSTERS", "LIST_SHORT", "LIST_LONG"):
        camel = "".join(part.capitalize() for part in name.lower().split("_"))
        assert eval(consts[camel]) == getattr(decode, name), name
    fields = re.search(r"struct Plan \{(.*?)\};", text, re.S).group(1)
    assert tuple(re.findall(r"int (\w+);", fields)) == \
        decode.GENERIC_PLAN_FIELDS


# --- a model of the kernel's selection --------------------------------------


def _value_bits(v: np.ndarray) -> np.ndarray:
    b = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def _sign_code(d: float) -> int:
    return 2 if d > 0 else 0 if d < 0 else 1 if d == 0 else 3


def _model_decode(maps: torch.Tensor, cfg: DecodeConfig, n_maps: int):
    """The kernel's selection on maps [N, H, W] under the plan for n_maps
    maps, outputs (scores, ys, xs) [N, P] as the kernel stores them."""
    n, h, w = maps.shape
    p, window = cfg.max_peaks_per_channel, cfg.nms_window
    taps = decode.smoothing_taps(cfg)
    plan = decode.generic_launch_plan(n_maps, h, w, len(taps), window, p)
    assert plan["path"] == 0
    cap = plan["cap"]
    sm = decode.gaussian_smooth(maps.float(), taps)
    is_peak = (sm >= decode.window_max(sm, window)) & (sm > -torch.inf)
    flat = np.arange(h * w, dtype=np.uint64)
    out = np.zeros((3, n, p), np.float32)
    for m in range(n):
        s = sm[m].numpy()
        peak = is_peak[m].numpy().reshape(-1)
        vb = np.where(peak, _value_bits(s.reshape(-1)),
                      _value_bits(np.float32(-np.inf)))
        keys = vb << np.uint64(32) | (FLAT_MASK - flat) << np.uint64(4)
        ceiling = (1 << 64) - 16
        for rnd in range(plan["rounds"]):
            lists = {}
            for rank, r0, c0, rows, cols in _tiles(plan, h, w):
                idx = ((np.arange(r0, r0 + rows)[:, None] * w
                        + np.arange(c0, c0 + cols)[None, :]).reshape(-1))
                below = [i for i in idx if int(keys[i]) < ceiling]
                peaks = sorted((int(keys[i]) for i in below if peak[i]),
                               reverse=True)[:cap]
                others = [int(keys[i]) for i in below if not peak[i]][:cap]
                got_p, got_o = lists.get(rank, ([], []))
                lists[rank] = (sorted(got_p + peaks, reverse=True)[:cap],
                               sorted(got_o + others, reverse=True)[:cap])
            blocks = [(pk + ot)[:cap] for pk, ot in lists.values()]
            merged = sorted(sum(blocks, []), reverse=True)[:cap]
            for j, key in enumerate(merged):
                slot = rnd * cap + j
                if slot >= p:
                    break
                f = FLAT_MASK - ((key & 0xFFFFFFFF) >> 4)
                y, x = divmod(f, w)
                v = s[y, x]
                up, down = s[max(y - 1, 0), x], s[min(y + 1, h - 1), x]
                left, right = s[y, max(x - 1, 0)], s[y, min(x + 1, w - 1)]
                steps = []
                for code in (_sign_code(np.float32(down - up)),
                             _sign_code(np.float32(right - left))):
                    steps.append(np.float32(np.nan) if code == 3 else
                                 np.float32(code - 1)
                                 * np.float32(cfg.subpixel_shift))
                out[0, m, slot] = v if peak[f] else -np.inf
                out[1, m, slot] = np.float32(y) + steps[0]
                out[2, m, slot] = np.float32(x) + steps[1]
            ceiling = merged[-1] & ~15
    return tuple(torch.from_numpy(o) for o in out)


def _straddle(shape, window, p, taps=1):
    b, k, h, w = shape
    plan = decode.generic_launch_plan(b * k, h, w, taps, window, p)
    rows = list(range(plan["tile_rows"], h, plan["tile_rows"]))
    cols = list(range(plan["tile_cols"], w, plan["tile_cols"]))
    hm = straddle_maps(np.random.RandomState(7), (b, h, w, k), rows, cols)
    return torch.from_numpy(hm).permute(0, 3, 1, 2).reshape(b * k, h, w)


def _grid(shape, kind):
    b, k, h, w = shape
    rng = np.random.RandomState(19)
    hm = {"planted": planted_maps, "plateau": plateau_maps}[
        kind.split("_")[0]](rng, (b, h, w, k))
    if kind.endswith("nan"):
        hm = with_nans(rng, hm)
    return torch.from_numpy(hm).permute(0, 3, 1, 2).reshape(b * k, h, w)


# (shape [B, K, H, W], maps, config): ties across row and column tiles,
# fewer peaks than P, P at and above the list length, P = H * W, NaNs.
MODEL_CASES = {
    "straddle_w3": ((1, 3, 40, 300), "straddle", dict(
        smooth_sigma=0.0, max_peaks_per_channel=8)),
    "straddle_w5_p32": ((1, 3, 64, 260), "straddle", dict(
        smooth_sigma=0.0, nms_window=5, max_peaks_per_channel=32)),
    "straddle_w2_p33": ((1, 2, 40, 140), "straddle", dict(
        smooth_sigma=0.0, nms_window=2, max_peaks_per_channel=33)),
    "plateau_w4_p64": ((2, 3, 40, 56), "plateau", dict(
        smooth_sigma=0.0, nms_window=4, max_peaks_per_channel=64)),
    "plateau_p_eq_hw": ((1, 2, 8, 8), "plateau", dict(
        smooth_sigma=0.0, nms_window=5, max_peaks_per_channel=64)),
    "planted_w5": ((2, 3, 37, 53), "planted", dict(nms_window=5)),
    "planted_w1_nan": ((2, 3, 24, 20), "planted_nan", dict(nms_window=1)),
    "planted_w7_p20_nan": ((1, 3, 40, 140), "planted_nan", dict(
        nms_window=7, max_peaks_per_channel=20)),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_selection_model_matches_plain(case):
    shape, kind, kwargs = MODEL_CASES[case]
    cfg = DecodeConfig(**kwargs)
    b, k, h, w = shape
    taps = len(decode.smoothing_taps(cfg))
    maps = (_straddle(shape, cfg.nms_window, cfg.max_peaks_per_channel,
                      taps) if kind == "straddle" else _grid(shape, kind))
    plan = decode.generic_launch_plan(b * k, h, w, taps, cfg.nms_window,
                                      cfg.max_peaks_per_channel)
    assert plan["row_tiles"] * plan["col_tiles"] > 1
    got = _model_decode(maps, cfg, b * k)
    want = decode.decode_maps_plain(maps, cfg)
    for a, c in zip(got, want):
        assert torch.equal(a.isnan(), c.isnan())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(c))
    if kind == "straddle":  # equal values in different tiles, flat order
        scores = want[0]
        assert (scores[:, :-1] == scores[:, 1:]).any()


def test_generic_launcher_checks_before_building(monkeypatch):
    """launch_generic_cuda refuses what the kernel does not take before it
    builds anything, as the counting wrapper does."""
    monkeypatch.setattr(kernels, "load", pytest.fail)
    with pytest.raises(TypeError):
        decode.launch_generic_cuda(torch.zeros(1, 2, 8, 8).half(),
                                   DecodeConfig(nms_window=5))
    with pytest.raises(ValueError):
        decode.launch_generic_cuda(torch.zeros(1, 2, 4, 4),
                                   DecodeConfig(max_peaks_per_channel=17))


def test_phase_tool_refuses_generic_without_a_card(monkeypatch, capsys):
    """tools/decode_phases.py --kernel generic measures on a card only:
    without one it exits non-zero before building and prints no result."""
    from multiposenet_tpu_torch.tools import decode_phases

    monkeypatch.setattr(kernels, "nvcc_path", pytest.fail)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert decode_phases.main(["--kernel", "generic", "--window", "5",
                               "--batch", "1"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_phase_tool_matches_the_generic_marks():
    """The tool's GENERIC_PHASES are the source's `enum Phase`, in order,
    and the kernel marks every one of them (DG_MARK)."""
    from multiposenet_tpu_torch.tools import decode_phases

    text = (kernels.CSRC / "decode_generic.cu").read_text()
    enum = re.search(r"enum Phase \{([^}]*)\}", text).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names[-1] == "kPhases"
    assert tuple(names[:-1]) == decode_phases.GENERIC_PHASES
    assert set(re.findall(r"DG_MARK\((\w+)\);", text)) == set(
        decode_phases.GENERIC_PHASES)
    assert decode_phases.KERNELS["generic"][3] == decode_phases.GENERIC_PHASES
