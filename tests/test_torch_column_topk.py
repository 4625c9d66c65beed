"""B4, the per-column top-8 of the 3x3 peak mask (`ops/column_topk.py`):
its plain version against the decode micro-benchmark's TPU kernel,
`benchmarks/ab/dbench2.py kern_reduce`, run through `pl.pallas_call` in
interpret mode (all three of its variants), and against a numpy oracle on
every column; the wrapper's refusals before anything is built; and the
micro-benchmark tool `tools/dbench2.py` rehearsed on the CPU.

`dbench2.py` runs its benchmark when it is imported, so it is not
imported: its imports, constants, `_prep` and `kern_reduce` are taken from
its source with `ast` and run in a namespace of their own, whose H, W and N
are then set to the test's shape."""

import ast
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.ops import column_topk
from multiposenet_tpu_torch.tools import dbench2

from torch_port_helpers import chip_smoke_module
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
DBENCH2 = REPO / "benchmarks" / "ab" / "dbench2.py"
VARIANTS = ("keepdims", "fold", "foldpair")
# (N, H, W): `fold` halves H, so H is a power of two; N is a multiple of
# the kernel's 8 maps a block.
SHAPES = ((16, 16, 16), (16, 32, 8), (8, 8, 24))


@functools.lru_cache(maxsize=None)
def _kern_reduce_code():
    """dbench2.py's imports, constants (Assign nodes), `_prep` and
    `kern_reduce`, compiled without the rest of the script."""
    tree = ast.parse(DBENCH2.read_text())
    keep = [node for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom, ast.Assign))
            or (isinstance(node, ast.FunctionDef)
                and node.name in ("_prep", "kern_reduce"))]
    return compile(ast.Module(body=keep, type_ignores=[]), str(DBENCH2),
                   "exec")


@functools.lru_cache(maxsize=None)
def _kern_reduce(variant: str, n: int, h: int, w: int):
    """kern_reduce's pallas_call for [n, h, w] maps in interpret mode, on
    the script's own grid (NM maps a block) and blocks, jitted."""
    ns = {}
    exec(_kern_reduce_code(), ns)
    ns.update(H=h, W=w, N=n)
    nm, top = ns["NM"], ns["NP_"]
    out_spec = pl.BlockSpec((nm, top), lambda i: (i, 0))
    call = pl.pallas_call(
        functools.partial(ns["kern_reduce"], variant=variant),
        grid=(n // nm,),
        in_specs=[pl.BlockSpec((nm, h, w), lambda i: (i, 0, 0))],
        out_specs=(out_spec, out_spec),
        out_shape=(jax.ShapeDtypeStruct((n, top), jnp.float32),
                   jax.ShapeDtypeStruct((n, top), jnp.int32)),
        interpret=True,
    )
    return jax.jit(call)


def _maps(kind: str, shape, rng) -> torch.Tensor:
    """bf16 maps [N, H, W] of one kind: uniform noise (many ties in bf16),
    plateaus of 2x2 blocks at 4 levels, a ramp falling row by row with two
    bumps near column 0 (fewer than 8 peaks in column 0, so its list ends
    in (-inf, 5) slots), or a constant map."""
    n, h, w = shape
    if kind == "noise":
        x = rng.rand(n, h, w)
    elif kind == "plateaus":
        levels = rng.randint(0, 4, (n, (h + 1) // 2, (w + 1) // 2)) / 4
        x = np.repeat(np.repeat(levels, 2, 1), 2, 2)[:, :h, :w]
    elif kind == "sparse_bumps":
        yy, xx = np.mgrid[0:h, 0:w]
        x = np.broadcast_to(-0.05 * yy, (n, h, w)).copy()
        for _ in range(2):
            cy = rng.uniform(0, h, (n, 1, 1))
            cx = rng.uniform(0, 3, (n, 1, 1))
            amp = rng.uniform(0.5, 1.0, (n, 1, 1))
            x += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 4.5)
    else:
        x = np.full((n, h, w), 0.5)
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _jax_bf16(x: torch.Tensor):
    """The same bf16 values as a JAX array (exact through f32)."""
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("kind", ["noise", "plateaus", "sparse_bumps",
                                  "constant"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_kern_reduce(variant, shape, kind):
    """Scores and packed rows bit for bit, the (-inf, 5) slots of a
    column's exhausted peaks included."""
    x = _maps(kind, shape, np.random.RandomState(sum(shape)))
    want_s, want_p = _kern_reduce(variant, *shape)(_jax_bf16(x))
    got_s, got_p = column_topk.column_topk_plain(x)
    assert got_s.dtype == torch.float32 and got_p.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    if kind == "sparse_bumps":
        empty = np.isneginf(np.asarray(want_s))
        assert empty.any()
        assert (np.asarray(want_p)[empty] == 5).all()


def test_plain_matches_kern_reduce_with_nan():
    """A NaN makes its 3x3 window's maximum NaN in both (jnp.maximum and
    max_pool2d propagate it), so neither it nor its neighbours are peaks."""
    x = _maps("noise", SHAPES[0], np.random.RandomState(7))
    x[0, 3, 0] = x[1, 0, 1] = x[2, 5, 5] = float("nan")
    want_s, want_p = _kern_reduce("keepdims", *SHAPES[0])(_jax_bf16(x))
    got_s, got_p = column_topk.column_topk_plain(x)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def _oracle(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Every column's top-8 peaks by plain loops: the peaks of a column
    sorted by (value desc, row asc), the rest (-inf, 5)."""
    n, h, w = x.shape
    scores = np.full((n, 8, w), -np.inf, np.float32)
    rows = np.full((n, 8, w), 5, np.int32)
    for i in range(n):
        for c in range(w):
            peaks = []
            for r in range(h):
                window = x[i, max(r - 1, 0):r + 2, max(c - 1, 0):c + 2]
                if x[i, r, c] >= window.max() and x[i, r, c] > -np.inf:
                    peaks.append((-x[i, r, c], r))
            for j, (neg, r) in enumerate(sorted(peaks)[:8]):
                scores[i, j, c], rows[i, j, c] = -neg, r * 16 + 5
    return scores, rows


@pytest.mark.parametrize("shape", [(3, 12, 10), (2, 1, 7), (2, 9, 1),
                                   (2, 5, 6), (1, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["noise", "plateaus"])
def test_plain_columns_match_oracle(shape, kind):
    x = _maps(kind, shape, np.random.RandomState(11))
    want_s, want_p = _oracle(x.float().numpy())
    got_s, got_p = column_topk.column_topk_plain(x, columns=True)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    col_s, col_p = column_topk.column_topk_plain(x)
    assert torch.equal(col_s, got_s[:, :, 0])
    assert torch.equal(col_p, got_p[:, :, 0])


def test_entry_point_runs_plain_on_cpu():
    """On a CPU tensor `column_topk` runs the plain version, fills
    columns_out with every column's lists and launches nothing."""
    x = _maps("noise", (4, 12, 20), np.random.RandomState(2))
    cols = (torch.empty(4, 8, 20), torch.empty(4, 8, 20, dtype=torch.int32))
    kernels.reset_launches()
    scores, rows = column_topk.column_topk(x, columns_out=cols)
    want_s, want_p = column_topk.column_topk_plain(x, columns=True)
    assert torch.equal(cols[0], want_s) and torch.equal(cols[1], want_p)
    assert torch.equal(scores, want_s[:, :, 0])
    assert torch.equal(rows, want_p[:, :, 0])
    assert kernels.LAUNCHES == {}


@pytest.mark.parametrize("case", ["dtype", "ndim", "strides", "width",
                                  "height", "empty", "columns_out",
                                  "device"])
def test_wrapper_refuses_before_building(case, monkeypatch):
    """The wrapper refuses what the kernel does not take before it builds
    or launches anything (CPU tensors stand in for CUDA ones): bf16 only,
    [N, H, W], contiguous, 1 <= W <= 1024, 1 <= H <= 2**27, N >= 1,
    columns_out as contiguous [N, 8, W] float32 and int32, all on one
    CUDA device."""
    monkeypatch.setattr(kernels, "load", pytest.fail)
    kernels.reset_launches()
    bf16 = torch.bfloat16
    x, cols, err = torch.zeros(2, 16, 16, dtype=bf16), None, ValueError
    if case == "dtype":
        x, err = x.float(), TypeError
    elif case == "ndim":
        x = x[None]
    elif case == "strides":
        x = x.transpose(1, 2)
    elif case == "width":
        x = torch.zeros(1, 2, column_topk.MAX_WIDTH + 1, dtype=bf16)
    elif case == "height":  # on the meta device: no memory is needed
        x = torch.empty(1, column_topk.MAX_ROWS + 1, 1, dtype=bf16,
                        device="meta")
    elif case == "empty":
        x = torch.zeros(0, 16, 16, dtype=bf16)
    elif case == "columns_out":
        cols = (torch.empty(2, 8, 16), torch.empty(2, 8, 16))
    with pytest.raises(err):
        column_topk.launch_cuda(x, cols)
    assert kernels.LAUNCHES == {}


def test_column_topk_bound_matches_hand_count():
    """2176 bf16 maps of 128² read once and 2 x 8 x 4 bytes written a map
    (71.44 MB, 0.0213 ms at 3.35 TB/s); 9 operations an element (0.0096
    ms): bytes bind. The tool reports the same bound."""
    bound = chip_smoke_module().column_topk_bound(2176, 128, 128)
    assert bound["bytes"] == 2176 * 128 * 128 * 2 + 2176 * 64 == 71_442_432
    assert bound["ops"] == 9 * 2176 * 128 * 128
    assert bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == pytest.approx(0.0213261, abs=1e-7)
    assert bound["ops_ms"] == pytest.approx(0.0095911, abs=1e-7)
    assert dbench2.column_topk_bound(2176, 128, 128) == bound


def test_dbench2_rehearsal_on_cpu(capsys):
    """`--device cpu --maps 16` runs the plain versions through the tool's
    whole flow (1 warm-up call and 3 rounds of 20 of each) and prints one
    JSON line, which names the CPU and no card. Its maps are dbench2.py's:
    numpy seed 0's uniform noise rounded to bf16."""
    kernels.reset_launches()
    assert dbench2.main(["--device", "cpu", "--maps", "16"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["device"] == "cpu" and out["card"] is None
    assert out["maps"] == [16, 128, 128]
    for name in ("column_topk", "decode_peaks"):
        assert len(out[name]["rounds_ms"]) == 3
        assert out[name]["ms"] == min(out[name]["rounds_ms"])
        assert "plain" in out[name]["ran"]
    assert out["column_topk"]["bytes"] == 16 * 128 * 128 * 2 + 16 * 64
    assert kernels.LAUNCHES == {}
    x = dbench2.make_maps(16, "cpu")
    assert x.dtype == torch.bfloat16 and tuple(x.shape) == (16, 128, 128)
    assert torch.equal(x[0, 0].float(), torch.from_numpy(
        np.random.RandomState(0).rand(128).astype(np.float32)).to(
            torch.bfloat16).float())


def test_dbench2_run_refuses_without_cuda(monkeypatch):
    """With no device given, the tool runs on the card or raises: it never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dbench2.run()


# The card tests' shapes (tests/test_torch_cuda.py), where launch_plan's
# tiles are checked.
CARD_SHAPES = ((2176, 128, 128), (1, 128, 128), (793, 128, 128),
               (4, 1, 128), (4, 128, 1), (4, 127, 128), (4, 128, 130),
               (3, 128, 256), (2, 20, 1024), (3, 31, 128), (3, 33, 128),
               (3, 65, 96), (2, 4097, 128), (2, 7, 200), (5, 9, 1),
               (1, 1, 1), (1, 300, 1024))


def _plan_tiles(n: int, h: int, w: int):
    """The kernel's tiles under launch_plan, in the order each block walks
    them (csrc/column_topk.cu: block b takes maps b, b + grid, ..., each
    in tiles of chunk_rows rows): (block, map, first row, rows, halo row
    above, halo row below), the halos -1 or h outside the map."""
    plan = column_topk.launch_plan(n, h, w)
    ch, grid = plan["chunk_rows"], plan["grid"]
    for block in range(grid):
        for m in range(block, n, grid):
            for r0 in range(0, h, ch):
                rows = min(ch, h - r0)
                yield block, m, r0, rows, r0 - 1, r0 + rows


@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_launch_plan_covers_every_row_once(shape):
    """Every row of every map lies in exactly one tile, walked by one
    block in row order, with the halo rows just above and below it; the
    plan fits the card (threads, shared memory, one block an SM at
    least) and never has more blocks than maps."""
    n, h, w = shape
    plan = column_topk.launch_plan(n, h, w)
    assert plan["fast"] == (h == w == 128)
    assert plan["threads"] % 32 == 0 and w <= plan["threads"] <= 1024
    assert plan["pitch"] % 8 == 0 and w <= plan["pitch"] < w + 8
    assert plan["chunk_rows"] % column_topk.STRIP == 0
    assert plan["smem_bytes"] + 1024 <= 232448
    assert plan["blocks_per_sm"] >= 1 and 1 <= plan["grid"] <= n
    seen = {}
    block_of = {}
    for block, m, r0, rows, above, below in _plan_tiles(n, h, w):
        assert 1 <= rows <= plan["chunk_rows"]
        assert (above, below) == (r0 - 1, r0 + rows)
        assert block_of.setdefault(m, block) == block
        assert seen.get(m, 0) == r0  # the map's tiles in row order
        seen[m] = r0 + rows
    assert seen == {m: h for m in range(n)}
    assert len(set(block_of.values())) == plan["grid"]


def test_launch_plan_at_the_micro_benchmark_shape():
    """2176 maps of 128²: tiles of 64 rows (two a map), 128 threads, 34 KB
    of shared memory, 6 blocks on each of 132 SMs: 792 blocks, each
    taking 2 or 3 maps."""
    assert column_topk.launch_plan(2176, 128, 128) == {
        "fast": 1, "threads": 128, "chunk_rows": 64, "chunks": 2,
        "pitch": 128, "smem_bytes": 34816, "blocks_per_sm": 6, "grid": 792}


def test_phases_tool_refuses_without_cuda(monkeypatch, capsys):
    from multiposenet_tpu_torch.tools import column_topk_phases
    monkeypatch.setattr(kernels, "nvcc_path", pytest.fail)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert column_topk_phases.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_phases_tool_matches_the_marks_in_the_source():
    """The tool's PHASES are the source's `enum Phase`, in order, and the
    kernel marks every one of them."""
    import re
    from multiposenet_tpu_torch.tools import column_topk_phases
    text = (kernels.CSRC / "column_topk.cu").read_text()
    enum = re.search(r"enum Phase \{([^}]*)\}", text).group(1)
    names = [s.strip() for s in enum.split(",")]
    assert names[-1] == "kPhases"
    assert tuple(names[:-1]) == column_topk_phases.PHASES
    marked = set(re.findall(r"CT_MARK\((\w+)\);", text))
    assert marked == set(column_topk_phases.PHASES)


def test_launch_plan_constants_match_the_source():
    """launch_plan's constants are those of csrc/column_topk.cu, read as
    text (`constexpr int kName = value;`, kFastSize as FAST_SIZE)."""
    import re
    text = (kernels.CSRC / "column_topk.cu").read_text()
    consts = dict(re.findall(r"constexpr int k(\w+) = (\d+);", text))
    for name in ("STRIP", "STAGES", "CHUNK_BYTES", "SMEM_PER_SM",
                 "SMEM_PER_BLOCK", "FAST_SIZE", "FAST_CHUNK", "FAST_THREADS",
                 "FAST_REGS", "GENERIC_REGS"):
        camel = "".join(p.capitalize() for p in name.lower().split("_"))
        assert int(consts[camel]) == getattr(column_topk, name), name
