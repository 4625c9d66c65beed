"""The AV1 encoder of cv2's default AVIF writer (libaom 3.14.1, all-intra,
speed 9, as libavif 1.4.2 sets it up), in NumPy and plain Python: the
plain twin of `csrc/av1_encode.c`.

`utils/avif_write.py` states the contract and writes the container and
the headers; this module writes the tiles. Given the frame's Y, U and V
planes (8-bit 4:2:0), `encode_tiles` makes libaom's decisions and codes
them:

- each 64x64 superblock's qindex: libaom's variance boost
  (`av1_get_sbq_variance_boost`, deltaq-mode 6, strength 3) rounded to
  the delta q step (`sb_qindex`);
- its partition: libaom's variance-based partitioning of key frames
  (`av1_choose_var_based_partitioning`) at the thresholds of that qindex
  (`partition`);
- each block's luma mode among DC, V, H and SMOOTH:
  `av1_nonrd_pick_intra_mode` (`Encoder.decide`), whose estimate is
  Hadamard transforms and the low-precision quantizer of the
  prediction's error (`av1_block_yrd`), weighed at the block's
  SSIM-scaled rdmult (`av1_set_ssim_rdmult`) with the mode and skip
  costs of the frame's first CDFs (from 4K up: of the tile's CDFs as each
  superblock row starts); chroma is DC;
- each transform block (the largest square transform of a block, the
  largest of its chroma, under TX_MODE_SELECT where blocks are
  rectangular): libaom's forward DCT (`av1_fwd_txfm2d_*_c`), the fp
  quantizer with the quantizer matrices of level 8
  (`quantize_fp_helper_c`) and the trellis (`av1_optimize_txb` at
  sharpness 7, the QM-weighted distortion and the coefficient costs of
  the same CDFs), then the reconstruction through the decoder's
  own prediction (`av1.nondir_predict`) and inverse transform
  (`av1.inverse_transform_add`), from which the next blocks predict;
- the symbols: libaom's od_ec encoder (`SymbolWriter`) and the tile
  syntax the decoder reads in `utils/av1.py` (`TileWriter`), with the
  CDFs adapting as the decoder adapts them.

Each stage is held to libaom's function of the same name (called through
ctypes in the wheel's library) or to the decisions the decoder reads
back from cv2's files by `tests/test_torch_avif_write.py`.
"""

from __future__ import annotations

import math

import numpy as np

from multiposenet_tpu_torch.utils import av1
from multiposenet_tpu_torch.utils.av1 import (BH4, BW4, MI_HLOG2, MI_WLOG2,
                                             TX_HLOG2, TX_SQR, TX_SQR_UP,
                                             TX_WLOG2)
from multiposenet_tpu_torch.utils.av1_tables import table

# The frame's settings: what libavif 1.4.2 asks of libaom 3.14.1 for
# cv2's default file (quality 50, speed 9, tune IQ).
BASE_Q = 148
CHROMA_DELTA_Q = -16
QM_LEVEL = 8
DELTA_Q_RES = 2  # log2 of the qindex step a superblock codes
SHARPNESS = 7  # the trellis's (the loop filter's is 1)

DC_PRED, V_PRED, H_PRED, SMOOTH_PRED = 0, 1, 2, 9
BLOCK_8X8, BLOCK_64X64 = 3, 12
PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT = range(4)
# The square transform of each block size (libaom's max_txsize_lookup),
# BLOCK_8X8 .. BLOCK_64X64: luma's transform, and the one its intra
# modes are estimated at.
SQUARE_TX = {3: 1, 4: 1, 5: 1, 6: 2, 7: 2, 8: 2, 9: 3, 10: 3, 11: 3, 12: 4}


# --- forward transforms ------------------------------------------------------


def _dct_steps(n: int) -> list:
    """The inverse DCT's butterflies of 2^n points in order, as
    `av1.idct` runs them: ("B", a, b, angle, flip) and ("H", a, b, flip)."""
    steps = []
    real_b, real_h = av1._bfly, av1._hada
    av1._bfly = lambda T, a, b, angle, flip: steps.append(
        ("B", a, b, angle, flip))
    av1._hada = lambda T, a, b, flip, r=16: steps.append(("H", a, b, flip))
    try:
        av1.idct([0] * (1 << n), n)
    finally:
        av1._bfly, av1._hada = real_b, real_h
    return steps


_STEPS: dict = {}


def dct_steps(n: int) -> list:
    """The forward DCT's steps of 2^n points (the inverse's, reversed)."""
    if n not in _STEPS:
        _STEPS[n] = _dct_steps(n)[::-1]
    return _STEPS[n]


def _cos(angle: int, bit: int) -> int:
    cospi = table("cospi")[bit - 10]
    a = angle & 255
    if a <= 64:
        return int(cospi[a])
    if a <= 128:
        return -int(cospi[128 - a])
    if a <= 192:
        return -int(cospi[a - 128])
    return int(cospi[256 - a])


def fdct(x, n: int, cos_bit: int) -> list:
    """libaom's av1_fdct4 .. av1_fdct32 (2^n points): the inverse DCT's
    graph transposed, each rotation rounded at `cos_bit` bits."""
    T = [int(v) for v in x]
    rnd = 1 << (cos_bit - 1)
    for step in dct_steps(n):
        if step[0] == "B":
            _, a, b, angle, flip = step
            c, s = _cos(angle, cos_bit), _cos(angle - 64, cos_bit)
            xa, yb = (T[b], T[a]) if flip else (T[a], T[b])
            T[a] = (xa * c + yb * s + rnd) >> cos_bit
            T[b] = (-xa * s + yb * c + rnd) >> cos_bit
        else:
            _, a, b, flip = step
            if flip:
                a, b = b, a
            T[a], T[b] = T[a] + T[b], T[a] - T[b]
    return [T[av1._brev(n, j)] for j in range(1 << n)]


# av1_fwd_txfm_shift_ls by transform, and av1_fwd_cos_bit_col/_row by
# (log2 width - 2, log2 height - 2), for the transforms the encoder uses.
FWD_SHIFT = {0: (2, 0, 0), 1: (2, -1, 0), 2: (2, -2, 0), 3: (2, -4, 0),
             5: (2, -1, 0), 6: (2, -1, 0), 7: (2, -2, 0), 8: (2, -2, 0),
             9: (2, -4, 0), 10: (2, -4, 0)}
FWD_COS_BIT_COL = ((13, 13, 13, 0), (13, 13, 13, 12), (13, 13, 13, 12),
                   (0, 13, 13, 12))
FWD_COS_BIT_ROW = ((13, 13, 12, 0), (13, 13, 13, 12), (13, 13, 12, 13),
                   (0, 12, 13, 12))


def _round_shift(v: int, bit: int) -> int:
    if bit > 0:
        return (v + (1 << (bit - 1))) >> bit
    return v << -bit


def fwd_txfm2d(residual: np.ndarray, tx: int) -> list:
    """libaom's av1_fwd_txfm2d_<W>x<H>_c with DCT_DCT on an H x W
    residual (sides 4 .. 32, at most 2:1): the coefficients column-major
    (index column * H + row, the scan's positions)."""
    lw, lh = TX_WLOG2[tx], TX_HLOG2[tx]
    w, h = 1 << lw, 1 << lh
    s0, s1, s2 = FWD_SHIFT[tx]
    cb_col = FWD_COS_BIT_COL[lw - 2][lh - 2]
    cb_row = FWD_COS_BIT_ROW[lw - 2][lh - 2]
    buf = [[0] * w for _ in range(h)]
    for c in range(w):
        col = fdct([int(residual[r, c]) << s0 for r in range(h)], lh, cb_col)
        for r in range(h):
            buf[r][c] = _round_shift(col[r], -s1)
    out = [0] * (w * h)
    for r in range(h):
        row = fdct(buf[r], lw, cb_row)
        for c in range(w):
            v = _round_shift(row[c], -s2)
            if lw != lh:
                v = _round_shift(v * 5793, 12)  # NewSqrt2
            out[c * h + r] = v
    return out


# --- quantization ------------------------------------------------------------


def quantizer(qindex: int, delta: int, dc: bool) -> tuple[int, int, int]:
    """libaom's av1_build_quantizer entries of one plane's DC or AC at
    qindex (8 bits; sharpness 7 leaves the rounding at half a step):
    (step, fp quantizer, fp rounding)."""
    step = int(table("dc_qlookup" if dc else "ac_qlookup")
               [min(max(qindex + delta, 0), 255)])
    return step, (1 << 16) // step, (64 * step) >> 7


def plane_delta(plane: int) -> int:
    """The delta q of a plane's DC and AC: luma none, chroma the
    frame's."""
    return 0 if plane == 0 else CHROMA_DELTA_Q


def qm_weights(tx: int, plane: int) -> tuple[np.ndarray, np.ndarray]:
    """The quantizer matrices of level QM_LEVEL for a transform of a
    plane: (weights, inverse weights) by coefficient position."""
    n = (1 << TX_WLOG2[tx]) << TX_HLOG2[tx]
    o = av1.QM_OFFSET[tx]
    return (table("wt_matrix")[QM_LEVEL][int(plane > 0)][o:o + n],
            table("iwt_matrix")[QM_LEVEL][int(plane > 0)][o:o + n])


def dequant_steps(qindex: int, plane: int, iwt) -> list:
    """Each position's step with its inverse weight (libaom's get_dqv)."""
    dc = quantizer(qindex, plane_delta(plane), True)[0]
    ac = quantizer(qindex, plane_delta(plane), False)[0]
    return [((dc if i == 0 else ac) * int(iwt[i]) + 16) >> 5
            for i in range(len(iwt))]


def quantize_fp(coeff, scan, qindex: int, plane: int, qm, iqm,
                log_scale: int) -> tuple[list, list, int]:
    """libaom's quantize_fp_helper_c with quantizer matrices (`qm` and
    `iqm` the block's weights by position): (quantized, dequantized,
    eob)."""
    P = [quantizer(qindex, plane_delta(plane), True),
         quantizer(qindex, plane_delta(plane), False)]
    rnd = [(p[2] + ((1 << log_scale) >> 1)) >> log_scale for p in P]
    n = len(coeff)
    qc, dq, eob = [0] * n, [0] * n, -1
    for i in range(n):
        rc = int(scan[i])
        c = int(coeff[rc])
        k = int(rc != 0)
        a = abs(c)
        wt, iwt = int(qm[rc]), int(iqm[rc])
        t32 = 0
        if a * wt >= (P[k][0] << (5 - (1 + log_scale))):
            a = min(a + rnd[k], 32767)
            t32 = (a * wt * P[k][1]) >> (16 - log_scale + 5)
            deq = (P[k][0] * iwt + 16) >> 5
            adq = (t32 * deq) >> log_scale
            qc[rc] = -t32 if c < 0 else t32
            dq[rc] = -adq if c < 0 else adq
        if t32:
            eob = i
    return qc, dq, eob + 1


# --- costs -------------------------------------------------------------------


def cost_symbol(p15: int) -> int:
    """libaom's av1_cost_symbol: the cost of a probability in 1/512
    bits."""
    p15 = min(max(p15, 1), 32767)
    shift = 15 - p15.bit_length()
    prob = min(max(((p15 << shift) * 256 + 16384) // 32768, 1), 255)
    return int(table("prob_cost")[prob - 128]) + (shift << 9)


def cdf_costs(icdf: list, nsyms: int) -> list:
    """libaom's av1_cost_tokens_from_cdf of an inverse CDF."""
    out, prev = [], 0
    for i in range(nsyms):
        p = (32768 - icdf[i]) - prev
        prev = 32768 - icdf[i]
        out.append(cost_symbol(max(p, 4)))
    return out


class CoeffCosts:
    """libaom's av1_fill_coeff_costs from a tile's CDFs (`av1.init_cdfs`
    form), what the trellis reads: for each square transform context and
    plane type the base, end-of-block base, extra eob bit, DC sign and
    range costs, and for each eob size the eob costs."""

    def __init__(self, cdf: dict):
        self.coeff = {}
        for txs in range(5):
            for ptype in range(2):
                base = []
                for c in cdf["coeff_base"][txs][ptype]:
                    k = cdf_costs(c, 4)
                    base.append(k + [0, k[1] + 512 - k[0], k[2] - k[1],
                                     k[3] - k[2]])
                lps = []
                for c in cdf["coeff_br"][min(txs, 3)][ptype]:
                    br = cdf_costs(c, 4)
                    row, prev = [0] * 26, 0
                    for i in range(0, 12, 3):
                        for j in range(3):
                            row[i + j] = prev + br[j]
                        prev += br[3]
                    row[12] = prev
                    row[13] = row[0]
                    for i in range(1, 13):
                        row[13 + i] = row[i] - row[i - 1]
                    lps.append(row)
                self.coeff[(txs, ptype)] = {
                    "base_eob": [cdf_costs(c, 3) for c in
                                 cdf["coeff_base_eob"][txs][ptype]],
                    "base": base,
                    "eob_extra": [cdf_costs(c, 2) for c in
                                  cdf["eob_extra"][txs][ptype]],
                    "dc_sign": [cdf_costs(c, 2) for c in
                                cdf["dc_sign"][ptype]],
                    "lps": lps}
        self.eob = {(ems, ptype): cdf_costs(cdf[f"eob{16 << ems}"][ptype][0],
                                            5 + ems)
                    for ems in range(7) for ptype in range(2)}


class ModeCosts:
    """The skip flag's and the key-frame luma modes' costs (libaom's
    av1_fill_mode_rates) from a tile's CDFs."""

    def __init__(self, cdf: dict):
        self.skip = cdf_costs(cdf["skip"][0], 2)
        self.kf_y = [[cdf_costs(cdf["kf_y"][a][b], 13) for b in range(5)]
                     for a in range(5)]


def rdcost(rdmult: int, rate: int, dist: int) -> int:
    """libaom's RDCOST: rate in 1/512 bits at rdmult, distortion << 7."""
    return ((rate * rdmult + 256) >> 9) + (dist << 7)


def rd_mult(qindex: int) -> int:
    """libaom's av1_compute_rd_mult_based_on_qindex of a key frame at 8
    bits tuned for image quality (AOM_TUNE_IQ): dc_q^2 (3.3 + 0.0015
    dc_q), then weighed by (128 + min((255 - qindex) 3 / 4, 72)) / 128."""
    q = int(table("dc_qlookup")[qindex])
    rdmult = int(q * q * (3.3 + 0.0015 * q))
    weight = min(max(((255 - qindex) * 3) // 4, 0), 72) + 128
    return max(int(rdmult * weight / 128.0), 1)


def source_variance(y: np.ndarray, r: int, c: int, bw: int, bh: int) -> int:
    """libaom's av1_get_perpixel_variance of a luma block: its variance
    (sse - sum^2 / n) over n pixels, rounded."""
    b = y[r:r + bh, c:c + bw].astype(np.int64)
    s, sse = int(b.sum()), int((b * b).sum())
    shift = (bw * bh).bit_length() - 1
    var = (sse - ((s * s) >> shift)) & 0xFFFFFFFF
    return (var + (1 << (shift - 1))) >> shift


def ssim_factors(y: np.ndarray, width: int, height: int) -> np.ndarray:
    """libaom's av1_set_mb_ssim_rdmult_scaling: for each 16x16 of the
    mode-info grid, 67.035434 (1 - exp(-0.0021489 v)) + 17.492222 of the
    mean per-pixel variance v of its 8x8 blocks, over the frame's
    geometric mean."""
    mi_cols, mi_rows = 2 * ((width + 7) >> 3), 2 * ((height + 7) >> 3)
    cols, rows = (mi_cols + 3) // 4, (mi_rows + 3) // 4
    out = np.zeros((rows, cols))
    log_sum = 0.0
    for row in range(rows):
        for col in range(cols):
            var = num = 0.0
            for mr in range(row * 4, min(mi_rows, (row + 1) * 4), 2):
                for mc in range(col * 4, min(mi_cols, (col + 1) * 4), 2):
                    var += source_variance(y, mr * 4, mc * 4, 8, 8)
                    num += 1.0
            var = var / num
            var = 67.035434 * (1.0 - math.exp(-0.0021489 * var)) \
                + 17.492222
            out[row, col] = var
            log_sum += math.log(var)
    mean = math.exp(log_sum / float(rows * cols))
    return out / mean


def block_rdmult(factors: np.ndarray, bsize: int, mi_row: int, mi_col: int,
                 base: int) -> int:
    """libaom's av1_set_ssim_rdmult: `base` times the geometric mean of
    the 16x16 factors the block covers, rounded."""
    rows, cols = factors.shape
    product, n = 1.0, 0.0
    for row in range(mi_row // 4, min(rows, mi_row // 4
                                      + (BH4[bsize] + 3) // 4)):
        for col in range(mi_col // 4, min(cols, mi_col // 4
                                          + (BW4[bsize] + 3) // 4)):
            product *= factors[row, col]
            n += 1.0
    return max(int(base * math.pow(product, 1.0 / n) + 0.5), 0)


# --- the symbol writer -------------------------------------------------------


class SymbolWriter:
    """libaom's od_ec_enc (precarry buffer) and aom_write_symbol: symbols
    of inverse CDFs and booleans in, the tile's bytes out, as
    `av1.SymbolDecoder` reads them."""

    def __init__(self):
        self.low, self.rng, self.cnt = 0, 0x8000, -9
        self.precarry: list[int] = []

    def _normalize(self, low: int, rng: int) -> None:
        d = 16 - rng.bit_length()
        c = self.cnt
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.precarry.append(low >> c)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append(low >> c)
            s = c + d - 24
            low &= m
        self.low, self.rng, self.cnt = low << d, rng << d, s

    def encode_cdf(self, icdf, s: int, nsyms: int) -> None:
        fl = icdf[s - 1] if s > 0 else 32768
        fh = icdf[s]
        r, n = self.rng, nsyms - 1
        if fl < 32768:
            u = ((r >> 8) * (fl >> 6) >> 1) + 4 * (n - (s - 1))
            v = ((r >> 8) * (fh >> 6) >> 1) + 4 * (n - s)
            self._normalize(self.low + r - u, u - v)
        else:
            self._normalize(self.low,
                            r - (((r >> 8) * (fh >> 6) >> 1) + 4 * (n - s)))

    def symbol(self, cdf: list, s: int, nsyms: int) -> None:
        self.encode_cdf(cdf, s, nsyms)
        av1.update_cdf(cdf, s, nsyms)

    def bool(self, val: int, f: int) -> None:
        r = self.rng
        v = ((r >> 8) * (f >> 6) >> 1) + 4
        self._normalize(self.low + (r - v if val else 0),
                        v if val else r - v)

    def bit(self, val: int) -> None:
        self.bool(val, 16384)

    def literal(self, n: int, v: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def done(self) -> bytes:
        c, m = self.cnt, 0x3FFF
        e = ((self.low + m) & ~m) | (m + 1)
        s = c + 10
        buf = list(self.precarry)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while s > 0:
                buf.append(e >> (c + 16))
                e &= n
                s -= 8
                c -= 8
                n >>= 8
        out = bytearray(len(buf))
        carry = 0
        for i in range(len(buf) - 1, -1, -1):
            carry += buf[i]
            out[i] = carry & 0xFF
            carry >>= 8
        return bytes(out)


# --- the tile syntax ---------------------------------------------------------


class Block:
    """A coded block's decisions: its position (mode-info units) and
    size, its luma mode (chroma is DC), its luma transform size, its
    superblock's qindex, and the quantized coefficients of each transform
    block (by plane, in coding order; each a list by position, or None
    where all are zero)."""

    def __init__(self, r: int, c: int, bsize: int, y_mode: int = DC_PRED,
                 tx: int = 0, q: int = BASE_Q, coeffs=None):
        self.r, self.c, self.bsize = r, c, bsize
        self.y_mode, self.tx, self.q = y_mode, tx, q
        self.coeffs = coeffs or [[], [], []]


def uv_tx_size(bsize: int) -> int:
    """The chroma transform of a 4:2:0 block."""
    return av1._uv_tx_size(bsize, 1, 1)


def transform_blocks(bsize: int, plane: int, tx: int, mi_rows: int,
                     mi_cols: int, r: int, c: int) -> list:
    """(x4, y4, x, y) of a plane's transform blocks in coding order: the
    position in 4x4 units of the plane and within the block, those past
    the frame's mode-info edge left out, as `av1._residual` visits them
    (blocks of up to 32x32)."""
    sx = sy = int(plane > 0)
    step_x, step_y = 1 << (TX_WLOG2[tx] - 2), 1 << (TX_HLOG2[tx] - 2)
    pbs = table("ss_size_lookup")[bsize][1][1] if plane else bsize
    out = []
    for y in range(0, BH4[pbs], step_y):
        for x in range(0, BW4[pbs], step_x):
            x4, y4 = (c >> sx) + x, (r >> sy) + y
            if 4 * x4 < (mi_cols * 4) >> sx and 4 * y4 < (mi_rows * 4) >> sy:
                out.append((x4, y4, x, y))
    return out


class TileWriter:
    """Writes one tile's symbols from its blocks' decisions, keeping the
    contexts and CDFs as `av1._decode_tile` does. `source(b, plane, i,
    x4, y4, x, y, tx, skip_ctx, dc_sign_ctx)` gives the levels of a
    block's i-th transform block of a plane as it is reached (the
    `Block`'s own by default); `decide(b, writer)`, where given, picks a
    block's mode before it is written."""

    def __init__(self, width: int, height: int, rows: tuple, cols: tuple,
                 delta_q: bool, tx_select: bool, source=None, decide=None):
        self.mi_cols = 2 * ((width + 7) >> 3)
        self.mi_rows = 2 * ((height + 7) >> 3)
        self.row_start, self.row_end = rows
        self.col_start, self.col_end = cols
        self.delta_q, self.tx_select = delta_q, tx_select
        self.source = source or (lambda b, plane, i, *rest:
                                 b.coeffs[plane][i])
        self.decide = decide
        shape = (self.mi_rows + 32, self.mi_cols + 32)
        self.mi_size = np.zeros(shape, np.int64)
        self.y_mode = np.zeros(shape, np.int64)
        self.tx_size = np.zeros(shape, np.int64)
        self.ec = SymbolWriter()
        self.cdf = av1.init_cdfs(BASE_Q)
        self.above = [[0] * (self.mi_cols + 64) for _ in range(3)]
        self.current_q = BASE_Q

    def inside(self, r: int, c: int) -> bool:
        return (self.col_start <= c < self.col_end
                and self.row_start <= r < self.row_end)

    def start_row(self) -> None:
        self.left = [[0] * 32 for _ in range(3)]

    def superblock(self, r: int, c: int, qindex: int, blocks: list) -> None:
        """One superblock at (r, c): its qindex and its blocks in coding
        order (their sizes give the partition tree)."""
        self.pending_q = qindex if self.delta_q else None
        self.at = {(b.r, b.c): b for b in blocks}
        self._partition(r, c, BLOCK_64X64)

    def _partition(self, r: int, c: int, bsize: int) -> None:
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        num4 = BW4[bsize]
        half = num4 >> 1
        has_rows = r + half < self.mi_rows
        has_cols = c + half < self.mi_cols
        sub_h = av1.bsize_of(num4, half)
        sub_v = av1.bsize_of(half, num4)
        split = av1.bsize_of(half, half)
        b = self.at.get((r, c))
        kind = PARTITION_SPLIT
        if b is not None and b.bsize == bsize:
            kind = PARTITION_NONE
        elif b is not None and b.bsize == sub_h:
            kind = PARTITION_HORZ
        elif b is not None and b.bsize == sub_v:
            kind = PARTITION_VERT
        bsl = MI_WLOG2[bsize]
        above = self.inside(r - 1, c) and \
            MI_WLOG2[self.mi_size[r - 1, c]] < bsl
        left = self.inside(r, c - 1) and \
            MI_HLOG2[self.mi_size[r, c - 1]] < bsl
        cdf = self.cdf["partition"][(bsl - 1) * 4 + 2 * left + above]
        nsym = 4 if bsl == 1 else 10
        if has_rows and has_cols:
            self.ec.symbol(cdf, kind, nsym)
        elif has_rows:
            assert kind in (PARTITION_SPLIT, PARTITION_VERT)
            p = 32768 - sum(av1._cdf_prob(cdf, e) for e in (1, 3, 4, 5, 6, 8))
            self.ec.encode_cdf([32768 - p, 0], int(kind == PARTITION_SPLIT),
                               2)
        elif has_cols:
            assert kind in (PARTITION_SPLIT, PARTITION_HORZ)
            p = 32768 - sum(av1._cdf_prob(cdf, e) for e in (2, 3, 4, 6, 7, 9))
            self.ec.encode_cdf([32768 - p, 0], int(kind == PARTITION_SPLIT),
                               2)
        else:
            assert kind == PARTITION_SPLIT
        if kind == PARTITION_NONE:
            self._block(b)
        elif kind == PARTITION_HORZ:
            self._block(b)
            if has_rows:
                self._block(self.at[(r + half, c)])
        elif kind == PARTITION_VERT:
            self._block(b)
            if has_cols:
                self._block(self.at[(r, c + half)])
        else:
            for dr, dc in ((0, 0), (0, half), (half, 0), (half, half)):
                self._partition(r + dr, c + dc, split)

    def _block(self, b: Block) -> None:
        r, c, bsize = b.r, b.c, b.bsize
        cdf, ec = self.cdf, self.ec
        if self.decide is not None:
            self.decide(b, self)
        avail_u, avail_l = self.inside(r - 1, c), self.inside(r, c - 1)
        ec.symbol(cdf["skip"][0], 0, 2)  # intra blocks are never skipped
        if self.pending_q is not None:
            d = (self.pending_q - self.current_q) >> DELTA_Q_RES
            self._delta(d)
            self.current_q += d << DELTA_Q_RES
            self.pending_q = None
        above = int(self.y_mode[r - 1, c]) if avail_u else DC_PRED
        left = int(self.y_mode[r, c - 1]) if avail_l else DC_PRED
        ctx = av1.INTRA_MODE_CTX
        ec.symbol(cdf["kf_y"][ctx[above]][ctx[left]], b.y_mode, 13)
        if V_PRED <= b.y_mode <= 8 and bsize >= BLOCK_8X8:
            ec.symbol(cdf["angle_delta"][b.y_mode - V_PRED], 3, 7)
        bw, bh = 4 * BW4[bsize], 4 * BH4[bsize]
        cfl_allowed = int(max(bw, bh) <= 32)
        ec.symbol(cdf["uv"][cfl_allowed][b.y_mode], DC_PRED,
                  13 + cfl_allowed)
        if b.y_mode == DC_PRED and max(bw, bh) <= 32:
            ec.symbol(cdf["filter_intra"][bsize], 0, 2)
        self._tx_size(b)
        r1, c1 = min(r + BH4[bsize], self.mi_rows), \
            min(c + BW4[bsize], self.mi_cols)
        self.y_mode[r:r1, c:c1] = b.y_mode
        self.tx_size[r:r1, c:c1] = b.tx
        self.mi_size[r:r1, c:c1] = bsize
        for plane in range(3):
            tx = b.tx if plane == 0 else uv_tx_size(bsize)
            units = transform_blocks(bsize, plane, tx, self.mi_rows,
                                     self.mi_cols, r, c)
            for i, (x4, y4, x, y) in enumerate(units):
                self._coeffs(b, plane, i, x4, y4, x, y, tx)

    def _delta(self, d: int) -> None:
        a = abs(d)
        self.ec.symbol(self.cdf["delta_q"], min(a, 3), 4)
        if a >= 3:
            n = (a - 1).bit_length() - 1
            self.ec.literal(3, n - 1)
            self.ec.literal(n, a - (1 << n) - 1)
        if a:
            self.ec.bit(int(d < 0))

    def _tx_size(self, b: Block) -> None:
        bsize, r, c = b.bsize, b.r, b.c
        max_rect = int(table("max_txsize_rect_lookup")[bsize])
        if self.tx_select and bsize > 0:
            def side(rr, cc, wide):
                if not self.inside(rr, cc):
                    return 0
                return 1 << (TX_WLOG2 if wide else TX_HLOG2)[
                    self.tx_size[rr, cc]]
            ctx = int(side(r - 1, c, True) >= 1 << TX_WLOG2[max_rect]) + \
                int(side(r, c - 1, False) >= 1 << TX_HLOG2[max_rect])
            depth_max = av1.MAX_TX_DEPTH[bsize]
            depth, tx = 0, max_rect
            while tx != b.tx:
                tx = av1.SPLIT_TX[tx]
                depth += 1
            self.ec.symbol(self.cdf["tx_size"][depth_max - 1][ctx], depth,
                           3 if depth_max > 1 else 2)

    def contexts(self, b: Block, plane: int, x4: int, y4: int,
                 tx: int) -> tuple[int, int]:
        """(skip context, DC sign context) of a transform block, as
        `av1._read_coeffs` derives them."""
        lw, lh = TX_WLOG2[tx], TX_HLOG2[tx]
        w4, h4 = 1 << (lw - 2), 1 << (lh - 2)
        a = self.above[plane]
        lctx = self.left[plane]
        lbase = y4 & ((16 >> int(plane > 0)) - 1)
        near = [a[x4 + k] for k in range(w4)] + \
            [lctx[lbase + k] for k in range(h4)]
        dc_sign = sum(-1 if v >> 6 == 1 else 1 if v >> 6 == 2 else 0
                      for v in near)
        dc_sign_ctx = 1 if dc_sign < 0 else 2 if dc_sign > 0 else 0
        top = left = 0
        for k in range(w4):
            top |= a[x4 + k]
        for k in range(h4):
            left |= lctx[lbase + k]
        pbs = table("ss_size_lookup")[b.bsize][1][1] if plane else b.bsize
        if plane == 0:
            ctx = 0 if pbs == av1.tx_bsize(tx) else \
                av1.SKIP_CONTEXTS[min(top & 63, 4)][min(left & 63, 4)]
        else:
            ctx = (top != 0) + (left != 0)
            ctx += 10 if 16 * BW4[pbs] * BH4[pbs] > (1 << (lw + lh)) else 7
        return ctx, dc_sign_ctx

    def _coeffs(self, b: Block, plane: int, i: int, x4: int, y4: int,
                x: int, y: int, tx: int) -> None:
        """The mirror of `av1._read_coeffs` for a DCT_DCT block."""
        cdf, ec, tb = self.cdf, self.ec, table
        ptype = int(plane > 0)
        lw, lh = TX_WLOG2[tx], TX_HLOG2[tx]
        w4, h4 = 1 << (lw - 2), 1 << (lh - 2)
        cw, ch = min(1 << lw, 32), min(1 << lh, 32)
        bhl = min(lh, 5)
        txs_ctx = (TX_SQR[tx] + TX_SQR_UP[tx] + 1) >> 1
        s = int(plane > 0)
        max_x4 = ((self.mi_cols * 4) >> s) >> 2
        max_y4 = ((self.mi_rows * 4) >> s) >> 2
        a = self.above[plane]
        lctx = self.left[plane]
        lbase = y4 & ((16 >> s) - 1)
        ctx, dc_sign_ctx = self.contexts(b, plane, x4, y4, tx)
        q = self.source(b, plane, i, x4, y4, x, y, tx, ctx, dc_sign_ctx)
        so = tb("scan_offset")[tx][0]
        scan = [int(v) for v in tb("scan_data")[so:so + cw * ch]]
        eob = 0
        if q is not None:
            for k in range(cw * ch - 1, -1, -1):
                if q[scan[k]]:
                    eob = k + 1
                    break
        ec.symbol(cdf["txb_skip"][txs_ctx][ctx], int(eob == 0), 2)
        cul = 0
        if eob:
            if plane == 0:
                tx_set = av1._tx_set_type(tx, 0)
                if tx_set > 0:
                    eset = 1 if tx_set == 3 else 2
                    sym = list(tb("ext_tx_inv")[tx_set]).index(av1.DCT_DCT)
                    ec.symbol(cdf["intra_ext_tx"][eset][TX_SQR[tx]]
                              [b.y_mode], sym, av1.NUM_EXT_TX_SET[tx_set])
            nz_off = tb("nz_map_ctx_data")[
                tb("nz_map_ctx_start")[tx]:][:cw * ch]
            ems = av1.EOB_MULTI_SIZE[tx]
            starts = [int(v) for v in tb("eob_group_start")]
            eob_pt = max(k for k in range(1, 12) if starts[k] <= eob)
            ec.symbol(cdf[f"eob{16 << ems}"][ptype][0], eob_pt - 1, 5 + ems)
            bits = int(tb("eob_offset_bits")[eob_pt])
            extra = eob - starts[eob_pt]
            if bits > 0:
                ec.symbol(cdf["eob_extra"][txs_ctx][ptype][eob_pt - 3],
                          (extra >> (bits - 1)) & 1, 2)
                for k in range(1, bits):
                    ec.bit((extra >> (bits - 1 - k)) & 1)
            stride = (1 << bhl) + 4
            levels = [0] * ((32 + 4) * (32 + 4) + 64)
            for ci in range(eob - 1, -1, -1):
                pos = scan[ci]
                col = pos >> bhl
                row = pos - (col << bhl)
                li = col * stride + row
                level = abs(q[pos])
                if ci == eob - 1:
                    area = cw << bhl
                    cctx = 0 if ci == 0 else 1 if ci <= area // 8 else 2 \
                        if ci <= area // 4 else 3
                    ec.symbol(cdf["coeff_base_eob"][txs_ctx][ptype][cctx],
                              min(level, 3) - 1, 3)
                else:
                    mag = sum(min(levels[li + o], 3) for o in (
                        stride, 1, stride + 1, 2 * stride, 2))
                    m = min((mag + 1) >> 1, 4)
                    cctx = 0 if pos == 0 else m + int(nz_off[pos])
                    ec.symbol(cdf["coeff_base"][txs_ctx][ptype][cctx],
                              min(level, 3), 4)
                if level > 2:
                    mag = levels[li + 1] + levels[li + stride] + \
                        levels[li + stride + 1]
                    mag = min((mag + 1) >> 1, 6)
                    if ci == eob - 1:
                        mag = 0
                    bctx = mag if pos == 0 else mag + 7 \
                        if row < 2 and col < 2 else mag + 14
                    bcdf = cdf["coeff_br"][min(txs_ctx, 3)][ptype][bctx]
                    rest = level - 3
                    for _ in range(4):
                        k = min(rest, 3)
                        ec.symbol(bcdf, k, 4)
                        rest -= k
                        if k < 3:
                            break
                levels[li] = min(level, 15)
            for ci in range(eob):
                pos = scan[ci]
                level = abs(q[pos])
                if not level:
                    continue
                sign = int(q[pos] < 0)
                if ci == 0:
                    ec.symbol(cdf["dc_sign"][ptype][dc_sign_ctx], sign, 2)
                else:
                    ec.bit(sign)
                if level >= 15:
                    x_ = level - 14
                    n = x_.bit_length()
                    for _ in range(n - 1):
                        ec.bit(0)
                    ec.bit(1)
                    for k in range(n - 2, -1, -1):
                        ec.bit((x_ >> k) & 1)
                cul += level
            cul = min(cul, 63)
            if q[0] < 0:
                cul |= 1 << 6
            elif q[0] > 0:
                cul += 2 << 6
        for k in range(w4):
            a[x4 + k] = cul if x4 + k < max_x4 else 0
        for k in range(h4):
            lctx[lbase + k] = cul if y4 + k < max_y4 else 0


# --- tiles -------------------------------------------------------------------


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def superblocks(width: int, height: int) -> tuple[int, int]:
    """(columns, rows) of 64x64 superblocks over the frame's mode-info
    grid (its sides rounded up to 8)."""
    mi_cols, mi_rows = 2 * ((width + 7) >> 3), 2 * ((height + 7) >> 3)
    return (mi_cols + 15) >> 4, (mi_rows + 15) >> 4


def tile_cols_log2(width: int) -> int:
    """log2 of the tile columns libaom writes: a column past 4096 pixels
    splits, and libaom counts one superblock column more than the frame
    has (64 columns already take two tiles, 128 four)."""
    return _tile_log2(64, superblocks(width, 8)[0] + 1)


def tile_rows_log2(width: int, height: int) -> int:
    """log2 of the tile rows: what the largest tile area (4096 x 2304)
    asks for beyond the columns."""
    sb_cols, sb_rows = superblocks(width, height)
    need = _tile_log2((4096 * 2304) >> 12, sb_cols * sb_rows)
    return max(need - tile_cols_log2(width), 0)


def tile_ranges(width: int, height: int) -> tuple[list, list]:
    """The tiles' (start, end) in mode-info units: columns, then rows
    (uniform spacing)."""
    mi_cols, mi_rows = 2 * ((width + 7) >> 3), 2 * ((height + 7) >> 3)
    sb_cols, sb_rows = superblocks(width, height)
    out = []
    for n, mi, log2 in ((sb_cols, mi_cols, tile_cols_log2(width)),
                        (sb_rows, mi_rows, tile_rows_log2(width, height))):
        step = ((n + (1 << log2) - 1) >> log2) * 16
        starts = list(range(0, mi, step)) + [mi]
        out.append([(a, b) for a, b in zip(starts, starts[1:])])
    return out[0], out[1]


def write_tiles(width: int, height: int, blocks: list[Block],
                delta_q: bool, tx_select: bool, source=None,
                decide=None, on_row=None) -> list[bytes]:
    """Each tile's bytes (columns within rows) from the frame's blocks in
    coding order, each carrying its superblock's qindex (`Block.q`);
    `source` and `decide` as `TileWriter` takes them; `on_row(writer)`,
    where given, is called as each tile's superblock row starts."""
    cols, rows = tile_ranges(width, height)
    by_sb: dict = {}
    for b in blocks:
        by_sb.setdefault((b.r >> 4, b.c >> 4), []).append(b)
    tiles = []
    for rr in rows:
        for cc in cols:
            w = TileWriter(width, height, rr, cc, delta_q, tx_select,
                           source, decide)
            for r in range(rr[0], rr[1], 16):
                w.start_row()
                if on_row is not None:
                    on_row(w)
                for c in range(cc[0], cc[1], 16):
                    sb = by_sb[(r >> 4, c >> 4)]
                    w.superblock(r, c, sb[0].q, sb)
            tiles.append(w.ec.done())
    return tiles


# --- the superblock's qindex: libaom's variance boost ------------------------


def _q_of(qindex: int) -> float:
    """libaom's av1_convert_qindex_to_q at 8 bits."""
    return int(table("ac_qlookup")[qindex]) / 4.0


def _qindex_of(q: float) -> int:
    """libaom's av1_convert_q_to_qindex: the first qindex at or above q."""
    for qindex in range(255):
        if _q_of(qindex) >= q:
            return qindex
    return 255


def boost_variance(y: np.ndarray, r: int, c: int) -> int:
    """libaom's av1_get_variance_boost_block_variance on the superblock
    at luma (r, c) of `y` (padded by replication past the frame): the
    per-pixel variances of its 64 8x8 blocks, sorted, at the octiles
    around the fifth weighed 1:2:1."""
    b = y[r:r + 64, c:c + 64].astype(np.int64).reshape(8, 8, 8, 8)
    s = b.sum(axis=(1, 3))
    sse = (b * b).sum(axis=(1, 3))
    v = np.sort(((sse - ((s * s) >> 6)) >> 6).reshape(-1))
    return int((v[31] + 2 * v[39] + v[47] + 2) >> 2)


def sb_qindex(y: np.ndarray, r: int, c: int, base_q: int = BASE_Q) -> int:
    """The superblock's qindex: libaom's av1_get_sbq_variance_boost
    (strength 3, the still-picture curve: qstep ratio 0.45 (10 -
    log2(variance)) + 1 within [1, 8]) rounded to the delta q step of 4
    from the base qindex (av1_adjust_q_from_delta_q_res, deadzone 1)."""
    var = boost_variance(y, r, c) or 1
    ratio = (min(6.0, 100 / 100.0 * 3.0) * 0.15) * (10.0 - math.log2(var)) \
        + 1.0
    ratio = 1.0 if 1.0 > ratio else min(8.0, ratio)
    target = _qindex_of(_q_of(base_q) / ratio)
    boost = min(math.floor((base_q + 544.0) * (base_q - target) / 1279.0
                           + 0.5), 80)
    q = max(base_q - boost, 1)
    q = min(max(q, 4), 252)
    step = (abs(q - base_q) + 1) & ~3
    return max(base_q + (step if q >= base_q else -step), 1)


# --- the partition: libaom's variance-based partitioning of key frames -------


class _Var:
    __slots__ = ("sse", "sum", "log2_count")

    def __init__(self, sse: int, s: int, log2_count: int):
        self.sse, self.sum, self.log2_count = sse, s, log2_count


def _sum2(a: _Var, b: _Var) -> _Var:
    return _Var(a.sse + b.sse, a.sum + b.sum, a.log2_count + 1)


def _variance(v: _Var) -> int:
    return (256 * (v.sse - ((v.sum * v.sum) >> v.log2_count))) \
        >> v.log2_count


def _node(split) -> tuple:
    """(none, (horz0, horz1), (vert0, vert1)) of a node from its four
    quarters' `none` (libaom's fill_variance_tree)."""
    h = (_sum2(split[0], split[1]), _sum2(split[2], split[3]))
    v = (_sum2(split[0], split[2]), _sum2(split[1], split[3]))
    return _sum2(v[0], v[1]), h, v


def vbp_thresholds(qindex: int, width: int, height: int) -> list:
    """libaom's set_vbp_thresholds for a key frame at the superblock's
    qindex (all-intra, large intra partitions forced): the thresholds of
    64x64, 64x64, 32x32 and 16x16 blocks, the last two halved from 720p
    up."""
    base = 120 * int(table("ac_qlookup")[qindex])
    if width * height < 1280 * 720:
        return [base, base, base // 3, base >> 1]
    return [base, base, base >> 1, base >> 1]


def partition(y: np.ndarray, mi_r: int, mi_c: int, mi_rows: int,
              mi_cols: int, tile_end: tuple, thresholds: list) -> list:
    """(mi_row, mi_col, bsize) of the blocks of the superblock at
    (mi_r, mi_c), as libaom's av1_choose_var_based_partitioning picks
    them in a key frame: variances of 4x4 means (less 128) summed up the
    tree; a 16x16 over its threshold forces its parents to split and
    itself to split or not by the spread of its 8x8 variances; a 32x32
    over its threshold splits; 64x64 always splits; a block under its
    threshold that fits (half and one more 4x4 past the frame's edge)
    stays whole, else its vertical or horizontal halves if both are under;
    8x8 is the least. `tile_end` is the tile's (mi_row_end, mi_col_end)."""
    pw, ph = (mi_cols - mi_c) * 4, (mi_rows - mi_r) * 4
    r0, c0 = mi_r * 4, mi_c * 4
    blk = y[r0:r0 + 64, c0:c0 + 64].astype(np.int64)
    means = ((blk.reshape(16, 4, 16, 4).sum(axis=(1, 3)) + 8) >> 4) - 128
    rows4, cols4 = np.arange(16)[:, None] * 4, np.arange(16)[None, :] * 4
    means = np.where((rows4 < ph) & (cols4 < pw), means, 0)
    nodes = {}
    for y8 in range(8):
        for x8 in range(8):
            quarters = [_Var(int(means[2 * y8 + i, 2 * x8 + j]) ** 2,
                             int(means[2 * y8 + i, 2 * x8 + j]), 0)
                        for i in range(2) for j in range(2)]
            nodes[(8, y8, x8)] = _node(quarters)
    for size in (16, 32):
        for yy in range(64 // size):
            for xx in range(64 // size):
                nodes[(size, yy, xx)] = _node([
                    nodes[(size // 2, 2 * yy + i, 2 * xx + j)][0]
                    for i in range(2) for j in range(2)])
    row_end, col_end = tile_end
    out = []

    def put(r, c, bsize):
        if r < mi_rows and c < mi_cols:
            out.append((r, c, bsize))

    def try_block(size, yy, xx, thr, force):
        none, horz, vert = nodes[(size, yy, xx)]
        w4 = size // 4
        r, c = mi_r + yy * w4, mi_c + xx * w4
        check_w = check_h = w4
        vert_w = horz_h = w4 >> 1
        if col_end == mi_cols:
            check_w, vert_w = (w4 >> 1) + 1, (w4 >> 2) + 1
        if row_end == mi_rows:
            check_h, horz_h = (w4 >> 1) + 1, (w4 >> 2) + 1
        fits = c + check_w <= col_end and r + check_h <= row_end
        if force == "none" and fits:
            put(r, c, av1.bsize_of(w4, w4))
            return True
        if force == "split":
            return False
        v = _variance(none)
        if v > thr << 4:
            return False
        if fits and v < thr:
            put(r, c, av1.bsize_of(w4, w4))
            return True
        if r + check_h <= row_end and c + vert_w <= col_end and \
                _variance(vert[0]) < thr and _variance(vert[1]) < thr:
            put(r, c, av1.bsize_of(w4 >> 1, w4))
            put(r, c + w4 // 2, av1.bsize_of(w4 >> 1, w4))
            return True
        if c + check_w <= col_end and r + horz_h <= row_end and \
                _variance(horz[0]) < thr and _variance(horz[1]) < thr:
            put(r, c, av1.bsize_of(w4, w4 >> 1))
            put(r + w4 // 2, c, av1.bsize_of(w4, w4 >> 1))
            return True
        return False

    force16 = {k: "all" for k in np.ndindex(4, 4)}
    force32 = {k: "all" for k in np.ndindex(2, 2)}
    for yy, xx in np.ndindex(4, 4):
        if _variance(nodes[(16, yy, xx)][0]) > thresholds[3]:
            v8 = [_variance(nodes[(8, 2 * yy + i, 2 * xx + j)][0])
                  for i in range(2) for j in range(2)]
            force16[(yy, xx)] = "split" if max(v8) - min(v8) > \
                thresholds[3] << 2 else "none"
            force32[(yy // 2, xx // 2)] = "split"
    for yy, xx in np.ndindex(2, 2):
        if force32[(yy, xx)] == "all" and \
                _variance(nodes[(32, yy, xx)][0]) > thresholds[2]:
            force32[(yy, xx)] = "split"
    for yy, xx in np.ndindex(2, 2):
        if try_block(32, yy, xx, thresholds[2], force32[(yy, xx)]):
            continue
        for i, j in np.ndindex(2, 2):
            y16, x16 = 2 * yy + i, 2 * xx + j
            if try_block(16, y16, x16, thresholds[3], force16[(y16, x16)]):
                continue
            for a, b in np.ndindex(2, 2):
                put(mi_r + 4 * y16 + 2 * a, mi_c + 4 * x16 + 2 * b,
                    BLOCK_8X8)
    return sorted(out)


# --- prediction --------------------------------------------------------------


def predict(rec: np.ndarray, x: int, y: int, w: int, h: int, mode: int,
            have_left: bool, have_above: bool, max_x: int,
            max_y: int) -> None:
    """DC, V, H or SMOOTH prediction of a w x h block at (x, y) of a
    reconstructed plane, into it, from its edges as AV1 takes them (the
    row above clipped at `max_x`, the column left at `max_y`; 127 above
    and 129 left where neither is there)."""
    if have_above:
        above = [int(rec[y - 1, min(x + i, max_x)]) for i in range(w)]
    elif have_left:
        above = [int(rec[y, x - 1])] * w
    else:
        above = [127] * w
    if have_left:
        left = [int(rec[min(y + i, max_y), x - 1]) for i in range(h)]
    elif have_above:
        left = [int(rec[y - 1, x])] * h
    else:
        left = [129] * h
    if mode == V_PRED:
        rec[y:y + h, x:x + w] = np.array(above)[None, :]
    elif mode == H_PRED:
        rec[y:y + h, x:x + w] = np.array(left)[:, None]
    else:
        rec[y:y + h, x:x + w] = av1.nondir_predict(
            above + [0], left + [0], w, h, mode, have_left, have_above)


# --- the intra mode: libaom's av1_nonrd_pick_intra_mode ----------------------


def _hadamard_col8(x: np.ndarray) -> np.ndarray:
    """libaom's hadamard_col8 along the first axis."""
    b = [x[0] + x[1], x[0] - x[1], x[2] + x[3], x[2] - x[3],
         x[4] + x[5], x[4] - x[5], x[6] + x[7], x[6] - x[7]]
    c = [b[0] + b[2], b[1] + b[3], b[0] - b[2], b[1] - b[3],
         b[4] + b[6], b[5] + b[7], b[4] - b[6], b[5] - b[7]]
    out = [None] * 8
    out[0], out[7], out[3], out[4] = c[0] + c[4], c[1] + c[5], \
        c[2] + c[6], c[3] + c[7]
    out[2], out[6], out[1], out[5] = c[0] - c[4], c[1] - c[5], \
        c[2] - c[6], c[3] - c[7]
    return np.stack(out)


def hadamard_8x8(diff: np.ndarray) -> np.ndarray:
    """libaom's aom_hadamard_lp_8x8_c: 64 coefficients."""
    d = diff.astype(np.int64)
    tmp = _hadamard_col8(d)          # tmp[k, col]: column col's output k
    return _hadamard_col8(tmp.T).reshape(-1)


def hadamard_16x16(diff: np.ndarray) -> np.ndarray:
    """libaom's aom_hadamard_lp_16x16_c: the four 8x8 blocks, then a
    halved Hadamard across them."""
    q = [hadamard_8x8(diff[8 * (i >> 1):8 * (i >> 1) + 8,
                           8 * (i & 1):8 * (i & 1) + 8]) for i in range(4)]
    b0, b1 = (q[0] + q[1]) >> 1, (q[0] - q[1]) >> 1
    b2, b3 = (q[2] + q[3]) >> 1, (q[2] - q[3]) >> 1
    return np.concatenate([b0 + b2, b1 + b3, b0 - b2, b1 - b3])


def quantize_lp(coeff: np.ndarray, scan, qindex: int) -> tuple:
    """libaom's av1_quantize_lp_c at a luma qindex (no matrices):
    (quantized, dequantized, eob)."""
    P = [quantizer(qindex, 0, True), quantizer(qindex, 0, False)]
    ac = np.ones(len(coeff), bool)
    ac[0] = False
    rnd = np.where(ac, P[1][2], P[0][2])
    quant = np.where(ac, P[1][1], P[0][1])
    deq = np.where(ac, P[1][0], P[0][0])
    a = np.minimum(np.abs(coeff) + rnd, 32767)
    t = (a * quant) >> 16
    q = np.where(coeff < 0, -t, t)
    nz = np.nonzero(t[np.asarray(scan)])[0]
    return q, q * deq, int(nz[-1]) + 1 if len(nz) else 0


def block_yrd(src: np.ndarray, pred: np.ndarray, tx_n: int,
              qindex: int) -> tuple:
    """libaom's av1_block_yrd on one transform block's region: Hadamard
    transforms of tx_n (8 or 16) over it, the lp quantizer (its eob in
    the 8x8 DCT's scan, or the 16x16 Hadamard's own); (rate, dist,
    skippable) in libaom's units (rate: the sum of |levels| << 11 plus
    msb(eob + 1) << 9 a transform, dist: the Hadamard-domain error / 4)."""
    diff = src.astype(np.int64) - pred.astype(np.int64)
    if tx_n == 8:
        so = table("scan_offset")[1][0]
        scan = table("scan_data")[so:so + 64]
    else:  # the lp Hadamard's order (default_scan_lp_16x16_transpose)
        scan = table("scan_lp_16x16")
    rate = dist = eob_cost = 0
    skippable = 1
    h, w = diff.shape
    for r in range(0, h, tx_n):
        for c in range(0, w, tx_n):
            d = diff[r:r + tx_n, c:c + tx_n]
            coeff = hadamard_8x8(d) if tx_n == 8 else hadamard_16x16(d)
            q, dq, eob = quantize_lp(coeff, scan, qindex)
            skippable &= int(eob == 0)
            eob_cost += (eob + 1).bit_length() - 1
            if eob == 1:
                rate += abs(int(q[0]))
            elif eob > 1:
                rate += int(np.abs(q).sum())
            dist += int(((coeff - dq) ** 2).sum()) >> 2
    if skippable:
        return 0, dist, 1
    return (rate << 11) + (eob_cost << 9), dist, 0


# --- the trellis: libaom's av1_optimize_txb ----------------------------------


GOLOMB_BITS_COST = [0, 512, 1536, 1536] + [2560] * 4 + [3584] * 8 + \
    [4608] * 16
GOLOMB_COST_DIFF = [0, 512, 1024, 0, 1024, 0, 0, 0, 1024] + [0] * 7 + \
    [1024] + [0] * 15


def _golomb_cost(level: int) -> int:
    if level >= 15:
        r = level - 14
        return (2 * r.bit_length() - 1) << 9
    return 0


def _br_cost(level: int, lps: list) -> int:
    return lps[min(level - 3, 12)] + _golomb_cost(level)


def _eob_cost(eob: int, eob_costs: list, coeff: dict) -> int:
    starts = [int(v) for v in table("eob_group_start")]
    pt = max(k for k in range(1, 12) if starts[k] <= eob)
    extra = eob - starts[pt]
    cost = eob_costs[pt - 1]
    bits = int(table("eob_offset_bits")[pt])
    if bits > 0:
        cost += coeff["eob_extra"][pt - 3][(extra >> (bits - 1)) & 1]
        if bits > 1:
            cost += (bits - 1) << 9
    return cost


class _Trellis:
    """State of one transform block's `optimize_txb`."""

    def __init__(self, qcoeff, dqcoeff, tcoeff, bhl: int, width: int,
                 scan, nz_off, coeff: dict, dc_sign_ctx: int,
                 rdmult: int, shift: int, dqv, qmatrix):
        self.q, self.dq, self.t = qcoeff, dqcoeff, tcoeff
        self.bhl, self.width, self.scan, self.nz_off = bhl, width, scan, \
            nz_off
        self.c, self.dc_sign_ctx = coeff, dc_sign_ctx
        self.rdmult, self.shift, self.dqv, self.qm = rdmult, shift, dqv, \
            qmatrix
        self.stride = (1 << bhl) + 4
        self.levels = [0] * ((32 + 4) * (32 + 4) + 64)
        for pos, v in enumerate(qcoeff):
            if v:
                self.levels[self._at(pos)] = min(abs(v), 127)

    def _at(self, pos: int) -> int:
        col = pos >> self.bhl
        return col * self.stride + pos - (col << self.bhl)

    def rd(self, rate: int, dist: int) -> int:
        return rdcost(self.rdmult, rate, dist)

    def dist(self, t: int, d: int, pos: int) -> int:
        diff = (t - d) * (1 << self.shift) * int(self.qm[pos])
        return (diff * diff + (1 << 9)) >> 10

    def ctx_eob(self, si: int) -> int:
        area = self.width << self.bhl
        return 0 if si == 0 else 1 if si <= area // 8 else 2 \
            if si <= area // 4 else 3

    def ctx(self, pos: int) -> int:
        if pos == 0:
            return 0
        li, s, lv = self._at(pos), self.stride, self.levels
        mag = sum(min(lv[li + o], 3) for o in (s, 1, s + 1, 2 * s, 2))
        return min((mag + 1) >> 1, 4) + int(self.nz_off[pos])

    def br_ctx_eob(self, pos: int) -> int:
        col = pos >> self.bhl
        row = pos - (col << self.bhl)
        if pos == 0:
            return 0
        return 7 if row < 2 and col < 2 else 14

    def br_ctx(self, pos: int) -> int:
        col = pos >> self.bhl
        row = pos - (col << self.bhl)
        li, s, lv = self._at(pos), self.stride, self.levels
        mag = min((lv[li + 1] + lv[li + s] + lv[li + s + 1] + 1) >> 1, 6)
        if pos == 0:
            return mag
        return mag + 7 if row < 2 and col < 2 else mag + 14

    def cost_eob(self, pos: int, level: int, sign: int, ctx: int) -> int:
        cost = self.c["base_eob"][ctx][min(level, 3) - 1]
        cost += self.c["dc_sign"][self.dc_sign_ctx][sign] if pos == 0 \
            else 512
        if level > 2:
            cost += _br_cost(level, self.c["lps"][self.br_ctx_eob(pos)])
        return cost

    def cost_general(self, last: bool, pos: int, level: int, sign: int,
                     ctx: int) -> int:
        if last:
            cost = self.c["base_eob"][ctx][min(level, 3) - 1]
        else:
            cost = self.c["base"][ctx][min(level, 3)]
        if level:
            cost += self.c["dc_sign"][self.dc_sign_ctx][sign] if pos == 0 \
                else 512
            if level > 2:
                br = self.br_ctx_eob(pos) if last else self.br_ctx(pos)
                cost += _br_cost(level, self.c["lps"][br])
        return cost

    def lower(self, pos: int, level: int, sign: int) -> tuple[int, int]:
        low = level - 1
        dq = (low * self.dqv[pos]) >> self.shift
        return (-low if sign else low), (-dq if sign else dq)

    def set_level(self, pos: int, q: int, dq: int) -> None:
        self.q[pos], self.dq[pos] = q, dq
        self.levels[self._at(pos)] = min(abs(q), 127)


# The trellis's rdmult of each plane type (libaom's plane_rd_mult_chroma
# of intra blocks), over (8 - sharpness) / 128.
PLANE_RD_MULT = (17, 13)


def optimize_txb(qcoeff: list, dqcoeff: list, tcoeff, eob: int, tx: int,
                 plane: int, dc_sign_ctx: int, rdmult: int,
                 costs: CoeffCosts, dqv: list, qmatrix) -> int:
    """libaom's av1_optimize_txb at sharpness 7 on one DCT_DCT transform
    block of an intra frame (`qcoeff`, `dqcoeff` by position, changed in
    place; `tcoeff` the transform): from the last coefficient back, each
    level weighed against one less at the trellis rdmult (rdmult (8 -
    sharpness) 17/128 for luma, 13/128 for chroma) with the distortion
    weighed by `qmatrix`: within the last two coefficients, a level over
    2 may drop by one, or the end of block move up to one past 4; then
    a level over 1 may drop by one, and the DC likewise. `dqv` is each
    position's step with its inverse weight. The new eob."""
    lw, lh = TX_WLOG2[tx], TX_HLOG2[tx]
    width = min(1 << lw, 32)
    bhl = min(lh, 5)
    so = table("scan_offset")[tx][0]
    scan = [int(v) for v in table("scan_data")[so:so + (width << bhl)]]
    nz_off = table("nz_map_ctx_data")[table("nz_map_ctx_start")[tx]:]
    txs = (TX_SQR[tx] + TX_SQR_UP[tx] + 1) >> 1
    ptype = int(plane > 0)
    coeff = costs.coeff[(txs, ptype)]
    eob_costs = costs.eob[(av1.EOB_MULTI_SIZE[tx], ptype)]
    shift = int(width << bhl > 256) + int(width << bhl > 1024)
    trellis_rdmult = (rdmult * (8 - SHARPNESS) * PLANE_RD_MULT[ptype]
                      + 64) >> 7
    T = _Trellis(qcoeff, dqcoeff, tcoeff, bhl, width, scan, nz_off, coeff,
                 dc_sign_ctx, trellis_rdmult, shift, dqv, qmatrix)
    accu_rate = _eob_cost(eob, eob_costs, coeff)
    accu_dist = 0
    si = eob - 1
    pos = scan[si]
    level = abs(qcoeff[pos])
    sign = int(qcoeff[pos] < 0)
    nz = [pos]
    if level >= 2:
        accu_rate, accu_dist = _update_general(T, accu_rate, accu_dist, si,
                                               eob)
    else:
        accu_rate += T.cost_eob(pos, level, sign, T.ctx_eob(si))
        t = int(tcoeff[pos])
        accu_dist += T.dist(t, dqcoeff[pos], pos) - T.dist(t, 0, pos)
    si -= 1
    while si >= 0 and len(nz) <= 2:
        accu_rate, accu_dist, eob = _update_eob(
            T, accu_rate, accu_dist, eob, nz, si, eob_costs)
        si -= 1
    while si >= 1:
        _update_simple(T, si)
        si -= 1
    if si == 0:
        _update_general(T, 0, 0, 0, eob)
    return eob


def _update_general(T: _Trellis, accu_rate: int, accu_dist: int, si: int,
                    eob: int) -> tuple[int, int]:
    pos = T.scan[si]
    qc = T.q[pos]
    last = si == eob - 1
    ctx = T.ctx_eob(si) if last else T.ctx(pos)
    if qc == 0:
        return accu_rate + T.c["base"][ctx][0], accu_dist
    sign, level = int(qc < 0), abs(qc)
    t = int(T.t[pos])
    dist = T.dist(t, T.dq[pos], pos)
    dist0 = T.dist(t, 0, pos)
    rate = T.cost_general(last, pos, level, sign, ctx)
    rd = T.rd(rate, dist)
    if level == 1:
        q_low = dq_low = 0
        dist_low = dist0
        rate_low = T.c["base"][ctx][0]
    else:
        q_low, dq_low = T.lower(pos, level, sign)
        dist_low = T.dist(t, dq_low, pos)
        rate_low = T.cost_general(last, pos, level - 1, sign, ctx)
    if T.rd(rate_low, dist_low) < rd:
        T.set_level(pos, q_low, dq_low)
        return accu_rate + rate_low, accu_dist + dist_low - dist0
    return accu_rate + rate, accu_dist + dist - dist0


def _update_eob(T: _Trellis, accu_rate: int, accu_dist: int, eob: int,
                nz: list, si: int, eob_costs: list) -> tuple:
    pos = T.scan[si]
    qc = T.q[pos]
    ctx = T.ctx(pos)
    if qc == 0:
        return accu_rate + T.c["base"][ctx][0], accu_dist, eob
    lower = False
    level, sign = abs(qc), int(qc < 0)
    t = int(T.t[pos])
    dist0 = T.dist(t, 0, pos)
    dist = T.dist(t, T.dq[pos], pos) - dist0
    rate = T.cost_general(False, pos, level, sign, ctx)
    rd = T.rd(accu_rate + rate, accu_dist + dist)
    if level == 1:
        q_low = dq_low = 0
        dist_low = 0
        rate_low = T.c["base"][ctx][0]
        rd_low = T.rd(accu_rate + rate_low, accu_dist)
    else:
        q_low, dq_low = T.lower(pos, level, sign)
        dist_low = T.dist(t, dq_low, pos) - dist0
        rate_low = T.cost_general(False, pos, level - 1, sign, ctx)
        rd_low = T.rd(accu_rate + rate_low, accu_dist + dist_low)
    lower_new_eob = False
    new_eob = si + 1
    ctx_new = T.ctx_eob(si)
    new_eob_cost = _eob_cost(new_eob, eob_costs, T.c)
    rate_eob = new_eob_cost + T.cost_eob(pos, level, sign, ctx_new)
    dist_eob = dist
    rd_eob = T.rd(rate_eob, dist_eob)
    if level - 1 > 0:
        rate_eob_low = new_eob_cost + T.cost_eob(pos, level - 1, sign,
                                                 ctx_new)
        rd_eob_low = T.rd(rate_eob_low, dist_low)
        if rd_eob_low < rd_eob:
            lower_new_eob = True
            rd_eob, rate_eob, dist_eob = rd_eob_low, rate_eob_low, dist_low
    if (level > 2 or (level == 2 and si > 5)) and rd_low < rd:
        lower = True
        rd, rate, dist = rd_low, rate_low, dist_low
    if new_eob > 4 and rd_eob < rd:
        for p in nz:
            T.set_level(p, 0, 0)
        eob = new_eob
        nz.clear()
        accu_rate, accu_dist = rate_eob, dist_eob
        lower = lower_new_eob
    else:
        accu_rate += rate
        accu_dist += dist
    if lower:
        T.set_level(pos, q_low, dq_low)
    if T.q[pos]:
        nz.append(pos)
    return accu_rate, accu_dist, eob


def _update_simple(T: _Trellis, si: int) -> None:
    pos = T.scan[si]
    qc = T.q[pos]
    if qc == 0:
        return
    ctx = T.ctx(pos)
    level = abs(qc)
    t, dq = abs(int(T.t[pos])), abs(T.dq[pos])
    if dq < t or level == 1:
        return
    base = T.c["base"][ctx]
    cost = base[min(level, 3)] + 512
    diff = base[level + 4] if level <= 3 else 0
    if level > 2:
        lps = T.c["lps"][T.br_ctx(pos)]
        r = min(level - 3, 12)
        if level <= 15:
            diff += lps[r + 13]
        golomb = 0
        if level >= 15:
            g = level - 14
            golomb = GOLOMB_BITS_COST[g] if g < 32 else _golomb_cost(level)
            diff += GOLOMB_COST_DIFF[g] if g < 32 else \
                (1024 if g & (g - 1) == 0 else 0)
        cost += lps[r] + golomb
    rate, rate_low = cost, cost - diff
    dist = T.dist(t, dq, pos)
    low = level - 1
    dq_low = (low * T.dqv[pos]) >> T.shift
    dist_low = T.dist(t, dq_low, pos)
    if T.rd(rate_low, dist_low) < T.rd(rate, dist):
        sign = int(qc < 0)
        T.set_level(pos, -low if sign else low, -dq_low if sign else dq_low)


# --- the encoder -------------------------------------------------------------


def padded(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """A plane extended by replication to h x w (libaom's border)."""
    ph, pw = plane.shape
    return np.pad(plane, ((0, h - ph), (0, w - pw)), mode="edge")


class Encoder:
    """One frame's encoding state: the source planes (padded), the
    reconstruction, the rate tables of the frame's first CDFs and the
    SSIM rdmult factors. `decide` and `levels` are `TileWriter`'s
    `decide` and `source`."""

    def __init__(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        self.h, self.w = y.shape
        sb_cols, sb_rows = superblocks(self.w, self.h)
        H, W = 64 * sb_rows + 64, 64 * sb_cols + 64
        self.src = [padded(y, H, W).astype(np.int64),
                    padded(u, H // 2, W // 2).astype(np.int64),
                    padded(v, H // 2, W // 2).astype(np.int64)]
        self.rec = [np.zeros((H, W), np.int64),
                    np.zeros((H // 2, W // 2), np.int64),
                    np.zeros((H // 2, W // 2), np.int64)]
        self.mi_cols = 2 * ((self.w + 7) >> 3)
        self.mi_rows = 2 * ((self.h + 7) >> 3)
        cdf = av1.init_cdfs(BASE_Q)
        self.coeff_costs = CoeffCosts(cdf)
        self.mode_costs = ModeCosts(cdf)
        self.factors = ssim_factors(self.src[0], self.w, self.h)
        self.base_rdmult = rd_mult(BASE_Q)
        # From 4K up, libaom refreshes its rates at each superblock row of
        # a tile (INTERNAL_COST_UPD_SBROW); below it never does.
        self.cost_upd_sbrow = min(self.w, self.h) >= 2160

    def on_row(self, wr: TileWriter) -> None:
        """A tile's superblock row starts: from 4K up, the rates anew
        from the tile's CDFs as they stand."""
        if self.cost_upd_sbrow:
            self.coeff_costs = CoeffCosts(wr.cdf)
            self.mode_costs = ModeCosts(wr.cdf)

    def blocks(self) -> tuple[list[Block], bool, bool]:
        """The frame's blocks in coding order with their superblocks'
        qindex (modes not yet picked), and the header's delta q and
        TX_MODE_SELECT flags."""
        cols, rows = tile_ranges(self.w, self.h)
        out, qs = [], []
        for r0, r1 in rows:
            for c0, c1 in cols:
                for r in range(r0, r1, 16):
                    for c in range(c0, c1, 16):
                        q = sb_qindex(self.src[0], 4 * r, 4 * c)
                        qs.append(q)
                        thr = vbp_thresholds(q, self.w, self.h)
                        for br, bc, bs in partition(
                                self.src[0], r, c, self.mi_rows,
                                self.mi_cols, (r1, c1), thr):
                            out.append(Block(br, bc, bs, tx=SQUARE_TX[bs],
                                             q=q))
        delta_q = any(q != BASE_Q for q in qs)
        tx_select = any(BW4[b.bsize] != BH4[b.bsize] for b in out)
        return out, delta_q, tx_select

    def estimate(self, b: Block, avail_u: bool, avail_l: bool, mode: int,
                 sad_state: dict | None) -> tuple | None:
        """libaom's av1_estimate_block_intra over the block's luma: each
        square transform block predicted in turn (the next from this
        prediction, not from a reconstruction), then `block_yrd` at up
        to 16x16; (rate, dist, skippable of the last transform block),
        or None where the SAD prune drops the mode (`sad_state`, a block
        of one transform: its prediction's SAD past the best so far by a
        sixteenth)."""
        n = 4 << b.tx
        r0, c0 = b.r * 4, b.c * 4
        bw, bh = 4 * BW4[b.bsize], 4 * BH4[b.bsize]
        rec = self.rec[0]
        saved = rec[r0:r0 + bh, c0:c0 + bw].copy()
        rate = dist = 0
        skippable = 1
        try:
            for yy in range(0, bh, n):
                for xx in range(0, bw, n):
                    x0, y0 = c0 + xx, r0 + yy
                    if x0 >= self.mi_cols * 4 or y0 >= self.mi_rows * 4:
                        continue
                    predict(rec, x0, y0, n, n, mode, avail_l or xx > 0,
                            avail_u or yy > 0, self.mi_cols * 4 - 1,
                            self.mi_rows * 4 - 1)
                    src = self.src[0][y0:y0 + n, x0:x0 + n]
                    pred = rec[y0:y0 + n, x0:x0 + n]
                    if sad_state is not None:
                        sad = int(np.abs(src - pred).sum())
                        best = sad_state["sad"]
                        if best is not None and sad > best + (best >> 4):
                            return None
                        if best is None or sad < best:
                            sad_state["sad"] = sad
                    rr, dd, skippable = block_yrd(src, pred, min(n, 16), b.q)
                    rate, dist = rate + rr, dist + dd
        finally:
            rec[r0:r0 + bh, c0:c0 + bw] = saved
        return rate, dist, skippable

    def decide(self, b: Block, wr: TileWriter) -> None:
        """libaom's av1_nonrd_pick_intra_mode in an all-intra key frame:
        DC, V, H and SMOOTH in turn, each estimated (`estimate`) unless
        pruned: only DC at the frame's first block from 16x16 up where the
        source is flat; H after V has won; where both neighbours are there
        and neither uses the mode, V and H where the block's source
        variance is at most 50 and SMOOTH while DC leads; by SAD where the
        block is one transform. Each mode's rate (its estimate, or the
        skip flag's cost where the block is skippable, with the mode's
        cost in its neighbours' context) and distortion weighed at the
        block's rdmult; the first of the least cost."""
        avail_u, avail_l = wr.inside(b.r - 1, b.c), wr.inside(b.r, b.c - 1)
        b.avail = (avail_u, avail_l)
        above = int(wr.y_mode[b.r - 1, b.c]) if avail_u else DC_PRED
        left = int(wr.y_mode[b.r, b.c - 1]) if avail_l else DC_PRED
        ctx = av1.INTRA_MODE_CTX
        mode_costs = self.mode_costs.kf_y[ctx[above]][ctx[left]]
        skip = self.mode_costs.skip
        bw, bh = 4 * BW4[b.bsize], 4 * BH4[b.bsize]
        variance = source_variance(self.src[0], b.r * 4, b.c * 4, bw, bh)
        b.rdmult = block_rdmult(self.factors, b.bsize, b.r, b.c,
                                self.base_rdmult)
        sad_state = {"sad": None} if av1.tx_bsize(b.tx) == b.bsize else None
        best, best_mode = None, DC_PRED
        for mode in (DC_PRED, V_PRED, H_PRED, SMOOTH_PRED):
            if mode != DC_PRED and b.bsize > 8 and not (
                    variance | b.r | b.c):
                continue
            if mode == H_PRED and best_mode == V_PRED:
                continue
            if mode != DC_PRED and avail_u and avail_l and \
                    mode != above and mode != left:
                if mode in (V_PRED, H_PRED) and variance <= 50:
                    continue
                if mode == SMOOTH_PRED and best_mode == DC_PRED:
                    continue
            est = self.estimate(b, avail_u, avail_l, mode, sad_state)
            if est is None:
                continue
            rate, dist, skippable = est
            rate = skip[1] if skippable else rate + skip[0]
            cost = rdcost(b.rdmult, rate + mode_costs[mode], dist)
            if best is None or cost < best:
                best, best_mode = cost, mode
        b.y_mode = best_mode

    def levels(self, b: Block, plane: int, i: int, x4: int, y4: int,
               x: int, y: int, tx: int, skip_ctx: int,
               dc_sign_ctx: int) -> list | None:
        """One transform block: predicted from the reconstruction, its
        residual transformed, quantized and trellised, then added back;
        its levels by position, or None where all are zero."""
        w, h = 1 << TX_WLOG2[tx], 1 << TX_HLOG2[tx]
        s = int(plane > 0)
        px, py = 4 * x4, 4 * y4
        rec = self.rec[plane]
        mode = b.y_mode if plane == 0 else DC_PRED
        avail_u, avail_l = b.avail
        predict(rec, px, py, w, h, mode, avail_l or x > 0, avail_u or y > 0,
                ((self.mi_cols * 4) >> s) - 1, ((self.mi_rows * 4) >> s) - 1)
        resid = self.src[plane][py:py + h, px:px + w] - \
            rec[py:py + h, px:px + w]
        coeff = fwd_txfm2d(resid, tx)
        so = table("scan_offset")[tx][0]
        scan = table("scan_data")[so:so + w * h]
        qm, iqm = qm_weights(tx, plane)
        q, dq, eob = quantize_fp(coeff, scan, b.q, plane, qm, iqm,
                                 int(w * h > 256))
        if eob:
            eob = optimize_txb(q, dq, coeff, eob, tx, plane, dc_sign_ctx,
                               b.rdmult, self.coeff_costs,
                               dequant_steps(b.q, plane, iqm), qm)
        if not eob:
            return None
        av1.inverse_transform_add(dq, tx, av1.DCT_DCT,
                                  rec[py:py + h, px:px + w])
        return q


def encode_tiles(y: np.ndarray, u: np.ndarray,
                 v: np.ndarray) -> tuple[list[bytes], bool, bool]:
    """The tiles of cv2's default AVIF frame of the planes (Y of H x W,
    U and V of (H+1)/2 x (W+1)/2), and the header's delta q and
    TX_MODE_SELECT flags."""
    enc = Encoder(y, u, v)
    blocks, delta_q, tx_select = enc.blocks()
    tiles = write_tiles(enc.w, enc.h, blocks, delta_q, tx_select,
                        enc.levels, enc.decide, enc.on_row)
    return tiles, delta_q, tx_select


# --- decisions read back from a stream ---------------------------------------


def blocks_of(record: list) -> list[Block]:
    """The blocks of a `av1.decode_planes_plain` record of cv2's default
    kind (DCT_DCT everywhere, chroma DC, no angle deltas), in coding
    order, each with its qindex."""
    out = []
    for d in record:
        if any(d["angles"]) or d["uv_mode"] != DC_PRED or any(
                t is not None and t[0] != av1.DCT_DCT
                for p in d["coeffs"] for t in p):
            raise ValueError("AV1: a block outside the encoder's tools")
        out.append(Block(d["r"], d["c"], d["bsize"], d["y_mode"], d["tx"],
                         d["q"], [[None if t is None else t[1] for t in p]
                                  for p in d["coeffs"]]))
    return out


def decisions(frame) -> list[Block]:
    """The blocks of a frame (an `avif.Frame`) as the plain decoder reads
    them (`blocks_of`)."""
    record: list = []
    av1.decode_planes_plain(frame, cdef=False, record=record)
    return blocks_of(record)
