"""The plain AV1 intra-frame decoder of the port: `csrc/av1.c` in Python,
function for function, for the files `utils/avif.py` reads (key frames
of 8, 10 or 12 bits a sample at 4:0:0, 4:2:0, 4:2:2 or 4:4:4, lossy or
lossless, with 64x64 or 128x128 superblocks, segmentation and film
grain, without superres). The planes hold 16 bits a sample at every depth; the
depth's terms (libaom's high-bit-depth functions) are the quantiser
tables, the coefficient clamp at 2^(bd+7), the transform clamps (rows
bd + 8 bits, columns max(bd + 6, 16)), the intra edge bases 2^(bd-1)
and its neighbours and the clips to 2^bd - 1, palette colours of bd
bits, the deblocking limits shifted by bd - 8 and its samples offset by
2^(bd-1), CDEF's strengths, damping and direction search shifted by bd -
8, and loop restoration's Wiener rounding (3 and 11, or 5 and 9 at 12
bits) and self-guided variance scaling. The stage functions take `bd`
(default 8).

`decode_planes_plain(frame)` takes an `avif.Frame` (the sequence and frame
headers and the tiles' bytes) and returns its Y, U and V planes (U and V
None when monochrome; uint8 at 8 bits, else uint16) as libaom 3.14.1
decodes them: the tiles (libaom's
entropy decoder and CDF adaptation, partition, intra mode info, palette,
intra block copy, segment ids, CDEF indices, delta q and delta lf,
restoration units, tx size, transform tree and type, coefficients), the
prediction, dequantisation at each block's segment's qindex with the
quantiser matrices and libaom's inverse transforms (the Walsh-Hadamard
transform in lossless segments), then deblocking (at each segment's
levels), CDEF and loop restoration, and the film grain libaom 3.14.1's
av1_add_film_grain adds to the output (`film_grain`: the seeded grain
templates and their auto-regressive filter, the scaling functions, the
32x32 blocks at offsets drawn per stripe and their overlap, the clip;
`grain_templates`, `noise_images`, `scaling_lut` are its stages); a
segment id past the last active one is refused, as libaom refuses it; a
tile whose symbols run past its bytes or that does not end in its
trailing bits is refused, as libaom reports it corrupt. The stage
functions (`inverse_transform_add`,
`iwht_add`, `idct`, `iadst`, `edge_filter`, `edge_upsample`,
`dr_predict`, `filter_intra_predict`, `nondir_predict`, `cfl_predict`,
`palette_color_context`, `dv_valid`, `intrabc_predict`,
`cdef_find_dir`, `cdef_block`, `lf_edge`, `wiener_filter`, `sgr_filter`)
are exposed for the tests that hold them against the C library's and
libaom's. A DV that libaom's av1_is_dv_valid rejects (a source outside
the tile, inside the 256-sample delay or past the wavefront) is refused,
as libaom reports the frame corrupt.

The tables are libaom's, read from the same header as the C library's
(`utils/av1_tables.py`). Everything is integer arithmetic; it is slow
(about 0.1 s for a few thousand pixels, 14 s at 480x640 on one CPU
core) and meant for small images.
"""

from __future__ import annotations

import functools

import numpy as np

from multiposenet_tpu_torch.utils.av1_tables import table

(DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
 D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED,
 UV_CFL_PRED) = range(14)
(DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
 FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST,
 H_ADST, V_FLIPADST, H_FLIPADST) = range(16)
TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64 = range(5)
TX_16X32, TX_32X16 = 9, 10
(BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8) = range(4)
BLOCK_64X64, BLOCK_128X128 = 12, 15
(PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
 PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B,
 PARTITION_HORZ_4, PARTITION_VERT_4) = range(10)
TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = range(3)

BW4 = (1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16)
BH4 = (1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4)
MI_WLOG2 = (0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4)
MI_HLOG2 = (0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2)
MAX_TX_DEPTH = (0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4, 2, 2, 3, 3, 4,
                4)
TX_WLOG2 = (2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6)
TX_HLOG2 = (2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4)
SPLIT_TX = (0, 0, 1, 2, 3, 0, 0, 1, 1, 2, 2, 3, 3, 5, 6, 7, 8, 9, 10)
TX_SQR = (0, 1, 2, 3, 4, 0, 0, 1, 1, 2, 2, 3, 3, 0, 0, 1, 1, 2, 2)
TX_SQR_UP = (0, 1, 2, 3, 4, 1, 1, 2, 2, 3, 3, 4, 4, 2, 2, 3, 3, 4, 4)
INTRA_MODE_CTX = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)
MODE_TO_TXFM = (DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT,
                DCT_ADST, DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                ADST_ADST)
FIMODE_TO_INTRADIR = (DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED)
NUM_EXT_TX_SET = (1, 2, 5, 7, 12, 16)
INTRA_EDGE_KERNEL = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))
DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)
INV_ROW_SHIFT = (0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2)
EOB_MULTI_SIZE = (0, 2, 4, 6, 6, 1, 1, 3, 3, 5, 5, 6, 6, 2, 2, 4, 4, 5, 5)
QM_OFFSET = (0, 16, 80, 336, 336, 1360, 1392, 1424, 1552, 1680, 2192, 336,
             336, 2704, 2768, 2832, 3088, 1680, 2192)
SKIP_CONTEXTS = ((1, 2, 2, 2, 3), (2, 4, 4, 4, 5), (2, 4, 4, 4, 5),
                 (2, 4, 4, 4, 5), (3, 5, 5, 5, 6))
# The vertical and horizontal 1-D kinds of each tx type: 0 DCT, 1 ADST,
# 2 flipped ADST, 3 identity.
TX_VERT = (0, 1, 0, 1, 2, 0, 2, 1, 2, 3, 0, 3, 1, 3, 2, 3)
TX_HORZ = (0, 0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 0, 3, 1, 3, 2)

_BSIZE = {(1, 1): 0, (1, 2): 1, (2, 1): 2, (2, 2): 3, (2, 4): 4, (4, 2): 5,
          (4, 4): 6, (4, 8): 7, (8, 4): 8, (8, 8): 9, (8, 16): 10,
          (16, 8): 11, (16, 16): 12, (1, 4): 16, (4, 1): 17, (2, 8): 18,
          (8, 2): 19, (4, 16): 20, (16, 4): 21, (16, 32): 13, (32, 16): 14,
          (32, 32): 15}


def bsize_of(w4: int, h4: int) -> int:
    return _BSIZE[(w4, h4)]


def tx_bsize(tx: int) -> int:
    return bsize_of(1 << (TX_WLOG2[tx] - 2), 1 << (TX_HLOG2[tx] - 2))


def clip3(lo, hi, v):
    return lo if v < lo else hi if v > hi else v


def round2(x: int, n: int) -> int:
    return x if n == 0 else (x + (1 << (n - 1))) >> n


def round2signed(x: int, n: int) -> int:
    return round2(x, n) if x >= 0 else -round2(-x, n)


@functools.cache
def _t():
    """The tables as Python lists (read once)."""
    names = ("kf_y_mode_cdf", "uv_mode_cdf", "partition_cdf",
             "intra_ext_tx_cdf", "txb_skip_cdf", "eob_extra_cdf",
             "dc_sign_cdf", "coeff_base_eob_cdf", "coeff_base_cdf",
             "coeff_br_cdf", "skip_cdf", "filter_intra_cdf",
             "filter_intra_mode_cdf", "angle_delta_cdf", "tx_size_cdf",
             "delta_q_cdf", "delta_lf_multi_cdf", "delta_lf_cdf",
             "cfl_sign_cdf", "cfl_alpha_cdf", "palette_y_mode_cdf",
             "palette_uv_mode_cdf", "palette_y_size_cdf",
             "palette_uv_size_cdf", "palette_y_color_index_cdf",
             "palette_uv_color_index_cdf", "switchable_restore_cdf",
             "wiener_restore_cdf", "sgrproj_restore_cdf",
             "palette_color_index_context_lookup", "sgr_params",
             "x_by_xplus1", "one_by_x", "nmv_context", "inter_ext_tx_cdf",
             "txfm_partition_cdf", "intrabc_cdf", "spatial_pred_seg_cdf",
             "dc_qlookup", "ac_qlookup",
             "dc_qlookup_10", "ac_qlookup_10", "dc_qlookup_12",
             "ac_qlookup_12",
             "filter_intra_taps", "dr_intra_derivative", "mode_to_angle_map",
             "smooth_weights", "cdef_pri_taps", "cdef_sec_taps",
             "cdef_directions_padded", "cospi", "sinpi", "eob_group_start",
             "eob_offset_bits", "ext_tx_inv", "ext_tx_used", "ss_size_lookup",
             "max_txsize_rect_lookup", "scan_data", "scan_offset",
             "nz_map_ctx_data", "nz_map_ctx_start")
    out = {n: table(n).tolist() for n in names}
    for k in (16, 32, 64, 128, 256, 512, 1024):
        out[f"eob{k}"] = table(f"eob_multi{k}_cdf").tolist()
    out["iwt_matrix"] = table("iwt_matrix")
    return out


# --- the symbol decoder ------------------------------------------------------


class SymbolDecoder:
    """libaom's od_ec_dec (a 32-bit window) and aom_read_symbol."""

    def __init__(self, data: bytes, allow_update: bool):
        self.data, self.pos, self.end = data, 0, len(data)
        self.dif = (1 << 31) - 1
        self.rng = 0x8000
        self.cnt = -15
        self.tell_offs = 10 - (32 - 8)
        self.allow_update = allow_update
        self._refill()

    def tell(self) -> int:
        """The bits read so far (od_ec_dec_tell)."""
        return self.pos * 8 - self.cnt + self.tell_offs

    def overflowed(self) -> bool:
        """aom_reader_has_overflowed: the bits read run past the data."""
        return (self.tell() + 7) >> 3 > self.end

    def trailing_bits_ok(self) -> bool:
        """libaom's check_trailing_bits_after_symbol_coder: a 1 bit after
        the last symbol, then zeros to the end."""
        if self.overflowed():
            return False
        bits = self.tell()
        at = (bits + 7) >> 3
        pattern = 128 >> ((bits - 1) & 7)
        if self.data[at - 1] & (2 * pattern - 1) != pattern:
            return False
        return not any(self.data[at:self.end])

    def _refill(self):
        s = 32 - 9 - (self.cnt + 15)
        dif, cnt, pos = self.dif, self.cnt, self.pos
        while s >= 0 and pos < self.end:
            dif ^= self.data[pos] << s
            cnt += 8
            pos += 1
            s -= 8
        if pos >= self.end:
            self.tell_offs += 0x4000 - cnt
            cnt = 0x4000
        self.dif, self.cnt, self.pos = dif, cnt, pos

    def _normalize(self, dif: int, rng: int, ret: int) -> int:
        d = 16 - rng.bit_length()
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & 0xFFFFFFFF
        self.rng = rng << d
        if self.cnt < 0:
            self._refill()
        return ret

    def decode_cdf(self, icdf, nsyms: int) -> int:
        dif, r = self.dif, self.rng
        c = dif >> 16
        v, ret, n = r, -1, nsyms - 1
        while True:
            u = v
            ret += 1
            v = ((r >> 8) * (icdf[ret] >> 6) >> 1) + 4 * (n - ret)
            if not c < v:
                break
        return self._normalize(dif - (v << 16), u - v, ret)

    def bool(self, f: int) -> int:
        dif, r = self.dif, self.rng
        v = ((r >> 8) * (f >> 6) >> 1) + 4
        vw = v << 16
        if dif >= vw:
            return self._normalize(dif - vw, r - v, 0)
        return self._normalize(dif, v, 1)

    def bit(self) -> int:
        return self.bool(16384)

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def uniform(self, n: int) -> int:
        """libaom's av1_read_uniform / aom_read_primitive_quniform."""
        if n <= 1:
            return 0
        w = n.bit_length()
        m = (1 << w) - n
        v = self.literal(w - 1)
        return v if v < m else (v << 1) - m + self.bit()

    def symbol(self, cdf: list, nsymbs: int) -> int:
        v = self.decode_cdf(cdf, nsymbs)
        if self.allow_update:
            update_cdf(cdf, v, nsymbs)
        return v


_SPEED = (0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2)


def update_cdf(cdf: list, val: int, nsymbs: int) -> None:
    rate = 3 + (cdf[nsymbs] > 15) + (cdf[nsymbs] > 31) + _SPEED[nsymbs]
    tmp = 32768
    for i in range(nsymbs - 1):
        if i == val:
            tmp = 0
        if tmp < cdf[i]:
            cdf[i] -= (cdf[i] - tmp) >> rate
        else:
            cdf[i] += (tmp - cdf[i]) >> rate
    cdf[nsymbs] += cdf[nsymbs] < 32


def _copy(x):
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    return [_copy(y) for y in x] if isinstance(x[0], (list, dict)) \
        else list(x)


def init_cdfs(base_q: int) -> dict:
    t = _t()
    q = 0 if base_q <= 20 else 1 if base_q <= 60 else 2 if base_q <= 120 \
        else 3
    c = {"kf_y": t["kf_y_mode_cdf"], "uv": t["uv_mode_cdf"],
         "partition": t["partition_cdf"],
         "intra_ext_tx": t["intra_ext_tx_cdf"],
         "txb_skip": t["txb_skip_cdf"][q], "eob_extra": t["eob_extra_cdf"][q],
         "dc_sign": t["dc_sign_cdf"][q],
         "coeff_base_eob": t["coeff_base_eob_cdf"][q],
         "coeff_base": t["coeff_base_cdf"][q],
         "coeff_br": t["coeff_br_cdf"][q], "skip": t["skip_cdf"],
         "filter_intra": t["filter_intra_cdf"],
         "filter_intra_mode": t["filter_intra_mode_cdf"],
         "angle_delta": t["angle_delta_cdf"], "tx_size": t["tx_size_cdf"],
         "delta_q": t["delta_q_cdf"], "delta_lf_multi": t["delta_lf_multi_cdf"],
         "delta_lf": t["delta_lf_cdf"], "cfl_sign": t["cfl_sign_cdf"],
         "cfl_alpha": t["cfl_alpha_cdf"],
         "palette_y_mode": t["palette_y_mode_cdf"],
         "palette_uv_mode": t["palette_uv_mode_cdf"],
         "palette_y_size": t["palette_y_size_cdf"],
         "palette_uv_size": t["palette_uv_size_cdf"],
         "palette_y_color": t["palette_y_color_index_cdf"],
         "palette_uv_color": t["palette_uv_color_index_cdf"],
         "switchable_restore": t["switchable_restore_cdf"],
         "wiener_restore": t["wiener_restore_cdf"],
         "sgrproj_restore": t["sgrproj_restore_cdf"],
         "intrabc": t["intrabc_cdf"],
         "txfm_partition": t["txfm_partition_cdf"],
         "inter_ext_tx": t["inter_ext_tx_cdf"],
         "spatial_seg": t["spatial_pred_seg_cdf"]}
    # the DV's CDFs: libaom's default_nmv_context (joints, then per
    # component classes, class0_fp, fp, sign, class0_hp, hp, class0, bits)
    mv = t["nmv_context"]
    c["dv_joints"] = mv[0:5]
    c["dv_comp"] = []
    for k in range(2):
        b = 5 + 69 * k
        c["dv_comp"].append({"classes": mv[b:b + 12],
                             "sign": mv[b + 27:b + 30],
                             "class0": mv[b + 36:b + 39],
                             "bits": [mv[b + 39 + 3 * i:b + 42 + 3 * i]
                                      for i in range(10)]})
    for k in (16, 32, 64, 128, 256, 512, 1024):
        c[f"eob{k}"] = t[f"eob{k}"][q]
    return _copy(c)


# --- inverse transforms ------------------------------------------------------


def _cos128(angle: int) -> int:
    cospi = _t()["cospi"][2]
    a = angle & 255
    if a <= 64:
        return cospi[a]
    if a <= 128:
        return -cospi[128 - a]
    if a <= 192:
        return -cospi[a - 128]
    return cospi[256 - a]


def _bfly(T: list, a: int, b: int, angle: int, flip: int) -> None:
    c, s = _cos128(angle), _cos128(angle - 64)
    x = (T[a] * c - T[b] * s + 2048) >> 12
    y = (T[a] * s + T[b] * c + 2048) >> 12
    if flip:
        T[a], T[b] = y, x
    else:
        T[a], T[b] = x, y


def _clamp_bits(v: int, bits: int) -> int:
    """v clamped to a signed range of `bits` bits (libaom's clamp_value)."""
    hi = (1 << (bits - 1)) - 1
    return -hi - 1 if v < -hi - 1 else hi if v > hi else v


def _hada(T: list, a: int, b: int, flip: int, r: int = 16) -> None:
    if flip:
        a, b = b, a
    x, y = T[a], T[b]
    T[a] = _clamp_bits(x + y, r)
    T[b] = _clamp_bits(x - y, r)


def _brev(nbits: int, x: int) -> int:
    r = 0
    for i in range(nbits):
        r |= ((x >> i) & 1) << (nbits - 1 - i)
    return r


def idct(T: list, n: int, r: int = 16) -> None:
    """Inverse DCT of 2^n points in place, its sums clamped to r bits
    (csrc/av1.c av1_idct)."""
    n0 = 1 << n
    copy = list(T[:n0])
    for i in range(n0):
        T[i] = copy[_brev(n, i)]
    B, H = _bfly, functools.partial(_hada, r=r)
    if n == 6:
        for i in range(16):
            B(T, 32 + i, 63 - i, 63 - 4 * _brev(4, i), 0)
    if n >= 5:
        for i in range(8):
            B(T, 16 + i, 31 - i, 6 + (_brev(3, 7 - i) << 3), 0)
    if n == 6:
        for i in range(16):
            H(T, 32 + i * 2, 33 + i * 2, i & 1)
    if n >= 4:
        for i in range(4):
            B(T, 8 + i, 15 - i, 12 + (_brev(2, 3 - i) << 4), 0)
    if n >= 5:
        for i in range(8):
            H(T, 16 + 2 * i, 17 + 2 * i, i & 1)
    if n == 6:
        for i in range(4):
            for j in range(2):
                B(T, 62 - i * 4 - j, 33 + i * 4 + j,
                  60 - 16 * _brev(2, i) + 64 * j, 1)
    if n >= 3:
        for i in range(2):
            B(T, 4 + i, 7 - i, 56 - 32 * i, 0)
    if n >= 4:
        for i in range(4):
            H(T, 8 + 2 * i, 9 + 2 * i, i & 1)
    if n >= 5:
        for i in range(2):
            for j in range(2):
                B(T, 30 - 4 * i - j, 17 + 4 * i + j,
                  24 + (j << 6) + ((1 - i) << 5), 1)
    if n == 6:
        for i in range(8):
            for j in range(2):
                H(T, 32 + i * 4 + j, 35 + i * 4 - j, i & 1)
    for i in range(2):
        B(T, 2 * i, 1 + 2 * i, 32 + 16 * i, 1 - i)
    if n >= 3:
        for i in range(2):
            H(T, 4 + 2 * i, 5 + 2 * i, i)
    if n >= 4:
        for i in range(2):
            B(T, 14 - i, 9 + i, 48 + 64 * i, 1)
    if n >= 5:
        for i in range(4):
            for j in range(2):
                H(T, 16 + 4 * i + j, 19 + 4 * i - j, i & 1)
    if n == 6:
        for i in range(2):
            for j in range(4):
                B(T, 61 - i * 8 - j, 34 + i * 8 + j,
                  56 - i * 32 + (j >> 1) * 64, 1)
    for i in range(2):
        H(T, i, 3 - i, 0)
    if n >= 3:
        B(T, 6, 5, 32, 1)
    if n >= 4:
        for i in range(2):
            for j in range(2):
                H(T, 8 + 4 * i + j, 11 + 4 * i - j, i)
    if n >= 5:
        for i in range(4):
            B(T, 29 - i, 18 + i, 48 + (i >> 1) * 64, 1)
    if n == 6:
        for i in range(4):
            for j in range(4):
                H(T, 32 + 8 * i + j, 39 + 8 * i - j, i & 1)
    if n >= 3:
        for i in range(4):
            H(T, i, 7 - i, 0)
    if n >= 4:
        for i in range(2):
            B(T, 13 - i, 10 + i, 32, 1)
    if n >= 5:
        for i in range(2):
            for j in range(4):
                H(T, 16 + i * 8 + j, 23 + i * 8 - j, i)
    if n == 6:
        for i in range(8):
            B(T, 59 - i, 36 + i, 48 if i < 4 else 112, 1)
    if n >= 4:
        for i in range(8):
            H(T, i, 15 - i, 0)
    if n >= 5:
        for i in range(4):
            B(T, 27 - i, 20 + i, 32, 1)
    if n == 6:
        for i in range(8):
            H(T, 32 + i, 47 - i, 0)
        for i in range(8):
            H(T, 48 + i, 63 - i, 1)
    if n >= 5:
        for i in range(16):
            H(T, i, 31 - i, 0)
    if n == 6:
        for i in range(8):
            B(T, 55 - i, 40 + i, 32, 1)
        for i in range(32):
            H(T, i, 63 - i, 0)


def iadst4(T: list) -> None:
    s = _t()["sinpi"][2]
    x0, x1, x2, x3 = T[0], T[1], T[2], T[3]
    if not (x0 | x1 | x2 | x3):
        return
    s0, s1, s2, s3 = s[1] * x0, s[2] * x0, s[3] * x1, s[4] * x2
    s4, s5, s6 = s[1] * x2, s[2] * x3, s[4] * x3
    s7 = (x0 - x2) + x3
    s0, s1 = s0 + s3, s1 - s4
    s3, s2 = s2, s[3] * s7
    s0, s1 = s0 + s5, s1 - s6
    x0, x1, x2, x3 = s0 + s3, s1 + s3, s2, s0 + s1
    x3 = x3 - s3
    T[0], T[1], T[2], T[3] = (round2(x0, 12), round2(x1, 12), round2(x2, 12),
                              round2(x3, 12))


def iadst(T: list, n: int, r: int = 16) -> None:
    """Inverse ADST of 8 (n = 3) or 16 (n = 4) points in place, its sums
    clamped to r bits."""
    n0 = 1 << n
    copy = list(T[:n0])
    for i in range(n0):
        T[i] = copy[(i - 1) if i & 1 else (n0 - i - 1)]
    B, H = _bfly, functools.partial(_hada, r=r)
    if n == 3:
        for i in range(4):
            B(T, 2 * i, 2 * i + 1, 60 - 16 * i, 1)
        for i in range(4):
            H(T, i, 4 + i, 0)
        for i in range(2):
            B(T, 4 + 3 * i, 5 + i, 48 - 32 * i, 1)
        for i in range(2):
            H(T, i, 2 + i, 0)
            H(T, 4 + i, 6 + i, 0)
        for i in range(2):
            B(T, 2 + 4 * i, 3 + 4 * i, 32, 1)
    else:
        for i in range(8):
            B(T, 2 * i, 2 * i + 1, 62 - 8 * i, 1)
        for i in range(8):
            H(T, i, 8 + i, 0)
        for i in range(2):
            B(T, 8 + 2 * i, 9 + 2 * i, 56 - 32 * i, 1)
            B(T, 13 + 2 * i, 12 + 2 * i, 8 + 32 * i, 1)
        for i in range(4):
            H(T, i, 4 + i, 0)
            H(T, 8 + i, 12 + i, 0)
        for i in range(2):
            B(T, 4 + 8 * i, 5 + 8 * i, 48, 1)
            B(T, 7 + 8 * i, 6 + 8 * i, 16, 1)
        for i in range(2):
            H(T, i, 2 + i, 0)
            H(T, 4 + i, 6 + i, 0)
            H(T, 8 + i, 10 + i, 0)
            H(T, 12 + i, 14 + i, 0)
        for i in range(4):
            B(T, 2 + 4 * i, 3 + 4 * i, 32, 1)
    copy = list(T[:n0])
    for i in range(n0):
        a = (i >> 3) & 1
        b = ((i >> 2) & 1) ^ ((i >> 3) & 1)
        c = ((i >> 1) & 1) ^ ((i >> 2) & 1)
        d = (i & 1) ^ ((i >> 1) & 1)
        idx = ((d << 3) | (c << 2) | (b << 1) | a) >> (4 - n)
        T[i] = -copy[idx] if i & 1 else copy[idx]


def _tx1d(T: list, n: int, kind: int, r: int) -> None:
    if kind == 0:
        idct(T, n, r)
    elif kind == 3:
        for i in range(1 << n):
            if n == 2:
                T[i] = round2(T[i] * 5793, 12)
            elif n == 3:
                T[i] = T[i] * 2
            elif n == 4:
                T[i] = round2(T[i] * 11586, 12)
            else:
                T[i] = T[i] * 4
    elif n == 2:
        iadst4(T)
    else:
        iadst(T, n, r)


def inverse_transform_add(coef, tx: int, tx_type: int, dst: np.ndarray,
                          bd: int = 8) -> None:
    """libaom's av1_inv_txfm2d_add_c at bd bits a sample: coef
    column-major over the coded area (min(w,32) x min(h,32)); rows
    clamped to bd + 8 bits in and through, columns to max(bd + 6, 16);
    the residual is added to dst (a view of h x w) and clipped to
    0 .. 2^bd - 1."""
    row_bits, col_bits = bd + 8, max(bd + 6, 16)
    lw, lh = TX_WLOG2[tx], TX_HLOG2[tx]
    w, h = 1 << lw, 1 << lh
    cw, ch = min(w, 32), min(h, 32)
    rect = abs(lw - lh) == 1
    vert, horz = TX_VERT[tx_type], TX_HORZ[tx_type]
    shift = INV_ROW_SHIFT[tx]
    buf = []
    for r in range(h):
        row = []
        for c in range(w):
            v = int(coef[c * ch + r]) if r < ch and c < cw else 0
            if rect:
                v = round2(v * 2896, 12)
            row.append(_clamp_bits(v, row_bits))
        _tx1d(row, lw, horz, row_bits)
        buf.append([round2(v, shift) for v in row])
    for c in range(w):
        sc = w - 1 - c if horz == 2 else c
        col = [_clamp_bits(buf[r][sc], col_bits) for r in range(h)]
        _tx1d(col, lh, vert, col_bits)
        for r in range(h):
            v = round2(col[h - 1 - r if vert == 2 else r], 4)
            dst[r, c] = clip3(0, (1 << bd) - 1, int(dst[r, c]) + v)


def _wht4(a: int, c: int, d: int, b: int) -> tuple:
    a += c
    d -= b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a -= b
    d += c
    return a, b, c, d


def iwht_add(coef, dst: np.ndarray, bd: int = 8) -> None:
    """libaom's av1_highbd_iwht4x4_16_add_c, the lossless inverse
    Walsh-Hadamard transform: coef column-major (4x4), rows first with
    the shift of 2; the residual is added to dst (a view of 4 x 4) and
    clipped to 0 .. 2^bd - 1."""
    tmp = [0] * 16
    for i in range(4):  # row i
        out = _wht4(*(int(coef[4 * k + i]) >> 2 for k in range(4)))
        for k in range(4):
            tmp[4 * k + i] = out[k]
    for i in range(4):  # column i
        out = _wht4(*tmp[4 * i:4 * i + 4])
        for k in range(4):
            dst[k, i] = clip3(0, (1 << bd) - 1, int(dst[k, i]) + out[k])


# --- the frame and its tiles -------------------------------------------------


class _Frame:
    def __init__(self, frame):
        s, h = frame.seq, frame.header
        self.h = h
        self.width, self.height = h.width, h.height
        self.planes = 1 if s.mono else 3
        self.bd = s.bit_depth
        self.ssx, self.ssy = (1, 1) if s.mono else (s.ssx, s.ssy)
        self.lossless = h.lossless  # CodedLossless
        self.filter_intra = s.filter_intra
        self.edge_filter = s.intra_edge_filter
        self.enable_cdef = s.cdef and not (h.lossless or h.allow_intrabc)
        self.mi_cols = 2 * ((h.width + 7) >> 3)
        self.mi_rows = 2 * ((h.height + 7) >> 3)
        self.sb4 = 32 if s.sb128 else 16  # the superblock's side in 4x4s
        self.sb_size = BLOCK_128X128 if s.sb128 else BLOCK_64X64
        sb4 = self.sb4
        sbc = (self.mi_cols + sb4 - 1) // sb4
        sbr = (self.mi_rows + sb4 - 1) // sb4
        self.mi_h, self.mi_w = sbr * sb4 + 1, sbc * sb4 + 1
        shape = (self.mi_h, self.mi_w)
        self.mi_size = np.zeros(shape, np.int64)
        self.y_mode = np.zeros(shape, np.int64)
        self.uv_mode = np.zeros(shape, np.int64)
        self.skip = np.zeros(shape, np.int64)
        self.tx_size = np.zeros(shape, np.int64)
        self.delta_lf = np.zeros(shape + (4,), np.int64)
        self.pal_size = np.zeros(shape + (2,), np.int64)
        self.pal_colors = np.zeros(shape + (3, 8), np.int64)
        self.is_inter = np.zeros(shape, np.int64)  # intra block copy
        self.mvs = np.zeros(shape + (2,), np.int64)  # its DV, 1/8 pel
        self.written = np.zeros(shape, bool)
        self.tx_type = np.zeros(shape, np.int64)  # luma tx types (4x4s)
        self.seg_map = np.zeros(shape, np.int64)  # segment ids
        self.cdef_idx = np.full((sbr * sb4 // 16, sbc * sb4 // 16), -1,
                                np.int64)
        # loop restoration: each plane's units (rows, cols) and, for each
        # unit, (type, coefficients)
        self.lr_units = []
        for p in range(self.planes):
            sx, sy = (self.ssx, self.ssy) if p else (0, 0)
            size = h.lr_unit_size[p]
            rows = lr_unit_count(size, (h.height + sy) >> sy)
            cols = lr_unit_count(size, (h.width + sx) >> sx)
            self.lr_units.append([[(0, None)] * cols for _ in range(rows)])
        self.frame, self.lf_txsz = [], []
        for p in range(self.planes):
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            ph, pw = (sbr * sb4 * 4) >> sy, (sbc * sb4 * 4) >> sx
            self.frame.append(np.zeros((ph, pw), np.uint16))
            self.lf_txsz.append(np.zeros((ph // 4, pw // 4), np.int64))


class _Tile:
    def __init__(self, f: _Frame):
        self.f = f
        self.above_ctx = [[0] * (f.mi_cols + 64) for _ in range(f.planes)]
        self.left_ctx = [[0] * 32 for _ in range(3)]
        self.decoded = [[[0] * 34 for _ in range(34)] for _ in range(3)]
        self.record = None  # a list: each block's decisions (`record`)

    def inside(self, r: int, c: int) -> bool:
        return (self.col_start <= c < self.col_end
                and self.row_start <= r < self.row_end)


def _is_directional(mode: int) -> bool:
    return V_PRED <= mode <= D67_PRED


def _is_smooth_at(t: _Tile, r: int, c: int, plane: int) -> bool:
    mode = t.f.y_mode[r, c] if plane == 0 else t.f.uv_mode[r, c]
    return mode in (SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED)


def _filter_type(t: _Tile, plane: int) -> int:
    f = t.f
    above = left = False
    if t.avail_u if plane == 0 else t.avail_u_chroma:
        r, c = t.mi_row - 1, t.mi_col
        if plane > 0:
            if f.ssx and not (t.mi_col & 1):
                c += 1
            if f.ssy and (t.mi_row & 1):
                r -= 1
        above = _is_smooth_at(t, r, c, plane)
    if t.avail_l if plane == 0 else t.avail_l_chroma:
        r, c = t.mi_row, t.mi_col - 1
        if plane > 0:
            if f.ssx and (t.mi_col & 1):
                c -= 1
            if f.ssy and not (t.mi_row & 1):
                r += 1
        left = _is_smooth_at(t, r, c, plane)
    return int(above or left)


def _edge_strength(w: int, h: int, kind: int, delta: int) -> int:
    d, wh, s = abs(delta), w + h, 0
    if kind == 0:
        if wh <= 8:
            s = 1 if d >= 56 else 0
        elif wh <= 16:
            s = 1 if d >= 40 else 0
        elif wh <= 24:
            s = 3 if d >= 32 else 2 if d >= 16 else 1 if d >= 8 else 0
        elif wh <= 32:
            s = 3 if d >= 32 else 2 if d >= 4 else 1 if d >= 1 else 0
        else:
            s = 3 if d >= 1 else 0
    else:
        if wh <= 8:
            s = 2 if d >= 64 else 1 if d >= 40 else 0
        elif wh <= 16:
            s = 2 if d >= 48 else 1 if d >= 20 else 0
        elif wh <= 24:
            s = 3 if d >= 4 else 0
        else:
            s = 3 if d >= 1 else 0
    return s


def _use_upsample(w: int, h: int, kind: int, delta: int) -> int:
    d = abs(delta)
    if d <= 0 or d >= 40:
        return 0
    return int(w + h <= 8) if kind else int(w + h <= 16)


class _Edge:
    """An edge array indexed from -16."""

    def __init__(self, n: int):
        self.a = [0] * (n + 32)

    def __getitem__(self, i):
        return self.a[i + 16]

    def __setitem__(self, i, v):
        self.a[i + 16] = v


def edge_filter(edge: _Edge, sz: int, strength: int) -> None:
    """The intra edge filter on edge[-1 .. sz-2] in place (csrc/av1.c
    av1_edge_filter)."""
    if not strength:
        return
    tmp = [edge[i - 1] for i in range(sz)]
    k = INTRA_EDGE_KERNEL[strength - 1]
    for i in range(1, sz):
        s = 0
        for j in range(5):
            s += k[j] * tmp[clip3(0, sz - 1, i - 2 + j)]
        edge[i - 1] = (s + 8) >> 4


def edge_upsample(buf: _Edge, numpx: int, bd: int = 8) -> None:
    """The intra edge upsampling of buf[-1 .. numpx-1] in place, into
    buf[-2 .. 2 numpx - 2], clipped to bd bits (csrc/av1.c
    av1_edge_upsample)."""
    dup = [0] * (numpx + 3)
    dup[0] = buf[-1]
    for i in range(-1, numpx):
        dup[i + 2] = buf[i]
    dup[numpx + 2] = buf[numpx - 1]
    buf[-2] = dup[0]
    for i in range(numpx):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        buf[2 * i - 1] = clip3(0, (1 << bd) - 1, round2(s, 4))
        buf[2 * i] = dup[i + 2]


def filter_intra_predict(above, left, w: int, h: int, mode: int,
                         bd: int = 8) -> np.ndarray:
    """Filter intra of a w x h block from its edges (above[-1] the
    corner), clipped to bd bits (csrc/av1.c av1_filter_intra_predict)."""
    taps = _t()["filter_intra_taps"][mode]
    out = np.zeros((h, w), np.int64)
    for i2 in range(h >> 1):
        for j4 in range(w >> 2):
            p = [0] * 7
            for i in range(7):
                if i < 5:
                    if i2 == 0:
                        p[i] = above[(j4 << 2) + i - 1]
                    elif j4 == 0 and i == 0:
                        p[i] = left[(i2 << 1) - 1]
                    else:
                        p[i] = int(out[(i2 << 1) - 1, (j4 << 2) + i - 1])
                elif j4 == 0:
                    p[i] = left[(i2 << 1) + i - 5]
                else:
                    p[i] = int(out[(i2 << 1) + i - 5, (j4 << 2) - 1])
            for i in range(8):
                pr = sum(taps[i][j] * p[j] for j in range(7))
                out[(i2 << 1) + (i >> 2), (j4 << 2) + (i & 3)] = clip3(
                    0, (1 << bd) - 1, round2signed(pr, 4))
    return out


def dr_predict(above, left, w: int, h: int, up_above: int, up_left: int,
               angle: int) -> np.ndarray:
    """Directional prediction at `angle` from the (filtered, upsampled)
    edges (csrc/av1.c av1_dr_predict)."""
    deriv = _t()["dr_intra_derivative"]
    out = np.zeros((h, w), np.int64)
    dx = dy = 0
    if angle < 90:
        dx = deriv[angle]
    elif 90 < angle < 180:
        dx = deriv[180 - angle]
    if 90 < angle < 180:
        dy = deriv[angle - 90]
    elif angle > 180:
        dy = deriv[270 - angle]
    for i in range(h):
        for j in range(w):
            if angle < 90:
                idx = (i + 1) * dx
                base = (idx >> (6 - up_above)) + (j << up_above)
                shift = ((idx << up_above) >> 1) & 0x1F
                max_base = (w + h - 1) << up_above
                if base < max_base:
                    v = round2(above[base] * (32 - shift)
                               + above[base + 1] * shift, 5)
                else:
                    v = above[max_base]
            elif 90 < angle < 180:
                idx = (j << 6) - (i + 1) * dx
                base = idx >> (6 - up_above)
                if base >= -(1 << up_above):
                    shift = ((idx * (1 << up_above)) >> 1) & 0x1F
                    v = round2(above[base] * (32 - shift)
                               + above[base + 1] * shift, 5)
                else:
                    idx = (i << 6) - (j + 1) * dy
                    base = idx >> (6 - up_left)
                    shift = ((idx * (1 << up_left)) >> 1) & 0x1F
                    v = round2(left[base] * (32 - shift)
                               + left[base + 1] * shift, 5)
            elif angle > 180:
                idx = (j + 1) * dy
                base = (idx >> (6 - up_left)) + (i << up_left)
                shift = ((idx << up_left) >> 1) & 0x1F
                v = round2(left[base] * (32 - shift)
                           + left[base + 1] * shift, 5)
            elif angle == 90:
                v = above[j]
            else:
                v = left[i]
            out[i, j] = v
    return out


def nondir_predict(above, left, w: int, h: int, mode: int, have_left: bool,
                   have_above: bool, bd: int = 8) -> np.ndarray:
    """DC, smooth, smooth V, smooth H and Paeth prediction from the edges
    (DC without either edge: 2^(bd-1); csrc/av1.c av1_nondir_predict)."""
    tb = _t()
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    out = np.zeros((h, w), np.int64)
    if mode in (SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED):
        sw = tb["smooth_weights"]
        wx, wy = sw[w - 4:2 * w - 4], sw[h - 4:2 * h - 4]
        for i in range(h):
            for j in range(w):
                if mode == SMOOTH_PRED:
                    s = (wy[i] * above[j] + (256 - wy[i]) * left[h - 1]
                         + wx[j] * left[i] + (256 - wx[j]) * above[w - 1])
                    out[i, j] = round2(s, 9)
                elif mode == SMOOTH_V_PRED:
                    out[i, j] = round2(wy[i] * above[j]
                                       + (256 - wy[i]) * left[h - 1], 8)
                else:
                    out[i, j] = round2(wx[j] * left[i]
                                       + (256 - wx[j]) * above[w - 1], 8)
    elif mode == DC_PRED:
        if have_left and have_above:
            s = sum(above[k] for k in range(w)) + sum(left[k]
                                                      for k in range(h))
            avg = (s + ((w + h) >> 1)) // (w + h)
        elif have_left:
            avg = (sum(left[k] for k in range(h)) + (h >> 1)) >> lh
        elif have_above:
            avg = (sum(above[k] for k in range(w)) + (w >> 1)) >> lw
        else:
            avg = 1 << (bd - 1)
        out[:] = avg
    else:
        for i in range(h):
            for j in range(w):
                base = above[j] + left[i] - above[-1]
                pl, pt = abs(base - left[i]), abs(base - above[j])
                ptl = abs(base - above[-1])
                if pl <= pt and pl <= ptl:
                    out[i, j] = left[i]
                elif pt <= ptl:
                    out[i, j] = above[j]
                else:
                    out[i, j] = above[-1]
    return out


def _predict_intra(t: _Tile, plane: int, x: int, y: int, have_left: bool,
                   have_above: bool, have_above_rt: int, have_below_lt: int,
                   mode: int, lw: int, lh: int) -> None:
    f = t.f
    tb = _t()
    w, h = 1 << lw, 1 << lh
    sx = f.ssx if plane else 0
    sy = f.ssy if plane else 0
    max_x = ((f.mi_cols * 4) >> sx) - 1
    max_y = ((f.mi_rows * 4) >> sy) - 1
    fr = f.frame[plane]
    base = 1 << (f.bd - 1)
    above, left = _Edge(2 * 128 + 32), _Edge(2 * 128 + 32)
    for i in range(w + h):
        if not have_above and have_left:
            above[i] = int(fr[y, x - 1])
        elif not have_above:
            above[i] = base - 1
        else:
            lim = min(x + (2 * w if have_above_rt else w) - 1, max_x)
            above[i] = int(fr[y - 1, min(x + i, lim)])
        if not have_left and have_above:
            left[i] = int(fr[y - 1, x])
        elif not have_left:
            left[i] = base + 1
        else:
            lim = min(y + (2 * h if have_below_lt else h) - 1, max_y)
            left[i] = int(fr[min(y + i, lim), x - 1])
    if have_above and have_left:
        corner = int(fr[y - 1, x - 1])
    elif have_above:
        corner = int(fr[y - 1, x])
    elif have_left:
        corner = int(fr[y, x - 1])
    else:
        corner = base
    above[-1] = left[-1] = corner
    if plane == 0 and t.use_filter_intra:
        out = filter_intra_predict(above, left, w, h, t.filter_mode, f.bd)
    elif _is_directional(mode):
        delta = t.angle_y if plane == 0 else t.angle_uv
        angle = tb["mode_to_angle_map"][mode] + delta * 3
        up_above = up_left = 0
        if f.edge_filter:
            if angle not in (90, 180):
                if 90 < angle < 180 and w + h >= 24:
                    v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4)
                    left[-1] = above[-1] = v
                kind = _filter_type(t, plane)
                if have_above:
                    s = _edge_strength(w, h, kind, angle - 90)
                    n = min(w, max_x - x + 1) + (h if angle < 90 else 0) + 1
                    edge_filter(above, n, s)
                if have_left:
                    s = _edge_strength(w, h, kind, angle - 180)
                    n = min(h, max_y - y + 1) + (w if angle > 180 else 0) + 1
                    edge_filter(left, n, s)
            kind = _filter_type(t, plane)
            up_above = _use_upsample(w, h, kind, angle - 90)
            if up_above:
                edge_upsample(above, w + (h if angle < 90 else 0), f.bd)
            up_left = _use_upsample(w, h, kind, angle - 180)
            if up_left:
                edge_upsample(left, h + (w if angle > 180 else 0), f.bd)
        out = dr_predict(above, left, w, h, up_above, up_left, angle)
    else:
        out = nondir_predict(above, left, w, h, mode, have_left, have_above,
                             f.bd)
    fr[y:y + h, x:x + w] = out


def cfl_predict(dc: np.ndarray, luma: np.ndarray, max_w: int, max_h: int,
                alpha: int, ssx: int = 1, ssy: int = 1,
                bd: int = 8) -> np.ndarray:
    """Chroma from luma of the chroma block whose DC prediction is `dc`,
    from the co-located luma (subsampled by ssx, ssy) of which max_w x
    max_h samples are decoded, clipped to bd bits (csrc/av1.c
    av1_cfl_predict)."""
    h, w = dc.shape
    L = [[0] * w for _ in range(h)]
    total = 0
    shift = 3 - ssx - ssy
    for i in range(h):
        ly = min(i, (max_h >> ssy) - 1) << ssy
        for j in range(w):
            lx = min(j, (max_w >> ssx) - 1) << ssx
            v = 0
            for dy in range(1 + ssy):
                for dx in range(1 + ssx):
                    v += int(luma[ly + dy, lx + dx])
            L[i][j] = v << shift
            total += L[i][j]
    avg = round2(total, (w.bit_length() - 1) + (h.bit_length() - 1))
    out = np.empty((h, w), np.int64)
    for i in range(h):
        for j in range(w):
            out[i, j] = clip3(0, (1 << bd) - 1, int(dc[i, j])
                              + round2signed(alpha * (L[i][j] - avg), 6))
    return out


def _predict_cfl(t: _Tile, plane: int, sx0: int, sy0: int, tx: int) -> None:
    f = t.f
    w, h = 1 << TX_WLOG2[tx], 1 << TX_HLOG2[tx]
    fr = f.frame[plane]
    lx, ly = sx0 << f.ssx, sy0 << f.ssy
    fr[sy0:sy0 + h, sx0:sx0 + w] = cfl_predict(
        fr[sy0:sy0 + h, sx0:sx0 + w], f.frame[0][ly:, lx:],
        t.max_luma_w - lx, t.max_luma_h - ly,
        t.cfl_u if plane == 1 else t.cfl_v, f.ssx, f.ssy, f.bd)


def _tx_class(tx_type: int) -> int:
    if tx_type in (V_DCT, V_ADST, V_FLIPADST):
        return TX_CLASS_VERT
    if tx_type in (H_DCT, H_ADST, H_FLIPADST):
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


# The inter transform sets (EXT_TX_SET_DCT_IDTX 1, _DTT9_IDTX_1DDCT 4,
# _ALL16 5) and their inter_ext_tx_cdf index.
INTER_SET_INDEX = {1: 3, 4: 2, 5: 1}


def _tx_set_type_inter(tx: int, reduced: int) -> int:
    if TX_SQR_UP[tx] > TX_32X32:
        return 0
    if TX_SQR_UP[tx] == TX_32X32 or reduced:
        return 1
    return 4 if TX_SQR[tx] == TX_16X16 else 5


def _tx_set_type(tx: int, reduced: int) -> int:
    if TX_SQR_UP[tx] >= TX_32X32:
        return 0
    if reduced:
        return 2
    return 2 if TX_SQR[tx] == TX_16X16 else 3


def _read_coeffs(t: _Tile, plane: int, x4: int, y4: int, tx: int):
    """(eob, tx_type, dequantised coefficients, column-major)."""
    f, cdf, ec, tb = t.f, t.cdf, t.ec, _t()
    hdr = f.h
    ptype = int(plane > 0)
    lw, lh = TX_WLOG2[tx], TX_HLOG2[tx]
    w4, h4 = 1 << (lw - 2), 1 << (lh - 2)
    cw, ch = min(1 << lw, 32), min(1 << lh, 32)
    bhl = min(lh, 5)
    txs_ctx = (TX_SQR[tx] + TX_SQR_UP[tx] + 1) >> 1
    sx = f.ssx if plane else 0
    sy = f.ssy if plane else 0
    max_x4 = ((f.mi_cols * 4) >> sx) >> 2
    max_y4 = ((f.mi_rows * 4) >> sy) >> 2
    a = t.above_ctx[plane]
    lctx = t.left_ctx[plane]
    lbase = y4 & ((f.sb4 >> sy) - 1)
    dc_sign = 0
    for k in range(w4):
        s = a[x4 + k] >> 6
        dc_sign += -1 if s == 1 else 1 if s == 2 else 0
    for k in range(h4):
        s = lctx[lbase + k] >> 6
        dc_sign += -1 if s == 1 else 1 if s == 2 else 0
    dc_sign_ctx = 1 if dc_sign < 0 else 2 if dc_sign > 0 else 0
    pbs = tb["ss_size_lookup"][t.bsize][f.ssx][f.ssy] if plane else t.bsize
    if plane == 0:
        if pbs == tx_bsize(tx):
            ctx = 0
        else:
            top = left = 0
            for k in range(w4):
                top |= a[x4 + k]
            for k in range(h4):
                left |= lctx[lbase + k]
            ctx = SKIP_CONTEXTS[min(top & 63, 4)][min(left & 63, 4)]
    else:
        above = left = 0
        for k in range(w4):
            above |= a[x4 + k]
        for k in range(h4):
            left |= lctx[lbase + k]
        ctx = (above != 0) + (left != 0)
        ctx += 10 if 16 * BW4[pbs] * BH4[pbs] > (1 << (lw + lh)) else 7
    all_zero = ec.symbol(cdf["txb_skip"][txs_ctx][ctx], 2)
    eob = cul = dc_val = 0
    tx_type = DCT_DCT
    coef = [0] * (cw * ch)
    signed = [0] * (cw * ch) if t.record is not None else None
    if not all_zero:
        inter = t.use_intrabc
        tx_set = _tx_set_type_inter(tx, hdr.reduced_tx_set) if inter \
            else _tx_set_type(tx, hdr.reduced_tx_set)
        if plane == 0 and inter:
            if tx_set > 0 and hdr.seg_qindex[t.segment_id] > 0:
                sym = ec.symbol(cdf["inter_ext_tx"][INTER_SET_INDEX[tx_set]]
                                [TX_SQR[tx]], NUM_EXT_TX_SET[tx_set])
                tx_type = tb["ext_tx_inv"][tx_set][sym]
        elif plane == 0:
            if tx_set > 0 and hdr.seg_qindex[t.segment_id] > 0:
                eset = 1 if tx_set == 3 else 2
                mode = FIMODE_TO_INTRADIR[t.filter_mode] \
                    if t.use_filter_intra else t.y_mode
                sym = ec.symbol(cdf["intra_ext_tx"][eset][TX_SQR[tx]][mode],
                                NUM_EXT_TX_SET[tx_set])
                tx_type = tb["ext_tx_inv"][tx_set][sym]
        else:
            if inter:  # the co-located luma transform's type
                tx_type = int(f.tx_type[
                    t.mi_row + ((y4 - (t.mi_row >> sy)) << sy),
                    t.mi_col + ((x4 - (t.mi_col >> sx)) << sx)])
            else:
                tx_type = MODE_TO_TXFM[DC_PRED if t.uv_mode == UV_CFL_PRED
                                       else t.uv_mode]
            if not tb["ext_tx_used"][tx_set][tx_type]:
                tx_type = DCT_DCT
        if TX_SQR_UP[tx] > TX_32X32 or t.lossless:
            tx_type = DCT_DCT
        cls = _tx_class(tx_type)
        so = tb["scan_offset"][tx][tx_type]
        scan = tb["scan_data"][so:so + cw * ch]
        nzs = tb["nz_map_ctx_start"][tx]
        nz_off = tb["nz_map_ctx_data"][nzs:nzs + cw * ch]
        ems = EOB_MULTI_SIZE[tx]
        emctx = 0 if cls == TX_CLASS_2D else 1
        eob_cdf = cdf[f"eob{16 << ems}"][ptype][emctx]
        eob_pt = ec.symbol(eob_cdf, 5 + ems) + 1
        extra = 0
        bits = tb["eob_offset_bits"][eob_pt]
        if bits > 0:
            if ec.symbol(cdf["eob_extra"][txs_ctx][ptype][eob_pt - 3], 2):
                extra += 1 << (bits - 1)
            for i in range(1, bits):
                if ec.bit():
                    extra += 1 << (bits - 1 - i)
        eob = tb["eob_group_start"][eob_pt] + extra
        stride = (1 << bhl) + 4
        levels = [0] * ((32 + 4) * (32 + 4) + 64)
        for c in range(eob - 1, -1, -1):
            pos = scan[c]
            col = pos >> bhl
            row = pos - (col << bhl)
            li = col * stride + row
            if c == eob - 1:
                area = cw << bhl
                cctx = 0 if c == 0 else 1 if c <= area // 8 else 2 \
                    if c <= area // 4 else 3
                level = ec.symbol(
                    cdf["coeff_base_eob"][txs_ctx][ptype][cctx], 3) + 1
            else:
                if cls == TX_CLASS_2D:
                    offs = (stride, 1, stride + 1, 2 * stride, 2)
                elif cls == TX_CLASS_VERT:
                    offs = (stride, 1, 2, 3, 4)
                else:
                    offs = (stride, 1, 2 * stride, 3 * stride, 4 * stride)
                mag = sum(min(levels[li + o], 3) for o in offs)
                m = min((mag + 1) >> 1, 4)
                if cls == TX_CLASS_2D:
                    cctx = 0 if pos == 0 else m + nz_off[pos]
                else:
                    idx = row if cls == TX_CLASS_VERT else col
                    cctx = m + 26 + (0 if idx == 0 else 5 if idx == 1 else 10)
                level = ec.symbol(cdf["coeff_base"][txs_ctx][ptype][cctx], 4)
            if level > 2:
                mag = levels[li + 1] + levels[li + stride]
                if cls == TX_CLASS_2D:
                    mag += levels[li + stride + 1]
                elif cls == TX_CLASS_HORIZ:
                    mag += levels[li + 2 * stride]
                else:
                    mag += levels[li + 2]
                mag = min((mag + 1) >> 1, 6)
                if c == eob - 1:
                    mag = 0
                if pos == 0:
                    bctx = mag
                elif ((cls == TX_CLASS_2D and row < 2 and col < 2)
                      or (cls == TX_CLASS_HORIZ and col == 0)
                      or (cls == TX_CLASS_VERT and row == 0)):
                    bctx = mag + 7
                else:
                    bctx = mag + 14
                bcdf = cdf["coeff_br"][min(txs_ctx, 3)][ptype][bctx]
                for _ in range(4):
                    k = ec.symbol(bcdf, 4)
                    level += k
                    if k < 3:
                        break
            levels[li] = level
        qm_level = hdr.qm[plane] if hdr.using_qm and not t.lossless else 15
        iqm = None
        if qm_level < 15 and tx_type < IDTX:
            iqm = tb["iwt_matrix"][qm_level][int(plane > 0)][QM_OFFSET[tx]:]
        q = _block_qindex(t)
        depth = "" if f.bd == 8 else f"_{f.bd}"  # Dc_Qlookup[(bd - 8) / 2]
        dcq, acq = tb["dc_qlookup" + depth], tb["ac_qlookup" + depth]
        coef_max = (1 << (7 + f.bd)) - 1  # libaom's max_value
        if plane == 0:
            dq_dc = dcq[clip3(0, 255, q + hdr.dq[0])]
            dq_ac = acq[clip3(0, 255, q)]
        else:
            dcd = hdr.dq[1] if plane == 1 else hdr.dq[3]
            acd = hdr.dq[2] if plane == 1 else hdr.dq[4]
            dq_dc = dcq[clip3(0, 255, q + dcd)]
            dq_ac = acq[clip3(0, 255, q + acd)]
        npix = 1 << (lw + lh)
        dq_shift = (npix > 256) + (npix > 1024)
        for c in range(eob):
            pos = scan[c]
            col = pos >> bhl
            row = pos - (col << bhl)
            level = levels[col * stride + row]
            if not level:
                continue
            if c == 0:
                sign = ec.symbol(cdf["dc_sign"][ptype][dc_sign_ctx], 2)
            else:
                sign = ec.bit()
            if level >= 15:
                length, bit, x = 0, 0, 1
                while not bit:
                    bit = ec.bit()
                    length += 1
                    if length > 20:
                        raise ValueError("AV1: a Golomb code longer than 20 "
                                         "bits")
                for _ in range(length - 1):
                    x = (x << 1) + ec.bit()
                level += x - 1
            if c == 0:
                dc_val = -level if sign else level
            if signed is not None:
                signed[pos] = -level if sign else level
            level &= 0xFFFFF
            cul += level
            dqv = dq_ac if pos else dq_dc
            if iqm is not None:
                dqv = (int(iqm[pos]) * dqv + 16) >> 5
            dq = ((level * dqv) & 0xFFFFFF) >> dq_shift
            coef[pos] = clip3(-coef_max - 1, coef_max, -dq if sign else dq)
        cul = min(cul, 63)
        if dc_val < 0:
            cul |= 1 << 6
        elif dc_val > 0:
            cul += 2 << 6
    for k in range(w4):
        a[x4 + k] = cul if x4 + k < max_x4 else 0
    for k in range(h4):
        lctx[lbase + k] = cul if y4 + k < max_y4 else 0
    if plane == 0:
        f.tx_type[y4:y4 + h4, x4:x4 + w4] = tx_type
    if signed is not None:
        t.record[-1]["coeffs"][plane].append((tx_type, signed) if eob
                                             else None)
    return eob, tx_type, coef


def _read_delta(t: _Tile, cdf: list) -> int:
    abs_v = t.ec.symbol(cdf, 4)
    if abs_v == 3:
        n = t.ec.literal(3) + 1
        abs_v = t.ec.literal(n) + (1 << n) + 1
    if abs_v:
        return -abs_v if t.ec.bit() else abs_v
    return 0


# The segment features read in an intra frame (the others, SEG_LVL_ALT_LF_*
# at 1 + i for filter level i, follow SEG_LVL_ALT_Q).
SEG_LVL_ALT_Q, SEG_LVL_ALT_LF_Y_V, SEG_LVL_SKIP = 0, 1, 6


def _seg_feature(h, segment: int, feature: int) -> bool:
    return bool(h.segmentation and h.seg_mask[segment] >> feature & 1)


def _block_qindex(t: _Tile) -> int:
    """get_qindex(0, segment_id): the block's qindex for
    dequantisation."""
    h = t.f.h
    if _seg_feature(h, t.segment_id, SEG_LVL_ALT_Q):
        return clip3(0, 255, t.current_q
                     + h.seg_data[t.segment_id][SEG_LVL_ALT_Q])
    return t.current_q


def neg_deinterleave(diff: int, ref: int, most: int) -> int:
    """libaom's av1_neg_deinterleave."""
    if not ref:
        return diff
    if ref >= most - 1:
        return most - diff - 1
    if 2 * ref < most:
        if diff <= 2 * ref:
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return diff
    if diff <= 2 * (most - ref - 1):
        return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
    return most - (diff + 1)


def segment_prediction(t: _Tile) -> tuple[int, int]:
    """(context, predicted id) of the current block's segment id, from
    the above, left and above-left ids (libaom's
    av1_get_spatial_seg_pred)."""
    f = t.f
    r, c = t.mi_row, t.mi_col
    ul = int(f.seg_map[r - 1, c - 1]) if t.avail_u and t.avail_l else -1
    u = int(f.seg_map[r - 1, c]) if t.avail_u else -1
    lt = int(f.seg_map[r, c - 1]) if t.avail_l else -1
    ctx = 0 if ul < 0 else 2 if ul == u == lt else \
        1 if ul == u or ul == lt or u == lt else 0
    pred = (0 if lt == -1 else lt) if u == -1 else u if lt == -1 else \
        u if ul == u else lt
    return ctx, pred


def _read_segment_id(t: _Tile, skip: int) -> int:
    """read_segment_id of an intra frame: the predicted id, taken as is
    by a skipped block, else coded relative to it."""
    ctx, pred = segment_prediction(t)
    if skip:
        return pred
    last = t.f.h.seg_last_active
    coded = t.ec.symbol(t.cdf["spatial_seg"][ctx], 8)
    segment = neg_deinterleave(coded, pred, last + 1)
    if not 0 <= segment <= last:
        raise ValueError("AV1: a segment id past the last active segment "
                         "(libaom reports a corrupt frame)")
    return segment


def _mode_info(t: _Tile) -> None:
    f, cdf, ec, hdr = t.f, t.cdf, t.ec, t.f.h
    r, c = t.mi_row, t.mi_col
    t.segment_id = 0
    if hdr.segmentation and hdr.seg_preskip:
        t.segment_id = _read_segment_id(t, 0)
    if _seg_feature(hdr, t.segment_id, SEG_LVL_SKIP):
        t.skip = 1
    else:
        ctx = (int(f.skip[r - 1, c]) if t.avail_u else 0) + \
            (int(f.skip[r, c - 1]) if t.avail_l else 0)
        t.skip = ec.symbol(cdf["skip"][ctx], 2)
    if hdr.segmentation and not hdr.seg_preskip:
        t.segment_id = _read_segment_id(t, t.skip)
    t.lossless = hdr.seg_lossless[t.segment_id]
    if not t.skip and f.enable_cdef:  # read_cdef, per 64x64
        sb = f.cdef_idx
        if sb[r >> 4, c >> 4] == -1:
            sb[r >> 4, c >> 4] = ec.literal(hdr.cdef_bits)
            sb[r >> 4:(r + BH4[t.bsize]) >> 4,
               c >> 4:(c + BW4[t.bsize]) >> 4] = sb[r >> 4, c >> 4]
    if not (t.bsize == f.sb_size and t.skip) and t.read_deltas:
        d = _read_delta(t, cdf["delta_q"])
        if d:
            t.current_q = clip3(1, 255, t.current_q + (d << hdr.delta_q_res))
        if hdr.delta_lf_present:
            count = (4 if f.planes > 1 else 2) if hdr.delta_lf_multi else 1
            for i in range(count):
                d = _read_delta(t, cdf["delta_lf_multi"][i]
                                if hdr.delta_lf_multi else cdf["delta_lf"])
                if d:
                    t.delta_lf[i] = clip3(-63, 63, t.delta_lf[i]
                                          + (d << hdr.delta_lf_res))
    t.read_deltas = 0
    t.use_intrabc = ec.symbol(cdf["intrabc"], 2) if hdr.allow_intrabc else 0
    t.pal_size = [0, 0]
    t.pal_colors = [[0] * 8 for _ in range(3)]
    t.use_filter_intra = 0
    if t.use_intrabc:
        t.y_mode = t.uv_mode = DC_PRED
        t.angle_y = t.angle_uv = t.cfl_u = t.cfl_v = 0
        _read_dv(t)
        return
    above = int(f.y_mode[r - 1, c]) if t.avail_u else DC_PRED
    left = int(f.y_mode[r, c - 1]) if t.avail_l else DC_PRED
    t.y_mode = ec.symbol(
        cdf["kf_y"][INTRA_MODE_CTX[above]][INTRA_MODE_CTX[left]], 13)
    t.angle_y = _read_angle(t, t.y_mode)
    t.uv_mode, t.angle_uv, t.cfl_u, t.cfl_v = DC_PRED, 0, 0, 0
    bw, bh = 4 * BW4[t.bsize], 4 * BH4[t.bsize]
    if t.has_chroma:
        if t.lossless:  # libaom's is_cfl_allowed
            cfl_allowed = int(_t()["ss_size_lookup"][t.bsize][f.ssx][f.ssy]
                              == BLOCK_4X4)
        else:
            cfl_allowed = int(max(bw, bh) <= 32)
        t.uv_mode = ec.symbol(cdf["uv"][cfl_allowed][t.y_mode],
                              13 + cfl_allowed)
        if t.uv_mode == UV_CFL_PRED:
            signs = ec.symbol(cdf["cfl_sign"], 8)
            su, sv = (signs + 1) // 3, (signs + 1) % 3
            if su:
                v = 1 + ec.symbol(cdf["cfl_alpha"][(su - 1) * 3 + sv], 16)
                t.cfl_u = -v if su == 1 else v
            if sv:
                v = 1 + ec.symbol(cdf["cfl_alpha"][(sv - 1) * 3 + su], 16)
                t.cfl_v = -v if sv == 1 else v
        else:
            t.angle_uv = _read_angle(t, t.uv_mode)
    if t.bsize >= BLOCK_8X8 and bw <= 64 and bh <= 64 and hdr.screen_content:
        _palette_mode_info(t)
    if f.filter_intra and t.y_mode == DC_PRED and not t.pal_size[0] and \
            max(bw, bh) <= 32:
        t.use_filter_intra = ec.symbol(cdf["filter_intra"][t.bsize], 2)
        if t.use_filter_intra:
            t.filter_mode = ec.symbol(cdf["filter_intra_mode"], 5)


# --- intra block copy ------------------------------------------------------

REF_CAT_LEVEL, MAX_REF_MV_STACK_SIZE, INTRABC_DELAY_PIXELS = 640, 8, 256


def _dv_stack(t: _Tile) -> list:
    """libaom's setup_ref_mv_list for INTRA_FRAME: the DVs of the intra
    block copy neighbours, weighted, sorted and clamped."""
    f, r, c = t.f, t.mi_row, t.mi_col
    bw4, bh4 = BW4[t.bsize], BH4[t.bsize]
    stack: list = []
    processed = [0, 0]

    def add(rr: int, cc: int, weight: int) -> None:
        if not f.is_inter[rr, cc]:
            return
        mv = (int(f.mvs[rr, cc, 0]), int(f.mvs[rr, cc, 1]))
        for e in stack:
            if e[0] == mv:
                e[1] += weight
                return
        if len(stack) < MAX_REF_MV_STACK_SIZE:
            stack.append([mv, weight])

    row_adj = int(bh4 < 2 and r & 1)
    col_adj = int(bw4 < 2 and c & 1)
    max_row = max_col = 0
    if t.avail_u:
        max_row = (-4 if bh4 < 2 else -6) + row_adj
        max_row = clip3(t.row_start - r, t.row_end - r - 1, max_row)
    if t.avail_l:
        max_col = (-4 if bw4 < 2 else -6) + col_adj
        max_col = clip3(t.col_start - c, t.col_end - c - 1, max_col)

    def scan(off: int, vertical: bool) -> None:
        """scan_row_mbmi (vertical False) or scan_col_mbmi."""
        n4, pos = (bh4, r) if vertical else (bw4, c)
        end = min(n4, (f.mi_rows if vertical else f.mi_cols) - pos, 16)
        step = 0
        if abs(off) > 1:
            step = 1
            if (pos & 1) and n4 < 2:
                step = 0
        i = 0
        while i < end:
            rr, cc = (r + step + i, c + off) if vertical else \
                (r + off, c + step + i)
            cb = int(f.mi_size[rr, cc])
            along, across = (BH4[cb], BW4[cb]) if vertical else \
                (BW4[cb], BH4[cb])
            n = min(n4, along)
            if n4 >= 16:
                n = max(4, n)
            elif abs(off) > 1:
                n = max(n, 2)
            weight = 2
            if 2 <= n4 <= along:
                inc = min(-(max_col if vertical else max_row) + off + 1,
                          across)
                weight = max(weight, inc)
                processed[int(vertical)] = inc - off - 1
            add(rr, cc, n * weight)
            i += n

    if abs(max_row) >= 1:
        scan(-1, False)
    if abs(max_col) >= 1:
        scan(-1, True)
    if max(bw4, bh4) <= 16 and t.inside(r - 1, c + bw4) and \
            f.written[r - 1, c + bw4]:
        add(r - 1, c + bw4, 4)
    nearest = len(stack)
    for e in stack:
        e[1] += REF_CAT_LEVEL
    if t.inside(r - 1, c - 1):
        add(r - 1, c - 1, 4)
    for idx in (2, 3):
        row_off = -(idx << 1) + 1 + row_adj
        col_off = -(idx << 1) + 1 + col_adj
        if abs(row_off) <= abs(max_row) and abs(row_off) > processed[0]:
            scan(row_off, False)
        if abs(col_off) <= abs(max_col) and abs(col_off) > processed[1]:
            scan(col_off, True)
    for lo, hi in ((0, nearest), (nearest, len(stack))):  # bubble sorts
        n = hi
        while n > lo:
            last = lo
            for i in range(lo + 1, n):
                if stack[i - 1][1] < stack[i][1]:
                    stack[i - 1], stack[i] = stack[i], stack[i - 1]
                    last = i
            n = last
    out = []
    for (mr, mc), _ in stack:  # clamp_mv_ref
        bw, bh = 4 * bw4, 4 * bh4
        mc = clip3(-(c * 32) - bw * 8 - 128,
                   (f.mi_cols - bw4 - c) * 32 + bw * 8 + 128, mc)
        mr = clip3(-(r * 32) - bh * 8 - 128,
                   (f.mi_rows - bh4 - r) * 32 + bh * 8 + 128, mr)
        out.append((mr, mc))
    return out


def _read_mv_component(t: _Tile, comp: int) -> int:
    """read_mv_component at integer precision (MV_SUBPEL_NONE)."""
    ec, cdf = t.ec, t.cdf["dv_comp"][comp]
    sign = ec.symbol(cdf["sign"], 2)
    cls = ec.symbol(cdf["classes"], 11)
    if cls == 0:
        d, mag = ec.symbol(cdf["class0"], 2), 0
    else:
        d = 0
        for i in range(cls):
            d |= ec.symbol(cdf["bits"][i], 2) << i
        mag = 2 << (cls + 2)
    mag += (d << 3) + 8
    return -mag if sign else mag


def _read_dv(t: _Tile) -> None:
    """The block's DV (1/8 pel, whole pixels): the first non-zero of the
    stack's two first entries or the default one, plus the coded
    difference."""
    f = t.f
    stack = _dv_stack(t) + [(0, 0), (0, 0)]
    ref = stack[0] if stack[0] != (0, 0) else stack[1]
    if ref == (0, 0):
        if t.mi_row - f.sb4 < t.row_start:
            ref = (0, -(4 * f.sb4 + INTRABC_DELAY_PIXELS) * 8)
        else:
            ref = (-(4 * f.sb4) * 8, 0)
    ref = ((ref[0] >> 3) * 8, (ref[1] >> 3) * 8)
    joint = t.ec.symbol(t.cdf["dv_joints"], 4)
    dr = _read_mv_component(t, 0) if joint in (2, 3) else 0
    dc = _read_mv_component(t, 1) if joint in (1, 3) else 0
    t.mv = (((ref[0] + dr) >> 3) * 8, ((ref[1] + dc) >> 3) * 8)
    if not dv_valid(t.mv, t.mi_row, t.mi_col, BW4[t.bsize], BH4[t.bsize],
                    f.sb4, (t.row_start, t.row_end, t.col_start, t.col_end),
                    f.ssx, f.ssy, t.has_chroma):
        raise ValueError("AV1: an intra block copy DV points outside the "
                         "area libaom allows (libaom reports a corrupt "
                         "frame)")


def dv_valid(dv: tuple, mi_row: int, mi_col: int, bw4: int, bh4: int,
             sb4: int, tile: tuple, ssx: int, ssy: int,
             has_chroma: int) -> bool:
    """libaom's is_mv_valid and av1_is_dv_valid: a DV (1/8 sample) of the
    bw4 x bh4 block at (mi_row, mi_col) is valid when its source lies in
    the tile (row_start, row_end, col_start, col_end), whole, in a
    superblock decoded at least INTRABC_DELAY_PIXELS (four 64-wide
    superblocks) before the block's own and above its wavefront."""
    row_start, row_end, col_start, col_end = tile
    if any(not -(1 << 14) < v < 1 << 14 or v & 7 for v in dv):
        return False
    top, left = mi_row * 32 + dv[0], mi_col * 32 + dv[1]
    bottom, right = (mi_row + bh4) * 32 + dv[0], (mi_col + bw4) * 32 + dv[1]
    if top < row_start * 32 or left < col_start * 32 or \
            bottom > row_end * 32 or right > col_end * 32:
        return False
    if has_chroma and ((bw4 == 1 and ssx and left < (col_start + 1) * 32) or
                       (bh4 == 1 and ssy and top < (row_start + 1) * 32)):
        return False
    delay, sb_size = INTRABC_DELAY_PIXELS // 64, 4 * sb4
    active_row, active_col = mi_row // sb4, (mi_col * 4) >> 6
    src_row = ((bottom >> 3) - 1) // sb_size
    src_col = ((right >> 3) - 1) >> 6
    per_row = ((col_end - col_start - 1) >> 4) + 1
    if src_row * per_row + src_col >= active_row * per_row + active_col - delay:
        return False
    gradient = 1 + delay + (sb_size > 64)
    return src_row <= active_row and \
        src_col < active_col - delay + gradient * (active_row - src_row)


def intrabc_predict(src: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """The intra block copy prediction from src (h + 1 x w + 1 samples
    when the DV has a half-sample part, fy / fx 8, else h x w): the
    BILINEAR filter at half a sample, as libaom's
    av1_convolve_{2d,x,y}_sr_intrabc_c rounds it."""
    s = src.astype(np.int64)
    h, w = s.shape[0] - (fy > 0), s.shape[1] - (fx > 0)
    if fx and fy:
        return (s[:h, :w] + s[:h, 1:] + s[1:, :w] + s[1:, 1:] + 2) >> 2
    if fx:
        return (s[:h, :w] + s[:h, 1:] + 1) >> 1
    if fy:
        return (s[:h, :w] + s[1:, :w] + 1) >> 1
    return s


def _predict_intrabc(t: _Tile) -> None:
    """Each plane of the block copied from the frame so far."""
    f = t.f
    for plane in range(1 + 2 * t.has_chroma):
        sx, sy = (f.ssx, f.ssy) if plane else (0, 0)
        bw, bh = 4 * BW4[t.bsize], 4 * BH4[t.bsize]
        x0 = (t.mi_col * 4 - (4 if bw == 4 and sx else 0)) >> sx
        y0 = (t.mi_row * 4 - (4 if bh == 4 and sy else 0)) >> sy
        w, h = max(4, bw >> sx), max(4, bh >> sy)
        qr, qc = t.mv[0] << (1 - sy), t.mv[1] << (1 - sx)  # 1/16 sample
        fy, fx = qr & 15, qc & 15
        ys, xs = y0 + (qr >> 4), x0 + (qc >> 4)
        fr = f.frame[plane]
        if ys < 0 or xs < 0 or ys + h + (fy > 0) > fr.shape[0] or \
                xs + w + (fx > 0) > fr.shape[1]:
            raise ValueError("AV1: an intra block copy DV points outside the "
                             "frame (libaom reports a corrupt frame)")
        src = fr[ys:ys + h + (fy > 0), xs:xs + w + (fx > 0)].copy()
        fr[y0:y0 + h, x0:x0 + w] = intrabc_predict(src, fy, fx)


def _txfm_partition_ctx(above: int, left: int, bsize: int, tx: int) -> int:
    """libaom's txfm_partition_context."""
    if tx == TX_4X4:
        return 0
    dim = max(BW4[bsize], BH4[bsize]) * 4
    max_tx = 4 if dim >= 64 else {32: 3, 16: 2, 8: 1}[dim]
    cat = int(TX_SQR_UP[tx] != max_tx and max_tx > TX_8X8) + (4 - max_tx) * 2
    return cat * 3 + int(above < 1 << TX_WLOG2[tx]) + \
        int(left < 1 << TX_HLOG2[tx])


def _set_txfm_ctx(t: _Tile, row: int, col: int, w4: int, h4: int,
                  tw: int, th: int) -> None:
    """The transform-size contexts (sample widths above, heights left)
    over w4 x h4 4x4 units at (row, col) of the block."""
    m = t.f.sb4 - 1
    for i in range(w4):
        t.above_txfm[t.mi_col + col + i] = tw
    for i in range(h4):
        t.left_txfm[(t.mi_row + row + i) & m] = th


def _read_var_tx(t: _Tile, tx: int, depth: int, row: int, col: int) -> None:
    """read_tx_size_vartx: the transform tree of an intra block copy
    block, into t.inter_tx (per 4x4 unit of the block)."""
    f = t.f
    if row >= min(BH4[t.bsize], f.mi_rows - t.mi_row) or \
            col >= min(BW4[t.bsize], f.mi_cols - t.mi_col):
        return
    w4, h4 = 1 << (TX_WLOG2[tx] - 2), 1 << (TX_HLOG2[tx] - 2)
    leaf, ctx_tx = tx, tx
    if depth < 2:
        ctx = _txfm_partition_ctx(t.above_txfm[t.mi_col + col],
                                  t.left_txfm[(t.mi_row + row) & (f.sb4 - 1)],
                                  t.bsize, tx)
        if t.ec.symbol(t.cdf["txfm_partition"][ctx], 2):
            sub = SPLIT_TX[tx]
            if sub != TX_4X4:
                sw, sh = 1 << (TX_WLOG2[sub] - 2), 1 << (TX_HLOG2[sub] - 2)
                for rr in range(0, h4, sh):
                    for cc in range(0, w4, sw):
                        _read_var_tx(t, sub, depth + 1, row + rr, col + cc)
                return
            leaf, ctx_tx = TX_4X4, TX_4X4
    t.inter_tx[row:row + h4, col:col + w4] = leaf
    t.tx_size = leaf
    _set_txfm_ctx(t, row, col, w4, h4, 1 << TX_WLOG2[ctx_tx],
                  1 << TX_HLOG2[ctx_tx])


def _inter_luma_tree(t: _Tile, tx: int, row: int, col: int) -> None:
    """decode_reconstruct_tx on luma: the leaves of the tree in order."""
    f = t.f
    max_h = min(BH4[t.bsize], f.mi_rows - t.mi_row)
    max_w = min(BW4[t.bsize], f.mi_cols - t.mi_col)
    if row >= max_h or col >= max_w:
        return
    if t.inter_tx[row, col] == tx:
        _transform_block(t, 0, t.mi_col * 4, t.mi_row * 4, tx, col, row)
        return
    sub = SPLIT_TX[tx]
    sw, sh = 1 << (TX_WLOG2[sub] - 2), 1 << (TX_HLOG2[sub] - 2)
    for rr in range(0, min(1 << (TX_HLOG2[tx] - 2), max_h - row), sh):
        for cc in range(0, min(1 << (TX_WLOG2[tx] - 2), max_w - col), sw):
            _inter_luma_tree(t, sub, row + rr, col + cc)


# --- palette -----------------------------------------------------------------


def _ceil_log2(n: int) -> int:
    return 0 if n < 2 else (n - 1).bit_length()


def _palette_cache(t: _Tile, plane: int) -> list:
    """libaom's av1_get_palette_cache: the above (within this 64-row
    superblock row) and left neighbours' colours, merged and unique."""
    f, r, c = t.f, t.mi_row, t.mi_col
    p = int(plane > 0)
    colours = []
    if t.avail_u and r % 16:
        colours += f.pal_colors[r - 1, c, plane, :f.pal_size[r - 1, c, p]]\
            .tolist()
    if t.avail_l:
        colours += f.pal_colors[r, c - 1, plane, :f.pal_size[r, c - 1, p]]\
            .tolist()
    return sorted(set(colours))


def _palette_colours(t: _Tile, plane: int, n: int) -> list:
    """The Y (plane 0) or U colours of a palette: those taken from the
    cache, then a literal of bd bits and deltas of bd - 3 bits or more
    (at least 1 apart for Y), sorted."""
    ec, bd = t.ec, t.f.bd
    cached = []
    for v in _palette_cache(t, plane):
        if len(cached) >= n:
            break
        if ec.bit():
            cached.append(v)
    coded = []
    if len(cached) < n:
        coded.append(ec.literal(bd))
        if len(cached) + 1 < n:
            step = 1 if plane == 0 else 0
            bits = bd - 3 + ec.literal(2)
            room = (1 << bd) - coded[0] - step
            while len(cached) + len(coded) < n:
                v = min(coded[-1] + ec.literal(bits) + step, (1 << bd) - 1)
                room -= v - coded[-1]
                coded.append(v)
                bits = min(bits, _ceil_log2(room))
    return sorted(cached + coded)


def _palette_mode_info(t: _Tile) -> None:
    f, cdf, ec = t.f, t.cdf, t.ec
    r, c = t.mi_row, t.mi_col
    bctx = MI_WLOG2[t.bsize] + MI_HLOG2[t.bsize] - 2
    if t.y_mode == DC_PRED:
        ctx = (int(f.pal_size[r - 1, c, 0] > 0) if t.avail_u else 0) + \
            (int(f.pal_size[r, c - 1, 0] > 0) if t.avail_l else 0)
        if ec.symbol(cdf["palette_y_mode"][bctx][ctx], 2):
            n = ec.symbol(cdf["palette_y_size"][bctx], 7) + 2
            t.pal_size[0] = n
            t.pal_colors[0][:n] = _palette_colours(t, 0, n)
    if t.has_chroma and t.uv_mode == DC_PRED and \
            ec.symbol(cdf["palette_uv_mode"][int(t.pal_size[0] > 0)], 2):
        n = ec.symbol(cdf["palette_uv_size"][bctx], 7) + 2
        t.pal_size[1] = n
        t.pal_colors[1][:n] = _palette_colours(t, 1, n)
        bd = f.bd
        if ec.bit():  # V by deltas, modulo 2^bd
            bits = bd - 4 + ec.literal(2)
            v = [ec.literal(bd)]
            for _ in range(1, n):
                d = ec.literal(bits)
                if d and ec.bit():
                    d = -d
                v.append((v[-1] + d) % (1 << bd))
        else:
            v = [ec.literal(bd) for _ in range(n)]
        t.pal_colors[2][:n] = v


def palette_color_context(colour_map, r: int, c: int, n: int):
    """libaom's av1_get_palette_color_index_context: (the context, the
    colour order) of entry (r, c) from its left, top-left and top
    neighbours."""
    scores = [0] * 8
    for (dr, dc), weight in (((0, -1), 2), ((-1, -1), 1), ((-1, 0), 2)):
        if r + dr >= 0 and c + dc >= 0:
            scores[int(colour_map[r + dr][c + dc])] += weight
    order = list(range(8))
    for i in range(3):
        best, best_i = scores[i], i
        for j in range(i + 1, n):
            if scores[j] > best:
                best, best_i = scores[j], j
        if best_i != i:
            s, o = scores[best_i], order[best_i]
            for k in range(best_i, i, -1):
                scores[k], order[k] = scores[k - 1], order[k - 1]
            scores[i], order[i] = s, o
    h = scores[0] + 2 * scores[1] + 2 * scores[2]
    return _t()["palette_color_index_context_lookup"][h], order


def _palette_tokens(t: _Tile) -> None:
    """The colour-index maps, in wavefront order (palette_tokens)."""
    f, ec = t.f, t.ec
    bw, bh = 4 * BW4[t.bsize], 4 * BH4[t.bsize]
    on_w = min(bw, (f.mi_cols - t.mi_col) * 4)
    on_h = min(bh, (f.mi_rows - t.mi_row) * 4)
    t.colour_map = [None, None]
    for p in range(2):
        n = t.pal_size[p]
        if not n:
            continue
        w, h, ow, oh = bw, bh, on_w, on_h
        if p:
            w, h, ow, oh = w >> f.ssx, h >> f.ssy, ow >> f.ssx, oh >> f.ssy
            if w < 4:
                w, ow = w + 2, ow + 2
            if h < 4:
                h, oh = h + 2, oh + 2
        m = np.zeros((h, w), np.int64)
        m[0, 0] = ec.uniform(n)
        cdf = t.cdf["palette_uv_color" if p else "palette_y_color"][n - 2]
        for i in range(1, oh + ow - 1):
            for j in range(min(i, ow - 1), max(0, i - oh + 1) - 1, -1):
                ctx, order = palette_color_context(m, i - j, j, n)
                m[i - j, j] = order[ec.symbol(cdf[ctx], n)]
        m[:oh, ow:] = m[:oh, ow - 1:ow]
        m[oh:] = m[oh - 1]
        t.colour_map[p] = m


def _read_angle(t: _Tile, mode: int) -> int:
    if t.bsize < BLOCK_8X8 or not _is_directional(mode):
        return 0
    return t.ec.symbol(t.cdf["angle_delta"][mode - V_PRED], 7) - 3


def _read_tx_size(t: _Tile) -> None:
    f = t.f
    r, c = t.mi_row, t.mi_col
    max_rect = _t()["max_txsize_rect_lookup"][t.bsize]
    t.tx_size = TX_4X4 if t.lossless else max_rect
    bw4, bh4 = BW4[t.bsize], BH4[t.bsize]
    t.inter_tx = None
    if t.use_intrabc:
        t.inter_tx = np.full((bh4, bw4), t.tx_size, np.int64)
        if f.h.tx_mode_select and t.bsize > BLOCK_4X4 and not t.skip \
                and not t.lossless:
            for row in range(0, bh4, 1 << (TX_HLOG2[max_rect] - 2)):
                for col in range(0, bw4, 1 << (TX_WLOG2[max_rect] - 2)):
                    _read_var_tx(t, max_rect, 0, row, col)
            return
    elif t.bsize > BLOCK_4X4 and f.h.tx_mode_select and not t.lossless:
        def ctx_side(rr, cc, avail, wide):
            if not avail:
                return 0
            if f.is_inter[rr, cc]:  # an intra block copy: its size
                b = int(f.mi_size[rr, cc])
                return 4 * (BW4[b] if wide else BH4[b])
            return 1 << (TX_WLOG2 if wide else TX_HLOG2)[f.tx_size[rr, cc]]
        aw = ctx_side(r - 1, c, t.avail_u, True)
        lh = ctx_side(r, c - 1, t.avail_l, False)
        ctx = int(aw >= 1 << TX_WLOG2[max_rect]) + \
            int(lh >= 1 << TX_HLOG2[max_rect])
        depth_max = MAX_TX_DEPTH[t.bsize]
        depth = t.ec.symbol(t.cdf["tx_size"][depth_max - 1][ctx],
                            3 if depth_max > 1 else 2)
        for _ in range(depth):
            t.tx_size = SPLIT_TX[t.tx_size]
    if t.use_intrabc and t.skip:  # set_txfm_ctxs: the block's size
        _set_txfm_ctx(t, 0, 0, bw4, bh4, 4 * bw4, 4 * bh4)
    else:
        _set_txfm_ctx(t, 0, 0, bw4, bh4, 1 << TX_WLOG2[t.tx_size],
                      1 << TX_HLOG2[t.tx_size])


def _uv_tx_size(bsize: int, ssx: int, ssy: int) -> int:
    tb = _t()
    uvtx = tb["max_txsize_rect_lookup"][tb["ss_size_lookup"][bsize][ssx][ssy]]
    w, h = 1 << TX_WLOG2[uvtx], 1 << TX_HLOG2[uvtx]
    if w == 64 or h == 64:
        return TX_16X32 if w == 16 else TX_32X16 if h == 16 else TX_32X32
    return uvtx


def _transform_block(t: _Tile, plane: int, base_x: int, base_y: int,
                     tx: int, x: int, y: int) -> None:
    f = t.f
    sx = f.ssx if plane else 0
    sy = f.ssy if plane else 0
    start_x, start_y = base_x + 4 * x, base_y + 4 * y
    row, col = (start_y << sy) >> 2, (start_x << sx) >> 2
    dr, dc = (row & (f.sb4 - 1)) >> sy, (col & (f.sb4 - 1)) >> sx
    step_x, step_y = 1 << (TX_WLOG2[tx] - 2), 1 << (TX_HLOG2[tx] - 2)
    if start_x >= (f.mi_cols * 4) >> sx or start_y >= (f.mi_rows * 4) >> sy:
        return
    is_cfl = plane > 0 and t.uv_mode == UV_CFL_PRED
    mode = t.y_mode if plane == 0 else DC_PRED if is_cfl else t.uv_mode
    dec = t.decoded[plane]
    if t.use_intrabc:
        pass  # predicted for the whole block
    elif t.pal_size[int(plane > 0)]:
        w, h = 1 << TX_WLOG2[tx], 1 << TX_HLOG2[tx]
        m = t.colour_map[int(plane > 0)][4 * y:4 * y + h, 4 * x:4 * x + w]
        f.frame[plane][start_y:start_y + h, start_x:start_x + w] = \
            np.array(t.pal_colors[plane])[m]
    else:
        _predict_intra(
            t, plane, start_x, start_y,
            (t.avail_l if plane == 0 else t.avail_l_chroma) or x > 0,
            (t.avail_u if plane == 0 else t.avail_u_chroma) or y > 0,
            dec[dr][dc + step_x + 1], dec[dr + step_y + 1][dc], mode,
            TX_WLOG2[tx], TX_HLOG2[tx])
    if is_cfl:
        _predict_cfl(t, plane, start_x, start_y, tx)
    if plane == 0 and not t.use_intrabc:
        t.max_luma_w = start_x + step_x * 4
        t.max_luma_h = start_y + step_y * 4
    if not t.skip:
        eob, tx_type, coef = _read_coeffs(t, plane, start_x >> 2,
                                          start_y >> 2, tx)
        if eob > 0:
            w, h = 1 << TX_WLOG2[tx], 1 << TX_HLOG2[tx]
            dst = f.frame[plane][start_y:start_y + h, start_x:start_x + w]
            if t.lossless:
                iwht_add(coef, dst, f.bd)
            else:
                inverse_transform_add(coef, tx, tx_type, dst, f.bd)
    f.lf_txsz[plane][row >> sy:(row >> sy) + step_y,
                     col >> sx:(col >> sx) + step_x] = tx
    for i in range(step_y):
        for j in range(step_x):
            dec[dr + i + 1][dc + j + 1] = 1


def _residual(t: _Tile) -> None:
    f = t.f
    tb = _t()
    bw4, bh4 = BW4[t.bsize], BH4[t.bsize]
    for cy in range(max(1, bh4 >> 4)):
        for cx in range(max(1, bw4 >> 4)):
            if t.use_intrabc:  # luma: the transform tree
                tx = _t()["max_txsize_rect_lookup"][t.bsize]
                if t.lossless:
                    tx = TX_4X4
                sw, sh = 1 << (TX_WLOG2[tx] - 2), 1 << (TX_HLOG2[tx] - 2)
                for y in range(cy << 4, min(bh4, (cy + 1) << 4), sh):
                    for x in range(cx << 4, min(bw4, (cx + 1) << 4), sw):
                        _inter_luma_tree(t, tx, y, x)
            for plane in range(int(t.use_intrabc), 1 + 2 * t.has_chroma):
                tx = TX_4X4 if t.lossless else _uv_tx_size(
                    t.bsize, f.ssx, f.ssy) if plane else t.tx_size
                step_x = 1 << (TX_WLOG2[tx] - 2)
                step_y = 1 << (TX_HLOG2[tx] - 2)
                sx = f.ssx if plane else 0
                sy = f.ssy if plane else 0
                pbs = tb["ss_size_lookup"][t.bsize][sx][sy] if plane \
                    else t.bsize
                base_x = (t.mi_col >> sx) * 4
                base_y = (t.mi_row >> sy) * 4
                for y in range(0, min(BH4[pbs], 16 >> sy), step_y):
                    for x in range(0, min(BW4[pbs], 16 >> sx), step_x):
                        _transform_block(t, plane, base_x, base_y, tx,
                                         x + ((cx << 4) >> sx),
                                         y + ((cy << 4) >> sy))


def _decode_block(t: _Tile, r: int, c: int, bsize: int) -> None:
    f = t.f
    t.mi_row, t.mi_col, t.bsize = r, c, bsize
    bw4, bh4 = BW4[bsize], BH4[bsize]
    if bh4 == 1 and f.ssy and (r & 1) == 0:
        t.has_chroma = 0
    elif bw4 == 1 and f.ssx and (c & 1) == 0:
        t.has_chroma = 0
    else:
        t.has_chroma = int(f.planes > 1)
    t.avail_u = t.inside(r - 1, c)
    t.avail_l = t.inside(r, c - 1)
    t.avail_u_chroma, t.avail_l_chroma = t.avail_u, t.avail_l
    if t.has_chroma:
        if f.ssy and bh4 == 1:
            t.avail_u_chroma = t.inside(r - 2, c)
        if f.ssx and bw4 == 1:
            t.avail_l_chroma = t.inside(r, c - 2)
    _mode_info(t)
    _palette_tokens(t)
    _read_tx_size(t)
    if t.use_intrabc:
        _predict_intrabc(t)
    if t.skip:
        for plane in range(1 + 2 * t.has_chroma):
            sx = f.ssx if plane else 0
            sy = f.ssy if plane else 0
            for i in range(c >> sx, (c + bw4) >> sx):
                t.above_ctx[plane][i] = 0
            for i in range(r >> sy, (r + bh4) >> sy):
                t.left_ctx[plane][i & ((f.sb4 >> sy) - 1)] = 0
    r1, c1 = min(r + bh4, f.mi_rows), min(c + bw4, f.mi_cols)
    f.y_mode[r:r1, c:c1] = t.y_mode
    f.uv_mode[r:r1, c:c1] = t.uv_mode
    f.skip[r:r1, c:c1] = t.skip
    f.tx_size[r:r1, c:c1] = t.tx_size
    f.mi_size[r:r1, c:c1] = bsize
    f.seg_map[r:r1, c:c1] = t.segment_id
    f.delta_lf[r:r1, c:c1] = t.delta_lf
    f.pal_size[r:r1, c:c1] = t.pal_size
    f.pal_colors[r:r1, c:c1] = t.pal_colors
    f.is_inter[r:r1, c:c1] = t.use_intrabc
    f.mvs[r:r1, c:c1] = t.mv if t.use_intrabc else (0, 0)
    f.written[r:r1, c:c1] = True
    if t.record is not None:
        t.record.append({"r": r, "c": c, "bsize": bsize, "y_mode": t.y_mode,
                         "uv_mode": t.uv_mode, "angles": (t.angle_y,
                                                          t.angle_uv),
                         "tx": t.tx_size, "q": t.current_q,
                         "coeffs": [[], [], []]})
    _residual(t)


def _cdf_prob(icdf: list, e: int) -> int:
    return (icdf[e - 1] if e > 0 else 32768) - icdf[e]


def _decode_partition(t: _Tile, r: int, c: int, bsize: int) -> None:
    f = t.f
    if r >= f.mi_rows or c >= f.mi_cols:
        return
    num4 = BW4[bsize]
    half, quarter = num4 >> 1, num4 >> 2
    has_rows = (r + half) < f.mi_rows
    has_cols = (c + half) < f.mi_cols
    if bsize < BLOCK_8X8:
        partition = PARTITION_NONE
    else:
        bsl = MI_WLOG2[bsize]
        above = t.inside(r - 1, c) and MI_WLOG2[f.mi_size[r - 1, c]] < bsl
        left = t.inside(r, c - 1) and MI_HLOG2[f.mi_size[r, c - 1]] < bsl
        cdf = t.cdf["partition"][(bsl - 1) * 4 + 2 * left + above]
        nsym = 4 if bsl == 1 else 8 if bsl == 5 else 10
        if has_rows and has_cols:
            partition = t.ec.symbol(cdf, nsym)
        elif has_rows:
            p = 32768 - sum(_cdf_prob(cdf, e) for e in (
                PARTITION_HORZ, PARTITION_SPLIT, PARTITION_HORZ_A,
                PARTITION_HORZ_B, PARTITION_VERT_A))
            if bsize != BLOCK_128X128:
                p -= _cdf_prob(cdf, PARTITION_HORZ_4)
            partition = PARTITION_SPLIT if t.ec.decode_cdf(
                [32768 - p, 0], 2) else PARTITION_VERT
        elif has_cols:
            p = 32768 - sum(_cdf_prob(cdf, e) for e in (
                PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
                PARTITION_VERT_A, PARTITION_VERT_B))
            if bsize != BLOCK_128X128:
                p -= _cdf_prob(cdf, PARTITION_VERT_4)
            partition = PARTITION_SPLIT if t.ec.decode_cdf(
                [32768 - p, 0], 2) else PARTITION_HORZ
        else:
            partition = PARTITION_SPLIT
    sub_h = bsize_of(num4, max(num4 // 2, 1)) if num4 > 1 else bsize
    sub_v = bsize_of(max(num4 // 2, 1), num4) if num4 > 1 else bsize
    split = bsize_of(half, half) if half else bsize
    B = _decode_block
    if partition == PARTITION_NONE:
        B(t, r, c, bsize)
    elif partition == PARTITION_HORZ:
        B(t, r, c, sub_h)
        if has_rows:
            B(t, r + half, c, sub_h)
    elif partition == PARTITION_VERT:
        B(t, r, c, sub_v)
        if has_cols:
            B(t, r, c + half, sub_v)
    elif partition == PARTITION_SPLIT:
        for dr, dc in ((0, 0), (0, half), (half, 0), (half, half)):
            _decode_partition(t, r + dr, c + dc, split)
    elif partition == PARTITION_HORZ_A:
        B(t, r, c, split)
        B(t, r, c + half, split)
        B(t, r + half, c, sub_h)
    elif partition == PARTITION_HORZ_B:
        B(t, r, c, sub_h)
        B(t, r + half, c, split)
        B(t, r + half, c + half, split)
    elif partition == PARTITION_VERT_A:
        B(t, r, c, split)
        B(t, r + half, c, split)
        B(t, r, c + half, sub_v)
    elif partition == PARTITION_VERT_B:
        B(t, r, c, sub_v)
        B(t, r, c + half, split)
        B(t, r + half, c + half, split)
    elif partition == PARTITION_HORZ_4:
        b = bsize_of(num4, quarter)
        for i in range(4):
            if i < 3 or r + quarter * 3 < f.mi_rows:
                B(t, r + quarter * i, c, b)
    else:
        b = bsize_of(quarter, num4)
        for i in range(4):
            if i < 3 or c + quarter * 3 < f.mi_cols:
                B(t, r, c + quarter * i, b)


def _clear_block_decoded(t: _Tile, r: int, c: int) -> None:
    f = t.f
    for plane in range(f.planes):
        sx = f.ssx if plane else 0
        sy = f.ssy if plane else 0
        sbw4, sbh4 = (t.col_end - c) >> sx, (t.row_end - r) >> sy
        dec = t.decoded[plane]
        for y in range(-1, (f.sb4 >> sy) + 1):
            for x in range(-1, (f.sb4 >> sx) + 1):
                dec[y + 1][x + 1] = int((y < 0 and x < sbw4)
                                        or (x < 0 and y < sbh4))
        dec[(f.sb4 >> sy) + 1][0] = 0


def _decode_tile(t: _Tile, data: bytes) -> None:
    f = t.f
    t.ec = SymbolDecoder(data, not f.h.disable_cdf_update)
    t.cdf = init_cdfs(f.h.base_q)
    for p in range(f.planes):
        t.above_ctx[p] = [0] * (f.mi_cols + 64)
    t.delta_lf = [0, 0, 0, 0]
    t.current_q = f.h.base_q
    # the previous unit's coefficients: Wiener (vertical, horizontal) and
    # self-guided, each plane from its defaults
    t.ref_wiener = [[list(WIENER_MID), list(WIENER_MID)] for _ in range(3)]
    t.ref_sgr = [list(SGRPROJ_MID) for _ in range(3)]
    t.above_txfm = [64] * (f.mi_cols + 64)
    for r in range(t.row_start, t.row_end, f.sb4):
        t.left_ctx = [[0] * 32 for _ in range(3)]
        t.left_txfm = [64] * 32
        for c in range(t.col_start, t.col_end, f.sb4):
            t.read_deltas = f.h.delta_q_present
            _clear_block_decoded(t, r, c)
            _read_lr(t, r, c)
            _decode_partition(t, r, c, f.sb_size)
            if t.ec.overflowed():
                raise ValueError("AV1: a tile's symbols run past its data "
                                 "(libaom reports a corrupt frame)")
    if not t.ec.trailing_bits_ok():
        raise ValueError("AV1: a tile's data does not end in its trailing "
                         "bits (libaom reports a corrupt frame)")


# --- loop restoration: the coefficients ------------------------------------

RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = range(4)
# libaom's WIENER_FILT_TAP{0,1,2}_{MINV,MAXV,SUBEXP_K,MIDV} and
# SGRPROJ_PRJ_{MIN,MAX}{0,1}, SGRPROJ_PRJ_SUBEXP_K and the defaults.
WIENER_MIN, WIENER_MAX, WIENER_K = (-5, -23, -17), (10, 8, 46), (1, 2, 3)
WIENER_MID = (3, -7, 15)
SGRPROJ_MIN, SGRPROJ_MAX, SGRPROJ_K = (-96, -32), (31, 95), 4
SGRPROJ_MID = (-32, 31)


def lr_unit_count(size: int, length: int) -> int:
    """av1_lr_count_units: units of `size` over `length` samples, the
    last one up to half a unit longer."""
    return max((length + (size >> 1)) // size, 1)


def _subexp(ec: SymbolDecoder, n: int, k: int) -> int:
    """aom_read_primitive_subexpfin."""
    i = mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            return ec.uniform(n - mk) + mk
        if not ec.bit():
            return ec.literal(b) + mk
        i += 1
        mk += a


def _read_ref_subexp(ec: SymbolDecoder, lo: int, hi: int, k: int,
                     ref: int) -> int:
    """aom_read_primitive_refsubexpfin over [lo, hi], recentred on ref."""
    n, r = hi - lo + 1, ref - lo
    v = _subexp(ec, n, k)
    if (r << 1) <= n:
        out = _recenter(r, v)
    else:
        out = n - 1 - _recenter(n - 1 - r, v)
    return out + lo


def _recenter(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    return (v >> 1) + r if not v & 1 else r - ((v + 1) >> 1)


def _read_lr(t: _Tile, r: int, c: int) -> None:
    """read_lr: the units whose top-left corner lies in the superblock
    at (r, c)."""
    f, h = t.f, t.f.h
    for plane in range(f.planes):
        if not h.lr_type[plane]:
            continue
        sx, sy = (f.ssx, f.ssy) if plane else (0, 0)
        size = h.lr_unit_size[plane]
        units = f.lr_units[plane]
        r0 = (r * (4 >> sy) + size - 1) // size
        r1 = min(len(units), ((r + f.sb4) * (4 >> sy) + size - 1) // size)
        c0 = (c * (4 >> sx) + size - 1) // size
        c1 = min(len(units[0]), ((c + f.sb4) * (4 >> sx) + size - 1)
                 // size)
        for ur in range(r0, r1):
            for uc in range(c0, c1):
                units[ur][uc] = _read_lr_unit(t, plane)


def _read_lr_unit(t: _Tile, plane: int) -> tuple:
    ec, cdf, kind = t.ec, t.cdf, t.f.h.lr_type[plane]
    if kind == RESTORE_SWITCHABLE:
        kind = ec.symbol(cdf["switchable_restore"], 3)
    elif kind == RESTORE_WIENER:
        kind = RESTORE_WIENER if ec.symbol(cdf["wiener_restore"], 2) \
            else RESTORE_NONE
    else:
        kind = RESTORE_SGRPROJ if ec.symbol(cdf["sgrproj_restore"], 2) \
            else RESTORE_NONE
    if kind == RESTORE_WIENER:
        taps = []
        for pass_ in range(2):  # the vertical filter, then the horizontal
            ref = t.ref_wiener[plane][pass_]
            c = [0, 0, 0]
            for j in range(1 if plane else 0, 3):
                c[j] = _read_ref_subexp(ec, WIENER_MIN[j], WIENER_MAX[j],
                                        WIENER_K[j], ref[j])
            t.ref_wiener[plane][pass_] = c
            taps.append((c[0], c[1], c[2], -2 * sum(c), c[2], c[1], c[0]))
        return kind, tuple(taps)
    if kind == RESTORE_SGRPROJ:
        sgr_set = ec.literal(4)
        r0, r1 = (int(v) for v in _t()["sgr_params"][sgr_set][:2])
        ref = t.ref_sgr[plane]
        xqd = [0, 0]
        for i in range(2):
            if (r0, r1)[i]:
                xqd[i] = _read_ref_subexp(ec, SGRPROJ_MIN[i], SGRPROJ_MAX[i],
                                          SGRPROJ_K, ref[i])
            elif i == 1:
                xqd[1] = clip3(SGRPROJ_MIN[1], SGRPROJ_MAX[1], 128 - xqd[0])
        t.ref_sgr[plane] = xqd
        return kind, (sgr_set, tuple(xqd))
    return kind, None


# --- deblocking --------------------------------------------------------------


def _filter_level(f: _Frame, row: int, col: int, plane: int,
                  pass_: int) -> int:
    h = f.h
    i = pass_ if plane == 0 else plane + 1
    delta = 0
    if h.delta_lf_present:
        d = f.delta_lf[row, col]
        delta = int(d[i] if h.delta_lf_multi else d[0])
    lvl = clip3(0, 63, delta + h.lf_level[i])
    segment = int(f.seg_map[row, col])
    if _seg_feature(h, segment, SEG_LVL_ALT_LF_Y_V + i):
        lvl = clip3(0, 63, lvl + h.seg_data[segment][SEG_LVL_ALT_LF_Y_V + i])
    if h.lf_delta_enabled:
        lvl = clip3(0, 63, lvl + h.lf_ref_deltas[0] * (1 << (lvl >> 5)))
    return lvl


def _c8(x: int, o: int) -> int:
    """libaom's signed_char_clamp_high: x clamped to -o .. o - 1, o =
    2^(bd-1)."""
    return clip3(-o, o - 1, x)


def lf_edge(s: list, plane: int, limit: int, blimit: int, thresh: int,
            filter_size: int, bd: int = 8) -> list:
    """One line of samples across an edge (s[8] is q0, s[7] p0) filtered
    as the deblocking filter of that size filters it at bd bits; limit,
    blimit and thresh are at 8 bits' scale, shifted by bd - 8 here as
    libaom's highbd masks shift them, and highbd_filter4 offsets and
    clamps the samples by 2^(bd-1) (its own shifts stay those of 8
    bits). Returns the line."""
    sh = bd - 8
    limit, blimit, thresh, one, o = (limit << sh, blimit << sh, thresh << sh,
                                     1 << sh, 128 << sh)
    s = list(s)
    q = [s[8 + k] for k in range(7)]
    p = [s[7 - k] for k in range(7)]
    hev = abs(p[1] - p[0]) > thresh or abs(q[1] - q[0]) > thresh
    length = 4 if filter_size == 4 else 6 if plane else \
        8 if filter_size == 8 else 16
    mask = (abs(p[1] - p[0]) <= limit and abs(q[1] - q[0]) <= limit
            and abs(p[0] - q[0]) * 2 + abs(p[1] - q[1]) // 2 <= blimit)
    if length >= 6:
        mask = mask and abs(p[2] - p[1]) <= limit and \
            abs(q[2] - q[1]) <= limit
    if length >= 8:
        mask = mask and abs(p[3] - p[2]) <= limit and \
            abs(q[3] - q[2]) <= limit
    if not mask:
        return s
    flat = flat2 = False
    if filter_size >= 8:
        flat = (abs(p[1] - p[0]) <= one and abs(q[1] - q[0]) <= one
                and abs(p[2] - p[0]) <= one and abs(q[2] - q[0]) <= one)
        if length >= 8:
            flat = flat and abs(p[3] - p[0]) <= one and \
                abs(q[3] - q[0]) <= one
    if filter_size >= 16:
        flat2 = all(abs(p[k] - p[0]) <= one and abs(q[k] - q[0]) <= one
                    for k in (4, 5, 6))
    if filter_size == 4 or not flat:
        ps1, ps0, qs0, qs1 = p[1] - o, p[0] - o, q[0] - o, q[1] - o
        filt = _c8(ps1 - qs1, o) if hev else 0
        filt = _c8(filt + 3 * (qs0 - ps0), o)
        f1, f2 = _c8(filt + 4, o) >> 3, _c8(filt + 3, o) >> 3
        s[8] = _c8(qs0 - f1, o) + o
        s[7] = _c8(ps0 + f2, o) + o
        if not hev:
            ff = round2(f1, 1)
            s[9] = _c8(qs1 - ff, o) + o
            s[6] = _c8(ps1 + ff, o) + o
        return s
    log2size = 3 if (filter_size == 8 or not flat2) else 4
    n = 6 if log2size == 4 else 3 if plane == 0 else 2
    n2 = 0 if (log2size == 3 and plane == 0) else 1
    F = {k: s[8 + k] for k in range(-(n + 1), n + 1)}
    out = {}
    for i in range(-n, n):
        tot = 0
        for j in range(-n, n + 1):
            tot += F[clip3(-(n + 1), n, i + j)] * (2 if abs(j) <= n2 else 1)
        out[i] = round2(tot, log2size)
    for i in range(-n, n):
        s[8 + i] = out[i]
    return s


def _loop_filter(f: _Frame) -> None:
    h = f.h
    if not h.lf_level[0] and not h.lf_level[1]:
        return
    sharp = h.lf_sharpness
    for plane in range(f.planes):
        if plane > 0 and not h.lf_level[1 + plane]:
            continue
        sx = f.ssx if plane else 0
        sy = f.ssy if plane else 0
        fr, lt = f.frame[plane], f.lf_txsz[plane]
        for pass_ in range(2):
            for row0 in range(0, f.mi_rows, 1 << sy):
                for col0 in range(0, f.mi_cols, 1 << sx):
                    x, y = col0 * 4, row0 * 4
                    if x >= f.width or y >= f.height:
                        continue
                    if (pass_ == 0 and x == 0) or (pass_ == 1 and y == 0):
                        continue
                    row, col = row0 | sy, col0 | sx
                    xp, yp = x >> sx, y >> sy
                    dx, dy = int(pass_ == 0), int(pass_ == 1)
                    prow, pcol = row - (dy << sy), col - (dx << sx)
                    txsz = int(lt[row >> sy, col >> sx])
                    ptx = int(lt[prow >> sy, pcol >> sx])
                    if pass_ == 0:
                        if xp % (1 << TX_WLOG2[txsz]):
                            continue
                        base = min(1 << TX_WLOG2[ptx], 1 << TX_WLOG2[txsz])
                    else:
                        if yp % (1 << TX_HLOG2[txsz]):
                            continue
                        base = min(1 << TX_HLOG2[ptx], 1 << TX_HLOG2[txsz])
                    size = min(16, base) if plane == 0 else min(8, base)
                    lvl = _filter_level(f, row, col, plane, pass_) or \
                        _filter_level(f, prow, pcol, plane, pass_)
                    if not lvl:
                        continue
                    shift = 2 if sharp > 4 else 1 if sharp > 0 else 0
                    limit = clip3(1, 9 - sharp, lvl >> shift) if sharp > 0 \
                        else max(1, lvl >> shift)
                    blimit, thresh = 2 * (lvl + 2) + limit, lvl >> 4
                    for i in range(4):
                        if pass_ == 0:
                            yy, xs = yp + i, xp
                            lo, hi = max(0, xs - 8), xs + 8
                            line = [0] * 16
                            for k in range(lo, min(hi, fr.shape[1])):
                                line[k - xs + 8] = int(fr[yy, k])
                            out = lf_edge(line, plane, limit, blimit, thresh,
                                          size, f.bd)
                            for k in range(max(0, xs - 7), min(xs + 7,
                                                               fr.shape[1])):
                                fr[yy, k] = out[k - xs + 8]
                        else:
                            xx, ys = xp + i, yp
                            line = [0] * 16
                            for k in range(max(0, ys - 8), min(ys + 8,
                                                               fr.shape[0])):
                                line[k - ys + 8] = int(fr[k, xx])
                            out = lf_edge(line, plane, limit, blimit, thresh,
                                          size, f.bd)
                            for k in range(max(0, ys - 7), min(ys + 7,
                                                               fr.shape[0])):
                                fr[k, xx] = out[k - ys + 8]


# --- CDEF --------------------------------------------------------------------


def _cdef_dir_rc(d: int, k: int) -> tuple[int, int]:
    v = _t()["cdef_directions_padded"][d + 2][k]
    r = (v + 72 + 144 * 4) // 144 - 4
    return r, v - r * 144


def cdef_find_dir(img: np.ndarray, coeff_shift: int = 0) -> tuple[int, int]:
    """libaom's cdef_find_dir_c on an 8x8 block, its samples shifted down
    by coeff_shift = bd - 8: (direction, variance)."""
    cost = [0] * 8
    partial = [[0] * 15 for _ in range(8)]
    for i in range(8):
        for j in range(8):
            x = (int(img[i, j]) >> coeff_shift) - 128
            partial[0][i + j] += x
            partial[1][i + j // 2] += x
            partial[2][i] += x
            partial[3][3 + i - j // 2] += x
            partial[4][7 + i - j] += x
            partial[5][3 - i // 2 + j] += x
            partial[6][j] += x
            partial[7][i // 2 + j] += x
    for i in range(8):
        cost[2] += partial[2][i] ** 2
        cost[6] += partial[6][i] ** 2
    cost[2] *= DIV_TABLE[8]
    cost[6] *= DIV_TABLE[8]
    for i in range(7):
        cost[0] += (partial[0][i] ** 2 + partial[0][14 - i] ** 2) \
            * DIV_TABLE[i + 1]
        cost[4] += (partial[4][i] ** 2 + partial[4][14 - i] ** 2) \
            * DIV_TABLE[i + 1]
    cost[0] += partial[0][7] ** 2 * DIV_TABLE[8]
    cost[4] += partial[4][7] ** 2 * DIV_TABLE[8]
    for i in range(1, 8, 2):
        for j in range(5):
            cost[i] += partial[i][3 + j] ** 2
        cost[i] *= DIV_TABLE[8]
        for j in range(3):
            cost[i] += (partial[i][j] ** 2 + partial[i][10 - j] ** 2) \
                * DIV_TABLE[2 * j + 2]
    best, d = 0, 0
    for k in range(8):
        if cost[k] > best:
            best, d = cost[k], k
    return d, (best - cost[(d + 4) & 7]) >> 10


def _constrain(diff: int, threshold: int, damping: int) -> int:
    if not threshold:
        return 0
    adj = max(0, damping - (threshold.bit_length() - 1))
    v = min(abs(diff), max(0, threshold - (abs(diff) >> adj)))
    return -v if diff < 0 else v


def cdef_block(src: np.ndarray, y0: int, x0: int, w: int, h: int, pri: int,
               sec: int, damping: int, d: int, bounds: tuple,
               coeff_shift: int = 0) -> np.ndarray:
    """The w x h block at (y0, x0) of src filtered by CDEF (taps outside
    bounds = (rows, cols) are unavailable); pri, sec and damping are at
    the samples' scale (shifted by coeff_shift = bd - 8), the primary
    taps chosen by pri >> coeff_shift. Returns the block."""
    tb = _t()
    pri_taps = tb["cdef_pri_taps"][(pri >> coeff_shift) & 1]
    rows, cols = bounds
    out = np.zeros((h, w), np.int64)
    for i in range(h):
        for j in range(w):
            x = int(src[y0 + i, x0 + j])
            tot, mx, mn = 0, x, x
            for k in range(2):
                for sign in (-1, 1):
                    r, c = _cdef_dir_rc(d, k)
                    yy, xx = y0 + i + sign * r, x0 + j + sign * c
                    if 0 <= xx < cols and 0 <= yy < rows:
                        p = int(src[yy, xx])
                        tot += pri_taps[k] * _constrain(p - x, pri, damping)
                        mx, mn = max(mx, p), min(mn, p)
                    for off in (-2, 2):
                        r, c = _cdef_dir_rc((d + off) & 7, k)
                        yy, xx = y0 + i + sign * r, x0 + j + sign * c
                        if 0 <= xx < cols and 0 <= yy < rows:
                            s = int(src[yy, xx])
                            tot += tb["cdef_sec_taps"][k] * \
                                _constrain(s - x, sec, damping)
                            mx, mn = max(mx, s), min(mn, s)
            out[i, j] = clip3(mn, mx, x + ((8 + tot - (tot < 0)) >> 4))
    return out


# The chroma direction of a luma direction where the chroma planes are
# subsampled on one axis only (4:2:2; libaom's conv422 in
# av1_cdef_filter_fb).
CDEF_CONV422 = (7, 0, 2, 4, 5, 6, 6, 6)


def _cdef(f: _Frame) -> None:
    """CDEF over the frame (libaom's av1_cdef_filter_fb: the strengths
    shifted by coeff_shift = bd - 8 before the luma adjustment, the
    damping raised by it; 4x8 chroma blocks at 4:2:2, their direction
    mapped through CDEF_CONV422)."""
    h = f.h
    if not f.enable_cdef:
        return
    cs = f.bd - 8
    src = [p.copy() for p in f.frame]
    for r in range(0, f.mi_rows, 2):
        for c in range(0, f.mi_cols, 2):
            idx = int(f.cdef_idx[r >> 4, c >> 4])
            if idx == -1 or f.skip[r:r + 2, c:c + 2].all():
                continue
            d, var = cdef_find_dir(src[0][r * 4:r * 4 + 8, c * 4:c * 4 + 8],
                                   cs)
            pri, sec = h.cdef_y[idx]
            pri, sec = pri << cs, sec << cs
            vs = min((var >> 6).bit_length() - 1, 12) if var >> 6 else 0
            adj = (pri * (4 + vs) + 8) >> 4 if var else 0
            if pri or sec:
                f.frame[0][r * 4:r * 4 + 8, c * 4:c * 4 + 8] = cdef_block(
                    src[0], r * 4, c * 4, 8, 8, adj, sec, h.cdef_damping + cs,
                    d if pri else 0, (f.mi_rows * 4, f.mi_cols * 4), cs)
            if f.planes > 1:
                pri, sec = h.cdef_uv[idx]
                pri, sec = pri << cs, sec << cs
                if pri or sec:
                    y0, x0 = (r * 4) >> f.ssy, (c * 4) >> f.ssx
                    bh, bw = 8 >> f.ssy, 8 >> f.ssx
                    cd = CDEF_CONV422[d] if f.ssx != f.ssy else d
                    for p in (1, 2):
                        f.frame[p][y0:y0 + bh, x0:x0 + bw] = cdef_block(
                            src[p], y0, x0, bw, bh, pri, sec,
                            h.cdef_damping - 1 + cs, cd if pri else 0,
                            ((f.mi_rows * 4) >> f.ssy,
                             (f.mi_cols * 4) >> f.ssx), cs)


# --- loop restoration: the filters -----------------------------------------


def _samples(x: np.ndarray, bd: int) -> np.ndarray:
    """A filter's output as samples: uint8 at 8 bits, else uint16."""
    return x.astype(np.uint8 if bd == 8 else np.uint16)


def wiener_filter(src: np.ndarray, vfilter, hfilter,
                  bd: int = 8) -> np.ndarray:
    """The Wiener filter at bd bits (libaom's
    av1_highbd_wiener_convolve_add_src_c at get_conv_params_wiener(bd):
    InterRound0 and InterRound1 3 and 11, or 5 and 9 at 12 bits): src
    holds the block with 3 samples around it; returns the (h, w) block.
    The 7 taps of each filter sum to 0; the source sample is added at the
    centre (weight 128)."""
    r0, r1 = (5, 9) if bd == 12 else (3, 11)
    p = src.astype(np.int64)
    h, w = p.shape[0] - 6, p.shape[1] - 6
    acc = (p[:, 3:3 + w] << 7) + (1 << (bd + 6))
    for k in range(7):
        acc += int(hfilter[k]) * p[:, k:k + w]
    tmp = np.clip((acc + (1 << (r0 - 1))) >> r0, 0, (1 << (bd + 8 - r0)) - 1)
    acc = (tmp[3:3 + h] << 7) - (1 << (bd + r1 - 1))
    for k in range(7):
        acc += int(vfilter[k]) * tmp[k:k + h]
    return _samples(np.clip((acc + (1 << (r1 - 1))) >> r1, 0, (1 << bd) - 1),
                    bd)


def _box_ab(p: np.ndarray, h: int, w: int, r: int, s: int, bd: int = 8):
    """The self-guided filter's A and B at rows and columns -1 .. h, w
    of the block (src padded by 3), for radius r and scale s; at bd bits
    the sums of squares and of samples are rounded down by 2 (bd - 8) and
    bd - 8 bits for the variance, B takes the sum as it is."""
    tb = _t()
    n = (2 * r + 1) ** 2
    b = np.zeros((h + 2, w + 2), np.int64)
    a = np.zeros((h + 2, w + 2), np.int64)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            q = p[2 + dy:4 + h + dy, 2 + dx:4 + w + dx]
            b += q
            a += q * q
    sa, sb = 2 * (bd - 8), bd - 8
    a_s = (a + ((1 << sa) >> 1)) >> sa
    b_s = (b + ((1 << sb) >> 1)) >> sb
    pv = np.maximum(a_s * n - b_s * b_s, 0)
    z = ((pv * s + (1 << 19)) & 0xFFFFFFFF) >> 20  # uint32, as libaom
    aa = np.array(tb["x_by_xplus1"], np.int64)[np.minimum(z, 255)]
    bb = ((256 - aa) * b * tb["one_by_x"][n - 1] + (1 << 11)) >> 12
    return aa, bb


def sgr_filter(src: np.ndarray, sgr_set: int, xqd, bd: int = 8) -> np.ndarray:
    """The self-guided filter at bd bits (libaom's
    av1_apply_selfguided_restoration_c): src holds the block with 3
    samples around it; returns the (h, w) block."""
    p = src.astype(np.int64)
    h, w = p.shape[0] - 6, p.shape[1] - 6
    r0, r1, s0, s1 = (int(v) for v in _t()["sgr_params"][sgr_set])
    x = p[3:3 + h, 3:3 + w]
    u = x << 4
    v = u << 7
    if r0:  # radius 2, A and B on every other row
        a, b = _box_ab(p, h, w, r0, s0, bd)
        flt = np.empty((h, w), np.int64)
        for i in range(h):
            if i & 1:
                fa = a[i + 1, 1:w + 1] * 6 + (a[i + 1, :w] + a[i + 1, 2:]) * 5
                fb = b[i + 1, 1:w + 1] * 6 + (b[i + 1, :w] + b[i + 1, 2:]) * 5
                flt[i] = (fa * x[i] + fb + (1 << 7)) >> 8
            else:
                fa = (a[i, 1:w + 1] + a[i + 2, 1:w + 1]) * 6 + (
                    a[i, :w] + a[i, 2:] + a[i + 2, :w] + a[i + 2, 2:]) * 5
                fb = (b[i, 1:w + 1] + b[i + 2, 1:w + 1]) * 6 + (
                    b[i, :w] + b[i, 2:] + b[i + 2, :w] + b[i + 2, 2:]) * 5
                flt[i] = (fa * x[i] + fb + (1 << 8)) >> 9
        v = v + xqd[0] * (flt - u)
    if r1:  # radius 1
        a, b = _box_ab(p, h, w, r1, s1, bd)

        def cross(m):
            return (m[1:h + 1, 1:w + 1] + m[1:h + 1, :w] + m[1:h + 1, 2:]
                    + m[:h, 1:w + 1] + m[2:, 1:w + 1]) * 4 + (
                m[:h, :w] + m[:h, 2:] + m[2:, :w] + m[2:, 2:]) * 3
        flt = (cross(a) * x + cross(b) + (1 << 8)) >> 9
        xq1 = 128 - xqd[1] if not r0 else 128 - xqd[0] - xqd[1]
        v = v + xq1 * (flt - u)
    out = (v + (1 << 10)) >> 11
    out = ((out + 32768) & 0xFFFF) - 32768  # libaom's int16_t
    return _samples(np.clip(out, 0, (1 << bd) - 1), bd)


def _loop_restoration(f: _Frame, deblocked: list) -> None:
    """Each plane's units filtered in 64-row stripes offset by 8 (luma):
    rows above and below a stripe are the deblocked frame's (2 rows, the
    nearer repeated), the frame's own edges are repeated."""
    h = f.h
    for plane in range(f.planes):
        if not h.lr_type[plane]:
            continue
        sx, sy = (f.ssx, f.ssy) if plane else (0, 0)
        pw, ph = (f.width + sx) >> sx, (f.height + sy) >> sy
        size = h.lr_unit_size[plane]
        units = f.lr_units[plane]
        cdef_out = f.frame[plane][:ph, :pw].copy()
        before = deblocked[plane][:ph, :pw]
        cols = np.clip(np.arange(-3, pw + 3), 0, pw - 1)
        off, height = 8 >> sy, 64 >> sy
        for k in range(ph // height + 2):
            start = k * height - off  # StripeStartY (may be negative)
            y0, y1 = max(0, start), min(ph, start + height)
            if y0 >= ph:
                break
            rows = []
            for y in range(y0 - 3, y1 + 3):
                y = clip3(0, ph - 1, y)
                if y < start:
                    rows.append(before[max(start - 2, y)])
                elif y > start + height - 1:
                    rows.append(before[min(start + height + 1, y)])
                else:
                    rows.append(cdef_out[y])
            block = np.stack(rows)[:, cols]
            ur = min(len(units) - 1, (y0 + off) // size)
            for uc, (kind, coef) in enumerate(units[ur]):
                x0 = uc * size
                x1 = pw if uc == len(units[ur]) - 1 else x0 + size
                part = block[:, x0:x1 + 6]
                if kind == RESTORE_WIENER:
                    out = wiener_filter(part, coef[0], coef[1], f.bd)
                elif kind == RESTORE_SGRPROJ:
                    out = sgr_filter(part, *coef, f.bd)
                else:
                    continue
                f.frame[plane][y0:y1, x0:x1] = out


# --- film grain synthesis ---------------------------------------------------


class GrainRandom:
    """The film grain's 16-bit linear feedback shift register
    (get_random_number)."""

    def __init__(self, seed: int):
        self.r = seed & 0xFFFF

    def bits(self, n: int) -> int:
        r = self.r
        bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        self.r = (r >> 1) | (bit << 15)
        return (self.r >> (16 - n)) & ((1 << n) - 1)


def _white_grain(rng: GrainRandom, h: int, w: int, shift: int) -> np.ndarray:
    """h x w samples of Gaussian_Sequence drawn by `rng`, rounded down by
    `shift`."""
    gauss = table("gaussian_sequence")
    idx = [rng.bits(11) for _ in range(h * w)]
    g = gauss[np.array(idx, np.int64)].reshape(h, w)
    return (g + ((1 << shift) >> 1)) >> shift


def _auto_regress(grain: np.ndarray, coeffs, lag: int, shift: int,
                  lo: int, hi: int, luma=None, sub=(0, 0)) -> None:
    """The auto-regressive filter over grain[3:, 3:-3] in raster order, in
    place; `luma` (chroma only) adds the co-located luma grain averaged
    over the subsampled block as the last coefficient's input."""
    h, w = grain.shape
    ssx, ssy = sub
    taps = [(dr, dc) for dr in range(-lag, 1) for dc in range(-lag, lag + 1)
            if dr < 0 or dc < 0]
    above = [(k, dr, dc) for k, (dr, dc) in enumerate(taps) if dr < 0]
    left = [(k, dc) for k, (dr, dc) in enumerate(taps) if dr == 0]
    rnd = 1 << (shift - 1)
    for y in range(3, h):
        xs = slice(3, w - 3)
        base = np.zeros(w - 6, np.int64)
        for k, dr, dc in above:
            base += coeffs[k] * grain[y + dr, 3 + dc:w - 3 + dc]
        if luma is not None:
            ly = ((y - 3) << ssy) + 3
            lx = ((np.arange(3, w - 3) - 3) << ssx) + 3
            avg = sum(luma[ly + i, lx + j] for i in range(ssy + 1)
                      for j in range(ssx + 1))
            base += coeffs[len(taps)] * round2(avg, ssx + ssy)
        row = grain[y].tolist()
        for x in range(3, w - 3):
            total = int(base[x - 3])
            for k, dc in left:
                total += coeffs[k] * row[x + dc]
            row[x] = clip3(lo, hi, row[x] + ((total + rnd) >> shift))
        grain[y, xs] = row[3:w - 3]


def grain_templates(g, bd: int, ssx: int, ssy: int, mono: int) -> list:
    """The luma (73 x 82) and Cb and Cr (38 or 73 x 44 or 82) grain
    templates of film grain parameters `g` (`avif.FilmGrain`): seeded
    Gaussian noise through the auto-regressive filter; a plane with no
    grain is None."""
    lo, hi = -(128 << (bd - 8)), (128 << (bd - 8)) - 1
    shift = 12 - bd + g.grain_scale_shift
    luma = None
    if g.y_points:
        luma = _white_grain(GrainRandom(g.seed), 73, 82, shift)
        _auto_regress(luma, g.ar_y, g.ar_coeff_lag, g.ar_coeff_shift, lo, hi)
    out = [luma]
    ch, cw = (38 if ssy else 73), (44 if ssx else 82)
    for salt, points, coeffs in ((0xB524, g.cb_points, g.ar_cb),
                                 (0x49D8, g.cr_points, g.ar_cr)):
        if mono or not (points or g.chroma_scaling_from_luma):
            out.append(None)
            continue
        c = _white_grain(GrainRandom(g.seed ^ salt), ch, cw, shift)
        _auto_regress(c, coeffs, g.ar_coeff_lag, g.ar_coeff_shift, lo, hi,
                      luma, (ssx, ssy))
        out.append(c)
    return out


def scaling_lut(points) -> np.ndarray:
    """The 256-entry scaling function of (value, scaling) points (libaom's
    init_scaling_function)."""
    lut = np.zeros(256, np.int64)
    if not points:
        return lut
    lut[:points[0][0]] = points[0][1]
    for (x0, y0), (x1, y1) in zip(points, points[1:]):
        dx = x1 - x0
        delta = (y1 - y0) * ((65536 + (dx >> 1)) // dx)
        lut[x0:x1] = y0 + ((np.arange(dx) * delta + 32768) >> 16)
    lut[points[-1][0]:] = points[-1][1]
    return lut


def _scale(lut: np.ndarray, index: np.ndarray, bd: int) -> np.ndarray:
    """scale_lut: the function at a bd-bit index, interpolated between
    entries past 8 bits."""
    x = index >> (bd - 8)
    if bd == 8:
        return lut[x]
    frac = index & ((1 << (bd - 8)) - 1)
    nxt = lut[np.minimum(x + 1, 255)]
    v = lut[x] + (((nxt - lut[x]) * frac + (1 << (bd - 9))) >> (bd - 8))
    return np.where(x == 255, lut[x], v)


def _blend(old: np.ndarray, new: np.ndarray, weights, lo: int, hi: int):
    a, b = weights
    return np.clip((old * a + new * b + 16) >> 5, lo, hi)


def noise_images(g, templates: list, height: int, width: int, bd: int,
                 ssx: int, ssy: int) -> list:
    """The noise of each plane (None where it has no grain): 34x34 (luma)
    blocks of the templates at offsets drawn per 32x32 block from the
    stripe's generator, blended across block and stripe edges where
    `g.overlap` is set."""
    lo, hi = -(128 << (bd - 8)), (128 << (bd - 8)) - 1
    half_h, half_w = (height + 1) // 2, (width + 1) // 2
    subs = [(0, 0), (ssx, ssy), (ssx, ssy)]
    stripes = []
    for n, y in enumerate(range(0, half_h, 16)):
        rng = GrainRandom(g.seed)
        rng.r ^= ((n * 37 + 178) & 255) << 8
        rng.r ^= (n * 173 + 105) & 255
        row = [None if t is None else
               np.zeros((34 >> sy, ((width + sx) >> sx) + 34), np.int64)
               for t, (sx, sy) in zip(templates, subs)]
        for x in range(0, half_w, 16):
            r = rng.bits(8)
            ox, oy = r >> 4, r & 15
            for t, st, (sx, sy) in zip(templates, row, subs):
                if t is None:
                    continue
                px = 6 + ox if sx else 9 + 2 * ox
                py = 6 + oy if sy else 9 + 2 * oy
                blk = t[py:py + (34 >> sy), px:px + (34 >> sx)].copy()
                x0 = (2 * x) >> sx
                if g.overlap and x:
                    if sx:
                        blk[:, 0] = _blend(st[:, x0], blk[:, 0], (23, 22),
                                           lo, hi)
                    else:
                        blk[:, 0] = _blend(st[:, x0], blk[:, 0], (27, 17),
                                           lo, hi)
                        blk[:, 1] = _blend(st[:, x0 + 1], blk[:, 1],
                                           (17, 27), lo, hi)
                st[:, x0:x0 + blk.shape[1]] = blk
        stripes.append(row)
    out = []
    for p, (sx, sy) in enumerate(subs):
        if templates[p] is None:
            out.append(None)
            continue
        ph, pw = (height + sy) >> sy, (width + sx) >> sx
        rows = 32 >> sy
        img = np.concatenate([st[p][:rows, :pw] for st in stripes])[:ph]
        if g.overlap:
            for n in range(1, len(stripes)):
                y0 = n * rows
                old, new = stripes[n - 1][p], stripes[n][p]
                pairs = ((0, (23, 22)),) if sy else ((0, (27, 17)),
                                                     (1, (17, 27)))
                for i, w in pairs:
                    if y0 + i < ph:
                        img[y0 + i] = _blend(old[rows + i, :pw],
                                             new[i, :pw], w, lo, hi)
        out.append(img)
    return out


def film_grain(g, y: np.ndarray, u, v, bd: int, ssx: int, ssy: int,
               mc_identity: int) -> tuple:
    """The planes (uint8 at 8 bits, else uint16; U and V None when
    monochrome) with the film grain of parameters `g` (`avif.FilmGrain`)
    added, as libaom 3.14.1's av1_add_film_grain adds it to the frames it
    outputs: the chroma scaled from the co-located luma before the luma's
    own grain, clipped to the full or the restricted range."""
    mono = u is None
    templates = grain_templates(g, bd, ssx, ssy, mono)
    height, width = y.shape
    noise = noise_images(g, templates, height, width, bd, ssx, ssy)
    top = (256 << (bd - 8)) - 1
    if g.clip_to_restricted_range:
        lo, hi_y = 16 << (bd - 8), 235 << (bd - 8)
        hi_c = hi_y if mc_identity else 240 << (bd - 8)
    else:
        lo, hi_y, hi_c = 0, top, top
    rnd = 1 << (g.scaling_shift - 1)
    luma = y.astype(np.int64)
    out = [y, u, v]
    if not mono:
        ch, cw = u.shape
        ly = luma[np.arange(ch) << ssy]
        lx = np.arange(cw) << ssx
        avg = (ly[:, lx] + ly[:, np.minimum(lx + 1, width - 1)] + 1) >> 1 \
            if ssx else ly[:, lx]
        chroma = ((g.cb_points, g.cb_mult, g.cb_luma_mult, g.cb_offset),
                  (g.cr_points, g.cr_mult, g.cr_luma_mult, g.cr_offset))
        for k, (points, mult, luma_mult, offset) in enumerate(chroma):
            if noise[k + 1] is None:
                continue
            c = out[k + 1].astype(np.int64)
            if g.chroma_scaling_from_luma:
                merged, lut = avg, scaling_lut(g.y_points)
            else:
                merged = np.clip(((avg * luma_mult + c * mult) >> 6)
                                 + (offset << (bd - 8)), 0, top)
                lut = scaling_lut(points)
            n = (_scale(lut, merged, bd) * noise[k + 1] + rnd) \
                >> g.scaling_shift
            out[k + 1] = np.clip(c + n, lo, hi_c).astype(u.dtype)
    if noise[0] is not None:
        n = (_scale(scaling_lut(g.y_points), luma, bd) * noise[0] + rnd) \
            >> g.scaling_shift
        out[0] = np.clip(luma + n, lo, hi_y).astype(y.dtype)
    return tuple(out)


# --- the frame ---------------------------------------------------------------


def decode_planes_plain(frame, cdef: bool = True, restoration: bool = True,
                        grain: bool = True, record: list | None = None):
    """(Y, U, V) of an `avif.Frame` (U, V None when monochrome), uint8 at
    8 bits, else uint16 at the stream's depth, with the frame's film
    grain added; without `cdef`, the deblocked frame, before CDEF and
    loop restoration; without `restoration`, the frame before loop
    restoration; without `grain`, the frame before its film grain
    (stages for the tests). A `record` list gets each block's decisions
    as a dict in coding order (position, size, modes, angle deltas, luma
    transform size, qindex and, by plane, each transform block's (type,
    signed levels by position) or None where none is coded), what the
    encoder's tile writer takes back (`av1_encode.decisions`)."""
    f = _Frame(frame)
    t = _Tile(f)
    t.record = record
    h = f.h
    for tr in range(h.tile_rows):
        for tc in range(h.tile_cols):
            off, size = frame.tiles[tr * h.tile_cols + tc]
            t.row_start, t.row_end = h.row_starts[tr], h.row_starts[tr + 1]
            t.col_start, t.col_end = h.col_starts[tc], h.col_starts[tc + 1]
            _decode_tile(t, frame.data[off:off + size])
    _loop_filter(f)
    if cdef:
        deblocked = [p.copy() for p in f.frame]
        _cdef(f)
        if restoration and any(h.lr_type):
            _loop_restoration(f, deblocked)
    y = _samples(f.frame[0][:h.height, :h.width], f.bd)
    u = v = None
    if f.planes > 1:
        ch, cw = (h.height + f.ssy) >> f.ssy, (h.width + f.ssx) >> f.ssx
        u = _samples(f.frame[1][:ch, :cw], f.bd)
        v = _samples(f.frame[2][:ch, :cw], f.bd)
    if grain and cdef and restoration and h.grain is not None:
        return film_grain(h.grain, y, u, v, f.bd, f.ssx, f.ssy,
                          int(frame.seq.matrix == 0))
    return y, u, v
