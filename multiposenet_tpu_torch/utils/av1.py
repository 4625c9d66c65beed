"""The plain AV1 intra-frame decoder of the port: `csrc/av1.c` in Python,
function for function, for the files `utils/avif.py` reads (8-bit 4:2:0
or monochrome key frames with 64x64 superblocks, without palette, intra
block copy, segmentation, loop restoration, superres or film grain).

`decode_planes_plain(frame)` takes an `avif.Frame` (the sequence and frame
headers and the tiles' bytes) and returns its Y, U and V planes (U and V
None when monochrome) as libaom 3.14.1 decodes them: the tiles (libaom's
entropy decoder and CDF adaptation, partition, intra mode info, CDEF
indices, delta q and delta lf, tx size and type, coefficients), the
prediction, dequantisation with the quantiser matrices and libaom's
inverse transforms, then deblocking and CDEF; a tile whose symbols run
past its bytes or that does not end in its trailing bits is refused, as
libaom reports it corrupt. The stage functions (`inverse_transform_add`,
`idct`, `iadst`, `edge_filter`, `edge_upsample`, `dr_predict`,
`filter_intra_predict`, `nondir_predict`, `cfl_predict`,
`cdef_find_dir`, `cdef_block`, `lf_edge`) are exposed for the tests that
hold them against the C library's and libaom's.

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
          (8, 2): 19, (4, 16): 20, (16, 4): 21}


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
             "palette_uv_mode_cdf", "dc_qlookup", "ac_qlookup",
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
    return [_copy(y) for y in x] if isinstance(x[0], list) else list(x)


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
         "palette_uv_mode": t["palette_uv_mode_cdf"]}
    for k in (16, 32, 64, 128, 256, 512, 1024):
        c[f"eob{k}"] = t[f"eob{k}"][q]
    return {k: _copy(v) for k, v in c.items()}


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


def _clamp16(v: int) -> int:
    return -32768 if v < -32768 else 32767 if v > 32767 else v


def _hada(T: list, a: int, b: int, flip: int) -> None:
    if flip:
        a, b = b, a
    x, y = T[a], T[b]
    T[a] = _clamp16(x + y)
    T[b] = _clamp16(x - y)


def _brev(nbits: int, x: int) -> int:
    r = 0
    for i in range(nbits):
        r |= ((x >> i) & 1) << (nbits - 1 - i)
    return r


def idct(T: list, n: int) -> None:
    """Inverse DCT of 2^n points in place (csrc/av1.c av1_idct)."""
    n0 = 1 << n
    copy = list(T[:n0])
    for i in range(n0):
        T[i] = copy[_brev(n, i)]
    B, H = _bfly, _hada
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


def iadst(T: list, n: int) -> None:
    """Inverse ADST of 8 (n = 3) or 16 (n = 4) points in place."""
    n0 = 1 << n
    copy = list(T[:n0])
    for i in range(n0):
        T[i] = copy[(i - 1) if i & 1 else (n0 - i - 1)]
    B, H = _bfly, _hada
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


def _tx1d(T: list, n: int, kind: int) -> None:
    if kind == 0:
        idct(T, n)
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
        iadst(T, n)


def inverse_transform_add(coef, tx: int, tx_type: int,
                          dst: np.ndarray) -> None:
    """libaom's av1_inv_txfm2d_add_c: coef column-major over the coded
    area (min(w,32) x min(h,32)); the residual is added to dst (a uint8
    view of h x w) and clipped."""
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
            row.append(_clamp16(v))
        _tx1d(row, lw, horz)
        buf.append([round2(v, shift) for v in row])
    for c in range(w):
        sc = w - 1 - c if horz == 2 else c
        col = [_clamp16(buf[r][sc]) for r in range(h)]
        _tx1d(col, lh, vert)
        for r in range(h):
            v = round2(col[h - 1 - r if vert == 2 else r], 4)
            dst[r, c] = clip3(0, 255, int(dst[r, c]) + v)


# --- the frame and its tiles -------------------------------------------------


class _Frame:
    def __init__(self, frame):
        s, h = frame.seq, frame.header
        self.h = h
        self.width, self.height = h.width, h.height
        self.planes = 1 if s.mono else 3
        self.ssx = self.ssy = 1
        self.filter_intra = s.filter_intra
        self.edge_filter = s.intra_edge_filter
        self.enable_cdef = s.cdef
        self.mi_cols = 2 * ((h.width + 7) >> 3)
        self.mi_rows = 2 * ((h.height + 7) >> 3)
        sbc, sbr = (self.mi_cols + 15) >> 4, (self.mi_rows + 15) >> 4
        self.mi_h, self.mi_w = sbr * 16 + 1, sbc * 16 + 1
        shape = (self.mi_h, self.mi_w)
        self.mi_size = np.zeros(shape, np.int64)
        self.y_mode = np.zeros(shape, np.int64)
        self.uv_mode = np.zeros(shape, np.int64)
        self.skip = np.zeros(shape, np.int64)
        self.tx_size = np.zeros(shape, np.int64)
        self.delta_lf = np.zeros(shape + (4,), np.int64)
        self.cdef_idx = np.full((sbr, sbc), -1, np.int64)
        self.frame, self.lf_txsz = [], []
        for p in range(self.planes):
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            ph, pw = (sbr * 64) >> sy, (sbc * 64) >> sx
            self.frame.append(np.zeros((ph, pw), np.uint8))
            self.lf_txsz.append(np.zeros((ph // 4, pw // 4), np.int64))


class _Tile:
    def __init__(self, f: _Frame):
        self.f = f
        self.above_ctx = [[0] * (f.mi_cols + 64) for _ in range(f.planes)]
        self.left_ctx = [[0] * 32 for _ in range(3)]
        self.decoded = [[[0] * 34 for _ in range(34)] for _ in range(3)]

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


def edge_upsample(buf: _Edge, numpx: int) -> None:
    """The intra edge upsampling of buf[-1 .. numpx-1] in place, into
    buf[-2 .. 2 numpx - 2] (csrc/av1.c av1_edge_upsample)."""
    dup = [0] * (numpx + 3)
    dup[0] = buf[-1]
    for i in range(-1, numpx):
        dup[i + 2] = buf[i]
    dup[numpx + 2] = buf[numpx - 1]
    buf[-2] = dup[0]
    for i in range(numpx):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        buf[2 * i - 1] = clip3(0, 255, round2(s, 4))
        buf[2 * i] = dup[i + 2]


def filter_intra_predict(above, left, w: int, h: int,
                         mode: int) -> np.ndarray:
    """Filter intra of a w x h block from its edges (above[-1] the
    corner; csrc/av1.c av1_filter_intra_predict)."""
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
                    0, 255, round2signed(pr, 4))
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
                   have_above: bool) -> np.ndarray:
    """DC, smooth, smooth V, smooth H and Paeth prediction from the edges
    (csrc/av1.c av1_nondir_predict)."""
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
            avg = 128
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
    above, left = _Edge(2 * 128 + 32), _Edge(2 * 128 + 32)
    for i in range(w + h):
        if not have_above and have_left:
            above[i] = int(fr[y, x - 1])
        elif not have_above:
            above[i] = 127
        else:
            lim = min(x + (2 * w if have_above_rt else w) - 1, max_x)
            above[i] = int(fr[y - 1, min(x + i, lim)])
        if not have_left and have_above:
            left[i] = int(fr[y - 1, x])
        elif not have_left:
            left[i] = 129
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
        corner = 128
    above[-1] = left[-1] = corner
    if plane == 0 and t.use_filter_intra:
        out = filter_intra_predict(above, left, w, h, t.filter_mode)
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
                edge_upsample(above, w + (h if angle < 90 else 0))
            up_left = _use_upsample(w, h, kind, angle - 180)
            if up_left:
                edge_upsample(left, h + (w if angle > 180 else 0))
        out = dr_predict(above, left, w, h, up_above, up_left, angle)
    else:
        out = nondir_predict(above, left, w, h, mode, have_left, have_above)
    fr[y:y + h, x:x + w] = out


def cfl_predict(dc: np.ndarray, luma: np.ndarray, max_w: int, max_h: int,
                alpha: int) -> np.ndarray:
    """Chroma from luma (4:2:0) of the chroma block whose DC prediction is
    `dc`, from the co-located luma of which max_w x max_h samples are
    decoded (csrc/av1.c av1_cfl_predict)."""
    h, w = dc.shape
    L = [[0] * w for _ in range(h)]
    total = 0
    for i in range(h):
        ly = min(i << 1, max_h - 2)
        for j in range(w):
            lx = min(j << 1, max_w - 2)
            L[i][j] = (int(luma[ly, lx]) + int(luma[ly, lx + 1])
                       + int(luma[ly + 1, lx]) + int(luma[ly + 1, lx + 1])) << 1
            total += L[i][j]
    avg = round2(total, (w.bit_length() - 1) + (h.bit_length() - 1))
    out = np.empty((h, w), np.int64)
    for i in range(h):
        for j in range(w):
            out[i, j] = clip3(0, 255, int(dc[i, j])
                              + round2signed(alpha * (L[i][j] - avg), 6))
    return out


def _predict_cfl(t: _Tile, plane: int, sx0: int, sy0: int, tx: int) -> None:
    w, h = 1 << TX_WLOG2[tx], 1 << TX_HLOG2[tx]
    fr = t.f.frame[plane]
    fr[sy0:sy0 + h, sx0:sx0 + w] = cfl_predict(
        fr[sy0:sy0 + h, sx0:sx0 + w], t.f.frame[0][sy0 << 1:, sx0 << 1:],
        t.max_luma_w - (sx0 << 1), t.max_luma_h - (sy0 << 1),
        t.cfl_u if plane == 1 else t.cfl_v)


def _tx_class(tx_type: int) -> int:
    if tx_type in (V_DCT, V_ADST, V_FLIPADST):
        return TX_CLASS_VERT
    if tx_type in (H_DCT, H_ADST, H_FLIPADST):
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


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
    lbase = y4 & ((16 >> sy) - 1)
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
    if not all_zero:
        tx_set = _tx_set_type(tx, hdr.reduced_tx_set)
        if plane == 0:
            if tx_set > 0 and t.current_q > 0:
                eset = 1 if tx_set == 3 else 2
                mode = FIMODE_TO_INTRADIR[t.filter_mode] \
                    if t.use_filter_intra else t.y_mode
                sym = ec.symbol(cdf["intra_ext_tx"][eset][TX_SQR[tx]][mode],
                                NUM_EXT_TX_SET[tx_set])
                tx_type = tb["ext_tx_inv"][tx_set][sym]
        else:
            tx_type = MODE_TO_TXFM[DC_PRED if t.uv_mode == UV_CFL_PRED
                                   else t.uv_mode]
            if not tb["ext_tx_used"][tx_set][tx_type]:
                tx_type = DCT_DCT
        if TX_SQR_UP[tx] > TX_32X32:
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
        qm_level = (hdr.qm[plane] if hdr.using_qm else 15)
        iqm = None
        if qm_level < 15 and tx_type < IDTX:
            iqm = tb["iwt_matrix"][qm_level][int(plane > 0)][QM_OFFSET[tx]:]
        q = t.current_q
        if plane == 0:
            dq_dc = tb["dc_qlookup"][clip3(0, 255, q + hdr.dq[0])]
            dq_ac = tb["ac_qlookup"][clip3(0, 255, q)]
        else:
            dcd = hdr.dq[1] if plane == 1 else hdr.dq[3]
            acd = hdr.dq[2] if plane == 1 else hdr.dq[4]
            dq_dc = tb["dc_qlookup"][clip3(0, 255, q + dcd)]
            dq_ac = tb["ac_qlookup"][clip3(0, 255, q + acd)]
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
            level &= 0xFFFFF
            cul += level
            dqv = dq_ac if pos else dq_dc
            if iqm is not None:
                dqv = (int(iqm[pos]) * dqv + 16) >> 5
            dq = ((level * dqv) & 0xFFFFFF) >> dq_shift
            coef[pos] = clip3(-32768, 32767, -dq if sign else dq)
        cul = min(cul, 63)
        if dc_val < 0:
            cul |= 1 << 6
        elif dc_val > 0:
            cul += 2 << 6
    for k in range(w4):
        a[x4 + k] = cul if x4 + k < max_x4 else 0
    for k in range(h4):
        lctx[lbase + k] = cul if y4 + k < max_y4 else 0
    return eob, tx_type, coef


def _read_delta(t: _Tile, cdf: list) -> int:
    abs_v = t.ec.symbol(cdf, 4)
    if abs_v == 3:
        n = t.ec.literal(3) + 1
        abs_v = t.ec.literal(n) + (1 << n) + 1
    if abs_v:
        return -abs_v if t.ec.bit() else abs_v
    return 0


def _mode_info(t: _Tile) -> None:
    f, cdf, ec, hdr = t.f, t.cdf, t.ec, t.f.h
    r, c = t.mi_row, t.mi_col
    ctx = (int(f.skip[r - 1, c]) if t.avail_u else 0) + \
        (int(f.skip[r, c - 1]) if t.avail_l else 0)
    t.skip = ec.symbol(cdf["skip"][ctx], 2)
    if not t.skip and f.enable_cdef:
        sb = f.cdef_idx
        if sb[r >> 4, c >> 4] == -1:
            sb[r >> 4, c >> 4] = ec.literal(hdr.cdef_bits)
    if not (t.bsize == BLOCK_64X64 and t.skip) and t.read_deltas:
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
    above = int(f.y_mode[r - 1, c]) if t.avail_u else DC_PRED
    left = int(f.y_mode[r, c - 1]) if t.avail_l else DC_PRED
    t.y_mode = ec.symbol(
        cdf["kf_y"][INTRA_MODE_CTX[above]][INTRA_MODE_CTX[left]], 13)
    t.angle_y = _read_angle(t, t.y_mode)
    t.uv_mode, t.angle_uv, t.cfl_u, t.cfl_v = DC_PRED, 0, 0, 0
    bw, bh = 4 * BW4[t.bsize], 4 * BH4[t.bsize]
    if t.has_chroma:
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
        bctx = MI_WLOG2[t.bsize] + MI_HLOG2[t.bsize] - 2
        if t.y_mode == DC_PRED and ec.symbol(cdf["palette_y_mode"][bctx][0],
                                             2):
            raise ValueError("AVIF: palette mode (screen content) is not "
                             "read here")
        if t.has_chroma and t.uv_mode == DC_PRED and \
                ec.symbol(cdf["palette_uv_mode"][0], 2):
            raise ValueError("AVIF: palette mode (screen content) is not "
                             "read here")
    t.use_filter_intra = 0
    if f.filter_intra and t.y_mode == DC_PRED and max(bw, bh) <= 32:
        t.use_filter_intra = ec.symbol(cdf["filter_intra"][t.bsize], 2)
        if t.use_filter_intra:
            t.filter_mode = ec.symbol(cdf["filter_intra_mode"], 5)


def _read_angle(t: _Tile, mode: int) -> int:
    if t.bsize < BLOCK_8X8 or not _is_directional(mode):
        return 0
    return t.ec.symbol(t.cdf["angle_delta"][mode - V_PRED], 7) - 3


def _read_tx_size(t: _Tile) -> None:
    f = t.f
    max_rect = _t()["max_txsize_rect_lookup"][t.bsize]
    t.tx_size = max_rect
    if t.bsize > BLOCK_4X4 and f.h.tx_mode_select:
        aw = (1 << TX_WLOG2[f.tx_size[t.mi_row - 1, t.mi_col]]) \
            if t.avail_u else 0
        lh = (1 << TX_HLOG2[f.tx_size[t.mi_row, t.mi_col - 1]]) \
            if t.avail_l else 0
        ctx = int(aw >= 1 << TX_WLOG2[max_rect]) + \
            int(lh >= 1 << TX_HLOG2[max_rect])
        depth_max = MAX_TX_DEPTH[t.bsize]
        depth = t.ec.symbol(t.cdf["tx_size"][depth_max - 1][ctx],
                            3 if depth_max > 1 else 2)
        for _ in range(depth):
            t.tx_size = SPLIT_TX[t.tx_size]


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
    dr, dc = (row & 15) >> sy, (col & 15) >> sx
    step_x, step_y = 1 << (TX_WLOG2[tx] - 2), 1 << (TX_HLOG2[tx] - 2)
    if start_x >= (f.mi_cols * 4) >> sx or start_y >= (f.mi_rows * 4) >> sy:
        return
    is_cfl = plane > 0 and t.uv_mode == UV_CFL_PRED
    mode = t.y_mode if plane == 0 else DC_PRED if is_cfl else t.uv_mode
    dec = t.decoded[plane]
    _predict_intra(t, plane, start_x, start_y,
                   (t.avail_l if plane == 0 else t.avail_l_chroma) or x > 0,
                   (t.avail_u if plane == 0 else t.avail_u_chroma) or y > 0,
                   dec[dr][dc + step_x + 1], dec[dr + step_y + 1][dc], mode,
                   TX_WLOG2[tx], TX_HLOG2[tx])
    if is_cfl:
        _predict_cfl(t, plane, start_x, start_y, tx)
    if plane == 0:
        t.max_luma_w = start_x + step_x * 4
        t.max_luma_h = start_y + step_y * 4
    if not t.skip:
        eob, tx_type, coef = _read_coeffs(t, plane, start_x >> 2,
                                          start_y >> 2, tx)
        if eob > 0:
            w, h = 1 << TX_WLOG2[tx], 1 << TX_HLOG2[tx]
            inverse_transform_add(
                coef, tx, tx_type,
                f.frame[plane][start_y:start_y + h, start_x:start_x + w])
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
            for plane in range(1 + 2 * t.has_chroma):
                tx = _uv_tx_size(t.bsize, f.ssx, f.ssy) if plane \
                    else t.tx_size
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
    _read_tx_size(t)
    if t.skip:
        for plane in range(1 + 2 * t.has_chroma):
            sx = f.ssx if plane else 0
            sy = f.ssy if plane else 0
            for i in range(c >> sx, (c + bw4) >> sx):
                t.above_ctx[plane][i] = 0
            for i in range(r >> sy, (r + bh4) >> sy):
                t.left_ctx[plane][i & ((16 >> sy) - 1)] = 0
    r1, c1 = min(r + bh4, f.mi_rows), min(c + bw4, f.mi_cols)
    f.y_mode[r:r1, c:c1] = t.y_mode
    f.uv_mode[r:r1, c:c1] = t.uv_mode
    f.skip[r:r1, c:c1] = t.skip
    f.tx_size[r:r1, c:c1] = t.tx_size
    f.mi_size[r:r1, c:c1] = bsize
    f.delta_lf[r:r1, c:c1] = t.delta_lf
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
        for y in range(-1, (16 >> sy) + 1):
            for x in range(-1, (16 >> sx) + 1):
                dec[y + 1][x + 1] = int((y < 0 and x < sbw4)
                                        or (x < 0 and y < sbh4))
        dec[(16 >> sy) + 1][0] = 0


def _decode_tile(t: _Tile, data: bytes) -> None:
    f = t.f
    t.ec = SymbolDecoder(data, not f.h.disable_cdf_update)
    t.cdf = init_cdfs(f.h.base_q)
    for p in range(f.planes):
        t.above_ctx[p] = [0] * (f.mi_cols + 64)
    t.delta_lf = [0, 0, 0, 0]
    t.current_q = f.h.base_q
    for r in range(t.row_start, t.row_end, 16):
        t.left_ctx = [[0] * 32 for _ in range(3)]
        for c in range(t.col_start, t.col_end, 16):
            t.read_deltas = f.h.delta_q_present
            _clear_block_decoded(t, r, c)
            _decode_partition(t, r, c, BLOCK_64X64)
            if t.ec.overflowed():
                raise ValueError("AV1: a tile's symbols run past its data "
                                 "(libaom reports a corrupt frame)")
    if not t.ec.trailing_bits_ok():
        raise ValueError("AV1: a tile's data does not end in its trailing "
                         "bits (libaom reports a corrupt frame)")


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
    if h.lf_delta_enabled:
        lvl = clip3(0, 63, lvl + h.lf_ref_deltas[0] * (1 << (lvl >> 5)))
    return lvl


def _c8(x: int) -> int:
    return clip3(-128, 127, x)


def lf_edge(s: list, plane: int, limit: int, blimit: int, thresh: int,
            filter_size: int) -> list:
    """One line of samples across an edge (s[8] is q0, s[7] p0) filtered
    as the deblocking filter of that size filters it; returns the line."""
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
        flat = (abs(p[1] - p[0]) <= 1 and abs(q[1] - q[0]) <= 1
                and abs(p[2] - p[0]) <= 1 and abs(q[2] - q[0]) <= 1)
        if length >= 8:
            flat = flat and abs(p[3] - p[0]) <= 1 and abs(q[3] - q[0]) <= 1
    if filter_size >= 16:
        flat2 = all(abs(p[k] - p[0]) <= 1 and abs(q[k] - q[0]) <= 1
                    for k in (4, 5, 6))
    if filter_size == 4 or not flat:
        ps1, ps0, qs0, qs1 = p[1] - 128, p[0] - 128, q[0] - 128, q[1] - 128
        filt = _c8(ps1 - qs1) if hev else 0
        filt = _c8(filt + 3 * (qs0 - ps0))
        f1, f2 = _c8(filt + 4) >> 3, _c8(filt + 3) >> 3
        s[8] = _c8(qs0 - f1) + 128
        s[7] = _c8(ps0 + f2) + 128
        if not hev:
            ff = round2(f1, 1)
            s[9] = _c8(qs1 - ff) + 128
            s[6] = _c8(ps1 + ff) + 128
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
                                          size)
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
                                          size)
                            for k in range(max(0, ys - 7), min(ys + 7,
                                                               fr.shape[0])):
                                fr[k, xx] = out[k - ys + 8]


# --- CDEF --------------------------------------------------------------------


def _cdef_dir_rc(d: int, k: int) -> tuple[int, int]:
    v = _t()["cdef_directions_padded"][d + 2][k]
    r = (v + 72 + 144 * 4) // 144 - 4
    return r, v - r * 144


def cdef_find_dir(img: np.ndarray) -> tuple[int, int]:
    """libaom's cdef_find_dir_c on an 8x8 block: (direction, variance)."""
    cost = [0] * 8
    partial = [[0] * 15 for _ in range(8)]
    for i in range(8):
        for j in range(8):
            x = int(img[i, j]) - 128
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
               sec: int, damping: int, d: int, bounds: tuple) -> np.ndarray:
    """The w x h block at (y0, x0) of src filtered by CDEF (taps outside
    bounds = (rows, cols) are unavailable); returns the block."""
    tb = _t()
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
                        tot += tb["cdef_pri_taps"][pri & 1][k] * \
                            _constrain(p - x, pri, damping)
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


def _cdef(f: _Frame) -> None:
    h = f.h
    if not f.enable_cdef:
        return
    src = [p.copy() for p in f.frame]
    for r in range(0, f.mi_rows, 2):
        for c in range(0, f.mi_cols, 2):
            idx = int(f.cdef_idx[r >> 4, c >> 4])
            if idx == -1 or f.skip[r:r + 2, c:c + 2].all():
                continue
            d, var = cdef_find_dir(src[0][r * 4:r * 4 + 8, c * 4:c * 4 + 8])
            pri, sec = h.cdef_y[idx]
            vs = min((var >> 6).bit_length() - 1, 12) if var >> 6 else 0
            adj = (pri * (4 + vs) + 8) >> 4 if var else 0
            if pri or sec:
                f.frame[0][r * 4:r * 4 + 8, c * 4:c * 4 + 8] = cdef_block(
                    src[0], r * 4, c * 4, 8, 8, adj, sec, h.cdef_damping,
                    d if pri else 0, (f.mi_rows * 4, f.mi_cols * 4))
            if f.planes > 1:
                pri, sec = h.cdef_uv[idx]
                if pri or sec:
                    for p in (1, 2):
                        f.frame[p][r * 2:r * 2 + 4, c * 2:c * 2 + 4] = \
                            cdef_block(src[p], r * 2, c * 2, 4, 4, pri, sec,
                                       h.cdef_damping - 1, d if pri else 0,
                                       (f.mi_rows * 2, f.mi_cols * 2))


# --- the frame ---------------------------------------------------------------


def decode_planes_plain(frame, cdef: bool = True):
    """(Y, U, V) of an `avif.Frame` (U, V None when monochrome); without
    `cdef`, the frame before CDEF (a stage for the tests)."""
    f = _Frame(frame)
    t = _Tile(f)
    h = f.h
    for tr in range(h.tile_rows):
        for tc in range(h.tile_cols):
            off, size = frame.tiles[tr * h.tile_cols + tc]
            t.row_start, t.row_end = h.row_starts[tr], h.row_starts[tr + 1]
            t.col_start, t.col_end = h.col_starts[tc], h.col_starts[tc + 1]
            _decode_tile(t, frame.data[off:off + size])
    _loop_filter(f)
    if cdef:
        _cdef(f)
    y = f.frame[0][:h.height, :h.width].copy()
    if f.planes == 1:
        return y, None, None
    ch, cw = (h.height + 1) >> 1, (h.width + 1) >> 1
    return y, f.frame[1][:ch, :cw].copy(), f.frame[2][:ch, :cw].copy()
