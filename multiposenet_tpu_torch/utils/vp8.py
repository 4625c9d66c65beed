"""VP8, WebP's lossy bitstream (key frames, RFC 6386): the plain Python
version of the host C decoder in `csrc/webp.c` (`vp8_decode`), to the
pixels libwebp 1.6 gives cv2 5.0.

`decode_frame` reads one key frame to its Y, U and V planes as libwebp's
`src/dec` does: the boolean decoder, the frame header (segmentation with
its map and quantiser and filter-level updates, the loop-filter deltas,
filter type and sharpness, 1/2/4/8 token partitions), the dequantisation
tables (y2 DC doubled, y2 AC at least 8, uv DC at most 132), the
coefficient tokens with their probability updates and the skip flag,
intra prediction (16x16 and chroma DC/V/H/TM, the ten 4x4 modes) with
127 above and 129 left of the frame and the top-right pixels of the
right-hand sub-blocks taken from the macroblock above and to the right,
the inverse WHT and DCT, and both loop filters in libwebp's order.
Prediction reads the unfiltered neighbours, as libwebp's does.
`yuv_to_rgb` is libwebp's fancy upsampling (`UpsampleRgbLinePair`, the
9-3-3-1 filter in its two-step averages) with its 14-bit fixed-point
`VP8YUVToR/G/B`. A stream libwebp rejects raises a ValueError: a bad
header, partitions past the data, or bits read past a partition's end
(libwebp's `eof_`, fatal at the next macroblock or row). The boolean
decoder is libwebp's own (see `_BoolReader`), so that corrupt streams
decode, or fail, as they do under cv2; and each block takes the inverse
transform libwebp picks for it on x86 (`Transform_SSE2` in 16-bit lanes,
or the integer AC3 and DC ones), which differ only where a corrupt
stream's sums wrap.
"""

from __future__ import annotations

import numpy as np

FRAME_HEADER_SIZE = 10
SIGNATURE = b"\x9d\x01\x2a"
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT_PROBAS = ((173, 148, 140), (176, 155, 140, 135),
               (180, 157, 141, 134, 130),
               (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# Sub-block n of a macroblock → (row, column) of its top-left pixel.
_SCAN = tuple((4 * (n // 4), 4 * (n % 4)) for n in range(16))
# libwebp's prediction modes (its enum order, which its tables follow).
DC, TM, VE, HE, RD, VR, LD, VL, HD, HU = range(10)
_Y_STRIDE = 21  # 1 left + 16 + 4 top-right
_UV_STRIDE = 9


_MASK64 = (1 << 64) - 1


class _BoolReader:
    """libwebp's VP8BitReader on a 64-bit machine, step for step: a 64-bit
    window filled 56 bits at a time while 8 bytes remain, then a byte at
    a time, then one zero byte that sets eof (fatal at the next
    macroblock or row); the range kept as range - 1. A stream that breaks
    the coder's invariant (a corrupt one) decodes as libwebp decodes it,
    high bits lost to the window included."""

    __slots__ = ("data", "buf", "end", "max", "value", "range", "bits",
                 "eof")

    def __init__(self, data: bytes, start: int, size: int):
        self.data = data
        self.buf = start
        self.end = start + size
        self.max = start + size - 7 if size >= 8 else start
        self.value = 0
        self.range = 254
        self.bits = -8
        self.eof = False
        self._load()

    def _load(self) -> None:
        if self.buf < self.max:
            chunk = int.from_bytes(self.data[self.buf:self.buf + 7], "big")
            self.buf += 7
            self.value = ((self.value << 56) | chunk) & _MASK64
            self.bits += 56
        elif self.buf < self.end:
            self.value = ((self.value << 8) | self.data[self.buf]) & _MASK64
            self.buf += 1
            self.bits += 8
        elif not self.eof:
            self.value = (self.value << 8) & _MASK64
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        rng = self.range
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = (rng * prob) >> 8
        if ((self.value >> pos) & 0xFFFFFFFF) > split:
            rng -= split
            self.value = (self.value - ((split + 1) << pos)) & _MASK64
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 7 ^ (rng.bit_length() - 1)
        self.range = (rng << shift) - 1
        self.bits -= shift
        return bit

    def signed(self, v: int) -> int:
        """VP8GetSigned: v with the sign of one bit of probability 1/2."""
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = self.range >> 1
        value = (self.value >> pos) & 0xFFFFFFFF
        negative = (split - value) & 0xFFFFFFFF >= 0x80000000
        self.bits -= 1
        if negative:
            self.range = ((self.range - 1) & 0xFFFFFFFF) | 1
            self.value = (self.value - ((split + 1) << pos)) & _MASK64
            return -v
        self.range |= 1
        return v

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(128) else v


def _int16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


class _Header:
    pass


def _parse_header(data: bytes) -> _Header:
    if len(data) < 4:
        raise ValueError("VP8 frame header ends early")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise ValueError("VP8 frame is not a key frame")
    if (bits >> 1) & 7 > 3:
        raise ValueError(f"VP8 profile {(bits >> 1) & 7}")
    if not (bits >> 4) & 1:
        raise ValueError("VP8 frame is not shown")
    part0 = bits >> 5
    if len(data) < FRAME_HEADER_SIZE:
        raise ValueError("VP8 picture header ends early")
    if data[3:6] != SIGNATURE:
        raise ValueError("VP8 key frame without its start code")
    h = _Header()
    h.width = (data[6] | (data[7] << 8)) & 0x3FFF
    h.height = (data[8] | (data[9] << 8)) & 0x3FFF
    if h.width == 0 or h.height == 0:
        raise ValueError("VP8 frame of zero width or height")
    if part0 > len(data) - FRAME_HEADER_SIZE:
        raise ValueError(f"VP8 first partition of {part0} bytes past the "
                         "data")
    br = _BoolReader(data, FRAME_HEADER_SIZE, part0)
    h.br = br
    br.value_bits(2)  # colour space and clamping type: libwebp ignores both
    # Segmentation.
    h.use_segment = br.bit(128)
    h.update_map = 0
    h.absolute = 1
    h.seg_quant = [0] * 4
    h.seg_filter = [0] * 4
    h.seg_probas = [255] * 3
    if h.use_segment:
        h.update_map = br.bit(128)
        if br.bit(128):
            h.absolute = br.bit(128)
            h.seg_quant = [br.signed_value(7) if br.bit(128) else 0
                           for _ in range(4)]
            h.seg_filter = [br.signed_value(6) if br.bit(128) else 0
                            for _ in range(4)]
        if h.update_map:
            h.seg_probas = [br.value_bits(8) if br.bit(128) else 255
                            for _ in range(3)]
    # Loop filter.
    h.simple = br.bit(128)
    h.level = br.value_bits(6)
    h.sharpness = br.value_bits(3)
    h.use_lf_delta = br.bit(128)
    ref_delta = [0] * 4
    mode_delta = [0] * 4
    if h.use_lf_delta and br.bit(128):
        for i in range(4):
            if br.bit(128):
                ref_delta[i] = br.signed_value(6)
        for i in range(4):
            if br.bit(128):
                mode_delta[i] = br.signed_value(6)
    h.ref_delta0, h.mode_delta0 = ref_delta[0], mode_delta[0]
    h.filter_type = 0 if h.level == 0 else 1 if h.simple else 2
    if br.eof:
        raise ValueError("VP8 frame header ends early")
    # Token partitions.
    num = 1 << br.value_bits(2)
    start = FRAME_HEADER_SIZE + part0
    left = len(data) - start
    if left < 3 * (num - 1):
        raise ValueError("VP8 partition sizes past the data")
    part_start = start + 3 * (num - 1)
    left -= 3 * (num - 1)
    h.parts = []
    for p in range(num - 1):
        at = start + 3 * p
        size = min(data[at] | (data[at + 1] << 8) | (data[at + 2] << 16),
                   left)
        h.parts.append(_BoolReader(data, part_start, size))
        part_start += size
        left -= size
    h.parts.append(_BoolReader(data, part_start, left))
    if part_start >= len(data):
        raise ValueError("VP8 last partition is empty")
    _parse_quant(br, h)
    br.bit(128)  # refresh entropy probs: one frame, nothing to refresh
    h.probas = _parse_probas(br)
    h.use_skip = br.bit(128)
    h.skip_p = br.value_bits(8) if h.use_skip else 0
    return h


def _parse_quant(br: _BoolReader, h: _Header) -> None:
    base = br.value_bits(7)
    deltas = [br.signed_value(4) if br.bit(128) else 0 for _ in range(5)]
    y1_dc, y2_dc, y2_ac, uv_dc, uv_ac = deltas

    def clip(v, hi):
        return 0 if v < 0 else hi if v > hi else v

    h.quant = []
    for s in range(4):
        if h.use_segment:
            q = h.seg_quant[s] + (0 if h.absolute else base)
        else:
            q = base
        y2_ac_q = (_AC_TABLE[clip(q + y2_ac, 127)] * 101581) >> 16
        h.quant.append((
            (_DC_TABLE[clip(q + y1_dc, 127)], _AC_TABLE[clip(q, 127)]),
            (_DC_TABLE[clip(q + y2_dc, 127)] * 2, max(y2_ac_q, 8)),
            (_DC_TABLE[clip(q + uv_dc, 117)], _AC_TABLE[clip(q + uv_ac,
                                                             127)])))


def _parse_probas(br: _BoolReader) -> list:
    """probas[type][band][ctx] → 11 probabilities."""
    probas = []
    i = 0
    for _ in range(4):
        bands = []
        for _ in range(8):
            ctxs = []
            for _ in range(3):
                row = []
                for _ in range(11):
                    row.append(br.value_bits(8)
                               if br.bit(_COEFFS_UPDATE_PROBA[i])
                               else _COEFFS_PROBA0[i])
                    i += 1
                ctxs.append(row)
            bands.append(ctxs)
        probas.append(bands)
    return probas


def _filter_strengths(h: _Header) -> list:
    """[segment][i4x4] → (limit, interior limit, hev threshold)."""
    out = []
    for s in range(4):
        if h.use_segment:
            base = h.seg_filter[s] + (0 if h.absolute else h.level)
        else:
            base = h.level
        per = []
        for i4x4 in range(2):
            level = base
            if h.use_lf_delta:
                level += h.ref_delta0 + (h.mode_delta0 if i4x4 else 0)
            level = 0 if level < 0 else 63 if level > 63 else level
            if level > 0:
                ilevel = level
                if h.sharpness > 0:
                    ilevel >>= 2 if h.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - h.sharpness)
                ilevel = max(ilevel, 1)
                per.append((2 * level + ilevel, ilevel,
                            2 if level >= 40 else 1 if level >= 15 else 0))
            else:
                per.append((0, 0, 0))
        out.append(per)
    return out


def _intra_modes(br: _BoolReader, h: _Header, top: list, left: list,
                 mb_x: int) -> tuple:
    """(segment, skip, is_i4x4, modes, uv mode) of one macroblock."""
    segment = 0
    if h.update_map:
        p = h.seg_probas
        segment = (br.bit(p[1]) if not br.bit(p[0])
                   else br.bit(p[2]) + 2)
    skip = br.bit(h.skip_p) if h.use_skip else 0
    i4x4 = not br.bit(145)
    t = top[4 * mb_x:4 * mb_x + 4]
    if not i4x4:
        if br.bit(156):
            ymode = TM if br.bit(128) else HE
        else:
            ymode = VE if br.bit(163) else DC
        modes = [ymode]
        t[:] = [ymode] * 4
        left[:] = [ymode] * 4
    else:
        modes = []
        for y in range(4):
            ymode = left[y]
            for x in range(4):
                base = (t[x] * 10 + ymode) * 9
                prob = _BMODES_PROBA[base:base + 9]
                if not br.bit(prob[0]):
                    ymode = DC
                elif not br.bit(prob[1]):
                    ymode = TM
                elif not br.bit(prob[2]):
                    ymode = VE
                elif not br.bit(prob[3]):
                    if not br.bit(prob[4]):
                        ymode = HE
                    else:
                        ymode = VR if br.bit(prob[5]) else RD
                elif not br.bit(prob[6]):
                    ymode = LD
                elif not br.bit(prob[7]):
                    ymode = VL
                else:
                    ymode = HU if br.bit(prob[8]) else HD
                t[x] = ymode
            modes.extend(t)
            left[y] = ymode
    top[4 * mb_x:4 * mb_x + 4] = t
    if not br.bit(142):
        uvmode = DC
    elif not br.bit(114):
        uvmode = VE
    else:
        uvmode = TM if br.bit(183) else HE
    return segment, skip, i4x4, modes, uvmode


def _large_value(br: _BoolReader, p) -> int:
    if not br.bit(p[3]):
        if not br.bit(p[4]):
            return 2
        return 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    bit1 = br.bit(p[8])
    bit0 = br.bit(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for prob in _CAT_PROBAS[cat]:
        v = 2 * v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _BoolReader, bands, ctx: int, dq, n: int, out: list,
            base: int) -> int:
    """One block's tokens into out[base:base + 16] (raster order,
    dequantised, stored as int16); returns libwebp's count: the position
    after the last token read."""
    p = bands[_BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[_BANDS[n]][0]
        if not br.bit(p[2]):
            v, ctx = 1, 1
        else:
            v, ctx = _large_value(br, p), 2
        out[base + _ZIGZAG[n]] = _int16(br.signed(v) * dq[n > 0])
        n += 1
        p = bands[_BANDS[n]][ctx]
    return 16


def _nz_code(nzc: int, nz: int, dc_nz: bool) -> int:
    return (nzc << 2) | (3 if nz > 3 else 2 if nz > 1 else int(dc_nz))


def _wht(dc: list, out: list) -> None:
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i] = a0 + a1
        tmp[8 + i] = a0 - a1
        tmp[4 + i] = a3 + a2
        tmp[12 + i] = a3 - a2
    for i in range(4):
        d = tmp[4 * i] + 3
        a0 = d + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = d - tmp[4 * i + 3]
        out[64 * i] = _int16((a0 + a1) >> 3)
        out[64 * i + 16] = _int16((a3 + a2) >> 3)
        out[64 * i + 32] = _int16((a0 - a1) >> 3)
        out[64 * i + 48] = _int16((a3 - a2) >> 3)


def _residuals(br: _BoolReader, h: _Header, q, i4x4: bool, nz: list,
               mb_x: int, coeffs: list) -> tuple[int, int]:
    """ParseResiduals: the macroblock's coefficients into `coeffs`; `nz`
    holds [top nz, top dc nz] per column and [left nz, left dc nz] at the
    end. Returns (non_zero_y, non_zero_uv)."""
    probas = h.probas
    top, left = nz[mb_x], nz[-1]
    if not i4x4:
        dc = [0] * 16
        n = _coeffs(br, probas[1], top[1] + left[1], q[1], 0, dc, 0)
        top[1] = left[1] = int(n > 0)
        if n > 1:
            _wht(dc, coeffs)
        else:
            dc0 = _int16((dc[0] + 3) >> 3)
            for i in range(16):
                coeffs[16 * i] = dc0
        first, ac = 1, probas[0]
    else:
        first, ac = 0, probas[3]
    tnz, lnz = top[0] & 0x0F, left[0] & 0x0F
    non_zero_y = 0
    base = 0
    for _ in range(4):
        l = lnz & 1
        nzc = 0
        for _ in range(4):
            n = _coeffs(br, ac, l + (tnz & 1), q[0], first, coeffs, base)
            l = int(n > first)
            tnz = (tnz >> 1) | (l << 7)
            nzc = _nz_code(nzc, n, coeffs[base] != 0)
            base += 16
        tnz >>= 4
        lnz = (lnz >> 1) | (l << 7)
        non_zero_y = (non_zero_y << 8) | nzc
    out_t, out_l = tnz, lnz >> 4
    non_zero_uv = 0
    for ch in (0, 2):
        nzc = 0
        tnz = top[0] >> (4 + ch)
        lnz = left[0] >> (4 + ch)
        for _ in range(2):
            l = lnz & 1
            for _ in range(2):
                n = _coeffs(br, probas[2], l + (tnz & 1), q[2], 0, coeffs,
                            base)
                l = int(n > 0)
                tnz = (tnz >> 1) | (l << 3)
                nzc = _nz_code(nzc, n, coeffs[base] != 0)
                base += 16
            tnz >>= 2
            lnz = (lnz >> 1) | (l << 5)
        non_zero_uv |= nzc << (4 * ch)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    top[0], left[0] = out_t, out_l
    return non_zero_y, non_zero_uv


# --- reconstruction --------------------------------------------------------


def _clip8(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _mul1(a: int) -> int:
    return ((a * 20091) >> 16) + a


def _mul2(a: int) -> int:
    return (a * 35468) >> 16


def _idct_add(c: list, base: int, ws: list, at: int, stride: int) -> None:
    """libwebp's TransformOne: vertical pass, then horizontal with
    (x + 4) >> 3, added to the prediction with clipping."""
    tmp = [0] * 16
    for i in range(4):
        a = c[base + i] + c[base + 8 + i]
        b = c[base + i] - c[base + 8 + i]
        cc = _mul2(c[base + 4 + i]) - _mul1(c[base + 12 + i])
        d = _mul1(c[base + 4 + i]) + _mul2(c[base + 12 + i])
        tmp[4 * i] = a + d
        tmp[4 * i + 1] = b + cc
        tmp[4 * i + 2] = b - cc
        tmp[4 * i + 3] = a - d
    for i in range(4):
        dc = tmp[i] + 4
        a = dc + tmp[8 + i]
        b = dc - tmp[8 + i]
        cc = _mul2(tmp[4 + i]) - _mul1(tmp[12 + i])
        d = _mul1(tmp[4 + i]) + _mul2(tmp[12 + i])
        row = at + i * stride
        ws[row] = _clip8(ws[row] + ((a + d) >> 3))
        ws[row + 1] = _clip8(ws[row + 1] + ((b + cc) >> 3))
        ws[row + 2] = _clip8(ws[row + 2] + ((b - cc) >> 3))
        ws[row + 3] = _clip8(ws[row + 3] + ((a - d) >> 3))


_K1, _K2 = 20091, 35468 - 65536


def _simd_pass(i0: int, i1: int, i2: int, i3: int) -> tuple:
    """One pass of libwebp's Transform_SSE2 on one lane: 16-bit sums that
    wrap, _mm_mulhi_epi16 with the constants less 1 << 16."""
    a, b = _int16(i0 + i2), _int16(i0 - i2)
    c = _int16(_int16(i1 - i3)
               + _int16(((i1 * _K2) >> 16) - ((i3 * _K1) >> 16)))
    d = _int16(_int16(i1 + i3)
               + _int16(((i1 * _K1) >> 16) + ((i3 * _K2) >> 16)))
    return _int16(a + d), _int16(b + c), _int16(b - c), _int16(a - d)


def _idct_add_simd(c: list, base: int, ws: list, at: int,
                   stride: int) -> None:
    """libwebp's Transform_SSE2, which its decoder runs on x86 for luma
    blocks with coefficients past the third and chroma planes with any
    AC: equal to `_idct_add` unless a 16-bit sum wraps (corrupt streams),
    then as the SIMD code computes it; the sum with the prediction wraps
    too, then saturates."""
    tmp = [0] * 16
    for j in range(4):
        tmp[4 * j:4 * j + 4] = _simd_pass(c[base + j], c[base + 4 + j],
                                          c[base + 8 + j], c[base + 12 + j])
    for i in range(4):
        out = _simd_pass(_int16(tmp[i] + 4), tmp[4 + i], tmp[8 + i],
                         tmp[12 + i])
        row = at + i * stride
        for k in range(4):
            ws[row + k] = _clip8(_int16(ws[row + k] + (out[k] >> 3)))


def _avg3(a: int, b: int, c: int) -> int:
    return (a + 2 * b + c + 2) >> 2


def _avg2(a: int, b: int) -> int:
    return (a + b + 1) >> 1


def _predict4(mode: int, ws: list, d: int, s: int) -> None:
    """A 4x4 luma predictor into ws at d (stride s)."""
    top = [ws[d - s + i] for i in range(-1, 8)]  # X A B C D E F G H
    X, A, B, C, D, E, F, G, H = top
    I, J, K, L = (ws[d - 1 + i * s] for i in range(4))
    out = [[0] * 4 for _ in range(4)]  # out[y][x]
    if mode == DC:
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        out = [[v] * 4 for _ in range(4)]
    elif mode == TM:
        out = [[_clip8(t + left - X) for t in (A, B, C, D)]
               for left in (I, J, K, L)]
    elif mode == VE:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
               _avg3(C, D, E)]
        out = [row[:] for _ in range(4)]
    elif mode == HE:
        out = [[v] * 4 for v in (_avg3(X, I, J), _avg3(I, J, K),
                                 _avg3(J, K, L), _avg3(K, L, L))]
    else:
        def put(cells, v):
            for x, y in cells:
                out[y][x] = v
        if mode == RD:
            put([(0, 3)], _avg3(J, K, L))
            put([(1, 3), (0, 2)], _avg3(I, J, K))
            put([(2, 3), (1, 2), (0, 1)], _avg3(X, I, J))
            put([(3, 3), (2, 2), (1, 1), (0, 0)], _avg3(A, X, I))
            put([(3, 2), (2, 1), (1, 0)], _avg3(B, A, X))
            put([(3, 1), (2, 0)], _avg3(C, B, A))
            put([(3, 0)], _avg3(D, C, B))
        elif mode == LD:
            put([(0, 0)], _avg3(A, B, C))
            put([(1, 0), (0, 1)], _avg3(B, C, D))
            put([(2, 0), (1, 1), (0, 2)], _avg3(C, D, E))
            put([(3, 0), (2, 1), (1, 2), (0, 3)], _avg3(D, E, F))
            put([(3, 1), (2, 2), (1, 3)], _avg3(E, F, G))
            put([(3, 2), (2, 3)], _avg3(F, G, H))
            put([(3, 3)], _avg3(G, H, H))
        elif mode == VR:
            put([(0, 0), (1, 2)], _avg2(X, A))
            put([(1, 0), (2, 2)], _avg2(A, B))
            put([(2, 0), (3, 2)], _avg2(B, C))
            put([(3, 0)], _avg2(C, D))
            put([(0, 3)], _avg3(K, J, I))
            put([(0, 2)], _avg3(J, I, X))
            put([(0, 1), (1, 3)], _avg3(I, X, A))
            put([(1, 1), (2, 3)], _avg3(X, A, B))
            put([(2, 1), (3, 3)], _avg3(A, B, C))
            put([(3, 1)], _avg3(B, C, D))
        elif mode == VL:
            put([(0, 0)], _avg2(A, B))
            put([(1, 0), (0, 2)], _avg2(B, C))
            put([(2, 0), (1, 2)], _avg2(C, D))
            put([(3, 0), (2, 2)], _avg2(D, E))
            put([(0, 1)], _avg3(A, B, C))
            put([(1, 1), (0, 3)], _avg3(B, C, D))
            put([(2, 1), (1, 3)], _avg3(C, D, E))
            put([(3, 1), (2, 3)], _avg3(D, E, F))
            put([(3, 2)], _avg3(E, F, G))
            put([(3, 3)], _avg3(F, G, H))
        elif mode == HU:
            put([(0, 0)], _avg2(I, J))
            put([(2, 0), (0, 1)], _avg2(J, K))
            put([(2, 1), (0, 2)], _avg2(K, L))
            put([(1, 0)], _avg3(I, J, K))
            put([(3, 0), (1, 1)], _avg3(J, K, L))
            put([(3, 1), (1, 2)], _avg3(K, L, L))
            put([(3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)], L)
        else:  # HD
            put([(0, 0), (2, 1)], _avg2(I, X))
            put([(0, 1), (2, 2)], _avg2(J, I))
            put([(0, 2), (2, 3)], _avg2(K, J))
            put([(0, 3)], _avg2(L, K))
            put([(3, 0)], _avg3(A, B, C))
            put([(2, 0)], _avg3(X, A, B))
            put([(1, 0), (3, 1)], _avg3(I, X, A))
            put([(1, 1), (3, 2)], _avg3(J, I, X))
            put([(1, 2), (3, 3)], _avg3(K, J, I))
            put([(1, 3)], _avg3(L, K, J))
    for y in range(4):
        ws[d + y * s:d + y * s + 4] = out[y]


def _luma_transform(code: int, c: list, base: int, ws: list, at: int,
                    s: int) -> None:
    """DoTransform: by the block's 2-bit code, the SIMD transform (3) or
    the integer AC3 and DC ones (2, 1; `_idct_add` computes both)."""
    code &= 3
    if code == 3:
        _idct_add_simd(c, base, ws, at, s)
    elif code:
        _idct_add(c, base, ws, at, s)


def _predict_block(mode: int, ws: list, size: int, s: int, mb_x: int,
                   mb_y: int) -> None:
    """A 16x16 luma or 8x8 chroma predictor into ws (top-left pixel at
    s + 1), DC as libwebp's CheckMode picks it at the frame's edges."""
    d = s + 1
    top = ws[1:1 + size]
    left = [ws[d - 1 + y * s] for y in range(size)]
    shift = 4 if size == 16 else 3
    if mode == DC:
        if mb_y > 0 and mb_x > 0:
            v = (sum(top) + sum(left) + size) >> (shift + 1)
        elif mb_y > 0:
            v = (sum(top) + (size >> 1)) >> shift
        elif mb_x > 0:
            v = (sum(left) + (size >> 1)) >> shift
        else:
            v = 128
        rows = [[v] * size] * size
    elif mode == TM:
        rows = [[_clip8(t + lv - ws[0]) for t in top] for lv in left]
    elif mode == VE:
        rows = [top] * size
    else:
        rows = [[lv] * size for lv in left]
    for y in range(size):
        ws[d + y * s:d + y * s + size] = rows[y]


def _reconstruct(h: _Header, mb, mb_x: int, mb_y: int, planes) -> None:
    """Predict and add the residuals of one macroblock into the
    (unfiltered) planes."""
    Y, U, V, ys, uvs = planes
    i4x4, modes, uvmode, coeffs, non_zero_y, non_zero_uv = mb
    mb_w = (h.width + 15) >> 4
    x0, y0 = 16 * mb_x, 16 * mb_y
    s = _Y_STRIDE
    ws = [0] * (17 * s)
    if mb_y == 0:
        ws[0:21] = [127] * 21
    else:
        above = (y0 - 1) * ys + x0
        ws[0] = 129 if mb_x == 0 else Y[above - 1]
        ws[1:17] = Y[above:above + 16]
        if mb_x == mb_w - 1:
            ws[17:21] = [Y[above + 15]] * 4
        else:
            ws[17:21] = Y[above + 16:above + 20]
    for y in range(16):
        ws[(y + 1) * s] = 129 if mb_x == 0 else Y[(y0 + y) * ys + x0 - 1]
    if i4x4:
        for r in (4, 8, 12):
            ws[r * s + 17:r * s + 21] = ws[17:21]
        for n in range(16):
            by, bx = _SCAN[n]
            at = (by + 1) * s + bx + 1
            _predict4(modes[n], ws, at, s)
            _luma_transform(non_zero_y >> (30 - 2 * n), coeffs, 16 * n, ws,
                            at, s)
    else:
        _predict_block(modes[0], ws, 16, s, mb_x, mb_y)
        for n in range(16):
            by, bx = _SCAN[n]
            _luma_transform(non_zero_y >> (30 - 2 * n), coeffs, 16 * n, ws,
                            (by + 1) * s + bx + 1, s)
    for y in range(16):
        Y[(y0 + y) * ys + x0:(y0 + y) * ys + x0 + 16] = \
            ws[(y + 1) * s + 1:(y + 1) * s + 17]
    s = _UV_STRIDE
    for ch, plane in enumerate((U, V)):
        ws = [0] * (9 * s)
        cx, cy = 8 * mb_x, 8 * mb_y
        if mb_y == 0:
            ws[0:9] = [127] * 9
        else:
            above = (cy - 1) * uvs + cx
            ws[0] = 129 if mb_x == 0 else plane[above - 1]
            ws[1:9] = plane[above:above + 8]
        for y in range(8):
            ws[(y + 1) * s] = 129 if mb_x == 0 else \
                plane[(cy + y) * uvs + cx - 1]
        _predict_block(uvmode, ws, 8, s, mb_x, mb_y)
        bits = (non_zero_uv >> (8 * ch)) & 0xFF
        for n in range(4):
            base = 256 + 64 * ch + 16 * n
            at = (4 * (n >> 1) + 1) * s + 4 * (n & 1) + 1
            if bits & 0xAA:  # any AC in the plane: all four through SIMD
                _idct_add_simd(coeffs, base, ws, at, s)
            elif bits and coeffs[base]:
                _idct_add(coeffs, base, ws, at, s)
        for y in range(8):
            plane[(cy + y) * uvs + cx:(cy + y) * uvs + cx + 8] = \
                ws[(y + 1) * s + 1:(y + 1) * s + 9]


# --- loop filter -------------------------------------------------------------


def _sclip1(v: int) -> int:
    return -128 if v < -128 else 127 if v > 127 else v


def _sclip2(v: int) -> int:
    return -16 if v < -16 else 15 if v > 15 else v


def _do_filter2(p: list, i: int, st: int) -> None:
    p1, p0, q0, q1 = p[i - 2 * st], p[i - st], p[i], p[i + st]
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    p[i - st] = _clip8(p0 + a2)
    p[i] = _clip8(q0 - a1)


def _do_filter4(p: list, i: int, st: int) -> None:
    p1, p0, q0, q1 = p[i - 2 * st], p[i - st], p[i], p[i + st]
    a = 3 * (q0 - p0)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    a3 = (a1 + 1) >> 1
    p[i - 2 * st] = _clip8(p1 + a3)
    p[i - st] = _clip8(p0 + a2)
    p[i] = _clip8(q0 - a1)
    p[i + st] = _clip8(q1 - a3)


def _do_filter6(p: list, i: int, st: int) -> None:
    p2, p1, p0 = p[i - 3 * st], p[i - 2 * st], p[i - st]
    q0, q1, q2 = p[i], p[i + st], p[i + 2 * st]
    a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
    a1 = (27 * a + 63) >> 7
    a2 = (18 * a + 63) >> 7
    a3 = (9 * a + 63) >> 7
    p[i - 3 * st] = _clip8(p2 + a3)
    p[i - 2 * st] = _clip8(p1 + a2)
    p[i - st] = _clip8(p0 + a1)
    p[i] = _clip8(q0 - a1)
    p[i + st] = _clip8(q1 - a2)
    p[i + 2 * st] = _clip8(q2 - a3)


def _simple_edge(p: list, i: int, hstep: int, vstep: int, thresh: int):
    t2 = 2 * thresh + 1
    for _ in range(16):
        if 4 * abs(p[i - hstep] - p[i]) + abs(p[i - 2 * hstep]
                                              - p[i + hstep]) <= t2:
            _do_filter2(p, i, hstep)
        i += vstep


def _complex_edge(p: list, i: int, hstep: int, vstep: int, size: int,
                  thresh: int, ithresh: int, hev_t: int, mb_edge: bool):
    t2 = 2 * thresh + 1
    for _ in range(size):
        p3, p2, p1, p0 = (p[i - 4 * hstep], p[i - 3 * hstep],
                          p[i - 2 * hstep], p[i - hstep])
        q0, q1, q2, q3 = p[i], p[i + hstep], p[i + 2 * hstep], \
            p[i + 3 * hstep]
        if (4 * abs(p0 - q0) + abs(p1 - q1) <= t2
                and abs(p3 - p2) <= ithresh and abs(p2 - p1) <= ithresh
                and abs(p1 - p0) <= ithresh and abs(q3 - q2) <= ithresh
                and abs(q2 - q1) <= ithresh and abs(q1 - q0) <= ithresh):
            if abs(p1 - p0) > hev_t or abs(q1 - q0) > hev_t:
                _do_filter2(p, i, hstep)
            elif mb_edge:
                _do_filter6(p, i, hstep)
            else:
                _do_filter4(p, i, hstep)
        i += vstep


def _filter_mb(h: _Header, info, mb_x: int, mb_y: int, planes) -> None:
    limit, ilevel, hev_t, inner = info
    if limit == 0:
        return
    Y, U, V, ys, uvs = planes
    y0 = 16 * mb_y * ys + 16 * mb_x
    if h.filter_type == 1:
        if mb_x > 0:
            _simple_edge(Y, y0, 1, ys, limit + 4)
        if inner:
            for k in (4, 8, 12):
                _simple_edge(Y, y0 + k, 1, ys, limit)
        if mb_y > 0:
            _simple_edge(Y, y0, ys, 1, limit + 4)
        if inner:
            for k in (4, 8, 12):
                _simple_edge(Y, y0 + k * ys, ys, 1, limit)
        return
    c0 = 8 * mb_y * uvs + 8 * mb_x
    if mb_x > 0:
        _complex_edge(Y, y0, 1, ys, 16, limit + 4, ilevel, hev_t, True)
        for plane in (U, V):
            _complex_edge(plane, c0, 1, uvs, 8, limit + 4, ilevel, hev_t,
                          True)
    if inner:
        for k in (4, 8, 12):
            _complex_edge(Y, y0 + k, 1, ys, 16, limit, ilevel, hev_t, False)
        for plane in (U, V):
            _complex_edge(plane, c0 + 4, 1, uvs, 8, limit, ilevel, hev_t,
                          False)
    if mb_y > 0:
        _complex_edge(Y, y0, ys, 1, 16, limit + 4, ilevel, hev_t, True)
        for plane in (U, V):
            _complex_edge(plane, c0, uvs, 1, 8, limit + 4, ilevel, hev_t,
                          True)
    if inner:
        for k in (4, 8, 12):
            _complex_edge(Y, y0 + k * ys, ys, 1, 16, limit, ilevel, hev_t,
                          False)
        for plane in (U, V):
            _complex_edge(plane, c0 + 4 * uvs, uvs, 1, 8, limit, ilevel,
                          hev_t, False)


def frame_size(data: bytes) -> tuple[int, int]:
    """(width, height) in a key frame's header, scaling bits dropped."""
    return ((data[6] | (data[7] << 8)) & 0x3FFF,
            (data[8] | (data[9] << 8)) & 0x3FFF)


def decode_frame(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """VP8 bytes (from the first byte of the frame to the end of what the
    decoder is given) → (Y [H, W], U, V [(H+1)//2, (W+1)//2]) uint8."""
    data = bytes(data)
    h = _parse_header(data)
    mb_w, mb_h = (h.width + 15) >> 4, (h.height + 15) >> 4
    ys, uvs = 16 * mb_w, 8 * mb_w
    planes = ([0] * (ys * 16 * mb_h), [0] * (uvs * 8 * mb_h),
              [0] * (uvs * 8 * mb_h), ys, uvs)
    strengths = _filter_strengths(h)
    top_modes = [DC] * (4 * mb_w)
    nz = [[0, 0] for _ in range(mb_w + 1)]  # per column, then the left
    filters = []
    for mb_y in range(mb_h):
        left_modes = [DC] * 4
        row = [_intra_modes(h.br, h, top_modes, left_modes, mb_x)
               for mb_x in range(mb_w)]
        if h.br.eof:
            raise ValueError("VP8 first partition ends early")
        part = h.parts[mb_y & (len(h.parts) - 1)]
        nz[-1] = [0, 0]
        for mb_x, (segment, skip, i4x4, modes, uvmode) in enumerate(row):
            coeffs = [0] * 384
            q = h.quant[segment]
            nzy = nzuv = 0
            if not (h.use_skip and skip):
                nzy, nzuv = _residuals(part, h, q, i4x4, nz, mb_x, coeffs)
            else:
                nz[mb_x][0] = nz[-1][0] = 0
                if not i4x4:
                    nz[mb_x][1] = nz[-1][1] = 0
            if part.eof:
                raise ValueError("VP8 token partition ends early")
            limit, ilevel, hev_t = strengths[segment][int(i4x4)]
            filters.append((limit, ilevel, hev_t,
                            i4x4 or bool(nzy | nzuv)))
            _reconstruct(h, (i4x4, modes, uvmode, coeffs, nzy, nzuv), mb_x,
                         mb_y, planes)
    if h.filter_type:
        for i, info in enumerate(filters):
            _filter_mb(h, info, i % mb_w, i // mb_w, planes)
    Y, U, V = (np.array(p, np.uint8) for p in planes[:3])
    Y = Y.reshape(16 * mb_h, ys)[:h.height, :h.width]
    cw, ch = (h.width + 1) // 2, (h.height + 1) // 2
    U = U.reshape(8 * mb_h, uvs)[:ch, :cw]
    V = V.reshape(8 * mb_h, uvs)[:ch, :cw]
    return Y, U, V


# --- YUV 4:2:0 → RGB -------------------------------------------------------


def _upsample_rows(top: np.ndarray, cur: np.ndarray,
                   width: int) -> tuple[np.ndarray, np.ndarray]:
    """libwebp's UpsampleRgbLinePair on one chroma plane: the values for
    the row nearer `top` and the row nearer `cur`, [.., width] int64."""
    tl, l_ = top[..., :-1], cur[..., :-1]
    t, uv = top[..., 1:], cur[..., 1:]
    avg = tl + t + l_ + uv + 8
    diag12 = (avg + 2 * (t + l_)) >> 3
    diag03 = (avg + 2 * (tl + uv)) >> 3
    shape = top.shape[:-1] + (width,)
    near_top = np.empty(shape, np.int64)
    near_cur = np.empty(shape, np.int64)
    near_top[..., 0] = (3 * top[..., 0] + cur[..., 0] + 2) >> 2
    near_cur[..., 0] = (3 * cur[..., 0] + top[..., 0] + 2) >> 2
    pairs = (width - 1) >> 1
    near_top[..., 1:2 * pairs:2] = ((diag12 + tl) >> 1)[..., :pairs]
    near_top[..., 2:2 * pairs + 1:2] = ((diag03 + t) >> 1)[..., :pairs]
    near_cur[..., 1:2 * pairs:2] = ((diag03 + l_) >> 1)[..., :pairs]
    near_cur[..., 2:2 * pairs + 1:2] = ((diag12 + uv) >> 1)[..., :pairs]
    if not width & 1:
        near_top[..., -1] = (3 * top[..., pairs] + cur[..., pairs] + 2) >> 2
        near_cur[..., -1] = (3 * cur[..., pairs] + top[..., pairs] + 2) >> 2
    return near_top, near_cur


def _upsample(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    c = plane.astype(np.int64)
    out = np.empty((height, width), np.int64)
    out[0] = _upsample_rows(c[:1], c[:1], width)[0][0]
    pairs = (height - 1) // 2
    if pairs:
        near_top, near_cur = _upsample_rows(c[:pairs], c[1:pairs + 1], width)
        out[1:2 * pairs:2] = near_top
        out[2:2 * pairs + 1:2] = near_cur
    if height > 1 and not height & 1:
        last = c[pairs:pairs + 1]
        out[-1] = _upsample_rows(last, last, width)[0][0]
    return out


def _yuv_clip(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Planes → uint8 RGB [H, W, 3] as libwebp's fancy upsampler and
    VP8YUVToR/G/B give them."""
    height, width = y.shape
    uu = _upsample(u, height, width)
    vv = _upsample(v, height, width)
    yy = (y.astype(np.int64) * 19077) >> 8
    r = _yuv_clip(yy + ((vv * 26149) >> 8) - 14234)
    g = _yuv_clip(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708)
    b = _yuv_clip(yy + ((uu * 33050) >> 8) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """VP8 bytes → uint8 RGB [H, W, 3]."""
    return yuv_to_rgb(*decode_frame(data))


# Tables of RFC 6386 in libwebp's layout (its prediction-mode order).
_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16,
    17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25,
    25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37,
    38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77,
    78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93,
    95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151,
    154, 157,
)
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
    32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45,
    46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
    62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88,
    90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158,
    161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274,
    279, 284,
)
_BMODES_PROBA = (
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170,
    118, 46, 70, 95, 175, 69, 143, 80, 85, 82, 72, 155, 103, 56,
    58, 10, 171, 218, 189, 17, 13, 152, 114, 26, 17, 163, 44, 195,
    21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85, 144, 71,
    10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33,
    206, 71, 63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11,
    96, 182, 84, 29, 16, 36, 134, 183, 89, 137, 98, 101, 106, 165,
    148, 72, 187, 100, 130, 157, 111, 32, 75, 80, 66, 102, 167, 99,
    74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51,
    52, 31, 115, 128, 104, 79, 12, 27, 217, 255, 87, 17, 7, 87,
    68, 71, 44, 114, 51, 15, 186, 23, 47, 41, 14, 110, 182, 183,
    21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22, 88, 88,
    147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35,
    179, 61, 39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51,
    104, 114, 102, 29, 93, 77, 39, 28, 85, 171, 58, 165, 90, 98,
    64, 34, 22, 116, 206, 23, 34, 43, 166, 73, 107, 54, 32, 26,
    51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85,
    57, 50, 48, 51, 193, 101, 35, 159, 215, 111, 89, 46, 111, 60,
    148, 31, 172, 219, 228, 21, 18, 111, 112, 113, 77, 85, 179, 255,
    38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109, 88, 43,
    29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68,
    1, 209, 100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78,
    16, 255, 128, 34, 197, 171, 41, 40, 5, 102, 211, 183, 4, 1,
    221, 51, 50, 17, 168, 209, 192, 23, 25, 82, 138, 31, 36, 171,
    27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143,
    209, 34, 39, 175, 47, 15, 16, 183, 34, 223, 49, 45, 183, 46,
    17, 33, 183, 6, 98, 15, 32, 183, 57, 46, 22, 24, 128, 1,
    54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205, 40, 3,
    9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64,
    21, 47, 104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70,
    205, 40, 41, 23, 26, 57, 54, 57, 112, 184, 5, 41, 38, 166,
    213, 30, 34, 26, 133, 152, 116, 10, 32, 134, 39, 19, 53, 221,
    26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102,
    85, 55, 186, 85, 56, 21, 23, 111, 59, 205, 45, 37, 192, 55,
    38, 70, 124, 73, 102, 1, 34, 98, 125, 98, 42, 88, 104, 85,
    117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45, 75, 79,
    123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53,
    41, 49, 38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67,
    138, 77, 110, 90, 47, 114, 115, 21, 2, 10, 102, 255, 166, 23,
    6, 101, 29, 16, 10, 85, 128, 101, 196, 26, 57, 18, 10, 102,
    102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73,
    119, 28, 222, 37, 68, 45, 128, 34, 1, 47, 11, 245, 171, 62,
    17, 19, 70, 146, 85, 55, 62, 70, 37, 43, 37, 154, 100, 163,
    85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85, 75, 15,
    9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25,
    248, 1, 56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20,
    82, 135, 57, 26, 121, 40, 164, 50, 31, 137, 154, 133, 25, 35,
    218, 51, 103, 44, 131, 131, 123, 31, 6, 158, 86, 40, 64, 135,
    148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60,
    138, 23, 102, 213, 83, 12, 13, 54, 192, 255, 68, 47, 28, 85,
    26, 85, 85, 128, 128, 32, 146, 171, 18, 11, 7, 63, 144, 171,
    4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128, 190, 80,
    35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41,
    20, 32, 101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15,
    176, 236, 85, 37, 9, 62, 71, 30, 17, 119, 118, 255, 17, 18,
    138, 101, 38, 60, 138, 55, 70, 43, 26, 142, 146, 36, 19, 30,
    171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195,
    128, 48, 4, 24,
)
_COEFFS_PROBA0 = (
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128,
    128, 128, 189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106,
    126, 227, 252, 214, 209, 255, 255, 128, 128, 128, 1, 98, 248, 255,
    236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255,
    154, 128, 128, 128, 78, 134, 202, 247, 198, 180, 255, 219, 128, 128,
    128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128, 184, 150,
    247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236,
    230, 128, 128, 128, 128, 128, 1, 101, 251, 255, 241, 255, 128, 128,
    128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254,
    255, 245, 255, 128, 128, 128, 128, 128, 207, 160, 250, 255, 238, 128,
    128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128,
    128, 128, 1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177,
    135, 243, 255, 234, 225, 128, 128, 128, 128, 128, 80, 129, 211, 255,
    194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128,
    128, 128, 128, 128, 246, 1, 255, 128, 128, 128, 128, 128, 128, 128,
    128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 198, 35,
    237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172,
    176, 220, 157, 252, 221, 1, 68, 47, 146, 208, 149, 167, 221, 162,
    255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181,
    242, 176, 190, 249, 202, 255, 255, 128, 1, 129, 232, 253, 214, 197,
    242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128,
    128, 128, 23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1,
    200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109, 178, 241, 255,
    231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255,
    255, 128, 128, 128, 1, 132, 239, 251, 219, 209, 255, 165, 128, 128,
    128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128, 22, 100,
    174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232,
    235, 128, 128, 128, 128, 128, 124, 143, 241, 255, 227, 234, 128, 128,
    128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235,
    255, 225, 227, 255, 255, 128, 128, 128, 45, 99, 188, 251, 195, 217,
    255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128,
    128, 128, 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137,
    1, 177, 255, 224, 255, 128, 128, 128, 128, 128, 253, 9, 248, 251,
    207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249,
    198, 255, 255, 128, 73, 17, 171, 221, 161, 179, 236, 167, 255, 234,
    128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128, 239, 90,
    244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188,
    195, 255, 255, 128, 128, 128, 1, 24, 239, 251, 218, 219, 255, 205,
    128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251,
    255, 255, 128, 128, 128, 128, 128, 128, 223, 165, 249, 255, 213, 255,
    128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128,
    128, 128, 1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190,
    36, 230, 255, 236, 255, 128, 128, 128, 128, 128, 149, 1, 255, 128,
    128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128,
    128, 128, 128, 128, 247, 192, 255, 128, 128, 128, 128, 128, 128, 128,
    128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 134,
    252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255,
    128, 128, 128, 128, 128, 128, 55, 93, 255, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 202, 24, 213, 235, 186, 191,
    220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255,
    187, 128, 61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1,
    112, 230, 250, 199, 191, 247, 159, 255, 255, 128, 166, 109, 228, 252,
    211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245,
    178, 255, 255, 128, 1, 52, 220, 246, 198, 199, 249, 220, 255, 255,
    128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128, 24, 71,
    130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219,
    240, 255, 224, 128, 128, 128, 149, 150, 226, 252, 216, 205, 255, 171,
    128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209,
    247, 188, 196, 255, 233, 128, 128, 128, 20, 95, 153, 243, 164, 173,
    255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128,
    128, 128, 168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47,
    116, 215, 255, 211, 212, 255, 255, 128, 128, 128, 1, 121, 236, 253,
    212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255,
    219, 128, 128, 128, 42, 80, 160, 240, 162, 185, 255, 205, 128, 128,
    128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 244, 1,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128,
    128, 128, 128, 128, 128, 128,
)
_COEFFS_UPDATE_PROBA = (
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249,
    253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 244, 252, 255,
    255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255, 239, 253,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250,
    255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 217, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255,
    255, 254, 255, 255, 255, 255, 234, 250, 241, 250, 253, 255, 253, 254,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 186, 251, 250, 255,
    255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255,
    255, 255, 255, 255, 251, 251, 243, 253, 254, 255, 254, 255, 255, 255,
    255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 236, 253,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 248, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255,
    255, 255, 248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 246, 253, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255,
    255, 255, 255, 255, 255, 254, 252, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 245, 251, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255,
)
