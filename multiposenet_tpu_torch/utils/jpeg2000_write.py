"""JPEG 2000 as OpenCV 5.0 writes it: `cv2.imencode(".jp2", bgr)` at its
defaults, through OpenJPEG 2.5.3 (`Jpeg2KOpjEncoder::write`,
`opj_encode`).

The contract. For every uint8 RGB image [H, W, 3] with both sides at
least `MIN_SIDE` (32), `encode` (host C) and `encode_plain` (this
module's Python) return the bytes `cv2.imencode(".jp2", rgb[..., ::-1])`
returns, byte for byte. An image with a side under 32 has no codestream:
OpenJPEG refuses five decomposition levels on a tile narrower than 2^5
after it has written the JP2 boxes, so cv2.imencode fails and
cv2.imwrite returns False with those 77 bytes (`jp2_header`) in its
file. Here `encode` raises a ValueError and `image_io.write_image`
writes `jp2_header` and returns False.

What cv2 asks of OpenJPEG (`opj_set_default_encoder_parameters`, then
one layer at rate 4; `tcp_mct` stays 0, so R, G and B are coded each
alone) and so what is written:
- a JP2 file: the signature box, `ftyp` ('jp2 ', minor version 0, one
  compatible brand 'jp2 '), `jp2h` holding `ihdr` (height, width, 3
  components, 8 bits, compression 7, colour space known, no IPR) and
  `colr` (method 1, enumerated colour space 16, sRGB), then `jp2c` with
  the codestream;
- the main header: SOC; SIZ (profile 0, one tile the size of the image
  at offset 0, three unsigned 8-bit components, no sub-sampling); COD
  (LRCP, one layer, no component transform, 5 decomposition levels,
  64 x 64 code-blocks, code-block style 0, the reversible 5/3, no
  precincts);
  QCD (no quantisation, 2 guard bits, exponents 8, 9, 9, 10 by band
  gain); COM (Latin-1, "Created by OpenJPEG version 2.5.3"); then one
  tile part (SOT with Psot, Isot 0, TPsot 0, TNsot 1; SOD; the packets)
  and EOC.
- the tile (`opj_tcd_encode_tile`), in its order: the DC level shift
  (-128), the forward 5/3 at 5 levels (each level the columns, then the
  rows, each resolution's origin at 0), tier 1 on each code-block
  (`opj_t1_encode_cblk`: the MQ coder of `mqc.c`, three passes a
  bit-plane, one termination with `opj_mqc_flush` after the last
  cleanup pass; each pass's rate, the coder's byte count plus 3 for a
  pass that is not terminated, and its distortion, `opj_t1_getwmsedec`
  with the `lut_nmsedec_*` tables made by `t1_generate_luts.c`'s formula
  and the 5/3 norms; the rates then made non-decreasing from the end,
  and a rate that would end on 0xFF one less), the rate allocation
  (`opj_j2k_update_rates`: the budget is the raw size over 4 less the
  bytes written before the first SOT, in float; `opj_tcd_rateallocate`:
  the slopes' range, then up to 128 bisection steps on the slope
  threshold, stopping when a step moves it by no more than 5e-6 of
  itself, each step sizing the layer by a simulated
  `opj_t2_encode_packets`, `opj_tcd_makelayer` taking a code-block's
  passes up to the last whose slope from the passes already taken
  reaches the threshold) and tier 2 (`opj_t2_encode_packet` in LRCP:
  inclusion and zero-bit-plane tag trees, pass counts, Lblock
  increments, lengths, a 0 bit after each 0xFF of a header, the
  code-blocks' bytes).

OpenJPEG's float arithmetic is kept in its order: the distortions and
slopes in double, the budget in float, so the same slopes meet the same
thresholds. The host C version is `csrc/jpeg2000_write.c`, built into
the same library as the decoder (`jpeg2000.library()`), compiled
without contraction of float operations (`-std=c99`).
"""

from __future__ import annotations

import ctypes
import math
import struct
import sys

import numpy as np

from multiposenet_tpu_torch.utils import jpeg2000 as j2k

MIN_SIDE = 32  # 2^(decomposition levels)
NUMRES = 6
CBLK_EXP = 6  # 64 x 64 code-blocks
GUARD_BITS = 2
RATE = 4.0  # cv2's tcp_rates[0]: 4:1
COMMENT = b"Created by OpenJPEG version 2.5.3"
DBL_EPSILON = sys.float_info.epsilon
DBL_MAX = sys.float_info.max

# opj_dwt_norms (dwt.c): the 5/3 synthesis norms by band orientation and
# decomposition level (index: the level of an LL band, one less for the
# others).
DWT_NORMS = (
    (1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3),
    (1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9),
    (1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9),
    (.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93),
)

NMSEDEC_BITS = 7
NMSEDEC_FRACBITS = NMSEDEC_BITS - 1


def nmsedec_tables() -> tuple[list[int], list[int], list[int], list[int]]:
    """lut_nmsedec_sig, _sig0, _ref and _ref0 as `t1_generate_luts.c`
    computes them: the decrease of the squared error, in 1/8192 units
    rounded to 1/64, when a sample's bit-plane is coded (significance or
    refinement) at a bit-plane above 0 and at 0."""
    scale = 2.0 ** NMSEDEC_FRACBITS

    def entry(x: float) -> int:
        return max(0, int(math.floor(x * scale + 0.5) / scale * 8192.0))

    sig, sig0, ref, ref0 = [], [], [], []
    for i in range(1 << NMSEDEC_BITS):
        t = i / scale
        u, v = t, t - 1.5
        sig.append(entry(u * u - v * v))
        sig0.append(entry(u * u))
        u = t - 1.0
        v = t - 1.5 if i & (1 << (NMSEDEC_BITS - 1)) else t - 0.5
        ref.append(entry(u * u - v * v))
        ref0.append(entry(u * u))
    return sig, sig0, ref, ref0


_SIG, _SIG0, _REF, _REF0 = nmsedec_tables()


def _check(rgb: np.ndarray) -> np.ndarray:
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError("the JPEG 2000 writer takes uint8 RGB [H, W, 3]; "
                         f"got {rgb.dtype} {rgb.shape}")
    if min(rgb.shape[:2]) < MIN_SIDE:
        raise ValueError(f"JPEG 2000: a side under {MIN_SIDE} pixels "
                         f"({rgb.shape[0]}x{rgb.shape[1]}) is not written, "
                         "as cv2 writes no file for it")
    return np.ascontiguousarray(rgb)


# --- the forward transforms --------------------------------------------------


def _fdwt53(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One forward 5/3 pass along axis 0 on a signal starting at an even
    coordinate (opj_dwt_encode_1 with cas 0): [n, K] → (low [ceil(n/2)],
    high [floor(n/2)])."""
    s, d = x[0::2].copy(), x[1::2].copy()
    sn, dn = len(s), len(d)
    if dn == 0:
        return s, d
    i = np.arange(dn)
    d -= (s[i] + s[np.minimum(i + 1, sn - 1)]) >> 1
    i = np.arange(sn)
    s += (d[np.clip(i - 1, 0, dn - 1)] + d[np.minimum(i, dn - 1)] + 2) >> 2
    return s, d


def forward_dwt(plane: np.ndarray, geometry) -> np.ndarray:
    """opj_dwt_encode on one tile-component: for each level from the
    finest, the columns, then the rows of the resolution, lows before
    highs. Returns the int64 [h, w] array of sub-bands that
    `jpeg2000.inverse_dwt` takes."""
    arr = plane.astype(np.int64)
    for r in range(len(geometry) - 1, 0, -1):
        cur = geometry[r]
        rw, rh = cur.x1 - cur.x0, cur.y1 - cur.y0
        lo, hi = _fdwt53(arr[:rh, :rw])
        arr[:rh, :rw] = np.concatenate([lo, hi])
        lo, hi = _fdwt53(arr[:rh, :rw].T)
        arr[:rh, :rw] = np.concatenate([lo, hi]).T
    return arr


# --- tier 1 ------------------------------------------------------------------


class _MQEncoder:
    """opj_mqc's encoder (Annex C.2) on registers as OpenJPEG keeps them:
    `buf[0]` is the byte before the code-block's data that `bp` starts
    on."""

    def __init__(self, size: int):
        self.buf = bytearray(size + 2)
        self.bp = 0
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.st = [0] * 19
        self.mps = [0] * 19
        self.st[j2k._CTX_UNI], self.st[j2k._CTX_AGG], self.st[0] = 46, 3, 4

    def numbytes(self) -> int:
        return self.bp - 1

    def _byteout(self) -> None:
        buf = self.buf
        if buf[self.bp] == 0xFF:
            self.bp += 1
            buf[self.bp] = self.c >> 20
            self.c &= 0xFFFFF
            self.ct = 7
        elif not self.c & 0x8000000:
            self.bp += 1
            buf[self.bp] = (self.c >> 19) & 0xFF
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            buf[self.bp] += 1
            if buf[self.bp] == 0xFF:
                self.c &= 0x7FFFFFF
                self.bp += 1
                buf[self.bp] = self.c >> 20
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.bp += 1
                buf[self.bp] = (self.c >> 19) & 0xFF
                self.c &= 0x7FFFF
                self.ct = 8

    def encode(self, cx: int, d: int) -> None:
        s = self.st[cx]
        q = j2k._QE[s]
        self.a -= q
        if self.mps[cx] == d:
            if self.a & 0x8000:
                self.c += q
                return
            if self.a < q:
                self.a = q
            else:
                self.c += q
            self.st[cx] = j2k._NMPS[s]
        else:
            if self.a < q:
                self.c += q
            else:
                self.a = q
            if j2k._SWITCH[s]:
                self.mps[cx] = 1 - self.mps[cx]
            self.st[cx] = j2k._NLPS[s]
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def flush(self) -> None:
        """opj_mqc_flush: SETBITS, two byte-outs, and no final 0xFF."""
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        if self.buf[self.bp] != 0xFF:
            self.bp += 1


class CodeBlock:
    """A code-block's tier-1 result: its bytes, and per coding pass the
    cumulative rate (bytes) and distortion decrease."""

    def __init__(self, numbps: int, data: bytes, rates: list[int],
                 dists: list[float]):
        self.numbps = numbps
        self.data = data
        self.rates = rates
        self.dists = dists


# The sign context and XOR bit by the horizontal and vertical sums of the
# neighbours' signs (-2..2 each, at hc * 5 + vc + 12), Table D.3 as the
# decoder's `_SC` gives it.
_SIGN_CONTEXTS = [j2k._SC[(max(-1, min(1, hc)), max(-1, min(1, vc)))]
                  for hc in range(-2, 3) for vc in range(-2, 3)]


def wmsedec(nmsedec: int, level: int, orient: int, bpno: int) -> float:
    """opj_t1_getwmsedec for the 5/3 without a component transform (step
    size 1), in its order of double operations."""
    w = 1.0 * DWT_NORMS[orient][
        min(level, 9 if orient == 0 else 8)] * 1.0 * float(1 << bpno)
    return w * (w * nmsedec / 8192.0)


def encode_cblk(coeffs: np.ndarray, orient: int, level: int) -> CodeBlock:
    """opj_t1_encode_cblk (code-block style 0) on one code-block's int
    coefficients [h, w]."""
    h, w = coeffs.shape
    W = w + 2
    size = W * (h + 2)
    padded = np.zeros((h + 2, W), np.int64)
    padded[1:-1, 1:-1] = coeffs
    top = int(np.abs(padded).max())
    if top == 0:
        return CodeBlock(0, b"", [], [])
    numbps = top.bit_length()
    mag = (np.abs(padded) << NMSEDEC_FRACBITS).ravel().tolist()
    neg = (padded < 0).ravel().astype(int).tolist()
    sig = [0] * size
    vis = [0] * size
    ref = [0] * size
    # The zero-coding index h * 15 + v * 5 + d of each sample's
    # significant neighbours, kept as they become significant.
    nb = [0] * size
    spread = ((-1, 15), (1, 15), (-W, 5), (W, 5), (-W - 1, 1), (-W + 1, 1),
              (W - 1, 1), (W + 1, 1))
    mq = _MQEncoder(h * w * 4 + 74)
    encode = mq.encode
    zc = j2k._ZC[orient]
    rates, dists = [], []
    cum = 0.0

    def significant(p, bpno):
        """Code the sign of a sample that became significant; its
        distortion decrease."""
        hc = (sig[p - 1] * (1 - 2 * neg[p - 1])
              + sig[p + 1] * (1 - 2 * neg[p + 1]))
        vc = (sig[p - W] * (1 - 2 * neg[p - W])
              + sig[p + W] * (1 - 2 * neg[p + W]))
        ctx, xor = _SIGN_CONTEXTS[hc * 5 + vc + 12]
        encode(ctx, neg[p] ^ xor)
        sig[p] = 1
        for d, weight in spread:
            nb[p + d] += weight
        x = mag[p]
        return _SIG[(x >> bpno) & 127] if bpno > 0 else _SIG0[x & 127]

    bpno = numbps - 1
    passtype = 2
    while bpno >= 0:
        one = 1 << (bpno + NMSEDEC_FRACBITS)
        nmsedec = 0
        for y0 in range(0, h, 4):
            rows = min(4, h - y0)
            for x in range(w):
                col = (y0 + 1) * W + x + 1
                end = col + rows * W
                if passtype == 0:
                    for p in range(col, end, W):
                        if sig[p] or vis[p] or not nb[p]:
                            continue
                        v = 1 if mag[p] & one else 0
                        encode(zc[nb[p]], v)
                        if v:
                            nmsedec += significant(p, bpno)
                        vis[p] = 1
                elif passtype == 1:
                    for p in range(col, end, W):
                        if not sig[p] or vis[p]:
                            continue
                        m = mag[p]
                        nmsedec += (_REF[(m >> bpno) & 127] if bpno > 0
                                    else _REF0[m & 127])
                        encode(j2k._CTX_MAG + (2 if ref[p] else 1 if nb[p]
                                               else 0),
                               1 if m & one else 0)
                        ref[p] = 1
                else:
                    start = col
                    if rows == 4 and not (
                            sig[col] or vis[col] or nb[col]
                            or sig[col + W] or vis[col + W] or nb[col + W]
                            or sig[end - 2 * W] or vis[end - 2 * W]
                            or nb[end - 2 * W] or sig[end - W]
                            or vis[end - W] or nb[end - W]):
                        run = 0
                        while run < 4 and not mag[col + run * W] & one:
                            run += 1
                        encode(j2k._CTX_AGG, run != 4)
                        if run == 4:
                            continue
                        encode(j2k._CTX_UNI, run >> 1)
                        encode(j2k._CTX_UNI, run & 1)
                        p = col + run * W
                        nmsedec += significant(p, bpno)
                        start = p + W
                    for p in range(start, end, W):
                        if sig[p] or vis[p]:
                            continue
                        v = 1 if mag[p] & one else 0
                        encode(zc[nb[p]], v)
                        if v:
                            nmsedec += significant(p, bpno)
        cum += wmsedec(nmsedec, level, orient, bpno)
        dists.append(cum)
        if passtype == 2:
            vis = [0] * size
        if passtype == 2 and bpno == 0:
            mq.flush()
            rates.append(mq.numbytes())
        else:
            rates.append((mq.numbytes() + 3) & 0xFFFFFFFF)
        passtype += 1
        if passtype == 3:
            passtype = 0
            bpno -= 1
    data = bytes(mq.buf[1:1 + mq.numbytes()])
    last = mq.numbytes()
    for i in range(len(rates) - 1, -1, -1):
        if rates[i] > last:
            rates[i] = last
        else:
            last = rates[i]
    for i, r in enumerate(rates):
        if mq.buf[r] == 0xFF:  # data[r - 1]
            rates[i] = r - 1
    return CodeBlock(numbps, data, rates, dists)


# --- tier 2 ------------------------------------------------------------------


class _BitWriter:
    """opj_bio's writer: bits MSB first, 7 bits in the byte after 0xFF."""

    def __init__(self):
        self.out = bytearray()
        self.buf, self.ct = 0, 8

    def _byteout(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def put(self, v: int, n: int = 1) -> None:
        for i in range(n - 1, -1, -1):
            if self.ct == 0:
                self._byteout()
            self.ct -= 1
            self.buf |= ((v >> i) & 1) << self.ct

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class _TagTreeEncoder(j2k.TagTree):
    """opj_tgt's encoder over the decoder's tree layout."""

    def __init__(self, w: int, h: int):
        super().__init__(w, h)
        self.known = [0] * len(self.parent)

    def set(self, leaf: int, value: int) -> None:
        node = leaf
        while node >= 0 and self.value[node] > value:
            self.value[node] = value
            node = self.parent[node]

    def encode(self, bio: _BitWriter, leaf: int, threshold: int) -> None:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bio.put(1)
                        self.known[node] = 1
                    break
                bio.put(0)
                low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()


def _floorlog2(a: int) -> int:
    return max(a, 1).bit_length() - 1


def _putnumpasses(bio: _BitWriter, n: int) -> None:
    if n == 1:
        bio.put(0, 1)
    elif n == 2:
        bio.put(2, 2)
    elif n <= 5:
        bio.put(0xC | (n - 3), 4)
    elif n <= 36:
        bio.put(0x1E0 | (n - 6), 9)
    else:
        bio.put(0xFF80 | (n - 37), 16)


def packet_header(bands) -> bytes:
    """opj_t2_encode_packet's header of layer 0 for one precinct:
    `bands` is a list of (cw, ch, band Mb, [(code-block, passes)])."""
    bio = _BitWriter()
    bio.put(1)
    for cw, ch, band_numbps, blocks in bands:
        incl = _TagTreeEncoder(cw, ch)
        imsb = _TagTreeEncoder(cw, ch)
        for i, (cb, n) in enumerate(blocks):
            imsb.set(i, band_numbps - cb.numbps)
            if n:
                incl.set(i, 0)
        for i, (cb, n) in enumerate(blocks):
            incl.encode(bio, i, 1)
            if not n:
                continue
            imsb.encode(bio, i, 999)
            _putnumpasses(bio, n)
            # One codeword segment: Lblock's increment as a comma code,
            # then the length in 3 + increment + floor(log2(passes)) bits.
            length = cb.rates[n - 1]
            increment = max(0, _floorlog2(length) + 1
                            - (3 + _floorlog2(n)))
            bio.put((1 << increment) - 1 << 1, increment + 1)
            bio.put(length, 3 + increment + _floorlog2(n))
    return bio.flush()


# --- the tile ----------------------------------------------------------------


class _Params:
    """The tile-component parameters tile_geometry takes: one precinct a
    resolution, 64 x 64 code-blocks."""
    numres = NUMRES
    cblkw = cblkh = CBLK_EXP
    prcw = prch = [15] * NUMRES


BAND_NUMBPS = (9, 10, 10, 11)  # expn (8 + gain) + guard bits - 1


def tile_blocks(rgb: np.ndarray):
    """Tier 1 over the image: per resolution, per component, the packet's
    bands as `packet_header` takes them (passes still to be chosen)."""
    h, w = rgb.shape[:2]
    geometry = j2k.tile_geometry((0, 0, w, h), _Params)
    comps = []
    for compno in range(3):
        plane = rgb[..., compno].astype(np.int64) - 128
        arr = forward_dwt(plane, geometry)
        comps.append(_component_blocks(arr, geometry))
    return [[comps[c][r] for c in range(3)] for r in range(NUMRES)]


def _component_blocks(arr, geometry):
    out = []
    for resno, res in enumerate(geometry):
        level = NUMRES - 1 - resno
        bands = []
        for band in res.bands:
            ox = oy = 0
            if band.bandno & 1:
                prev = geometry[resno - 1]
                ox = prev.x1 - prev.x0
            if band.bandno & 2:
                prev = geometry[resno - 1]
                oy = prev.y1 - prev.y0
            prc = band.precincts[0]
            blocks = []
            for cb in prc.cblks:
                coeffs = arr[oy + cb.y0 - band.y0:oy + cb.y1 - band.y0,
                             ox + cb.x0 - band.x0:ox + cb.x1 - band.x0]
                blocks.append(encode_cblk(coeffs, band.bandno, level))
            bands.append((prc.cw, prc.ch, BAND_NUMBPS[band.bandno], blocks))
        out.append(bands)
    return out


def _all_blocks(packets):
    for comps in packets:
        for bands in comps:
            for _, _, _, blocks in bands:
                yield from blocks


def slope_range(packets) -> tuple[float, float]:
    """opj_tcd_rateallocate's min and max of each pass's slope."""
    lo, hi = DBL_MAX, 0.0
    for cb in _all_blocks(packets):
        prev_r, prev_d = 0, 0.0
        for r, d in zip(cb.rates, cb.dists):
            dr = r - prev_r
            dd = d - prev_d
            prev_r, prev_d = r, d
            if dr == 0:
                continue
            s = dd / dr
            lo = min(lo, s)
            hi = max(hi, s)
    return lo, hi


def passes_at(cb: CodeBlock, thresh: float) -> int:
    """opj_tcd_makelayer's pass count for layer 0 at `thresh`."""
    n = 0
    for passno, (r, d) in enumerate(zip(cb.rates, cb.dists)):
        if n == 0:
            dr, dd = r, d
        else:
            dr, dd = r - cb.rates[n - 1], d - cb.dists[n - 1]
        if dr == 0:
            if dd != 0:
                n = passno + 1
            continue
        if thresh - dd / dr < DBL_EPSILON:
            n = passno + 1
    return n


def _layer(packets, thresh: float):
    return [[[(cw, ch, mb, [(cb, passes_at(cb, thresh)) for cb in blocks])
              for cw, ch, mb, blocks in bands] for bands in comps]
            for comps in packets]


def _packets_size(layer) -> int:
    size = 0
    for comps in layer:
        for bands in comps:
            size += len(packet_header(bands))
            for _, _, _, blocks in bands:
                size += sum(cb.rates[n - 1] for cb, n in blocks if n)
    return size


def budget(h: int, w: int, header_bytes: int) -> int:
    """opj_j2k_update_rates and opj_tcd_rateallocate's maxlen: the raw
    size over the rate, less the bytes before the first SOT, in float,
    rounded up. (OpenJPEG caps it by its output buffer too, 1.4 times the
    raw size and more, which a budget of a quarter never reaches.)"""
    f32 = np.float32
    rate = f32((24.0 * w * h) / float(f32(RATE) * f32(8.0)))
    rate = f32(rate - f32(0.0))
    rate = f32(rate - f32(f32(header_bytes) / f32(1.0)))
    if rate < f32(30.0):
        rate = f32(30.0)
    return math.ceil(float(rate))


def allocate(packets, maxlen: int) -> float:
    """opj_tcd_rateallocate's search for layer 0's threshold: bisection
    between the slopes' range, up to 128 steps, stopping when a step
    moves the threshold by no more than 5e-6 of itself; a threshold
    fits when the layer's packets take at most `maxlen` bytes."""
    lo, hi = slope_range(packets)
    stable = thresh = 0.0
    sizes = {}
    for _ in range(128):
        new = (lo + hi) / 2
        if abs(new - thresh) <= 5e-6 * thresh:
            break
        thresh = new
        layer = _layer(packets, thresh)
        key = tuple(n for comps in layer for bands in comps
                    for _, _, _, blocks in bands for _, n in blocks)
        if key not in sizes:
            sizes[key] = _packets_size(layer)
        if sizes[key] > maxlen:
            lo = thresh
        else:
            hi = stable = thresh
    return thresh if stable == 0 else stable


def tile_data(packets, thresh: float) -> bytes:
    out = bytearray()
    for comps in _layer(packets, thresh):
        for bands in comps:
            out += packet_header(bands)
            for _, _, _, blocks in bands:
                for cb, n in blocks:
                    if n:
                        out += cb.data[:cb.rates[n - 1]]
    return bytes(out)


# --- the file ----------------------------------------------------------------


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def jp2_header(h: int, w: int) -> bytes:
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, 3, 7, 7, 0, 0))
    colr = _box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16))
    return (j2k.JP2_SIGNATURE + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + _box(b"jp2h", ihdr + colr))


def main_header(h: int, w: int) -> bytes:
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, 3) \
        + b"\x07\x01\x01" * 3
    cod = struct.pack(">BBHBBBBBB", 0, 0, 1, 0, NUMRES - 1, CBLK_EXP - 2,
                      CBLK_EXP - 2, 0, 1)
    qcd = bytes([GUARD_BITS << 5, 8 << 3] + [9 << 3, 9 << 3, 10 << 3]
                * (NUMRES - 1))
    com = struct.pack(">H", 1) + COMMENT
    out = b"\xff\x4f"
    for marker, body in ((0xFF51, siz), (0xFF52, cod), (0xFF5C, qcd),
                         (0xFF64, com)):
        out += struct.pack(">HH", marker, 2 + len(body)) + body
    return out


def assemble(h: int, w: int, data: bytes) -> bytes:
    sot = struct.pack(">HHHIBB", 0xFF90, 10, 0, 12 + 2 + len(data), 0, 1)
    codestream = main_header(h, w) + sot + b"\xff\x93" + data + b"\xff\xd9"
    return jp2_header(h, w) + _box(b"jp2c", codestream)


def header_bytes(h: int, w: int) -> int:
    """The bytes OpenJPEG's stream has written when it sets the rates:
    the JP2 boxes up to jp2c's box header, and the main header."""
    return len(jp2_header(h, w)) + 8 + len(main_header(h, w))


def encode_plain(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] → cv2.imencode(".jp2")'s bytes, in Python."""
    rgb = _check(rgb)
    h, w = rgb.shape[:2]
    packets = tile_blocks(rgb)
    thresh = allocate(packets, budget(h, w, header_bytes(h, w)))
    return assemble(h, w, tile_data(packets, thresh))


def tile_data_c(rgb: np.ndarray, maxlen: int) -> bytes:
    """The tile's packets (`tile_data` after `allocate`) from the host C
    library."""
    h, w = rgb.shape[:2]
    lib = j2k.library()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cap = maxlen + 65536
    while True:
        out = np.empty(cap, np.uint8)
        n = ctypes.c_long(0)
        rc = lib.j2k_encode_tile(rgb.ctypes.data_as(u8p), h, w, maxlen,
                                 out.ctypes.data_as(u8p), cap,
                                 ctypes.byref(n))
        if rc == 3:
            cap = n.value
            continue
        if rc:
            raise MemoryError("jpeg2000: out of memory")
        return out[:n.value].tobytes()


def encode(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] → cv2.imencode(".jp2")'s bytes, tiers 1 and 2
    and the rate allocation in the host C library."""
    rgb = _check(rgb)
    h, w = rgb.shape[:2]
    return assemble(h, w, tile_data_c(rgb, budget(h, w, header_bytes(h, w))))
