"""The AVIF writer (`utils/avif_write.py`, `utils/av1_encode.py` and the
host C library `csrc/av1_encode.c`) against cv2 5.0 at its defaults
(libavif 1.4.2 over libaom 3.14.1, quality 50, speed 9):

- each stage against the wheel's own function, called over ctypes on
  seeded input: the RGB to YUV conversion against libyuv's RGB24ToJ420
  and libavif's avifImageRGBToYUV; the quantizer tables against
  av1_build_quantizer; the forward transforms against
  av1_lowbd_fwd_txfm_c; the fp quantizer with quantizer
  matrices against av1_quantize_fp_facade; the Hadamard transforms and
  the low-precision quantizer of the mode estimate against
  aom_hadamard_lp_*_c and av1_quantize_lp_c; the rate tables against
  av1_cost_tokens_from_cdf; the trellis against av1_optimize_txb (its
  MACROBLOCK and AV1_COMP laid out by hand, the fields it reads filled
  in: `_Aom.optimize_txb`); each also C against plain;
- the tile writer: the decisions the port's decoder reads from cv2's
  files, written anew, give cv2's bytes;
- the files: `encode` (C) and `encode_plain` (Python, on the small ones)
  return `cv2.imencode(".avif", bgr)`'s bytes for the photo, a drawing
  of people on it, a text drawing, noise, flat colour and the sides
  1x1, 7x5, 33x17, 64x80, 64x5120 (two tile columns), 720x1280 and
  2160x2160;
- a 20-case slice of `tools/avif_write_search.py`.
"""

import ctypes
from pathlib import Path

import cv2
import numpy as np
import pytest

import avif_reference as ar
from multiposenet_tpu_torch.tools import avif_write_search
from multiposenet_tpu_torch.utils import (av1, av1_encode, avif, avif_write,
                                          image_io)
from multiposenet_tpu_torch.utils.av1_tables import table
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(ar.LIBAOM is None,
                                reason="the opencv-python wheel's libaom "
                                       "is absent")

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
PHOTO = image_io.read_image(FIXTURES / "photo_480x640_q95_420.jpg")
# The transforms the encoder codes: the square ones of luma, and chroma's
# of rectangular blocks.
TXS = {0: "4x4", 1: "8x8", 2: "16x16", 3: "32x32", 5: "4x8", 6: "8x4",
       7: "8x16", 8: "16x8"}
vp = ctypes.c_void_p


def _cv2(rgb: np.ndarray) -> bytes:
    ok, data = cv2.imencode(".avif", np.ascontiguousarray(rgb[..., ::-1]))
    assert ok
    return data.tobytes()


def _aligned(n: int, dtype) -> np.ndarray:
    a = np.zeros(n + 64, dtype)
    off = (-a.ctypes.data % 64) // a.itemsize
    return a[off:off + n]


def _scan(tx: int) -> np.ndarray:
    n = (1 << av1.TX_WLOG2[tx]) << av1.TX_HLOG2[tx]
    so = table("scan_offset")[tx][0]
    return np.ascontiguousarray(table("scan_data")[so:so + n], np.int16)


@pytest.fixture(scope="module")
def aom():
    """libaom's run-time dispatch set up (a decoder made, then av1_rtcd
    and aom_dsp_rtcd, which the encoder's stages call through)."""
    ar.aom_planes(ar.primary_obus(
        (FIXTURES / "avif_odd_33x17.avif").read_bytes()))
    ar.libaom_function("av1_rtcd", None)()
    ar.libaom_function("aom_dsp_rtcd", None)()
    return _Aom()


class _Aom:
    """libaom's encoder stages over ctypes."""

    def __init__(self):
        self.build = ar.libaom_function(
            "av1_build_quantizer", None, *([ctypes.c_int] * 6), vp, vp,
            ctypes.c_int)
        self.quants = np.zeros(1 << 19, np.int16)
        self.dequants = np.zeros(1 << 19, np.int16)
        self.build(8, 0, av1_encode.CHROMA_DELTA_Q,
                   av1_encode.CHROMA_DELTA_Q, av1_encode.CHROMA_DELTA_Q,
                   av1_encode.CHROMA_DELTA_Q, self.quants.ctypes.data,
                   self.dequants.ctypes.data, 0)
        self.optimize = ar.libaom_function(
            "av1_optimize_txb", ctypes.c_int, vp, vp, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, vp, ctypes.c_int)
        self.keep = []

    def table(self, k: int) -> np.ndarray:
        """QUANTS's k-th [256][8] int16 table (y_quant 0, y_quant_shift 1,
        y_zbin 2, y_round 3, y/u/v_quant_fp 4-6, y/u/v_round_fp 7-9, ...)."""
        return self.quants.reshape(-1, 256, 8)[k]

    def dequant(self, plane: int, q: int) -> np.ndarray:
        return np.ascontiguousarray(self.dequants.reshape(-1, 256, 8)[plane]
                                    [q])

    def plane_struct(self, plane: int, q: int, **ptrs) -> np.ndarray:
        """A MACROBLOCK_PLANE: dqcoeff 0x8, qcoeff 0x10, coeff 0x18, eobs
        0x20, txb_entropy_ctx 0x28, quant_fp 0x50, round_fp 0x58, quant
        0x60, round 0x68, quant_shift 0x70, zbin 0x78, dequant 0x80."""
        p = np.zeros(0x88 // 8, np.uint64)
        tabs = [np.ascontiguousarray(self.table(k)[q]) for k in
                (4 + plane, 7 + plane)] + [self.dequant(plane, q)]
        self.keep += tabs
        p[0x50 // 8], p[0x58 // 8], p[0x80 // 8] = (t.ctypes.data
                                                    for t in tabs)
        for off, a in ptrs.items():
            p[int(off[1:], 16) // 8] = a.ctypes.data
        return p

    def optimize_txb(self, qc, dq, coeff, eob, tx, plane, skip_ctx, dc_ctx,
                     rdmult, q, costs) -> list:
        """av1_optimize_txb at sharpness 7 on one DCT_DCT block, with a
        zeroed AV1_COMP (tuning AOM_TUNE_IQ at 0x432b8, dist_metric
        QM-PSNR at 0x432c4, the chroma plane_rd_mult table chosen at
        0x61b88) and MACROBLOCK (the plane at plane * 0x88, xd at 0x1a0
        with the mode info pointer at 0x2058 and bit depth at 0x2b40, the
        quantizer matrices at xd + 8 * (0x18 or 0xb0 + tx + 0x146 plane),
        rdmult at 0x4230, the coefficient costs at 0xb9f0 (the txb skip
        costs, which sharpness 7 never reads, left 0), eob costs after
        them): the levels after it."""
        cpi, x = _aligned(1 << 20, np.uint8), _aligned(1 << 20, np.uint8)
        mi, mip = _aligned(512, np.uint8), _aligned(1, np.uint64)
        mip[0] = mi.ctypes.data
        n = len(qc)
        bufs = {k: _aligned(n, np.int32) for k in ("c", "q", "d")}
        bufs["c"][:], bufs["q"][:], bufs["d"][:] = coeff, qc, dq
        eobs, ents = _aligned(4, np.uint16), _aligned(4, np.uint8)
        eobs[0] = eob
        plane_ = self.plane_struct(plane, q, o8=bufs["d"], o10=bufs["q"],
                                   o18=bufs["c"], o20=eobs, o28=ents)
        x[plane * 0x88:(plane + 1) * 0x88] = plane_.view(np.uint8)
        wt, iwt = (np.ascontiguousarray(m, np.uint8)
                   for m in av1_encode.qm_weights(tx, plane))

        def put(buf, off, val, kind):
            kind.from_address(buf.ctypes.data + off).value = val

        put(x, 0x2058, mip.ctypes.data, ctypes.c_uint64)
        put(x, 0x2b40, 8, ctypes.c_int)
        put(x, 0x4230, rdmult, ctypes.c_int)
        put(x, 0x1a0 + 8 * (0x18 + tx + plane * 0x146), iwt.ctypes.data,
            ctypes.c_uint64)
        put(x, 0x1a0 + 8 * (0xb0 + tx + plane * 0x146), wt.ctypes.data,
            ctypes.c_uint64)
        put(cpi, 0x432b8, 10, ctypes.c_int)
        put(cpi, 0x432c4, 1, ctypes.c_int)
        put(cpi, 0x61b88, 1, ctypes.c_int)
        for txs in range(5):
            for pt in range(2):
                c = costs.coeff[(txs, pt)]
                arr = np.concatenate([np.zeros(26)] + [np.ravel(v) for v in (
                    c["base_eob"], c["base"], c["eob_extra"], c["dc_sign"],
                    c["lps"])]).astype(np.int32)
                o = 0xb9f0 + (txs * 2 + pt) * 0xec0
                x[o:o + arr.nbytes] = arr.view(np.uint8)
        for ems in range(7):
            for pt in range(2):
                arr = np.zeros(22, np.int32)
                e = costs.eob[(ems, pt)]
                arr[:len(e)] = e
                o = 0xb9f0 + 10 * 0xec0 + (ems * 2 + pt) * 0x58
                x[o:o + 88] = arr.view(np.uint8)
        ctx, rate = _aligned(2, np.int32), _aligned(1, np.int32)
        ctx[:] = skip_ctx, dc_ctx
        self.optimize(cpi.ctypes.data, x.ctypes.data, plane, 0, tx, 0,
                      ctx.ctypes.data, rate.ctypes.data, av1_encode.SHARPNESS)
        return [int(v) for v in bufs["q"]]


def _enc_lib():
    lib = avif_write.library()
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.av1_enc_fwd_txfm2d.argtypes = [vp, ctypes.c_int, vp]
    lib.av1_enc_quantize_fp.argtypes = [vp, vp, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, vp, vp, ctypes.c_int,
                                        vp, vp]
    lib.av1_enc_quantize_fp.restype = ctypes.c_int
    lib.av1_enc_optimize_txb.argtypes = [vp, vp, vp] + [ctypes.c_int] * 5 \
        + [vp, i32p, vp]
    lib.av1_enc_optimize_txb.restype = ctypes.c_int
    return lib


# --- the conversion ----------------------------------------------------------


@pytest.mark.parametrize("h,w", [(1, 1), (7, 5), (33, 17), (64, 80),
                                 (31, 257), (2, 1000)])
def test_rgb_to_yuv420_is_libyuv_and_libavif(h, w):
    """`rgb_to_yuv420` equals libyuv's RGB24ToJ420 on cv2's BGR bytes (in
    the wheel's libavif) and avifImageRGBToYUV of a BGR avifRGBImage into
    8-bit 4:2:0 full-range BT.601, the route cv2's writer takes."""
    lib = ar.libavif()
    rgb = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    cw, ch = (w + 1) // 2, (h + 1) // 2
    y, u, v = (np.zeros(s, np.uint8) for s in ((h, w), (ch, cw), (ch, cw)))
    f = lib.RGB24ToJ420
    f.argtypes = [vp, ctypes.c_int] + [vp, ctypes.c_int] * 3 + \
        [ctypes.c_int, ctypes.c_int]
    assert f(bgr.ctypes.data, 3 * w, y.ctypes.data, w, u.ctypes.data, cw,
             v.ctypes.data, cw, w, h) == 0
    mine = avif_write.rgb_to_yuv420(rgb)
    for a, b in zip((y, u, v), mine):
        np.testing.assert_array_equal(a, b)
    lib.avifImageRGBToYUV.argtypes = [vp, vp]
    img = lib.avifImageCreate(w, h, 8, ar.YUV420)
    try:
        ar._at(img, ar._IMG_RANGE).value = 1
        for off, val in ((ar._IMG_PRIMARIES, 1), (ar._IMG_TRANSFER, 13),
                         (ar._IMG_MATRIX, 6)):
            ar._at(img, off, ctypes.c_uint16).value = val
        rgbi = ctypes.create_string_buffer(128)
        ra = ctypes.addressof(rgbi)
        lib.avifRGBImageSetDefaults(rgbi, img)
        ar._at(ra, ar._RGB_DEPTH).value = 8
        ar._at(ra, ar._RGB_FORMAT).value = 3  # AVIF_RGB_FORMAT_BGR
        ctypes.c_void_p.from_address(ra + ar._RGB_PIXELS).value = \
            bgr.ctypes.data
        ar._at(ra, ar._RGB_ROW_BYTES).value = 3 * w
        assert lib.avifImageRGBToYUV(img, rgbi) == 0
        for p, want in enumerate(mine):
            base = ctypes.c_void_p.from_address(
                img + ar._IMG_PLANES + 8 * p).value
            stride = ar._at(img, ar._IMG_ROW_BYTES + 4 * p).value
            got = np.frombuffer(ctypes.string_at(base, stride * want.shape[0]),
                                np.uint8).reshape(-1, stride)
            np.testing.assert_array_equal(got[:, :want.shape[1]], want)
    finally:
        lib.avifImageDestroy(img)


# --- the residual path ------------------------------------------------------


def test_quantizer_is_av1_build_quantizer(aom):
    """The fp quantizer, its rounding and the step of every qindex, luma
    and chroma (delta -16), DC and AC, as libaom's av1_build_quantizer
    builds them at the encoder's sharpness."""
    for q in range(256):
        for plane in range(3):
            for dc in (True, False):
                step, quant, rnd = av1_encode.quantizer(
                    q, av1_encode.plane_delta(plane), dc)
                k = 0 if dc else 1
                assert (int(aom.table(4 + plane)[q][k]),
                        int(aom.table(7 + plane)[q][k]),
                        int(aom.dequant(plane, q)[k])) == (quant, rnd, step)


@pytest.mark.parametrize("tx", TXS, ids=TXS.values())
def test_forward_transform_is_libaom(tx, aom):
    """`fwd_txfm2d` (plain) and av1_enc_fwd_txfm2d (C) equal libaom's
    av1_lowbd_fwd_txfm_c with DCT_DCT on seeded residuals of every
    amplitude."""
    class TxfmParam(ctypes.Structure):
        _fields_ = [("tx_type", ctypes.c_uint8), ("tx_size", ctypes.c_uint8),
                    ("lossless", ctypes.c_int), ("bd", ctypes.c_int),
                    ("is_hbd", ctypes.c_int), ("tx_set_type", ctypes.c_int),
                    ("eob", ctypes.c_int)]

    ref = ar.libaom_function("av1_lowbd_fwd_txfm_c", None, vp, vp,
                             ctypes.c_int, ctypes.POINTER(TxfmParam))
    lib = _enc_lib()
    w, h = 1 << av1.TX_WLOG2[tx], 1 << av1.TX_HLOG2[tx]
    rng = np.random.default_rng(tx)
    for amp in (1, 4, 40, 255, 255, 255):
        res = _aligned(w * h, np.int16)
        res[:] = rng.integers(-amp, amp + 1, w * h)
        want = _aligned(w * h, np.int32)
        ref(res.ctypes.data, want.ctypes.data, w,
            ctypes.byref(TxfmParam(0, tx, 0, 8, 0, 0, 0)))
        assert av1_encode.fwd_txfm2d(res.reshape(h, w), tx) == list(want)
        out, res32 = np.zeros(w * h, np.int32), res.astype(np.int32)
        lib.av1_enc_fwd_txfm2d(res32.ctypes.data, tx, out.ctypes.data)
        np.testing.assert_array_equal(out, want)


def test_quantize_fp_is_libaom_facade(aom):
    """`quantize_fp` (plain) and av1_enc_quantize_fp (C) equal libaom's
    av1_quantize_fp_facade with the quantizer matrices of level 8 (its
    quantize_fp_helper_c) on seeded coefficients of each transform, plane
    and many qindexes: levels, dequantized values and eob."""
    fac = ar.libaom_function("av1_quantize_fp_facade", None, vp,
                             ctypes.c_long, vp, vp, vp, vp, vp, vp)
    lib = _enc_lib()
    rng = np.random.default_rng(7)
    for trial in range(160):
        tx = list(TXS)[trial % len(TXS)]
        plane, q = int(rng.integers(0, 3)), int(rng.integers(0, 256))
        n = (1 << av1.TX_WLOG2[tx]) << av1.TX_HLOG2[tx]
        coeff = rng.normal(0, rng.choice([30, 300, 3000]), n).astype(
            np.int32)
        scan = _scan(tx)
        iscan = np.zeros(n, np.int16)
        iscan[scan] = np.arange(n)
        qm, iqm = (np.ascontiguousarray(m, np.uint8)
                   for m in av1_encode.qm_weights(tx, plane))
        log_scale = int(n > 256)
        qc, dq = np.zeros(n, np.int32), np.zeros(n, np.int32)
        eob = np.zeros(4, np.uint16)
        plane_ = aom.plane_struct(plane, q)
        orders = np.array([scan.ctypes.data, iscan.ctypes.data], np.uint64)
        qparam = np.zeros(8, np.uint64)  # QUANT_PARAM
        qparam.view(np.int32)[0] = log_scale
        qparam.view(np.uint8)[4] = tx
        qparam[1], qparam[2] = qm.ctypes.data, iqm.ctypes.data
        fac(coeff.ctypes.data, n, plane_.ctypes.data, qc.ctypes.data,
            dq.ctypes.data, eob.ctypes.data, orders.ctypes.data,
            qparam.ctypes.data)
        mq, mdq, me = av1_encode.quantize_fp(coeff, scan, q, plane, qm, iqm,
                                             log_scale)
        assert (mq, mdq, me) == (list(qc), list(dq), int(eob[0]))
        cq, cdq = np.zeros(n, np.int32), np.zeros(n, np.int32)
        ce = lib.av1_enc_quantize_fp(coeff.ctypes.data, scan.ctypes.data, n,
                                     q, plane, qm.ctypes.data,
                                     iqm.ctypes.data, log_scale,
                                     cq.ctypes.data, cdq.ctypes.data)
        assert (list(cq), list(cdq), ce) == (mq, mdq, me)


# --- the mode estimate -------------------------------------------------------


@pytest.mark.parametrize("n", [8, 16])
def test_hadamard_and_quantize_lp_are_libaom(n, aom):
    """`hadamard_8x8` / `hadamard_16x16` equal aom_hadamard_lp_8x8_c /
    _16x16_c, and `quantize_lp` libaom's av1_quantize_lp_c at the
    encoder's rounding, in the scans av1_block_yrd gives it (the 8x8
    DCT's; default_scan_lp_16x16_transpose), on seeded differences."""
    had = ar.libaom_function(f"aom_hadamard_lp_{n}x{n}_c", None, vp,
                             ctypes.c_long, vp)
    qlp = ar.libaom_function("av1_quantize_lp_c", None, vp, ctypes.c_long,
                             vp, vp, vp, vp, vp, vp, vp, vp)
    mine = av1_encode.hadamard_8x8 if n == 8 else av1_encode.hadamard_16x16
    scan = _scan(1) if n == 8 else np.ascontiguousarray(
        table("scan_lp_16x16"), np.int16)
    rng = np.random.default_rng(n)
    for trial in range(40):
        d = rng.integers(-255, 256, (n, n)).astype(np.int16)
        if trial % 2:
            d //= 16
        coeff = _aligned(n * n, np.int16)
        had(d.ctypes.data, n, coeff.ctypes.data)
        np.testing.assert_array_equal(mine(d), coeff)
        q = int(rng.integers(1, 256))
        steps, rounds, quants = (np.array([
            av1_encode.quantizer(q, 0, dc)[k] for dc in (True, False)],
            np.int16) for k in (0, 2, 1))
        qc, dq = _aligned(n * n, np.int16), _aligned(n * n, np.int16)
        eob = np.zeros(4, np.uint16)
        qlp(coeff.ctypes.data, n * n, rounds.ctypes.data, quants.ctypes.data,
            qc.ctypes.data, dq.ctypes.data, steps.ctypes.data,
            eob.ctypes.data, scan.ctypes.data, scan.ctypes.data)
        got = av1_encode.quantize_lp(coeff.astype(np.int64), scan, q)
        np.testing.assert_array_equal(got[0], qc)
        np.testing.assert_array_equal(got[1], dq)
        assert got[2] == int(eob[0])


def test_cdf_costs_are_av1_cost_tokens_from_cdf(aom):
    """`cdf_costs` equals libaom's av1_cost_tokens_from_cdf on every CDF
    of the frame's first tables the encoder weighs (and on adapted ones:
    after a few hundred symbols)."""
    ref = ar.libaom_function("av1_cost_tokens_from_cdf", None, vp, vp, vp)
    cdf = av1.init_cdfs(av1_encode.BASE_Q)
    rng = np.random.default_rng(3)
    writer = av1_encode.SymbolWriter()
    for _ in range(300):
        writer.symbol(cdf["kf_y"][0][0], int(rng.integers(0, 13)), 13)
        writer.symbol(cdf["coeff_base"][1][0][5], int(rng.integers(0, 4)), 4)
    lists = [(cdf["skip"][0], 2), (cdf["coeff_base"][1][0][5], 4),
             (cdf["eob256"][1][0], 9)]
    lists += [(cdf["kf_y"][a][b], 13) for a in range(5) for b in range(5)]
    lists += [(c, 4) for c in cdf["coeff_br"][2][1]]
    for icdf, nsyms in lists:
        arr = np.array(icdf, np.uint16)
        out = np.zeros(16, np.int32)
        ref(out.ctypes.data, arr.ctypes.data, None)
        assert av1_encode.cdf_costs(icdf, nsyms) == list(out[:nsyms])


# --- the trellis -------------------------------------------------------------


def test_trellis_is_libaom_optimize_txb(aom):
    """`optimize_txb` (plain) and av1_enc_optimize_txb (C) give the levels
    libaom's av1_optimize_txb gives at sharpness 7 on seeded blocks of
    every transform the encoder codes, luma and chroma, over qindexes and
    rdmults around cv2's: quantized by `quantize_fp` from coefficients
    made of photo residuals, scaled and jittered."""
    lib = _enc_lib()
    costs = av1_encode.CoeffCosts(av1.init_cdfs(av1_encode.BASE_Q))
    y = avif_write.rgb_to_yuv420(PHOTO)[0].astype(np.int64)
    rng = np.random.default_rng(11)
    changed = 0
    for trial in range(240):
        tx = list(TXS)[trial % len(TXS)]
        plane = int(rng.integers(0, 3))
        w, h = 1 << av1.TX_WLOG2[tx], 1 << av1.TX_HLOG2[tx]
        r0, c0 = int(rng.integers(0, 480 - h)), int(rng.integers(0, 640 - w))
        res = y[r0:r0 + h, c0:c0 + w] - y[r0:r0 + h, c0 - 1:c0][:, [0] * w] \
            if c0 else y[r0:r0 + h, c0:c0 + w] - 128
        coeff = [int(v * rng.choice([0.5, 1, 2])) + int(rng.integers(-3, 4))
                 for v in av1_encode.fwd_txfm2d(res, tx)]
        q = int(rng.choice([92, 120, 148, 60, 200]))
        rdmult = int(av1_encode.rd_mult(148) * rng.choice([0.3, 1, 1, 3]))
        scan = _scan(tx)
        qm, iqm = av1_encode.qm_weights(tx, plane)
        qc, dq, eob = av1_encode.quantize_fp(coeff, scan, q, plane, qm, iqm,
                                             int(w * h > 256))
        if not eob:
            continue
        skip_ctx, dc_ctx = int(rng.integers(0, 13)), int(rng.integers(0, 3))
        want = aom.optimize_txb(qc, dq, coeff, eob, tx, plane, skip_ctx,
                                dc_ctx, rdmult, q, costs)
        dqv = av1_encode.dequant_steps(q, plane, iqm)
        mq, mdq = list(qc), list(dq)
        av1_encode.optimize_txb(mq, mdq, coeff, eob, tx, plane, dc_ctx,
                                rdmult, costs, dqv, qm)
        assert mq == want
        cq, cdq = np.array(qc, np.int32), np.array(dq, np.int32)
        tcoeff, qm8 = np.array(coeff, np.int32), np.array(qm, np.uint8)
        lib.av1_enc_optimize_txb(
            cq.ctypes.data, cdq.ctypes.data, tcoeff.ctypes.data, eob, tx,
            plane, dc_ctx, rdmult,
            ctypes.cast(ctypes.pointer(_c_costs()), vp),
            (ctypes.c_int32 * len(dqv))(*dqv), qm8.ctypes.data)
        assert list(cq) == want and list(cdq) == mdq
        changed += want != list(qc)
    assert changed > 15  # the trellis lowered levels in many of them


_COSTS = []


def _c_costs():
    """The C library's Costs of the frame's first CDFs, filled by its
    av1_enc_fill_costs."""
    if not _COSTS:
        lib = _enc_lib()
        buf = (ctypes.c_int32 * (1 << 16))()
        lib.av1_enc_fill_costs.argtypes = [vp]
        lib.av1_enc_fill_costs(buf)
        _COSTS.append(buf)
    return _COSTS[0]


# --- the tile writer --------------------------------------------------------


@pytest.mark.parametrize("kind,h,w", [("photo", 70, 90), ("noise", 33, 17),
                                      ("text", 40, 200), ("drawn", 130, 100),
                                      ("ramps", 9, 300)])
def test_recode_of_cv2_decisions_is_cv2s_bytes(kind, h, w):
    """The decisions the port's plain decoder reads from cv2's file
    (partitions, qindexes, modes, transform sizes, levels), written anew
    by the tile writer and wrapped in the headers and container, are
    cv2's file byte for byte."""
    from multiposenet_tpu_torch.tools.jpeg_cut_search import load_reference

    drawings = load_reference(avif_write_search.DRAWINGS)
    rgb = avif_write_search.image(kind, h, w, h * w, drawings)
    data = _cv2(rgb)
    frame = avif.read_image(data).frame
    hdr = frame.header
    tiles = av1_encode.write_tiles(w, h, av1_encode.decisions(frame),
                                   bool(hdr.delta_q_present),
                                   bool(hdr.tx_mode_select))
    assert avif_write.wrap(w, h, tiles, bool(hdr.delta_q_present),
                           bool(hdr.tx_mode_select)) == data


# --- the files ---------------------------------------------------------------


def _drawn_photo() -> np.ndarray:
    from multiposenet_tpu_torch.utils import visualize

    rng = np.random.default_rng(5)
    people = [avif_write_search._person(rng, 480, 640) for _ in range(3)]
    return visualize.draw_predictions(PHOTO, people)


FILES = {
    "photo_480x640": lambda: PHOTO,
    "drawn_photo_480x640": _drawn_photo,
    "text_240x320": lambda: ar.drawing(240, 320, 3),
    "noise_96x128": lambda: np.random.default_rng(1).integers(
        0, 256, (96, 128, 3), dtype=np.uint8),
    "flat_50x70": lambda: np.full((50, 70, 3), (200, 30, 90), np.uint8),
    "side_1x1": lambda: PHOTO[200:201, 300:301],
    "side_7x5": lambda: PHOTO[100:107, 50:55],
    "side_33x17": lambda: PHOTO[10:43, 600:617],
    "fixture_33x17": lambda: PHOTO[300:333, 400:417],
    "side_64x80": lambda: PHOTO[300:364, 100:180],
    "side_64x5120": lambda: np.tile(PHOTO[100:164], (1, 8, 1)),
    # 720p up: the partition's other thresholds; 4K up (the shorter side
    # 2160): the rates refreshed at each superblock row
    "photo_720x1280": lambda: np.tile(PHOTO, (2, 2, 1))[:720, :1280],
    "photo_2160x2160": lambda: np.tile(PHOTO, (5, 4, 1))[:2160, :2160],
}
PLAIN_PIXELS = 64 * 80
# The files of these that tests/make_image_fixtures.py committed (cv2's).
COMMITTED = {"photo_480x640": "avif_photo_480x640.avif",
             "fixture_33x17": "avif_odd_33x17.avif"}


@pytest.mark.parametrize("name", FILES)
def test_encode_is_cv2_imencode(name):
    """`encode` (the C library) returns cv2.imencode(".avif")'s bytes at
    its defaults; `encode_plain` returns them too on the images up to
    64x80, so C equals plain there. The photo's and a 33x17 crop's are
    the committed fixtures cv2 wrote of them; `image_io.encode_image` and
    `write_image` route .avif here; the port's decoder reads the file
    back as cv2 reads it."""
    rgb = np.ascontiguousarray(FILES[name]())
    want = _cv2(rgb)
    assert avif_write.encode(rgb) == want
    if rgb.shape[0] * rgb.shape[1] <= PLAIN_PIXELS:
        assert avif_write.encode_plain(rgb) == want
        assert image_io.encode_image_plain(rgb, ".avif") == want
    if name in COMMITTED:
        assert want == (FIXTURES / COMMITTED[name]).read_bytes()
    assert image_io.encode_image(rgb, ".AVIF") == want
    np.testing.assert_array_equal(
        image_io.decode_image(want),
        cv2.imdecode(np.frombuffer(want, np.uint8),
                     cv2.IMREAD_COLOR)[..., ::-1])


def test_write_image_avif_and_apng(tmp_path):
    """`write_image` writes .avif as cv2.imwrite does, and .apng as the
    PNG cv2 reads back to the same pixels (cv2's APNG encoder writes one
    still image as its PNG encoder does)."""
    rgb = np.ascontiguousarray(PHOTO[:100, :150])
    assert image_io.write_image(tmp_path / "a.avif", rgb)
    assert cv2.imwrite(str(tmp_path / "b.avif"),
                       np.ascontiguousarray(rgb[..., ::-1]))
    assert (tmp_path / "a.avif").read_bytes() == \
        (tmp_path / "b.avif").read_bytes()
    assert image_io.write_image(tmp_path / "a.apng", rgb)
    assert (tmp_path / "a.apng").read_bytes().startswith(
        image_io.PNG_SIGNATURE)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "a.apng"), cv2.IMREAD_COLOR)[..., ::-1],
        rgb)


def test_refuses_other_than_uint8_rgb():
    """Gray, BGRA, 16-bit and empty pixels lie outside the contract: a
    ValueError names them."""
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.uint16), np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError, match="uint8 RGB"):
            avif_write.encode(bad)


def test_search_slice_has_no_difference():
    """A 20-case slice of tools/avif_write_search.py (the wide strips
    first, then seeded kinds and sides; its frames of 720p and up are
    `test_encode_is_cv2_imencode`'s): C, and plain where small, write
    cv2's bytes."""
    result = avif_write_search.search(
        avif_write_search.cases(20, seed=4, large=False))
    assert result["cases"] == 20 and result["plain_cases"] > 5
    assert result["differences"] == []
