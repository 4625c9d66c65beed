/* Host AV1 encoder of the port, in plain C99 with no library: the tiles
 * of the one frame cv2.imencode(".avif", bgr) writes at its defaults
 * (OpenCV 5.0, libavif 1.4.2 over libaom 3.14.1: quality 50, speed 9,
 * all-intra, tune IQ, 8-bit 4:2:0), byte for byte. The contract, the
 * container and the headers are Python (utils/avif_write.py); the plain
 * version of everything here is utils/av1_encode.py, which this file
 * matches byte for byte, stage for stage.
 *
 * It is one translation unit with the decoder (av1.c, included below)
 * and takes from it the CDFs and their adaptation, the tables, the
 * intra predictors (av1_nondir_predict) and the inverse transform
 * (av1_inverse_transform_add) the reconstruction runs through.
 *
 * av1_encode_tiles takes the Y, U and V planes and writes each tile
 * (columns within rows) into out, its size into sizes, and the header's
 * delta q and TX_MODE_SELECT flags into flags. Per superblock: the
 * variance boost's qindex and the variance-based partition; per block
 * (in coding order): libaom's non-RD intra mode pick (DC, V, H or
 * SMOOTH, Hadamard estimates at the block's SSIM-scaled rdmult, rates of
 * the frame's first CDFs, or from 4K up of the tile's CDFs at each
 * superblock row); per
 * transform block: the prediction from the reconstruction, the forward
 * DCT, the fp quantizer with the level-8 quantizer matrices, libaom's
 * trellis at sharpness 7, the inverse transform back into the
 * reconstruction; and the symbols (libaom's od_ec encoder, the tile
 * syntax the decoder reads). Returns 0, 2 when out of memory, 3 when out
 * is too small (sizes[0] is then the bytes it needs). Nothing here keeps
 * state between calls. */
#include <math.h>

#include "av1.c"

enum { ENC_BASE_Q = 148, ENC_CHROMA_DQ = -16, ENC_QM_LEVEL = 8,
       ENC_DQ_RES = 2, ENC_SHARPNESS = 7 };

/* ------------------------------------------------- forward transforms */

/* The forward DCT's steps (utils/av1_encode.py dct_steps): the inverse
 * DCT's butterflies (av1_idct) in reverse order, each {1, a, b, angle,
 * flip} a rotation and {0, a, b, 0, flip} a sum and difference. */
static const int16_t fdct4_steps[4][5] = {
    {0, 1, 2, 0, 0}, {0, 0, 3, 0, 0}, {1, 2, 3, 48, 0}, {1, 0, 1, 32, 1}
};
static const int16_t fdct8_steps[13][5] = {
    {0, 3, 4, 0, 0}, {0, 2, 5, 0, 0}, {0, 1, 6, 0, 0}, {0, 0, 7, 0, 0}, {1, 6,
    5, 32, 1}, {0, 1, 2, 0, 0}, {0, 0, 3, 0, 0}, {0, 6, 7, 0, 1}, {0, 4, 5, 0,
    0}, {1, 2, 3, 48, 0}, {1, 0, 1, 32, 1}, {1, 5, 6, 24, 0}, {1, 4, 7, 56, 0}
};
static const int16_t fdct16_steps[37][5] = {
    {0, 7, 8, 0, 0}, {0, 6, 9, 0, 0}, {0, 5, 10, 0, 0}, {0, 4, 11, 0, 0}, {0,
    3, 12, 0, 0}, {0, 2, 13, 0, 0}, {0, 1, 14, 0, 0}, {0, 0, 15, 0, 0}, {1,
    12, 11, 32, 1}, {1, 13, 10, 32, 1}, {0, 3, 4, 0, 0}, {0, 2, 5, 0, 0}, {0,
    1, 6, 0, 0}, {0, 0, 7, 0, 0}, {0, 13, 14, 0, 1}, {0, 12, 15, 0, 1}, {0, 9,
    10, 0, 0}, {0, 8, 11, 0, 0}, {1, 6, 5, 32, 1}, {0, 1, 2, 0, 0}, {0, 0, 3,
    0, 0}, {1, 13, 10, 112, 1}, {1, 14, 9, 48, 1}, {0, 6, 7, 0, 1}, {0, 4, 5,
    0, 0}, {1, 2, 3, 48, 0}, {1, 0, 1, 32, 1}, {0, 14, 15, 0, 1}, {0, 12, 13,
    0, 0}, {0, 10, 11, 0, 1}, {0, 8, 9, 0, 0}, {1, 5, 6, 24, 0}, {1, 4, 7, 56,
    0}, {1, 11, 12, 12, 0}, {1, 10, 13, 44, 0}, {1, 9, 14, 28, 0}, {1, 8, 15,
    60, 0}
};
static const int16_t fdct32_steps[97][5] = {
    {0, 15, 16, 0, 0}, {0, 14, 17, 0, 0}, {0, 13, 18, 0, 0}, {0, 12, 19, 0,
    0}, {0, 11, 20, 0, 0}, {0, 10, 21, 0, 0}, {0, 9, 22, 0, 0}, {0, 8, 23, 0,
    0}, {0, 7, 24, 0, 0}, {0, 6, 25, 0, 0}, {0, 5, 26, 0, 0}, {0, 4, 27, 0,
    0}, {0, 3, 28, 0, 0}, {0, 2, 29, 0, 0}, {0, 1, 30, 0, 0}, {0, 0, 31, 0,
    0}, {1, 24, 23, 32, 1}, {1, 25, 22, 32, 1}, {1, 26, 21, 32, 1}, {1, 27,
    20, 32, 1}, {0, 7, 8, 0, 0}, {0, 6, 9, 0, 0}, {0, 5, 10, 0, 0}, {0, 4, 11,
    0, 0}, {0, 3, 12, 0, 0}, {0, 2, 13, 0, 0}, {0, 1, 14, 0, 0}, {0, 0, 15, 0,
    0}, {0, 27, 28, 0, 1}, {0, 26, 29, 0, 1}, {0, 25, 30, 0, 1}, {0, 24, 31,
    0, 1}, {0, 19, 20, 0, 0}, {0, 18, 21, 0, 0}, {0, 17, 22, 0, 0}, {0, 16,
    23, 0, 0}, {1, 12, 11, 32, 1}, {1, 13, 10, 32, 1}, {0, 3, 4, 0, 0}, {0, 2,
    5, 0, 0}, {0, 1, 6, 0, 0}, {0, 0, 7, 0, 0}, {1, 26, 21, 112, 1}, {1, 27,
    20, 112, 1}, {1, 28, 19, 48, 1}, {1, 29, 18, 48, 1}, {0, 13, 14, 0, 1},
    {0, 12, 15, 0, 1}, {0, 9, 10, 0, 0}, {0, 8, 11, 0, 0}, {1, 6, 5, 32, 1},
    {0, 1, 2, 0, 0}, {0, 0, 3, 0, 0}, {0, 29, 30, 0, 1}, {0, 28, 31, 0, 1},
    {0, 25, 26, 0, 0}, {0, 24, 27, 0, 0}, {0, 21, 22, 0, 1}, {0, 20, 23, 0,
    1}, {0, 17, 18, 0, 0}, {0, 16, 19, 0, 0}, {1, 13, 10, 112, 1}, {1, 14, 9,
    48, 1}, {0, 6, 7, 0, 1}, {0, 4, 5, 0, 0}, {1, 2, 3, 48, 0}, {1, 0, 1, 32,
    1}, {1, 25, 22, 88, 1}, {1, 26, 21, 24, 1}, {1, 29, 18, 120, 1}, {1, 30,
    17, 56, 1}, {0, 14, 15, 0, 1}, {0, 12, 13, 0, 0}, {0, 10, 11, 0, 1}, {0,
    8, 9, 0, 0}, {1, 5, 6, 24, 0}, {1, 4, 7, 56, 0}, {0, 30, 31, 0, 1}, {0,
    28, 29, 0, 0}, {0, 26, 27, 0, 1}, {0, 24, 25, 0, 0}, {0, 22, 23, 0, 1},
    {0, 20, 21, 0, 0}, {0, 18, 19, 0, 1}, {0, 16, 17, 0, 0}, {1, 11, 12, 12,
    0}, {1, 10, 13, 44, 0}, {1, 9, 14, 28, 0}, {1, 8, 15, 60, 0}, {1, 23, 24,
    6, 0}, {1, 22, 25, 38, 0}, {1, 21, 26, 22, 0}, {1, 20, 27, 54, 0}, {1, 19,
    28, 14, 0}, {1, 18, 29, 46, 0}, {1, 17, 30, 30, 0}, {1, 16, 31, 62, 0}
};

static int enc_cos(int angle, int bit) {
  const int32_t *cospi = av1_cospi[bit - 10];
  const int a = angle & 255;
  if (a <= 64) return cospi[a];
  if (a <= 128) return -cospi[128 - a];
  if (a <= 192) return -cospi[a - 128];
  return cospi[256 - a];
}

/* av1_fdct4 .. av1_fdct32 (2^n points), each rotation rounded at
 * cos_bit bits; out in natural order. */
static void fdct(const int64_t *in, int n, int cos_bit, int64_t *out) {
  const int16_t(*st)[5] = n == 2 ? fdct4_steps : n == 3 ? fdct8_steps
                          : n == 4 ? fdct16_steps : fdct32_steps;
  const int ns = n == 2 ? 4 : n == 3 ? 13 : n == 4 ? 37 : 97;
  const int64_t rnd = (int64_t)1 << (cos_bit - 1);
  int64_t T[32];
  memcpy(T, in, sizeof(int64_t) << n);
  for (int k = 0; k < ns; k++) {
    int a = st[k][1], b = st[k][2];
    const int flip = st[k][4];
    if (st[k][0]) {
      const int64_t c = enc_cos(st[k][3], cos_bit);
      const int64_t s = enc_cos(st[k][3] - 64, cos_bit);
      const int64_t xa = flip ? T[b] : T[a], yb = flip ? T[a] : T[b];
      T[a] = (xa * c + yb * s + rnd) >> cos_bit;
      T[b] = (-xa * s + yb * c + rnd) >> cos_bit;
    } else {
      if (flip) { const int t = a; a = b; b = t; }
      const int64_t x = T[a], y = T[b];
      T[a] = x + y;
      T[b] = x - y;
    }
  }
  for (int j = 0; j < (1 << n); j++) out[j] = T[brev(n, j)];
}

/* av1_fwd_txfm_shift_ls by transform (to TX_32X16), and
 * av1_fwd_cos_bit_col/_row by (log2 width - 2, log2 height - 2). */
static const int8_t fwd_shift[11][3] = {
    {2, 0, 0}, {2, -1, 0}, {2, -2, 0}, {2, -4, 0}, {0, 0, 0}, {2, -1, 0},
    {2, -1, 0}, {2, -2, 0}, {2, -2, 0}, {2, -4, 0}, {2, -4, 0}};
static const int8_t fwd_cos_bit_col[4][4] = {
    {13, 13, 13, 0}, {13, 13, 13, 12}, {13, 13, 13, 12}, {0, 13, 13, 12}};
static const int8_t fwd_cos_bit_row[4][4] = {
    {13, 13, 12, 0}, {13, 13, 13, 12}, {13, 13, 12, 13}, {0, 12, 13, 12}};

static int64_t round_shift(int64_t v, int bit) {
  return bit > 0 ? (v + ((int64_t)1 << (bit - 1))) >> bit
                 : v * ((int64_t)1 << -bit);
}

/* av1_fwd_txfm2d_<W>x<H>_c with DCT_DCT on an H x W residual (row-major,
 * stride w): the coefficients column-major (column * H + row). */
void av1_enc_fwd_txfm2d(const int32_t *res, int tx, int32_t *out) {
  const int lw = tx_wlog2[tx], lh = tx_hlog2[tx], w = 1 << lw, h = 1 << lh;
  const int cb_col = fwd_cos_bit_col[lw - 2][lh - 2];
  const int cb_row = fwd_cos_bit_row[lw - 2][lh - 2];
  int64_t buf[32 * 32], a[32] = {0}, b[32];
  for (int c = 0; c < w; c++) {
    for (int r = 0; r < h; r++)
      a[r] = (int64_t)res[r * w + c] * ((int64_t)1 << fwd_shift[tx][0]);
    fdct(a, lh, cb_col, b);
    for (int r = 0; r < h; r++) buf[r * w + c] = round_shift(b[r], -fwd_shift[tx][1]);
  }
  for (int r = 0; r < h; r++) {
    fdct(buf + r * w, lw, cb_row, b);
    for (int c = 0; c < w; c++) {
      int64_t v = round_shift(b[c], -fwd_shift[tx][2]);
      if (lw != lh) v = round_shift(v * 5793, 12); /* NewSqrt2 */
      out[c * h + r] = (int32_t)v;
    }
  }
}

/* ------------------------------------------------------- quantization */

typedef struct { int step, quant, rnd; } Quant;

static Quant quantizer(int q, int delta, int dc) {
  Quant o;
  const int i = clip3(0, 255, q + delta);
  o.step = dc ? av1_dc_qlookup[i] : av1_ac_qlookup[i];
  o.quant = 65536 / o.step;
  o.rnd = (64 * o.step) >> 7;
  return o;
}

static int plane_delta(int plane) { return plane ? ENC_CHROMA_DQ : 0; }

/* quantize_fp_helper_c with quantizer matrices: levels and dequantized
 * values by position; returns the eob. */
int av1_enc_quantize_fp(const int32_t *coeff, const int16_t *scan, int n,
                        int q, int plane, const uint8_t *qm,
                        const uint8_t *iqm, int log_scale, int32_t *qc,
                        int32_t *dq) {
  const Quant P[2] = {quantizer(q, plane_delta(plane), 1),
                      quantizer(q, plane_delta(plane), 0)};
  const int rnd[2] = {(P[0].rnd + ((1 << log_scale) >> 1)) >> log_scale,
                      (P[1].rnd + ((1 << log_scale) >> 1)) >> log_scale};
  int eob = -1;
  memset(qc, 0, sizeof(int32_t) * (size_t)n);
  memset(dq, 0, sizeof(int32_t) * (size_t)n);
  for (int i = 0; i < n; i++) {
    const int rc = scan[i], c = coeff[rc], k = rc != 0;
    const int64_t a = c < 0 ? -(int64_t)c : c;
    const int wt = qm[rc], iwt = iqm[rc];
    int64_t t32 = 0;
    if (a * wt >= ((int64_t)P[k].step << (5 - (1 + log_scale)))) {
      int64_t aa = a + rnd[k];
      if (aa > 32767) aa = 32767;
      t32 = (aa * wt * P[k].quant) >> (16 - log_scale + 5);
      const int64_t deq = (P[k].step * iwt + 16) >> 5;
      const int64_t adq = (t32 * deq) >> log_scale;
      qc[rc] = (int32_t)(c < 0 ? -t32 : t32);
      dq[rc] = (int32_t)(c < 0 ? -adq : adq);
    }
    if (t32) eob = i;
  }
  return eob + 1;
}

/* -------------------------------------------------------------- costs */

static int cost_symbol(int p15) {
  p15 = clip3(1, 32767, p15);
  const int shift = 15 - ilog_nz((uint32_t)p15);
  const int prob = clip3(1, 255, (int)((((int64_t)p15 << shift) * 256 + 16384) / 32768));
  return av1_prob_cost[prob - 128] + (shift << 9);
}

static void cdf_costs(const uint16_t *icdf, int nsyms, int *out) {
  int prev = 0;
  for (int i = 0; i < nsyms; i++) {
    const int p = (32768 - icdf[i]) - prev;
    prev = 32768 - icdf[i];
    out[i] = cost_symbol(p < 4 ? 4 : p);
  }
}

typedef struct {
  int base_eob[5][2][4][3], base[5][2][42][8];
  int eob_extra[5][2][9][2], dc_sign[2][3][2], lps[5][2][21][26];
  int eob[7][2][11];
  int mode_skip[2], kf_y[5][5][13];
} Costs;

/* av1_fill_coeff_costs and the skip and key-frame mode rates of the
 * frame's first CDFs. */
static void fill_costs(Costs *k, const Cdfs *c) {
  for (int txs = 0; txs < 5; txs++) {
    for (int pt = 0; pt < 2; pt++) {
      for (int ctx = 0; ctx < 42; ctx++) {
        int *b = k->base[txs][pt][ctx];
        cdf_costs(c->coeff_base[txs][pt][ctx], 4, b);
        b[4] = 0;
        b[5] = b[1] + 512 - b[0];
        b[6] = b[2] - b[1];
        b[7] = b[3] - b[2];
      }
      for (int ctx = 0; ctx < 21; ctx++) {
        int br[4], *row = k->lps[txs][pt][ctx], prev = 0, i;
        cdf_costs(c->coeff_br[txs < 3 ? txs : 3][pt][ctx], 4, br);
        for (i = 0; i < 12; i += 3) {
          for (int j = 0; j < 3; j++) row[i + j] = prev + br[j];
          prev += br[3];
        }
        row[12] = prev;
        row[13] = row[0];
        for (i = 1; i < 13; i++) row[13 + i] = row[i] - row[i - 1];
      }
      for (int ctx = 0; ctx < 4; ctx++)
        cdf_costs(c->coeff_base_eob[txs][pt][ctx], 3, k->base_eob[txs][pt][ctx]);
      for (int ctx = 0; ctx < 9; ctx++)
        cdf_costs(c->eob_extra[txs][pt][ctx], 2, k->eob_extra[txs][pt][ctx]);
    }
  }
  for (int pt = 0; pt < 2; pt++) {
    for (int ctx = 0; ctx < 3; ctx++) cdf_costs(c->dc_sign[pt][ctx], 2, k->dc_sign[pt][ctx]);
    cdf_costs(c->eob16[pt][0], 5, k->eob[0][pt]);
    cdf_costs(c->eob32[pt][0], 6, k->eob[1][pt]);
    cdf_costs(c->eob64[pt][0], 7, k->eob[2][pt]);
    cdf_costs(c->eob128[pt][0], 8, k->eob[3][pt]);
    cdf_costs(c->eob256[pt][0], 9, k->eob[4][pt]);
    cdf_costs(c->eob512[pt][0], 10, k->eob[5][pt]);
    cdf_costs(c->eob1024[pt][0], 11, k->eob[6][pt]);
  }
  cdf_costs(c->skip[0], 2, k->mode_skip);
  for (int a = 0; a < 5; a++)
    for (int b = 0; b < 5; b++) cdf_costs(c->kf_y[a][b], 13, k->kf_y[a][b]);
}

/* The rate tables of the frame's first CDFs into out (a Costs), for the
 * tests that hold av1_enc_optimize_txb to the plain version. */
void av1_enc_fill_costs(void *out) {
  Cdfs c;
  init_cdfs(&c, ENC_BASE_Q);
  fill_costs(out, &c);
}

static int64_t rdcost(int64_t rdmult, int64_t rate, int64_t dist) {
  return ((rate * rdmult + 256) >> 9) + dist * 128;
}

/* av1_compute_rd_mult_based_on_qindex of a key frame, tune IQ. */
static int rd_mult(int q) {
  const int dc = av1_dc_qlookup[q];
  const int rdmult = (int)((double)(dc * dc) * (3.3 + 0.0015 * dc));
  const int weight = clip3(0, 72, ((255 - q) * 3) / 4) + 128;
  const int r = (int)((double)(rdmult * weight) / 128.0);
  return r > 1 ? r : 1;
}

static int source_variance(const uint8_t *p, int stride, int bw, int bh) {
  int64_t s = 0, sse = 0;
  for (int i = 0; i < bh; i++)
    for (int j = 0; j < bw; j++) {
      const int v = p[i * stride + j];
      s += v;
      sse += v * v;
    }
  const int shift = ilog_nz((uint32_t)(bw * bh)) - 1;
  const int64_t var = (sse - ((s * s) >> shift)) & 0xFFFFFFFF;
  return (int)((var + ((int64_t)1 << (shift - 1))) >> shift);
}

/* ---------------------------------------------------- the symbol writer */

typedef struct {
  uint64_t low;
  uint32_t rng;
  int cnt, oom;
  uint16_t *pre;
  long n, cap;
} SymW;

static void sw_push(SymW *e, uint64_t v) {
  if (e->n == e->cap) {
    const long cap = e->cap ? 2 * e->cap : 4096;
    uint16_t *p = realloc(e->pre, sizeof(uint16_t) * (size_t)cap);
    if (!p) { e->oom = 1; return; }
    e->pre = p;
    e->cap = cap;
  }
  e->pre[e->n++] = (uint16_t)v;
}

static void sw_normalize(SymW *e, uint64_t low, uint32_t rng) {
  const int d = 16 - ilog_nz(rng);
  int c = e->cnt, s = c + d;
  if (s >= 0) {
    c += 16;
    uint64_t m = ((uint64_t)1 << c) - 1;
    if (s >= 8) {
      sw_push(e, low >> c);
      low &= m;
      c -= 8;
      m >>= 8;
    }
    sw_push(e, low >> c);
    s = c + d - 24;
    low &= m;
  }
  e->low = low << d;
  e->rng = rng << d;
  e->cnt = s;
}

static void sw_cdf(SymW *e, const uint16_t *icdf, int s, int nsyms) {
  const uint32_t fl = s > 0 ? icdf[s - 1] : 32768, fh = icdf[s], r = e->rng;
  const int n = nsyms - 1;
  if (fl < 32768) {
    const uint32_t u = (((r >> 8) * (fl >> 6)) >> 1) + 4 * (uint32_t)(n - (s - 1));
    const uint32_t v = (((r >> 8) * (fh >> 6)) >> 1) + 4 * (uint32_t)(n - s);
    sw_normalize(e, e->low + r - u, u - v);
  } else {
    sw_normalize(e, e->low, r - ((((r >> 8) * (fh >> 6)) >> 1) + 4 * (uint32_t)(n - s)));
  }
}

static void sw_symbol(SymW *e, uint16_t *cdf, int s, int nsyms) {
  sw_cdf(e, cdf, s, nsyms);
  update_cdf(cdf, s, nsyms);
}

static void sw_bool(SymW *e, int val, uint32_t f) {
  const uint32_t r = e->rng, v = (((r >> 8) * (f >> 6)) >> 1) + 4;
  sw_normalize(e, e->low + (val ? r - v : 0), val ? v : r - v);
}

static void sw_bit(SymW *e, int val) { sw_bool(e, val, 16384); }

static void sw_literal(SymW *e, int n, int v) {
  for (int i = n - 1; i >= 0; i--) sw_bit(e, (v >> i) & 1);
}

/* The tile's bytes (od_ec_enc_done, then the carries) into out; their
 * count, or -1 when out of memory. */
static long sw_done(SymW *e, uint8_t *out, long cap) {
  int c = e->cnt;
  const uint64_t m = 0x3FFF;
  uint64_t v = ((e->low + m) & ~m) | (m + 1);
  int s = c + 10;
  if (s > 0) {
    uint64_t n = ((uint64_t)1 << (c + 16)) - 1;
    while (s > 0) {
      sw_push(e, v >> (c + 16));
      v &= n;
      s -= 8;
      c -= 8;
      n >>= 8;
    }
  }
  if (e->oom) return -1;
  if (e->n <= cap) {
    uint32_t carry = 0;
    for (long i = e->n - 1; i >= 0; i--) {
      carry += e->pre[i];
      out[i] = (uint8_t)carry;
      carry >>= 8;
    }
  }
  return e->n;
}

/* ------------------------------------------------------------ blocks */

typedef struct {
  int r, c, bsize, y_mode, tx, q, rdmult, avail_u, avail_l;
} Blk;

typedef struct {
  int q, n;
  Blk b[64];
} Sb;

typedef struct {
  int w, h, mi_rows, mi_cols, sb_cols, sb_rows, W[3], H[3];
  uint8_t *src[3], *rec[3];
  double *factors;
  int frows, fcols, base_rdmult;
  Costs costs;
  Sb *sbs;
  int *col_starts, *row_starts, ncols, nrows;
} Coder;

typedef struct {
  Coder *e;
  int row_start, row_end, col_start, col_end, delta_q, tx_select;
  uint8_t *mi_size, *y_mode, *tx_size; /* mi_rows x mi_cols */
  uint8_t *above[3], left[3][32];
  Cdfs cdf;
  SymW ec;
  int current_q, pending_q;
  Sb *sb;
  int16_t at[16][16];
} TileW;

#define TMI(t, arr, r, c) ((t)->arr[(r) * (t)->e->mi_cols + (c)])

static int tw_inside(const TileW *t, int r, int c) {
  return t->col_start <= c && c < t->col_end && t->row_start <= r && r < t->row_end;
}

/* ---------------------------------------------------- rdmult and qindex */

/* av1_set_mb_ssim_rdmult_scaling: per 16x16 of the mode-info grid. */
static int ssim_factors(Coder *e) {
  const int cols = (e->mi_cols + 3) / 4, rows = (e->mi_rows + 3) / 4;
  e->fcols = cols;
  e->frows = rows;
  e->factors = malloc(sizeof(double) * (size_t)(rows * cols));
  if (!e->factors) return 2;
  double log_sum = 0.0;
  for (int row = 0; row < rows; row++)
    for (int col = 0; col < cols; col++) {
      double var = 0.0, num = 0.0;
      for (int mr = row * 4; mr < e->mi_rows && mr < (row + 1) * 4; mr += 2)
        for (int mc = col * 4; mc < e->mi_cols && mc < (col + 1) * 4; mc += 2) {
          var += source_variance(e->src[0] + mr * 4 * e->W[0] + mc * 4, e->W[0], 8, 8);
          num += 1.0;
        }
      var = var / num;
      var = 67.035434 * (1.0 - exp(-0.0021489 * var)) + 17.492222;
      e->factors[row * cols + col] = var;
      log_sum += log(var);
    }
  const double mean = exp(log_sum / (double)(rows * cols));
  for (int i = 0; i < rows * cols; i++) e->factors[i] = e->factors[i] / mean;
  return 0;
}

/* av1_set_ssim_rdmult */
static int block_rdmult(const Coder *e, int bsize, int mi_row, int mi_col) {
  double product = 1.0, n = 0.0;
  for (int row = mi_row / 4; row < e->frows && row < mi_row / 4 + (bh4_of[bsize] + 3) / 4; row++)
    for (int col = mi_col / 4; col < e->fcols && col < mi_col / 4 + (bw4_of[bsize] + 3) / 4; col++) {
      product *= e->factors[row * e->fcols + col];
      n += 1.0;
    }
  const int r = (int)(e->base_rdmult * pow(product, 1.0 / n) + 0.5);
  return r > 0 ? r : 0;
}

static int cmp_int64(const void *a, const void *b) {
  const int64_t x = *(const int64_t *)a, y = *(const int64_t *)b;
  return (x > y) - (x < y);
}

/* av1_get_variance_boost_block_variance, then av1_get_sbq_variance_boost
 * and the delta q step (utils/av1_encode.py sb_qindex). */
static int sb_qindex(const Coder *e, int y0, int x0) {
  int64_t v[64];
  const uint8_t *p = e->src[0] + y0 * e->W[0] + x0;
  for (int by = 0; by < 8; by++)
    for (int bx = 0; bx < 8; bx++) {
      int64_t s = 0, sse = 0;
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
          const int t = p[(8 * by + i) * e->W[0] + 8 * bx + j];
          s += t;
          sse += t * t;
        }
      v[by * 8 + bx] = (sse - ((s * s) >> 6)) >> 6;
    }
  qsort(v, 64, sizeof(int64_t), cmp_int64);
  int64_t var = (v[31] + 2 * v[39] + v[47] + 2) >> 2;
  if (!var) var = 1;
  const int base = ENC_BASE_Q;
  double ratio = (fmin(6.0, 100 / 100.0 * 3.0) * 0.15) * (10.0 - log2((double)var)) + 1.0;
  ratio = 1.0 > ratio ? 1.0 : (ratio > 8.0 ? 8.0 : ratio);
  const double want = (av1_ac_qlookup[base] / 4.0) / ratio;
  int target = 255;
  for (int qi = 0; qi < 255; qi++)
    if (av1_ac_qlookup[qi] / 4.0 >= want) { target = qi; break; }
  int boost = (int)floor((base + 544.0) * (double)(base - target) / 1279.0 + 0.5);
  if (boost > 80) boost = 80;
  int q = base - boost;
  if (q < 1) q = 1;
  q = clip3(4, 252, q);
  const int step = ((q > base ? q - base : base - q) + 1) & ~3;
  q = base + (q >= base ? step : -step);
  return q > 1 ? q : 1;
}

/* --------------------------------------------------------- partition */

typedef struct { int64_t sse, sum; int log2; } Var;

static Var var_sum(Var a, Var b) {
  Var o = {a.sse + b.sse, a.sum + b.sum, a.log2 + 1};
  return o;
}

static int64_t variance_of(Var v) {
  return (256 * (v.sse - ((v.sum * v.sum) >> v.log2))) >> v.log2;
}

typedef struct { Var none, horz[2], vert[2]; } VNode;

static VNode vnode(const Var *q) {
  VNode n;
  n.horz[0] = var_sum(q[0], q[1]);
  n.horz[1] = var_sum(q[2], q[3]);
  n.vert[0] = var_sum(q[0], q[2]);
  n.vert[1] = var_sum(q[1], q[3]);
  n.none = var_sum(n.vert[0], n.vert[1]);
  return n;
}

enum { FORCE_ALL, FORCE_NONE, FORCE_SPLIT };

typedef struct {
  Sb *sb;
  int mi_r, mi_c, mi_rows, mi_cols, row_end, col_end;
} PartCtx;

static void put_block(PartCtx *p, int r, int c, int bsize) {
  if (r < p->mi_rows && c < p->mi_cols) {
    Blk *b = &p->sb->b[p->sb->n++];
    memset(b, 0, sizeof(*b));
    b->r = r;
    b->c = c;
    b->bsize = bsize;
  }
}

static int try_block(PartCtx *p, const VNode *nd, int size, int yy, int xx,
                     int64_t thr, int force) {
  const int w4 = size / 4, r = p->mi_r + yy * w4, c = p->mi_c + xx * w4;
  int check_w = w4, check_h = w4, vert_w = w4 >> 1, horz_h = w4 >> 1;
  if (p->col_end == p->mi_cols) {
    check_w = (w4 >> 1) + 1;
    vert_w = (w4 >> 2) + 1;
  }
  if (p->row_end == p->mi_rows) {
    check_h = (w4 >> 1) + 1;
    horz_h = (w4 >> 2) + 1;
  }
  const int fits = c + check_w <= p->col_end && r + check_h <= p->row_end;
  if (force == FORCE_NONE && fits) {
    put_block(p, r, c, bsize_of(w4, w4));
    return 1;
  }
  if (force == FORCE_SPLIT) return 0;
  const int64_t v = variance_of(nd->none);
  if (v > thr << 4) return 0;
  if (fits && v < thr) {
    put_block(p, r, c, bsize_of(w4, w4));
    return 1;
  }
  if (r + check_h <= p->row_end && c + vert_w <= p->col_end &&
      variance_of(nd->vert[0]) < thr && variance_of(nd->vert[1]) < thr) {
    put_block(p, r, c, bsize_of(w4 >> 1, w4));
    put_block(p, r, c + w4 / 2, bsize_of(w4 >> 1, w4));
    return 1;
  }
  if (c + check_w <= p->col_end && r + horz_h <= p->row_end &&
      variance_of(nd->horz[0]) < thr && variance_of(nd->horz[1]) < thr) {
    put_block(p, r, c, bsize_of(w4, w4 >> 1));
    put_block(p, r + w4 / 2, c, bsize_of(w4, w4 >> 1));
    return 1;
  }
  return 0;
}

/* av1_choose_var_based_partitioning of a key frame's superblock
 * (utils/av1_encode.py partition). */
static void partition(const Coder *e, Sb *sb, int mi_r, int mi_c, int row_end,
                      int col_end, const int64_t *thr) {
  const int pw = (e->mi_cols - mi_c) * 4, ph = (e->mi_rows - mi_r) * 4;
  int64_t means[16][16];
  for (int i = 0; i < 16; i++)
    for (int j = 0; j < 16; j++) {
      int s = 0;
      const uint8_t *p = e->src[0] + (mi_r * 4 + 4 * i) * e->W[0] + mi_c * 4 + 4 * j;
      for (int a = 0; a < 4; a++)
        for (int b = 0; b < 4; b++) s += p[a * e->W[0] + b];
      means[i][j] = (4 * i < ph && 4 * j < pw) ? ((s + 8) >> 4) - 128 : 0;
    }
  VNode n8[8][8], n16[4][4], n32[2][2];
  for (int y8 = 0; y8 < 8; y8++)
    for (int x8 = 0; x8 < 8; x8++) {
      Var q[4];
      for (int k = 0; k < 4; k++) {
        const int64_t m = means[2 * y8 + (k >> 1)][2 * x8 + (k & 1)];
        q[k].sse = m * m;
        q[k].sum = m;
        q[k].log2 = 0;
      }
      n8[y8][x8] = vnode(q);
    }
  for (int y = 0; y < 4; y++)
    for (int x = 0; x < 4; x++) {
      Var q[4];
      for (int k = 0; k < 4; k++) q[k] = n8[2 * y + (k >> 1)][2 * x + (k & 1)].none;
      n16[y][x] = vnode(q);
    }
  for (int y = 0; y < 2; y++)
    for (int x = 0; x < 2; x++) {
      Var q[4];
      for (int k = 0; k < 4; k++) q[k] = n16[2 * y + (k >> 1)][2 * x + (k & 1)].none;
      n32[y][x] = vnode(q);
    }
  int force16[4][4], force32[2][2];
  for (int y = 0; y < 4; y++)
    for (int x = 0; x < 4; x++) force16[y][x] = FORCE_ALL;
  for (int y = 0; y < 2; y++)
    for (int x = 0; x < 2; x++) force32[y][x] = FORCE_ALL;
  for (int y = 0; y < 4; y++)
    for (int x = 0; x < 4; x++)
      if (variance_of(n16[y][x].none) > thr[3]) {
        int64_t lo = 0, hi = 0;
        for (int k = 0; k < 4; k++) {
          const int64_t v = variance_of(n8[2 * y + (k >> 1)][2 * x + (k & 1)].none);
          if (k == 0 || v < lo) lo = v;
          if (k == 0 || v > hi) hi = v;
        }
        force16[y][x] = hi - lo > thr[3] << 2 ? FORCE_SPLIT : FORCE_NONE;
        force32[y / 2][x / 2] = FORCE_SPLIT;
      }
  for (int y = 0; y < 2; y++)
    for (int x = 0; x < 2; x++)
      if (force32[y][x] == FORCE_ALL && variance_of(n32[y][x].none) > thr[2])
        force32[y][x] = FORCE_SPLIT;
  PartCtx p = {sb, mi_r, mi_c, e->mi_rows, e->mi_cols, row_end, col_end};
  sb->n = 0;
  for (int y = 0; y < 2; y++)
    for (int x = 0; x < 2; x++) {
      if (try_block(&p, &n32[y][x], 32, y, x, thr[2], force32[y][x])) continue;
      for (int k = 0; k < 4; k++) {
        const int y16 = 2 * y + (k >> 1), x16 = 2 * x + (k & 1);
        if (try_block(&p, &n16[y16][x16], 16, y16, x16, thr[3], force16[y16][x16]))
          continue;
        for (int a = 0; a < 2; a++)
          for (int b = 0; b < 2; b++)
            put_block(&p, mi_r + 4 * y16 + 2 * a, mi_c + 4 * x16 + 2 * b, BLOCK_8X8);
      }
    }
}

/* -------------------------------------------------------- prediction */

/* DC, V, H or SMOOTH prediction of a w x h block at (x, y) of a plane,
 * into it, from its edges (utils/av1_encode.py predict). */
static void enc_predict(uint8_t *rec, int stride, int x, int y, int w, int h,
                        int mode, int have_left, int have_above, int max_x,
                        int max_y) {
  int ab[65], lb[65];
  int *above = ab + 1, *left = lb + 1;
  ab[0] = lb[0] = 0;
  for (int i = 0; i < w; i++)
    above[i] = have_above ? rec[(y - 1) * stride + (x + i < max_x ? x + i : max_x)]
               : have_left ? rec[y * stride + x - 1] : 127;
  for (int i = 0; i < h; i++)
    left[i] = have_left ? rec[(y + i < max_y ? y + i : max_y) * stride + x - 1]
              : have_above ? rec[(y - 1) * stride + x] : 129;
  uint8_t *dst = rec + y * stride + x;
  if (mode == V_PRED) {
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) dst[i * stride + j] = (uint8_t)above[j];
  } else if (mode == H_PRED) {
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) dst[i * stride + j] = (uint8_t)left[i];
  } else {
    av1_nondir_predict(dst, stride, w, h, above, left, mode, have_left, have_above);
  }
}

/* ------------------------------------------------------ mode decision */

static void hadamard_col8(const int64_t *x, int xs, int64_t *out, int os) {
  int64_t b[8], c[8];
  b[0] = x[0] + x[xs]; b[1] = x[0] - x[xs];
  b[2] = x[2 * xs] + x[3 * xs]; b[3] = x[2 * xs] - x[3 * xs];
  b[4] = x[4 * xs] + x[5 * xs]; b[5] = x[4 * xs] - x[5 * xs];
  b[6] = x[6 * xs] + x[7 * xs]; b[7] = x[6 * xs] - x[7 * xs];
  c[0] = b[0] + b[2]; c[1] = b[1] + b[3]; c[2] = b[0] - b[2]; c[3] = b[1] - b[3];
  c[4] = b[4] + b[6]; c[5] = b[5] + b[7]; c[6] = b[4] - b[6]; c[7] = b[5] - b[7];
  out[0] = c[0] + c[4]; out[7 * os] = c[1] + c[5];
  out[3 * os] = c[2] + c[6]; out[4 * os] = c[3] + c[7];
  out[2 * os] = c[0] - c[4]; out[6 * os] = c[1] - c[5];
  out[1 * os] = c[2] - c[6]; out[5 * os] = c[3] - c[7];
}

/* aom_hadamard_lp_8x8_c of an 8x8 difference (row stride ds). */
static void hadamard8(const int64_t *d, int ds, int64_t *out) {
  int64_t tmp[64];
  for (int col = 0; col < 8; col++) hadamard_col8(d + col, ds, tmp + col, 8);
  for (int k = 0; k < 8; k++) hadamard_col8(tmp + 8 * k, 1, out + k, 8);
}

/* aom_hadamard_lp_16x16_c */
static void hadamard16(const int64_t *d, int ds, int64_t *out) {
  int64_t q[4][64];
  for (int i = 0; i < 4; i++) hadamard8(d + 8 * (i >> 1) * ds + 8 * (i & 1), ds, q[i]);
  for (int k = 0; k < 64; k++) {
    const int64_t b0 = (q[0][k] + q[1][k]) >> 1, b1 = (q[0][k] - q[1][k]) >> 1;
    const int64_t b2 = (q[2][k] + q[3][k]) >> 1, b3 = (q[2][k] - q[3][k]) >> 1;
    out[k] = b0 + b2;
    out[64 + k] = b1 + b3;
    out[128 + k] = b0 - b2;
    out[192 + k] = b1 - b3;
  }
}

/* av1_block_yrd on an n x n region (n 8 .. 32) of source and prediction
 * in Hadamard transforms of tx_n (8 or 16): rate, dist, skippable. */
static void block_yrd(const uint8_t *src, int ss, const uint8_t *pred, int ps,
                      int n, int tx_n, int q, int64_t *rate_o, int64_t *dist_o,
                      int *skippable_o) {
  const Quant P[2] = {quantizer(q, 0, 1), quantizer(q, 0, 0)};
  /* the eob in the 8x8 DCT's scan, or the 16x16 Hadamard's own */
  const int16_t *scan = tx_n == 8 ? av1_scan_data + av1_scan_offset[TX_8X8][DCT_DCT]
                                  : av1_scan_lp_16x16;
  int64_t rate = 0, dist = 0, eob_cost = 0;
  int skippable = 1;
  int64_t d[32 * 32], coeff[256];
  for (int i = 0; i < n; i++)
    for (int j = 0; j < n; j++) d[i * n + j] = (int64_t)src[i * ss + j] - pred[i * ps + j];
  for (int r = 0; r < n; r += tx_n)
    for (int c = 0; c < n; c += tx_n) {
      if (tx_n == 8) hadamard8(d + r * n + c, n, coeff);
      else hadamard16(d + r * n + c, n, coeff);
      const int nc = tx_n * tx_n;
      int64_t qv[256], dq[256];
      int eob = 0;
      for (int k = 0; k < nc; k++) {
        const Quant *pk = &P[k != 0];
        int64_t a = (coeff[k] < 0 ? -coeff[k] : coeff[k]) + pk->rnd;
        if (a > 32767) a = 32767;
        const int64_t t = (a * pk->quant) >> 16;
        qv[k] = coeff[k] < 0 ? -t : t;
        dq[k] = qv[k] * pk->step;
      }
      for (int k = 0; k < nc; k++)
        if (qv[scan[k]]) eob = k + 1;
      skippable &= eob == 0;
      eob_cost += ilog_nz((uint32_t)(eob + 1)) - 1;
      if (eob == 1) {
        rate += qv[0] < 0 ? -qv[0] : qv[0];
      } else if (eob > 1) {
        for (int k = 0; k < nc; k++) rate += qv[k] < 0 ? -qv[k] : qv[k];
      }
      int64_t e2 = 0;
      for (int k = 0; k < nc; k++) e2 += (coeff[k] - dq[k]) * (coeff[k] - dq[k]);
      dist += e2 >> 2;
    }
  *dist_o = dist;
  *skippable_o = skippable;
  *rate_o = skippable ? 0 : (rate << 11) + (eob_cost << 9);
}

/* av1_estimate_block_intra over a block's luma (utils/av1_encode.py
 * Encoder.estimate); returns 0 where the SAD prune drops the mode. */
static int estimate(Coder *e, const Blk *b, int mode, int64_t *best_sad,
                    int64_t *rate_o, int64_t *dist_o, int *skip_o) {
  const int n = 4 << b->tx, r0 = b->r * 4, c0 = b->c * 4;
  const int bw = 4 * bw4_of[b->bsize], bh = 4 * bh4_of[b->bsize];
  const int st = e->W[0];
  uint8_t *rec = e->rec[0];
  uint8_t saved[32 * 32];
  for (int i = 0; i < bh; i++) memcpy(saved + i * bw, rec + (r0 + i) * st + c0, (size_t)bw);
  int64_t rate = 0, dist = 0;
  int skippable = 1, kept = 1;
  for (int yy = 0; yy < bh && kept; yy += n)
    for (int xx = 0; xx < bw && kept; xx += n) {
      const int x0 = c0 + xx, y0 = r0 + yy;
      if (x0 >= e->mi_cols * 4 || y0 >= e->mi_rows * 4) continue;
      enc_predict(rec, st, x0, y0, n, n, mode, b->avail_l || xx > 0,
                  b->avail_u || yy > 0, e->mi_cols * 4 - 1, e->mi_rows * 4 - 1);
      const uint8_t *src = e->src[0] + y0 * st + x0, *pred = rec + y0 * st + x0;
      if (best_sad) {
        int64_t sad = 0;
        for (int i = 0; i < n; i++)
          for (int j = 0; j < n; j++) {
            const int dd = src[i * st + j] - pred[i * st + j];
            sad += dd < 0 ? -dd : dd;
          }
        if (*best_sad >= 0 && sad > *best_sad + (*best_sad >> 4)) {
          kept = 0;
          break;
        }
        if (*best_sad < 0 || sad < *best_sad) *best_sad = sad;
      }
      int64_t rr, dd;
      block_yrd(src, st, pred, st, n, n < 16 ? n : 16, b->q, &rr, &dd, &skippable);
      rate += rr;
      dist += dd;
    }
  for (int i = 0; i < bh; i++) memcpy(rec + (r0 + i) * st + c0, saved + i * bw, (size_t)bw);
  *rate_o = rate;
  *dist_o = dist;
  *skip_o = skippable;
  return kept;
}

/* av1_nonrd_pick_intra_mode (utils/av1_encode.py Encoder.decide). */
static void decide(Coder *e, TileW *t, Blk *b) {
  static const int modes[4] = {DC_PRED, V_PRED, H_PRED, SMOOTH_PRED};
  b->avail_u = tw_inside(t, b->r - 1, b->c);
  b->avail_l = tw_inside(t, b->r, b->c - 1);
  const int above = b->avail_u ? TMI(t, y_mode, b->r - 1, b->c) : DC_PRED;
  const int left = b->avail_l ? TMI(t, y_mode, b->r, b->c - 1) : DC_PRED;
  const int *mode_costs = e->costs.kf_y[intra_mode_ctx[above]][intra_mode_ctx[left]];
  const int bw = 4 * bw4_of[b->bsize], bh = 4 * bh4_of[b->bsize];
  const int variance = source_variance(e->src[0] + b->r * 4 * e->W[0] + b->c * 4,
                                       e->W[0], bw, bh);
  b->rdmult = block_rdmult(e, b->bsize, b->r, b->c);
  int64_t best_sad = -1, best = -1;
  const int prune_sad = tx_bsize(b->tx) == b->bsize;
  int best_mode = DC_PRED;
  for (int k = 0; k < 4; k++) {
    const int mode = modes[k];
    if (mode != DC_PRED && b->bsize > 8 && !(variance | b->r | b->c)) continue;
    if (mode == H_PRED && best_mode == V_PRED) continue;
    if (mode != DC_PRED && b->avail_u && b->avail_l && mode != above && mode != left) {
      if ((mode == V_PRED || mode == H_PRED) && variance <= 50) continue;
      if (mode == SMOOTH_PRED && best_mode == DC_PRED) continue;
    }
    int64_t rate, dist;
    int skippable;
    if (!estimate(e, b, mode, prune_sad ? &best_sad : NULL, &rate, &dist, &skippable))
      continue;
    rate = skippable ? e->costs.mode_skip[1] : rate + e->costs.mode_skip[0];
    const int64_t cost = rdcost(b->rdmult, rate + mode_costs[mode], dist);
    if (best < 0 || cost < best) {
      best = cost;
      best_mode = mode;
    }
  }
  b->y_mode = best_mode;
}

/* ------------------------------------------------------------ trellis */

static const int golomb_bits_cost[32] = {
    0, 512, 1536, 1536, 2560, 2560, 2560, 2560, 3584, 3584, 3584,
    3584, 3584, 3584, 3584, 3584, 4608, 4608, 4608, 4608, 4608, 4608,
    4608, 4608, 4608, 4608, 4608, 4608, 4608, 4608, 4608, 4608};
static const int golomb_cost_diff[32] = {
    0, 512, 1024, 0, 1024, 0, 0, 0, 1024, 0, 0, 0, 0, 0, 0, 0,
    1024, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

static int golomb_cost(int level) {
  if (level < 15) return 0;
  return (2 * ilog_nz((uint32_t)(level - 14)) - 1) << 9;
}

static int br_cost(int level, const int *lps) {
  return lps[level - 3 < 12 ? level - 3 : 12] + golomb_cost(level);
}

typedef struct {
  int32_t *q, *dq;
  const int32_t *t;
  const int16_t *scan;
  const int8_t *nz_off;
  const int *dqv;
  const uint8_t *qm;
  int bhl, width, stride, shift, dc_sign_ctx, txs, pt;
  int64_t rdmult;
  const Costs *k;
  uint8_t levels[(32 + 4) * (32 + 4) + 64];
} Trellis;

static int tr_at(const Trellis *T, int pos) {
  const int col = pos >> T->bhl;
  return col * T->stride + pos - (col << T->bhl);
}

static int64_t tr_dist(const Trellis *T, int64_t t, int64_t d, int pos) {
  const int64_t diff = (t - d) * ((int64_t)1 << T->shift) * T->qm[pos];
  return (diff * diff + (1 << 9)) >> 10;
}

static int tr_ctx_eob(const Trellis *T, int si) {
  const int area = T->width << T->bhl;
  return si == 0 ? 0 : si <= area / 8 ? 1 : si <= area / 4 ? 2 : 3;
}

static int tr_ctx(const Trellis *T, int pos) {
  if (pos == 0) return 0;
  const uint8_t *lv = T->levels + tr_at(T, pos);
  const int s = T->stride;
  const int o[5] = {s, 1, s + 1, 2 * s, 2};
  int mag = 0;
  for (int k = 0; k < 5; k++) mag += lv[o[k]] < 3 ? lv[o[k]] : 3;
  const int m = (mag + 1) >> 1;
  return (m < 4 ? m : 4) + T->nz_off[pos];
}

static int tr_br_ctx_eob(const Trellis *T, int pos) {
  const int col = pos >> T->bhl, row = pos - (col << T->bhl);
  if (pos == 0) return 0;
  return row < 2 && col < 2 ? 7 : 14;
}

static int tr_br_ctx(const Trellis *T, int pos) {
  const int col = pos >> T->bhl, row = pos - (col << T->bhl);
  const uint8_t *lv = T->levels + tr_at(T, pos);
  const int s = T->stride;
  int mag = (lv[1] + lv[s] + lv[s + 1] + 1) >> 1;
  if (mag > 6) mag = 6;
  if (pos == 0) return mag;
  return row < 2 && col < 2 ? mag + 7 : mag + 14;
}

static int tr_cost_eob(const Trellis *T, int pos, int level, int sign, int ctx) {
  int cost = T->k->base_eob[T->txs][T->pt][ctx][(level < 3 ? level : 3) - 1];
  cost += pos == 0 ? T->k->dc_sign[T->pt][T->dc_sign_ctx][sign] : 512;
  if (level > 2) cost += br_cost(level, T->k->lps[T->txs][T->pt][tr_br_ctx_eob(T, pos)]);
  return cost;
}

static int tr_cost_general(const Trellis *T, int last, int pos, int level,
                           int sign, int ctx) {
  int cost = last ? T->k->base_eob[T->txs][T->pt][ctx][(level < 3 ? level : 3) - 1]
                  : T->k->base[T->txs][T->pt][ctx][level < 3 ? level : 3];
  if (level) {
    cost += pos == 0 ? T->k->dc_sign[T->pt][T->dc_sign_ctx][sign] : 512;
    if (level > 2) {
      const int br = last ? tr_br_ctx_eob(T, pos) : tr_br_ctx(T, pos);
      cost += br_cost(level, T->k->lps[T->txs][T->pt][br]);
    }
  }
  return cost;
}

static void tr_set(Trellis *T, int pos, int q, int dq) {
  T->q[pos] = q;
  T->dq[pos] = dq;
  const int a = q < 0 ? -q : q;
  T->levels[tr_at(T, pos)] = (uint8_t)(a < 127 ? a : 127);
}

static void tr_lower(const Trellis *T, int pos, int level, int sign, int *q, int *dq) {
  const int low = level - 1;
  const int d = (int)(((int64_t)low * T->dqv[pos]) >> T->shift);
  *q = sign ? -low : low;
  *dq = sign ? -d : d;
}

static int eob_cost(const Trellis *T, int eob, const int *ecost) {
  int pt = 1;
  for (int k = 1; k < 12; k++)
    if (av1_eob_group_start[k] <= eob) pt = k;
  const int extra = eob - av1_eob_group_start[pt];
  int cost = ecost[pt - 1];
  const int bits = av1_eob_offset_bits[pt];
  if (bits > 0) {
    cost += T->k->eob_extra[T->txs][T->pt][pt - 3][(extra >> (bits - 1)) & 1];
    if (bits > 1) cost += (bits - 1) << 9;
  }
  return cost;
}

static void update_general(Trellis *T, int64_t *rate_a, int64_t *dist_a, int si, int eob) {
  const int pos = T->scan[si], qc = T->q[pos], last = si == eob - 1;
  const int ctx = last ? tr_ctx_eob(T, si) : tr_ctx(T, pos);
  if (qc == 0) {
    *rate_a += T->k->base[T->txs][T->pt][ctx][0];
    return;
  }
  const int sign = qc < 0, level = sign ? -qc : qc;
  const int64_t t = T->t[pos];
  const int64_t dist = tr_dist(T, t, T->dq[pos], pos), dist0 = tr_dist(T, t, 0, pos);
  const int rate = tr_cost_general(T, last, pos, level, sign, ctx);
  const int64_t rd = rdcost(T->rdmult, rate, dist);
  int q_low = 0, dq_low = 0, rate_low;
  int64_t dist_low;
  if (level == 1) {
    dist_low = dist0;
    rate_low = T->k->base[T->txs][T->pt][ctx][0];
  } else {
    tr_lower(T, pos, level, sign, &q_low, &dq_low);
    dist_low = tr_dist(T, t, dq_low, pos);
    rate_low = tr_cost_general(T, last, pos, level - 1, sign, ctx);
  }
  if (rdcost(T->rdmult, rate_low, dist_low) < rd) {
    tr_set(T, pos, q_low, dq_low);
    *rate_a += rate_low;
    *dist_a += dist_low - dist0;
  } else {
    *rate_a += rate;
    *dist_a += dist - dist0;
  }
}

static void update_eob(Trellis *T, int64_t *rate_a, int64_t *dist_a, int *eob,
                       int *nz, int *nz_num, int si, const int *ecost) {
  const int pos = T->scan[si], qc = T->q[pos];
  const int ctx = tr_ctx(T, pos);
  if (qc == 0) {
    *rate_a += T->k->base[T->txs][T->pt][ctx][0];
    return;
  }
  int lower = 0;
  const int sign = qc < 0, level = sign ? -qc : qc;
  const int64_t t = T->t[pos];
  const int64_t dist0 = tr_dist(T, t, 0, pos);
  int64_t dist = tr_dist(T, t, T->dq[pos], pos) - dist0;
  int64_t rate = tr_cost_general(T, 0, pos, level, sign, ctx);
  int64_t rd = rdcost(T->rdmult, *rate_a + rate, *dist_a + dist);
  int q_low = 0, dq_low = 0;
  int64_t dist_low, rate_low, rd_low;
  if (level == 1) {
    dist_low = 0;
    rate_low = T->k->base[T->txs][T->pt][ctx][0];
    rd_low = rdcost(T->rdmult, *rate_a + rate_low, *dist_a);
  } else {
    tr_lower(T, pos, level, sign, &q_low, &dq_low);
    dist_low = tr_dist(T, t, dq_low, pos) - dist0;
    rate_low = tr_cost_general(T, 0, pos, level - 1, sign, ctx);
    rd_low = rdcost(T->rdmult, *rate_a + rate_low, *dist_a + dist_low);
  }
  int lower_new_eob = 0;
  const int new_eob = si + 1, ctx_new = tr_ctx_eob(T, si);
  const int new_eob_cost = eob_cost(T, new_eob, ecost);
  int64_t rate_eob = new_eob_cost + tr_cost_eob(T, pos, level, sign, ctx_new);
  int64_t dist_eob = dist;
  int64_t rd_eob = rdcost(T->rdmult, rate_eob, dist_eob);
  if (level - 1 > 0) {
    const int64_t rate_eob_low = new_eob_cost + tr_cost_eob(T, pos, level - 1, sign, ctx_new);
    const int64_t rd_eob_low = rdcost(T->rdmult, rate_eob_low, dist_low);
    if (rd_eob_low < rd_eob) {
      lower_new_eob = 1;
      rd_eob = rd_eob_low;
      rate_eob = rate_eob_low;
      dist_eob = dist_low;
    }
  }
  if ((level > 2 || (level == 2 && si > 5)) && rd_low < rd) {
    lower = 1;
    rd = rd_low;
    rate = rate_low;
    dist = dist_low;
  }
  if (new_eob > 4 && rd_eob < rd) {
    for (int i = 0; i < *nz_num; i++) tr_set(T, nz[i], 0, 0);
    *eob = new_eob;
    *nz_num = 0;
    *rate_a = rate_eob;
    *dist_a = dist_eob;
    lower = lower_new_eob;
  } else {
    *rate_a += rate;
    *dist_a += dist;
  }
  if (lower) tr_set(T, pos, q_low, dq_low);
  if (T->q[pos]) nz[(*nz_num)++] = pos;
}

static void update_simple(Trellis *T, int si) {
  const int pos = T->scan[si], qc = T->q[pos];
  if (qc == 0) return;
  const int level = qc < 0 ? -qc : qc;
  const int64_t t = T->t[pos] < 0 ? -(int64_t)T->t[pos] : T->t[pos];
  const int64_t dq = T->dq[pos] < 0 ? -(int64_t)T->dq[pos] : T->dq[pos];
  if (dq < t || level == 1) return;
  const int ctx = tr_ctx(T, pos);
  const int *base = T->k->base[T->txs][T->pt][ctx];
  int cost = base[level < 3 ? level : 3] + 512;
  int diff = level <= 3 ? base[level + 4] : 0;
  if (level > 2) {
    const int *lps = T->k->lps[T->txs][T->pt][tr_br_ctx(T, pos)];
    const int r = level - 3 < 12 ? level - 3 : 12;
    if (level <= 15) diff += lps[r + 13];
    int golomb = 0;
    if (level >= 15) {
      const int g = level - 14;
      golomb = g < 32 ? golomb_bits_cost[g] : golomb_cost(level);
      diff += g < 32 ? golomb_cost_diff[g] : ((g & (g - 1)) == 0 ? 1024 : 0);
    }
    cost += lps[r] + golomb;
  }
  const int rate = cost, rate_low = cost - diff;
  const int64_t dist = tr_dist(T, t, dq, pos);
  const int low = level - 1;
  const int64_t dq_low = ((int64_t)low * T->dqv[pos]) >> T->shift;
  const int64_t dist_low = tr_dist(T, t, dq_low, pos);
  if (rdcost(T->rdmult, rate_low, dist_low) < rdcost(T->rdmult, rate, dist))
    tr_set(T, pos, qc < 0 ? -low : low, (int)(qc < 0 ? -dq_low : dq_low));
}

/* av1_optimize_txb at sharpness 7 (utils/av1_encode.py optimize_txb):
 * levels and dequantized values by position, changed in place; returns
 * the new eob. */
int av1_enc_optimize_txb(int32_t *qc, int32_t *dq, const int32_t *tcoeff,
                         int eob, int tx, int plane, int dc_sign_ctx,
                         int rdmult, const void *costs, const int *dqv,
                         const uint8_t *qm) {
  Trellis T;
  const int lw = tx_wlog2[tx], lh = tx_hlog2[tx];
  T.width = lw > 5 ? 32 : 1 << lw;
  T.bhl = lh > 5 ? 5 : lh;
  T.stride = (1 << T.bhl) + 4;
  T.scan = av1_scan_data + av1_scan_offset[tx][DCT_DCT];
  T.nz_off = av1_nz_map_ctx_data + av1_nz_map_ctx_start[tx];
  T.txs = (tx_sqr[tx] + tx_sqr_up[tx] + 1) >> 1;
  T.pt = plane > 0;
  T.k = costs;
  const int area = T.width << T.bhl;
  T.shift = (area > 256) + (area > 1024);
  static const int plane_rd_mult[2] = {17, 13};
  T.rdmult = ((int64_t)rdmult * (8 - ENC_SHARPNESS) * plane_rd_mult[T.pt] + 64) >> 7;
  T.q = qc;
  T.dq = dq;
  T.t = tcoeff;
  T.dqv = dqv;
  T.qm = qm;
  T.dc_sign_ctx = dc_sign_ctx;
  memset(T.levels, 0, sizeof(T.levels));
  for (int pos = 0; pos < area; pos++)
    if (qc[pos]) {
      const int a = qc[pos] < 0 ? -qc[pos] : qc[pos];
      T.levels[tr_at(&T, pos)] = (uint8_t)(a < 127 ? a : 127);
    }
  static const int lw4[19] = {0, 2, 4, 6, 6, 1, 1, 3, 3, 5, 5, 6, 6, 2, 2, 4, 4, 5, 5};
  const int *ecost = T.k->eob[lw4[tx]][T.pt];
  int64_t rate_a = eob_cost(&T, eob, ecost), dist_a = 0;
  int si = eob - 1;
  const int pos = T.scan[si];
  const int level = qc[pos] < 0 ? -qc[pos] : qc[pos];
  int nz[3] = {pos, 0, 0}, nz_num = 1;
  if (level >= 2) {
    update_general(&T, &rate_a, &dist_a, si, eob);
  } else {
    rate_a += tr_cost_eob(&T, pos, level, qc[pos] < 0, tr_ctx_eob(&T, si));
    dist_a += tr_dist(&T, tcoeff[pos], dq[pos], pos) - tr_dist(&T, tcoeff[pos], 0, pos);
  }
  si--;
  for (; si >= 0 && nz_num <= 2; si--)
    update_eob(&T, &rate_a, &dist_a, &eob, nz, &nz_num, si, ecost);
  for (; si >= 1; si--) update_simple(&T, si);
  if (si == 0) {
    int64_t r0 = 0, d0 = 0;
    update_general(&T, &r0, &d0, 0, eob);
  }
  return eob;
}

/* ---------------------------------------------------- transform blocks */

/* One transform block: predicted from the reconstruction, transformed,
 * quantized and trellised, added back; its levels by position into qc,
 * its eob returned (utils/av1_encode.py Encoder.levels). */
static int encode_txb(Coder *e, const Blk *b, int plane, int x4, int y4,
                      int x, int y, int tx, int dc_sign_ctx, int32_t *qc) {
  const int w = 1 << tx_wlog2[tx], h = 1 << tx_hlog2[tx], s = plane > 0;
  const int px = 4 * x4, py = 4 * y4, st = e->W[plane];
  uint8_t *rec = e->rec[plane];
  enc_predict(rec, st, px, py, w, h, plane ? DC_PRED : b->y_mode,
              b->avail_l || x > 0, b->avail_u || y > 0,
              ((e->mi_cols * 4) >> s) - 1, ((e->mi_rows * 4) >> s) - 1);
  int32_t res[32 * 32], coeff[32 * 32], dq[32 * 32];
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++)
      res[i * w + j] = e->src[plane][(py + i) * st + px + j] - rec[(py + i) * st + px + j];
  av1_enc_fwd_txfm2d(res, tx, coeff);
  const int16_t *scan = av1_scan_data + av1_scan_offset[tx][DCT_DCT];
  const uint8_t *qm = av1_wt_matrix[ENC_QM_LEVEL][s] + qm_offset[tx];
  const uint8_t *iqm = av1_iwt_matrix[ENC_QM_LEVEL][s] + qm_offset[tx];
  int eob = av1_enc_quantize_fp(coeff, scan, w * h, b->q, plane, qm, iqm,
                                w * h > 256, qc, dq);
  if (eob) {
    int dqv[32 * 32];
    const Quant dc = quantizer(b->q, plane_delta(plane), 1);
    const Quant ac = quantizer(b->q, plane_delta(plane), 0);
    for (int i = 0; i < w * h; i++) dqv[i] = ((i ? ac.step : dc.step) * iqm[i] + 16) >> 5;
    eob = av1_enc_optimize_txb(qc, dq, coeff, eob, tx, plane, dc_sign_ctx,
                               b->rdmult, &e->costs, dqv, qm);
  }
  if (eob) av1_inverse_transform_add(dq, tx, DCT_DCT, rec + py * st + px, st);
  return eob;
}

/* ------------------------------------------------------ the tile syntax */

static void tw_delta(TileW *t, int d) {
  const int a = d < 0 ? -d : d;
  sw_symbol(&t->ec, t->cdf.delta_q, a < 3 ? a : 3, 4);
  if (a >= 3) {
    const int n = ilog_nz((uint32_t)(a - 1)) - 1;
    sw_literal(&t->ec, 3, n - 1);
    sw_literal(&t->ec, n, a - (1 << n) - 1);
  }
  if (a) sw_bit(&t->ec, d < 0);
}

static void tw_tx_size(TileW *t, const Blk *b) {
  const int max_rect = av1_max_txsize_rect_lookup[b->bsize];
  if (!t->tx_select || b->bsize == 0) return;
  const int r = b->r, c = b->c;
  const int aw = tw_inside(t, r - 1, c) ? 1 << tx_wlog2[TMI(t, tx_size, r - 1, c)] : 0;
  const int lh = tw_inside(t, r, c - 1) ? 1 << tx_hlog2[TMI(t, tx_size, r, c - 1)] : 0;
  const int ctx = (aw >= 1 << tx_wlog2[max_rect]) + (lh >= 1 << tx_hlog2[max_rect]);
  const int depth_max = max_tx_depth[b->bsize];
  int depth = 0, tx = max_rect;
  while (tx != b->tx) {
    tx = split_tx[tx];
    depth++;
  }
  sw_symbol(&t->ec, t->cdf.tx_size[depth_max - 1][ctx], depth, depth_max > 1 ? 3 : 2);
}

/* One transform block's contexts, levels (encode_txb) and symbols: the
 * mirror of the decoder's read_coeffs for a DCT_DCT block. */
static void tw_coeffs(TileW *t, const Blk *b, int plane, int x4, int y4,
                      int x, int y, int tx) {
  Coder *e = t->e;
  Cdfs *cdf = &t->cdf;
  SymW *ec = &t->ec;
  const int ptype = plane > 0, s = plane > 0;
  const int lw = tx_wlog2[tx], lh = tx_hlog2[tx];
  const int w4 = 1 << (lw - 2), h4 = 1 << (lh - 2);
  const int cw = lw > 5 ? 32 : 1 << lw;
  const int bhl = lh > 5 ? 5 : lh;
  const int txs_ctx = (tx_sqr[tx] + tx_sqr_up[tx] + 1) >> 1;
  const int max_x4 = ((e->mi_cols * 4) >> s) >> 2, max_y4 = ((e->mi_rows * 4) >> s) >> 2;
  uint8_t *a = t->above[plane] + x4;
  uint8_t *l = t->left[plane] + (y4 & ((16 >> s) - 1));
  int dc_sign = 0, top = 0, left = 0, ctx;
  for (int k = 0; k < w4; k++) {
    dc_sign += (a[k] >> 6) == 1 ? -1 : (a[k] >> 6) == 2 ? 1 : 0;
    top |= a[k];
  }
  for (int k = 0; k < h4; k++) {
    dc_sign += (l[k] >> 6) == 1 ? -1 : (l[k] >> 6) == 2 ? 1 : 0;
    left |= l[k];
  }
  const int dc_sign_ctx = dc_sign < 0 ? 1 : dc_sign > 0 ? 2 : 0;
  const int pbs = plane ? plane_bsize(b->bsize, 1, 1) : b->bsize;
  if (plane == 0) {
    static const uint8_t skip_contexts[5][5] = {{1, 2, 2, 2, 3}, {2, 4, 4, 4, 5},
                                                {2, 4, 4, 4, 5}, {2, 4, 4, 4, 5},
                                                {3, 5, 5, 5, 6}};
    const int tp = (top & 63) < 4 ? top & 63 : 4, lf = (left & 63) < 4 ? left & 63 : 4;
    ctx = pbs == tx_bsize(tx) ? 0 : skip_contexts[tp][lf];
  } else {
    ctx = (top != 0) + (left != 0);
    ctx += 16 * bw4_of[pbs] * bh4_of[pbs] > (1 << (lw + lh)) ? 10 : 7;
  }
  int32_t q[32 * 32];
  const int eob = encode_txb(e, b, plane, x4, y4, x, y, tx, dc_sign_ctx, q);
  sw_symbol(ec, cdf->txb_skip[txs_ctx][ctx], eob == 0, 2);
  int cul = 0;
  if (eob) {
    if (plane == 0) {
      const int set = tx_set_type(tx, 0);
      if (set > 0) {
        const int eset = set == 3 ? 1 : 2;
        int sym = 0;
        while (av1_ext_tx_inv[set][sym] != DCT_DCT) sym++;
        sw_symbol(ec, cdf->intra_ext_tx[eset][tx_sqr[tx]][b->y_mode], sym, num_ext_tx_set[set]);
      }
    }
    const int16_t *scan = av1_scan_data + av1_scan_offset[tx][DCT_DCT];
    const int8_t *nz_off = av1_nz_map_ctx_data + av1_nz_map_ctx_start[tx];
    static const int lw4[19] = {0, 2, 4, 6, 6, 1, 1, 3, 3, 5, 5, 6, 6, 2, 2, 4, 4, 5, 5};
    int eob_pt = 1;
    for (int k = 1; k < 12; k++)
      if (av1_eob_group_start[k] <= eob) eob_pt = k;
    switch (lw4[tx]) {
      case 0: sw_symbol(ec, cdf->eob16[ptype][0], eob_pt - 1, 5); break;
      case 1: sw_symbol(ec, cdf->eob32[ptype][0], eob_pt - 1, 6); break;
      case 2: sw_symbol(ec, cdf->eob64[ptype][0], eob_pt - 1, 7); break;
      case 3: sw_symbol(ec, cdf->eob128[ptype][0], eob_pt - 1, 8); break;
      case 4: sw_symbol(ec, cdf->eob256[ptype][0], eob_pt - 1, 9); break;
      case 5: sw_symbol(ec, cdf->eob512[ptype][0], eob_pt - 1, 10); break;
      default: sw_symbol(ec, cdf->eob1024[ptype][0], eob_pt - 1, 11); break;
    }
    const int bits = av1_eob_offset_bits[eob_pt];
    const int extra = eob - av1_eob_group_start[eob_pt];
    if (bits > 0) {
      sw_symbol(ec, cdf->eob_extra[txs_ctx][ptype][eob_pt - 3], (extra >> (bits - 1)) & 1, 2);
      for (int k = 1; k < bits; k++) sw_bit(ec, (extra >> (bits - 1 - k)) & 1);
    }
    const int stride = (1 << bhl) + 4;
    uint8_t levels[(32 + 4) * (32 + 4) + 64];
    memset(levels, 0, sizeof(levels));
    for (int ci = eob - 1; ci >= 0; ci--) {
      const int pos = scan[ci], col = pos >> bhl, row = pos - (col << bhl);
      uint8_t *lv = levels + col * stride + row;
      const int level = q[pos] < 0 ? -q[pos] : q[pos];
      if (ci == eob - 1) {
        const int area = cw << bhl;
        const int cctx = ci == 0 ? 0 : ci <= area / 8 ? 1 : ci <= area / 4 ? 2 : 3;
        sw_symbol(ec, cdf->coeff_base_eob[txs_ctx][ptype][cctx], (level < 3 ? level : 3) - 1, 3);
      } else {
        const int o[5] = {stride, 1, stride + 1, 2 * stride, 2};
        int mag = 0;
        for (int k = 0; k < 5; k++) mag += lv[o[k]] < 3 ? lv[o[k]] : 3;
        int m = (mag + 1) >> 1;
        if (m > 4) m = 4;
        const int cctx = pos == 0 ? 0 : m + nz_off[pos];
        sw_symbol(ec, cdf->coeff_base[txs_ctx][ptype][cctx], level < 3 ? level : 3, 4);
      }
      if (level > 2) {
        int mag = (lv[1] + lv[stride] + lv[stride + 1] + 1) >> 1;
        if (mag > 6) mag = 6;
        if (ci == eob - 1) mag = 0;
        const int bctx = pos == 0 ? mag : row < 2 && col < 2 ? mag + 7 : mag + 14;
        uint16_t *bcdf = cdf->coeff_br[txs_ctx < 3 ? txs_ctx : 3][ptype][bctx];
        int rest = level - 3;
        for (int k = 0; k < 4; k++) {
          const int v = rest < 3 ? rest : 3;
          sw_symbol(ec, bcdf, v, 4);
          rest -= v;
          if (v < 3) break;
        }
      }
      *lv = (uint8_t)(level < 15 ? level : 15);
    }
    for (int ci = 0; ci < eob; ci++) {
      const int pos = scan[ci];
      const int level = q[pos] < 0 ? -q[pos] : q[pos];
      if (!level) continue;
      if (ci == 0) sw_symbol(ec, cdf->dc_sign[ptype][dc_sign_ctx], q[pos] < 0, 2);
      else sw_bit(ec, q[pos] < 0);
      if (level >= 15) {
        const int xg = level - 14, n = ilog_nz((uint32_t)xg);
        for (int k = 0; k < n - 1; k++) sw_bit(ec, 0);
        sw_bit(ec, 1);
        for (int k = n - 2; k >= 0; k--) sw_bit(ec, (xg >> k) & 1);
      }
      cul += level;
    }
    if (cul > 63) cul = 63;
    if (q[0] < 0) cul |= 1 << 6;
    else if (q[0] > 0) cul += 2 << 6;
  }
  for (int k = 0; k < w4; k++) a[k] = (uint8_t)(x4 + k < max_x4 ? cul : 0);
  for (int k = 0; k < h4; k++) l[k] = (uint8_t)(y4 + k < max_y4 ? cul : 0);
}

static void tw_block(TileW *t, Blk *b) {
  Coder *e = t->e;
  Cdfs *cdf = &t->cdf;
  const int r = b->r, c = b->c, bsize = b->bsize;
  decide(e, t, b);
  sw_symbol(&t->ec, cdf->skip[0], 0, 2);
  if (t->pending_q >= 0) {
    const int d = (t->pending_q - t->current_q) >> ENC_DQ_RES;
    tw_delta(t, d);
    t->current_q += d * (1 << ENC_DQ_RES);
    t->pending_q = -1;
  }
  const int above = b->avail_u ? TMI(t, y_mode, r - 1, c) : DC_PRED;
  const int left = b->avail_l ? TMI(t, y_mode, r, c - 1) : DC_PRED;
  sw_symbol(&t->ec, cdf->kf_y[intra_mode_ctx[above]][intra_mode_ctx[left]], b->y_mode, 13);
  if (b->y_mode >= V_PRED && b->y_mode <= D67_PRED && bsize >= BLOCK_8X8)
    sw_symbol(&t->ec, cdf->angle_delta[b->y_mode - V_PRED], 3, 7);
  const int bw = 4 * bw4_of[bsize], bh = 4 * bh4_of[bsize];
  const int cfl_allowed = (bw > bh ? bw : bh) <= 32;
  sw_symbol(&t->ec, cdf->uv[cfl_allowed][b->y_mode], DC_PRED, 13 + cfl_allowed);
  if (b->y_mode == DC_PRED && (bw > bh ? bw : bh) <= 32)
    sw_symbol(&t->ec, cdf->filter_intra[bsize], 0, 2);
  tw_tx_size(t, b);
  const int r1 = r + bh4_of[bsize] < e->mi_rows ? r + bh4_of[bsize] : e->mi_rows;
  const int c1 = c + bw4_of[bsize] < e->mi_cols ? c + bw4_of[bsize] : e->mi_cols;
  for (int i = r; i < r1; i++)
    for (int j = c; j < c1; j++) {
      TMI(t, y_mode, i, j) = (uint8_t)b->y_mode;
      TMI(t, tx_size, i, j) = (uint8_t)b->tx;
      TMI(t, mi_size, i, j) = (uint8_t)bsize;
    }
  for (int plane = 0; plane < 3; plane++) {
    const int s = plane > 0;
    const int tx = plane ? uv_tx_size(bsize, 1, 1) : b->tx;
    const int step_x = 1 << (tx_wlog2[tx] - 2), step_y = 1 << (tx_hlog2[tx] - 2);
    const int pbs = plane ? plane_bsize(bsize, 1, 1) : bsize;
    for (int y = 0; y < bh4_of[pbs]; y += step_y)
      for (int x = 0; x < bw4_of[pbs]; x += step_x) {
        const int x4 = (c >> s) + x, y4 = (r >> s) + y;
        if (4 * x4 < (e->mi_cols * 4) >> s && 4 * y4 < (e->mi_rows * 4) >> s)
          tw_coeffs(t, b, plane, x4, y4, x, y, tx);
      }
  }
}

static void tw_partition(TileW *t, int r, int c, int bsize) {
  Coder *e = t->e;
  if (r >= e->mi_rows || c >= e->mi_cols) return;
  const int num4 = bw4_of[bsize], half = num4 >> 1;
  const int has_rows = r + half < e->mi_rows, has_cols = c + half < e->mi_cols;
  const int sub_h = bsize_of(num4, half), sub_v = bsize_of(half, num4);
  const int split = bsize_of(half, half);
  const int sr = r & ~15, sc = c & ~15;
  const int idx = t->at[r - sr][c - sc];
  Blk *b = idx >= 0 ? &t->sb->b[idx] : NULL;
  int kind = PARTITION_SPLIT;
  if (b && b->bsize == bsize) kind = PARTITION_NONE;
  else if (b && b->bsize == sub_h) kind = PARTITION_HORZ;
  else if (b && b->bsize == sub_v) kind = PARTITION_VERT;
  const int bsl = mi_wlog2[bsize];
  const int above = tw_inside(t, r - 1, c) && mi_wlog2[TMI(t, mi_size, r - 1, c)] < bsl;
  const int left = tw_inside(t, r, c - 1) && mi_hlog2[TMI(t, mi_size, r, c - 1)] < bsl;
  uint16_t *cdf = t->cdf.partition[(bsl - 1) * 4 + 2 * left + above];
  if (has_rows && has_cols) {
    sw_symbol(&t->ec, cdf, kind, bsl == 1 ? 4 : 10);
  } else if (has_rows) {
    const int p = 32768 - cdf_prob(cdf, 1) - cdf_prob(cdf, 3) - cdf_prob(cdf, 4) -
                  cdf_prob(cdf, 5) - cdf_prob(cdf, 6) - cdf_prob(cdf, 8);
    const uint16_t tmp[2] = {(uint16_t)(32768 - p), 0};
    sw_cdf(&t->ec, tmp, kind == PARTITION_SPLIT, 2);
  } else if (has_cols) {
    const int p = 32768 - cdf_prob(cdf, 2) - cdf_prob(cdf, 3) - cdf_prob(cdf, 4) -
                  cdf_prob(cdf, 6) - cdf_prob(cdf, 7) - cdf_prob(cdf, 9);
    const uint16_t tmp[2] = {(uint16_t)(32768 - p), 0};
    sw_cdf(&t->ec, tmp, kind == PARTITION_SPLIT, 2);
  }
  if (kind == PARTITION_NONE) {
    tw_block(t, b);
  } else if (kind == PARTITION_HORZ) {
    tw_block(t, b);
    if (has_rows) tw_block(t, &t->sb->b[t->at[r + half - sr][c - sc]]);
  } else if (kind == PARTITION_VERT) {
    tw_block(t, b);
    if (has_cols) tw_block(t, &t->sb->b[t->at[r - sr][c + half - sc]]);
  } else {
    tw_partition(t, r, c, split);
    tw_partition(t, r, c + half, split);
    tw_partition(t, r + half, c, split);
    tw_partition(t, r + half, c + half, split);
  }
}

/* ------------------------------------------------------------- entry */

static int tile_log2(int blk, int target) {
  int k = 0;
  while ((blk << k) < target) k++;
  return k;
}

static void free_coder(Coder *e) {
  for (int p = 0; p < 3; p++) {
    free(e->src[p]);
    free(e->rec[p]);
  }
  free(e->factors);
  free(e->sbs);
  free(e->col_starts);
  free(e->row_starts);
}

int av1_encode_tiles(const uint8_t *y, const uint8_t *u, const uint8_t *v,
                     int w, int h, uint8_t *out, long cap, long *sizes,
                     int *flags) {
  Coder e;
  memset(&e, 0, sizeof(e));
  e.w = w;
  e.h = h;
  e.mi_cols = 2 * ((w + 7) >> 3);
  e.mi_rows = 2 * ((h + 7) >> 3);
  e.sb_cols = (e.mi_cols + 15) >> 4;
  e.sb_rows = (e.mi_rows + 15) >> 4;
  const uint8_t *in[3] = {y, u, v};
  for (int p = 0; p < 3; p++) {
    const int s = p > 0;
    const int pw = p ? (w + 1) >> 1 : w, ph = p ? (h + 1) >> 1 : h;
    e.W[p] = (64 * e.sb_cols + 64) >> s;
    e.H[p] = (64 * e.sb_rows + 64) >> s;
    e.src[p] = malloc((size_t)e.W[p] * (size_t)e.H[p]);
    e.rec[p] = calloc((size_t)e.W[p] * (size_t)e.H[p], 1);
    if (!e.src[p] || !e.rec[p]) { free_coder(&e); return 2; }
    for (int i = 0; i < e.H[p]; i++)
      for (int j = 0; j < e.W[p]; j++)
        e.src[p][i * e.W[p] + j] = in[p][(i < ph ? i : ph - 1) * pw + (j < pw ? j : pw - 1)];
  }
  if (ssim_factors(&e)) { free_coder(&e); return 2; }
  e.base_rdmult = rd_mult(ENC_BASE_Q);
  {
    Cdfs c0;
    init_cdfs(&c0, ENC_BASE_Q);
    fill_costs(&e.costs, &c0);
  }
  /* the tiles: uniform spacing, a column past 4096 pixels */
  const int cols_log2 = tile_log2(64, ((2 * ((w + 7) >> 3) + 15) >> 4) + 1);
  const int need = tile_log2((4096 * 2304) >> 12, e.sb_cols * e.sb_rows);
  const int rows_log2 = need - cols_log2 > 0 ? need - cols_log2 : 0;
  const int cstep = ((e.sb_cols + (1 << cols_log2) - 1) >> cols_log2) * 16;
  const int rstep = ((e.sb_rows + (1 << rows_log2) - 1) >> rows_log2) * 16;
  e.ncols = (e.mi_cols + cstep - 1) / cstep;
  e.nrows = (e.mi_rows + rstep - 1) / rstep;
  e.col_starts = malloc(sizeof(int) * (size_t)(e.ncols + 1));
  e.row_starts = malloc(sizeof(int) * (size_t)(e.nrows + 1));
  e.sbs = malloc(sizeof(Sb) * (size_t)(e.sb_cols * e.sb_rows));
  if (!e.col_starts || !e.row_starts || !e.sbs) { free_coder(&e); return 2; }
  for (int i = 0; i <= e.ncols; i++) e.col_starts[i] = i < e.ncols ? i * cstep : e.mi_cols;
  for (int i = 0; i <= e.nrows; i++) e.row_starts[i] = i < e.nrows ? i * rstep : e.mi_rows;
  /* each superblock's qindex and partition, then the header's flags */
  int delta_q = 0, tx_select = 0;
  for (int tr = 0; tr < e.nrows; tr++)
    for (int tc = 0; tc < e.ncols; tc++)
      for (int r = e.row_starts[tr]; r < e.row_starts[tr + 1]; r += 16)
        for (int c = e.col_starts[tc]; c < e.col_starts[tc + 1]; c += 16) {
          Sb *sb = &e.sbs[(r >> 4) * e.sb_cols + (c >> 4)];
          sb->q = sb_qindex(&e, 4 * r, 4 * c);
          const int64_t base = 120 * (int64_t)av1_ac_qlookup[sb->q];
          int64_t thr[4] = {base, base, base / 3, base >> 1};
          if ((int64_t)w * h >= 1280 * 720) thr[2] = thr[3] = base >> 1;
          partition(&e, sb, r, c, e.row_starts[tr + 1], e.col_starts[tc + 1], thr);
          delta_q |= sb->q != ENC_BASE_Q;
          for (int i = 0; i < sb->n; i++) {
            Blk *b = &sb->b[i];
            b->q = sb->q;
            b->tx = av1_max_txsize_rect_lookup[b->bsize];
            while (tx_wlog2[b->tx] != tx_hlog2[b->tx]) b->tx = split_tx[b->tx];
            tx_select |= bw4_of[b->bsize] != bh4_of[b->bsize];
          }
        }
  flags[0] = delta_q;
  flags[1] = tx_select;
  /* the tiles' symbols */
  const int cost_upd_sbrow = (w < h ? w : h) >= 2160;
  const size_t mi_n = (size_t)e.mi_rows * (size_t)e.mi_cols;
  uint8_t *mi = malloc(3 * mi_n), *above = malloc(3 * (size_t)(e.mi_cols + 64));
  if (!mi || !above) { free(mi); free(above); free_coder(&e); return 2; }
  long used = 0, n = 0;
  int rc = 0;
  for (int tr = 0; tr < e.nrows && !rc; tr++)
    for (int tc = 0; tc < e.ncols && !rc; tc++) {
      TileW t;
      memset(&t, 0, sizeof(t));
      t.e = &e;
      t.row_start = e.row_starts[tr];
      t.row_end = e.row_starts[tr + 1];
      t.col_start = e.col_starts[tc];
      t.col_end = e.col_starts[tc + 1];
      t.delta_q = delta_q;
      t.tx_select = tx_select;
      t.mi_size = mi;
      t.y_mode = mi + mi_n;
      t.tx_size = mi + 2 * mi_n;
      memset(mi, 0, 3 * mi_n);
      memset(above, 0, 3 * (size_t)(e.mi_cols + 64));
      for (int p = 0; p < 3; p++) t.above[p] = above + p * (e.mi_cols + 64);
      init_cdfs(&t.cdf, ENC_BASE_Q);
      t.ec.rng = 0x8000;
      t.ec.cnt = -9;
      t.current_q = ENC_BASE_Q;
      for (int r = t.row_start; r < t.row_end; r += 16) {
        memset(t.left, 0, sizeof(t.left));
        /* from 4K up, libaom refreshes its rates from the tile's CDFs at
         * each superblock row (INTERNAL_COST_UPD_SBROW); below, never */
        if (cost_upd_sbrow) fill_costs(&e.costs, &t.cdf);
        for (int c = t.col_start; c < t.col_end; c += 16) {
          t.sb = &e.sbs[(r >> 4) * e.sb_cols + (c >> 4)];
          memset(t.at, 0xff, sizeof(t.at));
          for (int i = 0; i < t.sb->n; i++) t.at[t.sb->b[i].r - r][t.sb->b[i].c - c] = (int16_t)i;
          t.pending_q = delta_q ? t.sb->q : -1;
          tw_partition(&t, r, c, BLOCK_64X64);
        }
      }
      const long got = sw_done(&t.ec, out + used, cap - used);
      free(t.ec.pre);
      if (got < 0) {
        rc = 2;
      } else {
        sizes[n++] = got;
        used += got;
      }
    }
  free(mi);
  free(above);
  free_coder(&e);
  if (rc) return rc;
  if (used > cap) {
    sizes[0] = used;
    return 3;
  }
  return 0;
}
