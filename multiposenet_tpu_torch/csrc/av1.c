/* Host AV1 intra-frame decoder of the port, in plain C99 with no library:
 * the one frame of an AVIF image as libaom 3.14.1 decodes it under
 * libavif 1.4.2 and OpenCV 5.0, for the tools libaom's encoder uses at
 * any of cv2's depths, qualities and speeds and that other writers use
 * (key frames of 8, 10 or 12 bits a sample at 4:0:0, 4:2:0, 4:2:2 or
 * 4:4:4, lossy or lossless, with 64x64 or 128x128 superblocks,
 * segmentation and film grain, without superres).
 * The planes hold 16 bits a sample at every depth (AV1_BIT_DEPTH in the
 * plan); the depth's terms are libaom's high-bit-depth ones: the
 * quantiser tables, the coefficient clamp at 2^(bd+7), the transform
 * clamps, the intra edge bases and the clips to 2^bd - 1, palette
 * colours of bd bits, the deblocking limits and offsets, CDEF's shifted
 * strengths and damping, the Wiener rounding and the self-guided
 * variance scaling. The stage functions take uint16 samples and bd
 * (av1_*_hbd); their 8-bit entry points (the same names without _hbd)
 * widen to 16 bits, call them at bd 8 and narrow back. The container, the
 * OBUs and the uncompressed frame header are Python (utils/avif.py),
 * which passes the header's fields as a plan of int32 (AV1_* below) and
 * the tiles' bytes.
 * The plain version of everything here is utils/av1.py, which this file
 * matches sample for sample; the stage functions exported beside
 * av1_decode_frame (the inverse transforms and the WHT, the intra
 * predictors, CFL, the palette colour context, the intra block copy DV
 * check and filter, the edge filters, CDEF, a deblocking line, the Wiener and
 * self-guided filters) are what the tests hold against it and against
 * libaom's C reference functions. Nothing here keeps state between calls.
 *
 * av1_decode_frame reads each tile (the symbol decoder and CDF adaptation
 * of libaom's entropy decoder, restoration units, partition, intra mode
 * info, segment ids (spatially predicted, read before or after the skip
 * flag; SEG_LVL_SKIP), palette and its colour-index maps, intra block
 * copy and its DV, CDEF indices, delta q and delta lf, tx size and the
 * transform tree, tx type, coefficients), predicts (DC, directional with
 * edge filtering and upsampling, smooth, Paeth, filter intra, chroma from
 * luma, palette, intra block copy), dequantises (at the block's
 * segment's qindex, with the quantiser matrices) and adds the inverse
 * transform (libaom's av1_inv_txfm2d_add_c: its row and column clamps
 * and its 16-bit stage clamps; the Walsh-Hadamard transform in lossless
 * segments), then runs the deblocking filter (with each segment's
 * SEG_LVL_ALT_LF_* levels), CDEF and loop restoration over the frame.
 * It writes the Y plane (height x width) and,
 * unless monochrome, U and V ((height+1)/2 x (width+1)/2 at 4:2:0, height
 * x width at 4:4:4), uint8 at 8 bits, else uint16. Coefficients are kept
 * in libaom's column-major order (index = column * height + row), which
 * its scan tables and context offsets assume.
 *
 * Returns 0, 1 with a message in err (a damaged tile, a DV that
 * libaom's av1_is_dv_valid rejects or a segment id past the last active
 * one, as libaom reports each frame corrupt), 2 when out of
 * memory. stats (AV1_STAT_* counters) records which tools the stream
 * reached.
 *
 * av1_film_grain adds a frame's film grain to those output planes as
 * libaom 3.14.1's av1_add_film_grain adds it to the frames its decoder
 * outputs (the parameters as G_* int32 fields, utils/avif.py grain_plan).
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "av1_tables.h"

/* The plan: AV1_NHDR header fields, then the tile grid and tile bytes. */
enum {
  AV1_WIDTH, AV1_HEIGHT, AV1_MONO, AV1_ENABLE_FILTER_INTRA,
  AV1_ENABLE_EDGE_FILTER, AV1_ENABLE_CDEF, AV1_SCREEN_CONTENT,
  AV1_DISABLE_CDF_UPDATE, AV1_BASE_Q, AV1_DQ_Y_DC, AV1_DQ_U_DC,
  AV1_DQ_U_AC, AV1_DQ_V_DC, AV1_DQ_V_AC, AV1_USING_QM, AV1_QM_Y, AV1_QM_U,
  AV1_QM_V, AV1_DELTA_Q_PRESENT, AV1_DELTA_Q_RES, AV1_DELTA_LF_PRESENT,
  AV1_DELTA_LF_RES, AV1_DELTA_LF_MULTI, AV1_LF_LEVEL, /* 4 */
  AV1_LF_SHARPNESS = AV1_LF_LEVEL + 4, AV1_LF_DELTA_ENABLED,
  AV1_LF_REF_DELTAS, /* 8 */
  AV1_CDEF_DAMPING = AV1_LF_REF_DELTAS + 8, AV1_CDEF_BITS,
  AV1_CDEF_Y_PRI, /* 8 each */
  AV1_CDEF_Y_SEC = AV1_CDEF_Y_PRI + 8, AV1_CDEF_UV_PRI = AV1_CDEF_Y_SEC + 8,
  AV1_CDEF_UV_SEC = AV1_CDEF_UV_PRI + 8, AV1_TX_MODE_SELECT = AV1_CDEF_UV_SEC + 8,
  AV1_REDUCED_TX_SET, AV1_TILE_COLS, AV1_TILE_ROWS,
  AV1_SSX, AV1_SSY, /* chroma subsampling: 1, 1 (4:2:0) or 0, 0 (4:4:4) */
  AV1_LOSSLESS,     /* CodedLossless: the WHT, no deblocking, CDEF or LR */
  AV1_ALLOW_INTRABC,
  AV1_NO_CDEF = 79, /* 1: the deblocked frame, before CDEF and LR (a stage
                       for the tests) */
  AV1_LR_TYPE = 80, /* 3 planes: RESTORE_NONE, _WIENER, _SGRPROJ, _SWITCHABLE */
  AV1_LR_UNIT = 83, /* 3 planes: the restoration unit size */
  AV1_SB128 = 86,   /* 128x128 superblocks */
  AV1_NO_LR = 87,   /* 1: the frame before loop restoration (a stage for the
                       tests) */
  AV1_BIT_DEPTH = 88, /* 8, 10 or 12 */
  AV1_SEG_ENABLED = 89, /* segmentation_enabled */
  AV1_SEG_PRESKIP = 90, /* SegIdPreSkip */
  AV1_SEG_LAST_ACTIVE = 91, /* LastActiveSegId */
  AV1_SEG_MASK = 92, /* 8 segments: bit j, feature j enabled */
  AV1_SEG_DATA = 100, /* 8 x 8: FeatureData[segment][feature] */
  AV1_SEG_LOSSLESS = 164, /* 8: LosslessArray */
  AV1_SEG_QINDEX = 172, /* 8: get_qindex(1, segment) */
  AV1_COL_STARTS = 180, /* 65 MI columns */
  AV1_ROW_STARTS = AV1_COL_STARTS + 65, /* 65 MI rows */
  AV1_TILES = AV1_ROW_STARTS + 65 /* offset and size of each tile */
};

/* Counters of the tools a stream reached. */
enum {
  AV1_STAT_TX_SIZE = 0,                       /* 19 */
  AV1_STAT_TX_TYPE = AV1_STAT_TX_SIZE + 19,   /* 16 */
  AV1_STAT_Y_MODE = AV1_STAT_TX_TYPE + 16,    /* 13 */
  AV1_STAT_UV_MODE = AV1_STAT_Y_MODE + 13,    /* 14 */
  AV1_STAT_FILTER_INTRA = AV1_STAT_UV_MODE + 14, /* 5 modes */
  AV1_STAT_ANGLE_DELTA = AV1_STAT_FILTER_INTRA + 5, /* 7 */
  AV1_STAT_UPSAMPLE = AV1_STAT_ANGLE_DELTA + 7,
  AV1_STAT_EDGE_FILTER, AV1_STAT_TX_DEPTH, AV1_STAT_DELTA_Q,
  AV1_STAT_DELTA_LF, AV1_STAT_TILES, AV1_STAT_BLOCKS, AV1_STAT_EOB_MAX,
  AV1_STAT_GOLOMB, AV1_STAT_CDEF_BLOCKS, AV1_STAT_LF_EDGES,
  AV1_STAT_PARTITION, /* 10 */
  AV1_STAT_PALETTE_Y = AV1_STAT_PARTITION + 10, AV1_STAT_PALETTE_UV,
  AV1_STAT_PALETTE_CACHE, AV1_STAT_PALETTE_DELTA_V, AV1_STAT_LOSSLESS_BLOCKS,
  AV1_STAT_LR_NONE, AV1_STAT_LR_WIENER, AV1_STAT_LR_SGRPROJ,
  AV1_STAT_LR_SWITCHABLE, AV1_STAT_INTRABC_BLOCKS, AV1_STAT_INTRABC_HALFPEL,
  AV1_STAT_VARTX,
  AV1_STAT_SEG_FRAMES, /* frames with segmentation enabled */
  AV1_STAT_SEGMENT, /* 8: blocks of each segment id */
  AV1_STAT_SEG_FEATURE = AV1_STAT_SEGMENT + 8, /* 8: blocks whose segment
                                                  has feature j enabled */
  AV1_STAT_SEG_PREDICTED = AV1_STAT_SEG_FEATURE + 8, /* skipped blocks that
                                                        take the predicted id */
  AV1_STAT_SEG_LOSSLESS, /* lossless-segment blocks of a lossy frame */
  AV1_STAT_GRAIN_FRAMES, /* frames whose film grain was added */
  AV1_STAT_GRAIN_BLOCKS, /* 32x32 luma blocks of film grain */
  AV1_NSTATS
};
enum { SEG_LVL_ALT_Q, SEG_LVL_ALT_LF_Y_V, SEG_LVL_REF_FRAME = 5,
       SEG_LVL_SKIP };
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
       D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
       PAETH_PRED, UV_CFL_PRED };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
       FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
       V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4,
       TX_8X16, TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16,
       TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16 };
enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
       BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
       BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128,
       BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64,
       BLOCK_64X16, BLOCK_INVALID = 255 };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
       PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A,
       PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };

static const uint8_t bw4_of[22] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16,
                                   16, 32, 32, 1, 4, 2, 8, 4, 16};
static const uint8_t bh4_of[22] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16,
                                   32, 16, 32, 4, 1, 8, 2, 16, 4};
static const uint8_t mi_wlog2[22] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4,
                                     4, 5, 5, 0, 2, 1, 3, 2, 4};
static const uint8_t mi_hlog2[22] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4,
                                     5, 4, 5, 2, 0, 3, 1, 4, 2};
static const uint8_t max_tx_depth[22] = {0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4,
                                         4, 4, 4, 4, 2, 2, 3, 3, 4, 4};
static const uint8_t tx_wlog2[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6,
                                     2, 4, 3, 5, 4, 6};
static const uint8_t tx_hlog2[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5,
                                     4, 2, 5, 3, 6, 4};
static const uint8_t split_tx[19] = {0, 0, 1, 2, 3, 0, 0, 1, 1, 2, 2, 3, 3,
                                     5, 6, 7, 8, 9, 10};
static const uint8_t tx_sqr[19] = {0, 1, 2, 3, 4, 0, 0, 1, 1, 2, 2, 3, 3,
                                   0, 0, 1, 1, 2, 2};
static const uint8_t tx_sqr_up[19] = {0, 1, 2, 3, 4, 1, 1, 2, 2, 3, 3, 4, 4,
                                      2, 2, 3, 3, 4, 4};
static const uint8_t intra_mode_ctx[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1,
                                           2, 0};
static const uint8_t mode_to_txfm[13] = {
    DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
    DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST};
static const uint8_t fimode_to_intradir[5] = {DC_PRED, V_PRED, H_PRED,
                                              D157_PRED, DC_PRED};
static const uint8_t num_ext_tx_set[6] = {1, 2, 5, 7, 12, 16};
static const uint8_t intra_edge_kernel[3][5] = {
    {0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
static const int div_table[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
static const int8_t inv_row_shift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1,
                                         1, 1, 1, 1, 2, 2, 2, 2};

/* ---------------------------------------------------------------- CDFs */

typedef struct {
  uint16_t kf_y[5][5][14], uv[2][13][15], partition[20][11];
  uint16_t intra_ext_tx[3][4][13][17];
  uint16_t txb_skip[5][13][3], eob_extra[5][2][9][3], dc_sign[2][3][3];
  uint16_t eob16[2][2][6], eob32[2][2][7], eob64[2][2][8], eob128[2][2][9];
  uint16_t eob256[2][2][10], eob512[2][2][11], eob1024[2][2][12];
  uint16_t coeff_base_eob[5][2][4][4], coeff_base[5][2][42][5];
  uint16_t coeff_br[5][2][21][5];
  uint16_t skip[3][3], filter_intra[22][3], filter_intra_mode[6];
  uint16_t angle_delta[8][8], tx_size[4][3][4], delta_q[5];
  uint16_t delta_lf_multi[4][5], delta_lf[5], cfl_sign[9], cfl_alpha[6][17];
  uint16_t palette_y_mode[7][3][3], palette_uv_mode[2][3];
  uint16_t palette_y_size[7][8], palette_uv_size[7][8];
  uint16_t palette_y_color[7][5][9], palette_uv_color[7][5][9];
  uint16_t switchable_restore[4], wiener_restore[3], sgrproj_restore[3];
  uint16_t intrabc[3], txfm_partition[21][3], inter_ext_tx[4][4][17];
  uint16_t dv[143]; /* libaom's nmv_context: the DV's CDFs (DV_* below) */
  uint16_t spatial_seg[3][9];
} Cdfs;

/* Offsets in nmv_context: the joints, then per component (at DV_COMP +
 * DV_COMP_SIZE * k) classes, class0_fp, fp, sign, class0_hp, hp, class0,
 * bits. */
enum { DV_COMP = 5, DV_COMP_SIZE = 69, DV_CLASSES = 0, DV_SIGN = 27,
       DV_CLASS0 = 36, DV_BITS = 39 };

static void init_cdfs(Cdfs *c, int base_q) {
  const int q = base_q <= 20 ? 0 : base_q <= 60 ? 1 : base_q <= 120 ? 2 : 3;
#define CP(dst, src) memcpy(dst, src, sizeof(dst))
  CP(c->kf_y, av1_kf_y_mode_cdf);
  CP(c->uv, av1_uv_mode_cdf);
  CP(c->partition, av1_partition_cdf);
  CP(c->intra_ext_tx, av1_intra_ext_tx_cdf);
  CP(c->txb_skip, av1_txb_skip_cdf[q]);
  CP(c->eob_extra, av1_eob_extra_cdf[q]);
  CP(c->dc_sign, av1_dc_sign_cdf[q]);
  CP(c->eob16, av1_eob_multi16_cdf[q]);
  CP(c->eob32, av1_eob_multi32_cdf[q]);
  CP(c->eob64, av1_eob_multi64_cdf[q]);
  CP(c->eob128, av1_eob_multi128_cdf[q]);
  CP(c->eob256, av1_eob_multi256_cdf[q]);
  CP(c->eob512, av1_eob_multi512_cdf[q]);
  CP(c->eob1024, av1_eob_multi1024_cdf[q]);
  CP(c->coeff_base_eob, av1_coeff_base_eob_cdf[q]);
  CP(c->coeff_base, av1_coeff_base_cdf[q]);
  CP(c->coeff_br, av1_coeff_br_cdf[q]);
  CP(c->skip, av1_skip_cdf);
  CP(c->filter_intra, av1_filter_intra_cdf);
  CP(c->filter_intra_mode, av1_filter_intra_mode_cdf);
  CP(c->angle_delta, av1_angle_delta_cdf);
  CP(c->tx_size, av1_tx_size_cdf);
  CP(c->delta_q, av1_delta_q_cdf);
  CP(c->delta_lf_multi, av1_delta_lf_multi_cdf);
  CP(c->delta_lf, av1_delta_lf_cdf);
  CP(c->cfl_sign, av1_cfl_sign_cdf);
  CP(c->cfl_alpha, av1_cfl_alpha_cdf);
  CP(c->palette_y_mode, av1_palette_y_mode_cdf);
  CP(c->palette_uv_mode, av1_palette_uv_mode_cdf);
  CP(c->palette_y_size, av1_palette_y_size_cdf);
  CP(c->palette_uv_size, av1_palette_uv_size_cdf);
  CP(c->palette_y_color, av1_palette_y_color_index_cdf);
  CP(c->palette_uv_color, av1_palette_uv_color_index_cdf);
  CP(c->switchable_restore, av1_switchable_restore_cdf);
  CP(c->wiener_restore, av1_wiener_restore_cdf);
  CP(c->sgrproj_restore, av1_sgrproj_restore_cdf);
  CP(c->intrabc, av1_intrabc_cdf);
  CP(c->txfm_partition, av1_txfm_partition_cdf);
  CP(c->inter_ext_tx, av1_inter_ext_tx_cdf);
  CP(c->dv, av1_nmv_context);
  CP(c->spatial_seg, av1_spatial_pred_seg_cdf);
#undef CP
}

/* ------------------------------------------------- the symbol decoder */

typedef struct {
  const uint8_t *buf, *bptr, *end;
  uint32_t dif;
  uint32_t rng;
  int cnt;
  int tell_offs;
  int allow_update;
} Ec;

static void ec_refill(Ec *d) {
  int s = 32 - 9 - (d->cnt + 15);
  uint32_t dif = d->dif;
  int cnt = d->cnt;
  const uint8_t *b = d->bptr;
  for (; s >= 0 && b < d->end; s -= 8, b++) {
    dif ^= (uint32_t)b[0] << s;
    cnt += 8;
  }
  if (b >= d->end) {
    d->tell_offs += 0x4000 - cnt;
    cnt = 0x4000;
  }
  d->dif = dif;
  d->cnt = cnt;
  d->bptr = b;
}

static void ec_init(Ec *d, const uint8_t *buf, long n, int allow_update) {
  d->buf = d->bptr = buf;
  d->end = buf + n;
  d->tell_offs = 10 - (32 - 8);
  d->dif = ((uint32_t)1 << 31) - 1;
  d->rng = 0x8000;
  d->cnt = -15;
  d->allow_update = allow_update;
  ec_refill(d);
}

/* libaom's aom_reader_has_overflowed: the bits read (od_ec_dec_tell) run
 * past the tile's bytes. */
static int ec_overflowed(const Ec *d) {
  const long tell = (long)(d->bptr - d->buf) * 8 - d->cnt + d->tell_offs;
  return ((tell + 7) >> 3) > (long)(d->end - d->buf);
}

/* libaom's check_trailing_bits_after_symbol_coder: after a tile's last
 * symbol, a 1 bit, then zeros to the end of its bytes. */
static int ec_trailing_bits_ok(const Ec *d) {
  if (ec_overflowed(d)) return 0;
  const long bits = (long)(d->bptr - d->buf) * 8 - d->cnt + d->tell_offs;
  const uint8_t *p = d->buf + ((bits + 7) >> 3);
  const int pattern = 128 >> ((bits - 1) & 7);
  if ((p[-1] & (2 * pattern - 1)) != pattern) return 0;
  for (; p < d->end; p++)
    if (*p) return 0;
  return 1;
}

static int ilog_nz(uint32_t v) { /* 1 + floor(log2 v), v > 0 */
  int n = 0;
  while (v) { n++; v >>= 1; }
  return n;
}

static int ec_normalize(Ec *d, uint32_t dif, uint32_t rng, int ret) {
  int s = 16 - ilog_nz(rng);
  d->cnt -= s;
  d->dif = ((dif + 1) << s) - 1;
  d->rng = rng << s;
  if (d->cnt < 0) ec_refill(d);
  return ret;
}

static int ec_decode_cdf(Ec *d, const uint16_t *icdf, int nsyms) {
  uint32_t dif = d->dif, r = d->rng, c = dif >> 16, u, v = r;
  int ret = -1, n = nsyms - 1;
  do {
    u = v;
    ret++;
    v = ((r >> 8) * (uint32_t)(icdf[ret] >> 6) >> 1);
    v += 4 * (uint32_t)(n - ret);
  } while (c < v);
  r = u - v;
  dif -= v << 16;
  return ec_normalize(d, dif, r, ret);
}

static int ec_bool(Ec *d, unsigned f) {
  uint32_t dif = d->dif, r = d->rng, v, vw, rnew;
  int ret = 1;
  v = ((r >> 8) * (uint32_t)(f >> 6) >> 1) + 4;
  vw = v << 16;
  rnew = v;
  if (dif >= vw) {
    rnew = r - v;
    dif -= vw;
    ret = 0;
  }
  return ec_normalize(d, dif, rnew, ret);
}

static int read_bit(Ec *d) { return ec_bool(d, 16384); }

static int read_literal(Ec *d, int n) {
  int v = 0;
  for (int i = 0; i < n; i++) v = (v << 1) | read_bit(d);
  return v;
}

/* libaom's av1_read_uniform (aom_read_primitive_quniform): 0 .. n-1. */
static int read_uniform(Ec *d, int n) {
  if (n <= 1) return 0;
  const int w = ilog_nz((uint32_t)n), m = (1 << w) - n;
  const int v = read_literal(d, w - 1);
  return v < m ? v : (v << 1) - m + read_bit(d);
}

static void update_cdf(uint16_t *cdf, int val, int nsymbs) {
  static const int nsymbs2speed[17] = {0, 0, 1, 1, 2, 2, 2, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 2};
  const int rate = 3 + (cdf[nsymbs] > 15) + (cdf[nsymbs] > 31) +
                   nsymbs2speed[nsymbs];
  int tmp = 32768;
  for (int i = 0; i < nsymbs - 1; ++i) {
    tmp = (i == val) ? 0 : tmp;
    if (tmp < cdf[i])
      cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
    else
      cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
  }
  cdf[nsymbs] += (cdf[nsymbs] < 32);
}

static int read_symbol(Ec *d, uint16_t *cdf, int nsymbs) {
  int v = ec_decode_cdf(d, cdf, nsymbs);
  if (d->allow_update) update_cdf(cdf, v, nsymbs);
  return v;
}

/* ------------------------------------------------------ the decoder */

/* A restoration unit: its type and its Wiener taps (vertical, then
 * horizontal: 3 each, the outer first) or self-guided set and xqd. */
typedef struct {
  int8_t type, sgr_set;
  int16_t coef[6];
} LrUnit;

typedef struct {
  int width, height, mono, ssx, ssy, planes, lossless; /* CodedLossless */
  int bd; /* the bit depth: 8, 10 or 12 */
  int sb4, sb_size; /* the superblock: its side in 4x4 units, its size */
  int mi_cols, mi_rows, mi_stride;
  const int32_t *hdr;
  /* planes (stride, allocated rows), 16 bits a sample at every depth */
  uint16_t *frame[3];
  int stride[3], alloc_h[3];
  /* per 4x4 luma unit */
  uint8_t *mi_size, *y_mode, *uv_mode, *skip, *tx_size_mi;
  int8_t *delta_lf; /* 4 a unit */
  uint8_t *pal_size;   /* 2 a unit: Y and UV palette sizes */
  uint16_t *pal_colors; /* 24 a unit: 8 colours of Y, U and V */
  uint8_t *is_inter;   /* an intra block copy block */
  int16_t *mvs;        /* 2 a unit: its DV (row, column) in 1/8 sample */
  uint8_t *written;    /* the unit is decoded */
  uint8_t *tx_type_mi; /* luma transform types */
  uint8_t *seg_map;    /* segment ids */
  int8_t *cdef_idx; /* per 64x64 */
  int cdef_stride;
  /* per 4x4 unit of each plane: the transform size for deblocking */
  uint8_t *lf_txsz[3];
  int lf_stride[3];
  /* loop restoration units of each plane, rows x cols */
  LrUnit *lr[3];
  int lr_rows[3], lr_cols[3];
  int32_t *stats;
  char *err;
  int errlen;
  int failed;
} Frame;

typedef struct {
  Frame *f;
  Ec ec;
  Cdfs cdf;
  int mi_row_start, mi_row_end, mi_col_start, mi_col_end;
  int current_q;
  int delta_lf[4];
  /* above contexts (per tile, frame-wide arrays indexed by 4x4 unit) */
  uint8_t *above_ctx[3], left_ctx[3][32];
  /* block decoded flags of the current superblock */
  uint8_t decoded[3][34][34];
  /* the current block */
  int mi_row, mi_col, bsize, has_chroma;
  int avail_u, avail_l, avail_u_chroma, avail_l_chroma;
  int skip, y_mode, uv_mode, angle_y, angle_uv, use_filter_intra,
      filter_mode, cfl_u, cfl_v, tx_size, read_deltas;
  int segment_id, lossless; /* the block's segment and LosslessArray[it] */
  int max_luma_w, max_luma_h;
  /* the current block's palettes and colour-index maps (Y, UV) */
  int pal_size[2];
  uint16_t pal_colors[3][8];
  uint8_t color_map[2][64 * 64];
  int color_map_w[2];
  /* the previous restoration unit's coefficients of each plane */
  int ref_wiener[3][2][3], ref_sgr[3][2];
  /* intra block copy: the block's flag and DV, its transform tree (per
   * 4x4 unit), the transform-size contexts (sample sizes) */
  int use_intrabc, mv[2];
  uint8_t inter_tx[32 * 32];
  uint8_t *above_txfm, left_txfm[32];
  int32_t coef[64 * 64];
} Tile;

static void fail(Frame *f, const char *msg) {
  if (!f->failed) {
    snprintf(f->err, (size_t)f->errlen, "%s", msg);
    f->failed = 1;
  }
}

static int bsize_of(int w4, int h4) {
  switch (w4 * 64 + h4) {
    case 1 * 64 + 1: return BLOCK_4X4;
    case 1 * 64 + 2: return BLOCK_4X8;
    case 2 * 64 + 1: return BLOCK_8X4;
    case 2 * 64 + 2: return BLOCK_8X8;
    case 2 * 64 + 4: return BLOCK_8X16;
    case 4 * 64 + 2: return BLOCK_16X8;
    case 4 * 64 + 4: return BLOCK_16X16;
    case 4 * 64 + 8: return BLOCK_16X32;
    case 8 * 64 + 4: return BLOCK_32X16;
    case 8 * 64 + 8: return BLOCK_32X32;
    case 8 * 64 + 16: return BLOCK_32X64;
    case 16 * 64 + 8: return BLOCK_64X32;
    case 16 * 64 + 16: return BLOCK_64X64;
    case 16 * 64 + 32: return BLOCK_64X128;
    case 32 * 64 + 16: return BLOCK_128X64;
    case 32 * 64 + 32: return BLOCK_128X128;
    case 1 * 64 + 4: return BLOCK_4X16;
    case 4 * 64 + 1: return BLOCK_16X4;
    case 2 * 64 + 8: return BLOCK_8X32;
    case 8 * 64 + 2: return BLOCK_32X8;
    case 4 * 64 + 16: return BLOCK_16X64;
    case 16 * 64 + 4: return BLOCK_64X16;
  }
  return BLOCK_INVALID;
}

static int tx_bsize(int tx) {
  return bsize_of(1 << (tx_wlog2[tx] - 2), 1 << (tx_hlog2[tx] - 2));
}

static int plane_bsize(int bsize, int ssx, int ssy) {
  return av1_ss_size_lookup[bsize][ssx][ssy];
}

#define MI(f, arr, r, c) ((f)->arr[(r) * (f)->mi_stride + (c)])

static int is_inside(const Tile *t, int r, int c) {
  return c >= t->mi_col_start && c < t->mi_col_end &&
         r >= t->mi_row_start && r < t->mi_row_end;
}

static int px(const Frame *f, int p, int y, int x) {
  return f->frame[p][y * f->stride[p] + x];
}

static int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
static int round2(int64_t x, int n) {
  if (n == 0) return (int)x;
  return (int)((x + ((int64_t)1 << (n - 1))) >> n);
}
static int round2signed(int64_t x, int n) {
  return x >= 0 ? round2(x, n) : -round2(-x, n);
}
static int floor_log2(uint32_t x) { return ilog_nz(x) - 1; }

/* ------------------------------------------------ inverse transforms */

static int32_t cospi12(int i) { return av1_cospi[2][i]; }

/* v clamped to -hi - 1 .. hi: a signed range of b bits (libaom's
 * clamp_value) for hi = 2^(b-1) - 1. */
static int32_t clamp_to(int64_t v, int32_t hi) {
  return v < -(int64_t)hi - 1 ? -hi - 1 : v > hi ? hi : (int32_t)v;
}

static int32_t range_hi(int bits) { return (int32_t)((1u << (bits - 1)) - 1); }

static int32_t cos128(int angle) {
  int a = angle & 255;
  if (a <= 64) return cospi12(a);
  if (a <= 128) return -cospi12(128 - a);
  if (a <= 192) return -cospi12(a - 128);
  return cospi12(256 - a);
}
static int32_t sin128(int angle) { return cos128(angle - 64); }

/* The butterfly of the AV1 specification, section 7.13.2.2: a rotation
 * by angle, rounded to 12 bits, with the two outputs swapped if flip. */
static void bfly(int32_t *T, int a, int b, int angle, int flip) {
  int64_t x = (int64_t)T[a] * cos128(angle) - (int64_t)T[b] * sin128(angle);
  int64_t y = (int64_t)T[a] * sin128(angle) + (int64_t)T[b] * cos128(angle);
  int32_t xr = (int32_t)((x + 2048) >> 12), yr = (int32_t)((y + 2048) >> 12);
  if (flip) {
    T[a] = yr;
    T[b] = xr;
  } else {
    T[a] = xr;
    T[b] = yr;
  }
}

/* The Hadamard step: T[a], T[b] = T[a] + T[b], T[a] - T[b] (flip: the
 * roles of a and b swapped), clamped to -hi - 1 .. hi as libaom's
 * clamp_value at the pass's stage_range clamps them
 * (av1_gen_inv_stage_range: rows 16, 18, 20 bits and columns 16, 16, 18
 * at 8, 10, 12 bits a sample). */
static void hada(int32_t *T, int a, int b, int flip, int32_t hi) {
  if (flip) { int t = a; a = b; b = t; }
  int32_t x = T[a], y = T[b];
  T[a] = clamp_to((int64_t)x + y, hi);
  T[b] = clamp_to((int64_t)x - y, hi);
}

static int brev(int nbits, int x) {
  int r = 0;
  for (int i = 0; i < nbits; i++) r |= ((x >> i) & 1) << (nbits - 1 - i);
  return r;
}

/* Inverse DCT of 2^n points (AV1 specification 7.13.2.3), its sums
 * clamped to r bits. */
void av1_idct(int32_t *T, int n, int r) {
  const int32_t hi = range_hi(r);
  int32_t copy[64];
  const int n0 = 1 << n;
  memcpy(copy, T, sizeof(int32_t) * n0);
  for (int i = 0; i < n0; i++) T[i] = copy[brev(n, i)];
  if (n == 6)
    for (int i = 0; i < 16; i++) bfly(T, 32 + i, 63 - i, 63 - 4 * brev(4, i), 0);
  if (n >= 5)
    for (int i = 0; i < 8; i++) bfly(T, 16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0);
  if (n == 6)
    for (int i = 0; i < 16; i++) hada(T, 32 + i * 2, 33 + i * 2, i & 1, hi);
  if (n >= 4)
    for (int i = 0; i < 4; i++) bfly(T, 8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0);
  if (n >= 5)
    for (int i = 0; i < 8; i++) hada(T, 16 + 2 * i, 17 + 2 * i, i & 1, hi);
  if (n == 6)
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 2; j++)
        bfly(T, 62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * brev(2, i) + 64 * j, 1);
  if (n >= 3)
    for (int i = 0; i < 2; i++) bfly(T, 4 + i, 7 - i, 56 - 32 * i, 0);
  if (n >= 4)
    for (int i = 0; i < 4; i++) hada(T, 8 + 2 * i, 9 + 2 * i, i & 1, hi);
  if (n >= 5)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++)
        bfly(T, 30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1);
  if (n == 6)
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 2; j++) hada(T, 32 + i * 4 + j, 35 + i * 4 - j, i & 1, hi);
  for (int i = 0; i < 2; i++) bfly(T, 2 * i, 1 + 2 * i, 32 + 16 * i, 1 - i);
  if (n >= 3)
    for (int i = 0; i < 2; i++) hada(T, 4 + 2 * i, 5 + 2 * i, i, hi);
  if (n >= 4)
    for (int i = 0; i < 2; i++) bfly(T, 14 - i, 9 + i, 48 + 64 * i, 1);
  if (n >= 5)
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 2; j++) hada(T, 16 + 4 * i + j, 19 + 4 * i - j, i & 1, hi);
  if (n == 6)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 4; j++)
        bfly(T, 61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1);
  for (int i = 0; i < 2; i++) hada(T, i, 3 - i, 0, hi);
  if (n >= 3) bfly(T, 6, 5, 32, 1);
  if (n >= 4)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++) hada(T, 8 + 4 * i + j, 11 + 4 * i - j, i, hi);
  if (n >= 5)
    for (int i = 0; i < 4; i++) bfly(T, 29 - i, 18 + i, 48 + (i >> 1) * 64, 1);
  if (n == 6)
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) hada(T, 32 + 8 * i + j, 39 + 8 * i - j, i & 1, hi);
  if (n >= 3)
    for (int i = 0; i < 4; i++) hada(T, i, 7 - i, 0, hi);
  if (n >= 4)
    for (int i = 0; i < 2; i++) bfly(T, 13 - i, 10 + i, 32, 1);
  if (n >= 5)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 4; j++) hada(T, 16 + i * 8 + j, 23 + i * 8 - j, i, hi);
  if (n == 6)
    for (int i = 0; i < 8; i++) bfly(T, 59 - i, 36 + i, i < 4 ? 48 : 112, 1);
  if (n >= 4)
    for (int i = 0; i < 8; i++) hada(T, i, 15 - i, 0, hi);
  if (n >= 5)
    for (int i = 0; i < 4; i++) bfly(T, 27 - i, 20 + i, 32, 1);
  if (n == 6) {
    for (int i = 0; i < 8; i++) hada(T, 32 + i, 47 - i, 0, hi);
    for (int i = 0; i < 8; i++) hada(T, 48 + i, 63 - i, 1, hi);
  }
  if (n >= 5)
    for (int i = 0; i < 16; i++) hada(T, i, 31 - i, 0, hi);
  if (n == 6)
    for (int i = 0; i < 8; i++) bfly(T, 55 - i, 40 + i, 32, 1);
  if (n == 6)
    for (int i = 0; i < 32; i++) hada(T, i, 63 - i, 0, hi);
}

void av1_iadst4(int32_t *T) {
  const int32_t *s = av1_sinpi[2];
  int32_t x0 = T[0], x1 = T[1], x2 = T[2], x3 = T[3];
  if (!(x0 | x1 | x2 | x3)) return;
  int32_t s0 = s[1] * x0, s1 = s[2] * x0, s2 = s[3] * x1, s3 = s[4] * x2;
  int32_t s4 = s[1] * x2, s5 = s[2] * x3, s6 = s[4] * x3;
  int32_t s7 = (x0 - x2) + x3;
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = s[3] * s7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  x0 = s0 + s3;
  x1 = s1 + s3;
  x2 = s2;
  x3 = s0 + s1;
  x3 = x3 - s3;
  T[0] = round2(x0, 12);
  T[1] = round2(x1, 12);
  T[2] = round2(x2, 12);
  T[3] = round2(x3, 12);
}

/* Inverse ADST of 8 or 16 points (AV1 specification 7.13.2.6-7.13.2.8),
 * its sums clamped to r bits. */
void av1_iadst(int32_t *T, int n, int r) {
  const int32_t hi = range_hi(r);
  int32_t copy[16];
  const int n0 = 1 << n;
  memcpy(copy, T, sizeof(int32_t) * n0);
  for (int i = 0; i < n0; i++)
    T[i] = copy[(i & 1) ? (i - 1) : (n0 - i - 1)];
  if (n == 3) {
    for (int i = 0; i < 4; i++) bfly(T, 2 * i, 2 * i + 1, 60 - 16 * i, 1);
    for (int i = 0; i < 4; i++) hada(T, i, 4 + i, 0, hi);
    for (int i = 0; i < 2; i++) bfly(T, 4 + 3 * i, 5 + i, 48 - 32 * i, 1);
    for (int i = 0; i < 2; i++) {
      hada(T, i, 2 + i, 0, hi);
      hada(T, 4 + i, 6 + i, 0, hi);
    }
    for (int i = 0; i < 2; i++) bfly(T, 2 + 4 * i, 3 + 4 * i, 32, 1);
  } else {
    for (int i = 0; i < 8; i++) bfly(T, 2 * i, 2 * i + 1, 62 - 8 * i, 1);
    for (int i = 0; i < 8; i++) hada(T, i, 8 + i, 0, hi);
    for (int i = 0; i < 2; i++) {
      bfly(T, 8 + 2 * i, 9 + 2 * i, 56 - 32 * i, 1);
      bfly(T, 13 + 2 * i, 12 + 2 * i, 8 + 32 * i, 1);
    }
    for (int i = 0; i < 4; i++) {
      hada(T, i, 4 + i, 0, hi);
      hada(T, 8 + i, 12 + i, 0, hi);
    }
    for (int i = 0; i < 2; i++) {
      bfly(T, 4 + 8 * i, 5 + 8 * i, 48, 1);
      bfly(T, 7 + 8 * i, 6 + 8 * i, 16, 1);
    }
    for (int i = 0; i < 2; i++) {
      hada(T, i, 2 + i, 0, hi);
      hada(T, 4 + i, 6 + i, 0, hi);
      hada(T, 8 + i, 10 + i, 0, hi);
      hada(T, 12 + i, 14 + i, 0, hi);
    }
    for (int i = 0; i < 4; i++) bfly(T, 2 + 4 * i, 3 + 4 * i, 32, 1);
  }
  memcpy(copy, T, sizeof(int32_t) * n0);
  for (int i = 0; i < n0; i++) {
    int a = (i >> 3) & 1;
    int b = ((i >> 2) & 1) ^ ((i >> 3) & 1);
    int c = ((i >> 1) & 1) ^ ((i >> 2) & 1);
    int d = (i & 1) ^ ((i >> 1) & 1);
    int idx = ((d << 3) | (c << 2) | (b << 1) | a) >> (4 - n);
    T[i] = (i & 1) ? -copy[idx] : copy[idx];
  }
}

static void iidentity(int32_t *T, int n) {
  const int n0 = 1 << n;
  for (int i = 0; i < n0; i++) {
    if (n == 2) T[i] = round2((int64_t)T[i] * 5793, 12);
    else if (n == 3) T[i] = T[i] * 2;
    else if (n == 4) T[i] = round2((int64_t)T[i] * 11586, 12);
    else T[i] = T[i] * 4;
  }
}

/* kind: 0 DCT, 1 ADST, 2 flipped ADST, 3 identity; r the stage range. */
static void tx1d(int32_t *T, int n, int kind, int r) {
  if (kind == 0) av1_idct(T, n, r);
  else if (kind == 3) iidentity(T, n);
  else if (n == 2) av1_iadst4(T);
  else av1_iadst(T, n, r);
}

static void tx_kinds(int tx_type, int *vert, int *horz) {
  static const uint8_t v[16] = {0, 1, 0, 1, 2, 0, 2, 1, 2, 3, 0, 3, 1, 3, 2, 3};
  static const uint8_t h[16] = {0, 0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 0, 3, 1, 3, 2};
  *vert = v[tx_type];
  *horz = h[tx_type];
}

/* Samples of 8 bits to 16 and back, for the 8-bit entry points of the
 * stage functions (w x h at each side's stride). */
static void widen(const uint8_t *s, int ss, uint16_t *d, int ds, int w, int h) {
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) d[i * ds + j] = s[i * ss + j];
}
static void narrow(const uint16_t *s, int ss, uint8_t *d, int ds, int w, int h) {
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) d[i * ds + j] = (uint8_t)s[i * ss + j];
}

/* av1_inv_txfm2d_add_c at bd bits a sample (av1_highbd_inv_txfm_add_c):
 * coef is column-major over the coded area (min(w,32) x min(h,32)); rows
 * clamped to bd + 8 bits in and through, columns to max(bd + 6, 16); the
 * residual is added to dst and clipped to 0 .. 2^bd - 1. */
void av1_inverse_transform_add_hbd(const int32_t *coef, int tx, int tx_type,
                                   uint16_t *dst, int stride, int bd) {
  const int lw = tx_wlog2[tx], lh = tx_hlog2[tx];
  const int row_bits = bd + 8, col_bits = bd + 6 > 16 ? bd + 6 : 16;
  const int pmax = (1 << bd) - 1;
  const int w = 1 << lw, h = 1 << lh;
  const int cw = w > 32 ? 32 : w, ch = h > 32 ? 32 : h;
  const int rect = lw - lh == 1 || lh - lw == 1;
  int vert, horz;
  int32_t buf[64 * 64];
  int32_t tmp[64];
  tx_kinds(tx_type, &vert, &horz);
  const int row_shift = inv_row_shift[tx];
  for (int r = 0; r < h; r++) {
    for (int c = 0; c < w; c++) {
      int32_t v = (r < ch && c < cw) ? coef[c * ch + r] : 0;
      if (rect) v = round2((int64_t)v * 2896, 12);
      tmp[c] = clamp_to(v, range_hi(row_bits));
    }
    tx1d(tmp, lw, horz, row_bits);
    for (int c = 0; c < w; c++) buf[r * w + c] = round2(tmp[c], row_shift);
  }
  for (int c = 0; c < w; c++) {
    const int sc = horz == 2 ? w - 1 - c : c;
    for (int r = 0; r < h; r++) tmp[r] = clamp_to(buf[r * w + sc], range_hi(col_bits));
    tx1d(tmp, lh, vert, col_bits);
    for (int r = 0; r < h; r++) {
      const int v = round2(tmp[vert == 2 ? h - 1 - r : r], 4);
      uint16_t *p = dst + r * stride + c;
      *p = (uint16_t)clip3(0, pmax, *p + v);
    }
  }
}

void av1_inverse_transform_add(const int32_t *coef, int tx, int tx_type,
                               uint8_t *dst, int stride) {
  uint16_t b[64 * 64];
  const int w = 1 << tx_wlog2[tx], h = 1 << tx_hlog2[tx];
  widen(dst, stride, b, w, w, h);
  av1_inverse_transform_add_hbd(coef, tx, tx_type, b, w, 8);
  narrow(b, w, dst, stride, w, h);
}

static void wht4(int32_t *a, int32_t *b, int32_t *c, int32_t *d) {
  /* in: a, c, d, b in the order libaom reads them */
  int32_t a1 = *a, c1 = *c, d1 = *d, b1 = *b, e1;
  a1 += c1;
  d1 -= b1;
  e1 = (a1 - d1) >> 1;
  b1 = e1 - b1;
  c1 = e1 - c1;
  a1 -= b1;
  d1 += c1;
  *a = a1;
  *b = b1;
  *c = c1;
  *d = d1;
}

/* libaom's av1_highbd_iwht4x4_16_add_c, the lossless inverse Walsh-Hadamard
 * transform: coef column-major (4x4), rows first with a shift of 2; the
 * residual is added to dst and clipped to 0 .. 2^bd - 1. */
void av1_iwht4x4_add_hbd(const int32_t *coef, uint16_t *dst, int stride,
                         int bd) {
  int32_t tmp[16];
  for (int i = 0; i < 4; i++) { /* row i */
    int32_t a = coef[i] >> 2, c = coef[4 + i] >> 2, d = coef[8 + i] >> 2,
            b = coef[12 + i] >> 2;
    wht4(&a, &b, &c, &d);
    tmp[i] = a;
    tmp[4 + i] = b;
    tmp[8 + i] = c;
    tmp[12 + i] = d;
  }
  for (int i = 0; i < 4; i++) { /* column i */
    int32_t a = tmp[4 * i], c = tmp[4 * i + 1], d = tmp[4 * i + 2],
            b = tmp[4 * i + 3];
    wht4(&a, &b, &c, &d);
    const int32_t out[4] = {a, b, c, d};
    for (int k = 0; k < 4; k++) {
      uint16_t *p = dst + k * stride + i;
      *p = (uint16_t)clip3(0, (1 << bd) - 1, *p + out[k]);
    }
  }
}

void av1_iwht4x4_add(const int32_t *coef, uint8_t *dst, int stride) {
  uint16_t b[16];
  widen(dst, stride, b, 4, 4, 4);
  av1_iwht4x4_add_hbd(coef, b, 4, 8);
  narrow(b, 4, dst, stride, 4, 4);
}

/* --------------------------------------------------- intra prediction */

static int is_directional(int mode) { return mode >= V_PRED && mode <= D67_PRED; }

static int is_smooth_at(const Tile *t, int r, int c, int plane) {
  const Frame *f = t->f;
  int mode = plane == 0 ? MI(f, y_mode, r, c) : MI(f, uv_mode, r, c);
  return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
}

static int filter_type(const Tile *t, int plane) {
  const Frame *f = t->f;
  int above = 0, left = 0;
  if (plane == 0 ? t->avail_u : t->avail_u_chroma) {
    int r = t->mi_row - 1, c = t->mi_col;
    if (plane > 0) {
      if (f->ssx && !(t->mi_col & 1)) c++;
      if (f->ssy && (t->mi_row & 1)) r--;
    }
    above = is_smooth_at(t, r, c, plane);
  }
  if (plane == 0 ? t->avail_l : t->avail_l_chroma) {
    int r = t->mi_row, c = t->mi_col - 1;
    if (plane > 0) {
      if (f->ssx && (t->mi_col & 1)) c--;
      if (f->ssy && !(t->mi_row & 1)) r++;
    }
    left = is_smooth_at(t, r, c, plane);
  }
  return above || left;
}

static int edge_strength(int w, int h, int type, int delta) {
  const int d = delta < 0 ? -delta : delta;
  const int wh = w + h;
  int s = 0;
  if (type == 0) {
    if (wh <= 8) { if (d >= 56) s = 1; }
    else if (wh <= 12) { if (d >= 40) s = 1; }
    else if (wh <= 16) { if (d >= 40) s = 1; }
    else if (wh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
    else if (wh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
    else { if (d >= 1) s = 3; }
  } else {
    if (wh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
    else if (wh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
    else if (wh <= 24) { if (d >= 4) s = 3; }
    else { if (d >= 1) s = 3; }
  }
  return s;
}

static int use_upsample(int w, int h, int type, int delta) {
  const int d = delta < 0 ? -delta : delta;
  if (d <= 0 || d >= 40) return 0;
  return type ? (w + h <= 8) : (w + h <= 16);
}

/* edge[-1 .. sz-2] filtered in place; edge points at element 0 (index -1
 * reachable). */
void av1_edge_filter(int *edge, int sz, int strength) {
  int tmp[288];
  if (!strength) return;
  for (int i = 0; i < sz; i++) tmp[i] = edge[i - 1];
  for (int i = 1; i < sz; i++) {
    int s = 0;
    for (int j = 0; j < 5; j++) {
      int k = clip3(0, sz - 1, i - 2 + j);
      s += intra_edge_kernel[strength - 1][j] * tmp[k];
    }
    edge[i - 1] = (s + 8) >> 4;
  }
}

void av1_edge_upsample_hbd(int *buf, int numpx, int bd) {
  int dup[64];
  dup[0] = buf[-1];
  for (int i = -1; i < numpx; i++) dup[i + 2] = buf[i];
  dup[numpx + 2] = buf[numpx - 1];
  buf[-2] = dup[0];
  for (int i = 0; i < numpx; i++) {
    int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
    s = clip3(0, (1 << bd) - 1, round2(s, 4));
    buf[2 * i - 1] = s;
    buf[2 * i] = dup[i + 2];
  }
}

void av1_edge_upsample(int *buf, int numpx) { av1_edge_upsample_hbd(buf, numpx, 8); }

/* Filter intra (AV1 specification 7.11.2.3) of a w x h block (sides up
 * to 32) from its edges: above[-1..w-1] (above[-1] the corner) and left[0..h-1],
 * clipped to bd bits. */
void av1_filter_intra_predict_hbd(uint16_t *dst, int stride, int w, int h,
                                  const int *above, const int *left, int mode,
                                  int bd) {
  int pred[32][32];
  const int w4 = w >> 2, h2 = h >> 1;
  for (int i2 = 0; i2 < h2; i2++)
    for (int j4 = 0; j4 < w4; j4++) {
      int p[7];
      for (int i = 0; i < 7; i++) {
        if (i < 5) {
          if (i2 == 0) p[i] = above[(j4 << 2) + i - 1];
          else if (j4 == 0 && i == 0) p[i] = left[(i2 << 1) - 1];
          else p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
        } else {
          if (j4 == 0) p[i] = left[(i2 << 1) + i - 5];
          else p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
        }
      }
      for (int i = 0; i < 8; i++) {
        int pr = 0;
        for (int j = 0; j < 7; j++) pr += av1_filter_intra_taps[mode][i][j] * p[j];
        pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] =
            clip3(0, (1 << bd) - 1, round2signed(pr, 4));
      }
    }
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) dst[i * stride + j] = (uint16_t)pred[i][j];
}

void av1_filter_intra_predict(uint8_t *dst, int stride, int w, int h,
                              const int *above, const int *left, int mode) {
  uint16_t b[32 * 32];
  av1_filter_intra_predict_hbd(b, w, w, h, above, left, mode, 8);
  narrow(b, w, dst, stride, w, h);
}

/* Directional prediction at angle (7.11.2.4, step 4 on): above and left
 * are the (filtered, upsampled) edges, indexable from -16. */
void av1_dr_predict_hbd(uint16_t *dst, int stride, int w, int h, const int *above,
                        const int *left, int up_above, int up_left, int angle) {
  int dx = 0, dy = 0;
  if (angle < 90) dx = av1_dr_intra_derivative[angle];
  else if (angle > 90 && angle < 180) dx = av1_dr_intra_derivative[180 - angle];
  if (angle > 90 && angle < 180) dy = av1_dr_intra_derivative[angle - 90];
  else if (angle > 180) dy = av1_dr_intra_derivative[270 - angle];
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      int v;
      if (angle < 90) {
        int idx = (i + 1) * dx;
        int base = (idx >> (6 - up_above)) + (j << up_above);
        int shift = ((idx << up_above) >> 1) & 0x1F;
        int max_base = (w + h - 1) << up_above;
        if (base < max_base)
          v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
        else
          v = above[max_base];
      } else if (angle > 90 && angle < 180) {
        int idx = (j << 6) - (i + 1) * dx;
        int base = idx >> (6 - up_above);
        if (base >= -(1 << up_above)) {
          int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
          v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
        } else {
          idx = (i << 6) - (j + 1) * dy;
          base = idx >> (6 - up_left);
          int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
          v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
        }
      } else if (angle > 180) {
        int idx = (j + 1) * dy;
        int base = (idx >> (6 - up_left)) + (i << up_left);
        int shift = ((idx << up_left) >> 1) & 0x1F;
        v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
      } else if (angle == 90) {
        v = above[j];
      } else {
        v = left[i];
      }
      dst[i * stride + j] = (uint16_t)v;
    }
}

void av1_dr_predict(uint8_t *dst, int stride, int w, int h, const int *above,
                    const int *left, int up_above, int up_left, int angle) {
  uint16_t b[64 * 64];
  av1_dr_predict_hbd(b, w, w, h, above, left, up_above, up_left, angle);
  narrow(b, w, dst, stride, w, h);
}

/* DC, smooth, smooth V, smooth H and Paeth prediction from the edges (DC
 * without either edge: 2^(bd-1)). */
void av1_nondir_predict_hbd(uint16_t *dst, int stride, int w, int h,
                            const int *above, const int *left, int mode,
                            int have_left, int have_above, int bd) {
  const int lw = floor_log2((uint32_t)w), lh = floor_log2((uint32_t)h);
  if (mode == SMOOTH_PRED) {
    const uint8_t *wx = av1_smooth_weights + w - 4, *wy = av1_smooth_weights + h - 4;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int s = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] +
                wx[j] * left[i] + (256 - wx[j]) * above[w - 1];
        dst[i * stride + j] = (uint16_t)round2(s, 9);
      }
  } else if (mode == SMOOTH_V_PRED) {
    const uint8_t *wy = av1_smooth_weights + h - 4;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++)
        dst[i * stride + j] =
            (uint16_t)round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
  } else if (mode == SMOOTH_H_PRED) {
    const uint8_t *wx = av1_smooth_weights + w - 4;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++)
        dst[i * stride + j] =
            (uint16_t)round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
  } else if (mode == DC_PRED) {
    int avg, sum = 0;
    if (have_left && have_above) {
      for (int k = 0; k < w; k++) sum += above[k];
      for (int k = 0; k < h; k++) sum += left[k];
      avg = (sum + ((w + h) >> 1)) / (w + h);
    } else if (have_left) {
      for (int k = 0; k < h; k++) sum += left[k];
      avg = (sum + (h >> 1)) >> lh;
    } else if (have_above) {
      for (int k = 0; k < w; k++) sum += above[k];
      avg = (sum + (w >> 1)) >> lw;
    } else {
      avg = 1 << (bd - 1);
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) dst[i * stride + j] = (uint16_t)avg;
  } else { /* PAETH */
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int base = above[j] + left[i] - above[-1];
        int pl = abs(base - left[i]), pt = abs(base - above[j]),
            ptl = abs(base - above[-1]);
        int v = (pl <= pt && pl <= ptl) ? left[i] : (pt <= ptl ? above[j] : above[-1]);
        dst[i * stride + j] = (uint16_t)v;
      }
  }
}

void av1_nondir_predict(uint8_t *dst, int stride, int w, int h,
                        const int *above, const int *left, int mode,
                        int have_left, int have_above) {
  uint16_t b[64 * 64];
  av1_nondir_predict_hbd(b, w, w, h, above, left, mode, have_left, have_above, 8);
  narrow(b, w, dst, stride, w, h);
}

static void predict_intra(Tile *t, int plane, int x, int y, int have_left,
                          int have_above, int have_above_rt,
                          int have_below_lt, int mode, int lw, int lh) {
  Frame *f = t->f;
  const int w = 1 << lw, h = 1 << lh;
  const int sx = plane ? f->ssx : 0, sy = plane ? f->ssy : 0;
  const int max_x = ((f->mi_cols * 4) >> sx) - 1;
  const int max_y = ((f->mi_rows * 4) >> sy) - 1;
  int above_buf[16 + 2 * 128 + 32], left_buf[16 + 2 * 128 + 32];
  int *above = above_buf + 16, *left = left_buf + 16;
  uint16_t *dst = f->frame[plane] + y * f->stride[plane] + x;
  const int stride = f->stride[plane], base = 1 << (f->bd - 1);
  for (int i = 0; i < w + h; i++) {
    if (!have_above && have_left) above[i] = px(f, plane, y, x - 1);
    else if (!have_above) above[i] = base - 1;
    else {
      int lim = x + (have_above_rt ? 2 * w : w) - 1;
      if (lim > max_x) lim = max_x;
      int xx = x + i < lim ? x + i : lim;
      above[i] = px(f, plane, y - 1, xx);
    }
    if (!have_left && have_above) left[i] = px(f, plane, y - 1, x);
    else if (!have_left) left[i] = base + 1;
    else {
      int lim = y + (have_below_lt ? 2 * h : h) - 1;
      if (lim > max_y) lim = max_y;
      int yy = y + i < lim ? y + i : lim;
      left[i] = px(f, plane, yy, x - 1);
    }
  }
  if (have_above && have_left) above[-1] = px(f, plane, y - 1, x - 1);
  else if (have_above) above[-1] = px(f, plane, y - 1, x);
  else if (have_left) above[-1] = px(f, plane, y, x - 1);
  else above[-1] = base;
  left[-1] = above[-1];

  if (plane == 0 && t->use_filter_intra) {
    av1_filter_intra_predict_hbd(dst, stride, w, h, above, left, t->filter_mode,
                                 f->bd);
    return;
  }
  if (is_directional(mode)) {
    const int delta = plane == 0 ? t->angle_y : t->angle_uv;
    const int angle = av1_mode_to_angle_map[mode] + delta * 3;
    int up_above = 0, up_left = 0;
    if (f->hdr[AV1_ENABLE_EDGE_FILTER]) {
      if (angle != 90 && angle != 180) {
        if (angle > 90 && angle < 180 && w + h >= 24) {
          int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
          left[-1] = above[-1] = v;
        }
        const int type = filter_type(t, plane);
        if (have_above) {
          int s = edge_strength(w, h, type, angle - 90);
          int n = (w < max_x - x + 1 ? w : max_x - x + 1) + (angle < 90 ? h : 0) + 1;
          if (s) f->stats[AV1_STAT_EDGE_FILTER]++;
          av1_edge_filter(above, n, s);
        }
        if (have_left) {
          int s = edge_strength(w, h, type, angle - 180);
          int n = (h < max_y - y + 1 ? h : max_y - y + 1) + (angle > 180 ? w : 0) + 1;
          if (s) f->stats[AV1_STAT_EDGE_FILTER]++;
          av1_edge_filter(left, n, s);
        }
      }
      up_above = use_upsample(w, h, filter_type(t, plane), angle - 90);
      if (up_above) {
        av1_edge_upsample_hbd(above, w + (angle < 90 ? h : 0), f->bd);
        f->stats[AV1_STAT_UPSAMPLE]++;
      }
      up_left = use_upsample(w, h, filter_type(t, plane), angle - 180);
      if (up_left) {
        av1_edge_upsample_hbd(left, h + (angle > 180 ? w : 0), f->bd);
        f->stats[AV1_STAT_UPSAMPLE]++;
      }
    }
    av1_dr_predict_hbd(dst, stride, w, h, above, left, up_above, up_left, angle);
    return;
  }
  av1_nondir_predict_hbd(dst, stride, w, h, above, left, mode, have_left,
                         have_above, f->bd);
}

/* Chroma from luma on the w x h chroma block at dst, which holds its DC
 * prediction: luma is the co-located luma (subsampled by ssx, ssy), of
 * which max_w x max_h samples are decoded (later columns and rows repeat
 * the last). */
void av1_cfl_predict_ss_hbd(uint16_t *dst, int stride, const uint16_t *luma,
                            int luma_stride, int w, int h, int max_w, int max_h,
                            int alpha, int ssx, int ssy, int bd) {
  int L[32][32];
  int avg = 0;
  const int shift = 3 - ssx - ssy;
  for (int i = 0; i < h; i++) {
    int ly = i < (max_h >> ssy) - 1 ? i : (max_h >> ssy) - 1;
    ly <<= ssy;
    for (int j = 0; j < w; j++) {
      int lx = j < (max_w >> ssx) - 1 ? j : (max_w >> ssx) - 1;
      lx <<= ssx;
      const uint16_t *p = luma + ly * luma_stride + lx;
      int v = 0;
      for (int dy = 0; dy <= ssy; dy++)
        for (int dx = 0; dx <= ssx; dx++) v += p[dy * luma_stride + dx];
      L[i][j] = v << shift;
      avg += L[i][j];
    }
  }
  avg = round2(avg, floor_log2((uint32_t)w) + floor_log2((uint32_t)h));
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      int dc = dst[i * stride + j];
      int scaled = round2signed((int64_t)alpha * (L[i][j] - avg), 6);
      dst[i * stride + j] = (uint16_t)clip3(0, (1 << bd) - 1, dc + scaled);
    }
}

void av1_cfl_predict_ss(uint8_t *dst, int stride, const uint8_t *luma,
                        int luma_stride, int w, int h, int max_w, int max_h,
                        int alpha, int ssx, int ssy) {
  uint16_t b[32 * 32], l[64 * 64] = {0};
  /* the luma the block reads */
  const int lw = (w < max_w >> ssx ? w : max_w >> ssx) << ssx;
  const int lh = (h < max_h >> ssy ? h : max_h >> ssy) << ssy;
  widen(dst, stride, b, w, w, h);
  widen(luma, luma_stride, l, lw, lw, lh);
  av1_cfl_predict_ss_hbd(b, w, l, lw, w, h, max_w, max_h, alpha, ssx, ssy, 8);
  narrow(b, w, dst, stride, w, h);
}

/* av1_cfl_predict_ss at 4:2:0. */
void av1_cfl_predict(uint8_t *dst, int stride, const uint8_t *luma,
                     int luma_stride, int w, int h, int max_w, int max_h,
                     int alpha) {
  av1_cfl_predict_ss(dst, stride, luma, luma_stride, w, h, max_w, max_h,
                     alpha, 1, 1);
}

static void predict_cfl(Tile *t, int plane, int sx0, int sy0, int tx) {
  Frame *f = t->f;
  const int ls = f->stride[0];
  const int lx = sx0 << f->ssx, ly = sy0 << f->ssy;
  av1_cfl_predict_ss_hbd(f->frame[plane] + sy0 * f->stride[plane] + sx0,
                         f->stride[plane], f->frame[0] + ly * ls + lx, ls,
                         1 << tx_wlog2[tx], 1 << tx_hlog2[tx],
                         t->max_luma_w - lx, t->max_luma_h - ly,
                         plane == 1 ? t->cfl_u : t->cfl_v, f->ssx, f->ssy, f->bd);
}

/* ------------------------------------------------------- coefficients */

static int tx_class_of(int tx_type) {
  if (tx_type == V_DCT || tx_type == V_ADST || tx_type == V_FLIPADST)
    return TX_CLASS_VERT;
  if (tx_type == H_DCT || tx_type == H_ADST || tx_type == H_FLIPADST)
    return TX_CLASS_HORIZ;
  return TX_CLASS_2D;
}

static int tx_set_type(int tx, int reduced) {
  if (tx_sqr_up[tx] > TX_32X32) return 0;
  if (tx_sqr_up[tx] == TX_32X32) return 0;
  if (reduced) return 2;
  return tx_sqr[tx] == TX_16X16 ? 2 : 3;
}

/* The inter transform sets: EXT_TX_SET_DCTONLY 0, _DCT_IDTX 1,
 * _DTT9_IDTX_1DDCT 4, _ALL16 5. */
static int tx_set_type_inter(int tx, int reduced) {
  if (tx_sqr_up[tx] > TX_32X32) return 0;
  if (tx_sqr_up[tx] == TX_32X32 || reduced) return 1;
  return tx_sqr[tx] == TX_16X16 ? 4 : 5;
}

static int get_dqv(int dq_dc, int dq_ac, int pos, const uint8_t *iqm) {
  int dqv = pos ? dq_ac : dq_dc;
  if (iqm) dqv = (iqm[pos] * dqv + 16) >> 5;
  return dqv;
}

static const int qm_offset[19] = {
    0, 16, 80, 336, 336, 1360, 1392, 1424, 1552, 1680, 2192, 336, 336,
    2704, 2768, 2832, 3088, 1680, 2192};

static int seg_feature(const Frame *f, int segment, int feature) {
  return f->hdr[AV1_SEG_ENABLED] && (f->hdr[AV1_SEG_MASK + segment] >> feature & 1);
}

/* get_qindex(0, segment_id): the block's qindex for dequantisation. */
static int block_qindex(const Tile *t) {
  const Frame *f = t->f;
  if (seg_feature(f, t->segment_id, SEG_LVL_ALT_Q))
    return clip3(0, 255, t->current_q +
                 f->hdr[AV1_SEG_DATA + 8 * t->segment_id + SEG_LVL_ALT_Q]);
  return t->current_q;
}

/* Reads one transform block's coefficients into t->coef (column-major,
 * dequantised); returns the eob. */
static int read_coeffs(Tile *t, int plane, int x4, int y4, int tx,
                       int *tx_type_out) {
  Frame *f = t->f;
  Cdfs *cdf = &t->cdf;
  const int ptype = plane > 0;
  const int lw = tx_wlog2[tx], lh = tx_hlog2[tx];
  const int w4 = 1 << (lw - 2), h4 = 1 << (lh - 2);
  const int cw = lw > 5 ? 32 : 1 << lw, ch = lh > 5 ? 32 : 1 << lh;
  const int bhl = lh > 5 ? 5 : lh;
  const int txs_ctx = (tx_sqr[tx] + tx_sqr_up[tx] + 1) >> 1;
  const int sx = plane ? f->ssx : 0, sy = plane ? f->ssy : 0;
  const int max_x4 = ((f->mi_cols * 4) >> sx) >> 2;
  const int max_y4 = ((f->mi_rows * 4) >> sy) >> 2;
  uint8_t *a = t->above_ctx[plane] + x4;
  uint8_t *l = t->left_ctx[plane] + (y4 & ((f->sb4 >> sy) - 1));
  /* the txb contexts */
  int dc_sign = 0, ctx;
  for (int k = 0; k < w4; k++) {
    int s = a[k] >> 6;
    dc_sign += s == 1 ? -1 : s == 2 ? 1 : 0;
  }
  for (int k = 0; k < h4; k++) {
    int s = l[k] >> 6;
    dc_sign += s == 1 ? -1 : s == 2 ? 1 : 0;
  }
  const int dc_sign_ctx = dc_sign < 0 ? 1 : dc_sign > 0 ? 2 : 0;
  const int pbs = plane ? plane_bsize(t->bsize, f->ssx, f->ssy) : t->bsize;
  if (plane == 0) {
    if (pbs == tx_bsize(tx)) {
      ctx = 0;
    } else {
      static const uint8_t skip_contexts[5][5] = {{1, 2, 2, 2, 3},
                                                  {2, 4, 4, 4, 5},
                                                  {2, 4, 4, 4, 5},
                                                  {2, 4, 4, 4, 5},
                                                  {3, 5, 5, 5, 6}};
      int top = 0, left = 0;
      for (int k = 0; k < w4; k++) top |= a[k];
      top &= 63;
      if (top > 4) top = 4;
      for (int k = 0; k < h4; k++) left |= l[k];
      left &= 63;
      if (left > 4) left = 4;
      ctx = skip_contexts[top][left];
    }
  } else {
    int above = 0, left = 0;
    for (int k = 0; k < w4; k++) above |= a[k];
    for (int k = 0; k < h4; k++) left |= l[k];
    ctx = (above != 0) + (left != 0);
    const int bw = 4 * bw4_of[pbs], bh = 4 * bh4_of[pbs];
    ctx += (bw * bh > (1 << (lw + lh))) ? 10 : 7;
  }
  int all_zero = read_symbol(&t->ec, cdf->txb_skip[txs_ctx][ctx], 2);
  int eob = 0, cul_level = 0, dc_val = 0, tx_type = DCT_DCT;
  if (!all_zero) {
    /* the transform type */
    const int inter = t->use_intrabc;
    if (plane == 0 && inter) {
      const int set = tx_set_type_inter(tx, f->hdr[AV1_REDUCED_TX_SET]);
      if (set > 0 && f->hdr[AV1_SEG_QINDEX + t->segment_id] > 0) {
        const int eset = set == 1 ? 3 : set == 4 ? 2 : 1;
        int sym = read_symbol(&t->ec, cdf->inter_ext_tx[eset][tx_sqr[tx]], num_ext_tx_set[set]);
        tx_type = av1_ext_tx_inv[set][sym];
      }
    } else if (plane == 0) {
      const int set = tx_set_type(tx, f->hdr[AV1_REDUCED_TX_SET]);
      if (set > 0 && f->hdr[AV1_SEG_QINDEX + t->segment_id] > 0) {
        const int eset = set == 3 ? 1 : 2;
        const int mode = t->use_filter_intra ? fimode_to_intradir[t->filter_mode]
                                             : t->y_mode;
        int sym = read_symbol(&t->ec, cdf->intra_ext_tx[eset][tx_sqr[tx]][mode],
                              num_ext_tx_set[set]);
        tx_type = av1_ext_tx_inv[set][sym];
      }
      /* luma tx types are kept for this block only */
    } else {
      const int set = inter ? tx_set_type_inter(tx, f->hdr[AV1_REDUCED_TX_SET])
                            : tx_set_type(tx, f->hdr[AV1_REDUCED_TX_SET]);
      if (inter) /* the co-located luma transform's type */
        tx_type = MI(f, tx_type_mi, t->mi_row + ((y4 - (t->mi_row >> sy)) << sy),
                     t->mi_col + ((x4 - (t->mi_col >> sx)) << sx));
      else
        tx_type = mode_to_txfm[t->uv_mode == UV_CFL_PRED ? DC_PRED : t->uv_mode];
      if (!av1_ext_tx_used[set][tx_type]) tx_type = DCT_DCT;
    }
    if (tx_sqr_up[tx] > TX_32X32 || t->lossless) tx_type = DCT_DCT;
    f->stats[AV1_STAT_TX_TYPE + tx_type]++;
    const int cls = tx_class_of(tx_type);
    const int16_t *scan = av1_scan_data + av1_scan_offset[tx][tx_type];
    const int8_t *nz_off = av1_nz_map_ctx_data + av1_nz_map_ctx_start[tx];
    /* eob */
    static const int lw4[19] = {0, 2, 4, 6, 6, 1, 1, 3, 3, 5, 5, 6, 6,
                                2, 2, 4, 4, 5, 5};
    const int eob_multi_size = lw4[tx], emctx = cls == TX_CLASS_2D ? 0 : 1;
    int eob_pt;
    switch (eob_multi_size) {
      case 0: eob_pt = read_symbol(&t->ec, cdf->eob16[ptype][emctx], 5); break;
      case 1: eob_pt = read_symbol(&t->ec, cdf->eob32[ptype][emctx], 6); break;
      case 2: eob_pt = read_symbol(&t->ec, cdf->eob64[ptype][emctx], 7); break;
      case 3: eob_pt = read_symbol(&t->ec, cdf->eob128[ptype][emctx], 8); break;
      case 4: eob_pt = read_symbol(&t->ec, cdf->eob256[ptype][emctx], 9); break;
      case 5: eob_pt = read_symbol(&t->ec, cdf->eob512[ptype][emctx], 10); break;
      default: eob_pt = read_symbol(&t->ec, cdf->eob1024[ptype][emctx], 11); break;
    }
    eob_pt += 1;
    int eob_extra = 0;
    const int eob_bits = av1_eob_offset_bits[eob_pt];
    if (eob_bits > 0) {
      if (read_symbol(&t->ec, cdf->eob_extra[txs_ctx][ptype][eob_pt - 3], 2))
        eob_extra += 1 << (eob_bits - 1);
      for (int i = 1; i < eob_bits; i++)
        if (read_bit(&t->ec)) eob_extra += 1 << (eob_bits - 1 - i);
    }
    eob = av1_eob_group_start[eob_pt] + eob_extra;
    if (eob > f->stats[AV1_STAT_EOB_MAX]) f->stats[AV1_STAT_EOB_MAX] = eob;
    /* levels, column-major with 4 rows of padding a column */
    uint8_t levels[(32 + 4) * (32 + 4) + 64];
    const int stride = (1 << bhl) + 4;
    memset(levels, 0, sizeof(levels));
    for (int c = eob - 1; c >= 0; c--) {
      const int pos = scan[c];
      const int col = pos >> bhl, row = pos - (col << bhl);
      uint8_t *lv = levels + col * stride + row;
      int level, cctx;
      if (c == eob - 1) {
        cctx = c == 0 ? 0 : c <= (cw << bhl) / 8 ? 1 : c <= (cw << bhl) / 4 ? 2 : 3;
        level = read_symbol(&t->ec, cdf->coeff_base_eob[txs_ctx][ptype][cctx], 3) + 1;
      } else {
        int mag;
        if (cls == TX_CLASS_2D) {
          mag = (lv[stride] < 3 ? lv[stride] : 3) + (lv[1] < 3 ? lv[1] : 3) +
                (lv[stride + 1] < 3 ? lv[stride + 1] : 3) +
                (lv[2 * stride] < 3 ? lv[2 * stride] : 3) +
                (lv[2] < 3 ? lv[2] : 3);
        } else if (cls == TX_CLASS_VERT) {
          mag = 0;
          const int o[5] = {stride, 1, 2, 3, 4};
          for (int k = 0; k < 5; k++) mag += lv[o[k]] < 3 ? lv[o[k]] : 3;
        } else {
          mag = 0;
          const int o[5] = {stride, 1, 2 * stride, 3 * stride, 4 * stride};
          for (int k = 0; k < 5; k++) mag += lv[o[k]] < 3 ? lv[o[k]] : 3;
        }
        int m = (mag + 1) >> 1;
        if (m > 4) m = 4;
        if (cls == TX_CLASS_2D) {
          cctx = pos == 0 ? 0 : m + nz_off[pos];
        } else {
          const int idx = cls == TX_CLASS_VERT ? row : col;
          cctx = m + 26 + (idx == 0 ? 0 : idx == 1 ? 5 : 10);
        }
        level = read_symbol(&t->ec, cdf->coeff_base[txs_ctx][ptype][cctx], 4);
      }
      if (level > 2) {
        int mag = lv[1] + lv[stride], bctx;
        if (cls == TX_CLASS_2D) mag += lv[stride + 1];
        else if (cls == TX_CLASS_HORIZ) mag += lv[2 * stride];
        else mag += lv[2];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (c == eob - 1) mag = 0; /* no neighbour is read yet */
        if (pos == 0) bctx = mag;
        else if ((cls == TX_CLASS_2D && row < 2 && col < 2) ||
                 (cls == TX_CLASS_HORIZ && col == 0) ||
                 (cls == TX_CLASS_VERT && row == 0))
          bctx = mag + 7;
        else
          bctx = mag + 14;
        uint16_t *bcdf = cdf->coeff_br[txs_ctx > 3 ? 3 : txs_ctx][ptype][bctx];
        for (int idx = 0; idx < 12; idx += 3) {
          int k = read_symbol(&t->ec, bcdf, 4);
          level += k;
          if (k < 3) break;
        }
      }
      *lv = (uint8_t)level;
    }
    /* signs, Golomb remainders and dequantisation */
    const int qm_level = f->hdr[AV1_USING_QM] && !t->lossless
        ? f->hdr[plane == 0 ? AV1_QM_Y : plane == 1 ? AV1_QM_U : AV1_QM_V] : 15;
    const uint8_t *iqm = NULL;
    if (qm_level < 15 && tx_type < IDTX)
      iqm = av1_iwt_matrix[qm_level][plane > 0] + qm_offset[tx];
    const int q = block_qindex(t);
    /* Dc_Qlookup and Ac_Qlookup at the stream's depth */
    const int16_t *dcq = f->bd == 8 ? av1_dc_qlookup
                         : f->bd == 10 ? av1_dc_qlookup_10 : av1_dc_qlookup_12;
    const int16_t *acq = f->bd == 8 ? av1_ac_qlookup
                         : f->bd == 10 ? av1_ac_qlookup_10 : av1_ac_qlookup_12;
    int dq_dc, dq_ac;
    if (plane == 0) {
      dq_dc = dcq[clip3(0, 255, q + f->hdr[AV1_DQ_Y_DC])];
      dq_ac = acq[clip3(0, 255, q)];
    } else {
      const int dcd = f->hdr[plane == 1 ? AV1_DQ_U_DC : AV1_DQ_V_DC];
      const int acd = f->hdr[plane == 1 ? AV1_DQ_U_AC : AV1_DQ_V_AC];
      dq_dc = dcq[clip3(0, 255, q + dcd)];
      dq_ac = acq[clip3(0, 255, q + acd)];
    }
    const int coef_max = (1 << (7 + f->bd)) - 1; /* libaom's max_value */
    const int npix = (1 << lw) * (1 << lh);
    const int dq_shift = (npix > 256) + (npix > 1024);
    memset(t->coef, 0, sizeof(int32_t) * (size_t)(cw * ch));
    for (int c = 0; c < eob; c++) {
      const int pos = scan[c];
      const int col = pos >> bhl, row = pos - (col << bhl);
      int level = levels[col * stride + row];
      if (!level) continue;
      int sign;
      if (c == 0) sign = read_symbol(&t->ec, cdf->dc_sign[ptype][dc_sign_ctx], 2);
      else sign = read_bit(&t->ec);
      if (level >= 15) {
        int length = 0, bit = 0, x = 1;
        while (!bit) {
          bit = read_bit(&t->ec);
          if (++length > 20) {
            fail(f, "AV1: a Golomb code longer than 20 bits");
            return 0;
          }
        }
        for (int i = 0; i < length - 1; i++) x = (x << 1) + read_bit(&t->ec);
        level += x - 1;
        f->stats[AV1_STAT_GOLOMB]++;
      }
      if (c == 0) dc_val = sign ? -level : level;
      level &= 0xfffff;
      cul_level += level;
      const int64_t dqv = get_dqv(dq_dc, dq_ac, pos, iqm);
      int32_t dq = (int32_t)((level * dqv) & 0xffffff);
      dq >>= dq_shift;
      if (sign) dq = -dq;
      t->coef[pos] = clip3(-coef_max - 1, coef_max, dq);
    }
    if (cul_level > 63) cul_level = 63;
    if (dc_val < 0) cul_level |= 1 << 6;
    else if (dc_val > 0) cul_level += 2 << 6;
  }
  /* the contexts, 0 past the frame's edge */
  for (int k = 0; k < w4; k++) a[k] = (uint8_t)(x4 + k < max_x4 ? cul_level : 0);
  for (int k = 0; k < h4; k++) l[k] = (uint8_t)(y4 + k < max_y4 ? cul_level : 0);
  if (plane == 0) /* the luma types, for the chroma of intra block copy */
    for (int i = 0; i < h4 && y4 + i < f->mi_rows; i++)
      for (int k = 0; k < w4 && x4 + k < f->mi_cols; k++)
        MI(f, tx_type_mi, y4 + i, x4 + k) = (uint8_t)tx_type;
  *tx_type_out = tx_type;
  return eob;
}

/* ---------------------------------------------------------- mode info */

static void read_cdef(Tile *t) {
  Frame *f = t->f;
  if (t->skip || !f->hdr[AV1_ENABLE_CDEF]) return;
  const int r = t->mi_row >> 4, c = t->mi_col >> 4; /* per 64x64 */
  int8_t *idx = &f->cdef_idx[r * f->cdef_stride + c];
  if (*idx != -1) return;
  *idx = (int8_t)read_literal(&t->ec, f->hdr[AV1_CDEF_BITS]);
  for (int y = r; y < (t->mi_row + bh4_of[t->bsize]) >> 4; y++)
    for (int x = c; x < (t->mi_col + bw4_of[t->bsize]) >> 4; x++)
      f->cdef_idx[y * f->cdef_stride + x] = *idx;
}

static void read_delta_qindex(Tile *t) {
  Frame *f = t->f;
  if (t->bsize == f->sb_size && t->skip) return;
  if (!t->read_deltas) return;
  int abs_v = read_symbol(&t->ec, t->cdf.delta_q, 4);
  if (abs_v == 3) {
    int rem_bits = read_literal(&t->ec, 3) + 1;
    abs_v = read_literal(&t->ec, rem_bits) + (1 << rem_bits) + 1;
  }
  if (abs_v) {
    int sign = read_bit(&t->ec);
    int reduced = sign ? -abs_v : abs_v;
    t->current_q = clip3(1, 255, t->current_q + (reduced << f->hdr[AV1_DELTA_Q_RES]));
    f->stats[AV1_STAT_DELTA_Q]++;
  }
}

static void read_delta_lf(Tile *t) {
  Frame *f = t->f;
  if (t->bsize == f->sb_size && t->skip) return;
  if (!t->read_deltas || !f->hdr[AV1_DELTA_LF_PRESENT]) return;
  const int multi = f->hdr[AV1_DELTA_LF_MULTI];
  const int count = multi ? (f->planes > 1 ? 4 : 2) : 1;
  for (int i = 0; i < count; i++) {
    uint16_t *cdf = multi ? t->cdf.delta_lf_multi[i] : t->cdf.delta_lf;
    int abs_v = read_symbol(&t->ec, cdf, 4);
    if (abs_v == 3) {
      int n = read_literal(&t->ec, 3) + 1;
      abs_v = read_literal(&t->ec, n) + (1 << n) + 1;
    }
    if (abs_v) {
      int sign = read_bit(&t->ec);
      int reduced = sign ? -abs_v : abs_v;
      t->delta_lf[i] = clip3(-63, 63, t->delta_lf[i] + (reduced << f->hdr[AV1_DELTA_LF_RES]));
      f->stats[AV1_STAT_DELTA_LF]++;
    }
  }
}

static int read_angle(Tile *t, int mode) {
  if (t->bsize < BLOCK_8X8 || !is_directional(mode)) return 0;
  int v = read_symbol(&t->ec, t->cdf.angle_delta[mode - V_PRED], 7) - 3;
  t->f->stats[AV1_STAT_ANGLE_DELTA + v + 3]++;
  return v;
}

/* ------------------------------------------------- intra block copy */

enum { REF_CAT_LEVEL = 640, MAX_REF_MV_STACK_SIZE = 8, INTRABC_DELAY_PIXELS = 256 };

typedef struct {
  int n, mv[MAX_REF_MV_STACK_SIZE][2], weight[MAX_REF_MV_STACK_SIZE];
} DvStack;

static void dv_add(const Frame *f, DvStack *st, int r, int c, int weight) {
  const int at = r * f->mi_stride + c;
  if (!f->is_inter[at]) return;
  const int mr = f->mvs[at * 2], mc = f->mvs[at * 2 + 1];
  for (int i = 0; i < st->n; i++)
    if (st->mv[i][0] == mr && st->mv[i][1] == mc) {
      st->weight[i] += weight;
      return;
    }
  if (st->n < MAX_REF_MV_STACK_SIZE) {
    st->mv[st->n][0] = mr;
    st->mv[st->n][1] = mc;
    st->weight[st->n++] = weight;
  }
}

/* libaom's scan_row_mbmi (vertical 0) or scan_col_mbmi (vertical 1). */
static void dv_scan(const Tile *t, DvStack *st, int off, int vertical,
                    int max_off, int *processed) {
  const Frame *f = t->f;
  const int n4 = vertical ? bh4_of[t->bsize] : bw4_of[t->bsize];
  const int pos = vertical ? t->mi_row : t->mi_col;
  int end = (vertical ? f->mi_rows : f->mi_cols) - pos;
  if (end > n4) end = n4;
  if (end > 16) end = 16;
  int step = 0;
  if (abs(off) > 1) step = (pos & 1) && n4 < 2 ? 0 : 1;
  for (int i = 0; i < end;) {
    const int rr = vertical ? t->mi_row + step + i : t->mi_row + off;
    const int cc = vertical ? t->mi_col + off : t->mi_col + step + i;
    const int cb = MI(f, mi_size, rr, cc);
    const int along = vertical ? bh4_of[cb] : bw4_of[cb];
    const int across = vertical ? bw4_of[cb] : bh4_of[cb];
    int n = n4 < along ? n4 : along;
    if (n4 >= 16) n = n > 4 ? n : 4;
    else if (abs(off) > 1) n = n > 2 ? n : 2;
    int weight = 2;
    if (n4 >= 2 && n4 <= along) {
      int inc = -max_off + off + 1;
      if (inc > across) inc = across;
      if (inc > weight) weight = inc;
      *processed = inc - off - 1;
    }
    dv_add(f, st, rr, cc, n * weight);
    i += n;
  }
}

/* libaom's setup_ref_mv_list for INTRA_FRAME: the DVs of the intra block
 * copy neighbours, weighted, sorted and clamped into out (n of them). */
static int dv_stack(const Tile *t, int out[][2]) {
  const Frame *f = t->f;
  const int r = t->mi_row, c = t->mi_col;
  const int bw4 = bw4_of[t->bsize], bh4 = bh4_of[t->bsize];
  DvStack st = {0, {{0}}, {0}};
  int processed[2] = {0, 0};
  const int row_adj = bh4 < 2 && (r & 1), col_adj = bw4 < 2 && (c & 1);
  int max_row = 0, max_col = 0;
  if (t->avail_u)
    max_row = clip3(t->mi_row_start - r, t->mi_row_end - r - 1,
                    (bh4 < 2 ? -4 : -6) + row_adj);
  if (t->avail_l)
    max_col = clip3(t->mi_col_start - c, t->mi_col_end - c - 1,
                    (bw4 < 2 ? -4 : -6) + col_adj);
  if (abs(max_row) >= 1) dv_scan(t, &st, -1, 0, max_row, &processed[0]);
  if (abs(max_col) >= 1) dv_scan(t, &st, -1, 1, max_col, &processed[1]);
  if ((bw4 > bh4 ? bw4 : bh4) <= 16 && is_inside(t, r - 1, c + bw4) &&
      f->written[(r - 1) * f->mi_stride + c + bw4])
    dv_add(f, &st, r - 1, c + bw4, 4);
  const int nearest = st.n;
  for (int i = 0; i < nearest; i++) st.weight[i] += REF_CAT_LEVEL;
  if (is_inside(t, r - 1, c - 1)) dv_add(f, &st, r - 1, c - 1, 4);
  for (int idx = 2; idx <= 3; idx++) {
    const int row_off = -(idx << 1) + 1 + row_adj;
    const int col_off = -(idx << 1) + 1 + col_adj;
    if (abs(row_off) <= abs(max_row) && abs(row_off) > processed[0])
      dv_scan(t, &st, row_off, 0, max_row, &processed[0]);
    if (abs(col_off) <= abs(max_col) && abs(col_off) > processed[1])
      dv_scan(t, &st, col_off, 1, max_col, &processed[1]);
  }
  const int bounds[2][2] = {{0, nearest}, {nearest, st.n}};
  for (int g = 0; g < 2; g++) { /* libaom's bubble sorts */
    const int lo = bounds[g][0];
    int len = bounds[g][1];
    while (len > lo) {
      int last = lo;
      for (int i = lo + 1; i < len; i++)
        if (st.weight[i - 1] < st.weight[i]) {
          for (int k = 0; k < 2; k++) {
            const int m = st.mv[i - 1][k];
            st.mv[i - 1][k] = st.mv[i][k];
            st.mv[i][k] = m;
          }
          const int w = st.weight[i - 1];
          st.weight[i - 1] = st.weight[i];
          st.weight[i] = w;
          last = i;
        }
      len = last;
    }
  }
  for (int i = 0; i < st.n; i++) { /* clamp_mv_ref */
    const int bw = 4 * bw4, bh = 4 * bh4;
    out[i][1] = clip3(-(c * 32) - bw * 8 - 128, (f->mi_cols - bw4 - c) * 32 + bw * 8 + 128,
                      st.mv[i][1]);
    out[i][0] = clip3(-(r * 32) - bh * 8 - 128, (f->mi_rows - bh4 - r) * 32 + bh * 8 + 128,
                      st.mv[i][0]);
  }
  return st.n;
}

/* read_mv_component at integer precision (MV_SUBPEL_NONE). */
static int read_mv_component(Tile *t, int comp) {
  uint16_t *c = t->cdf.dv + DV_COMP + DV_COMP_SIZE * comp;
  const int sign = read_symbol(&t->ec, c + DV_SIGN, 2);
  const int cls = read_symbol(&t->ec, c + DV_CLASSES, 11);
  int d = 0, mag = 0;
  if (cls == 0) {
    d = read_symbol(&t->ec, c + DV_CLASS0, 2);
  } else {
    for (int i = 0; i < cls; i++) d |= read_symbol(&t->ec, c + DV_BITS + 3 * i, 2) << i;
    mag = 2 << (cls + 2);
  }
  mag += (d << 3) + 8;
  return sign ? -mag : mag;
}

/* libaom's is_mv_valid and av1_is_dv_valid: a DV (1/8 sample) of the
 * bw4 x bh4 block at (mi_row, mi_col) is valid when its source lies in the
 * tile, whole, in a superblock decoded at least INTRABC_DELAY_PIXELS (four
 * 64-wide superblocks) before the block's own and above its wavefront. */
int av1_dv_valid(int dv_row, int dv_col, int mi_row, int mi_col, int bw4,
                 int bh4, int sb4, int row_start, int row_end, int col_start,
                 int col_end, int ssx, int ssy, int has_chroma) {
  const int mv_max = 1 << 14;
  if (dv_row <= -mv_max || dv_row >= mv_max || dv_col <= -mv_max ||
      dv_col >= mv_max || (dv_row & 7) || (dv_col & 7))
    return 0;
  const int top = mi_row * 32 + dv_row, left = mi_col * 32 + dv_col;
  const int bottom = (mi_row + bh4) * 32 + dv_row;
  const int right = (mi_col + bw4) * 32 + dv_col;
  if (top < row_start * 32 || left < col_start * 32 || bottom > row_end * 32 ||
      right > col_end * 32)
    return 0;
  if (has_chroma && ((bw4 == 1 && ssx && left < (col_start + 1) * 32) ||
                     (bh4 == 1 && ssy && top < (row_start + 1) * 32)))
    return 0;
  const int delay = INTRABC_DELAY_PIXELS / 64, sb_size = 4 * sb4;
  const int active_row = mi_row / sb4, active_col = (mi_col * 4) >> 6;
  const int src_row = ((bottom >> 3) - 1) / sb_size;
  const int src_col = ((right >> 3) - 1) >> 6;
  const int per_row = ((col_end - col_start - 1) >> 4) + 1;
  if (src_row * per_row + src_col >= active_row * per_row + active_col - delay)
    return 0;
  const int gradient = 1 + delay + (sb_size > 64);
  return src_row <= active_row &&
         src_col < active_col - delay + gradient * (active_row - src_row);
}

/* The block's DV (1/8 sample, whole samples): the first non-zero of the
 * stack's two first entries, or the default one, plus the coded
 * difference. */
static void read_dv(Tile *t) {
  Frame *f = t->f;
  int stack[MAX_REF_MV_STACK_SIZE + 2][2] = {{0}};
  dv_stack(t, stack);
  int ref[2] = {stack[0][0], stack[0][1]};
  if (!ref[0] && !ref[1]) {
    ref[0] = stack[1][0];
    ref[1] = stack[1][1];
  }
  if (!ref[0] && !ref[1]) {
    if (t->mi_row - f->sb4 < t->mi_row_start) {
      ref[0] = 0;
      ref[1] = -(4 * f->sb4 + INTRABC_DELAY_PIXELS) * 8;
    } else {
      ref[0] = -(4 * f->sb4) * 8;
      ref[1] = 0;
    }
  }
  ref[0] = (ref[0] >> 3) * 8;
  ref[1] = (ref[1] >> 3) * 8;
  const int joint = read_symbol(&t->ec, t->cdf.dv, 4);
  const int dr = (joint == 2 || joint == 3) ? read_mv_component(t, 0) : 0;
  const int dc = (joint == 1 || joint == 3) ? read_mv_component(t, 1) : 0;
  t->mv[0] = ((ref[0] + dr) >> 3) * 8;
  t->mv[1] = ((ref[1] + dc) >> 3) * 8;
  if (!av1_dv_valid(t->mv[0], t->mv[1], t->mi_row, t->mi_col,
                    bw4_of[t->bsize], bh4_of[t->bsize], f->sb4,
                    t->mi_row_start, t->mi_row_end, t->mi_col_start,
                    t->mi_col_end, f->ssx, f->ssy, t->has_chroma))
    fail(f, "AV1: an intra block copy DV points outside the area libaom "
            "allows (libaom reports a corrupt frame)");
}

/* The intra block copy prediction of a w x h block from src (one more row
 * or column read when fy or fx, the half-sample parts, are 8): the
 * BILINEAR filter at half a sample, as libaom's
 * av1_convolve_{2d,x,y}_sr_intrabc_c rounds it. */
void av1_intrabc_predict_hbd(const uint16_t *src, int stride, int w, int h,
                             int fy, int fx, uint16_t *dst, int dst_stride) {
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      const uint16_t *p = src + i * stride + j;
      int v;
      if (fx && fy) v = (p[0] + p[1] + p[stride] + p[stride + 1] + 2) >> 2;
      else if (fx) v = (p[0] + p[1] + 1) >> 1;
      else if (fy) v = (p[0] + p[stride] + 1) >> 1;
      else v = p[0];
      dst[i * dst_stride + j] = (uint16_t)v;
    }
}

void av1_intrabc_predict(const uint8_t *src, int stride, int w, int h, int fy,
                         int fx, uint8_t *dst, int dst_stride) {
  uint16_t s[129 * 129], d[128 * 128];
  const int sw = w + (fx > 0), sh = h + (fy > 0);
  widen(src, stride, s, sw, sw, sh);
  av1_intrabc_predict_hbd(s, sw, w, h, fy, fx, d, w);
  narrow(d, w, dst, dst_stride, w, h);
}

/* Each plane of the block copied from the frame so far. */
static int predict_intrabc(Tile *t) {
  Frame *f = t->f;
  const int bw = 4 * bw4_of[t->bsize], bh = 4 * bh4_of[t->bsize];
  for (int plane = 0; plane < 1 + 2 * t->has_chroma; plane++) {
    const int sx = plane ? f->ssx : 0, sy = plane ? f->ssy : 0;
    const int x0 = (t->mi_col * 4 - (bw == 4 && sx ? 4 : 0)) >> sx;
    const int y0 = (t->mi_row * 4 - (bh == 4 && sy ? 4 : 0)) >> sy;
    const int w = bw >> sx > 4 ? bw >> sx : 4, h = bh >> sy > 4 ? bh >> sy : 4;
    const int qr = t->mv[0] * (1 << (1 - sy)), qc = t->mv[1] * (1 << (1 - sx));
    const int fy = qr & 15, fx = qc & 15;
    const int ys = y0 + (qr >> 4), xs = x0 + (qc >> 4);
    const int stride = f->stride[plane];
    if (ys < 0 || xs < 0 || ys + h + (fy > 0) > f->alloc_h[plane] ||
        xs + w + (fx > 0) > stride) {
      fail(f, "AV1: an intra block copy DV points outside the frame (libaom "
              "reports a corrupt frame)");
      return 1;
    }
    if (fy || fx) f->stats[AV1_STAT_INTRABC_HALFPEL]++;
    /* av1_dv_valid put the source in decoded superblocks: no overlap */
    av1_intrabc_predict_hbd(f->frame[plane] + ys * stride + xs, stride, w, h, fy,
                            fx, f->frame[plane] + y0 * stride + x0, stride);
  }
  return 0;
}

/* libaom's txfm_partition_context. */
static int txfm_partition_ctx(int above, int left, int bsize, int tx) {
  if (tx == TX_4X4) return 0;
  const int w4 = bw4_of[bsize], h4 = bh4_of[bsize];
  const int dim = 4 * (w4 > h4 ? w4 : h4);
  const int max_tx = dim >= 64 ? TX_64X64 : dim == 32 ? TX_32X32 : dim == 16 ? TX_16X16 : TX_8X8;
  const int cat = (tx_sqr_up[tx] != max_tx && max_tx > TX_8X8) + (4 - max_tx) * 2;
  return cat * 3 + (above < (1 << tx_wlog2[tx])) + (left < (1 << tx_hlog2[tx]));
}

/* The transform-size contexts (sample widths above, heights left) over
 * w4 x h4 4x4 units at (row, col) of the block. */
static void set_txfm_ctx(Tile *t, int row, int col, int w4, int h4, int tw, int th) {
  const int m = t->f->sb4 - 1;
  for (int i = 0; i < w4; i++) t->above_txfm[t->mi_col + col + i] = (uint8_t)tw;
  for (int i = 0; i < h4; i++) t->left_txfm[(t->mi_row + row + i) & m] = (uint8_t)th;
}

/* read_tx_size_vartx: the transform tree of an intra block copy block,
 * into t->inter_tx (per 4x4 unit of the block, 32 a row). */
static void read_var_tx(Tile *t, int tx, int depth, int row, int col) {
  Frame *f = t->f;
  const int max_h = bh4_of[t->bsize] < f->mi_rows - t->mi_row ? bh4_of[t->bsize] : f->mi_rows - t->mi_row;
  const int max_w = bw4_of[t->bsize] < f->mi_cols - t->mi_col ? bw4_of[t->bsize] : f->mi_cols - t->mi_col;
  if (row >= max_h || col >= max_w) return;
  const int w4 = 1 << (tx_wlog2[tx] - 2), h4 = 1 << (tx_hlog2[tx] - 2);
  int leaf = tx;
  if (depth < 2) {
    const int ctx = txfm_partition_ctx(t->above_txfm[t->mi_col + col],
                                       t->left_txfm[(t->mi_row + row) & (f->sb4 - 1)],
                                       t->bsize, tx);
    if (read_symbol(&t->ec, t->cdf.txfm_partition[ctx], 2)) {
      const int sub = split_tx[tx];
      f->stats[AV1_STAT_VARTX]++;
      if (sub != TX_4X4) {
        const int sw = 1 << (tx_wlog2[sub] - 2), sh = 1 << (tx_hlog2[sub] - 2);
        for (int rr = 0; rr < h4; rr += sh)
          for (int cc = 0; cc < w4; cc += sw) read_var_tx(t, sub, depth + 1, row + rr, col + cc);
        return;
      }
      leaf = TX_4X4;
    }
  }
  for (int i = 0; i < h4 && row + i < 32; i++)
    for (int j = 0; j < w4 && col + j < 32; j++) t->inter_tx[(row + i) * 32 + col + j] = (uint8_t)leaf;
  t->tx_size = leaf;
  set_txfm_ctx(t, row, col, w4, h4, 1 << tx_wlog2[leaf], 1 << tx_hlog2[leaf]);
}

/* ------------------------------------------------------------ palette */

static int ceil_log2(int n) { return n < 2 ? 0 : ilog_nz((uint32_t)(n - 1)); }

/* libaom's av1_get_palette_cache: the above neighbour's colours (within
 * this 64-row superblock row) and the left one's, merged, sorted, each
 * once. */
static int palette_cache(const Tile *t, int plane, int *cache) {
  const Frame *f = t->f;
  const int p = plane > 0, r = t->mi_row, c = t->mi_col;
  int a[8], l[8], na = 0, nl = 0, n = 0;
  if (t->avail_u && (r & 15)) {
    const int at = (r - 1) * f->mi_stride + c;
    na = f->pal_size[at * 2 + p];
    for (int i = 0; i < na; i++) a[i] = f->pal_colors[at * 24 + plane * 8 + i];
  }
  if (t->avail_l) {
    const int at = r * f->mi_stride + c - 1;
    nl = f->pal_size[at * 2 + p];
    for (int i = 0; i < nl; i++) l[i] = f->pal_colors[at * 24 + plane * 8 + i];
  }
  int ia = 0, il = 0;
  while (ia < na && il < nl) {
    const int va = a[ia], vl = l[il];
    if (vl < va) {
      if (n == 0 || vl != cache[n - 1]) cache[n++] = vl;
      il++;
    } else {
      if (n == 0 || va != cache[n - 1]) cache[n++] = va;
      ia++;
      if (vl == va) il++;
    }
  }
  for (; ia < na; ia++)
    if (n == 0 || a[ia] != cache[n - 1]) cache[n++] = a[ia];
  for (; il < nl; il++)
    if (n == 0 || l[il] != cache[n - 1]) cache[n++] = l[il];
  return n;
}

/* The Y (plane 0) or U colours of an n-colour palette: those taken from
 * the cache, then a literal of bd bits and deltas of bd - 3 bits or more
 * (at least 1 apart for Y), sorted. */
static void palette_colours(Tile *t, int plane, int n, uint16_t *out) {
  const int bd = t->f->bd;
  int cache[16], colours[8], k = 0;
  const int n_cache = palette_cache(t, plane, cache);
  for (int i = 0; i < n_cache && k < n; i++)
    if (read_bit(&t->ec)) colours[k++] = cache[i];
  t->f->stats[AV1_STAT_PALETTE_CACHE] += k;
  if (k < n) {
    colours[k] = read_literal(&t->ec, bd);
    k++;
    if (k < n) {
      const int step = plane == 0;
      int bits = bd - 3 + read_literal(&t->ec, 2);
      int room = (1 << bd) - colours[k - 1] - step;
      for (; k < n; k++) {
        int v = colours[k - 1] + read_literal(&t->ec, bits) + step;
        if (v > (1 << bd) - 1) v = (1 << bd) - 1;
        room -= v - colours[k - 1];
        colours[k] = v;
        const int cl = ceil_log2(room);
        if (cl < bits) bits = cl;
      }
    }
  }
  for (int i = 1; i < n; i++) /* insertion sort */
    for (int j = i; j > 0 && colours[j - 1] > colours[j]; j--) {
      const int x = colours[j];
      colours[j] = colours[j - 1];
      colours[j - 1] = x;
    }
  for (int i = 0; i < n; i++) out[i] = (uint16_t)colours[i];
}

static void palette_mode_info(Tile *t) {
  Frame *f = t->f;
  Cdfs *cdf = &t->cdf;
  const int r = t->mi_row, c = t->mi_col;
  const int bctx = mi_wlog2[t->bsize] + mi_hlog2[t->bsize] - 2;
  if (t->y_mode == DC_PRED) {
    const int ctx =
        (t->avail_u && f->pal_size[((r - 1) * f->mi_stride + c) * 2] > 0) +
        (t->avail_l && f->pal_size[(r * f->mi_stride + c - 1) * 2] > 0);
    if (read_symbol(&t->ec, cdf->palette_y_mode[bctx][ctx], 2)) {
      const int n = read_symbol(&t->ec, cdf->palette_y_size[bctx], 7) + 2;
      t->pal_size[0] = n;
      palette_colours(t, 0, n, t->pal_colors[0]);
      f->stats[AV1_STAT_PALETTE_Y]++;
    }
  }
  if (t->has_chroma && t->uv_mode == DC_PRED &&
      read_symbol(&t->ec, cdf->palette_uv_mode[t->pal_size[0] > 0], 2)) {
    const int n = read_symbol(&t->ec, cdf->palette_uv_size[bctx], 7) + 2;
    t->pal_size[1] = n;
    palette_colours(t, 1, n, t->pal_colors[1]);
    f->stats[AV1_STAT_PALETTE_UV]++;
    const int bd = f->bd;
    if (read_bit(&t->ec)) { /* V by deltas, modulo 2^bd */
      const int bits = bd - 4 + read_literal(&t->ec, 2);
      int v = read_literal(&t->ec, bd);
      t->pal_colors[2][0] = (uint16_t)v;
      for (int i = 1; i < n; i++) {
        int d = read_literal(&t->ec, bits);
        if (d && read_bit(&t->ec)) d = -d;
        v = (v + d + (1 << bd)) & ((1 << bd) - 1);
        t->pal_colors[2][i] = (uint16_t)v;
      }
      f->stats[AV1_STAT_PALETTE_DELTA_V]++;
    } else {
      for (int i = 0; i < n; i++) t->pal_colors[2][i] = (uint16_t)read_literal(&t->ec, bd);
    }
  }
}

/* libaom's av1_get_palette_color_index_context: the context of entry
 * (r, c) of a colour-index map (stride w) from its left, top-left and top
 * neighbours, and the colour order (8 entries) it implies. */
int av1_palette_color_context(const uint8_t *map, int w, int r, int c, int n,
                              uint8_t *order) {
  int scores[8] = {0};
  if (c > 0) scores[map[r * w + c - 1]] += 2;
  if (c > 0 && r > 0) scores[map[(r - 1) * w + c - 1]] += 1;
  if (r > 0) scores[map[(r - 1) * w + c]] += 2;
  for (int i = 0; i < 8; i++) order[i] = (uint8_t)i;
  for (int i = 0; i < 3; i++) {
    int best = scores[i], best_i = i;
    for (int j = i + 1; j < n; j++)
      if (scores[j] > best) {
        best = scores[j];
        best_i = j;
      }
    if (best_i != i) {
      const int sc = scores[best_i];
      const uint8_t o = order[best_i];
      for (int k = best_i; k > i; k--) {
        scores[k] = scores[k - 1];
        order[k] = order[k - 1];
      }
      scores[i] = sc;
      order[i] = o;
    }
  }
  return av1_palette_color_index_context_lookup[scores[0] + 2 * scores[1] +
                                                 2 * scores[2]];
}

/* palette_tokens: the colour-index maps in wavefront order. */
static void palette_tokens(Tile *t) {
  Frame *f = t->f;
  const int bw = 4 * bw4_of[t->bsize], bh = 4 * bh4_of[t->bsize];
  const int on_w0 = bw < (f->mi_cols - t->mi_col) * 4 ? bw : (f->mi_cols - t->mi_col) * 4;
  const int on_h0 = bh < (f->mi_rows - t->mi_row) * 4 ? bh : (f->mi_rows - t->mi_row) * 4;
  for (int p = 0; p < 2; p++) {
    const int n = t->pal_size[p];
    if (!n) continue;
    int w = bw, h = bh, ow = on_w0, oh = on_h0;
    if (p) {
      w >>= f->ssx;
      h >>= f->ssy;
      ow >>= f->ssx;
      oh >>= f->ssy;
      if (w < 4) { w += 2; ow += 2; }
      if (h < 4) { h += 2; oh += 2; }
    }
    uint8_t *m = t->color_map[p];
    t->color_map_w[p] = w;
    uint16_t (*cdf)[9] = p ? t->cdf.palette_uv_color[n - 2] : t->cdf.palette_y_color[n - 2];
    uint8_t order[8];
    m[0] = (uint8_t)read_uniform(&t->ec, n);
    for (int i = 1; i < oh + ow - 1; i++) {
      const int j0 = i < ow - 1 ? i : ow - 1, j1 = i - oh + 1 > 0 ? i - oh + 1 : 0;
      for (int j = j0; j >= j1; j--) {
        const int ctx = av1_palette_color_context(m, w, i - j, j, n, order);
        m[(i - j) * w + j] = order[read_symbol(&t->ec, cdf[ctx], n)];
      }
    }
    for (int i = 0; i < oh; i++)
      memset(m + i * w + ow, m[i * w + ow - 1], (size_t)(w - ow));
    for (int i = oh; i < h; i++) memcpy(m + i * w, m + (oh - 1) * w, (size_t)w);
  }
}

/* libaom's av1_neg_deinterleave */
static int neg_deinterleave(int diff, int ref, int max) {
  if (!ref) return diff;
  if (ref >= max - 1) return max - diff - 1;
  if (2 * ref < max) {
    if (diff <= 2 * ref) return diff & 1 ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
    return diff;
  }
  if (diff <= 2 * (max - ref - 1))
    return diff & 1 ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
  return max - (diff + 1);
}

/* read_segment_id of an intra frame: the id predicted from the above,
 * left and above-left ids (av1_get_spatial_seg_pred), taken as is by a
 * skipped block, else coded relative to it. */
static void read_segment_id(Tile *t, int skip) {
  Frame *f = t->f;
  const int r = t->mi_row, c = t->mi_col;
  const int ul = t->avail_u && t->avail_l ? MI(f, seg_map, r - 1, c - 1) : -1;
  const int u = t->avail_u ? MI(f, seg_map, r - 1, c) : -1;
  const int l = t->avail_l ? MI(f, seg_map, r, c - 1) : -1;
  const int ctx = ul < 0 ? 0 : ul == u && ul == l ? 2
                  : ul == u || ul == l || u == l ? 1 : 0;
  const int pred = u == -1 ? (l == -1 ? 0 : l) : l == -1 ? u : ul == u ? u : l;
  if (skip) {
    t->segment_id = pred;
    f->stats[AV1_STAT_SEG_PREDICTED]++;
    return;
  }
  const int last = f->hdr[AV1_SEG_LAST_ACTIVE];
  const int coded = read_symbol(&t->ec, t->cdf.spatial_seg[ctx], 8);
  t->segment_id = neg_deinterleave(coded, pred, last + 1);
  if (t->segment_id < 0 || t->segment_id > last)
    fail(f, "AV1: a segment id past the last active segment (libaom "
            "reports a corrupt frame)");
}

static void intra_frame_mode_info(Tile *t) {
  Frame *f = t->f;
  Cdfs *cdf = &t->cdf;
  const int seg = f->hdr[AV1_SEG_ENABLED], preskip = f->hdr[AV1_SEG_PRESKIP];
  t->segment_id = 0;
  if (seg && preskip) read_segment_id(t, 0);
  if (f->failed) return;
  if (seg_feature(f, t->segment_id, SEG_LVL_SKIP)) {
    t->skip = 1;
  } else {
    int ctx = (t->avail_u ? MI(f, skip, t->mi_row - 1, t->mi_col) : 0) +
              (t->avail_l ? MI(f, skip, t->mi_row, t->mi_col - 1) : 0);
    t->skip = read_symbol(&t->ec, cdf->skip[ctx], 2);
  }
  if (seg && !preskip) read_segment_id(t, t->skip);
  if (f->failed) return;
  t->lossless = f->hdr[AV1_SEG_LOSSLESS + t->segment_id];
  read_cdef(t);
  read_delta_qindex(t);
  read_delta_lf(t);
  t->read_deltas = 0;
  t->pal_size[0] = t->pal_size[1] = 0;
  memset(t->pal_colors, 0, sizeof(t->pal_colors));
  t->use_filter_intra = 0;
  t->use_intrabc = f->hdr[AV1_ALLOW_INTRABC] ? read_symbol(&t->ec, cdf->intrabc, 2) : 0;
  if (t->use_intrabc) {
    t->y_mode = t->uv_mode = DC_PRED;
    t->angle_y = t->angle_uv = t->cfl_u = t->cfl_v = 0;
    read_dv(t);
    f->stats[AV1_STAT_INTRABC_BLOCKS]++;
    return;
  }
  int above = t->avail_u ? MI(f, y_mode, t->mi_row - 1, t->mi_col) : DC_PRED;
  int left = t->avail_l ? MI(f, y_mode, t->mi_row, t->mi_col - 1) : DC_PRED;
  t->y_mode = read_symbol(&t->ec, cdf->kf_y[intra_mode_ctx[above]][intra_mode_ctx[left]], 13);
  t->angle_y = read_angle(t, t->y_mode);
  t->uv_mode = DC_PRED;
  t->angle_uv = 0;
  t->cfl_u = t->cfl_v = 0;
  if (t->has_chroma) {
    const int bw = 4 * bw4_of[t->bsize], bh = 4 * bh4_of[t->bsize];
    /* libaom's is_cfl_allowed */
    const int cfl_allowed = t->lossless
        ? plane_bsize(t->bsize, f->ssx, f->ssy) == BLOCK_4X4
        : (bw > bh ? bw : bh) <= 32;
    t->uv_mode = read_symbol(&t->ec, cdf->uv[cfl_allowed][t->y_mode], 13 + cfl_allowed);
    if (t->uv_mode == UV_CFL_PRED) {
      int signs = read_symbol(&t->ec, cdf->cfl_sign, 8);
      int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
      if (sign_u) {
        int a = 1 + read_symbol(&t->ec, cdf->cfl_alpha[(sign_u - 1) * 3 + sign_v], 16);
        t->cfl_u = sign_u == 1 ? -a : a;
      }
      if (sign_v) {
        int a = 1 + read_symbol(&t->ec, cdf->cfl_alpha[(sign_v - 1) * 3 + sign_u], 16);
        t->cfl_v = sign_v == 1 ? -a : a;
      }
    } else {
      t->angle_uv = read_angle(t, t->uv_mode);
    }
  }
  if (t->bsize >= BLOCK_8X8 && 4 * bw4_of[t->bsize] <= 64 &&
      4 * bh4_of[t->bsize] <= 64 && f->hdr[AV1_SCREEN_CONTENT])
    palette_mode_info(t);
  if (f->hdr[AV1_ENABLE_FILTER_INTRA] && t->y_mode == DC_PRED && !t->pal_size[0]) {
    const int bw = 4 * bw4_of[t->bsize], bh = 4 * bh4_of[t->bsize];
    if ((bw > bh ? bw : bh) <= 32) {
      t->use_filter_intra = read_symbol(&t->ec, cdf->filter_intra[t->bsize], 2);
      if (t->use_filter_intra) {
        t->filter_mode = read_symbol(&t->ec, cdf->filter_intra_mode, 5);
        f->stats[AV1_STAT_FILTER_INTRA + t->filter_mode]++;
      }
    }
  }
}

/* The transform-size context's neighbour size (width above, height
 * left): an intra block copy neighbour's block size, else its transform
 * size. */
static int neighbour_tx_side(const Tile *t, int r, int c, int wide) {
  const Frame *f = t->f;
  const int at = r * f->mi_stride + c;
  if (f->is_inter[at]) {
    const int b = f->mi_size[at];
    return 4 * (wide ? bw4_of[b] : bh4_of[b]);
  }
  return 1 << (wide ? tx_wlog2 : tx_hlog2)[f->tx_size_mi[at]];
}

static void read_tx_size(Tile *t) {
  Frame *f = t->f;
  const int max_rect = av1_max_txsize_rect_lookup[t->bsize];
  const int bw4 = bw4_of[t->bsize], bh4 = bh4_of[t->bsize];
  t->tx_size = t->lossless ? TX_4X4 : max_rect;
  if (t->use_intrabc) {
    memset(t->inter_tx, t->tx_size, sizeof(t->inter_tx));
    if (f->hdr[AV1_TX_MODE_SELECT] && t->bsize > BLOCK_4X4 && !t->skip && !t->lossless) {
      for (int row = 0; row < bh4; row += 1 << (tx_hlog2[max_rect] - 2))
        for (int col = 0; col < bw4; col += 1 << (tx_wlog2[max_rect] - 2))
          read_var_tx(t, max_rect, 0, row, col);
      return;
    }
  } else if (t->bsize > BLOCK_4X4 && f->hdr[AV1_TX_MODE_SELECT] && !t->lossless) {
    const int max_w = 1 << tx_wlog2[max_rect], max_h = 1 << tx_hlog2[max_rect];
    int aw = t->avail_u ? neighbour_tx_side(t, t->mi_row - 1, t->mi_col, 1) : 0;
    int lh = t->avail_l ? neighbour_tx_side(t, t->mi_row, t->mi_col - 1, 0) : 0;
    const int ctx = (aw >= max_w) + (lh >= max_h);
    const int cat = max_tx_depth[t->bsize] - 1;
    const int nsym = max_tx_depth[t->bsize] > 1 ? 3 : 2;
    int depth = read_symbol(&t->ec, t->cdf.tx_size[cat][ctx], nsym);
    f->stats[AV1_STAT_TX_DEPTH] += depth > 0;
    for (int i = 0; i < depth; i++) t->tx_size = split_tx[t->tx_size];
  }
  if (t->use_intrabc && t->skip) /* set_txfm_ctxs: the block's size */
    set_txfm_ctx(t, 0, 0, bw4, bh4, 4 * bw4, 4 * bh4);
  else
    set_txfm_ctx(t, 0, 0, bw4, bh4, 1 << tx_wlog2[t->tx_size], 1 << tx_hlog2[t->tx_size]);
}

/* ------------------------------------------------------ reconstruction */

static int uv_tx_size(int bsize, int ssx, int ssy) {
  const int uvtx = av1_max_txsize_rect_lookup[plane_bsize(bsize, ssx, ssy)];
  const int w = 1 << tx_wlog2[uvtx], h = 1 << tx_hlog2[uvtx];
  if (w == 64 || h == 64) {
    if (w == 16) return TX_16X32;
    if (h == 16) return TX_32X16;
    return TX_32X32;
  }
  return uvtx;
}

static void transform_block(Tile *t, int plane, int base_x, int base_y,
                            int tx, int x, int y) {
  Frame *f = t->f;
  const int sx = plane ? f->ssx : 0, sy = plane ? f->ssy : 0;
  const int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
  const int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
  const int sb_row = row & (f->sb4 - 1), sb_col = col & (f->sb4 - 1);
  const int step_x = 1 << (tx_wlog2[tx] - 2), step_y = 1 << (tx_hlog2[tx] - 2);
  const int max_x = (f->mi_cols * 4) >> sx, max_y = (f->mi_rows * 4) >> sy;
  if (start_x >= max_x || start_y >= max_y) return;
  const int is_cfl = plane > 0 && t->uv_mode == UV_CFL_PRED;
  const int mode = plane == 0 ? t->y_mode : is_cfl ? DC_PRED : t->uv_mode;
  const int dr = (sb_row >> sy), dc = (sb_col >> sx);
  if (t->use_intrabc) {
    /* predicted for the whole block */
  } else if (t->pal_size[plane > 0]) {
    const int p = plane > 0, mw = t->color_map_w[p];
    const uint8_t *m = t->color_map[p] + 4 * y * mw + 4 * x;
    uint16_t *dst = f->frame[plane] + start_y * f->stride[plane] + start_x;
    for (int i = 0; i < 4 * step_y; i++)
      for (int j = 0; j < 4 * step_x; j++)
        dst[i * f->stride[plane] + j] = t->pal_colors[plane][m[i * mw + j]];
  } else {
    predict_intra(t, plane, start_x, start_y,
                  (plane == 0 ? t->avail_l : t->avail_l_chroma) || x > 0,
                  (plane == 0 ? t->avail_u : t->avail_u_chroma) || y > 0,
                  t->decoded[plane][dr - 1 + 1][dc + step_x + 1],
                  t->decoded[plane][dr + step_y + 1][dc - 1 + 1],
                  mode, tx_wlog2[tx], tx_hlog2[tx]);
  }
  if (is_cfl) predict_cfl(t, plane, start_x, start_y, tx);
  if (plane == 0 && !t->use_intrabc) {
    t->max_luma_w = start_x + step_x * 4;
    t->max_luma_h = start_y + step_y * 4;
  }
  if (!t->skip) {
    int tx_type;
    int eob = read_coeffs(t, plane, start_x >> 2, start_y >> 2, tx, &tx_type);
    if (f->failed) return;
    uint16_t *dst = f->frame[plane] + start_y * f->stride[plane] + start_x;
    if (eob > 0 && t->lossless)
      av1_iwht4x4_add_hbd(t->coef, dst, f->stride[plane], f->bd);
    else if (eob > 0)
      av1_inverse_transform_add_hbd(t->coef, tx, tx_type, dst, f->stride[plane],
                                    f->bd);
  }
  f->stats[AV1_STAT_TX_SIZE + tx]++;
  for (int i = 0; i < step_y; i++)
    for (int j = 0; j < step_x; j++) {
      const int yy = (row >> sy) + i, xx = (col >> sx) + j;
      f->lf_txsz[plane][yy * f->lf_stride[plane] + xx] = (uint8_t)tx;
      t->decoded[plane][dr + i + 1][dc + j + 1] = 1;
    }
}

/* decode_reconstruct_tx on luma: the leaves of an intra block copy
 * block's transform tree, in order. */
static void inter_luma_tree(Tile *t, int tx, int row, int col) {
  Frame *f = t->f;
  const int max_h = bh4_of[t->bsize] < f->mi_rows - t->mi_row ? bh4_of[t->bsize] : f->mi_rows - t->mi_row;
  const int max_w = bw4_of[t->bsize] < f->mi_cols - t->mi_col ? bw4_of[t->bsize] : f->mi_cols - t->mi_col;
  if (row >= max_h || col >= max_w || f->failed) return;
  if (t->inter_tx[row * 32 + col] == tx) {
    transform_block(t, 0, t->mi_col * 4, t->mi_row * 4, tx, col, row);
    return;
  }
  const int sub = split_tx[tx];
  const int sw = 1 << (tx_wlog2[sub] - 2), sh = 1 << (tx_hlog2[sub] - 2);
  const int re = (1 << (tx_hlog2[tx] - 2)) < max_h - row ? 1 << (tx_hlog2[tx] - 2) : max_h - row;
  const int ce = (1 << (tx_wlog2[tx] - 2)) < max_w - col ? 1 << (tx_wlog2[tx] - 2) : max_w - col;
  for (int rr = 0; rr < re; rr += sh)
    for (int cc = 0; cc < ce; cc += sw) inter_luma_tree(t, sub, row + rr, col + cc);
}

static void residual(Tile *t) {
  Frame *f = t->f;
  const int bw4 = bw4_of[t->bsize], bh4 = bh4_of[t->bsize];
  const int wchunks = bw4 >> 4 > 1 ? bw4 >> 4 : 1;
  const int hchunks = bh4 >> 4 > 1 ? bh4 >> 4 : 1;
  for (int cy = 0; cy < hchunks; cy++)
    for (int cx = 0; cx < wchunks; cx++) {
      if (t->use_intrabc) { /* luma: the transform tree */
        const int tx = t->lossless ? TX_4X4 : av1_max_txsize_rect_lookup[t->bsize];
        const int sw = 1 << (tx_wlog2[tx] - 2), sh = 1 << (tx_hlog2[tx] - 2);
        const int ye = bh4 < (cy + 1) << 4 ? bh4 : (cy + 1) << 4;
        const int xe = bw4 < (cx + 1) << 4 ? bw4 : (cx + 1) << 4;
        for (int y = cy << 4; y < ye; y += sh)
          for (int x = cx << 4; x < xe; x += sw) {
            inter_luma_tree(t, tx, y, x);
            if (f->failed) return;
          }
      }
      for (int plane = t->use_intrabc; plane < 1 + t->has_chroma * 2; plane++) {
        const int tx = t->lossless ? TX_4X4
                       : plane ? uv_tx_size(t->bsize, f->ssx, f->ssy) : t->tx_size;
        const int step_x = 1 << (tx_wlog2[tx] - 2), step_y = 1 << (tx_hlog2[tx] - 2);
        const int sx = plane ? f->ssx : 0, sy = plane ? f->ssy : 0;
        const int pbs = plane ? plane_bsize(t->bsize, sx, sy) : t->bsize;
        const int n4w = bw4_of[pbs], n4h = bh4_of[pbs];
        const int base_x = (t->mi_col >> sx) * 4, base_y = (t->mi_row >> sy) * 4;
        const int lim_y = n4h < (16 >> sy) ? n4h : (16 >> sy);
        const int lim_x = n4w < (16 >> sx) ? n4w : (16 >> sx);
        for (int y = 0; y < lim_y; y += step_y)
          for (int x = 0; x < lim_x; x += step_x) {
            transform_block(t, plane, base_x, base_y, tx,
                            x + ((cx << 4) >> sx), y + ((cy << 4) >> sy));
            if (f->failed) return;
          }
      }
    }
}

static void reset_block_context(Tile *t) {
  const Frame *f = t->f;
  const int bw4 = bw4_of[t->bsize], bh4 = bh4_of[t->bsize];
  for (int plane = 0; plane < 1 + 2 * t->has_chroma; plane++) {
    const int sx = plane ? f->ssx : 0, sy = plane ? f->ssy : 0;
    for (int i = t->mi_col >> sx; i < ((t->mi_col + bw4) >> sx); i++)
      t->above_ctx[plane][i] = 0;
    for (int i = t->mi_row >> sy; i < ((t->mi_row + bh4) >> sy); i++)
      t->left_ctx[plane][i & ((f->sb4 >> sy) - 1)] = 0;
  }
}

static void decode_block(Tile *t, int r, int c, int bsize) {
  Frame *f = t->f;
  if (f->failed) return;
  t->mi_row = r;
  t->mi_col = c;
  t->bsize = bsize;
  const int bw4 = bw4_of[bsize], bh4 = bh4_of[bsize];
  if (bh4 == 1 && f->ssy && (r & 1) == 0) t->has_chroma = 0;
  else if (bw4 == 1 && f->ssx && (c & 1) == 0) t->has_chroma = 0;
  else t->has_chroma = f->planes > 1;
  t->avail_u = is_inside(t, r - 1, c);
  t->avail_l = is_inside(t, r, c - 1);
  t->avail_u_chroma = t->avail_u;
  t->avail_l_chroma = t->avail_l;
  if (t->has_chroma) {
    if (f->ssy && bh4 == 1) t->avail_u_chroma = is_inside(t, r - 2, c);
    if (f->ssx && bw4 == 1) t->avail_l_chroma = is_inside(t, r, c - 2);
  }
  f->stats[AV1_STAT_BLOCKS]++;
  intra_frame_mode_info(t);
  if (f->failed) return;
  f->stats[AV1_STAT_Y_MODE + t->y_mode]++;
  if (t->has_chroma) f->stats[AV1_STAT_UV_MODE + t->uv_mode]++;
  f->stats[AV1_STAT_LOSSLESS_BLOCKS] += t->lossless;
  if (f->hdr[AV1_SEG_ENABLED]) {
    f->stats[AV1_STAT_SEGMENT + t->segment_id]++;
    for (int j = 0; j < 8; j++)
      f->stats[AV1_STAT_SEG_FEATURE + j] += seg_feature(f, t->segment_id, j);
    f->stats[AV1_STAT_SEG_LOSSLESS] += t->lossless && !f->lossless;
  }
  palette_tokens(t);
  read_tx_size(t);
  if (t->use_intrabc && predict_intrabc(t)) return;
  if (t->skip) reset_block_context(t);
  for (int y = 0; y < bh4; y++)
    for (int x = 0; x < bw4; x++) {
      if (r + y >= f->mi_rows || c + x >= f->mi_cols) continue;
      MI(f, y_mode, r + y, c + x) = (uint8_t)t->y_mode;
      MI(f, uv_mode, r + y, c + x) = (uint8_t)t->uv_mode;
      MI(f, skip, r + y, c + x) = (uint8_t)t->skip;
      MI(f, tx_size_mi, r + y, c + x) = (uint8_t)t->tx_size;
      MI(f, mi_size, r + y, c + x) = (uint8_t)bsize;
      MI(f, seg_map, r + y, c + x) = (uint8_t)t->segment_id;
      const int at = (r + y) * f->mi_stride + c + x;
      for (int k = 0; k < 4; k++) f->delta_lf[at * 4 + k] = (int8_t)t->delta_lf[k];
      f->pal_size[at * 2] = (uint8_t)t->pal_size[0];
      f->pal_size[at * 2 + 1] = (uint8_t)t->pal_size[1];
      memcpy(f->pal_colors + at * 24, t->pal_colors, sizeof(t->pal_colors));
      f->is_inter[at] = (uint8_t)t->use_intrabc;
      f->mvs[at * 2] = (int16_t)(t->use_intrabc ? t->mv[0] : 0);
      f->mvs[at * 2 + 1] = (int16_t)(t->use_intrabc ? t->mv[1] : 0);
      f->written[at] = 1;
    }
  residual(t);
}

static int partition_ctx(Tile *t, int r, int c, int bsl) {
  Frame *f = t->f;
  int above = is_inside(t, r - 1, c) && mi_wlog2[MI(f, mi_size, r - 1, c)] < bsl;
  int left = is_inside(t, r, c - 1) && mi_hlog2[MI(f, mi_size, r, c - 1)] < bsl;
  return left * 2 + above;
}

static int cdf_prob(const uint16_t *icdf, int e) {
  return (e > 0 ? icdf[e - 1] : 32768) - icdf[e];
}

static void decode_partition(Tile *t, int r, int c, int bsize) {
  Frame *f = t->f;
  if (f->failed || r >= f->mi_rows || c >= f->mi_cols) return;
  const int num4 = bw4_of[bsize], half = num4 >> 1, quarter = half >> 1;
  const int has_rows = (r + half) < f->mi_rows;
  const int has_cols = (c + half) < f->mi_cols;
  int partition;
  if (bsize < BLOCK_8X8) {
    partition = PARTITION_NONE;
  } else {
    const int bsl = mi_wlog2[bsize];
    uint16_t *cdf = t->cdf.partition[(bsl - 1) * 4 + partition_ctx(t, r, c, bsl)];
    const int nsym = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
    if (has_rows && has_cols) {
      partition = read_symbol(&t->ec, cdf, nsym);
    } else if (has_rows) {
      int p = 32768 - cdf_prob(cdf, PARTITION_HORZ) - cdf_prob(cdf, PARTITION_SPLIT) -
              cdf_prob(cdf, PARTITION_HORZ_A) - cdf_prob(cdf, PARTITION_HORZ_B) -
              cdf_prob(cdf, PARTITION_VERT_A);
      if (bsize != BLOCK_128X128) p -= cdf_prob(cdf, PARTITION_HORZ_4);
      uint16_t tmp[2] = {(uint16_t)(32768 - p), 0};
      partition = ec_decode_cdf(&t->ec, tmp, 2) ? PARTITION_SPLIT : PARTITION_VERT;
    } else if (has_cols) {
      int p = 32768 - cdf_prob(cdf, PARTITION_VERT) - cdf_prob(cdf, PARTITION_SPLIT) -
              cdf_prob(cdf, PARTITION_HORZ_A) - cdf_prob(cdf, PARTITION_VERT_A) -
              cdf_prob(cdf, PARTITION_VERT_B);
      if (bsize != BLOCK_128X128) p -= cdf_prob(cdf, PARTITION_VERT_4);
      uint16_t tmp[2] = {(uint16_t)(32768 - p), 0};
      partition = ec_decode_cdf(&t->ec, tmp, 2) ? PARTITION_SPLIT : PARTITION_HORZ;
    } else {
      partition = PARTITION_SPLIT;
    }
  }
  f->stats[AV1_STAT_PARTITION + partition]++;
  /* Every partition but NONE splits a square block of 8x8 or more. */
  const int sub_h = bsize_of(num4, half), sub_v = bsize_of(half, num4);
  const int split = bsize_of(half, half);
  switch (partition) {
    case PARTITION_NONE: decode_block(t, r, c, bsize); break;
    case PARTITION_HORZ:
      decode_block(t, r, c, sub_h);
      if (has_rows) decode_block(t, r + half, c, sub_h);
      break;
    case PARTITION_VERT:
      decode_block(t, r, c, sub_v);
      if (has_cols) decode_block(t, r, c + half, sub_v);
      break;
    case PARTITION_SPLIT:
      decode_partition(t, r, c, split);
      decode_partition(t, r, c + half, split);
      decode_partition(t, r + half, c, split);
      decode_partition(t, r + half, c + half, split);
      break;
    case PARTITION_HORZ_A:
      decode_block(t, r, c, split);
      decode_block(t, r, c + half, split);
      decode_block(t, r + half, c, sub_h);
      break;
    case PARTITION_HORZ_B:
      decode_block(t, r, c, sub_h);
      decode_block(t, r + half, c, split);
      decode_block(t, r + half, c + half, split);
      break;
    case PARTITION_VERT_A:
      decode_block(t, r, c, split);
      decode_block(t, r + half, c, split);
      decode_block(t, r, c + half, sub_v);
      break;
    case PARTITION_VERT_B:
      decode_block(t, r, c, sub_v);
      decode_block(t, r, c + half, split);
      decode_block(t, r + half, c + half, split);
      break;
    case PARTITION_HORZ_4: {
      const int b = bsize_of(num4, quarter);
      for (int i = 0; i < 4; i++)
        if (i < 3 || r + quarter * 3 < f->mi_rows)
          decode_block(t, r + quarter * i, c, b);
      break;
    }
    case PARTITION_VERT_4: {
      const int b = bsize_of(quarter, num4);
      for (int i = 0; i < 4; i++)
        if (i < 3 || c + quarter * 3 < f->mi_cols)
          decode_block(t, r, c + quarter * i, b);
      break;
    }
  }
}

static void clear_block_decoded(Tile *t, int r, int c) {
  const Frame *f = t->f;
  for (int plane = 0; plane < f->planes; plane++) {
    const int sx = plane ? f->ssx : 0, sy = plane ? f->ssy : 0;
    const int sbw4 = (t->mi_col_end - c) >> sx, sbh4 = (t->mi_row_end - r) >> sy;
    for (int y = -1; y <= (f->sb4 >> sy); y++)
      for (int x = -1; x <= (f->sb4 >> sx); x++) {
        int v;
        if (y < 0 && x < sbw4) v = 1;
        else if (x < 0 && y < sbh4) v = 1;
        else v = 0;
        t->decoded[plane][y + 1][x + 1] = (uint8_t)v;
      }
    t->decoded[plane][(f->sb4 >> sy) + 1][0] = 0;
  }
}

/* ------------------------------------- loop restoration: the coefficients */

/* libaom's WIENER_FILT_TAP{0,1,2}_{MINV,MAXV,SUBEXP_K,MIDV},
 * SGRPROJ_PRJ_{MIN,MAX}{0,1}, SGRPROJ_PRJ_SUBEXP_K and the defaults. */
static const int wiener_min[3] = {-5, -23, -17}, wiener_max[3] = {10, 8, 46};
static const int wiener_k[3] = {1, 2, 3}, wiener_mid[3] = {3, -7, 15};
static const int sgrproj_min[2] = {-96, -32}, sgrproj_max[2] = {31, 95};
static const int sgrproj_mid[2] = {-32, 31};
enum { SGRPROJ_K = 4 };

static int lr_unit_count(int size, int length) {
  const int n = (length + (size >> 1)) / size;
  return n > 1 ? n : 1;
}

/* aom_read_primitive_subexpfin */
static int read_subexp(Ec *d, int n, int k) {
  int i = 0, mk = 0;
  for (;;) {
    const int b = i ? k + i - 1 : k, a = 1 << b;
    if (n <= mk + 3 * a) return read_uniform(d, n - mk) + mk;
    if (!read_bit(d)) return read_literal(d, b) + mk;
    i++;
    mk += a;
  }
}

static int recenter(int r, int v) {
  if (v > (r << 1)) return v;
  return (v & 1) ? r - ((v + 1) >> 1) : (v >> 1) + r;
}

/* aom_read_primitive_refsubexpfin over [lo, hi], recentred on ref. */
static int read_ref_subexp(Ec *d, int lo, int hi, int k, int ref) {
  const int n = hi - lo + 1, r = ref - lo;
  const int v = read_subexp(d, n, k);
  return lo + ((r << 1) <= n ? recenter(r, v) : n - 1 - recenter(n - 1 - r, v));
}

static void read_lr_unit(Tile *t, int plane, LrUnit *u) {
  Frame *f = t->f;
  int kind = f->hdr[AV1_LR_TYPE + plane];
  if (kind == RESTORE_SWITCHABLE) {
    kind = read_symbol(&t->ec, t->cdf.switchable_restore, 3);
    f->stats[AV1_STAT_LR_SWITCHABLE]++;
  } else if (kind == RESTORE_WIENER) {
    kind = read_symbol(&t->ec, t->cdf.wiener_restore, 2) ? RESTORE_WIENER : RESTORE_NONE;
  } else {
    kind = read_symbol(&t->ec, t->cdf.sgrproj_restore, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
  }
  u->type = (int8_t)kind;
  f->stats[AV1_STAT_LR_NONE + kind]++;
  if (kind == RESTORE_WIENER) {
    for (int pass = 0; pass < 2; pass++) { /* vertical, then horizontal */
      int *ref = t->ref_wiener[plane][pass];
      int c[3] = {0, 0, 0};
      for (int j = plane ? 1 : 0; j < 3; j++)
        c[j] = read_ref_subexp(&t->ec, wiener_min[j], wiener_max[j], wiener_k[j], ref[j]);
      for (int j = 0; j < 3; j++) {
        ref[j] = c[j];
        u->coef[pass * 3 + j] = (int16_t)c[j];
      }
    }
  } else if (kind == RESTORE_SGRPROJ) {
    const int set = read_literal(&t->ec, 4);
    const int32_t *params = av1_sgr_params[set];
    int *ref = t->ref_sgr[plane], xqd[2] = {0, 0};
    for (int i = 0; i < 2; i++) {
      if (params[i])
        xqd[i] = read_ref_subexp(&t->ec, sgrproj_min[i], sgrproj_max[i], SGRPROJ_K, ref[i]);
      else if (i == 1)
        xqd[1] = clip3(sgrproj_min[1], sgrproj_max[1], 128 - xqd[0]);
    }
    u->sgr_set = (int8_t)set;
    for (int i = 0; i < 2; i++) {
      ref[i] = xqd[i];
      u->coef[i] = (int16_t)xqd[i];
    }
  }
}

/* read_lr: the units whose top-left corner lies in the superblock at
 * (r, c). */
static void read_lr(Tile *t, int r, int c) {
  Frame *f = t->f;
  for (int plane = 0; plane < f->planes; plane++) {
    if (!f->hdr[AV1_LR_TYPE + plane]) continue;
    const int sx = plane ? f->ssx : 0, sy = plane ? f->ssy : 0;
    const int size = f->hdr[AV1_LR_UNIT + plane];
    const int r0 = (r * (4 >> sy) + size - 1) / size;
    int r1 = ((r + f->sb4) * (4 >> sy) + size - 1) / size;
    const int c0 = (c * (4 >> sx) + size - 1) / size;
    int c1 = ((c + f->sb4) * (4 >> sx) + size - 1) / size;
    if (r1 > f->lr_rows[plane]) r1 = f->lr_rows[plane];
    if (c1 > f->lr_cols[plane]) c1 = f->lr_cols[plane];
    for (int ur = r0; ur < r1; ur++)
      for (int uc = c0; uc < c1; uc++)
        read_lr_unit(t, plane, &f->lr[plane][ur * f->lr_cols[plane] + uc]);
  }
}

static void decode_tile(Tile *t, const uint8_t *data, long size) {
  Frame *f = t->f;
  ec_init(&t->ec, data, size, !f->hdr[AV1_DISABLE_CDF_UPDATE]);
  init_cdfs(&t->cdf, f->hdr[AV1_BASE_Q]);
  for (int p = 0; p < f->planes; p++)
    memset(t->above_ctx[p], 0, (size_t)(f->mi_cols + 32));
  for (int i = 0; i < 4; i++) t->delta_lf[i] = 0;
  t->current_q = f->hdr[AV1_BASE_Q];
  for (int p = 0; p < 3; p++) {
    for (int pass = 0; pass < 2; pass++)
      for (int j = 0; j < 3; j++) t->ref_wiener[p][pass][j] = wiener_mid[j];
    for (int i = 0; i < 2; i++) t->ref_sgr[p][i] = sgrproj_mid[i];
  }
  memset(t->above_txfm, 64, (size_t)(f->mi_cols + 64));
  for (int r = t->mi_row_start; r < t->mi_row_end; r += f->sb4) {
    memset(t->left_ctx, 0, sizeof(t->left_ctx));
    memset(t->left_txfm, 64, sizeof(t->left_txfm));
    for (int c = t->mi_col_start; c < t->mi_col_end; c += f->sb4) {
      t->read_deltas = f->hdr[AV1_DELTA_Q_PRESENT];
      clear_block_decoded(t, r, c);
      read_lr(t, r, c);
      decode_partition(t, r, c, f->sb_size);
      if (f->failed) return;
      if (ec_overflowed(&t->ec)) {
        fail(f, "AV1: a tile's symbols run past its data (libaom reports "
                "a corrupt frame)");
        return;
      }
    }
  }
  if (!ec_trailing_bits_ok(&t->ec))
    fail(f, "AV1: a tile's data does not end in its trailing bits (libaom "
            "reports a corrupt frame)");
}

/* ----------------------------------------------------------- deblocking */

static int filter_level(const Frame *f, int row, int col, int plane, int pass) {
  const int i = plane == 0 ? pass : plane + 1;
  int delta = 0;
  if (f->hdr[AV1_DELTA_LF_PRESENT]) {
    const int8_t *d = &f->delta_lf[(row * f->mi_stride + col) * 4];
    delta = f->hdr[AV1_DELTA_LF_MULTI] ? d[i] : d[0];
  }
  int lvl = clip3(0, 63, delta + f->hdr[AV1_LF_LEVEL + i]);
  const int segment = MI(f, seg_map, row, col);
  if (seg_feature(f, segment, SEG_LVL_ALT_LF_Y_V + i))
    lvl = clip3(0, 63, lvl + f->hdr[AV1_SEG_DATA + 8 * segment + SEG_LVL_ALT_LF_Y_V + i]);
  if (f->hdr[AV1_LF_DELTA_ENABLED]) {
    const int shift = lvl >> 5;
    lvl += f->hdr[AV1_LF_REF_DELTAS + 0] * (1 << shift);
    lvl = clip3(0, 63, lvl);
  }
  return lvl;
}

/* libaom's highbd_filter4: samples offset by and clamped to +-2^(bd-1)
 * (signed_char_clamp_high); the filter's own shifts stay those of 8
 * bits. */
static void filter4(uint16_t *s, int step, int hev, int bd) {
  const int o = 128 << (bd - 8);
  int p1 = s[-2 * step] - o, p0 = s[-step] - o, q0 = s[0] - o, q1 = s[step] - o;
#define C8(x) clip3(-o, o - 1, (x))
  int filter = hev ? C8(p1 - q1) : 0;
  filter = C8(filter + 3 * (q0 - p0));
  int f1 = C8(filter + 4) >> 3, f2 = C8(filter + 3) >> 3;
  s[0] = (uint16_t)(C8(q0 - f1) + o);
  s[-step] = (uint16_t)(C8(p0 + f2) + o);
  if (!hev) {
    int ff = round2(f1, 1);
    s[step] = (uint16_t)(C8(q1 - ff) + o);
    s[-2 * step] = (uint16_t)(C8(p1 + ff) + o);
  }
#undef C8
}

static void wide_filter(uint16_t *s, int step, int plane, int log2size) {
  const int n = log2size == 4 ? 6 : plane == 0 ? 3 : 2;
  const int n2 = (log2size == 3 && plane == 0) ? 0 : 1;
  int F[16], out[16];
  for (int k = -(n + 1); k <= n; k++) F[k + 8] = s[k * step];
  for (int i = -n; i < n; i++) {
    int t = 0;
    for (int j = -n; j <= n; j++) {
      int p = clip3(-(n + 1), n, i + j);
      int tap = (abs(j) <= n2) ? 2 : 1;
      t += F[p + 8] * tap;
    }
    out[i + 8] = round2(t, log2size);
  }
  for (int i = -n; i < n; i++) s[i * step] = (uint16_t)out[i + 8];
}

/* The deblocking of one line; limit, blimit and thresh are the 8-bit
 * ones, shifted by bd - 8 here as libaom's highbd masks shift them. */
static void sample_filter(uint16_t *s, int step, int plane, int limit,
                          int blimit, int thresh, int filter_size, int bd) {
  const int sh = bd - 8, one = 1 << sh;
  limit <<= sh;
  blimit <<= sh;
  thresh <<= sh;
  int p[7], q[7];
  for (int k = 0; k < 7; k++) {
    q[k] = (k < 4 || filter_size == 16) ? s[k * step] : 0;
    p[k] = (k < 4 || filter_size == 16) ? s[-(k + 1) * step] : 0;
  }
  const int hev = abs(p[1] - p[0]) > thresh || abs(q[1] - q[0]) > thresh;
  int len = filter_size == 4 ? 4 : plane ? 6 : filter_size == 8 ? 8 : 16;
  int mask = abs(p[1] - p[0]) <= limit && abs(q[1] - q[0]) <= limit &&
             abs(p[0] - q[0]) * 2 + abs(p[1] - q[1]) / 2 <= blimit;
  if (len >= 6) mask = mask && abs(p[2] - p[1]) <= limit && abs(q[2] - q[1]) <= limit;
  if (len >= 8) mask = mask && abs(p[3] - p[2]) <= limit && abs(q[3] - q[2]) <= limit;
  if (!mask) return;
  int flat = 0, flat2 = 0;
  if (filter_size >= 8) {
    flat = abs(p[1] - p[0]) <= one && abs(q[1] - q[0]) <= one &&
           abs(p[2] - p[0]) <= one && abs(q[2] - q[0]) <= one;
    if (len >= 8) flat = flat && abs(p[3] - p[0]) <= one && abs(q[3] - q[0]) <= one;
  }
  if (filter_size >= 16)
    flat2 = abs(p[6] - p[0]) <= one && abs(q[6] - q[0]) <= one &&
            abs(p[5] - p[0]) <= one && abs(q[5] - q[0]) <= one &&
            abs(p[4] - p[0]) <= one && abs(q[4] - q[0]) <= one;
  if (filter_size == 4 || !flat) filter4(s, step, hev, bd);
  else if (filter_size == 8 || !flat2) wide_filter(s, step, plane, 3);
  else wide_filter(s, step, plane, 4);
}

/* One line of 16 samples across an edge (line[8] is q0, line[7] p0),
 * filtered in place as the deblocking filter of filter_size filters it at
 * bd bits (limit, blimit and thresh at 8 bits' scale). */
void av1_lf_line_hbd(uint16_t *line, int plane, int limit, int blimit,
                     int thresh, int filter_size, int bd) {
  sample_filter(line + 8, 1, plane, limit, blimit, thresh, filter_size, bd);
}

void av1_lf_line(uint8_t *line, int plane, int limit, int blimit, int thresh,
                 int filter_size) {
  uint16_t b[16];
  widen(line, 16, b, 16, 16, 1);
  av1_lf_line_hbd(b, plane, limit, blimit, thresh, filter_size, 8);
  narrow(b, 16, line, 16, 16, 1);
}

static void loop_filter(Frame *f) {
  const int32_t *h = f->hdr;
  if (!h[AV1_LF_LEVEL] && !h[AV1_LF_LEVEL + 1]) return;
  const int sharp = h[AV1_LF_SHARPNESS];
  for (int plane = 0; plane < f->planes; plane++) {
    if (plane > 0 && !h[AV1_LF_LEVEL + 1 + plane]) continue;
    const int sx = plane ? f->ssx : 0, sy = plane ? f->ssy : 0;
    for (int pass = 0; pass < 2; pass++) {
      for (int row0 = 0; row0 < f->mi_rows; row0 += 1 << sy)
        for (int col0 = 0; col0 < f->mi_cols; col0 += 1 << sx) {
          const int x = col0 * 4, y = row0 * 4;
          if (x >= f->width || y >= f->height) continue;
          if ((pass == 0 && x == 0) || (pass == 1 && y == 0)) continue;
          const int row = row0 | sy, col = col0 | sx;
          const int xp = x >> sx, yp = y >> sy;
          const int dx = pass == 0, dy = pass == 1;
          const int prev_row = row - (dy << sy), prev_col = col - (dx << sx);
          const int ls = f->lf_stride[plane];
          const int txsz = f->lf_txsz[plane][(row >> sy) * ls + (col >> sx)];
          const int prev_tx = f->lf_txsz[plane][(prev_row >> sy) * ls + (prev_col >> sx)];
          /* Intra blocks are filtered at every transform edge; the filter
           * is the smaller transform's side across the edge, at most 16
           * (luma) or 8 (chroma, the 6-tap filter). */
          const int cur = pass == 0 ? tx_wlog2[txsz] : tx_hlog2[txsz];
          const int prev = pass == 0 ? tx_wlog2[prev_tx] : tx_hlog2[prev_tx];
          if ((pass == 0 ? xp : yp) % (1 << cur)) continue;
          const int base = 1 << (cur < prev ? cur : prev);
          const int filter_size = base < (plane ? 8 : 16) ? base : (plane ? 8 : 16);
          int lvl = filter_level(f, row, col, plane, pass);
          if (!lvl) lvl = filter_level(f, prev_row, prev_col, plane, pass);
          if (!lvl) continue;
          const int shift = sharp > 4 ? 2 : sharp > 0 ? 1 : 0;
          const int limit = sharp > 0 ? clip3(1, 9 - sharp, lvl >> shift)
                                      : ((lvl >> shift) > 1 ? lvl >> shift : 1);
          const int blimit = 2 * (lvl + 2) + limit, thresh = lvl >> 4;
          f->stats[AV1_STAT_LF_EDGES]++;
          uint16_t *base_px = f->frame[plane] + yp * f->stride[plane] + xp;
          const int step = pass == 0 ? 1 : f->stride[plane];
          for (int i = 0; i < 4; i++) {
            uint16_t *s = pass == 0 ? base_px + i * f->stride[plane] : base_px + i;
            sample_filter(s, step, plane, limit, blimit, thresh, filter_size, f->bd);
          }
        }
    }
  }
}

/* ----------------------------------------------------------------- CDEF */

static int cdef_dir_rc(int dir, int k, int rc) {
  const int v = av1_cdef_directions_padded[dir + 2][k];
  const int r = (v + 72 + 144 * 4) / 144 - 4;
  return rc == 0 ? r : v - r * 144;
}

/* libaom's cdef_find_dir_c, the samples shifted down by coeff_shift =
 * bd - 8 first. */
int av1_cdef_find_dir_hbd(const uint16_t *img, int stride, int *var,
                          int coeff_shift) {
  int cost[8] = {0}, partial[8][15] = {{0}};
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) {
      int x = (img[i * stride + j] >> coeff_shift) - 128;
      partial[0][i + j] += x;
      partial[1][i + j / 2] += x;
      partial[2][i] += x;
      partial[3][3 + i - j / 2] += x;
      partial[4][7 + i - j] += x;
      partial[5][3 - i / 2 + j] += x;
      partial[6][j] += x;
      partial[7][i / 2 + j] += x;
    }
  for (int i = 0; i < 8; i++) {
    cost[2] += partial[2][i] * partial[2][i];
    cost[6] += partial[6][i] * partial[6][i];
  }
  cost[2] *= div_table[8];
  cost[6] *= div_table[8];
#define SQ(v) ((v) * (v))
  for (int i = 0; i < 7; i++) {
    cost[0] += (SQ(partial[0][i]) + SQ(partial[0][14 - i])) * div_table[i + 1];
    cost[4] += (SQ(partial[4][i]) + SQ(partial[4][14 - i])) * div_table[i + 1];
  }
  cost[0] += partial[0][7] * partial[0][7] * div_table[8];
  cost[4] += partial[4][7] * partial[4][7] * div_table[8];
  for (int i = 1; i < 8; i += 2) {
    for (int j = 0; j < 5; j++) cost[i] += SQ(partial[i][3 + j]);
    cost[i] *= div_table[8];
    for (int j = 0; j < 3; j++)
      cost[i] += (SQ(partial[i][j]) + SQ(partial[i][10 - j])) * div_table[2 * j + 2];
  }
#undef SQ
  int best = 0, dir = 0;
  for (int d = 0; d < 8; d++)
    if (cost[d] > best) {
      best = cost[d];
      dir = d;
    }
  *var = (best - cost[(dir + 4) & 7]) >> 10;
  return dir;
}

int av1_cdef_find_dir(const uint8_t *img, int stride, int *var) {
  uint16_t b[64];
  widen(img, stride, b, 8, 8, 8);
  return av1_cdef_find_dir_hbd(b, 8, var, 0);
}

static int constrain(int diff, int threshold, int damping) {
  if (!threshold) return 0;
  int adj = damping - floor_log2((uint32_t)threshold);
  if (adj < 0) adj = 0;
  const int a = abs(diff);
  int lim = threshold - (a >> adj);
  if (lim < 0) lim = 0;
  const int v = a < lim ? a : lim;
  return diff < 0 ? -v : v;
}

/* CDEF of the w x h block at (y0, x0) of src (taps outside rows x cols
 * unavailable) into dst; pri, sec and damping are the strengths and the
 * damping at the samples' scale (shifted by coeff_shift = bd - 8), the
 * primary taps chosen by pri >> coeff_shift. */
void av1_cdef_block_hbd(const uint16_t *src, int stride, int rows, int cols,
                        int y0, int x0, int w, int h, int pri, int sec,
                        int damping, int dir, uint16_t *dst, int dst_stride,
                        int coeff_shift) {
  const int32_t *pri_taps = av1_cdef_pri_taps[(pri >> coeff_shift) & 1];
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      const int x = src[(y0 + i) * stride + x0 + j];
      int sum = 0, mx = x, mn = x;
      for (int k = 0; k < 2; k++)
        for (int sign = -1; sign <= 1; sign += 2) {
          int yy = y0 + i + sign * cdef_dir_rc(dir, k, 0);
          int xx = x0 + j + sign * cdef_dir_rc(dir, k, 1);
          if (xx >= 0 && xx < cols && yy >= 0 && yy < rows) {
            int p = src[yy * stride + xx];
            sum += pri_taps[k] * constrain(p - x, pri, damping);
            if (p > mx) mx = p;
            if (p < mn) mn = p;
          }
          for (int off = -2; off <= 2; off += 4) {
            const int d2 = (dir + off) & 7;
            yy = y0 + i + sign * cdef_dir_rc(d2, k, 0);
            xx = x0 + j + sign * cdef_dir_rc(d2, k, 1);
            if (xx >= 0 && xx < cols && yy >= 0 && yy < rows) {
              int s = src[yy * stride + xx];
              sum += av1_cdef_sec_taps[k] * constrain(s - x, sec, damping);
              if (s > mx) mx = s;
              if (s < mn) mn = s;
            }
          }
        }
      const int y = x + ((8 + sum - (sum < 0)) >> 4);
      dst[i * dst_stride + j] = (uint16_t)clip3(mn, mx, y);
    }
}

void av1_cdef_block(const uint8_t *src, int stride, int rows, int cols,
                    int y0, int x0, int w, int h, int pri, int sec,
                    int damping, int dir, uint8_t *dst, int dst_stride) {
  /* the taps lie in rows x cols, the block itself may lie past them */
  const int nr = rows > y0 + h ? rows : y0 + h, nc = cols > x0 + w ? cols : x0 + w;
  uint16_t *s = malloc(sizeof(uint16_t) * (size_t)nr * (size_t)stride);
  uint16_t d[64];
  if (!s) return;
  widen(src, stride, s, stride, nc, nr);
  av1_cdef_block_hbd(s, stride, rows, cols, y0, x0, w, h, pri, sec, damping, dir,
                     d, 8, 0);
  narrow(d, 8, dst, dst_stride, w, h);
  free(s);
}

static void cdef_filter(Frame *f, const uint16_t *src, int plane, int r, int c,
                        int pri, int sec, int damping, int dir) {
  const int sx = plane ? f->ssx : 0, sy = plane ? f->ssy : 0;
  const int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy, stride = f->stride[plane];
  const int cs = f->bd - 8;
  av1_cdef_block_hbd(src, stride, (f->mi_rows * 4) >> sy, (f->mi_cols * 4) >> sx,
                     y0, x0, 8 >> sx, 8 >> sy, pri, sec << cs, damping + cs, dir,
                     f->frame[plane] + y0 * stride + x0, stride, cs);
}

/* The chroma direction of a luma direction where the chroma planes are
 * subsampled on one axis only (4:2:2; libaom's conv422 in
 * av1_cdef_filter_fb). */
const int av1_cdef_conv422[8] = {7, 0, 2, 4, 5, 6, 6, 6};

/* CDEF over the frame, reading the deblocked planes src (libaom's
 * av1_cdef_filter_fb: the strengths shifted by coeff_shift = bd - 8 before
 * the luma adjustment, the damping raised by it; 4x8 chroma blocks at
 * 4:2:2, their direction mapped through av1_cdef_conv422). */
static void cdef(Frame *f, uint16_t *const *src) {
  const int32_t *h = f->hdr;
  const int damping = h[AV1_CDEF_DAMPING], cs = f->bd - 8;
  for (int r = 0; r < f->mi_rows; r += 2)
    for (int c = 0; c < f->mi_cols; c += 2) {
      const int idx = f->cdef_idx[(r >> 4) * f->cdef_stride + (c >> 4)];
      if (idx == -1) continue;
      if (MI(f, skip, r, c) && MI(f, skip, r + 1, c) && MI(f, skip, r, c + 1) &&
          MI(f, skip, r + 1, c + 1))
        continue;
      f->stats[AV1_STAT_CDEF_BLOCKS]++;
      int var;
      const int ydir = av1_cdef_find_dir_hbd(src[0] + r * 4 * f->stride[0] + c * 4,
                                             f->stride[0], &var, cs);
      int pri = h[AV1_CDEF_Y_PRI + idx] << cs, sec = h[AV1_CDEF_Y_SEC + idx];
      int dir = pri ? ydir : 0;
      int vs = (var >> 6) ? floor_log2((uint32_t)(var >> 6)) : 0;
      if (vs > 12) vs = 12;
      const int adj = var ? (pri * (4 + vs) + 8) >> 4 : 0;
      if (pri || sec) cdef_filter(f, src[0], 0, r, c, adj, sec, damping, dir);
      if (f->planes > 1) {
        pri = h[AV1_CDEF_UV_PRI + idx] << cs;
        sec = h[AV1_CDEF_UV_SEC + idx];
        dir = !pri ? 0 : f->ssx != f->ssy ? av1_cdef_conv422[ydir] : ydir;
        if (pri || sec) {
          cdef_filter(f, src[1], 1, r, c, pri, sec, damping - 1, dir);
          cdef_filter(f, src[2], 2, r, c, pri, sec, damping - 1, dir);
        }
      }
    }
}

/* ----------------------------------------- loop restoration: the filters */

/* The Wiener filter at bd bits (libaom's av1_highbd_wiener_convolve_add_src_c
 * at get_conv_params_wiener(bd): InterRound0 and InterRound1 3 and 11, or
 * 5 and 9 at 12 bits) of the w x h block at src, whose 3 samples around it
 * are read: vf and hf are the 7 taps of the vertical and the horizontal
 * filter (summing to 0; the source sample is added at the centre with
 * weight 128). Returns 0, or 2 when out of memory. */
int av1_wiener_filter_hbd(const uint16_t *src, int stride, int w, int h,
                          const int *vf, const int *hf, uint16_t *dst,
                          int dst_stride, int bd) {
  const int r0 = bd == 12 ? 5 : 3, r1 = bd == 12 ? 9 : 11;
  const int lim = (1 << (bd + 1 + 7 - r0)) - 1; /* WIENER_CLAMP_LIMIT - 1 */
  int32_t *tmp = malloc(sizeof(int32_t) * (size_t)(h + 6) * (size_t)w);
  if (!tmp) return 2;
  for (int i = -3; i < h + 3; i++) {
    const uint16_t *row = src + i * stride;
    for (int j = 0; j < w; j++) {
      int32_t acc = (row[j] << 7) + (1 << (bd + 6));
      for (int k = 0; k < 7; k++) acc += hf[k] * row[j + k - 3];
      tmp[(i + 3) * w + j] = clip3(0, lim, round2(acc, r0));
    }
  }
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      int32_t acc = (tmp[(i + 3) * w + j] << 7) - (1 << (bd + r1 - 1));
      for (int k = 0; k < 7; k++) acc += vf[k] * tmp[(i + k) * w + j];
      dst[i * dst_stride + j] = (uint16_t)clip3(0, (1 << bd) - 1, round2(acc, r1));
    }
  free(tmp);
  return 0;
}

/* The (h + 6) x (w + 6) samples around a w x h block at src widened to 16
 * bits (malloc'd; NULL when out of memory), for the 8-bit entry points of
 * the loop restoration filters. */
static uint16_t *widen_around(const uint8_t *src, int stride, int w, int h) {
  uint16_t *b = malloc(sizeof(uint16_t) * (size_t)(h + 6) * (size_t)(w + 6));
  if (b) widen(src - 3 * stride - 3, stride, b, w + 6, w + 6, h + 6);
  return b;
}

int av1_wiener_filter(const uint8_t *src, int stride, int w, int h,
                      const int *vf, const int *hf, uint8_t *dst,
                      int dst_stride) {
  uint16_t *b = widen_around(src, stride, w, h);
  uint16_t *d = malloc(sizeof(uint16_t) * (size_t)w * (size_t)h);
  int rc = 2;
  if (b && d) rc = av1_wiener_filter_hbd(b + 3 * (w + 6) + 3, w + 6, w, h, vf,
                                         hf, d, w, 8);
  if (!rc) narrow(d, w, dst, dst_stride, w, h);
  free(b);
  free(d);
  return rc;
}

/* The self-guided filter's A and B (libaom's calculate_intermediate_result)
 * at rows -1 .. h and columns -1 .. w of the block at src, for radius r and
 * scale s, into arrays of (h + 2) x (w + 2); at bd bits the box's sums
 * of squares and of samples are rounded down by 2 (bd - 8) and bd - 8
 * bits for the variance, B takes the sum as it is. */
static void sgr_box(const uint16_t *src, int stride, int w, int h, int r, int s,
                    int bd, int32_t *A, int32_t *B) {
  const uint32_t n = (uint32_t)((2 * r + 1) * (2 * r + 1));
  for (int i = -1; i <= h; i++)
    for (int j = -1; j <= w; j++) {
      uint32_t a = 0, b = 0;
      for (int dy = -r; dy <= r; dy++)
        for (int dx = -r; dx <= r; dx++) {
          const uint32_t v = src[(i + dy) * stride + j + dx];
          a += v * v;
          b += v;
        }
      const uint32_t as = (uint32_t)round2(a, 2 * (bd - 8));
      const uint32_t bs = (uint32_t)round2(b, bd - 8);
      const uint32_t p = as * n < bs * bs ? 0 : as * n - bs * bs;
      const uint32_t z = (p * (uint32_t)s + (1u << 19)) >> 20;
      const int k = (i + 1) * (w + 2) + j + 1;
      A[k] = av1_x_by_xplus1[z < 255 ? z : 255];
      B[k] = (int32_t)(((uint32_t)(256 - A[k]) * b * (uint32_t)av1_one_by_x[n - 1] +
                        (1u << 11)) >> 12);
    }
}

/* The self-guided filter at bd bits (libaom's
 * av1_apply_selfguided_restoration_c) of the w x h block at src, whose 3
 * samples around it are read, with parameter set `set` and xqd. Returns 0,
 * or 2 when out of memory. */
int av1_sgr_filter_hbd(const uint16_t *src, int stride, int w, int h, int set,
                       int xqd0, int xqd1, uint16_t *dst, int dst_stride,
                       int bd) {
  const int32_t *prm = av1_sgr_params[set];
  const int r0 = prm[0], r1 = prm[1], ws = w + 2;
  const size_t n = (size_t)(h + 2) * (size_t)ws;
  int32_t *buf = malloc(sizeof(int32_t) * 4 * n);
  if (!buf) return 2;
  int32_t *A0 = buf, *B0 = buf + n, *A1 = buf + 2 * n, *B1 = buf + 3 * n;
  if (r0) sgr_box(src, stride, w, h, r0, prm[2], bd, A0, B0);
  if (r1) sgr_box(src, stride, w, h, r1, prm[3], bd, A1, B1);
  const int xq0 = r0 ? xqd0 : 0;
  const int xq1 = !r1 ? 0 : r0 ? 128 - xqd0 - xqd1 : 128 - xqd1;
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      const int k = (i + 1) * ws + j + 1;
      const int32_t x = src[i * stride + j], u = x << 4;
      int32_t v = u << 7;
      if (r0) {
        int32_t a, b, f0;
        if (i & 1) {
          a = A0[k] * 6 + (A0[k - 1] + A0[k + 1]) * 5;
          b = B0[k] * 6 + (B0[k - 1] + B0[k + 1]) * 5;
          f0 = (a * x + b + (1 << 7)) >> 8;
        } else {
          a = (A0[k - ws] + A0[k + ws]) * 6 +
              (A0[k - 1 - ws] + A0[k + 1 - ws] + A0[k - 1 + ws] + A0[k + 1 + ws]) * 5;
          b = (B0[k - ws] + B0[k + ws]) * 6 +
              (B0[k - 1 - ws] + B0[k + 1 - ws] + B0[k - 1 + ws] + B0[k + 1 + ws]) * 5;
          f0 = (a * x + b + (1 << 8)) >> 9;
        }
        v += xq0 * (f0 - u);
      }
      if (r1) {
        const int32_t a =
            (A1[k] + A1[k - 1] + A1[k + 1] + A1[k - ws] + A1[k + ws]) * 4 +
            (A1[k - 1 - ws] + A1[k + 1 - ws] + A1[k - 1 + ws] + A1[k + 1 + ws]) * 3;
        const int32_t b =
            (B1[k] + B1[k - 1] + B1[k + 1] + B1[k - ws] + B1[k + ws]) * 4 +
            (B1[k - 1 - ws] + B1[k + 1 - ws] + B1[k - 1 + ws] + B1[k + 1 + ws]) * 3;
        v += xq1 * (((a * x + b + (1 << 8)) >> 9) - u);
      }
      const int16_t out = (int16_t)((v + (1 << 10)) >> 11);
      dst[i * dst_stride + j] = (uint16_t)clip3(0, (1 << bd) - 1, out);
    }
  free(buf);
  return 0;
}

int av1_sgr_filter(const uint8_t *src, int stride, int w, int h, int set,
                   int xqd0, int xqd1, uint8_t *dst, int dst_stride) {
  uint16_t *b = widen_around(src, stride, w, h);
  uint16_t *d = malloc(sizeof(uint16_t) * (size_t)w * (size_t)h);
  int rc = 2;
  if (b && d) rc = av1_sgr_filter_hbd(b + 3 * (w + 6) + 3, w + 6, w, h, set,
                                      xqd0, xqd1, d, w, 8);
  if (!rc) narrow(d, w, dst, dst_stride, w, h);
  free(b);
  free(d);
  return rc;
}

/* Loop restoration of each plane whose frame type is not RESTORE_NONE:
 * its units filtered in 64-row stripes offset 8 rows up (luma rows); the
 * rows above and below a stripe are the deblocked frame's `pre` (the 2
 * nearest, the nearer repeated), the frame's own edges repeat. Returns 0,
 * or 2 when out of memory. */
static int loop_restoration(Frame *f, uint16_t *const *pre) {
  for (int p = 0; p < f->planes; p++) {
    if (!f->hdr[AV1_LR_TYPE + p]) continue;
    const int sx = p ? f->ssx : 0, sy = p ? f->ssy : 0;
    const int pw = (f->width + sx) >> sx, ph = (f->height + sy) >> sy;
    const int size = f->hdr[AV1_LR_UNIT + p], stride = f->stride[p];
    const int off = 8 >> sy, height = 64 >> sy, bw = pw + 6;
    const int rows = f->lr_rows[p], cols = f->lr_cols[p];
    const size_t plane_bytes = sizeof(uint16_t) * (size_t)stride * (size_t)f->alloc_h[p];
    uint16_t *block = malloc(sizeof(uint16_t) * (size_t)(height + 6) * (size_t)bw);
    uint16_t *cdef_out = malloc(plane_bytes);
    if (!block || !cdef_out) {
      free(block);
      free(cdef_out);
      return 2;
    }
    memcpy(cdef_out, f->frame[p], plane_bytes);
    int rc = 0;
    for (int k = 0; !rc; k++) {
      const int start = k * height - off;
      const int y0 = start > 0 ? start : 0;
      const int y1 = start + height < ph ? start + height : ph;
      if (y0 >= ph) break;
      for (int y = y0 - 3; y < y1 + 3; y++) {
        const int yy = clip3(0, ph - 1, y);
        const uint16_t *row;
        if (yy < start)
          row = pre[p] + (start - 2 > yy ? start - 2 : yy) * stride;
        else if (yy > start + height - 1)
          row = pre[p] + (start + height + 1 < yy ? start + height + 1 : yy) * stride;
        else
          row = cdef_out + yy * stride;
        uint16_t *b = block + (y - y0 + 3) * bw;
        for (int x = -3; x < pw + 3; x++) b[x + 3] = row[clip3(0, pw - 1, x)];
      }
      const int ur = (y0 + off) / size < rows - 1 ? (y0 + off) / size : rows - 1;
      for (int uc = 0; uc < cols && !rc; uc++) {
        const LrUnit *u = &f->lr[p][ur * cols + uc];
        const int x0 = uc * size, x1 = uc == cols - 1 ? pw : x0 + size;
        const uint16_t *src = block + 3 * bw + 3 + x0;
        uint16_t *dst = f->frame[p] + y0 * stride + x0;
        if (u->type == RESTORE_WIENER) {
          int vf[7], hf[7];
          for (int pass = 0; pass < 2; pass++) {
            const int16_t *c = u->coef + 3 * pass;
            int *t = pass ? hf : vf;
            t[0] = t[6] = c[0];
            t[1] = t[5] = c[1];
            t[2] = t[4] = c[2];
            t[3] = -2 * (c[0] + c[1] + c[2]);
          }
          rc = av1_wiener_filter_hbd(src, bw, x1 - x0, y1 - y0, vf, hf, dst, stride,
                                     f->bd);
        } else if (u->type == RESTORE_SGRPROJ) {
          rc = av1_sgr_filter_hbd(src, bw, x1 - x0, y1 - y0, u->sgr_set, u->coef[0],
                                  u->coef[1], dst, stride, f->bd);
        }
      }
    }
    free(block);
    free(cdef_out);
    if (rc) return rc;
  }
  return 0;
}

/* ------------------------------------------------------------ the frame */

/* ------------------------------------------------------- film grain */

/* The grain parameters (utils/avif.py grain_plan): libaom's
 * aom_film_grain_t with the AR coefficients and the multipliers less 128
 * and the offsets less 256. */
enum {
  G_SEED, G_NUM_Y, G_Y_POINTS /* 14 x 2 */, G_NUM_CB = G_Y_POINTS + 28,
  G_CB_POINTS /* 10 x 2 */, G_NUM_CR = G_CB_POINTS + 20,
  G_CR_POINTS /* 10 x 2 */, G_CSFL = G_CR_POINTS + 20, G_SCALING_SHIFT,
  G_AR_LAG, G_AR_Y /* 24 */, G_AR_CB = G_AR_Y + 24 /* 25 */,
  G_AR_CR = G_AR_CB + 25 /* 25 */, G_AR_SHIFT = G_AR_CR + 25,
  G_GRAIN_SCALE_SHIFT, G_CB_MULT, G_CB_LUMA_MULT, G_CB_OFFSET, G_CR_MULT,
  G_CR_LUMA_MULT, G_CR_OFFSET, G_OVERLAP, G_CLIP, G_MC_IDENTITY, G_N
};

static int grain_bits(uint16_t *r, int n) {
  const unsigned v = *r;
  const unsigned bit = (v ^ (v >> 1) ^ (v >> 3) ^ (v >> 12)) & 1;
  *r = (uint16_t)((v >> 1) | (bit << 15));
  return (*r >> (16 - n)) & ((1 << n) - 1);
}

/* A grain template (h x w, stride 82): Gaussian_Sequence drawn from the
 * seeded register, rounded down by shift, then the auto-regressive
 * filter over rows 3.. and columns 3..w-4 (for chroma, with the
 * co-located luma template's average as the last input). */
static void grain_template(int16_t *g, int h, int w, uint16_t seed, int shift,
                           const int32_t *coef, int lag, int ar_shift, int lo,
                           int hi, const int16_t *luma, int ssx, int ssy) {
  uint16_t r = seed;
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++)
      g[i * 82 + j] = (int16_t)((av1_gaussian_sequence[grain_bits(&r, 11)] +
                                 ((1 << shift) >> 1)) >> shift);
  for (int i = 3; i < h; i++)
    for (int j = 3; j < w - 3; j++) {
      int sum = 0, pos = 0;
      for (int dr = -lag; dr <= 0; dr++)
        for (int dc = -lag; dc <= lag; dc++) {
          if (dr == 0 && dc == 0) {
            if (luma) {
              const int ly = ((i - 3) << ssy) + 3, lx = ((j - 3) << ssx) + 3;
              int avg = 0;
              for (int a = 0; a <= ssy; a++)
                for (int b = 0; b <= ssx; b++) avg += luma[(ly + a) * 82 + lx + b];
              sum += coef[pos] * round2(avg, ssx + ssy);
            }
            goto done;
          }
          sum += coef[pos++] * g[(i + dr) * 82 + j + dc];
        }
    done:
      g[i * 82 + j] = (int16_t)clip3(lo, hi, g[i * 82 + j] + round2(sum, ar_shift));
    }
}

static void scaling_lut(const int32_t *points, int n, int *lut) {
  memset(lut, 0, 256 * sizeof(int));
  if (!n) return;
  for (int i = 0; i < points[0]; i++) lut[i] = points[1];
  for (int k = 0; k + 1 < n; k++) {
    const int x0 = points[2 * k], y0 = points[2 * k + 1];
    const int dx = points[2 * k + 2] - x0, dy = points[2 * k + 3] - y0;
    const int64_t delta = (int64_t)dy * ((65536 + (dx >> 1)) / dx);
    for (int x = 0; x < dx; x++) lut[x0 + x] = y0 + (int)((x * delta + 32768) >> 16);
  }
  for (int i = points[2 * (n - 1)]; i < 256; i++) lut[i] = points[2 * (n - 1) + 1];
}

static int scale_lut(const int *lut, int index, int bd) {
  const int x = index >> (bd - 8);
  if (bd == 8 || x == 255) return lut[x];
  return lut[x] + (((lut[x + 1] - lut[x]) * (index & ((1 << (bd - 8)) - 1)) +
                    (1 << (bd - 9))) >> (bd - 8));
}

static int sample_at(const void *p, size_t i, int hbd) {
  return hbd ? ((const uint16_t *)p)[i] : ((const uint8_t *)p)[i];
}

static void sample_set(void *p, size_t i, int hbd, int v) {
  if (hbd) ((uint16_t *)p)[i] = (uint16_t)v;
  else ((uint8_t *)p)[i] = (uint8_t)v;
}

/* Adds the film grain of g to the output planes in place (uint8 at 8
 * bits, else uint16; width x height luma, the chroma subsampled), as
 * libaom 3.14.1's av1_add_film_grain adds it to the frames it outputs:
 * the templates, then per 32-row stripe (its generator seeded from the
 * stripe's index) a 34x34 luma block of each template at offsets drawn
 * per 32x32 block, blended over the two columns (one where subsampled)
 * a block shares with the one before it and the rows a stripe shares
 * with the one above where overlap is set; the chroma scaled from the
 * co-located luma before the luma's own grain; clipped to the full or
 * the restricted range. Returns 0, or 2 when out of memory. */
int av1_film_grain(const int32_t *g, void *y, void *u, void *v, int width,
                   int height, int ssx, int ssy, int mono, int bd,
                   int32_t *stats) {
  const int hbd = bd > 8, lo_g = -(128 << (bd - 8)), hi_g = (128 << (bd - 8)) - 1;
  const int shift = 12 - bd + g[G_GRAIN_SCALE_SHIFT], lag = g[G_AR_LAG];
  const int cw_t = ssx ? 44 : 82, ch_t = ssy ? 38 : 73;
  const int cw = (width + ssx) >> ssx, ch = (height + ssy) >> ssy;
  const int stripe_w[3] = {width + 34, cw + 34, cw + 34};
  const int sub_x[3] = {0, ssx, ssx}, sub_y[3] = {0, ssy, ssy};
  int on[3];
  on[0] = g[G_NUM_Y] > 0;
  on[1] = !mono && (g[G_NUM_CB] > 0 || g[G_CSFL]);
  on[2] = !mono && (g[G_NUM_CR] > 0 || g[G_CSFL]);
  int16_t *tmpl = calloc(3 * 73 * 82, sizeof(int16_t));
  int16_t *noise[3] = {NULL, NULL, NULL}, *stripe[2][3] = {{NULL}};
  int *lut = malloc(3 * 256 * sizeof(int));
  int rc = 2;
  if (!tmpl || !lut) goto out;
  for (int p = 0; p < 3; p++) {
    if (!on[p]) continue;
    const size_t ph = (size_t)(p ? ch : height), pw = (size_t)(p ? cw : width);
    noise[p] = malloc(ph * pw * sizeof(int16_t));
    for (int k = 0; k < 2; k++)
      stripe[k][p] = calloc((size_t)(34 >> sub_y[p]) * (size_t)stripe_w[p], sizeof(int16_t));
    if (!noise[p] || !stripe[0][p] || !stripe[1][p]) goto out;
  }
  if (on[0])
    grain_template(tmpl, 73, 82, (uint16_t)g[G_SEED], shift, g + G_AR_Y, lag,
                   g[G_AR_SHIFT], lo_g, hi_g, NULL, 0, 0);
  for (int p = 1; p < 3; p++)
    if (on[p])
      grain_template(tmpl + p * 73 * 82, ch_t, cw_t,
                     (uint16_t)(g[G_SEED] ^ (p == 1 ? 0xB524 : 0x49D8)), shift,
                     g + (p == 1 ? G_AR_CB : G_AR_CR), lag, g[G_AR_SHIFT], lo_g,
                     hi_g, on[0] ? tmpl : NULL, ssx, ssy);
  /* the noise, stripe by stripe */
  for (int n = 0, y0 = 0; y0 < (height + 1) / 2; n++, y0 += 16) {
    int16_t *const *cur = stripe[n & 1], *const *prev = stripe[(n + 1) & 1];
    uint16_t r = (uint16_t)g[G_SEED];
    r ^= (uint16_t)((((n * 37 + 178) & 255) << 8) | ((n * 173 + 105) & 255));
    for (int x = 0; x < (width + 1) / 2; x += 16) {
      const int rnd = grain_bits(&r, 8), ox = rnd >> 4, oy = rnd & 15;
      for (int p = 0; p < 3; p++) {
        if (!on[p]) continue;
        const int sx = sub_x[p], sy = sub_y[p], sw = stripe_w[p];
        const int px = sx ? 6 + ox : 9 + 2 * ox, py = sy ? 6 + oy : 9 + 2 * oy;
        const int16_t *t = tmpl + p * 73 * 82;
        const int x0 = (2 * x) >> sx;
        for (int i = 0; i < (34 >> sy); i++)
          for (int j = 0; j < (34 >> sx); j++) {
            int v = t[(py + i) * 82 + px + j];
            int16_t *dst = &cur[p][i * sw + x0 + j];
            if (g[G_OVERLAP] && x && j < 2 - sx) {
              if (sx) v = *dst * 23 + v * 22;
              else v = j == 0 ? *dst * 27 + v * 17 : *dst * 17 + v * 27;
              v = clip3(lo_g, hi_g, round2(v, 5));
            }
            *dst = (int16_t)v;
          }
      }
      stats[AV1_STAT_GRAIN_BLOCKS]++;
    }
    for (int p = 0; p < 3; p++) {
      if (!on[p]) continue;
      const int sy = sub_y[p], rows = 32 >> sy, sw = stripe_w[p];
      const int ph = p ? ch : height, pw = p ? cw : width;
      for (int i = 0; i < rows && n * rows + i < ph; i++) {
        int16_t *dst = noise[p] + (size_t)(n * rows + i) * (size_t)pw;
        for (int x = 0; x < pw; x++) {
          int v = cur[p][i * sw + x];
          if (g[G_OVERLAP] && n && i < 2 - sy) {
            const int old = prev[p][(rows + i) * sw + x];
            if (sy) v = old * 23 + v * 22;
            else v = i == 0 ? old * 27 + v * 17 : old * 17 + v * 27;
            v = clip3(lo_g, hi_g, round2(v, 5));
          }
          dst[x] = (int16_t)v;
        }
      }
    }
  }
  /* the blend: the chroma first, from the luma before its grain */
  const int top = (256 << (bd - 8)) - 1, rs = g[G_SCALING_SHIFT];
  int lo = 0, hi_y = top, hi_c = top;
  if (g[G_CLIP]) {
    lo = 16 << (bd - 8);
    hi_y = 235 << (bd - 8);
    hi_c = g[G_MC_IDENTITY] ? hi_y : 240 << (bd - 8);
  }
  scaling_lut(g + G_Y_POINTS, g[G_NUM_Y], lut);
  scaling_lut(g + G_CB_POINTS, g[G_NUM_CB], lut + 256);
  scaling_lut(g + G_CR_POINTS, g[G_NUM_CR], lut + 512);
  for (int p = 1; p < 3; p++) {
    if (!on[p]) continue;
    void *c = p == 1 ? u : v;
    const int mult = g[p == 1 ? G_CB_MULT : G_CR_MULT];
    const int luma_mult = g[p == 1 ? G_CB_LUMA_MULT : G_CR_LUMA_MULT];
    const int offset = g[p == 1 ? G_CB_OFFSET : G_CR_OFFSET] * (1 << (bd - 8));
    const int *l = g[G_CSFL] ? lut : lut + 256 * p;
    for (int i = 0; i < ch; i++)
      for (int j = 0; j < cw; j++) {
        const size_t ly = (size_t)(i << ssy) * (size_t)width;
        const int lx = j << ssx;
        const int avg = ssx ? (sample_at(y, ly + (size_t)lx, hbd) +
                               sample_at(y, ly + (size_t)(lx + 1 < width ? lx + 1 : width - 1), hbd) + 1) >> 1
                            : sample_at(y, ly + (size_t)lx, hbd);
        const size_t at = (size_t)i * (size_t)cw + (size_t)j;
        const int orig = sample_at(c, at, hbd);
        const int merged = g[G_CSFL] ? avg
                           : clip3(0, top, ((avg * luma_mult + orig * mult) >> 6) + offset);
        const int nz = (scale_lut(l, merged, bd) * noise[p][at] + (1 << (rs - 1))) >> rs;
        sample_set(c, at, hbd, clip3(lo, hi_c, orig + nz));
      }
  }
  if (on[0])
    for (size_t at = 0; at < (size_t)width * (size_t)height; at++) {
      const int orig = sample_at(y, at, hbd);
      const int nz = (scale_lut(lut, orig, bd) * noise[0][at] + (1 << (rs - 1))) >> rs;
      sample_set(y, at, hbd, clip3(lo, hi_y, orig + nz));
    }
  stats[AV1_STAT_GRAIN_FRAMES]++;
  rc = 0;
out:
  for (int p = 0; p < 3; p++) {
    free(noise[p]);
    free(stripe[0][p]);
    free(stripe[1][p]);
  }
  free(tmpl);
  free(lut);
  return rc;
}

int av1_decode_frame(const int32_t *plan, const uint8_t *data, long len,
                     void *y_out, void *u_out, void *v_out,
                     int32_t *stats, char *err, int errlen) {
  Frame F;
  Frame *f = &F;
  memset(f, 0, sizeof(F));
  f->hdr = plan;
  f->stats = stats;
  f->err = err;
  f->errlen = errlen;
  memset(stats, 0, sizeof(int32_t) * AV1_NSTATS);
  f->width = plan[AV1_WIDTH];
  f->height = plan[AV1_HEIGHT];
  f->mono = plan[AV1_MONO];
  f->planes = f->mono ? 1 : 3;
  f->ssx = f->mono ? 1 : plan[AV1_SSX];
  f->ssy = f->mono ? 1 : plan[AV1_SSY];
  f->lossless = plan[AV1_LOSSLESS];
  f->bd = plan[AV1_BIT_DEPTH];
  f->mi_cols = 2 * ((f->width + 7) >> 3);
  f->mi_rows = 2 * ((f->height + 7) >> 3);
  f->sb4 = plan[AV1_SB128] ? 32 : 16;
  f->sb_size = plan[AV1_SB128] ? BLOCK_128X128 : BLOCK_64X64;
  const int sb_cols = (f->mi_cols + f->sb4 - 1) / f->sb4;
  const int sb_rows = (f->mi_rows + f->sb4 - 1) / f->sb4;
  f->mi_stride = sb_cols * f->sb4 + 1;
  const int mi_alloc = (sb_rows * f->sb4 + 1) * f->mi_stride;
  f->cdef_stride = sb_cols * f->sb4 / 16;
  int rc = 2;
  uint16_t *pre[3] = {NULL, NULL, NULL};
  Tile *t = calloc(1, sizeof(Tile));
  uint8_t *mi_block = calloc((size_t)mi_alloc, 9);
  f->delta_lf = calloc((size_t)mi_alloc, 4);
  f->pal_size = calloc((size_t)mi_alloc, 2);
  f->pal_colors = calloc((size_t)mi_alloc, 24 * sizeof(uint16_t));
  f->mvs = calloc((size_t)mi_alloc, 2 * sizeof(int16_t));
  if (t) t->above_txfm = malloc((size_t)(f->mi_cols + 64));
  const size_t n_cdef = (size_t)(sb_rows * sb_cols * (f->sb4 / 16) * (f->sb4 / 16));
  f->cdef_idx = malloc(n_cdef);
  if (!t || !mi_block || !f->delta_lf || !f->pal_size || !f->pal_colors ||
      !f->mvs || !t->above_txfm || !f->cdef_idx)
    goto done;
  memset(f->cdef_idx, -1, n_cdef);
  f->mi_size = mi_block;
  f->y_mode = mi_block + mi_alloc;
  f->uv_mode = mi_block + 2 * mi_alloc;
  f->skip = mi_block + 3 * mi_alloc;
  f->tx_size_mi = mi_block + 4 * mi_alloc;
  f->is_inter = mi_block + 5 * mi_alloc;
  f->written = mi_block + 6 * mi_alloc;
  f->tx_type_mi = mi_block + 7 * mi_alloc;
  f->seg_map = mi_block + 8 * mi_alloc;
  stats[AV1_STAT_SEG_FRAMES] = plan[AV1_SEG_ENABLED];
  for (int p = 0; p < f->planes; p++) {
    const int sx = p ? f->ssx : 0, sy = p ? f->ssy : 0;
    f->stride[p] = (sb_cols * f->sb4 * 4) >> sx;
    f->alloc_h[p] = (sb_rows * f->sb4 * 4) >> sy;
    f->frame[p] = calloc((size_t)f->stride[p] * (size_t)f->alloc_h[p], sizeof(uint16_t));
    f->lf_stride[p] = f->stride[p] / 4;
    f->lf_txsz[p] = calloc((size_t)f->lf_stride[p] * (size_t)(f->alloc_h[p] / 4), 1);
    t->above_ctx[p] = calloc((size_t)(f->mi_cols + 64), 1);
    const int size = plan[AV1_LR_UNIT + p];
    f->lr_rows[p] = lr_unit_count(size, (f->height + sy) >> sy);
    f->lr_cols[p] = lr_unit_count(size, (f->width + sx) >> sx);
    f->lr[p] = calloc((size_t)f->lr_rows[p] * (size_t)f->lr_cols[p], sizeof(LrUnit));
    if (!f->frame[p] || !f->lf_txsz[p] || !t->above_ctx[p] || !f->lr[p]) goto done;
  }
  t->f = f;
  const int tile_cols = plan[AV1_TILE_COLS], tile_rows = plan[AV1_TILE_ROWS];
  for (int tr = 0; tr < tile_rows; tr++)
    for (int tc = 0; tc < tile_cols; tc++) {
      const int n = tr * tile_cols + tc;
      const long off = plan[AV1_TILES + 2 * n], size = plan[AV1_TILES + 2 * n + 1];
      if (off < 0 || size <= 0 || off + size > len) {
        fail(f, "AV1: a tile's bytes lie outside the frame OBU");
        rc = 1;
        goto done;
      }
      t->mi_row_start = plan[AV1_ROW_STARTS + tr];
      t->mi_row_end = plan[AV1_ROW_STARTS + tr + 1];
      t->mi_col_start = plan[AV1_COL_STARTS + tc];
      t->mi_col_end = plan[AV1_COL_STARTS + tc + 1];
      decode_tile(t, data + off, size);
      stats[AV1_STAT_TILES]++;
      if (f->failed) {
        rc = 1;
        goto done;
      }
    }
  loop_filter(f);
  const int lr = !plan[AV1_NO_LR] &&
                 (plan[AV1_LR_TYPE] || plan[AV1_LR_TYPE + 1] || plan[AV1_LR_TYPE + 2]);
  if (!plan[AV1_NO_CDEF] && (plan[AV1_ENABLE_CDEF] || lr)) {
    for (int p = 0; p < f->planes; p++) { /* the deblocked frame */
      const size_t n = sizeof(uint16_t) * (size_t)f->stride[p] * (size_t)f->alloc_h[p];
      pre[p] = malloc(n);
      if (!pre[p]) goto done;
      memcpy(pre[p], f->frame[p], n);
    }
    if (plan[AV1_ENABLE_CDEF]) cdef(f, pre);
    if (lr && loop_restoration(f, pre)) goto done;
  }
  for (int p = 0; p < f->planes; p++) { /* uint8 at 8 bits, else uint16 */
    void *out = p == 0 ? y_out : p == 1 ? u_out : v_out;
    const int sx = p ? f->ssx : 0, sy = p ? f->ssy : 0;
    const size_t w = (size_t)((f->width + sx) >> sx);
    const int h = (f->height + sy) >> sy;
    for (int y = 0; y < h; y++) {
      const uint16_t *row = f->frame[p] + (size_t)y * (size_t)f->stride[p];
      if (f->bd == 8)
        for (size_t x = 0; x < w; x++) ((uint8_t *)out)[(size_t)y * w + x] = (uint8_t)row[x];
      else
        memcpy((uint16_t *)out + (size_t)y * w, row, w * sizeof(uint16_t));
    }
  }
  rc = 0;
done:
  if (rc == 2 && !f->failed) snprintf(err, (size_t)errlen, "AV1: out of memory");
  for (int p = 0; p < 3; p++) {
    free(f->frame[p]);
    free(f->lf_txsz[p]);
    free(f->lr[p]);
    free(pre[p]);
    if (t) free(t->above_ctx[p]);
  }
  if (t) free(t->above_txfm);
  free(t);
  free(mi_block);
  free(f->mvs);
  free(f->delta_lf);
  free(f->pal_size);
  free(f->pal_colors);
  free(f->cdef_idx);
  return rc;
}
