/* Host image codec of the port: JPEG decoding, cv2's INTER_LINEAR
 * resize on uint8 and on two-channel float32, its INTER_AREA on float32,
 * and cv2.fillPoly, in plain C99 with no library.
 *
 * decode_jpeg decodes as libjpeg-turbo 3 does under OpenCV 5's reader:
 * baseline and extended sequential (SOF0, SOF1) and progressive (SOF2)
 * Huffman-coded frames of 8-bit samples, 1, 3 or 4 components. Scans
 * fill a coefficient buffer for the whole image (jdhuff.c and jdphuff.c:
 * DC first and refine scans, AC first and refine scans with EOB runs,
 * restart intervals in every scan); then every block goes through
 * libjpeg-turbo's ISLOW IDCT in the arithmetic of its SIMD code (16-bit
 * dequantisation and sums, the first pass saturated to 16 bits, the
 * whole-block zero-AC shortcut), fancy upsampling where libjpeg-turbo
 * takes it and box upsampling elsewhere, and the colour conversion of
 * jdcolor.c: fixed-point YCbCr -> RGB, none for RGB JPEGs (Adobe
 * transform 0, or component ids 'R', 'G', 'B'), YCCK -> CMYK, and for 4
 * components OpenCV's CMYK -> BGR (c' = k - ((255 - c) * k >> 8)). It
 * writes RGB; the Exif orientation is applied by the caller.
 *
 * A stream whose data ends early is refused, as cv2.imdecode refuses it,
 * unless the caller passes `eof_fill` (cv2.imread of a file: libjpeg's
 * file source appends an EOI): then the block in which the data ran out
 * is decoded with zero bits, and every later block of the scan keeps
 * zero coefficients (mid-gray), as jdhuff.c's `insufficient_data` does.
 * A progressive image whose coefficients 1..9 do not all reach their
 * last bit (Al = 0) would take libjpeg's inter-block smoothing
 * (jdcoefct.c decompress_smooth_data); that is refused by name, as are
 * lossless, hierarchical and arithmetic-coded frames, 12-bit samples and
 * corrupt streams. `utils/jpeg.py` is the plain version of the baseline
 * part and refuses the rest by name.
 *
 * resize_linear_u8 is cv2.resize(..., INTER_LINEAR) on uint8: 11-bit
 * fixed-point weights from float32 source coordinates, an exact integer
 * horizontal pass, and the vertical pass of cv2's vectorised code,
 * (((S0 >> 4) * b0) >> 16) + (((S1 >> 4) * b1) >> 16), rounded by
 * (+ 2) >> 2. Rows are never clamped: above the first source row and
 * below the last the weights stay as computed and both rows are the edge.
 *
 * resize_linear_f32 and resize_area_f32 are cv2's float32 paths for the
 * segmentation coverage maps (OpenCV's own code; for INTER_LINEAR cv2
 * 5.0 takes it on two channels and hands one, three and four to IPP), and
 * fill_polygons is cv2.fillPoly with 8-connected lines and shift 0; each
 * is described where it is defined. Their plain versions are
 * utils/image_io.py resize_linear_plain, resize_area_plain and
 * data/masks.py fill_polygons_plain.
 *
 * Built by `kernels.py load_host` with `cc -O2 -std=c99 -shared -fPIC`;
 * called through ctypes.
 */

#include <setjmp.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* Errors: a failure longjmps back to the entry point, which frees.    */

typedef struct {
    jmp_buf jump;
    char *err;
    int err_len;
} Fail;

static void fail(Fail *f, const char *msg)
{
    if (f->err && f->err_len > 0) {
        snprintf(f->err, (size_t)f->err_len, "JPEG: %s", msg);
    }
    longjmp(f->jump, 1);
}

/* ------------------------------------------------------------------ */
/* The frame.                                                          */

typedef struct {
    uint16_t lookup[512]; /* 9-bit lookahead: length << 8 | symbol, or 0 */
    int32_t maxcode[18];  /* largest code of each length, -1 if none */
    int32_t valoffset[18];
    uint8_t values[256];
    int defined;
} Huff;

typedef struct {
    int cid, h, v, tq;
    int width, height;     /* downsampled size */
    int blocks_w, blocks_h;
    int16_t *coef;         /* blocks_h * blocks_w blocks, row-major */
    int32_t q[64];         /* the table latched at its first scan */
    int latched;
    int coef_bits[64];     /* progressive: Al of each coefficient, -1 */
    uint8_t *plane;        /* blocks_h * 8 rows of blocks_w * 8 samples */
} Comp;

typedef struct {
    Fail f;
    const uint8_t *data;
    long n;
    int width, height, ncomp, hmax, vmax, progressive;
    Comp comp[4];
    int32_t qt[4][64]; /* row-major */
    int qt_defined[4];
    Huff huff[2][4];
    int restart;
    int jfif, adobe, adobe_transform, scans;
    /* entropy decoder */
    long pos;            /* next byte */
    uint64_t acc;        /* bit accumulator, MSB first */
    int nacc;            /* valid bits in acc */
    long real_bits;      /* bits taken from the stream */
    long used_bits;      /* bits the decoder consumed */
    int marker_hit;
    int eof_fill;        /* the data may end early: fill as libjpeg */
    int at_eof;          /* the data ended (not a marker) */
    int insufficient;    /* ran out of data: later blocks stay zero */
    int eobrun;
    uint8_t *scratch;    /* upsampled rows, column sums, colour tables */
} Jpeg;

static const int zigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

static int u16be(const uint8_t *p) { return (p[0] << 8) | p[1]; }

/* The marker at j->pos (fill bytes skipped); j->pos moves past it. */
static int next_marker(Jpeg *j)
{
    char msg[64];
    if (j->pos >= j->n) {
        if (j->eof_fill) return 0xD9;
        fail(&j->f, "truncated stream (no EOI)");
    }
    if (j->data[j->pos] != 0xFF) {
        snprintf(msg, sizeof msg, "expected a marker at byte %ld", j->pos);
        fail(&j->f, msg);
    }
    while (j->pos < j->n && j->data[j->pos] == 0xFF) j->pos++;
    if (j->pos >= j->n) fail(&j->f, "truncated stream (no EOI)");
    return j->data[j->pos++];
}

/* Payload bounds of the segment whose length field is at j->pos. */
static void segment(Jpeg *j, long *start, long *end)
{
    int length;
    if (j->pos + 2 > j->n) fail(&j->f, "truncated marker segment");
    length = u16be(j->data + j->pos);
    if (length < 2 || j->pos + length > j->n)
        fail(&j->f, "truncated marker segment");
    *start = j->pos + 2;
    *end = j->pos + length;
    j->pos = *end;
}

static void parse_sof(Jpeg *j, const uint8_t *p, long len, int progressive)
{
    char msg[96];
    int i, precision, nc, mcus_x, mcus_y;
    if (j->ncomp) fail(&j->f, "more than one frame");
    if (len < 6) fail(&j->f, "truncated SOF");
    precision = p[0];
    j->height = u16be(p + 1);
    j->width = u16be(p + 3);
    nc = p[5];
    if (precision != 8) {
        snprintf(msg, sizeof msg,
                 "%d-bit samples are not read (8-bit only)", precision);
        fail(&j->f, msg);
    }
    if (nc != 1 && nc != 3 && nc != 4) {
        snprintf(msg, sizeof msg, "%d-component images are not read "
                 "(gray, YCbCr, RGB, CMYK or YCCK only)", nc);
        fail(&j->f, msg);
    }
    if (j->height == 0 || j->width == 0) {
        snprintf(msg, sizeof msg, "bad size %dx%d (DNL is not read)",
                 j->width, j->height);
        fail(&j->f, msg);
    }
    if (j->height > 65500 || j->width > 65500)
        fail(&j->f, "image larger than 65500 pixels a side");
    if (len < 6 + 3 * nc) fail(&j->f, "truncated SOF");
    j->hmax = j->vmax = 1;
    for (i = 0; i < nc; i++) {
        Comp *c = &j->comp[i];
        c->cid = p[6 + 3 * i];
        c->h = p[7 + 3 * i] >> 4;
        c->v = p[7 + 3 * i] & 15;
        c->tq = p[8 + 3 * i];
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3) {
            snprintf(msg, sizeof msg,
                     "bad sampling factors or table in component %d",
                     c->cid);
            fail(&j->f, msg);
        }
        if (c->h > j->hmax) j->hmax = c->h;
        if (c->v > j->vmax) j->vmax = c->v;
    }
    j->ncomp = nc;
    j->progressive = progressive;
    mcus_x = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
    mcus_y = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
    for (i = 0; i < nc; i++) {
        Comp *c = &j->comp[i];
        size_t size;
        if (j->hmax % c->h || j->vmax % c->v)
            fail(&j->f, "fractional sampling factors are not read");
        c->width = (int)(((long)j->width * c->h + j->hmax - 1) / j->hmax);
        c->height = (int)(((long)j->height * c->v + j->vmax - 1) / j->vmax);
        c->blocks_w = mcus_x * c->h;
        c->blocks_h = mcus_y * c->v;
        size = (size_t)c->blocks_w * 8 * (size_t)c->blocks_h * 8;
        c->plane = (uint8_t *)malloc(size);
        c->coef = (int16_t *)calloc(size, sizeof(int16_t));
        if (!c->plane || !c->coef) fail(&j->f, "out of memory");
        memset(c->coef_bits, 0xFF, sizeof c->coef_bits); /* all -1 */
    }
}

static void parse_dqt(Jpeg *j, const uint8_t *p, long len)
{
    long pos = 0;
    int k;
    while (pos < len) {
        int pq = p[pos] >> 4, tq = p[pos] & 15, size = pq ? 128 : 64;
        if (pq > 1 || tq > 3 || pos + 1 + size > len) fail(&j->f, "bad DQT");
        for (k = 0; k < 64; k++) {
            j->qt[tq][zigzag[k]] = pq ? u16be(p + pos + 1 + 2 * k)
                                      : p[pos + 1 + k];
        }
        j->qt_defined[tq] = 1;
        pos += 1 + size;
    }
}

static void parse_dht(Jpeg *j, const uint8_t *p, long len)
{
    long pos = 0;
    while (pos < len) {
        int tc, th, total = 0, l, i, k = 0;
        int32_t code = 0;
        Huff *t;
        if (pos + 17 > len) fail(&j->f, "bad DHT");
        tc = p[pos] >> 4;
        th = p[pos] & 15;
        for (l = 1; l <= 16; l++) total += p[pos + l];
        if (tc > 1 || th > 3 || total > 256 || pos + 17 + total > len)
            fail(&j->f, "bad DHT");
        t = &j->huff[tc][th];
        memset(t, 0, sizeof *t);
        memcpy(t->values, p + pos + 17, (size_t)total);
        for (l = 1; l <= 16; l++) {
            int count = p[pos + l];
            t->valoffset[l] = k - code;
            for (i = 0; i < count; i++) {
                if (code >= (1 << l)) fail(&j->f, "bad Huffman table");
                if (l <= 9) {
                    int span = 1 << (9 - l), s, start = code << (9 - l);
                    for (s = 0; s < span; s++)
                        t->lookup[start + s] =
                            (uint16_t)((l << 8) | t->values[k]);
                }
                code++;
                k++;
            }
            t->maxcode[l] = count ? code - 1 : -1;
            code <<= 1;
        }
        t->maxcode[17] = 0x7FFFFFFF;
        t->defined = 1;
        pos += 17 + total;
    }
}

/* ------------------------------------------------------------------ */
/* Entropy-coded data.                                                 */

/* Tops the accumulator up to more than 56 bits; past a marker (or the end
 * of the data, which sets at_eof) it feeds zero bits: an MCU that used
 * them is refused, or with eof_fill at the end of the data marks the
 * rest of the scan as insufficient (end_mcu). */
static void fill(Jpeg *j)
{
    while (j->nacc <= 56) {
        int b = 0;
        if (!j->marker_hit && j->pos >= j->n) {
            j->marker_hit = j->at_eof = 1;
        } else if (!j->marker_hit) {
            b = j->data[j->pos];
            if (b == 0xFF) {
                long q = j->pos + 1;
                while (q < j->n && j->data[q] == 0xFF) q++;
                if (q < j->n && j->data[q] == 0x00) {
                    j->pos = q + 1;
                    j->real_bits += 8;
                } else {
                    j->marker_hit = 1; /* leave pos on the marker */
                    if (q >= j->n) j->at_eof = 1;
                    b = 0;
                }
            } else {
                j->pos++;
                j->real_bits += 8;
            }
        }
        j->acc |= (uint64_t)b << (56 - j->nacc);
        j->nacc += 8;
    }
}

/* The decoder's bit state lives in locals of decode_block: `acc` holds
 * `nacc` bits, MSB first. */
#define LOAD_BITS() (acc = j->acc, nacc = j->nacc)
#define SAVE_BITS() (j->acc = acc, j->nacc = nacc)
#define NEED_BITS(n) \
    do { if (nacc < (n)) { SAVE_BITS(); fill(j); LOAD_BITS(); } } while (0)
#define DROP_BITS(n) (acc <<= (n), nacc -= (n), used += (n))

/* Codes longer than 9 bits: jdhuff.c's maxcode walk. */
static int slow_symbol(Jpeg *j, const Huff *t, uint64_t acc, int *length)
{
    int l;
    for (l = 10; l <= 16; l++) {
        int32_t code = (int32_t)(acc >> (64 - l));
        if (t->maxcode[l] >= 0 && code <= t->maxcode[l]) {
            *length = l;
            return t->values[t->valoffset[l] + code];
        }
    }
    fail(&j->f, "corrupt Huffman code");
    return 0;
}

static int extend(int v, int s)
{
    return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

/* One block's coefficients (row-major, 16-bit); returns the DC value.
 * The caller checks, per MCU, whether it used bits past the data. */
static int decode_block(Jpeg *j, const Huff *dc, const Huff *ac, int pred,
                        int16_t *out)
{
    uint64_t acc;
    int nacc, s, k, v, look, l;
    long used = 0;
    LOAD_BITS();
    memset(out, 0, 64 * sizeof *out);
    NEED_BITS(32);
    look = dc->lookup[acc >> (64 - 9)];
    if (look) {
        l = look >> 8;
        s = look & 0xFF;
    } else {
        s = slow_symbol(j, dc, acc, &l);
    }
    DROP_BITS(l);
    if (s > 15) fail(&j->f, "corrupt DC code");
    v = s ? (int)(acc >> (64 - s)) : 0;
    DROP_BITS(s);
    v = pred + extend(v, s);
    v = (int16_t)(uint16_t)(v & 0xFFFF); /* JCOEF is 16-bit */
    out[0] = (int16_t)v;
    for (k = 1; k < 64;) {
        int rs, r;
        NEED_BITS(32);
        look = ac->lookup[acc >> (64 - 9)];
        if (look) {
            l = look >> 8;
            rs = look & 0xFF;
        } else {
            rs = slow_symbol(j, ac, acc, &l);
        }
        DROP_BITS(l);
        r = rs >> 4;
        s = rs & 15;
        if (s == 0) {
            if (r != 15) break;
            k += 16;
            continue;
        }
        k += r;
        if (k > 63) fail(&j->f, "corrupt AC run");
        out[zigzag[k]] = (int16_t)extend((int)(acc >> (64 - s)), s);
        DROP_BITS(s);
        k++;
    }
    SAVE_BITS();
    j->used_bits += used;
    return v;
}

/* Progressive scans (jdphuff.c), one bit request at a time. */
static int get_bits(Jpeg *j, int n)
{
    int v;
    if (!n) return 0;
    if (j->nacc < n) fill(j);
    v = (int)(j->acc >> (64 - n));
    j->acc <<= n;
    j->nacc -= n;
    j->used_bits += n;
    return v;
}

static int huff_symbol(Jpeg *j, const Huff *t)
{
    int look, l, s;
    if (j->nacc < 16) fill(j);
    look = t->lookup[j->acc >> (64 - 9)];
    if (look) {
        l = look >> 8;
        s = look & 0xFF;
    } else {
        s = slow_symbol(j, t, j->acc, &l);
    }
    j->acc <<= l;
    j->nacc -= l;
    j->used_bits += l;
    return s;
}

/* jpeg_natural_order with its 16 extra entries of 63, which a progressive
 * run past the band writes into. */
static int natural(int k) { return k > 63 ? 63 : zigzag[k]; }

static void dc_first(Jpeg *j, const Huff *dc, int *pred, int al,
                     int16_t *blk)
{
    int s = huff_symbol(j, dc);
    if (s > 16) fail(&j->f, "corrupt DC code");
    if (s) s = extend(get_bits(j, s), s);
    *pred += s;
    blk[0] = (int16_t)(uint16_t)((unsigned)*pred << al);
}

static void dc_refine(Jpeg *j, int al, int16_t *blk)
{
    if (get_bits(j, 1)) blk[0] = (int16_t)(blk[0] | (1 << al));
}

static void ac_first(Jpeg *j, const Huff *ac, int ss, int se, int al,
                     int16_t *blk)
{
    int k;
    if (j->eobrun > 0) {
        j->eobrun--;
        return;
    }
    for (k = ss; k <= se; k++) {
        int rs = huff_symbol(j, ac), r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            s = extend(get_bits(j, s), s);
            blk[natural(k)] = (int16_t)(uint16_t)((unsigned)s << al);
        } else if (r == 15) {
            k += 15;
        } else {
            j->eobrun = (1 << r) + get_bits(j, r) - 1;
            break;
        }
    }
}

/* A correction bit for an already nonzero coefficient. */
static void refine_coef(Jpeg *j, int16_t *c, int p1)
{
    if (get_bits(j, 1) && (*c & p1) == 0)
        *c = (int16_t)(*c >= 0 ? *c + p1 : *c - p1);
}

static void ac_refine(Jpeg *j, const Huff *ac, int ss, int se, int al,
                      int16_t *blk)
{
    int p1 = 1 << al, k = ss;
    if (j->eobrun == 0) {
        for (; k <= se; k++) {
            int rs = huff_symbol(j, ac), r = rs >> 4, s = rs & 15;
            if (s) {
                s = get_bits(j, 1) ? p1 : -p1;
            } else if (r != 15) {
                j->eobrun = (1 << r) + get_bits(j, r);
                break;
            }
            do {
                int16_t *c = blk + zigzag[k];
                if (*c) refine_coef(j, c, p1);
                else if (--r < 0) break;
                k++;
            } while (k <= se);
            if (s) blk[natural(k)] = (int16_t)s;
        }
    }
    if (j->eobrun > 0) {
        for (; k <= se; k++) {
            int16_t *c = blk + zigzag[k];
            if (*c) refine_coef(j, c, p1);
        }
        j->eobrun--;
    }
}

/* ------------------------------------------------------------------ */
/* The inverse DCT (jidctint.c, as its SIMD code computes it).         */

#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172

static int32_t i16(int32_t x) { return (int16_t)(uint16_t)(x & 0xFFFF); }

/* One 8-point pass over in[0], in[stride], ...: the eight sums before
 * the descale. */
static void idct_1d(const int32_t *in, int stride, int64_t *out)
{
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3;
    int64_t tmp10, tmp11, tmp12, tmp13, t0, t1, t2, t3;
    z2 = in[2 * stride];
    z3 = in[6 * stride];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 - z3 * FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = (int64_t)i16(in[0] + in[4 * stride]) * 8192;
    tmp1 = (int64_t)i16(in[0] - in[4 * stride]) * 8192;
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;

    t0 = in[7 * stride];
    t1 = in[5 * stride];
    t2 = in[3 * stride];
    t3 = in[1 * stride];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = i16((int32_t)(t0 + t2));
    z4 = i16((int32_t)(t1 + t3));
    z5 = (z3 + z4) * FIX_1_175875602;
    t0 *= FIX_0_298631336;
    t1 *= FIX_2_053119869;
    t2 *= FIX_3_072711026;
    t3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    out[0] = tmp10 + t3;
    out[1] = tmp11 + t2;
    out[2] = tmp12 + t1;
    out[3] = tmp13 + t0;
    out[4] = tmp13 - t0;
    out[5] = tmp12 - t1;
    out[6] = tmp11 - t2;
    out[7] = tmp10 - t3;
}

static int32_t sat16(int64_t v)
{
    return (int32_t)(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}

static void idct_islow(const int16_t *coef, const int32_t *q, uint8_t *dst,
                       int dst_stride)
{
    int32_t dq[64], ws[64];
    int64_t out[8];
    int x, y, k, block_ac_zero = 1;
    for (k = 8; k < 64; k++) {
        if (coef[k]) { block_ac_zero = 0; break; }
    }
    for (k = 0; k < 64; k++) dq[k] = i16((int32_t)coef[k] * q[k]);
    for (x = 0; x < 8; x++) {
        int col_ac_zero = 1;
        if (block_ac_zero) {
            /* The SIMD shortcut: a 16-bit shift, for the whole block. */
            int32_t v = i16(dq[x] * 4);
            for (y = 0; y < 8; y++) ws[y * 8 + x] = v;
            continue;
        }
        for (y = 1; y < 8; y++) {
            if (dq[y * 8 + x]) { col_ac_zero = 0; break; }
        }
        if (col_ac_zero) {
            /* What the full pass computes for such a column. */
            int32_t v = sat16((int64_t)dq[x] * 4);
            for (y = 0; y < 8; y++) ws[y * 8 + x] = v;
            continue;
        }
        idct_1d(dq + x, 8, out);
        for (y = 0; y < 8; y++) ws[y * 8 + x] = sat16((out[y] + (1 << 10)) >> 11);
    }
    for (y = 0; y < 8; y++) {
        const int32_t *w = ws + y * 8;
        uint8_t *o = dst + y * dst_stride;
        if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
            /* What the full pass computes for such a row. */
            int32_t v = (w[0] + 16) >> 5;
            v = v < -128 ? -128 : v > 127 ? 127 : v;
            for (x = 0; x < 8; x++) o[x] = (uint8_t)(v + 128);
            continue;
        }
        idct_1d(w, 1, out);
        for (x = 0; x < 8; x++) {
            int64_t v = (out[x] + (1 << 17)) >> 18;
            v = v < -128 ? -128 : v > 127 ? 127 : v;
            o[x] = (uint8_t)(v + 128);
        }
    }
}

/* ------------------------------------------------------------------ */
/* Scans.                                                              */

/* The EOI that libjpeg's file source appends where the data ends. */
#define EOF_MARKER 0x1D9

/* From j->pos, skip entropy-coded bytes to the next marker and return
 * it (j->pos then follows it). Where the data ends first: EOF_MARKER
 * with eof_fill, else a refusal. */
static int marker_after_data(Jpeg *j)
{
    for (;;) {
        long q;
        while (j->pos < j->n && j->data[j->pos] != 0xFF) j->pos++;
        q = j->pos + 1;
        while (q < j->n && j->data[q] == 0xFF) q++;
        if (q >= j->n) {
            if (j->eof_fill) {
                j->pos = j->n;
                return EOF_MARKER;
            }
            fail(&j->f, "truncated stream (no marker after the scan)");
        }
        if (j->data[q] != 0x00) {
            j->pos = q + 1;
            return j->data[q];
        }
        j->pos = q + 1;
    }
}

/* jdphuff.c's checks of a progressive scan's Ss, Se, Ah and Al, and the
 * update of each coefficient's Al (coef_bits). A scan whose Ah does not
 * follow the last one (libjpeg warns and decodes) is refused. */
static void progression(Jpeg *j, Comp **comps, int ns, int ss, int se,
                        int ah, int al)
{
    int i, k, bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13 || bad)
        fail(&j->f, "bad progressive scan parameters");
    for (i = 0; i < ns; i++) {
        Comp *c = comps[i];
        if (ss != 0 && c->coef_bits[0] < 0)
            fail(&j->f, "progressive AC scan before the DC scan");
        for (k = ss; k <= se; k++) {
            if (ah != (c->coef_bits[k] < 0 ? 0 : c->coef_bits[k]))
                fail(&j->f, "progressive scans out of order");
            c->coef_bits[k] = al;
        }
    }
}

/* After an MCU: bits used past the data are a refusal, or with eof_fill
 * at the end of the data the start of jdhuff.c's insufficient_data. */
static void end_mcu(Jpeg *j)
{
    if (j->used_bits <= j->real_bits) return;
    if (!(j->eof_fill && j->at_eof))
        fail(&j->f, "truncated or corrupt entropy-coded data");
    j->insufficient = 1;
}

static void decode_scan(Jpeg *j, const uint8_t *p, long len)
{
    Comp *comps[4];
    const Huff *dc[4], *ac[4];
    int ns, i, units_x, units_y, per_interval, interval = 0, expect = 0;
    int ss, se, ah, al;
    long total, u;
    char msg[96];
    ns = len > 0 ? p[0] : 0;
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) fail(&j->f, "bad SOS");
    ss = p[1 + 2 * ns];
    se = p[2 + 2 * ns];
    ah = p[3 + 2 * ns] >> 4;
    al = p[3 + 2 * ns] & 15;
    for (i = 0; i < ns; i++) {
        int cid = p[1 + 2 * i], t = p[2 + 2 * i], c, need_dc, need_ac;
        comps[i] = NULL;
        for (c = 0; c < j->ncomp; c++) {
            if (j->comp[c].cid == cid) comps[i] = &j->comp[c];
        }
        if (!comps[i]) {
            snprintf(msg, sizeof msg, "SOS names unknown component %d", cid);
            fail(&j->f, msg);
        }
        /* Progressive scans use one kind of table, first DC scans only. */
        need_dc = !j->progressive || (ss == 0 && ah == 0);
        need_ac = !j->progressive || ss != 0;
        if ((t >> 4) > 3 || (t & 15) > 3
            || (need_dc && !j->huff[0][t >> 4].defined)
            || (need_ac && !j->huff[1][t & 15].defined))
            fail(&j->f, "SOS uses an undefined Huffman table");
        dc[i] = &j->huff[0][t >> 4];
        ac[i] = &j->huff[1][t & 15];
        if (!comps[i]->latched) {
            if (!j->qt_defined[comps[i]->tq])
                fail(&j->f, "component uses an undefined quantisation "
                            "table");
            memcpy(comps[i]->q, j->qt[comps[i]->tq], sizeof comps[i]->q);
            comps[i]->latched = 1;
        }
    }
    if (j->progressive) progression(j, comps, ns, ss, se, ah, al);
    if (ns == 1) {
        units_x = (comps[0]->width + 7) / 8;
        units_y = (comps[0]->height + 7) / 8;
    } else {
        int blocks = 0;
        for (i = 0; i < ns; i++) blocks += comps[i]->h * comps[i]->v;
        if (blocks > 10) fail(&j->f, "too many blocks in an MCU");
        units_x = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
        units_y = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
    }
    total = (long)units_x * units_y;
    per_interval = j->restart ? j->restart : (int)total;
    j->insufficient = 0;
    for (interval = 0, u = 0; u < total; interval++) {
        int preds[4] = {0, 0, 0, 0};
        long end = u + per_interval < total ? u + per_interval : total;
        int m, eof = j->at_eof;
        if (interval > 0 && !eof) {
            m = marker_after_data(j);
            if (m == EOF_MARKER) {
                eof = 1;
            } else if (m < 0xD0 || m > 0xD7) {
                snprintf(msg, sizeof msg, "%d restart intervals, want %ld",
                         interval, (total + per_interval - 1) / per_interval);
                fail(&j->f, msg);
            } else if (m != 0xD0 + expect) {
                snprintf(msg, sizeof msg,
                         "restart marker RST%d out of order", m - 0xD0);
                fail(&j->f, msg);
            }
            expect = (expect + 1) & 7;
        }
        /* Past the end of the data (eof_fill) every interval reads zero
         * bits; the flag of the last one stays set, as in process_restart
         * with the appended EOI unread. */
        j->acc = 0;
        j->nacc = 0;
        j->marker_hit = j->at_eof = eof;
        j->real_bits = j->used_bits = 0;
        j->eobrun = 0;
        for (; u < end; u++) {
            int uy = (int)(u / units_x), ux = (int)(u % units_x);
            if (j->insufficient) continue;
            for (i = 0; i < ns; i++) {
                Comp *c = comps[i];
                int v = ns == 1 ? 1 : c->v, h = ns == 1 ? 1 : c->h, by, bx;
                for (by = 0; by < v; by++) {
                    for (bx = 0; bx < h; bx++) {
                        int row = uy * v + by, col = ux * h + bx;
                        int16_t *blk = c->coef
                            + ((size_t)row * c->blocks_w + col) * 64;
                        if (!j->progressive)
                            preds[i] = decode_block(j, dc[i], ac[i],
                                                    preds[i], blk);
                        else if (ss == 0 && ah == 0)
                            dc_first(j, dc[i], &preds[i], al, blk);
                        else if (ss == 0)
                            dc_refine(j, al, blk);
                        else if (ah == 0)
                            ac_first(j, ac[i], ss, se, al, blk);
                        else
                            ac_refine(j, ac[i], ss, se, al, blk);
                    }
                }
            }
            end_mcu(j);
        }
    }
    /* The marker after the scan must not be another restart marker. */
    {
        int m;
        long save;
        if (j->at_eof) {
            j->pos = j->n;
            return;
        }
        m = marker_after_data(j);
        if (m == EOF_MARKER) return;
        if (m >= 0xD0 && m <= 0xD7) {
            snprintf(msg, sizeof msg, "%d restart intervals, want %ld",
                     interval + 1,
                     (total + per_interval - 1) / per_interval);
            fail(&j->f, msg);
        }
        /* Step back onto the marker for the header parser. */
        save = j->pos - 1;
        while (save > 0 && j->data[save - 1] == 0xFF) save--;
        j->pos = save;
    }
}

/* Every block of every component through the IDCT, after the scans. */
static void inverse_dct(Jpeg *j)
{
    int i, by, bx;
    for (i = 0; i < j->ncomp; i++) {
        Comp *c = &j->comp[i];
        int stride = c->blocks_w * 8;
        for (by = 0; by < c->blocks_h; by++) {
            for (bx = 0; bx < c->blocks_w; bx++) {
                idct_islow(c->coef + ((size_t)by * c->blocks_w + bx) * 64,
                           c->q, c->plane + (size_t)by * 8 * stride
                                     + (size_t)bx * 8, stride);
            }
        }
    }
}

/* libjpeg's smoothing_ok: a progressive image takes inter-block
 * smoothing where every component's DC has been seen and some
 * component's coefficient 1..9 has not reached Al = 0. */
static int takes_smoothing(const Jpeg *j)
{
    int i, k, useful = 0;
    if (!j->progressive) return 0;
    for (i = 0; i < j->ncomp; i++) {
        if (j->comp[i].coef_bits[0] < 0) return 0;
        for (k = 1; k < 10; k++) useful |= j->comp[i].coef_bits[k] != 0;
    }
    return useful;
}

/* ------------------------------------------------------------------ */
/* Upsampling and colour (jdsample.c, jdcolor.c).                      */

static int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

/* 2x horizontal fancy upsampling of in[0:cw] into o[0:W]:
 * o[2c] = (3 in[c] + in[c-1] + bl) >> shift and
 * o[2c+1] = (3 in[c] + in[c+1] + br) >> shift, edges replicated. */
static void fancy_h2(const int *in, int cw, uint8_t *o, int W, int bl,
                     int br, int shift)
{
    int cx;
    for (cx = 0; cx < cw && 2 * cx < W; cx++) {
        int s = 3 * in[cx];
        int left = in[cx > 0 ? cx - 1 : 0];
        int right = in[cx + 1 < cw ? cx + 1 : cx];
        o[2 * cx] = (uint8_t)((s + left + bl) >> shift);
        if (2 * cx + 1 < W) o[2 * cx + 1] = (uint8_t)((s + right + br) >> shift);
    }
}

/* Output row y of component c upsampled to the frame's width, into o;
 * `sums` holds c->width ints. */
static void upsample_row(const Jpeg *j, const Comp *c, int y, uint8_t *o,
                         int *sums)
{
    int fh = j->hmax / c->h, fv = j->vmax / c->v;
    int stride = c->blocks_w * 8, W = j->width, x;
    const uint8_t *p = c->plane;
    if (fv == 2 && (fh == 1 || (fh == 2 && c->width > 2))) {
        /* h1v2 and h2v2 fancy: the nearer row 3:1 with the other. */
        int cy = y >> 1;
        int ny = clampi((y & 1) ? cy + 1 : cy - 1, 0, c->height - 1);
        const uint8_t *r = p + (size_t)cy * stride, *q = p + (size_t)ny * stride;
        if (fh == 1) {
            int bias = (y & 1) ? 2 : 1;
            for (x = 0; x < W; x++) o[x] = (uint8_t)((3 * r[x] + q[x] + bias) >> 2);
            return;
        }
        for (x = 0; x < c->width; x++) sums[x] = 3 * r[x] + q[x];
        fancy_h2(sums, c->width, o, W, 8, 7, 4);
        return;
    }
    {
        const uint8_t *r = p + (size_t)(y / fv) * stride;
        if (fh == 1) {
            memcpy(o, r, (size_t)W);
        } else if (fh == 2 && fv == 1 && c->width > 2) {
            for (x = 0; x < c->width; x++) sums[x] = r[x];
            fancy_h2(sums, c->width, o, W, 1, 2, 2);
        } else {
            /* Box upsampling (h2v1_upsample, h2v2_upsample, int_upsample). */
            for (x = 0; x < W; x++) o[x] = r[x / fh];
        }
    }
}

#define SCALEBITS 16
#define ONE_HALF (1 << (SCALEBITS - 1))
#define FIX(x) ((int32_t)((x) * (1 << SCALEBITS) + 0.5))

static uint8_t clamp8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

/* jdcolor.c's tables, indexed by the chroma sample. */
typedef struct {
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
} Ycc;

static void build_ycc(Ycc *t)
{
    int i;
    for (i = 0; i < 256; i++) {
        int x = i - 128;
        t->cr_r[i] = (FIX(1.40200) * x + ONE_HALF) >> SCALEBITS;
        t->cb_b[i] = (FIX(1.77200) * x + ONE_HALF) >> SCALEBITS;
        t->cr_g[i] = -FIX(0.71414) * x;
        t->cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
}

/* OpenCV's CMYK -> BGR of libjpeg's CMYK output, written as RGB. */
static void cmyk_to_rgb(int c, int m, int y, int k, uint8_t *rgb)
{
    rgb[0] = (uint8_t)(k - ((255 - c) * k >> 8));
    rgb[1] = (uint8_t)(k - ((255 - m) * k >> 8));
    rgb[2] = (uint8_t)(k - ((255 - y) * k >> 8));
}

/* `space` as colour_space returns. */
static void colour_row(const Ycc *t, int ncomp, int space,
                       const uint8_t *const *in, uint8_t *rgb, int W)
{
    int x;
    if (ncomp == 1) {
        for (x = 0; x < W; x++) rgb[3 * x] = rgb[3 * x + 1] = rgb[3 * x + 2] = in[0][x];
        return;
    }
    if (space == 1) {
        for (x = 0; x < W; x++) {
            rgb[3 * x] = in[0][x];
            rgb[3 * x + 1] = in[1][x];
            rgb[3 * x + 2] = in[2][x];
        }
        return;
    }
    if (space == 2) {
        for (x = 0; x < W; x++)
            cmyk_to_rgb(in[0][x], in[1][x], in[2][x], in[3][x], rgb + 3 * x);
        return;
    }
    for (x = 0; x < W; x++) {
        int y = in[0][x], cb = in[1][x], cr = in[2][x];
        int r = clamp8(y + t->cr_r[cr]);
        int g = clamp8(y + ((t->cb_g[cb] + t->cr_g[cr]) >> SCALEBITS));
        int b = clamp8(y + t->cb_b[cb]);
        if (space == 3) {
            /* jdcolor.c ycck_cmyk_convert: C, M, Y = 255 - R, G, B. */
            cmyk_to_rgb(255 - r, 255 - g, 255 - b, in[3][x], rgb + 3 * x);
        } else {
            rgb[3 * x] = (uint8_t)r;
            rgb[3 * x + 1] = (uint8_t)g;
            rgb[3 * x + 2] = (uint8_t)b;
        }
    }
}

/* ------------------------------------------------------------------ */
/* The header walk and the entry points.                               */

/* Parses the stream; with `decode` set it also decodes every scan. Stops
 * after the SOF when only the size is wanted. */
static void walk(Jpeg *j, int decode)
{
    char msg[96];
    if (j->n < 2 || j->data[0] != 0xFF || j->data[1] != 0xD8)
        fail(&j->f, "no SOI marker");
    j->pos = 2;
    for (;;) {
        int m = next_marker(j);
        long start, end;
        const uint8_t *p;
        if (m == 0xD9) break;
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01)
            fail(&j->f, "restart marker outside a scan");
        segment(j, &start, &end);
        p = j->data + start;
        switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
            parse_sof(j, p, end - start, m == 0xC2);
            if (!decode) return;
            break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF: {
            static const char *names[16] = {
                0, 0, "progressive (SOF2)", "lossless (SOF3)", 0,
                "differential sequential (SOF5)",
                "differential progressive (SOF6)",
                "differential lossless (SOF7)", 0,
                "arithmetic-coded sequential (SOF9)",
                "arithmetic-coded progressive (SOF10)",
                "arithmetic-coded lossless (SOF11)", 0,
                "arithmetic-coded differential sequential (SOF13)",
                "arithmetic-coded differential progressive (SOF14)",
                "arithmetic-coded differential lossless (SOF15)"};
            snprintf(msg, sizeof msg, "%s JPEGs are not read (sequential "
                     "and progressive Huffman only)", names[m - 0xC0]);
            fail(&j->f, msg);
            break;
        }
        case 0xCC:
            fail(&j->f, "arithmetic coding (DAC) is not read");
            break;
        case 0xC4:
            parse_dht(j, p, end - start);
            break;
        case 0xDB:
            parse_dqt(j, p, end - start);
            break;
        case 0xDD:
            if (end - start != 2) fail(&j->f, "bad DRI");
            j->restart = u16be(p);
            break;
        case 0xE0:
            if (end - start >= 5 && !memcmp(p, "JFIF\0", 5)) j->jfif = 1;
            break;
        case 0xEE:
            if (end - start >= 12 && !memcmp(p, "Adobe", 5)) {
                j->adobe = 1;
                j->adobe_transform = p[11];
            }
            break;
        case 0xDC:
            fail(&j->f, "DNL is not read");
            break;
        case 0xDA:
            if (!j->ncomp) fail(&j->f, "SOS before SOF");
            decode_scan(j, p, end - start);
            j->scans++;
            break;
        default:
            break;
        }
    }
    if (!j->ncomp) fail(&j->f, "no image data");
    if (!j->scans) fail(&j->f, "no image data");
    if (takes_smoothing(j))
        fail(&j->f, "progressive JPEG whose scans stop before the last bit "
                    "of coefficients 1-9 (libjpeg's inter-block smoothing) "
                    "is not read");
}

/* jdapimin.c's guess of the colour space: 0 YCbCr or gray, 1 RGB, 2 CMYK,
 * 3 YCCK. */
static int colour_space(const Jpeg *j)
{
    if (j->ncomp == 3) {
        if (j->jfif) return 0;
        if (j->adobe) return j->adobe_transform == 0;
        return j->comp[0].cid == 82 && j->comp[1].cid == 71
               && j->comp[2].cid == 66;
    }
    if (j->ncomp == 4) return j->adobe && j->adobe_transform != 0 ? 3 : 2;
    return 0;
}

static void release(Jpeg *j)
{
    int i;
    for (i = 0; i < 4; i++) {
        free(j->comp[i].plane);
        free(j->comp[i].coef);
    }
    free(j->scratch);
}

/* Height and width of the JPEG in data[0:n]; 0, or 1 with a message. */
int jpeg_size(const uint8_t *data, long n, int *height, int *width,
              char *err, int err_len)
{
    Jpeg *j = (Jpeg *)calloc(1, sizeof(Jpeg));
    volatile int rc = 0;
    if (!j) return 2;
    j->data = data;
    j->n = n;
    j->f.err = err;
    j->f.err_len = err_len;
    if (setjmp(j->f.jump) == 0) {
        walk(j, 0);
        if (!j->ncomp) fail(&j->f, "no image data");
        *height = j->height;
        *width = j->width;
    } else {
        rc = 1;
    }
    release(j);
    free(j);
    return rc;
}

/* Decodes the JPEG in data[0:n] into rgb[height][width][3], which the
 * caller sized with jpeg_size; 0, or 1 with a message. With eof_fill a
 * stream whose data ends early is filled as cv2.imread fills it. */
int decode_jpeg(const uint8_t *data, long n, uint8_t *rgb, int height,
                int width, int eof_fill, char *err, int err_len)
{
    Jpeg *j = (Jpeg *)calloc(1, sizeof(Jpeg));
    volatile int rc = 0;
    int i;
    if (!j) return 2;
    j->data = data;
    j->n = n;
    j->f.err = err;
    j->f.err_len = err_len;
    j->eof_fill = eof_fill;
    if (setjmp(j->f.jump) == 0) {
        size_t sums_at;
        uint8_t *rows[4];
        Ycc *ycc;
        int y, space;
        walk(j, 1);
        space = colour_space(j);
        inverse_dct(j);
        if (j->height != height || j->width != width)
            fail(&j->f, "output buffer of the wrong size");
        /* Row by row: each component's upsampled row, then colour. */
        sums_at = ((size_t)j->width * j->ncomp + 15) & ~(size_t)15;
        j->scratch = (uint8_t *)malloc(sums_at + sizeof(int) * (size_t)j->width
                                       + sizeof(Ycc));
        if (!j->scratch) fail(&j->f, "out of memory");
        ycc = (Ycc *)(void *)(j->scratch + sums_at
                              + sizeof(int) * (size_t)j->width);
        build_ycc(ycc);
        for (i = 0; i < j->ncomp; i++) rows[i] = j->scratch + (size_t)j->width * i;
        for (y = 0; y < j->height; y++) {
            for (i = 0; i < j->ncomp; i++) {
                upsample_row(j, &j->comp[i], y, rows[i],
                             (int *)(void *)(j->scratch + sums_at));
            }
            colour_row(ycc, j->ncomp, space, (const uint8_t *const *)rows,
                       rgb + (size_t)y * j->width * 3, j->width);
        }
    } else {
        rc = 1;
    }
    release(j);
    free(j);
    return rc;
}

/* ------------------------------------------------------------------ */
/* cv2's INTER_LINEAR on uint8.                                        */

static int floor_f(float v)
{
    int i = (int)v;
    return (v < (float)i) ? i - 1 : i;
}

/* cvRound: to nearest, ties to even. */
static int round_even(float v)
{
    int i = floor_f(v);
    float d = v - (float)i;
    if (d > 0.5f || (d == 0.5f && (i & 1))) i++;
    return i;
}

/* Source index pair and float32 weights (1 - f, f) of each destination
 * index along one axis, as cv2 computes them for INTER_LINEAR. `clamp`
 * sets the weights of indices beyond the edges to the edge sample (cv2
 * does so along x only). */
static void axis_f32(int src, int dst, int clamp, int *s0, int *s1,
                     float *w0, float *w1)
{
    double scale = 1.0 / ((double)dst / src);
    int d;
    for (d = 0; d < dst; d++) {
        float f = (float)((d + 0.5) * scale - 0.5);
        int s = floor_f(f);
        f -= (float)s;
        if (clamp && s < 0) { s = 0; f = 0.f; }
        if (clamp && s >= src - 1) { s = src - 1; f = 0.f; }
        w0[d] = 1.f - f;
        w1[d] = f;
        s0[d] = clampi(s, 0, src - 1);
        s1[d] = clampi(s + 1, 0, src - 1);
    }
}

/* The same with cv2's 11-bit weights for uint8. */
static int axis(int src, int dst, int clamp, int *s0, int *s1, int *w0,
                int *w1)
{
    float *f = (float *)malloc(sizeof(float) * (size_t)dst * 2);
    int d;
    if (!f) return 1;
    axis_f32(src, dst, clamp, s0, s1, f, f + dst);
    for (d = 0; d < dst; d++) {
        w0[d] = round_even(f[d] * 2048.f);
        w1[d] = round_even(f[dst + d] * 2048.f);
    }
    free(f);
    return 0;
}

/* One source row's horizontal pass: r[x*cn + k] = a0 * s[x0] + a1 * s[x1]
 * (x0, x1 already multiplied by cn). */
static void horizontal_row(const uint8_t *restrict s, int32_t *restrict r,
                           int dw, int cn, const int *restrict x0,
                           const int *restrict x1, const int *restrict a0,
                           const int *restrict a1)
{
    int x, k;
    if (cn == 3) {
        for (x = 0; x < dw; x++) {
            const uint8_t *p = s + x0[x], *q = s + x1[x];
            r[3 * x] = p[0] * a0[x] + q[0] * a1[x];
            r[3 * x + 1] = p[1] * a0[x] + q[1] * a1[x];
            r[3 * x + 2] = p[2] * a0[x] + q[2] * a1[x];
        }
        return;
    }
    for (x = 0; x < dw; x++) {
        for (k = 0; k < cn; k++)
            r[x * cn + k] = s[x0[x] + k] * a0[x] + s[x1[x] + k] * a1[x];
    }
}

static uint8_t vertical(int32_t s0, int32_t s1, int b0, int b1)
{
    int v = ((((s0 >> 4) * b0) >> 16) + (((s1 >> 4) * b1) >> 16) + 2) >> 2;
    v = v < 0 ? 0 : v;
    return (uint8_t)(v > 255 ? 255 : v);
}

/* One output row of the vertical pass, as cv2's vectorised code; in
 * groups of 16 that the compiler turns into vector instructions at -O2. */
static void vertical_row(const int32_t *restrict r0,
                         const int32_t *restrict r1, uint8_t *restrict o,
                         int n, int b0, int b1)
{
    int x = 0, k;
    for (; x + 16 <= n; x += 16) {
        for (k = 0; k < 16; k++) o[x + k] = vertical(r0[x + k], r1[x + k], b0, b1);
    }
    for (; x < n; x++) o[x] = vertical(r0[x], r1[x], b0, b1);
}

/* src [sh][sw][cn] → dst [dh][dw][cn]; 0, or 1 if out of memory. */
int resize_linear_u8(const uint8_t *src, int sh, int sw, int cn,
                     uint8_t *dst, int dh, int dw)
{
    int *xs0 = (int *)malloc(sizeof(int) * (size_t)dw * 4);
    int *ys0 = (int *)malloc(sizeof(int) * (size_t)dh * 4);
    int32_t *rows = (int32_t *)malloc(sizeof(int32_t) * (size_t)sh * dw * cn);
    unsigned char *needed = (unsigned char *)calloc((size_t)sh, 1);
    int *xs1, *xw0, *xw1, *ys1, *yw0, *yw1, x, y;
    int row_len = dw * cn;
    if (!xs0 || !ys0 || !rows || !needed) {
        free(xs0);
        free(ys0);
        free(rows);
        free(needed);
        return 1;
    }
    xs1 = xs0 + dw; xw0 = xs1 + dw; xw1 = xw0 + dw;
    ys1 = ys0 + dh; yw0 = ys1 + dh; yw1 = yw0 + dh;
    if (axis(sw, dw, 1, xs0, xs1, xw0, xw1)
        || axis(sh, dh, 0, ys0, ys1, yw0, yw1)) {
        free(xs0);
        free(ys0);
        free(rows);
        free(needed);
        return 1;
    }
    for (x = 0; x < dw; x++) {
        xs0[x] *= cn;
        xs1[x] *= cn;
    }
    /* The horizontal pass, only on the source rows some output row
     * reads. */
    for (y = 0; y < dh; y++) needed[ys0[y]] = needed[ys1[y]] = 1;
    for (y = 0; y < sh; y++) {
        if (needed[y])
            horizontal_row(src + (size_t)y * sw * cn,
                           rows + (size_t)y * row_len, dw, cn, xs0, xs1,
                           xw0, xw1);
    }
    for (y = 0; y < dh; y++) {
        vertical_row(rows + (size_t)ys0[y] * row_len,
                     rows + (size_t)ys1[y] * row_len,
                     dst + (size_t)y * row_len, row_len, yw0[y], yw1[y]);
    }
    free(xs0);
    free(ys0);
    free(rows);
    free(needed);
    return 0;
}

/* ------------------------------------------------------------------ */
/* cv2's INTER_LINEAR and INTER_AREA on float32 with 2 channels.       */

/* cv2's generic INTER_AREA for an integer ratio (resizeAreaFast_
 * without its vector code, which it skips for 2 channels): each output
 * the float sum of its sx * sy block in row order, four samples at a
 * time ((a + b) + c) + d added to the running sum, times the float
 * 1 / (sx * sy). */
static void area_fast_f32(const float *src, int sw, int cn, float *dst,
                          int dh, int dw, int sx, int sy)
{
    int area = sx * sy, y, x, c, k;
    float scale = 1.f / (float)area;
    for (y = 0; y < dh; y++) {
        for (x = 0; x < dw; x++) {
            for (c = 0; c < cn; c++) {
                const float *s = src + ((size_t)y * sy * sw + (size_t)x * sx) * cn + c;
                float sum = 0.f, v[4];
                for (k = 0; k + 4 <= area; k += 4) {
                    int j;
                    for (j = 0; j < 4; j++)
                        v[j] = s[((size_t)((k + j) / sx) * sw + (k + j) % sx) * cn];
                    sum += ((v[0] + v[1]) + v[2]) + v[3];
                }
                for (; k < area; k++)
                    sum += s[((size_t)(k / sx) * sw + k % sx) * cn];
                dst[((size_t)y * dw + x) * cn + c] = sum * scale;
            }
        }
    }
}

typedef struct { int di, si; float alpha; } Decimate;

static int floor_d(double v)
{
    int i = (int)v;
    return (v < (double)i) ? i - 1 : i;
}

static int ceil_d(double v)
{
    int i = (int)v;
    return (v > (double)i) ? i + 1 : i;
}

/* computeResizeAreaTab: the source samples and weights of each output
 * along one axis, for a ratio `scale` = src / dst that is no integer. */
static int area_tab(int ssize, int dsize, double scale, Decimate *tab)
{
    int k = 0, dx, sx;
    for (dx = 0; dx < dsize; dx++) {
        double fsx1 = dx * scale, fsx2 = fsx1 + scale;
        double cell = scale < ssize - fsx1 ? scale : ssize - fsx1;
        int sx1 = ceil_d(fsx1), sx2 = floor_d(fsx2);
        sx2 = sx2 < ssize - 1 ? sx2 : ssize - 1;
        sx1 = sx1 < sx2 ? sx1 : sx2;
        if (sx1 - fsx1 > 1e-3) {
            tab[k].di = dx; tab[k].si = sx1 - 1;
            tab[k++].alpha = (float)((sx1 - fsx1) / cell);
        }
        for (sx = sx1; sx < sx2; sx++) {
            tab[k].di = dx; tab[k].si = sx;
            tab[k++].alpha = (float)(1.0 / cell);
        }
        if (fsx2 - sx2 > 1e-3) {
            double t = fsx2 - sx2 < 1. ? fsx2 - sx2 : 1.;
            tab[k].di = dx; tab[k].si = sx2;
            tab[k++].alpha = (float)((t < cell ? t : cell) / cell);
        }
    }
    return k;
}

/* cv2's resizeArea_: each source row weighted along x into buf
 * (buf[dx] += s * alpha in table order), rows summed into an output row
 * (sum = beta * buf for a row's first source row, then sum += beta *
 * buf). 0, or 1 if out of memory. */
static int area_general_f32(const float *src, int sh, int sw, int cn,
                            float *dst, int dh, int dw)
{
    Decimate *xt = (Decimate *)malloc(sizeof(Decimate) * (size_t)sw * 2);
    Decimate *yt = (Decimate *)malloc(sizeof(Decimate) * (size_t)sh * 2);
    float *buf = (float *)malloc(sizeof(float) * (size_t)dw * cn * 2);
    float *sum;
    int nx, ny, j, k, c, prev, n = dw * cn;
    if (!xt || !yt || !buf) {
        free(xt);
        free(yt);
        free(buf);
        return 1;
    }
    sum = buf + n;
    nx = area_tab(sw, dw, 1.0 / ((double)dw / sw), xt);
    ny = area_tab(sh, dh, 1.0 / ((double)dh / sh), yt);
    for (k = 0; k < n; k++) sum[k] = 0.f;
    prev = yt[0].di;
    for (j = 0; j < ny; j++) {
        float beta = yt[j].alpha;
        const float *s = src + (size_t)yt[j].si * sw * cn;
        for (k = 0; k < n; k++) buf[k] = 0.f;
        for (k = 0; k < nx; k++) {
            float a = xt[k].alpha;
            for (c = 0; c < cn; c++)
                buf[xt[k].di * cn + c] += s[xt[k].si * cn + c] * a;
        }
        if (yt[j].di != prev) {
            float *d = dst + (size_t)prev * n;
            for (k = 0; k < n; k++) {
                d[k] = sum[k];
                sum[k] = beta * buf[k];
            }
            prev = yt[j].di;
        } else {
            for (k = 0; k < n; k++) sum[k] += beta * buf[k];
        }
    }
    for (k = 0; k < n; k++) dst[(size_t)prev * n + k] = sum[k];
    free(xt);
    free(yt);
    free(buf);
    return 0;
}

/* The integer ratio of src to dst if cv2 takes it as one (|r - round(r)|
 * below DBL_EPSILON), else 0. */
static int integer_ratio(int src, int dst)
{
    double r = 1.0 / ((double)dst / src);
    int i = (int)(r + 0.5);
    double d = r - i;
    return (d < 0 ? -d : d) < 2.220446049250313e-16 ? i : 0;
}

/* cv2.resize(src, (dw, dh), INTER_AREA) on float32 [sh][sw][cn] with
 * dh <= sh and dw <= sw; 0, or 1 if out of memory. */
int resize_area_f32(const float *src, int sh, int sw, int cn, float *dst,
                    int dh, int dw)
{
    int ix = integer_ratio(sw, dw), iy = integer_ratio(sh, dh);
    if (ix && iy) {
        area_fast_f32(src, sw, cn, dst, dh, dw, ix, iy);
        return 0;
    }
    return area_general_f32(src, sh, sw, cn, dst, dh, dw);
}

/* cv2.resize(src, (dw, dh), INTER_LINEAR) on float32 [sh][sw][cn] with
 * cn = 2 (cv2 hands 1, 3 and 4 channels to IPP): along x, a0 * s[x0] +
 * a1 * s[x0 + 1] up to the first output whose source index reaches the
 * last column and s[x0] from there on; along y, b0 * r0 + b1 * r1 with
 * rows never clamped; each product and sum rounded to float. Halving
 * both sides is cv2's INTER_AREA, as cv2 does. 0, or 1 if out of
 * memory. */
int resize_linear_f32(const float *src, int sh, int sw, int cn, float *dst,
                      int dh, int dw)
{
    int *xs0, *xs1, *ys0, *ys1, x, y, c, xmax = dw, n = dw * cn;
    float *xw0, *xw1, *yw0, *yw1, *rows;
    unsigned char *needed;
    double scale_x = 1.0 / ((double)dw / sw);
    if (sh == 2 * dh && sw == 2 * dw)
        return resize_area_f32(src, sh, sw, cn, dst, dh, dw);
    xs0 = (int *)malloc(sizeof(int) * (size_t)(dw + dh) * 2);
    xw0 = (float *)malloc(sizeof(float) * (size_t)(dw + dh) * 2);
    rows = (float *)malloc(sizeof(float) * (size_t)sh * n);
    needed = (unsigned char *)calloc((size_t)sh, 1);
    if (!xs0 || !xw0 || !rows || !needed) {
        free(xs0);
        free(xw0);
        free(rows);
        free(needed);
        return 1;
    }
    xs1 = xs0 + dw; ys0 = xs1 + dw; ys1 = ys0 + dh;
    xw1 = xw0 + dw; yw0 = xw1 + dw; yw1 = yw0 + dh;
    axis_f32(sw, dw, 1, xs0, xs1, xw0, xw1);
    axis_f32(sh, dh, 0, ys0, ys1, yw0, yw1);
    /* cv2's xmax: from the first output whose source index (raised to 0)
     * plus one reaches the last column, one tap. */
    for (x = 0; x < dw; x++) {
        int s = floor_f((float)((x + 0.5) * scale_x - 0.5));
        if ((s < 0 ? 0 : s) + 1 >= sw) { xmax = x; break; }
    }
    for (y = 0; y < dh; y++) needed[ys0[y]] = needed[ys1[y]] = 1;
    for (y = 0; y < sh; y++) {
        const float *s = src + (size_t)y * sw * cn;
        float *r = rows + (size_t)y * n;
        if (!needed[y]) continue;
        for (x = 0; x < xmax; x++) {
            for (c = 0; c < cn; c++) {
                float p = s[xs0[x] * cn + c] * xw0[x];
                float q = s[xs1[x] * cn + c] * xw1[x];
                r[x * cn + c] = p + q;
            }
        }
        for (; x < dw; x++)
            for (c = 0; c < cn; c++) r[x * cn + c] = s[xs0[x] * cn + c];
    }
    for (y = 0; y < dh; y++) {
        const float *r0 = rows + (size_t)ys0[y] * n;
        const float *r1 = rows + (size_t)ys1[y] * n;
        float b0 = yw0[y], b1 = yw1[y], *d = dst + (size_t)y * n;
        for (x = 0; x < n; x++) {
            float p = r0[x] * b0, q = r1[x] * b1;
            d[x] = p + q;
        }
    }
    free(xs0);
    free(xw0);
    free(rows);
    free(needed);
    return 0;
}

/* ------------------------------------------------------------------ */
/* cv2.fillPoly with 8-connected lines and shift 0.                    */

#define XY_SHIFT 16
#define XY_ONE (1LL << XY_SHIFT)

typedef struct { int64_t x, dx; int y0, y1; } Edge;

/* OpenCV's clipLine on a w x h image; moves the end points, also when
 * it then fails (returns 0). */
static int clip_line(int w, int h, int64_t *x1, int64_t *y1, int64_t *x2,
                     int64_t *y2)
{
    int64_t right = w - 1, bottom = h - 1, a;
    int c1, c2;
    if (w <= 0 || h <= 0) return 0;
    c1 = (*x1 < 0) + (*x1 > right) * 2 + (*y1 < 0) * 4 + (*y1 > bottom) * 8;
    c2 = (*x2 < 0) + (*x2 > right) * 2 + (*y2 < 0) * 4 + (*y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            *x1 += (int64_t)((double)(a - *y1) * (*x2 - *x1) / (*y2 - *y1));
            *y1 = a;
            c1 = (*x1 < 0) + (*x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            *x2 += (int64_t)((double)(a - *y2) * (*x2 - *x1) / (*y2 - *y1));
            *y2 = a;
            c2 = (*x2 < 0) + (*x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                *y1 += (int64_t)((double)(a - *x1) * (*y2 - *y1) / (*x2 - *x1));
                *x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                *y2 += (int64_t)((double)(a - *x2) * (*y2 - *y1) / (*x2 - *x1));
                *x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

static int inside(int w, int h, int64_t x, int64_t y)
{
    return x >= 0 && x < w && y >= 0 && y < h;
}

/* OpenCV's Line through an 8-connected LineIterator, left to right. */
static void draw_line(uint8_t *img, int h, int w, int64_t ax, int64_t ay,
                      int64_t bx, int64_t by, uint8_t value)
{
    int64_t dx, dy, major, minor, err, k, px, py;
    int sy = 1, vert;
    if (!inside(w, h, ax, ay) || !inside(w, h, bx, by))
        if (!clip_line(w, h, &ax, &ay, &bx, &by)) return;
    dx = bx - ax;
    dy = by - ay;
    if (dx < 0) {
        dx = -dx; dy = -dy;
        px = ax; ax = bx; bx = px;
        py = ay; ay = by; by = py;
    }
    if (dy < 0) { dy = -dy; sy = -1; }
    vert = dy > dx;
    major = vert ? dy : dx;
    minor = vert ? dx : dy;
    err = major - 2 * minor;
    px = ax;
    py = ay;
    for (k = 0; k <= major; k++) {
        img[py * w + px] = value;
        if (vert) py += sy; else px++;
        if (err < 0) {
            if (vert) px++; else py += sy;
            err += 2 * major - 2 * minor;
        } else {
            err -= 2 * minor;
        }
    }
}

static int edge_before(const Edge *a, const Edge *b)
{
    if (a->y0 != b->y0) return a->y0 < b->y0;
    if (a->x != b->x) return a->x < b->x;
    return a->dx < b->dx;
}

/* FillEdgeCollection: the active list walked in x order, spans between
 * the 1st and 2nd, 3rd and 4th, ... crossing, each span the pixels
 * whose x lies in [ceil(xa), floor(xb)]. */
static int fill_edges(uint8_t *img, int h, int w, Edge *edges, int total,
                      uint8_t value)
{
    Edge **active, *t;
    int64_t x_min = INT64_MAX, x_max = INT64_MIN;
    int y_min = INT32_MAX, y_max = INT32_MIN, i, j, n = 0, y, e = 0;
    if (total < 2) return 0;
    for (i = 0; i < total; i++) {
        int64_t x1 = edges[i].x + (edges[i].y1 - edges[i].y0) * edges[i].dx;
        if (edges[i].y0 < y_min) y_min = edges[i].y0;
        if (edges[i].y1 > y_max) y_max = edges[i].y1;
        if (edges[i].x < x_min) x_min = edges[i].x;
        if (edges[i].x > x_max) x_max = edges[i].x;
        if (x1 < x_min) x_min = x1;
        if (x1 > x_max) x_max = x1;
    }
    if (y_max < 0 || y_min >= h || x_max < 0 || x_min >= ((int64_t)w << XY_SHIFT))
        return 0;
    /* Insertion sort by (y0, x, dx): polygons have few edges. */
    for (i = 1; i < total; i++) {
        Edge v = edges[i];
        for (j = i; j > 0 && edge_before(&v, &edges[j - 1]); j--)
            edges[j] = edges[j - 1];
        edges[j] = v;
    }
    active = (Edge **)malloc(sizeof(Edge *) * (size_t)total);
    if (!active) return 1;
    if (y_max > h) y_max = h;
    for (y = edges[0].y0; y < y_max; y++) {
        int pos = 0, draw = 0;
        Edge *prev = NULL, *keep;
        while (pos < n || (e < total && edges[e].y0 == y)) {
            Edge *last = pos < n ? active[pos] : NULL;
            if (last && last->y1 == y) {
                memmove(active + pos, active + pos + 1,
                        sizeof(Edge *) * (size_t)(n - pos - 1));
                n--;
                continue;
            }
            keep = prev;
            if (last && (e >= total || edges[e].y0 > y || last->x < edges[e].x)) {
                prev = last;
                pos++;
            } else if (e < total) {
                memmove(active + pos + 1, active + pos,
                        sizeof(Edge *) * (size_t)(n - pos));
                active[pos] = &edges[e++];
                prev = active[pos];
                pos++;
                n++;
            } else {
                break;
            }
            if (draw) {
                if (y >= 0) {
                    int64_t xa = keep->x > prev->x ? prev->x : keep->x;
                    int64_t xb = keep->x > prev->x ? keep->x : prev->x;
                    xa = (xa + XY_ONE - 1) >> XY_SHIFT;
                    xb >>= XY_SHIFT;
                    if (xa < w && xb >= 0) {
                        if (xa < 0) xa = 0;
                        if (xb >= w) xb = w - 1;
                        if (xb >= xa)
                            memset(img + (size_t)y * w + xa, value,
                                   (size_t)(xb - xa + 1));
                    }
                }
                keep->x += keep->dx;
                prev->x += prev->dx;
            }
            draw ^= 1;
        }
        /* Back in x order, stably (OpenCV's bubble sort). */
        for (i = 1; i < n; i++) {
            t = active[i];
            for (j = i; j > 0 && active[j - 1]->x > t->x; j--)
                active[j] = active[j - 1];
            active[j] = t;
        }
    }
    free(active);
    return 0;
}

/* cv2.fillPoly(img, parts, value) on uint8 [h][w]: `pts` holds the
 * (x, y) points of every part in turn, counts[p] points in part p. Each
 * edge's line is drawn, then the edges of all parts fill together. An
 * edge with an end off the image takes x and slope from its clipped
 * segment (and its rows, where the clipped ends lie on different rows),
 * x carried back to the unclipped first row. 0, or 1 if out of memory. */
int fill_polygons(uint8_t *img, int h, int w, const int32_t *pts,
                  const int32_t *counts, int parts, uint8_t value)
{
    int total = 0, p, i, rc;
    const int32_t *v = pts;
    Edge *edges;
    for (p = 0; p < parts; p++) total += counts[p];
    edges = (Edge *)malloc(sizeof(Edge) * (size_t)(total + 1));
    if (!edges) return 1;
    total = 0;
    for (p = 0; p < parts; p++) {
        int n = counts[p];
        int64_t x0, y0;
        if (n <= 0) continue;
        x0 = v[2 * (n - 1)];
        y0 = v[2 * (n - 1) + 1];
        for (i = 0; i < n; i++) {
            int64_t x1 = v[2 * i], y1 = v[2 * i + 1];
            int64_t cx0 = x0, cx1 = x1, cy0 = y0, cy1 = y1;
            draw_line(img, h, w, x0, y0, x1, y1, value);
            if (!inside(w, h, x0, y0) || !inside(w, h, x1, y1)) {
                clip_line(w, h, &cx0, &cy0, &cx1, &cy1);
                if (cy0 == cy1) { cy0 = y0; cy1 = y1; }
            }
            if (y0 != y1) {
                Edge *ed = &edges[total++];
                ed->dx = (cx1 - cx0) * XY_ONE / (cy1 - cy0);
                if (y0 < y1) {
                    ed->y0 = (int)y0; ed->y1 = (int)y1;
                    ed->x = cx0 * XY_ONE + (y0 - cy0) * ed->dx;
                } else {
                    ed->y0 = (int)y1; ed->y1 = (int)y0;
                    ed->x = cx1 * XY_ONE + (y1 - cy1) * ed->dx;
                }
            }
            x0 = x1;
            y0 = y1;
        }
        v += 2 * n;
    }
    rc = fill_edges(img, h, w, edges, total, value);
    free(edges);
    return rc;
}
