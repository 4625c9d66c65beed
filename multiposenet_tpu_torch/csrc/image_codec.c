/* Host image codec of the port: JPEG decoding and encoding, cv2's INTER_LINEAR
 * resize on uint8 and on two-channel float32, its INTER_AREA on float32,
 * cv2.fillPoly, the byte coders of the simple formats (TIFF LZW,
 * PackBits, JPEG strips and CCITT fax, GIF LZW, BMP RLE4/RLE8, Radiance
 * HDR pixels) and cv2.imencode's writers for .bmp, .ppm/.pam/.pfm, .sr,
 * .tif, .hdr and .gif, in plain C99 with no library.
 *
 * decode_jpeg decodes as libjpeg-turbo 3 does under OpenCV 5's reader:
 * sequential (SOF0, SOF1) and progressive (SOF2) Huffman-coded frames,
 * their arithmetic-coded counterparts (SOF9, SOF10: jdarith.c's Q-coder
 * with DAC conditioning), all of 8-bit samples and 1, 3 or 4 components,
 * and lossless frames (SOF3, jdlossls.c: predictors 1-7, a point
 * transform, 2 to 8 bits) in RGB or CMYK. Scans fill a coefficient
 * buffer for the whole image (jdhuff.c and jdphuff.c: DC first and
 * refine scans, AC first and refine scans with EOB runs, restart
 * intervals in every scan); then every block goes through libjpeg-turbo's
 * ISLOW IDCT in the arithmetic of its SIMD code (16-bit dequantisation
 * and sums, the first pass saturated to 16 bits, the whole-block zero-AC
 * shortcut), fancy upsampling where libjpeg-turbo takes it and box
 * upsampling elsewhere (lossless frames always), and the colour
 * conversion of jdcolor.c: fixed-point YCbCr -> RGB, none for RGB JPEGs
 * (Adobe transform 0, or component ids 'R', 'G', 'B'), YCCK -> CMYK, and
 * for 4 components OpenCV's CMYK -> BGR (c' = k - ((255 - c) * k >> 8)).
 * A progressive image whose coefficients 1..9 do not all reach their
 * last bit goes through libjpeg-turbo 3's inter-block smoothing
 * (jdcoefct.c decompress_smooth_data). It writes RGB; the Exif
 * orientation is applied by the caller.
 *
 * A stream whose data ends early is refused, as cv2.imdecode refuses it,
 * unless the caller passes `eof_fill` (cv2.imread of a file: libjpeg's
 * file source appends an EOI at every read past the end): then the block
 * in which the data ran out is decoded with zero bits, and every later
 * block of the scan keeps zero coefficients (mid-gray), as jdhuff.c's
 * `insufficient_data` does; lossless rows finish on zero bits and later
 * rows restart from zero differences (jdlhuff.c); arithmetic decoding
 * goes on over zero bytes until a bad code ends the interval (jdarith.c);
 * a marker segment cut short is completed with FF D9 bytes; smoothing
 * takes the coefficient bits from before a cut scan below its last
 * decoded iMCU row. Entropy-coded data that is corrupt decodes on as
 * libjpeg-turbo 3.1 decodes it after its warnings, under both sources:
 * a bad Huffman code gives symbol 0 (slow_symbol), a run past the block
 * writes coefficient 63, data that runs into a marker is finished as
 * at the end of the data (end_mcu), a wrong restart marker is answered
 * as jpeg_resync_to_restart answers it (read_restart_marker), an
 * arithmetic interval stops at a bad code (arith_err), a progression out
 * of order is decoded as its scans say; the header walk skips what is
 * not a marker (walk). What cv2 5.0 returns no image for is refused by
 * name: 12- and 16-bit samples, lossless frames that need a colour
 * conversion (gray, YCbCr, YCCK), arithmetic-coded lossless and
 * hierarchical frames, unknown markers and bad tables or scan headers.
 * `utils/jpeg.py` is the plain version of the baseline part and refuses
 * the rest by name.
 *
 * encode_jpeg writes what cv2.imencode(".jpg") writes at its defaults,
 * bit for bit: jccolor.c's RGB -> YCbCr, h2v2_downsample with its
 * alternating 1, 2 bias, jcprepct.c's and jcsample.c's edge replication
 * and jccoefct.c's dummy blocks, jfdctint.c's ISLOW DCT, jcdctmgr.c's
 * reciprocal quantiser, the standard Huffman tables with 0xFF stuffing
 * and 1-bit padding. Its plain version is utils/jpeg.py encode_pixels.
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
 * tiff_lzw, packbits, gif_lzw and bmp_rle run one strip, tile, frame or
 * bitmap's codes for the parsers in utils/tiff.py, gif.py and bmp.py,
 * which hold their plain versions; decode_jpeg_tiff decodes a TIFF's JPEG
 * strip in the colour space the TIFF names (plain version jpeg.py
 * decode_planes), fax_decode a CCITT strip as libtiff's tif_fax3.c does
 * (plain version utils/ccitt.py) and hdr_pixels a Radiance HDR file's
 * pixels as OpenCV's rgbe.cpp reads them (utils/hdr.py); encode_bmp,
 * encode_pxm, encode_sunras, encode_tiff, encode_hdr and encode_gif write
 * whole files (plain versions utils/bmp.py, pxm.py, sunras.py, tiff.py,
 * hdr.py and gif.py; encode_gif dithers onto cv2's 3-3-2 palette and
 * codes GIF's LZW, whose codes go least significant bit first without
 * TIFF's early change, so it shares nothing with lzw_encode_strip).
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
    int count;            /* symbols */
    int defined;
    int overflow;         /* more codes of a length than fit: bad table */
} Huff;

typedef struct {
    int cid, h, v, tq;
    int width, height;     /* downsampled size */
    int blocks_w, blocks_h;
    int16_t *coef;         /* blocks_h * blocks_w blocks, row-major */
    int32_t q[64];         /* the table latched at its first scan */
    int latched;
    int coef_bits[64];     /* progressive: Al of each coefficient, -1 */
    int prev_bits[10];     /* coef_bits[0..9] before the latest scan */
    uint8_t *plane;        /* blocks_h * 8 rows of blocks_w * 8 samples */
} Comp;

/* The codes of one MCU that lj_mcu replays: at most 10 blocks (the
 * header check) of at most 128 each in a sequential scan (a DC length and
 * its bits, and 63 AC lengths and their bits); a progressive AC scan has
 * one block of fewer than 64 * 4. LJ_EVENT fails rather than pass it. */
#define LJ_EVENTS 1400

typedef struct {
    Fail f;
    const uint8_t *data;
    long n;
    int width, height, ncomp, hmax, vmax, progressive;
    int arith;           /* arithmetic-coded (SOF9, SOF10) */
    int lossless;        /* SOF3: samples, not blocks */
    int precision;
    int unit;            /* a component plane's block side: 8, or 1 */
    const char *kind;    /* the frame's name, for messages */
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
    int unread;          /* a marker the decoder ran into (libjpeg's
                          * unread_marker), 0 if none; pos is past it */
    int eof_fill;        /* the data may end early: fill as libjpeg */
    int at_eof;          /* the data ended (not a marker) */
    int ran_out;         /* ... without eof_fill, in a tracked interval */
    /* libjpeg-turbo's own bit buffer over an interval whose data ends
     * without a marker, without eof_fill (see lj_mcu) */
    int track;           /* follow it in this interval */
    long lj_pos;         /* its next byte */
    int lj_bits;         /* its bits_left */
    int nev;             /* this MCU's codes: lengths, extra bits < 0 */
    int16_t ev[LJ_EVENTS];
    int insufficient;    /* ran out of data: later blocks stay zero */
    int std_tables;      /* the standard Huffman tables were installed */
    int eobrun;
    int cut;             /* a scan's data ended early (eof_fill) */
    int last_good;       /* the last iMCU row a cut scan decoded */
    int arith_err;       /* jdarith.c's ct == -1 after a bad code (a
                          * magnitude or a run past the block): nothing
                          * more is decoded until the next restart */
    /* arithmetic decoder (jdarith.c) */
    int64_t ac, aa;      /* the C and A registers */
    int ct;              /* bits left in C's byte buffer; -16 at a start */
    uint8_t dc_l[16], dc_u[16], ac_k[16]; /* DAC conditioning */
    uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin;
    int dc_context[4];
    uint8_t *scratch;    /* upsampled rows, column sums, colour tables */
    uint8_t *filled;     /* a segment cut by the end of the data, filled */
    uint8_t *reset;      /* lossless: the MCU rows that restart prediction */
} Jpeg;

static const int zigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

static int u16be(const uint8_t *p) { return (p[0] << 8) | p[1]; }

/* jdmarker.c next_marker: the next marker from j->pos on, skipping
 * whatever is not one (other bytes, FF 00 pairs; libjpeg warns), fill
 * bytes included; j->pos moves past it. Where the data ends first: the
 * EOI libjpeg's file source appends (eof_fill, cv2.imread), else a
 * refusal (cv2.imdecode's source suspends). */
static int next_marker(Jpeg *j)
{
    for (;;) {
        int c;
        while (j->pos < j->n && j->data[j->pos] != 0xFF) j->pos++;
        while (j->pos < j->n && j->data[j->pos] == 0xFF) j->pos++;
        if (j->pos >= j->n) break;
        c = j->data[j->pos++];
        if (c) return c;
    }
    if (!j->eof_fill) fail(&j->f, "truncated stream (no EOI)");
    j->at_eof = 1;
    return 0xD9;
}

/* The marker to act on next: the one the entropy decoder ran into, or
 * the next in the stream. */
static int take_marker(Jpeg *j)
{
    int m = j->unread;
    if (j->ran_out)
        fail(&j->f, "truncated stream (entropy-coded data ends early)");
    j->unread = 0;
    return m ? m : next_marker(j);
}

/* The payload of the segment whose length field is at j->pos, and its
 * length; j->pos moves past it. With eof_fill a segment cut by the end of
 * the data is completed as libjpeg's file source completes it, with the
 * bytes FF D9 over and over (the EOI it appends at each read past the
 * end), and j->pos stays in that fill: where it ends on an FF, the byte
 * after the segment is the D9 (`fill_byte`). A length field below 2 is
 * refused, or with `lenient` (the markers libjpeg skips or only peeks
 * into: APPn, COM, DNL) read as an empty payload after the field. */
static const uint8_t *segment(Jpeg *j, long *len, int lenient)
{
    long length, k, start = j->pos + 2;
    if (lenient && j->pos + 2 <= j->n && u16be(j->data + j->pos) < 2) {
        j->pos += 2;
        *len = 0;
        return j->data + j->pos;
    }
    if (j->pos + 2 > j->n || j->pos + u16be(j->data + j->pos) > j->n) {
        uint8_t head[2];
        if (!j->eof_fill) fail(&j->f, "truncated marker segment");
        for (k = 0; k < 2; k++) {
            long at = j->pos + k;
            head[k] = at < j->n ? j->data[at] : (at - j->n) % 2 ? 0xD9 : 0xFF;
        }
        length = u16be(head);
        if (length < 2) {
            if (!lenient) fail(&j->f, "truncated marker segment");
            length = 2;
        }
        free(j->filled);
        j->filled = (uint8_t *)malloc((size_t)length);
        if (!j->filled) fail(&j->f, "out of memory");
        for (k = 0; k < length - 2; k++) {
            long at = start + k;
            j->filled[k] = at < j->n ? j->data[at]
                           : (at - j->n) % 2 ? 0xD9 : 0xFF;
        }
        j->pos = start + length - 2 > j->n ? start + length - 2 : j->n;
        *len = length - 2;
        return j->filled;
    }
    length = u16be(j->data + j->pos);
    if (length < 2) fail(&j->f, "truncated marker segment");
    j->pos += length;
    *len = length - 2;
    return j->data + start;
}

/* A frame header. `kind` is the SOF's low nibble: 0, 1 sequential, 2
 * progressive, 3 lossless, 9, 10 their arithmetic-coded counterparts. */
static void parse_sof(Jpeg *j, const uint8_t *p, long len, int kind)
{
    char msg[96];
    int i, precision, nc, mcus_x, mcus_y;
    if (j->ncomp) fail(&j->f, "more than one frame");
    if (len < 6) fail(&j->f, "truncated SOF");
    precision = p[0];
    j->height = u16be(p + 1);
    j->width = u16be(p + 3);
    nc = p[5];
    static const char *kinds[11] = {
        "baseline (SOF0)", "extended sequential (SOF1)", "progressive (SOF2)",
        "lossless (SOF3)", 0, 0, 0, 0, 0,
        "arithmetic-coded sequential (SOF9)",
        "arithmetic-coded progressive (SOF10)"};
    j->kind = kinds[kind];
    j->lossless = kind == 3;
    j->arith = kind >= 8;
    j->unit = j->lossless ? 1 : 8;
    /* libjpeg-turbo reads 12- and 16-bit samples through other calls
     * than the 8-bit ones OpenCV 5 makes: cv2 returns no image for them.
     * Lossless frames of 2 to 8 bits go through the 8-bit calls. */
    if (j->lossless ? precision < 2 || precision > 8 : precision != 8) {
        snprintf(msg, sizeof msg, "%d-bit %s samples are not read (%s)",
                 precision, j->lossless ? "lossless" : "DCT",
                 j->lossless ? "2 to 8 bits only" : "8-bit only");
        fail(&j->f, msg);
    }
    j->precision = precision;
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
    if (len != 6 + 3 * nc) fail(&j->f, "bad SOF length");
    j->hmax = j->vmax = 1;
    for (i = 0; i < nc; i++) {
        Comp *c = &j->comp[i];
        c->cid = p[6 + 3 * i];
        c->h = p[7 + 3 * i] >> 4;
        c->v = p[7 + 3 * i] & 15;
        c->tq = p[8 + 3 * i];
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4) {
            snprintf(msg, sizeof msg,
                     "bad sampling factors in component %d",
                     c->cid);
            fail(&j->f, msg);
        }
        if (c->h > j->hmax) j->hmax = c->h;
        if (c->v > j->vmax) j->vmax = c->v;
    }
    j->ncomp = nc;
    j->progressive = kind == 2 || kind == 10;
    mcus_x = (j->width + j->unit * j->hmax - 1) / (j->unit * j->hmax);
    mcus_y = (j->height + j->unit * j->vmax - 1) / (j->unit * j->vmax);
    for (i = 0; i < nc; i++) {
        Comp *c = &j->comp[i];
        size_t size;
        if (j->hmax % c->h || j->vmax % c->v)
            fail(&j->f, "fractional sampling factors are not read");
        c->width = (int)(((long)j->width * c->h + j->hmax - 1) / j->hmax);
        c->height = (int)(((long)j->height * c->v + j->vmax - 1) / j->vmax);
        c->blocks_w = mcus_x * c->h;
        c->blocks_h = mcus_y * c->v;
        size = (size_t)c->blocks_w * j->unit * (size_t)c->blocks_h * j->unit;
        c->plane = (uint8_t *)malloc(size);
        c->coef = (int16_t *)calloc(size, sizeof(int16_t));
        if (!c->plane || !c->coef) fail(&j->f, "out of memory");
        memset(c->coef_bits, 0xFF, sizeof c->coef_bits); /* all -1 */
    }
}

/* jdmarker.c get_dqt: any nonzero precision nibble means 16-bit values;
 * a table cut short by the segment is refused. */
static void parse_dqt(Jpeg *j, const uint8_t *p, long len)
{
    long pos = 0;
    int k;
    while (pos < len) {
        int pq = p[pos] >> 4, tq = p[pos] & 15, size = pq ? 128 : 64;
        if (tq > 3 || pos + 1 + size > len) fail(&j->f, "bad DQT");
        for (k = 0; k < 64; k++) {
            j->qt[tq][zigzag[k]] = pq ? u16be(p + pos + 1 + 2 * k)
                                      : p[pos + 1 + k];
        }
        j->qt_defined[tq] = 1;
        pos += 1 + size;
    }
}

/* One table from its 16 code counts and its values. Codes that
 * overflow a length leave the table marked, refused where a scan uses it
 * (jpeg_make_d_derived_tbl builds tables then). */
static void build_huff(Huff *t, const uint8_t *counts, const uint8_t *values)
{
    int total = 0, l, i, k = 0;
    int32_t code = 0;
    memset(t, 0, sizeof *t);
    for (l = 1; l <= 16; l++) total += counts[l - 1];
    memcpy(t->values, values, (size_t)total);
    t->count = total;
    for (l = 1; l <= 16; l++) {
        int count = counts[l - 1];
        t->valoffset[l] = k - code;
        for (i = 0; i < count; i++) {
            if (code >= (1 << l)) {
                t->overflow = 1;
                return;
            }
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
}

static void parse_dht(Jpeg *j, const uint8_t *p, long len)
{
    long pos = 0;
    while (len - pos > 16) {
        int tc, th, total = 0, l;
        tc = p[pos] >> 4;
        th = p[pos] & 15;
        for (l = 1; l <= 16; l++) total += p[pos + l];
        if (total > 256 || pos + 17 + total > len)
            fail(&j->f, "bad DHT");
        if (tc > 1 || th > 3) fail(&j->f, "bad DHT table index");
        build_huff(&j->huff[tc][th], p + pos + 1, p + pos + 17);
        j->huff[tc][th].defined = 1;
        pos += 17 + total;
    }
    if (pos != len) fail(&j->f, "bad DHT length");
}

/* ------------------------------------------------------------------ */
/* Entropy-coded data.                                                 */

/* The end of the data where the entropy decoder wants more: with
 * eof_fill the EOI libjpeg's file source appends is the marker it runs
 * into (at_eof); cv2.imdecode's source suspends, which refuses the
 * stream. */
static void data_ends(Jpeg *j)
{
    if (!j->eof_fill) {
        /* Where libjpeg-turbo's own reader decides (lj_mcu), zero bits
         * until it does. */
        if (!j->track)
            fail(&j->f, "truncated stream (entropy-coded data ends early)");
        j->ran_out = 1;
    }
    j->pos = j->n;
    j->unread = 0xD9;
    j->at_eof = 1;
}

/* Past the end of the data (j->pos >= j->n) with eof_fill: the data byte
 * the entropy decoder reads there, or -1 for the EOI it runs into. A scan
 * whose SOS segment the data cut inside its FF D9 fill starts on the D9
 * of that fill, which is no marker: one data byte, then FF D9. */
static int fill_byte(Jpeg *j)
{
    if ((j->pos - j->n) % 2) {
        j->pos++;
        return 0xD9;
    }
    data_ends(j);
    return -1;
}

/* Tops the accumulator up to more than 56 bits, as jdhuff.c's
 * jpeg_fill_bit_buffer: FF 00 is an FF data byte; at a marker (recorded
 * in j->unread) or the end of the data it feeds zero bits, and an MCU
 * that used them leaves the rest of its interval zero (end_mcu). */
static void fill(Jpeg *j)
{
    while (j->nacc <= 56) {
        int b = 0;
        if (!j->unread && j->pos >= j->n) {
            b = fill_byte(j);
            if (b < 0) b = 0;
            else j->real_bits += 8;
        } else if (!j->unread) {
            b = j->data[j->pos++];
            if (b == 0xFF) {
                while (j->pos < j->n && j->data[j->pos] == 0xFF) j->pos++;
                if (j->pos >= j->n) {
                    data_ends(j);
                    b = 0;
                } else if (j->data[j->pos] == 0x00) {
                    j->pos++;
                } else {
                    j->unread = j->data[j->pos++];
                    b = 0;
                }
            }
            if (!j->unread) j->real_bits += 8;
        }
        j->acc |= (uint64_t)b << (56 - j->nacc);
        j->nacc += 8;
    }
}

/* cv2.imdecode's source suspends where libjpeg-turbo asks for a byte past
 * the end of the data, which refuses the stream; where it asks follows
 * its own bit buffer (jdhuff.c), not the port's. It is followed over an
 * interval whose data runs to the end without a marker (lj_start): each
 * MCU's codes are recorded as the port decodes them (LJ_EVENT) and
 * replayed (lj_mcu). jpeg_fill_bit_buffer tops the buffer up to 57 bits
 * where a request finds fewer bits than it needs: 8 for a code's lookup,
 * 9 and then 1 at a time for a longer code, an extra-bits count. */
static void lj_fill(Jpeg *j)
{
    while (j->lj_bits < 57) {
        int c;
        if (j->lj_pos >= j->n)
            fail(&j->f, "truncated stream (entropy-coded data ends early)");
        c = j->data[j->lj_pos++];
        /* FF (FF)* 00 is an FF data byte: there is no marker ahead. */
        while (c == 0xFF) {
            if (j->lj_pos >= j->n)
                fail(&j->f, "truncated stream (entropy-coded data ends "
                            "early)");
            c = j->data[j->lj_pos++];
        }
        j->lj_bits += 8;
    }
}

/* decode_mcu_fast's GET_BYTE: 0 where it meets a marker (an FF not
 * followed by 00), which has the MCU decoded again the slow way. */
static int lj_fast_bytes(Jpeg *j)
{
    int k;
    for (k = 0; k < 6; k++) {
        if (j->lj_pos + 1 >= j->n) return 0;
        if (j->data[j->lj_pos] == 0xFF) {
            if (j->data[j->lj_pos + 1] != 0) return 0;
            j->lj_pos++;
        }
        j->lj_pos++;
        j->lj_bits += 8;
    }
    return 1;
}

/* One MCU's codes through libjpeg-turbo's reader: decode_mcu_fast where
 * no restart interval is set and 512 bytes a block are left (6 bytes
 * read where 16 bits or fewer are left), or where that meets a marker,
 * and otherwise, decode_mcu_slow (and jdlhuff.c, which has no fast
 * path). A request past the end of the data refuses the stream. */
static void lj_mcu(Jpeg *j, int blocks)
{
    long pos = j->lj_pos;
    int bits = j->lj_bits, k, e;
    if (!j->lossless && !j->restart && j->n - pos >= 512L * blocks) {
        for (k = 0; k < j->nev; k++) {
            if (j->lj_bits <= 16 && !lj_fast_bytes(j)) break;
            e = j->ev[k];
            j->lj_bits -= e > 0 ? e : -e;
        }
        if (k == j->nev) {
            j->nev = 0;
            return;
        }
        j->lj_pos = pos;
        j->lj_bits = bits;
    }
    for (k = 0; k < j->nev; k++) {
        e = j->ev[k];
        if (e < 0) {
            if (j->lj_bits < -e) lj_fill(j);
            j->lj_bits += e;
            continue;
        }
        if (j->lj_bits < 8) lj_fill(j);
        if (e <= 8) {
            j->lj_bits -= e;
            continue;
        }
        if (j->lj_bits < 9) lj_fill(j);
        j->lj_bits -= 9;
        for (e -= 9; e > 0; e--) {
            if (j->lj_bits < 1) lj_fill(j);
            j->lj_bits--;
        }
    }
    j->nev = 0;
}

/* At an interval's start: follow libjpeg-turbo's reader where the data
 * may end early for it (no eof_fill, a Huffman-coded sequential or
 * lossless scan) and runs to its end without a marker. */
static void lj_start(Jpeg *j)
{
    long p = j->pos;
    j->track = 0;
    j->nev = 0;
    j->lj_pos = j->pos;
    j->lj_bits = 0;
    if (j->eof_fill || j->arith || j->progressive || j->unread) return;
    for (;;) {
        const uint8_t *ff = (const uint8_t *)memchr(j->data + p, 0xFF,
                                                    (size_t)(j->n - p));
        if (!ff) break;
        p = ff - j->data + 1;
        while (p < j->n && j->data[p] == 0xFF) p++;
        if (p >= j->n) break;
        if (j->data[p++]) return;
    }
    j->track = 1;
}

#define LJ_EVENT(e) \
    do { \
        if (j->track) { \
            if (j->nev == LJ_EVENTS) fail(&j->f, "too many codes in an MCU"); \
            j->ev[j->nev++] = (int16_t)(e); \
        } \
    } while (0)

/* The decoder's bit state lives in locals of decode_block: `acc` holds
 * `nacc` bits, MSB first. */
#define LOAD_BITS() (acc = j->acc, nacc = j->nacc)
#define SAVE_BITS() (j->acc = acc, j->nacc = nacc)
#define NEED_BITS(n) \
    do { if (nacc < (n)) { SAVE_BITS(); fill(j); LOAD_BITS(); } } while (0)
#define DROP_BITS(n) (acc <<= (n), nacc -= (n), used += (n))

/* Codes longer than 9 bits: jdhuff.c's maxcode walk. Where no code of
 * 16 bits or fewer matches, jpeg_huff_decode warns, takes 17 bits and
 * returns symbol 0 (JWRN_HUFF_BAD_CODE). */
static int slow_symbol(const Huff *t, uint64_t acc, int *length)
{
    int l;
    for (l = 10; l <= 16; l++) {
        int32_t code = (int32_t)(acc >> (64 - l));
        if (t->maxcode[l] >= 0 && code <= t->maxcode[l]) {
            *length = l;
            return t->values[(t->valoffset[l] + code) & 0xFF];
        }
    }
    *length = 17;
    return 0;
}

/* jpeg_natural_order with its 16 extra entries of 63, which a run past
 * the block or band writes into. */
static int natural(int k) { return k > 63 ? 63 : zigzag[k]; }

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
        s = slow_symbol(dc, acc, &l);
    }
    DROP_BITS(l);
    LJ_EVENT(l);
    v = s ? (int)(acc >> (64 - s)) : 0;
    DROP_BITS(s);
    if (s) LJ_EVENT(-s);
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
            rs = slow_symbol(ac, acc, &l);
        }
        DROP_BITS(l);
        LJ_EVENT(l);
        r = rs >> 4;
        s = rs & 15;
        if (s == 0) {
            if (r != 15) break;
            k += 16;
            continue;
        }
        /* A run past the block lands on the extra entries of
         * jpeg_natural_order, which are all 63. */
        k += r;
        out[natural(k)] = (int16_t)extend((int)(acc >> (64 - s)), s);
        DROP_BITS(s);
        LJ_EVENT(-s);
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
    LJ_EVENT(-n);
    v = (int)(j->acc >> (64 - n));
    j->acc <<= n;
    j->nacc -= n;
    j->used_bits += n;
    return v;
}

static int huff_symbol(Jpeg *j, const Huff *t)
{
    int look, l, s;
    if (j->nacc < 17) fill(j);
    look = t->lookup[j->acc >> (64 - 9)];
    if (look) {
        l = look >> 8;
        s = look & 0xFF;
    } else {
        s = slow_symbol(t, j->acc, &l);
    }
    LJ_EVENT(l);
    j->acc <<= l;
    j->nacc -= l;
    j->used_bits += l;
    return s;
}

static void dc_first(Jpeg *j, const Huff *dc, int *pred, int al,
                     int16_t *blk)
{
    int s = huff_symbol(j, dc);
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
/* Arithmetic decoding (jdarith.c, the Q-coder of T.81 Annex D).        */

/* jaricom.c's jpeg_aritab: Qe << 16 | next MPS index << 8 | switch << 7 |
 * next LPS index; entry 113 is the fixed probability of sign bits and
 * refinements. Exported for the test that holds it to libjpeg-turbo's. */
#define QE(qe, lps, mps, sw) ((int32_t)(qe) << 16 | (mps) << 8 | (sw) << 7 | (lps))
const int32_t jpeg_arith_table[114] = {
    QE(0x5a1d, 1, 1, 1), QE(0x2586, 14, 2, 0), QE(0x1114, 16, 3, 0),
    QE(0x080b, 18, 4, 0), QE(0x03d8, 20, 5, 0), QE(0x01da, 23, 6, 0),
    QE(0x00e5, 25, 7, 0), QE(0x006f, 28, 8, 0), QE(0x0036, 30, 9, 0),
    QE(0x001a, 33, 10, 0), QE(0x000d, 35, 11, 0), QE(0x0006, 9, 12, 0),
    QE(0x0003, 10, 13, 0), QE(0x0001, 12, 13, 0), QE(0x5a7f, 15, 15, 1),
    QE(0x3f25, 36, 16, 0), QE(0x2cf2, 38, 17, 0), QE(0x207c, 39, 18, 0),
    QE(0x17b9, 40, 19, 0), QE(0x1182, 42, 20, 0), QE(0x0cef, 43, 21, 0),
    QE(0x09a1, 45, 22, 0), QE(0x072f, 46, 23, 0), QE(0x055c, 48, 24, 0),
    QE(0x0406, 49, 25, 0), QE(0x0303, 51, 26, 0), QE(0x0240, 52, 27, 0),
    QE(0x01b1, 54, 28, 0), QE(0x0144, 56, 29, 0), QE(0x00f5, 57, 30, 0),
    QE(0x00b7, 59, 31, 0), QE(0x008a, 60, 32, 0), QE(0x0068, 62, 33, 0),
    QE(0x004e, 63, 34, 0), QE(0x003b, 32, 35, 0), QE(0x002c, 33, 9, 0),
    QE(0x5ae1, 37, 37, 1), QE(0x484c, 64, 38, 0), QE(0x3a0d, 65, 39, 0),
    QE(0x2ef1, 67, 40, 0), QE(0x261f, 68, 41, 0), QE(0x1f33, 69, 42, 0),
    QE(0x19a8, 70, 43, 0), QE(0x1518, 72, 44, 0), QE(0x1177, 73, 45, 0),
    QE(0x0e74, 74, 46, 0), QE(0x0bfb, 75, 47, 0), QE(0x09f8, 77, 48, 0),
    QE(0x0861, 78, 49, 0), QE(0x0706, 79, 50, 0), QE(0x05cd, 48, 51, 0),
    QE(0x04de, 50, 52, 0), QE(0x040f, 50, 53, 0), QE(0x0363, 51, 54, 0),
    QE(0x02d4, 52, 55, 0), QE(0x025c, 53, 56, 0), QE(0x01f8, 54, 57, 0),
    QE(0x01a4, 55, 58, 0), QE(0x0160, 56, 59, 0), QE(0x0125, 57, 60, 0),
    QE(0x00f6, 58, 61, 0), QE(0x00cb, 59, 62, 0), QE(0x00ab, 61, 63, 0),
    QE(0x008f, 61, 32, 0), QE(0x5b12, 65, 65, 1), QE(0x4d04, 80, 66, 0),
    QE(0x412c, 81, 67, 0), QE(0x37d8, 82, 68, 0), QE(0x2fe8, 83, 69, 0),
    QE(0x293c, 84, 70, 0), QE(0x2379, 86, 71, 0), QE(0x1edf, 87, 72, 0),
    QE(0x1aa9, 87, 73, 0), QE(0x174e, 72, 74, 0), QE(0x1424, 72, 75, 0),
    QE(0x119c, 74, 76, 0), QE(0x0f6b, 74, 77, 0), QE(0x0d51, 75, 78, 0),
    QE(0x0bb6, 77, 79, 0), QE(0x0a40, 77, 48, 0), QE(0x5832, 80, 81, 1),
    QE(0x4d1c, 88, 82, 0), QE(0x438e, 89, 83, 0), QE(0x3bdd, 90, 84, 0),
    QE(0x34ee, 91, 85, 0), QE(0x2eae, 92, 86, 0), QE(0x299a, 93, 87, 0),
    QE(0x2516, 86, 71, 0), QE(0x5570, 88, 89, 1), QE(0x4ca9, 95, 90, 0),
    QE(0x44d9, 96, 91, 0), QE(0x3e22, 97, 92, 0), QE(0x3824, 99, 93, 0),
    QE(0x32b4, 99, 94, 0), QE(0x2e17, 93, 86, 0), QE(0x56a8, 95, 96, 1),
    QE(0x4f46, 101, 97, 0), QE(0x47e5, 102, 98, 0), QE(0x41cf, 103, 99, 0),
    QE(0x3c3d, 104, 100, 0), QE(0x375e, 99, 93, 0), QE(0x5231, 105, 102, 0),
    QE(0x4c0f, 106, 103, 0), QE(0x4639, 107, 104, 0),
    QE(0x415e, 103, 99, 0), QE(0x5627, 105, 106, 1),
    QE(0x50e7, 108, 107, 0), QE(0x4b85, 109, 103, 0),
    QE(0x5597, 110, 109, 0), QE(0x504f, 111, 107, 0),
    QE(0x5a10, 110, 111, 1), QE(0x5522, 112, 109, 0),
    QE(0x59eb, 112, 111, 1), QE(0x5a1d, 113, 113, 0)};

/* The next byte of the scan (jdarith.c get_byte), 0 from a marker on,
 * which j->unread records. Where the data ends: zeros with eof_fill (the
 * EOI libjpeg's file source appends), else a refusal (jdarith.c cannot
 * suspend). */
static int arith_byte(Jpeg *j)
{
    int d;
    if (j->unread) return 0;
    if (j->pos >= j->n) return (d = fill_byte(j)) < 0 ? 0 : d;
    d = j->data[j->pos++];
    if (d != 0xFF) return d;
    while (j->pos < j->n && j->data[j->pos] == 0xFF) j->pos++;
    if (j->pos >= j->n) {
        data_ends(j);
        return 0;
    }
    if (j->data[j->pos] == 0) {
        j->pos++;
        return 0xFF;
    }
    j->unread = j->data[j->pos++];
    return 0;
}

/* jdarith.c arith_decode: one binary decision with statistics bin *st. */
static int arith_decode(Jpeg *j, uint8_t *st)
{
    int sv, nl, nm;
    int64_t qe, temp;
    while (j->aa < 0x8000) {
        if (--j->ct < 0) {
            j->ac = (j->ac << 8) | arith_byte(j);
            if ((j->ct += 8) < 0) {
                if (++j->ct == 0) j->aa = 0x8000;
            }
        }
        j->aa <<= 1;
    }
    sv = *st;
    qe = jpeg_arith_table[sv & 0x7F];
    nl = (int)(qe & 0xFF);
    qe >>= 8;
    nm = (int)(qe & 0xFF);
    qe >>= 8;
    temp = j->aa - qe;
    j->aa = temp;
    temp <<= j->ct;
    if (j->ac >= temp) {
        j->ac -= temp;
        if (j->aa < qe) {
            j->aa = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            j->aa = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (j->aa < 0x8000) {
        if (j->aa < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

/* A DC difference (Figures F.19-F.24), updating the component's
 * conditioning context; dc_tbl is the DC statistics area. */
static int arith_dc_diff(Jpeg *j, int tbl, int *context)
{
    uint8_t *st = j->dc_stats[tbl] + *context;
    int sign, m, v;
    if (arith_decode(j, st) == 0) {
        *context = 0;
        return 0;
    }
    sign = arith_decode(j, st + 1);
    st += 2 + sign;
    if ((m = arith_decode(j, st)) != 0) {
        st = j->dc_stats[tbl] + 20;
        while (arith_decode(j, st)) {
            if ((m <<= 1) == 0x8000) {
                j->arith_err = 1;
                return 0;
            }
            st++;
        }
    }
    if (m < (int)((1L << j->dc_l[tbl]) >> 1))
        *context = 0;
    else if (m > (int)((1L << j->dc_u[tbl]) >> 1))
        *context = 12 + sign * 4;
    else
        *context = 4 + sign * 4;
    v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(j, st)) v |= m;
    v += 1;
    return sign ? -v : v;
}

/* An AC value once its position is known: sign and magnitude. `st` is
 * the position's statistics (3 bins a position), k its index. */
static int arith_ac_value(Jpeg *j, int tbl, uint8_t *st, int k)
{
    int sign = arith_decode(j, &j->fixed_bin), m, v;
    st += 2;
    if ((m = arith_decode(j, st)) != 0) {
        if (arith_decode(j, st)) {
            m <<= 1;
            st = j->ac_stats[tbl] + (k <= j->ac_k[tbl] ? 189 : 217);
            while (arith_decode(j, st)) {
                if ((m <<= 1) == 0x8000) {
                    j->arith_err = 1;
                    return 0;
                }
                st++;
            }
        }
    }
    v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(j, st)) v |= m;
    v += 1;
    return sign ? -v : v;
}

/* decode_mcu's AC part (sequential), or decode_mcu_AC_first: positions
 * ss..se, values shifted up by al. */
static void arith_ac_first(Jpeg *j, int tbl, int ss, int se, int al,
                           int16_t *blk)
{
    int k, v;
    for (k = ss; k <= se; k++) {
        uint8_t *st = j->ac_stats[tbl] + 3 * (k - 1);
        if (arith_decode(j, st)) break; /* EOB */
        while (arith_decode(j, st + 1) == 0) {
            st += 3;
            if (++k > se) {
                j->arith_err = 1;
                return;
            }
        }
        v = arith_ac_value(j, tbl, st, k);
        if (j->arith_err) return;
        blk[zigzag[k]] = (int16_t)(uint16_t)((unsigned)v << al);
    }
}

/* decode_mcu_AC_refine. */
static void arith_ac_refine(Jpeg *j, int tbl, int ss, int se, int al,
                            int16_t *blk)
{
    int p1 = 1 << al, m1 = -1 * (1 << al), k, kex;
    for (kex = se; kex > 0; kex--)
        if (blk[zigzag[kex]]) break;
    for (k = ss; k <= se; k++) {
        uint8_t *st = j->ac_stats[tbl] + 3 * (k - 1);
        if (k > kex && arith_decode(j, st)) break; /* EOB */
        for (;;) {
            int16_t *c = blk + zigzag[k];
            if (*c) {
                if (arith_decode(j, st + 2))
                    *c = (int16_t)(*c + (*c < 0 ? m1 : p1));
                break;
            }
            if (arith_decode(j, st + 1)) {
                *c = (int16_t)(arith_decode(j, &j->fixed_bin) ? m1 : p1);
                break;
            }
            st += 3;
            if (++k > se) {
                j->arith_err = 1;
                return;
            }
        }
    }
}

/* The start of a scan or of a restart interval (start_pass,
 * process_restart): statistics cleared, the registers reset. */
static void arith_reset(Jpeg *j, Comp **comps, const int *td, const int *ta,
                        int ns, int ss, int ah, int *last_dc)
{
    int i;
    for (i = 0; i < ns; i++) {
        if (!j->progressive || (ss == 0 && ah == 0)) {
            memset(j->dc_stats[td[i]], 0, sizeof j->dc_stats[0]);
            last_dc[i] = 0;
            j->dc_context[i] = 0;
        }
        if (!j->progressive || ss != 0)
            memset(j->ac_stats[ta[i]], 0, sizeof j->ac_stats[0]);
    }
    (void)comps;
    j->ac = 0;
    j->aa = 0;
    j->ct = -16;
    j->arith_err = 0;
}

/* One block of an arithmetic-coded scan. */
static void arith_block(Jpeg *j, int td, int ta, int *last_dc, int *context,
                        int ss, int se, int ah, int al, int16_t *blk)
{
    int d;
    if (j->arith_err) return;
    if (!j->progressive) {
        d = arith_dc_diff(j, td, context);
        if (j->arith_err) return;
        *last_dc = (*last_dc + d) & 0xFFFF;
        blk[0] = (int16_t)(uint16_t)*last_dc;
        arith_ac_first(j, ta, 1, 63, 0, blk);
    } else if (ss == 0 && ah == 0) {
        d = arith_dc_diff(j, td, context);
        if (j->arith_err) return;
        *last_dc = (*last_dc + d) & 0xFFFF;
        blk[0] = (int16_t)(uint16_t)((unsigned)*last_dc << al);
    } else if (ss == 0) {
        if (arith_decode(j, &j->fixed_bin)) blk[0] = (int16_t)(blk[0] | (1 << al));
    } else if (ah == 0) {
        arith_ac_first(j, ta, ss, se, al, blk);
    } else {
        arith_ac_refine(j, ta, ss, se, al, blk);
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

/* jdmarker.c read_restart_marker with jpeg_resync_to_restart, at the
 * start of every restart interval but the first: the marker the decoder
 * ran into, or the next one. RSTn as expected is taken; otherwise (libjpeg
 * warns) one that is no marker of a frame (below SOF0) or a restart
 * marker one or two behind is skipped for the next, one that is a
 * restart marker one or two ahead or any other frame marker is left
 * where it is (the interval reads no data), and any other restart marker
 * is taken as if it were the one expected. */
static void read_restart_marker(Jpeg *j, int want)
{
    int m = take_marker(j);
    for (;;) {
        int ahead = m == 0xD0 + ((want + 1) & 7) || m == 0xD0 + ((want + 2) & 7);
        int behind = m == 0xD0 + ((want - 1) & 7) || m == 0xD0 + ((want - 2) & 7);
        if (m == 0xD0 + want) return;
        if (m < 0xC0 || (m >= 0xD0 && m <= 0xD7 && behind)) {
            m = next_marker(j);
            continue;
        }
        if (m < 0xD0 || m > 0xD7 || ahead) {
            j->unread = m;
            return;
        }
        return;
    }
}

/* jdphuff.c's checks of a progressive scan's Ss, Se, Ah and Al, and the
 * update of each coefficient's Al (coef_bits). A scan whose Ah does not
 * follow the last one, or an AC scan before the DC one, is decoded as it
 * says (libjpeg warns); bad parameters are refused. */
static void progression(Jpeg *j, Comp **comps, int ns, int ss, int se,
                        int ah, int al)
{
    int i, k, bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    char msg[96];
    if ((ah != 0 && al != ah - 1) || al > 13 || bad) {
        snprintf(msg, sizeof msg, "bad scan parameters in a %s frame",
                 j->kind);
        fail(&j->f, msg);
    }
    for (i = 0; i < ns; i++) {
        Comp *c = comps[i];
        /* jdphuff.c start_pass's copy, for smoothing a cut scan's rows. */
        for (k = ss < 1 ? ss : 1; k <= 9; k++)
            c->prev_bits[k] = j->scans ? c->coef_bits[k] : 0;
        for (k = ss; k <= se; k++) c->coef_bits[k] = al;
    }
}

/* After an MCU: bits used past a marker (or the end of the data) start
 * jdhuff.c's insufficient_data: the MCU keeps what it decoded from the
 * zero bits, and the rest of the interval stays zero. */
static void end_mcu(Jpeg *j)
{
    if (j->used_bits > j->real_bits) j->insufficient = 1;
}

/* jdlossls.c: a lossless component's samples from its differences, row
 * by row: the first row of the image and of each MCU row marked in
 * `reset` (`v` rows each: a restart, or data that had run out, decoded
 * as zero differences) from its left neighbour (the first sample from
 * 1 << (P - Pt - 1)), every other row's first sample from the one above
 * and the rest by predictor `psv`, all modulo 2^16; then shifted up by
 * the point transform `pt` and cut to 8 bits. */
static void undifference(Jpeg *j, Comp *c, int psv, int pt,
                         const uint8_t *reset, int v)
{
    int x, y, w = c->width, stride = c->blocks_w;
    int *prev = (int *)malloc(sizeof(int) * (size_t)w * 2), *cur;
    if (!prev) fail(&j->f, "out of memory");
    cur = prev + w;
    for (y = 0; y < c->height; y++) {
        const int16_t *d = c->coef + (size_t)y * stride;
        uint8_t *o = c->plane + (size_t)y * stride;
        int *t;
        if (y == 0 || (y % v == 0 && reset[y / v])) {
            int ra = (int)((uint16_t)d[0] + (1 << (j->precision - pt - 1)))
                     & 0xFFFF;
            cur[0] = ra;
            for (x = 1; x < w; x++) cur[x] = ra = ((uint16_t)d[x] + ra) & 0xFFFF;
        } else {
            int ra, rb = prev[0], rc, pred;
            cur[0] = ra = ((uint16_t)d[0] + rb) & 0xFFFF;
            for (x = 1; x < w; x++) {
                rc = rb;
                rb = prev[x];
                switch (psv) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                default: pred = (ra + rb) >> 1; break;
                }
                cur[x] = ra = ((uint16_t)d[x] + pred) & 0xFFFF;
            }
        }
        for (x = 0; x < w; x++) o[x] = (uint8_t)(cur[x] << pt);
        t = prev;
        prev = cur;
        cur = t;
    }
    free(prev < cur ? prev : cur);
}

/* jdlhuff.c: one sample's difference. */
static int lossless_diff(Jpeg *j, const Huff *dc)
{
    int s = huff_symbol(j, dc);
    if (s == 16) return 32768;
    return s ? extend(get_bits(j, s), s) : 0;
}

/* jdhuff.c's std_huff_tables: where the first scan of a sequential
 * Huffman-coded frame starts, tables 0 and 1 that no DHT defined take the
 * standard ones (Motion JPEG); progressive and lossless frames get none. */
static const uint8_t dc_luma[28], ac_luma[178], dc_chroma[28], ac_chroma[178];

static void standard_tables(Jpeg *j)
{
    static const uint8_t *const spec[2][2] = {{dc_luma, dc_chroma},
                                             {ac_luma, ac_chroma}};
    int tc, th;
    for (tc = 0; tc < 2; tc++) {
        for (th = 0; th < 2; th++) {
            Huff *t = &j->huff[tc][th];
            if (t->defined) continue;
            build_huff(t, spec[tc][th], spec[tc][th] + 16);
            t->defined = 1;
        }
    }
}

/* jpeg_make_d_derived_tbl's checks of a table a scan uses. */
static const Huff *scan_table(Jpeg *j, int tc, int th)
{
    const Huff *t;
    int k;
    if (th > 3 || !j->huff[tc][th].defined)
        fail(&j->f, "SOS uses an undefined Huffman table");
    t = &j->huff[tc][th];
    if (t->overflow) fail(&j->f, "bad Huffman table");
    if (tc == 0) {
        for (k = 0; k < t->count; k++)
            if (t->values[k] > (j->lossless ? 16 : 15))
                fail(&j->f, "bad Huffman table (DC symbol out of range)");
    }
    return t;
}

/* One scan, as libjpeg-turbo decodes it: restart intervals resynchronised
 * by read_restart_marker, data that runs into a marker finished on zero
 * bits (end_mcu), arithmetic intervals dropped after a bad code. Without
 * `decode`, only the checks of its header and tables. */
static void decode_scan(Jpeg *j, const uint8_t *p, long len, int decode)
{
    Comp *comps[4];
    const Huff *dc[4], *ac[4];
    int td[4], ta[4], preds[4] = {0, 0, 0, 0};
    int ns, i, units_x, units_y, togo, want = 0, skip_row = 0, blocks;
    int ss, se, ah, al;
    long total, u;
    uint8_t *reset = NULL;
    char msg[96];
    ns = len > 0 ? p[0] : 0;
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) fail(&j->f, "bad SOS");
    ss = p[1 + 2 * ns];
    se = p[2 + 2 * ns];
    ah = p[3 + 2 * ns] >> 4;
    al = p[3 + 2 * ns] & 15;
    if (!j->scans && !j->arith && !j->progressive && !j->lossless)
        standard_tables(j);
    for (i = 0; i < ns; i++) {
        int cid = p[1 + 2 * i], t = p[2 + 2 * i], c, k, need_dc, need_ac;
        /* jdmarker.c get_sos matches the id against the frame's components
         * from the i-th on, and refuses one named twice. */
        comps[i] = NULL;
        for (c = i; c < j->ncomp && !comps[i]; c++) {
            if (j->comp[c].cid == cid) comps[i] = &j->comp[c];
        }
        for (k = 0; k < i && comps[i]; k++)
            if (comps[k] == comps[i]) comps[i] = NULL;
        if (!comps[i]) {
            snprintf(msg, sizeof msg, "SOS names unknown component %d", cid);
            fail(&j->f, msg);
        }
        /* Progressive scans use one kind of table, first DC scans only;
         * lossless scans DC tables only; arithmetic coding none. */
        need_dc = !j->progressive || (ss == 0 && ah == 0);
        need_ac = !j->lossless && (!j->progressive || ss != 0);
        td[i] = t >> 4;
        ta[i] = t & 15;
        dc[i] = &j->huff[0][td[i] & 3];
        ac[i] = &j->huff[1][ta[i] & 3];
        if (!j->arith && need_dc) dc[i] = scan_table(j, 0, td[i]);
        if (!j->arith && need_ac) ac[i] = scan_table(j, 1, ta[i]);
        if (!comps[i]->latched && !j->lossless) {
            if (comps[i]->tq > 3 || !j->qt_defined[comps[i]->tq])
                fail(&j->f, "component uses an undefined quantisation "
                            "table");
            memcpy(comps[i]->q, j->qt[comps[i]->tq], sizeof comps[i]->q);
            comps[i]->latched = 1;
        }
    }
    if (j->lossless && (ss < 1 || ss > 7 || se != 0 || ah != 0
                        || al >= j->precision)) {
        snprintf(msg, sizeof msg, "bad scan parameters in a %s frame",
                 j->kind);
        fail(&j->f, msg);
    }
    if (j->progressive) progression(j, comps, ns, ss, se, ah, al);
    if (ns == 1) {
        units_x = (comps[0]->width + j->unit - 1) / j->unit;
        units_y = (comps[0]->height + j->unit - 1) / j->unit;
    } else {
        int blocks = 0;
        for (i = 0; i < ns; i++) blocks += comps[i]->h * comps[i]->v;
        if (blocks > 10) fail(&j->f, "too many blocks in an MCU");
        units_x = (j->width + j->unit * j->hmax - 1) / (j->unit * j->hmax);
        units_y = (j->height + j->unit * j->vmax - 1) / (j->unit * j->vmax);
    }
    total = (long)units_x * units_y;
    if (j->lossless && j->restart && j->restart % units_x)
        fail(&j->f, "lossless restart interval not a multiple of the MCUs "
                    "in a row");
    if (!decode) return;
    if (j->lossless) {
        free(j->reset);
        reset = j->reset = (uint8_t *)calloc((size_t)units_y, 1);
        if (!reset) fail(&j->f, "out of memory");
    }
    j->insufficient = 0;
    j->acc = 0;
    j->nacc = 0;
    j->real_bits = j->used_bits = 0;
    j->eobrun = 0;
    if (j->arith) arith_reset(j, comps, td, ta, ns, ss, ah, preds);
    lj_start(j);
    blocks = 0;
    for (i = 0; i < ns; i++)
        blocks += ns == 1 ? 1 : comps[i]->h * comps[i]->v;
    togo = j->restart;
    for (u = 0; u < total; u++) {
        int uy = (int)(u / units_x), ux = (int)(u % units_x);
        if (j->restart) {
            if (togo == 0) {
                /* process_restart: the bits left are dropped, the
                 * predictors and EOB run reset; the data counts as there
                 * again unless the interval starts at a marker. */
                j->acc = 0;
                j->nacc = 0;
                j->real_bits = j->used_bits = 0;
                read_restart_marker(j, want);
                want = (want + 1) & 7;
                for (i = 0; i < 4; i++) preds[i] = 0;
                j->eobrun = 0;
                if (j->arith)
                    arith_reset(j, comps, td, ta, ns, ss, ah, preds);
                else if (!j->unread)
                    j->insufficient = 0;
                if (j->lossless) reset[uy] = 1;
                lj_start(j);
                togo = j->restart;
            }
            togo--;
        }
        /* jdlhuff.c finishes the MCU row in which the data ran out on zero
         * bits; a later row is zero differences from a reset predictor.
         * The DCT decoders leave every later MCU of the interval zero. */
        if (j->lossless) {
            if (ux == 0) skip_row = j->insufficient;
            if (skip_row) {
                reset[uy] = 1;
                continue;
            }
        } else if (j->insufficient) {
            continue;
        }
        j->last_good = ns == 1 ? uy / comps[0]->v : uy;
        for (i = 0; i < ns; i++) {
            Comp *c = comps[i];
            int v = ns == 1 ? 1 : c->v, h = ns == 1 ? 1 : c->h, by, bx;
            for (by = 0; by < v; by++) {
                for (bx = 0; bx < h; bx++) {
                    int row = uy * v + by, col = ux * h + bx;
                    size_t at = (size_t)row * c->blocks_w + col;
                    int16_t *blk = j->lossless ? NULL : c->coef + at * 64;
                    if (j->lossless)
                        c->coef[at] = (int16_t)(uint16_t)
                            lossless_diff(j, dc[i]);
                    else if (j->arith)
                        arith_block(j, td[i], ta[i], &preds[i],
                                    &j->dc_context[i], ss, se, ah, al,
                                    blk);
                    else if (!j->progressive)
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
        if (j->track) lj_mcu(j, blocks);
        if (!j->arith) end_mcu(j);
        else if (j->at_eof) j->cut = 1;
    }
    if (j->insufficient) j->cut = 1;
    if (j->lossless) {
        for (i = 0; i < ns; i++)
            undifference(j, comps[i], ss, al, reset,
                         ns == 1 ? 1 : comps[i]->v);
    }
}

static int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

/* libjpeg's smoothing_ok: a progressive image takes inter-block
 * smoothing where every component's DC has been seen, its quantisers of
 * coefficients 0-9 are nonzero, and some component's coefficient 1..9
 * has not reached Al = 0. */
static int takes_smoothing(const Jpeg *j)
{
    static const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    int i, k, useful = 0;
    if (!j->progressive) return 0;
    for (i = 0; i < j->ncomp; i++) {
        if (j->comp[i].coef_bits[0] < 0) return 0;
        for (k = 0; k < 10; k++)
            if (j->comp[i].q[pos[k]] == 0) return 0;
        for (k = 1; k < 10; k++) useful |= j->comp[i].coef_bits[k] != 0;
    }
    return useful;
}

/* jdcoefct.c decompress_smooth_data's estimate of one coefficient: the
 * rounded quotient of num by Q << 8, limited below 1 << Al when Al > 0. */
static int smooth_pred(int64_t num, int64_t q, int al)
{
    int64_t pred;
    if (num >= 0) {
        pred = ((q << 7) + num) / (q << 8);
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        return (int)pred;
    }
    pred = ((q << 7) - num) / (q << 8);
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    return (int)-pred;
}

/* libjpeg-turbo 3's decompress_smooth_data for component c: every block
 * of the component's image rows, its zero coefficients 1..9 that are not
 * yet exact estimated from the DC values of a 5x5 neighbourhood (the DC
 * too where no AC has been seen), then the IDCT. Neighbour columns are
 * clamped to the component's blocks. Neighbour rows are clamped as
 * libjpeg-turbo clamps them: it numbers a block row as the iMCU row
 * times this iMCU row's block rows, plus the row in it, and holds that
 * number against this iMCU row's block rows times the iMCU rows. Both
 * count the last iMCU row's real block rows where that row is partial
 * (a vertical factor of 3 or 4, or 2 with an odd height in blocks): the
 * neighbours taken there are not the true row's. Elsewhere the clamp can
 * reach the dummy rows of the last iMCU row. */
static void smooth_component(Jpeg *j, Comp *c)
{
    int prev[10], k;
    const int *bits;
    const int32_t *q = c->q;
    int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9];
    int64_t Q02 = q[2], Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
    int change_dc, v = c->v, stride = c->blocks_w * 8;
    int hib = (c->height + 7) / 8, wib = (c->width + 7) / 8;
    int imcus = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
    int last = imcus - 1, im, br, last_col = wib - 1;
    /* iMCU rows past the last one a cut scan decoded take the
     * coefficient bits from before that scan (-1 after a single scan). */
    for (k = 1; k < 10; k++) prev[k] = j->scans > 1 ? c->prev_bits[k] : -1;
    for (im = 0; im < imcus; im++) {
        int rows = im < last ? v : (hib % v ? hib % v : v);
        bits = j->cut && im > j->last_good ? prev : c->coef_bits;
        change_dc = 1;
        for (k = 1; k < 10; k++) change_dc &= bits[k] == -1;
        /* As libjpeg-turbo counts them: this iMCU row's block rows times
         * the iMCU rows, and the block row `at` among them. */
        int image_rows = rows * imcus;
        for (br = 0; br < rows; br++) {
            int r = im * v + br, at = im * rows + br, rr[5], col, i;
            int dc[5][5];
            const int16_t *row[5];
            rr[2] = r;
            rr[1] = at > 0 ? r - 1 : r;
            rr[0] = at > 1 ? r - 2 : rr[1];
            rr[3] = at < image_rows - 1 ? r + 1 : r;
            rr[4] = at < image_rows - 2 ? r + 2 : rr[3];
            for (i = 0; i < 5; i++)
                row[i] = c->coef + (size_t)rr[i] * c->blocks_w * 64;
            for (col = 0; col <= last_col; col++) {
                int16_t w[64];
                int64_t num;
                int al, x;
                memcpy(w, row[2] + (size_t)col * 64, sizeof w);
                for (x = 0; x < 5; x++) {
                    int cx = clampi(col + x - 2, 0, last_col);
                    for (i = 0; i < 5; i++)
                        dc[i][x] = row[i][(size_t)cx * 64];
                }
#define DC(n) ((int64_t)dc[((n) - 1) / 5][((n) - 1) % 5])
                if ((al = bits[1]) != 0 && w[1] == 0) {
                    num = Q00 * (change_dc ?
                        (-DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6)
                         + 13 * DC(7) - 13 * DC(9) + 3 * DC(10) - 3 * DC(11)
                         + 38 * DC(12) - 38 * DC(14) + 3 * DC(15)
                         - 3 * DC(16) + 13 * DC(17) - 13 * DC(19)
                         + 3 * DC(20) - DC(21) - DC(22) + DC(24) + DC(25)) :
                        (-7 * DC(11) + 50 * DC(12) - 50 * DC(14)
                         + 7 * DC(15)));
                    w[1] = (int16_t)smooth_pred(num, Q01, al);
                }
                if ((al = bits[2]) != 0 && w[8] == 0) {
                    num = Q00 * (change_dc ?
                        (-DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5)
                         - DC(6) + 13 * DC(7) + 38 * DC(8) + 13 * DC(9)
                         - DC(10) + DC(16) - 13 * DC(17) - 38 * DC(18)
                         - 13 * DC(19) + DC(20) + DC(21) + 3 * DC(22)
                         + 3 * DC(23) + 3 * DC(24) + DC(25)) :
                        (-7 * DC(3) + 50 * DC(8) - 50 * DC(18)
                         + 7 * DC(23)));
                    w[8] = (int16_t)smooth_pred(num, Q10, al);
                }
                if ((al = bits[3]) != 0 && w[16] == 0) {
                    num = Q00 * (change_dc ?
                        (DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9)
                         - 5 * DC(12) - 14 * DC(13) - 5 * DC(14)
                         + 2 * DC(17) + 7 * DC(18) + 2 * DC(19) + DC(23)) :
                        (-DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18)
                         - DC(23)));
                    w[16] = (int16_t)smooth_pred(num, Q20, al);
                }
                if ((al = bits[4]) != 0 && w[9] == 0) {
                    num = Q00 * (change_dc ?
                        (-DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17)
                         + 9 * DC(19) + DC(21) - DC(25)) :
                        (DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19)
                         - DC(2) - DC(20) + DC(22) - DC(24) + DC(4) - DC(6)
                         + 10 * DC(7) - 10 * DC(9)));
                    w[9] = (int16_t)smooth_pred(num, Q11, al);
                }
                if ((al = bits[5]) != 0 && w[2] == 0) {
                    num = Q00 * (change_dc ?
                        (2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11)
                         + 7 * DC(12) - 14 * DC(13) + 7 * DC(14) + DC(15)
                         + 2 * DC(17) - 5 * DC(18) + 2 * DC(19)) :
                        (-DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14)
                         - DC(15)));
                    w[2] = (int16_t)smooth_pred(num, Q02, al);
                }
                if (change_dc) {
                    if ((al = bits[6]) != 0 && w[3] == 0) {
                        num = Q00 * (DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14)
                                     + DC(17) - DC(19));
                        w[3] = (int16_t)smooth_pred(num, Q03, al);
                    }
                    if ((al = bits[7]) != 0 && w[10] == 0) {
                        num = Q00 * (DC(7) - 3 * DC(8) + DC(9) - DC(17)
                                     + 3 * DC(18) - DC(19));
                        w[10] = (int16_t)smooth_pred(num, Q12, al);
                    }
                    if ((al = bits[8]) != 0 && w[17] == 0) {
                        num = Q00 * (DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14)
                                     + DC(17) - DC(19));
                        w[17] = (int16_t)smooth_pred(num, Q21, al);
                    }
                    if ((al = bits[9]) != 0 && w[24] == 0) {
                        num = Q00 * (DC(7) + 2 * DC(8) + DC(9) - DC(17)
                                     - 2 * DC(18) - DC(19));
                        w[24] = (int16_t)smooth_pred(num, Q30, al);
                    }
                    num = Q00 * (-2 * DC(1) - 6 * DC(2) - 8 * DC(3)
                                 - 6 * DC(4) - 2 * DC(5) - 6 * DC(6)
                                 + 6 * DC(7) + 42 * DC(8) + 6 * DC(9)
                                 - 6 * DC(10) - 8 * DC(11) + 42 * DC(12)
                                 + 152 * DC(13) + 42 * DC(14) - 8 * DC(15)
                                 - 6 * DC(16) + 6 * DC(17) + 42 * DC(18)
                                 + 6 * DC(19) - 6 * DC(20) - 2 * DC(21)
                                 - 6 * DC(22) - 8 * DC(23) - 6 * DC(24)
                                 - 2 * DC(25));
                    w[0] = (int16_t)smooth_pred(num, Q00, 0);
                }
#undef DC
                idct_islow(w, q, c->plane + (size_t)r * 8 * stride
                                      + (size_t)col * 8, stride);
            }
        }
    }
}

/* Every block of every component through the IDCT, after the scans;
 * progressive images that take it through block smoothing. */
static void inverse_dct(Jpeg *j)
{
    int i, by, bx, smooth = takes_smoothing(j);
    if (j->lossless) return;
    for (i = 0; i < j->ncomp; i++) {
        Comp *c = &j->comp[i];
        int stride = c->blocks_w * 8;
        if (smooth) {
            smooth_component(j, c);
            continue;
        }
        for (by = 0; by < c->blocks_h; by++) {
            for (bx = 0; bx < c->blocks_w; bx++) {
                idct_islow(c->coef + ((size_t)by * c->blocks_w + bx) * 64,
                           c->q, c->plane + (size_t)by * 8 * stride
                                     + (size_t)bx * 8, stride);
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* Upsampling and colour (jdsample.c, jdcolor.c).                      */

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
    int stride = c->blocks_w * j->unit, W = j->width, x;
    const uint8_t *p = c->plane;
    /* Lossless frames have 1x1 "blocks": jdsample.c takes no fancy
     * upsampling there. */
    int fancy = !j->lossless;
    if (fancy && fv == 2 && (fh == 1 || (fh == 2 && c->width > 2))) {
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
        } else if (fancy && fh == 2 && fv == 1 && c->width > 2) {
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

/* Parses the stream as jdmarker.c read_markers does; with `decode` set
 * it also decodes every scan. Without it, stops at the first SOS, after
 * the checks of its scan that jpeg_start_decompress makes: the size
 * comes with every check that refuses the image before its data.
 * Restart and TEM markers between segments are ignored, and so
 * is anything that is not a marker; markers libjpeg does not know are
 * refused. An image of one scan that holds every component ends with
 * that scan: OpenCV's reader has its pixels before jpeg_finish_decompress
 * reads on, and ignores what that call finds. */
static void walk(Jpeg *j, int decode)
{
    char msg[96];
    if (j->n < 2 || j->data[0] != 0xFF || j->data[1] != 0xD8)
        fail(&j->f, "no SOI marker");
    j->pos = 2;
    memset(j->dc_l, 0, sizeof j->dc_l);
    memset(j->dc_u, 1, sizeof j->dc_u);
    memset(j->ac_k, 5, sizeof j->ac_k);
    j->fixed_bin = 113;
    for (;;) {
        int m = take_marker(j);
        long len;
        const uint8_t *p;
        if (m == 0xD9) break;
        if (m == 0xD8) fail(&j->f, "a second SOI marker");
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
        if (m < 0xC0 || m == 0xDE || m == 0xDF || (m >= 0xF0 && m <= 0xFD)) {
            snprintf(msg, sizeof msg, "unknown marker 0x%02X", m);
            fail(&j->f, msg);
        }
        p = segment(j, &len, m >= 0xE0 || m == 0xDC);
        switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
            parse_sof(j, p, len, m - 0xC0);
            break;
        case 0xC5: case 0xC6: case 0xC7: case 0xC8: case 0xCB: case 0xCD:
        case 0xCE: case 0xCF: {
            /* libjpeg-turbo reads none of these: cv2 returns no image. */
            static const char *names[16] = {
                0, 0, 0, 0, 0, "differential sequential (SOF5)",
                "differential progressive (SOF6)",
                "differential lossless (SOF7)", "JPG-extension (0xC8)", 0, 0,
                "arithmetic-coded lossless (SOF11)", 0,
                "arithmetic-coded differential sequential (SOF13)",
                "arithmetic-coded differential progressive (SOF14)",
                "arithmetic-coded differential lossless (SOF15)"};
            snprintf(msg, sizeof msg, "%s JPEGs are not read (as "
                     "libjpeg-turbo reads none)", names[m - 0xC0]);
            fail(&j->f, msg);
            break;
        }
        case 0xCC: {
            /* DAC: conditioning of arithmetic coding (jdmarker.c). */
            long k;
            for (k = 0; k + 1 < len; k += 2) {
                int index = p[k], val = p[k + 1];
                if (index >= 32) fail(&j->f, "bad DAC table index");
                if (index >= 16) {
                    j->ac_k[index - 16] = (uint8_t)val;
                } else {
                    j->dc_l[index] = (uint8_t)(val & 15);
                    j->dc_u[index] = (uint8_t)(val >> 4);
                    if (j->dc_l[index] > j->dc_u[index])
                        fail(&j->f, "bad DAC value");
                }
            }
            if ((len) % 2) fail(&j->f, "bad DAC length");
            break;
        }
        case 0xC4:
            parse_dht(j, p, len);
            break;
        case 0xDB:
            parse_dqt(j, p, len);
            break;
        case 0xDD:
            if (len != 2) fail(&j->f, "bad DRI");
            j->restart = u16be(p);
            break;
        case 0xE0:
            /* What the first SOS finds decides the colour space. */
            if (!j->scans && len >= 14 && !memcmp(p, "JFIF\0", 5))
                j->jfif = 1;
            break;
        case 0xEE:
            if (!j->scans && len >= 12 && !memcmp(p, "Adobe", 5)) {
                j->adobe = 1;
                j->adobe_transform = p[11];
            }
            break;
        case 0xDA:
            if (!j->ncomp) fail(&j->f, "SOS before SOF");
            decode_scan(j, p, len, decode);
            if (!decode) return;
            if (!j->scans++ && !j->progressive && p[0] == j->ncomp) return;
            break;
        default:
            break;
        }
    }
    if (!j->ncomp) fail(&j->f, "no image data");
    if (!j->scans) fail(&j->f, "no image data");
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
    free(j->filled);
    free(j->reset);
}

/* Height and width of the JPEG in data[0:n], its header walked up to the
 * first SOS (with eof_fill, a header the data cuts filled as decode_jpeg
 * fills it); 0, or 1 with a message. */
int jpeg_size(const uint8_t *data, long n, int eof_fill, int *height,
              int *width, char *err, int err_len)
{
    Jpeg *j = (Jpeg *)calloc(1, sizeof(Jpeg));
    volatile int rc = 0;
    if (!j) return 2;
    j->data = data;
    j->n = n;
    j->eof_fill = eof_fill;
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

/* Decodes the walked frame into out[height][width][channels]: `space` as
 * colour_space returns (RGB, channels 3), or 4 for the components as they
 * are, interleaved (channels = the frame's components). */
static void decode_frame(Jpeg *j, uint8_t *out, int height, int width,
                         int channels, int space)
{
    size_t sums_at;
    uint8_t *rows[4];
    Ycc *ycc;
    int y, i;
    /* libjpeg-turbo converts no colours in lossless mode: cv2's
     * IMREAD_COLOR gets RGB and CMYK frames only. */
    if (j->lossless && space != 1 && space != 2 && space != 4)
        fail(&j->f, j->ncomp == 1
             ? "gray lossless JPEGs are not read (libjpeg-turbo "
               "converts no colours in lossless mode)"
             : "lossless JPEGs in YCbCr or YCCK are not read "
               "(libjpeg-turbo converts no colours in lossless mode)");
    inverse_dct(j);
    if (j->height != height || j->width != width)
        fail(&j->f, "output buffer of the wrong size");
    if (space == 4 ? channels != j->ncomp : channels != 3 || j->ncomp == 2)
        fail(&j->f, "output buffer of the wrong depth");
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
        uint8_t *o = out + (size_t)y * j->width * channels;
        for (i = 0; i < j->ncomp; i++) {
            upsample_row(j, &j->comp[i], y, rows[i],
                         (int *)(void *)(j->scratch + sums_at));
        }
        if (space == 4) {
            int x, k;
            for (x = 0; x < j->width; x++)
                for (k = 0; k < channels; k++) o[x * channels + k] = rows[k][x];
        } else {
            colour_row(ycc, j->ncomp, space, (const uint8_t *const *)rows, o,
                       j->width);
        }
    }
}

/* Decodes the JPEG in data[0:n] into rgb[height][width][3], which the
 * caller sized with jpeg_size; 0, or 1 with a message. With eof_fill a
 * stream whose data ends early is filled as cv2.imread fills it. */
int decode_jpeg(const uint8_t *data, long n, uint8_t *rgb, int height,
                int width, int eof_fill, char *err, int err_len)
{
    Jpeg *j = (Jpeg *)calloc(1, sizeof(Jpeg));
    volatile int rc = 0;
    if (!j) return 2;
    j->data = data;
    j->n = n;
    j->f.err = err;
    j->f.err_len = err_len;
    j->eof_fill = eof_fill;
    if (setjmp(j->f.jump) == 0) {
        walk(j, 1);
        decode_frame(j, rgb, height, width, 3, colour_space(j));
    } else {
        rc = 1;
    }
    release(j);
    free(j);
    return rc;
}

/* A JPEG stream of a TIFF strip or tile (its JPEGTables in front, as
 * libtiff hands both to libjpeg) as libtiff's JPEG codec decodes it: the
 * colour space comes from the TIFF, not from the stream's markers. With
 * `ycc_to_rgb` the three components go through jdcolor.c's YCbCr -> RGB
 * (JPEGCOLORMODE_RGB, which libtiff's RGBA reader sets for photometric
 * YCbCr); otherwise every component comes out as it is (JCS_UNKNOWN),
 * into out[height][width][channels] with channels the frame's
 * components. Data that ends early is filled as libjpeg fills it under
 * libtiff's source manager (a fake EOI at each read past the end).
 * 0, or 1 with a message. */
int decode_jpeg_tiff(const uint8_t *data, long n, uint8_t *out, int height,
                     int width, int channels, int ycc_to_rgb, char *err,
                     int err_len)
{
    Jpeg *j = (Jpeg *)calloc(1, sizeof(Jpeg));
    volatile int rc = 0;
    if (!j) return 2;
    j->data = data;
    j->n = n;
    j->f.err = err;
    j->f.err_len = err_len;
    j->eof_fill = 1;
    if (setjmp(j->f.jump) == 0) {
        walk(j, 1);
        if (ycc_to_rgb && j->ncomp != 3)
            fail(&j->f, "YCbCr data that is not of 3 components");
        decode_frame(j, out, height, width, channels, ycc_to_rgb ? 0 : 4);
    } else {
        rc = 1;
    }
    release(j);
    free(j);
    return rc;
}

/* ------------------------------------------------------------------ */
/* JPEG encoding as cv2.imencode(".jpg") writes it (libjpeg-turbo 3 at
 * OpenCV 5's defaults): baseline, 4:2:0, the standard Huffman tables,
 * no restart markers, JFIF 1.01 with a 1:1 density of unit 0.           */

/* The Huffman tables of jstdhuff.c: 16 code counts, then the values. */
static const uint8_t dc_luma[28] = {
    0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7,
    8, 9, 10, 11
};
static const uint8_t ac_luma[178] = {
    0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125, 1, 2, 3, 0, 4, 17, 5,
    18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50, 129, 145, 161, 8, 35,
    66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114, 130, 9, 10, 22, 23, 24,
    25, 26, 37, 38, 39, 40, 41, 42, 52, 53, 54, 55, 56, 57, 58, 67, 68, 69,
    70, 71, 72, 73, 74, 83, 84, 85, 86, 87, 88, 89, 90, 99, 100, 101, 102,
    103, 104, 105, 106, 115, 116, 117, 118, 119, 120, 121, 122, 131, 132,
    133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151, 152, 153,
    154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181,
    182, 183, 184, 185, 186, 194, 195, 196, 197, 198, 199, 200, 201, 202,
    210, 211, 212, 213, 214, 215, 216, 217, 218, 225, 226, 227, 228, 229,
    230, 231, 232, 233, 234, 241, 242, 243, 244, 245, 246, 247, 248, 249,
    250
};
static const uint8_t dc_chroma[28] = {
    0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7,
    8, 9, 10, 11
};
static const uint8_t ac_chroma[178] = {
    0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119, 0, 1, 2, 3, 17, 4, 5,
    33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50, 129, 8, 20, 66, 145, 161,
    177, 193, 9, 35, 51, 82, 240, 21, 98, 114, 209, 10, 22, 36, 52, 225, 37,
    241, 23, 24, 25, 26, 38, 39, 40, 41, 42, 53, 54, 55, 56, 57, 58, 67, 68,
    69, 70, 71, 72, 73, 74, 83, 84, 85, 86, 87, 88, 89, 90, 99, 100, 101,
    102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120, 121, 122, 130,
    131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151,
    152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179,
    180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197, 198, 199, 200,
    201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 226, 227, 228,
    229, 230, 231, 232, 233, 234, 242, 243, 244, 245, 246, 247, 248, 249,
    250
};

/* Table K.1 and K.2 (jcparam.c std_luminance_quant_tbl and
 * std_chrominance_quant_tbl), row-major. */
static const uint8_t std_quant[2][64] = {
    {16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

typedef struct {
    uint16_t code[256];
    uint8_t size[256];
} Code;

typedef struct {
    uint8_t *out;
    long cap, n;
    uint64_t acc; /* pending bits, right-aligned */
    int nacc;
    int full;     /* the output ran past cap */
} Writer;

static void put_byte(Writer *w, int b)
{
    if (w->n < w->cap) w->out[w->n] = (uint8_t)b;
    else w->full = 1;
    w->n++;
}

static void put_bytes(Writer *w, const uint8_t *p, long len)
{
    long i;
    for (i = 0; i < len; i++) put_byte(w, p[i]);
}

/* Bits MSB first, with a 0x00 stuffed after every 0xFF (jchuff.c). */
static void put_bits(Writer *w, uint32_t bits, int n)
{
    w->acc = (w->acc << n) | (bits & ((1u << n) - 1));
    w->nacc += n;
    while (w->nacc >= 8) {
        int b = (int)(w->acc >> (w->nacc - 8)) & 0xFF;
        put_byte(w, b);
        if (b == 0xFF) put_byte(w, 0);
        w->nacc -= 8;
    }
}

/* jchuff.c jpeg_make_c_derived_tbl: canonical codes from the counts. */
static void make_code(const uint8_t *spec, Code *c)
{
    int l, i, k = 0, code = 0;
    memset(c, 0, sizeof *c);
    for (l = 1; l <= 16; l++) {
        for (i = 0; i < spec[l - 1]; i++, k++) {
            c->code[spec[16 + k]] = (uint16_t)code++;
            c->size[spec[16 + k]] = (uint8_t)l;
        }
        code <<= 1;
    }
}

/* jcparam.c jpeg_quality_scaling and jpeg_add_quant_table with
 * force_baseline. */
static void quant_table(int which, int quality, int32_t *q)
{
    int i, scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (i = 0; i < 64; i++) {
        long v = ((long)std_quant[which][i] * scale + 50) / 100;
        q[i] = (int32_t)(v < 1 ? 1 : v > 255 ? 255 : v);
    }
}

/* jcdctmgr.c compute_reciprocal for the divisor q << 3 of the ISLOW
 * DCT, and its quantize(): |x| + c times the reciprocal, shifted. Both
 * libjpeg-turbo's C and SIMD quantisers compute exactly this. */
typedef struct { uint32_t recip, corr; int shift; } Divisor;

static Divisor divisor(int d)
{
    Divisor r;
    int b = 0;
    uint32_t fq, fr;
    while ((1 << (b + 1)) <= d) b++;   /* flss(d) - 1 */
    r.shift = 16 + b;
    fq = (uint32_t)((1ULL << r.shift) / (uint32_t)d);
    fr = (uint32_t)((1ULL << r.shift) % (uint32_t)d);
    r.corr = (uint32_t)d / 2;
    if (fr == 0) {
        fq >>= 1;
        r.shift--;
    } else if (fr <= (uint32_t)d / 2) {
        r.corr++;
    } else {
        fq++;
    }
    r.recip = fq & 0xFFFF;
    return r;
}

static int quantize(int x, Divisor d)
{
    uint32_t a = (uint32_t)(x < 0 ? -x : x);
    int v = (int)((a + d.corr) * d.recip >> d.shift);
    return x < 0 ? -v : v;
}

/* jfdctint.c jpeg_fdct_islow: rows scaled up by PASS1_BITS = 2, then
 * columns, leaving the result scaled up by 8. */
static void fdct_1d(int32_t *d, int stride, int pass)
{
    int64_t t0, t1, t2, t3, t4, t5, t6, t7, t10, t11, t12, t13;
    int64_t z1, z2, z3, z4, z5;
    int sh = pass == 0 ? 13 - 2 : 13 + 2;
    t0 = d[0] + d[7 * stride];
    t7 = d[0] - d[7 * stride];
    t1 = d[stride] + d[6 * stride];
    t6 = d[stride] - d[6 * stride];
    t2 = d[2 * stride] + d[5 * stride];
    t5 = d[2 * stride] - d[5 * stride];
    t3 = d[3 * stride] + d[4 * stride];
    t4 = d[3 * stride] - d[4 * stride];
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    if (pass == 0) {
        d[0] = (int32_t)((t10 + t11) * 4);
        d[4 * stride] = (int32_t)((t10 - t11) * 4);
    } else {
        d[0] = (int32_t)((t10 + t11 + 2) >> 2);
        d[4 * stride] = (int32_t)((t10 - t11 + 2) >> 2);
    }
    z1 = (t12 + t13) * FIX_0_541196100;
    d[2 * stride] = (int32_t)((z1 + t13 * FIX_0_765366865
                               + (1LL << (sh - 1))) >> sh);
    d[6 * stride] = (int32_t)((z1 - t12 * FIX_1_847759065
                               + (1LL << (sh - 1))) >> sh);
    z1 = t4 + t7;
    z2 = t5 + t6;
    z3 = t4 + t6;
    z4 = t5 + t7;
    z5 = (z3 + z4) * FIX_1_175875602;
    t4 *= FIX_0_298631336;
    t5 *= FIX_2_053119869;
    t6 *= FIX_3_072711026;
    t7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    d[7 * stride] = (int32_t)((t4 + z1 + z3 + (1LL << (sh - 1))) >> sh);
    d[5 * stride] = (int32_t)((t5 + z2 + z4 + (1LL << (sh - 1))) >> sh);
    d[3 * stride] = (int32_t)((t6 + z2 + z3 + (1LL << (sh - 1))) >> sh);
    d[stride] = (int32_t)((t7 + z1 + z4 + (1LL << (sh - 1))) >> sh);
}

/* One block of a plane (samples minus 128) through the DCT and the
 * quantiser, into out[64] row-major. */
static void forward_block(const uint8_t *p, long stride, const Divisor *dv,
                          int *out)
{
    int32_t d[64];
    int x, y;
    for (y = 0; y < 8; y++)
        for (x = 0; x < 8; x++) d[y * 8 + x] = p[y * stride + x] - 128;
    for (y = 0; y < 8; y++) fdct_1d(d + y * 8, 1, 0);
    for (x = 0; x < 8; x++) fdct_1d(d + x, 8, 1);
    for (x = 0; x < 64; x++) out[x] = quantize(d[x], dv[x]);
}

/* jchuff.c encode_one_block. */
static void encode_block(Writer *w, const int *blk, int *last_dc,
                         const Code *dc, const Code *ac)
{
    int t = blk[0] - *last_dc, t2 = t, nbits = 0, k, r = 0;
    *last_dc = blk[0];
    if (t < 0) { t = -t; t2--; }
    while (t) { nbits++; t >>= 1; }
    put_bits(w, dc->code[nbits], dc->size[nbits]);
    if (nbits) put_bits(w, (uint32_t)t2, nbits);
    for (k = 1; k < 64; k++) {
        t = blk[zigzag[k]];
        if (!t) { r++; continue; }
        while (r > 15) {
            put_bits(w, ac->code[0xF0], ac->size[0xF0]);
            r -= 16;
        }
        t2 = t;
        if (t < 0) { t = -t; t2--; }
        nbits = 0;
        while (t) { nbits++; t >>= 1; }
        put_bits(w, ac->code[(r << 4) + nbits], ac->size[(r << 4) + nbits]);
        put_bits(w, (uint32_t)t2, nbits);
        r = 0;
    }
    if (r > 0) put_bits(w, ac->code[0], ac->size[0]);
}

static void put_marker(Writer *w, int m, const uint8_t *p, int len)
{
    put_byte(w, 0xFF);
    put_byte(w, m);
    put_byte(w, (len + 2) >> 8);
    put_byte(w, (len + 2) & 0xFF);
    put_bytes(w, p, len);
}

/* jccolor.c rgb_ycc_convert of one pixel (its table arithmetic). */
static void rgb_to_ycc(const uint8_t *px, uint8_t *y, uint8_t *cb,
                       uint8_t *cr)
{
    int32_t r = px[0], g = px[1], b = px[2];
    *y = (uint8_t)((FIX(0.29900) * r + FIX(0.58700) * g + FIX(0.11400) * b
                    + ONE_HALF) >> SCALEBITS);
    *cb = (uint8_t)((-FIX(0.16874) * r - FIX(0.33126) * g
                     + FIX(0.50000) * b + (128 << SCALEBITS) + ONE_HALF - 1)
                    >> SCALEBITS);
    *cr = (uint8_t)((FIX(0.50000) * r - FIX(0.41869) * g
                     - FIX(0.08131) * b + (128 << SCALEBITS) + ONE_HALF - 1)
                    >> SCALEBITS);
}

/* Encodes rgb[height][width][3] at `quality` (1..100) into out[0:cap];
 * *size gets the stream's length. 0, 1 if cap was too small (*size is
 * then what it needs), 2 out of memory, 3 a bad argument. */
int encode_jpeg(const uint8_t *rgb, int height, int width, int quality,
                uint8_t *out, long cap, long *size)
{
    static const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0,
                                     0, 1, 0, 1, 0, 0};
    const uint8_t *specs[4] = {dc_luma, ac_luma, dc_chroma, ac_chroma};
    Writer w;
    Code codes[4];
    Divisor dv[2][64];
    int32_t q[2][64];
    uint8_t seg[200], *yp, *cp[2], *full[2];
    int mx = (width + 15) / 16, my = (height + 15) / 16;
    int ywb = (width + 7) / 8, yhb = (height + 7) / 8;
    long ys = (long)mx * 16, cs = (long)mx * 8, fs = (long)mx * 16;
    int i, k, x, y, c, last_dc[3] = {0, 0, 0};
    if (height < 1 || width < 1 || height > 65500 || width > 65500
        || quality < 1 || quality > 100)
        return 3;
    /* Planes: Y at full size, Cb and Cr at full size padded to a whole
     * row pair and to the chroma blocks' width (2 * cs), then downsampled
     * to cs x my * 8; edges replicated as jcprepct.c and jcsample.c do. */
    yp = (uint8_t *)malloc((size_t)ys * my * 16);
    full[0] = (uint8_t *)malloc((size_t)fs * 2);
    full[1] = (uint8_t *)malloc((size_t)fs * 2);
    cp[0] = (uint8_t *)malloc((size_t)cs * my * 8);
    cp[1] = (uint8_t *)malloc((size_t)cs * my * 8);
    if (!yp || !full[0] || !full[1] || !cp[0] || !cp[1]) {
        free(yp); free(full[0]); free(full[1]); free(cp[0]); free(cp[1]);
        return 2;
    }
    for (y = 0; y < (height + 1) / 2; y++) {
        int r, bias;
        for (r = 0; r < 2; r++) {
            int sy = 2 * y + r < height ? 2 * y + r : height - 1;
            uint8_t *yr = yp + (2 * y + r) * ys;
            for (x = 0; x < width; x++) {
                rgb_to_ycc(rgb + ((size_t)sy * width + x) * 3, yr + x,
                           full[0] + r * fs + x, full[1] + r * fs + x);
            }
            for (; x < ys; x++) yr[x] = yr[width - 1];
            for (c = 0; c < 2; c++)
                for (x = width; x < 2 * cs; x++)
                    full[c][r * fs + x] = full[c][r * fs + width - 1];
        }
        for (c = 0; c < 2; c++) {
            const uint8_t *a = full[c], *b = full[c] + fs;
            uint8_t *o = cp[c] + (size_t)y * cs;
            for (x = 0, bias = 1; x < cs; x++, bias ^= 3)
                o[x] = (uint8_t)((a[2 * x] + a[2 * x + 1] + b[2 * x]
                                  + b[2 * x + 1] + bias) >> 2);
        }
    }
    for (y = 2 * ((height + 1) / 2); y < my * 16; y++)
        memcpy(yp + y * ys, yp + (long)(height - 1) * ys, (size_t)ys);
    for (c = 0; c < 2; c++)
        for (y = (height + 1) / 2; y < my * 8; y++)
            memcpy(cp[c] + y * cs, cp[c] + (long)((height + 1) / 2 - 1) * cs,
                   (size_t)cs);

    memset(&w, 0, sizeof w);
    w.out = out;
    w.cap = cap;
    for (i = 0; i < 4; i++) make_code(specs[i], &codes[i]);
    for (i = 0; i < 2; i++) {
        quant_table(i, quality, q[i]);
        for (k = 0; k < 64; k++) dv[i][k] = divisor(q[i][k] << 3);
    }
    put_byte(&w, 0xFF);
    put_byte(&w, 0xD8);
    put_marker(&w, 0xE0, jfif, 14);
    for (i = 0; i < 2; i++) {
        seg[0] = (uint8_t)i;
        for (k = 0; k < 64; k++) seg[1 + k] = (uint8_t)q[i][zigzag[k]];
        put_marker(&w, 0xDB, seg, 65);
    }
    {
        const uint8_t sof[15] = {8, (uint8_t)(height >> 8),
                                 (uint8_t)height, (uint8_t)(width >> 8),
                                 (uint8_t)width, 3, 1, 0x22, 0, 2, 0x11, 1,
                                 3, 0x11, 1};
        put_marker(&w, 0xC0, sof, 15);
    }
    for (i = 0; i < 4; i++) {
        int n = 0;
        for (k = 0; k < 16; k++) n += specs[i][k];
        seg[0] = (uint8_t)((i & 1) << 4 | i >> 1);
        memcpy(seg + 1, specs[i], (size_t)(16 + n));
        put_marker(&w, 0xC4, seg, 17 + n);
    }
    {
        const uint8_t sos[12] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
        put_marker(&w, 0xDA, sos, 10);
    }
    for (y = 0; y < my; y++) {
        for (x = 0; x < mx; x++) {
            int blk[6][64], b = 0, by, bx;
            /* Y: blocks past the image's blocks are jccoefct.c's dummy
             * blocks, zero but for the DC of the block before them. */
            for (by = 0; by < 2; by++) {
                for (bx = 0; bx < 2; bx++, b++) {
                    int row = 2 * y + by, col = 2 * x + bx;
                    if (row < yhb && col < ywb) {
                        forward_block(yp + (long)row * 8 * ys + col * 8, ys,
                                      dv[0], blk[b]);
                    } else {
                        memset(blk[b], 0, sizeof blk[b]);
                        blk[b][0] = blk[row < yhb ? b - 1 : 2 * by - 1][0];
                    }
                }
            }
            for (c = 0; c < 2; c++)
                forward_block(cp[c] + (long)y * 8 * cs + x * 8, cs, dv[1],
                              blk[4 + c]);
            for (b = 0; b < 4; b++)
                encode_block(&w, blk[b], &last_dc[0], &codes[0], &codes[1]);
            encode_block(&w, blk[4], &last_dc[1], &codes[2], &codes[3]);
            encode_block(&w, blk[5], &last_dc[2], &codes[2], &codes[3]);
        }
    }
    /* Pad the last byte with ones (jchuff.c flush_bits). */
    if (w.nacc) put_bits(&w, 0x7F, 8 - w.nacc);
    put_byte(&w, 0xFF);
    put_byte(&w, 0xD9);
    free(yp); free(full[0]); free(full[1]); free(cp[0]); free(cp[1]);
    *size = w.n;
    return w.full ? 1 : 0;
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

/* ------------------------------------------------------------------ */
/* The byte coders of the simple formats (utils/tiff.py, gif.py, bmp.py */
/* hold their plain versions and the parsing around them).             */

/* libtiff's LZWDecode of one strip or tile into out[0..want): codes MSB
 * first from 9 bits, the width growing one code early (at 511, 1023,
 * 2047); a stream starting with 00 and an odd byte is old-style LZW
 * (LZWDecodeCompat: codes LSB first, the width growing at 512, 1024,
 * 2048). A stream without its EOI code ends where its bits do. A code
 * before the first clear code, or past the table, or after the table is
 * full, is an error at which libtiff stops (and zero-fills the rest).
 * Returns the bytes produced: fewer than `want` where the codes ended or
 * failed first. */
long tiff_lzw(const uint8_t *src, long n, uint8_t *out, long want)
{
    static uint16_t prefix[4096];
    static uint8_t suffix[4096], first[4096];
    static uint16_t length[4096];
    int old = n >= 2 && src[0] == 0 && (src[1] & 1);
    int nbits = 9, free_ent = 258, prev = -1, cleared = 0;
    long pos = 0, produced = 0, consumed = 0, total = n * 8;
    uint64_t acc = 0;
    int have = 0;
    for (int i = 0; i < 256; i++) {
        prefix[i] = 0;
        suffix[i] = first[i] = (uint8_t)i;
        length[i] = 1;
    }
    while (produced < want) {
        int code;
        if (total - consumed < nbits)
            break;
        while (have < nbits) {
            if (old)
                acc |= (uint64_t)src[pos++] << have;
            else
                acc = (acc << 8) | src[pos++];
            have += 8;
        }
        if (old) {
            code = (int)(acc & ((1u << nbits) - 1));
            acc >>= nbits;
        } else {
            code = (int)((acc >> (have - nbits)) & ((1u << nbits) - 1));
            acc &= ((uint64_t)1 << (have - nbits)) - 1;
        }
        have -= nbits;
        consumed += nbits;
        if (code == 257)
            break;
        if (code == 256) {
            free_ent = 258;
            nbits = 9;
            prev = -1;
            cleared = 1;
            continue;
        }
        int entry = code;
        if (!cleared)
            break;
        if (prev < 0) {
            if (code > 256)
                break;
        } else {
            if (code > free_ent || free_ent >= 4096)
                break;
            int base = code == free_ent ? prev : code;
            prefix[free_ent] = (uint16_t)prev;
            suffix[free_ent] = first[base];
            first[free_ent] = first[prev];
            length[free_ent] = (uint16_t)(length[prev] + 1);
            free_ent++;
        }
        /* write the entry's bytes backwards, clipped to want */
        long len = length[entry];
        for (long i = len - 1, c = entry; i >= 0; i--) {
            if (produced + i < want)
                out[produced + i] = suffix[c];
            c = prefix[c];
        }
        produced = produced + len < want ? produced + len : want;
        prev = code;
        if (free_ent > (1 << nbits) - (old ? 1 : 2) && nbits < 12)
            nbits++;
    }
    return produced;
}

/* libtiff's PackBitsDecode into out[0..want); returns the bytes
 * produced. */
long packbits(const uint8_t *src, long n, uint8_t *out, long want)
{
    long i = 0, o = 0;
    while (i < n && o < want) {
        int c = src[i++];
        if (c >= 128)
            c -= 256;
        if (c < 0) {
            if (c == -128)
                continue;
            long run = -c + 1;
            if (run > want - o)
                run = want - o;
            if (i >= n)
                break;
            memset(out + o, src[i++], (size_t)run);
            o += run;
        } else {
            long run = c + 1;
            if (run > want - o)
                run = want - o;
            if (n - i < run)
                break;
            memcpy(out + o, src + i, (size_t)run);
            o += run;
            i += run;
        }
    }
    return o;
}

/* GIF's LZW into out[0..count) as OpenCV 5's GifDecoder::lzwDecode runs
 * it: codes LSB first from min_size + 1 bits, the width growing when the
 * table reaches 1 << width, up to 12 bits, the table frozen at 4096
 * entries; the end-of-information code starts a new table as a clear code
 * does, and decoding goes on to the end of the data (or to that code in
 * the data's last byte, where it stops). A frame is read
 * only if the codes give exactly `count` indices: a pixel code that comes
 * once the frame is full is taken (and the decoding stops) only where it
 * is in the last byte of the data. Returns count, or GIF_PAST_TABLE (a
 * code past the table), GIF_STRING_PAST_FRAME (a string longer than the
 * pixels left: cv2's "Too long LZW length"), GIF_DATA_PAST_FRAME or
 * GIF_SHORT (the data ends before the last pixel). */
#define GIF_PAST_TABLE -1
#define GIF_STRING_PAST_FRAME -2
#define GIF_DATA_PAST_FRAME -3
#define GIF_SHORT -4
long gif_lzw(const uint8_t *src, long n, int min_size, uint8_t *out,
             long count)
{
    static uint16_t prefix[4097], length[4097];
    static uint8_t suffix[4097], first[4097];
    int clear = 1 << min_size, eoi = clear + 1;
    int width = min_size + 1, size = eoi, prev = -1;
    long pos = 0, produced = 0;
    uint32_t acc = 0;
    int bits = 0;
    if (min_size < 2 || min_size > 11)
        return GIF_PAST_TABLE;
    for (int i = 0; i < clear; i++) {
        prefix[i] = 0;
        suffix[i] = first[i] = (uint8_t)i;
        length[i] = 1;
    }
    for (;;) {
        while (bits < width && pos < n) {
            acc |= (uint32_t)src[pos++] << bits;
            bits += 8;
        }
        if (bits < width)
            return produced == count ? count : GIF_SHORT;
        int code = (int)(acc & ((1u << width) - 1));
        acc >>= width;
        bits -= width;
        if (code == clear || code == eoi) {
            size = eoi;
            width = min_size + 1;
            prev = -1;
            /* At the end-of-information code with the data all read, cv2
             * reads the terminator and stops, leaving the bits after it. */
            if (code == eoi && pos == n)
                return produced == count ? count : GIF_SHORT;
            continue;
        }
        if (produced >= count)
            return produced == count && pos == n ? count
                                                 : GIF_DATA_PAST_FRAME;
        if (size < 4096) {
            if (code >= clear && code > size)
                return GIF_PAST_TABLE;
            if (prev >= 0) {
                /* the entry the last code began, ended by this one's first
                 * index */
                int base = code == size ? prev : code;
                prefix[size] = (uint16_t)prev;
                suffix[size] = first[base];
                first[size] = first[prev];
                length[size] = (uint16_t)(length[prev] + 1);
            }
            size = prev >= 0 ? size + 1 : eoi + 1;
        }
        long len = length[code];
        if (produced + len > count)
            return GIF_STRING_PAST_FRAME;
        for (long i = len - 1, c = code; i >= 0; i--) {
            out[produced + i] = suffix[c];
            c = prefix[c];
        }
        produced += len;
        prev = code;
        if (size == (1 << width) && width < 12)
            width++;
    }
}

/* An RLE4 or RLE8 BMP stream from data[offset] into rgb [height, width, 3]
 * rows in file order, as OpenCV 5.0's BmpDecoder::readData runs it:
 * encoded runs (RLE4: two alternating palette colours), absolute runs
 * (word aligned), and the escapes end of line, end of bitmap and delta,
 * whose skipped pixels take palette entry 0 (cv2's FillUniColor, wrapping
 * from row to row). In RLE8 the end of bitmap fills every row left and a
 * delta skips dx + dy rows; in RLE4 both stay in the row (dx, or the
 * row's rest). Returns 0, or 1 with a message when cv2 gives no image
 * (a run past the row's end, data that ends early). */
int bmp_rle(const uint8_t *data, long n, long offset, int bits,
            const uint8_t *palette, int height, int width, uint8_t *rgb,
            char *err, int err_len)
{
    long total = (long)height * width, pos = 0, line_end = width;
    long at = offset;
    int y = 0, line_end_flag = 0;
#define RLE_FAIL(msg)                                                     \
    do {                                                                  \
        snprintf(err, (size_t)err_len, "BMP RLE%d: %s", bits, msg);       \
        return 1;                                                         \
    } while (0)
#define RLE_BYTE(v)                                                       \
    do {                                                                  \
        if (at >= n)                                                      \
            RLE_FAIL("data ends early");                                  \
        (v) = data[at++];                                                 \
    } while (0)
    memset(rgb, 0, (size_t)total * 3);
    if (offset < 0)
        RLE_FAIL("data ends early");
    for (;;) {
        int len, code;
        RLE_BYTE(len);
        RLE_BYTE(code);
        if (len) {
            if (pos + len > line_end)
                RLE_FAIL("run past the end of a row");
            if (bits == 4) {
                const uint8_t *c[2] = {palette + 3 * (code >> 4),
                                       palette + 3 * (code & 15)};
                for (int t = 0; t < len; t++)
                    memcpy(rgb + 3 * (pos + t), c[t & 1], 3);
                pos += len;
                continue;
            }
        } else if (code > 2) {
            if (pos + code > line_end)
                RLE_FAIL("run past the end of a row");
            long words = bits == 4 ? ((((code + 1) >> 1) + 1) & ~1)
                                   : ((code + 1) & ~1);
            if (at + words > n)
                RLE_FAIL("data ends early");
            for (int t = 0; t < code; t++) {
                int idx = bits == 4
                    ? (t & 1 ? data[at + t / 2] & 15 : data[at + t / 2] >> 4)
                    : data[at + t];
                memcpy(rgb + 3 * (pos + t), palette + 3 * idx, 3);
            }
            at += words;
            pos += code;
            line_end_flag = 0;
            continue;
        }
        /* An encoded RLE8 run, or an escape: fill `count` pixels of one
         * colour from pos, wrapping to the next row at its end. */
        long count;
        const uint8_t *colour;
        if (len) {
            count = len;
            colour = palette + 3 * code;
        } else {
            long x_shift = line_end - pos, y_shift = height - y;
            if (bits == 8 && !(code || !line_end_flag || x_shift < width)) {
                line_end_flag = 0;
                continue;
            }
            if (code == 2) {
                int dx, dy;
                RLE_BYTE(dx);
                RLE_BYTE(dy);
                x_shift = dx;
                y_shift = dy;
            }
            count = x_shift + (code && bits == 8 ? y_shift * width : 0);
            colour = palette;
            if (bits == 8 && y >= height)
                break;
        }
        int prev_y = y;
        for (;;) {
            long end = pos + count < line_end ? pos + count : line_end;
            count -= end - pos;
            for (; pos < end; pos++)
                memcpy(rgb + 3 * pos, colour, 3);
            if (pos >= line_end) {
                line_end += width;
                pos = line_end - width;
                if (++y >= height)
                    break;
            }
            if (count <= 0)
                break;
        }
        line_end_flag = len ? y - prev_y : 0;
        if (y >= height)
            break;
    }
    return 0;
#undef RLE_BYTE
#undef RLE_FAIL
}

/* ------------------------------------------------------------------ */
/* The writers of cv2.imencode for a 3-channel image: .bmp, .ppm/.pam/ */
/* .pfm, .sr and .tif (plain versions in utils/bmp.py, pxm.py,         */
/* sunras.py, tiff.py). Each returns 0, or 1 with *size the bytes      */
/* needed when cap is too small.                                       */

static void put_le(uint8_t *p, uint32_t v, int n)
{
    for (int i = 0; i < n; i++)
        p[i] = (uint8_t)(v >> (8 * i));
}

static void put_be(uint8_t *p, uint32_t v, int n)
{
    for (int i = 0; i < n; i++)
        p[i] = (uint8_t)(v >> (8 * (n - 1 - i)));
}

int encode_bmp(const uint8_t *rgb, int height, int width, uint8_t *out,
               long cap, long *size)
{
    long pitch = ((long)width * 3 + 3) & ~3L;
    *size = 54 + pitch * height;
    if (*size > cap)
        return 1;
    memset(out, 0, (size_t)*size);
    out[0] = 'B';
    out[1] = 'M';
    put_le(out + 2, (uint32_t)*size, 4);
    put_le(out + 10, 54, 4);
    put_le(out + 14, 40, 4);
    put_le(out + 18, (uint32_t)width, 4);
    put_le(out + 22, (uint32_t)height, 4);
    put_le(out + 26, 1, 2);
    put_le(out + 28, 24, 2);
    for (int y = 0; y < height; y++) {
        const uint8_t *s = rgb + (long)(height - 1 - y) * width * 3;
        uint8_t *d = out + 54 + y * pitch;
        for (int x = 0; x < width; x++) {
            d[3 * x] = s[3 * x + 2];
            d[3 * x + 1] = s[3 * x + 1];
            d[3 * x + 2] = s[3 * x];
        }
    }
    return 0;
}

/* kind 0: P6 (.ppm, .pnm); 1: P7 without TUPLTYPE, B, G, R samples (.pam);
 * 2: PF with scale -1, little-endian R, G, B floats, rows bottom-up. */
int encode_pxm(int kind, const uint8_t *rgb, int height, int width,
               uint8_t *out, long cap, long *size)
{
    char head[128];
    int hl;
    long px = (long)height * width;
    if (kind == 0)
        hl = snprintf(head, sizeof head, "P6\n%d %d\n255\n", width, height);
    else if (kind == 1)
        hl = snprintf(head, sizeof head,
                      "P7\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
                      width, height);
    else
        hl = snprintf(head, sizeof head, "PF\n%d %d\n-1\n", width, height);
    *size = hl + px * 3 * (kind == 2 ? 4 : 1);
    if (*size > cap)
        return 1;
    memcpy(out, head, (size_t)hl);
    uint8_t *d = out + hl;
    if (kind == 0) {
        memcpy(d, rgb, (size_t)px * 3);
    } else if (kind == 1) {
        for (long i = 0; i < px; i++) {
            d[3 * i] = rgb[3 * i + 2];
            d[3 * i + 1] = rgb[3 * i + 1];
            d[3 * i + 2] = rgb[3 * i];
        }
    } else {
        for (int y = 0; y < height; y++) {
            const uint8_t *s = rgb + (long)(height - 1 - y) * width * 3;
            for (long i = 0; i < (long)width * 3; i++) {
                float f = (float)s[i];
                uint32_t u;
                memcpy(&u, &f, 4);
                put_le(d, u, 4);
                d += 4;
            }
        }
    }
    return 0;
}

/* Sun raster: depth 24, RT_STANDARD, no colormap, B, G, R rows padded to
 * an even length with the byte after the row (the next row's first; 0
 * after the last row). */
int encode_sunras(const uint8_t *rgb, int height, int width, uint8_t *out,
                  long cap, long *size)
{
    long row = (long)width * 3, pitch = (row + 1) & ~1L;
    *size = 32 + pitch * height;
    if (*size > cap)
        return 1;
    const uint32_t head[8] = {0x59A66A95u, (uint32_t)width, (uint32_t)height,
                              24, (uint32_t)(pitch * height), 1, 0, 0};
    for (int i = 0; i < 8; i++)
        put_be(out + 4 * i, head[i], 4);
    for (int y = 0; y < height; y++) {
        const uint8_t *s = rgb + y * row;
        uint8_t *d = out + 32 + y * pitch;
        for (int x = 0; x < width; x++) {
            d[3 * x] = s[3 * x + 2];
            d[3 * x + 1] = s[3 * x + 1];
            d[3 * x + 2] = s[3 * x];
        }
        if (pitch > row)
            d[row] = y + 1 < height ? s[row + 2] : 0;
    }
    return 0;
}

/* libtiff's LZWEncode and LZWPostEncode of one strip (see
 * utils/tiff.py lzw_encode_plain); out must hold the worst case. */
typedef struct {
    uint8_t *out;
    long len;
    uint64_t data;
    int bits, nbits;
    long outcount;
} LzwOut;

static void lzw_put(LzwOut *o, int code)
{
    o->data = ((o->data << o->nbits) | (uint64_t)code) & 0xFFFFFFFFu;
    o->bits += o->nbits;
    while (o->bits >= 8) {
        o->out[o->len++] = (uint8_t)(o->data >> (o->bits - 8));
        o->bits -= 8;
    }
    o->outcount += o->nbits;
}

static long lzw_encode_strip(const uint8_t *src, long n, uint8_t *out,
                             uint16_t *table, uint32_t *stamp, uint32_t *gen)
{
    LzwOut o = {out, 0, 0, 0, 9, 0};
    int maxcode = 511, free_ent = 258, ent = -1;
    long incount = 0, checkpoint = 10000, ratio = 0;
    (*gen)++;
    if (n > 0) {
        lzw_put(&o, 256);
        ent = src[0];
        incount = 1;
    }
    for (long i = 1; i < n; i++) {
        int c = src[i];
        long key = ((long)ent << 8) | c;
        incount++;
        if (stamp[key] == *gen) {
            ent = table[key];
            continue;
        }
        lzw_put(&o, ent);
        stamp[key] = *gen;
        table[key] = (uint16_t)free_ent++;
        ent = c;
        int reset = 0;
        if (free_ent == 4094) {
            reset = 1;
        } else if (free_ent > maxcode) {
            o.nbits++;
            maxcode = (1 << o.nbits) - 1;
        } else if (incount >= checkpoint) {
            checkpoint = incount + 10000;
            long rat = (incount << 8) / o.outcount;
            if (rat <= ratio)
                reset = 1;
            else
                ratio = rat;
        }
        if (reset) {
            (*gen)++;
            ratio = incount = 0;
            o.outcount = 0;
            free_ent = 258;
            lzw_put(&o, 256);
            o.nbits = 9;
            maxcode = 511;
        }
    }
    if (ent >= 0) {
        lzw_put(&o, ent);
        free_ent++;
        if (free_ent == 4094) {
            o.outcount = 0;
            lzw_put(&o, 256);
            o.nbits = 9;
        } else if (free_ent > maxcode) {
            o.nbits++;
        }
    }
    lzw_put(&o, 257);
    if (o.bits)
        out[o.len++] = (uint8_t)(o.data << (8 - o.bits));
    return o.len;
}

/* cv2.imencode(".tif") of a 3-channel image: LZW with the horizontal
 * predictor, RowsPerStrip max(1, min(H, 8192 / (3 W))), the strips from
 * byte 8, IFD0 at an even offset, then BitsPerSample, StripByteCounts
 * (SHORT when several strips and an uncompressed strip under 6553
 * bytes), StripOffsets and SampleFormat. Returns 0, 1 (cap too small,
 * *size a bound), 2 (out of memory). */
int encode_tiff(const uint8_t *rgb, int height, int width, uint8_t *out,
                long cap, long *size)
{
    long row = (long)width * 3;
    int rps = (int)(8192 / row);
    if (rps > height)
        rps = height;
    if (rps < 1)
        rps = 1;
    int nstrips = (height + rps - 1) / rps;
    long strip_raw = row * rps;
    /* A strip's codes take at most 12 bits a byte, plus clears. */
    long bound = 8 + (long)nstrips * (strip_raw * 2 + 16) + 1 + 2 + 12 * 12
        + 4 + 6 + 8L * nstrips + 6;
    if (bound > cap) {
        *size = bound;
        return 1;
    }
    uint8_t *diff = malloc((size_t)strip_raw);
    uint16_t *table = malloc(sizeof(uint16_t) * 4096 * 256);
    uint32_t *stamp = calloc(4096 * 256, sizeof(uint32_t));
    long *counts = malloc(sizeof(long) * (size_t)nstrips);
    long *offsets = malloc(sizeof(long) * (size_t)nstrips);
    uint32_t gen = 0;
    if (!diff || !table || !stamp || !counts || !offsets) {
        free(diff);
        free(table);
        free(stamp);
        free(counts);
        free(offsets);
        return 2;
    }
    long at = 8;
    memcpy(out, "II*\0", 4);
    for (int s = 0; s < nstrips; s++) {
        int rows = height - s * rps < rps ? height - s * rps : rps;
        const uint8_t *src = rgb + (long)s * rps * row;
        for (int y = 0; y < rows; y++) {
            const uint8_t *r = src + y * row;
            uint8_t *d = diff + y * row;
            for (long i = 0; i < row; i++)
                d[i] = (uint8_t)(i < 3 ? r[i] : r[i] - r[i - 3]);
        }
        offsets[s] = at;
        counts[s] = lzw_encode_strip(diff, rows * row, out + at, table,
                                     stamp, &gen);
        at += counts[s];
    }
    if (at & 1)
        out[at++] = 0;
    long ifd = at;
    put_le(out + 4, (uint32_t)ifd, 4);
    int short_counts = nstrips > 1 && strip_raw < 0xFFFF / 10;
    long tail = ifd + 2 + 12 * 12 + 4, t = tail;
    long bits_at = t;
    for (int i = 0; i < 3; i++, t += 2)
        put_le(out + t, 8, 2);
    long counts_at = t, offsets_at = 0;
    if (nstrips > 1) {
        for (int s = 0; s < nstrips; s++, t += short_counts ? 2 : 4)
            put_le(out + t, (uint32_t)counts[s], short_counts ? 2 : 4);
        offsets_at = t;
        for (int s = 0; s < nstrips; s++, t += 4)
            put_le(out + t, (uint32_t)offsets[s], 4);
    }
    long formats_at = t;
    for (int i = 0; i < 3; i++, t += 2)
        put_le(out + t, 1, 2);
    const uint32_t entries[12][4] = {
        {256, 3, 1, (uint32_t)width},
        {257, 3, 1, (uint32_t)height},
        {258, 3, 3, (uint32_t)bits_at},
        {259, 3, 1, 5},
        {262, 3, 1, 2},
        {273, 4, (uint32_t)nstrips,
         (uint32_t)(nstrips > 1 ? offsets_at : offsets[0])},
        {277, 3, 1, 3},
        {278, 3, 1, (uint32_t)rps},
        {279, short_counts ? 3u : 4u, (uint32_t)nstrips,
         (uint32_t)(nstrips > 1 ? counts_at : counts[0])},
        {284, 3, 1, 1},
        {317, 3, 1, 2},
        {339, 3, 3, (uint32_t)formats_at}};
    put_le(out + ifd, 12, 2);
    for (int i = 0; i < 12; i++) {
        uint8_t *e = out + ifd + 2 + 12 * i;
        put_le(e, entries[i][0], 2);
        put_le(e + 2, entries[i][1], 2);
        put_le(e + 4, entries[i][2], 4);
        put_le(e + 8, entries[i][3], 4);
    }
    put_le(out + ifd + 2 + 12 * 12, 0, 4);
    *size = t;
    free(diff);
    free(table);
    free(stamp);
    free(counts);
    free(offsets);
    return 0;
}

/* ------------------------------------------------------------------ */
/* CCITT fax decoding of TIFF strips (compressions 2, 3 and 4) as     */
/* libtiff 4.7's tif_fax3.c runs it; utils/ccitt.py is the plain       */
/* version and says what is reproduced.                                */

enum { S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB,
       S_MAKEUPW, S_MAKEUPB, S_MAKEUP, S_EOL };
enum { FAX_OK, FAX_EOF, FAX_FAIL, FAX_NOEOL };

typedef struct { uint8_t state, width; uint16_t param; } FaxEnt;

typedef struct {
    FaxEnt main[128], white[4096], black[8192];
} FaxTables;

/* T.4's code words, first bit first, in the order mkg3states.c fills. */
static const char *const fax_white_term[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000", "0010111",
    "0000011", "0000100", "0101000", "0101011", "0010011", "0100100",
    "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000",
    "00101001", "00101010", "00101011", "00101100", "00101101", "00000100",
    "00000101", "00001010", "00001011", "01010010", "01010011", "01010100",
    "01010101", "00100100", "00100101", "01011000", "01011001", "01011010",
    "01011011", "01001010", "01001011", "00110010", "00110011", "00110100"};
static const char *const fax_white_makeup[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100", "011001101",
    "011010010", "011010011", "011010100", "011010101", "011010110",
    "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011"};
static const char *const fax_black_term[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101",
    "000100", "0000100", "0000101", "0000111", "00000100", "00000111",
    "000011000", "0000010111", "0000011000", "0000001000", "00001100111",
    "00001101000", "00001101100", "00000110111", "00000101000", "00000010111",
    "00000011000", "000011001010", "000011001011", "000011001100",
    "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100",
    "000011010101", "000011010110", "000011010111", "000001101100",
    "000001101101", "000011011010", "000011011011", "000001010100",
    "000001010101", "000001010110", "000001010111", "000001100100",
    "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000",
    "000001011000", "000001011001", "000000101011", "000000101100",
    "000001011010", "000001100110", "000001100111"};
static const char *const fax_black_makeup[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
static const char *const fax_ext_makeup[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

/* mkg3states.c FillTable: every index whose low bits are the code read
 * first bit first. */
static void fax_fill_table(FaxEnt *t, int bits, int state, const char *code,
                           int param)
{
    int len = (int)strlen(code), rev = 0, k, i;
    for (k = 0; k < len; k++) rev |= (code[k] == '1') << k;
    for (i = rev; i < (1 << bits); i += 1 << len) {
        t[i].state = (uint8_t)state;
        t[i].width = (uint8_t)len;
        t[i].param = (uint16_t)param;
    }
}

static void fax_build(FaxTables *t)
{
    static const struct { int state; const char *code; int param; } modes[] = {
        {S_PASS, "0001", 0}, {S_HORIZ, "001", 0}, {S_V0, "1", 0},
        {S_VR, "011", 1}, {S_VR, "000011", 2}, {S_VR, "0000011", 3},
        {S_VL, "010", 1}, {S_VL, "000010", 2}, {S_VL, "0000010", 3},
        {S_EXT, "0000001", 0}, {S_EOL, "0000000", 0}};
    int i, c;
    memset(t, 0, sizeof *t);
    for (i = 0; i < (int)(sizeof modes / sizeof modes[0]); i++)
        fax_fill_table(t->main, 7, modes[i].state, modes[i].code,
                       modes[i].param);
    for (c = 0; c < 2; c++) {
        FaxEnt *tab = c ? t->black : t->white;
        int bits = c ? 13 : 12;
        const char *const *term = c ? fax_black_term : fax_white_term;
        const char *const *makeup = c ? fax_black_makeup : fax_white_makeup;
        for (i = 0; i < 27; i++)
            fax_fill_table(tab, bits, c ? S_MAKEUPB : S_MAKEUPW, makeup[i],
                           64 * (i + 1));
        for (i = 0; i < 13; i++)
            fax_fill_table(tab, bits, S_MAKEUP, fax_ext_makeup[i],
                           1792 + 64 * i);
        for (i = 0; i < 64; i++)
            fax_fill_table(tab, bits, c ? S_TERMB : S_TERMW, term[i], i);
        fax_fill_table(tab, bits, S_EOL, "00000000000", 0);
    }
}

typedef struct {
    const FaxTables *t;
    const uint8_t *data;
    long n, cp;
    uint32_t acc;
    int avail, eolcnt, msb_first;
    int lastx;
    long nruns;
    uint32_t *runs;        /* 2 * nruns, kept by the caller between strips */
    long cur, ref, pa, thisrun, pb;
    int a0, run_length, b1;
} Fax;

static uint8_t fax_byte(const Fax *f, uint8_t b)
{
    if (!f->msb_first) return b;
    b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
    return (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

/* NeedBits8 (wide = 0) and NeedBits16 (wide = 1). */
static int fax_need(Fax *f, int n, int wide)
{
    if (f->avail >= n) return FAX_OK;
    if (f->cp >= f->n) {
        if (f->avail == 0) return FAX_EOF;
        f->avail = n;
        return FAX_OK;
    }
    f->acc |= (uint32_t)fax_byte(f, f->data[f->cp++]) << f->avail;
    f->avail += 8;
    if (wide && f->avail < n) {
        if (f->cp >= f->n) {
            f->avail = n;
        } else {
            f->acc |= (uint32_t)fax_byte(f, f->data[f->cp++]) << f->avail;
            f->avail += 8;
        }
    }
    return FAX_OK;
}

#define FAX_GET(f, k) ((f)->acc & ((1u << (k)) - 1))
#define FAX_TRY(x) do { int r_ = (x); if (r_) return r_; } while (0)

static void fax_clr(Fax *f, int k)
{
    f->avail -= k;
    f->acc >>= k;
}

static int fax_lookup(Fax *f, int bits, const FaxEnt *t, int wide, FaxEnt *e)
{
    FAX_TRY(fax_need(f, bits, wide));
    *e = t[FAX_GET(f, bits)];
    fax_clr(f, e->width);
    return FAX_OK;
}

static int fax_set(Fax *f, int x)
{
    if (f->pa >= f->thisrun + f->nruns) return FAX_FAIL;
    f->runs[f->pa++] = (uint32_t)f->run_length + (uint32_t)x;
    f->a0 = (int)((uint32_t)f->a0 + (uint32_t)x);
    f->run_length = 0;
    return FAX_OK;
}

/* CLEANUP_RUNS. */
static int fax_cleanup(Fax *f)
{
    int lastx = f->lastx;
    if (f->run_length) FAX_TRY(fax_set(f, 0));
    if (f->a0 != lastx) {
        while (f->a0 > lastx && f->pa > f->thisrun)
            f->a0 = (int)((uint32_t)f->a0 - f->runs[--f->pa]);
        if (f->a0 < lastx) {
            if (f->a0 < 0) f->a0 = 0;
            if ((f->pa - f->thisrun) & 1) FAX_TRY(fax_set(f, 0));
            FAX_TRY(fax_set(f, lastx - f->a0));
        } else if (f->a0 > lastx) {
            FAX_TRY(fax_set(f, lastx));
            FAX_TRY(fax_set(f, 0));
        }
    }
    return FAX_OK;
}

/* _TIFFFax3fillruns into a row of 0/1 bytes, clamping the runs in place. */
static void fax_fill(Fax *f, uint8_t *row)
{
    long end = f->pa, i, k;
    uint32_t x = 0, lastx = (uint32_t)f->lastx;
    if ((end - f->thisrun) & 1 && end < 2 * f->nruns) f->runs[end++] = 0;
    for (i = f->thisrun; i < end; i += 2) {
        for (k = i; k < i + 2 && k < end; k++) {
            uint32_t run = f->runs[k];
            if (x + run > lastx || run > lastx) run = f->runs[k] = lastx - x;
            if (run) {
                memset(row + x, (int)(k - i), run);
                x += run;
            }
        }
    }
}

/* The loops of EXPAND1D for one colour: make-up codes then a terminating
 * one; *done at an EOL or a bad code. */
static int fax_colour(Fax *f, int black, int *done)
{
    const FaxEnt *t = black ? f->t->black : f->t->white;
    int term = black ? S_TERMB : S_TERMW;
    int makeup = black ? S_MAKEUPB : S_MAKEUPW;
    for (;;) {
        FaxEnt e;
        FAX_TRY(fax_lookup(f, black ? 13 : 12, t, 1, &e));
        if (e.state == S_EOL) {
            f->eolcnt = 1;
            *done = 1;
            return FAX_OK;
        }
        if (e.state == term) return fax_set(f, e.param);
        if (e.state == makeup || e.state == S_MAKEUP) {
            f->a0 += e.param;
            f->run_length += e.param;
            continue;
        }
        *done = 1;
        return FAX_OK;
    }
}

static int fax_expand_1d(Fax *f)
{
    int r, done = 0;
    for (;;) {
        if ((r = fax_colour(f, 0, &done)) || done || f->a0 >= f->lastx) break;
        if ((r = fax_colour(f, 1, &done)) || done || f->a0 >= f->lastx) break;
        if (f->runs[f->pa - 1] == 0 && f->runs[f->pa - 2] == 0) f->pa -= 2;
    }
    if (r == FAX_FAIL) return r;
    FAX_TRY(fax_cleanup(f));
    return r;
}

static int fax_check_b1(Fax *f)
{
    if (f->pa != f->thisrun) {
        while (f->b1 <= f->a0 && f->b1 < f->lastx) {
            if (f->pb + 1 >= f->ref + f->nruns) return FAX_FAIL;
            f->b1 = (int)((uint32_t)f->b1 + f->runs[f->pb] + f->runs[f->pb + 1]);
            f->pb += 2;
        }
    }
    return FAX_OK;
}

/* A run of one colour in horizontal mode; *bad where EXPAND2D goes to
 * badBlack2d or badWhite2d. */
static int fax_horizontal(Fax *f, int black, int *bad)
{
    const FaxEnt *t = black ? f->t->black : f->t->white;
    int term = black ? S_TERMB : S_TERMW;
    int makeup = black ? S_MAKEUPB : S_MAKEUPW;
    for (;;) {
        FaxEnt e;
        FAX_TRY(fax_lookup(f, black ? 13 : 12, t, 1, &e));
        if (e.state == term) return fax_set(f, e.param);
        if (e.state == makeup || e.state == S_MAKEUP) {
            f->a0 += e.param;
            f->run_length += e.param;
            continue;
        }
        *bad = 1;
        return FAX_OK;
    }
}

static int fax_expand_2d_body(Fax *f)
{
    int lastx = f->lastx;
    while (f->a0 < lastx) {
        FaxEnt e;
        if (f->pa >= f->thisrun + f->nruns) return FAX_FAIL;
        FAX_TRY(fax_lookup(f, 7, f->t->main, 0, &e));
        switch (e.state) {
        case S_PASS:
            FAX_TRY(fax_check_b1(f));
            if (f->pb + 1 >= f->ref + f->nruns) return FAX_FAIL;
            f->b1 = (int)((uint32_t)f->b1 + f->runs[f->pb++]);
            f->run_length = (int)((uint32_t)f->run_length + (uint32_t)f->b1
                                  - (uint32_t)f->a0);
            f->a0 = f->b1;
            f->b1 = (int)((uint32_t)f->b1 + f->runs[f->pb++]);
            break;
        case S_HORIZ: {
            int bad = 0, black = (int)((f->pa - f->thisrun) & 1);
            FAX_TRY(fax_horizontal(f, black, &bad));
            if (bad) return FAX_OK;
            FAX_TRY(fax_horizontal(f, !black, &bad));
            if (bad) return FAX_OK;
            FAX_TRY(fax_check_b1(f));
            break;
        }
        case S_V0:
        case S_VR:
            FAX_TRY(fax_check_b1(f));
            FAX_TRY(fax_set(f, f->b1 - f->a0 + e.param));
            if (f->pb >= f->ref + f->nruns) return FAX_FAIL;
            f->b1 = (int)((uint32_t)f->b1 + f->runs[f->pb++]);
            break;
        case S_VL:
            FAX_TRY(fax_check_b1(f));
            if (f->b1 < f->a0 + e.param) return FAX_OK;
            FAX_TRY(fax_set(f, f->b1 - f->a0 - e.param));
            f->b1 = (int)((uint32_t)f->b1 - f->runs[--f->pb]);
            break;
        case S_EXT:
            if (f->pa < 2 * f->nruns)
                f->runs[f->pa++] = (uint32_t)(lastx - f->a0);
            return FAX_OK;
        case S_EOL:
            if (f->pa < 2 * f->nruns)
                f->runs[f->pa++] = (uint32_t)(lastx - f->a0);
            FAX_TRY(fax_need(f, 4, 0));
            fax_clr(f, 4);
            f->eolcnt = 1;
            return FAX_OK;
        default:
            return FAX_OK;
        }
    }
    if (f->run_length) {
        if (f->run_length + f->a0 < lastx) {
            FAX_TRY(fax_need(f, 1, 0));
            if (!FAX_GET(f, 1)) return FAX_OK;
            fax_clr(f, 1);
        }
        FAX_TRY(fax_set(f, 0));
    }
    return FAX_OK;
}

static int fax_expand_2d(Fax *f)
{
    int r = fax_expand_2d_body(f);
    if (r == FAX_FAIL) return r;
    FAX_TRY(fax_cleanup(f));
    return r;
}

/* SYNC_EOL; FAX_NOEOL where it runs out of data. */
static int fax_sync_eol(Fax *f)
{
    if (f->eolcnt == 0) {
        for (;;) {
            if (fax_need(f, 11, 1)) return FAX_NOEOL;
            if (FAX_GET(f, 11) == 0) break;
            fax_clr(f, 1);
        }
    }
    for (;;) {
        if (fax_need(f, 8, 0)) return FAX_NOEOL;
        if (FAX_GET(f, 8)) break;
        fax_clr(f, 8);
    }
    while (FAX_GET(f, 1) == 0) fax_clr(f, 1);
    fax_clr(f, 1);
    f->eolcnt = 0;
    return FAX_OK;
}

/* One row of a T.4 or RLE strip; FAX_EOF and FAX_FAIL fail the strip. */
static int fax_row_t4(Fax *f, int compression, int two_d, int *noeol)
{
    int r;
    if (compression == 2) return fax_expand_1d(f);
    if (!*noeol) {
        r = fax_sync_eol(f);
        if (r == FAX_NOEOL) {
            *noeol = 1;
            f->cp = 0;
            f->acc = 0;
            f->avail = f->eolcnt = 0;
        }
    }
    if (two_d) {
        int is_1d;
        if (fax_need(f, 1, 0)) {
            FAX_TRY(fax_cleanup(f));
            return FAX_EOF;
        }
        is_1d = (int)FAX_GET(f, 1);
        fax_clr(f, 1);
        f->pb = f->ref;
        f->b1 = (int)f->runs[f->pb++];
        return is_1d ? fax_expand_1d(f) : fax_expand_2d(f);
    }
    return fax_expand_1d(f);
}

/* One strip or tile of CCITT data into out[rows][width] (0 white, 1
 * black). `runs` holds 2 * fax_runs(width, two_d) words and `*noeol` the
 * codec's no-EOL mode, both kept by the caller from one strip of an image
 * to the next. Returns 1, or 0 where libtiff's decoder returns -1 (the rows
 * decoded until then written, the rest left as they were), or 2 if out of
 * memory. */
long fax_runs(int width, int two_d)
{
    long words = ((long)width + 1 + 31) / 32 * 32;
    return two_d ? 2 * words : words;
}

int fax_decode(const uint8_t *data, long n, int width, int rows,
               int compression, int t4options, int fill_order,
               uint32_t *runs, int *noeol, uint8_t *out)
{
    FaxTables *t = (FaxTables *)malloc(sizeof(FaxTables));
    int two_d = compression == 4 || (compression == 3 && (t4options & 1));
    int line, rc = 1;
    Fax f;
    if (!t) return 2;
    fax_build(t);
    memset(&f, 0, sizeof f);
    f.t = t;
    f.data = data;
    f.n = n;
    f.msb_first = fill_order != 2;
    f.lastx = width;
    f.nruns = fax_runs(width, two_d);
    f.runs = runs;
    f.cur = 0;
    f.ref = f.nruns;
    if (two_d) {
        runs[f.ref] = (uint32_t)width;
        runs[f.ref + 1] = 0;
    }
    for (line = 0; line < rows; line++) {
        uint8_t *row = out + (size_t)line * width;
        int r;
        f.a0 = f.run_length = 0;
        f.pa = f.thisrun = f.cur;
        if (compression == 4) {
            int ended;
            f.pb = f.ref;
            f.b1 = (int)runs[f.pb++];
            r = fax_expand_2d(&f);
            if (r == FAX_FAIL) { rc = 0; break; }
            ended = r == FAX_EOF || f.eolcnt;
            if (ended) {
                (void)fax_need(&f, 13, 1);
                fax_clr(&f, 13);
                fax_fill(&f, row);
                rc = line > 0;
                break;
            }
            fax_fill(&f, row);
            if (fax_set(&f, 0)) { rc = 0; break; }
            f.cur = f.ref;
            f.ref = f.thisrun;
            continue;
        }
        r = fax_row_t4(&f, compression, two_d, noeol);
        if (r == FAX_FAIL) { rc = 0; break; }
        fax_fill(&f, row);
        if (r == FAX_EOF) { rc = 0; break; }
        if (compression == 2) {
            fax_clr(&f, f.avail & 7);
        } else if (two_d) {
            if (f.pa < f.thisrun + f.nruns && fax_set(&f, 0)) { rc = 0; break; }
            f.cur = f.ref;
            f.ref = f.thisrun;
        }
    }
    free(t);
    return rc;
}

/* ------------------------------------------------------------------ */
/* Radiance HDR pixels as OpenCV's rgbe.cpp reads and writes them;     */
/* utils/hdr.py parses the header and holds the plain versions.        */

/* rgbe2float and cv2's scaling by 255 to uint8: m * 255 * 2^(e - 136) is
 * exact in float32; rounded to even and saturated, in integers here. A
 * value of 2^31 or more converts to INT_MIN under cv2's cvRound, then
 * saturates to 0. */
static void rgbe_to_rgb8(const uint8_t *rgbe, uint8_t *rgb)
{
    int c, s = 136 - rgbe[3];
    for (c = 0; c < 3; c++) {
        uint32_t x = 255u * rgbe[c], q, rem, half;
        if (!rgbe[3] || s >= 17) {
            rgb[c] = 0; /* below one half */
        } else if (s <= 0) {
            rgb[c] = x && -s < 31 && ((uint64_t)x << -s) < (1u << 31) ? 255 : 0;
        } else {
            q = x >> s;
            rem = x & ((1u << s) - 1);
            half = 1u << (s - 1);
            q += rem > half || (rem == half && (q & 1));
            rgb[c] = (uint8_t)(q > 255 ? 255 : q);
        }
    }
}

/* RGBE_ReadPixels_RLE of body[0:n] into rgb[height][width][3]; 0, or 1
 * where cv2 returns no image (data that ends early, a bad run). */
int hdr_pixels(const uint8_t *body, long n, int height, int width,
               uint8_t *rgb)
{
    long pos = 0, total = (long)height * width, px;
    uint8_t *line;
    int y;
    if (width < 8 || width > 0x7FFF) {
        if (n < 4 * total) return 1;
        for (px = 0; px < total; px++)
            rgbe_to_rgb8(body + 4 * px, rgb + 3 * px);
        return 0;
    }
    line = (uint8_t *)malloc((size_t)4 * width);
    if (!line) return 2;
    for (y = 0; y < height; y++) {
        const uint8_t *h = body + pos;
        int c, x;
        if (pos + 4 > n) goto bad;
        pos += 4;
        if (h[0] != 2 || h[1] != 2 || (h[2] & 0x80)) {
            /* Not run-length coded: this pixel and the rest flat. */
            long first = (long)y * width;
            if (pos + 4 * (total - first - 1) > n) goto bad;
            rgbe_to_rgb8(h, rgb + 3 * first);
            for (px = first + 1; px < total; px++, pos += 4)
                rgbe_to_rgb8(body + pos, rgb + 3 * px);
            free(line);
            return 0;
        }
        if (((int)h[2] << 8 | h[3]) != width) goto bad;
        for (c = 0; c < 4; c++) {
            int at = c * width, end = (c + 1) * width;
            while (at < end) {
                int count, value;
                if (pos + 2 > n) goto bad;
                count = body[pos];
                value = body[pos + 1];
                pos += 2;
                if (count > 128) {
                    count -= 128;
                    if (count > end - at) goto bad;
                    memset(line + at, value, (size_t)count);
                } else {
                    if (count == 0 || count > end - at) goto bad;
                    line[at] = (uint8_t)value;
                    if (count > 1) {
                        if (pos + count - 1 > n) goto bad;
                        memcpy(line + at + 1, body + pos, (size_t)count - 1);
                        pos += count - 1;
                    }
                }
                at += count;
            }
        }
        for (x = 0; x < width; x++) {
            uint8_t p[4];
            for (c = 0; c < 4; c++) p[c] = line[c * width + x];
            rgbe_to_rgb8(p, rgb + 3 * ((size_t)y * width + x));
        }
    }
    free(line);
    return 0;
bad:
    free(line);
    return 1;
}

/* cv2's uint8 -> float32 (times the float 1/255) and float2rgbe. The
 * largest channel v lies in [1/255, 1], so frexp's exponent e is that of
 * its float bits and frexp(v) * 256.0 / v is exactly 2^(8 - e). */
static void rgb8_to_rgbe(const uint8_t *rgb, uint8_t *rgbe)
{
    const float k = 1.0f / 255.0f;
    float r = rgb[0] * k, g = rgb[1] * k, b = rgb[2] * k, v = r, scale;
    uint32_t bits;
    int e;
    if (g > v) v = g;
    if (b > v) v = b;
    if (v < 1e-32) {
        rgbe[0] = rgbe[1] = rgbe[2] = rgbe[3] = 0;
        return;
    }
    memcpy(&bits, &v, sizeof bits);
    e = (int)((bits >> 23) & 0xFF) - 126;
    scale = (float)(1u << (8 - e));
    rgbe[0] = (uint8_t)(r * scale);
    rgbe[1] = (uint8_t)(g * scale);
    rgbe[2] = (uint8_t)(b * scale);
    rgbe[3] = (uint8_t)(e + 128);
}

/* RGBE_WriteBytes_RLE of data[0:count] at out + *at. */
static void rgbe_rle(const uint8_t *data, int count, uint8_t *out, long *at)
{
    int cur = 0;
    while (cur < count) {
        int beg = cur, run = 0, old_run = 0;
        while (run < 4 && beg < count) {
            beg += run;
            old_run = run;
            run = 1;
            while (beg + run < count && run < 127
                   && data[beg] == data[beg + run])
                run++;
        }
        if (old_run > 1 && old_run == beg - cur) {
            out[(*at)++] = (uint8_t)(128 + old_run);
            out[(*at)++] = data[cur];
            cur = beg;
        }
        while (cur < beg) {
            int k = beg - cur > 128 ? 128 : beg - cur;
            out[(*at)++] = (uint8_t)k;
            memcpy(out + *at, data + cur, (size_t)k);
            *at += k;
            cur += k;
        }
        if (run >= 4) {
            out[(*at)++] = (uint8_t)(128 + run);
            out[(*at)++] = data[beg];
            cur += run;
        }
    }
}

/* What cv2.imencode(".hdr") writes for rgb[height][width][3], into
 * out[0:cap]; *size its length. 0, 1 if cap is too small (*size then the
 * bytes needed at most), 2 if out of memory. */
int encode_hdr(const uint8_t *rgb, int height, int width, uint8_t *out,
               long cap, long *size)
{
    char head[96];
    int len = snprintf(head, sizeof head,
                       "#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n",
                       height, width);
    long need = len + (long)height * (4 + 4 * (width + (width + 127) / 128 + 2))
                + 4L * height * width, at = len, px;
    uint8_t *line;
    int y, x, c;
    if (cap < need) {
        *size = need;
        return 1;
    }
    memcpy(out, head, (size_t)len);
    if (width < 8 || width > 0x7FFF) {
        for (px = 0; px < (long)height * width; px++, at += 4)
            rgb8_to_rgbe(rgb + 3 * px, out + at);
        *size = at;
        return 0;
    }
    line = (uint8_t *)malloc((size_t)4 * width);
    if (!line) return 2;
    for (y = 0; y < height; y++) {
        out[at++] = 2;
        out[at++] = 2;
        out[at++] = (uint8_t)(width >> 8);
        out[at++] = (uint8_t)(width & 0xFF);
        for (x = 0; x < width; x++) {
            uint8_t p[4];
            rgb8_to_rgbe(rgb + 3 * ((size_t)y * width + x), p);
            for (c = 0; c < 4; c++) line[c * width + x] = p[c];
        }
        for (c = 0; c < 4; c++) rgbe_rle(line + c * width, width, out, &at);
    }
    free(line);
    *size = at;
    return 0;
}

/* ------------------------------------------------------------------ */
/* GIF writing, as cv2.imencode(".gif") writes at its defaults.        */

/* The bytes of a GIF of width x height pixels besides its LZW data:
 * header and 3-3-2 palette (781), NETSCAPE2.0 (19), graphic control
 * (8), image descriptor (10), minimum code size (1), block terminator
 * and trailer (2). */
#define GIF_FIXED 821L

/* The largest file encode_gif can write for n pixels: a 12-bit code a
 * pixel at most, a clear every 3838 codes, the first clear and the end
 * code, and a length byte for each 255 bytes of them. */
static long gif_bound(long n)
{
    long data = (12 * (n + n / 3838 + 2) + 7) / 8;
    return GIF_FIXED + data + (data + 254) / 255;
}

/* The LZW data in sub-blocks of up to 255 bytes: codes least significant
 * bit first, each block's length byte written when it fills or ends. */
typedef struct {
    uint8_t *out;
    long at, block;
    uint32_t acc;
    int bits;
} GifBits;

static void gif_byte(GifBits *g, uint8_t b)
{
    if (g->at - g->block == 256) {
        g->out[g->block] = 255;
        g->block = g->at++;
    }
    g->out[g->at++] = b;
}

static void gif_put(GifBits *g, int code, int width)
{
    g->acc |= (uint32_t)code << g->bits;
    g->bits += width;
    while (g->bits >= 8) {
        gif_byte(g, (uint8_t)g->acc);
        g->acc >>= 8;
        g->bits -= 8;
    }
}

/* Floyd-Steinberg onto the 3-3-2 palette, as cv2 dithers: each channel
 * on its own, rows from the top, each left to right. A pixel's value v
 * is its byte plus the error it has gathered, both in float32; its level
 * is (int)(clamp(v, 0, 255) / step + 0.5) (steps 36, 36, 85: halves
 * round up, and the clamp keeps the level within the palette), and
 * v - level * step, from the unclamped v, goes 7/16 to the right and
 * 3/16, 5/16 and 1/16 to the row below, added into float32 error rows
 * that start at 0. Returns 2 if out of memory. */
static int gif_dither(const uint8_t *rgb, int height, int width,
                      uint8_t *idx)
{
    static const float steps[3] = {36.0f, 36.0f, 85.0f};
    static const int shifts[3] = {5, 2, 0};
    size_t row = (size_t)(width + 2) * 3;
    float *err = calloc(2 * row, sizeof(float));
    if (!err) return 2;
    for (int y = 0; y < height; y++) {
        /* err + 3 and below + 3 hold column 0; one column of slack
         * on each side takes the error that falls off the image. */
        float *cur = err + (y & 1) * row + 3, *below = err
            + ((y + 1) & 1) * row + 3;
        memset(below - 3, 0, row * sizeof(float));
        for (int x = 0; x < width; x++) {
            const uint8_t *px = rgb + 3 * ((size_t)y * width + x);
            int code = 0;
            for (int c = 0; c < 3; c++) {
                float v = (float)px[c] + cur[3 * x + c];
                float cl = v < 0.0f ? 0.0f : v > 255.0f ? 255.0f : v;
                int q = (int)(cl / steps[c] + 0.5f);
                float e = v - (float)q * steps[c];
                code |= q << shifts[c];
                if (x + 1 < width)
                    cur[3 * (x + 1) + c] += e * 7.0f / 16.0f;
                if (y + 1 < height) {
                    if (x > 0)
                        below[3 * (x - 1) + c] += e * 3.0f / 16.0f;
                    below[3 * x + c] += e * 5.0f / 16.0f;
                    if (x + 1 < width)
                        below[3 * (x + 1) + c] += e * 1.0f / 16.0f;
                }
            }
            idx[(size_t)y * width + x] = (uint8_t)code;
        }
    }
    free(err);
    return 0;
}

/* What cv2.imencode(".gif") writes for rgb[height][width][3] (sides 1 to
 * 65535) at its defaults, into out[0:cap]; *size its length. GIF89a with
 * a global 3-3-2 palette (entry i: R (i >> 5) * 36, G ((i >> 2) & 7) *
 * 36, B (i & 3) * 85; flags 0xF7), NETSCAPE2.0 looping forever, a
 * graphic control extension of disposal 3 and delay 100 without
 * transparency, one frame at (0, 0) of the dithered indices (gif_dither)
 * coded by LZW with minimum code size 8. The codes start with a clear;
 * a code's width grows once the decoder's table (one entry behind the
 * encoder's, which adds an entry with every code it sends) reaches
 * 1 << width entries, up to 12 bits; when the encoder's next free code
 * reaches 4096 it sends a clear at 12 bits and starts again from 9. The
 * end-of-information code follows the last string's code at the width
 * the decoder then reads. 0, 1 if cap is too small (*size then the
 * bytes needed at most), 2 if out of memory. */
int encode_gif(const uint8_t *rgb, int height, int width, uint8_t *out,
               long cap, long *size)
{
    static const uint8_t extensions[] = {
        0x21, 0xFF, 0x0B, 'N', 'E', 'T', 'S', 'C', 'A', 'P', 'E', '2', '.',
        '0', 0x03, 0x01, 0x00, 0x00, 0x00,
        0x21, 0xF9, 0x04, 0x0C, 0x64, 0x00, 0x00, 0x00};
    long n = (long)height * width, at = 0, need = gif_bound(n);
    if (cap < need) {
        *size = need;
        return 1;
    }
    uint8_t *idx = malloc((size_t)n);
    uint16_t *next = malloc(sizeof(uint16_t) * 4096 * 256);
    uint32_t *stamp = calloc(4096 * 256, sizeof(uint32_t));
    if (!idx || !next || !stamp || gif_dither(rgb, height, width, idx)) {
        free(idx);
        free(next);
        free(stamp);
        return 2;
    }
    memcpy(out, "GIF89a", 6);
    at = 6;
    out[at++] = (uint8_t)width;
    out[at++] = (uint8_t)(width >> 8);
    out[at++] = (uint8_t)height;
    out[at++] = (uint8_t)(height >> 8);
    out[at++] = 0xF7;
    out[at++] = 0;
    out[at++] = 0;
    for (int i = 0; i < 256; i++) {
        out[at++] = (uint8_t)((i >> 5) * 36);
        out[at++] = (uint8_t)(((i >> 2) & 7) * 36);
        out[at++] = (uint8_t)((i & 3) * 85);
    }
    memcpy(out + at, extensions, sizeof extensions);
    at += sizeof extensions;
    uint8_t descriptor[11] = {0x2C, 0, 0, 0, 0, (uint8_t)width,
                              (uint8_t)(width >> 8), (uint8_t)height,
                              (uint8_t)(height >> 8), 0x07, 8};
    memcpy(out + at, descriptor, sizeof descriptor);
    at += sizeof descriptor;

    /* (prefix code, byte) -> code, live where stamp equals gen. */
    GifBits g = {out, at + 1, at, 0, 0};
    uint32_t gen = 1;
    int width_bits = 9, free_code = 258, ent = idx[0];
    gif_put(&g, 256, width_bits);
    for (long i = 1; i < n; i++) {
        long key = ((long)ent << 8) | idx[i];
        if (stamp[key] == gen) {
            ent = next[key];
            continue;
        }
        gif_put(&g, ent, width_bits);
        stamp[key] = gen;
        next[key] = (uint16_t)free_code++;
        if (free_code > 1 << width_bits && width_bits < 12)
            width_bits++;
        if (free_code == 4096) {
            gif_put(&g, 256, width_bits);
            gen++;
            free_code = 258;
            width_bits = 9;
        }
        ent = idx[i];
    }
    gif_put(&g, ent, width_bits);
    if (free_code + 1 > 1 << width_bits && width_bits < 12)
        width_bits++;
    gif_put(&g, 257, width_bits);
    if (g.bits)
        gif_byte(&g, (uint8_t)g.acc);
    out[g.block] = (uint8_t)(g.at - g.block - 1); /* 1 to 255 */
    at = g.at;
    out[at++] = 0;
    out[at++] = 0x3B;
    free(idx);
    free(next);
    free(stamp);
    *size = at;
    return 0;
}
