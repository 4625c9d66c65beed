/* Host JPEG 2000 writer of the port, in plain C99 with no library: the
 * tile of the file cv2.imencode(".jp2") writes at OpenCV 5.0's defaults,
 * as OpenJPEG 2.5.3 encodes it (opj_tcd_encode_tile). The JP2 boxes, the
 * main header, the tile-part header and the budget are Python
 * (utils/jpeg2000_write.py), which also holds the plain version of
 * everything here; this file matches it byte for byte.
 *
 * j2k_encode_tile takes uint8 RGB [h, w, 3] and the budget in bytes of
 * the tile's packets. It lays out the tile's geometry with the decoder's
 * j2k_geometry (6 resolutions, one precinct each, 64 x 64 code-blocks),
 * level-shifts each component by -128 and runs the forward 5/3 at 5
 * levels (each level the columns, then the rows; lows before highs),
 * codes each code-block (opj_t1_encode_cblk: the MQ coder of mqc.c, three
 * passes a bit-plane, one flush after the last cleanup pass; each pass's
 * rate, bytes plus 3 where the pass is not terminated, and its
 * distortion, opj_t1_getwmsedec in double), then searches the slope
 * threshold of the one quality layer (opj_tcd_rateallocate: bisection
 * between the smallest and largest pass slope, up to 128 steps, stopping
 * when a step moves the threshold by no more than 5e-6 of itself; each
 * threshold sized by the layer's packets as opj_t2_encode_packets would
 * write them) and writes the packets in LRCP order (opj_t2_encode_packet:
 * inclusion and zero-bit-plane tag trees, pass counts, Lblock, lengths,
 * a 0 bit after each 0xFF of a header, then the code-blocks' bytes).
 *
 * Returns 0 with the packets in out[0..*outlen), 3 with *outlen the bytes
 * needed when cap is too small, 2 when out of memory. No float operation
 * is contracted (-std=c99): the distortions and slopes are OpenJPEG's
 * doubles, operation for operation.
 */

#include <float.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "jpeg2000.h"

#define NUMRES 6
#define CBLK_EXP 6
#define FRACBITS 6
#define MAXPASSES (3 * 32)

/* opj_dwt_norms: the 5/3 norms by orientation and level. */
static const double DWT_NORMS[4][10] = {
    {1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3},
    {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
    {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
    {.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93}};

/* Band Mb: QCD's exponent (8 plus the band's gain) + 2 guard bits - 1. */
static const int BAND_NUMBPS[4] = {9, 10, 10, 11};

typedef struct {
    int sig[128], sig0[128], ref[128], ref0[128];
} Luts;

static int lut_entry(double x) {
    int v = (int)(floor(x * 64.0 + 0.5) / 64.0 * 8192.0);
    return v > 0 ? v : 0;
}

/* t1_generate_luts.c's lut_nmsedec_sig, _sig0, _ref and _ref0. */
static void make_luts(Luts *l) {
    int i;
    for (i = 0; i < 128; i++) {
        double t = i / 64.0, u = t, v = t - 1.5;
        l->sig[i] = lut_entry(u * u - v * v);
        l->sig0[i] = lut_entry(u * u);
        u = t - 1.0;
        v = (i & 64) ? t - 1.5 : t - 0.5;
        l->ref[i] = lut_entry(u * u - v * v);
        l->ref0[i] = lut_entry(u * u);
    }
}

/* --- the forward 5/3 --------------------------------------------------- */

/* opj_dwt_encode_1 with cas 0 on n samples a stride apart: lows, then
 * highs. */
static void fdwt53(int32_t *x, long stride, int n, int32_t *tmp) {
    int sn = (n + 1) / 2, dn = n / 2, i;
    int32_t *s = tmp, *d = tmp + sn;
    if (dn == 0) return;
    for (i = 0; i < sn; i++) s[i] = x[2 * i * stride];
    for (i = 0; i < dn; i++) d[i] = x[(2 * i + 1) * stride];
    for (i = 0; i < dn; i++)
        d[i] -= (s[i] + s[imin(i + 1, sn - 1)]) >> 1;
    for (i = 0; i < sn; i++)
        s[i] += (d[imax(i - 1, 0)] + d[imin(i, dn - 1)] + 2) >> 2;
    for (i = 0; i < n; i++) x[i * stride] = tmp[i];
}

static void forward_dwt(Comp *cp, int32_t *plane, int w, int32_t *tmp) {
    int r, i;
    for (r = NUMRES - 1; r > 0; r--) {
        Res *res = &cp->res[r];
        int rw = res->x1 - res->x0, rh = res->y1 - res->y0;
        for (i = 0; i < rw; i++) fdwt53(plane + i, w, rh, tmp);
        for (i = 0; i < rh; i++) fdwt53(plane + (long)i * w, 1, rw, tmp);
    }
}

/* --- tier 1 ----------------------------------------------------------- */

typedef struct {
    uint8_t *buf; /* buf[0]: the byte before the data, where bp starts */
    long bp;
    uint32_t a, c;
    int ct;
    uint8_t st[19], mps[19];
} Enc;

static void enc_init(Enc *e, uint8_t *buf) {
    memset(e, 0, sizeof(*e));
    e->buf = buf;
    e->buf[0] = 0;
    e->a = 0x8000;
    e->ct = 12;
    e->st[18] = 46;
    e->st[17] = 3;
    e->st[0] = 4;
}

static long enc_numbytes(const Enc *e) { return e->bp - 1; }

static void enc_byteout(Enc *e) {
    uint8_t *b = e->buf;
    if (b[e->bp] == 0xFF) {
        b[++e->bp] = (uint8_t)(e->c >> 20);
        e->c &= 0xFFFFF;
        e->ct = 7;
    } else if (!(e->c & 0x8000000)) {
        b[++e->bp] = (uint8_t)(e->c >> 19);
        e->c &= 0x7FFFF;
        e->ct = 8;
    } else {
        b[e->bp]++;
        if (b[e->bp] == 0xFF) {
            e->c &= 0x7FFFFFF;
            b[++e->bp] = (uint8_t)(e->c >> 20);
            e->c &= 0xFFFFF;
            e->ct = 7;
        } else {
            b[++e->bp] = (uint8_t)(e->c >> 19);
            e->c &= 0x7FFFF;
            e->ct = 8;
        }
    }
}

static void enc_encode(Enc *e, int cx, int d) {
    int s = e->st[cx];
    uint32_t q = J2K_QE[s];
    e->a -= q;
    if (e->mps[cx] == d) {
        if (e->a & 0x8000) {
            e->c += q;
            return;
        }
        if (e->a < q)
            e->a = q;
        else
            e->c += q;
        e->st[cx] = J2K_NMPS[s];
    } else {
        if (e->a < q)
            e->c += q;
        else
            e->a = q;
        if (J2K_SWITCH[s]) e->mps[cx] = (uint8_t)(1 - e->mps[cx]);
        e->st[cx] = J2K_NLPS[s];
    }
    do {
        e->a <<= 1;
        e->c <<= 1;
        if (--e->ct == 0) enc_byteout(e);
    } while (!(e->a & 0x8000));
}

/* opj_mqc_flush. */
static void enc_flush(Enc *e) {
    uint32_t tempc = e->c + e->a;
    e->c |= 0xFFFF;
    if (e->c >= tempc) e->c -= 0x8000;
    e->c <<= e->ct;
    enc_byteout(e);
    e->c <<= e->ct;
    enc_byteout(e);
    if (e->buf[e->bp] != 0xFF) e->bp++;
}

/* A code-block's coding: its bytes and per pass the cumulative rate and
 * distortion decrease; `n` passes in the layer being sized. */
typedef struct {
    int numbps, npasses, n;
    long len;
    uint8_t *data;
    uint32_t rates[MAXPASSES];
    double dists[MAXPASSES];
} Coded;

typedef struct {
    int W;
    int32_t *mag;
    uint8_t *neg, *sig, *vis, *ref;
    uint8_t *buf;
    const Luts *luts;
    int zc[45]; /* by h * 15 + v * 5 + d */
} T1;

static void code_sign(T1 *t, Enc *e, int p) {
    int W = t->W, hc, vc, ctx, xr;
    hc = (t->sig[p - 1] ? (t->neg[p - 1] ? -1 : 1) : 0)
         + (t->sig[p + 1] ? (t->neg[p + 1] ? -1 : 1) : 0);
    vc = (t->sig[p - W] ? (t->neg[p - W] ? -1 : 1) : 0)
         + (t->sig[p + W] ? (t->neg[p + W] ? -1 : 1) : 0);
    hc = hc > 0 ? 1 : (hc < 0 ? -1 : 0);
    vc = vc > 0 ? 1 : (vc < 0 ? -1 : 0);
    if (hc == 0) {
        ctx = vc == 0 ? 9 : 10;
        xr = vc < 0;
    } else {
        ctx = vc == 0 ? 12 : (vc == hc ? 13 : 11);
        xr = hc < 0;
    }
    enc_encode(e, ctx, t->neg[p] ^ xr);
    t->sig[p] = 1;
}

static int zc_index(const T1 *t, int p, int *any) {
    int W = t->W;
    const uint8_t *s = t->sig;
    int h = s[p - 1] + s[p + 1], v = s[p - W] + s[p + W];
    int d = s[p - W - 1] + s[p - W + 1] + s[p + W - 1] + s[p + W + 1];
    *any = h | v | d;
    return h * 15 + v * 5 + d;
}

static int sig_lut(const T1 *t, int p, int bpno) {
    uint32_t x = (uint32_t)t->mag[p];
    return bpno > 0 ? t->luts->sig[(x >> bpno) & 127]
                    : t->luts->sig0[x & 127];
}

static double wmsedec(int nmsedec, int level, int orient, int bpno) {
    double w = 1.0 * DWT_NORMS[orient][imin(level, orient ? 8 : 9)] * 1.0
               * (double)(1 << bpno);
    return w * (w * nmsedec / 8192.0);
}

/* opj_t1_encode_cblk, code-block style 0, on coeffs [h, w] (row stride
 * `stride`) into cb. */
static void encode_cblk(T1 *t, const int32_t *coeffs, long stride, int w,
                        int h, int orient, int level, Coded *cb) {
    int W = w + 2, size = W * (h + 2), x, y, p, top = 0, bpno, passtype;
    int passno = 0, i;
    double cum = 0.0;
    Enc e;
    t->W = W;
    memset(t->mag, 0, sizeof(int32_t) * (size_t)size);
    memset(t->neg, 0, (size_t)size);
    memset(t->sig, 0, (size_t)size);
    memset(t->vis, 0, (size_t)size);
    memset(t->ref, 0, (size_t)size);
    for (y = 0; y < h; y++)
        for (x = 0; x < w; x++) {
            int32_t v = coeffs[(long)y * stride + x];
            int32_t m = v < 0 ? -v : v;
            p = (y + 1) * W + x + 1;
            t->mag[p] = m << FRACBITS;
            t->neg[p] = v < 0;
            if (m > top) top = m;
        }
    cb->npasses = 0;
    cb->len = 0;
    cb->numbps = 0;
    if (!top) return;
    while (top >> cb->numbps) cb->numbps++;
    enc_init(&e, t->buf);
    bpno = cb->numbps - 1;
    passtype = 2;
    while (bpno >= 0) {
        int32_t one = (int32_t)1 << (bpno + FRACBITS);
        int nmsedec = 0, y0, any;
        for (y0 = 0; y0 < h; y0 += 4) {
            int y1 = imin(y0 + 4, h);
            for (x = 0; x < w; x++) {
                int col = (y0 + 1) * W + x + 1;
                int end = col + (y1 - y0) * W, start = col;
                if (passtype == 0) {
                    for (p = col; p < end; p += W) {
                        int zi, v;
                        if (t->sig[p] || t->vis[p]) continue;
                        zi = zc_index(t, p, &any);
                        if (!any) continue;
                        v = (t->mag[p] & one) != 0;
                        enc_encode(&e, t->zc[zi], v);
                        if (v) {
                            nmsedec += sig_lut(t, p, bpno);
                            code_sign(t, &e, p);
                        }
                        t->vis[p] = 1;
                    }
                } else if (passtype == 1) {
                    for (p = col; p < end; p += W) {
                        uint32_t m;
                        int ctx;
                        if (!t->sig[p] || t->vis[p]) continue;
                        m = (uint32_t)t->mag[p];
                        nmsedec += bpno > 0 ? t->luts->ref[(m >> bpno) & 127]
                                            : t->luts->ref0[m & 127];
                        if (t->ref[p]) {
                            ctx = 16;
                        } else {
                            zc_index(t, p, &any);
                            ctx = any ? 15 : 14;
                        }
                        enc_encode(&e, ctx, (m & (uint32_t)one) != 0);
                        t->ref[p] = 1;
                    }
                } else {
                    int run_mode = y1 - y0 == 4;
                    for (p = col; run_mode && p < end; p += W) {
                        zc_index(t, p, &any);
                        if (t->sig[p] || t->vis[p] || any) run_mode = 0;
                    }
                    if (run_mode) {
                        int run = 0;
                        while (run < 4 && !(t->mag[col + run * W] & one))
                            run++;
                        enc_encode(&e, 17, run != 4);
                        if (run == 4) continue;
                        enc_encode(&e, 18, run >> 1);
                        enc_encode(&e, 18, run & 1);
                        p = col + run * W;
                        nmsedec += sig_lut(t, p, bpno);
                        code_sign(t, &e, p);
                        start = p + W;
                    }
                    for (p = start; p < end; p += W) {
                        int zi, v;
                        if (t->sig[p] || t->vis[p]) continue;
                        zi = zc_index(t, p, &any);
                        v = (t->mag[p] & one) != 0;
                        enc_encode(&e, t->zc[zi], v);
                        if (v) {
                            nmsedec += sig_lut(t, p, bpno);
                            code_sign(t, &e, p);
                        }
                    }
                }
            }
        }
        cum += wmsedec(nmsedec, level, orient, bpno);
        cb->dists[passno] = cum;
        if (passtype == 2) memset(t->vis, 0, (size_t)size);
        if (passtype == 2 && bpno == 0) {
            enc_flush(&e);
            cb->rates[passno] = (uint32_t)enc_numbytes(&e);
        } else {
            cb->rates[passno] = (uint32_t)(enc_numbytes(&e) + 3);
        }
        passno++;
        if (++passtype == 3) {
            passtype = 0;
            bpno--;
        }
    }
    cb->npasses = passno;
    cb->len = enc_numbytes(&e);
    {
        uint32_t last = (uint32_t)cb->len;
        for (i = passno - 1; i >= 0; i--) {
            if (cb->rates[i] > last)
                cb->rates[i] = last;
            else
                last = cb->rates[i];
        }
    }
    for (i = 0; i < passno; i++)
        if (t->buf[cb->rates[i]] == 0xFF) cb->rates[i]--; /* data[rate-1] */
}

/* --- tier 2 ----------------------------------------------------------- */

typedef struct {
    uint8_t *out; /* NULL: count only */
    long n;
    unsigned buf, ct;
} Bits;

static void bits_byteout(Bits *b) {
    b->buf = (b->buf << 8) & 0xFFFF;
    b->ct = b->buf == 0xFF00 ? 7 : 8;
    if (b->out) b->out[b->n] = (uint8_t)(b->buf >> 8);
    b->n++;
}

static void bits_put(Bits *b, uint32_t v, int n) {
    int i;
    for (i = n - 1; i >= 0; i--) {
        if (b->ct == 0) bits_byteout(b);
        b->ct--;
        b->buf |= ((v >> i) & 1u) << b->ct;
    }
}

static void bits_flush(Bits *b) {
    bits_byteout(b);
    if (b->ct == 7) bits_byteout(b);
}

static void tagtree_set(TagTree *t, int leaf, int value) {
    int node = leaf;
    while (node >= 0 && t->value[node] > value) {
        t->value[node] = value;
        node = t->parent[node];
    }
}

/* opj_tgt_encode; known[] as opj_tgt_node_t's `known`. */
static void tagtree_encode(TagTree *t, uint8_t *known, Bits *b, int leaf,
                           int threshold) {
    int stack[32], depth = 0, node = leaf, low = 0;
    while (t->parent[node] >= 0) {
        stack[depth++] = node;
        node = t->parent[node];
    }
    for (;;) {
        if (low > t->low[node])
            t->low[node] = low;
        else
            low = t->low[node];
        while (low < threshold) {
            if (low >= t->value[node]) {
                if (!known[node]) {
                    bits_put(b, 1, 1);
                    known[node] = 1;
                }
                break;
            }
            bits_put(b, 0, 1);
            low++;
        }
        t->low[node] = low;
        if (!depth) break;
        node = stack[--depth];
    }
}

static int floorlog2(uint32_t a) {
    int l = 0;
    while (a > 1) {
        a >>= 1;
        l++;
    }
    return l;
}

static void putnumpasses(Bits *b, int n) {
    if (n == 1)
        bits_put(b, 0, 1);
    else if (n == 2)
        bits_put(b, 2, 2);
    else if (n <= 5)
        bits_put(b, 0xC | (uint32_t)(n - 3), 4);
    else if (n <= 36)
        bits_put(b, 0x1E0 | (uint32_t)(n - 6), 9);
    else
        bits_put(b, 0xFF80 | (uint32_t)(n - 37), 16);
}

typedef struct {
    Comp comp[3];
    Coded *coded; /* every code-block, in packet order */
    uint8_t *known;
} Tile;

/* The code-blocks of the packet of (resno, compno), and its bands. */
static Coded *packet_blocks(Tile *tl, int resno, int compno) {
    Coded *cb = tl->coded;
    int r, c, b;
    for (r = 0; r <= resno; r++)
        for (c = 0; c < 3; c++) {
            Res *res = &tl->comp[c].res[r];
            if (r == resno && c == compno) return cb;
            for (b = 0; b < res->nbands; b++) {
                Prec *pr = &res->bands[b].precs[0];
                cb += pr->cw * pr->ch;
            }
        }
    return cb;
}

/* opj_t2_encode_packet for layer 0 of one precinct: header then bodies;
 * returns its size (out NULL: sizes only). */
static long encode_packet(Tile *tl, int resno, int compno, uint8_t *out) {
    Res *res = &tl->comp[compno].res[resno];
    Coded *first = packet_blocks(tl, resno, compno), *cb;
    Bits bits = {out, 0, 0, 8};
    long size;
    int b, k, i;
    bits_put(&bits, 1, 1);
    cb = first;
    for (b = 0; b < res->nbands; b++) {
        Band *band = &res->bands[b];
        Prec *pr = &band->precs[0];
        int nb = pr->cw * pr->ch;
        j2k_tagtree_reset(&pr->incl);
        j2k_tagtree_reset(&pr->imsb);
        memset(tl->known, 0, (size_t)pr->incl.n * 2);
        for (k = 0; k < nb; k++) {
            tagtree_set(&pr->imsb, k, BAND_NUMBPS[band->bandno]
                                          - cb[k].numbps);
            if (cb[k].n) tagtree_set(&pr->incl, k, 0);
        }
        for (k = 0; k < nb; k++) {
            int n = cb[k].n, inc, lb;
            uint32_t len;
            tagtree_encode(&pr->incl, tl->known, &bits, k, 1);
            if (!n) continue;
            tagtree_encode(&pr->imsb, tl->known + pr->incl.n, &bits, k, 999);
            putnumpasses(&bits, n);
            len = cb[k].rates[n - 1];
            lb = floorlog2((uint32_t)n);
            inc = imax(0, floorlog2(len) + 1 - (3 + lb));
            for (i = 0; i < inc; i++) bits_put(&bits, 1, 1);
            bits_put(&bits, 0, 1);
            bits_put(&bits, len, 3 + inc + lb);
        }
        cb += nb;
    }
    bits_flush(&bits);
    size = bits.n;
    cb = first;
    for (b = 0; b < res->nbands; b++) {
        Prec *pr = &res->bands[b].precs[0];
        for (k = 0; k < pr->cw * pr->ch; k++, cb++) {
            long len = cb->n ? (long)cb->rates[cb->n - 1] : 0;
            if (out && len) memcpy(out + size, cb->data, (size_t)len);
            size += len;
        }
    }
    return size;
}

static long encode_packets(Tile *tl, uint8_t *out) {
    long size = 0;
    int r, c;
    for (r = 0; r < NUMRES; r++)
        for (c = 0; c < 3; c++)
            size += encode_packet(tl, r, c, out ? out + size : NULL);
    return size;
}

/* opj_tcd_makelayer's pass count for layer 0 at thresh. */
static int passes_at(const Coded *cb, double thresh) {
    int n = 0, passno;
    for (passno = 0; passno < cb->npasses; passno++) {
        uint32_t dr;
        double dd;
        if (n == 0) {
            dr = cb->rates[passno];
            dd = cb->dists[passno];
        } else {
            dr = cb->rates[passno] - cb->rates[n - 1];
            dd = cb->dists[passno] - cb->dists[n - 1];
        }
        if (!dr) {
            if (dd != 0) n = passno + 1;
            continue;
        }
        if (thresh - dd / (double)dr < DBL_EPSILON) n = passno + 1;
    }
    return n;
}

/* opj_tcd_makelayer at thresh; whether no code-block's count changed. */
static int make_layer(Tile *tl, long nblocks, double thresh) {
    long i;
    int same = 1;
    for (i = 0; i < nblocks; i++) {
        int n = passes_at(&tl->coded[i], thresh);
        if (n != tl->coded[i].n) same = 0;
        tl->coded[i].n = n;
    }
    return same;
}

/* opj_tcd_rateallocate for one layer: the threshold. */
static double allocate(Tile *tl, long nblocks, long maxlen) {
    double lo = DBL_MAX, hi = 0, thresh = 0, stable = 0;
    long i;
    int step, fits = 0;
    for (i = 0; i < nblocks; i++) {
        const Coded *cb = &tl->coded[i];
        int passno;
        for (passno = 0; passno < cb->npasses; passno++) {
            int32_t dr;
            double dd, slope;
            if (passno == 0) {
                dr = (int32_t)cb->rates[0];
                dd = cb->dists[0];
            } else {
                dr = (int32_t)(cb->rates[passno] - cb->rates[passno - 1]);
                dd = cb->dists[passno] - cb->dists[passno - 1];
            }
            if (dr == 0) continue;
            slope = dd / dr;
            if (slope < lo) lo = slope;
            if (slope > hi) hi = slope;
        }
    }
    for (i = 0; i < nblocks; i++) tl->coded[i].n = -1;
    for (step = 0; step < 128; step++) {
        double next = (lo + hi) / 2;
        int same;
        if (fabs(next - thresh) <= 5e-6 * thresh) break;
        thresh = next;
        same = make_layer(tl, nblocks, thresh) && step != 0;
        if (!same) fits = encode_packets(tl, NULL) <= maxlen;
        if (!fits) {
            lo = thresh;
        } else {
            hi = thresh;
            stable = thresh;
        }
    }
    return stable == 0 ? thresh : stable;
}

/* --- the tile --------------------------------------------------------- */

static long encode(Ctx *ctx, const uint8_t *rgb, int h, int w, long maxlen,
                   uint8_t *out, long cap) {
    static const int32_t prc[MAXRLVLS] = {15, 15, 15, 15, 15, 15},
                         zero[MAXBANDS] = {0};
    Tile tl;
    T1 t1;
    Luts luts;
    int32_t *plane, *tmp;
    uint8_t *arena;
    long nblocks = 0, used = 0, total, i;
    int c, r, b, k, maxn = 0;

    make_luts(&luts);
    memset(&tl, 0, sizeof(tl));
    for (c = 0; c < 3; c++) {
        Comp *cp = &tl.comp[c];
        cp->prec = 8;
        cp->numres = NUMRES;
        cp->cblkw = cp->cblkh = CBLK_EXP;
        cp->qmfbid = 1;
        cp->numgbits = 2;
        cp->prcw = cp->prch = prc;
        cp->expn = cp->mant = zero;
        j2k_geometry(ctx, cp, 0, 0, w, h);
        for (r = 0; r < NUMRES; r++)
            for (b = 0; b < cp->res[r].nbands; b++) {
                Prec *pr = &cp->res[r].bands[b].precs[0];
                nblocks += pr->cw * pr->ch;
                maxn = imax(maxn, pr->incl.n);
            }
    }
    tl.coded = (Coded *)j2k_alloc(ctx, sizeof(Coded) * (size_t)nblocks);
    tl.known = (uint8_t *)j2k_alloc(ctx, (size_t)maxn * 2);
    plane = (int32_t *)j2k_alloc(ctx, sizeof(int32_t) * (size_t)h * w);
    tmp = (int32_t *)j2k_alloc(ctx, sizeof(int32_t) * (size_t)imax(h, w));
    t1.mag = (int32_t *)j2k_alloc(ctx, sizeof(int32_t) * 66 * 66);
    t1.neg = (uint8_t *)j2k_alloc(ctx, 66 * 66);
    t1.sig = (uint8_t *)j2k_alloc(ctx, 66 * 66);
    t1.vis = (uint8_t *)j2k_alloc(ctx, 66 * 66);
    t1.ref = (uint8_t *)j2k_alloc(ctx, 66 * 66);
    t1.buf = (uint8_t *)j2k_alloc(ctx, 64 * 64 * 4 + 74 + 2);
    t1.luts = &luts;
    /* Every code-block's bytes: at most 4 a coefficient and 74 more, as
     * opj_tcd_code_block_enc_allocate_data reserves. */
    arena = (uint8_t *)j2k_alloc(ctx, (size_t)h * w * 3 * 4
                                          + (size_t)nblocks * 74);
    for (c = 0; c < 3; c++) {
        for (i = 0; i < (long)h * w; i++) plane[i] = rgb[i * 3 + c] - 128;
        forward_dwt(&tl.comp[c], plane, w, tmp);
        for (r = 0; r < NUMRES; r++) {
            Res *res = &tl.comp[c].res[r], *low = res - 1;
            Coded *cb = packet_blocks(&tl, r, c);
            for (b = 0; b < res->nbands; b++) {
                Band *band = &res->bands[b];
                Prec *pr = &band->precs[0];
                int ox = band->bandno & 1 ? low->x1 - low->x0 : 0;
                int oy = band->bandno & 2 ? low->y1 - low->y0 : 0;
                for (k = 0; k < 45; k++)
                    t1.zc[k] = j2k_zc_context(band->bandno, k / 15,
                                              k / 5 % 3, k % 5);
                for (k = 0; k < pr->cw * pr->ch; k++, cb++) {
                    Cblk *g = &pr->cblks[k];
                    encode_cblk(&t1, plane + (long)(oy + g->y0) * w + ox
                                         + g->x0,
                                w, g->x1 - g->x0, g->y1 - g->y0,
                                band->bandno, NUMRES - 1 - r, cb);
                    cb->data = arena + used;
                    memcpy(cb->data, t1.buf + 1, (size_t)cb->len);
                    used += cb->len;
                }
            }
        }
    }
    make_layer(&tl, nblocks, allocate(&tl, nblocks, maxlen));
    total = encode_packets(&tl, NULL);
    if (total <= cap) encode_packets(&tl, out);
    return total;
}

int j2k_encode_tile(const uint8_t *rgb, int h, int w, long maxlen,
                    uint8_t *out, long cap, long *outlen) {
    Ctx ctx;
    int rc;
    memset(&ctx, 0, sizeof(ctx));
    rc = setjmp(ctx.jump);
    if (!rc) {
        *outlen = encode(&ctx, rgb, h, w, maxlen, out, cap);
        rc = *outlen > cap ? 3 : 0;
    }
    while (ctx.blocks) {
        Block *b = ctx.blocks;
        ctx.blocks = b->next;
        free(b);
    }
    return rc;
}
