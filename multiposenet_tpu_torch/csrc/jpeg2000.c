/* Host JPEG 2000 tile decoder of the port, in plain C99 with no library:
 * one tile of a codestream as OpenJPEG 2.5.3 decodes it under OpenCV 5.0
 * (opj_tcd_decode_tile). The JP2 boxes, the main and tile-part headers,
 * the walk over tile parts and OpenCV's conversion to 8 bits are Python
 * (utils/jpeg2000.py), which passes each tile's parameters as a plan of
 * int32 and its data; the plain version of everything here is in that
 * module too, and this file matches it sample for sample.
 *
 * j2k_decode_tile lays out the tile's geometry (opj_tcd_init_tile:
 * resolutions, sub-bands, precincts and code-blocks with their ceiling
 * divisions), reads its packets in progression order (pi.c: LRCP, RLCP,
 * RPCL, PCRL, CPRL, and POC entries, each packet once; t2.c: tag trees,
 * pass counts, Lblock, bit stuffing after 0xFF, SOP and EPH), decodes
 * each code-block (t1.c, code-block style 0: the MQ decoder of mqc.c with
 * an 0xFF 0xFF pair after each segment, the significance, refinement and
 * cleanup passes, ROI shifts), dequantises, runs the inverse 5/3 or 9/7
 * transform (opj_dwt_decode_tile, opj_v8dwt_decode's float order of
 * operations), the inverse RCT or ICT, the DC level shift with rounding
 * half to even, and the clamp. Nothing here contracts float arithmetic:
 * each product and sum is rounded to float as OpenJPEG's SSE code rounds
 * it.
 *
 * Packet headers are read from the packets, or with *hpos >= 0 from
 * hdr[*hpos..hlen) (the PPM stream or the tile's PPT chunks), *hpos
 * advanced. Returns 0, 1 with a message in err where OpenJPEG fails, 2
 * when out of memory. out receives numcomps planes of th x tw int32;
 * resno, the image components' highest resolution decoded so far, is
 * raised by this tile's packets, and each component is reconstructed
 * and level-shifted up to it (the rest of its plane left as OpenJPEG
 * leaves it).
 */

#include <setjmp.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "jpeg2000.h"

#define PLAN_HEAD 10
#define PLAN_POC 6
#define COMP_INTS (9 + 2 * MAXRLVLS + 2 * MAXBANDS)

void j2k_fail(Ctx *c, const char *msg) {
    snprintf(c->err, (size_t)c->errlen, "%s", msg);
    longjmp(c->jump, 1);
}

void *j2k_alloc(Ctx *c, size_t n) {
    Block *b = (Block *)calloc(1, sizeof(Block) + (n ? n : 1));
    if (!b) longjmp(c->jump, 2);
    b->next = c->blocks;
    c->blocks = b;
    return (void *)(b + 1);
}

/* --- geometry ------------------------------------------------------------ */

void j2k_tagtree_init(Ctx *c, TagTree *t, int w, int h) {
    int lw[64], lh[64], nl = 0, n = 0, i, x, y, start = 0, k = 0;
    lw[0] = w;
    lh[0] = h;
    for (;;) {
        n += lw[nl] * lh[nl];
        if (lw[nl] * lh[nl] <= 1) break;
        lw[nl + 1] = (lw[nl] + 1) / 2;
        lh[nl + 1] = (lh[nl] + 1) / 2;
        nl++;
    }
    t->n = n;
    t->parent = (int *)j2k_alloc(c, sizeof(int) * (size_t)n);
    t->value = (int *)j2k_alloc(c, sizeof(int) * (size_t)n);
    t->low = (int *)j2k_alloc(c, sizeof(int) * (size_t)n);
    for (i = 0; i < nl; i++) {
        int up = start + lw[i] * lh[i];
        for (y = 0; y < lh[i]; y++)
            for (x = 0; x < lw[i]; x++)
                t->parent[k++] = up + (y / 2) * lw[i + 1] + x / 2;
        start = up;
    }
    t->parent[k] = -1;
}

void j2k_tagtree_reset(TagTree *t) {
    int i;
    for (i = 0; i < t->n; i++) {
        t->value[i] = 999;
        t->low[i] = 0;
    }
}

void j2k_geometry(Ctx *c, Comp *cp, int tx0, int ty0, int tx1, int ty1) {
    int resno, n = cp->numres;
    for (resno = 0; resno < n; resno++) {
        Res *r = &cp->res[resno];
        int level = n - 1 - resno, pdx = cp->prcw[resno],
            pdy = cp->prch[resno];
        int px0, py0, px1, py1, cbgx0, cbgy0, cbgw, cbgh, cbw, cbh, b;
        r->x0 = ceildivpow2(tx0, level);
        r->y0 = ceildivpow2(ty0, level);
        r->x1 = ceildivpow2(tx1, level);
        r->y1 = ceildivpow2(ty1, level);
        r->pdx = pdx;
        r->pdy = pdy;
        px0 = (r->x0 >> pdx) << pdx;
        py0 = (r->y0 >> pdy) << pdy;
        px1 = ceildivpow2(r->x1, pdx) << pdx;
        py1 = ceildivpow2(r->y1, pdy) << pdy;
        r->pw = r->x0 == r->x1 ? 0 : (px1 - px0) >> pdx;
        r->ph = r->y0 == r->y1 ? 0 : (py1 - py0) >> pdy;
        if (resno == 0) {
            cbgx0 = px0; cbgy0 = py0; cbgw = pdx; cbgh = pdy;
            r->nbands = 1;
        } else {
            cbgx0 = ceildivpow2(px0, 1); cbgy0 = ceildivpow2(py0, 1);
            cbgw = pdx - 1; cbgh = pdy - 1;
            r->nbands = 3;
        }
        cbw = imin(cp->cblkw, cbgw);
        cbh = imin(cp->cblkh, cbgh);
        for (b = 0; b < r->nbands; b++) {
            Band *band = &r->bands[b];
            int precno, np = r->pw * r->ph;
            if (resno == 0) {
                band->bandno = 0;
                band->x0 = r->x0; band->y0 = r->y0;
                band->x1 = r->x1; band->y1 = r->y1;
            } else {
                int xb, yb;
                band->bandno = b + 1;
                xb = band->bandno & 1;
                yb = band->bandno >> 1;
                band->x0 = ceildivpow2((int64_t)tx0 - ((int64_t)xb << level),
                                       level + 1);
                band->y0 = ceildivpow2((int64_t)ty0 - ((int64_t)yb << level),
                                       level + 1);
                band->x1 = ceildivpow2((int64_t)tx1 - ((int64_t)xb << level),
                                       level + 1);
                band->y1 = ceildivpow2((int64_t)ty1 - ((int64_t)yb << level),
                                       level + 1);
            }
            band->empty = band->x0 == band->x1 || band->y0 == band->y1;
            {
                int i = resno ? 3 * (resno - 1) + band->bandno : 0;
                int expn = cp->expn[i], mant = cp->mant[i];
                int gain = cp->qmfbid == 0 ? 0
                           : (band->bandno == 0 ? 0
                              : band->bandno == 3 ? 2 : 1);
                int e = cp->prec + gain - expn;
                double p = 1.0;
                int k;
                for (k = 0; k < (e < 0 ? -e : e); k++) p *= 2.0;
                if (e < 0) p = 1.0 / p;
                band->numbps = expn + cp->numgbits - 1;
                band->stepsize = (float)((1.0 + mant / 2048.0) * p);
            }
            if (band->empty) continue;
            band->precs = (Prec *)j2k_alloc(c, sizeof(Prec) * (size_t)np);
            for (precno = 0; precno < np; precno++) {
                Prec *pr = &band->precs[precno];
                int gx0 = cbgx0 + (precno % r->pw) * (1 << cbgw);
                int gy0 = cbgy0 + (precno / r->pw) * (1 << cbgh);
                int bx0, by0, bx1, by1, k;
                pr->x0 = imax(gx0, band->x0);
                pr->y0 = imax(gy0, band->y0);
                pr->x1 = imin(gx0 + (1 << cbgw), band->x1);
                pr->y1 = imin(gy0 + (1 << cbgh), band->y1);
                bx0 = (pr->x0 >> cbw) << cbw;
                by0 = (pr->y0 >> cbh) << cbh;
                bx1 = ceildivpow2(pr->x1, cbw) << cbw;
                by1 = ceildivpow2(pr->y1, cbh) << cbh;
                pr->cw = imax((bx1 - bx0) >> cbw, 0);
                pr->ch = imax((by1 - by0) >> cbh, 0);
                if (!pr->cw || !pr->ch) {
                    pr->cw = pr->ch = 0;
                    continue;
                }
                pr->cblks = (Cblk *)j2k_alloc(c, sizeof(Cblk)
                                          * (size_t)(pr->cw * pr->ch));
                for (k = 0; k < pr->cw * pr->ch; k++) {
                    Cblk *cb = &pr->cblks[k];
                    int cx0 = bx0 + (k % pr->cw) * (1 << cbw);
                    int cy0 = by0 + (k / pr->cw) * (1 << cbh);
                    cb->x0 = imax(cx0, pr->x0);
                    cb->y0 = imax(cy0, pr->y0);
                    cb->x1 = imin(cx0 + (1 << cbw), pr->x1);
                    cb->y1 = imin(cy0 + (1 << cbh), pr->y1);
                }
                j2k_tagtree_init(c, &pr->incl, pr->cw, pr->ch);
                j2k_tagtree_init(c, &pr->imsb, pr->cw, pr->ch);
            }
        }
    }
}

/* --- tier 2 ---------------------------------------------------------------- */

typedef struct {
    const uint8_t *data;
    long bp, end;
    unsigned buf, ct;
} Bio;

static void bio_bytein(Bio *b) {
    b->buf = (b->buf << 8) & 0xFFFF;
    b->ct = b->buf == 0xFF00 ? 7 : 8;
    if (b->bp < b->end) b->buf |= b->data[b->bp++];
}

static uint32_t bio_read(Bio *b, int n) {
    uint32_t v = 0;
    int i;
    for (i = n - 1; i >= 0; i--) {
        if (b->ct == 0) bio_bytein(b);
        b->ct--;
        v |= (uint32_t)((b->buf >> b->ct) & 1) << i;
    }
    return v;
}

static void bio_inalign(Bio *b) {
    if ((b->buf & 0xFF) == 0xFF) bio_bytein(b);
    b->ct = 0;
}

static int tagtree_decode(TagTree *t, Bio *b, int leaf, int threshold) {
    int stack[64], sp = 0, node = leaf, low = 0;
    while (t->parent[node] >= 0) {
        stack[sp++] = node;
        node = t->parent[node];
    }
    for (;;) {
        if (low > t->low[node]) t->low[node] = low;
        else low = t->low[node];
        while (low < threshold && low < t->value[node]) {
            if (bio_read(b, 1)) t->value[node] = low;
            else low++;
        }
        t->low[node] = low;
        if (!sp) break;
        node = stack[--sp];
    }
    return t->value[node] < threshold;
}

static int numpasses(Bio *b) {
    uint32_t n;
    if (!bio_read(b, 1)) return 1;
    if (!bio_read(b, 1)) return 2;
    if ((n = bio_read(b, 2)) != 3) return 3 + (int)n;
    if ((n = bio_read(b, 5)) != 31) return 6 + (int)n;
    return 37 + (int)bio_read(b, 7);
}

/* opj_t2_init_seg: 1 pass with TERMALL, 10 then 2 and 1 in turn with
 * BYPASS, else 109. */
static void init_seg(Ctx *c, Cblk *cb, int index, int cblksty) {
    int most = 109;
    if (index >= cb->nsegs) {
        int n = index + 10;
        Seg *s = (Seg *)j2k_alloc(c, sizeof(Seg) * (size_t)n);
        if (cb->nsegs) memcpy(s, cb->segs, sizeof(Seg) * (size_t)cb->nsegs);
        cb->segs = s;
        cb->nsegs = n;
    }
    if (cblksty & 0x04)
        most = 1;
    else if (cblksty & 0x01)
        most = index == 0 ? 10
               : (cb->segs[index - 1].maxpasses == 1
                  || cb->segs[index - 1].maxpasses == 10) ? 2 : 1;
    memset(&cb->segs[index], 0, sizeof(Seg));
    cb->segs[index].maxpasses = most;
}

static void append(Ctx *c, Cblk *cb, const uint8_t *p, long n) {
    if (cb->dlen + n > cb->dcap) {
        long cap = (cb->dlen + n) * 2 + 16;
        uint8_t *d = (uint8_t *)j2k_alloc(c, (size_t)cap);
        if (cb->dlen) memcpy(d, cb->data, (size_t)cb->dlen);
        cb->data = d;
        cb->dcap = cap;
    }
    if (n) memcpy(cb->data + cb->dlen, p, (size_t)n);
    cb->dlen += n;
}

static int floorlog2(int a) {
    int l = 0;
    while (a > 1) { a >>= 1; l++; }
    return l;
}

/* Past the EPH marker at pos when the COD asks for them (any other
 * bytes, or fewer than two, fail the tile). */
static long after_eph(Ctx *c, const uint8_t *buf, long pos, long end,
                      int csty) {
    if (!(csty & 4)) return pos;
    if (end - pos < 2 || buf[pos] != 0xFF || buf[pos + 1] != 0x92)
        j2k_fail(c, "packet header without its EPH marker");
    return pos + 2;
}

/* One packet at data[pos..end): its header there, or from hdr at *hpos
 * (PPM or PPT) when hpos is not NULL; returns the position after it. */
static long read_packet(Ctx *c, Comp *comps, int csty, int layno, int resno,
                        int compno, int precno, const uint8_t *data,
                        long pos, long end, const uint8_t *hdr, long hlen,
                        long *hpos) {
    Res *r = &comps[compno].res[resno];
    int cblksty = comps[compno].cblksty;
    Bio bio;
    int b, k;
    if (layno == 0) {
        for (b = 0; b < r->nbands; b++) {
            Prec *pr;
            if (r->bands[b].empty) continue;
            pr = &r->bands[b].precs[precno];
            if (!pr->cw) continue;
            j2k_tagtree_reset(&pr->incl);
            j2k_tagtree_reset(&pr->imsb);
            for (k = 0; k < pr->cw * pr->ch; k++) pr->cblks[k].numsegs = 0;
        }
    }
    if ((csty & 2) && end - pos >= 6 && data[pos] == 0xFF
            && data[pos + 1] == 0x91)
        pos += 6;
    if (hpos) {
        bio.data = hdr; bio.bp = *hpos; bio.end = hlen;
    } else {
        bio.data = data; bio.bp = pos; bio.end = end;
    }
    bio.buf = 0;
    bio.ct = 0;
    if (!bio_read(&bio, 1)) {
        bio_inalign(&bio);
        if (hpos)
            *hpos = after_eph(c, hdr, bio.bp, hlen, csty);
        else
            pos = after_eph(c, data, bio.bp, end, csty);
        return pos;
    }
    for (b = 0; b < r->nbands; b++) {
        Band *band = &r->bands[b];
        Prec *pr;
        if (band->empty) continue;
        pr = &band->precs[precno];
        for (k = 0; k < pr->cw * pr->ch; k++) {
            Cblk *cb = &pr->cblks[k];
            int included, segno, n;
            if (!cb->numsegs)
                included = tagtree_decode(&pr->incl, &bio, k, layno + 1);
            else
                included = (int)bio_read(&bio, 1);
            if (!included) {
                cb->numnewpasses = 0;
                continue;
            }
            if (!cb->numsegs) {
                int i = 0;
                while (!tagtree_decode(&pr->imsb, &bio, k, i)) i++;
                cb->numbps = band->numbps + 1 - i;
                cb->numlenbits = 3;
            }
            cb->numnewpasses = numpasses(&bio);
            while (bio_read(&bio, 1)) cb->numlenbits++;
            if (!cb->numsegs) {
                segno = 0;
                init_seg(c, cb, 0, cblksty);
            } else {
                segno = cb->numsegs - 1;
                if (cb->segs[segno].numpasses == cb->segs[segno].maxpasses) {
                    segno++;
                    init_seg(c, cb, segno, cblksty);
                }
            }
            n = cb->numnewpasses;
            for (;;) {
                Seg *s = &cb->segs[segno];
                int bits;
                s->numnewpasses = imin(s->maxpasses - s->numpasses, n);
                bits = cb->numlenbits + floorlog2(s->numnewpasses);
                if (bits > 32) j2k_fail(c, "packet header: invalid bit number");
                s->newlen = (int)bio_read(&bio, bits);
                n -= s->numnewpasses;
                if (n <= 0) break;
                segno++;
                init_seg(c, cb, segno, cblksty);
            }
        }
    }
    bio_inalign(&bio);
    if (hpos)
        *hpos = after_eph(c, hdr, bio.bp, hlen, csty);
    else
        pos = after_eph(c, data, bio.bp, end, csty);
    for (b = 0; b < r->nbands; b++) {
        Band *band = &r->bands[b];
        Prec *pr;
        if (band->empty) continue;
        pr = &band->precs[precno];
        for (k = 0; k < pr->cw * pr->ch; k++) {
            Cblk *cb = &pr->cblks[k];
            int segno;
            if (!cb->numnewpasses) continue;
            if (!cb->numsegs) {
                segno = 0;
                cb->numsegs = 1;
            } else {
                segno = cb->numsegs - 1;
                if (cb->segs[segno].numpasses == cb->segs[segno].maxpasses) {
                    segno++;
                    cb->numsegs++;
                }
            }
            for (;;) {
                Seg *s = &cb->segs[segno];
                if ((uint32_t)s->newlen > (uint32_t)(end - pos))
                    j2k_fail(c, "segment too long for its code-block");
                append(c, cb, data + pos, s->newlen);
                pos += (uint32_t)s->newlen;
                s->len += s->newlen;
                s->numpasses += s->numnewpasses;
                cb->numnewpasses -= s->numnewpasses;
                if (cb->numnewpasses <= 0) break;
                segno++;
                cb->numsegs++;
            }
        }
    }
    return pos;
}

/* Packet order (pi.c). */

typedef struct {
    Ctx *c;
    Comp *comps;
    int nc, max_res, max_prec, tx0, ty0, tx1, ty1;
    uint8_t *include;
    long include_size;
    int32_t *order;
    long norder, cap;
} Pi;

static void emit(Pi *pi, int l, int r, int c, int p) {
    long index = (((long)l * pi->max_res + r) * pi->nc + c) * pi->max_prec
                 + p;
    if (index >= pi->include_size || pi->include[index]) return;
    pi->include[index] = 1;
    if (pi->norder == pi->cap) {
        long cap = pi->cap * 2 + 64;
        int32_t *o = (int32_t *)j2k_alloc(pi->c, sizeof(int32_t) * 4
                                               * (size_t)cap);
        if (pi->norder) memcpy(o, pi->order, sizeof(int32_t) * 4
                                             * (size_t)pi->norder);
        pi->order = o;
        pi->cap = cap;
    }
    pi->order[4 * pi->norder] = l;
    pi->order[4 * pi->norder + 1] = r;
    pi->order[4 * pi->norder + 2] = c;
    pi->order[4 * pi->norder + 3] = p;
    pi->norder++;
}

static int64_t uceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

/* The precinct of position (x, y) at component c, resolution r, or -1. */
static int precinct_at(Pi *pi, int c, int r, int64_t x, int64_t y) {
    Comp *cp = &pi->comps[c];
    Res *res;
    int level, rpx, rpy;
    int64_t trx0, try0, trx1, try1, prci, prcj;
    if (r >= cp->numres) return -1;
    res = &cp->res[r];
    level = cp->numres - 1 - r;
    if (level >= 31) return -1;
    trx0 = uceildiv(pi->tx0, (int64_t)1 << level);
    try0 = uceildiv(pi->ty0, (int64_t)1 << level);
    trx1 = uceildiv(pi->tx1, (int64_t)1 << level);
    try1 = uceildiv(pi->ty1, (int64_t)1 << level);
    rpx = res->pdx + level;
    rpy = res->pdy + level;
    if (!(y % ((int64_t)1 << rpy) == 0
          || (y == pi->ty0 && ((try0 << level) % ((int64_t)1 << rpy)))))
        return -1;
    if (!(x % ((int64_t)1 << rpx) == 0
          || (x == pi->tx0 && ((trx0 << level) % ((int64_t)1 << rpx)))))
        return -1;
    if (res->pw == 0 || res->ph == 0 || trx0 == trx1 || try0 == try1)
        return -1;
    prci = (uceildiv(x, (int64_t)1 << level) >> res->pdx)
           - (trx0 >> res->pdx);
    prcj = (uceildiv(y, (int64_t)1 << level) >> res->pdy)
           - (try0 >> res->pdy);
    return (int)(prci + prcj * res->pw);
}

static void steps(Pi *pi, int c0, int c1, int64_t *dx, int64_t *dy) {
    int c, r;
    *dx = *dy = 0;
    for (c = c0; c < c1; c++) {
        int n = pi->comps[c].numres;
        for (r = 0; r < n; r++) {
            int ex = pi->comps[c].res[r].pdx + n - 1 - r;
            int ey = pi->comps[c].res[r].pdy + n - 1 - r;
            if (ex < 32) {
                int64_t v = (int64_t)1 << ex;
                *dx = !*dx ? v : (v < *dx ? v : *dx);
            }
            if (ey < 32) {
                int64_t v = (int64_t)1 << ey;
                *dy = !*dy ? v : (v < *dy ? v : *dy);
            }
        }
    }
}

static void positions_layers(Pi *pi, int c, int r, int64_t x, int64_t y,
                             int l0, int l1) {
    int p = precinct_at(pi, c, r, x, y), l;
    if (p < 0) return;
    for (l = l0; l < l1; l++) emit(pi, l, r, c, p);
}

static void poc_order(Pi *pi, int r0, int c0, int l0, int l1, int r1, int c1,
                      int prg) {
    int l, r, c, p;
    int64_t x, y, dx, dy;
    if (c0 >= pi->nc || c1 >= pi->nc + 1) return;
    if (prg == 0 || prg == 1) {
        int a0 = prg == 0 ? l0 : r0, a1 = prg == 0 ? l1 : r1;
        int b0 = prg == 0 ? r0 : l0, b1 = prg == 0 ? r1 : l1, a, b;
        for (a = a0; a < a1; a++)
            for (b = b0; b < b1; b++) {
                l = prg == 0 ? a : b;
                r = prg == 0 ? b : a;
                for (c = c0; c < c1; c++) {
                    Res *res;
                    if (r >= pi->comps[c].numres) continue;
                    res = &pi->comps[c].res[r];
                    for (p = 0; p < res->pw * res->ph; p++)
                        emit(pi, l, r, c, p);
                }
            }
    } else if (prg == 2 || prg == 3) {
        steps(pi, 0, pi->nc, &dx, &dy);
        if (!dx || !dy) return;
        if (prg == 2) {
            for (r = r0; r < r1; r++)
                for (y = pi->ty0; y < pi->ty1; y += dy - y % dy)
                    for (x = pi->tx0; x < pi->tx1; x += dx - x % dx)
                        for (c = c0; c < c1; c++)
                            positions_layers(pi, c, r, x, y, l0, l1);
        } else {
            for (y = pi->ty0; y < pi->ty1; y += dy - y % dy)
                for (x = pi->tx0; x < pi->tx1; x += dx - x % dx)
                    for (c = c0; c < c1; c++)
                        for (r = r0; r < imin(r1, pi->comps[c].numres); r++)
                            positions_layers(pi, c, r, x, y, l0, l1);
        }
    } else if (prg == 4) {
        for (c = c0; c < c1; c++) {
            steps(pi, c, c + 1, &dx, &dy);
            if (!dx || !dy) return;
            for (y = pi->ty0; y < pi->ty1; y += dy - y % dy)
                for (x = pi->tx0; x < pi->tx1; x += dx - x % dx)
                    for (r = r0; r < imin(r1, pi->comps[c].numres); r++)
                        positions_layers(pi, c, r, x, y, l0, l1);
        }
    }
}

/* --- tier 1 ---------------------------------------------------------------- */

const uint16_t J2K_QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801,
    0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801,
    0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601,
    0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005,
    0x0001, 0x5601};
const uint8_t J2K_NMPS[47] = {
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t J2K_NLPS[47] = {
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17,
    18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t J2K_SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0,
                                   1};

typedef struct {
    const uint8_t *buf;  /* the segment, then 0xFF 0xFF */
    long bp;
    uint32_t c, a;
    int ct;
    uint8_t st[19], mps[19];
} Mq;

static void mq_bytein(Mq *m) {
    if (m->buf[m->bp] == 0xFF) {
        if (m->buf[m->bp + 1] > 0x8F) {
            m->c += 0xFF00;
            m->ct = 8;
        } else {
            m->bp++;
            m->c += (uint32_t)m->buf[m->bp] << 9;
            m->ct = 7;
        }
    } else {
        m->bp++;
        m->c += (uint32_t)m->buf[m->bp] << 8;
        m->ct = 8;
    }
}

static void mq_raw_init(Mq *m, const uint8_t *buf) {
    m->buf = buf;
    m->bp = 0;
    m->c = 0;
    m->ct = 0;
}

static int mq_raw(Mq *m) {
    if (m->ct == 0) {
        if (m->c == 0xFF) {
            if (m->buf[m->bp] > 0x8F) {
                m->c = 0xFF;
                m->ct = 8;
            } else {
                m->c = m->buf[m->bp++];
                m->ct = 7;
            }
        } else {
            m->c = m->buf[m->bp++];
            m->ct = 8;
        }
    }
    m->ct--;
    return (int)((m->c >> m->ct) & 1);
}

static void mq_init(Mq *m, const uint8_t *buf, long len) {
    m->buf = buf;
    m->bp = 0;
    m->c = (uint32_t)(len ? buf[0] : 0xFF) << 16;
    mq_bytein(m);
    m->c <<= 7;
    m->ct -= 7;
    m->a = 0x8000;
}

static int mq_decode(Mq *m, int cx) {
    int s = m->st[cx], d;
    uint32_t q = J2K_QE[s];
    uint32_t a = m->a - q;
    if ((m->c >> 16) < q) {
        if (a < q) {
            d = m->mps[cx];
            m->st[cx] = J2K_NMPS[s];
        } else {
            d = 1 - m->mps[cx];
            if (J2K_SWITCH[s]) m->mps[cx] = (uint8_t)d;
            m->st[cx] = J2K_NLPS[s];
        }
        a = q;
    } else {
        m->c -= q << 16;
        if (a & 0x8000) {
            m->a = a;
            return m->mps[cx];
        }
        if (a < q) {
            d = 1 - m->mps[cx];
            if (J2K_SWITCH[s]) m->mps[cx] = (uint8_t)d;
            m->st[cx] = J2K_NLPS[s];
        } else {
            d = m->mps[cx];
            m->st[cx] = J2K_NMPS[s];
        }
    }
    do {
        if (m->ct == 0) mq_bytein(m);
        a <<= 1;
        m->c <<= 1;
        m->ct--;
    } while (a < 0x8000);
    m->a = a;
    return d;
}

int j2k_zc_context(int orient, int h, int v, int d) {
    if (orient == 1) { int t = h; h = v; v = t; }
    if (orient == 3) {
        int hv = h + v;
        if (d == 0) return imin(hv, 2);
        if (d == 1) return 3 + imin(hv, 2);
        if (d == 2) return hv == 0 ? 6 : 7;
        return 8;
    }
    if (h == 0) {
        if (v == 0) return imin(d, 2);
        return v == 1 ? 3 : 4;
    }
    if (h == 1) return v == 0 ? (d == 0 ? 5 : 6) : 7;
    return 8;
}

typedef struct {
    int w, h, W;
    uint8_t *sig, *neg, *vis, *ref, *below;
    int32_t *val;
} T1;

static int clamp1(int v) { return v > 0 ? 1 : (v < 0 ? -1 : 0); }

static void t1_sign(T1 *t, Mq *m, int p, int32_t oph) {
    int W = t->W, hc, vc, ctx, xr, v;
    hc = clamp1((t->sig[p - 1] ? (t->neg[p - 1] ? -1 : 1) : 0)
                + (t->sig[p + 1] ? (t->neg[p + 1] ? -1 : 1) : 0));
    vc = clamp1((t->sig[p - W] ? (t->neg[p - W] ? -1 : 1) : 0)
                + (t->below[p] && t->sig[p + W] ? (t->neg[p + W] ? -1 : 1)
                   : 0));
    if (hc == 0) {
        ctx = vc == 0 ? 9 : 10;
        xr = vc < 0;
    } else {
        ctx = vc == 0 ? 12 : (vc == hc ? 13 : 11);
        xr = hc < 0;
    }
    v = mq_decode(m, ctx) ^ xr;
    t->val[p] = v ? -oph : oph;
    t->sig[p] = 1;
    t->neg[p] = (uint8_t)v;
}

static void t1_nbrs(T1 *t, int p, int *h, int *v, int *d) {
    int W = t->W;
    const uint8_t *s = t->sig;
    int b = t->below[p];
    *h = s[p - 1] + s[p + 1];
    *v = s[p - W] + b * s[p + W];
    *d = s[p - W - 1] + s[p - W + 1] + b * (s[p + W - 1] + s[p + W + 1]);
}

static void reset_contexts(Mq *m) {
    memset(m->st, 0, sizeof m->st);
    memset(m->mps, 0, sizeof m->mps);
    m->st[18] = 46;
    m->st[17] = 3;
    m->st[0] = 4;
}

static void t1_decode(Ctx *c, T1 *t, Cblk *cb, int bpno, int orient,
                      int cblksty) {
    int W = t->W, passtype = 2, segno;
    int lazy = cblksty & 0x01, reset = cblksty & 0x02,
        segsym = cblksty & 0x20;
    long at = 0;
    uint8_t zc[75];
    Mq m;
    {
        int h, v, d;
        for (h = 0; h < 3; h++)
            for (v = 0; v < 3; v++)
                for (d = 0; d < 5; d++)
                    zc[h * 15 + v * 5 + d] = (uint8_t)j2k_zc_context(orient, h,
                                                                 v, d);
    }
    memset(&m, 0, sizeof m);
    m.a = 0x8000;
    reset_contexts(&m);
    for (segno = 0; segno < cb->numsegs; segno++) {
        Seg *s = &cb->segs[segno];
        uint8_t *buf = (uint8_t *)j2k_alloc(c, (size_t)s->len + 2);
        int passno, raw = lazy && bpno <= cb->numbps - 4 && passtype < 2;
        memcpy(buf, cb->data + at, (size_t)s->len);
        buf[s->len] = buf[s->len + 1] = 0xFF;
        at += s->len;
        if (raw)
            mq_raw_init(&m, buf);
        else
            mq_init(&m, buf, s->len);
        for (passno = 0; passno < s->numpasses && bpno >= 1; passno++) {
            int32_t one = (int32_t)1 << bpno, oph = one | (one >> 1);
            int y0, x, p;
            for (y0 = 0; y0 < t->h; y0 += 4) {
                int y1 = imin(y0 + 4, t->h);
                for (x = 0; x < t->w; x++) {
                    int col = (y0 + 1) * W + x + 1, end = col + (y1 - y0) * W;
                    int hh, vv, dd;
                    if (passtype == 0) {
                        for (p = col; p < end; p += W) {
                            if (t->sig[p] || t->vis[p]) continue;
                            t1_nbrs(t, p, &hh, &vv, &dd);
                            if (!(hh || vv || dd)) continue;
                            if (raw) {
                                if (mq_raw(&m)) {
                                    int v = mq_raw(&m);
                                    t->val[p] = v ? -oph : oph;
                                    t->sig[p] = 1;
                                    t->neg[p] = (uint8_t)v;
                                }
                            } else if (mq_decode(&m,
                                                 zc[hh * 15 + vv * 5 + dd])) {
                                t1_sign(t, &m, p, oph);
                            }
                            t->vis[p] = 1;
                        }
                    } else if (passtype == 1) {
                        int32_t half = one >> 1;
                        for (p = col; p < end; p += W) {
                            int ctx, v;
                            if (!t->sig[p] || t->vis[p]) continue;
                            if (raw) {
                                v = mq_raw(&m);
                            } else {
                                if (t->ref[p]) {
                                    ctx = 16;
                                } else {
                                    t1_nbrs(t, p, &hh, &vv, &dd);
                                    ctx = (hh || vv || dd) ? 15 : 14;
                                }
                                v = mq_decode(&m, ctx);
                            }
                            t->val[p] += (v ^ (t->val[p] < 0)) ? half : -half;
                            t->ref[p] = 1;
                        }
                    } else {
                        int start = col;
                        if (y1 - y0 == 4) {
                            int run = 1;
                            for (p = col; p < end; p += W) {
                                t1_nbrs(t, p, &hh, &vv, &dd);
                                if (t->sig[p] || t->vis[p] || hh || vv || dd) {
                                    run = 0;
                                    break;
                                }
                            }
                            if (run) {
                                int r;
                                if (!mq_decode(&m, 17)) continue;
                                r = mq_decode(&m, 18) << 1;
                                r |= mq_decode(&m, 18);
                                t1_sign(t, &m, col + r * W, oph);
                                start = col + (r + 1) * W;
                            }
                        }
                        for (p = start; p < end; p += W) {
                            if (t->sig[p] || t->vis[p]) continue;
                            t1_nbrs(t, p, &hh, &vv, &dd);
                            if (mq_decode(&m, zc[hh * 15 + vv * 5 + dd]))
                                t1_sign(t, &m, p, oph);
                        }
                    }
                }
            }
            if (passtype == 2) {
                memset(t->vis, 0, (size_t)(W * (t->h + 2)));
                if (segsym) {
                    int k;
                    for (k = 0; k < 4; k++) mq_decode(&m, 18);
                }
            }
            if (reset && !raw) reset_contexts(&m);
            if (++passtype == 3) {
                passtype = 0;
                bpno--;
            }
        }
    }
}

/* --- the inverse transforms ------------------------------------------------- */

static void idwt53(int64_t *x, int64_t *tmp, int sn, int dn, int cas) {
    int n = sn + dn, i;
    const int64_t *lo = x, *hi = x + sn;
    if (cas == 0) {
        if (n == 1) return;
        for (i = 0; i < sn; i++)
            tmp[2 * i] = lo[i] - ((hi[imax(imin(i - 1, dn - 1), 0)]
                                   + hi[imax(imin(i, dn - 1), 0)] + 2) >> 2);
        for (i = 0; i < dn; i++)
            tmp[2 * i + 1] = hi[i] + ((tmp[2 * i]
                                       + tmp[2 * imin(i + 1, sn - 1)]) >> 1);
    } else {
        if (n == 1) {
            x[0] = x[0] / 2;
            return;
        }
        for (i = 0; i < sn; i++)
            tmp[2 * i + 1] = lo[i] - ((hi[i] + hi[imin(i + 1, dn - 1)] + 2)
                                      >> 2);
        for (i = 0; i < dn; i++)
            tmp[2 * i] = hi[i] + ((tmp[2 * imax(imin(i - 1, sn - 1), 0) + 1]
                                   + tmp[2 * imin(i, sn - 1) + 1]) >> 1);
    }
    memcpy(x, tmp, sizeof(int64_t) * (size_t)n);
}

static const float K97 = 1.230174105f, TWO_INVK = 1.625732422f;
static const float LIFT97[4] = {-0.443506852f, -0.882911075f, 0.052980118f,
                                1.586134342f};

static void idwt97(float *x, float *tmp, int sn, int dn, int cas) {
    int i, step;
    float *L = tmp, *H = tmp + sn;
    if ((cas == 0 && !(dn > 0 || sn > 1)) || (cas == 1 && !(sn > 0 || dn > 1)))
        return;  /* left as it is: low band first, high band after */
    for (i = 0; i < sn; i++) L[i] = x[i] * K97;
    for (i = 0; i < dn; i++) H[i] = x[sn + i] * TWO_INVK;
    for (step = 0; step < 4; step++) {
        float c = LIFT97[step], c2 = c + c;
        int m;
        if (step % 2 == 0) {
            if (cas == 0) {
                m = imin(sn, dn);
                for (i = m - 1; i >= 0; i--)
                    L[i] = L[i] + ((H[i ? i - 1 : 0] + H[i]) * c);
                if (m < sn) L[m] = L[m] + H[m - 1] * c2;
            } else {
                m = imin(sn, dn - 1);
                for (i = 0; i < m; i++) L[i] = L[i] + ((H[i] + H[i + 1]) * c);
                if (m < sn) L[m] = L[m] + H[m] * c2;
            }
        } else {
            if (cas == 0) {
                m = imin(dn, sn - 1);
                for (i = 0; i < m; i++) H[i] = H[i] + ((L[i] + L[i + 1]) * c);
                if (m < dn) H[m] = H[m] + L[m] * c2;
            } else {
                m = imin(dn, sn);
                for (i = m - 1; i >= 0; i--)
                    H[i] = H[i] + ((L[i ? i - 1 : 0] + L[i]) * c);
                if (m < dn) H[m] = H[m] + L[m - 1] * c2;
            }
        }
    }
    for (i = 0; i < sn; i++) x[2 * i + cas] = L[i];
    for (i = 0; i < dn; i++) x[2 * i + 1 - cas] = H[i];
}

static void inverse_dwt(Ctx *c, Comp *cp, int32_t *plane, int tw,
                        int numres) {
    int r, i, j, maxn = 0;
    int64_t *line, *tmp;
    float *fline, *ftmp;
    if (numres == 1 || tw == 0) return;
    for (r = 0; r < cp->numres; r++) {
        maxn = imax(maxn, cp->res[r].x1 - cp->res[r].x0);
        maxn = imax(maxn, cp->res[r].y1 - cp->res[r].y0);
    }
    line = (int64_t *)j2k_alloc(c, sizeof(int64_t) * (size_t)(maxn + 1));
    tmp = (int64_t *)j2k_alloc(c, sizeof(int64_t) * (size_t)(maxn + 1));
    fline = (float *)j2k_alloc(c, sizeof(float) * (size_t)(maxn + 1));
    ftmp = (float *)j2k_alloc(c, sizeof(float) * (size_t)(maxn + 1));
    for (r = 1; r < numres; r++) {
        Res *lo = &cp->res[r - 1], *cur = &cp->res[r];
        int sw = lo->x1 - lo->x0, sh = lo->y1 - lo->y0;
        int rw = cur->x1 - cur->x0, rh = cur->y1 - cur->y0;
        int cx = cur->x0 & 1, cy = cur->y0 & 1;
        if (!rw || !rh) continue;
        for (j = 0; j < rh; j++) {
            int32_t *row = plane + (long)j * tw;
            if (cp->qmfbid == 1) {
                for (i = 0; i < rw; i++) line[i] = row[i];
                idwt53(line, tmp, sw, rw - sw, cx);
                for (i = 0; i < rw; i++) row[i] = (int32_t)line[i];
            } else {
                float *f = (float *)row;
                for (i = 0; i < rw; i++) fline[i] = f[i];
                idwt97(fline, ftmp, sw, rw - sw, cx);
                for (i = 0; i < rw; i++) f[i] = fline[i];
            }
        }
        for (i = 0; i < rw; i++) {
            if (cp->qmfbid == 1) {
                for (j = 0; j < rh; j++) line[j] = plane[(long)j * tw + i];
                idwt53(line, tmp, sh, rh - sh, cy);
                for (j = 0; j < rh; j++)
                    plane[(long)j * tw + i] = (int32_t)line[j];
            } else {
                float *f = (float *)plane;
                for (j = 0; j < rh; j++) fline[j] = f[(long)j * tw + i];
                idwt97(fline, ftmp, sh, rh - sh, cy);
                for (j = 0; j < rh; j++) f[(long)j * tw + i] = fline[j];
            }
        }
    }
}

/* lrintf, half to even, without libm: exact in double below 2^51. */
static int64_t round_even(float f) {
    volatile double d = (double)f + 6755399441055744.0;
    return (int64_t)(d - 6755399441055744.0);
}

/* --- the tile --------------------------------------------------------------- */

static void cblk_to_plane(Ctx *c, Comp *cp, Band *band, Cblk *cb,
                          int32_t *plane, int tw, int ox, int oy) {
    int w = cb->x1 - cb->x0, h = cb->y1 - cb->y0, x, y;
    int64_t bpno64 = (int64_t)cp->roishift + cb->numbps;
    int bpno = (int)(int32_t)(uint32_t)(bpno64 & 0xFFFFFFFF);
    T1 t;
    if (w <= 0 || h <= 0) return;
    if (bpno >= 31) j2k_fail(c, "code-block of 31 bit-planes or more");
    t.w = w; t.h = h; t.W = w + 2;
    t.sig = (uint8_t *)j2k_alloc(c, (size_t)(t.W * (h + 2)));
    t.neg = (uint8_t *)j2k_alloc(c, (size_t)(t.W * (h + 2)));
    t.vis = (uint8_t *)j2k_alloc(c, (size_t)(t.W * (h + 2)));
    t.ref = (uint8_t *)j2k_alloc(c, (size_t)(t.W * (h + 2)));
    t.val = (int32_t *)j2k_alloc(c, sizeof(int32_t) * (size_t)(t.W * (h + 2)));
    t.below = (uint8_t *)j2k_alloc(c, (size_t)(t.W * (h + 2)));
    for (y = 0; y < t.W * (h + 2); y++)
        t.below[y] = !((cp->cblksty & 0x08) && (y / t.W - 1) % 4 == 3);
    if (cb->dlen || cb->numsegs)
        t1_decode(c, &t, cb, bpno, band->bandno, cp->cblksty);
    for (y = 0; y < h; y++)
        for (x = 0; x < w; x++) {
            int32_t v = t.val[(y + 1) * t.W + x + 1];
            long at = (long)(cb->y0 - band->y0 + oy + y) * tw
                      + (cb->x0 - band->x0 + ox + x);
            if (cp->roishift) {
                if (cp->roishift >= 31) {
                    v = 0;
                } else {
                    int32_t mag = v < 0 ? -v : v;
                    if (mag >= ((int32_t)1 << cp->roishift)) {
                        mag >>= cp->roishift;
                        v = v < 0 ? -mag : mag;
                    }
                }
            }
            if (cp->qmfbid == 1)
                plane[at] = v / 2;
            else
                ((float *)plane)[at] = (float)v * (0.5f * band->stepsize);
        }
}

int j2k_decode_tile(const int32_t *plan, const uint8_t *data, long len,
                    const uint8_t *hdr, long hlen, long *hpos,
                    int32_t *out, int32_t *resno_out, char *err,
                    int errlen) {
    Ctx c;
    Pi pi;
    Comp *comps;
    int tx0 = plan[0], ty0 = plan[1], tx1 = plan[2], ty1 = plan[3];
    int nc = plan[4], prg = plan[5], numlayers = plan[6], mct = plan[7];
    int csty = plan[8], npocs = plan[9], tw = tx1 - tx0, th = ty1 - ty0;
    int rc, i, k, b;
    long pos = 0, n;
    c.blocks = NULL;
    c.err = err;
    c.errlen = errlen;
    if ((rc = setjmp(c.jump)) != 0) {
        while (c.blocks) {
            Block *next = c.blocks->next;
            free(c.blocks);
            c.blocks = next;
        }
        return rc;
    }
    if (!npocs && prg < 0) j2k_fail(&c, "unknown progression order");
    comps = (Comp *)j2k_alloc(&c, sizeof(Comp) * (size_t)nc);
    for (i = 0; i < nc; i++) {
        const int32_t *q = plan + PLAN_HEAD + PLAN_POC * MAX_POCS
                           + (long)i * COMP_INTS;
        Comp *cp = &comps[i];
        cp->prec = q[0]; cp->sgnd = q[1]; cp->numres = q[2];
        cp->cblkw = q[3]; cp->cblkh = q[4]; cp->cblksty = q[5];
        cp->qmfbid = q[6]; cp->numgbits = q[7]; cp->roishift = q[8];
        cp->prcw = q + 9;
        cp->prch = q + 9 + MAXRLVLS;
        cp->expn = q + 9 + 2 * MAXRLVLS;
        cp->mant = q + 9 + 2 * MAXRLVLS + MAXBANDS;
        j2k_geometry(&c, cp, tx0, ty0, tx1, ty1);
    }
    memset(&pi, 0, sizeof pi);
    pi.c = &c;
    pi.comps = comps;
    pi.nc = nc;
    pi.tx0 = tx0; pi.ty0 = ty0; pi.tx1 = tx1; pi.ty1 = ty1;
    for (i = 0; i < nc; i++) {
        pi.max_res = imax(pi.max_res, comps[i].numres);
        for (k = 0; k < comps[i].numres; k++)
            pi.max_prec = imax(pi.max_prec,
                               comps[i].res[k].pw * comps[i].res[k].ph);
    }
    pi.include_size = (long)(numlayers + 1) * pi.max_res * nc * pi.max_prec;
    pi.include = (uint8_t *)j2k_alloc(&c, (size_t)pi.include_size);
    if (!npocs) {
        poc_order(&pi, 0, 0, 0, numlayers, pi.max_res, nc, prg);
    } else {
        for (i = 0; i < npocs; i++) {
            const int32_t *q = plan + PLAN_HEAD + PLAN_POC * i;
            poc_order(&pi, q[0], q[1], 0, imin(q[2], numlayers), q[3], q[4],
                      q[5]);
        }
    }
    for (n = 0; n < pi.norder; n++) {
        const int32_t *o = pi.order + 4 * n;
        pos = read_packet(&c, comps, csty, o[0], o[1], o[2], o[3], data, pos,
                          len, hdr, hlen, *hpos >= 0 ? hpos : NULL);
        if (o[1] > resno_out[o[2]]) resno_out[o[2]] = o[1];
    }
    for (i = 0; i < nc; i++) {
        Comp *cp = &comps[i];
        int32_t *plane = out + (long)i * tw * th;
        int r;
        memset(plane, 0, sizeof(int32_t) * (size_t)tw * (size_t)th);
        for (r = 0; r < cp->numres; r++) {
            Res *res = &cp->res[r];
            for (b = 0; b < res->nbands; b++) {
                Band *band = &res->bands[b];
                int ox = 0, oy = 0, p;
                if (band->empty) continue;
                if (band->bandno & 1) ox = cp->res[r - 1].x1 - cp->res[r - 1].x0;
                if (band->bandno & 2) oy = cp->res[r - 1].y1 - cp->res[r - 1].y0;
                for (p = 0; p < res->pw * res->ph; p++) {
                    Prec *pr = &band->precs[p];
                    for (k = 0; k < pr->cw * pr->ch; k++)
                        cblk_to_plane(&c, cp, band, &pr->cblks[k], plane, tw,
                                      ox, oy);
                }
            }
        }
    }
    for (i = 0; i < nc; i++)
        inverse_dwt(&c, &comps[i], out + (long)i * tw * th, tw,
                    imin(resno_out[i] + 1, comps[i].numres));
    n = (long)tw * th;
    if (mct && nc >= 3) {
        int32_t *p0 = out, *p1 = out + n, *p2 = out + 2 * n;
        long j;
        if (comps[0].qmfbid == 1) {
            for (j = 0; j < n; j++) {
                int64_t y = p0[j], u = p1[j], v = p2[j];
                int64_t g = y - ((u + v) >> 2);
                p0[j] = (int32_t)(v + g);
                p1[j] = (int32_t)g;
                p2[j] = (int32_t)(u + g);
            }
        } else {
            float *f0 = (float *)p0, *f1 = (float *)p1, *f2 = (float *)p2;
            for (j = 0; j < n; j++) {
                float y = f0[j], u = f1[j], v = f2[j];
                float r = y + (v * 1.402f);
                float g = (y - (u * 0.34413f)) - (v * 0.71414f);
                float bb = y + (u * 1.772f);
                f0[j] = r;
                f1[j] = g;
                f2[j] = bb;
            }
        }
    }
    for (i = 0; i < nc; i++) {
        Comp *cp = &comps[i];
        Res *res = &cp->res[imin(resno_out[i], cp->numres - 1)];
        int rw = res->x1 - res->x0, rh = res->y1 - res->y0, x, y;
        int64_t shift = cp->sgnd ? 0 : (int64_t)1 << (cp->prec - 1);
        int64_t lo = cp->sgnd ? -((int64_t)1 << (cp->prec - 1)) : 0;
        int64_t hi = cp->sgnd ? ((int64_t)1 << (cp->prec - 1)) - 1
                              : ((int64_t)1 << cp->prec) - 1;
        for (y = 0; y < rh; y++) for (x = 0; x < rw; x++) {
            long j = (long)y * tw + x;
            int32_t *p = out + (long)i * n;
            int64_t v;
            if (cp->qmfbid == 1) {
                v = (int64_t)p[j] + shift;
            } else {
                float f = ((float *)p)[j];
                if (f > 2147483648.0f) v = hi;
                else if (f < -2147483648.0f || f != f) v = lo;
                else v = round_even(f) + shift;
            }
            p[j] = (int32_t)(v < lo ? lo : (v > hi ? hi : v));
        }
    }
    while (c.blocks) {
        Block *next = c.blocks->next;
        free(c.blocks);
        c.blocks = next;
    }
    return 0;
}
