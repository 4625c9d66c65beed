/* What the host JPEG 2000 decoder (jpeg2000.c) shares with the writer
 * (jpeg2000_write.c), both built into one library: the allocation
 * context, the tile geometry of opj_tcd_init_tile with its tag trees, and
 * the MQ coder's state table and zero-coding contexts.
 */

#ifndef JPEG2000_H
#define JPEG2000_H

#include <setjmp.h>
#include <stddef.h>
#include <stdint.h>

#define MAXRLVLS 33
#define MAXBANDS (3 * MAXRLVLS - 2)
#define MAX_POCS 32

typedef struct Block { struct Block *next; } Block;

typedef struct {
    jmp_buf jump;
    Block *blocks;
    char *err;
    int errlen;
} Ctx;

void j2k_fail(Ctx *c, const char *msg);
void *j2k_alloc(Ctx *c, size_t n);

static inline int ceildivpow2(int64_t a, int b) { return (int)-((-a) >> b); }
static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }

typedef struct { int maxpasses, numpasses, len, newlen, numnewpasses; } Seg;

typedef struct {
    int x0, y0, x1, y1;
    int numbps, numlenbits, numsegs, numnewpasses;
    int nsegs;
    Seg *segs;
    uint8_t *data;
    long dlen, dcap;
} Cblk;

typedef struct {
    int n;
    int *parent, *value, *low;
} TagTree;

typedef struct {
    int x0, y0, x1, y1, cw, ch;
    Cblk *cblks;
    TagTree incl, imsb;
} Prec;

typedef struct {
    int bandno, x0, y0, x1, y1, empty, numbps;
    float stepsize;
    Prec *precs;
} Band;

typedef struct {
    int x0, y0, x1, y1, pdx, pdy, pw, ph, nbands;
    Band bands[3];
} Res;

typedef struct {
    int prec, sgnd, numres, cblkw, cblkh, cblksty, qmfbid, numgbits,
        roishift;
    const int32_t *prcw, *prch, *expn, *mant;
    Res res[MAXRLVLS];
} Comp;

void j2k_tagtree_init(Ctx *c, TagTree *t, int w, int h);
void j2k_tagtree_reset(TagTree *t);
void j2k_geometry(Ctx *c, Comp *cp, int tx0, int ty0, int tx1, int ty1);

/* The MQ coder's states (Table C.2): Qe, the next state after an MPS and
 * after an LPS, and whether an LPS switches the MPS. */
extern const uint16_t J2K_QE[47];
extern const uint8_t J2K_NMPS[47], J2K_NLPS[47], J2K_SWITCH[47];

int j2k_zc_context(int orient, int h, int v, int d);

#endif
