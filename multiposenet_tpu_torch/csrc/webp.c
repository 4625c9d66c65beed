/* Host WebP codec of the port, in plain C99 with no library: the two
 * bitstreams of WebP as libwebp 1.6 decodes them under OpenCV 5.0, and a
 * lossless writer. The RIFF container, the demuxer's checks and the Exif
 * orientation are Python (utils/webp.py); the plain versions of what is
 * here are utils/vp8l.py and utils/vp8.py, which these functions match
 * pixel for pixel (and byte for byte for the writer).
 *
 * vp8l_decode reads a VP8L stream (src/dec/vp8l_dec.c) to ARGB words:
 * transforms (predictor with its 14 modes, cross-colour, subtract-green,
 * colour indexing with pixel bundling) undone in reverse order, the
 * colour cache, meta prefix codes, simple and normal prefix codes with
 * the code-length code, LZ77 with the 120-entry distance map. With
 * `headerless` it reads the stream of an ALPH chunk at a given size.
 * What libwebp rejects is refused with a message: prefix codes that are
 * over-subscribed, incomplete or empty, code-length runs past their
 * alphabet, a transform given twice, a colour cache of 0 or more than 11
 * bits, copies that leave the image, and bits read past the data (at
 * least 8 bytes' worth, libwebp's 64-bit window).
 *
 * vp8_decode reads one VP8 key frame (RFC 6386, as src/dec/vp8_dec.c,
 * tree_dec.c, quant_dec.c and frame_dec.c do) and converts it to RGB as
 * libwebp's fancy upsampler (UpsampleRgbLinePair) and its 14-bit
 * VP8YUVToR/G/B do: prediction from unfiltered neighbours (127 above and
 * 129 left of the frame), int16 coefficients, the inverse WHT and DCT,
 * the simple or normal loop filter over the whole frame in macroblock
 * order. The boolean decoder is libwebp's own, so corrupt streams decode
 * or fail as under cv2; a partition read past its end (libwebp's eof_)
 * is refused. Each block takes the inverse transform libwebp picks for
 * it on x86 (Transform_SSE2 in 16-bit lanes, or the integer AC3 and DC
 * ones), which differ only where a corrupt stream's sums wrap.
 *
 * vp8l_encode writes uint8 RGB as a VP8L stream: a predictor transform
 * (one mode per 16x16 tile, the smallest residual entropy in integer Q16
 * arithmetic) after subtract-green or not, whichever is shorter, or
 * colour indexing for 256 colours or fewer unless the predicted stream
 * is shorter; greedy LZ77 over a hash
 * chain; one group of canonical prefix codes of at most 15 bits. Its
 * bytes are utils/vp8l.py encode's, not libwebp's (see there).
 *
 * Entry points return 0, 1 with a message in err for a stream refused,
 * 2 when out of memory.
 */

#include <setjmp.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* --- errors and memory ---------------------------------------------------- */

typedef struct {
    jmp_buf jump;
    char *err;
    int errlen;
    void **blocks;
    int nblocks, cap;
} Ctx;

static void fail(Ctx *c, const char *msg)
{
    if (c->err && c->errlen > 0) snprintf(c->err, (size_t)c->errlen, "%s", msg);
    longjmp(c->jump, 1);
}

static void *alloc(Ctx *c, size_t n)
{
    void *p;
    if (c->nblocks == c->cap) {
        int cap = c->cap ? 2 * c->cap : 64;
        void **b = (void **)realloc(c->blocks, (size_t)cap * sizeof(*b));
        if (!b) longjmp(c->jump, 2);
        c->blocks = b;
        c->cap = cap;
    }
    p = calloc(n ? n : 1, 1);
    if (!p) longjmp(c->jump, 2);
    c->blocks[c->nblocks++] = p;
    return p;
}

static void release(Ctx *c)
{
    int i;
    for (i = 0; i < c->nblocks; i++) free(c->blocks[i]);
    free(c->blocks);
    c->blocks = NULL;
    c->nblocks = c->cap = 0;
}

/* --- VP8L decoding -------------------------------------------------------- */

#define NUM_LITERAL 256
#define NUM_LENGTH 24
#define NUM_DISTANCE 40
#define ROOT_BITS 8

static const uint8_t kCodeLengthOrder[19] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
static const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112};

typedef struct {
    const uint8_t *buf;
    size_t len, next;
    uint64_t val, consumed, limit;
    int nbits;
} BitReader;

static void br_init(BitReader *b, const uint8_t *buf, size_t len)
{
    b->buf = buf;
    b->len = len;
    b->next = 0;
    b->val = 0;
    b->nbits = 0;
    b->consumed = 0;
    b->limit = 8 * (uint64_t)(len > 8 ? len : 8);
}

static uint32_t br_peek(BitReader *b)
{
    while (b->nbits <= 56) {
        uint64_t byte = b->next < b->len ? b->buf[b->next] : 0;
        b->next++;
        b->val |= byte << b->nbits;
        b->nbits += 8;
    }
    return (uint32_t)b->val;
}

static void br_skip(Ctx *c, BitReader *b, int n)
{
    b->val >>= n;
    b->nbits -= n;
    b->consumed += (uint64_t)n;
    if (b->consumed > b->limit) fail(c, "VP8L data ends before the image does");
}

static uint32_t br_read(Ctx *c, BitReader *b, int n)
{
    uint32_t v = n ? br_peek(b) & ((1u << n) - 1) : 0;
    br_skip(c, b, n);
    return v;
}

typedef struct {
    int single; /* the one symbol of a zero-bit code, or -1 */
    uint16_t counts[16];
    uint16_t *symbols; /* canonical order */
    int16_t sym[1 << ROOT_BITS];
    uint8_t len[1 << ROOT_BITS]; /* 0: a longer code starts here */
} HCode;

static uint32_t reverse_bits(uint32_t code, int n)
{
    uint32_t r = 0;
    int i;
    for (i = 0; i < n; i++) r |= ((code >> i) & 1u) << (n - 1 - i);
    return r;
}

/* BuildHuffmanTable's checks, then the canonical code; its symbols go
 * into `spare` when given (a code that is read and dropped), else into a
 * block of their own. */
static void build_code(Ctx *c, HCode *h, const int *lengths, int size, uint16_t *spare)
{
    int n, s, k, nsym = 0, left = 1;
    uint32_t code = 0;
    int offs[16];
    memset(h->counts, 0, sizeof(h->counts));
    for (s = 0; s < size; s++) h->counts[lengths[s]]++;
    if (h->counts[0] == size) fail(c, "VP8L prefix code without symbols");
    nsym = size - h->counts[0];
    h->symbols = spare ? spare : (uint16_t *)alloc(c, (size_t)nsym * sizeof(uint16_t));
    offs[1] = 0;
    for (n = 1; n < 15; n++) offs[n + 1] = offs[n] + h->counts[n];
    for (s = 0; s < size; s++)
        if (lengths[s]) h->symbols[offs[lengths[s]]++] = (uint16_t)s;
    if (nsym == 1) {
        h->single = h->symbols[0];
        return;
    }
    h->single = -1;
    for (n = 1; n < 16; n++) {
        left = 2 * left - h->counts[n];
        if (left < 0) fail(c, "VP8L prefix code is over-subscribed");
    }
    if (left) fail(c, "VP8L prefix code is incomplete");
    memset(h->len, 0, sizeof(h->len));
    k = 0;
    for (n = 1; n < 16; n++) {
        int i;
        for (i = 0; i < h->counts[n]; i++, k++) {
            if (n <= ROOT_BITS) {
                uint32_t r = reverse_bits(code, n), f;
                for (f = 0; f < (1u << (ROOT_BITS - n)); f++) {
                    h->sym[r | (f << n)] = (int16_t)h->symbols[k];
                    h->len[r | (f << n)] = (uint8_t)n;
                }
            }
            code++;
        }
        code <<= 1;
    }
}

static int read_symbol(Ctx *c, BitReader *b, const HCode *h)
{
    uint32_t bits;
    int n, code = 0, first = 0, index = 0;
    if (h->single >= 0) return h->single;
    bits = br_peek(b);
    n = h->len[bits & ((1u << ROOT_BITS) - 1)];
    if (n) {
        br_skip(c, b, n);
        return h->sym[bits & ((1u << ROOT_BITS) - 1)];
    }
    for (n = 1; n < 16; n++) {
        int count = h->counts[n];
        code |= (int)((bits >> (n - 1)) & 1u);
        if (code - first < count) {
            br_skip(c, b, n);
            return h->symbols[index + code - first];
        }
        index += count;
        first = (first + count) << 1;
        code <<= 1;
    }
    fail(c, "VP8L prefix code does not end");
    return 0;
}

static void read_code(Ctx *c, BitReader *b, HCode *h, int size, uint16_t *spare)
{
    int lengths[2328 + 1];
    int asize = size > 256 ? size : 256, i;
    memset(lengths, 0, (size_t)asize * sizeof(int));
    if (br_read(c, b, 1)) { /* simple: one or two symbols */
        int two = (int)br_read(c, b, 1);
        int first_bits = br_read(c, b, 1) ? 8 : 1;
        lengths[br_read(c, b, first_bits)] = 1;
        if (two) lengths[br_read(c, b, 8)] = 1;
    } else {
        int cl[19], max_symbol, symbol = 0, prev = 8;
        uint16_t clsyms[19];
        HCode clcode;
        int num = (int)br_read(c, b, 4) + 4;
        memset(cl, 0, sizeof(cl));
        for (i = 0; i < num; i++) cl[kCodeLengthOrder[i]] = (int)br_read(c, b, 3);
        build_code(c, &clcode, cl, 19, clsyms);
        if (br_read(c, b, 1)) {
            int nbits = 2 + 2 * (int)br_read(c, b, 3);
            max_symbol = 2 + (int)br_read(c, b, nbits);
            if (max_symbol > size) fail(c, "VP8L code-length count past its alphabet");
        } else {
            max_symbol = size;
        }
        while (symbol < size) {
            int v;
            if (max_symbol-- == 0) break;
            v = read_symbol(c, b, &clcode);
            if (v < 16) {
                lengths[symbol++] = v;
                if (v) prev = v;
            } else {
                static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
                int repeat = (int)br_read(c, b, extra[v - 16]) + offset[v - 16];
                int value = v == 16 ? prev : 0;
                if (symbol + repeat > size) fail(c, "VP8L code-length run past its alphabet");
                while (repeat-- > 0) lengths[symbol++] = value;
            }
        }
    }
    build_code(c, h, lengths, size, spare);
}

static int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

static int prefix_value(Ctx *c, BitReader *b, int symbol)
{
    int extra;
    if (symbol < 4) return symbol + 1;
    extra = (symbol - 2) >> 1;
    return ((2 + (symbol & 1)) << extra) + (int)br_read(c, b, extra) + 1;
}

static int plane_distance(int xsize, int code)
{
    int dc, dist;
    if (code > 120) return code - 120;
    dc = kCodeToPlane[code - 1];
    dist = (dc >> 4) * xsize + 8 - (dc & 15);
    return dist >= 1 ? dist : 1;
}

static uint32_t add_pixels(uint32_t a, uint32_t b)
{
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

static uint32_t sub_pixels(uint32_t a, uint32_t b)
{
    uint32_t ag = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
    uint32_t rb = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

static uint32_t avg2(uint32_t a, uint32_t b)
{
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

static int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

static uint32_t predict(int mode, uint32_t l, uint32_t t, uint32_t tr, uint32_t tl)
{
    int s, pa_minus_pb;
    uint32_t out = 0, ave;
    switch (mode) {
    case 1: return l;
    case 2: return t;
    case 3: return tr;
    case 4: return tl;
    case 5: return avg2(avg2(l, tr), t);
    case 6: return avg2(l, tl);
    case 7: return avg2(l, t);
    case 8: return avg2(tl, t);
    case 9: return avg2(t, tr);
    case 10: return avg2(avg2(l, tl), avg2(t, tr));
    case 11:
        pa_minus_pb = 0;
        for (s = 0; s < 32; s += 8) {
            int cl = (int)((l >> s) & 255), ct = (int)((t >> s) & 255);
            int cc = (int)((tl >> s) & 255);
            pa_minus_pb += abs(cl - cc) - abs(ct - cc);
        }
        return pa_minus_pb <= 0 ? t : l;
    case 12:
        for (s = 0; s < 32; s += 8)
            out |= (uint32_t)clip255((int)((l >> s) & 255) + (int)((t >> s) & 255) -
                                     (int)((tl >> s) & 255)) << s;
        return out;
    case 13:
        ave = avg2(l, t);
        for (s = 0; s < 32; s += 8) {
            int a = (int)((ave >> s) & 255), b = (int)((tl >> s) & 255);
            out |= (uint32_t)clip255(a + (a - b) / 2) << s;
        }
        return out;
    default: return 0xff000000u;
    }
}

typedef struct {
    int kind, bits, xsize;
    uint32_t *data; /* sub-image, or the palette */
} Transform;

static uint32_t *image_stream(Ctx *c, BitReader *b, int xsize, int ysize, int level0);

static void entropy_data(Ctx *c, BitReader *b, uint32_t *out, int xsize, int ysize,
                         int cache_bits, HCode *codes, const uint32_t *meta,
                         int meta_bits)
{
    size_t total = (size_t)xsize * ysize, pos = 0, last_cached = 0;
    uint32_t *cache = cache_bits ? (uint32_t *)alloc(c, sizeof(uint32_t) << cache_bits) : NULL;
    int shift = 32 - cache_bits, x = 0, y = 0;
    int mask = meta ? (1 << meta_bits) - 1 : -1;
    int meta_width = subsample(xsize, meta_bits);
    const HCode *g = codes;
    while (pos < total) {
        int code;
        if (meta && (x & mask) == 0)
            g = codes + 5 * (size_t)meta[(size_t)(y >> meta_bits) * meta_width + (x >> meta_bits)];
        code = read_symbol(c, b, &g[0]);
        if (code < NUM_LITERAL) {
            int red = read_symbol(c, b, &g[1]);
            int blue = read_symbol(c, b, &g[2]);
            int alpha = read_symbol(c, b, &g[3]);
            out[pos++] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) |
                         ((uint32_t)code << 8) | (uint32_t)blue;
            if (++x >= xsize) {
                x = 0;
                y++;
            }
        } else if (code < NUM_LITERAL + NUM_LENGTH) {
            int length = prefix_value(c, b, code - NUM_LITERAL);
            int dist = plane_distance(xsize, prefix_value(c, b, read_symbol(c, b, &g[4])));
            size_t k;
            if (pos < (size_t)dist || total - pos < (size_t)length)
                fail(c, "VP8L copy leaves the image");
            for (k = pos; k < pos + (size_t)length; k++) out[k] = out[k - dist];
            pos += (size_t)length;
            x += length;
            while (x >= xsize) {
                x -= xsize;
                y++;
            }
            if (meta && pos < total)
                g = codes + 5 * (size_t)meta[(size_t)(y >> meta_bits) * meta_width + (x >> meta_bits)];
        } else {
            out[pos++] = cache[code - NUM_LITERAL - NUM_LENGTH];
            if (++x >= xsize) {
                x = 0;
                y++;
            }
        }
        /* Every pixel enters the cache in order (libwebp inserts lazily,
         * but always before a lookup). */
        while (cache && last_cached < pos) {
            uint32_t argb = out[last_cached++];
            cache[(argb * 0x1e35a7bdu) >> shift] = argb;
        }
    }
}

static void undo_predictor(const Transform *t, uint32_t *p, int height)
{
    int w = t->xsize, bits = t->bits, tiles = subsample(w, bits), x, y;
    p[0] = add_pixels(p[0], 0xff000000u);
    for (x = 1; x < w; x++) p[x] = add_pixels(p[x], p[x - 1]);
    for (y = 1; y < height; y++) {
        uint32_t *row = p + (size_t)y * w;
        const uint32_t *modes = t->data + (size_t)(y >> bits) * tiles;
        row[0] = add_pixels(row[0], row[-w]);
        for (x = 1; x < w; x++) {
            int mode = (int)((modes[x >> bits] >> 8) & 15);
            row[x] = add_pixels(row[x], predict(mode, row[x - 1], row[x - w],
                                                row[x - w + 1], row[x - w - 1]));
        }
    }
}

static int8_t s8(uint32_t v) { return (int8_t)(uint8_t)v; }

static void undo_cross_colour(const Transform *t, uint32_t *p, int height)
{
    int w = t->xsize, bits = t->bits, tiles = subsample(w, bits), x, y;
    for (y = 0; y < height; y++)
        for (x = 0; x < w; x++) {
            uint32_t code = t->data[(size_t)(y >> bits) * tiles + (x >> bits)];
            uint32_t argb = p[(size_t)y * w + x];
            int green = s8(argb >> 8);
            int red = (int)((argb >> 16) & 255), blue = (int)(argb & 255);
            red = (red + ((s8(code) * green) >> 5)) & 255;
            blue += (s8(code >> 8) * green) >> 5;
            blue = (blue + ((s8(code >> 16) * s8((uint32_t)red)) >> 5)) & 255;
            p[(size_t)y * w + x] = (argb & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
        }
}

static uint32_t *undo_transform(Ctx *c, const Transform *t, uint32_t *p, int height)
{
    size_t i, n = (size_t)t->xsize * height;
    if (t->kind == 0) {
        undo_predictor(t, p, height);
        return p;
    }
    if (t->kind == 1) {
        undo_cross_colour(t, p, height);
        return p;
    }
    if (t->kind == 2) {
        for (i = 0; i < n; i++) {
            uint32_t argb = p[i], green = (argb >> 8) & 255;
            uint32_t rb = ((argb & 0x00ff00ffu) + (green << 16 | green)) & 0x00ff00ffu;
            p[i] = (argb & 0xff00ff00u) | rb;
        }
        return p;
    }
    {
        int bits = t->bits, w = t->xsize, packed_w = subsample(w, bits), x, y;
        uint32_t *out = (uint32_t *)alloc(c, n * sizeof(uint32_t));
        for (y = 0; y < height; y++) {
            const uint32_t *src = p + (size_t)y * packed_w;
            uint32_t *dst = out + (size_t)y * w;
            if (bits == 0) {
                for (x = 0; x < w; x++) dst[x] = t->data[(src[x] >> 8) & 255];
            } else {
                int depth = 8 >> bits, per_mask = (1 << bits) - 1;
                uint32_t packed = 0, bmask = (1u << depth) - 1;
                for (x = 0; x < w; x++) {
                    if ((x & per_mask) == 0) packed = (src[x >> bits] >> 8) & 255;
                    dst[x] = t->data[packed & bmask];
                    packed >>= depth;
                }
            }
        }
        return out;
    }
}

static uint32_t *image_stream(Ctx *c, BitReader *b, int xsize, int ysize, int level0)
{
    Transform transforms[4];
    int nt = 0, seen = 0, cache_bits = 0, meta_bits = 0, ngroups = 1, i, j;
    uint32_t *meta = NULL, *pixels;
    HCode *codes;
    int sizes[5];
    if (level0) {
        while (br_read(c, b, 1)) {
            Transform *t = &transforms[nt];
            int kind = (int)br_read(c, b, 2);
            if (seen & (1 << kind)) fail(c, "VP8L transform given twice");
            seen |= 1 << kind;
            t->kind = kind;
            t->xsize = xsize;
            t->bits = 0;
            t->data = NULL;
            if (kind == 0 || kind == 1) {
                t->bits = (int)br_read(c, b, 3) + 2;
                t->data = image_stream(c, b, subsample(xsize, t->bits),
                                       subsample(ysize, t->bits), 0);
            } else if (kind == 3) {
                int n = (int)br_read(c, b, 8) + 1, k;
                uint32_t *colours;
                t->bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
                colours = image_stream(c, b, n, 1, 0);
                t->data = (uint32_t *)alloc(c, sizeof(uint32_t) << (8 >> t->bits));
                t->data[0] = colours[0];
                for (k = 1; k < n; k++) t->data[k] = add_pixels(colours[k], t->data[k - 1]);
                xsize = subsample(xsize, t->bits);
            }
            nt++;
        }
    }
    if (br_read(c, b, 1)) {
        cache_bits = (int)br_read(c, b, 4);
        if (cache_bits < 1 || cache_bits > 11) fail(c, "VP8L colour cache of 0 or more than 11 bits");
    }
    if (level0 && br_read(c, b, 1)) {
        int mw, mh;
        size_t k;
        meta_bits = (int)br_read(c, b, 3) + 2;
        mw = subsample(xsize, meta_bits);
        mh = subsample(ysize, meta_bits);
        meta = image_stream(c, b, mw, mh, 0);
        for (k = 0; k < (size_t)mw * mh; k++) {
            meta[k] = (meta[k] >> 8) & 0xffff;
            if ((int)meta[k] + 1 > ngroups) ngroups = (int)meta[k] + 1;
        }
    }
    sizes[0] = NUM_LITERAL + NUM_LENGTH + (cache_bits ? 1 << cache_bits : 0);
    sizes[1] = sizes[2] = sizes[3] = NUM_LITERAL;
    sizes[4] = NUM_DISTANCE;
    {
        /* Groups the entropy image never names are read (and checked) as
         * libwebp reads them, into a scratch code: up to 65536 groups
         * cost no memory of their own. */
        int *map = (int *)alloc(c, (size_t)ngroups * sizeof(int)), nused = 0;
        uint16_t *spare = (uint16_t *)alloc(c, 2328 * sizeof(uint16_t));
        HCode scratch;
        size_t k, npix = meta ? (size_t)subsample(xsize, meta_bits) * subsample(ysize, meta_bits) : 0;
        for (i = 0; i < ngroups; i++) map[i] = meta ? -1 : 0;
        for (k = 0; k < npix; k++) map[meta[k]] = 0;
        for (i = 0; i < ngroups; i++)
            if (map[i] == 0) map[i] = nused++;
        for (k = 0; k < npix; k++) meta[k] = (uint32_t)map[meta[k]];
        codes = (HCode *)alloc(c, (size_t)nused * 5 * sizeof(HCode));
        for (i = 0; i < ngroups; i++)
            for (j = 0; j < 5; j++)
                read_code(c, b, map[i] >= 0 ? &codes[5 * map[i] + j] : &scratch, sizes[j],
                          map[i] >= 0 ? NULL : spare);
    }
    pixels = (uint32_t *)alloc(c, (size_t)xsize * ysize * sizeof(uint32_t));
    entropy_data(c, b, pixels, xsize, ysize, cache_bits, codes, meta, meta_bits);
    for (i = nt - 1; i >= 0; i--) pixels = undo_transform(c, &transforms[i], pixels, ysize);
    return pixels;
}

int vp8l_decode(const uint8_t *data, long len, int width, int height, int headerless,
                uint32_t *out, char *err, int errlen)
{
    Ctx c;
    BitReader b;
    uint32_t *pixels;
    int rc;
    memset(&c, 0, sizeof(c));
    c.err = err;
    c.errlen = errlen;
    if ((rc = setjmp(c.jump)) != 0) {
        release(&c);
        return rc;
    }
    br_init(&b, data, (size_t)len);
    if (!headerless) {
        if (br_read(&c, &b, 8) != 0x2f) fail(&c, "not a VP8L stream (signature 0x2f)");
        if ((int)br_read(&c, &b, 14) + 1 != width || (int)br_read(&c, &b, 14) + 1 != height)
            fail(&c, "VP8L size differs from the caller's");
        br_read(&c, &b, 1);
        if (br_read(&c, &b, 3)) fail(&c, "VP8L version other than 0");
    }
    pixels = image_stream(&c, &b, width, height, 1);
    memcpy(out, pixels, (size_t)width * height * sizeof(uint32_t));
    release(&c);
    return 0;
}

/* --- VP8 decoding ----------------------------------------------------------- */

/* RFC 6386 tables in libwebp's layout (its prediction-mode order). */
static const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
static const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};
static const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
static const uint8_t kCat3[] = {173, 148, 140, 0};
static const uint8_t kCat4[] = {176, 155, 140, 135, 0};
static const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
static const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
static const uint8_t *const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

enum { DC, TM, VE, HE, RD, VR, LD, VL, HD, HU };
#define YS 21 /* luma work stride: 1 left + 16 + 4 top-right */
#define US 9

/* libwebp's VP8BitReader on a 64-bit machine (bit_reader_utils.c and
 * bit_reader_inl_utils.h): a 64-bit window filled 56 bits at a time while
 * 8 bytes remain, then a byte at a time, then one zero byte that sets eof;
 * the range kept as range - 1. Corrupt streams that break the coder's
 * invariant decode as libwebp decodes them. */
typedef struct {
    const uint8_t *buf, *end, *max;
    uint64_t value;
    uint32_t range;
    int bits, eof;
} BoolReader;

static void bool_load(BoolReader *b)
{
    if (b->buf < b->max) {
        uint64_t chunk = 0;
        int i;
        for (i = 0; i < 7; i++) chunk = (chunk << 8) | b->buf[i];
        b->buf += 7;
        b->value = chunk | (b->value << 56);
        b->bits += 56;
    } else if (b->buf < b->end) {
        b->value = (uint64_t)(*b->buf++) | (b->value << 8);
        b->bits += 8;
    } else if (!b->eof) {
        b->value <<= 8;
        b->bits += 8;
        b->eof = 1;
    } else {
        b->bits = 0;
    }
}

static void bool_init(BoolReader *b, const uint8_t *start, size_t size)
{
    b->buf = start;
    b->end = start + size;
    b->max = size >= 8 ? start + size - 7 : start;
    b->value = 0;
    b->range = 254;
    b->bits = -8;
    b->eof = 0;
    bool_load(b);
}

static int get_bit(BoolReader *b, int prob)
{
    uint32_t range = b->range, split;
    int pos, bit, shift = 0;
    if (b->bits < 0) bool_load(b);
    pos = b->bits;
    split = (range * (uint32_t)prob) >> 8;
    if ((uint32_t)(b->value >> pos) > split) {
        range -= split;
        b->value -= (uint64_t)(split + 1) << pos;
        bit = 1;
    } else {
        range = split + 1;
        bit = 0;
    }
    while ((range << shift) < 128) shift++;
    b->range = (range << shift) - 1;
    b->bits -= shift;
    return bit;
}

/* VP8GetSigned: v with the sign of one bit of probability 1/2. */
static int get_signed(BoolReader *b, int v)
{
    uint32_t split, value;
    int32_t mask;
    int pos;
    if (b->bits < 0) bool_load(b);
    pos = b->bits;
    split = b->range >> 1;
    value = (uint32_t)(b->value >> pos);
    mask = (split - value) >= 0x80000000u ? -1 : 0;
    b->bits -= 1;
    b->range += (uint32_t)mask;
    b->range |= 1;
    b->value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
}

static int get_value(BoolReader *b, int n)
{
    int v = 0;
    while (n-- > 0) v = (v << 1) | get_bit(b, 128);
    return v;
}

static int get_signed_value(BoolReader *b, int n)
{
    int v = get_value(b, n);
    return get_bit(b, 128) ? -v : v;
}

typedef struct {
    int width, height, mb_w, mb_h;
    BoolReader br, parts[8];
    int nparts;
    int use_segment, update_map, absolute, seg_quant[4], seg_filter[4];
    uint8_t seg_probas[3];
    int simple, level, sharpness, use_lf_delta, ref_delta0, mode_delta0, filter_type;
    int quant[4][3][2]; /* segment, (y1, y2, uv), (dc, ac) */
    uint8_t probas[4][8][3][11];
    int use_skip, skip_p;
} Vp8;

static int clipq(int v, int hi) { return v < 0 ? 0 : v > hi ? hi : v; }

static void vp8_header(Ctx *c, Vp8 *h, const uint8_t *data, size_t len)
{
    uint32_t bits;
    size_t part0, start, left, part_start;
    int num, p, s, i, t, bnd, ctx, k, base, d[5];
    if (len < 4) fail(c, "VP8 frame header ends early");
    bits = data[0] | (data[1] << 8) | ((uint32_t)data[2] << 16);
    if (bits & 1) fail(c, "VP8 frame is not a key frame");
    if (((bits >> 1) & 7) > 3) fail(c, "VP8 profile past 3");
    if (!((bits >> 4) & 1)) fail(c, "VP8 frame is not shown");
    part0 = bits >> 5;
    if (len < 10) fail(c, "VP8 picture header ends early");
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
        fail(c, "VP8 key frame without its start code");
    h->width = (data[6] | (data[7] << 8)) & 0x3fff;
    h->height = (data[8] | (data[9] << 8)) & 0x3fff;
    if (!h->width || !h->height) fail(c, "VP8 frame of zero width or height");
    h->mb_w = (h->width + 15) >> 4;
    h->mb_h = (h->height + 15) >> 4;
    if (part0 > len - 10) fail(c, "VP8 first partition past the data");
    bool_init(&h->br, data + 10, part0);
    get_value(&h->br, 2); /* colour space and clamping: ignored */
    h->use_segment = get_bit(&h->br, 128);
    h->update_map = 0;
    h->absolute = 1;
    memset(h->seg_quant, 0, sizeof(h->seg_quant));
    memset(h->seg_filter, 0, sizeof(h->seg_filter));
    memset(h->seg_probas, 255, sizeof(h->seg_probas));
    if (h->use_segment) {
        h->update_map = get_bit(&h->br, 128);
        if (get_bit(&h->br, 128)) {
            h->absolute = get_bit(&h->br, 128);
            for (s = 0; s < 4; s++)
                h->seg_quant[s] = get_bit(&h->br, 128) ? get_signed_value(&h->br, 7) : 0;
            for (s = 0; s < 4; s++)
                h->seg_filter[s] = get_bit(&h->br, 128) ? get_signed_value(&h->br, 6) : 0;
        }
        if (h->update_map)
            for (s = 0; s < 3; s++)
                h->seg_probas[s] = (uint8_t)(get_bit(&h->br, 128) ? get_value(&h->br, 8) : 255);
    }
    h->simple = get_bit(&h->br, 128);
    h->level = get_value(&h->br, 6);
    h->sharpness = get_value(&h->br, 3);
    h->use_lf_delta = get_bit(&h->br, 128);
    h->ref_delta0 = h->mode_delta0 = 0;
    if (h->use_lf_delta && get_bit(&h->br, 128)) {
        int ref[4] = {0, 0, 0, 0}, mode[4] = {0, 0, 0, 0};
        for (i = 0; i < 4; i++)
            if (get_bit(&h->br, 128)) ref[i] = get_signed_value(&h->br, 6);
        for (i = 0; i < 4; i++)
            if (get_bit(&h->br, 128)) mode[i] = get_signed_value(&h->br, 6);
        h->ref_delta0 = ref[0];
        h->mode_delta0 = mode[0];
    }
    h->filter_type = h->level == 0 ? 0 : h->simple ? 1 : 2;
    if (h->br.eof) fail(c, "VP8 frame header ends early");
    num = 1 << get_value(&h->br, 2);
    start = 10 + part0;
    left = len - start;
    if (left < 3 * (size_t)(num - 1)) fail(c, "VP8 partition sizes past the data");
    part_start = start + 3 * (size_t)(num - 1);
    left -= 3 * (size_t)(num - 1);
    for (p = 0; p < num - 1; p++) {
        const uint8_t *sz = data + start + 3 * p;
        size_t psize = sz[0] | (sz[1] << 8) | ((size_t)sz[2] << 16);
        if (psize > left) psize = left;
        bool_init(&h->parts[p], data + part_start, psize);
        part_start += psize;
        left -= psize;
    }
    bool_init(&h->parts[num - 1], data + part_start, left);
    if (part_start >= len) fail(c, "VP8 last partition is empty");
    h->nparts = num;
    base = get_value(&h->br, 7);
    for (i = 0; i < 5; i++) d[i] = get_bit(&h->br, 128) ? get_signed_value(&h->br, 4) : 0;
    for (s = 0; s < 4; s++) {
        int q = h->use_segment ? h->seg_quant[s] + (h->absolute ? 0 : base) : base;
        int y2ac = (kAcTable[clipq(q + d[2], 127)] * 101581) >> 16;
        h->quant[s][0][0] = kDcTable[clipq(q + d[0], 127)];
        h->quant[s][0][1] = kAcTable[clipq(q, 127)];
        h->quant[s][1][0] = kDcTable[clipq(q + d[1], 127)] * 2;
        h->quant[s][1][1] = y2ac < 8 ? 8 : y2ac;
        h->quant[s][2][0] = kDcTable[clipq(q + d[3], 117)];
        h->quant[s][2][1] = kAcTable[clipq(q + d[4], 127)];
    }
    get_bit(&h->br, 128); /* refresh entropy probs */
    k = 0;
    for (t = 0; t < 4; t++)
        for (bnd = 0; bnd < 8; bnd++)
            for (ctx = 0; ctx < 3; ctx++)
                for (i = 0; i < 11; i++, k++)
                    h->probas[t][bnd][ctx][i] = (uint8_t)(
                        get_bit(&h->br, kCoeffsUpdateProba[k]) ? get_value(&h->br, 8)
                                                               : kCoeffsProba0[k]);
    h->use_skip = get_bit(&h->br, 128);
    h->skip_p = h->use_skip ? get_value(&h->br, 8) : 0;
}

typedef struct {
    int segment, skip, i4x4, uvmode;
    uint8_t modes[16];
} MbInfo;

static void intra_modes(Vp8 *h, uint8_t *top, uint8_t *left, MbInfo *m)
{
    BoolReader *br = &h->br;
    int x, y;
    m->segment = 0;
    if (h->update_map)
        m->segment = !get_bit(br, h->seg_probas[0]) ? get_bit(br, h->seg_probas[1])
                                                    : get_bit(br, h->seg_probas[2]) + 2;
    m->skip = h->use_skip ? get_bit(br, h->skip_p) : 0;
    m->i4x4 = !get_bit(br, 145);
    if (!m->i4x4) {
        int ymode = get_bit(br, 156) ? (get_bit(br, 128) ? TM : HE)
                                     : (get_bit(br, 163) ? VE : DC);
        m->modes[0] = (uint8_t)ymode;
        memset(top, ymode, 4);
        memset(left, ymode, 4);
    } else {
        for (y = 0; y < 4; y++) {
            int ymode = left[y];
            for (x = 0; x < 4; x++) {
                const uint8_t *prob = kBModesProba + (top[x] * 10 + ymode) * 9;
                if (!get_bit(br, prob[0])) ymode = DC;
                else if (!get_bit(br, prob[1])) ymode = TM;
                else if (!get_bit(br, prob[2])) ymode = VE;
                else if (!get_bit(br, prob[3]))
                    ymode = !get_bit(br, prob[4]) ? HE : (get_bit(br, prob[5]) ? VR : RD);
                else if (!get_bit(br, prob[6])) ymode = LD;
                else if (!get_bit(br, prob[7])) ymode = VL;
                else ymode = get_bit(br, prob[8]) ? HU : HD;
                top[x] = (uint8_t)ymode;
            }
            memcpy(m->modes + 4 * y, top, 4);
            left[y] = (uint8_t)ymode;
        }
    }
    m->uvmode = !get_bit(br, 142) ? DC : !get_bit(br, 114) ? VE : get_bit(br, 183) ? TM : HE;
}

static int16_t i16(int v) { return (int16_t)(uint16_t)(unsigned)v; }

static int large_value(BoolReader *br, const uint8_t *p)
{
    int v;
    if (!get_bit(br, p[3])) {
        if (!get_bit(br, p[4])) return 2;
        return 3 + get_bit(br, p[5]);
    }
    if (!get_bit(br, p[6])) {
        if (!get_bit(br, p[7])) return 5 + get_bit(br, 159);
        v = 7 + 2 * get_bit(br, 165);
        return v + get_bit(br, 145);
    }
    {
        const uint8_t *tab;
        int bit1 = get_bit(br, p[8]);
        int bit0 = get_bit(br, p[9 + bit1]);
        int cat = 2 * bit1 + bit0;
        v = 0;
        for (tab = kCat3456[cat]; *tab; ++tab) v += v + get_bit(br, *tab);
        return v + 3 + (8 << cat);
    }
}

static int get_coeffs(BoolReader *br, uint8_t bands[8][3][11], int ctx, const int *dq,
                      int n, int16_t *out)
{
    const uint8_t *p = bands[kBands[n]][ctx];
    while (n < 16) {
        int v;
        if (!get_bit(br, p[0])) return n;
        while (!get_bit(br, p[1])) {
            if (++n == 16) return 16;
            p = bands[kBands[n]][0];
        }
        if (!get_bit(br, p[2])) {
            v = 1;
            ctx = 1;
        } else {
            v = large_value(br, p);
            ctx = 2;
        }
        out[kZigzag[n]] = i16(get_signed(br, v) * dq[n > 0]);
        n++;
        p = bands[kBands[n]][ctx];
    }
    return 16;
}

static uint32_t nz_code(uint32_t nzc, int nz, int dc_nz)
{
    return (nzc << 2) | (uint32_t)(nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
}

static void wht(const int16_t *in, int16_t *out)
{
    int tmp[16], i;
    for (i = 0; i < 4; i++) {
        int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
        int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
        tmp[i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (i = 0; i < 4; i++) {
        int dc = tmp[4 * i] + 3;
        int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
        int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
        out[64 * i] = i16((a0 + a1) >> 3);
        out[64 * i + 16] = i16((a3 + a2) >> 3);
        out[64 * i + 32] = i16((a0 - a1) >> 3);
        out[64 * i + 48] = i16((a3 - a2) >> 3);
    }
}

/* ParseResiduals: top[0]/left[0] the nz bits, top[1]/left[1] the DC nz. */
static void residuals(Vp8 *h, BoolReader *br, const int q[3][2], int i4x4, int *top,
                      int *left, int16_t *coeffs, uint32_t *nzy, uint32_t *nzuv)
{
    int first, x, y, ch, n, l, base = 0;
    uint32_t tnz, lnz, non_zero_y = 0, non_zero_uv = 0, out_t, out_l;
    uint8_t(*ac)[3][11];
    if (!i4x4) {
        int16_t dc[16];
        memset(dc, 0, sizeof(dc));
        n = get_coeffs(br, h->probas[1], top[1] + left[1], q[1], 0, dc);
        top[1] = left[1] = n > 0;
        if (n > 1) {
            wht(dc, coeffs);
        } else {
            int16_t dc0 = i16((dc[0] + 3) >> 3);
            for (x = 0; x < 16; x++) coeffs[16 * x] = dc0;
        }
        first = 1;
        ac = h->probas[0];
    } else {
        first = 0;
        ac = h->probas[3];
    }
    tnz = (uint32_t)top[0] & 0x0f;
    lnz = (uint32_t)left[0] & 0x0f;
    for (y = 0; y < 4; y++) {
        uint32_t nzc = 0;
        l = (int)(lnz & 1);
        for (x = 0; x < 4; x++) {
            n = get_coeffs(br, ac, l + (int)(tnz & 1), q[0], first, coeffs + base);
            l = n > first;
            tnz = (tnz >> 1) | ((uint32_t)l << 7);
            nzc = nz_code(nzc, n, coeffs[base] != 0);
            base += 16;
        }
        tnz >>= 4;
        lnz = (lnz >> 1) | ((uint32_t)l << 7);
        non_zero_y = (non_zero_y << 8) | nzc;
    }
    out_t = tnz;
    out_l = lnz >> 4;
    for (ch = 0; ch < 4; ch += 2) {
        uint32_t nzc = 0;
        tnz = (uint32_t)top[0] >> (4 + ch);
        lnz = (uint32_t)left[0] >> (4 + ch);
        for (y = 0; y < 2; y++) {
            l = (int)(lnz & 1);
            for (x = 0; x < 2; x++) {
                n = get_coeffs(br, h->probas[2], l + (int)(tnz & 1), q[2], 0, coeffs + base);
                l = n > 0;
                tnz = (tnz >> 1) | ((uint32_t)l << 3);
                nzc = nz_code(nzc, n, coeffs[base] != 0);
                base += 16;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | ((uint32_t)l << 5);
        }
        non_zero_uv |= nzc << (4 * ch);
        out_t |= (tnz << 4) << ch;
        out_l |= (lnz & 0xf0) << ch;
    }
    top[0] = (int)out_t;
    left[0] = (int)out_l;
    *nzy = non_zero_y;
    *nzuv = non_zero_uv;
}

static uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
/* In 64 bits: the products of a corrupt stream's coefficients pass 2^31. */
#define MUL1(a) ((int)(((int64_t)(a) * 20091) >> 16) + (a))
#define MUL2(a) ((int)(((int64_t)(a) * 35468) >> 16))

static void idct_add(const int16_t *in, uint8_t *dst, int stride)
{
    int tmp[16], i;
    for (i = 0; i < 4; i++) {
        int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
        int c = MUL2(in[4 + i]) - MUL1(in[12 + i]);
        int d = MUL1(in[4 + i]) + MUL2(in[12 + i]);
        tmp[4 * i] = a + d;
        tmp[4 * i + 1] = b + c;
        tmp[4 * i + 2] = b - c;
        tmp[4 * i + 3] = a - d;
    }
    for (i = 0; i < 4; i++) {
        int dc = tmp[i] + 4;
        int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
        int c = MUL2(tmp[4 + i]) - MUL1(tmp[12 + i]);
        int d = MUL1(tmp[4 + i]) + MUL2(tmp[12 + i]);
        uint8_t *r = dst + i * stride;
        r[0] = clip8(r[0] + ((a + d) >> 3));
        r[1] = clip8(r[1] + ((b + c) >> 3));
        r[2] = clip8(r[2] + ((b - c) >> 3));
        r[3] = clip8(r[3] + ((a - d) >> 3));
    }
}

/* One pass of libwebp's Transform_SSE2 on a lane: 16-bit sums that
 * wrap, _mm_mulhi_epi16 with the constants less 1 << 16. */
static void simd_pass(int i0, int i1, int i2, int i3, int16_t *o)
{
    const int k1 = 20091, k2 = 35468 - 65536;
    int16_t a = i16(i0 + i2), b = i16(i0 - i2);
    int16_t c = i16(i16(i1 - i3) + i16(((i1 * k2) >> 16) - ((i3 * k1) >> 16)));
    int16_t d = i16(i16(i1 + i3) + i16(((i1 * k1) >> 16) + ((i3 * k2) >> 16)));
    o[0] = i16(a + d);
    o[1] = i16(b + c);
    o[2] = i16(b - c);
    o[3] = i16(a - d);
}

/* libwebp's Transform_SSE2, which its decoder runs on x86 for luma blocks
 * with coefficients past the third and chroma planes with any AC: equal
 * to idct_add unless a 16-bit sum wraps (corrupt streams); the sum with
 * the prediction wraps too, then saturates. */
static void idct_add_simd(const int16_t *in, uint8_t *dst, int stride)
{
    int16_t tmp[16], out[4];
    int i, k;
    for (i = 0; i < 4; i++) simd_pass(in[i], in[4 + i], in[8 + i], in[12 + i], tmp + 4 * i);
    for (i = 0; i < 4; i++) {
        uint8_t *r = dst + i * stride;
        simd_pass(i16(tmp[i] + 4), tmp[4 + i], tmp[8 + i], tmp[12 + i], out);
        for (k = 0; k < 4; k++) r[k] = clip8(i16(r[k] + (out[k] >> 3)));
    }
}

/* DoTransform: by the block's 2-bit code, the SIMD transform (3) or the
 * integer AC3 and DC ones (2, 1; idct_add computes both). */
static void luma_transform(uint32_t code, const int16_t *in, uint8_t *dst, int stride)
{
    code &= 3;
    if (code == 3) idct_add_simd(in, dst, stride);
    else if (code) idct_add(in, dst, stride);
}

#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) ((uint8_t)(((a) + (b) + 1) >> 1))
#define DST(x, y) d[(x) + (y) * s]

static void predict4(int mode, uint8_t *d, int s)
{
    const uint8_t *t = d - s;
    int X = t[-1], A = t[0], B = t[1], C = t[2], D = t[3], E = t[4], F = t[5], G = t[6],
        H = t[7];
    int I = d[-1], J = d[-1 + s], K = d[-1 + 2 * s], L = d[-1 + 3 * s], x, y;
    switch (mode) {
    case DC: {
        int v = (A + B + C + D + I + J + K + L + 4) >> 3;
        for (y = 0; y < 4; y++) memset(d + y * s, v, 4);
        break;
    }
    case TM:
        for (y = 0; y < 4; y++) {
            int left = d[-1 + y * s];
            for (x = 0; x < 4; x++) DST(x, y) = clip8(t[x] + left - X);
        }
        break;
    case VE: {
        uint8_t v[4];
        v[0] = AVG3(X, A, B);
        v[1] = AVG3(A, B, C);
        v[2] = AVG3(B, C, D);
        v[3] = AVG3(C, D, E);
        for (y = 0; y < 4; y++) memcpy(d + y * s, v, 4);
        break;
    }
    case HE:
        memset(d, AVG3(X, I, J), 4);
        memset(d + s, AVG3(I, J, K), 4);
        memset(d + 2 * s, AVG3(J, K, L), 4);
        memset(d + 3 * s, AVG3(K, L, L), 4);
        break;
    case RD:
        DST(0, 3) = AVG3(J, K, L);
        DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
        DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
        DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
        DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
        DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
        DST(3, 0) = AVG3(D, C, B);
        break;
    case LD:
        DST(0, 0) = AVG3(A, B, C);
        DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
        DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
        DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
        DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
        DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
        DST(3, 3) = AVG3(G, H, H);
        break;
    case VR:
        DST(0, 0) = DST(1, 2) = AVG2(X, A);
        DST(1, 0) = DST(2, 2) = AVG2(A, B);
        DST(2, 0) = DST(3, 2) = AVG2(B, C);
        DST(3, 0) = AVG2(C, D);
        DST(0, 3) = AVG3(K, J, I);
        DST(0, 2) = AVG3(J, I, X);
        DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
        DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
        DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
        DST(3, 1) = AVG3(B, C, D);
        break;
    case VL:
        DST(0, 0) = AVG2(A, B);
        DST(1, 0) = DST(0, 2) = AVG2(B, C);
        DST(2, 0) = DST(1, 2) = AVG2(C, D);
        DST(3, 0) = DST(2, 2) = AVG2(D, E);
        DST(0, 1) = AVG3(A, B, C);
        DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
        DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
        DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
        DST(3, 2) = AVG3(E, F, G);
        DST(3, 3) = AVG3(F, G, H);
        break;
    case HU:
        DST(0, 0) = AVG2(I, J);
        DST(2, 0) = DST(0, 1) = AVG2(J, K);
        DST(2, 1) = DST(0, 2) = AVG2(K, L);
        DST(1, 0) = AVG3(I, J, K);
        DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
        DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
        DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
        break;
    default: /* HD */
        DST(0, 0) = DST(2, 1) = AVG2(I, X);
        DST(0, 1) = DST(2, 2) = AVG2(J, I);
        DST(0, 2) = DST(2, 3) = AVG2(K, J);
        DST(0, 3) = AVG2(L, K);
        DST(3, 0) = AVG3(A, B, C);
        DST(2, 0) = AVG3(X, A, B);
        DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
        DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
        DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
        DST(1, 3) = AVG3(L, K, J);
        break;
    }
}

/* 16x16 luma or 8x8 chroma prediction into ws (pixel (0,0) at s + 1), DC
 * as libwebp's CheckMode picks it at the frame's edges. */
static void predict_block(int mode, uint8_t *ws, int size, int s, int mb_x, int mb_y)
{
    uint8_t *d = ws + s + 1;
    const uint8_t *top = ws + 1;
    int x, y, shift = size == 16 ? 4 : 3, sum = 0;
    if (mode == DC) {
        int v;
        if (mb_y > 0 && mb_x > 0) {
            for (x = 0; x < size; x++) sum += top[x] + d[-1 + x * s];
            v = (sum + size) >> (shift + 1);
        } else if (mb_y > 0) {
            for (x = 0; x < size; x++) sum += top[x];
            v = (sum + (size >> 1)) >> shift;
        } else if (mb_x > 0) {
            for (x = 0; x < size; x++) sum += d[-1 + x * s];
            v = (sum + (size >> 1)) >> shift;
        } else {
            v = 128;
        }
        for (y = 0; y < size; y++) memset(d + y * s, v, (size_t)size);
    } else if (mode == TM) {
        for (y = 0; y < size; y++)
            for (x = 0; x < size; x++) d[x + y * s] = clip8(top[x] + d[-1 + y * s] - ws[0]);
    } else if (mode == VE) {
        for (y = 0; y < size; y++) memcpy(d + y * s, top, (size_t)size);
    } else {
        for (y = 0; y < size; y++) memset(d + y * s, d[-1 + y * s], (size_t)size);
    }
}

typedef struct {
    uint8_t *y, *u, *v;
    int ys, uvs;
} Planes;

static void reconstruct(const Vp8 *h, const MbInfo *m, const int16_t *coeffs, uint32_t nzy,
                        uint32_t nzuv, int mb_x, int mb_y, Planes *pl)
{
    uint8_t ws[17 * YS], wc[9 * US];
    int x0 = 16 * mb_x, y0 = 16 * mb_y, y, n, ch;
    int s = YS;
    memset(ws, 0, sizeof(ws));
    if (mb_y == 0) {
        memset(ws, 127, 21);
    } else {
        const uint8_t *above = pl->y + (size_t)(y0 - 1) * pl->ys + x0;
        ws[0] = mb_x == 0 ? 129 : above[-1];
        memcpy(ws + 1, above, 16);
        if (mb_x == h->mb_w - 1) memset(ws + 17, above[15], 4);
        else memcpy(ws + 17, above + 16, 4);
    }
    for (y = 0; y < 16; y++)
        ws[(y + 1) * s] = mb_x == 0 ? 129 : pl->y[(size_t)(y0 + y) * pl->ys + x0 - 1];
    if (m->i4x4) {
        for (y = 4; y <= 12; y += 4) memcpy(ws + y * s + 17, ws + 17, 4);
        for (n = 0; n < 16; n++) {
            uint8_t *d = ws + (4 * (n >> 2) + 1) * s + 4 * (n & 3) + 1;
            predict4(m->modes[n], d, s);
            luma_transform(nzy >> (30 - 2 * n), coeffs + 16 * n, d, s);
        }
    } else {
        predict_block(m->modes[0], ws, 16, s, mb_x, mb_y);
        for (n = 0; n < 16; n++)
            luma_transform(nzy >> (30 - 2 * n), coeffs + 16 * n,
                           ws + (4 * (n >> 2) + 1) * s + 4 * (n & 3) + 1, s);
    }
    for (y = 0; y < 16; y++)
        memcpy(pl->y + (size_t)(y0 + y) * pl->ys + x0, ws + (y + 1) * s + 1, 16);
    s = US;
    for (ch = 0; ch < 2; ch++) {
        uint8_t *plane = ch ? pl->v : pl->u;
        int cx = 8 * mb_x, cy = 8 * mb_y;
        memset(wc, 0, sizeof(wc));
        if (mb_y == 0) {
            memset(wc, 127, 9);
        } else {
            const uint8_t *above = plane + (size_t)(cy - 1) * pl->uvs + cx;
            wc[0] = mb_x == 0 ? 129 : above[-1];
            memcpy(wc + 1, above, 8);
        }
        for (y = 0; y < 8; y++)
            wc[(y + 1) * s] = mb_x == 0 ? 129 : plane[(size_t)(cy + y) * pl->uvs + cx - 1];
        predict_block(m->uvmode, wc, 8, s, mb_x, mb_y);
        for (n = 0; n < 4; n++) {
            const int16_t *cf = coeffs + 256 + 64 * ch + 16 * n;
            uint8_t *d = wc + (4 * (n >> 1) + 1) * s + 4 * (n & 1) + 1;
            uint32_t bits = (nzuv >> (8 * ch)) & 0xff;
            if (bits & 0xaa) idct_add_simd(cf, d, s); /* any AC: all four */
            else if (bits && cf[0]) idct_add(cf, d, s);
        }
        for (y = 0; y < 8; y++)
            memcpy(plane + (size_t)(cy + y) * pl->uvs + cx, wc + (y + 1) * s + 1, 8);
    }
}

static int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
static int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

static void do_filter2(uint8_t *p, int st)
{
    int p1 = p[-2 * st], p0 = p[-st], q0 = p[0], q1 = p[st];
    int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-st] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

static void do_filter4(uint8_t *p, int st)
{
    int p1 = p[-2 * st], p0 = p[-st], q0 = p[0], q1 = p[st];
    int a = 3 * (q0 - p0);
    int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
    p[-2 * st] = clip8(p1 + a3);
    p[-st] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[st] = clip8(q1 - a3);
}

static void do_filter6(uint8_t *p, int st)
{
    int p2 = p[-3 * st], p1 = p[-2 * st], p0 = p[-st];
    int q0 = p[0], q1 = p[st], q2 = p[2 * st];
    int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
    p[-3 * st] = clip8(p2 + a3);
    p[-2 * st] = clip8(p1 + a2);
    p[-st] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[st] = clip8(q1 - a2);
    p[2 * st] = clip8(q2 - a3);
}

static void simple_edge(uint8_t *p, int hstep, int vstep, int thresh)
{
    int i, t2 = 2 * thresh + 1;
    for (i = 0; i < 16; i++, p += vstep)
        if (4 * abs(p[-hstep] - p[0]) + abs(p[-2 * hstep] - p[hstep]) <= t2) do_filter2(p, hstep);
}

static void complex_edge(uint8_t *p, int hs, int vs, int size, int thresh, int it, int hev_t,
                         int mb_edge)
{
    int i, t2 = 2 * thresh + 1;
    for (i = 0; i < size; i++, p += vs) {
        int p3 = p[-4 * hs], p2 = p[-3 * hs], p1 = p[-2 * hs], p0 = p[-hs];
        int q0 = p[0], q1 = p[hs], q2 = p[2 * hs], q3 = p[3 * hs];
        if (4 * abs(p0 - q0) + abs(p1 - q1) > t2) continue;
        if (abs(p3 - p2) > it || abs(p2 - p1) > it || abs(p1 - p0) > it || abs(q3 - q2) > it ||
            abs(q2 - q1) > it || abs(q1 - q0) > it)
            continue;
        if (abs(p1 - p0) > hev_t || abs(q1 - q0) > hev_t) do_filter2(p, hs);
        else if (mb_edge) do_filter6(p, hs);
        else do_filter4(p, hs);
    }
}

typedef struct {
    int limit, ilevel, hev_t, inner;
} FInfo;

static void filter_mb(const Vp8 *h, const FInfo *f, int mb_x, int mb_y, Planes *pl)
{
    uint8_t *y0, *u0, *v0;
    int k, ys = pl->ys, uvs = pl->uvs;
    if (f->limit == 0) return;
    y0 = pl->y + (size_t)16 * mb_y * ys + 16 * mb_x;
    if (h->filter_type == 1) {
        if (mb_x > 0) simple_edge(y0, 1, ys, f->limit + 4);
        if (f->inner)
            for (k = 4; k < 16; k += 4) simple_edge(y0 + k, 1, ys, f->limit);
        if (mb_y > 0) simple_edge(y0, ys, 1, f->limit + 4);
        if (f->inner)
            for (k = 4; k < 16; k += 4) simple_edge(y0 + k * ys, ys, 1, f->limit);
        return;
    }
    u0 = pl->u + (size_t)8 * mb_y * uvs + 8 * mb_x;
    v0 = pl->v + (size_t)8 * mb_y * uvs + 8 * mb_x;
    if (mb_x > 0) {
        complex_edge(y0, 1, ys, 16, f->limit + 4, f->ilevel, f->hev_t, 1);
        complex_edge(u0, 1, uvs, 8, f->limit + 4, f->ilevel, f->hev_t, 1);
        complex_edge(v0, 1, uvs, 8, f->limit + 4, f->ilevel, f->hev_t, 1);
    }
    if (f->inner) {
        for (k = 4; k < 16; k += 4) complex_edge(y0 + k, 1, ys, 16, f->limit, f->ilevel, f->hev_t, 0);
        complex_edge(u0 + 4, 1, uvs, 8, f->limit, f->ilevel, f->hev_t, 0);
        complex_edge(v0 + 4, 1, uvs, 8, f->limit, f->ilevel, f->hev_t, 0);
    }
    if (mb_y > 0) {
        complex_edge(y0, ys, 1, 16, f->limit + 4, f->ilevel, f->hev_t, 1);
        complex_edge(u0, uvs, 1, 8, f->limit + 4, f->ilevel, f->hev_t, 1);
        complex_edge(v0, uvs, 1, 8, f->limit + 4, f->ilevel, f->hev_t, 1);
    }
    if (f->inner) {
        for (k = 4; k < 16; k += 4)
            complex_edge(y0 + k * ys, ys, 1, 16, f->limit, f->ilevel, f->hev_t, 0);
        complex_edge(u0 + 4 * uvs, uvs, 1, 8, f->limit, f->ilevel, f->hev_t, 0);
        complex_edge(v0 + 4 * uvs, uvs, 1, 8, f->limit, f->ilevel, f->hev_t, 0);
    }
}

static void filter_strengths(const Vp8 *h, FInfo out[4][2])
{
    int s, i4x4;
    for (s = 0; s < 4; s++) {
        int base = h->use_segment ? h->seg_filter[s] + (h->absolute ? 0 : h->level) : h->level;
        for (i4x4 = 0; i4x4 < 2; i4x4++) {
            FInfo *f = &out[s][i4x4];
            int level = base;
            if (h->use_lf_delta) level += h->ref_delta0 + (i4x4 ? h->mode_delta0 : 0);
            level = level < 0 ? 0 : level > 63 ? 63 : level;
            f->inner = i4x4;
            if (level > 0) {
                int ilevel = level;
                if (h->sharpness > 0) {
                    ilevel >>= h->sharpness > 4 ? 2 : 1;
                    if (ilevel > 9 - h->sharpness) ilevel = 9 - h->sharpness;
                }
                if (ilevel < 1) ilevel = 1;
                f->ilevel = ilevel;
                f->limit = 2 * level + ilevel;
                f->hev_t = level >= 40 ? 2 : level >= 15 ? 1 : 0;
            } else {
                f->limit = f->ilevel = f->hev_t = 0;
            }
        }
    }
}

/* UpsampleRgbLinePair on one chroma plane: the row nearer `top` and the
 * row nearer `cur`, `width` values each. */
static void upsample_pair(const uint8_t *top, const uint8_t *cur, int width, int *near_top,
                          int *near_cur)
{
    int x, pairs = (width - 1) >> 1;
    int tl = top[0], l = cur[0];
    near_top[0] = (3 * tl + l + 2) >> 2;
    near_cur[0] = (3 * l + tl + 2) >> 2;
    for (x = 1; x <= pairs; x++) {
        int t = top[x], uv = cur[x];
        int avg = tl + t + l + uv + 8;
        int diag12 = (avg + 2 * (t + l)) >> 3, diag03 = (avg + 2 * (tl + uv)) >> 3;
        near_top[2 * x - 1] = (diag12 + tl) >> 1;
        near_top[2 * x] = (diag03 + t) >> 1;
        near_cur[2 * x - 1] = (diag03 + l) >> 1;
        near_cur[2 * x] = (diag12 + uv) >> 1;
        tl = t;
        l = uv;
    }
    if (!(width & 1)) {
        near_top[width - 1] = (3 * tl + l + 2) >> 2;
        near_cur[width - 1] = (3 * l + tl + 2) >> 2;
    }
}

static uint8_t yuv_clip(int v) { return (uint8_t)((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }

static void yuv_row(const uint8_t *y, const int *u, const int *v, int width, uint8_t *rgb)
{
    int x;
    for (x = 0; x < width; x++) {
        int yy = (y[x] * 19077) >> 8;
        rgb[3 * x] = yuv_clip(yy + ((v[x] * 26149) >> 8) - 14234);
        rgb[3 * x + 1] = yuv_clip(yy - ((u[x] * 6419) >> 8) - ((v[x] * 13320) >> 8) + 8708);
        rgb[3 * x + 2] = yuv_clip(yy + ((u[x] * 33050) >> 8) - 17685);
    }
}

static void to_rgb(Ctx *c, const Planes *pl, int width, int height, uint8_t *rgb)
{
    int *ut = (int *)alloc(c, (size_t)width * sizeof(int)), *uc = (int *)alloc(c, (size_t)width * sizeof(int));
    int *vt = (int *)alloc(c, (size_t)width * sizeof(int)), *vc = (int *)alloc(c, (size_t)width * sizeof(int));
    int k, pairs = (height - 1) / 2;
    size_t row = (size_t)3 * width;
    upsample_pair(pl->u, pl->u, width, ut, uc);
    upsample_pair(pl->v, pl->v, width, vt, vc);
    yuv_row(pl->y, ut, vt, width, rgb);
    for (k = 0; k < pairs; k++) {
        const uint8_t *u0 = pl->u + (size_t)k * pl->uvs, *v0 = pl->v + (size_t)k * pl->uvs;
        upsample_pair(u0, u0 + pl->uvs, width, ut, uc);
        upsample_pair(v0, v0 + pl->uvs, width, vt, vc);
        yuv_row(pl->y + (size_t)(2 * k + 1) * pl->ys, ut, vt, width, rgb + (2 * k + 1) * row);
        yuv_row(pl->y + (size_t)(2 * k + 2) * pl->ys, uc, vc, width, rgb + (2 * k + 2) * row);
    }
    if (height > 1 && !(height & 1)) {
        const uint8_t *u0 = pl->u + (size_t)pairs * pl->uvs, *v0 = pl->v + (size_t)pairs * pl->uvs;
        upsample_pair(u0, u0, width, ut, uc);
        upsample_pair(v0, v0, width, vt, vc);
        yuv_row(pl->y + (size_t)(height - 1) * pl->ys, ut, vt, width, rgb + (height - 1) * row);
    }
}

int vp8_decode(const uint8_t *data, long len, int width, int height, uint8_t *rgb, char *err,
               int errlen)
{
    Ctx c;
    Vp8 *h;
    Planes pl;
    FInfo strengths[4][2], *filters;
    uint8_t *top_modes, left_modes[4];
    int (*nz)[2], mb_x, mb_y, rc;
    MbInfo *row;
    int16_t coeffs[384];
    memset(&c, 0, sizeof(c));
    c.err = err;
    c.errlen = errlen;
    if ((rc = setjmp(c.jump)) != 0) {
        release(&c);
        return rc;
    }
    h = (Vp8 *)alloc(&c, sizeof(Vp8));
    vp8_header(&c, h, data, (size_t)len);
    if (h->width != width || h->height != height) fail(&c, "VP8 size differs from the caller's");
    pl.ys = 16 * h->mb_w;
    pl.uvs = 8 * h->mb_w;
    pl.y = (uint8_t *)alloc(&c, (size_t)pl.ys * 16 * h->mb_h);
    pl.u = (uint8_t *)alloc(&c, (size_t)pl.uvs * 8 * h->mb_h);
    pl.v = (uint8_t *)alloc(&c, (size_t)pl.uvs * 8 * h->mb_h);
    filter_strengths(h, strengths);
    filters = (FInfo *)alloc(&c, (size_t)h->mb_w * h->mb_h * sizeof(FInfo));
    top_modes = (uint8_t *)alloc(&c, (size_t)4 * h->mb_w); /* DC is 0 */
    nz = (int(*)[2])alloc(&c, (size_t)(h->mb_w + 1) * sizeof(*nz));
    row = (MbInfo *)alloc(&c, (size_t)h->mb_w * sizeof(MbInfo));
    for (mb_y = 0; mb_y < h->mb_h; mb_y++) {
        BoolReader *part = &h->parts[mb_y & (h->nparts - 1)];
        memset(left_modes, DC, sizeof(left_modes));
        for (mb_x = 0; mb_x < h->mb_w; mb_x++)
            intra_modes(h, top_modes + 4 * mb_x, left_modes, &row[mb_x]);
        if (h->br.eof) fail(&c, "VP8 first partition ends early");
        nz[h->mb_w][0] = nz[h->mb_w][1] = 0;
        for (mb_x = 0; mb_x < h->mb_w; mb_x++) {
            MbInfo *m = &row[mb_x];
            FInfo *f = &filters[(size_t)mb_y * h->mb_w + mb_x];
            uint32_t nzy = 0, nzuv = 0;
            memset(coeffs, 0, sizeof(coeffs));
            if (!(h->use_skip && m->skip)) {
                residuals(h, part, (const int(*)[2])h->quant[m->segment], m->i4x4, nz[mb_x],
                          nz[h->mb_w], coeffs, &nzy, &nzuv);
            } else {
                nz[mb_x][0] = nz[h->mb_w][0] = 0;
                if (!m->i4x4) nz[mb_x][1] = nz[h->mb_w][1] = 0;
            }
            if (part->eof) fail(&c, "VP8 token partition ends early");
            *f = strengths[m->segment][m->i4x4];
            f->inner = m->i4x4 || nzy || nzuv;
            reconstruct(h, m, coeffs, nzy, nzuv, mb_x, mb_y, &pl);
        }
    }
    if (h->filter_type)
        for (mb_y = 0; mb_y < h->mb_h; mb_y++)
            for (mb_x = 0; mb_x < h->mb_w; mb_x++)
                filter_mb(h, &filters[(size_t)mb_y * h->mb_w + mb_x], mb_x, mb_y, &pl);
    to_rgb(&c, &pl, width, height, rgb);
    release(&c);
    return 0;
}

/* --- VP8L encoding -------------------------------------------------------- */

#define PREDICTOR_BITS 4
#define MAX_LENGTH 4096
#define MAX_DISTANCE ((1 << 20) - 120)
#define HASH_BITS 16
#define CHAIN 32
#define MIN_MATCH 3

typedef struct {
    uint8_t *out;
    size_t cap, n;
    uint64_t acc;
    int nbits;
} Writer;

static void put(Writer *w, uint32_t value, int bits)
{
    w->acc |= (uint64_t)value << w->nbits;
    w->nbits += bits;
    while (w->nbits >= 8) {
        if (w->n < w->cap) w->out[w->n] = (uint8_t)w->acc;
        w->n++;
        w->acc >>= 8;
        w->nbits -= 8;
    }
}

/* floor(log2(x) * 65536) in integer arithmetic (utils/vp8l.py log2_q16). */
static int64_t log2_q16(uint32_t x)
{
    int n = 0, i;
    uint64_t y;
    int64_t frac = 0;
    while ((x >> n) > 1) n++;
    y = n <= 30 ? (uint64_t)x << (30 - n) : (uint64_t)x >> (n - 30);
    for (i = 0; i < 16; i++) {
        y = (y * y) >> 30;
        frac <<= 1;
        if (y >= (2ull << 30)) {
            y >>= 1;
            frac |= 1;
        }
    }
    return ((int64_t)n << 16) | frac;
}

typedef struct {
    uint64_t w;
    int s;
} Leaf;

static int leaf_cmp(const void *a, const void *b)
{
    const Leaf *x = (const Leaf *)a, *y = (const Leaf *)b;
    if (x->w != y->w) return x->w < y->w ? -1 : 1;
    return x->s < y->s ? -1 : x->s > y->s;
}

/* Huffman code lengths of at most `limit` bits (vp8l.py _huffman_lengths). */
static void huffman_lengths(Ctx *c, const uint32_t *counts, int size, int limit, int *lengths)
{
    int nsym = 0, s, k;
    uint64_t floor = 1;
    Leaf *leaves = (Leaf *)alloc(c, (size_t)size * sizeof(Leaf));
    uint64_t *nodes = (uint64_t *)alloc(c, (size_t)size * sizeof(uint64_t));
    int *parent = (int *)alloc(c, (size_t)2 * size * sizeof(int));
    int *depth = (int *)alloc(c, (size_t)2 * size * sizeof(int));
    memset(lengths, 0, (size_t)size * sizeof(int));
    for (s = 0; s < size; s++) nsym += counts[s] != 0;
    if (nsym == 1) {
        for (s = 0; s < size; s++)
            if (counts[s]) lengths[s] = 1;
        return;
    }
    for (;;) {
        int n = 0, li = 0, ni = 0, maxd = 0, total;
        for (s = 0; s < size; s++)
            if (counts[s]) {
                leaves[n].w = counts[s] > floor ? counts[s] : floor;
                leaves[n++].s = s;
            }
        qsort(leaves, (size_t)n, sizeof(Leaf), leaf_cmp);
        total = 2 * n - 1;
        for (k = 0; k < n - 1; k++) {
            int pick, j;
            uint64_t w = 0;
            for (j = 0; j < 2; j++) {
                if (li < n && (ni >= k || leaves[li].w <= nodes[ni])) {
                    pick = li;
                    w += leaves[li++].w;
                } else {
                    pick = n + ni;
                    w += nodes[ni++];
                }
                parent[pick] = n + k;
            }
            nodes[k] = w;
        }
        depth[total - 1] = 0;
        for (k = total - 2; k >= 0; k--) depth[k] = depth[parent[k]] + 1;
        for (k = 0; k < n; k++)
            if (depth[k] > maxd) maxd = depth[k];
        if (maxd <= limit) {
            for (k = 0; k < n; k++) lengths[leaves[k].s] = depth[k];
            return;
        }
        floor *= 2;
    }
}

typedef struct {
    int *lengths;
    uint32_t *codes;
    int single;
} WCode;

static void make_wcode(Ctx *c, WCode *wc, const int *lengths, int size)
{
    int n, s, nsym = 0, prev = 0;
    uint32_t code = 0;
    wc->lengths = (int *)alloc(c, (size_t)size * sizeof(int));
    wc->codes = (uint32_t *)alloc(c, (size_t)size * sizeof(uint32_t));
    memcpy(wc->lengths, lengths, (size_t)size * sizeof(int));
    for (s = 0; s < size; s++) nsym += lengths[s] != 0;
    wc->single = nsym <= 1;
    if (wc->single) return;
    for (n = 1; n < 16; n++)
        for (s = 0; s < size; s++)
            if (lengths[s] == n) {
                code <<= n - prev;
                prev = n;
                wc->codes[s] = reverse_bits(code, n);
                code++;
            }
}

static void put_symbol(Writer *w, const WCode *wc, int s)
{
    if (!wc->single) put(w, wc->codes[s], wc->lengths[s]);
}

/* Code lengths → code-length tokens (vp8l.py _length_tokens): symbol,
 * extra bits, extra value. Returns the count. */
static int length_tokens(const int *lengths, int n, int (*tok)[3])
{
    int i = 0, nt = 0, prev = 8;
    while (i < n) {
        int v = lengths[i], run = 1;
        while (i + run < n && lengths[i + run] == v) run++;
        i += run;
        if (v == 0) {
            while (run >= 3) {
                int k = run < 138 ? run : 138;
                if (k >= 11) {
                    tok[nt][0] = 18;
                    tok[nt][1] = 7;
                    tok[nt++][2] = k - 11;
                } else {
                    tok[nt][0] = 17;
                    tok[nt][1] = 3;
                    tok[nt++][2] = k - 3;
                }
                run -= k;
            }
            while (run-- > 0) {
                tok[nt][0] = 0;
                tok[nt][1] = tok[nt][2] = 0;
                nt++;
            }
            continue;
        }
        if (v != prev) {
            tok[nt][0] = v;
            tok[nt][1] = tok[nt][2] = 0;
            nt++;
            prev = v;
            run--;
        }
        while (run >= 3) {
            int k = run < 6 ? run : 6;
            tok[nt][0] = 16;
            tok[nt][1] = 2;
            tok[nt++][2] = k - 3;
            run -= k;
        }
        while (run-- > 0) {
            tok[nt][0] = v;
            tok[nt][1] = tok[nt][2] = 0;
            nt++;
        }
    }
    return nt;
}

static void write_code(Ctx *c, Writer *w, const uint32_t *counts, int size, WCode *wc)
{
    int used[3], nused = 0, s, i, nt, num;
    int *lengths = (int *)alloc(c, (size_t)size * sizeof(int));
    for (s = 0; s < size && nused < 3; s++)
        if (counts[s]) used[nused++] = s;
    if (nused == 0) used[nused++] = 0;
    if (nused <= 2 && used[nused - 1] < 256) {
        put(w, 1, 1);
        put(w, (uint32_t)nused - 1, 1);
        if (used[0] < 2) {
            put(w, 0, 1);
            put(w, (uint32_t)used[0], 1);
        } else {
            put(w, 1, 1);
            put(w, (uint32_t)used[0], 8);
        }
        if (nused == 2) put(w, (uint32_t)used[1], 8);
        for (i = 0; i < nused; i++) lengths[used[i]] = 1;
        make_wcode(c, wc, lengths, size);
        return;
    }
    {
        int (*tok)[3] = (int(*)[3])alloc(c, (size_t)size * sizeof(*tok));
        uint32_t hist[19];
        int cl[19];
        WCode clcode;
        huffman_lengths(c, counts, size, 15, lengths);
        nt = length_tokens(lengths, size, tok);
        memset(hist, 0, sizeof(hist));
        for (i = 0; i < nt; i++) hist[tok[i][0]]++;
        huffman_lengths(c, hist, 19, 7, cl);
        num = 4;
        for (i = 0; i < 19; i++)
            if (cl[kCodeLengthOrder[i]] && i + 1 > num) num = i + 1;
        put(w, 0, 1);
        put(w, (uint32_t)num - 4, 4);
        for (i = 0; i < num; i++) put(w, (uint32_t)cl[kCodeLengthOrder[i]], 3);
        put(w, 0, 1);
        make_wcode(c, &clcode, cl, 19);
        for (i = 0; i < nt; i++) {
            put_symbol(w, &clcode, tok[i][0]);
            if (tok[i][1]) put(w, (uint32_t)tok[i][2], tok[i][1]);
        }
        make_wcode(c, wc, lengths, size);
    }
}

static void prefix_encode(int value, int *sym, int *bits, int *extra)
{
    int d, high = 0;
    if (value <= 4) {
        *sym = value - 1;
        *bits = *extra = 0;
        return;
    }
    d = value - 1;
    while ((d >> high) > 1) high++;
    *bits = high - 1;
    *sym = 2 * high + ((d >> (high - 1)) & 1);
    *extra = d & ((1 << (high - 1)) - 1);
}

static int distance_code(int xsize, int dist)
{
    static int plane_to_code[128];
    static int ready = 0;
    int y = dist / xsize, x = dist - y * xsize;
    if (!ready) {
        int i;
        for (i = 0; i < 120; i++) plane_to_code[kCodeToPlane[i]] = i;
        ready = 1;
    }
    if (x <= 8 && y < 8) return plane_to_code[y * 16 + 8 - x] + 1;
    if (x > xsize - 8 && y < 7) return plane_to_code[(y + 1) * 16 + 8 + xsize - x] + 1;
    return dist + 120;
}

static uint32_t lz_hash(uint32_t a, uint32_t b)
{
    return (((a * 0x1e35a7bdu) ^ b) * 0x9e3779b1u) >> (32 - HASH_BITS);
}

/* Greedy LZ77 (vp8l.py _lz77): len[i] 0 for a literal, else a copy of
 * len[i] pixels from dist[i] back; returns the token count. */
static size_t lz77(Ctx *c, const uint32_t *px, size_t n, int xsize, int *len, int *dist)
{
    int32_t *head = (int32_t *)alloc(c, sizeof(int32_t) << HASH_BITS);
    int32_t *prev = (int32_t *)alloc(c, (n ? n : 1) * sizeof(int32_t));
    size_t i = 0, nt = 0, k;
    memset(head, 0xff, sizeof(int32_t) << HASH_BITS);
#define INSERT(p)                                          \
    do {                                                   \
        if ((p) + 1 < n) {                                 \
            uint32_t h_ = lz_hash(px[(p)], px[(p) + 1]);   \
            prev[(p)] = head[h_];                          \
            head[h_] = (int32_t)(p);                       \
        }                                                  \
    } while (0)
    while (i < n) {
        int best_len = 0, best_dist = 0;
        if (i + 1 < n) {
            size_t limit = n - i < MAX_LENGTH ? n - i : MAX_LENGTH;
            int ds[2], j, tries = 0;
            int32_t cand;
            ds[0] = 1;
            ds[1] = xsize;
            for (j = 0; j < 2; j++)
                if ((size_t)ds[j] <= i) {
                    size_t m = 0;
                    while (m < limit && px[i + m] == px[i - ds[j] + m]) m++;
                    if ((int)m > best_len) {
                        best_len = (int)m;
                        best_dist = ds[j];
                    }
                }
            cand = head[lz_hash(px[i], px[i + 1])];
            while (cand >= 0 && tries < CHAIN && i - (size_t)cand <= MAX_DISTANCE) {
                int d = (int)(i - (size_t)cand);
                if (d != 1 && d != xsize) {
                    size_t m = 0;
                    while (m < limit && px[i + m] == px[(size_t)cand + m]) m++;
                    if ((int)m > best_len) {
                        best_len = (int)m;
                        best_dist = d;
                    }
                }
                cand = prev[cand];
                tries++;
            }
        }
        if (best_len >= MIN_MATCH) {
            len[nt] = best_len;
            dist[nt++] = best_dist;
            for (k = 0; k < (size_t)best_len; k++) INSERT(i + k);
            i += (size_t)best_len;
        } else {
            len[nt] = 0;
            dist[nt++] = (int)px[i];
            INSERT(i);
            i++;
        }
    }
#undef INSERT
    return nt;
}

static void write_image(Ctx *c, Writer *w, const uint32_t *img, int xsize, int ysize, int level0)
{
    size_t n = (size_t)xsize * ysize, nt, i;
    int *len = (int *)alloc(c, n * sizeof(int)), *dist = (int *)alloc(c, n * sizeof(int));
    uint32_t *counts[5];
    int sizes[5] = {NUM_LITERAL + NUM_LENGTH, 256, 256, 256, NUM_DISTANCE}, j;
    WCode codes[5];
    put(w, 0, 1); /* no colour cache */
    if (level0) put(w, 0, 1); /* no meta prefix codes */
    nt = lz77(c, img, n, xsize, len, dist);
    for (j = 0; j < 5; j++) counts[j] = (uint32_t *)alloc(c, (size_t)sizes[j] * sizeof(uint32_t));
    for (i = 0; i < nt; i++) {
        if (!len[i]) {
            uint32_t t = (uint32_t)dist[i];
            counts[0][(t >> 8) & 255]++;
            counts[1][(t >> 16) & 255]++;
            counts[2][t & 255]++;
            counts[3][t >> 24]++;
        } else {
            int sym, bits, extra;
            prefix_encode(len[i], &sym, &bits, &extra);
            counts[0][NUM_LITERAL + sym]++;
            prefix_encode(distance_code(xsize, dist[i]), &sym, &bits, &extra);
            counts[4][sym]++;
        }
    }
    for (j = 0; j < 5; j++) write_code(c, w, counts[j], sizes[j], &codes[j]);
    for (i = 0; i < nt; i++) {
        if (!len[i]) {
            uint32_t t = (uint32_t)dist[i];
            put_symbol(w, &codes[0], (int)((t >> 8) & 255));
            put_symbol(w, &codes[1], (int)((t >> 16) & 255));
            put_symbol(w, &codes[2], (int)(t & 255));
            put_symbol(w, &codes[3], (int)(t >> 24));
        } else {
            int sym, bits, extra;
            prefix_encode(len[i], &sym, &bits, &extra);
            put_symbol(w, &codes[0], NUM_LITERAL + sym);
            put(w, (uint32_t)extra, bits);
            prefix_encode(distance_code(xsize, dist[i]), &sym, &bits, &extra);
            put_symbol(w, &codes[4], sym);
            put(w, (uint32_t)extra, bits);
        }
    }
}

/* Per 16x16 tile the predictor mode (0-13) of least residual entropy;
 * writes the residuals into res and the modes into modes. */
static void predictor_residuals(Ctx *c, const uint32_t *p, int w, int h, uint32_t *modes,
                                uint32_t *res)
{
    static int64_t xlogx[257];
    int tw = subsample(w, PREDICTOR_BITS), th = subsample(h, PREDICTOR_BITS), tx, ty;
    uint32_t(*hist)[256] = (uint32_t(*)[256])alloc(c, 4 * 256 * sizeof(uint32_t));
    if (!xlogx[2]) {
        int k;
        for (k = 1; k <= 256; k++) xlogx[k] = (int64_t)k * log2_q16((uint32_t)k);
    }
    for (ty = 0; ty < th; ty++)
        for (tx = 0; tx < tw; tx++) {
            int64_t best = -1;
            int best_mode = 0, pass;
            for (pass = 0; pass < 15; pass++) {
                int m = pass < 14 ? pass : best_mode, x, y, s, k;
                int64_t score = 0;
                if (pass < 14) memset(hist, 0, 4 * 256 * sizeof(uint32_t));
                for (y = ty << PREDICTOR_BITS; y < h && y < (ty + 1) << PREDICTOR_BITS; y++)
                    for (x = tx << PREDICTOR_BITS; x < w && x < (tx + 1) << PREDICTOR_BITS; x++) {
                        size_t i = (size_t)y * w + x;
                        uint32_t pred, r;
                        if (x > 0 && y > 0) pred = predict(m, p[i - 1], p[i - w], p[i - w + 1], p[i - w - 1]);
                        else if (y == 0) pred = x == 0 ? 0xff000000u : p[i - 1];
                        else pred = p[i - w];
                        r = sub_pixels(p[i], pred);
                        if (pass == 14) {
                            res[i] = r;
                            continue;
                        }
                        for (s = 0; s < 4; s++) hist[s][(r >> (8 * s)) & 255]++;
                    }
                if (pass == 14) break;
                for (s = 0; s < 4; s++)
                    for (k = 0; k < 256; k++) score += xlogx[hist[s][k]];
                if (score > best) {
                    best = score;
                    best_mode = m;
                }
            }
            modes[(size_t)ty * tw + tx] = 0xff000000u | ((uint32_t)best_mode << 8);
        }
}

static int colour_cmp(const void *a, const void *b)
{
    uint32_t x = *(const uint32_t *)a, y = *(const uint32_t *)b;
    return x < y ? -1 : x > y;
}

/* The sorted distinct colours if there are at most 256, else 0. */
static int palette_of(const uint32_t *argb, size_t n, uint32_t *palette)
{
    uint32_t table[1024];
    uint8_t used[1024];
    int count = 0;
    size_t i;
    memset(used, 0, sizeof(used));
    for (i = 0; i < n; i++) {
        uint32_t k = (argb[i] * 0x9e3779b1u) >> 22;
        while (used[k] && table[k] != argb[i]) k = (k + 1) & 1023;
        if (!used[k]) {
            if (count == 256) return 0;
            used[k] = 1;
            table[k] = argb[i];
            palette[count++] = argb[i];
        }
    }
    qsort(palette, (size_t)count, sizeof(uint32_t), colour_cmp);
    return count;
}

static void put_header(Writer *w, int width, int height)
{
    put(w, 0x2f, 8);
    put(w, (uint32_t)width - 1, 14);
    put(w, (uint32_t)height - 1, 14);
    put(w, 0, 1); /* alpha_is_used */
    put(w, 0, 3); /* version */
}

static void flush(Writer *w)
{
    if (w->nbits) put(w, 0, 8 - w->nbits);
}

static void encode_palette(Ctx *c, Writer *wr, const uint32_t *argb, int w, int h,
                           const uint32_t *palette, int ncol)
{
    int bits = ncol > 16 ? 0 : ncol > 4 ? 1 : ncol > 2 ? 2 : 3, x, y, iw;
    int per = 1 << bits, depth = 8 >> bits;
    uint32_t delta[256], *image;
    size_t i;
    put_header(wr, w, h);
    put(wr, 1, 1);
    put(wr, 3, 2);
    put(wr, (uint32_t)ncol - 1, 8);
    delta[0] = palette[0];
    for (x = 1; x < ncol; x++) delta[x] = sub_pixels(palette[x], palette[x - 1]);
    write_image(c, wr, delta, ncol, 1, 0);
    iw = subsample(w, bits);
    image = (uint32_t *)alloc(c, (size_t)iw * h * sizeof(uint32_t));
    for (y = 0; y < h; y++)
        for (x = 0; x < w; x++) {
            uint32_t v = argb[(size_t)y * w + x];
            int lo = 0, hi = ncol - 1;
            while (lo < hi) {
                int mid = (lo + hi) / 2;
                if (palette[mid] < v) lo = mid + 1;
                else hi = mid;
            }
            image[(size_t)y * iw + x / per] |= (uint32_t)lo << (8 + (x % per) * depth);
        }
    for (i = 0; i < (size_t)iw * h; i++) image[i] |= 0xff000000u;
    put(wr, 0, 1);
    write_image(c, wr, image, iw, h, 1);
    flush(wr);
}

static void encode_predicted(Ctx *c, Writer *wr, const uint32_t *argb, int w, int h,
                             int subtract_green)
{
    int tw = subsample(w, PREDICTOR_BITS), th = subsample(h, PREDICTOR_BITS);
    size_t n = (size_t)w * h, i;
    uint32_t *modes = (uint32_t *)alloc(c, (size_t)tw * th * sizeof(uint32_t));
    uint32_t *p = (uint32_t *)alloc(c, n * sizeof(uint32_t));
    uint32_t *image = (uint32_t *)alloc(c, n * sizeof(uint32_t));
    put_header(wr, w, h);
    memcpy(p, argb, n * sizeof(uint32_t));
    if (subtract_green) {
        put(wr, 1, 1);
        put(wr, 2, 2);
        for (i = 0; i < n; i++) {
            uint32_t v = p[i], g = (v >> 8) & 255;
            p[i] = (v & 0xff00ff00u) | ((((v >> 16) - g) & 255) << 16) | ((v - g) & 255);
        }
    }
    put(wr, 1, 1);
    put(wr, 0, 2);
    put(wr, PREDICTOR_BITS - 2, 3);
    predictor_residuals(c, p, w, h, modes, image);
    write_image(c, wr, modes, tw, th, 0);
    put(wr, 0, 1);
    write_image(c, wr, image, w, h, 1);
    flush(wr);
}

static void writer_init(Writer *w, uint8_t *out, size_t cap)
{
    w->out = out;
    w->cap = cap;
    w->n = 0;
    w->acc = 0;
    w->nbits = 0;
}

int vp8l_encode(const uint8_t *rgb, int h, int w, uint8_t *out, long cap, long *size)
{
    Ctx c;
    Writer wr;
    uint32_t *argb, palette[256];
    size_t n = (size_t)h * w, i;
    int ncol, rc;
    memset(&c, 0, sizeof(c));
    if ((rc = setjmp(c.jump)) != 0) {
        release(&c);
        return rc;
    }
    argb = (uint32_t *)alloc(&c, n * sizeof(uint32_t));
    for (i = 0; i < n; i++)
        argb[i] = 0xff000000u | ((uint32_t)rgb[3 * i] << 16) | ((uint32_t)rgb[3 * i + 1] << 8) |
                  rgb[3 * i + 2];
    ncol = palette_of(argb, n, palette);
    {
        /* Subtract-green or not: both written, the shorter kept; then the
         * palette's stream where there is one and it is no longer. */
        Writer alt;
        writer_init(&wr, out, (size_t)cap);
        encode_predicted(&c, &wr, argb, w, h, 1);
        writer_init(&alt, (uint8_t *)alloc(&c, (size_t)cap), (size_t)cap);
        encode_predicted(&c, &alt, argb, w, h, 0);
        if (alt.n < wr.n) {
            if (alt.n <= alt.cap) memcpy(out, alt.out, alt.n);
            wr = alt;
            wr.out = out;
        }
        if (ncol) {
            writer_init(&alt, (uint8_t *)alloc(&c, (size_t)cap), (size_t)cap);
            encode_palette(&c, &alt, argb, w, h, palette, ncol);
            if (alt.n <= wr.n) {
                if (alt.n <= alt.cap) memcpy(out, alt.out, alt.n);
                wr = alt;
                wr.out = out;
            }
        }
    }
    *size = (long)wr.n;
    release(&c);
    return wr.n > wr.cap ? 1 : 0;
}
