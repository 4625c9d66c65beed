"""VP8L, WebP's lossless bitstream: the plain NumPy/Python version of the
host C coder in `csrc/webp.c` (`webp.c vp8l_decode`, `vp8l_encode`).

`decode` reads a VP8L stream as libwebp 1.6 (`src/dec/vp8l_dec.c`) does,
to ARGB words: the transforms (predictor with all 14 modes, cross-colour,
subtract-green, colour indexing with pixel bundling), applied in reverse
order; the colour cache; meta prefix codes (the entropy image); simple
and normal prefix codes with the code-length code and its repeat codes;
LZ77 lengths and distances with the 120-entry distance map. A stream
libwebp rejects raises a ValueError that names the fault: a prefix code
that is over-subscribed, incomplete or empty, a code-length run past its
alphabet, a transform given twice, a colour cache of 0 or more than 11
bits, a copy that starts before the first pixel or runs past the last,
or bits read past the end of the data (libwebp counts at least 8 bytes:
a shorter stream may be read 64 bits deep). Leftover bytes are allowed,
as libwebp allows them. `decode(data, width, height)` reads the
headerless stream of an `ALPH` chunk (WebP's alpha plane).

`encode` writes uint8 RGB as the simple-format VP8L stream that
`cv2.imwrite(".webp")` writes at its defaults (lossless), with
`alpha_is_used` 0: a predictor transform with one mode per 16x16 tile
chosen by the smallest residual entropy, after subtract-green or not
(both are written and the shorter kept), LZ77 over a hash chain with the
distance map, and one group of length-limited (15 bits) canonical prefix
codes; images of at most 256 colours are also written with the colour
indexing transform (bundled for 16 colours or fewer), which is kept
unless a predicted stream is shorter (smooth ramps of a few dozen
levels predict better than they index). Its bytes
are not libwebp's: libwebp's lossless encoder picks its transforms and
backward references with heuristics (entropy-image clustering with its
own pseudo-random merges, a cost model) that are no part of what cv2
promises and that change between libwebp versions. What is promised,
and held in the tests, is the pixels: cv2 and `decode` read back exactly
what was written. The C version (`webp.c vp8l_encode`) runs the same
algorithm to the same bytes.
"""

from __future__ import annotations

import numpy as np

MAGIC = 0x2F
NUM_LITERAL = 256
NUM_LENGTH = 24
NUM_DISTANCE = 40
MAX_CACHE_BITS = 11
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                     13, 14, 15)
# Distance codes 1-120 → (dy << 4) | (8 - dx) for the nearest 2-D offsets.
CODE_TO_PLANE = (
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
)
_TRANSFORM_NAMES = ("predictor", "cross-colour", "subtract-green",
                    "colour-indexing")


class _Reader:
    """LSB-first bits; reading past the data (at least 8 bytes' worth, as
    libwebp's 64-bit window counts) raises."""

    __slots__ = ("data", "pos", "limit")

    def __init__(self, data: bytes):
        self.data = bytes(data) + b"\0\0\0\0"
        self.pos = 0
        self.limit = 8 * max(len(data), 8)

    def read(self, n: int) -> int:
        p = self.pos
        v = (int.from_bytes(self.data[p >> 3:(p >> 3) + 4], "little")
             >> (p & 7)) & ((1 << n) - 1)
        self.pos = p + n
        if self.pos > self.limit:
            raise ValueError("VP8L data ends before the image does")
        return v


def _build_code(lengths, size: int):
    """Code lengths of symbols [0, size) → (single symbol or -1, counts per
    length, symbols in canonical order), checked as libwebp's
    BuildHuffmanTable checks them."""
    counts = [0] * 16
    for n in lengths[:size]:
        counts[n] += 1
    if counts[0] == size:
        raise ValueError("VP8L prefix code without symbols")
    symbols = sorted((n, s) for s, n in enumerate(lengths[:size]) if n)
    if len(symbols) == 1:
        return symbols[0][1], counts, [symbols[0][1]]
    left = 1
    for n in range(1, 16):
        left = 2 * left - counts[n]
        if left < 0:
            raise ValueError("VP8L prefix code is over-subscribed")
    if left:
        raise ValueError("VP8L prefix code is incomplete")
    return -1, counts, [s for _, s in symbols]


def _symbol(br: _Reader, code) -> int:
    single, counts, symbols = code
    if single >= 0:
        return single
    c = first = index = 0
    for n in range(1, 16):
        c |= br.read(1)
        count = counts[n]
        if c - first < count:
            return symbols[index + c - first]
        index += count
        first = (first + count) << 1
        c <<= 1
    raise AssertionError("a complete prefix code always ends")


def _code_lengths(br: _Reader, cl_lengths, size: int) -> list:
    cl_code = _build_code(cl_lengths, 19)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > size:
            raise ValueError(f"VP8L code-length count {max_symbol} past its "
                             f"alphabet of {size}")
    else:
        max_symbol = size
    lengths = [0] * max(size, 256)
    symbol, prev = 0, 8
    while symbol < size:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = _symbol(br, cl_code)
        if c < 16:
            lengths[symbol] = c
            symbol += 1
            if c:
                prev = c
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
        repeat = br.read(extra) + offset
        if symbol + repeat > size:
            raise ValueError("VP8L code-length run past its alphabet")
        value = prev if c == 16 else 0
        lengths[symbol:symbol + repeat] = [value] * repeat
        symbol += repeat
    return lengths


def _read_code(br: _Reader, size: int):
    if br.read(1):  # simple: one or two symbols of one bit each
        lengths = [0] * max(size, 256)
        two = br.read(1)
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if two:
            lengths[br.read(8)] = 1
        return _build_code(lengths, size)
    cl_lengths = [0] * 19
    for i in range(br.read(4) + 4):
        cl_lengths[CODE_LENGTH_ORDER[i]] = br.read(3)
    return _build_code(_code_lengths(br, cl_lengths, size), size)


def subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _prefix_value(br: _Reader, symbol: int) -> int:
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def plane_distance(xsize: int, code: int) -> int:
    if code > 120:
        return code - 120
    dc = CODE_TO_PLANE[code - 1]
    return max((dc >> 4) * xsize + 8 - (dc & 15), 1)


def _image_stream(br: _Reader, xsize: int, ysize: int,
                  level0: bool) -> np.ndarray:
    """One entropy-coded image (the main one with its transforms when
    `level0`) → uint32 ARGB [ysize, xsize], transforms undone."""
    transforms = []
    if level0:
        seen = 0
        while br.read(1):
            kind = br.read(2)
            if seen & (1 << kind):
                raise ValueError(f"VP8L {_TRANSFORM_NAMES[kind]} transform "
                                 "given twice")
            seen |= 1 << kind
            if kind in (0, 1):
                bits = br.read(3) + 2
                data = _image_stream(br, subsample(xsize, bits),
                                     subsample(ysize, bits), False)
                transforms.append((kind, bits, xsize, data))
            elif kind == 3:
                n = br.read(8) + 1
                bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                colours = _image_stream(br, n, 1, False)[0]
                palette = np.zeros(1 << (8 >> bits), np.uint32)
                palette[:n] = _add_running(colours)
                transforms.append((kind, bits, xsize, palette))
                xsize = subsample(xsize, bits)
            else:
                transforms.append((kind, 0, xsize, None))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= MAX_CACHE_BITS:
            raise ValueError(f"VP8L colour cache of {cache_bits} bits")
    meta_bits, meta = 0, None
    groups = 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        image = _image_stream(br, subsample(xsize, meta_bits),
                              subsample(ysize, meta_bits), False)
        meta = ((image >> 8) & 0xFFFF).astype(np.int64)
        groups = int(meta.max()) + 1
    sizes = (NUM_LITERAL + NUM_LENGTH + (1 << cache_bits if cache_bits
                                         else 0),
             NUM_LITERAL, NUM_LITERAL, NUM_LITERAL, NUM_DISTANCE)
    codes = [[_read_code(br, size) for size in sizes] for _ in range(groups)]
    pixels = _entropy_data(br, xsize, ysize, cache_bits, codes, meta,
                           meta_bits)
    for kind, bits, width, data in reversed(transforms):
        pixels = _undo_transform(kind, bits, width, data, pixels)
    return pixels


def _add_running(colours: np.ndarray) -> np.ndarray:
    """A delta-coded palette → its colours (each entry adds the one
    before, channel by channel)."""
    out = colours.copy().view(np.uint8).reshape(-1, 4)
    np.cumsum(out, axis=0, dtype=np.uint8, out=out)
    return out.reshape(-1).view(np.uint32)


def _entropy_data(br: _Reader, xsize: int, ysize: int, cache_bits: int,
                  codes, meta, meta_bits: int) -> np.ndarray:
    total = xsize * ysize
    out = [0] * total
    cache = [0] * (1 << cache_bits)
    shift = 32 - cache_bits
    last_cached = 0
    mask = (1 << meta_bits) - 1 if meta is not None else -1
    meta_width = subsample(xsize, meta_bits)
    pos = x = y = 0
    group = codes[0]
    while pos < total:
        if meta is not None and (x & mask) == 0:
            group = codes[meta.flat[(y >> meta_bits) * meta_width
                                    + (x >> meta_bits)]]
        code = _symbol(br, group[0])
        if code < NUM_LITERAL or code >= NUM_LITERAL + NUM_LENGTH:
            if code < NUM_LITERAL:
                red = _symbol(br, group[1])
                blue = _symbol(br, group[2])
                alpha = _symbol(br, group[3])
                out[pos] = (alpha << 24) | (red << 16) | (code << 8) | blue
            else:
                out[pos] = cache[code - NUM_LITERAL - NUM_LENGTH]
            pos += 1
            x += 1
            if x >= xsize:
                x = 0
                y += 1
        else:
            length = _prefix_value(br, code - NUM_LITERAL)
            dist = plane_distance(xsize, _prefix_value(br, _symbol(br,
                                                                   group[4])))
            if pos < dist or total - pos < length:
                raise ValueError(f"VP8L copy of {length} pixels from "
                                 f"distance {dist} at pixel {pos} leaves "
                                 "the image")
            for k in range(pos, pos + length):
                out[k] = out[k - dist]
            pos += length
            x += length
            while x >= xsize:
                x -= xsize
                y += 1
            if meta is not None:
                group = codes[meta.flat[(y >> meta_bits) * meta_width
                                        + (x >> meta_bits)]] \
                    if pos < total else group
        # Every pixel enters the cache in order (libwebp inserts lazily,
        # but always before a lookup).
        while cache_bits and last_cached < pos:
            argb = out[last_cached]
            cache[((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = argb
            last_cached += 1
    return np.array(out, np.uint32).reshape(ysize, xsize)


def _channels(p: int) -> tuple[int, int, int, int]:
    return p >> 24, (p >> 16) & 255, (p >> 8) & 255, p & 255


def _avg2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip255(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _select(t: int, left: int, tl: int) -> int:
    ta, tr, tg, tb = _channels(t)
    la, lr, lg, lb = _channels(left)
    ca, cr, cg, cb = _channels(tl)
    pa_minus_pb = (abs(la - ca) - abs(ta - ca) + abs(lr - cr) - abs(tr - cr)
                   + abs(lg - cg) - abs(tg - cg) + abs(lb - cb)
                   - abs(tb - cb))
    return t if pa_minus_pb <= 0 else left


def _clamped_full(a: int, b: int, c: int) -> int:
    return ((_clip255((a >> 24) + (b >> 24) - (c >> 24)) << 24)
            | (_clip255(((a >> 16) & 255) + ((b >> 16) & 255)
                        - ((c >> 16) & 255)) << 16)
            | (_clip255(((a >> 8) & 255) + ((b >> 8) & 255)
                        - ((c >> 8) & 255)) << 8)
            | _clip255((a & 255) + (b & 255) - (c & 255)))


def _clamped_half(ave: int, c: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        a, b = (ave >> s) & 255, (c >> s) & 255
        d = a - b
        out |= _clip255(a + (d // 2 if d >= 0 else -((-d) // 2))) << s
    return out


def predict(mode: int, left: int, top: int, tr: int, tl: int) -> int:
    """Predictor `mode` (0-15) of the four neighbours, as ARGB."""
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg2(_avg2(left, tr), top)
    if mode == 6:
        return _avg2(left, tl)
    if mode == 7:
        return _avg2(left, top)
    if mode == 8:
        return _avg2(tl, top)
    if mode == 9:
        return _avg2(top, tr)
    if mode == 10:
        return _avg2(_avg2(left, tl), _avg2(top, tr))
    if mode == 11:
        return _select(top, left, tl)
    if mode == 12:
        return _clamped_full(left, top, tl)
    if mode == 13:
        return _clamped_half(_avg2(left, top), tl)
    return 0xFF000000  # 0, and 14 and 15 as libwebp pads its table


def add_pixels(a: int, b: int) -> int:
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _undo_predictor(bits: int, width: int, modes: np.ndarray,
                    pixels: np.ndarray) -> np.ndarray:
    height = pixels.shape[0]
    tiles = subsample(width, bits)
    flat = pixels.reshape(-1).tolist()
    mode_of = ((modes.reshape(-1) >> 8) & 15).tolist()
    flat[0] = add_pixels(flat[0], 0xFF000000)
    for x in range(1, width):
        flat[x] = add_pixels(flat[x], flat[x - 1])
    for y in range(1, height):
        row = y * width
        flat[row] = add_pixels(flat[row], flat[row - width])
        tile_row = (y >> bits) * tiles
        for x in range(1, width):
            i = row + x
            mode = mode_of[tile_row + (x >> bits)]
            # The top-right of the last column is this row's first pixel,
            # the next word in memory, as libwebp reads it.
            flat[i] = add_pixels(flat[i], predict(
                mode, flat[i - 1], flat[i - width], flat[i - width + 1],
                flat[i - width - 1]))
    return np.array(flat, np.uint32).reshape(height, width)


def _signed(v: np.ndarray) -> np.ndarray:
    return v.astype(np.uint8).astype(np.int8).astype(np.int64)


def _undo_cross_colour(bits: int, width: int, codes: np.ndarray,
                       pixels: np.ndarray) -> np.ndarray:
    height = pixels.shape[0]
    rows = np.arange(height) >> bits
    cols = np.arange(width) >> bits
    code = codes[rows[:, None], cols[None, :]].astype(np.int64)
    g2r, g2b, r2b = (_signed(code & 255), _signed((code >> 8) & 255),
                     _signed((code >> 16) & 255))
    p = pixels.astype(np.int64)
    green = _signed((p >> 8) & 255)
    red = ((p >> 16) + ((g2r * green) >> 5)) & 255
    blue = (p + ((g2b * green) >> 5) + ((r2b * _signed(red)) >> 5)) & 255
    return ((p & 0xFF00FF00) | (red << 16) | blue).astype(np.uint32)


def _undo_transform(kind: int, bits: int, width: int, data,
                    pixels: np.ndarray) -> np.ndarray:
    if kind == 0:
        return _undo_predictor(bits, width, data, pixels)
    if kind == 1:
        return _undo_cross_colour(bits, width, data, pixels)
    if kind == 2:
        p = pixels.astype(np.int64)
        green = (p >> 8) & 255
        red = ((p >> 16) + green) & 255
        blue = (p + green) & 255
        return ((p & 0xFF00FF00) | (red << 16) | blue).astype(np.uint32)
    index = ((pixels >> 8) & 255).astype(np.int64)
    if bits:
        per = 1 << bits
        depth = 8 >> bits
        shifts = (np.arange(per) * depth)[None, None, :]
        index = (index[:, :, None] >> shifts) & ((1 << depth) - 1)
        index = index.reshape(index.shape[0], -1)[:, :width]
    return data[index]


def decode_header(data: bytes) -> tuple[int, int, bool]:
    """(width, height, alpha_is_used) of a VP8L stream; raises a
    ValueError for a wrong signature or version."""
    if len(data) < 5 or data[0] != MAGIC or data[4] >> 5:
        raise ValueError("not a VP8L stream (signature 0x2f, version 0)")
    bits = int.from_bytes(data[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, \
        bool((bits >> 28) & 1)


def decode(data: bytes, width: int | None = None,
           height: int | None = None) -> np.ndarray:
    """A VP8L stream → uint32 ARGB [height, width]. With `width` and
    `height` the stream has no header: an ALPH chunk's alpha plane (its
    values in the green channel)."""
    br = _Reader(data)
    if width is None:
        if br.read(8) != MAGIC:
            raise ValueError("not a VP8L stream (signature 0x2f)")
        width = br.read(14) + 1
        height = br.read(14) + 1
        br.read(1)
        if br.read(3):
            raise ValueError("VP8L version other than 0")
    return _image_stream(br, width, height, True)


# --- encoding ----------------------------------------------------------------

PREDICTOR_BITS = 4  # one predictor mode per 16x16 tile
MAX_LENGTH = 4096
MAX_DISTANCE = (1 << 20) - 120
HASH_BITS = 16
CHAIN = 32  # hash-chain candidates tried per position
MIN_MATCH = 3


def log2_q16(x: int) -> int:
    """floor(log2(x) * 65536) for an integer x >= 1, in integer arithmetic
    (so that the C version gets the same value)."""
    n = x.bit_length() - 1
    y = x << (30 - n) if n <= 30 else x >> (n - 30)
    frac = 0
    for _ in range(16):
        y = (y * y) >> 30
        frac <<= 1
        if y >= 2 << 30:
            y >>= 1
            frac |= 1
    return (n << 16) | frac


# c * log2(c) in Q16 for the counts of one tile's histogram.
_XLOGX = np.array([0] + [c * log2_q16(c) for c in range(1, 257)], np.int64)


class _Writer:
    """LSB-first bits."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, bits: int) -> None:
        self.acc |= value << self.n
        self.n += bits
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def bytes(self) -> bytes:
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


def _huffman_lengths(counts, limit: int) -> list:
    """Code lengths (at most `limit`) of a Huffman code of the nonzero
    counts: leaves in (count, symbol) order and internal nodes in the
    order made, the leaf taken on ties; counts below a floor that doubles
    until the code fits are raised to it."""
    syms = [s for s, c in enumerate(counts) if c]
    lengths = [0] * len(counts)
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    floor = 1
    while True:
        leaves = sorted((max(counts[s], floor), s) for s in syms)
        weight = [w for w, _ in leaves]
        parent = [-1] * (2 * len(leaves) - 1)
        nodes = []  # internal nodes' weights, in the order made
        li = ni = 0
        for k in range(len(leaves) - 1):
            pair = []
            for _ in range(2):
                if li < len(leaves) and (ni >= len(nodes)
                                         or weight[li] <= nodes[ni]):
                    pair.append(li)
                    li += 1
                else:
                    pair.append(len(leaves) + ni)
                    ni += 1
            me = len(leaves) + k
            w = 0
            for p in pair:
                parent[p] = me
                w += weight[p] if p < len(leaves) else nodes[p - len(leaves)]
            nodes.append(w)
        depth = [0] * len(parent)
        for i in range(len(parent) - 2, -1, -1):
            depth[i] = depth[parent[i]] + 1
        if max(depth[:len(leaves)]) <= limit:
            for i, (_, s) in enumerate(leaves):
                lengths[s] = depth[i]
            return lengths
        floor *= 2


def _canonical(lengths) -> list:
    """Code lengths → each symbol's code, bit-reversed for LSB-first
    writing (0 where unused, or when one symbol alone takes no bits)."""
    codes = [0] * len(lengths)
    if sum(1 for n in lengths if n) <= 1:
        return codes
    code = 0
    prev = 0
    for n, s in sorted((n, s) for s, n in enumerate(lengths) if n):
        code <<= n - prev
        prev = n
        codes[s] = int(format(code, f"0{n}b")[::-1], 2)
        code += 1
    return codes


class _Code:
    def __init__(self, lengths):
        self.lengths = lengths
        self.codes = _canonical(lengths)
        self.single = sum(1 for n in lengths if n) <= 1

    def put(self, bw: _Writer, symbol: int) -> None:
        if not self.single:
            bw.put(self.codes[symbol], self.lengths[symbol])


def _length_tokens(lengths) -> list:
    """Code lengths → (code-length symbol, extra bits, extra value)
    tokens: repeat code 16 for runs of the last length written, 17 and
    18 for runs of zeros."""
    tokens = []
    i, n, prev = 0, len(lengths), 8
    while i < n:
        v = lengths[i]
        run = 1
        while i + run < n and lengths[i + run] == v:
            run += 1
        i += run
        if v == 0:
            while run >= 3:
                k = min(run, 138)
                tokens.append((18, 7, k - 11) if k >= 11 else (17, 3, k - 3))
                run -= k
            tokens.extend([(0, 0, 0)] * run)
            continue
        if v != prev:
            tokens.append((v, 0, 0))
            prev = v
            run -= 1
        while run >= 3:
            k = min(run, 6)
            tokens.append((16, 2, k - 3))
            run -= k
        tokens.extend([(v, 0, 0)] * run)
    return tokens


def _write_code(bw: _Writer, counts, size: int) -> _Code:
    """A prefix code for `counts` over an alphabet of `size`, written as
    VP8L stores it."""
    used = [s for s in range(size) if counts[s]]
    lengths = [0] * size
    if not used:
        used = [0]
    if len(used) <= 2 and used[-1] < 256:
        bw.put(1, 1)
        bw.put(len(used) - 1, 1)
        if used[0] < 2:
            bw.put(0, 1)
            bw.put(used[0], 1)
        else:
            bw.put(1, 1)
            bw.put(used[0], 8)
        if len(used) == 2:
            bw.put(used[1], 8)
        for s in used:
            lengths[s] = 1
        return _Code(lengths)
    lengths = _huffman_lengths(list(counts[:size]), 15)
    tokens = _length_tokens(lengths)
    histogram = [0] * 19
    for t, _, _ in tokens:
        histogram[t] += 1
    cl_lengths = _huffman_lengths(histogram, 7)
    num = max(4, max(i for i in range(19)
                     if cl_lengths[CODE_LENGTH_ORDER[i]]) + 1)
    bw.put(0, 1)
    bw.put(num - 4, 4)
    for i in range(num):
        bw.put(cl_lengths[CODE_LENGTH_ORDER[i]], 3)
    bw.put(0, 1)  # every symbol's length is written
    cl_code = _Code(cl_lengths)
    for t, bits, value in tokens:
        cl_code.put(bw, t)
        if bits:
            bw.put(value, bits)
    return _Code(lengths)


def _prefix(value: int) -> tuple[int, int, int]:
    """A length or distance code >= 1 → (symbol, extra bits, extra
    value)."""
    if value <= 4:
        return value - 1, 0, 0
    d = value - 1
    high = d.bit_length() - 1
    extra = high - 1
    return 2 * high + ((d >> extra) & 1), extra, d & ((1 << extra) - 1)


_PLANE_TO_CODE = [0] * 128
for _i, _v in enumerate(CODE_TO_PLANE):
    _PLANE_TO_CODE[_v] = _i


def distance_code(xsize: int, dist: int) -> int:
    """A distance in pixels → its VP8L distance code (1-120 for the
    nearest 2-D offsets, else dist + 120)."""
    y, x = divmod(dist, xsize)
    if x <= 8 and y < 8:
        return _PLANE_TO_CODE[y * 16 + 8 - x] + 1
    if x > xsize - 8 and y < 7:
        return _PLANE_TO_CODE[(y + 1) * 16 + 8 + xsize - x] + 1
    return dist + 120


def _hash(a: int, b: int) -> int:
    return ((((a * 0x1E35A7BD) & 0xFFFFFFFF) ^ b) * 0x9E3779B1
            & 0xFFFFFFFF) >> (32 - HASH_BITS)


def _lz77(pixels: list, xsize: int) -> list:
    """Greedy LZ77 over the ARGB words → tokens: a literal word (int) or
    (length, distance). Candidates: distance 1, distance xsize, then up to
    CHAIN earlier positions with the same hash of two words; the longest
    match of at least MIN_MATCH wins, the first found on ties."""
    n = len(pixels)
    head = [-1] * (1 << HASH_BITS)
    prev = [-1] * n
    tokens = []

    def insert(i):
        if i + 1 < n:
            h = _hash(pixels[i], pixels[i + 1])
            prev[i] = head[h]
            head[h] = i

    def extend(i, j):
        limit = min(MAX_LENGTH, n - i)
        k = 0
        while k < limit and pixels[i + k] == pixels[j + k]:
            k += 1
        return k

    i = 0
    while i < n:
        best_len, best_dist = 0, 0
        if i + 1 < n:
            for d in (1, xsize):
                if d <= i:
                    k = extend(i, i - d)
                    if k > best_len:
                        best_len, best_dist = k, d
            j = head[_hash(pixels[i], pixels[i + 1])]
            tries = 0
            while j >= 0 and tries < CHAIN and i - j <= MAX_DISTANCE:
                d = i - j
                if d != 1 and d != xsize:
                    k = extend(i, j)
                    if k > best_len:
                        best_len, best_dist = k, d
                j = prev[j]
                tries += 1
        if best_len >= MIN_MATCH:
            tokens.append((best_len, best_dist))
            for k in range(best_len):
                insert(i + k)
            i += best_len
        else:
            tokens.append(pixels[i])
            insert(i)
            i += 1
    return tokens


def _write_image(bw: _Writer, image: np.ndarray, level0: bool) -> None:
    """An entropy-coded image (no colour cache, one group of codes)."""
    xsize = image.shape[1]
    bw.put(0, 1)  # no colour cache
    if level0:
        bw.put(0, 1)  # no meta prefix codes
    tokens = _lz77(image.reshape(-1).tolist(), xsize)
    counts = [[0] * (NUM_LITERAL + NUM_LENGTH), [0] * 256, [0] * 256,
              [0] * 256, [0] * NUM_DISTANCE]
    coded = []
    for t in tokens:
        if isinstance(t, int):
            counts[0][(t >> 8) & 255] += 1
            counts[1][(t >> 16) & 255] += 1
            counts[2][t & 255] += 1
            counts[3][t >> 24] += 1
            coded.append(t)
        else:
            length, dist = t
            ls = _prefix(length)
            ds = _prefix(distance_code(xsize, dist))
            counts[0][NUM_LITERAL + ls[0]] += 1
            counts[4][ds[0]] += 1
            coded.append((ls, ds))
    codes = [_write_code(bw, c, len(c)) for c in counts]
    for t in coded:
        if isinstance(t, int):
            codes[0].put(bw, (t >> 8) & 255)
            codes[1].put(bw, (t >> 16) & 255)
            codes[2].put(bw, t & 255)
            codes[3].put(bw, t >> 24)
        else:
            (lsym, lbits, lval), (dsym, dbits, dval) = t
            codes[0].put(bw, NUM_LITERAL + lsym)
            bw.put(lval, lbits)
            codes[4].put(bw, dsym)
            bw.put(dval, dbits)


def _sub_pixels(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    ag = 0x00FF00FF + (a & 0xFF00FF00) - (b & 0xFF00FF00)
    rb = 0xFF00FF00 + (a & 0x00FF00FF) - (b & 0x00FF00FF)
    return ((ag & 0xFF00FF00) | (rb & 0x00FF00FF)).astype(np.uint32)


def _chan(p: np.ndarray, s: int) -> np.ndarray:
    return (p >> s) & 255


def _predict_all(mode: int, left, top, tr, tl) -> np.ndarray:
    """`predict` over arrays of int64 ARGB words."""
    def avg2(a, b):
        return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)

    if mode in (0, 14, 15):
        return np.full(left.shape, 0xFF000000, np.int64)
    simple = {1: lambda: left, 2: lambda: top, 3: lambda: tr,
              4: lambda: tl, 5: lambda: avg2(avg2(left, tr), top),
              6: lambda: avg2(left, tl), 7: lambda: avg2(left, top),
              8: lambda: avg2(tl, top), 9: lambda: avg2(top, tr),
              10: lambda: avg2(avg2(left, tl), avg2(top, tr))}
    if mode in simple:
        return simple[mode]()
    out = np.zeros(left.shape, np.int64)
    if mode == 11:
        score = sum(np.abs(_chan(left, s) - _chan(tl, s))
                    - np.abs(_chan(top, s) - _chan(tl, s))
                    for s in (24, 16, 8, 0))
        return np.where(score <= 0, top, left)
    ave = avg2(left, top)
    for s in (24, 16, 8, 0):
        if mode == 12:
            v = _chan(left, s) + _chan(top, s) - _chan(tl, s)
        else:
            a, c = _chan(ave, s), _chan(tl, s)
            d = a - c
            v = a + np.where(d >= 0, d // 2, -((-d) // 2))
        out |= np.clip(v, 0, 255) << s
    return out


def _predictor_residuals(argb: np.ndarray, bits: int):
    """(mode image [tiles_y, tiles_x], residuals [h, w]) of the predictor
    transform, each tile's mode (0-13) the one whose residuals have the
    smallest entropy (summed over the four channels; the lowest mode on
    ties)."""
    h, w = argb.shape
    flat = argb.reshape(-1).astype(np.int64)
    idx = np.arange(h * w)
    x, y = idx % w, idx // w
    inner = (x > 0) & (y > 0)
    left = flat[np.maximum(idx - 1, 0)]
    top = flat[np.maximum(idx - w, 0)]
    tr = flat[np.clip(idx - w + 1, 0, h * w - 1)]
    tl = flat[np.maximum(idx - w - 1, 0)]
    fixed = np.where(y == 0, np.where(x == 0, 0xFF000000, left), top)
    tw, th = subsample(w, bits), subsample(h, bits)
    tile = (y >> bits) * tw + (x >> bits)
    best_score = best_res = None
    best_mode = np.zeros(tw * th, np.int64)
    for mode in range(14):
        pred = np.where(inner, _predict_all(mode, left, top, tr, tl), fixed)
        res = _sub_pixels(flat, pred).astype(np.int64)
        score = np.zeros(tw * th, np.int64)
        for s in (24, 16, 8, 0):
            hist = np.bincount(tile * 256 + _chan(res, s),
                               minlength=tw * th * 256).reshape(-1, 256)
            score += _XLOGX[hist].sum(axis=1)
        if best_score is None:
            best_score, best_res = score, res
            continue
        better = score > best_score
        best_score = np.where(better, score, best_score)
        best_mode = np.where(better, mode, best_mode)
        best_res = np.where(better[tile], res, best_res)
    return best_mode.reshape(th, tw), best_res.reshape(h, w).astype(np.uint32)


def _bundle(index: np.ndarray, bits: int) -> np.ndarray:
    """Palette indices [h, w] → the packed green bytes [h, ceil(w / 2^bits)],
    first index in the low bits."""
    if bits == 0:
        return index
    per, depth = 1 << bits, 8 >> bits
    h, w = index.shape
    padded = np.zeros((h, subsample(w, bits) * per), np.int64)
    padded[:, :w] = index
    shifts = np.arange(per) * depth
    return (padded.reshape(h, -1, per) << shifts).sum(axis=2)


def _header(bw: _Writer, h: int, w: int) -> None:
    bw.put(MAGIC, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(0, 1)  # alpha_is_used
    bw.put(0, 3)  # version


def _encode_palette(argb: np.ndarray, colours: np.ndarray) -> bytes:
    h, w = argb.shape
    bw = _Writer()
    _header(bw, h, w)
    n = len(colours)
    bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
    bw.put(1, 1)
    bw.put(3, 2)
    bw.put(n - 1, 8)
    delta = colours.copy()
    delta[1:] = _sub_pixels(colours[1:], colours[:-1])
    _write_image(bw, delta[None, :], level0=False)
    packed = _bundle(np.searchsorted(colours, argb), bits)
    bw.put(0, 1)  # no more transforms
    _write_image(bw, (0xFF000000 | (packed << 8)).astype(np.uint32),
                 level0=True)
    return bw.bytes()


def _encode_predicted(argb: np.ndarray, subtract_green: bool) -> bytes:
    h, w = argb.shape
    bw = _Writer()
    _header(bw, h, w)
    p = argb.astype(np.int64)
    if subtract_green:
        bw.put(1, 1)
        bw.put(2, 2)
        green = (p >> 8) & 255
        p = (p & 0xFF00FF00) | ((((p >> 16) - green) & 255) << 16) \
            | ((p - green) & 255)
    bw.put(1, 1)
    bw.put(0, 2)  # predictor
    bw.put(PREDICTOR_BITS - 2, 3)
    modes, image = _predictor_residuals(p.astype(np.uint32), PREDICTOR_BITS)
    _write_image(bw, (0xFF000000 | (modes << 8)).astype(np.uint32),
                 level0=False)
    bw.put(0, 1)  # no more transforms
    _write_image(bw, image, level0=True)
    return bw.bytes()


def encode(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] → a VP8L stream (see the module docstring)."""
    px = np.asarray(rgb, np.uint8).astype(np.int64)
    argb = (0xFF000000 | (px[..., 0] << 16) | (px[..., 1] << 8)
            | px[..., 2]).astype(np.uint32)
    colours = np.unique(argb)
    # Subtract-green decorrelates most photographs and hurts images whose
    # channels vary apart: both are written and the shorter kept, and the
    # palette's stream where there is one and it is no longer.
    with_green = _encode_predicted(argb, True)
    without = _encode_predicted(argb, False)
    best = without if len(without) < len(with_green) else with_green
    if len(colours) <= 256:
        indexed = _encode_palette(argb, colours)
        if len(indexed) <= len(best):
            return indexed
    return best
