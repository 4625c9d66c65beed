"""zlib's inflate of a zlib stream up to its first error, as libtiff's
ZIPDecode runs it on a deflate-compressed TIFF strip or tile: the bytes
produced before zlib reports an error (or runs out of input, or reaches
the end of the stream) are kept, and the caller fills the rest of the
strip with zeros. Python's `zlib` module raises at an error and drops
what that call produced, so `tiff.py` takes this path only where `zlib`
fails or comes up short; on a stream `zlib` decodes the two agree.

Errors are found where zlib 1.3's inflate.c and inftrees.c find them:
the header (check bits, method, window size, a preset dictionary), a
block type of 3, stored lengths that do not match, too many length or
distance codes, code length sets that are over-subscribed or incomplete
(an incomplete literal/length or distance code is allowed only as a
single code of one bit), a repeat with no length before it or past the
end, a code set without an end-of-block code, a literal/length or
distance code that is not in the table (the fixed table's 286, 287, 30
and 31 included), and a distance past the bytes produced so far.
"""

from __future__ import annotations

_LENGTH_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
                35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
_LENGTH_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                 4, 4, 4, 4, 5, 5, 5, 5, 0)
_DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
              385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
              12289, 16385, 24577)
_DIST_EXTRA = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
               9, 10, 10, 11, 11, 12, 12, 13, 13)
_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)


class _Stop(Exception):
    """zlib stops: an error, or the input ran out."""


class _Bits:
    """Deflate's bit order: LSB first within each byte."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.acc, self.n = data, 0, 0, 0

    def need(self, k: int):
        while self.n < k:
            if self.pos >= len(self.data):
                raise _Stop
            self.acc |= self.data[self.pos] << self.n
            self.pos += 1
            self.n += 8

    def get(self, k: int) -> int:
        self.need(k)
        v = self.acc & ((1 << k) - 1)
        self.acc >>= k
        self.n -= k
        return v

    def byte_align(self):
        self.acc >>= self.n & 7
        self.n -= self.n & 7


def _table(lengths, kind: str):
    """inftrees.c inflate_table's checks, then {(length, code): symbol}.
    `kind` is "codes", "lens" or "dists"; a set with no codes at all is
    kept (decoding from it is the error)."""
    count = [0] * 16
    for length in lengths:
        count[length] += 1
    count[0] = 0
    top = max((k for k in range(1, 16) if count[k]), default=0)
    if top:
        left = 1
        for k in range(1, 16):
            left = (left << 1) - count[k]
            if left < 0:
                raise _Stop  # over-subscribed
        if left > 0 and (kind == "codes" or top != 1):
            raise _Stop  # incomplete
    codes, code, nxt = {}, 0, [0] * 16
    for k in range(1, 16):
        code = (code + count[k - 1]) << 1
        nxt[k] = code
    for sym, length in enumerate(lengths):
        if length:
            codes[(length, nxt[length])] = sym
            nxt[length] += 1
    return codes


def _symbol(bits: _Bits, codes: dict) -> int:
    code = 0
    for length in range(1, 16):
        code = (code << 1) | bits.get(1)
        sym = codes.get((length, code))
        if sym is not None:
            return sym
    raise _Stop  # a code not in the table


_FIXED = None


def _fixed():
    global _FIXED
    if _FIXED is None:
        lens = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
        _FIXED = (_table(lens, "lens"), _table([5] * 32, "dists"))
    return _FIXED


def inflate_partial(data: bytes, want: int) -> bytes:
    """The first `want` bytes the zlib stream `data` inflates to, or
    fewer: those produced before the first error, the end of the input
    or the end of the stream."""
    out = bytearray()
    bits = _Bits(data)
    try:
        cmf, flg = bits.get(8), bits.get(8)
        if ((cmf << 8) | flg) % 31 or cmf & 15 != 8 or (cmf >> 4) > 7 \
                or flg & 0x20:
            return b""
        while len(out) < want:
            final, kind = bits.get(1), bits.get(2)
            if kind == 0:
                bits.byte_align()
                length, nlength = bits.get(16), bits.get(16)
                if length != nlength ^ 0xFFFF:
                    break
                for _ in range(length):
                    if len(out) >= want:
                        break
                    out.append(bits.get(8))
            elif kind == 3:
                break
            else:
                if kind == 1:
                    lit, dist = _fixed()
                else:
                    nlen, ndist, ncode = (bits.get(5) + 257, bits.get(5) + 1,
                                          bits.get(4) + 4)
                    if nlen > 286 or ndist > 30:
                        break
                    lens = [0] * 19
                    for k in range(ncode):
                        lens[_ORDER[k]] = bits.get(3)
                    codes = _table(lens, "codes")
                    lengths: list[int] = []
                    while len(lengths) < nlen + ndist:
                        sym = _symbol(bits, codes)
                        if sym < 16:
                            lengths.append(sym)
                            continue
                        if sym == 16:
                            if not lengths:
                                raise _Stop
                            rep, val = 3 + bits.get(2), lengths[-1]
                        elif sym == 17:
                            rep, val = 3 + bits.get(3), 0
                        else:
                            rep, val = 11 + bits.get(7), 0
                        if len(lengths) + rep > nlen + ndist:
                            raise _Stop
                        lengths += [val] * rep
                    if lengths[256] == 0:
                        break
                    lit = _table(lengths[:nlen], "lens")
                    dist = _table(lengths[nlen:], "dists")
                while len(out) < want:
                    sym = _symbol(bits, lit)
                    if sym < 256:
                        out.append(sym)
                        continue
                    if sym == 256:
                        break
                    if sym > 285:
                        raise _Stop
                    k = sym - 257
                    length = _LENGTH_BASE[k] + bits.get(_LENGTH_EXTRA[k])
                    d = _symbol(bits, dist)
                    if d > 29:
                        raise _Stop
                    d = _DIST_BASE[d] + bits.get(_DIST_EXTRA[d])
                    if d > len(out):
                        raise _Stop  # too far back
                    for _ in range(min(length, want - len(out))):
                        out.append(out[-d])
                else:
                    break
            if final:
                break
    except _Stop:
        pass
    return bytes(out[:want])
