"""Baseline JPEG decoding in plain NumPy, bit for bit as libjpeg-turbo
decodes under `cv2.imdecode(buf, cv2.IMREAD_COLOR)` with its SIMD code on
x86 (the output reversed from BGR to RGB). It is the specification of
`csrc/image_codec.c decode_jpeg`, the fast path, and the plain version
the tests and the smoke script hold that path to.

What is decoded: sequential Huffman-coded frames (SOF0, SOF1) of 8-bit
samples, one component (gray) or three (YCbCr), in one or several scans,
with DHT, DQT (8- and 16-bit tables), DRI and RST0-7 (the DC predictors
reset at each interval), byte stuffing and fill bytes. APP0, APP14, COM
and the other APPn are skipped; APP1 may hold Exif, read by
`exif_orientation` and applied by `utils/image_io.py`.

The stages follow libjpeg-turbo's sources:
- `jdhuff.c`: Huffman decoding, the DC predictor kept as a 16-bit JCOEF;
- `jidctint.c` `jpeg_idct_islow` (CONST_BITS 13, PASS1_BITS 2), in the
  arithmetic of its SIMD versions (`jidctint-avx2.asm`), which OpenCV
  5.0's bundled libjpeg-turbo 3.1 runs on x86: dequantised coefficients and the sums in0+in4, in0-in4,
  in7+in3 and in5+in1 wrap to 16 bits, the first pass saturates to 16
  bits, an all-zero AC column skips it as `dq0 << 2` in 16 bits, and the
  output saturates to [0, 255]. Far out of range the C version's
  `range_limit` table wraps instead; on streams an encoder writes the two
  agree;
- `jdsample.c`: fancy upsampling (h2v1, h2v2 with context rows, h1v2),
  taken for h2v1 and h2v2 only where the component's downsampled width
  is greater than 2; box upsampling otherwise and for any other integral
  factor (4:1:1); edges replicate the outermost samples;
- `jdcolor.c`: fixed-point YCbCr -> RGB (SCALEBITS 16), gray repeated
  into three channels.

It is the plain version of the baseline part of `csrc/image_codec.c`,
which also reads progressive, arithmetic-coded, lossless, RGB,
CMYK/YCCK, block-smoothed and truncated files. `encode_pixels` (below)
is the plain version of its encoder: the bytes cv2.imencode(".jpg")
writes. Everything else raises a ValueError that names it here:
progressive (SOF2),
lossless or hierarchical (SOF3, SOF5-7), arithmetic coding (SOF9-15),
12-bit samples, 2 or 4 components (CMYK/YCCK), RGB JPEGs (Adobe
transform 0, or component ids 'R', 'G', 'B'), and streams whose data
ends early where libjpeg-turbo would ask for a byte past the end
(`cv2.imdecode` refuses them; with `eof_fill` they are filled as
`cv2.imread` fills a file).
"""

from __future__ import annotations

import struct

import numpy as np

# jpeg_natural_order: zigzag index -> row-major index in the 8x8 block.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)
ZIGZAG_LIST = ZIGZAG.tolist()

_SOF_NAMES = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential sequential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}


class Component:
    """One frame component: id, sampling factors, quantisation table, its
    downsampled size, and its coefficients [blocks_h, blocks_w, 64]
    (row-major in each block), filled by the scans."""

    __slots__ = ("cid", "h", "v", "tq", "width", "height", "blocks_w",
                 "blocks_h", "coefs")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq


class Frame:
    """A parsed baseline JPEG: its size, components with their
    coefficients (filled by the scans), quantisation tables and the
    markers libjpeg-turbo infers the colour space from."""

    def __init__(self):
        self.width = self.height = 0
        self.components: list[Component] = []
        self.qtables: dict[int, np.ndarray] = {}
        self.jfif = False
        self.adobe_transform: int | None = None


def _fail(msg: str):
    raise ValueError(f"JPEG: {msg}")


class _Source:
    """The stream as libjpeg's data source and marker reader see it: a
    position, the marker the entropy decoder ran into (`unread`), and the
    end of the data, past which `eof_fill` (cv2.imread's file source, and
    libtiff's) supplies the bytes FF D9 over and over and cv2.imdecode's
    source refuses. A segment the data cuts leaves the position in that
    fill."""

    def __init__(self, data: bytes, eof_fill: bool):
        self.data, self.n, self.eof_fill = data, len(data), eof_fill
        self.pos = self.interval_start = 2
        self.unread = 0

    def next_marker(self) -> int:
        """jdmarker.c next_marker: the next marker, skipping whatever is
        not one (other bytes, FF 00 pairs; libjpeg warns)."""
        data, n = self.data, self.n
        while True:
            pos = data.find(b"\xff", self.pos)
            if pos < 0:
                break
            while pos < n and data[pos] == 0xFF:
                pos += 1
            if pos >= n:
                break
            self.pos = pos + 1
            if data[pos]:
                return data[pos]
        if not self.eof_fill:
            _fail("truncated stream (no EOI)")
        self.pos = n
        return 0xD9

    def take_marker(self) -> int:
        """The marker to act on next: the one the entropy decoder ran
        into, or the next in the stream."""
        m, self.unread = self.unread, 0
        return m or self.next_marker()

    def segment(self, lenient: bool) -> bytes:
        """The payload of the segment whose length field is next. A
        length below 2 is refused, or with `lenient` (APPn, COM, DNL,
        which libjpeg skips or only peeks into) an empty payload after
        the field. With eof_fill a segment cut by the end of the data is
        completed with FF D9 bytes, and the position stays in them."""
        data, n, pos = self.data, self.n, self.pos
        head = data[pos:pos + 2]
        if lenient and len(head) == 2 and (head[0] << 8 | head[1]) < 2:
            self.pos = pos + 2
            return b""
        if pos + 2 > n or pos + (head[0] << 8 | head[1]) > n:
            if not self.eof_fill:
                _fail("truncated marker segment")

            def at(k):
                return data[k] if k < n else 0xD9 if (k - n) % 2 else 0xFF

            length = at(pos) << 8 | at(pos + 1)
            if length < 2:
                if not lenient:
                    _fail("truncated marker segment")
                length = 2
            self.pos = max(pos + length, n)
            return bytes(at(pos + 2 + k) for k in range(length - 2))
        length = head[0] << 8 | head[1]
        if length < 2:
            _fail("truncated marker segment")
        self.pos = pos + length
        return data[pos + 2:pos + length]

    def entropy_bytes(self) -> tuple[bytes, bool]:
        """The data of a restart interval, FF 00 unstuffed, up to the
        marker that ends it (recorded as unread: the decoder reads zero
        bits from there on), and whether the data ended first without
        eof_fill (then `_LibjpegReader` decides where decoding near its
        end is refused; `interval_start` is where the data began).
        Nothing where a marker is already unread. A scan whose SOS segment
        the data cut starts inside the fill: on its D9, which is no marker
        but a data byte, where the segment ended on an FF."""
        if self.unread:
            return b"", False
        data, n, pos = self.data, self.n, self.pos
        self.interval_start = pos
        if pos > n:
            self.pos, self.unread = n, 0xD9
            return (b"\xd9" if (pos - n) % 2 else b""), False
        out = bytearray()
        while True:
            nxt = data.find(b"\xff", pos)
            if nxt < 0:
                out += data[pos:]
                break
            out += data[pos:nxt]
            q = nxt + 1
            while q < n and data[q] == 0xFF:
                q += 1
            if q >= n:
                break
            if data[q] == 0:
                out.append(0xFF)
                pos = q + 1
                continue
            self.unread, self.pos = data[q], q + 1
            return bytes(out), False
        self.pos = n
        if self.eof_fill:
            self.unread = 0xD9
            return bytes(out), False
        return bytes(out), True


def _parse_sof(frame: Frame, p: bytes, raw: bool = False):
    if frame.components:
        _fail("more than one frame")
    if len(p) < 6:
        _fail("truncated SOF")
    precision, height, width, nc = struct.unpack(">BHHB", p[:6])
    if precision != 8:
        _fail(f"{precision}-bit samples are not read (8-bit only)")
    if nc not in ((1, 3, 4) if raw else (1, 3)):
        kind = "CMYK/YCCK" if nc == 4 else f"{nc}-component"
        _fail(f"{kind} images are not read (gray or YCbCr only)")
    if height == 0 or width == 0:
        _fail(f"bad size {width}x{height} (DNL is not read)")
    if len(p) != 6 + 3 * nc:
        _fail("bad SOF length")
    frame.width, frame.height = width, height
    for i in range(nc):
        cid, hv, tq = p[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4):
            _fail(f"bad sampling factors in component {cid}")
        frame.components.append(Component(cid, h, v, tq))
    hmax = max(c.h for c in frame.components)
    vmax = max(c.v for c in frame.components)
    mcus_x = -(-width // (8 * hmax))
    mcus_y = -(-height // (8 * vmax))
    for c in frame.components:
        if hmax % c.h or vmax % c.v:
            _fail("fractional sampling factors are not read")
        c.width = -(-width * c.h // hmax)
        c.height = -(-height * c.v // vmax)
        c.blocks_w, c.blocks_h = mcus_x * c.h, mcus_y * c.v
        c.coefs = np.zeros((c.blocks_h, c.blocks_w, 64), np.int64)


def _parse_dqt(frame: Frame, p: bytes):
    """jdmarker.c get_dqt: any nonzero precision nibble means 16-bit
    values; a table cut short by the segment is refused."""
    pos = 0
    while pos < len(p):
        pq, tq = p[pos] >> 4, p[pos] & 15
        size = 128 if pq else 64
        if tq > 3 or pos + 1 + size > len(p):
            _fail("bad DQT")
        dtype = ">u2" if pq else "u1"
        zz = np.frombuffer(p[pos + 1:pos + 1 + size], dtype).astype(np.int64)
        table = np.zeros(64, np.int64)
        table[ZIGZAG] = zz
        frame.qtables[tq] = table
        pos += 1 + size


def _parse_dht(tables: dict, p: bytes):
    """Tables by (class, index): (lookup table, values), or the message a
    scan that uses a bad one is refused with (libjpeg builds tables
    there)."""
    pos = 0
    while len(p) - pos > 16:
        tc, th = p[pos] >> 4, p[pos] & 15
        counts = list(p[pos + 1:pos + 17])
        total = sum(counts)
        if total > 256 or pos + 17 + total > len(p):
            _fail("bad DHT")
        if tc > 1 or th > 3:
            _fail("bad DHT table index")
        values = list(p[pos + 17:pos + 17 + total])
        try:
            tables[(tc, th)] = (_lookup_table(counts, values), values)
        except ValueError as exc:
            tables[(tc, th)] = str(exc)
        pos += 17 + total
    if pos != len(p):
        _fail("bad DHT length")


def _lookup_table(counts: list, values: list) -> list:
    """A 16-bit lookahead table of a canonical Huffman code:
    entry[next 16 bits] = (code length, symbol), or (0, 0) where no code
    of 16 bits or fewer starts that way (jdhuff.c's jpeg_make_d_derived_tbl
    builds the same codes)."""
    table = [(0, 0)] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                _fail("bad Huffman table")
            span = 1 << (16 - length)
            start = code << (16 - length)
            table[start:start + span] = [(length, values[k])] * span
            code += 1
            k += 1
        code <<= 1
    return table


def _standard_tables(tables: dict):
    """jdhuff.c std_huff_tables: where the first scan of a sequential
    frame starts, tables 0 and 1 that no DHT defined take the standard
    ones (Motion JPEG)."""
    for (tc, th), (counts, values) in zip(
            ((0, 0), (1, 0), (0, 1), (1, 1)), STD_HUFFMAN):
        if (tc, th) not in tables:
            tables[(tc, th)] = (_lookup_table(list(counts), list(values)),
                                list(values))


def parse(data: bytes, raw: bool = False, eof_fill: bool = False
          ) -> tuple[Frame, list]:
    """Frame header, tables and every scan's coefficients, walked as
    jdmarker.c read_markers walks them: returns the frame and its scans,
    each (its components with their Huffman tables, the restart interval
    in force). Restart and TEM markers between segments are ignored, and
    so is anything that is not a marker; markers libjpeg does not know
    are refused. An image of one scan holding every component ends with
    that scan (OpenCV's reader has its pixels before
    jpeg_finish_decompress reads on, and ignores what that finds). `raw`
    takes 4 components too and skips the colour-space check, for
    `decode_planes`; `eof_fill` reads data that ends early as libjpeg's
    file source fills it."""
    if not data.startswith(b"\xff\xd8"):
        _fail("no SOI marker")
    frame = Frame()
    tables: dict = {}
    restart = 0
    scans = []
    src = _Source(data, eof_fill)
    while True:
        marker = src.take_marker()
        if marker == 0xD9:
            break
        if marker == 0xD8:
            _fail("a second SOI marker")
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if marker < 0xC0 or marker in (0xDE, 0xDF) or 0xF0 <= marker <= 0xFD:
            _fail(f"unknown marker 0x{marker:02X}")
        p = src.segment(marker >= 0xE0 or marker == 0xDC)
        if marker in (0xC0, 0xC1):
            _parse_sof(frame, p, raw)
        elif marker in _SOF_NAMES:
            _fail(f"{_SOF_NAMES[marker]} JPEGs are not read (baseline "
                  "sequential Huffman only)")
        elif marker == 0xCC:
            _fail("arithmetic coding (DAC) is not read")
        elif marker == 0xC4:
            _parse_dht(tables, p)
        elif marker == 0xDB:
            _parse_dqt(frame, p)
        elif marker == 0xDD:
            if len(p) != 2:
                _fail("bad DRI")
            (restart,) = struct.unpack(">H", p)
        elif marker == 0xE0 and not scans and len(p) >= 14 \
                and p[:5] == b"JFIF\x00":
            frame.jfif = True
        elif marker == 0xEE and not scans and len(p) >= 12 \
                and p[:5] == b"Adobe":
            frame.adobe_transform = p[11]
        elif marker == 0xDA:
            if not frame.components:
                _fail("SOS before SOF")
            if not scans:
                _standard_tables(tables)
            scan = _parse_sos(frame, tables, p, restart)
            scans.append(scan)
            _decode_scan(frame, scan, src)
            if len(scans) == 1 and len(scan[0]) == len(frame.components):
                break
    if not scans:
        _fail("no image data")
    if not raw:
        _check_colour_space(frame)
    return frame, scans


def _scan_table(tables: dict, tc: int, th: int):
    """jpeg_make_d_derived_tbl's checks of a table a scan uses."""
    if th > 3 or (tc, th) not in tables:
        _fail("SOS uses an undefined Huffman table")
    table = tables[(tc, th)]
    if isinstance(table, str):
        _fail(table[len("JPEG: "):])
    if tc == 0 and max(table[1], default=0) > 15:
        _fail("bad Huffman table (DC symbol out of range)")
    return table[0]


def _parse_sos(frame: Frame, tables: dict, p: bytes, restart: int):
    ns = p[0] if p else 0
    if not 1 <= ns <= 4 or len(p) != 4 + 2 * ns:
        _fail("bad SOS")
    comps = []
    for i in range(ns):
        cid, t = p[1 + 2 * i], p[2 + 2 * i]
        # jdmarker.c get_sos matches the id against the frame's components
        # from the i-th on, and refuses one named twice.
        c = next((c for c in frame.components[i:] if c.cid == cid), None)
        if c is None or any(c is d for d, _, _ in comps):
            _fail(f"SOS names unknown component {cid}")
        dct, act = _scan_table(tables, 0, t >> 4), _scan_table(tables, 1,
                                                                 t & 15)
        if c.tq not in frame.qtables:
            _fail("component uses an undefined quantisation table")
        comps.append((c, dct, act))
    # Ss, Se, Ah and Al are ignored, as libjpeg-turbo ignores them (with a
    # warning) in a sequential scan.
    if ns > 1 and sum(c.h * c.v for c, _, _ in comps) > 10:
        _fail("too many blocks in an MCU")
    return comps, restart


def _read_restart_marker(src: _Source, want: int):
    """jdmarker.c read_restart_marker with jpeg_resync_to_restart: RSTn
    as expected is taken; otherwise (libjpeg warns) a marker that is no
    marker of a frame (below SOF0) or a restart marker one or two behind
    is skipped for the next, a restart marker one or two ahead or any
    other frame marker is left unread (the interval reads no data), and
    any other restart marker is taken as if it were the one expected."""
    m = src.take_marker()
    while True:
        ahead = m in (0xD0 + ((want + 1) & 7), 0xD0 + ((want + 2) & 7))
        behind = m in (0xD0 + ((want - 1) & 7), 0xD0 + ((want - 2) & 7))
        if m == 0xD0 + want:
            return
        if m < 0xC0 or (0xD0 <= m <= 0xD7 and behind):
            m = src.next_marker()
            continue
        if not 0xD0 <= m <= 0xD7 or ahead:
            src.unread = m
        return


# Zero bytes after an interval's data: an MCU of up to 10 blocks that ran
# into a marker reads at most 64 codes of 17 bits and 64 values of 15
# bits a block past the end before the check.
_PAD = 2600


class _Bits:
    """An MSB-first bit reader over one restart interval: `words[i]` holds
    the 40 bits from byte i on, so any 16 bits from bit p are one shift
    and mask away. Bits past the end read as zeros."""

    def __init__(self, seg: bytes):
        padded = np.frombuffer(seg + b"\x00" * (_PAD + 4), np.uint8) \
            .astype(np.uint64)
        n = len(seg) + _PAD
        words = np.zeros(n, np.uint64)
        for k in range(5):
            words |= padded[k:k + n] << np.uint64(32 - 8 * k)
        self.words = words.tolist()
        self.nbits = len(seg) * 8
        self.pos = 0

    def peek16(self) -> int:
        p = self.pos
        return (self.words[p >> 3] >> (24 - (p & 7))) & 0xFFFF

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        v = (self.words[p >> 3] >> (40 - (p & 7) - n)) & ((1 << n) - 1)
        self.pos = p + n
        return v

    def insufficient(self) -> bool:
        """jdhuff.c insufficient_data: bits were used past the data."""
        return self.pos > self.nbits


class _LibjpegReader:
    """libjpeg-turbo's own bit buffer (jdhuff.c) over an interval whose
    data runs from `pos` to the end of `data` without a marker: where it
    asks for a byte past the end, cv2.imdecode's source suspends, which
    refuses the stream (the plain version of `csrc/image_codec.c`
    lj_mcu). `mcu` replays one MCU's codes: their lengths, extra bits
    negated. jpeg_fill_bit_buffer tops up to 57 bits where a request
    finds fewer bits than it needs: 8 for a code's lookup, 9 and then 1
    at a time for a longer code, an extra-bits count; decode_mcu_fast,
    which takes an MCU where no restart interval is set (`fast`) and 512
    bytes a block are left, reads 6 bytes where 16 bits or fewer are
    left, and an MCU in which that meets a marker is decoded again the
    slow way."""

    def __init__(self, data: bytes, pos: int, fast: bool):
        self.data, self.n, self.pos, self.bits = data, len(data), pos, 0
        self.fast = fast

    def _fill(self):
        data, n = self.data, self.n
        while self.bits < 57:
            if self.pos >= n:
                _fail("truncated stream (entropy-coded data ends early)")
            c = data[self.pos]
            self.pos += 1
            while c == 0xFF:  # FF (FF)* 00: no marker lies ahead
                if self.pos >= n:
                    _fail("truncated stream (entropy-coded data ends early)")
                c = data[self.pos]
                self.pos += 1
            self.bits += 8

    def _fast_bytes(self) -> bool:
        data, n = self.data, self.n
        for _ in range(6):
            if self.pos + 1 >= n:
                return False
            if data[self.pos] == 0xFF:
                if data[self.pos + 1]:
                    return False
                self.pos += 1
            self.pos += 1
            self.bits += 8
        return True

    def mcu(self, events: list, blocks: int):
        if self.fast and self.n - self.pos >= 512 * blocks:
            pos, bits = self.pos, self.bits
            for e in events:
                if self.bits <= 16 and not self._fast_bytes():
                    break
                self.bits -= abs(e)
            else:
                return
            self.pos, self.bits = pos, bits
        for e in events:
            if e < 0:
                if self.bits < -e:
                    self._fill()
                self.bits += e
                continue
            if self.bits < 8:
                self._fill()
            if e <= 8:
                self.bits -= e
                continue
            if self.bits < 9:
                self._fill()
            self.bits -= 9
            for _ in range(e - 9):
                if self.bits < 1:
                    self._fill()
                self.bits -= 1


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _decode_symbol(bits: _Bits, table: list) -> int:
    """A Huffman symbol; where no code of 16 bits or fewer matches,
    jpeg_huff_decode warns, takes 17 bits and returns symbol 0."""
    length, symbol = table[bits.peek16()]
    bits.pos += length or 17
    return symbol


def _decode_block(bits: _Bits, dc_table, ac_table, pred: int, out,
                  events: list | None = None):
    """One block's coefficients into `out`; returns the DC value. With
    `events`, the length of each code and the count of extra bits
    (negated) go there, for `_LibjpegReader`."""
    p = bits.pos
    s = _decode_symbol(bits, dc_table)
    if events is not None:
        events.append(bits.pos - p)
        if s:
            events.append(-s)
    dc = pred + _extend(bits.get(s), s)
    dc = ((dc + 32768) & 0xFFFF) - 32768  # JCOEF is 16-bit
    out[0] = dc
    k = 1
    while k < 64:
        p = bits.pos
        rs = _decode_symbol(bits, ac_table)
        r, s = rs >> 4, rs & 15
        if events is not None:
            events.append(bits.pos - p)
            if s:
                events.append(-s)
        if s == 0:
            if r != 15:
                break
            k += 16
            continue
        # A run past the block lands on the extra entries of
        # jpeg_natural_order, which are all 63.
        k += r
        out[ZIGZAG_LIST[k] if k < 64 else 63] = _extend(bits.get(s), s)
        k += 1
    return dc


def _decode_scan(frame: Frame, scan, src: _Source):
    """Huffman-decode one scan into the components' coefficients, as
    jdhuff.c decode_mcu does: restart intervals resynchronised by
    `_read_restart_marker`, an MCU that runs into a marker finished on
    zero bits and the rest of its interval left zero. A scan of one
    component codes its blocks one by one, over its own width and height;
    an interleaved scan codes MCUs of h x v blocks of each component in
    turn."""
    comps, restart = scan
    if len(comps) == 1:
        c = comps[0][0]
        units_x, units_y = -(-c.width // 8), -(-c.height // 8)
        shapes = [(1, 1)]
    else:
        hmax = max(c.h for c in frame.components)
        vmax = max(c.v for c in frame.components)
        units_x = -(-frame.width // (8 * hmax))
        units_y = -(-frame.height // (8 * vmax))
        shapes = [(c.v, c.h) for c, _, _ in comps]
    total = units_x * units_y
    blocks = sum(v * h for v, h in shapes)
    block = [0] * 64

    def interval():
        """The next interval's bits, and libjpeg-turbo's reader where its
        data runs to the end without a marker (and eof_fill is off)."""
        seg, open_end = src.entropy_bytes()
        return _Bits(seg), (_LibjpegReader(src.data, src.interval_start,
                                           restart == 0)
                            if open_end else None)

    bits, reader = interval()
    events = [] if reader else None
    preds = [0] * len(comps)
    insufficient = False
    togo, want = restart, 0
    for u in range(total):
        if restart:
            if togo == 0:
                _read_restart_marker(src, want)
                want = (want + 1) & 7
                preds = [0] * len(comps)
                if not src.unread:
                    insufficient = False
                bits, reader = interval()
                events = [] if reader else None
                togo = restart
            togo -= 1
        if insufficient:
            continue
        uy, ux = divmod(u, units_x)
        for i, ((c, dct, act), (v, h)) in enumerate(zip(comps, shapes)):
            for by in range(v):
                for bx in range(h):
                    block[:] = [0] * 64
                    preds[i] = _decode_block(bits, dct, act, preds[i], block,
                                             events)
                    c.coefs[uy * v + by, ux * h + bx] = block
        if reader:
            reader.mcu(events, blocks)
            events.clear()
        insufficient = bits.insufficient()


def _check_colour_space(frame: Frame):
    """jdapimin.c default_decompress_parms: a 3-component JPEG is RGB
    (refused) under an Adobe marker with transform 0, or, with neither a
    JFIF nor an Adobe marker, component ids 'R', 'G', 'B'."""
    if len(frame.components) != 3:
        return
    ids = tuple(c.cid for c in frame.components)
    if frame.jfif:
        return
    if frame.adobe_transform is not None:
        if frame.adobe_transform == 0:
            _fail("RGB JPEGs (Adobe transform 0) are not read")
        return
    if ids == (82, 71, 66):
        _fail("RGB JPEGs (component ids R, G, B) are not read")


# --- the inverse DCT -----------------------------------------------------

FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _i16(x: np.ndarray) -> np.ndarray:
    """Wrap to a signed 16-bit value, as a SIMD lane does."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(c):
    """One pass of jpeg_idct_islow over axis 0 of `c` ([8, ...] int64),
    before the descale: the eight outputs in order. The 16-bit sums are
    those of the SIMD version."""
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = _i16(c[0] + c[4]) << 13
    tmp1 = _i16(c[0] - c[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = _i16(t0 + t2)
    z4 = _i16(t1 + t3)
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """[..., 64] coefficients in row-major order and a row-major table →
    [..., 8, 8] uint8 samples."""
    shape = coefs.shape[:-1]
    blocks = coefs.reshape(-1, 8, 8)
    dq = _i16(blocks * qtable.reshape(8, 8))
    # Pass 1 on columns: axis 1 is the vertical frequency.
    cols = np.moveaxis(dq, 1, 0)  # [8 (u), N, 8 (column)]
    out = np.stack(_idct_1d(cols))  # [8 (y), N, 8 (column)]
    ws = np.clip((out + (1 << 10)) >> 11, -32768, 32767)
    # All AC rows zero: the SIMD code skips the pass for the whole block.
    ac_zero = ~blocks[:, 1:, :].any(axis=(1, 2))  # [N]
    ws = np.where(ac_zero[None, :, None], _i16(cols[0] << 2)[None], ws)
    # Pass 2 on rows: axis 2 of [y, N, x].
    rows = np.moveaxis(ws, 2, 0)  # [8 (v), 8 (y), N]
    out = np.stack(_idct_1d(rows))  # [8 (x), 8 (y), N]
    pix = np.clip((out + (1 << 17)) >> 18, -128, 127) + 128
    return pix.transpose(2, 1, 0).reshape(*shape, 8, 8).astype(np.uint8)


# --- upsampling and colour -----------------------------------------------


def _plane(c: Component, qtable: np.ndarray) -> np.ndarray:
    """A component's samples, [blocks_h*8, blocks_w*8] int64."""
    pix = idct_islow(c.coefs, qtable)  # [bh, bw, 8, 8]
    return pix.transpose(0, 2, 1, 3).reshape(c.blocks_h * 8,
                                              c.blocks_w * 8).astype(np.int64)


def _fancy_h2(x: np.ndarray, width: int, bias_left: int, bias_right: int,
              shift: int) -> np.ndarray:
    """Horizontal 2x fancy upsampling of x [..., width] (the component's
    real width): out[2c] = (3 x[c] + x[c-1] + bias_left) >> shift and
    out[2c+1] = (3 x[c] + x[c+1] + bias_right) >> shift, edges
    replicated. h2v1 passes samples; h2v2 passes its column sums."""
    left = np.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    right = np.concatenate([x[..., 1:], x[..., -1:]], axis=-1)
    out = np.empty((*x.shape[:-1], 2 * width), np.int64)
    out[..., 0::2] = (3 * x + left + bias_left) >> shift
    out[..., 1::2] = (3 * x + right + bias_right) >> shift
    return out


def _upsample(p: np.ndarray, c: Component, hmax: int, vmax: int,
              out_h: int, out_w: int) -> np.ndarray:
    """A component plane upsampled to the frame's full size, as
    jdsample.c's routine for its factors does."""
    fh, fv = hmax // c.h, vmax // c.v
    real = p[:c.height, :c.width]
    if (fh, fv) == (1, 1):
        return p[:out_h, :out_w]
    if (fh, fv) == (2, 1) and c.width > 2:
        up = _fancy_h2(real, c.width, 1, 2, 2)
        return up[:out_h, :out_w]
    if (fh, fv) == (1, 2):
        above = np.concatenate([real[:1], real[:-1]], axis=0)
        below = np.concatenate([real[1:], real[-1:]], axis=0)
        up = np.empty((2 * c.height, c.width), np.int64)
        up[0::2] = (3 * real + above + 1) >> 2
        up[1::2] = (3 * real + below + 2) >> 2
        return up[:out_h, :out_w]
    if (fh, fv) == (2, 2) and c.width > 2:
        above = np.concatenate([real[:1], real[:-1]], axis=0)
        below = np.concatenate([real[1:], real[-1:]], axis=0)
        sums = np.empty((2 * c.height, c.width), np.int64)
        sums[0::2] = 3 * real + above
        sums[1::2] = 3 * real + below
        up = _fancy_h2(sums, c.width, 8, 7, 4)
        return up[:out_h, :out_w]
    # Box upsampling (h2v1_upsample, h2v2_upsample, int_upsample).
    up = np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)
    return up[:out_h, :out_w]


SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert on int arrays of samples → uint8
    [..., 3] RGB."""
    cb = cb - 128
    cr = cr - 128
    r = y + ((_fix(1.40200) * cr + ONE_HALF) >> SCALEBITS)
    g = y + ((-_fix(0.34414) * cb + ONE_HALF - _fix(0.71414) * cr)
             >> SCALEBITS)
    b = y + ((_fix(1.77200) * cb + ONE_HALF) >> SCALEBITS)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_pixels(data: bytes, eof_fill: bool = False) -> np.ndarray:
    """JPEG bytes → uint8 RGB [H, W, 3], before any Exif orientation;
    data that ends early is refused, as cv2.imdecode refuses it, or with
    `eof_fill` filled as cv2.imread fills a file."""
    frame, _ = parse(bytes(data), eof_fill=eof_fill)
    hmax = max(c.h for c in frame.components)
    vmax = max(c.v for c in frame.components)
    h, w = frame.height, frame.width
    planes = [_upsample(_plane(c, frame.qtables[c.tq]), c, hmax, vmax, h, w)
              for c in frame.components]
    if len(planes) == 1:
        gray = planes[0].astype(np.uint8)
        return np.repeat(gray[:, :, None], 3, axis=2)
    return ycc_to_rgb(*planes)


def decode_planes(data: bytes) -> np.ndarray:
    """A baseline JPEG's components, upsampled and not converted, as
    libjpeg-turbo outputs them for an unknown colour space → uint8
    [H, W, components], data that ends early filled as libtiff's source
    manager fills it: how libtiff reads a TIFF's JPEG strips and tiles
    (the plain version of `csrc/image_codec.c decode_jpeg_tiff`;
    `ycc_to_rgb` converts YCbCr ones)."""
    frame, _ = parse(bytes(data), raw=True, eof_fill=True)
    hmax = max(c.h for c in frame.components)
    vmax = max(c.v for c in frame.components)
    h, w = frame.height, frame.width
    return np.stack([_upsample(_plane(c, frame.qtables[c.tq]), c, hmax,
                               vmax, h, w) for c in frame.components],
                    -1).astype(np.uint8)


def exif_block(data: bytes) -> bytes | None:
    """The TIFF bytes of the first APP1 Exif segment before the first SOS,
    or None (also for a header too broken to walk). OpenCV takes the Exif
    from the APP1 segments libjpeg saved while jdmarker.c read_markers
    walked the header, so the walk is `parse`'s: bytes that are no marker
    and FF 00 pairs are skipped, fill bytes too, TEM and RST0-7 carry no
    length, and an APPn length below 2 is an empty payload."""
    src = _Source(data, eof_fill=False)
    try:
        while True:
            marker = src.next_marker()
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:
                continue
            if marker in (0xD8, 0xD9, 0xDA) or marker < 0xC0 \
                    or marker in (0xDE, 0xDF) or 0xF0 <= marker <= 0xFD:
                return None
            p = src.segment(marker >= 0xE0 or marker == 0xDC)
            if marker == 0xE1 and p[:6] == b"Exif\x00\x00":
                return bytes(p[6:])
    except ValueError:
        return None


# --- encoding -------------------------------------------------------------
# What cv2.imencode(".jpg", bgr) writes at OpenCV 5's defaults
# (libjpeg-turbo 3): baseline 4:2:0 at quality 95, the standard Huffman
# tables, no restart markers, JFIF 1.01 with a 1:1 density of unit 0. The
# plain version of `csrc/image_codec.c encode_jpeg`.

# Tables K.1 and K.2, row-major.
STD_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104,
              113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98,
              112, 100, 103, 99], np.int64),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
             + [99] * 32, np.int64),
)
# Tables K.3-K.6 (jstdhuff.c): 16 code counts, then the values.
_AC_LUMA_VALUES = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a92"
    "939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8"
    "c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_VALUES = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
STD_HUFFMAN = (
    (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]),
     _AC_LUMA_VALUES),
    (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
     _AC_CHROMA_VALUES),
)
_JFIF = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def quant_table(which: int, quality: int) -> np.ndarray:
    """jcparam.c jpeg_quality_scaling and jpeg_add_quant_table with
    force_baseline: table `which` (0 luma, 1 chroma), row-major."""
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((STD_QUANT[which] * scale + 50) // 100, 1, 255)


def _divisors(q: np.ndarray):
    """jcdctmgr.c compute_reciprocal for each divisor q << 3 of the ISLOW
    DCT: (reciprocal, correction, shift)."""
    recip, corr, shift = [], [], []
    for d in (q << 3).tolist():
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return np.array(recip), np.array(corr), np.array(shift)


def _quantize(coefs: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's quantize(): (|x| + correction) * reciprocal >> shift,
    the sign restored; equal to its SIMD version."""
    recip, corr, shift = _divisors(q)
    mag = ((np.abs(coefs) + corr) * recip) >> shift
    return np.where(coefs < 0, -mag, mag)


def _fdct_1d(d, descale: int, first: bool):
    """One pass of jfdctint.c jpeg_fdct_islow over axis 0 of d ([8, ...]
    int64): the eight outputs, DC and coefficient 4 shifted up by 2 in the
    first pass and rounded down by 2 in the second."""
    t0, t7 = d[0] + d[7], d[0] - d[7]
    t1, t6 = d[1] + d[6], d[1] - d[6]
    t2, t5 = d[2] + d[5], d[2] - d[5]
    t3, t4 = d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2

    def down(x):
        return (x + (1 << (descale - 1))) >> descale

    out = [None] * 8
    if first:
        out[0], out[4] = (t10 + t11) << 2, (t10 - t11) << 2
    else:
        out[0], out[4] = (t10 + t11 + 2) >> 2, (t10 - t11 + 2) >> 2
    z1 = (t12 + t13) * FIX_0_541196100
    out[2] = down(z1 + t13 * FIX_0_765366865)
    out[6] = down(z1 - t12 * FIX_1_847759065)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * FIX_1_175875602
    t4, t5 = t4 * FIX_0_298631336, t5 * FIX_2_053119869
    t6, t7 = t6 * FIX_3_072711026, t7 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    out[7] = down(t4 + z1 + z3)
    out[5] = down(t5 + z2 + z4)
    out[3] = down(t6 + z2 + z3)
    out[1] = down(t7 + z1 + z4)
    return np.stack(out)


def fdct_islow(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """A plane [8*bh, 8*bw] of samples → quantised coefficients
    [bh, bw, 64], row-major in each block."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    blocks = plane.reshape(bh, 8, bw, 8).transpose(1, 3, 0, 2) - 128
    rows = _fdct_1d(np.moveaxis(blocks, 1, 0), 13 - 2, True)  # [u, y, ...]
    cols = _fdct_1d(np.moveaxis(rows, 1, 0), 13 + 2, False)  # [v, u, ...]
    coefs = cols.reshape(64, bh, bw).transpose(1, 2, 0)
    return _quantize(coefs, q)


def rgb_to_ycc(rgb: np.ndarray) -> tuple:
    """jccolor.c rgb_ycc_convert: uint8 RGB [..., 3] → Y, Cb, Cr int64."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, centre = ONE_HALF, 128 << SCALEBITS
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + half) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
          + centre + half - 1) >> SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + centre + half - 1) >> SCALEBITS
    return y, cb, cr


def _mcu_blocks(rgb: np.ndarray, quality: int) -> np.ndarray:
    """The quantised blocks of every MCU in order, [my, mx, 6, 64]: four Y
    blocks, then Cb and Cr. Edges are replicated as jcprepct.c and
    jcsample.c do, and Y blocks past the image's are jccoefct.c's dummy
    blocks (zero, with the DC of the block before them)."""
    h, w = rgb.shape[:2]
    mx, my = (w + 15) // 16, (h + 15) // 16
    y, cb, cr = rgb_to_ycc(rgb)
    # Rows padded to a whole pair, columns to the chroma blocks' width.
    rows = np.minimum(np.arange(2 * ((h + 1) // 2)), h - 1)
    cols = np.minimum(np.arange(16 * mx), w - 1)
    bias = np.tile([1, 2], 4 * mx)
    chroma = []
    for c in (cb, cr):
        full = c[rows][:, cols]
        sums = (full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2]
                + full[1::2, 1::2] + bias) >> 2
        chroma.append(sums[np.minimum(np.arange(8 * my), len(sums) - 1)])
    yplane = y[np.minimum(np.arange(16 * my), h - 1)][:, cols]
    ycoef = fdct_islow(yplane, quant_table(0, quality))  # [2my, 2mx, 64]
    yhb, ywb = (h + 7) // 8, (w + 7) // 8
    blocks = np.zeros((my, mx, 6, 64), np.int64)
    quad = ycoef.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4)
    blocks[:, :, :4] = quad.reshape(my, mx, 4, 64)
    q1 = quant_table(1, quality)
    blocks[:, :, 4] = fdct_islow(chroma[0], q1)
    blocks[:, :, 5] = fdct_islow(chroma[1], q1)
    if ywb % 2:  # the right column of the last MCU column is dummy
        blocks[:, -1, [1, 3]] = 0
        blocks[:, -1, 1, 0] = blocks[:, -1, 0, 0]
        blocks[:, -1, 3, 0] = blocks[:, -1, 2, 0]
    if yhb % 2:  # the bottom row of the last MCU row is dummy
        blocks[-1, :, [2, 3]] = 0
        blocks[-1, :, 2, 0] = blocks[-1, :, 1, 0]
        blocks[-1, :, 3, 0] = blocks[-1, :, 1, 0]
    return blocks


def _codes(spec) -> tuple[dict, dict]:
    """Canonical code and length of each symbol (jchuff.c)."""
    counts, values = spec
    code, k, codes, sizes = 0, 0, {}, {}
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[values[k]], sizes[values[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, sizes


def _entropy_bits(blocks: np.ndarray) -> tuple[list, list]:
    """jchuff.c encode_one_block over every block of every MCU: the
    (bits, length) of each code and each magnitude, in stream order."""
    tables = [_codes(spec) for spec in STD_HUFFMAN]
    zz = blocks[..., ZIGZAG].reshape(-1, 6, 64)
    bits, lengths = [], []
    last = [0, 0, 0]
    for mcu in zz.tolist():
        for b, blk in enumerate(mcu):
            comp = 0 if b < 4 else b - 3
            (dc_c, dc_s), (ac_c, ac_s) = tables[2 * (comp > 0):
                                                2 * (comp > 0) + 2]
            t = blk[0] - last[comp]
            last[comp] = blk[0]
            n = abs(t).bit_length()
            bits += [dc_c[n], t - 1 if t < 0 else t]
            lengths += [dc_s[n], n]
            run = 0
            for k in range(1, 64):
                t = blk[k]
                if not t:
                    run += 1
                    continue
                while run > 15:
                    bits.append(ac_c[0xF0])
                    lengths.append(ac_s[0xF0])
                    run -= 16
                n = abs(t).bit_length()
                sym = (run << 4) + n
                bits += [ac_c[sym], t - 1 if t < 0 else t]
                lengths += [ac_s[sym], n]
                run = 0
            if run:
                bits.append(ac_c[0])
                lengths.append(ac_s[0])
    return bits, lengths


def _pack(bits: list, lengths: list) -> bytes:
    """MSB-first bit packing, the last byte padded with ones, a 0x00
    stuffed after every 0xFF."""
    lengths = np.array(lengths, np.int64)
    values = np.array(bits, np.int64) & ((1 << lengths) - 1)
    total = int(lengths.sum())
    owner = np.repeat(np.arange(len(lengths)), lengths)
    ends = np.cumsum(lengths)
    pos = np.arange(total) - np.repeat(ends - lengths, lengths)
    stream = (values[owner] >> (lengths[owner] - 1 - pos)) & 1
    stream = np.concatenate([stream, np.ones(-total % 8, np.int64)])
    packed = np.packbits(stream.astype(np.uint8))
    ff = np.flatnonzero(packed == 0xFF)
    return np.insert(packed, ff + 1, 0).tobytes()


def _segment_bytes(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


def encode_pixels(rgb: np.ndarray, quality: int = 95) -> bytes:
    """uint8 RGB [H, W, 3] → the bytes `cv2.imencode(".jpg", bgr,
    [cv2.IMWRITE_JPEG_QUALITY, quality])` writes (95 is cv2's default)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError("encode_pixels takes uint8 RGB [H, W, 3]; got "
                         f"{rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    if not (1 <= h <= 65500 and 1 <= w <= 65500 and 1 <= quality <= 100):
        raise ValueError(f"cannot encode {h}x{w} at quality {quality}")
    out = [b"\xff\xd8", _segment_bytes(0xE0, _JFIF)]
    for i in range(2):
        table = quant_table(i, quality)[ZIGZAG]
        out.append(_segment_bytes(0xDB, bytes([i]) + bytes(table.tolist())))
    out.append(_segment_bytes(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                              + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for i, (counts, values) in enumerate(STD_HUFFMAN):
        out.append(_segment_bytes(0xC4, bytes([(i & 1) << 4 | i >> 1])
                                  + counts + values))
    out.append(_segment_bytes(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11,
                                           0, 63, 0])))
    out.append(_pack(*_entropy_bits(_mcu_blocks(rgb, quality))))
    out.append(b"\xff\xd9")
    return b"".join(out)
