"""CCITT fax decoding of 1-bit TIFF strips and tiles as libtiff 4.7's
`tif_fax3.c` runs it under OpenCV 5.0: compression 2 (modified Huffman,
rows aligned to bytes, no EOLs), 3 (T.4: one-dimensional, or two-dimensional
where T4Options has bit 0, every row after an EOL) and 4 (T.6). It is the
plain version of `csrc/image_codec.c fax_decode` and the specification it
follows, state for state:

- bits are taken from the bytes least significant first, each byte read
  through a bit reversal table unless FillOrder is 2 (libtiff's
  `bitmap`), into a 32-bit accumulator; past the end of the data the
  accumulator is padded with zero bits while any real bit is left in it
  (NeedBits8/NeedBits16), and only a read with none left is the end;
- codes are looked up in libtiff's tables (`mkg3states.c`): 12 bits for
  white runs, 13 for black, 7 for the two-dimensional modes; eleven zero
  bits are an EOL; a code that is in no table consumes no bits;
- a bad code ends the row where it stands (CLEANUP_RUNS pads or trims the
  runs to the row's width) and decoding goes on with the next row; a row
  with too many runs, or the data ending before the strip's rows are
  decoded, fails the strip (cv2 then returns no image), except that a T.6
  strip whose data or an EOL ends it after its first row is kept, the rows
  not decoded left at 0 (libtiff's "badly-terminated strips");
- black runs are 1 bits, white runs 0 bits (what MinIsWhite means).
"""

from __future__ import annotations

import numpy as np

(S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB,
 S_MAKEUPW, S_MAKEUPB, S_MAKEUP, S_EOL) = range(13)

# T.4's code words, first bit first.
WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011").split()
BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 "
    "0000111 00000100 00000111 000011000 0000010111 0000011000 0000001000 "
    "00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 "
    "000011010111 000001101100 000001101101 000011011010 000011011011 "
    "000001010100 000001010101 000001010110 000001010111 000001100100 "
    "000001100101 000001010010 000001010011 000000100100 000000110111 "
    "000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101").split()
# Make-up codes of 1792-2560, shared by both colours.
EXT_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111").split()
# Two-dimensional modes: (state, code, param).
MODES = ((S_PASS, "0001", 0), (S_HORIZ, "001", 0), (S_V0, "1", 0),
         (S_VR, "011", 1), (S_VR, "000011", 2), (S_VR, "0000011", 3),
         (S_VL, "010", 1), (S_VL, "000010", 2), (S_VL, "0000010", 3),
         (S_EXT, "0000001", 0), (S_EOL, "0000000", 0))
EOL_ZEROS = "0" * 11


def _fill(table: list, bits: int, state: int, code: str, param: int) -> None:
    """mkg3states.c FillTable: every index whose low bits are the code
    read first bit first."""
    rev = int(code[::-1], 2)
    for i in range(rev, 1 << bits, 1 << len(code)):
        table[i] = (state, len(code), param)


def _tables():
    main = [(S_NULL, 0, 0)] * 128
    for state, code, param in MODES:
        _fill(main, 7, state, code, param)
    out = [main]
    for bits, term, makeup, s_term, s_makeup in (
            (12, WHITE_TERM, WHITE_MAKEUP, S_TERMW, S_MAKEUPW),
            (13, BLACK_TERM, BLACK_MAKEUP, S_TERMB, S_MAKEUPB)):
        t = [(S_NULL, 0, 0)] * (1 << bits)
        for i, code in enumerate(makeup):
            _fill(t, bits, s_makeup, code, 64 * (i + 1))
        for i, code in enumerate(EXT_MAKEUP):
            _fill(t, bits, S_MAKEUP, code, 1792 + 64 * i)
        for i, code in enumerate(term):
            _fill(t, bits, s_term, code, i)
        _fill(t, bits, S_EOL, EOL_ZEROS, 0)
        out.append(t)
    return out


MAIN, WHITE, BLACK = _tables()
_REVERSE = [int(f"{i:08b}"[::-1], 2) for i in range(256)]


def _i32(v: int) -> int:
    """C's int: wrapped to 32 bits, two's complement."""
    return (v + 2**31) % 2**32 - 2**31


class _Fail(Exception):
    """The decoder returns -1: the strip fails."""


class _Eof(Exception):
    """A code ran past the data (a macro's `eoflab`)."""


class _NoEol(Exception):
    """SYNC_EOL ran past the data looking for an EOL (`noEOLFound`)."""


class _Fax:
    """One strip's decoder state (libtiff's Fax3CodecState and the
    DECLARE_STATE locals)."""

    def __init__(self, data: bytes, width: int, two_d: bool,
                 msb_first: bool, codec: dict):
        self.data, self.cp = data, 0
        self.bitmap = _REVERSE if msb_first else list(range(256))
        self.acc = self.avail = 0
        self.eolcnt = 0
        self.lastx = width
        words = -(-(width + 1) // 32) * 32
        self.nruns = 2 * words if two_d else words
        # The run arrays live as long as the codec: what a strip leaves in
        # them past its reference line is read by the next on bad data.
        if len(codec.get("runs", ())) != 2 * self.nruns:
            codec["runs"] = [0] * (2 * self.nruns)
        self.runs = codec["runs"]
        self.cur = 0
        self.ref = self.nruns
        if two_d:
            self.runs[self.ref] = width
            self.runs[self.ref + 1] = 0

    # --- bits ---------------------------------------------------------

    def need(self, n: int, wide: bool) -> None:
        """NeedBits8 (one byte at most) or NeedBits16 (two)."""
        if self.avail >= n:
            return
        if self.cp >= len(self.data):
            if self.avail == 0:
                raise _Eof
            self.avail = n
            return
        self.acc |= self.bitmap[self.data[self.cp]] << self.avail
        self.cp += 1
        self.avail += 8
        if wide and self.avail < n:
            if self.cp >= len(self.data):
                self.avail = n
            else:
                self.acc |= self.bitmap[self.data[self.cp]] << self.avail
                self.cp += 1
                self.avail += 8
        self.acc &= 0xFFFFFFFF

    def get(self, n: int) -> int:
        return self.acc & ((1 << n) - 1)

    def clr(self, n: int) -> None:
        self.avail -= n
        self.acc >>= n

    def lookup(self, bits: int, table: list, wide: bool = True):
        self.need(bits, wide)
        entry = table[self.get(bits)]
        self.clr(entry[1])
        return entry

    # --- runs -----------------------------------------------------------

    def setvalue(self, x: int) -> None:
        if self.pa >= self.thisrun + self.nruns:
            raise _Fail("buffer overflow")
        self.runs[self.pa] = (self.run_length + x) & 0xFFFFFFFF
        self.pa += 1
        self.a0 = _i32(self.a0 + x)
        self.run_length = 0

    def cleanup_runs(self) -> None:
        """CLEANUP_RUNS: the row's runs padded or trimmed to its width."""
        if self.run_length:
            self.setvalue(0)
        lastx = self.lastx
        if self.a0 != lastx:
            while self.a0 > lastx and self.pa > self.thisrun:
                self.pa -= 1
                self.a0 = _i32(self.a0 - self.runs[self.pa])
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if (self.pa - self.thisrun) & 1:
                    self.setvalue(0)
                self.setvalue(lastx - self.a0)
            elif self.a0 > lastx:
                self.setvalue(lastx)
                self.setvalue(0)

    def start_row(self) -> None:
        self.a0 = self.run_length = 0
        self.pa = self.thisrun = self.cur

    def fill(self, row: np.ndarray) -> None:
        """_TIFFFax3fillruns: white runs 0, black runs 1, each clamped to
        the row in place (the clamped runs are the next row's
        reference), a 0 after an odd count."""
        runs, end = self.runs, self.pa
        if (end - self.thisrun) & 1 and end < len(runs):
            runs[end] = 0
            end += 1
        x, lastx = 0, self.lastx
        for i in range(self.thisrun, end, 2):
            for k, colour in ((i, 0), (i + 1, 1)):
                if k >= end:
                    break
                run = runs[k]
                if x + run > lastx or run > lastx:
                    run = runs[k] = lastx - x
                if run:
                    row[x:x + run] = colour
                    x += run

    # --- the macros ---------------------------------------------------------

    def restart(self) -> None:
        """CACHE_STATE after a retry: the bit reader back at the strip's
        first byte (nothing was stored since the strip began)."""
        self.cp = self.acc = self.avail = self.eolcnt = 0

    def sync_eol(self) -> None:
        """SYNC_EOL: find an EOL unless one was just read, then move past
        its zero bits and its 1. Running out of data on the way raises
        _NoEol: libtiff then takes the data for one without EOLs."""
        try:
            if self.eolcnt == 0:
                while True:
                    self.need(11, True)
                    if self.get(11) == 0:
                        break
                    self.clr(1)
            while True:
                self.need(8, False)
                if self.get(8):
                    break
                self.clr(8)
        except _Eof:
            raise _NoEol from None
        while self.get(1) == 0:
            self.clr(1)
        self.clr(1)
        self.eolcnt = 0

    def _colour_run(self, table_bits: int, table: list, term: int,
                    makeup: int) -> bool:
        """Make-up codes then a terminating code of one colour (the inner
        loops of EXPAND1D); False at an EOL or a bad code (`done1d`)."""
        while True:
            state, _, param = self.lookup(table_bits, table)
            if state == S_EOL:
                self.eolcnt = 1
                return False
            if state == term:
                self.setvalue(param)
                return True
            if state in (makeup, S_MAKEUP):
                self.a0 += param
                self.run_length += param
                continue
            return False  # unexpected(...)

    def expand_1d(self) -> None:
        """EXPAND1D; raises _Eof after cleaning up at the end of data."""
        try:
            while True:
                if not self._colour_run(12, WHITE, S_TERMW, S_MAKEUPW):
                    break
                if self.a0 >= self.lastx:
                    break
                if not self._colour_run(13, BLACK, S_TERMB, S_MAKEUPB):
                    break
                if self.a0 >= self.lastx:
                    break
                if self.runs[self.pa - 1] == 0 and self.runs[self.pa - 2] == 0:
                    self.pa -= 2
        except _Eof:
            self.cleanup_runs()
            raise
        self.cleanup_runs()

    def check_b1(self) -> None:
        if self.pa != self.thisrun:
            while self.b1 <= self.a0 and self.b1 < self.lastx:
                if self.pb + 1 >= self.ref + self.nruns:
                    raise _Fail("buffer overflow")
                self.b1 = _i32(self.b1 + self.runs[self.pb]
                               + self.runs[self.pb + 1])
                self.pb += 2

    def _horizontal_run(self, black: bool) -> bool:
        table_bits, table = (13, BLACK) if black else (12, WHITE)
        term, makeup = (S_TERMB, S_MAKEUPB) if black else (S_TERMW, S_MAKEUPW)
        while True:
            state, _, param = self.lookup(table_bits, table)
            if state == term:
                self.setvalue(param)
                return True
            if state in (makeup, S_MAKEUP):
                self.a0 += param
                self.run_length += param
                continue
            return False

    def expand_2d(self) -> None:
        """EXPAND2D; raises _Eof after cleaning up at the end of data."""
        try:
            self._expand_2d()
        except _Eof:
            self.cleanup_runs()
            raise
        self.cleanup_runs()

    def _expand_2d(self) -> None:
        lastx = self.lastx
        while self.a0 < lastx:
            if self.pa >= self.thisrun + self.nruns:
                raise _Fail("buffer overflow")
            state, _, param = self.lookup(7, MAIN, wide=False)
            if state == S_PASS:
                self.check_b1()
                if self.pb + 1 >= self.ref + self.nruns:
                    raise _Fail("buffer overflow")
                self.b1 = _i32(self.b1 + self.runs[self.pb])
                self.pb += 1
                self.run_length = _i32(self.run_length + self.b1 - self.a0)
                self.a0 = self.b1
                self.b1 = _i32(self.b1 + self.runs[self.pb])
                self.pb += 1
            elif state == S_HORIZ:
                black_first = (self.pa - self.thisrun) & 1
                if not (self._horizontal_run(bool(black_first))
                        and self._horizontal_run(not black_first)):
                    return  # unexpected: goto eol2d
                self.check_b1()
            elif state in (S_V0, S_VR):
                self.check_b1()
                self.setvalue(self.b1 - self.a0 + param)
                if self.pb >= self.ref + self.nruns:
                    raise _Fail("buffer overflow")
                self.b1 = _i32(self.b1 + self.runs[self.pb])
                self.pb += 1
            elif state == S_VL:
                self.check_b1()
                if self.b1 < self.a0 + param:
                    return
                self.setvalue(self.b1 - self.a0 - param)
                self.pb -= 1
                self.b1 = _i32(self.b1 - self.runs[self.pb])
            elif state == S_EXT:
                self.runs[self.pa] = (lastx - self.a0) & 0xFFFFFFFF
                self.pa += 1
                return
            elif state == S_EOL:
                self.runs[self.pa] = (lastx - self.a0) & 0xFFFFFFFF
                self.pa += 1
                self.need(4, False)
                self.clr(4)
                self.eolcnt = 1
                return
            else:
                return
        if self.run_length:
            if self.run_length + self.a0 < lastx:
                self.need(1, False)
                if not self.get(1):
                    return  # badMain2d
                self.clr(1)
            self.setvalue(0)

    def begin_2d_row(self) -> None:
        self.pb = self.ref
        self.b1 = _i32(self.runs[self.pb])
        self.pb += 1

    def end_2d_row(self) -> None:
        self.cur, self.ref = self.ref, self.cur


def decode(data: bytes, width: int, rows: int, compression: int,
           t4options: int = 0, fill_order: int = 1,
           codec: dict | None = None) -> tuple[np.ndarray, bool]:
    """One strip or tile of CCITT data → (its rows [rows, width] of 0/1,
    1 black; False where libtiff's decoder returns -1, the rows decoded
    until then kept and the rest 0). `codec` is the state libtiff keeps
    from one strip of an image to the next: pass one dict for all of an
    image's strips. A T.4 strip in which the search for an EOL runs out
    of data is decoded again from its start as if it had no EOLs, from the
    row where the search began, and so is every later strip
    (FAXMODE_NOEOL, which libtiff 4.7 sets then)."""
    codec = {} if codec is None else codec
    two_d = compression == 4 or (compression == 3 and t4options & 1)
    fax = _Fax(bytes(data), width, bool(two_d), fill_order != 2, codec)
    out = np.zeros((rows, width), np.uint8)
    try:
        for line in range(rows):
            fax.start_row()
            if compression == 4:
                fax.begin_2d_row()
                try:
                    fax.expand_2d()
                    ended = bool(fax.eolcnt)
                except _Eof:
                    ended = True
                if ended:
                    # EOFG4: take the 13 bits of an EOFB, fill the row, and
                    # keep the strip unless this was its first row.
                    try:
                        fax.need(13, True)
                    except _Eof:
                        pass
                    fax.clr(13)
                    fax.fill(out[line])
                    return out, line > 0
                fax.fill(out[line])
                fax.setvalue(0)
                fax.end_2d_row()
                continue
            try:
                if compression == 2:
                    fax.expand_1d()
                else:
                    try:
                        if not codec.get("noeol"):
                            try:
                                fax.sync_eol()
                            except _NoEol:
                                codec["noeol"] = True
                                fax.restart()
                        if two_d:
                            fax.need(1, False)
                            is_1d = fax.get(1)
                            fax.clr(1)
                    except _Eof:
                        fax.cleanup_runs()
                        raise
                    if two_d:
                        fax.begin_2d_row()
                        fax.expand_1d() if is_1d else fax.expand_2d()
                    else:
                        fax.expand_1d()
            except _Eof:
                fax.fill(out[line])
                raise _Fail("the data ends before the strip's rows")
            fax.fill(out[line])
            if compression == 2:
                fax.clr(fax.avail & 7)  # rows aligned to bytes
            elif two_d:
                if fax.pa < fax.thisrun + fax.nruns:
                    fax.setvalue(0)
                fax.end_2d_row()
    except _Fail:
        return out, False
    return out, True
