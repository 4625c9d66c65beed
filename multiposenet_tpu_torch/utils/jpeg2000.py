"""JPEG 2000 as OpenCV 5.0 reads it through OpenJPEG 2.5.3
(`grfmt_jpeg2000_openjpeg.cpp`, `opj_decode` in strict mode).

cv2 takes a JP2 file (its signature box first) or a bare J2K codestream
(`FF 4F FF 51`). Then, step for step as OpenJPEG walks it:
- the JP2 boxes (`opj_jp2_read_header_procedure`): the signature and
  `ftyp` boxes first, `jp2h` with its `ihdr`, the first `colr`, `bpcc`,
  `pclr` and `cmap` (palettes looked up as `opj_jp2_apply_pclr` does),
  `cdef` (channels swapped as `opj_jp2_apply_cdef` does), unknown boxes
  skipped, up to `jp2c`, whose codestream runs to the end of the file
  (its length is not used);
- the main header (`opj_j2k_read_header_procedure`): SIZ, COD/COC,
  QCD/QCC, RGN, POC, TLM, PLM, CRG, COM, CAP and CPF, unknown markers
  skipped two bytes at a time as `opj_j2k_read_unk` skips them, each
  marker checked where OpenJPEG checks it;
- the tile parts (`opj_j2k_read_tile_header`, `opj_j2k_read_sod`,
  `opj_j2k_decode_tile`): SOT, tile-part COD/COC/QCD/QCC/RGN/POC/PLT/COM,
  SOD, the tile-part counts (with OpenJPEG's TPsot == TNsot correction
  where cv2 makes it), Psot 0 (data to two bytes before the end), and
  EOC. Strict mode refuses a tile part longer than the data left and a
  stream that ends before the marker after a tile. Tiles left out stay
  black;
- each tile (`opj_tcd_decode_tile`): its geometry as `opj_tcd_init_tile`
  lays it out (resolutions, sub-bands, precincts, code-blocks, with their
  ceiling divisions), tier 2 (`t2.c`: the five progression orders and POC
  as `pi.c` iterates them, tag trees, pass counts, Lblock, bit stuffing,
  SOP and EPH), tier 1 (`t1.c` and `mqc.c`: the MQ decoder with its
  synthetic 0xFF 0xFF after each segment, the three passes and their
  contexts, the half-step reconstruction at the last decoded bit-plane,
  ROI shifts), dequantisation, the inverse 5/3 (integer) and 9/7 (float32
  lifting in `opj_v8dwt_decode`'s order of operations, with its 2/K
  scaling of the high bands) transforms, the inverse RCT and ICT
  (`opj_mct_decode`, `opj_mct_decode_real`), the DC level shift, rounding
  with `lrintf` (half to even) and the clamp to the precision;
- OpenCV's checks and conversion: 1 to 4 components, unsigned, precision
  at least 8, every component of the image's size at offset 0 (no
  sub-sampling, no image offset); sRGB (and an unknown or unspecified
  colour space) with 3 or 4 components reads R, G, B (alpha dropped),
  gray repeats its first component; each sample shifted right by the
  largest precision less 8.

Tiers 2 and 1, the transforms and the level shift run in the host C
library `csrc/jpeg2000.c` (`kernels.load_host("jpeg2000")`), one call a
tile; `decode(..., plain=True)` runs their plain Python versions here.
Everything before them (boxes, markers, the tile walk) and after them
(OpenCV's conversion) is this module's on both paths.

What OpenJPEG decodes but nothing here can make a fixture of is refused
by a ValueError that names it: HT code-blocks (Part 15) and the Part 2
multi-component markers MCC, MCO and CBD.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from multiposenet_tpu_torch import kernels

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"

MAXRLVLS = 33
MAXBANDS = 3 * MAXRLVLS - 2
MAX_POCS = 32

SIZ, COD, COC, TLM, PLM, PLT = 0xFF51, 0xFF52, 0xFF53, 0xFF55, 0xFF57, 0xFF58
QCD, QCC, RGN, POC, PPM, PPT, CRG, COM = (0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F,
                                          0xFF60, 0xFF61, 0xFF63, 0xFF64)
SOT, SOP, SOD, EOC = 0xFF90, 0xFF91, 0xFF93, 0xFFD9
CAP, CPF, MCT, MCC, MCO, CBD = 0xFF50, 0xFF59, 0xFF74, 0xFF75, 0xFF77, 0xFF78

# Decoder states (j2k.h).
MHSOC, MHSIZ, MH, TPHSOT, TPH, NEOC, DATA, EOC_STATE = (
    0x01, 0x02, 0x04, 0x08, 0x10, 0x40, 0x80, 0x100)

# Marker → the states where OpenJPEG accepts it.
_MARKER_STATES = {
    SOT: MH | TPHSOT, COD: MH | TPH, COC: MH | TPH, RGN: MH | TPH,
    QCD: MH | TPH, QCC: MH | TPH, POC: MH | TPH, SIZ: MHSIZ, TLM: MH,
    PLM: MH, PLT: TPH, PPM: MH, PPT: TPH, SOP: 0, CRG: MH, COM: MH | TPH,
    MCT: MH | TPH, CBD: MH, CAP: MH, CPF: MH, MCC: MH | TPH, MCO: MH | TPH,
}
_UNKNOWN_STATES = MH | TPH
_REFUSED_MARKERS = {MCC: "MCC (Part 2 multi-component collection)",
                    MCO: "MCO (Part 2 multi-component ordering)",
                    CBD: "CBD (Part 2 component bit depth)"}
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")

# OpenJPEG's colour spaces (opj_jp2 enumcs → OPJ_CLRSPC_*) as OpenCV 5.0
# switches on them.
_ENUMCS = {16: "sRGB", 17: "gray", 18: "sYCC", 24: "eYCC", 12: "CMYK"}


class _Stream:
    """An OpenJPEG memory stream: reads and skips stop at the end and
    return what they got."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def left(self) -> int:
        return len(self.data) - self.pos

    def read(self, n: int) -> bytes:
        chunk = self.data[self.pos:self.pos + n]
        self.pos += len(chunk)
        return chunk

    def skip(self, n: int) -> int:
        n = min(n, self.left())
        self.pos += n
        return n


def _be(data: bytes, at: int, n: int) -> int:
    return int.from_bytes(data[at:at + n], "big")


# --- the JP2 boxes -----------------------------------------------------------


class _Jp2:
    """What the JP2 boxes say: ihdr's size, the first colr's enumerated
    colour space, the palette and cdef's channel definitions."""

    def __init__(self):
        self.state = 0  # 1 signature, 2 ftyp, 4 jp2h, 8 codestream
        self.ihdr = None
        self.has_colr = False
        self.enumcs = 0
        self.cdef = None
        self.pclr = None  # (channel sizes, entries [NE][NPC])
        self.cmap = None  # [(component, mapping type, palette column)]


_SIGNATURE, _FILE_TYPE, _HEADER, _CODESTREAM = 1, 2, 4, 8
_HEADER_BOXES = (b"jP  ", b"ftyp", b"jp2h")
_IMAGE_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")


def _box_header(s: _Stream):
    """opj_jp2_read_boxhdr: (length, type, header bytes) or None at the
    end of the data."""
    head = s.read(8)
    if len(head) != 8:
        return None
    length, kind = _be(head, 0, 4), head[4:8]
    read = 8
    if length == 0:
        return s.left() + 8, kind, read
    if length == 1:
        xl = s.read(8)
        if len(xl) != 8:
            return None
        if _be(xl, 0, 4):
            raise ValueError("JP2 box larger than 2^32 bytes")
        length, read = _be(xl, 4, 4), 16
    return length, kind, read


def read_jp2(data: bytes) -> tuple[_Jp2, int]:
    """The JP2 boxes up to `jp2c` (opj_jp2_read_header): (what they say,
    where the codestream starts)."""
    jp2 = _Jp2()
    s = _Stream(data)
    while True:
        box = _box_header(s)
        if box is None:
            break
        length, kind, read = box
        if kind == b"jp2c":
            if not jp2.state & _HEADER:
                raise ValueError("JP2 codestream box before the jp2h box")
            jp2.state |= _CODESTREAM
            break
        if length < read:
            raise ValueError(f"JP2 box {kind!r} of length {length}")
        size = length - read
        if kind in _HEADER_BOXES or kind in _IMAGE_BOXES:
            if kind not in _HEADER_BOXES and not jp2.state & _HEADER:
                if s.skip(size) != size:  # ignored before jp2h
                    raise ValueError(f"JP2 box {kind!r} past the data")
                continue
            if size > s.left():
                raise ValueError(f"JP2 box {kind!r} of {size} bytes past "
                                 "the data")
            if size == 0:
                raise ValueError(f"empty JP2 box {kind!r}")
            payload = s.read(size)
            if kind in _HEADER_BOXES:
                _HEADER_READERS[kind](jp2, payload)
            else:
                _image_box(jp2, kind, payload)
        else:
            if not jp2.state & _SIGNATURE:
                raise ValueError("JP2 file whose first box is not the "
                                 "signature box")
            if not jp2.state & _FILE_TYPE:
                raise ValueError("JP2 file whose second box is not ftyp")
            if s.skip(size) != size:
                raise ValueError(f"JP2 box {kind!r} past the data")
    if not jp2.state & _HEADER:
        raise ValueError("JP2 file without a jp2h box")
    if jp2.ihdr is None:
        raise ValueError("JP2 file without an ihdr box")
    return jp2, s.pos


def _read_signature(jp2: _Jp2, payload: bytes) -> None:
    if jp2.state:
        raise ValueError("JP2 signature box that is not the first box")
    if len(payload) != 4 or payload != b"\r\n\x87\n":
        raise ValueError("bad JP2 signature box")
    jp2.state |= _SIGNATURE


def _read_ftyp(jp2: _Jp2, payload: bytes) -> None:
    if jp2.state != _SIGNATURE:
        raise ValueError("JP2 ftyp box that is not the second box")
    if len(payload) < 8 or (len(payload) - 8) % 4:
        raise ValueError(f"JP2 ftyp box of {len(payload)} bytes")
    jp2.state |= _FILE_TYPE


def _read_jp2h(jp2: _Jp2, payload: bytes) -> None:
    if not jp2.state & _FILE_TYPE:
        raise ValueError("JP2 jp2h box before ftyp")
    has_ihdr = False
    pos, size = 0, len(payload)
    while size > 0:
        if size < 8:
            raise ValueError("JP2 jp2h box with a sub-box under 8 bytes")
        length, kind, read = _be(payload, pos, 4), payload[pos + 4:pos + 8], 8
        if length == 1:
            if size < 16:
                raise ValueError("JP2 jp2h box with a short XL sub-box")
            if _be(payload, pos + 8, 4):
                raise ValueError("JP2 box larger than 2^32 bytes")
            length, read = _be(payload, pos + 12, 4), 16
        if length == 0:
            raise ValueError("JP2 sub-box of undefined size")
        if length < read or length > size:
            raise ValueError(f"JP2 jp2h sub-box {kind!r} of length {length}")
        if kind in _IMAGE_BOXES:
            _image_box(jp2, kind, payload[pos + read:pos + length])
        if kind == b"ihdr":
            has_ihdr = True
        pos += length
        size -= length
    if not has_ihdr:
        raise ValueError("JP2 jp2h box without ihdr")
    jp2.state |= _HEADER


def _image_box(jp2: _Jp2, kind: bytes, payload: bytes) -> None:
    """opj_jp2_read_ihdr, _colr, _bpcc, _cdef (pclr and cmap named)."""
    if kind == b"ihdr":
        if jp2.ihdr is not None:
            return  # the first ihdr box counts
        if len(payload) != 14:
            raise ValueError("JP2 ihdr box of other than 14 bytes")
        h, w, nc = struct.unpack(">IIH", payload[:10])
        if nc == 0 or nc > 16384:
            raise ValueError(f"JP2 ihdr box with {nc} components")
        jp2.ihdr = (h, w, nc, payload[10])
    elif kind == b"colr":
        if len(payload) < 3:
            raise ValueError("JP2 colr box under 3 bytes")
        if jp2.has_colr:
            return  # only the first colr box counts
        if payload[0] == 1:  # an enumerated colour space
            if len(payload) < 7:
                raise ValueError("JP2 colr box under 7 bytes")
            jp2.enumcs = _be(payload, 3, 4)
            jp2.has_colr = True
        elif payload[0] == 2:  # an ICC profile: the colour space stays
            jp2.has_colr = True
    elif kind == b"bpcc":
        if jp2.ihdr is None:
            raise ValueError("JP2 bpcc box before ihdr")
        if len(payload) != jp2.ihdr[2]:
            raise ValueError("JP2 bpcc box of the wrong size")
    elif kind == b"cdef":
        if jp2.cdef is not None:
            raise ValueError("JP2 file with two cdef boxes")
        if len(payload) < 2:
            raise ValueError("JP2 cdef box under 2 bytes")
        n = _be(payload, 0, 2)
        if n == 0:
            raise ValueError("JP2 cdef box of no channels")
        if len(payload) < 2 + 6 * n:
            raise ValueError("JP2 cdef box shorter than its channels")
        jp2.cdef = [struct.unpack(">HHH", payload[2 + 6 * i:8 + 6 * i])
                    for i in range(n)]
    elif kind == b"pclr":
        _read_pclr(jp2, payload)
    elif kind == b"cmap":
        if jp2.pclr is None:
            raise ValueError("JP2 cmap box before pclr")
        if jp2.cmap is not None:
            raise ValueError("JP2 file with two cmap boxes")
        n = len(jp2.pclr[0])
        if len(payload) < 4 * n:
            raise ValueError("JP2 cmap box shorter than its channels")
        jp2.cmap = [list(struct.unpack(">HBB", payload[4 * i:4 * i + 4]))
                    for i in range(n)]


def _read_pclr(jp2: _Jp2, payload: bytes) -> None:
    """opj_jp2_read_pclr."""
    if jp2.pclr is not None:
        raise ValueError("JP2 file with two pclr boxes")
    if len(payload) < 3:
        raise ValueError("JP2 pclr box under 3 bytes")
    entries, channels = _be(payload, 0, 2), payload[2]
    if not 1 <= entries <= 1024:
        raise ValueError(f"JP2 pclr box of {entries} entries")
    if channels == 0 or len(payload) < 3 + channels:
        raise ValueError(f"JP2 pclr box of {channels} columns")
    sizes = [(b & 0x7F) + 1 for b in payload[3:3 + channels]]
    pos, table = 3 + channels, []
    for _ in range(entries):
        row = []
        for size in sizes:
            n = min((size + 7) >> 3, 4)
            if pos + n > len(payload):
                raise ValueError("JP2 pclr box shorter than its entries")
            row.append(_be(payload, pos, n))
            pos += n
        table.append(row)
    jp2.pclr = (sizes, table)


_HEADER_READERS = {b"jP  ": _read_signature, b"ftyp": _read_ftyp,
                   b"jp2h": _read_jp2h}


# --- the codestream: main header and tile-part headers -----------------------


class _Tccp:
    """One tile-component's coding and quantisation parameters."""

    def __init__(self):
        self.csty = 0
        self.numres = 0
        self.cblkw = self.cblkh = 0
        self.cblksty = 0
        self.qmfbid = 0
        self.prcw = [15] * MAXRLVLS
        self.prch = [15] * MAXRLVLS
        self.qntsty = 0
        self.numgbits = 0
        self.expn = [0] * MAXBANDS
        self.mant = [0] * MAXBANDS
        self.roishift = 0

    def copy(self) -> "_Tccp":
        c = _Tccp()
        c.__dict__.update(self.__dict__)
        c.prcw, c.prch = list(self.prcw), list(self.prch)
        c.expn, c.mant = list(self.expn), list(self.mant)
        return c


class _Tcp:
    """One tile's (or the main header's default) coding parameters and
    the tile's data as its parts arrive."""

    def __init__(self, numcomps: int):
        self.csty = 0
        self.prg = 0
        self.numlayers = 0
        self.mct = 0
        self.tccps = [_Tccp() for _ in range(numcomps)]
        self.pocs: list[tuple] = []
        self.poc = False
        self.ppt: dict[int, bytes] = {}
        self.ppt_data: bytes | None = None
        self.data: bytearray | None = None
        self.nb_parts = 0
        self.part = -1

    def copy(self) -> "_Tcp":
        t = _Tcp(0)
        t.__dict__.update(self.__dict__)
        t.tccps = [c.copy() for c in self.tccps]
        t.pocs = list(self.pocs)
        t.ppt = dict(self.ppt)
        return t


class Image:
    """SIZ: the image and tile grid and each component's precision,
    sign and sub-sampling."""

    def __init__(self, x0, y0, x1, y1, tx0, ty0, tdx, tdy, comps):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.tx0, self.ty0, self.tdx, self.tdy = tx0, ty0, tdx, tdy
        self.comps = comps  # [(prec, sgnd, dx, dy)]
        self.tw = -(-(x1 - tx0) // tdx)
        self.th = -(-(y1 - ty0) // tdy)

    def tile_bounds(self, tileno: int) -> tuple[int, int, int, int]:
        p, q = tileno % self.tw, tileno // self.tw
        return (max(self.tx0 + p * self.tdx, self.x0),
                max(self.ty0 + q * self.tdy, self.y0),
                min(self.tx0 + (p + 1) * self.tdx, self.x1),
                min(self.ty0 + (q + 1) * self.tdy, self.y1))


class _Codestream:
    """OpenJPEG's j2k decoder state while it walks the codestream."""

    def __init__(self, data: bytes, start: int, ihdr):
        self.s = _Stream(data, start)
        self.ihdr = ihdr
        self.state = MHSOC
        self.image: Image | None = None
        self.default: _Tcp | None = None
        self.tcps: list[_Tcp] = []
        self.tile = 0
        self.sot_length = 0
        self.last_tile_part = False
        self.can_decode = False
        self.correction_checked = False
        self.parts_correction = 0
        self.ppm: dict[int, bytes] = {}
        self.ppm_data: bytes | None = None
        self.ppm_pos = 0

    # main header ------------------------------------------------------------

    def read_header(self) -> None:
        s = self.s
        if s.read(2) != b"\xff\x4f":
            raise ValueError("codestream without its SOC marker")
        self.state = MHSIZ
        head = s.read(2)
        if len(head) != 2:
            raise ValueError("codestream ends in its main header")
        marker = _be(head, 0, 2)
        found = set()
        while marker != SOT:
            if marker < 0xFF00:
                raise ValueError(f"codestream: a marker was expected, not "
                                 f"{marker:#06x}")
            if marker not in _MARKER_STATES:
                marker = self._skip_unknown()
                if marker == SOT:
                    break
            found.add(marker)
            if not self.state & _MARKER_STATES[marker]:
                raise ValueError(f"codestream: marker {marker:#06x} out of "
                                 "place")
            head = s.read(2)
            if len(head) != 2:
                raise ValueError("codestream ends in its main header")
            size = _be(head, 0, 2)
            if size < 2:
                raise ValueError(f"codestream: marker {marker:#06x} of "
                                 f"size {size}")
            body = s.read(size - 2)
            if len(body) != size - 2:
                raise ValueError("codestream ends in its main header")
            self._marker(marker, body)
            head = s.read(2)
            if len(head) != 2:
                raise ValueError("codestream ends in its main header")
            marker = _be(head, 0, 2)
        for need, name in ((SIZ, "SIZ"), (COD, "COD"), (QCD, "QCD")):
            if need not in found:
                raise ValueError(f"codestream without its {name} marker")
        self._merge_ppm()
        # opj_j2k_copy_default_tcp_and_create_tcd
        self.tcps = [self.default.copy()
                     for _ in range(self.image.tw * self.image.th)]
        self.state = TPHSOT

    def _skip_unknown(self) -> int:
        """opj_j2k_read_unk: two bytes at a time up to a known marker
        that may stand here."""
        while True:
            head = self.s.read(2)
            if len(head) != 2:
                raise ValueError("codestream ends after an unknown marker")
            marker = _be(head, 0, 2)
            if marker < 0xFF00:
                continue
            states = _MARKER_STATES.get(marker, _UNKNOWN_STATES)
            if not self.state & states:
                raise ValueError(f"codestream: marker {marker:#06x} out of "
                                 "place")
            if marker in _MARKER_STATES:
                return marker

    def _tcp(self) -> _Tcp:
        return self.tcps[self.tile] if self.state == TPH else self.default

    def _marker(self, marker: int, body: bytes) -> None:
        if marker in _REFUSED_MARKERS:
            raise ValueError(f"JPEG 2000 {_REFUSED_MARKERS[marker]} is not "
                             "read here")
        handler = {SIZ: self._siz, COD: self._cod, COC: self._coc,
                   QCD: self._qcd, QCC: self._qcc, RGN: self._rgn,
                   POC: self._poc, TLM: self._tlm, PLM: self._plm,
                   PLT: self._plt, CRG: self._crg, SOT: self._sot,
                   MCT: self._mct, PPM: self._ppm,
                   PPT: self._ppt}.get(marker)
        if handler is not None:
            handler(body)

    def _siz(self, b: bytes) -> None:
        if len(b) < 36 or (len(b) - 36) % 3:
            raise ValueError("SIZ marker of the wrong size")
        (rsiz, x1, y1, x0, y0, tdx, tdy, tx0, ty0,
         nc) = struct.unpack(">HIIIIIIIIH", b[:36])
        if nc != (len(b) - 36) // 3:
            raise ValueError("SIZ marker size and component count differ")
        if nc == 0 or nc > 16384:
            raise ValueError(f"SIZ marker with {nc} components")
        if x0 >= x1 or y0 >= y1:
            raise ValueError("SIZ marker: negative or zero image size")
        if tdx == 0 or tdy == 0:
            raise ValueError("SIZ marker: invalid tile size")
        if (tx0 > x0 or ty0 > y0 or min(tx0 + tdx, 0xFFFFFFFF) <= x0
                or min(ty0 + tdy, 0xFFFFFFFF) <= y0):
            raise ValueError("SIZ marker: illegal tile offset")
        if self.ihdr is not None and self.ihdr[:2] != (y1 - y0, x1 - x0):
            raise ValueError("SIZ marker and the JP2 ihdr box differ in "
                             "size")
        comps = []
        for i in range(nc):
            ssiz, dx, dy = b[36 + 3 * i:39 + 3 * i]
            prec, sgnd = (ssiz & 0x7F) + 1, ssiz >> 7
            if not (1 <= dx <= 255 and 1 <= dy <= 255):
                raise ValueError(f"SIZ marker: component {i} sub-sampling "
                                 f"{dx}x{dy}")
            if prec > 31:
                raise ValueError(f"SIZ marker: component {i} of {prec} bits")
            comps.append((prec, sgnd, dx, dy))
        self.image = Image(x0, y0, x1, y1, tx0, ty0, tdx, tdy, comps)
        if self.image.tw == 0 or self.image.th == 0 or \
                self.image.tw > 65535 // self.image.th:
            raise ValueError("SIZ marker: invalid number of tiles")
        self.default = _Tcp(nc)
        self.state = MH

    def _spcod(self, tccp: _Tccp, b: bytes, pos: int) -> int:
        """opj_j2k_read_SPCod_SPCoc from `pos`; returns the bytes left."""
        left = len(b) - pos
        if left < 5:
            raise ValueError("COD/COC marker too short")
        tccp.numres = b[pos] + 1
        if tccp.numres > MAXRLVLS:
            raise ValueError(f"COD/COC marker: {tccp.numres} resolutions")
        tccp.cblkw, tccp.cblkh = b[pos + 1] + 2, b[pos + 2] + 2
        if tccp.cblkw > 10 or tccp.cblkh > 10 or \
                tccp.cblkw + tccp.cblkh > 12:
            raise ValueError("COD/COC marker: invalid code-block size")
        tccp.cblksty = b[pos + 3]
        if tccp.cblksty & 0x80:
            raise ValueError("COD/COC marker: mixed HT code-block style")
        tccp.qmfbid = b[pos + 4]
        if tccp.qmfbid > 1:
            raise ValueError("COD/COC marker: invalid wavelet transform")
        left -= 5
        pos += 5
        if tccp.csty & 1:
            if left < tccp.numres:
                raise ValueError("COD/COC marker too short for its "
                                 "precincts")
            for i in range(tccp.numres):
                v = b[pos + i]
                if i and (not v & 0xF or not v >> 4):
                    raise ValueError("COD/COC marker: invalid precinct "
                                     "size")
                tccp.prcw[i], tccp.prch[i] = v & 0xF, v >> 4
            left -= tccp.numres
        else:
            tccp.prcw[:tccp.numres] = [15] * tccp.numres
            tccp.prch[:tccp.numres] = [15] * tccp.numres
        return left

    def _cod(self, b: bytes) -> None:
        tcp = self._tcp()
        if len(b) < 5:
            raise ValueError("COD marker too short")
        tcp.csty = b[0]
        if tcp.csty & ~0x07:
            raise ValueError("COD marker: unknown Scod value")
        tcp.prg = b[1] if b[1] <= 4 else -1
        tcp.numlayers = _be(b, 2, 2)
        if tcp.numlayers < 1:
            raise ValueError("COD marker: no layers")
        tcp.mct = b[4]
        if tcp.mct > 1:
            raise ValueError("COD marker: invalid multiple component "
                             "transform")
        for tccp in tcp.tccps:
            tccp.csty = tcp.csty & 1
        if self._spcod(tcp.tccps[0], b[5:], 0):
            raise ValueError("COD marker of the wrong size")
        first = tcp.tccps[0]
        for tccp in tcp.tccps[1:]:
            tccp.numres, tccp.cblkw, tccp.cblkh = (first.numres, first.cblkw,
                                                   first.cblkh)
            tccp.cblksty, tccp.qmfbid = first.cblksty, first.qmfbid
            tccp.prcw[:first.numres] = first.prcw[:first.numres]
            tccp.prch[:first.numres] = first.prch[:first.numres]

    def _comp_index(self, b: bytes, name: str) -> tuple[int, int]:
        room = 1 if len(self.image.comps) <= 256 else 2
        if len(b) < room:
            raise ValueError(f"{name} marker too short")
        comp = _be(b, 0, room)
        if comp >= len(self.image.comps):
            raise ValueError(f"{name} marker for component {comp}")
        return comp, room

    def _coc(self, b: bytes) -> None:
        tcp = self._tcp()
        room = 1 if len(self.image.comps) <= 256 else 2
        if len(b) < room + 1:
            raise ValueError("COC marker too short")
        comp, room = self._comp_index(b, "COC")
        tcp.tccps[comp].csty = b[room]
        if self._spcod(tcp.tccps[comp], b, room + 1):
            raise ValueError("COC marker of the wrong size")

    def _sqcd(self, tccp: _Tccp, b: bytes, pos: int) -> int:
        """opj_j2k_read_SQcd_SQcc from `pos`; returns the bytes left."""
        left = len(b) - pos
        if left < 1:
            raise ValueError("QCD/QCC marker too short")
        left -= 1
        tccp.qntsty, tccp.numgbits = b[pos] & 0x1F, b[pos] >> 5
        pos += 1
        if tccp.qntsty == 1:
            nbands = 1
        elif tccp.qntsty == 0:
            nbands = left
        else:
            nbands = left // 2
        if tccp.qntsty == 0:
            for i in range(nbands):
                if i < MAXBANDS:
                    tccp.expn[i], tccp.mant[i] = b[pos + i] >> 3, 0
            left -= nbands
        else:
            if left < 2 * nbands:
                raise ValueError("QCD/QCC marker too short")
            for i in range(nbands):
                v = _be(b, pos + 2 * i, 2)
                if i < MAXBANDS:
                    tccp.expn[i], tccp.mant[i] = v >> 11, v & 0x7FF
            left -= 2 * nbands
        if tccp.qntsty == 1:
            for i in range(1, MAXBANDS):
                tccp.expn[i] = max(tccp.expn[0] - (i - 1) // 3, 0)
                tccp.mant[i] = tccp.mant[0]
        return left

    def _qcd(self, b: bytes) -> None:
        tcp = self._tcp()
        if self._sqcd(tcp.tccps[0], b, 0):
            raise ValueError("QCD marker of the wrong size")
        first = tcp.tccps[0]
        for tccp in tcp.tccps[1:]:
            tccp.qntsty, tccp.numgbits = first.qntsty, first.numgbits
            tccp.expn, tccp.mant = list(first.expn), list(first.mant)

    def _qcc(self, b: bytes) -> None:
        comp, room = self._comp_index(b, "QCC")
        if self._sqcd(self._tcp().tccps[comp], b, room):
            raise ValueError("QCC marker of the wrong size")

    def _rgn(self, b: bytes) -> None:
        room = 1 if len(self.image.comps) <= 256 else 2
        if len(b) != 2 + room:
            raise ValueError("RGN marker of the wrong size")
        comp = _be(b, 0, room)
        if comp >= len(self.image.comps):
            raise ValueError(f"RGN marker for component {comp}")
        self._tcp().tccps[comp].roishift = b[room + 1]

    def _poc(self, b: bytes) -> None:
        nc = len(self.image.comps)
        room = 1 if nc <= 256 else 2
        chunk = 5 + 2 * room
        if len(b) < chunk or len(b) % chunk:
            raise ValueError("POC marker of the wrong size")
        tcp = self._tcp()
        old = len(tcp.pocs) if tcp.poc else 0
        if old + len(b) // chunk >= MAX_POCS:
            raise ValueError("too many POC entries")
        tcp.poc = True
        tcp.pocs = tcp.pocs[:old]
        for at in range(0, len(b), chunk):
            resno0 = b[at]
            compno0 = _be(b, at + 1, room)
            layno1 = min(_be(b, at + 1 + room, 2), tcp.numlayers)
            resno1 = b[at + 3 + room]
            compno1 = min(_be(b, at + 4 + room, room), nc)
            prg = b[at + 4 + 2 * room]
            tcp.pocs.append((resno0, compno0, layno1, resno1, compno1, prg))

    def _tlm(self, b: bytes) -> None:
        """Checked for its size only: an ST of 3 or lengths that do not
        divide it only mark the index invalid, and a whole image is
        decoded without it."""
        if len(b) < 2:
            raise ValueError("TLM marker too short")

    def _plm(self, b: bytes) -> None:
        if len(b) < 1:
            raise ValueError("PLM marker too short")

    def _plt(self, b: bytes) -> None:
        if len(b) < 1:
            raise ValueError("PLT marker too short")
        length = 0
        for v in b[1:]:
            length |= v & 0x7F
            length = length << 7 if v & 0x80 else 0
        if length:
            raise ValueError("PLT marker ends inside a length")

    def _ppm(self, b: bytes) -> None:
        """opj_j2k_read_ppm: one chunk of the main header's packet
        headers, by its Zppm."""
        if len(b) < 2:
            raise ValueError("PPM marker too short")
        if b[0] in self.ppm:
            raise ValueError(f"PPM marker Zppm {b[0]} given twice")
        self.ppm[b[0]] = b[1:]

    def _merge_ppm(self) -> None:
        """opj_j2k_merge_ppm: the PPM chunks in Zppm order, their Nppm
        lengths dropped, into one stream of packet headers."""
        if not self.ppm:
            return
        out, remaining = bytearray(), 0
        for z in sorted(self.ppm):
            d = self.ppm[z]
            take = min(remaining, len(d))
            out += d[:take]
            d, remaining = d[take:], remaining - take
            while d:
                if len(d) < 4:
                    raise ValueError("PPM marker: not enough bytes for "
                                     "Nppm")
                n = _be(d, 0, 4)
                d = d[4:]
                out += d[:n]
                remaining = max(n - len(d), 0)
                d = d[n:]
        if remaining:
            raise ValueError("corrupted PPM markers")
        self.ppm_data = bytes(out)

    def _ppt(self, b: bytes) -> None:
        """opj_j2k_read_ppt: one chunk of a tile's packet headers."""
        if len(b) < 2:
            raise ValueError("PPT marker too short")
        if self.ppm:
            raise ValueError("PPT marker after PPM markers")
        tcp = self.tcps[self.tile]
        if b[0] in tcp.ppt:
            raise ValueError(f"PPT marker Zppt {b[0]} given twice")
        tcp.ppt[b[0]] = b[1:]

    def packet_headers(self, tile: int) -> list | None:
        """Where tile's packet headers are read from: [bytes, position]
        of the PPM stream (shared by all tiles) or of the tile's PPT
        chunks, or None for headers in the packets."""
        if self.ppm_data is not None:
            return [self.ppm_data, self.ppm_pos]
        tcp = self.tcps[tile]
        if tcp.ppt_data is not None:
            return [tcp.ppt_data, 0]
        return None

    def _mct(self, b: bytes) -> None:
        """opj_j2k_read_mct's checks: its array is kept but used only by
        a COD transform of 2, which is refused."""
        if len(b) < 2:
            raise ValueError("MCT marker too short")
        if _be(b, 0, 2) == 0 and len(b) <= 6:
            raise ValueError("MCT marker too short")

    def _crg(self, b: bytes) -> None:
        if len(b) != 4 * len(self.image.comps):
            raise ValueError("CRG marker of the wrong size")

    # tile parts --------------------------------------------------------------

    def _sot(self, b: bytes) -> None:
        """opj_j2k_read_sot."""
        if len(b) != 8:
            raise ValueError("SOT marker of the wrong size")
        tile, psot, part, nparts = struct.unpack(">HIBB", b)
        ntiles = self.image.tw * self.image.th
        if tile >= ntiles:
            raise ValueError(f"SOT marker for tile {tile} of {ntiles}")
        self.tile = tile
        tcp = self.tcps[tile]
        if tcp.part + 1 != part:
            raise ValueError(f"tile {tile}: tile part {part} out of order")
        tcp.part = part
        if psot and psot < 14 and psot != 12:
            raise ValueError(f"SOT marker: Psot {psot}")
        if not psot:
            self.last_tile_part = True
        if tcp.nb_parts and part >= tcp.nb_parts:
            self.last_tile_part = True
            raise ValueError(f"tile {tile}: tile part {part} of "
                             f"{tcp.nb_parts}")
        if nparts:
            nparts += self.parts_correction
            if part >= nparts:
                self.last_tile_part = True
                raise ValueError(f"tile {tile}: tile part {part} of "
                                 f"{nparts}")
            tcp.nb_parts = nparts
        if tcp.nb_parts and tcp.nb_parts == part + 1:
            self.can_decode = True
        self.sot_length = 0 if self.last_tile_part else psot - 12
        self.state = TPH

    def _read_sod(self) -> None:
        """opj_j2k_read_sod (strict)."""
        s = self.s
        if self.last_tile_part:
            self.sot_length = (s.left() - 2) & 0xFFFFFFFF
        elif self.sot_length >= 2:
            self.sot_length -= 2
        tcp = self.tcps[self.tile]
        if self.sot_length:
            if self.sot_length > s.left():
                raise ValueError("tile part longer than the data left")
            if tcp.data is None:
                tcp.data = bytearray()
            chunk = s.read(self.sot_length)
        else:
            chunk = b""
        if len(chunk) != self.sot_length:
            self.state = NEOC
        else:
            self.state = TPHSOT
        tcp.data.extend(chunk) if tcp.data is not None else None

    def _needs_parts_correction(self) -> bool:
        """opj_j2k_need_nb_tile_parts_correction: whether the next tile
        part of this tile (found over the SOT markers of others) has a
        TPsot equal to its TNsot."""
        s = self.s
        back = s.pos
        try:
            while True:
                head = s.read(2)
                if len(head) != 2 or _be(head, 0, 2) != SOT:
                    return False
                head = s.read(2)
                if len(head) != 2:
                    raise ValueError("codestream ends in a SOT marker")
                if _be(head, 0, 2) != 10:
                    raise ValueError("SOT marker of the wrong size")
                body = s.read(8)
                if len(body) != 8:
                    raise ValueError("codestream ends in a SOT marker")
                tile, psot, part, nparts = struct.unpack(">HIBB", body)
                if tile == self.tile:
                    return part == nparts
                if psot < 14:
                    return False
                if s.skip(psot - 12) != psot - 12:
                    return False
        finally:
            s.pos = back

    def read_tile_header(self):
        """opj_j2k_read_tile_header: the index of the next tile to decode,
        or None when none is left."""
        s = self.s
        ntiles = self.image.tw * self.image.th
        if self.state == EOC_STATE:
            marker = EOC
        elif self.state != TPHSOT:
            raise ValueError("codestream: tile header out of place")
        else:
            marker = SOT
        while not self.can_decode and marker != EOC:
            while marker != SOD:
                if s.left() == 0:
                    self.state = NEOC
                    break
                head = s.read(2)
                if len(head) != 2:
                    raise ValueError("codestream ends in a tile-part header")
                size = _be(head, 0, 2)
                if size < 2:
                    raise ValueError("tile-part marker of an inconsistent "
                                     "size")
                if marker == 0x8080 and s.left() == 0:
                    self.state = NEOC
                    break
                if self.state & TPH and self.sot_length:
                    if self.sot_length < size + 2:
                        raise ValueError("tile-part header longer than its "
                                         "Psot")
                    self.sot_length -= size + 2
                states = _MARKER_STATES.get(marker, _UNKNOWN_STATES)
                if not self.state & states:
                    raise ValueError(f"codestream: marker {marker:#06x} out "
                                     "of place")
                body = s.read(size - 2)
                if len(body) != size - 2:
                    raise ValueError("codestream ends in a tile-part header")
                if marker not in _MARKER_STATES:
                    raise ValueError(f"codestream: unknown marker "
                                     f"{marker:#06x} in a tile-part header")
                if marker in (CAP, CPF, COM):
                    pass
                else:
                    self._marker(marker, body)
                head = s.read(2)
                if len(head) != 2:
                    raise ValueError("codestream ends in a tile-part header")
                marker = _be(head, 0, 2)
            if s.left() == 0 and self.state == NEOC:
                break
            self._read_sod()
            if self.can_decode and not self.correction_checked \
                    and self.tcps[self.tile].part >= 1:
                # OpenJPEG's look-ahead for a later part whose TPsot
                # equals its TNsot, which cv2 runs only when a tile's
                # last part by TNsot is not its first.
                self.correction_checked = True
                if self._needs_parts_correction():
                    self.can_decode = False
                    self.parts_correction = 1
                    for tcp in self.tcps:
                        if tcp.nb_parts:
                            tcp.nb_parts += 1
            if not self.can_decode:
                head = s.read(2)
                if len(head) != 2:
                    if self.tile + 1 == ntiles:
                        lone = next((t for t in range(ntiles)
                                     if self.tcps[t].part == 0
                                     and self.tcps[t].nb_parts == 0), None)
                        if lone is not None:
                            self.tile = lone
                            marker = EOC
                            self.state = EOC_STATE
                            break
                    raise ValueError("codestream ends after a tile part")
                marker = _be(head, 0, 2)
        if marker == EOC and self.state != EOC_STATE:
            self.tile = 0
            self.state = EOC_STATE
        if not self.can_decode:
            while self.tile < ntiles and self.tcps[self.tile].data is None:
                self.tile += 1
            if self.tile == ntiles:
                return None
        tcp = self.tcps[self.tile]
        if tcp.ppt:  # opj_j2k_merge_ppt, in Zppt order
            if tcp.ppt_data is not None:
                raise ValueError("PPT markers merged twice")
            tcp.ppt_data = b"".join(tcp.ppt[z] for z in sorted(tcp.ppt))
        self.state |= DATA
        return self.tile

    def after_tile(self) -> None:
        """The end of opj_j2k_decode_tile: the marker after the tile must
        be SOT or EOC (strict)."""
        s = self.s
        self.can_decode = False
        self.state &= ~DATA
        if s.left() == 0 and self.state == NEOC:
            return
        if self.state != EOC_STATE:
            head = s.read(2)
            if len(head) != 2:
                raise ValueError("codestream ends after a tile")
            marker = _be(head, 0, 2)
            if marker == EOC:
                self.tile = 0
                self.state = EOC_STATE
            elif marker != SOT:
                if s.left() == 0:
                    self.state = NEOC
                    return
                raise ValueError("codestream: SOT expected after a tile")


# --- tile geometry -----------------------------------------------------------


def _ceildivpow2(a: int, b: int) -> int:
    return -((-a) >> b)


class Band:
    def __init__(self, bandno, x0, y0, x1, y1):
        self.bandno = bandno
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.empty = x0 == x1 or y0 == y1
        self.precincts: list[Precinct] = []


class Precinct:
    def __init__(self, x0, y0, x1, y1, cw, ch):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.cw, self.ch = cw, ch
        self.cblks: list[Cblk] = []
        self.incl = self.imsb = None


class Cblk:
    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = 0
        self.numlenbits = 0
        self.numsegs = 0
        self.segs: list[list[int]] = []  # [maxpasses, numpasses, len,
        #                                   newlen, numnewpasses]
        self.numnewpasses = 0
        self.chunks: list[bytes] = []


class Resolution:
    def __init__(self, x0, y0, x1, y1, pdx, pdy, pw, ph):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.pdx, self.pdy, self.pw, self.ph = pdx, pdy, pw, ph
        self.bands: list[Band] = []


def tile_geometry(bounds, tccp: _Tccp) -> list[Resolution]:
    """opj_tcd_init_tile for one tile-component (no sub-sampling)."""
    tx0, ty0, tx1, ty1 = bounds
    resolutions = []
    n = tccp.numres
    for resno in range(n):
        level = n - 1 - resno
        rx0, ry0 = _ceildivpow2(tx0, level), _ceildivpow2(ty0, level)
        rx1, ry1 = _ceildivpow2(tx1, level), _ceildivpow2(ty1, level)
        pdx, pdy = tccp.prcw[resno], tccp.prch[resno]
        px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
        px1, py1 = (_ceildivpow2(rx1, pdx) << pdx,
                    _ceildivpow2(ry1, pdy) << pdy)
        pw = 0 if rx0 == rx1 else (px1 - px0) >> pdx
        ph = 0 if ry0 == ry1 else (py1 - py0) >> pdy
        res = Resolution(rx0, ry0, rx1, ry1, pdx, pdy, pw, ph)
        if resno == 0:
            cbgx0, cbgy0, cbgw, cbgh = px0, py0, pdx, pdy
            bandnos = (0,)
        else:
            cbgx0, cbgy0 = _ceildivpow2(px0, 1), _ceildivpow2(py0, 1)
            cbgw, cbgh = pdx - 1, pdy - 1
            bandnos = (1, 2, 3)
        cbw, cbh = min(tccp.cblkw, cbgw), min(tccp.cblkh, cbgh)
        for bandno in bandnos:
            if bandno == 0:
                band = Band(0, rx0, ry0, rx1, ry1)
            else:
                xb, yb = bandno & 1, bandno >> 1
                band = Band(bandno,
                            _ceildivpow2(tx0 - (xb << level), level + 1),
                            _ceildivpow2(ty0 - (yb << level), level + 1),
                            _ceildivpow2(tx1 - (xb << level), level + 1),
                            _ceildivpow2(ty1 - (yb << level), level + 1))
            res.bands.append(band)
            if band.empty:
                continue
            for precno in range(pw * ph):
                gx0 = cbgx0 + (precno % pw) * (1 << cbgw)
                gy0 = cbgy0 + (precno // pw) * (1 << cbgh)
                x0, y0 = max(gx0, band.x0), max(gy0, band.y0)
                x1 = min(gx0 + (1 << cbgw), band.x1)
                y1 = min(gy0 + (1 << cbgh), band.y1)
                bx0, by0 = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                bx1 = _ceildivpow2(x1, cbw) << cbw
                by1 = _ceildivpow2(y1, cbh) << cbh
                cw, ch = max((bx1 - bx0) >> cbw, 0), max((by1 - by0) >> cbh,
                                                         0)
                prc = Precinct(x0, y0, x1, y1, cw, ch)
                for cblkno in range(cw * ch):
                    cx0 = bx0 + (cblkno % cw) * (1 << cbw)
                    cy0 = by0 + (cblkno // cw) * (1 << cbh)
                    prc.cblks.append(Cblk(max(cx0, x0), max(cy0, y0),
                                          min(cx0 + (1 << cbw), x1),
                                          min(cy0 + (1 << cbh), y1)))
                if cw * ch:
                    prc.incl, prc.imsb = TagTree(cw, ch), TagTree(cw, ch)
                band.precincts.append(prc)
        resolutions.append(res)
    return resolutions


class TagTree:
    """opj_tgt: a quad-tree of (value, low) nodes over cw x ch leaves."""

    def __init__(self, w: int, h: int):
        parents = []
        levels = [(w, h)]
        while levels[-1][0] * levels[-1][1] > 1:
            lw, lh = levels[-1]
            levels.append(((lw + 1) // 2, (lh + 1) // 2))
        start = 0
        for i, (lw, lh) in enumerate(levels[:-1]):
            up = start + lw * lh
            uw = levels[i + 1][0]
            for y in range(lh):
                for x in range(lw):
                    parents.append(up + (y // 2) * uw + x // 2)
            start = up
        parents.append(-1)
        self.parent = parents
        self.value = [999] * len(parents)
        self.low = [0] * len(parents)

    def decode(self, bio: "_Bio", leaf: int, threshold: int) -> int:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bio.read(1):
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return 1 if self.value[node] < threshold else 0


class _Bio:
    """opj_bio's reader: bits MSB first, 7 bits after an 0xFF byte, zeros
    past the end."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.start, self.end = data, start, end
        self.bp, self.buf, self.ct = start, 0, 0

    def _bytein(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.bp < self.end:
            self.buf |= self.data[self.bp]
            self.bp += 1

    def read(self, n: int) -> int:
        v = 0
        for i in range(n - 1, -1, -1):
            if self.ct == 0:
                self._bytein()
            self.ct -= 1
            v |= ((self.buf >> self.ct) & 1) << i
        return v

    def inalign(self) -> None:
        if self.buf & 0xFF == 0xFF:
            self._bytein()
        self.ct = 0


# --- tier 2: packets ---------------------------------------------------------


def packet_order(bounds, tccps: list[_Tccp], geometry, tcp) -> list[tuple]:
    """(layno, resno, compno, precno) of each packet in decoding order, as
    opj_pi_next_* iterate them for each POC entry (or the COD's order)."""
    tx0, ty0, tx1, ty1 = bounds
    nc = len(tccps)
    max_res = max(t.numres for t in tccps)
    if tcp.poc:
        pocs = [(r0, c0, 0, l1, r1, c1, p) for (r0, c0, l1, r1, c1, p)
                in tcp.pocs]
    else:
        pocs = [(0, 0, 0, tcp.numlayers, max_res, nc, tcp.prg)]
    include = set()
    order = []

    def emit(l, r, c, p):
        key = (l, r, c, p)
        if key not in include:
            include.add(key)
            order.append(key)

    def steps(comps):
        dx = dy = 0
        for c in comps:
            n = tccps[c].numres
            for r in range(n):
                ex = geometry[c][r].pdx + n - 1 - r
                ey = geometry[c][r].pdy + n - 1 - r
                if ex < 32:
                    dx = 1 << ex if not dx else min(dx, 1 << ex)
                if ey < 32:
                    dy = 1 << ey if not dy else min(dy, 1 << ey)
        return dx, dy

    def precinct_at(c, r, x, y):
        """The precinct of (x, y) at comp c res r, or None (the checks of
        opj_pi_next_rpcl/pcrl/cprl)."""
        n = tccps[c].numres
        if r >= n:
            return None
        res = geometry[c][r]
        level = n - 1 - r
        if level >= 31:
            return None
        trx0, try0 = -(-tx0 // (1 << level)), -(-ty0 // (1 << level))
        trx1, try1 = -(-tx1 // (1 << level)), -(-ty1 // (1 << level))
        rpx, rpy = res.pdx + level, res.pdy + level
        if not (y % (1 << rpy) == 0
                or (y == ty0 and (try0 << level) % (1 << rpy))):
            return None
        if not (x % (1 << rpx) == 0
                or (x == tx0 and (trx0 << level) % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (-(-x // (1 << level)) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (-(-y // (1 << level)) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    for r0, c0, l0, l1, r1, c1, prg in pocs:
        if c0 >= nc or c1 >= nc + 1:
            continue
        comps = range(c0, c1)
        if prg in (0, 1):
            outer = ((l, r) for l in range(l0, l1) for r in range(r0, r1)) \
                if prg == 0 else \
                ((l, r) for r in range(r0, r1) for l in range(l0, l1))
            for l, r in outer:
                for c in comps:
                    if r >= tccps[c].numres:
                        continue
                    res = geometry[c][r]
                    for p in range(res.pw * res.ph):
                        emit(l, r, c, p)
        elif prg in (2, 3):
            dx, dy = steps(range(nc))
            if not dx or not dy:
                continue
            if prg == 2:
                for r in range(r0, r1):
                    for y in _positions(ty0, ty1, dy):
                        for x in _positions(tx0, tx1, dx):
                            for c in comps:
                                p = precinct_at(c, r, x, y)
                                if p is not None:
                                    for l in range(l0, l1):
                                        emit(l, r, c, p)
            else:
                for y in _positions(ty0, ty1, dy):
                    for x in _positions(tx0, tx1, dx):
                        for c in comps:
                            for r in range(r0, min(r1, tccps[c].numres)):
                                p = precinct_at(c, r, x, y)
                                if p is not None:
                                    for l in range(l0, l1):
                                        emit(l, r, c, p)
        elif prg == 4:
            for c in comps:
                dx, dy = steps([c])
                if not dx or not dy:
                    break
                for y in _positions(ty0, ty1, dy):
                    for x in _positions(tx0, tx1, dx):
                        for r in range(r0, min(r1, tccps[c].numres)):
                            p = precinct_at(c, r, x, y)
                            if p is not None:
                                for l in range(l0, l1):
                                    emit(l, r, c, p)
    return order


def _positions(start: int, stop: int, step: int):
    v = start
    while v < stop:
        yield v
        v += step - v % step


def read_packets(data: bytes, tcp: _Tcp, geometry, order,
                 trace: list | None = None,
                 headers: list | None = None) -> None:
    """opj_t2_decode_packets: each packet's header and body, the bodies'
    chunks added to their code-blocks. Raises where OpenJPEG fails.
    `trace` receives each packet's (start, end of header, end) in `data`;
    `headers` ([bytes, position], advanced) holds the packet headers when
    PPM or PPT markers carry them."""
    pos, end = 0, len(data)
    sop, eph = tcp.csty & 2, tcp.csty & 4
    for layno, resno, compno, precno in order:
        start = pos
        res = geometry[compno][resno]
        cblksty = tcp.tccps[compno].cblksty
        if layno == 0:
            for band in res.bands:
                if band.empty:
                    continue
                prc = band.precincts[precno]
                if prc.incl is not None:
                    prc.incl.value = [999] * len(prc.incl.value)
                    prc.incl.low = [0] * len(prc.incl.low)
                    prc.imsb.value = [999] * len(prc.imsb.value)
                    prc.imsb.low = [0] * len(prc.imsb.low)
                for cblk in prc.cblks:
                    cblk.numsegs = 0
        if sop and end - pos >= 6 and data[pos] == 0xFF \
                and data[pos + 1] == 0x91:
            pos += 6
        hbuf, hpos = (data, pos) if headers is None else headers
        bio = _Bio(hbuf, hpos, len(hbuf) if headers else end)
        if not bio.read(1):
            bio.inalign()
            hpos = _after_eph(hbuf, bio.bp, bio.end, eph)
            if headers is None:
                pos = hpos
            else:
                headers[1] = hpos
            if trace is not None:
                trace.append((start, pos, pos))
            continue
        for band in res.bands:
            if band.empty:
                continue
            prc = band.precincts[precno]
            for cblkno, cblk in enumerate(prc.cblks):
                if not cblk.numsegs:
                    included = prc.incl.decode(bio, cblkno, layno + 1)
                else:
                    included = bio.read(1)
                if not included:
                    cblk.numnewpasses = 0
                    continue
                if not cblk.numsegs:
                    i = 0
                    while not prc.imsb.decode(bio, cblkno, i):
                        i += 1
                    cblk.numbps = band.numbps + 1 - i
                    cblk.numlenbits = 3
                cblk.numnewpasses = _numpasses(bio)
                cblk.numlenbits += _commacode(bio)
                if not cblk.numsegs:
                    segno = 0
                    _init_seg(cblk, 0, cblksty)
                else:
                    segno = cblk.numsegs - 1
                    if cblk.segs[segno][1] == cblk.segs[segno][0]:
                        segno += 1
                        _init_seg(cblk, segno, cblksty)
                n = cblk.numnewpasses
                while True:
                    seg = cblk.segs[segno]
                    seg[4] = min(seg[0] - seg[1], n)
                    bits = cblk.numlenbits + max(seg[4].bit_length() - 1, 0)
                    if bits > 32:
                        raise ValueError(f"packet header: invalid bit number "
                                         f"{bits}")
                    seg[3] = bio.read(bits)
                    n -= seg[4]
                    if n <= 0:
                        break
                    segno += 1
                    _init_seg(cblk, segno, cblksty)
        bio.inalign()
        hpos = _after_eph(hbuf, bio.bp, bio.end, eph)
        if headers is None:
            pos = hpos
        else:
            headers[1] = hpos
        header_end = pos
        # the body
        for band in res.bands:
            if band.empty:
                continue
            for cblkno, cblk in enumerate(band.precincts[precno].cblks):
                if not cblk.numnewpasses:
                    continue
                if not cblk.numsegs:
                    segno = 0
                    cblk.numsegs = 1
                else:
                    segno = cblk.numsegs - 1
                    if cblk.segs[segno][1] == cblk.segs[segno][0]:
                        segno += 1
                        cblk.numsegs += 1
                while True:
                    seg = cblk.segs[segno]
                    if pos + seg[3] > end:
                        raise ValueError(
                            f"segment too long ({seg[3]}) for code-block "
                            f"{cblkno} (p={precno}, b={band.bandno}, "
                            f"r={resno}, c={compno})")
                    cblk.chunks.append(bytes(data[pos:pos + seg[3]]))
                    pos += seg[3]
                    seg[2] += seg[3]
                    seg[1] += seg[4]
                    cblk.numnewpasses -= seg[4]
                    if cblk.numnewpasses <= 0:
                        break
                    segno += 1
                    cblk.numsegs += 1
        if trace is not None:
            trace.append((start, header_end, pos))


def _after_eph(buf: bytes, pos: int, end: int, eph: int) -> int:
    """Past the EPH marker at `pos` when the COD asks for them (any other
    bytes, or fewer than two, fail the tile)."""
    if not eph:
        return pos
    if end - pos < 2 or buf[pos] != 0xFF or buf[pos + 1] != 0x92:
        raise ValueError("packet header without its EPH marker")
    return pos + 2


def _init_seg(cblk: Cblk, index: int, cblksty: int) -> None:
    """opj_t2_init_seg: a segment's most passes, 1 with TERMALL, 10 then
    2 and 1 in turn with BYPASS, else 109."""
    while len(cblk.segs) <= index:
        cblk.segs.append([109, 0, 0, 0, 0])
    if cblksty & 0x04:
        most = 1
    elif cblksty & 0x01:
        most = 10 if index == 0 else (
            2 if cblk.segs[index - 1][0] in (1, 10) else 1)
    else:
        most = 109
    cblk.segs[index][:] = [most, 0, 0, 0, 0]


def _numpasses(bio: _Bio) -> int:
    if not bio.read(1):
        return 1
    if not bio.read(1):
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


def _commacode(bio: _Bio) -> int:
    n = 0
    while bio.read(1):
        n += 1
    return n


# --- tier 1: code-blocks -----------------------------------------------------

# The MQ coder's states (Table C.2): Qe, next index after an MPS, after an
# LPS, and whether an LPS switches the MPS.
_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
       0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
       0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
       0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
       0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
       0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19,
         20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
         37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16,
         17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
         33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46)
_SWITCH = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1) + (0,) * 32

# Contexts: 0-8 zero coding, 9-13 sign, 14-16 magnitude, 17 run, 18 uniform.
_CTX_SC, _CTX_MAG, _CTX_AGG, _CTX_UNI = 9, 14, 17, 18


def _zc_context(orient: int, h: int, v: int, d: int) -> int:
    """Table D.1 (t1_init_ctxno_zc): LL and LH bands (OpenJPEG's bands 0
    and 2, vertically high-pass) by the horizontal count first, HL (band
    1) with the two counts swapped, HH by the diagonals first."""
    if orient == 1:
        h, v = v, h
    if orient == 3:
        hv = h + v
        if d == 0:
            return min(hv, 2)
        if d == 1:
            return 3 + min(hv, 2)
        if d == 2:
            return 6 if hv == 0 else 7
        return 8
    if h == 0:
        if v == 0:
            return min(d, 2)
        return 3 if v == 1 else 4
    if h == 1:
        if v == 0:
            return 5 if d == 0 else 6
        return 7
    return 8


_ZC = [[_zc_context(o, h, v, d) for h in range(3) for v in range(3)
        for d in range(5)] for o in range(4)]
# (H, V) contributions in -1..1 → (sign context, XOR bit), Table D.3.
_SC = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0), (0, 1): (10, 0),
       (0, 0): (9, 0), (0, -1): (10, 1), (-1, 1): (11, 1), (-1, 0): (12, 1),
       (-1, -1): (13, 1)}


class _MQ:
    """opj_mqc's decoder: MQ over one segment with an 0xFF 0xFF pair after
    it (`init`, `decode`), or raw bits for the bypass passes
    (`raw_init`, `raw`), on the same registers as OpenJPEG keeps them."""

    def __init__(self, st: list, mps: list):
        self.st, self.mps = st, mps
        self.buf, self.bp = b"\xff\xff", 0
        self.a, self.c, self.ct = 0x8000, 0, 0

    def init(self, data: bytes) -> None:
        self.buf = bytes(data) + b"\xff\xff"
        self.bp = 0
        self.c = (0xFF if not data else data[0]) << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def raw_init(self, data: bytes) -> None:
        self.buf = bytes(data) + b"\xff\xff"
        self.bp = 0
        self.c = self.ct = 0

    def raw(self) -> int:
        if self.ct == 0:
            if self.c == 0xFF:
                if self.buf[self.bp] > 0x8F:
                    self.c, self.ct = 0xFF, 8
                else:
                    self.c = self.buf[self.bp]
                    self.bp += 1
                    self.ct = 7
            else:
                self.c = self.buf[self.bp]
                self.bp += 1
                self.ct = 8
        self.ct -= 1
        return (self.c >> self.ct) & 1

    def _bytein(self) -> None:
        buf, bp = self.buf, self.bp
        if buf[bp] == 0xFF:
            if buf[bp + 1] > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += buf[bp + 1] << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c += buf[bp + 1] << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        s = self.st[cx]
        q = _QE[s]
        a = (self.a - q) & 0xFFFFFFFF
        if (self.c >> 16) < q:
            if a < q:
                d = self.mps[cx]
                self.st[cx] = _NMPS[s]
            else:
                d = 1 - self.mps[cx]
                if _SWITCH[s]:
                    self.mps[cx] = d
                self.st[cx] = _NLPS[s]
            a = q
        else:
            self.c -= q << 16
            if a & 0x8000:
                self.a = a
                return self.mps[cx]
            if a < q:
                d = 1 - self.mps[cx]
                if _SWITCH[s]:
                    self.mps[cx] = d
                self.st[cx] = _NLPS[s]
            else:
                d = self.mps[cx]
                self.st[cx] = _NMPS[s]
        while True:
            if self.ct == 0:
                self._bytein()
            a = (a << 1) & 0xFFFFFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if a >= 0x8000:
                break
        self.a = a
        return d


def _reset_contexts(st: list, mps: list) -> None:
    st[:] = [0] * 19
    mps[:] = [0] * 19
    st[_CTX_UNI], st[_CTX_AGG], st[0] = 46, 3, 4


def decode_cblk(segments: list[tuple[bytes, int]], w: int, h: int,
                bpno_plus_one: int, orient: int, cblksty: int = 0,
                numbps: int = 0) -> np.ndarray:
    """opj_t1_decode_cblk: the coefficients, [h, w] int64, at twice their
    scale (the half step below the last decoded bit-plane set). Code-block
    styles: BYPASS (raw significance and refinement passes in segments
    after the fourth bit-plane), RESET (contexts reset after each MQ
    pass), TERMALL and PTERM (segments as tier 2 cut them), VSC (no
    context from the stripe below) and SEGSYM (four symbols after each
    cleanup pass)."""
    lazy, reset = cblksty & 0x01, cblksty & 0x02
    vsc, segsym = cblksty & 0x08, cblksty & 0x20
    W = w + 2
    size = W * (h + 2)
    sig = [0] * size
    neg = [0] * size
    vis = [0] * size
    ref = [0] * size
    val = [0] * size
    # 0 where the row below a coefficient is not its context (VSC).
    below = [0 if vsc and (p // W - 1) % 4 == 3 else 1 for p in range(size)]
    st, mps = [0] * 19, [0] * 19
    _reset_contexts(st, mps)
    mq = _MQ(st, mps)
    zc = _ZC[orient]
    passtype = 2

    def nbrs(p):
        s = below[p]
        return (sig[p - 1] + sig[p + 1], sig[p - W] + s * sig[p + W],
                sig[p - W - 1] + sig[p - W + 1]
                + s * (sig[p + W - 1] + sig[p + W + 1]))

    def sign(p, oph):
        hc = (sig[p - 1] * (1 - 2 * neg[p - 1])
              + sig[p + 1] * (1 - 2 * neg[p + 1]))
        vc = (sig[p - W] * (1 - 2 * neg[p - W])
              + below[p] * sig[p + W] * (1 - 2 * neg[p + W]))
        ctx, xor = _SC[(max(-1, min(1, hc)), max(-1, min(1, vc)))]
        v = mq.decode(ctx) ^ xor
        val[p] = -oph if v else oph
        sig[p] = 1
        neg[p] = v

    for data, passes in segments:
        raw = lazy and bpno_plus_one <= numbps - 4 and passtype < 2
        if raw:
            mq.raw_init(data)
        else:
            mq.init(data)
        for _ in range(passes):
            if bpno_plus_one < 1:
                break
            one = 1 << bpno_plus_one
            oph = one | (one >> 1)
            for y0 in range(0, h, 4):
                y1 = min(y0 + 4, h)
                for x in range(w):
                    col = (y0 + 1) * W + x + 1
                    end = col + (y1 - y0) * W
                    if passtype == 0:
                        for p in range(col, end, W):
                            if sig[p] or vis[p]:
                                continue
                            hh, vv, dd = nbrs(p)
                            if not (hh or vv or dd):
                                continue
                            if raw:
                                if mq.raw():
                                    v = mq.raw()
                                    val[p] = -oph if v else oph
                                    sig[p], neg[p] = 1, v
                            elif mq.decode(zc[hh * 15 + vv * 5 + dd]):
                                sign(p, oph)
                            vis[p] = 1
                    elif passtype == 1:
                        half = one >> 1
                        for p in range(col, end, W):
                            if not sig[p] or vis[p]:
                                continue
                            if raw:
                                v = mq.raw()
                            else:
                                if ref[p]:
                                    ctx = _CTX_MAG + 2
                                else:
                                    hh, vv, dd = nbrs(p)
                                    ctx = _CTX_MAG + (1 if hh or vv or dd
                                                      else 0)
                                v = mq.decode(ctx)
                            val[p] += half if v ^ (val[p] < 0) else -half
                            ref[p] = 1
                    else:
                        start = col
                        if y1 - y0 == 4 and not any(
                                sig[p] or vis[p] or any(nbrs(p))
                                for p in range(col, end, W)):
                            if not mq.decode(_CTX_AGG):
                                continue
                            r = mq.decode(_CTX_UNI) << 1
                            r |= mq.decode(_CTX_UNI)
                            sign(col + r * W, oph)
                            start = col + (r + 1) * W
                        for p in range(start, end, W):
                            if sig[p] or vis[p]:
                                continue
                            hh, vv, dd = nbrs(p)
                            if mq.decode(zc[hh * 15 + vv * 5 + dd]):
                                sign(p, oph)
            if passtype == 2:
                vis = [0] * size
                if segsym:
                    for _ in range(4):
                        mq.decode(_CTX_UNI)
            if reset and not raw:
                _reset_contexts(st, mps)
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno_plus_one -= 1
    out = np.array(val, np.int64).reshape(h + 2, W)
    return out[1:h + 1, 1:w + 1]


# --- the inverse wavelet transforms ------------------------------------------

_K = np.float32(1.230174105)
_TWO_INVK = np.float32(1.625732422)
# -delta, -gamma, -beta, -alpha of Table F.4, as opj_v8dwt_decode passes
# them to its lifting steps.
_LIFT97 = (np.float32(-0.443506852), np.float32(-0.882911075),
           np.float32(0.052980118), np.float32(1.586134342))


def _idwt53(lo: np.ndarray, hi: np.ndarray, cas: int) -> np.ndarray:
    """One inverse 5/3 pass along axis 0 (opj_idwt53_h/v): lo [sn, K],
    hi [dn, K] int64 → [sn + dn, K]."""
    sn, dn = len(lo), len(hi)
    n = sn + dn
    out = np.empty((n,) + lo.shape[1:], np.int64)
    if cas == 0:
        if n == 1:
            return lo.copy()
        i = np.arange(sn)
        even = lo - ((hi[np.clip(i - 1, 0, dn - 1)]
                      + hi[np.clip(i, 0, dn - 1)] + 2) >> 2)
        j = np.arange(dn)
        odd = hi + ((even[j] + even[np.clip(j + 1, 0, sn - 1)]) >> 1)
        out[0::2], out[1::2] = even, odd
    else:
        if n == 1:
            h0 = hi[0]
            return ((h0 + (h0 < 0)) >> 1)[None]  # C's truncating / 2
        i = np.arange(sn)
        odd = lo - ((hi[i] + hi[np.clip(i + 1, 0, dn - 1)] + 2) >> 2)
        j = np.arange(dn)
        even = hi + ((odd[np.clip(j - 1, 0, sn - 1)]
                      + odd[np.clip(j, 0, sn - 1)]) >> 1)
        out[1::2], out[0::2] = odd, even
    return out


def _idwt97(lo: np.ndarray, hi: np.ndarray, cas: int) -> np.ndarray:
    """One inverse 9/7 pass along axis 0 (opj_v8dwt_decode): float32 lo
    [sn, K], hi [dn, K] → [sn + dn, K], in its order of operations: the
    bands scaled by K and 2/K, then four lifting steps, each sample plus
    (left + right) * c, an edge sample plus its one neighbour * 2c."""
    sn, dn = len(lo), len(hi)
    out = np.empty((sn + dn,) + lo.shape[1:], np.float32)
    if (cas == 0 and not (dn > 0 or sn > 1)) or \
            (cas == 1 and not (sn > 0 or dn > 1)):
        out[cas::2], out[1 - cas::2] = lo, hi
        return out
    L = lo * _K
    H = hi * _TWO_INVK
    for step, c in enumerate(_LIFT97):
        c2 = c + c
        if step % 2 == 0:  # the low band from the high band
            if cas == 0:
                m = min(sn, dn)
                left = H[np.maximum(np.arange(m) - 1, 0)]
                L[:m] = L[:m] + ((left + H[:m]) * c)
                if m < sn:
                    L[m] = L[m] + H[m - 1] * c2
            else:
                m = min(sn, dn - 1)
                L[:m] = L[:m] + ((H[:m] + H[1:m + 1]) * c)
                if m < sn:
                    L[m] = L[m] + H[m] * c2
        else:  # the high band from the low band
            if cas == 0:
                m = min(dn, sn - 1)
                H[:m] = H[:m] + ((L[:m] + L[1:m + 1]) * c)
                if m < dn:
                    H[m] = H[m] + L[m] * c2
            else:
                m = min(dn, sn)
                left = L[np.maximum(np.arange(m) - 1, 0)]
                H[:m] = H[:m] + ((left + L[:m]) * c)
                if m < dn:
                    H[m] = H[m] + L[m - 1] * c2
    out[cas::2], out[1 - cas::2] = L, H
    return out


def inverse_dwt(data: np.ndarray, resolutions, numres: int,
                reversible: bool) -> None:
    """opj_dwt_decode_tile / _tile_97 in place on a tile-component's int32
    buffer (9/7 data as float32 in the same bytes): for each resolution
    the rows, then the columns."""
    if numres == 1 or data.shape[1] == 0:
        return
    arr = data if reversible else data.view(np.float32)
    one = _idwt53 if reversible else _idwt97
    work = np.int64 if reversible else np.float32
    for r in range(1, numres):
        lo, cur = resolutions[r - 1], resolutions[r]
        sw, sh = lo.x1 - lo.x0, lo.y1 - lo.y0
        rw, rh = cur.x1 - cur.x0, cur.y1 - cur.y0
        if rh and rw:
            rows = arr[:rh, :rw].astype(work).T
            arr[:rh, :rw] = one(rows[:sw], rows[sw:rw], cur.x0 % 2).T \
                .astype(arr.dtype)
            cols = arr[:rh, :rw].astype(work)
            arr[:rh, :rw] = one(cols[:sh], cols[sh:rh], cur.y0 % 2) \
                .astype(arr.dtype)


# --- one tile, plain ---------------------------------------------------------


def _band_parameters(geometry, tccp: _Tccp, prec: int) -> None:
    """Each band's Mb (numbps) and float32 step size as opj_tcd_init_tile
    sets them (a 9/7 band's gain taken as 0: the 2/K of the transform)."""
    for resno, res in enumerate(geometry):
        for band in res.bands:
            i = 3 * (resno - 1) + band.bandno if resno else 0
            expn, mant = tccp.expn[i], tccp.mant[i]
            gain = 0 if tccp.qmfbid == 0 else (0, 1, 1, 2)[band.bandno]
            band.numbps = expn + tccp.numgbits - 1
            band.stepsize = np.float32((1.0 + mant / 2048.0)
                                       * 2.0 ** (prec + gain - expn))


def check_supported(tcp: _Tcp) -> None:
    """Refuse by name what the decoders here do not implement."""
    for tccp in tcp.tccps:
        if tccp.cblksty & 0x40:
            raise ValueError("JPEG 2000 HT code-blocks (High Throughput, "
                             "Part 15) are not read here")


def decode_tile_plain(bounds, tcp: _Tcp, comps, data: bytes,
                      resno_in: list[int], headers: list | None = None):
    """opj_tcd_decode_tile in Python: the tile's components as int32
    [th, tw], and the image components' highest resolution decoded so far
    (`resno_in` raised by this tile's packets). Each component is
    reconstructed up to that resolution, and only its part of the buffer
    is level-shifted and clamped, as OpenJPEG does when packets of higher
    resolutions are missing."""
    if not tcp.poc and tcp.prg < 0:
        raise ValueError("COD marker: unknown progression order")
    tccps = tcp.tccps
    geometry = [tile_geometry(bounds, t) for t in tccps]
    for c, t in enumerate(tccps):
        _band_parameters(geometry[c], t, comps[c][0])
    order = packet_order(bounds, tccps, geometry, tcp)
    read_packets(data, tcp, geometry, order, headers=headers)
    resno = list(resno_in)
    for _, r, c, _ in order:
        resno[c] = max(resno[c], r)
    tx0, ty0, tx1, ty1 = bounds
    planes = []
    for c, tccp in enumerate(tccps):
        plane = np.zeros((ty1 - ty0, tx1 - tx0), np.int32)
        fplane = plane.view(np.float32)
        for resno_, res in enumerate(geometry[c]):
            for band in res.bands:
                if band.empty:
                    continue
                ox = oy = 0
                if band.bandno & 1:
                    prev = geometry[c][resno_ - 1]
                    ox = prev.x1 - prev.x0
                if band.bandno & 2:
                    prev = geometry[c][resno_ - 1]
                    oy = prev.y1 - prev.y0
                for prc in band.precincts:
                    for cblk in prc.cblks:
                        _cblk_to_plane(cblk, band, tccp, plane, fplane,
                                       ox, oy)
        planes.append(plane)
    for c, tccp in enumerate(tccps):
        inverse_dwt(planes[c], geometry[c], min(resno[c] + 1, tccp.numres),
                    tccp.qmfbid == 1)
    regions = []
    for c, tccp in enumerate(tccps):
        res = geometry[c][min(resno[c], tccp.numres - 1)]
        regions.append((res.y1 - res.y0, res.x1 - res.x0))
    _mct_and_shift(planes, tcp, comps, regions)
    return planes, resno


def _cblk_to_plane(cblk, band, tccp, plane, fplane, ox, oy) -> None:
    w, h = cblk.x1 - cblk.x0, cblk.y1 - cblk.y0
    if w <= 0 or h <= 0:
        return
    bpno = tccp.roishift + cblk.numbps
    bpno = ((bpno + 2 ** 31) % 2 ** 32) - 2 ** 31  # OpenJPEG's int32 sum
    if bpno >= 31:
        raise ValueError(f"code-block of {bpno} bit-planes")
    if cblk.chunks:
        blob = b"".join(cblk.chunks)
        segments, at = [], 0
        for seg in cblk.segs[:cblk.numsegs]:
            segments.append((blob[at:at + seg[2]], seg[1]))
            at += seg[2]
        numbps = ((cblk.numbps + 2 ** 31) % 2 ** 32) - 2 ** 31
        vals = decode_cblk(segments, w, h, bpno, band.bandno, tccp.cblksty,
                           numbps)
    else:
        vals = np.zeros((h, w), np.int64)
    if tccp.roishift:
        if tccp.roishift >= 31:
            vals[:] = 0
        else:
            mag = np.abs(vals)
            big = mag >= (1 << tccp.roishift)
            vals = np.where(big, np.sign(vals) * (mag >> tccp.roishift),
                            vals)
    x, y = cblk.x0 - band.x0 + ox, cblk.y0 - band.y0 + oy
    if tccp.qmfbid == 1:
        plane[y:y + h, x:x + w] = (vals + (vals < 0)) >> 1
    else:
        half = np.float32(0.5) * band.stepsize
        fplane[y:y + h, x:x + w] = vals.astype(np.float32) * half


def _mct_and_shift(planes: list[np.ndarray], tcp: _Tcp, comps,
                   regions) -> None:
    """opj_tcd_mct_decode (over whole planes) and
    opj_tcd_dc_level_shift_decode (over each plane's top-left region of
    its decoded resolution) in place."""
    if tcp.mct and len(planes) >= 3:
        if tcp.tccps[0].qmfbid == 1:
            y, u, v = (p.astype(np.int64) for p in planes[:3])
            g = y - ((u + v) >> 2)
            planes[0][...] = v + g
            planes[1][...] = g
            planes[2][...] = u + g
        else:
            y, u, v = (p.view(np.float32) for p in planes[:3])
            r = y + (v * np.float32(1.402))
            g = (y - (u * np.float32(0.34413))) - (v * np.float32(0.71414))
            b = y + (u * np.float32(1.772))
            planes[0].view(np.float32)[...] = r
            planes[1].view(np.float32)[...] = g
            planes[2].view(np.float32)[...] = b
    for whole, tccp, (prec, sgnd, _, _), (rh, rw) in zip(
            planes, tcp.tccps, comps, regions):
        plane = whole[:rh, :rw]
        shift = 0 if sgnd else 1 << (prec - 1)
        lo, hi = ((-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd
                  else (0, (1 << prec) - 1))
        if tccp.qmfbid == 1:
            v = plane.astype(np.int64) + shift
        else:
            f = plane.view(np.float32)
            with np.errstate(invalid="ignore"):
                r = np.rint(f)
                v = np.where(np.isfinite(r) & (np.abs(r) < 2 ** 62), r,
                             0).astype(np.int64) + shift
                v = np.where(f > np.float32(2 ** 31), hi, v)
                v = np.where((f < np.float32(-2 ** 31)) | np.isnan(f), lo, v)
        plane[...] = np.clip(v, lo, hi)


# --- the whole image ---------------------------------------------------------


def _decode_tiles(cs: _Codestream, plain: bool) -> list[np.ndarray]:
    """opj_j2k_decode_tiles: every tile the walk finds, decoded and pasted
    into the image's components (zeros where no tile was decoded)."""
    img = cs.image
    ntiles = img.tw * img.th
    nc = len(img.comps)
    resno = [0] * nc
    single = (img.tw == 1 and img.th == 1 and img.tx0 == 0 and img.ty0 == 0
              and img.x0 == 0 and img.y0 == 0 and img.x1 == img.tdx
              and img.y1 == img.tdy)
    out: list[np.ndarray | None] = [None] * nc
    done = 0
    while True:
        if not single and img.tw == 1 and img.th == 1 \
                and cs.tcps[0].data is not None:
            tile = 0
            cs.tile = 0
            cs.state |= DATA
        else:
            tile = cs.read_tile_header()
            if tile is None:
                if single:
                    raise ValueError("codestream without tile data")
                break
        tcp = cs.tcps[tile]
        if tcp.data is None:
            raise ValueError(f"tile {tile} without data")
        bounds = img.tile_bounds(tile)
        check_supported(tcp)
        decode_tile = decode_tile_plain if plain else decode_tile_c
        headers = cs.packet_headers(tile)
        planes, resno = decode_tile(bounds, tcp, img.comps, bytes(tcp.data),
                                    resno, headers)
        if cs.ppm_data is not None:
            cs.ppm_pos = headers[1]
        cs.after_tile()
        for c, tccp in enumerate(tcp.tccps):
            if single:
                out[c] = planes[c]
                continue
            if out[c] is None:
                out[c] = np.zeros((img.y1 - img.y0, img.x1 - img.x0),
                                  np.int32)
            # opj_j2k_update_image_data: the decoded resolution's region,
            # at its own coordinates, clipped to the image.
            level = tccp.numres - 1 - min(resno[c], tccp.numres - 1)
            x0, y0, x1, y1 = (_ceildivpow2(v, level) for v in bounds)
            x1, y1 = min(x1, img.x1), min(y1, img.y1)
            out[c][y0:y1, x0:x1] = planes[c][:y1 - y0, :x1 - x0]
        tcp.data = None
        if single:
            break
        if cs.s.left() == 0 and cs.state == NEOC:
            break
        done += 1
        if done == ntiles:
            break
    if any(o is None for o in out):
        raise ValueError("no tile of the image could be decoded")
    return out


def _opencv_header(img: Image) -> int:
    """Jpeg2KOpjDecoderBase::readHeader's checks and imread's size limits
    (validateInputImageSize); the largest precision."""
    w, h = img.x1 - img.x0, img.y1 - img.y0
    if w > 1 << 20 or h > 1 << 20 or w * h > 1 << 30:
        raise ValueError(f"JPEG 2000 image of {w}x{h} pixels, larger than "
                         "cv2 reads")
    nc = len(img.comps)
    if not 1 <= nc <= 4:
        raise ValueError(f"JPEG 2000 image of {nc} components (cv2 reads "
                         "1 to 4)")
    for i, (prec, sgnd, _, _) in enumerate(img.comps):
        if sgnd:
            raise ValueError(f"JPEG 2000 component {i} of signed samples "
                             "(cv2 reads unsigned only)")
    prec = max(c[0] for c in img.comps)
    if prec < 8:
        raise ValueError(f"JPEG 2000 precision {prec} (cv2 reads 8 bits "
                         "and more)")
    return prec


def _check_palette(jp2: _Jp2, ncomps: int) -> None:
    """opj_jp2_check_color's cmap checks (a one-component image's odd
    mapping corrected as OpenJPEG corrects it)."""
    cmap = jp2.cmap
    n = len(cmap)
    sane = all(cmp < ncomps for cmp, _, _ in cmap)
    used = [False] * n
    for i, (_, mtyp, pcol) in enumerate(cmap):
        if mtyp not in (0, 1) or pcol >= n or (used[pcol] and mtyp == 1) \
                or (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
            sane = False
        else:
            used[pcol] = True
    if any(not used[i] and cmap[i][1] != 0 for i in range(n)):
        sane = False
    if sane and ncomps == 1 and not all(used):
        for i, entry in enumerate(cmap):
            entry[1:] = [1, i]
    if not sane:
        raise ValueError("JP2 cmap box maps the palette wrongly")


def _apply_palette(jp2: _Jp2, planes: list) -> list:
    """opj_jp2_apply_pclr: a component for each cmap entry, the index
    component looked up in its palette column (clamped to the entries) or
    used directly."""
    _, table = jp2.pclr
    table = np.array(table, np.int64)
    out = [None] * len(jp2.cmap)
    for i, (cmp, mtyp, pcol) in enumerate(jp2.cmap):
        src = planes[cmp]
        if mtyp == 0:
            out[i] = src.copy()
        else:
            k = np.clip(src, 0, len(table) - 1)
            out[pcol] = table[k, pcol].astype(np.int32)
    return out


def _check_cdef(jp2: _Jp2, n: int) -> None:
    """opj_jp2_check_color's cdef checks against `n` channels."""
    for cn, _, asoc in jp2.cdef:
        if cn >= n:
            raise ValueError(f"JP2 cdef: channel {cn} of {n}")
        if asoc != 65535 and asoc > 0 and asoc - 1 >= n:
            raise ValueError(f"JP2 cdef: colour {asoc} of {n}")
    for c in range(n):
        if not any(e[0] == c for e in jp2.cdef):
            raise ValueError("JP2 cdef: incomplete channel definitions")


def _apply_cdef(jp2: _Jp2, planes: list) -> None:
    """opj_jp2_apply_cdef: each colour channel swapped to its association
    (alpha channels stay; cv2 drops them by position)."""
    info = [list(e) for e in jp2.cdef]
    n = len(planes)
    for i, (cn, typ, asoc) in enumerate(info):
        if cn >= n or asoc in (0, 65535) or asoc - 1 >= n:
            continue
        acn = asoc - 1
        if cn != acn and typ == 0:
            planes[cn], planes[acn] = planes[acn], planes[cn]
            for e in info[i + 1:]:
                if e[0] == cn:
                    e[0] = acn
                elif e[0] == acn:
                    e[0] = cn


def _header(data: bytes) -> tuple[_Jp2 | None, _Codestream]:
    """The JP2 boxes (or None) and the codestream with its main header
    read."""
    jp2 = None
    start = 0
    if data.startswith(JP2_SIGNATURE):
        jp2, start = read_jp2(data)
    elif not data.startswith(J2K_SIGNATURE):
        raise ValueError("not a JPEG 2000 file or codestream")
    cs = _Codestream(data, start, jp2.ihdr if jp2 else None)
    cs.read_header()
    return jp2, cs


def image_size(data: bytes) -> tuple[int, int]:
    """(height, width) of the image from the header alone."""
    img = _header(bytes(data))[1].image
    return img.y1 - img.y0, img.x1 - img.x0


def decode(data: bytes, plain: bool = False) -> np.ndarray:
    """JP2 or J2K bytes → uint8 RGB [H, W, 3] as cv2.imdecode reads them
    (reversed to RGB); a ValueError where cv2 returns no image or where
    the file needs what is not read here (named)."""
    jp2, cs = _header(bytes(data))
    img = cs.image
    prec = _opencv_header(img)
    for i, (_, _, dx, dy) in enumerate(img.comps):
        if dx != 1 or dy != 1:
            raise ValueError(f"JPEG 2000 component {i} sub-sampled {dx}x{dy}"
                             " (cv2 reads none)")
    if img.x0 or img.y0:
        raise ValueError("JPEG 2000 image offset "
                         f"({img.x0}, {img.y0}) (cv2 reads none)")
    planes = _decode_tiles(cs, plain)
    space = "unknown"
    if jp2 is not None:  # opj_jp2_decode's colour steps
        palette = jp2.pclr is not None and jp2.cmap is not None
        if jp2.cdef is not None:
            _check_cdef(jp2, len(jp2.cmap) if palette else len(planes))
        if palette:
            _check_palette(jp2, len(planes))
            planes = _apply_palette(jp2, planes)
        if jp2.cdef is not None:
            _apply_cdef(jp2, planes)
        space = _ENUMCS.get(jp2.enumcs, "unknown")
    return to_rgb(planes, space, prec)


def to_rgb(planes: list[np.ndarray], space: str, prec: int) -> np.ndarray:
    """OpenCV 5.0's conversion of the decoded components to 8-bit RGB:
    each sample shifted right by the largest precision less 8."""
    shift = prec - 8  # each sample then cast to uint8 (its low byte)
    if space in ("unknown", "sRGB"):
        if len(planes) not in (3, 4):
            raise ValueError(f"JPEG 2000 sRGB image of {len(planes)} "
                             "components (cv2 reads 3 or 4)")
        rgb = np.stack(planes[:3], -1)
    elif space == "gray":
        rgb = np.repeat(planes[0][:, :, None], 3, 2)
    elif space == "sYCC":
        if len(planes) < 3:
            raise ValueError(f"JPEG 2000 sYCC image of {len(planes)} "
                             "components (cv2 reads 3 or 4)")
        return yuv_to_rgb((np.stack(planes[:3], -1) >> shift)
                          .astype(np.uint8))
    else:
        raise ValueError(f"JPEG 2000 colour space {space} (cv2 reads sRGB, "
                         "sYCC and gray)")
    return np.ascontiguousarray((rgb >> shift).astype(np.uint8))


def yuv_to_rgb(yuv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(COLOR_YUV2BGR) on uint8 (YCrCb2RGB_i with the YUV
    coefficients of BT.601 in 14-bit fixed point), reversed to RGB."""
    y, u, v = (yuv[..., i].astype(np.int64) for i in range(3))

    def descale(x):
        return (x + (1 << 13)) >> 14

    r = y + descale((v - 128) * 18678)
    g = y + descale((u - 128) * -6472 + (v - 128) * -9519)
    b = y + descale((u - 128) * 33292)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# --- the host C library ------------------------------------------------------

_ERR_LEN = 256
_PLAN_HEAD, _PLAN_POC = 10, 6
_COMP_INTS = 9 + 2 * MAXRLVLS + 2 * MAXBANDS
_i32p = ctypes.POINTER(ctypes.c_int32)


@functools.cache
def library() -> ctypes.CDLL:
    """csrc/jpeg2000.c and the writer's csrc/jpeg2000_write.c, built on
    first use, with their argument types."""
    lib = kernels.load_host("jpeg2000")
    lib.j2k_decode_tile.argtypes = [_i32p, ctypes.c_char_p, ctypes.c_long,
                                    ctypes.c_char_p, ctypes.c_long,
                                    ctypes.POINTER(ctypes.c_long), _i32p,
                                    _i32p, ctypes.c_char_p, ctypes.c_int]
    lib.j2k_decode_tile.restype = ctypes.c_int
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.j2k_encode_tile.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_long, u8p, ctypes.c_long,
                                    ctypes.POINTER(ctypes.c_long)]
    lib.j2k_encode_tile.restype = ctypes.c_int
    return lib


def tile_plan(bounds, tcp: _Tcp, comps) -> np.ndarray:
    """The int32 plan csrc/jpeg2000.c reads: the tile's bounds, COD's
    progression, layers, transform and Scod, the POC entries, then per
    component its precision, sign and coding and quantisation
    parameters."""
    head = list(bounds) + [len(comps), tcp.prg, tcp.numlayers, tcp.mct,
                           tcp.csty, len(tcp.pocs) if tcp.poc else 0]
    pocs = [0] * (_PLAN_POC * MAX_POCS)
    for i, poc in enumerate(tcp.pocs if tcp.poc else ()):
        pocs[_PLAN_POC * i:_PLAN_POC * (i + 1)] = poc
    body = []
    for (prec, sgnd, _, _), t in zip(comps, tcp.tccps):
        body += [prec, sgnd, t.numres, t.cblkw, t.cblkh, t.cblksty, t.qmfbid,
                 t.numgbits, t.roishift] + t.prcw + t.prch + t.expn + t.mant
    return np.array(head + pocs + body, np.int32)


def decode_tile_c(bounds, tcp: _Tcp, comps, data: bytes,
                  resno_in: list[int], headers: list | None = None):
    """`decode_tile_plain` in C."""
    plan = tile_plan(bounds, tcp, comps)
    tx0, ty0, tx1, ty1 = bounds
    out = np.empty((len(comps), ty1 - ty0, tx1 - tx0), np.int32)
    resno = np.array(resno_in, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    hbuf, hpos = (b"", -1) if headers is None else headers
    hpos = ctypes.c_long(hpos)
    rc = library().j2k_decode_tile(plan.ctypes.data_as(_i32p), data,
                                   len(data), hbuf, len(hbuf),
                                   ctypes.byref(hpos),
                                   out.ctypes.data_as(_i32p),
                                   resno.ctypes.data_as(_i32p), err, _ERR_LEN)
    if headers is not None:
        headers[1] = hpos.value
    if rc == 1:
        raise ValueError(err.value.decode(errors="replace"))
    if rc:
        raise MemoryError("jpeg2000: out of memory")
    return list(out), resno.tolist()
