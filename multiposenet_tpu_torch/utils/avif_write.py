"""AVIF writing as cv2.imwrite writes it at its defaults.

The contract: for every uint8 RGB image of H x W x 3 with sides from 1 up
(odd sides, and wide enough for two or four tile columns included),
`encode(rgb)` (the encoder in the host C library `csrc/av1_encode.c`)
and `encode_plain(rgb)` (in Python, `utils/av1_encode.py`) return the
bytes that `cv2.imencode(".avif", bgr)` returns with no parameters
(opencv-python 5.0's libavif 1.4.2 over libaom 3.14.1): quality 50,
speed 9, 8-bit 4:2:0, BT.601 full range. Outside the contract, and not
reachable from the CLI: gray, BGRA, 16-bit input and any
`IMWRITE_AVIF_*` parameter (a ValueError names what is not uint8 RGB).

cv2's default file is one still item. Every frame-level field but two
flags is the same for every image:

- the reduced still-picture sequence header: 64x64 superblocks, filter
  intra and the intra edge filter on, CDEF on, no loop restoration,
  8-bit 4:2:0, colour primaries 1, transfer 13, matrix 6 (BT.601), full
  range; its level is the least whose picture size, width and height
  hold the image (`level_index`);
- a key frame at base_q_idx 148, the U and V DC and AC delta q at -16,
  quantizer matrices at level 8, loop filter 15/15/15/15 with sharpness
  1 and the default reference deltas, one CDEF strength (damping 5, luma
  (2, 1), chroma (0, 0)), the full transform set, screen content tools
  off;
- one tile column, or more where the superblock columns reach 64
  (`av1_encode.tile_cols_log2`);
- delta q present (delta_q_res 2: a qindex per superblock) where a
  superblock's qindex differs from 148, and TX_MODE_SELECT where a block
  is rectangular (else TX_MODE_LARGEST).

Only the tiles and those flags depend on the pixels: `av1_encode`
makes and codes the encoder's decisions. This module writes the rest:
libyuv's RGB24ToJ420 conversion (the route libavif takes for cv2's BGR
pixels), the OBUs with the sequence and frame headers, and the ISOBMFF
container as libavif writes it (`ftyp`, `meta` with `hdlr`, `pitm`,
`iloc`, `iinf`, `iprp` holding `ispe`, `pixi`, `av1C` and `colr`, then
`mdat`). `tools/avif_write_search.py` holds both writers to cv2 on
seeded images; `tests/test_torch_avif_write.py` holds each stage to
libaom's or libyuv's own function.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.utils import av1_encode
from multiposenet_tpu_torch.utils.av1_encode import (
    BASE_Q, CHROMA_DELTA_Q, DELTA_Q_RES, QM_LEVEL, _tile_log2, superblocks,
    tile_cols_log2, tile_rows_log2)

LF_LEVELS = (15, 15, 15, 15)
LF_SHARPNESS = 1
CDEF_DAMPING = 5
CDEF_Y = (2, 1)
CDEF_UV = (0, 0)
PRIMARIES, TRANSFER, MATRIX = 1, 13, 6

OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER, OBU_FRAME = 1, 2, 6

# AV1's levels (seq_level_idx): the largest picture (luma samples),
# width and height each allows.
_LEVELS = ((0, 147456, 2048, 1152), (1, 278784, 2816, 1584),
           (4, 665856, 4352, 2448), (5, 1065024, 5504, 3096),
           (8, 2359296, 6144, 3456), (12, 8912896, 8192, 4352),
           (16, 35651584, 16384, 8704))


def rgb_to_yuv420(rgb: np.ndarray) -> tuple:
    """uint8 RGB [H, W, 3] → (Y [H, W], U, V [(H+1)//2, (W+1)//2]), as
    libavif 1.4.2 converts cv2's BGR pixels: libyuv's RGB24ToJ420 (BT.601
    full range; Y of each pixel, U and V of each 2x2 block's rounded
    mean, a last odd row or column paired with itself)."""
    rgb = np.asarray(rgb)
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    h, w = y.shape

    def mean(c):
        c = np.pad(c, ((0, h & 1), (0, w & 1)), mode="edge")
        return (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2]
                + c[1::2, 1::2] + 2) >> 2

    rm, gm, bm = mean(r), mean(g), mean(b)
    u = (128 * bm - 85 * gm - 43 * rm + 0x8000) >> 8
    v = (128 * rm - 107 * gm - 21 * bm + 0x8000) >> 8
    return y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8)


def level_index(width: int, height: int) -> int:
    """libaom's seq_level_idx for a still of this size: the first level
    whose picture size, width and height hold it (31 past them all)."""
    for idx, area, max_w, max_h in _LEVELS:
        if width * height <= area and width <= max_w and height <= max_h:
            return idx
    return 31


class BitWriter:
    """MSB-first bits, as the OBU headers are written."""

    def __init__(self):
        self.bits: list[int] = []

    def f(self, n: int, v: int) -> None:
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def su(self, n: int, v: int) -> None:
        self.f(n, v & ((1 << n) - 1))

    def aligned(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                     for i in range(0, len(bits), 8))

    def trailing(self) -> bytes:
        self.bits.append(1)
        return self.aligned()


def _leb128(n: int) -> bytes:
    out = b""
    while True:
        byte = n & 0x7F
        n >>= 7
        out += bytes([byte | (0x80 if n else 0)])
        if not n:
            return out


def obu(kind: int, payload: bytes) -> bytes:
    """An OBU with its size field."""
    return bytes([(kind << 3) | 2]) + _leb128(len(payload)) + payload


def sequence_header(width: int, height: int) -> bytes:
    """The payload of cv2's reduced still-picture sequence header."""
    w = BitWriter()
    wb = max((width - 1).bit_length(), 1)
    hb = max((height - 1).bit_length(), 1)
    w.f(3, 0)  # seq_profile
    w.f(1, 1)  # still_picture
    w.f(1, 1)  # reduced_still_picture_header
    w.f(5, level_index(width, height))
    w.f(4, wb - 1)
    w.f(4, hb - 1)
    w.f(wb, width - 1)
    w.f(hb, height - 1)
    w.f(1, 0)  # use_128x128_superblock
    w.f(1, 1)  # enable_filter_intra
    w.f(1, 1)  # enable_intra_edge_filter
    w.f(1, 0)  # enable_superres
    w.f(1, 1)  # enable_cdef
    w.f(1, 0)  # enable_restoration
    w.f(1, 0)  # high_bitdepth
    w.f(1, 0)  # mono_chrome
    w.f(1, 1)  # color_description_present_flag
    w.f(8, PRIMARIES)
    w.f(8, TRANSFER)
    w.f(8, MATRIX)
    w.f(1, 1)  # color_range: full
    w.f(2, 0)  # chroma_sample_position
    w.f(1, 0)  # separate_uv_delta_q
    w.f(1, 0)  # film_grain_params_present
    return w.trailing()


def frame_header(width: int, height: int, delta_q: bool = True,
                 tx_select: bool = False, tile_size_bytes: int = 4,
                 largest_tile: int = 0) -> bytes:
    """cv2's uncompressed header of the key frame (byte-aligned): delta q
    present where a superblock's qindex differs from BASE_Q, the
    transform size coded (TX_MODE_SELECT) where a block's transform is
    smaller than the block (a rectangular block takes its square
    transform), and the largest tile named for the CDF update."""
    w = BitWriter()
    w.f(1, 0)  # disable_cdf_update
    w.f(1, 0)  # allow_screen_content_tools
    w.f(1, 0)  # render_and_frame_size_different
    sb_cols, sb_rows = superblocks(width, height)
    min_cols = _tile_log2(64, sb_cols)
    max_cols = _tile_log2(1, min(sb_cols, 64))
    max_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2 = max(min_cols, _tile_log2((4096 * 2304) >> 12,
                                        sb_rows * sb_cols))
    cols, rows = tile_cols_log2(width), tile_rows_log2(width, height)
    w.f(1, 1)  # uniform_tile_spacing_flag
    k = min_cols
    while k < max_cols:
        w.f(1, int(k < cols))
        if k >= cols:
            break
        k += 1
    k = max(min_log2 - cols, 0)
    while k < max_rows:
        w.f(1, int(k < rows))
        if k >= rows:
            break
        k += 1
    if cols or rows:
        w.f(cols + rows, largest_tile)  # context_update_tile_id
        w.f(2, tile_size_bytes - 1)
    w.f(8, BASE_Q)
    w.f(1, 0)  # DeltaQYDc
    for _ in range(2):  # DeltaQUDc, DeltaQUAc (V takes U's)
        w.f(1, 1)
        w.su(7, CHROMA_DELTA_Q)
    w.f(1, 1)  # using_qmatrix
    w.f(4, QM_LEVEL)
    w.f(4, QM_LEVEL)
    w.f(1, 0)  # segmentation_enabled
    w.f(1, int(delta_q))  # delta_q_present
    if delta_q:
        w.f(2, DELTA_Q_RES)
        w.f(1, 0)  # delta_lf_present
    for level in LF_LEVELS:
        w.f(6, level)
    w.f(3, LF_SHARPNESS)
    w.f(1, 1)  # loop_filter_delta_enabled
    w.f(1, 0)  # loop_filter_delta_update
    w.f(2, CDEF_DAMPING - 3)
    w.f(2, 0)  # cdef_bits
    w.f(4, CDEF_Y[0])
    w.f(2, CDEF_Y[1])
    w.f(4, CDEF_UV[0])
    w.f(2, CDEF_UV[1])
    w.f(1, int(tx_select))  # else TX_MODE_LARGEST
    w.f(1, 0)  # reduced_tx_set
    return w.aligned()


def _size_bytes(size: int) -> int:
    """libaom's choose_size_bytes: the bytes that hold `size`."""
    return 4 if size >> 24 else 3 if size >> 16 else 2 if size >> 8 else 1


def frame_obu(width: int, height: int, tiles: list[bytes],
              delta_q: bool = True, tx_select: bool = False) -> bytes:
    """The frame OBU: its header, then the tile group (each tile's size,
    less one, before every tile but the last, in the fewest bytes that
    hold the largest tile's size)."""
    if len(tiles) == 1:
        return obu(OBU_FRAME, frame_header(width, height, delta_q, tx_select)
                   + tiles[0])
    sizes = [len(t) for t in tiles]
    largest = sizes.index(max(sizes))
    n = _size_bytes(max(sizes))
    body = b"".join((len(t) - 1).to_bytes(n, "little") + t
                    for t in tiles[:-1]) + tiles[-1]
    # tile_start_and_end_present_flag 0, then byte alignment
    return obu(OBU_FRAME, frame_header(width, height, delta_q, tx_select, n,
                                       largest) + b"\0" + body)


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _full(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(kind, bytes([version]) + flags.to_bytes(3, "big") + payload)


def container(width: int, height: int, stream: bytes) -> bytes:
    """The AVIF file libavif 1.4.2 writes around one still item's AV1
    stream (temporal delimiter, sequence header, frame)."""
    level = level_index(width, height)
    ftyp = _box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miafMA1B")
    hdlr = _full(b"hdlr", 0, 0, bytes(4) + b"pict" + bytes(12) + b"\0")
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", 1))
    infe = _full(b"infe", 2, 0, struct.pack(">HH", 1, 0) + b"av01Color\0")
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", 1) + infe)
    ispe = _full(b"ispe", 0, 0, struct.pack(">II", width, height))
    pixi = _full(b"pixi", 0, 0, bytes([3, 8, 8, 8]))
    av1c = _box(b"av1C", bytes([0x81, level, 0x0C, 0x00]))
    colr = _box(b"colr", b"nclx" + struct.pack(">HHHB", PRIMARIES, TRANSFER,
                                               MATRIX, 0x80))
    ipco = _box(b"ipco", ispe + pixi + av1c + colr)
    ipma = _full(b"ipma", 0, 0, struct.pack(">IHB", 1, 1, 4)
                 + bytes([0x01, 0x02, 0x83, 0x04]))
    iprp = _box(b"iprp", ipco + ipma)

    def meta(offset):
        iloc = _full(b"iloc", 0, 0, bytes([0x44, 0x00])
                     + struct.pack(">HHHHII", 1, 1, 0, 1, offset,
                                   len(stream)))
        return _full(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iprp)

    offset = len(ftyp) + len(meta(0)) + 8
    return ftyp + meta(offset) + _box(b"mdat", stream)


def wrap(width: int, height: int, tiles: list[bytes],
         delta_q: bool = True, tx_select: bool = False) -> bytes:
    """The file of a frame whose tiles (in order, columns within rows)
    the encoder wrote, with the header's two flags (`frame_header`)."""
    stream = (obu(OBU_TEMPORAL_DELIMITER, b"")
              + obu(OBU_SEQUENCE_HEADER, sequence_header(width, height))
              + frame_obu(width, height, tiles, delta_q, tx_select))
    return container(width, height, stream)


def _check(rgb: np.ndarray) -> np.ndarray:
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or \
            0 in rgb.shape:
        raise ValueError(f"AVIF: uint8 RGB [H, W, 3] pixels are written, "
                         f"not {rgb.dtype} {rgb.shape}")
    return np.ascontiguousarray(rgb)


def encode_plain(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] → cv2.imencode(".avif")'s bytes at its
    defaults, the tiles in Python (`av1_encode.encode_tiles`)."""
    rgb = _check(rgb)
    h, w = rgb.shape[:2]
    tiles, delta_q, tx_select = av1_encode.encode_tiles(*rgb_to_yuv420(rgb))
    return wrap(w, h, tiles, delta_q, tx_select)


@functools.cache
def library() -> ctypes.CDLL:
    """The host C encoder csrc/av1_encode.c, built on first use."""
    lib = kernels.load_host("av1_encode")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.av1_encode_tiles.argtypes = [u8p, u8p, u8p, ctypes.c_int,
                                     ctypes.c_int, u8p, ctypes.c_long,
                                     ctypes.POINTER(ctypes.c_long),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.av1_encode_tiles.restype = ctypes.c_int
    return lib


def encode_tiles(y: np.ndarray, u: np.ndarray,
                 v: np.ndarray) -> tuple[list[bytes], bool, bool]:
    """`av1_encode.encode_tiles` in the host C library."""
    h, w = y.shape
    lib = library()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    planes = [np.ascontiguousarray(p, np.uint8) for p in (y, u, v)]
    cols, rows = av1_encode.tile_ranges(w, h)
    sizes = (ctypes.c_long * (len(cols) * len(rows)))()
    flags = (ctypes.c_int * 2)()
    cap = 2 * w * h + 65536
    while True:
        out = np.empty(cap, np.uint8)
        rc = lib.av1_encode_tiles(*(p.ctypes.data_as(u8p) for p in planes),
                                  w, h, out.ctypes.data_as(u8p), cap, sizes,
                                  flags)
        if rc == 3:
            cap = sizes[0]
            continue
        if rc:
            raise MemoryError("AVIF: out of memory")
        break
    tiles, at = [], 0
    for n in sizes:
        tiles.append(out[at:at + n].tobytes())
        at += n
    return tiles, bool(flags[0]), bool(flags[1])


def encode(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] → cv2.imencode(".avif")'s bytes at its
    defaults, the tiles in the host C library."""
    rgb = _check(rgb)
    h, w = rgb.shape[:2]
    tiles, delta_q, tx_select = encode_tiles(*rgb_to_yuv420(rgb))
    return wrap(w, h, tiles, delta_q, tx_select)
