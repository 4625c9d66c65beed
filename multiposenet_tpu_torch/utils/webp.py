"""WebP as OpenCV 5.0 (`grfmt_webp.cpp` over libwebp 1.6) reads and
writes it.

cv2 takes a buffer for WebP when libwebp's `WebPGetFeatures` accepts its
first 32 bytes (a shorter file is no WebP to cv2): a RIFF/`WEBP`
container, or a bare VP8 or VP8L bitstream. Then:
- a still image is decoded as `WebPDecodeBGR(A)Into` decodes it
  (`ParseHeadersInternal`): an optional `VP8X` whose canvas must equal
  the bitstream's size, chunks skipped up to the first `VP8 `/`VP8L`
  (the last `ALPH` before it kept), and the bitstream read on to the end
  of the buffer, past its chunk. The alpha plane is dropped, but it is
  decoded, so a lossy image whose `ALPH` chunk is corrupt is refused as
  cv2 refuses it;
- an animation (`VP8X` with its animation flag) goes through libwebp's
  demuxer (`src/demux/demux.c`, which checks the chunk layout, frame
  bounds and flags strictly) and `WebPAnimDecoder`: its first frame is
  decoded onto a transparent black canvas, so what it leaves uncovered
  reads as black;
- the Exif orientation of the first `EXIF` chunk (raw TIFF bytes) is
  applied when the demuxer accepts the file and the `VP8X` flags say
  Exif, as cv2 applies it.
The bitstreams are decoded by the host C library `csrc/webp.c`
(`kernels.load_host("webp")`); `decode(..., plain=True)` runs the plain
versions `utils/vp8l.py` and `utils/vp8.py` instead. Nothing falls back
from one to the other.

`encode` writes uint8 RGB as `cv2.imwrite(path, bgr)` writes a `.webp`
at its defaults: a simple-format `RIFF…WEBPVP8L` lossless file (see
`utils/vp8l.py` for what is and is not libwebp's), refusing images
wider or taller than 16383 pixels, as cv2 does.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from multiposenet_tpu_torch import kernels
from multiposenet_tpu_torch.utils import vp8, vp8l

HEADER_SIZE = 32  # what cv2 hands WebPGetFeatures to pick its decoder
MAX_CHUNK_PAYLOAD = 0xFFFFFFF6
MAX_IMAGE_AREA = 1 << 32
MAX_SIDE = 16383
ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02
EXIF_FLAG, XMP_FLAG, ICCP_FLAG = 0x08, 0x04, 0x20
VALID_FLAGS = ALPHA_FLAG | ANIMATION_FLAG | EXIF_FLAG | XMP_FLAG | ICCP_FLAG


class _NotEnough(ValueError):
    """libwebp's VP8_STATUS_NOT_ENOUGH_DATA."""


def _le(data: bytes, at: int, n: int) -> int:
    return int.from_bytes(data[at:at + n], "little")


def _vp8_info(data: bytes, chunk_size: int) -> tuple[int, int]:
    """VP8GetInfo: (width, height) of a key frame, or ValueError."""
    if len(data) < vp8.FRAME_HEADER_SIZE or data[3:6] != vp8.SIGNATURE:
        raise ValueError("VP8 bitstream without its start code")
    bits = _le(data, 0, 3)
    if bits & 1:
        raise ValueError("VP8 frame is not a key frame")
    if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 \
            or bits >> 5 >= chunk_size:
        raise ValueError("VP8 frame header is inconsistent")
    w, h = vp8.frame_size(data)
    if w == 0 or h == 0:
        raise ValueError("VP8 frame of zero width or height")
    return w, h


def _vp8l_signature(data: bytes) -> bool:
    return len(data) >= 5 and data[0] == vp8l.MAGIC and not data[4] >> 5


class _Headers:
    """What ParseHeadersInternal finds: canvas and image sizes, flags,
    the ALPH payload and where the bitstream starts."""


def parse_headers(data: bytes, full: bool) -> _Headers:
    """libwebp's ParseHeadersInternal: `full` as WebPDecode calls it (all
    the data, headers wanted), else as WebPGetFeatures does. Raises a
    ValueError (`_NotEnough` for missing data) where it fails."""
    hd = _Headers()
    hd.width = hd.height = 0
    hd.alpha = None
    hd.animation = False
    size = len(data)
    if size < 12:
        raise _NotEnough("WebP data ends early")
    pos = riff_size = 0
    if size >= 12 and data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            raise ValueError("RIFF file that is not WebP")
        riff_size = _le(data, 4, 4)
        if riff_size < 12 or riff_size > MAX_CHUNK_PAYLOAD:
            raise ValueError(f"WebP RIFF size {riff_size}")
        if full and riff_size > size - 8:
            raise _NotEnough(f"WebP RIFF size {riff_size} past the data")
        pos = 12
    if size - pos < 8:
        raise _NotEnough("WebP data ends early")
    found_vp8x = data[pos:pos + 4] == b"VP8X"
    flags = 0
    if found_vp8x:
        if _le(data, pos + 4, 4) != 10:
            raise ValueError("WebP VP8X chunk of other than 10 bytes")
        if size - pos < 18:
            raise _NotEnough("WebP VP8X chunk ends early")
        flags = _le(data, pos + 8, 4)
        hd.width = 1 + _le(data, pos + 12, 3)
        hd.height = 1 + _le(data, pos + 15, 3)
        if hd.width * hd.height >= MAX_IMAGE_AREA:
            raise ValueError("WebP canvas too large")
        pos += 18
        if not riff_size:
            raise ValueError("WebP VP8X without RIFF")
    hd.animation = bool(flags & ANIMATION_FLAG)
    hd.flags = flags
    canvas = (hd.width, hd.height)
    try:
        if found_vp8x and hd.animation and not full:
            return hd
        if size - pos < 4:
            raise _NotEnough("WebP data ends early")
        if (riff_size and found_vp8x) or (
                not riff_size and not found_vp8x
                and data[pos:pos + 4] == b"ALPH"):
            total = 22
            while True:
                if size - pos < 8:
                    raise _NotEnough("WebP chunk header ends early")
                n = _le(data, pos + 4, 4)
                if n > MAX_CHUNK_PAYLOAD:
                    raise ValueError(f"WebP chunk size {n}")
                disk = (8 + n + 1) & ~1
                total += disk
                if riff_size and total > riff_size:
                    raise ValueError("WebP chunk past the RIFF size")
                if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                    break
                if size - pos < disk:
                    raise _NotEnough("WebP chunk ends early")
                if data[pos:pos + 4] == b"ALPH":
                    hd.alpha = (pos + 8, n)
                pos += disk
        if size - pos < 8:
            raise _NotEnough("WebP data ends early")
        tag = data[pos:pos + 4]
        if tag in (b"VP8 ", b"VP8L"):
            n = _le(data, pos + 4, 4)
            if riff_size >= 12 and n > riff_size - 12:
                raise ValueError(f"WebP {tag.decode()} chunk of {n} bytes "
                                 "past the RIFF size")
            if full and n > size - pos - 8:
                raise _NotEnough(f"WebP {tag.decode()} chunk of {n} bytes "
                                 "past the data")
            hd.chunk_size = n
            pos += 8
            hd.lossless = tag == b"VP8L"
        else:
            hd.lossless = _vp8l_signature(data[pos:])
            hd.chunk_size = size - pos
        if hd.chunk_size > MAX_CHUNK_PAYLOAD:
            raise ValueError("WebP bitstream too large")
        bitstream = data[pos:]
        if not hd.lossless:
            if len(bitstream) < vp8.FRAME_HEADER_SIZE:
                raise _NotEnough("VP8 frame header ends early")
            hd.width, hd.height = _vp8_info(bitstream, hd.chunk_size)
        else:
            if len(bitstream) < 5:
                raise _NotEnough("VP8L header ends early")
            if not _vp8l_signature(bitstream):
                raise ValueError("VP8L bitstream with a wrong signature "
                                 "or version")
            hd.width, hd.height, _ = vp8l.decode_header(bitstream)
        if found_vp8x and canvas != (hd.width, hd.height):
            raise ValueError(f"WebP canvas {canvas[0]}x{canvas[1]} is not "
                             f"its image's {hd.width}x{hd.height}")
        hd.offset = pos
    except _NotEnough:
        if found_vp8x and not full:
            return hd
        raise
    return hd


def is_webp(data: bytes) -> bool:
    """Whether cv2 picks its WebP decoder for these bytes."""
    if len(data) < HEADER_SIZE:
        return False
    try:
        parse_headers(bytes(data[:HEADER_SIZE]), full=False)
    except ValueError:
        return False
    return True


# --- the demuxer (animations, and the Exif of stills) ------------------------


class _Frame:
    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.num = 0
        self.complete = False
        self.image = (0, 0)  # (offset, size) of its chunk, header included
        self.alpha = (0, 0)


class _Invalid(Exception):
    pass


class _Demux:
    """libwebp's WebPDemux (no partial data) of a RIFF/WEBP file with a
    VP8X chunk: raises _Invalid where it returns NULL."""

    def __init__(self, data: bytes):
        self.data = data
        if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
            raise _Invalid
        riff_size = _le(data, 4, 4)
        if riff_size < 8 or riff_size > MAX_CHUNK_PAYLOAD:
            raise _Invalid
        self.riff_end = riff_size + 8
        if len(data) < self.riff_end:
            raise _Invalid  # partial
        self.end = self.riff_end
        self.start = 12
        self.frames: list[_Frame] = []
        self.chunks: list[tuple[bytes, int, int]] = []
        if data[12:16] != b"VP8X":
            raise _Invalid  # not an extended file: nothing to find here
        self._parse_vp8x()
        self._validate()

    def left(self) -> int:
        return self.end - self.start

    def size_invalid(self, n: int) -> bool:
        return n > self.riff_end - self.start

    def _parse_vp8x(self) -> None:
        d = self.data
        if self.left() < 8:
            raise _Invalid
        size = _le(d, self.start + 4, 4)
        self.start += 8
        if size > MAX_CHUNK_PAYLOAD or size < 10:
            raise _Invalid
        size += size & 1
        if self.size_invalid(size) or self.left() < size:
            raise _Invalid
        self.flags = d[self.start]
        self.canvas_width = 1 + _le(d, self.start + 4, 3)
        self.canvas_height = 1 + _le(d, self.start + 7, 3)
        if self.canvas_width * self.canvas_height >= MAX_IMAGE_AREA:
            raise _Invalid
        self.start += size
        if self.size_invalid(8) or self.left() < 8:
            raise _Invalid
        self._parse_chunks()

    def _parse_chunks(self) -> None:
        d = self.data
        animation = bool(self.flags & ANIMATION_FLAG)
        anim_chunks = 0
        while True:
            at = self.start
            tag = d[at:at + 4]
            size = _le(d, at + 4, 4)
            self.start += 8
            if size > MAX_CHUNK_PAYLOAD:
                raise _Invalid
            padded = size + (size & 1)
            if self.size_invalid(padded):
                raise _Invalid
            if tag == b"VP8X":
                raise _Invalid
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or animation:
                    raise _Invalid
                self.start = at
                self._single_image()
            elif tag == b"ANIM":
                if padded < 6 or self.left() < padded:
                    raise _Invalid
                if anim_chunks == 0:
                    anim_chunks = 1
                self.start += padded
            elif tag == b"ANMF":
                if anim_chunks == 0:
                    raise _Invalid
                self._animation_frame(padded)
            else:
                store = {b"ICCP": ICCP_FLAG, b"EXIF": EXIF_FLAG,
                         b"XMP ": XMP_FLAG}.get(tag)
                if padded > self.left():
                    raise _Invalid
                if store is None or self.flags & store:
                    self.chunks.append((tag, at + 8, size))
                self.start += padded
            if self.start == self.riff_end:
                return
            if self.left() < 8:
                raise _Invalid

    def _single_image(self) -> None:
        if self.frames or self.size_invalid(8) or self.left() < 8:
            raise _Invalid
        frame = _Frame()
        self._store_frame(frame, 1, 0)
        if not self.flags & ALPHA_FLAG:
            frame.alpha = (0, 0)
        self._add(frame)

    def _animation_frame(self, chunk_size: int) -> None:
        d = self.data
        if self.size_invalid(16) or chunk_size < 16 or self.left() < 16:
            raise _Invalid
        frame = _Frame()
        at = self.start
        frame.x = 2 * _le(d, at, 3)
        frame.y = 2 * _le(d, at + 3, 3)
        width, height = 1 + _le(d, at + 6, 3), 1 + _le(d, at + 9, 3)
        if width * height >= MAX_IMAGE_AREA:
            raise _Invalid
        self.start += 16
        payload = chunk_size - 16
        self._store_frame(frame, len(self.frames) + 1, payload)
        if self.start - (at + 16) > payload:
            raise _Invalid
        if self.flags & ANIMATION_FLAG and frame.num > 0:
            self._add(frame)

    def _add(self, frame: _Frame) -> None:
        if self.frames and not self.frames[-1].complete:
            raise _Invalid
        self.frames.append(frame)

    def _store_frame(self, frame: _Frame, num: int, min_size: int) -> None:
        """StoreFrame: the frame's ALPH and VP8/VP8L chunks."""
        d = self.data
        if self.left() < 8 or self.left() < min_size:
            raise _Invalid
        alpha_chunks = image_chunks = 0
        while True:
            at = self.start
            tag = d[at:at + 4]
            size = _le(d, at + 4, 4)
            self.start += 8
            if size > MAX_CHUNK_PAYLOAD:
                raise _Invalid
            padded = size + (size & 1)
            available = min(padded, self.left())
            if self.size_invalid(padded):
                raise _Invalid
            complete = padded <= self.left()
            if tag == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha = (at, 8 + available)
                frame.num = num
                self.start += available
            elif tag in (b"VP8 ", b"VP8L") and image_chunks == 0 and not (
                    tag == b"VP8L" and alpha_chunks):
                try:
                    hd = parse_headers(d[at:at + 8 + available], full=False)
                except ValueError:
                    raise _Invalid from None
                image_chunks = 1
                frame.image = (at, 8 + available)
                frame.width, frame.height = hd.width, hd.height
                frame.num = num
                frame.complete = complete
                self.start += available
            elif tag == b"VP8L" and alpha_chunks:
                raise _Invalid  # VP8L has its own alpha
            else:
                self.start = at
                return
            if not complete:
                raise _Invalid  # data ends inside the frame
            if self.start == self.riff_end:
                return
            if self.left() < 8:
                raise _Invalid

    def _validate(self) -> None:
        animation = bool(self.flags & ANIMATION_FLAG)
        if self.flags & ~VALID_FLAGS or not self.frames:
            raise _Invalid
        for f in self.frames:
            if not animation and f.num > 1:
                raise _Invalid
            if not f.complete:
                raise _Invalid
            if f.alpha[1] == 0 and f.image[1] == 0:
                raise _Invalid
            if f.alpha[1] and f.alpha[0] > f.image[0]:
                raise _Invalid
            if f.width <= 0 or f.height <= 0:
                raise _Invalid
            if not animation:
                ok = (f.x, f.y, f.width, f.height) == (
                    0, 0, self.canvas_width, self.canvas_height)
            else:
                ok = (f.x + f.width <= self.canvas_width
                      and f.y + f.height <= self.canvas_height)
            if not ok:
                raise _Invalid

    def fragment(self, frame: _Frame) -> bytes:
        """GetFramePayload: from the ALPH chunk (if any) to the end of the
        image chunk."""
        start, size = frame.image
        if frame.alpha[1]:
            size += frame.alpha[1] + start - (frame.alpha[0] + frame.alpha[1])
            start = frame.alpha[0]
        return self.data[start:start + size]

    def chunk(self, tag: bytes) -> bytes | None:
        for t, at, size in self.chunks:
            if t == tag:
                return self.data[at:at + size]
        return None


def _exif(data: bytes) -> bytes | None:
    """The first EXIF chunk, as cv2 gets it through the demuxer."""
    try:
        return _Demux(data).chunk(b"EXIF")
    except _Invalid:
        return None


# --- decoding ----------------------------------------------------------------


def _check_alpha(alpha: bytes, width: int, height: int, plain: bool) -> None:
    """ALPHInit and the decode of the plane, for their failures only
    (cv2 decodes the plane and drops it)."""
    if len(alpha) <= 1:
        raise ValueError("WebP ALPH chunk of one byte or none")
    method, pre, reserved = alpha[0] & 3, (alpha[0] >> 4) & 3, alpha[0] >> 6
    if method > 1 or pre > 1 or reserved:
        raise ValueError(f"WebP ALPH header byte 0x{alpha[0]:02x}")
    if method == 0:
        if len(alpha) - 1 < width * height:
            raise ValueError("WebP ALPH plane ends early")
    elif plain:
        vp8l.decode(alpha[1:], width, height)
    else:
        vp8l_decode_c(alpha[1:], width, height)


def _argb_to_rgb(argb: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(
        argb.view(np.uint8).reshape(argb.shape + (4,))[..., 2::-1])


def _decode_bitstream(data: bytes, plain: bool) -> np.ndarray:
    """WebPDecode of a whole buffer (a file, or an animation frame's
    fragment) → uint8 RGB [H, W, 3]."""
    hd = parse_headers(data, full=True)
    if hd.animation:
        raise ValueError("WebP animation where a still image was expected")
    body = data[hd.offset:]
    if hd.lossless:
        argb = vp8l.decode(body) if plain else vp8l_decode_c(body)
        return _argb_to_rgb(argb)
    rgb = vp8.decode(body) if plain else vp8_decode_c(body)
    if hd.alpha is not None:
        at, n = hd.alpha
        _check_alpha(data[at:at + n], rgb.shape[1], rgb.shape[0], plain)
    return rgb


def decode(data: bytes, plain: bool = False) -> tuple[np.ndarray,
                                                      bytes | None]:
    """WebP bytes → (uint8 RGB [H, W, 3] before any Exif orientation, the
    Exif TIFF bytes cv2 reads or None); raises a ValueError where cv2
    returns no image. `plain` runs the bitstream decoders in Python."""
    data = bytes(data)
    if len(data) < HEADER_SIZE:
        raise ValueError(f"WebP of {len(data)} bytes: cv2 reads none under "
                         f"{HEADER_SIZE}")
    features = parse_headers(data[:HEADER_SIZE], full=False)
    if not features.animation:
        return _decode_bitstream(data, plain), _exif(data)
    try:
        demux = _Demux(data)
    except _Invalid:
        raise ValueError("animated WebP that libwebp's demuxer refuses") \
            from None
    frame = demux.frames[0]
    canvas = np.zeros((demux.canvas_height, demux.canvas_width, 3),
                      np.uint8)
    rgb = _decode_bitstream(demux.fragment(frame), plain)
    if rgb.shape[:2] != (frame.height, frame.width):
        raise ValueError("WebP frame size differs from its bitstream's")
    canvas[frame.y:frame.y + frame.height,
           frame.x:frame.x + frame.width] = rgb
    return canvas, demux.chunk(b"EXIF")


# --- encoding ----------------------------------------------------------------


def _riff(chunk_tag: bytes, payload: bytes) -> bytes:
    pad = b"\0" if len(payload) & 1 else b""
    body = b"WEBP" + chunk_tag + struct.pack("<I", len(payload)) + payload \
        + pad
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _check_encodable(rgb: np.ndarray) -> np.ndarray:
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError("WebP encoding takes uint8 RGB [H, W, 3]; got "
                         f"{rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    if not (1 <= h <= MAX_SIDE and 1 <= w <= MAX_SIDE):
        raise ValueError(f"WebP holds at most {MAX_SIDE} pixels a side; got "
                         f"{h}x{w}")
    return np.ascontiguousarray(rgb)


def encode(rgb: np.ndarray, plain: bool = False) -> bytes:
    """uint8 RGB [H, W, 3] → a lossless WebP file (`RIFF…WEBPVP8L`), as
    `cv2.imwrite(".webp")` writes one at its defaults; the pixels are
    cv2's, the bytes are not (see `utils/vp8l.py`)."""
    rgb = _check_encodable(rgb)
    stream = vp8l.encode(rgb) if plain else vp8l_encode_c(rgb)
    return _riff(b"VP8L", stream)


# --- the host C library ------------------------------------------------------

_ERR_LEN = 256
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)


@functools.cache
def library() -> ctypes.CDLL:
    """csrc/webp.c, built on first use, with its argument types."""
    lib = kernels.load_host("webp")
    lib.vp8l_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, _u32p,
                                ctypes.c_char_p, ctypes.c_int]
    lib.vp8l_decode.restype = ctypes.c_int
    lib.vp8_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                               ctypes.c_int, _u8p, ctypes.c_char_p,
                               ctypes.c_int]
    lib.vp8_decode.restype = ctypes.c_int
    lib.vp8l_encode.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, _u8p,
                                ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    lib.vp8l_encode.restype = ctypes.c_int
    return lib


def _check(rc: int, err: ctypes.Array) -> None:
    if rc == 1:
        raise ValueError(err.value.decode(errors="replace"))
    if rc:
        raise MemoryError("webp: out of memory")


def vp8l_decode_c(data: bytes, width: int | None = None,
                  height: int | None = None) -> np.ndarray:
    """`vp8l.decode` in C."""
    data = bytes(data)
    headerless = width is not None
    if not headerless:
        width, height, _ = vp8l.decode_header(data)
    out = np.empty((height, width), np.uint32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(library().vp8l_decode(data, len(data), width, height,
                                 int(headerless), out.ctypes.data_as(_u32p),
                                 err, _ERR_LEN), err)
    return out


def vp8_decode_c(data: bytes) -> np.ndarray:
    """`vp8.decode` in C."""
    data = bytes(data)
    if len(data) < vp8.FRAME_HEADER_SIZE:
        raise ValueError("VP8 frame header ends early")
    width, height = vp8.frame_size(data)
    out = np.empty((height, width, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(library().vp8_decode(data, len(data), width, height,
                                out.ctypes.data_as(_u8p), err, _ERR_LEN),
           err)
    return out


def vp8l_encode_c(rgb: np.ndarray) -> bytes:
    """`vp8l.encode` in C."""
    rgb = _check_encodable(rgb)
    h, w = rgb.shape[:2]
    cap = 1024 + h * w * 4
    size = ctypes.c_long()
    while True:
        out = np.empty(cap, np.uint8)
        rc = library().vp8l_encode(rgb.ctypes.data_as(_u8p), h, w,
                                   out.ctypes.data_as(_u8p), cap,
                                   ctypes.byref(size))
        if rc != 1:
            break
        cap = size.value
    if rc:
        raise MemoryError("webp: out of memory")
    return out[:size.value].tobytes()
