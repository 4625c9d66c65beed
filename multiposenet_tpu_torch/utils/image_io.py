"""Image files and resizing without cv2, for the port's eval and command
line (the JAX package reads and writes images through cv2, which the
card's machine does not have).

`read_image` (a file) and `decode_image` (its bytes) return uint8 RGB
[H, W, 3] pixel for pixel as `cv2.imread(path, cv2.IMREAD_COLOR)` and
`cv2.imdecode` reversed to RGB do on OpenCV 5.0 (libjpeg-turbo 3.1,
libpng 1.6):
- JPEG through the host C library `csrc/image_codec.c`: sequential and
  progressive, Huffman- or arithmetic-coded, gray, YCbCr, RGB (Adobe
  transform 0 or component ids R, G, B), CMYK and YCCK (through OpenCV's
  CMYK -> BGR); lossless RGB and CMYK; progressive files whose scans stop
  early through libjpeg's inter-block smoothing. A file whose data ends
  early is filled as `cv2.imread` fills it; bytes that end early are
  refused where `cv2.imdecode` refuses them, which is where libjpeg-turbo
  asks for a byte past their end (a stream without its EOI may read). The
  Exif block is found as libjpeg walks the header. What cv2 returns no
  image for (12- and 16-bit samples, gray, YCbCr and YCCK lossless,
  arithmetic lossless, hierarchical) is refused by name. Its plain
  version for baseline streams is `utils/jpeg.py`;
- PNG with zlib and NumPy: every colour type and bit depth, Adam7
  interlace, palette (tRNS dropped; an index past the palette is black),
  gray at 1, 2 and 4 bits expanded to 8 as libpng does, 16-bit samples
  cut to their high byte (libpng's png_set_strip_16), alpha dropped;
- `.npy` arrays, uint8 [H, W, 3] or gray [H, W];
- by signature, as cv2 picks its decoder: BMP/DIB (`utils/bmp.py`),
  Radiance HDR (`utils/hdr.py`), PBM/PGM/PPM/PAM/PFM (`utils/pxm.py`),
  Sun raster (`utils/sunras.py`), TIFF (`utils/tiff.py`: LZW, PackBits,
  deflate, JPEG and CCITT compression; gray, RGB, palette, CMYK, YCbCr and
  CIELab) and GIF's first frame (`utils/gif.py`), their coders (BMP RLE,
  TIFF LZW, PackBits, JPEG and CCITT, GIF LZW, HDR run-length pixels) in
  the host C library; `decode_image_plain` runs the same readers on the
  coders' plain versions (`utils/ccitt.py`, `jpeg.decode_planes` for
  baseline streams, `hdr.decode_pixels_plain`, ...). Each module names the
  variants it reads and what cv2 5.0 returns no image for;
- WebP (`utils/webp.py`): lossless VP8L, lossy VP8 (with or without an
  `ALPH` plane, which is decoded and dropped), the `VP8X` extended form
  and an animation's first frame on its canvas, as libwebp 1.6 decodes
  them for cv2, through the host C library `csrc/webp.c`;
  `decode_image_plain` runs the plain decoders `utils/vp8l.py` and
  `utils/vp8.py`. A RIFF file of another form is refused by name;
- JPEG 2000 (`utils/jpeg2000.py`): JP2 files and bare J2K codestreams,
  5/3 and 9/7, RCT and ICT, tiles, quality layers, precincts, every
  progression order and POC, SOP/EPH, ROI shifts, 8 to 16 bits and more
  (shifted to 8 as cv2 shifts them), gray, RGB and RGBA (alpha dropped),
  as OpenJPEG 2.5.3 decodes them for cv2, tiers 1 and 2 and the
  transforms in the host C library `csrc/jpeg2000.c` (plain versions in
  the module); what cv2 returns no image for (signed samples, an image
  offset, sub-sampled components, precinct sizes OpenJPEG rejects, cut or
  damaged codestreams where OpenJPEG fails) is refused, and what no
  encoder here can make (code-block styles other than 0, PPM/PPT packet
  headers, palettes, Part 2 multi-component markers) is refused by name;
- AVIF (`utils/avif.py`): every file `cv2.imencode(".avif")` writes
  from uint8 pixels or, at IMWRITE_AVIF_DEPTH 10 or 12, uint16 (gray,
  colour or with an alpha item, any size, quality 0 to 100, speed 0 to
  10), and other encoders' files in 4:4:4 lossy and 4:2:2 frames and in
  every colour description libavif converts (limited and full range,
  BT.601, BT.709, BT.2020, FCC, SMPTE 240M, YCgCo, chroma-derived), as
  libavif 1.4.2 over libaom 3.14.1 decodes it for cv2, the AV1 tiles
  (palette, intra block copy, lossless 4:4:4, segmentation),
  deblocking, CDEF, loop restoration and libaom's film grain in the
  host C library `csrc/av1.c`; `decode_image_plain` runs the plain
  decoder `utils/av1.py`; grid images (the cells stitched), Exif items
  (their orientation applied) and image sequences (the first frame) are
  read as cv2 reads them. What cv2 returns no image for (colour
  descriptions libavif does not convert, a monochrome image with an
  alpha item, the container forms libavif refuses or cv2's 500-byte
  signature parse cannot reach, grain parameters or segment ids libaom
  refuses) and what lies past that contract (superres) is refused by
  name.
Gray is repeated into three channels. The Exif orientation (tag 0x0112
of IFD0, in a JPEG APP1 `Exif` block, a PNG `eXIf` chunk, a TIFF's own
IFD0, a WebP `EXIF` chunk or an AVIF Exif item) is applied as cv2
applies it. OpenEXR files
(cv2 is built without it) are refused by a ValueError that names the
format; any other bytes by one that names the suffix.

`encode_jpeg` and `write_jpeg` write uint8 RGB as the JPEG bytes
`cv2.imencode(".jpg")` writes at its defaults (host C; plain version
`jpeg.encode_pixels`); `encode_png` and `write_png` write uint8 gray or
RGB as an 8-bit PNG; `encode_image` writes the bytes `cv2.imencode`
writes for .bmp/.dib, .ppm/.pnm, .pam, .pfm, .sr/.ras, .tif/.tiff,
.hdr/.pic, .gif (`utils/gif.py`: cv2's fixed 3-3-2 palette with its
Floyd-Steinberg dithering), .jp2 (`utils/jpeg2000_write.py`: OpenJPEG
2.5.3 at cv2's defaults, its rate allocation included) and .avif
(`utils/avif_write.py`: libavif 1.4.2 over libaom 3.14.1 at cv2's
defaults, the encoder's decisions included), and for .webp a
lossless file of cv2's pixels (host C; `encode_image_plain` runs the
modules' plain writers); .apng is written as .png, as cv2's APNG
encoder writes one still image;
`decode_gray_png` reads a gray PNG as `cv2.imdecode(buf,
cv2.IMREAD_GRAYSCALE)` does. `resize_linear` is cv2's INTER_LINEAR and
`resize_area` its INTER_AREA, bit for bit through the C library where
noted (`resize_linear_plain` and `resize_area_plain` are the NumPy
versions): INTER_LINEAR on uint8 (fixed-point arithmetic) and on
two-channel float32 (the segmentation coverage maps), INTER_AREA on
float32. cv2 5.0 hands one-, three- and four-channel float32
INTER_LINEAR to IPP, whose arithmetic is not reproduced here: those go
through torch's bilinear, within float rounding of cv2.
"""

from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from multiposenet_tpu_torch.utils import (avif, avif_write, bmp, gif, hdr,
                                          image_codec, jpeg, jpeg2000,
                                          jpeg2000_write, pxm, sunras, tiff,
                                          webp)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
NPY_MAGIC = b"\x93NUMPY"
JPEG_MAGIC = b"\xff\xd8\xff"
# Magic bytes of formats the reader refuses, to name them in the error.
_OTHER_FORMATS = {
    b"\x76\x2f\x31\x01": "OpenEXR",
}
# Suffix → the writer's kind for `encode_image`, as cv2.imwrite picks it.
WRITTEN_SUFFIXES = {".bmp": "bmp", ".dib": "bmp", ".ppm": "ppm",
                    ".pnm": "ppm", ".pam": "pam", ".pfm": "pfm",
                    ".sr": "sunras", ".ras": "sunras", ".tif": "tiff",
                    ".tiff": "tiff", ".webp": "webp", ".hdr": "hdr",
                    ".pic": "hdr", ".gif": "gif", ".jp2": "jp2",
                    ".avif": "avif"}
# Suffixes cv2.imwrite writes as a PNG (its APNG encoder writes one still
# image as the PNG encoder does).
PNG_SUFFIXES = (".png", ".apng")
# Suffixes for which cv2.imwrite of 3-channel pixels returns False and
# writes no file.
UNWRITTEN_SUFFIXES = (".pgm", ".pbm")
# Written suffixes whose side cv2 limits (past it: no file, False).
_MAX_SIDES = {".webp": webp.MAX_SIDE, ".gif": gif.MAX_SIDE}
# Written suffixes whose sides cv2 wants at least so long (under it:
# False, and the file holds what the encoder wrote before it failed).
_MIN_SIDES = {".jp2": jpeg2000_write.MIN_SIDE}
# PNG colour type → (samples a pixel, allowed bit depths).
_PNG_KINDS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
              3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
_PNG_COLOUR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                     6: "RGBA"}
# Adam7 passes: (first row, first column, row step, column step).
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def read_image(path: str | Path) -> np.ndarray:
    """File → uint8 RGB [H, W, 3] (see the module docstring). Raises
    FileNotFoundError for a missing file and ValueError for a format or
    mode that is not read."""
    return decode_image(Path(path).read_bytes(), path, eof_fill=True)


def image_size(path: str | Path) -> tuple[int, int]:
    """The (height, width) of what `read_image` returns for the file: a
    JPEG's from its header, walked up to the first SOS, and its Exif
    orientation (5-8 swap the sides), an AVIF's from its container and
    AV1 headers (a grid's output size) and its Exif item's orientation,
    any other format's by decoding it."""
    data = Path(path).read_bytes()
    if data.startswith(JPEG_MAGIC):
        try:
            h, w = image_codec.jpeg_size(data)
        except ValueError:
            return decode_image(data, path, eof_fill=True).shape[:2]
        turned = exif_orientation(jpeg.exif_block(data)) in (5, 6, 7, 8)
        return (w, h) if turned else (h, w)
    if avif.is_avif(data):
        try:
            image = avif.read_image(data)
        except ValueError as exc:
            raise ValueError(f"{path}: {exc}") from None
        turned = exif_orientation(image.exif) in (5, 6, 7, 8)
        return (image.width, image.height) if turned else (image.height,
                                                           image.width)
    return decode_image(data, path, eof_fill=True).shape[:2]


def decode_image(data: bytes, name: str | Path = "<bytes>",
                 eof_fill: bool = False) -> np.ndarray:
    """Encoded bytes (a format of the module docstring) → uint8 RGB
    [H, W, 3], Exif orientation applied; `name` is used in error messages.
    `eof_fill` reads a JPEG whose data ends early as `cv2.imread` reads
    the file."""
    if data.startswith(JPEG_MAGIC):
        try:
            rgb = image_codec.decode_jpeg(data, eof_fill)
        except ValueError as exc:
            raise ValueError(f"{name}: {exc}") from None
        return apply_orientation(rgb, exif_orientation(jpeg.exif_block(data)))
    if data.startswith(PNG_SIGNATURE):
        pixels, exif = _decode_png(data, name)
        return apply_orientation(_gray_to_rgb(pixels),
                                 exif_orientation(exif))
    if data.startswith(NPY_MAGIC):
        return _npy_image(data, name)
    return _decode_simple(data, name, plain=False)


def decode_image_plain(data: bytes, name: str | Path = "<bytes>",
                       eof_fill: bool = False) -> np.ndarray:
    """`decode_image` of a baseline JPEG, BMP, Netpbm, Sun raster, TIFF,
    GIF, WebP, JPEG 2000, AVIF or Radiance HDR file with the coders' plain
    Python versions
    instead of the C library (`utils/jpeg.py` refuses the JPEG modes past
    baseline by name); `eof_fill` as for `decode_image`."""
    if data.startswith(JPEG_MAGIC):
        try:
            rgb = jpeg.decode_pixels(data, eof_fill)
        except ValueError as exc:
            raise ValueError(f"{name}: {exc}") from None
        return apply_orientation(rgb, exif_orientation(jpeg.exif_block(data)))
    return _decode_simple(data, name, plain=True)


def _decode_webp(data: bytes, name, plain: bool) -> np.ndarray:
    try:
        rgb, exif = webp.decode(data, plain=plain)
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None
    return apply_orientation(rgb, exif_orientation(exif))


_READERS = {"bmp": bmp, "pxm": pxm, "sunras": sunras, "tiff": tiff,
            "gif": gif, "hdr": hdr}


def simple_format(data: bytes) -> str | None:
    """The module that reads `data` by its signature, as cv2's decoders
    check theirs: "bmp", "hdr", "pxm", "sunras", "tiff", "gif", or None."""
    if data[:2] == b"BM":
        return "bmp"
    if hdr.is_hdr(data):
        return "hdr"
    if data[:1] == b"P" and data[1:2] and data[1:2] in b"1234567Ff" \
            and data[2:3] and data[2:3] in b" \t\n\v\f\r":
        return "pxm"
    if data[:4] == sunras.MAGIC:
        return "sunras"
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return "tiff"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    return None


def _decode_simple(data: bytes, name, plain: bool) -> np.ndarray:
    if (data[:4] == b"RIFF" and data[8:12] == b"WEBP") or webp.is_webp(data):
        return _decode_webp(data, name, plain)
    if data.startswith((jpeg2000.JP2_SIGNATURE, jpeg2000.J2K_SIGNATURE)):
        try:
            return jpeg2000.decode(data, plain=plain)
        except ValueError as exc:
            raise ValueError(f"{name}: {exc}") from None
    if avif.is_avif(data):
        try:
            rgb, exif = avif.decode_with_exif(data, plain=plain)
        except ValueError as exc:
            raise ValueError(f"{name}: {exc}") from None
        return apply_orientation(rgb, exif_orientation(exif))
    kind = simple_format(data)
    if kind is not None:
        reader = _READERS[kind]
        if kind in ("pxm", "sunras"):
            return reader.decode(data, name)
        return reader.decode(data, name, plain=plain)
    if data[:4] == b"RIFF":
        raise ValueError(f"{name}: RIFF {bytes(data[8:12])!r} files are not "
                         "read here (of RIFF, WebP only)")
    for magic, fmt in _OTHER_FORMATS.items():
        if data.startswith(magic):
            raise ValueError(f"{name}: {fmt} images are not read here")
    suffix = Path(str(name)).suffix or "none"
    raise ValueError(f"{name}: not an image file this reader knows (suffix "
                     f"{suffix}): JPEG, PNG, .npy, WebP, JPEG 2000, AVIF, "
                     "BMP, PBM/PGM/PPM/PAM/PFM, Sun raster, Radiance HDR, "
                     "TIFF and GIF only")


def _npy_image(data: bytes, name) -> np.ndarray:
    arr = np.load(io.BytesIO(data), allow_pickle=False)
    if arr.dtype != np.uint8 or not (
            arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] == 3)):
        raise ValueError(f"{name}: a .npy image must be uint8 [H, W, 3] or "
                         f"[H, W]; got {arr.dtype} {arr.shape}")
    return _gray_to_rgb(arr)


def _gray_to_rgb(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    return np.ascontiguousarray(arr)


# --- Exif orientation -----------------------------------------------------

# Tags OpenCV's Exif reader parses as strings; one whose data lies outside
# the block ends the parse there.
_EXIF_STRING_TAGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x013B, 0x8298)


def exif_orientation(tiff: bytes | None) -> int:
    """The orientation (1-8) in Exif TIFF bytes, as OpenCV's Exif reader
    finds it: IFD0's entries in file order, tag 0x0112 read as a 16-bit
    value at its value field whatever its type and count. A missing or
    malformed block, a value outside 1-8, or an entry that cannot be
    read before the tag (past the block, or a string tag whose data lies
    outside it) gives 1."""
    if not tiff or len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    magic, ifd = struct.unpack(e + "HI", tiff[2:8])
    if magic != 42 or ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for i in range(count):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            return 1
        tag, _, n, value = struct.unpack(e + "HHII", tiff[at:at + 12])
        if tag == 0x0112:
            (o,) = struct.unpack(e + "H", tiff[at + 8:at + 10])
            return o if 1 <= o <= 8 else 1
        if tag in _EXIF_STRING_TAGS:
            start = value if n > 4 else 4
            if start > len(tiff) or start + n > len(tiff):
                return 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Pixels stored under Exif `orientation` → as displayed: OpenCV's
    ExifTransform (2 flips columns, 3 rotates 180°, 4 flips rows, 5
    transposes, 6 rotates 90° clockwise, 7 transposes and rotates 180°,
    8 rotates 90° counter-clockwise)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
        orientation -= 4
        if orientation == 1:
            return np.ascontiguousarray(img)
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


# --- PNG --------------------------------------------------------------------


def _chunks(data: bytes, name):
    """(type, payload) of each PNG chunk, CRC checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc_at = pos + 8 + length
        if len(payload) != length or crc_at + 4 > len(data):
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[crc_at:crc_at + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{name}: bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = crc_at + 4
    raise ValueError(f"{name}: PNG without IEND")


def _decode_png(data: bytes, name) -> tuple[np.ndarray, bytes | None]:
    """PNG bytes → (uint8 [H, W] gray or [H, W, 3] colour, the Exif TIFF
    bytes of its eXIf chunk or None)."""
    header, palette, exif, idat = None, None, None, []
    for kind, payload in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            if len(payload) % 3:
                raise ValueError(f"{name}: PLTE of {len(payload)} bytes")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"eXIf" and exif is None and payload[:4] in (
                b"II*\x00", b"MM\x00*"):  # libpng drops any other
            exif = payload
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _PNG_KINDS or depth not in _PNG_KINDS[colour][1] \
            or interlace > 1:
        raise ValueError(
            f"{name}: PNG with {depth}-bit "
            f"{_PNG_COLOUR_NAMES.get(colour, f'colour type {colour}')} "
            f"samples{', interlace method ' + str(interlace) if interlace > 1 else ''}"
            " is not a valid PNG")
    if colour == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    channels = _PNG_KINDS[colour][0]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"{name}: corrupt PNG image data ({exc})") from None
    samples = np.zeros((height, width, channels), np.int64)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    pos = 0
    for y0, x0, dy, dx in passes:
        h = len(range(y0, height, dy))
        w = len(range(x0, width, dx))
        if h == 0 or w == 0:
            continue
        stride = -(-w * channels * depth // 8)
        size = h * (stride + 1)
        if pos + size > len(raw):
            raise ValueError(f"{name}: PNG image data of {len(raw)} bytes "
                             "is too short")
        rows = np.frombuffer(raw, np.uint8, size, pos).reshape(h, stride + 1)
        pos += size
        bpp = max(1, channels * depth // 8)
        pixels = _unfilter(rows[:, 0], rows[:, 1:], bpp, name)
        samples[y0::dy, x0::dx] = _unpack(pixels, w, channels, depth)
    if pos != len(raw):
        raise ValueError(f"{name}: PNG image data of {len(raw)} bytes, "
                         f"want {pos}")
    if depth == 16:
        samples >>= 8
    elif depth < 8 and colour == 0:
        samples *= 255 // ((1 << depth) - 1)
    if colour == 3:
        full = np.zeros((256, 3), np.uint8)  # libpng's padding: black
        n = min(len(palette), 256)
        full[:n] = palette[:n]
        return full[samples[:, :, 0]], exif
    out = samples.astype(np.uint8)
    if channels <= 2:
        return out[:, :, 0].copy(), exif
    return out[:, :, :3].copy(), exif


def _unpack(rows: np.ndarray, width: int, channels: int,
            depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] → samples [h, width, channels] int64."""
    h = rows.shape[0]
    if depth == 8:
        flat = rows[:, :width * channels].astype(np.int64)
    elif depth == 16:
        flat = rows[:, :2 * width * channels].reshape(h, -1, 2) \
            .astype(np.int64)
        flat = (flat[:, :, 0] << 8) | flat[:, :, 1]
    else:
        bits = np.unpackbits(rows, axis=1)[:, :width * channels * depth]
        weights = 1 << np.arange(depth - 1, -1, -1)
        flat = bits.reshape(h, -1, depth).astype(np.int64) @ weights
    return flat.reshape(h, width, channels)


def _unfilter(filters: np.ndarray, rows: np.ndarray, bpp: int,
              name) -> np.ndarray:
    """Undo PNG's per-row filters (None, Sub, Up, Average, Paeth) in
    modulo-256 arithmetic; None, Sub and Up vectorised, Average and Paeth
    (which depend on the pixel just decoded) a byte at a time."""
    height, stride = rows.shape
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        f, cur = int(filters[y]), rows[y]
        if f == 0:
            out[y] = cur
        elif f == 1:
            out[y] = np.cumsum(cur.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif f == 2:
            out[y] = cur + prev
        elif f in (3, 4):
            out[y] = _unfilter_row(f, cur.tolist(), prev.tolist(), bpp)
        else:
            raise ValueError(f"{name}: PNG row filter {f} is not defined")
        prev = out[y]
    return out


def _unfilter_row(f: int, cur: list, prev: list, bpp: int) -> list:
    row = [0] * len(cur)
    for i, x in enumerate(cur):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        if f == 3:
            row[i] = (x + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (x + pred) & 0xFF
    return row


def encode_png(pixels: np.ndarray) -> bytes:
    """uint8 gray [H, W] or RGB [H, W, 3] → 8-bit PNG bytes (rows
    unfiltered). PNG is lossless: `decode_image` / `decode_gray_png` (and
    cv2) read the same pixels back, though the bytes differ from cv2's."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8 or not (
            pixels.ndim == 2 or (pixels.ndim == 3 and pixels.shape[-1] == 3)):
        raise ValueError("encode_png takes uint8 gray [H, W] or RGB "
                         f"[H, W, 3]; got {pixels.dtype} {pixels.shape}")
    height, width = pixels.shape[:2]
    channels = 1 if pixels.ndim == 2 else 3
    rows = np.zeros((height, width * channels + 1), np.uint8)
    rows[:, 1:] = pixels.reshape(height, width * channels)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    colour = 0 if channels == 1 else 2
    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8,
                                         colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str | Path, rgb: np.ndarray) -> None:
    """uint8 RGB [H, W, 3] → an 8-bit RGB PNG file (rows unfiltered)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError("write_png takes uint8 RGB [H, W, 3]; got "
                         f"{rgb.dtype} {rgb.shape}")
    Path(path).write_bytes(encode_png(rgb))


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """uint8 RGB [H, W, 3] → the JPEG bytes `cv2.imencode(".jpg", bgr)`
    writes at its defaults, bit for bit (host C; `jpeg.encode_pixels` is
    the plain version)."""
    return image_codec.encode_jpeg(rgb)


def write_jpeg(path: str | Path, rgb: np.ndarray) -> None:
    """uint8 RGB [H, W, 3] → a JPEG file, as `cv2.imwrite(path, bgr)`
    writes one with a .jpg suffix."""
    Path(path).write_bytes(encode_jpeg(rgb))


def encode_image(rgb: np.ndarray, suffix: str) -> bytes:
    """uint8 RGB [H, W, 3] → the bytes `cv2.imencode(suffix, bgr)` writes
    for a suffix of `WRITTEN_SUFFIXES` (host C; .hdr and .pic through
    `utils/hdr.py`'s coders, .gif through `utils/gif.py`'s, .jp2 through
    `utils/jpeg2000_write.py`'s, .avif through `utils/avif_write.py`'s),
    but for the pad byte after a Sun
    raster's last row (see `utils/sunras.py`); for .webp a lossless file
    that cv2 reads back to the same pixels (`utils/webp.py`)."""
    kind = WRITTEN_SUFFIXES[suffix.lower()]
    if kind == "webp":
        return webp.encode(rgb)
    if kind == "gif":
        return gif.encode(rgb)
    if kind == "jp2":
        return jpeg2000_write.encode(rgb)
    if kind == "avif":
        return avif_write.encode(rgb)
    return image_codec.encode_image(rgb, kind)


def encode_image_plain(rgb: np.ndarray, suffix: str) -> bytes:
    """The plain NumPy version of `encode_image`."""
    kind = WRITTEN_SUFFIXES[suffix.lower()]
    if kind == "webp":
        return webp.encode(rgb, plain=True)
    rgb = np.ascontiguousarray(rgb)
    if kind in ("ppm", "pam", "pfm"):
        return pxm.encode(rgb, kind)
    if kind == "hdr":
        return hdr.encode_plain(rgb)
    if kind == "gif":
        return gif.encode_plain(rgb)
    if kind == "jp2":
        return jpeg2000_write.encode_plain(rgb)
    if kind == "avif":
        return avif_write.encode_plain(rgb)
    return {"bmp": bmp, "sunras": sunras, "tiff": tiff}[kind].encode(rgb)


def write_image(path: str | Path, rgb: np.ndarray) -> bool:
    """uint8 RGB [H, W, 3] → a file, as `cv2.imwrite(path, bgr)` writes it
    for .png and .apng (an 8-bit PNG) and .webp (lossless; for these cv2's
    bytes differ, its pixels do not), the JPEG suffixes and
    `WRITTEN_SUFFIXES`;
    for .pgm and .pbm it writes nothing and returns False, as cv2.imwrite
    does for 3-channel pixels, and so for a .webp wider or taller than
    16383 pixels and a .gif wider or taller than 65535; for a .jp2
    narrower or shorter than 32 it returns False too, leaving in the file
    the JP2 boxes OpenJPEG writes before it refuses the size, as
    cv2.imwrite leaves them. Any other suffix raises a ValueError naming
    it."""
    suffix = Path(path).suffix.lower()
    if suffix in UNWRITTEN_SUFFIXES:
        return False
    if suffix in PNG_SUFFIXES:
        write_png(path, rgb)
    elif suffix in (".jpg", ".jpeg", ".jpe"):
        write_jpeg(path, rgb)
    elif max(np.shape(rgb)[:2]) > _MAX_SIDES.get(suffix, np.inf):
        return False  # cv2.imwrite's encoder fails: no file, False
    elif min(np.shape(rgb)[:2]) < _MIN_SIDES.get(suffix, 0):
        Path(path).write_bytes(jpeg2000_write.jp2_header(*np.shape(rgb)[:2]))
        return False
    elif suffix in WRITTEN_SUFFIXES:
        Path(path).write_bytes(encode_image(rgb, suffix))
    else:
        raise ValueError(f"{path}: suffix {suffix or 'none'} is not written "
                         "here")
    return True


def decode_gray_png(data: bytes, name: str | Path = "<bytes>") -> np.ndarray:
    """Gray PNG bytes (any bit depth, alpha dropped) → uint8 [H, W], as
    `cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)` reads them; Exif orientation
    applied. Colour PNGs are refused: cv2 would convert them to gray
    with libpng's weights, which are not reproduced here."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG")
    pixels, exif = _decode_png(data, name)
    if pixels.ndim != 2:
        raise ValueError(f"{name}: a colour PNG is not read as gray here")
    return apply_orientation(pixels[:, :, None],
                             exif_orientation(exif))[:, :, 0]


# --- resizing -----------------------------------------------------------------


def _check_resize(arr: np.ndarray, size) -> None:
    if arr.dtype not in (np.uint8, np.float32) or arr.ndim not in (2, 3):
        raise ValueError("resize_linear takes uint8 or float32 [H, W] or "
                         f"[H, W, C]; got {arr.dtype} {arr.shape}")
    if size[0] < 1 or size[1] < 1:
        raise ValueError(f"resize_linear: bad size {size}")


def _two_channel_f32(arr: np.ndarray) -> bool:
    return arr.dtype == np.float32 and arr.ndim == 3 and arr.shape[2] == 2


def resize_linear(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR) for uint8
    or float32 [H, W] / [H, W, C] arrays. uint8 and two-channel float32
    go through the C library, bit for bit with cv2; other float32 is
    torch's bilinear with half-pixel centres, no antialias, edge pixels
    repeated (within float rounding of cv2's IPP path)."""
    arr = np.asarray(image)
    _check_resize(arr, size)
    if arr.shape[:2] == (size[1], size[0]):
        return arr.copy()  # cv2 copies an image of the same size
    if arr.dtype == np.uint8:
        return image_codec.resize_linear_u8(arr, size)
    if _two_channel_f32(arr):
        return image_codec.resize_linear_f32(arr, size)
    w, h = size
    x = torch.from_numpy(np.ascontiguousarray(arr))
    x = x[None, None] if arr.ndim == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=False)[0]
    y = y[0] if arr.ndim == 2 else y.permute(1, 2, 0)
    return np.ascontiguousarray(y.numpy())


def _linear_coords(src: int, dst: int, clamp: bool):
    """Source indices s, s + 1 (clipped to the axis), the float32 fraction
    f and cv2's `xmax` along one axis, as cv2 computes them: float32
    coordinates (d + 0.5) * scale - 0.5 with scale = 1 / (dst / src) in
    double. With `clamp` (cv2 does it along x only) a coordinate beyond
    an edge takes the edge sample at full weight. `xmax` is the first
    output whose index (raised to 0) plus one reaches the last sample:
    cv2's float path takes one tap from there on."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    one_tap = np.flatnonzero(np.maximum(s, 0) + 1 >= src)
    xmax = int(one_tap[0]) if len(one_tap) else dst
    if clamp:
        low, high = s < 0, s >= src - 1
        s[low], f[low] = 0, 0
        s[high], f[high] = src - 1, 0
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f, xmax


def _linear_axis(src: int, dst: int, clamp: bool):
    """`_linear_coords` with cv2's 11-bit weights rint((1 - f) * 2048)
    and rint(f * 2048)."""
    s0, s1, f, _ = _linear_coords(src, dst, clamp)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return s0, s1, w0, w1


def resize_linear_plain(image: np.ndarray,
                        size: tuple[int, int]) -> np.ndarray:
    """The plain NumPy version of `resize_linear` on uint8 and on
    two-channel float32, the specification of `csrc/image_codec.c
    resize_linear_u8` and `resize_linear_f32`.

    uint8: an exact integer horizontal pass S = a0 * p0 + a1 * p1, then
    cv2's vectorised vertical pass (((S0 >> 4) * b0) >> 16) + (((S1 >>
    4) * b1) >> 16), (+ 2) >> 2, saturated. Rows are not clamped: above
    the first source row and below the last both rows are the edge row,
    with the weights as computed (cv2 computes them so, and its two
    truncating products can then land one level below the edge row
    itself).

    float32: the same coordinates with float weights (1 - f, f), each
    product and sum rounded to float, no fused multiply-add; along x two
    taps up to the first output whose source index (raised to 0) plus one
    reaches the last column, one tap from there on. Halving both sides
    is cv2's INTER_AREA, as cv2 does."""
    arr = np.asarray(image)
    _check_resize(arr, size)
    if arr.shape[:2] == (size[1], size[0]):
        return arr.copy()
    if _two_channel_f32(arr):
        return _resize_linear_f32_plain(arr, size)
    if arr.dtype != np.uint8:
        raise ValueError("resize_linear_plain takes uint8 or float32 "
                         "[H, W, 2]")
    w, h = size
    src = arr.reshape(arr.shape[0], arr.shape[1], -1).astype(np.int64)
    x0, x1, a0, a1 = _linear_axis(src.shape[1], w, clamp=True)
    y0, y1, b0, b1 = _linear_axis(src.shape[0], h, clamp=False)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    v = (((rows[y0] >> 4) * b0[:, None, None]) >> 16) \
        + (((rows[y1] >> 4) * b1[:, None, None]) >> 16)
    out = np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((h, w) + arr.shape[2:])


def _resize_linear_f32_plain(arr: np.ndarray, size) -> np.ndarray:
    w, h = size
    if arr.shape[0] == 2 * h and arr.shape[1] == 2 * w:
        return resize_area_plain(arr, size)
    x0, x1, fx, xmax = _linear_coords(arr.shape[1], w, clamp=True)
    y0, y1, fy, _ = _linear_coords(arr.shape[0], h, clamp=False)
    a0, b0 = np.float32(1) - fx, np.float32(1) - fy
    rows = arr[:, x0] * a0[None, :, None] + arr[:, x1] * fx[None, :, None]
    rows[:, xmax:] = arr[:, x0[xmax:]]
    return rows[y0] * b0[:, None, None] + rows[y1] * fy[:, None, None]


def _check_area(arr: np.ndarray, size) -> None:
    w, h = size
    if arr.dtype != np.float32 or arr.ndim not in (2, 3):
        raise ValueError("resize_area takes float32 [H, W] or [H, W, C]; "
                         f"got {arr.dtype} {arr.shape}")
    if not (1 <= h <= arr.shape[0] and 1 <= w <= arr.shape[1]):
        raise ValueError(f"resize_area shrinks only: {arr.shape[:2]} to "
                         f"{(h, w)}")
    cn = 1 if arr.ndim == 2 else arr.shape[2]
    if arr.shape[:2] == (2 * h, 2 * w) and cn in (1, 3, 4):
        raise ValueError("resize_area: cv2 halves 1, 3 and 4 channels in "
                         "vector code whose sums are grouped otherwise; "
                         "not reproduced here")


def resize_area(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """cv2.resize(image, (w, h), interpolation=cv2.INTER_AREA) on float32
    [H, W] / [H, W, C] shrinking to (w, h), bit for bit through the C
    library (see `resize_area_plain`)."""
    arr = np.asarray(image)
    _check_area(arr, size)
    if arr.shape[:2] == (size[1], size[0]):
        return arr.copy()
    return image_codec.resize_area_f32(arr, size)


def _integer_ratio(src: int, dst: int) -> int:
    """cv2's test for an integer ratio: 1 / (dst / src) within
    DBL_EPSILON of its rounding (0 if not)."""
    r = 1.0 / (dst / src)
    i = int(r + 0.5)
    return i if abs(r - i) < np.finfo(np.float64).eps else 0


def _area_table(src: int, dst: int):
    """computeResizeAreaTab for a ratio that is no integer: per output,
    its source indices and float32 weights, padded into [dst, K] arrays
    with a validity mask."""
    scale = 1.0 / (dst / src)
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((dst, k), np.int64)
    wt = np.zeros((dst, k), np.float32)
    valid = np.zeros((dst, k), bool)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[d, j], wt[d, j], valid[d, j] = s, np.float32(a), True
    return idx, wt, valid


def resize_area_plain(image: np.ndarray,
                      size: tuple[int, int]) -> np.ndarray:
    """The plain NumPy version of `resize_area`, the specification of
    `csrc/image_codec.c resize_area_f32`. At an integer ratio on both
    axes (cv2's resizeAreaFast_ without its vector code): each output the
    float sum of its block in row order, four samples at a time ((a + b)
    + c) + d added to the running sum, times the float 1 / area.
    Otherwise (cv2's resizeArea_): each source row weighted along x
    (buf[d] += s * alpha, taps in order), then rows along y (sum = beta
    * buf for an output row's first tap, sum += beta * buf after), all
    in float32."""
    arr = np.asarray(image)
    _check_area(arr, size)
    if arr.shape[:2] == (size[1], size[0]):
        return arr.copy()
    w, h = size
    src = arr.reshape(arr.shape[0], arr.shape[1], -1)
    ix, iy = _integer_ratio(src.shape[1], w), _integer_ratio(src.shape[0], h)
    if ix and iy:
        cn = src.shape[2]
        blocks = src[:h * iy, :w * ix].reshape(h, iy, w, ix, cn) \
            .transpose(0, 2, 4, 1, 3).reshape(h, w, cn, ix * iy)
        area = ix * iy
        total = np.zeros((h, w, cn), np.float32)
        k = 0
        while k + 4 <= area:
            b = blocks[..., k:k + 4]
            total += ((b[..., 0] + b[..., 1]) + b[..., 2]) + b[..., 3]
            k += 4
        for k in range(k, area):
            total += blocks[..., k]
        out = total * np.float32(1.0 / area)
    else:
        xi, xw, xv = _area_table(src.shape[1], w)
        yi, yw, yv = _area_table(src.shape[0], h)
        rows = np.zeros((src.shape[0], w, src.shape[2]), np.float32)
        for j in range(xi.shape[1]):
            rows = np.where(xv[None, :, j, None],
                            rows + src[:, xi[:, j]] * xw[None, :, j, None],
                            rows)
        out = rows[yi[:, 0]] * yw[:, 0, None, None]
        for j in range(1, yi.shape[1]):
            out = np.where(yv[:, j, None, None],
                           out + rows[yi[:, j]] * yw[:, j, None, None], out)
    return out.reshape((h, w) + arr.shape[2:]).astype(np.float32)
