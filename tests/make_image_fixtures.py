"""Writes the image fixtures under tests/fixtures/images/ with cv2, for
the card's machine, which can neither encode JPEG nor run cv2. The tests
do not run this script; they check that its digests still equal the
installed cv2's decode.

    python tests/make_image_fixtures.py

- `scene_*.jpg`: `data/synthetic.make_dataset` scenes with texture laid
  over them (the flat scenes alone compress to a few KB and barely
  exercise the IDCT or the upsampling), at several samplings and
  qualities; `annotations.json` is a COCO person-keypoints JSON of their
  persons, for `eval --coco-json ... --image-dir`;
  `annotations_segs.json` is the same persons with COCO segmentations
  (`segmentation_annotations`), for `prepare --coco-json`: multi-part
  polygons whose parts overlap (with a part off the image and a part
  under 6 numbers), uncompressed and compressed RLE, crowd regions in
  both RLE forms, a person with no labelled keypoint and persons with no
  segmentation (the box fallback).
- `photo_480x640_q95_420.jpg`: the timing fixture (and `predict`'s input).
- `kind_*.jpg`: textured and noise content covering 4:4:4, 4:2:2, 4:2:0,
  4:4:0, 4:1:1 and gray, q 50, 75, 95 and 100, optimised Huffman tables,
  restart intervals, odd sizes (97x133, 37x53, 3x3) and Exif orientations
  3 and 6 spliced into APP1 (little- and big-endian).
- `c3_*.jpg`: the modes past baseline that cv2 reads and the plain
  decoder refuses: progressive (with restart intervals, and gray), Adobe
  RGB (PIL's keep_rgb), CMYK (PIL) and YCCK (the CMYK stream with its
  Adobe transform set to 2), and files cut inside their scan data, one
  baseline and one progressive cut in its last scan (which `cv2.imread`
  fills and reads).
- `c3_arith_*`, `c3_lossless_*`, `c3_smooth_*`: the modes past those
  that cv2 reads, written by libjpeg-turbo 3.1 itself (`libjpeg_jpeg`):
  arithmetic coding (sequential 4:2:0; progressive 4:4:4 with restarts
  and DAC conditioning other than the defaults), lossless RGB (predictors
  1 and 7, a point transform, 4:2:0) and CMYK, and a progressive file
  ended after its DC scan and after its first AC scan, which libjpeg
  reads through its inter-block smoothing.
- `png_palette4.png`, `png_rgb16.png`, `png_interlaced.png`: PNG kinds
  the port decodes without cv2 (palette, 16-bit, Adam7).
- `webp_*.webp`: WebP as cv2 reads it, written by cv2 (lossy at q 1, 50,
  90 and 100; lossless at its default) and by libwebp 1.6 itself
  (`libwebp_webp`, for the encoder options cv2 does not expose: the
  simple loop filter, 4 token partitions, one segment, sharpness 7; an
  ALPH plane; lossless at method 0 and 6, with the colour cache and meta
  prefix codes, and palettes of 2, 3 and 12 colours, which bundle
  pixels). libwebp 1.6 writes one token partition whatever it is asked;
  `repartition` re-codes two of its frames into 4 and 8. Containers are
  spliced here (`webp_file`): a VP8X file with
  an EXIF chunk of orientation 6 and an animation whose first frame lies
  off the canvas's corner; odd sizes (1x1, 3x5, 17x33); and the 480x640
  timing fixtures, the photo lossy at q 90 and a textured scene
  lossless.
- `tiff_*.tif`, `hdr_*.hdr`, `hdr_*.pic`: TIFF and Radiance HDR as cv2
  reads them (`tiff_hdr_fixtures`). JPEG-compressed TIFFs: YCbCr 4:2:0
  strips sharing JPEGTables (abbreviated streams), 4:2:2 tiles, a last
  strip whose stream keeps the full strip height, and Pillow's and cv2's
  own RGB, gray, CMYK and YCbCr files; CCITT RLE, group 3 (1-D and 2-D)
  and group 4 in both fill orders, several strips, MinIsWhite and
  MinIsBlack, and a 1728x2292 group 4 page (A4 at 200 dpi, the fax
  width: the timing fixture); CMYK (planar LZW, Pillow's), YCbCr of 2x2,
  4x2 and 4x4 units (tiles the image covers only partly) and Pillow's,
  CIELab of 8 bits (Pillow's) and of 16 bits with a D65 WhitePoint; HDR
  written by cv2 (run-length and, under 8 wide, flat), a `#?RGBE` file
  with EXPOSURE and comment lines, and one whose later scanlines are
  flat.
- `j2k_*.jp2`, `j2k_*.j2k`: JPEG 2000 as cv2 reads it (Pillow's writer,
  `jpeg2000_fixtures`): a reversible gray JP2 and an irreversible RGB
  codestream of three quality layers in RPCL order, small enough for the
  budget (every other JPEG 2000 case is made at test time).
- `avif_*.avif`: AVIF as cv2 reads it, written by cv2 itself
  (`avif_fixtures`: libavif 1.4.2 over libaom 3.14.1 at cv2's default
  quality and speed unless named): noise (64x80), a gray crop of the
  photo (a monochrome stream), an odd-sided crop (33x17), a line drawing
  libaom codes with TX_MODE_SELECT, a BGRA crop (an alpha auxiliary item)
  and the 480x640 photo (the AVIF timing fixture); a 128x160 crop of the
  photo at IMWRITE_AVIF_QUALITY 100 (lossless 4:4:4 with the identity
  matrix; `predict`'s AVIF input), the photo at IMWRITE_AVIF_SPEED 2
  (loop restoration), a drawing of flat colours and text at speed 6
  (palette) and one at speed 6 that libaom codes with intra block copy
  (`tests/avif_reference.py drawing`); two crops of the photo at
  IMWRITE_AVIF_DEPTH 10 (96x128, 4:2:0, profile 0; `predict`'s 10-bit
  input) and 12 (64x80, 4:2:0, profile 2), from uint16 pixels with
  seeded noise in the low bits (`avif_reference.widen`). Four more
  are written by the wheel's libavif encoder, as other encoders than
  cv2 write them (`other_avif_fixtures`): 4:4:4 lossy (profile 1), 4:2:2
  with CDEF's chroma filter on (profile 2), 4:2:2 at 10 bits and a
  limited-range BT.709 4:2:0 crop, as video tools write frames
  (`predict`'s input on the card). Two hold the container forms past one
  still item (`container_avif_fixtures`): a 128x96 crop of the photo as a
  grid of 2x2 cells of 64x64 with an Exif item of orientation 6 (the
  wheel's libavif encoder; cv2 returns it 96x128) and three 48x64 crops
  as a Pillow image sequence (brand avis; cv2 returns the first). Three
  hold libaom's film grain and segmentation (`grain_avif_fixtures`, the
  wheel's libavif encoder): a 96x128 4:2:0 crop with `film-grain-test` 1,
  a 64x80 10-bit 4:4:4 crop with `film-grain-test` 15 (chroma scaled
  from luma) and a 2-frame 48x64 `aq-mode=1` sequence (its first frame
  segmented).
- `digests.json`: for each file, the shape and sha256 of cv2's RGB decode
  (`cv2.imread(path, IMREAD_COLOR)[..., ::-1]`) and of cv2's INTER_LINEAR
  letterbox of it to 512 (the eval runner's resize: scale 512 / max(h, w),
  rounded sizes), the size of the lossless file `cv2.imencode(".webp")`
  writes for its pixels and the sha256 of the bytes `cv2.imencode(".gif")`
  writes for them (its 3-3-2 palette, dithered); for the timing photo
  also the sha256 of the bytes `cv2.imencode(".jpg")` writes for them;
  for the TIFF and HDR files and the photo the sha256 of the bytes
  `cv2.imencode(".hdr")` writes for their pixels, and for the photo the
  sha256 of cv2's decode of that file and of the 480x640 TIFFs
  `multiposenet_tpu_torch/tools/image_samples.py timing_tiffs` builds
  from it. Some files (and a GIF of the photo's pixels,
  `image_samples.quantised_gif`, under the photo's entry as `gif_corrupt`)
  carry `corrupt` recipes (`corruption_recipes`): byte changes in their
  coded data, each with the sha256 of cv2's decode of the changed bytes
  (`cv2.imdecode`, which `cv2.imread` of them equals) or null where cv2
  returns no image; the JPEG 2000 files' recipes also cut them
  (`jpeg2000_recipes`). The two `kind_orient*` files carry `stray_sha256`,
  the `c3_smooth_*` files `sampling_sha256`: the digest
  (`image_samples.outcomes_sha256`) of cv2's decodes of every
  `image_samples.stray_recipes` (bytes that are no marker segment before
  each header segment) or `sampling_recipes` (each component's sampling
  factors set to every value) of the file. The photo's `exif_stray` is
  the recipe that puts stray bytes and an Exif APP1 of orientation 6
  before its DQT, with cv2's digest. `python tests/make_image_fixtures.py
  corrupt` writes only those into the committed digests, `python
  tests/make_image_fixtures.py jpeg2000` only the JPEG 2000 files with
  their digests and recipes, `python tests/make_image_fixtures.py
  avif` only the AVIF files with their digests, `python
  tests/make_image_fixtures.py avif_container` only the two container
  ones and `python tests/make_image_fixtures.py avif_grain` only the
  three film grain and segmentation ones.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import io
import json
import struct
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "fixtures" / "images"
LETTERBOX = 512
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}


# A writer over the libjpeg-turbo 3 that Pillow bundles, for the modes cv2
# cannot write: arithmetic coding, lossless (jpeg_enable_lossless), 12-
# and 16-bit samples. It is compiled against the system's jpeglib.h
# (libjpeg-turbo 2.1, the same struct layout) and linked to Pillow's
# library by path.
_WRITER_SOURCE = r"""
#include <stdio.h>
#include <jpeglib.h>
extern void jpeg_enable_lossless(j_compress_ptr, int, int);
extern JDIMENSION jpeg12_write_scanlines(j_compress_ptr, short ***,
                                         JDIMENSION);
extern JDIMENSION jpeg16_write_scanlines(j_compress_ptr, unsigned short ***,
                                         JDIMENSION);

/* samples: h * w * nc, uint8 at 8 bits, uint16 above. */
int write_jpeg(const void *samples, int w, int h, int nc, int precision,
               int quality, int progressive, int arith, int psv, int pt,
               int sampling, int restart_rows, int conditioning,
               unsigned char **out, unsigned long *size)
{
    struct jpeg_compress_struct c;
    struct jpeg_error_mgr e;
    int y, i;
    c.err = jpeg_std_error(&e);
    jpeg_create_compress(&c);
    *out = NULL;
    *size = 0;
    jpeg_mem_dest(&c, out, size);
    c.image_width = w;
    c.image_height = h;
    c.input_components = nc;
    c.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 4 ? JCS_CMYK : JCS_RGB;
    c.data_precision = precision > 8 ? precision : 8;
    jpeg_set_defaults(&c);
    if (psv) jpeg_enable_lossless(&c, psv, pt);
    c.data_precision = precision;
    if (!psv) jpeg_set_quality(&c, quality, TRUE);
    if (nc == 3) {
        c.comp_info[0].h_samp_factor = sampling >> 4;
        c.comp_info[0].v_samp_factor = sampling & 15;
    }
    if (progressive) jpeg_simple_progression(&c);
    c.arith_code = arith;
    c.restart_in_rows = restart_rows;
    if (conditioning)
        for (i = 0; i < NUM_ARITH_TBLS; i++) {
            c.arith_dc_L[i] = 1;
            c.arith_dc_U[i] = 3;
            c.arith_ac_K[i] = 2;
        }
    jpeg_start_compress(&c, TRUE);
    for (y = 0; y < h; y++) {
        if (precision == 8) {
            JSAMPROW r = (JSAMPROW)samples + (size_t)y * w * nc;
            jpeg_write_scanlines(&c, &r, 1);
        } else if (precision <= 12) {
            short *r = (short *)samples + (size_t)y * w * nc, **a = &r;
            jpeg12_write_scanlines(&c, &a, 1);
        } else {
            unsigned short *r = (unsigned short *)samples
                                + (size_t)y * w * nc, **a = &r;
            jpeg16_write_scanlines(&c, &a, 1);
        }
    }
    jpeg_finish_compress(&c);
    jpeg_destroy_compress(&c);
    return 0;
}
"""


@functools.cache
def _writer() -> ctypes.CDLL:
    import PIL

    libs = sorted((Path(PIL.__file__).parent.parent / "pillow.libs").glob(
        "libjpeg-*.so*"))
    if not libs:
        raise RuntimeError("Pillow's bundled libjpeg-turbo was not found")
    build = Path(tempfile.mkdtemp(prefix="jpeg_writer_"))
    (build / "writer.c").write_text(_WRITER_SOURCE)
    subprocess.run(["cc", "-O1", "-shared", "-fPIC", "-o",
                    str(build / "writer.so"), str(build / "writer.c"),
                    str(libs[0]), f"-Wl,-rpath,{libs[0].parent}"],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(build / "writer.so"))
    lib.write_jpeg.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 12 + [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_ulong)]
    return lib


def libjpeg_jpeg(samples: np.ndarray, precision: int = 8, quality: int = 90,
                 progressive: bool = False, arith: bool = False,
                 predictor: int = 0, point_transform: int = 0,
                 sampling: int = 0x22, restart_rows: int = 0,
                 conditioning: bool = False) -> bytes:
    """RGB [H, W, 3], CMYK [H, W, 4] or gray [H, W] samples → a JPEG
    written by
    libjpeg-turbo 3.1: `arith` arithmetic-coded, `predictor` 1-7 lossless
    (with `point_transform`), `precision` 8, 12 or 16 bits, `sampling` the
    luma factors (h << 4 | v), `conditioning` DAC values other than the
    defaults. The writer aborts the process on a mode libjpeg-turbo does
    not write (arithmetic-coded lossless)."""
    arr = np.ascontiguousarray(
        samples, np.uint8 if precision == 8 else np.uint16)
    h, w = arr.shape[:2]
    nc = 1 if arr.ndim == 2 else arr.shape[2]
    out = ctypes.POINTER(ctypes.c_ubyte)()
    size = ctypes.c_ulong()
    _writer().write_jpeg(arr.ctypes.data, w, h, nc, precision, quality,
                         int(progressive), int(arith), predictor,
                         point_transform, sampling, restart_rows,
                         int(conditioning), ctypes.byref(out),
                         ctypes.byref(size))
    return ctypes.string_at(out, size.value)


# A writer over the libwebp 1.6 that Pillow bundles, for the encoder
# options cv2 does not expose. It is compiled against the system's
# webp/encode.h (ABI 0x020f, the same major version) and linked to
# Pillow's library by path; libsharpyuv is loaded first, globally.
_WEBP_WRITER_SOURCE = r"""
#include <webp/encode.h>

/* o: quality, method, lossless, filter_type, filter_sharpness,
   filter_strength, segments, exact */
int write_webp(const unsigned char *pixels, int w, int h, int nc,
               const float *o, unsigned char **out, size_t *size)
{
    WebPConfig c;
    WebPPicture p;
    WebPMemoryWriter wr;
    int ok;
    if (!WebPConfigInitInternal(&c, WEBP_PRESET_DEFAULT, o[0],
                                WEBP_ENCODER_ABI_VERSION)) return -1;
    c.method = (int)o[1];
    c.lossless = (int)o[2];
    c.filter_type = (int)o[3];
    c.filter_sharpness = (int)o[4];
    c.filter_strength = (int)o[5];
    c.segments = (int)o[6];
    c.exact = (int)o[7];
    if (!WebPValidateConfig(&c)) return -2;
    if (!WebPPictureInitInternal(&p, WEBP_ENCODER_ABI_VERSION)) return -3;
    p.width = w;
    p.height = h;
    p.use_argb = c.lossless;
    ok = nc == 4 ? WebPPictureImportRGBA(&p, pixels, w * 4)
                 : WebPPictureImportRGB(&p, pixels, w * 3);
    if (!ok) return -4;
    WebPMemoryWriterInit(&wr);
    p.writer = WebPMemoryWrite;
    p.custom_ptr = &wr;
    ok = WebPEncode(&c, &p);
    WebPPictureFree(&p);
    if (!ok) return -5;
    *out = wr.mem;
    *size = wr.size;
    return 0;
}
"""


@functools.cache
def _webp_writer() -> ctypes.CDLL:
    import PIL

    libs = Path(PIL.__file__).parent.parent / "pillow.libs"
    sharp = sorted(libs.glob("libsharpyuv-*.so*"))
    webp = sorted(libs.glob("libwebp-*.so*"))
    if not sharp or not webp:
        raise RuntimeError("Pillow's bundled libwebp was not found")
    ctypes.CDLL(str(sharp[0]), mode=ctypes.RTLD_GLOBAL)
    build = Path(tempfile.mkdtemp(prefix="webp_writer_"))
    (build / "writer.c").write_text(_WEBP_WRITER_SOURCE)
    subprocess.run(["cc", "-O1", "-shared", "-fPIC", "-o",
                    str(build / "writer.so"), str(build / "writer.c"),
                    str(webp[0]), str(sharp[0]), f"-Wl,-rpath,{libs}"],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(build / "writer.so"))
    lib.write_webp.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_size_t)]
    return lib


def libwebp_webp(pixels: np.ndarray, quality: float = 75, method: int = 4,
                 lossless: bool = False, filter_type: int = 1,
                 sharpness: int = 0, strength: int = 60,
                 segments: int = 4, exact: bool = False) -> bytes:
    """RGB [H, W, 3] or RGBA [H, W, 4] → a WebP file written by libwebp
    1.6 with these WebPConfig fields."""
    arr = np.ascontiguousarray(pixels, np.uint8)
    h, w, nc = arr.shape
    opts = np.array([quality, method, int(lossless), filter_type, sharpness,
                     strength, segments, int(exact)], np.float32)
    out = ctypes.POINTER(ctypes.c_ubyte)()
    size = ctypes.c_size_t()
    rc = _webp_writer().write_webp(arr.ctypes.data, w, h, nc,
                                   opts.ctypes.data, ctypes.byref(out),
                                   ctypes.byref(size))
    if rc:
        raise RuntimeError(f"libwebp refused the options (rc {rc})")
    return ctypes.string_at(out, size.value)


def encode_webp(rgb: np.ndarray, quality: int | None = None) -> bytes:
    """cv2's WebP: lossless without a quality, else lossy at it."""
    params = [] if quality is None else [cv2.IMWRITE_WEBP_QUALITY, quality]
    ok, buf = cv2.imencode(".webp", np.ascontiguousarray(rgb[..., ::-1]),
                           params)
    assert ok
    return buf.tobytes()


def webp_chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    """The (tag, payload) chunks of a RIFF/WEBP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def webp_chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload \
        + b"\0" * (len(payload) & 1)


def webp_file(chunks) -> bytes:
    body = b"WEBP" + b"".join(webp_chunk(t, p) for t, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x_chunk(flags: int, width: int, height: int) -> tuple[bytes, bytes]:
    return b"VP8X", bytes([flags, 0, 0, 0]) + (width - 1).to_bytes(
        3, "little") + (height - 1).to_bytes(3, "little")


def anmf_chunk(x: int, y: int, frame: bytes) -> tuple[bytes, bytes]:
    """An animation frame at even offset (x, y) holding the image chunks
    of the WebP file `frame`, 100 ms, no blending."""
    chunks = webp_chunks(frame)
    tag, img = chunks[-1]
    if tag == b"VP8L":
        bits = int.from_bytes(img[1:5], "little")
        w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    else:
        w = int.from_bytes(img[6:8], "little") & 0x3FFF
        h = int.from_bytes(img[8:10], "little") & 0x3FFF
    head = b"".join(v.to_bytes(3, "little") for v in (
        x // 2, y // 2, w - 1, h - 1, 100)) + b"\x02"
    return b"ANMF", head + b"".join(webp_chunk(t, p) for t, p in chunks
                                    if t in (b"ALPH", b"VP8 ", b"VP8L"))


class _BoolWriter:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def finish(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) << (8 * (c >> 3))
        for _ in range(4):
            self.out.append((v >> 24) & 255)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def repartition(vp8_frame: bytes, log2_parts: int) -> bytes:
    """A one-partition VP8 key frame re-coded with 2**log2_parts token
    partitions (macroblock row r in partition r mod the count): every
    boolean decision is recorded while the port's decoder reads the frame
    and written again by `_BoolWriter`. libwebp 1.6 writes one partition
    whatever its `partitions` option says; cv2's digest of the result
    checks the re-coding."""
    from multiposenet_tpu_torch.utils import vp8

    logs, row_ends, count_at = [], [], []

    class Recording(vp8._BoolReader):
        def __init__(self, *args):
            super().__init__(*args)
            self.log = []
            logs.append(self.log)

        def bit(self, prob):
            b = super().bit(prob)
            self.log.append((prob, b))
            return b

        def signed(self, v):
            r = super().signed(v)
            self.log.append((128, int(r < 0)))
            return r

        def value_bits(self, n):
            if self is logs_owner[0] and n == 2:
                count_at.append(len(self.log))
            return super().value_bits(n)

    logs_owner = []
    real_reader, real_reconstruct = vp8._BoolReader, vp8._reconstruct

    def reconstruct(h, mb, mb_x, mb_y, planes):
        if mb_x == (h.width + 15) // 16 - 1:
            row_ends.append(len(logs[1]))
        return real_reconstruct(h, mb, mb_x, mb_y, planes)

    def reader(*args):
        r = Recording(*args)
        if not logs_owner:
            logs_owner.append(r)
        return r

    vp8._BoolReader, vp8._reconstruct = reader, reconstruct
    try:
        vp8.decode_frame(vp8_frame)
    finally:
        vp8._BoolReader, vp8._reconstruct = real_reader, real_reconstruct
    assert len(logs) == 2, "the frame must have one token partition"
    part0, tokens = logs
    at = count_at[1]  # the first 2-bit value is colour space and clamping
    part0 = part0[:at] + [(128, (log2_parts >> 1) & 1),
                          (128, log2_parts & 1)] + part0[at + 2:]
    w0 = _BoolWriter()
    for prob, b in part0:
        w0.put(prob, b)
    first = w0.finish()
    n = 1 << log2_parts
    writers = [_BoolWriter() for _ in range(n)]
    start = 0
    for r, end in enumerate(row_ends):
        for prob, b in tokens[start:end]:
            writers[r % n].put(prob, b)
        start = end
    parts = [w.finish() for w in writers]
    tag = int.from_bytes(vp8_frame[:3], "little") & 0x1F
    tag |= len(first) << 5
    return (tag.to_bytes(3, "little") + vp8_frame[3:10] + first
            + b"".join(len(p).to_bytes(3, "little") for p in parts[:-1])
            + b"".join(parts))


def until_scan(jpeg: bytes, scans: int) -> bytes:
    """A progressive file ended (EOI) after its first `scans` scans."""
    starts = [i for i in range(len(jpeg) - 1)
              if jpeg[i] == 0xFF and jpeg[i + 1] == 0xDA]
    end = starts[scans] if scans < len(starts) else len(jpeg) - 2
    # Markers between the cut scan and the next SOS (DHT) stay out.
    return jpeg[:end] + b"\xff\xd9"


def texture(h: int, w: int, seed: int, noise: int = 24) -> np.ndarray:
    """Stripes, a checkerboard and uniform noise: detail at every
    frequency, float [h, w, 3] around 0."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = []
    for c in range(3):
        wave = 40 * np.sin(xx / (2.5 + c) + yy / (7.0 + 2 * c))
        check = 30 * (((yy // (4 + c)) + (xx // (5 + c))) % 2 - 0.5)
        planes.append(wave + check + rng.uniform(-noise, noise, (h, w)))
    return np.stack(planes, -1)


def textured_scene(image: np.ndarray, seed: int,
                   noise: int = 24) -> np.ndarray:
    h, w = image.shape[:2]
    return np.clip(image * 0.8 + 25 + 0.6 * texture(h, w, seed, noise), 0,
                   255).astype(np.uint8)


def encode_jpeg(rgb: np.ndarray, quality: int, sampling: str | None,
                extra=()) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, *extra]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    image = rgb[..., ::-1] if rgb.ndim == 3 else rgb
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(image), params)
    assert ok
    return buf.tobytes()


def exif_tiff(orientation: int, big_endian: bool) -> bytes:
    """A TIFF header and IFD0 holding only the orientation tag."""
    e = ">" if big_endian else "<"
    return ((b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))


def with_exif(jpeg: bytes, tiff: bytes) -> bytes:
    """`jpeg` with an APP1 Exif segment right after SOI."""
    payload = b"Exif\x00\x00" + tiff
    return (jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2)
            + payload + jpeg[2:])


def pil_jpeg(rgb: np.ndarray, mode: str, **options) -> bytes:
    """`rgb` converted to `mode` and written by PIL (libjpeg), q 90."""
    import io

    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(rgb).convert(mode).save(out, "JPEG",
                                            **{"quality": 90, **options})
    return out.getvalue()


def with_adobe_transform(jpeg: bytes, transform: int) -> bytes:
    """`jpeg` with the transform byte of its APP14 Adobe block replaced."""
    at = jpeg.index(b"Adobe") + 11
    return jpeg[:at] + bytes([transform]) + jpeg[at + 1:]


def cut_scan_data(jpeg: bytes, fraction: float) -> bytes:
    """`jpeg` cut `fraction` of the way from its first SOS to its end."""
    sos = jpeg.index(b"\xff\xda")
    return jpeg[:sos + int((len(jpeg) - sos) * fraction)]


def png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(samples: np.ndarray, colour: int, depth: int,
               interlace: bool = False, extra: bytes = b"") -> bytes:
    """A PNG of integer samples [H, W, C] (rows unfiltered), Adam7
    interlaced if asked."""
    h, w, ch = samples.shape

    def rows(block):
        out = b""
        for row in block.reshape(block.shape[0], -1):
            if depth == 16:
                data = row.astype(">u2").tobytes()
            elif depth == 8:
                data = row.astype(np.uint8).tobytes()
            else:
                bits = (row[:, None] >> np.arange(depth - 1, -1, -1)) & 1
                data = np.packbits(bits.astype(np.uint8).reshape(-1)) \
                    .tobytes()
            out += b"\x00" + data
        return out

    if interlace:
        raw = b""
        for y0, x0, dy, dx in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4),
                               (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
                               (1, 0, 2, 1)):
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += rows(sub)
    else:
        raw = rows(samples)
    return (b"\x89PNG\r\n\x1a\n"
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                             0, 0, int(interlace)))
            + extra + png_chunk(b"IDAT", zlib.compress(raw, 9))
            + png_chunk(b"IEND", b""))


def coco_annotations(records, names) -> dict:
    data = {"images": [], "annotations": [],
            "categories": [{"id": 1, "name": "person"}]}
    for i, (rec, name) in enumerate(zip(records, names)):
        h, w = rec["image"].shape[:2]
        data["images"].append({"id": i, "file_name": name, "height": h,
                               "width": w})
        for p in range(len(rec["boxes"])):
            y0, x0, y1, x1 = (float(v) for v in rec["boxes"][p])
            kps = np.asarray(rec["keypoints"][p], np.float64)
            data["annotations"].append({
                "id": len(data["annotations"]) + 1, "image_id": i,
                "category_id": 1, "iscrowd": 0,
                "bbox": [x0, y0, x1 - x0, y1 - y0],
                "area": float(rec["area"][p]),
                "keypoints": [round(float(v), 3) for v in kps.reshape(-1)],
                "num_keypoints": int((kps[:, 2] > 0).sum())})
    return data


def _outline(box, n: int, rng) -> list[float]:
    """An n-point ellipse-like polygon inside a (y0, x0, y1, x1) box, as
    flat COCO [x0, y0, x1, y1, ...] rounded to 2 decimals."""
    y0, x0, y1, x1 = box
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = 0.5 * (0.8 + 0.2 * rng.rand(n))
    xs = (x0 + x1) / 2 + r * (x1 - x0) * np.cos(t)
    ys = (y0 + y1) / 2 + r * (y1 - y0) * np.sin(t)
    return [round(float(v), 2) for v in np.stack([xs, ys], 1).reshape(-1)]


def _rle(poly_parts, h: int, w: int, compressed: bool) -> dict:
    from multiposenet_tpu_torch.data import masks

    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [np.round(np.asarray(p, np.float64).reshape(-1, 2))
                        .astype(np.int32) for p in poly_parts], 1)
    counts = masks.mask_to_rle_counts(mask.astype(bool))
    return {"size": [h, w], "counts": (masks.encode_rle_string(counts)
                                       if compressed else counts)}


def segmentation_annotations(records, names) -> dict:
    """`coco_annotations` with a `segmentation` on the persons and crowd
    regions added: person k of the fixture gets, by k % 5, overlapping
    multi-part polygons (body, head square and a part off the image, plus
    a dropped part of 4 numbers), uncompressed RLE, compressed RLE, one
    polygon, or no segmentation (the box fallback). Image 0 gains a
    crowd region in uncompressed RLE, image 1 one in compressed RLE, and
    image 2's first person loses its keypoints (unlabelled)."""
    data = coco_annotations(records, names)
    rng = np.random.RandomState(11)
    for k, ann in enumerate(data["annotations"]):
        im = data["images"][ann["image_id"]]
        h, w = im["height"], im["width"]
        x, y, bw, bh = ann["bbox"]
        box = (y, x, y + bh, x + bw)
        body = _outline(box, 14, rng)
        cx, top = x + bw / 2, y + 0.12 * bh
        s = 0.18 * bw
        head = [round(v, 2) for v in (cx - s, top - s, cx + s, top - s,
                                      cx + s, top + s, cx - s, top + s)]
        kind = k % 5
        if kind == 0:
            off = [round(v, 2) for v in (x - 20, y + bh / 2, x + 0.3 * bw,
                                         y + 0.4 * bh, x + 0.3 * bw,
                                         y + 0.7 * bh)]
            ann["segmentation"] = [body, head, off, [x, y, x + 1, y + 1]]
        elif kind in (1, 2):
            ann["segmentation"] = _rle([body, head], h, w, kind == 2)
        elif kind == 3:
            ann["segmentation"] = [body]
    for image_id, compressed in ((0, False), (1, True)):
        im = data["images"][image_id]
        h, w = im["height"], im["width"]
        crowd = [10.0, h - 60.0, 90.0, h - 70.0, 100.0, h - 10.0, 5.0,
                 h - 5.0]
        data["annotations"].append({
            "id": len(data["annotations"]) + 1, "image_id": image_id,
            "category_id": 1, "iscrowd": 1,
            "bbox": [5.0, h - 70.0, 95.0, 65.0], "area": 5000.0,
            "keypoints": [0] * 51, "num_keypoints": 0,
            "segmentation": _rle([crowd], h, w, compressed)})
    first = next(a for a in data["annotations"] if a["image_id"] == 2)
    first["keypoints"] = [0] * 51
    first["num_keypoints"] = 0
    return data


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def digest(path: Path) -> dict:
    rgb = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
    h, w = rgb.shape[:2]
    scale = LETTERBOX / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    box = cv2.resize(np.ascontiguousarray(rgb), (nw, nh),
                     interpolation=cv2.INTER_LINEAR)
    return {"shape": list(rgb.shape), "rgb_sha256": sha256(rgb),
            "letterbox_sha256": sha256(box)}


def webp_fixtures(tex: np.ndarray, big: np.ndarray) -> dict[str, bytes]:
    """The WebP fixtures (see the module docstring), from the 97x133
    texture and the 480x640 scene."""
    from multiposenet_tpu_torch.data.synthetic import make_dataset

    files = {}
    for q in (1, 50, 90, 100):
        files[f"webp_lossy_q{q}_97x133.webp"] = encode_webp(tex, q)
    for name, log2_parts, options in (
            ("simple_p4_s1_sharp7", 2, dict(
                quality=60, filter_type=0, sharpness=7, strength=70,
                segments=1)),
            ("normal_p8_sharp3", 3, dict(quality=30, sharpness=3,
                                         strength=90))):
        frame = webp_chunks(libwebp_webp(tex, **options))[-1][1]
        files[f"webp_lossy_{name}_97x133.webp"] = webp_file(
            [(b"VP8 ", repartition(frame, log2_parts))])
    rng = np.random.RandomState(17)
    alpha = rng.randint(0, 256, (48, 64, 1)).astype(np.uint8)
    files["webp_lossy_alpha_48x64.webp"] = libwebp_webp(
        np.concatenate([tex[:48, :64], alpha], -1), quality=70)
    files["webp_lossless_cv2_97x133.webp"] = encode_webp(tex)
    scene = make_dataset(1, img_h=97, img_w=133, seed=3)[0]["image"]
    files["webp_lossless_m0_97x133.webp"] = libwebp_webp(
        tex, quality=100, method=0, lossless=True)
    files["webp_lossless_m6_cache_meta_97x133.webp"] = libwebp_webp(
        scene, quality=100, method=6, lossless=True)
    for n, (h, w) in ((2, (45, 50)), (3, (33, 47)), (12, (61, 83))):
        palette = rng.randint(0, 256, (n, 3)).astype(np.uint8)
        idx = (np.add.outer(np.arange(h) // 3, np.arange(w) // 4)
               + rng.randint(0, 2, (h, w))) % n
        files[f"webp_lossless_palette{n}_{h}x{w}.webp"] = libwebp_webp(
            palette[idx], quality=100, lossless=True)
    for h, w in ((1, 1), (3, 5), (17, 33)):
        files[f"webp_lossy_{h}x{w}.webp"] = encode_webp(tex[:h, :w], 75)
        files[f"webp_lossless_{h}x{w}.webp"] = encode_webp(tex[:h, :w])
    # Exif orientation 6 in a VP8X file, after the image.
    lossy = encode_webp(tex[:37, :53], 80)
    files["webp_exif6_37x53.webp"] = webp_file(
        [vp8x_chunk(0x08, 53, 37)] + webp_chunks(lossy)
        + [(b"EXIF", exif_tiff(6, False))])
    # An animation: the first frame at (4, 6) on a 40x56 canvas, then one
    # that covers it.
    first = encode_webp(tex[:20, :30])
    second = encode_webp(tex[40:70, 50:106], 60)
    files["webp_anim_offset_30x56.webp"] = webp_file(
        [vp8x_chunk(0x02, 56, 30),
         (b"ANIM", struct.pack("<IH", 0xFF204080, 0)),
         anmf_chunk(4, 6, first), anmf_chunk(0, 0, second)])
    # The timing fixtures.
    photo = textured_scene(big, seed=5, noise=6)
    files["webp_photo_480x640_q90.webp"] = encode_webp(photo, 90)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    waves = np.stack([30 * np.sin(xx / (4 + c) + yy / (8 + 2 * c))
                      + 20 * (((yy // (4 + c)) + (xx // (5 + c))) % 2 - 0.5)
                      for c in range(3)], -1)
    files["webp_scene_480x640_lossless.webp"] = encode_webp(
        np.clip(big * 0.8 + 25 + waves, 0, 255).astype(np.uint8))
    return files


def jpeg2000_fixtures() -> dict[str, bytes]:
    """The two JPEG 2000 fixtures (Pillow's writer, OpenJPEG 2.5.4): a
    reversible gray JP2 and an irreversible RGB codestream of three
    quality layers in RPCL order, both of smooth ramps (small)."""
    from PIL import Image

    def ramps(h: int, w: int, channels: int) -> np.ndarray:
        y, x = np.mgrid[0:h, 0:w]
        planes = [x * 255 // (w - 1), y * 255 // (h - 1),
                  (x + y) * 255 // (w + h - 2)]
        return np.stack(planes[:channels], -1).astype(np.uint8).squeeze()

    def pil(pixels: np.ndarray, **options) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, "JPEG2000", **options)
        return buf.getvalue()

    return {"j2k_rev_gray_37x53.jp2": pil(ramps(37, 53, 1)),
            "j2k_irr_rpcl_layers3_37x53.j2k": pil(
                ramps(37, 53, 3), irreversible=True, progression="RPCL",
                quality_mode="rates", quality_layers=[80, 40, 20],
                no_jp2=True)}


def avif_fixtures() -> dict[str, bytes]:
    """The AVIF fixtures, each written by cv2.imencode(".avif") at its
    default quality and speed or at those its name gives (see the module
    docstring)."""
    from avif_reference import drawing as shapes
    from avif_reference import widen

    photo = cv2.imread(str(OUT / "photo_480x640_q95_420.jpg"))
    # Lines 2 pixels wide on a flat background, a drawing libaom codes
    # with TX_MODE_SELECT at cv2's default quality.
    rng = np.random.default_rng(5)
    h, w = (int(v) for v in rng.integers(40, 100, 2))
    drawing = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    for _ in range(int(rng.integers(1, 8))):
        colour = tuple(int(c) for c in rng.integers(0, 256, 3))
        p1 = tuple(int(v) for v in (rng.integers(0, w), rng.integers(0, h)))
        p2 = tuple(int(v) for v in (rng.integers(0, w), rng.integers(0, h)))
        cv2.line(drawing, p1, p2, colour, 2)
    rng = np.random.default_rng(24)
    bgra = np.dstack([photo[200:224, 300:332],
                      rng.integers(0, 256, (24, 32), dtype=np.uint8)])
    images = {
        "avif_noise_64x80.avif": rng.integers(0, 256, (64, 80, 3),
                                              dtype=np.uint8),
        "avif_gray_40x56.avif": cv2.cvtColor(photo[100:140, 200:256],
                                             cv2.COLOR_BGR2GRAY),
        "avif_odd_33x17.avif": photo[300:333, 400:417],
        "avif_drawing_txsel_80x88.avif": drawing,
        "avif_alpha_24x32.avif": bgra,
        "avif_photo_480x640.avif": photo,
        "avif_lossless_q100_128x160.avif": photo[:128, :160],
        "avif_photo_speed2_480x640.avif": photo,
        "avif_palette_speed6_64x96.avif": shapes(64, 96, 7),
        "avif_intrabc_speed6_200x300.avif": shapes(200, 300, 0),
        "avif_10bit_96x128.avif": widen(
            np.ascontiguousarray(photo[192:288, 256:384]), 10, 10),
        "avif_12bit_64x80.avif": widen(
            np.ascontiguousarray(photo[192:256, 256:336]), 12, 12)}
    params = {"avif_lossless_q100_128x160.avif": [cv2.IMWRITE_AVIF_QUALITY,
                                                  100],
              "avif_photo_speed2_480x640.avif": [cv2.IMWRITE_AVIF_SPEED, 2],
              "avif_palette_speed6_64x96.avif": [cv2.IMWRITE_AVIF_SPEED, 6],
              "avif_intrabc_speed6_200x300.avif": [cv2.IMWRITE_AVIF_SPEED,
                                                   6],
              "avif_10bit_96x128.avif": [cv2.IMWRITE_AVIF_DEPTH, 10],
              "avif_12bit_64x80.avif": [cv2.IMWRITE_AVIF_DEPTH, 12]}
    files = {name: cv2.imencode(".avif", img, params.get(name, []))[1]
             .tobytes() for name, img in images.items()}
    files.update(other_avif_fixtures(photo[:, :, ::-1]))
    files.update(container_avif_fixtures(photo[:, :, ::-1]))
    files.update(grain_avif_fixtures(photo[:, :, ::-1]))
    return files


def grain_avif_fixtures(photo: np.ndarray) -> dict[str, bytes]:
    """The film grain and segmentation fixtures, from crops of the photo
    (RGB) by the wheel's libavif encoder with libaom's options: an 8-bit
    4:2:0 still with `film-grain-test` 1, a 10-bit 4:4:4 still with
    `film-grain-test` 15 (chroma scaled from luma) and a 2-frame
    `aq-mode=1` sequence whose first frame is segmented."""
    sys.path.insert(0, str(ROOT))
    from avif_reference import (YUV420, YUV444, avif_encode, avif_sequence,
                                planes_of, widen)

    crop = np.ascontiguousarray(photo[240:336, 160:288])
    small = np.ascontiguousarray(photo[64:128, 400:480])
    frames = [planes_of(np.ascontiguousarray(photo[y:y + 48, 96:160]), 8,
                        YUV420) for y in (300, 304)]
    return {
        "avif_grain_96x128.avif": avif_encode(
            planes_of(crop, 8, YUV420), 8, YUV420, quality=20, speed=6,
            film_grain_test=1),
        "avif_grain_csfl_10bit_444_64x80.avif": avif_encode(
            planes_of(widen(small, 10), 10, YUV444), 10, YUV444, quality=20,
            speed=6, film_grain_test=15),
        "avif_aq_sequence2_48x64.avif": avif_sequence(
            frames, 8, YUV420, quality=30, speed=6, aq_mode=1)}


def container_avif_fixtures(photo: np.ndarray) -> dict[str, bytes]:
    """The grid (with its Exif item) and the sequence fixtures, from crops
    of the photo (RGB)."""
    sys.path.insert(0, str(ROOT))  # avif_reference's surgery uses the port
    from avif_reference import grid_from_rgb, pillow_avis, tiff_orientation

    grid = grid_from_rgb(np.ascontiguousarray(photo[160:288, 300:396]), 2, 2,
                         64, 64, exif=tiff_orientation(6), quality=35,
                         speed=6)
    frames = [np.ascontiguousarray(photo[y:y + 48, x:x + 64])
              for y, x in ((200, 200), (210, 206), (220, 212))]
    return {"avif_grid2x2_exif6_128x96.avif": grid,
            "avif_sequence3_48x64.avif": pillow_avis(frames, quality=40,
                                                     speed=6)}


def write_avif_fixture_files(files: dict[str, bytes]) -> None:
    """AVIF fixtures and their digests, into the committed digests."""
    digests = json.loads((OUT / "digests.json").read_text())
    for name, data in files.items():
        (OUT / name).write_bytes(data)
        digests[name] = digest(OUT / name)
        bgr = cv2.imread(str(OUT / name))
        digests[name]["imencode_webp_bytes"] = len(cv2.imencode(".webp",
                                                                bgr)[1])
        digests[name]["imencode_gif_sha256"] = hashlib.sha256(
            cv2.imencode(".gif", bgr)[1].tobytes()).hexdigest()
        digests[name]["imencode_jp2_sha256"] = jp2_sha(bgr)
    write_digests(digests)


def other_avif_fixtures(photo: np.ndarray) -> dict[str, bytes]:
    """The AVIF fixtures cv2 does not write, from crops of the photo (RGB)
    by the wheel's libavif encoder (`avif_reference.avif_encode`): name:
    (crop, depth, avifPixelFormat, matrix coefficients, full range,
    encoder settings)."""
    from avif_reference import YUV420, YUV422, YUV444, avif_encode, planes_of

    recipes = {
        "avif_444_lossy_96x128.avif": (
            photo[40:136, 300:428], 8, YUV444, 6, 1, dict(quality=50)),
        "avif_422_cdef_96x128.avif": (
            photo[200:296, 100:228], 8, YUV422, 6, 1,
            dict(quality=30, enable_cdef=1)),
        "avif_422_10bit_64x80.avif": (
            photo[320:384, 480:560], 10, YUV422, 6, 1, dict(quality=40)),
        "avif_bt709_limited_96x128.avif": (
            photo[192:288, 256:384], 8, YUV420, 1, 0, dict(quality=60))}
    return {name: avif_encode(
        planes_of(np.ascontiguousarray(crop), depth, fmt, matrix, full),
        depth, fmt, speed=6, matrix=matrix, full_range=full, primaries=1,
        transfer=1 if matrix == 1 else 13, **settings)
        for name, (crop, depth, fmt, matrix, full, settings)
        in recipes.items()}


def write_avif_fixtures() -> None:
    """Only the AVIF fixtures and their digests, into the committed
    digests."""
    write_avif_fixture_files(avif_fixtures())


def jpeg2000_recipes(data: bytes) -> list[dict]:
    """A JPEG 2000 fixture's `corrupt` recipes: two single bytes of its
    packet data that cv2 reads and one it refuses, and cuts in the middle
    of the data and before the final EOC (refused)."""
    sod = data.rindex(b"\xff\x93") + 2
    recipes = pick_recipes(data, [(sod, len(data) - 2)], 0, 1, 2, 1)
    for cut in ((sod + len(data)) // 2, len(data) - 2):
        at = f"{cut}/"
        recipes.append({"at": at, "rgb_sha256": cv2_sha(
            image_samples.corrupted(data, at))})
    return recipes


def write_jpeg2000_fixtures() -> None:
    """Only the JPEG 2000 fixtures and their digests and recipes, into
    the committed digests."""
    global image_samples
    sys.path.insert(0, str(ROOT))
    from multiposenet_tpu_torch.tools import image_samples

    digests = json.loads((OUT / "digests.json").read_text())
    for name, data in jpeg2000_fixtures().items():
        (OUT / name).write_bytes(data)
        digests[name] = digest(OUT / name)
        bgr = cv2.imread(str(OUT / name))
        digests[name]["imencode_webp_bytes"] = len(cv2.imencode(".webp",
                                                                bgr)[1])
        digests[name]["imencode_gif_sha256"] = hashlib.sha256(
            cv2.imencode(".gif", bgr)[1].tobytes()).hexdigest()
        digests[name]["imencode_jp2_sha256"] = jp2_sha(bgr)
        digests[name]["corrupt"] = jpeg2000_recipes(data)
    write_digests(digests)


def jpeg_abbreviate(stream: bytes) -> tuple[bytes, bytes]:
    """A JPEG split as libtiff writes JPEG strips: (the tables-only
    stream SOI DQT DHT EOI, the stream without its DQT and DHT)."""
    tables, rest, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while stream[pos + 1] != 0xDA:
        marker = stream[pos + 1]
        length = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        segment = stream[pos:pos + 2 + length]
        (tables if marker in (0xDB, 0xC4) else rest).extend(segment)
        pos += 2 + length
    return bytes(tables + b"\xff\xd9"), bytes(rest + stream[pos:])


def pil_tiff(img, mode: str, **options) -> bytes:
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(img).convert(mode).save(b, "TIFF", **options)
    return b.getvalue()


def fax_page() -> np.ndarray:
    """A 2292x1728 page of text-like lines: rows of word-sized black
    blocks on white, with a frame and a rule."""
    rng = np.random.RandomState(29)
    page = np.zeros((2292, 1728), bool)
    page[80:84, 120:1608] = page[2200:2204, 120:1608] = True
    page[80:2204, 120:124] = page[80:2204, 1604:1608] = True
    for top in range(160, 2120, 72):
        x = 180
        while x < 1500:
            w = int(rng.randint(40, 200))
            page[top:top + 14, x:min(x + w, 1540)] = True
            x += w + int(rng.randint(14, 30))
    page[1100:1110, 300:1400] = True
    return page


def tiff_hdr_fixtures(tex: np.ndarray) -> dict[str, bytes]:
    """The TIFF and Radiance HDR fixtures (see the module docstring)."""
    sys.path.insert(0, str(ROOT))
    from multiposenet_tpu_torch.tools import image_samples as samples
    from multiposenet_tpu_torch.utils import tiff

    files = {}
    t = samples.tiff_bytes
    small = np.ascontiguousarray(tex[:37, :53])
    # JPEG-compressed: 4:2:0 strips of 16 rows sharing JPEGTables.
    strips = [pil_jpeg(small[y:y + 16], "RGB", quality=85, subsampling=2)
              for y in range(0, 37, 16)]
    tables = jpeg_abbreviate(strips[0])[0]
    files["tiff_jpeg_ycc420_tables_37x53.tif"] = t(
        small, 6, compression=7, rows_per_strip=16,
        chunks=[jpeg_abbreviate(s)[1] for s in strips],
        tags=((530, 3, [2, 2]), (347, 7, tables)))
    tiles = []
    for ty in range(0, 37, 16):
        for tx in range(0, 53, 32):
            blk = np.zeros((16, 32, 3), np.uint8)
            part = small[ty:ty + 16, tx:tx + 32]
            blk[:part.shape[0], :part.shape[1]] = part
            tiles.append(pil_jpeg(blk, "RGB", quality=75, subsampling=1))
    files["tiff_jpeg_ycc422_tiles_37x53.tif"] = t(
        small, 6, compression=7, tile=(16, 32), chunks=tiles,
        tags=((530, 3, [2, 1]),))
    odd = np.ascontiguousarray(tex[40:61, 60:79])
    full = np.concatenate([odd, odd[::-1][:11]])
    files["tiff_jpeg_ycc420_last_strip_full_21x19.tif"] = t(
        odd, 6, compression=7, rows_per_strip=16,
        chunks=[pil_jpeg(full[y:y + 16], "RGB", quality=90, subsampling=2)
                for y in (0, 16)], tags=((530, 3, [2, 2]),))
    piece = np.ascontiguousarray(tex[50:66, 70:94])
    for mode in ("RGB", "L", "CMYK", "YCbCr"):
        files[f"tiff_jpeg_pil_{mode.lower()}_16x24.tif"] = pil_tiff(
            piece, mode, compression="jpeg")
    files["tiff_jpeg_cv2_rgb_16x24.tif"] = cv2.imencode(
        ".tif", piece[..., ::-1], [cv2.IMWRITE_TIFF_COMPRESSION, 7])[1] \
        .tobytes()
    files["tiff_jpeg_cv2_gray_16x24.tif"] = cv2.imencode(
        ".tif", piece[..., 1], [cv2.IMWRITE_TIFF_COMPRESSION, 7])[1] \
        .tobytes()
    # CCITT, on thresholded texture with blocks.
    bits = (tex[:45, :71, 0] > 128)
    bits[10:20, 5:40] = True
    for fill in (1, 2):
        for name, comp, info in (("rle", "tiff_ccitt", {}),
                                 ("g3_1d", "group3", {}),
                                 ("g3_2d", "group3", {292: 1}),
                                 ("g4", "group4", {})):
            info = {**info, 278: 16, 266: fill,
                    262: 0 if fill == 1 else 1}
            files[f"tiff_{name}_fill{fill}_45x71.tif"] = pil_tiff(
                bits, "1", compression=comp, tiffinfo=info)
    files["tiff_g4_page_2292x1728.tif"] = pil_tiff(
        fax_page(), "1", compression="group4", tiffinfo={262: 0})
    # CMYK, YCbCr and CIELab.
    cmyk = np.concatenate([255 - piece, (255 - piece).min(-1,
                                                          keepdims=True)],
                          -1)
    files["tiff_cmyk_lzw_planar_16x24.tif"] = t(cmyk, 5, compression=5,
                                                planar=2, rows_per_strip=8)
    files["tiff_cmyk_pil_16x24.tif"] = pil_tiff(piece, "CMYK")
    rng = np.random.RandomState(31)
    ycc = np.ascontiguousarray(tex[20:43, 30:67])
    for (hs, vs), (h, w), tile in (((2, 2), (23, 37), None),
                                   ((4, 2), (17, 30), None),
                                   ((4, 4), (21, 40), (16, 32))):
        img = ycc[:h, :w]
        if tile is None:
            chunks = [tiff.lzw_encode_plain(samples.ycbcr_units(
                img[y:y + 8], hs, vs).tobytes()) for y in range(0, h, 8)]
            kw = dict(rows_per_strip=8)
        else:
            chunks = []
            for ty in range(0, h, tile[0]):
                for tx in range(0, w, tile[1]):
                    blk = np.zeros(tile + (3,), np.uint8)
                    part = img[ty:ty + tile[0], tx:tx + tile[1]]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(tiff.lzw_encode_plain(
                        samples.ycbcr_units(blk, hs, vs).tobytes()))
            kw = dict(tile=tile)
        files[f"tiff_ycbcr{hs}{vs}_lzw_{h}x{w}.tif"] = t(
            img, 6, compression=5, chunks=chunks,
            tags=((530, 3, [hs, vs]), (532, 5, [16, 1, 235, 1, 128, 1, 240,
                                                1, 128, 1, 240, 1])), **kw)
    files["tiff_ycbcr_pil_16x24.tif"] = pil_tiff(piece, "YCbCr")
    files["tiff_cielab_pil_16x24.tif"] = pil_tiff(piece, "LAB")
    lab16 = rng.randint(0, 65536, (17, 23, 3)).astype(np.uint16)
    lab16[..., 0] = np.linspace(0, 65535, 23).astype(np.uint16)
    files["tiff_cielab16_d65_17x23.tif"] = t(
        lab16, 8, bps=16, compression=8,
        tags=((318, 5, [3127, 10000, 3290, 10000]),))
    # Radiance HDR.
    files["hdr_rle_17x23.hdr"] = cv2.imencode(
        ".hdr", np.ascontiguousarray(tex[:17, :23, ::-1]))[1].tobytes()
    files["hdr_flat_5x7.pic"] = cv2.imencode(
        ".pic", np.ascontiguousarray(tex[30:35, 40:47, ::-1]))[1].tobytes()
    body = cv2.imencode(".hdr", np.ascontiguousarray(
        tex[60:69, 90:102, ::-1]))[1].tobytes().split(b"+X 12\n", 1)[1]
    files["hdr_rgbe_exposure_9x12.hdr"] = (
        b"#?RGBE\n# written for the tests\nEXPOSURE=2.5\n"
        b"FORMAT=32-bit_rle_rgbe\nGAMMA=2.2\n\n-Y 9 +X 12\n" + body)
    head, rle = cv2.imencode(".hdr", np.ascontiguousarray(
        tex[70:76, 10:20, ::-1]))[1].tobytes().split(b"+X 10\n", 1)
    first = rle[:4 + rle[4:].index(b"\x02\x02\x00\x0a")]
    pixels = rng.randint(0, 256, (5 * 10, 4)).astype(np.uint8)
    pixels[:, 0] |= 0x80
    pixels[:, 3] = rng.randint(120, 136, 50)
    files["hdr_then_flat_6x10.hdr"] = (head + b"+X 10\n" + first
                                       + pixels.tobytes())
    return files


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from multiposenet_tpu_torch.data.synthetic import make_dataset

    OUT.mkdir(parents=True, exist_ok=True)
    for old in OUT.iterdir():
        old.unlink()
    files: dict[str, bytes] = {}

    # Scenes with persons, for eval.
    kinds = [("420", 75), ("422", 95), ("444", 50), ("440", 95),
             ("411", 75), ("420", 95), (None, 95), ("420", 50),
             ("444", 75), ("422", 75)]
    records = make_dataset(len(kinds), img_h=192, img_w=256, seed=21)
    names = []
    for i, (rec, (sampling, q)) in enumerate(zip(records, kinds)):
        rgb = textured_scene(rec["image"], seed=100 + i)
        if sampling is None:
            rgb = rgb[..., 1]
        name = f"scene_{i:02d}_{sampling or 'gray'}_q{q}.jpg"
        files[name] = encode_jpeg(rgb, q, sampling)
        names.append(name)

    # The timing fixture.
    big = make_dataset(1, img_h=480, img_w=640, seed=7)[0]["image"]
    files["photo_480x640_q95_420.jpg"] = encode_jpeg(
        textured_scene(big, seed=5, noise=6), 95, "420")

    # Coverage of the decoder's modes.
    rng = np.random.RandomState(3)
    noise = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    tex = textured_scene(np.full((97, 133, 3), 128, np.uint8), seed=9)
    files["kind_noise_37x53_444_q100.jpg"] = encode_jpeg(noise, 100, "444")
    files["kind_noise_37x53_420_q95.jpg"] = encode_jpeg(noise, 95, "420")
    files["kind_tex_97x133_422_q50.jpg"] = encode_jpeg(tex, 50, "422")
    files["kind_tex_97x133_440_q75.jpg"] = encode_jpeg(tex, 75, "440")
    files["kind_tex_97x133_411_q95.jpg"] = encode_jpeg(tex, 95, "411")
    files["kind_tex_97x133_gray_q100.jpg"] = encode_jpeg(tex[..., 0], 100,
                                                         None)
    files["kind_tex_97x133_420_q75_optimize.jpg"] = encode_jpeg(
        tex, 75, "420", (cv2.IMWRITE_JPEG_OPTIMIZE, 1))
    files["kind_tex_97x133_420_q95_rst3.jpg"] = encode_jpeg(
        tex, 95, "420", (cv2.IMWRITE_JPEG_RST_INTERVAL, 3))
    files["kind_tex_3x3_420_q95.jpg"] = encode_jpeg(tex[:3, :3], 95, "420")
    files["kind_tex_4x4_422_q50.jpg"] = encode_jpeg(tex[:4, :4], 50, "422")
    base = encode_jpeg(tex[:40, :64], 95, "420")
    files["kind_orient3_le_40x64.jpg"] = with_exif(base, exif_tiff(3, False))
    files["kind_orient6_be_40x64.jpg"] = with_exif(base, exif_tiff(6, True))

    # Past baseline (ROADMAP C3).
    small = np.ascontiguousarray(tex[:48, :64])
    progressive = (cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    files["c3_progressive_48x64_420_q95_rst2.jpg"] = encode_jpeg(
        small, 95, "420", progressive + (cv2.IMWRITE_JPEG_RST_INTERVAL, 2))
    files["c3_progressive_48x64_gray_q50.jpg"] = encode_jpeg(
        small[..., 1], 50, None, progressive)
    files["c3_adobe_rgb_48x64.jpg"] = pil_jpeg(small, "RGB", keep_rgb=True,
                                               subsampling=0)
    cmyk = pil_jpeg(small, "CMYK")
    files["c3_cmyk_48x64.jpg"] = cmyk
    files["c3_ycck_48x64.jpg"] = with_adobe_transform(cmyk, 2)
    files["c3_truncated_48x64_420.jpg"] = cut_scan_data(
        encode_jpeg(small, 95, "420"), 0.6)
    files["c3_truncated_progressive_48x64_444.jpg"] = cut_scan_data(
        encode_jpeg(small, 95, "444", progressive), 0.97)

    # The rest of C3: the modes libjpeg-turbo 3.1 reads under cv2 5.0 and
    # only its own writer makes (see libjpeg_jpeg).
    tiny = np.ascontiguousarray(tex[:32, :32])
    files["c3_arith_32x32_420.jpg"] = libjpeg_jpeg(tiny, arith=True)
    files["c3_arith_progressive_32x32_444_rst.jpg"] = libjpeg_jpeg(
        tiny, arith=True, progressive=True, sampling=0x11, restart_rows=1,
        conditioning=True)
    files["c3_lossless_p1_24x24.jpg"] = libjpeg_jpeg(
        tiny[:24, :24], predictor=1, sampling=0x11)
    files["c3_lossless_p7_pt2_24x24_420.jpg"] = libjpeg_jpeg(
        tiny[:24, :24], predictor=7, point_transform=2)
    cmyk_samples = np.concatenate([tiny[:16, :16], tiny[:16, :16, :1]], -1)
    files["c3_lossless_cmyk_p4_16x16.jpg"] = libjpeg_jpeg(
        cmyk_samples, predictor=4, sampling=0x11)
    smooth = libjpeg_jpeg(np.ascontiguousarray(tex[:40, :48]), quality=75,
                          progressive=True)
    files["c3_smooth_dc_40x48_420.jpg"] = until_scan(smooth, 1)
    files["c3_smooth_ac1_40x48_420.jpg"] = until_scan(smooth, 2)

    # PNG kinds.
    palette = rng.randint(0, 256, (16, 3)).astype(np.uint8)
    idx = rng.randint(0, 16, (29, 41, 1))
    files["png_palette4.png"] = encode_png(
        idx, 3, 4, extra=png_chunk(b"PLTE", palette.tobytes())
        + png_chunk(b"tRNS", bytes(range(0, 256, 16))))
    files["png_rgb16.png"] = encode_png(
        rng.randint(0, 65536, (23, 31, 3)), 2, 16)
    files["png_interlaced.png"] = encode_png(
        tex[:27, :35].astype(np.int64), 2, 8, interlace=True)

    files.update(webp_fixtures(tex, big))
    files.update(tiff_hdr_fixtures(tex))
    files.update(jpeg2000_fixtures())

    for name, data in files.items():
        (OUT / name).write_bytes(data)
    # The AVIF fixtures crop the photo, so they are made after it is
    # written.
    files.update(avif_fixtures())
    for name, data in files.items():
        (OUT / name).write_bytes(data)
    digests = {name: digest(OUT / name) for name in sorted(files)}
    # What cv2.imencode(".jpg") writes for the timing photo's pixels, and
    # for every file the size of cv2's lossless .webp of its pixels and
    # the sha256 of its .gif and its .jp2.
    photo = cv2.imread(str(OUT / "photo_480x640_q95_420.jpg"))
    digests["photo_480x640_q95_420.jpg"]["imencode_sha256"] = hashlib.sha256(
        cv2.imencode(".jpg", photo)[1].tobytes()).hexdigest()
    for name in digests:
        digests[name]["imencode_webp_bytes"] = len(cv2.imencode(
            ".webp", cv2.imread(str(OUT / name)))[1])
        digests[name]["imencode_gif_sha256"] = hashlib.sha256(cv2.imencode(
            ".gif", cv2.imread(str(OUT / name)))[1].tobytes()).hexdigest()
        digests[name]["imencode_jp2_sha256"] = jp2_sha(
            cv2.imread(str(OUT / name)))
        if name.startswith(("tiff_", "hdr_", "photo_")):
            digests[name]["imencode_hdr_sha256"] = hashlib.sha256(
                cv2.imencode(".hdr", cv2.imread(str(OUT / name)))[1]
                .tobytes()).hexdigest()
    # What cv2 reads from the 480x640 files the smoke script times.
    from multiposenet_tpu_torch.tools.image_samples import timing_tiffs

    photo_rgb = np.ascontiguousarray(photo[..., ::-1])
    timed = timing_tiffs((OUT / "photo_480x640_q95_420.jpg").read_bytes(),
                         photo_rgb)
    timed["hdr"] = cv2.imencode(".hdr", photo)[1].tobytes()
    digests["photo_480x640_q95_420.jpg"]["timing_sha256"] = {
        kind: sha256(cv2.imdecode(np.frombuffer(data, np.uint8),
                                  cv2.IMREAD_COLOR)[..., ::-1])
        for kind, data in sorted(timed.items())}
    corruption_recipes(digests)
    write_digests(digests)
    (OUT / "annotations.json").write_text(
        json.dumps(coco_annotations(records, names)) + "\n")
    (OUT / "annotations_segs.json").write_text(json.dumps(
        segmentation_annotations(records, names), separators=(",", ":"))
        + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(files)} images, {total} bytes in {OUT}")


# The modes of the JPEG recipes (the corpus of
# tests/test_torch_image_corrupt.py), the TIFF files and the photo.
CORRUPT_JPEG = (
    "kind_noise_37x53_420_q95.jpg", "kind_tex_97x133_420_q95_rst3.jpg",
    "c3_progressive_48x64_420_q95_rst2.jpg",
    "c3_progressive_48x64_gray_q50.jpg", "c3_lossless_p1_24x24.jpg",
    "scene_02_444_q50.jpg", "c3_arith_progressive_32x32_444_rst.jpg",
    "c3_arith_32x32_420.jpg")
CORRUPT_TIFF = (
    "tiff_cmyk_lzw_planar_16x24.tif", "tiff_ycbcr22_lzw_23x37.tif",
    "tiff_cielab16_d65_17x23.tif", "tiff_jpeg_pil_ycbcr_16x24.tif",
    "tiff_jpeg_ycc420_tables_37x53.tif")
# The files of the stray-byte and the sampling-factor recipe sets.
STRAY_JPEG = ("kind_orient3_le_40x64.jpg", "kind_orient6_be_40x64.jpg")
SAMPLING_JPEG = ("c3_smooth_ac1_40x48_420.jpg", "c3_smooth_dc_40x48_420.jpg")


def imread_rgb(path: Path) -> np.ndarray | None:
    """cv2.imread's RGB decode of the file, or None (the reference of
    `multiposenet_tpu_torch/tools/jpeg_cut_search.py`)."""
    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[..., ::-1]


def imdecode_rgb(data: bytes) -> np.ndarray | None:
    """cv2.imdecode's RGB decode of the bytes, or None."""
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[..., ::-1]


def imencode(suffix: str, rgb: np.ndarray) -> bytes:
    """The bytes cv2.imencode writes for uint8 RGB pixels (the reference
    of `multiposenet_tpu_torch/tools/jpeg2000_cut_search.py` takes cv2's
    own JPEG 2000 file from here)."""
    return cv2.imencode(suffix, np.ascontiguousarray(rgb[..., ::-1]))[1] \
        .tobytes()


def cv2_rgb(data: bytes) -> np.ndarray | None:
    """cv2.imdecode's RGB decode of `data`, or None where it returns no
    image; cv2.imread of the bytes in a file must agree."""
    rgb = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    path = OUT.parent / "_corrupt_probe"
    path.write_bytes(data)
    try:
        again = cv2.imread(str(path), cv2.IMREAD_COLOR)
    finally:
        path.unlink()
    assert (rgb is None) == (again is None) and (
        rgb is None or np.array_equal(rgb, again))
    return None if rgb is None else rgb[..., ::-1]


def cv2_sha(data: bytes) -> str | None:
    """sha256 of `cv2_rgb(data)`, or None."""
    rgb = cv2_rgb(data)
    return None if rgb is None else sha256(rgb)


def pick_recipes(data: bytes, spans: list[tuple[int, int]], seed: int,
                 nbytes: int, reads: int, refusals: int) -> list[dict]:
    """Seeded changes of `nbytes` bytes each (0xFF written as 0xFE) inside
    `spans` of `data`: the first `reads` that cv2 decodes to other pixels
    than the file's, and the first `refusals` it returns no image for."""
    rs = np.random.RandomState(seed)
    clean = cv2_sha(data)
    out, got = [], {True: 0, False: 0}
    for _ in range(2000):
        if got[True] >= reads and got[False] >= refusals:
            break
        changes = []
        for _ in range(nbytes):
            a, b = spans[rs.randint(len(spans))]
            value = rs.randint(0, 256)
            changes.append((rs.randint(a, b), 0xFE if value == 0xFF
                            else value))
        at = " ".join(f"{o}:{v}" for o, v in changes)
        want = cv2_sha(image_samples.corrupted(data, at))
        if want == clean:
            continue
        key = want is not None
        if got[key] < (reads if key else refusals):
            got[key] += 1
            out.append({"at": at, "rgb_sha256": want})
    return out


def scan_spans(data: bytes) -> list[tuple[int, int]]:
    """Every JPEG stream's entropy-coded data in `data` (a JPEG, or a
    TIFF's JPEG strips): from after each SOS to the next EOI."""
    spans, i = [], 0
    while (i := data.find(b"\xff\xda", i)) >= 0:
        start = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
        end = data.find(b"\xff\xd9", start)
        spans.append((start, end if end > 0 else len(data) - 2))
        i = start
    return spans


def corruption_recipes(digests: dict) -> None:
    """The `corrupt` recipes of the digests (see the module docstring):
    two bytes of the scan data of each mode's JPEG (two reads and a
    refusal), the restart markers of the interval files moved, one byte
    of the TIFF strips (LZW, deflate and JPEG ones), one byte of the
    photo GIF's LZW data, and two bytes of the photo's scan (read by
    cv2: the smoke script times its decode and predicts on it); the
    digests of the stray-byte and sampling-factor sets, and the photo's
    `exif_stray` recipe (the smoke script predicts on it)."""
    global image_samples
    sys.path.insert(0, str(ROOT))
    from multiposenet_tpu_torch.tools import image_samples
    from multiposenet_tpu_torch.utils import tiff

    for name in CORRUPT_JPEG:
        data = (OUT / name).read_bytes()
        start = scan_spans(data)[0][0]
        recipes = pick_recipes(data, [(start, len(data) - 2)], 0, 2, 2, 1)
        if "rst" in name:
            at = [i for i in range(start, len(data) - 1) if data[i] == 0xFF
                  and 0xD0 <= data[i + 1] <= 0xD7][1]
            for value in ((data[at + 1] - 0xD0 + 2) % 8 + 0xD0, 0x37):
                recipe = f"{at + 1}:{value}"
                recipes.append({"at": recipe, "rgb_sha256": cv2_sha(
                    image_samples.corrupted(data, recipe))})
        digests[name]["corrupt"] = recipes
    for name in CORRUPT_TIFF:
        data = (OUT / name).read_bytes()
        e, tags = tiff._tags(data, name)
        offsets = tags.get(273) or tags[324]
        counts = tags.get(279) or tags[325]
        spans = (scan_spans(data) if tags[259][0] == 7 else
                 [(o, o + c) for o, c in zip(offsets, counts)])
        digests[name]["corrupt"] = pick_recipes(data, spans, 0, 1, 2, 0)
    photo = OUT / "photo_480x640_q95_420.jpg"
    data = photo.read_bytes()
    gif = image_samples.quantised_gif(
        np.ascontiguousarray(cv2.imread(str(photo))[..., ::-1]))
    lzw_start = gif.index(b"\x2c", 13 + 3 * 256) + 11  # after the palette
    entry = digests["photo_480x640_q95_420.jpg"]
    entry["gif_corrupt"] = pick_recipes(gif, [(lzw_start, len(gif) - 2)], 0,
                                        1, 1, 2)
    entry["corrupt"] = pick_recipes(data, [(scan_spans(data)[0][0],
                                            len(data) - 2)], 0, 2, 1, 0)
    for names, key, recipes in (
            (STRAY_JPEG, "stray_sha256", image_samples.stray_recipes),
            (SAMPLING_JPEG, "sampling_sha256",
             image_samples.sampling_recipes)):
        for name in names:
            data = (OUT / name).read_bytes()
            digests[name][key] = image_samples.outcomes_sha256([
                image_samples.outcome(cv2_rgb(image_samples.corrupted(
                    data, r))) for r in recipes(data)])
    for name in jpeg2000_fixtures():
        digests[name]["corrupt"] = jpeg2000_recipes((OUT / name).read_bytes())
    app1 = b"Exif\x00\x00" + exif_tiff(6, big_endian=True)
    app1 = b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1
    dqt = photo.read_bytes().index(b"\xff\xdb")
    at = f"{dqt}+001122{app1.hex()}"
    entry["exif_stray"] = {"at": at, "rgb_sha256": cv2_sha(
        image_samples.corrupted(photo.read_bytes(), at))}


def jp2_sha(bgr: np.ndarray) -> str | None:
    """The sha256 of cv2.imencode(".jp2")'s bytes, or None where cv2
    writes no file (a side under 32 pixels)."""
    try:
        ok, buf = cv2.imencode(".jp2", bgr)
    except cv2.error:
        return None
    return hashlib.sha256(buf.tobytes()).hexdigest() if ok else None


def write_jp2_digests() -> None:
    """Only the .jp2 digests, into the committed digests."""
    digests = json.loads((OUT / "digests.json").read_text())
    for name in digests:
        digests[name]["imencode_jp2_sha256"] = jp2_sha(
            cv2.imread(str(OUT / name)))
    write_digests(digests)


def write_digests(digests: dict) -> None:
    """digests.json, a line for each file (compact: the fixture directory
    has a budget, held in tests/test_torch_jpeg.py)."""
    lines = [f"{json.dumps(name)}:{json.dumps(entry, separators=(',', ':'))}"
             for name, entry in sorted(digests.items())]
    (OUT / "digests.json").write_text("{\n" + ",\n".join(lines) + "\n}\n")


def write_corruption_recipes() -> None:
    """Only the recipes, into the committed digests."""
    digests = json.loads((OUT / "digests.json").read_text())
    corruption_recipes(digests)
    write_digests(digests)


if __name__ == "__main__":
    if sys.argv[1:] == ["corrupt"]:
        write_corruption_recipes()
    elif sys.argv[1:] == ["jpeg2000"]:
        write_jpeg2000_fixtures()
    elif sys.argv[1:] == ["jp2"]:
        write_jp2_digests()
    elif sys.argv[1:] == ["avif"]:
        write_avif_fixtures()
    elif sys.argv[1:] == ["avif_container"]:
        photo = cv2.imread(str(OUT / "photo_480x640_q95_420.jpg"))
        write_avif_fixture_files(container_avif_fixtures(photo[:, :, ::-1]))
    elif sys.argv[1:] == ["avif_grain"]:
        photo = cv2.imread(str(OUT / "photo_480x640_q95_420.jpg"))
        write_avif_fixture_files(grain_avif_fixtures(photo[:, :, ::-1]))
    else:
        main()
