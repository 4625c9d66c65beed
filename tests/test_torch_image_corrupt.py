"""Damaged coded data through the port's readers against cv2 5.0
(libjpeg-turbo 3.1, libtiff 4.7.1, OpenCV's own GIF decoder): seeded
corruptions of JPEG scan data in every mode (baseline, restart intervals,
progressive, lossless, arithmetic-coded sequential and progressive),
restart markers moved, changed or dropped, the JPEG strips of a YCbCr
TIFF, TIFF LZW, PackBits and deflate strips corrupted or cut (8 and 16
bits, strips and tiles, the predictor, FillOrder 2), and GIF LZW data
(a Pillow file's bytes and crafted code streams). Each case goes through
`decode_image` (held to `cv2.imdecode`), `read_image` of a file (held to
`cv2.imread`) and `decode_image_plain` where the plain versions read the
mode (baseline JPEG, TIFF, GIF): the same pixels, or a ValueError on
every side where cv2 returns no image. The `corrupt` recipes of
tests/fixtures/images/digests.json, which the smoke script replays on
the card's machine, are held to cv2 here too.
"""

import io
import json
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from multiposenet_tpu_torch.tools import image_samples as samples
from multiposenet_tpu_torch.utils import gif, image_codec, image_io, tiff
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
# The fixture of each JPEG mode, and whether the plain decoder reads it.
JPEG_MODES = {
    "kind_noise_37x53_420_q95.jpg": True,
    "kind_tex_97x133_420_q95_rst3.jpg": True,
    "c3_progressive_48x64_420_q95_rst2.jpg": False,
    "c3_progressive_48x64_gray_q50.jpg": False,
    "c3_lossless_p1_24x24.jpg": False,
    "scene_02_444_q50.jpg": True,
    "c3_arith_progressive_32x32_444_rst.jpg": False,
    "c3_arith_32x32_420.jpg": False,
}


def _cv2(data: bytes, path: Path | None = None):
    """cv2's RGB decode of the bytes (cv2.imdecode), or of the file they
    were written to (cv2.imread), or None."""
    if path is not None:
        path.write_bytes(data)
        bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    else:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else bgr[:, :, ::-1]


def _outcome(read, *args):
    try:
        return read(*args)
    except ValueError:
        return None


def _same(got, want) -> bool:
    return (got is None) == (want is None) and (
        want is None or np.array_equal(got, want))


def _hold(data: bytes, tmp_path, plain: bool, suffix: str) -> bool:
    """Every reader against cv2 on `data`; returns whether cv2 read it."""
    path = tmp_path / f"damaged{suffix}"
    want = _cv2(data)
    want_file = _cv2(data, path)
    assert _same(_outcome(image_io.decode_image, data), want)
    assert _same(_outcome(image_io.read_image, path), want_file)
    if plain:
        assert _same(_outcome(image_io.decode_image_plain, data), want)
    return want is not None


def _scan_start(data: bytes) -> int:
    sos = data.index(b"\xff\xda")
    return sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]


def _changed(data: bytes, rs, start: int, end: int, count: int) -> bytes:
    out = bytearray(data)
    for _ in range(count):
        at, value = rs.randint(start, end), rs.randint(0, 256)
        out[at] = 0xFE if value == 0xFF else value
    return bytes(out)


@pytest.mark.parametrize("name", sorted(JPEG_MODES))
def test_two_byte_scan_corruptions_read_as_cv2(name, tmp_path):
    """150 changes of two bytes in the entropy-coded data after the first
    SOS (seed 0, never to 0xFF): bad Huffman and arithmetic codes, runs
    past the block, data that runs into a marker, restart markers lost."""
    data = (FIXTURES / name).read_bytes()
    rs = np.random.RandomState(0)
    start, read = _scan_start(data), 0
    for trial in range(150):
        damaged = _changed(data, rs, start, len(data) - 2, 2)
        # The plain decoder runs on every fifth trial of the larger files.
        plain = JPEG_MODES[name] and (len(data) < 8000 or trial % 5 == 0)
        read += _hold(damaged, tmp_path, plain, ".jpg")
    assert read > 75, read


@pytest.mark.parametrize("name", sorted(JPEG_MODES))
def test_one_byte_corruptions_read_as_cv2(name, tmp_path):
    """60 changes of one byte anywhere after the first SOS (seed 1):
    later scans' headers and tables too."""
    data = (FIXTURES / name).read_bytes()
    rs = np.random.RandomState(1)
    start = _scan_start(data)
    for _ in range(60):
        _hold(_changed(data, rs, start, len(data) - 2, 1), tmp_path,
              JPEG_MODES[name] and len(data) < 8000, ".jpg")


@pytest.mark.parametrize("name", [
    "kind_tex_97x133_420_q95_rst3.jpg",
    "c3_progressive_48x64_420_q95_rst2.jpg",
    "c3_arith_progressive_32x32_444_rst.jpg"])
def test_restart_markers_moved_changed_or_dropped_read_as_cv2(name,
                                                               tmp_path):
    """jpeg_resync_to_restart's three answers: restart markers renumbered,
    replaced by other markers, their 0xFF changed, or cut out."""
    data = (FIXTURES / name).read_bytes()
    start = _scan_start(data)
    rsts = [i for i in range(start, len(data) - 1)
            if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    rs = np.random.RandomState(3)
    for _ in range(40):
        out = bytearray(data)
        for _ in range(rs.randint(1, 3)):
            i, how = rsts[rs.randint(len(rsts))], rs.randint(4)
            if how == 0:
                out[i + 1] = 0xD0 + rs.randint(8)
            elif how == 1:
                out[i + 1] = rs.choice([0x01, 0x05, 0xC4, 0xDB, 0xE1, 0xFE,
                                        0xDD, 0xD9, 0xC0, 0xDC])
            elif how == 2:
                out[i] = rs.randint(0, 255)
            else:
                out[i:i + 2] = b""
        _hold(bytes(out), tmp_path, JPEG_MODES[name], ".jpg")


@pytest.mark.parametrize("name", ["tiff_jpeg_pil_ycbcr_16x24.tif",
                                  "tiff_jpeg_ycc420_tables_37x53.tif",
                                  "tiff_jpeg_ycc422_tiles_37x53.tif"])
def test_tiff_jpeg_strip_corruptions_read_as_cv2(name, tmp_path):
    """Bytes of a JPEG-compressed TIFF's strips or tiles after their SOS
    (libtiff's JPEG codec, warnings and all)."""
    data = (FIXTURES / name).read_bytes()
    spans, i = [], 0
    while (i := data.find(b"\xff\xda", i)) >= 0:
        start = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
        spans.append((start, data.find(b"\xff\xd9", start)))
        i = start
    rs = np.random.RandomState(0)
    for _ in range(50):
        out = bytearray(data)
        for _ in range(rs.randint(1, 3)):
            a, b = spans[rs.randint(len(spans))]
            value = rs.randint(0, 256)
            out[rs.randint(a, b)] = 0xFE if value == 0xFF else value
        _hold(bytes(out), tmp_path, True, ".tif")


def _tiff_writers() -> dict:
    rng = np.random.RandomState(7)
    img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
    img[::2] = img[::2] // 16 * 16

    def pil(**options):
        b = io.BytesIO()
        Image.fromarray(img).save(b, "TIFF", **options)
        return b.getvalue()

    return {"cv2_lzw": cv2.imencode(".tif", img[:, :, ::-1])[1].tobytes(),
            "pil_lzw": pil(compression="tiff_lzw"),
            "pil_deflate": pil(compression="tiff_adobe_deflate"),
            "pil_packbits": pil(compression="packbits")}


@pytest.mark.parametrize("writer", ["cv2_lzw", "pil_lzw", "pil_deflate",
                                    "pil_packbits"])
def test_tiff_strip_corruptions_read_as_cv2(writer, tmp_path):
    """80 changes of one byte in the first half of a 64x48 RGB TIFF
    (seed 0): libtiff keeps what the codec wrote before its data failed
    and zeros after it."""
    data = _tiff_writers()[writer]
    rs = np.random.RandomState(0)
    read = 0
    for _ in range(80):
        out = bytearray(data)
        out[rs.randint(0, len(out) // 2)] = rs.randint(0, 256)
        read += _hold(bytes(out), tmp_path, True, ".tif")
    assert read > 40, read


REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


@pytest.mark.parametrize("comp,bps,layout", [
    (comp, bps, layout) for comp in (5, 32773, 8) for bps in (8, 16)
    for layout in ("strips", "tiles", "predictor", "fill_order_2",
                   "big_endian")
    # libtiff takes no predictor under PackBits
    if not (layout == "predictor" and comp == 32773)])
def test_tiff_strips_cut_or_corrupted_read_as_cv2(comp, bps, layout,
                                                  tmp_path):
    """Coded strips and tiles cut short or with bytes changed: the
    codec's output kept, zeros after it, and neither the predictor nor a
    big-endian file's byte swap applied to a strip whose decode failed;
    8- and 16-bit samples alike."""
    rng = np.random.RandomState(comp + bps)
    top = 255 if bps == 8 else 65535
    img = (rng.rand(32, 24, 3) * top).astype(np.uint8 if bps == 8
                                               else np.uint16)
    img[::2] //= 16
    tile = (16, 16) if layout == "tiles" else None
    predictor = 2 if layout == "predictor" else 1
    e = ">" if layout == "big_endian" else "<"
    blocks = [img] if tile is None else [
        np.pad(img[y:y + 16, x:x + 16], ((0, 16 - len(img[y:y + 16])),
                                         (0, 0), (0, 0)))
        for y in (0, 16) for x in (0, 16)]

    def code(block):
        b = block.astype(np.int64)
        if predictor == 2:
            b[:, 1:] = b[:, 1:] - b[:, :-1]
        raw = (b % (top + 1)).astype(e + ("u2" if bps == 16 else "u1"))
        raw = raw.tobytes()
        coded = (tiff.lzw_encode_plain(raw) if comp == 5 else
                 samples.packbits_encode(raw) if comp == 32773 else
                 zlib.compress(raw))
        return coded.translate(REVERSED) if layout == "fill_order_2" \
            else coded

    coded = [code(b) for b in blocks]
    tags = ((266, 3, [2]),) if layout == "fill_order_2" else ()
    rs = np.random.RandomState(0)
    for trial in range(16):
        chunks = list(coded)
        k = rs.randint(len(chunks))
        if trial % 2:
            chunks[k] = chunks[k][:rs.randint(1, len(chunks[k]))]
        else:
            chunk = bytearray(chunks[k])
            chunk[rs.randint(len(chunk))] = rs.randint(256)
            chunks[k] = bytes(chunk)
        _hold(samples.tiff_bytes(img, 2, bps=bps, compression=comp,
                                 predictor=predictor, tile=tile,
                                 chunks=chunks, tags=tags,
                                 big_endian=layout == "big_endian"),
              tmp_path, True, ".tif")


def test_gif_corruptions_read_as_cv2(tmp_path):
    """60 changes of one byte in the last three quarters of a Pillow
    64x48 adaptive-palette GIF (seeds 0 and 1): cv2 gives up on strings
    past the frame, codes past the table, pixel codes after the frame's
    last pixel and data that ends before it; the port refuses those by
    name and reads the rest as cv2 does."""
    rng = np.random.RandomState(11)
    img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
    img[:, :32] = img[:, :32] // 64 * 64
    b = io.BytesIO()
    Image.fromarray(img).convert("P", palette=Image.ADAPTIVE).save(b, "GIF")
    data = b.getvalue()
    outcomes = {True: 0, False: 0}
    for seed in (0, 1):
        rs = np.random.RandomState(seed)
        for _ in range(60):
            out = bytearray(data)
            out[rs.randint(len(out) // 4, len(out))] = rs.randint(0, 256)
            outcomes[_hold(bytes(out), tmp_path, True, ".gif")] += 1
    assert min(outcomes.values()) > 20, outcomes


def _lzw_codes(codes: list[int], min_size: int) -> bytes:
    """GIF LZW data of `codes`, each as wide as OpenCV's decoder reads
    it (the width grows when its table reaches 1 << width)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    acc = bits = 0
    out = bytearray()
    width, size = min_size + 1, eoi
    for c in codes:
        acc |= c << bits
        bits += width
        while bits >= 8:
            out.append(acc & 255)
            acc >>= 8
            bits -= 8
        if c in (clear, eoi):
            width, size = min_size + 1, eoi
            continue
        size = min(size + 1, 4096)
        if size == 1 << width and width < 12:
            width += 1
    if bits:
        out.append(acc & 255)
    return bytes(out)


def _gif(w: int, h: int, lzw: bytes, block: int = 255) -> bytes:
    pal = (np.arange(12) * 7 % 256).astype(np.uint8).tobytes()
    out = b"GIF89a" + struct.pack("<HHBBB", w, h, 0x81, 0, 0) + pal
    out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x02"
    for i in range(0, len(lzw), block):
        out += bytes([len(lzw[i:i + block])]) + lzw[i:i + block]
    return out + b"\x00\x3b"


C, E = 4, 5  # the clear and end-of-information codes of 2-bit indices


@pytest.mark.parametrize("case,codes,cv2_reads", [
    ("no clear code first", [0, 1, 2, 3, 0, 1, 2, 3, E], True),
    ("a code past the table", [C, 0, 1, 9, 3, E], False),
    ("a string first", [C, 6, 1, E], False),
    ("the end code early", [C, 0, 1, 2, E], False),
    ("no end code", [C, 0, 1, 2, 3, 0, 1, 2, 3], True),
    ("codes after the end code", [C, 0, 1, 2, E, 3, 0, 1, 2, 3, E], True),
    ("a pixel code after the last, in the last byte",
     [C, 0, 1, 2, 3, 0, 1, 2, 3, 1], True),
    ("pixel codes after the last, past the last byte",
     [C, 0, 1, 2, 3, 0, 1, 2, 3, 1, 1, 1, E], False),
    ("a string past the last pixel", [C, 1, 1, 1, 1, 1, 1, 1, 6], False),
    ("an end code in the last byte, pixels after it",
     [C, 0, 1, 2, 3, 0, 1, 2, 3, E], True),
])
def test_gif_lzw_rules_of_cv2(case, codes, cv2_reads, tmp_path):
    """Code streams of a 4x2 frame that show OpenCV's GifDecoder rules:
    the end-of-information code starts a new table as a clear code does
    and decoding goes on, except where it lies in the data's last byte;
    the frame must come out exactly."""
    data = _gif(4, 2, _lzw_codes(codes, 2))
    assert _hold(data, tmp_path, True, ".gif") == cv2_reads, case


def test_gif_lzw_random_streams_read_as_cv2(tmp_path):
    """Random code streams (within the table, past it, past the frame,
    end codes, no clear code) in sub-blocks of 1 to 255 bytes, frames of
    1x1 to 80x90."""
    rs = np.random.RandomState(1)
    outcomes = {True: 0, False: 0}
    for trial in range(400):
        big = trial % 5 == 0
        w, h = ((rs.randint(40, 90), rs.randint(40, 80)) if big else
                (rs.randint(1, 9), rs.randint(1, 5)))
        n = w * h // (3 if big else 1)
        codes = [] if rs.rand() < 0.2 else [C]
        size = E
        for _ in range(rs.randint(max(1, n - 4), n + 5)):
            r = rs.rand()
            if r < 0.02:
                c = rs.randint(0, 64)
            elif r < 0.5 or size <= E + 1:
                c = rs.randint(0, 4)
            else:
                c = rs.randint(max(E + 1, size - 30), size + 1)
            codes.append(c)
            size = min(size + 1, 4096)
        if rs.rand() < 0.5:
            codes.append(E)
        lzw = _lzw_codes(codes, 2)
        if rs.rand() < 0.3:
            lzw += bytes([rs.randint(256)]) * rs.randint(1, 3)
        data = _gif(w, h, lzw, block=int(rs.choice([255, rs.randint(1, 7)])))
        outcomes[_hold(data, tmp_path, True, ".gif")] += 1
    assert min(outcomes.values()) > 20, outcomes


def test_gif_lzw_c_equals_plain_with_named_refusals():
    """The C coder and the plain version return the same indices or
    raise the same named refusal, on random bytes at every minimum code
    size (a string past the frame is shown by test_gif_lzw_rules_of_cv2;
    random bytes seldom build one)."""
    rs = np.random.RandomState(5)
    seen = set()
    for _ in range(300):
        data = rs.randint(0, 256, rs.randint(1, 200)).astype(np.uint8)
        min_size, count = int(rs.randint(2, 12)), int(rs.randint(1, 400))
        got = []
        for fn in (image_codec.gif_lzw, gif.lzw_decode_plain):
            try:
                got.append(fn(data.tobytes(), min_size, count))
            except ValueError as exc:
                got.append(str(exc))
        assert got[0] == got[1]
        seen.add(got[0] if isinstance(got[0], str) else "read")
    assert len(seen & set(image_codec.GIF_LZW_ERRORS)) >= 3, seen


def _recipes():
    for name, entry in sorted(DIGESTS.items()):
        for recipe in entry.get("corrupt", []):
            yield name, recipe["at"]
    for recipe in DIGESTS["photo_480x640_q95_420.jpg"]["gif_corrupt"]:
        yield "gif", recipe["at"]


def _sha(a) -> str | None:
    import hashlib
    return None if a is None else hashlib.sha256(
        np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name,at", list(_recipes()))
def test_committed_corruption_recipes_equal_cv2(name, at, tmp_path):
    """Each `corrupt` recipe of the digests still reads, through cv2 and
    through every reader of the port, to its recorded sha256 (or is
    refused by all where it is null): what the smoke script replays on
    the card's machine without cv2."""
    if name == "gif":
        photo = image_io.read_image(FIXTURES / "photo_480x640_q95_420.jpg")
        data = samples.quantised_gif(photo)
        recipes = DIGESTS["photo_480x640_q95_420.jpg"]["gif_corrupt"]
    else:
        data = (FIXTURES / name).read_bytes()
        recipes = DIGESTS[name]["corrupt"]
    want = next(r["rgb_sha256"] for r in recipes if r["at"] == at)
    damaged = samples.corrupted(data, at)
    assert _sha(_cv2(damaged)) == want
    suffix = ".gif" if name == "gif" else Path(name).suffix
    _hold(damaged, tmp_path, not name.startswith("c3_"), suffix)
