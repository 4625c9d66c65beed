"""Netpbm images as OpenCV 5.0 reads and writes them: PBM, PGM and PPM
(`grfmt_pxm.cpp`), PAM (`grfmt_pam.cpp`) and PFM (`grfmt_pfm.cpp`).

Reading (`decode`, uint8 RGB as `cv2.imdecode(buf, IMREAD_COLOR)`
reversed to RGB):
- P1-P6: header numbers separated by whitespace and `#` comments, each
  number ended by one byte; ASCII samples above maxval are clipped to it
  and scaled by `v * 255 // maxval` (P1 and P4: 1 is black); binary
  8-bit samples are taken as they are, whatever maxval says; 16-bit
  samples (maxval > 255, big-endian) keep their high byte. An ASCII file
  whose last number ends the file gives no image (cv2 reads one byte
  past each number);
- P7 (PAM): WIDTH, HEIGHT, DEPTH and MAXVAL, TUPLTYPE GRAYSCALE,
  BLACKANDWHITE or RGB matching DEPTH (or none for depth 1 or 3);
  samples as they are (16-bit: the high byte), RGB tuples taken in the
  order cv2 writes them (B, G, R). cv2 5.0 returns pixels that are not
  the file's for MAXVAL 1 and for the `_ALPHA` tuple types (its
  conversion reads past the row it decoded), so those are refused by
  name; BLACKANDWHITE_ALPHA gives no image in cv2;
- PF / Pf: `P`, `F` or `f`, a line break, then width, height and scale
  each ended by one whitespace byte; little-endian if the scale is
  negative; rows bottom-up; values times float32(1 / |scale|), then
  rounded half to even and saturated (NaN, infinities and values past
  the int range give 0). cv2 returns a Pf file with one channel even
  for IMREAD_COLOR; here its gray is repeated into three channels.

Writing (3-channel, what `cv2.imencode` writes): `.ppm`/`.pnm` as P6,
`.pam` as P7 without TUPLTYPE with B, G, R samples, `.pfm` as `PF` with
scale -1 (little-endian), R, G, B floats, rows bottom-up. These are the
plain versions of `image_codec.encode_pxm`. cv2 writes no `.pgm` or
`.pbm` for 3-channel pixels.
"""

from __future__ import annotations

import numpy as np

_SPACE = b" \t\n\v\f\r"
_DIGITS = b"0123456789"
_TUPLE_DEPTH = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "RGB": 3,
                "BLACKANDWHITE_ALPHA": 2, "GRAYSCALE_ALPHA": 2,
                "RGB_ALPHA": 4}


class _Stream:
    def __init__(self, data: bytes, name, what: str):
        self.data, self.pos, self.name, self.what = data, 0, name, what

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError(f"{self.name}: {self.what} data ends early")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.name}: {self.what} data ends early")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def number(self, max_digits: int = 0) -> int:
        """cv2's ReadNumber: skip whitespace and comments, read digits,
        and take the byte after the last digit unless max_digits ends
        the number."""
        code = self.byte()
        while code not in _DIGITS:
            if code == ord("#"):
                while code not in (10, 13):
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise ValueError(f"{self.name}: {self.what} header has "
                                 f"byte {code:#x} where a number belongs")
        val = digits = 0
        while True:
            val = val * 10 + code - 48
            if val > 2**31 - 1:
                raise ValueError(f"{self.name}: {self.what} number too "
                                 "large")
            digits += 1
            if max_digits and digits >= max_digits:
                break
            code = self.byte()
            if code not in _DIGITS:
                break
        return val


def _rgb(samples: np.ndarray) -> np.ndarray:
    """[h, w] gray or [h, w, 3] → uint8 RGB [h, w, 3]."""
    if samples.ndim == 2:
        samples = np.repeat(samples[:, :, None], 3, axis=2)
    return np.ascontiguousarray(samples, dtype=np.uint8)


def _decode_pnm(data: bytes, name) -> np.ndarray:
    s = _Stream(data, name, "PNM")
    s.take(1)
    kind = s.byte() - 48
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    binary = kind >= 4
    width, height = s.number(), s.number()
    maxval = 1 if bpp == 1 else s.number()
    if maxval > 65535 or width <= 0 or height <= 0 or maxval <= 0:
        raise ValueError(f"{name}: P{kind} of {width}x{height}, maxval "
                         f"{maxval} (cv2 returns no image)")
    nch = 3 if bpp == 24 else 1
    wide = maxval > 255
    if bpp == 1:
        if binary:
            pitch = (width + 7) // 8
            rows = np.frombuffer(s.take(pitch * height), np.uint8)
            bits = np.unpackbits(rows.reshape(height, pitch),
                                 axis=1)[:, :width]
        else:
            bits = np.array([[s.number(1) != 0 for _ in range(width)]
                             for _ in range(height)], np.uint8)
        return _rgb((1 - bits) * 255)
    count = width * height * nch
    if binary:
        dtype = ">u2" if wide else np.uint8
        samples = np.frombuffer(s.take(count * (2 if wide else 1)), dtype)
        samples = samples.astype(np.int64)
    else:
        samples = np.minimum([s.number() for _ in range(count)], maxval)
        if not wide:
            samples = samples * 255 // maxval
    if wide:
        samples = samples >> 8
    return _rgb(samples.reshape((height, width) + ((3,) if nch == 3 else ())))


def _pam_header(s: _Stream, name) -> dict:
    fields = {}
    while True:
        line = bytearray()
        while True:
            c = s.byte()
            if c in (10, 13):
                break
            line.append(c)
        text = line.decode("latin-1").strip(" \t\v\f")
        if not text or text.startswith("#"):
            continue
        key, _, value = text.partition(" ")
        key, value = key.strip(), value.strip()
        if key == "ENDHDR":
            return fields
        if key not in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL", "TUPLTYPE"):
            raise ValueError(f"{name}: PAM header field {key!r} (cv2 "
                             "returns no image)")
        if key in fields:
            raise ValueError(f"{name}: PAM header repeats {key}")
        fields[key] = value


def _decode_pam(data: bytes, name) -> np.ndarray:
    s = _Stream(data, name, "PAM")
    s.take(3)
    f = _pam_header(s, name)
    try:
        width, height = int(f["WIDTH"]), int(f["HEIGHT"])
        depth, maxval = int(f["DEPTH"]), int(f["MAXVAL"])
    except (KeyError, ValueError):
        raise ValueError(f"{name}: PAM header lacks WIDTH, HEIGHT, DEPTH "
                         "or MAXVAL (cv2 returns no image)") from None
    tupltype = f.get("TUPLTYPE")
    if tupltype is not None and tupltype not in _TUPLE_DEPTH:
        raise ValueError(f"{name}: PAM TUPLTYPE {tupltype!r} (cv2 returns "
                         "no image)")
    if tupltype is not None and _TUPLE_DEPTH[tupltype] != depth \
            or tupltype is None and depth not in (1, 3) \
            or tupltype == "BLACKANDWHITE_ALPHA" or maxval > 65535 \
            or width <= 0 or height <= 0:
        raise ValueError(f"{name}: PAM of depth {depth}, TUPLTYPE "
                         f"{tupltype}, maxval {maxval} (cv2 returns no "
                         "image)")
    if maxval == 1 or depth in (2, 4):
        raise ValueError(f"{name}: PAM with "
                         f"{'maxval 1' if maxval == 1 else tupltype} is "
                         "not read: cv2 5.0 returns pixels that are not "
                         "the file's for it")
    wide = maxval > 255
    count = width * height * depth
    samples = np.frombuffer(s.take(count * (2 if wide else 1)),
                            ">u2" if wide else np.uint8).astype(np.int64)
    if wide:
        samples >>= 8
    if depth == 1:
        return _rgb(samples.reshape(height, width))
    return _rgb(samples.reshape(height, width, 3)[:, :, ::-1])


def _pfm_number(s: _Stream) -> str:
    chars = bytearray()
    while len(chars) < 2048:
        c = s.byte()
        if c >= 128:
            raise ValueError(f"{s.name}: PFM header byte {c:#x}")
        if c in _SPACE:
            break
        chars.append(c)
    return chars.decode("ascii")


def _atoi(text: str) -> int:
    """C's atoi: leading whitespace, a sign, the digits that follow."""
    t = text.lstrip(" \t\n\v\f\r")
    sign, i = 1, 0
    if t[:1] in ("+", "-"):
        sign, i = (-1 if t[0] == "-" else 1), 1
    j = i
    while j < len(t) and t[j].isdigit():
        j += 1
    return sign * int(t[i:j]) if j > i else 0


def _atof(text: str) -> float:
    """C's atof on the longest float prefix (0.0 without one)."""
    t = text.lstrip(" \t\n\v\f\r")
    for end in range(len(t), 0, -1):
        try:
            return float(t[:end])
        except ValueError:
            continue
    return 0.0


def _float_to_u8(v: np.ndarray) -> np.ndarray:
    """cv2's saturate_cast<uchar>(float): round half to even through an
    int (NaN and values past the int range become INT_MIN), then clip."""
    r = np.rint(v.astype(np.float64))
    r[~np.isfinite(r) | (np.abs(r) >= 2.0**31)] = -(2.0**31)
    return np.clip(r, 0, 255).astype(np.uint8)


def _decode_pfm(data: bytes, name) -> np.ndarray:
    s = _Stream(data, name, "PFM")
    s.take(1)
    nch = 3 if s.byte() == ord("F") else 1
    if s.byte() != 10:
        raise ValueError(f"{name}: PFM header without a line break after "
                         "its kind (cv2 returns no image)")
    width, height = _atoi(_pfm_number(s)), _atoi(_pfm_number(s))
    scale = _atof(_pfm_number(s))
    if width <= 0 or height <= 0 or scale == 0:
        raise ValueError(f"{name}: PFM of {width}x{height}, scale {scale} "
                         "(cv2 returns no image)")
    dtype = "<f4" if scale < 0 else ">f4"
    raw = np.frombuffer(s.take(width * height * nch * 4), dtype)
    v = raw.astype(np.float32).reshape(height, width, nch)[::-1]
    v = v * np.float32(1.0 / abs(scale))
    return _rgb(_float_to_u8(v)[:, :, 0] if nch == 1 else _float_to_u8(v))


def decode(data: bytes, name="<bytes>") -> np.ndarray:
    """PBM/PGM/PPM (P1-P6), PAM (P7) or PFM (PF/Pf) bytes → uint8 RGB
    [H, W, 3] (see the module docstring); ValueError where cv2 returns no
    image or returns pixels that are not the file's."""
    kind = data[1:2]
    if kind in b"123456" and kind:
        return _decode_pnm(data, name)
    if kind == b"7":
        return _decode_pam(data, name)
    return _decode_pfm(data, name)


def encode(rgb: np.ndarray, kind: str) -> bytes:
    """uint8 RGB [H, W, 3] → what `cv2.imencode` writes for `kind` (one of
    "ppm", "pam", "pfm"); the plain version of
    `image_codec.encode_pxm`."""
    h, w = rgb.shape[:2]
    if kind == "ppm":
        return f"P6\n{w} {h}\n255\n".encode() + rgb.tobytes()
    if kind == "pam":
        return (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 3\nMAXVAL 255\n"
                "ENDHDR\n").encode() + rgb[:, :, ::-1].tobytes()
    if kind == "pfm":
        return (f"PF\n{w} {h}\n-1\n".encode()
                + rgb[::-1].astype("<f4").tobytes())
    raise ValueError(f"no Netpbm writer for {kind!r}")
