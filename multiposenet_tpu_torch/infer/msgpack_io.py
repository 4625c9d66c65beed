"""The msgpack subset that flax's `serialization.to_bytes` writes for a
tree of arrays, read and written without the `msgpack` package.

What it covers (flax/serialization.py `msgpack_serialize`):
  * maps with string keys (the tree's dicts), written in their own key
    order, and the ints, strings, bools and arrays inside them;
  * ext type 1, an ndarray, whose payload is itself msgpack: the tuple
    (shape, dtype name, C-order bytes);
  * ext type 3, a numpy scalar, the same payload with shape ();
  * arrays over `MAX_CHUNK_SIZE` bytes, which flax splits into a map
    {'__msgpack_chunked_array__': True, 'shape': {'0': n0, ...},
    'chunks': {'0': flat piece, ...}} of pieces of MAX_CHUNK_SIZE bytes.

`unpack` raises on any other ext code and on any dtype name outside
`DTYPES`; nothing is guessed. `pack` writes each value in the smallest
encoding, as the msgpack package does, so a tree whose dicts are in the
order flax gives them (sorted keys) packs to the bytes flax writes.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

# flax.serialization.MAX_CHUNK_SIZE: arrays of more bytes are chunked.
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
DTYPES = frozenset((
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64"))


class MsgpackError(ValueError):
    """Bytes outside the subset this module reads."""


# --- writing ----------------------------------------------------------------

def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise MsgpackError(f"int {v} does not fit 64 bits")
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise MsgpackError(f"int {v} does not fit 64 bits")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple,
              out: bytearray) -> None:
    """A length header: the fix form below fix_max, else 8/16/32 bits."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} does not fit 32 bits")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.name not in DTYPES:
        raise MsgpackError(f"dtype {arr.dtype.name} is not written")
    out = bytearray()
    out.append(0x93)
    _pack(tuple(int(d) for d in arr.shape), out)
    _pack(arr.dtype.name, out)
    _pack(np.ascontiguousarray(arr).tobytes(), out)
    return bytes(out)


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), None, 0, (0xc7, 0xc8, 0xc9), out)
    out += struct.pack(">b", code)
    out += data


def _pack(v: Any, out: bytearray) -> None:
    if v is None:
        out.append(0xc0)
    elif v is True or v is False:
        out.append(0xc3 if v else 0xc2)
    elif isinstance(v, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(v), out)
    elif isinstance(v, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(v)), out)
    elif isinstance(v, int):
        _pack_int(v, out)
    elif isinstance(v, float):
        out.append(0xcb)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _pack_len(len(data), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out += data
    elif isinstance(v, (bytes, bytearray)):
        _pack_len(len(v), None, 0, (0xc4, 0xc5, 0xc6), out)
        out += v
    elif isinstance(v, (list, tuple)):
        _pack_len(len(v), 0x90, 16, (None, 0xdc, 0xdd), out)
        for item in v:
            _pack(item, out)
    elif isinstance(v, dict):
        _pack_len(len(v), 0x80, 16, (None, 0xde, 0xdf), out)
        for key, item in v.items():
            if not isinstance(key, str):
                raise MsgpackError(f"map key {key!r} is not a string")
            _pack(key, out)
            _pack(item, out)
    else:
        raise MsgpackError(f"cannot write a {type(v).__name__}")


def _chunk(arr: np.ndarray) -> dict:
    """flax's `_chunk`: the canonical dict of flat pieces."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    pieces = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): p for i, p in enumerate(pieces)}}


def _chunk_leaves(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def pack(tree: Any) -> bytes:
    """A tree of dicts with string keys and numpy leaves → msgpack bytes,
    arrays over MAX_CHUNK_SIZE bytes chunked as flax chunks them."""
    out = bytearray()
    _pack(_chunk_leaves(tree), out)
    return bytes(out)


# --- reading ----------------------------------------------------------------

class _Reader:

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackError("truncated msgpack data")
        piece = self.data[self.pos:self.pos + n]
        self.pos += n
        return piece

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
                0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H",
                0xc6: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",
                0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in lens:
            raise MsgpackError(f"msgpack type byte 0x{b:02x} is not read")
        n = self.unpack(lens[b])
        if b in (0xd9, 0xda, 0xdb):
            return self.str(n)
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(n))
        if b in (0xdc, 0xdd):
            return self.array(n)
        if b in (0xde, 0xdf):
            return self.map(n)
        return self.ext(n)

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise MsgpackError(f"map key {key!r} is not a string")
            out[key] = self.value()
        return _unchunk(out) if out.get(CHUNKED) is True else out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise MsgpackError(f"msgpack ext type {code} is not read")
        arr = _ndarray_from_payload(data)
        return arr if code == EXT_NDARRAY else arr[()]


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    reader = _Reader(data)
    header = reader.value()
    if (not isinstance(header, list) or len(header) != 3
            or reader.pos != len(data)):
        raise MsgpackError("ndarray payload is not (shape, dtype, bytes)")
    shape, name, buffer = header
    if name not in DTYPES:
        raise MsgpackError(f"dtype {name!r} is not read")
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(d: dict) -> np.ndarray:
    """flax's `_unchunk`: the flat pieces concatenated, reshaped."""
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    pieces = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(pieces).reshape(shape)


def unpack(data: bytes) -> Any:
    """msgpack bytes → the tree (dicts, numpy arrays and scalars), chunked
    arrays joined again."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise MsgpackError("trailing bytes after the msgpack value")
    return tree
