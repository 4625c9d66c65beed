"""The AV1 tables of `csrc/av1_tables.h` for the plain decoder
(`utils/av1.py`): the header is the one copy of libaom 3.14.1's tables
that both the C library and this module read (see
`tools/av1_tables.py`, which writes it, for where each table comes from).

`table(name)` returns the array the header calls `av1_<name>`, shaped as
it is declared, as an int64 NumPy array.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import numpy as np

HEADER = Path(__file__).resolve().parents[1] / "csrc" / "av1_tables.h"
_DECL = re.compile(
    r"static const (u?int(?:8|16|32)_t) av1_(\w+)((?:\[\d+\])+) = (\{.*?\});",
    re.S)


@functools.cache
def tables() -> dict[str, np.ndarray]:
    """Every table of the header by name (without the av1_ prefix)."""
    text = HEADER.read_text()
    out = {}
    for _, name, dims, body in _DECL.findall(text):
        shape = tuple(int(d) for d in re.findall(r"\d+", dims))
        values = np.array([int(v) for v in re.findall(r"-?\d+", body)],
                          np.int64)
        if values.size != int(np.prod(shape)):
            raise ValueError(f"{HEADER}: av1_{name} has {values.size} values "
                             f"for {shape}")
        out[name] = values.reshape(shape)
    return out


def table(name: str) -> np.ndarray:
    return tables()[name]
