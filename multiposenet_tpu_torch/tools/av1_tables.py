"""Writes `csrc/av1_tables.h`: the AV1 tables of the port's AVIF decoder,
copied from libaom 3.14.1 as the opencv-python wheel ships it
(`opencv_python.libs/libaom-*.so.3.14.1`, the library cv2 5.0's AVIF
reader decodes through).

The library keeps its `.symtab`: every table here is read by its symbol
and size (its bytes at the symbol's file offset), except

- the default CDFs that have no symbol of their own. `av1_init_mode_probs`
  copies them into a FRAME_CONTEXT: the tool loads the library, calls that
  function (a local symbol, at its address in the loaded image) on a
  zeroed buffer and reads each field at its offset in libaom 3.14.1's
  FRAME_CONTEXT (`FC_FIELDS`; the fields that have a symbol of their own,
  such as `default_kf_y_mode_cdf`, pin the offsets). The bytes are then
  found in `.rodata`, and the header gives where they lie.
- the scan orders and the coefficient-context offsets, which libaom
  reaches through tables of pointers (`av1_scan_orders`,
  `av1_nz_map_ctx_offset`): the pointers are read in the loaded image and
  named by the symbol they point at.

Each table's comment gives its symbol (or `av1_init_mode_probs` and the
FRAME_CONTEXT offset), its virtual address, its file offset, its size
and the sha256 of its bytes. `utils/av1_tables.py` reads the same header
for the plain decoder, so the C and Python sides share one copy.

    python -m multiposenet_tpu_torch.tools.av1_tables [--check] [--lib PATH]

writes the header (or, with --check, exits 1 if the committed one
differs). It needs the wheel's libaom, so it runs where cv2 is installed;
the build and the decoder use only the committed header.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import importlib.util
import os
import struct
import sys
from pathlib import Path

import numpy as np

HEADER = Path(__file__).resolve().parents[1] / "csrc" / "av1_tables.h"
LIBAOM_VERSION = "3.14.1"

# (C name, symbol, dtype, dims): tables copied by symbol.
NAMED = [
    ("kf_y_mode_cdf", "default_kf_y_mode_cdf", "u16", (5, 5, 14)),
    ("uv_mode_cdf", "default_uv_mode_cdf", "u16", (2, 13, 15)),
    ("partition_cdf", "default_partition_cdf", "u16", (20, 11)),
    ("intra_ext_tx_cdf", "default_intra_ext_tx_cdf", "u16", (3, 4, 13, 17)),
    ("txb_skip_cdf", "av1_default_txb_skip_cdfs", "u16", (4, 5, 13, 3)),
    ("eob_extra_cdf", "av1_default_eob_extra_cdfs", "u16", (4, 5, 2, 9, 3)),
    ("dc_sign_cdf", "av1_default_dc_sign_cdfs", "u16", (4, 2, 3, 3)),
    ("eob_multi16_cdf", "av1_default_eob_multi16_cdfs", "u16", (4, 2, 2, 6)),
    ("eob_multi32_cdf", "av1_default_eob_multi32_cdfs", "u16", (4, 2, 2, 7)),
    ("eob_multi64_cdf", "av1_default_eob_multi64_cdfs", "u16", (4, 2, 2, 8)),
    ("eob_multi128_cdf", "av1_default_eob_multi128_cdfs", "u16",
     (4, 2, 2, 9)),
    ("eob_multi256_cdf", "av1_default_eob_multi256_cdfs", "u16",
     (4, 2, 2, 10)),
    ("eob_multi512_cdf", "av1_default_eob_multi512_cdfs", "u16",
     (4, 2, 2, 11)),
    ("eob_multi1024_cdf", "av1_default_eob_multi1024_cdfs", "u16",
     (4, 2, 2, 12)),
    ("coeff_base_eob_cdf", "av1_default_coeff_base_eob_multi_cdfs", "u16",
     (4, 5, 2, 4, 4)),
    ("coeff_base_cdf", "av1_default_coeff_base_multi_cdfs", "u16",
     (4, 5, 2, 42, 5)),
    ("coeff_br_cdf", "av1_default_coeff_lps_multi_cdfs", "u16",
     (4, 5, 2, 21, 5)),
    ("dc_qlookup", "dc_qlookup_QTX", "i16", (256,)),
    ("ac_qlookup", "ac_qlookup_QTX", "i16", (256,)),
    ("dc_qlookup_10", "dc_qlookup_10_QTX", "i16", (256,)),
    ("ac_qlookup_10", "ac_qlookup_10_QTX", "i16", (256,)),
    ("dc_qlookup_12", "dc_qlookup_12_QTX", "i16", (256,)),
    ("ac_qlookup_12", "ac_qlookup_12_QTX", "i16", (256,)),
    ("filter_intra_taps", "av1_filter_intra_taps", "i8", (5, 8, 8)),
    ("dr_intra_derivative", "dr_intra_derivative", "i16", (90,)),
    ("mode_to_angle_map", "mode_to_angle_map", "u8", (13,)),
    ("smooth_weights", "smooth_weights", "u8", (124,)),
    ("cdef_pri_taps", "cdef_pri_taps", "i32", (2, 2)),
    ("cdef_sec_taps", "cdef_sec_taps", "i32", (2,)),
    ("cdef_directions_padded", "cdef_directions_padded", "i32", (12, 2)),
    ("cospi", "av1_cospi_arr_data", "i32", (4, 64)),
    ("sinpi", "av1_sinpi_arr_data", "i32", (4, 5)),
    ("eob_group_start", "av1_eob_group_start", "i16", (12,)),
    ("eob_offset_bits", "av1_eob_offset_bits", "i16", (12,)),
    ("iwt_matrix", "iwt_matrix_ref", "u8", (15, 2, 3344)),
    ("wt_matrix", "wt_matrix_ref", "u8", (15, 2, 3344)),
    ("prob_cost", "av1_prob_cost", "u16", (128,)),
    ("scan_lp_16x16", "default_scan_lp_16x16_transpose", "i16", (256,)),
    ("ext_tx_inv", "av1_ext_tx_inv", "i32", (6, 16)),
    ("ext_tx_used", "av1_ext_tx_used", "i32", (6, 16)),
    ("ss_size_lookup", "av1_ss_size_lookup", "u8", (22, 2, 2)),
    ("max_txsize_rect_lookup", "max_txsize_rect_lookup", "u8", (22,)),
    ("palette_y_color_index_cdf", "default_palette_y_color_index_cdf", "u16",
     (7, 5, 9)),
    ("palette_uv_color_index_cdf", "default_palette_uv_color_index_cdf",
     "u16", (7, 5, 9)),
    ("palette_color_index_context_lookup",
     "av1_palette_color_index_context_lookup", "i32", (9,)),
    ("sgr_params", "av1_sgr_params", "i32", (16, 4)),
    ("x_by_xplus1", "av1_x_by_xplus1", "i32", (256,)),
    ("one_by_x", "av1_one_by_x", "i32", (25,)),
    ("nmv_context", "default_nmv_context", "u16", (143,)),
    ("inter_ext_tx_cdf", "default_inter_ext_tx_cdf", "u16", (4, 4, 17)),
    ("intrabc_filter", "av1_intrabc_bilinear_filter", "i16", (2, 16)),
    ("gaussian_sequence", "gaussian_sequence", "i32", (2048,)),
]

# FRAME_CONTEXT of libaom 3.14.1 (av1/common/entropymode.h), field by
# field up to the last one read here: (name, dims of aom_cdf_prob).
# Fields whose C name is given are written into the header.
FC_FIELDS = [
    ("txb_skip", (5, 13, 3)), ("eob_extra", (5, 2, 9, 3)),
    ("dc_sign", (2, 3, 3)), ("eob16", (2, 2, 6)), ("eob32", (2, 2, 7)),
    ("eob64", (2, 2, 8)), ("eob128", (2, 2, 9)), ("eob256", (2, 2, 10)),
    ("eob512", (2, 2, 11)), ("eob1024", (2, 2, 12)),
    ("coeff_base_eob", (5, 2, 4, 4)), ("coeff_base", (5, 2, 42, 5)),
    ("coeff_br", (5, 2, 21, 5)),
    ("newmv", (6, 3)), ("zeromv", (2, 3)), ("refmv", (6, 3)),
    ("drl", (3, 3)), ("inter_compound_mode", (8, 9)),
    ("compound_type", (22, 3)), ("wedge_idx", (22, 17)),
    ("interintra", (4, 3)), ("wedge_interintra", (22, 3)),
    ("interintra_mode", (4, 5)), ("motion_mode", (22, 4)),
    ("obmc", (22, 3)), ("palette_y_size", (7, 8)),
    ("palette_uv_size", (7, 8)), ("palette_y_color_index", (7, 5, 9)),
    ("palette_uv_color_index", (7, 5, 9)), ("palette_y_mode", (7, 3, 3)),
    ("palette_uv_mode", (2, 3)), ("comp_inter", (5, 3)),
    ("single_ref", (3, 6, 3)), ("comp_ref_type", (5, 3)),
    ("uni_comp_ref", (3, 3, 3)), ("comp_ref", (3, 3, 3)),
    ("comp_bwdref", (3, 2, 3)), ("txfm_partition", (21, 3)),
    ("compound_index", (6, 3)), ("comp_group_idx", (6, 3)),
    ("skip_mode", (3, 3)), ("skip_txfm", (3, 3)), ("intra_inter", (4, 3)),
    ("nmvc", (143,)), ("ndvc", (143,)), ("intrabc", (3,)),
]
# The fields read by offset from named anchors further on (the mv
# contexts between them are skipped): (name, dims) in
# FRAME_CONTEXT order, each list ending at (anchor symbol's field).
FC_BEFORE_UV_MODE = [  # the fields just before uv_mode_cdf
    ("filter_intra", (22, 3)), ("filter_intra_mode", (6,)),
    ("switchable_restore", (4,)), ("wiener_restore", (3,)),
    ("sgrproj_restore", (3,)), ("y_mode", (4, 14)),
]
FC_AFTER_KF_Y = [  # kf_y_cdf, then these, then intra_ext_tx_cdf
    ("angle_delta", (8, 8)), ("tx_size", (4, 3, 4)), ("delta_q", (5,)),
    ("delta_lf_multi", (4, 5)), ("delta_lf", (5,)),
]
FC_AFTER_INTRABC = [  # intrabc_cdf, then segmentation_probs, then
    # filter_intra_cdfs
    ("seg_pred", (3, 3)), ("spatial_pred_seg", (3, 9)),
]
FC_AFTER_INTRA_EXT_TX = [
    ("inter_ext_tx", (4, 4, 17)), ("cfl_sign", (9,)), ("cfl_alpha", (6, 17)),
]
FC_WRITTEN = {"skip_txfm": "skip_cdf", "filter_intra": "filter_intra_cdf",
              "filter_intra_mode": "filter_intra_mode_cdf",
              "angle_delta": "angle_delta_cdf", "tx_size": "tx_size_cdf",
              "delta_q": "delta_q_cdf", "delta_lf_multi": "delta_lf_multi_cdf",
              "delta_lf": "delta_lf_cdf", "cfl_sign": "cfl_sign_cdf",
              "cfl_alpha": "cfl_alpha_cdf",
              "palette_y_mode": "palette_y_mode_cdf",
              "palette_uv_mode": "palette_uv_mode_cdf",
              "palette_y_size": "palette_y_size_cdf",
              "palette_uv_size": "palette_uv_size_cdf",
              "switchable_restore": "switchable_restore_cdf",
              "wiener_restore": "wiener_restore_cdf",
              "sgrproj_restore": "sgrproj_restore_cdf",
              "txfm_partition": "txfm_partition_cdf",
              "intrabc": "intrabc_cdf",
              "spatial_pred_seg": "spatial_pred_seg_cdf"}

TX_SIZES_ALL = 19
DTYPES = {"u8": ("uint8_t", np.uint8), "i8": ("int8_t", np.int8),
          "u16": ("uint16_t", np.uint16), "i16": ("int16_t", np.int16),
          "i32": ("int32_t", np.int32)}

BSD2 = """\
 * The tables below are libaom's, under its BSD 2-Clause licence:
 *
 * Copyright (c) 2016, Alliance for Open Media. All rights reserved.
 *
 * Redistribution and use in source and binary forms, with or without
 * modification, are permitted provided that the following conditions are
 * met:
 * 1. Redistributions of source code must retain the above copyright
 *    notice, this list of conditions and the following disclaimer.
 * 2. Redistributions in binary form must reproduce the above copyright
 *    notice, this list of conditions and the following disclaimer in the
 *    documentation and/or other materials provided with the distribution.
 *
 * THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
 * "AS IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
 * LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A
 * PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT
 * HOLDER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL,
 * SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED
 * TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
 * PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
 * LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
 * NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
 * SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
"""


def find_libaom() -> str | None:
    """The wheel's libaom beside the installed cv2 package (found, not
    imported), or None."""
    spec = importlib.util.find_spec("cv2")
    if spec is None or spec.origin is None:
        return None
    libs = os.path.join(os.path.dirname(os.path.dirname(spec.origin)),
                        "opencv_python.libs")
    found = sorted(glob.glob(os.path.join(libs, "libaom-*.so." +
                                          LIBAOM_VERSION)))
    return found[0] if found else None


class Elf:
    """The sections and `.symtab` of a little-endian ELF64 file."""

    def __init__(self, path: str):
        self.data = Path(path).read_bytes()
        d = self.data
        if d[:4] != b"\x7fELF" or d[4] != 2 or d[5] != 1:
            raise ValueError(f"{path}: not a little-endian ELF64 file")
        shoff, = struct.unpack_from("<Q", d, 0x28)
        shentsize, shnum, shstrndx = struct.unpack_from("<HHH", d, 0x3A)
        secs = [struct.unpack_from("<IIQQQQIIQQ", d, shoff + i * shentsize)
                for i in range(shnum)]
        names = secs[shstrndx]

        def cstr(off):
            return d[off:d.index(b"\0", off)].decode()

        self.sections = {cstr(names[4] + s[0]): s for s in secs}
        symtab = self.sections[".symtab"]
        strtab = secs[symtab[6]]
        self.symbols: dict[str, list[tuple[int, int]]] = {}
        for i in range(symtab[5] // 24):
            st_name, info, _, shndx, value, size = struct.unpack_from(
                "<IBBHQQ", d, symtab[4] + 24 * i)
            if st_name and shndx:
                self.symbols.setdefault(cstr(strtab[4] + st_name), []).append(
                    (value, size))
        self.by_addr = {v: n for n, vs in self.symbols.items() for v, _ in vs}

    def file_offset(self, vaddr: int) -> int:
        for _, _, _, addr, off, size, *_ in self.sections.values():
            if addr and addr <= vaddr < addr + size:
                return vaddr - addr + off
        raise ValueError(f"address {vaddr:#x} lies in no section")

    def symbol(self, name: str) -> tuple[int, int]:
        """(address, size) of `name`; a static table that several objects
        define must have the same bytes in each (the first is given)."""
        found = sorted(set(self.symbols.get(name, [])))
        if not found or len({self.bytes_at(*f) for f in found}) != 1:
            raise ValueError(f"symbol {name}: {len(found)} definitions")
        return found[0]

    def bytes_at(self, vaddr: int, size: int) -> bytes:
        off = self.file_offset(vaddr)
        return self.data[off:off + size]


def _fc_offsets(elf: Elf, fc: bytes) -> dict[str, tuple[int, tuple]]:
    """FRAME_CONTEXT offset and dims of each field read here."""
    out, pos = {}, 0
    for name, dims in FC_FIELDS:
        out[name] = (pos, dims)
        pos += 2 * int(np.prod(dims))

    def anchor(symbol):
        vaddr, size = elf.symbol(symbol)
        at = fc.find(elf.bytes_at(vaddr, size))
        if at < 0 or fc.find(elf.bytes_at(vaddr, size), at + 1) >= 0:
            raise ValueError(f"{symbol} is not once in the FRAME_CONTEXT")
        return at, size

    for symbol, field in (("default_palette_y_color_index_cdf",
                           "palette_y_color_index"),
                          ("default_wedge_idx_cdf", "wedge_idx")):
        if anchor(symbol)[0] != out[field][0]:
            raise ValueError(f"FRAME_CONTEXT layout: {field} is not at "
                             f"{symbol}'s copy")
    uv_at, _ = anchor("default_uv_mode_cdf")
    pos = uv_at - sum(2 * int(np.prod(d)) for _, d in FC_BEFORE_UV_MODE)
    for name, dims in FC_BEFORE_UV_MODE:
        out[name] = (pos, dims)
        pos += 2 * int(np.prod(dims))
    pos = out["intrabc"][0] + 2 * 3
    for name, dims in FC_AFTER_INTRABC:
        out[name] = (pos, dims)
        pos += 2 * int(np.prod(dims))
    if pos != out["filter_intra"][0]:
        raise ValueError("FRAME_CONTEXT layout: the segmentation CDFs do "
                         "not fill intrabc_cdf to filter_intra_cdfs")
    kf_at, kf_size = anchor("default_kf_y_mode_cdf")
    pos = kf_at + kf_size
    for name, dims in FC_AFTER_KF_Y:
        out[name] = (pos, dims)
        pos += 2 * int(np.prod(dims))
    ext_at, ext_size = anchor("default_intra_ext_tx_cdf")
    if pos != ext_at:
        raise ValueError("FRAME_CONTEXT layout: intra_ext_tx_cdf is not "
                         "after delta_lf_cdf")
    pos = ext_at + ext_size
    for name, dims in FC_AFTER_INTRA_EXT_TX:
        out[name] = (pos, dims)
        pos += 2 * int(np.prod(dims))
    if anchor("default_inter_ext_tx_cdf")[0] != out["inter_ext_tx"][0]:
        raise ValueError("FRAME_CONTEXT layout: inter_ext_tx_cdf misplaced")
    return out


def _loaded(path: str, elf: Elf):
    """(library, load base) of libaom loaded into this process."""
    lib = ctypes.CDLL(path)
    vaddr, _ = elf.symbol("aom_codec_av1_dx")
    return lib, ctypes.cast(lib.aom_codec_av1_dx, ctypes.c_void_p).value \
        - vaddr


def collect(path: str) -> tuple[list[dict], dict]:
    """Every table: a dict of name, ctype, dims, values, provenance."""
    elf = Elf(path)
    tables = []

    def add(name, dtype, dims, raw, provenance):
        ctype, np_type = DTYPES[dtype]
        values = np.frombuffer(raw, np_type)
        if values.size != int(np.prod(dims)):
            raise ValueError(f"{name}: {values.size} values for {dims}")
        tables.append({"name": name, "ctype": ctype,
                       "dims": tuple(dims), "values": values,
                       "provenance": provenance + (
                           f", {len(raw)} bytes, sha256 "
                           f"{hashlib.sha256(raw).hexdigest()}")})

    for name, symbol, dtype, dims in NAMED:
        vaddr, size = elf.symbol(symbol)
        add(name, dtype, dims, elf.bytes_at(vaddr, size),
            f"symbol {symbol} at {vaddr:#x}, file offset "
            f"{elf.file_offset(vaddr):#x}")

    lib, base = _loaded(path, elf)
    init_vaddr, init_size = elf.symbol("av1_init_mode_probs")
    fc = ctypes.create_string_buffer(1 << 16)
    ctypes.CFUNCTYPE(None, ctypes.c_void_p)(base + init_vaddr)(fc)
    fc_bytes = fc.raw
    rodata = elf.sections[".rodata"]
    ro = elf.data[rodata[4]:rodata[4] + rodata[5]]
    for field, (at, dims) in _fc_offsets(elf, fc_bytes).items():
        if field not in FC_WRITTEN:
            continue
        raw = fc_bytes[at:at + 2 * int(np.prod(dims))]
        where = ro.find(raw)
        src = (f"at {rodata[3] + where:#x}, file offset {rodata[4] + where:#x}"
               if where >= 0 else "not one run in .rodata (the function "
               "writes some as immediates)")
        add(FC_WRITTEN[field], "u16", dims, raw,
            f"av1_init_mode_probs ({init_vaddr:#x}, {init_size:#x} bytes) "
            f"into FRAME_CONTEXT+{at:#x}; source bytes {src}")

    # Scan orders: av1_scan_orders[TX_SIZES_ALL][TX_TYPES] of {scan, iscan}.
    so_vaddr, so_size = elf.symbol("av1_scan_orders")
    ptrs = np.frombuffer(ctypes.string_at(base + so_vaddr, so_size),
                         np.uint64).reshape(TX_SIZES_ALL, 16, 2) - base
    scans, index = [], np.zeros((TX_SIZES_ALL, 16), np.int32)
    for t in range(TX_SIZES_ALL):
        for k in range(16):
            sym = elf.by_addr[int(ptrs[t, k, 0])]
            if sym not in scans:
                scans.append(sym)
            index[t, k] = scans.index(sym)
    offsets, n = [], 0
    for sym in scans:
        offsets.append(n)
        n += elf.symbol(sym)[1] // 2
    raw = b"".join(elf.bytes_at(*elf.symbol(s)) for s in scans)
    add("scan_data", "i16", (n,), raw,
        "symbols " + ", ".join(scans) + " (in this order), which "
        f"av1_scan_orders ({so_vaddr:#x}) points at")
    add("scan_offset", "i32", (TX_SIZES_ALL, 16),
        np.array([offsets[i] for i in index.ravel()], np.int32).tobytes(),
        "av1_scan_orders[tx_size][tx_type].scan as an offset into "
        "av1_scan_data")

    nz_vaddr, nz_size = elf.symbol("av1_nz_map_ctx_offset")
    nz_ptrs = np.frombuffer(ctypes.string_at(base + nz_vaddr, nz_size),
                            np.uint64) - base
    parts, nz_offsets, n = [], [], 0
    names = []
    for t in range(TX_SIZES_ALL):
        sym = elf.by_addr[int(nz_ptrs[t])]
        vaddr, size = elf.symbol(sym)
        names.append(sym)
        nz_offsets.append(n)
        parts.append(elf.bytes_at(vaddr, size))
        n += size
    add("nz_map_ctx_data", "i8", (n,), b"".join(parts),
        "symbols " + ", ".join(names) + " (one a tx size, in TX_SIZES_ALL "
        f"order), which av1_nz_map_ctx_offset ({nz_vaddr:#x}) points at")
    add("nz_map_ctx_start", "i32", (TX_SIZES_ALL,),
        np.array(nz_offsets, np.int32).tobytes(),
        "the offset of each tx size's table in av1_nz_map_ctx_data")
    lib.aom_codec_version_str.restype = ctypes.c_char_p
    meta = {"version": lib.aom_codec_version_str().decode(),
            "file": os.path.basename(path),
            "sha256": hashlib.sha256(elf.data).hexdigest()}
    return tables, meta


def _braced(a: np.ndarray, depth: int) -> str:
    """`a` as a C initializer with one brace a dimension, wrapped at 79."""
    pad = " " * depth
    if a.ndim == 1:
        lines, line = [], pad + "{"
        for v in (str(int(x)) for x in a):
            if len(line) + len(v) + 2 > 78:
                lines.append(line.rstrip())
                line = pad + " "
            line += v + ", "
        return "\n".join(lines + [line.rstrip(", ") + "}"])
    return (pad + "{\n" + ",\n".join(_braced(x, depth + 1) for x in a)
            + "\n" + pad + "}")


def render(tables: list[dict], meta: dict) -> str:
    out = ["/* AV1 tables of the port's AVIF decoder (csrc/av1.c and, read by",
           " * utils/av1_tables.py, the plain decoder in utils/avif.py).",
           " * Written by `python -m multiposenet_tpu_torch.tools.av1_tables`",
           f" * from libaom {meta['version']} as the opencv-python wheel ships",
           f" * it: {meta['file']}, sha256",
           f" * {meta['sha256']}.",
           " * Do not edit: regenerate. Each table's comment gives where its",
           " * bytes lie in that file. CDFs are libaom's inverse CDFs",
           " * (32768 minus the cumulative probability), each with its",
           " * adaptation counter last.",
           " *",
           BSD2.rstrip("\n"),
           " */",
           "#ifndef AV1_TABLES_H",
           "#define AV1_TABLES_H",
           "#include <stdint.h>",
           ""]
    for t in tables:
        dims = "".join(f"[{d}]" for d in t["dims"])
        out.append(f"/* {t['provenance']} */")
        out.append(f"static const {t['ctype']} av1_{t['name']}{dims} = "
                   + _braced(t["values"].reshape(t["dims"]), 0).lstrip()
                   + ";")
        out.append("")
    out.append("#endif")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--lib", default=None)
    args = parser.parse_args(argv)
    path = args.lib or find_libaom()
    if path is None:
        print("libaom 3.14.1 of the opencv-python wheel not found",
              file=sys.stderr)
        return 2
    text = render(*collect(path))
    if args.check:
        same = HEADER.exists() and HEADER.read_text() == text
        print("same" if same else f"{HEADER} differs")
        return 0 if same else 1
    HEADER.write_text(text)
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
