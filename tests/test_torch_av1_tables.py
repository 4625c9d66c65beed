"""The AV1 tables of the port's AVIF decoder (`csrc/av1_tables.h`, read
by the C library and, through `utils/av1_tables.py`, by the plain
decoder): regenerated here from the opencv-python wheel's libaom 3.14.1
by `tools/av1_tables.py` they equal the committed header byte for byte,
and each table's values hash to the sha256 its comment records (the
provenance the header carries: symbol, address, file offset, size).
"""

import hashlib
import re

import numpy as np
import pytest

from multiposenet_tpu_torch.tools import av1_tables as tool
from multiposenet_tpu_torch.utils import av1_tables
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"uint8_t": np.uint8, "int8_t": np.int8, "uint16_t": np.uint16,
          "int16_t": np.int16, "int32_t": np.int32}
_COMMENT = re.compile(r"/\* (.*?), (\d+) bytes, sha256 ([0-9a-f]{64}) \*/\n"
                      r"static const (u?int\d+_t) av1_(\w+)")


def _entries():
    return _COMMENT.findall(av1_tables.HEADER.read_text())


def test_header_regenerates_from_the_wheels_libaom():
    path = tool.find_libaom()
    if path is None:
        pytest.skip("the opencv-python wheel's libaom is absent")
    text = tool.render(*tool.collect(path))
    assert text == av1_tables.HEADER.read_text()
    assert tool.main(["--check", "--lib", path]) == 0


def test_each_table_hashes_to_its_recorded_sha256():
    entries = _entries()
    tables = av1_tables.tables()
    assert len(entries) == len(tables) >= 50
    for provenance, size, sha, ctype, name in entries:
        raw = tables[name].astype(DTYPES[ctype]).tobytes()
        assert len(raw) == int(size), name
        assert hashlib.sha256(raw).hexdigest() == sha, name
        assert provenance.startswith(("symbol", "symbols", "av1_init_mode",
                                      "av1_scan_orders", "the offset")), name


def test_header_names_its_source_and_licence():
    text = av1_tables.HEADER.read_text()
    head = text[:text.index("#ifndef")]
    assert "libaom 3.14.1" in head or "v3.14.1" in head
    assert re.search(r"sha256\n \* [0-9a-f]{64}", head)
    assert "BSD 2-Clause" in head and "Alliance for Open Media" in head


@pytest.mark.parametrize("name,first", [
    ("skip_cdf", [1097, 0, 0]),            # AOM_CDF2(31671)
    ("filter_intra_mode_cdf", [23819, 19992, 15557, 3210, 0, 0]),
    ("delta_q_cdf", [4608, 648, 91, 0, 0]),
    ("dc_qlookup", [4, 8, 8, 9]),
    ("ac_qlookup", [4, 8, 9, 10]),
    ("mode_to_angle_map", [0, 90, 180, 45, 135, 113, 157, 203, 67]),
    # Default_Segment_Id_Cdf[0]: AOM_CDF8(5622, 7893, 16093, 18233, 27809,
    # 28373, 32533)
    ("spatial_pred_seg_cdf", [27146, 24875, 16675, 14535, 4959, 4395, 235,
                              0, 0]),
    ("gaussian_sequence", [56, 568, -180, 172, 124, -84, 172, -64, -900, 24,
                           820, 224, 1248, 996, 272, -8])])
def test_tables_hold_the_values_the_av1_specification_gives(name, first):
    """A few values the AV1 specification states (its default CDFs are
    32768 minus libaom's inverse CDFs): the FRAME_CONTEXT offsets the
    tool reads the unnamed CDFs at are the right ones."""
    values = av1_tables.table(name).ravel().tolist()
    assert values[:len(first)] == first
