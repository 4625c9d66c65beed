"""JPEG 2000 files edited box by box and marker by marker, for holding
`utils/jpeg2000.py` to cv2 where no encoder at hand writes the feature:
the JP2 boxes (`jp2_boxes`, `jp2_file`, `with_jp2h`), the main header's
marker segments and the tile parts (`split`, `join`: tiles cut into
parts, parts reordered, Psot 0, TNsot edited), and packets found by the
port's own tier-2 parser (`packet_spans`) to insert SOP and EPH markers
(`with_sop_eph`), to move the packet headers into PPT or PPM markers
(`with_ppt`, `with_ppm`), and a POC marker that restates the packet
order (`with_poc`). Plain Python and NumPy: the card's machine runs it on the
committed codestreams too.
"""

from __future__ import annotations

import struct

from multiposenet_tpu_torch.utils import jpeg2000


def jp2_boxes(data: bytes) -> list[list]:
    """[type, payload] of each top-level box (a length of 0 runs to the
    end)."""
    out, pos = [], 0
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        n = n or len(data) - pos
        out.append([kind, data[pos + 8:pos + n]])
        pos += n
    return out


def jp2_file(boxes) -> bytes:
    """Boxes [type, payload] → their bytes."""
    return b"".join(struct.pack(">I", len(p) + 8) + k + p for k, p in boxes)


def with_jp2h(data: bytes, edit) -> bytes:
    """The JP2 file with its jp2h sub-boxes replaced by edit(sub-boxes)."""
    boxes = jp2_boxes(data)
    for box in boxes:
        if box[0] == b"jp2h":
            box[1] = jp2_file(edit(jp2_boxes(box[1])))
    return jp2_file(boxes)


def codestream(data: bytes) -> tuple[list | None, bytes]:
    """(the JP2 boxes before jp2c or None for a bare codestream, the
    codestream)."""
    if data.startswith(jpeg2000.J2K_SIGNATURE):
        return None, data
    boxes = jp2_boxes(data)
    i = next(k for k, (kind, _) in enumerate(boxes) if kind == b"jp2c")
    return boxes[:i], boxes[i][1]


def with_codestream(boxes: list | None, cs: bytes) -> bytes:
    return cs if boxes is None else jp2_file(boxes + [[b"jp2c", cs]])


def split(cs: bytes) -> tuple[list, list, bytes]:
    """A codestream → (main-header segments [marker, body] after SOC,
    tile parts [dict(tile, tp, tn, segs, data)], the bytes after the last
    part)."""
    pos, main = 2, []
    while cs[pos:pos + 2] != b"\xff\x90":
        marker, n = struct.unpack(">HH", cs[pos:pos + 4])
        main.append([marker, cs[pos + 4:pos + 2 + n]])
        pos += 2 + n
    parts = []
    while cs[pos:pos + 2] == b"\xff\x90":
        tile, psot, tp, tn = struct.unpack(">HIBB", cs[pos + 4:pos + 12])
        end = pos + psot if psot else len(cs) - 2
        q, segs = pos + 12, []
        while cs[q:q + 2] != b"\xff\x93":
            marker, n = struct.unpack(">HH", cs[q:q + 4])
            segs.append([marker, cs[q + 4:q + 2 + n]])
            q += 2 + n
        parts.append(dict(tile=tile, tp=tp, tn=tn, segs=segs,
                          data=cs[q + 2:end]))
        pos = end
    return main, parts, cs[pos:]


def _segments(segs) -> bytes:
    return b"".join(struct.pack(">HH", m, len(b) + 2) + b for m, b in segs)


def join(main, parts, tail: bytes = b"\xff\xd9",
         psot0_last: bool = False) -> bytes:
    """`split`'s pieces → a codestream (each Psot recomputed; with
    `psot0_last` the last part's Psot is 0)."""
    out = b"\xff\x4f" + _segments(main)
    for k, p in enumerate(parts):
        head = _segments(p["segs"])
        psot = 14 + len(head) + len(p["data"])
        if psot0_last and k == len(parts) - 1:
            psot = 0
        out += struct.pack(">HHHIBB", 0xFF90, 10, p["tile"], psot, p["tp"],
                           p["tn"]) + head + b"\xff\x93" + p["data"]
    return out + tail


def in_parts(parts, n: int) -> list[dict]:
    """Each tile's data cut into n tile parts of about equal size (TNsot
    n, the first keeping the tile-part header)."""
    out = []
    for p in parts:
        d = p["data"]
        cuts = [len(d) * i // n for i in range(n + 1)]
        out += [dict(tile=p["tile"], tp=i, tn=n, segs=p["segs"] if i == 0
                     else [], data=d[cuts[i]:cuts[i + 1]]) for i in range(n)]
    return out


def packet_spans(data: bytes) -> dict[int, list[tuple[int, int, int]]]:
    """Each tile's packets as the port's tier-2 parser finds them in the
    tile's data: (start, end of header, end), in decoding order."""
    start = 0
    ihdr = None
    if data.startswith(jpeg2000.JP2_SIGNATURE):
        jp2, start = jpeg2000.read_jp2(data)
        ihdr = jp2.ihdr
    cs = jpeg2000._Codestream(data, start, ihdr)
    cs.read_header()
    img = cs.image
    spans = {}
    while True:
        tile = cs.read_tile_header()
        if tile is None:
            break
        tcp = cs.tcps[tile]
        bounds = img.tile_bounds(tile)
        geometry = [jpeg2000.tile_geometry(bounds, t) for t in tcp.tccps]
        for c, t in enumerate(tcp.tccps):
            jpeg2000._band_parameters(geometry[c], t, img.comps[c][0])
        order = jpeg2000.packet_order(bounds, tcp.tccps, geometry, tcp)
        trace: list = []
        jpeg2000.read_packets(bytes(tcp.data), tcp, geometry, order, trace)
        spans[tile] = trace
        tcp.data = None
        cs.after_tile()
        if cs.state == jpeg2000.EOC_STATE or len(spans) == img.tw * img.th:
            break
    return spans


def _set_scod(main, bits: int) -> list:
    return [[m, bytes([b[0] | bits]) + b[1:] if m == jpeg2000.COD else b]
            for m, b in main]


def with_sop_eph(data: bytes, sop: bool = True, eph: bool = True) -> bytes:
    """The file with an SOP marker (its packet index modulo 65536) before
    every packet and an EPH marker after every packet header, the COD's
    Scod saying so; one tile part a tile."""
    spans = packet_spans(data)
    boxes, cs = codestream(data)
    main, parts, tail = split(cs)
    tiles = {}
    for p in parts:
        tiles.setdefault(p["tile"], [p["segs"], b""])[1] += p["data"]
    out, index = [], 0
    for tile, (segs, body) in tiles.items():
        new = b""
        for start, head, end in spans[tile]:
            if sop:
                new += struct.pack(">HHH", 0xFF91, 4, index & 0xFFFF)
            new += body[start:head] + (b"\xff\x92" if eph else b"")
            new += body[head:end]
            index += 1
        out.append(dict(tile=tile, tp=0, tn=1, segs=segs, data=new))
    bits = (2 if sop else 0) | (4 if eph else 0)
    return with_codestream(boxes, join(_set_scod(main, bits), out, tail))


def with_poc(data: bytes, entries, in_tile: bool = False) -> bytes:
    """The file with a POC marker of `entries` (RSpoc, CSpoc, LYEpoc,
    REpoc, CEpoc, Ppoc) after its COD, in the main header or (`in_tile`)
    in each tile's first tile-part header."""
    body = b"".join(struct.pack(">BBHBBB", *e) for e in entries)
    boxes, cs = codestream(data)
    main, parts, tail = split(cs)
    if in_tile:
        for p in parts:
            if p["tp"] == 0:
                p["segs"] = p["segs"] + [[jpeg2000.POC, body]]
    else:
        at = next(i for i, (m, _) in enumerate(main) if m == jpeg2000.COD)
        main = main[:at + 1] + [[jpeg2000.POC, body]] + main[at + 1:]
    return with_codestream(boxes, join(main, parts, tail))


def _headers_and_bodies(data: bytes):
    """(the JP2 boxes or None, main segments, [(tile, tile-part header
    segments, packet headers, packet bodies)], tail) with each tile's
    packets split at their headers' ends."""
    spans = packet_spans(data)
    boxes, cs = codestream(data)
    main, parts, tail = split(cs)
    tiles = {}
    for p in parts:
        tiles.setdefault(p["tile"], [p["segs"], b""])[1] += p["data"]
    out = []
    for tile, (segs, body) in tiles.items():
        heads, bodies = b"", b""
        for s, h, e in spans[tile]:
            sop = 6 if body[s:s + 2] == b"\xff\x91" else 0  # stays
            heads += body[s + sop:h]
            bodies += body[s:s + sop] + body[h:e]
        out.append((tile, segs, heads, bodies))
    return boxes, main, out, tail


def _chunks(data: bytes, size: int) -> list[bytes]:
    return [data[i:i + size] for i in range(0, len(data), size)] or [b""]


def with_ppt(data: bytes, chunk: int = 65532) -> bytes:
    """The file with each tile's packet headers moved into PPT markers
    (Zppt 0, 1, ... of at most `chunk` bytes) of its tile-part header."""
    boxes, main, tiles, tail = _headers_and_bodies(data)
    parts = [dict(tile=t, tp=0, tn=1, data=bodies, segs=segs + [
        [jpeg2000.PPT, bytes([z]) + c] for z, c in enumerate(
            _chunks(heads, chunk))]) for t, segs, heads, bodies in tiles]
    return with_codestream(boxes, join(main, parts, tail))


def with_ppm(data: bytes, chunk: int = 65532) -> bytes:
    """The file with every packet header moved into PPM markers of the
    main header: Nppm and the headers of each tile part in turn, cut into
    markers (Zppm 0, 1, ...) of at most `chunk` bytes, where a length or
    a tile part's headers may run on into the next marker."""
    boxes, main, tiles, tail = _headers_and_bodies(data)
    stream = b"".join(struct.pack(">I", len(heads)) + heads
                      for _, _, heads, _ in tiles)
    at = next(i for i, (m, _) in enumerate(main) if m == jpeg2000.QCD)
    ppm = [[jpeg2000.PPM, bytes([z]) + c]
           for z, c in enumerate(_chunks(stream, chunk))]
    parts = [dict(tile=t, tp=0, tn=1, data=bodies, segs=segs)
             for t, segs, _, bodies in tiles]
    return with_codestream(boxes, join(main[:at + 1] + ppm + main[at + 1:],
                                       parts, tail))


def pclr_box(table, sizes) -> list:
    """A pclr box [type, payload]: table [NE][NPC] of entries, each column
    `sizes` bits wide (big-endian in whole bytes)."""
    payload = struct.pack(">HB", len(table), len(sizes))
    payload += bytes(s - 1 for s in sizes)
    for row in table:
        for v, s in zip(row, sizes):
            payload += int(v).to_bytes(min((s + 7) >> 3, 4), "big")
    return [b"pclr", payload]


def cmap_box(entries) -> list:
    """A cmap box of (component, mapping type, palette column) entries."""
    return [b"cmap", b"".join(struct.pack(">HBB", *e) for e in entries)]


def colr_box(enumcs: int) -> list:
    return [b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs)]
