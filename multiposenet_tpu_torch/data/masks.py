"""COCO segmentations → boolean masks, the port of
`multiposenet_tpu/data/masks.py`: run-length encodings (uncompressed
counts and pycocotools' compressed strings) and polygons.

The JAX package rasterises polygons with `cv2.fillPoly(mask, parts, 1)`,
one call with every part of an annotation. cv2 is not on the card's
machine, so `fill_polygons_plain` is OpenCV 5.0's scanline fill written
out (drawing.cpp, 8-connected lines, `shift` 0): each edge's
8-connected line is drawn, then the edges of all parts together fill
between pairs of crossings, an even-odd rule across the parts, with x in
16.16 fixed point. Two overlapping parts thus leave their overlap's
interior empty and its boundary drawn, as cv2 does. `fill_polygons` is
the same in the host C library (`csrc/image_codec.c`), which
`polygons_to_mask` uses: a COCO-sized polygon takes milliseconds in
Python.
"""

from __future__ import annotations

import numpy as np

from multiposenet_tpu_torch.utils import image_codec

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def rle_counts_to_mask(counts: list[int], h: int, w: int) -> np.ndarray:
    """Alternating-run counts (zeros first, column-major) → bool [h, w]."""
    flat = np.zeros(h * w, dtype=bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos:pos + c] = True
        pos += c
        val = not val
    if pos != h * w:
        raise ValueError(f"RLE counts sum to {pos}, expected {h * w}")
    return flat.reshape((h, w), order="F")


def mask_to_rle_counts(mask: np.ndarray) -> list[int]:
    """bool [h, w] → alternating-run counts (column-major, zeros first)."""
    flat = np.asarray(mask, bool).reshape(-1, order="F")
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return counts


def decode_rle_string(s: str) -> list[int]:
    """pycocotools' compressed counts string → run counts (rleFrString)."""
    counts: list[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)  # sign-extend
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode_rle_string(counts: list[int]) -> str:
    """Run counts → pycocotools' compressed string (rleToString)."""
    out = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            # Continue while the remaining bits disagree with the sign bit.
            more = x != -1 if chunk & 0x10 else x != 0
            if more:
                chunk |= 0x20
            out.append(chr(chunk + 48))
    return "".join(out)


# --- cv2.fillPoly -------------------------------------------------------------


def _clip_line(w: int, h: int, p1: list[int],
              p2: list[int]) -> bool:
    """OpenCV's clipLine on an image of w x h: moves the integer end
    points (in place) onto the image's edges; False if the segment
    misses the image. The second point's move uses the first point's
    already moved coordinates, as OpenCV's does."""
    if w <= 0 or h <= 0:
        return False
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += _trunc((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += _trunc((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += _trunc((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += _trunc((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = (x1, y1)
    p2[:] = (x2, y2)
    return (c1 | c2) == 0


def _trunc(v: float) -> int:
    """C's double → int64 conversion (toward zero)."""
    return int(v)


def _draw_line(img: np.ndarray, p1, p2, value) -> None:
    """OpenCV's Line with an 8-connected LineIterator, left to right:
    the segment clipped to the image, then dx + 1 pixels along the major
    axis, the minor axis stepping while the error term is negative."""
    h, w = img.shape[:2]
    a, b = list(p1), list(p2)
    if not (0 <= a[0] < w and 0 <= b[0] < w and 0 <= a[1] < h
            and 0 <= b[1] < h):
        if not _clip_line(w, h, a, b):
            return
    dx, dy = b[0] - a[0], b[1] - a[1]
    if dx < 0:
        dx, dy = -dx, -dy
        a, b = b, a
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    # OpenCV's iterator starts the error at major - 2*minor and steps the
    # minor axis after each pixel whose error is negative (adding
    # 2*major - 2*minor, else subtracting 2*minor): the offset of pixel k
    # is max(0, ceil((2*minor*k - major) / (2*major))).
    n = major + 1
    k = np.arange(n)
    m = np.maximum(0, -((major - 2 * minor * k) // max(2 * major, 1)))
    if vert:
        img[a[1] + sy * k, a[0] + m] = value
    else:
        img[a[1] + sy * m, a[0] + k] = value


def _collect_edges(img: np.ndarray, pts: np.ndarray, edges: list,
                   value) -> None:
    """CollectPolyEdges with shift 0 and 8-connected lines: draws every
    edge's line and appends [y0, y1, x, dx] (x and dx in 16.16 fixed
    point, x at row y0) of each edge that is not horizontal. An edge with
    an end off the image takes its slope and x from the clipped segment
    (its y too, where the clipped ends lie on different rows), x carried
    back to the unclipped first row; its rows stay the unclipped ones."""
    h, w = img.shape[:2]
    n = len(pts)
    x0, y0 = int(pts[n - 1][0]), int(pts[n - 1][1])
    for i in range(n):
        x1, y1 = int(pts[i][0]), int(pts[i][1])
        _draw_line(img, (x0, y0), (x1, y1), value)
        cy0, cy1 = y0, y1
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h
                and 0 <= y1 < h):
            t0, t1 = [x0, y0], [x1, y1]
            _clip_line(w, h, t0, t1)  # moves the ends even if it fails
            if t0[1] != t1[1]:
                cy0, cy1 = t0[1], t1[1]
            x0, x1 = t0[0], t1[0]
        if y0 != y1:
            num, den = (x1 - x0) << XY_SHIFT, cy1 - cy0
            step = abs(num) // abs(den)
            if (num < 0) != (den < 0):
                step = -step  # C's division truncates toward zero
            if y0 < y1:
                edges.append([y0, y1, (x0 << XY_SHIFT)
                              + (y0 - cy0) * step, step])
            else:
                edges.append([y1, y0, (x1 << XY_SHIFT)
                              + (y1 - cy1) * step, step])
        x0, y0 = int(pts[i][0]), y1


def _fill_edges(img: np.ndarray, edges: list, value) -> None:
    """FillEdgeCollection for 8-connected lines: edges sorted by (y0, x,
    dx); each row walks the active list in x order, inserting the edges
    that start on the row, filling between the 1st and 2nd, 3rd and 4th,
    ... crossing (each then stepped by its dx), and dropping edges that
    end on the row; then the active list is put back in x order."""
    h, w = img.shape[:2]
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3]
                                  for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    total = len(edges)
    i = 0
    active: list = []  # edges in list order: [y0, y1, x, dx]
    for y in range(edges[0][0], min(y_max, h)):
        # The walk of OpenCV's linked list, as a list with a cursor.
        pos = 0
        draw = False
        prev = None
        while pos < len(active) or (i < total and edges[i][0] == y):
            last = active[pos] if pos < len(active) else None
            if last is not None and last[1] == y:
                del active[pos]
                continue
            keep = prev
            if last is not None and (i >= total or edges[i][0] > y
                                     or last[2] < edges[i][2]):
                prev = last
                pos += 1
            elif i < total:
                active.insert(pos, edges[i])
                prev = edges[i]
                pos += 1
                i += 1
            else:
                break
            if draw:
                if y >= 0:
                    if keep[2] > prev[2]:
                        xa, xb = prev[2], keep[2]
                    else:
                        xa, xb = keep[2], prev[2]
                    # The pixels whose x lies in [xa, xb].
                    xa = (xa + XY_ONE - 1) >> XY_SHIFT
                    xb >>= XY_SHIFT
                    if xa < w and xb >= 0:
                        img[y, max(xa, 0):min(xb, w - 1) + 1] = value
                keep[2] += keep[3]
                prev[2] += prev[3]
            draw = not draw
        # OpenCV bubble-sorts the list by x with strict comparisons:
        # a stable sort.
        active.sort(key=lambda e: e[2])


def fill_polygons_plain(img: np.ndarray, polygons: list,
                        value=1) -> np.ndarray:
    """`cv2.fillPoly(img, polygons, value)` with the default line type
    (8-connected) and shift 0, in place: `polygons` is a list of integer
    [N, 2] (x, y) point arrays, filled in one call. The plain version of
    `fill_polygons`."""
    edges: list = []
    for pts in polygons:
        pts = np.asarray(pts).reshape(-1, 2)
        if len(pts):
            _collect_edges(img, pts, edges, value)
    _fill_edges(img, edges, value)
    return img


def fill_polygons(img: np.ndarray, polygons: list, value=1) -> np.ndarray:
    """`fill_polygons_plain` through the host C library."""
    image_codec.fill_polygons(img, polygons, value)
    return img


def polygons_to_mask(polygons: list[list[float]], h: int,
                     w: int) -> np.ndarray:
    """COCO polygon list ([[x0, y0, x1, y1, ...], ...]) → bool [h, w]:
    points rounded half to even, parts of fewer than 6 numbers dropped,
    the rest filled in one call."""
    mask = np.zeros((h, w), np.uint8)
    pts = [np.round(np.asarray(p, np.float64).reshape(-1, 2))
           .astype(np.int32) for p in polygons if len(p) >= 6]
    if pts:
        fill_polygons(mask, pts, 1)
    return mask.astype(bool)


def annotation_mask(segmentation, h: int, w: int) -> np.ndarray | None:
    """One COCO annotation's `segmentation` → bool [h, w]: polygons (a
    list), uncompressed RLE (a dict with list counts) or compressed RLE
    (a dict with str counts); None when the field is missing or empty."""
    if not segmentation:
        return None
    if isinstance(segmentation, dict):
        sh, sw = segmentation.get("size", (h, w))
        counts = segmentation["counts"]
        if isinstance(counts, str):
            counts = decode_rle_string(counts)
        mask = rle_counts_to_mask(list(counts), int(sh), int(sw))
        if mask.shape != (h, w):
            raise ValueError(f"RLE size {mask.shape} != image size {(h, w)}")
        return mask
    return polygons_to_mask(segmentation, h, w)


def region_masks(segmentations: list, iscrowd: np.ndarray,
                 keypoints: np.ndarray, boxes: np.ndarray, h: int,
                 w: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-image unions (exclude [h, w], person [h, w]): `exclude` covers
    crowd persons and persons with no labelled keypoint (the regions the
    heatmap loss ignores), `person` every person (the segmentation
    head's target). A person without a segmentation contributes its box
    (y0, x0, y1, x1 pixels), rows int(y0)..ceil(y1) and columns
    int(x0)..ceil(x1) inclusive."""
    exclude = np.zeros((h, w), bool)
    person = np.zeros((h, w), bool)
    for i, seg in enumerate(segmentations):
        m = annotation_mask(seg, h, w)
        if m is None:
            y0, x0, y1, x1 = np.maximum(np.asarray(boxes[i]), 0.0)
            m = np.zeros((h, w), bool)
            m[int(y0):int(np.ceil(y1)) + 1,
              int(x0):int(np.ceil(x1)) + 1] = True
        person |= m
        unlabelled = not (np.asarray(keypoints[i])[:, 2] > 0).any()
        if bool(iscrowd[i]) or unlabelled:
            exclude |= m
    return exclude, person
