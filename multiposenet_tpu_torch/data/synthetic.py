"""Synthetic multi-person fixtures: images + COCO-style annotations.
The port's own copy of `multiposenet_tpu/data/synthetic.py`: the same seed
gives the same records, bit for bit (tests/test_torch_data.py).

Reference counterpart: the reference's de-facto smoke fixtures were a
handful of JPEGs in notebooks (SURVEY.md §4). This environment has no COCO
data or network (SURVEY.md §7: "Training configs must support
synthetic/fixture data"), so this module synthesizes deterministic
multi-person scenes, returning both the image and exact GT — enough for
integration tests, PRN training, and benchmarks (BASELINE.json config 4
needs ≥8-person images).

Two distributions:

* v2 (default, VERDICT r3 #3): ARTICULATED stick figures — per-joint limb
  angles sampled within human-ish ranges (elbows/knees bend, arms raise),
  whole-body rotation, border truncation (persons may be partially
  outside the frame; out-of-frame keypoints are v=0), inter-person
  occlusion ordering (later-rendered persons draw an opaque body silhouette
  over earlier ones; covered keypoints become v=1 "labeled, not visible"
  and their blobs are erased), and a wider scale range. The PRN's
  discrimination task is real here: poses differ in topology, overlap, and
  truncation, unlike v1's identical upright templates.
* v1: the round-1..3 distribution (upright template ± 0.015 jitter, fully
  inside the frame, no occlusion model) — kept for A/B continuity with
  recorded round-3 numbers.
"""

from __future__ import annotations

import numpy as np

from multiposenet_tpu_torch.utils.constants import NUM_KEYPOINTS

# Canonical upright-person keypoint template in a unit box (x, y in [0, 1]).
_TEMPLATE = np.array([
    [0.50, 0.08],  # nose
    [0.46, 0.06], [0.54, 0.06],   # eyes
    [0.42, 0.08], [0.58, 0.08],   # ears
    [0.35, 0.22], [0.65, 0.22],   # shoulders
    [0.28, 0.40], [0.72, 0.40],   # elbows
    [0.24, 0.56], [0.76, 0.56],   # wrists
    [0.40, 0.55], [0.60, 0.55],   # hips
    [0.38, 0.75], [0.62, 0.75],   # knees
    [0.37, 0.95], [0.63, 0.95],   # ankles
], dtype=np.float32)

# COCO keypoint indices.
_NOSE, _LEYE, _REYE, _LEAR, _REAR = 0, 1, 2, 3, 4
_LSHO, _RSHO, _LELB, _RELB, _LWRI, _RWRI = 5, 6, 7, 8, 9, 10
_LHIP, _RHIP, _LKNE, _RKNE, _LANK, _RANK = 11, 12, 13, 14, 15, 16

# Limb segments (for the occluder silhouette): pairs of keypoint indices.
_LIMBS = [
    (_LSHO, _RSHO), (_LHIP, _RHIP), (_LSHO, _LHIP), (_RSHO, _RHIP),
    (_LSHO, _LELB), (_LELB, _LWRI), (_RSHO, _RELB), (_RELB, _RWRI),
    (_LHIP, _LKNE), (_LKNE, _LANK), (_RHIP, _RKNE), (_RKNE, _RANK),
    (_NOSE, _LSHO), (_NOSE, _RSHO),
]


def _rot(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]], np.float32)


def _articulated_pose(rng: np.random.RandomState) -> np.ndarray:
    """Sample an articulated skeleton in a canonical frame.

    Returns [17, 2] (x, y) with the pelvis near (0.5, 0.55) in a unit-ish
    box, y down. Limbs are built kinematically: each segment direction is
    a sampled angle relative to its parent, within human-ish ranges, so
    elbows/knees bend and arms swing — unlike the rigid v1 template.
    """
    pts = np.zeros((NUM_KEYPOINTS, 2), np.float32)
    half_shoulder = rng.uniform(0.12, 0.17)
    half_hip = rng.uniform(0.08, 0.12)
    torso_len = rng.uniform(0.28, 0.36)
    neck = np.array([0.5, 0.55 - torso_len], np.float32)
    pelvis = np.array([0.5, 0.55], np.float32)
    # Slight torso lean.
    lean = rng.uniform(-0.25, 0.25)
    neck = pelvis + _rot(lean) @ (neck - pelvis)

    pts[_LSHO] = neck + [-half_shoulder, 0.0]
    pts[_RSHO] = neck + [half_shoulder, 0.0]
    pts[_LHIP] = pelvis + [-half_hip, 0.0]
    pts[_RHIP] = pelvis + [half_hip, 0.0]

    # Head relative to the neck, with tilt.
    head_tilt = rng.uniform(-0.35, 0.35)
    head_r = rng.uniform(0.09, 0.13)
    up = _rot(head_tilt) @ np.array([0.0, -1.0], np.float32)
    side = np.array([-up[1], up[0]], np.float32)
    pts[_NOSE] = neck + up * head_r * 1.15
    pts[_LEYE] = neck + up * head_r * 1.3 - side * head_r * 0.35
    pts[_REYE] = neck + up * head_r * 1.3 + side * head_r * 0.35
    pts[_LEAR] = neck + up * head_r * 1.05 - side * head_r * 0.7
    pts[_REAR] = neck + up * head_r * 1.05 + side * head_r * 0.7

    def chain(root, seg_len, base_angle, rel_range, out1, out2):
        """Two-segment limb: root → joint → end, angles y-down radians."""
        a1 = base_angle + rng.uniform(*rel_range)
        d1 = np.array([np.sin(a1), np.cos(a1)], np.float32)  # 0 = down
        joint = pts[root] + d1 * seg_len
        # Lower segment bends off the upper one within a bounded flexion
        # range (elbow/knee).
        a2 = a1 + rng.uniform(-1.5, 0.3)
        d2 = np.array([np.sin(a2), np.cos(a2)], np.float32)
        end = joint + d2 * seg_len * rng.uniform(0.85, 1.05)
        pts[out1] = joint
        pts[out2] = end

    arm_len = rng.uniform(0.16, 0.22)
    leg_len = rng.uniform(0.20, 0.26)
    # Arms: hang down (0) ± big swing, occasionally raised overhead.
    for sho, elb, wri, sign in ((_LSHO, _LELB, _LWRI, -1),
                                (_RSHO, _RELB, _RWRI, 1)):
        base = sign * rng.uniform(0.0, 0.9)
        if rng.rand() < 0.15:  # raised arm
            base = sign * rng.uniform(2.2, 3.0)
        chain(sho, arm_len, base, (-0.3, 0.3), elb, wri)
    # Legs: near-vertical with stance/stride variation.
    for hip, kne, ank, sign in ((_LHIP, _LKNE, _LANK, -1),
                                (_RHIP, _RKNE, _RANK, 1)):
        base = sign * rng.uniform(0.0, 0.35)
        if rng.rand() < 0.2:  # striding
            base = sign * rng.uniform(-0.5, 0.8)
        chain(hip, leg_len, base, (-0.25, 0.25), kne, ank)
    return pts


def synth_person(
    rng: np.random.RandomState,
    img_h: int,
    img_w: int,
    min_size: float = 0.2,
    max_size: float = 0.6,
    style: str = "v2",
    overhang: float = 0.35,
) -> tuple[np.ndarray, np.ndarray]:
    """One random person → (keypoints[17, 3], box[4] (y0,x0,y1,x1)).

    v2: articulated pose + whole-body rotation + possible border
    truncation (center may land near the frame edge; out-of-frame
    keypoints get v=0 and the box is clipped to the frame, so truncated
    persons contribute partial GT exactly like COCO border crops).
    """
    if style == "v1":
        ph = rng.uniform(min_size, max_size) * img_h
        pw = ph * rng.uniform(0.4, 0.6)
        y0 = rng.uniform(0, max(img_h - ph, 1))
        x0 = rng.uniform(0, max(img_w - pw, 1))
        jitter = rng.normal(0, 0.015, _TEMPLATE.shape).astype(np.float32)
        pts = np.clip(_TEMPLATE + jitter, 0.0, 1.0)
        kx = x0 + pts[:, 0] * pw
        ky = y0 + pts[:, 1] * ph
        vis = np.full((NUM_KEYPOINTS,), 2.0, np.float32)
        hide = rng.rand(NUM_KEYPOINTS) < 0.1
        vis[hide] = 0.0
        kps = np.stack([kx, ky, vis], axis=-1).astype(np.float32)
        box = np.asarray([y0, x0, y0 + ph, x0 + pw], np.float32)
        return kps, box

    scale = rng.uniform(min_size, max_size) * img_h
    pts = _articulated_pose(rng)  # canonical frame, pelvis ~(0.5, 0.55)
    # Whole-body rotation: usually modest, occasionally large (fallen /
    # leaning person).
    theta = rng.normal(0.0, 0.18)
    if rng.rand() < 0.08:
        theta = rng.uniform(-1.2, 1.2)
    center = pts.mean(axis=0)
    pts = (pts - center) @ _rot(theta).T + center

    # Placement: allow the body to overhang any border by up to
    # `overhang` (default ~35%) of its size (border truncation).
    # overhang=0.0 keeps persons' centers inside the frame — the
    # quality-gate operating point (round 5: at gate scale, the default
    # truncation compounds with occlusion until scenes are unlearnable;
    # NOTES_r5.md diagnosis arms 1-4). Same rng draw count either way,
    # so the default stream is unchanged.
    ov = overhang * scale
    cy = rng.uniform(-ov, img_h + ov)
    cx = rng.uniform(-ov, img_w + ov)
    kx = cx + (pts[:, 0] - center[0]) * scale
    ky = cy + (pts[:, 1] - center[1]) * scale

    vis = np.full((NUM_KEYPOINTS,), 2.0, np.float32)
    out = (kx < 0) | (kx > img_w - 1) | (ky < 0) | (ky > img_h - 1)
    vis[out] = 0.0
    hide = rng.rand(NUM_KEYPOINTS) < 0.08  # unlabeled, like v1
    vis[hide] = 0.0
    kps = np.stack([kx, ky, vis], axis=-1).astype(np.float32)

    inb = vis > 0
    if inb.sum() >= 2:
        y0, y1 = ky[inb].min(), ky[inb].max()
        x0, x1 = kx[inb].min(), kx[inb].max()
        # Small margin like a human-drawn box around the visible extent.
        my, mx = 0.06 * (y1 - y0 + 1), 0.06 * (x1 - x0 + 1)
        box = np.asarray([
            max(y0 - my, 0.0), max(x0 - mx, 0.0),
            min(y1 + my, img_h - 1.0), min(x1 + mx, img_w - 1.0),
        ], np.float32)
    else:
        box = np.zeros((4,), np.float32)
    return kps, box


def _silhouette_mask(
    kps: np.ndarray, img_h: int, img_w: int, width: float
) -> np.ndarray:
    """Opaque body silhouette: union of capsules along _LIMBS segments.

    Used for v2 occlusion ordering — a later person's silhouette covers
    earlier persons' keypoints.
    """
    yy, xx = np.mgrid[0:img_h, 0:img_w].astype(np.float32)
    mask = np.zeros((img_h, img_w), bool)
    w2 = width * width
    for a, b in _LIMBS:
        if kps[a, 2] <= 0 and kps[b, 2] <= 0:
            continue
        ax, ay = kps[a, 0], kps[a, 1]
        bx, by = kps[b, 0], kps[b, 1]
        dx, dy = bx - ax, by - ay
        seg2 = dx * dx + dy * dy + 1e-6
        t = np.clip(((xx - ax) * dx + (yy - ay) * dy) / seg2, 0.0, 1.0)
        px, py = ax + t * dx, ay + t * dy
        d2 = (xx - px) ** 2 + (yy - py) ** 2
        mask |= d2 <= w2
    return mask


def _make_palette() -> np.ndarray:
    """[17, 3] distinct RGB color per keypoint type (hue palette).

    Round-4 fixtures v2 rendered all 17 keypoint types as FLAT blobs in
    3 channels (c % 3), so a channel-0 blob could be any of 6 joints;
    once v2 freed articulation/rotation there was no rigid-template
    position prior left to disambiguate — measured in round 5 as the red
    quality gates' root cause (NOTES_r5.md arms 1-5: oracle-assign AP
    0.0 at every scale/truncation tried, while v1 stayed green). A
    6-level intensity code was tried first and is ALSO insufficient
    (arms 6-7: adjacent levels differ by ~9% of full scale — too subtle
    for a width-0.25 net in a gate budget). Hue coding makes identity a
    LINEAR function of local color, readable by the first conv layer —
    the property real images have through appearance (a wrist looks
    like a wrist) — while keeping v2's articulated geometry, truncation,
    and occlusion ordering.

    Hues are evenly spaced on the HSV wheel but assigned in stride-7
    order ((c*7) % 17, 7 coprime with 17), so SPATIALLY adjacent
    keypoints (the face cluster, whose blobs overlap at gate scales) get
    maximally separated hues and survive max-composition blending.
    """
    import colorsys

    pal = np.zeros((NUM_KEYPOINTS, 3), np.float32)
    for c in range(NUM_KEYPOINTS):
        hue = ((c * 7) % NUM_KEYPOINTS) / NUM_KEYPOINTS
        pal[c] = colorsys.hsv_to_rgb(hue, 1.0, 1.0)
    return pal


_PALETTE = _make_palette()


def render_scene(
    keypoints: np.ndarray, img_h: int, img_w: int, blob_sigma: float = 3.0,
    color_coded: bool = True,
) -> np.ndarray:
    """Render persons as bright keypoint blobs → uint8 [H, W, 3].

    The blobs make the scene learnable end-to-end: a trained network can
    locate keypoints, and tests can assert decoded peaks near GT.
    color_coded=True (style "v2") colors each keypoint type by
    _PALETTE; color_coded=False reproduces the round-1..4 flat
    3-channel rendering (styles "v1"/"v2flat" — kept for A/B
    continuity).
    """
    yy, xx = np.mgrid[0:img_h, 0:img_w].astype(np.float32)
    canvas = np.zeros((img_h, img_w, 3), np.float32)
    for person in keypoints:
        for c, (x, y, v) in enumerate(person):
            if v <= 0:
                continue
            g = np.exp(
                -((yy - y) ** 2 + (xx - x) ** 2) / (2 * blob_sigma**2)
            )
            if color_coded:
                canvas = np.maximum(canvas, g[..., None] * _PALETTE[c])
            else:
                canvas[..., c % 3] = np.maximum(canvas[..., c % 3], g)
    img = canvas * 200.0 + 20.0
    return np.clip(img, 0, 255).astype(np.uint8)


def render_scene_occluded(
    persons: list[np.ndarray], img_h: int, img_w: int,
    widths: list[float], blob_sigma: float = 3.0,
    color_coded: bool = True,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """v2 renderer with inter-person occlusion ordering.

    Persons render back-to-front (list order): each person first stamps an
    opaque gray silhouette that ERASES earlier persons' blobs under it,
    then draws its own keypoint blobs. Earlier persons' keypoints covered
    by a later silhouette are downgraded to v=1 (labeled, not visible) —
    their blobs are gone from the image, so the network genuinely cannot
    see them, but COCO-style GT still records them.

    Returns (image, updated keypoint arrays).
    """
    yy, xx = np.mgrid[0:img_h, 0:img_w].astype(np.float32)
    canvas = np.zeros((img_h, img_w, 3), np.float32)
    body = np.zeros((img_h, img_w), np.float32)
    kps_out = [p.copy() for p in persons]
    for i, person in enumerate(persons):
        sil = _silhouette_mask(person, img_h, img_w, widths[i])
        if sil.any():
            # Occlude earlier persons: erase their blobs, flip visibility.
            canvas[sil] = 0.0
            body[sil] = 0.35 + 0.1 * (i % 3)
            for j in range(i):
                prev = kps_out[j]
                for c in range(NUM_KEYPOINTS):
                    x, y, v = prev[c]
                    if v != 2.0:
                        continue
                    xi, yi = int(round(x)), int(round(y))
                    if 0 <= yi < img_h and 0 <= xi < img_w and sil[yi, xi]:
                        prev[c, 2] = 1.0
        for c in range(NUM_KEYPOINTS):
            x, y, v = person[c]
            if v <= 0:
                continue
            g = np.exp(
                -((yy - y) ** 2 + (xx - x) ** 2) / (2 * blob_sigma**2)
            )
            if color_coded:
                canvas = np.maximum(canvas, g[..., None] * _PALETTE[c])
            else:
                canvas[..., c % 3] = np.maximum(canvas[..., c % 3], g)
    img = canvas * 200.0 + body[..., None] * 60.0 + 20.0
    return np.clip(img, 0, 255).astype(np.uint8), kps_out


def make_dataset(
    num_images: int,
    img_h: int = 256,
    img_w: int = 256,
    min_persons: int = 1,
    max_persons: int = 4,
    seed: int = 0,
    style: str = "v2",
    min_size: float = 0.15,
    max_size: float = 0.65,
    overhang: float = 0.35,
) -> list[dict]:
    """Deterministic synthetic dataset in the coco.py record layout.

    style="v2" (default): articulated/rotated/truncated/occluded scenes
    with hue-palette-coded blobs (round 5 — see _make_palette for why
    flat blobs made the round-4 gates unlearnable). style="v2flat":
    identical geometry with the round-4 flat-intensity rendering (A/B
    continuity with the round-5 512² knob grid, which ran on it).
    style="v1": the
    round-1..3 rigid upright distribution (kept for continuity with
    recorded A/B numbers; pass min_size=0.2, max_size=0.6 to reproduce
    them exactly).
    """
    rng = np.random.RandomState(seed)
    records = []
    for i in range(num_images):
        n = rng.randint(min_persons, max_persons + 1)
        kps, boxes, widths = [], [], []
        attempts = 0
        while len(kps) < n and attempts < n * 8:
            attempts += 1
            k, b = synth_person(rng, img_h, img_w, min_size=min_size,
                                max_size=max_size, style=style,
                                overhang=overhang)
            if (k[:, 2] > 0).sum() < 4:  # too truncated to be a person
                continue
            kps.append(k)
            boxes.append(b)
            widths.append(
                0.04 * max(b[2] - b[0], b[3] - b[1]) + 1.5
            )
        coded = style == "v2"
        if style == "v1":
            kps = np.asarray(kps, np.float32).reshape(-1, NUM_KEYPOINTS, 3)
            image = render_scene(kps, img_h, img_w, color_coded=False)
        else:
            image, kps = render_scene_occluded(kps, img_h, img_w, widths,
                                               color_coded=coded)
            kps = np.asarray(kps, np.float32).reshape(-1, NUM_KEYPOINTS, 3)
        # Every-attempt-rejected scenes (aggressive truncation at small
        # sizes) must still yield well-shaped empty arrays (ADVICE r4):
        # np.asarray([]) is (0,), and boxes[:, 2] below would IndexError.
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        n = len(boxes)
        records.append({
            "id": i,
            "file_name": f"synthetic_{i:06d}.png",
            "height": img_h,
            "width": img_w,
            "keypoints": kps,
            "boxes": boxes,
            "iscrowd": np.zeros((n,), bool),
            "area": (
                (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            ).astype(np.float32),
            "image": image,
        })
    return records
