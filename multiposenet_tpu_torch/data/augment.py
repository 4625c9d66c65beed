"""Host training augmentations (NumPy), the port of
`multiposenet_tpu/data/augment.py`: random crop keeping the annotations,
horizontal flip with the COCO left/right keypoint swap, colour jitter, and
the resize to the train size, drawing from the caller's RandomState in
the JAX package's order so one seed gives the same images bit for bit.

The colour jitter runs in the host C library
(`utils/image_codec.jitter_rgb`); its plain version `jitter_plain` writes
the two cv2 calls out as OpenCV computes them on uint8: `rgb_to_hsv`
(COLOR_RGB2HSV, fixed point with hsv_shift 12, hue range 180) and
`hsv_to_rgb` (COLOR_HSV2RGB, through float32 and a truncating
conversion). The resizes are `utils/image_io.
resize_linear`, bit for bit with cv2's INTER_LINEAR on the uint8 image
and on the float32 [H, W, 2] stack of segmentation masks (`masks`, from
`data/loader.make_batch`), which goes through the same draws as the
image.
"""

from __future__ import annotations

import numpy as np

from multiposenet_tpu_torch.utils import image_codec
from multiposenet_tpu_torch.utils.constants import FLIP_PERMUTATION
from multiposenet_tpu_torch.utils.image_io import resize_linear

_HSV_SHIFT = 12


def _round_half_even(x: np.ndarray) -> np.ndarray:
    return np.rint(x).astype(np.int64)


# cv2's RGB2HSV_b tables: saturate_cast<int>((255 << 12) / (1. * i)) and
# saturate_cast<int>((180 << 12) / (6. * i)), 0 at i = 0.
_SDIV = np.concatenate([[0], _round_half_even(
    (255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))])
_HDIV = np.concatenate([[0], _round_half_even(
    (180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256, dtype=np.float64)))])


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV) on uint8 [..., 3]: H in
    [0, 180), S and V in [0, 255]."""
    c = rgb.astype(np.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = h + np.where(h < 0, 180, 0)
    return np.stack([np.clip(h, 0, 255), s, v], -1).astype(np.uint8)


# HSV2RGB_native's sector table: which of (v, p, q, t) is b, g and r.
_HSV_VECTOR = 32
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                     [0, 1, 3], [2, 1, 0]])


def _one_minus_fused(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 1 - a·b rounded once, as a fused multiply-add computes it
    (the float32 product is exact in float64; over every uint8 HSV input
    this equals OpenCV's vector code)."""
    return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(
        np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB) on uint8 [..., W, 3] (H in
    [0, 180)), each row of W pixels as OpenCV 5.0 converts it: in
    float32, h·(6/180) split into a sector and its fraction, the four
    levels v, v(1-s), v(1-s·f), v(1-s(1-f)) (the last two with 1 - s·f
    rounded once, as a fused multiply-add), each channel times 255, then
    truncated for the row's first multiple of 32 pixels (the vector code)
    and rounded half to even for the rest (saturate_cast in the scalar
    code)."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255)
    sector = np.trunc(h)
    h = h - sector
    sector = sector.astype(np.int64) % 6
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * _one_minus_fused(s, h),
                    v * _one_minus_fused(s, one - h)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1) * f32(255.0)
    # OpenCV converts each row's first multiple of 32 pixels in vector
    # code, which truncates, and the rest in scalar code, which rounds
    # half to even.
    vec = np.arange(hsv.shape[-2]) < hsv.shape[-2] // _HSV_VECTOR * _HSV_VECTOR
    out = np.where(vec[:, None], np.trunc(bgr), np.rint(bgr))
    return np.clip(out, 0, 255).astype(np.uint8)[..., ::-1]


def hflip(image: np.ndarray, keypoints: np.ndarray, boxes: np.ndarray,
          masks: np.ndarray | None = None):
    """Horizontal flip with the COCO L/R keypoint swap; `masks` [H, W, M]
    flips with the image."""
    w = image.shape[1]
    image = image[:, ::-1]
    if masks is not None:
        masks = np.ascontiguousarray(masks[:, ::-1])
    keypoints = keypoints.copy()
    keypoints[..., 0] = np.where(
        keypoints[..., 2] > 0, (w - 1) - keypoints[..., 0], keypoints[..., 0])
    keypoints = keypoints[:, FLIP_PERMUTATION]
    boxes = boxes.copy()
    x0 = boxes[:, 1].copy()
    boxes[:, 1] = (w - 1) - boxes[:, 3]
    boxes[:, 3] = (w - 1) - x0
    return np.ascontiguousarray(image), keypoints, boxes, masks


def crop_window(rng: np.random.RandomState, h: int, w: int,
                min_fraction: float = 0.6) -> tuple[int, int, int, int]:
    """random_crop's draws for an h x w image: (y0, x0, ch, cw)."""
    ch = int(h * rng.uniform(min_fraction, 1.0))
    cw = int(w * rng.uniform(min_fraction, 1.0))
    y0 = rng.randint(0, h - ch + 1)
    x0 = rng.randint(0, w - cw + 1)
    return y0, x0, ch, cw


def random_crop(rng: np.random.RandomState, image: np.ndarray,
                keypoints: np.ndarray, boxes: np.ndarray,
                masks: np.ndarray | None = None,
                min_fraction: float = 0.6):
    """Random crop keeping annotations consistent; keypoints falling
    outside the crop get v=0; `masks` is cropped with the image."""
    window = crop_window(rng, *image.shape[:2], min_fraction)
    return crop(image, keypoints, boxes, masks, window)


def crop(image: np.ndarray, keypoints: np.ndarray, boxes: np.ndarray,
         masks: np.ndarray | None, window: tuple[int, int, int, int]):
    """The crop (y0, x0, ch, cw) of `crop_window`, applied."""
    y0, x0, ch, cw = window
    image = image[y0:y0 + ch, x0:x0 + cw]
    if masks is not None:
        masks = np.ascontiguousarray(masks[y0:y0 + ch, x0:x0 + cw])
    keypoints = keypoints.copy()
    keypoints[..., 0] -= x0
    keypoints[..., 1] -= y0
    outside = ((keypoints[..., 0] < 0) | (keypoints[..., 0] > cw - 1)
               | (keypoints[..., 1] < 0) | (keypoints[..., 1] > ch - 1))
    keypoints[..., 2] = np.where(outside, 0.0, keypoints[..., 2])
    boxes = boxes.copy()
    boxes[:, 0] = np.clip(boxes[:, 0] - y0, 0, ch - 1)
    boxes[:, 2] = np.clip(boxes[:, 2] - y0, 0, ch - 1)
    boxes[:, 1] = np.clip(boxes[:, 1] - x0, 0, cw - 1)
    boxes[:, 3] = np.clip(boxes[:, 3] - x0, 0, cw - 1)
    return np.ascontiguousarray(image), keypoints, boxes, masks


def jitter_factors(rng: np.random.RandomState, brightness: float = 0.25,
                   contrast: float = 0.25, hue: float = 0.05,
                   saturation: float = 0.25) -> tuple:
    """color_jitter's draws, in its order: (contrast factor, brightness
    shift, hue shift, saturation factor), the last two None when neither
    is jittered."""
    c = rng.uniform(1 - contrast, 1 + contrast)
    b = rng.uniform(-brightness, brightness)
    if not (hue > 0 or saturation > 0):
        return c, b, None, None
    return c, b, rng.uniform(-hue, hue), rng.uniform(1 - saturation,
                                                     1 + saturation)


def jitter(image: np.ndarray, factors: tuple) -> np.ndarray:
    """The jitter of `jitter_factors` on uint8 pixels, in the host C
    library (`jitter_plain` is its plain version)."""
    return image_codec.jitter_rgb(image, *factors)


def jitter_plain(image: np.ndarray, factors: tuple) -> np.ndarray:
    """`jitter` in NumPy."""
    c, b, hue_shift, sat = factors
    img = image.astype(np.float32)
    img = img * c
    img = img + b * 255.0
    img = np.clip(img, 0, 255).astype(np.uint8)
    if hue_shift is not None:
        hsv = rgb_to_hsv(img).astype(np.float32)
        # OpenCV's uint8 hue range is [0, 180).
        hsv[..., 0] = (hsv[..., 0] + hue_shift * 180.0) % 180.0
        hsv[..., 1] = np.clip(hsv[..., 1] * sat, 0, 255)
        img = hsv_to_rgb(hsv.astype(np.uint8))
    return img


def color_jitter(rng: np.random.RandomState, image: np.ndarray,
                 brightness: float = 0.25, contrast: float = 0.25,
                 hue: float = 0.05, saturation: float = 0.25) -> np.ndarray:
    """Contrast, brightness, hue and saturation jitter on uint8 pixels;
    hue is a fraction of the hue circle, saturation a factor range."""
    return jitter(image, jitter_factors(rng, brightness, contrast, hue,
                                        saturation))


def resize_to(image: np.ndarray, keypoints: np.ndarray, boxes: np.ndarray,
              target: int, masks: np.ndarray | None = None,
              mode: str = "max_side"):
    """Resize + bottom/right zero pad/crop to (target, target).
    "max_side": one scale target / max(h, w), the whole image visible;
    "min_side": target / min(h, w), the long axis cropped at `target`
    (keypoints beyond it get v=0). `masks` [H, W, M] float32 resizes
    alike (cv2's float INTER_LINEAR) into zeros [target, target, M]."""
    h, w = image.shape[:2]
    if mode == "min_side":
        scale = target / min(h, w)
    elif mode == "max_side":
        scale = target / max(h, w)
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_linear(image, (nw, nh))
    out = np.zeros((target, target, 3), image.dtype)
    out[:min(nh, target), :min(nw, target)] = resized[:target, :target]
    keypoints = keypoints.copy()
    keypoints[..., :2] *= scale
    boxes = boxes * scale
    if mode == "min_side":
        boxes = np.clip(boxes, 0.0, target - 1)
        outside = ((keypoints[..., 0] > target - 1)
                   | (keypoints[..., 1] > target - 1))
        keypoints[..., 2] = np.where(outside, 0.0, keypoints[..., 2])
    if masks is not None:
        mr = resize_linear(masks.astype(np.float32), (nw, nh))
        if mr.ndim == 2:
            mr = mr[..., None]
        mout = np.zeros((target, target, mr.shape[-1]), np.float32)
        mout[:min(nh, target), :min(nw, target)] = mr[:target, :target]
        masks = mout
    return out, keypoints, boxes, masks


def draw_augmentation(rng: np.random.RandomState, h: int, w: int,
                      flip_prob: float = 0.5, crop_prob: float = 0.7):
    """augment_record's draws for an h x w image, in its order: (the crop
    window or None, whether to flip, the jitter factors). They depend on
    the image's size alone, so a data-parallel loader rank replays the
    draws of the rows it does not load (data/loader.py)."""
    window = crop_window(rng, h, w) if rng.rand() < crop_prob else None
    flip = rng.rand() < flip_prob
    return window, flip, jitter_factors(rng)


def augment_record(rng: np.random.RandomState, image: np.ndarray,
                   keypoints: np.ndarray, boxes: np.ndarray, target: int,
                   masks: np.ndarray | None = None, flip_prob: float = 0.5,
                   crop_prob: float = 0.7):
    """The training augmentation chain → a (target, target) image; `masks`
    go through the same crop, flip and resize."""
    window, flip, factors = draw_augmentation(rng, *image.shape[:2],
                                              flip_prob, crop_prob)
    if window is not None:
        image, keypoints, boxes, masks = crop(image, keypoints, boxes, masks,
                                              window)
    if flip:
        image, keypoints, boxes, masks = hflip(image, keypoints, boxes,
                                               masks)
    image = jitter(image, factors)
    return resize_to(image, keypoints, boxes, target, masks)
