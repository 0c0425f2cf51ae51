"""Numpy transforms of the datasets (copy of the JAX package's
``datasets/transforms.py``; reference ``evals/datasets/utils.py:81-214``).

Nearest interpolation throughout, as the reference's ``interpolation=0``
choices, so depth and normal targets stay valid. Two functions of the JAX
file call optional libraries; the port computes them in numpy instead:

* ``color_jitter``'s hue shift goes through ``rgb_to_hsv`` and
  ``hsv_to_rgb`` below, matplotlib's formulas in matplotlib's order;
* ``rotate`` is a nearest-neighbour affine warp with ``cv2.warpAffine``'s
  inverse map and float32 arithmetic (``_warp_nearest``). The JAX function
  returns its input unrotated where cv2 is missing; this one always
  rotates.

Random draws come from the caller's ``np.random.RandomState`` in the JAX
functions' order, so a shared seed gives the same crops and jitters.
"""

from __future__ import annotations

import math

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def mean_std(image_mean: str):
    if image_mean == "clip":
        return CLIP_MEAN, CLIP_STD
    if image_mean == "imagenet":
        return IMAGENET_MEAN, IMAGENET_STD
    if image_mean in ("None", "none", None):
        return (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    if image_mean == "half":  # ScanNet pairs use mean 0.5 (scannet_pairs.py)
        return (0.5, 0.5, 0.5), (1.0, 1.0, 1.0)
    raise ValueError(image_mean)


def normalize_image(img: np.ndarray, image_mean: str = "imagenet") -> np.ndarray:
    """uint8/float (H, W, 3) → normalized float32."""
    mean, std = mean_std(image_mean)
    # dtype decides the /255, not a value heuristic: a near-black uint8
    # frame (max <= 1) is still 0..255-scaled. Floats keep the heuristic
    # for callers that pass un-rescaled float arrays.
    is_int = np.issubdtype(np.asarray(img).dtype, np.integer)
    img = np.asarray(img).astype(np.float32)
    if is_int or img.max() > 1.5:
        img = img / 255.0
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def rgb_to_hsv(arr: np.ndarray) -> np.ndarray:
    """(..., 3) RGB in [0, 1] -> HSV in [0, 1] (``matplotlib.colors.
    rgb_to_hsv``'s arithmetic, without its range checks)."""
    arr = np.asarray(arr)
    arr = arr.astype(np.promote_types(arr.dtype, np.float32), copy=False)
    out = np.zeros_like(arr)
    arr_max = arr.max(-1)
    ipos = arr_max > 0
    delta = np.ptp(arr, -1)
    s = np.zeros_like(delta)
    s[ipos] = delta[ipos] / arr_max[ipos]
    ipos = delta > 0
    idx = (arr[..., 0] == arr_max) & ipos  # red is max
    out[idx, 0] = (arr[idx, 1] - arr[idx, 2]) / delta[idx]
    idx = (arr[..., 1] == arr_max) & ipos  # green is max
    out[idx, 0] = 2. + (arr[idx, 2] - arr[idx, 0]) / delta[idx]
    idx = (arr[..., 2] == arr_max) & ipos  # blue is max
    out[idx, 0] = 4. + (arr[idx, 0] - arr[idx, 1]) / delta[idx]
    out[..., 0] = (out[..., 0] / 6.0) % 1.0
    out[..., 1] = s
    out[..., 2] = arr_max
    return out


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) HSV in [0, 1] -> RGB (``matplotlib.colors.hsv_to_rgb``'s
    arithmetic)."""
    hsv = np.asarray(hsv)
    hsv = hsv.astype(np.promote_types(hsv.dtype, np.float32), copy=False)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # sector i takes (r, g, b) from these; i == 6 (h rounding to 1) is 0's
    sectors = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))
    for k, (rk, gk, bk) in enumerate(sectors):
        idx = i % 6 == 0 if k == 0 else i == k
        r[idx], g[idx], b[idx] = rk[idx], gk[idx], bk[idx]
    idx = s == 0
    r[idx], g[idx], b[idx] = v[idx], v[idx], v[idx]
    return np.stack([r, g, b], axis=-1)


def color_jitter(img: np.ndarray, rng: np.random.RandomState,
                 brightness=0.2, contrast=0.2, saturation=0.2, hue=0.2,
                 p=0.8) -> np.ndarray:
    """torchvision-style ColorJitter on a float [0,1] (H, W, 3) image."""
    if rng.rand() > p:
        return img
    img = img.copy()
    b = 1 + rng.uniform(-brightness, brightness)
    img *= b
    c = 1 + rng.uniform(-contrast, contrast)
    gray = img.mean()
    img = (img - gray) * c + gray
    s = 1 + rng.uniform(-saturation, saturation)
    lum = img.mean(axis=-1, keepdims=True)
    img = (img - lum) * s + lum
    if hue:
        # torchvision adjust_hue: shift the HSV hue channel (in turns); the
        # reference trains with ColorJitter(0.2, 0.2, 0.2, 0.2)
        dh = rng.uniform(-hue, hue)
        hsv = rgb_to_hsv(np.clip(img, 0.0, 1.0))
        hsv[..., 0] = (hsv[..., 0] + dh) % 1.0
        img = hsv_to_rgb(hsv)
    return np.clip(img, 0.0, 1.0)


def hflip(*arrays: np.ndarray):
    """Horizontal flip of (H, W, C) targets (albumentations
    ``HorizontalFlip``: a pure spatial flip, no sign change of normals, as
    the reference uses it)."""
    return tuple(np.ascontiguousarray(a[:, ::-1]) for a in arrays)


def rotation_matrix(center, angle_deg: float, scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the (2, 3) float64 forward map of a
    rotation by ``angle_deg`` (counter-clockwise) about ``center`` (x, y)."""
    a = math.radians(angle_deg)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` of a (2, 3) matrix, in float64."""
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[1, 1] * det, m[0, 0] * det
    a12, a21 = -m[0, 1] * det, -m[1, 0] * det
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def warp_source_index(m: np.ndarray, hw) -> tuple[np.ndarray, np.ndarray]:
    """The source pixel (row, col) that a nearest-neighbour warp by the
    forward map ``m`` reads for each output pixel of an ``hw`` image.

    The inverse map in float32 coefficients; per row ``m1*y + m2`` rounded
    to float32, then ``m0*x`` added with one rounding (a fused multiply-add:
    the float32 product is exact in float64), then rounded half to even.
    That is the arithmetic of ``cv2.warpAffine(INTER_NEAREST)`` in OpenCV
    5.0 to the last bit on every case the tests draw; ties at a rounding
    boundary may still pick the 8-adjacent neighbour."""
    h, w = hw
    inv = invert_affine(m).astype(np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float64)[None, :]

    def coord(r):
        row = inv[r, 1] * ys + inv[r, 2]  # float32
        full = np.float64(inv[r, 0]) * xs + row.astype(np.float64)
        return np.rint(full.astype(np.float32)).astype(np.int64)

    return coord(1), coord(0)


def _warp_nearest(a: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Nearest-neighbour warp of (H, W, ...) ``a`` by the forward map ``m``
    with a zero border (``cv2.BORDER_CONSTANT``)."""
    h, w = a.shape[:2]
    iy, ix = warp_source_index(m, (h, w))
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    out = np.zeros_like(a)
    out[inside] = a[iy[inside], ix[inside]]
    return out


def rotate(arrays, angle_deg: float):
    """Rotate (H, W, C) targets by ``angle_deg`` with nearest interpolation
    and zero border (albumentations ``Rotate(interpolation=0)``), about the
    center ``(w/2 - 0.5, h/2 - 0.5)`` as the JAX function does."""
    out = []
    for a in arrays:
        h, w = a.shape[:2]
        out.append(_warp_nearest(a, rotation_matrix((w / 2 - 0.5, h / 2 - 0.5),
                                                    angle_deg)))
    return tuple(out)


def random_resized_crop(arrays, rng: np.random.RandomState, out_hw,
                        scale=(0.5, 1.0), ratio=(1.0, 1.0)):
    """albumentations RandomResizedCrop with nearest interp."""
    h, w = arrays[0].shape[:2]
    area = h * w
    for _ in range(10):  # albumentations resamples infeasible draws
        s = rng.uniform(*scale)
        r = rng.uniform(*ratio)
        ch = int(round(np.sqrt(area * s / r)))
        cw = int(round(np.sqrt(area * s * r)))
        if ch <= h and cw <= w:
            break
    else:
        # the fallback keeps the requested ratio instead of clamping each
        # side on its own
        cw = min(w, int(round(h * r)))
        ch = min(h, int(round(cw / r)))
    y0 = rng.randint(0, h - ch + 1)
    x0 = rng.randint(0, w - cw + 1)
    return tuple(resize_nearest(a[y0: y0 + ch, x0: x0 + cw], out_hw) for a in arrays)


def resize_nearest(a: np.ndarray, out_hw) -> np.ndarray:
    """Nearest resize of an (H, W, ...) array (legacy ``floor(dst*in/out)``)."""
    oh, ow = out_hw
    h, w = a.shape[:2]
    if (h, w) == (oh, ow):
        return a
    ys = (np.arange(oh) * h // oh).clip(0, h - 1)
    xs = (np.arange(ow) * w // ow).clip(0, w - 1)
    return a[ys][:, xs]


def nyu_shared_augment(image, depth, snorm, rng: np.random.RandomState,
                       out_hw, rotateflip: bool = True):
    """The reference's NYU shared augmentation (``utils.py:200-214``):
    HFlip(p) → Rotate(±10, p) → RandomResizedCrop (scale 0.5-1, ratio 1,
    p=0.5), all nearest."""
    p_rotflip = 0.5 if rotateflip else 0.0
    if rng.rand() < p_rotflip:
        image, depth, snorm = hflip(image, depth, snorm)
    if rng.rand() < p_rotflip:
        angle = rng.uniform(-10, 10)
        image, depth, snorm = rotate((image, depth, snorm), angle)
    if rng.rand() < 0.5:
        image, depth, snorm = random_resized_crop((image, depth, snorm), rng, out_hw)
    else:
        image = resize_nearest(image, out_hw)
        depth = resize_nearest(depth, out_hw)
        snorm = resize_nearest(snorm, out_hw)
    return image, depth, snorm
