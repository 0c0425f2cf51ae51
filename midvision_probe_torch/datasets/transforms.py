"""Numpy transforms of the datasets (copy of the parts of the JAX package's
``datasets/transforms.py`` that the port calls)."""

from __future__ import annotations

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


def resize_nearest(a: np.ndarray, out_hw) -> np.ndarray:
    """Nearest resize of an (H, W, ...) array (legacy ``floor(dst*in/out)``)."""
    oh, ow = out_hw
    h, w = a.shape[:2]
    if (h, w) == (oh, ow):
        return a
    ys = (np.arange(oh) * h // oh).clip(0, h - 1)
    xs = (np.arange(ow) * w // ow).clip(0, w - 1)
    return a[ys][:, xs]
