"""NAVI geometry helpers (copy of the JAX package's
``datasets/navi_utils.py``), numpy channel-last."""

from __future__ import annotations

import numpy as np


def read_depth(path: str, scale_factor: float = 10.0) -> np.ndarray:
    """16-bit disparity PNG → metric depth (``utils.py:288-297``)."""
    from PIL import Image

    max_val = (2**16) - 1
    disparity = np.array(Image.open(path)).astype(np.uint16)
    disparity = disparity.astype(np.float32) / (max_val * scale_factor)
    disparity[disparity == 0] = np.inf
    return 1.0 / disparity


def quaternion_to_rotation_matrix(q) -> np.ndarray:
    """``utils.py:383-420`` (4x4, scaled-quaternion form)."""
    q = np.asarray(q, np.float32)
    w, x, y, z = q
    s = 2.0 / (q * q).sum()
    R = np.eye(4, dtype=np.float32)
    R[0, 0] = 1 - s * (y**2 + z**2)
    R[0, 1] = s * (x * y - z * w)
    R[0, 2] = s * (x * z + y * w)
    R[1, 0] = s * (x * y + z * w)
    R[1, 1] = 1 - s * (x**2 + z**2)
    R[1, 2] = s * (y * z - x * w)
    R[2, 0] = s * (x * z - y * w)
    R[2, 1] = s * (y * z + x * w)
    R[2, 2] = 1 - s * (x**2 + y**2)
    return R


def camera_matrices_from_annotation(annotation) -> np.ndarray:
    """object→world 4x4 from quaternion + translation
    (``utils.py:371-378``)."""
    t = np.asarray(annotation["camera"]["t"], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    R = quaternion_to_rotation_matrix(annotation["camera"]["q"])
    return T @ R


def pixel_grid(h: int, w: int) -> np.ndarray:
    """(h, w, 3) pixel-center (u, v, 1) grid."""
    xs = np.linspace(0.5, w - 0.5, w, dtype=np.float32)
    ys = np.linspace(0.5, h - 0.5, h, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, ys), axis=-1)
    return np.concatenate([grid, np.ones_like(grid[..., :1])], axis=-1)


def bbox_crop(image, depth, xyz_grid):
    """Square crop around the valid-depth bbox (``utils.py:300-329``).
    All arrays (H, W, C)."""
    mask = depth[..., 0] > 0
    ys, xs = np.nonzero(mask)
    tl = np.array([ys.min(), xs.min()])
    br = np.array([ys.max(), xs.max()])
    box_size = br - tl
    img_size = np.array(mask.shape)
    assert box_size.max() <= img_size.min(), "Aspect ratio prevents square crop"

    pad_size = box_size.max() - box_size
    tl_cent = tl - pad_size // 2
    br_cent = tl_cent + box_size.max()
    if (tl_cent >= 0).all() and (br_cent <= img_size).all():
        y0, x0 = tl_cent
        y1, x1 = br_cent
    else:
        tl_far = np.clip(tl - pad_size, 0, None)
        br_far = tl_far + box_size.max()
        y0, x0 = tl_far
        y1, x1 = br_far
    sl = (slice(int(y0), int(y1)), slice(int(x0), int(x1)))
    return image[sl], depth[sl], xyz_grid[sl]


def compute_normal(depth_hw1: np.ndarray, focal_length: float) -> np.ndarray:
    """Cross-product surface normals from depth (``utils.py:236-275``).
    depth (H, W, 1) → normals (H, W, 3)."""
    depth = depth_hw1[..., 0].copy()
    mask = (depth > 0).astype(np.float32)
    depth[depth == 0] = 1e6

    h, w = depth.shape
    K_inv = np.eye(3, dtype=np.float32)
    K_inv[0, 0] = 1.0 / focal_length
    K_inv[1, 1] = 1.0 / focal_length
    grid = pixel_grid(h, w)  # (h, w, 3)
    xyd = grid * depth[..., None]
    xyz = xyd @ K_inv.T

    c = xyz[1:-1, 1:-1]
    diff_l = xyz[1:-1, :-2] - c
    diff_t = xyz[:-2, 1:-1] - c
    diff_r = xyz[1:-1, 2:] - c
    diff_b = xyz[2:, 1:-1] - c

    normal = np.zeros_like(xyz)
    n = (
        np.cross(diff_l, diff_t)
        + np.cross(diff_t, diff_r)
        + np.cross(diff_r, diff_b)
        + np.cross(diff_b, diff_l)
    ) / 4.0
    normal[1:-1, 1:-1] = n
    norm = np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / np.clip(norm, 1e-12, None)
    return normal * mask[..., None]


def resize_min_side_nearest(arr: np.ndarray, min_size: int) -> np.ndarray:
    """torchvision Resize(min_size, NEAREST): scale so the short side equals
    ``min_size``."""
    h, w = arr.shape[:2]
    if h < w:
        oh, ow = min_size, int(round(min_size * w / h))
    else:
        oh, ow = int(round(min_size * h / w)), min_size
    from midvision_probe_torch.datasets.transforms import resize_nearest

    return resize_nearest(arr, (oh, ow))


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    y0 = max((h - size) // 2, 0)
    x0 = max((w - size) // 2, 0)
    return arr[y0: y0 + size, x0: x0 + size]
