"""SPair-71k PCK evaluation of the PyTorch port (counterpart of the JAX
package's ``evaluators/spair.py``), batched over pairs.

Per pair: the source keypoints' features are sampled (``grid_sample``,
``align_corners=True``) and correlated against the dense target map; the
2D argmax of each heat map is the predicted keypoint, and its error is
measured against every target keypoint, normalised by the pair's PCK
scale. Invalid keypoints get an error of 1e3 so they never win the
nearest search; that also makes the padded keypoint slots free.

The heat product runs in full float32 (TF32 off on a card): cosine
similarities of L2-normalised features are often near ties, and a TF32
product would flip the argmax against the reference's float32 einsum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from midvision_probe_torch.ops.image import grid_sample
from midvision_probe_torch.ops.matching import l2_normalize
from midvision_probe_torch.utils.correspondence import argmax_2d


@functools.lru_cache(maxsize=64)
def _area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights of ``jax.image.resize(..., "linear", antialias=True)``
    along one axis, in float32 as it computes them: a triangle filter widened
    by the downscale factor, each output's weights normalised to sum to 1."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T.astype(f32))


def _area_resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(B, S, S') float -> (B, h, w) by ``_area_matrix`` along each axis
    that changes size."""
    x = x.float()
    if hw[0] != x.shape[1]:
        wh = torch.from_numpy(_area_matrix(x.shape[1], hw[0])).to(x.device)
        x = torch.einsum("oh,bhw->bow", wh, x)
    if hw[1] != x.shape[2]:
        ww = torch.from_numpy(_area_matrix(x.shape[2], hw[1])).to(x.device)
        x = torch.einsum("ow,bhw->bho", ww, x)
    return x


def patch_masks(segs: torch.Tensor, patch_size: int = 16, grid_hw=None) -> torch.Tensor:
    """(B, S, S) 0/1 segmentation masks -> (B, h, w) bool patch masks: a
    patch is kept where it holds more than 4 foreground pixels.

    ``grid_hw`` is the backbone's feature grid. Where it is the patch grid
    of this image (a stride-``patch_size`` conv over it), the masks are
    pooled exactly per patch, the right and bottom remainder cropped as the
    conv drops it. Otherwise (a fixed-input backbone that resized the image
    first) the foreground fraction is area-averaged into the cells, and the
    threshold stays 4 source pixels per cell."""
    b, s, _ = segs.shape
    p = patch_size
    h, w = grid_hw if grid_hw is not None else (s // p, s // p)
    if (h, w) == (s // p, s // p):
        pooled = segs[:, :h * p, :w * p].float().reshape(b, h, p, w, p).mean(dim=(2, 4))
        cell_area = float(p * p)
    else:
        pooled = _area_resize(segs, (h, w))
        cell_area = (s / h) * (s / w)
    return pooled > 4.0 / cell_area


def _heat(kp_feats: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """(B, K, C) x (B, h, w, C) -> (B, K, h, w) in full float32."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.einsum("bkc,bhwc->bkhw", kp_feats.float(), feats.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def batch_errors(feats_i, feats_j, kps_i, kps_j, thresh_scale, image_size: int,
                 masks_i=None, masks_j=None, return_heatmaps: bool = False):
    """Per-pair keypoint errors of a batch.

    Args:
        feats_i/feats_j: (B, h, w, C) L2-normalised dense features.
        kps_i/kps_j: (B, K, 3) padded keypoints in pixels and a valid flag.
        thresh_scale: (B,) PCK normalisation scale.
        masks_i/masks_j: optional (B, h, w) bool patch masks; background
            features are zeroed after the normalisation (``mask_feats``).
        return_heatmaps: also return the (B, K, h, w) similarity maps.

    Returns (error_same (B, K), error_nn (B, K), in_both (B, K), index_nn
    (B, K)) [+ heatmaps].
    """
    if masks_i is not None:
        feats_i = feats_i * masks_i[..., None].to(feats_i.dtype)
        feats_j = feats_j * masks_j[..., None].to(feats_j.dtype)
    xy_i = kps_i[..., :2] / image_size
    xy_j = kps_j[..., :2] / image_size
    kp_feats = grid_sample(feats_i, (xy_i * 2.0 - 1.0)[:, None], align_corners=True)[:, 0]
    heat = _heat(kp_feats, feats_j)
    pred = argmax_2d(heat).float() / feats_j.shape[2]  # (B, K, 2) in [0, 1]

    errors = torch.linalg.vector_norm(pred[:, :, None] - xy_j[:, None], dim=-1)
    errors = errors / thresh_scale[:, None, None]
    valid = (kps_i[:, :, None, 2] * kps_j[:, None, :, 2]) == 1
    in_both = valid.diagonal(dim1=1, dim2=2)
    errors = torch.where(valid, errors, torch.full_like(errors, 1e3))
    out = (errors.diagonal(dim1=1, dim2=2), errors.amin(-1), in_both, errors.argmin(-1))
    return (*out, heat) if return_heatmaps else out


def pair_errors(feats_i, feats_j, kps_i, kps_j, thresh_scale, image_size: int,
                mask_i=None, mask_j=None, return_heatmaps: bool = False):
    """``batch_errors`` for one pair: (h, w, C) features, (K, 3) keypoints,
    a scalar scale and optional (h, w) masks; (K,) outputs [+ (K, h, w)]."""
    masks = {} if mask_i is None else {"masks_i": mask_i[None], "masks_j": mask_j[None]}
    out = batch_errors(feats_i[None], feats_j[None], kps_i[None], kps_j[None],
                       torch.as_tensor(thresh_scale, dtype=torch.float32,
                                       device=feats_i.device).reshape(1),
                       image_size, return_heatmaps=return_heatmaps, **masks)
    return tuple(o[0] for o in out)


def make_feature_fn(backbone):
    """images (B, S, S, 3) -> L2-normalized dense features (B, h, w, C) in
    float32, the backbone's taps concatenated along channels."""

    def fn(images) -> torch.Tensor:
        maps = backbone.features(torch.as_tensor(images))
        feats = torch.cat(maps, dim=-1) if len(maps) > 1 else maps[0]
        return l2_normalize(feats.float())

    return fn
