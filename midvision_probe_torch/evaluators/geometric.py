"""Geometric correspondence evaluation cores, NAVI and ScanNet (counterpart
of the JAX package's ``evaluators/geometric.py``).

The JAX package vmaps a per-pair function over the pair batch; here every
step takes the batch dimension itself, so the whole batch's matching is one
``knn2`` call (one K4 launch on a card). ``recall_row`` turns the drivers'
errors into their CSV columns.
"""

from __future__ import annotations

import numpy as np
import torch

from midvision_probe_torch.utils.correspondence import (
    estimate_correspondence_depth,
    estimate_correspondence_xyz,
    project_3dto2d,
)
from midvision_probe_torch.utils.metrics import compute_binned_performance
from midvision_probe_torch.utils.transformations import (
    so3_rotation_angle,
    transform_points_Rt,
)


def navi_batch_errors(feats_0, feats_1, xyz_0, xyz_1, Rt_01, intrinsics,
                      num_corr: int = 500):
    """Batched NAVI pair errors.

    feats_0/1: (B, h, w, C); xyz_0/1: (B, H, W, 3); Rt_01: (B, 4, 4)
    camera-0 -> camera-1 transforms; intrinsics: (B, 3, 3) at full
    resolution, so err_2d is in full-resolution pixels.

    Returns (err_3d (B, N), err_2d (B, N), valid (B, N)). ``valid`` marks
    real matches: a pair with fewer than ``num_corr`` valid query points is
    padded with -inf-weight rows, which recalls must skip."""
    c_xyz0, c_xyz1, w, _, _ = estimate_correspondence_xyz(
        feats_0, feats_1, xyz_0, xyz_1, num_corr)
    c_xyz0in1 = transform_points_Rt(c_xyz0, Rt_01[:, :3, :4])
    err3d = torch.linalg.vector_norm(c_xyz0in1 - c_xyz1, dim=-1)
    uv1 = project_3dto2d(c_xyz1, intrinsics)
    uv0in1 = project_3dto2d(c_xyz0in1, intrinsics)
    err2d = torch.linalg.vector_norm(uv0in1 - uv1, dim=-1)
    return err3d, err2d, torch.isfinite(w)


def scannet_batch_errors(feats_0, feats_1, depth_0, depth_1, K, Rt_01,
                         num_corr: int = 500):
    """Batched ScanNet pair errors (depth unprojection).

    depth_0/1: (B, H, W); K: (B, 3, 3); Rt_01: (B, 4, 4). Returns (err_3d
    (B, N), err_2d (B, N), uv_0in0 (B, N, 2), uv_1in1 (B, N, 2), valid
    (B, N)); the uv points locate the matches for pair renders."""
    c_xyz0, c_xyz1, w = estimate_correspondence_depth(
        feats_0, feats_1, depth_0, depth_1, K, num_corr)
    c_xyz0in1 = transform_points_Rt(c_xyz0, Rt_01[:, :3, :4])
    err3d = torch.linalg.vector_norm(c_xyz0in1 - c_xyz1, dim=-1)
    uv0in0 = project_3dto2d(c_xyz0, K)
    uv1 = project_3dto2d(c_xyz1, K)
    uv0in1 = project_3dto2d(c_xyz0in1, K)
    err2d = torch.linalg.vector_norm(uv0in1 - uv1, dim=-1)
    return err3d, err2d, uv0in0, uv1, torch.isfinite(w)


def rotation_degrees(Rt: np.ndarray) -> np.ndarray:
    """Rotation angles in degrees of a (B, 4, 4) numpy batch of poses."""
    return np.degrees(so3_rotation_angle(torch.from_numpy(Rt[:, :3, :3])).numpy())


def recall_row(err_3d, err_2d, valid, rel_ang, th_3d, th_2d, logger) -> dict:
    """The results CSV's recall columns from (N_pairs, num_corr) numpy
    errors: 3D and 2D recall at each threshold over REAL matches only
    (pairs with fewer than num_corr valid points pad with rows the
    reference never emits), and the 2 cm recall binned by rotation angle
    over [0, 120] degrees (NaN for a bin without pairs)."""
    n_valid = max(int(valid.sum()), 1)
    row = {}
    for th in th_3d:
        rec = 100 * float(((err_3d < th) & valid).sum() / n_valid)
        logger.info("Recall at %.2f m: %.2f", th, rec)
        row[f"3D Recall ({th:.2f}m)"] = f"{rec:5.02f}"
    for th in th_2d:
        rec = 100 * float(((err_2d < th) & valid).sum() / n_valid)
        logger.info("Recall at %3dpx: %.2f", th, rec)
        row[f"2D Recall ({th}px)"] = f"{rec:5.02f}"
    # pairs with NO real matches contribute nothing (consistent with the
    # valid-only global recalls above) instead of deflating their bin as 0%
    has_m = valid.any(axis=1)
    rec_2cm = ((err_3d < 0.02) & valid).sum(axis=1) / np.maximum(valid.sum(axis=1), 1)
    bins = compute_binned_performance(rec_2cm[has_m], rel_ang[has_m],
                                      [0, 30, 60, 90, 120])
    for i, acc in enumerate(bins):
        row[f"Bin Rec {i * 30}-{(i + 1) * 30}°"] = f"{acc * 100:5.02f}"
    return row
