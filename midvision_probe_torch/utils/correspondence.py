"""Dense correspondence estimation on fixed-shape point sets (counterpart of
the JAX package's ``utils/correspondence.py``), batched over pairs.

Invalid points are never filtered out (that would make shapes depend on the
data). Instead validity is folded into the search: invalid *target* points
are displaced to a far constant, so they can never be a nearest neighbour,
and invalid *query* points get a ``-inf`` match weight, so top-k never
selects them. Matching runs through ``ops.matching.knn2`` (kernel K4 on a
card), one launch per pair batch.

Every function takes a leading batch dimension ``B`` (one entry per pair).
"""

from __future__ import annotations

import torch

from midvision_probe_torch.ops.image import grid_sample, resize
from midvision_probe_torch.ops.matching import (
    l2_normalize,
    calculate_ratio_test,
    knn2,
    topk_matches,
)

# displacement for masked-out TARGET points. Precondition: features are
# unit-normalized before use (the cosine path normalizes; a euclidean
# caller with feature magnitudes approaching ~1e3 could match invalid
# points, so scale _FAR with such a caller)
_FAR = 1.0e3


def get_grid(H: int, W: int, device=None) -> torch.Tensor:
    """Pixel-center (u, v, 1) grid, (3, H, W)."""
    xs = torch.linspace(0.5, W - 0.5, W, device=device)
    ys = torch.linspace(0.5, H - 0.5, H, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy, torch.ones_like(gx)], dim=0)


def grid_to_pointcloud(K_inv: torch.Tensor, depth: torch.Tensor,
                       grid: torch.Tensor | None = None) -> torch.Tensor:
    """Unproject depth maps (B, H, W) to camera-frame points (B, H*W, 3)."""
    B, H, W = depth.shape
    if grid is None:
        grid = get_grid(H, W, device=depth.device)
    points = depth[:, None] * grid  # (B, 3, H, W)
    return (K_inv @ points.reshape(B, 3, H * W)).transpose(1, 2)


def project_3dto2d(xyz: torch.Tensor, K_mat: torch.Tensor) -> torch.Tensor:
    """(B, n, 3) points through (B, 3, 3) intrinsics -> (B, n, 2) pixels."""
    uvd = xyz @ K_mat.transpose(-2, -1)
    return uvd[..., :2] / uvd[..., 2:3].clamp_min(1e-9)


def sample_pointcloud_features(feats_hwc: torch.Tensor, K: torch.Tensor,
                               pc: torch.Tensor, image_shape) -> torch.Tensor:
    """Bilinearly sample (B, h, w, C) features at the projections of (B, N, 3)
    points -> (B, N, C)."""
    H, W = image_shape
    uv = project_3dto2d(pc, K)
    grid = torch.stack([2 * uv[..., 0] / W - 1, 2 * uv[..., 1] / H - 1], dim=-1)
    return grid_sample(feats_hwc, grid[:, None], align_corners=False)[:, 0]


def argmax_2d(x: torch.Tensor, max_value: bool = True) -> torch.Tensor:
    """(..., H, W) -> (..., 2) (x, y) argmax (or argmin) coordinates."""
    h, w = x.shape[-2:]
    flat = x.reshape(*x.shape[:-2], h * w)
    idx = flat.argmax(-1) if max_value else flat.argmin(-1)
    return torch.stack([idx % w, idx // w], dim=-1)


def masked_correspondences_ratio_test(feats_0: torch.Tensor, feats_1: torch.Tensor,
                                      valid_0: torch.Tensor, valid_1: torch.Tensor,
                                      num_corres: int, metric: str = "cosine",
                                      ratio_test: bool = True):
    """Ratio-test matching over masked point sets (B, N, C) / (B, M, C).

    Equivalent to filtering invalid points and then running
    ``get_correspondences_ratio_test``, with the selection inside the
    search (see the module docstring). Returns ``(idx0, idx1, weights)``,
    indices into the full inputs; matches whose query point is invalid
    carry ``-inf`` weight."""
    if metric == "cosine":
        feats_0, feats_1 = l2_normalize(feats_0), l2_normalize(feats_1)
    # invalid targets -> far constant (cannot be a nearest neighbour)
    feats_1 = torch.where(valid_1[..., None], feats_1, torch.full_like(feats_1, _FAR))
    dists, idx = knn2(feats_0, feats_1, metric="euclidean")
    # a NEAREST neighbour at _FAR scale means the target view had no (or
    # not enough) valid points: without this guard the _FAR row becomes the
    # 2nd NN, the ratio weight comes out finite (~1.0, "maximally unique")
    # and garbage matches pass the isfinite(w) validity filter downstream
    far_hit = dists[..., 0] > (_FAR / 2.0)
    if metric == "cosine":
        dists = 0.5 * dists**2  # inputs were normalized: 1 - cos = 0.5 * L2^2
    # ratio_test=False: NEGATED distance so the descending top-k keeps the
    # NEAREST pairs
    weights = calculate_ratio_test(dists) if ratio_test else -dists[..., 0]
    weights = torch.where(valid_0 & ~far_hit, weights,
                          torch.full_like(weights, float("-inf")))
    return topk_matches(weights, idx[..., 0], num_corres)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, k) rows of x picked by (B, n) indices -> (B, n, k)."""
    return torch.take_along_dim(x, idx.long()[..., None], dim=1)


def estimate_correspondence_xyz(feat_0: torch.Tensor, feat_1: torch.Tensor,
                                xyz_grid_0: torch.Tensor, xyz_grid_1: torch.Tensor,
                                num_corr: int = 500, ratio_test: bool = True):
    """NAVI-style correspondence between xyz-annotated views.

    feat_0 / feat_1: (B, h, w, C) dense features, bicubic-upsampled to the
    xyz grid. xyz_grid_0/1: (B, H, W, 3) object-frame coordinates, invalid
    where z <= 0. Returns (c_xyz0, c_xyz1, c_weight, c_uv0, c_uv1)."""
    B, H, W, _ = xyz_grid_0.shape
    f0 = resize(feat_0, (H, W), mode="bicubic")
    f1 = resize(feat_1, (H, W), mode="bicubic")
    uvd = get_grid(H, W, device=xyz_grid_0.device).permute(1, 2, 0).reshape(-1, 3)
    xyz_0 = xyz_grid_0.reshape(B, -1, 3)
    xyz_1 = xyz_grid_1.reshape(B, -1, 3)
    idx0, idx1, w = masked_correspondences_ratio_test(
        f0.reshape(B, H * W, -1), f1.reshape(B, H * W, -1),
        xyz_0[..., 2] > 0, xyz_1[..., 2] > 0, num_corr, ratio_test=ratio_test)
    uv = uvd[:, :2].expand(B, -1, -1)
    return (_gather_rows(xyz_0, idx0), _gather_rows(xyz_1, idx1), w,
            _gather_rows(uv, idx0), _gather_rows(uv, idx1))


def estimate_correspondence_depth(feat_0: torch.Tensor, feat_1: torch.Tensor,
                                  depth_0: torch.Tensor, depth_1: torch.Tensor,
                                  K: torch.Tensor, num_corr: int = 500):
    """ScanNet-style correspondence from depth maps (B, H, W) and
    intrinsics (B, 3, 3); feats (B, h, w, C).
    Returns (corr_xyz0, corr_xyz1, weights)."""
    K_inv = torch.linalg.inv(K)
    xyz_0 = grid_to_pointcloud(K_inv, depth_0)
    xyz_1 = grid_to_pointcloud(K_inv, depth_1)
    f0 = sample_pointcloud_features(feat_0, K, xyz_0, depth_0.shape[1:])
    f1 = sample_pointcloud_features(feat_1, K, xyz_1, depth_1.shape[1:])
    idx0, idx1, w = masked_correspondences_ratio_test(
        f0, f1, xyz_0[..., 2] > 0, xyz_1[..., 2] > 0, num_corr)
    return _gather_rows(xyz_0, idx0), _gather_rows(xyz_1, idx1), w
