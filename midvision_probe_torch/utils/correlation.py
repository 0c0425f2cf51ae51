"""Representational-similarity utilities (counterpart of the JAX package's
``utils/correlation.py``): a pairwise distance matrix computed with torch,
and row-wise and upper-triangle Pearson and Spearman correlations through
scipy."""

from __future__ import annotations

import numpy as np
import scipy.stats
import torch


def compute_pw_distances(source_feat, target_feat=None) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) L2 distances in float32, the squared
    distances clipped at 0 before the square root (TF32 off on a card)."""
    s = torch.as_tensor(source_feat, dtype=torch.float32)
    t = s if target_feat is None else torch.as_tensor(target_feat, dtype=torch.float32,
                                                      device=s.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dot = s @ t.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    sq = (s * s).sum(1)[:, None] + (t * t).sum(1)[None, :] - 2.0 * dot
    return torch.sqrt(sq.clamp_min(0.0))


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _corr_func(method: str):
    assert method in ("pearson", "spearman")
    return getattr(scipy.stats, f"{method}r")


def compute_row_correlation(mat_a, mat_b, method="pearson") -> float:
    """The mean over rows of each row's correlation."""
    corr_func = _corr_func(method)
    mat_a, mat_b = _numpy(mat_a), _numpy(mat_b)
    return float(np.mean([corr_func(mat_a[i], mat_b[i])[0] for i in range(mat_a.shape[0])]))


def upper(matrix) -> np.ndarray:
    """The values above the diagonal (k=1), row by row."""
    matrix = _numpy(matrix)
    n, m = matrix.shape
    return matrix[np.triu_indices(n=n, m=m, k=1)]


def compute_uppertriangle_correlation(mat_a, mat_b, method="pearson") -> float:
    return float(_corr_func(method)(upper(mat_a), upper(mat_b))[0])


def matrix_distance(matrix_a, matrix_b, use_upper=False) -> str:
    """Spearman and Pearson correlation of two distance matrices, as
    ``"S:<s> P:<p>"``."""
    if use_upper:
        s = compute_uppertriangle_correlation(matrix_a, matrix_b, "spearman")
        p = compute_uppertriangle_correlation(matrix_a, matrix_b, "pearson")
    else:
        s = compute_row_correlation(matrix_a, matrix_b, "spearman")
        p = compute_row_correlation(matrix_a, matrix_b, "pearson")
    return f"S:{s:.3f} P:{p:.3f}"
