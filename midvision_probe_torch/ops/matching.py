"""Exact 2-NN search and ratio-test match selection: the hand-written CUDA
kernel K4, its plain PyTorch twin and the wrappers around them.

Counterpart of the JAX package's ``ops/matching.py`` (the Pallas TPU kernel
``_knn2_pallas`` -> ``_knn2_kernel`` and its XLA fallback ``_knn2_xla``).
The kernel source is ``csrc/knn2.cu``; its header says what bounds it on
an H100 (tensor-core operations at the protocol's shapes) and what the
design does about it.

* ``knn2(query, target, metric)``: ``(N, d)`` / ``(M, d)`` or batched
  ``(B, N, d)`` / ``(B, M, d)`` -> ``(dists, idx)``, each ``(..., N, 2)``,
  ascending. For CPU tensors it runs the plain twin; for CUDA tensors it
  launches the kernel or raises. There is no fallback.
* ``_knn2_plain``: the chunked f32 formulation of ``_knn2_xla`` (queries
  in chunks of 4096 rows, so a 19200 x 19200 matrix is never whole).
* Ties: equal distances keep the lower target index, as
  ``jax.lax.top_k`` does, in the kernel, in the twin and in
  ``topk_matches`` (a stable sort).

Constraints of the kernel: float32 (other float inputs are cast, as the JAX
package does); any d >= 1; N >= 1; M >= 2.
"""

from __future__ import annotations

import ctypes

import torch

_CHUNK = 4096  # query rows per distance block of the plain twin


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(-1)


def _top2_lowest_index(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two smallest entries of each row of ``d`` (R, M), ascending, equal
    values in increasing column order."""
    cols = torch.arange(d.shape[-1], device=d.device)
    big = d.shape[-1]
    d1 = d.amin(-1, keepdim=True)
    i1 = torch.where(d == d1, cols, big).amin(-1, keepdim=True)
    masked = d.scatter(-1, i1, float("inf"))
    d2 = masked.amin(-1, keepdim=True)
    i2 = torch.where(masked == d2, cols, big).amin(-1, keepdim=True)
    return torch.cat([d1, d2], -1), torch.cat([i1, i2], -1).to(torch.int32)


def _knn2_plain(query: torch.Tensor, target: torch.Tensor,
                chunk: int = _CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """Squared L2 2-NN, ``(B, N, d)`` x ``(B, M, d)`` -> ``(B, N, 2)`` f32
    distances and int32 indices: ``max(|q|^2 + |t|^2 - 2 q.t, 0)`` in f32
    (TF32 off on a card), chunked over queries."""
    q, t = query.float(), target.float()
    tn = _sq_norms(t)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dists, idxs = [], []
        for b in range(q.shape[0]):
            db, ib = [], []
            for lo in range(0, q.shape[1], chunk):
                qc = q[b, lo:lo + chunk]
                d = _sq_norms(qc)[:, None] + tn[b][None, :] - 2.0 * (qc @ t[b].T)
                dd, ii = _top2_lowest_index(torch.clamp_min(d, 0.0))
                db.append(dd)
                ib.append(ii)
            dists.append(torch.cat(db))
            idxs.append(torch.cat(ib))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.stack(dists), torch.stack(idxs)


def _library():
    from midvision_probe_torch.ops.cuda_build import load_library

    lib = load_library("knn2")
    if lib.mvp_knn2.argtypes is None:
        lib.mvp_knn2.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.mvp_knn2.restype = ctypes.c_int
        lib.mvp_knn2_plane_width.argtypes = [ctypes.c_int]
        lib.mvp_knn2_plane_width.restype = ctypes.c_int
    return lib


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.float().contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _knn2_cuda(query: torch.Tensor, target: torch.Tensor):
    """One launch of the kernel on ``(B, N, d)`` x ``(B, M, d)``. The
    wrapper allocates the outputs and the kernel's workspace: the bf16
    planes of q and t, which hold the hi and lo parts of each 32-feature
    chunk side by side (``mvp_knn2_plane_width(d)`` elements a row)."""
    q, t = _aligned(query), _aligned(target)
    B, N, d = q.shape
    M = t.shape[1]
    qn, tn = _sq_norms(q).contiguous(), _sq_norms(t).contiguous()
    lib = _library()
    width = lib.mvp_knn2_plane_width(d)
    q_planes = torch.empty((B, N, width), dtype=torch.bfloat16, device=q.device)
    t_planes = torch.empty((B, M, width), dtype=torch.bfloat16, device=q.device)
    dist = torch.empty((B, N, 2), dtype=torch.float32, device=q.device)
    idx = torch.empty((B, N, 2), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mvp_knn2(q.data_ptr(), t.data_ptr(), qn.data_ptr(), tn.data_ptr(),
                           q_planes.data_ptr(), t_planes.data_ptr(), dist.data_ptr(),
                           idx.data_ptr(), B, N, M, d,
                           torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn2 kernel launch failed: cudaError {err}")
    knn2.launches += 1
    return dist, idx


def _knn2_sq(query: torch.Tensor, target: torch.Tensor):
    """Squared-L2 2-NN on batched inputs: the kernel for CUDA tensors, the
    plain twin for CPU tensors."""
    if query.ndim != 3 or target.ndim != 3 or query.shape[0] != target.shape[0] \
            or query.shape[2] != target.shape[2]:
        raise ValueError(f"query (B, N, d) and target (B, M, d) expected, got "
                         f"{tuple(query.shape)} and {tuple(target.shape)}")
    if query.shape[1] < 1 or target.shape[1] < 2 or query.shape[2] < 1:
        raise ValueError(f"knn2 needs N >= 1, M >= 2, d >= 1, got "
                         f"{tuple(query.shape)} and {tuple(target.shape)}")
    if query.device != target.device:
        raise ValueError(f"query on {query.device}, target on {target.device}")
    if query.device.type == "cpu":
        return _knn2_plain(query, target)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    return _knn2_cuda(query, target)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def knn2(query: torch.Tensor, target: torch.Tensor, metric: str = "cosine"):
    """Exact 2-nearest-neighbour search.

    For ``metric='cosine'`` both sides are L2-normalised first and the
    distances are cosine distances ``1 - cos`` in ``[0, 2]``; for
    ``'euclidean'`` they are (non-squared) L2 distances. Returns
    ``(dists, idx)`` of shape ``(..., N, 2)``, sorted ascending."""
    if metric not in ("cosine", "euclidean"):
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "cosine":
        query, target = l2_normalize(query), l2_normalize(target)
    unbatched = query.ndim == 2
    if unbatched:
        query, target = query[None], target[None]
    sq_dist, idx = _knn2_sq(query, target)
    if unbatched:
        sq_dist, idx = sq_dist[0], idx[0]
    # cosine: |q - t|^2 = 2 - 2 cos  =>  1 - cos = 0.5 * |q - t|^2
    dists = 0.5 * sq_dist if metric == "cosine" else torch.sqrt(sq_dist)
    return dists, idx


knn2.launches = 0  # kernel launches (never the plain twin)


def calculate_ratio_test(dists: torch.Tensor) -> torch.Tensor:
    """Lowe ratio-test match weights, ``1 - d1 / d2``."""
    dists = dists.clamp_min(1e-9)
    return 1.0 - dists[..., 0] / dists[..., 1].clamp_min(1e-9)


def topk_matches(weights: torch.Tensor, idx: torch.Tensor, num_corres: int):
    """Top-k matches by weight, descending; equal weights keep the lower
    source index (a stable sort). Returns (idx_source, idx_target, weight)."""
    k = min(num_corres, weights.shape[-1])
    w, idx_source = torch.sort(weights, dim=-1, descending=True, stable=True)
    w, idx_source = w[..., :k], idx_source[..., :k]
    idx_target = torch.take_along_dim(idx, idx_source, dim=-1)
    return idx_source, idx_target, w


def get_correspondences_ratio_test(feats_0: torch.Tensor, feats_1: torch.Tensor,
                                   num_corres: int, metric: str = "cosine",
                                   bidirectional: bool = False, ratio_test: bool = True):
    """End-to-end match selection.

    ``ratio_test=False`` weighs a match by its NEGATED nearest distance, so
    the descending top-k keeps the nearest pairs and "higher weight =
    better match" holds on both branches."""
    dists_1, idx_1 = knn2(feats_0, feats_1, metric)
    weights_1 = calculate_ratio_test(dists_1) if ratio_test else -dists_1[..., 0]
    nn_1 = idx_1[..., 0]
    if not bidirectional:
        return topk_matches(weights_1, nn_1, num_corres)

    dists_2, idx_2 = knn2(feats_1, feats_0, metric)
    weights_2 = calculate_ratio_test(dists_2) if ratio_test else -dists_2[..., 0]
    nn_2 = idx_2[..., 0]
    m12_i1, m12_i2, m12_w = topk_matches(weights_1, nn_1, num_corres // 2)
    m21_i2, m21_i1, m21_w = topk_matches(weights_2, nn_2, num_corres // 2)
    return (torch.cat([m12_i1, m21_i1], -1), torch.cat([m12_i2, m21_i2], -1),
            torch.cat([m12_w, m21_w], -1))
