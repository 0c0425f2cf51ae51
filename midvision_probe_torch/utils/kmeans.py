"""2-means for 1-D data, scikit-learn's algorithm without scikit-learn.

MaskCut's adaptive threshold clusters the N^2 affinity values into two
groups with ``sklearn.cluster.KMeans(n_clusters=2, n_init=10)``
(``maskcut_processor.py:64-111``). The port computes the same estimator:

* the data are centred on their mean (and the centres shifted back);
* greedy k-means++ seeding: the first centre drawn uniformly, the second
  the best of ``2 + int(log 2) = 2`` candidates drawn with probability
  proportional to the squared distance to the first;
* Lloyd iterations until the labels stop changing or the squared centre
  shift falls to ``tol`` times the data's variance (``max_iter`` at most),
  then a last assignment to the final centres;
* the best of ``n_init`` runs by inertia, a run replacing the best one only
  when its inertia is lower and its clustering differs.

In one dimension a 2-clustering splits the sorted values at one index:
each Lloyd step is a search for the midpoint of the two centres in the
sorted data and a difference of prefix sums, so a step costs O(log n) after
one sort. The random draws come from the caller's
``numpy.random.Generator``; scikit-learn's come from its own generator, so
the two agree in distribution, not draw for draw. A value equally near
both centres goes to the lower one (scikit-learn: to the lower label). A
cluster that empties keeps its centre (scikit-learn moves it to a far
point); two clusters seeded on distinct data values never empty in one
dimension.
"""

from __future__ import annotations

import numpy as np


def _kmeans_plusplus(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    n = x.shape[0]
    first = x[rng.integers(n)]
    closest_dist_sq = (x - first) ** 2
    rand_vals = rng.uniform(size=2) * closest_dist_sq.sum()
    candidate_ids = np.searchsorted(np.cumsum(closest_dist_sq), rand_vals)
    np.clip(candidate_ids, None, n - 1, out=candidate_ids)
    pots = np.minimum(closest_dist_sq, (x[None, :] - x[candidate_ids, None]) ** 2).sum(axis=1)
    return np.array([first, x[candidate_ids[int(np.argmin(pots))]]])


def _split(xs: np.ndarray, lo: float, hi: float) -> int:
    """The first sorted value nearer ``hi`` than ``lo`` (``lo < hi``)."""
    return int(np.searchsorted(xs, (lo + hi) / 2, side="right"))


def _lloyd(xs: np.ndarray, csum: np.ndarray, centers: np.ndarray, tol: float,
           max_iter: int):
    """One Lloyd run from ``centers`` on the sorted values ``xs`` (prefix
    sums ``csum``, led by 0): the (lower, upper) centres and the split."""
    n = xs.shape[0]
    lo, hi = sorted(centers)
    split_old = None
    strict = False
    for _ in range(max_iter):
        split = _split(xs, lo, hi)
        new_lo = csum[split] / split if split > 0 else lo
        new_hi = (csum[n] - csum[split]) / (n - split) if split < n else hi
        shift = (new_lo - lo) ** 2 + (new_hi - hi) ** 2
        lo, hi = new_lo, new_hi
        if split == split_old:
            strict = True
            break
        if shift <= tol:
            break
        split_old = split
    if not strict:  # assign to the final centres
        split = _split(xs, lo, hi)
    return lo, hi, split


def two_means_1d(x, rng: np.random.Generator, n_init: int = 10, max_iter: int = 300,
                 tol: float = 1e-4) -> tuple[np.ndarray, float]:
    """2-means of the values ``x`` (any shape, read flat, in float64) with
    scikit-learn's defaults: the two centres (lower first) and the inertia,
    the sum of squared distances to the assigned centres."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    mean = x.mean()
    x = x - mean
    tol = x.var() * tol
    xs = np.sort(x)
    csum = np.concatenate([[0.0], np.cumsum(xs)])

    best = None
    for _ in range(n_init):
        lo, hi, split = _lloyd(xs, csum, _kmeans_plusplus(x, rng), tol, max_iter)
        inertia = float(((xs[:split] - lo) ** 2).sum() + ((xs[split:] - hi) ** 2).sum())
        if best is None or (inertia < best[2] and split != best[3]):
            best = (lo, hi, inertia, split)
    lo, hi, inertia, _ = best
    return np.array([lo, hi]) + mean, inertia
