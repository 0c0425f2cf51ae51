"""K4's module of the PyTorch port (``ops/matching.py``) against the JAX
package's: the plain twin ``_knn2_plain`` against ``_knn2_xla`` and the
interpret-mode Pallas kernel, the tie order, the ratio test and the match
selection.

The JAX side runs under ``jax.default_matmul_precision("float32")``.
Tolerance: indices equal; distances within 1e-4 abs + 1e-5 rel (f32
summation order; the Pallas kernel's 3-term bf16 split differs from f32 by
~1e-6 on unit-scale distances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.ops import matching as tm
from midvision_probe_tpu.ops import matching as jm

F32 = jax.default_matmul_precision("float32")


def _pair(seed, n, m, d):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32), rng.randn(m, d).astype(np.float32)


# (n, m, d): a small multi-tile grid, a ragged target count (77 is no
# multiple of the 16-row tiles), a wide feature dim
SHAPES = [(37, 53, 19), (40, 77, 32), (24, 40, 2048)]


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_knn2_matches_jax_xla_and_pallas(metric, n, m, d):
    q, t = _pair(n + m + d, n, m, d)
    got_d, got_i = tm.knn2(torch.from_numpy(q), torch.from_numpy(t), metric)
    with F32:
        jx = jm.knn2(jnp.asarray(q), jnp.asarray(t), metric, use_pallas=False)
        jp = jm.knn2(jnp.asarray(q), jnp.asarray(t), metric, use_pallas=True,
                     interpret=True, tile_n=16, tile_m=16)
    for ref_d, ref_i in (jx, jp):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d),
                                   atol=1e-4, rtol=1e-5)


def test_knn2_plain_squared_distances_match_jax_xla_batched():
    """The twin on a (B, N, d) batch equals ``_knn2_xla`` per element."""
    rng = np.random.RandomState(5)
    q = rng.randn(3, 50, 24).astype(np.float32)
    t = rng.randn(3, 61, 24).astype(np.float32)
    got_d, got_i = tm._knn2_plain(torch.from_numpy(q), torch.from_numpy(t), chunk=16)
    assert got_d.shape == (3, 50, 2) and got_i.dtype == torch.int32
    with F32:
        for b in range(3):
            ref_d, ref_i = jm._knn2_xla(jnp.asarray(q[b]), jnp.asarray(t[b]))
            np.testing.assert_array_equal(got_i[b].numpy(), np.asarray(ref_i))
            np.testing.assert_allclose(got_d[b].numpy(), np.asarray(ref_d),
                                       atol=1e-4, rtol=1e-5)


def test_knn2_large_magnitude_queries_never_pick_padding():
    """The 990-constant queries of the JAX package's regression test: no
    index past the targets, and the same answer as both JAX paths."""
    rng = np.random.RandomState(0)
    q = np.full((4, 128), 990.0, np.float32)
    t = rng.randn(100, 128).astype(np.float32)
    got_d, got_i = tm.knn2(torch.from_numpy(q), torch.from_numpy(t), "euclidean")
    assert (got_i.numpy() < 100).all()
    with F32:
        jx = jm.knn2(jnp.asarray(q), jnp.asarray(t), "euclidean", use_pallas=False)
        jp = jm.knn2(jnp.asarray(q), jnp.asarray(t), "euclidean", use_pallas=True,
                     interpret=True, tile_m=64)
    for ref_d, ref_i in (jx, jp):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d),
                                   atol=1e-4, rtol=1e-5)


def test_knn2_ties_break_to_the_lowest_index():
    """Quarter-integer features make every distance exact in any summation
    order, so ties are real: every target row is duplicated 30 rows later
    and many distinct rows collide. The top-2 must be the two lowest
    (distance, index) pairs, as jax.lax.top_k orders them."""
    rng = np.random.RandomState(7)
    q = rng.randint(-3, 4, (20, 16)).astype(np.float32) / 4
    base = rng.randint(-3, 4, (30, 16)).astype(np.float32) / 4
    t = np.concatenate([base, base])
    full = ((q[:, None, :].astype(np.float64) - t[None]) ** 2).sum(-1)
    want = np.stack([np.lexsort((np.arange(60), row))[:2] for row in full])
    _, got_i = tm.knn2(torch.from_numpy(q), torch.from_numpy(t), "euclidean")
    np.testing.assert_array_equal(got_i.numpy(), want)
    with F32:
        _, jx = jm.knn2(jnp.asarray(q), jnp.asarray(t), "euclidean", use_pallas=False)
        _, jp = jm.knn2(jnp.asarray(q), jnp.asarray(t), "euclidean", use_pallas=True,
                        interpret=True, tile_n=16, tile_m=16)
    np.testing.assert_array_equal(np.asarray(jx), want)
    # the Pallas kernel's cross-tile merge (_merge_top2) hands a tie for
    # SECOND place to the later tile's index; its first neighbour and both
    # distances are still right
    jp = np.asarray(jp)
    np.testing.assert_array_equal(jp[:, 0], want[:, 0])
    rows = np.arange(len(q))[:, None]
    np.testing.assert_array_equal(full[rows, jp], full[rows, want])


def test_knn2_rejects_what_it_cannot_take():
    before = tm.knn2.launches
    with pytest.raises(ValueError, match="M >= 2"):
        tm.knn2(torch.zeros(3, 4), torch.zeros(1, 4))
    with pytest.raises(ValueError, match="metric"):
        tm.knn2(torch.zeros(3, 4), torch.zeros(2, 4), "cityblock")
    with pytest.raises(ValueError, match="unsupported device"):
        tm.knn2(torch.zeros(3, 4, device="meta"), torch.zeros(2, 4, device="meta"),
                "euclidean")
    tm.knn2(torch.randn(3, 4), torch.randn(5, 4))
    assert tm.knn2.launches == before  # the CPU twin is never counted


def test_ratio_test_and_topk_match_jax():
    rng = np.random.RandomState(1)
    d = np.abs(rng.randn(50, 2)).astype(np.float32)
    d.sort(axis=1)
    d[:5] = 0.0  # the 1e-9 clip
    np.testing.assert_allclose(tm.calculate_ratio_test(torch.from_numpy(d)).numpy(),
                               np.asarray(jm.calculate_ratio_test(jnp.asarray(d))),
                               atol=1e-6)
    # weights with many exact ties and -inf padding: the same order
    w = rng.randint(0, 4, 40).astype(np.float32)
    w[rng.rand(40) < 0.2] = -np.inf
    idx = rng.randint(0, 99, 40).astype(np.int32)
    got = tm.topk_matches(torch.from_numpy(w), torch.from_numpy(idx), 25)
    ref = jm.topk_matches(jnp.asarray(w), jnp.asarray(idx), 25)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("ratio_test", [True, False])
def test_get_correspondences_ratio_test_matches_jax(bidirectional, ratio_test):
    rng = np.random.RandomState(2)
    f0 = rng.randn(64, 16).astype(np.float32)
    f1 = rng.randn(80, 16).astype(np.float32)
    got = tm.get_correspondences_ratio_test(
        torch.from_numpy(f0), torch.from_numpy(f1), 10,
        bidirectional=bidirectional, ratio_test=ratio_test)
    with F32:
        ref = jm.get_correspondences_ratio_test(
            jnp.asarray(f0), jnp.asarray(f1), 10, bidirectional=bidirectional,
            ratio_test=ratio_test, use_pallas=False)
    assert got[0].shape == (10,)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-5)
