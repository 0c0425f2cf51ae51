"""MaskCut, its 2-means and the DenseCRF in the PyTorch port against the JAX
package's (``models/maskcut.py``, ``models/crf.py``) and scikit-learn:

* ``utils/kmeans.py`` against ``sklearn.cluster.KMeans(n_clusters=2)`` on
  an affinity matrix's values: run to convergence (``tol=0``) both find
  the same centres and inertia (within 1e-12 relative); at the default ``tol`` scikit-learn's tau (the mean of the two
  centres) moves from seed to seed around the converged tau (up to 2.6e-3
  on this data, six seeds), and the port's tau for eight seeds lies within
  twice scikit-learn's largest distance from it;
* affinity, eigenvector, bipartition, ``detect_box`` and
  ``maskcut_forward`` (three masks) with the same features in both
  packages (through ``feature_extractor_fn``): equal, the features built so
  that no affinity lies near tau; tau is the mean of the centres even when
  they are closer than the fallback's threshold (the reference's quirk);
* ``densecrf`` against the JAX package's native path on synthetic images:
  at least 99.9% of the pixels equal;
* ``process_image`` end to end at ``fixed_size`` 128 on ``test_tiny_vit``
  with the JAX backbone's weights: combined masks agreeing on at least 99%
  of the pixels and as many boxes;
* the port's CRF build refuses to fall back: a missing source, a source
  that does not compile and a non-zero return from the library raise, and
  the library it loads is the one it built under ``build/densecrf``;
* the library's name changes with the compiler's ``-march=native`` target,
  so a build copied from another CPU is not loaded."""

import shutil

import jax
import numpy as np
import pytest
from sklearn.cluster import KMeans

from midvision_probe_torch.convert.from_jax import vit_state_dict
from midvision_probe_torch.models import crf as t_crf
from midvision_probe_torch.models import maskcut as t_maskcut
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_torch.utils.kmeans import two_means_1d
from midvision_probe_tpu.models import crf as j_crf
from midvision_probe_tpu.models import maskcut as j_maskcut
from midvision_probe_tpu.models import zoo as j_zoo

F32 = jax.default_matmul_precision("float32")


def _affinity(n, seed=0, channels=32):
    """The cosine affinity of ``n`` random features, a third of them pulled
    one way: two overlapping groups of values."""
    rng = np.random.RandomState(seed)
    f = rng.randn(channels, n)
    f[:4, : n // 3] += 3.0
    f = f / np.linalg.norm(f, axis=0, keepdims=True)
    return (f.T @ f).astype(np.float64)


def test_kmeans_converges_to_sklearns_clustering():
    """In one dimension the two centres fix the partition (the values below
    their midpoint and the rest), so equal centres and inertia are the same
    clustering."""
    values = _affinity(200).reshape(-1, 1)
    sk = KMeans(n_clusters=2, n_init=10, tol=0, random_state=0).fit(values)
    centers, inertia = two_means_1d(values, np.random.default_rng(0), tol=0)
    np.testing.assert_allclose(centers, np.sort(sk.cluster_centers_.ravel()), rtol=1e-12)
    np.testing.assert_allclose(inertia, sk.inertia_, rtol=1e-12)


def test_kmeans_tau_lies_within_sklearns_spread():
    """scikit-learn stops a run once the squared centre shift falls to
    1e-4 times the data's variance, short of the converged clustering, so
    its tau moves from seed to seed; the port's tau stays within twice
    scikit-learn's largest distance from the converged tau."""
    values = _affinity(200).reshape(-1, 1)
    converged = KMeans(n_clusters=2, n_init=10, tol=0, random_state=0).fit(values)
    tau0 = converged.cluster_centers_.mean()
    sk_taus = [KMeans(n_clusters=2, n_init=10, random_state=s).fit(values)
               .cluster_centers_.mean() for s in range(6)]
    spread = max(abs(t - tau0) for t in sk_taus)
    assert 0 < spread < 1e-2
    taus = [two_means_1d(values, np.random.default_rng(s))[0].mean() for s in range(8)]
    assert all(abs(t - tau0) <= 2 * spread for t in taus), (tau0, sk_taus, taus)


def _object_features(dims=(16, 16), channels=8, seed=0):
    """(C, N) features constant (plus small noise) on each of three
    rectangles and on the background: affinities near 1 within a region and
    far from it across regions."""
    rng = np.random.RandomState(seed)
    region = np.zeros(dims, int)
    region[2:7, 2:8] = 1
    region[9:14, 3:9] = 2
    region[4:12, 10:15] = 3
    protos = rng.randn(channels, 4) * 3
    return protos[:, region.reshape(-1)] + rng.randn(channels, dims[0] * dims[1]) * 0.05


def test_spectral_steps_match_jax():
    feats = _object_features()
    dims = [16, 16]
    tproc = t_maskcut.MaskCutProcessor(feature_extractor_fn=lambda x: feats, patch_size=8,
                                       fixed_size=128)
    jproc = j_maskcut.MaskCutProcessor(feature_extractor_fn=lambda x: feats, patch_size=8,
                                       fixed_size=128)
    tA, tD = tproc.get_affinity_matrix(feats, 0.15)
    jA, jD = jproc.get_affinity_matrix(feats, 0.15)
    np.testing.assert_array_equal(tA, jA)
    np.testing.assert_array_equal(tD, jD)
    tvec, tsecond = tproc.second_smallest_eigenvector(tA, tD)
    jvec, jsecond = jproc.second_smallest_eigenvector(jA, jD)
    np.testing.assert_array_equal(tsecond, jsecond)
    bip = tproc.get_salient_areas(tsecond)
    np.testing.assert_array_equal(bip, jproc.get_salient_areas(jsecond))
    assert tproc.check_num_fg_corners(bip, dims) == jproc.check_num_fg_corners(bip, dims)
    seed = int(np.argmax(np.abs(tsecond)))
    tbox = tproc.detect_box(bip.reshape(dims).astype(float), seed, dims, [128, 128], [8, 8])
    jbox = jproc.detect_box(bip.reshape(dims).astype(float), seed, dims, [128, 128], [8, 8])
    assert tbox[0] == jbox[0] and tbox[1] == jbox[1]
    np.testing.assert_array_equal(tbox[2], jbox[2])

    tout = tproc.maskcut_forward(feats, dims, [8, 8], [128, 128], 3)
    jout = jproc.maskcut_forward(feats, dims, [8, 8], [128, 128], 3)
    assert tout[0] == jout[0]
    assert len(tout[1]) == len(jout[1]) == 3
    for t, j in zip(tout[1] + tout[2], jout[1] + jout[2]):
        np.testing.assert_array_equal(t, j)
    assert all(b.sum() > 0 for b in tout[1])  # three objects found


def test_tau_is_the_mean_of_the_centres_even_when_they_are_close():
    rng = np.random.RandomState(3)
    feats = np.ones((8, 64)) + rng.randn(8, 64) * 0.01  # affinities all near 1
    proc = t_maskcut.MaskCutProcessor(feature_extractor_fn=lambda x: feats)
    A, _ = proc.get_affinity_matrix(feats, 0.15)
    f = feats / np.linalg.norm(feats, axis=0, keepdims=True)
    raw = f.T @ f
    centers, _ = two_means_1d(raw, np.random.default_rng(0))  # the processor's draws
    assert abs(centers[0] - centers[1]) < 0.3  # the reference's fallback would apply
    np.testing.assert_array_equal(A, np.where(raw > centers.mean(), 1.0, 1e-5))


def _synthetic_image(h=96, w=128, seed=0):
    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w, 3) * 60).astype(np.uint8)
    img[20:70, 30:90] = [200, 40, 40]
    img[10:30, 95:120] = [40, 180, 60]
    return img


def test_densecrf_matches_the_jax_native_path():
    assert j_crf._load_native() is not None  # the JAX side is on its native path
    rng = np.random.RandomState(1)
    for img, mask in [
        (_synthetic_image(), (rng.rand(12, 16) > 0.5).astype(np.float64)),
        ((rng.rand(120, 100, 3) * 255).astype(np.uint8), rng.rand(30, 25)),
    ]:
        got, ref = t_crf.densecrf(img, mask), j_crf.densecrf(img, mask)
        assert got.shape == ref.shape == img.shape[:2] and got.dtype == np.float32
        agree = (got == ref).mean()
        assert agree >= 0.999, agree
    assert t_crf.BUILD_INFO["path"].startswith(str(t_crf.BUILD_DIR))


def test_process_image_matches_jax(monkeypatch):
    jext = j_zoo.build_vit_extractor("test_tiny_vit", output="dense", init_size=64)
    jvars = jax.tree_util.tree_map(np.asarray, jext.variables)

    def load_jax_vit(module, seed=0):
        module.load_state_dict(vit_state_dict(jvars))
        return module

    monkeypatch.setattr(t_zoo, "random_init", load_jax_vit)
    text = t_zoo.build_vit_extractor("test_tiny_vit", output="dense", device="cpu")
    img = _synthetic_image()
    tproc = t_maskcut.MaskCutProcessor(backbone=text, patch_size=8, fixed_size=128)
    jproc = j_maskcut.MaskCutProcessor(backbone=jext, patch_size=8, fixed_size=128)
    tboxes, tmasks, tcomb = tproc.process_image(img, 2)
    with F32:
        jboxes, jmasks, jcomb = jproc.process_image(img, 2)
    assert tcomb.shape == jcomb.shape == img.shape[:2] and tcomb.dtype == bool
    assert (tcomb == jcomb).mean() >= 0.99
    assert len(tboxes) == len(jboxes) and len(tmasks) == len(jmasks)
    for b in tboxes:
        assert len(b) == 4


def test_crf_build_refuses_to_fall_back(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="DenseCRF source missing"):
        t_crf.build_densecrf(src_dir=tmp_path / "absent", build_dir=tmp_path / "build")
    broken = tmp_path / "broken"
    shutil.copytree(t_crf.NATIVE_DIR, broken, ignore=shutil.ignore_patterns("*.so"))
    with open(broken / "densecrf.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="building the DenseCRF library failed"):
        t_crf.build_densecrf(src_dir=broken, build_dir=tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))

    class FailingLib:
        class dense_crf_inference:  # noqa: N801 — stands in for the C function
            def __new__(cls, *args):
                return 3

    monkeypatch.setattr(t_crf, "load_densecrf", lambda: FailingLib)
    with pytest.raises(RuntimeError, match="returned 3"):
        t_crf.densecrf(_synthetic_image(), np.ones((4, 4)))


def test_crf_library_is_named_by_the_host_target(monkeypatch):
    here = t_crf.library_path()
    assert here.parent == t_crf.BUILD_DIR and here.name.startswith("libdensecrf_")
    assert b"-march=" in t_crf._host_target(t_crf._compiler())
    monkeypatch.setattr(t_crf, "_host_target", lambda compiler: b"another CPU")
    assert t_crf.library_path() != here
