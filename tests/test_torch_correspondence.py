"""The correspondence modules of the PyTorch port against the JAX package's
on the same numpy inputs: masked ratio-test matching, the xyz and depth
correspondence estimators, the NAVI and ScanNet batch errors, grid_sample,
the SE(3) helpers, the binned recall, the synthetic pair datasets and the
NAVI and ScanNet-1500 readers.

The JAX side runs under ``jax.default_matmul_precision("float32")``, one
pair at a time (the port takes the pair batch as a dimension). Match
indices and validity must be equal; values agree within 1e-5 (f32
summation order)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from midvision_probe_torch.datasets import navi as t_navi
from midvision_probe_torch.datasets import scannet_pairs as t_scannet
from midvision_probe_torch.datasets import synthetic as t_syn
from midvision_probe_torch.evaluators import geometric as tg
from midvision_probe_torch.ops.image import grid_sample as t_grid_sample
from midvision_probe_torch.utils import correspondence as tc
from midvision_probe_torch.utils import transformations as tt
from midvision_probe_torch.utils.metrics import compute_binned_performance as t_binned
from midvision_probe_tpu.datasets import navi as j_navi
from midvision_probe_tpu.datasets import scannet_pairs as j_scannet
from midvision_probe_tpu.datasets import synthetic as j_syn
from midvision_probe_tpu.evaluators import geometric as jg
from midvision_probe_tpu.ops.image import grid_sample as j_grid_sample
from midvision_probe_tpu.utils import correspondence as jc
from midvision_probe_tpu.utils import transformations as jt
from midvision_probe_tpu.utils.metrics import compute_binned_performance as j_binned

F32 = jax.default_matmul_precision("float32")
T = torch.from_numpy


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


def _poses(rng, n):
    Rt = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    Rt[:, :3, :3] = _rotations(rng, n)
    Rt[:, :3, 3] = rng.randn(n, 3) * 0.1
    return Rt


def _intrinsics(n, f, cx, cy):
    K = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = f
    K[:, 0, 2], K[:, 1, 2] = cx, cy
    return K


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(align_corners):
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 5, 7, 6).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 3, 4, 2)).astype(np.float32)
    got = t_grid_sample(T(feats), T(grid), align_corners=align_corners)
    ref = j_grid_sample(jnp.asarray(feats), jnp.asarray(grid), align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_transformations_match_jax():
    rng = np.random.RandomState(1)
    pts = rng.randn(3, 10, 3).astype(np.float32)
    Rt = _poses(rng, 3)
    R2 = _rotations(rng, 3)
    with F32:
        for inverse in (False, True):
            np.testing.assert_allclose(
                tt.transform_points_Rt(T(pts), T(Rt[:, :3, :4]), inverse).numpy(),
                np.asarray(jt.transform_points_Rt(pts, Rt[:, :3, :4], inverse)), atol=1e-5)
        np.testing.assert_allclose(tt.so3_rotation_angle(T(Rt[:, :3, :3])).numpy(),
                                   np.asarray(jt.so3_rotation_angle(Rt[:, :3, :3])),
                                   atol=1e-5)
        np.testing.assert_allclose(
            tt.so3_relative_angle(T(Rt[:, :3, :3]), T(R2)).numpy(),
            np.asarray(jt.so3_relative_angle(Rt[:, :3, :3], R2)), atol=1e-5)


def test_compute_binned_performance_matches_jax():
    rng = np.random.RandomState(2)
    y, x = rng.rand(40), rng.uniform(0, 85, 40)  # the [90, 120) bin stays empty
    bins = [0, 30, 60, 90, 120]
    got, ref = t_binned(y, x, bins), j_binned(y, x, bins)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.isnan(got[-1]) and np.isnan(ref[-1])


def _masked_inputs(seed, B=3, N=60, M=70, C=16):
    rng = np.random.RandomState(seed)
    f0 = rng.randn(B, N, C).astype(np.float32)
    f1 = rng.randn(B, M, C).astype(np.float32)
    v0, v1 = rng.rand(B, N) > 0.2, rng.rand(B, M) > 0.3
    v1[1] = False  # no valid target: every match must come out -inf
    v1[2, 1:] = False  # one valid target: the far row is the 2nd neighbour
    return f0, f1, v0, v1


@pytest.mark.parametrize("ratio_test", [True, False])
def test_masked_correspondences_ratio_test_matches_jax(ratio_test):
    f0, f1, v0, v1 = _masked_inputs(3)
    got = tc.masked_correspondences_ratio_test(T(f0), T(f1), T(v0), T(v1), 25,
                                               ratio_test=ratio_test)
    assert torch.isinf(got[2][1]).all()
    with F32:
        for b in range(len(f0)):
            ref = jc.masked_correspondences_ratio_test(
                jnp.asarray(f0[b]), jnp.asarray(f1[b]), jnp.asarray(v0[b]),
                jnp.asarray(v1[b]), 25, ratio_test=ratio_test, use_pallas=False)
            np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(ref[0]))
            np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(ref[1]))
            np.testing.assert_allclose(got[2][b].numpy(), np.asarray(ref[2]), atol=1e-5)


def _xyz_inputs(seed, B=2, h=4, w=4, C=12, H=16, W=16):
    rng = np.random.RandomState(seed)
    feats_0 = rng.randn(B, h, w, C).astype(np.float32)
    feats_1 = rng.randn(B, h, w, C).astype(np.float32)
    xyz_0 = (rng.rand(B, H, W, 3) + 0.5).astype(np.float32)
    xyz_1 = (rng.rand(B, H, W, 3) + 0.5).astype(np.float32)
    xyz_0[:, :3, :, 2] = 0.0  # invalid rows in both views
    xyz_1[:, -2:, :, 2] = -1.0
    return feats_0, feats_1, xyz_0, xyz_1


def test_estimate_correspondence_xyz_matches_jax():
    f0, f1, x0, x1 = _xyz_inputs(4)
    got = tc.estimate_correspondence_xyz(T(f0), T(f1), T(x0), T(x1), num_corr=40)
    with F32:
        for b in range(len(f0)):
            ref = jc.estimate_correspondence_xyz(
                jnp.asarray(f0[b]), jnp.asarray(f1[b]), jnp.asarray(x0[b]),
                jnp.asarray(x1[b]), num_corr=40, use_pallas=False)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g[b].numpy(), np.asarray(r), atol=1e-5)


def _depth_inputs(seed, B=2, h=6, w=8, C=32, H=12, W=16):
    rng = np.random.RandomState(seed)
    feats_0 = rng.randn(B, h, w, C).astype(np.float32)
    feats_1 = rng.randn(B, h, w, C).astype(np.float32)
    depth_0 = (rng.rand(B, H, W) * 3 + 1).astype(np.float32)
    depth_1 = (rng.rand(B, H, W) * 3 + 1).astype(np.float32)
    depth_0[:, :2] = 0.0  # holes
    depth_1[:, :, :3] = 0.0
    K = _intrinsics(B, 0.8 * W, 0.5 * W, 0.5 * H)
    return feats_0, feats_1, depth_0, depth_1, K


def test_estimate_correspondence_depth_matches_jax():
    f0, f1, d0, d1, K = _depth_inputs(5)
    got = tc.estimate_correspondence_depth(T(f0), T(f1), T(d0), T(d1), T(K), num_corr=40)
    with F32:
        for b in range(len(f0)):
            ref = jc.estimate_correspondence_depth(
                jnp.asarray(f0[b]), jnp.asarray(f1[b]), jnp.asarray(d0[b]),
                jnp.asarray(d1[b]), jnp.asarray(K[b]), num_corr=40, use_pallas=False)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g[b].numpy(), np.asarray(r), atol=1e-5)


def test_navi_batch_errors_match_jax():
    f0, f1, x0, x1 = _xyz_inputs(6)
    rng = np.random.RandomState(6)
    Rt, K = _poses(rng, 2), _intrinsics(2, 20.0, 8.0, 8.0)
    got = tg.navi_batch_errors(T(f0), T(f1), T(x0), T(x1), T(Rt), T(K), num_corr=40)
    with F32:
        ref = jg.navi_batch_errors(jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(x0),
                                   jnp.asarray(x1), jnp.asarray(Rt), jnp.asarray(K),
                                   num_corr=40, use_pallas=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_navi_batch_errors_mask_garbage_when_few_valid():
    """Fewer valid points (32) than num_corr (50): exactly the real
    matches are valid, as in the JAX package's own test."""
    rng = np.random.RandomState(0)
    feats = rng.randn(1, 8, 8, 12).astype(np.float32)
    xyz = (rng.rand(1, 8, 8, 3) + 0.5).astype(np.float32)
    xyz[:, 4:, :, 2] = 0.0
    Rt = np.eye(4, dtype=np.float32)[None]
    K = _intrinsics(1, 20.0, 0.0, 0.0)
    e3, e2, ok = tg.navi_batch_errors(T(feats), T(feats), T(xyz), T(xyz), T(Rt), T(K),
                                      num_corr=50)
    with F32:
        _, _, j_ok = jg.navi_batch_errors(
            jnp.asarray(feats), jnp.asarray(feats), jnp.asarray(xyz), jnp.asarray(xyz),
            jnp.asarray(Rt), jnp.asarray(K), num_corr=50, use_pallas=False)
    assert int(ok.sum()) == 32
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    assert (e3[ok] < 1e-4).all()


def test_scannet_batch_errors_match_jax():
    f0, f1, d0, d1, K = _depth_inputs(7)
    Rt = _poses(np.random.RandomState(7), 2)
    got = tg.scannet_batch_errors(T(f0), T(f1), T(d0), T(d1), T(K), T(Rt), num_corr=40)
    with F32:
        ref = jg.scannet_batch_errors(jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(d0),
                                      jnp.asarray(d1), jnp.asarray(K), jnp.asarray(Rt),
                                      num_corr=40, use_pallas=False)
    for g, r in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


HARD_NAVI = dict(view_shading=True, texture_period=6.0, occlude_frac=0.1, noise=0.03,
                 photometric=0.15)
HARD_SCANNET = dict(max_angle_deg=4.0, t_scale=0.02, texture_period=6.0,
                    occlude_frac=0.1, noise=0.03)


@pytest.mark.parametrize("name,kwargs", [
    ("SyntheticNAVIPairs", {}),
    ("SyntheticNAVIPairs", HARD_NAVI),
    ("SyntheticScanNetPairs", {"image_hw": (48, 64)}),
    ("SyntheticScanNetPairs", dict(HARD_SCANNET, image_hw=(48, 64))),
])
def test_synthetic_pair_items_are_bit_identical_to_jax(name, kwargs):
    t_ds = getattr(t_syn, name)(num_instances=3, **kwargs)
    j_ds = getattr(j_syn, name)(num_instances=3, **kwargs)
    assert len(t_ds) == len(j_ds) == 3 and t_ds.name == j_ds.name
    for i in range(3):
        a, b = t_ds[i], j_ds[i]
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (name, i, k)


def test_scannet_reader_matches_jax_on_a_fabricated_layout(tmp_path):
    """The ScanNet-1500 on-disk layout (intrinsics.npz, test.npz, scene
    color/depth/pose) read by both readers: equal items, RGB within 1e-5
    (the antialiased resize sums in another order)."""
    root = str(tmp_path / "scannet_test_1500")
    rng = np.random.RandomState(4)
    scene = "scene0000_00"
    K = np.array([[578.0, 0, 319.5], [0, 578.0, 239.5], [0, 0, 1]], np.float32)
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(root, scene, sub))
    np.savez(os.path.join(root, "intrinsics.npz"), **{scene: K})
    np.savez(os.path.join(root, "test.npz"), name=np.array([[0, 0, 10, 25]], np.int64))
    for ins in (10, 25):
        Image.fromarray(rng.randint(0, 255, (120, 160, 3), dtype=np.uint8)).save(
            os.path.join(root, scene, "color", f"{ins}.jpg"))
        Image.fromarray(rng.randint(500, 5000, (120, 160)).astype(np.uint16)).save(
            os.path.join(root, scene, "depth", f"{ins}.png"))
        pose = np.eye(4)
        pose[:3, 3] = rng.rand(3)
        np.savetxt(os.path.join(root, scene, "pose", f"{ins}.txt"), pose, delimiter=" ")

    t_ds, j_ds = t_scannet.ScanNetPairsDataset(root=root), j_scannet.ScanNetPairsDataset(root=root)
    assert len(t_ds) == len(j_ds) == 1 and t_ds.name == j_ds.name
    a, b = t_ds[0], j_ds[0]
    assert a.keys() == b.keys()
    for k in a:
        if k.startswith("rgb"):
            assert a[k].shape == (480, 640, 3)
            np.testing.assert_allclose(a[k], b[k], atol=1e-5)
        else:
            np.testing.assert_array_equal(a[k], b[k])


def _navi_scene(root, obj, coll, ids, rng, wild=False):
    """One NAVI collection: downsampled JPEGs, 16-bit disparity PNGs with a
    valid blob, and annotations.json (quaternion, translation, focal)."""
    d = os.path.join(root, obj, coll)
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "depth"))
    annos = []
    for i, img_id in enumerate(ids):
        Image.fromarray(rng.randint(0, 255, (48, 64, 3), dtype=np.uint8)).save(
            os.path.join(d, "images", f"downsampled_{img_id}.jpg"))
        disp = np.zeros((48, 64), np.uint16)
        disp[8:40, 16:48] = rng.randint(20000, 60000, (32, 32))
        Image.fromarray(disp).save(os.path.join(d, "depth", f"downsampled_{img_id}.png"))
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        ann = {"filename": f"{img_id}.jpg", "image_size": [48, 64],
               "camera": {"q": q.tolist(), "t": (rng.rand(3) * 100).tolist(),
                          "focal_length": 520.0}}
        if wild:
            ann["split"] = "train" if i % 2 == 0 else "val"
        annos.append(ann)
    with open(os.path.join(d, "annotations.json"), "w") as f:
        json.dump(annos, f)


@pytest.mark.parametrize("split,pairs", [("train", True), ("test", False)])
def test_navi_reader_matches_jax_on_a_fabricated_layout(tmp_path, split, pairs):
    """The NAVI on-disk layout read by both readers: the same instances,
    pairs and items, bit for bit (both are the same numpy code)."""
    root = str(tmp_path / "navi")
    rng = np.random.RandomState(6)
    ids = [f"{i:03d}" for i in range(8)]
    for coll in ("multiview_00", "multiview_01"):
        _navi_scene(root, "schleich_lion", coll, ids, rng)
    _navi_scene(root, "schleich_lion", "wild_set", ids[:4], rng, wild=True)
    kw = dict(path=root, split=split, image_size=64, pair_dataset=pairs)
    t_ds, j_ds = t_navi.NAVI(**kw), j_navi.NAVI(**kw)
    assert len(t_ds) == len(j_ds) >= 1 and t_ds.name == j_ds.name
    for i in range(len(j_ds)):
        a, b = t_ds[i], j_ds[i]
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (i, k)
