"""Parity of the PyTorch port's SPair-71k pieces with the JAX package's:
``ops.image.center_padding`` (exact), the ``SPairDataset`` reader on the
layout of ``tests/test_spair.py`` (images within 1e-5; segmentation,
keypoints and the PCK scale exact; the pair order after the seed-20
shuffle equal, on a tree of 12 pairs), ``patch_masks`` on both branches
(equal, also the area path at 64 -> 14, 800 -> 24 and 800 -> 57 against
``jax.image.resize``), ``pair_errors`` and ``batch_errors`` with masks and
heat maps (``index_nn`` and ``in_both`` equal, errors and heat maps within
1e-5) and ``utils/correlation.py`` (1e-6).

Inputs come from a seeded numpy RandomState; f32 on both sides, the JAX
side under ``jax.default_matmul_precision("float32")``."""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from midvision_probe_torch.datasets import spair as t_spair
from midvision_probe_torch.evaluators import spair as t_eval
from midvision_probe_torch.ops import image as t_image
from midvision_probe_torch.utils import correlation as t_corr
from midvision_probe_tpu.datasets import spair as j_spair
from midvision_probe_tpu.evaluators import spair as j_eval
from midvision_probe_tpu.ops import image as j_image
from midvision_probe_tpu.utils import correlation as j_corr

F32 = jax.default_matmul_precision("float32")


def make_spair_tree(root, pairs_per_class, seed, classes=("cat",), size=(48, 64),
                    n_kps=6):
    """A SPair-71k tree in the reference layout: per class ``2 *
    pairs_per_class`` views (a JPEG, a class-id segmentation PNG with the
    object inside a box, an ImageAnnotation JSON whose keypoints lie on the
    object, some ``null``) and ``pairs_per_class`` test pairs over
    viewpoint differences 0, 1 and 2, each with its ``src_bndbox``,
    ``trg_bndbox`` and ``trg_imsize``."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "PairAnnotation", "test"), exist_ok=True)
    h, w = size
    boxes, n_pairs = {}, 0
    for cls in classes:
        for sub in ("JPEGImages", "Segmentation", "ImageAnnotation"):
            os.makedirs(os.path.join(root, sub, cls), exist_ok=True)
        for v in range(2 * pairs_per_class):
            view = f"{cls}{v:04d}"
            x0, y0 = rng.randint(1, w // 4), rng.randint(1, h // 4)
            x1, y1 = rng.randint(3 * w // 4, w - 1), rng.randint(3 * h // 4, h - 1)
            boxes[view] = [int(x0), int(y0), int(x1), int(y1)]
            coarse = rng.randint(0, 256, (max(h // 8, 2), max(w // 8, 2), 3), dtype=np.uint8)
            img = Image.fromarray(coarse).resize((w, h), Image.BICUBIC)
            img.save(os.path.join(root, "JPEGImages", cls, f"{view}.jpg"), quality=90)
            seg = np.zeros((h, w), np.uint8)
            seg[y0:y1, x0:x1] = t_spair.CLASS_IDS[cls]
            seg[0, 0] = 21  # another class's pixel
            Image.fromarray(seg).save(os.path.join(root, "Segmentation", cls, f"{view}.png"))
            kps = {str(k): (None if rng.rand() < 0.25 else
                            [int(rng.randint(x0, x1)), int(rng.randint(y0, y1))])
                   for k in range(n_kps)}
            with open(os.path.join(root, "ImageAnnotation", cls, f"{view}.json"), "w") as f:
                json.dump({"filename": f"{view}.jpg", "kps": kps}, f)
        for p in range(pairs_per_class):
            src, trg = f"{cls}{2 * p:04d}", f"{cls}{2 * p + 1:04d}"
            pair = {"filename": f"{n_pairs:06d}-{src}-{trg}:{cls}", "category": cls,
                    "viewpoint_variation": p % 3, "src_bndbox": boxes[src],
                    "trg_bndbox": boxes[trg], "trg_imsize": [w, h, 3]}
            with open(os.path.join(root, "PairAnnotation", "test", f"{n_pairs:06d}.json"),
                      "w") as f:
                json.dump(pair, f)
            n_pairs += 1
    return str(root)


@pytest.fixture(scope="module")
def spair_root(tmp_path_factory):
    """The one-pair tree of ``tests/test_spair.py``."""
    root = tmp_path_factory.mktemp("spair")
    rng = np.random.RandomState(0)
    cls, class_id = "cat", 8
    for sub in ("JPEGImages", "Segmentation", "ImageAnnotation"):
        os.makedirs(root / sub / cls)
    os.makedirs(root / "PairAnnotation" / "test")
    kps = {"v0": {"0": [10, 12], "1": [30, 20], "2": None},
           "v1": {"0": [14, 16], "1": [28, 24], "2": None}}
    for v in ("v0", "v1"):
        img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "JPEGImages" / cls / f"{v}.jpg")
        seg = np.zeros((48, 64), np.uint8)
        seg[8:40, 8:48] = class_id
        Image.fromarray(seg).save(root / "Segmentation" / cls / f"{v}.png")
        with open(root / "ImageAnnotation" / cls / f"{v}.json", "w") as f:
            json.dump({"filename": f"{v}.jpg", "kps": kps[v]}, f)
    pair = {"filename": f"pair-v0-v1:{cls}", "category": cls, "viewpoint_variation": 0,
            "src_bndbox": [8, 8, 48, 40], "trg_bndbox": [8, 8, 48, 40],
            "trg_imsize": [64, 48]}
    with open(root / "PairAnnotation" / "test" / "p0.json", "w") as f:
        json.dump(pair, f)
    return str(root)


# ---------------------------------------------------------- center padding
@pytest.mark.parametrize("hw,patch", [((17, 23), 8), ((31, 16), 16), ((29, 30), 14),
                                      ((32, 48), 16), ((1, 5), 4)])
def test_center_padding_matches_jax(rng, hw, patch):
    x = rng.randn(2, *hw, 3).astype(np.float32)
    got = t_image.center_padding(torch.from_numpy(x), patch).numpy()
    ref = np.asarray(j_image.center_padding(jnp.asarray(x), patch))
    assert got.shape == ref.shape
    assert got.shape[1] % patch == 0 and got.shape[2] % patch == 0
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------------ reader
def _assert_items_match(got, ref):
    assert list(got) == list(ref)
    np.testing.assert_allclose(got["img_i"], ref["img_i"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["img_j"], ref["img_j"], atol=1e-5, rtol=0)
    for k in ("seg_i", "seg_j", "kps_i", "kps_j", "thresh_scale"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["class_name"] == ref["class_name"]


@pytest.mark.parametrize("use_bbox", [False, True])
@pytest.mark.parametrize("image_size", [64, 100])
def test_spair_item_matches_jax(spair_root, use_bbox, image_size):
    kw = dict(image_size=image_size, use_bbox=use_bbox)
    got = t_spair.SPairDataset(spair_root, "test", **kw)
    ref = j_spair.SPairDataset(spair_root, "test", **kw)
    assert len(got) == len(ref) == 1
    _assert_items_match(got[0], ref[0])
    assert got[0]["img_i"].shape == (image_size, image_size, 3)
    if not use_bbox:
        assert got[0]["thresh_scale"] == np.float32(40 / 64)


def test_spair_pair_order_and_items_match_jax(tmp_path):
    """12 pairs over 2 classes: the seed-20 shuffle keeps the same pairs in
    the same order (also filtered by class and viewpoint difference), and
    the port leaves Python's global generator as it was."""
    root = make_spair_tree(tmp_path / "spair", 6, seed=3, classes=("cat", "dog"),
                           size=(40, 56))
    for kw in (dict(num_instances=7), dict(num_instances=12), dict(num_instances=None),
               dict(num_instances=3, class_name="dog"), dict(num_instances=5, vp_diff=1)):
        random.seed(1234)
        state = random.getstate()
        got = t_spair.SPairDataset(root, "test", image_size=48, use_bbox=False, **kw)
        assert random.getstate() == state
        ref = j_spair.SPairDataset(root, "test", image_size=48, use_bbox=False, **kw)
        assert [p["filename"] for p in got.instances] == [p["filename"] for p in ref.instances]
        assert len(got) == min(kw["num_instances"] or 12, len(ref.instances))
    assert len(got) == 4  # vp_diff 1: pairs 1 and 4 of each class, under the cap of 5
    for i in range(len(got)):
        _assert_items_match(got[i], ref[i])
    full = t_spair.SPairDataset(root, "test", image_size=48, use_bbox=True)
    assert len(full) == 12 and full.instances != got.instances


# ------------------------------------------------------------- patch masks
@pytest.mark.parametrize("s,patch,grid", [
    (64, 16, None), (64, 14, None), (30, 7, None), (800, 16, None),
    (64, 16, (14, 14)), (800, 16, (24, 24)), (800, 14, (57, 57)), (48, 16, (5, 7)),
])
def test_patch_masks_match_jax(rng, s, patch, grid):
    segs = np.zeros((2, s, s), np.float32)
    gh, gw = grid or (s // patch, s // patch)
    for b in range(2):  # a few random boxes, and scattered pixels near the
        for _ in range(3):  # threshold's 4 per cell
            y0, x0 = rng.randint(0, s - 2, 2)
            y1, x1 = y0 + rng.randint(1, s // 2), x0 + rng.randint(1, s // 2)
            segs[b, y0:y1, x0:x1] = 1.0
        segs[b][rng.rand(s, s) < 4.0 * gh * gw / s**2] = 1.0
    got = t_eval.patch_masks(torch.from_numpy(segs), patch, grid_hw=grid).numpy()
    ref = np.asarray(j_eval.patch_masks(jnp.asarray(segs), patch, grid_hw=grid))
    assert got.dtype == ref.dtype == bool
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert got.any() and not got.all()


@pytest.mark.parametrize("s,out", [(64, 14), (800, 24), (800, 57), (48, 5), (30, 30)])
def test_area_resize_matches_jax_image_resize(rng, s, out):
    x = rng.rand(2, s, s).astype(np.float32)
    got = t_eval._area_resize(torch.from_numpy(x), (out, out)).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, out, out), method="linear",
                                      antialias=True))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


# ------------------------------------------------------------------ errors
def _error_inputs(rng, B=3, h=8, w=8, C=16, K=30, image_size=128):
    def feats():
        f = rng.randn(B, h, w, C).astype(np.float32)
        return f / np.linalg.norm(f, axis=-1, keepdims=True)

    kps = []
    for _ in range(2):
        k = np.zeros((B, K, 3), np.float32)
        n = 7
        k[:, :n, :2] = rng.rand(B, n, 2) * (image_size - 1)
        k[:, :n, 2] = (rng.rand(B, n) > 0.2).astype(np.float32)
        kps.append(k)
    masks = rng.rand(2, B, h, w) > 0.3
    thresh = (rng.rand(B) * 0.5 + 0.3).astype(np.float32)
    return feats(), feats(), kps[0], kps[1], thresh, masks[0], masks[1]


@pytest.mark.parametrize("masked", [False, True])
def test_batch_errors_match_jax(rng, masked):
    fi, fj, ki, kj, th, mi, mj = _error_inputs(rng)
    masks_t = {"masks_i": torch.from_numpy(mi), "masks_j": torch.from_numpy(mj)} if masked else {}
    masks_j = {"masks_i": jnp.asarray(mi), "masks_j": jnp.asarray(mj)} if masked else {}
    got = t_eval.batch_errors(*map(torch.from_numpy, (fi, fj, ki, kj, th)), 128,
                              return_heatmaps=True, **masks_t)
    with F32:
        ref = j_eval.batch_errors(*map(jnp.asarray, (fi, fj, ki, kj, th)), 128,
                                  return_heatmaps=True, **masks_j)
    got = [g.numpy() for g in got]
    ref = [np.asarray(r) for r in ref]
    names = ("error_same", "error_nn", "in_both", "index_nn", "heat")
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape, name
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    for i in (0, 1, 4):
        np.testing.assert_allclose(got[i], ref[i], atol=1e-5, rtol=0, err_msg=names[i])
    assert got[2].any() and (got[0] == 1e3).any()  # valid and padded slots both present
    if masked:
        assert (got[4].transpose(0, 2, 3, 1)[~mj] == 0).all()
    # without heat maps: the same four outputs
    plain = t_eval.batch_errors(*map(torch.from_numpy, (fi, fj, ki, kj, th)), 128, **masks_t)
    assert len(plain) == 4
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())


def test_pair_errors_match_jax(rng):
    fi, fj, ki, kj, th, mi, mj = _error_inputs(rng, B=1, h=6, w=9)
    got = t_eval.pair_errors(*(torch.from_numpy(a[0]) for a in (fi, fj, ki, kj)), float(th[0]),
                             128, mask_i=torch.from_numpy(mi[0]),
                             mask_j=torch.from_numpy(mj[0]), return_heatmaps=True)
    with F32:
        ref = j_eval.pair_errors(*(jnp.asarray(a[0]) for a in (fi, fj, ki, kj)), th[0], 128,
                                 mask_i=jnp.asarray(mi[0]), mask_j=jnp.asarray(mj[0]),
                                 return_heatmaps=True)
    assert len(got) == len(ref) == 5
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for i in (0, 1, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), atol=1e-5, rtol=0)


# ------------------------------------------------------------- correlation
def test_pairwise_distances_match_jax(rng):
    s = rng.randn(20, 32).astype(np.float32) * 0.1
    t = rng.randn(13, 32).astype(np.float32) * 0.1
    got = t_corr.compute_pw_distances(s, t).numpy()
    ref = np.asarray(j_corr.compute_pw_distances(s, t))
    assert got.dtype == np.float32 and got.shape == (20, 13)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    got = t_corr.compute_pw_distances(s).numpy()
    ref = np.asarray(j_corr.compute_pw_distances(s))
    off = ~np.eye(20, dtype=bool)
    np.testing.assert_allclose(got[off], ref[off], atol=1e-6, rtol=0)
    # the diagonal is the root of each product's rounding, clipped at 0
    assert (got.diagonal() >= 0).all() and got.diagonal().max() < 1e-3


@pytest.mark.parametrize("method", ["pearson", "spearman"])
def test_correlations_match_jax(rng, method):
    a = rng.rand(9, 9)
    b = a + rng.randn(9, 9) * 0.3
    np.testing.assert_allclose(t_corr.compute_row_correlation(a, b, method),
                               j_corr.compute_row_correlation(a, b, method), atol=1e-6)
    np.testing.assert_allclose(t_corr.compute_uppertriangle_correlation(a, b, method),
                               j_corr.compute_uppertriangle_correlation(a, b, method), atol=1e-6)
    np.testing.assert_array_equal(t_corr.upper(a), j_corr.upper(a))
    for use_upper in (False, True):
        assert t_corr.matrix_distance(torch.from_numpy(a), b, use_upper) == \
            j_corr.matrix_distance(a, b, use_upper)
