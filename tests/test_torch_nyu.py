"""Parity of the PyTorch port's NYU reader and its transforms with the JAX
package's, on fabricated trees in the reference's on-disk layouts (the
layouts of ``tests/test_dataset_layouts.py``): the test layout
(``nyuv2_test_{i}_*``) and the GeoNet train layout (``*_image.png`` stems).

The JAX transforms call matplotlib (the hue shift of ``color_jitter``) and
cv2 (``rotate``); the port computes both in numpy. ``rotate`` is held to
cv2 by the share of pixels that differ and by where each differing pixel
reads from: the 8-adjacent neighbour of cv2's source pixel, a tie at a
rounding boundary."""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

from midvision_probe_torch.datasets import nyu as t_nyu
from midvision_probe_torch.datasets import transforms as t_tf
from midvision_probe_torch.utils.metrics import STUFF, THINGS
from midvision_probe_tpu.datasets import nyu as j_nyu
from midvision_probe_tpu.datasets import transforms as j_tf

H, W = 480, 640
ROTATE_SHARE = 1e-4  # the most pixels of an array that may differ from cv2


def make_nyu_tree(root, stems, seed=3, hw=(H, W)):
    """One frame per stem: a uint8 RGB PNG, float32 depth in 0-12 m,
    channel-first float32 normals and an npz ``panoptic_map`` with ids from
    STUFF, THINGS and neither."""
    rng = np.random.RandomState(seed)
    h, w = hw
    ids = np.array(STUFF[:4] + THINGS[:4] + (11, 40), np.int64)
    for sub in ("images", "depths", "normals", "segmentations", "metadata"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for stem in stems:
        img = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "images", f"{stem}_image.png"))
        depth = rng.rand(h, w).astype(np.float32) * 12  # some pixels > 10 m
        np.save(os.path.join(root, "depths", f"{stem}_depth.npy"), depth)
        snorm = rng.randn(3, h, w).astype(np.float32)
        snorm[:, rng.rand(h, w) < 0.05] = 0.0  # invalid normals
        np.save(os.path.join(root, "normals", f"{stem}_norm.npy"), snorm)
        np.savez(os.path.join(root, "segmentations", f"{stem}_image.npz"),
                 panoptic_map=ids[rng.randint(0, len(ids), (h, w))],
                 id2label=np.asarray({0: "wall", 1: "chair"}, dtype=object))
        np.save(os.path.join(root, "metadata", f"{stem}_metadata.npy"),
                np.asarray({"scene": "kitchen_0001"}, dtype=object))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("nyu")
    test, train = str(root / "test"), str(root / "train")
    make_nyu_tree(test, [f"nyuv2_test_{i}" for i in range(2)])
    make_nyu_tree(train, ["bathroom_0001_100", "kitchen_0002_42", "office_0003_7"], seed=4)
    return test, train


def _assert_items_equal(got, ref, image_atol=1e-6):
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k == "image":
            np.testing.assert_allclose(got[k], v, atol=image_atol, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("center_crop", [False, True])
def test_test_layout_items_match_jax(trees, center_crop):
    test, _ = trees
    j = j_nyu.NYU("/nonexistent", test, "test", center_crop=center_crop)
    t = t_nyu.NYU("/nonexistent", test, "test", center_crop=center_crop)
    assert len(t) == len(j) == 2 and t.name == j.name == "NYUv2"
    for i in range(2):
        item = t[i]
        _assert_items_equal(item, j[i])
        assert item["depth"].max() <= 10.0
        assert item["image"].shape == (H, 480 if center_crop else W, 3)


@pytest.mark.parametrize("center_crop,augment", [(False, False), (True, False),
                                                 (True, True), (False, True)])
def test_geonet_layout_items_match_jax(trees, center_crop, augment):
    """Augmentation on, ``rotateflip`` off: color jitter and the random
    resized crop from the reader's ``RandomState(0)``, items read in the same
    order (twice over, so the stream of draws goes on across items)."""
    _, train = trees
    kw = dict(center_crop=center_crop, augment_train=augment)
    j = j_nyu.NYU(train, "/nonexistent", "trainval", **kw)
    t = t_nyu.NYU(train, "/nonexistent", "trainval", **kw)
    assert t.files == j.files and len(t) == 3
    for i in (0, 1, 2, 0, 1):
        item = t[i]
        _assert_items_equal(item, j[i])
        assert item["image"].shape == (H, 480 if center_crop else W, 3)


def test_geonet_items_with_rotateflip_match_jax_but_for_rotation_ties(trees, monkeypatch):
    """With flips and rotations on, each array equals the JAX reader's
    except at most a 1e-4 share of its pixels (ties of the rotation's
    rounding against cv2); some of the items were rotated."""
    _, train = trees
    angles = []
    rotate = t_tf.rotate
    monkeypatch.setattr(t_tf, "rotate", lambda arrays, a: angles.append(a) or rotate(arrays, a))
    kw = dict(center_crop=True, augment_train=True, rotateflip=True)
    j = j_nyu.NYU(train, "/nonexistent", "train", **kw)
    t = t_nyu.NYU(train, "/nonexistent", "train", **kw)
    worst = 0.0
    for i in (0, 1, 2, 0, 1, 2, 0):
        got, ref = t[i], j[i]
        for k, v in ref.items():
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
            diff = np.abs(got[k].astype(np.float64) - v)
            if k == "image":
                diff = np.where(diff <= 1e-6, 0.0, diff)
            differing = (diff.reshape(v.shape[0], v.shape[1], -1) > 0).any(-1)
            worst = max(worst, differing.mean())
    print(f"rotateflip items: {len(angles)} rotated, largest share of differing "
          f"pixels {worst:.3e}")
    assert angles and worst <= ROTATE_SHARE


def test_color_jitter_matches_matplotlib_hsv(rng):
    """The port's numpy HSV round trip against the JAX function's
    matplotlib one, within 1e-6, over draws that apply and skip the
    jitter; and the HSV pair itself against matplotlib's."""
    from matplotlib.colors import hsv_to_rgb, rgb_to_hsv

    for seed in range(6):
        img = rng.rand(37, 53, 3).astype(np.float32)
        img[:4] = img[:4, :, :1]  # gray pixels: zero saturation
        img[4:6] = 0.0
        got = t_tf.color_jitter(img, np.random.RandomState(seed))
        ref = j_tf.color_jitter(img, np.random.RandomState(seed))
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    x = rng.rand(64, 3).astype(np.float32)
    x[:8] = x[:8, :1]
    np.testing.assert_array_equal(t_tf.rgb_to_hsv(x), rgb_to_hsv(x))
    hsv = rgb_to_hsv(x)
    hsv[0, 0] = 1.0  # the hue that rounds to sector 6
    np.testing.assert_array_equal(t_tf.hsv_to_rgb(hsv), hsv_to_rgb(hsv))


ROTATE_CASES = [((480, 640), 3), ((480, 640), 1), ((37, 53), 3), ((37, 53), 1),
                ((36, 52), 3), ((36, 52), 1), ((481, 641), 1), ((64, 64), 3)]


def test_rotate_matches_cv2_but_for_ties_to_adjacent_pixels():
    """24 seeded angles in ±10° over odd and even sizes, 1 and 3 channels:
    the port's ``rotate`` against the JAX function's cv2 warp. At most a
    1e-4 share of the pixels of each case differ, and every differing pixel
    reads a source pixel 8-adjacent to the one cv2 read (found by warping an
    image of pixel indices)."""
    rng = np.random.RandomState(11)
    total = differing = 0
    for n in range(24):
        (h, w), c = ROTATE_CASES[n % len(ROTATE_CASES)]
        angle = rng.uniform(-10, 10)
        a = rng.rand(h, w, c).astype(np.float32)
        got, = t_tf.rotate((a,), angle)
        ref, = j_tf.rotate((a,), angle)
        assert got.shape == ref.shape == a.shape and got.dtype == ref.dtype
        bad = (got != ref).any(-1)
        if bad.any():
            index = (np.arange(h * w, dtype=np.float32) + 1).reshape(h, w, 1)
            cv_src, = j_tf.rotate((index,), angle)
            m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), angle, 1.0)
            iy, ix = t_tf.warp_source_index(m, (h, w))
            cv = cv_src[..., 0][bad].astype(np.int64) - 1  # -1: cv2 read the border
            assert (cv >= 0).all()
            cy, cx = cv // w, cv % w
            assert (np.abs(iy[bad] - cy) <= 1).all() and (np.abs(ix[bad] - cx) <= 1).all()
        assert bad.mean() <= ROTATE_SHARE, (h, w, c, angle, bad.mean())
        total += h * w
        differing += int(bad.sum())
    print(f"rotate vs cv2 {cv2.__version__}: {differing} of {total} pixels differ "
          f"(share {differing / total:.3e})")


def test_rotate_matrix_and_inverse_match_cv2():
    for angle in (-9.5, -0.3, 0.0, 4.25, 10.0):
        m = cv2.getRotationMatrix2D((319.5, 239.5), angle, 1.0)
        np.testing.assert_allclose(t_tf.rotation_matrix((319.5, 239.5), angle), m,
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(t_tf.invert_affine(m), cv2.invertAffineTransform(m),
                                   rtol=0, atol=1e-12)


def test_nyu_shared_augment_and_crop_match_jax(rng):
    """The shared augmentation (flip, rotation, resized crop) and
    ``random_resized_crop`` on their own, from the same RandomState:
    the same crops (exact), the rotation within its tie share."""
    img = rng.rand(48, 40, 3).astype(np.float32)
    depth = rng.rand(48, 40, 1).astype(np.float32)
    snorm = rng.randn(48, 40, 3).astype(np.float32)
    for seed in range(8):
        got = t_tf.random_resized_crop((img, depth), np.random.RandomState(seed), (48, 48),
                                       ratio=(0.5, 3.0))
        ref = j_tf.random_resized_crop((img, depth), np.random.RandomState(seed), (48, 48),
                                       ratio=(0.5, 3.0))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        for rotateflip in (False, True):
            got = t_tf.nyu_shared_augment(img, depth, snorm, np.random.RandomState(seed),
                                          (40, 40), rotateflip)
            ref = j_tf.nyu_shared_augment(img, depth, snorm, np.random.RandomState(seed),
                                          (40, 40), rotateflip)
            for g, r in zip(got, ref):
                assert g.shape == r.shape
                assert (g != r).any(-1).mean() <= ROTATE_SHARE


def test_nyu_factory_rejects_unknown_split(trees):
    test, train = trees
    with pytest.raises(ValueError, match="split"):
        t_nyu.NYU(train, test, "val")
    with pytest.raises(FileNotFoundError):
        t_nyu.NYU("/nonexistent", test, "train")
