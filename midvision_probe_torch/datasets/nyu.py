"""NYUv2 depth/normals dataset (copy of the JAX package's
``datasets/nyu.py``; reference ``evals/datasets/nyu.py``), numpy
channel-last.

Same on-disk layouts:

* test: ``<test_path>/{images,depths,normals,segmentations,metadata}/``
  with ``nyuv2_test_{i}_*`` files (``nyu.py:78-138``),
* train: ``<train_path>/{images,depths,normals,segmentations}/`` with
  ``*_image.png`` stems (GeoNet crops, cut to ``[:480, :640]``,
  ``nyu.py:184-251``).

Items: image (H, W, 3) float32 normalized, depth (H, W, 1) with depth
> 10 m zeroed (``nyu.py:118,208``), snorm (H, W, 3) (channel-first normals
transposed), segmentation (H, W) int32 from the npz's ``panoptic_map``;
optional 480x480 center crop (x-slice 80:-80, ``nyu.py:121-126``). The
train reader draws its augmentation from ``RandomState(0)`` per instance,
as the JAX reader does.
"""

from __future__ import annotations

import os

import numpy as np

from midvision_probe_torch.datasets.transforms import (
    color_jitter,
    normalize_image,
    nyu_shared_augment,
    resize_nearest,
)

MAX_DEPTH = 10.0


def NYU(train_path, test_path, split, name="nyu", image_mean="imagenet",
        center_crop=False, rotateflip=False, augment_train=False):
    """Factory with the reference signature (``nyu.py:10-31``); the readers
    name themselves ``NYUv2`` whatever ``name`` says, as the JAX ones do."""
    if split not in ("train", "trainval", "valid", "test"):
        raise ValueError(f"unknown NYU split {split!r}")
    if split == "test":
        return NYUTest(test_path, image_mean, center_crop)
    return NYUGeonet(train_path, split, image_mean, center_crop, augment_train,
                     rotateflip)


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as f:
        return np.array(f.convert("RGB"))


def _chw_to_hwc(snorm: np.ndarray) -> np.ndarray:
    if snorm.ndim == 3 and snorm.shape[0] == 3:
        return snorm.transpose(1, 2, 0)
    return snorm


class NYUTest:
    def __init__(self, base_path, image_mean="imagenet", center_crop=False):
        self.name = "NYUv2"
        self.base_path = base_path
        self.image_mean = image_mean
        self.center_crop = center_crop
        self.max_depth = MAX_DEPTH
        image_dir = os.path.join(base_path, "images")
        if not os.path.isdir(image_dir):
            raise FileNotFoundError(
                f"NYUv2 test data not found at {base_path} — expected the "
                "processed layout of the reference (images/depths/normals/"
                "segmentations).")
        self.num_instances = len(os.listdir(image_dir))

    def __len__(self):
        return self.num_instances

    def __getitem__(self, index):
        b, stem = self.base_path, f"nyuv2_test_{index}"
        image = _read_rgb(os.path.join(b, "images", f"{stem}_image.png"))
        depth = np.load(os.path.join(b, "depths", f"{stem}_depth.npy"))
        snorm = np.load(os.path.join(b, "normals", f"{stem}_norm.npy"))
        with np.load(os.path.join(b, "segmentations", f"{stem}_image.npz"),
                     allow_pickle=True) as npz:
            seg = npz["panoptic_map"]

        image = normalize_image(image, self.image_mean)
        depth = np.where(depth > self.max_depth, 0.0, depth).astype(np.float32)
        snorm = _chw_to_hwc(snorm)
        if self.center_crop:
            image, depth = image[:, 80:-80], depth[:, 80:-80]
            snorm, seg = snorm[:, 80:-80], seg[:, 80:-80]
        return {
            "image": image.astype(np.float32),
            "depth": depth[..., None].astype(np.float32),
            "snorm": snorm.astype(np.float32),
            "segmentation": seg.astype(np.int32),
        }


class NYUGeonet:
    def __init__(self, base_path, split, image_mean="imagenet",
                 center_crop=False, augment_train=False, rotateflip=False):
        self.name = "NYUv2"
        self.base_path = base_path
        self.image_mean = image_mean
        self.center_crop = center_crop
        self.augment = augment_train and "train" in split
        self.rotateflip = rotateflip
        self.max_depth = MAX_DEPTH
        self.image_size = (480, 480) if center_crop else (480, 640)

        image_dir = os.path.join(base_path, "images")
        if not os.path.isdir(image_dir):
            raise FileNotFoundError(f"NYU-GeoNet train data not found at {base_path}")
        self.files = [f.split("_image.png")[0] for f in sorted(os.listdir(image_dir))]
        self._rng = np.random.RandomState(0)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index):
        b, stem = self.base_path, self.files[index]
        image = _read_rgb(os.path.join(b, "images", f"{stem}_image.png"))
        image = image.astype(np.uint8)[:480, :640]
        depth = np.load(os.path.join(b, "depths", f"{stem}_depth.npy"))[:480, :640]
        depth = np.where(depth > self.max_depth, 0.0, depth).astype(np.float32)
        snorm = np.load(os.path.join(b, "normals", f"{stem}_norm.npy"))[:480, :640]
        with np.load(os.path.join(b, "segmentations", f"{stem}_image.npz"),
                     allow_pickle=True) as npz:
            seg = npz["panoptic_map"][:480, :640]
        snorm = _chw_to_hwc(snorm)

        img = image.astype(np.float32) / 255.0
        if self.augment:
            img = color_jitter(img, self._rng)
        if self.center_crop:
            img, depth = img[:, 80:-80], depth[:, 80:-80]
            snorm, seg = snorm[:, 80:-80], seg[:, 80:-80]
        depth = depth[..., None]

        if self.augment:
            img, depth, snorm = nyu_shared_augment(
                img, depth, snorm, self._rng, self.image_size, self.rotateflip)
        else:
            img = resize_nearest(img, self.image_size)
            depth = resize_nearest(depth, self.image_size)
            snorm = resize_nearest(snorm, self.image_size)
        seg = resize_nearest(seg, self.image_size)

        img = normalize_image(img, self.image_mean)
        return {
            "image": img.astype(np.float32),
            "depth": depth.astype(np.float32),
            "snorm": snorm.astype(np.float32),
            "segmentation": seg.astype(np.int32),
        }
