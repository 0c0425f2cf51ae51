"""Taskonomy probing dataset (counterpart of the JAX package's
``datasets/taskonomy.py``).

The reader takes a local HF-datasets directory (``datasets.load_from_disk``,
imported only when such a directory is given; the layout that
``data_processing/prepare_taskonomy.py`` writes). Where the configured path
is not a directory it builds a synthetic set with the same item schema
(``rgb``, ``<task>``, ``mask_valid``), sized by ``num_instances`` and
``image_size``. A directory that exists is never replaced by synthetic
data: without the ``datasets`` package it raises.
"""

from __future__ import annotations

import os

import numpy as np

from midvision_probe_torch.datasets.synthetic import SyntheticDepth
from midvision_probe_torch.datasets.transforms import normalize_image

# the reference's task_configs.task_parameters (the tasks the pipelines use)
TASK_PARAMETERS = {
    "depth_euclidean": {"num_channels": 1, "clamp_to": (0.0, 8000.0 / (2**16 - 1))},
    "depth_zbuffer": {"num_channels": 1, "mask_val": 1.0,
                      "clamp_to": (0.0, 8000.0 / (2**16 - 1))},
    "edge_texture": {"num_channels": 1, "clamp_to": (0.0, 0.25)},
    "edge_occlusion": {"num_channels": 1},
    "keypoints2d": {"num_channels": 1},
    "keypoints3d": {"num_channels": 1},
    "principal_curvature": {"num_channels": 3, "mask_val": 0.0},
    "reshading": {"num_channels": 1},
    "normal": {"num_channels": 3},
}

# explicit aliases: a blanket fallback to depth's parameters would clamp
# curvature targets to depth's [0, 8000/65535] and destroy them
_ALIASES = {"depth": "depth_euclidean", "curvature": "principal_curvature"}


def task_transform(arr: np.ndarray, task: str) -> np.ndarray:
    """One HWC (or HW) array of ``task`` -> float32 HWC: RGB normalised;
    the valid mask binarised at 0.5 (after /255 when its max is above 1.5);
    a target scaled from uint16 by 1/65535 or from 8 bits by 1/255 (when
    its max is above 1.5), curvature cut to its 2 channels, and a clamped
    task rescaled to [0, 1]. An unknown task raises ``KeyError``."""
    arr = np.asarray(arr)
    if task == "rgb":
        return normalize_image(arr.astype(np.float32))
    if task == "mask_valid":
        m = arr.astype(np.float32)
        if m.max() > 1.5:
            m = m / 255.0
        if m.ndim == 2:
            m = m[..., None]
        return (m > 0.5).astype(np.float32)

    x = arr.astype(np.float32)
    if arr.dtype == np.uint16:
        x = x / (2**16 - 1)
    elif x.max() > 1.5:
        x = x / 255.0
    if x.ndim == 2:
        x = x[..., None]

    base = _ALIASES.get(task, task)
    if base not in TASK_PARAMETERS:
        raise KeyError(f"unknown taskonomy task {task!r}; known: {sorted(TASK_PARAMETERS)}")
    params = TASK_PARAMETERS[base]
    if base == "principal_curvature":
        x = x[..., :2]  # the reference keeps 2 channels
    if "clamp_to" in params:
        lo, hi = params["clamp_to"]
        x = np.clip(x, lo, hi) / hi
    return x


class TaskonomyDataset:
    """An HF-style dataset as ``{image, target, mask_valid}`` items."""

    name = "taskonomy"

    def __init__(self, dataset, task: str):
        self.dataset = dataset
        self.task = task

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        item = self.dataset[idx]
        # the published set's column is 'depth'; the synthetic set stores
        # the component's name
        src_key = self.task
        if src_key not in item and self.task == "depth":
            src_key = "depth_euclidean"
        return {
            "image": task_transform(np.asarray(item["rgb"]), "rgb"),
            "target": task_transform(np.asarray(item[src_key]), src_key),
            "mask_valid": task_transform(np.asarray(item["mask_valid"]), "mask_valid"),
        }


class _SyntheticTaskonomy:
    """Taskonomy-schema items over ``SyntheticDepth``: uint8 RGB, the
    task's target (uint16 for depth) and a float valid mask."""

    def __init__(self, task, num_instances=16, image_size=(64, 64), seed=0):
        self.inner = SyntheticDepth(num_instances, image_size, seed=seed)
        self.task = task

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, idx):
        it = self.inner[idx]
        ch = TASK_PARAMETERS.get(self.task, {}).get("num_channels", 1)
        if self.task == "normal":
            target = it["snorm"] * 0.5 + 0.5
        elif ch == 3 or self.task in ("principal_curvature", "curvature"):
            target = np.repeat(it["depth"] / 10.0, 2, axis=-1)
        else:
            target = it["depth"] / 10.0
        is_depth = self.task in ("depth", "depth_euclidean")
        return {
            "rgb": (it["image"] * 255).astype(np.uint8),
            "depth_euclidean" if self.task == "depth" else self.task:
                (target * (2**16 - 1)).astype(np.uint16) if is_depth else target,
            "mask_valid": (it["depth"][..., 0] > 0).astype(np.float32),
        }


def _load_from_disk(path: str):
    try:
        import datasets as hf_datasets
    except ImportError as e:
        raise ImportError(
            f"the Taskonomy directory {path!r} is an HF-datasets directory; reading "
            "it needs the 'datasets' package, which is not installed") from e
    return hf_datasets.load_from_disk(path)


def Taskonomy(snorm_path, other_path, split, task, name="taskonomy",
              image_mean="imagenet", center_crop=False, rotateflip=False,
              augment_train=False, num_instances=16, image_size=(64, 64), **_):
    """Config-facing factory: the HF directory at ``snorm_path`` (normals)
    or ``other_path`` (every other task), its ``split`` where it holds
    several; without such a directory, the synthetic set
    (``num_instances`` and ``image_size`` size it only)."""
    path = snorm_path if task == "normal" else other_path
    if os.path.isdir(str(path)):
        ds = _load_from_disk(path)
        if hasattr(ds, "keys") and split in ds:
            ds = ds[split]
        return TaskonomyDataset(ds, task)
    seed = {"train": 0, "valid": 1, "test": 2}.get(split, 0)
    return TaskonomyDataset(
        _SyntheticTaskonomy(task, num_instances=int(num_instances),
                            image_size=tuple(image_size), seed=seed), task)
