"""Synthetic NYU-shaped depth items (copy of the JAX package's
``datasets/synthetic.py::SyntheticDepth``).

Items are a pure function of ``(seed, index)`` and byte-identical to the
JAX package's for the same seed: the generator below is the same numpy
code. Only the depth dataset is ported in this slice.
"""

from __future__ import annotations

import os

import numpy as np


class SyntheticDepth:
    """NYU-shaped items: image/depth/snorm/segmentation (NHWC numpy).

    The scene is a smooth random height-field; normals are derived from the
    depth gradient, so probes can genuinely (over)fit it.
    """

    name = "synthetic"

    def __init__(self, num_instances=16, image_size=(64, 64), max_depth=10.0,
                 seed=0, **_):
        self.num_instances = num_instances
        self.image_size = tuple(image_size)
        self.max_depth = max_depth
        self.seed = seed
        # items are a pure function of (seed, index), so memoize: a fresh
        # 480x640 item costs ~0.5 s of numpy, which re-generated every epoch
        # would dominate. Budget via $MVP_SYNTH_CACHE_GB (default 16 GiB).
        self._memo: dict[int, dict] = {}
        self._memo_bytes = 0
        self._memo_budget = int(float(os.environ.get(
            "MVP_SYNTH_CACHE_GB", "16")) * 1024**3)

    def __len__(self):
        return self.num_instances

    def __getitem__(self, index):
        hit = self._memo.get(index)
        if hit is not None:
            return dict(hit)  # shallow copy: consumers may pop keys
        item = self._generate(index)
        size = sum(v.nbytes for v in item.values())
        if self._memo_bytes + size <= self._memo_budget:
            self._memo[index] = item
            self._memo_bytes += size
        return dict(item)

    def _generate(self, index):
        h, w = self.image_size
        rng = np.random.RandomState(self.seed * 100003 + index)
        # smooth depth field
        base = rng.randn(h // 8 + 2, w // 8 + 2)
        ys = np.linspace(0, base.shape[0] - 1.001, h)
        xs = np.linspace(0, base.shape[1] - 1.001, w)
        yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
        fy, fx = (ys - yi)[:, None], (xs - xi)[None, :]
        d = (
            base[yi][:, xi] * (1 - fy) * (1 - fx)
            + base[yi + 1][:, xi] * fy * (1 - fx)
            + base[yi][:, xi + 1] * (1 - fy) * fx
            + base[yi + 1][:, xi + 1] * fy * fx
        )
        depth = (3.0 + 1.5 * d).clip(0.3, self.max_depth - 0.5)

        gy, gx = np.gradient(depth)
        n = np.stack([-gx, -gy, np.ones_like(depth)], axis=-1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)

        image = np.stack(
            [depth / self.max_depth, n[..., 0] * 0.5 + 0.5, n[..., 1] * 0.5 + 0.5],
            axis=-1,
        ).astype(np.float32)
        image += rng.randn(h, w, 3).astype(np.float32) * 0.01

        seg = (depth > np.median(depth)).astype(np.int32) * 7  # stuff 0 / thing 7
        # a few invalid pixels
        mask = rng.rand(h, w) < 0.05
        depth = np.where(mask, 0.0, depth)

        return {
            "image": image.astype(np.float32),
            "depth": depth[..., None].astype(np.float32),
            "snorm": n.astype(np.float32),
            "segmentation": seg,
        }


def Synthetic(split="train", num_instances=16, image_size=(64, 64), **kw):
    """Config-facing factory (``dataset=synthetic``)."""
    for k in ("train_path", "test_path", "image_mean", "augment_train",
              "center_crop", "name"):
        kw.pop(k, None)
    seed = 0 if "train" in split else 1
    return SyntheticDepth(num_instances, image_size, seed=seed, **kw)
