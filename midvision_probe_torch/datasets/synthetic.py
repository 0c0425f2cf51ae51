"""Synthetic datasets (copy of the JAX package's ``datasets/synthetic.py``):
the NYU-shaped depth items and the NAVI- and ScanNet-shaped pair items of
the geometric correspondence evaluations, the VOC-shaped objectness items
and the NIGHTS-shaped 2AFC triplets.

Items are a pure function of ``(seed, index)`` and byte-identical to the
JAX package's for the same seed: the generators below are the same numpy
code.
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


def SyntheticVOC(split="trainval", num_instances=16, image_size=(64, 64), **kw):
    """Config-facing factory for the VOC-shaped synthetic set."""
    for k in ("trainval_path", "test_path", "trainval_jpeg_dir",
              "test_jpeg_dir", "trainval_xml_dir", "test_xml_dir",
              "image_mean", "fixed_size", "name"):
        kw.pop(k, None)
    seed = 0 if "train" in split else 1
    return SyntheticBinaryMask(num_instances, image_size, seed=seed, **kw)


class SyntheticBinaryMask:
    """VOC-shaped items: image + binary object mask (for BinaryHead)."""

    name = "synthetic_voc"

    def __init__(self, num_instances=16, image_size=(64, 64), seed=0, **_):
        self.num_instances = num_instances
        self.image_size = tuple(image_size)
        self.seed = seed

    def __len__(self):
        return self.num_instances

    def __getitem__(self, index):
        h, w = self.image_size
        rng = np.random.RandomState(self.seed * 7919 + index)
        cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4, 3 * w // 4)
        ry, rx = rng.randint(h // 8, h // 4), rng.randint(w // 8, w // 4)
        yy, xx = np.mgrid[0:h, 0:w]
        mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1).astype(
            np.float32
        )
        image = np.stack([mask, 1 - mask, mask * 0.5], axis=-1).astype(np.float32)
        image += rng.randn(h, w, 3).astype(np.float32) * 0.05
        return {
            "image": image,
            # un-normalized [0,1] copy, like voc.py:79 — MaskCut consumes
            # raw_image and the driver deliberately swallows per-image
            # errors, so a missing key silently zeroes the whole eval
            "raw_image": np.clip(image, 0.0, 1.0),
            "mask": mask[..., None],
            "num_objects": np.int32(1),
        }


class SyntheticNAVIPairs:
    """NAVI-pair-shaped items (layout of ``navi.NAVI.__getitem__`` with
    ``pair_dataset=True``; reference ``navi.py:166-189``): two "views" of
    one smooth synthetic surface.

    Geometric construction: the world frame is camera 0's frame, so
    ``xyz_grid_0`` comes from unprojecting a smooth depth field, and view 1
    carries the SAME per-pixel 3D points expressed in a rotated+translated
    camera frame (``xyz_grid_1 = Rt_01 ∘ xyz_grid_0``) with the image
    appearance unchanged up to noise. Matching pixel i↔i is then exactly
    correct, so correspondence recall measures the full feature-matching +
    SE(3)/projection pipeline rather than rendering fidelity: a backbone
    whose features identify the pixel recovers ~100% recall@1cm, while
    mismatches land on far-away surface points.

    Hardness knobs (all default OFF — the default item stream is
    bit-identical to the easy dataset, pinned by tests/test_synthetic_hard):
    with both views sharing one appearance, ANY locality-preserving feature
    matches i↔i and 3D recall saturates at ~99-100 for every backbone.
    ``synthetic_navi_hard`` turns on:

    - ``view_shading``: view 1's channels are re-shaded from the SAME
      surface points expressed in camera 1's frame (depth_z, rotated
      normals) — genuinely view-dependent appearance, ground truth still
      exactly i↔i.
    - ``texture_period``: blends a surface-attached periodic texture into
      both views; patches ``image_size/period`` pixels apart look alike,
      so non-discriminative features mismatch onto far-away 3D points.
    - ``occlude_frac``: constant-gray occluder patches over ~that fraction
      of view 1 (appearance damage only; occluded queries must be carried
      by context or they become errors).
    - ``noise`` / ``photometric``: per-view pixel noise sigma and view-1
      brightness/contrast jitter.
    """

    name = "synthetic-navi"

    def __init__(self, num_instances=8, image_size=64, seed=1,
                 max_angle_deg=90.0, pair_dataset=True, view_shading=False,
                 texture_period=0.0, occlude_frac=0.0, noise=0.01,
                 photometric=0.0, **_):
        if not pair_dataset:
            raise ValueError("SyntheticNAVIPairs only serves pair items")
        self.num_instances = num_instances
        self.image_size = (image_size if isinstance(image_size, int)
                           else min(image_size))
        self.seed = seed
        self.max_angle_deg = max_angle_deg
        self.view_shading = view_shading
        self.texture_period = texture_period
        self.occlude_frac = occlude_frac
        self.noise = noise
        self.photometric = photometric

    def __len__(self):
        return self.num_instances

    def __getitem__(self, index):
        from midvision_probe_torch.datasets.navi_utils import pixel_grid

        s = self.image_size
        rng = np.random.RandomState(self.seed * 60013 + index)

        base = rng.randn(s // 8 + 2, s // 8 + 2)
        ys = np.linspace(0, base.shape[0] - 1.001, s)
        xs = np.linspace(0, base.shape[1] - 1.001, s)
        yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
        fy, fx = (ys - yi)[:, None], (xs - xi)[None, :]
        d = (base[yi][:, xi] * (1 - fy) * (1 - fx)
             + base[yi + 1][:, xi] * fy * (1 - fx)
             + base[yi][:, xi + 1] * (1 - fy) * fx
             + base[yi + 1][:, xi + 1] * fy * fx)
        depth = (3.0 + 1.2 * d).clip(1.0, 6.0).astype(np.float32)[..., None]

        K = np.eye(3, dtype=np.float32)
        K[0, 0] = K[1, 1] = float(s)
        K[0, 2] = K[1, 2] = 0.5 * s
        xyz0 = ((pixel_grid(s, s) * depth) @ np.linalg.inv(K).T
                ).astype(np.float32)

        gy, gx = np.gradient(depth[..., 0])
        n = np.stack([-gx, -gy, np.ones_like(depth[..., 0])], axis=-1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        image = np.stack([depth[..., 0] / 6.0,
                          n[..., 0] * 0.5 + 0.5,
                          n[..., 1] * 0.5 + 0.5], axis=-1).astype(np.float32)

        # relative pose: random-axis rotation (angle index-stratified so the
        # rotation-binned metric has mass in every [0,120]° bin) + small t
        angle = np.deg2rad(self.max_angle_deg) * (
            (index + rng.rand()) / max(1, self.num_instances))
        axis = rng.randn(3)
        axis /= np.linalg.norm(axis)
        kx, ky, kz = axis
        Kx = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]], np.float64)
        R = (np.eye(3) + np.sin(angle) * Kx
             + (1 - np.cos(angle)) * (Kx @ Kx)).astype(np.float32)
        t = (rng.randn(3) * 0.05).astype(np.float32)
        Rt_01 = np.eye(4, dtype=np.float32)
        Rt_01[:3, :3], Rt_01[:3, 3] = R, t
        xyz1 = (xyz0 @ R.T + t).astype(np.float32)

        noise0 = rng.randn(s, s, 3).astype(np.float32) * self.noise
        noise1 = rng.randn(s, s, 3).astype(np.float32) * self.noise

        # hardness branches draw from rng strictly AFTER every easy-path
        # draw, so default items stay bit-identical (test_synthetic_hard)
        image1 = image
        if self.view_shading:
            n1 = (n @ R.T).astype(np.float32)
            image1 = np.stack([np.clip(xyz1[..., 2] / 6.0, 0.0, 1.0),
                               n1[..., 0] * 0.5 + 0.5,
                               n1[..., 1] * 0.5 + 0.5],
                              axis=-1).astype(np.float32)
        if self.texture_period:
            f = self.texture_period
            yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
            tex = np.stack(
                [np.sin(2 * np.pi * f * yy) * np.sin(2 * np.pi * f * xx),
                 np.sin(2 * np.pi * f * (yy + xx)),
                 np.cos(2 * np.pi * f * (yy - xx))],
                axis=-1).astype(np.float32) * 0.5 + 0.5
            image = 0.4 * image + 0.6 * tex
            image1 = 0.4 * image1 + 0.6 * tex
        img0 = image + noise0
        img1 = image1 + noise1
        if self.photometric:
            gain = 1.0 + self.photometric * (2 * rng.rand() - 1)
            bias = self.photometric * (2 * rng.rand() - 1)
            img1 = (img1 * gain + bias).astype(np.float32)
        if self.occlude_frac:
            patch = max(4, s // 8)
            covered = 0
            while covered < self.occlude_frac * s * s:
                y0 = rng.randint(0, s - patch + 1)
                x0 = rng.randint(0, s - patch + 1)
                img1[y0:y0 + patch, x0:x0 + patch] = 0.5
                covered += patch * patch

        out = {}
        for v, (img, xyz, Rt) in enumerate(
                [(img0, xyz0, np.eye(4, dtype=np.float32)),
                 (img1, xyz1, Rt_01)]):
            out[f"image_{v}"] = img
            out[f"depth_{v}"] = depth
            out[f"class_id_{v}"] = np.int32(index)
            out[f"intrinsics_{v}"] = K
            out[f"snorm_{v}"] = n.astype(np.float32)
            out[f"Rt_{v}"] = Rt
            out[f"xyz_grid_{v}"] = xyz
        out["Rt_01"] = Rt_01
        out["pair_id"] = f"{index}-{index}"
        return out


class SyntheticScanNetPairs:
    """ScanNet-pair-shaped items (layout of ``scannet_pairs.py:60-87``):
    two views of a textured 3D PLANE, rendered exactly.

    Unlike :class:`SyntheticNAVIPairs` (which ships per-pixel xyz grids),
    the ScanNet protocol unprojects DEPTH maps through K, so view 1 must be
    a true re-render. A plane makes that closed-form: depth along each ray
    is ``c / (n · K⁻¹p̃)`` and appearance warps by the plane homography
    ``H = K (R − t·nᵀ/c) K⁻¹``, sampled bilinearly from view 0's texture.
    ``max_angle_deg=0`` with ``t_scale=0`` degenerates to identity pairs
    (exactly matchable pixel i↔i) for recall-asserting tests; nonzero
    angles give honest novel-view geometry.

    Hardness knobs (default OFF; easy items stay bit-identical —
    tests/test_synthetic_hard): the easy suite config uses identity pairs,
    so 3D recall is 100.0 for every backbone.
    ``synthetic_scannet_hard`` sets a real pose (``max_angle_deg``,
    ``t_scale`` — already supported) plus:

    - ``texture_period``: a periodic pattern mixed into the plane texture
      BEFORE rendering (it warps consistently with the homography), making
      patches one period apart ambiguous.
    - ``occlude_frac``: constant-gray occluder patches over view 1.
    - ``noise``: per-view pixel noise sigma (default 0.01 as before).
    """

    name = "synthetic-scannet"

    def __init__(self, num_instances=8, image_hw=(64, 64), seed=2,
                 max_angle_deg=0.0, t_scale=0.0, texture_period=0.0,
                 occlude_frac=0.0, noise=0.01, **_):
        self.num_instances = num_instances
        self.image_hw = tuple(image_hw)
        self.seed = seed
        self.max_angle_deg = max_angle_deg
        self.t_scale = t_scale
        self.texture_period = texture_period
        self.occlude_frac = occlude_frac
        self.noise = noise

    def __len__(self):
        return self.num_instances

    def _rays(self, K):
        h, w = self.image_hw
        xx, yy = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
        p = np.stack([xx, yy, np.ones_like(xx)], axis=-1)
        return p @ np.linalg.inv(K).T  # (h, w, 3)

    def __getitem__(self, index):
        h, w = self.image_hw
        rng = np.random.RandomState(self.seed * 49999 + index)

        K = np.eye(3, dtype=np.float32)
        K[0, 0] = K[1, 1] = 0.8 * w
        K[0, 2], K[1, 2] = 0.5 * w, 0.5 * h

        # gently tilted plane n·X = c, all rays hitting in front
        n0 = np.array([0.15 * rng.randn(), 0.15 * rng.randn(), 1.0])
        n0 /= np.linalg.norm(n0)
        c = 3.0 + rng.rand()

        # smooth random texture, indexed by view-0 pixel coordinates
        base = rng.randn(h // 8 + 2, w // 8 + 2, 3)
        ys = np.linspace(0, base.shape[0] - 1.001, h)
        xs = np.linspace(0, base.shape[1] - 1.001, w)
        yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
        fy = (ys - yi)[:, None, None]
        fx = (xs - xi)[None, :, None]
        tex = (base[yi][:, xi] * (1 - fy) * (1 - fx)
               + base[yi + 1][:, xi] * fy * (1 - fx)
               + base[yi][:, xi + 1] * (1 - fy) * fx
               + base[yi + 1][:, xi + 1] * fy * fx).astype(np.float32)

        if self.texture_period:
            # mixed in BEFORE rendering: the pattern rides the plane
            # homography exactly, so ambiguity is appearance-only and the
            # closed-form depth/pose ground truth is untouched
            f = self.texture_period
            gy2, gx2 = np.mgrid[0:h, 0:w].astype(np.float32)
            per = np.stack(
                [np.sin(2 * np.pi * f * gy2 / h)
                 * np.sin(2 * np.pi * f * gx2 / w),
                 np.sin(2 * np.pi * f * (gy2 / h + gx2 / w)),
                 np.cos(2 * np.pi * f * (gy2 / h - gx2 / w))],
                axis=-1).astype(np.float32)
            tex = (0.4 * tex + 0.8 * per).astype(np.float32)

        rays = self._rays(K)
        depth_0 = (c / (rays @ n0)).astype(np.float32)
        rgb_0 = tex + rng.randn(h, w, 3).astype(np.float32) * self.noise

        angle = np.deg2rad(self.max_angle_deg) * rng.rand()
        axis = rng.randn(3)
        axis /= np.linalg.norm(axis)
        kx, ky, kz = axis
        Kx = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]], np.float64)
        R = (np.eye(3) + np.sin(angle) * Kx
             + (1 - np.cos(angle)) * (Kx @ Kx))
        t = rng.randn(3) * self.t_scale

        # plane in cam-1 frame: X1 = R X0 + t  =>  (R n0)·X1 = c + (R n0)·t
        n1, c1 = R @ n0, c + (R @ n0) @ t
        depth_1 = (c1 / (rays @ n1)).astype(np.float32)

        # re-render: X1 along each view-1 ray -> cam-0 -> view-0 pixel
        X1 = rays * depth_1[..., None]
        X0 = (X1 - t) @ R  # == R^T @ (X1 - t) rowwise
        p0 = X0 @ K.T
        u = np.clip(p0[..., 0] / p0[..., 2] - 0.5, 0, w - 1.001)
        v = np.clip(p0[..., 1] / p0[..., 2] - 0.5, 0, h - 1.001)
        ui, vi = np.floor(u).astype(int), np.floor(v).astype(int)
        fu, fv = (u - ui)[..., None], (v - vi)[..., None]
        rgb_1 = (tex[vi, ui] * (1 - fv) * (1 - fu)
                 + tex[vi + 1, ui] * fv * (1 - fu)
                 + tex[vi, ui + 1] * (1 - fv) * fu
                 + tex[vi + 1, ui + 1] * fv * fu).astype(np.float32)
        rgb_1 += rng.randn(h, w, 3).astype(np.float32) * self.noise
        if self.occlude_frac:
            patch = max(4, min(h, w) // 8)
            covered = 0
            while covered < self.occlude_frac * h * w:
                y0 = rng.randint(0, h - patch + 1)
                x0 = rng.randint(0, w - patch + 1)
                rgb_1[y0:y0 + patch, x0:x0 + patch] = 0.5
                covered += patch * patch

        Rt_01 = np.eye(4, dtype=np.float32)
        Rt_01[:3, :3] = R.astype(np.float32)
        Rt_01[:3, 3] = t.astype(np.float32)
        return {
            "rgb_0": rgb_0, "rgb_1": rgb_1,
            "depth_0": depth_0, "depth_1": depth_1,
            "Rt_0": np.eye(4, dtype=np.float32), "Rt_1": Rt_01,
            "K": K,
        }


def _smooth01(rng, h: int, w: int) -> "np.ndarray":
    """Smooth random RGB texture in [0, 1] (bilinear upsample of a coarse
    randn field — the same construction the geometric sets use)."""
    base = rng.randn(h // 8 + 2, w // 8 + 2, 3)
    ys = np.linspace(0, base.shape[0] - 1.001, h)
    xs = np.linspace(0, base.shape[1] - 1.001, w)
    yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
    fy = (ys - yi)[:, None, None]
    fx = (xs - xi)[None, :, None]
    t = (base[yi][:, xi] * (1 - fy) * (1 - fx)
         + base[yi + 1][:, xi] * fy * (1 - fx)
         + base[yi][:, xi + 1] * (1 - fy) * fx
         + base[yi + 1][:, xi + 1] * fy * fx)
    return np.clip(0.5 + 0.25 * t, 0.0, 1.0).astype(np.float32)


class SyntheticTwoAFC:
    """NIGHTS-triplet-shaped items (layout of ``twoafcdataset.py:22-44``):
    ``img_ref`` plus a near-duplicate and an unrelated distractor, with
    ``p`` encoding which side is near (0 = left). Any feature space that
    preserves locality picks the near-duplicate, so 2AFC accuracy ~1 is
    the correct result even for a random-init backbone.

    ``hard=True`` (``synthetic_twoafc_hard``; the easy
    set saturates at accuracy 1.0 for every backbone): the 2AFC protocol
    scores a GLOBAL embedding (ViT cls / CNN global-average pool,
    reference ``evaluate_model_percepture.py:105-131``), so hardness must
    live on the content-vs-statistics axis that embedding actually sees.
    The "near" side is a CONTENT-PRESERVING photometric change (per-channel
    gain/bias jitter of strength ``photometric`` — same texture, slightly
    shifted global color statistics), while the "far" side is a
    CONTENT-CHANGING blend toward an independent texture at an
    index-stratified weight from ``margin_range``. The two sides' global-
    statistics distances overlap (calibrated: the near-stats-only
    ``test_tiny`` cls embedding lands at 0.39, content-pooled numpy
    features near 1.0 — tests/test_synthetic_hard), so accuracy spreads
    with how much texture/content a backbone's global embedding encodes
    instead of pinning at 1.0, and an embedding regression collapses it
    toward the floor."""

    name = "synthetic-2afc"

    def __init__(self, num_instances=16, image_size=(64, 64), seed=3,
                 split="test", hard=False, photometric=0.02,
                 margin_range=(0.1, 0.5), **_):
        self.num_instances = num_instances
        self.image_size = tuple(image_size)
        self.seed = seed
        self.hard = hard
        self.photometric = photometric
        self.margin_range = tuple(margin_range)

    def __len__(self):
        return self.num_instances

    def __getitem__(self, index):
        h, w = self.image_size
        rng = np.random.RandomState(self.seed * 32452843 + index)
        if self.hard:
            ref = _smooth01(rng, h, w)
            db = _smooth01(rng, h, w)
            lo, hi = self.margin_range
            strata = max(1, (self.num_instances + 1) // 2 - 1)
            a_far = lo + (hi - lo) * ((index // 2) % (strata + 1)) / strata
            # near: same content, shifted global statistics
            gain = 1.0 + self.photometric * (2 * rng.rand(3) - 1)
            bias = 0.5 * self.photometric * (2 * rng.rand(3) - 1)
            near = np.clip(ref * gain + bias
                           + rng.randn(h, w, 3) * 0.02, 0, 1
                           ).astype(np.float32)
            # far: different content (plain blend — the natural residual
            # mean difference keeps global statistics roughly
            # uninformative rather than anti-informative)
            far = np.clip((1 - a_far) * ref + a_far * db
                          + rng.randn(h, w, 3) * 0.02, 0, 1
                          ).astype(np.float32)
        else:
            ref = rng.rand(h, w, 3).astype(np.float32)
            near = np.clip(ref + rng.randn(h, w, 3).astype(np.float32)
                           * 0.02, 0, 1)
            far = rng.rand(h, w, 3).astype(np.float32)
        left_is_near = index % 2 == 0
        return {
            "id": np.int64(index),
            "p": np.float32(0.0 if left_is_near else 1.0),
            "img_ref": ref,
            "img_left": near if left_is_near else far,
            "img_right": far if left_is_near else near,
        }
