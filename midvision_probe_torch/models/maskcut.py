"""MaskCut training-free object discovery (counterpart of the JAX package's
``models/maskcut.py``; reference ``evals/models/maskcut_processor.py``).

Pipeline per image (``maskcut_processor.py:215-296, 339-406``):
patch-feature affinity with a KMeans-adaptive threshold tau -> the
generalized eigenproblem's second-smallest eigenvector (spectral
bipartition) -> seed + corner-reversal heuristics -> connected-component
box/mask -> iterative extraction of N masks with affinity masking and
IoU/area rejection -> DenseCRF refinement + hole filling + IoU sign-flip
filter.

The backbone forward runs on its device (the port's ``FeatureExtractor``;
a ViT's attention on kernel K1), and the (h, w, C) map comes back to the
host. The spectral and connected-component steps run there in float64
with scipy's ``eigh(subset_by_index=[1, 2])`` and ``ndimage``, as in the
JAX package; the 2-means of the affinity values is the port's own
(``utils/kmeans.py``, scikit-learn's algorithm, drawing from this
processor's ``numpy.random.Generator``), and the DenseCRF is the
repository's C++ library, built from its sources (``models/crf.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from midvision_probe_torch.datasets.transforms import normalize_image, resize_nearest
from midvision_probe_torch.models.crf import densecrf
from midvision_probe_torch.utils.kmeans import two_means_1d


def _iou(mask1: np.ndarray, mask2: np.ndarray) -> float:
    m1 = mask1 > 0.5
    m2 = mask2 > 0.5
    union = (m1 | m2).sum()
    if union == 0:
        return 0.0
    inter = (m1 & (m1 == m2)).sum()
    return float(inter / union)


def _nearest_resize(arr: np.ndarray, hw) -> np.ndarray:
    out = resize_nearest(arr[..., None] if arr.ndim == 2 else arr, hw)
    return out[..., 0] if arr.ndim == 2 else out


class MaskCutProcessor:
    """API-compatible with the reference class (``maskcut_processor.py:18``).

    Args:
        backbone: FeatureExtractor with ``output='dense'`` (first map used).
        feature_extractor_fn: (1, H, W, 3) normalized numpy image ->
            (C, num_patches) features; default: ``backbone``'s.
        patch_size / tau / fixed_size: reference knobs.

    The 2-means draws from a generator seeded with 0 (the reference's
    KMeans is unseeded).
    """

    def __init__(self, backbone=None, feature_extractor_fn=None,
                 patch_size=16, tau=0.15, fixed_size=480):
        self.backbone = backbone
        self.feature_extractor_fn = (
            feature_extractor_fn if feature_extractor_fn is not None
            else self._default_features)
        self.patch_size = patch_size
        self.tau = tau
        self.fixed_size = fixed_size
        self.rng = np.random.default_rng(0)

    def _default_features(self, image_nhwc: np.ndarray) -> np.ndarray:
        """(1, H, W, 3) normalized image -> (C, num_patches) features."""
        out = self.backbone(torch.from_numpy(np.ascontiguousarray(image_nhwc)))
        if isinstance(out, list):
            out = out[0]
        feat = out[0].float().cpu().numpy()  # (h, w, C)
        return feat.reshape(-1, feat.shape[-1]).T  # (C, N)

    # ---------------------------------------------------------- spectral --
    def get_affinity_matrix(self, feats_cn: np.ndarray, tau: float,
                            eps: float = 1e-5, distance_threshold: float = 0.3):
        """``maskcut_processor.py:64-111``: cosine affinity + adaptive tau.

        Kept quirk of the reference: it computes both the fallback and the
        mean of the centers, then overwrites tau with the mean of the
        KMeans centers unconditionally (``:94``)."""
        f = feats_cn / np.clip(np.linalg.norm(feats_cn, axis=0, keepdims=True), 1e-12, None)
        A = (f.T @ f).astype(np.float64)
        centers, _ = two_means_1d(A, rng=self.rng, n_init=10)
        if abs(centers[0] - centers[1]) < distance_threshold:
            tau = np.percentile(A, 90)
        else:
            tau = centers.mean()
        tau = np.mean(centers)

        A = A > tau
        A = np.where(A.astype(float) == 0, eps, A)
        D = np.diag(A.sum(axis=1))
        return A, D

    @staticmethod
    def second_smallest_eigenvector(A, D):
        """``:113-127``."""
        from scipy.linalg import eigh

        _, vecs = eigh(D - A, D, subset_by_index=[1, 2])
        return np.copy(vecs[:, 0]), vecs[:, 0]

    @staticmethod
    def get_salient_areas(vec):
        return vec > (vec.sum() / len(vec))

    @staticmethod
    def check_num_fg_corners(bipartition, dims):
        b = bipartition.reshape(dims)
        return int(b[0, 0]) + int(b[0, -1]) + int(b[-1, 0]) + int(b[-1, -1])

    def detect_box(self, bipartition, seed, dims, initial_im_size=None, scales=None):
        """Connected component containing the seed (``:166-201``)."""
        from scipy import ndimage

        objects, _ = ndimage.label(bipartition)
        cc = objects[np.unravel_index(seed, dims)]
        mask = np.where(objects == cc)
        ymin, ymax = mask[0].min(), mask[0].max() + 1
        xmin, xmax = mask[1].min(), mask[1].max() + 1
        pred = [scales[1] * xmin, scales[0] * ymin, scales[1] * xmax, scales[0] * ymax]
        if initial_im_size:
            pred[2] = min(pred[2], initial_im_size[1])
            pred[3] = min(pred[3], initial_im_size[0])
        return pred, [ymin, xmin, ymax, xmax], objects, mask

    # ---------------------------------------------------------- maskcut ---
    def maskcut_forward(self, feats_cn, dims, scales, init_image_size, num_pseudo_masks):
        """``:215-296``. feats_cn: (C, N)."""
        bipartitions, eigvecs = [], []
        painting = np.zeros(dims, np.float64)
        current_mask = None
        feats = np.asarray(feats_cn, np.float64)
        seed = 0
        for i in range(num_pseudo_masks):
            if i > 0:
                # mask out previous foreground in the feature map (:205-213)
                painting = painting + current_mask
                painting = (painting > 0).astype(np.float64)
                feats = (feats.reshape(feats.shape[0], *dims)
                         * (1 - painting)).reshape(feats.shape[0], -1)
            A, D = self.get_affinity_matrix(feats, self.tau)
            eigenvec, second_vec = self.second_smallest_eigenvector(A, D)
            bipartition = self.get_salient_areas(second_vec)

            seed = int(np.argmax(np.abs(second_vec)))
            nc = self.check_num_fg_corners(bipartition, dims)
            reverse = True if nc >= 3 else bipartition[seed] != 1
            if reverse:
                eigenvec = eigenvec * -1
                bipartition = np.logical_not(bipartition)
                seed = int(np.argmax(eigenvec))
            else:
                seed = int(np.argmax(second_vec))

            bip2d = bipartition.reshape(dims).astype(float)
            _, _, _, cc = self.detect_box(bip2d, seed, dims, scales=scales,
                                          initial_im_size=init_image_size)
            pseudo_mask = np.zeros(dims)
            pseudo_mask[cc[0], cc[1]] = 1

            if i >= 1:
                ratio = pseudo_mask.sum() / pseudo_mask.size
                if _iou(current_mask, pseudo_mask) > 0.5 or ratio <= 0.01:
                    pseudo_mask = np.zeros(dims)
            current_mask = pseudo_mask

            masked_out = 0 if not bipartitions else np.sum(bipartitions, axis=0)
            up = _nearest_resize(pseudo_mask, init_image_size)
            up = up - masked_out
            up[up <= 0] = 0
            bipartitions.append(up)
            eigvecs.append(_nearest_resize(second_vec.reshape(dims), init_image_size))
        return seed, bipartitions, eigvecs

    @staticmethod
    def compute_bbox(mask):
        """``:317-337``: [x_min, y_min, width, height] or None."""
        coords = np.column_stack(np.where(mask > 0))
        if coords.shape[0] == 0:
            return None
        y_min, x_min = coords.min(axis=0)
        y_max, x_max = coords.max(axis=0)
        return [int(x_min), int(y_min), int(x_max - x_min), int(y_max - y_min)]

    # ------------------------------------------------------------ public --
    def process_image(self, img_path, num_pseudo_masks):
        """``:339-406``. ``img_path`` may be a path or an (H, W, 3) uint8
        array (as the VOC driver passes it)."""
        from PIL import Image
        from scipy import ndimage

        if isinstance(img_path, (str, bytes)):
            I = Image.open(img_path).convert("RGB")  # noqa: E741
        else:
            I = Image.fromarray(np.asarray(img_path).astype(np.uint8))  # noqa: E741
        I_new = I.resize((self.fixed_size, self.fixed_size), Image.LANCZOS)
        w, h = I_new.size
        new_w = int(round(w / self.patch_size)) * self.patch_size
        new_h = int(round(h / self.patch_size)) * self.patch_size
        feat_w, feat_h = new_w // self.patch_size, new_h // self.patch_size
        I_resize = I_new.resize((new_w, new_h), Image.LANCZOS)

        tensor = normalize_image(np.array(I_resize))[None]
        feats = self.feature_extractor_fn(tensor)
        _, bipartitions, _ = self.maskcut_forward(
            np.asarray(feats), [feat_h, feat_w], [self.patch_size, self.patch_size],
            [h, w], num_pseudo_masks)

        width, height = I.size
        combined_mask = np.zeros((height, width), np.uint8)
        bboxes, masks = [], []
        for bipartition in bipartitions:
            pseudo_mask = densecrf(np.array(I_new), bipartition)
            pseudo_mask = ndimage.binary_fill_holes(pseudo_mask >= 0.5)
            if _iou(bipartition, pseudo_mask.astype(np.float64)) < 0.5:
                pseudo_mask = pseudo_mask * -1
            pseudo_mask = np.asarray(pseudo_mask, float)
            pseudo_mask[pseudo_mask < 0] = 0
            pseudo_mask = np.uint8(pseudo_mask * 255)
            resized = np.asarray(
                Image.fromarray(pseudo_mask).resize((width, height))).astype(np.uint8)
            combined_mask = np.maximum(combined_mask, resized)
            bbox = self.compute_bbox(resized)
            if bbox:
                bboxes.append(bbox)
                masks.append(resized)

        combined_mask_filled = ndimage.binary_fill_holes(combined_mask)
        return bboxes, masks, combined_mask_filled
