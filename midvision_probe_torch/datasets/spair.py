"""SPair-71k semantic-correspondence reader (counterpart of the JAX
package's ``datasets/spair.py``).

The reference layout (``PairAnnotation/<split>/*.json``,
``ImageAnnotation/<class>/*.json``, ``JPEGImages``, ``Segmentation``) and
its behaviour: an optional bounding-box crop, padding to a white square,
a bicubic antialiased resize to ``image_size``, keypoints rescaled to
``image_size`` and padded to ``MAX_KPS`` slots with a validity flag, and the
PCK scale ``max bbox side / max image side`` of the target when
``use_bbox=False``. ``num_instances`` keeps the first pairs after a seed-20
shuffle of the glob order, drawn from a ``random.Random(20)`` of its own
(the same permutation as the global ``random.seed(20)``, without touching
the global generator).

Images are resized on the host with the port's ``ops.image.resize`` on CPU
tensors, so the reader leaves the card free.
"""

from __future__ import annotations

import glob
import json
import os
import random

import numpy as np
import torch

from midvision_probe_torch.datasets.transforms import mean_std, resize_nearest
from midvision_probe_torch.ops.image import resize

CLASS_IDS = {
    "aeroplane": 1, "bicycle": 2, "bird": 3, "boat": 4, "bottle": 5,
    "bus": 6, "car": 7, "cat": 8, "chair": 9, "cow": 10, "dog": 12,
    "horse": 13, "motorbike": 14, "person": 15, "pottedplant": 16,
    "sheep": 17, "train": 19, "tvmonitor": 20,
}

MAX_KPS = 30


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class SPairDataset:
    def __init__(self, root, split, image_size=512, image_mean="imagenet",
                 use_bbox=True, class_name=None, num_instances=None, vp_diff=None):
        assert split in ["train", "valid", "test"]
        self.root = root
        self.split = split
        self.image_size = int(image_size)
        self.use_bbox = use_bbox
        self.mean, self.std = mean_std(image_mean)

        instances = self._pair_annotations()
        if class_name:
            instances = [a for a in instances if a["category"] == class_name]
        if vp_diff is not None:
            instances = [a for a in instances if a["viewpoint_variation"] == vp_diff]
        if num_instances:
            random.Random(20).shuffle(instances)
            instances = instances[:num_instances]
        self.instances = instances
        self.image_annotations = self._image_annotations()

    def _pair_annotations(self):
        split = {"train": "trn", "valid": "val", "test": "test"}[self.split]
        files = glob.glob(os.path.join(self.root, "PairAnnotation", split, "*.json"))
        return [_read_json(p) for p in files]

    def _image_annotations(self):
        annot_path = os.path.join(self.root, "ImageAnnotation")
        out = {}
        for cls in os.listdir(annot_path):
            annots = [_read_json(p) for p in glob.glob(os.path.join(annot_path, cls, "*.json"))]
            out[cls] = {a["filename"].split(".")[0]: a for a in annots}
        return out

    def __len__(self):
        return len(self.instances)

    @staticmethod
    def _kps(kp_dict, bbox):
        """(MAX_KPS, 3) float32: x, y (relative to the crop) and 1 for each
        annotated keypoint; zeros for a ``null`` one and the padding."""
        kps = np.zeros((MAX_KPS, 3), np.float32)
        for i in range(len(kp_dict)):
            v = kp_dict[str(i)]
            if v:
                x, y = v
                if bbox:
                    x, y = x - bbox[0], y - bbox[1]
                kps[i] = (x, y, 1)
        return kps

    def _load(self, class_name, image_name, bbox, is_mask):
        from PIL import Image

        sub, ext = ("Segmentation", ".png") if is_mask else ("JPEGImages", ".jpg")
        with Image.open(os.path.join(self.root, sub, class_name, image_name + ext)) as im:
            arr = np.array(im)
        if bbox:
            left, upper, right, lower = bbox
            arr = arr[upper:lower, left:right]
        h, w = arr.shape[:2]
        max_hw = max(h, w)
        if is_mask:
            arr = np.pad(arr, ((0, max_hw - h), (0, max_hw - w)))
            arr = (arr == CLASS_IDS[class_name]).astype(np.float32)
        else:
            arr = np.pad(arr, ((0, max_hw - h), (0, max_hw - w), (0, 0)),
                         constant_values=255)
        return arr, max_hw

    def _resize_image(self, img: np.ndarray) -> np.ndarray:
        s = self.image_size
        x = torch.from_numpy(img.astype(np.float32) / 255.0)
        return resize(x, (s, s), mode="bicubic", antialias=True).clamp(0, 1).numpy()

    def __getitem__(self, index):
        pair = self.instances[index]
        class_name = pair["category"]
        class_dict = self.image_annotations[class_name]
        _, view_i, view_j = pair["filename"].split(":")[0].split("-")

        bbx_i = pair["src_bndbox"] if self.use_bbox else None
        bbx_j = pair["trg_bndbox"] if self.use_bbox else None

        kps_i = self._kps(class_dict[view_i]["kps"], bbx_i)
        kps_j = self._kps(class_dict[view_j]["kps"], bbx_j)

        img_i, hw_i = self._load(class_name, view_i, bbx_i, is_mask=False)
        img_j, hw_j = self._load(class_name, view_j, bbx_j, is_mask=False)
        seg_i, _ = self._load(class_name, view_i, bbx_i, is_mask=True)
        seg_j, _ = self._load(class_name, view_j, bbx_j, is_mask=True)

        s = self.image_size
        mean = np.asarray(self.mean, np.float32)
        std = np.asarray(self.std, np.float32)
        img_i = (self._resize_image(img_i) - mean) / std
        img_j = (self._resize_image(img_j) - mean) / std
        seg_i = resize_nearest(seg_i, (s, s))
        seg_j = resize_nearest(seg_j, (s, s))

        kps_i[:, :2] *= s / hw_i
        kps_j[:, :2] *= s / hw_j

        if not self.use_bbox:
            left, upper, right, lower = pair["trg_bndbox"]
            thresh_scale = float(max(right - left, lower - upper)) / max(pair["trg_imsize"][:2])
        else:
            thresh_scale = 1.0

        return {
            "img_i": img_i.astype(np.float32),
            "seg_i": seg_i.astype(np.float32),
            "kps_i": kps_i,
            "img_j": img_j.astype(np.float32),
            "seg_j": seg_j.astype(np.float32),
            "kps_j": kps_j,
            "thresh_scale": np.float32(thresh_scale),
            "class_name": class_name,
        }
