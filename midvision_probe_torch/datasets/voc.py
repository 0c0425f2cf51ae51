"""Pascal VOC objectness reader (copy of the JAX package's
``datasets/voc.py``; reference ``evals/datasets/voc.py``).

Items: ``image`` (the JPEG LANCZOS-resized by PIL to fixed_size²,
normalized), ``raw_image`` (the same, un-normalized, for MaskCut and
renders), ``mask`` the binary ground truth from the SegmentationObject
palette PNG NEAREST-resized to fixed_size² (any object id, neither 0 nor
the 255 boundary) and ``num_objects`` from the XML annotation
(``voc.py:60-102``).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from midvision_probe_torch.datasets.transforms import normalize_image


class VOC:
    def __init__(
        self,
        split="trainval",
        trainval_path=None,
        test_path=None,
        trainval_jpeg_dir=None,
        test_jpeg_dir=None,
        trainval_xml_dir=None,
        test_xml_dir=None,
        image_mean="imagenet",
        fixed_size=480,
        name="voc",
        **_,
    ):
        self.name = name
        self.image_mean = image_mean
        self.fixed_size = int(fixed_size)
        if split == "test":
            self.seg_dir, self.jpeg_dir, self.xml_dir = test_path, test_jpeg_dir, test_xml_dir
        else:
            self.seg_dir, self.jpeg_dir, self.xml_dir = (
                trainval_path, trainval_jpeg_dir, trainval_xml_dir)
        if not (self.seg_dir and os.path.isdir(self.seg_dir)):
            raise FileNotFoundError(f"VOC SegmentationObject dir not found: {self.seg_dir}")
        self.stems = sorted(f[:-4] for f in os.listdir(self.seg_dir) if f.endswith(".png"))

    def __len__(self):
        return len(self.stems)

    def __getitem__(self, index):
        from PIL import Image

        stem = self.stems[index]
        s = self.fixed_size
        img = Image.open(os.path.join(self.jpeg_dir, stem + ".jpg")).convert("RGB")
        img = img.resize((s, s), Image.LANCZOS)
        raw = np.array(img).astype(np.float32) / 255.0

        seg = Image.open(os.path.join(self.seg_dir, stem + ".png"))
        seg = np.array(seg.resize((s, s), Image.NEAREST))
        mask = ((seg > 0) & (seg < 255)).astype(np.float32)

        num_objects = 1
        if self.xml_dir:
            xml_path = os.path.join(self.xml_dir, stem + ".xml")
            if os.path.exists(xml_path):
                root = ET.parse(xml_path).getroot()
                num_objects = max(len(root.findall("object")), 1)

        return {
            "image": normalize_image(raw, self.image_mean),
            "raw_image": raw,
            "mask": mask[..., None],
            "num_objects": np.int32(num_objects),
        }
