"""NIGHTS 2AFC perceptual-similarity reader (counterpart of the JAX
package's ``datasets/twoafc.py``; reference
``evals/datasets/twoafcdataset.py``), without pandas.

``data.csv`` is read with the standard ``csv`` module under the JAX
reader's semantics: the rows with ``votes >= 6`` (``twoafcdataset.py:
22-24``), then the split (``train``, ``val``, ``test``, or ``test`` with
``is_imagenet`` true or false, parsed as pandas parses ``True`` and
``False``); an item takes ``id``, ``p`` and the reference, left and right
paths by column position (0, 2, 4, 5, 6), as ``row.iloc`` does. Preprocess
(``datasets/utils.py:36-78``): ``DEFAULT`` is a bicubic resize to
``load_size``² (``ops.image.resize``) clipped to [0, 1], no mean
normalization; ``LPIPS`` scales the image to [-1, 1] at its own size.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from midvision_probe_torch.ops.image import resize

# the spellings pandas' CSV reader turns into booleans by default
_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")


def _bool(text: str) -> bool:
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    raise ValueError(f"is_imagenet is not a boolean: {text!r}")


class TwoAFCDataset:
    def __init__(self, root_dir: str, split: str = "train", load_size: int = 224,
                 preprocess: str = "DEFAULT", **_):
        self.root_dir = root_dir
        self.load_size = int(load_size)
        self.preprocess = preprocess
        with open(os.path.join(root_dir, "data.csv"), newline="") as f:
            reader = csv.reader(f)
            col = {name: i for i, name in enumerate(next(reader))}
            rows = [r for r in reader if r and float(r[col["votes"]]) >= 6]
        if split in ("train", "val", "test"):
            rows = [r for r in rows if r[col["split"]] == split]
        elif split in ("test_imagenet", "test_no_imagenet"):
            want = split == "test_imagenet"
            rows = [r for r in rows
                    if r[col["split"]] == "test" and _bool(r[col["is_imagenet"]]) == want]
        else:
            raise ValueError(f"Invalid split: {split}")
        self.rows = rows
        self.name = "nights_2afc"

    def __len__(self):
        return len(self.rows)

    def _load(self, rel_path):
        from PIL import Image

        img = Image.open(os.path.join(self.root_dir, rel_path)).convert("RGB")
        arr = np.array(img).astype(np.float32) / 255.0
        if self.preprocess == "LPIPS":
            return arr * 2.0 - 1.0
        s = self.load_size
        return resize(torch.from_numpy(arr), (s, s), mode="bicubic").numpy().clip(0, 1)

    def __getitem__(self, idx):
        row = self.rows[idx]
        return {
            "id": np.int64(int(row[0])),
            "p": np.float32(float(row[2])),  # pandas reads a float64 column
            "img_ref": self._load(row[4]).astype(np.float32),
            "img_left": self._load(row[5]).astype(np.float32),
            "img_right": self._load(row[6]).astype(np.float32),
        }
