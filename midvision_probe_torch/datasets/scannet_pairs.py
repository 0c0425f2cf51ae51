"""ScanNet-1500 test pairs (counterpart of the JAX package's
``datasets/scannet_pairs.py``).

Layout: ``<root>/intrinsics.npz``, ``<root>/test.npz`` (the SuperGlue /
LoFTR split) and per-scene ``color/ depth/ pose/`` directories. RGB is
resized to 480x640 (bilinear, antialiased) and normalized with mean/std
0.5; depth is in millimetres / 1000; ``Rt_01 = Rt_1^-1 @ Rt_0``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from midvision_probe_torch.datasets.transforms import resize_nearest
from midvision_probe_torch.ops.image import resize


class ScanNetPairsDataset:
    def __init__(self, root="data/scannet_test_1500", split="test", **_):
        self.name = "ScanNet-pairs"
        self.root = root
        self.split = "test"
        self.num_views = 2
        self.instances = self._get_instances(root)

    def _get_instances(self, root):
        K_dict = dict(np.load(os.path.join(root, "intrinsics.npz")))
        data = np.load(os.path.join(root, "test.npz"))["name"]
        out = []
        for i in range(len(data)):
            room_id, seq_id, ins_0, ins_1 = data[i]
            scene_id = f"scene{int(room_id):04d}_{int(seq_id):02d}"
            out.append((scene_id, int(ins_0), int(ins_1),
                        np.asarray(K_dict[scene_id], np.float32)))
        return out

    def __len__(self):
        return len(self.instances)

    def _rgb(self, path):
        from PIL import Image

        img = np.array(Image.open(path).convert("RGB"), np.float32) / 255.0
        img = resize(torch.from_numpy(img), (480, 640), mode="bilinear",
                     antialias=True).numpy()
        return (img - 0.5) / 0.5

    def _dep(self, path):
        from PIL import Image

        return np.array(Image.open(path), np.float32) / 1000.0

    def __getitem__(self, index):
        s_id, ins_0, ins_1, K = self.instances[index]
        root = os.path.join(self.root, s_id)
        rgb_0 = self._rgb(os.path.join(root, f"color/{ins_0}.jpg"))
        rgb_1 = self._rgb(os.path.join(root, f"color/{ins_1}.jpg"))
        dep_0 = self._dep(os.path.join(root, f"depth/{ins_0}.png"))
        dep_1 = self._dep(os.path.join(root, f"depth/{ins_1}.png"))
        if dep_0.shape != (480, 640):
            dep_0 = resize_nearest(dep_0[..., None], (480, 640))[..., 0]
            dep_1 = resize_nearest(dep_1[..., None], (480, 640))[..., 0]

        Rt_0 = np.loadtxt(os.path.join(root, f"pose/{ins_0}.txt"),
                          delimiter=" ").astype(np.float32)
        Rt_1 = np.loadtxt(os.path.join(root, f"pose/{ins_1}.txt"),
                          delimiter=" ").astype(np.float32)
        Rt_01 = np.linalg.inv(Rt_1) @ Rt_0

        return {
            "uid": np.int32(index),
            "frame_0": np.int32(ins_0),
            "frame_1": np.int32(ins_1),
            "K": K,
            "rgb_0": rgb_0.astype(np.float32),
            "rgb_1": rgb_1.astype(np.float32),
            "depth_0": dep_0.astype(np.float32),
            "depth_1": dep_1.astype(np.float32),
            "Rt_0": np.eye(4, dtype=np.float32),
            "Rt_1": Rt_01.astype(np.float32),
        }
