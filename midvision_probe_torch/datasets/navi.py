"""NAVI dataset (copy of the JAX package's ``datasets/navi.py``), numpy
channel-last.

Same on-disk layout: ``<root>/<object>/<multiview_*|wild_set>/
{images/downsampled_*.jpg, depth/downsampled_*.png, annotations.json}``.
Behaviors preserved: multiview 90/10 scene split, wild=test
(``navi.py:62-75, 279-335``), xyz grids from disparity depth + centered
intrinsics (``:160-177``), valid-bbox square crop, normals from depth cross
products, pair partner sampled within ``max_angle`` degrees with seed 8
(``:341-384``), instance subsample ``[::4]`` (``:113``), relative-depth
normalization to (0.01, 1] (``:211-220``).
"""

from __future__ import annotations

import glob
import json
import os
from pathlib import Path

import numpy as np

from midvision_probe_torch.datasets.navi_utils import (
    bbox_crop,
    camera_matrices_from_annotation,
    center_crop,
    compute_normal,
    pixel_grid,
    read_depth,
    resize_min_side_nearest,
)
from midvision_probe_torch.datasets.transforms import normalize_image


class NAVI:
    max_depth = 1.0

    def __init__(
        self,
        path,
        name="navi",
        split="train",
        model="all",
        image_mean="imagenet",
        augment_train=False,
        rotateflip=False,
        bbox_crop=True,
        pair_dataset=False,
        max_angle=120,
        relative_depth=False,
        image_size=512,
        **_,
    ):
        if split == "train":
            collection, subpart = "multiview", "train"
        elif split == "valid":
            collection, subpart = "multiview", "test"
        elif split == "trainval":
            collection, subpart = "multiview", "all"
        elif split == "test":
            collection, subpart = "wild", "all"
        else:
            raise ValueError(f"Unknown split: {split}")

        self.data_root = Path(path)
        self.do_bbox_crop = bbox_crop
        self.relative_depth = relative_depth
        self.image_mean = image_mean
        self.image_size = int(image_size)
        self.name = f"NAVI_{collection}_{subpart}" + (
            "_reldepth" if relative_depth else ""
        )

        self.data_dict = self._parse_dataset()
        self._define_split(model, collection, subpart)

        self.pair_dataset = pair_dataset
        self.max_angle = max_angle
        if pair_dataset:
            self.pair_indices = self._generate_pairs(self.instances)
        self.instances = self.instances[::4]

    # ------------------------------------------------------------- parsing
    def _parse_dataset(self):
        data_dict: dict = {}
        collections = glob.glob(str(self.data_root / "*/multiview_*"))
        collections += glob.glob(str(self.data_root / "*/wild_set"))
        for cpath in sorted(collections):
            object_id, collection_id = cpath.split("/")[-2:]
            img_files = os.listdir(os.path.join(cpath, "images"))
            img_ids = [f.split(".")[0] for f in img_files if "jpg" in f]
            img_ids = [i for i in img_ids if "_" not in i.replace(
                "downsampled_", "")]
            img_ids = sorted(
                i.replace("downsampled_", "") for i in img_ids
            )
            with open(os.path.join(cpath, "annotations.json")) as f:
                annotations = {
                    a["filename"].split(".")[0]: a for a in json.load(f)
                }
            data_dict.setdefault(object_id, {})[collection_id] = {
                "views": img_ids,
                "annotations": annotations,
            }
        return data_dict

    def _define_split(self, model, collection, subpart):
        object_names = (
            list(self.data_dict.keys()) if model == "all" else [model]
        )
        self.instances = []
        self.objects = []
        for obj_id in sorted(object_names):
            scenes = list(self.data_dict[obj_id].keys())
            if "wild_set" not in scenes or len(scenes) == 1:
                continue
            self.objects.append(obj_id)
            if collection == "wild":
                image_ids = self.data_dict[obj_id]["wild_set"]["views"]
                ann = self.data_dict[obj_id]["wild_set"]["annotations"]
                for _id in image_ids:
                    if subpart == "all":
                        self.instances.append((obj_id, "wild_set", _id))
                    elif subpart == "train" and ann[_id]["split"] == "train":
                        self.instances.append((obj_id, "wild_set", _id))
                    elif subpart == "test" and ann[_id]["split"] == "val":
                        self.instances.append((obj_id, "wild_set", _id))
            else:
                mv = sorted(s for s in scenes if "multiview" in s)
                train_split = int(0.9 * len(mv))
                if subpart == "train":
                    mv = mv[:train_split]
                elif subpart == "test":
                    mv = mv[train_split:]
                for scene in mv:
                    for _id in self.data_dict[obj_id][scene]["views"]:
                        self.instances.append((obj_id, scene, _id))
        self.objects.sort()
        self.objects = {o: i for i, o in enumerate(self.objects)}

    def _generate_pairs(self, instances):
        rng = np.random.RandomState(8)
        inst_dict: dict = {}
        for obj_id, coll_id, img_id in instances:
            inst_dict.setdefault(obj_id, {}).setdefault(coll_id, []).append(
                img_id
            )
        pair_dict: dict = {}
        for obj_id, colls in inst_dict.items():
            pair_dict[obj_id] = {}
            for col_id, img_ids in colls.items():
                anns = self.data_dict[obj_id][col_id]["annotations"]
                rots = np.stack([
                    camera_matrices_from_annotation(anns[i])[:3, :3]
                    for i in img_ids
                ])
                pair_dict[obj_id][col_id] = {}
                for i, img_id in enumerate(img_ids):
                    rel = rots[i] @ rots.transpose(0, 2, 1)
                    tr = rel[:, 0, 0] + rel[:, 1, 1] + rel[:, 2, 2]
                    ang = np.degrees(
                        np.arccos(np.clip(0.5 * tr - 0.5, -1, 1))
                    )
                    cand = (ang > 0) & (ang <= self.max_angle)
                    options = np.nonzero(cand)[0]
                    if len(options) == 0:
                        options = np.asarray([i])
                    pair_dict[obj_id][col_id][img_id] = img_ids[
                        int(rng.choice(options))
                    ]
        return pair_dict

    # -------------------------------------------------------------- items
    def __len__(self):
        return len(self.instances)

    def get_single(self, obj_id, scene_id, img_id):
        from PIL import Image, ImageOps

        anno = self.data_dict[obj_id][scene_id]["annotations"][img_id]
        scene_path = self.data_root / obj_id / scene_id
        with Image.open(scene_path / f"images/downsampled_{img_id}.jpg") as f:
            image = np.array(ImageOps.exif_transpose(f).convert("RGB"))
        # millimeters -> meters (reference navi.py:156; Rt's translation is
        # converted below — mixing the two corrupts every 3D error)
        depth = read_depth(
            str(scene_path / f"depth/downsampled_{img_id}.png")) / 1000.0
        valid = depth[depth > 0]
        min_depth = valid.min() if valid.size else 0.0

        s = self.image_size
        image = resize_min_side_nearest(image, s)
        image = center_crop(image, s).astype(np.float32) / 255.0
        depth = resize_min_side_nearest(depth[..., None], s)
        depth = center_crop(depth, s)

        orig_h, orig_w = anno["image_size"]
        fx = anno["camera"]["focal_length"] * s / min(orig_h, orig_w)
        K = np.eye(3, dtype=np.float32)
        K[0, 0] = K[1, 1] = fx
        K[0, 2] = K[1, 2] = 0.5 * s

        grid = pixel_grid(s, s)
        xyz_grid = (grid * depth) @ np.linalg.inv(K).T

        if self.do_bbox_crop:
            image, depth, xyz_grid = bbox_crop(image, depth, xyz_grid)
            bbox_hw = image.shape[0]
            image = resize_min_side_nearest(image, s)
            depth = resize_min_side_nearest(depth, s)
            xyz_grid = resize_min_side_nearest(xyz_grid, s)
            fx = fx * s / bbox_hw

        snorm = compute_normal(depth.copy(), fx)
        depth = np.where(depth < min_depth, 0.0, depth)

        K_final = np.eye(3, dtype=np.float32)
        K_final[0, 0] = K_final[1, 1] = fx
        K_final[0, 2] = K_final[1, 2] = 0.5 * self.image_size

        Rt = camera_matrices_from_annotation(anno)
        Rt[:3, 3] /= 1000.0

        if self.relative_depth:
            zero = depth == 0
            dmax = depth.max()
            depth = (depth - min_depth) / max(0.01, dmax - min_depth)
            depth = depth * 0.99 + 0.01
            depth = np.where(zero, 0.0, depth)

        return {
            "image": normalize_image(image, self.image_mean).astype(np.float32),
            "depth": depth.astype(np.float32),
            "class_id": np.int32(self.objects[obj_id]),
            "intrinsics": K_final,
            "snorm": snorm.astype(np.float32),
            "Rt": Rt,
            "xyz_grid": xyz_grid.astype(np.float32),
        }

    def __getitem__(self, index):
        if self.pair_dataset:
            obj_id, scene_id, img_id_0 = self.instances[index]
            img_id_1 = self.pair_indices[obj_id][scene_id][img_id_0]
            inst_0 = self.get_single(obj_id, scene_id, img_id_0)
            inst_1 = self.get_single(obj_id, scene_id, img_id_1)
            out = {}
            for k in inst_0:
                out[f"{k}_0"] = inst_0[k]
                out[f"{k}_1"] = inst_1[k]
            out["Rt_01"] = inst_1["Rt"] @ np.linalg.inv(inst_0["Rt"])
            out["pair_id"] = f"{img_id_0}-{img_id_1}"
            return out
        obj_id, scene_id, img_id = self.instances[index]
        return self.get_single(obj_id, scene_id, img_id)
