"""ScanNet-1500 geometric correspondence evaluation of the PyTorch port
(counterpart of the repository's ``render_scannet_correspondence.py``): 3D
recall @ {0.01 .. 0.5} m, 2D recall @ {1 .. 50} px and the rotation-binned
2 cm recall, appended to ``scannet_correspondence_final.csv``.

Usage::

    python -m midvision_probe_torch.render_scannet_correspondence \\
        backbone=dino_b16 dataset=synthetic_scannet_hard dataset.image_hw=[480,640] \\
        num_corr=1000 scale_factor=0.25 batch_pairs=4 +render_every=0 \\
        [+system.backbone_dtype=bfloat16] [+system.device=cpu]

The path per pair batch: the frozen backbone's dense forward on both views
(kernel K1 on a card), L2-normalised f32 features, depth maps and
intrinsics at ``scale_factor``, unprojection, bilinear feature sampling at
the points, one batched 2-NN search (kernel K4 on a card), the ratio test
and top-k, then 3D/2D errors. Runs on cuda unless ``system.device`` says
otherwise. Single process: the multi-host sharding of the JAX driver is not
ported. The qualitative pair renders need ``utils/reporting.py``, which is
not ported yet: ``render_every > 0`` (the default, 10) raises.
"""

from __future__ import annotations

import numpy as np
import torch

from midvision_probe_torch.config import instantiate, main
from midvision_probe_torch.datasets.builder import Loader
from midvision_probe_torch.datasets.transforms import resize_nearest
from midvision_probe_torch.engine.driver_common import (
    append_correspondence_csv,
    build_dense_backbone,
)
from midvision_probe_torch.evaluators.geometric import (
    recall_row,
    rotation_degrees,
    scannet_batch_errors,
)
from midvision_probe_torch.evaluators.spair import make_feature_fn
from midvision_probe_torch.utils.logging import setup_logger


def run(cfg):
    """Evaluate every pair of the configured dataset (the ScanNet-1500 reader
    under ``scannet_root`` when none is configured). Returns the per-match
    errors (N_pairs, num_corr), their ``valid`` mask and the CSV row."""
    if int(cfg.get("render_every", 10)) > 0:
        raise NotImplementedError(
            "the ScanNet pair renders need utils/reporting.py, which is not "
            "ported to PyTorch yet; pass +render_every=0")
    logger = setup_logger(None, "scannet")
    model = build_dense_backbone(cfg)
    device = model.device
    feature_fn = make_feature_fn(model)
    if cfg.get("dataset") is not None:
        dataset = instantiate(cfg.dataset)
    else:
        from midvision_probe_torch.datasets.scannet_pairs import ScanNetPairsDataset

        dataset = ScanNetPairsDataset(root=cfg.get("scannet_root",
                                                   "data/scannet_test_1500"))
    loader = Loader(dataset, cfg.get("batch_pairs", 4))

    sf = cfg.scale_factor
    err_3d, err_2d, valid, rel_ang = [], [], [], []
    for batch in loader:
        f0 = feature_fn(batch["rgb_0"])
        f1 = feature_fn(batch["rgb_1"])
        hw = (int(batch["depth_0"].shape[1] * sf), int(batch["depth_0"].shape[2] * sf))
        d0 = np.stack([resize_nearest(d[..., None], hw)[..., 0] for d in batch["depth_0"]])
        d1 = np.stack([resize_nearest(d[..., None], hw)[..., 0] for d in batch["depth_1"]])
        K = np.array(batch["K"], np.float32)
        K[:, :2, :] *= sf
        Rt_01 = np.asarray(batch["Rt_1"], np.float32)
        e3, e2, _, _, ok = scannet_batch_errors(
            f0, f1, torch.as_tensor(d0, device=device), torch.as_tensor(d1, device=device),
            torch.as_tensor(K, device=device), torch.as_tensor(Rt_01, device=device),
            num_corr=cfg.num_corr)
        err_3d.append(e3.cpu().numpy())
        err_2d.append(e2.cpu().numpy())
        valid.append(ok.cpu().numpy())
        rel_ang.append(rotation_degrees(Rt_01))

    err_3d, err_2d = np.concatenate(err_3d), np.concatenate(err_2d)
    valid, rel_ang = np.concatenate(valid), np.concatenate(rel_ang)
    row = recall_row(err_3d, err_2d, valid, rel_ang,
                     [0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5],
                     [1, 2, 5, 15, 25, 35, 50], logger)
    append_correspondence_csv(cfg, "scannet_correspondence_final.csv", model,
                              getattr(dataset, "name", "ScanNet-pairs"), row)
    return {"err_3d": err_3d, "err_2d": err_2d, "valid": valid, "row": row}


entry = main("scannet_correspondence")(run)

if __name__ == "__main__":
    entry()
