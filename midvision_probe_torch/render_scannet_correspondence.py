"""ScanNet-1500 geometric correspondence evaluation of the PyTorch port
(counterpart of the repository's ``render_scannet_correspondence.py``): 3D
recall @ {0.01 .. 0.5} m, 2D recall @ {1 .. 50} px and the rotation-binned
2 cm recall, appended to ``scannet_correspondence_final.csv``.

Usage::

    python -m midvision_probe_torch.render_scannet_correspondence \\
        backbone=dino_b16 dataset=synthetic_scannet_hard dataset.image_hw=[480,640] \\
        num_corr=1000 scale_factor=0.25 batch_pairs=4 [+render_every=10] \\
        [+system.backbone_dtype=bfloat16] [+system.device=cpu]

The path per pair batch: the frozen backbone's dense forward on both views
(kernel K1 on a card), L2-normalised f32 features, depth maps and
intrinsics at ``scale_factor``, unprojection, bilinear feature sampling at
the points, one batched 2-NN search (kernel K4 on a card), the ratio test
and top-k, then 3D/2D errors. Every ``render_every``-th pair (default
10; 0 renders none) gets the qualitative renders of its real matches and
their error counts under ``instance_{idx}/`` (``utils/reporting.py``).
Runs on cuda unless ``system.device`` says otherwise. Single process: the
multi-host sharding of the JAX driver is not ported.
"""

from __future__ import annotations

import os
from datetime import datetime

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
from midvision_probe_torch.utils.reporting import (
    save_correspondence_json,
    visualize_and_save_correspondences,
)


def run(cfg):
    """Evaluate every pair of the configured dataset (the ScanNet-1500 reader
    under ``scannet_root`` when none is configured). Returns the per-match
    errors (N_pairs, num_corr), their ``valid`` mask and the CSV row."""
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
    render_every = int(cfg.get("render_every", 10))
    render_dir = os.path.join(
        cfg.output_dir,
        f"scannet_correspondence_{datetime.now().strftime('%Y%m%d_%H%M%S')}",
        str(model.checkpoint_name))
    err_3d, err_2d, valid, rel_ang = [], [], [], []
    seen = 0
    for batch in loader:
        f0 = feature_fn(batch["rgb_0"])
        f1 = feature_fn(batch["rgb_1"])
        hw = (int(batch["depth_0"].shape[1] * sf), int(batch["depth_0"].shape[2] * sf))
        d0 = np.stack([resize_nearest(d[..., None], hw)[..., 0] for d in batch["depth_0"]])
        d1 = np.stack([resize_nearest(d[..., None], hw)[..., 0] for d in batch["depth_1"]])
        K = np.array(batch["K"], np.float32)
        K[:, :2, :] *= sf
        Rt_01 = np.asarray(batch["Rt_1"], np.float32)
        e3, e2, uv0, uv1, ok = scannet_batch_errors(
            f0, f1, torch.as_tensor(d0, device=device), torch.as_tensor(d1, device=device),
            torch.as_tensor(K, device=device), torch.as_tensor(Rt_01, device=device),
            num_corr=cfg.num_corr)
        e3, e2, ok = e3.cpu().numpy(), e2.cpu().numpy(), ok.cpu().numpy()
        ang = rotation_degrees(Rt_01)
        err_3d.append(e3)
        err_2d.append(e2)
        valid.append(ok)
        rel_ang.append(ang)

        # every render_every-th pair, counted across batches: its real
        # matches only, at the views' own resolution
        for b in range(len(ok)):
            idx = seen + b
            if render_every <= 0 or idx % render_every:
                continue
            inst_dir = os.path.join(render_dir, f"instance_{idx}")
            sel = ok[b]
            visualize_and_save_correspondences(
                np.asarray(batch["rgb_0"][b]), np.asarray(batch["rgb_1"][b]),
                uv0[b].cpu().numpy()[sel] / sf, uv1[b].cpu().numpy()[sel] / sf,
                e2[b][sel], inst_dir)
            save_correspondence_json(e2[b][sel], e3[b][sel], ang[b], inst_dir)
        seen += len(ok)

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
