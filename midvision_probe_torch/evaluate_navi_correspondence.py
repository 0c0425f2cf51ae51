"""NAVI geometric correspondence evaluation of the PyTorch port (counterpart
of the repository's ``evaluate_navi_correspondence.py``): 3D recall @
{1, 2, 5} cm, 2D recall @ {5, 25, 50} px and the rotation-binned 2 cm
recall over [0, 120] degrees, appended to ``navi_correspondence_final.csv``.

Usage::

    python -m midvision_probe_torch.evaluate_navi_correspondence \\
        backbone=dino_b16 dataset=synthetic_navi_hard dataset.image_size=512 \\
        num_corr=1000 scale_factor=0.25 batch_pairs=4 \\
        [+system.backbone_dtype=bfloat16] [+system.device=cpu]

The path per pair batch: the frozen backbone's dense forward on both views
(every attention layer through kernel K1 on a card), L2-normalised f32
features, the xyz grids at ``scale_factor``, bicubic feature upsampling,
one batched 2-NN search (kernel K4 on a card), the ratio test and top-k,
then 3D/2D errors. Runs on cuda unless ``system.device`` says otherwise.
Under ``torchrun`` each rank evaluates its shard of the pairs; the error
rows, without the shards' wrapped repeats, are gathered in rank order
before the recalls, and rank 0 writes the CSV row.
"""

from __future__ import annotations

import numpy as np
import torch

from midvision_probe_torch.config import main
from midvision_probe_torch.datasets import build_loader
from midvision_probe_torch.datasets.transforms import resize_nearest
from midvision_probe_torch.engine.driver_common import (
    append_correspondence_csv,
    build_dense_backbone,
)
from midvision_probe_torch.evaluators.geometric import (
    navi_batch_errors,
    recall_row,
    rotation_degrees,
)
from midvision_probe_torch.evaluators.spair import make_feature_fn
from midvision_probe_torch.parallel import multihost
from midvision_probe_torch.utils.logging import setup_logger


def run(cfg):
    """Evaluate every pair of the configured dataset. Returns the per-match
    errors (N_pairs, num_corr), their ``valid`` mask and the CSV row."""
    logger = setup_logger(None, "navi")
    model = build_dense_backbone(cfg)
    device = model.device
    feature_fn = make_feature_fn(model)
    loader = build_loader(cfg.dataset, "test", cfg.get("batch_pairs", 4),
                          pair_dataset=True, **multihost.process_shard_args())

    err_3d, err_2d, valid, rel_ang = [], [], [], []
    sf = cfg.scale_factor
    for batch in loader:
        keep = batch.pop("_valid", np.ones(len(batch["image_0"]), bool))
        f0 = feature_fn(batch["image_0"])
        f1 = feature_fn(batch["image_1"])
        H, W = batch["xyz_grid_0"].shape[1:3]
        hw = (int(H * sf), int(W * sf))
        xyz0 = np.stack([resize_nearest(x, hw) for x in batch["xyz_grid_0"]])
        xyz1 = np.stack([resize_nearest(x, hw) for x in batch["xyz_grid_1"]])
        e3, e2, ok = navi_batch_errors(
            f0, f1, torch.as_tensor(xyz0, device=device),
            torch.as_tensor(xyz1, device=device),
            torch.as_tensor(batch["Rt_01"], device=device),
            torch.as_tensor(batch["intrinsics_1"], device=device),
            num_corr=cfg.num_corr)
        err_3d.append(e3.cpu().numpy()[keep])
        err_2d.append(e2.cpu().numpy()[keep])
        valid.append(ok.cpu().numpy()[keep])
        rel_ang.append(rotation_degrees(batch["Rt_01"])[keep])

    gathered = multihost.gather_metrics({
        "err_3d": np.concatenate(err_3d), "err_2d": np.concatenate(err_2d),
        "valid": np.concatenate(valid), "rel_ang": np.concatenate(rel_ang)})
    err_3d, err_2d = gathered["err_3d"], gathered["err_2d"]
    valid, rel_ang = gathered["valid"], gathered["rel_ang"]
    row = recall_row(err_3d, err_2d, valid, rel_ang, [0.01, 0.02, 0.05],
                     [5, 25, 50], logger)
    append_correspondence_csv(cfg, "navi_correspondence_final.csv", model,
                              getattr(loader.dataset, "name", "navi"), row)
    return {"err_3d": err_3d, "err_2d": err_2d, "valid": valid, "row": row}


entry = main("navi_correspondence")(run)

if __name__ == "__main__":
    entry()
