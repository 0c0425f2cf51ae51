"""SPair-71k semantic correspondence evaluation of the PyTorch port
(counterpart of the repository's ``evaluate_spair_correspondence.py``):
PCK@0.1 per class and viewpoint difference {0, 1, 2, all}, the averaged
recall table and one row of ``spair_correspondence_final.csv``.

Usage::

    python -m midvision_probe_torch.evaluate_spair_correspondence \\
        backbone=dino_b16 data_root=<SPair-71k> [mask_feats=true] \\
        [return_heatmaps=true] [+system.device=cpu]

Pairs are batched: one backbone forward over the batch's 2B images (every
attention layer through kernel K1 on a card; float32 unless
``system.backbone_dtype`` says otherwise, as the JAX driver runs it), then
one batched error pass. Runs on cuda unless ``system.device`` says
otherwise.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np
import torch

from midvision_probe_torch.config import main
from midvision_probe_torch.datasets.spair import CLASS_IDS, SPairDataset
from midvision_probe_torch.engine.driver_common import build_dense_backbone
from midvision_probe_torch.evaluators.spair import batch_errors, make_feature_fn, patch_masks
from midvision_probe_torch.utils.logging import CSVWriter, setup_logger

THRESH = 0.10


def evaluate_dataset(feature_fn, dataset, batch_pairs=8, image_size=800,
                     mask_feats=False, return_heatmaps=False, patch_size=16):
    """Returns (recall %, confusion matrix[, heatmaps (pairs, K, h, w)])."""
    n = len(dataset)
    all_same, all_in_both, all_idx_nn, all_heat = [], [], [], []
    for start in range(0, n, batch_pairs):
        items = [dataset[i] for i in range(start, min(start + batch_pairs, n))]
        feats = feature_fn(torch.from_numpy(np.stack(
            [it["img_i"] for it in items] + [it["img_j"] for it in items])))
        device = feats.device

        def stacked(key):
            return torch.from_numpy(np.stack([it[key] for it in items])).to(device)

        b = len(items)
        masks = {}
        if mask_feats:
            segs = torch.from_numpy(np.stack([it["seg_i"] for it in items]
                                             + [it["seg_j"] for it in items])).to(device)
            # the grid from the features' own shape: a fixed-input backbone
            # emits its own grid, not image_size // patch
            pm = patch_masks(segs, patch_size, grid_hw=tuple(feats.shape[1:3]))
            masks = {"masks_i": pm[:b], "masks_j": pm[b:]}
        out = batch_errors(feats[:b], feats[b:], stacked("kps_i"), stacked("kps_j"),
                           stacked("thresh_scale"), image_size,
                           return_heatmaps=return_heatmaps, **masks)
        err_same, _, in_both, idx_nn = (o.cpu().numpy() for o in out[:4])
        if return_heatmaps:
            all_heat.append(out[4].cpu().numpy())
        all_same.append(err_same)
        all_in_both.append(in_both)
        all_idx_nn.append(idx_nn)

    err_same = np.concatenate(all_same).reshape(-1)
    in_both = np.concatenate(all_in_both).reshape(-1)
    idx_nn = np.concatenate(all_idx_nn).reshape(-1)

    sel = in_both.astype(bool)
    recall = float((err_same[sel] < THRESH).mean()) * 100.0

    K = all_same[0].shape[-1]
    src_ind = np.tile(np.arange(K), len(err_same) // K)[sel]
    tgt_ind = idx_nn[sel]
    kp_max = int(max(src_ind.max(), tgt_ind.max())) + 1 if len(src_ind) else 1
    confusion = np.zeros((kp_max, kp_max))
    np.add.at(confusion, (src_ind, tgt_ind), 1)
    if return_heatmaps:
        return recall, confusion, np.concatenate(all_heat)
    return recall, confusion


def run(cfg):
    """Evaluate every class (or ``eval_class``) at each viewpoint difference
    and append the CSV row. Returns the averaged recalls by viewpoint
    difference and the per-class table (-1 where a class has no pairs)."""
    logger = setup_logger(None, "spair")
    model = build_dense_backbone(cfg)
    feature_fn = make_feature_fn(model)

    classes = list(CLASS_IDS) if cfg.eval_class == "all" else [cfg.eval_class]
    return_heatmaps = bool(cfg.get("return_heatmaps", False))
    heat_dir = os.path.join(cfg.output_dir, "spair_heatmaps")

    class_acc = {}
    for class_name in classes:
        recall = []
        for vp_diff in [0, 1, 2, None]:
            dataset = SPairDataset(
                cfg.data_root, cfg.split, use_bbox=cfg.use_bbox,
                image_size=cfg.image_size, image_mean=cfg.image_mean,
                class_name=class_name, num_instances=cfg.num_instances, vp_diff=vp_diff)
            tag = "all" if vp_diff is None else f"{vp_diff:3d}"
            if len(dataset) > 0:
                out = evaluate_dataset(
                    feature_fn, dataset, cfg.get("batch_pairs", 8), cfg.image_size,
                    mask_feats=bool(cfg.get("mask_feats", False)),
                    return_heatmaps=return_heatmaps, patch_size=model.patch_size)
                rec = out[0]
                if return_heatmaps:
                    os.makedirs(heat_dir, exist_ok=True)
                    np.savez_compressed(
                        os.path.join(heat_dir, f"heatmaps_{class_name}_{tag.strip()}.npz"),
                        heatmaps=out[2])
                logger.info("Recall@%.2f %13s %s | %6.2f", THRESH, class_name, tag, rec)
            else:
                logger.info("Recall@%.2f %13s %s | N/A", THRESH, class_name, tag)
                rec = -1.0
            recall.append(rec)
        class_acc[class_name] = recall

    all_recall = np.asarray([class_acc[c] for c in class_acc], float)
    valid = (all_recall >= 0).astype(float)
    avg_recall = (all_recall * valid).sum(0) / np.clip(valid.sum(0), 1, None)
    for i, vp in enumerate(["0", "1", "2", "all"]):
        logger.info("Recall@%.2f view diff=%3s | %6.2f", THRESH, vp, avg_recall[i])

    os.makedirs(cfg.output_dir, exist_ok=True)
    CSVWriter(os.path.join(cfg.output_dir, "spair_correspondence_final.csv")).append({
        "Time": datetime.now().strftime("%d%m%Y-%H%M"),
        "Model Checkpoint": model.checkpoint_name,
        "Patch Size": model.patch_size,
        "Layer": str(model.layer),
        "Output": model.output,
        "Dataset": "SPair-71k",
        "Split": cfg.split,
        "Class": cfg.eval_class,
        "Num Instances": cfg.num_instances,
        "Recall (View Diff 0)": f"{avg_recall[0]:6.2f}",
        "Recall (View Diff 1)": f"{avg_recall[1]:6.2f}",
        "Recall (View Diff 2)": f"{avg_recall[2]:6.2f}",
        "Recall (View Diff all)": f"{avg_recall[3]:6.2f}",
    })
    row = {f"recall_vp_{v}": float(avg_recall[i]) for i, v in enumerate(["0", "1", "2", "all"])}
    return dict(row, class_recalls=class_acc)


entry = main("spair_correspondence")(run)

if __name__ == "__main__":
    entry()
