"""2AFC perceptual-similarity evaluation of the PyTorch port (counterpart of
the repository's ``evaluate_model_percepture.py``).

Usage::

    python -m midvision_probe_torch.evaluate_model_percepture backbone=clip_b16 \\
        dataset=twoafcdataset [+system.device=cpu]

Of each triplet's left and right image, the one whose global embedding is
closer to the reference's in cosine similarity is chosen (a ViT's last cls
token; the global average of the last map when there is none, as for
SigLIP; reference ``:105-131``), and the choices are scored against the
human vote by accuracy, F1, precision and recall. The three images of a
batch go through the frozen backbone as one stacked (3B) forward, in
float32 as the JAX driver runs it (it reads no ``system.backbone_dtype``).
Runs on cuda unless ``system.device`` says otherwise. Under ``torchrun``
each rank scores its shard of the triplets, the (vote, choice) rows are
gathered in rank order without the shards' wrapped repeats, and rank 0
writes the CSV row.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np
import torch

from midvision_probe_torch.config import instantiate, main
from midvision_probe_torch.datasets import build_loader
from midvision_probe_torch.datasets.builder import Loader
from midvision_probe_torch.engine.driver_common import config_device
from midvision_probe_torch.parallel import multihost
from midvision_probe_torch.utils.logging import CSVWriter, setup_logger


def compute_metrics(gt, pred):
    """sklearn-equivalent binary metrics (reference ``:51-64``)."""
    gt = np.asarray(gt).astype(int)
    pred = np.asarray(pred).astype(int)
    tp = int(((pred == 1) & (gt == 1)).sum())
    fp = int(((pred == 1) & (gt == 0)).sum())
    fn = int(((pred == 0) & (gt == 1)).sum())
    accuracy = float((pred == gt).mean()) if len(gt) else 0.0
    precision = tp / (tp + fp) if (tp + fp) else 0.0
    recall = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) else 0.0
    return {"accuracy": accuracy, "f1_score": f1, "precision": precision, "recall": recall}


def choose_2afc(ref, left, right):
    """The 2AFC choice (reference ``:121-131``): 0 where ``ref`` is closer to
    ``left`` in cosine similarity, else 1 (a tie goes to the right). The
    denominator is clamped to 1e-8 as ``torch.cosine_similarity``'s."""
    def cos(a, c):
        num = (a * c).sum(dim=-1)
        den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(c, dim=-1)
        return num / den.clamp_min(1e-8)

    sim_l, sim_r = cos(ref, left), cos(ref, right)
    return np.where((sim_l > sim_r).cpu().numpy(), 0, 1)


def run(cfg, dataset=None):
    """Score the 2AFC split (or ``dataset``) and append the CSV row.
    Returns the metrics."""
    logger = setup_logger(None, "percepture")
    model = instantiate(cfg.backbone, return_cls=True, device=config_device(cfg))
    is_vit = model.arch == "vit"

    def embed(images):
        maps, cls_tokens = model.outputs(images)
        if is_vit and cls_tokens[-1] is not None:
            return cls_tokens[-1].float()
        return maps[-1].mean(dim=(1, 2)).float()  # no cls token: GAP of the last map

    shard = multihost.process_shard_args()
    if dataset is not None:
        loader = Loader(dataset, cfg.batch_size, **shard)
    else:
        loader = build_loader(cfg.dataset, cfg.get("split", "test"), cfg.batch_size,
                              **shard)

    gts, preds = [], []
    for batch in loader:
        keep = batch.pop("_valid", np.ones(len(batch["p"]), bool))
        imgs = np.concatenate([batch["img_ref"], batch["img_left"], batch["img_right"]])
        feats = embed(torch.from_numpy(imgs))
        b = batch["img_ref"].shape[0]
        preds.extend(choose_2afc(feats[:b], feats[b:2 * b], feats[2 * b:])[keep].tolist())
        gts.extend(np.asarray(batch["p"])[keep].tolist())

    gathered = multihost.gather_metrics({"gt": np.asarray(gts, np.float64),
                                         "pred": np.asarray(preds, np.float64)})
    metrics = compute_metrics(gathered["gt"].tolist(), gathered["pred"].tolist())
    logger.info("2AFC acc %.4f f1 %.4f p %.4f r %.4f", metrics["accuracy"],
                metrics["f1_score"], metrics["precision"], metrics["recall"])
    if not multihost.is_main_process():  # the CSV is rank 0's
        return metrics
    os.makedirs(cfg.output_dir, exist_ok=True)
    CSVWriter(os.path.join(cfg.output_dir, "final_results_summary.csv")).append({
        "Time": datetime.now().strftime("%d%m%Y-%H%M"),
        "Model Checkpoint": model.checkpoint_name,
        "Layer": str(model.layer),
        "Output": model.output,
        "Dataset": getattr(loader.dataset, "name", "nights_2afc"),
        **{k: f"{v:.4f}" for k, v in metrics.items()},
    })
    return metrics


entry = main("model_percepture")(run)

if __name__ == "__main__":
    entry()
