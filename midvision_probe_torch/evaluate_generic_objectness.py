"""Training-free object discovery by MaskCut, the PyTorch port's counterpart
of the repository's ``evaluate_generic_objectness.py``.

Usage::

    python -m midvision_probe_torch.evaluate_generic_objectness backbone=dino_b16 \\
        dataset=voc [maskcut.fixed_size=480] [max_images=N] [+system.device=cpu]

Per image of VOC's ``trainval`` split: the spectral bipartition of the
frozen backbone's patch features at ``maskcut.fixed_size`` squared, refined
by the DenseCRF (``models/maskcut.py``), with as many masks as the image's
annotation has objects; scored against the ground-truth mask by F-measure,
IoU, accuracy and CorLoc, averaged over the images that succeeded. A
per-image failure is logged and counted (reference ``:195-260``); when every
image fails the run exits non-zero before the CSV append. The row of
``final_results_summary_<dataset>.csv`` has the JAX driver's columns in its
order. The backbone runs in float32 (the JAX driver reads no
``system.backbone_dtype``) on cuda unless ``system.device`` says otherwise.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np

from midvision_probe_torch.config import instantiate, main
from midvision_probe_torch.datasets import build_loader
from midvision_probe_torch.datasets.transforms import resize_nearest
from midvision_probe_torch.engine.driver_common import config_device
from midvision_probe_torch.models.maskcut import MaskCutProcessor
from midvision_probe_torch.utils.logging import CSVWriter, setup_logger
from midvision_probe_torch.utils.objectness import (
    compute_accuracy,
    compute_corloc,
    compute_f_measure,
    compute_iou,
    compute_precision_recall,
)


def predict(processor, dataset, logger, max_images=-1):
    """``evaluate_generic_objectness.py:180-279``: running metric sums over
    the images that succeed -> (averages, images that succeeded, errors)."""
    avg = {"F-measure": 0.0, "IoU": 0.0, "Accuracy": 0.0, "CorLoc": 0.0}
    n_ok = 0
    errors = []
    n = len(dataset) if max_images in (-1, None) else min(max_images, len(dataset))
    for i in range(n):
        try:
            item = dataset[i]
            raw = (item["raw_image"] * 255).astype(np.uint8)
            gt = item["mask"][..., 0]
            num_objects = int(item.get("num_objects", 1))
            _, _, combined = processor.process_image(raw, num_objects)
            combined = combined.astype(np.float32)
            if combined.shape != gt.shape:
                combined = resize_nearest(combined[..., None], gt.shape)[..., 0]
            pb = (combined >= 0.5).astype(np.uint8)
            gb = (gt >= 0.5).astype(np.uint8)
            p, r = compute_precision_recall(pb, gb)
            avg["F-measure"] += compute_f_measure(p, r)
            avg["IoU"] += compute_iou(combined, gb)
            avg["Accuracy"] += compute_accuracy(combined, gb)
            avg["CorLoc"] += compute_corloc(combined, gb)
            n_ok += 1
        except Exception as e:  # noqa: BLE001 — the reference swallows per image
            errors.append(f"image {i}: {e!r}")
            logger.warning("image %d failed", i, exc_info=True)
    if n_ok:
        avg = {k: v / n_ok for k, v in avg.items()}
    return avg, n_ok, errors


def run(cfg, dataset=None):
    """Evaluate MaskCut on ``dataset`` (default: ``cfg.dataset``'s trainval
    split); returns the averaged metrics."""
    logger = setup_logger(None, "maskcut")
    model = instantiate(cfg.backbone, output="dense", device=config_device(cfg))
    if dataset is None:
        dataset = build_loader(cfg.dataset, "trainval", 1).dataset
    processor = MaskCutProcessor(
        backbone=model,
        patch_size=model.patch_size or 16,
        tau=cfg.get_path("maskcut.tau", 0.15),
        fixed_size=cfg.get_path("maskcut.fixed_size", 480),
    )
    metrics, n_ok, errors = predict(processor, dataset, logger, cfg.get("max_images", -1))
    # as the JAX driver: when every image failed the run proved nothing, so
    # it exits non-zero before an all-0.0 row can land in the CSV
    if n_ok == 0 and len(dataset) > 0:
        raise SystemExit(f"maskcut: all {len(errors)} images failed (first: "
                         f"{errors[0] if errors else 'n/a'})")
    logger.info("MaskCut (%d imgs): F %.4f IoU %.4f Acc %.4f CorLoc %.4f",
                n_ok, metrics["F-measure"], metrics["IoU"], metrics["Accuracy"],
                metrics["CorLoc"])

    os.makedirs(cfg.output_dir, exist_ok=True)
    CSVWriter(os.path.join(
        cfg.output_dir, f"final_results_summary_{getattr(dataset, 'name', 'voc')}.csv",
    )).append({
        "Time": datetime.now().strftime("%d%m%Y-%H%M"),
        "Model Checkpoint": model.checkpoint_name,
        "Layer": str(model.layer),
        "Output": model.output,
        "Num Images": n_ok,
        "Num Errors": len(errors),
        **{k: f"{v:.4f}" for k, v in metrics.items()},
    })
    return metrics


entry = main("objectness_eval")(run)

if __name__ == "__main__":
    entry()
