"""Depth-probe trainer of the PyTorch port (counterpart of the repository's
``train_depth.py``).

Usage::

    python -m midvision_probe_torch.train_depth backbone=dino_b16 \\
        dataset=synthetic probe=depth_dpt +render_images=False \\
        [+system.backbone_dtype=bfloat16] [+system.device=cpu]

It composes the same YAML configs under ``configs/``. The path: frozen ViT
forward with 4 taps (every attention layer through the CUDA kernel on a
GPU), tap-norms + DPT depth head, ``depth_loss``, AdamW with cosine warmup,
then ``evaluate_depth`` scale-aware and scale-invariant over one prediction
sweep, and one CSV row. Runs on cuda unless ``system.device`` says
otherwise.

Not ported yet: the PNG/wandb image dumps and the segment-area scatter of
``utils/reporting.py`` (``render_images=True`` raises; the per-segment rows
are written to ``plots/segment_area_vs_d1.csv`` instead of a scatter PNG),
and the feature cache.
"""

from __future__ import annotations

import os

import numpy as np

from midvision_probe_torch.config import instantiate, main
from midvision_probe_torch.engine.checkpoint import restore_checkpoint
from midvision_probe_torch.engine.driver_common import (
    build_backbone,
    build_loader,
    emit_csv,
    fit,
    init_from_loader,
    make_trainer,
    probe_dtype_kwargs,
    setup_experiment,
)
from midvision_probe_torch.ops.image import resize
from midvision_probe_torch.utils.logging import CSVWriter
from midvision_probe_torch.utils.losses import depth_loss
from midvision_probe_torch.utils.metrics import evaluate_depth, segment_metrics_depth


def run(cfg):
    """Train (or restore, with ``is_eval=True``) and evaluate one depth
    probe. Returns the CSV row plus ``train_losses`` (per-step, not written
    to the CSV)."""
    if bool(cfg.get("render_images", True)):
        raise NotImplementedError(
            "render_images=True needs utils/reporting.py, which is not ported "
            "to PyTorch yet; pass +render_images=False")
    head_type = cfg.probe.get("head_type", "dpt")
    backbone = build_backbone(cfg, needs_multilayer=head_type != "linear")

    train_loader = build_loader(cfg.dataset, "trainval", cfg.batch_size,
                                seed=cfg.system.get("random_seed", 8))
    test_loader = build_loader(cfg.dataset, "test", cfg.batch_size)
    max_depth = getattr(train_loader.dataset, "max_depth", 10.0)

    probe = instantiate(cfg.probe, feat_dim=backbone.feat_dim,
                        max_depth=max_depth, **probe_dtype_kwargs(cfg))
    exp_name, exp_dir, logger, wandb = setup_experiment(
        cfg, "depth", backbone, probe.name_tag)
    logger.info("experiment: %s", exp_name)

    def loss_fn(pred, batch):
        target = batch["depth"]
        pred = resize(pred, target.shape[1:3], mode="bilinear")
        return depth_loss(pred, target, max_depth=max_depth)

    trainer = make_trainer(cfg, backbone, probe, loss_fn, len(train_loader))
    if not cfg.get("is_eval", False):
        fit(cfg, trainer, train_loader, logger, wandb, exp_dir)
    else:
        init_from_loader(trainer, test_loader)
        ckpt = cfg.get("ckpt_path", "") or os.path.join(exp_dir, "ckpt")
        restored = restore_checkpoint(ckpt, map_location=trainer.device)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt}")
        trainer.load_state_dict(restored[0])

    # one prediction sweep serves both protocols (scale-aware and
    # scale-invariant are pure functions of (pred, target))
    def metric_fn_both(pred, batch):
        target = batch["depth"]
        pred_r = resize(pred, target.shape[1:3], mode="bilinear")
        flat = {}
        for tag, si_flag in (("sa", False), ("si", True)):
            g, lv = evaluate_depth(pred_r, target, batch.get("segmentation"),
                                   scale_invariant=si_flag,
                                   is_navi="segmentation" not in batch)
            for k, v in g.items():
                flat[f"{tag}__{k}"] = v
            for lk, lvv in lv.items():
                for k, v in lvv.items():
                    flat[f"{tag}__{lk}_{k}"] = v
        return flat

    both = trainer.validate(test_loader, metric_fn_both)
    sa = {k[4:]: v for k, v in both.items() if k.startswith("sa__")}
    si = {k[4:]: v for k, v in both.items() if k.startswith("si__")}
    logger.info(
        "scale-aware  d1 %.4f rmse %.4f | scale-invariant d1 %.4f rmse %.4f",
        sa["d1"].mean(), sa["rmse"].mean(), si["d1"].mean(), si["rmse"].mean())

    # per-segment d1 over the full validation set
    seg_rows = []
    for batch in test_loader:
        if "segmentation" not in batch:
            break
        pred_r = resize(trainer.predict(batch), batch["depth"].shape[1:3],
                        mode="bilinear")
        seg_rows += segment_metrics_depth(pred_r.cpu().numpy(), batch["depth"],
                                          batch["segmentation"])
    if seg_rows:
        seg_csv = CSVWriter(os.path.join(exp_dir, "plots", "segment_area_vs_d1.csv"))
        for r in seg_rows:
            seg_csv.append(r)
        logger.info("segment rows: %s (%d segments)", seg_csv.path, len(seg_rows))

    row = {}
    row.update({f"sa_{k}": float(np.mean(v)) for k, v in sa.items()})
    row.update({f"si_{k}": float(np.mean(v)) for k, v in si.items()})
    csv_path = os.path.join(
        cfg.get("output_dir", "result"),
        f"depth_results_{getattr(train_loader.dataset, 'name', 'dataset')}_final.csv")
    emit_csv(cfg, csv_path, exp_name, backbone, row)
    wandb.log(row)
    wandb.finish()
    logger.info("results appended to %s", csv_path)
    return dict(row, train_losses=list(trainer.step_losses))


entry = main("depth_training")(run)

if __name__ == "__main__":
    entry()
