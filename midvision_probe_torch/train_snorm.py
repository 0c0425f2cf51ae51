"""Surface-normal probe trainer of the PyTorch port (counterpart of the
repository's ``train_snorm.py``).

Usage::

    python -m midvision_probe_torch.train_snorm backbone=dino_b16 \\
        dataset=nyu probe=snorm_dpt \\
        [+system.backbone_dtype=bfloat16] [+system.device=cpu]

It composes the same YAML configs under ``configs/``. The path is the depth
trainer's with three differences kept from the reference: the prediction
is resized to the target bicubically (``a = -0.75``, no antialias), the
loss is ``angular_loss`` (with the kappa term when the probe is
``uncertainty_aware``) over the pixels with non-zero target normals, and
the metrics are the angular recalls of ``evaluate_surface_norm`` (11.25,
22.5 and 30 degrees) with the per-level keys flattened. Then the
artifacts of ``utils/reporting.py``: with ``render_images`` (the default)
the first test batch's normal maps under ``val_images/``, and the
segment-area-vs-d1 scatter under ``plots/`` over the whole test set. Runs
on cuda unless ``system.device`` says otherwise.

Not ported yet, as in the port's ``train_depth``: the feature cache.
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
from midvision_probe_torch.utils.losses import angular_loss
from midvision_probe_torch.utils.metrics import evaluate_surface_norm, segment_metrics_snorm
from midvision_probe_torch.utils.reporting import log_first_batch_images, plot_segment_area_vs_d1


def run(cfg):
    """Train (or restore, with ``is_eval=True``) and evaluate one
    surface-normal probe. Returns the CSV row plus ``train_losses``
    (per-step, not written to the CSV)."""
    head_type = cfg.probe.get("head_type", "dpt")
    backbone = build_backbone(cfg, needs_multilayer=head_type != "linear")

    train_loader = build_loader(cfg.dataset, "trainval", cfg.batch_size,
                                seed=cfg.system.get("random_seed", 8))
    test_loader = build_loader(cfg.dataset, "test", cfg.batch_size)

    uncertainty_aware = bool(cfg.probe.get("uncertainty_aware", False))
    probe = instantiate(cfg.probe, feat_dim=backbone.feat_dim, **probe_dtype_kwargs(cfg))
    exp_name, exp_dir, logger, wandb = setup_experiment(
        cfg, "snorm", backbone, probe.name_tag)
    logger.info("experiment: %s", exp_name)

    def predict_resized(pred, target):
        return resize(pred, target.shape[1:3], mode="bicubic")

    def loss_fn(pred, batch):
        target = batch["snorm"]
        mask = target.abs().sum(dim=-1) > 0
        return angular_loss(predict_resized(pred, target), target, mask[..., None],
                            uncertainty_aware=uncertainty_aware)

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

    def metric_fn(pred, batch):
        target = batch["snorm"]
        g, lv = evaluate_surface_norm(predict_resized(pred, target), target,
                                      batch.get("segmentation"),
                                      is_navi="segmentation" not in batch)
        flat = dict(g)
        for lk, lvv in lv.items():
            for k, v in lvv.items():
                flat[f"{lk}_{k}"] = v
        return flat

    res = trainer.validate(test_loader, metric_fn)
    logger.info("snorm d1 %.4f d2 %.4f d3 %.4f rmse %.2fdeg", res["d1"].mean(),
                res["d2"].mean(), res["d3"].mean(), res["rmse"].mean())

    if bool(cfg.get("render_images", True)):
        log_first_batch_images(
            lambda batch: predict_resized(trainer.predict(batch), batch["snorm"]),
            test_loader, wandb, save_dir=os.path.join(exp_dir, "val_images"),
            task="snorm")

    # per-segment d1 over the full validation set
    seg_rows = []
    for batch in test_loader:
        if "segmentation" not in batch:
            break
        target = batch["snorm"]
        pred_r = predict_resized(trainer.predict(batch), target)
        seg_rows += segment_metrics_snorm(pred_r.cpu().numpy(), target,
                                          batch["segmentation"])
    if seg_rows:
        plot = plot_segment_area_vs_d1(seg_rows, output_dir=os.path.join(exp_dir, "plots"))
        logger.info("segment-area scatter: %s (%d segments)", plot, len(seg_rows))

    # the JAX driver's columns come back from jit in sorted key order
    row = {k: float(np.mean(res[k])) for k in sorted(res)}
    csv_path = os.path.join(
        cfg.get("output_dir", "result"),
        f"snorm_results_{getattr(train_loader.dataset, 'name', 'dataset')}_final.csv")
    emit_csv(cfg, csv_path, exp_name, backbone, row)
    wandb.log(row)
    wandb.finish()
    logger.info("results appended to %s", csv_path)
    return dict(row, train_losses=list(trainer.step_losses))


entry = main("snorm_training")(run)

if __name__ == "__main__":
    entry()
