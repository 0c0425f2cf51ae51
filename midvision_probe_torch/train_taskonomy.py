"""Taskonomy probe trainer of the PyTorch port (counterpart of the
repository's ``train_taskonomy.py``).

Usage::

    python -m midvision_probe_torch.train_taskonomy backbone=dino_b16 \\
        dataset=taskonomy probe=taskonomy_dpt [dataset.task=reshading] \\
        [+system.backbone_dtype=bfloat16] [+system.device=cpu]

A ``TaskonomyHead`` with as many output channels as the task's target
(``output_dim`` from the first train item) trains with a masked L1 loss,
the prediction resized bilinearly to the target's size and the loss taken
where ``mask_valid > 0.5``. Validation metrics by task: principal curvature
AbsRel and ratio thresholds, reshading AbsRel and ratio thresholds on
channel 0, else the masked L1 per image; their means go to
``taskonomy_results_<task>_final.csv``. Without an HF Taskonomy directory
at the configured path the dataset is synthetic (``dataset.num_instances``,
``dataset.image_size``). Runs on cuda unless ``system.device`` says
otherwise. ``system.cache_features`` reuses each training batch's bf16
features across epochs (``engine/probe_fit.py``).
"""

from __future__ import annotations

import os

import numpy as np

from midvision_probe_torch.config import instantiate, main
from midvision_probe_torch.engine.checkpoint import restore_checkpoint
from midvision_probe_torch.engine.driver_common import (
    build_backbone,
    build_loader,
    cache_shuffle_kwargs,
    emit_csv,
    fit,
    init_from_loader,
    make_trainer,
    probe_dtype_kwargs,
    setup_experiment,
)
from midvision_probe_torch.ops.image import resize
from midvision_probe_torch.utils.losses import masked_l1_loss
from midvision_probe_torch.utils.metrics import (
    evaluate_curvature_absrel,
    evaluate_reshading_absrel_and_delta,
)


def run(cfg):
    """Train (or restore, with ``is_eval=True``) and validate one Taskonomy
    probe. Returns the CSV row's metrics plus ``train_losses`` (per-step,
    not written to the CSV)."""
    task = cfg.dataset.get("task", "principal_curvature")
    head_type = cfg.probe.get("head_type", "dpt")
    backbone = build_backbone(cfg, needs_multilayer=head_type != "linear")

    # the feature cache fixes each batch's composition and permutes the
    # batches' order per epoch (cache_shuffle_kwargs)
    train_loader = build_loader(cfg.dataset, "train", cfg.batch_size,
                                seed=cfg.system.get("random_seed", 8),
                                **cache_shuffle_kwargs(cfg))
    test_loader = build_loader(cfg.dataset, "test", cfg.batch_size)

    out_ch = train_loader.dataset[0]["target"].shape[-1]
    probe_kwargs = {"feat_dim": backbone.feat_dim, **probe_dtype_kwargs(cfg)}
    if "output_dim" in cfg.probe:
        probe_kwargs["output_dim"] = out_ch
    probe = instantiate(cfg.probe, **probe_kwargs)
    exp_name, exp_dir, logger, wandb = setup_experiment(
        cfg, f"taskonomy_{task}", backbone, getattr(probe, "name_tag", f"taskonomy_{head_type}"))
    logger.info("experiment: %s (task %s, %d channels)", exp_name, task, out_ch)

    def loss_fn(pred, batch):
        target = batch["target"]
        pred = resize(pred, target.shape[1:3], mode="bilinear")
        return masked_l1_loss(pred, target, batch["mask_valid"] > 0.5)

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
        target = batch["target"]
        pred_r = resize(pred, target.shape[1:3], mode="bilinear")
        mask = batch["mask_valid"]
        if task in ("principal_curvature", "curvature"):
            return evaluate_curvature_absrel(pred_r, target, mask)
        if task == "reshading":
            return evaluate_reshading_absrel_and_delta(
                pred_r[..., :1], target[..., :1], mask[..., :1])
        l1 = (pred_r - target).abs().mean(dim=-1)
        m = mask[..., 0]
        return {"masked_l1": (l1 * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2)).clamp_min(1)}

    res = trainer.validate(test_loader, metric_fn)
    # the JAX driver's columns come back from jit in sorted key order
    row = {k: float(np.mean(res[k])) for k in sorted(res)}
    logger.info("taskonomy %s: %s", task, {k: round(v, 4) for k, v in row.items()})
    csv_path = os.path.join(cfg.get("output_dir", "result"),
                            f"taskonomy_results_{task}_final.csv")
    emit_csv(cfg, csv_path, exp_name, backbone, row)
    wandb.log(row)
    wandb.finish()
    return dict(row, train_losses=list(trainer.step_losses))


entry = main("taskonomy_training")(run)

if __name__ == "__main__":
    entry()
