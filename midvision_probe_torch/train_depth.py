"""Depth-probe trainer of the PyTorch port (counterpart of the repository's
``train_depth.py``).

Usage::

    python -m midvision_probe_torch.train_depth backbone=dino_b16 \\
        dataset=synthetic probe=depth_dpt \\
        [+system.backbone_dtype=bfloat16] [+system.device=cpu]

It composes the same YAML configs under ``configs/``. The path: frozen ViT
forward with 4 taps (every attention layer through the CUDA kernel on a
GPU), tap-norms + DPT depth head, ``depth_loss``, AdamW with cosine warmup,
then ``evaluate_depth`` scale-aware and scale-invariant over one prediction
sweep, and one CSV row. Then the artifacts of ``utils/reporting.py``:
with ``render_images`` (the default) the first test batch's panels and the
first 6 test batches' per-image PNG/JSON/TXT dumps under ``val_images/``;
and the segment-area-vs-d1 scatter under ``plots/`` over the whole test
set. Runs on cuda unless ``system.device`` says otherwise.
``system.cache_features`` reuses each training batch's bf16 features
across epochs, under ``$MVP_FEATURE_CACHE_DEVICE_GB`` on the device and
``$MVP_FEATURE_CACHE_GB`` on the host (``engine/probe_fit.py``).

Under ``torchrun`` (``torchrun --nproc_per_node=N -m
midvision_probe_torch.train_depth ...``) each rank trains on its shard of
the batches, the step being the one of the global batch
(``engine/probe_fit.py``); the metrics and the segment rows are gathered
over the ranks, and rank 0 writes the CSV row and the scatter.
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
from midvision_probe_torch.parallel import multihost
from midvision_probe_torch.utils.losses import depth_loss
from midvision_probe_torch.utils.metrics import evaluate_depth, segment_metrics_depth
from midvision_probe_torch.utils.reporting import (
    log_first_batch_images,
    plot_segment_area_vs_d1,
    save_images_to_png,
)

SEGMENT_KEYS = ("segment_id", "image_idx", "area", "d1_ratio")


def run(cfg):
    """Train (or restore, with ``is_eval=True``) and evaluate one depth
    probe. Returns the CSV row plus ``train_losses`` (per-step, not written
    to the CSV)."""
    head_type = cfg.probe.get("head_type", "dpt")
    backbone = build_backbone(cfg, needs_multilayer=head_type != "linear")

    # the feature cache fixes each batch's composition and permutes the
    # batches' order per epoch (cache_shuffle_kwargs)
    train_loader = build_loader(cfg.dataset, "trainval", cfg.batch_size,
                                seed=cfg.system.get("random_seed", 8),
                                **cache_shuffle_kwargs(cfg))
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

    # sorted: the JAX driver's columns come back from jit in sorted key order
    both = dict(sorted(trainer.validate(test_loader, metric_fn_both).items()))
    sa = {k[4:]: v for k, v in both.items() if k.startswith("sa__")}
    si = {k[4:]: v for k, v in both.items() if k.startswith("si__")}
    logger.info(
        "scale-aware  d1 %.4f rmse %.4f | scale-invariant d1 %.4f rmse %.4f",
        sa["d1"].mean(), sa["rmse"].mean(), si["d1"].mean(), si["rmse"].mean())

    # artifacts: first-batch panels, per-segment d1 over the full validation
    # set and per-image dumps of the first 6 batches
    render_images = bool(cfg.get("render_images", True))
    is_navi = getattr(train_loader.dataset, "name", "").startswith("navi")
    val_dir = os.path.join(exp_dir, "val_images")

    def predict_resized(batch):
        return resize(trainer.predict(batch), batch["depth"].shape[1:3], mode="bilinear")

    if render_images:
        log_first_batch_images(predict_resized, test_loader, wandb, save_dir=val_dir,
                               task="depth", is_navi=is_navi)
    seg_rows = []
    for i, batch in enumerate(test_loader):
        # a shard's wrapped repeats are dropped, as validate drops them
        valid = batch.pop("_valid", None)
        has_seg = "segmentation" in batch
        if not has_seg and not (render_images and i < 6):
            break
        pred_r = predict_resized(batch).float().cpu().numpy()
        if valid is not None:
            batch = {k: (v[valid] if isinstance(v, np.ndarray) else v)
                     for k, v in batch.items()}
            pred_r = pred_r[valid]
        if has_seg:
            seg_rows += segment_metrics_depth(pred_r, batch["depth"], batch["segmentation"])
        if render_images and i < 6:
            save_images_to_png(pred_r, batch["depth"], batch.get("segmentation"),
                               batch_idx=i, task="depth", save_dir=val_dir,
                               is_navi=is_navi)
    # every rank's segments, in rank order; the scatter is rank 0's (the
    # per-image dumps above stay per rank, each of its own shard)
    seg_rows = multihost.gather_rows(seg_rows, SEGMENT_KEYS)
    if seg_rows and multihost.is_main_process():
        plot = plot_segment_area_vs_d1(seg_rows, output_dir=os.path.join(exp_dir, "plots"))
        logger.info("segment-area scatter: %s (%d segments)", plot, len(seg_rows))

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
