"""Shared driver plumbing for the port's probe trainers (counterpart of the
JAX package's ``engine/driver_common.py``), single process."""

from __future__ import annotations

import os

from midvision_probe_torch.config import Config, instantiate
from midvision_probe_torch.datasets import build_loader
from midvision_probe_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from midvision_probe_torch.engine.probe_fit import ProbeTrainer
from midvision_probe_torch.utils.device import resolve_device
from midvision_probe_torch.utils.logging import CSVWriter, maybe_wandb, setup_logger


def config_device(cfg: Config):
    """``system.device`` (default cuda; no silent CPU fallback)."""
    return resolve_device(cfg.get_path("system.device", None))


def build_backbone(cfg: Config, needs_multilayer: bool):
    """Instantiate the backbone on the config's device; DPT/multiscale heads
    need 4 taps. ``system.backbone_dtype`` selects the frozen forward's
    compute dtype (bfloat16 runs the attention kernel's tensor-core path)."""
    kwargs = {"device": config_device(cfg)}
    if needs_multilayer and not cfg.backbone.get("return_multilayer", False):
        kwargs["return_multilayer"] = True
    dtype_name = cfg.get_path("system.backbone_dtype", None)
    if dtype_name:
        kwargs["dtype"] = dtype_name
    return instantiate(cfg.backbone, **kwargs)


def probe_dtype_kwargs(cfg: Config) -> dict:
    """``system.probe_dtype``: the probe's autocast dtype (params stay f32)."""
    name = cfg.get_path("system.probe_dtype", None)
    return {"dtype": name} if name else {}


def experiment_name(cfg: Config, task: str, backbone, probe_tag: str) -> str:
    """Reference-style experiment naming (``train_depth.py:575-600``)."""
    train_info = f"{cfg.optimizer.n_epochs}ep_bs{cfg.batch_size}_lr{cfg.probe_lr}"
    parts = [task, backbone.checkpoint_name, f"layer-{backbone.layer}",
             backbone.output, probe_tag, train_info]
    if cfg.get("note", ""):
        parts.append(cfg.note)
    return "_".join(str(p) for p in parts)


def setup_experiment(cfg: Config, task: str, backbone, probe_tag: str):
    exp_name = experiment_name(cfg, task, backbone, probe_tag)
    exp_dir = os.path.join(cfg.get("output_dir", "result"), exp_name)
    os.makedirs(exp_dir, exist_ok=True)
    return exp_name, exp_dir, setup_logger(exp_dir), maybe_wandb(cfg)


def make_trainer(cfg: Config, backbone, probe, loss_fn, steps_per_epoch: int):
    if cfg.get_path("system.cache_features", False):
        raise NotImplementedError(
            "system.cache_features is not ported to PyTorch yet")
    n_epochs = cfg.optimizer.n_epochs
    return ProbeTrainer(
        backbone=backbone,
        probe=probe,
        loss_fn=loss_fn,
        probe_lr=cfg.probe_lr,
        n_steps=max(int(n_epochs * steps_per_epoch), 1),
        warmup_steps=max(cfg.optimizer.warmup_epochs * steps_per_epoch, 1e-6),
        add_norm=bool(cfg.backbone.get("add_norm", False)),
        seed=cfg.system.get("random_seed", 8),
        device=config_device(cfg),
    )


def fit(cfg: Config, trainer: ProbeTrainer, train_loader, logger, wandb,
        exp_dir: str, resume: bool = True):
    """Epoch loop with per-epoch checkpoints and exact resume."""
    trainer.init()
    ckpt_dir = os.path.join(exp_dir, "ckpt")
    start_ep = 0
    if resume:
        restored = restore_checkpoint(ckpt_dir, map_location=trainer.device)
        if restored is not None:
            state, start_ep = restored
            trainer.load_state_dict(state)
            logger.info("resumed from epoch %d", start_ep)
    n_epochs = int(cfg.optimizer.n_epochs)
    for ep in range(start_ep, n_epochs):
        train_loader.set_epoch(ep)
        loss = trainer.train_epoch(train_loader, logger=logger, wandb=wandb)
        logger.info("epoch %d/%d | train loss %.4f", ep + 1, n_epochs, loss)
        save_checkpoint(ckpt_dir, trainer.state_dict(), ep + 1)
    return trainer


def emit_csv(cfg: Config, path: str, exp_name: str, backbone, row: dict) -> dict:
    meta = {
        "exp_name": exp_name,
        "checkpoint": backbone.checkpoint_name,
        "layer": backbone.layer,
        "output": backbone.output,
        "n_epochs": cfg.optimizer.n_epochs,
        "batch_size": cfg.batch_size,
        "probe_lr": cfg.probe_lr,
        "note": cfg.get("note", ""),
    }
    meta.update(row)
    CSVWriter(path).append(meta)
    return meta


__all__ = ["build_backbone", "build_loader", "config_device", "emit_csv",
           "experiment_name", "fit", "make_trainer", "probe_dtype_kwargs",
           "setup_experiment"]
