"""Shared driver plumbing for the port's probe trainers and correspondence
evaluators (counterpart of the JAX package's ``engine/driver_common.py``).

Under ``torchrun`` each rank joins the process group when the driver first
asks for its device or a loader (``multihost.initialize``), reads its shard
of every loader, and rank 0 alone writes the CSV and talks to wandb."""

from __future__ import annotations

import os
from datetime import datetime

from midvision_probe_torch.config import Config, instantiate
from midvision_probe_torch.datasets import build_loader as _build_loader
from midvision_probe_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from midvision_probe_torch.engine.probe_fit import ProbeTrainer
from midvision_probe_torch.parallel import multihost
from midvision_probe_torch.utils.device import resolve_device
from midvision_probe_torch.utils.logging import CSVWriter, maybe_wandb, setup_logger


def config_device(cfg: Config):
    """``system.device`` (default the rank's card; no silent CPU fallback),
    after joining the process group under ``torchrun`` (NCCL on cards,
    gloo with ``+system.device=cpu``)."""
    device = cfg.get_path("system.device", None)
    multihost.initialize(device=device)
    return resolve_device(device)


def build_loader(dataset_cfg, split, batch_size, **kwargs):
    """The dataset loader with this rank's shard (``DistributedSampler``):
    joins the process group first, as the JAX ``build_loader`` does."""
    multihost.initialize()
    return _build_loader(dataset_cfg, split, batch_size, **multihost.process_shard_args(),
                         **kwargs)


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


def build_dense_backbone(cfg: Config):
    """The frozen backbone of a correspondence driver: dense output and
    ``cfg.multilayer`` taps on the config's device, ``system.backbone_dtype``
    as its compute dtype."""
    kwargs = {"device": config_device(cfg)}
    dtype_name = cfg.get_path("system.backbone_dtype", None)
    if dtype_name:
        kwargs["dtype"] = dtype_name
    return instantiate(cfg.backbone, output="dense",
                       return_multilayer=cfg.multilayer, **kwargs)


def cache_shuffle_kwargs(cfg: Config) -> dict:
    """Train-loader kwargs for ``system.cache_features``: the cache keys
    features by batch, so a batch's composition stays fixed across epochs
    (no sample shuffling) while the batches' order is permuted per epoch.
    Without the cache, nothing (the loader's sample shuffling applies)."""
    if cfg.get_path("system.cache_features", False):
        return {"shuffle": False, "shuffle_batch_order": True}
    return {}


def probe_dtype_kwargs(cfg: Config) -> dict:
    """``system.probe_dtype``: the probe's compute dtype (params stay f32)."""
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
    # wandb on rank 0 only; the other ranks get the no-op stub
    wandb = maybe_wandb(cfg if multihost.is_main_process() else None)
    return exp_name, exp_dir, setup_logger(exp_dir), wandb


def make_trainer(cfg: Config, backbone, probe, loss_fn, steps_per_epoch: int):
    n_epochs = cfg.optimizer.n_epochs
    return ProbeTrainer(
        backbone=backbone,
        probe=probe,
        loss_fn=loss_fn,
        probe_lr=cfg.probe_lr,
        n_steps=max(int(n_epochs * steps_per_epoch), 1),
        warmup_steps=max(cfg.optimizer.warmup_epochs * steps_per_epoch, 1e-6),
        add_norm=bool(cfg.backbone.get("add_norm", False)),
        num_devices=cfg.system.get("num_devices", -1),
        seed=cfg.system.get("random_seed", 8),
        device=config_device(cfg),
        cache_features=bool(cfg.get_path("system.cache_features", False)),
    )


def init_from_loader(trainer: ProbeTrainer, loader) -> None:
    """Draw the init batch from ``loader`` as the JAX drivers do
    (``trainer.init(next(iter(loader)))``), then init the trainer (its
    shapes come from the backbone's feature spec, so the batch goes
    unused). The draw matters for a reader whose items advance a
    RandomState (NYU's augmentation): the abandoned iterator's producer
    has read 2-4 batches by the time it stops, as the JAX loader's has."""
    next(iter(loader))
    trainer.init()


def fit(cfg: Config, trainer: ProbeTrainer, train_loader, logger, wandb,
        exp_dir: str, resume: bool = True):
    """Epoch loop with per-epoch checkpoints and exact resume."""
    init_from_loader(trainer, train_loader)
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
    if multihost.is_main_process():  # every rank holds the gathered metrics
        CSVWriter(path).append(meta)
    return meta


def append_correspondence_csv(cfg: Config, file_name: str, backbone,
                              dataset_name: str, row: dict) -> None:
    """One row of a correspondence driver's results CSV (the JAX drivers'
    columns), written by rank 0."""
    if not multihost.is_main_process():
        return
    os.makedirs(cfg.output_dir, exist_ok=True)
    CSVWriter(os.path.join(cfg.output_dir, file_name)).append({
        "Time": datetime.now().strftime("%d%m%Y-%H%M"),
        "Model Checkpoint": backbone.checkpoint_name,
        "Patch Size": backbone.patch_size,
        "Layer": str(backbone.layer),
        "Output": backbone.output,
        "Num Correspondences": cfg.num_corr,
        "Scale Factor": cfg.scale_factor,
        "Dataset": dataset_name,
        **row,
    })


__all__ = ["append_correspondence_csv", "build_backbone", "build_dense_backbone",
           "build_loader", "cache_shuffle_kwargs", "config_device", "emit_csv",
           "experiment_name", "fit", "init_from_loader", "make_trainer", "probe_dtype_kwargs",
           "setup_experiment"]
