"""The probe-training engine (counterpart of the JAX package's
``engine/probe_fit.py``), single device.

Each step runs the frozen backbone under ``torch.no_grad()`` (the
counterpart of ``jax.lax.stop_gradient`` on the tapped features), the
optional per-tap BatchNorms and the probe, the task loss, backward and an
AdamW step with the cosine-warmup schedule. Features enter the probe in
float32; ``system.probe_dtype`` autocasts the probe. The feature cache of
the JAX engine is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn as nn

from midvision_probe_torch.models.feature_extractor import FeatureExtractor
from midvision_probe_torch.models.probes import TapNorms, _channels, init_probe_
from midvision_probe_torch.utils.device import resolve_device, resolve_dtype
from midvision_probe_torch.utils.optim import make_adamw


_LOG_EVERY = 50  # train steps between loss log lines


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays of a loader batch -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}


@dataclasses.dataclass
class ProbeTrainer:
    """Train a probe (plus optional tap-norms) on frozen features.

    Args:
        backbone: frozen FeatureExtractor.
        probe: ``nn.Module`` taking the list of NHWC feature maps.
        loss_fn: ``(pred, batch) -> scalar`` (NHWC pred at probe resolution).
        probe_lr / n_steps / warmup_steps: AdamW + cosine-with-warmup recipe.
        add_norm: train per-tap BatchNorms (reference ``add_norm``).
        seed: seeds the probe's random init.
        device: default cuda; raises without a card unless given.
    """

    backbone: FeatureExtractor
    probe: nn.Module
    loss_fn: Callable[[torch.Tensor, dict], torch.Tensor]
    probe_lr: float = 5e-4
    n_steps: int = 1000
    warmup_steps: float = 150.0
    add_norm: bool = False
    seed: int = 8
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # one entry per tap: a width, or a ResNet's (C, hw) pair
        dims = self.backbone.feat_dim
        dims = dims if isinstance(dims, list) else [dims]
        self.tap_norms = TapNorms(_channels(dims)) if self.add_norm else None
        # the trained modules: probe + tap-norms (state_dict keys probe.*, tap.*)
        self.modules = nn.ModuleDict({"probe": self.probe})
        if self.tap_norms is not None:
            self.modules["tap"] = self.tap_norms
        dtype = getattr(self.probe, "dtype", None)
        self.probe_dtype = resolve_dtype(dtype) if dtype else None
        self.optimizer = None
        self.scheduler = None
        self.step = 0
        self.step_losses: list[float] = []

    # ---------------------------------------------------------------- init
    def init(self) -> None:
        """Seeded random init of tap-norms + probe (shapes come from the
        backbone's feature spec), and a fresh optimizer."""
        gen = torch.Generator().manual_seed(self.seed)
        for m in self.modules.values():
            init_probe_(m, gen)
        self.modules.to(self.device)
        self.optimizer, self.scheduler = make_adamw(
            self.modules.parameters(), self.probe_lr, self.n_steps, self.warmup_steps)
        self.step = 0

    def state_dict(self) -> dict:
        return {"modules": self.modules.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.modules.load_state_dict(state["modules"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])

    # ------------------------------------------------------------- forward
    def _forward(self, images: torch.Tensor, train: bool) -> torch.Tensor:
        feats = [f.float() for f in self.backbone.features(images)]
        self.modules.train(train)
        if self.tap_norms is not None:
            feats = self.tap_norms(feats)
        with torch.autocast(self.device.type, dtype=self.probe_dtype or torch.float32,
                            enabled=self.probe_dtype is not None):
            pred = self.probe(feats)
        return pred.float()

    # ---------------------------------------------------------------- step
    def train_epoch(self, loader, logger=None, wandb=None) -> float:
        losses = []
        t0 = time.time()
        for i, batch in enumerate(loader):
            batch = batch_to_device(batch, self.device)
            loss = self.loss_fn(self._forward(batch["image"], train=True), batch)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            self.scheduler.step()
            self.step += 1
            losses.append(loss.detach())
            if logger and (i + 1) % _LOG_EVERY == 0:
                logger.info("step %d | loss %.4f | %.2f it/s", self.step,
                            float(torch.stack(losses[-_LOG_EVERY:]).mean()),
                            (i + 1) / (time.time() - t0))
            if wandb:  # the stub is falsy: no per-step host copy
                wandb.log({"loss_batch": float(losses[-1])})
        values = [float(x) for x in losses]
        self.step_losses += values
        return float(np.mean(values)) if values else float("nan")

    # ----------------------------------------------------------- inference
    @torch.no_grad()
    def predict(self, batch: dict) -> torch.Tensor:
        images = torch.as_tensor(batch["image"]).to(self.device)
        return self._forward(images, train=False)

    def validate(self, loader, metric_fn) -> dict:
        """Run ``metric_fn(pred, batch) -> dict of (B,) tensors`` over the
        loader and return concatenated numpy metrics."""
        acc: dict[str, list] = {}
        for batch in loader:
            batch = batch_to_device(batch, self.device)
            pred = self.predict(batch)
            with torch.no_grad():
                metrics = metric_fn(pred, batch)
            for k, v in metrics.items():
                acc.setdefault(k, []).append(v.reshape(-1).cpu().numpy())
        return {k: np.concatenate(v) for k, v in acc.items()}
