"""The probe-training engine (counterpart of the JAX package's
``engine/probe_fit.py``): one card per rank.

Each step runs the frozen backbone under ``torch.no_grad()`` (the
counterpart of ``jax.lax.stop_gradient`` on the tapped features), the
optional per-tap BatchNorms and the probe, the task loss, backward and an
AdamW step with the cosine-warmup schedule. Features enter the probe in
the dtype they come in (the backbone's, or bf16 from the feature cache);
each of the probe's modules casts them to its own compute dtype, float32
or ``system.probe_dtype`` (``models/probes.py``), as flax does.

Under a process group (``torchrun``, ``parallel/multihost.py``) each rank
feeds its loader shard, and the step is the JAX step on the global batch
(the ranks' batches concatenated in rank order): the loss's sums and
counts and the BatchNorms' batch statistics are all-reduced inside the
forward (``multihost.global_batch``), so every rank computes the global
loss and the global running statistics, and the gradients of the probe
and the tap-norms are summed over the ranks before the AdamW step. A plain
average of per-rank gradients would not be that step whenever the ranks
hold different numbers of valid pixels. Rank 0's initial parameters are
broadcast to every rank.

``cache_features`` (``system.cache_features``) extracts each training
batch's features once and reuses them in later epochs, keyed by the
loader's ``_batch_id``, as the JAX engine does: features are cast to
bfloat16 in every epoch, the first included, so the probe trains on
bf16-rounded values promoted to float32 from step one. Two tiers: the
device tier holds the features and the batch's targets on the device under
``$MVP_FEATURE_CACHE_DEVICE_GB`` (default 4 GiB); the host tier holds the
features alone, charged their bytes alone, under ``$MVP_FEATURE_CACHE_GB``
(default 8 GiB); past both budgets a batch is recomputed every epoch (one
warning). The cache refuses a loader that shuffles samples.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn as nn

from midvision_probe_torch.models.feature_extractor import FeatureExtractor
from midvision_probe_torch.models.probes import TapNorms, _channels, init_probe_
from midvision_probe_torch.parallel import multihost
from midvision_probe_torch.parallel.mesh import check_num_devices, replicate, shard_batch
from midvision_probe_torch.utils.device import resolve_device
from midvision_probe_torch.utils.optim import make_adamw


_LOG_EVERY = 50  # train steps between loss log lines
_GIB = 1024**3

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ProbeTrainer:
    """Train a probe (plus optional tap-norms) on frozen features.

    Args:
        backbone: frozen FeatureExtractor.
        probe: ``nn.Module`` taking the list of NHWC feature maps.
        loss_fn: ``(pred, batch) -> scalar`` (NHWC pred at probe resolution).
        probe_lr / n_steps / warmup_steps: AdamW + cosine-with-warmup recipe.
        add_norm: train per-tap BatchNorms (reference ``add_norm``).
        num_devices: ``system.num_devices``: -1 (every rank) or the world
            size (``parallel.mesh.check_num_devices``).
        seed: seeds the probe's random init.
        device: default the rank's card; raises without one unless given.
        cache_features: reuse each batch's bf16 features across epochs.
    """

    backbone: FeatureExtractor
    probe: nn.Module
    loss_fn: Callable[[torch.Tensor, dict], torch.Tensor]
    probe_lr: float = 5e-4
    n_steps: int = 1000
    warmup_steps: float = 150.0
    add_norm: bool = False
    num_devices: int = -1
    seed: int = 8
    device: Any = None
    cache_features: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        check_num_devices(self.num_devices)
        # one entry per tap: a width, or a ResNet's (C, hw) pair
        dims = self.backbone.feat_dim
        dims = dims if isinstance(dims, list) else [dims]
        self.tap_norms = TapNorms(_channels(dims)) if self.add_norm else None
        # the trained modules: probe + tap-norms (state_dict keys probe.*, tap.*)
        self.modules = nn.ModuleDict({"probe": self.probe})
        if self.tap_norms is not None:
            self.modules["tap"] = self.tap_norms
        self.optimizer = None
        self.scheduler = None
        self.step = 0
        self.step_losses: list[float] = []
        self._feature_cache: dict = {}
        self._dev_cache_bytes = self._cache_bytes = 0
        self._dev_cache_budget = int(float(os.environ.get("MVP_FEATURE_CACHE_DEVICE_GB", "4"))
                                     * _GIB)
        self._cache_budget = int(float(os.environ.get("MVP_FEATURE_CACHE_GB", "8")) * _GIB)
        self._cache_full_warned = False

    # ---------------------------------------------------------------- init
    def init(self) -> None:
        """Seeded random init of tap-norms + probe (shapes come from the
        backbone's feature spec), rank 0's broadcast to every rank, and a
        fresh optimizer."""
        gen = torch.Generator().manual_seed(self.seed)
        for m in self.modules.values():
            init_probe_(m, gen)
        replicate(self.modules.to(self.device))
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
    def _forward(self, feats: list[torch.Tensor], train: bool) -> torch.Tensor:
        """The prediction in the dtype the head returns (bf16 from a
        sigmoid head under ``probe_dtype=bfloat16``, as in the JAX head)."""
        self.modules.train(train)
        if self.tap_norms is not None:
            feats = self.tap_norms(feats)
        return self.probe(feats)

    # ---------------------------------------------------------------- step
    def _cached_features(self, bid, batch: dict, logger=None) -> tuple[list, dict]:
        """The bf16 features and the on-device targets of the batch keyed
        ``bid``: from the device tier, from the host tier, or extracted
        (and kept in the first tier with room)."""
        cached = self._feature_cache.get(bid)
        if isinstance(cached, tuple):  # device tier: features and targets
            return cached
        image = batch.pop("image")
        batch = shard_batch(batch, self.device)
        if cached is not None:  # host tier: features only
            return [f.to(self.device, non_blocking=True) for f in cached], batch
        feats = [f.to(torch.bfloat16) for f in self.backbone.features(torch.as_tensor(image))]
        feat_bytes = sum(f.numel() * f.element_size() for f in feats)
        size = feat_bytes + sum(v.numel() * v.element_size() for v in batch.values())
        if self._dev_cache_bytes + size <= self._dev_cache_budget:
            self._feature_cache[bid] = (feats, batch)
            self._dev_cache_bytes += size
        elif self._cache_bytes + feat_bytes <= self._cache_budget:
            self._feature_cache[bid] = [f.cpu() for f in feats]
            self._cache_bytes += feat_bytes
        elif not self._cache_full_warned:
            self._cache_full_warned = True
            (logger or log).warning(
                "feature cache budgets reached (device %.1f GiB $MVP_FEATURE_CACHE_DEVICE_GB + "
                "host %.1f GiB $MVP_FEATURE_CACHE_GB) — later batches recompute",
                self._dev_cache_budget / _GIB, self._cache_budget / _GIB)
        return feats, batch

    def train_epoch(self, loader, logger=None, wandb=None) -> float:
        if self.cache_features and getattr(loader, "shuffle", False):
            raise ValueError(
                "cache_features requires fixed batch composition (shuffle=False); "
                "sample-level reshuffling would serve stale features. Use "
                "shuffle_batch_order=True for an epoch-seeded permutation of the batch "
                "order, which the cache takes.")
        grouped = multihost.in_process_group()
        losses = []
        t0 = time.time()
        for i, batch in enumerate(loader):
            # the batch's identity, stable when the loader permutes the order
            bid = batch.pop("_batch_id", i)
            # a shard's wrapped repeats train, as the reference's
            # DistributedSampler's duplicates do; only validate drops them
            batch.pop("_valid", None)
            if grouped and len(batch["image"]) != getattr(loader, "batch_size", None):
                raise ValueError(
                    "multi-process training needs full batches (drop_last train "
                    f"loaders): got {len(batch['image'])} rows for a batch size of "
                    f"{getattr(loader, 'batch_size', None)}; the ranks' batches together "
                    "make the global batch of a step")
            if self.cache_features:
                feats, batch = self._cached_features(bid, batch, logger)
            else:
                batch = shard_batch(batch, self.device)
                feats = self.backbone.features(batch["image"])
            self.optimizer.zero_grad(set_to_none=True)
            with multihost.global_batch():
                loss = self.loss_fn(self._forward(feats, train=True), batch)
                loss.backward()
            multihost.all_reduce_grads(self.modules.parameters())
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
        return self._forward(self.backbone.features(images), train=False)

    def validate(self, loader, metric_fn) -> dict:
        """Run ``metric_fn(pred, batch) -> dict of (B,) tensors`` over the
        loader and return concatenated numpy metrics.

        Rows the loader marks as a shard's wrapped repeats (``_valid``) are
        dropped, so each sample counts once; under a process group every
        rank then returns the whole dataset's metrics, its own shard's
        gathered with the others' in rank order (``gather_metrics``)."""
        acc: dict[str, list] = {}
        for batch in loader:
            valid = batch.pop("_valid", None)
            batch = shard_batch(batch, self.device)
            pred = self.predict(batch)
            with torch.no_grad():
                metrics = metric_fn(pred, batch)
            for k, v in metrics.items():
                v = v.reshape(-1)
                v = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
                if valid is not None:
                    if v.shape[0] != valid.shape[0]:
                        raise ValueError(
                            f"metric {k!r} has {v.shape[0]} rows but the batch has "
                            f"{valid.shape[0]} samples; validate expects per-sample (B,) "
                            "metrics so a shard's repeats can be dropped")
                    v = v[valid]
                acc.setdefault(k, []).append(v)
        return multihost.gather_metrics({k: np.concatenate(v) for k, v in acc.items()})
