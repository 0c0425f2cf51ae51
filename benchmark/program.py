"""The system under test: the port's objects that a cell drives, built
through the port's own entry points. This is the only module of the
benchmark that imports ``midvision_probe_torch``, and it imports it inside
its functions, so that importing the harness loads nothing of the program.

* ``build_extractor``: ``zoo.build_vit_extractor`` as the trainers call it
  (dense taps, ``return_multilayer``, the configuration's dtype), its
  parameters made on the device and the zoo's random init on the host
  skipped, then given the seeded weights by ``load_state_dict``.
* ``build_trainer``: the ``DepthHead`` probe and ``ProbeTrainer`` through
  ``engine.driver_common.make_trainer``, with the loss of
  ``train_depth.run`` (the prediction resized to the target, then
  ``depth_loss``), initialised by ``ProbeTrainer.init`` and then given the
  seeded probe weights by ``load_state_dict``.
* ``BackboneProxy``: delegates to the extractor the trainer is handed; it
  keeps the check steps' taps, and marks the backbone's calls with a
  profiler span in traced runs.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch
from torch.autograd.profiler import record_function

BACKBONE_SPAN = "bench.backbone"


def build_extractor(cfg: dict, device, weights: dict):
    """The frozen extractor of ``cfg`` on ``device`` holding ``weights``."""
    os.environ["MVP_CHECKPOINT_DIR"] = os.path.join("build", "benchmark_no_checkpoints")
    from midvision_probe_torch.models import zoo
    random_init, zoo_log = zoo.random_init, logging.getLogger(zoo.__name__)
    zoo.random_init = lambda module, seed=0: module  # the seeded weights come next
    level = zoo_log.level
    zoo_log.setLevel(logging.ERROR)  # its notice of a random init
    try:
        with torch.device(device):
            extractor = zoo.build_vit_extractor(
                cfg["zoo"], output=cfg["output"], return_multilayer=True,
                add_norm=cfg["add_norm"], dtype=cfg["dtype"], device=device)
    finally:
        zoo.random_init = random_init
        zoo_log.setLevel(level)
    if list(extractor.multilayers) != list(cfg["taps"]):
        raise ValueError(f"{cfg['zoo']} taps {extractor.multilayers}, the configuration "
                         f"states {cfg['taps']}")
    extractor.module.load_state_dict(weights, strict=True)
    return extractor


class BackboneProxy:
    """The extractor handed to the trainer: ``features`` delegates, keeps
    a host copy of the taps while ``capture`` is a list, and runs inside
    the backbone span while ``traced``; every other attribute is the
    extractor's."""

    def __init__(self, extractor):
        self._extractor = extractor
        self.capture: list | None = None
        self.traced = False

    def __getattr__(self, name):
        return getattr(self._extractor, name)

    def features(self, images):
        span = record_function(BACKBONE_SPAN) if self.traced else contextlib.nullcontext()
        with span:
            maps = self._extractor.features(images)
        if self.capture is not None:
            self.capture.append([m.detach().to("cpu", copy=True) for m in maps])
        return maps


class DepthLoss:
    """``train_depth.run``'s loss: the prediction resized to the target,
    then ``depth_loss``. While ``capture`` is a list, each prediction is
    kept in it. ``fault`` (``(pred, target) -> (pred, target)``) plants a
    fault for the check's own test: before the capture where its
    ``at_prediction`` is true (an answer altered where it is produced),
    else after it (a loss that leaves rows out)."""

    def __init__(self, max_depth: float, fault=None):
        self.max_depth = max_depth
        self.fault = fault
        self.capture: list | None = None

    def __call__(self, pred, batch):
        from midvision_probe_torch.ops.image import resize
        from midvision_probe_torch.utils.losses import depth_loss
        target = batch["depth"]
        pred = resize(pred, target.shape[1:3], mode="bilinear")
        fault = self.fault
        if fault is not None and fault.at_prediction:
            pred, target = fault(pred, target)
        if self.capture is not None:
            self.capture.append(pred.detach().clone())
        if fault is not None and not fault.at_prediction:
            pred, target = fault(pred, target)
        return depth_loss(pred, target, max_depth=self.max_depth)


def _config(tree):
    from midvision_probe_torch.config.core import Config
    if isinstance(tree, dict):
        return Config({k: _config(v) for k, v in tree.items()})
    return tree


def build_trainer(cfg: dict, backbone, loss_fn, device, weights: dict,
                  probe_dtype: str | None, system: dict | None = None):
    """``ProbeTrainer`` for ``cfg``'s depth probe on ``backbone``, its
    probe and tap norms holding ``weights``; ``system`` overrides the run
    configuration's ``system`` settings (a mix's ``trainer``)."""
    from midvision_probe_torch.engine.driver_common import make_trainer
    from midvision_probe_torch.models.probes import DepthHead
    p, o = cfg["probe"], cfg["optimizer"]
    probe = DepthHead(feat_dim=backbone.feat_dim, head_type=p["head_type"],
                      min_depth=p["min_depth"], max_depth=p["max_depth"],
                      prediction_type=p["prediction_type"], hidden_dim=p["hidden_dim"],
                      kernel_size=p["kernel_size"], dtype=probe_dtype)
    run_cfg = _config({
        "probe_lr": o["probe_lr"],
        "optimizer": {"n_epochs": o["n_epochs"], "warmup_epochs": o["warmup_epochs"]},
        "backbone": {"add_norm": cfg["add_norm"]},
        "system": {"device": str(device), "num_devices": -1, "random_seed": 8,
                   "cache_features": False, **(system or {})},
    })
    trainer = make_trainer(run_cfg, backbone, probe, loss_fn, o["steps_per_epoch"])
    trainer.init()
    trainer.modules.load_state_dict(weights, strict=True)
    return trainer


def attention_launches() -> dict:
    """K1's launches by route so far (``ops.vit_attention.route_launches``)."""
    from midvision_probe_torch.ops import vit_attention
    return dict(vit_attention.route_launches)
