"""The model's FLOPs per image, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the benchmark's plain
reference on the meta device (shapes only, nothing computed). A loop's
``flops_per_image`` adds up the parts its step runs. The count is the
model's work as published (nearest upsamples materialised before their
convolutions), whatever kernels the program runs it with."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import probe, vit


def _count(fn) -> float:
    with torch.device("meta"), FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


@functools.lru_cache(maxsize=8)
def _backbone_forward(cfg_json: str) -> float:
    cfg = json.loads(cfg_json)
    h, w = cfg["image_hw"]

    def forward():
        params = {k: torch.empty(s) for k, s in vit.param_shapes(cfg).items()}
        vit.features(params, cfg, torch.empty(1, h, w, 3))
    return _count(forward)


@functools.lru_cache(maxsize=8)
def _depth_probe_step(cfg_json: str) -> float:
    cfg = json.loads(cfg_json)
    h, w = cfg["image_hw"]
    gh, gw = vit.grid_hw(cfg)
    c = vit.feat_dim(cfg)

    def step():
        taps = [torch.empty(1, gh, gw, c) for _ in cfg["taps"]]
        head = {k: torch.empty(s, requires_grad=True)
                for k, s in probe.param_shapes(cfg, c).items()}
        pred = probe.resize_to(probe.predict(head, cfg, taps), (h, w))
        loss = probe.depth_loss(pred, torch.empty(1, h, w, 1), cfg["probe"]["max_depth"])
        torch.autograd.grad(loss, list(head.values()))
    return _count(step)


def backbone_forward(cfg: dict) -> float:
    """FLOPs of the backbone's forward over one image."""
    return _backbone_forward(json.dumps(cfg, sort_keys=True))


def depth_probe_step(cfg: dict) -> float:
    """FLOPs of the depth probe's forward, loss and backward on one image's
    taps (the tap norms, the DPT head, the resize and the loss)."""
    return _depth_probe_step(json.dumps(cfg, sort_keys=True))
