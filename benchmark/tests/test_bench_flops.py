"""The FLOP count of the plain reference: 24 N D^2 + 4 N^2 D a ViT block at
an MLP ratio of 4, plus the patch embedding's convolution; each loop adds
up the parts its step runs."""

from __future__ import annotations

import pytest

from benchmark import flops, manifest
from benchmark.tests import tiny


@pytest.mark.parametrize("output", ["dense", "dense-cls"])
def test_extraction_flops_per_image(output):
    cfg = tiny.config()
    cfg.update(mlp_ratio=4.0, output=output)
    gh, gw = (s // cfg["patch_size"] for s in cfg["image_hw"])
    n, d, p = 1 + gh * gw, cfg["width"], cfg["patch_size"]
    blocks = max(cfg["taps"]) + 1
    expected = blocks * (24 * n * d * d + 4 * n * n * d) + 2 * gh * gw * d * 3 * p * p
    assert flops.backbone_forward(cfg) == expected
    assert manifest.loop("extract").flops_per_image(cfg, tiny.mix("extract")) == expected


def test_training_adds_the_probe():
    cfg, mix = tiny.config(), tiny.mix("train_dpt")
    step = manifest.loop(mix["loop"]).flops_per_image(cfg, mix)
    assert step == flops.backbone_forward(cfg) + flops.depth_probe_step(cfg)
    assert step > 3 * flops.backbone_forward(cfg)


def test_the_mix_sets_the_probe():
    """A mix's ``probe`` settings count: a wider head does more work."""
    cfg, mix = tiny.config(), tiny.mix("train_dpt")
    loop = manifest.loop(mix["loop"])
    wider = dict(mix, probe={"hidden_dim": 2 * cfg["probe"]["hidden_dim"]})
    assert loop.flops_per_image(cfg, wider) > loop.flops_per_image(cfg, mix)
