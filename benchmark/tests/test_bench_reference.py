"""The plain reference held against the port on the CPU at tiny widths, in
float32: the ViT taps of both families (DINOv2's LayerScale and
``dense-cls`` included), the DPT prediction, the loss and the parameters
after two AdamW steps. The test imports the port; the reference does
not."""

from __future__ import annotations

import pytest
import torch

from benchmark import inputs, manifest, program
from benchmark.reference import vit
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["dino_b16", "dinov2_l14"])
def test_backbone_taps(name, monkeypatch):
    tiny.register_layerscale_zoo(monkeypatch)
    cfg = tiny.config(name, dtype="float32")
    weights = inputs.weights(vit.param_shapes(cfg), 5, "backbone", CPU)
    extractor = program.build_extractor(cfg, CPU, weights)
    images = inputs.images(5, 0, 3, cfg["image_hw"], CPU)
    with torch.no_grad():
        got = extractor.features(images)
        ref = vit.features(weights, cfg, images)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["dino_b16", "dinov2_l14"])
def test_probe_training_steps(name, monkeypatch):
    """Prediction, losses, first gradient and the parameters after two
    AdamW steps: the session's own check at float32 on both sides, fed the
    reference's taps and fed the program's."""
    tiny.register_layerscale_zoo(monkeypatch)
    cfg = tiny.config(name, dtype="float32")
    mix = dict(tiny.mix("train_dpt"), check_steps=2)
    session = manifest.loop(mix["loop"]).Session(cfg, mix, 11, CPU)
    session.release()
    readings = session.check()
    assert readings["tap_err"] < 1e-4
    for prefix in ("", "probe_"):
        assert readings[prefix + "pred_err"] < 1e-5
        assert readings[prefix + "loss_gap"] < 1e-5
        assert readings[prefix + "grad_gap"] < 1e-4
        assert readings[prefix + "grad_gap_median"] < 1e-4
        # Adam divides each gradient by its own size: where one is near
        # nought, f32 summation order alone moves that element's update
        assert readings[prefix + "delta_gap"] < 2e-2


def test_the_weights_are_the_seeds():
    cfg = tiny.config()
    a = inputs.weights(vit.param_shapes(cfg), 2**31 + 1, "backbone", CPU)
    b = inputs.weights(vit.param_shapes(cfg), 2**31 + 1, "backbone", CPU)
    c = inputs.weights(vit.param_shapes(cfg), 2**31 + 2, "backbone", CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight"], c["blocks.0.attn.qkv.weight"])
