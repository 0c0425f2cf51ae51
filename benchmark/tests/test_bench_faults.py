"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; so does the control. The look for a card
is skipped and the rest of a run is driven on the CPU at tiny widths,
against limits set, as the cells' are, between a sound run's readings and
the faults'. Each control of a loop (``CONTROLS``) is run apart."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import calibrate, check, run
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 77
ROOM = 4.0  # the tiny limits: this many times a sound run's reading


def _run(mix_name: str, limits: dict) -> dict:
    cfg, mix = tiny.config(), tiny.mix(mix_name)
    entries = [{"name": "images_per_s", "unit": "images/s"}]
    return run.execute("tiny", cfg, mix, limits, entries, SEED, 0.3, False, CPU, time.time())


def _limits(mix_name: str) -> dict:
    cfg, mix = tiny.config(), tiny.mix(mix_name)
    sound = calibrate.one(cfg, mix, SEED, 0.3, CPU, "program")["readings"]
    return {k: {"limit": ROOM * v} for k, v in sound.items()}


@pytest.fixture(scope="module")
def extract_limits():
    return _limits("extract")


@pytest.fixture(scope="module")
def train_limits():
    return _limits("train_dpt")


def _features_with(alter):
    from midvision_probe_torch.models.feature_extractor import FeatureExtractor
    features = FeatureExtractor.features

    def broken(self, images):
        return [alter(m.clone()) for m in features(self, images)]
    return broken


def _half_left_out(m):
    m[m.shape[0] // 2:] = 0
    return m


def _token_altered(m):
    m[0, 0, 0] = m[0, 0, 1]
    return m


def test_a_sound_extraction_is_correct(extract_limits):
    assert _run("extract", extract_limits)["correct"]


@pytest.mark.parametrize("alter", [_half_left_out, _token_altered])
def test_extraction_faults(alter, extract_limits, monkeypatch):
    from midvision_probe_torch.models.feature_extractor import FeatureExtractor
    monkeypatch.setattr(FeatureExtractor, "features", _features_with(alter))
    assert not _run("extract", extract_limits)["correct"]


def test_a_sound_training_run_is_correct(train_limits):
    assert _run("train_dpt", train_limits)["correct"]


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from midvision_probe_torch.utils import losses
    depth_loss = losses.depth_loss

    def half(pred, target, **kw):
        n = pred.shape[0] // 2
        return depth_loss(pred[:n], target[:n], **kw)
    monkeypatch.setattr(losses, "depth_loss", half)


def _answer_altered(monkeypatch):
    from midvision_probe_torch.models.probes import DepthHead
    forward = DepthHead.forward

    def altered(self, feats):
        out = forward(self, feats).clone()
        out[0] = out[0] * 1.1
        return out
    monkeypatch.setattr(DepthHead, "forward", altered)


@pytest.mark.parametrize("plant", [_state_unchanged, _half_batch, _answer_altered])
def test_training_faults(plant, train_limits, monkeypatch):
    plant(monkeypatch)
    assert not _run("train_dpt", train_limits)["correct"]


@pytest.mark.parametrize("mix_name,control", [("extract", "control_taps"),
                                              ("train_dpt", "control_taps"),
                                              ("train_dpt", "control_probe")])
def test_each_control_is_not_correct(mix_name, control, extract_limits, train_limits):
    """float8 taps in the backbone's place; for training, apart from it, the
    program's own bfloat16 probe path."""
    limits = extract_limits if mix_name == "extract" else train_limits
    row = calibrate.one(tiny.config(), tiny.mix(mix_name), SEED, 0.3, CPU, control, limits)
    assert row["correct"] is False
    assert not check.verdict(row["readings"], limits)[0]


def test_the_probe_control_fails_a_probe_number(train_limits):
    """The bfloat16 probe is caught by the numbers that feed the reference
    the program's own taps, not by the backbone's."""
    readings = calibrate.one(tiny.config(), tiny.mix("train_dpt"), SEED, 0.3, CPU,
                             "control_probe")["readings"]
    probe = {k: v for k, v in train_limits.items() if k.startswith("probe_")}
    assert probe and not check.verdict(readings, probe)[0]
