"""The port's spans (``utils/profiling.py``): nothing entered while no
profiler is on; under ``torch.profiler.profile`` and under the low-level
Kineto calls (``torch.autograd._enable_profiler``, as a profiler driven
from outside the program enables it), a probe training epoch and a ViT
forward emit the spans of ``SPANS`` where the work happens, each a
``cpu_op`` event and none a user annotation; ``trace()``'s Chrome trace
holds them; the losses of a training epoch are the same bits with the
profiler on and off."""

from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch

from midvision_probe_torch.engine.probe_fit import ProbeTrainer
from midvision_probe_torch.models import zoo
from midvision_probe_torch.models.probes import DepthHead
from midvision_probe_torch.ops.image import resize
from midvision_probe_torch.utils import profiling
from midvision_probe_torch.utils.losses import depth_loss

STEP_SPANS = ("mvp.engine.h2d", "mvp.probe.forward", "mvp.probe.backward",
              "mvp.engine.optimizer")
BLOCK_SPANS = ("mvp.backbone.attention", "mvp.backbone.mlp")
HW = (32, 48)
BATCH = 2


class _LowLevel:
    """Kineto enabled and read through ``torch.autograd``'s low-level calls,
    as an outside profiler does: ``torch.autograd.profiler``'s own flag
    stays false under it."""

    def __enter__(self):
        from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
        from torch.autograd import (ProfilerConfig, ProfilerState, _enable_profiler,
                                    _prepare_profiler)
        self._config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                      _ExperimentalConfig())
        activities = {ProfilerActivity.CPU}
        _prepare_profiler(self._config, activities)
        _enable_profiler(self._config, activities)
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler
        self.events = _disable_profiler().events()


class _Profile:
    """``torch.profiler.profile`` on the CPU, its Kineto events kept."""

    def __enter__(self):
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        self.events = self._prof.profiler.kineto_results.events()


PROFILERS = {"profile": _Profile, "low_level": _LowLevel}


def _spans(events) -> list[tuple[int, int, str]]:
    """The program's span events as (start, end, name), sorted by start;
    each checked to be a span of ``SPANS`` and no user annotation."""
    out = []
    for ev in events:
        if ev.name().startswith("mvp."):
            assert ev.name() in profiling.SPANS
            assert not ev.is_user_annotation(), ev.name()
            out.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
    return sorted(out)


def _inside(outer, spans):
    s, e, _ = outer
    return [x for x in spans if s <= x[0] and x[1] <= e and x is not outer]


def _extractor():
    return zoo.build_vit_extractor("test_tiny_vit", return_multilayer=True, device="cpu")


def _loss(pred, batch):
    """``train_depth``'s: the prediction resized to the target, then
    ``depth_loss``."""
    target = batch["depth"]
    return depth_loss(resize(pred, target.shape[1:3], mode="bilinear"), target)


def _trainer(backbone):
    probe = DepthHead(feat_dim=backbone.feat_dim, head_type="dpt", hidden_dim=16,
                      prediction_type="bindepth", kernel_size=3)
    trainer = ProbeTrainer(backbone, probe, _loss, n_steps=4, warmup_steps=1.0,
                           add_norm=True, device="cpu")
    trainer.init()
    return trainer


def _batches(n):
    rng = np.random.default_rng(5)
    return [{"image": rng.standard_normal((BATCH, *HW, 3)).astype(np.float32),
             "depth": rng.uniform(1.0, 10.0, (BATCH, *HW, 1)).astype(np.float32),
             "_batch_id": i} for i in range(n)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, restored after: beside the other workers of a
    parallel test run, torch's thread barriers slow many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def backbone(one_torch_thread):
    return _extractor()


def test_a_span_is_the_shared_null_context_while_no_profiler_is_on():
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("mvp.backbone")
    assert first is profiling.span("mvp.probe.backward")
    assert isinstance(first, contextlib.nullcontext)
    with first:
        pass
    # an unknown name is not looked at while the profiler is off, and is
    # refused while it is on
    assert profiling.span("mvp.unknown") is first
    with _Profile() as prof, pytest.raises(KeyError, match="SPANS"):
        profiling.span("mvp.unknown")
    assert _spans(prof.events) == []


@pytest.mark.parametrize("profiler", PROFILERS)
def test_a_training_epoch_emits_its_spans_in_order(profiler, backbone):
    torch.manual_seed(0)
    trainer = _trainer(backbone)
    with PROFILERS[profiler]() as prof:
        trainer.train_epoch(_batches(2))
    spans = _spans(prof.events)
    step = [x for x in spans if x[2] in STEP_SPANS]
    assert [x[2] for x in step] == list(STEP_SPANS) * 2
    assert all(a[1] <= b[0] for a, b in zip(step, step[1:]))  # disjoint, in order
    outer = [x for x in spans if x[2] == "mvp.backbone"]
    assert len(outer) == 2
    blocks = max(backbone.multilayers) + 1
    for i, bb in enumerate(outer):
        h2d, fwd = step[4 * i], step[4 * i + 1]
        assert h2d[1] <= bb[0] and bb[1] <= fwd[0]  # copy, backbone, probe
        inner = _inside(bb, spans)
        assert [x[2] for x in inner] == list(BLOCK_SPANS) * blocks
    assert len(spans) == 2 * (len(STEP_SPANS) + 1 + 2 * blocks)


@pytest.mark.parametrize("profiler", PROFILERS)
def test_a_vit_forward_emits_one_backbone_span_over_its_blocks(profiler, backbone):
    images = torch.randn(BATCH, *HW, 3)
    with torch.no_grad(), PROFILERS[profiler]() as prof:
        backbone.features(images)
    spans = _spans(prof.events)
    blocks = max(backbone.multilayers) + 1
    assert spans[0][2] == "mvp.backbone"
    inner = _inside(spans[0], spans)
    assert len(inner) == len(spans) - 1
    assert [x[2] for x in inner] == list(BLOCK_SPANS) * blocks
    for attn, mlp in zip(inner[::2], inner[1::2]):
        assert attn[1] <= mlp[0]


def test_the_chrome_trace_holds_the_spans(tmp_path, backbone):
    with torch.no_grad(), profiling.trace(str(tmp_path)) as log_dir:
        backbone.features(torch.randn(BATCH, *HW, 3))
    with open(f"{log_dir}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if str(e.get("name", "")).startswith("mvp.")]
    blocks = max(backbone.multilayers) + 1
    assert sorted(names) == sorted(["mvp.backbone"] + list(BLOCK_SPANS) * blocks)
    assert {e.get("cat") for e in events if e["name"] in names} == {"cpu_op"}


def test_the_losses_are_the_same_bits_with_the_profiler_on_and_off(backbone):
    losses = []
    for profiler in (contextlib.nullcontext, _LowLevel):
        torch.manual_seed(0)
        trainer = _trainer(backbone)
        with profiler():
            trainer.train_epoch(_batches(2))
        losses.append(np.asarray(trainer.step_losses, dtype=np.float32))
    assert losses[0].tobytes() == losses[1].tobytes()
