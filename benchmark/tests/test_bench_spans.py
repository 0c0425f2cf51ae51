"""The readers of the program's spans (``spans.py``, ``metrics/*``) on
fabricated profiler events: the probe's three parts and the kernels
launched outside every program span make ``probe_ms_per_step``; the
attention, the MLP and the rest make the device time launched inside the
backbone's span; the copy's host time; the faults that raise; a program
without spans reads nothing. Then a traced run on the CPU through
``run.execute``: the spans reach the readers through ``trace.collect``."""

from __future__ import annotations

import time
import types

import pytest
import torch

from benchmark import manifest, run
from benchmark.tests import tiny
from benchmark.trace import TraceData

KERNEL = "void at::native::vectorized_elementwise_kernel<4, AddFunctor<float>>"
MEMSET = "Memset (Device)"
H2D = "Memcpy HtoD (Pageable -> Device)"
PROBE_PARTS = ("probe_fwd_ms_per_step", "probe_bwd_ms_per_step", "optim_ms_per_step")
BACKBONE_PARTS = ("attn_ms_per_step", "mlp_ms_per_step", "backbone_rest_ms_per_step")
NEW_METRICS = PROBE_PARTS + ("h2d_host_ms_per_step",) + BACKBONE_PARTS
US = 1_000  # ns


def _ctx(device, host, spans=None, steps=2):
    trace = TraceData(window=(0, 1_000 * US), device=device,
                      spans={"bench.window": [(0, 1_000 * US)], **(spans or {})},
                      host=sorted(host))
    return types.SimpleNamespace(trace=trace, steps=steps, images=steps * 16, window_s=1e-3)


def _read(name, ctx):
    return manifest.reader(name).read(ctx)


def _training_step(t0):
    """One training step's host spans from ``t0`` (us): the copy, the
    benchmark's backbone span around the program's, the probe's forward,
    backward and optimiser; and its device events, each launched in one of
    them or between them."""
    host = [((t0 + 0) * US, (t0 + 40) * US, "mvp.engine.h2d"),
            ((t0 + 5) * US, (t0 + 30) * US, "aten::copy_"),
            ((t0 + 50) * US, (t0 + 100) * US, "bench.backbone"),
            ((t0 + 51) * US, (t0 + 99) * US, "mvp.backbone"),
            ((t0 + 60) * US, (t0 + 70) * US, "mvp.backbone.attention"),
            ((t0 + 75) * US, (t0 + 85) * US, "mvp.backbone.mlp"),
            ((t0 + 110) * US, (t0 + 200) * US, "mvp.probe.forward"),
            ((t0 + 210) * US, (t0 + 400) * US, "mvp.probe.backward"),
            ((t0 + 410) * US, (t0 + 440) * US, "mvp.engine.optimizer")]
    launches = {"h2d": t0 + 10, "bb": t0 + 55, "attn": t0 + 65, "mlp": t0 + 80,
                "fwd": t0 + 150, "fwd_memset": t0 + 160, "bwd": t0 + 300, "opt": t0 + 420,
                "between": t0 + 205}
    dur = {"h2d": 30, "bb": 3, "attn": 7, "mlp": 5, "fwd": 20, "fwd_memset": 1, "bwd": 45,
           "opt": 2, "between": 4}
    device, at = [], t0 + 2
    for key, launch in launches.items():
        name = H2D if key == "h2d" else MEMSET if key == "fwd_memset" else KERNEL
        kind = "copy" if key == "h2d" else "memset" if key == "fwd_memset" else "kernel"
        device.append((at * US, (at + dur[key]) * US, name, kind, launch * US))
        at += dur[key]
    return host, device, dur


def _two_steps():
    host, device = [], []
    for t0 in (0, 450):
        h, d, dur = _training_step(t0)
        host += h
        device += d
    spans = {"bench.backbone": [(s, e) for s, e, n in host if n == "bench.backbone"]}
    # a kernel whose launch the trace did not match: outside every span
    device.append((990 * US, 995 * US, KERNEL, "kernel", None))
    return host, device, spans, dur


def test_the_probe_parts_and_the_rest_make_probe_ms_per_step():
    host, device, spans, dur = _two_steps()
    ctx = _ctx(device, host, spans)
    parts = {name: _read(name, ctx) for name in PROBE_PARTS}
    assert parts == pytest.approx({"probe_fwd_ms_per_step": 0.021,
                                   "probe_bwd_ms_per_step": 0.045,
                                   "optim_ms_per_step": 0.002}, rel=1e-12)
    outside_every_span = (2 * dur["between"] + 5) / 1e3 / 2  # ms a step
    total = _read("probe_ms_per_step", ctx)
    assert sum(parts.values()) + outside_every_span == pytest.approx(total, rel=1e-12)


def test_attention_mlp_and_rest_make_the_backbone_span():
    host, device, spans, dur = _two_steps()
    ctx = _ctx(device, host, spans)
    parts = [_read(name, ctx) for name in BACKBONE_PARTS]
    assert parts == pytest.approx([0.007, 0.005, 0.003], rel=1e-12)
    inside = ctx.trace.device_ns(kinds=("kernel", "memset"), launched_in="bench.backbone")
    assert sum(parts) == pytest.approx(inside / 1e6 / ctx.steps, rel=1e-12)
    assert sum(parts) == pytest.approx(_read("backbone_ms_per_step", ctx), rel=1e-12)


def test_the_copy_reads_its_host_time_not_its_device_time():
    host, device, spans, _ = _two_steps()
    # the window cuts the first step's copy in half
    trace = _ctx(device, host, spans)
    trace.trace.window = (20 * US, 1_000 * US)
    assert _read("h2d_host_ms_per_step", trace) == pytest.approx((20 + 40) / 1e3 / 2)
    assert _read("h2d_host_ms_per_step", _ctx(device, host, spans)) == pytest.approx(0.040)
    assert _read("h2d_ms_per_step", _ctx(device, host, spans)) == pytest.approx(0.030)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_a_span_missing_from_the_window_raises(name):
    """The program records spans, but not the one the metric reads: the
    traced run fails rather than the metric going silent."""
    host, device, spans, _ = _two_steps()
    wanted = {"probe_fwd_ms_per_step": "mvp.probe.forward",
              "probe_bwd_ms_per_step": "mvp.probe.backward",
              "optim_ms_per_step": "mvp.engine.optimizer",
              "h2d_host_ms_per_step": "mvp.engine.h2d",
              "attn_ms_per_step": "mvp.backbone.attention",
              "mlp_ms_per_step": "mvp.backbone.mlp",
              "backbone_rest_ms_per_step": "mvp.backbone"}[name]
    host = [h for h in host if h[2] != wanted]
    with pytest.raises(LookupError, match=wanted):
        _read(name, _ctx(device, host, spans))


@pytest.mark.parametrize("name", NEW_METRICS)
def test_a_device_event_named_like_a_span_raises(name):
    """A span's shadow on the device's timeline would count as device work."""
    host, device, spans, _ = _two_steps()
    device.append((996 * US, 998 * US, "mvp.probe.forward", "kernel", 150 * US))
    with pytest.raises(LookupError, match="named like program spans"):
        _read(name, _ctx(device, host, spans))


@pytest.mark.parametrize("name", NEW_METRICS)
def test_a_program_without_spans_reads_nothing(name):
    """A program older than its spans: its traced run reads nothing here
    and does not fail."""
    host, device, spans, _ = _two_steps()
    host = [h for h in host if not h[2].startswith("mvp.")]
    assert _read(name, _ctx(device, host, spans)) is None


def test_a_traced_cpu_run_hands_the_spans_to_the_readers():
    """A tiny training cell traced on the CPU: no device events, so the
    device-time readers read nothing, and the copy's host time reads."""
    cfg, mix = tiny.config(), tiny.mix("train_dpt")
    limits = {k: {"limit": 1.0} for k in ("tap_err", "pred_err", "loss_gap", "grad_gap",
                                           "delta_gap")}
    entries = [{"name": n, "unit": "ms"} for n in NEW_METRICS]
    result = run.execute("tiny", cfg, mix, limits, entries, 2**31 + 17, 0.3, True,
                         torch.device("cpu"), time.time())
    assert set(result["metrics"]) == {"h2d_host_ms_per_step"}
    assert result["metrics"]["h2d_host_ms_per_step"]["value"] > 0
