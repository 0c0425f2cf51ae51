"""The program's own spans in a traced window, for the per-layer metrics
that read them.

The port marks where its work happens with spans named ``mvp.*``
(``midvision_probe_torch/utils/profiling.py``, ``SPANS``). Each is a host
event on the profiler's clock, which ``trace.collect`` keeps among the
host's operators (``TraceData.host``). ``traced`` takes the intervals of
the spans a metric needs by exact name and hands back the trace with
those spans in place of the benchmark's own, so that a reader counts the
device time launched inside them by ``TraceData.device_ns``'s rule: a
device event belongs to a span when the host time of its launch lies in
one of the span's intervals, whatever thread launched it (the backward's
kernels come from autograd's thread).

A program that records no span at all (one older than its spans) reads
nothing. Where the program records spans but the window lacks one that a
metric needs, or where a device event is named like a span (a span's
shadow on the device's timeline, counted as device work), ``traced``
raises, so that the traced run fails rather than a metric going silent
or counting the wrong time.
"""

from __future__ import annotations

import dataclasses

from benchmark.trace import TraceData

PREFIX = "mvp."
DEVICE_KINDS = ("kernel", "memset")  # the device work a span is charged; copies apart

H2D = "mvp.engine.h2d"
PROBE_FORWARD = "mvp.probe.forward"
PROBE_BACKWARD = "mvp.probe.backward"
OPTIMIZER = "mvp.engine.optimizer"
BACKBONE = "mvp.backbone"
ATTENTION = "mvp.backbone.attention"
MLP = "mvp.backbone.mlp"


def traced(trace: TraceData, *names: str) -> TraceData | None:
    """``trace`` with ``spans`` holding the intervals of the program spans
    ``names``, or None where the program recorded no span; raises
    ``LookupError`` where one of ``names`` is absent from the window, or a
    device event is named like a span."""
    shadows = sorted({n for _, _, n, _, _ in trace.device if n.startswith(PREFIX)})
    if shadows:
        raise LookupError(f"device events named like program spans: {', '.join(shadows)}")
    found: dict[str, list[tuple[int, int]]] = {n: [] for n in names}
    any_span = False
    for s, e, name in trace.host:
        if name.startswith(PREFIX):
            any_span = True
            if name in found:
                found[name].append((s, e))
    if not any_span:
        return None
    missing = [n for n, iv in found.items() if not iv]
    if missing:
        raise LookupError(f"the window holds no span {', '.join(missing)}, and other "
                          "program spans")
    return dataclasses.replace(trace, spans=found)


def device_ms_per_step(ctx, name: str, less: tuple[str, ...] = ()) -> float | None:
    """Device ms a step of the kernels and memsets launched inside the span
    ``name``, less those launched inside the spans ``less`` (spans nested
    in it); None without a device trace or a step, or from a program
    without spans."""
    if ctx.steps == 0 or not ctx.trace.device:
        return None
    trace = traced(ctx.trace, name, *less)
    if trace is None:
        return None
    ns = trace.device_ns(kinds=DEVICE_KINDS, launched_in=name)
    ns -= sum(trace.device_ns(kinds=DEVICE_KINDS, launched_in=inner) for inner in less)
    return ns / 1e6 / ctx.steps


def host_ms_per_step(ctx, name: str) -> float | None:
    """The host's wall ms a step inside the span ``name``, within the
    window; None without a step, or from a program without spans."""
    if ctx.steps == 0:
        return None
    trace = traced(ctx.trace, name)
    if trace is None:
        return None
    ws, we = trace.window
    ns = sum(max(0, min(e, we) - max(s, ws)) for s, e in trace.spans[name])
    return ns / 1e6 / ctx.steps
