"""Profiling and timing (counterpart of the JAX package's
``utils/profiling.py``): a ``torch.profiler`` trace written as a Chrome
trace, the program's own spans, a step timer that waits for the card, and
the card's memory use.

The spans (``SPANS``, entered through ``span``) mark where the port's work
happens: the batch's copy to the card, the probe's forward, backward and
optimiser step, the backbone's forward and, in each ViT block, its
attention and its MLP. Anyone who traces the port sees them, on the same
clock as the device's kernels: under ``trace()`` (Perfetto or
``chrome://tracing`` open its file) or any other ``torch.profiler``
session. A span is a ``cpu_op`` event, not a user annotation, so the
profiler mirrors no copy of it onto the device's timeline. With the
profiler off a span is a shared null context: the profiler being on is the
only switch.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

# the port's spans, outermost first where they nest
SPANS = (
    "mvp.engine.h2d",  # parallel/mesh.shard_batch: a loader batch to the card
    "mvp.probe.forward",  # ProbeTrainer.train_epoch: tap norms, probe and loss
    "mvp.probe.backward",  # ProbeTrainer.train_epoch: loss.backward()
    "mvp.engine.optimizer",  # ProbeTrainer.train_epoch: all-reduce, AdamW, schedule
    "mvp.backbone",  # FeatureExtractor.outputs: one backbone forward
    "mvp.backbone.attention",  # models/vit.py Attention.forward: qkv, attention, proj
    "mvp.backbone.mlp",  # models/vit.py Mlp.forward: fc1, activation, fc2
)
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` (one of ``SPANS``) as a span while a
    profiler is on, and the shared null context while none is. It neither
    waits for the card nor launches anything, so it may sit inside a CUDA
    graph's capture (recorded once, at capture)."""
    if not _profiler_enabled():
        return _NULL
    if name not in SPANS:
        raise KeyError(f"{name!r} is not one of profiling.SPANS")
    return _RecordFunctionFast(name)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block with ``torch.profiler`` (the CPU and, when there is
    one, the card) and write ``<log_dir>/trace.json``, a Chrome trace that
    Perfetto or ``chrome://tracing`` opens. Yields ``log_dir`` (default
    ``$TMPDIR/mvp_trace``)."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "mvp_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(out) -> None:
    """Wait for the card(s) that hold a tensor of ``out`` (nested lists,
    tuples and dicts searched)."""
    stack, devices = [out], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10, **kwargs) -> dict:
    """Wall time of ``fn(*args, **kwargs)``, waiting after each call for the
    card that holds its output. Returns {mean_ms, p50_ms, min_ms, iters}."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _sync(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "mean_ms": 1e3 * sum(times) / len(times),
        "p50_ms": 1e3 * times[len(times) // 2],
        "min_ms": 1e3 * times[0],
        "iters": iters,
    }


def device_memory_stats() -> dict:
    """Per card, the bytes the caching allocator has handed out now and at
    its peak (``torch.cuda.memory_stats``); ``{"cpu": None}`` without a
    card, as the JAX function reports a device without statistics."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        }
    return out
