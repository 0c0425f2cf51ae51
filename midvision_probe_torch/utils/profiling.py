"""Profiling and timing (counterpart of the JAX package's
``utils/profiling.py``): a ``torch.profiler`` trace written as a Chrome
trace, a step timer that waits for the card, and the card's memory use."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch


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
