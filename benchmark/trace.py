"""The traced run's profiler and the reduction of its events.

``Tracer`` drives ``torch.profiler``'s Kineto backend (CPU and CUDA
activities) through its low-level calls, so that the events stay in
memory as they come and are read once, without building the profiler's
own event tree. ``collect`` keeps, inside the benchmark's window span:

* the device's intervals (kernels, copies, memsets), each with the host
  time at which it was launched (matched through the CUDA runtime call's
  correlation id);
* the benchmark's own spans (names starting with ``bench.``);
* the host's operator intervals, to say what the host was doing while the
  device idled.

The per-layer metrics (``metrics/*.py``) read a ``TraceData``; the
breakdown of the result line comes from it too.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict

import torch
from torch.autograd.profiler import record_function

WINDOW_SPAN = "bench.window"
SPAN_PREFIX = "bench."
NAME_CHARS = 120  # a device operation's name in the breakdown is cut to this
MIN_GAP_NS = 2_000  # idle gaps shorter than this are counted but not named
BREAKDOWN_ENTRIES = 10


class Tracer:
    """Kineto over CPU and, on a card, CUDA activity."""

    def __init__(self, device: torch.device):
        from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
        from torch.autograd import ProfilerConfig, ProfilerState
        self._activities = {ProfilerActivity.CPU}
        if device.type == "cuda":
            self._activities.add(ProfilerActivity.CUDA)
        self._config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                      _ExperimentalConfig())
        self.result = None

    def prepare(self) -> None:
        from torch.autograd import _prepare_profiler
        _prepare_profiler(self._config, self._activities)

    def start(self) -> None:
        from torch.autograd import _enable_profiler
        _enable_profiler(self._config, self._activities)

    def stop(self) -> None:
        from torch.autograd import _disable_profiler
        self.result = _disable_profiler()

    @staticmethod
    def span(name: str):
        return record_function(name)


@dataclasses.dataclass
class TraceData:
    window: tuple[int, int]  # ns, the window span on the profiler's clock
    # (start, end, name, kind, launch start or None); kind: kernel, copy, memset
    device: list[tuple[int, int, str, str, int | None]]
    spans: dict[str, list[tuple[int, int]]]
    host: list[tuple[int, int, str]]  # host operators, sorted by start

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def busy_ns(self) -> int:
        return sum(e - s for s, e in merged(self.device))

    def device_ns(self, pattern: re.Pattern | None = None, exclude: re.Pattern | None = None,
                  kinds=("kernel",), launched_in: str | None = None,
                  launched_outside: str | None = None) -> int:
        """Device time of the events of ``kinds`` whose name matches
        ``pattern`` and not ``exclude``, optionally only those launched
        inside (or outside) the spans named ``launched_in``
        (``launched_outside``)."""
        inside = _Intervals(self.spans.get(launched_in or launched_outside or "", []))
        total = 0
        for s, e, name, kind, launch in self.device:
            if kind not in kinds:
                continue
            if pattern is not None and not pattern.search(name):
                continue
            if exclude is not None and exclude.search(name):
                continue
            if launched_in is not None and not (launch is not None and inside.covers(launch)):
                continue
            if launched_outside is not None and launch is not None and inside.covers(launch):
                continue
            total += e - s
        return total

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps by what the host was doing, in seconds."""
        ops: dict[str, int] = defaultdict(int)
        for s, e, name, _, _ in self.device:
            ops[name[:NAME_CHARS]] += e - s
        gaps: dict[str, int] = defaultdict(int)
        host = _HostIndex(self.host)
        prev = self.window[0]
        for s, e in merged(self.device) + [(self.window[1], self.window[1])]:
            if s - prev >= MIN_GAP_NS:
                gaps[host.at((prev + s) // 2)] += s - prev
            prev = max(prev, e)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        return {"device_ops": [[n, t / 1e9] for n, t in top],
                "idle_gaps": [[n, t / 1e9] for n, t in idle]}


def merged(device) -> list[tuple[int, int]]:
    """The union of the events' intervals, sorted."""
    out: list[list[int]] = []
    for s, e, *_ in sorted(device):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class _Intervals:
    def __init__(self, intervals):
        self._iv = sorted(intervals)
        self._starts = [s for s, _ in self._iv]

    def covers(self, t: int) -> bool:
        i = bisect.bisect_right(self._starts, t) - 1
        return i >= 0 and self._iv[i][1] >= t


class _HostIndex:
    """The innermost host operator running at a time."""

    LOOKBACK = 256

    def __init__(self, host):
        self._host = host
        self._starts = [s for s, _, _ in host]

    def at(self, t: int) -> str:
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(i - self.LOOKBACK, -1), -1):
            s, e, name = self._host[j]
            if e >= t:
                return f"host: {name}"
        return "host: outside any operator"


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _is_device(event) -> bool:
    return str(event.device_type()).rsplit(".", 1)[-1] != "CPU"


def collect(result) -> TraceData:
    """Reduce the profiler's events to what lies inside the window span."""
    device, host, launches = [], [], {}
    spans: dict[str, list[tuple[int, int]]] = defaultdict(list)
    for ev in result.events():
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if _is_device(ev):
            if name.startswith(SPAN_PREFIX):  # a span's shadow on the device's timeline
                continue
            device.append((start, end, name, _kind(name), ev.correlation_id()))
        elif name.startswith(SPAN_PREFIX):
            spans[name].append((start, end))
        elif name.startswith("cu"):  # a CUDA runtime or driver call
            launches[ev.correlation_id()] = start
        else:
            host.append((start, end, name))
    if not spans.get(WINDOW_SPAN):
        raise RuntimeError("the trace holds no window span")
    ws, we = spans[WINDOW_SPAN][0]
    inside = []
    for s, e, name, kind, corr in device:
        s, e = max(s, ws), min(e, we)
        if s < e:
            inside.append((s, e, name, kind, launches.get(corr)))
    host.sort()
    return TraceData(window=(ws, we), device=inside, spans=dict(spans),
                     host=[h for h in host if h[1] >= ws and h[0] <= we])
