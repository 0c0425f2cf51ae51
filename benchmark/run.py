"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

Usage, from the root of a checkout::

    python3 -m benchmark.run --workload dino_b16.train_dpt --seed 12345 \\
        --seconds 40 --trace 0

The run makes its weights and inputs from ``--seed``, builds the program's
objects and warms every shape of the cell (the set-up, ``setup_s``), then
drives the cell's loop for ``--seconds`` (the window). With ``--trace 1``
the window runs under the profiler and the line carries the cell's
per-layer metrics, the device's busy time and a breakdown; with
``--trace 0`` its end-to-end metrics. After the window the program's state
is freed and what the window produced is compared with the plain
reference (``check.py``): ``correct``, and each number beside its limit,
on standard error and under ``checks``, the last key of the line.

It exits 2 without a result when no card is there (or fewer than the cell
asks for), and 3 when JAX or the JAX package was loaded into the process.
Kernel caches stay in the checkout: the port's nvcc builds in
``build/torch_kernels`` (``ops/cuda_build.py``), Triton's in
``build/triton_cache``.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import manifest  # noqa: E402

CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton_cache",
              "TORCH_EXTENSIONS_DIR": "build/torch_extensions"}
FORBIDDEN = ("jax", "jaxlib", "flax", "midvision_probe_tpu")
GIB = 2**30


def set_environment() -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX."""
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(manifest.ROOT / rel)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules=None) -> list[str]:
    """The loaded top-level modules that are JAX or the JAX package, compared
    by the whole name before the first dot."""
    names = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


class Context:
    """What a per-layer metric's ``read`` gets: the cell's configuration and
    mix, the window's counts and the trace."""

    def __init__(self, cfg: dict, mix: dict, stats: dict, trace, device_kind: str, loop):
        self.cfg, self.mix, self.trace, self.loop = cfg, mix, trace, loop
        self.steps, self.images = stats["steps"], stats["images"]
        self.window_s = stats["window_s"]
        self.device_kind = device_kind

    def peak(self, name: str) -> float | None:
        from benchmark import peaks
        return peaks.peak(self.device_kind, name)

    def flops_per_image(self) -> float:
        return self.loop.flops_per_image(self.cfg, self.mix)


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def percentile(values: list[float], q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values), q))


def execute(cell_name: str, cfg: dict, mix: dict, limits: dict, metric_entries: list[dict],
            seed: int, seconds: float, trace: bool, device, start: float,
            here=manifest.HERE) -> dict:
    """One run of a cell on ``device`` (its loop and metric readers found
    under ``here``); returns the result line's object."""
    import torch

    from benchmark import check, program
    from benchmark import trace as tracing

    imported = time.time() - start
    loop = manifest.loop(mix["loop"], here)
    session = loop.Session(cfg, mix, seed, device)
    print("setup phases", json.dumps({"imports": round(imported, 4), **session.phases.seconds}),
          file=sys.stderr, flush=True)
    tracer = None
    if trace:
        tracer = tracing.Tracer(device)
        tracer.prepare()
    setup_s = time.time() - start
    if tracer:
        tracer.start()
    stats = session.window(seconds, tracer)
    if tracer:
        tracer.stop()
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    print("k1_route_launches", json.dumps(program.attention_launches()), flush=True)

    out: dict = {"metrics": {}, "device": {"platform": "gpu" if cuda else "cpu",
                                           "kind": kind, "count": 1,
                                           "memory_peak_bytes": peak}}
    if trace:
        data = tracing.collect(tracer.result)
        tracer.result = None
        ctx = Context(cfg, mix, stats, data, kind, loop)
        for entry in metric_entries:
            value = manifest.reader(entry["name"], here).read(ctx)
            if value is None:
                print(f"metric {entry['name']}: nothing to read", file=sys.stderr)
                continue
            out["metrics"][entry["name"]] = {"value": value, "unit": entry["unit"]}
        out["device"]["busy_s"] = data.busy_ns() / 1e9
        out["device"]["window_s"] = data.window_ns / 1e9
        out["breakdown"] = data.breakdown()
    else:
        values = {"images_per_s": stats["images"] / stats["window_s"],
                  "step_ms_p95": percentile(stats["step_ms"], 95),
                  "peak_mem_gib": peak / GIB,
                  "setup_s": setup_s}
        for entry in metric_entries:
            out["metrics"][entry["name"]] = {"value": values[entry["name"]],
                                             "unit": entry["unit"]}

    session.release()
    readings = session.check()
    print("readings", json.dumps({k: _number(v) for k, v in readings.items()}),
          file=sys.stderr)
    correct, failed, table = check.verdict(readings, limits)
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    result = {"correct": correct, "attempted": stats["steps"], "failed": failed,
              "metrics": out["metrics"], "device": out["device"]}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                        for k, v in table.items()}
    return result


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    import torch

    m = manifest.load()
    cell = manifest.cell(m, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(device)
    result = execute(args.workload, manifest.config(m, cell["config"]),
                     manifest.mix(cell["traffic"]), manifest.limits(args.workload),
                     manifest.metrics(m, args.workload, bool(args.trace)), args.seed,
                     args.seconds, bool(args.trace), device, PROCESS_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
