"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``, by the manifest's ``file``), its
traffic mix (``traffic/<mix>.json``), the loop that the mix names
(``loops/<loop>.py``, with ``Session`` and ``flops_per_image``), its
comparison limits (``limits/<cell>.json``) and the readers of its
per-layer metrics (``metrics/<metric>.py``, each with ``read(ctx)``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(manifest: dict, name: str) -> dict:
    return _named(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    return json.loads((root / _named(manifest["configs"], name, "config")["file"]).read_text())


def mix(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str, here: Path = HERE) -> dict:
    return json.loads((here / "limits" / f"{cell_name}.json").read_text())


def reports(metric: dict, cell_name: str) -> bool:
    """Whether ``cell_name`` reports ``metric`` (all cells without a
    ``workloads`` key)."""
    return cell_name in metric.get("workloads", [cell_name])


def metrics(manifest: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key] if reports(m, cell_name)]


def _module(kind: str, name: str, here: Path):
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {path.relative_to(here.parent)}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric_name: str, here: Path = HERE):
    """The module ``metrics/<name>.py``; its ``read(ctx)`` returns the value,
    or None when it finds nothing to read."""
    return _module("metrics", metric_name, here)


def loop(loop_name: str, here: Path = HERE):
    """The module ``loops/<name>.py``: its ``Session(cfg, mix, seed, device)``
    and ``flops_per_image(cfg, mix)``."""
    return _module("loops", loop_name, here)
