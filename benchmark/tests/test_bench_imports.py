"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference imports nothing of the
program."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark import manifest, run

REFERENCE_ALLOWED = {"__future__", "math", "torch"}
NEVER = {"jax", "jaxlib", "flax", "midvision_probe_tpu"}

TINY_RUN = """
import json, time, torch
from benchmark import run
from benchmark.tests import tiny
cfg, mix = tiny.config(), tiny.mix("train_dpt")
limits = {k: {"limit": 1.0} for k in ("tap_err", "pred_err", "loss_gap", "grad_gap",
                                       "delta_gap")}
entries = [{"name": n, "unit": "x"} for n in ("images_per_s", "step_ms_p95",
                                               "peak_mem_gib", "setup_s")]
result = run.execute("tiny", cfg, mix, limits, entries, 2**31 + 9, 0.3, False,
                     torch.device("cpu"), time.time())
print(json.dumps({"correct": result["correct"], "found": run.forbidden_modules()}))
"""


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", TINY_RUN], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    assert '"found": []' in line and '"correct": true' in line


def test_names_are_compared_whole():
    assert run.forbidden_modules(["midvision_probe_torch", "midvision_probe_torch.models",
                                  "jaxtyping", "flax_like"]) == []
    assert run.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert run.forbidden_modules(["midvision_probe_tpu.ops"]) == ["midvision_probe_tpu"]


def test_the_reference_imports_torch_alone():
    for path in sorted((manifest.HERE / "reference").glob("*.py")):
        assert _imports(path) <= REFERENCE_ALLOWED | {"benchmark"}, path.name


def test_no_file_of_the_benchmark_imports_jax():
    for path in sorted(manifest.HERE.rglob("*.py")):
        assert not _imports(path) & NEVER, path.name


def test_only_program_py_imports_the_program():
    """The harness loads the port through ``program.py`` alone (tests may
    import it to compare)."""
    for path in sorted(manifest.HERE.rglob("*.py")):
        if path.name != "program.py" and "tests" not in path.relative_to(manifest.HERE).parts:
            assert "midvision_probe_torch" not in _imports(path), path.name
