"""The port's launchers (``midvision_probe_torch/launch/``) against the JAX
package's (``launch_script/``): ``task_plan`` task for task (the same keys
and overrides, only the driver's module path differs), the miniature SPair
tree byte for byte, ``sweep --dry-run`` on the four cases of
``tests/test_sweep_cli.py``, the report, resume, pending-cell and
two-phase-cell logic with ``subprocess`` monkeypatched as there, the
refusal to run without a card unless ``--device cpu`` (once, before any
cell) and the bounded card probe. No driver runs here
(``test_torch_suite_e2e.py`` runs them)."""

import filecmp
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from midvision_probe_torch.launch import suite_run, sweep

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_launcher(name):
    """The repository's ``launch_script/<name>.py`` under a module name of
    its own (it imports ``sweep`` from its directory)."""
    sys.path.insert(0, str(ROOT / "launch_script"))
    spec = importlib.util.spec_from_file_location(f"jax_launch_{name}",
                                                  ROOT / "launch_script" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_SUITE = _jax_launcher("suite_run")
J_SWEEP = _jax_launcher("sweep")


# ------------------------------------------------------------------ plans
def test_task_plan_equals_the_jax_plan_task_for_task():
    t_plan, j_plan = suite_run.task_plan("/x/spair"), J_SUITE.task_plan("/x/spair")
    assert list(t_plan) == list(j_plan)
    assert suite_run.EXTRA_TASKS == J_SUITE.EXTRA_TASKS
    for task, j_entry in j_plan.items():
        t_entry = t_plan[task]
        assert t_entry[1:] == j_entry[1:], task  # overrides and the eval size
        j_module = j_entry[0].removesuffix(".py")
        assert t_entry[0] == f"midvision_probe_torch.{j_module}", task
        assert importlib.util.find_spec(t_entry[0]) is not None, task


def test_sweep_lists_equal_the_jax_lists():
    assert sweep.DEFAULT_MODELS == J_SWEEP.DEFAULT_MODELS
    assert {t: f"midvision_probe_torch.{d.removesuffix('.py')}"
            for t, d in J_SWEEP.DRIVERS.items()} == sweep.DRIVERS
    env = sweep.subprocess_env()
    assert env["MVP_SYNTH_DISK_CACHE"]
    assert not any(k.startswith("JAX_") and k not in os.environ for k in env)


def test_mini_spair_tree_equals_the_jax_tree(tmp_path):
    t_root = suite_run.make_mini_spair(str(tmp_path / "torch"))
    j_root = J_SUITE.make_mini_spair(str(tmp_path / "jax"))
    t_files = sorted(p.relative_to(t_root) for p in pathlib.Path(t_root).rglob("*")
                     if p.is_file())
    j_files = sorted(p.relative_to(j_root) for p in pathlib.Path(j_root).rglob("*")
                     if p.is_file())
    assert t_files == j_files and len(t_files) == 3 * (5 * 3 + 4)
    for rel in t_files:
        assert filecmp.cmp(pathlib.Path(t_root) / rel, pathlib.Path(j_root) / rel,
                           shallow=False), rel


# -------------------------------------------------------- sweep --dry-run
def _dry_run(args):
    out = subprocess.run(
        [sys.executable, "-m", "midvision_probe_torch.launch.sweep", "--dry-run"] + args,
        capture_output=True, text=True, check=True, cwd=ROOT)
    return out.stdout


@pytest.mark.parametrize("case", ["fast_defaults", "no_fast", "eval_task", "parallel"])
def test_sweep_dry_run(case, tmp_path):
    log_dir = ["--log-dir", str(tmp_path)]
    if case == "fast_defaults":
        out = _dry_run(["--task", "depth", "--models", "dino_b16"] + log_dir)
        for o in ("system.cache_features=true", "system.backbone_dtype=bfloat16",
                  "system.probe_dtype=bfloat16", "+backbone.return_multilayer=True",
                  "-m midvision_probe_torch.train_depth", "+system.device=cuda"):
            assert o in out
    elif case == "no_fast":
        out = _dry_run(["--task", "depth", "--models", "dino_b16", "--no-fast"] + log_dir)
        assert "cache_features" not in out and "probe_dtype" not in out
    elif case == "eval_task":
        out = _dry_run(["--task", "spair", "--models", "dino_b16", "--device", "cpu"]
                       + log_dir)
        assert "cache_features" not in out and "return_multilayer" not in out
        assert "midvision_probe_torch.evaluate_spair_correspondence" in out
        assert "+system.device=cpu" in out
    else:
        out = _dry_run(["--task", "depth", "--models", "a", "b", "--parallel", "2"]
                       + log_dir)
        assert out.count("[sweep]") >= 2


# ------------------------------------------------------------ no card here
def test_sweep_raises_once_before_any_cell_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(sweep.subprocess, "call", lambda cmd, **kw: calls.append(cmd) or 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.main(["--task", "depth", "--log-dir", str(tmp_path)])
    assert calls == [] and list(tmp_path.iterdir()) == []
    # with --device cpu every cell runs, on the CPU, and nothing is built
    from midvision_probe_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "build_all", lambda *a: pytest.fail("built kernels"))
    assert sweep.main(["--task", "navi", "--models", "a", "b", "--device", "cpu",
                       "--log-dir", str(tmp_path)]) == 0
    assert len(calls) == 2 and all(c[-1] == "+system.device=cpu" for c in calls)


def test_suite_raises_once_before_any_cell_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(suite_run.subprocess, "call", lambda cmd, **kw: calls.append(cmd) or 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        suite_run.main(["--log-dir", str(tmp_path / "logs"), "--out", str(tmp_path / "r.md"),
                        "--suite-out", str(tmp_path / "out")])
    assert calls == []
    assert not os.path.exists(tmp_path / "logs" / "suite_rows.json")


def test_the_card_probe_is_bounded_and_not_swallowed(monkeypatch, tmp_path):
    """On a CUDA device the suite probes the card in a bounded process
    before the first cell and raises when it does not answer; a failed
    cell is followed by a probe, and the suite stops if the card is gone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(suite_run, "build_kernels", lambda device: 0.0)
    answers = []

    def fake_run(cmd, **kw):
        assert kw["timeout"] > 0 and "torch.cuda.is_available()" in cmd[-1]
        answers.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "AssertionError: CUDA is not available")

    monkeypatch.setattr(suite_run.subprocess, "run", fake_run)
    monkeypatch.setattr(suite_run, "card_name", lambda device: "a card")
    calls = []
    monkeypatch.setattr(suite_run.subprocess, "call", lambda cmd, **kw: calls.append(cmd) or 0)
    argv = ["--models", "m_b16", "--tasks", "navi", "spair",
            "--log-dir", str(tmp_path / "logs"), "--out", str(tmp_path / "r.md"),
            "--suite-out", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="the card does not answer"):
        suite_run.main(argv)
    assert len(answers) == 1 and calls == []

    # the card answers first, then a cell fails and the card is gone
    state = iter([0, 1])
    monkeypatch.setattr(suite_run.subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
        cmd, next(state), "", "lost"))
    monkeypatch.setattr(suite_run.subprocess, "call", lambda cmd, **kw: calls.append(cmd) or 3)
    assert suite_run.main(argv) == 1
    assert len(calls) == 1  # the second cell never ran
    with open(tmp_path / "logs" / "suite_rows.json") as f:
        assert [(r["task"], r["rc"]) for r in json.load(f)] == [("navi", 3)]

    # --device cpu: no probe at all
    monkeypatch.setattr(suite_run.subprocess, "run",
                        lambda *a, **k: pytest.fail("probed the card for --device cpu"))
    monkeypatch.setattr(suite_run.subprocess, "call", lambda cmd, **kw: calls.append(cmd) or 0)
    assert suite_run.main(argv + ["--device", "cpu", "--no-resume"]) == 0


# ------------------------------------------------------------------ report
def test_report_and_resume(tmp_path):
    rows = [
        {"task": "depth", "model": "a_b16", "rc": 0, "wall_s": 100.0},
        {"task": "snorm", "model": "a_b16", "rc": 1, "wall_s": 4.0},
        {"task": "depth", "model": "b_r50", "rc": 0, "wall_s": 50.0},
    ]
    out_md = tmp_path / "report.md"
    suite_run.write_report(rows, str(out_md), str(tmp_path),
                           card="NVIDIA H100 80GB HBM3, 700.00 W")
    text = out_md.read_text()
    assert "| a_b16 | 100 | **F**(4) |" in text
    assert "| b_r50 | 50 | — |" in text
    assert "3 runs, 1 failures" in text
    assert "on NVIDIA H100 80GB HBM3, 700.00 W" in text and "TPU" not in text
    assert "| depth | 2 | 100 | 50..100 | 0.04 |" in text  # median, range, total
    assert "fresh" not in text  # no compile-cache attribution: nothing to cache

    done = {(r["task"], r["model"]) for r in rows if r["rc"] == 0}
    todo = [(t, m) for m in ["a_b16", "b_r50"] for t in ["depth", "snorm"]
            if (t, m) not in done]
    assert todo == [("snorm", "a_b16"), ("snorm", "b_r50")]


def test_resume_reruns_only_failed_cells(monkeypatch, tmp_path):
    logs = tmp_path / "logs"
    logs.mkdir()
    with open(logs / "suite_rows.json", "w") as f:
        json.dump([{"task": "navi", "model": "a_b16", "rc": 0, "wall_s": 5.0, "ts": 1.0},
                   {"task": "navi", "model": "b_r50", "rc": 2, "wall_s": 5.0, "ts": 2.0}], f)
    calls = []
    monkeypatch.setattr(suite_run.subprocess, "call", lambda cmd, **kw: calls.append(cmd) or 0)
    argv = ["--models", "a_b16", "b_r50", "--tasks", "navi", "--device", "cpu",
            "--log-dir", str(logs), "--out", str(tmp_path / "r.md"),
            "--suite-out", str(tmp_path / "out")]
    assert suite_run.main(argv) == 0
    assert [c[c.index("-m") + 1:c.index("-m") + 3] for c in calls] == [
        ["midvision_probe_torch.evaluate_navi_correspondence", "backbone=b_r50"]]
    with open(logs / "suite_rows.json") as f:
        rows = json.load(f)
    assert {(r["model"], r["rc"]) for r in rows} == {("a_b16", 0), ("b_r50", 0)}
    assert all("ts" in r for r in rows)


def test_report_lists_pending_cells(tmp_path):
    rows = [{"task": "depth", "model": "a_b16", "rc": 0, "wall_s": 1.0}]
    out_md = tmp_path / "report.md"
    suite_run.write_report(rows, str(out_md), str(tmp_path),
                           expected_models=["a_b16", "b_r50"])
    text = out_md.read_text()
    assert "Remaining cells: 11 of 12" in text
    assert "- a_b16: snorm, navi, scannet, spair, percepture" in text
    assert "- b_r50: depth, snorm, navi, scannet, spair, percepture" in text

    full = [{"task": t, "model": "a_b16", "rc": 0, "wall_s": 1.0}
            for t in ("depth", "snorm", "navi", "scannet", "spair", "percepture")]
    suite_run.write_report(full, str(out_md), str(tmp_path), expected_models=["a_b16"])
    text = out_md.read_text()
    assert "Remaining cells: 0 of 6" in text and "complete" in text


def test_two_phase_preset_cell(tmp_path, monkeypatch):
    """The dpt-192-hd256 cells run two drivers: train at 192 into a
    per-model dir, then the driver's eval-only reload (+is_eval +ckpt_path)
    at 480 into the shared task dir; no checkpoint fails the cell."""
    out_root = tmp_path / "out"
    monkeypatch.setattr(suite_run, "SUITE_OUT", str(out_root))
    calls = []

    def fake_call(cmd, **kw):
        calls.append(cmd)
        if len(calls) == 1:  # the port's checkpoint layout: <exp>/ckpt/epoch_N.pt
            ckpt = out_root / "depth_dpt192" / "train_m_b16" / "exp" / "ckpt"
            ckpt.mkdir(parents=True)
            (ckpt / "epoch_1.pt").write_bytes(b"")
        return 0

    monkeypatch.setattr(suite_run.subprocess, "call", fake_call)
    row = suite_run.run_one(
        "depth_dpt192", "midvision_probe_torch.train_depth", "m_b16",
        ["dataset.image_size=[192,192]", "probe=depth_dpt192_hd256"],
        str(tmp_path / "logs"), eval_size=480, device="cpu")
    assert row["rc"] == 0 and len(calls) == 2
    assert any("train_m_b16" in a for a in calls[0])
    assert "dataset.image_size=[192,192]" in calls[0]
    ph2 = calls[1]
    assert "dataset.image_size=[480,480]" in ph2 and "+is_eval=True" in ph2
    assert any(a.startswith("+ckpt_path=") and a.endswith("ckpt") for a in ph2)
    assert f"output_dir={out_root / 'depth_dpt192'}" in ph2
    assert all(c[-1] == "+system.device=cpu" for c in calls)

    calls.clear()
    monkeypatch.setattr(suite_run.subprocess, "call",
                        lambda cmd, **kw: calls.append(cmd) or 0)
    row = suite_run.run_one(
        "snorm_dpt192", "midvision_probe_torch.train_snorm", "m_b16",
        ["dataset.image_size=[192,192]"], str(tmp_path / "logs"), eval_size=480,
        device="cpu")
    assert row["rc"] == 1 and len(calls) == 1


def test_archive_csvs(tmp_path, monkeypatch):
    out_root = tmp_path / "out"
    (out_root / "navi").mkdir(parents=True)
    (out_root / "navi" / "results.csv").write_text("a,b\n1,2\n")
    monkeypatch.setattr(suite_run, "SUITE_OUT", str(out_root))
    suite_run.archive_csvs(str(tmp_path / "logs"))
    suite_run.archive_csvs(str(tmp_path / "logs"))  # idempotent
    assert os.listdir(tmp_path / "logs" / "csv") == ["navi_results.csv"]
