"""The port's two A/B launchers (``midvision_probe_torch/launch/
{fast_preset_ab,shuffle_ab}.py``) against the repository's
``launch_script/{fast_preset_ab,shuffle_ab}.py``.

* ``ARMS`` equal, and each arm's overrides equal to the JAX script's
  (captured from its ``compose`` calls, both drivers replaced by recorders
  returning the same rows): the training phase's list and, for the
  reduced-size arms, the eval phase's at ``--size`` with ``+is_eval`` and
  the newest checkpoint. The output directory and the port's
  ``+system.device`` are set apart.
* The reports from those same rows: the table row for row, the
  projection's hours and the findings equal, the JAX "v4-8" read as the
  port's ``4 × <card>`` (``--cards 4``), and the JAX findings' fixed
  record of an earlier TPU sweep absent from the port's.
* One reduced-size arm end to end on the CPU in both scripts: ``test_tiny``
  trained at 32² (DPT, 16 hidden channels, three epochs of 64 synthetic
  images in batches of 32, the cache and both bf16 dtypes) and evaluated at
  48² from the newest checkpoint, the arm patched into both scripts'
  ``ARMS`` alike (the real arms train at 160² or more with 256-512 hidden
  channels, minutes on a CPU); the port's backbone and probe init carried
  from the JAX driver's (``convert/from_jax.py``) and its extractor fed the
  JAX bf16 taps of each batch (the bf16 backbones' parity is the other
  tests' subject): the row's sa_d1, si_d1, sa_rmse and si_rmse within
  1e-2, the bound of ``tests/test_torch_bf16_slice.py`` for the bf16
  probe's one-ulp flips (read: 4.0e-3 on sa_rmse, 1.4e-3 on sa_d1, 7e-4
  on the si columns).
* ``shuffle_ab``'s two arms on one seed at a tiny size in both scripts
  (test_tiny at 32², 64 images, three epochs), the weights and probe init
  carried across: the scale-aware sa_d1, sa_rmse and sa_std_pred within
  1e-5 relative (read: 4e-7 at most); the scale-invariant si_d1 and
  si_rmse within 5e-3 (read: 2.1e-3). Six small steps leave this probe's
  predictions nearly constant (std 0.022 about a mean of 4.95, the
  targets' std 0.95), and the per-image scale-and-shift fit of the
  scale-invariant metrics divides by that spread, ~44x the predictions'
  float32 differences.

The step times come from ``time_suite.measure_backbone``, replaced here by
one fixed function in both scripts. The JAX scripts' driver runs, which
they write to fixed ``/tmp`` directories, are moved under each test's
``tmp_path``, so concurrent runs of these tests share no directory. The JAX side runs under
``jax.default_matmul_precision("float32")`` on one device, the port on one
torch thread.
"""

import copy
import glob
import importlib.util
import json
import os
import pathlib
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import midvision_probe_tpu.config as j_config
import train_depth as j_train_depth
from midvision_probe_torch.convert.from_jax import trainer_state_dict, vit_state_dict
from midvision_probe_torch.engine import probe_fit as t_probe_fit
from midvision_probe_torch.launch import fast_preset_ab, shuffle_ab, time_suite
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.datasets import build_loader as j_build_loader
from midvision_probe_tpu.engine import probe_fit as j_probe_fit
from midvision_probe_tpu.engine.driver_common import cache_shuffle_kwargs
from midvision_probe_tpu.models import zoo as j_zoo

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = jax.default_matmul_precision("float32")
BF16_TOL = 1e-2  # tests/test_torch_bf16_slice.py's bound for the bf16 probe's row
SI_TOL = 5e-3  # a scale-and-shift fit to near-constant predictions
EXTRACT_S = 0.062  # the JAX script's fixed extraction time, handed to both


def _jax_script(name):
    """``launch_script/<name>.py`` under a module name of its own; its
    import-time JAX settings are put back after."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
            "jax_platforms")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(f"jax_launch_{name}",
                                                  ROOT / "launch_script" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


J_AB = _jax_script("fast_preset_ab")
J_SHUFFLE = _jax_script("shuffle_ab")


def _step_times(head_type, size, hidden_dim):
    """One fixed (extract, probe step, full step) per arm shape."""
    probe = 1e-3 * (1 + size / 100) * (1 + hidden_dim / 512) * (0.2 if head_type == "linear"
                                                                 else 1.0)
    return EXTRACT_S, probe, probe + EXTRACT_S


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_time_suite(monkeypatch):
    """The JAX script's ``from time_suite import measure_backbone``, served
    the fixed step times."""
    mod = types.ModuleType("time_suite")
    mod.measure_backbone = lambda name, batch, hw, head_type, probe_dtype, hidden_dim: \
        _step_times(head_type, hw[0], hidden_dim)
    monkeypatch.setitem(sys.modules, "time_suite", mod)


def _fake_row(out_dir: str) -> dict:
    """A metrics row that depends only on the run's directory name."""
    h = sum(map(ord, os.path.basename(out_dir))) % 97
    return {"sa_d1": 0.5 + h / 1000, "si_d1": 0.6 + h / 2000,
            "sa_rmse": 1.0 + h / 100, "si_rmse": 0.9 + h / 300}


@pytest.fixture
def recorded(tmp_path, monkeypatch, jax_time_suite):
    """Both scripts over every arm with their drivers replaced by
    recorders: ``{"jax"|"torch": [(overrides, out_dir), ...]}``, reports in
    ``tmp_path``."""
    calls = {"jax": [], "torch": []}
    real_compose = j_config.compose

    def j_compose(name, overrides):
        cfg = real_compose(name, overrides)
        if any(o.startswith("output_dir=") for o in overrides):
            calls["jax"].append(list(overrides))
        return cfg

    def j_run(cfg):
        return _fake_row(cfg.output_dir)

    fake_ckpt = "/fake/exp/ckpt"
    real_glob = glob.glob
    monkeypatch.setattr(glob, "glob", lambda pattern, **kw: [fake_ckpt]
                        if pattern.endswith(os.path.join("*", "ckpt")) else real_glob(pattern, **kw))
    monkeypatch.setattr(j_config, "compose", j_compose)
    monkeypatch.setattr(j_train_depth, "run", j_run)
    assert J_AB.main(["--out", str(tmp_path / "jax" / "ab.md")]) == 0

    def t_run(overrides, out_dir):
        calls["torch"].append(list(overrides) + [f"output_dir={out_dir}"])
        return _fake_row(out_dir)

    monkeypatch.setattr(fast_preset_ab, "run_depth", t_run)
    monkeypatch.setattr(time_suite, "measure_backbone",
                        lambda name, batch, hw, head_type, probe_dtype, hidden_dim, device:
                        _step_times(head_type, hw[0], hidden_dim))
    rows = fast_preset_ab.main(["--out", str(tmp_path / "torch" / "ab.md"),
                                "--device", "cpu", "--work-dir", str(tmp_path / "runs")])
    return {"calls": calls, "rows": rows, "jax_md": tmp_path / "jax" / "ab.md",
            "torch_md": tmp_path / "torch" / "ab.md"}


def test_arms_equal_the_jax_arms():
    assert fast_preset_ab.ARMS == J_AB.ARMS
    assert time_suite.STEPS_PER_EPOCH * 10 == J_AB.STEPS
    assert (fast_preset_ab.TASKS, fast_preset_ab.BACKBONES) == (J_AB.TASKS, J_AB.BACKBONES)


def test_each_arm_runs_the_jax_overrides(recorded):
    def norm(overrides):
        return [o for o in overrides if not o.startswith("+system.device=")]

    j_calls, t_calls = recorded["calls"]["jax"], recorded["calls"]["torch"]
    assert len(j_calls) == len(t_calls) == len(J_AB.ARMS) + sum(
        1 for a in J_AB.ARMS if a[4] is not None)
    for j, t in zip(j_calls, t_calls):
        assert "+system.device=cpu" in t
        j_dir = [o for o in j if o.startswith("output_dir=")]
        t_dir = [o for o in t if o.startswith("output_dir=")]
        # fast_ab_<arm>[_eval480]: under /tmp there, under --work-dir here
        assert [os.path.basename(o) for o in j_dir] == [os.path.basename(o) for o in t_dir]
        assert [o for o in norm(t) if o not in t_dir] == [o for o in j if o not in j_dir], (j, t)


def test_report_table_and_findings_equal_the_jax_report(recorded):
    jl = recorded["jax_md"].read_text().splitlines()
    tl = recorded["torch_md"].read_text().splitlines()
    j_rows = [ln for ln in jl if ln.startswith("| ") and "²" in ln]
    t_rows = [ln for ln in tl if ln.startswith("| ") and "²" in ln]
    assert len(t_rows) == len(J_AB.ARMS) and t_rows == j_rows
    header = next(ln for ln in tl if ln.startswith("| preset"))
    assert header == next(ln for ln in jl if ln.startswith("| preset")).replace(
        "v4-8", "4 × CPU")
    j_find = jl[jl.index("## Findings") + 2:]
    t_find = tl[tl.index("## Findings") + 2:]
    assert j_find[-1].startswith("- Reference record of the full 11-arm sweep")
    assert t_find == [ln.replace("v4-8", "4 × CPU") for ln in j_find[:-1]]
    for row in recorded["rows"]:
        n_ep = fast_preset_ab.N_EPOCHS[next(a[2] for a in J_AB.ARMS if a[0] == row["preset"])]
        assert row["suite_h"] == J_AB.project_suite_hours(row["step_s"], n_ep)


# ------------------------------------------------------------ end to end
JAX_RUN_DIR = re.compile(r"/tmp/((?:fast_ab|shuffle_ab)_.*)")


def _jax_runs_under(monkeypatch, root):
    """The JAX scripts' fixed driver outputs (``/tmp/fast_ab_<arm>``,
    ``/tmp/shuffle_ab_<seed>_<arm>``) moved under ``root``: each run's
    ``output_dir``, and the checkpoint search that follows a run."""
    real_run, real_glob = j_train_depth.run, glob.glob

    def moved(path):
        m = JAX_RUN_DIR.fullmatch(path)
        return str(root / m.group(1)) if m else path

    def run(cfg):
        cfg.output_dir = moved(cfg.output_dir)
        return real_run(cfg)

    monkeypatch.setattr(j_train_depth, "run", run)
    monkeypatch.setattr(glob, "glob", lambda pattern, **kw: real_glob(moved(pattern), **kw))


def _carry_jax_weights(monkeypatch, argv, sizes):
    """Run-time patches of the port: the JAX test_tiny weights, the JAX
    driver's probe init (captured when it runs) and the JAX bf16 taps of
    every batch at ``sizes`` through the port's extractor."""
    jvars = jax.tree_util.tree_map(np.asarray, j_zoo.build_vit_extractor(
        "test_tiny_vit", return_multilayer=True, add_norm=True).variables)
    init_state = {}
    j_init = j_probe_fit.ProbeTrainer.init

    def capture_init(self, batch):
        st = j_init(self, batch)
        init_state.setdefault("params", jax.tree_util.tree_map(np.asarray, st.params))
        init_state.setdefault("stats", jax.tree_util.tree_map(np.asarray, st.batch_stats))
        return st

    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "init", capture_init)
    monkeypatch.setattr(t_zoo, "random_init",
                        lambda module, seed=0: (module.load_state_dict(vit_state_dict(jvars)),
                                                module)[1])
    t_init = t_probe_fit.ProbeTrainer.init

    def load_jax_probe(self):
        t_init(self)
        self.modules.load_state_dict(copy.deepcopy(trainer_state_dict(
            init_state["params"], init_state["stats"])))

    monkeypatch.setattr(t_probe_fit.ProbeTrainer, "init", load_jax_probe)
    if sizes is None:
        return
    jext = j_zoo.build_vit_extractor("test_tiny_vit", return_multilayer=True, add_norm=True,
                                     dtype=jnp.bfloat16)
    jax_apply = jax.jit(jext._apply_fn)
    maps = {}
    for size in sizes:
        jcfg = j_config.compose("depth_training", argv + [f"dataset.image_size=[{size},{size}]"])
        for split in ("trainval", "test"):
            kw = cache_shuffle_kwargs(jcfg) if split == "trainval" else {}
            for batch in j_build_loader(jcfg.dataset, split, 32, seed=8, **kw):
                with F32:
                    taps = jax_apply(jext.variables, batch["image"])[0]
                maps[batch["image"].tobytes()] = [np.asarray(m.astype(jnp.float32))
                                                  for m in taps]
    from midvision_probe_torch import train_depth as t_train_depth

    t_build = t_train_depth.build_backbone

    def jax_features(cfg, needs_multilayer):
        ext = t_build(cfg, needs_multilayer)
        ext._apply_fn = lambda images: (
            [torch.from_numpy(m).bfloat16() for m in maps[images.float().numpy().tobytes()]],
            [None] * 4)
        return ext

    monkeypatch.setattr(t_train_depth, "build_backbone", jax_features)


def test_a_reduced_size_arm_end_to_end_matches_the_jax_script(
        tmp_path, monkeypatch, jax_time_suite, one_torch_thread):
    name = "dpt-32-hd16"
    arm = (name, "depth_dpt", "three_epoch", "dpt", 32, 16)
    monkeypatch.setattr(J_AB, "ARMS", [arm])
    monkeypatch.setattr(fast_preset_ab, "ARMS", [arm])
    monkeypatch.setattr(time_suite, "measure_backbone",
                        lambda name, batch, hw, head_type, probe_dtype, hidden_dim, device:
                        _step_times(head_type, hw[0], hidden_dim))
    argv = ["backbone=test_tiny", "dataset=synthetic", "dataset.num_instances=64",
            "+backbone.return_multilayer=True", "system.cache_features=true"]
    args = ["--backbone", "test_tiny", "--instances", "64", "--size", "48", "--arms", name]
    _carry_jax_weights(monkeypatch, argv, sizes=(32, 48))
    _jax_runs_under(monkeypatch, tmp_path / "jax_runs")
    with F32:
        assert J_AB.main(args + ["--out", str(tmp_path / "jax" / "ab.md")]) == 0
    assert (tmp_path / "jax_runs" / f"fast_ab_{name}_eval48").is_dir()
    rows = fast_preset_ab.main(args + ["--out", str(tmp_path / "torch" / "ab.md"),
                                       "--device", "cpu", "--work-dir", str(tmp_path)])
    (j_row,) = [json.loads(ln) for ln in
                (tmp_path / "jax" / "fast_preset_ab_rows_r5.jsonl").read_text().splitlines()]
    (row,) = rows
    assert row["eval_dir"] == str(tmp_path / f"fast_ab_{name}_eval48")
    assert (pathlib.Path(row["eval_dir"]) / "depth_results_synthetic_final.csv").exists()
    assert row["train_size"] == j_row["train_size"] == 32
    for k in ("sa_d1", "si_d1", "sa_rmse", "si_rmse"):
        np.testing.assert_allclose(row["metrics"][k], j_row["metrics"][k], rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=k)


def test_shuffle_ab_rows_match_the_jax_script(tmp_path, monkeypatch, one_torch_thread):
    argv = ["--instances", "64", "--size", "32", "--epochs", "three_epoch", "--seeds", "0"]
    _carry_jax_weights(monkeypatch, [], sizes=None)
    _jax_runs_under(monkeypatch, tmp_path / "jax_runs")
    rows_j = {}
    real_run = j_train_depth.run

    def j_run(cfg):
        row = real_run(cfg)
        rows_j.setdefault("cache" if cfg.system.cache_features else "full", row)
        return row

    monkeypatch.setattr(j_train_depth, "run", j_run)
    with F32:
        J_SHUFFLE.main(argv + ["--out", str(tmp_path / "jax.md")])
    assert sorted(os.listdir(tmp_path / "jax_runs")) == ["shuffle_ab_0_cache",
                                                        "shuffle_ab_0_full-shuffle"]
    rows = shuffle_ab.main(argv + ["--out", str(tmp_path / "torch.md"), "--device", "cpu",
                                   "--work-dir", str(tmp_path)])
    assert (tmp_path / "torch.md").read_text().startswith("# Cache-shuffle A/B")
    for arm, key in (("cache+order-shuffle", "cache"), ("full-shuffle", "full")):
        (row,) = rows[arm]
        for k in ("sa_d1", "sa_rmse", "sa_std_pred"):
            np.testing.assert_allclose(row[k], rows_j[key][k], rtol=1e-5, err_msg=f"{arm} {k}")
        for k in ("si_d1", "si_rmse"):
            np.testing.assert_allclose(row[k], rows_j[key][k], rtol=0, atol=SI_TOL,
                                       err_msg=f"{arm} {k}")
