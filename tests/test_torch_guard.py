"""Guards of the PyTorch port: it never imports JAX, the JAX package,
pandas, sklearn or matplotlib (the GPU host's packages need not include
them), it names the JAX
package only in its config-target mapping, it never names the prebuilt
DenseCRF library committed in ``native/densecrf/`` (it builds its own from
the sources), and its entry points refuse to run on the CPU unless asked
to."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "midvision_probe_torch"
JAX_PKG = "midvision_probe_" + "tpu"  # spelled apart: this file is not scanned


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        f" or m.split('.')[0] in ('flax', 'optax', 'orbax', 'pandas', 'sklearn', 'matplotlib',"
        f" {JAX_PKG!r}))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_names_the_jax_package_only_in_the_target_mapping():
    hits = []
    for path in sorted(PORT.rglob("*")) + [ROOT / "chip_smoke.py"]:
        if not path.is_file() or path.suffix not in (".py", ".cu", ".cuh", ".md"):
            continue
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if JAX_PKG in line:
                hits.append((str(path.relative_to(ROOT)), n, line.strip()))
    assert hits == [("midvision_probe_torch/config/core.py", hits[0][1],
                     f'_JAX_TARGET_PREFIX = "{JAX_PKG}."')], hits


def test_port_never_names_the_prebuilt_densecrf_library():
    prebuilt = "libdensecrf" + ".so"  # spelled apart: this file is not scanned
    hits = []
    for path in sorted(PORT.rglob("*")) + [ROOT / "chip_smoke.py"]:
        if path.is_file() and path.suffix in (".py", ".cu", ".cuh", ".md"):
            hits += [(str(path.relative_to(ROOT)), n) for n, line in
                     enumerate(path.read_text().splitlines(), 1) if prebuilt in line]
    assert hits == []


def test_entry_points_raise_without_a_device_on_a_cpu_only_host(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from midvision_probe_torch import train_depth
    from midvision_probe_torch.models.zoo import build_resnet_extractor, build_vit_extractor
    from midvision_probe_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_vit_extractor("test_tiny_vit")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_resnet_extractor("simclr_resnet50")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_depth.entry(["backbone=test_tiny", "dataset=synthetic",
                           "probe=depth_linear", "+render_images=False",
                           f"output_dir={tmp_path}"])
    assert not list(tmp_path.iterdir())  # nothing ran on the CPU


@pytest.mark.parametrize("driver,argv", [
    ("evaluate_navi_correspondence", ["dataset=synthetic_navi"]),
    ("render_scannet_correspondence", ["dataset=synthetic_scannet", "+render_every=0"]),
    ("render_scannet_correspondence", ["dataset=synthetic_scannet"]),
    ("render_navi_correspondence", ["dataset=synthetic_navi"]),
])
def test_correspondence_drivers_raise_without_a_device_on_a_cpu_only_host(
        monkeypatch, tmp_path, driver, argv):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"midvision_probe_torch.{driver}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.entry(["backbone=test_tiny", "num_corr=10", *argv,
                      f"output_dir={tmp_path}"])
    assert not list(tmp_path.iterdir())  # nothing ran on the CPU


@pytest.mark.parametrize("driver,argv", [
    ("train_generic_objectness", ["dataset=synthetic_voc", "probe=binaryhead",
                                  "optimizer=one_epoch"]),
    ("evaluate_model_percepture", ["dataset=synthetic_twoafc"]),
    ("evaluate_generic_objectness", ["dataset=synthetic_voc", "max_images=1"]),
])
def test_objectness_and_2afc_drivers_raise_without_a_device_on_a_cpu_only_host(
        monkeypatch, tmp_path, driver, argv):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"midvision_probe_torch.{driver}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.entry(["backbone=test_tiny", *argv, f"output_dir={tmp_path}"])
    assert not list(tmp_path.iterdir())  # nothing ran on the CPU


@pytest.mark.parametrize("driver,argv", [
    ("train_taskonomy", ["dataset=taskonomy", "probe=taskonomy_dpt", "optimizer=one_epoch"]),
    ("evaluate_spair_correspondence", ["data_root=absent", "image_size=64"]),
])
def test_taskonomy_and_spair_drivers_raise_without_a_device_on_a_cpu_only_host(
        monkeypatch, tmp_path, driver, argv):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"midvision_probe_torch.{driver}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.entry(["backbone=test_tiny", *argv, f"output_dir={tmp_path}"])
    assert not list(tmp_path.iterdir())  # nothing ran on the CPU


def test_attention_bench_raises_without_a_device_on_a_cpu_only_host(monkeypatch, capsys):
    from midvision_probe_torch import bench_attn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_attn.main(["--batch", "1", "--n-valid", "10", "--heads", "1",
                         "--variants", "base"])
    assert capsys.readouterr().out == ""  # nothing ran on the CPU


NEW_MODULES = ["midvision_probe_torch.parallel", "midvision_probe_torch.parallel.mesh",
               "midvision_probe_torch.parallel.multihost",
               "midvision_probe_torch.parallel.pipeline",
               "midvision_probe_torch.utils.profiling", "midvision_probe_torch.compat"]


def test_parallel_profiling_and_compat_import_neither_jax_nor_the_jax_package():
    """The multi-process, profiling and ``evals.*`` modules, each imported
    alone in a fresh interpreter."""
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        f" ('jax', 'flax', 'optax', {JAX_PKG!r}))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_a_driver_under_a_one_rank_torchrun_env_raises_on_a_cpu_only_host(
        monkeypatch, tmp_path):
    """``torchrun --nproc_per_node=1`` on a host without a card and without
    ``+system.device=cpu``: the driver raises before it joins a group; it
    never falls back to gloo on the CPU."""
    import torch.distributed as dist

    from midvision_probe_torch import train_depth
    from midvision_probe_torch.parallel import multihost

    for name, value in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29531"),
                        ("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(multihost, "_initialized", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_group(*args, **kwargs):
        raise AssertionError("joined a process group on the CPU")

    monkeypatch.setattr(dist, "init_process_group", no_group)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_depth.entry(["backbone=test_tiny", "dataset=synthetic", "probe=depth_linear",
                           "+render_images=False", f"output_dir={tmp_path}"])
    assert not dist.is_initialized()
    assert not list(tmp_path.iterdir())  # nothing ran on the CPU


LAUNCH_AND_TOOLS = sorted(m for m in _port_modules() if m.startswith((
    "midvision_probe_torch.launch", "midvision_probe_torch.data_processing")))
# top-level names the repository's launch_script/ and data_processing/
# scripts are imported under (they put their directories on sys.path)
SCRIPT_MODULES = ("launch_script", "data_processing", "sweep", "suite_run",
                  "aggregate_results", "export_golden", "torch_replicas",
                  "convert_checkpoints", "extract_instance_masks", "time_suite",
                  "fast_preset_ab", "shuffle_ab", "__graft_entry__")


def test_launchers_and_data_tools_import_neither_jax_nor_the_jax_scripts():
    """``launch/`` and ``data_processing/`` of the port, each imported in a
    fresh interpreter: no jax, no JAX package and none of the repository's
    own ``launch_script/`` or ``data_processing/`` modules; and their
    sources neither name those directories in an import nor put anything
    on ``sys.path``."""
    assert len(LAUNCH_AND_TOOLS) == 12, LAUNCH_AND_TOOLS
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {LAUNCH_AND_TOOLS!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        f" ('jax', 'flax', 'optax', {JAX_PKG!r}, *{SCRIPT_MODULES!r}))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    hits = []
    for sub in ("launch", "data_processing"):
        for path in sorted((PORT / sub).glob("*.py")):
            for n, line in enumerate(path.read_text().splitlines(), 1):
                code_part = line.split("#")[0]
                if "sys.path" in code_part or any(
                        code_part.lstrip().startswith((f"import {m}", f"from {m} "))
                        for m in SCRIPT_MODULES):
                    hits.append((path.name, n, line.strip()))
    assert hits == []


def test_suite_timing_the_ab_launchers_and_the_dry_run_raise_without_a_device(
        monkeypatch, tmp_path, capsys):
    """``launch.time_suite``, ``launch.fast_preset_ab``, ``launch.shuffle_ab``
    and ``graft_entry`` run on the card by default: on a host without one
    and without ``--device cpu`` / ``device="cpu"`` each raises before its
    first forward, and the dry run before it starts a rank."""
    import subprocess as sp

    from midvision_probe_torch import graft_entry
    from midvision_probe_torch.launch import fast_preset_ab, shuffle_ab, time_suite

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_rank(*args, **kwargs):
        raise AssertionError("started a rank on the CPU")

    monkeypatch.setattr(sp, "Popen", no_rank)
    for run in (lambda: time_suite.main(["--backbones", "test_tiny_vit", "--batch", "1",
                                         "--out", str(tmp_path / "t.md")]),
                lambda: time_suite.measure_backbone("test_tiny_vit", 1, (32, 32)),
                lambda: fast_preset_ab.main(["--backbone", "test_tiny", "--arms", "dpt-160",
                                             "--out", str(tmp_path / "a.md"),
                                             "--work-dir", str(tmp_path)]),
                lambda: shuffle_ab.main(["--seeds", "0", "--out", str(tmp_path / "s.md"),
                                         "--work-dir", str(tmp_path)]),
                lambda: graft_entry.entry(),
                lambda: graft_entry.dryrun_multichip(4),
                lambda: graft_entry.dryrun_multichip(4, preset="vitb")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    assert not list(tmp_path.iterdir())  # nothing ran on the CPU
    assert "[ab]" not in capsys.readouterr().out
