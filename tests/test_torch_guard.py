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
