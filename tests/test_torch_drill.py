"""The port's weights-landing drill
(``midvision_probe_torch/data_processing/convert_checkpoints.py --all``)
against the repository's JAX drill (``data_processing/convert_checkpoints.py``)
on the CPU, over one fabricated full-size timm ViT container
(``dino_vitb16.pth``, flat DINO naming) and one ResNet-50 container
(``simclr_resnet50.torch``, VISSL nesting) in a temporary
``$MVP_CHECKPOINT_DIR``: every zoo entry gets the same status and detail in
both reports (present, missing, OK), and the port's goldens verify at the
JAX drill's atol, 2e-3, on every tap (the reading is printed). The port's
golden oracles are its own jax-free replicas
(``data_processing/torch_replicas.py``); the JAX side runs under
``jax.default_matmul_precision("float32")``."""

import contextlib
import importlib.util
import io
import pathlib
import sys

import jax
import pytest
import torch

from midvision_probe_torch.data_processing import convert_checkpoints as t_drill
from midvision_probe_torch.data_processing import torch_replicas as t_replicas

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = jax.default_matmul_precision("float32")
PRESENT = ("dino_vitb16", "simclr_resnet50")


def _jax_drill():
    sys.path.insert(0, str(ROOT / "data_processing"))
    spec = importlib.util.spec_from_file_location(
        "jax_convert_checkpoints", ROOT / "data_processing" / "convert_checkpoints.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _report(text):
    """{name: (status, detail)} from a drill report's table."""
    lines = text.split("=== weights-landing drill report", 1)[1].splitlines()[1:]
    rows = {}
    for ln in lines:
        if not ln.strip():
            break
        name, status, detail = ln.split(None, 2)
        rows[name] = (status, detail)
    return rows


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    sys.path.insert(0, str(ROOT / "data_processing"))
    from torch_replicas import wrap_vissl  # the repository's VISSL packaging

    ckpt = tmp_path_factory.mktemp("checkpoints")
    torch.save(t_replicas.TimmViT(seed=1).state_dict(), ckpt / "dino_vitb16.pth")
    torch.save(wrap_vissl(t_replicas.TorchResNet50(seed=2).state_dict()),
               ckpt / "simclr_resnet50.torch")
    mp = pytest.MonkeyPatch()
    mp.setenv("MVP_CHECKPOINT_DIR", str(ckpt))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    try:
        j_drill = _jax_drill()
        buf = io.StringIO()
        with F32, contextlib.redirect_stdout(buf):
            out["jax_rc"] = j_drill.drill()
        out["jax"] = buf.getvalue()
        drill_rows = t_drill.drill_rows  # recorded as the drill calls it

        def recorded(device=None):
            out["port_rows"] = drill_rows(device)
            return out["port_rows"]

        mp.setattr(t_drill, "drill_rows", recorded)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out["port_rc"] = t_drill.drill(device="cpu")
        out["port"] = buf.getvalue()
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return out


def test_drills_pass(drills):
    assert drills["jax_rc"] == 0 and drills["port_rc"] == 0


@pytest.mark.parametrize("name", PRESENT)
def test_present_model_has_the_jax_status(drills, name):
    t, j = _report(drills["port"]), _report(drills["jax"])
    assert t[name] == j[name] == ("OK", "converted + golden-verified vs torch replica")


def test_every_zoo_entry_has_the_jax_status(drills):
    t, j = _report(drills["port"]), _report(drills["jax"])
    assert t == j
    assert sum(s == "MISSING" for s, _ in t.values()) == len(t) - len(PRESENT)
    tail = [ln for ln in drills["port"].splitlines() if ln.startswith("present ")]
    assert tail == [ln for ln in drills["jax"].splitlines() if ln.startswith("present ")]
    assert tail == ["present 2 | missing 49 | failed 0 | golden rc=0 | smoke ok=True"]


@pytest.mark.parametrize("name", PRESENT)
def test_port_goldens_verify_within_the_jax_atol(drills, name):
    readings = drills["port_rows"]["readings"][name]
    print(f"{name}: max abs err per tap {['%.2e' % e for e in readings]}")
    assert len(readings) == (4 if name == "dino_vitb16" else 5)
    assert max(readings) <= 2e-3


def test_a_model_without_an_oracle_here_is_reported_not_failed(tmp_path, monkeypatch, capsys):
    """SAM's golden oracle is a ``transformers`` model: on a host without
    it the drill converts and smoke-tests the file and reports OK-SMOKE
    with the reason, neither failing it nor dropping it silently."""
    import chip_smoke
    from midvision_probe_torch.data_processing import export_golden

    torch.save(chip_smoke.sam_vitb_container(torch), tmp_path / "sam_vit_b_01ec64.pth")
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(tmp_path))
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(export_golden.importlib.util, "find_spec",
                        lambda name, *a: None if name == "transformers" else find_spec(name, *a))
    res = t_drill.drill_rows(device="cpu")
    out = capsys.readouterr().out
    assert res["rc"] == 0 and res["present"] == ["sam_vit_b"]
    (row,) = [r for r in res["rows"] if r[0] == "sam_vit_b"]
    assert row[1] == "OK-SMOKE" and "transformers" in row[2]
    assert "[golden-NO-ORACLE] sam_vit_b" in out and "[ok]      sam_vit_b" in out
