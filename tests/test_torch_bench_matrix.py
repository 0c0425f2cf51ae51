"""The port's regression matrix (``midvision_probe_torch/launch/bench_matrix.py``)
against the repository's ``launch_script/bench_matrix.py``.

* The rows: both scripts' ``measure`` with their timing functions replaced
  by recorders (the JAX script's ``_extract_imgs_per_sec`` and
  ``measure_backbone``, the port's ``extract_imgs_per_sec`` and
  ``measure_backbone``) that return the same fixed times: the same six
  rows, backbones, batches, sizes, probe heads and dtypes, units and
  roundings; ``--rows`` subsets likewise.
* ``check``: both on the same dicts, the failure lists and every printed
  row (value, bounds, ok/REGRESSED) equal, at the ±15% edges of a
  higher-is-better and a ``lower_is_better`` row, for a ``--rows`` subset
  and a missing row; the port also skips the expectations' ``_meta``.
* ``main``: both with ``measure`` replaced by the same fixed dicts and the
  expectations files under ``tmp_path``: the first run writes the file
  and returns 0, ``--update`` of a ``--rows`` subset merges only those
  rows, a regression returns 1 with the same failure line, a run within
  tolerance returns 0.
* The JAX tool's fault: its ``_extract_imgs_per_sec`` sends SAM-B and
  ConvNeXt-B to ``zoo.build_vit_extractor``, which raises ``TypeError``
  on their ``ZooEntry.vit = None``; the port builds them with
  ``zoo.build_sam_extractor`` and ``zoo.build_convnext_extractor`` (the
  builders replaced by recorders that return test_tiny_vit).

The JAX script is loaded from its file with ``launch_script/`` on
``sys.path`` for its ``time_suite`` import; both its and ``time_suite``'s
import-time compile-cache settings, ``sys.path`` and ``sys.modules`` are
put back after.
"""

import importlib.util
import json
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from midvision_probe_torch.launch import bench_matrix as t_matrix
from midvision_probe_tpu.models import zoo as j_zoo

ROOT = pathlib.Path(__file__).resolve().parents[1]
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
ROWS = ["vitb16_extract", "resnet50_extract", "sam_vitb_extract", "convnextb_extract",
        "vitb16_dpt_step", "vitb16_linear_step"]


@pytest.fixture(scope="module")
def j_matrix():
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    path, had_time_suite = list(sys.path), "time_suite" in sys.modules
    sys.path.insert(0, str(ROOT / "launch_script"))
    spec = importlib.util.spec_from_file_location("_jax_bench_matrix",
                                                  ROOT / "launch_script" / "bench_matrix.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
        if not had_time_suite:
            sys.modules.pop("time_suite", None)
    return module


# ------------------------------------------------------------------ the rows
EXTRACT_S = 0.0123456  # seconds a batch of every extraction
STEP_S = (0.0111111, 0.0166666, 0.1721111)  # extract, probe step, full step


@pytest.fixture
def recorded(j_matrix, monkeypatch):
    """Both scripts' timing functions replaced by recorders returning the
    same fixed times; ``calls[side]`` lists what each was asked."""
    calls = {"jax": [], "port": []}

    def extract(side):
        def fn(name, batch, hw, device=None):
            calls[side].append(("extract", name, batch, tuple(hw)))
            return batch / EXTRACT_S
        return fn

    def steps(side):
        def fn(name, batch, hw, head_type, probe_dtype, device=None):
            calls[side].append(("step", name, batch, tuple(hw), head_type,
                                jnp.dtype(probe_dtype).name))
            return STEP_S
        return fn

    monkeypatch.setattr(j_matrix, "_extract_imgs_per_sec", extract("jax"))
    monkeypatch.setattr(j_matrix, "measure_backbone", steps("jax"))
    monkeypatch.setattr(t_matrix, "extract_imgs_per_sec", extract("port"))
    monkeypatch.setattr(t_matrix, "measure_backbone", steps("port"))
    return calls


@pytest.mark.parametrize("rows", [None, ["sam_vitb_extract", "vitb16_linear_step"],
                                  ["vitb16_dpt_step"]])
def test_measure_takes_the_jax_rows(j_matrix, recorded, rows):
    ref = j_matrix.measure(rows)
    got = t_matrix.measure(rows, device="cpu")
    assert got == ref and list(got) == [r for r in ROWS if rows is None or r in rows]
    assert recorded["port"] == recorded["jax"] and recorded["port"]


# ------------------------------------------------------------------- check
def _row(value, lower=False):
    unit = "ms" if lower else "imgs/s"
    return {"value": value, "unit": unit, **({"lower_is_better": True} if lower else {})}


EXPECTED = {"vitb16_extract": _row(1000.0), "convnextb_extract": _row(850.5),
            "vitb16_dpt_step": _row(170.0, lower=True),
            "vitb16_linear_step": _row(16.5, lower=True)}
# the ±15% edges as both scripts compute them, and the next float beyond
LO = {k: v["value"] * (1 - 0.15) for k, v in EXPECTED.items()}
HI = {k: v["value"] * (1 + 0.15) for k, v in EXPECTED.items()}
CHECK_CASES = {
    # higher is better: at the -15% edge passes; faster never fails
    "extract_edges": ({"vitb16_extract": _row(LO["vitb16_extract"]),
                       "convnextb_extract": _row(LO["convnextb_extract"]),
                       "vitb16_dpt_step": _row(170.0, True),
                       "vitb16_linear_step": _row(16.5, True)}, None),
    "extract_regressed_and_faster": ({
        "vitb16_extract": _row(math.nextafter(LO["vitb16_extract"], 0)),
        "convnextb_extract": _row(2000.0), "vitb16_dpt_step": _row(100.0, True),
        "vitb16_linear_step": _row(1.0, True)}, None),
    # lower is better: at the +15% edge passes, the next float fails
    "step_edges": ({"vitb16_extract": _row(1000.0), "convnextb_extract": _row(850.5),
                    "vitb16_dpt_step": _row(HI["vitb16_dpt_step"], True),
                    "vitb16_linear_step": _row(HI["vitb16_linear_step"], True)}, None),
    "step_regressed": ({"vitb16_extract": _row(1000.0), "convnextb_extract": _row(850.5),
                        "vitb16_dpt_step": _row(math.nextafter(HI["vitb16_dpt_step"], 1e9),
                                                True),
                        "vitb16_linear_step": _row(16.5, True)}, None),
    # a --rows subset: the unrequested (and unmeasured) keys are no failures
    "rows_subset": ({"vitb16_dpt_step": _row(250.0, True)}, ["vitb16_dpt_step"]),
    # a row the expectations have and the run did not measure
    "missing_row": ({"vitb16_extract": _row(1000.0), "vitb16_dpt_step": _row(170.0, True)},
                    None),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_matches_the_jax_check(j_matrix, capsys, case):
    measured, rows = CHECK_CASES[case]
    ref = j_matrix.check(measured, EXPECTED, rows=rows)
    ref_out = capsys.readouterr().out
    got = t_matrix.check(measured, EXPECTED, rows=rows)
    got_out = capsys.readouterr().out
    assert got == ref and got_out == ref_out
    # each case reaches what it is named for
    statuses = [ln.split()[-1] for ln in got_out.splitlines()]
    if case in ("extract_regressed_and_faster", "step_regressed"):
        assert statuses.count("REGRESSED") == len(got) == 1 and statuses.count("ok") == 3
    elif case == "rows_subset":
        assert got == ["vitb16_dpt_step: 250.0 vs expected 170.0 (±15%)"]
        assert statuses == ["REGRESSED"]
    elif case == "missing_row":
        assert got == ["convnextb_extract: not measured", "vitb16_linear_step: not measured"]
        assert statuses == ["ok", "ok"]
    else:
        assert got == [] and statuses == ["ok"] * 4
    # the port's expectations carry a _meta entry, which is no row
    meta = {**EXPECTED, "_meta": {"card": "NVIDIA H100 80GB HBM3, 700.00 W"}}
    assert t_matrix.check(measured, meta, rows=rows) == got
    assert capsys.readouterr().out == got_out


# -------------------------------------------------------------------- main
MEASURED = {"vitb16_extract": _row(1369.4), "resnet50_extract": _row(2647.8),
            "sam_vitb_extract": _row(345.8), "convnextb_extract": _row(1137.8),
            "vitb16_dpt_step": _row(171.2, True), "vitb16_linear_step": _row(15.54, True)}


@pytest.fixture
def both_mains(j_matrix, monkeypatch, tmp_path):
    """``run(side, values, argv)``: that side's ``main`` with ``measure``
    returning ``values`` (restricted to ``--rows``) and its expectations
    file at ``tmp_path/<side>_expected.json``; returns (rc, expectations,
    the last line printed)."""
    paths = {"jax": tmp_path / "jax_expected.json", "port": tmp_path / "port_expected.json"}
    mods = {"jax": j_matrix, "port": t_matrix}
    for side, mod in mods.items():
        monkeypatch.setattr(mod, "EXPECTED_PATH", str(paths[side]))

    def run(side, values, argv, capsys):
        def measure(rows=None, device=None):
            return {k: dict(v) for k, v in values.items() if rows is None or k in rows}

        monkeypatch.setattr(mods[side], "measure", measure)
        extra = ["--device", "cpu"] if side == "port" else []
        rc = mods[side].main(["--out", str(tmp_path / f"{side}_run.json"), *argv, *extra])
        last = capsys.readouterr().out.strip().splitlines()[-1]
        with open(paths[side]) as f:
            return rc, json.load(f), last

    return run


def _rows_of(expected: dict) -> dict:
    return {k: v for k, v in expected.items() if not k.startswith("_")}


def test_main_writes_merges_and_fails_as_the_jax_main(both_mains, capsys):
    # the first run with no expectations file writes it and passes
    first = {side: both_mains(side, MEASURED, [], capsys) for side in ("jax", "port")}
    assert first["jax"][0] == first["port"][0] == 0
    assert _rows_of(first["port"][1]) == first["jax"][1] == MEASURED
    meta = first["port"][1]["_meta"]
    assert meta["card"] == "the CPU" and meta["device"] == "cpu"
    assert {"wall_s", "date"} <= set(meta)

    # --update of a --rows subset refreshes only those rows
    slower = {**MEASURED, "sam_vitb_extract": _row(100.0), "vitb16_dpt_step": _row(400.0, True)}
    argv = ["--update", "--rows", "sam_vitb_extract", "vitb16_dpt_step"]
    upd = {side: both_mains(side, slower, argv, capsys) for side in ("jax", "port")}
    assert upd["jax"][0] == upd["port"][0] == 0
    want = {**MEASURED, "sam_vitb_extract": _row(100.0), "vitb16_dpt_step": _row(400.0, True)}
    assert _rows_of(upd["port"][1]) == upd["jax"][1] == want

    # a regression beyond 15% fails with rc 1 and the same failure line
    regressed = {**want, "resnet50_extract": _row(2000.0)}
    reg = {side: both_mains(side, regressed, [], capsys) for side in ("jax", "port")}
    assert reg["jax"][0] == reg["port"][0] == 1
    assert reg["port"][2] == reg["jax"][2] == (
        "[bench_matrix] 1 regression(s): ['resnet50_extract: 2000.0 vs expected 2647.8 (±15%)']")
    assert _rows_of(reg["port"][1]) == reg["jax"][1] == want  # a check writes nothing

    # within tolerance: rc 0
    ok = {side: both_mains(side, want, [], capsys) for side in ("jax", "port")}
    assert ok["jax"][0] == ok["port"][0] == 0
    assert ok["port"][2] == ok["jax"][2] == "[bench_matrix] all rows within tolerance"


def test_main_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_measure(*args, **kwargs):
        raise AssertionError("measured without a card")

    monkeypatch.setattr(t_matrix, "measure", no_measure)
    monkeypatch.setattr(t_matrix, "EXPECTED_PATH", str(tmp_path / "e.json"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_matrix.main(["--out", str(tmp_path / "m.json")])
    assert not list(tmp_path.iterdir())


# --------------------------------------------------- SAM-B and ConvNeXt-B rows
@pytest.mark.parametrize("name", ["sam_vit_b", "cnxt_b_in22k"])
def test_the_jax_matrix_cannot_build_sam_or_convnext(j_matrix, name):
    """The witness: the JAX tool's row goes through ``build_vit_extractor``,
    which cannot build an entry without ViT settings."""
    assert j_zoo.ZOO[name].vit is None
    with pytest.raises(TypeError, match="must be a mapping, not NoneType"):
        j_matrix._extract_imgs_per_sec(name, 1, (32, 32))


def test_the_port_builds_sam_and_convnext_with_their_own_builders(monkeypatch):
    calls = []
    tiny = t_matrix.zoo.build_vit_extractor

    def builder(which):
        def fn(name, **kw):
            calls.append((which, name, kw))
            return tiny("test_tiny_vit", return_multilayer=True, dtype=torch.bfloat16,
                        device="cpu")
        return fn

    for which in ("vit", "resnet", "sam", "convnext"):
        monkeypatch.setattr(t_matrix.zoo, f"build_{which}_extractor", builder(which))
    monkeypatch.setattr(t_matrix, "EXTRACT_ROWS", {
        key: (name, 1, (32, 32)) for key, (name, _, _) in t_matrix.EXTRACT_ROWS.items()})
    monkeypatch.setattr(t_matrix, "EXTRACT_ITERS", 1)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = t_matrix.measure(ROWS[:4], device="cpu")
    finally:
        torch.set_num_threads(n)
    assert list(got) == ROWS[:4] and all(r["value"] > 0 for r in got.values())
    common = {"return_multilayer": True, "dtype": torch.bfloat16, "device": "cpu"}
    assert calls == [("vit", "dino_vitb16", {**common, "init_size": 224}),
                     ("resnet", "simclr_resnet50", {**common, "return_layers": [1, 2, 3, 4]}),
                     ("sam", "sam_vit_b", common),
                     ("convnext", "cnxt_b_in22k", common)]


# ------------------------------------------- the step rows' host-side copies
@pytest.mark.parametrize("head", ["linear", "dpt"])
def test_a_probe_step_copies_nothing_from_host_memory(monkeypatch, head):
    """The step rows time ``time_suite``'s probe step. On the card its wall
    followed the host's speed while the depth loss and the head made their
    scalar constants with ``new_tensor`` and ``resize`` copied its numpy
    matrices at every call: each copy from host memory holds the host until
    the card's queue drains. After a first step, which fills the resize
    caches, a step makes no such copy (the calls counted on the CPU, where
    the same code runs)."""
    from midvision_probe_torch.launch import time_suite

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        steps = time_suite.build_steps("test_tiny_vit", 2, (32, 32), head, "bfloat16",
                                       hidden_dim=32, device="cpu")
        feats = steps.extract(steps.images)
        steps.probe_step(feats, steps.depth)
        calls = []

        def counted(name, fn):
            def wrapper(*args, **kwargs):
                calls.append(name)
                return fn(*args, **kwargs)
            return wrapper

        monkeypatch.setattr(torch.Tensor, "new_tensor",
                            counted("new_tensor", torch.Tensor.new_tensor))
        for name in ("as_tensor", "tensor", "from_numpy"):
            monkeypatch.setattr(torch, name, counted(name, getattr(torch, name)))
        loss = steps.probe_step(feats, steps.depth)
    finally:
        torch.set_num_threads(n)
    assert calls == [] and bool(torch.isfinite(loss))
