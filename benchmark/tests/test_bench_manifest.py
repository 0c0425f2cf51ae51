"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name; a new configuration, mix and metric taken in from added
files alone."""

from __future__ import annotations

import json
import re
import shutil

import time

import pytest
import torch

from benchmark import manifest, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names(bench):
    assert set(bench) == TOP_KEYS
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    names = [e["name"] for k in ("configs", "workloads") for e in bench[k]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names) and len(set(metrics)) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_command_paths_and_budget(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(word) for word in bench["command"])
    seconds = bench["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    runs = 2 + 14 * 24  # a full check with the 24 cells a benchmark may reach
    assert runs * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and setup[0]["source"] == "host_clock"
    assert all(m["source"] in ("host_clock", "device_trace") for m in bench["end_to_end"])


def test_every_file_found_by_name(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        cfg = manifest.config(bench, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        loop = manifest.loop(manifest.mix(w["traffic"])["loop"])
        assert callable(loop.Session) and callable(loop.flops_per_image)
        assert isinstance(loop.CONTROLS, dict) and isinstance(loop.FAULTS, dict)
        assert manifest.limits(w["name"])
    for m in bench["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in manifest.metrics(bench, w["name"], trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics(bench, w["name"], trace=True)


def test_moves_is_reported_by_each_of_its_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert _line(m["layer"])
        cells = m.get("workloads", [w["name"] for w in bench["workloads"]])
        for cell in cells:
            manifest.cell(bench, cell)
            assert manifest.reports(e2e[m["moves"]], cell)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


NEW_LOOP = """
import time

from benchmark import inputs, session

CONTROLS, FAULTS = {}, {}


def flops_per_image(cfg, mix):
    return 2.0 * mix["size"] ** 3


class Session:
    def __init__(self, cfg, mix, seed, device):
        self.mix, self.phases = mix, session.Phases()
        self.x = inputs.images(seed, 0, 1, [mix["size"]] * 2, device)[0, :, :, 0]
        self.outs = []

    def window(self, seconds, tracer=None):
        t0 = time.perf_counter()
        while not self.outs or time.perf_counter() - t0 < seconds:
            self.outs.append(self.x @ self.x)
        wall = time.perf_counter() - t0
        n = len(self.outs)
        return {"steps": n, "images": n, "window_s": wall, "step_ms": [wall * 1e3 / n] * n}

    def release(self):
        pass

    def check(self, lowp=None):
        ref = (self.x.double() @ self.x.double()).float()
        return {"product_err": max(float((o - ref).abs().max()) for o in self.outs)}
"""


def test_the_harness_takes_new_files_alone(tmp_path, bench):
    """A configuration, a mix with a loop of its own, a metric and a cell's
    limits added as files, with entries in BENCHMARK.json, are found
    without editing a file, and a run drives the new loop."""
    here = tmp_path / "benchmark"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    added = dict(bench)
    (here / "configs" / "new_vit.json").write_text(json.dumps(
        dict(manifest.config(bench, "dino_b16"), name="new_vit")))
    (here / "traffic" / "new_mix.json").write_text(json.dumps({"loop": "new_loop",
                                                               "size": 32}))
    (here / "loops" / "new_loop.py").write_text(NEW_LOOP)
    (here / "metrics" / "new_metric.py").write_text("def read(ctx):\n    return 1.5\n")
    (here / "limits" / "new_vit.new_mix.json").write_text(json.dumps(
        {"product_err": {"limit": 1e-3}}))
    added["configs"] = bench["configs"] + [dict(bench["configs"][0], name="new_vit",
                                                file="benchmark/configs/new_vit.json")]
    added["workloads"] = bench["workloads"] + [{
        "name": "new_vit.new_mix", "config": "new_vit", "traffic": "new_mix", "chips": 1,
        "why": "a test"}]
    added["per_layer"] = bench["per_layer"] + [{
        "name": "new_metric", "unit": "%", "better": "higher", "source": "device_trace",
        "layer": "device", "moves": "images_per_s", "workloads": ["new_vit.new_mix"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(added))
    loaded = manifest.load(tmp_path)
    cell = manifest.cell(loaded, "new_vit.new_mix")
    assert manifest.config(loaded, cell["config"], root=tmp_path)["name"] == "new_vit"
    mix = manifest.mix(cell["traffic"], here=here)
    limits = manifest.limits(cell["name"], here=here)
    assert manifest.loop(mix["loop"], here=here).flops_per_image({}, mix) == 2.0 * 32**3
    layer = manifest.metrics(loaded, cell["name"], trace=True)
    assert [m["name"] for m in layer] == ["new_metric"]
    assert manifest.reader("new_metric", here=here).read(None) == 1.5
    entries = manifest.metrics(loaded, cell["name"], trace=False)
    result = run.execute(cell["name"], {}, mix, limits, entries, 2**31 + 5, 0.05, False,
                         torch.device("cpu"), time.time(), here=here)
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert list(result["checks"]) == ["product_err"]


def test_limits_sit_between_their_readings():
    """Every limit that has its two readings lies above the lower and below
    the upper; a limit without an upper reading is for the record only."""
    for path in sorted((manifest.HERE / "limits").glob("*.json")):
        for name, entry in json.loads(path.read_text()).items():
            lower, upper = entry.get("lower"), entry.get("upper")
            if lower is not None and upper is not None:
                assert lower < entry["limit"] < upper, (path.name, name)
