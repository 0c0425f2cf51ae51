"""The port's suite end to end on the CPU: ``launch/suite_run.py`` with
``--device cpu`` runs real driver processes of the port over two tiny
cells (``test_tiny`` on depth and NAVI; the plan is cut to tiny sizes here
only), then ``launch/aggregate_results.py`` renders their CSVs and logs to
the same markdown, byte for byte, as the repository's
``launch_script/aggregate_results.py`` on the same directory, and
``parse_cell_log`` reads each port cell log into the CSV's values. Then the
port's SPair driver on the runner's own miniature SPair tree."""

import csv
import importlib.util
import pathlib
import shutil

import pytest

from midvision_probe_torch.launch import aggregate_results, suite_run

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_aggregate():
    spec = importlib.util.spec_from_file_location(
        "jax_launch_aggregate_results", ROOT / "launch_script" / "aggregate_results.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PLAN = suite_run.task_plan


def _tiny_plan(spair_root):
    plan = PLAN(spair_root)
    return {
        "depth": (plan["depth"][0], [
            "dataset=synthetic", "dataset.num_instances=8", "dataset.image_size=[32,32]",
            "optimizer=one_epoch", "batch_size=4", "+backbone.return_multilayer=True",
            "wandb.use=False", "+render_images=False", "probe=depth_linear"] + suite_run.FAST),
        "navi": (plan["navi"][0], [
            "dataset=synthetic_navi", "dataset.num_instances=2", "dataset.image_size=64",
            "num_corr=20", "batch_pairs=2", "scale_factor=0.25"]),
    }


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    root = tmp_path_factory.mktemp("suite")
    mp = pytest.MonkeyPatch()
    mp.setattr(suite_run, "task_plan", _tiny_plan)
    for var, value in (("MVP_SYNTH_DISK_CACHE", str(root / "synth")),
                       ("OMP_NUM_THREADS", "1"), ("MKL_NUM_THREADS", "1")):
        mp.setenv(var, value)
    try:
        rc = suite_run.main([
            "--models", "test_tiny", "--tasks", "depth", "navi", "--device", "cpu",
            "--log-dir", str(root / "logs"), "--out", str(root / "logs" / "suite_run.md"),
            "--suite-out", str(root / "out")])
    finally:
        mp.undo()
    return {"root": root, "rc": rc}


def test_suite_cells_run_on_the_cpu(suite):
    root = suite["root"]
    assert suite["rc"] == 0
    report = (root / "logs" / "suite_run.md").read_text()
    assert "on the CPU" in report and "(2 runs, 0 failures)" in report
    archived = sorted(p.name for p in (root / "logs" / "csv").iterdir())
    assert len(archived) == 2 and archived[0].startswith("depth_") \
        and archived[1].startswith("navi_")
    assert list((root / "synth").iterdir())  # the cells wrote the disk tier


@pytest.mark.parametrize("drop", [None, "navi"])
def test_aggregate_renders_the_jax_markdown_byte_for_byte(suite, tmp_path, drop):
    """On the archive as the suite left it, and with the NAVI CSV removed so
    that its row is recovered from the cell's log."""
    csv_dir = tmp_path / "logs" / "csv"
    shutil.copytree(suite["root"] / "logs", tmp_path / "logs")
    if drop:
        for p in csv_dir.glob(f"{drop}_*.csv"):
            p.unlink()
    j_agg = _jax_aggregate()
    outs = {}
    for side, mod in (("port", aggregate_results), ("jax", j_agg)):
        outs[side] = tmp_path / f"{side}.md"
        assert mod.main(["--csv-dir", str(csv_dir), "--out", str(outs[side])]) == 0
    port, jax_md = outs["port"].read_bytes(), outs["jax"].read_bytes()
    assert port == jax_md
    text = port.decode()
    assert "## depth (ranked by sa_d1 ↑)" in text and "## navi (ranked by" in text
    assert ("†" in text) == (drop is not None)


@pytest.mark.parametrize("task", ["depth", "navi"])
def test_parse_cell_log_reads_each_port_cell_log(suite, task):
    root = suite["root"]
    parsed = aggregate_results.parse_cell_log(
        task, (root / "logs" / task / "test_tiny.log").read_text())
    assert parsed
    (path,) = (root / "out" / task).glob("*.csv")
    with open(path, newline="") as f:
        (row,) = list(csv.DictReader(f))
    for k, v in parsed.items():  # the log prints 4 (depth) or 2 (NAVI) decimals
        assert abs(float(v) - float(row[k])) <= (5e-5 if task == "depth" else 5e-3), k


def test_spair_driver_reads_the_runners_mini_tree(tmp_path, monkeypatch):
    """The suite's SPair cell passes ``data_root=`` to the tree the runner
    writes; the port's reader takes it (3 classes x 4 pairs, the plan's
    ``num_instances=8`` cap, every viewpoint difference)."""
    from midvision_probe_torch import evaluate_spair_correspondence

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = suite_run.make_mini_spair(str(tmp_path / "spair"))
    overrides = suite_run.task_plan(root)["spair"][1]
    overrides = [o if o != "image_size=480" else "image_size=64" for o in overrides]
    evaluate_spair_correspondence.entry(["backbone=test_tiny", *overrides,
                                         "+system.device=cpu", f"output_dir={tmp_path}"])
    with open(tmp_path / "spair_correspondence_final.csv", newline="") as f:
        (row,) = list(csv.DictReader(f))
    assert row["Class"] == "all" and row["Num Instances"] == "8"  # the plan's cap
    recalls = [float(row[f"Recall (View Diff {d})"]) for d in ("0", "1", "2", "all")]
    assert all(0.0 <= r <= 100.0 for r in recalls)
