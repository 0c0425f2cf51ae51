"""The MaskCut slice end to end: the port's ``evaluate_generic_objectness``
against the repository's JAX driver (``evaluate_generic_objectness.run``)
on the synthetic binary-mask set (``SyntheticBinaryMask``, 4 images of
96x96) with ``backbone=test_tiny`` at ``maskcut.fixed_size=128`` (a 16x16
patch grid), the JAX backbone's weights carried across by
``convert.from_jax``: the same CSV columns in the same order, as many
images and errors, and each metric within 0.02 (the two 2-means draw from
different generators, so tau may differ within scikit-learn's own
run-to-run spread). The port's driver exits non-zero, before the CSV
append, when every image fails. The JAX side runs under
``jax.default_matmul_precision("float32")``."""

import csv

import jax
import numpy as np
import pytest

import evaluate_generic_objectness as j_driver
from midvision_probe_torch import evaluate_generic_objectness as t_driver
from midvision_probe_torch.config import compose as t_compose
from midvision_probe_torch.convert.from_jax import vit_state_dict
from midvision_probe_torch.datasets.synthetic import SyntheticBinaryMask as TSynthetic
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.datasets.synthetic import SyntheticBinaryMask as JSynthetic
from midvision_probe_tpu.models import zoo as j_zoo

F32 = jax.default_matmul_precision("float32")
ARGV = ["backbone=test_tiny", "maskcut.fixed_size=128", "max_images=4"]
CSV_NAME = "final_results_summary_synthetic_voc.csv"


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def test_maskcut_slice_matches_jax(tmp_path, monkeypatch):
    with F32:
        jmetrics = j_driver.run(j_compose("objectness_eval", ARGV + [
            f"output_dir={tmp_path / 'jax'}"]), dataset=JSynthetic(4, (96, 96)))
    jvars = jax.tree_util.tree_map(np.asarray, j_zoo.build_vit_extractor(
        "test_tiny_vit", output="dense", add_norm=True).variables)

    def load_jax_vit(module, seed=0):
        module.load_state_dict(vit_state_dict(jvars))
        return module

    monkeypatch.setattr(t_zoo, "random_init", load_jax_vit)
    tmetrics = t_driver.run(t_compose("objectness_eval", ARGV + [
        "+system.device=cpu", f"output_dir={tmp_path / 'torch'}"]),
        dataset=TSynthetic(4, (96, 96)))

    assert set(tmetrics) == set(jmetrics) == {"F-measure", "IoU", "Accuracy", "CorLoc"}
    for k, v in jmetrics.items():
        assert 0.0 <= tmetrics[k] <= 1.0
        np.testing.assert_allclose(tmetrics[k], v, atol=0.02, err_msg=k)
    jcsv, tcsv = (_read_csv(tmp_path / side / CSV_NAME) for side in ("jax", "torch"))
    assert list(tcsv) == list(jcsv) == [
        "Time", "Model Checkpoint", "Layer", "Output", "Num Images", "Num Errors",
        "F-measure", "IoU", "Accuracy", "CorLoc"]
    for k in ("Model Checkpoint", "Layer", "Output", "Num Images", "Num Errors"):
        assert tcsv[k] == jcsv[k], k
    assert tcsv["Num Images"] == "4" and tcsv["Num Errors"] == "0"
    for k in jmetrics:
        np.testing.assert_allclose(float(tcsv[k]), float(jcsv[k]), atol=0.02, err_msg=k)


def test_driver_exits_before_the_csv_when_every_image_fails(tmp_path):
    class Broken(TSynthetic):
        def __getitem__(self, i):
            item = super().__getitem__(i)
            del item["raw_image"]
            return item

    cfg = t_compose("objectness_eval", ARGV + ["+system.device=cpu",
                                               f"output_dir={tmp_path}"])
    with pytest.raises(SystemExit, match="all 2 images failed"):
        t_driver.run(cfg, dataset=Broken(2, (96, 96)))
    assert not list(tmp_path.glob("final_results_summary_*.csv"))
