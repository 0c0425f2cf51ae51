"""The SPair-71k slice end to end: the port's
``evaluate_spair_correspondence`` against the repository's JAX driver
``evaluate_spair_correspondence.run`` on one fabricated SPair-71k tree (2
classes x 6 test pairs over viewpoint differences 0, 1 and 2, 48x64 JPEGs
and segmentations; the layout of ``tests/test_torch_spair.py``), every
class and viewpoint difference, ``backbone=test_tiny`` with the JAX
variables carried across by ``convert.from_jax``, at 64x64 in batches of 4
pairs (a ragged last batch).

The CSV rows are equal (but for the time stamp), and so are the recall
tables. The heat maps (``return_heatmaps``) are within 1e-5, and their
argmax, the predicted keypoint, is equal wherever the JAX heat map's top
two values are more than 1e-5 apart; a keypoint at a nearer tie may
differ, and the test counts and reports those. Run once without and once
with ``mask_feats``. f32 everywhere, the JAX side under
``jax.default_matmul_precision("float32")``."""

import csv
import os
import sys

import jax
import numpy as np
import pytest

import evaluate_spair_correspondence as j_driver
from midvision_probe_torch import evaluate_spair_correspondence as t_driver
from midvision_probe_torch.convert.from_jax import vit_state_dict
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.models import zoo as j_zoo

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_spair import make_spair_tree  # noqa: E402

F32 = jax.default_matmul_precision("float32")
CSV_NAME = "spair_correspondence_final.csv"
TIE_GAP = 1e-5


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def _top2_gap(heat):
    flat = np.sort(heat.reshape(*heat.shape[:2], -1), axis=-1)
    return flat[..., -1] - flat[..., -2]


@pytest.mark.parametrize("mask_feats", [False, True])
def test_spair_slice_matches_jax(tmp_path, monkeypatch, mask_feats):
    root = make_spair_tree(tmp_path / "spair", 6, seed=5, classes=("cat", "dog"))
    argv = ["backbone=test_tiny", f"data_root={root}", "image_size=64", "batch_pairs=4",
            "return_heatmaps=true", f"mask_feats={str(mask_feats).lower()}"]
    with F32:
        jrow = j_driver.run(j_compose("spair_correspondence", argv + [
            f"output_dir={tmp_path / 'jax'}"]))

    jvars = jax.tree_util.tree_map(np.asarray, j_zoo.build_vit_extractor(
        "test_tiny_vit", return_multilayer=False, add_norm=True).variables)

    def load_jax_vit(module, seed=0):
        module.load_state_dict(vit_state_dict(jvars))
        return module

    monkeypatch.setattr(t_zoo, "random_init", load_jax_vit)
    trow = t_driver.entry(argv + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])

    table = trow.pop("class_recalls")
    assert trow == jrow
    assert list(table) == list(t_driver.CLASS_IDS)
    for cls, recalls in table.items():
        assert len(recalls) == 4
        if cls in ("cat", "dog"):
            assert all(0.0 <= r <= 100.0 for r in recalls), cls
        else:
            assert recalls == [-1.0] * 4, cls
    jcsv = _read_csv(tmp_path / "jax" / CSV_NAME)
    tcsv = _read_csv(tmp_path / "torch" / CSV_NAME)
    assert list(tcsv) == list(jcsv)
    assert {k: v for k, v in tcsv.items() if k != "Time"} == \
        {k: v for k, v in jcsv.items() if k != "Time"}

    heat_files = sorted(os.listdir(tmp_path / "jax" / "spair_heatmaps"))
    assert heat_files == sorted(os.listdir(tmp_path / "torch" / "spair_heatmaps"))
    assert len(heat_files) == 8  # 2 classes x {0, 1, 2, all}
    near_ties, clear_count = 0, 0
    for name in heat_files:
        jh = np.load(tmp_path / "jax" / "spair_heatmaps" / name)["heatmaps"]
        th = np.load(tmp_path / "torch" / "spair_heatmaps" / name)["heatmaps"]
        assert th.shape == jh.shape and th.shape[1:] == (30, 8, 8), name
        np.testing.assert_allclose(th, jh, atol=1e-5, rtol=0, err_msg=name)
        j_arg = jh.reshape(*jh.shape[:2], -1).argmax(-1)
        t_arg = th.reshape(*th.shape[:2], -1).argmax(-1)
        clear = _top2_gap(jh) > TIE_GAP
        np.testing.assert_array_equal(t_arg[clear], j_arg[clear], err_msg=name)
        zero = (jh == 0).all(axis=(2, 3))
        assert (th[zero] == 0).all() and (t_arg[zero] == 0).all() and (j_arg[zero] == 0).all()
        near_ties += int((~clear).sum())
        clear_count += int(clear.sum())
    # with mask_feats, a keypoint on a masked patch (the padded slots sit at
    # the corner) has an all-zero heat map: an exact tie, which both send to
    # the first cell
    print(f"predicted keypoints equal: {clear_count}; at a top-two gap <= {TIE_GAP}: "
          f"{near_ties}")
    assert clear_count > 0
