"""The geometric correspondence slice of the PyTorch port end to end: each
port driver against the repository's JAX driver on the same config, with
the JAX-initialised backbone weights carried across.

Setup: test_tiny on the hardened synthetic pair sets (they do not saturate
at recall 100), 8 pairs in batches of 4, num_corr=100. The JAX side runs
under ``jax.default_matmul_precision("float32")``. Tolerances: every CSV
recall and binned recall within 0.5 percentage points (one flipped match
of 800 is 0.125); the same CSV columns; equal ``valid`` masks; the selected
query indices of each pair the same on at least 99% of valid rows. The
indices are compared as per-pair sets: ratio weights that tie to ~1e-7
swap adjacent ranks between the two f32 implementations."""

import csv

import jax
import numpy as np
import pytest

import evaluate_navi_correspondence as j_navi
import render_scannet_correspondence as j_scannet
from midvision_probe_torch import evaluate_navi_correspondence as t_navi
from midvision_probe_torch import render_scannet_correspondence as t_scannet
from midvision_probe_torch.convert.from_jax import vit_state_dict
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_torch.utils import correspondence as tc
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.models import zoo as j_zoo
from midvision_probe_tpu.utils import correspondence as jc

F32 = jax.default_matmul_precision("float32")
COMMON = ["backbone=test_tiny", "dataset.num_instances=8", "num_corr=100",
          "scale_factor=0.25", "batch_pairs=4"]


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's backbone loads the JAX package's test_tiny weights."""
    jvars = jax.tree_util.tree_map(np.asarray, j_zoo.build_vit_extractor(
        "test_tiny_vit", output="dense", add_norm=True).variables)

    def load_jax_vit(module, seed=0):
        module.load_state_dict(vit_state_dict(jvars))
        return module

    monkeypatch.setattr(t_zoo, "random_init", load_jax_vit)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def _compare(tmp_path, csv_name, jax_rec, torch_rec):
    jrow = _read_csv(tmp_path / "jax" / csv_name)
    trow = _read_csv(tmp_path / "torch" / csv_name)
    assert list(trow) == list(jrow)
    recall_cols = [k for k in jrow if "Rec" in k]
    assert len(recall_cols) >= 10
    for k in recall_cols:
        j, t = float(jrow[k]), float(trow[k])
        assert (np.isnan(j) and np.isnan(t)) or abs(j - t) <= 0.5, (k, j, t)
    for k in jrow:
        if k not in recall_cols and k != "Time":
            assert trow[k] == jrow[k], k

    j_valid = np.concatenate([v for v, _ in jax_rec])
    t_valid = np.concatenate([v for v, _ in torch_rec])
    np.testing.assert_array_equal(t_valid, j_valid)
    assert j_valid.sum() > 0
    j_sel = np.concatenate([s for _, s in jax_rec])
    t_sel = np.concatenate([s for _, s in torch_rec])
    shared = sum(len(set(j[v]) & set(t[v])) for j, t, v in zip(j_sel, t_sel, j_valid))
    assert shared >= 0.99 * j_valid.sum(), (shared, j_valid.sum())


def _pixel_index(uv, width):
    """Pixel-center (u, v) coordinates -> flat pixel indices."""
    uv = np.asarray(uv)
    return np.floor(uv[..., 1]).astype(int) * width + np.floor(uv[..., 0]).astype(int)


def test_navi_driver_matches_jax(tmp_path, monkeypatch, jax_weights):
    argv = COMMON + ["dataset=synthetic_navi_hard"]
    jax_rec, torch_rec = [], []
    j_errors, t_errors = j_navi.navi_batch_errors, t_navi.navi_batch_errors

    def jax_errors(f0, f1, x0, x1, Rt, K, num_corr, use_pallas):
        e3, e2, ok = j_errors(f0, f1, x0, x1, Rt, K, num_corr=num_corr,
                              use_pallas=use_pallas)
        uv0 = jax.vmap(lambda a, b, c, d: jc.estimate_correspondence_xyz(
            a, b, c, d, num_corr, use_pallas=use_pallas)[3])(f0, f1, x0, x1)
        jax_rec.append((np.asarray(ok), _pixel_index(uv0, x0.shape[2])))
        return e3, e2, ok

    def torch_errors(f0, f1, x0, x1, Rt, K, num_corr):
        e3, e2, ok = t_errors(f0, f1, x0, x1, Rt, K, num_corr=num_corr)
        uv0 = tc.estimate_correspondence_xyz(f0, f1, x0, x1, num_corr)[3]
        torch_rec.append((ok.numpy(), _pixel_index(uv0.numpy(), x0.shape[2])))
        return e3, e2, ok

    monkeypatch.setattr(j_navi, "navi_batch_errors", jax_errors)
    monkeypatch.setattr(t_navi, "navi_batch_errors", torch_errors)
    with F32:
        j_navi.run(j_compose("navi_correspondence",
                             argv + [f"output_dir={tmp_path / 'jax'}"]))
    out = t_navi.entry(argv + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])
    assert out["err_3d"].shape == out["valid"].shape == (8, 100)
    assert len(jax_rec) == len(torch_rec) == 2
    _compare(tmp_path, "navi_correspondence_final.csv", jax_rec, torch_rec)


def test_scannet_driver_matches_jax(tmp_path, monkeypatch, jax_weights):
    argv = COMMON + ["dataset=synthetic_scannet_hard", "+render_every=0"]
    jax_rec, torch_rec = [], []
    j_errors, t_errors = j_scannet.scannet_batch_errors, t_scannet.scannet_batch_errors

    def jax_errors(f0, f1, d0, d1, K, Rt, num_corr, use_pallas):
        out = j_errors(f0, f1, d0, d1, K, Rt, num_corr=num_corr, use_pallas=use_pallas)
        jax_rec.append((np.asarray(out[4]), _pixel_index(out[2], d0.shape[2])))
        return out

    def torch_errors(f0, f1, d0, d1, K, Rt, num_corr):
        out = t_errors(f0, f1, d0, d1, K, Rt, num_corr=num_corr)
        torch_rec.append((out[4].numpy(), _pixel_index(out[2].numpy(), d0.shape[2])))
        return out

    monkeypatch.setattr(j_scannet, "scannet_batch_errors", jax_errors)
    monkeypatch.setattr(t_scannet, "scannet_batch_errors", torch_errors)
    with F32:
        j_scannet.run(j_compose("scannet_correspondence",
                                argv + [f"output_dir={tmp_path / 'jax'}"]))
    out = t_scannet.entry(argv + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])
    assert out["err_3d"].shape == out["valid"].shape == (8, 100)
    assert len(jax_rec) == len(torch_rec) == 2
    _compare(tmp_path, "scannet_correspondence_final.csv", jax_rec, torch_rec)
    with pytest.raises(NotImplementedError, match="render_every"):
        t_scannet.entry([a for a in argv if "render_every" not in a]
                        + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])
