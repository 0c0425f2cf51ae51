"""The surface-normal slice end to end: the port's ``train_snorm`` against
the repository's JAX ``train_snorm.run`` on the same config.

* ``backbone=test_tiny dataset=synthetic probe=snorm_dpt`` (the JAX e2e
  oracle of ``tests/test_train_others_e2e.py``), with the JAX-initialised
  backbone and probe weights carried across by ``convert.from_jax``;
* ``backbone=dino_b16 dataset=nyu probe=snorm_dpt`` on a fabricated NYU
  tree (2 GeoNet train frames, 2 test frames, 480x640) with a fabricated
  DINO-layout checkpoint that both zoos load (their ``dino_vitb16`` entries
  patched to a tiny config of patch 16), so only the probe's init is
  carried across. Augmentation is off here; the augmented run, whose
  reader state both ``fit``s advance by a thread-timed number of batches,
  is held from a pinned reader state in ``test_torch_init_batch.py``, and
  the augmented items item for item in ``test_torch_nyu.py``.

Per-step losses within rtol 1e-4, the CSV row's metrics within atol 1e-3
(f32 everywhere, the JAX side under
``jax.default_matmul_precision("float32")`` on one device)."""

import copy
import csv
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

import train_snorm as j_train_snorm
from midvision_probe_torch import train_snorm as t_train_snorm
from midvision_probe_torch.convert.from_jax import trainer_state_dict, vit_state_dict
from midvision_probe_torch.engine import probe_fit as t_probe_fit
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.engine import probe_fit as j_probe_fit
from midvision_probe_tpu.models import zoo as j_zoo

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "data_processing"))

from test_torch_nyu import make_nyu_tree  # noqa: E402
from torch_replicas import TimmViT  # noqa: E402

F32 = jax.default_matmul_precision("float32")

SYNTHETIC = ["backbone=test_tiny", "dataset=synthetic", "probe=snorm_dpt",
             "probe.hidden_dim=32", "optimizer=one_epoch", "batch_size=8",
             "dataset.num_instances=16", "+render_images=False"]
TINY_DINO = dict(patch_size=16, width=64, depth=4, num_heads=4, mlp_ratio=2.0,
                 table_grid=(3, 3))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def _run_both(tmp_path, monkeypatch, argv, jvars=None):
    """JAX ``train_snorm.run`` then the port's ``entry`` on ``argv``, the
    JAX probe init (and, given ``jvars``, the JAX backbone) carried across.
    Returns (JAX row, JAX losses, port row)."""
    init_state, jax_losses = {}, []
    j_init, j_make_step = j_probe_fit.ProbeTrainer.init, j_probe_fit.ProbeTrainer._make_train_step

    def capture_init(self, batch):
        st = j_init(self, batch)
        init_state.update(params=_np_tree(st.params), stats=_np_tree(st.batch_stats))
        return st

    def capture_losses(self, cached):
        step = j_make_step(self, cached)

        def wrapped(*args):
            st, loss = step(*args)
            jax_losses.append(float(loss))
            return st, loss

        return wrapped

    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "init", capture_init)
    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "_make_train_step", capture_losses)
    with F32:
        jrow = j_train_snorm.run(j_compose(
            "snorm_training", argv + ["system.num_devices=1",
                                      f"output_dir={tmp_path / 'jax'}"]))

    if jvars is not None:
        def load_jax_vit(module, seed=0):
            module.load_state_dict(vit_state_dict(jvars))
            return module

        monkeypatch.setattr(t_zoo, "random_init", load_jax_vit)
    t_init = t_probe_fit.ProbeTrainer.init

    def load_jax_probe(self):
        t_init(self)
        self.modules.load_state_dict(copy.deepcopy(trainer_state_dict(
            init_state["params"], init_state["stats"])))

    monkeypatch.setattr(t_probe_fit.ProbeTrainer, "init", load_jax_probe)
    trow = t_train_snorm.entry(argv + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])
    return jrow, jax_losses, trow


def _assert_rows_close(jrow, jax_losses, trow, n_steps, csv_name, tmp_path):
    losses = trow.pop("train_losses")
    assert len(losses) == len(jax_losses) == n_steps
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert set(trow) == set(jrow)
    assert {"d1", "d2", "d3", "rmse", "level_1_d1", "level_5_rmse"} <= set(trow)
    for k, v in jrow.items():
        np.testing.assert_allclose(trow[k], v, atol=1e-3, rtol=0, err_msg=k)
    jcsv = _read_csv(tmp_path / "jax" / csv_name)
    tcsv = _read_csv(tmp_path / "torch" / csv_name)
    assert list(tcsv) == list(jcsv)
    for k, v in jcsv.items():
        if k in jrow:
            np.testing.assert_allclose(float(tcsv[k]), float(v), atol=1e-3, rtol=0, err_msg=k)
        else:
            assert tcsv[k] == v, k


def test_train_snorm_synthetic_slice_matches_jax(tmp_path, monkeypatch):
    jvars = _np_tree(j_zoo.build_vit_extractor(
        "test_tiny_vit", return_multilayer=True, add_norm=True).variables)
    jrow, jax_losses, trow = _run_both(tmp_path, monkeypatch, SYNTHETIC, jvars)
    assert 0.0 <= trow["d1"] <= trow["d2"] <= trow["d3"] <= 1.0
    assert {"stuff_d1", "things_rmse", "stuff_pixels"} <= set(trow)
    _assert_rows_close(jrow, jax_losses, trow, 2, "snorm_results_synthetic_final.csv",
                       tmp_path)


def test_train_snorm_nyu_slice_with_a_loaded_checkpoint_matches_jax(tmp_path, monkeypatch):
    """The config's NYU dataset (center crop: 480x480, so a 30x30 grid) on
    the fabricated tree; the CSV is ``snorm_results_NYUv2_final.csv``
    whatever the config's ``name``; the port never random-initialises."""
    root = tmp_path / "nyu"
    make_nyu_tree(str(root / "train"), ["bathroom_0001_100", "kitchen_0002_42"], seed=5)
    make_nyu_tree(str(root / "test"), ["nyuv2_test_0", "nyuv2_test_1"], seed=6)
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    torch.save(TimmViT(dim=64, depth=4, heads=4, patch=16, grid=3, mlp_ratio=2.0,
                       seed=21).state_dict(), ckpt_dir / "dino_vitb16.pth")
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(ckpt_dir))
    for zoo in (j_zoo, t_zoo):
        monkeypatch.setitem(zoo.ZOO, "dino_vitb16",
                            dataclasses.replace(zoo.ZOO["dino_vitb16"], vit=TINY_DINO))

    def no_random_init(*a, **k):
        raise AssertionError("random init ran although a checkpoint is present")

    monkeypatch.setattr(t_zoo, "random_init", no_random_init)
    argv = ["backbone=dino_b16", "dataset=nyu", f"dataset.train_path={root / 'train'}",
            f"dataset.test_path={root / 'test'}", "dataset.augment_train=False",
            "probe=snorm_dpt", "probe.hidden_dim=32", "optimizer=one_epoch",
            "batch_size=2", "+render_images=False"]
    jrow, jax_losses, trow = _run_both(tmp_path, monkeypatch, argv)
    assert 0.0 <= trow["d1"] <= trow["d2"] <= trow["d3"] <= 1.0
    assert 0.0 <= trow["rmse"] <= 180.0
    _assert_rows_close(jrow, jax_losses, trow, 1, "snorm_results_NYUv2_final.csv", tmp_path)
    assert [f for f in os.listdir(tmp_path / "torch") if f.endswith(".csv")] == [
        "snorm_results_NYUv2_final.csv"]


def test_train_snorm_is_eval_restores_and_render_images_raises(tmp_path):
    """A second run with is_eval=True restores the saved probe and
    reproduces the trained run's metrics exactly; render_images at its
    default (on) no longer raises: it writes the first test batch's normal
    maps beside the segment scatter."""
    argv = SYNTHETIC + ["probe=snorm_linear", "dataset.num_instances=8",
                        "+system.device=cpu", f"output_dir={tmp_path}"]
    trained = t_train_snorm.entry(argv)
    restored = t_train_snorm.entry(argv + ["is_eval=True"])
    assert restored.pop("train_losses") == []
    assert len(trained.pop("train_losses")) == 1
    assert restored == trained
    rendered = t_train_snorm.entry([a for a in argv if "render_images" not in a]
                                   + ["is_eval=True"])
    rendered.pop("train_losses")
    assert rendered == trained
    (exp_dir,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert sorted(os.listdir(exp_dir / "val_images")) == sorted(
        f"firstbatch_{kind}_{i}.png" for kind in ("pred", "target") for i in range(8))
    # one timestamped scatter per run (runs within a second share a name)
    plots = os.listdir(exp_dir / "plots")
    assert plots and all(p.startswith("segment_area_vs_d1_") and p.endswith(".png")
                         for p in plots)
