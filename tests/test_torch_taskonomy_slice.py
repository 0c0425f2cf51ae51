"""The Taskonomy slice end to end: the port's ``train_taskonomy`` against
the repository's JAX ``train_taskonomy.run`` on the synthetic fallback
(``backbone=test_tiny dataset=taskonomy probe=taskonomy_dpt``, principal
curvature, one epoch at batch 8), with the JAX-initialised backbone and
probe carried across by ``convert.from_jax``.

The synthetic reader's items are a pure function of (seed, index), so the
init draw of both ``fit``s (2-4 batches, set by thread timing) leaves the
epoch's items as they are: the reader state is pinned by construction.

Per-step losses within rtol 1e-4. The CSV row within atol 1e-4 where the
port's ``is_eval`` branch validates the probe that the JAX run trained
(written into the port's checkpoint), and within atol 1e-3 end to end. The
end-to-end gap is AdamW's: its first steps move a weight by about the step
size whatever the size of its gradient, so gradients near zero that differ
in the last bits move weights apart. At ``probe_lr=0`` the two packages'
predictions agree to 1.2e-6 of their largest; after the two steps the
curvature predictions differ by up to 6.5e-4 (of ~8.8), and the pixels
whose prediction sits near 0 or a ratio threshold move the δ columns by up
to 1.3e-4. f32 everywhere, the JAX side under
``jax.default_matmul_precision("float32")`` on one device."""

import copy
import csv

import jax
import numpy as np
import pytest

import train_taskonomy as j_driver
from midvision_probe_torch import train_taskonomy as t_driver
from midvision_probe_torch.convert.from_jax import trainer_state_dict, vit_state_dict
from midvision_probe_torch.engine import probe_fit as t_probe_fit
from midvision_probe_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.engine import probe_fit as j_probe_fit
from midvision_probe_tpu.models import zoo as j_zoo

F32 = jax.default_matmul_precision("float32")
ARGV = ["backbone=test_tiny", "dataset=taskonomy", "probe=taskonomy_dpt",
        "+probe.hidden_dim=32", "optimizer=one_epoch", "batch_size=8",
        "dataset.task=principal_curvature", "+dataset.num_instances=16"]
CSV_NAME = "taskonomy_results_principal_curvature_final.csv"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def _assert_csv_close(jcsv_path, tcsv_path, jrow, atol):
    jcsv, tcsv = _read_csv(jcsv_path), _read_csv(tcsv_path)
    assert list(tcsv) == list(jcsv)
    for k, v in jcsv.items():
        if k in jrow:
            np.testing.assert_allclose(float(tcsv[k]), float(v), atol=atol, rtol=0, err_msg=k)
        else:
            assert tcsv[k] == v, k


def test_train_taskonomy_slice_matches_jax(tmp_path, monkeypatch):
    init_state, trained_state, jax_losses = {}, {}, []
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
            trained_state.update(params=_np_tree(st.params), stats=_np_tree(st.batch_stats))
            return st, loss

        return wrapped

    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "init", capture_init)
    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "_make_train_step", capture_losses)
    with F32:
        jrow = j_driver.run(j_compose("taskonomy_training", ARGV + [
            "system.num_devices=1", f"output_dir={tmp_path / 'jax'}"]))
    # pred_type vanilla: the raw decoder output, no BatchNorm
    assert "batch_norm" not in init_state["params"]["probe"]

    jvars = _np_tree(j_zoo.build_vit_extractor(
        "test_tiny_vit", return_multilayer=True, add_norm=True).variables)

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
    trow = t_driver.entry(ARGV + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])

    losses = trow.pop("train_losses")
    assert len(losses) == len(jax_losses) == 2  # 16 items at batch 8
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert list(trow) == list(jrow)
    assert {"AbsRel", "δ1.25_k1", "δ3.75_avg"} <= set(trow)
    for k, v in jrow.items():
        np.testing.assert_allclose(trow[k], v, atol=1e-3, rtol=0, err_msg=k)
        if k != "AbsRel":
            assert 0.0 <= trow[k] <= 1.0, k
    _assert_csv_close(tmp_path / "jax" / CSV_NAME, tmp_path / "torch" / CSV_NAME, jrow, 1e-3)

    # the JAX-trained probe through the port's is_eval branch
    ckpt_dirs = list((tmp_path / "torch").glob("*/ckpt"))
    assert len(ckpt_dirs) == 1
    state, epoch = restore_checkpoint(str(ckpt_dirs[0]))
    state["modules"] = trainer_state_dict(trained_state["params"], trained_state["stats"])
    save_checkpoint(str(ckpt_dirs[0]), state, epoch)
    (tmp_path / "torch" / CSV_NAME).unlink()
    erow = t_driver.entry(ARGV + ["+system.device=cpu", "is_eval=True",
                                  f"output_dir={tmp_path / 'torch'}"])
    assert erow.pop("train_losses") == []
    assert list(erow) == list(jrow)
    for k, v in jrow.items():
        np.testing.assert_allclose(erow[k], v, atol=1e-4, rtol=0, err_msg=k)
    _assert_csv_close(tmp_path / "jax" / CSV_NAME, tmp_path / "torch" / CSV_NAME, jrow, 1e-4)


@pytest.mark.parametrize("task,keys", [
    ("reshading", {"AbsRel", "δ_1.1", "δ_1.2100000000000002", "δ_1.3310000000000004"}),
    ("depth", {"masked_l1"}),
])
def test_train_taskonomy_other_tasks_match_jax_columns(tmp_path, task, keys):
    """The reshading and masked-L1 metric branches: the port's row has the
    JAX driver's columns, in its order."""
    argv = [a for a in ARGV if not a.startswith("dataset.task")] + [f"dataset.task={task}"]
    with F32:
        jrow = j_driver.run(j_compose("taskonomy_training", argv + [
            "system.num_devices=1", f"output_dir={tmp_path / 'jax'}"]))
    trow = t_driver.entry(argv + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])
    assert len(trow.pop("train_losses")) == 2
    assert list(trow) == list(jrow)
    assert set(trow) == keys
    assert all(np.isfinite(v) for v in trow.values())


def test_train_taskonomy_is_eval_restores_and_cache_raises(tmp_path):
    """A second run with is_eval=True restores the saved probe and
    reproduces the trained run's metrics exactly; with the feature cache
    (``system.cache_features``) the driver trains its two steps on the
    cached bf16 features and writes finite metrics with the same keys."""
    argv = ARGV + ["+system.device=cpu", f"output_dir={tmp_path}"]
    trained = t_driver.entry(argv)
    restored = t_driver.entry(argv + ["is_eval=True"])
    assert restored.pop("train_losses") == []
    assert len(trained.pop("train_losses")) == 2
    assert restored == trained
    cached = t_driver.entry(argv + ["system.cache_features=True",
                                    f"output_dir={tmp_path / 'cached'}"])
    assert len(cached.pop("train_losses")) == 2
    assert set(cached) == set(trained) and all(np.isfinite(v) for v in cached.values())
