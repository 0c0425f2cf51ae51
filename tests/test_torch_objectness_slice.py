"""The objectness slice end to end: the port's ``train_generic_objectness``
against the repository's JAX ``train_generic_objectness.run`` on the JAX
e2e oracle's config (``tests/test_train_others_e2e.py``:
``backbone=test_tiny dataset=synthetic_voc probe=binaryhead``), with the
JAX-initialised backbone and probe (the BinaryHead's BatchNorm statistics
included) carried across by ``convert.from_jax``.

Per-step losses within rtol 1e-4, the CSV row's metrics within atol 1e-3
(f32 everywhere, the JAX side under
``jax.default_matmul_precision("float32")`` on one device)."""

import copy
import csv

import jax
import numpy as np

import train_generic_objectness as j_driver
from midvision_probe_torch import train_generic_objectness as t_driver
from midvision_probe_torch.convert.from_jax import trainer_state_dict, vit_state_dict
from midvision_probe_torch.engine import probe_fit as t_probe_fit
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.engine import probe_fit as j_probe_fit
from midvision_probe_tpu.models import zoo as j_zoo

F32 = jax.default_matmul_precision("float32")
ARGV = ["backbone=test_tiny", "dataset=synthetic_voc", "probe=binaryhead",
        "+probe.hidden_dim=32", "optimizer=one_epoch", "batch_size=4",
        "dataset.num_instances=10", "+backbone.return_multilayer=True"]
CSV_NAME = "final_results_summary_synthetic_voc.csv"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def test_train_objectness_slice_matches_jax(tmp_path, monkeypatch):
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
        jrow = j_driver.run(j_compose("objectness_train", ARGV + [
            "system.num_devices=1", f"output_dir={tmp_path / 'jax'}"]))
    assert "batch_norm" in init_state["stats"]["probe"]

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
    assert len(losses) == len(jax_losses) == 2  # 8 of 10 items train, batch 4
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert list(trow) == list(jrow) == ["F-measure", "IoU", "Accuracy", "CorLoc"]
    for k, v in jrow.items():
        assert 0.0 <= trow[k] <= 1.0, k
        np.testing.assert_allclose(trow[k], v, atol=1e-3, rtol=0, err_msg=k)
    jcsv = _read_csv(tmp_path / "jax" / CSV_NAME)
    tcsv = _read_csv(tmp_path / "torch" / CSV_NAME)
    assert list(tcsv) == list(jcsv)
    for k, v in jcsv.items():
        if k in jrow:
            np.testing.assert_allclose(float(tcsv[k]), float(v), atol=1e-3, rtol=0, err_msg=k)
        else:
            assert tcsv[k] == v, k


def test_train_objectness_is_eval_restores_and_cache_raises(tmp_path):
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
