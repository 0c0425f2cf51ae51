"""The ResNet-50 depth slice end to end: the port's ``train_depth`` against
the repository's JAX ``train_depth.run`` on ``backbone=simclr_resnet50
dataset=synthetic probe=depth_dpt`` at 64x64 (taps at 16x16, 8x8, 4x4 and
2x2), one epoch, SimCLR's trunk loaded by both zoos from one fabricated
VISSL ``simclr_resnet50.torch`` (``data_processing/torch_replicas.py``)
under a temporary ``$MVP_CHECKPOINT_DIR``, the JAX probe init carried
across. Per-step losses within 1e-4 relative, the CSV row within 1e-4; the
port never random-initialises. The JAX side runs under
``jax.default_matmul_precision("float32")`` on one device."""

import copy
import csv
import os
import sys

import jax
import numpy as np
import torch

import train_depth as j_train_depth
from midvision_probe_torch import train_depth as t_train_depth
from midvision_probe_torch.convert.from_jax import trainer_state_dict
from midvision_probe_torch.engine import probe_fit as t_probe_fit
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.engine import probe_fit as j_probe_fit

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "data_processing"))

from torch_replicas import TorchResNet50, wrap_vissl  # noqa: E402

F32 = jax.default_matmul_precision("float32")
ARGV = ["backbone=simclr_resnet50", "dataset=synthetic", "probe=depth_dpt",
        "probe.hidden_dim=64", "optimizer=one_epoch", "batch_size=8",
        "dataset.num_instances=16"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def test_train_depth_resnet50_slice_matches_jax(tmp_path, monkeypatch):
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    torch.save(wrap_vissl(TorchResNet50(seed=7).state_dict()),
               ckpt_dir / t_zoo.ZOO["simclr_resnet50"].filename)
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(ckpt_dir))

    init_state, jax_losses, taps = {}, [], []
    j_init, j_make_step = j_probe_fit.ProbeTrainer.init, j_probe_fit.ProbeTrainer._make_train_step

    def capture_init(self, batch):
        st = j_init(self, batch)
        init_state.update(params=_np_tree(st.params), stats=_np_tree(st.batch_stats))
        taps.extend(tuple(f.shape[1:]) for f in self.backbone.features(batch["image"]))
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
        jrow = j_train_depth.run(j_compose("depth_training", ARGV + [
            "system.num_devices=1", f"output_dir={tmp_path / 'jax'}"]))
    assert taps == [(16, 16, 256), (8, 8, 512), (4, 4, 1024), (2, 2, 2048)]

    def no_random_init(*a, **k):
        raise AssertionError("random init ran although a checkpoint is present")

    t_init = t_probe_fit.ProbeTrainer.init

    def load_jax_probe(self):
        t_init(self)
        self.modules.load_state_dict(copy.deepcopy(trainer_state_dict(
            init_state["params"], init_state["stats"])))

    monkeypatch.setattr(t_zoo, "random_init", no_random_init)
    monkeypatch.setattr(t_probe_fit.ProbeTrainer, "init", load_jax_probe)
    trow = t_train_depth.entry(ARGV + ["+system.device=cpu",
                                       f"output_dir={tmp_path / 'torch'}"])

    losses = trow.pop("train_losses")
    assert len(losses) == len(jax_losses) == 2
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert set(trow) == set(jrow)
    for k, v in jrow.items():
        np.testing.assert_allclose(trow[k], v, atol=1e-4, rtol=1e-4, err_msg=k)
    name = "depth_results_synthetic_final.csv"
    jcsv, tcsv = _read_csv(tmp_path / "jax" / name), _read_csv(tmp_path / "torch" / name)
    assert list(tcsv) == list(jcsv)
    assert tcsv["checkpoint"] == jcsv["checkpoint"] == "simclr_resnet50_dense_[1, 2, 3, 4]"
    for k, v in jcsv.items():
        if k in jrow:
            np.testing.assert_allclose(float(tcsv[k]), float(v), atol=1e-4, rtol=1e-4,
                                       err_msg=k)
        elif k != "exp_name":
            assert tcsv[k] == v, k
