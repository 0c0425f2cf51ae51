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
import jax.numpy as jnp
import numpy as np
import torch

import train_depth as j_train_depth
from midvision_probe_torch import train_depth as t_train_depth
from midvision_probe_torch.convert.from_jax import trainer_state_dict
from midvision_probe_torch.engine import probe_fit as t_probe_fit
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.config import instantiate as j_instantiate
from midvision_probe_tpu.datasets import build_loader as j_build_loader
from midvision_probe_tpu.engine import probe_fit as j_probe_fit
from midvision_probe_tpu.engine.driver_common import cache_shuffle_kwargs

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


LINEAR_ARGV = ["backbone=simclr_resnet50", "dataset=synthetic", "probe=depth_linear",
               "+backbone.return_multilayer=True", "optimizer=one_epoch",
               "batch_size=8", "dataset.num_instances=16",
               "system.cache_features=true", "+render_images=False"]


def test_cached_depth_linear_on_resnet50_matches_jax(tmp_path, monkeypatch):
    """F7's path through the driver: ``probe=depth_linear`` on SimCLR's four stage
    taps (16x16, 8x8, 4x4, 2x2 at 64x64) with the feature cache, so the
    ``Linear`` head resizes bf16 taps of four grids. The port's extractor
    returns the bf16 features the JAX cache trained on, and the JAX
    backbone's for the test batches (the backbones' float32 parity is the
    test above). Two batches of one epoch: per-step losses within 1e-4
    relative (read: 1.2e-6); the CSV's scale-aware columns within 1e-3
    (read: 1.2e-4, ``sa_level_2_d1``, one pixel of a thresholded recall)
    and its scale-invariant ones within 1e-2 (read: 4.1e-3,
    ``si_level_1_d1``: after two steps the linear probe's predictions are
    nearly constant, and the per-image scale fit amplifies float32
    differences). This is a plumbing check of the driver, the cache and
    the trainer, not a check of F7: the old port, which resized these taps
    in float32, reads 1.4e-6 and the same CSV gaps here, and the first
    step's prediction, from the same init and taps, reads 1.2e-5 of
    max|ref| (3.3e-6 mean) in both; the bindepth reduction of a
    random-init probe hides the taps' rounding. F7 is checked by
    ``tests/test_torch_probe_dtype.py``."""
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    torch.save(wrap_vissl(TorchResNet50(seed=7).state_dict()),
               ckpt_dir / t_zoo.ZOO["simclr_resnet50"].filename)
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(ckpt_dir))

    init_state, jax_losses = {}, []
    j_init, j_make_step = j_probe_fit.ProbeTrainer.init, j_probe_fit.ProbeTrainer._make_train_step

    def capture_init(self, batch):
        st = j_init(self, batch)
        init_state.update(params=_np_tree(st.params), stats=_np_tree(st.batch_stats))
        return st

    def capture_losses(self, cached):
        assert cached
        step = j_make_step(self, cached)

        def wrapped(*args):
            st, loss = step(*args)
            jax_losses.append(float(loss))
            return st, loss

        return wrapped

    # the bf16 features the JAX cache trained on, by batch
    j_extract, extracted = j_probe_fit.ProbeTrainer._extract, {}

    def capture_extract(self, images):
        feats = j_extract(self, images)
        extracted[np.asarray(images).tobytes()] = [np.asarray(f.astype(jnp.float32))
                                                   for f in feats]
        return feats

    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "init", capture_init)
    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "_make_train_step", capture_losses)
    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "_extract", capture_extract)
    jcfg = j_compose("depth_training", LINEAR_ARGV + ["system.num_devices=1",
                                                      f"output_dir={tmp_path / 'jax'}"])
    with F32:
        jrow = j_train_depth.run(jcfg)

    # the taps of every batch the port will see: the training batches' as
    # the JAX cache held them, the test batches' from the JAX backbone
    jext = j_instantiate(jcfg.backbone)
    jax_apply = jax.jit(jext._apply_fn)
    jax_maps = {}
    for batch in j_build_loader(jcfg.dataset, "test", 8):
        with F32:
            maps = jax_apply(jext.variables, batch["image"])[0]
        jax_maps[batch["image"].tobytes()] = [np.array(m) for m in maps]
    jax_maps.update(extracted)
    assert [m.shape[1:3] for m in next(iter(jax_maps.values()))] == [(16, 16), (8, 8),
                                                                     (4, 4), (2, 2)]
    t_build, t_init = t_train_depth.build_backbone, t_probe_fit.ProbeTrainer.init

    def jax_features(cfg, needs_multilayer):
        ext = t_build(cfg, needs_multilayer)

        def apply_fn(images):
            maps = jax_maps[images.numpy().tobytes()]
            return [torch.from_numpy(m) for m in maps], [None] * len(maps)

        ext._apply_fn = apply_fn
        return ext

    def load_jax_probe(self):
        t_init(self)
        self.modules.load_state_dict(copy.deepcopy(trainer_state_dict(
            init_state["params"], init_state["stats"])))

    monkeypatch.setattr(t_train_depth, "build_backbone", jax_features)
    monkeypatch.setattr(t_probe_fit.ProbeTrainer, "init", load_jax_probe)
    trow = t_train_depth.entry(LINEAR_ARGV + ["+system.device=cpu",
                                              f"output_dir={tmp_path / 'torch'}"])

    losses = trow.pop("train_losses")
    assert len(losses) == len(jax_losses) == 2
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    name = "depth_results_synthetic_final.csv"
    jcsv, tcsv = _read_csv(tmp_path / "jax" / name), _read_csv(tmp_path / "torch" / name)
    assert list(tcsv) == list(jcsv)
    for k, v in jcsv.items():
        if k in jrow:
            tol = 1e-3 if k.startswith("sa_") else 1e-2
            np.testing.assert_allclose(float(tcsv[k]), float(v), atol=tol, rtol=tol, err_msg=k)
        elif k != "exp_name":
            assert tcsv[k] == v, k
