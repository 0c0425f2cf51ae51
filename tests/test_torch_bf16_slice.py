"""``train_depth`` with the sweep's three bf16 settings
(``launch_script/sweep.py:94-99``: ``system.cache_features=true``,
``system.backbone_dtype=bfloat16``, ``system.probe_dtype=bfloat16``) in
both packages, on test_tiny with synthetic data, the DPT probe narrowed to
32 hidden channels, two epochs of three batches, the JAX probe init
carried across: fault F8's driver check.

The port's extractor returns the JAX bf16 backbone's features of each
batch (its forward still counted), so the run holds the probe's bf16
dtype flow, the loss and the training; the bf16 backbone's parity is the
other tests' subject.

F8 is checked on the first step's prediction, the trainer's own forward
from the same probe init on the same bf16 taps, before any update: its
mean error relative to the mean |ref| (the statistic of
``tests/test_torch_probe_dtype.py``) is held to 1.5e-3. Read: 9.7e-4;
the old autocast probe, which reduced in float32, reads 2.2e-3 here.
The maximum errors do not separate the two (7.7e-3 and 7.9e-3 of
max|ref|: one-ulp bf16 flips where the frameworks' float32 accumulation
orders differ, which bindepth's bf16 channel sum spreads over a pixel).
After training, per-step losses within 1e-3 relative (read: 2.5e-4) and
the CSV column for column within 1e-2, rtol and atol (read: 4.1e-3 at
most, ``si_level_1_d1``; the thresholded per-level recalls of a
12-image set move by whole pixels): those flips move the six AdamW
steps' updates. These two bars are the driver's plumbing check and do
not separate the repair from the old probe (3.4e-4 and 2.7e-3 there).
The JAX side runs under ``jax.default_matmul_precision("float32")`` on
one device."""

import copy
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_depth as j_train_depth
from midvision_probe_torch import train_depth as t_train_depth
from midvision_probe_torch.convert.from_jax import trainer_state_dict, vit_state_dict
from midvision_probe_torch.engine import probe_fit as t_probe_fit
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.datasets import build_loader as j_build_loader
from midvision_probe_tpu.engine import probe_fit as j_probe_fit
from midvision_probe_tpu.engine.driver_common import cache_shuffle_kwargs
from midvision_probe_tpu.models import zoo as j_zoo

F32 = jax.default_matmul_precision("float32")
ARGV = ["backbone=test_tiny", "dataset=synthetic", "probe=depth_dpt", "probe.hidden_dim=32",
        "optimizer=one_epoch", "optimizer.n_epochs=2", "batch_size=4",
        "dataset.num_instances=12", "+render_images=False", "system.cache_features=true",
        "system.backbone_dtype=bfloat16", "system.probe_dtype=bfloat16"]
CSV_NAME = "depth_results_synthetic_final.csv"
TOL = 1e-2
FIRST_PRED_LIMIT = 1.5e-3


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def test_bf16_preset_train_depth_matches_jax(tmp_path, monkeypatch, one_torch_thread):
    jvars = _np_tree(j_zoo.build_vit_extractor(
        "test_tiny_vit", return_multilayer=True, add_norm=True).variables)
    init_state, jax_losses, first_pred = {}, [], {}
    j_init, j_make_step = j_probe_fit.ProbeTrainer.init, j_probe_fit.ProbeTrainer._make_train_step

    def capture_init(self, batch):
        st = j_init(self, batch)
        init_state.update(params=_np_tree(st.params), stats=_np_tree(st.batch_stats))
        return st

    def capture_losses(self, cached):
        step = j_make_step(self, cached)
        forward = jax.jit(lambda s, f: self._forward(s.params, s.batch_stats, None,
                                                     train=True, feats=f)[0])

        def wrapped(*args):
            if "jax" not in first_pred:  # the first step's, before any update
                first_pred["jax"] = np.asarray(forward(args[0], args[3]).astype(jnp.float32))
            st, loss = step(*args)
            jax_losses.append(float(loss))
            return st, loss

        return wrapped

    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "init", capture_init)
    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "_make_train_step", capture_losses)
    with F32:
        jrow = j_train_depth.run(j_compose("depth_training", ARGV + [
            "system.num_devices=1", f"output_dir={tmp_path / 'jax'}"]))

    # the JAX bf16 backbone's taps of every batch the port will see
    jax_maps = {}
    jext = j_zoo.build_vit_extractor("test_tiny_vit", return_multilayer=True, add_norm=True,
                                     dtype=jnp.bfloat16)
    jax_apply = jax.jit(jext._apply_fn)
    jcfg = j_compose("depth_training", ARGV)
    for split in ("trainval", "test"):
        kw = cache_shuffle_kwargs(jcfg) if split == "trainval" else {}
        for batch in j_build_loader(jcfg.dataset, split, 4, seed=8, **kw):
            with F32:
                maps = jax_apply(jext.variables, batch["image"])[0]
            assert maps[0].dtype == jnp.bfloat16
            jax_maps[batch["image"].tobytes()] = [np.asarray(m.astype(jnp.float32))
                                                  for m in maps]

    def load_jax_vit(module, seed=0):
        module.load_state_dict(vit_state_dict(jvars))
        return module

    t_build, t_init = t_train_depth.build_backbone, t_probe_fit.ProbeTrainer.init
    t_forward = t_probe_fit.ProbeTrainer._forward

    def jax_features(cfg, needs_multilayer):
        ext = t_build(cfg, needs_multilayer)

        def apply_fn(images):
            maps = jax_maps[images.float().numpy().tobytes()]
            return [torch.from_numpy(m).bfloat16() for m in maps], [None] * len(maps)

        ext._apply_fn = apply_fn
        return ext

    def load_jax_probe(self):
        t_init(self)
        self.modules.load_state_dict(copy.deepcopy(trainer_state_dict(
            init_state["params"], init_state["stats"])))

    def capture_forward(self, feats, train):
        pred = t_forward(self, feats, train)
        if train and "torch" not in first_pred:
            first_pred["torch"] = pred.detach().float().numpy()
        return pred

    monkeypatch.setattr(t_zoo, "random_init", load_jax_vit)
    monkeypatch.setattr(t_probe_fit.ProbeTrainer, "_forward", capture_forward)
    monkeypatch.setattr(t_train_depth, "build_backbone", jax_features)
    monkeypatch.setattr(t_probe_fit.ProbeTrainer, "init", load_jax_probe)
    trow = t_train_depth.entry(ARGV + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])

    # the first step's prediction, from the same probe init and taps: F8's check
    want = first_pred["jax"]
    err = np.abs(first_pred["torch"] - want).mean() / np.abs(want).mean()
    assert err <= FIRST_PRED_LIMIT, err
    losses = trow.pop("train_losses")
    assert len(losses) == len(jax_losses) == 6
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-3)
    jcsv, tcsv = _read_csv(tmp_path / "jax" / CSV_NAME), _read_csv(tmp_path / "torch" / CSV_NAME)
    assert list(tcsv) == list(jcsv)
    for k, v in jcsv.items():
        if k in jrow:
            np.testing.assert_allclose(float(tcsv[k]), float(v), rtol=TOL, atol=TOL, err_msg=k)
        elif k != "exp_name":
            assert tcsv[k] == v, k
