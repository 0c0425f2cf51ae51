"""The SAM and ConvNeXt depth slices end to end: the port's ``train_depth``
against the repository's JAX ``train_depth.run`` on ``dataset=synthetic
probe=depth_dpt`` (64x64, one epoch) with ``backbone=clip_convnext`` (stage
widths 8-32, one block a stage; the open_clip ``visual.trunk.`` prefix and
OpenAI mean/std) and ``backbone=convnext_fcmae`` (the same widths, GRN) here,
and ``backbone=sam_base`` (the preset narrowed in both packages to width 32
and 4 blocks, 1 and 3 global, so every block is tapped) in
``test_torch_sam_slice.py`` (its own file: the JAX side's compilation takes
most of its time, and the files run on separate workers), the
trunk loaded by both zoos from one fabricated file in the source's naming
under a temporary ``$MVP_CHECKPOINT_DIR``, the JAX probe init carried
across. Per-step losses within 1e-4 relative, the CSV row within 1e-4 and
its columns in the JAX order, with two kinds of metric within 1e-3: the
shares of pixels under a ratio threshold (``*_d1``/``d2``/``d3``: a pixel
at a threshold may fall either side in float32) and the scale-invariant
``si_*`` ones (their least-squares scale and shift are fitted to a
prediction whose variance is ~0.008 after two steps, which amplifies
float32 rounding; the scale-aware ``sa_*`` ones agree within 2e-6); the
port never random-initialises. The JAX side runs under
``jax.default_matmul_precision("float32")`` on one device."""

import copy
import csv
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

import train_depth as j_train_depth
from midvision_probe_torch import train_depth as t_train_depth
from midvision_probe_torch.convert.from_jax import trainer_state_dict
from midvision_probe_torch.engine import probe_fit as t_probe_fit
from midvision_probe_torch.models import convnext as t_convnext
from midvision_probe_torch.models import vit_sam as t_sam
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.engine import probe_fit as j_probe_fit
from midvision_probe_tpu.models import convnext as j_convnext
from midvision_probe_tpu.models import vit_sam as j_sam

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_convnext import _openclip, _timm_container  # noqa: E402
from test_torch_sam import sam_container  # noqa: E402

F32 = jax.default_matmul_precision("float32")
ARGV = ["dataset=synthetic", "probe=depth_dpt", "probe.hidden_dim=32",
        "optimizer=one_epoch", "batch_size=8", "dataset.num_instances=16"]
SAM_PRESET = dict(width=32, depth=4, num_heads=2, global_attn_indexes=(1, 3))
CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def _atol(key: str) -> float:
    return 1e-3 if key.startswith("si_") or key.endswith(("_d1", "_d2", "_d3")) else 1e-4


def _fabricate(config, ckpt_dir, monkeypatch):
    """Narrow the architecture in both packages and write its file."""
    if config == "sam_base":
        for mod in (t_sam, j_sam):
            monkeypatch.setitem(mod.SAM_PRESETS, "vit_b", SAM_PRESET)
        sd = sam_container(32, 4, 2, (1, 3), seed=4)
        return sd, "sam_vit_b", [(4, 4, 32)] * 4
    for mod in (t_convnext, j_convnext):
        monkeypatch.setattr(mod, "ConvNeXtConfig",
                            functools.partial(mod.ConvNeXtConfig, **CONVNEXT))
    taps = [(4, 4, d) for d in CONVNEXT["dims"]]
    if config == "convnext_fcmae":  # timm ConvNeXt-v2 naming, GRN
        return _timm_container(6, use_grn=True, arch=CONVNEXT), "cnxt_b_fcmae", taps
    return _openclip(_timm_container(6, arch=CONVNEXT)), "cnxt_b_w_laion2b", taps


@pytest.mark.parametrize("config", ["clip_convnext", "convnext_fcmae"])
def test_train_depth_slice_matches_jax(tmp_path, monkeypatch, config):
    run_slice(tmp_path, monkeypatch, config)


def run_slice(tmp_path, monkeypatch, config):
    """Both drivers on ``config`` from one fabricated file; the rows compared."""
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    sd, entry, tap_shapes = _fabricate(config, ckpt_dir, monkeypatch)
    torch.save(sd, ckpt_dir / t_zoo.ZOO[entry].filename)
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(ckpt_dir))
    argv = [f"backbone={config}"] + ARGV

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
        jrow = j_train_depth.run(j_compose("depth_training", argv + [
            "system.num_devices=1", f"output_dir={tmp_path / 'jax'}"]))
    assert taps == tap_shapes

    def no_random_init(*a, **k):
        raise AssertionError("random init ran although a checkpoint is present")

    t_init = t_probe_fit.ProbeTrainer.init

    def load_jax_probe(self):
        t_init(self)
        self.modules.load_state_dict(copy.deepcopy(trainer_state_dict(
            init_state["params"], init_state["stats"])))

    monkeypatch.setattr(t_zoo, "random_init", no_random_init)
    monkeypatch.setattr(t_probe_fit.ProbeTrainer, "init", load_jax_probe)
    trow = t_train_depth.entry(argv + ["+system.device=cpu",
                                       f"output_dir={tmp_path / 'torch'}"])

    losses = trow.pop("train_losses")
    assert len(losses) == len(jax_losses) == 2
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert set(trow) == set(jrow)
    for k, v in jrow.items():
        np.testing.assert_allclose(trow[k], v, atol=_atol(k), rtol=1e-4, err_msg=k)
    name = "depth_results_synthetic_final.csv"
    jcsv, tcsv = _read_csv(tmp_path / "jax" / name), _read_csv(tmp_path / "torch" / name)
    assert list(tcsv) == list(jcsv)
    assert tcsv["checkpoint"] == jcsv["checkpoint"] == entry
    for k, v in jcsv.items():
        if k in jrow:
            np.testing.assert_allclose(float(tcsv[k]), float(v), atol=_atol(k), rtol=1e-4,
                                       err_msg=k)
        elif k != "exp_name":
            assert tcsv[k] == v, k
