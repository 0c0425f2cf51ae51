"""The ViT generic attention slice end to end: the NAVI correspondence
driver with ``backbone=crocov2_b16`` and ``train_depth`` with
``backbone=radio``, each port driver against the repository's JAX driver
on the same config, with the JAX-initialised weights carried across.

Both packages' ``ZOO["crocov2_vitb16"]`` and ``ZOO["radio_v2"]`` are
monkeypatched to tiny configs of the same shape: CroCo-v2 (2D RoPE, no cls
token, no table, ``fixed_input=32``, so every 64x64 view is resized to
32x32 and runs at a 4x4 grid) and RADIO-v2 (head dim 80, a patch-only 4x4
table resized to the input grid, final norm). Depth 4, so that the four
default taps (``depth//4 - 1``, ...) are the blocks 0-3. The configs under
``configs/backbone/`` are read as they are. The JAX side runs under
``jax.default_matmul_precision("float32")``; the tolerances are those of
``test_torch_geometric_slice.py`` and ``test_torch_train.py``."""

import copy
import csv
import dataclasses

import jax
import numpy as np
import pytest
import torch

import evaluate_navi_correspondence as j_navi
import train_depth as j_train_depth
from midvision_probe_torch import evaluate_navi_correspondence as t_navi
from midvision_probe_torch import train_depth as t_train_depth
from midvision_probe_torch.convert.from_jax import trainer_state_dict, vit_state_dict
from midvision_probe_torch.engine import probe_fit as t_probe_fit
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_torch.utils import correspondence as tc
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.engine import probe_fit as j_probe_fit
from midvision_probe_tpu.models import zoo as j_zoo
from midvision_probe_tpu.utils import correspondence as jc

F32 = jax.default_matmul_precision("float32")

TINY = {
    "crocov2_vitb16": dict(vit=dict(patch_size=8, width=32, depth=4, num_heads=2,
                                    class_token=False, pos_embed="none", rope=True),
                           fixed_input=32),
    "radio_v2": dict(vit=dict(patch_size=8, width=160, depth=4, num_heads=2,
                              final_norm=True, pos_embed_cls=False, table_grid=(4, 4))),
}


def _tiny_backbone(monkeypatch, name, **build_kw):
    """Patch both zoos' ``name`` to its tiny config and make the port load
    the JAX package's random init of it; returns nothing."""
    for zoo in (j_zoo, t_zoo):
        monkeypatch.setitem(zoo.ZOO, name, dataclasses.replace(zoo.ZOO[name], **TINY[name]))
    jvars = jax.tree_util.tree_map(
        np.asarray, j_zoo.build_vit_extractor(name, **build_kw).variables)

    def load_jax_vit(module, seed=0):
        module.load_state_dict(vit_state_dict(jvars))
        return module

    monkeypatch.setattr(t_zoo, "random_init", load_jax_vit)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def _pixel_index(uv, width):
    """Pixel-center (u, v) coordinates -> flat pixel indices."""
    uv = np.asarray(uv)
    return np.floor(uv[..., 1]).astype(int) * width + np.floor(uv[..., 0]).astype(int)


def test_navi_driver_on_crocov2_matches_jax(tmp_path, monkeypatch):
    """CSV recalls within 0.5 percentage points (one flipped match of 800
    is 0.125), the other columns equal, equal ``valid`` masks, and the
    selected query pixels of each pair the same on at least 99% of valid
    rows (compared as sets: ratio weights that tie to ~1e-7 swap ranks)."""
    _tiny_backbone(monkeypatch, "crocov2_vitb16", output="dense")
    argv = ["backbone=crocov2_b16", "dataset=synthetic_navi_hard",
            "dataset.num_instances=8", "num_corr=100", "scale_factor=0.25",
            "batch_pairs=4"]
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
        j_navi.run(j_compose("navi_correspondence", argv + [f"output_dir={tmp_path / 'jax'}"]))
    out = t_navi.entry(argv + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])
    assert out["err_3d"].shape == out["valid"].shape == (8, 100)
    assert out["valid"].sum() > 0

    jrow = _read_csv(tmp_path / "jax" / "navi_correspondence_final.csv")
    trow = _read_csv(tmp_path / "torch" / "navi_correspondence_final.csv")
    assert list(trow) == list(jrow)
    recall_cols = [k for k in jrow if "Rec" in k]
    assert len(recall_cols) >= 10
    for k in recall_cols:
        j, t = float(jrow[k]), float(trow[k])
        assert (np.isnan(j) and np.isnan(t)) or abs(j - t) <= 0.5, (k, j, t)
    for k in jrow:
        if k not in recall_cols and k != "Time":
            assert trow[k] == jrow[k], k
    assert len(jax_rec) == len(torch_rec) == 2
    j_valid = np.concatenate([v for v, _ in jax_rec])
    np.testing.assert_array_equal(np.concatenate([v for v, _ in torch_rec]), j_valid)
    j_sel = np.concatenate([s for _, s in jax_rec])
    t_sel = np.concatenate([s for _, s in torch_rec])
    shared = sum(len(set(j[v]) & set(t[v])) for j, t, v in zip(j_sel, t_sel, j_valid))
    assert shared >= 0.99 * j_valid.sum(), (shared, j_valid.sum())


def test_train_depth_on_radio_matches_jax(tmp_path, monkeypatch):
    """Per-step losses to rtol 1e-4 and the CSV row's depth metrics to atol
    1e-3 (f32; after two AdamW steps the gap is summation order amplified
    by Adam's normalised update)."""
    _tiny_backbone(monkeypatch, "radio_v2", return_multilayer=True)
    argv = ["backbone=radio", "dataset=synthetic", "probe=depth_dpt",
            "probe.hidden_dim=64", "optimizer=one_epoch", "batch_size=8",
            "dataset.num_instances=16", "+render_images=False"]
    init_state, jax_losses = {}, []
    j_init, j_make_step = j_probe_fit.ProbeTrainer.init, j_probe_fit.ProbeTrainer._make_train_step

    def capture_init(self, batch):
        st = j_init(self, batch)
        init_state.update(params=jax.tree_util.tree_map(np.asarray, st.params),
                          stats=jax.tree_util.tree_map(np.asarray, st.batch_stats))
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
        jrow = j_train_depth.run(j_compose(
            "depth_training", argv + ["system.num_devices=1", f"output_dir={tmp_path / 'jax'}"]))

    t_init = t_probe_fit.ProbeTrainer.init

    def load_jax_probe(self):
        t_init(self)
        self.modules.load_state_dict(copy.deepcopy(trainer_state_dict(
            init_state["params"], init_state["stats"])))

    monkeypatch.setattr(t_probe_fit.ProbeTrainer, "init", load_jax_probe)
    trow = t_train_depth.entry(argv + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])

    losses = trow.pop("train_losses")
    assert len(losses) == len(jax_losses) == 2
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert set(trow) == set(jrow)
    for k, v in jrow.items():
        if k.startswith(("sa_", "si_")):
            np.testing.assert_allclose(trow[k], v, atol=1e-3, rtol=1e-3, err_msg=k)
        else:
            assert trow[k] == v, k
    assert (tmp_path / "torch" / "depth_results_synthetic_final.csv").exists()


@pytest.mark.parametrize("backbone", ["crocov2_b16", "radio"])
def test_backbone_configs_instantiate_through_the_port(backbone):
    """``configs/backbone/{crocov2_b16,radio}.yaml`` name the JAX package's
    constructors; the port's ``_target_`` rewrite reaches its own."""
    from midvision_probe_torch.config import compose, instantiate

    cfg = compose("navi_correspondence", [f"backbone={backbone}"])
    with torch.device("meta"):
        ext = instantiate(cfg.backbone, output="dense", device="meta")
    assert ext.checkpoint_name == cfg.backbone.checkpoint_name
