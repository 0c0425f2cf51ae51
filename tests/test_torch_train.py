"""The whole ``train_depth`` slice of the PyTorch port against the JAX
package's driver on test_tiny, with the JAX-initialised backbone and probe
weights carried across, and the port's checkpoint resume.

The JAX side runs under ``jax.default_matmul_precision("float32")``."""

import copy
import os

import jax
import numpy as np

import train_depth as jax_train_depth
from midvision_probe_torch import train_depth as t_train_depth
from midvision_probe_torch.convert.from_jax import trainer_state_dict, vit_state_dict
from midvision_probe_torch.engine import probe_fit as t_probe_fit
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.engine import probe_fit as j_probe_fit
from midvision_probe_tpu.models import zoo as j_zoo

F32 = jax.default_matmul_precision("float32")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------- slice
# the depth_dpt probe narrowed to 64 hidden channels to keep the CPU run short
SLICE = ["backbone=test_tiny", "dataset=synthetic", "probe=depth_dpt",
         "probe.hidden_dim=64", "optimizer=one_epoch", "batch_size=8",
         "dataset.num_instances=16", "+render_images=False"]


def test_train_depth_slice_matches_jax(tmp_path, monkeypatch):
    """JAX ``train_depth.run`` and the port's driver on the same config,
    with the JAX-initialised backbone and probe weights carried across:
    per-step losses agree to rtol 1e-4 and the CSV row's depth metrics to
    atol 1e-3 (f32 everywhere; after two AdamW steps the gap is summation
    order amplified by Adam's normalised update)."""
    jvars = _np_tree(j_zoo.build_vit_extractor(
        "test_tiny_vit", return_multilayer=True, add_norm=True).variables)
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
        # one device, like the port: the same math without the 8-way mesh
        jrow = jax_train_depth.run(j_compose(
            "depth_training", SLICE + ["system.num_devices=1",
                                       f"output_dir={tmp_path / 'jax'}"]))

    def load_jax_vit(module, seed=0):
        module.load_state_dict(vit_state_dict(jvars))
        return module

    t_init = t_probe_fit.ProbeTrainer.init

    def load_jax_probe(self):
        t_init(self)
        self.modules.load_state_dict(copy.deepcopy(trainer_state_dict(
            init_state["params"], init_state["stats"])))

    monkeypatch.setattr(t_zoo, "random_init", load_jax_vit)
    monkeypatch.setattr(t_probe_fit.ProbeTrainer, "init", load_jax_probe)
    trow = t_train_depth.entry(SLICE + ["+system.device=cpu",
                                        f"output_dir={tmp_path / 'torch'}"])

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


def test_train_depth_checkpoint_resume_is_eval(tmp_path):
    """A second run with is_eval=True restores the saved probe and
    reproduces the trained run's metrics exactly; with render_images at its
    default (on) the same run writes the first-batch panels, the per-image
    dumps and the segment scatter."""
    argv = SLICE + ["probe=depth_linear", "dataset.num_instances=8",
                    "+system.device=cpu", f"output_dir={tmp_path}"]
    trained = t_train_depth.entry(argv)
    restored = t_train_depth.entry(argv + ["is_eval=True"])
    assert restored.pop("train_losses") == []
    assert len(trained.pop("train_losses")) == 1
    assert restored == trained
    rendered = t_train_depth.entry([a for a in argv if "render_images" not in a]
                                   + ["is_eval=True"])
    rendered.pop("train_losses")
    assert rendered == trained
    (exp_dir,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    files = sorted(os.listdir(exp_dir / "val_images"))
    # 8 test images in one batch: 8 first-batch pairs, 4 files per image
    assert len(files) == 2 * 8 + 4 * 8 and "metrics_depth_0_7.json" in files
    # one timestamped scatter per run (runs within a second share a name)
    plots = os.listdir(exp_dir / "plots")
    assert plots and all(p.startswith("segment_area_vs_d1_") and p.endswith(".png")
                         for p in plots)
