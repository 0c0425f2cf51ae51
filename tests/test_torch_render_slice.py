"""The drivers' artifacts end to end: each port driver against the
repository's JAX driver on the same config, test_tiny with the JAX
package's weights carried across.

* ``train_depth`` with ``render_images`` on, on a fabricated NYU tree
  (2 train and 2 test frames, 480x640, center crop): the same file names
  under ``val_images/`` (first-batch panels, per-image PNG, JSON and TXT)
  and one scatter PNG under ``plots/`` in both. The compared files come
  from the probe the JAX run trained, validated through the port's
  ``is_eval`` branch (two AdamW steps move a weight by about the step size
  whatever the gradient's size, so two trainings differ by more than the
  artifacts' tolerance). JSON values within 1e-4; target PNGs equal; pred
  PNGs equal except where a max-normalised depth lies within 1e-4 of a
  k/256 colormap boundary, where they may differ by one table step (the
  count of such pixels is printed).
* ``render_navi_correspondence`` on ``synthetic_navi_hard``: the same
  ``pair_{i}`` directories, each ``errors.json`` with the same
  ``num_matches`` and ``err3d`` within 1e-5 (after the same sort); the same
  matches with the same errors reach the line drawing, and both draw the
  50 lowest-error ones (members of a tie at the cut may differ).
* ``render_scannet_correspondence`` with ``render_every=2``: the same
  ``instance_{i}`` directories and files, each
  ``correspondence_metrics.json`` equal.

The JAX side runs under ``jax.default_matmul_precision("float32")`` on one
device."""

import copy
import json
import os
import sys

import jax
import numpy as np
import pytest
from PIL import Image

import render_navi_correspondence as j_render_navi
import render_scannet_correspondence as j_scannet
import train_depth as j_train_depth
from midvision_probe_torch import render_navi_correspondence as t_render_navi
from midvision_probe_torch import render_scannet_correspondence as t_scannet
from midvision_probe_torch import train_depth as t_train_depth
from midvision_probe_torch.convert.from_jax import trainer_state_dict, vit_state_dict
from midvision_probe_torch.engine import probe_fit as t_probe_fit
from midvision_probe_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.engine import probe_fit as j_probe_fit
from midvision_probe_tpu.models import zoo as j_zoo
from midvision_probe_tpu.utils import reporting as j_reporting

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_nyu import make_nyu_tree  # noqa: E402

F32 = jax.default_matmul_precision("float32")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def jax_vit(monkeypatch):
    """The port's test_tiny loads the JAX package's test_tiny weights."""
    jvars = _np_tree(j_zoo.build_vit_extractor(
        "test_tiny_vit", return_multilayer=True, add_norm=True).variables)

    def load_jax_vit(module, seed=0):
        module.load_state_dict(vit_state_dict(jvars))
        return module

    monkeypatch.setattr(t_zoo, "random_init", load_jax_vit)


def _png(path):
    return np.asarray(Image.open(path))


def _capture(monkeypatch, module, store):
    """Record every ``save_images_to_png`` call's predictions (by batch)."""
    save = module.save_images_to_png

    def recording(pred, *args, batch_idx, **kw):
        store[batch_idx] = np.squeeze(np.asarray(pred, np.float32), -1)
        return save(pred, *args, batch_idx=batch_idx, **kw)

    monkeypatch.setattr(module, "save_images_to_png", recording)


def _cmap_index(pred):
    """Max-normalised depth -> its inferno table index, and whether it lies
    within 1e-4 of a k/256 boundary."""
    x = pred / max(float(pred.max()), 1e-9)
    scaled = x * np.float32(256)
    near = np.abs(scaled - np.round(scaled)) < 256 * 1e-4
    return np.clip(np.floor(scaled), 0, 255).astype(int), near


def test_train_depth_artifacts_match_jax(tmp_path, monkeypatch, jax_vit):
    root = tmp_path / "nyu"
    make_nyu_tree(str(root / "train"), ["bathroom_0001_100", "kitchen_0002_42"], seed=5)
    make_nyu_tree(str(root / "test"), ["nyuv2_test_0", "nyuv2_test_1"], seed=6)
    argv = ["backbone=test_tiny", "dataset=nyu", f"dataset.train_path={root / 'train'}",
            f"dataset.test_path={root / 'test'}", "dataset.augment_train=False",
            "probe=depth_dpt", "probe.hidden_dim=32", "optimizer=one_epoch", "batch_size=2"]
    init_state, trained_state = {}, {}
    j_init, j_make_step = j_probe_fit.ProbeTrainer.init, j_probe_fit.ProbeTrainer._make_train_step

    def capture_init(self, batch):
        st = j_init(self, batch)
        init_state.update(params=_np_tree(st.params), stats=_np_tree(st.batch_stats))
        return st

    def capture_trained(self, cached):
        step = j_make_step(self, cached)

        def wrapped(*args):
            st, loss = step(*args)
            trained_state.update(params=_np_tree(st.params), stats=_np_tree(st.batch_stats))
            return st, loss

        return wrapped

    jax_preds, torch_preds = {}, {}
    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "init", capture_init)
    monkeypatch.setattr(j_probe_fit.ProbeTrainer, "_make_train_step", capture_trained)
    _capture(monkeypatch, j_reporting, jax_preds)
    with F32:
        j_train_depth.run(j_compose("depth_training", argv + [
            "system.num_devices=1", f"output_dir={tmp_path / 'jax'}"]))

    t_init = t_probe_fit.ProbeTrainer.init

    def load_jax_probe(self):
        t_init(self)
        self.modules.load_state_dict(copy.deepcopy(trainer_state_dict(
            init_state["params"], init_state["stats"])))

    monkeypatch.setattr(t_probe_fit.ProbeTrainer, "init", load_jax_probe)
    t_train_depth.entry(argv + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])
    # the JAX-trained probe through the port's is_eval branch, renders anew
    (exp_dir,) = [p for p in (tmp_path / "torch").iterdir() if p.is_dir()]
    ckpt = str(exp_dir / "ckpt")
    state, epoch = restore_checkpoint(ckpt)
    state["modules"] = trainer_state_dict(trained_state["params"], trained_state["stats"])
    save_checkpoint(ckpt, state, epoch)
    for sub in ("val_images", "plots"):
        for f in (exp_dir / sub).iterdir():
            f.unlink()
    _capture(monkeypatch, t_train_depth, torch_preds)
    t_train_depth.entry(argv + ["+system.device=cpu", "is_eval=True",
                                f"output_dir={tmp_path / 'torch'}"])

    (jexp,) = [p for p in (tmp_path / "jax").iterdir() if p.is_dir()]
    assert jexp.name == exp_dir.name
    names = sorted(os.listdir(jexp / "val_images"))
    assert sorted(os.listdir(exp_dir / "val_images")) == names
    assert len(names) == 2 * 2 + 4 * 2  # 2 first-batch pairs, 2 test images x 4 files
    for d in (jexp, exp_dir):
        (plot,) = os.listdir(d / "plots")
        assert plot.startswith("segment_area_vs_d1_") and plot.endswith(".png")
    assert sorted(jax_preds) == sorted(torch_preds) == [0]
    near_boundary_diffs = 0
    for name in names:
        got, ref = exp_dir / "val_images" / name, jexp / "val_images" / name
        if name.endswith(".json"):
            g, r = json.load(open(got)), json.load(open(ref))
            for part in ("global_metrics", "level_metrics"):
                gv = {k: v for k, v in g[part].items()}
                assert list(gv) == list(r[part])
            flat = lambda d: [v for kv in d["level_metrics"].values()  # noqa: E731
                              for v in kv.values()] + list(d["global_metrics"].values())
            np.testing.assert_allclose(flat(g), flat(r), atol=1e-4, rtol=1e-4, err_msg=name)
        elif name.endswith(".txt"):
            assert len(open(got).read().splitlines()) == len(open(ref).read().splitlines())
        elif "target" in name:
            np.testing.assert_array_equal(_png(got), _png(ref), err_msg=name)
        else:  # pred_depth_0_{i}.png and firstbatch_pred_{i}.png: batch 0's image i
            i = int(name.rsplit("_", 1)[1][:-4])
            it, near = _cmap_index(torch_preds[0][i])
            ij, _ = _cmap_index(jax_preds[0][i])
            differ = (_png(got) != _png(ref)).any(-1)
            assert not (differ & ~near).any(), name
            assert (np.abs(it - ij)[differ] <= 1).all(), name
            near_boundary_diffs += int(differ.sum())
    print(f"pred PNG pixels differing next to a colormap boundary: {near_boundary_diffs}")


def test_render_navi_matches_jax(tmp_path, monkeypatch, jax_vit):
    argv = ["backbone=test_tiny", "dataset=synthetic_navi_hard", "num_corr=100",
            "scale_factor=0.25"]
    pairs_seen = {"jax": [], "torch": []}
    j_pair, t_pair = j_render_navi.render_pair, t_render_navi.render_pair

    def record(pkg, uv0, uv1, err, order):
        # the JAX pixel grid carries float32 noise (50.000004 for 50)
        key = lambda i: tuple(np.round([*uv0[i], *uv1[i]], 3))  # noqa: E731
        matches = {key(i): float(err[i]) for i in range(len(err))}
        pairs_seen[pkg].append((matches, [key(i) for i in order]))

    def jax_pair(img0, img1, uv0, uv1, err, out_path, max_lines=50):
        record("jax", uv0, uv1, err, np.argsort(err)[:max_lines])
        return j_pair(img0, img1, uv0, uv1, err, out_path, max_lines)

    def torch_pair(img0, img1, uv0, uv1, err, out_path, max_lines=50):
        order = t_pair(img0, img1, uv0, uv1, err, out_path, max_lines)
        record("torch", uv0, uv1, err, order)
        return order

    monkeypatch.setattr(j_render_navi, "render_pair", jax_pair)
    monkeypatch.setattr(t_render_navi, "render_pair", torch_pair)
    with F32:
        jdir = j_render_navi.run(j_compose("navi_correspondence", argv + [
            f"output_dir={tmp_path / 'jax'}"]))
    tdir = t_render_navi.entry(argv + ["+system.device=cpu",
                                       f"output_dir={tmp_path / 'torch'}"])
    pairs = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == pairs == [f"pair_{i}" for i in range(8)]
    for p in pairs:
        assert sorted(os.listdir(os.path.join(tdir, p))) == sorted(
            os.listdir(os.path.join(jdir, p)))
        g = json.load(open(os.path.join(tdir, p, "errors.json")))
        r = json.load(open(os.path.join(jdir, p, "errors.json")))
        assert g["pair_id"] == r["pair_id"]
        assert g["num_matches"] == r["num_matches"] > 0
        np.testing.assert_allclose(np.sort(g["err3d"]), np.sort(r["err3d"]), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(g["err3d_mean"], r["err3d_mean"], atol=1e-5, rtol=0)
    assert len(pairs_seen["jax"]) == len(pairs_seen["torch"]) == 8
    for (tm, tlines), (jm, jlines) in zip(pairs_seen["torch"], pairs_seen["jax"]):
        # the same matches with the same errors; the drawn lines are the 50
        # lowest-error ones in both (ties, exact on this 16x16 grid, may
        # be broken toward other members of the tie)
        assert set(tm) == set(jm)
        np.testing.assert_allclose([tm[k] for k in sorted(tm)], [jm[k] for k in sorted(tm)],
                                   atol=1e-5, rtol=0)
        assert len(tlines) == len(jlines) == min(50, len(tm))
        np.testing.assert_allclose(sorted(tm[k] for k in tlines),
                                   sorted(jm[k] for k in jlines), atol=1e-5, rtol=0)
        tied = sum(1 for k in tlines if k not in set(jlines))
        cut = sorted(jm.values())[len(jlines) - 1]
        assert all(abs(tm[k] - cut) <= 1e-5 for k in tlines if k not in set(jlines)), tied


def test_render_scannet_instances_match_jax(tmp_path, monkeypatch, jax_vit):
    argv = ["backbone=test_tiny", "dataset=synthetic_scannet_hard", "dataset.num_instances=8",
            "num_corr=100", "scale_factor=0.25", "batch_pairs=4", "+render_every=2"]
    with F32:
        j_scannet.run(j_compose("scannet_correspondence", argv + [
            f"output_dir={tmp_path / 'jax'}"]))
    t_scannet.entry(argv + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])

    def instances(root):
        found = {}
        for dirpath, _, files in os.walk(root):
            if os.path.basename(dirpath).startswith("instance_"):
                found[os.path.basename(dirpath)] = (dirpath, sorted(files))
        return found

    jinst, tinst = instances(tmp_path / "jax"), instances(tmp_path / "torch")
    assert sorted(tinst) == sorted(jinst) == [f"instance_{i}" for i in (0, 2, 4, 6)]
    for name, (jpath, jfiles) in jinst.items():
        tpath, tfiles = tinst[name]
        assert tfiles == jfiles
        g = json.load(open(os.path.join(tpath, "correspondence_metrics.json")))
        r = json.load(open(os.path.join(jpath, "correspondence_metrics.json")))
        assert g["2d_error_counts"] == r["2d_error_counts"], name
        assert g["3d_error_counts"] == r["3d_error_counts"], name
        np.testing.assert_allclose(g["relative_angle_deg"], r["relative_angle_deg"],
                                   atol=1e-4, rtol=0)
