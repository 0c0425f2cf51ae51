"""Parity of the PyTorch port's Taskonomy pieces with the JAX package's:
``task_transform`` for every task and input dtype (exact), the
``Taskonomy`` reader on ``data_processing/prepare_taskonomy.py``'s output
and on the synthetic fallback (exact), ``TaskonomyHead`` in its three
prediction types (flax weights and BatchNorm statistics carried across
with ``convert.from_jax``; 1e-5), the curvature and reshading metrics
(1e-5, with NaN and inf in the same places on zero targets), and
``masked_l1_loss`` and ``ssim`` (1e-6).

Inputs come from a seeded numpy RandomState; f32 on both sides, the JAX
side under ``jax.default_matmul_precision("float32")``."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from midvision_probe_torch.convert.from_jax import probe_state_dict
from midvision_probe_torch.datasets import taskonomy as t_tk
from midvision_probe_torch.models import probes as t_probes
from midvision_probe_torch.utils import losses as t_losses
from midvision_probe_torch.utils import metrics as t_metrics
from midvision_probe_tpu.datasets import taskonomy as j_tk
from midvision_probe_tpu.models import probes as j_probes
from midvision_probe_tpu.utils import losses as j_losses
from midvision_probe_tpu.utils import metrics as j_metrics

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "data_processing"))

F32 = jax.default_matmul_precision("float32")
TASKS = sorted(t_tk.TASK_PARAMETERS) + ["depth", "curvature"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(rng, dtype, channels):
    shape = (6, 5) if channels == 0 else (6, 5, channels)
    if dtype == "uint8":
        return rng.randint(0, 256, shape).astype(np.uint8)
    if dtype == "uint16":
        return rng.randint(0, 2**16, shape).astype(np.uint16)
    if dtype == "float_unit":
        return rng.rand(*shape).astype(np.float32)
    return (rng.rand(*shape) * 255).astype(np.float32)  # float, max above 1.5


# -------------------------------------------------------------- transforms
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float_unit", "float_255"])
@pytest.mark.parametrize("channels", [0, 1, 3])
def test_task_transform_matches_jax_for_every_task(rng, dtype, channels):
    x = _inputs(rng, dtype, channels)
    for task in TASKS + ["mask_valid"] + (["rgb"] if channels == 3 else []):
        got = t_tk.task_transform(x, task)
        ref = j_tk.task_transform(x, task)
        assert got.dtype == ref.dtype == np.float32, task
        np.testing.assert_array_equal(got, ref, err_msg=task)
    for fn in (t_tk.task_transform, j_tk.task_transform):
        with pytest.raises(KeyError, match="unknown taskonomy task"):
            fn(x, "segment_semantic")


def test_task_transform_scalings():
    """uint16 by 1/65535, 8 bits by 1/255 only above 1.5, curvature's two
    channels, depth's clamp rescaled to [0, 1]."""
    d16 = np.full((2, 2), 4000, np.uint16)
    np.testing.assert_allclose(t_tk.task_transform(d16, "depth")[..., 0],
                               4000 / 65535 / (8000 / 65535), rtol=1e-6)
    np.testing.assert_array_equal(t_tk.task_transform(np.full((2, 2), 1.2, np.float32),
                                                      "reshading"), np.float32(1.2))
    curv = np.full((2, 2, 3), 255, np.uint8)
    assert t_tk.task_transform(curv, "principal_curvature").shape == (2, 2, 2)
    mask = np.array([[0, 255], [128, 127]], np.uint8)
    np.testing.assert_array_equal(t_tk.task_transform(mask, "mask_valid")[..., 0],
                                  [[0, 1], [1, 0]])


# ------------------------------------------------------------------ reader
def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def taskonomy_dirs(tmp_path_factory):
    """A raw omnitools tree through ``prepare_taskonomy.py`` (the layout of
    ``tests/test_dataset_layouts.py::test_taskonomy_prepare_and_layout``)."""
    import prepare_taskonomy as prep

    tmp = tmp_path_factory.mktemp("taskonomy")
    rng = np.random.RandomState(11)
    raw = tmp / "raw"
    scenes = prep.TRAIN_SCENES[:2] + prep.VALIDATION_SCENES[:1] + prep.TEST_SCENES[:1]
    comps16 = ("depth_euclidean", "depth_zbuffer", "keypoints2d", "keypoints3d",
               "edge_texture", "edge_occlusion")
    for scene in scenes:
        for p in range(3):
            stem = f"point_{p}_view_0_domain"
            for comp in comps16:
                arr = rng.randint(0, 2**16 - 1, (8, 8)).astype(np.uint16)
                _png(str(raw / comp / "taskonomy" / scene / f"{stem}_{comp}.png"), arr)
            for comp in ("rgb", "normal", "principal_curvature", "reshading"):
                ch = 3 if comp != "reshading" else 1
                arr = rng.randint(0, 255, (8, 8, ch), dtype=np.uint8)
                _png(str(raw / comp / "taskonomy" / scene / f"{stem}_{comp}.png"),
                     arr.squeeze())
            _png(str(raw / "mask_valid" / "taskonomy" / scene / f"{stem}_mask_valid.png"),
                 (rng.rand(8, 8) > 0.2).astype(np.uint8) * 255)
    out_main, out_snorm = str(tmp / "taskonomy_seg"), str(tmp / "taskonomy_snorm_seg")
    assert prep.main(["--raw-root", str(raw), "--out-main", out_main, "--out-snorm",
                      out_snorm, "--train-size", "50", "--val-size", "5",
                      "--test-size", "5"]) == 0
    return out_main, out_snorm


@pytest.mark.parametrize("split", ["train", "test"])
def test_hf_reader_matches_jax_item_for_item(taskonomy_dirs, split):
    out_main, out_snorm = taskonomy_dirs
    for task in ("depth", "principal_curvature", "reshading", "edge_texture",
                 "keypoints2d", "normal"):
        kw = dict(snorm_path=out_snorm, other_path=out_main, split=split, task=task)
        got, ref = t_tk.Taskonomy(**kw), j_tk.Taskonomy(**kw)
        assert isinstance(got, t_tk.TaskonomyDataset)
        assert len(got) == len(ref) > 0
        for i in range(len(ref)):
            g, r = got[i], ref[i]
            assert list(g) == list(r) == ["image", "target", "mask_valid"]
            for k in r:
                np.testing.assert_array_equal(g[k], r[k], err_msg=f"{task} {i} {k}")
        assert got[0]["target"].shape[-1] == {"principal_curvature": 2, "normal": 3}.get(task, 1)


def test_hf_directory_without_the_datasets_package_raises(taskonomy_dirs, monkeypatch):
    """An existing directory is never replaced by synthetic data."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="'datasets' package"):
        t_tk.Taskonomy(snorm_path=taskonomy_dirs[1], other_path=taskonomy_dirs[0],
                       split="train", task="depth")


@pytest.mark.parametrize("task", ["principal_curvature", "depth", "reshading", "normal"])
def test_synthetic_fallback_matches_jax(tmp_path, task):
    kw = dict(snorm_path=str(tmp_path / "absent"), other_path=str(tmp_path / "absent"),
              split="test", task=task, num_instances=3, image_size=(24, 32))
    got, ref = t_tk.Taskonomy(**kw), j_tk.Taskonomy(**kw)
    assert len(got) == len(ref) == 3
    for i in range(3):
        g, r = got[i], ref[i]
        assert list(g) == list(r)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=f"{task} {i} {k}")


# -------------------------------------------------------------------- head
@pytest.mark.parametrize("pred_type", ["sigmoid", "tanh", "vanilla"])
def test_taskonomy_head_matches_jax(rng, pred_type):
    """Each prediction type, train mode then eval mode (for ``sigmoid`` the
    BatchNorm's batch statistics, then its updated running ones)."""
    feats = [rng.randn(2, 6, 5, 24).astype(np.float32) for _ in range(4)]
    feats2 = [rng.randn(3, 6, 5, 24).astype(np.float32) for _ in range(4)]
    kw = dict(feat_dim=[24] * 4, head_type="dpt", output_dim=2, pred_type=pred_type,
              hidden_dim=16, kernel_size=3)
    jhead = j_probes.TaskonomyHead(**kw)
    jf = [jnp.asarray(f) for f in feats]
    variables = jhead.init(jax.random.PRNGKey(3), jf)
    params = _np_tree(variables["params"])
    stats = _np_tree(variables.get("batch_stats", {}))
    assert ("batch_norm" in params) == (pred_type == "sigmoid")
    with F32:
        ref_train, upd = jhead.apply({"params": params, "batch_stats": stats}, jf,
                                     train=True, mutable=["batch_stats"])
        ref_eval = jhead.apply({"params": params, "batch_stats": upd.get("batch_stats", {})},
                               [jnp.asarray(f) for f in feats2])

    thead = t_probes.TaskonomyHead(**kw)
    thead.load_state_dict(probe_state_dict(params, stats))
    thead.train()
    with torch.no_grad():
        got_train = thead([torch.from_numpy(f) for f in feats]).numpy()
        thead.eval()
        got_eval = thead([torch.from_numpy(f) for f in feats2]).numpy()
    assert got_train.shape == np.asarray(ref_train).shape
    assert got_train.shape[-1] == 2
    np.testing.assert_allclose(got_train, np.asarray(ref_train), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_eval, np.asarray(ref_eval), atol=1e-5, rtol=0)
    if pred_type == "tanh":
        assert np.abs(got_eval).max() <= 1.0
    if pred_type == "vanilla":
        assert np.abs(got_eval).max() > 1.0  # the raw decoder output, unbounded


# ----------------------------------------------------------------- metrics
def _assert_metrics_match(got, ref, atol):
    assert list(got) == list(ref)
    for k in ref:
        g, r = got[k].numpy(), np.asarray(ref[k])
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=k)
        np.testing.assert_array_equal(np.isposinf(g), np.isposinf(r), err_msg=k)
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(r), err_msg=k)
        fin = np.isfinite(r)
        np.testing.assert_allclose(g[fin], r[fin], atol=atol, rtol=1e-6, err_msg=k)


def _curvature_case(rng, zero_targets):
    pred = (rng.randn(3, 16, 12, 2) * 0.6).astype(np.float32)
    gt = (rng.rand(3, 16, 12, 2) * 0.9 + 0.05).astype(np.float32)
    valid = (rng.rand(3, 16, 12, 1) > 0.2).astype(np.float32)
    if zero_targets:
        gt[0, :4] = 0.0                              # pred / 0 -> +-inf in the ratio
        gt[1, :2, :, 0] = np.float32(-1e-6)          # |gt + 1e-6| = 0 -> inf AbsRel
        pred[2, :3] = 0.0
        gt[2, :3] = 0.0                              # 0 / 0 -> NaN
        gt[1, 5, 5, 1] = np.float32(-1e-6)
        pred[1, 5, 5, 1] = np.float32(-1e-6)         # 0 / 0 AbsRel -> NaN
    return pred, gt, valid


@pytest.mark.parametrize("zero_targets", [False, True])
@pytest.mark.parametrize("image_average", [False, True])
def test_curvature_metrics_match_jax(rng, zero_targets, image_average):
    pred, gt, valid = _curvature_case(rng, zero_targets)
    got = t_metrics.evaluate_curvature_absrel(torch.from_numpy(pred), torch.from_numpy(gt),
                                              torch.from_numpy(valid), image_average)
    ref = j_metrics.evaluate_curvature_absrel(jnp.asarray(pred), jnp.asarray(gt),
                                              jnp.asarray(valid), image_average)
    _assert_metrics_match(got, ref, 1e-5)
    if zero_targets:
        absrel = np.asarray(ref["AbsRel"])
        assert not np.isfinite(absrel).all()  # the zero targets reach the output
    # a 2-channel mask takes the same path as the repeated one-channel mask
    got2 = t_metrics.evaluate_curvature_absrel(
        torch.from_numpy(pred), torch.from_numpy(gt),
        torch.from_numpy(np.repeat(valid, 2, -1)), image_average)
    _assert_metrics_match(got2, ref, 1e-5)


@pytest.mark.parametrize("zero_targets", [False, True])
@pytest.mark.parametrize("image_average", [False, True])
def test_reshading_metrics_match_jax(rng, zero_targets, image_average):
    pred = rng.rand(3, 16, 12, 1).astype(np.float32)
    target = (rng.rand(3, 16, 12, 1) * 0.9 + 0.05).astype(np.float32)
    mask = rng.rand(3, 16, 12, 1) > 0.3
    if zero_targets:
        target[0, :4] = 0.0
        pred[0, :2] = np.float32(-1e-6)              # t / (p + 1e-6) = 0 / 0
        target[1, :2] = np.float32(-1e-6)            # (t + 1e-6) = 0 -> inf AbsRel
        mask[1, :2] = True
        pred[2, :2] = target[2, :2] = np.float32(-1e-6)
        mask[2, :2] = True                           # 0 / 0 AbsRel -> NaN
    got = t_metrics.evaluate_reshading_absrel_and_delta(
        torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(mask),
        image_average=image_average)
    ref = j_metrics.evaluate_reshading_absrel_and_delta(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask),
        image_average=image_average)
    _assert_metrics_match(got, ref, 1e-5)
    if zero_targets and not image_average:
        absrel = np.asarray(ref["AbsRel"])
        assert np.isposinf(absrel[1]) and np.isnan(absrel[2])


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("mask_kind", ["none", "one_channel", "full", "empty"])
def test_masked_l1_loss_matches_jax(rng, mask_kind):
    pred = rng.randn(2, 9, 7, 2).astype(np.float32)
    target = rng.randn(2, 9, 7, 2).astype(np.float32)
    mask = {"none": None, "one_channel": rng.rand(2, 9, 7, 1) > 0.4,
            "full": rng.rand(2, 9, 7, 2) > 0.4, "empty": np.zeros((2, 9, 7, 1), bool)}[mask_kind]
    got = t_losses.masked_l1_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                  None if mask is None else torch.from_numpy(mask))
    ref = j_losses.masked_l1_loss(jnp.asarray(pred), jnp.asarray(target),
                                  None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(rng, size_average):
    img1 = rng.rand(2, 24, 20, 3).astype(np.float32)
    img2 = np.clip(img1 + rng.randn(2, 24, 20, 3).astype(np.float32) * 0.1, 0, 1)
    np.testing.assert_allclose(t_losses._gaussian_window(11, 1.5).numpy(),
                               np.asarray(j_losses._gaussian_window(11, 1.5)),
                               atol=1e-7, rtol=0)
    got = t_losses.ssim(torch.from_numpy(img1), torch.from_numpy(img2),
                        size_average=size_average).numpy()
    with F32:
        ref = np.asarray(j_losses.ssim(jnp.asarray(img1), jnp.asarray(img2),
                                       size_average=size_average))
    assert got.shape == ref.shape == (() if size_average else (2,))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    # an image against itself scores 1
    same = t_losses.ssim(torch.from_numpy(img1), torch.from_numpy(img1)).item()
    np.testing.assert_allclose(same, 1.0, atol=1e-6)
