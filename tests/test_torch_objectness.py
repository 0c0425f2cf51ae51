"""Parity of the PyTorch port's objectness pieces with the JAX package's:
``BinaryHead`` (weights and BatchNorm statistics carried across with
``convert.from_jax``; its BatchNorm follows flax's rule, so the running
variance decays toward the biased batch variance), ``binary_cross_entropy``
(value and gradient against ``jax.grad``), the objectness metrics,
``SyntheticVOC`` and the ``VOC`` reader on a fabricated VOC tree (JPEGs,
palette and grey SegmentationObject PNGs with 255 boundaries, Annotations
XML; the layout of ``tests/test_dataset_layouts.py::test_voc_layout``).

Inputs come from a seeded numpy RandomState; f32 on both sides, the JAX
side under ``jax.default_matmul_precision("float32")``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from midvision_probe_torch.convert.from_jax import probe_state_dict
from midvision_probe_torch.datasets import synthetic as t_synthetic
from midvision_probe_torch.datasets.voc import VOC as TVOC
from midvision_probe_torch.models import probes as t_probes
from midvision_probe_torch.utils import losses as t_losses
from midvision_probe_torch.utils import objectness as t_obj
from midvision_probe_tpu.datasets import synthetic as j_synthetic
from midvision_probe_tpu.datasets.voc import VOC as JVOC
from midvision_probe_tpu.models import probes as j_probes
from midvision_probe_tpu.utils import losses as j_losses
from midvision_probe_tpu.utils import objectness as j_obj

F32 = jax.default_matmul_precision("float32")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -------------------------------------------------------------------- head
@pytest.mark.parametrize("head_type,output_dim", [("dpt", 1), ("linear", 2),
                                                  ("multiscale", 1)])
def test_binary_head_train_and_eval_match_jax(rng, head_type, output_dim):
    """One train-mode forward (batch statistics; the running mean and
    variance updated by momentum 0.9 toward the biased batch variance), then
    an eval-mode forward on other features (running statistics)."""
    feats = [rng.randn(2, 6, 5, 24).astype(np.float32) for _ in range(4)]
    feats2 = [rng.randn(3, 6, 5, 24).astype(np.float32) for _ in range(4)]
    kw = dict(feat_dim=[24] * 4, head_type=head_type, output_dim=output_dim,
              hidden_dim=16, kernel_size=3)
    jhead = j_probes.BinaryHead(**kw)
    jf = [jnp.asarray(f) for f in feats]
    variables = jhead.init(jax.random.PRNGKey(5), jf)
    # a running state away from the init's zeros and ones
    stats = _np_tree(variables["batch_stats"])
    stats["batch_norm"]["mean"] = rng.randn(output_dim).astype(np.float32) * 0.1
    stats["batch_norm"]["var"] = rng.rand(output_dim).astype(np.float32) + 0.5
    params = _np_tree(variables["params"])
    params["batch_norm"]["scale"] = rng.rand(output_dim).astype(np.float32) + 0.5
    params["batch_norm"]["bias"] = rng.randn(output_dim).astype(np.float32) * 0.1
    with F32:
        ref_train, upd = jhead.apply({"params": params, "batch_stats": stats}, jf,
                                     train=True, mutable=["batch_stats"])
        ref_eval = jhead.apply({"params": params, "batch_stats": upd["batch_stats"]},
                               [jnp.asarray(f) for f in feats2])

    thead = t_probes.BinaryHead(**kw)
    thead.load_state_dict(probe_state_dict(params, stats))
    thead.train()
    with torch.no_grad():
        got_train = thead([torch.from_numpy(f) for f in feats]).numpy()
        thead.eval()
        got_eval = thead([torch.from_numpy(f) for f in feats2]).numpy()
    assert got_train.shape == np.asarray(ref_train).shape
    assert got_train.shape[-1] == output_dim
    np.testing.assert_allclose(got_train, np.asarray(ref_train), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_eval, np.asarray(ref_eval), atol=1e-5, rtol=0)
    bn = upd["batch_stats"]["batch_norm"]
    np.testing.assert_allclose(thead.batch_norm.running_mean.numpy(), bn["mean"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(thead.batch_norm.running_var.numpy(), bn["var"],
                               atol=1e-5, rtol=0)
    assert not np.allclose(bn["var"], stats["batch_norm"]["var"])  # it moved


def test_binary_head_default_output_dim_and_other_pred_types(rng):
    """The reference constructor's two channels; the ``tanh`` and raw
    prediction types (no BatchNorm) match the JAX head's; ``init_probe_``
    starts the BatchNorm where flax's init does."""
    feats = [rng.randn(1, 4, 4, 8).astype(np.float32) for _ in range(4)]
    jf = [jnp.asarray(f) for f in feats]
    for pred_type in ("tanh", "raw"):
        jhead = j_probes.BinaryHead(feat_dim=[8] * 4, pred_type=pred_type, hidden_dim=8)
        variables = jhead.init(jax.random.PRNGKey(2), jf)
        assert "batch_stats" not in variables
        thead = t_probes.BinaryHead(feat_dim=[8] * 4, pred_type=pred_type, hidden_dim=8)
        thead.load_state_dict(probe_state_dict(_np_tree(variables["params"])))
        with F32:
            ref = np.asarray(jhead.apply(variables, jf))
        with torch.no_grad():
            got = thead([torch.from_numpy(f) for f in feats]).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=pred_type)
    jhead = j_probes.BinaryHead(feat_dim=[8] * 4, hidden_dim=8)
    variables = jhead.init(jax.random.PRNGKey(1), jf)
    thead = t_probes.BinaryHead(feat_dim=[8] * 4, hidden_dim=8)
    thead.load_state_dict(probe_state_dict(_np_tree(variables["params"]),
                                           _np_tree(variables["batch_stats"])))
    thead.eval()
    with F32:
        ref = np.asarray(jhead.apply(variables, jf))
    with torch.no_grad():
        got = thead([torch.from_numpy(f) for f in feats]).numpy()
    assert got.shape[-1] == ref.shape[-1] == 2
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # the port's seeded init gives the BatchNorm flax's initial state
    t_probes.init_probe_(thead, torch.Generator().manual_seed(0))
    init = dict(probe_state_dict(_np_tree(variables["params"]),
                                 _np_tree(variables["batch_stats"])))
    for k in ("weight", "bias", "running_mean", "running_var"):
        np.testing.assert_array_equal(getattr(thead.batch_norm, k).detach().numpy(),
                                      init[f"batch_norm.{k}"].numpy(), err_msg=k)


# ------------------------------------------------------------ loss, metrics
def test_binary_cross_entropy_and_gradient_match_jax(rng):
    pred = rng.rand(2, 9, 7, 1).astype(np.float32)
    pred.flat[:4] = [0.0, 1.0, 1e-9, 1 - 1e-9]  # the clip at eps and 1 - eps
    target = (rng.rand(2, 9, 7, 1) > 0.5).astype(np.float32)
    ref, ref_grad = jax.value_and_grad(j_losses.binary_cross_entropy)(
        jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = t_losses.binary_cross_entropy(p, torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad), atol=1e-6, rtol=1e-6)


def test_objectness_metrics_match_jax(rng):
    pred = rng.rand(5, 12, 10, 1).astype(np.float32)
    gt = (rng.rand(5, 12, 10, 1) > 0.6).astype(np.float32)
    pred[1] = 0.0  # predicts nothing
    gt[2] = 0.0  # no object
    pred[3] = gt[3]  # exact
    pb, gb = (pred[0, ..., 0] >= 0.5).astype(np.uint8), gt[0, ..., 0].astype(np.uint8)
    p, r = t_obj.compute_precision_recall(pb, gb)
    assert (p, r) == j_obj.compute_precision_recall(pb, gb)
    assert t_obj.compute_f_measure(p, r) == j_obj.compute_f_measure(p, r)
    for fn in ("compute_iou", "compute_accuracy", "compute_corloc"):
        assert getattr(t_obj, fn)(pred[0, ..., 0], gb) == getattr(j_obj, fn)(
            pred[0, ..., 0], gb), fn
    for reduce in (True, False):
        got = t_obj.evaluate_binary_masks(pred, gt, reduce=reduce)
        ref = j_obj.evaluate_binary_masks(pred, gt, reduce=reduce)
        assert list(got) == list(ref) == ["F-measure", "IoU", "Accuracy", "CorLoc"]
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=0, err_msg=k)
    assert t_obj.evaluate_binary_masks(pred, gt, reduce=False)["CorLoc"][3] == 1


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("split", ["trainval", "test"])
def test_synthetic_voc_items_equal_jax(split):
    got = t_synthetic.SyntheticVOC(split, num_instances=5, image_size=(24, 40))
    ref = j_synthetic.SyntheticVOC(split, num_instances=5, image_size=(24, 40))
    assert len(got) == len(ref) == 5 and got.name == ref.name
    for i in range(5):
        g, r = got[i], ref[i]
        assert list(g) == list(r)
        for k in r:
            assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def make_voc_tree(root, frames, hw=(60, 80), seed=7):
    """``frames`` of (stem, object count): ``JPEGImages/<stem>.jpg``,
    ``SegmentationObject/<stem>.png`` (object ids 1..n, a 255 boundary
    around each object and a void top row; palette PNGs as VOC ships them,
    every other frame a grey PNG) and ``Annotations/<stem>.xml``."""
    rng = np.random.RandomState(seed)
    h, w = hw
    for sub in ("JPEGImages", "SegmentationObject", "Annotations"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for j, (stem, n_obj) in enumerate(frames):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, "JPEGImages", f"{stem}.jpg"))
        seg = np.zeros((h, w), np.uint8)
        for k in range(n_obj):
            y, x = rng.randint(2, h // 2), rng.randint(0, w // 2)
            seg[y:y + h // 3, x:x + w // 3] = 255
            seg[y + 1:y + h // 3 - 1, x + 1:x + w // 3 - 1] = k + 1
        seg[0, :] = 255
        img = Image.fromarray(seg)
        if j % 2 == 0:
            img = img.convert("P")
            img.putpalette([c for i in range(256) for c in (i * 37 % 256, i * 91 % 256, i)])
        img.save(os.path.join(root, "SegmentationObject", f"{stem}.png"))
        objs = "".join("<object><name>cat</name></object>" for _ in range(n_obj))
        with open(os.path.join(root, "Annotations", f"{stem}.xml"), "w") as f:
            f.write(f"<annotation>{objs}</annotation>")


@pytest.mark.parametrize("fixed_size", [96, 45])
def test_voc_reader_matches_jax(tmp_path, fixed_size):
    root = str(tmp_path / "VOC2007")
    make_voc_tree(root, [("2007_000032", 2), ("2007_000039", 1), ("2007_000063", 3),
                         ("2007_000068", 0)])
    os.remove(os.path.join(root, "Annotations", "2007_000063.xml"))  # no XML: one object
    kw = dict(trainval_path=os.path.join(root, "SegmentationObject"),
              trainval_jpeg_dir=os.path.join(root, "JPEGImages"),
              trainval_xml_dir=os.path.join(root, "Annotations"), fixed_size=fixed_size)
    got, ref = TVOC(split="trainval", **kw), JVOC(split="trainval", **kw)
    assert len(got) == len(ref) == 4 and got.name == ref.name == "voc"
    for i in range(4):
        g, r = got[i], ref[i]
        assert list(g) == list(r)
        for k in r:
            assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        assert g["mask"].shape == (fixed_size, fixed_size, 1)
        assert set(np.unique(g["mask"])) <= {0.0, 1.0}
    assert [int(got[i]["num_objects"]) for i in range(4)] == [2, 1, 1, 1]
    assert got[0]["mask"].any() and not got[3]["mask"].any()
    with pytest.raises(FileNotFoundError):
        TVOC(split="test", **kw)
