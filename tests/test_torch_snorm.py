"""Parity of the PyTorch port's surface-normal pieces with the JAX
package's: ``SurfaceNormalHead`` (weights carried across with
``convert.from_jax``), ``angular_loss`` and ``snorm_l1_loss`` (values and
gradients against ``jax.grad``), and the normal metrics
(``evaluate_surface_norm`` with its levels, its stuff/things split and its
``is_navi`` form, ``evaluate_surface_norm_navi``, ``segment_metrics_snorm``).

Inputs come from a seeded numpy RandomState; f32 on both sides, the JAX
side under ``jax.default_matmul_precision("float32")``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.convert.from_jax import probe_state_dict
from midvision_probe_torch.models import probes as t_probes
from midvision_probe_torch.utils import losses as t_losses
from midvision_probe_torch.utils import metrics as t_metrics
from midvision_probe_tpu.models import probes as j_probes
from midvision_probe_tpu.utils import losses as j_losses
from midvision_probe_tpu.utils import metrics as j_metrics

F32 = jax.default_matmul_precision("float32")
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -------------------------------------------------------------------- head
@pytest.mark.parametrize("head_type,ua", [("dpt", True), ("dpt", False),
                                          ("multiscale", True), ("linear", False)])
def test_surface_normal_head_matches_jax(rng, head_type, ua):
    """4 channels with ``uncertainty_aware``, 3 without; the name tag; the
    output within atol 2e-5 (f32 convs in other summation orders, as
    ``test_torch_probes.py``)."""
    feats = [rng.randn(2, 6, 5, 24).astype(np.float32) for _ in range(4)]
    kw = dict(feat_dim=[24] * 4, head_type=head_type, uncertainty_aware=ua,
              hidden_dim=16, kernel_size=3)
    jhead = j_probes.SurfaceNormalHead(**kw)
    jf = [jnp.asarray(f) for f in feats]
    variables = jhead.init(jax.random.PRNGKey(5), jf)
    with F32:
        ref = np.asarray(jhead.apply(variables, jf))

    thead = t_probes.SurfaceNormalHead(**kw)
    thead.load_state_dict(probe_state_dict(_np_tree(variables["params"])))
    with torch.no_grad():
        got = thead([torch.from_numpy(f) for f in feats]).numpy()
    assert thead.name_tag == jhead.name_tag == (
        f"snorm_{head_type}_k3" + ("_UA" if ua else ""))
    assert got.shape == ref.shape and got.shape[-1] == (4 if ua else 3)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


# ------------------------------------------------------------------ losses
def _snorm_case(rng, channels=4, B=2, H=10, W=12):
    """A prediction, a target with invalid (all-zero) pixels, and a mask;
    a tenth of the pixels predict a positive multiple of the target
    (cosine 1, beyond the clip) and a tenth its negative (cosine -1)."""
    pr = rng.randn(B, H, W, channels).astype(np.float32)
    gt = rng.randn(B, H, W, 3).astype(np.float32)
    gt /= np.linalg.norm(gt, axis=-1, keepdims=True)
    gt[rng.rand(B, H, W) < 0.15] = 0.0
    pick = rng.rand(B, H, W)
    pr[..., :3] = np.where((pick < 0.1)[..., None], 1.7 * gt, pr[..., :3])
    pr[..., :3] = np.where(((pick >= 0.1) & (pick < 0.2))[..., None], -0.6 * gt, pr[..., :3])
    pr[..., :3][np.abs(pr[..., :3]).sum(-1) == 0] = 0.3  # no all-zero prediction
    mask = (np.abs(gt).sum(-1) > 0)[..., None]
    return pr, gt, mask


@pytest.mark.parametrize("ua", [True, False])
def test_angular_loss_and_gradient_match_jax(rng, ua):
    pr, gt, mask = _snorm_case(rng)
    beyond = np.abs(np.sum(pr[..., :3] * gt, -1) / (
        np.linalg.norm(pr[..., :3], axis=-1) * np.maximum(np.linalg.norm(gt, axis=-1), 1e-8)))
    assert (beyond[mask[..., 0]] > 1 - 1e-4).sum() >= 10  # cosines past the clip

    def jloss(p):
        return j_losses.angular_loss(p, jnp.asarray(gt), jnp.asarray(mask),
                                     uncertainty_aware=ua)

    ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(pr))
    tp = torch.from_numpy(pr).requires_grad_(True)
    got = t_losses.angular_loss(tp, torch.from_numpy(gt), torch.from_numpy(mask),
                                uncertainty_aware=ua)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), **TOL)
    grad = tp.grad.numpy()
    np.testing.assert_allclose(grad, np.asarray(ref_grad), **TOL)
    # clipped pixels carry no angular gradient on either side
    clipped = (beyond > 1 - 1e-4) & mask[..., 0]
    np.testing.assert_array_equal(grad[..., :3][clipped], 0.0)
    if not ua:
        np.testing.assert_array_equal(grad[..., 3], 0.0)


def test_snorm_l1_loss_and_gradient_match_jax(rng):
    pr, gt, mask = _snorm_case(rng, channels=3)

    def jloss(p):
        return j_losses.snorm_l1_loss(p, jnp.asarray(gt), jnp.asarray(mask))

    ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(pr))
    tp = torch.from_numpy(pr).requires_grad_(True)
    got = t_losses.snorm_l1_loss(tp, torch.from_numpy(gt), torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), **TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(ref_grad), **TOL)


# ----------------------------------------------------------------- metrics
def _seg(rng, B, H, W):
    """Panoptic ids from STUFF, THINGS and the four ids in neither."""
    ids = np.array([0, 3, 13, 7, 8, 20, 11, 40], np.int32)
    return ids[rng.randint(0, len(ids), (B, H, W))]


def _assert_tree_close(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            _assert_tree_close(got[k], v)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), err_msg=k, **TOL)


@pytest.mark.parametrize("is_navi,image_average", [(False, False), (True, False),
                                                   (False, True)])
def test_evaluate_surface_norm_matches_jax(rng, is_navi, image_average):
    """Global, five centroid levels (thresholds on the masked error map) and
    stuff/things with ``sqrt(sum)/pixels`` for the rmse."""
    pr, gt, _ = _snorm_case(rng, B=3, H=25, W=30)
    seg = _seg(rng, 3, 25, 30)
    g_ref, l_ref = j_metrics.evaluate_surface_norm(
        jnp.asarray(pr), jnp.asarray(gt), jnp.asarray(seg), is_navi=is_navi,
        image_average=image_average)
    g, lv = t_metrics.evaluate_surface_norm(
        torch.from_numpy(pr), torch.from_numpy(gt), torch.from_numpy(seg),
        is_navi=is_navi, image_average=image_average)
    _assert_tree_close(g, g_ref)
    _assert_tree_close(lv, l_ref)
    assert len(lv) == 5
    if not is_navi:
        # the quirk: sqrt of the sum, over the pixel count
        err = t_metrics._snorm_err_deg(torch.from_numpy(pr), torch.from_numpy(gt)).numpy()
        m = np.isin(seg, t_metrics.STUFF) & (np.abs(gt).sum(-1) > 0)
        quirk = np.sqrt((err**2 * m).sum((1, 2))) / np.maximum(m.sum((1, 2)), 1)
        want = quirk.mean() if image_average else quirk
        np.testing.assert_allclose(g["stuff_rmse"].numpy(), want, rtol=1e-5)
    else:
        assert not any(k.startswith(("stuff", "things")) for k in g)


def test_evaluate_surface_norm_navi_matches_jax(rng):
    pr, gt, _ = _snorm_case(rng, B=2, H=9, W=11)
    valid = rng.rand(2, 9, 11, 1) < 0.7
    for image_average in (False, True):
        ref = j_metrics.evaluate_surface_norm_navi(
            jnp.asarray(pr), jnp.asarray(gt), jnp.asarray(valid), image_average)
        got = t_metrics.evaluate_surface_norm_navi(
            torch.from_numpy(pr), torch.from_numpy(gt), torch.from_numpy(valid),
            image_average)
        _assert_tree_close(got, ref)


def test_segment_metrics_snorm_matches_jax(rng):
    pr, gt, _ = _snorm_case(rng, B=2, H=12, W=14)
    seg = _seg(rng, 2, 12, 14)
    ref = j_metrics.segment_metrics_snorm(pr, gt, seg)
    got = t_metrics.segment_metrics_snorm(pr, gt, seg)
    assert [(r["segment_id"], r["image_idx"]) for r in got] == [
        (r["segment_id"], r["image_idx"]) for r in ref]
    for g, r in zip(got, ref):
        assert g["area"] == r["area"]
        np.testing.assert_allclose(g["d1_ratio"], r["d1_ratio"], **TOL)
