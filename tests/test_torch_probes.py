"""Parity of the PyTorch port's probe heads with the JAX package's: the
DPT depth head (both branches) and the other decoders with the depth
reduction, and the tap BatchNorms. Weights go JAX -> port through
``convert.from_jax``; inputs come from a seeded numpy RandomState.

fp32 on both sides; the JAX side runs under
``jax.default_matmul_precision("float32")``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.convert.from_jax import probe_state_dict
from midvision_probe_torch.models import probes as t_probes
from midvision_probe_tpu.models import probes as j_probes

F32 = jax.default_matmul_precision("float32")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -------------------------------------------------------------------- heads
def _feats(rng, shapes):
    return [rng.randn(2, h, w, c).astype(np.float32) for (c, h, w) in shapes]


HEAD_CASES = [
    # (head_type, prediction_type, feat_dim, tap shapes (C, h, w))
    ("dpt", "bindepth", [24] * 4, [(24, 6, 5)] * 4),
    ("dpt", "bindepth", [(8, 32), (12, 16), (16, 8), (20, 4)],
     [(8, 16, 16), (12, 8, 8), (16, 4, 4), (20, 2, 2)]),  # CNN (resnet) branch
    ("linear", "sigdepth", [24] * 4, [(24, 6, 5)] * 4),
    ("multiscale", "bindepth", [24] * 4, [(24, 6, 5)] * 4),
]


@pytest.mark.parametrize("head_type,pred_type,feat_dim,shapes", HEAD_CASES)
def test_depth_head_matches_jax(rng, head_type, pred_type, feat_dim, shapes):
    """Every decoder branch with the depth reduction. atol 2e-5 on depth in
    [0, 10] (f32 convs in other summation orders)."""
    feats = _feats(rng, shapes)
    kw = dict(feat_dim=feat_dim, head_type=head_type, prediction_type=pred_type,
              hidden_dim=16, kernel_size=3, max_depth=10.0)
    jhead = j_probes.DepthHead(**kw)
    jf = [jnp.asarray(f) for f in feats]
    variables = jhead.init(jax.random.PRNGKey(3), jf)
    with F32:
        ref = np.asarray(jhead.apply(variables, jf))

    thead = t_probes.DepthHead(**kw)
    thead.load_state_dict(probe_state_dict(_np_tree(variables["params"])))
    with torch.no_grad():
        got = thead([torch.from_numpy(f) for f in feats]).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_tap_norms_train_step_matches_flax_batchnorm(rng):
    """Train-mode normalisation and the running-stat update (biased batch
    variance, momentum 0.9) as flax computes them."""
    feats = _feats(rng, [(6, 4, 5)] * 2)
    jn = j_probes.TapNorms(num_taps=2)
    jf = [jnp.asarray(f) for f in feats]
    v = jn.init(jax.random.PRNGKey(0), jf, train=True)
    params = jax.tree_util.tree_map(lambda a: a + 0.3, v["params"])
    ref, upd = jn.apply({"params": params, "batch_stats": v["batch_stats"]}, jf,
                        train=True, mutable=["batch_stats"])

    tn = t_probes.TapNorms([6, 6])
    tn.load_state_dict(probe_state_dict(_np_tree(params),
                                        _np_tree(v["batch_stats"])))
    tn.train()
    got = tn([torch.from_numpy(f) for f in feats])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), atol=1e-5)
    sd = tn.state_dict()
    for i in range(2):
        stats = upd["batch_stats"][f"tap_norm_{i}"]
        np.testing.assert_allclose(sd[f"tap_norm_{i}.running_mean"].numpy(),
                                   np.asarray(stats["mean"]), atol=1e-6)
        np.testing.assert_allclose(sd[f"tap_norm_{i}.running_var"].numpy(),
                                   np.asarray(stats["var"]), atol=1e-6)
