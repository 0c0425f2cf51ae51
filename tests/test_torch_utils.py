"""Parity of the PyTorch port's training utilities with the JAX package's:
config composition and target mapping, synthetic data and batch order, the
depth loss, the depth metrics, and the schedule + AdamW.

Inputs come from seeded numpy and are handed to both sides."""

import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from midvision_probe_torch.config import compose as t_compose
from midvision_probe_torch.config import instantiate as t_instantiate
from midvision_probe_torch.datasets import build_loader as t_build_loader
from midvision_probe_torch.models import probes as t_probes
from midvision_probe_torch.utils import losses as t_losses
from midvision_probe_torch.utils import metrics as t_metrics
from midvision_probe_torch.utils import optim as t_optim
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.config import core as j_config_core
from midvision_probe_tpu.datasets import build_loader as j_build_loader
from midvision_probe_tpu.utils import losses as j_losses
from midvision_probe_tpu.utils import metrics as j_metrics
from midvision_probe_tpu.utils import optim as j_optim


# ------------------------------------------------------------------ config
def test_config_targets_map_onto_the_port_without_global_aliases():
    aliases = dict(j_config_core._TARGET_ALIASES)
    cfg = t_compose("depth_training", ["backbone=test_tiny", "dataset=synthetic"])
    assert cfg.probe._target_.endswith(".models.probes.DepthHead")
    head = t_instantiate(cfg.probe, feat_dim=[32] * 4, max_depth=10.0)
    assert isinstance(head, t_probes.DepthHead) and head.name_tag == "bindepth_dpt_k3"
    ext = t_instantiate(cfg.backbone, return_multilayer=True, device="cpu")
    assert ext.checkpoint_name == "test_tiny_vit" and ext.multilayers == [0, 1, 2, 3]
    with pytest.raises(NotImplementedError, match="no counterpart"):
        t_instantiate(t_compose("depth_training", ["backbone=dift"]).backbone)
    assert j_config_core._TARGET_ALIASES == aliases


# -------------------------------------------------------------------- data
def test_synthetic_items_and_batch_order_match_jax():
    """Items byte-identical, and the shuffled train loader yields the same
    batches in the same order, epoch after epoch."""
    cfg = t_compose("depth_training", ["dataset=synthetic", "dataset.num_instances=12"])
    jcfg = j_compose("depth_training", ["dataset=synthetic", "dataset.num_instances=12"])
    for split in ("trainval", "test"):
        tl = t_build_loader(cfg.dataset, split, 4, seed=8)
        jl = j_build_loader(jcfg.dataset, split, 4, seed=8)
        assert len(tl) == len(jl) == 3
        for ep in range(2):
            tl.set_epoch(ep)
            jl.set_epoch(ep)
            tb, jb = list(tl), list(jl)
            assert len(tb) == len(jb)
            for a, b in zip(tb, jb):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    assert a[k].tobytes() == b[k].tobytes(), (split, ep, k)


# -------------------------------------------------------------------- loss
def test_depth_loss_matches_jax_with_holes(rng):
    """Holes (target 0) under negative predictions stay finite (the NaN
    guard) and far targets (> max_depth) are ignored. rtol 1e-5 (f32)."""
    pred = rng.uniform(0.2, 9.0, (2, 16, 20, 1)).astype(np.float32)
    target = rng.uniform(0.3, 9.5, (2, 16, 20, 1)).astype(np.float32)
    holes = rng.rand(2, 16, 20, 1) < 0.2
    target[holes] = 0.0
    pred[holes] = -0.5
    target[0, 0, :3] = 12.0
    ref = float(j_losses.depth_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = float(t_losses.depth_loss(torch.from_numpy(pred), torch.from_numpy(target)))
    assert math.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # the gradient at the holes is zero and finite
    p = torch.from_numpy(pred).requires_grad_(True)
    t_losses.depth_loss(p, torch.from_numpy(target)).backward()
    assert torch.isfinite(p.grad).all() and (p.grad[torch.from_numpy(holes)] == 0).all()


# ----------------------------------------------------------------- metrics
def test_evaluate_depth_matches_jax(rng):
    """Scale-aware and scale-invariant, global, stuff/things and levels;
    atol 1e-5 (f32 reductions in other orders)."""
    pred = rng.uniform(0.5, 9.0, (3, 20, 24, 1)).astype(np.float32)
    target = rng.uniform(0.5, 9.0, (3, 20, 24, 1)).astype(np.float32)
    target[rng.rand(3, 20, 24, 1) < 0.1] = 0.0
    seg = rng.choice([0, 7, 11, 30], size=(3, 20, 24)).astype(np.int32)
    for si in (False, True):
        jg, jl = j_metrics.evaluate_depth(jnp.asarray(pred), jnp.asarray(target),
                                          jnp.asarray(seg), scale_invariant=si)
        tg, tl = t_metrics.evaluate_depth(torch.from_numpy(pred),
                                          torch.from_numpy(target),
                                          torch.from_numpy(seg), scale_invariant=si)
        assert tg.keys() == jg.keys() and tl.keys() == jl.keys()
        for k in jg:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
        for lk in jl:
            for k in jl[lk]:
                np.testing.assert_allclose(tl[lk][k].numpy(), np.asarray(jl[lk][k]),
                                           atol=1e-5, rtol=1e-5, err_msg=f"{lk}/{k}")
    assert j_metrics.segment_metrics_depth(pred, target, seg) == \
        t_metrics.segment_metrics_depth(pred, target, seg)
    np.testing.assert_allclose(
        t_metrics.depth_rmse(torch.from_numpy(pred), torch.from_numpy(target)).numpy(),
        np.asarray(j_metrics.depth_rmse(jnp.asarray(pred), jnp.asarray(target))),
        rtol=1e-6)


# --------------------------------------------------------------- optimizer
def test_schedule_and_adamw_match_optax(rng):
    """The LambdaLR factor equals the optax schedule at every step (past
    max_step too: rel clamps at 1) to rtol 1e-5 (optax evaluates it in
    float32, the port in float64), and 3 AdamW steps with the schedule give
    the same parameters as optax.adamw (rtol 1e-6: f32 rounding)."""
    base_lr, max_step, warmup = 5e-3, 3, 0.45
    jsched = j_optim.cosine_decay_linear_warmup(base_lr, max_step, warmup)
    for step in range(6):
        np.testing.assert_allclose(
            base_lr * t_optim.cosine_decay_linear_warmup_factor(step, max_step, warmup),
            float(jsched(step)), rtol=1e-5)

    params = {"w": rng.randn(5, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = j_optim.make_adamw(jsched)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, sched = t_optim.make_adamw(list(tp.values()), base_lr, max_step, warmup)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
