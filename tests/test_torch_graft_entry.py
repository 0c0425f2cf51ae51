"""The port's driver entry points (``midvision_probe_torch/graft_entry.py``)
against the repository's ``__graft_entry__.py``.

* ``entry()``'s structure at a tiny size on the CPU, beside the JAX
  module's own small compile check (``tests/test_graft_entry.py``).
* ``dryrun_multichip(4, device="cpu")``: four gloo ranks, a 2 x 2
  ``(data, model)`` grid, the tiny preset on seeded random inputs and the
  JAX weights carried across (``convert/from_jax.py``): the loss, the
  gradients and the updated parameters against the JAX dry run's
  ``train_step`` math run unsharded on one CPU device (under
  ``jax.default_matmul_precision("float32")``).

  The loss is held to 1e-5 relative (read: 1.2e-7). The gradients of
  this step are ill-conditioned: rounding alone moves them (the port's
  one-process step on the same features, once strided and once
  contiguous, which changes only the convolutions' summation order, reads
  up to 11% of max|grad| apart on ``out_conv_1``'s weight). AdamW's first
  update is lr·sign(g) for every |g| well above its eps, so an element
  whose gradient is within that noise of zero may move by +lr in one run
  and -lr in the other. So the gradients are held within 5% of each
  tensor's max|g| (read: 1.2%), the parameters within 1e-5 absolute (a
  tenth of lr) on every element whose JAX gradient exceeds 5% of its
  tensor's max|g| (read: 3e-8), and every other element within
  2·lr + 1e-5, a sign flip and no more (read: 92 of 217,184 elements
  flipped). BatchNorm running statistics within 1e-6.
* Query-sharded ``knn2`` equal to the unsharded call, and ``pipeline_apply``
  over each model group within 1e-5 of the sequential stages (inside the
  run: the ranks raise otherwise, and report the errors).
* A renamed parameter makes the tensor-parallel rules raise, as the JAX
  dry run's loud failure does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from midvision_probe_torch import graft_entry
from midvision_probe_torch.convert.from_jax import trainer_state_dict, vit_state_dict
from midvision_probe_tpu.models import zoo as j_zoo
from midvision_probe_tpu.models.probes import DepthHead as JDepthHead
from midvision_probe_tpu.models.probes import TapNorms as JTapNorms
from midvision_probe_tpu.ops.image import resize as j_resize
from midvision_probe_tpu.utils.losses import depth_loss as j_depth_loss

F32 = jax.default_matmul_precision("float32")
LR = 1e-4
SURE_GRAD = 0.05  # of a tensor's max|g|: above the step's rounding noise


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX dry run's train_step (``__graft_entry__.py:187-204``) on the
    tiny preset, unsharded on one CPU device, on the port's seeded inputs."""
    preset = graft_entry.PRESETS["tiny"]
    backbone = j_zoo.build_vit_extractor("test_tiny_vit", output="dense",
                                         return_multilayer=True, init_size=preset.hw)
    probe = JDepthHead(feat_dim=backbone.feat_dim, head_type="dpt",
                       prediction_type="bindepth", hidden_dim=preset.hidden_dim,
                       kernel_size=3)
    tap_norms = JTapNorms(num_taps=len(backbone.multilayers))
    images, depth = (jnp.asarray(a) for a in graft_entry.dry_inputs("tiny", 2))
    rng = jax.random.PRNGKey(0)
    with F32:
        feats0, _ = backbone._apply_fn(backbone.variables, images[:1])
        tn_vars = tap_norms.init(rng, feats0, train=True)
        pr_vars = probe.init(rng, tap_norms.apply(tn_vars, feats0, train=False))
    params = {"tap": tn_vars["params"], "probe": pr_vars["params"]}
    stats = {"tap": tn_vars["batch_stats"]}
    tx = optax.adamw(LR)
    opt_state = tx.init(params)

    def loss_fn(p):
        feats, _ = backbone._apply_fn(backbone.variables, images)
        feats = [jax.lax.stop_gradient(f) for f in feats]
        feats, upd = tap_norms.apply({"params": p["tap"], "batch_stats": stats["tap"]},
                                     feats, train=True, mutable=["batch_stats"])
        pred = probe.apply({"params": p["probe"]}, feats)
        pred = j_resize(pred, depth.shape[1:3], mode="bilinear")
        return j_depth_loss(pred, depth), upd["batch_stats"]

    with F32:
        (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        updates, _ = tx.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
    state = {"backbone": vit_state_dict(_np_tree(backbone.variables)),
             "trainer": trainer_state_dict(_np_tree(params), _np_tree(stats))}
    return {"state": state, "loss": float(loss),
            "params": trainer_state_dict(_np_tree(new_params), _np_tree({"tap": new_stats})),
            "grads": trainer_state_dict(_np_tree(grads))}


@pytest.fixture(scope="module")
def dryrun(jax_step):
    return graft_entry.dryrun_multichip(4, device="cpu", preset="tiny",
                                        state=jax_step["state"], timeout_s=300)


def test_entry_returns_the_dense_four_tap_forward_at_a_tiny_size():
    fn, (backbone, example) = graft_entry.entry(device="cpu", model="test_tiny_vit",
                                                batch=2, hw=(64, 64))
    assert callable(fn) and example.shape == (2, 64, 64, 3)
    assert next(backbone.module.parameters()).dtype == torch.bfloat16
    maps = fn(backbone, example)
    assert len(maps) == 4
    assert all(m.shape == (2, 8, 8, 32) and m.dtype == torch.float32 for m in maps)
    assert all(bool(torch.isfinite(m).all()) for m in maps)


def test_dryrun_runs_a_two_by_two_grid_of_gloo_ranks(dryrun):
    assert dryrun["backend"] == "gloo" and dryrun["world_size"] == 4
    assert dryrun["mesh"] == {"data": 2, "model": 2}
    losses = [r["loss"] for r in dryrun["ranks"]]
    assert np.isfinite(losses).all() and len(set(losses)) == 1
    for r in dryrun["ranks"]:
        # this rank's heads of the test ViT (2 heads, d 16) on its data slice
        assert r["k1_qkv_shape"] == (2, 17, 3, 1, 16)


def test_dryrun_step_matches_the_jax_train_step(dryrun, jax_step):
    np.testing.assert_allclose(dryrun["loss"], jax_step["loss"], rtol=1e-5)
    for r in dryrun["ranks"]:
        for name, want in jax_step["params"].items():
            got = r["params"][name].numpy()
            want = want.numpy()
            g = jax_step["grads"].get(name)
            if g is None:  # BatchNorm running statistics
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
                continue
            g = g.numpy()
            sure = np.abs(g) > SURE_GRAD * np.abs(g).max()
            np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR + 1e-5, err_msg=name)
            gg = r["grads"][name].numpy()
            np.testing.assert_allclose(gg, g, rtol=0, atol=SURE_GRAD * np.abs(g).max(),
                                       err_msg=name)


def test_sharded_matching_and_pipeline_equal_the_unsharded_calls(dryrun):
    for r in dryrun["ranks"]:
        assert r["matching"]["idx_equal"]
        assert r["matching"]["max_dist_err"] <= 1e-6
        assert r["pipeline"]["stages"] == 2
        assert r["pipeline"]["max_err"] <= 1e-5


def test_a_renamed_parameter_makes_the_tp_rules_raise():
    vit = graft_entry.build("tiny", "cpu", 4).backbone.module
    assert set(graft_entry.tp_plan(vit).values()) == {"col", "row", "vec"}
    for blk in vit.blocks:  # mlp.fc2 -> mlp.fc_out
        blk.mlp.fc_out = blk.mlp.fc2
        del blk.mlp.fc2
    with pytest.raises(RuntimeError, match=r"matched no params for rules \[\('mlp', 'fc2'"):
        graft_entry.tp_plan(vit)
    with pytest.raises(RuntimeError, match="matched no params"):
        graft_entry.shard_tensor_parallel(vit, 0, 2, None)
