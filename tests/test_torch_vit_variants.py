"""Parity of the port's ViT generic attention branch with the JAX package's:
tiny CroCo-v2-shaped (2D RoPE, no cls token, no pos-embed table) and
RADIO-v2-shaped (head dim 80, patch-only pos-embed table, final norm) ViTs,
a RoPE ViT with a class token (the prefix stays unrotated), and the
``fixed_input`` resize of the feature function.

Weights go JAX -> port through ``convert.from_jax``; every parameter is
perturbed with seeded numpy noise first, so biases, the class token and the
LayerNorm affine are not their zero/one init. f32 on both sides, the JAX
side under ``jax.default_matmul_precision("float32")``. Taps agree within
1e-4 abs / 1e-3 rel (2 blocks, f32, other summation orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.convert.from_jax import vit_state_dict
from midvision_probe_torch.models import feature_extractor as t_fe
from midvision_probe_torch.models import vit as t_vit
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_torch.ops import rope2d as t_rope
from midvision_probe_torch.ops import vit_attention as t_vit_attn
from midvision_probe_tpu.models import feature_extractor as j_fe
from midvision_probe_tpu.models import vit as j_vit

F32 = jax.default_matmul_precision("float32")

CROCOV2_TINY = dict(patch_size=8, width=32, depth=2, num_heads=2, class_token=False,
                    pos_embed="none", rope=True)
ROPE_CLS_TINY = dict(patch_size=8, width=32, depth=2, num_heads=2, rope=True,
                     pos_embed="none")
RADIO_TINY = dict(patch_size=8, width=160, depth=2, num_heads=2, final_norm=True,
                  pos_embed_cls=False, table_grid=(4, 4))


def _jax_params(cfg: dict, images: np.ndarray, taps, seed: int = 0):
    """JAX init at the input, every leaf perturbed by N(0, 0.05) noise."""
    jmodel = j_vit.ViT(j_vit.ViTConfig(**cfg))
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(images), taps=taps)
    rng = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32),
        params)
    return jmodel, params


def _run_both(cfg: dict, images: np.ndarray, taps=(0, 1)):
    jmodel, params = _jax_params(cfg, images, taps)
    with F32:
        ref = jmodel.apply(params, jnp.asarray(images), taps=taps)
    tmodel = t_vit.ViT(t_vit.ViTConfig(**cfg))
    tmodel.load_state_dict(vit_state_dict(params))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), taps=taps)
    assert got["grid_hw"] == ref["grid_hw"]
    return got["tokens"], ref["tokens"], tmodel


def _counts():
    return (t_vit_attn.fused_qkv_attention.launches, t_vit_attn.vit_attention.launches,
            t_rope.rope_2d.launches)


@pytest.mark.parametrize("cfg,hw,layout", [
    # CroCo-v2: no pos-embed table, no cls token
    (CROCOV2_TINY, (32, 24), {"pos_embed": None, "cls_token": None}),
    # the prefix (cls) token stays unrotated
    (ROPE_CLS_TINY, (24, 40), {"pos_embed": None, "cls_token": (1, 1, 32)}),
    # RADIO: a patch-only (4x4, no cls row) table resized to the 4x6 grid,
    # a cls token and the final norm
    (RADIO_TINY, (32, 48), {"pos_embed": (1, 16, 160), "cls_token": (1, 1, 160),
                            "norm.weight": (160,)}),
], ids=["crocov2", "rope_with_cls", "radio"])
def test_vit_variant_taps_match_jax(rng, cfg, hw, layout):
    """Taps, and the layout ``vit_state_dict`` carries across (the strict
    ``load_state_dict`` in ``_run_both`` checks that the key sets agree)."""
    images = rng.randn(2, *hw, 3).astype(np.float32)
    before = _counts()
    got, ref, tmodel = _run_both(cfg, images)
    assert _counts() == before  # the CPU runs the plain versions: no launch
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-3)
    # every block takes the generic branch (RoPE, or d = 80 outside K1's d | 128)
    assert all(not blk.attn.fused for blk in tmodel.blocks)
    sd = tmodel.state_dict()
    for key, shape in layout.items():
        assert (tuple(sd[key].shape) if key in sd else None) == shape, key


def test_fixed_input_feature_fn_matches_jax(rng):
    """A ``fixed_input=32`` CroCo-v2-shaped extractor fed 48x64 images: both
    packages resize bilinearly (align_corners=False) to 32x32 first, so the
    features come out at the 4x4 grid."""
    images = rng.rand(2, 48, 64, 3).astype(np.float32)
    taps = (0, 1)
    jmodel, params = _jax_params(CROCOV2_TINY, np.zeros((1, 32, 32, 3), np.float32), taps)
    j_fn = j_fe.make_vit_feature_fn(jmodel, taps, "dense", 0, fixed_input=32)
    with F32:
        ref_maps, _ = j_fn(params, jnp.asarray(images))
    tmodel = t_vit.ViT(t_vit.ViTConfig(**CROCOV2_TINY))
    tmodel.load_state_dict(vit_state_dict(params))
    t_fn = t_fe.make_vit_feature_fn(tmodel, taps, "dense", 0, fixed_input=32)
    with torch.no_grad():
        got_maps, cls = t_fn(torch.from_numpy(images))
    assert cls == [None, None]
    for g, r in zip(got_maps, ref_maps):
        assert tuple(g.shape) == r.shape == (2, 4, 4, 32)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-3)


def test_zoo_entries_and_constructors(monkeypatch):
    """``crocov2_vitb16`` and ``radio_v2`` at full width on the meta device
    (no memory, no forward), built through the config constructors: layout,
    taps, the fixed 224 input; and a tiny CroCo-v2 extractor through
    ``CROCOV2`` on the CPU, whose 48x64 input comes out at the fixed grid."""
    with torch.device("meta"):
        croco = t_zoo.CROCOV2(return_multilayer=True, add_norm=True,
                              checkpoint_name="crocov2_vitb16", device="meta")
        radio = t_zoo.RADIO(version="radio_v2", return_multilayer=True,
                            checkpoint_name="radio_v2", return_cls=False, device="meta")
    sd = croco.module.state_dict()
    assert "pos_embed" not in sd and "cls_token" not in sd
    assert croco.multilayers == [2, 5, 8, 11]
    assert t_zoo.ZOO["crocov2_vitb16"].fixed_input == 224
    sd = radio.module.state_dict()
    assert tuple(sd["pos_embed"].shape) == (1, 256, 1280)
    assert tuple(sd["blocks.31.attn.qkv.weight"].shape) == (3840, 1280)
    assert radio.module.cfg.head_dim == 80 and radio.multilayers == [7, 15, 23, 31]
    # the ViT-H/16 trunk: 32 blocks of 19,677,440, the patch embed, the
    # 16x16 table, the cls token and the final norm
    assert sum(p.numel() for p in radio.module.parameters()) == 630_993_920

    tiny = dataclasses.replace(t_zoo.ZOO["crocov2_vitb16"], vit=CROCOV2_TINY,
                               fixed_input=32)
    monkeypatch.setitem(t_zoo.ZOO, "crocov2_vitb16", tiny)
    ext = t_zoo.CROCOV2(output="dense", device="cpu")
    images = torch.from_numpy(np.random.RandomState(2).rand(1, 48, 64, 3).astype(np.float32))
    assert tuple(ext(images).shape) == (1, 4, 4, 32)
