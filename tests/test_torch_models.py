"""Parity of the PyTorch port's ViT with the JAX package's: the tapped
tokens and the feature contract of test_tiny_vit, the plain-ViT options,
the JAX fused-kernel path with whole-network padding, and dino_b16's
layout. Weights go JAX -> port through ``convert.from_jax``; inputs come
from a seeded numpy RandomState.

fp32 on both sides; the JAX side runs under
``jax.default_matmul_precision("float32")``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.convert.from_jax import vit_state_dict
from midvision_probe_torch.models import vit as t_vit
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.models import vit as j_vit
from midvision_probe_tpu.models import zoo as j_zoo

F32 = jax.default_matmul_precision("float32")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_test_tiny_vit_taps_match_jax(rng, hw):
    """All 4 taps of the feature contract; (64, 96) also resizes the 8x8
    pos-embed table bicubically to 8x12. atol 2e-5: f32, 4 blocks."""
    images = rng.rand(2, *hw, 3).astype(np.float32)
    jext = j_zoo.build_vit_extractor("test_tiny_vit", return_multilayer=True)
    with F32:
        ref = [np.asarray(f) for f in jext.features(jnp.asarray(images))]

    text = t_zoo.build_vit_extractor("test_tiny_vit", return_multilayer=True,
                                     device="cpu")
    text.module.load_state_dict(vit_state_dict(_np_tree(jext.variables)))
    got = [f.numpy() for f in text.features(torch.from_numpy(images))]

    assert text.multilayers == jext.multilayers == [0, 1, 2, 3]
    assert text.feat_dim == jext.feat_dim == [32] * 4
    assert len(got) == 4
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (2, hw[0] // 8, hw[1] // 8, 32)
        np.testing.assert_allclose(g, r, atol=2e-5, rtol=0)


@pytest.mark.parametrize("variant", [
    dict(final_norm=True, act="quickgelu"),
    dict(pre_norm=True, act="gelu_tanh", qkv_bias=False, patch_bias=False),
    dict(pos_embed="sincos2d"),
    dict(class_token=False, pos_embed_cls=False),
])
def test_plain_vit_variants_match_jax(rng, variant):
    """The plain-ViT options the slice's ViT carries (final/pre norm, the
    three activations, biases, sin-cos tables, no cls token). atol 2e-5."""
    cfg = dict(patch_size=8, width=32, depth=2, num_heads=2, **variant)
    jmodel = j_vit.ViT(j_vit.ViTConfig(**cfg))
    images = rng.randn(2, 32, 40, 3).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(images), taps=[0, 1])
    with F32:
        ref = jmodel.apply(params, jnp.asarray(images), taps=[0, 1])["tokens"]
    tmodel = t_vit.ViT(t_vit.ViTConfig(**cfg, table_grid=(4, 5)))
    tmodel.load_state_dict(vit_state_dict(_np_tree(params)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), taps=[0, 1])["tokens"]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=0)


def test_extractor_contract_single_layer_and_cls(rng):
    images = torch.from_numpy(rng.rand(1, 64, 64, 3).astype(np.float32))
    ext = t_zoo.build_vit_extractor("test_tiny_vit", device="cpu")
    assert ext.multilayers == [3] and ext.feat_dim == 32
    assert tuple(ext(images).shape) == (1, 8, 8, 32)
    cls = t_zoo.build_vit_extractor("test_tiny_vit", output="cls", return_cls=True,
                                    device="cpu")
    assert tuple(cls(images).shape) == (1, 32)
    gap = t_zoo.build_vit_extractor("test_tiny_vit", output="dense-cls",
                                    device="cpu")
    assert tuple(gap(images).shape) == (1, 8, 8, 64)


def test_vit_unported_features_raise():
    """Only SAM's windowed attention and ``scan_blocks`` are refused now;
    the relative-position bias, LayerScale and registers build."""
    with pytest.raises(NotImplementedError, match="window_size"):
        t_vit.ViT(t_vit.ViTConfig(window_size=14, table_grid=(2, 2)))
    with pytest.raises(NotImplementedError, match="scan_blocks"):
        t_vit.ViT(t_vit.ViTConfig(scan_blocks=True, table_grid=(2, 2)))
    vit = t_vit.ViT(t_vit.ViTConfig(width=32, depth=2, num_heads=2, rel_pos_bias=True,
                                    layerscale=True, pos_embed="none", table_grid=(2, 2)))
    assert tuple(vit.blocks[0].attn.rel_pos_bias_table.shape) == (3 * 3 + 3, 2)
    assert tuple(vit.blocks[1].gamma_2.shape) == (32,)
    assert not vit.blocks[0].attn.fused  # the biased einsum route


def test_vit_matches_jax_fused_kernel_path_with_padding(rng, monkeypatch):
    """2 layers, width 128, head dim 64 at N = 16*16+1 = 257: the JAX side
    runs its Pallas kernel (interpret mode) over the whole-network
    128-padded sequence (384 rows, n_valid=257); the port runs unpadded
    through the same attention contract. atol 2e-5 (f32)."""
    monkeypatch.setattr(j_vit, "_FORCE_INTERPRET", True)
    cfg = dict(patch_size=16, width=128, depth=2, num_heads=2)
    jmodel = j_vit.ViT(j_vit.ViTConfig(**cfg))
    images = rng.randn(1, 256, 256, 3).astype(np.float32) * 0.1
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images), taps=[0, 1])
    with F32:
        ref = jmodel.apply(params, jnp.asarray(images), taps=[0, 1])["tokens"]

    tmodel = t_vit.ViT(t_vit.ViTConfig(**cfg, table_grid=(16, 16)))
    tmodel.load_state_dict(vit_state_dict(_np_tree(params)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), taps=[0, 1])["tokens"]
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape == (1, 257, 128)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=0)


def test_dino_vitb16_layout_and_taps():
    """Full-width dino_b16 structure, built on the meta device (no memory,
    no forward): source-layout parameter names, 14x14 pos-embed table, taps
    2/5/8/11."""
    with torch.device("meta"):
        ext = t_zoo.DINO(return_multilayer=True, add_norm=True, device="meta")
    sd = ext.module.state_dict()
    assert tuple(sd["blocks.11.attn.qkv.weight"].shape) == (2304, 768)
    assert tuple(sd["pos_embed"].shape) == (1, 197, 768)
    assert tuple(sd["patch_embed.proj.weight"].shape) == (768, 3, 16, 16)
    assert ext.multilayers == [2, 5, 8, 11] and ext.checkpoint_name == "dino_vitb16"
    # DINO's released ViT-B/16 has 85,798,656 parameters, 1,536 of them in
    # the final `norm`, which the tapped probing forward never uses
    assert sum(p.numel() for p in ext.module.parameters()) == 85_797_120
