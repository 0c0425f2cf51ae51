"""``FeatureExtractor.extract_kqv`` of the PyTorch port against the JAX
package's, on the same images and the same weights (carried across by
``convert.from_jax.vit_state_dict``): every mode (k, q, v and kqv, the
last in the order k, q, v) within 1e-5 in f32, at tiny widths of

* ``test_tiny_vit`` at head dim 64, the port's fused (K1) branch;
* ``dinov2_vitb14_reg``, fused, with LayerScale and 4 register tokens
  that the patch-token slice must leave out;
* ``beitv2_vitb16``, the generic branch with a relative-position bias, at
  its fixed 224 input (a 96x128 input is resized first);
* ``crocov2_vitb16``, the generic branch with RoPE (q and k are taken
  before the rotation) and no class token, also at a fixed 224 input.

A non-ViT extractor raises in both packages, and so does an unknown mode
in the port. The JAX side runs under
``jax.default_matmul_precision("float32")``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from midvision_probe_torch.convert.from_jax import vit_state_dict
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.models import zoo as j_zoo

F32 = jax.default_matmul_precision("float32")
MODES = ("k", "q", "v", "kqv")

# entry -> (its ViT at a tiny width, input size, patch grid, fused branch)
CASES = {
    "test_tiny_vit": (dict(width=128, num_heads=2, depth=4), (64, 64), (8, 8), True),
    "dinov2_vitb14_reg": (dict(width=128, num_heads=2, depth=4, mlp_ratio=2.0), (56, 42),
                          (4, 3), True),
    "beitv2_vitb16": (dict(width=64, num_heads=4, depth=4, mlp_ratio=2.0), (96, 128),
                      (14, 14), False),
    "crocov2_vitb16": (dict(width=64, num_heads=4, depth=4, mlp_ratio=2.0), (96, 128),
                       (14, 14), False),
}


def _extractors(monkeypatch, rng, name, narrow):
    """Both packages' extractors of ``name`` at the narrowed width, the JAX
    one's random weights (N(0, 0.1) in every leaf) loaded into the port."""
    for zoo in (j_zoo, t_zoo):
        monkeypatch.setitem(zoo.ZOO, name, dataclasses.replace(
            zoo.ZOO[name], vit=dict(zoo.ZOO[name].vit, **narrow)))
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", "/nonexistent")
    jext = j_zoo.build_vit_extractor(name, return_multilayer=True)
    variables = jax.tree_util.tree_map(
        lambda x: (0.1 * rng.randn(*np.shape(x))).astype(np.float32), jext.variables)
    jext.variables, jext._device_vars = variables, None

    def load(module, seed=0):
        module.load_state_dict(vit_state_dict(variables), strict=True)
        return module

    monkeypatch.setattr(t_zoo, "random_init", load)
    text = t_zoo.build_vit_extractor(name, return_multilayer=True, device="cpu")
    return jext, text


@pytest.mark.parametrize("name", list(CASES))
def test_extract_kqv_matches_jax(monkeypatch, rng, name):
    narrow, size, grid, fused = CASES[name]
    jext, text = _extractors(monkeypatch, rng, name, narrow)
    assert text.module.blocks[0].attn.fused == fused
    images = rng.randn(2, *size, 3).astype(np.float32)
    width = narrow["width"]
    for mode in MODES:
        got = text.extract_kqv(torch.from_numpy(images), mode).numpy()
        with F32:
            ref = np.asarray(jext.extract_kqv(jax.numpy.asarray(images), mode))
        assert got.shape == ref.shape == (2, *grid, width * (3 if mode == "kqv" else 1))
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=mode)


def test_extract_kqv_orders_k_q_v_and_counts_one_forward(monkeypatch, rng):
    narrow, size, grid, _ = CASES["test_tiny_vit"]
    _, text = _extractors(monkeypatch, rng, "test_tiny_vit", narrow)
    images = torch.from_numpy(rng.randn(1, *size, 3).astype(np.float32))
    before = type(text).forward_count
    kqv = text.extract_kqv(images, "kqv")
    assert type(text).forward_count == before + 1
    parts = [text.extract_kqv(images, m) for m in ("k", "q", "v")]
    torch.testing.assert_close(kqv, torch.cat(parts, dim=-1), rtol=0, atol=0)
    with pytest.raises(ValueError, match="mode"):
        text.extract_kqv(images, "qk")


@pytest.mark.parametrize("backbone", ["convnext_in22k", "sam_base"])
def test_extract_kqv_refuses_other_archs(monkeypatch, backbone):
    from midvision_probe_torch.config import compose as t_compose
    from midvision_probe_torch.config import instantiate as t_instantiate
    from midvision_probe_tpu.config import compose as j_compose
    from midvision_probe_tpu.config import instantiate as j_instantiate
    from test_torch_vit_families import CONFIGS, _narrow

    _narrow(monkeypatch, CONFIGS[backbone])
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", "/nonexistent")
    text = t_instantiate(t_compose("depth_training", [f"backbone={backbone}"]).backbone,
                         return_multilayer=True, device="cpu")
    jext = j_instantiate(j_compose("depth_training", [f"backbone={backbone}"]).backbone,
                         return_multilayer=True)
    images = np.zeros((1, 64, 64, 3), np.float32)
    with pytest.raises(ValueError, match="ViT feature"):
        text.extract_kqv(torch.from_numpy(images), "k")
    with pytest.raises(AssertionError, match="ViT feature"):
        jext.extract_kqv(jax.numpy.asarray(images), "k")
