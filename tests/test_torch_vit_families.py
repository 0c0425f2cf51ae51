"""The LayerScale, register and relative-position-bias ViTs of the PyTorch
port against the JAX package's ``ViT`` (DINOv2, DINOv2-reg, DeiT-III,
BEiT-v2, MiDaS):

* small ``ViTConfig``s with LayerScale, 4 register tokens and BEiT's
  relative-position bias, each alone and LayerScale with each of the
  other two (the JAX index covers one prefix token, so registers and the
  bias do not combine), from random weights carried across by
  ``convert.from_jax.vit_state_dict``: taps within 1e-5;
* ``_rel_pos_index`` equal on square and non-square grids;
* the fabricated full-size ``dinov2_vitb14.pth``,
  ``deit_3_base_384_21k.pth``, ``beitv2_vitb16.pth`` and
  ``dpt_beit_large_384.pt`` (``data_processing/make_source_layout_
  checkpoints.py``'s layouts) loaded strictly by both zoos: taps within
  1e-4 * max|ref| at batch 1 and the entry's own size, and no random init
  in the port;
* each of the 7 backbone configs, and the 2 SAM and 4 ConvNeXt configs,
  names the same entry in both packages (the entry's fields and, built at
  a tiny width, the feature spec);
* the register tokens are not in the spatial taps; BEiT's fixed-input
  resize.

The JAX side runs under ``jax.default_matmul_precision("float32")``."""

import dataclasses
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from midvision_probe_torch.config import compose as t_compose
from midvision_probe_torch.config import instantiate as t_instantiate
from midvision_probe_torch.convert.from_jax import vit_state_dict
from midvision_probe_torch.models import vit as t_vit
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_torch.ops.image import resize
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.config import instantiate as j_instantiate
from midvision_probe_tpu.models import vit as j_vit
from midvision_probe_tpu.models import zoo as j_zoo

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "data_processing"))

from make_source_layout_checkpoints import _beit_large_midas, _beit_vitb  # noqa: E402
from torch_replicas import TimmViT  # noqa: E402

F32 = jax.default_matmul_precision("float32")
GRID = (3, 4)
BASE = dict(patch_size=8, width=64, depth=3, num_heads=4, mlp_ratio=2.0, table_grid=GRID)


def _random_like(tree, rng):
    """Every leaf replaced by N(0, 0.1) draws (the init's ones and zeros
    would hide a wrongly placed gamma, register or bias table)."""
    return jax.tree_util.tree_map(
        lambda x: (0.1 * rng.randn(*np.shape(x))).astype(np.float32), tree)


@pytest.mark.parametrize("features", [
    dict(layerscale=True),
    dict(num_register_tokens=4),
    dict(rel_pos_bias=True, pos_embed="none"),
    dict(layerscale=True, num_register_tokens=4),
    dict(layerscale=True, rel_pos_bias=True, pos_embed="none"),
], ids=["layerscale", "registers", "rel_pos_bias", "layerscale_registers", "beit"])
def test_vit_features_match_jax(features, rng):
    kw = dict(BASE, **features)
    images = rng.randn(2, GRID[0] * 8, GRID[1] * 8, 3).astype(np.float32)
    jmod = j_vit.ViT(j_vit.ViTConfig(**kw))
    taps = (0, 1, 2)
    variables = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jax.numpy.asarray(images), taps=taps))
    variables = _random_like(variables, rng)
    with F32:
        ref = jmod.apply(variables, jax.numpy.asarray(images), taps=taps)
    tmod = t_vit.ViT(t_vit.ViTConfig(**kw))
    tmod.load_state_dict(vit_state_dict(variables), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(images), taps=taps)
    assert got["grid_hw"] == tuple(ref["grid_hw"]) == GRID
    n = 1 + kw.get("num_register_tokens", 0) + GRID[0] * GRID[1]
    for g, r in zip(got["tokens"], ref["tokens"]):
        assert tuple(g.shape) == tuple(r.shape) == (2, n, 64)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def test_rel_pos_bias_needs_its_grid_and_one_prefix_token():
    with pytest.raises(ValueError, match="table_grid"):
        t_vit.ViT(t_vit.ViTConfig(**dict(BASE, table_grid=None), rel_pos_bias=True,
                                  pos_embed="none"))
    with pytest.raises(ValueError, match="one prefix token"):
        t_vit.ViT(t_vit.ViTConfig(**BASE, rel_pos_bias=True, num_register_tokens=4))
    tmod = t_vit.ViT(t_vit.ViTConfig(**BASE, rel_pos_bias=True, pos_embed="none"))
    with pytest.raises(ValueError, match="grid"):
        tmod(torch.zeros(1, 32, 40, 3), taps=(0,))


@pytest.mark.parametrize("window", [(3, 3), (2, 5), (14, 14)])
def test_rel_pos_index_equals_jax(window):
    np.testing.assert_array_equal(t_vit._rel_pos_index(window),
                                  j_vit._rel_pos_index(window))


def test_registers_are_not_in_the_spatial_taps(rng, monkeypatch):
    """A DINOv2-reg-shaped tiny entry with output dense-cls: the cls half
    is token 0 and the spatial half the last h*w tokens, without the 4
    registers; both zoos agree."""
    vit = dict(BASE, layerscale=True, num_register_tokens=4, depth=4)
    for zoo in (j_zoo, t_zoo):
        monkeypatch.setitem(zoo.ZOO, "dinov2_vitb14_reg",
                            dataclasses.replace(zoo.ZOO["dinov2_vitb14_reg"], vit=vit))
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", "/nonexistent")
    jext = j_zoo.build_vit_extractor("dinov2_vitb14_reg", output="dense-cls",
                                     return_multilayer=True)
    variables = _random_like(jax.tree_util.tree_map(np.asarray, jext.variables), rng)
    jext.variables, jext._device_vars = variables, None

    def load(module, seed=0):
        module.load_state_dict(vit_state_dict(variables))
        return module

    monkeypatch.setattr(t_zoo, "random_init", load)
    text = t_zoo.build_vit_extractor("dinov2_vitb14_reg", output="dense-cls",
                                     return_multilayer=True, device="cpu")
    images = rng.randn(1, 24, 32, 3).astype(np.float32)
    with torch.no_grad():
        maps = text.features(torch.from_numpy(images))
        tokens = text.module(torch.from_numpy(images), taps=text.multilayers)["tokens"]
    with F32:
        ref = jext.features(jax.numpy.asarray(images))
    for m, tok, r in zip(maps, tokens, ref):
        assert tuple(m.shape) == (1, 3, 4, 128) and tok.shape[1] == 1 + 4 + 12
        np.testing.assert_array_equal(m[..., :64].numpy(), tok[:, 5:].reshape(1, 3, 4, 64))
        np.testing.assert_array_equal(m[..., 64:].numpy(),
                                      tok[:, :1].expand(1, 12, 64).reshape(1, 3, 4, 64))
        np.testing.assert_allclose(m.numpy(), np.asarray(r), atol=1e-5, rtol=0)


# the fabricated full-size containers, as make_source_layout_checkpoints.py
# builds them, and the entry each loads through
def _container(name):
    if name == "dinov2_vitb14":
        return TimmViT(dim=768, depth=12, heads=12, patch=14, grid=37, layerscale=True,
                       ls_naming="ls", seed=20).state_dict()
    if name == "deit3_vitb16":
        return {"model": TimmViT(dim=768, depth=12, heads=12, patch=16, grid=24,
                                 layerscale=True, seed=22).state_dict()}
    if name == "beitv2_vitb16":
        return {"model": _beit_vitb(seed=24)}
    return _beit_large_midas(seed=28)


@pytest.mark.parametrize("name", ["dinov2_vitb14", "deit3_vitb16", "beitv2_vitb16",
                                  "midas_l16"])
def test_fabricated_containers_load_in_both_zoos(tmp_path, monkeypatch, rng, name):
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(tmp_path))
    torch.save(_container(name), tmp_path / t_zoo.ZOO[name].filename)

    def no_random_init(*a, **k):
        raise AssertionError("random init ran although a checkpoint is present")

    monkeypatch.setattr(t_zoo, "random_init", no_random_init)
    size = t_zoo.ZOO[name].fixed_input or t_zoo.ZOO[name].default_size
    images = rng.randn(1, size, size, 3).astype(np.float32)
    text = t_zoo.build_vit_extractor(name, return_multilayer=True, device="cpu")
    with torch.no_grad():
        got = [f.numpy() for f in text.features(torch.from_numpy(images))]
    del text
    jext = j_zoo.build_vit_extractor(name, return_multilayer=True)
    with F32:
        ref = [np.asarray(f) for f in jext.features(jax.numpy.asarray(images))]
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.shape[1] == size // t_zoo.ZOO[name].vit["patch_size"]
        np.testing.assert_allclose(g, r, atol=1e-4 * np.abs(r).max(), rtol=0)


def test_beit_resizes_every_input_to_its_fixed_size(rng, monkeypatch):
    """The BEiT-v2 entry (tiny width, its fixed 224 input) resizes a 96x128
    input bilinearly to 224x224 first: the features of the input resized
    by ``ops.image.resize``, and the JAX extractor's within 1e-4."""
    vit = dict(t_zoo.ZOO["beitv2_vitb16"].vit, width=64, depth=4, num_heads=4,
               mlp_ratio=2.0)
    for zoo in (j_zoo, t_zoo):
        monkeypatch.setitem(zoo.ZOO, "beitv2_vitb16",
                            dataclasses.replace(zoo.ZOO["beitv2_vitb16"], vit=vit))
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", "/nonexistent")
    jext = j_zoo.build_vit_extractor("beitv2_vitb16", return_multilayer=True)
    variables = _random_like(jax.tree_util.tree_map(np.asarray, jext.variables), rng)
    jext.variables, jext._device_vars = variables, None

    def load(module, seed=0):
        module.load_state_dict(vit_state_dict(variables))
        return module

    monkeypatch.setattr(t_zoo, "random_init", load)
    text = t_zoo.build_vit_extractor("beitv2_vitb16", return_multilayer=True, device="cpu")
    images = rng.randn(2, 96, 128, 3).astype(np.float32)
    resized = resize(torch.from_numpy(images), (224, 224), mode="bilinear",
                     align_corners=False)
    with torch.no_grad():
        got = text.features(torch.from_numpy(images))
        direct = text.features(resized)
    with F32:
        ref = jext.features(jax.numpy.asarray(images))
    for g, d, r in zip(got, direct, ref):
        assert tuple(g.shape) == (2, 14, 14, 64)
        np.testing.assert_array_equal(g.numpy(), d.numpy())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0)


# the 7 configs of these families, the SAM and ConvNeXt configs, and the zoo
# entry each names
CONFIGS = {"dinov2_b14": "dinov2_vitb14", "dinov2_b14_reg": "dinov2_vitb14_reg",
           "dinov2_l14": "dinov2_vitl14", "deit3_b16": "deit3_vitb16",
           "deit3_l16": "deit3_vitl16", "beit-v2_vitb16": "beitv2_vitb16",
           "midas_l16": "midas_l16", "sam_base": "sam_vit_b", "sam_large": "sam_vit_l",
           "convnext_in22k": "cnxt_b_in22k", "convnext_fcmae": "cnxt_b_fcmae",
           "clip_convnext": "cnxt_b_w_laion2b", "clip_convnext_augreg": "cnxt_b_w_laion2b"}


def _narrow(monkeypatch, name):
    """The entry's architecture at a tiny width in both packages: a ViT's
    config, a SAM preset (its depth and global blocks kept) or ConvNeXt's
    stage widths."""
    from midvision_probe_torch.models import convnext as t_convnext
    from midvision_probe_torch.models import vit_sam as t_sam
    from midvision_probe_tpu.models import convnext as j_convnext
    from midvision_probe_tpu.models import vit_sam as j_sam

    arch = t_zoo.ZOO[name].arch
    for zoo, sam, convnext in ((t_zoo, t_sam, t_convnext), (j_zoo, j_sam, j_convnext)):
        if arch == "vit":
            monkeypatch.setitem(zoo.ZOO, name, dataclasses.replace(
                zoo.ZOO[name], vit=dict(zoo.ZOO[name].vit, width=32, num_heads=2, depth=4)))
        elif arch == "sam":
            preset = name.replace("sam_", "")
            monkeypatch.setitem(sam.SAM_PRESETS, preset,
                                dict(sam.SAM_PRESETS[preset], width=32, num_heads=2))
        else:
            monkeypatch.setattr(convnext, "ConvNeXtConfig", functools.partial(
                convnext.ConvNeXtConfig, depths=(1, 1, 1, 1), dims=(8, 16, 24, 32)))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_backbone_config_names_the_same_entry_in_both_packages(monkeypatch, config):
    name = CONFIGS[config]
    t_entry, j_entry = t_zoo.ZOO[name], j_zoo.ZOO[name]
    assert t_entry.vit == j_entry.vit
    for f in ("arch", "source", "filename", "converter", "prefix", "image_mean",
              "image_std", "default_size", "fixed_input", "fixed_input_mode"):
        assert getattr(t_entry, f) == getattr(j_entry, f), f
    _narrow(monkeypatch, name)
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", "/nonexistent")
    text = t_instantiate(t_compose("depth_training", [f"backbone={config}"]).backbone,
                         return_multilayer=True, device="cpu")
    jext = j_instantiate(j_compose("depth_training", [f"backbone={config}"]).backbone,
                         return_multilayer=True)
    assert dataclasses.asdict(text.spec) == dataclasses.asdict(jext.spec)
    assert text.spec.checkpoint_name == name
