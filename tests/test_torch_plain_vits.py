"""The plain-ViT backbones of the port against the JAX package.

* Forward parity, one tiny-width config per family, each made from the
  zoo entry's own ``vit`` fields with width, depth and heads cut (and the
  pos-embed table kept at its grid, so a learned table is resized): CLIP
  (LN before the blocks, quickgelu, a bias-free patch conv), SigLIP (no cls
  token, gelu_tanh, a patch-only table), MAE (a sincos table with a cls
  row, LayerNorm eps 1e-12), CroCo v1 (sincos, no cls token, every input
  resized to its fixed size), MaskFeat (no final norm), DINO at patch 8,
  CLIP ViT-L/14's grid on an input that patch 14 does not divide (the
  remainder pixels are cropped, the top-left kept, as a VALID conv does).
  Weights go JAX -> port through ``convert.from_jax`` after seeded N(0,
  0.05) noise on every leaf; the feature functions' maps and cls tokens
  agree within 1e-4 abs / 1e-3 rel (f32, the JAX side under
  ``jax.default_matmul_precision("float32")``).
* Each of the 18 ``configs/backbone`` files of these families names the
  same zoo entry through both packages' ``instantiate``, whose ``ViTConfig``
  fields, mean, std and ``fixed_input`` are equal; built at a tiny width,
  both extractors have the same feature spec.
* The families the port lacks (the SD featurizers) still raise; the
  others build."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.config import compose as t_compose
from midvision_probe_torch.config import instantiate as t_instantiate
from midvision_probe_torch.convert.from_jax import vit_state_dict
from midvision_probe_torch.models import feature_extractor as t_fe
from midvision_probe_torch.models import vit as t_vit
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.config import instantiate as j_instantiate
from midvision_probe_tpu.models import feature_extractor as j_fe
from midvision_probe_tpu.models import vit as j_vit
from midvision_probe_tpu.models import zoo as j_zoo

F32 = jax.default_matmul_precision("float32")
TINY = dict(width=32, num_heads=2)

# family -> (zoo entry, input HxW, output, fixed input)
FAMILIES = {
    "clip": ("clip_vitb16", (40, 56), "dense", None),
    "siglip": ("siglip_vitb16", (48, 32), "dense", None),
    "mae": ("mae_vitb16", (32, 48), "dense-cls", None),
    "croco_v1": ("croco_vitb16", (40, 56), "dense", 32),
    "maskfeat": ("maskfeat_vitb16", (48, 48), "dense-cls", None),
    "dino_patch8": ("dino_vitb8", (24, 40), "dense", None),
    "clip_l14_crop": ("clip_vitl14", (45, 61), "dense", None),
}

# the 18 configs of these families and the zoo entry each names
CONFIGS = {
    "dino_b8": "dino_vitb8", "mae_b16": "mae_vitb16", "mae_l16": "mae_vitl16",
    "ibot_b16": "ibot_vitb16", "ibot_b16_in22k": "ibot_vitb16_in22k",
    "ibot_l16": "ibot_vitl16", "ibot_l16_in22k": "ibot_vitl16_in22k",
    "mocov3_b14": "mocov3_vitb16", "maskfeat_vitb16": "maskfeat_vitb16",
    "milan_vitb16": "milan_vitb16", "eva_vitb16": "eva_vitb16",
    "pixmlm_vitb16": "pixmim_vitb16", "clip_b16": "clip_vitb16",
    "clip_b16_laion": "clip_vitb16_laion", "clip_l14": "clip_vitl14",
    "siglip_b16": "siglip_vitb16", "siglip_l16": "siglip_vitl16",
    "croco_b16": "croco_vitb16",
}


def _tiny(name: str) -> dict:
    cfg = dict(t_zoo.ZOO[name].vit, **TINY, depth=2)
    assert cfg == dict(j_zoo.ZOO[name].vit, **TINY, depth=2)
    if name == "clip_vitl14":
        cfg["patch_size"] = 8  # 45x61 -> a 5x7 grid, 5 and 5 pixels cropped
    return cfg


@pytest.mark.parametrize("family", list(FAMILIES))
def test_plain_vit_family_features_match_jax(rng, family):
    name, hw, output, fixed = FAMILIES[family]
    cfg = _tiny(name)
    taps = (0, 1)
    images = rng.randn(2, *hw, 3).astype(np.float32)
    jcfg = j_vit.ViTConfig(**cfg)
    jmodel = j_vit.ViT(jcfg)
    init_hw = (fixed, fixed) if fixed else hw
    params = jax.jit(functools.partial(jmodel.init, taps=taps))(
        jax.random.PRNGKey(3), jnp.zeros((1, *init_hw, 3)))
    noise = np.random.RandomState(4)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * noise.randn(*np.shape(a)).astype(np.float32), params)
    j_fn = j_fe.make_vit_feature_fn(jmodel, taps, output, jcfg.num_prefix_tokens,
                                    fixed_input=fixed)
    with F32:
        ref_maps, ref_cls = jax.jit(j_fn)(params, jnp.asarray(images))

    tcfg = t_vit.ViTConfig(**cfg)
    tmodel = t_vit.ViT(tcfg)
    tmodel.load_state_dict(vit_state_dict(params))
    t_fn = t_fe.make_vit_feature_fn(tmodel, taps, output, tcfg.num_prefix_tokens,
                                    fixed_input=fixed)
    with torch.no_grad():
        maps, cls = t_fn(torch.from_numpy(images))
    for g, r in zip(maps, ref_maps):
        assert tuple(g.shape) == np.asarray(r).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-3)
    for g, r in zip(cls, ref_cls):
        assert (g is None) == (r is None) == (not tcfg.class_token)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-3)
    grid = (fixed // cfg["patch_size"],) * 2 if fixed else (
        hw[0] // cfg["patch_size"], hw[1] // cfg["patch_size"])
    assert maps[0].shape[1:3] == grid
    # K1's branch (d = 16 divides 128; its plain version on the CPU)
    assert all(blk.attn.fused for blk in tmodel.blocks)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_backbone_config_names_the_same_entry_in_both_packages(monkeypatch, config):
    name = CONFIGS[config]
    t_entry, j_entry = t_zoo.ZOO[name], j_zoo.ZOO[name]
    t_cfg, j_cfg = t_vit.ViTConfig(**t_entry.vit), j_vit.ViTConfig(**j_entry.vit)
    for f in dataclasses.fields(t_cfg):
        assert getattr(t_cfg, f.name) == getattr(j_cfg, f.name), f.name
    for f in ("source", "filename", "converter", "prefix", "image_mean", "image_std",
              "default_size", "fixed_input", "fixed_input_mode"):
        assert getattr(t_entry, f) == getattr(j_entry, f), f
    # built through each package's instantiate at a tiny width (the rest of
    # the entry as it is): the same feature spec
    for zoo in (t_zoo, j_zoo):
        monkeypatch.setitem(zoo.ZOO, name, dataclasses.replace(
            zoo.ZOO[name], vit=dict(zoo.ZOO[name].vit, **TINY, depth=4)))
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", "/nonexistent")
    text = t_instantiate(t_compose("depth_training", [f"backbone={config}"]).backbone,
                         return_multilayer=True, device="cpu")
    jext = j_instantiate(j_compose("depth_training", [f"backbone={config}"]).backbone,
                         return_multilayer=True)
    assert dataclasses.asdict(text.spec) == dataclasses.asdict(jext.spec)
    assert text.spec.checkpoint_name == name


@pytest.mark.parametrize("config", ["dinov2_b14", "dinov2_b14_reg", "dinov2_l14",
                                    "deit3_b16", "beit-v2_vitb16", "midas_l16",
                                    "sam_base", "convnext_in22k", "simclr_resnet50",
                                    "dift", "zero123"])
def test_unported_families_raise(monkeypatch, config):
    """The SD featurizers still raise, pointing at ROADMAP.md; the
    LayerScale, register and relative-position-bias ViTs, SAM, ConvNeXt
    (each at a tiny width) and ResNet-50 build and give features of their
    config's shape."""
    from midvision_probe_torch.models import convnext as t_convnext
    from midvision_probe_torch.models import vit_sam as t_sam

    compose = t_compose("depth_training", [f"backbone={config}"])
    if config in ("dift", "zero123"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_instantiate(compose.backbone, device="cpu")
        return
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", "/nonexistent")
    name = compose.backbone["checkpoint_name"]
    if name in t_zoo.ZOO and t_zoo.ZOO[name].arch == "vit":
        monkeypatch.setitem(t_zoo.ZOO, name, dataclasses.replace(
            t_zoo.ZOO[name], vit=dict(t_zoo.ZOO[name].vit, **TINY, depth=4)))
    monkeypatch.setitem(t_sam.SAM_PRESETS, "vit_b",
                        dict(t_sam.SAM_PRESETS["vit_b"], width=32, num_heads=2))
    monkeypatch.setattr(t_convnext, "ConvNeXtConfig", functools.partial(
        t_convnext.ConvNeXtConfig, depths=(1, 1, 1, 1), dims=(8, 16, 24, 32)))
    ext = t_instantiate(compose.backbone, device="cpu")
    size = ext.spec.patch_size * 4 if ext.arch == "vit" else 64
    with torch.no_grad():
        out = ext(torch.zeros(1, size, size, 3))
    assert out.ndim == 4 and bool(torch.isfinite(out).all())
