"""Released-checkpoint loading in the PyTorch port against the JAX package:

* the port's copies of ``unwrap_checkpoint`` and the ViT and RADIO
  converters give the JAX ones' numpy trees, array for array and exactly,
  on every container of ``tests/test_source_layouts.py`` (the DINO-style
  ``state_dict`` box, MoCo-v3, mmselfsup, HF-MAE, the VISSL and MoCo-v2
  unwraps, CroCo and RADIO), each saved and read back with ``torch.load``;
* the port's copy of the OpenCLIP converter gives the JAX one's tree
  exactly on an OpenAI-layout CLIP file (``visual.*`` and text-tower junk);
* one fabricated file per ported backbone family (tiny DINO-style, CroCo-v2
  and RADIO configs, and the MILAN, iBOT, MoCo v3, EVA, MAE, CroCo v1,
  SigLIP and CLIP containers: both zoos' entries patched to them) is loaded
  by both zoos: the taps agree within atol 1e-4 (f32; the JAX side under
  ``jax.default_matmul_precision("float32")``), RADIO's mean and std come
  from the input conditioner, equal, and the port's random init never runs;
* a file whose keys do not match makes the port raise, and an architecture
  no ported family takes raises ``NotImplementedError``.

The containers are made by ``data_processing/torch_replicas.py``."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "data_processing"))

from test_convert_extra import _CLIPVisual  # noqa: E402
from torch_replicas import (  # noqa: E402
    RadioViT,
    TimmViT,
    sincos2d_pos_embed,
    timm_to_hf_mae,
    timm_to_mmselfsup,
    wrap_croco,
    wrap_mocov2,
    wrap_mocov3_vit,
    wrap_radio,
    wrap_vissl,
)
from midvision_probe_torch.models import convert as t_convert  # noqa: E402
from midvision_probe_torch.models import vit as t_vit  # noqa: E402
from midvision_probe_torch.models import zoo as t_zoo  # noqa: E402
from midvision_probe_tpu.models import convert as j_convert  # noqa: E402
from midvision_probe_tpu.models import vit as j_vit  # noqa: E402
from midvision_probe_tpu.models import zoo as j_zoo  # noqa: E402
from midvision_probe_tpu.models.convert.clip_convert import convert_vit_openclip as j_convert_openclip  # noqa: E402,E501
from midvision_probe_tpu.models.convert.radio_convert import convert_radio as j_convert_radio  # noqa: E402,E501
from midvision_probe_tpu.models.convert.remap import unwrap_checkpoint as j_unwrap  # noqa: E402

F32 = jax.default_matmul_precision("float32")
DIM, DEPTH, HEADS, PATCH, GRID = 64, 4, 4, 8, 3


def _roundtrip(tmp_path, obj, source):
    """save -> torch.load -> both packages' unwrap_checkpoint."""
    path = os.path.join(tmp_path, f"{source}.bin")
    torch.save(obj, path)
    load = lambda: torch.load(path, map_location="cpu", weights_only=False)  # noqa: E731
    return t_convert.unwrap_checkpoint(load(), source), j_unwrap(load(), source)


def _assert_same_trunk(got: dict, ref: dict):
    assert list(got) == list(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_same_tree(got: dict, ref: dict):
    g, r = dict(_flat(got)), dict(_flat(ref))
    assert list(g) == list(r)
    for k, v in r.items():
        assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
        np.testing.assert_array_equal(g[k], v, err_msg=str(k))


def _cfgs(**kw):
    base = dict(patch_size=PATCH, width=DIM, depth=DEPTH, num_heads=HEADS, mlp_ratio=2.0,
                table_grid=(GRID, GRID), **kw)
    return t_vit.ViTConfig(**base), j_vit.ViTConfig(**base)


def _tiny_timm(**kw):
    return TimmViT(dim=DIM, depth=DEPTH, heads=HEADS, patch=PATCH, grid=GRID, mlp_ratio=2.0,
                   seed=11, **kw)


# -------------------------------------------------------------- converters
@pytest.mark.parametrize("container", ["state_dict_box", "mocov3", "mmselfsup", "raw",
                                       "hf_mae", "croco"])
def test_unwrap_and_convert_give_the_jax_trees(tmp_path, container):
    t = _tiny_timm(class_token=container != "croco")
    sd = t.state_dict()
    converter, prefix, cfg_kw = "timm", "", {}
    if container == "state_dict_box":
        obj, source = {"state_dict": dict(sd), "epoch": 1}, "state_dict"
        obj["state_dict"]["head.mlp.0.weight"] = torch.zeros(8, DIM)
    elif container == "mocov3":
        obj, source = wrap_mocov3_vit(dict(sd)), "mocov3"
    elif container == "mmselfsup":
        obj, source = timm_to_mmselfsup(dict(sd)), "mmselfsup"
    elif container == "raw":
        obj, source = dict(sd), "raw"
    elif container == "hf_mae":
        obj, source = timm_to_hf_mae(dict(sd)), "raw"
        converter, prefix = "hf", "vit."
    else:
        obj, source = wrap_croco(dict(sd)), "croco"
        cfg_kw = dict(class_token=False, pos_embed="sincos2d")
    got_sd, ref_sd = _roundtrip(tmp_path, obj, source)
    _assert_same_trunk(got_sd, ref_sd)
    t_cfg, j_cfg = _cfgs(**cfg_kw)
    if converter == "hf":
        got = t_convert.convert_vit_hf(got_sd, t_cfg, prefix=prefix)
        ref = j_convert.convert_vit_hf(ref_sd, j_cfg, prefix=prefix)
    else:
        got = t_convert.convert_vit_timm(got_sd, t_cfg, prefix=prefix)
        ref = j_convert.convert_vit_timm(ref_sd, j_cfg, prefix=prefix)
    _assert_same_tree(got, ref)


def test_vissl_mocov2_and_openclip_unwraps_match_jax(tmp_path):
    trunk = {"conv1.weight": torch.randn(4, 3, 7, 7), "bn1.weight": torch.randn(4)}
    for obj, source in [(wrap_vissl(dict(trunk)), "vissl"),
                        (wrap_mocov2(dict(trunk)), "mocov2"),
                        ({"state_dict": dict(trunk)}, "openclip")]:
        got, ref = _roundtrip(tmp_path, obj, source)
        _assert_same_trunk(got, ref)
        assert set(got) == set(trunk), source
    with pytest.raises(ValueError, match="unknown checkpoint source"):
        t_convert.unwrap_checkpoint({}, "nope")


def test_radio_convert_gives_the_jax_tree_and_conditioner(tmp_path):
    t = RadioViT(dim=160, depth=DEPTH, heads=2, patch=PATCH, grid=4, mlp_ratio=2.0, seed=13)
    obj = wrap_radio(t.state_dict(), mean=(0.1, 0.2, 0.3), std=(0.9, 0.8, 0.7))
    got_sd, ref_sd = _roundtrip(tmp_path, obj, "state_dict")
    _assert_same_trunk(got_sd, ref_sd)
    kw = dict(patch_size=PATCH, width=160, depth=DEPTH, num_heads=2, mlp_ratio=2.0,
              final_norm=True, pos_embed_cls=False, table_grid=(4, 4))
    got, got_extras = t_convert.convert_radio(got_sd, t_vit.ViTConfig(**kw))
    ref, ref_extras = j_convert_radio(ref_sd, j_vit.ViTConfig(**kw))
    _assert_same_tree(got, ref)
    assert got_extras == ref_extras
    assert got_extras["image_mean"] == tuple(np.float32([0.1, 0.2, 0.3]))


def clip_container(seed=26, d=DIM, heads=HEADS, depth=DEPTH, patch=PATCH, img=PATCH * GRID):
    """An OpenAI CLIP ``.pt`` as ``make_source_layout_checkpoints.py``
    lays it out: the visual tower under ``visual.`` (open_clip naming, the
    final ``ln_post`` and projection included) and text-tower junk."""
    torch.manual_seed(seed)
    t = _CLIPVisual(d=d, heads=heads, depth=depth, patch=patch, img=img)
    sd = {f"visual.{k}": v for k, v in t.state_dict().items()}
    sd["visual.ln_post.weight"] = torch.ones(d) + 0.1 * torch.randn(d)
    sd["visual.ln_post.bias"] = 0.1 * torch.randn(d)
    sd["visual.proj"] = torch.randn(d, 16) * 0.02
    sd["token_embedding.weight"] = torch.zeros(100, 16)
    sd["transformer.resblocks.0.ln_1.weight"] = torch.ones(16)
    sd["logit_scale"] = torch.tensor(4.6052)
    return sd


@pytest.mark.parametrize("final_norm", [False, True])
def test_openclip_convert_gives_the_jax_tree(tmp_path, final_norm):
    got_sd, ref_sd = _roundtrip(tmp_path, clip_container(), "openclip")
    _assert_same_trunk(got_sd, ref_sd)
    kw = dict(pre_norm=True, patch_bias=False, act="quickgelu", layernorm_eps=1e-5,
              mlp_ratio=4.0, final_norm=final_norm)
    base = dict(patch_size=PATCH, width=DIM, depth=DEPTH, num_heads=HEADS,
                table_grid=(GRID, GRID), **kw)
    got = t_convert.convert_vit_openclip(got_sd, t_vit.ViTConfig(**base))
    ref = j_convert_openclip(ref_sd, j_vit.ViTConfig(**base))
    _assert_same_tree(got, ref)
    assert ("norm" in got["params"]) == final_norm
    assert "qkv" in got["params"]["blocks_0"]["attn"]


# ------------------------------------------------------------- zoo loading
TINY = {
    "dino_vitb16": dict(vit=dict(patch_size=PATCH, width=DIM, depth=DEPTH, num_heads=HEADS,
                                 mlp_ratio=2.0, table_grid=(GRID, GRID))),
    "crocov2_vitb16": dict(vit=dict(patch_size=PATCH, width=DIM, depth=DEPTH,
                                    num_heads=HEADS, mlp_ratio=2.0, class_token=False,
                                    pos_embed="none", rope=True), fixed_input=32),
    "radio_v2": dict(vit=dict(patch_size=PATCH, width=160, depth=DEPTH, num_heads=2,
                              mlp_ratio=2.0, final_norm=True, pos_embed_cls=False,
                              table_grid=(4, 4))),
}


# the plain-ViT families: their entries' own fields at the tiny width
_SHAPE = dict(patch_size=PATCH, width=DIM, depth=DEPTH, num_heads=HEADS, mlp_ratio=2.0)
for _name in ("milan_vitb16", "ibot_vitb16", "mocov3_vitb16", "eva_vitb16", "mae_vitb16",
              "croco_vitb16", "siglip_vitb16", "clip_vitb16"):
    _vit_kw = dict(t_zoo.ZOO[_name].vit, **_SHAPE)
    if _vit_kw.get("table_grid"):
        _vit_kw["table_grid"] = (GRID, GRID)
    if _name == "clip_vitb16":
        _vit_kw["mlp_ratio"] = 4.0  # open_clip's
    TINY[_name] = dict(vit=_vit_kw)
TINY["croco_vitb16"]["fixed_input"] = 32


def _container(name):
    """The entry's released-file layout, at the tiny config."""
    if name == "dino_vitb16":
        return _tiny_timm().state_dict()  # DINO's raw trunk, final norm included
    if name == "crocov2_vitb16":
        return wrap_croco(_tiny_timm(class_token=False).state_dict())
    if name == "milan_vitb16":
        return {"model": _tiny_timm().state_dict()}
    if name == "ibot_vitb16":  # the teacher under module., head junk
        sd = {f"module.{k}": v for k, v in _tiny_timm().state_dict().items()}
        sd["module.head.mlp.0.weight"] = torch.zeros(32, DIM)
        return {"state_dict": sd, "epoch": 100}
    if name == "mocov3_vitb16":
        return wrap_mocov3_vit(_tiny_timm().state_dict())
    if name == "eva_vitb16":
        return timm_to_mmselfsup(_tiny_timm().state_dict())
    if name == "mae_vitb16":  # HF layout, a stored sincos table with a cls row
        sd = _tiny_timm(eps=1e-12).state_dict()
        sd["pos_embed"] = sincos2d_pos_embed(DIM, GRID, cls_row=True)
        return timm_to_hf_mae(sd)
    if name == "croco_vitb16":
        return wrap_croco(_tiny_timm(class_token=False).state_dict())
    if name == "siglip_vitb16":  # timm, no cls token, a patch-only table
        return _tiny_timm(class_token=False, act="gelu_tanh").state_dict()
    if name == "clip_vitb16":
        return clip_container()
    radio = RadioViT(dim=160, depth=DEPTH, heads=2, patch=PATCH, grid=4, mlp_ratio=2.0,
                     seed=13)
    return wrap_radio(radio.state_dict(), mean=(0.1, 0.2, 0.3), std=(0.9, 0.8, 0.7))


def _patch_zoos(monkeypatch, name, tmp_path):
    for zoo in (j_zoo, t_zoo):
        monkeypatch.setitem(zoo.ZOO, name, dataclasses.replace(zoo.ZOO[name], **TINY[name]))
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(tmp_path))

    def no_random_init(*a, **k):
        raise AssertionError("random init ran although a checkpoint is present")

    monkeypatch.setattr(t_zoo, "random_init", no_random_init)
    return os.path.join(tmp_path, t_zoo.ZOO[name].filename)


@pytest.mark.parametrize("name", list(TINY))
def test_zoo_loads_the_file_like_the_jax_zoo(tmp_path, monkeypatch, rng, name):
    path = _patch_zoos(monkeypatch, name, tmp_path)
    torch.save(_container(name), path)
    images = rng.randn(2, 32, 40, 3).astype(np.float32)
    jext = j_zoo.build_vit_extractor(name, return_multilayer=True)
    text = t_zoo.build_vit_extractor(name, return_multilayer=True, device="cpu")
    with F32:
        ref = [np.asarray(f) for f in jext.features(jax.numpy.asarray(images))]
    with torch.no_grad():
        got = [f.numpy() for f in text.features(torch.from_numpy(images))]
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=0)
    assert text.spec.image_mean == jext.spec.image_mean
    assert text.spec.image_std == jext.spec.image_std
    if name == "radio_v2":
        assert text.spec.image_mean == tuple(np.float32([0.1, 0.2, 0.3]))
        assert text.spec.image_std == tuple(np.float32([0.9, 0.8, 0.7]))
    else:
        assert text.spec.image_mean == t_zoo.ZOO[name].image_mean


@pytest.mark.parametrize("drop", ["blocks.2.norm1.weight", "blocks.1.mlp.fc1.bias",
                                  "cls_token", "pos_embed"])
def test_zoo_raises_on_a_file_whose_keys_do_not_match(tmp_path, monkeypatch, drop):
    path = _patch_zoos(monkeypatch, "dino_vitb16", tmp_path)
    sd = _container("dino_vitb16")
    del sd[drop]
    torch.save(sd, path)
    with pytest.raises((KeyError, RuntimeError)):
        t_zoo.build_vit_extractor("dino_vitb16", device="cpu")


def test_zoo_refuses_the_converters_it_lacks(tmp_path, monkeypatch):
    """An architecture no ported family takes (the SD featurizers' U-Net)
    raises, naming the roadmap item; SAM and ConvNeXt load since their
    families were ported."""
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(tmp_path))
    entry = dataclasses.replace(t_zoo.ZOO["dino_vitb16"], arch="sd_unet")
    torch.save({}, os.path.join(tmp_path, entry.filename))
    with pytest.raises(NotImplementedError, match="sd_unet.*section 1, item 5"):
        t_zoo.load_variables(entry, t_vit.ViTConfig())
    variables, extras = t_zoo.load_variables(t_zoo.ZOO["crocov2_vitb16"], t_vit.ViTConfig())
    assert variables is None and extras == {}  # no file: random init, as before
