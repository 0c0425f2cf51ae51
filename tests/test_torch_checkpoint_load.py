"""Released-checkpoint loading in the PyTorch port against the JAX package:

* the port's copies of ``unwrap_checkpoint`` and the ViT and RADIO
  converters give the JAX ones' numpy trees, array for array and exactly,
  on every container of ``tests/test_source_layouts.py`` (the DINO-style
  ``state_dict`` box, MoCo-v3, mmselfsup, HF-MAE, the VISSL and MoCo-v2
  unwraps, CroCo and RADIO), each saved and read back with ``torch.load``;
* one fabricated file per ported backbone (tiny DINO-style, CroCo-v2 and
  RADIO configs: both zoos' entries patched to them) is loaded by both
  zoos: the taps agree within atol 1e-4 (f32; the JAX side under
  ``jax.default_matmul_precision("float32")``), RADIO's mean and std come
  from the input conditioner, equal, and the port's random init never runs;
* a file whose keys do not match makes the port raise, and the converters
  the port lacks raise ``NotImplementedError``.

The containers are made by ``data_processing/torch_replicas.py``."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "data_processing"))

from torch_replicas import (  # noqa: E402
    RadioViT,
    TimmViT,
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


def _container(name):
    """The entry's released-file layout, at the tiny config."""
    if name == "dino_vitb16":
        return _tiny_timm().state_dict()  # DINO's raw trunk, final norm included
    if name == "crocov2_vitb16":
        return wrap_croco(_tiny_timm(class_token=False).state_dict())
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
        assert text.spec.image_mean == t_zoo.IMAGENET_MEAN


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
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(tmp_path))
    entry = dataclasses.replace(t_zoo.ZOO["dino_vitb16"], arch="resnet")
    torch.save({}, os.path.join(tmp_path, entry.filename))
    with pytest.raises(NotImplementedError, match="item 7"):
        t_zoo.load_variables(entry, t_vit.ViTConfig())
    variables, extras = t_zoo.load_variables(t_zoo.ZOO["crocov2_vitb16"], t_vit.ViTConfig())
    assert variables is None and extras == {}  # no file: random init, as before
