"""ConvNeXt in the PyTorch port against the JAX package's:

* a narrow ``ConvNeXt`` (depths (1, 1, 2, 1), dims (16, 32, 64, 128)), v1
  (layer-scale ``gamma``) and v2 (GRN), from random weights carried across
  by ``convert.from_jax.convnext_state_dict``: the four stage taps within
  1e-5 * max|ref| in float32, within 2^-5 * max|ref| in bfloat16 (GRN's
  f32 ``grn_gamma``/``grn_beta`` kept f32 by the zoo's cast). Through the
  whole network bf16 rounding of every layer hides GRN's order: over four
  seeds the largest error was 1.3e-2 * max|ref|, and a control with GRN
  in plain f32 read the same;
* so GRN's bf16 order alone, in one block whose GELU both packages replace
  by the same bf16 tensor, its input zero and ``pwconv2`` a 0/1 selection
  (every step but GRN exact): over five seeds at most 6.1e-5 of the
  outputs differ, by at most 8.3e-5 * max|ref|; the f32-GRN control
  differs in 28-40% of them, by 3.4e-3 to 5.7e-3 * max|ref|. The limits,
  1e-3 of the outputs and 2^-10 * max|ref|, lie between;
* the extractor's ``dense`` (every stage bilinearly resized in f32 to the
  /16 grid), ``gap`` and ``raw`` outputs from one fabricated timm file
  loaded by both zoos (the config narrowed in both packages), within
  1e-5 * max|ref|, and no random init in the port;
* the converter on timm, FB and open_clip-prefixed containers (the
  ``_TorchConvNeXt`` replica of ``tests/test_convert_extra.py``): the JAX
  converter's tree, array for array and exactly, and both zoos'
  ``load_variables`` give one tree from one file.

The JAX side runs under ``jax.default_matmul_precision("float32")``."""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.convert.from_jax import convnext_state_dict
from midvision_probe_torch.models import convnext as t_convnext
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_torch.models.convert import convert_convnext as t_convert
from midvision_probe_tpu.models import convnext as j_convnext
from midvision_probe_tpu.models import zoo as j_zoo
from midvision_probe_tpu.models.convert.convnext_convert import convert_convnext as j_convert

sys.path.insert(0, os.path.dirname(__file__))

from test_convert_extra import _TorchConvNeXt  # noqa: E402

F32 = jax.default_matmul_precision("float32")
NARROW = dict(depths=(1, 1, 2, 1), dims=(16, 32, 64, 128))


def _random_like(tree, rng):
    return jax.tree_util.tree_map(
        lambda x: (0.1 * rng.randn(*np.shape(x))).astype(np.float32), tree)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_same_tree(got, ref):
    g, r = dict(_flat(got)), dict(_flat(ref))
    assert g.keys() == r.keys()
    for k in r:
        assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
        np.testing.assert_array_equal(g[k], r[k], err_msg=str(k))


def _assert_close(got, ref, rel):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("use_grn", [False, True], ids=["v1_gamma", "v2_grn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convnext_taps_match_jax(rng, use_grn, dtype):
    jcfg = j_convnext.ConvNeXtConfig(use_grn=use_grn, dtype=getattr(jnp, dtype), **NARROW)
    images = rng.randn(2, 64, 96, 3).astype(np.float32)
    jmod = j_convnext.ConvNeXt(jcfg)
    variables = _random_like(jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(images)),
                             rng)
    with F32:
        ref = jax.jit(jmod.apply)(variables, jnp.asarray(images))

    tmod = t_convnext.ConvNeXt(t_convnext.ConvNeXtConfig(use_grn=use_grn, **NARROW))
    tmod.load_state_dict(convnext_state_dict(variables), strict=True)
    tmod = t_zoo._cast(tmod, "cpu", dtype, keep_f32=t_convnext.KEEP_F32)
    if use_grn:
        assert tmod.stages[0][0].grn_gamma.dtype == torch.float32
    assert tmod.stages[0][0].pwconv1.weight.dtype == getattr(torch, dtype)
    with torch.no_grad():
        got = tmod(torch.from_numpy(images))
    shapes = [(2, 16, 24, 16), (2, 8, 12, 32), (2, 4, 6, 64), (2, 2, 3, 128)]
    assert [tuple(t.shape) for t in got] == shapes
    for g, r in zip(got, ref):
        assert g.dtype == getattr(torch, dtype)
        _assert_close(g.float().numpy(), r, 1e-5 if dtype == "float32" else 2**-5)


def test_grn_keeps_the_jax_bf16_order(rng, monkeypatch):
    dim, c4, hw = 64, 256, (16, 24)
    H = rng.randn(2, *hw, c4).astype(np.float32)  # what GELU hands GRN
    monkeypatch.setattr(j_convnext, "gelu", lambda h: jnp.asarray(H, h.dtype))
    monkeypatch.setattr(t_convnext, "gelu", lambda h: torch.from_numpy(H).to(h.dtype))
    params = {
        "dwconv": {"kernel": rng.randn(7, 7, 1, dim).astype(np.float32),
                   "bias": np.zeros(dim, np.float32)},
        "norm": {"scale": np.ones(dim, np.float32), "bias": np.zeros(dim, np.float32)},
        "pwconv1": {"kernel": rng.randn(dim, c4).astype(np.float32),
                    "bias": np.zeros(c4, np.float32)},
        "pwconv2": {"kernel": np.eye(c4, dim, dtype=np.float32),
                    "bias": np.zeros(dim, np.float32)},
        "grn_gamma": rng.randn(c4).astype(np.float32),
        "grn_beta": (0.1 * rng.randn(c4)).astype(np.float32)}
    x = np.zeros((2, *hw, dim), np.float32)
    cfg = dict(depths=(1,), dims=(dim,), use_grn=True)
    jblock = j_convnext.ConvNeXtBlock(j_convnext.ConvNeXtConfig(dtype=jnp.bfloat16, **cfg), dim)
    with F32:
        ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)),
                         np.float32)
    tblock = t_convnext.ConvNeXtBlock(t_convnext.ConvNeXtConfig(**cfg), dim)
    sd = {"dwconv.weight": params["dwconv"]["kernel"].transpose(3, 2, 0, 1),
          "dwconv.bias": params["dwconv"]["bias"], "norm.weight": params["norm"]["scale"],
          "norm.bias": params["norm"]["bias"], "pwconv1.weight": params["pwconv1"]["kernel"].T,
          "pwconv1.bias": params["pwconv1"]["bias"],
          "pwconv2.weight": params["pwconv2"]["kernel"].T,
          "pwconv2.bias": params["pwconv2"]["bias"], "grn_gamma": params["grn_gamma"],
          "grn_beta": params["grn_beta"]}
    tblock.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    tblock = t_zoo._cast(tblock, "cpu", "bfloat16", keep_f32=t_convnext.KEEP_F32)
    with torch.no_grad():
        got = tblock(torch.from_numpy(x).bfloat16()).float().numpy()
    assert got.shape == ref.shape == (2, *hw, dim)
    assert (got != ref).mean() <= 1e-3
    assert np.abs(got - ref).max() <= 2**-10 * np.abs(ref).max()


def _timm_container(seed, use_grn=False, arch=NARROW):
    """The ``_TorchConvNeXt`` replica in timm naming (``stem.1`` for its
    stem norm) at ``arch``'s depths and widths, random weights throughout
    (gamma and GRN included)."""
    torch.manual_seed(seed)
    t = _TorchConvNeXt(depths=arch["depths"], dims=arch["dims"])
    sd = {k.replace("stem_norm", "stem.1"): torch.randn_like(v) * 0.1
          for k, v in t.state_dict().items()}
    if use_grn:  # timm convnextv2: mlp.grn, no gamma
        for k in [k for k in sd if k.endswith(".gamma")]:
            dim = sd.pop(k).shape[0]
            base = k[:-len("gamma")]
            sd[base + "mlp.grn.weight"] = torch.randn(4 * dim) * 0.1
            sd[base + "mlp.grn.bias"] = torch.randn(4 * dim) * 0.1
    sd["head.fc.weight"] = torch.zeros(10, arch["dims"][-1])  # classifier junk
    return sd


def _fb_naming(sd):
    """timm names -> the FB repo's (``downsample_layers``, ``stages.N.M``,
    ``dwconv``/``pwconv1``/``pwconv2``, ``grn.gamma``/``grn.beta``)."""
    out = {}
    for k, v in sd.items():
        k = k.replace("stem.0.", "downsample_layers.0.0.").replace(
            "stem.1.", "downsample_layers.0.1.")
        for s in range(1, 4):
            k = k.replace(f"stages.{s}.downsample.", f"downsample_layers.{s}.")
        k = k.replace(".blocks.", ".").replace("conv_dw", "dwconv")
        k = k.replace("mlp.fc1", "pwconv1").replace("mlp.fc2", "pwconv2")
        if "mlp.grn." in k:
            k = k.replace("mlp.grn.weight", "grn.gamma").replace("mlp.grn.bias", "grn.beta")
            v = v.reshape(1, 1, 1, -1)
        out[k] = v
    return out


def _openclip(sd):
    out = {f"visual.trunk.{k}": v for k, v in sd.items()}
    out["visual.head.proj.weight"] = torch.zeros(8, 16)
    out["token_embedding.weight"] = torch.zeros(16, 8)
    out["text_projection"] = torch.zeros(8, 8)
    return out


@pytest.mark.parametrize("layout", ["timm", "fb", "openclip"])
@pytest.mark.parametrize("use_grn", [False, True], ids=["v1_gamma", "v2_grn"])
def test_converter_gives_the_jax_tree(layout, use_grn):
    sd = _timm_container(3, use_grn)
    prefix = ""
    if layout == "fb":
        sd = _fb_naming(sd)
        assert "downsample_layers.2.1.weight" in sd and "stages.2.1.pwconv1.weight" in sd
    elif layout == "openclip":
        sd, prefix = _openclip(sd), "visual.trunk."
    t_cfg = t_convnext.ConvNeXtConfig(use_grn=use_grn, **NARROW)
    j_cfg = j_convnext.ConvNeXtConfig(use_grn=use_grn, **NARROW)
    tree = t_convert(sd, t_cfg, prefix=prefix)
    _assert_same_tree(tree, j_convert(sd, j_cfg, prefix=prefix))
    # the tree loads strictly into the port's module
    t_convnext.ConvNeXt(t_cfg).load_state_dict(convnext_state_dict(tree), strict=True)


def _narrow_zoos(monkeypatch):
    for mod in (t_convnext, j_convnext):
        monkeypatch.setattr(mod, "ConvNeXtConfig",
                            functools.partial(mod.ConvNeXtConfig, **NARROW))


@pytest.mark.parametrize("name", ["cnxt_b_in22k", "cnxt_b_fcmae", "cnxt_b_w_laion2b"])
def test_both_zoos_load_one_file_to_one_tree(tmp_path, monkeypatch, name):
    entry = t_zoo.ZOO[name]
    use_grn = "fcmae" in name
    sd = _timm_container(5, use_grn)
    if entry.prefix:
        sd = _openclip(sd)
    torch.save(sd, tmp_path / entry.filename)
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(tmp_path))
    tree, _ = t_zoo.load_variables(entry, t_convnext.ConvNeXtConfig(use_grn=use_grn, **NARROW))
    jtree, _ = j_zoo.load_variables(j_zoo.ZOO[name],
                                    j_convnext.ConvNeXtConfig(use_grn=use_grn, **NARROW))
    _assert_same_tree(tree, jtree)


@pytest.mark.parametrize("output", ["dense", "gap", "raw"])
def test_extractor_outputs_match_the_jax_zoo(tmp_path, monkeypatch, rng, output):
    name = "cnxt_b_fcmae"  # GRN
    torch.save(_timm_container(7, use_grn=True), tmp_path / t_zoo.ZOO[name].filename)
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(tmp_path))
    _narrow_zoos(monkeypatch)

    def no_random_init(*a, **k):
        raise AssertionError("random init ran although a checkpoint is present")

    monkeypatch.setattr(t_zoo, "random_init", no_random_init)
    text = t_zoo.build_convnext_extractor(name, output=output, return_multilayer=True,
                                          device="cpu")
    jext = j_zoo.build_convnext_extractor(name, output=output, return_multilayer=True)
    assert dataclasses.asdict(text.spec) == dataclasses.asdict(jext.spec)
    assert text.feat_dim == list(NARROW["dims"])
    images = rng.randn(2, 80, 112, 3).astype(np.float32)
    got = text(torch.from_numpy(images))
    with F32:
        ref = jext(jnp.asarray(images))
    shapes = {"dense": [(2, 5, 7, d) for d in NARROW["dims"]],
              "gap": [(2, d) for d in NARROW["dims"]],
              "raw": [(2, 20, 28, 16), (2, 10, 14, 32), (2, 5, 7, 64), (2, 2, 3, 128)]}
    assert [tuple(g.shape) for g in got] == shapes[output]
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        _assert_close(g.numpy(), r, 1e-5)
