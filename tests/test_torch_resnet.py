"""The ResNet-50 zoo of the PyTorch port against the JAX package's:

* ``ResNet50``'s five taps against JAX's from one fabricated torchvision
  state dict (running statistics randomised) converted by both packages'
  ``convert_resnet50`` (the port's tree mapped by
  ``convert.from_jax.resnet_state_dict``), at 64x64 and 96x128, f32:
  max error <= 1e-4 * max|ref|; the two converters' trees equal;
* the fabricated VISSL (SimCLR) and MoCo v2 containers of
  ``data_processing/torch_replicas.py`` loaded strictly by the port's zoo,
  every trunk tensor equal, and the taps against the JAX zoo's;
* every ``*_resnet50`` backbone config instantiated in both packages: the
  same ``feat_dim``, ``patch_size``, ``multilayers`` and
  ``checkpoint_name``, and the same tap shapes;
* the two config spellings that differ from the zoo's names, and a
  ``KeyError`` on an unknown ``checkpoint_name``.

The JAX side runs under ``jax.default_matmul_precision("float32")``."""

import dataclasses
import glob
import os
import sys

import jax
import numpy as np
import pytest
import torch

from midvision_probe_torch.config import compose as t_compose
from midvision_probe_torch.config import instantiate as t_instantiate
from midvision_probe_torch.convert.from_jax import resnet_state_dict
from midvision_probe_torch.models import resnet as t_resnet
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_torch.models.convert import convert_resnet50 as t_convert_resnet50
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.config import instantiate as j_instantiate
from midvision_probe_tpu.models import resnet as j_resnet
from midvision_probe_tpu.models import zoo as j_zoo
from midvision_probe_tpu.models.convert import convert_resnet50 as j_convert_resnet50

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "data_processing"))

from torch_replicas import TorchResNet50, wrap_mocov2, wrap_vissl  # noqa: E402

F32 = jax.default_matmul_precision("float32")
ROOT = os.path.join(os.path.dirname(__file__), "..")
R50_CONFIGS = sorted(os.path.basename(p)[:-5] for p in
                     glob.glob(os.path.join(ROOT, "configs", "backbone", "*resnet50.yaml")))


@pytest.fixture(scope="module")
def trunk():
    return TorchResNet50(seed=3).state_dict()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)])
def test_resnet50_taps_match_jax(trunk, rng, hw):
    jvars = j_convert_resnet50(trunk)
    tvars = t_convert_resnet50(trunk)
    jflat, tflat = dict(_flat(jvars)), dict(_flat(tvars))
    assert list(tflat) == list(jflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k], v, err_msg=str(k))
    module = t_resnet.ResNet50()
    module.load_state_dict(resnet_state_dict(tvars), strict=True)
    images = rng.randn(2, *hw, 3).astype(np.float32)
    with F32:
        ref = j_resnet.ResNet50().apply(jvars, jax.numpy.asarray(images),
                                        taps=(0, 1, 2, 3, 4))
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(images), taps=(0, 1, 2, 3, 4))
    channels = [64, 256, 512, 1024, 2048]
    strides = [4, 4, 8, 16, 32]
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape == (2, -(-hw[0] // strides[i]),
                                             -(-hw[1] // strides[i]), channels[i])
        assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max(), i


def test_resnet50_taps_are_torchvisions(trunk, rng):
    """The port's trunk loads the torchvision-layout state dict itself
    (the same names, without ``num_batches_tracked``) and gives the
    replica's stage outputs."""
    module = t_resnet.ResNet50()
    missing, unexpected = module.load_state_dict(trunk, strict=False)
    assert missing == [] and all(k.endswith("num_batches_tracked") for k in unexpected)
    replica = TorchResNet50(seed=3).eval()
    images = rng.randn(1, 64, 96, 3).astype(np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(images))
        ref = replica(torch.from_numpy(images).permute(0, 3, 1, 2))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.permute(0, 2, 3, 1).numpy(), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("name,wrap", [("simclr_resnet50", wrap_vissl),
                                       ("mocov2_resnet50", wrap_mocov2)])
def test_zoo_loads_the_vissl_and_mocov2_containers(tmp_path, monkeypatch, rng, trunk,
                                                   name, wrap):
    torch.save(wrap(dict(trunk)), tmp_path / t_zoo.ZOO[name].filename)
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(tmp_path))

    def no_random_init(*a, **k):
        raise AssertionError("random init ran although a checkpoint is present")

    monkeypatch.setattr(t_zoo, "random_init", no_random_init)
    text = t_zoo.build_resnet_extractor(name, return_layers=[1, 2, 3, 4],
                                        return_multilayer=True, device="cpu")
    loaded = text.module.state_dict()
    assert set(trunk) - set(loaded) == {k for k in trunk if k.endswith("num_batches_tracked")}
    for k, v in loaded.items():
        assert torch.equal(v, trunk[k]), k
    jext = j_zoo.build_resnet_extractor(name, return_layers=[1, 2, 3, 4],
                                        return_multilayer=True)
    images = rng.randn(1, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        got = text.features(torch.from_numpy(images))
    with F32:
        ref = jext.features(jax.numpy.asarray(images))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max()


@pytest.mark.parametrize("config", R50_CONFIGS)
def test_resnet50_config_builds_in_both_packages(monkeypatch, rng, config):
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", "/nonexistent")
    text = t_instantiate(t_compose("depth_training", [f"backbone={config}"]).backbone,
                         return_multilayer=True, device="cpu")
    jext = j_instantiate(j_compose("depth_training", [f"backbone={config}"]).backbone,
                         return_multilayer=True)
    for attr in ("feat_dim", "patch_size", "multilayers", "checkpoint_name", "arch",
                 "layer", "output"):
        assert getattr(text, attr) == getattr(jext, attr), attr
    assert dataclasses.asdict(text.spec) == dataclasses.asdict(jext.spec)
    images = rng.randn(1, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        got = text.features(torch.from_numpy(images))
    ref = jext.features(jax.numpy.asarray(images))
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref]


def test_resnet_name_aliases_and_unknown_names(monkeypatch):
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", "/nonexistent")
    assert len(R50_CONFIGS) == 17
    for alias, name in (("deepcluster_v2_resnet50", "deepclusterv2_resnet50"),
                        ("sela_v2_resnet50", "selav2_resnet50")):
        assert t_zoo._RESNET_NAME_ALIASES[alias] == j_zoo._RESNET_NAME_ALIASES[alias] == name
        ext = t_zoo.DEEPCLUSTERV2(checkpoint_name=alias, device="cpu")
        assert ext.checkpoint_name == f"{name}_dense_[0, 1, 2, 3, 4]"
        assert ext.feat_dim == (2048, 15)  # the last (C, hw) pair without multilayer
    with pytest.raises(KeyError, match="not a zoo entry"):
        t_zoo.SIMCLR(checkpoint_name="simclr_resnet_typo", device="cpu")
    with pytest.raises(KeyError, match="not a zoo entry"):
        j_zoo.SIMCLR(checkpoint_name="simclr_resnet_typo")
