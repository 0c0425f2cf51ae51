"""The SD featurizers end to end: ``DIFT`` and ``Zero123`` built from
``configs/backbone/{dift,zero123}.yaml`` by both packages' ``instantiate``,
both featurizer modules patched to tiny configs (4 UNet levels of 8 and
16 channels, a 2-level VAE, a 1-layer text tower of width 12), on the same
weights: the port's seeded init written out as the JAX trees (JAX's own
eager init of a UNet costs tens of seconds of op compiles on the CPU).

The JAX featurizers draw their noise inside their jit from
``PRNGKey(noise_seed)``; the port is handed the same draw, made with JAX
outside the jit, so each comparison also shows that this reproduces the
JAX featurizer's own output. Covered: ``dense`` and ``gap``,
``return_multilayer`` on and off, the empty prompt through the text tower
(fabricated ``vocab.json``/``merges.txt``) and without the files (zeros; a
broken file raises in the port), and Zero123's ``cond_embedding`` and
guided features with a fabricated CLIP conditioning tower. float32 within
1e-4 relative; the JAX side runs under ``jax.default_matmul_precision
("float32")``."""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from midvision_probe_torch.config import compose as t_compose
from midvision_probe_torch.config import instantiate as t_instantiate
from midvision_probe_torch.models.sd import featurizer as t_feat
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.config import instantiate as j_instantiate
from midvision_probe_tpu.models.sd import featurizer as j_feat

sys.path.insert(0, os.path.dirname(__file__))

from test_convert_extra import _CLIPVisual  # noqa: E402
from test_torch_sd import _flax_tree  # noqa: E402

F32 = jax.default_matmul_precision("float32")
UNET = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, cross_attention_dim=12,
            head_dim=4, norm_groups=4)
VAE = dict(block_out_channels=(8, 16), layers_per_block=1, latent_channels=4, norm_groups=4)
TEXT = dict(vocab_size=600, hidden_size=12, num_layers=1, num_heads=2)
HW = (64, 96)  # latents 32x48 through the 2-level VAE; dense taps on the 4x6 grid


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """Both featurizer modules on the tiny configs, an empty checkpoint
    directory, and the JAX featurizers' ``_load`` handing over the trees
    that the test sets in ``trees``. One torch intra-op thread, restored
    after: beside the other workers of a parallel test run the cores are
    oversubscribed, and torch's thread barriers then slow its many small
    ops by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(tmp_path))
    for mod in (t_feat, j_feat):
        monkeypatch.setattr(mod, "UNetConfig", functools.partial(mod.UNetConfig, **UNET))
        monkeypatch.setattr(mod, "VAEEncoderConfig",
                            functools.partial(mod.VAEEncoderConfig, **VAE))
        monkeypatch.setattr(mod, "CLIPTextConfig", functools.partial(mod.CLIPTextConfig, **TEXT))
    trees = {}

    def load(self, *_):
        for k, v in trees.items():
            setattr(self, k, v)
        self.clip_vars = self.clip_proj = self.cc_proj = None

    monkeypatch.setattr(j_feat.SDFeaturizer, "_load", load)
    monkeypatch.setattr(j_feat.Zero123, "_load", load)
    yield tmp_path, trees
    torch.set_num_threads(threads)


def _backbone(pkg, name, **kw):
    compose, instantiate = (t_compose, t_instantiate) if pkg == "t" else (j_compose, j_instantiate)
    cfg = compose("depth_training", [f"backbone={name}"]).backbone
    return instantiate(cfg, **({"device": "cpu"} if pkg == "t" else {}), **kw)


def _port_trees(modules: dict) -> dict:
    """Seeded weights for the port's modules, and the same as JAX trees."""
    return {k: _flax_tree(m, seed=i) for i, (k, m) in enumerate(modules.items())}


def _images(n=2, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, *HW, 3)).astype(np.float32)


def _jax_noise(shape, seed=0):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def _close(got, ref, rtol=1e-4):
    got = got if isinstance(got, list) else [got]
    ref = ref if isinstance(ref, list) else [ref]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol, atol=rtol * float(np.abs(r).max()))


def _write_tokenizer(d):
    from test_sd_tokenizer import bytes_to_unicode

    os.makedirs(d, exist_ok=True)
    byte_vocab = list(bytes_to_unicode().values())
    merges = [("a", "</w>"), ("p", "h"), ("o", "t")]
    tokens = byte_vocab + [v + "</w>" for v in byte_vocab] + ["".join(m) for m in merges]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def test_dift_matches_jax(tiny):
    ckpt, trees = tiny
    port = _backbone("t", "dift", return_multilayer=True)
    assert (port.arch, port.patch_size, port.checkpoint_name) == (
        "diffusion", 16, "stable-diffusion-2-1_noise-1")
    f = port.featurizer
    trees.update({f"{k}_vars": v for k, v in _port_trees(
        {"unet": f.unet, "vae": f.vae, "text": f.text}).items()})
    jft = _backbone("j", "dift", return_multilayer=True)
    images = _images()
    noise = _jax_noise((2, HW[0] // 2, HW[1] // 2, 4))

    # the empty prompt's context: zeros without tokenizer files, then the
    # text tower's once they are there
    for tokenizer in (False, True):
        if tokenizer:
            _write_tokenizer(ckpt / "sd21" / "tokenizer")
            port._empty_embed = jft._empty_embed = None
        with F32:
            jemb = np.asarray(jft._prompt_embeds(2))
        temb = port._prompt_embeds(2)
        assert tuple(temb.shape) == (2, 77, 12) and (np.abs(jemb).max() > 0) == tokenizer
        _close(temb, jemb)

    with F32:
        ref = jft(jnp.asarray(images))  # its own noise, drawn inside its jit
    got = port(torch.from_numpy(images), noise=noise)
    assert [tuple(g.shape) for g in got] == [(2, 4, 6, c) for c in (16, 16, 8, 8)]
    _close(got, ref)

    # gap, and one tap, from the same JAX executable
    for output, layer in (("gap", None), ("dense", 1)):
        jft.output = output
        if layer is not None:
            jft.multilayers = [layer]
        with F32:
            ref = jft(jnp.asarray(images))
        other = _backbone("t", "dift", output=output,
                          **({"return_multilayer": True} if layer is None else {}))
        for name in ("unet", "vae", "text"):
            getattr(other.featurizer, name).load_state_dict(
                getattr(f, name).state_dict(), strict=True)
        assert other.layer == ("0-1-2-3" if layer is None else "1")
        _close(other(torch.from_numpy(images), noise=noise), ref)


def test_dift_narrows_the_prompt_fallback(tiny):
    """Missing tokenizer files give zeros (with a warning); a broken file
    raises in the port, where the JAX package returns zeros too."""
    ckpt, _ = tiny
    port = _backbone("t", "dift")
    assert port.feat_dim == 1280 and port.layer == "1" and port.output == "dense"
    assert float(port._prompt_embeds(1, prompts=["a photo"]).abs().max()) == 0.0
    d = ckpt / "sd21" / "tokenizer"
    os.makedirs(d)
    (d / "vocab.json").write_text("{not json")
    with pytest.raises(json.JSONDecodeError):
        port._prompt_embeds(1, prompts=["a photo"])


def _conditioning_state_dict(width=64, depth=2, patch=8, emb=48):
    torch.manual_seed(5)
    tower = _CLIPVisual(d=width, heads=1, depth=depth, patch=patch, img=224).eval()
    ln_post = nn.LayerNorm(width, eps=1e-5)
    with torch.no_grad():
        ln_post.weight.normal_(1.0, 0.05)
        ln_post.bias.normal_(0.0, 0.05)
    cc = nn.Linear(emb + 4, 768)
    pre = "cond_stage_model.model.visual."
    sd = {pre + k: v for k, v in tower.state_dict().items()}
    sd.update({pre + "ln_post.weight": ln_post.weight.data, pre + "ln_post.bias": ln_post.bias.data,
               pre + "proj": torch.randn(width, emb) * 0.05,
               "cc_projection.weight": cc.weight.data, "cc_projection.bias": cc.bias.data})
    return sd


def test_zero123_matches_jax(tiny):
    _, trees = tiny
    port = _backbone("t", "zero123", return_multilayer=True)
    assert port.checkpoint_name == "zero123_t-1" and port.unet_cfg.num_heads == 8
    trees.update({f"{k}_vars": v for k, v in _port_trees(
        {"unet": port.unet, "vae": port.vae}).items()})
    jz = _backbone("j", "zero123", return_multilayer=True)
    sd = _conditioning_state_dict()
    port._load_conditioning(sd)
    jz._load_conditioning(sd)
    assert port.clip_cfg.width == jz.clip_cfg.width == 64 and port.clip_cfg.depth == 2
    images = _images()
    with F32:
        jctx = jz.cond_embedding(jnp.asarray(images))
        ref = jz(jnp.asarray(images))
    _close(port.cond_embedding(torch.from_numpy(images)), jctx)
    got = port(torch.from_numpy(images), noise=_jax_noise((2, HW[0] // 2, HW[1] // 2, 4)))
    assert [tuple(g.shape) for g in got] == [(2, 4, 6, c) for c in (16, 16, 8, 8)]
    _close(got, ref)
