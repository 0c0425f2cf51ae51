"""The port's SD modules against the JAX package's at tiny widths, on the
same weights: a seeded port init written out as the flax tree
(``_flax_tree``), which the JAX module applies and ``convert.from_jax``
loads strictly into a fresh port module (JAX's own init of a UNet costs
tens of seconds of op compiles on the CPU). The text
tower, the VAE encoder, the UNet on an even and on an odd latent grid (the
8 -> 15 upsample), the LDM UNet with a fixed head count,
``timestep_embedding``, and the converters' numpy trees on the same
fabricated diffusers, transformers and LDM state dicts. f32, 1e-4
relative; the JAX side runs under ``jax.default_matmul_precision
("float32")``."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from midvision_probe_torch.convert.from_jax import (
    sd_text_state_dict,
    sd_unet_state_dict,
    sd_vae_state_dict,
)
from midvision_probe_torch.models.sd import convert as t_convert
from midvision_probe_torch.models.sd.featurizer import init_sd_
from midvision_probe_torch.models.sd import text_encoder as t_text
from midvision_probe_torch.models.sd import unet as t_unet
from midvision_probe_torch.models.sd import vae as t_vae
from midvision_probe_tpu.models.sd import convert as j_convert
from midvision_probe_tpu.models.sd import text_encoder as j_text
from midvision_probe_tpu.models.sd import unet as j_unet
from midvision_probe_tpu.models.sd import vae as j_vae

sys.path.insert(0, os.path.dirname(__file__))

from test_sd import TTinyUNet, TTinyVAE  # noqa: E402

F32 = jax.default_matmul_precision("float32")
G = 4  # tiny group count
UNET = dict(block_out_channels=(8, 16), layers_per_block=1, cross_attention_dim=12,
            head_dim=4, norm_groups=G)


def _flax_tree(module: nn.Module, seed: int = 0) -> dict:
    """A seeded init of ``module`` (flax's distributions, and biases and
    norm parameters perturbed so that their mapping shows) as the JAX
    module's variables."""
    gen = torch.Generator().manual_seed(seed)
    init_sd_(module, gen)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim == 1 or name.endswith("position_embedding"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    tree: dict = {}
    for name, mod in module.named_modules():
        own = {k: p.detach().numpy() for k, p in mod.named_parameters(recurse=False)}
        if not own:
            continue
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            w = own.pop("weight")
            own["kernel"] = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
        elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
            own["scale"] = own.pop("weight")
        elif isinstance(mod, nn.Embedding):
            own["embedding"] = own.pop("weight")
        node = tree
        for part in filter(None, name.split(".")):
            node = node.setdefault(part, {})
        node.update({k: np.ascontiguousarray(v) for k, v in own.items()})
    return {"params": tree}


def _same_weights(make):
    """A JAX module's variables and a port module carrying them."""
    variables = _flax_tree(make())
    port = make()
    return variables, port


def _close(got: torch.Tensor, ref, rtol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("act", ["gelu", "quickgelu"])
def test_text_encoder_matches_jax(act):
    kw = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4, max_positions=16,
              act=act)
    ids = np.random.RandomState(0).randint(0, 100, size=(2, 16)).astype(np.int32)
    variables, tm = _same_weights(lambda: t_text.CLIPTextEncoder(t_text.CLIPTextConfig(**kw)))
    tm.load_state_dict(sd_text_state_dict(variables), strict=True)
    with F32:
        ref = jax.jit(j_text.CLIPTextEncoder(j_text.CLIPTextConfig(**kw)).apply)(
            variables, jnp.asarray(ids))
    with torch.no_grad():
        _close(tm(torch.from_numpy(ids)), ref)


def test_vae_encoder_matches_jax():
    cfg = dict(block_out_channels=(8, 16), layers_per_block=1, latent_channels=4,
               norm_groups=G)
    x = np.random.RandomState(0).uniform(-1, 1, (2, 24, 20, 3)).astype(np.float32)
    variables, tm = _same_weights(lambda: t_vae.VAEEncoder(t_vae.VAEEncoderConfig(**cfg)))
    tm.load_state_dict(sd_vae_state_dict(variables), strict=True)
    with F32:
        ref = jax.jit(j_vae.VAEEncoder(j_vae.VAEEncoderConfig(**cfg)).apply)(
            variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 12, 10, 4)
    _close(got, ref)


@pytest.mark.parametrize("case", ["even", "odd_grid", "ldm_num_heads"])
def test_unet_matches_jax(case):
    """The taps of every up block. ``odd_grid``: 15x20 latents go down to
    8x10 and back up to 15x20, where a plain nearest resize picks other
    rows than jax.image.resize; ``ldm_num_heads``: Zero123's 8-channel
    input and fixed head count (2 heads of 4 and of 8)."""
    cfg = dict(UNET)
    hw, cin = {"even": ((8, 8), 4), "odd_grid": ((15, 20), 4),
               "ldm_num_heads": ((6, 10), 8)}[case]
    if case == "ldm_num_heads":
        cfg.update(in_channels=8, num_heads=2)
    rng = np.random.RandomState(0)
    x = rng.randn(2, *hw, cin).astype(np.float32)
    ctx = rng.randn(2, 5, 12).astype(np.float32)
    ts = np.array([7, 250], np.int32)
    variables, tm = _same_weights(lambda: t_unet.UNet2DCondition(t_unet.UNetConfig(**cfg)))
    tm.load_state_dict(sd_unet_state_dict(variables), strict=True)
    with F32:
        ref = jax.jit(j_unet.UNet2DCondition(j_unet.UNetConfig(**cfg)).apply)(
            variables, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))["up_ft"]
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    assert tuple(got[-1].shape[1:3]) == hw
    for g, r in zip(got, ref):
        _close(g, r)


def test_upsample_to_an_odd_grid_is_nearest_exact():
    """The UNet's 8x10 -> 15x20 upsample: jax.image.resize "nearest" is
    torch's "nearest-exact"; plain "nearest" differs there."""
    x = np.random.RandomState(0).randn(1, 8, 10, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 15, 20, 3), "nearest"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    exact = F.interpolate(xt, size=(15, 20), mode="nearest-exact").permute(0, 2, 3, 1)
    plain = F.interpolate(xt, size=(15, 20), mode="nearest").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(exact.numpy(), ref)
    assert (plain.numpy() != ref).any()


def test_timestep_embedding_matches_jax():
    """Both in float32. XLA's float32 exp is one ulp off the correctly
    rounded value in 18 of SD's 160 frequencies, which t = 999 turns into
    up to 6e-5 in a sinusoid: within 1e-4 of the unit maximum."""
    t = np.array([0, 1, 250, 999], np.int32)
    for dim in (8, 320):
        ref = np.asarray(j_unet.timestep_embedding(jnp.asarray(t), dim))
        got = t_unet.timestep_embedding(torch.from_numpy(t), dim)
        assert got.dtype == torch.float32
        _close(got, ref)


# ---------------------------------------------------------------- converters
_LDM_UNET = {
    "time_embedding.linear_1": "time_embed.0", "time_embedding.linear_2": "time_embed.2",
    "conv_in": "input_blocks.0.0", "down_blocks.0.resnets.0": "input_blocks.1.0",
    "down_blocks.0.attentions.0": "input_blocks.1.1",
    "down_blocks.0.downsamplers.0.conv": "input_blocks.2.0.op",
    "down_blocks.1.resnets.0": "input_blocks.3.0", "mid_block.resnets.0": "middle_block.0",
    "mid_block.attentions.0": "middle_block.1", "mid_block.resnets.1": "middle_block.2",
    "up_blocks.0.resnets.0": "output_blocks.0.0", "up_blocks.0.resnets.1": "output_blocks.1.0",
    "up_blocks.0.upsamplers.0.conv": "output_blocks.1.1.conv",
    "up_blocks.1.resnets.0": "output_blocks.2.0", "up_blocks.1.attentions.0": "output_blocks.2.1",
    "up_blocks.1.resnets.1": "output_blocks.3.0", "up_blocks.1.attentions.1": "output_blocks.3.1",
}
_LDM_RESNET = {"norm1": "in_layers.0", "conv1": "in_layers.2", "time_emb_proj": "emb_layers.1",
               "norm2": "out_layers.0", "conv2": "out_layers.3",
               "conv_shortcut": "skip_connection"}
_LDM_VAE = {
    "encoder.down_blocks.0.resnets.0": "encoder.down.0.block.0",
    "encoder.down_blocks.0.downsamplers.0.conv": "encoder.down.0.downsample.conv",
    "encoder.down_blocks.1.resnets.0": "encoder.down.1.block.0",
    "encoder.mid_block.resnets.0": "encoder.mid.block_1",
    "encoder.mid_block.resnets.1": "encoder.mid.block_2",
    "encoder.mid_block.attentions.0.group_norm": "encoder.mid.attn_1.norm",
    "encoder.mid_block.attentions.0.to_q": "encoder.mid.attn_1.q",
    "encoder.mid_block.attentions.0.to_k": "encoder.mid.attn_1.k",
    "encoder.mid_block.attentions.0.to_v": "encoder.mid.attn_1.v",
    "encoder.mid_block.attentions.0.to_out.0": "encoder.mid.attn_1.proj_out",
    "encoder.conv_norm_out": "encoder.norm_out",
}


def _rename(sd, table, sub=None):
    out = {}
    for k, v in sd.items():
        block = max((b for b in table if k.startswith(b + ".")), key=len, default=None)
        rest = k[len(block):] if block else "." + k
        if sub and block and "resnets" in block:
            for a, b in sub.items():
                rest = rest.replace(f".{a}.", f".{b}.")
        out[(table[block] if block else "") + rest] = v
    return {k.lstrip("."): v for k, v in out.items()}


def _ldm_vae(sd):
    sd = _rename(sd, _LDM_VAE, {"conv_shortcut": "nin_shortcut"})
    # the LDM VAE's attention projections are 1x1 convolutions
    return {"first_stage_model." + k: (v[:, :, None, None] if ".attn_1." in k and v.ndim == 2
                                       else v) for k, v in sd.items()}


def _assert_same_tree(got, ref):
    gl, rl = jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in gl] == [p for p, _ in rl]
    for (p, g), (_, r) in zip(gl, rl):
        assert g.dtype == r.dtype == np.float32, p
        np.testing.assert_array_equal(g, r, err_msg=str(p))


def test_converters_match_the_jax_package():
    torch.manual_seed(4)
    unet_sd = TTinyUNet().state_dict()
    vae_sd = TTinyVAE(latent=4).state_dict()
    ju, tu = j_unet.UNetConfig(**UNET), t_unet.UNetConfig(**UNET)
    vkw = dict(block_out_channels=(8, 16), layers_per_block=1, latent_channels=4, norm_groups=G)
    jv, tv = j_vae.VAEEncoderConfig(**vkw), t_vae.VAEEncoderConfig(**vkw)
    _assert_same_tree(t_convert.convert_unet(unet_sd, tu), j_convert.convert_unet(unet_sd, ju))
    _assert_same_tree(t_convert.convert_vae_encoder(vae_sd, tv),
                      j_convert.convert_vae_encoder(vae_sd, jv))
    ldm_unet = {"model.diffusion_model." + k: v
                for k, v in _rename(unet_sd, _LDM_UNET, _LDM_RESNET).items()}
    _assert_same_tree(t_convert.convert_unet_ldm(ldm_unet, tu),
                      j_convert.convert_unet_ldm(ldm_unet, ju))
    ldm_vae = _ldm_vae(vae_sd)
    _assert_same_tree(t_convert.convert_vae_encoder_ldm(ldm_vae, tv),
                      j_convert.convert_vae_encoder_ldm(ldm_vae, jv))
    # the LDM and diffusers layouts give one tree, which loads strictly
    _assert_same_tree(t_convert.convert_vae_encoder_ldm(ldm_vae, tv),
                      t_convert.convert_vae_encoder(vae_sd, tv))
    t_vae.VAEEncoder(tv).load_state_dict(
        sd_vae_state_dict(t_convert.convert_vae_encoder_ldm(ldm_vae, tv)), strict=True)
    t_unet.UNet2DCondition(tu).load_state_dict(
        sd_unet_state_dict(t_convert.convert_unet_ldm(ldm_unet, tu)), strict=True)

    kw = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4, max_positions=16)
    text_sd = hf_text_state_dict(**kw)
    tree = t_convert.convert_text_encoder(text_sd, t_text.CLIPTextConfig(**kw))
    _assert_same_tree(tree, j_convert.convert_text_encoder(text_sd, j_text.CLIPTextConfig(**kw)))
    t_text.CLIPTextEncoder(t_text.CLIPTextConfig(**kw)).load_state_dict(
        sd_text_state_dict(tree), strict=True)


def test_featurizers_load_their_checkpoint_files(tmp_path, monkeypatch):
    """``sd21/{unet,vae,text_encoder}.bin`` (diffusers and transformers
    layouts) and ``zero123/105000.ckpt`` (LDM layout, with a conditioning
    tower) load strictly: every tensor is the converter's."""
    from midvision_probe_torch.models.sd import featurizer as t_feat
    from test_convert_extra import _CLIPVisual

    monkeypatch.setenv("MVP_CHECKPOINT_DIR", str(tmp_path))
    torch.manual_seed(4)
    unet_sd, vae_sd = TTinyUNet().state_dict(), TTinyVAE(latent=4).state_dict()
    tkw = dict(vocab_size=100, hidden_size=12, num_layers=1, num_heads=2, max_positions=77)
    text_sd = hf_text_state_dict(**tkw)
    os.makedirs(tmp_path / "sd21")
    for name, sd in (("unet", unet_sd), ("vae", vae_sd), ("text_encoder", text_sd)):
        torch.save(sd, tmp_path / "sd21" / f"{name}.bin")
    ucfg = t_unet.UNetConfig(**UNET)
    vcfg = t_vae.VAEEncoderConfig(block_out_channels=(8, 16), layers_per_block=1,
                                  latent_channels=4, norm_groups=G)
    feat = t_feat.SDFeaturizer(unet_cfg=ucfg, vae_cfg=vcfg,
                               text_cfg=t_text.CLIPTextConfig(**tkw), device="cpu")
    for module, want in ((feat.unet, sd_unet_state_dict(t_convert.convert_unet(unet_sd, ucfg))),
                         (feat.vae, sd_vae_state_dict(t_convert.convert_vae_encoder(vae_sd, vcfg))),
                         (feat.text, sd_text_state_dict(t_convert.convert_text_encoder(
                             text_sd, t_text.CLIPTextConfig(**tkw))))):
        got = module.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)

    unet8 = TTinyUNet(ctx=768)
    unet8.conv_in = nn.Conv2d(8, 8, 3, padding=1)
    ldm = {"model.diffusion_model." + k: v
           for k, v in _rename(unet8.state_dict(), _LDM_UNET, _LDM_RESNET).items()}
    ldm.update(_ldm_vae(vae_sd))
    tower = _CLIPVisual(d=64, heads=1, depth=2, patch=8, img=224)
    pre = "cond_stage_model.model.visual."
    ldm.update({pre + k: v for k, v in tower.state_dict().items()})
    ldm.update({pre + "ln_post.weight": torch.ones(64), pre + "ln_post.bias": torch.zeros(64),
                pre + "proj": torch.randn(64, 48), "cc_projection.weight": torch.randn(768, 52),
                "cc_projection.bias": torch.randn(768)})
    os.makedirs(tmp_path / "zero123")
    torch.save({"state_dict": ldm}, tmp_path / "zero123" / "105000.ckpt")
    monkeypatch.setattr(t_feat, "UNetConfig", lambda **kw: t_unet.UNetConfig(**{**UNET, **kw}))
    monkeypatch.setattr(t_feat, "VAEEncoderConfig", lambda: vcfg)
    z = t_feat.Zero123(device="cpu")
    want = sd_unet_state_dict(t_convert.convert_unet_ldm(ldm, z.unet_cfg))
    assert set(z.unet.state_dict()) == set(want) and z.unet.conv_in.weight.shape[1] == 8
    torch.testing.assert_close(z.unet.conv_in.weight, want["conv_in.weight"], rtol=0, atol=0)
    assert z.clip_cfg.table_grid == (28, 28) and z.clip_cfg.depth == 2
    torch.testing.assert_close(z.cc_proj[0], ldm["cc_projection.weight"].T, rtol=0, atol=0)
    assert tuple(z.cond_embedding(torch.zeros(1, 32, 32, 3)).shape) == (1, 1, 768)


def hf_text_state_dict(vocab_size, hidden_size, num_layers, max_positions, seed=0, **_):
    """A transformers ``CLIPTextModel`` state dict of random tensors."""
    gen = torch.Generator().manual_seed(seed)
    C, pre = hidden_size, "text_model."
    shapes = {"embeddings.token_embedding.weight": (vocab_size, C),
              "embeddings.position_embedding.weight": (max_positions, C),
              "final_layer_norm.weight": (C,), "final_layer_norm.bias": (C,)}
    for i in range(num_layers):
        b = f"encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            shapes.update({f"{b}{n}.weight": (C,), f"{b}{n}.bias": (C,)})
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes.update({f"{b}self_attn.{n}.weight": (C, C), f"{b}self_attn.{n}.bias": (C,)})
        shapes.update({f"{b}mlp.fc1.weight": (4 * C, C), f"{b}mlp.fc1.bias": (4 * C,),
                       f"{b}mlp.fc2.weight": (C, 4 * C), f"{b}mlp.fc2.bias": (C,)})
    return {pre + k: 0.1 * torch.randn(v, generator=gen) for k, v in shapes.items()}
