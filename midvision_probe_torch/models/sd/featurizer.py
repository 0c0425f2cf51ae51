"""One-step SD featurizers (counterpart of the JAX package's
``models/sd/featurizer.py``): ``SDFeaturizer``, ``DIFT`` and ``Zero123``.

DIFT, per batch: CLIP-encode the prompt (the empty prompt once, then
broadcast) -> VAE-encode the images to scaled mode latents -> DDPM noise at
timestep t -> UNet forward, tapping the up blocks ([1280, 1280, 640, 320])
-> the taps resized (nearest) to the /16 grid for ``dense``, or their
spatial mean for ``gap``.

Zero123: the LDM UNet (8 input channels: pure noise concatenated with the
unscaled latents; 768-d context; 8 heads), run once conditioned on the
CLIP ViT-L/14 image embedding of the input view (posed by T = [0, 0, 1, 0]
and projected by ``cc_projection``) and once unconditioned (context and
concat latents zeroed); the taps are combined with guidance scale 3.

Both are standalone featurizers, as in the JAX package: ``instantiate(
cfg.backbone)(images)`` with images NHWC in [-1, 1]; no driver of either
package takes them.

Weights: ``$MVP_CHECKPOINT_DIR/sd21/{unet,vae,text_encoder}.bin``
(diffusers layout) and ``$MVP_CHECKPOINT_DIR/zero123/105000.ckpt`` (LDM
layout), converted to numpy trees and mapped onto the port's modules by
``convert.from_jax``. A missing part is random-initialised on the target
device from a seeded ``torch.Generator`` (flax's default distributions;
the draws differ from JAX's).

The noise: the JAX package draws ``jax.random.normal(PRNGKey(noise_seed),
latents.shape)`` inside its jit, which the port cannot reproduce; a caller
may pass the ``noise`` (NHWC, latents' shape), and without it the port
draws it from a ``torch.Generator`` seeded with ``noise_seed`` on the
device. The forward runs with TF32 off for matmuls and cuDNN convolutions
(the flags are restored after), as the JAX package's float32 does.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch
import torch.nn as nn

from midvision_probe_torch.convert.from_jax import (
    sd_text_state_dict,
    sd_unet_state_dict,
    sd_vae_state_dict,
    vit_state_dict,
)
from midvision_probe_torch.models.convert import convert_vit_openclip
from midvision_probe_torch.models.convert.common import _np
from midvision_probe_torch.models.sd.convert import (
    convert_text_encoder,
    convert_unet,
    convert_unet_ldm,
    convert_vae_encoder,
    convert_vae_encoder_ldm,
)
from midvision_probe_torch.models.sd.text_encoder import CLIPTextConfig, CLIPTextEncoder
from midvision_probe_torch.models.sd.tokenizer import CLIPTokenizer
from midvision_probe_torch.models.sd.unet import UNet2DCondition, UNetConfig
from midvision_probe_torch.models.sd.vae import VAEEncoder, VAEEncoderConfig
from midvision_probe_torch.models.vit import ViT, ViTConfig, _lecun_normal_
from midvision_probe_torch.models.zoo import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, checkpoint_dir
from midvision_probe_torch.ops.image import resize
from midvision_probe_torch.utils.device import full_f32, resolve_device, resolve_dtype

log = logging.getLogger(__name__)

FEAT_DIMS = [1280, 1280, 640, 320]  # the up blocks' widths


def ddpm_alphas_cumprod(num_steps=1000, beta_start=0.00085, beta_end=0.012) -> np.ndarray:
    """scaled_linear betas (SD scheduler config), float64."""
    betas = np.linspace(beta_start**0.5, beta_end**0.5, num_steps) ** 2
    return np.cumprod(1.0 - betas)


@torch.no_grad()
def init_sd_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default init: lecun-normal kernels and embeddings (fan-in the
    embedding width), zero biases, norms ones/zeros, a zero position
    table."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            _lecun_normal_(mod.weight, mod.weight.shape[1], generator)
        elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, CLIPTextEncoder):
            mod.position_embedding.zero_()
    return module


def _noise(latents: torch.Tensor, noise, noise_seed: int) -> torch.Tensor:
    """The caller's noise on the latents' device and dtype, or a standard
    normal draw of the latents' shape from a generator seeded with
    ``noise_seed`` on that device."""
    if noise is None:
        gen = torch.Generator(device=latents.device).manual_seed(int(noise_seed))
        noise = torch.randn(latents.shape, generator=gen, device=latents.device)
    noise = torch.as_tensor(noise, device=latents.device)
    if tuple(noise.shape) != tuple(latents.shape):
        raise ValueError(f"noise of shape {tuple(noise.shape)} for latents of shape "
                         f"{tuple(latents.shape)}")
    return noise.to(latents.dtype)


def _load_part(module: nn.Module, path: str, convert, to_state_dict, generator, name: str):
    """``module`` loaded strictly from the checkpoint at ``path`` (the
    converter's numpy tree mapped by ``to_state_dict``), or
    random-initialised from ``generator`` when there is no file."""
    if os.path.exists(path):
        sd = torch.load(path, map_location="cpu", weights_only=False)
        module.load_state_dict(to_state_dict(convert(sd.get("state_dict", sd))), strict=True)
    else:
        log.warning("SD %s weights missing at %s — random init (features are not "
                    "meaningful)", name, path)
        init_sd_(module, generator)


def _taps_to_output(feats: list, multilayers: list, output: str, hw: tuple[int, int],
                    patch_size: int):
    feats = [feats[i] for i in multilayers]
    h, w = hw[0] // patch_size, hw[1] // patch_size
    if output == "dense":
        feats = [resize(f.float(), (h, w), mode="nearest") for f in feats]
    else:
        feats = [f.mean(dim=(1, 2)) for f in feats]
    return feats[0] if len(feats) == 1 else feats


def _tap_spec(obj, layer: int, return_multilayer: bool) -> None:
    multilayers = [0, 1, 2, 3]
    if return_multilayer:
        obj.feat_dim, obj.multilayers = list(FEAT_DIMS), multilayers
    else:
        layer = multilayers[-1] if layer == -1 else layer
        obj.feat_dim, obj.multilayers = FEAT_DIMS[layer], [layer]
    obj.return_multilayer = return_multilayer
    obj.layer = "-".join(str(x) for x in obj.multilayers)


class SDFeaturizer:
    """SD-2.1's VAE encoder, UNet and text tower on ``device`` (default
    cuda; raises without a card unless a device is given) in ``dtype``
    (default float32)."""

    def __init__(self, sd_id="stabilityai/stable-diffusion-2-1", dtype=None, unet_cfg=None,
                 vae_cfg=None, text_cfg=None, device=None):
        self.device = resolve_device(device)
        self.unet_cfg = unet_cfg or UNetConfig()
        self.vae_cfg = vae_cfg or VAEEncoderConfig()
        self.text_cfg = text_cfg or CLIPTextConfig()
        with torch.device(self.device):
            self.unet = UNet2DCondition(self.unet_cfg)
            self.vae = VAEEncoder(self.vae_cfg)
            self.text = CLIPTextEncoder(self.text_cfg)
        # float64 in numpy, float32 on the device (the JAX package's
        # jnp.asarray with x64 off)
        self.alphas_cumprod = torch.as_tensor(ddpm_alphas_cumprod(), dtype=torch.float32,
                                              device=self.device)
        self._load(sd_id)
        for m in (self.unet, self.vae, self.text):
            m.to(resolve_dtype(dtype)).eval().requires_grad_(False)

    def _ckpt_dir(self) -> str:
        return os.path.join(checkpoint_dir(), "sd21")

    def _load(self, sd_id) -> None:
        gen = torch.Generator(device=self.device).manual_seed(0)
        d = self._ckpt_dir()
        _load_part(self.unet, os.path.join(d, "unet.bin"),
                   lambda sd: convert_unet(sd, self.unet_cfg), sd_unet_state_dict, gen, "unet")
        _load_part(self.vae, os.path.join(d, "vae.bin"),
                   lambda sd: convert_vae_encoder(sd, self.vae_cfg), sd_vae_state_dict, gen,
                   "vae")
        _load_part(self.text, os.path.join(d, "text_encoder.bin"),
                   lambda sd: convert_text_encoder(sd, self.text_cfg), sd_text_state_dict,
                   gen, "text_encoder")

    def encode_prompt(self, prompts: list[str]) -> torch.Tensor:
        """Tokenize (``tokenizer/vocab.json`` + ``merges.txt``, or openai's
        ``bpe_simple_vocab_16e6.txt.gz``, under the checkpoint's folder) and
        text-encode; ``FileNotFoundError`` when neither is there."""
        tok_dir = os.path.join(self._ckpt_dir(), "tokenizer")
        gz = os.path.join(self._ckpt_dir(), "bpe_simple_vocab_16e6.txt.gz")
        if os.path.exists(os.path.join(tok_dir, "vocab.json")):
            tokenizer = CLIPTokenizer.from_dir(tok_dir)
        elif os.path.exists(gz):
            tokenizer = CLIPTokenizer.from_gzip(gz)
        else:
            raise FileNotFoundError(f"no tokenizer files under {tok_dir} or {gz}")
        ids = torch.as_tensor(tokenizer(prompts), device=self.device)
        with torch.no_grad(), full_f32():
            return self.text(ids)

    def __call__(self, images, prompt_embeds, t=1, up_ft_indices=(0, 1, 2, 3), noise_seed=0,
                 noise=None) -> list[torch.Tensor]:
        """images (B, H, W, 3) in [-1, 1]; prompt_embeds (B, 77, hidden) ->
        the requested up blocks' NHWC taps. ``noise``: the latents' (B, H/8,
        W/8, 4) standard-normal draw (default: drawn from ``noise_seed``)."""
        images = torch.as_tensor(images, device=self.device)
        B = images.shape[0]
        t_arr = torch.full((B,), int(t), dtype=torch.int64, device=self.device)
        with torch.no_grad(), full_f32():
            latents = self.vae(images)
            a = self.alphas_cumprod[t_arr]
            sa = torch.sqrt(a).to(latents.dtype)[:, None, None, None]
            sb = torch.sqrt(1 - a).to(latents.dtype)[:, None, None, None]
            noisy = sa * latents + sb * _noise(latents, noise, noise_seed)
            return self.unet(noisy, t_arr, torch.as_tensor(prompt_embeds, device=self.device),
                             up_ft_indices=tuple(up_ft_indices))


class DIFT:
    """DIFT on SD-2.1 (feature widths [1280, 1280, 640, 320], /16 dense
    output, the empty prompt by default). Runs float32 whatever dtype a
    driver asks for, as the JAX package's does."""

    def __init__(self, model_id="stabilityai/stable-diffusion-2-1", time_step=250,
                 output="dense", layer=1, return_multilayer=False, add_norm=False, device=None,
                 **_):
        if output not in ("gap", "dense"):
            raise ValueError(f"DIFT output must be 'gap' or 'dense', got {output!r}")
        self.output = output
        self.time_step = time_step
        self.checkpoint_name = model_id.split("/")[-1] + f"_noise-{time_step}"
        self.patch_size = 16
        self.arch = "diffusion"
        self.featurizer = SDFeaturizer(model_id, device=device)
        _tap_spec(self, layer, return_multilayer)
        self._empty_embed = None

    def _prompt_embeds(self, batch, categories=None, prompts=None) -> torch.Tensor:
        if categories is not None:
            prompts = [f"a photo of a {c}" for c in categories]
        if prompts is None:
            # the empty prompt's embedding is constant: encode once, broadcast
            if self._empty_embed is None:
                self._empty_embed = self._prompt_embeds(1, prompts=[""])
            return self._empty_embed.expand(batch, *self._empty_embed.shape[1:])
        try:
            return self.featurizer.encode_prompt(prompts)
        except FileNotFoundError as e:
            # only the missing tokenizer files fall back to a zero context
            # (the JAX package falls back on any exception)
            log.warning("prompt encoding unavailable (%s); using zeros", e)
            return torch.zeros(batch, 77, self.featurizer.text_cfg.hidden_size,
                               device=self.featurizer.device)

    def __call__(self, images, categories=None, prompts=None, noise=None):
        """images (B, H, W, 3) in [-1, 1] -> the tapped features;
        ``noise``: see ``SDFeaturizer.__call__``."""
        B, H, W, _ = images.shape
        embeds = self._prompt_embeds(B, categories, prompts)
        feats = self.featurizer(images, embeds, t=self.time_step, noise=noise)
        return _taps_to_output(feats, self.multilayers, self.output, (H, W), self.patch_size)


class Zero123:
    """Zero123's novel-view featurizer: the LDM UNet and VAE encoder from the
    lightning checkpoint (or random init), the checkpoint's CLIP ViT-L/14
    image tower and ``cc_projection`` for the conditioning
    (``_load_conditioning``), the conditioned and unconditioned up-block
    taps combined with guidance scale 3. On ``device`` (default cuda),
    float32."""

    GUIDANCE_SCALE = 3.0

    def __init__(self, time_step=1, output="dense", layer=1, return_multilayer=False,
                 add_norm=False, device=None, **_):
        if output not in ("gap", "dense"):
            raise ValueError(f"Zero123 output must be 'gap' or 'dense', got {output!r}")
        self.output = output
        self.time_step = time_step
        self.checkpoint_name = f"zero123_t-{time_step}"
        self.patch_size = 16
        self.arch = "diffusion"
        self.device = resolve_device(device)
        self.unet_cfg = UNetConfig(in_channels=8, cross_attention_dim=768, num_heads=8)
        self.vae_cfg = VAEEncoderConfig()
        with torch.device(self.device):
            self.unet = UNet2DCondition(self.unet_cfg)
            self.vae = VAEEncoder(self.vae_cfg)
        self.alphas_cumprod = torch.as_tensor(ddpm_alphas_cumprod(), dtype=torch.float32,
                                              device=self.device)
        self.clip = self.clip_cfg = self.clip_proj = self.cc_proj = None
        self._load()
        for m in (self.unet, self.vae):
            m.eval().requires_grad_(False)
        _tap_spec(self, layer, return_multilayer)

    def _load(self) -> None:
        path = os.path.join(checkpoint_dir(), "zero123", "105000.ckpt")
        if os.path.exists(path):
            sd = torch.load(path, map_location="cpu", weights_only=False)["state_dict"]
            self.unet.load_state_dict(sd_unet_state_dict(convert_unet_ldm(sd, self.unet_cfg)),
                                      strict=True)
            self.vae.load_state_dict(
                sd_vae_state_dict(convert_vae_encoder_ldm(sd, self.vae_cfg)), strict=True)
            self._load_conditioning(sd)
        else:
            log.warning("zero123 checkpoint missing at %s — random init", path)
            gen = torch.Generator(device=self.device).manual_seed(0)
            init_sd_(self.unet, gen)
            init_sd_(self.vae, gen)

    def _load_conditioning(self, sd) -> None:
        """The CLIP image tower (open_clip naming under
        ``cond_stage_model.model.visual.``), its ``proj`` and
        ``cc_projection`` from a lightning state_dict; the tower's width,
        patch, depth and table grid are read off the weights."""
        pre = "cond_stage_model.model."
        if f"{pre}visual.proj" not in sd:
            log.warning("zero123 ckpt lacks cond_stage_model — conditioning must be passed in")
            return
        conv1 = sd[f"{pre}visual.conv1.weight"]
        width, patch = conv1.shape[0], conv1.shape[-1]
        depth = 1 + max(int(k[len(pre):].split(".")[3]) for k in sd
                        if k.startswith(f"{pre}visual.transformer.resblocks."))
        grid = math.isqrt(sd[f"{pre}visual.positional_embedding"].shape[0] - 1)
        self.clip_cfg = ViTConfig(
            patch_size=patch, width=width, depth=depth, num_heads=max(width // 64, 1),
            pre_norm=True, patch_bias=False, act="quickgelu", layernorm_eps=1e-5,
            final_norm=True, table_grid=(grid, grid))
        with torch.device(self.device):
            clip = ViT(self.clip_cfg)
        clip.load_state_dict(vit_state_dict(convert_vit_openclip(
            sd, self.clip_cfg, prefix=f"{pre}visual.")), strict=True)
        self.clip = clip.eval().requires_grad_(False)
        self.clip_proj = torch.as_tensor(_np(sd[f"{pre}visual.proj"]), device=self.device)
        self.cc_proj = (torch.as_tensor(_np(sd["cc_projection.weight"]), device=self.device).T,
                        torch.as_tensor(_np(sd["cc_projection.bias"]), device=self.device))

    def cond_embedding(self, images, T=None) -> torch.Tensor:
        """images (B, H, W, 3) in [-1, 1] -> the cc-projected context
        (B, 1, 768): bicubic 224 (align_corners, antialias), [-1, 1] ->
        [0, 1], CLIP normalisation, ``ln_post(cls) @ proj``, the pose T
        (default the identity view [0, 0, 1, 0]) concatenated."""
        if self.clip is None:
            raise RuntimeError("zero123's conditioning weights are not loaded")
        x = resize(torch.as_tensor(images, device=self.device).float(), (224, 224),
                   mode="bicubic", align_corners=True, antialias=True)
        mean = torch.tensor(OPENAI_CLIP_MEAN, device=self.device)
        std = torch.tensor(OPENAI_CLIP_STD, device=self.device)
        x = ((x + 1.0) / 2.0 - mean) / std
        with torch.no_grad(), full_f32():
            res = self.clip(x, taps=(self.clip_cfg.depth - 1,))
            emb = res["tokens"][0][:, 0] @ self.clip_proj
            B = emb.shape[0]
            T = torch.tensor([0.0, 0.0, 1.0, 0.0]) if T is None else torch.as_tensor(T)
            T = T.float().to(self.device).expand(B, 4)
            c = torch.cat([emb, T], dim=-1)[:, None]  # (B, 1, 772)
            w, b = self.cc_proj
            return c @ w + b

    def __call__(self, images, cond_embeds=None, noise_seed=0, noise=None):
        """images (B, H, W, 3) in [-1, 1]; ``cond_embeds`` an optional
        (B, 1, 768) context (default: ``cond_embedding``, or zeros without
        conditioning weights); ``noise``: see ``SDFeaturizer.__call__``."""
        images = torch.as_tensor(images, device=self.device)
        B, H, W, _ = images.shape
        if cond_embeds is not None:
            ctx = torch.as_tensor(cond_embeds, device=self.device)
        elif self.clip is not None:
            ctx = self.cond_embedding(images)
        else:
            ctx = torch.zeros(B, 1, 768, device=self.device)
        t = torch.full((B,), int(self.time_step), dtype=torch.int64, device=self.device)
        with torch.no_grad(), full_f32():
            # c_concat: the unscaled latents; the UNet's own input is pure noise
            latents = self.vae(images) / self.vae_cfg.scaling_factor
            eps = _noise(latents, noise, noise_seed)
            cond = self.unet(torch.cat([eps, latents], dim=-1), t, ctx)
            # the unconditioned pass zeroes the context and the concat latents
            uncond = self.unet(torch.cat([eps, torch.zeros_like(latents)], dim=-1), t,
                               torch.zeros_like(ctx))
            feats = [u + self.GUIDANCE_SCALE * (c - u) for c, u in zip(cond, uncond)]
        return _taps_to_output(feats, self.multilayers, self.output, (H, W), self.patch_size)
