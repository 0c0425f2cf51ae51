"""SD ``AutoencoderKL`` encoder (counterpart of the JAX package's
``models/sd/vae.py``): DIFT needs only ``vae.encode(images).latent_dist
.mode()``.

conv_in(128) -> 4 down levels (2 ResNets each, channels (128, 256, 512,
512), a stride-2 conv after each level but the last, on the input padded
by one row and column at the bottom and right, as diffusers pads) -> mid
(ResNet, single-head attention at d = 512, ResNet) -> GroupNorm + SiLU ->
conv_out(8) -> quant_conv(8) -> the posterior's mode (its first 4
channels) times ``scaling_factor`` (0.18215).

Images and latents are NHWC; the module computes in NCHW. Parameter names
are the flax module names (``convert.from_jax.sd_vae_state_dict``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from midvision_probe_torch.models.sd.unet import ResnetBlock, attend


@dataclasses.dataclass(frozen=True)
class VAEEncoderConfig:
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_groups: int = 32
    scaling_factor: float = 0.18215


class VAEAttention(nn.Module):
    """Single-head spatial self-attention over all H*W positions. NCHW."""

    def __init__(self, cfg: VAEEncoderConfig, ch: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(cfg.norm_groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.Linear(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        out = self.to_out(attend(self.to_q(h), self.to_k(h), self.to_v(h), C**-0.5))
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEEncoderConfig):
        super().__init__()
        self.cfg = c = cfg
        chans = c.block_out_channels

        def res(name, cin, cout):
            self.add_module(name, ResnetBlock(cin, cout, c.norm_groups, 1e-6))

        self.conv_in = nn.Conv2d(3, chans[0], 3, padding=1)
        cur = chans[0]
        for lvl, ch in enumerate(chans):
            for b in range(c.layers_per_block):
                res(f"down_{lvl}_res_{b}", cur, ch)
                cur = ch
            if lvl < len(chans) - 1:
                self.add_module(f"down_{lvl}_downsample", nn.Conv2d(ch, ch, 3, stride=2))
        res("mid_res_0", cur, chans[-1])
        self.mid_attn = VAEAttention(c, chans[-1])
        res("mid_res_1", chans[-1], chans[-1])
        self.conv_norm_out = nn.GroupNorm(c.norm_groups, chans[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 2 * c.latent_channels, 3, padding=1)
        self.quant_conv = nn.Conv2d(2 * c.latent_channels, 2 * c.latent_channels, 1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) in [-1, 1] -> scaled mode latents
        (B, H/8, W/8, latent_channels)."""
        c = self.cfg
        mod = self._modules
        h = self.conv_in(images.to(self.conv_in.weight.dtype).permute(0, 3, 1, 2))
        for lvl in range(len(c.block_out_channels)):
            for b in range(c.layers_per_block):
                h = mod[f"down_{lvl}_res_{b}"](h)
            if lvl < len(c.block_out_channels) - 1:
                h = mod[f"down_{lvl}_downsample"](F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        moments = self.quant_conv(self.conv_out(F.silu(self.conv_norm_out(h))))
        mode = moments[:, : c.latent_channels]  # DiagonalGaussian.mode()
        return (mode * c.scaling_factor).permute(0, 2, 3, 1)
