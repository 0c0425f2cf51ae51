"""SD-2.1 ``UNet2DConditionModel`` with up-block feature taps (counterpart
of the JAX package's ``models/sd/unet.py``).

conv_in -> time embedding (sinusoidal 320 -> SiLU MLP 1280) -> down blocks
[CrossAttn(320), CrossAttn(640), CrossAttn(1280), Plain(1280)] (2 ResNet
blocks each, a spatial transformer after each ResNet of the cross-attention
levels, a stride-2 conv between levels) -> mid (ResNet, transformer,
ResNet) -> up blocks [Plain(1280), CrossAttn(1280), CrossAttn(640),
CrossAttn(320)] (3 ResNet blocks each on the skip concat, an upsample to
the next skip's size between blocks). DIFT taps the output of each up
block (feature widths [1280, 1280, 640, 320]).

Transformer blocks use linear projections, GEGLU feed-forward and
cross-attention over the text context. SD-2.1 fixes the head width at 64;
SD-1.x / LDM UNets (Zero123) fix the head count (``num_heads``).

Inputs and taps are NHWC, as in the JAX package; the module computes in
NCHW. Parameter names are the flax module names, so
``convert.from_jax.sd_unet_state_dict`` maps a flax tree onto it leaf by
leaf. Attention is the JAX package's einsum route: scores and softmax in
float32 (float64 for a float64 module), no hand-written kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from midvision_probe_torch.ops.activations import gelu


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    head_dim: int = 64
    # SD-1.x / LDM UNets (Zero123) fix the head COUNT instead of the width
    num_heads: int | None = None
    norm_groups: int = 32

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` (flip_sin_to_cos=True, shift=0),
    in float32 as the JAX package computes it."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """``softmax(q*scale @ k^T + bias) @ v`` over the last two axes: the
    scores and softmax in float32 (or the inputs' wider dtype), the
    probabilities cast back before the product with ``v``, as the JAX
    package's einsums with ``preferred_element_type=float32``."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.matmul((q * scale).to(acc), k.to(acc).transpose(-1, -2))
    if bias is not None:
        scores = scores + bias
    return torch.matmul(scores.softmax(dim=-1).to(v.dtype), v)


class ResnetBlock(nn.Module):
    """GroupNorm-SiLU-conv twice, the time embedding added between (when
    ``temb_dim``), a 1x1 shortcut when the width changes. NCHW."""

    def __init__(self, in_ch: int, out_ch: int, groups: int, eps: float,
                 temb_dim: int | None = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, cfg: UNetConfig, query_dim: int, context_dim: int | None = None):
        super().__init__()
        if cfg.num_heads:
            self.heads, self.head_dim = cfg.num_heads, query_dim // cfg.num_heads
        else:
            self.heads, self.head_dim = max(query_dim // cfg.head_dim, 1), cfg.head_dim
        inner = self.heads * self.head_dim
        ctx = context_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        ctx = x if context is None else context
        B, N, _ = x.shape
        M = ctx.shape[1]
        H, d = self.heads, self.head_dim
        q = self.to_q(x).reshape(B, N, H, d).transpose(1, 2)
        k = self.to_k(ctx).reshape(B, M, H, d).transpose(1, 2)
        v = self.to_v(ctx).reshape(B, M, H, d).transpose(1, 2)
        out = attend(q, k, v, d**-0.5).transpose(1, 2).reshape(B, N, H * d)
        return self.to_out(out)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(cfg, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(cfg, dim, cfg.cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff_proj = nn.Linear(dim, dim * 8)
        self.ff_out = nn.Linear(dim * 4, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        a, b = self.ff_proj(self.norm3(x)).chunk(2, dim=-1)  # GEGLU
        return x + self.ff_out(a * gelu(b))


class SpatialTransformer(nn.Module):
    """``Transformer2DModel`` with linear projections. NCHW in and out."""

    def __init__(self, cfg: UNetConfig, dim: int):
        super().__init__()
        self.norm = nn.GroupNorm(cfg.norm_groups, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.block = TransformerBlock(cfg, dim)
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_out(self.block(self.proj_in(h), context))
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = c = cfg
        chans, n, L = c.block_out_channels, len(c.block_out_channels), c.layers_per_block
        temb = c.time_embed_dim

        def res(name, cin, cout):
            self.add_module(name, ResnetBlock(cin, cout, c.norm_groups, 1e-5, temb))

        self.time_fc1 = nn.Linear(chans[0], temb)
        self.time_fc2 = nn.Linear(temb, temb)
        self.conv_in = nn.Conv2d(c.in_channels, chans[0], 3, padding=1)
        skips, cur = [chans[0]], chans[0]
        for lvl in range(n):
            for b in range(L):
                res(f"down_{lvl}_res_{b}", cur, chans[lvl])
                cur = chans[lvl]
                if lvl < n - 1:
                    self.add_module(f"down_{lvl}_attn_{b}", SpatialTransformer(c, cur))
                skips.append(cur)
            if lvl < n - 1:
                self.add_module(f"down_{lvl}_downsample",
                                nn.Conv2d(cur, cur, 3, stride=2, padding=1))
                skips.append(cur)
        res("mid_res_0", cur, chans[-1])
        self.mid_attn = SpatialTransformer(c, chans[-1])
        res("mid_res_1", chans[-1], chans[-1])
        cur = chans[-1]
        for i in range(n):
            lvl = n - 1 - i
            for b in range(L + 1):
                res(f"up_{i}_res_{b}", cur + skips.pop(), chans[lvl])
                cur = chans[lvl]
                if i > 0:
                    self.add_module(f"up_{i}_attn_{b}", SpatialTransformer(c, cur))
            if i < n - 1:
                self.add_module(f"up_{i}_upsample", nn.Conv2d(cur, cur, 3, padding=1))

    def forward(self, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                up_ft_indices: Sequence[int] = (0, 1, 2, 3)) -> list[torch.Tensor]:
        """latents (B, H, W, C_in); t (B,) int; context (B, M, ctx_dim) ->
        the NHWC outputs of the requested up blocks, in index order."""
        c = self.cfg
        n, L = len(c.block_out_channels), c.layers_per_block
        dtype = self.conv_in.weight.dtype
        temb = timestep_embedding(t, c.block_out_channels[0]).to(dtype)
        temb = self.time_fc2(F.silu(self.time_fc1(temb)))
        context = context.to(dtype)
        mod = self._modules

        h = self.conv_in(latents.to(dtype).permute(0, 3, 1, 2))
        skips = [h]
        for lvl in range(n):
            for b in range(L):
                h = mod[f"down_{lvl}_res_{b}"](h, temb)
                if lvl < n - 1:
                    h = mod[f"down_{lvl}_attn_{b}"](h, context)
                skips.append(h)
            if lvl < n - 1:
                h = mod[f"down_{lvl}_downsample"](h)
                skips.append(h)

        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, temb), context), temb)

        up_ft = {}
        for i in range(n):
            for b in range(L + 1):
                h = mod[f"up_{i}_res_{b}"](torch.cat([h, skips.pop()], dim=1), temb)
                if i > 0:
                    h = mod[f"up_{i}_attn_{b}"](h, context)
            if i < n - 1:
                # to the NEXT skip's size, not a blind 2x: 60x80 latents
                # reach 8x10 through 15x20. jax.image.resize's "nearest"
                # samples pixel centres, which is torch's "nearest-exact"
                # (plain "nearest" picks other rows at 8 -> 15)
                h = F.interpolate(h, size=tuple(skips[-1].shape[2:]), mode="nearest-exact")
                h = mod[f"up_{i}_upsample"](h)
            if i in up_ft_indices:
                up_ft[i] = h.permute(0, 2, 3, 1)
        return [up_ft[i] for i in sorted(up_ft)]
