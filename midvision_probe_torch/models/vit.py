"""Plain ViT with per-layer taps (counterpart of the JAX package's
``models/vit.py``, plain-ViT subset).

Parameter names follow the DINO/timm source layout
(``patch_embed.proj.weight``, ``blocks.{i}.attn.qkv.weight``, ...), so a
released checkpoint can later load with ``load_state_dict``. The fused qkv
projection keeps the source column order ``(role, head, j)``, which is the
layout the attention kernel reads.

A block's attention takes one of the JAX package's two branches
(``models/vit.py::Attention``):

* fused: without RoPE or a relative-position bias and with a head dim that
  divides 128, ``ops.vit_attention.fused_qkv_attention`` (kernel K1) reads
  the qkv projection directly (DINO and the other plain ViTs);
* generic: q, k and v as ``(B, H, N, d)`` views of the projection, 2D RoPE
  on the patch tokens (``ops.rope2d.rope_2d``, kernel K5; the prefix tokens
  stay unrotated), then ``ops.attention.multi_head_attention`` (kernel K2,
  or its long-sequence route K3) (CroCo-v2, and RADIO-v2's head dim 80).

Each kernel runs on a CUDA tensor, its plain version on a CPU tensor. The
JAX package's whole-network 128-padding was a TPU layout device and is
dropped: the kernels take any token count.

Not ported yet (a config asking for them raises): relative-position bias,
LayerScale, register tokens, windowed attention, ``scan_blocks``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from midvision_probe_torch.ops.activations import gelu
from midvision_probe_torch.ops.attention import multi_head_attention
from midvision_probe_torch.ops.image import resize
from midvision_probe_torch.ops.rope2d import rope_2d
from midvision_probe_torch.ops.vit_attention import FUSED_HEAD_DIMS, fused_qkv_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    in_channels: int = 3
    class_token: bool = True
    num_register_tokens: int = 0
    pos_embed: str = "learned"  # learned | sincos2d | none
    pos_embed_cls: bool = True  # pos-embed table includes a cls entry
    # canonical (training-time) pos-embed grid; the table is bicubic-resized
    # to the input grid at forward time
    table_grid: tuple[int, int] | None = None
    layernorm_eps: float = 1e-6
    qkv_bias: bool = True
    patch_bias: bool = True
    act: str = "gelu"  # gelu (erf f32 / tanh half) | quickgelu | gelu_tanh
    layerscale: bool = False
    rel_pos_bias: bool = False
    rope: bool = False  # CroCo-style 2D RoPE on q/k (no abs pos embed)
    rope_base: float = 100.0
    window_size: int = 0
    use_rel_pos: bool = False
    final_norm: bool = False  # apply final LN to tapped outputs
    pre_norm: bool = False  # CLIP-style LN before the blocks
    scan_blocks: bool = False

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.class_token else 0) + self.num_register_tokens

    def check_supported(self) -> None:
        unsupported = {
            "rel_pos_bias": self.rel_pos_bias,
            "layerscale": self.layerscale,
            "num_register_tokens": self.num_register_tokens,
            "window_size": self.window_size, "use_rel_pos": self.use_rel_pos,
            "scan_blocks": self.scan_blocks,
        }
        asked = [k for k, v in unsupported.items() if v]
        if asked:
            raise NotImplementedError(
                f"ViT features {asked} are not ported to PyTorch yet (ROADMAP "
                "section 1, item 3: the other backbone families)")


def get_2d_sincos_pos_embed(embed_dim: int, grid_hw: tuple[int, int],
                            add_cls_token: bool = False) -> np.ndarray:
    """Fixed 2D sin-cos table (numpy, same as the JAX package's)."""
    h, w = grid_hw
    grid = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))  # w goes first
    grid = np.stack(grid, axis=0).reshape(2, 1, h, w)

    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate(
        [_1d(embed_dim // 2, grid[0]), _1d(embed_dim // 2, grid[1])], axis=1)
    if add_cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb.astype(np.float32)


def resize_pos_embed(pos: torch.Tensor, hw: tuple[int, int],
                     has_cls_token: bool = True,
                     orig_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """Bicubic antialiased pos-embed resize; ``pos`` (n_tokens, C).

    When the table's grid is known (``orig_hw``) the early return requires
    the grid shapes to match, not only the token counts (a 14x14 table fed
    a 7x28 grid is resized, not reused scrambled)."""
    n_grid = pos.shape[0] - 1 if has_cls_token else pos.shape[0]
    known = orig_hw is not None and n_grid == orig_hw[0] * orig_hw[1]
    if known:
        if tuple(orig_hw) == tuple(hw):
            return pos
    else:
        if n_grid == hw[0] * hw[1]:
            return pos
        orig = int(round(math.sqrt(n_grid)))
        orig_hw = (orig, orig)
    if has_cls_token:
        cls_embed, pos = pos[:1], pos[1:]
    grid = pos.reshape(orig_hw[0], orig_hw[1], -1)
    grid = resize(grid, hw, mode="bicubic", align_corners=False, antialias=True)
    pos = grid.reshape(hw[0] * hw[1], -1)
    if has_cls_token:
        pos = torch.cat([cls_embed, pos], dim=0)
    return pos


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        hidden = int(cfg.width * cfg.mlp_ratio)
        self.act = cfg.act
        self.fc1 = nn.Linear(cfg.width, hidden)
        self.fc2 = nn.Linear(hidden, cfg.width)

    def forward(self, x):
        x = self.fc1(x)
        if self.act == "quickgelu":  # openai CLIP: x * sigmoid(1.702 x)
            x = x * torch.sigmoid(1.702 * x)
        elif self.act == "gelu_tanh":  # SigLIP: tanh-approx gelu at any dtype
            x = F.gelu(x, approximate="tanh")
        else:
            x = gelu(x)  # erf in f32, tanh in bf16
        return self.fc2(x)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.fused = (not cfg.rope and not cfg.rel_pos_bias
                      and cfg.head_dim in FUSED_HEAD_DIMS)
        self.qkv = nn.Linear(cfg.width, 3 * cfg.width, bias=cfg.qkv_bias)
        self.proj = nn.Linear(cfg.width, cfg.width)

    def forward(self, x, pos_2d=None):
        c = self.cfg
        B, N, C = x.shape
        scale = c.head_dim**-0.5
        qkv = self.qkv(x).reshape(B, N, 3, c.num_heads, c.head_dim)
        if self.fused:
            return self.proj(fused_qkv_attention(qkv, scale).reshape(B, N, C))

        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, N, d) views
        if c.rope and pos_2d is not None:
            # rotate patch tokens only; prefix tokens are left untouched
            p = c.num_prefix_tokens
            q_pat = rope_2d(q[:, :, p:], pos_2d, base=c.rope_base)
            k_pat = rope_2d(k[:, :, p:], pos_2d, base=c.rope_base)
            q = torch.cat([q[:, :, :p], q_pat], dim=2) if p else q_pat
            k = torch.cat([k[:, :, :p], k_pat], dim=2) if p else k_pat
        out = multi_head_attention(q, k, v, scale=scale)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.width, eps=cfg.layernorm_eps)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(cfg.width, eps=cfg.layernorm_eps)
        self.mlp = Mlp(cfg)

    def forward(self, x, pos_2d=None):
        x = x + self.attn(self.norm1(x), pos_2d)
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_channels, cfg.width, cfg.patch_size,
                              stride=cfg.patch_size, bias=cfg.patch_bias)


class ViT(nn.Module):
    """Generic plain ViT; ``forward(images, taps)`` returns the per-block
    token taps.

    images: (B, H, W, 3) NHWC, already preprocessed. Returns a dict with
    ``tokens``: list of (B, N, C) raw block outputs (prefix tokens first),
    one per tap, and ``grid_hw``: the patch grid. Blocks past the last tap
    are not run."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        cfg.check_supported()
        self.cfg = cfg
        c = cfg
        self.patch_embed = PatchEmbed(c)
        if c.class_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width))
        if c.pos_embed == "learned":
            if c.table_grid is None:
                raise ValueError("a learned pos-embed needs cfg.table_grid")
            n = c.table_grid[0] * c.table_grid[1] + (1 if c.pos_embed_cls else 0)
            self.pos_embed = nn.Parameter(torch.zeros(1, n, c.width))
        if c.pre_norm:
            self.norm_pre = nn.LayerNorm(c.width, eps=c.layernorm_eps)
        self.blocks = nn.ModuleList(Block(c) for _ in range(c.depth))
        if c.final_norm:
            self.norm = nn.LayerNorm(c.width, eps=c.layernorm_eps)

    @property
    def dtype(self) -> torch.dtype:
        return self.patch_embed.proj.weight.dtype

    def forward(self, images: torch.Tensor, taps: Sequence[int]):
        c = self.cfg
        B, H, W, _ = images.shape
        gh, gw = H // c.patch_size, W // c.patch_size
        dtype = self.dtype

        x = self.patch_embed.proj(images.permute(0, 3, 1, 2).to(dtype))
        x = x.flatten(2).transpose(1, 2)  # (B, gh*gw, C)
        if c.class_token:
            x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)

        if c.pos_embed == "learned":
            # resize in f32 from the stored table, then cast, as the JAX
            # package does
            pos = resize_pos_embed(self.pos_embed[0].float(), (gh, gw),
                                   has_cls_token=c.pos_embed_cls,
                                   orig_hw=c.table_grid)
            if c.class_token and not c.pos_embed_cls:
                pos = torch.cat([torch.zeros_like(pos[:1]), pos], dim=0)
            if not c.class_token and c.pos_embed_cls:
                pos = pos[1:]
            x = x + pos[None].to(dtype)
        elif c.pos_embed == "sincos2d":
            pos = torch.as_tensor(get_2d_sincos_pos_embed(
                c.width, (gh, gw), add_cls_token=c.class_token), device=x.device)
            x = x + pos[None].to(dtype)

        if c.pre_norm:
            x = self.norm_pre(x)

        pos_2d = None
        if c.rope:
            yy, xx = torch.meshgrid(
                torch.arange(gh, dtype=torch.int32, device=x.device),
                torch.arange(gw, dtype=torch.int32, device=x.device), indexing="ij")
            pos_2d = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)
            pos_2d = pos_2d[None].expand(B, gh * gw, 2)

        taps = list(taps)
        max_tap = max(taps)
        outputs = {}
        for i, blk in enumerate(self.blocks):
            x = blk(x, pos_2d)
            if i in taps:
                outputs[i] = self.norm(x) if c.final_norm else x
            if i == max_tap:
                break
        return {"tokens": [outputs[i] for i in taps], "grid_hw": (gh, gw)}


# Canonical size presets (width/depth/heads) used across the zoo.
VIT_PRESETS = {
    "vit_small": dict(width=384, depth=12, num_heads=6),
    "vit_base": dict(width=768, depth=12, num_heads=12),
    "vit_large": dict(width=1024, depth=24, num_heads=16),
    "vit_huge": dict(width=1280, depth=32, num_heads=16),
    "vit_giant": dict(width=1536, depth=40, num_heads=24),
}


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax ``lecun_normal``: truncated normal (±2 std) with variance
    1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_vit_(model: ViT, generator: torch.Generator) -> ViT:
    """Random init with the JAX package's distributions (flax defaults):
    lecun-normal kernels, zero biases, LayerNorm ones/zeros, zero cls token,
    N(0, 0.02) pos-embed. The draws differ from JAX's (other generator);
    parity tests carry weights across with ``convert.from_jax``."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    if model.cfg.class_token:
        model.cls_token.zero_()
    if model.cfg.pos_embed == "learned":
        model.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model
