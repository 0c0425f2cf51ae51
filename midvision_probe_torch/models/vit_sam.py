"""SAM image encoder (ViTDet-style windowed ViT), counterpart of the JAX
package's ``models/vit_sam.py`` (reference wrapper ``evals/models/sam.py``:
the segment_anything image encoder tapped at the n/4 block schedule, bicubic
pos-embed resize for non-1024 inputs).

* 16x16 patch embed, 2D learned abs pos-embed (no cls token), stored at
  ``table_grid`` (64x64: 1024/16) and bicubic-resized in float32 to the
  runtime grid;
* blocks keep the (B, H, W, C) spatial layout; all but
  ``global_attn_indexes`` attend inside 14x14 windows: ``norm1``'s output is
  zero-padded to a window multiple and partitioned, and the padded tokens
  stay in the keys, unmasked, as in segment_anything;
* decomposed relative positions: per-axis tables ``rel_pos_h``/``rel_pos_w``
  (a window's extent in windowed blocks, ``table_grid``'s in global ones,
  linearly resized to the runtime grid), cast to the compute dtype, turned
  into a bias by two einsums in that dtype and added to the float32 scores;
* pre-LN MLP with the dtype-aware GELU; blocks stop at the last tap.

Scores, bias and softmax are materialised (einsum + softmax), as in the JAX
package, which has no kernel for them: ``q * scale`` is rounded to the
compute dtype, the product with ``k`` is formed from those values in
float32, the softmax runs in float32 and is cast back.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from midvision_probe_torch.models.vit import _lecun_normal_
from midvision_probe_torch.ops.activations import gelu
from midvision_probe_torch.ops.image import resize

SAM_PRESETS = {
    "vit_b": dict(width=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11)),
    "vit_l": dict(width=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23)),
    "vit_h": dict(width=1280, depth=32, num_heads=16, global_attn_indexes=(7, 15, 23, 31)),
}

# parameters that stay float32 when the module is cast to a half dtype: the
# JAX package resizes the pos-embed table in float32 before the cast
KEEP_F32 = ("pos_embed",)


@dataclasses.dataclass(frozen=True)
class SAMViTConfig:
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    patch_size: int = 16
    window_size: int = 14
    global_attn_indexes: tuple = (2, 5, 8, 11)
    mlp_ratio: float = 4.0
    table_grid: tuple = (64, 64)  # 1024/16 canonical pos-embed grid
    layernorm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads


def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The (2*max-1, hd) per-axis table, linearly resized when its length
    differs, gathered to (q, k, hd)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        # (1, L, hd) read as HWC: a resize of the L axis, in float32, cast back
        rel_pos = resize(rel_pos[None], (1, max_rel_dist), mode="bilinear")[0]
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.to(torch.int64)]


class SAMAttention(nn.Module):
    def __init__(self, cfg: SAMViTConfig, table_hw: tuple[int, int]):
        super().__init__()
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.width, 3 * cfg.width)
        self.proj = nn.Linear(cfg.width, cfg.width)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * table_hw[0] - 1, cfg.head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * table_hw[1] - 1, cfg.head_dim))

    def forward(self, x):
        """x: (B, H, W, C) spatial tokens."""
        c = self.cfg
        B, H, W, C = x.shape
        N = H * W
        nh, hd = c.num_heads, c.head_dim
        qkv = self.qkv(x.reshape(B, N, C)).reshape(B, N, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, nH, N, hd)

        scale = hd**-0.5
        # the JAX einsum's preferred_element_type=float32: products of the
        # compute-dtype values, accumulated in float32
        attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))

        Rh = _get_rel_pos(H, H, self.rel_pos_h.to(x.dtype))  # (H, H, hd)
        Rw = _get_rel_pos(W, W, self.rel_pos_w.to(x.dtype))
        r_q = q.reshape(B, nh, H, W, hd)
        bias_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, Rh)
        bias_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, Rw)
        bias = (bias_h[:, :, :, :, :, None] + bias_w[:, :, :, :, None, :]).reshape(B, nh, N, N)
        attn.add_(bias)  # the bf16 bias, exact in f32, added to the f32 scores

        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, H, W, C)
        return self.proj(out)


def _window_partition(x: torch.Tensor, win: int):
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % win, (-W) % win
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // win, win, Wp // win, win, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, C)
    return x, (Hp, Wp)


def _window_unpartition(x: torch.Tensor, win: int, hp_wp, hw):
    Hp, Wp = hp_wp
    H, W = hw
    B = x.shape[0] // ((Hp // win) * (Wp // win))
    x = x.reshape(B, Hp // win, Wp // win, win, win, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


class SAMBlock(nn.Module):
    def __init__(self, cfg: SAMViTConfig, window_size: int):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(cfg.width, eps=cfg.layernorm_eps)
        # global blocks store their tables at the canonical grid extent and
        # resize them to the runtime grid inside _get_rel_pos
        table_hw = (window_size, window_size) if window_size > 0 else tuple(cfg.table_grid)
        self.attn = SAMAttention(cfg, table_hw)
        self.norm2 = nn.LayerNorm(cfg.width, eps=cfg.layernorm_eps)
        hidden = int(cfg.width * cfg.mlp_ratio)
        self.mlp_lin1 = nn.Linear(cfg.width, hidden)
        self.mlp_lin2 = nn.Linear(hidden, cfg.width)

    def forward(self, x):
        h = self.norm1(x)
        if self.window_size > 0:
            hw = h.shape[1:3]
            h, hp_wp = _window_partition(h, self.window_size)
            h = _window_unpartition(self.attn(h), self.window_size, hp_wp, hw)
        else:
            h = self.attn(h)
        x = x + h
        return x + self.mlp_lin2(gelu(self.mlp_lin1(self.norm2(x))))


class SAMViT(nn.Module):
    """``forward(images NHWC, taps)`` -> ``{"maps": [(B, h, w, C)] per tap,
    "grid_hw": (h, w)}``; blocks past the last tap are not run."""

    def __init__(self, cfg: SAMViTConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.patch_embed = nn.Conv2d(3, c.width, c.patch_size, stride=c.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, *c.table_grid, c.width))
        self.blocks = nn.ModuleList(
            SAMBlock(c, 0 if i in c.global_attn_indexes else c.window_size)
            for i in range(c.depth))

    @property
    def dtype(self) -> torch.dtype:
        return self.patch_embed.weight.dtype

    def forward(self, images: torch.Tensor, taps: Sequence[int]):
        c = self.cfg
        B, H, W, _ = images.shape
        gh, gw = H // c.patch_size, W // c.patch_size
        dtype = self.dtype
        x = self.patch_embed(images.permute(0, 3, 1, 2).to(dtype)).permute(0, 2, 3, 1)

        pos = self.pos_embed[0].float()
        if (gh, gw) != tuple(c.table_grid):
            pos = resize(pos, (gh, gw), mode="bicubic")
        x = x + pos[None].to(dtype)

        taps = list(taps)
        outputs = {}
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in taps:
                outputs[i] = x
            if i == max(taps):
                break
        return {"maps": [outputs[i] for i in taps], "grid_hw": (gh, gw)}


@torch.no_grad()
def init_sam_(model: SAMViT, generator: torch.Generator) -> SAMViT:
    """Random init with the JAX package's distributions (flax defaults):
    lecun-normal kernels, zero biases, LayerNorm ones/zeros, zero
    relative-position tables, N(0, 0.02) pos-embed."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, SAMAttention):
            mod.rel_pos_h.zero_()
            mod.rel_pos_w.zero_()
    model.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model
