"""ConvNeXt(-v2) with 4 stage taps (counterpart of the JAX package's
``models/convnext.py``; reference wrapper ``evals/models/convnext.py``:
open_clip laion trunk / timm in22k / FCMAE-v2).

Architecture (timm layout): stem conv4x4/s4 + LN; stages of blocks
[dwconv 7x7 -> LN -> fc1 (4x) -> GELU -> (GRN for v2) -> fc2 -> layer-scale
gamma (v1) -> residual]; LN + conv2x2/s2 downsample between stages.

Channels-last throughout: the activations are NHWC tensors, and each
convolution reads them as a channels-last NCHW view (``permute``, no copy),
the memory format cuDNN's kernels take. The depthwise 7x7, the stem and the
downsample convolutions are library convolutions, as the JAX package's
``nn.Conv`` are.

Mixed precision as in the JAX package: the module runs in its parameters'
dtype, except GRN's ``grn_gamma``/``grn_beta``, which stay float32
(``KEEP_F32``): GRN's statistics are f32, ``nx`` is rounded to the compute
dtype, ``h * nx`` is formed there, then promoted to f32 against the f32
``grn_gamma``/``grn_beta``, added to ``h`` in f32 and cast back.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn

from midvision_probe_torch.models.vit import _lecun_normal_
from midvision_probe_torch.ops.activations import gelu

# parameters that stay float32 when the module is cast to a half dtype
KEEP_F32 = ("grn_gamma", "grn_beta")


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: tuple = (3, 3, 27, 3)
    dims: tuple = (128, 256, 512, 1024)  # ConvNeXt-Base
    use_grn: bool = False  # v2 (FCMAE) replaces layer-scale with GRN
    layernorm_eps: float = 1e-6


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on an NHWC tensor, read as a channels-last NCHW view."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    def __init__(self, cfg: ConvNeXtConfig, dim: int):
        super().__init__()
        self.use_grn = cfg.use_grn
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=cfg.layernorm_eps)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        if cfg.use_grn:
            self.grn_gamma = nn.Parameter(torch.zeros(4 * dim))
            self.grn_beta = nn.Parameter(torch.zeros(4 * dim))
        else:
            self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        h = _conv_nhwc(self.dwconv, x)
        h = self.norm(h)
        h = gelu(self.pwconv1(h))
        if self.use_grn:
            # the f32 L2 norm over the spatial axes without an f32 copy of h;
            # then f32(grn_gamma * bf16(h * nx) + grn_beta) + h, cast back
            gx = torch.linalg.vector_norm(h, dim=(1, 2), keepdim=True, dtype=torch.float32)
            nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
            out = torch.addcmul(self.grn_beta.float(), self.grn_gamma.float(),
                                h * nx.to(h.dtype))
            h = out.add_(h).to(x.dtype)
        h = self.pwconv2(h)
        if not self.use_grn:
            h = h * self.gamma.to(h.dtype)
        return x + h


class ConvNeXt(nn.Module):
    """``forward(images NHWC, taps)`` -> the NHWC stage outputs at ``taps``
    (stage s at 1/(4*2^s) of the input)."""

    def __init__(self, cfg: ConvNeXtConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.stem_conv = nn.Conv2d(3, c.dims[0], 4, stride=4)
        self.stem_norm = nn.LayerNorm(c.dims[0], eps=c.layernorm_eps)
        self.downsample_norm = nn.ModuleList()
        self.downsample_conv = nn.ModuleList()
        for s in range(1, len(c.dims)):
            self.downsample_norm.append(nn.LayerNorm(c.dims[s - 1], eps=c.layernorm_eps))
            self.downsample_conv.append(nn.Conv2d(c.dims[s - 1], c.dims[s], 2, stride=2))
        self.stages = nn.ModuleList(
            nn.ModuleList(ConvNeXtBlock(c, dim) for _ in range(depth))
            for depth, dim in zip(c.depths, c.dims))

    @property
    def dtype(self) -> torch.dtype:
        return self.stem_conv.weight.dtype

    def forward(self, images: torch.Tensor, taps: Sequence[int] = (0, 1, 2, 3)):
        x = _conv_nhwc(self.stem_conv, images.to(self.dtype))
        x = self.stem_norm(x)
        outputs = {}
        for s, blocks in enumerate(self.stages):
            if s > 0:
                x = self.downsample_norm[s - 1](x)
                x = _conv_nhwc(self.downsample_conv[s - 1], x)
            for blk in blocks:
                x = blk(x)
            outputs[s] = x
        return [outputs[i] for i in taps]


@torch.no_grad()
def init_convnext_(model: ConvNeXt, generator: torch.Generator) -> ConvNeXt:
    """Random init with the JAX package's distributions (flax defaults):
    lecun-normal kernels (fan-in of a depthwise kernel: its 49 taps), zero
    biases, LayerNorm ones/zeros, ``gamma`` 1e-6, GRN zeros."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, ConvNeXtBlock):
            if mod.use_grn:
                mod.grn_gamma.zero_()
                mod.grn_beta.zero_()
            else:
                mod.gamma.fill_(1e-6)
    return model
