"""Full-size torch replicas of the released backbones, the independent
oracles of the weights-landing drill's goldens (``export_golden.py``).

A jax-free copy of the repository's ``data_processing/torch_replicas.py``
(the timm-naming ViT, the torchvision-naming ResNet-50, RADIO's trunk) and
of the test replicas that its ``export_golden.py`` reaches (the BEiT
rel-pos-bias ViT, the open_clip visual tower, ConvNeXt). Each replica is
written from its source's structure, not from the port's modules; the
fixed 2D sin-cos table is this package's own
(``models/vit.py::get_2d_sincos_pos_embed``). CPU float32 only: these are
oracles, never the measured path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from midvision_probe_torch.models.vit import get_2d_sincos_pos_embed

# --------------------------------------------------------------------------
# timm-naming ViT (dino.py:164-210, ibot_transformers.py blocks)
# --------------------------------------------------------------------------


class TimmAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = ((q @ k.transpose(-2, -1)) * self.scale).softmax(dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B, N, C))


class _LSGamma(nn.Module):
    """DINOv2 LayerScale submodule naming (``blocks.N.ls1.gamma``)."""

    def __init__(self, dim, init=1e-4):
        super().__init__()
        self.gamma = nn.Parameter(init * torch.ones(dim))


class TimmBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, layerscale=False, eps=1e-6,
                 ls_naming="gamma", act="gelu"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = TimmAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = nn.Sequential()
        self.mlp.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        # SigLIP trains in big_vision with JAX's default tanh-approx gelu
        self.mlp.act = nn.GELU(approximate="tanh" if act == "gelu_tanh"
                               else "none")
        self.mlp.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self._ls = None
        if layerscale and ls_naming == "ls":
            self.ls1 = _LSGamma(dim)
            self.ls2 = _LSGamma(dim)
            self._ls = "ls"
        elif layerscale:
            self.gamma_1 = nn.Parameter(1e-4 * torch.ones(dim))
            self.gamma_2 = nn.Parameter(1e-4 * torch.ones(dim))
            self._ls = "gamma"

    def _g(self, which):
        if self._ls == "ls":
            return (self.ls1 if which == 1 else self.ls2).gamma
        if self._ls == "gamma":
            return self.gamma_1 if which == 1 else self.gamma_2
        return None

    def forward(self, x):
        h = self.attn(self.norm1(x))
        g1 = self._g(1)
        x = x + (h if g1 is None else g1 * h)
        h = self.mlp.fc2(self.mlp.act(self.mlp.fc1(self.norm2(x))))
        g2 = self._g(2)
        return x + (h if g2 is None else g2 * h)


class TimmViT(nn.Module):
    """timm/DINO-naming ViT; forward returns per-block token taps."""

    def __init__(self, dim=768, depth=12, heads=12, patch=16, grid=14,
                 mlp_ratio=4.0, layerscale=False, class_token=True,
                 final_norm=True, eps=1e-6, seed=0, ls_naming="gamma",
                 act="gelu"):
        super().__init__()
        torch.manual_seed(seed)
        self.patch_embed = nn.Sequential()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, patch)
        n = grid * grid + (1 if class_token else 0)
        if class_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n, dim))
        self.blocks = nn.ModuleList(
            [TimmBlock(dim, heads, mlp_ratio, layerscale, eps, ls_naming, act)
             for _ in range(depth)]
        )
        if final_norm:
            self.norm = nn.LayerNorm(dim, eps=eps)
        self._class_token = class_token
        self._init_realistic()

    def _init_realistic(self):
        """trunc-normal(0.02) like real ViT checkpoints, so a depth-12
        random forward stays numerically tame for golden comparisons."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                nn.init.trunc_normal_(m.weight, std=0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        if self._class_token:
            nn.init.trunc_normal_(self.cls_token, std=0.02)

    def forward(self, x):
        B = x.shape[0]
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        if self._class_token:
            x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        x = x + self.pos_embed
        taps = []
        for blk in self.blocks:
            x = blk(x)
            taps.append(x)
        return taps


# --------------------------------------------------------------------------
# torchvision-naming ResNet-50 (simclr.py:53-66 trunk)
# --------------------------------------------------------------------------


class TorchBottleneck(nn.Module):
    def __init__(self, cin, width, stride=1, downsample=False):
        super().__init__()
        cout = width * 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU()
        self.downsample = (
            nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                          nn.BatchNorm2d(cout))
            if downsample else None
        )

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        h = self.relu(self.bn1(self.conv1(x)))
        h = self.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return self.relu(h + idt)


class TorchResNet50(nn.Module):
    def __init__(self, seed=0):
        super().__init__()
        torch.manual_seed(seed)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin, width = 64, 64
        for s, blocks in enumerate([3, 4, 6, 3]):
            layers = []
            for b in range(blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                layers.append(
                    TorchBottleneck(cin, width, stride, downsample=(b == 0)))
                cin = width * 4
            setattr(self, f"layer{s + 1}", nn.Sequential(*layers))
            width *= 2
        # realistic running stats so batch_stats conversion is non-trivial
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        taps = [x]
        for s in range(4):
            x = getattr(self, f"layer{s + 1}")(x)
            taps.append(x)
        return taps


def sincos2d_pos_embed(dim: int, grid: int, cls_row: bool) -> torch.Tensor:
    """MAE-style fixed 2D sin-cos table (mae.py:74-89 regenerates this), as
    (1, tokens, dim)."""
    tab = get_2d_sincos_pos_embed(dim, (grid, grid), add_cls_token=cls_row)
    return torch.from_numpy(np.asarray(tab, np.float32)).unsqueeze(0)


# --------------------------------------------------------------------------
# RADIO trunk (radio.py:84-115: CPE patch generator, patch-only pos embed,
# per-tap final norm)
# --------------------------------------------------------------------------


class RadioViT(nn.Module):
    def __init__(self, dim=1280, depth=32, heads=16, patch=16, grid=16,
                 mlp_ratio=4.0, seed=0):
        super().__init__()
        torch.manual_seed(seed)
        self.patch_generator = nn.Module()
        self.patch_generator.embedder = nn.Linear(3 * patch * patch, dim)
        self.patch_generator.pos_embed = nn.Parameter(
            torch.zeros(1, grid * grid, dim))
        self.patch_generator.cls_token = nn.Module()
        self.patch_generator.cls_token.token = nn.Parameter(
            torch.zeros(1, 1, dim))
        self.blocks = nn.ModuleList(
            [TimmBlock(dim, heads, mlp_ratio) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self._patch = patch
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        nn.init.trunc_normal_(self.patch_generator.pos_embed, std=0.02)
        nn.init.trunc_normal_(self.patch_generator.cls_token.token, std=0.02)

    def forward(self, x):
        B, _, H, W = x.shape
        p = self._patch
        # RADIO flattens patches (ph, pw, c): b c (h p1) (w p2) -> b (h w) (p1 p2 c)
        x = x.unfold(2, p, p).unfold(3, p, p)        # B C gh gw p p
        x = x.permute(0, 2, 3, 4, 5, 1).reshape(B, -1, p * p * 3)
        x = self.patch_generator.embedder(x)
        x = x + self.patch_generator.pos_embed       # patches only
        cls = self.patch_generator.cls_token.token.expand(B, -1, -1)
        x = torch.cat([cls, x], dim=1)               # no pos on cls
        taps = []
        for blk in self.blocks:
            x = blk(x)
            taps.append(self.norm(x))                # radio.py:92-95
        return taps


# --------------------------------------------------------------------------
# BEiT (rel-pos-bias attention, q/v-only bias, LayerScale; the reference's
# impl_utils/beit_model.py structure)
# --------------------------------------------------------------------------


class BEiTAttention(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=False)
        self.q_bias = nn.Parameter(torch.randn(dim) * 0.02)
        self.v_bias = nn.Parameter(torch.randn(dim) * 0.02)
        self.proj = nn.Linear(dim, dim)
        h, w = window
        num_rel = (2 * h - 1) * (2 * w - 1) + 3
        self.relative_position_bias_table = nn.Parameter(
            torch.randn(num_rel, heads) * 0.02
        )
        # BEiT relative_position_index construction
        coords = torch.stack(torch.meshgrid(
            torch.arange(h), torch.arange(w), indexing="ij"))
        coords = coords.flatten(1)
        rel = coords[:, :, None] - coords[:, None, :]
        rel = rel.permute(1, 2, 0).contiguous()
        rel[:, :, 0] += h - 1
        rel[:, :, 1] += w - 1
        rel[:, :, 0] *= 2 * w - 1
        idx = torch.zeros((h * w + 1, h * w + 1), dtype=torch.long)
        idx[1:, 1:] = rel.sum(-1)
        idx[0, 0:] = num_rel - 3
        idx[0:, 0] = num_rel - 2
        idx[0, 0] = num_rel - 1
        self.register_buffer("relative_position_index", idx)

    def forward(self, x):
        B, N, C = x.shape
        bias = torch.cat([
            self.q_bias, torch.zeros_like(self.v_bias), self.v_bias
        ])
        qkv = torch.nn.functional.linear(x, self.qkv.weight, bias)
        qkv = qkv.reshape(B, N, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)
        attn = (q @ k.transpose(-2, -1)) * self.scale
        rel_bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)
        ].view(N, N, -1).permute(2, 0, 1)
        attn = attn + rel_bias.unsqueeze(0)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(x)


class BEiTBlock(nn.Module):
    def __init__(self, dim, heads, window, mlp_ratio=2.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = BEiTAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Sequential()
        self.mlp.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.gamma_1 = nn.Parameter(torch.full((dim,), 0.1))
        self.gamma_2 = nn.Parameter(torch.full((dim,), 0.1))

    def forward(self, x):
        x = x + self.gamma_1 * self.attn(self.norm1(x))
        h = self.mlp.fc2(torch.nn.functional.gelu(self.mlp.fc1(self.norm2(x))))
        return x + self.gamma_2 * h


class BEiT(nn.Module):
    def __init__(self, dim=32, heads=2, depth=2, patch=8, img=24,
                 mlp_ratio=2.0):
        super().__init__()
        self.patch_embed = nn.Sequential()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, patch)
        self.cls_token = nn.Parameter(torch.randn(1, 1, dim) * 0.02)
        g = img // patch
        self.blocks = nn.ModuleList(
            [BEiTBlock(dim, heads, (g, g), mlp_ratio) for _ in range(depth)]
        )

    def forward(self, x):
        B = x.shape[0]
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        taps = []
        for blk in self.blocks:
            x = blk(x)
            taps.append(x)
        return taps


# --------------------------------------------------------------------------
# open_clip visual tower (ResidualAttentionBlock structure)
# --------------------------------------------------------------------------


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class CLIPBlock(nn.Module):
    """open_clip ResidualAttentionBlock structure."""

    def __init__(self, d, heads):
        super().__init__()
        self.ln_1 = nn.LayerNorm(d, eps=1e-5)
        self.attn = nn.MultiheadAttention(d, heads, batch_first=True)
        self.ln_2 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = nn.Sequential()
        self.mlp.c_fc = nn.Linear(d, d * 4)
        self.mlp.gelu = QuickGELU()
        self.mlp.c_proj = nn.Linear(d * 4, d)

    def forward(self, x):
        h = self.ln_1(x)
        h, _ = self.attn(h, h, h, need_weights=False)
        x = x + h
        return x + self.mlp.c_proj(self.mlp.gelu(self.mlp.c_fc(self.ln_2(x))))


class CLIPVisual(nn.Module):
    def __init__(self, d=64, heads=4, depth=2, patch=8, img=32):
        super().__init__()
        self.conv1 = nn.Conv2d(3, d, patch, patch, bias=False)
        n = (img // patch) ** 2
        self.class_embedding = nn.Parameter(torch.randn(d) * 0.02)
        self.positional_embedding = nn.Parameter(torch.randn(n + 1, d) * 0.02)
        self.ln_pre = nn.LayerNorm(d, eps=1e-5)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [CLIPBlock(d, heads) for _ in range(depth)]
        )

    def forward(self, x):
        B = x.shape[0]
        x = self.conv1(x).flatten(2).transpose(1, 2)
        cls = self.class_embedding[None, None].expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        taps = []
        for blk in self.transformer.resblocks:
            x = blk(x)
            taps.append(x)
        return taps


# --------------------------------------------------------------------------
# ConvNeXt (timm naming, the stem's LayerNorm as stem_norm)
# --------------------------------------------------------------------------


class TorchConvNeXtBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Sequential()
        self.mlp.fc1 = nn.Linear(dim, dim * 4)
        self.mlp.fc2 = nn.Linear(dim * 4, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        h = self.conv_dw(x).permute(0, 2, 3, 1)
        h = self.norm(h)
        h = self.mlp.fc2(torch.nn.functional.gelu(self.mlp.fc1(h)))
        h = (self.gamma * h).permute(0, 3, 1, 2)
        return x + h


class TorchConvNeXt(nn.Module):
    def __init__(self, depths=(1, 1), dims=(16, 32)):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv2d(3, dims[0], 4, 4),
            nn.Identity(),  # placeholder; LN applied channel-last below
        )
        self.stem_norm = nn.LayerNorm(dims[0], eps=1e-6)
        self.stages = nn.ModuleList()
        for s, (dep, dim) in enumerate(zip(depths, dims)):
            stage = nn.Module()
            if s > 0:
                stage.downsample = nn.Sequential(
                    ChanLN(dims[s - 1]), nn.Conv2d(dims[s - 1], dim, 2, 2)
                )
            stage.blocks = nn.ModuleList(
                [TorchConvNeXtBlock(dim) for _ in range(dep)]
            )
            self.stages.append(stage)

    def forward(self, x):
        x = self.stem[0](x)
        x = self.stem_norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        taps = []
        for s, stage in enumerate(self.stages):
            if s > 0:
                x = stage.downsample(x)
            for blk in stage.blocks:
                x = blk(x)
            taps.append(x)
        return taps


class ChanLN(nn.Module):
    """channels-first LayerNorm used in ConvNeXt downsample layers."""

    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = torch.nn.functional.layer_norm(
            x, (x.shape[-1],), self.weight, self.bias, 1e-6
        )
        return x.permute(0, 3, 1, 2)
