"""Plain float32 ViT of the DINO and DINOv2 families with per-layer taps:
the benchmark's reference for the frozen backbone.

Written from the published models (DINO, Caron et al. 2021,
facebookresearch/dino ``vision_transformer.py``; DINOv2, Oquab et al. 2023,
facebookresearch/dinov2 ``layers/block.py``): a strided patch convolution,
a cls token, a learned position table resized bicubically (antialiased) to
the input's patch grid, then pre-norm blocks of multi-head softmax
attention and a GELU MLP, with LayerScale on both branches where the model
has it. The taps are raw block outputs; their spatial tokens become an
NHWC map (``dense``), with the cls token appended to every position's
channels for ``dense-cls``.

Departures from the published code, each exact or named:
* the position table is resized with ``F.interpolate(mode="bicubic",
  antialias=True)`` from its stored grid (the published code resizes with
  a scale factor and no antialias; the program resizes as here);
* GELU is the exact erf form; a bfloat16 program may use the tanh form,
  and that difference is part of what the comparison reads.

``lowp="fp8"`` rounds every matrix product's operands to float8 e4m3 with
one scale per tensor (its absolute maximum onto 448): the control that the
comparison has to fail. Parameters are a flat dict under the published
names (``blocks.{i}.attn.qkv.weight``, ...). Imports torch alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def lowp_round(x: torch.Tensor, lowp: str | None) -> torch.Tensor:
    """``x`` as ``lowp`` holds it, back in float32 (``None``: ``x``)."""
    if lowp is None:
        return x
    if lowp != "fp8":
        raise ValueError(f"unknown low precision {lowp!r}")
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter of the backbone under its published name."""
    w, p, g = cfg["width"], cfg["patch_size"], cfg["table_grid"]
    hidden = int(w * cfg["mlp_ratio"])
    shapes = {"cls_token": (1, 1, w), "pos_embed": (1, g * g + 1, w),
              "patch_embed.proj.weight": (w, 3, p, p), "patch_embed.proj.bias": (w,)}
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        if cfg["layerscale"]:
            shapes[b + "gamma_1"] = (w,)
            shapes[b + "gamma_2"] = (w,)
        shapes.update({
            b + "norm1.weight": (w,), b + "norm1.bias": (w,),
            b + "attn.qkv.weight": (3 * w, w), b + "attn.qkv.bias": (3 * w,),
            b + "attn.proj.weight": (w, w), b + "attn.proj.bias": (w,),
            b + "norm2.weight": (w,), b + "norm2.bias": (w,),
            b + "mlp.fc1.weight": (hidden, w), b + "mlp.fc1.bias": (hidden,),
            b + "mlp.fc2.weight": (w, hidden), b + "mlp.fc2.bias": (w,),
        })
    return shapes


def grid_hw(cfg: dict) -> tuple[int, int]:
    """The patch grid of the configuration's images."""
    h, w = cfg["image_hw"]
    return h // cfg["patch_size"], w // cfg["patch_size"]


def feat_dim(cfg: dict) -> int:
    """Channels of one tap's map."""
    return cfg["width"] * (2 if cfg["output"] == "dense-cls" else 1)


def _linear(x, params, name, lowp):
    return F.linear(lowp_round(x, lowp), lowp_round(params[name + ".weight"], lowp),
                    params[name + ".bias"])


def _attention(q, k, v, scale, lowp):
    """Softmax attention over (B, H, N, d) operands."""
    s = torch.matmul(lowp_round(q * scale, lowp), lowp_round(k, lowp).transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(lowp_round(p, lowp), lowp_round(v, lowp))


def features(params: dict, cfg: dict, images: torch.Tensor,
             lowp: str | None = None) -> list[torch.Tensor]:
    """images (B, H, W, 3) float32 -> one (B, gh, gw, C) map per tap."""
    w, p, heads = cfg["width"], cfg["patch_size"], cfg["num_heads"]
    d = w // heads
    eps = cfg["layernorm_eps"]
    B = images.shape[0]
    gh, gw = grid_hw(cfg)
    x = F.conv2d(lowp_round(images.permute(0, 3, 1, 2), lowp),
                 lowp_round(params["patch_embed.proj.weight"], lowp),
                 params["patch_embed.proj.bias"], stride=p)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([params["cls_token"].expand(B, -1, -1), x], dim=1)
    g = cfg["table_grid"]
    pos = params["pos_embed"][0]
    table = pos[1:].reshape(1, g, g, w).permute(0, 3, 1, 2)
    table = F.interpolate(table, size=(gh, gw), mode="bicubic", align_corners=False,
                          antialias=True)
    x = x + torch.cat([pos[:1], table[0].permute(1, 2, 0).reshape(gh * gw, w)])[None]
    N = x.shape[1]
    taps, out = cfg["taps"], []
    for i in range(max(taps) + 1):
        b = f"blocks.{i}."
        h = F.layer_norm(x, (w,), params[b + "norm1.weight"], params[b + "norm1.bias"], eps)
        qkv = _linear(h, params, b + "attn.qkv", lowp)
        q, k, v = qkv.reshape(B, N, 3, heads, d).permute(2, 0, 3, 1, 4)
        h = _attention(q, k, v, d**-0.5, lowp).transpose(1, 2).reshape(B, N, w)
        h = _linear(h, params, b + "attn.proj", lowp)
        if cfg["layerscale"]:
            h = h * params[b + "gamma_1"]
        x = x + h
        h = F.layer_norm(x, (w,), params[b + "norm2.weight"], params[b + "norm2.bias"], eps)
        h = _linear(F.gelu(_linear(h, params, b + "mlp.fc1", lowp)), params, b + "mlp.fc2",
                    lowp)
        if cfg["layerscale"]:
            h = h * params[b + "gamma_2"]
        x = x + h
        if i in taps:
            out.append(_to_map(x, cfg["output"], gh, gw))
    return [out[sorted(taps).index(t)] for t in taps]


def _to_map(x: torch.Tensor, output: str, gh: int, gw: int) -> torch.Tensor:
    B, _, C = x.shape
    dense = x[:, 1:].reshape(B, gh, gw, C)
    if output == "dense":
        return dense
    if output == "dense-cls":
        return torch.cat([dense, x[:, 0, None, None, :].expand(B, gh, gw, C)], dim=-1)
    raise ValueError(f"unknown output {output!r}")
