"""Weight bridge: the JAX package's flax variables (nested dicts of numpy
arrays) -> the port's ``state_dict``s. Never imports jax: callers hand in
numpy pytrees (``np.asarray`` of each leaf).

Layout rules:
* Dense kernel ``(in, out)`` -> Linear weight ``(out, in)``; the fused qkv
  column order ``(role, head, j)`` is kept as is;
* Conv kernel HWIO -> OIHW (the ViT patch embed, probe convs and the
  folded ``NearestUpConv``s alike);
* LayerNorm/BatchNorm ``scale`` -> ``weight``; BatchNorm statistics
  ``mean``/``var`` -> ``running_mean``/``running_var``;
* ViT ``blocks_{i}`` -> ``blocks.{i}``, ``patch_embed`` -> ``patch_embed.proj``,
  the ``(T, C)`` pos-embed table -> ``(1, T, C)``; LayerScale's
  ``gamma_1``/``gamma_2``, ``register_tokens`` and each block's
  ``attn.rel_pos_bias_table`` keep their names;
* ResNet ``layer{s}_{b}`` -> ``layer{s}.{b}``, ``downsample_conv`` /
  ``downsample_bn`` -> ``downsample.0`` / ``.1`` (torchvision's names);
* ConvNeXt ``stage{s}_block{b}`` -> ``stages.{s}.{b}``,
  ``downsample_{norm,conv}_{s}`` -> ``downsample_{norm,conv}.{s-1}``; GRN's
  ``grn_gamma``/``grn_beta`` and the v1 ``gamma`` keep their names;
* SAM ``blocks_{i}`` -> ``blocks.{i}``, the ``(H, W, C)`` pos-embed table
  -> ``(1, H, W, C)``; the per-axis ``rel_pos_h``/``rel_pos_w`` keep their
  names;
* a head's auto-named decoder (``DPT_0``, ``Linear_0``, ``MultiscaleHead_0``)
  -> ``decoder``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_DECODER = re.compile(r"^(DPT|Linear|MultiscaleHead)_0$")
_BLOCK = re.compile(r"^blocks_(\d+)$")
_RESNET_BLOCK = re.compile(r"^(layer\d)_(\d+)$")
_CONVNEXT_BLOCK = re.compile(r"^stage(\d+)_block(\d+)$")
_CONVNEXT_DOWNSAMPLE = re.compile(r"^downsample_(norm|conv)_(\d+)$")
_RESNET_DOWNSAMPLE = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _leaf(name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif value.ndim == 2:
            value = value.T  # (in, out) -> (out, in)
        return "weight", value
    if name == "scale":
        return "weight", value
    if name in ("mean", "var"):
        return f"running_{name}", value
    return name, value


def _to_state_dict(tree: Mapping, rename_module) -> dict[str, torch.Tensor]:
    out = {}
    for path, value in _flatten(tree):
        mods = [rename_module(m) for m in path[:-1]]
        leaf, value = _leaf(path[-1], value)
        key = ".".join([m for m in mods if m] + [leaf])
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return out


def vit_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``ViT`` variables (``{"params": ...}``) -> port ``ViT`` state_dict."""
    def rename(m):
        if m == "patch_embed":
            return "patch_embed.proj"
        b = _BLOCK.match(m)
        return f"blocks.{b.group(1)}" if b else m

    sd = _to_state_dict(variables["params"], rename)
    if "pos_embed" in sd:
        sd["pos_embed"] = sd["pos_embed"][None]
    return sd


def resnet_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``ResNet50`` variables (``{"params": ..., "batch_stats": ...}``)
    -> port ``ResNet50`` state_dict (torchvision's key names)."""
    def rename(m):
        b = _RESNET_BLOCK.match(m)
        return f"{b.group(1)}.{b.group(2)}" if b else _RESNET_DOWNSAMPLE.get(m, m)

    sd = _to_state_dict(variables["params"], rename)
    sd.update(_to_state_dict(variables["batch_stats"], rename))
    return sd


def convnext_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``ConvNeXt`` variables -> port ``ConvNeXt`` state_dict."""
    def rename(m):
        b = _CONVNEXT_BLOCK.match(m)
        if b:
            return f"stages.{b.group(1)}.{b.group(2)}"
        d = _CONVNEXT_DOWNSAMPLE.match(m)
        return f"downsample_{d.group(1)}.{int(d.group(2)) - 1}" if d else m

    return _to_state_dict(variables["params"], rename)


def sam_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``SAMViT`` variables -> port ``SAMViT`` state_dict."""
    def rename(m):
        b = _BLOCK.match(m)
        return f"blocks.{b.group(1)}" if b else m

    sd = _to_state_dict(variables["params"], rename)
    sd["pos_embed"] = sd["pos_embed"][None]
    return sd


def probe_state_dict(params: Mapping,
                     batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """A head's (or TapNorms') flax params (+ batch_stats) -> state_dict."""
    def rename(m):
        return "decoder" if _DECODER.match(m) else m

    sd = _to_state_dict(params, rename)
    if batch_stats:
        sd.update(_to_state_dict(batch_stats, rename))
    return sd


def trainer_state_dict(params: Mapping,
                       batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """The JAX trainer's ``{"probe": ..., "tap": ...}`` params/batch_stats
    -> the state_dict of the port trainer's probe + tap-norm modules."""
    batch_stats = batch_stats or {}
    sd = {}
    for group in ("probe", "tap"):
        if group in params:
            part = probe_state_dict(params[group], batch_stats.get(group))
            sd.update({f"{group}.{k}": v for k, v in part.items()})
    return sd
