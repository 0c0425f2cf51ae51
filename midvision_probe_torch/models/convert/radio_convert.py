"""NVIDIA RADIO checkpoint → ViT params (numpy, the JAX package's layout) +
input-conditioner stats (copy of the JAX package's
``models/convert/radio_convert.py``).

Reference wrapper: ``evals/models/radio.py:35-115`` — the trunk is a ViT
whose embedding stage is RADIO's ``ViTPatchGenerator`` (linear patch
embedder over (ph, pw, c)-flattened patches, cropped positional embedding
applied to patches only, learned CLS token with no positional entry) and
whose tapped block outputs are each passed through the final ``model.norm``
(``radio.py:88-95``). ``radio.make_preprocessor_external()`` exposes the
``input_conditioner`` (normalization mean/std) for the caller — returned
here so the extractor can fold it into its preprocessing spec.

Key layout (torch.hub ``radio_model`` state_dict, trunk under
``base_model.model.`` / ``radio_model.model.`` / ``model.``):
  [prefix]patch_generator.embedder.weight   (D, p*p*3), (ph, pw, c) order
  [prefix]patch_generator.embedder.bias     (D,) [optional]
  [prefix]patch_generator.pos_embed         (1, G*G, D) — no CLS row
  [prefix]patch_generator.cls_token.token   (1, 1, D)
  [prefix]blocks.N.*                        timm naming
  [prefix]norm.{weight,bias}                final norm (applied per tap)
  [conditioner]input_conditioner.norm_mean / norm_std
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from midvision_probe_torch.models.convert.common import _np
from midvision_probe_torch.models.convert.vit_convert import convert_vit_timm
from midvision_probe_torch.models.vit import ViTConfig

_TRUNK_PREFIXES = ("base_model.model.", "radio_model.model.", "model.", "")
_COND_PREFIXES = ("base_model.", "radio_model.", "")


def convert_radio(sd: Mapping[str, Any], cfg: ViTConfig,
                  prefix: str = "") -> tuple[dict, dict]:
    """Returns ``(variables, extras)``; extras may carry
    ``image_mean``/``image_std`` from the input conditioner."""
    for p in ((prefix,) if prefix else _TRUNK_PREFIXES):
        if f"{p}blocks.0.attn.qkv.weight" in sd:
            prefix = p
            break
    else:
        raise KeyError("no RADIO trunk found (blocks.0.attn.qkv.weight)")

    g = lambda k: sd[f"{prefix}patch_generator.{k}"]  # noqa: E731
    p_, D = cfg.patch_size, cfg.width
    # present the patch generator in timm naming: the linear embedder over
    # (ph, pw, c)-flattened patches IS a stride-p conv with torch layout
    # (D, c, ph, pw)
    shim = dict(sd)
    emb_w = _np(g("embedder.weight"))  # (D, p*p*3)
    shim[f"{prefix}patch_embed.proj.weight"] = (
        emb_w.reshape(D, p_, p_, 3).transpose(0, 3, 1, 2))
    if f"{prefix}patch_generator.embedder.bias" in sd:
        shim[f"{prefix}patch_embed.proj.bias"] = _np(g("embedder.bias"))
    else:
        shim[f"{prefix}patch_embed.proj.bias"] = np.zeros(D, np.float32)
    pos = _np(g("pos_embed"))
    shim[f"{prefix}pos_embed"] = pos.reshape(-1, pos.shape[-1])  # no CLS row
    shim[f"{prefix}cls_token"] = _np(g("cls_token.token"))

    variables = convert_vit_timm(shim, cfg, prefix=prefix)

    extras: dict = {}
    for cp in _COND_PREFIXES:
        if f"{cp}input_conditioner.norm_mean" in sd:
            extras["image_mean"] = tuple(
                _np(sd[f"{cp}input_conditioner.norm_mean"]).reshape(-1))
            extras["image_std"] = tuple(
                _np(sd[f"{cp}input_conditioner.norm_std"]).reshape(-1))
            break
    return variables, extras
