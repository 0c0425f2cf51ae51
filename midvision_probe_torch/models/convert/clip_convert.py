"""open_clip / CLIP visual-tower state_dict -> numpy tree in the JAX
package's ``ViT`` layout (copy of the JAX package's
``models/convert/clip_convert.py``).

Layout (open_clip ``VisualTransformer``): ``visual.conv1.weight`` (no bias),
``visual.class_embedding``, ``visual.positional_embedding``,
``visual.ln_pre``, ``visual.transformer.resblocks.N.{ln_1,
attn.in_proj_weight/in_proj_bias, attn.out_proj, ln_2, mlp.c_fc,
mlp.c_proj}``, ``visual.ln_post`` (reference wrapper: ``clip.py:27-101``).

torch ``nn.MultiheadAttention`` fuses the qkv rows as [q; k; v], the order
of the ViT's fused qkv projection, so the kernel is a plain transpose.
"""

from __future__ import annotations

from typing import Any, Mapping

from midvision_probe_torch.models.convert.common import _np
from midvision_probe_torch.models.vit import ViTConfig


def convert_vit_openclip(sd: Mapping[str, Any], cfg: ViTConfig,
                         prefix: str = "visual.") -> dict:
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    params: dict[str, Any] = {
        "patch_embed": {"kernel": _np(sub["conv1.weight"]).transpose(2, 3, 1, 0)},
        "cls_token": _np(sub["class_embedding"]).reshape(1, 1, -1),
        "pos_embed": _np(sub["positional_embedding"]),
    }
    if "ln_pre.weight" in sub:
        params["norm_pre"] = {
            "scale": _np(sub["ln_pre.weight"]),
            "bias": _np(sub["ln_pre.bias"]),
        }
    for i in range(cfg.depth):
        b = f"transformer.resblocks.{i}"
        params[f"blocks_{i}"] = {
            "norm1": {"scale": _np(sub[f"{b}.ln_1.weight"]),
                      "bias": _np(sub[f"{b}.ln_1.bias"])},
            "norm2": {"scale": _np(sub[f"{b}.ln_2.weight"]),
                      "bias": _np(sub[f"{b}.ln_2.bias"])},
            "attn": {
                "qkv": {
                    "kernel": _np(sub[f"{b}.attn.in_proj_weight"]).T,
                    "bias": _np(sub[f"{b}.attn.in_proj_bias"]),
                },
                "proj": {
                    "kernel": _np(sub[f"{b}.attn.out_proj.weight"]).T,
                    "bias": _np(sub[f"{b}.attn.out_proj.bias"]),
                },
            },
            "mlp": {
                "fc1": {"kernel": _np(sub[f"{b}.mlp.c_fc.weight"]).T,
                        "bias": _np(sub[f"{b}.mlp.c_fc.bias"])},
                "fc2": {"kernel": _np(sub[f"{b}.mlp.c_proj.weight"]).T,
                        "bias": _np(sub[f"{b}.mlp.c_proj.bias"])},
            },
        }
    if cfg.final_norm and "ln_post.weight" in sub:
        params["norm"] = {"scale": _np(sub["ln_post.weight"]),
                          "bias": _np(sub["ln_post.bias"])}
    return {"params": params}
