"""segment_anything image-encoder state_dict -> numpy tree in the JAX
package's ``SAMViT`` layout (copy of the JAX package's
``models/convert/sam_convert.py``), which ``convert.from_jax.sam_state_dict``
maps onto the port's ``SAMViT``.

Only ``image_encoder.*`` (``prefix``) is read: the released files' prompt
encoder and mask decoder, and the encoder's neck (the reference taps block
outputs), are skipped.
"""

from __future__ import annotations

from typing import Any, Mapping

from midvision_probe_torch.models.convert.common import _np
from midvision_probe_torch.models.vit_sam import SAMViTConfig


def convert_sam(sd: Mapping[str, Any], cfg: SAMViTConfig,
                prefix: str = "image_encoder.") -> dict:
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    def dense(key: str) -> dict:
        return {"kernel": _np(sub[f"{key}.weight"]).T, "bias": _np(sub[f"{key}.bias"])}

    def ln(key: str) -> dict:
        return {"scale": _np(sub[f"{key}.weight"]), "bias": _np(sub[f"{key}.bias"])}

    params: dict[str, Any] = {
        "patch_embed": {
            "kernel": _np(sub["patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sub["patch_embed.proj.bias"]),
        },
        "pos_embed": _np(sub["pos_embed"])[0],  # (1, H, W, C) -> (H, W, C)
    }
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        params[f"blocks_{i}"] = {
            "norm1": ln(f"{b}.norm1"),
            "norm2": ln(f"{b}.norm2"),
            "attn": {
                "qkv": dense(f"{b}.attn.qkv"),
                "proj": dense(f"{b}.attn.proj"),
                "rel_pos_h": _np(sub[f"{b}.attn.rel_pos_h"]),
                "rel_pos_w": _np(sub[f"{b}.attn.rel_pos_w"]),
            },
            "mlp_lin1": dense(f"{b}.mlp.lin1"),
            "mlp_lin2": dense(f"{b}.mlp.lin2"),
        }
    return {"params": params}
