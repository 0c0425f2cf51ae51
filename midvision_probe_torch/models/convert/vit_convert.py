"""ViT state_dict conversion (copy of the JAX package's
``models/convert/vit_convert.py``): timm/DINO fused-qkv and HF split-qkv
layouts -> a numpy tree in the JAX package's ``ViT`` layout, which
``convert.from_jax.vit_state_dict`` maps onto the port's ``ViT``."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from midvision_probe_torch.models.convert.common import _np
from midvision_probe_torch.models.vit import ViTConfig


def _ln(sd: Mapping, key: str) -> dict:
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def _dense(sd: Mapping, key: str, bias: bool = True) -> dict:
    out = {"kernel": _np(sd[f"{key}.weight"]).T}
    if bias and f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def convert_vit_timm(
    sd: Mapping[str, Any], cfg: ViTConfig, prefix: str = ""
) -> dict:
    """timm/DINO/iBOT/DeiT naming → params in the ``models.vit.ViT`` layout.

    Covers: ``cls_token``, ``pos_embed``, ``register_tokens``,
    ``patch_embed.proj``, ``blocks.N.{norm1,attn.qkv,attn.proj,norm2,
    mlp.fc1,mlp.fc2}``, LayerScale (``gamma_1``/``ls1.gamma``), final
    ``norm``.
    """
    g = lambda k: sd[prefix + k]  # noqa: E731
    has = lambda k: (prefix + k) in sd  # noqa: E731

    params: dict[str, Any] = {}
    pe_w = _np(g("patch_embed.proj.weight"))  # (C, 3, p, p)
    params["patch_embed"] = {
        "kernel": pe_w.transpose(2, 3, 1, 0),
        "bias": _np(g("patch_embed.proj.bias")),
    }
    if cfg.class_token and has("cls_token"):
        params["cls_token"] = _np(g("cls_token")).reshape(1, 1, -1)
    if has("pos_embed"):
        params["pos_embed"] = _np(g("pos_embed")).reshape(
            -1, _np(g("pos_embed")).shape[-1]
        )
    if cfg.num_register_tokens and has("register_tokens"):
        params["register_tokens"] = _np(g("register_tokens")).reshape(
            1, cfg.num_register_tokens, -1
        )

    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        block: dict[str, Any] = {
            "norm1": _ln(sub, f"{b}.norm1"),
            "norm2": _ln(sub, f"{b}.norm2"),
            "mlp": {
                "fc1": _dense(sub, f"{b}.mlp.fc1"),
                "fc2": _dense(sub, f"{b}.mlp.fc2"),
            },
        }
        attn: dict[str, Any] = {"proj": _dense(sub, f"{b}.attn.proj")}
        if f"{b}.attn.q_bias" in sub:
            # BEiT: fused qkv weight, but bias only on q and v
            # (impl_utils/beit_model.py) — k bias is structurally zero
            qb = _np(sub[f"{b}.attn.q_bias"])
            vb = _np(sub[f"{b}.attn.v_bias"])
            attn["qkv"] = {
                "kernel": _np(sub[f"{b}.attn.qkv.weight"]).T,
                "bias": np.concatenate([qb, np.zeros_like(qb), vb]),
            }
        elif f"{b}.attn.qkv.weight" in sub:
            attn["qkv"] = _dense(sub, f"{b}.attn.qkv", bias=cfg.qkv_bias)
        else:  # split q/k/v (some local impls)
            qw = _np(sub[f"{b}.attn.q.weight"])
            kw = _np(sub[f"{b}.attn.k.weight"])
            vw = _np(sub[f"{b}.attn.v.weight"])
            attn["qkv"] = {"kernel": np.concatenate([qw, kw, vw], axis=0).T}
            if cfg.qkv_bias:
                attn["qkv"]["bias"] = np.concatenate(
                    [
                        _np(sub[f"{b}.attn.q.bias"]),
                        _np(sub[f"{b}.attn.k.bias"]),
                        _np(sub[f"{b}.attn.v.bias"]),
                    ]
                )
        if cfg.rel_pos_bias and f"{b}.attn.relative_position_bias_table" in sub:
            attn["rel_pos_bias_table"] = _np(
                sub[f"{b}.attn.relative_position_bias_table"]
            )
        block["attn"] = attn
        if cfg.layerscale:
            if f"{b}.gamma_1" in sub:
                block["gamma_1"] = _np(sub[f"{b}.gamma_1"])
                block["gamma_2"] = _np(sub[f"{b}.gamma_2"])
            elif f"{b}.ls1.gamma" in sub:
                block["gamma_1"] = _np(sub[f"{b}.ls1.gamma"])
                block["gamma_2"] = _np(sub[f"{b}.ls2.gamma"])
        params[f"blocks_{i}"] = block

    if cfg.final_norm and "norm.weight" in sub:
        params["norm"] = _ln(sub, "norm")
    if cfg.pre_norm and "norm_pre.weight" in sub:
        params["norm_pre"] = _ln(sub, "norm_pre")
    return {"params": params}


def convert_vit_hf(sd: Mapping[str, Any], cfg: ViTConfig, prefix: str = "") -> dict:
    """HuggingFace ViT / ViTMAE naming → params in the ``models.vit.ViT`` layout.

    Layout: ``embeddings.cls_token``, ``embeddings.position_embeddings``,
    ``embeddings.patch_embeddings.projection``, ``encoder.layer.N.
    {layernorm_before, attention.attention.{query,key,value},
    attention.output.dense, intermediate.dense, output.dense,
    layernorm_after}``, final ``layernorm`` (reference MAE wrapper:
    ``mae.py:33-104``).
    """
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    params: dict[str, Any] = {}
    pe_w = _np(sub["embeddings.patch_embeddings.projection.weight"])
    params["patch_embed"] = {
        "kernel": pe_w.transpose(2, 3, 1, 0),
        "bias": _np(sub["embeddings.patch_embeddings.projection.bias"]),
    }
    if cfg.class_token:
        params["cls_token"] = _np(sub["embeddings.cls_token"]).reshape(1, 1, -1)
    if cfg.pos_embed == "learned" and "embeddings.position_embeddings" in sub:
        pos = _np(sub["embeddings.position_embeddings"])
        params["pos_embed"] = pos.reshape(-1, pos.shape[-1])

    for i in range(cfg.depth):
        b = f"encoder.layer.{i}"
        qw = _np(sub[f"{b}.attention.attention.query.weight"])
        kw = _np(sub[f"{b}.attention.attention.key.weight"])
        vw = _np(sub[f"{b}.attention.attention.value.weight"])
        qkv = {"kernel": np.concatenate([qw, kw, vw], axis=0).T}
        if cfg.qkv_bias:
            qkv["bias"] = np.concatenate(
                [
                    _np(sub[f"{b}.attention.attention.query.bias"]),
                    _np(sub[f"{b}.attention.attention.key.bias"]),
                    _np(sub[f"{b}.attention.attention.value.bias"]),
                ]
            )
        params[f"blocks_{i}"] = {
            "norm1": _ln(sub, f"{b}.layernorm_before"),
            "norm2": _ln(sub, f"{b}.layernorm_after"),
            "attn": {"qkv": qkv, "proj": _dense(sub, f"{b}.attention.output.dense")},
            "mlp": {
                "fc1": _dense(sub, f"{b}.intermediate.dense"),
                "fc2": _dense(sub, f"{b}.output.dense"),
            },
        }

    if cfg.final_norm and "layernorm.weight" in sub:
        params["norm"] = _ln(sub, "layernorm")
    return {"params": params}
