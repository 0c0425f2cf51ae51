"""diffusers / transformers / LDM state_dicts -> numpy trees for the SD
stack (copy of the JAX package's jax-free ``models/sd/convert.py``).

The trees are the JAX package's flax layouts, array for array the same;
``convert.from_jax.sd_{unet,vae,text}_state_dict`` map them onto the
port's modules, so one tested mapping carries weights into the port
whether they come from JAX or from a file.

* ``convert_unet``, ``convert_vae_encoder``, ``convert_text_encoder``:
  diffusers / transformers naming (SD-2.1's ``sd21/*.bin``),
* ``convert_unet_ldm``, ``convert_vae_encoder_ldm``: LDM/CompVis naming
  (Zero123's lightning checkpoint).
"""

from __future__ import annotations

from typing import Any, Mapping

from midvision_probe_torch.models.convert.common import _np
from midvision_probe_torch.models.sd.text_encoder import CLIPTextConfig
from midvision_probe_torch.models.sd.unet import UNetConfig
from midvision_probe_torch.models.sd.vae import VAEEncoderConfig


def _conv(sd, key):
    return {"kernel": _np(sd[f"{key}.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd[f"{key}.bias"])}


def _dense(sd, key, bias=True):
    w = _np(sd[f"{key}.weight"])
    if w.ndim == 4:
        # SD-1.x diffusers checkpoints store transformer proj_in/proj_out
        # as 1x1 convs; fold to the dense layout (same trick as the LDM
        # path's _conv1x1_as_dense). Anything larger routed here is a
        # layout-mapping bug — fail loudly rather than keep one tap.
        if w.shape[2:] != (1, 1):
            raise ValueError(f"{key}: a dense weight of shape {w.shape}")
        w = w[:, :, 0, 0]
    out = {"kernel": w.T}
    if bias and f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _gn(sd, key):
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def _resnet(sd, p):
    out = {
        "norm1": _gn(sd, f"{p}.norm1"),
        "conv1": _conv(sd, f"{p}.conv1"),
        "norm2": _gn(sd, f"{p}.norm2"),
        "conv2": _conv(sd, f"{p}.conv2"),
    }
    if f"{p}.time_emb_proj.weight" in sd:
        out["time_emb_proj"] = _dense(sd, f"{p}.time_emb_proj")
    if f"{p}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _conv(sd, f"{p}.conv_shortcut")
    return out


def _transformer(sd, p):
    tb = f"{p}.transformer_blocks.0"
    return {
        "norm": _gn(sd, f"{p}.norm"),
        "proj_in": _dense(sd, f"{p}.proj_in"),
        "proj_out": _dense(sd, f"{p}.proj_out"),
        "block": {
            "norm1": {"scale": _np(sd[f"{tb}.norm1.weight"]),
                      "bias": _np(sd[f"{tb}.norm1.bias"])},
            "norm2": {"scale": _np(sd[f"{tb}.norm2.weight"]),
                      "bias": _np(sd[f"{tb}.norm2.bias"])},
            "norm3": {"scale": _np(sd[f"{tb}.norm3.weight"]),
                      "bias": _np(sd[f"{tb}.norm3.bias"])},
            "attn1": {
                "to_q": _dense(sd, f"{tb}.attn1.to_q", bias=False),
                "to_k": _dense(sd, f"{tb}.attn1.to_k", bias=False),
                "to_v": _dense(sd, f"{tb}.attn1.to_v", bias=False),
                "to_out": _dense(sd, f"{tb}.attn1.to_out.0"),
            },
            "attn2": {
                "to_q": _dense(sd, f"{tb}.attn2.to_q", bias=False),
                "to_k": _dense(sd, f"{tb}.attn2.to_k", bias=False),
                "to_v": _dense(sd, f"{tb}.attn2.to_v", bias=False),
                "to_out": _dense(sd, f"{tb}.attn2.to_out.0"),
            },
            "ff_proj": _dense(sd, f"{tb}.ff.net.0.proj"),
            "ff_out": _dense(sd, f"{tb}.ff.net.2"),
        },
    }


def convert_unet(sd: Mapping[str, Any], cfg: UNetConfig) -> dict:
    n = len(cfg.block_out_channels)
    p: dict[str, Any] = {
        "conv_in": _conv(sd, "conv_in"),
        "time_fc1": _dense(sd, "time_embedding.linear_1"),
        "time_fc2": _dense(sd, "time_embedding.linear_2"),
    }
    for lvl in range(n):
        for b in range(cfg.layers_per_block):
            p[f"down_{lvl}_res_{b}"] = _resnet(
                sd, f"down_blocks.{lvl}.resnets.{b}"
            )
            if f"down_blocks.{lvl}.attentions.{b}.norm.weight" in sd:
                p[f"down_{lvl}_attn_{b}"] = _transformer(
                    sd, f"down_blocks.{lvl}.attentions.{b}"
                )
        if f"down_blocks.{lvl}.downsamplers.0.conv.weight" in sd:
            p[f"down_{lvl}_downsample"] = _conv(
                sd, f"down_blocks.{lvl}.downsamplers.0.conv"
            )
    p["mid_res_0"] = _resnet(sd, "mid_block.resnets.0")
    p["mid_res_1"] = _resnet(sd, "mid_block.resnets.1")
    p["mid_attn"] = _transformer(sd, "mid_block.attentions.0")
    for i in range(n):
        for b in range(cfg.layers_per_block + 1):
            p[f"up_{i}_res_{b}"] = _resnet(sd, f"up_blocks.{i}.resnets.{b}")
            if f"up_blocks.{i}.attentions.{b}.norm.weight" in sd:
                p[f"up_{i}_attn_{b}"] = _transformer(
                    sd, f"up_blocks.{i}.attentions.{b}"
                )
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            p[f"up_{i}_upsample"] = _conv(sd, f"up_blocks.{i}.upsamplers.0.conv")
    return {"params": p}


def convert_vae_encoder(sd: Mapping[str, Any], cfg: VAEEncoderConfig) -> dict:
    p: dict[str, Any] = {"conv_in": _conv(sd, "encoder.conv_in")}
    for lvl in range(len(cfg.block_out_channels)):
        for b in range(cfg.layers_per_block):
            p[f"down_{lvl}_res_{b}"] = _resnet(
                sd, f"encoder.down_blocks.{lvl}.resnets.{b}"
            )
        k = f"encoder.down_blocks.{lvl}.downsamplers.0.conv"
        if f"{k}.weight" in sd:
            p[f"down_{lvl}_downsample"] = _conv(sd, k)
    p["mid_res_0"] = _resnet(sd, "encoder.mid_block.resnets.0")
    p["mid_res_1"] = _resnet(sd, "encoder.mid_block.resnets.1")
    a = "encoder.mid_block.attentions.0"
    p["mid_attn"] = {
        "group_norm": _gn(sd, f"{a}.group_norm"),
        "to_q": _dense(sd, f"{a}.to_q" if f"{a}.to_q.weight" in sd
                       else f"{a}.query"),
        "to_k": _dense(sd, f"{a}.to_k" if f"{a}.to_k.weight" in sd
                       else f"{a}.key"),
        "to_v": _dense(sd, f"{a}.to_v" if f"{a}.to_v.weight" in sd
                       else f"{a}.value"),
        "to_out": _dense(sd, f"{a}.to_out.0" if f"{a}.to_out.0.weight" in sd
                         else f"{a}.proj_attn"),
    }
    p["conv_norm_out"] = _gn(sd, "encoder.conv_norm_out")
    p["conv_out"] = _conv(sd, "encoder.conv_out")
    p["quant_conv"] = _conv(sd, "quant_conv")
    return {"params": p}


def convert_text_encoder(sd: Mapping[str, Any], cfg: CLIPTextConfig) -> dict:
    pre = "text_model."
    p: dict[str, Any] = {
        "token_embedding": {
            "embedding": _np(sd[f"{pre}embeddings.token_embedding.weight"])
        },
        "position_embedding": _np(
            sd[f"{pre}embeddings.position_embedding.weight"]
        ),
        "final_layer_norm": {
            "scale": _np(sd[f"{pre}final_layer_norm.weight"]),
            "bias": _np(sd[f"{pre}final_layer_norm.bias"]),
        },
    }
    for i in range(cfg.num_layers):
        b = f"{pre}encoder.layers.{i}"
        p[f"layers_{i}"] = {
            "layer_norm1": {"scale": _np(sd[f"{b}.layer_norm1.weight"]),
                            "bias": _np(sd[f"{b}.layer_norm1.bias"])},
            "layer_norm2": {"scale": _np(sd[f"{b}.layer_norm2.weight"]),
                            "bias": _np(sd[f"{b}.layer_norm2.bias"])},
            "q_proj": _dense(sd, f"{b}.self_attn.q_proj"),
            "k_proj": _dense(sd, f"{b}.self_attn.k_proj"),
            "v_proj": _dense(sd, f"{b}.self_attn.v_proj"),
            "out_proj": _dense(sd, f"{b}.self_attn.out_proj"),
            "fc1": _dense(sd, f"{b}.mlp.fc1"),
            "fc2": _dense(sd, f"{b}.mlp.fc2"),
        }
    return {"params": p}


# ---------------------------------------------------------------------------
# LDM / CompVis naming (Zero123 lightning checkpoints: model.diffusion_model)
# ---------------------------------------------------------------------------
def _ldm_resnet(sd, p):
    out = {
        "norm1": _gn(sd, f"{p}.in_layers.0"),
        "conv1": _conv(sd, f"{p}.in_layers.2"),
        "time_emb_proj": _dense(sd, f"{p}.emb_layers.1"),
        "norm2": _gn(sd, f"{p}.out_layers.0"),
        "conv2": _conv(sd, f"{p}.out_layers.3"),
    }
    if f"{p}.skip_connection.weight" in sd:
        out["conv_shortcut"] = _conv(sd, f"{p}.skip_connection")
    return out


def _conv1x1_as_dense(sd, key):
    w = _np(sd[f"{key}.weight"])  # (O, I, 1, 1)
    return {"kernel": w[:, :, 0, 0].T, "bias": _np(sd[f"{key}.bias"])}


def _ldm_transformer(sd, p):
    tb = f"{p}.transformer_blocks.0"
    def _proj(key):
        # SD-1.x uses conv1x1 projections; SD-2.x linear
        if _np(sd[f"{key}.weight"]).ndim == 4:
            return _conv1x1_as_dense(sd, key)
        return _dense(sd, key)
    return {
        "norm": _gn(sd, f"{p}.norm"),
        "proj_in": _proj(f"{p}.proj_in"),
        "proj_out": _proj(f"{p}.proj_out"),
        "block": {
            "norm1": {"scale": _np(sd[f"{tb}.norm1.weight"]),
                      "bias": _np(sd[f"{tb}.norm1.bias"])},
            "norm2": {"scale": _np(sd[f"{tb}.norm2.weight"]),
                      "bias": _np(sd[f"{tb}.norm2.bias"])},
            "norm3": {"scale": _np(sd[f"{tb}.norm3.weight"]),
                      "bias": _np(sd[f"{tb}.norm3.bias"])},
            "attn1": {
                "to_q": _dense(sd, f"{tb}.attn1.to_q", bias=False),
                "to_k": _dense(sd, f"{tb}.attn1.to_k", bias=False),
                "to_v": _dense(sd, f"{tb}.attn1.to_v", bias=False),
                "to_out": _dense(sd, f"{tb}.attn1.to_out.0"),
            },
            "attn2": {
                "to_q": _dense(sd, f"{tb}.attn2.to_q", bias=False),
                "to_k": _dense(sd, f"{tb}.attn2.to_k", bias=False),
                "to_v": _dense(sd, f"{tb}.attn2.to_v", bias=False),
                "to_out": _dense(sd, f"{tb}.attn2.to_out.0"),
            },
            "ff_proj": _dense(sd, f"{tb}.ff.net.0.proj"),
            "ff_out": _dense(sd, f"{tb}.ff.net.2"),
        },
    }


def convert_unet_ldm(sd: Mapping[str, Any], cfg: UNetConfig,
                     prefix: str = "model.diffusion_model.") -> dict:
    """LDM/CompVis UNet naming (input_blocks/middle_block/output_blocks) →
    the same Flax tree as ``convert_unet`` (Zero123 checkpoints)."""
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    n = len(cfg.block_out_channels)
    L = cfg.layers_per_block

    p: dict[str, Any] = {
        "conv_in": _conv(sub, "input_blocks.0.0"),
        "time_fc1": _dense(sub, "time_embed.0"),
        "time_fc2": _dense(sub, "time_embed.2"),
    }
    k = 1
    for lvl in range(n):
        has_attn = lvl < n - 1
        for b in range(L):
            p[f"down_{lvl}_res_{b}"] = _ldm_resnet(sub, f"input_blocks.{k}.0")
            if has_attn:
                p[f"down_{lvl}_attn_{b}"] = _ldm_transformer(
                    sub, f"input_blocks.{k}.1"
                )
            k += 1
        if lvl < n - 1:
            p[f"down_{lvl}_downsample"] = _conv(sub, f"input_blocks.{k}.0.op")
            k += 1

    p["mid_res_0"] = _ldm_resnet(sub, "middle_block.0")
    p["mid_attn"] = _ldm_transformer(sub, "middle_block.1")
    p["mid_res_1"] = _ldm_resnet(sub, "middle_block.2")

    k = 0
    for i in range(n):
        has_attn = i > 0
        for b in range(L + 1):
            p[f"up_{i}_res_{b}"] = _ldm_resnet(sub, f"output_blocks.{k}.0")
            if has_attn:
                p[f"up_{i}_attn_{b}"] = _ldm_transformer(
                    sub, f"output_blocks.{k}.1"
                )
            if b == L and i < n - 1:
                up_idx = 2 if has_attn else 1
                p[f"up_{i}_upsample"] = _conv(
                    sub, f"output_blocks.{k}.{up_idx}.conv"
                )
            k += 1
    return {"params": p}


def convert_vae_encoder_ldm(sd: Mapping[str, Any], cfg: VAEEncoderConfig,
                            prefix: str = "first_stage_model.") -> dict:
    """LDM/CompVis AutoencoderKL encoder naming (``first_stage_model.encoder.
    down.{i}.block.{j}`` etc.) → the ``convert_vae_encoder`` tree."""
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    def res(p):
        out = {
            "norm1": _gn(sub, f"{p}.norm1"),
            "conv1": _conv(sub, f"{p}.conv1"),
            "norm2": _gn(sub, f"{p}.norm2"),
            "conv2": _conv(sub, f"{p}.conv2"),
        }
        if f"{p}.nin_shortcut.weight" in sub:
            out["conv_shortcut"] = _conv(sub, f"{p}.nin_shortcut")
        return out

    p: dict[str, Any] = {"conv_in": _conv(sub, "encoder.conv_in")}
    for lvl in range(len(cfg.block_out_channels)):
        for b in range(cfg.layers_per_block):
            p[f"down_{lvl}_res_{b}"] = res(f"encoder.down.{lvl}.block.{b}")
        k = f"encoder.down.{lvl}.downsample.conv"
        if f"{k}.weight" in sub:
            p[f"down_{lvl}_downsample"] = _conv(sub, k)
    p["mid_res_0"] = res("encoder.mid.block_1")
    p["mid_res_1"] = res("encoder.mid.block_2")
    a = "encoder.mid.attn_1"
    p["mid_attn"] = {
        "group_norm": _gn(sub, f"{a}.norm"),
        "to_q": _conv1x1_as_dense(sub, f"{a}.q"),
        "to_k": _conv1x1_as_dense(sub, f"{a}.k"),
        "to_v": _conv1x1_as_dense(sub, f"{a}.v"),
        "to_out": _conv1x1_as_dense(sub, f"{a}.proj_out"),
    }
    p["conv_norm_out"] = _gn(sub, "encoder.norm_out")
    p["conv_out"] = _conv(sub, "encoder.conv_out")
    p["quant_conv"] = _conv(sub, "quant_conv")
    return {"params": p}
