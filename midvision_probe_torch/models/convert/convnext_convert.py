"""timm/open_clip/FB ConvNeXt state_dict -> numpy tree in the JAX package's
``ConvNeXt`` layout (copy of the JAX package's
``models/convert/convnext_convert.py``), which
``convert.from_jax.convnext_state_dict`` maps onto the port's ``ConvNeXt``.

Handles both naming families: timm convnext/convnextv2
(``stages.N.blocks.M.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma,mlp.grn}``,
``stem.0/1``, ``stages.N.downsample.0/1``) and the original FB repo naming
(``stages.N.M.{dwconv,norm,pwconv1,pwconv2,gamma,grn}``,
``downsample_layers``). ``prefix`` selects the trunk inside a larger file
(open_clip's ``visual.trunk.``).
"""

from __future__ import annotations

from typing import Any, Mapping

from midvision_probe_torch.models.convert.common import _np
from midvision_probe_torch.models.convnext import ConvNeXtConfig


def _get(sub: Mapping, *names: str):
    for n in names:
        if n in sub:
            return sub[n]
    raise KeyError(names)


def convert_convnext(sd: Mapping[str, Any], cfg: ConvNeXtConfig,
                     prefix: str = "") -> dict:
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    def conv(*names):
        return _np(_get(sub, *names)).transpose(2, 3, 1, 0)

    def ln(stem: str) -> dict:
        return {"scale": _np(sub[f"{stem}.weight"]), "bias": _np(sub[f"{stem}.bias"])}

    def dense(*names):
        for n in names:
            if f"{n}.weight" in sub:
                return {"kernel": _np(sub[f"{n}.weight"]).T, "bias": _np(sub[f"{n}.bias"])}
        raise KeyError(names)

    params: dict[str, Any] = {}
    # stem: timm 'stem.0/1'; FB 'downsample_layers.0.0/1'
    params["stem_conv"] = {
        "kernel": conv("stem.0.weight", "downsample_layers.0.0.weight"),
        "bias": _np(_get(sub, "stem.0.bias", "downsample_layers.0.0.bias")),
    }
    params["stem_norm"] = (
        ln("stem.1") if "stem.1.weight" in sub else ln("downsample_layers.0.1"))

    for s, depth in enumerate(cfg.depths):
        if s > 0:
            if f"stages.{s}.downsample.0.weight" in sub:
                params[f"downsample_norm_{s}"] = ln(f"stages.{s}.downsample.0")
                dk = f"stages.{s}.downsample.1"
            else:
                params[f"downsample_norm_{s}"] = ln(f"downsample_layers.{s}.0")
                dk = f"downsample_layers.{s}.1"
            params[f"downsample_conv_{s}"] = {
                "kernel": conv(f"{dk}.weight"), "bias": _np(sub[f"{dk}.bias"])}
        for b in range(depth):
            timm_b = f"stages.{s}.blocks.{b}"
            base = timm_b if f"{timm_b}.norm.weight" in sub else f"stages.{s}.{b}"
            block: dict[str, Any] = {
                "dwconv": {
                    "kernel": conv(f"{base}.conv_dw.weight", f"{base}.dwconv.weight"),
                    "bias": _np(_get(sub, f"{base}.conv_dw.bias", f"{base}.dwconv.bias")),
                },
                "norm": ln(f"{base}.norm"),
                "pwconv1": dense(f"{base}.mlp.fc1", f"{base}.pwconv1"),
                "pwconv2": dense(f"{base}.mlp.fc2", f"{base}.pwconv2"),
            }
            if cfg.use_grn:
                block["grn_gamma"] = _np(_get(sub, f"{base}.mlp.grn.weight",
                                              f"{base}.grn.gamma")).reshape(-1)
                block["grn_beta"] = _np(_get(sub, f"{base}.mlp.grn.bias",
                                             f"{base}.grn.beta")).reshape(-1)
            else:
                block["gamma"] = _np(_get(sub, f"{base}.gamma"))
            params[f"stage{s}_block{b}"] = block

    return {"params": params}
