"""torchvision-layout ResNet-50 state_dict conversion (copy of the JAX
package's ``models/convert/resnet_convert.py``): a numpy tree in the JAX
package's ``ResNet50`` layout (``params`` and ``batch_stats``), which
``convert.from_jax.resnet_state_dict`` maps onto the port's ``ResNet50``."""

from __future__ import annotations

from typing import Any, Mapping

from midvision_probe_torch.models.convert.common import _np
from midvision_probe_torch.models.resnet import STAGE_BLOCKS


def _conv(sd: Mapping, key: str) -> dict:
    # torch conv weight (O, I, kh, kw) -> flax (kh, kw, I, O)
    return {"kernel": _np(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)}


def _bn(sd: Mapping, key: str):
    params = {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}
    stats = {"mean": _np(sd[f"{key}.running_mean"]), "var": _np(sd[f"{key}.running_var"])}
    return params, stats


def convert_resnet50(sd: Mapping[str, Any], prefix: str = "") -> dict:
    """torchvision ``resnet50`` trunk -> variables of the JAX package's
    ``models.resnet.ResNet50``: the layout every VISSL, MoCo and MMSelfSup
    R50 checkpoint is brought to by ``unwrap_checkpoint``."""
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    params: dict[str, Any] = {"conv1": _conv(sub, "conv1")}
    stats: dict[str, Any] = {}
    params["bn1"], stats["bn1"] = _bn(sub, "bn1")

    for stage, num_blocks in enumerate(STAGE_BLOCKS):
        for b in range(num_blocks):
            t = f"layer{stage + 1}.{b}"
            name = f"layer{stage + 1}_{b}"
            blk_p: dict[str, Any] = {}
            blk_s: dict[str, Any] = {}
            for c in (1, 2, 3):
                blk_p[f"conv{c}"] = _conv(sub, f"{t}.conv{c}")
                blk_p[f"bn{c}"], blk_s[f"bn{c}"] = _bn(sub, f"{t}.bn{c}")
            if f"{t}.downsample.0.weight" in sub:
                blk_p["downsample_conv"] = _conv(sub, f"{t}.downsample.0")
                blk_p["downsample_bn"], blk_s["downsample_bn"] = _bn(sub, f"{t}.downsample.1")
            params[name] = blk_p
            stats[name] = blk_s

    return {"params": params, "batch_stats": stats}
