"""SPair evaluation pieces of the PyTorch port (counterpart of the JAX
package's ``evaluators/spair.py``). Only the dense feature function is
ported so far; the geometric correspondence drivers use it."""

from __future__ import annotations

import torch

from midvision_probe_torch.ops.matching import l2_normalize


def make_feature_fn(backbone):
    """images (B, S, S, 3) -> L2-normalized dense features (B, h, w, C) in
    float32, the backbone's taps concatenated along channels."""

    def fn(images) -> torch.Tensor:
        maps = backbone.features(torch.as_tensor(images))
        feats = torch.cat(maps, dim=-1) if len(maps) > 1 else maps[0]
        return l2_normalize(feats.float())

    return fn
