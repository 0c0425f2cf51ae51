"""Weights and inputs made from the run's seed, on the device, in a few
large calls: the same seed gives the same tensors, so the program and the
reference are handed the same weights and batches and the reference can
make them again after the program's state is freed.

Weights are drawn at the scales that ``WEIGHT_RULES`` names (the
configuration lists them under ``assumed``): matrices and convolution
kernels N(0, 1/fan_in) (flax's lecun scale, which the program's own init
uses), biases N(0, 0.02^2), norm weights 1 + N(0, 0.1^2), LayerScale
0.5 + N(0, 0.1^2), cls token and position table N(0, 0.02^2), running
statistics 0 and 1. Images are N(0, 1) per channel (a normalised image's
scale); depth targets are uniform in the mix's range.
"""

from __future__ import annotations

import hashlib
import math

import torch

# (suffix, mean, std) for the named tensors; first match wins
WEIGHT_RULES = (
    ("running_mean", 0.0, 0.0),
    ("running_var", 1.0, 0.0),
    ("gamma_1", 0.5, 0.1),
    ("gamma_2", 0.5, 0.1),
    ("cls_token", 0.0, 0.02),
    ("pos_embed", 0.0, 0.02),
    (".bias", 0.0, 0.02),
)
NORM_WEIGHT = (1.0, 0.1)  # a ``.weight`` vector: a LayerNorm's or BatchNorm's scale


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of draws (``tag``) of the run's seed."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _rule(name: str, shape) -> tuple[float, float]:
    """(mean, std) of the tensor ``name``: ``WEIGHT_RULES``, else a matrix
    or kernel at N(0, 1/fan_in), else a norm's scale."""
    for suffix, mean, std in WEIGHT_RULES:
        if name.endswith(suffix):
            return mean, std
    if not name.endswith(".weight"):
        raise ValueError(f"no weight rule for {name!r}")
    if len(shape) == 1:
        return NORM_WEIGHT
    return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))


def weights(shapes: dict, seed: int, tag: str, device, dtype=torch.float32) -> dict:
    """One tensor per name in ``shapes``, from one normal draw, rounded to
    ``dtype`` (the type the program serves them in)."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, tag, device), device=device)
    out, offset = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        mean, std = _rule(name, shape)
        out[name] = (flat[offset:offset + n].view(shape) * std + mean).to(dtype)
        offset += n
    return out


def images(seed: int, slot: int, batch: int, hw, device) -> torch.Tensor:
    """Batch ``slot`` of the run's images: (batch, H, W, 3) float32."""
    return torch.randn((batch, *hw, 3), generator=generator(seed, f"images.{slot}", device),
                       device=device)


def depths(seed: int, slot: int, batch: int, hw, depth_range, device) -> torch.Tensor:
    """Batch ``slot`` of the run's depth targets: (batch, H, W, 1) float32,
    uniform in ``depth_range``."""
    lo, hi = depth_range
    u = torch.rand((batch, *hw, 1), generator=generator(seed, f"depth.{slot}", device),
                   device=device)
    return u * (hi - lo) + lo
