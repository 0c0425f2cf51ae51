"""Dtype-aware GELU (counterpart of the JAX package's ``ops/activations.py``).

The JAX package computes GELU with the erf-exact form in float32 (parity
with torch ``nn.GELU()``) and with the tanh approximation in bfloat16 and
float16, where its error (~3e-4 at |x| ≈ 2) is below half-precision
rounding. The port follows the same rule, so a bf16 backbone computes the
same function in both packages; always using erf would drift in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU at the compute dtype: erf in float32/float64, tanh in
    bfloat16/float16."""
    approximate = "tanh" if x.dtype in (torch.bfloat16, torch.float16) else "none"
    return F.gelu(x, approximate=approximate)
