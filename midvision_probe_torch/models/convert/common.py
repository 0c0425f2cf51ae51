"""Shared converter helpers (copy of the JAX package's
``models/convert/common.py``)."""

from __future__ import annotations

from typing import Any

import numpy as np


def _np(t: Any) -> np.ndarray:
    """torch-or-array -> float32 numpy. The ``.float()`` upcast is load-
    bearing: ``.numpy()`` raises on bfloat16 torch tensors (numpy has no
    bf16), and fp16 checkpoints should land in f32 params anyway."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)
