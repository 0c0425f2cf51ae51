"""Device and dtype selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device.
Without a device and without a card they raise: the port never falls back
to the CPU on its own.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist


def resolve_device(device=None) -> torch.device:
    """``device``, or by default the card: ``cuda`` in one process and,
    under a process group, the card the rank is bound to
    (``torch.cuda.current_device()``, which ``multihost.initialize`` sets
    to ``cuda:{LOCAL_RANK}``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on a GPU by default; "
                "pass device='cpu' (or +system.device=cpu) to run on the CPU")
        if dist.is_available() and dist.is_initialized():
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cuda")
    return torch.device(device)


def resolve_dtype(dtype=None) -> torch.dtype:
    """``None`` -> float32; a name like ``"bfloat16"`` -> ``torch.bfloat16``."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    resolved = getattr(torch, str(dtype), None)
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return resolved


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and cuDNN convolutions; the flags restored."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
