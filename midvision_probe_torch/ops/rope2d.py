"""2D rotary position embedding (CroCo-v2): the hand-written CUDA kernel
K5, its plain PyTorch version and the wrapper that chooses between them.

Counterpart of the JAX package's ``ops/rope2d.py`` (Pallas TPU kernel
``_rope2d_kernel`` via ``_rope_2d_pallas``). The kernel source is
``csrc/rope2d.cu``; its header says what bounds it on an H100 (bytes) and
what the design does about it.

Semantics (the reference's cuRoPE2D): tokens ``(B, H, N, dim)`` split into a
y half ``[..., :dim/2]`` and an x half ``[..., dim/2:]``; each half gets
rotate-half 1-D RoPE, ``t * cos + rotate_half(t) * sin`` with
``rotate_half(u, v) = (-v, u)``, at angle ``pos / base**(2i/D)`` (D = dim/2,
``pos`` the token's y or x grid coordinate). f32 math, cast back to the
input dtype.

* ``rope_2d(tokens, positions, base=100.0)``: for a CPU tensor it runs the
  plain version; for a CUDA tensor it launches the kernel or raises. There
  is no fallback.
* ``_rope_2d_plain``: ``_rope_half`` / ``_rope_2d_jnp`` of the JAX package,
  operation for operation.

Constraints of the CUDA kernel: ``dim % 4 == 0`` (as the JAX package
asserts); float32, bfloat16 or float16 tokens with a contiguous last
dimension (any other strides: q and k arrive as views of the qkv
projection); integer positions ``(B, N, 2)``; the output is a fresh
contiguous tensor.
"""

from __future__ import annotations

import ctypes
import math

import torch

from midvision_probe_torch.ops.cuda_build import float_bits, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _rope_half(t: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """1-D RoPE on the last dim of ``t`` (..., N, D) with positions (..., N)."""
    D = t.shape[-1]
    half = D // 2
    i = torch.arange(half, dtype=torch.float32, device=t.device)
    inv_freq = torch.exp(-math.log(base) * (2.0 * i / D))
    angle = pos[..., None].to(torch.float32) * inv_freq  # (..., N, D/2)
    cos, sin = torch.cos(angle), torch.sin(angle)
    u, v = t[..., :half], t[..., half:]
    return torch.cat([u * cos - v * sin, v * cos + u * sin], dim=-1)


def _rope_2d_plain(tokens: torch.Tensor, positions: torch.Tensor,
                   base: float = 100.0) -> torch.Tensor:
    D = tokens.shape[-1] // 2
    y, x = tokens[..., :D], tokens[..., D:]
    pos_y = positions[:, None, :, 0]  # (B, 1, N) broadcast over heads
    pos_x = positions[:, None, :, 1]
    y = _rope_half(y.to(torch.float32), pos_y, base)
    x = _rope_half(x.to(torch.float32), pos_x, base)
    return torch.cat([y, x], dim=-1).to(tokens.dtype)


def _kernel():
    fn = load_library("rope2d").mvp_rope2d
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_int64] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def rope_2d(tokens: torch.Tensor, positions: torch.Tensor,
            base: float = 100.0) -> torch.Tensor:
    """Apply 2D RoPE.

    Args:
        tokens: ``(B, nheads, N, dim)`` attention q or k.
        positions: ``(B, N, 2)`` integer (y, x) grid positions per token.
        base: frequency base (CroCo-v2 uses 100.0).
    """
    if tokens.ndim != 4 or tokens.shape[-1] % 4:
        raise ValueError("tokens must be (B, H, N, dim) with dim divisible by 4 "
                         f"for 2D RoPE, got {tuple(tokens.shape)}")
    B, H, N, dim = tokens.shape
    if tuple(positions.shape) != (B, N, 2):
        raise ValueError(f"positions must be ({B}, {N}, 2), got {tuple(positions.shape)}")
    if tokens.device.type == "cpu":
        return _rope_2d_plain(tokens, positions, base)
    if tokens.device.type != "cuda":
        raise ValueError(f"unsupported device {tokens.device}")
    if tokens.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {tokens.dtype} not in {tuple(_DTYPE_CODES)}")
    if tokens.stride(-1) != 1:
        raise ValueError("tokens must have a contiguous last dimension")
    if positions.dtype.is_floating_point or positions.dtype.is_complex:
        raise ValueError(f"positions must be integer, got {positions.dtype}")
    if positions.device != tokens.device:
        raise ValueError("positions must be on the tokens' device")
    if tokens.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("the RoPE kernel is forward-only (frozen backbone); "
                           "run it under torch.no_grad()")
    positions = positions.to(torch.int32)  # no copy when already int32
    out = torch.empty((B, H, N, dim), dtype=tokens.dtype, device=tokens.device)
    with torch.cuda.device(tokens.device):
        err = _kernel()(
            tokens.data_ptr(), positions.data_ptr(), out.data_ptr(), B, H, N, dim,
            *tokens.stride()[:3], *positions.stride(),
            float_bits(-math.log(base)), _DTYPE_CODES[tokens.dtype],
            torch.cuda.current_stream(tokens.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rope_2d kernel launch failed: cudaError {err}")
    rope_2d.launches += 1
    return out


rope_2d.launches = 0  # kernel launches (never the plain version)
