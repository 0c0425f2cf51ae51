"""Fused-qkv ViT attention: the hand-written CUDA kernel K1, its plain
PyTorch twin and the wrapper that chooses between them.

Counterpart of the JAX package's Pallas TPU kernel ``fused_qkv_attention``
(``ops/vit_attention.py``, ``_fused_forward`` -> ``_fused_kernel``). The
kernel source is ``csrc/vit_attention.cu``; its header says what bounds it
on an H100 (tensor-core operations at the ViT-B/16 probing shape) and what
the design does about it.

* ``fused_qkv_attention(qkv, scale, n_valid=None)``: qkv ``(B, N, 3, H, d)``
  -> ``(B, N, H*d)``. For a CPU tensor it runs the plain twin; for a CUDA
  tensor it launches the kernel or raises. There is no fallback.
* ``_fused_qkv_attention_plain``: the einsum + softmax formulation of the
  JAX package's ``_fused_einsum_ref`` (f32 scores, probabilities cast to
  the input dtype before the PV product).

Constraints of the CUDA kernel (they replace the TPU-only gates of the JAX
package's ``fused_attention_ok``: 128-lane divisibility, the VMEM cap and
N >= 256 do not apply): head dim d in {16, 32, 64, 128}; dtype bfloat16 or
float32 (float32 runs a SIMT path with no TF32); the qkv tensor contiguous
and 16-byte aligned; any N >= 1 and 1 <= n_valid <= N; forward only (the
backbone is frozen, so no gradient flows through it).
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

_LOG2E = math.log2(math.e)
_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.bfloat16, torch.float32)


def _fused_qkv_attention_plain(qkv: torch.Tensor, scale: float,
                               n_valid: int | None = None) -> torch.Tensor:
    """Einsum formulation with the kernel's semantics: every query row
    (padded rows included) attends over the first ``n_valid`` keys/values
    only."""
    B, N, _, H, d = qkv.shape
    q, k, v = qkv.unbind(2)  # each (B, N, H, d)
    if n_valid is not None:
        k, v = k[:, :n_valid], v[:, :n_valid]
    s = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, N, H * d)


def _kernel():
    from midvision_probe_torch.ops.cuda_build import load_library

    lib = load_library("vit_attention")
    fn = lib.mvp_fused_qkv_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _float_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0]


def fused_qkv_attention(qkv: torch.Tensor, scale: float,
                        n_valid: int | None = None) -> torch.Tensor:
    """Non-causal attention on the fused projection output.

    qkv ``(B, N, 3, H, d)`` -> ``(B, N, H*d)``. ``n_valid``: rows >= n_valid
    are padding; their keys/values are excluded (never read by the kernel)
    and their output rows attend over the valid keys like any other row."""
    if qkv.ndim != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, N, 3, H, d), got {tuple(qkv.shape)}")
    B, N, _, H, d = qkv.shape
    if n_valid is not None and not 0 < n_valid <= N:
        raise ValueError(f"n_valid={n_valid} outside [1, {N}]")
    if qkv.device.type == "cpu":
        return _fused_qkv_attention_plain(qkv, scale, n_valid)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"dtype {qkv.dtype} not in {_DTYPES}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("the fused attention kernel is forward-only "
                           "(frozen backbone); run it under torch.no_grad()")
    out = torch.empty((B, N, H * d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _kernel()(
            qkv.data_ptr(), out.data_ptr(), B, N, H, d,
            N if n_valid is None else n_valid, _float_bits(scale * _LOG2E),
            int(qkv.dtype == torch.bfloat16),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_qkv_attention kernel launch failed: "
                           f"cudaError {err}")
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0  # kernel launches (never the plain twin)
