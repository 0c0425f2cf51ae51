"""Fused transformer MLP (fc1 -> activation -> fc2): the hand-written CUDA
kernel K6, its plain PyTorch versions and the wrapper.

Counterpart of the JAX package's Pallas TPU kernel ``fused_mlp``
(``ops/fused_mlp.py``, ``_forward`` -> ``_mlp_kernel``). It is a library op:
no model dispatches it (the ViT's MLP runs two linears). The kernel is
``csrc/fused_mlp.cu``; its header says what bounds it on an H100 (tensor-core
operations, in both dtypes) and what its design does about it. It is one
``wgmma`` GEMM with a fused epilogue launched twice: fc1 with bias and
activation into an ``(M, H)`` scratch of x's dtype that the wrapper
allocates, then fc2 with bias from it. The hidden activations therefore make
one round trip through device memory, rounded to bf16 where the TPU kernel
rounds them and to f32 in float32 (a one-SM design that keeps them on chip
cannot hold the (rows x C) f32 accumulator at wgmma's 64 rows). In bf16 the
GEMM takes bf16 products; in float32 (the ``bf16x6`` route) each operand is
split exactly into three bf16 pieces and each product taken as the six
piece products that matter at f32 precision, the slices summed with
Kahan's compensation and the bias and activation applied in f64; the
weights are split once per call into a workspace of ``6*C*H`` bf16 that
the wrapper allocates.

* ``fused_mlp(x, w1, b1, w2, b2, act="gelu")``: x ``(..., C)``, w1
  ``(C, H)``, b1 ``(H,)``, w2 ``(H, C)``, b2 ``(C,)`` (the JAX argument
  layout), one dtype -> ``(..., C)``; any number of rows, no padding. The
  forward is the kernel for CUDA tensors and ``_fused_mlp_plain`` for CPU
  tensors; the backward is autograd through ``_plain``, as the JAX
  ``custom_vjp`` takes the vjp of its ``_plain``.
* ``_fused_mlp_plain``: the kernel's function: ``h = act(f32(x @ W1) +
  f32(b1))`` with f32 accumulation and the rational erf for ``gelu``,
  rounded to x's dtype; ``o = f32(h @ W2) + f32(b2)`` rounded to x's dtype.
* ``_fused_mlp_exact``: the same function with float64 products and sums,
  rounded only where the kernel rounds: the oracle that the card's checks
  hold the float32 kernel to.
* ``_plain``: the JAX ``_plain``: ``act`` with the exact erf on
  ``f32(x @ W1 + b1)`` (bias added in the input dtype).

Activations: ``gelu`` (erf form), ``gelu_tanh`` (tanh form, the ViT's bf16
GELU) and ``quickgelu`` (``x * sigmoid(1.702 x)``).

Constraints of the CUDA kernel (``check_kernel_widths``), one rule for
both dtypes (bfloat16 and float32): any C that is a multiple of 8, so every
width the JAX op takes (384 and 1536 included), and any H that is a multiple
of 32; contiguous, 16-byte aligned operands.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from midvision_probe_torch.ops.cuda_build import load_library

ACTIVATIONS = ("gelu", "gelu_tanh", "quickgelu")  # kernel codes 0, 1, 2
_DTYPES = (torch.bfloat16, torch.float32)
_SQRT_HALF = float(np.float32(np.sqrt(0.5)))
_TANH_C = float(np.float32(np.sqrt(2.0 / np.pi)))


def _erf(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational erf (max abs error 1.5e-7), the
    TPU kernel's erf."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _act(h: torch.Tensor, act: str, exact: bool = True) -> torch.Tensor:
    if act == "quickgelu":  # openai CLIP
        return h * torch.sigmoid(1.702 * h)
    if act == "gelu_tanh":
        return 0.5 * h * (1.0 + torch.tanh(_TANH_C * (h + 0.044715 * h * h * h)))
    erf = torch.erf if exact else _erf
    return 0.5 * h * (1.0 + erf(h * _SQRT_HALF))


def _fused_mlp_plain(x, w1, b1, w2, b2, act: str = "gelu") -> torch.Tensor:
    """The kernel's function (f32 products: TF32 off on a card)."""
    h = torch.matmul(x.float(), w1.float()) + b1.float()
    h = _act(h, act, exact=False).to(x.dtype)
    o = torch.matmul(h.float(), w2.float()) + b2.float()
    return o.to(x.dtype)


def _fused_mlp_exact(x, w1, b1, w2, b2, act: str = "gelu") -> torch.Tensor:
    """The kernel's function with float64 products and sums (the rational
    erf evaluated in float64), rounded where the kernel rounds: the hidden
    to x's dtype, the output to x's dtype. The oracle of the checks only."""
    f64 = torch.float64
    h = torch.matmul(x.to(f64), w1.to(f64)) + b1.to(f64)
    h = _act(h, act, exact=False).to(x.dtype)
    o = torch.matmul(h.to(f64), w2.to(f64)) + b2.to(f64)
    return o.to(x.dtype)


def _plain(x, w1, b1, w2, b2, act: str = "gelu") -> torch.Tensor:
    """The JAX package's ``_plain``: exact erf, biases in the input dtype."""
    h = _act((x @ w1 + b1).float(), act).to(x.dtype)
    return (h @ w2 + b2).to(x.dtype)


def _check(x, w1, b1, w2, b2, act) -> tuple[int, int]:
    if act not in ACTIVATIONS:
        raise ValueError(f"act {act!r} not in {ACTIVATIONS}")
    C = x.shape[-1]
    if w1.ndim != 2 or w1.shape[0] != C:
        raise ValueError(f"w1 must be (C={C}, H), got {tuple(w1.shape)}")
    H = w1.shape[1]
    if tuple(b1.shape) != (H,) or tuple(w2.shape) != (H, C) or tuple(b2.shape) != (C,):
        raise ValueError(f"expected b1 ({H},), w2 ({H}, {C}), b2 ({C},); got "
                         f"{tuple(b1.shape)}, {tuple(w2.shape)}, {tuple(b2.shape)}")
    if any(t.dtype != x.dtype for t in (w1, b1, w2, b2)):
        raise ValueError("x, w1, b1, w2, b2 must share one dtype")
    if any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("x, w1, b1, w2, b2 must be on one device")
    return C, H


def check_kernel_widths(C: int, H: int, dtype: torch.dtype) -> None:
    """Raise unless the kernel takes widths C and H in ``dtype`` (bfloat16
    or float32), one rule for both: C a multiple of 8 (TMA's 16-byte row
    strides) and H a multiple of 32."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype} not in {_DTYPES}")
    if C % 8:
        raise ValueError(f"width C={C} must be a multiple of 8")
    if H % 32:
        raise ValueError(f"hidden width H={H} must be a multiple of 32")


def _kernel():
    fn = load_library("fused_mlp").mvp_fused_mlp
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _forward(x, w1, b1, w2, b2, act: str) -> torch.Tensor:
    C, H = _check(x, w1, b1, w2, b2, act)
    if x.device.type == "cpu":
        return _fused_mlp_plain(x, w1, b1, w2, b2, act)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    check_kernel_widths(C, H, x.dtype)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (x, w1, b1, w2, b2)):
        raise ValueError("x, w1, b1, w2, b2 must be contiguous and 16-byte aligned")
    M = x.numel() // C
    out = torch.empty_like(x)
    if M == 0:
        return out
    hidden = torch.empty((M, H), dtype=x.dtype, device=x.device)  # fc1's output, fc2's input
    planes = None  # float32: the three bf16 planes of W1 and of W2
    if x.dtype == torch.float32:
        planes = torch.empty(6 * C * H, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                        b2.data_ptr(), out.data_ptr(), hidden.data_ptr(),
                        None if planes is None else planes.data_ptr(), M, C, H,
                        ACTIVATIONS.index(act), int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: cudaError {err}")
    fused_mlp.launches += 1
    return out


class _FusedMLP(torch.autograd.Function):
    """Forward: the kernel (or, on the CPU, its plain version); backward:
    the gradient of ``_plain``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.act = act
        return _forward(x, w1, b1, w2, b2, act)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _plain(*inputs, ctx.act)
            grads = torch.autograd.grad(out, inputs, grad)
        return (*grads, None)


def fused_mlp(x, w1, b1, w2, b2, act: str = "gelu") -> torch.Tensor:
    """``act(x @ w1 + b1) @ w2 + b2``: x ``(..., C)``, w1 ``(C, H)``, b1
    ``(H,)``, w2 ``(H, C)``, b2 ``(C,)``. One call (two launches of the
    GEMM, and in float32 the weights' split before them) counts as one
    launch."""
    return _FusedMLP.apply(x, w1, b1, w2, b2, act)


fused_mlp.launches = 0  # kernel launches (never the plain version)
