"""Multi-head attention dispatch (counterpart of the JAX package's
``ops/attention.py``). All operands are ``(B, H, N, d)``.

* No bias: the hand-written attention kernel (``csrc/vit_attention.cu``)
  on a card, its plain version on the CPU. The JAX package splits these
  calls by K+V size: up to 2 MB they go to its single-pass ViT kernel (K2,
  ``ops.vit_attention.vit_attention``), beyond it to the jax library's TPU
  flash kernel (K3, ``_flash_attention`` here). On the card both routes
  reach the same kernel, whose KV-tile online softmax is the flash
  algorithm and takes any N; the split only decides which launch count
  counts. Their gradients differ as in the JAX package: ``vit_attention``'s
  is its plain version's vjp (the JAX ``custom_vjp``'s einsum backward),
  ``_flash_attention``'s is the hand-written backward K10
  (``csrc/attention_bwd.cu``), the counterpart of the jax library's dq and
  dkv kernels, counted in ``_flash_attention.backward_launches``.
* A bias (BEiT's relative-position bias), or a head dim and dtype that no
  route of the kernel takes (``kernel_takes``, beside the route table in
  ``ops/vit_attention.py``): ``_einsum_attention``, the plain f32-softmax
  formulation, on the operands' own device, as the JAX package computes
  every call off the TPU; ``use_flash=True`` with either raises, because
  the kernel has no bias input and no such head dim.

The JAX package's TPU gates (N >= 256, d <= 256) were chosen for the TPU's
launch overhead and VMEM; they do not apply to the card and are dropped.
"""

from __future__ import annotations

import torch

from midvision_probe_torch.ops.vit_attention import (
    _needs_grad,
    _vit_attention_plain,
    kernel_takes,
    launch_attention,
    launch_attention_backward,
    vit_attention,
)

_KV_RESIDENT_BYTES = 2 * 1024 * 1024  # the JAX package's K+V-in-VMEM split


def _einsum_attention(q, k, v, bias=None, scale=1.0):
    """(B, H, N, d) reference path; f32 softmax."""
    s = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), k.float())
    if bias is not None:
        s = s + bias.to(s.dtype)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


class _FlashAttention(torch.autograd.Function):
    """K3 on a card with the residual its backward needs; backward: K10."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = launch_attention(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = launch_attention_backward(q, k, v, out, lse, dout, ctx.scale)
        _flash_attention.backward_launches += 1
        return (*grads, None)


def _flash_attention(q, k, v, scale: float):
    """The long-sequence route (K3 in the JAX package): the attention
    kernel on a card, counted in ``_flash_attention.launches``, and under
    autograd its backward K10, counted in ``.backward_launches``; the plain
    version (and its autograd) on the CPU."""
    if q.device.type == "cpu":
        return _vit_attention_plain(q, k, v, scale)
    if _needs_grad(q, k, v):
        out = _FlashAttention.apply(q, k, v, scale)
    else:
        out = launch_attention(q, k, v, scale)
    _flash_attention.launches += 1
    return out


_flash_attention.launches = 0  # kernel launches (never the plain version)
_flash_attention.backward_launches = 0  # K10 launches


def multi_head_attention(q, k, v, bias=None, scale: float = 1.0,
                         use_flash: bool | None = None):
    """Attention over ``(B, H, N, d)`` operands.

    ``use_flash=None``: without a bias, at a head dim and dtype that the
    kernel takes, K+V up to 2 MB go to ``vit_attention``, longer sequences
    to ``_flash_attention``; otherwise ``_einsum_attention``.
    ``use_flash=True`` forces ``_flash_attention`` (a bias or a head dim the
    kernel does not take then raises); ``use_flash=False`` forces
    ``_einsum_attention``."""
    takes = kernel_takes(q.shape[-1], q.dtype)
    if use_flash is None:
        if bias is not None or not takes:
            return _einsum_attention(q, k, v, bias, scale)
        kv_bytes = q.shape[2] * q.shape[-1] * q.element_size() * 2
        if kv_bytes <= _KV_RESIDENT_BYTES:
            return vit_attention(q, k, v, float(scale))
        return _flash_attention(q, k, v, float(scale))
    if use_flash:
        # the kernel has no bias input: silently dropping a rel-pos bias
        # would return wrong attention
        if bias is not None:
            raise ValueError("use_flash=True cannot apply an attention bias; pass "
                             "use_flash=None/False for biased (BEiT-style) attention")
        if not takes:
            raise ValueError(f"use_flash=True: no attention kernel takes head dim "
                             f"{q.shape[-1]} in {q.dtype}; pass use_flash=None/False "
                             "for the einsum path")
        return _flash_attention(q, k, v, float(scale))
    return _einsum_attention(q, k, v, bias, scale)
