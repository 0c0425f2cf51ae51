"""Parity of the port's (B, H, N, d) attention (``ops/vit_attention.py::
vit_attention`` and ``ops/attention.py``) with the JAX package's: the port's
plain versions against the Pallas kernel K2 in interpret mode and against
``_einsum_attention``, on the same numpy inputs.

Tolerances: f32 1e-5 abs (f32 scores and softmax on both sides, summation
order only); bf16 1.6e-2 abs (both sides round the probabilities and the
output to bf16, summing in other orders: a few bf16 ulps at |o| <= 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.ops import attention as t_attn
from midvision_probe_torch.ops import vit_attention as t_vit_attn
from midvision_probe_tpu.ops import attention as j_attn
from midvision_probe_tpu.ops import vit_attention as j_vit_attn

F32 = jax.default_matmul_precision("float32")
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


def _qkv(B, H, N, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, N, d).astype(np.float32) for _ in range(3)]


def _to_torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _to_jax(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("N", [65, 200, 300])
def test_vit_attention_matches_jax_kernel(dtype, N, d):
    """K2's plain version against the interpreted Pallas kernel (which pads
    N to a multiple of 128 and masks the padded keys) and ``_einsum_ref``."""
    arrays = _qkv(1, 2, N, d, seed=N + d)
    scale = d**-0.5
    with F32:
        ref_kernel = j_vit_attn.vit_attention(*_to_jax(arrays, dtype), scale, True)
        ref_einsum = j_vit_attn._einsum_ref(*_to_jax(arrays, dtype), scale)
    got = t_vit_attn.vit_attention(*_to_torch(arrays, dtype), scale)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (1, 2, N, d)
    got = got.float().numpy()
    for ref in (ref_kernel, ref_einsum):
        np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)),
                                   atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_multi_head_attention_matches_jax_einsum(dtype, with_bias):
    """The dispatch against the JAX package's ``_einsum_attention``, with
    and without a (BEiT-style) additive bias. The JAX CPU dispatch takes the
    einsum path; the port's takes ``vit_attention``'s plain version without
    a bias and ``_einsum_attention`` with one."""
    B, H, N, d = 2, 2, 77, 80
    arrays = _qkv(B, H, N, d, seed=3)
    bias = np.random.RandomState(4).randn(1, H, N, N).astype(np.float32)
    scale = d**-0.5
    with F32:
        ref = j_attn._einsum_attention(*_to_jax(arrays, dtype),
                                       jnp.asarray(bias) if with_bias else None, scale)
        ref_dispatch = j_attn.multi_head_attention(
            *_to_jax(arrays, dtype), jnp.asarray(bias) if with_bias else None, scale)
    got = t_attn.multi_head_attention(*_to_torch(arrays, dtype),
                                      torch.from_numpy(bias) if with_bias else None,
                                      scale=scale)
    for r in (ref, ref_dispatch):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(r.astype(jnp.float32)),
                                   atol=TOL[dtype], rtol=0)


def test_long_sequence_route_matches_jax_einsum():
    """N = 4097 at d = 80 in f32: K+V exceed 2 MB, so the dispatch takes
    the long-sequence route (``_flash_attention``), as the JAX package sends
    this shape to the jax library's TPU flash kernel. That kernel has no
    CPU interpret path here, so the reference is the JAX package's
    ``_einsum_attention``; f32 1e-5."""
    B, H, N, d = 1, 1, 4097, 80
    arrays = _qkv(B, H, N, d, seed=7)
    scale = d**-0.5
    assert N * d * 4 * 2 > 2 * 1024 * 1024
    with F32:
        ref = j_attn._einsum_attention(*_to_jax(arrays, "float32"), None, scale)
    got = t_attn.multi_head_attention(*_to_torch(arrays, "float32"), scale=scale)
    forced = t_attn.multi_head_attention(*_to_torch(arrays, "float32"), scale=scale,
                                         use_flash=True)
    for g in (got, forced):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_strided_views_are_accepted():
    """q, k, v as (B, H, N, d) views of one (B, N, 3, H, d) projection, as
    the ViT's generic branch passes them; f32 1e-5 against JAX on the same
    values made contiguous."""
    B, N, H, d = 2, 50, 2, 16
    qkv = np.random.RandomState(9).randn(B, N, 3, H, d).astype(np.float32)
    q, k, v = torch.from_numpy(qkv).permute(2, 0, 3, 1, 4).unbind(0)
    assert not q.is_contiguous()
    got = t_attn.multi_head_attention(q, k, v, scale=d**-0.5)
    with F32:
        ref = j_vit_attn.vit_attention(*[jnp.asarray(qkv[:, :, i].transpose(0, 2, 1, 3))
                                         for i in range(3)], d**-0.5, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_flash_with_a_bias_raises_and_cpu_runs_count_no_launch():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="bias"):
        t_attn.multi_head_attention(q, q, q, bias=torch.zeros(1, 1, 8, 8), use_flash=True)
    before = (t_vit_attn.vit_attention.launches, t_attn._flash_attention.launches)
    t_attn.multi_head_attention(q, q, q)
    t_attn.multi_head_attention(q, q, q, use_flash=True)
    assert (t_vit_attn.vit_attention.launches, t_attn._flash_attention.launches) == before


@pytest.mark.parametrize("dtype,d", [("float32", 48), ("bfloat16", 48), ("float32", 96)])
def test_head_dims_no_kernel_takes_match_the_jax_dispatch(dtype, d):
    """A head dim outside the kernel's table goes to ``_einsum_attention``
    in the port (on any device); the JAX package's dispatch takes its einsum
    path for the same call off the TPU. Tolerances as above."""
    arrays = _qkv(2, 3, 77, d, seed=d)
    scale = d**-0.5
    assert not t_vit_attn.kernel_takes(d, getattr(torch, dtype))
    with F32:
        ref = j_attn.multi_head_attention(*_to_jax(arrays, dtype), None, scale)
    got = t_attn.multi_head_attention(*_to_torch(arrays, dtype), scale=scale)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)
