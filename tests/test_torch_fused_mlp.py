"""Parity of the port's fused MLP (``ops/fused_mlp.py``, K6) with the JAX
package's: on the CPU the port's wrapper runs the kernel's plain version,
held against the Pallas kernel in interpret mode (JAX side under
``jax.default_matmul_precision("float32")``) on the same numpy inputs; the
backward against ``jax.grad``.

Tolerances: f32 atol 2e-5, rtol 1e-4, as the JAX package's own test of the
kernel against its plain version (f32 products on both sides, summation
order and the rational erf's 1-ulp rounding only); bf16 one bf16 ulp of each
output plus one of the largest output (both sides round the hidden
activations to bf16; a different f32 summation order can flip one of those
roundings, which moves a whole output row by a hidden ulp times a W2
entry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.ops import fused_mlp as t_mlp
from midvision_probe_tpu.ops import fused_mlp as j_mlp

F32 = jax.default_matmul_precision("float32")


def _inputs(M, C, H, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(M, C) * 0.5).astype(np.float32),
            (rng.randn(C, H) * 0.05).astype(np.float32),
            (rng.randn(H) * 0.1).astype(np.float32),
            (rng.randn(H, C) * 0.05).astype(np.float32),
            (rng.randn(C) * 0.1).astype(np.float32)]


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quickgelu"])
def test_fused_mlp_matches_jax_kernel_f32(act):
    """M = 300 is not a multiple of the TPU kernel's row block (it pads);
    the port takes any M."""
    arrays = _inputs(300, 128, 256, seed=0)
    with F32:
        ref = j_mlp.fused_mlp(*map(jnp.asarray, arrays), act, True)
        ref_plain = j_mlp._plain(*map(jnp.asarray, arrays), act)
    tensors = [torch.from_numpy(a) for a in arrays]
    before = t_mlp.fused_mlp.launches
    got = t_mlp.fused_mlp(*tensors, act=act)
    assert t_mlp.fused_mlp.launches == before  # the plain version: no launch
    assert got.dtype == torch.float32 and got.shape == (300, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(t_mlp._plain(*tensors, act=act).numpy(),
                               np.asarray(ref_plain), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh"])
def test_fused_mlp_matches_jax_kernel_bf16(act):
    """bf16 in and out (the ViT's bf16 MLP is gelu_tanh), a leading batch
    dimension; one bf16 ulp of each output plus one of the largest."""
    arrays = _inputs(2 * 77, 128, 512, seed=1)
    arrays[0] = arrays[0].reshape(2, 77, 128)
    with F32:
        ref = j_mlp.fused_mlp(*[jnp.asarray(a).astype(jnp.bfloat16) for a in arrays], act,
                              True)
    got = t_mlp.fused_mlp(*[torch.from_numpy(a).to(torch.bfloat16) for a in arrays], act=act)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 77, 128)
    g, r = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert np.all(np.abs(g - r) <= 2.0**-7 * (np.abs(r) + np.abs(r).max())), np.abs(g - r).max()


def test_fused_mlp_grad_matches_jax():
    """The backward (autograd through ``_plain``, exact erf) against
    ``jax.grad`` of the JAX kernel's ``custom_vjp``: every input's
    gradient, f32 atol 2e-5, rtol 1e-4."""
    arrays = _inputs(8, 128, 256, seed=2)
    with F32:
        ref = jax.grad(lambda *a: jnp.sum(j_mlp.fused_mlp(*a, "gelu", True) ** 2),
                       argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (t_mlp.fused_mlp(*leaves, act="gelu") ** 2).sum().backward()
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), atol=2e-5, rtol=1e-4)


def test_rational_erf_matches_jax():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(t_mlp._erf(torch.from_numpy(x)).numpy(),
                               np.asarray(j_mlp._erf(jnp.asarray(x))), atol=1e-7, rtol=0)


def test_fused_mlp_rejects_bad_shapes_and_activations():
    x, w1, b1, w2, b2 = [torch.from_numpy(a) for a in _inputs(4, 128, 64, seed=3)]
    with pytest.raises(ValueError, match="act"):
        t_mlp.fused_mlp(x, w1, b1, w2, b2, act="relu")
    with pytest.raises(ValueError, match="w1"):
        t_mlp.fused_mlp(x, w1.T, b1, w2, b2)
    with pytest.raises(ValueError, match="b1"):
        t_mlp.fused_mlp(x, w1, b2, w2, b2)
    with pytest.raises(ValueError, match="dtype"):
        t_mlp.fused_mlp(x.double(), w1, b1, w2, b2)
