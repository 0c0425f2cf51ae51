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


@pytest.mark.parametrize("C,H", [(384, 1536), (1536, 6144)])
def test_fused_mlp_matches_jax_kernel_f32_at_vit_s_and_vit_g_widths(C, H):
    """float32 at the JAX op's ViT-S (384) and ViT-g (1536) widths, which the
    card's kernel takes since its float32 route became the bf16x6 GEMM; a
    small ragged M; the tolerance above."""
    arrays = _inputs(20, C, H, seed=C)
    with F32:
        ref = j_mlp.fused_mlp(*map(jnp.asarray, arrays), "gelu_tanh", True)
    got = t_mlp.fused_mlp(*[torch.from_numpy(a) for a in arrays], act="gelu_tanh")
    assert got.dtype == torch.float32 and got.shape == (20, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quickgelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_exact_oracle_agrees_with_the_plain_version(act, dtype):
    """``_fused_mlp_exact`` (float64 products and sums) against
    ``_fused_mlp_plain`` at a small shape: f32 within 1e-5 abs; bf16 within
    one bf16 ulp of each output plus one of the largest (the bf16 bar)."""
    tensors = [torch.from_numpy(a).to(dtype) for a in _inputs(33, 128, 256, seed=4)]
    exact = t_mlp._fused_mlp_exact(*tensors, act=act)
    plain = t_mlp._fused_mlp_plain(*tensors, act=act)
    assert exact.dtype == dtype and exact.shape == (33, 128)
    e, p = exact.float(), plain.float()
    if dtype == torch.float32:
        torch.testing.assert_close(e, p, atol=1e-5, rtol=0)
    else:
        assert bool(((e - p).abs() <= 2.0**-7 * (p.abs() + p.abs().max())).all())


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quickgelu"])
def test_fused_mlp_plain_is_the_f32_chain_bit_for_bit(act):
    """``_fused_mlp_plain`` is the f32 chain it always was (f32 products and
    sums, the bias in f32, the activation in f32, rounded to x's dtype):
    the same tensor bit for bit at a seeded f32 input. The card's float32
    checks hold the kernel to no more error than this function has."""
    x, w1, b1, w2, b2 = [torch.from_numpy(a) for a in _inputs(17, 128, 96, seed=5)]
    h = t_mlp._act(torch.matmul(x, w1) + b1, act, exact=False)
    want = torch.matmul(h, w2) + b2
    got = t_mlp._fused_mlp_plain(x, w1, b1, w2, b2, act=act)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def _bf16_pieces(x: torch.Tensor):
    """The card's float32 split (``split3`` in ``csrc/fused_mlp.cu``): x =
    p0 + p1 + p2, each rounded to bf16 to nearest even."""
    p0 = x.bfloat16().float()
    p1 = (x - p0).bfloat16().float()
    return p0, p1, (x - p0) - p1


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, on the bit pattern."""
    bits = x.view(torch.int32).to(torch.int64)
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def test_bf16x6_split_is_exact():
    """Each f32 value over a wide range of magnitudes is the sum of its three
    bf16 pieces exactly, and each piece is a bf16 value."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy((rng.randn(200_000) * 2.0 ** rng.randint(-60, 60, 200_000))
                         .astype(np.float32))
    pieces = _bf16_pieces(x)
    for p in pieces:
        assert torch.equal(p.bfloat16().float(), p)
    assert torch.equal(sum(p.double() for p in pieces), x.double())


def test_bf16x6_products_reach_f32_where_tf32x3_does_not():
    """Per product, the six bf16 piece products the card's float32 route
    takes (a0b0; a0b1, a1b0; a0b2, a1b1, a2b0) are within 2^-23 of a*b (the
    dropped a1b2 + a2b1 + a2b2: |a1| <= 2^-8 |a|, |a2| <= 2^-16 |a|); three
    TF32 products (hi.hi + hi.lo + lo.hi) leave errors above 2^-22, so that
    a sum of them carries a floor of its own."""
    rng = np.random.RandomState(7)
    a, b = (torch.from_numpy(rng.randn(200_000).astype(np.float32)) for _ in range(2))
    exact = a.double() * b.double()
    (a0, a1, a2), (b0, b1, b2) = _bf16_pieces(a), _bf16_pieces(b)
    d = [t.double() for t in (a0, a1, a2, b0, b1, b2)]
    six = d[0] * d[3] + (d[0] * d[4] + d[1] * d[3]) + (d[0] * d[5] + d[1] * d[4] + d[2] * d[3])
    assert ((six - exact).abs() / exact.abs()).max().item() <= 2.0**-23
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    three = (a_hi.double() * b_hi.double() + a_hi.double() * b_lo.double()
             + a_lo.double() * b_hi.double())
    assert ((three - exact).abs() / exact.abs()).max().item() > 2.0**-22


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
