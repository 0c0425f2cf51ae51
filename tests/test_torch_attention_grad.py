"""Gradients of the port's K1 and K2 wrappers (``ops/vit_attention.py``:
``fused_qkv_attention`` with and without ``n_valid``, ``vit_attention``)
against the JAX package's ``custom_vjp``s, whose forward is the Pallas
kernel in interpret mode and whose backward is the vjp of the einsum
reference: the same numpy inputs and cotangent, f32, atol 1e-5 (f32 scores
and softmax on both sides, summation order only; the JAX side under
``jax.default_matmul_precision("float32")``). On the CPU the port's
wrappers run their plain versions, whose autograd is the recomputed vjp
that the card's backward takes (F12)."""

import jax
import numpy as np
import pytest
import torch

from midvision_probe_torch.ops import vit_attention as t_attn
from midvision_probe_tpu.ops import vit_attention as j_attn

F32 = jax.default_matmul_precision("float32")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_grads(fn, arrays, cotangent):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*leaves)
    return [g.numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(cotangent))]


@pytest.mark.parametrize("n_valid", [None, 100])
def test_fused_qkv_attention_grad_matches_jax_custom_vjp(n_valid):
    """(1, 128, 3, 4, 32) with a cotangent on every output row (padded
    query rows are real outputs; padded keys and values get no gradient)."""
    rng = np.random.RandomState(7)
    qkv = rng.randn(1, 128, 3, 4, 32).astype(np.float32)
    g = rng.randn(1, 128, 128).astype(np.float32)
    with F32:
        _, vjp = jax.vjp(lambda x: j_attn.fused_qkv_attention(x, 0.3, True, n_valid), qkv)
        (ref,) = vjp(g)
    (got,) = _port_grads(lambda x: t_attn.fused_qkv_attention(x, 0.3, n_valid), [qkv], g)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    if n_valid is not None:
        assert not got[:, n_valid:, 1:].any() and not np.asarray(ref)[:, n_valid:, 1:].any()


@pytest.mark.parametrize("d", [16, 80])
def test_vit_attention_grad_matches_jax_custom_vjp(d):
    """(1, 2, 70, d): N pads to 128 in the JAX kernel."""
    rng = np.random.RandomState(d)
    arrays = [rng.randn(1, 2, 70, d).astype(np.float32) for _ in range(3)]
    g = rng.randn(1, 2, 70, d).astype(np.float32)
    scale = d**-0.5
    with F32:
        _, vjp = jax.vjp(lambda q, k, v: j_attn.vit_attention(q, k, v, scale, True), *arrays)
        ref = vjp(g)
    got = _port_grads(lambda q, k, v: t_attn.vit_attention(q, k, v, scale), arrays, g)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0, err_msg=name)
