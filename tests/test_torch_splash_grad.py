"""The gradient of the port's ``bench_attn.splash_attention`` (K9; its
backward on a card is K11) against ``jax.grad`` through the JAX bench's
splash line (``_jax_splash`` of ``test_torch_bench_attn.py``: the splash
library kernel in interpret mode, so its own dq and dkv backward kernels
run), bf16 at (1, 256, 3, 2, 64) with n_valid 200: each of dq, dk and dv
within 2^-6 * max|ref| (both sides round the probabilities, the gradients
and q * scale to bf16, summing in other orders), and the gradients of the
padded keys and values exactly 0 on both sides. On the CPU the port runs
its plain version, whose autograd is the function K11 computes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bench_attn import _jax_splash

from midvision_probe_torch import bench_attn as t_bench


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_splash_attention_grad_matches_the_splash_library_backward():
    B, N, H, d, n_valid = 1, 256, 2, 64, 200
    rng = np.random.RandomState(5)
    x = (rng.randn(B, N, 3, H, d) * 0.6).astype(np.float32)
    g = rng.randn(B, N, H * d).astype(np.float32)
    scale = d**-0.5
    with jax.default_matmul_precision("float32"):
        _, vjp = jax.vjp(lambda a: _jax_splash(a, scale, n_valid),
                         jnp.asarray(x).astype(jnp.bfloat16))
        (ref,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    ref = np.asarray(ref.astype(jnp.float32))
    qkv = torch.from_numpy(x).bfloat16().requires_grad_()
    out = t_bench.splash_attention(qkv, scale, n_valid)
    (got,) = torch.autograd.grad(out, qkv, torch.from_numpy(g).bfloat16())
    assert got.dtype == torch.bfloat16 and t_bench.splash_attention.backward_launches == 0
    got = got.float().numpy()
    for role, name in enumerate("qkv"):
        r = ref[:, :, role]
        np.testing.assert_allclose(got[:, :, role], r, atol=2.0**-6 * np.abs(r).max(), rtol=0,
                                   err_msg=name)
    for role in (1, 2):  # the padded keys and values
        assert not got[:, n_valid:, role].any() and not ref[:, n_valid:, role].any()
