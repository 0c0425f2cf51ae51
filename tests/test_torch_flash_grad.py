"""The gradient of the port's long-sequence route (``ops/attention.py::
_flash_attention``, K3; its backward on a card is K10) against ``jax.grad``
of the JAX package's ``ops/attention.py::_flash_attention`` under
``pltpu.force_tpu_interpret_mode()``, which runs the jax library's flash
forward and its own dq and dkv backward kernels in interpret mode. N = 200
is no multiple of 128, so the JAX side pads to 256 and masks the padding
with segment ids. f32, atol 1e-5 (the JAX side under
``jax.default_matmul_precision("float32")``). On the CPU the port runs its
plain version, whose autograd is the function K10 computes."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from midvision_probe_torch.ops import attention as t_mha
from midvision_probe_tpu.ops import attention as j_mha

F32 = jax.default_matmul_precision("float32")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_flash_attention_grad_matches_the_jax_library_backward_kernels():
    B, H, N, d = 1, 2, 200, 80
    rng = np.random.RandomState(3)
    arrays = [rng.randn(B, H, N, d).astype(np.float32) for _ in range(3)]
    g = rng.randn(B, H, N, d).astype(np.float32)
    scale = d**-0.5
    with F32, pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, k, v: j_mha._flash_attention(q, k, v, scale), *arrays)
        ref = [np.asarray(r) for r in vjp(g)]
    for fn in (lambda q, k, v: t_mha._flash_attention(q, k, v, scale),
               lambda q, k, v: t_mha.multi_head_attention(q, k, v, scale=scale,
                                                          use_flash=True)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
        got = torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(g))
        for name, a, b in zip("qkv", got, ref):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0, err_msg=name)
    assert t_mha._flash_attention.backward_launches == 0  # no kernel on the CPU
