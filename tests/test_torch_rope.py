"""Parity of the port's 2D RoPE (``ops/rope2d.py``) with the JAX package's:
the plain version against the Pallas kernel K5 in interpret mode and
against the jnp composition, on the same numpy inputs.

Tolerances: f32 1e-6 abs (|t| <= ~4, |out| <= ~6: the same f32 formula,
where sin/cos/exp of the two libraries may differ in the last ulp); bf16
one bf16 ulp of the reference (2**-7 relative, +1e-6), since an f32 ulp
difference before the final rounding can flip it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midvision_probe_torch.ops import rope2d as t_rope
from midvision_probe_tpu.ops import rope2d as j_rope

F32 = jax.default_matmul_precision("float32")


def _inputs(B, H, gh, gw, dim, seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randn(B, H, gh * gw, dim).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    pos = np.stack([yy.reshape(-1), xx.reshape(-1)], -1).astype(np.int32)
    return tokens, np.broadcast_to(pos[None], (B, gh * gw, 2)).copy()


def _assert_close(got, ref, dtype):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    else:
        assert np.all(np.abs(got - ref) <= 2.0**-7 * np.abs(ref) + 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,gh,gw,dim", [
    (2, 2, 4, 4, 64),   # CroCo-v2's head dim on a square grid
    (1, 3, 3, 5, 16),   # a small dim on a non-square grid
    (2, 1, 7, 2, 64),   # tall grid, one head
])
def test_rope_2d_matches_jax(dtype, B, H, gh, gw, dim):
    tokens, pos = _inputs(B, H, gh, gw, dim, seed=gh * 10 + gw + dim)
    jt = jnp.asarray(tokens).astype(dtype)
    with F32:
        ref_kernel = j_rope.rope_2d(jt, jnp.asarray(pos), base=100.0,
                                    use_pallas=True, interpret=True)
        ref_jnp = j_rope.rope_2d(jt, jnp.asarray(pos), base=100.0, use_pallas=False)
    tt = torch.from_numpy(tokens).to(getattr(torch, dtype))
    got = t_rope.rope_2d(tt, torch.from_numpy(pos), base=100.0)
    assert got.dtype == tt.dtype and tuple(got.shape) == tokens.shape
    got = got.float().numpy()
    _assert_close(got, ref_kernel.astype(jnp.float32), dtype)
    _assert_close(got, ref_jnp.astype(jnp.float32), dtype)


def test_rope_2d_prefix_slice_of_a_strided_view():
    """The module's call: q as a strided (B, H, N, d) view of the qkv
    projection, with a one-token prefix sliced off; the plain version reads
    the view as it is. Against JAX on the same slice, f32 1e-6."""
    B, H, gh, gw, d = 2, 2, 3, 4, 16
    rng = np.random.RandomState(5)
    qkv = rng.randn(B, 1 + gh * gw, 3, H, d).astype(np.float32)
    _, pos = _inputs(B, H, gh, gw, d, seed=0)
    q = torch.from_numpy(qkv).permute(2, 0, 3, 1, 4)[0]  # (B, H, N, d) view
    assert not q.is_contiguous()
    got = t_rope.rope_2d(q[:, :, 1:], torch.from_numpy(pos))
    with F32:
        ref = j_rope.rope_2d(jnp.asarray(qkv[:, 1:, 0].transpose(0, 2, 1, 3)),
                             jnp.asarray(pos), use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_rope_2d_rejects_what_it_cannot_take():
    with pytest.raises(ValueError, match="divisible by 4"):
        t_rope.rope_2d(torch.zeros(1, 1, 4, 18), torch.zeros(1, 4, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="positions"):
        t_rope.rope_2d(torch.zeros(1, 1, 4, 16), torch.zeros(1, 5, 2, dtype=torch.int32))
    before = t_rope.rope_2d.launches
    t_rope.rope_2d(torch.zeros(1, 1, 4, 16), torch.zeros(1, 4, 2, dtype=torch.int32))
    assert t_rope.rope_2d.launches == before  # the plain version is no launch
