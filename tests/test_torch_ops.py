"""Parity of the PyTorch port's ops with the JAX package's: the fused-qkv
attention's plain twin (the CUDA kernel itself is held against the twin in
test_torch_kernels.py and chip_smoke.py), resize, gelu and the
nearest-upsample conv fold.

Inputs are made from a seeded numpy RandomState and handed to both sides.
The JAX side runs under ``jax.default_matmul_precision("float32")`` (a
context: CPU JAX matmuls otherwise run at reduced precision)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from midvision_probe_torch.ops import activations as t_act
from midvision_probe_torch.ops import image as t_image
from midvision_probe_torch.ops import subpixel as t_sub
from midvision_probe_torch.ops import vit_attention as t_attn
from midvision_probe_tpu.ops import activations as j_act
from midvision_probe_tpu.ops import image as j_image
from midvision_probe_tpu.ops import subpixel as j_sub
from midvision_probe_tpu.ops import vit_attention as j_attn

F32 = jax.default_matmul_precision("float32")


# ------------------------------------------------------------ attention K1
# (B, N, H, d, n_valid): ragged N padded inside the JAX kernel, the
# network-padded layout with NaN garbage rows, and test_vit_attention's shape
ATTN_CASES = [(2, 257, 2, 64, None), (2, 384, 2, 64, 257), (2, 70, 8, 16, None),
              (1, 256, 4, 32, 200)]


def _qkv(rng, B, N, H, d, n_valid):
    x = rng.randn(B, N, 3, H, d).astype(np.float32)
    if n_valid is not None:
        x[:, n_valid:] = np.nan  # padded rows: must never reach valid outputs
    return x


@pytest.mark.parametrize("B,N,H,d,n_valid", ATTN_CASES)
def test_fused_qkv_attention_plain_matches_jax_kernel(rng, B, N, H, d, n_valid):
    """fp32, atol 1e-5: the JAX kernel's max-free exp2 softmax and the
    twin's max-subtracted softmax differ at f32 rounding only."""
    x = _qkv(rng, B, N, H, d, n_valid)
    scale = d**-0.5
    with F32:
        ref = np.asarray(j_attn.fused_qkv_attention(jnp.asarray(x), scale, True,
                                                    n_valid))
        ref_einsum = np.asarray(j_attn._fused_einsum_ref(jnp.asarray(x), scale,
                                                         n_valid))
    got = t_attn.fused_qkv_attention(torch.from_numpy(x), scale, n_valid).numpy()
    assert got.shape == (B, N, H * d)
    rows = n_valid or N
    assert np.isfinite(got[:, :rows]).all()
    np.testing.assert_allclose(got[:, :rows], ref[:, :rows], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:, :rows], ref_einsum[:, :rows], atol=1e-5, rtol=0)


def test_fused_qkv_attention_cpu_tensor_runs_the_plain_twin(rng):
    x = torch.from_numpy(_qkv(rng, 1, 40, 2, 16, None))
    before = t_attn.fused_qkv_attention.launches
    out = t_attn.fused_qkv_attention(x, 0.25)
    assert t_attn.fused_qkv_attention.launches == before  # no kernel launch
    torch.testing.assert_close(out, t_attn._fused_qkv_attention_plain(x, 0.25),
                               atol=0, rtol=0)


def test_fused_qkv_attention_rejects_bad_shapes(rng):
    with pytest.raises(ValueError, match="n_valid"):
        t_attn.fused_qkv_attention(torch.zeros(1, 8, 3, 2, 16), 0.25, n_valid=9)
    with pytest.raises(ValueError, match="qkv must be"):
        t_attn.fused_qkv_attention(torch.zeros(1, 8, 2, 2, 16), 0.25)


# ------------------------------------------------------------------ resize
RESIZE_CASES = [
    # (in_hw, kwargs): every mode the DPT head and the ViT use
    ((6, 5), dict(scale_factor=2, mode="nearest")),
    ((6, 5), dict(scale_factor=4, mode="nearest")),
    ((6, 5), dict(size=(12, 10), mode="bilinear", align_corners=True)),
    ((6, 5), dict(size=(24, 20), mode="bilinear", align_corners=False)),
    ((16, 16), dict(size=(9, 7), mode="bilinear", align_corners=False)),
    ((14, 14), dict(size=(30, 40), mode="bicubic", antialias=True)),
    ((14, 14), dict(size=(8, 12), mode="bicubic", antialias=True)),
]


@pytest.mark.parametrize("hw,kw", RESIZE_CASES)
def test_resize_matches_jax(rng, hw, kw):
    x = rng.randn(2, *hw, 3).astype(np.float32)
    with F32:
        ref = np.asarray(j_image.resize(jnp.asarray(x), **kw))
    got = t_image.resize(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)  # f32 matmul order


def test_resize_bilinear_matches_torch_interpolate(rng):
    """The port's NCHW probes use F.interpolate: same weights as resize."""
    x = rng.randn(2, 6, 5, 3).astype(np.float32)
    for ac in (True, False):
        got = t_image.resize(torch.from_numpy(x), size=(12, 10), mode="bilinear",
                             align_corners=ac)
        ref = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(12, 10),
                            mode="bilinear", align_corners=ac).permute(0, 2, 3, 1)
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


# -------------------------------------------------------------------- gelu
def test_gelu_erf_in_fp32_matches_jax(rng):
    x = rng.randn(1000).astype(np.float32) * 3
    ref = np.asarray(j_act.gelu(jnp.asarray(x)))
    got = t_act.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_gelu_tanh_in_bf16_matches_jax(rng):
    """bf16 uses the tanh form in both packages; an erf port would drift.
    Tolerance: one bf16 ulp of the output (2^-8 relative)."""
    x = rng.randn(1000).astype(np.float32) * 3
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = np.asarray(j_act.gelu(jnp.asarray(xb.float().numpy(), jnp.bfloat16))
                     .astype(jnp.float32))
    got = t_act.gelu(xb).float().numpy()
    assert t_act.gelu(xb).dtype == torch.bfloat16
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=2**-7)
    tanh_form = F.gelu(xb.float(), approximate="tanh").to(torch.bfloat16)
    torch.testing.assert_close(t_act.gelu(xb), tanh_form, atol=1e-2, rtol=2**-7)


# ----------------------------------------------------------------- subpixel
@pytest.mark.parametrize("up", [2, 4])
def test_nearest_up_conv_matches_jax_fold_and_plain_conv(rng, up):
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    k = rng.randn(3, 3, 8, 4).astype(np.float32) * 0.2  # HWIO
    b = rng.randn(4).astype(np.float32)
    with F32:
        ref = np.asarray(j_sub.conv3x3_after_nearest_up(
            jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), up))
    mod = t_sub.NearestUpConv(8, 4, up)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        mod.bias.copy_(torch.from_numpy(b))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = mod(xt)
        plain = F.conv2d(F.interpolate(xt, scale_factor=up, mode="nearest"),
                         mod.weight, mod.bias, padding=1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)
