"""The Python side of the port's Hopper kernels that runs without a card:
the choice of attention route by head dim and dtype, the dispatch of head
dims that no route takes to einsum, the fused MLP's width check, the check
of the strided launch's ``q_scale``, the attention backward's route table
and the argument checks of its launch (K10, K11), the recomputed backward
of K1 and K2 (F12) and the wrappers' CPU path (the plain version and its
autograd, no launch counted). The kernels themselves run in
``tests/test_torch_kernels.py`` on the card."""

import numpy as np
import pytest
import torch

from midvision_probe_torch import bench_attn as ba
from midvision_probe_torch.ops import attention as mha
from midvision_probe_torch.ops import fused_mlp as fm
from midvision_probe_torch.ops import vit_attention as attn


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128])
def test_attention_route_by_head_dim_and_dtype(d, dtype):
    """bf16 at d 64 and 80 on wgmma, the other bf16 head dims on mma_sync,
    float32 at every head dim on tf32x3."""
    assert attn.kernel_takes(d, dtype)
    if dtype == torch.float32:
        expected = "tf32x3"
    else:
        expected = "wgmma" if d in (64, 80) else "mma_sync"
    assert attn.attention_route(d, dtype) == expected
    assert expected in attn.ROUTES and set(attn.route_launches) == set(attn.ROUTES)


def test_attention_route_rejects_what_no_kernel_takes():
    assert not attn.kernel_takes(48, torch.bfloat16)
    assert not attn.kernel_takes(64, torch.float16)
    with pytest.raises(ValueError, match="head dim"):
        attn.attention_route(48, torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        attn.attention_route(64, torch.float16)


def _not_called(*args, **kwargs):
    raise AssertionError("a kernel route was taken")


@pytest.mark.parametrize("d,dtype", [(48, torch.bfloat16), (48, torch.float32),
                                     (96, torch.float32), (64, torch.float16)])
@pytest.mark.parametrize("N", [40, 5600])
def test_multi_head_attention_sends_what_no_kernel_takes_to_einsum(monkeypatch, d, dtype, N):
    """The route table decides before any launch: a head dim or dtype that
    no route takes goes to ``_einsum_attention`` on the operands' device, at
    a short and a long (K+V above 2 MB at f32) sequence; neither kernel
    wrapper is called. ``use_flash=True`` at such a call raises."""
    monkeypatch.setattr(mha, "vit_attention", _not_called)
    monkeypatch.setattr(mha, "_flash_attention", _not_called)
    rng = np.random.RandomState(d + N)
    q, k, v = (torch.from_numpy(rng.randn(1, 1, N, d).astype(np.float32)).to(dtype)
               for _ in range(3))
    got = mha.multi_head_attention(q, k, v, scale=d**-0.5)
    assert got.dtype == dtype and got.device == q.device and got.shape == q.shape
    torch.testing.assert_close(got, mha._einsum_attention(q, k, v, None, d**-0.5),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="no attention kernel takes head dim"):
        mha.multi_head_attention(q, k, v, scale=d**-0.5, use_flash=True)


@pytest.mark.parametrize("C", [384, 768, 1536, 8])
def test_fused_mlp_bf16_takes_any_width_that_is_a_multiple_of_8(C):
    """One rule for both dtypes: the wgmma GEMM (bf16) and its bf16x6 form
    (float32) take any C that is a multiple of 8, so ViT-S's 384 and ViT-g's
    1536 too, and any H that is a multiple of 32."""
    for dtype in (torch.bfloat16, torch.float32):
        fm.check_kernel_widths(C, 4 * C if C % 32 == 0 else 32, dtype)


@pytest.mark.parametrize("C", [384, 1536])
def test_fused_mlp_float32_takes_vit_s_and_vit_g_widths(C):
    """float32 at ViT-S's (384) and ViT-g's (1536) widths, which the JAX op
    takes in either dtype and the SIMT kernel refused, at H = 4C."""
    fm.check_kernel_widths(C, 4 * C, torch.float32)


@pytest.mark.parametrize("C,H,dtype,match", [
    (388, 1536, torch.bfloat16, "multiple of 8"), (388, 1536, torch.float32, "multiple of 8"),
    (768, 48, torch.bfloat16, "multiple of 32"), (768, 48, torch.float32, "multiple of 32"),
    (768, 3072, torch.float16, "dtype")])
def test_fused_mlp_width_check_rejects_what_no_kernel_takes(C, H, dtype, match):
    with pytest.raises(ValueError, match=match):
        fm.check_kernel_widths(C, H, dtype)


@pytest.mark.parametrize("d,route", [(32, "mma_sync"), (64, "wgmma"), (80, "wgmma"),
                                     (128, "mma_sync")])
def test_wide_attention_route_by_head_dim(d, route):
    """K7 at d 64 and 80 on the attention kernel's wgmma route (its clamped
    mode), at 32 and 128 on bench_attn.cu's mma_sync kernel; the CPU runs
    the plain version and counts no launch on any route."""
    assert ba.wide_route(d) == route and route in attn.ROUTES
    qkv = torch.from_numpy(np.random.RandomState(d).randn(1, 20, 3, 2, d).astype(np.float32)
                           ).bfloat16()
    before = (dict(attn.route_launches), ba.wide_attention.launches)
    got = ba.wide_attention(qkv, d**-0.5, 17, width=d, stagger=True)
    assert (dict(attn.route_launches), ba.wide_attention.launches) == before
    torch.testing.assert_close(got, ba._wide_attention_plain(qkv, d**-0.5, 17), atol=0, rtol=0)


def test_wide_attention_route_rejects_what_neither_kernel_takes():
    """K7 and K8 take no head dim outside their sets (d = 12 and 136 here),
    and say which head dim they refuse, before any launch."""
    for d in (12, 136):
        with pytest.raises(ValueError, match=f"head dim {d}"):
            ba.wide_route(d)
        with pytest.raises(ValueError, match=f"head dim {d}"):
            ba.int8_route(d)


# d: (K7's route, K8's route or None where K8 refuses d)
BENCH_ROUTES = {8: ("mma_sync", "mma_sync"), 16: ("mma_sync", "mma_sync"),
                48: ("mma_sync", None), 96: ("mma_sync", None), 64: ("wgmma", "wgmma")}


@pytest.mark.parametrize("d", list(BENCH_ROUTES))
def test_bench_kernel_routes_by_head_dim(d):
    """The head-dim table of the bench kernels: K7 takes every multiple of 8
    up to 128 (wgmma at 64 and 80, else mma_sync at d rounded up to 16), K8
    the head dims that the JAX int8 kernel takes up to 128 (wgmma at 64, 8,
    16, 32 and 128 on mma_sync, its q8 and k8 rows padded to 32 bytes)."""
    wide, int8 = BENCH_ROUTES[d]
    assert ba.wide_route(d) == wide and d in ba.WIDE_HEAD_DIMS
    if int8 is None:
        assert d not in ba.INT8_HEAD_DIMS
        with pytest.raises(ValueError, match=f"head dim {d}"):
            ba.int8_route(d)
    else:
        assert ba.int8_route(d) == int8 and int8 in attn.ROUTES
        assert ba.int8_row_bytes(d) == max(32, d)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), "0.125", None])
def test_launch_attention_rejects_a_q_scale_that_is_not_a_finite_float(bad):
    z = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q_scale"):
        attn.launch_attention(z, z, z, 1.0, q_scale=bad)


def test_launch_attention_checks_its_arguments_before_the_device():
    """On the CPU a well-formed call reaches the device check and raises
    there; no route counts a launch."""
    z = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    before = dict(attn.route_launches)
    with pytest.raises(ValueError, match="n_valid"):
        attn.launch_attention(z, z, z, 1.0, 9, q_scale=0.125)
    with pytest.raises(ValueError, match="head dim"):
        w = torch.zeros(1, 2, 8, 48, dtype=torch.bfloat16)
        attn.launch_attention(w, w, w, 1.0, q_scale=np.float32(0.125))
    with pytest.raises(ValueError, match="unsupported device"):
        attn.launch_attention(z, z, z, 1.0, 5, q_scale=np.float32(0.125))
    assert attn.route_launches == before


def test_splash_attention_on_the_cpu_is_its_plain_version():
    """K9's function at a scale that is not a power of two; the CPU runs
    the plain version and no route counts a launch."""
    rng = np.random.RandomState(0)
    qkv = torch.from_numpy((rng.randn(2, 40, 3, 2, 16) * 0.6).astype(np.float32)).bfloat16()
    before = (dict(attn.route_launches), ba.splash_attention.launches)
    got = ba.splash_attention(qkv, 80**-0.5, 33)
    assert (dict(attn.route_launches), ba.splash_attention.launches) == before
    torch.testing.assert_close(got, ba._splash_attention_plain(qkv, 80**-0.5, 33),
                               atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128])
def test_backward_route_by_head_dim_and_dtype(d, dtype):
    """The attention backward's route table (K10, K11): wgmma for bf16 at d
    64 and 80, mma_sync for the other bf16 head dims, tf32x3 for float32;
    the forward's route of the same name at every head dim and dtype, and
    a counter for each route."""
    if dtype == torch.float32:
        expected = "tf32x3"
    else:
        expected = "wgmma" if d in (64, 80) else "mma_sync"
    assert attn.backward_route(d, dtype) == expected == attn.attention_route(d, dtype)
    assert set(attn.backward_route_launches) == set(attn.ROUTES)


def test_backward_route_rejects_what_no_kernel_takes():
    with pytest.raises(ValueError, match="head dim"):
        attn.backward_route(48, torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        attn.backward_route(64, torch.float16)


def _backward_args(B=1, H=2, N=8, d=64, dtype=torch.bfloat16):
    z = torch.zeros(B, H, N, d, dtype=dtype)
    return [z, z, z, z, torch.zeros(B, H, N), z]


def test_launch_attention_backward_checks_its_arguments_before_the_device():
    """K10's and K11's launch raises on what the kernel does not take, each
    before the device: a head dim or dtype no route takes, n_valid, q_scale,
    mismatched shapes or dtypes, an lse that is not contiguous f32 (B, H,
    N); a well-formed call on the CPU raises at the device check."""
    with pytest.raises(ValueError, match="head dim"):
        attn.launch_attention_backward(*_backward_args(d=48), 1.0)
    with pytest.raises(ValueError, match="dtype"):
        attn.launch_attention_backward(*_backward_args(dtype=torch.float16), 1.0)
    with pytest.raises(ValueError, match="n_valid"):
        attn.launch_attention_backward(*_backward_args(), 1.0, n_valid=9)
    with pytest.raises(ValueError, match="q_scale"):
        attn.launch_attention_backward(*_backward_args(), 1.0, q_scale=float("nan"))
    args = _backward_args()
    with pytest.raises(ValueError, match="one shape"):
        attn.launch_attention_backward(args[0][:, :, :4], *args[1:], 1.0)
    with pytest.raises(ValueError, match="dout"):
        attn.launch_attention_backward(*args[:5], args[5][:, :1], 1.0)
    with pytest.raises(ValueError, match="out and dout"):
        attn.launch_attention_backward(*args[:3], args[3].float(), *args[4:], 1.0)
    for lse in (torch.zeros(1, 2, 9), torch.zeros(1, 2, 8, dtype=torch.float64),
                torch.zeros(1, 8, 2).transpose(1, 2)):
        with pytest.raises(ValueError, match="lse"):
            attn.launch_attention_backward(*args[:4], lse, args[5], 1.0)
    before = dict(attn.backward_route_launches)
    with pytest.raises(ValueError, match="unsupported device"):
        attn.launch_attention_backward(*args, 1.0, n_valid=5, q_scale=0.125)
    assert attn.backward_route_launches == before


def test_launch_attention_refuses_to_record_a_gradient():
    """The raw launch is not differentiable: under autograd it raises
    before the device (its callers wrap it in their gradients)."""
    z = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="records no gradient"):
        attn.launch_attention(z.clone().requires_grad_(), z, z, 1.0)


@pytest.mark.parametrize("n_valid", [None, 5])
def test_recomputed_backward_is_the_plain_versions_autograd(n_valid):
    """F12's wiring, run on the CPU with the plain version standing in for
    the launch: the gradient of ``_Recomputed`` (K1's and K2's on a card)
    is exactly the plain version's autograd."""
    rng = np.random.RandomState(1)
    qkv = torch.from_numpy(rng.randn(2, 8, 3, 2, 16).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(2, 8, 32).astype(np.float32))
    plain = attn._fused_qkv_attention_plain
    out = attn._Recomputed.apply(plain, plain, (0.3, n_valid), qkv)
    (got,) = torch.autograd.grad(out, qkv, g)
    (ref,) = torch.autograd.grad(plain(qkv, 0.3, n_valid), qkv, g)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    q, k, v = (t.detach().transpose(1, 2).requires_grad_() for t in qkv.unbind(2))
    gv = g.reshape(2, 8, 2, 16).transpose(1, 2)
    vit = attn._vit_attention_plain
    got = torch.autograd.grad(attn._Recomputed.apply(vit, vit, (0.3,), q, k, v), (q, k, v), gv)
    ref = torch.autograd.grad(vit(q, k, v, 0.3), (q, k, v), gv)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_splash_attention_grad_on_the_cpu_is_its_plain_versions():
    """K9's gradient on the CPU: the plain version's autograd, zero at the
    keys and values past n_valid, no forward or backward launch counted."""
    rng = np.random.RandomState(4)
    qkv = torch.from_numpy((rng.randn(2, 40, 3, 2, 16) * 0.6).astype(np.float32)).bfloat16()
    qkv.requires_grad_()
    g = torch.from_numpy(rng.randn(2, 40, 32).astype(np.float32)).bfloat16()
    before = (ba.splash_attention.launches, ba.splash_attention.backward_launches)
    (got,) = torch.autograd.grad(ba.splash_attention(qkv, 80**-0.5, 33), qkv, g)
    assert (ba.splash_attention.launches, ba.splash_attention.backward_launches) == before
    (ref,) = torch.autograd.grad(ba._splash_attention_plain(qkv, 80**-0.5, 33), qkv, g)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    assert not got[:, 33:, 1:].any()


def _mlp_args(M=6, C=16, H=32, dtype=torch.bfloat16):
    rng = np.random.RandomState(M + C + H)
    shapes = [(M, C), (C, H), (H,), (H, C), (C,)]
    return [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.3).to(dtype) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lead", [(6,), (2, 3), (1, 2, 3)])
def test_fused_mlp_on_the_cpu_is_its_plain_version(lead, dtype):
    """Any leading shape of x (its rows flattened), either dtype; the CPU
    runs the plain version and counts no launch."""
    args = _mlp_args(dtype=dtype)
    args[0] = args[0].reshape(*lead, 16)
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(*args, act="gelu_tanh")
    assert fm.fused_mlp.launches == before
    assert got.shape == (*lead, 16) and got.dtype == dtype
    torch.testing.assert_close(got, fm._fused_mlp_plain(*args, act="gelu_tanh"), atol=0, rtol=0)
