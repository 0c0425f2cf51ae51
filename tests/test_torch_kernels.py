"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU and skip elsewhere (decided inside the
fixture, never at import). They import no JAX, so a GPU host without JAX
runs them with::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

``chip_smoke.py`` makes the same comparisons at the main path's shapes."""

import numpy as np
import pytest
import torch

from midvision_probe_torch.models import vit as t_vit
from midvision_probe_torch.models import zoo
from midvision_probe_torch.ops import attention as mha
from midvision_probe_torch.ops import rope2d
from midvision_probe_torch.ops import vit_attention as attn


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


# (B, N, H, d, n_valid): ragged N, padded rows poisoned with NaN, every
# supported head dim
CASES = [(2, 257, 2, 64, None), (2, 384, 2, 64, 257), (2, 70, 8, 16, None),
         (1, 256, 4, 32, 200), (2, 200, 2, 128, None), (3, 1, 1, 16, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1.6e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("B,N,H,d,n_valid", CASES)
def test_fused_qkv_attention_kernel_matches_plain_twin(cuda, dtype, tol,
                                                       B, N, H, d, n_valid):
    """bf16 tolerance: kernel and twin both round P and the output to bf16,
    summing in other orders (a few ulps at |o| <= 1); fp32: FMA order."""
    x = np.random.RandomState(0).randn(B, N, 3, H, d).astype(np.float32)
    if n_valid is not None:
        x[:, n_valid:] = np.nan
    qkv = torch.from_numpy(x).to(cuda, dtype)
    before = attn.fused_qkv_attention.launches
    with torch.no_grad():
        got = attn.fused_qkv_attention(qkv, d**-0.5, n_valid)
        ref = attn._fused_qkv_attention_plain(qkv, d**-0.5, n_valid)
    torch.cuda.synchronize()
    assert attn.fused_qkv_attention.launches == before + 1
    rows = n_valid or N
    assert torch.isfinite(got[:, :rows]).all()
    torch.testing.assert_close(got[:, :rows].float(), ref[:, :rows].float(),
                               atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,route", [(torch.bfloat16, 1.6e-2, "wgmma"),
                                             (torch.float32, 1e-5, "tf32x3")])
def test_fused_qkv_attention_at_the_nyu_center_crop(cuda, dtype, tol, route):
    """DINO ViT-B/16 on NYU's 480x480 center crop, the surface-normal
    trainer's launch: B=8, N = 30*30 + 1 = 901 tokens (no multiple of the
    kernel's tiles), H=12, d=64, on the route its dtype takes."""
    x = np.random.RandomState(1).randn(8, 901, 3, 12, 64).astype(np.float32)
    qkv = torch.from_numpy(x).to(cuda, dtype)
    routes = dict(attn.route_launches)
    with torch.no_grad():
        got = attn.fused_qkv_attention(qkv, 64**-0.5)
        ref = attn._fused_qkv_attention_plain(qkv, 64**-0.5)
    torch.cuda.synchronize()
    assert {r: n - routes[r] for r, n in attn.route_launches.items() if n != routes[r]} == {
        route: 1}
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.cuda
def test_fused_qkv_attention_kernel_rejects_what_it_cannot_take(cuda):
    with pytest.raises(ValueError, match="head dim"):
        attn.fused_qkv_attention(torch.zeros(1, 8, 3, 2, 48, device=cuda), 0.1)
    with pytest.raises(ValueError, match="dtype"):
        attn.fused_qkv_attention(torch.zeros(1, 8, 3, 2, 16, device=cuda,
                                             dtype=torch.float16), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        attn.fused_qkv_attention(
            torch.zeros(1, 8, 3, 2, 32, device=cuda)[..., :16], 0.1)
    # under autograd the kernel runs and the gradient is the plain
    # version's, recomputed (F12), as the JAX custom_vjp's
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(2)
    qkv = torch.from_numpy(rng.randn(1, 8, 3, 2, 16).astype(np.float32)).to(cuda)
    qkv.requires_grad_()
    g = torch.from_numpy(rng.randn(1, 8, 32).astype(np.float32)).to(cuda)
    before = attn.fused_qkv_attention.launches
    out = attn.fused_qkv_attention(qkv, 0.1, 6)
    assert attn.fused_qkv_attention.launches == before + 1 and out.grad_fn is not None
    (got,) = torch.autograd.grad(out, qkv, g)
    (ref,) = torch.autograd.grad(attn._fused_qkv_attention_plain(qkv, 0.1, 6), qkv, g)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_test_tiny_vit_on_the_card_matches_the_cpu_twin(cuda):
    """The whole test_tiny forward (4 kernel launches) against the same
    weights on the CPU twin; fp32 with TF32 off, atol 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        images = torch.from_numpy(
            np.random.RandomState(1).rand(2, 64, 96, 3).astype(np.float32))
        cpu = zoo.build_vit_extractor("test_tiny_vit", return_multilayer=True,
                                      device="cpu")
        gpu = zoo.build_vit_extractor("test_tiny_vit", return_multilayer=True,
                                      device=cuda)
        before = attn.fused_qkv_attention.launches
        got = gpu.features(images)
        assert attn.fused_qkv_attention.launches == before + 4
        for g, r in zip(got, cpu.features(images)):
            torch.testing.assert_close(g.cpu(), r, atol=1e-4, rtol=0)
    finally:
        torch.backends.cudnn.allow_tf32 = True


# ------------------------------------------------------------------ K4 knn2
def _knn2_inputs(B, N, M, d, seed=0, far_frac=0.0, ties=False):
    rng = np.random.RandomState(seed)
    if ties:
        # quarter-integer features: every distance is exact in any order, so
        # ties are real; each target row is duplicated M//2 rows later
        q = rng.randint(-3, 4, (B, N, d)).astype(np.float32) / 4
        base = rng.randint(-3, 4, (B, M // 2, d)).astype(np.float32) / 4
        t = np.concatenate([base, base], axis=1)
        return q, t
    q = rng.randn(B, N, d).astype(np.float32)
    t = rng.randn(B, M, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    if far_frac:
        t[rng.rand(B, M) < far_frac] = 1e3  # masked targets of the NAVI path
    return q, t


def _true_sq_dist(q, t, idx):
    """f64 squared distances of the chosen neighbours (B, N, 2)."""
    q64, t64 = q.double(), t.double()
    rows = torch.take_along_dim(t64[:, None], idx.long()[..., None], dim=2)  # B,N,2,d
    return ((q64[:, :, None] - rows) ** 2).sum(-1)


# (B, N, M, d, far_frac): ragged tiles, masked far targets, a wide feature
# dim, a tiny one, d not a multiple of 4 (element-wise staging), M == 2
K4_CASES = [(2, 1000, 777, 768, 0.0), (1, 2048, 2048, 768, 0.3),
            (1, 2048, 3000, 2048, 0.0), (2, 256, 256, 32, 0.0),
            (2, 300, 301, 19, 0.0), (3, 5, 2, 8, 0.0)]


def _knn2_matches_plain_twin(q, t):
    """One launch against the plain twin under K4's bars: no index >= M;
    indices equal on >= 99.9% of rows (random unit features have no exact
    ties; a 1e-6 near-tie may swap); on every row the chosen neighbours'
    true (f64) squared distances within 1e-5 of the twin's, and the
    kernel's distances within 1e-5 (+1e-5 rel) of the twin's."""
    from midvision_probe_torch.ops import matching

    B, N, M = q.shape[0], q.shape[1], t.shape[1]
    before = matching.knn2.launches
    dist, idx = matching._knn2_sq(q, t)
    ref_d, ref_i = matching._knn2_plain(q, t)
    torch.cuda.synchronize()
    assert matching.knn2.launches == before + 1
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (B, N, 2)
    assert int(idx.min()) >= 0 and int(idx.max()) < M
    agree = (idx == ref_i).all(-1).float().mean().item()
    assert agree >= 0.999, agree
    true_k, true_r = _true_sq_dist(q, t, idx), _true_sq_dist(q, t, ref_i)
    torch.testing.assert_close(true_k, true_r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dist, ref_d, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M,d,far_frac", K4_CASES)
def test_knn2_kernel_matches_plain_twin(cuda, B, N, M, d, far_frac):
    """K4's bars (``_knn2_matches_plain_twin``) at ragged tiles, masked far
    targets, a wide and a tiny feature dim, an odd d and M == 2."""
    q_np, t_np = _knn2_inputs(B, N, M, d, seed=N + M + d, far_frac=far_frac)
    _knn2_matches_plain_twin(torch.from_numpy(q_np).to(cuda), torch.from_numpy(t_np).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [127, 128, 129, 255, 256, 257])
@pytest.mark.parametrize("d", [19, 64, 100, 800])
def test_knn2_kernel_at_tile_edges(cuda, N, d):
    """N = M on both sides of the kernel's 128-row query block and 256-row
    target tile, d below, at and past its 32-feature chunks (19, 100 and
    800 zero-padded in the planes); B * N >= 1000 query rows, so that K4's
    99.9% bar allows one row in a thousand, as in the cases above."""
    B = -(-1000 // N)
    q_np, t_np = _knn2_inputs(B, N, N, d, seed=N * d)
    _knn2_matches_plain_twin(torch.from_numpy(q_np).to(cuda), torch.from_numpy(t_np).to(cuda))


@pytest.mark.cuda
def test_knn2_kernel_ties_break_to_the_lowest_index(cuda):
    from midvision_probe_torch.ops import matching

    q_np, t_np = _knn2_inputs(2, 500, 600, 64, seed=3, ties=True)
    q, t = torch.from_numpy(q_np).to(cuda), torch.from_numpy(t_np).to(cuda)
    dist, idx = matching._knn2_sq(q, t)
    ref_d, ref_i = matching._knn2_plain(q, t)
    torch.cuda.synchronize()
    torch.testing.assert_close(idx, ref_i, atol=0, rtol=0)
    torch.testing.assert_close(dist, ref_d, atol=0, rtol=0)


@pytest.mark.cuda
def test_knn2_kernel_ties_across_a_target_tile_boundary(cuda):
    """Exact ties between targets that lie in two 256-row target tiles
    (255 and 256, 511 and 512) on quarter-integer features: 1024 queries,
    the first two equal to targets 255 and 511, get (255, 256) and (511,
    512) at distance 0, and every row agrees with the plain twin bit for
    bit (the bar of the ``ties`` case above)."""
    from midvision_probe_torch.ops import matching

    rng = np.random.RandomState(7)
    t_np = rng.randint(-3, 4, (1, 600, 64)).astype(np.float32) / 4
    t_np[0, 256], t_np[0, 512] = t_np[0, 255], t_np[0, 511]
    q_np = rng.randint(-3, 4, (1, 1024, 64)).astype(np.float32) / 4
    q_np[0, 0], q_np[0, 1] = t_np[0, 255], t_np[0, 511]
    q, t = torch.from_numpy(q_np).to(cuda), torch.from_numpy(t_np).to(cuda)
    dist, idx = matching._knn2_sq(q, t)
    ref_d, ref_i = matching._knn2_plain(q, t)
    torch.cuda.synchronize()
    assert idx[0, 0].tolist() == [255, 256] and idx[0, 1].tolist() == [511, 512]
    assert dist[0, :2].abs().max().item() == 0.0
    torch.testing.assert_close(idx, ref_i, atol=0, rtol=0)
    torch.testing.assert_close(dist, ref_d, atol=0, rtol=0)


# ------------------------------------------------------- K2/K3 vit_attention
def _strided_qkv(B, N, H, d, dtype, seed):
    """q, k, v as (B, H, N, d) views of one (B, N, 3, H, d) projection."""
    x = np.random.RandomState(seed).randn(B, N, 3, H, d).astype(np.float32)
    return torch.from_numpy(x).to("cuda", dtype).permute(2, 0, 3, 1, 4).unbind(0)


# (B, H, N, d): every head dim at a ragged N, RADIO's d = 80, a long N (the
# JAX package's flash route), N = 1
K2_CASES = [(2, 2, 77, 16), (2, 2, 77, 32), (2, 2, 77, 64), (2, 2, 77, 80),
            (2, 2, 77, 128), (1, 3, 1201, 80), (1, 2, 4097, 80), (2, 1, 1, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1.6e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("B,H,N,d", K2_CASES)
def test_vit_attention_kernel_matches_plain_version(cuda, dtype, tol, B, H, N, d):
    """Strided views in, a (B, H, N, d) view of a (B, N, H, d) buffer out;
    fp32 with TF32 off. Tolerances as K1's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _strided_qkv(B, N, H, d, dtype, seed=N + d)
    before = (attn.vit_attention.launches, mha._flash_attention.launches)
    with torch.no_grad():
        got = attn.vit_attention(q, k, v, d**-0.5)
        flash = mha.multi_head_attention(q, k, v, scale=d**-0.5, use_flash=True)
        ref = attn._vit_attention_plain(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert (attn.vit_attention.launches, mha._flash_attention.launches) == (
        before[0] + 1, before[1] + 1)
    assert tuple(got.shape) == (B, H, N, d) and got.transpose(1, 2).is_contiguous()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(flash.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.cuda
def test_vit_attention_kernel_rejects_what_it_cannot_take(cuda):
    z = torch.zeros(1, 2, 8, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        attn.vit_attention(z, z, z, 0.1)
    z = torch.zeros(1, 2, 32, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous last"):
        attn.vit_attention(z.transpose(2, 3), z, z, 0.1)
    z = torch.zeros(1, 2, 8, 32, device=cuda, dtype=torch.bfloat16)
    wide = torch.zeros(1, 2, 8, 36, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        attn.vit_attention(wide[..., :32], z, z, 0.1)  # 72-byte rows
    with pytest.raises(ValueError, match="aligned"):
        attn.vit_attention(torch.zeros(2 * 8 * 32 + 1, device=cuda, dtype=torch.bfloat16)
                           [1:].view(1, 2, 8, 32), z, z, 0.1)
    with pytest.raises(ValueError, match="dtype"):
        attn.vit_attention(z.half(), z.half(), z.half(), 0.1)
    # under autograd the kernel runs and the gradient is the plain
    # version's, recomputed (F12)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = torch.from_numpy(np.random.RandomState(3).randn(1, 8, 3, 2, 32).astype(
        np.float32)).to(cuda).requires_grad_()
    q, k, v = base.permute(2, 0, 3, 1, 4).unbind(0)
    g = torch.ones(1, 2, 8, 32, device=cuda)
    before = attn.vit_attention.launches
    out = attn.vit_attention(q, k, v, 0.1)
    assert attn.vit_attention.launches == before + 1 and out.grad_fn is not None
    (got,) = torch.autograd.grad(out, base, g)
    (ref,) = torch.autograd.grad(attn._vit_attention_plain(q, k, v, 0.1), base, g)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


# ------------------------------------- K10/K11: the attention backward kernel
def _exact_grads(qkv, g, scale, n_valid, q_scale=1.0):
    """The gradient of (B, N, 3, H, d) qkv through exact softmax attention
    in float64 over the keys < n_valid, of q' = q * q_scale rounded to
    qkv's dtype (the multiplication's transpose for q), cotangent g
    (B, H, N, d)."""
    q, k, v = qkv.detach().permute(2, 0, 3, 1, 4).unbind(0)
    q = (q.float() * q_scale).to(qkv.dtype)
    leaves = [t.double().requires_grad_() for t in (q, k[:, :, :n_valid], v[:, :, :n_valid])]
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", leaves[0] * scale, leaves[1]), -1)
    dq, dk, dv = torch.autograd.grad(torch.einsum("bhqk,bhkd->bhqd", p, leaves[2]), leaves,
                                     g.double())
    pad = (0, 0, 0, qkv.shape[1] - n_valid)
    grads = [dq * q_scale, torch.nn.functional.pad(dk, pad), torch.nn.functional.pad(dv, pad)]
    return torch.stack([t.transpose(1, 2) for t in grads], dim=2)


def _hold_to_exact(got, plain, exact, dtype):
    """Each of dq, dk and dv: f32 within 1e-4 * max|exact|; bf16 within
    max(2^-6 * max|exact|, twice the plain version's own error). A part
    whose exact gradient is 0 everywhere (dq over a single key: P = 1, so
    dS = dP - di, two f32 sums of the same products in other orders) is held
    to its dtype's bar against the gradient's scale, max|exact| over the
    three: 1e-4 of it in f32, bf16's rounding 2^-8 of it in bf16."""
    scale = exact.abs().max().item()
    for role, name in enumerate("qkv"):
        e = exact[:, :, role]
        err = (got[:, :, role].double() - e).abs().max().item()
        if dtype == torch.float32:
            tol = 1e-4 * e.abs().max().item()
        else:
            plain_err = (plain[:, :, role].double() - e).abs().max().item()
            tol = max(2.0**-6 * e.abs().max().item(), 2 * plain_err)
        if not e.any():
            tol = (1e-4 if dtype == torch.float32 else 2.0**-8) * scale
        assert err <= tol, (name, err, tol)


# (B, N, H, d, n_valid): every head dim, ragged N, a partial last key tile
BWD_CASES = [(2, 77, 2, 16, 77), (1, 130, 2, 32, 100), (2, 200, 2, 64, 150),
             (1, 257, 3, 80, 257), (1, 96, 2, 128, 70)]
# the wgmma route (bf16, d 64 and 80): several query and key tiles with N and
# n_valid off the tiles' multiples, d = 80's split rows, B*H >= 132 blocks'
# columns adding into one dQ row from nine key tiles, one token
WGMMA_BWD_CASES = [(2, 300, 3, 64, 200), (1, 257, 2, 80, 129), (2, 1100, 72, 64, 1031),
                   (1, 390, 70, 80, 390), (1, 1, 1, 64, 1), (1, 1, 1, 80, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,N,H,d,n_valid", BWD_CASES)
def test_attention_backward_kernel_matches_plain_autograd(cuda, dtype, B, N, H, d, n_valid):
    """K10 through ``_flash_attention`` on strided views of a qkv
    projection (all N keys), and K11 through ``splash_attention`` with
    ``n_valid`` and q_scale (keys and values past n_valid NaN: never read,
    their gradient 0): one forward and one backward launch each, on the
    route ``backward_route`` names, held to an f64 oracle beside the plain
    version's autograd (TF32 off)."""
    _check_attention_backward(B, N, H, d, n_valid, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,d,n_valid", WGMMA_BWD_CASES)
def test_attention_backward_wgmma_route_matches_plain_autograd(cuda, B, N, H, d, n_valid):
    """The bf16 backward at d 64 and 80 on the wgmma route, as above."""
    assert attn.backward_route(d, torch.bfloat16) == "wgmma"
    _check_attention_backward(B, N, H, d, n_valid, torch.bfloat16)


def _check_attention_backward(B, N, H, d, n_valid, dtype):
    import midvision_probe_torch.bench_attn as ba

    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    routes = dict(attn.backward_route_launches)
    rng = np.random.RandomState(N + d)
    x = torch.from_numpy(rng.randn(B, N, 3, H, d).astype(np.float32)).to(cuda, dtype)
    g = torch.from_numpy(rng.randn(B, H, N, d).astype(np.float32)).to(cuda, dtype)
    scale = d**-0.5

    qkv = x.clone().requires_grad_()
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    before = (mha._flash_attention.launches, mha._flash_attention.backward_launches)
    (got,) = torch.autograd.grad(mha._flash_attention(q, k, v, scale), qkv, g)
    torch.cuda.synchronize()
    assert (mha._flash_attention.launches, mha._flash_attention.backward_launches) == (
        before[0] + 1, before[1] + 1)
    (plain,) = torch.autograd.grad(attn._vit_attention_plain(q, k, v, scale), qkv, g)
    _hold_to_exact(got, plain, _exact_grads(x, g, scale, N), dtype)

    poisoned = x.clone()
    poisoned[:, n_valid:, 1:] = float("nan")
    qkv = poisoned.requires_grad_()
    gs = g.transpose(1, 2).reshape(B, N, H * d)
    before = (ba.splash_attention.launches, ba.splash_attention.backward_launches)
    (got,) = torch.autograd.grad(ba.splash_attention(qkv, scale, n_valid), qkv, gs)
    torch.cuda.synchronize()
    assert (ba.splash_attention.launches, ba.splash_attention.backward_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(got).all() and not got[:, n_valid:, 1:].any()
    (plain,) = torch.autograd.grad(ba._splash_attention_plain(qkv, scale, n_valid), qkv, gs)
    _hold_to_exact(got, plain, _exact_grads(x, g, 1.0, n_valid, q_scale=scale), dtype)
    route = attn.backward_route(d, dtype)
    assert {r: n - routes[r] for r, n in attn.backward_route_launches.items()
            if n != routes[r]} == {route: 2}


# ------------------------------------------ the wgmma route (bf16, d 64 and 80)
# (B, H, N, n_valid, d): N not a multiple of 128 with n_valid < N (one or
# two KV tiles, a ragged last tile), d = 80's two-part rows, one token
WGMMA_CASES = [(2, 3, 300, 200, 64), (1, 2, 257, 129, 80), (2, 2, 77, 50, 80),
               (1, 1, 1, 1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N,n_valid,d", WGMMA_CASES)
def test_wgmma_route_never_reads_keys_past_n_valid(cuda, B, H, N, n_valid, d):
    """Strided (B, H, N, d) views of a (B, N, 3, H, d) projection whose k and
    v rows >= n_valid are NaN, through the strided launch: the wgmma route
    runs, every output row is finite and within K1's bf16 tolerance of the
    plain version over the valid keys."""
    x = np.random.RandomState(N + d).randn(B, N, 3, H, d).astype(np.float32)
    x[:, n_valid:, 1:] = np.nan
    q, k, v = torch.from_numpy(x).to(cuda, torch.bfloat16).permute(2, 0, 3, 1, 4).unbind(0)
    assert attn.attention_route(d, torch.bfloat16) == "wgmma"
    before = attn.route_launches["wgmma"]
    with torch.no_grad():
        got = attn.launch_attention(q, k, v, d**-0.5, n_valid)
        ref = attn._vit_attention_plain(q, k[:, :, :n_valid], v[:, :, :n_valid], d**-0.5)
    torch.cuda.synchronize()
    assert attn.route_launches["wgmma"] == before + 1
    assert tuple(got.shape) == (B, H, N, d) and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=1.6e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80])
def test_wgmma_route_takes_contiguous_and_transposed_operands(cuda, d):
    """The tensor maps follow the strides: contiguous (B, H, N, d) operands
    (head stride above the token stride) and (B, N, H, d) transposes (head
    stride below it) give the strided views' result."""
    q, k, v = _strided_qkv(2, 130, 3, d, torch.bfloat16, seed=d)
    with torch.no_grad():
        ref = attn._vit_attention_plain(q, k, v, d**-0.5)
        for layout in (lambda t: t.contiguous(),
                       lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)):
            got = attn.vit_attention(*(layout(t) for t in (q, k, v)), d**-0.5)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), ref.float(), atol=1.6e-2, rtol=0)


# ---------------------------------------- the tf32x3 route (float32, every d)
# (B, H, N, n_valid, d): every head dim, n_valid < N, one token, N = 4097
TF32X3_CASES = [(2, 3, 77, 77, 16), (2, 2, 130, 100, 32), (1, 3, 300, 257, 64),
                (2, 2, 200, 129, 80), (1, 2, 150, 150, 128), (1, 1, 1, 1, 80),
                (1, 2, 4097, 4097, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("q_scale", [1.0, 0.37])
@pytest.mark.parametrize("B,H,N,n_valid,d", TF32X3_CASES)
def test_tf32x3_route_matches_plain_version(cuda, B, H, N, n_valid, d, q_scale):
    """float32 on the tf32x3 route: strided views of a projection whose k
    and v rows >= n_valid are NaN, a non-unit q_scale; every output row
    finite and within 1e-5 of the plain version over the valid keys (f32,
    TF32 off), and the route reported as tf32x3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = np.random.RandomState(N + d).randn(B, N, 3, H, d).astype(np.float32)
    x[:, n_valid:, 1:] = np.nan
    q, k, v = torch.from_numpy(x).to(cuda).permute(2, 0, 3, 1, 4).unbind(0)
    assert attn.attention_route(d, torch.float32) == "tf32x3"
    before = attn.route_launches["tf32x3"]
    with torch.no_grad():
        got = attn.launch_attention(q, k, v, d**-0.5, n_valid, q_scale=q_scale)
        ref = attn._vit_attention_plain(q * q_scale, k[:, :, :n_valid], v[:, :, :n_valid],
                                        d**-0.5)
    torch.cuda.synchronize()
    assert attn.route_launches["tf32x3"] == before + 1
    assert tuple(got.shape) == (B, H, N, d) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 80, 128])
def test_tf32x3_route_takes_contiguous_and_transposed_operands(cuda, d):
    """Contiguous (B, H, N, d) operands and (B, N, H, d) transposes give the
    strided views' result within 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _strided_qkv(2, 131, 3, d, torch.float32, seed=d)
    with torch.no_grad():
        ref = attn._vit_attention_plain(q, k, v, d**-0.5)
        for layout in (lambda t: t.contiguous(),
                       lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)):
            got = attn.vit_attention(*(layout(t) for t in (q, k, v)), d**-0.5)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1.6e-2), (torch.float32, 1e-5)])
def test_head_dims_no_kernel_takes_run_einsum_on_the_card(cuda, dtype, tol):
    """d = 48: ``multi_head_attention`` computes the call with
    ``_einsum_attention`` on the card (no kernel launch, on any route), as
    the JAX package does off the TPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _strided_qkv(2, 200, 3, 48, dtype, seed=48)
    before = (dict(attn.route_launches), attn.vit_attention.launches,
              mha._flash_attention.launches)
    with torch.no_grad():
        got = mha.multi_head_attention(q, k, v, scale=48**-0.5)
        ref = mha._einsum_attention(q.cpu(), k.cpu(), v.cpu(), None, 48**-0.5)
    torch.cuda.synchronize()
    assert (dict(attn.route_launches), attn.vit_attention.launches,
            mha._flash_attention.launches) == before
    assert got.device.type == "cuda" and got.dtype == dtype
    torch.testing.assert_close(got.cpu().float(), ref.float(), atol=tol, rtol=0)


# ----------------------------------------------------------------- K5 rope2d
def _rope_inputs(B, H, gh, gw, dim, dtype, prefix, seed):
    """q as a strided (B, H, N, dim) view of a (B, N, 3, H, dim) projection
    (the first ``prefix`` tokens sliced off), and int32 (y, x) positions."""
    x = np.random.RandomState(seed).randn(B, prefix + gh * gw, 3, H, dim) * 2
    q = torch.from_numpy(x.astype(np.float32)).to("cuda", dtype).permute(2, 0, 3, 1, 4)[0]
    yy, xx = torch.meshgrid(torch.arange(gh), torch.arange(gw), indexing="ij")
    pos = torch.stack([yy.reshape(-1), xx.reshape(-1)], -1).to("cuda", torch.int32)
    return q[:, :, prefix:], pos[None].expand(B, -1, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,gh,gw,dim,prefix", [
    (2, 12, 14, 14, 64, 0), (2, 2, 4, 3, 64, 0), (2, 3, 5, 7, 64, 1), (3, 2, 6, 6, 16, 0)])
def test_rope2d_kernel_matches_plain_version(cuda, dtype, B, H, gh, gw, dim, prefix):
    """f32 within 1e-5 abs (|t| <~ 8: sin/cos/exp of the two may differ in
    the last ulp); bf16/fp16 within one ulp of the plain output."""
    q, pos = _rope_inputs(B, H, gh, gw, dim, dtype, prefix, seed=dim + gh)
    before = rope2d.rope_2d.launches
    with torch.no_grad():
        got = rope2d.rope_2d(q, pos)
        ref = rope2d._rope_2d_plain(q, pos)
    torch.cuda.synchronize()
    assert rope2d.rope_2d.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous() and got.shape == q.shape
    g, r = got.float(), ref.float()
    if dtype == torch.float32:
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
    else:
        ulp = 2.0**-7 if dtype == torch.bfloat16 else 2.0**-10
        assert bool(((g - r).abs() <= ulp * r.abs() + 1e-6).all())


@pytest.mark.cuda
def test_crocov2_shaped_vit_on_the_card_matches_the_cpu_plain_version(cuda):
    """A tiny CroCo-v2-shaped ViT (RoPE, no cls) and a RADIO-shaped one
    (d = 80): every block on the card goes through K5 (q and k) and K2,
    never K1; taps against the same weights on the CPU, fp32 with TF32 off,
    atol 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        images = torch.from_numpy(np.random.RandomState(1).rand(2, 32, 48, 3)
                                  .astype(np.float32))
        for cfg, k5 in ((dict(patch_size=8, width=64, depth=2, num_heads=2,
                              class_token=False, pos_embed="none", rope=True), 4),
                        (dict(patch_size=8, width=160, depth=2, num_heads=2,
                              final_norm=True, pos_embed_cls=False, table_grid=(4, 4)), 0)):
            cpu = zoo.random_init(t_vit.ViT(t_vit.ViTConfig(**cfg)))
            gpu = zoo.random_init(t_vit.ViT(t_vit.ViTConfig(**cfg))).to(cuda)
            before = (attn.fused_qkv_attention.launches, attn.vit_attention.launches,
                      rope2d.rope_2d.launches)
            with torch.no_grad():
                got = gpu(images.to(cuda), taps=[0, 1])["tokens"]
                ref = cpu(images, taps=[0, 1])["tokens"]
            assert (attn.fused_qkv_attention.launches, attn.vit_attention.launches,
                    rope2d.rope_2d.launches) == (before[0], before[1] + 2, before[2] + k5)
            for g, r in zip(got, ref):
                torch.testing.assert_close(g.cpu(), r, atol=1e-4, rtol=0)
    finally:
        torch.backends.cudnn.allow_tf32 = True


# ------------------------------------------------ K7, K8, K9: attention bench
def _bench_qkv(B, N, H, d, seed, clamp=False):
    """bf16 (B, N, 3, H, d) on the card: the bench's randn * 0.6, or (clamp)
    q and k at std 5 (base-2 scores far above 110) with v at std 0.25 (so
    that |o| stays near 1)."""
    x = np.random.RandomState(seed).randn(B, N, 3, H, d).astype(np.float32)
    x *= np.array([5.0, 5.0, 0.25] if clamp else [0.6] * 3, np.float32)[:, None, None]
    return torch.from_numpy(x).to("cuda", torch.bfloat16)


# (B, N, n_valid, H, d, clamp): the bench's padding, n_valid = N, ragged
# tiles, every head dim of the kernels, the clamp active
BENCH_CASES = [(2, 256, 200, 4, 64, False), (2, 256, 256, 4, 64, False),
               (2, 384, 301, 12, 64, False), (1, 128, 77, 2, 32, False),
               (1, 256, 250, 2, 128, False), (2, 256, 200, 4, 64, True)]


def _bench_tol(ref: torch.Tensor) -> float:
    """The bench kernels' bar: a few bf16 ulps of the largest plain output,
    capped at 1.6e-2 (where |o| nears 1)."""
    return min(1.6e-2, 2.0**-6 * ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,n_valid,H,d,clamp", BENCH_CASES)
def test_bench_attention_kernels_match_plain_versions(cuda, B, N, n_valid, H, d, clamp):
    """K7 at every width (one head to all heads per block, with and without
    stagger), K8 and K9 against their plain versions; bf16, max abs error
    <= min(1.6e-2, 2^-6 * max|ref|) (both sides round p and the output to
    bf16 and sum in other orders: a few bf16 ulps of the largest output).
    The clamp case checks on the plain side that scores above 110 occur."""
    from midvision_probe_torch import bench_attn as ba

    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = _bench_qkv(B, N, H, d, seed=N + n_valid + d, clamp=clamp)
    scale = d**-0.5
    if clamp:
        assert (ba.wide_scores(qkv, scale, n_valid) > 110).any()
        assert (ba.int8_scores(qkv, scale, n_valid) > 110).any()
    calls = [(ba.wide_attention, ba._wide_attention_plain, dict(width=w, stagger=st))
             for w in sorted({d, 2 * d, H * d}) if (H * d) % w == 0 for st in (False, True)]
    calls += [(ba.int8_attention, ba._int8_attention_plain, dict(width=d)),
              (ba.splash_attention, ba._splash_attention_plain, {})]
    for fn, plain, kw in calls:
        before = fn.launches
        with torch.no_grad():
            got = fn(qkv, scale, n_valid, **kw)
            ref = plain(qkv, scale, n_valid)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.shape == (B, N, H * d) and torch.isfinite(got).all(), fn.__name__
        torch.testing.assert_close(got.float(), ref.float(), atol=_bench_tol(ref), rtol=0,
                                   msg=lambda m, n=fn.__name__, k=kw: f"{n} {k}: {m}")


# (B, N, n_valid, H, d, clamp): K7 on the wgmma route (d 64 and 80): the
# bench's padding, n_valid = N, ragged tiles, the clamp active
K7_WGMMA_CASES = [(2, 384, 301, 12, 64, False), (2, 256, 256, 4, 64, False),
                  (2, 300, 177, 4, 80, False), (1, 1280, 1201, 12, 64, True),
                  (2, 256, 200, 4, 80, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,n_valid,H,d,clamp", K7_WGMMA_CASES)
def test_wide_attention_wgmma_route_matches_plain_version(cuda, B, N, n_valid, H, d, clamp):
    """K7 at d 64 and 80 on the wgmma route, with the projection's rows
    >= n_valid NaN: one head, four heads and all heads per block, with and
    without stagger, equal to each other and to the plain version within
    the bench kernels' bar (on the valid rows; rows past n_valid attend over
    the valid keys, so their NaN q makes them NaN on both sides)."""
    from midvision_probe_torch import bench_attn as ba

    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = _bench_qkv(B, N, H, d, seed=N + n_valid + d, clamp=clamp)
    qkv[:, n_valid:] = float("nan")
    scale = d**-0.5
    if clamp:
        assert (ba.wide_scores(qkv, scale, n_valid) > 110).any()
    assert ba.wide_route(d) == "wgmma"
    with torch.no_grad():
        ref = ba._wide_attention_plain(qkv, scale, n_valid)[:, :n_valid]
        outs = []
        for heads in (1, 4, H):
            for stagger in (False, True):
                before = (ba.wide_attention.launches, attn.route_launches["wgmma"])
                outs.append(ba.wide_attention(qkv, scale, n_valid, width=heads * d,
                                              stagger=stagger)[:, :n_valid])
                assert (ba.wide_attention.launches, attn.route_launches["wgmma"]) == (
                    before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    for got in outs:
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=_bench_tol(ref), rtol=0)
        torch.testing.assert_close(got, outs[0], atol=0, rtol=0)


@pytest.mark.cuda
def test_int8_attention_rows_whose_exponentials_underflow_get_zero(cuda):
    """q rows of -64 against positive keys at a scale of 8/d (scores near
    -350): every exp2 underflows, l takes the 1e-30 floor, and those rows
    come out 0 on both sides; K7 on both routes (d 32 on mma_sync, 64 and
    80 on wgmma) and K8."""
    from midvision_probe_torch import bench_attn as ba

    for d in (32, 64, 80):
        qkv = _bench_qkv(1, 128, 2, d, seed=5)
        qkv[:, :, 1] = qkv[:, :, 1].abs()
        qkv[:, :16, 0] = -64.0
        calls = [(ba.wide_attention, ba._wide_attention_plain)]
        if d != 80:
            calls.append((ba.int8_attention, ba._int8_attention_plain))
        for fn, plain in calls:
            with torch.no_grad():
                got, ref = fn(qkv, 8 / d, 100, width=2 * d), plain(qkv, 8 / d, 100)
            torch.cuda.synchronize()
            assert ref[:, :16].abs().max().item() == 0, fn.__name__
            assert got[:, :16].abs().max().item() == 0, (fn.__name__, d)
            torch.testing.assert_close(got.float(), ref.float(), atol=_bench_tol(ref), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_splash_attention_at_a_scale_that_is_not_a_power_of_two(cuda, d):
    """K9 with scale 80^-1/2: the kernel rounds q * scale to bf16 itself
    (``q_scale``), as ``_splash_q`` does; every head dim, on its route (d 64
    and 80 on wgmma, 32 and 128 on mma_sync), within the bench kernels'
    bar."""
    from midvision_probe_torch import bench_attn as ba

    qkv = _bench_qkv(2, 300, 3, d, seed=d)
    scale = 80**-0.5
    route = attn.attention_route(d, torch.bfloat16)
    before = attn.route_launches[route]
    with torch.no_grad():
        got = ba.splash_attention(qkv, scale, 250)
        ref = ba._splash_attention_plain(qkv, scale, 250)
    torch.cuda.synchronize()
    assert attn.route_launches[route] == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=_bench_tol(ref), rtol=0)


@pytest.mark.cuda
def test_bench_attention_kernels_reject_what_they_cannot_take(cuda):
    from midvision_probe_torch import bench_attn as ba

    qkv = torch.zeros(1, 128, 3, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        ba.wide_attention(qkv.float(), 0.1, 100, width=128)
    for d in (12, 136):  # outside both kernels' head dims
        odd = torch.zeros(1, 128, 3, 2, d, device=cuda, dtype=torch.bfloat16)
        launches = (ba.int8_attention.launches, ba.quantize_qk_heads.launches,
                    ba.wide_attention.launches)
        with pytest.raises(ValueError, match=f"head dim {d}"):
            ba.int8_attention(odd, 0.1, 100, width=d)
        with pytest.raises(ValueError, match=f"head dim {d}"):
            ba.wide_attention(odd, 0.1, 100, width=d)
        assert launches == (ba.int8_attention.launches, ba.quantize_qk_heads.launches,
                            ba.wide_attention.launches)
    with pytest.raises(ValueError, match="width"):
        ba.wide_attention(qkv, 0.1, 100, width=96)
    with pytest.raises(ValueError, match="n_valid"):
        ba.splash_attention(qkv, 0.1, 129)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 64])
def test_int8_prologue_kernels_equal_quantize_qk_bit_for_bit(cuda, d):
    """K8's prologue (``amax_qk`` and ``quantize_qk`` of csrc/bench_attn.cu)
    against ``quantize_qk`` on the card: the rows past n_valid hold +-3e4
    (the per-head scales must not see them; they quantize to +-127), head 1
    is zero in q and k (the 1e-8 floor of the scale). q8 and k8 equal bit for
    bit, head-major, with zero pad bytes at d = 8 and 16 (rows of 32 bytes);
    c within two f32 ulps."""
    from midvision_probe_torch import bench_attn as ba

    qkv = _bench_qkv(2, 300, 3, d, seed=d)
    qkv[:, 177:, :2] = 3e4
    qkv[:, 177:, :2, :, ::2] = -3e4
    qkv[:, :, :2, 1] = 0.0
    before = ba.quantize_qk_heads.launches
    with torch.no_grad():
        q8, k8, c = ba.quantize_qk_heads(qkv, d**-0.5, 177)
        rq, rk, rc = ba.quantize_qk(qkv, d**-0.5, 177)
    torch.cuda.synchronize()
    assert ba.quantize_qk_heads.launches == before + 1
    dp = ba.int8_row_bytes(d)
    assert q8.shape == k8.shape == (2, 3, 300, dp) and q8.dtype == torch.int8
    assert torch.equal(q8[..., :d], rq.transpose(1, 2))
    assert torch.equal(k8[..., :d], rk.transpose(1, 2))
    assert not q8[..., d:].any() and not k8[..., d:].any()
    assert (q8[:, [0, 2], 177:, :d].abs() == 127).all() and not q8[:, 1].any()
    assert (c.view(torch.int32) - rc.view(torch.int32)).abs().max().item() <= 2


# (B, N, n_valid, H, d, inputs): K8 at d = 64 on the wgmma route: the clamp
# active, rows whose exponentials all underflow, n_valid = N, ragged tiles
K8_WGMMA_CASES = [(2, 256, 200, 4, 64, "clamp"), (1, 256, 200, 2, 64, "underflow"),
                  (2, 256, 256, 4, 64, "bench"), (2, 300, 177, 4, 64, "bench")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,n_valid,H,d,inputs", K8_WGMMA_CASES)
def test_int8_attention_wgmma_route_matches_plain_version(cuda, B, N, n_valid, H, d, inputs):
    """K8 at d = 64 on the wgmma route (the attention kernel's clamped mode
    with an s8 QK^T), one head and two heads per block, within the bench
    kernels' bar of ``_int8_attention_plain``; the clamp case checks that
    scores above 110 occur, the underflow case that those rows are 0."""
    from midvision_probe_torch import bench_attn as ba

    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = _bench_qkv(B, N, H, d, seed=N + n_valid, clamp=inputs == "clamp")
    scale = d**-0.5
    if inputs == "underflow":
        qkv[:, :, 1] = qkv[:, :, 1].abs()
        qkv[:, :16, 0] = -64.0
        scale = 8 / d
    if inputs == "clamp":
        assert (ba.int8_scores(qkv, scale, n_valid) > 110).any()
    assert ba.int8_route(d) == "wgmma"
    with torch.no_grad():
        ref = ba._int8_attention_plain(qkv, scale, n_valid)
        for width in (d, 2 * d):
            before = (ba.int8_attention.launches, attn.route_launches["wgmma"])
            got = ba.int8_attention(qkv, scale, n_valid, width=width)
            torch.cuda.synchronize()
            assert (ba.int8_attention.launches, attn.route_launches["wgmma"]) == (
                before[0] + 1, before[1] + 1)
            assert got.shape == (B, N, H * d) and torch.isfinite(got).all()
            torch.testing.assert_close(got.float(), ref.float(), atol=_bench_tol(ref), rtol=0)
            if inputs == "underflow":
                assert got[:, :16].abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32, 128])
def test_int8_attention_mma_sync_route_at_other_head_dims(cuda, d):
    """K8 at d = 8, 16, 32 and 128 on csrc/bench_attn.cu's mma_sync kernel,
    reading the prologue's rows padded to 32 bytes; ragged tiles, against
    ``_int8_attention_plain`` within the bench kernels' bar."""
    from midvision_probe_torch import bench_attn as ba

    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = _bench_qkv(2, 300, 4, d, seed=d)
    assert ba.int8_route(d) == "mma_sync"
    before = (ba.int8_attention.launches, attn.route_launches["mma_sync"])
    with torch.no_grad():
        got = ba.int8_attention(qkv, d**-0.5, 177, width=2 * d)
        ref = ba._int8_attention_plain(qkv, d**-0.5, 177)
    torch.cuda.synchronize()
    assert (ba.int8_attention.launches, attn.route_launches["mma_sync"]) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=_bench_tol(ref), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 48, 96])
def test_wide_attention_mma_sync_route_at_padded_head_dims(cuda, d):
    """K7 at head dims that its mma_sync kernel runs at d rounded up to 16
    (columns >= d zero-filled in shared memory, never written), with the
    projection's rows >= n_valid NaN; with and without stagger, against
    ``_wide_attention_plain`` on the valid rows within the bench kernels'
    bar."""
    from midvision_probe_torch import bench_attn as ba

    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = _bench_qkv(2, 300, 4, d, seed=d + 1)
    qkv[:, 177:] = float("nan")
    assert ba.wide_route(d) == "mma_sync"
    with torch.no_grad():
        ref = ba._wide_attention_plain(qkv, d**-0.5, 177)[:, :177]
        for stagger in (False, True):
            got = ba.wide_attention(qkv, d**-0.5, 177, width=2 * d, stagger=stagger)
            torch.cuda.synchronize()
            assert got.shape == (2, 300, 4 * d)
            got = got[:, :177]
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got.float(), ref.float(), atol=_bench_tol(ref), rtol=0)


# ------------------------------------------------------------- K6 fused_mlp
def _mlp_inputs(M, C, H, dtype, seed):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(M, C), rng.randn(C, H) * C**-0.5, rng.randn(H) * 0.1,
              rng.randn(H, C) * H**-0.5, rng.randn(C) * 0.1]
    return [torch.from_numpy(a.astype(np.float32)).to("cuda", dtype) for a in arrays]


def _mlp_f32_close(fm, got, args, act, plain=None) -> None:
    """K6's float32 bar: the kernel within 1e-5 abs of the exact oracle
    (``_fused_mlp_exact``: float64 products and sums, rounded where the
    kernel rounds), and no farther from it than ``_fused_mlp_plain`` (the
    f32 chain with TF32 off, itself ~1e-5 off at DINO's MLP) at the same
    inputs."""
    exact = fm._fused_mlp_exact(*args, act=act)
    if plain is None:
        plain = fm._fused_mlp_plain(*args, act=act)
    err = (got - exact).abs().max().item()
    plain_err = (plain - exact).abs().max().item()
    vs_plain = (got - plain).abs().max().item()
    assert err <= 1e-5 and err <= plain_err, (err, plain_err, vs_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quickgelu"])
@pytest.mark.parametrize("M,C,H", [(300, 768, 256), (77, 768, 3072), (33, 1280, 160),
                                   (1, 768, 32), (64, 1280, 64), (40, 1024, 96)])
def test_fused_mlp_kernel_matches_plain_version(cuda, act, M, C, H):
    """bf16: every element within one bf16 ulp of its plain value plus one
    bf16 ulp of the largest plain output (the hidden activations round to
    bf16 on both sides; a different f32 summation order can flip one of
    those roundings, which moves a whole output row by a hidden ulp times a
    W2 entry); f32 with TF32 off: ``_mlp_f32_close``."""
    from midvision_probe_torch.ops import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.bfloat16, torch.float32):
        args = _mlp_inputs(M, C, H, dtype, seed=M + C + H)
        before = fm.fused_mlp.launches
        with torch.no_grad():
            got = fm.fused_mlp(*args, act=act)
            ref = fm._fused_mlp_plain(*args, act=act)
        torch.cuda.synchronize()
        assert fm.fused_mlp.launches == before + 1
        assert got.dtype == dtype and got.shape == (M, C) and torch.isfinite(got).all()
        if dtype == torch.float32:
            _mlp_f32_close(fm, got, args, act, plain=ref)
        else:
            g, r = got.float(), ref.float()
            tol = 2.0**-7 * (r.abs() + r.abs().max())
            assert bool(((g - r).abs() <= tol).all()), (g - r).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quickgelu"])
@pytest.mark.parametrize("C", [200, 384, 768, 1024, 1280, 1536])
@pytest.mark.parametrize("M", [77, 300])
@pytest.mark.parametrize("hidden", ["160", "4C"])
def test_fused_mlp_f32_at_every_width(cuda, act, C, M, hidden):
    """float32 on the bf16x6 GEMM at every width of the zoo, the JAX op's
    ViT-S (384) and ViT-g (1536) widths and C = 200 (a ragged 32-deep K
    slice in fc1, a ragged 128-column tile in fc2): ragged M (one and three
    128-row tiles), H = 160 (a ragged 128-column tile in fc1) and H = 4C;
    ``_mlp_f32_close``."""
    from midvision_probe_torch.ops import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    H = 160 if hidden == "160" else 4 * C
    args = _mlp_inputs(M, C, H, torch.float32, seed=M + C + H)
    before = fm.fused_mlp.launches
    with torch.no_grad():
        got = fm.fused_mlp(*args, act=act)
    torch.cuda.synchronize()
    assert fm.fused_mlp.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, C) and torch.isfinite(got).all()
    _mlp_f32_close(fm, got, args, act)


def _mlp_close(got: torch.Tensor, ref: torch.Tensor) -> None:
    """One bf16 ulp of each output plus one of the largest (see above)."""
    g, r = got.float(), ref.float()
    tol = 2.0**-7 * (r.abs() + r.abs().max())
    assert bool(((g - r).abs() <= tol).all()), (g - r).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quickgelu"])
@pytest.mark.parametrize("C", [768, 1024, 1280])
@pytest.mark.parametrize("M,H", [(77, 160), (300, 3072)])
def test_fused_mlp_wgmma_gemm_at_every_width(cuda, act, C, M, H):
    """The bf16 GEMM at each of the zoo's widths: ragged M (one and three
    128-row tiles), H = 160 (a ragged 256-column tile in fc1, a ragged
    64-deep K slice in fc2) and H = 3072."""
    from midvision_probe_torch.ops import fused_mlp as fm

    args = _mlp_inputs(M, C, H, torch.bfloat16, seed=M + C + H + len(act))
    with torch.no_grad():
        got = fm.fused_mlp(*args, act=act)
        ref = fm._fused_mlp_plain(*args, act=act)
    torch.cuda.synchronize()
    assert got.shape == (M, C) and torch.isfinite(got).all()
    _mlp_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quickgelu"])
@pytest.mark.parametrize("C", [384, 1536])
@pytest.mark.parametrize("M", [77, 300])
def test_fused_mlp_bf16_at_widths_outside_the_f32_instances(cuda, act, C, M):
    """bf16 at ViT-S's width (384) and ViT-g's (1536), which the JAX op
    takes: ragged M, H = 4C."""
    from midvision_probe_torch.ops import fused_mlp as fm

    args = _mlp_inputs(M, C, 4 * C, torch.bfloat16, seed=M + C + len(act))
    before = fm.fused_mlp.launches
    with torch.no_grad():
        got = fm.fused_mlp(*args, act=act)
        ref = fm._fused_mlp_plain(*args, act=act)
    torch.cuda.synchronize()
    assert fm.fused_mlp.launches == before + 1
    assert got.shape == (M, C) and torch.isfinite(got).all()
    _mlp_close(got, ref)


@pytest.mark.cuda
def test_fused_mlp_backward_on_the_card_matches_the_cpu(cuda):
    """The gradient (autograd through ``_plain``) on the card against the
    same on the CPU, f32 with TF32 off: 1e-5 abs. The loss is linear in the
    output (a seeded cotangent at std 0.25, gradients up to ~7), so the
    forward output, which the kernel computes on the card and its plain
    version on the CPU, does not enter the gradient."""
    from midvision_probe_torch.ops import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    args = _mlp_inputs(8, 768, 256, torch.float32, seed=3)
    cotangent = np.random.RandomState(4).randn(8, 768).astype(np.float32) * 0.25
    grads = []
    for device in ("cuda", "cpu"):
        leaves = [a.detach().to(device).requires_grad_() for a in args]
        out = fm.fused_mlp(*leaves, act="gelu")
        (out * torch.from_numpy(cotangent).to(device)).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_fused_mlp_kernel_rejects_what_it_cannot_take(cuda):
    from midvision_probe_torch.ops import fused_mlp as fm

    args = _mlp_inputs(4, 768, 64, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="dtype"):
        fm.fused_mlp(*[a.half() for a in args])
    fm.fused_mlp(*_mlp_inputs(4, 128, 64, torch.float32, seed=0))  # one rule for both dtypes
    with pytest.raises(ValueError, match="multiple of 8"):
        fm.fused_mlp(*_mlp_inputs(4, 388, 64, torch.float32, seed=0))
    with pytest.raises(ValueError, match="multiple of 8"):
        fm.fused_mlp(*_mlp_inputs(4, 388, 64, torch.bfloat16, seed=0))
    with pytest.raises(ValueError, match="multiple of 32"):
        fm.fused_mlp(*_mlp_inputs(4, 768, 48, torch.bfloat16, seed=0))
    with pytest.raises(ValueError, match="act"):
        fm.fused_mlp(*args, act="relu")
