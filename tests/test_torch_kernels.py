"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA GPU and skip elsewhere (decided inside the
fixture, never at import). They import no JAX, so a GPU host without JAX
runs them with::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

``chip_smoke.py`` makes the same comparisons at the main path's shapes."""

import numpy as np
import pytest
import torch

from midvision_probe_torch.models import zoo
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
def test_fused_qkv_attention_kernel_rejects_what_it_cannot_take(cuda):
    with pytest.raises(ValueError, match="head dim"):
        attn.fused_qkv_attention(torch.zeros(1, 8, 3, 2, 48, device=cuda), 0.1)
    with pytest.raises(ValueError, match="dtype"):
        attn.fused_qkv_attention(torch.zeros(1, 8, 3, 2, 16, device=cuda,
                                             dtype=torch.float16), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        attn.fused_qkv_attention(
            torch.zeros(1, 8, 3, 2, 32, device=cuda)[..., :16], 0.1)
    with pytest.raises(RuntimeError, match="forward-only"):
        attn.fused_qkv_attention(
            torch.zeros(1, 8, 3, 2, 16, device=cuda, requires_grad=True), 0.1)


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
