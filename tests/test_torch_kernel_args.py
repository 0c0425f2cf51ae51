"""The Python side of the port's Hopper kernels that runs without a card:
the choice of attention route by head dim and dtype, the check of the
strided launch's ``q_scale``, and the wrappers' CPU path (the plain version,
no launch counted). The kernels themselves run in
``tests/test_torch_kernels.py`` on the card."""

import numpy as np
import pytest
import torch

from midvision_probe_torch import bench_attn as ba
from midvision_probe_torch.ops import fused_mlp as fm
from midvision_probe_torch.ops import vit_attention as attn


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128])
def test_attention_route_by_head_dim_and_dtype(d, dtype):
    """bf16 at d 64 and 80 on wgmma, the other bf16 head dims on mma_sync,
    float32 on simt."""
    if dtype == torch.float32:
        expected = "simt"
    else:
        expected = "wgmma" if d in (64, 80) else "mma_sync"
    assert attn.attention_route(d, dtype) == expected
    assert expected in attn.ROUTES and set(attn.route_launches) == set(attn.ROUTES)


def test_attention_route_rejects_what_no_kernel_takes():
    with pytest.raises(ValueError, match="head dim"):
        attn.attention_route(48, torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        attn.attention_route(64, torch.float16)


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
