"""The per-layer metrics' arithmetic on fabricated profiler events."""

from __future__ import annotations

import types

import pytest

from benchmark import manifest, peaks
from benchmark.trace import TraceData

KIND = "NVIDIA H100 80GB HBM3"
ATTN = "void (anonymous namespace)::attention_wgmma<64, false, false>(CUtensorMap_st)"
GEMM = "nvjet_tst_192x192_64x4_1x2_h_bz_coopB_bias_TNN"
CONV = "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16>"
ELEM = "void at::native::vectorized_elementwise_kernel<8, GeluCUDAKernelImpl>"
H2D = "Memcpy HtoD (Pageable -> Device)"


def _cfg():
    return {"patch_size": 16, "image_hw": [480, 640], "width": 768, "num_heads": 12,
            "mlp_ratio": 4.0, "dtype": "bfloat16", "taps": [2, 5, 8, 11]}


def _ctx(device, spans=None, steps=2, batch=64, kind=KIND):
    trace = TraceData(window=(0, 10_000_000), device=device,
                      spans={"bench.window": [(0, 10_000_000)], **(spans or {})}, host=[])
    return types.SimpleNamespace(cfg=_cfg(), mix={"batch": batch, "loop": "extract"},
                                 steps=steps, images=steps * batch, window_s=0.01,
                                 trace=trace, peak=lambda name: peaks.peak(kind, name),
                                 flops_per_image=lambda: 1e12)


def _read(name, ctx):
    return manifest.reader(name).read(ctx)


def test_attention_roofline():
    device = [(0, 2_000_000, ATTN, "kernel", 0), (2_000_000, 5_000_000, GEMM, "kernel", 0)]
    n, b, h, d = 1 + 30 * 40, 64, 12, 64
    bound = max(4 * b * h * n * n * d / 989e12, 4 * b * n * h * d * 2 / 3.35e12)
    expected = 100 * 2 * 12 * bound / 2e-3
    assert _read("attn_roofline", _ctx(device)) == pytest.approx(expected, rel=1e-12)


def test_linear_roofline_counts_gemms_and_not_convolutions():
    device = [(0, 3_000_000, GEMM, "kernel", 0), (3_000_000, 4_000_000, CONV, "kernel", 0)]
    n, b, dim = 1201, 64, 768
    bound = max(24 * n * dim * dim * b / 989e12,
                (12 * dim * dim + b * n * dim * 16) * 2 / 3.35e12)
    expected = 100 * 2 * 12 * bound / 3e-3
    assert _read("linear_roofline", _ctx(device)) == pytest.approx(expected, rel=1e-12)


@pytest.mark.parametrize("name", ["attn_roofline", "linear_roofline"])
def test_a_roofline_that_matches_nothing_raises(name):
    """A kernel renamed or a new route under a name the patterns miss fails
    the traced run; the metric does not go silent."""
    device = [(0, 1_000_000, ELEM, "kernel", 0), (1_000_000, 2_000_000, H2D, "copy", 0)]
    with pytest.raises(LookupError, match=name):
        _read(name, _ctx(device))


@pytest.mark.parametrize("name", ["attn_roofline", "linear_roofline"])
def test_a_card_without_peaks_reads_no_roofline(name):
    device = [(0, 1_000_000, ATTN, "kernel", 0), (1_000_000, 2_000_000, GEMM, "kernel", 0)]
    assert _read(name, _ctx(device, kind="cpu")) is None


def test_idle_share_is_the_union_of_device_intervals():
    device = [(0, 4_000_000, ELEM, "kernel", 0), (2_000_000, 6_000_000, GEMM, "kernel", 0),
              (8_000_000, 9_000_000, H2D, "copy", 0)]
    assert _read("device_idle_share", _ctx(device)) == pytest.approx(30.0)


def test_layers_split_by_the_backbone_span():
    spans = {"bench.backbone": [(0, 1_000), (5_000, 6_000)]}
    device = [(0, 1_000_000, ATTN, "kernel", 500), (1_000_000, 3_000_000, ELEM, "kernel", 2_000),
              (3_000_000, 4_000_000, GEMM, "kernel", 5_500),
              (4_000_000, 5_000_000, H2D, "copy", 1_500),
              (5_000_000, 5_500_000, ELEM, "kernel", None)]
    ctx = _ctx(device, spans)
    assert _read("backbone_ms_per_step", ctx) == pytest.approx(1.0)
    assert _read("probe_ms_per_step", ctx) == pytest.approx(1.25)
    assert _read("h2d_ms_per_step", ctx) == pytest.approx(0.5)


def test_mfu():
    assert _read("mfu", _ctx([])) == pytest.approx(100 * 1e12 * 128 / 0.01 / 989e12)


def test_breakdown_names_gaps_by_the_host():
    trace = TraceData(window=(0, 100_000), device=[(10_000, 20_000, ELEM, "kernel", 0),
                                                   (50_000, 60_000, GEMM, "kernel", 0)],
                      spans={}, host=[(0, 100_000, "aten::backward"),
                                      (25_000, 45_000, "aten::copy_")])
    out = trace.breakdown()
    assert out["device_ops"] == [[ELEM, 1e-5], [GEMM, 1e-5]]
    gaps = dict(out["idle_gaps"])
    assert gaps["host: aten::copy_"] == pytest.approx(3e-5)
    assert gaps["host: aten::backward"] == pytest.approx(5e-5)
