#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It exits non-zero, printing no result, when no CUDA device is visible or
when the port's package is not next to this file. Otherwise it prints one
JSON line per phase and fails on the first failing phase:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the time to build the CUDA kernels from ``csrc/``.
2. ``kernel_checks``: the fused-qkv attention kernel against its plain
   PyTorch twin at the main path's shape (B=64, N=1201, H=12, d=64) in
   bfloat16 and in float32 (TF32 off for matmuls and cuDNN), with
   NaN-poisoned padded rows (N=1280, n_valid=1201), and at test_tiny's
   shape; each with its error, its tolerance and, at the main shape, the
   kernel's, the twin's and ``F.scaled_dot_product_attention``'s times
   (the last as a yardstick only; the port never calls it).
3. ``path``: the depth trainer (``midvision_probe_torch.train_depth``)
   through its ``main`` entry on full-width dino_b16 (random weights),
   synthetic 480x640 data, the DPT depth probe, a bf16 backbone: per-step
   losses, the CSV row, the kernel's launch count (it must be 12 per
   backbone forward), wall time and peak memory.
4. ``forward``: the bench protocol, dino_vitb16 at 480x640, batch 64,
   bf16, 4 taps, in images per second per card (CUDA events), with a
   profiler breakdown of one forward by kernel.

Then the ``nvidia-smi`` name/power-limit line, a ``kernels`` summary line
and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of one H100 SXM at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # SIMT, outside the tensor cores
PEAK_BYTES = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, iters: int = 15, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound_ms(B, N, n_valid, H, d, itemsize, peak_flops) -> tuple[float, str]:
    """Least time for one call: QK^T and PV over the valid keys at the
    dtype's peak, or the qkv read plus output write at the memory rate."""
    flops = 4.0 * B * H * N * n_valid * d
    nbytes = (B * N * 3 * H * d + B * N * H * d) * itemsize
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernel_checks(torch):
    import torch.nn.functional as F

    from midvision_probe_torch.ops.vit_attention import (
        _fused_qkv_attention_plain,
        fused_qkv_attention,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    # bf16: kernel and twin both round P and the output to bf16 but sum in
    # other orders -> a few bf16 ulps at |o| <= 1; fp32: FMA order only
    tol = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}
    cases = [
        ("main_bf16", 64, 1201, 12, 64, None, torch.bfloat16, True),
        ("main_fp32", 64, 1201, 12, 64, None, torch.float32, True),
        ("main_bf16_nan_padded", 64, 1280, 12, 64, 1201, torch.bfloat16, False),
        ("test_tiny_bf16", 8, 65, 2, 16, None, torch.bfloat16, False),
        ("test_tiny_fp32", 8, 65, 2, 16, None, torch.float32, False),
    ]
    results = []
    for name, B, N, H, d, nv, dtype, timed in cases:
        qkv = torch.randn(B, N, 3, H, d, device="cuda", generator=gen).to(dtype)
        if nv is not None:
            qkv[:, nv:] = float("nan")  # padded rows: the kernel must not read them
        scale = d**-0.5
        with torch.no_grad():
            out = fused_qkv_attention(qkv, scale, nv)
            ref = _fused_qkv_attention_plain(qkv, scale, nv)
        torch.cuda.synchronize()
        rows = nv or N
        o, r = out[:, :rows].float(), ref[:, :rows].float()
        err = (o - r).abs().max().item()
        rel = err / max(r.abs().max().item(), 1e-30)
        finite = bool(torch.isfinite(o).all())
        res = {"case": name, "shape": [B, N, H, d], "n_valid": nv, "dtype": str(dtype),
               "max_abs_err": err, "max_rel_err": rel, "tol": tol[dtype],
               "finite": finite, "ok": finite and err <= tol[dtype]}
        if timed:
            with torch.no_grad():
                res["kernel_ms"] = cuda_ms(torch, lambda: fused_qkv_attention(qkv, scale))
                res["plain_ms"] = cuda_ms(
                    torch, lambda: _fused_qkv_attention_plain(qkv, scale), iters=10)
                q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, N, d)
                res["library_ms"] = cuda_ms(
                    torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
            res["bound_ms"], res["bound_by"] = attention_bound_ms(
                B, N, N, H, d, qkv.element_size(), peak)
        results.append(res)
        del qkv, out, ref, o, r
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True  # the path runs with torch's defaults
    emit({"phase": "kernel_checks", "cases": results})
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel check failed: {bad}")
    return {r["case"]: r for r in results}


def phase_path(torch):
    from midvision_probe_torch import train_depth
    from midvision_probe_torch.models.feature_extractor import FeatureExtractor
    from midvision_probe_torch.ops.vit_attention import fused_qkv_attention

    out_dir = tempfile.mkdtemp(prefix="mvp_chip_smoke_")
    try:
        argv = ["backbone=dino_b16", "dataset=synthetic",
                "dataset.image_size=[480,640]", "dataset.num_instances=16",
                "probe=depth_dpt", "batch_size=8", "optimizer=one_epoch",
                "+system.backbone_dtype=bfloat16", "+render_images=False",
                f"output_dir={out_dir}"]
        torch.cuda.reset_peak_memory_stats()
        fused_qkv_attention.launches = 0
        FeatureExtractor.forward_count = 0
        t0 = time.perf_counter()
        row = train_depth.entry(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_qkv_attention.launches
        forwards = FeatureExtractor.forward_count
        csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses = row.pop("train_losses")
    res = {"phase": "path", "argv": argv, "train_losses": losses,
           "csv_files": csvs, "csv_row": row,
           "k1_launches": launches, "backbone_forwards": forwards,
           "k1_launches_per_forward": launches / max(forwards, 1),
           "wall_s": wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(res)
    checks = {
        "losses_finite": bool(losses) and all(math.isfinite(x) for x in losses),
        "csv_written": len(csvs) == 1,
        "sa_rmse_finite": math.isfinite(row["sa_rmse"]),
        "sa_d1_in_unit": 0.0 <= row["sa_d1"] <= 1.0,
        "k1_launched": launches > 0,
        "k1_12_per_forward": forwards > 0 and launches == 12 * forwards,
    }
    if not all(checks.values()):
        raise SystemExit(f"path check failed: {checks}")
    return launches


def phase_forward(torch, smi: str):
    from midvision_probe_torch.models.zoo import build_vit_extractor

    batch, hw = 64, (480, 640)
    backbone = build_vit_extractor("dino_vitb16", return_multilayer=True,
                                   dtype=torch.bfloat16, device="cuda")
    images = torch.randn(batch, *hw, 3, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(torch, lambda: backbone.features(images), iters=10, warmup=2)
    feats = backbone.features(images)
    shapes_ok = all(tuple(f.shape) == (batch, 30, 40, 768) and bool(torch.isfinite(f).all())
                    for f in feats)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        backbone.features(images)
        torch.cuda.synchronize()
    # device-side events only (the kernels): the aten ops that launch them
    # report the same time again
    by_kernel = sorted(
        ((e.key, e.device_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda kv: -kv[1])
    device_ms = sum(t for _, t in by_kernel)
    emit({"phase": "forward", "model": "dino_vitb16", "batch": batch, "image_hw": hw,
          "dtype": "bfloat16", "taps": backbone.multilayers, "forward_ms": ms,
          "imgs_per_s_per_card": batch / (ms / 1e3), "feature_shapes_ok": shapes_ok,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "profile_device_ms": device_ms,
          "profile_top": [[k[:80], t] for k, t in by_kernel[:8]],
          "nvidia_smi": smi})
    if not shapes_ok:
        raise SystemExit("forward check failed: tap shapes or values")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "midvision_probe_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(midvision_probe_torch/ not found next to this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from midvision_probe_torch.config.core import JAX_PACKAGE
    from midvision_probe_torch.ops import cuda_build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    cuda_build.build_all()
    ptxas = [ln.strip() for info in cuda_build.BUILD_INFO.values()
             for ln in info["log"].splitlines() if "registers" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0, "ptxas": ptxas})

    checks = phase_kernel_checks(torch)
    launches = phase_path(torch)
    torch.cuda.empty_cache()
    phase_forward(torch, smi)

    main_case = checks["main_bf16"]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "fused_qkv_attention",
        "route": "cuda",
        "source": "midvision_probe_torch/csrc/vit_attention.cu",
        "replaces": f"{JAX_PACKAGE}/ops/vit_attention.py:85",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
