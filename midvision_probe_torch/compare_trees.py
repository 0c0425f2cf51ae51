"""Compare two checkouts of the repository on one card, in one run.

Runs each tree in a fresh process, in the order A B B A, so that a drift of
the card over the run falls on both trees alike. Each process builds the
tree's kernels, then measures with that tree's ``midvision_probe_torch``:

* ``host_us_per_launch``: host time of one K1 call (``fused_qkv_attention``)
  at a small shape (1 x 197 tokens, 12 heads of 64, bf16), where the card
  finishes each kernel before the host has queued the next: the wrapper's
  and the entry point's host cost per launch;
* ``k1_ms``: K1 at DINO ViT-B/16's shape (64 x 1201 tokens, 12 heads of 64,
  bf16), mean of 20 calls by CUDA events;
* ``k6_ms``: K6 (``fused_mlp``) at DINO's MLP (76,864 x 768 -> 3072, bf16)
  for each activation, mean of 10 calls by CUDA events;
* ``k6_f32``: K6 in float32 (gelu_tanh) at DINO's MLP and RADIO-v2's
  (76,864 x 1280 -> 5120): mean of 5 calls by CUDA events, the ``F.linear``
  chain's time (TF32 off; the same call in both trees), and the largest
  distances of the kernel's output, of ``_fused_mlp_plain``'s and of the
  kernel's from each other, the first two from an exact oracle: this
  file's tree's ``_fused_mlp_exact`` (float64 products and sums), loaded by
  path so that both trees are held to one oracle;
* ``kernel_ms``: the other kernels at ``chip_smoke.py``'s main shapes, mean
  of 10 calls by CUDA events: K3 in f32 (``_flash_attention`` on strided
  views, B=2, H=16, N=4097, d=80), K2 at RADIO-v2's launch (bf16, B=64,
  H=16, N=1201, d=80), K5 at CroCo-v2's q (bf16, 64 x 12 heads, 14 x 14,
  dim 64; also the mean of 200 back-to-back launches, ``k5_crocov2_200``,
  and the kernel's device time per launch from ``torch.profiler`` over 50,
  ``k5_device_ms``), the bench's K7 (``wide4``), K8 (with its prologue,
  ``k8_int8``; its prologue alone, ``k8_prologue``; its attention kernel
  alone on the prologue's output, ``k8_kernel``) and K9 (``splash``) at
  B=64, N=1280, n_valid=1201, H=12, d=64, and last K4 at ScanNet's (4 x
  19200^2 x 768); with SDPA's time on K3's and K7's inputs as the
  yardstick (``sdpa_f32_ms``, ``sdpa_bench_ms``; the same call in both
  trees);
* ``forward_imgs_per_s``: the frozen bf16 forwards of dino_vitb16 (480x640),
  crocov2_vitb16 (224x224) and radio_v2 (480x640) at batch 64, 4 taps,
  images per second from the mean of 5 forwards by CUDA events;
* ``depth``: the depth trainer on full-width ``dino_b16`` with
  ``chip_smoke.py``'s ``path`` arguments, three times (wall seconds),
  then once under ``torch.profiler``: wall, device time summed over the
  kernels, and the host operations with the most self time;
* ``scannet``: the ScanNet correspondence driver on full-width ``dino_b16``
  with ``chip_smoke.py``'s ``path_scannet`` arguments (8 synthetic pairs
  at 480x640 in batches of 4, K4 at 4 x 19200^2 x 768), six times (wall
  seconds), then once under ``torch.profiler`` as the depth trainer.

Seeded inputs; one JSON line per tree and run, then a summary line. Run from
the root of a checkout on a machine with a card::

    python -m midvision_probe_torch.compare_trees --trees <tree A> <tree B> \
        [--parts kernels forwards]

``--parts`` measures only some of the groups (``k1`` with
``host_us_per_launch``, ``k6``, ``kernels``, ``k6_f32``, ``forwards``,
``paths``: the depth and ScanNet runs); the default is all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

DEPTH_ARGV = ["backbone=dino_b16", "dataset=synthetic", "dataset.image_size=[480,640]",
              "dataset.num_instances=16", "probe=depth_dpt", "batch_size=8",
              "optimizer=one_epoch", "+system.backbone_dtype=bfloat16", "+render_images=False"]
DEPTH_REPS = 3  # unprofiled depth runs per process: the first carries the set-up
SCANNET_REPS = 6  # unprofiled ScanNet runs per process: its wall varies more than the depth runs
SCANNET_ARGV = ["backbone=dino_b16", "num_corr=1000", "scale_factor=0.25", "batch_pairs=4",
                "+system.backbone_dtype=bfloat16", "dataset=synthetic_scannet_hard",
                "dataset.image_hw=[480,640]", "+render_every=0"]
MLP_F32 = {"dino": (768, 3072), "radio": (1280, 5120)}  # (C, H) of K6's f32 cases
PARTS = ("k1", "k6", "kernels", "k6_f32", "forwards", "paths")


def _events_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms_per_launch(torch, fn, iters: int, name_part: str) -> float:
    """The device time per call of the kernels whose name holds
    ``name_part``, summed by ``torch.profiler`` over ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and name_part in e.key)
    return us / 1e3 / iters


def _k8_split(torch, ba, qkv) -> dict:
    """K8's prologue alone and its attention kernel alone on the prologue's
    output: ``quantize_qk_heads`` where the tree has it, else (an older
    tree) the PyTorch ``quantize_qk`` that its wrapper ran on the card."""
    prologue = getattr(ba, "quantize_qk_heads", ba.quantize_qk)
    q8, k8, c = prologue(qkv, 0.125, 1201)
    return {"k8_prologue": _events_ms(torch, lambda: prologue(qkv, 0.125, 1201), 10),
            "k8_kernel": _events_ms(
                torch, lambda: ba._launch_int8(q8, k8, c, qkv, 1201, 128), 10)}


def _kernel_ms(torch, gen) -> dict:
    """``kernel_ms`` above (this tree's wrappers)."""
    import torch.nn.functional as F

    from midvision_probe_torch import bench_attn as ba
    from midvision_probe_torch.ops.attention import _flash_attention
    from midvision_probe_torch.ops.matching import _knn2_sq
    from midvision_probe_torch.ops.rope2d import rope_2d
    from midvision_probe_torch.ops.vit_attention import vit_attention

    out = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = torch.randn(2, 4097, 3, 16, 80, device="cuda", generator=gen)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    out["k3_f32"] = _events_ms(torch, lambda: _flash_attention(q, k, v, 80**-0.5), 10)
    out["sdpa_f32_ms"] = _events_ms(
        torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=80**-0.5), 10)
    qkv = torch.randn(64, 1201, 3, 16, 80, device="cuda", generator=gen).bfloat16()
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    out["k2_radio"] = _events_ms(torch, lambda: vit_attention(q, k, v, 80**-0.5), 10)
    del qkv, q, k, v
    qkv = torch.randn(64, 196, 3, 12, 64, device="cuda", generator=gen).bfloat16()
    yy, xx = torch.meshgrid(torch.arange(14, device="cuda", dtype=torch.int32),
                            torch.arange(14, device="cuda", dtype=torch.int32), indexing="ij")
    pos = torch.stack([yy.reshape(-1), xx.reshape(-1)], -1)[None].expand(64, 196, 2)
    rope = lambda: rope_2d(qkv.permute(2, 0, 3, 1, 4)[0], pos)  # noqa: E731
    out["k5_crocov2"] = _events_ms(torch, rope, 10)
    out["k5_crocov2_200"] = _events_ms(torch, rope, 200)
    out["k5_device_ms"] = _device_ms_per_launch(torch, rope, 50, "rope")
    qkv = (torch.randn(64, 1280, 3, 12, 64, device="cuda", generator=gen) * 0.6).bfloat16()
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    out["k7_wide4"] = _events_ms(torch, lambda: ba.wide_attention(qkv, 0.125, 1201, width=256),
                                 10)
    out["k8_int8"] = _events_ms(torch, lambda: ba.int8_attention(qkv, 0.125, 1201), 10)
    out.update(_k8_split(torch, ba, qkv))
    out["k9_splash"] = _events_ms(torch, lambda: ba.splash_attention(qkv, 0.125, 1201), 10)
    out["sdpa_bench_ms"] = _events_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k[:, :, :1201], v[:, :, :1201], scale=0.125), 10)
    del qkv, q, k, v
    # last: the card's clock drops under K4's load, and the drop outlasts it
    qt = [torch.nn.functional.normalize(torch.randn(4, 19200, 768, device="cuda",
                                                    generator=gen), dim=-1) for _ in range(2)]
    out["k4_scannet"] = _events_ms(torch, lambda: _knn2_sq(*qt), 10)
    return out


def _exact_oracle():
    """``_fused_mlp_exact`` of the tree that holds this file (a parent tree
    may predate it), loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ops", "fused_mlp.py")
    spec = importlib.util.spec_from_file_location("_compare_trees_k6_oracle", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module._fused_mlp_exact


def _k6_f32(torch, gen) -> dict:
    """``k6_f32`` above (this tree's wrapper, this file's oracle)."""
    import torch.nn.functional as F

    from midvision_probe_torch.ops.fused_mlp import _fused_mlp_plain, fused_mlp

    exact = _exact_oracle()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, (C, H) in MLP_F32.items():
        x, w1, b1, w2, b2 = args = [
            torch.randn(64 * 1201, C, device="cuda", generator=gen),
            torch.randn(C, H, device="cuda", generator=gen) * C**-0.5,
            torch.randn(H, device="cuda", generator=gen) * 0.1,
            torch.randn(H, C, device="cuda", generator=gen) * H**-0.5,
            torch.randn(C, device="cuda", generator=gen) * 0.1]
        got = fused_mlp(*args, act="gelu_tanh")
        plain = _fused_mlp_plain(*args, act="gelu_tanh")
        ref = exact(*args, act="gelu_tanh")
        out[name] = {
            "ms": _events_ms(torch, lambda: fused_mlp(*args, act="gelu_tanh"), 5, warmup=1),
            "library_ms": _events_ms(torch, lambda: F.linear(F.gelu(
                F.linear(x, w1.t(), b1), approximate="tanh"), w2.t(), b2), 5, warmup=1),
            "err_vs_exact": (got - ref).abs().max().item(),
            "plain_err_vs_exact": (plain - ref).abs().max().item(),
            "err_vs_plain": (got - plain).abs().max().item()}
        del x, w1, b1, w2, b2, args, got, plain, ref
        torch.cuda.empty_cache()
    return out


def _forwards(torch) -> dict:
    """``forward_imgs_per_s`` above."""
    from midvision_probe_torch.models.zoo import build_vit_extractor

    out = {}
    for model, hw in (("dino_vitb16", (480, 640)), ("crocov2_vitb16", (224, 224)),
                      ("radio_v2", (480, 640))):
        backbone = build_vit_extractor(model, return_multilayer=True, dtype=torch.bfloat16,
                                       device="cuda")
        images = torch.randn(64, *hw, 3, device="cuda")
        out[model] = 64 / (_events_ms(torch, lambda: backbone.features(images), 5, 2) / 1e3)
        del backbone, images
        torch.cuda.empty_cache()
    return out


def _timed_entry(torch, module, argv) -> float:
    """Wall seconds of one run of a driver's ``entry``."""
    out_dir = tempfile.mkdtemp(prefix="mvp_compare_")
    try:
        t0 = time.perf_counter()
        module.entry(argv + [f"output_dir={out_dir}"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _profiled_entry(torch, module, argv) -> dict:
    """One more run of a driver under ``torch.profiler``: wall seconds,
    device ms summed over the kernels and the host operations with the most
    self time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = _timed_entry(torch, module, argv)
    events = prof.key_averages()
    device_ms = sum(e.device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    host = sorted(((e.key, e.self_cpu_time_total / 1e3) for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU), key=lambda kv: -kv[1])
    return {"wall_s": wall, "device_ms": device_ms,
            "host_self_ms_top": [[k[:60], t] for k, t in host[:12]]}


def _k6_bf16(torch, gen) -> dict:
    """``k6_ms`` above (this tree's wrapper)."""
    from midvision_probe_torch.ops.fused_mlp import ACTIVATIONS, fused_mlp

    bf16 = torch.bfloat16
    x = torch.randn(64 * 1201, 768, device="cuda", generator=gen).to(bf16)
    w1 = (torch.randn(768, 3072, device="cuda", generator=gen) * 768**-0.5).to(bf16)
    b1 = (torch.randn(3072, device="cuda", generator=gen) * 0.1).to(bf16)
    w2 = (torch.randn(3072, 768, device="cuda", generator=gen) * 3072**-0.5).to(bf16)
    b2 = (torch.randn(768, device="cuda", generator=gen) * 0.1).to(bf16)
    return {act: _events_ms(torch, lambda: fused_mlp(x, w1, b1, w2, b2, act=act), 10)
            for act in ACTIVATIONS}


def measure(tree: str, parts=PARTS) -> dict:
    """The numbers above of ``parts`` for the tree at ``tree`` (this process
    imports that tree's package)."""
    import torch

    import midvision_probe_torch
    from midvision_probe_torch import render_scannet_correspondence, train_depth
    from midvision_probe_torch.ops import cuda_build
    from midvision_probe_torch.ops.vit_attention import fused_qkv_attention

    t0 = time.perf_counter()
    cuda_build.build_all()
    res = {"tree": tree, "package": os.path.dirname(midvision_probe_torch.__file__),
           "build_s": time.perf_counter() - t0}
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    with torch.no_grad():
        if "k1" in parts:
            small = torch.randn(1, 197, 3, 12, 64, device="cuda", generator=gen).to(bf16)
            for _ in range(20):
                fused_qkv_attention(small, 0.125)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                fused_qkv_attention(small, 0.125)
            res["host_us_per_launch"] = (time.perf_counter() - t0) / 500 * 1e6
            torch.cuda.synchronize()
            qkv = torch.randn(64, 1201, 3, 12, 64, device="cuda", generator=gen).to(bf16)
            res["k1_ms"] = _events_ms(torch, lambda: fused_qkv_attention(qkv, 0.125), 20)
            del qkv
        if "k6" in parts:
            res["k6_ms"] = _k6_bf16(torch, gen)
        torch.cuda.empty_cache()
        if "kernels" in parts:
            res["kernel_ms"] = _kernel_ms(torch, gen)
        torch.cuda.empty_cache()
        if "k6_f32" in parts:
            res["k6_f32"] = _k6_f32(torch, gen)
        if "forwards" in parts:
            res["forward_imgs_per_s"] = _forwards(torch)
    torch.cuda.empty_cache()
    if "paths" in parts:
        res["depth_wall_s"] = [_timed_entry(torch, train_depth, DEPTH_ARGV)
                               for _ in range(DEPTH_REPS)]
        res["depth_profiled"] = _profiled_entry(torch, train_depth, DEPTH_ARGV)
        torch.cuda.empty_cache()
        res["scannet_wall_s"] = [_timed_entry(torch, render_scannet_correspondence,
                                              SCANNET_ARGV) for _ in range(SCANNET_REPS)]
        res["scannet_profiled"] = _profiled_entry(torch, render_scannet_correspondence,
                                                  SCANNET_ARGV)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar=("A", "B"),
                    help="roots of the two checkouts")
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS),
                    help="the groups of numbers to measure (default: all)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(measure(args.child, args.parts)), flush=True)
        return 0
    trees = [os.path.abspath(t) for t in args.trees]
    runs = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        # this file, run as a script from the tree's root, imports that
        # tree's package (a tree may predate this file)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--trees", *trees, "--parts",
             *args.parts, "--child", tree], cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    keys = ("host_us_per_launch", "k1_ms", "k6_ms", "k6_f32", "kernel_ms", "forward_imgs_per_s",
            "depth_wall_s", "scannet_wall_s")
    summary = {}
    for tree in trees:
        mine = [r for r in runs if r["tree"] == tree]
        summary[tree] = {k: [r[k] for r in mine] for k in keys if k in mine[0]}
        for k in ("depth_profiled", "scannet_profiled"):
            if k in mine[0]:
                summary[tree][k] = [[r[k]["wall_s"], r[k]["device_ms"]] for r in mine]
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:  # the tree's root, not this file's folder, on the path
        sys.path[0] = sys.argv[sys.argv.index("--child") + 1]
    sys.exit(main())
