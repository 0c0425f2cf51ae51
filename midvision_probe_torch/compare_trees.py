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
* ``depth``: the depth trainer on full-width ``dino_b16`` with
  ``chip_smoke.py``'s ``path`` arguments, three times (wall seconds),
  then once under ``torch.profiler``: wall, device time summed over the
  kernels, and the host operations with the most self time.

Seeded inputs; one JSON line per tree and run, then a summary line. Run from
the root of a checkout on a machine with a card::

    python -m midvision_probe_torch.compare_trees --trees <tree A> <tree B>
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


def _depth_run(torch, train_depth) -> float:
    out_dir = tempfile.mkdtemp(prefix="mvp_compare_")
    try:
        t0 = time.perf_counter()
        train_depth.entry(DEPTH_ARGV + [f"output_dir={out_dir}"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def measure(tree: str) -> dict:
    """Every number above for the tree at ``tree`` (this process imports
    that tree's package)."""
    import torch

    import midvision_probe_torch
    from midvision_probe_torch import train_depth
    from midvision_probe_torch.ops import cuda_build
    from midvision_probe_torch.ops.fused_mlp import ACTIVATIONS, fused_mlp
    from midvision_probe_torch.ops.vit_attention import fused_qkv_attention

    t0 = time.perf_counter()
    cuda_build.build_all()
    res = {"tree": tree, "package": os.path.dirname(midvision_probe_torch.__file__),
           "build_s": time.perf_counter() - t0}
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    with torch.no_grad():
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
        x = torch.randn(64 * 1201, 768, device="cuda", generator=gen).to(bf16)
        w1 = (torch.randn(768, 3072, device="cuda", generator=gen) * 768**-0.5).to(bf16)
        b1 = (torch.randn(3072, device="cuda", generator=gen) * 0.1).to(bf16)
        w2 = (torch.randn(3072, 768, device="cuda", generator=gen) * 3072**-0.5).to(bf16)
        b2 = (torch.randn(768, device="cuda", generator=gen) * 0.1).to(bf16)
        res["k6_ms"] = {act: _events_ms(torch, lambda: fused_mlp(x, w1, b1, w2, b2, act=act), 10)
                        for act in ACTIVATIONS}
        del x, w1, b1, w2, b2
    torch.cuda.empty_cache()
    res["depth_wall_s"] = [_depth_run(torch, train_depth) for _ in range(DEPTH_REPS)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = _depth_run(torch, train_depth)
    events = prof.key_averages()
    device_ms = sum(e.device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    host = sorted(((e.key, e.self_cpu_time_total / 1e3) for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU), key=lambda kv: -kv[1])
    res["depth_profiled"] = {"wall_s": wall, "device_ms": device_ms,
                             "host_self_ms_top": [[k[:60], t] for k, t in host[:12]]}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar=("A", "B"),
                    help="roots of the two checkouts")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(measure(args.child)), flush=True)
        return 0
    trees = [os.path.abspath(t) for t in args.trees]
    runs = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        # this file, run as a script from the tree's root, imports that
        # tree's package (a tree may predate this file)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--trees", *trees, "--child", tree],
            cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for tree in trees:
        mine = [r for r in runs if r["tree"] == tree]
        summary[tree] = {
            "host_us_per_launch": [r["host_us_per_launch"] for r in mine],
            "k1_ms": [r["k1_ms"] for r in mine],
            "k6_ms": [r["k6_ms"] for r in mine],
            "depth_wall_s": [r["depth_wall_s"] for r in mine],
            "depth_profiled": [[r["depth_profiled"]["wall_s"], r["depth_profiled"]["device_ms"]]
                               for r in mine]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:  # the tree's root, not this file's folder, on the path
        sys.path[0] = sys.argv[sys.argv.index("--child") + 1]
    sys.exit(main())
