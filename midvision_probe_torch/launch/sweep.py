"""Backbone-sweep launcher of the PyTorch port (counterpart of the
repository's ``launch_script/sweep.py``, which replaces the reference's
submitit SLURM scripts).

One driver process of the port per backbone, sequential or ``--parallel
N`` at a time, each with its log under ``<log-dir>/<task>/``. The default
model list is the reference's depth-sweep list (``launch_depth.py:22-51``).
Every cell runs on ``--device`` (default ``cuda``, passed to the driver as
``+system.device=``); without a card and without ``--device cpu`` the
launcher raises once, before any cell runs. On the card the CUDA kernels
are built once, before the first cell, so no cell pays ``nvcc`` and
parallel cells do not all compile.

Usage::

    python -m midvision_probe_torch.launch.sweep --task depth --models dino_b16 mae_b16
    python -m midvision_probe_torch.launch.sweep --task snorm            # full list
    python -m midvision_probe_torch.launch.sweep --task depth --extra dataset=navi_reldepth
    python -m midvision_probe_torch.launch.sweep --task depth --models test_tiny --device cpu
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# reference launch_depth.py:22-51
DEFAULT_MODELS = [
    "mocov3_resnet50", "crocov2_b16", "croco_b16", "barlowtwins_resnet50",
    "beit-v2_vitb16", "byol_resnet50", "clusterfit_resnet50",
    "deepcluster-v2-resnet50", "densecl_resnet50", "dino_b16", "eva_vitb16",
    "ibot_b16", "jigsaw_resnet50", "mae_b16", "maskfeat_vitb16",
    "milan_vitb16", "mocov2_resnet50", "mocov3_b14", "npid-plusplus_resnet50",
    "pirl_resnet50", "pixmlm_vitb16", "rotnet_resnet50", "simsiam_resnet50",
    "sela-v2_resnet50", "simclr_resnet50", "swav_resnet50", "npid_resnet50",
    "dino_resnet50",
]

DRIVERS = {
    "depth": "midvision_probe_torch.train_depth",
    "snorm": "midvision_probe_torch.train_snorm",
    "objectness": "midvision_probe_torch.train_generic_objectness",
    "taskonomy": "midvision_probe_torch.train_taskonomy",
    "spair": "midvision_probe_torch.evaluate_spair_correspondence",
    "navi": "midvision_probe_torch.evaluate_navi_correspondence",
    "scannet": "midvision_probe_torch.render_scannet_correspondence",
    "percepture": "midvision_probe_torch.evaluate_model_percepture",
    "maskcut": "midvision_probe_torch.evaluate_generic_objectness",
}


def subprocess_env() -> dict:
    """Environment of the driver processes, with the synthetic sets' shared
    disk tier (``datasets/synthetic.py``): every cell is its own process,
    so without it each one regenerates the identical synthetic data. Shared
    by sweep and suite_run so the two launchers' paths cannot drift apart.
    (The JAX launcher also shares XLA's persistent compile cache here; the
    port compiles no programs per cell, and its CUDA kernels are built once
    by ``build_kernels``.)"""
    env = dict(os.environ)
    env.setdefault("MVP_SYNTH_DISK_CACHE",
                   os.path.join(tempfile.gettempdir(), "mvp_synth_cache"))
    return env


def require_device(device: str) -> None:
    """Raise unless ``device`` can run: a CUDA device needs a visible card
    (the cells never fall back to the CPU)."""
    if device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the launcher runs every cell on the card by "
                "default; pass --device cpu to run the cells on the CPU")


def build_kernels(device: str) -> float | None:
    """Build the CUDA kernels' libraries once, before the first cell (every
    cell then loads them from ``build/``); the seconds it took, or None on
    the CPU, where no kernel is built."""
    if not device.startswith("cuda"):
        return None
    from midvision_probe_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="depth", choices=sorted(DRIVERS))
    ap.add_argument("--models", nargs="*", default=None)
    ap.add_argument("--extra", nargs="*", default=[],
                    help="extra key=value overrides for every run")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--log-dir", default="logs/sweep_torch")
    ap.add_argument("--device", default="cuda",
                    help="device of every cell (+system.device=); cpu runs on the CPU")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--parallel", type=int, default=1, metavar="N",
                    help="run N driver processes concurrently (on one card they "
                         "share it)")
    ap.add_argument("--no-fast", action="store_true",
                    help="disable the fast-suite defaults "
                         "(system.cache_features + bfloat16 backbone)")
    args = ap.parse_args(argv)

    models = args.models or DEFAULT_MODELS
    driver = DRIVERS[args.task]
    if not args.dry_run:
        require_device(args.device)
        build_s = build_kernels(args.device)
        if build_s is not None:
            print(f"[sweep] CUDA kernels built in {build_s:.1f}s", flush=True)
    os.makedirs(os.path.join(args.log_dir, args.task), exist_ok=True)

    def run_one(model: str, idx: int = 0):
        tag = model if models.count(model) == 1 else f"{model}.{idx}"
        overrides = [f"backbone={model}"]
        if args.task in ("depth", "snorm", "taskonomy"):
            overrides += ["+backbone.return_multilayer=True",
                          f"system.random_seed={args.seed}"]
            if not args.no_fast:
                # the fast-suite levers: extract frozen features once per
                # epoch-0 batch and reuse them; bf16 backbone and probe
                overrides += ["system.cache_features=true",
                              "system.backbone_dtype=bfloat16",
                              "system.probe_dtype=bfloat16"]
        overrides += list(args.extra) + [f"+system.device={args.device}"]
        cmd = [sys.executable, "-m", driver] + overrides
        log_path = os.path.join(args.log_dir, args.task, f"{tag}.log")
        print(f"[sweep] {' '.join(cmd)} -> {log_path}", flush=True)
        if args.dry_run:
            return model, 0, 0.0
        t0 = time.time()
        with open(log_path, "w") as log:
            ret = subprocess.call(cmd, stdout=log, stderr=subprocess.STDOUT,
                                  env=subprocess_env(), cwd=REPO)
        dt = time.time() - t0
        status = "ok" if ret == 0 else f"FAILED ({ret})"
        print(f"[sweep] {model}: {status} in {dt:.0f}s", flush=True)
        return model, ret, dt

    t_suite = time.time()
    if args.parallel > 1:
        with ThreadPoolExecutor(max_workers=args.parallel) as pool:
            results = list(pool.map(run_one, models, range(len(models))))
    else:
        results = [run_one(m, i) for i, m in enumerate(models)]

    failures = [m for m, ret, _ in results if ret != 0]
    if not args.dry_run:
        print(f"[sweep] suite wall-clock: {time.time() - t_suite:.0f}s "
              f"({len(models)} models, parallel={args.parallel})")
    if failures:
        print(f"[sweep] {len(failures)} failures: {failures}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
