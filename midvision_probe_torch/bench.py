"""Headline benchmark of the PyTorch port (counterpart of the repository's
root ``bench.py``): ViT-B/16 dense multilayer feature extraction, images
per second per card.

The frozen backbone forward is the hot op of every probing pipeline (probe
training and the correspondence evaluations all start from it). Protocol:
DINO ViT-B/16 at NYU's 480x640 (a 30x40 patch grid and the cls token, N =
1201), its 4 multilayer taps, bfloat16, the forward as the probe trainers
consume it (its attention on kernel K1), each map cast to float32.

Usage::

    python -m midvision_probe_torch.bench                 # on the card
    MVP_BENCH_BACKBONE=deit3_vitb16 MVP_BENCH_BATCH=32 python -m midvision_probe_torch.bench
    python -m midvision_probe_torch.bench --device cpu    # the CPU's time

``$MVP_BENCH_BACKBONE`` (default ``dino_vitb16``) names another ViT of the
zoo; ``$MVP_BENCH_BATCH`` (default 64) sets the batch. Before building
anything, the card is checked in a bounded process (one tiny launch): if
it does not answer, the reason goes to stderr and the exit code is 2.
Without a card and without ``--device cpu`` it raises.

Prints ONE JSON line: ``metric``, ``value`` (images/s on the one card the
forward ran on), ``unit`` and ``vs_baseline``, the value over an estimated
250 images/s of the reference's float32 single-GPU pipeline (the reference
publishes no throughput; the estimate is not a measurement).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from midvision_probe_torch.launch.suite_run import probe_backend
from midvision_probe_torch.launch.sweep import require_device
from midvision_probe_torch.models import zoo

BASELINE_IMGS_PER_SEC = 250.0
HEADLINE = "dino_vitb16"
# the protocol's image size and timed calls (a CPU test shrinks them)
IMAGE_HW = (480, 640)
N_ITERS = 20


def metric_name(name: str) -> str:
    """The headline keeps its historical key; another backbone's key carries
    its full zoo name, so no override can shadow the protocol metric."""
    if name == HEADLINE:
        return "vitb16_dense_multilayer_imgs_per_sec_per_chip"
    return f"{name}_dense_multilayer_imgs_per_sec_per_chip"


def build_backbone(name: str, device) -> zoo.FeatureExtractor:
    """The dense 4-tap bf16 extractor of the zoo ViT ``name``."""
    vits = sorted(n for n, e in zoo.ZOO.items() if e.vit is not None)
    if name not in vits:
        raise ValueError(f"bench: {name!r} is not a ViT of the zoo; the bench times one "
                         f"of {vits}")
    return zoo.build_vit_extractor(name, output="dense", return_multilayer=True,
                                   dtype=torch.bfloat16, init_size=224, device=device)


def forward(backbone, images: torch.Tensor):
    """The timed forward: the four maps cast to float32 (what feature
    consumers read) and the checksum of the last map's first pixel, whose
    read waits for the whole computation."""
    maps = [m.float() for m in backbone.features(images)]
    return maps, maps[-1][0, 0, 0].sum()


def run(name: str, batch: int, device) -> dict:
    """Build ``name``, time ``N_ITERS`` forwards of a seeded batch after one
    warm-up, and return the JSON line's fields."""
    backbone = build_backbone(name, device)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.randn(batch, *IMAGE_HW, 3).astype(np.float32)).to(backbone.device)

    _, chk = forward(backbone, images)
    float(chk)
    t0 = time.perf_counter()
    for _ in range(N_ITERS):
        _, chk = forward(backbone, images)
    float(chk)  # one host read drains every queued forward
    dt = time.perf_counter() - t0

    # the forward runs on one card, so its rate is the rate per card
    value = round(batch * N_ITERS / dt, 2)
    return {"metric": metric_name(name), "value": value, "unit": "imgs/sec/chip",
            "vs_baseline": round(value / BASELINE_IMGS_PER_SEC, 3)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cpu runs on the CPU")
    args = ap.parse_args(argv)
    require_device(args.device)
    if args.device != "cpu":
        ok, why = probe_backend()
        if not ok:
            print(f"bench preflight: {why}", file=sys.stderr)
            raise SystemExit(2)
    name = os.environ.get("MVP_BENCH_BACKBONE", HEADLINE)
    batch = int(os.environ.get("MVP_BENCH_BATCH", "64"))
    line = run(name, batch, args.device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
