"""Per-family performance regression matrix of the PyTorch port (counterpart
of the repository's ``launch_script/bench_matrix.py``).

``midvision_probe_torch.bench`` tracks one configuration (the ViT-B dense
extraction); the cost of a probing suite spans several. This tool measures
the set on the card, writes one JSON artifact a run and FAILS (rc 1) when a
row regresses beyond tolerance of the stored expectations, so a change that
slows a family other than the headline's is caught when it lands.

Rows (key, configuration), every backbone in bf16 with seeded random
weights unless ``$MVP_CHECKPOINT_DIR`` holds its file:
  * vitb16_extract      dino_vitb16 dense 4-tap, batch 64 @480x640 (the
                        bench protocol; attention on K1)
  * resnet50_extract    simclr_resnet50 stages [1-4], batch 64 @480x480
  * sam_vitb_extract    sam_vit_b windowed ViTDet 4-tap, batch 16 @480x480
  * convnextb_extract   cnxt_b_in22k 4 stages, batch 64 @480x480
  * vitb16_dpt_step     the full train step (extraction + DPT probe +
                        AdamW), batch 32 @480x480, ms
  * vitb16_linear_step  the probe step of the linear probe on cached
                        features, batch 32 @480x480, ms

Extraction rows are images/s (``utils/profiling.time_fn``: one warm-up
call, then 10 calls, each waited for); the step rows are
``launch/time_suite.py::measure_backbone``'s. Every extractor is built by
its family's builder (``zoo.build_{vit,resnet,sam,convnext}_extractor``).

Usage::

    python -m midvision_probe_torch.launch.bench_matrix             # measure + check
    python -m midvision_probe_torch.launch.bench_matrix --update    # rewrite expected
    python -m midvision_probe_torch.launch.bench_matrix --rows vitb16_extract sam_vitb_extract
    python -m midvision_probe_torch.launch.bench_matrix --device cpu --out /tmp/m.json

Expectations live in ``bench_matrix_expected.json`` beside this file,
written on the card; its ``_meta`` names the card and its power limit. A
run with no expectations file writes one and passes; ``--update`` merges
the measured rows into it. Tolerance: ±15% of each expected value, and
only a regression fails (a faster extraction or a shorter step never does).
Without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from midvision_probe_torch.launch.suite_run import card_name
from midvision_probe_torch.launch.sweep import require_device
from midvision_probe_torch.launch.time_suite import measure_backbone
from midvision_probe_torch.models import zoo
from midvision_probe_torch.utils.profiling import time_fn

EXPECTED_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "bench_matrix_expected.json")

TOLERANCE = 0.15  # fraction of expected, both directions

# extraction rows: key -> (zoo name, batch, (h, w)); images/s
EXTRACT_ROWS = {
    "vitb16_extract": ("dino_vitb16", 64, (480, 640)),
    "resnet50_extract": ("simclr_resnet50", 64, (480, 480)),
    "sam_vitb_extract": ("sam_vit_b", 16, (480, 480)),
    "convnextb_extract": ("cnxt_b_in22k", 64, (480, 480)),
}
# step rows: key -> (zoo name, batch, (h, w), probe head); ms, lower is better
STEP_ROWS = {
    "vitb16_dpt_step": ("dino_vitb16", 32, (480, 480), "dpt"),
    "vitb16_linear_step": ("dino_vitb16", 32, (480, 480), "linear"),
}
EXTRACT_ITERS = 10


def build_extractor(name: str, device):
    """The 4-tap bf16 extractor of zoo entry ``name``, by its family's
    builder (a ResNet's stages [1-4], as the reference's backbone configs
    pick for probing)."""
    arch = zoo.ZOO[name].arch
    kw = {"return_multilayer": True, "dtype": torch.bfloat16, "device": device}
    if arch == "resnet":
        return zoo.build_resnet_extractor(name, return_layers=[1, 2, 3, 4], **kw)
    if arch == "sam":
        return zoo.build_sam_extractor(name, **kw)
    if arch == "convnext":
        return zoo.build_convnext_extractor(name, **kw)
    return zoo.build_vit_extractor(name, init_size=224, **kw)


def extract_imgs_per_sec(name: str, batch: int, hw, device) -> float:
    bb = build_extractor(name, device)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(batch, *hw, 3).astype(np.float32)).to(bb.device)
    t = time_fn(lambda im: [m.float() for m in bb.features(im)], images,
                warmup=1, iters=EXTRACT_ITERS)
    return batch / (t["mean_ms"] / 1e3)


def measure(rows=None, device="cuda") -> dict:
    out = {}

    def want(key):
        return rows is None or key in rows

    for key, (name, batch, hw) in EXTRACT_ROWS.items():
        if want(key):
            out[key] = {"value": round(extract_imgs_per_sec(name, batch, hw, device), 1),
                        "unit": "imgs/s"}
    # the full step (uncached) and the probe step (cached): the two anchors
    # of the suite's projection (launch/time_suite.py)
    for key, (name, batch, hw, head) in STEP_ROWS.items():
        if want(key):
            _, t_probe, t_full = measure_backbone(name, batch, hw, head_type=head,
                                                  probe_dtype="bfloat16", device=device)
            ms, digits = (t_full, 1) if head == "dpt" else (t_probe, 2)
            out[key] = {"value": round(ms * 1e3, digits), "unit": "ms",
                        "lower_is_better": True}
    return out


def check(measured: dict, expected: dict, rows=None) -> list[str]:
    failures = []
    for key, exp in expected.items():
        if key.startswith("_"):
            continue  # _meta: where and when the expectations were taken
        if rows is not None and key not in rows:
            continue  # --rows subset: unrequested keys are not failures
        if key not in measured:
            failures.append(f"{key}: not measured")
            continue
        got, want = measured[key]["value"], exp["value"]
        lo, hi = want * (1 - TOLERANCE), want * (1 + TOLERANCE)
        # regressions only: faster extract (higher) / faster step (lower)
        # never fails
        if exp.get("lower_is_better"):
            ok = got <= hi
        else:
            ok = got >= lo
        status = "ok" if ok else "REGRESSED"
        print(f"  {key:22s} {got:>10} {exp['unit']}  "
              f"(expected {want}, bounds [{lo:.1f}, {hi:.1f}]) {status}")
        if not ok:
            failures.append(f"{key}: {got} vs expected {want} (±15%)")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="JSON artifact path (default logs/bench_torch/bench_matrix_"
                         "<timestamp>.json)")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the expected file from this run")
    ap.add_argument("--rows", nargs="*", default=None,
                    help="subset of row keys to measure")
    ap.add_argument("--device", default="cuda", help="cpu runs on the CPU")
    args = ap.parse_args(argv)
    require_device(args.device)

    t0 = time.time()
    measured = measure(args.rows, args.device)
    measured["_meta"] = {
        "device": args.device,
        "card": card_name(args.device),
        "wall_s": round(time.time() - t0, 1),
        "date": time.strftime("%Y-%m-%d %H:%M"),
    }

    out_path = args.out or os.path.join(
        "logs", "bench_torch", f"bench_matrix_{time.strftime('%Y%m%d-%H%M')}.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(measured, f, indent=1)
    print(f"[bench_matrix] wrote {out_path}")

    if args.update or not os.path.exists(EXPECTED_PATH):
        # merge into the existing expectations so a --rows subset update
        # refreshes only the measured keys instead of deleting every other
        # family's regression baseline; _meta names this run
        expected = {}
        if os.path.exists(EXPECTED_PATH):
            with open(EXPECTED_PATH) as f:
                expected = json.load(f)
        expected.update(measured)
        with open(EXPECTED_PATH, "w") as f:
            json.dump(expected, f, indent=1)
        print(f"[bench_matrix] expectations written to {EXPECTED_PATH}")
        return 0

    with open(EXPECTED_PATH) as f:
        expected = json.load(f)
    failures = check(measured, expected, rows=args.rows)
    if failures:
        print(f"[bench_matrix] {len(failures)} regression(s): {failures}")
        return 1
    print("[bench_matrix] all rows within tolerance")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
