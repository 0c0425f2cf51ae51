"""Cache-shuffle A/B: the accuracy cost of the feature cache's fixed batch
COMPOSITION against the reference's full per-epoch sample reshuffle
(``sampler.set_epoch``, reference ``train_depth.py:94-95``); counterpart of
the repository's ``launch_script/shuffle_ab.py``.

Arms (same data, probe and schedule; one run a seed each):

  * cache+order-shuffle: ``system.cache_features=true``, the batches'
    composition frozen (the cache's key), their ORDER permuted each epoch
    (``engine/driver_common.cache_shuffle_kwargs``);
  * full-shuffle: no cache, the samples reshuffled every epoch.

Runs the port's ``train_depth`` in this process on synthetic depth data,
on the card unless ``--device cpu``, and writes a markdown table of the
per-seed sa_d1 and si_d1, their means and the mean deltas.

Usage::

    python -m midvision_probe_torch.launch.shuffle_ab --seeds 0 1
    python -m midvision_probe_torch.launch.shuffle_ab --device cpu --instances 32 \\
        --size 32 --epochs one_epoch --seeds 0
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from midvision_probe_torch.launch.fast_preset_ab import run_depth
from midvision_probe_torch.launch.suite_run import card_name
from midvision_probe_torch.launch.sweep import require_device

ARMS = {"cache+order-shuffle": ["system.cache_features=true"],
        "full-shuffle": ["system.cache_features=false"]}


def main(argv=None) -> dict:
    """Run both arms for every seed and write the table; returns
    ``{arm: [row per seed]}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", default="test_tiny")
    ap.add_argument("--instances", type=int, default=256)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--epochs", default="ten_epoch")
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--out", default="logs/suite_torch/shuffle_ab.md")
    ap.add_argument("--work-dir", default=tempfile.gettempdir(),
                    help="where each run's driver output goes (shuffle_ab_<seed>_<arm>)")
    ap.add_argument("--device", default="cuda", help="cpu runs on the CPU")
    args = ap.parse_args(argv)
    require_device(args.device)

    rows = {name: [] for name in ARMS}
    for seed in args.seeds:
        for name, extra in ARMS.items():
            overrides = [
                f"backbone={args.backbone}", "dataset=synthetic",
                f"dataset.num_instances={args.instances}",
                f"dataset.image_size=[{args.size},{args.size}]",
                "probe=depth_linear", f"optimizer={args.epochs}",
                "batch_size=32", f"system.random_seed={seed}",
                "wandb.use=False", "+render_images=False", *extra,
                f"+system.device={args.device}",
            ]
            out_dir = os.path.join(args.work_dir, f"shuffle_ab_{seed}_{name.split('+')[0]}")
            t0 = time.time()
            row = run_depth(overrides, out_dir)
            rows[name].append(row)
            print(f"[ab] seed {seed} {name}: sa_d1={row['sa_d1']:.4f} "
                  f"si_d1={row['si_d1']:.4f} ({time.time() - t0:.0f}s)", flush=True)

    def mean(name, key):
        vals = [r[key] for r in rows[name]]
        return sum(vals) / len(vals)

    lines = [
        "# Cache-shuffle A/B — fixed batch composition vs full reshuffle",
        "",
        f"backbone {args.backbone} (random init), synthetic depth "
        f"{args.instances} imgs @ {args.size}², linear probe, "
        f"{args.epochs}, batch 32, seeds {args.seeds}, on {card_name(args.device)}, "
        "the port's `train_depth` driver.",
        "",
        "| arm | " + " | ".join(f"seed{s} sa_d1" for s in args.seeds) +
        " | mean sa_d1 | mean si_d1 |",
        "|---|" + "---|" * (len(args.seeds) + 2),
    ]
    for name in ARMS:
        per_seed = " | ".join(f"{r['sa_d1']:.4f}" for r in rows[name])
        lines.append(f"| {name} | {per_seed} | {mean(name, 'sa_d1'):.4f} "
                     f"| {mean(name, 'si_d1'):.4f} |")
    d_sa = mean("cache+order-shuffle", "sa_d1") - mean("full-shuffle", "sa_d1")
    d_si = mean("cache+order-shuffle", "si_d1") - mean("full-shuffle", "si_d1")
    spread = max(abs(a["sa_d1"] - b["sa_d1"]) for a, b in
                 zip(rows["cache+order-shuffle"], rows["full-shuffle"]))
    lines += [
        "",
        f"mean delta (cache − full-shuffle): sa_d1 {d_sa:+.4f}, "
        f"si_d1 {d_si:+.4f}; max per-seed |Δsa_d1| {spread:.4f}.",
        "",
        "Caveat: random-init backbone + synthetic data — the measurement "
        "isolates the optimizer-trajectory effect of batch-composition "
        "freezing, which is the only thing the cache changes (identical "
        "model, loss, schedule, data).",
    ]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
