"""Suite-preset A/B: the cost/accuracy space between the paper's DPT
protocol and the linear fast preset (counterpart of the repository's
``launch_script/fast_preset_ab.py``).

Each arm runs the port's ``train_depth`` in this process on identical
synthetic data (same seed, the sweep's feature cache and bf16 backbone and
probe):

  * protocol-dpt    probe=depth_dpt (k=3, bindepth), 10 epochs: the paper
  * multiscale-k1   probe=depth_multiscale (kernel 1), 10 epochs
  * dpt-3ep         probe=depth_dpt, three_epoch: a shorter schedule
  * dpt-240, dpt-240-3ep, dpt-320-3ep, dpt-160, dpt-240-hd256,
    dpt-160-hd256, dpt-192-hd256
                    probe=depth_dpt TRAINED at a reduced size, then
                    EVALUATED at ``--size``: the probe is fully
                    convolutional, so the newest checkpoint reloads through
                    the driver's eval-only path (``+is_eval +ckpt_path``,
                    ``suite_run.reload_at_size``, the suite's two-phase cell)
  * fast-linear     probe=depth_linear (k=1), 10 epochs

For each arm the report records d1 and rmse and a suite projection: the
arm's probe-step and extraction times on the card
(``time_suite.measure_backbone`` at the arm's training size, batch 32)
times the reference suite's geometry (757 steps an epoch x 2 trained tasks
x 20 backbones, one cached extraction pass), divided over ``--cards`` cards
(a data-parallel projection, not a measurement), marking the arms that
meet < 1 h.

Rows persist to ``fast_preset_ab_rows.jsonl`` beside ``--out``, keyed by
the run's configuration, so an interrupted A/B resumes (``--rerun`` runs
every arm again).

Synthetic data and a random-init backbone measure the protocol's
sensitivity in the pipeline, not paper-table accuracy; with real weights
the same commands run the A/B on NYU.

Usage::

    python -m midvision_probe_torch.launch.fast_preset_ab --arms protocol-dpt fast-linear
    python -m midvision_probe_torch.launch.fast_preset_ab --device cpu --backbone test_tiny \\
        --instances 32 --size 64 --arms dpt-160
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from midvision_probe_torch.launch.suite_run import card_name, reload_at_size
from midvision_probe_torch.launch.sweep import require_device
from midvision_probe_torch.launch import time_suite

# (arm name, probe config, optimizer config, measure_backbone head_type,
#  train size (None trains at the eval size), DPT hidden_dim)
ARMS = [
    ("protocol-dpt", "depth_dpt", "ten_epoch", "dpt", None, 512),
    ("multiscale-k1", "depth_multiscale", "ten_epoch", "multiscale",
     None, 512),
    ("dpt-3ep", "depth_dpt", "three_epoch", "dpt", None, 512),
    ("dpt-240", "depth_dpt", "ten_epoch", "dpt", 240, 512),
    ("dpt-240-3ep", "depth_dpt", "three_epoch", "dpt", 240, 512),
    ("dpt-320-3ep", "depth_dpt", "three_epoch", "dpt", 320, 512),
    ("dpt-160", "depth_dpt", "ten_epoch", "dpt", 160, 512),
    ("dpt-240-hd256", "depth_dpt", "ten_epoch", "dpt", 240, 256),
    ("dpt-160-hd256", "depth_dpt", "ten_epoch", "dpt", 160, 256),
    ("dpt-192-hd256", "depth_dpt", "ten_epoch", "dpt", 192, 256),
    ("fast-linear", "depth_linear", "ten_epoch", "linear", None, 512),
]
N_EPOCHS = {"ten_epoch": 10, "three_epoch": 3, "fifteen_epoch": 15, "one_epoch": 1}

# reference suite geometry: time_suite's, over the trained-probe tasks
TASKS, BACKBONES = 2, time_suite.N_BACKBONES
ROWS_FILE = "fast_preset_ab_rows.jsonl"


def project_suite_hours(step_s: float, n_epochs: int, extract_s: float,
                        cards: int = 4) -> float:
    """Wall hours of the trained-probe suite under a preset on ``cards``
    cards, one backbone a card: the probe steps of ``n_epochs`` epochs and
    one cached extraction pass per task (the JAX script's geometry, with
    the extraction time measured, not fixed)."""
    steps = time_suite.STEPS_PER_EPOCH
    per_bb = steps * n_epochs * step_s * TASKS + steps * extract_s * TASKS
    return per_bb * BACKBONES / cards / 3600


def arm_overrides(args, probe: str, epochs: str, hidden_dim: int, size: int) -> list:
    return [
        f"backbone={args.backbone}", "dataset=synthetic",
        f"dataset.num_instances={args.instances}",
        f"dataset.image_size=[{size},{size}]",
        f"probe={probe}", f"optimizer={epochs}",
        f"probe.hidden_dim={hidden_dim}",
        "batch_size=32", "+backbone.return_multilayer=True",
        "system.cache_features=true",
        "system.backbone_dtype=bfloat16",
        "system.probe_dtype=bfloat16",
        "wandb.use=False", "+render_images=False",
        f"+system.device={args.device}",
    ]


def run_depth(overrides: list, out_dir: str) -> dict:
    """``train_depth`` in this process; the CSV row's metrics."""
    from midvision_probe_torch import train_depth
    from midvision_probe_torch.config import compose

    row = train_depth.run(compose("depth_training", overrides + [f"output_dir={out_dir}"]))
    return {k: float(v) for k, v in row.items() if k != "train_losses"}


def main(argv=None) -> list:
    """Run the arms and write the report; returns the rows as dicts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", default="dino_b16")
    ap.add_argument("--instances", type=int, default=256)
    ap.add_argument("--size", type=int, default=480)
    ap.add_argument("--arms", nargs="*", default=None,
                    help="subset of arm names to run")
    ap.add_argument("--base-d1", type=float, default=None,
                    help="protocol-dpt sa_d1 from an earlier partial run, "
                         "for the delta column when that arm is skipped")
    ap.add_argument("--out", default="logs/suite_torch/fast_preset_ab.md")
    ap.add_argument("--rerun", action="store_true",
                    help="ignore persisted rows and rerun every arm")
    ap.add_argument("--cards", type=int, default=4,
                    help="cards of the data-parallel suite projection")
    ap.add_argument("--work-dir", default=tempfile.gettempdir(),
                    help="where each arm's driver output goes (fast_ab_<arm>)")
    ap.add_argument("--device", default="cuda", help="cpu runs on the CPU")
    args = ap.parse_args(argv)
    if args.arms:
        unknown = set(args.arms) - {a[0] for a in ARMS}
        if unknown:
            ap.error(f"unknown arm(s) {sorted(unknown)}; "
                     f"choose from {[a[0] for a in ARMS]}")
    require_device(args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    args.card, args.label = card_name(args.device), card_name(args.device, short=True)

    from midvision_probe_torch.config import compose

    arms = [a for a in ARMS if args.arms is None or a[0] in args.arms]
    # rows are valid only for the configuration they were measured under
    rows_path = os.path.join(os.path.dirname(args.out) or ".", ROWS_FILE)
    run_cfg = {"backbone": args.backbone, "instances": args.instances,
               "size": args.size, "device": args.device}
    done: dict = {}
    if os.path.exists(rows_path) and not args.rerun:
        with open(rows_path) as f:
            for line in f:
                d = json.loads(line)
                if d.get("run_cfg") == run_cfg:
                    done[d["preset"]] = d
                else:
                    print(f"[ab] ignoring cached row for {d['preset']} "
                          f"(measured under {d.get('run_cfg')}, "
                          f"this run is {run_cfg})", flush=True)

    rows = []
    for preset, probe, epochs, head_type, train_size, hidden_dim in arms:
        ts = train_size or args.size
        if preset in done:
            d = done[preset]
            rows.append(d)
            print(f"[ab] {preset}: cached row (rerun with --rerun)", flush=True)
            _write_report(rows, args)
            continue

        outdir = os.path.join(args.work_dir, f"fast_ab_{preset}")
        overrides = arm_overrides(args, probe, epochs, hidden_dim, ts)
        t0 = time.time()
        metrics = run_depth(overrides, outdir)
        eval_dir = None
        if train_size is not None:
            # reduced-size arm: the metric that counts is at the protocol
            # size, from the trained probe reloaded there
            eval_overrides = reload_at_size(overrides, outdir, args.size)
            if eval_overrides is None:
                raise FileNotFoundError(f"no checkpoint under {outdir}")
            eval_dir = f"{outdir}_eval{args.size}"
            metrics = run_depth(eval_overrides, eval_dir)
        dt = time.time() - t0
        # launcher aliases (dino_b16) -> zoo names (dino_vitb16)
        zoo_name = compose("depth_training", [f"backbone={args.backbone}"]
                           ).backbone.get("checkpoint_name", "dino_vitb16")
        t_extract, t_probe, _ = time_suite.measure_backbone(
            zoo_name, 32, (ts, ts), head_type=head_type, probe_dtype="bfloat16",
            hidden_dim=hidden_dim, device=args.device)
        proj_h = project_suite_hours(t_probe, N_EPOCHS[epochs], t_extract, args.cards)
        row = {"preset": preset, "train_size": ts, "run_cfg": run_cfg, "metrics": metrics,
               "wall_s": round(dt, 1), "step_s": t_probe, "extract_s": t_extract,
               "suite_h": proj_h, "eval_dir": eval_dir}
        rows.append(row)
        with open(rows_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(f"[ab] {preset}: train@{ts} sa_d1={metrics['sa_d1']:.4f} "
              f"si_d1={metrics['si_d1']:.4f} sa_rmse={metrics['sa_rmse']:.4f} "
              f"step {t_probe*1e3:.1f} ms  suite {proj_h:.2f} h "
              f"({dt:.0f}s)", flush=True)
        _write_report(rows, args)

    _write_report(rows, args)
    return rows


def _write_report(rows, args):
    if not rows:
        print("[ab] no arms ran — nothing to report", flush=True)
        return
    base = next((r for r in rows if r["preset"] == "protocol-dpt"), None)
    if base is not None:
        base_d1, base_name = base["metrics"]["sa_d1"], "protocol"
    elif args.base_d1 is not None:
        base_d1, base_name = args.base_d1, "protocol (--base-d1)"
    else:
        # no protocol arm in this subset and no --base-d1: the delta column
        # is against the first arm, and says so
        base_d1, base_name = rows[0]["metrics"]["sa_d1"], rows[0]["preset"]
    fleet = f"{args.cards} × {args.label}"
    lines = [
        "# Suite-preset A/B — the space between paper DPT and fast linear",
        "",
        f"backbone {args.backbone} (random init unless its checkpoint is under "
        f"$MVP_CHECKPOINT_DIR), synthetic depth {args.instances} imgs, "
        f"EVAL always @ {args.size}² (reduced-res arms train low, restore "
        "the fully-conv probe, eval at protocol res), identical data/seed, "
        f"on {args.card}, the port's `train_depth` driver with cache_features+bf16 "
        "(the sweep defaults). Suite projection: (probe step x 757 steps/ep + one "
        f"extraction pass) x 2 trained tasks x 20 backbones over {fleet}, "
        "the step and extraction times measured at the arm's training size.",
        "",
        "| preset | train res | sa_d1 | si_d1 | sa_rmse | si_rmse | "
        f"probe step ms | {fleet} suite h | <1 h | δ1 vs {base_name} |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for row in rows:
        r, proj_h = row["metrics"], row["suite_h"]
        met = "**MET**" if proj_h < 1.0 else "not met"
        lines.append(
            f"| {row['preset']} | {row['train_size']}² | {r['sa_d1']:.4f} | "
            f"{r['si_d1']:.4f} | {r['sa_rmse']:.4f} | {r['si_rmse']:.4f} | "
            f"{row['step_s']*1e3:.1f} | {proj_h:.2f} | {met} | "
            f"sa {r['sa_d1']-base_d1:+.4f} |")
    lines += [
        "",
        "SPair PCK / NAVI / ScanNet / 2AFC are unaffected by the preset "
        "(training-free evals on the same frozen features). The preset "
        "changes only the trained-probe decoder; with real checkpoints the "
        "same commands run this A/B on NYU.",
        "",
        "## Findings",
        "",
    ] + _findings(rows, base_d1, base_name, fleet)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fo:
        fo.write("\n".join(lines) + "\n")


def _findings(rows, base_d1, base_name, fleet):
    """Findings from what this run measured, never from another run."""
    out = []
    ep3 = [(r["preset"], r["metrics"]["sa_d1"] - base_d1) for r in rows
           if r["preset"].endswith("-3ep") or r["preset"] == "dpt-3ep"]
    if ep3 and base_name.startswith("protocol"):
        lo = min(d for _, d in ep3)
        hi = max(d for _, d in ep3)
        out.append(f"- Shortened schedules cost δ1 {lo:+.4f}..{hi:+.4f} "
                   f"across {len(ep3)} 3-epoch arm(s).")
    met = [(r["preset"], r["suite_h"], r["metrics"]["sa_d1"] - base_d1)
           for r in rows if r["suite_h"] < 1.0]
    if met:
        best = min(met, key=lambda x: abs(x[2]))
        out.append(
            f"- {len(met)} arm(s) meet <1 h on {fleet}; smallest accuracy "
            f"trade: `{best[0]}` at {best[1]:.2f} h, "
            f"δ1 {best[2]:+.4f} vs {base_name}.")
    else:
        out.append(f"- No arm in this run meets <1 h on {fleet}.")
    return out


if __name__ == "__main__":
    main()
