"""Read the numbers that set a cell's comparison limits, on the card, at
the cell's own size, in one process:

* the program on ``--seeds`` (the lower readings: the largest of sound
  runs);
* each of the loop's controls (``CONTROLS`` in ``loops/<loop>.py``) on
  ``--control-seeds``, one part at a time one precision below the
  configuration's: ``control_taps``, the bfloat16 backbone's taps as the
  reference's computed in float8 (e4m3, one scale a tensor) in the
  program's place; for a training loop ``control_probe``, the float32
  probe run on the program's own bfloat16 path (``probe_dtype``);
* the loop's faults (``FAULTS``) planted in the program on
  ``--fault-seeds``: for training, half of each batch left out of the
  loss (its mean over the rest), and the first image's prediction altered
  where it is produced. A step that leaves its state unchanged reads 1 on
  ``delta_gap`` by construction and needs no run.

Each run drives the cell's set-up and a window of ``--seconds`` at the
cell's load, then the same check as ``benchmark.run``, and is judged
against the cell's committed limits (``correct``). Usage::

    python3 -m benchmark.calibrate --workload dino_b16.train_dpt \\
        --seeds 1,2,3 --control-seeds 4,5,6 --fault-seeds 7,8,9 \\
        --seconds 3 --out calibrate_dino_b16.train_dpt.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import manifest, run


def one(cfg, mix, seed, seconds, device, mode: str, limits=None) -> dict:
    """One run of ``mode`` (``program``, a control or a fault of the
    mix's loop): its readings and, against ``limits``, its verdict."""
    import torch

    from benchmark import check
    loop = manifest.loop(mix["loop"])
    plan = {"program": {}, **loop.CONTROLS, **loop.FAULTS}[mode]
    t0 = time.time()
    session = loop.Session(cfg, mix, seed, device, **plan.get("session", {}))
    stats = session.window(seconds)
    session.release()
    readings = session.check(**plan.get("check", {}))
    del session
    if device.type == "cuda":
        torch.cuda.empty_cache()
    row = {"mode": mode, "seed": seed, "steps": stats["steps"], "readings": readings,
           "seconds": time.time() - t0}
    if limits is not None:
        row["correct"] = check.verdict(readings, limits)[0]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    run.set_environment()
    import torch

    m = manifest.load()
    cell = manifest.cell(m, args.workload)
    cfg, mix = manifest.config(m, cell["config"]), manifest.mix(cell["traffic"])
    device = torch.device("cuda", 0)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    loop = manifest.loop(mix["loop"])
    limits = manifest.limits(args.workload)
    plan = [(s, "program") for s in seeds(args.seeds)]
    plan += [(s, c) for s in seeds(args.control_seeds) for c in loop.CONTROLS]
    plan += [(s, f) for s in seeds(args.fault_seeds) for f in loop.FAULTS]
    rows = []
    for seed, mode in plan:
        try:
            row = one(cfg, mix, seed, args.seconds, device, mode, limits)
        except Exception as e:  # a control that crashes has failed; say how
            row = {"mode": mode, "seed": seed, "error": repr(e), "correct": False}
            torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for mode in sorted({r["mode"] for r in rows}):
        got = [r["readings"] for r in rows if r["mode"] == mode and "readings" in r]
        if not got:
            continue
        summary[mode] = {k: {"max": max(g[k] for g in got), "min": min(g[k] for g in got)}
                         for k in got[0]}
        summary[mode]["correct"] = [r["correct"] for r in rows if r["mode"] == mode]
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(device),
           "rows": rows, "summary": summary}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(summary), flush=True)
    found = run.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
