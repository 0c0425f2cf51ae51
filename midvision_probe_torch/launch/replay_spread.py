"""The spread of the timed probe step between runs, on the card: the
`capturable` eager step against itself in other processes, and the
CUDA-graph replay (``time_suite.Steps.graphed_probe_step``) against it.

``chip_smoke.py``'s ``suite_timing`` holds the replay of dino_vitb16's bf16
linear probe step to an eager step with ``capturable`` AdamW at the 99.9th
percentile of the parameters' differences, 0.01 of the learning rate. This
tool measures what that gate reads when nothing differs but the run: each
of ``--processes`` worker processes builds the same seeded features (batch
32 at 480², bf16) and, ``--trials`` times, a fresh seeded probe per arm:

* ``capturable``: two eager warm-up steps, then three eager steps, AdamW
  ``capturable`` (the gate's reference arm);
* ``replayed``: the same steps as a CUDA-graph capture and replays (the
  gate's arm under test);
* ``deterministic``: the ``capturable`` arm under
  ``torch.use_deterministic_algorithms(True)``, or the error that PyTorch
  raises for a kernel with no deterministic version;
* ``deterministic_warn_only``: the same with ``warn_only=True`` (every
  kernel deterministic that has a deterministic version).

The workers run with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which cuBLAS
needs to be deterministic.

The parent process compares every pair of runs: within a process and across
processes, eager against eager, replay against eager and replay against
replay, and prints the distribution of each pair's ``q0.999_lr`` (the
gate's reading) as one JSON object. Usage (on the card)::

    python -m midvision_probe_torch.launch.replay_spread --processes 4 --trials 10 \\
        --out replay_spread.json
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile

import torch

ARMS = ("capturable", "replayed", "deterministic", "deterministic_warn_only")
QUANTILES = (0.5, 0.99, 0.999, 1.0)
GATE_LR = 0.01  # chip_smoke.py's bound on q0.999_lr
STEPS = 3  # the steps compared after two warm-up steps, as the gate takes them


def _deterministic(arm: str) -> None:
    torch.use_deterministic_algorithms(arm.startswith("deterministic"),
                                       warn_only=arm.endswith("warn_only"))


def _run_arm(time_suite, arm: str, feats, depth):
    """One fresh seeded bf16 linear probe, two warm-up steps and ``STEPS``
    more in ``arm``; its losses and parameters (or the error raised)."""
    modules, optimizer = time_suite.build_probe(feats[-1].shape[-1], "linear",
                                                probe_dtype="bfloat16", device="cuda")
    steps = time_suite.Steps(None, modules, optimizer, None, depth)
    if arm == "replayed":
        step = steps.graphed_probe_step(feats, depth)
    else:
        for group in optimizer.param_groups:
            group["capturable"] = True
        _deterministic(arm)
        try:
            for _ in range(2):
                steps.probe_step(feats, depth)
        except RuntimeError as err:
            return {"error": str(err).splitlines()[0]}
        finally:
            torch.use_deterministic_algorithms(False)
        step = steps.probe_step
    _deterministic(arm)
    try:
        losses = [float(step(feats, depth)) for _ in range(STEPS)]
    finally:
        torch.use_deterministic_algorithms(False)
    params = torch.cat([p.detach().float().reshape(-1) for p in modules.parameters()])
    return {"losses": losses, "params": params.cpu()}


def worker(trials: int, dump: str) -> int:
    """Build dino_vitb16's seeded bf16 features at the gate's shape and run
    every arm ``trials`` times; write the runs to ``dump``."""
    from midvision_probe_torch.launch import time_suite

    steps = time_suite.build_steps("dino_vitb16", 32, (480, 480), "dpt", "bfloat16")
    with torch.no_grad():
        feats = steps.extract(steps.images)[-1:]
    depth = steps.depth
    del steps
    torch.cuda.empty_cache()
    runs = {arm: [] for arm in ARMS}
    for _ in range(trials):
        for arm in ARMS:
            runs[arm].append(_run_arm(time_suite, arm, feats, depth))
            torch.cuda.empty_cache()
    torch.save({"runs": runs, "feats_sum": float(feats[-1].double().sum()),
                "device": torch.cuda.get_device_name(0)}, dump)
    return 0


def q_lr(a: torch.Tensor, b: torch.Tensor, lr: float) -> dict:
    """Quantiles of the parameters' absolute differences in units of ``lr``,
    as ``chip_smoke.py::replay_against_eager`` reads them."""
    diff = (a - b).abs().sort().values / lr
    return {f"q{q}_lr": float(diff[int(q * (diff.numel() - 1))]) for q in QUANTILES}


def summarise(values: list[float]) -> dict:
    s = sorted(values)
    if not s:
        return {"pairs": 0}
    return {"pairs": len(s), "min": s[0], "median": s[len(s) // 2],
            "q0.9": s[int(0.9 * (len(s) - 1))], "max": s[-1],
            "above_gate": sum(v > GATE_LR for v in s)}


def compare(per_process: list[dict], lr: float) -> dict:
    """Every pair of runs: the q0.999_lr distributions by kind of pair."""
    runs = [(p, t, arm, run) for p, proc in enumerate(per_process)
            for arm, arm_runs in proc["runs"].items() for t, run in enumerate(arm_runs)
            if "params" in run]
    kinds: dict[str, list[float]] = {}
    worst: dict[str, dict] = {}
    for (p1, t1, a1, r1), (p2, t2, a2, r2) in itertools.combinations(runs, 2):
        if a1 != a2 and (a1.startswith("deterministic") or a2.startswith("deterministic")):
            continue
        arms = "_vs_".join(sorted((a1, a2)))
        where = "same_process" if p1 == p2 else "other_process"
        key = f"{arms}.{where}"
        q = q_lr(r1["params"], r2["params"], lr)
        kinds.setdefault(key, []).append(q["q0.999_lr"])
        if q["q0.999_lr"] >= worst.get(key, {}).get("q0.999_lr", -1.0):
            loss_rel = max(abs(x - y) / abs(y) for x, y in zip(r1["losses"], r2["losses"]))
            worst[key] = {**q, "loss_rel": loss_rel}
    return {key: {**summarise(v), "worst": worst[key]} for key, v in sorted(kinds.items())}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--processes", type=int, default=4)
    parser.add_argument("--trials", type=int, default=10)
    parser.add_argument("--out", default=None, help="write the JSON object here too")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("replay_spread measures the card: CUDA is not available")
    if args.worker is not None:
        return worker(args.trials, args.worker)

    from midvision_probe_torch.launch import time_suite
    from midvision_probe_torch.ops.cuda_build import build_all

    build_all(("vit_attention",))  # K1, the backbone's attention
    root = tempfile.mkdtemp(prefix="mvp_replay_spread_")
    per_process = []
    for p in range(args.processes):
        dump = os.path.join(root, f"{p}.pt")
        subprocess.run([sys.executable, "-m", "midvision_probe_torch.launch.replay_spread",
                        "--trials", str(args.trials), "--worker", dump], check=True,
                       env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
        proc = torch.load(dump)
        for arm_runs in proc["runs"].values():
            for run in arm_runs:
                if "params" in run:
                    run["params"] = run["params"].cuda()
        per_process.append(proc)
        os.remove(dump)
    os.rmdir(root)
    errors = sorted({run["error"] for proc in per_process for run in proc["runs"]["deterministic"]
                     if "error" in run})
    result = {"tool": "replay_spread", "device": per_process[0]["device"],
              "processes": args.processes, "trials": args.trials, "steps": STEPS,
              "gate_lr": GATE_LR, "lr": time_suite.ADAMW_LR,
              "same_features": len({proc["feats_sum"] for proc in per_process}) == 1,
              "deterministic_errors": errors,
              "q0.999_lr": compare(per_process, time_suite.ADAMW_LR)}
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
