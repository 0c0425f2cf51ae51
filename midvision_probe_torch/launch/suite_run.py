"""One-command full-suite run of the PyTorch port (counterpart of the
repository's ``launch_script/suite_run.py``).

Runs the complete product the reference ships, the reference's depth-sweep
backbone list (``launch_depth.py:22-51``, 28 families) crossed with the six
evaluation task families, as driver processes of the port on one card:
the fast preset, synthetic data, the full CSV artifact set the reference's
pipelines emit (``train_depth.py:806-829`` et al.) and a wall-time report.

Per-(task, model) rows persist to ``<log-dir>/suite_rows.json`` after every
cell, so an interrupted suite resumes where it stopped (``--resume``, the
default). Before the first cell the launcher checks the card in a bounded
process (one tiny launch) and builds the CUDA kernels once; after a failed
cell it checks the card again and stops if it no longer answers. With
``--device cpu`` every cell runs on the CPU and neither happens.

Usage::

    python -m midvision_probe_torch.launch.suite_run                     # everything
    python -m midvision_probe_torch.launch.suite_run --tasks depth navi  # subset
    python -m midvision_probe_torch.launch.suite_run --models dino_b16 mae_b16
    python -m midvision_probe_torch.launch.suite_run --report-only       # md from rows
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from midvision_probe_torch.launch.sweep import (
    DEFAULT_MODELS,
    REPO,
    build_kernels,
    require_device,
    subprocess_env,
)

# overridable via --suite-out (a smoke must not pollute a real run's CSVs)
SUITE_OUT = os.path.join(tempfile.gettempdir(), "mvp_suite_torch")

# task -> (driver module, overrides[, eval size]). Trained probes use the
# fast preset (linear probe + cached features + bf16) at the protocol 480
# resolution; eval tasks use the synthetic geometric datasets at 224
# (divisible by both patch 14 and 16 families).
FAST = ["system.cache_features=true", "system.backbone_dtype=bfloat16",
        "system.probe_dtype=bfloat16"]
TRAIN_COMMON = ["dataset=synthetic", "dataset.num_instances=64",
                "dataset.image_size=[480,480]", "optimizer=ten_epoch",
                "batch_size=32", "+backbone.return_multilayer=True",
                "wandb.use=False", "+render_images=False"] + FAST

# beyond the 6 headline families: the remaining reference driver families
# and the preset and hardened columns, run only when named with --tasks.
# depth_dpt192/snorm_dpt192 train a DPT decoder (hidden_dim 256) at 192²
# and evaluate the reloaded probe at the protocol's 480².
EXTRA_TASKS = ("objectness", "taskonomy", "maskcut",
               "depth_dpt192", "snorm_dpt192",
               "navi_hard", "scannet_hard", "percepture_hard")

MAIN_TASKS = ("depth", "snorm", "navi", "scannet", "spair", "percepture")


def _at_size(overrides: list, size: int) -> list:
    return [f"dataset.image_size=[{size},{size}]"
            if o.startswith("dataset.image_size=") else o
            for o in overrides]


def reload_at_size(overrides: list, train_dir: str, size: int) -> list | None:
    """The second phase of a two-phase cell: ``overrides`` at ``size`` plus
    the driver's eval-only path (``+is_eval`` and ``+ckpt_path``) on the
    newest checkpoint the first phase wrote under ``train_dir`` (the probe is
    fully convolutional, so it transfers across sizes); None without one."""
    ckpts = sorted(glob.glob(os.path.join(train_dir, "*", "ckpt")))
    if not ckpts:
        return None
    return _at_size(overrides, size) + ["+is_eval=True", f"+ckpt_path={ckpts[-1]}"]


def task_plan(spair_root: str) -> dict:
    """The JAX suite's plan, cell for cell: the same tasks and overrides,
    each driver being the port's module."""
    return {
        "depth": ("midvision_probe_torch.train_depth",
                  TRAIN_COMMON + ["probe=depth_linear"]),
        "snorm": ("midvision_probe_torch.train_snorm",
                  TRAIN_COMMON + ["probe=snorm_linear"]),
        "navi": ("midvision_probe_torch.evaluate_navi_correspondence",
                 ["dataset=synthetic_navi", "dataset.num_instances=16",
                  "dataset.image_size=224", "num_corr=100",
                  "batch_pairs=4", "scale_factor=0.25"]),
        "scannet": ("midvision_probe_torch.render_scannet_correspondence",
                    ["dataset=synthetic_scannet", "dataset.num_instances=8",
                     "dataset.image_hw=[224,224]", "num_corr=100",
                     "batch_pairs=2", "scale_factor=0.25"]),
        "spair": ("midvision_probe_torch.evaluate_spair_correspondence",
                  [f"data_root={spair_root}", "image_size=480",
                   "num_instances=8", "batch_pairs=4"]),
        "percepture": ("midvision_probe_torch.evaluate_model_percepture",
                       ["dataset=synthetic_twoafc",
                        "dataset.num_instances=64",
                        "dataset.image_size=[224,224]", "batch_size=32"]),
        # ---- EXTRA_TASKS (explicit --tasks only) ----
        "objectness": ("midvision_probe_torch.train_generic_objectness",
                       ["dataset=synthetic_voc", "dataset.num_instances=64",
                        "dataset.image_size=[480,480]",
                        "optimizer=ten_epoch", "batch_size=32",
                        "+backbone.return_multilayer=True",
                        "wandb.use=False"] + FAST),
        "taskonomy": ("midvision_probe_torch.train_taskonomy",
                      ["dataset=taskonomy", "+dataset.num_instances=64",
                       "+dataset.image_size=[480,480]",
                       "optimizer=ten_epoch", "batch_size=32",
                       "+backbone.return_multilayer=True",
                       "wandb.use=False"] + FAST),
        "maskcut": ("midvision_probe_torch.evaluate_generic_objectness",
                    ["dataset=synthetic_voc", "dataset.num_instances=8",
                     "dataset.image_size=[224,224]",
                     "maskcut.fixed_size=224", "max_images=8"]),
        # the hardened geometric evaluations: the same shapes as the easy
        # cells on harder data (view-dependent shading, periodic texture,
        # occlusion, shift-vs-blend triplets) so the rankings spread
        "navi_hard": ("midvision_probe_torch.evaluate_navi_correspondence",
                      ["dataset=synthetic_navi_hard",
                       "dataset.num_instances=16",
                       "dataset.image_size=224", "num_corr=100",
                       "batch_pairs=4", "scale_factor=0.25"]),
        "scannet_hard": ("midvision_probe_torch.render_scannet_correspondence",
                         ["dataset=synthetic_scannet_hard",
                          "dataset.num_instances=8",
                          "dataset.image_hw=[224,224]", "num_corr=100",
                          "batch_pairs=2", "scale_factor=0.25"]),
        "percepture_hard": ("midvision_probe_torch.evaluate_model_percepture",
                            ["dataset=synthetic_twoafc_hard",
                             "dataset.num_instances=64",
                             "dataset.image_size=[224,224]",
                             "batch_size=32"]),
        # the dpt-192-hd256 preset columns: train at 192², then reload the
        # fully convolutional probe and evaluate at the protocol's 480²
        "depth_dpt192": ("midvision_probe_torch.train_depth",
                         _at_size(TRAIN_COMMON, 192)
                         + ["probe=depth_dpt192_hd256"], 480),
        "snorm_dpt192": ("midvision_probe_torch.train_snorm",
                         _at_size(TRAIN_COMMON, 192)
                         + ["probe=snorm_dpt192_hd256"], 480),
    }


def make_mini_spair(root: str, n_pairs: int = 4) -> str:
    """Miniature SPair-71k tree in the reference's on-disk layout
    (reference ``evals/datasets/spair.py``), the JAX suite's stand-in for
    the real archive, byte for byte: three classes, ``n_pairs`` test pairs
    each, 96x128 JPEGs."""
    import numpy as np
    from PIL import Image

    if os.path.exists(os.path.join(root, "PairAnnotation", "test")):
        return root
    rng = np.random.RandomState(8)
    classes = {"cat": 8, "dog": 12, "chair": 9}
    os.makedirs(os.path.join(root, "PairAnnotation", "test"), exist_ok=True)
    pid = 0
    for cls, cid in classes.items():
        for d in ("JPEGImages", "Segmentation", "ImageAnnotation"):
            os.makedirs(os.path.join(root, d, cls), exist_ok=True)
        views = [f"v{i}" for i in range(n_pairs + 1)]
        for v in views:
            img = (rng.rand(96, 128, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(root, "JPEGImages", cls, f"{v}.jpg"))
            seg = np.zeros((96, 128), np.uint8)
            seg[16:80, 16:96] = cid
            Image.fromarray(seg).save(
                os.path.join(root, "Segmentation", cls, f"{v}.png"))
            kps = {str(k): [int(20 + 10 * k + rng.randint(8)),
                            int(24 + 8 * k + rng.randint(8))]
                   for k in range(4)}
            kps["4"] = None
            with open(os.path.join(root, "ImageAnnotation", cls, f"{v}.json"), "w") as f:
                json.dump({"filename": f"{v}.jpg", "kps": kps}, f)
        for i in range(n_pairs):
            pair = {
                "filename": f"pair-{views[i]}-{views[i + 1]}:{cls}",
                "category": cls,
                "viewpoint_variation": i % 3,
                "src_bndbox": [16, 16, 96, 80],
                "trg_bndbox": [16, 16, 96, 80],
                "trg_imsize": [128, 96],
            }
            with open(os.path.join(root, "PairAnnotation", "test", f"p{pid}.json"), "w") as f:
                json.dump(pair, f)
            pid += 1
    return root


PROBE = ("import torch\n"
         "assert torch.cuda.is_available(), 'CUDA is not available'\n"
         "x = torch.ones(1024, device='cuda')\n"
         "assert float((x + 1).sum()) == 2048.0\n")


def probe_backend(timeout_s: int = 120) -> tuple[bool, str]:
    """Check the card in a bounded process: CUDA visible and one tiny launch
    that comes back right. Returns (ok, what went wrong)."""
    try:
        proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                              text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False, f"the card probe did not answer within {timeout_s} s"
    if proc.returncode != 0:
        return False, (proc.stderr.strip().splitlines() or ["(no output)"])[-1]
    return True, ""


def card_name(device: str, short: bool = False) -> str:
    """The card as ``nvidia-smi`` names it, with its power limit, or the
    CPU; ``short``: the model alone (``H100``, ``CPU``)."""
    if not device.startswith("cuda"):
        return "CPU" if short else "the CPU"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    if not out:
        return "a CUDA card (nvidia-smi did not answer)"
    line = out.splitlines()[0]
    return line.split(",")[0].removeprefix("NVIDIA ").split()[0] if short else line


def run_one(task: str, driver: str, model: str, overrides: list,
            log_dir: str, eval_size: int | None = None, device: str = "cuda") -> dict:
    out_dir = os.path.join(SUITE_OUT, task)
    env = subprocess_env()
    os.makedirs(os.path.join(log_dir, task), exist_ok=True)
    log_path = os.path.join(log_dir, task, f"{model}.log")
    t0 = time.time()

    def _phase(phase_overrides: list, outdir: str, log) -> int:
        cmd = [sys.executable, "-m", driver, f"backbone={model}",
               f"output_dir={outdir}"] + phase_overrides + [f"+system.device={device}"]
        # bounded: a wedged cell must not stall the whole suite; a two-phase
        # preset cell runs two drivers, so each phase gets a wider budget
        budget = 2400 if eval_size is None else 3600
        try:
            return subprocess.call(cmd, stdout=log, stderr=subprocess.STDOUT,
                                   env=env, cwd=REPO, timeout=budget)
        except subprocess.TimeoutExpired:
            log.write(f"\n[suite] KILLED: exceeded {budget} s cell budget\n")
            return 124

    with open(log_path, "w") as log:
        if eval_size is None:
            ret = _phase(overrides, out_dir, log)
        else:
            # two-phase preset cell: train at the reduced size into a
            # per-model dir (exp_name embeds the zoo checkpoint name, so a
            # shared dir would make the checkpoint glob ambiguous), then
            # reload the fully convolutional probe through the driver's
            # eval-only path (+is_eval +ckpt_path) at the protocol size,
            # appending to the shared task CSV
            train_dir = os.path.join(out_dir, f"train_{model}")
            ret = _phase(overrides, train_dir, log)
            if ret == 0:
                eval_overrides = reload_at_size(overrides, train_dir, eval_size)
                if eval_overrides is None:
                    log.write(f"\n[suite] no checkpoint under {train_dir}\n")
                    ret = 1
                else:
                    ret = _phase(eval_overrides, out_dir, log)
    return {"task": task, "model": model, "rc": ret,
            "wall_s": round(time.time() - t0, 1), "ts": round(t0, 1)}


def _median(xs):
    return sorted(xs)[len(xs) // 2] if xs else float("nan")


def write_report(rows: list, out_md: str, log_dir: str,
                 expected_models: list | None = None, card: str = "one card"):
    tasks = sorted({r["task"] for r in rows})
    models = []
    for r in rows:  # preserve run order
        if r["model"] not in models:
            models.append(r["model"])
    by = {(r["task"], r["model"]): r for r in rows}
    total_s = sum(r["wall_s"] for r in rows)
    n_fail = sum(1 for r in rows if r["rc"] != 0)

    lines = [
        "# Full-suite run — every backbone x every task family, one command",
        "",
        f"`python -m midvision_probe_torch.launch.suite_run` — {len(models)} "
        f"backbones (the reference depth-sweep list, launch_depth.py:22-51) x "
        f"{len(tasks)} task families, fast preset, synthetic data, on {card} "
        "(serial). Cells are wall seconds per driver process "
        "(start-up + data + train/eval + CSV); **F** = nonzero exit.",
        "",
        "| backbone | " + " | ".join(tasks) + " |",
        "|---" * (len(tasks) + 1) + "|",
    ]
    for m in models:
        cells = []
        for t in tasks:
            r = by.get((t, m))
            cells.append("—" if r is None else
                         (f"{r['wall_s']:.0f}" if r["rc"] == 0
                          else f"**F**({r['wall_s']:.0f})"))
        lines.append(f"| {m} | " + " | ".join(cells) + " |")
    per_task = {t: sum(r["wall_s"] for r in rows if r["task"] == t)
                for t in tasks}
    lines += [
        "",
        f"**Total observed wall-clock: {total_s / 3600:.2f} h** "
        f"({len(rows)} runs, {n_fail} failures). Per task: "
        + ", ".join(f"{t} {s / 3600:.2f} h" for t, s in per_task.items())
        + ".",
        "",
        "## Per task",
        "",
        "Green cells only; every cell appended its row to the task CSV "
        f"(archived under `{log_dir}/csv/`).",
        "",
        "| task | cells | median s | min..max s | total h |",
        "|---|---|---|---|---|",
    ]
    for t in tasks:
        walls = [r["wall_s"] for r in rows if r["task"] == t and r["rc"] == 0]
        if not walls:
            continue
        lines.append(f"| {t} | {len(walls)} | {_median(walls):.0f} | "
                     f"{min(walls):.0f}..{max(walls):.0f} | {sum(walls) / 3600:.2f} |")
    med = sorted(r["wall_s"] for r in rows if r["rc"] == 0)
    if med:
        lines += ["", f"Median per-run wall {_median(med):.0f} s."]
    # a zero-failure report must not read as complete when cells never ran
    exp_models = expected_models or DEFAULT_MODELS
    green = {(r["task"], r["model"]) for r in rows if r["rc"] == 0}
    pending = [(t, m) for m in exp_models for t in MAIN_TASKS
               if (t, m) not in green]
    lines += [
        "",
        f"## Remaining cells: {len(pending)} of "
        f"{len(exp_models) * len(MAIN_TASKS)} main-pass cells not yet green",
        "",
    ]
    if pending:
        by_model: dict = {}
        for t, m in pending:
            by_model.setdefault(m, []).append(t)
        lines += [f"- {m}: {', '.join(ts)}" for m, ts in by_model.items()]
    else:
        lines += ["All main-pass cells green — the suite artifact is "
                  "complete."]
    os.makedirs(os.path.dirname(out_md) or ".", exist_ok=True)
    with open(out_md, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"[suite] report -> {out_md}")


def archive_csvs(log_dir: str):
    """Copy the per-task CSV artifact set from the suite's output tree into
    ``<log_dir>/csv/`` as ``<task>_<file>.csv``. Idempotent and cheap, so
    it runs after every cell: an interrupted suite keeps every CSV row it
    made."""
    csv_dir = os.path.join(log_dir, "csv")
    os.makedirs(csv_dir, exist_ok=True)
    for p in glob.glob(os.path.join(SUITE_OUT, "*", "*.csv")):
        shutil.copy(p, os.path.join(
            csv_dir, os.path.basename(os.path.dirname(p)) + "_"
            + os.path.basename(p)))


def main(argv=None):
    global SUITE_OUT
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", nargs="*", default=None)
    ap.add_argument("--models", nargs="*", default=None)
    ap.add_argument("--log-dir", default="logs/suite_torch")
    ap.add_argument("--out", default="logs/suite_torch/suite_run.md")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--report-only", action="store_true")
    ap.add_argument("--suite-out", default=SUITE_OUT)
    ap.add_argument("--device", default="cuda",
                    help="device of every cell (+system.device=); cpu runs on the CPU")
    args = ap.parse_args(argv)
    SUITE_OUT = args.suite_out

    os.makedirs(args.log_dir, exist_ok=True)
    rows_path = os.path.join(args.log_dir, "suite_rows.json")
    rows = []
    if os.path.exists(rows_path) and not args.no_resume:
        with open(rows_path) as f:
            rows = json.load(f)
    card = card_name(args.device)

    if not args.report_only:
        require_device(args.device)
        # the miniature SPair tree lives beside the task outputs (it holds
        # no CSV at its top, so neither the archive nor the tables read it)
        plan = task_plan(make_mini_spair(os.path.join(SUITE_OUT, "spair_tree")))
        tasks = args.tasks or [t for t in plan if t not in EXTRA_TASKS]
        unknown = sorted(set(tasks) - set(plan))
        if unknown:
            raise SystemExit(f"[suite] unknown tasks {unknown}; the plan has {sorted(plan)}")
        models = args.models or DEFAULT_MODELS
        done = {(r["task"], r["model"]) for r in rows if r["rc"] == 0}
        todo = [(t, m) for m in models for t in tasks
                if (t, m) not in done]
        print(f"[suite] {len(todo)} runs to go "
              f"({len(done)} already ok)", flush=True)
        if todo and args.device.startswith("cuda"):
            ok, why = probe_backend()
            if not ok:
                raise RuntimeError(f"[suite] the card does not answer: {why}")
            print(f"[suite] CUDA kernels built in {build_kernels(args.device):.1f}s",
                  flush=True)
        for i, (t, m) in enumerate(todo):
            driver, overrides = plan[t][0], plan[t][1]
            eval_size = plan[t][2] if len(plan[t]) > 2 else None
            row = run_one(t, driver, m, overrides, args.log_dir, eval_size, args.device)
            rows = [r for r in rows
                    if not (r["task"] == t and r["model"] == m)] + [row]
            with open(rows_path, "w") as f:
                json.dump(rows, f, indent=1)
            status = "ok" if row["rc"] == 0 else f"FAILED({row['rc']})"
            print(f"[suite] {i + 1}/{len(todo)} {t}/{m}: {status} "
                  f"in {row['wall_s']:.0f}s", flush=True)
            # keep the report and the CSV archive current, so an interrupted
            # suite still leaves a coherent artifact
            write_report(rows, args.out, args.log_dir, card=card)
            archive_csvs(args.log_dir)
            # a failed cell on the card: check that the card still answers
            # before spending more cell budgets on it
            if row["rc"] != 0 and args.device.startswith("cuda"):
                ok, why = probe_backend()
                if not ok:
                    print(f"[suite] the card stopped answering ({why}) — stopping "
                          "(resume later)", flush=True)
                    break
        archive_csvs(args.log_dir)

    write_report(rows, args.out, args.log_dir, card=card)
    return 1 if any(r["rc"] != 0 for r in rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
