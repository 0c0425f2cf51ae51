"""Aggregate the suite's CSV artifact set into paper-style ranking tables
(a copy of the repository's ``launch_script/aggregate_results.py`` for the
PyTorch port; it renders the same markdown from the same directory).

The reference's pipelines stop at per-task CSV rows (one append per run,
``train_depth.py:806-829`` et al.); the paper's backbone-ranking tables are
assembled from those rows by hand. This CLI is that last step: it reads
every task CSV a suite run produced (either the ``suite_run`` archive
layout ``<dir>/<task>_<name>.csv`` or the live output tree
``<dir>/<task>/<name>.csv``), keeps the latest row per backbone, and emits
one markdown ranking table per task plus a cross-task overview. A cell
whose CSV row is missing is recovered from its driver log; the patterns of
``parse_cell_log`` are held to the port drivers' own log lines.

Usage::

    python -m midvision_probe_torch.launch.aggregate_results             # archive dir
    python -m midvision_probe_torch.launch.aggregate_results --csv-dir /tmp/mvp_suite_torch
    python -m midvision_probe_torch.launch.aggregate_results --out results.md
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import re

# headline columns per task family, in display order; the FIRST column is
# the ranking key and the one shown in the cross-task overview. Names are
# the exact CSV headers the drivers emit (reference schemas: depth/snorm
# train_depth.py:806-829 / train_snorm.py; correspondence
# evaluate_navi_correspondence.py; 2AFC evaluate_model_percepture.py).
HEADLINE = {
    "depth": ["sa_d1", "sa_d2", "sa_d3", "sa_rmse", "si_d1", "si_rmse"],
    "snorm": ["d1", "d2", "d3", "rmse"],
    "navi": ["3D Recall (0.02m)", "3D Recall (0.01m)", "3D Recall (0.05m)",
             "2D Recall (5px)", "2D Recall (25px)", "2D Recall (50px)"],
    "scannet": ["3D Recall (0.05m)", "3D Recall (0.10m)",
                "2D Recall (5px)", "2D Recall (15px)"],
    "spair": ["Recall (View Diff all)", "Recall (View Diff 0)",
              "Recall (View Diff 1)", "Recall (View Diff 2)"],
    "percepture": ["accuracy", "f1_score", "precision", "recall"],
    # hardened geometric evals (same drivers/schemas as their easy twins;
    # suite_run's navi_hard/scannet_hard/percepture_hard columns)
    "navi_hard": ["3D Recall (0.02m)", "3D Recall (0.01m)",
                  "3D Recall (0.05m)", "2D Recall (5px)",
                  "2D Recall (25px)", "2D Recall (50px)"],
    "scannet_hard": ["3D Recall (0.05m)", "3D Recall (0.10m)",
                     "2D Recall (5px)", "2D Recall (15px)"],
    "percepture_hard": ["accuracy", "f1_score", "precision", "recall"],
    "objectness": ["F-measure", "IoU", "Accuracy", "CorLoc"],
    "maskcut": ["F-measure", "IoU", "Accuracy", "CorLoc"],
    # the dpt-192-hd256 preset columns (suite_run's depth_dpt192 and
    # snorm_dpt192): their own tables, never merged into depth and snorm
    # (the launch_script copy files them under depth and snorm by prefix,
    # where the latest row per backbone replaces the linear probe's)
    "depth_dpt192": ["sa_d1", "sa_d2", "sa_d3", "sa_rmse", "si_d1", "si_rmse"],
    "snorm_dpt192": ["d1", "d2", "d3", "rmse"],
    # taskonomy metric keys vary by task (masked_l1 / absrel / delta1..) —
    # resolved per file by _numeric_columns below
    "taskonomy": [],
}

# identity / configuration columns that must never be treated as metrics
_META = {"exp_name", "checkpoint", "layer", "output", "n_epochs",
         "batch_size", "probe_lr", "note", "Time", "Model Checkpoint",
         "Patch Size", "Layer", "Output", "Num Correspondences",
         "Scale Factor", "Dataset", "Split", "Class", "Num Instances",
         "Num Images", "Num Errors"}


def _lower_is_better(col: str) -> bool:
    c = col.lower()
    return any(k in c for k in ("rmse", "l1", "absrel", "error", "loss"))


def _model_of(row: dict) -> str | None:
    return row.get("checkpoint") or row.get("Model Checkpoint")


def _numeric_columns(rows: list[dict]) -> list[str]:
    """Fallback headline set: every non-meta column that parses as float
    in the first row (taskonomy's keys vary with the sub-task)."""
    cols = []
    for k, v in rows[0].items():
        if k in _META:
            continue
        try:
            float(v)
        except (TypeError, ValueError):
            continue
        cols.append(k)
    return cols


def _norm_name(name: str) -> str:
    """Checkpoint-name normalizer for matching a suite model key (e.g.
    ``dino_b16``) against a driver CSV checkpoint value (``dino_vitb16``
    or ``byol_resnet50_dense_[1, 2, 3, 4]``): lowercase, drop non-alnum,
    drop the 'vit' infix."""
    return re.sub(r"[^a-z0-9]", "", name.lower()).replace("vit", "")


def _overview_key(name: str) -> str:
    """Canonical backbone key for merging one model's rows across tasks:
    strips the ' †' recovery marker and the output/layers config suffix
    the drivers bake into the checkpoint column
    (``byol_resnet50_dense_[1, 2, 3, 4]`` -> ``byolresnet50``), then
    normalizes. Without this, a model with CSV rows in some tasks and
    log-recovered rows in others split into two overview rows padded
    with '—'."""
    base = name.replace(" †", "")
    base = re.sub(r"_(dense-cls|dense|cls|gap)(_?\[.*)?$", "", base)
    return _norm_name(base)


def _names_match(csv_ckpt: str, model_key: str) -> bool:
    a, b = _norm_name(csv_ckpt), _norm_name(model_key)
    return a.startswith(b) or b.startswith(a)


# --- per-cell-log metric recovery -----------------------------------------
# The suite writes one log per (task, model) cell under <logs>/<task>/.
# When a cell's CSV row is missing from the archive (the suite's output
# tree sits in the temp directory, which a host reboot can empty before the
# archive step, while the rows JSON says rc=0 and resume never re-runs the
# cell), the headline metrics are still recoverable from the driver's final
# log lines. Rows built this way
# carry a ' †' suffix on the backbone name and only the headline columns.

def parse_cell_log(task: str, text: str) -> dict | None:
    """Extract the headline metric dict from one cell log, or None."""
    out: dict[str, str] = {}
    # *_hard and *_dpt192 logs share the easy schema
    task = task.removesuffix("_hard").removesuffix("_dpt192")
    if task == "depth":
        ms = re.findall(r"scale-aware\s+d1 (\S+) rmse (\S+) \| "
                        r"scale-invariant d1 (\S+) rmse (\S+)", text)
        if ms:
            sa_d1, sa_rmse, si_d1, si_rmse = ms[-1]
            out = {"sa_d1": sa_d1, "sa_rmse": sa_rmse,
                   "si_d1": si_d1, "si_rmse": si_rmse}
    elif task == "snorm":
        ms = re.findall(r"snorm d1 (\S+) d2 (\S+) d3 (\S+) "
                        r"rmse (\S+?)deg", text)
        if ms:
            d1, d2, d3, rmse = ms[-1]
            out = {"d1": d1, "d2": d2, "d3": d3, "rmse": rmse}
    elif task in ("navi", "scannet"):
        for thr, v in re.findall(r"Recall at\s*([\d.]+)\s*m:\s*(\S+)", text):
            out[f"3D Recall ({thr}m)"] = v
        for px, v in re.findall(r"Recall at\s*(\d+)\s*px:\s*(\S+)", text):
            out[f"2D Recall ({px}px)"] = v
    elif task == "spair":
        for d, v in re.findall(
                r"Recall@[\d.]+ view diff=\s*(\S+) \|\s*(\S+)", text):
            if v != "N/A":
                out[f"Recall (View Diff {d})"] = v
    elif task == "percepture":
        ms = re.findall(r"2AFC acc (\S+) f1 (\S+) p (\S+) r (\S+)", text)
        if ms:
            a, f1, p, r = ms[-1]
            out = {"accuracy": a, "f1_score": f1,
                   "precision": p, "recall": r}
    return out or None


def recover_from_logs(logs_dir: str,
                      tables: dict[str, list[dict]]) -> dict[str, int]:
    """For every <logs_dir>/<task>/<model>.log with no matching CSV row in
    ``tables``, parse the log's final metric lines into a headline-only row
    (backbone name suffixed ' †'). Mutates ``tables``; returns per-task
    recovered-row counts."""
    recovered: dict[str, int] = {}
    # only recover cells the suite recorded as green: a cell that printed
    # metrics then failed (or was killed mid-print, or is still running)
    # must not be presented as a result. Without a rows
    # JSON (e.g. a raw /tmp tree), recover everything as before.
    green: set | None = None
    rows_path = os.path.join(logs_dir, "suite_rows.json")
    if os.path.exists(rows_path):
        import json
        green = {(r["task"], r["model"])
                 for r in json.load(open(rows_path)) if r["rc"] == 0}
    for sub in sorted(glob.glob(os.path.join(logs_dir, "*", ""))):
        task = os.path.basename(os.path.dirname(sub))
        if task not in HEADLINE:
            continue
        rows = tables.setdefault(task, [])
        have = [(_model_of(r) or "") for r in rows]
        for lp in sorted(glob.glob(os.path.join(sub, "*.log"))):
            model = os.path.splitext(os.path.basename(lp))[0]
            if green is not None and (task, model) not in green:
                continue
            if any(_names_match(h, model) for h in have):
                continue
            with open(lp) as f:
                parsed = parse_cell_log(task, f.read())
            if parsed:
                rows.append({"checkpoint": model + " †", **parsed})
                have.append(model)
                recovered[task] = recovered.get(task, 0) + 1
        if not rows:
            tables.pop(task, None)
    return recovered


def discover(csv_dir: str) -> dict[str, list[str]]:
    """Map task -> CSV paths for both supported layouts."""
    by_task: dict[str, list[str]] = {}
    for sub in sorted(glob.glob(os.path.join(csv_dir, "*", ""))):
        task = os.path.basename(os.path.dirname(sub))
        paths = sorted(glob.glob(os.path.join(sub, "*.csv")))
        if paths and task != "csv":
            by_task.setdefault(task, []).extend(paths)
    for p in sorted(glob.glob(os.path.join(csv_dir, "*.csv"))):
        base = os.path.basename(p)
        # longest task prefix wins: 'navi_hard_<file>.csv' must land under
        # navi_hard, not navi (same for scannet/percepture _hard twins)
        task = next((t for t in sorted(HEADLINE, key=len, reverse=True)
                     if base.startswith(t + "_")), None)
        if task:
            by_task.setdefault(task, []).append(p)
    return by_task


def load_task(paths: list[str]) -> list[dict]:
    rows: list[dict] = []
    for p in paths:
        with open(p) as f:
            rows.extend(csv.DictReader(f))
    # SPair emits one row per class plus the 'all' aggregate — rank on the
    # aggregate only (per-class detail stays in the archived CSV)
    if rows and "Class" in rows[0]:
        allr = [r for r in rows if r.get("Class") == "all"]
        rows = allr or rows
    # latest row per backbone wins (suite retries / repeated runs append)
    latest: dict[str, dict] = {}
    for r in rows:
        m = _model_of(r)
        if m:
            latest[m] = r
    return list(latest.values())


def _fmt(v: str) -> str:
    try:
        return f"{float(v):.4f}"
    except (TypeError, ValueError):
        return (v or "").strip() or "—"


def task_table(task: str, rows: list[dict]) -> list[str]:
    cols = [c for c in HEADLINE.get(task, []) if c in rows[0]]
    if not cols:
        cols = _numeric_columns(rows)
    if not cols:
        return []
    rank_col = cols[0]

    def key(r):
        try:
            v = float(r.get(rank_col, "nan"))
        except (TypeError, ValueError):
            return float("inf")
        if v != v:  # NaN ranks last either direction
            return float("inf")
        return v if _lower_is_better(rank_col) else -v

    arrow = "↓" if _lower_is_better(rank_col) else "↑"
    lines = [f"## {task} (ranked by {rank_col} {arrow})", "",
             "| backbone | " + " | ".join(cols) + " |",
             "|---" * (len(cols) + 1) + "|"]
    for r in sorted(rows, key=key):
        lines.append("| " + _model_of(r) + " | "
                     + " | ".join(_fmt(r.get(c)) for c in cols) + " |")
    return lines + [""]


def overview_table(tables: dict[str, list[dict]]) -> list[str]:
    tasks = sorted(tables)
    rank_col = {}
    for t in tasks:
        cols = [c for c in HEADLINE.get(t, []) if c in tables[t][0]]
        cols = cols or _numeric_columns(tables[t])
        if cols:
            rank_col[t] = cols[0]
    tasks = [t for t in tasks if t in rank_col]
    # one overview row per backbone, merging CSV and log-recovered cells
    # (keys canonicalized by _overview_key; '†' marks recovered cells)
    keys: list[str] = []
    display: dict[str, str] = {}
    for t in tasks:
        for r in tables[t]:
            m = _model_of(r)
            k = _overview_key(m)
            if k not in display:
                keys.append(k)
                display[k] = m.replace(" †", "")
            elif "†" not in m and len(m) < len(display[k]):
                display[k] = m  # prefer the shortest non-recovered spelling
    any_recovered = any("†" in _model_of(r)
                        for t in tasks for r in tables[t])
    legend = ("; † = cell recovered from the driver log"
              if any_recovered else "")
    lines = [f"## Overview (headline metric per task{legend})", "",
             "| backbone | " + " | ".join(
                 f"{t}: {rank_col[t]}" for t in tasks) + " |",
             "|---" * (len(tasks) + 1) + "|"]
    for k in keys:
        cells = []
        for t in tasks:
            r = next((r for r in tables[t]
                      if _overview_key(_model_of(r)) == k), None)
            if r is None:
                cells.append("—")
            else:
                mark = "†" if "†" in _model_of(r) else ""
                cells.append(_fmt(r.get(rank_col[t])) + mark)
        lines.append(f"| {display[k]} | " + " | ".join(cells) + " |")
    return lines + [""]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv-dir", default="logs/suite_torch/csv")
    ap.add_argument("--out", default="logs/suite_torch/results_tables.md")
    ap.add_argument("--logs-dir", default=None,
                    help="per-cell log tree for metric recovery when a "
                         "cell's CSV row is missing (default: the parent "
                         "of --csv-dir); pass 'none' to disable")
    args = ap.parse_args(argv)

    by_task = discover(args.csv_dir)
    tables = {t: load_task(ps) for t, ps in sorted(by_task.items())}
    tables = {t: rows for t, rows in tables.items() if rows}

    logs_dir = args.logs_dir or os.path.dirname(
        args.csv_dir.rstrip("/")) or "."
    recovered: dict[str, int] = {}
    if logs_dir != "none":
        recovered = recover_from_logs(logs_dir, tables)
    if not tables:
        print(f"[aggregate] no task CSVs under {args.csv_dir} and no "
              f"recoverable cell logs under {logs_dir}")
        return 1

    lines = ["# Suite results — per-task backbone ranking tables", "",
             f"Assembled from the per-run CSV artifacts under "
             f"`{args.csv_dir}` (latest row per backbone; schemas match "
             "the reference's pipelines — see README 'Usage'). Synthetic "
             "data + random init unless real checkpoints were converted, "
             "so treat values as pipeline proof, not science.", ""]
    if recovered:
        n = sum(recovered.values())
        lines += [f"Rows marked **†** ({n} across "
                  f"{len(recovered)} tasks) had no archived CSV row (the "
                  "volatile /tmp output tree was lost to a host reboot "
                  "before the archive step); their headline metrics are "
                  f"recovered from the per-cell driver logs under "
                  f"`{logs_dir}/<task>/`.", ""]
    lines += overview_table(tables)
    for t, rows in tables.items():
        lines += task_table(t, rows)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"[aggregate] {sum(len(r) for r in tables.values())} backbone "
          f"rows across {len(tables)} tasks -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
