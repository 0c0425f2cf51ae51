"""Observability sinks (copy of the JAX package's ``utils/logging.py``):
console + per-experiment ``training.log``, append-only CSV result rows, and
a no-op wandb stub when wandb is off or missing."""

from __future__ import annotations

import csv
import logging
import os
import sys
from typing import Any, Mapping


def setup_logger(exp_dir: str | None = None, name: str = "mvp_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if exp_dir:
        os.makedirs(exp_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(exp_dir, "training.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class CSVWriter:
    """Append rows to a CSV, creating the header on first write."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def append(self, row: Mapping[str, Any]) -> None:
        header = None
        if os.path.exists(self.path):
            with open(self.path, newline="") as f:
                header = next(csv.reader(f), None)
        if header is None:
            header = list(row.keys())
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=header)
                w.writeheader()
                w.writerow({k: row.get(k, "") for k in header})
            return
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=header, extrasaction="ignore")
            w.writerow({k: row.get(k, "") for k in header})


class _WandbStub:
    run = None

    def __bool__(self):
        # falsy so hot loops can guard ``if wandb:`` and skip a per-step
        # device-to-host loss copy for a no-op log
        return False

    def log(self, *a, **k):
        pass

    def finish(self, *a, **k):
        pass


def maybe_wandb(cfg) -> Any:
    use = bool(cfg.get_path("wandb.use", False)) if hasattr(cfg, "get_path") else False
    if not use:
        return _WandbStub()
    try:
        import wandb

        wandb.init(project=cfg.get_path("experiment_name", "midvision-probe"),
                   config=dict(cfg))
        return wandb
    except Exception as e:  # never let a half-working wandb kill a run
        logging.getLogger("mvp_torch").warning(
            "wandb.use=True but wandb init failed (%s: %s) — falling back to a "
            "no-op stub; nothing will be logged to W&B", type(e).__name__, e)
        return _WandbStub()
