"""Per-epoch checkpoint and exact resume (counterpart of the JAX package's
orbax ``engine/checkpoint.py``): the full trainer state (tap-norm + probe
parameters and BatchNorm statistics, optimizer and scheduler state, step)
goes through ``torch.save``; the two newest epochs are kept."""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^epoch_(\d+)\.pt$")
_KEEP = 2


def _epochs(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  if (m := _NAME.match(f)))


def save_checkpoint(ckpt_dir: str, state: dict, epoch: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"epoch_{epoch}.pt")
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"state": state, "epoch": epoch}, tmp)
    os.replace(tmp, path)
    for old in _epochs(ckpt_dir)[:-_KEEP]:
        os.remove(os.path.join(ckpt_dir, f"epoch_{old}.pt"))
    return path


def restore_checkpoint(ckpt_dir: str, map_location=None) -> tuple[dict, int] | None:
    """(state, epoch) of the newest checkpoint, or None if there is none."""
    epochs = _epochs(ckpt_dir)
    if not epochs:
        return None
    blob = torch.load(os.path.join(ckpt_dir, f"epoch_{epochs[-1]}.pt"),
                      map_location=map_location, weights_only=True)
    return blob["state"], int(blob["epoch"])
