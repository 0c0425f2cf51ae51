"""Per-epoch checkpoint and exact resume (counterpart of the JAX package's
orbax ``engine/checkpoint.py``): the full trainer state (tap-norm + probe
parameters and BatchNorm statistics, optimizer and scheduler state, step)
goes through ``torch.save``; the two newest epochs are kept. Rank 0
writes them; every rank restores."""

from __future__ import annotations

import os
import re

import torch

from midvision_probe_torch.parallel import multihost

_NAME = re.compile(r"^epoch_(\d+)\.pt$")
_KEEP = 2


def _epochs(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  if (m := _NAME.match(f)))


def save_checkpoint(ckpt_dir: str, state: dict, epoch: int) -> str:
    """Write epoch ``epoch``'s state and prune to the two newest. Under a
    process group every rank calls it, as every rank calls the JAX save:
    rank 0 writes and prunes (the ranks hold the same state), and the
    others wait at a barrier until it is done, so no rank races another's
    pruning or reads a half-written file."""
    path = os.path.join(ckpt_dir, f"epoch_{epoch}.pt")
    if multihost.is_main_process():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save({"state": state, "epoch": epoch}, tmp)
        os.replace(tmp, path)
        for old in _epochs(ckpt_dir)[:-_KEEP]:
            os.remove(os.path.join(ckpt_dir, f"epoch_{old}.pt"))
    multihost.barrier()
    return path


def restore_checkpoint(ckpt_dir: str, map_location=None) -> tuple[dict, int] | None:
    """(state, epoch) of the newest checkpoint, or None if there is none."""
    epochs = _epochs(ckpt_dir)
    if not epochs:
        return None
    blob = torch.load(os.path.join(ckpt_dir, f"epoch_{epochs[-1]}.pt"),
                      map_location=map_location, weights_only=True)
    return blob["state"], int(blob["epoch"])
