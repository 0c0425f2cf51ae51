"""The torch meanings of the JAX package's mesh helpers
(``parallel/mesh.py``): one card per rank (the rank's device,
``cuda:{LOCAL_RANK}``, is ``utils/device.py::resolve_device``'s default
under a process group), the batch split over the ranks, the trained
parameters replicated.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from midvision_probe_torch.parallel import multihost


def check_num_devices(num_devices: int | None = -1) -> int:
    """``system.num_devices`` under ``torch.distributed``: ``-1`` (or 0,
    or None) means every rank; a positive count must equal the world size,
    one card per rank. Returns the world size. Anything else raises, as
    the JAX ``make_mesh`` refuses a count it cannot honour."""
    world = multihost.world_size()
    if num_devices and num_devices > 0 and num_devices != world:
        raise ValueError(
            f"system.num_devices={num_devices} with a world size of {world}: the port "
            "runs one card per rank; start num_devices ranks with torchrun "
            f"(torchrun --nproc_per_node={num_devices} -m midvision_probe_torch.<driver> ...) "
            "or use num_devices=-1 (every rank)")
    return world


@torch.no_grad()
def replicate(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Broadcast rank ``src``'s parameters and buffers to every rank (the
    JAX ``replicate``); the identity in one process."""
    if multihost.in_process_group():
        comm = multihost.comm_device()
        for t in list(module.parameters()) + list(module.buffers()):
            buf = t.detach().to(comm)
            dist.broadcast(buf, src)
            t.copy_(buf)
    return module


def shard_batch(batch: dict, device) -> dict:
    """The rank's local batch (its loader shard) on its device: the arrays
    of a loader batch as tensors on ``device``, other entries dropped."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}
