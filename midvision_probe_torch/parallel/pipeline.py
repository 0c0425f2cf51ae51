"""GPipe pipeline parallelism over ranks (counterpart of the JAX package's
``parallel/pipeline.py``).

The reference has no pipeline parallelism (SURVEY §2.6), and the probing
workload does not need it (frozen backbones, small probes). This is the
generic runner for a model that outgrows one card: stage ``r`` lives on
rank ``r`` of the group, activations move stage to stage by point-to-point
``send``/``recv``, and microbatches fill the pipeline GPipe-style (no
interleaving) over ``n_micro + n_stages - 1`` ticks. No driver uses it.

Every rank holds the whole input batch, as in the JAX runner, and every
rank returns the last stage's output for the whole batch (the JAX runner's
``psum``; here a broadcast from the last rank). Activations travel through
``multihost.comm_device()``: the card under NCCL, the host under gloo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from midvision_probe_torch.parallel.multihost import comm_device


def _global_rank(group, group_rank: int) -> int:
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def stage_params_sharding(stacked_params: dict, group=None) -> dict:
    """This rank's stage of a params dict whose tensors are stacked along a
    leading stage dimension (``(n_stages, ...)``): entry ``[rank]`` of each
    (the JAX ``stage_params_sharding`` lays the same stack over the
    pipeline axis)."""
    r = dist.get_rank(group)
    return {k: v[r] for k, v in stacked_params.items()}


def pipeline_apply(stage_fn, stage_params, x: torch.Tensor, n_micro: int | None = None,
                   group=None) -> torch.Tensor:
    """Run ``x`` through the group's ``n_stages`` sequential stages.

    Args:
        stage_fn: ``(params, activations) -> activations``, one stage; it
            keeps the activation's shape and dtype.
        stage_params: this rank's stage params (``stage_params_sharding``).
        x: the ``(B, ...)`` batch, the same on every rank.
        n_micro: microbatch count (default ``n_stages``), dividing B.
        group: the process group of the stages (default: the world).

    Returns the last stage's output for the whole batch, on every rank.
    At tick ``t`` stage ``s`` runs microbatch ``t - s``: it receives that
    microbatch from stage ``s - 1`` (which sent it at tick ``t - 1``),
    runs it, and sends it on to ``s + 1``; every send is matched by the
    next stage's receive of the following tick, so the schedule cannot
    deadlock.
    """
    n_stages = dist.get_world_size(group)
    sid = dist.get_rank(group)
    n_micro = n_micro or n_stages
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} is not divisible into {n_micro} microbatches")
    xs = x.reshape(n_micro, B // n_micro, *x.shape[1:])
    outs = torch.zeros_like(xs)
    comm = comm_device()
    sends = []
    for t in range(n_micro + n_stages - 1):
        m = t - sid
        if not 0 <= m < n_micro:
            continue
        if sid == 0:
            cur = xs[m]
        else:
            cur = torch.empty_like(xs[m], device=comm)
            dist.recv(cur, _global_rank(group, sid - 1), group=group)
            cur = cur.to(x.device)
        y = stage_fn(stage_params, cur)
        if sid == n_stages - 1:
            outs[m] = y
        else:
            y = y.to(comm).contiguous()
            sends.append((dist.isend(y, _global_rank(group, sid + 1), group=group), y))
    for work, _ in sends:
        work.wait()
    staged = outs.to(comm)
    dist.broadcast(staged, _global_rank(group, n_stages - 1), group=group)
    return staged.to(x.device).reshape(B, *x.shape[1:])
