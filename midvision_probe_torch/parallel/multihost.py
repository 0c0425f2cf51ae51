"""Multi-process plumbing over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/multihost.py``).

* ``initialize()`` joins the process group from the ``torchrun``
  environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``) or from explicit arguments, which win. A single process
  is a no-op, decided from the arguments and the environment alone: no
  CUDA query and no backend call comes before ``init_process_group``
  (on a host of several cards an early CUDA call can bind the wrong one).
  NCCL when the rank's device is a card, gloo when it is the CPU; or the
  backend asked for (gloo for ranks that share one card).
* ``process_shard_args()``: the loader's ``num_shards``/``shard_index``,
  the ``DistributedSampler`` equivalent.
* ``gather_metrics`` / ``gather_rows``: every rank's rows in rank order,
  on every rank; the identity in one process.
* The global batch of a training step: inside ``global_batch()``,
  ``batch_sum`` (a loss's sums and counts) and ``batch_stat_sum`` (a
  BatchNorm's sums) all-reduce over the ranks (or over the group given,
  a data-parallel group of a larger grid), so the step computes what one
  process computes on the concatenated batch. ``all_reduce_grads`` then
  sums the per-rank gradients.

Every all-reduce is counted in ``counts["all_reduce"]``. A tensor that does
not live on ``comm_device()`` (a card's tensor under gloo) is staged
through it.
"""

from __future__ import annotations

import contextlib
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from midvision_probe_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

_initialized = False
_global_batch = False  # set inside global_batch()
_group = None  # the group of the global batch (None: every rank)
counts = {"all_reduce": 0}


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, local_rank: int | None = None,
               device=None, backend: str | None = None) -> None:
    """Join the process group exactly once.

    Resolution order: explicit arguments > the ``torchrun`` environment >
    single-process no-op. ``device`` is the rank's device (default
    ``cuda:{LOCAL_RANK}``); without a card and without a device this
    raises rather than falling back to gloo on the CPU. ``backend``
    (default NCCL on a card, gloo on the CPU): gloo on a card stages every
    collective through the host, for ranks that share a card."""
    global _initialized
    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if init_method is None and world_size in (None, 1):
        # one process: nothing to join (decided without touching CUDA)
        _initialized = True
        return
    rank = rank if rank is not None else _env_int("RANK")
    local = local_rank if local_rank is not None else _env_int("LOCAL_RANK")
    dev = resolve_device(device)  # without a device and a card: raise
    if device is None:  # the rank's card
        dev = torch.device("cuda", local if local is not None else (rank or 0))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kwargs)
    _initialized = True
    log.info("torch.distributed initialized: rank %d/%d on %s (%s)",
             dist.get_rank(), dist.get_world_size(), dev, backend)


def in_process_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if in_process_group() else 1


def rank() -> int:
    return dist.get_rank() if in_process_group() else 0


def is_main_process() -> bool:
    """Rank 0, the one that writes the CSV and talks to wandb."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank; a no-op outside a process group."""
    if in_process_group():
        dist.barrier()


def process_shard_args() -> dict:
    """Loader kwargs for this rank's data shard (``DistributedSampler``)."""
    return {"num_shards": world_size(), "shard_index": rank()}


def comm_device() -> torch.device:
    """Where collective buffers live: the rank's card under NCCL, else the
    CPU."""
    if in_process_group() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (default: every rank), staged
    through ``comm_device()`` when ``t`` lives elsewhere."""
    counts["all_reduce"] += 1
    comm = comm_device()
    if t.device == comm:
        dist.all_reduce(t, group=group)
        return t
    staged = t.to(comm)
    dist.all_reduce(staged, group=group)
    return t.copy_(staged)


class _SumReplicated(torch.autograd.Function):
    """All-reduce whose result feeds only computation that every rank
    repeats alike (a loss from global sums): each rank's partial
    derivative is its own, so the backward is the identity."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce(t.clone(), _group)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _SumToRanks(torch.autograd.Function):
    """All-reduce whose result feeds each rank's own rows (a BatchNorm's
    statistics): every rank's rows depend on every rank's inputs, so the
    backward sums the incoming gradients over the ranks of the forward's
    group, wherever the backward runs."""

    @staticmethod
    def forward(ctx, t):
        ctx.group = _group
        return all_reduce(t.clone(), _group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group)


@contextlib.contextmanager
def global_batch(group=None):
    """Make ``batch_sum`` and ``batch_stat_sum`` sum over ``group`` (default:
    every rank; a no-op outside a process group): the training step's
    global batch."""
    global _global_batch, _group
    prev = _global_batch, _group
    _global_batch, _group = in_process_group(), group
    try:
        yield
    finally:
        _global_batch, _group = prev


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks inside ``global_batch()``, else ``t``.
    For the sums and counts of a loss."""
    return _SumReplicated.apply(t) if _global_batch else t


def batch_stat_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks inside ``global_batch()``, else ``t``.
    For the sums of a BatchNorm's batch statistics."""
    return _SumToRanks.apply(t) if _global_batch else t


def all_reduce_grads(params, group=None) -> None:
    """Sum the gradients of ``params`` over ``group`` (default: every rank;
    one all-reduce of one flat buffer); a no-op outside a process group."""
    if not in_process_group():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _all_gather(arr: np.ndarray) -> np.ndarray:
    """``(P, *arr.shape)``: every rank's equally shaped array, in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.uint8) if arr.dtype == bool
                                              else arr)).to(comm_device())
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t)
    out = torch.stack(parts).cpu().numpy()
    return out.astype(bool) if arr.dtype == bool else out


def gather_metrics(metrics: dict) -> dict:
    """Concatenate per-sample metric arrays over the ranks, in rank order,
    on every rank. Ranks may hold different row counts (``validate`` drops
    a shard's wrapped repeats): one gather of the lengths, the arrays
    padded to the longest, gathered, and trimmed."""
    if world_size() == 1:
        return {k: np.asarray(v) for k, v in metrics.items()}
    lens = {np.asarray(v).shape[0] for v in metrics.values()}
    if len(lens) > 1:
        raise ValueError(f"per-key row counts differ: {sorted(lens)}")
    n_local = lens.pop() if lens else 0
    ns = _all_gather(np.asarray([n_local], np.int64)).reshape(-1)
    m = int(ns.max())
    out = {}
    for k, v in metrics.items():
        v = np.asarray(v)
        padded = np.zeros((m,) + v.shape[1:], v.dtype)
        padded[: v.shape[0]] = v
        g = _all_gather(padded)
        out[k] = np.concatenate([g[p, : ns[p]] for p in range(g.shape[0])])
    return out


def gather_rows(rows: list, keys: tuple) -> list:
    """Gather lists of flat numeric dicts over the ranks, in rank order, on
    every rank. ``keys`` fixes the schema, so a rank with no rows still
    takes part. The identity in one process."""
    if world_size() == 1:
        return rows
    arr = np.asarray([[float(r[k]) for k in keys] for r in rows],
                     np.float64).reshape(len(rows), len(keys))
    ns = _all_gather(np.asarray([arr.shape[0]], np.int64)).reshape(-1)
    padded = np.zeros((int(ns.max()), len(keys)), np.float64)
    padded[: arr.shape[0]] = arr
    g = _all_gather(padded)
    return [dict(zip(keys, row.tolist())) for p in range(g.shape[0]) for row in g[p, : ns[p]]]
