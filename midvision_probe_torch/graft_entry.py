"""Driver entry points of the port (counterpart of the repository's
``__graft_entry__.py``): the flagship forward for a one-card launch check,
and a dry run of one probe-training step over a ``(data, model)`` grid of
ranks.

* ``entry(device=None)`` -> ``(fn, example_args)``: DINO ViT-B/16's dense
  4-tap forward in bf16 at 480x640, batch 4, f32 maps out (the hot op of
  every probe trainer); on a card 12 launches of K1 a call (``wgmma``).
* ``dryrun_multichip(n_devices, device=None, preset="tiny")`` starts
  ``n_devices`` ranks (``python -m midvision_probe_torch.graft_entry
  --worker``), forms a ``(data, model)`` grid with ``model_par = 2`` when
  ``n_devices`` is even, and on every rank:

  - tensor parallelism over the rank's model group: ``TP_RULES`` (the JAX
    dry run's table, keyed by the last three names of a parameter, torch's
    ``weight`` read as flax's ``kernel``) shards each block's
    ``attn.qkv`` and ``mlp.fc1`` column-wise and ``attn.proj`` and
    ``mlp.fc2`` row-wise. q, k and v split by heads, so the rank's
    ``(B, N, 3, H/model_par, d)`` projection goes straight into K1; the
    row-parallel partial sums are all-reduced over the model group and
    each bias added once. A rule that matches no parameter raises;
  - data parallelism over the rank's data group: its slice of the global
    batch, the loss and BatchNorm sums and the gradients summed over the
    group (``parallel/multihost.py``);
  - one step of TapNorms + DPT ``DepthHead`` + ``depth_loss`` + AdamW on
    seeded inputs: ``test_tiny_vit`` at 32² (``preset="tiny"``) or
    ``dino_vitb16`` at 480² (``"vitb"``), the backbone in float32 as in the
    JAX dry run;
  - sharded matching: the queries split over every rank, ``ops/matching.knn2``
    (K4 on a card) against the whole target, gathered and held to the
    unsharded call;
  - the GPipe runner (``parallel/pipeline.py``) over the model group,
    held to the sequential stages.

  Backend: NCCL when every rank has a card of its own; gloo when ranks
  outnumber the cards (they share them, every collective staged through
  the host) or on the CPU. The summary line says which. Without a card a
  device must be given (``device="cpu"``), else it raises before any rank
  starts.

Tensor parallelism exists only here, as in the JAX package: no driver has a
model axis.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from midvision_probe_torch.launch.time_suite import Steps, build_probe
from midvision_probe_torch.models.zoo import build_vit_extractor
from midvision_probe_torch.ops.matching import knn2
from midvision_probe_torch.ops.vit_attention import fused_qkv_attention
from midvision_probe_torch.parallel import multihost
from midvision_probe_torch.parallel.pipeline import pipeline_apply, stage_params_sharding
from midvision_probe_torch.utils.device import full_f32, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device=None, *, model: str = "dino_vitb16", batch: int = 4, hw=(480, 640)):
    """``(fn, example_args)``: ``fn(*example_args)`` is the frozen ViT's
    dense 4-tap forward in bf16, each map returned in float32. ``model``,
    ``batch`` and ``hw`` shrink it for a check on the CPU."""
    backbone = build_vit_extractor(model, output="dense", return_multilayer=True,
                                   dtype=torch.bfloat16, init_size=224, device=device)

    def forward(extractor, images):
        return [m.float() for m in extractor.features(images)]

    example = torch.zeros((batch, *hw, 3), dtype=torch.float32, device=backbone.device)
    return forward, (backbone, example)


# ---------------------------------------------------------------- the step
@dataclasses.dataclass(frozen=True)
class Preset:
    model: str
    hw: int
    hidden_dim: int
    per_data_rank: int  # images a data rank holds


PRESETS = {"tiny": Preset("test_tiny_vit", 32, 32, 2),
           "vitb": Preset("dino_vitb16", 480, 64, 1)}
ADAMW_LR = 1e-4


def grid(n_devices: int) -> tuple[int, int]:
    """(data_par, model_par) of ``n_devices`` ranks."""
    model_par = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // model_par, model_par


def dry_inputs(preset: str, data_par: int) -> tuple[np.ndarray, np.ndarray]:
    """The global batch: seeded images in [0, 1) and depths in [1, 10)."""
    p = PRESETS[preset]
    rng = np.random.RandomState(0)
    shape = (data_par * p.per_data_rank, p.hw, p.hw)
    images = rng.rand(*shape, 3).astype(np.float32)
    depth = (rng.rand(*shape, 1) * 9 + 1).astype(np.float32)
    return images, depth


def build(preset: str, device, n_devices: int, state: dict | None = None) -> Steps:
    """The dry run's step of a preset: the float32 backbone, TapNorms and
    the DPT head (``time_suite.build_probe``) with AdamW(1e-4), and the
    global batch of ``n_devices`` ranks on ``device``. Seeded random
    weights, or ``state`` (``{"backbone": ViT state_dict, "trainer": tap +
    probe state_dict}``)."""
    p = PRESETS[preset]
    bb = build_vit_extractor(p.model, output="dense", return_multilayer=True,
                             init_size=p.hw, device=device)
    modules, opt = build_probe(bb.feat_dim, "dpt", p.hidden_dim, lr=ADAMW_LR, device=device)
    if state is not None:
        bb.module.load_state_dict(state["backbone"])
        modules.load_state_dict(state["trainer"])
    images, depth = dry_inputs(preset, grid(n_devices)[0])
    return Steps(bb, modules, opt, torch.from_numpy(images).to(device),
                 torch.from_numpy(depth).to(device))


def train_step(steps: Steps, rows: slice = slice(None), data_group=None) -> torch.Tensor:
    """The JAX dry run's ``train_step`` on the batch's ``rows``: frozen
    float32 features, then ``Steps.probe_step`` with the batch global over
    ``data_group``; in float32 throughout (no TF32 on a card), so the
    sharded and unsharded steps differ by their summation order alone."""
    images, depth = steps.images[rows], steps.depth[rows]
    with full_f32():
        return steps.probe_step(steps.backbone.features(images), depth, data_group)


def _step_state(steps: Steps) -> dict:
    return {"params": {k: v.detach().cpu() for k, v in steps.modules.state_dict().items()},
            "grads": {k: v.grad.cpu() for k, v in steps.modules.named_parameters()
                      if v.grad is not None}}


def reference_step(preset: str = "tiny", n_devices: int = 4, device=None,
                   state: dict | None = None) -> dict:
    """The dry run's step unsharded in this process, on the same weights and
    the whole global batch: ``{"loss", "params", "grads"}``."""
    steps = build(preset, resolve_device(device), n_devices, state)
    return {"loss": float(train_step(steps)), **_step_state(steps)}


# ------------------------------------------------------ tensor parallelism
# (module scope, submodule, leaf) -> "col" (output dim), "row" (input dim)
# or "vec" (the bias of a column-sharded layer); the JAX dry run's keys
TP_RULES = {
    ("attn", "qkv", "kernel"): "col",
    ("attn", "qkv", "bias"): "vec",
    ("attn", "proj", "kernel"): "row",
    ("mlp", "fc1", "kernel"): "col",
    ("mlp", "fc1", "bias"): "vec",
    ("mlp", "fc2", "kernel"): "row",
}
_FLAX_LEAF = {"weight": "kernel"}


def tp_plan(module: nn.Module) -> dict[str, str]:
    """Parameter name -> rule kind for every parameter a rule matches.
    Raises when a rule matches none: a renamed parameter must not leave
    its layer silently replicated."""
    plan, matched = {}, dict.fromkeys(TP_RULES, 0)
    names = [name for name, _ in module.named_parameters()]
    for name in names:
        parts = name.split(".")
        key = (*parts[-3:-1], _FLAX_LEAF.get(parts[-1], parts[-1]))
        if key in TP_RULES:
            plan[name] = TP_RULES[key]
            matched[key] += 1
    missing = [k for k, n in matched.items() if n == 0]
    if missing:
        raise RuntimeError(f"tp dry run matched no params for rules {missing} — param "
                           f"tree paths changed? (tree has {len(names)} leaves)")
    return plan


class _RowParallelLinear(nn.Module):
    """A linear layer whose input dim is sharded over ``group``: the partial
    product all-reduced over the group, then the bias added once."""

    def __init__(self, linear: nn.Linear, group):
        super().__init__()
        self.weight, self.bias, self.group = linear.weight, linear.bias, group

    def forward(self, x):
        y = multihost.all_reduce(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


class _TPAttention(nn.Module):
    """A block's attention on this rank's heads: its slice of the qkv
    projection, ``(B, N, 3, heads, d)``, straight into K1, then the
    row-parallel output projection."""

    def __init__(self, attn: nn.Module, heads: int):
        super().__init__()
        self.qkv, self.proj, self.heads = attn.qkv, attn.proj, heads
        self.head_dim = attn.cfg.head_dim
        self.qkv_shape = None  # the last launch's, for reports

    def forward(self, x, pos_2d=None, grid_hw=None):
        B, N, _ = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, self.head_dim)
        self.qkv_shape = tuple(qkv.shape)
        return self.proj(fused_qkv_attention(qkv, self.head_dim**-0.5))


def shard_tensor_parallel(vit: nn.Module, rank: int, model_par: int, group) -> list:
    """Shard ``vit`` in place for model rank ``rank`` of ``model_par`` by
    ``tp_plan``; returns the tensor-parallel attention modules."""
    plan = tp_plan(vit)
    params = dict(vit.named_parameters())
    with torch.no_grad():
        for name, kind in plan.items():
            p = params[name]
            if kind == "row":
                part = p.chunk(model_par, dim=1)[rank]
            elif name.split(".")[-2] == "qkv":  # fused (q, k, v): by heads in each
                part = p.reshape(3, -1, *p.shape[1:]).chunk(model_par, dim=1)[rank]
                part = part.reshape(-1, *p.shape[1:])
            else:
                part = p.chunk(model_par, dim=0)[rank]
            p.data = part.contiguous()
    attns = []
    for name, kind in plan.items():
        if kind != "row":
            continue
        owner, _ = name.rsplit(".", 1)  # e.g. blocks.3.attn.proj
        parent_name, child = owner.rsplit(".", 1)
        parent = vit.get_submodule(parent_name)
        setattr(parent, child, _RowParallelLinear(getattr(parent, child), group))
    for blk in vit.blocks:
        if not blk.attn.fused:
            raise ValueError("the tensor-parallel dry run needs the fused K1 branch")
        blk.attn = _TPAttention(blk.attn, blk.attn.cfg.num_heads // model_par)
        attns.append(blk.attn)
    return attns


# --------------------------------------------------------------- the ranks
def _rank_main(cfg: dict) -> None:
    """One rank of the dry run; writes its results to ``cfg["out"]``."""
    from midvision_probe_torch.ops import vit_attention

    rank, n = cfg["rank"], cfg["world_size"]
    if cfg["device"] == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    multihost.initialize(init_method=cfg["init_method"], world_size=n, rank=rank,
                         device=device, backend=cfg["backend"])
    data_par, model_par = grid(n)
    d, m = divmod(rank, model_par)
    # every rank creates every group, in one order
    model_groups = [dist.new_group([dd * model_par + mm for mm in range(model_par)])
                    for dd in range(data_par)]
    data_groups = [dist.new_group([dd * model_par + mm for dd in range(data_par)])
                   for mm in range(model_par)]
    model_group, data_group = model_groups[d], data_groups[m]

    state = torch.load(cfg["state"]) if cfg["state"] else None
    steps = build(cfg["preset"], device, n, state)
    attns = []
    if model_par > 1:
        attns = shard_tensor_parallel(steps.backbone.module, m, model_par, model_group)
    b = PRESETS[cfg["preset"]].per_data_rank
    k1_before = fused_qkv_attention.launches
    routes_before = dict(vit_attention.route_launches)
    loss = train_step(steps, slice(d * b, (d + 1) * b), data_group)
    k1 = fused_qkv_attention.launches - k1_before
    routes = {k: v - routes_before[k] for k, v in vit_attention.route_launches.items()}

    # sharded matching: the queries over every rank, the whole target each
    per = 16
    qf = np.random.RandomState(0).randn(per * n, 32).astype(np.float32)
    tf = torch.from_numpy(np.random.RandomState(1).randn(64, 32).astype(np.float32)).to(device)
    k4_before = knn2.launches
    dists, idx = knn2(torch.from_numpy(qf[rank * per:(rank + 1) * per]).to(device), tf,
                      metric="euclidean")
    g_dists = multihost._all_gather(dists.cpu().numpy()).reshape(-1, 2)
    g_idx = multihost._all_gather(idx.cpu().numpy()).reshape(-1, 2)
    k4 = knn2.launches - k4_before
    ref_d, ref_i = knn2(torch.from_numpy(qf).to(device), tf, metric="euclidean")
    matching = {"idx_equal": bool((g_idx == ref_i.cpu().numpy()).all()),
                "max_dist_err": float(np.abs(g_dists - ref_d.cpu().numpy()).max()),
                "launches_sharded": k4, "query_rows": per}

    # the GPipe runner over the model group
    pipeline = None
    if model_par > 1:
        rs = np.random.RandomState(2)
        d_pp = 16
        stacked = {"w": torch.from_numpy(rs.randn(model_par, d_pp, d_pp).astype(np.float32)
                                         * np.float32(0.3)).to(device),
                   "b": torch.zeros((model_par, d_pp), device=device)}

        def stage_fn(p, h):
            return h + torch.tanh(h @ p["w"] + p["b"])

        xp = torch.from_numpy(rs.randn(4 * model_par, d_pp).astype(np.float32)).to(device)
        got = pipeline_apply(stage_fn, stage_params_sharding(stacked, model_group), xp,
                             n_micro=model_par, group=model_group)
        ref = xp
        for s in range(model_par):
            ref = stage_fn({"w": stacked["w"][s], "b": stacked["b"][s]}, ref)
        pipeline = {"max_err": float((got - ref).abs().max()), "stages": model_par}

    torch.save({"rank": rank, "loss": float(loss), "k1": k1, "routes": routes,
                "k1_qkv_shape": attns[0].qkv_shape if attns else None,
                "matching": matching, "pipeline": pipeline,
                "all_reduce": multihost.counts["all_reduce"], **_step_state(steps)},
               cfg["out"])
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None, preset: str = "tiny",
                     state: dict | None = None, timeout_s: float = 900.0) -> dict:
    """Run the dry run on ``n_devices`` ranks and return ``{"backend",
    "world_size", "mesh", "mode", "loss", "ranks"}`` (each rank's loss,
    updated parameters, launch counts, matching and pipeline errors);
    raises when a rank fails or the checks do not hold."""
    if preset not in PRESETS:
        raise ValueError(f"preset {preset!r} not in {sorted(PRESETS)}")
    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and n_devices <= cards:
        backend, mode = "nccl", f"NCCL, one card a rank ({n_devices} of {cards})"
    elif dev.type == "cuda":
        backend = "gloo"
        mode = (f"gloo, {n_devices} ranks sharing {cards} card(s), every collective "
                "staged through the host")
    else:
        backend, mode = "gloo", f"gloo, {n_devices} ranks on the CPU"
    data_par, model_par = grid(n_devices)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mvp_dryrun_") as tmp:
        state_path = ""
        if state is not None:
            state_path = os.path.join(tmp, "state.pt")
            torch.save(state, state_path)
        init = f"tcp://localhost:{_free_port()}"
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        if dev.type == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs, logs = [], []
        for r in range(n_devices):
            cfg = {"rank": r, "world_size": n_devices, "init_method": init,
                   "device": dev.type, "backend": backend, "preset": preset,
                   "state": state_path, "out": os.path.join(tmp, f"rank{r}.pt")}
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "midvision_probe_torch.graft_entry", "--worker",
                 json.dumps(cfg)], stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
        try:
            deadline = time.monotonic() + timeout_s
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            log = logs[failed[0]]
            log.seek(0)
            tail = "".join(log.readlines()[-30:])
            raise RuntimeError(f"dry run rank {failed[0]} of {n_devices} exited "
                               f"{procs[failed[0]].returncode}:\n{tail}")
        for log in logs:
            log.close()
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(n_devices)]

    losses = [r["loss"] for r in ranks]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"multichip dry run produced non-finite losses {losses}")
    if max(losses) != min(losses):
        raise RuntimeError(f"the ranks' losses differ: {losses}")
    for r in ranks:
        mt = r["matching"]
        if not mt["idx_equal"] or mt["max_dist_err"] > 1e-6:
            raise RuntimeError(f"rank {r['rank']}: sharded matching differs from the "
                               f"unsharded call ({mt})")
        if r["pipeline"] is not None and r["pipeline"]["max_err"] > 1e-4:
            raise RuntimeError(f"rank {r['rank']}: pipeline differs from the sequential "
                               f"stages ({r['pipeline']})")
    mesh = {"data": data_par, "model": model_par}
    print(f"dryrun_multichip({n_devices}): loss={losses[0]:.4f} mesh={mesh} "
          f"backend={backend} world_size={n_devices} ({mode}) "
          f"+ sharded-matching + pipeline OK", flush=True)
    return {"backend": backend, "world_size": n_devices, "mesh": mesh, "mode": mode,
            "loss": losses[0], "wall_s": time.perf_counter() - t0, "ranks": ranks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dryrun", type=int, default=None, metavar="N",
                    help="run the dry run on N ranks")
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--device", default=None, help="cpu runs the ranks on the CPU")
    args = ap.parse_args(argv)
    if args.worker is not None:
        _rank_main(json.loads(args.worker))
        return 0
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, device=args.device, preset=args.preset)
        return 0
    fn, example = entry(device=args.device)
    maps = fn(*example)
    print(f"entry(): {len(maps)} maps {[tuple(m.shape) for m in maps]} "
          f"finite={all(bool(torch.isfinite(m).all()) for m in maps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
