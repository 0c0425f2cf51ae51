"""Per-step probe-training costs on the card and the projected wall-clock
of the full 20-backbone x 6-task suite (counterpart of the repository's
``launch_script/time_suite.py``).

The reference protocol (``configs/depth_training.yaml`` + ``ten_epoch.yaml``):
batch 16 per GPU x 2 = 32 global, 10 epochs over NYU GeoNet (~24.2k images,
~757 steps an epoch), the DPT probe on 4 frozen taps. Each backbone is timed
three ways at batch 32 and 480x480: the bf16 extraction, the probe step on
cached features (what ``system.cache_features`` leaves of epochs 2-10) and
the full step (extraction + probe step). The backbone runs in bf16 in every
variant (its attention on kernel K1, ``wgmma``); only the probe's dtype
changes.

Usage::

    python -m midvision_probe_torch.launch.time_suite                 # on the card
    python -m midvision_probe_torch.launch.time_suite --device cpu --batch 2 --size 32 \\
        --backbones test_tiny_vit --out logs/suite_torch/suite_timing_cpu.md

Writes a markdown table and the projection; ``--cards N`` (default 4)
divides the one-card suite time by N, a data-parallel projection, not a
measurement.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

import numpy as np
import torch
import torch.nn as nn

from midvision_probe_torch.launch.suite_run import card_name
from midvision_probe_torch.launch.sweep import require_device
from midvision_probe_torch.models import zoo
from midvision_probe_torch.models.probes import DepthHead, TapNorms, _channels, init_probe_
from midvision_probe_torch.ops.image import resize
from midvision_probe_torch.parallel import multihost
from midvision_probe_torch.utils.device import resolve_device, resolve_dtype
from midvision_probe_torch.utils.losses import depth_loss
from midvision_probe_torch.utils.profiling import time_fn

# reference suite geometry
STEPS_PER_EPOCH = 757      # ~24.2k NYU GeoNet images / batch 32
N_EPOCHS = 10
N_BACKBONES = 20
OBJECTNESS_STEPS = 200     # VOC objectness steps an epoch
# tasks: depth + snorm (trained probes), objectness (VOC), and the eval-only
# spair/navi/scannet/percepture (feature-extraction bound)
EVAL_IMAGES = {"spair": 2 * 700, "navi": 2 * 1000, "scannet": 2 * 1500,
               "percepture": 3 * 1800}
# (head, probe dtype): the JAX script's variants; ResNets skip the f32 probe
VARIANTS = (("dpt", "float32"), ("dpt", "bfloat16"), ("linear", "bfloat16"))
ADAMW_LR = 5e-4
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


def variant_tag(name: str, head: str, probe_dtype: str) -> str:
    return f"{name}/{head}-{probe_dtype.replace('float', 'f')}"


@dataclasses.dataclass
class Steps:
    """One backbone's three timed functions on seeded inputs.

    ``extract(images)`` is the bf16 features; ``probe_step(feats, depth)``
    and ``full_step(images, depth)`` take one AdamW step of the tap norms
    and the probe (the step of the JAX script's ``probe_step``) and return
    the loss. Given a ``data_group``, ``probe_step``'s batch is global over
    that group of ranks: the loss and BatchNorm sums and the gradients are
    summed over it (``parallel/multihost.py``)."""

    backbone: object
    modules: nn.ModuleDict  # {"tap": TapNorms, "probe": DepthHead}
    optimizer: torch.optim.Optimizer
    images: torch.Tensor
    depth: torch.Tensor

    def extract(self, images: torch.Tensor) -> list[torch.Tensor]:
        return [f.to(torch.bfloat16) for f in self.backbone.features(images)]

    def probe_step(self, feats: list[torch.Tensor], depth: torch.Tensor,
                   data_group=None) -> torch.Tensor:
        self.modules.train()
        self.optimizer.zero_grad(set_to_none=True)
        with multihost.global_batch(data_group):
            pred = self.modules["probe"](self.modules["tap"]([f.float() for f in feats]))
            pred = resize(pred, depth.shape[1:3], mode="bilinear")
            loss = depth_loss(pred, depth)
            loss.backward()
        multihost.all_reduce_grads(self.modules.parameters(), data_group)
        self.optimizer.step()
        return loss.detach()

    def full_step(self, images: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        return self.probe_step(self.extract(images), depth)

    def graphed_probe_step(self, feats: list[torch.Tensor], depth: torch.Tensor):
        """``probe_step`` recorded once as a CUDA graph on ``feats`` and
        ``depth`` (after two eager steps on a side stream) and replayed at
        each call: one launch a step, as the JAX script's jitted step is
        one dispatch. Eagerly the linear probe's step issues hundreds of kernels
        whose host time is about their device time (``PERF.md``), so its
        time would follow the host's load. Returns ``step(feats, depth)``,
        which copies inputs other than the recorded ones into them first
        and returns the recorded loss. AdamW runs ``capturable`` (its step
        counts and bias corrections on the card), which rounds apart from
        the default AdamW; the replay equals the eager step with it."""
        for group in self.optimizer.param_groups:
            group["capturable"] = True
        for state in self.optimizer.state.values():
            if "step" in state:
                state["step"] = state["step"].to(depth.device)
        feats, side = list(feats), torch.cuda.Stream(depth.device)
        side.wait_stream(torch.cuda.current_stream(depth.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self.probe_step(feats, depth)
        torch.cuda.current_stream(depth.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            loss = self.probe_step(feats, depth)

        def step(new_feats: list[torch.Tensor], new_depth: torch.Tensor) -> torch.Tensor:
            for dst, src in zip((*feats, depth), (*new_feats, new_depth)):
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
            graph.replay()
            return loss

        return step


def build_probe(feat_dim, head_type: str = "dpt", hidden_dim: int = 512,
                probe_dtype="float32", lr: float = ADAMW_LR, device=None,
                seed: int = 0) -> tuple[nn.ModuleDict, torch.optim.Optimizer]:
    """``{"tap": TapNorms, "probe": DepthHead}`` on the taps ``feat_dim``
    (a bindepth head, kernel 1 for ``linear``, else 3), seeded, with
    AdamW(``lr``)."""
    # one entry a tap: a width, or a ResNet's (C, hw) pair (alone without
    # multilayer, so listed)
    dims = feat_dim if isinstance(feat_dim, list) else [feat_dim]
    # kernel 3 is the paper's DPT protocol (configs/probe/depth_dpt.yaml);
    # the linear preset uses the reference Linear's default k = 1
    probe = DepthHead(feat_dim=dims, head_type=head_type, prediction_type="bindepth",
                      kernel_size=1 if head_type == "linear" else 3,
                      hidden_dim=hidden_dim, dtype=resolve_dtype(probe_dtype))
    modules = nn.ModuleDict({"tap": TapNorms(_channels(dims)), "probe": probe})
    gen = torch.Generator().manual_seed(seed)
    for m in modules.values():
        init_probe_(m, gen)
    modules.to(resolve_device(device))
    optimizer = torch.optim.AdamW(modules.parameters(), lr=lr, eps=1e-8,
                                  weight_decay=ADAMW_WEIGHT_DECAY)
    return modules, optimizer


def build_steps(name: str, batch: int, hw=(480, 480), head_type: str = "dpt",
                probe_dtype="float32", hidden_dim: int = 512, device=None,
                seed: int = 0) -> Steps:
    """The backbone ``name`` (the port's zoo, seeded random weights unless
    ``$MVP_CHECKPOINT_DIR`` holds its file) in bf16, ``TapNorms`` and a
    bindepth ``DepthHead`` (``build_probe``) with AdamW(5e-4), and the JAX
    script's inputs (``np.random.RandomState(0)``). Nothing is
    timed."""
    device = resolve_device(device)
    multilayer = head_type != "linear"  # linear probes read one tap
    if zoo.ZOO[name].arch == "resnet":
        # reference backbone configs pick stages [1,2,3,4] for probing
        bb = zoo.build_resnet_extractor(name, return_multilayer=multilayer,
                                        return_layers=[1, 2, 3, 4],
                                        dtype=torch.bfloat16, device=device)
    else:
        bb = zoo.build_vit_extractor(name, return_multilayer=multilayer,
                                     dtype=torch.bfloat16, init_size=224, device=device)
    modules, optimizer = build_probe(bb.feat_dim, head_type, hidden_dim, probe_dtype,
                                     device=device, seed=seed)

    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(batch, *hw, 3).astype(np.float32)).to(device)
    depth = torch.from_numpy(rng.rand(batch, *hw, 1).astype(np.float32) * 9 + 1).to(device)
    return Steps(bb, modules, optimizer, images, depth)


def time_steps(steps: Steps, iters: int = 10) -> dict:
    """Seconds per call of the extraction, the probe step and the full step
    (``utils/profiling.time_fn``: one warm-up call, then ``iters`` calls,
    each waited for), and the last probe-step and full-step losses. On the
    card the probe step is ``Steps.graphed_probe_step``'s replay (the full
    step: the extraction, then that replay); on the CPU it runs eagerly."""
    def seconds(fn, *args):
        return time_fn(fn, *args, warmup=1, iters=iters)["mean_ms"] / 1e3

    t_extract = seconds(steps.extract, steps.images)
    feats = steps.extract(steps.images)
    probe = (steps.graphed_probe_step(feats, steps.depth) if steps.depth.is_cuda
             else steps.probe_step)

    def full(images, depth):
        return probe(steps.extract(images), depth)

    t_probe = seconds(probe, feats, steps.depth)
    probe_loss = float(probe(feats, steps.depth))
    t_full = seconds(full, steps.images, steps.depth)
    full_loss = float(full(steps.images, steps.depth))
    return {"extract_s": t_extract, "probe_s": t_probe, "full_s": t_full,
            "probe_loss": probe_loss, "full_loss": full_loss}


def measure_backbone(name: str, batch: int, hw=(480, 480), head_type: str = "dpt",
                     probe_dtype="float32", hidden_dim: int = 512, device=None):
    """(extract, probe step, full step) seconds of backbone ``name``."""
    t = time_steps(build_steps(name, batch, hw, head_type, probe_dtype, hidden_dim, device))
    return t["extract_s"], t["probe_s"], t["full_s"]


def project_suite(rows, batch: int) -> dict:
    """The JAX script's suite projection from ``(tag, extract_s, probe_s,
    full_s)`` rows: per variant the mean over backbones stands for the
    fleet; the cached schedule runs full steps in epoch 1 and probe steps
    after; the eval tasks are extraction-bound. Seconds on one card."""
    def fleet(head, pdt):
        sel = [r for r in rows if f"/{head}-{pdt}" in r[0]]
        return tuple(float(np.mean([r[i] for r in sel])) if sel else math.nan
                     for i in (1, 2, 3))

    te, tp, tf = fleet("dpt", "bf16")
    total_steps = STEPS_PER_EPOCH * N_EPOCHS
    t_train_cached = STEPS_PER_EPOCH * tf + (total_steps - STEPS_PER_EPOCH) * tp
    t_train_uncached = total_steps * tf
    eval_imgs = sum(EVAL_IMAGES.values())
    t_eval = eval_imgs * te / batch
    t_obj = OBJECTNESS_STEPS * N_EPOCHS * tf
    te_l, tp_l, tf_l = fleet("linear", "bf16")
    t_train_lin = STEPS_PER_EPOCH * tf_l + (total_steps - STEPS_PER_EPOCH) * tp_l
    return {
        "t_train_cached": t_train_cached, "t_train_uncached": t_train_uncached,
        "t_eval": t_eval, "t_obj": t_obj, "eval_images": eval_imgs,
        "suite_cached": N_BACKBONES * (2 * t_train_cached + t_obj + t_eval),
        "suite_uncached": N_BACKBONES * (2 * t_train_uncached + t_obj + t_eval),
        "suite_linear": N_BACKBONES * (2 * t_train_lin + OBJECTNESS_STEPS * N_EPOCHS * tf_l
                                       + eval_imgs * te_l / batch),
    }


def report_lines(rows, proj: dict, batch: int, cards: int, card: str,
                 size: int = 480) -> list[str]:
    """The markdown report: the per-backbone table and the projection, one
    card measured, ``cards`` projected by division."""
    def met(seconds):
        return "MET" if seconds / cards < 3600 else "NOT MET"

    lines = [
        f"# Suite wall-clock projection (measured on 1x {card})",
        "",
        f"batch {batch}, {size}x{size}, bf16 backbone, DPT probe; reference "
        f"protocol {N_EPOCHS} epochs x {STEPS_PER_EPOCH} steps.",
        "",
        "| backbone | extract ms | probe-step ms | full-step ms |",
        "|---|---|---|---|",
    ]
    for name, a, b, c in rows:
        lines.append(f"| {name} | {a*1e3:.1f} | {b*1e3:.1f} | {c*1e3:.1f} |")
    sc, su, sl = proj["suite_cached"], proj["suite_uncached"], proj["suite_linear"]
    lines += [
        "",
        f"- depth+snorm training per backbone: "
        f"{2*proj['t_train_cached']/60:.1f} min cached / "
        f"{2*proj['t_train_uncached']/60:.1f} min uncached",
        f"- eval tasks (spair/navi/scannet/2afc, {proj['eval_images']} imgs) per "
        f"backbone: {proj['t_eval']/60:.1f} min",
        f"- objectness per backbone: {proj['t_obj']/60:.1f} min",
        "",
        f"**{N_BACKBONES}-backbone suite, 1 card: {sc/3600:.2f} h with "
        f"cache_features ({su/3600:.2f} h without).**",
        f"**{cards} cards (data-parallel, a projection): ~{sc/3600/cards:.2f} h "
        f"cached — target < 1 h: {met(sc)}.**",
        "",
        f"**Linear-probe fast preset: {sl/3600:.2f} h on 1 card, "
        f"~{sl/3600/cards:.2f} h on {cards} cards (a projection) — {met(sl)}.**",
        "",
        "Context: the paper protocol's DPT probe dominates the train step; "
        "cache_features only removes the smaller extraction term. Meeting <1 h "
        "needs either the linear preset on more cards or a shorter schedule.",
    ]
    return lines


def main(argv=None) -> dict:
    """Time every backbone and variant, write the report; returns
    ``{"rows": [...], "projection": {...}, "report": path}`` (each row with
    its tag, three times and two losses)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=480,
                    help="square image size (smaller for a CPU run)")
    ap.add_argument("--backbones", nargs="*", default=["dino_vitb16", "simclr_resnet50"])
    ap.add_argument("--cards", type=int, default=4,
                    help="cards of the data-parallel projection")
    ap.add_argument("--out", default="logs/suite_torch/suite_timing.md")
    ap.add_argument("--device", default="cuda", help="cpu runs on the CPU")
    args = ap.parse_args(argv)
    require_device(args.device)

    rows, results = [], []
    for name in args.backbones:
        for head, pdt in VARIANTS:
            if zoo.ZOO[name].arch == "resnet" and pdt == "float32":
                continue  # the JAX script's variant set: ResNets without the f32 probe
            tag = variant_tag(name, head, pdt)
            try:
                steps = build_steps(name, args.batch, (args.size, args.size), head, pdt,
                                    device=args.device)
                t = time_steps(steps)
            except Exception as e:  # noqa: BLE001 — record and continue
                print(f"{tag}: FAILED {type(e).__name__}: {e}", flush=True)
                continue
            del steps
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            rows.append((tag, t["extract_s"], t["probe_s"], t["full_s"]))
            results.append({"tag": tag, **t})
            print(f"{tag}: extract {t['extract_s']*1e3:.1f} ms | probe-step "
                  f"{t['probe_s']*1e3:.1f} ms | full-step {t['full_s']*1e3:.1f} ms "
                  f"(batch {args.batch})", flush=True)

    proj = project_suite(rows, args.batch)
    lines = report_lines(rows, proj, args.batch, args.cards, card_name(args.device),
                         args.size)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines[-6:-2]))
    return {"rows": results, "projection": proj, "report": args.out}


if __name__ == "__main__":
    res = main()
    sys.exit(0 if res["rows"] else 1)
