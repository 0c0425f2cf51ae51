"""Depth probe training, a closed loop: the paper's ``train_depth.py``.

``ProbeTrainer.train_epoch`` over a feed of ``ring`` distinct seeded host
batches (numpy images and depth targets uniform in ``depth_range``, with
``_batch_id``, as the dataset loader yields them), cycled until the
window's time is up; the program copies each to the card itself. The
loss is ``train_depth.run``'s (the prediction resized to the target, then
``depth_loss``). The mix's ``probe`` overrides the configuration's probe
settings, and its ``trainer`` the trainer's ``system`` settings.

Set-up drives the same trainer through ``check_steps`` steps of the same
call and feed, on distinct batches, and keeps what the check compares:
each step's taps (a host copy) and loss, the first step's prediction and
gradient, and the parameters after the last. The check holds them to the
plain reference twice: fed the reference's own taps (the whole chain,
``tap_err`` to ``delta_gap``) and fed the program's taps (the probe
alone, ``probe_*``), so that the probe's arithmetic is judged apart from
the backbone's noise.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import check, flops, inputs, program, session
from benchmark.reference import probe as ref_probe
from benchmark.reference import vit as ref_vit
from benchmark.trace import WINDOW_SPAN


def half_batch(pred, target):
    """Half of the batch left out: the loss is the mean over the rest."""
    half = pred.shape[0] // 2
    return pred[:half], target[:half]


half_batch.at_prediction = False


def altered_answer(pred, target):
    """The first image's prediction altered (10% deeper) where the head
    produces it."""
    pred = pred.clone()
    pred[0] = pred[0] * 1.1
    return pred, target


altered_answer.at_prediction = True

# one precision below the configuration's: float8 (e4m3) reference taps for
# the bfloat16 backbone; the program's own bfloat16 path for the float32 probe
CONTROLS = {"control_taps": {"check": {"lowp": "fp8"}},
            "control_probe": {"session": {"probe_dtype": "bfloat16"}}}
FAULTS = {"half_batch": {"session": {"fault": half_batch}},
          "altered_answer": {"session": {"fault": altered_answer}}}


def cell_config(cfg: dict, mix: dict) -> dict:
    """The configuration with the mix's probe settings over its own."""
    return dict(cfg, probe={**cfg["probe"], **mix.get("probe", {})})


def flops_per_image(cfg: dict, mix: dict) -> float:
    cfg = cell_config(cfg, mix)
    return flops.backbone_forward(cfg) + flops.depth_probe_step(cfg)


class Feed:
    """The training loader: host batches in the dataset loader's form.
    ``slots`` fixes which batches; else it cycles from ``start`` until the
    host clock passes ``deadline``. A mark on the device's stream at each
    hand-over, and one when it stops."""

    def __init__(self, batches, slots=None, start=0, deadline=None, clock=None):
        self.batches = batches
        self.slots, self.start, self.deadline, self.clock = slots, start, deadline, clock
        self.count = 0

    def __iter__(self):
        while True:
            if self.slots is not None:
                if self.count >= len(self.slots):
                    break
                slot = self.slots[self.count]
            else:
                if time.perf_counter() >= self.deadline:
                    break
                slot = (self.start + self.count) % len(self.batches)
            if self.clock is not None:
                self.clock.mark()
            image, depth = self.batches[slot]
            self.count += 1
            yield {"image": image, "depth": depth, "_batch_id": slot}
        if self.clock is not None:
            self.clock.mark()


class Session:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device,
                 probe_dtype: str | None = None, fault=None):
        cfg = cell_config(cfg, mix)
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.phases = session.Phases()
        bw = inputs.weights(ref_vit.param_shapes(cfg), seed, "backbone", device,
                            getattr(torch, cfg["dtype"]))
        self.phases.mark("weights", device)
        self.backbone = program.BackboneProxy(program.build_extractor(cfg, device, bw))
        del bw
        self.phases.mark("extractor", device)
        self.loss = program.DepthLoss(cfg["probe"]["max_depth"], fault)
        pw = inputs.weights(self._probe_shapes(), seed, "probe", device)
        self.trainer = program.build_trainer(
            cfg, self.backbone, self.loss, device, pw,
            probe_dtype if probe_dtype is not None else cfg["probe"]["probe_dtype"],
            mix.get("trainer"))
        del pw
        self.phases.mark("trainer", device)
        B, hw = mix["batch"], cfg["image_hw"]
        self.batches = [
            (inputs.images(seed, s, B, hw, device).cpu().numpy(),
             inputs.depths(seed, s, B, hw, mix["depth_range"], device).cpu().numpy())
            for s in range(mix["ring"])]
        self.phases.mark("inputs", device)
        self._check_steps()
        self.phases.mark("check_steps", device)

    def _probe_shapes(self) -> dict:
        c = ref_vit.feat_dim(self.cfg)
        return {**ref_probe.param_shapes(self.cfg, c), **ref_probe.buffer_shapes(self.cfg, c)}

    def _check_steps(self) -> None:
        """The first steps, through the window's own call and feed, each on
        its own batch: every step's taps and loss, the first step's
        prediction and gradient (from AdamW's first moment,
        ``(1 - beta1) g``), and the parameters after the last."""
        tr, n = self.trainer, self.mix["check_steps"]
        self.backbone.capture, self.loss.capture = [], []
        tr.train_epoch(Feed(self.batches, slots=[0]))
        beta1 = tr.optimizer.param_groups[0]["betas"][0]
        # a step that kept no moment has no gradient to show: NaN, not correct
        self.first_grad = {
            k: (tr.optimizer.state[p]["exp_avg"] / (1 - beta1)).cpu()
            if "exp_avg" in tr.optimizer.state[p] else torch.full_like(p, math.nan, device="cpu")
            for k, p in tr.modules.named_parameters()}
        tr.train_epoch(Feed(self.batches, slots=list(range(1, n))))
        self.taps = self.backbone.capture
        self.pred = self.loss.capture[0].cpu()
        self.backbone.capture = self.loss.capture = None
        self.losses = list(tr.step_losses[:n])
        self.params = {k: p.detach().to("cpu", copy=True)
                       for k, p in tr.modules.named_parameters()}
        self.next_slot = n % len(self.batches)

    def window(self, seconds: float, tracer=None) -> dict:
        tracer = tracer or session.NoTracer
        self.backbone.traced = tracer is not session.NoTracer
        clock = session.StepClock(self.device)
        feed = Feed(self.batches, start=self.next_slot, clock=clock)
        t0 = time.perf_counter()
        feed.deadline = t0 + seconds
        with tracer.span(WINDOW_SPAN):
            self.trainer.train_epoch(feed)
            session.synchronize(self.device)
        wall = time.perf_counter() - t0
        return {"steps": feed.count, "images": feed.count * self.mix["batch"],
                "window_s": wall, "step_ms": clock.step_ms()}

    def release(self) -> None:
        del self.trainer, self.backbone
        session.free(self.device)

    def check(self, lowp: str | None = None) -> dict:
        """The check steps against the reference's (with ``lowp``, the taps
        of the whole chain are the reference's in that precision in the
        backbone's place)."""
        with session.full_f32():
            return self._check(lowp)

    def _compare(self, ref: dict, params0: dict, prefix: str = "") -> dict:
        """The program's check steps against the reference's ``ref``."""
        dev = self.device
        first_grad = {k: g.to(dev) for k, g in self.first_grad.items()}
        delta_p = {k: self.params[k].to(dev) - params0[k] for k in params0}
        delta_r = {k: ref["params"][k] - params0[k] for k in params0}
        moved = check.moved_leaves(ref["first_grad"])
        return {
            prefix + "pred_err": check.image_err(self.pred.to(dev), ref["pred"]),
            prefix + "loss_gap": check.loss_gap(self.losses, ref["losses"]),
            prefix + "grad_gap": check.norm_gap(first_grad, ref["first_grad"]),
            prefix + "grad_gap_median": check.median_norm_gap(first_grad, ref["first_grad"]),
            prefix + "delta_gap": check.norm_gap(delta_p, delta_r, keep=moved),
        }

    def _check(self, lowp) -> dict:
        cfg, n, dev = self.cfg, self.mix["check_steps"], self.device
        params = session.reference_backbone(cfg, self.seed, dev)
        B, hw, chunk = self.mix["batch"], cfg["image_hw"], self.mix["check_chunk"]
        taps, targets = [], []
        for s in range(n):
            images = inputs.images(self.seed, s, B, hw, dev)
            taps.append(session.reference_taps(params, cfg, images, chunk))
            targets.append(inputs.depths(self.seed, s, B, hw, self.mix["depth_range"], dev))
        got_taps = [t.to(dev) for t in self.taps[0]] if self.taps else []
        if lowp:
            images = inputs.images(self.seed, 0, B, hw, dev)
            got_taps = session.reference_taps(params, cfg, images, chunk, lowp)
        del params
        session.free(dev)
        shapes = ref_probe.param_shapes(cfg, ref_vit.feat_dim(cfg))
        params0 = {k: v for k, v in inputs.weights(self._probe_shapes(), self.seed, "probe",
                                                   dev).items() if k in shapes}
        tap_err = (max(check.token_err(p, r) for p, r in zip(got_taps, taps[0]))
                   if len(got_taps) == len(taps[0]) else math.inf)
        readings = {"tap_err": tap_err,
                    **self._compare(ref_probe.train_steps(params0, cfg, taps, targets),
                                    params0)}
        del taps, got_taps
        session.free(dev)
        if len(self.taps) != n:
            return {**readings, **{"probe_" + k: math.inf for k in readings if k != "tap_err"}}
        own = [[t.to(dev).float() for t in step] for step in self.taps]
        ref = ref_probe.train_steps(params0, cfg, own, targets)
        return {**readings, **self._compare(ref, params0, "probe_")}
