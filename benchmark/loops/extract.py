"""Frozen dense feature extraction, a closed loop.

``FeatureExtractor.features`` on a ring of ``ring`` distinct seeded
batches of ``batch`` images made on the device in set-up, enqueued back
to back; each map cast to float32, as feature consumers read them.

For the check, ``check_batches`` of the window's outputs are kept: the
seed draws as many instants of the window, and the step that the host
starts first at or after each instant is kept (the last step, where none
starts after it). Its maps, as the program returned them, are copied on
the stream into pinned host buffers made in set-up, so that the kept
outputs take no device memory and the host does not wait.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import check, flops, inputs, program, session
from benchmark.reference import vit as ref_vit
from benchmark.trace import WINDOW_SPAN

CONTROLS = {"control_taps": {"check": {"lowp": "fp8"}}}
FAULTS: dict = {}


def flops_per_image(cfg: dict, mix: dict) -> float:
    return flops.backbone_forward(cfg)


class Session:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.phases = session.Phases()
        weights = inputs.weights(ref_vit.param_shapes(cfg), seed, "backbone", device,
                                 getattr(torch, cfg["dtype"]))
        self.phases.mark("weights", device)
        self.extractor = program.build_extractor(cfg, device, weights)
        del weights
        self.phases.mark("extractor", device)
        self.ring = [inputs.images(seed, s, mix["batch"], cfg["image_hw"], device)
                     for s in range(mix["ring"])]
        rng = np.random.default_rng(inputs.sub_seed(seed, "check_sample"))
        self.keep_at = sorted(float(u) for u in rng.random(mix["check_batches"]))
        self.phases.mark("inputs", device)
        maps = None
        for _ in range(mix["warmup_steps"]):
            maps, _ = self._step(0)
        pin = device.type == "cuda"
        self.kept = [[torch.empty(m.shape, dtype=m.dtype, pin_memory=pin) for m in maps]
                     for _ in self.keep_at]
        self.kept_slots: list[int] = []
        del maps
        self.phases.mark("warmup", device)

    def _step(self, slot: int):
        maps = self.extractor.features(self.ring[slot])
        return maps, [m.float() for m in maps]

    def _keep(self, slot: int, maps) -> None:
        for host, m in zip(self.kept[len(self.kept_slots)], maps):
            host.copy_(m, non_blocking=True)
        self.kept_slots.append(slot)

    def window(self, seconds: float, tracer=None) -> dict:
        tracer = tracer or session.NoTracer
        clock = session.StepClock(self.device)
        n, ring, k = 0, len(self.ring), len(self.keep_at)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        with tracer.span(WINDOW_SPAN):
            while True:
                clock.mark()
                due = (len(self.kept_slots) < k and time.perf_counter() - t0
                       >= self.keep_at[len(self.kept_slots)] * seconds)
                maps, _ = self._step(n % ring)
                if due:
                    self._keep(n % ring, maps)
                n += 1
                if time.perf_counter() >= deadline:
                    break
            clock.mark()
            session.synchronize(self.device)
        wall = time.perf_counter() - t0
        while len(self.kept_slots) < k:  # no step started after an instant
            self._keep((n - 1) % ring, maps)
        session.synchronize(self.device)
        return {"steps": n, "images": n * self.mix["batch"], "window_s": wall,
                "step_ms": clock.step_ms()}

    def release(self) -> None:
        """Free the program's state; the kept outputs stay for the check."""
        del self.extractor, self.ring
        session.free(self.device)

    @torch.no_grad()
    def check(self, lowp: str | None = None) -> dict:
        """The kept outputs against the reference (or, with ``lowp``, the
        reference in that precision in the program's place)."""
        with session.full_f32():
            return self._check(lowp)

    def _check(self, lowp):
        params = session.reference_backbone(self.cfg, self.seed, self.device)
        worst = 0.0
        chunk = self.mix["check_chunk"]
        for slot, maps in zip(self.kept_slots, self.kept):
            images = inputs.images(self.seed, slot, self.mix["batch"], self.cfg["image_hw"],
                                   self.device)
            for i in range(0, images.shape[0], chunk):
                ref = ref_vit.features(params, self.cfg, images[i:i + chunk])
                got = (ref_vit.features(params, self.cfg, images[i:i + chunk], lowp) if lowp
                       else [m[i:i + chunk].to(self.device).float() for m in maps])
                worst = max(worst, *(check.token_err(g, r) for g, r in zip(got, ref)))
        return {"tap_err": worst}
