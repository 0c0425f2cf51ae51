"""What every loop (``loops/<loop>.py``) shares: the step clock, the
set-up's phases, the reference's precision and the reference backbone
made again from the seed.

A traffic mix is a data file (``traffic/<mix>.json``) of parameters; its
``loop`` names the file under ``loops/`` whose ``Session`` makes the
inputs from the seed (``inputs.py``, the one generator), warms up, drives
the window and checks what the window produced. A loop file also gives
``flops_per_image(cfg, mix)`` (the model's work, for ``mfu``), and its
``CONTROLS`` and ``FAULTS`` (keyword arguments of ``Session`` and of its
``check``) for ``calibrate.py``. A new loop is a new file, found by name
(``manifest.loop``).

A step's boundaries are marked on the device's stream (a CUDA event when
a batch is handed over, and one after the last step), so the step times
count the device's waits on the host and add no synchronisation.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from benchmark import inputs
from benchmark.reference import vit as ref_vit


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepClock:
    """Step boundaries on the device's stream (host clock on the CPU)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list[float]:
        """Each step's time, after the device has passed the last mark."""
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


class Phases:
    """Seconds of each set-up phase, for the run's log."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._last = time.perf_counter()

    def mark(self, name: str, device=None) -> None:
        if device is not None:
            synchronize(device)
        now = time.perf_counter()
        self.seconds[name] = round(now - self._last, 4)
        self._last = now


class NoTracer:
    @staticmethod
    def span(name):
        return contextlib.nullcontext()


def reference_backbone(cfg, seed, device) -> dict:
    """The backbone's weights again from the seed, as the program holds
    them (rounded to its dtype), in float32."""
    dtype = getattr(torch, cfg["dtype"])
    shapes = ref_vit.param_shapes(cfg)
    return {k: v.float() for k, v in inputs.weights(shapes, seed, "backbone", device,
                                                    dtype).items()}


@torch.no_grad()
def reference_taps(params, cfg, images, chunk, lowp=None) -> list[torch.Tensor]:
    parts = [ref_vit.features(params, cfg, images[i:i + chunk], lowp)
             for i in range(0, images.shape[0], chunk)]
    return [torch.cat(t) for t in zip(*parts)]


@contextlib.contextmanager
def full_f32():
    """Matrix products and convolutions in float32, TF32 off: the
    reference's precision."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
