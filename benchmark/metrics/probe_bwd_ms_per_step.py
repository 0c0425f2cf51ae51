"""probe_bwd_ms_per_step (ms): the device time of the kernels and memsets
launched inside the program's ``mvp.probe.backward`` span (in
``ProbeTrainer.train_epoch``: ``loss.backward()``, its kernels launched
from autograd's thread while the span is open), per step of the window."""

from benchmark import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, spans.PROBE_BACKWARD)
