"""probe_fwd_ms_per_step (ms): the device time of the kernels and memsets
launched inside the program's ``mvp.probe.forward`` span (in
``ProbeTrainer.train_epoch``: the tap norms, the DPT head and the loss),
per step of the window."""

from benchmark import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, spans.PROBE_FORWARD)
