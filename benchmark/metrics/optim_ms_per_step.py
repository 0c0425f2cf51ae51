"""optim_ms_per_step (ms): the device time of the kernels and memsets
launched inside the program's ``mvp.engine.optimizer`` span (in
``ProbeTrainer.train_epoch``: the gradients' all-reduce under a process
group, AdamW's step and the schedule's), per step of the window."""

from benchmark import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, spans.OPTIMIZER)
