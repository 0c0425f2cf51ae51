"""probe_ms_per_step (ms): the device time of the step's kernels (and
memsets) launched outside the backbone span, copies left out: the tap
norms, the DPT head, the loss, the backward and AdamW, per step of the
window."""

BACKBONE_SPAN = "bench.backbone"


def read(ctx):
    if ctx.steps == 0 or not ctx.trace.spans.get(BACKBONE_SPAN):
        return None
    ns = ctx.trace.device_ns(kinds=("kernel", "memset"), launched_outside=BACKBONE_SPAN)
    return ns / 1e6 / ctx.steps if ns > 0 else None
