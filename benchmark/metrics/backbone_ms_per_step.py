"""backbone_ms_per_step (ms): the device time of the kernels (and
memsets) launched inside the backbone span (``program.BACKBONE_SPAN``,
around each ``FeatureExtractor.features`` call the trainer makes), per
step of the window."""

BACKBONE_SPAN = "bench.backbone"


def read(ctx):
    if ctx.steps == 0 or not ctx.trace.spans.get(BACKBONE_SPAN):
        return None
    ns = ctx.trace.device_ns(kinds=("kernel", "memset"), launched_in=BACKBONE_SPAN)
    return ns / 1e6 / ctx.steps if ns > 0 else None
