"""h2d_ms_per_step (ms): the device time of host-to-device copies per
step of the window (the engine's ``shard_batch`` of each host batch)."""

import re

PATTERN = re.compile(r"HtoD")


def read(ctx):
    if ctx.steps == 0:
        return None
    ns = ctx.trace.device_ns(PATTERN, kinds=("copy",))
    return ns / 1e6 / ctx.steps if ns > 0 else None
