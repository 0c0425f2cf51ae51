"""device_idle_share (%): the share of the window in which no kernel,
copy or memset ran on the device (the union of the profiler's device
intervals, over the window span)."""


def read(ctx):
    if not ctx.trace.device or ctx.trace.window_ns <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns() / ctx.trace.window_ns)
