"""mfu (%): the whole step's share of the card's peak. The model's FLOPs
per image (``flops.per_image``: ``FlopCounterMode`` over the plain
reference; for a training mix the backbone's forward and the probe's
forward, loss and backward) times the images of the window, over the
window's wall time, over the bf16 dense peak, for every FLOP (a float32
probe's convolutions, at TF32 at best, read below a TF32 peak's share)."""


def read(ctx):
    peak = ctx.peak("bf16_flops")
    if peak is None or ctx.images == 0:
        return None
    return 100.0 * ctx.flops_per_image() * ctx.images / ctx.window_s / peak
