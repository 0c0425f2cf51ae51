"""attn_ms_per_step (ms): the device time of the kernels and memsets
launched inside the program's ``mvp.backbone.attention`` spans (each ViT
block's ``Attention.forward``: the qkv projection, kernel K1 or the
unfused path, the output projection), per step of the window."""

from benchmark import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, spans.ATTENTION)
