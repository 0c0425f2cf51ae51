"""mlp_ms_per_step (ms): the device time of the kernels and memsets
launched inside the program's ``mvp.backbone.mlp`` spans (each ViT
block's ``Mlp.forward``: fc1, the activation, fc2), per step of the
window."""

from benchmark import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, spans.MLP)
