"""backbone_rest_ms_per_step (ms): the device time of the kernels and
memsets launched inside the program's ``mvp.backbone`` span
(``FeatureExtractor.outputs``) and outside its blocks' attention and MLP
spans: the patch embedding, position embedding, LayerNorms, residual adds,
LayerScale and the taps' maps, per step of the window."""

from benchmark import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, spans.BACKBONE, less=(spans.ATTENTION, spans.MLP))
