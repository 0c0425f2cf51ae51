"""ResNet-50 with 5 stage taps (counterpart of the JAX package's
``models/resnet.py``), the trunk of the 17 SSL ResNet-50 configs.

torchvision's bottleneck v1.5 (the stride on ``conv2``), with torchvision's
parameter names, so a trunk state_dict loads as it is. Taps: 0 the stem
(conv, BN, ReLU, 3x3/2 max-pool), 1-4 the stages ``layer1``-``layer4``.
NCHW inside (channels-last memory on the card, where the input's NHWC
already is), taps returned NHWC as the feature contract has them.

Inference only: BatchNorm always uses its running statistics (the backbone
is frozen). The convolutions are cuDNN's ``F.conv2d``; the JAX package
runs them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from midvision_probe_torch.models.vit import _lecun_normal_

STAGE_BLOCKS = (3, 4, 6, 3)
STAGE_WIDTHS = (256, 512, 1024, 2048)
# (channels, spatial at a 480 input) per tap (reference ``simclr.py:69-75``)
RESNET50_FEAT_DIMS = [(64, 240), (256, 120), (512, 60), (1024, 30), (2048, 15)]


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm on its running statistics, eps 1e-5: ``weight``/``bias``
    (flax's ``scale``/``bias``) and ``running_mean``/``running_var``
    (flax's ``batch_stats``), and no ``num_batches_tracked``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        out = width * 4
        self.conv1, self.bn1 = _conv(cin, width, 1), FrozenBatchNorm2d(width)
        self.conv2, self.bn2 = _conv(width, width, 3, stride), FrozenBatchNorm2d(width)
        self.conv3, self.bn3 = _conv(width, out, 1), FrozenBatchNorm2d(out)
        self.downsample = (nn.Sequential(_conv(cin, out, 1, stride), FrozenBatchNorm2d(out))
                           if downsample else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + h)


class ResNet50(nn.Module):
    """``forward(images, taps)``: images (B, H, W, 3) NHWC, preprocessed ->
    the tapped NHWC stage outputs. Stages past the last tap are not run."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        cin, width = 64, 64
        for stage, num_blocks in enumerate(STAGE_BLOCKS):
            blocks = []
            for b in range(num_blocks):
                blocks.append(Bottleneck(cin, width, stride=2 if stage > 0 and b == 0 else 1,
                                         downsample=b == 0))
                cin = width * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            width *= 2

    @property
    def dtype(self) -> torch.dtype:
        return self.conv1.weight.dtype

    def forward(self, images: torch.Tensor, taps: Sequence[int] = (0, 1, 2, 3, 4)):
        taps = list(taps)
        x = images.permute(0, 3, 1, 2).to(self.dtype)  # NCHW view of NHWC memory
        # MaxPool2d(3, 2, padding=1) pads with -inf, as the JAX package does
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        outputs = {0: x}
        for stage in range(1, max(taps) + 1):
            x = getattr(self, f"layer{stage}")(x)
            outputs[stage] = x
        return [outputs[i].permute(0, 2, 3, 1) for i in taps]


@torch.no_grad()
def init_resnet_(model: ResNet50, generator: torch.Generator) -> ResNet50:
    """Random init with the JAX package's distributions (flax defaults):
    lecun-normal convs (truncated normal, variance 1/fan_in), BatchNorm
    scale 1, bias 0, mean 0, var 1. The draws differ from JAX's."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
        elif isinstance(mod, FrozenBatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return model
