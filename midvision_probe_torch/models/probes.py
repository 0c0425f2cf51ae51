"""Probe heads and decoders (counterpart of the JAX package's
``models/probes.py``), trained on frozen features.

Public boundaries are NHWC like the JAX package's: heads take a list of
(B, h, w, C) feature maps and return (B, H, W, C_out). Inside, each head
converts once to NCHW (a permute of an NHWC tensor is ``channels_last`` in
memory, which cuDNN takes directly) and back once at the end.

Interpolation semantics follow the reference exactly: the bare
``F.interpolate(scale_factor=...)`` inside DPT is nearest, the CNN-branch
fusion upsample is bilinear with ``align_corners=True``, Linear and
Multiscale use bilinear ``align_corners=False``.

Module and parameter names mirror the flax tree (``conv_0``,
``ref_3.resConfUnit2.conv1``, ``out_conv_0``, ``tap_norm_0``) so
``convert.from_jax`` maps the JAX package's probe variables one to one.

``dtype`` (``system.probe_dtype``) follows flax's rule module by module:
parameters stay float32; each conv casts its input, kernel and bias to
``dtype`` and adds the bias in ``dtype``; a bilinear resize computes in
float32 and rounds back to its input's dtype; elementwise ops and the
depth reduction run in the dtype they are given; a BatchNorm takes its
statistics in float32 and returns ``dtype``. A tap keeps its incoming
dtype (a bf16 backbone's or the feature cache's) until the first conv.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from midvision_probe_torch.ops.image import resize
from midvision_probe_torch.ops.subpixel import NearestUpConv
from midvision_probe_torch.parallel import multihost
from midvision_probe_torch.utils.device import resolve_dtype


class _Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` as flax's ``nn.Conv(dtype=...)``
    does: input, kernel and bias cast to ``dtype``, and below float32 the
    bias added after the convolution, in ``dtype`` (a fused bias would
    round once where flax rounds twice)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(cin, cout, k, padding=k // 2, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        d = self.dtype
        x, w = x.to(d), self.weight.to(d)
        b = None if self.bias is None else self.bias.to(d)
        if d == torch.float32 or b is None:
            return F.conv2d(x, w, b, padding=self.padding)
        return F.conv2d(x, w, None, padding=self.padding) + b[:, None, None]


def _bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """NCHW bilinear resize (torch ``F.interpolate`` semantics) computed in
    float32 and returned in the input's dtype, as the JAX ``resize``."""
    out = F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                        align_corners=align_corners)
    return out.to(x.dtype)


def _up(x: torch.Tensor, factor: int, mode: str,
        align_corners: bool | None = None) -> torch.Tensor:
    """NCHW upsample by an integer factor (torch ``F.interpolate``
    semantics; bilinear through ``_bilinear``)."""
    size = (x.shape[2] * factor, x.shape[3] * factor)
    if mode == "bilinear":
        return _bilinear(x, size, bool(align_corners))
    return F.interpolate(x, size=size, mode=mode, align_corners=align_corners)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it below float32:
    ``1 / (1 + exp(-x))``, each op rounded to the input's dtype."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _FlaxBatchNorm(nn.Module):
    """BatchNorm over an NHWC map with flax ``nn.BatchNorm`` semantics:
    running stats decay by ``momentum`` (0.9) toward the BIASED batch
    variance (torch's BatchNorm uses the unbiased one), stats and the
    normalisation in f32, the result in ``dtype``."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        xf = x.float()
        if self.training:
            # batch statistics over the global batch: one all-reduce of the
            # sums under a process group's training step, else local
            dims = tuple(range(xf.ndim - 1))
            count = xf.new_full((1,), xf.numel() // xf.shape[-1])
            sums = multihost.batch_stat_sum(
                torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]))
            c = xf.shape[-1]
            mean = sums[:c] / sums[-1]
            var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (self.weight * torch.rsqrt(var + self.eps)) + self.bias
        return y.to(self.dtype)


class TapNorms(nn.Module):
    """Trainable BatchNorm over each tapped feature map (``add_norm``)."""

    def __init__(self, feat_dims: Sequence[int]):
        super().__init__()
        for i, c in enumerate(feat_dims):
            self.add_module(f"tap_norm_{i}", _FlaxBatchNorm(c))
        self.num_taps = len(feat_dims)

    def forward(self, feats: Sequence[torch.Tensor]):
        return [getattr(self, f"tap_norm_{i}")(f)
                for i, f in enumerate(feats[: self.num_taps])]


def _channels(feat_dim) -> list[int]:
    if isinstance(feat_dim, (list, tuple)):
        return [d[0] if isinstance(d, (list, tuple)) else d for d in feat_dim]
    return [feat_dim]


class Linear(nn.Module):
    """Concat multilayer maps -> 4x bilinear upsample -> 1 conv
    (``probes.py:417-432``). Hetero-grid taps are first resized to the last
    tap's grid, each in its own dtype (``ops.image.resize`` rounds back to
    it, as the JAX resize does); a 1x1 conv runs before the (commuting)
    upsample."""

    def __init__(self, feat_dim, output_dim: int, kernel_size: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv = _Conv(sum(_channels(feat_dim)), output_dim, kernel_size, dtype=dtype)

    def forward(self, feats):
        if isinstance(feats, (list, tuple)):
            hw = feats[-1].shape[1:3]
            feats = [f if f.shape[1:3] == hw else resize(f, size=hw, mode="bilinear")
                     for f in feats]
            x = _nchw(torch.cat(feats, dim=-1))
        else:
            x = _nchw(feats)
        if self.kernel_size == 1:
            x = _up(self.conv(x), 4, "bilinear", align_corners=False)
        else:
            x = self.conv(_up(x, 4, "bilinear", align_corners=False))
        return _nhwc(x)


class MultiscaleHead(nn.Module):
    """Per-layer conv -> concat at last-layer res -> 2-stage conv with 2x/4x
    upsampling (``probes.py:435-458``)."""

    def __init__(self, feat_dim, output_dim: int, hidden_dim: int = 512,
                 kernel_size: int = 1, dtype=torch.float32):
        super().__init__()
        k, hd = kernel_size, hidden_dim
        chans = _channels(feat_dim)
        for i, c in enumerate(chans):
            self.add_module(f"convs_{i}", _Conv(c, hd, k, dtype=dtype))
        self.num_convs = len(chans)
        self.conv_mid_0 = _Conv(hd * len(chans), hd, k, dtype=dtype)
        self.conv_mid_1 = _Conv(hd, hd, k, dtype=dtype)
        self.conv_mid_2 = _Conv(hd, hd, k, dtype=dtype)
        self.conv_out_0 = _Conv(hd, hd, k, dtype=dtype)
        self.conv_out_1 = _Conv(hd, output_dim, k, dtype=dtype)

    def forward(self, feats):
        xs = [getattr(self, f"convs_{i}")(_nchw(f)) for i, f in enumerate(feats)]
        hw = xs[-1].shape[2:]
        xs = [_bilinear(x, hw) for x in xs]
        x = F.relu(torch.cat(xs, dim=1))
        x = _up(x, 2, "bilinear", align_corners=False)
        x = F.relu(self.conv_mid_0(x))
        x = F.relu(self.conv_mid_1(x))
        x = F.relu(self.conv_mid_2(x))
        x = _up(x, 4, "bilinear", align_corners=False)
        x = F.relu(self.conv_out_0(x))
        return _nhwc(self.conv_out_1(x))


class ResidualConvUnit(nn.Module):
    """``probes.py:263-306`` (NCHW). Transformer branch: conv-relu-conv-relu
    + x; CNN branch: relu-conv-relu-conv + relu(x) (the reference's inplace
    ReLU rectifies the residual too).

    ``input_up``: ``x`` arrives at 1/input_up resolution and this unit
    computes ``RCU(nearest_up(x, input_up))`` exactly, with conv1 as the
    folded phase conv (3x3 only)."""

    def __init__(self, features: int, kernel_size: int = 3,
                 is_transformer: bool = False, input_up: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.is_transformer, self.input_up = is_transformer, input_up
        f, k = features, kernel_size
        if not is_transformer:
            if input_up != 1:
                raise ValueError("the CNN branch takes full-resolution inputs")
            k = 3
        self.fold = is_transformer and input_up > 1 and k == 3
        self.conv1 = (NearestUpConv(f, f, input_up, dtype=dtype) if self.fold
                      else _Conv(f, f, k, dtype=dtype))
        self.conv2 = _Conv(f, f, k, dtype=dtype)

    def forward(self, x):
        if self.is_transformer:
            if self.fold:
                h = self.conv1(x)
                x = _up(x, self.input_up, "nearest")
            else:
                if self.input_up > 1:
                    x = _up(x, self.input_up, "nearest")
                h = self.conv1(x)
            h = F.relu(self.conv2(F.relu(h)))
            return h + x
        x = F.relu(x)
        h = self.conv2(F.relu(self.conv1(x)))
        return h + x


class FeatureFusionBlock(nn.Module):
    """``probes.py:215-260`` (NCHW). ``x`` arrives at 1/input_up resolution;
    ``skip_x`` is always full resolution."""

    def __init__(self, features: int, kernel_size: int = 3, with_skip: bool = True,
                 is_transformer: bool = False, input_up: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.with_skip, self.is_transformer = with_skip, is_transformer
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features, kernel_size,
                                                 is_transformer, input_up, dtype)
            self.resConfUnit2 = ResidualConvUnit(features, kernel_size,
                                                 is_transformer, dtype=dtype)
        else:
            self.resConfUnit2 = ResidualConvUnit(features, kernel_size,
                                                 is_transformer, input_up, dtype)

    def forward(self, x, skip_x=None):
        if skip_x is not None and self.with_skip:
            x = self.resConfUnit2(self.resConfUnit1(x) + skip_x)
        else:
            x = self.resConfUnit2(x)
        if not self.is_transformer:
            x = _up(x, 2, "bilinear", align_corners=True)
        return x


class DPT(nn.Module):
    """4-level DPT fusion decoder (``probes.py:309-399``).

    ``feat_dim`` entries as ``(C, hw)`` pairs select the CNN branch (3x3
    no-bias input convs, fusion upsampling); plain ints the transformer
    branch (1x1 convs, nearest 2x deferred into each fusion block's first
    conv, nearest 4x folded into ``out_conv_0``). ``final_resize=False``
    skips the trailing nearest 2x so per-pixel heads can upsample their
    low-channel result instead."""

    def __init__(self, feat_dim, output_dim: int, hidden_dim: int = 512,
                 kernel_size: int = 3, final_resize: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.resnet_mode = _resnet_mode(feat_dim)
        self.final_resize = final_resize
        chans = _channels(feat_dim)
        if len(chans) != 4:
            raise ValueError(f"DPT needs 4 taps, got {len(chans)}")
        hd, rn = hidden_dim, self.resnet_mode
        for i, c in enumerate(chans):
            self.add_module(f"conv_{i}", _Conv(c, hd, 3, bias=False, dtype=dtype) if rn
                            else _Conv(c, hd, 1, dtype=dtype))
        up = 1 if rn else 2
        for i in range(4):
            self.add_module(f"ref_{i}", FeatureFusionBlock(
                hd, kernel_size, with_skip=i != 3, is_transformer=not rn,
                input_up=up, dtype=dtype))
        self.out_conv_0 = (_Conv(hd, hd, 3, dtype=dtype) if rn
                           else NearestUpConv(hd, hd, 4, dtype=dtype))
        self.out_conv_1 = _Conv(hd, output_dim, 3, dtype=dtype)

    def forward_nchw(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """NHWC tap maps -> NCHW decoder output."""
        xs = [getattr(self, f"conv_{i}")(_nchw(f)) for i, f in enumerate(feats)]
        out = self.ref_3(xs[3])
        out = self.ref_2(xs[2], out)
        out = self.ref_1(xs[1], out)
        out = self.ref_0(xs[0], out)
        out = self.out_conv_1(F.relu(self.out_conv_0(out)))
        if self.final_resize:
            out = _up(out, 2, "nearest")
        return out

    def forward(self, feats):
        return _nhwc(self.forward_nchw(feats))


def _resnet_mode(feat_dim) -> bool:
    return (isinstance(feat_dim, (list, tuple)) and len(feat_dim) > 0
            and isinstance(feat_dim[0], (list, tuple)))


def make_decoder(head_type: str, feat_dim, output_dim: int, hidden_dim: int,
                 kernel_size: int, final_resize: bool = True,
                 dtype=torch.float32) -> nn.Module:
    if head_type == "linear":
        return Linear(feat_dim, output_dim, kernel_size, dtype)
    if head_type == "multiscale":
        return MultiscaleHead(feat_dim, output_dim, hidden_dim, kernel_size, dtype)
    if head_type == "dpt":
        return DPT(feat_dim, output_dim, hidden_dim, kernel_size,
                   final_resize=final_resize, dtype=dtype)
    raise ValueError(f"Unknown head type: {head_type}")


class DepthHead(nn.Module):
    """``probes.py:119-157`` + bin/sigmoid prediction (``:160-212``).

    Returns (B, H, W, 1). For DPT the per-pixel depth reduction runs before
    the decoder's trailing nearest 2x (they commute exactly), so the
    256-channel map is never upsampled. ``dtype`` (``system.probe_dtype``)
    is the compute dtype of every module (module docstring); the bindepth
    reduction runs in it up to the expectation over the float32 bins, which
    returns float32, and sigdepth returns ``dtype``, as in the JAX head."""

    def __init__(self, feat_dim: Any, head_type: str = "multiscale",
                 min_depth: float = 0.001, max_depth: float = 10.0,
                 prediction_type: str = "sigdepth", hidden_dim: int = 512,
                 kernel_size: int = 1, dtype=None):
        super().__init__()
        if prediction_type not in ("bindepth", "sigdepth"):
            raise ValueError(prediction_type)
        self.head_type, self.prediction_type = head_type, prediction_type
        self.kernel_size = kernel_size
        self.min_depth, self.max_depth = min_depth, max_depth
        self.dtype = dtype
        output_dim = 256 if prediction_type == "bindepth" else 1
        self.defer = head_type == "dpt"
        self.decoder = make_decoder(head_type, feat_dim, output_dim, hidden_dim,
                                    kernel_size, final_resize=not self.defer,
                                    dtype=resolve_dtype(dtype))
        self.register_buffer(
            "bins", torch.linspace(min_depth, max_depth, 256), persistent=False)

    @property
    def name_tag(self) -> str:
        return f"{self.prediction_type}_{self.head_type}_k{self.kernel_size}"

    def forward(self, feats):
        if self.defer:
            x = self.decoder.forward_nchw(feats)
        else:
            x = _nchw(self.decoder(feats))
        # a Python constant is rounded to x's dtype first, as JAX's weakly
        # typed scalars are
        if self.prediction_type == "bindepth":
            prob = F.relu(x) + x.new_tensor(0.1)
            prob = prob / prob.sum(dim=1, keepdim=True)
            depth = torch.einsum("bkhw,k->bhw", prob.float(), self.bins)[:, None]
        else:
            depth = _sigmoid(x)
            depth = (x.new_tensor(self.min_depth)
                     + depth * x.new_tensor(self.max_depth - self.min_depth))
        if self.defer:
            depth = _up(depth, 2, "nearest")
        return _nhwc(depth)


class SurfaceNormalHead(nn.Module):
    """``probes.py:86-116``: the decoder's raw output, (B, H, W, 3), or
    (B, H, W, 4) with ``uncertainty_aware`` (the fourth channel is the
    kappa logit of ``angular_loss``). ``dtype`` as in ``DepthHead``."""

    def __init__(self, feat_dim: Any, head_type: str = "multiscale",
                 uncertainty_aware: bool = False, hidden_dim: int = 512,
                 kernel_size: int = 1, dtype=None):
        super().__init__()
        self.head_type, self.kernel_size = head_type, kernel_size
        self.uncertainty_aware = uncertainty_aware
        self.dtype = dtype
        self.decoder = make_decoder(head_type, feat_dim, 4 if uncertainty_aware else 3,
                                    hidden_dim, kernel_size, dtype=resolve_dtype(dtype))

    @property
    def name_tag(self) -> str:
        name = f"snorm_{self.head_type}_k{self.kernel_size}"
        return f"{name}_UA" if self.uncertainty_aware else name

    def forward(self, feats):
        return self.decoder(feats)


class _SigmoidHead(nn.Module):
    """The shared body of ``BinaryHead`` and ``TaskonomyHead``
    (``probes.py:7-84``), (B, H, W, output_dim): the decoder's output
    through a BatchNorm and a sigmoid (``pred_type="sigmoid"``), a tanh
    (``"tanh"``), or as it is (any other type, as Taskonomy's
    ``pred_type: vanilla``). The BatchNorm is flax's, as the JAX package's
    head has it: momentum 0.9, decay toward the biased batch variance, eps
    1e-5 (``_FlaxBatchNorm``; torch's ``BatchNorm2d`` would decay toward the
    unbiased one). ``dtype`` as in ``DepthHead``."""

    def __init__(self, feat_dim: Any, head_type: str = "dpt", output_dim: int = 1,
                 pred_type: str = "sigmoid", hidden_dim: int = 512,
                 kernel_size: int = 1, dtype=None):
        super().__init__()
        self.head_type, self.kernel_size = head_type, kernel_size
        self.pred_type = pred_type
        self.dtype = dtype
        self.decoder = make_decoder(head_type, feat_dim, output_dim, hidden_dim,
                                    kernel_size, dtype=resolve_dtype(dtype))
        if pred_type == "sigmoid":
            self.batch_norm = _FlaxBatchNorm(output_dim, dtype=resolve_dtype(dtype))

    def forward(self, feats):
        x = self.decoder(feats)
        if self.pred_type == "sigmoid":
            return _sigmoid(self.batch_norm(x))
        if self.pred_type == "tanh":
            return torch.tanh(x)
        return x


class BinaryHead(_SigmoidHead):
    """``probes.py:7-44`` (the objectness probe). The default
    ``output_dim=2`` is the reference constructor's (``probes.py:15``); the
    objectness config pins 1."""

    def __init__(self, feat_dim: Any, head_type: str = "dpt", output_dim: int = 2,
                 **kwargs):
        super().__init__(feat_dim, head_type, output_dim, **kwargs)


class TaskonomyHead(_SigmoidHead):
    """``probes.py:46-84`` (the Taskonomy probe); its trainer sets
    ``output_dim`` to the task's channels."""


def _lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    fan_in = t[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_probe_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init with flax's defaults (the JAX package's probe init):
    lecun-normal conv kernels, zero biases, BatchNorm ones/zeros. The draws
    differ from JAX's; parity tests carry weights across instead."""
    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, NearestUpConv)):
            _lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, _FlaxBatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return module
