"""Fold a nearest-neighbour upsample into the 3x3 conv that follows it
(counterpart of the JAX package's ``ops/subpixel.py``; ordinary torch ops,
not a kernel).

A nearest-upsampled map is piecewise constant on ``up x up`` blocks, so the
3x3 window over the upsampled grid touches at most two distinct source
pixels per axis. The output pixel ``(up*i + a, up*j + b)`` is then a small
conv over the base grid whose per-axis kernel depends on the phase:
``L = [w0, w1 + w2]`` over taps ``(i-1, i)`` for phase 0, ``S = w0+w1+w2``
over tap ``i`` for interior phases, ``R = [w0 + w1, w2]`` over taps
``(i, i+1)`` for phase ``up-1``. Nine small convs tile the phase grid: the
result equals ``conv3x3(nearest_up(x))`` exactly up to float summation
order, at 25/(9*up^2) of the multiply-adds.

Layout here is the torch-native NCHW / OIHW: the probe converts its NHWC
inputs once at its boundary.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _collapse(w: torch.Tensor, dim: int):
    """(L, S, R) phase kernels of one 3-tap axis of an OIHW kernel."""
    w0, w1, w2 = w.split(1, dim=dim)
    L = torch.cat([w0, w1 + w2], dim=dim)
    S = w0 + w1 + w2
    R = torch.cat([w0 + w1, w2], dim=dim)
    return L, S, R


# padding (before, after) per phase class: L reads (i-1, i), R reads (i, i+1)
_PAD = {"L": (1, 0), "S": (0, 0), "R": (0, 1)}


def conv3x3_after_nearest_up(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor | None, up: int) -> torch.Tensor:
    """``conv3x3(nearest_up(x, up), weight, padding=1) + bias`` computed at
    base resolution. x (B, Cin, H, W); weight (Cout, Cin, 3, 3); returns
    (B, Cout, up*H, up*W). Phase kernels are summed in the weight's dtype,
    then cast to the input's."""
    if up < 2 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"needs up >= 2 and a 3x3 kernel, got {up}, "
                         f"{tuple(weight.shape)}")
    B, _, H, W = x.shape
    out = {}
    for rname, rk in zip("LSR", _collapse(weight, 2)):
        for cname, kk in zip("LSR", _collapse(rk, 3)):
            (pt, pb), (pl, pr) = _PAD[rname], _PAD[cname]
            out[rname + cname] = F.conv2d(F.pad(x, (pl, pr, pt, pb)),
                                          kk.to(x.dtype))
    nin = up - 2  # interior phases per axis

    def row(r):  # (B, Cout, H, W, up): column phases of row class r
        return torch.stack([out[r + "L"]] + [out[r + "S"]] * nin + [out[r + "R"]],
                           dim=-1)

    grid = torch.stack([row("L")] + [row("S")] * nin + [row("R")], dim=3)
    y = grid.reshape(B, weight.shape[0], up * H, up * W)  # (B, C, H, a, W, b)
    if bias is not None:
        y = y + bias.to(x.dtype)[:, None, None]
    return y


class NearestUpConv(nn.Module):
    """Drop-in for ``nearest_up(x, up)`` followed by ``nn.Conv2d(cin, cout,
    3, padding=1)``: same parameters (``weight``, ``bias``), exact math."""

    def __init__(self, in_channels: int, out_channels: int, up: int):
        super().__init__()
        self.up = up
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x):
        return conv3x3_after_nearest_up(x, self.weight, self.bias, self.up)
