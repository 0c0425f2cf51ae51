"""Torch-semantics image resampling on NHWC tensors (counterpart of the JAX
package's ``ops/image.py``).

The JAX package expresses each 1-D resample as a dense ``(out, in)`` weight
matrix built in numpy; the port applies the same matrices, so both packages
resample with identical weights:

* DPT fusion blocks (CNN branch): bilinear x2 with ``align_corners=True``,
* probe outputs: bilinear with ``align_corners=False``,
* pos-embed resize: bicubic antialiased,
* DPT transformer-branch upsamples: nearest (legacy ``floor(dst*in/out)``),
  done as an index gather,
* correspondence features: bicubic upsampling to the xyz grid, and
  ``grid_sample`` (bilinear, zeros padding) at projected points;
* ``center_padding``: zero padding to a multiple of the patch size.

Layout: NHWC (or HWC) in and out, like the JAX package's public functions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _source_coords(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            return np.zeros(1)
        return dst * (in_size - 1) / (out_size - 1)
    scale = in_size / out_size
    return (dst + 0.5) * scale - 0.5


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, mode: str,
                   align_corners: bool, antialias: bool) -> np.ndarray:
    """Dense (out_size, in_size) resampling matrix with edge clamping."""
    src = _source_coords(out_size, in_size, align_corners)
    W = np.zeros((out_size, in_size), dtype=np.float64)

    if mode in ("bilinear", "linear"):
        base_support = 1.0
        base_kernel = lambda x: np.clip(1.0 - np.abs(x), 0.0, None)  # noqa: E731
    elif mode in ("bicubic", "cubic"):
        base_support = 2.0
        # torch: plain bicubic uses a=-0.75; the antialias path uses a=-0.5
        a = -0.5 if antialias else -0.75
        base_kernel = functools.partial(_cubic_kernel, a=a)
    else:
        raise ValueError(f"Unsupported resize mode: {mode}")

    if antialias:
        # torch antialias path: scaled kernel, window truncated at the
        # borders and renormalized
        scale = max(in_size / out_size, 1.0)
        support = base_support * scale
        for i in range(out_size):
            center = src[i] + 0.5
            xmin = max(0, int(np.floor(center - support + 0.5)))
            xmax = min(in_size, int(np.floor(center + support + 0.5)))
            taps = np.arange(xmin, xmax)
            w = base_kernel((taps - center + 0.5) / scale)
            s = w.sum()
            if s != 0:
                w = w / s
            W[i, taps] = w
    else:
        for i in range(out_size):
            lo = int(np.floor(src[i] - base_support)) + 1
            hi = int(np.ceil(src[i] + base_support))
            taps = np.arange(lo, hi + 1)
            w = base_kernel(taps - src[i])
            # replicate-pad at borders (torch clamps source indices)
            np.add.at(W[i], np.clip(taps, 0, in_size - 1), w)

    return W.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index per output position (torch legacy floor(dst*in/out))."""
    return np.clip(np.arange(out_size) * in_size // out_size,
                   0, in_size - 1).astype(np.int64)


@functools.lru_cache(maxsize=256)
def _resize_weights(in_size: int, out_size: int, mode: str, align_corners: bool,
                    antialias: bool, device: torch.device) -> torch.Tensor:
    """``_resize_matrix`` on ``device``, copied there once: a copy from host
    memory at every call would hold the host until the card's queue
    drains."""
    return torch.as_tensor(_resize_matrix(in_size, out_size, mode, align_corners, antialias),
                           device=device)


@functools.lru_cache(maxsize=256)
def _nearest_index_tensor(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``_nearest_indices`` on ``device``, copied there once."""
    return torch.as_tensor(_nearest_indices(in_size, out_size), device=device)


def resize(
    x: torch.Tensor,
    size: tuple[int, int] | None = None,
    scale_factor: float | tuple[float, float] | None = None,
    mode: str = "bilinear",
    align_corners: bool = False,
    antialias: bool = False,
) -> torch.Tensor:
    """torch ``F.interpolate`` semantics for NHWC (or HWC) tensors.

    Bilinear and bicubic run in float32 and return the input dtype."""
    if mode == "nearest" and align_corners:
        raise ValueError(
            "align_corners is not applicable to mode='nearest' "
            "(torch F.interpolate raises for this combination too)")
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    if size is None:
        if scale_factor is None:
            raise ValueError("resize() needs size or scale_factor")
        if isinstance(scale_factor, (int, float)):
            scale_factor = (scale_factor, scale_factor)
        size = (int(h * scale_factor[0]), int(w * scale_factor[1]))
    out_h, out_w = int(size[0]), int(size[1])

    if (out_h, out_w) != (h, w):
        if mode == "nearest":
            if out_h != h:
                x = x.index_select(1, _nearest_index_tensor(h, out_h, x.device))
            if out_w != w:
                x = x.index_select(2, _nearest_index_tensor(w, out_w, x.device))
        else:
            dtype = x.dtype
            xf = x.float()
            if out_h != h:
                Wh = _resize_weights(h, out_h, mode, align_corners, antialias, x.device)
                xf = torch.einsum("oh,bhwc->bowc", Wh, xf)
            if out_w != w:
                Ww = _resize_weights(w, out_w, mode, align_corners, antialias, x.device)
                xf = torch.einsum("ow,bhwc->bhoc", Ww, xf)
            x = xf.to(dtype)
    return x[0] if squeeze else x


def grid_sample(feats: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False) -> torch.Tensor:
    """torch ``F.grid_sample`` (bilinear, zeros padding) on NHWC features.

    feats ``(B, H, W, C)``; grid ``(B, Hg, Wg, 2)`` of ``(x, y)`` locations
    in ``[-1, 1]`` -> ``(B, Hg, Wg, C)``; out-of-bounds taps are 0."""
    out = torch.nn.functional.grid_sample(
        feats.permute(0, 3, 1, 2), grid.to(feats.dtype), mode="bilinear",
        padding_mode="zeros", align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def center_padding(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Zero-pad NHWC images so H and W are multiples of ``patch_size``; the
    top and left get the smaller half of the padding."""
    h, w = images.shape[1], images.shape[2]
    pad_h = (patch_size - h % patch_size) % patch_size
    pad_w = (patch_size - w % patch_size) % patch_size
    if pad_h == 0 and pad_w == 0:
        return images
    pad_t, pad_l = pad_h // 2, pad_w // 2
    # F.pad lists the last dim first: C, then W, then H
    return torch.nn.functional.pad(
        images, (0, 0, pad_l, pad_w - pad_l, pad_t, pad_h - pad_t))
