"""Validation artifacts of the port (counterpart of the JAX package's
``utils/reporting.py``): colormapped PNG dumps, per-image metric JSON and
TXT, the first-batch panels, the segment-area-vs-d1 scatter and the
correspondence renders.

No matplotlib (the GPU host has none): the colormaps are numpy tables
(``utils/colormaps.py``) and the PNGs are written with PIL.

* Pure functions of numbers, equal to the JAX package's output:
  ``visualize_depth``, ``visualize_depth_navi``, ``visualize_snorm``,
  ``save_images_to_png`` (PNGs, JSON, TXT), ``log_first_batch_images``'s
  PNGs and ``save_correspondence_json``.
* Figures, which the JAX package draws with matplotlib: the port draws the
  same content (which points and lines, where, in which colour) on its own
  canvas. ``plot_segment_area_vs_d1`` (a 1000x600 scatter, matplotlib's
  10x6 inches at 100 dpi) and ``visualize_and_save_correspondences`` (the
  two views side by side, a dot at each end of every match and a line
  between them, green below the pixel threshold, red above).

Host-side numpy; they run once per validation.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping, Sequence

import numpy as np
import torch
from PIL import Image, ImageDraw

from midvision_probe_torch.utils import colormaps

_COLORMAPS = {"inferno": colormaps.INFERNO, "RdYlGn_r": colormaps.RDYLGN_R}

# the scatter's canvas: matplotlib's default figure axes box (subplot
# params left 0.125, right 0.9, bottom 0.11, top 0.88) on a 1000x600 figure
SCATTER_SIZE = (1000, 600)
SCATTER_BOX = (125, 72, 900, 534)  # x0, y0 (top), x1, y1 (bottom) in pixels
SCATTER_MARGIN = 0.05  # matplotlib's default axes margins
SCATTER_RGB = (0x1F, 0x77, 0xB4)  # matplotlib's default first colour
SCATTER_ALPHA = 0.6
SCATTER_RADIUS = 4  # the default marker (6 pt across) at 100 dpi

MATCH_GREEN = (0, 128, 0)
MATCH_RED = (255, 0, 0)
MATCH_DOT_RADIUS = 3


def _cmap(colormap: str) -> np.ndarray:
    return _COLORMAPS[colormap]


def visualize_depth(pred, target, colormap: str = "inferno"):
    """Max-normalised colormapped pair; ``pred``/``target`` (H, W) or
    (H, W, 1). Returns two (H, W, 3) float arrays."""
    table = _cmap(colormap)
    pred = np.squeeze(np.asarray(pred, np.float32))
    target = np.squeeze(np.asarray(target, np.float32))
    pred_c = colormaps.apply(table, pred / max(float(pred.max()), 1e-9))[:, :, :3]
    target_c = colormaps.apply(table, target / max(float(target.max()), 1e-9))[:, :, :3]
    return pred_c, target_c


def visualize_depth_navi(pred, target, colormap: str = "inferno"):
    """Min/max normalisation over the valid pixels (target != 0), invalid
    pixels white."""
    table = _cmap(colormap)
    pred = np.squeeze(np.asarray(pred, np.float32))
    target = np.squeeze(np.asarray(target, np.float32))
    mask = target != 0.0
    if not mask.any():
        mask = np.ones_like(mask)

    def norm(x):
        lo, hi = float(x[mask].min()), float(x[mask].max())
        c = colormaps.apply(table, (x - lo) / max(hi - lo, 1e-9))[:, :, :3]
        c[~mask] = 1.0
        return c

    return norm(pred), norm(target)


def _to_uint8(rgb01: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> uint8 by truncation, as the JAX package writes."""
    return (np.clip(rgb01, 0, 1) * 255).astype(np.uint8)


def _save_png(path: str, rgb01: np.ndarray) -> None:
    Image.fromarray(_to_uint8(rgb01)).save(path)


def save_images_to_png(pred, target, segmentation_map, batch_idx: int, task: str,
                       save_dir: str, colormap: str = "inferno", is_navi: bool = False,
                       scale_invariant: bool = False, num_levels: int = 5) -> None:
    """Per image: colormapped ``pred_``/``target_{task}_{batch_idx}_{i}.png``
    and its global and centroid-level metrics (``evaluate_depth`` with
    ``image_average=True``) as ``metrics_*.json`` and ``metrics_*.txt``."""
    from midvision_probe_torch.utils.metrics import evaluate_depth

    os.makedirs(save_dir, exist_ok=True)
    pred = np.asarray(pred, np.float32)
    target = np.asarray(target, np.float32)
    seg = None if segmentation_map is None else np.asarray(segmentation_map)

    for i in range(pred.shape[0]):
        g, lv = evaluate_depth(
            torch.from_numpy(pred[i:i + 1]), torch.from_numpy(target[i:i + 1]),
            None if seg is None else torch.from_numpy(seg[i:i + 1]),
            image_average=True, scale_invariant=scale_invariant,
            num_levels=num_levels, is_navi=is_navi)
        data = {
            "global_metrics": {k: float(v) for k, v in g.items()},
            "level_metrics": {
                f"Level {n + 1}": {k: float(v) for k, v in lv[f"level_{n + 1}"].items()}
                for n in range(num_levels)
            },
        }
        stem = f"{task}_{batch_idx}_{i}"
        with open(os.path.join(save_dir, f"metrics_{stem}.json"), "w") as f:
            json.dump(data, f, indent=4)
        with open(os.path.join(save_dir, f"metrics_{stem}.txt"), "w") as f:
            f.write(f"Metrics for image {i} in batch {batch_idx}:\n")
            f.write("Global Metrics:\n")
            for k, v in data["global_metrics"].items():
                f.write(f"{k}: {v:.4f}\n")
            f.write("\nCentroid-Level Metrics:\n")
            for lvl, kv in data["level_metrics"].items():
                f.write(f"{lvl}:\n")
                for k, v in kv.items():
                    f.write(f"  {k}: {v:.4f}\n")

        viz = visualize_depth_navi if is_navi else visualize_depth
        pred_c, target_c = viz(pred[i], target[i], colormap=colormap)
        _save_png(os.path.join(save_dir, f"pred_{stem}.png"), pred_c)
        _save_png(os.path.join(save_dir, f"target_{stem}.png"), target_c)


def visualize_snorm(snorm) -> np.ndarray:
    """Surface normals as RGB, ``(n + 1) / 2``; channel-first input is moved
    to the last axis."""
    s = np.asarray(snorm, np.float32)
    if s.shape[-1] not in (3, 4):
        s = np.moveaxis(s, 0, -1)
    return (s[..., :3] + 1.0) / 2.0


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def log_first_batch_images(predict_fn, loader, wandb, save_dir: str | None = None,
                           task: str = "depth", is_navi: bool = False,
                           max_images: int = 8) -> None:
    """Colormapped pred/target panels of the loader's first batch, sent to
    wandb and saved as ``firstbatch_{pred,target}_{i}.png`` (at most
    ``max_images``). ``predict_fn(batch)`` gives the (B, H, W, C)
    prediction at the target's resolution."""
    batch = next(iter(loader))
    key = "depth" if task == "depth" else "snorm"
    target = np.asarray(batch[key])
    pred = _numpy(predict_fn(batch))

    pred_imgs, target_imgs = [], []
    for i in range(min(max_images, pred.shape[0])):
        if task == "snorm":
            p, t = visualize_snorm(pred[i]), visualize_snorm(target[i])
        elif is_navi:
            p, t = visualize_depth_navi(pred[i], target[i])
        else:
            p, t = visualize_depth(pred[i], target[i])
        pred_imgs.append(p)
        target_imgs.append(t)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            _save_png(os.path.join(save_dir, f"firstbatch_pred_{i}.png"), p)
            _save_png(os.path.join(save_dir, f"firstbatch_target_{i}.png"), t)

    if getattr(wandb, "run", None) is not None and hasattr(wandb, "Image"):
        wandb.log({"predictions": [wandb.Image(p) for p in pred_imgs],
                   "targets": [wandb.Image(t) for t in target_imgs]})


def scatter_limits(values: Sequence[float]) -> tuple[float, float]:
    """An axis' data limits: the values' range widened by 5% on each side
    (a single value gets +-0.5)."""
    lo, hi = float(min(values)), float(max(values))
    if hi == lo:
        return lo - 0.5, hi + 0.5
    pad = SCATTER_MARGIN * (hi - lo)
    return lo - pad, hi + pad


def scatter_pixel(x: float, y: float, xlim, ylim) -> tuple[float, float]:
    """Data point -> pixel centre inside ``SCATTER_BOX`` (y grows upward)."""
    x0, y0, x1, y1 = SCATTER_BOX
    px = x0 + (x - xlim[0]) / (xlim[1] - xlim[0]) * (x1 - x0)
    py = y1 - (y - ylim[0]) / (ylim[1] - ylim[0]) * (y1 - y0)
    return px, py


def plot_segment_area_vs_d1(segment_metrics: Sequence[Mapping],
                            output_dir: str = "plots") -> str | None:
    """Scatter of per-segment area against d1 over the validation set, as
    ``segment_area_vs_d1_%Y%m%d-%H%M%S.png`` under ``output_dir``: a
    1000x600 white canvas, the axes box with a grid, the title and labels,
    and one alpha-0.6 ``#1f77b4`` dot per row. None on no rows."""
    if not segment_metrics:
        return None
    areas = [float(e["area"]) for e in segment_metrics]
    d1 = [float(e["d1_ratio"]) for e in segment_metrics]
    xlim, ylim = scatter_limits(areas), scatter_limits(d1)
    x0, y0, x1, y1 = SCATTER_BOX

    img = Image.new("RGB", SCATTER_SIZE, (255, 255, 255))
    draw = ImageDraw.Draw(img)
    for k in range(1, 5):  # grid
        gx = x0 + k * (x1 - x0) / 5
        gy = y0 + k * (y1 - y0) / 5
        draw.line([(gx, y0), (gx, y1)], fill=(176, 176, 176))
        draw.line([(x0, gy), (x1, gy)], fill=(176, 176, 176))
    draw.rectangle([x0, y0, x1, y1], outline=(0, 0, 0))
    draw.text((SCATTER_SIZE[0] // 2 - 90, y0 - 24), "Segment Area vs. D1 Accuracy",
              fill=(0, 0, 0))
    draw.text(((x0 + x1) // 2 - 70, y1 + 28), "Segment Area (pixels)", fill=(0, 0, 0))
    draw.text((10, (y0 + y1) // 2), "D1 Accuracy", fill=(0, 0, 0))
    for value, at in ((xlim[0], (x0, y1 + 6)), (xlim[1], (x1 - 40, y1 + 6)),
                      (ylim[0], (x0 - 60, y1 - 10)), (ylim[1], (x0 - 60, y0))):
        draw.text(at, f"{value:.3g}", fill=(0, 0, 0))

    # alpha-composite each dot over what is below it, as the scatter does
    canvas = np.asarray(img, np.float64)
    color = np.asarray(SCATTER_RGB, np.float64)
    r = SCATTER_RADIUS
    for a, d in zip(areas, d1):
        px, py = scatter_pixel(a, d, xlim, ylim)
        cx, cy = int(round(px)), int(round(py))
        ys, xs = np.ogrid[cy - r:cy + r + 1, cx - r:cx + r + 1]
        disc = (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r
        win = canvas[cy - r:cy + r + 1, cx - r:cx + r + 1]
        win[disc] = win[disc] * (1 - SCATTER_ALPHA) + color * SCATTER_ALPHA
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir,
                        f"segment_area_vs_d1_{time.strftime('%Y%m%d-%H%M%S')}.png")
    Image.fromarray(np.round(canvas).astype(np.uint8)).save(path)
    return path


def _pair_canvas(img0, img1) -> Image.Image:
    """The two views side by side (H, 2W), un-normalised from [-1, 1]."""
    canvas = np.concatenate([np.clip((np.asarray(img0, np.float32) + 1) / 2, 0, 1),
                             np.clip((np.asarray(img1, np.float32) + 1) / 2, 0, 1)],
                            axis=1)
    return Image.fromarray(_to_uint8(canvas))


def visualize_and_save_correspondences(img0, img1, uv0, uv1, err2d, output_dir: str,
                                       threshold: float = 5.0,
                                       sparse_n: int = 200) -> None:
    """``original_views.png``, ``correspondences.png`` (every match) and
    ``correspondences_sparse{sparse_n}.png`` (the first ``sparse_n``): the
    two views side by side, each match a dot at ``uv0`` in the left view, a
    dot at ``uv1`` in the right one and a line between them, green
    ``(0, 128, 0)`` when ``err2d < threshold`` pixels, else red. ``img0``,
    ``img1``: (H, W, 3) in [-1, 1]; ``uv``: (N, 2) pixel (x, y)."""
    os.makedirs(output_dir, exist_ok=True)
    uv0, uv1, err2d = np.asarray(uv0), np.asarray(uv1), np.asarray(err2d)
    width = np.asarray(img0).shape[1]
    base = _pair_canvas(img0, img1)
    base.save(os.path.join(output_dir, "original_views.png"))

    for fname, count in (("correspondences.png", uv0.shape[0]),
                         (f"correspondences_sparse{sparse_n}.png",
                          min(sparse_n, uv0.shape[0]))):
        img = base.copy()
        draw = ImageDraw.Draw(img)
        colors = [MATCH_GREEN if err2d[i] < threshold else MATCH_RED for i in range(count)]
        ends = [((float(uv0[i, 0]), float(uv0[i, 1])),
                 (float(uv1[i, 0]) + width, float(uv1[i, 1]))) for i in range(count)]
        for (a, b), c in zip(ends, colors):  # lines first, so no line hides a dot
            draw.line([a, b], fill=c, width=1)
        r = MATCH_DOT_RADIUS
        for (a, b), c in zip(ends, colors):
            for x, y in (a, b):
                draw.ellipse([x - r, y - r, x + r, y + r], fill=c)
        img.save(os.path.join(output_dir, fname))


def save_correspondence_json(err2d, err3d, rel_ang_deg, output_dir: str) -> None:
    """Per-instance error counts under the 2D (px) and 3D (m) thresholds
    and the pair's relative angle, as ``correspondence_metrics.json``."""
    os.makedirs(output_dir, exist_ok=True)
    err2d, err3d = np.asarray(err2d), np.asarray(err3d)
    results = {
        "relative_angle_deg": float(np.asarray(rel_ang_deg).reshape(-1)[0]),
        "2d_error_counts": {str(t): int((err2d < t).sum())
                            for t in (1, 2, 5, 15, 25, 35, 50)},
        "3d_error_counts": {str(t): int((err3d < t).sum())
                            for t in (0.01, 0.02, 0.05, 0.1, 0.25, 0.5)},
    }
    with open(os.path.join(output_dir, "correspondence_metrics.json"), "w") as f:
        json.dump(results, f, indent=4)
