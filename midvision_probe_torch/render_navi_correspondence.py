"""Qualitative NAVI correspondence renders of the PyTorch port (counterpart
of the repository's ``render_navi_correspondence.py``): per pair, the two
views side by side with the lowest-error matches drawn as lines coloured by
their 3D error, and the errors as JSON.

Usage::

    python -m midvision_probe_torch.render_navi_correspondence \\
        backbone=dino_b16 dataset=synthetic_navi_hard dataset.image_size=512 \\
        num_corr=1000 scale_factor=0.25 \\
        [+system.backbone_dtype=bfloat16] [+system.device=cpu]

The path per pair (batch 1, the first ``max_pairs`` pairs): the frozen
backbone's dense forward on both views (kernel K1 on a card), the xyz grids
at ``scale_factor``, bicubic feature upsampling, the 2-NN search (kernel K4
on a card), the ratio test and top-k, then the 3D error ``|R x0 + t - x1|``
of every match with a finite weight. Writes ``pair_{i}/errors.json`` and,
when the pair has matches, ``pair_{i}/matches.png``. Runs on cuda unless
``system.device`` says otherwise.
"""

from __future__ import annotations

import json
import os
from datetime import datetime

import numpy as np
import torch
from PIL import Image, ImageDraw

from midvision_probe_torch.config import main
from midvision_probe_torch.datasets import build_loader
from midvision_probe_torch.datasets.transforms import resize_nearest
from midvision_probe_torch.engine.driver_common import build_dense_backbone
from midvision_probe_torch.evaluators.spair import make_feature_fn
from midvision_probe_torch.utils import colormaps
from midvision_probe_torch.utils.correspondence import estimate_correspondence_xyz
from midvision_probe_torch.utils.logging import setup_logger
from midvision_probe_torch.utils.transformations import transform_points_Rt


def render_pair(img0, img1, uv0, uv1, err, out_path, max_lines: int = 50) -> np.ndarray:
    """The two views side by side at their native size (H x 2W), min/ptp
    normalised together, and a line from ``uv0`` to ``uv1`` (shifted by W)
    for each of the ``max_lines`` lowest-error matches, coloured
    ``RdYlGn_r(min(err / err.max(), 1))``. Returns the drawn match indices."""
    W = np.asarray(img0).shape[1]
    canvas = np.concatenate([np.asarray(img0, np.float32), np.asarray(img1, np.float32)],
                            axis=1)
    canvas = (canvas - canvas.min()) / max(np.ptp(canvas), 1e-6)
    img = Image.fromarray((np.clip(canvas, 0, 1) * 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    order = np.argsort(err)[:max_lines]
    emax = max(float(err.max()), 1e-6)
    rgba = colormaps.apply(colormaps.RDYLGN_R,
                           np.minimum(err[order] / emax, 1.0).astype(np.float64))
    for i, c in zip(order, rgba):
        draw.line([(float(uv0[i, 0]), float(uv0[i, 1])),
                   (float(uv1[i, 0]) + W, float(uv1[i, 1]))],
                  fill=tuple(int(round(v * 255)) for v in c[:3]), width=1)
    img.save(out_path)
    return order


def run(cfg, max_pairs: int = 8):
    """Render the first ``max_pairs`` pairs of the configured dataset.
    Returns the output directory."""
    logger = setup_logger(None, "navi_render")
    model = build_dense_backbone(cfg)
    device = model.device
    feature_fn = make_feature_fn(model)
    loader = build_loader(cfg.dataset, "test", 1, pair_dataset=True)

    out_dir = os.path.join(cfg.output_dir,
                           f"navi_render_{datetime.now().strftime('%Y%m%d_%H%M%S')}",
                           model.checkpoint_name)
    os.makedirs(out_dir, exist_ok=True)

    sf = cfg.scale_factor
    for i, batch in enumerate(loader):
        if i >= max_pairs:
            break
        f0 = feature_fn(batch["image_0"])
        f1 = feature_fn(batch["image_1"])
        H, W = batch["xyz_grid_0"].shape[1:3]
        hw = (int(H * sf), int(W * sf))
        xyz0 = torch.as_tensor(resize_nearest(batch["xyz_grid_0"][0], hw), device=device)
        xyz1 = torch.as_tensor(resize_nearest(batch["xyz_grid_1"][0], hw), device=device)

        c_xyz0, c_xyz1, w, uv0, uv1 = estimate_correspondence_xyz(
            f0, f1, xyz0[None], xyz1[None], num_corr=cfg.num_corr)
        sel = torch.isfinite(w[0]).cpu().numpy()  # drop the static-shape pad rows
        Rt = torch.as_tensor(np.asarray(batch["Rt_01"][0, :3, :4]), device=device)
        err3d = torch.linalg.norm(transform_points_Rt(c_xyz0[0], Rt) - c_xyz1[0], dim=-1)
        err3d = err3d.cpu().numpy()[sel]
        uv0 = uv0[0].cpu().numpy()[sel] / sf
        uv1 = uv1[0].cpu().numpy()[sel] / sf

        pair_dir = os.path.join(out_dir, f"pair_{i}")
        os.makedirs(pair_dir, exist_ok=True)
        if err3d.size:  # err.max() of an empty match set would raise
            render_pair(np.asarray(batch["image_0"][0]), np.asarray(batch["image_1"][0]),
                        uv0, uv1, err3d, os.path.join(pair_dir, "matches.png"))
        # a pair can yield no finite-weight match (every xyz row invalid):
        # 0 matches and no mean, not a NaN
        mean_err = float(err3d.mean()) if err3d.size else None
        with open(os.path.join(pair_dir, "errors.json"), "w") as f:
            json.dump({"pair_id": str(batch.get("pair_id", [i])[0]),
                       "num_matches": int(err3d.size),
                       "err3d_mean": mean_err,
                       "err3d": err3d.tolist()}, f)
        logger.info("pair %d: %d matches, mean 3D err %s m -> %s", i, err3d.size,
                    "n/a" if mean_err is None else f"{mean_err:.4f}", pair_dir)
    return out_dir


entry = main("navi_correspondence")(run)

if __name__ == "__main__":
    entry()
