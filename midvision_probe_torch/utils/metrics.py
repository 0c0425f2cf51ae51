"""Depth evaluation metrics (counterpart of the JAX package's
``utils/metrics.py``, depth subset) on torch tensors.

Depth maps are (B, H, W) or (B, H, W, 1); segmentation maps (B, H, W) int
panoptic ids (OneFormer ADE20k-150). Per-image metrics come back as (B,)
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

# OneFormer ADE20k panoptic id split (reference
# ``evals/utils/oneformer_id2label.py:154-206``); ids {11, 17, 40, 68} are
# in neither list
STUFF = (0, 1, 2, 3, 4, 5, 6, 9, 13, 16, 21, 26, 29, 46, 52, 60, 91, 94, 96,
         106, 113, 128)
THINGS = tuple(i for i in range(150) if i not in STUFF and i not in (11, 17, 40, 68))


def _squeeze_chan(x):
    return x[..., 0] if x.ndim == 4 and x.shape[-1] == 1 else x


def _safe_div(num, den, eps=1e-6):
    return num / torch.where(den == 0, torch.full_like(den, eps), den)


def match_scale_and_shift(prediction, target):
    """Closed-form per-image least-squares scale/shift alignment."""
    four_chan = prediction.ndim == 4
    prediction, target = _squeeze_chan(prediction), _squeeze_chan(target)
    mask = (target > 0).float()
    a_00 = (mask * prediction * prediction).sum(dim=(1, 2))
    a_01 = (mask * prediction).sum(dim=(1, 2))
    a_11 = mask.sum(dim=(1, 2))
    b_0 = (mask * prediction * target).sum(dim=(1, 2))
    b_1 = (mask * target).sum(dim=(1, 2))

    det = a_00 * a_11 - a_01 * a_01
    valid = det != 0
    safe_det = torch.where(valid, det, torch.ones_like(det))
    scale = torch.where(valid, (a_11 * b_0 - a_01 * b_1) / safe_det,
                        torch.ones_like(det))
    shift = torch.where(valid, (-a_01 * b_0 + a_00 * b_1) / safe_det,
                        torch.zeros_like(det))
    out = prediction * scale[:, None, None] + shift[:, None, None]
    return out[..., None] if four_chan else out


def depth_rmse(depth_pr, depth_gt, image_average=False):
    depth_pr, depth_gt = _squeeze_chan(depth_pr), _squeeze_chan(depth_gt)
    valid = (depth_gt > 0).float()
    num_valid = valid.sum(dim=(1, 2)).clamp_min(1)
    rmse = torch.sqrt((((depth_gt - depth_pr) ** 2) * valid).sum(dim=(1, 2))
                      / num_valid)
    return rmse.mean() if image_average else rmse


def _threshold_metrics(depth_pr, depth_gt, mask):
    """d1/d2/d3 + rmse under a pixel mask; dict of (B,)."""
    num = mask.sum(dim=(1, 2))
    thresh = torch.maximum(depth_gt / depth_pr.clamp_min(1e-9),
                           depth_pr / depth_gt.clamp_min(1e-9))
    out = {}
    for k in (1, 2, 3):
        out[f"d{k}"] = _safe_div(((thresh < 1.25**k).float() * mask).sum(dim=(1, 2)),
                                 num)
    sse = (depth_gt - depth_pr) ** 2
    out["rmse"] = torch.sqrt(_safe_div((sse * mask).sum(dim=(1, 2)), num))
    return out


def _level_masks(valid, num_levels):
    """Concentric centroid-level region masks."""
    B, H, W = valid.shape
    masks = []
    cumulative = torch.zeros_like(valid)
    for level in range(1, num_levels + 1):
        offset = (H // num_levels) * (num_levels - level) // 2
        m = torch.zeros((H, W), device=valid.device)
        m[offset: H - offset, offset: W - offset] = 1.0
        m = (m[None].expand(B, H, W) - cumulative).clamp_min(0) * valid
        cumulative = cumulative + m
        masks.append(m)
    return masks


def evaluate_depth(depth_pr, depth_gt, segmentation_map=None, image_average=False,
                   scale_invariant=False, num_levels=5, is_navi=False):
    """Global + stuff/things + centroid-level depth metrics. Returns
    ``(global_metrics, metrics_by_level)`` dicts of (B,) tensors (scalars
    if ``image_average``)."""
    depth_pr, depth_gt = _squeeze_chan(depth_pr), _squeeze_chan(depth_gt)
    if scale_invariant:
        depth_pr = match_scale_and_shift(depth_pr, depth_gt)

    valid = (depth_gt > 0).float()
    depth_pr = depth_pr * valid
    num_valid = valid.sum(dim=(1, 2))

    mean_pred = _safe_div((depth_pr * valid).sum(dim=(1, 2)), num_valid)
    var_pred = _safe_div(
        (((depth_pr - mean_pred[:, None, None]) ** 2) * valid).sum(dim=(1, 2)),
        num_valid)
    mean_gt = _safe_div((depth_gt * valid).sum(dim=(1, 2)), num_valid)
    var_gt = _safe_div(
        (((depth_gt - mean_gt[:, None, None]) ** 2) * valid).sum(dim=(1, 2)),
        num_valid)

    g = _threshold_metrics(depth_pr, depth_gt, valid)
    g.update(
        mean_pred=mean_pred,
        std_pred=torch.sqrt(var_pred),
        variance_pred=var_pred,
        mean_gt=mean_gt,
        std_gt=torch.sqrt(var_gt),
        variance_gt=var_gt,
        variance_ratio=_safe_div(var_pred, var_gt),
    )

    if not is_navi and segmentation_map is not None:
        seg = segmentation_map
        stuff_mask = torch.isin(seg, torch.tensor(STUFF, device=seg.device)).float() * valid
        things_mask = torch.isin(seg, torch.tensor(THINGS, device=seg.device)).float() * valid
        sm = _threshold_metrics(depth_pr, depth_gt, stuff_mask)
        tm = _threshold_metrics(depth_pr, depth_gt, things_mask)
        g.update({f"stuff_{k}": v for k, v in sm.items()})
        g.update({f"things_{k}": v for k, v in tm.items()})
        g["stuff_pixels"] = stuff_mask.sum(dim=(1, 2))
        g["things_pixels"] = things_mask.sum(dim=(1, 2))

    by_level = {f"level_{i + 1}": _threshold_metrics(depth_pr, depth_gt, m)
                for i, m in enumerate(_level_masks(valid, num_levels))}

    if image_average:
        g = {k: v.mean() for k, v in g.items()}
        by_level = {lk: {k: v.mean() for k, v in lv.items()}
                    for lk, lv in by_level.items()}
    return g, by_level


def segment_metrics_depth(depth_pr, depth_gt, segmentation_map,
                          scale_invariant=False):
    """Per-segment d1 vs area; host-side numpy (inputs numpy or tensors)."""
    if scale_invariant:
        depth_pr = match_scale_and_shift(torch.as_tensor(np.asarray(depth_pr)),
                                         torch.as_tensor(np.asarray(depth_gt)))
    depth_pr = np.asarray(_squeeze_chan(np.asarray(depth_pr)))
    depth_gt = np.asarray(_squeeze_chan(np.asarray(depth_gt)))
    seg = np.asarray(segmentation_map)
    valid = (depth_gt > 0).astype(np.float32)
    pr = depth_pr * valid
    thresh = np.maximum(depth_gt / np.clip(pr, 1e-9, None),
                        pr / np.clip(depth_gt, 1e-9, None))
    hit = (thresh < 1.25).astype(np.float32)

    out = []
    for segment_id in np.unique(seg):
        m = (seg == segment_id).astype(np.float32) * valid
        area = m.sum(axis=(1, 2))
        safe = np.where(area == 0, 1e-6, area)
        d1 = (hit * m).sum(axis=(1, 2)) / safe
        for b in range(pr.shape[0]):
            out.append({
                "segment_id": int(segment_id),
                "image_idx": b,
                "area": float(safe[b]),
                "d1_ratio": float(d1[b]),
            })
    return out
