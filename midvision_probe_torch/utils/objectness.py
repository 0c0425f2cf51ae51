"""Objectness metrics (copy of the JAX package's ``utils/objectness.py``),
numpy, shared by the probe trainer and, once ported, the MaskCut evaluator.

The reference duplicates these in both drivers
(``train_generic_objectness.py:56-183`` and
``evaluate_generic_objectness.py:50-177``); one numpy implementation here.
"""

from __future__ import annotations

import numpy as np


def compute_precision_recall(pred_mask, gt_mask):
    """``train_generic_objectness.py:56-82`` (eps-denominator variant)."""
    TP = np.logical_and(pred_mask == 1, gt_mask == 1).sum()
    FP = np.logical_and(pred_mask == 1, gt_mask == 0).sum()
    FN = np.logical_and(pred_mask == 0, gt_mask == 1).sum()
    precision = TP / (TP + FP + 1e-6)
    recall = TP / (TP + FN + 1e-6)
    return float(precision), float(recall)


def compute_f_measure(precision, recall, beta=0.3):
    """``:85-101``; note beta is squared inside."""
    beta_sq = beta**2
    return float(
        (1 + beta_sq) * (precision * recall) / (beta_sq * precision + recall + 1e-6)
    )


def compute_iou(pred_mask, gt_mask, threshold=0.5):
    """``:104-127``."""
    p = (pred_mask >= threshold).astype(np.uint8)
    inter = np.logical_and(p == 1, gt_mask == 1).sum()
    union = np.logical_or(p == 1, gt_mask == 1).sum()
    return float(inter / (union + 1e-6))


def compute_accuracy(pred_mask, gt_mask, threshold=0.5):
    """``:130-153``."""
    p = (pred_mask >= threshold).astype(np.uint8)
    return float((p == gt_mask).mean())


def compute_corloc(pred_mask, gt_mask, threshold=0.5):
    """``:156-183``: 1 iff IoU of the binarized masks >= threshold."""
    return 1 if compute_iou(pred_mask, gt_mask, threshold) >= threshold else 0


def evaluate_binary_masks(pred, gt, threshold=0.5, reduce=True):
    """Batch (B, H, W[, 1]) float masks → averaged metric dict.

    ``reduce=False`` returns the per-sample lists instead, so callers can
    aggregate across uneven loader shards (multi-process validation
    allgathers per-sample rows before the mean).

    Per-IMAGE metrics by design: the reference's trainer validate pools
    the whole batch into one mask blob (``train_generic_objectness.py:
    445-454``), making its numbers batch-size dependent; its per-image
    eval driver (``evaluate_generic_objectness.py:209-233``) is the
    intended semantics and the one mirrored here (see README
    "Deliberate non-ports")."""
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    if pred.ndim == 4:
        pred = pred[..., 0]
    if gt.ndim == 4:
        gt = gt[..., 0]
    rows = {"F-measure": [], "IoU": [], "Accuracy": [], "CorLoc": []}
    for b in range(pred.shape[0]):
        pb = (pred[b] >= threshold).astype(np.uint8)
        gb = (gt[b] >= 0.5).astype(np.uint8)
        p, r = compute_precision_recall(pb, gb)
        rows["F-measure"].append(compute_f_measure(p, r))
        rows["IoU"].append(compute_iou(pred[b], gb, threshold))
        rows["Accuracy"].append(compute_accuracy(pred[b], gb, threshold))
        rows["CorLoc"].append(compute_corloc(pred[b], gb, threshold))
    if not reduce:
        return rows
    return {k: float(np.mean(v)) for k, v in rows.items()}
