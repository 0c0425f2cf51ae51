"""Depth, surface-normal and objectness losses (counterpart of the JAX
package's ``utils/losses.py``) on NHWC tensors.

Validity is handled with masks (sums over valid pixels) rather than boolean
indexing, as in the JAX package. Kept from there:

* the gradient-loss axis fix: the reference slices ``depth[::2i, ::2i]`` on
  a (B, 1, H, W) tensor, i.e. the batch/channel axes; here H and W are
  strided, which is the intended multi-scale spatial loss;
* the NaN guards at depth holes: both the target and the prediction are
  replaced by 1 where the target is invalid before the log, so a negative
  prediction at a hole cannot produce NaN (NaN * 0 is NaN).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _masked_mean(x, mask):
    """Mean of ``x`` over the pixels where ``mask`` is 1 (no fewer than one
    in the denominator)."""
    return (x * mask).sum() / mask.sum().clamp_min(1.0)


def _cosine_similarity(a, b, dim=-1, eps=1e-8):
    """``torch.cosine_similarity`` as the JAX package writes it: each norm
    clamped to ``eps`` on its own."""
    na = torch.linalg.vector_norm(a, dim=dim)
    nb = torch.linalg.vector_norm(b, dim=dim)
    return (a * b).sum(dim) / (na.clamp_min(eps) * nb.clamp_min(eps))


def sig_loss(depth_pr, depth_gt, sigma=0.85, eps=0.001):
    """AdaBins-style SigLoss over all valid pixels of the batch."""
    valid = (depth_gt > 0).float()
    gt_safe = torch.where(depth_gt > 0, depth_gt, torch.ones_like(depth_gt))
    pr_safe = torch.where(depth_gt > 0, depth_pr, torch.ones_like(depth_pr))
    g = (torch.log(pr_safe + eps) - torch.log(gt_safe + eps)) * valid
    n = valid.sum().clamp_min(1)
    mean_g2 = (g**2).sum() / n
    mean_g = g.sum() / n
    return torch.sqrt(mean_g2 - sigma * mean_g**2)


def gradient_loss(depth_pr, depth_gt, eps=0.001):
    """Multi-scale log-depth spatial gradient loss; inputs (B, H, W, 1) or
    (B, H, W); scales: full + strides {2, 4, 6}."""
    if depth_pr.ndim == 4:
        depth_pr, depth_gt = depth_pr[..., 0], depth_gt[..., 0]
    total = 0.0
    for s in (1, 2, 4, 6):
        pr = depth_pr[:, ::s, ::s]
        gt = depth_gt[:, ::s, ::s]
        valid = (gt > 0).float()
        n = valid.sum().clamp_min(1)
        gt_safe = torch.where(gt > 0, gt, torch.ones_like(gt))
        pr_safe = torch.where(gt > 0, pr, torch.ones_like(pr))
        diff = (torch.log(pr_safe + eps) - torch.log(gt_safe + eps)) * valid
        v_grad = (diff[:, :-2, :] - diff[:, 2:, :]).abs()
        v_valid = valid[:, :-2, :] * valid[:, 2:, :]
        h_grad = (diff[:, :, :-2] - diff[:, :, 2:]).abs()
        h_valid = valid[:, :, :-2] * valid[:, :, 2:]
        total = total + ((h_grad * h_valid).sum() + (v_grad * v_valid).sum()) / n
    return total


def depth_loss(pred, target, weight_sig=10.0, weight_grad=0.5, max_depth=10.0):
    """``DepthLoss``: targets beyond max_depth are zeroed (ignored)."""
    target = torch.where(target > max_depth, torch.zeros_like(target), target)
    return (weight_sig * sig_loss(pred, target)
            + weight_grad * gradient_loss(pred, target))


def angular_loss(snorm_pr, snorm_gt, mask, uncertainty_aware=False, eps=1e-4):
    """Bae et al. angular loss, with the kappa NLL when
    ``uncertainty_aware`` (``losses.py:157-182``): the cosine is clipped to
    ``±(1 - eps)`` before ``arccos`` (a clipped pixel has zero gradient);
    kappa is ``elu(x) + 1.01`` of the fourth channel.

    snorm_pr: (B, H, W, 3|4); snorm_gt: (B, H, W, 3); mask: (B, H, W, 1)."""
    m = mask[..., 0].float()
    ang = torch.arccos(torch.clamp(_cosine_similarity(snorm_pr[..., :3], snorm_gt),
                                   -1 + eps, 1 - eps))
    if uncertainty_aware:
        kappa = F.elu(snorm_pr[..., 3]) + 1.01
        kappa_reg = torch.log1p(torch.exp(-kappa * math.pi)) - torch.log(kappa**2 + 1)
        ang = kappa_reg + kappa * ang
    return _masked_mean(ang, m)


def snorm_l1_loss(snorm_pr, snorm_gt, mask):
    """Masked mean over pixels of the channel-mean L1 (``losses.py:185-200``)."""
    m = mask[..., 0].float()
    return _masked_mean((snorm_pr[..., :3] - snorm_gt).abs().mean(dim=-1), m)


def binary_cross_entropy(pred, target, eps=1e-7):
    """torch ``nn.BCELoss`` on ``pred`` clipped to [eps, 1 - eps] (the
    objectness trainer, ``train_generic_objectness.py:575``)."""
    pred = pred.clamp(eps, 1 - eps)
    return -(target * torch.log(pred) + (1 - target) * torch.log1p(-pred)).mean()
