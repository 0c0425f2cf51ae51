"""Depth, surface-normal and objectness losses (counterpart of the JAX
package's ``utils/losses.py``) on NHWC tensors.

Validity is handled with masks (sums over valid pixels) rather than boolean
indexing, as in the JAX package. Kept from there:

* the gradient-loss axis fix: the reference slices ``depth[::2i, ::2i]`` on
  a (B, 1, H, W) tensor, i.e. the batch/channel axes; here H and W are
  strided, which is the intended multi-scale spatial loss;
* the NaN guards at depth holes: both the target and the prediction are
  replaced by 1 where the target is invalid before the log, so a negative
  prediction at a hole cannot produce NaN (NaN * 0 is NaN);
* the dtypes: a bf16 prediction stays bf16 until it meets a float32
  target, and a Python constant added to it is rounded to bf16 first, as
  JAX's weakly typed scalars are.

Every sum or count over the batch goes through ``multihost.batch_sum``:
inside a multi-process training step (``multihost.global_batch``) it sums
over the ranks, so each loss is the JAX loss of the global batch, its
normalisations by global valid-pixel counts included; elsewhere it is the
identity. Several sums of one loss travel in one all-reduce.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from midvision_probe_torch.parallel.multihost import batch_sum


def _sums(*terms: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Batch sums of float32 scalars, over the ranks in a global step."""
    return tuple(batch_sum(torch.stack(terms)).unbind())


def _masked_mean(x, mask):
    """Mean of ``x`` over the pixels where ``mask`` is 1 (no fewer than one
    in the denominator)."""
    total, n = _sums((x * mask).sum(), mask.sum())
    return total / n.clamp_min(1.0)


def _cosine_similarity(a, b, dim=-1, eps=1e-8):
    """``torch.cosine_similarity`` as the JAX package writes it: each norm
    clamped to ``eps`` on its own."""
    na = torch.sqrt((a * a).sum(dim))  # jnp.linalg.norm's order, in the input's dtype
    nb = torch.sqrt((b * b).sum(dim))
    return (a * b).sum(dim) / (na.clamp_min(eps) * nb.clamp_min(eps))


def sig_loss(depth_pr, depth_gt, sigma=0.85, eps=0.001):
    """AdaBins-style SigLoss over all valid pixels of the batch."""
    valid = (depth_gt > 0).float()
    gt_safe = torch.where(depth_gt > 0, depth_gt, torch.ones_like(depth_gt))
    pr_safe = torch.where(depth_gt > 0, depth_pr, torch.ones_like(depth_pr))
    g = (torch.log(pr_safe + pr_safe.new_tensor(eps)) - torch.log(gt_safe + eps)) * valid
    n, sum_g2, sum_g = _sums(valid.sum(), (g**2).sum(), g.sum())
    n = n.clamp_min(1)
    mean_g2 = sum_g2 / n
    mean_g = sum_g / n
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
        gt_safe = torch.where(gt > 0, gt, torch.ones_like(gt))
        pr_safe = torch.where(gt > 0, pr, torch.ones_like(pr))
        diff = (torch.log(pr_safe + pr_safe.new_tensor(eps))
                - torch.log(gt_safe + eps)) * valid
        v_grad = (diff[:, :-2, :] - diff[:, 2:, :]).abs()
        v_valid = valid[:, :-2, :] * valid[:, 2:, :]
        h_grad = (diff[:, :, :-2] - diff[:, :, 2:]).abs()
        h_valid = valid[:, :, :-2] * valid[:, :, 2:]
        n, grad_sum = _sums(valid.sum(),
                            (h_grad * h_valid).sum() + (v_grad * v_valid).sum())
        total = total + grad_sum / n.clamp_min(1)
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
        kappa = F.elu(snorm_pr[..., 3])
        kappa = kappa + kappa.new_tensor(1.01)
        kappa_reg = (torch.log1p(torch.exp(-kappa * kappa.new_tensor(math.pi)))
                     - torch.log(kappa**2 + 1))
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
    ll = target * torch.log(pred) + (1 - target) * torch.log1p(-pred)
    total, n = _sums(ll.sum(), ll.new_tensor(float(ll.numel())))
    return -(total / n)


def masked_l1_loss(preds, target, mask_valid=None):
    """``MaskedL1Loss``: the mean absolute error over the valid entries; a
    one-channel mask is repeated across the prediction's channels."""
    if mask_valid is None:
        mask_valid = torch.ones_like(preds, dtype=torch.bool)
    if preds.shape[-1] != mask_valid.shape[-1]:
        mask_valid = mask_valid.repeat_interleave(preds.shape[-1], dim=-1)
    m = mask_valid.to(preds.dtype)
    err = (preds - target).abs() * m
    # each sum as JAX has it: accumulated in float32, rounded to its dtype
    total, n = _sums(err.sum(dtype=torch.float32), m.sum(dtype=torch.float32))
    return total.to(err.dtype) / n.to(m.dtype).clamp_min(1)


def _gaussian_window(window_size: int, sigma: float) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32) - window_size // 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img1, img2, window_size=11, size_average=True):
    """SSIM of NHWC images with an 11x11 gaussian window (sigma 1.5) as a
    depthwise convolution with zero padding; C1 = 0.01^2, C2 = 0.03^2. The
    mean over everything, or per image with ``size_average=False``."""
    channel = img1.shape[-1]
    weight = _gaussian_window(window_size, 1.5).to(img1.device, img1.dtype)
    weight = weight.expand(channel, 1, window_size, window_size)

    def conv(x):
        return F.conv2d(x.permute(0, 3, 1, 2), weight, padding=window_size // 2,
                        groups=channel).permute(0, 2, 3, 1)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    s1 = conv(img1 * img1) - mu1_sq
    s2 = conv(img2 * img2) - mu2_sq
    s12 = conv(img1 * img2) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    m = ((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return m.mean() if size_average else m.mean(dim=(1, 2, 3))
