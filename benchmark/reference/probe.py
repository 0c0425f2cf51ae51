"""Plain float32 depth probe and its training step: the benchmark's
reference for the probe layer.

Written from the probing paper's protocol (El Banani et al. 2024,
"Probing the 3D Awareness of Visual Foundation Models", its ``probes.py``,
``losses.py`` and ``train_depth.py``):

* ``tap.tap_norm_{i}``: a BatchNorm over each tapped map, trained with the
  probe, normalising by the batch's mean and biased variance (eps 1e-5);
* the DPT decoder's transformer branch: a 1x1 convolution per tap, four
  fusion blocks of residual conv units (``relu(conv2(relu(conv1(x)))) +
  x``) whose first unit takes its tap nearest-upsampled 2x, a nearest 4x
  upsample into ``out_conv_0``, ``out_conv_1`` to 256 bins;
* bin depth: ``relu(x) + 0.1`` normalised over the bins, the expectation
  over 256 depths evenly spaced from ``min_depth`` to ``max_depth``, then
  the decoder's final nearest 2x (a per-pixel reduction commutes exactly
  with a nearest upsample, so it is applied after the reduction);
* the depth loss: 10 x SigLoss + 0.5 x the multi-scale log-depth gradient
  loss, targets beyond ``max_depth`` ignored;
* AdamW (betas 0.9, 0.999, eps 1e-8, decoupled weight decay 0.01) at the
  cosine schedule with linear warm-up, by hand.

The program folds each nearest upsample into the convolution after it;
here the upsample is materialised, as published. Imports torch alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NUM_BINS = 256
BN_EPS = 1e-5


def param_shapes(cfg: dict, channels: int) -> dict[str, tuple[int, ...]]:
    """Trained parameters of the tap norms and the DPT depth head under the
    program's names; ``channels``: one tap's width."""
    p = cfg["probe"]
    hd, k = p["hidden_dim"], p["kernel_size"]
    shapes = {}
    if cfg["add_norm"]:
        for i in range(4):
            shapes[f"tap.tap_norm_{i}.weight"] = (channels,)
            shapes[f"tap.tap_norm_{i}.bias"] = (channels,)
    d = "probe.decoder."
    for i in range(4):
        shapes[f"{d}conv_{i}.weight"] = (hd, channels, 1, 1)
        shapes[f"{d}conv_{i}.bias"] = (hd,)
    for i in range(4):
        units = ("resConfUnit2",) if i == 3 else ("resConfUnit1", "resConfUnit2")
        for u in units:
            for c in ("conv1", "conv2"):
                shapes[f"{d}ref_{i}.{u}.{c}.weight"] = (hd, hd, k, k)
                shapes[f"{d}ref_{i}.{u}.{c}.bias"] = (hd,)
    shapes[f"{d}out_conv_0.weight"] = (hd, hd, 3, 3)
    shapes[f"{d}out_conv_0.bias"] = (hd,)
    shapes[f"{d}out_conv_1.weight"] = (NUM_BINS, hd, 3, 3)
    shapes[f"{d}out_conv_1.bias"] = (NUM_BINS,)
    return shapes


def buffer_shapes(cfg: dict, channels: int) -> dict[str, tuple[int, ...]]:
    """The tap norms' running statistics (not trained, not compared)."""
    if not cfg["add_norm"]:
        return {}
    out = {}
    for i in range(4):
        out[f"tap.tap_norm_{i}.running_mean"] = (channels,)
        out[f"tap.tap_norm_{i}.running_var"] = (channels,)
    return out


def _conv(x, params, name, pad):
    return F.conv2d(x, params[name + ".weight"], params[name + ".bias"], padding=pad)


def _up(x, factor):
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def _rcu(x, params, name, pad):
    h = F.relu(_conv(x, params, name + ".conv1", pad))
    return F.relu(_conv(h, params, name + ".conv2", pad)) + x


def _batch_norm(x, weight, bias):
    """(B, H, W, C): normalised by the batch's statistics per channel."""
    dims = (0, 1, 2)
    mean = x.mean(dim=dims)
    var = ((x - mean) ** 2).mean(dim=dims)
    return (x - mean) * (weight * torch.rsqrt(var + BN_EPS)) + bias


def predict(params: dict, cfg: dict, taps: list[torch.Tensor]) -> torch.Tensor:
    """Four (B, h, w, C) tap maps -> depth (B, 16h, 16w, 1)."""
    p = cfg["probe"]
    pad = p["kernel_size"] // 2
    if cfg["add_norm"]:
        taps = [_batch_norm(t, params[f"tap.tap_norm_{i}.weight"],
                            params[f"tap.tap_norm_{i}.bias"]) for i, t in enumerate(taps)]
    d = "probe.decoder."
    xs = [_conv(t.permute(0, 3, 1, 2), params, f"{d}conv_{i}", 0) for i, t in enumerate(taps)]
    out = _rcu(_up(xs[3], 2), params, f"{d}ref_3.resConfUnit2", pad)
    for i in (2, 1, 0):
        skip = _rcu(_up(xs[i], 2), params, f"{d}ref_{i}.resConfUnit1", pad)
        out = _rcu(skip + out, params, f"{d}ref_{i}.resConfUnit2", pad)
    out = F.relu(_conv(_up(out, 4), params, f"{d}out_conv_0", 1))
    out = _conv(out, params, f"{d}out_conv_1", 1)
    prob = F.relu(out) + 0.1
    prob = prob / prob.sum(dim=1, keepdim=True)
    bins = torch.linspace(p["min_depth"], p["max_depth"], NUM_BINS, device=out.device)
    depth = torch.einsum("bkhw,k->bhw", prob, bins)[:, None]
    return _up(depth, 2).permute(0, 2, 3, 1)


def resize_to(pred: torch.Tensor, hw) -> torch.Tensor:
    """(B, h, w, 1) -> (B, H, W, 1), bilinear, ``align_corners=False``, as
    the trainer resizes a prediction to its target."""
    if tuple(pred.shape[1:3]) == tuple(hw):
        return pred
    out = F.interpolate(pred.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def _log_diff(pred, target, eps):
    valid = (target > 0).float()
    gt = torch.where(target > 0, target, torch.ones_like(target))
    pr = torch.where(target > 0, pred, torch.ones_like(pred))
    return (torch.log(pr + eps) - torch.log(gt + eps)) * valid, valid


def depth_loss(pred: torch.Tensor, target: torch.Tensor, max_depth: float) -> torch.Tensor:
    """(B, H, W, 1) prediction and target -> the scalar training loss."""
    target = torch.where(target > max_depth, torch.zeros_like(target), target)
    g, valid = _log_diff(pred, target, 0.001)
    n = valid.sum().clamp_min(1)
    sig = torch.sqrt((g**2).sum() / n - 0.85 * (g.sum() / n) ** 2)
    pred, target = pred[..., 0], target[..., 0]
    grad = 0.0
    for s in (1, 2, 4, 6):
        diff, valid = _log_diff(pred[:, ::s, ::s], target[:, ::s, ::s], 0.001)
        v = (diff[:, :-2] - diff[:, 2:]).abs() * valid[:, :-2] * valid[:, 2:]
        h = (diff[:, :, :-2] - diff[:, :, 2:]).abs() * valid[:, :, :-2] * valid[:, :, 2:]
        grad = grad + (v.sum() + h.sum()) / valid.sum().clamp_min(1)
    return 10.0 * sig + 0.5 * grad


def lr_factor(step: int, max_step: float, warmup: float, min_factor: float = 0.01) -> float:
    """Linear warm-up from ``min_factor`` to 1, then a quarter cosine down
    to ``min_factor``; ``step`` counts updates from 0."""
    if step <= warmup:
        return (1 - min_factor) * step / max(warmup, 1e-8) + min_factor
    rel = min((step - warmup) / (max_step - warmup), 1.0)
    return (1 - min_factor) * math.cos(0.5 * rel * math.pi) + min_factor


def schedule(cfg: dict) -> tuple[float, float, float]:
    """(base lr, total updates, warm-up updates) of the configuration."""
    o = cfg["optimizer"]
    steps = o["steps_per_epoch"]
    return o["probe_lr"], max(o["n_epochs"] * steps, 1), max(o["warmup_epochs"] * steps, 1e-6)


@torch.no_grad()
def adamw_step(params: dict, grads: dict, state: dict, step: int, lr: float,
               betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.01) -> None:
    """One decoupled-weight-decay Adam update of every tensor in ``params``
    (``step`` counts from 0; ``state`` holds the moments)."""
    b1, b2 = betas
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.mul_(1 - lr * weight_decay)
        c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
        p.sub_(lr / c1 * m / (v.sqrt() / math.sqrt(c2) + eps))


def train_steps(params0: dict, cfg: dict, taps: list[list[torch.Tensor]],
                targets: list[torch.Tensor]) -> dict:
    """Follow the probe's first training steps from ``params0``, one step a
    batch of ``taps`` and ``targets``: each step's loss, the first step's
    prediction (resized to its target) and gradient, and the parameters after the last step."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    base, total, warm = schedule(cfg)
    max_depth = cfg["probe"]["max_depth"]
    state: dict = {}
    out: dict = {"losses": []}
    for step, (tap, target) in enumerate(zip(taps, targets)):
        with torch.enable_grad():
            pred = resize_to(predict(params, cfg, tap), target.shape[1:3])
            loss = depth_loss(pred, target, max_depth)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if step == 0:
            out["pred"] = pred.detach()
            out["first_grad"] = {k: g.clone() for k, g in grads.items()}
        out["losses"].append(float(loss.detach()))
        adamw_step(params, grads, state, step, base * lr_factor(step, total, warm))
    out["params"] = {k: v.detach() for k, v in params.items()}
    return out
