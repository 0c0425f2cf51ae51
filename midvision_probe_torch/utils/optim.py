"""Optimizer and schedule (counterpart of the JAX package's
``utils/optim.py``).

``make_adamw`` returns ``torch.optim.AdamW`` with the reference trainer's
settings (weight decay 0.01, eps 1e-8, betas 0.9/0.999) and a ``LambdaLR``
over ``cosine_decay_linear_warmup_factor``. Stepping the scheduler after
each optimizer step makes update ``t`` (0-based) use the factor at ``t``,
which is how optax evaluates its schedule at the pre-update count; with
decoupled decay ``p - lr*wd*p - lr*adam`` both frameworks compute the same
update.
"""

from __future__ import annotations

import math

import torch


def cosine_decay_linear_warmup_factor(current_step: float, max_step: float,
                                      warmup_step: float,
                                      min_factor: float = 0.01) -> float:
    """LR factor: linear warmup from ``min_factor`` to 1, then
    ``cos(0.5 * rel * pi)`` decay (a quarter period, as in the reference)
    down to ``min_factor``. ``rel`` is clamped at 1, so a loader that yields
    more steps than ``max_step`` never pushes the factor negative."""
    range_factor = 1 - min_factor
    if current_step <= warmup_step:
        return range_factor * (current_step / max(warmup_step, 1e-8)) + min_factor
    rel = min((current_step - warmup_step) / (max_step - warmup_step), 1.0)
    return range_factor * math.cos(0.5 * rel * math.pi) + min_factor


def cosine_decay_linear_warmup(base_lr: float, max_step: int, warmup_step: float,
                               min_factor: float = 0.01):
    """``step -> lr`` form of the factor schedule, scaled by ``base_lr``."""
    def schedule(step: float) -> float:
        return base_lr * cosine_decay_linear_warmup_factor(
            step, max_step, warmup_step, min_factor)

    return schedule


def make_adamw(params, base_lr: float, max_step: int, warmup_step: float,
               weight_decay: float = 0.01, betas=(0.9, 0.999), eps: float = 1e-8):
    """(AdamW, LambdaLR) pair; call ``scheduler.step()`` after every
    ``optimizer.step()``."""
    opt = torch.optim.AdamW(params, lr=base_lr, betas=betas, eps=eps,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: cosine_decay_linear_warmup_factor(
            step, max_step, warmup_step))
    return opt, sched


def get_linear_scaled_lr(base_lr, batch_size, base_batch_size):
    """Linear LR scaling rule (reference ``optim.py:105-121``)."""
    return base_lr * batch_size / base_batch_size
