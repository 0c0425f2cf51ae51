"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference, each held to the limit in
``limits/<cell>.json``.

* ``token_err``: over every position of every tap map, the largest
  ``|program - reference| / |reference|`` of its channel vector (the
  widest gap: one altered token reads about 1);
* ``image_err``: over the images of a prediction, the largest relative
  Frobenius gap;
* ``loss_gap``: over the checked steps, the largest relative gap of the
  loss;
* ``norm_gap``: over the leaves (parameters), the largest gap between the
  program's norm and the reference's, over the larger of the reference
  leaf's norm and the median leaf's (some gradients are all but zero);
  ``median_norm_gap``: the median leaf's such gap.
"""

from __future__ import annotations

import math

import torch

GRAD_FLOOR = 1e-3  # leaves whose reference gradient is under this x the median's


def token_err(program: torch.Tensor, reference: torch.Tensor) -> float:
    """(..., C) maps -> the largest relative gap of a position's vector."""
    if program.shape != reference.shape:
        return math.inf
    diff = (program.float() - reference).norm(dim=-1)
    return float((diff / reference.norm(dim=-1).clamp_min(1e-30)).max())


def image_err(program: torch.Tensor, reference: torch.Tensor) -> float:
    """(B, ...) -> the largest relative gap of an image."""
    if program.shape != reference.shape:
        return math.inf
    p, r = program.float().flatten(1), reference.flatten(1)
    return float(((p - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)).max())


def loss_gap(program: list[float], reference: list[float]) -> float:
    if len(program) != len(reference):
        return math.inf
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference))


def norm_gaps(program: dict, reference: dict, keep=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's (leaves
    in ``keep``, default all), over the larger of the reference leaf's norm
    and the median leaf's; a leaf the program lacks reads infinite."""
    names = [k for k in reference if keep is None or k in keep]
    ref = {k: float(reference[k].norm()) for k in names}
    median = sorted(ref.values())[len(ref) // 2]
    return {k: (abs(float(program[k].float().norm()) - ref[k]) / max(ref[k], median, 1e-30)
                if k in program else math.inf) for k in names}


def norm_gap(program: dict, reference: dict, keep=None) -> float:
    """The worst leaf's gap of norms."""
    return max(norm_gaps(program, reference, keep).values())


def median_norm_gap(program: dict, reference: dict, keep=None) -> float:
    """The median leaf's gap of norms: steady where one small leaf is noisy."""
    gaps = sorted(norm_gaps(program, reference, keep).values())
    return gaps[len(gaps) // 2]


def moved_leaves(first_grad: dict) -> set:
    """Leaves whose reference gradient is not nought to rounding: at least
    ``GRAD_FLOOR`` of the median leaf's norm."""
    norms = {k: float(g.norm()) for k, g in first_grad.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return {k for k, n in norms.items() if n >= GRAD_FLOOR * median}


def verdict(readings: dict, limits: dict) -> tuple[bool, int, dict]:
    """(correct, numbers over their limits, {name: {value, limit}})."""
    table, failed = {}, 0
    for name, entry in limits.items():
        value = readings.get(name, math.nan)
        ok = math.isfinite(value) and value <= entry["limit"]
        failed += not ok
        table[name] = {"value": value, "limit": entry["limit"]}
    return failed == 0, failed, table
