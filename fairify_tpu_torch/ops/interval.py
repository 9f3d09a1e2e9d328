"""Batched interval bound propagation (IBP) over input boxes.

Port of ``fairify_tpu/ops/interval.py``: the sign-split interval image
``lb @ W⁺ + ub @ W⁻`` of every layer, widened outward by ``SOUND_SLACK`` to
absorb f32 round-off.  Leading batch axes on ``lb``/``ub`` are kept.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fairify_tpu_torch.utils import num as _num  # noqa: F401  (numeric policy)

# Outward widening applied to computed bounds to absorb f32 round-off.
SOUND_SLACK_REL = 1e-5
SOUND_SLACK_ABS = 1e-6


class LayerBounds(NamedTuple):
    """Bounds per layer: ws = pre-activation, pl = post-activation."""

    ws_lb: tuple
    ws_ub: tuple
    pl_lb: tuple
    pl_ub: tuple


def affine_interval(w, b, lb, ub):
    """Interval image of ``x @ w + b`` for ``x`` in ``[lb, ub]``."""
    wp = torch.clamp(w, min=0.0)
    wn = torch.clamp(w, max=0.0)
    lo = lb @ wp + ub @ wn + b
    hi = ub @ wp + lb @ wn + b
    return lo, hi


def widen(lo, hi):
    slack = SOUND_SLACK_REL * torch.maximum(lo.abs(), hi.abs()) + SOUND_SLACK_ABS
    return lo - slack, hi + slack


def network_bounds(net, lb, ub, widen_bounds: bool = True) -> LayerBounds:
    """WS/PL interval bounds of every layer for a batch of input boxes.

    Masked neurons propagate ``[0, 0]``; the final layer is linear, so its
    PL bounds equal its WS bounds.
    """
    ws_lb, ws_ub, pl_lb, pl_ub = [], [], [], []
    lo, hi = lb, ub
    n = net.depth
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        zlo, zhi = affine_interval(w, b, lo, hi)
        if widen_bounds:
            zlo, zhi = widen(zlo, zhi)
        ws_lb.append(zlo)
        ws_ub.append(zhi)
        if i == n - 1:
            plo, phi = zlo, zhi
        else:
            plo, phi = torch.relu(zlo) * m, torch.relu(zhi) * m
        pl_lb.append(plo)
        pl_ub.append(phi)
        lo, hi = plo, phi
    return LayerBounds(tuple(ws_lb), tuple(ws_ub), tuple(pl_lb), tuple(pl_ub))


def dead_from_ws_ub(bounds: LayerBounds) -> list:
    """Provably-dead masks (1 = dead) from WS upper bounds; the output
    layer is all-alive."""
    n = len(bounds.ws_ub)
    return [torch.zeros_like(ub) if i == n - 1 else (ub <= 0.0).to(ub.dtype)
            for i, ub in enumerate(bounds.ws_ub)]
