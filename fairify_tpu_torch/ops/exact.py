"""Exact rational certification of dead-neuron masks (host-side).

Port of ``fairify_tpu/ops/exact.py``.  It replaces the reference's
per-neuron Z3 "singular verification" (``utils/prune.py:276-364``) with a
closed-form exact computation, and the replacement is an equivalence, not
an approximation:

Each reference query asks, for neuron *n* of layer *ℓ*: "is there a point in
the constraint box with pre-activation > 0?".  Its constraint set is exactly
an axis-aligned box — the integer input domain for ℓ=0
(``input_domain_constraint``, ``utils/prune.py:253-263``) or the previous
layer's interval box for ℓ>0 (``intermediate_domain_constraint``,
``utils/prune.py:266-273``) — and the objective ``w·x + b`` is linear.  The
maximum of a linear function over a box is attained at the sign-split corner,
which is precisely the interval-arithmetic upper bound; for ℓ=0 the box
corners are integers, so integrality adds nothing.  Therefore the Z3 verdict
equals the sign of the exact-rational IBP upper bound, computed here with
`fractions.Fraction` (float32 weights are dyadic rationals, so the conversion
is exact).  Unlike the float32 device bounds this pass cannot suffer
round-off: it is the soundness anchor of pruning.

The device float bounds (``fairify_tpu_torch.ops.interval``) are the fast
filter; this pass certifies (or vetoes) every neuron the filter proposes to
prune.  :func:`certify_dead_masks` takes the native core
(:mod:`fairify_tpu_torch.ops.exact_native`) when it is available.
"""
from __future__ import annotations

from fractions import Fraction
from typing import List, Sequence, Tuple

import numpy as np

from fairify_tpu_torch.ops import exact_native

_ZERO = Fraction(0)


def _layer_interval(
    w: np.ndarray, b: np.ndarray, lb: List[Fraction], ub: List[Fraction]
) -> Tuple[List[Fraction], List[Fraction]]:
    """Exact sign-split interval image of ``x @ w + b`` over the box [lb, ub].

    The single soundness-critical inner loop, shared by the bounds pass and
    the certification pass (mirrors ``neuron_bounds``, ``utils/prune.py:132-149``).
    """
    wf = [[Fraction(float(v)) for v in row] for row in np.asarray(w, dtype=np.float64)]
    bf = [Fraction(float(v)) for v in np.asarray(b, dtype=np.float64)]
    lo_l, hi_l = [], []
    for j in range(len(bf)):
        mn = bf[j]
        mx = bf[j]
        for i in range(len(wf)):
            wij = wf[i][j]
            if wij < 0:
                mn += wij * ub[i]
                mx += wij * lb[i]
            else:
                mn += wij * lb[i]
                mx += wij * ub[i]
        lo_l.append(mn)
        hi_l.append(mx)
    return lo_l, hi_l


def _relu_box(
    lo_l: List[Fraction], hi_l: List[Fraction], dead_row: np.ndarray | None
) -> Tuple[List[Fraction], List[Fraction]]:
    """Post-activation box: ReLU clamp, with dead neurons pinned to [0, 0]."""
    lb = [
        _ZERO if (dead_row is not None and dead_row[j] > 0.5) else max(_ZERO, v)
        for j, v in enumerate(lo_l)
    ]
    ub = [
        _ZERO if (dead_row is not None and dead_row[j] > 0.5) else max(_ZERO, v)
        for j, v in enumerate(hi_l)
    ]
    return lb, ub


def _input_box(lo: Sequence[int], hi: Sequence[int]):
    return [Fraction(int(v)) for v in lo], [Fraction(int(v)) for v in hi]


def exact_network_bounds(
    weights: Sequence[np.ndarray],
    biases: Sequence[np.ndarray],
    lo: Sequence[int],
    hi: Sequence[int],
    alive: Sequence[np.ndarray] | None = None,
):
    """Exact ws/pl bounds per layer over the integer input box [lo, hi].

    Mirrors ``neuron_bounds`` (``utils/prune.py:105-164``) in rational
    arithmetic.  ``alive`` masks (1 = alive) pin pruned neurons to [0, 0],
    matching excision.  Returns (ws_lb, ws_ub, pl_lb, pl_ub) as nested lists
    of Fractions.
    """
    n = len(weights)
    lb, ub = _input_box(lo, hi)
    ws_lb, ws_ub, pl_lb, pl_ub = [], [], [], []
    for l in range(n):
        lo_l, hi_l = _layer_interval(weights[l], biases[l], lb, ub)
        ws_lb.append(lo_l)
        ws_ub.append(hi_l)
        if l == n - 1:
            pl_lo, pl_hi = lo_l, hi_l
        else:
            dead_row = None
            if alive is not None:
                dead_row = 1.0 - np.asarray(alive[l], dtype=np.float64)
            pl_lo, pl_hi = _relu_box(lo_l, hi_l, dead_row)
        pl_lb.append(pl_lo)
        pl_ub.append(pl_hi)
        lb, ub = pl_lo, pl_hi
    return ws_lb, ws_ub, pl_lb, pl_ub


def certify_dead_masks(
    weights: Sequence[np.ndarray],
    biases: Sequence[np.ndarray],
    lo: Sequence[int],
    hi: Sequence[int],
    proposed_dead: Sequence[np.ndarray],
) -> List[np.ndarray]:
    """Exact-rational veto of a proposed dead-mask set.

    A proposed-dead neuron is certified iff its *exact* pre-activation upper
    bound over the box is ≤ 0, where the bound is computed on the network
    with previously certified layers' masks applied (layer-by-layer, like the
    reference's sequential sweep).  Uncertifiable proposals are revived, so
    the returned masks are sound regardless of float round-off on device.

    The output layer is never dead (``utils/prune.py:235-236``).  The
    native core answers when it is available; otherwise
    :func:`certify_dead_fraction` does.
    """
    native = exact_native.certify_dead(weights, biases, lo, hi, proposed_dead)
    if native is not None:
        return native[: len(proposed_dead)]
    return certify_dead_fraction(weights, biases, lo, hi, proposed_dead)


def certify_dead_fraction(
    weights: Sequence[np.ndarray],
    biases: Sequence[np.ndarray],
    lo: Sequence[int],
    hi: Sequence[int],
    proposed_dead: Sequence[np.ndarray],
) -> List[np.ndarray]:
    """:func:`certify_dead_masks` in ``Fraction`` arithmetic, whatever the
    native core's state."""
    n = len(weights)
    certified = [np.zeros_like(np.asarray(d), dtype=np.float64) for d in proposed_dead]
    lb, ub = _input_box(lo, hi)
    for l in range(n - 1):
        lo_l, hi_l = _layer_interval(weights[l], biases[l], lb, ub)
        proposed = np.asarray(proposed_dead[l])
        for j in range(len(lo_l)):
            if proposed[j] > 0.5 and hi_l[j] <= 0:
                certified[l][j] = 1.0
        lb, ub = _relu_box(lo_l, hi_l, certified[l])
    return [np.asarray(c, dtype=np.float32) for c in certified]
