"""Brute-force ground-truth oracle for the pair-fairness property.

Copy of ``fairify_tpu/verify/oracle.py`` for the port's tests and
``chip_smoke.py`` (the port imports nothing of ``fairify_tpu``).

Enumerates every legal ``(x, x')`` pair of a query over a small integer box
— the ground truth the reference would obtain from Z3's complete search
(``src/GC/Verify-GC.py:134-154``).  Deliberately *independent* of the
engine's own property machinery: legality is re-derived here from the query
definition (all protected attributes differ, shared attributes equal,
relaxed attributes within ±ε, both points' non-relaxed coordinates inside
the box), with none of ``property.encode``'s assignment/valid-pair tensors
or ``engine.decide_leaf``'s enumeration reused — so a bug there cannot
cancel out in the comparison.  Only the exact rational sign evaluator is
shared.  Exponential in the domain, so strictly a testing device: the
port's engine tests and ``chip_smoke.py``'s tiny case are built on it.
"""
from __future__ import annotations

import itertools

import numpy as np

from fairify_tpu_torch.data.domains import DomainSpec
from fairify_tpu_torch.models import mlp
from fairify_tpu_torch.verify import engine


def tiny_domain(ranges) -> DomainSpec:
    return DomainSpec(name="tiny", label="y", ranges=dict(ranges))


def random_net(rng, sizes, scale=1.0, device="cpu") -> mlp.MLP:
    ws, bs = [], []
    for i in range(len(sizes) - 1):
        ws.append((scale * rng.normal(size=(sizes[i], sizes[i + 1]))).astype(np.float32))
        bs.append((scale * rng.normal(size=(sizes[i + 1],))).astype(np.float32))
    return mlp.from_numpy(ws, bs, device=device)


def exact_sign(net, x) -> int:
    weights, biases = net.numpy_params()
    return engine.exact_logit_sign(weights, biases, x)


def brute_force_verdict(net, query, lo, hi) -> str:
    """Exhaustive pair enumeration: ``'sat'`` iff any legal pair strictly flips.

    ``x`` ranges over every lattice point of the box.  ``x'`` agrees with
    ``x`` off the protected/relaxed attributes, differs from it on *every*
    protected attribute (within the box), and sits within ±ε of it on each
    relaxed attribute (ε displacements are not re-clamped to the box,
    matching the engine's relaxed semantics).
    """
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    d = len(query.columns)
    pa = sorted(int(i) for i in query.pa_idx)
    ra = [int(i) for i in query.ra_idx]
    eps = int(query.relax_eps)

    signs = {}

    def sign_of(pt) -> int:
        if pt not in signs:
            signs[pt] = exact_sign(net, np.array(pt, dtype=np.int64))
        return signs[pt]

    for x in itertools.product(*(range(lo[i], hi[i] + 1) for i in range(d))):
        sx = sign_of(x)
        if sx == 0:
            continue  # a strict flip needs two nonzero, opposite signs
        pa_axes = [[v for v in range(lo[i], hi[i] + 1) if v != x[i]] for i in pa]
        ra_axes = [range(x[r] - eps, x[r] + eps + 1) for r in ra] if eps else []
        for pa_vals in itertools.product(*pa_axes):
            for ra_vals in itertools.product(*ra_axes) if ra_axes else [()]:
                xp = list(x)
                for i, v in zip(pa, pa_vals):
                    xp[i] = v
                for r, v in zip(ra, ra_vals):
                    xp[r] = v
                sp = sign_of(tuple(xp))
                if (sx > 0 and sp < 0) or (sx < 0 and sp > 0):
                    return "sat"
    return "unsat"
