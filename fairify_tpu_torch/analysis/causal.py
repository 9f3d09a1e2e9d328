"""Causal-discrimination tester: black-box fairness rate with CI stopping.

Port of ``fairify_tpu/analysis/causal.py`` (numpy and scipy, no device
code; the reference's ``src/AC/metrics.py:40-264``,
``CausalDiscriminationDetector``): each round draws a *batch* of
non-protected assignments, sweeps every PA value for the whole batch in one
call of the black-box predictor, and applies the same Wald-interval
stopping rule (``_check_stopping_condition``, ``:243-257``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
from scipy import stats as scipy_stats


@dataclass
class CausalResult:
    rate: float
    tested: int
    discriminatory: int
    interval: Tuple[float, float]
    examples: list


def _wald_interval(successes: int, trials: int, conf: float):
    """Normal-approximation CI, as the reference's scipy-based rule."""
    if trials == 0:
        return 0.0, 1.0
    p = successes / trials
    z = scipy_stats.norm.ppf(0.5 + conf / 2.0)
    half = z * np.sqrt(p * (1 - p) / trials)
    return max(0.0, p - half), min(1.0, p + half)


def causal_discrimination(
    predict_batch: Callable[[np.ndarray], np.ndarray],
    lo: Sequence[int],
    hi: Sequence[int],
    pa_index,
    conf: float = 0.99,
    max_error: float = 0.01,
    min_samples: int = 100,
    max_samples: int = 50_000,
    batch_size: int = 512,
    rng: Optional[np.random.Generator] = None,
    keep_examples: int = 100,
    max_combos: int = 4096,
) -> CausalResult:
    """Causal discrimination rate of a black-box classifier.

    ``pa_index`` is one attribute index or a sequence of them.  A sampled
    assignment of the non-protected attributes is *discriminatory* if
    sweeping the protected attribute(s) over the full cartesian product of
    their [lo, hi] ranges changes the prediction (``causal_discrimination``,
    ``src/AC/metrics.py:101-168``; the attribute-set case is the joint sweep
    of ``discrimination_search``, ``:170-227``).  Stops when the Wald
    interval at ``conf`` is narrower than ``2·max_error`` (after
    ``min_samples``), like ``_check_stopping_condition`` (``:243-257``).
    """
    rng = rng or np.random.default_rng(0)
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    d = lo.shape[0]
    idx = np.atleast_1d(np.asarray(pa_index, dtype=np.int64))
    V = int(np.prod([hi[k] - lo[k] + 1 for k in idx]))
    if V > max_combos:  # before meshgrid materializes the product
        raise ValueError(
            f"joint PA sweep of {V} combinations exceeds max_combos="
            f"{max_combos}; narrow the attribute set or ranges")
    grids = np.meshgrid(*(np.arange(lo[k], hi[k] + 1) for k in idx),
                        indexing="ij")
    combos = np.stack([g.ravel() for g in grids], axis=1)  # (V, |idx|)

    tested = 0
    disc = 0
    examples = []
    while tested < max_samples:
        n = min(batch_size, max_samples - tested)
        x = rng.integers(lo[None, :], hi[None, :] + 1, size=(n, d))
        sweep = np.repeat(x[:, None, :], V, axis=1).astype(np.float32)
        sweep[:, :, idx] = combos[None, :, :]
        preds = np.asarray(predict_batch(sweep.reshape(n * V, d))).reshape(n, V)
        flips = (preds != preds[:, :1]).any(axis=1)
        for i in np.where(flips)[0][: max(0, keep_examples - len(examples))]:
            examples.append(x[i].copy())
        disc += int(flips.sum())
        tested += n
        if tested >= min_samples:
            lo_ci, hi_ci = _wald_interval(disc, tested, conf)
            if (hi_ci - lo_ci) / 2.0 <= max_error:
                break
    lo_ci, hi_ci = _wald_interval(disc, tested, conf)
    return CausalResult(
        rate=disc / tested if tested else 0.0,
        tested=tested,
        discriminatory=disc,
        interval=(lo_ci, hi_ci),
        examples=examples,
    )


def discrimination_search(
    predict_batch: Callable[[np.ndarray], np.ndarray],
    lo: Sequence[int],
    hi: Sequence[int],
    pa_indices: Sequence[int],
    **kw,
) -> dict:
    """Per-attribute causal rates with superset pruning.

    Mirrors ``discrimination_search`` (``src/AC/metrics.py:170-227``): test
    singletons first; a multi-attribute set whose subset already discriminates
    above threshold is skipped.  Here limited to singletons + pairs, which is
    what the reference CLI exercises.
    """
    results = {}
    flagged = set()
    for i in pa_indices:
        res = causal_discrimination(predict_batch, lo, hi, i, **kw)
        results[(i,)] = res
        if res.rate > kw.get("max_error", 0.01):
            flagged.add(i)
    for i in pa_indices:
        for j in pa_indices:
            if j <= i or i in flagged or j in flagged:
                continue
            # Joint sweep over the (i, j) value product — one batch per
            # round, every combination for every sampled base assignment.
            res = causal_discrimination(predict_batch, lo, hi, (i, j), **kw)
            results[(i, j)] = res
    return results
