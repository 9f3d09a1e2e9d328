"""Heuristic (unsound) pruning: the UNKNOWN-fallback distribution test.

Copy of ``fairify_tpu/ops/heuristic.py`` (host numpy; the port imports
nothing of ``fairify_tpu``).

Re-implements the reference's ``heuristic_prune`` (``utils/prune.py:862-939``)
as array statistics.  When the decision engine cannot decide a partition
within budget, borderline-quiet candidate neurons are killed to shrink the
problem; verdicts after heuristic pruning are flagged (the reference reports
``h_attempt``/``h_success`` and counts the result against the unsound tier).

Rules, kept bit-for-bit from the reference:

* per hidden layer, split pre-activation upper bounds (``ws_ub``) into
  simulation-candidates vs non-candidates;
* layers with no non-candidates kill every solver-surviving candidate
  (``utils/prune.py:883-885``); layers with no candidates do nothing;
* otherwise require distribution separation (non-candidate mean AND median
  > 2× candidate's, ``utils/prune.py:908``), then kill a surviving candidate
  iff its ``ws_ub`` is below the non-candidate ``perc``-percentile AND below
  ``0.1 ×`` the non-candidate ``(100-perc)``-percentile AND below ``|ws_lb|``
  (``utils/prune.py:916-921``);
* keep-one-per-layer guard, then union with the sound dead set.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from fairify_tpu_torch.ops import masks as mops


def heuristic_prune(
    ws_lb: Sequence[np.ndarray],
    ws_ub: Sequence[np.ndarray],
    candidates: Sequence[np.ndarray],
    surviving_candidates: Sequence[np.ndarray],
    sound_dead: Sequence[np.ndarray],
    perc_threshold: float,
):
    """Returns (heuristic_dead, merged_dead) as float arrays (1 = dead)."""
    n_layers = len(candidates)
    new_dead = [np.zeros_like(np.asarray(c), dtype=np.float32) for c in candidates]

    for l in range(n_layers - 1):
        ub = np.asarray(ws_ub[l], dtype=np.float64)
        lb = np.asarray(ws_lb[l], dtype=np.float64)
        cand_mask = np.asarray(candidates[l]) > 0.5
        surv_mask = np.asarray(surviving_candidates[l]) > 0.5

        cand = ub[cand_mask]
        noncand = ub[~cand_mask]

        if noncand.size == 0:
            # Reference kills the whole layer in this case (every index of the
            # s_candidates row, not just survivors), utils/prune.py:883-885;
            # the keep-one-alive guard below then revives neuron 0.
            new_dead[l][:] = 1.0
            continue
        if cand.size == 0:
            continue

        if np.mean(noncand) > 2 * np.mean(cand) and np.median(noncand) > 2 * np.median(cand):
            lo_perc = np.percentile(noncand, perc_threshold)
            hi_perc = np.percentile(noncand, 100 - perc_threshold)
            kill = surv_mask & (ub < lo_perc) & (ub < 0.1 * hi_perc) & (ub < np.abs(lb))
            new_dead[l][kill] = 1.0

    new_dead = [np.asarray(d) for d in mops.keep_one_alive(new_dead)]
    merged = [np.maximum(a, np.asarray(b)) for a, b in zip(new_dead, sound_dead)]
    merged = [np.asarray(d) for d in mops.keep_one_alive(merged)]
    return new_dead, merged
