"""Hybrid fair/original model routing from per-partition verdicts.

Port of ``fairify_tpu/analysis/hybrid.py`` (the reference's hybrid
predictor, ``src/AC/Verify-AC-experiment-new2.py:562-794``): an input goes
to the *fairer* model if its partition was SAT (bias proven there), to the
original if UNSAT, and to the original on a miss or UNKNOWN.  Membership
of all points in all partitions is one broadcast box test on the host;
both models run one plain batched forward each on their device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

from fairify_tpu_torch.models import mlp as mlp_mod


@dataclass
class HybridReport:
    predictions: np.ndarray
    routed_fair: int
    routed_original: int
    routed_miss: int


def route_points(X: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                 verdicts: Sequence[str]) -> np.ndarray:
    """Partition index of each point (first containing box), −1 on miss."""
    X = np.asarray(X, dtype=np.float64)
    inside = (X[None, :, :] >= lo[:, None, :]) & (X[None, :, :] <= hi[:, None, :])
    member = inside.all(axis=2)  # (P, N)
    any_hit = member.any(axis=0)
    first = member.argmax(axis=0)
    return np.where(any_hit, first, -1)


def hybrid_predict(
    X: np.ndarray,
    original,
    fairer,
    lo: np.ndarray,
    hi: np.ndarray,
    verdicts: Sequence[str],
) -> HybridReport:
    """Route each row: SAT partition → fairer model, else original
    (``hybrid_predict``, ``Verify-AC-experiment-new2.py:613-638``)."""
    idx = route_points(X, lo, hi, verdicts)
    verdict_arr = np.asarray(list(verdicts))
    use_fair = np.zeros(X.shape[0], dtype=bool)
    hit = idx >= 0
    use_fair[hit] = verdict_arr[idx[hit]] == "sat"
    preds = np.where(use_fair, mlp_mod.predict_rows(fairer, X),
                     mlp_mod.predict_rows(original, X)).astype(int)
    return HybridReport(
        predictions=preds,
        routed_fair=int(use_fair.sum()),
        routed_original=int((hit & ~use_fair).sum()),
        routed_miss=int((~hit).sum()),
    )


def evaluate_hybrid(
    X, y, protected_col: int,
    original, fairer,
    lo, hi, verdicts,
    privileged_value=1,
) -> Tuple[Dict[str, dict], HybridReport]:
    """Accuracy + group metrics for original/fairer/hybrid side by side
    (``Verify-AC-experiment-new2.py:653-787``), plus the routing report."""
    from fairify_tpu_torch.analysis import metrics as gm

    prot = np.asarray(X)[:, protected_col]
    routing = hybrid_predict(X, original, fairer, lo, hi, verdicts)
    preds = {
        "original": mlp_mod.predict_rows(original, X).astype(int),
        "fairer": mlp_mod.predict_rows(fairer, X).astype(int),
        "hybrid": routing.predictions,
    }
    out = {name: gm.group_report(X, y, p, prot, privileged_value).as_dict()
           for name, p in preds.items()}
    return out, routing
