"""Group fairness metrics — native replacement for the AIF360 suite.

Copy of ``fairify_tpu/analysis/metrics.py``, in numpy only: the JAX
package's ``consistency`` takes its neighbours from sklearn, the port's
from :func:`nearest_neighbors`.

The reference computes DI, SPD (mean difference), EOD, AOD, ERD, consistency
and Theil index through ``aif360.metrics`` (``src/CP/Verify-CP.py:398-458``,
``src/AC/new_model.py:49-114``).  Those are closed-form statistics; here they
are direct vectorized implementations (definitions follow AIF360's public
docs/source semantics: privileged group = protected attribute == privileged
value, favorable label = 1).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _groups(protected: np.ndarray, privileged_value: float):
    priv = np.asarray(protected) == privileged_value
    return priv, ~priv


def base_rate(y: np.ndarray) -> float:
    return float(np.mean(np.asarray(y) == 1))


def statistical_parity_difference(y_pred, protected, privileged_value=1) -> float:
    """P(ŷ=1 | unprivileged) − P(ŷ=1 | privileged)."""
    priv, unpriv = _groups(protected, privileged_value)
    return base_rate(np.asarray(y_pred)[unpriv]) - base_rate(np.asarray(y_pred)[priv])


def disparate_impact(y_pred, protected, privileged_value=1) -> float:
    """P(ŷ=1 | unprivileged) / P(ŷ=1 | privileged)."""
    priv, unpriv = _groups(protected, privileged_value)
    p = base_rate(np.asarray(y_pred)[priv])
    u = base_rate(np.asarray(y_pred)[unpriv])
    return float(u / p) if p > 0 else float("inf")


def _rates(y_true, y_pred, sel):
    yt = np.asarray(y_true)[sel]
    yp = np.asarray(y_pred)[sel]
    pos = yt == 1
    neg = yt == 0
    tpr = float(np.mean(yp[pos] == 1)) if pos.any() else 0.0
    fpr = float(np.mean(yp[neg] == 1)) if neg.any() else 0.0
    err = float(np.mean(yp != yt)) if yt.size else 0.0
    return tpr, fpr, err


def equal_opportunity_difference(y_true, y_pred, protected, privileged_value=1) -> float:
    """TPR(unprivileged) − TPR(privileged)."""
    priv, unpriv = _groups(protected, privileged_value)
    tpr_p, _, _ = _rates(y_true, y_pred, priv)
    tpr_u, _, _ = _rates(y_true, y_pred, unpriv)
    return tpr_u - tpr_p


def average_odds_difference(y_true, y_pred, protected, privileged_value=1) -> float:
    """½[(FPRu−FPRp) + (TPRu−TPRp)]."""
    priv, unpriv = _groups(protected, privileged_value)
    tpr_p, fpr_p, _ = _rates(y_true, y_pred, priv)
    tpr_u, fpr_u, _ = _rates(y_true, y_pred, unpriv)
    return 0.5 * ((fpr_u - fpr_p) + (tpr_u - tpr_p))


def error_rate_difference(y_true, y_pred, protected, privileged_value=1) -> float:
    """ERR(unprivileged) − ERR(privileged)."""
    priv, unpriv = _groups(protected, privileged_value)
    _, _, err_p = _rates(y_true, y_pred, priv)
    _, _, err_u = _rates(y_true, y_pred, unpriv)
    return err_u - err_p


def nearest_neighbors(X, n_neighbors: int = 5, block: int = 64) -> np.ndarray:
    """Indices of each row's ``n_neighbors`` nearest rows of ``X`` (itself
    first), by Euclidean distance, ties to the lower index: what the JAX
    package takes from sklearn's ``NearestNeighbors(n_neighbors).fit(X)
    .kneighbors(X)``, in numpy (the port needs no sklearn).  The
    squared distances are summed exactly for integer data, so the sets
    equal sklearn's wherever the k-th distance is not tied."""
    X = np.asarray(X, dtype=np.float64)
    out = np.empty((X.shape[0], n_neighbors), dtype=np.int64)
    for s in range(0, X.shape[0], block):
        d = ((X[s:s + block, None, :] - X[None, :, :]) ** 2).sum(axis=2)
        out[s:s + block] = np.argsort(d, axis=1, kind="stable")[:, :n_neighbors]
    return out


def consistency(X, y_pred, n_neighbors: int = 5) -> float:
    """1 − mean |ŷᵢ − mean(ŷ of i's k nearest neighbors)| (AIF360 definition,
    ``aif360.metrics.BinaryLabelDatasetMetric.consistency``)."""
    y_pred = np.asarray(y_pred).astype(np.float64)
    idx = nearest_neighbors(X, n_neighbors)
    return float(1.0 - np.mean(np.abs(y_pred - y_pred[idx].mean(axis=1))))


def f1_score(y_true, y_pred) -> float:
    """Binary F1 (favorable label 1) — the reference's per-partition metric
    CSV carries original/pruned F1 next to accuracy
    (``src/CP/Verify-CP.py:448-451``)."""
    yt = np.asarray(y_true) == 1
    yp = np.asarray(y_pred) == 1
    tp = float(np.sum(yt & yp))
    fp = float(np.sum(~yt & yp))
    fn = float(np.sum(yt & ~yp))
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom > 0 else 0.0


def theil_index(y_true, y_pred) -> float:
    """Generalized entropy (α=1) of benefit b = ŷ − y + 1 (AIF360 definition)."""
    b = np.asarray(y_pred, dtype=np.float64) - np.asarray(y_true, dtype=np.float64) + 1.0
    mu = b.mean()
    if mu == 0:
        return 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(b > 0, (b / mu) * np.log(b / mu), 0.0)
    return float(terms.mean())


@dataclass
class GroupFairnessReport:
    accuracy: float
    disparate_impact: float
    statistical_parity_difference: float
    equal_opportunity_difference: float
    average_odds_difference: float
    error_rate_difference: float
    consistency: float
    theil_index: float

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def group_report(X, y_true, y_pred, protected, privileged_value=1,
                 n_neighbors: int = 5) -> GroupFairnessReport:
    """The reference's per-run metric block (``src/CP/Verify-CP.py:398-458``)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return GroupFairnessReport(
        accuracy=float(np.mean(y_true == y_pred)),
        disparate_impact=disparate_impact(y_pred, protected, privileged_value),
        statistical_parity_difference=statistical_parity_difference(
            y_pred, protected, privileged_value),
        equal_opportunity_difference=equal_opportunity_difference(
            y_true, y_pred, protected, privileged_value),
        average_odds_difference=average_odds_difference(
            y_true, y_pred, protected, privileged_value),
        error_rate_difference=error_rate_difference(
            y_true, y_pred, protected, privileged_value),
        consistency=consistency(X, y_pred, n_neighbors),
        theil_index=theil_index(y_true, y_pred),
    )
