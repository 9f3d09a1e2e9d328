"""Synthetic tabular-data generators (the reference's task1 analog).

Port of ``fairify_tpu/models/synth.py``, with the same names and
signatures, plus ``device`` where the JAX code runs on its device:

* :class:`GaussianCopula`, :class:`ColumnQuantizer`, :func:`bootstrap_rows`
  and the normal CDF/PPF helpers are numpy on the host, copied unchanged:
  the same seeds give the same arrays as the JAX package's.
* :class:`ARColumnModel` — the autoregressive categorical model over the
  column sequence: a shared MLP trunk over causally-masked one-hot
  prefixes with one softmax head per column.  ``init`` draws the same
  numpy weights as the JAX package's and keeps them in one flat f32 buffer
  on the model's device (``params`` holds views of it under the keys ``w1
  b1 w2 b2 wh bh``; ``load_params`` copies weights in); ``fit`` runs
  JAX's loop — the epoch permutations of ``default_rng(seed)``, batches
  of ``batch_size`` with the ragged last one, one row-29 step a batch
  (``ops/synth_step.synth_step``), each epoch's loss as ``Σ
  float(l)·len(sel) / n`` read once an epoch;
  ``sample`` is one row-30 draw (``ops/synth_step.synth_draw``) on the
  keys of ``key(seed)`` split column by column, as JAX's ``draw``.

Both generators model the label column jointly with the features, so
sampled rows arrive fully labelled.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np
import torch

from fairify_tpu_torch.ops import synth_step
from fairify_tpu_torch.utils.num import resolve_device


# ---------------------------------------------------------------------------
# Gaussian copula
# ---------------------------------------------------------------------------

def _norm_ppf(u: np.ndarray) -> np.ndarray:
    """Inverse standard-normal CDF (Acklam's rational approximation).

    Avoids a scipy dependency in the sampling path; max abs error ~1e-9,
    far below the integer-lattice quantization of the output.
    """
    u = np.clip(u, 1e-12, 1 - 1e-12)
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    lo, hi = 0.02425, 1 - 0.02425
    out = np.empty_like(u)
    m = u < lo
    if m.any():
        q = np.sqrt(-2 * np.log(u[m]))
        out[m] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
                 ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    m = (u >= lo) & (u <= hi)
    if m.any():
        q = u[m] - 0.5
        r = q * q
        out[m] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
                 (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    m = u > hi
    if m.any():
        q = np.sqrt(-2 * np.log(1 - u[m]))
        out[m] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
                 ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    return out


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    from math import sqrt

    try:
        from scipy.special import erf
    except ImportError:  # pragma: no cover - scipy is installed with the port's tests
        import math

        erf = np.vectorize(math.erf)
    return 0.5 * (1.0 + erf(z / sqrt(2.0)))


@dataclass
class GaussianCopula:
    """Empirical-marginal Gaussian copula over integer columns.

    ``values[j]``/``cum[j]`` give column *j*'s observed support and its
    cumulative probabilities; ``chol`` is the Cholesky factor of the
    normal-scores correlation matrix.
    """

    values: List[np.ndarray]
    cum: List[np.ndarray]
    chol: np.ndarray

    @staticmethod
    def fit(X: np.ndarray) -> "GaussianCopula":
        X = np.asarray(X)
        n, d = X.shape
        values, cum, scores = [], [], np.empty((n, d))
        for j in range(d):
            col = X[:, j]
            vals, counts = np.unique(col, return_counts=True)
            p = counts / n
            cj = np.cumsum(p)
            values.append(vals.astype(np.int64))
            cum.append(cj)
            # mid-CDF normal scores keep ties well-defined on discrete data
            mid = cj - p / 2.0
            lookup = {v: mid[i] for i, v in enumerate(vals)}
            scores[:, j] = _norm_ppf(np.array([lookup[v] for v in col]))
        corr = np.corrcoef(scores, rowvar=False)
        corr = np.atleast_2d(corr)
        # jitter for numerical PD-ness on near-degenerate columns
        corr = corr + 1e-6 * np.eye(d)
        np.nan_to_num(corr, copy=False, nan=0.0)
        np.fill_diagonal(corr, 1.0 + 1e-6)
        chol = np.linalg.cholesky(corr)
        return GaussianCopula(values, cum, chol)

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        d = self.chol.shape[0]
        rng = np.random.default_rng(seed)
        z = rng.standard_normal((n, d)) @ self.chol.T
        u = _norm_cdf(z)
        out = np.empty((n, d), dtype=np.int64)
        for j in range(d):
            idx = np.searchsorted(self.cum[j], u[:, j], side="left")
            idx = np.clip(idx, 0, len(self.values[j]) - 1)
            out[:, j] = self.values[j][idx]
        return out


# ---------------------------------------------------------------------------
# Column quantizer: bounded-cardinality view of wide integer columns
# ---------------------------------------------------------------------------

@dataclass
class ColumnQuantizer:
    """Maps wide integer columns onto ≤``max_card`` frequency bins.

    The AR model below is categorical per column; German's ``credit_amount``
    spans 0..20000, which would make its one-hot input 20k wide and its
    softmax unlearnable from ~1k rows.  Narrow columns pass through
    unchanged; wide ones are binned at empirical quantile edges, and
    decoding draws uniformly among the *observed* values of the bin — so
    decoded rows always stay on the dataset's support (like the copula).
    """

    bins: List[List[np.ndarray]]   # bins[j][k] = observed values of bin k
    edges: List[np.ndarray]        # bin upper-bound edges for encode()

    @staticmethod
    def fit(X: np.ndarray, max_card: int = 64) -> "ColumnQuantizer":
        X = np.asarray(X)
        bins, edges = [], []
        for j in range(X.shape[1]):
            vals = np.unique(X[:, j])
            if len(vals) <= max_card:
                bins.append([np.array([v]) for v in vals])
                edges.append(vals.astype(np.float64))
            else:
                qs = np.quantile(X[:, j], np.linspace(0, 1, max_card + 1)[1:])
                ub = np.unique(qs)                      # bin upper bounds
                idx = np.searchsorted(ub, vals, side="left")
                kept = np.unique(idx)                   # drop empty bins
                bins.append([vals[idx == k] for k in kept])
                edges.append(ub[kept].astype(np.float64))
        return ColumnQuantizer(bins, edges)

    @property
    def card(self) -> np.ndarray:
        return np.array([len(b) for b in self.bins], dtype=np.int64)

    def encode(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X)
        out = np.empty_like(X, dtype=np.int64)
        for j, ub in enumerate(self.edges):
            out[:, j] = np.clip(np.searchsorted(ub, X[:, j], side="left"),
                                0, len(self.bins[j]) - 1)
        return out

    def decode(self, B: np.ndarray, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        B = np.asarray(B)
        out = np.empty_like(B, dtype=np.int64)
        for j, col_bins in enumerate(self.bins):
            for k, vals in enumerate(col_bins):
                m = B[:, j] == k
                if m.any():
                    out[m, j] = vals[rng.integers(0, len(vals), size=int(m.sum()))]
        return out


# ---------------------------------------------------------------------------
# Autoregressive column model (rows 29 and 30)
# ---------------------------------------------------------------------------

@dataclass
class ARColumnModel:
    """p(x) = prod_j p(x_j | x_<j>) over integer columns, MLP trunk + heads.

    One-hot prefix encoding with causal masking; shared two-layer trunk;
    per-column heads stored as one padded ``(d, H, Kmax)`` tensor.  The
    constructor packs the six parameters into one flat f32 buffer ``theta``
    on their device (``ops/synth_step.param_layout``; ``params`` then holds
    its views), which ``fit`` updates in place, and makes the model's
    ``shape`` there (``ops/synth_step.Shape``) for every launch.
    """

    lo: np.ndarray            # (d,) column minima
    card: np.ndarray          # (d,) column cardinalities
    offsets: np.ndarray       # (d,) one-hot block offsets
    params: dict              # trunk/head weights (views of ``theta``)
    theta: torch.Tensor = field(init=False, repr=False, compare=False)
    shape: synth_step.Shape = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        p = self.params
        dev = p["w1"].device if torch.is_tensor(p["w1"]) else torch.device("cpu")
        self.shape = synth_step.Shape(self.card, int(np.prod(p["b1"].shape)), dev)
        self.theta = torch.cat([torch.as_tensor(p[k], dtype=torch.float32, device=dev).reshape(-1)
                                for k in synth_step.KEYS])
        self.params = synth_step.views(self.theta, self.shape)

    # -- construction -------------------------------------------------------
    @staticmethod
    def init(lo: Sequence[int], hi: Sequence[int], hidden: int = 64, seed: int = 0,
             device=None) -> "ARColumnModel":
        """The JAX package's ``init`` (the same numpy draws in the same
        order), the weights on ``device`` (default ``cuda``)."""
        dev = resolve_device(device)
        lo = np.asarray(lo, dtype=np.int64)
        hi = np.asarray(hi, dtype=np.int64)
        card = (hi - lo + 1).astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(card)[:-1]])
        D = int(card.sum())
        d = len(card)
        kmax = int(card.max())
        rng = np.random.default_rng(seed)

        def lin(i, o):
            return rng.normal(scale=np.sqrt(2.0 / i), size=(i, o)).astype(np.float32)

        host = {
            "w1": lin(D, hidden), "b1": np.zeros(hidden, np.float32),
            "w2": lin(hidden, hidden), "b2": np.zeros(hidden, np.float32),
            "wh": rng.normal(scale=0.05, size=(d, hidden, kmax)).astype(np.float32),
            "bh": np.zeros((d, kmax), np.float32),
        }
        return ARColumnModel(lo, card, offsets,
                             {k: torch.from_numpy(v).to(dev) for k, v in host.items()})

    def load_params(self, params: dict) -> None:
        """Copy weights (arrays or tensors under ``w1 b1 w2 b2 wh bh``, in
        ``params``' shapes) into θ."""
        for k in synth_step.KEYS:
            self.params[k].copy_(torch.as_tensor(params[k]))

    @property
    def device(self) -> torch.device:
        return self.theta.device

    # -- training (row 29) ---------------------------------------------------
    def fit(self, X: np.ndarray, epochs: int = 300, lr: float = 3e-3,
            batch_size: int = 256, seed: int = 0) -> List[float]:
        X = np.asarray(X, dtype=np.int64)
        X = np.clip(X, self.lo[None, :], (self.lo + self.card - 1)[None, :])
        dev = self.device
        codes = torch.from_numpy((X - self.lo[None, :]).astype(np.int32)).to(dev)
        m, v = torch.zeros_like(self.theta), torch.zeros_like(self.theta)
        n = len(X)
        starts = range(0, n, batch_size)
        rng = np.random.default_rng(seed)
        hist, t = [], 0
        for _ in range(epochs):
            order = torch.from_numpy(rng.permutation(n)).to(dev)
            losses = torch.empty(len(starts), dtype=torch.float32, device=dev)
            for i, s in enumerate(starts):
                t += 1
                synth_step.synth_step(self.theta, m, v, codes, order[s:s + batch_size],
                                      self.shape, t, lr, loss_out=losses[i:i + 1])
            tot = 0.0
            for s, l in zip(starts, losses.cpu().numpy().tolist()):
                tot += float(l) * (min(s + batch_size, n) - s)
            hist.append(tot / n)
        return hist

    # -- sampling (row 30) ---------------------------------------------------
    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        keys = synth_step.column_keys(seed, len(self.card))
        cls = synth_step.synth_draw(self.theta, self.shape, keys, n)
        return cls.cpu().numpy().astype(np.int64) + self.lo[None, :]


# ---------------------------------------------------------------------------
# Bootstrap baseline
# ---------------------------------------------------------------------------

def bootstrap_rows(X: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """Resample-with-replacement baseline generator (task1's third arm)."""
    rng = np.random.default_rng(seed)
    X = np.asarray(X)
    return X[rng.integers(0, len(X), size=n)]


GENERATORS = ("copula", "ar", "bootstrap")


def synthesize(kind: str, X: np.ndarray, lo, hi, n: int, seed: int = 0,
               ar_epochs: int = 200, ar_hidden: int = 64, device=None) -> np.ndarray:
    """Fit generator ``kind`` on labelled rows ``X`` and sample ``n`` rows.

    Rows are clipped to the ``[lo, hi]`` domain lattice first, so every
    generator's output support stays inside the verification domain even
    when the raw dataset carries out-of-spec values.  ``device`` (default
    ``cuda``) is where the autoregressive model trains and samples.
    """
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    X = np.clip(np.asarray(X, dtype=np.int64), lo[None, :], hi[None, :])
    if kind == "copula":
        return GaussianCopula.fit(X).sample(n, seed=seed)
    if kind == "ar":
        # bounded-cardinality view keeps the one-hot width ~d*64 even when
        # a column spans 0..20000 (German credit_amount)
        q = ColumnQuantizer.fit(X)
        B = q.encode(X)
        card = q.card
        m = ARColumnModel.init(np.zeros_like(card), card - 1,
                               hidden=ar_hidden, seed=seed, device=device)
        m.fit(B, epochs=ar_epochs, seed=seed)
        return q.decode(m.sample(n, seed=seed + 1), seed=seed + 2)
    if kind == "bootstrap":
        return bootstrap_rows(X, n, seed=seed)
    raise ValueError(f"unknown generator {kind!r}; options: {GENERATORS}")
