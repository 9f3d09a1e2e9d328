"""Verification-funnel taxonomy + fixed-bucket margin statistics.

Copy of the jax-free core of ``fairify_tpu/obs/funnel.py`` (states, bucket
edges, ``StageStats``, ``FunnelCounts``, ``classify``).

The paper's whole game is the SAT/UNSAT/UNKNOWN funnel — Fairify wins by
pruning until almost nothing reaches the solver — so every partition's
terminal state is classified into ONE of the states below and the run's
certified-margin / attack-gap distributions are kept as fixed-bucket
histograms (DESIGN.md §20).  The bucket layout is shared verbatim by the
device kernels (the port's attack kernel KC accumulates it with atomics,
``verify/engine.py:attack_flips``) and the host mirrors here, so a
segment's statistics cost one extra fetched buffer and ZERO extra launches.

Terminal states
---------------
``certified:stage0``   UNSAT by the stage-0 CROWN certificate
``attacked:stage0``    SAT by a stage-0 attack witness (exact-replayed)
``certified:bab``      UNSAT by BaB / the heuristic retry tier
``attacked:bab``       SAT by BaB / PGD / the heuristic retry tier
``smt:unsat``          UNSAT by the out-of-process SMT tier
``smt:sat``            SAT by the SMT tier
``unknown:deadline``   abandoned by the deadline (per-box or cumulative)
``unknown:budget``     abandoned by a node/attempt budget (or never
                       attempted under a budgeted ladder)
``unknown:frontier``   legacy catch-all: the host-frontier BaB (or an
                       unrecognised engine reason) could not decide it
``unknown:frontier:overflow``  the device BaB queue ran out of slots while
                       the root still had splittable boxes — a CAPACITY
                       fall, not a hardness one (raise
                       ``EngineConfig.bab_frontier_cap``)
``unknown:frontier:hard``  the device BaB ran to a bound stall / exact-leaf
                       UNKNOWN with queue room to spare: genuinely hard
``unknown:failure:<site>``  degraded by an exhausted fault site (the
                       ``<site>`` prefix of the failure record's reason,
                       e.g. ``launch.submit``)
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

#: Closed bucket taxonomy (``unknown:failure:<site>`` is open-ended).
STATES = (
    "certified:stage0",
    "attacked:stage0",
    "certified:bab",
    "attacked:bab",
    "smt:sat",
    "smt:unsat",
    "unknown:deadline",
    "unknown:budget",
    "unknown:frontier",
    "unknown:frontier:overflow",
    "unknown:frontier:hard",
)

#: Engine ``Decision.reason`` values with a dedicated funnel state.  The
#: device-BaB path (DESIGN.md §22) splits the old catch-all 'frontier' into
#: 'frontier:overflow' (queue capacity exhausted — retune, don't despair)
#: vs 'frontier:hard' (bounds stalled at full budget — genuinely hard);
#: bare 'frontier' remains the host-frontier / unrecognised-reason fallback.
_ENGINE_REASONS = ("deadline", "budget", "frontier",
                   "frontier:overflow", "frontier:hard")

# ---------------------------------------------------------------------------
# Fixed-bucket histogram layout (margins and attack gaps share it)
# ---------------------------------------------------------------------------

#: Symmetric log-ish bucket edges.  Bucket i holds values v with
#: ``EDGES[i-1] <= v < EDGES[i]`` under the rule ``idx = Σ (v >= edge)``
#: (identical on device and host: comparisons + a reduce, no searchsorted).
#: The 0.0 edge makes the certified boundary exact: margin >= 0 ⟺ certified
#: lands in buckets >= NEG_BUCKETS by construction.
EDGES = np.array([-1e4, -1e2, -10.0, -1.0, -0.1, -0.01, 0.0,
                  0.01, 0.1, 1.0, 10.0, 100.0, 1e4], dtype=np.float32)
N_BUCKETS = int(EDGES.size) + 1
#: Buckets strictly below 0 (margin < 0 / gap <= 0 side).
NEG_BUCKETS = int((EDGES <= 0.0).sum())
MARGIN_ROW, GAP_ROW = 0, 1


def bucketize(values: np.ndarray) -> np.ndarray:
    """Host mirror of the device bucket rule: ``idx = Σ (v >= edge)``."""
    v = np.asarray(values, np.float32)
    return (v[..., None] >= EDGES).sum(axis=-1).astype(np.int64)


def hist(values: np.ndarray, ok: Optional[np.ndarray] = None) -> np.ndarray:
    """(N_BUCKETS,) int64 histogram of ``values`` (rows masked by ``ok``)."""
    idx = bucketize(values).reshape(-1)
    if ok is None:
        okf = np.ones(idx.shape, dtype=bool)
    else:
        okf = np.asarray(ok, dtype=bool).reshape(-1)
    onehot = (idx[:, None] == np.arange(N_BUCKETS)[None, :]) & okf[:, None]
    return onehot.sum(axis=0).astype(np.int64)


class StageStats:
    """Host accumulator for the stage-0 margin/gap histograms.

    Fed either a packed device ``(2, N_BUCKETS)`` buffer (the mega-loop's
    scan-carry result, one per segment) or raw per-box values (the chunk
    loop's host decode) — the two paths produce bit-identical histograms
    for bit-identical margins because they share one bucket rule.
    """

    def __init__(self) -> None:
        self.hist = np.zeros((2, N_BUCKETS), dtype=np.int64)

    def add_packed(self, stats) -> None:
        self.hist += np.asarray(stats, dtype=np.int64).reshape(2, N_BUCKETS)

    def add_values(self, margin, gap, ok: Optional[np.ndarray] = None) -> None:
        self.hist[MARGIN_ROW] += hist(margin, ok)
        self.hist[GAP_ROW] += hist(gap, ok)

    def merge(self, other: "StageStats") -> None:
        self.hist += other.hist

    @property
    def margin_hist(self) -> np.ndarray:
        return self.hist[MARGIN_ROW]

    @property
    def gap_hist(self) -> np.ndarray:
        return self.hist[GAP_ROW]

    @property
    def boxes(self) -> int:
        return int(self.hist[MARGIN_ROW].sum())

    def to_payload(self) -> dict:
        """JSON-ready histogram block for throughput files / funnel events."""
        return {
            "edges": [float(e) for e in EDGES],
            "margin": [int(c) for c in self.hist[MARGIN_ROW]],
            "gap": [int(c) for c in self.hist[GAP_ROW]],
        }


# ---------------------------------------------------------------------------
# Terminal-state classification
# ---------------------------------------------------------------------------


def failure_state(failure_reason: str) -> str:
    """``unknown:failure:<site>`` from a failure record's ``site:kind`` reason."""
    site = str(failure_reason).split(":", 1)[0] or "unknown"
    return f"unknown:failure:{site}"


def classify(verdict: str, via: str, failure: Optional[str] = None,
             engine_reason: Optional[str] = None) -> str:
    """One partition's terminal funnel state.

    ``via`` is the verdict event's provenance tag (``stage0`` / ``bab`` /
    ``heuristic`` / ``smt`` / ``degraded`` / ``ledger``); ``failure`` the
    degradation reason (``site:kind``) when the partition degraded;
    ``engine_reason`` the BaB :class:`~fairify_tpu.verify.engine.Decision`
    reason for UNKNOWNs (``deadline`` | ``budget`` | ``frontier`` |
    ``frontier:overflow`` | ``frontier:hard``).
    """
    if failure is not None:
        return failure_state(failure)
    if verdict == "unsat":
        if via == "stage0":
            return "certified:stage0"
        if via == "smt":
            return "smt:unsat"
        return "certified:bab"
    if verdict == "sat":
        if via == "stage0":
            return "attacked:stage0"
        if via == "smt":
            return "smt:sat"
        return "attacked:bab"
    reason = engine_reason if engine_reason in _ENGINE_REASONS else "frontier"
    return f"unknown:{reason}"


def is_decided(state: str) -> bool:
    return not state.startswith("unknown")


class FunnelCounts:
    """Per-run terminal-state counter, mirrored into the metrics registry.

    Every ``add`` increments the labelled ``funnel_states`` counter of the
    process registry, so the heartbeat sees the live funnel; the instance
    itself is the per-run tally that rides the throughput JSON and the
    per-model ``funnel`` event."""

    def __init__(self) -> None:
        self.counts: Dict[str, int] = {}

    def add(self, state: str, n: int = 1) -> None:
        if n <= 0:
            return
        self.counts[state] = self.counts.get(state, 0) + n
        from fairify_tpu_torch.obs.metrics import registry

        registry().counter("funnel_states").inc(n, state=state)

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    @property
    def decided(self) -> int:
        return sum(n for s, n in self.counts.items() if is_decided(s))

    @property
    def decided_fraction(self) -> float:
        total = self.total
        return (self.decided / total) if total else 0.0

    def to_dict(self) -> Dict[str, int]:
        return {s: self.counts[s] for s in sorted(self.counts)}


def live_decided() -> int:
    """Process-wide decided count from the mirrored ``funnel_states`` counter
    (the heartbeat's live-funnel source; pair with a baseline captured at
    init)."""
    from fairify_tpu_torch.obs.metrics import registry

    snap = registry().counter("funnel_states").snapshot()
    return int(sum(s["value"] for s in snap
                   if is_decided(s["labels"].get("state", ""))))
