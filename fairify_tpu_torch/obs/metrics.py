"""Named, labelled, resettable metrics: counters, gauges, histograms.

Copy of ``fairify_tpu/obs/metrics.py``.  Named instruments that

* carry **labels** (``counter.inc(verdict="sat", via="stage0")``), so one
  instrument covers a verdict × phase matrix instead of five attributes;
* are **resettable** (:meth:`MetricsRegistry.reset`) between runs, so
  per-run deltas need no caller-side subtraction;
* **snapshot** to plain JSON (:meth:`MetricsRegistry.snapshot`) — the
  record the tracer appends to the event log on close, in the JAX
  package's layout, so its ``obs.report`` aggregates a log the port wrote.

Everything is host-side Python on the sweep's bookkeeping path, and every
access — reads included — takes one small lock: thread-safe for the
span/heartbeat consumers.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

# Default latency buckets (seconds): spans partition decisions from
# sub-millisecond ledger replays to the 100 s soft-timeout tail.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0)


def _key(labels: Dict[str, object]) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic (between resets) named counter with optional labels."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._series: Dict[tuple, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        k = _key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_key(labels), 0)

    def total(self) -> float:
        with self._lock:
            return sum(self._series.values())

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot(self) -> list:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._series.items())]


class Gauge:
    """Last-write-wins named value with optional labels."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._series: Dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_key(labels)] = value

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._series.get(_key(labels))

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot(self) -> list:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._series.items())]


class Histogram:
    """Cumulative-bucket histogram (Prometheus-style ``le`` bounds).

    ``counts()[i]`` is the number of observations ≤ ``buckets[i]``; the
    final slot counts the overflow (> last bound).
    """

    kind = "histogram"

    def __init__(self, name: str, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        # label key -> [per-bucket counts..., overflow], running sum, count
        self._series: Dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        k = _key(labels)
        with self._lock:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = [[0] * (len(self.buckets) + 1), 0.0, 0]
            for i, b in enumerate(self.buckets):
                if value <= b:
                    s[0][i] += 1
                    break
            else:
                s[0][-1] += 1
            s[1] += value
            s[2] += 1

    def counts(self, **labels) -> list:
        with self._lock:
            s = self._series.get(_key(labels))
            return list(s[0]) if s else [0] * (len(self.buckets) + 1)

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_key(labels))
            return s[1] if s else 0.0

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_key(labels))
            return s[2] if s else 0

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot(self) -> list:
        with self._lock:
            return [{"labels": dict(k), "buckets": list(self.buckets),
                     "counts": list(s[0]), "sum": s[1], "count": s[2]}
                    for k, s in sorted(self._series.items())]


class MetricsRegistry:
    """Name → instrument map; one per process by default (:func:`registry`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            return inst

    def counter(self, name: str) -> Counter:
        inst = self._get(name, lambda: Counter(name))
        if not isinstance(inst, Counter):
            raise TypeError(f"{name!r} is registered as a {inst.kind}")
        return inst

    def gauge(self, name: str) -> Gauge:
        inst = self._get(name, lambda: Gauge(name))
        if not isinstance(inst, Gauge):
            raise TypeError(f"{name!r} is registered as a {inst.kind}")
        return inst

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        inst = self._get(
            name, lambda: Histogram(name, buckets or DEFAULT_BUCKETS))
        if not isinstance(inst, Histogram):
            raise TypeError(f"{name!r} is registered as a {inst.kind}")
        return inst

    def reset(self) -> None:
        """Zero every instrument (registrations survive) — per-run hygiene."""
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            inst.reset()

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            instruments = sorted(self._instruments.items())
        return {name: {"kind": inst.kind, "series": inst.snapshot()}
                for name, inst in instruments}


def snapshot_delta(before: Dict[str, dict], after: Dict[str, dict]) -> Dict[str, dict]:
    """Per-run view of two registry snapshots: ``after`` minus ``before``.

    The process registry is cumulative (resetting it under a live consumer
    would corrupt absolute readers like the sweep's launch delta), so a
    tracer instead snapshots at activation and records the difference at
    close.  Counters and histograms subtract per labelled series (empty
    series are dropped); gauges are last-write-wins, so the ``after`` value
    is kept as-is.
    """
    out: Dict[str, dict] = {}
    for name, inst in after.items():
        base = before.get(name)
        kind = inst["kind"]
        if base is None or base["kind"] != kind or kind == "gauge":
            out[name] = inst
            continue
        base_map = {_key(s["labels"]): s for s in base["series"]}
        series = []
        for s in inst["series"]:
            b = base_map.get(_key(s["labels"]))
            if b is None:
                series.append(s)
            elif kind == "counter":
                v = s["value"] - b["value"]
                if v:
                    series.append({"labels": s["labels"], "value": v})
            else:  # histogram
                n = s["count"] - b["count"]
                if n:
                    series.append({
                        "labels": s["labels"], "buckets": s["buckets"],
                        "counts": [a - c for a, c in zip(s["counts"], b["counts"])],
                        "sum": s["sum"] - b["sum"], "count": n})
        if series:
            out[name] = {"kind": kind, "series": series}
    return out


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-default registry (the launch counter et al. live here)."""
    return _REGISTRY
