"""Live heartbeat: one throttled stderr line per interval during long sweeps.

Port of ``fairify_tpu/obs/heartbeat.py`` (``FleetPulse`` belongs to
serving, which the port does not run yet).  The heartbeat prints a single
line at most once per ``interval_s``::

    [hb GC-1] 1536/3360 attempted (45.7%) | 1510 decided, 12 unknown | 24.1 pps | +38 launches | eta 79s

with ``| retries=N degraded=M`` appended whenever the run has spent launch
retries or degraded chunks (``resilience/``), segment lines
(:meth:`Heartbeat.segment`) while a long launch is in flight, and an
unthrottled "building <source>" line while ``nvcc`` runs.  Throttling is
clock-based, so per-partition call sites beat unconditionally.  The launch
delta comes from the ``device_launches`` counter; the ETA extrapolates a
recent attempt rate (an EMA over the emitted beats).
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Optional

from fairify_tpu_torch.obs import metrics as metrics_mod

# The run's live heartbeat (last enabled one wins; sequential sweeps each
# register their own).  utils.cuda_build uses it to flag an ``nvcc`` build
# in progress — the long silent pause that otherwise looks like a hang.
_ACTIVE: Optional["Heartbeat"] = None


def active() -> Optional["Heartbeat"]:
    return _ACTIVE


def notify_build(source: str) -> None:
    """Flag an ``nvcc`` build start on the active heartbeat (no-op when
    none).

    Called by ``utils.cuda_build`` as it starts compiling a kernel source:
    a cold build takes seconds, during which the partition loop — and
    therefore ``beat`` — cannot run, so the flag must be prospective.
    """
    hb = _ACTIVE
    if hb is not None:
        hb.build_started(source)


class Heartbeat:
    """Throttled progress reporter; ``interval_s <= 0`` disables it."""

    # Recent-rate EMA weight for the ETA: one beat-to-beat window carries
    # this much, history the rest — after a phase transition (stage-0 →
    # BaB) the ETA converges to the new rate within a few beats.
    ETA_ALPHA = 0.5

    def __init__(self, interval_s: float, total: Optional[int] = None,
                 label: str = "", stream=None,
                 clock: Callable[[], float] = time.monotonic):
        self.interval_s = float(interval_s)
        self.total = total
        self.label = label
        self.stream = stream  # None → sys.stderr at beat time (testable)
        self._clock = clock
        self._start = clock()
        self._last: Optional[float] = None
        self._last_launches = self._launches()
        # Baselines for the retries/degraded suffix: the registry is
        # process-cumulative, and an earlier model's faults must not
        # flag a later (healthy) model's heartbeat as flaky.
        reg = metrics_mod.registry()
        self._retries0 = reg.counter("launch_retries").total()
        self._degraded0 = reg.counter("chunks_degraded").total()
        # Funnel baselines: the beat's decided k/N (f%) segment reads the
        # mirrored ``funnel_states`` counter (obs.funnel), which is
        # process-cumulative like the fault counters above.
        self._funnel0_total = reg.counter("funnel_states").total()
        self._funnel0_decided = self._funnel_decided()
        self._last_attempted: Optional[int] = None
        self._last_segment: Optional[float] = None
        self._rate_ema: Optional[float] = None
        if self.interval_s > 0:
            global _ACTIVE
            _ACTIVE = self

    def close(self) -> None:
        """Deregister as the live heartbeat (end of the owning sweep)."""
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    @staticmethod
    def _launches() -> float:
        return metrics_mod.registry().counter("device_launches").total()

    @staticmethod
    def _funnel_decided() -> int:
        from fairify_tpu_torch.obs import funnel as funnel_mod

        return funnel_mod.live_decided()

    def build_started(self, source: str) -> None:
        """One line flagging an ``nvcc`` build in progress.

        Unthrottled: each source builds once per process, so a cold run
        emits a handful of these, and each one explains a pause the
        interval-throttled beats cannot cover.  Does not count as a beat
        for throttling.
        """
        label = f" {self.label}" if self.label else ""
        try:
            print(f"[hb{label}] building {source}…",
                  file=self.stream or sys.stderr, flush=True)
        except (OSError, ValueError):
            # A leaked/stale registration over a closed stream must never
            # fail the kernel call that triggered the flag.
            self.close()

    def segment(self, phase: str, done: int, total: int,
                in_flight: int = 0, force: bool = False) -> bool:
        """Segment-granular progress for device-resident mega launches.

        A mega segment is ONE device launch covering many chunks:
        partitions decided inside it are invisible to the host until the
        launch drains, so the per-partition ``beat`` stalls for the whole
        launch and a long single launch would look hung.  This line
        surfaces segments-done/total instead::

            [hb GC-1] stage0_decide segments 3/8 (2 in flight) | +3 launches

        Same interval throttle as ``beat`` but on its own clock (the two
        progress streams must not starve each other); the final segment of
        a phase always prints.
        """
        if self.interval_s <= 0 and not force:
            return False
        now = self._clock()
        if not force and done < total and self._last_segment is not None \
                and now - self._last_segment < self.interval_s:
            return False
        launches = self._launches()
        d_launch = int(launches - self._last_launches)
        label = f" {self.label}" if self.label else ""
        flight = f" ({in_flight} in flight)" if in_flight else ""
        print(f"[hb{label}] {phase} segments {done}/{total}{flight} "
              f"| +{d_launch} launches",
              file=self.stream or sys.stderr, flush=True)
        self._last_segment = now
        self._last_launches = launches
        return True

    def beat(self, decided: int, attempted: int, unknown: int = 0,
             force: bool = False) -> bool:
        """Emit one line if the interval elapsed (or ``force``); else no-op.

        Returns whether a line was emitted.
        """
        if self.interval_s <= 0 and not force:
            return False
        now = self._clock()
        if not force and self._last is not None \
                and now - self._last < self.interval_s:
            return False
        elapsed = max(now - self._start, 1e-9)
        pps = decided / elapsed
        launches = self._launches()
        d_launch = int(launches - self._last_launches)
        parts = [f"[hb{' ' + self.label if self.label else ''}]"]
        if self.total:
            parts.append(f"{attempted}/{self.total} attempted "
                         f"({100.0 * attempted / self.total:.1f}%)")
        else:
            parts.append(f"{attempted} attempted")
        reg = metrics_mod.registry()
        # Live funnel segment (obs.funnel): once partitions start reaching
        # terminal states the mirrored ``funnel_states`` counter drives the
        # decided line — k/N over CLASSIFIED partitions with the decided
        # fraction, the run's success metric.  Before any classification
        # (stage-0 still in flight) the caller-passed counts stand in.
        f_total = int(reg.counter("funnel_states").total()
                      - self._funnel0_total)
        if f_total > 0:
            f_dec = self._funnel_decided() - self._funnel0_decided
            parts.append(f"| decided {f_dec}/{f_total} "
                         f"({100.0 * f_dec / f_total:.1f}%), "
                         f"{f_total - f_dec} unknown")
        else:
            parts.append(f"| {decided} decided, {unknown} unknown")
        parts.append(f"| {pps:.2f} pps")
        parts.append(f"| +{d_launch} launches")
        retries = int(reg.counter("launch_retries").total() - self._retries0)
        degr = int(reg.counter("chunks_degraded").total() - self._degraded0)
        if retries or degr:
            # Fault visibility (resilience/): a flaky device shows up here
            # beats before anything degrades; omitted entirely when healthy.
            parts.append(f"| retries={retries} degraded={degr}")
        smt_workers = reg.gauge("smt_pool_workers").value()
        if smt_workers:
            # SMT pool visibility (fairify_tpu/smt): host solving in
            # flight/queued and the live worker count — omitted entirely
            # when no pool is running (zero-noise like the fault suffix).
            active = int(reg.gauge("smt_pool_active").value() or 0)
            queued = int(reg.gauge("smt_pool_queue_depth").value() or 0)
            parts.append(f"| smt: {active}/{queued} "
                         f"workers={int(smt_workers)}")
        if self._last is not None and now > self._last:
            # Fold this beat's window into the recent-rate EMA (the first
            # beat has no window → whole-run-mean fallback below).
            inst = max(attempted - (self._last_attempted or 0), 0) \
                / (now - self._last)
            self._rate_ema = inst if self._rate_ema is None else (
                self.ETA_ALPHA * inst + (1.0 - self.ETA_ALPHA) * self._rate_ema)
        if self.total and attempted and attempted < self.total:
            rate = self._rate_ema if self._rate_ema is not None \
                else attempted / elapsed
            if rate > 0:
                parts.append(f"| eta {(self.total - attempted) / rate:.0f}s")
        print(" ".join(parts), file=self.stream or sys.stderr, flush=True)
        self._last = now
        self._last_attempted = attempted
        self._last_launches = launches
        return True
