"""Deterministic, seedable fault-injection registry for chaos testing.

Copy of ``fairify_tpu/resilience/faults.py``: the same sites, kinds, spec
grammar and arrival counting, so a schedule fires at the same arrivals in
both packages.  Real runtime faults (a card dropping a launch, a network
filesystem tearing an append) are rare and unreproducible; the retry /
degradation machinery they exercise must not be.  This registry lets a
test schedule exact failures at named **sites**, the places the sweep
talks to something that can die (the port has the first five; the rest
belong to the SMT tier, the shard runtime and serving, which it does not
run yet):

====================  =====================================================
site                  where :func:`check` is called
====================  =====================================================
``launch.submit``     :class:`parallel.pipeline.LaunchPipeline` dispatch
``launch.decode``     the pipeline's drain (the CUDA event's sync)
``compile``           ``utils.cuda_build.build_all``'s ``nvcc`` build
``smt.query``         :func:`verify.smt.decide_box_smt` solver call
``ledger.append``     :class:`resilience.journal.JournalWriter` appends
``shard.dispatch``    :func:`parallel.shards.sweep_sharded` handing a
                      shard's span to its device group
``shard.gather``      collecting a completed shard's verdict summary back
                      into the cross-shard merge
``device.lost``       a shard's device set dying mid-sweep (``fatal``
                      triggers elastic re-sharding onto the survivors;
                      ``transient`` models a link blip the shard
                      supervisor's retry absorbs)
``request.admit``     :meth:`serve.admission.AdmissionController.admit`
                      deciding whether a service request is accepted
``request.deadline``  the server's per-request deadline check before a
                      request (or its next span) starts executing
``serve.drain``       :meth:`serve.server.VerificationServer.drain`
                      journaling queued requests for resume pickup
``request.preempt``   the server's preemption decision at a span-granule
                      boundary (an injected fault FORCES the preemption,
                      so the requeue/resume machinery is chaos-testable
                      without real overload)
``replica.lost``      the fleet router's per-replica health check
                      (:mod:`serve.fleet`) — ``fatal`` kills that replica
                      and exercises failover re-spooling; ``transient``
                      models a heartbeat blip the router absorbs
``replica.spawn``     :class:`serve.procfleet.ProcessFleet` forking a
                      replica worker process (an injected fault models a
                      fork/exec failure; exhaustion abandons the slot and
                      re-homes its requests to survivors)
``replica.lease``     the process-fleet router reading a replica's
                      file-lease heartbeat — ``transient`` is a stat blip
                      the router absorbs for one tick; ``fatal`` forces
                      the lease expired, so the REAL escalating
                      SIGTERM→SIGKILL hang-containment path runs
``smt.worker.spawn``  :class:`smt.pool.SmtPool` forking a solver worker
                      subprocess (an injected fault models a fork/exec
                      failure; exhaustion degrades the query)
``smt.worker.crash``  pool dispatch of one query to a live worker — an
                      injected fault here SIGKILLs the worker subprocess
                      mid-query, so the real death-containment path runs
``smt.worker.hang``   pool dispatch — an injected fault wedges the worker
                      (it sleeps through its deadline), exercising the
                      hard wall-clock kill after grace
``smt.worker.memout`` pool dispatch — an injected fault makes the worker
                      allocate past its RSS cap, exercising the memout
                      containment + higher-cap retry policy
====================  =====================================================

A **spec** is ``site:kind:nth``:

* ``kind`` — ``transient`` (retryable; the supervisor backs off and
  re-attempts), ``fatal`` (non-retryable; the chunk degrades immediately),
  ``crash`` (never handled; propagates like a SIGKILL would, for
  crash-resume chaos tests), or ``corrupt`` (silent-data-corruption: the
  site does NOT raise — it deterministically flips a bit in the payload it
  was about to trust, and the integrity layer
  (:mod:`resilience.integrity`) must catch it downstream).  ``corrupt`` is
  only valid at the data-plane sites ``launch.decode`` (decoded device
  buffers), ``ledger.append`` (durable verdict rows), and ``smt.query``
  (solver witness payloads); it is consumed via :func:`corruption`, which
  keeps its own per-site arrival counters so arming a corrupt spec never
  shifts an existing ``check``-based chaos schedule.
* ``nth`` — which arrivals at the site fire: ``3`` (the 3rd arrival only),
  ``3+`` (every arrival from the 3rd), ``3-5`` (an inclusive range), or
  ``p0.25`` (each arrival independently with probability 0.25, drawn from
  the registry's seeded RNG — deterministic for a given seed and arrival
  order).

Scheduling is arrival-count based, so a schedule is reproducible whenever
the instrumented call order is (the async pipeline keeps submission order
depth-invariant precisely so this holds).  Arrivals are counted per site
from :func:`arm` time; every fired fault bumps the ``fault_injected``
counter (labelled by site and kind) and emits a ``fault_injected`` obs
event.
"""
from __future__ import annotations

import re
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

FAULT_SITES = frozenset(
    {"launch.submit", "launch.decode", "compile", "smt.query", "ledger.append",
     "shard.dispatch", "shard.gather", "device.lost",
     "request.admit", "request.deadline", "serve.drain",
     "request.preempt", "replica.lost", "replica.spawn", "replica.lease",
     "smt.worker.spawn", "smt.worker.crash", "smt.worker.hang",
     "smt.worker.memout"})
FAULT_KINDS = frozenset({"transient", "fatal", "crash", "corrupt"})
# ``corrupt`` models a bit flip in data the site hands downstream, not a
# failed call — it only makes sense where a payload exists to corrupt AND
# an integrity detector exists to catch it (resilience/integrity.py).
CORRUPT_SITES = frozenset({"launch.decode", "ledger.append", "smt.query"})

_SPEC_RE = re.compile(
    r"^(?P<site>[a-z.]+):(?P<kind>[a-z]+):"
    r"(?P<nth>\d+|\d+\+|\d+-\d+|p(0?\.\d+|1(\.0+)?))$")


class InjectedFault(RuntimeError):
    """The error a scheduled fault raises at its site.

    ``kind`` drives the supervisor's classification: ``transient`` is
    retried, ``fatal`` degrades without retry, ``crash`` always propagates
    (it models a failure no in-process handler may paper over).
    """

    def __init__(self, site: str, kind: str, n: int):
        super().__init__(f"injected {kind} fault at {site} (arrival #{n})")
        self.site = site
        self.kind = kind
        self.n = n


@dataclass(frozen=True)
class FaultSpec:
    site: str
    kind: str
    start: int = 0          # first firing arrival (1-based); 0 = probabilistic
    stop: Optional[int] = None  # inclusive; None with start>0 = single arrival
    every: bool = False     # start+ : every arrival from start
    rate: float = 0.0       # p<rate> : per-arrival probability

    def fires(self, n: int, rng) -> bool:
        if self.rate:
            return bool(rng.random() < self.rate)
        if self.every:
            return n >= self.start
        if self.stop is not None:
            return self.start <= n <= self.stop
        return n == self.start


def parse_spec(spec: str) -> FaultSpec:
    m = _SPEC_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"bad fault spec {spec!r}: want site:kind:nth with nth one of "
            f"'3', '3+', '3-5', 'p0.25'")
    site, kind, nth = m.group("site"), m.group("kind"), m.group("nth")
    if site not in FAULT_SITES:
        raise ValueError(f"unknown fault site {site!r} "
                         f"(known: {sorted(FAULT_SITES)})")
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r} "
                         f"(known: {sorted(FAULT_KINDS)})")
    if kind == "corrupt" and site not in CORRUPT_SITES:
        raise ValueError(
            f"fault kind 'corrupt' is only valid at data-plane sites "
            f"{sorted(CORRUPT_SITES)}, not {site!r}")
    if nth.startswith("p"):
        return FaultSpec(site, kind, rate=float(nth[1:]))
    if nth.endswith("+"):
        out = FaultSpec(site, kind, start=int(nth[:-1]), every=True)
    elif "-" in nth:
        a, b = nth.split("-")
        out = FaultSpec(site, kind, start=int(a), stop=int(b))
    else:
        out = FaultSpec(site, kind, start=int(nth))
    if out.start < 1:  # arrivals are 1-based; 0 could never fire
        raise ValueError(f"bad fault spec {spec!r}: nth arrivals are 1-based")
    return out


def parse_specs(specs: Iterable[str]) -> List[FaultSpec]:
    return [parse_spec(s) for s in specs]


class FaultPlan:
    """Armed schedule: per-site arrival counters + the specs they drive."""

    def __init__(self, specs: Iterable[str], seed: int = 0):
        import numpy as np

        self.specs = parse_specs(specs)
        self._rng = np.random.default_rng(seed)
        self._arrivals: Dict[str, int] = {}
        self._corrupt_arrivals: Dict[str, int] = {}
        self._lock = threading.Lock()

    def arrivals(self, site: str) -> int:
        return self._arrivals.get(site, 0)

    def check(self, site: str) -> None:
        """Count one arrival at ``site``; raise if a spec schedules it.

        ``corrupt`` specs are invisible here — they live on their own
        arrival stream (:meth:`corruption`), so arming one can never shift
        the arrival numbering an existing chaos schedule depends on.
        """
        with self._lock:
            n = self._arrivals.get(site, 0) + 1
            self._arrivals[site] = n
            hit = next((s for s in self.specs
                        if s.site == site and s.kind != "corrupt"
                        and s.fires(n, self._rng)), None)
        if hit is None:
            return
        from fairify_tpu_torch import obs

        obs.registry().counter("fault_injected").inc(site=site, kind=hit.kind)
        obs.event("fault_injected", site=site, kind=hit.kind, arrival=n)
        raise InjectedFault(site, hit.kind, n)

    def corruption(self, site: str) -> Optional[int]:
        """Count one data-plane arrival at ``site``; return the arrival
        number if a ``corrupt`` spec schedules a bit flip there, else None.

        Never raises: the caller is expected to mutate the payload it was
        about to trust (:mod:`resilience.integrity` provides deterministic
        flip helpers keyed on the returned arrival number) and carry on —
        the whole point is that only the integrity layer may notice.
        """
        with self._lock:
            n = self._corrupt_arrivals.get(site, 0) + 1
            self._corrupt_arrivals[site] = n
            hit = next((s for s in self.specs
                        if s.site == site and s.kind == "corrupt"
                        and s.fires(n, self._rng)), None)
        if hit is None:
            return None
        from fairify_tpu_torch import obs

        obs.registry().counter("fault_injected").inc(site=site, kind="corrupt")
        obs.event("fault_injected", site=site, kind="corrupt", arrival=n)
        return n


_active: Optional[FaultPlan] = None
_lock = threading.Lock()


def arm(specs: Iterable[str], seed: int = 0) -> Optional[FaultPlan]:
    """Activate a fault schedule (replacing any previous one); None if empty."""
    global _active
    plan = FaultPlan(specs, seed=seed) if specs else None
    with _lock:
        _active = plan
    return plan


def disarm() -> None:
    global _active
    with _lock:
        _active = None


def active() -> Optional[FaultPlan]:
    return _active


def check(site: str) -> None:
    """One arrival at ``site`` — no-op unless a plan is armed.

    The disarmed path is one global read, so instrumented hot paths (every
    pipeline dispatch/drain) pay nothing in production.
    """
    plan = _active
    if plan is not None:
        plan.check(site)


def corruption(site: str) -> Optional[int]:
    """One data-plane arrival at ``site`` — None unless an armed ``corrupt``
    spec fires there (see :meth:`FaultPlan.corruption`)."""
    plan = _active
    if plan is None:
        return None
    return plan.corruption(site)


class armed:
    """Scope a fault schedule: ``with faults.armed(specs, seed): ...``.

    Nested scopes stack (the inner schedule wins for its duration); an
    empty ``specs`` is a true no-op, so call sites can pass config fields
    unconditionally.
    """

    def __init__(self, specs: Iterable[str], seed: int = 0):
        self._specs = tuple(specs or ())
        self._seed = seed
        self._prev: Optional[FaultPlan] = None
        self.plan: Optional[FaultPlan] = None

    def __enter__(self) -> Optional[FaultPlan]:
        if not self._specs:
            self.plan = _active
            return self.plan
        self._prev = _active
        self.plan = arm(self._specs, seed=self._seed)
        return self.plan

    def __exit__(self, *exc) -> bool:
        if self._specs:
            global _active
            with _lock:
                _active = self._prev
        return False
