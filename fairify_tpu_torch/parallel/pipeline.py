"""Bounded async launch pipeline on CUDA events: overlap launches with host
decode.

Port of ``fairify_tpu/parallel/pipeline.py``.  The sweep's host decode of
a launch (exact ``validate_pair`` replay of every flip, witness
extraction, the slab search) can run while the next launch is on the card,
if nothing in between waits for the card.  This module makes that a
structure:

* :class:`LaunchPipeline` — a bounded in-flight FIFO.  ``submit(fn)``
  first drains the oldest entries until at most ``depth - 1`` launches
  remain in flight, then dispatches: ``fn()`` launches on the current
  stream and returns ``(payload, ctx)``, ``payload`` a dict / tuple /
  list / tensor of the launch's outputs; the pipeline then starts a
  ``non_blocking`` copy of every CUDA tensor of ``payload`` into a pinned
  host buffer that the queue entry owns (a fresh one per entry, so no
  buffer is reused before its entry drains) and records a
  ``torch.cuda.Event`` behind the copies.  ``depth=1`` is the synchronous
  fetch order.
* The drain is the **only** sync point: ``event.synchronize()``, then
  numpy views of the pinned buffers (of the tensors themselves on the
  CPU, where the payload is already on the host).
* :func:`stage` puts a submit's numpy inputs on the card the same way
  round: through a pinned buffer with ``non_blocking=True``.  A pageable
  host-to-device copy (``torch.as_tensor(a, device=cuda)``) synchronises
  the stream in PyTorch's copy path, so a submit built that way would
  wait for the launches before it and no depth would overlap anything.
* :class:`FlightStats` — max and time-weighted mean launches in flight,
  mirrored into the obs ``launches_in_flight`` gauge (``stat="max"`` /
  ``stat="mean"``).

Verdict-map invariance: the pipeline changes only *when* results are
fetched, never which kernels run or with which seeds (chunk RNG streams
are keyed to global chunk starts), so outputs are equal at every depth.

Fault tolerance: dispatch and drain are the fault sites ``launch.submit``
/ ``launch.decode``.  With a :class:`resilience.supervisor.Supervisor`
attached, a transient error at either site is retried (a failed decode
re-dispatches its ``fn``: submit fns are idempotent, their RNG streams are
keyed); exhaustion or a fatal error yields the entry as ``(meta, ctx,
ChunkFailure)`` in its FIFO slot, and later entries are unaffected.  A
``launch.decode:corrupt`` spec flips one bit of a dict payload after the
fetch (:func:`resilience.integrity.corrupt_host`), for the consumer's
integrity checks to catch.  Without a supervisor errors propagate.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

def stage(a, device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) as a tensor on ``device``,
    without a sync: on a CUDA device through a pinned buffer with a
    ``non_blocking`` copy; on the CPU the array itself.  The pinned buffer
    may be dropped at once: PyTorch's caching host allocator records an
    event on the copy's stream and hands the block out again only after
    that event has passed."""
    t = a if torch.is_tensor(a) else torch.as_tensor(np.ascontiguousarray(a))
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def _walk(obj, leaf):
    """``obj`` with ``leaf`` applied to every tensor in its dicts, lists and
    tuples (namedtuples included)."""
    if torch.is_tensor(obj):
        return leaf(obj)
    if isinstance(obj, dict):
        return {k: _walk(v, leaf) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_walk(v, leaf) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_walk(v, leaf) for v in obj)
    return obj


def start_fetch(payload) -> Tuple[Any, list]:
    """Start copying every CUDA tensor of ``payload`` into a fresh pinned
    host buffer (``non_blocking``) and record one event per device behind
    the copies: ``(host payload of pinned / CPU tensors, events)``."""
    devices = set()

    def to_pinned(t):
        if t.device.type != "cuda":
            return t.detach()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t.detach(), non_blocking=True)
        devices.add(t.device)
        return buf

    host = _walk(payload, to_pinned)
    events = []
    for dev in sorted(devices, key=str):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return host, events


def finish_fetch(host, events):
    """Wait for the copies (the pipeline's one sync point) and return the
    payload with numpy views in place of its tensors."""
    for ev in events:
        ev.synchronize()
    return _walk(host, lambda t: t.numpy())


def fetch(payload):
    """Synchronous :func:`start_fetch` + :func:`finish_fetch`."""
    return finish_fetch(*start_fetch(payload))


class FlightStats:
    """In-flight launch accounting: current, max, and time-weighted mean.

    ``update(n)`` is called on every queue-depth transition; the mean is the
    integral of depth over time divided by elapsed time since the first
    transition.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self.max = 0
        self._cur = 0
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self._area = 0.0

    def update(self, n: int) -> None:
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        else:
            self._area += self._cur * (now - self._t_last)
        self._t_last = now
        self._cur = n
        if n > self.max:
            self.max = n

    def mean(self) -> float:
        if self._t0 is None or self._t_last == self._t0:
            return float(self._cur)
        return self._area / (self._t_last - self._t0)

    def summary(self) -> dict:
        return {"max": int(self.max), "mean": round(self.mean(), 3)}


class LaunchPipeline:
    """Bounded in-flight queue of launches whose outputs are copied to the
    host behind CUDA events.

    ``submit(fn, meta)`` expects ``fn() -> (payload, ctx)``: ``payload``
    the launch's outputs (tensors in dicts / tuples / lists), ``ctx``
    opaque host-side context the decode needs.  It returns the entries it
    had to drain to make room, each ``(meta, ctx, host_payload)`` with
    numpy arrays in place of the tensors; ``drain()`` flushes the rest in
    submission order.  One pipeline can serve several phases of a run
    back to back; its lifetime :class:`FlightStats` then describe the run.

    ``gauge=False`` keeps an engine-internal micro-pipeline off the
    ``launches_in_flight`` gauge; ``fault_sites=False`` keeps a pipeline
    whose whole phase is supervised as one unit (the prune pass) off the
    ``launch.submit`` / ``launch.decode`` arrival counts.
    """

    def __init__(self, depth: int = 2, stats: Optional[FlightStats] = None,
                 gauge: bool = True, supervisor=None, fault_sites: bool = True):
        self.depth = max(1, int(depth))
        self.stats = stats if stats is not None else FlightStats()
        self._gauge = gauge
        self._fault_sites = fault_sites
        self.supervisor = supervisor
        self._q: deque = deque()
        self.stats.update(0)

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, fn: Callable[[], Tuple[Any, Any]],
               meta: Any = None) -> List[Tuple[Any, Any, Any]]:
        ready = []
        while len(self._q) >= self.depth:
            ready.append(self._drain_one())
        self._q.append(self._dispatch(fn, meta))
        self.stats.update(len(self._q))
        return ready

    def _launch(self, fn) -> tuple:
        """``fn()`` with its outputs' copies started: ``(ctx, (host, events,
        device payload))``; the entry keeps the device payload alive until
        its copies have been waited for."""
        payload, ctx = fn()
        host, events = start_fetch(payload)
        return ctx, (host, events, payload)

    def _dispatch(self, fn, meta) -> tuple:
        """One supervised dispatch → queue entry ``(meta, ctx, flight, fn,
        trace_ctx)``; a degraded dispatch enqueues its ``ChunkFailure`` in
        place of the flight, so FIFO order is kept."""
        from fairify_tpu_torch.obs import trace as trace_mod
        from fairify_tpu_torch.resilience import faults
        from fairify_tpu_torch.resilience.supervisor import ChunkDegraded

        tctx = trace_mod.current_context()

        def attempt():
            if self._fault_sites:
                faults.check("launch.submit")
            return self._launch(fn)

        if self.supervisor is None:
            ctx, flight = attempt()
            return meta, ctx, flight, fn, tctx
        try:
            ctx, flight = self.supervisor.run(attempt, site="launch.submit")
        except ChunkDegraded as exc:
            return meta, None, exc.failure, None, tctx
        return meta, ctx, flight, fn, tctx

    def drain(self) -> Iterator[Tuple[Any, Any, Any]]:
        while self._q:
            yield self._drain_one()

    def _drain_one(self) -> Tuple[Any, Any, Any]:
        from fairify_tpu_torch import obs
        from fairify_tpu_torch.obs import trace as trace_mod
        from fairify_tpu_torch.resilience import faults
        from fairify_tpu_torch.resilience.supervisor import ChunkDegraded, ChunkFailure

        meta, ctx, flight, fn, tctx = self._q.popleft()
        if isinstance(flight, ChunkFailure):  # degraded at dispatch
            self.stats.update(len(self._q))
            self._record_gauge()
            return meta, ctx, flight

        state = {"flight": flight}

        def fetch_once():
            if self._fault_sites:
                faults.check("launch.decode")
            host, events = state["flight"][:2]
            return finish_fetch(host, events)

        def redispatch():
            # A failed decode lost its payload: re-run the launch.  Submit
            # fns are idempotent (keyed RNG), so the relaunch is bit-equal.
            if fn is not None:
                state["flight"] = self._launch(fn)[1]

        # The pipeline's one sync point, as its own span: short waits in
        # the trace mean real overlap.
        with trace_mod.context(tctx), \
                obs.span("pipeline.drain", in_flight=len(self._q) + 1,
                         depth=self.depth):
            if self.supervisor is None:
                host = fetch_once()
            else:
                try:
                    host = self.supervisor.run(fetch_once, site="launch.decode",
                                               on_retry=redispatch)
                except ChunkDegraded as exc:
                    host = exc.failure
        if self._fault_sites and isinstance(host, dict):
            # launch.decode:corrupt flips one bit of the fetched payload
            # (its own arrival stream): only the consumer's integrity
            # checks may notice.
            n = faults.corruption("launch.decode")
            if n is not None:
                from fairify_tpu_torch.resilience import integrity

                host = integrity.corrupt_host(host, n)
        self.stats.update(len(self._q))
        self._record_gauge()
        return meta, ctx, host

    def _record_gauge(self) -> None:
        if not self._gauge:
            return
        from fairify_tpu_torch import obs

        g = obs.registry().gauge("launches_in_flight")
        prev = g.value(stat="max")
        if prev is None or self.stats.max > prev:
            g.set(self.stats.max, stat="max")
        g.set(round(self.stats.mean(), 3), stat="mean")
