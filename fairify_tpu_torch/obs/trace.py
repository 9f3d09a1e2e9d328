"""Structured span tracer: nested, thread-safe spans → JSONL + Chrome trace.

Copy of ``fairify_tpu/obs/trace.py``, so the event logs of both packages
share one layout.  One :class:`Tracer` per run (activated by
``SweepConfig.trace_out``).  Instrumented code never holds a tracer —
it calls the module-level :func:`span` / :func:`event`, which route to the
active tracer or to a shared no-op when tracing is off, so the disabled
path costs one global read per span.

Event-log schema (one JSON object per line, append-only and crash-safe
like the verdict ledgers; truncated trailing lines are tolerated on read):

* ``{"type": "meta", "version": 1, "run_id": ..., "wall_time": ...}`` —
  written once per tracer activation.
* ``{"type": "span", "name", "span_id", "parent_id", "tid", "ts",
  "dur_s", "attrs"}`` — written when a span closes.  ``ts`` is wall-clock
  epoch seconds at span start (so logs from sequential runs appended to
  one file stay ordered); ``dur_s`` is a monotonic perf-counter delta.
  Spans that covered device work carry an automatic ``launches`` attr —
  the delta of the ``device_launches`` counter over the span.
* ``{"type": "event", "name", "ts", "tid", "attrs"}`` — instant events
  (per-partition verdicts, retries).
* ``{"type": "metrics", "ts", "metrics"}`` — the run's registry delta
  (:func:`fairify_tpu_torch.obs.metrics.snapshot_delta` of activation-time vs
  close-time snapshots, so a warm-up pass or earlier run in the same
  process never pollutes it), appended when the tracer closes.

:func:`write_chrome_trace` converts an event log into the Chrome
``traceEvents`` JSON that ``chrome://tracing`` / Perfetto load directly;
the JAX package's ``obs.report`` aggregates the same log into tables.

This module is the obs layer's clock shim: the one place that calls
``time.time()`` (wall-clock span timestamps).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import List, Optional

from fairify_tpu_torch.obs import metrics as metrics_mod

EVENT_VERSION = 1


def _round(v: float, nd: int = 6) -> float:
    # Raw floats internally, rounding only at serialization (the PhaseTimer
    # 2-vs-3-decimal inconsistency this layer replaces).
    return round(float(v), nd)


class _NullSpan:
    """Shared do-nothing span for the tracing-disabled path."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


# ---------------------------------------------------------------------------
# Trace context: the cross-boundary identity of one request
# ---------------------------------------------------------------------------


class TraceContext:
    """The per-request identity that crosses process boundaries.

    ``trace_id`` is stamped once, at submit time (``serve/client.py``);
    ``parent_span`` is the sender-side span id the receiving process
    should treat as its logical parent.  Span ids are per-process
    counters, so ``parent_span`` is only meaningful together with the
    sender's shard — the merged view namespaces tracks by ``(pid, tid)``
    and joins shards on ``trace_id``, never on raw span ids.
    """

    __slots__ = ("trace_id", "parent_span")

    def __init__(self, trace_id: str, parent_span: Optional[int] = None):
        self.trace_id = str(trace_id)
        self.parent_span = parent_span

    def fields(self) -> dict:
        """The wire form: ``{"trace": {"id": ..., "span": ...}}`` —
        mergeable into any JSON frame (spool payload, pipe frame, SMT
        query frame) without schema changes on the reader side."""
        t: dict = {"id": self.trace_id}
        if self.parent_span is not None:
            t["span"] = int(self.parent_span)
        return {"trace": t}

    @staticmethod
    def from_fields(obj: Optional[dict]) -> Optional["TraceContext"]:
        """Recover a context from a frame's ``trace`` field (None when
        the frame predates tracing or came from a trace-off sender)."""
        t = (obj or {}).get("trace")
        if not isinstance(t, dict) or not t.get("id"):
            return None
        span_id = t.get("span")
        return TraceContext(str(t["id"]),
                            int(span_id) if span_id is not None else None)


def new_trace_id() -> str:
    """A fresh 64-bit hex trace id (collision-safe across processes)."""
    return os.urandom(8).hex()


_ctx_tls = threading.local()


def current_context() -> Optional[TraceContext]:
    """The trace context bound to this thread (None outside any request)."""
    return getattr(_ctx_tls, "ctx", None)


class _ContextScope:
    """Bind a context for a scope; restores the previous binding on exit.

    A ``None`` context is a no-op scope (the caller can bind
    ``TraceContext.from_fields(frame)`` unconditionally)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self) -> Optional[TraceContext]:
        self._prev = getattr(_ctx_tls, "ctx", None)
        if self._ctx is not None:
            _ctx_tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _ctx_tls.ctx = self._prev
        return False


def context(ctx: Optional[TraceContext]) -> _ContextScope:
    """``with context(ctx): ...`` — every span/event/outgoing frame in the
    scope records/carries ``ctx``.  Nested scopes shadow; threads never
    inherit (a handoff must capture :func:`current_context` explicitly
    and re-bind on the far side — the queues in serve/ and parallel/ do
    exactly that)."""
    return _ContextScope(ctx)


def context_fields() -> dict:
    """Trace fields for an outgoing cross-boundary frame.

    ``{}`` when no context is bound (control frames — ping/drain/hello —
    legitimately carry none).  The ``span`` field is the innermost open
    span on this thread when tracing is active, so the receiver's shard
    records which sender-side stage handed the work over."""
    ctx = current_context()
    if ctx is None:
        return {}
    parent = ctx.parent_span
    tr = _active
    if tr is not None:
        stack = tr._stack()
        if stack:
            parent = stack[-1].span_id
    return TraceContext(ctx.trace_id, parent).fields()


class Span:
    """One open span; created by :meth:`Tracer.span`, closed on ``__exit__``."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "tid",
                 "_tracer", "_t0", "_ts", "_launch0", "_trace")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._tracer = tracer
        self.span_id = next(tracer._ids)
        self.parent_id: Optional[int] = None
        self.tid = 0

    def set(self, **attrs) -> None:
        """Attach/overwrite attributes on the open span."""
        self.attrs.update(attrs)

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        self.parent_id = stack[-1].span_id if stack else None
        self.tid = tr._tid()
        self._trace = current_context()
        self._ts = time.time()
        self._launch0 = tr._launches()
        self._t0 = time.perf_counter()
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        launches = tr._launches() - self._launch0
        if launches > 0:
            self.attrs.setdefault("launches", int(launches))
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        rec = {
            "type": "span", "name": self.name, "span_id": self.span_id,
            "parent_id": self.parent_id, "tid": self.tid,
            "ts": _round(self._ts), "dur_s": _round(dur),
            "attrs": self.attrs,
        }
        if self._trace is not None:
            rec["trace_id"] = self._trace.trace_id
            if self.parent_id is None \
                    and self._trace.parent_span is not None:
                # Cross-process parent: the sender-side span id that handed
                # this work over (meaningful only with the sender's shard).
                rec["remote_parent"] = int(self._trace.parent_span)
        tr._write(rec)
        return False


class Tracer:
    """Appends span/event records to a JSONL file, one line per record."""

    def __init__(self, path: str, run_id: Optional[str] = None):
        self.path = path
        self.run_id = run_id
        parent = os.path.dirname(path)
        if parent:  # e.g. --trace-out inside a result_dir not yet created
            os.makedirs(parent, exist_ok=True)
        self._fp = open(path, "a")
        self._write_lock = threading.Lock()
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._tid_lock = threading.Lock()
        self._tid_map: dict = {}
        self._closed = False
        # Baseline for the closing per-run metrics delta: the process
        # registry is cumulative (a warm-up sweep or a previous run in the
        # same process has already bumped it).
        self._metrics0 = metrics_mod.registry().snapshot()
        # ``pid`` namespaces this shard's tracks in merged views: thread
        # ids are only unique per process, so two replicas' worker threads
        # would otherwise interleave on one Perfetto track.
        self._write({"type": "meta", "version": EVENT_VERSION,
                     "run_id": run_id, "pid": os.getpid(),
                     "wall_time": _round(time.time())})

    # -- internals ---------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._tid_lock:
            tid = self._tid_map.get(ident)
            if tid is None:
                tid = self._tid_map[ident] = len(self._tid_map)
            return tid

    @staticmethod
    def _launches() -> float:
        return metrics_mod.registry().counter("device_launches").total()

    def _write(self, rec: dict) -> None:
        from fairify_tpu_torch.resilience.journal import write_line

        line = json.dumps(rec) + "\n"
        with self._write_lock:
            if self._closed:
                return
            # Shared single-write append helper (resilience.journal): one
            # OS write per record, so a crash can tear at most the final
            # line.  No fsync here — spans are dense and advisory; the
            # verdict ledger (which fsyncs) is the record of truth.
            write_line(self._fp, line, fsync=False)

    # -- public API --------------------------------------------------------
    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        rec = {"type": "event", "name": name, "ts": _round(time.time()),
               "tid": self._tid(), "attrs": attrs}
        ctx = current_context()
        if ctx is not None:
            rec["trace_id"] = ctx.trace_id
        self._write(rec)

    def close(self, snapshot_metrics: bool = True) -> None:
        if self._closed:
            return
        if snapshot_metrics:
            delta = metrics_mod.snapshot_delta(
                self._metrics0, metrics_mod.registry().snapshot())
            self._write({"type": "metrics", "ts": _round(time.time()),
                         "metrics": delta})
        with self._write_lock:
            self._closed = True
            self._fp.close()


# ---------------------------------------------------------------------------
# Active-tracer plumbing (module-level; instrumented code calls these)
# ---------------------------------------------------------------------------

_active: Optional[Tracer] = None
_active_lock = threading.Lock()


def activate(tracer: Tracer) -> None:
    global _active
    with _active_lock:
        _active = tracer


def deactivate() -> None:
    global _active
    with _active_lock:
        _active = None


def current() -> Optional[Tracer]:
    return _active


def span(name: str, **attrs):
    """A span on the active tracer, or the shared no-op when tracing is off."""
    tr = _active
    if tr is None:
        return NULL_SPAN
    return tr.span(name, **attrs)


def event(name: str, **attrs) -> None:
    tr = _active
    if tr is not None:
        tr.event(name, **attrs)


class _TracingScope:
    """Context manager behind :func:`tracing` / :func:`maybe_tracing`."""

    def __init__(self, path: Optional[str], run_id: Optional[str]):
        self._path = path
        self._run_id = run_id
        self._tracer: Optional[Tracer] = None

    def __enter__(self) -> Optional[Tracer]:
        if not self._path or current() is not None:
            # Tracing off, or an outer scope (e.g. the CLI) already owns the
            # tracer — nested sweeps must not re-open/re-export it.
            return current()
        self._tracer = Tracer(self._path, run_id=self._run_id)
        activate(self._tracer)
        return self._tracer

    def __exit__(self, *exc):
        if self._tracer is None:
            return False
        deactivate()
        self._tracer.close()
        try:
            write_chrome_trace(self._path, chrome_trace_path(self._path))
        except (OSError, ValueError):
            pass  # the event log is the record of truth; the view is best-effort
        return False


def tracing(path: Optional[str], run_id: Optional[str] = None) -> _TracingScope:
    """Own a tracer for the scope: open + activate, close + Chrome-export.

    No-op when ``path`` is falsy or a tracer is already active (so per-model
    scopes nest cleanly under a CLI-level ``--trace-out`` scope).
    """
    return _TracingScope(path, run_id)


maybe_tracing = tracing


# ---------------------------------------------------------------------------
# Readers / exporters
# ---------------------------------------------------------------------------


def load_events(path: str, count_skipped: bool = False):
    """Event-log records; tolerates truncated/partially-written lines.

    A crash mid-sweep leaves a torn final line (the same convention as the
    verdict ledger), and a crash mid-``write`` on a network filesystem can
    tear earlier lines too.  Unparseable lines are skipped, never raised on
    — but they are *counted*, so consumers (``fairify_tpu report``) can
    surface "N torn line(s) skipped" instead of silently under-reporting.

    Returns the record list, or ``(records, skipped)`` when
    ``count_skipped`` is true.  Blank lines are not torn records.
    """
    out = []
    skipped = 0
    with open(path) as fp:
        for line in fp:
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                skipped += 1
    if count_skipped:
        return out, skipped
    return out


def chrome_trace_path(jsonl_path: str) -> str:
    base = jsonl_path[:-len(".jsonl")] if jsonl_path.endswith(".jsonl") \
        else jsonl_path
    return base + ".chrome.json"


def shard_path(trace_dir: str) -> str:
    """This process's trace shard inside a shared ``--trace-dir``.

    Per-process shards are how the fleet traces without cross-process
    file locking: each process appends to its own ``trace.<pid>.jsonl``
    (crash-safe single-write appends), and the merge joins them on
    ``trace_id`` after the fact."""
    os.makedirs(trace_dir, exist_ok=True)
    return os.path.join(trace_dir, f"trace.{os.getpid()}.jsonl")


def shard_paths(trace_dir: str) -> List[str]:
    """Every trace shard under ``trace_dir`` (sorted; [] when none)."""
    try:
        names = sorted(os.listdir(trace_dir))
    except OSError:
        return []
    return [os.path.join(trace_dir, n) for n in names
            if n.startswith("trace.") and n.endswith(".jsonl")]


def _chrome_events(records: list, pid: int, ts0: float,
                   include_instants: bool) -> list:
    out = []
    for r in records:
        args = dict(r.get("attrs") or {})
        if r.get("trace_id"):
            args["trace_id"] = r["trace_id"]
        if r.get("type") == "span":
            out.append({
                "name": r["name"], "ph": "X", "pid": pid,
                "tid": r.get("tid", 0),
                "ts": _round((r["ts"] - ts0) * 1e6, 3),
                "dur": _round(r["dur_s"] * 1e6, 3),
                "args": args,
            })
        elif r.get("type") == "event" and include_instants:
            out.append({
                "name": r["name"], "ph": "i", "s": "t", "pid": pid,
                "tid": r.get("tid", 0),
                "ts": _round((r["ts"] - ts0) * 1e6, 3),
                "args": args,
            })
    return out


def _shard_meta(records: list, fallback_pid: int) -> dict:
    meta = next((r for r in records if r.get("type") == "meta"), {})
    pid = meta.get("pid")
    return {"pid": int(pid) if pid else fallback_pid,
            "run_id": meta.get("run_id")}


def write_chrome_trace(jsonl_path: str, out_path: str,
                       include_instants: bool = True) -> int:
    """Convert one event log to Chrome ``traceEvents`` JSON (Perfetto-ready).

    Timestamps are rebased to the log's earliest record so the viewer opens
    at t=0.  Returns the number of trace events written.
    """
    records = load_events(jsonl_path)
    ts0 = min((r["ts"] for r in records if "ts" in r), default=0.0)
    meta = _shard_meta(records, fallback_pid=0)
    trace = [{"name": "process_name", "ph": "M", "pid": meta["pid"],
              "args": {"name": meta["run_id"] or "fairify_tpu_torch"}}]
    trace += _chrome_events(records, meta["pid"], ts0, include_instants)
    with open(out_path, "w") as fp:
        json.dump({"traceEvents": trace, "displayTimeUnit": "ms"}, fp)
    return len(trace) - 1


def write_chrome_trace_merged(shard_jsonl_paths: List[str], out_path: str,
                              include_instants: bool = True) -> int:
    """Merge per-process trace shards into one Perfetto export.

    Each shard becomes its own process track, named from the shard's meta
    record (``run_id [pid N]``) and pid-namespaced so thread ids from
    different processes never collide on one track.  Timestamps are
    rebased to the earliest record across ALL shards (same-host wall
    clock), so cross-process handoffs line up visually.  Returns the
    number of (non-metadata) trace events written.
    """
    shards = []
    for i, path in enumerate(shard_jsonl_paths):
        try:
            records = load_events(path)
        except OSError:
            continue
        meta = _shard_meta(records, fallback_pid=-(i + 1))
        shards.append((path, meta, records))
    ts0 = min((r["ts"] for _p, _m, records in shards
               for r in records if "ts" in r), default=0.0)
    trace = []
    n_events = 0
    for path, meta, records in shards:
        run = meta["run_id"] or os.path.basename(path)
        trace.append({"name": "process_name", "ph": "M", "pid": meta["pid"],
                      "args": {"name": f"{run} [pid {meta['pid']}]"}})
        events = _chrome_events(records, meta["pid"], ts0, include_instants)
        n_events += len(events)
        trace += events
    with open(out_path, "w") as fp:
        json.dump({"traceEvents": trace, "displayTimeUnit": "ms"}, fp)
    return n_events
