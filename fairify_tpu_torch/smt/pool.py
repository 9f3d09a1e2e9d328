"""Crash-contained out-of-process SMT worker pool.

Port of ``fairify_tpu/smt/pool.py`` onto the port's ``obs``,
``resilience.faults`` and ``resilience.supervisor``; the metric names
(``smt_queries``, ``smt_worker_crashes``, ``smt_memouts``, the
``smt_pool_*`` gauges) are the JAX package's, so its ``report`` and the
port's heartbeat read them.  Workers are fresh interpreters
(``subprocess.Popen`` of ``python -m fairify_tpu_torch.smt.worker`` with
``cwd`` at the repository root), never forks: a forked child of a process
with a live CUDA context cannot use CUDA, and a ``preexec_fn`` is unsafe
beside the pool's threads.  The pool's lane threads make no CUDA call.

The ONLY way the sweep and its UNKNOWN-retry ladder reach a native
solver.  Queries are serialized via ``verify.smt.
build_query`` (the ``to_smtlib`` emitter — nothing but text crosses the
process boundary) and dispatched to N worker subprocesses
(:mod:`fairify_tpu_torch.smt.worker`), each disposable:

* **hard wall-clock kill** — every dispatch has a deadline of its solver
  tier's soft timeout plus ``grace_s``; a worker that has not answered by
  then is SIGKILLed (z3's soft ``timeout`` is best-effort — a wedged
  tactic ignores it, and before this pool it wedged the whole run).
* **RSS cap** — workers start under ``RLIMIT_AS``
  (``memory_cap_mb``), so a solver memory blowup dies in its own
  process; the pool retries the query ONCE on a fresh worker with a
  doubled cap (``memout`` never enters the timeout-escalation ladder —
  more time only OOMs harder).
* **crash containment** — any worker death (EOF, SIGKILL, kernel OOM) is
  classified through the ``resilience.supervisor`` transient/fatal
  taxonomy and retried on a fresh worker up to ``max_retries``;
  exhaustion degrades exactly that query to UNKNOWN with a
  machine-readable reason (``smt.worker:crash|hang|memout|spawn``) —
  never a crashed run or a hung server.
* **parallel fan-out** — ``submit_serialized`` returns a future;
  UNKNOWN boxes from a chunk fan out across all workers (z3 is
  single-threaded; the pre-pool UNKNOWN-retry ladder was serial).
* **portfolio racing** — ``portfolio=K`` races K seed variants of the
  same query on K workers and takes the first decisive answer.  The
  VERDICT is deterministic (every variant is sound, so decisive answers
  agree); the witness and which variant wins are not.

Chaos: the ``smt.worker.{spawn,crash,hang,memout}`` fault sites fire in
the dispatch path and convert to REAL subprocess events — a crash fault
SIGKILLs the live worker mid-query, a hang fault wedges it past the
deadline, a memout fault makes it allocate past its cap — so the chaos
suite exercises the true containment machinery, not a simulation of it.
Arrival counting is per dispatch attempt; deterministic schedules want
``workers=1`` or ``N+`` specs (concurrent dispatch order is not).
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from fairify_tpu_torch import obs
from fairify_tpu_torch.obs import trace as trace_mod
from fairify_tpu_torch.resilience import faults as faults_mod
from fairify_tpu_torch.resilience.faults import InjectedFault
from fairify_tpu_torch.smt import protocol
from fairify_tpu_torch.smt.brute import DEFAULT_PAIR_CAP


@dataclass(frozen=True)
class PoolConfig:
    """Knobs of one pool (the ``--smt-*`` CLI flags)."""

    workers: int = 1
    # RLIMIT_AS per worker, MB; 0 = uncapped (no memout containment, no
    # higher-cap retry tier).
    memory_cap_mb: int = 0
    # K seed variants raced per query; 0/1 = off.  Each variant occupies
    # a worker, so the pool sizes its dispatch concurrency to
    # workers // K.
    portfolio: int = 0
    backend: str = "auto"          # auto | z3 | brute (worker --backend)
    grace_s: float = 1.0           # SIGKILL this long after the deadline
    max_retries: int = 2           # fresh-worker retries per query
    backoff_s: float = 0.02        # first respawn backoff (jittered, 2x)
    pair_cap: int = DEFAULT_PAIR_CAP  # brute backend enumeration budget
    seed: int = 0
    spawn_timeout_s: float = 20.0  # worker hello deadline
    # Shared trace-shard directory (obs.trace.shard_path): workers append
    # their solve spans to trace.<pid>.jsonl there; None = no worker-side
    # tracing (trace contexts still ride the solve frames either way).
    trace_dir: Optional[str] = None


@dataclass
class SmtResult:
    """One query's pooled outcome (the ``decide_box_smt`` triple + audit)."""

    verdict: str                   # 'sat' | 'unsat' | 'unknown'
    ce: Optional[Tuple] = None
    reason: Optional[str] = None   # None for decided; taxonomy code else
    attempts: int = 0              # dispatches actually made
    elapsed_s: float = 0.0
    backend: str = ""

    @property
    def triple(self):
        return self.verdict, self.ce, self.reason


class WorkerDied(RuntimeError):
    """A worker failed to answer: crashed, hung past deadline, or could
    not spawn.  ``kind`` ∈ {crash, hang, spawn, memout}; ``injected`` is
    the fault kind when the chaos machinery caused it (drives the
    transient/fatal classification)."""

    def __init__(self, kind: str, detail: str, injected: Optional[str] = None):
        super().__init__(f"smt worker {kind}: {detail}")
        self.kind = kind
        self.injected = injected


class _Worker:
    """One live subprocess + its pipes.  NOT thread-safe: a worker is
    owned by exactly one dispatch between checkout and checkin."""

    _next_id = 0

    def __init__(self, cfg: PoolConfig, cap_mb: int):
        _Worker._next_id += 1
        self.id = _Worker._next_id
        self.cap_mb = cap_mb
        cmd = [sys.executable, "-m", "fairify_tpu_torch.smt.worker",
               "--backend", cfg.backend,
               "--memory-cap-mb", str(int(cap_mb)),
               "--pair-cap", str(int(cfg.pair_cap))]
        if cfg.trace_dir:
            cmd += ["--trace-dir", cfg.trace_dir]
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, bufsize=1,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))))
        hello = self.recv(cfg.spawn_timeout_s)
        if hello is None or not hello.get("hello"):
            self.kill()
            raise WorkerDied("spawn", f"no hello from worker {self.id} "
                                      f"({hello!r})")
        self.backend = hello.get("backend", "?")

    def alive(self) -> bool:
        return self.proc.poll() is None

    def send(self, obj: dict) -> None:
        try:
            self.proc.stdin.write(protocol.dump_msg(obj))
            self.proc.stdin.flush()
        except (OSError, ValueError) as exc:
            raise WorkerDied("crash", f"write to worker {self.id}: {exc}")

    def recv(self, timeout_s: float) -> Optional[dict]:
        """One framed response; None on deadline (caller kills), raises
        :class:`WorkerDied` on EOF (the worker is gone)."""
        import select

        fd = self.proc.stdout
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while True:
            left = deadline - time.monotonic()
            if left <= 0.0:
                return None
            ready, _, _ = select.select([fd], [], [], min(left, 0.5))
            if not ready:
                continue
            line = fd.readline()
            if line == "":
                raise WorkerDied("crash", f"worker {self.id} EOF "
                                          f"(rc={self.proc.poll()})")
            msg = protocol.parse_msg(line)
            if msg is not None:
                return msg

    def kill(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.send_signal(signal.SIGKILL)
            except OSError:
                pass
        try:
            self.proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            pass
        for fp in (self.proc.stdin, self.proc.stdout):
            try:
                if fp is not None:
                    fp.close()
            except OSError:
                pass


class SmtPool:
    """See module docstring.  Thread-safe; one instance per run/server."""

    def __init__(self, cfg: PoolConfig = PoolConfig()):
        import numpy as np

        self.cfg = cfg
        self._cv = threading.Condition()
        self._idle: List[_Worker] = []
        self._spawned: List[_Worker] = []  # every worker ever forked
        self._n_live = 0
        self._queued = 0
        self._active = 0
        self._closed = False
        self._query_s_ema: Optional[float] = None
        self._rng = np.random.default_rng(cfg.seed)
        self._threads: List[threading.Thread] = []
        # (future, query, soft_timeout, retry_tiers, trace_ctx): the trace
        # context is captured at submit and re-bound in the dispatch lane —
        # lanes are pool threads, and thread-locals never cross a handoff.
        self._pending: List[Tuple[Future, dict, float, tuple,
                                  Optional[trace_mod.TraceContext]]] = []

    # --- introspection (heartbeat / admission) ----------------------------

    def stats(self) -> Dict[str, int]:
        with self._cv:
            return {"workers": self._n_live, "active": self._active,
                    "queued": self._queued}

    def live_workers(self) -> List[subprocess.Popen]:
        """Procs of every live worker (chaos tests SIGKILL these)."""
        with self._cv:
            return [w.proc for w in self._spawned if w.alive()]

    def backlog_s(self) -> float:
        """Predicted seconds of queued+active host solving (0 until a
        query-time EMA exists — no evidence, no backlog claim).  The serve
        admission controller folds this into SLA feasibility so an
        UNKNOWN-heavy request cannot admit a deadline the Z3 phase will
        blow."""
        with self._cv:
            if self._query_s_ema is None:
                return 0.0
            depth = self._queued + self._active
            lanes = max(self.cfg.workers, 1)
            return depth * self._query_s_ema / lanes

    def _observe_query_s(self, elapsed: float) -> None:
        with self._cv:
            self._query_s_ema = elapsed if self._query_s_ema is None else \
                0.3 * elapsed + 0.7 * self._query_s_ema

    def _gauges(self) -> None:
        reg = obs.registry()
        st = self.stats()
        reg.gauge("smt_pool_workers").set(st["workers"])
        reg.gauge("smt_pool_active").set(st["active"])
        reg.gauge("smt_pool_queue_depth").set(st["queued"])

    # --- worker lifecycle -------------------------------------------------

    def _spawn(self, cap_mb: int) -> _Worker:
        """Fresh worker under supervision of the ``smt.worker.spawn`` site."""
        from fairify_tpu_torch.resilience.supervisor import classify

        retries = 0
        while True:
            try:
                faults_mod.check("smt.worker.spawn")
                w = _Worker(self.cfg, cap_mb)
                with self._cv:
                    self._spawned.append(w)
                return w
            except BaseException as exc:
                cls = classify(exc)
                if cls == "propagate":
                    raise
                if cls == "fatal" or retries >= self.cfg.max_retries:
                    inj = exc.kind if isinstance(exc, InjectedFault) else None
                    raise WorkerDied("spawn", f"{type(exc).__name__}: {exc}",
                                     injected=inj)
                retries += 1
                time.sleep(self.cfg.backoff_s * (2.0 ** (retries - 1))
                           * (1.0 + float(self._rng.random())))

    def _checkout(self, cap_mb: Optional[int] = None) -> _Worker:
        """An idle worker with an adequate cap (spawning under the pool
        size limit; a higher-cap memout retry always spawns fresh)."""
        want = self.cfg.memory_cap_mb if cap_mb is None else cap_mb
        if cap_mb is not None:
            # Dedicated higher-cap worker: never pulled from the idle set
            # (those run at the configured cap), never counted against the
            # pool width — it exists for exactly one retry.
            return self._spawn(cap_mb)
        with self._cv:
            while True:
                if self._closed:
                    raise WorkerDied("spawn", "pool closed")
                if self._idle:
                    return self._idle.pop()
                if self._n_live < self.cfg.workers:
                    self._n_live += 1
                    break
                self._cv.wait(timeout=0.5)
        try:
            return self._spawn(want)
        except BaseException:
            with self._cv:
                self._n_live -= 1
                self._cv.notify_all()
            raise

    def _checkin(self, w: _Worker, dedicated: bool = False) -> None:
        if dedicated:
            w.kill()
            return
        with self._cv:
            if w.alive() and not self._closed:
                self._idle.append(w)
            else:
                w.kill()
                self._n_live -= 1
            self._cv.notify_all()

    def _discard(self, w: _Worker, dedicated: bool = False) -> None:
        w.kill()
        if not dedicated:
            with self._cv:
                self._n_live -= 1
                self._cv.notify_all()

    # --- dispatch ---------------------------------------------------------

    def _dispatch(self, query: dict, timeout_s: float, seed: int,
                  cap_mb: Optional[int] = None) -> dict:
        """One query on one worker under the hard deadline.

        Raises :class:`WorkerDied` on any worker death; the chaos sites
        fire here and convert to real subprocess events (see module
        docstring)."""
        directive = None
        injected: Optional[str] = None
        try:
            faults_mod.check("smt.worker.crash")
            faults_mod.check("smt.worker.hang")
            faults_mod.check("smt.worker.memout")
        except InjectedFault as f:
            directive = f.site.rsplit(".", 1)[-1]
            injected = f.kind
            if f.kind == "crash":
                raise  # crash-kind faults always propagate (taxonomy)
        dedicated = cap_mb is not None
        w = self._checkout(cap_mb)
        with self._cv:
            self._active += 1
        self._gauges()
        t0 = time.perf_counter()
        try:
            if directive == "crash":
                # Chaos: SIGKILL the live worker mid-query — dispatch
                # proceeds against the corpse so the REAL death path runs.
                w.kill()
            elif directive == "hang":
                w.send({"op": "hang", "duration_s": 3600.0})
            elif directive == "memout":
                w.send({"op": "memout", "qid": 0})
            try:
                w.send(protocol.solve_request(
                    0, query, timeout_s, seed=seed,
                    trace=trace_mod.context_fields().get("trace")))
                resp = w.recv(timeout_s + self.cfg.grace_s)
            except WorkerDied as exc:
                self._discard(w, dedicated)
                obs.registry().counter("smt_worker_crashes").inc(kind="crash")
                raise WorkerDied("crash", str(exc), injected=injected)
            if resp is None:
                # Hard deadline: the worker ignored its soft timeout
                # (wedged tactic / chaos hang) — SIGKILL within grace.
                self._discard(w, dedicated)
                obs.registry().counter("smt_worker_crashes").inc(kind="hang")
                raise WorkerDied(
                    "hang", f"no answer within {timeout_s}s + "
                            f"{self.cfg.grace_s}s grace", injected=injected)
            if resp.get("exit") or resp.get("reason") == "memout":
                # A worker that just blew its heap is not reusable.
                self._discard(w, dedicated)
                obs.registry().counter("smt_memouts").inc()
                if injected == "memout" or resp.get("chaos") or directive:
                    resp = dict(resp, injected=injected)
            else:
                self._checkin(w, dedicated)
            self._observe_query_s(time.perf_counter() - t0)
            return resp
        finally:
            with self._cv:
                self._active -= 1
            self._gauges()

    def _solve_attempts(self, query: dict, tiers: Sequence[float],
                        seed: int) -> SmtResult:
        """The containment state machine for ONE query (no portfolio):
        tier escalation on clean timeouts, bounded fresh-worker retries on
        deaths, one higher-cap retry on memout."""
        t_start = time.perf_counter()
        attempts = 0
        crash_retries = 0
        memout_retried = False
        cap_override: Optional[int] = None
        last_reason = "timeout"
        ti = 0
        while ti < len(tiers):
            attempts += 1
            try:
                resp = self._dispatch(query, float(tiers[ti]), seed,
                                      cap_mb=cap_override)
            except WorkerDied as exc:
                reason = {"spawn": protocol.REASON_SPAWN,
                          "hang": protocol.REASON_HANG}.get(
                              exc.kind, protocol.REASON_CRASH)
                if exc.injected == "fatal" or exc.kind == "spawn" \
                        or crash_retries >= self.cfg.max_retries:
                    obs.registry().counter("smt_queries").inc(
                        verdict="unknown", reason=reason)
                    return SmtResult("unknown", None, reason,
                                     attempts=attempts,
                                     elapsed_s=time.perf_counter() - t_start)
                crash_retries += 1
                obs.registry().counter("launch_retries").inc(
                    site="smt.worker")
                time.sleep(self.cfg.backoff_s * (2.0 ** (crash_retries - 1)))
                continue  # fresh worker, same tier
            cap_override = None
            verdict = resp.get("verdict", "unknown")
            if verdict in ("sat", "unsat"):
                obs.registry().counter("smt_queries").inc(verdict=verdict)
                return SmtResult(verdict, protocol.result_ce(resp), None,
                                 attempts=attempts,
                                 elapsed_s=time.perf_counter() - t_start,
                                 backend=resp.get("backend", ""))
            reason = resp.get("reason") or "solver-error"
            last_reason = reason
            if reason == "timeout":
                ti += 1  # escalate to the next tier of the ladder
                continue
            if reason == "memout":
                died = bool(resp.get("exit") or resp.get("chaos"))
                worker_reason = protocol.REASON_MEMOUT if died else "memout"
                if not memout_retried and self.cfg.memory_cap_mb > 0:
                    # The sanctioned second attempt: same tier, one fresh
                    # worker at double the RSS cap — never a bigger time
                    # budget (that only OOMs harder).
                    memout_retried = True
                    cap_override = self.cfg.memory_cap_mb * 2
                    continue
                obs.registry().counter("smt_queries").inc(
                    verdict="unknown", reason=worker_reason)
                return SmtResult("unknown", None, worker_reason,
                                 attempts=attempts,
                                 elapsed_s=time.perf_counter() - t_start)
            obs.registry().counter("smt_queries").inc(verdict="unknown",
                                                      reason=reason)
            return SmtResult("unknown", None, reason, attempts=attempts,
                             elapsed_s=time.perf_counter() - t_start)
        obs.registry().counter("smt_queries").inc(verdict="unknown",
                                                  reason=last_reason)
        return SmtResult("unknown", None, last_reason, attempts=attempts,
                         elapsed_s=time.perf_counter() - t_start)

    def solve_serialized(self, query: dict, soft_timeout_s: float = 100.0,
                         retry_timeouts_s: Sequence[float] = ()) -> SmtResult:
        """Decide one serialized query (build with ``verify.smt.
        build_query``), racing ``portfolio`` seed variants when enabled."""
        tiers = (float(soft_timeout_s),) + tuple(retry_timeouts_s)
        k = max(int(self.cfg.portfolio), 1)
        with obs.span("smt.pool_query", tiers=len(tiers), portfolio=k):
            if k <= 1:
                return self._solve_attempts(query, tiers, self.cfg.seed)
            return self._solve_portfolio(query, tiers, k)

    def _solve_portfolio(self, query: dict, tiers: Sequence[float],
                         k: int) -> SmtResult:
        """Race k seed variants; first DECISIVE answer wins.

        Soundness makes the verdict deterministic — any two decisive
        answers agree — so losers are simply abandoned (their workers
        finish their soft timeout and return to the idle set; no kill
        races).  All-indecisive keeps the most actionable reason
        (worker-death > memout > timeout > solver-error)."""
        done = threading.Event()
        state_lock = threading.Lock()
        results: List[Optional[SmtResult]] = [None] * k
        remaining = [k]

        def run(i: int) -> None:
            res = self._solve_attempts(query, tiers, self.cfg.seed + i)
            with state_lock:
                results[i] = res
                remaining[0] -= 1
                if res.verdict != "unknown" or remaining[0] == 0:
                    done.set()

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(k)]
        for t in threads:
            t.start()
        # First decisive answer wins IMMEDIATELY — the losers are left to
        # run out their soft timeouts in the background (their workers
        # rejoin the idle set on their own); joining them here would make
        # portfolio strictly slower than a single attempt.
        done.wait()
        with state_lock:
            snapshot = list(results)
        decisive = [r for r in snapshot if r is not None
                    and r.verdict != "unknown"]
        if decisive:
            return decisive[0]
        rank = {protocol.REASON_CRASH: 0, protocol.REASON_HANG: 0,
                protocol.REASON_SPAWN: 0, protocol.REASON_MEMOUT: 1,
                "memout": 1, "timeout": 2, "solver-error": 3}
        known = [r for r in snapshot if r is not None]
        if not known:
            return SmtResult("unknown", None, protocol.REASON_CRASH)
        return sorted(known, key=lambda r: rank.get(r.reason, 4))[0]

    # --- fan-out ----------------------------------------------------------

    def submit_serialized(self, query: dict, soft_timeout_s: float = 100.0,
                          retry_timeouts_s: Sequence[float] = ()) -> Future:
        """Async fan-out: queue the query, return a Future[SmtResult].

        Dispatch lanes are sized to the worker count (each lane occupies
        one worker; a portfolio solve occupies K), so submitting a whole
        chunk of UNKNOWN boxes saturates the pool."""
        fut: Future = Future()
        with self._cv:
            if self._closed:
                fut.set_result(SmtResult(
                    "unknown", None, protocol.REASON_SPAWN))
                return fut
            self._queued += 1
            self._pending.append(
                (fut, query, float(soft_timeout_s), tuple(retry_timeouts_s),
                 trace_mod.current_context()))
            lanes = max(self.cfg.workers // max(self.cfg.portfolio, 1), 1)
            live = [t for t in self._threads if t.is_alive()]
            self._threads = live
            if len(live) < min(lanes, self._queued):
                t = threading.Thread(target=self._lane, daemon=True,
                                     name=f"smt-lane-{len(live)}")
                self._threads.append(t)
                t.start()
            self._cv.notify_all()
        self._gauges()
        return fut

    def _lane(self) -> None:
        """One dispatch lane: drain pending queries until none are left."""
        while True:
            with self._cv:
                if not self._pending or self._closed:
                    return
                fut, query, soft, retries, ctx = self._pending.pop(0)
                self._queued -= 1
            self._gauges()
            if not fut.set_running_or_notify_cancel():
                continue  # cancelled while queued (e.g. heuristic decided)
            try:
                with trace_mod.context(ctx):
                    fut.set_result(self.solve_serialized(
                        query, soft_timeout_s=soft, retry_timeouts_s=retries))
            except BaseException as exc:
                from fairify_tpu_torch.resilience.supervisor import classify

                fut.set_exception(exc)
                if classify(exc) == "propagate":
                    return  # interrupt/crash-fault: the lane dies with it
                # Anything else is contained in the future; the lane keeps
                # draining so sibling queries never stall.

    # --- lifecycle --------------------------------------------------------

    def close(self) -> None:
        with self._cv:
            self._closed = True
            pending = list(self._pending)
            self._pending.clear()
            self._queued = 0
            idle = list(self._idle)
            self._idle.clear()
            threads = list(self._threads)
            self._cv.notify_all()
        for fut, _q, _s, _r, _ctx in pending:
            if fut.cancel():
                continue
            if not fut.done():
                fut.set_result(SmtResult("unknown", None,
                                         protocol.REASON_SPAWN))
        for w in idle:
            w.kill()
        for t in threads:
            t.join(timeout=10.0)
        with self._cv:
            self._n_live = max(self._n_live - len(idle), 0)
            spawned = list(self._spawned)
            self._spawned.clear()
        for w in spawned:  # belt-and-braces: no worker outlives its pool
            w.kill()
        self._gauges()  # a closed pool reads 0/0 on the heartbeat

    def __enter__(self) -> "SmtPool":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def solve_box(pool: SmtPool, net, enc, lo, hi, soft_timeout_s: float = 100.0,
              retry_timeouts_s: Sequence[float] = ()):
    """Pooled drop-in for ``verify.smt.decide_box_smt``: same
    ``(verdict, ce, reason)`` triple, solver out of process."""
    from fairify_tpu_torch.verify import smt as smt_mod

    query = smt_mod.build_query(net, enc, lo, hi)
    return pool.solve_serialized(
        query, soft_timeout_s=soft_timeout_s,
        retry_timeouts_s=retry_timeouts_s).triple


def submit_box(pool: SmtPool, net, enc, lo, hi,
               soft_timeout_s: float = 100.0,
               retry_timeouts_s: Sequence[float] = ()) -> Future:
    """Async ``solve_box`` (Future[SmtResult]) — the sweep's fan-out API."""
    from fairify_tpu_torch.verify import smt as smt_mod

    query = smt_mod.build_query(net, enc, lo, hi)
    return pool.submit_serialized(query, soft_timeout_s=soft_timeout_s,
                                  retry_timeouts_s=retry_timeouts_s)
