"""SMT worker subprocess: ``python -m fairify_tpu_torch.smt.worker``.

Port of ``fairify_tpu/smt/worker.py``.  One worker owns one native solver
at a time, and NOTHING else — no torch, no CUDA context, no shared state
with the host.  It imports only :mod:`fairify_tpu_torch.smt.protocol`,
:mod:`fairify_tpu_torch.smt.brute` and :mod:`fairify_tpu_torch.obs.trace`
(all free of torch): a process that initialised CUDA maps tens of GB of
virtual address space, so under ``--memory-cap-mb`` a worker that touched
CUDA would die at spawn, and importing torch alone would make each spawn
several times slower.  The host talks framed
JSON over stdin/stdout (:mod:`fairify_tpu_torch.smt.protocol`); everything else
about the worker is disposable by design:

* **RSS cap** — ``--memory-cap-mb`` applies ``RLIMIT_AS`` before the
  first query, so a solver memory blowup lands as a Python
  ``MemoryError`` inside *this* process (reported as a clean ``memout``
  response, then exit) or as a malloc-failure death — either way the
  host's sweep never feels it.
* **hard kills are fine** — the worker holds no files open for write and
  no partial state the host cares about; the pool SIGKILLs on deadline
  and respawns.
* **chaos directives** — ``hang`` (sleep through any deadline) and
  ``memout`` (allocate past the cap) let the fault sites
  ``smt.worker.hang`` / ``smt.worker.memout`` exercise the host's
  containment against a REAL wedged/dying subprocess, not a mock.

Backends: ``z3`` parses the shipped SMT-LIB2 text with the native solver
(soft ``timeout`` + ``random_seed`` set per request — portfolio variants
differ only in seed); ``brute`` is the exact enumeration backend
(:mod:`fairify_tpu_torch.smt.brute`), the default wherever ``z3-solver`` is not
installed; ``auto`` picks z3 when importable.
"""
from __future__ import annotations

import argparse
import sys
import time

from fairify_tpu_torch.obs import trace as trace_mod
from fairify_tpu_torch.smt import brute, protocol

try:  # pragma: no cover - exercised only where z3-solver is installed
    import z3  # type: ignore

    HAVE_Z3 = True
except ImportError:
    z3 = None
    HAVE_Z3 = False


def _respond(obj: dict) -> None:
    sys.stdout.write(protocol.dump_msg(obj))
    sys.stdout.flush()


def _apply_memory_cap(cap_mb: int) -> None:
    if cap_mb <= 0:
        return
    import resource

    cap = int(cap_mb) * 1024 * 1024
    resource.setrlimit(resource.RLIMIT_AS, (cap, cap))


def _solve_z3(query: dict, timeout_s: float, seed: int):
    """(verdict, ce, reason) via the native solver on the shipped script."""
    meta = query["meta"]
    s = z3.Solver()
    s.set("timeout", max(int(timeout_s * 1000), 1))
    try:
        s.set("random_seed", int(seed))
    except z3.Z3Exception:
        pass  # older solvers without the param: seedless, still sound
    s.from_string(query["smtlib"])
    res = s.check()
    if res == z3.sat:
        m = s.model()
        d = int(meta["dims"])

        def val(name):
            return int(m.eval(z3.Int(name), model_completion=True).as_long())

        ce = [[val(f"x{i}") for i in range(d)],
              [val(f"xp{i}") for i in range(d)]]
        return "sat", ce, None
    if res == z3.unsat:
        return "unsat", None, None
    return "unknown", None, protocol.unknown_reason(s.reason_unknown())


def solve_one(req: dict, backend: str, pair_cap: int) -> dict:
    """One solve request → one response dict (never raises).

    The worker's whole contract is "respond or die": any error deciding a
    query — a solver exception, a malformed script, a MemoryError under
    the RSS cap — becomes a sound UNKNOWN response (``memout`` exits
    afterwards: a heap that just failed allocation is not trustworthy for
    the next query).
    """
    qid = req.get("qid")
    t0 = time.perf_counter()
    timeout_s = float(req.get("timeout_s", 60.0))
    try:
        query = req["query"]
        if backend == "z3":
            verdict, ce, reason = _solve_z3(query, timeout_s,
                                            int(req.get("seed", 0)))
        else:
            verdict, ce, reason = brute.solve(
                query["smtlib"], query["meta"], timeout_s=timeout_s,
                pair_cap=pair_cap)
    except MemoryError:
        return {"qid": qid, "verdict": "unknown", "ce": None,
                "reason": "memout", "backend": backend, "exit": True,
                "elapsed_s": time.perf_counter() - t0}
    except BaseException as exc:
        # Respond-or-die: an exception must become a sound UNKNOWN, not a
        # dead pipe the host has to classify as a crash.
        return {"qid": qid, "verdict": "unknown", "ce": None,
                "reason": "solver-error", "error": type(exc).__name__,
                "backend": backend, "elapsed_s": time.perf_counter() - t0}
    return {"qid": qid, "verdict": verdict, "ce": ce, "reason": reason,
            "backend": backend, "elapsed_s": time.perf_counter() - t0}


def _chaos_memout(qid) -> dict:
    """Allocate until the RSS cap kills the allocation (chaos directive)."""
    blocks = []
    try:
        while True:
            blocks.append(bytearray(16 * 1024 * 1024))
    except MemoryError:
        del blocks
        return {"qid": qid, "verdict": "unknown", "ce": None,
                "reason": "memout", "chaos": True, "exit": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "z3", "brute"))
    ap.add_argument("--memory-cap-mb", type=int, default=0)
    ap.add_argument("--pair-cap", type=int, default=brute.DEFAULT_PAIR_CAP)
    ap.add_argument("--trace-dir", default=None,
                    help="shared trace-shard directory: the worker appends "
                         "its solve spans to trace.<pid>.jsonl so the "
                         "merged view shows the host-solver leg of each "
                         "request (obs.trace is stdlib-only — no torch)")
    args = ap.parse_args(argv)
    backend = args.backend
    if backend == "auto":
        backend = "z3" if HAVE_Z3 else "brute"
    if backend == "z3" and not HAVE_Z3:
        _respond({"fatal": "z3-solver is not installed in the worker env"})
        return 2
    _apply_memory_cap(args.memory_cap_mb)
    if args.trace_dir:
        # Hard kills are in this worker's contract: the shard is append-
        # per-record (flushed, no close needed), so a SIGKILL tears at
        # most the final line — same tolerance as every JSONL ledger.
        trace_mod.activate(trace_mod.Tracer(
            trace_mod.shard_path(args.trace_dir), run_id="smt-worker"))
    _respond({"hello": True, "backend": backend,
              "memory_cap_mb": args.memory_cap_mb})
    for line in sys.stdin:
        req = protocol.parse_msg(line)
        if req is None:
            continue  # torn/garbage frame: ignore, stay alive
        op = req.get("op")
        if op == "exit":
            return 0
        if op == "ping":
            _respond({"qid": req.get("qid"), "pong": True})
            continue
        if op == "hang":
            # Chaos directive: wedge like a stuck tactic — ignore the soft
            # deadline entirely; only the host's SIGKILL ends this.
            time.sleep(float(req.get("duration_s", 3600.0)))
            continue
        if op == "memout":
            _respond(_chaos_memout(req.get("qid")))
            return 0
        if op == "solve":
            # The request's trace context rides the solve frame: bind it
            # so the worker's span joins the merged tree, and echo it in
            # the response so the host can assert propagation end-to-end.
            with trace_mod.context(trace_mod.TraceContext.from_fields(req)), \
                    trace_mod.span("smt.worker_solve", qid=req.get("qid"),
                                   backend=backend):
                resp = solve_one(req, backend, args.pair_cap)
            if req.get("trace"):
                resp["trace"] = req["trace"]
            _respond(resp)
            if resp.get("exit"):
                return 0
            continue
        _respond({"qid": req.get("qid"), "verdict": "unknown",
                  "reason": "solver-error", "error": f"unknown op {op!r}"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
