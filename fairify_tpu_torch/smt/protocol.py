"""Wire protocol between the SMT pool and its worker subprocesses.

Copy of ``fairify_tpu/smt/protocol.py`` (stdlib only), so the frames the
pool and the worker exchange are the JAX package's byte for byte.

One JSON object per line over the worker's stdin/stdout pipes — the same
torn-line-tolerant framing the JSONL ledgers use, chosen for the same
reason: a SIGKILLed worker can leave at most one truncated line, and the
host treats any undecodable/short read as a worker death (contained), not
a protocol error (crash).

Requests (host → worker), discriminated by ``op``:

* ``solve`` — ``{"op": "solve", "qid": n, "timeout_s": t, "seed": s,
  "query": {"smtlib": ..., "meta": {...}}}``; the query payload is
  :func:`fairify_tpu_torch.verify.smt.build_query`'s output, i.e. the SMT-LIB2
  serialization is the ONLY thing that crosses the process boundary.
* ``hang`` / ``memout`` — chaos directives (driven by the
  ``smt.worker.hang`` / ``smt.worker.memout`` fault sites): wedge the
  worker past any deadline / allocate past the RSS cap, so the host's
  containment paths are exercised against a REAL stuck/dying subprocess.
* ``ping`` — liveness probe; ``exit`` — orderly shutdown.

Responses (worker → host): ``{"qid": n, "verdict": "sat"|"unsat"|
"unknown", "ce": [[...],[...]]|null, "reason": null|"timeout"|"memout"|
"solver-error", "elapsed_s": t, "backend": "z3"|"brute"}``.  ``reason``
uses the same taxonomy as :func:`verify.smt._unknown_reason`; the
worker-death reasons (``smt.worker:*``) are assigned by the HOST — a dead
worker by definition cannot report its own cause of death.
"""
from __future__ import annotations

import json
from typing import Optional

#: Machine-readable degradation reasons the pool assigns when a worker
#: dies (a worker cannot report these itself).  They share the namespace
#: of `ChunkFailure.reason` (site:kind) so the report's degradation
#: table and the resume machinery treat them like any other fault.
REASON_CRASH = "smt.worker:crash"
REASON_HANG = "smt.worker:hang"
REASON_MEMOUT = "smt.worker:memout"
REASON_SPAWN = "smt.worker:spawn"

#: Reasons that must SKIP the escalating-timeout ladder: re-running the
#: query at a bigger time budget cannot help (memory exhaustion only OOMs
#: harder; a deterministic solver error repeats at any budget).
NO_ESCALATE_REASONS = frozenset(
    {"memout", "solver-error", REASON_MEMOUT})


def unknown_reason(reason_str: str) -> str:
    """Map a solver's ``reason_unknown`` text to the degradation taxonomy.

    Single source of truth shared by the in-process backend
    (:func:`verify.smt._unknown_reason` delegates here) and the worker —
    kept stdlib-only so worker startup never imports torch.
    ``memout`` is distinct from ``timeout``: re-running a memory-exhausted
    query at a bigger TIME budget only OOMs harder, so the escalation
    ladder must skip it (the pool's higher-RSS-cap retry is the sanctioned
    second attempt).
    """
    r = (reason_str or "").lower()
    if "memout" in r or "memory" in r or "resource" in r:
        return "memout"
    if "timeout" in r or "canceled" in r:
        return "timeout"
    return "solver-error"


def dump_msg(obj: dict) -> str:
    """One framed message (newline-terminated single-line JSON)."""
    return json.dumps(obj, separators=(",", ":")) + "\n"


def parse_msg(line: str) -> Optional[dict]:
    """Decode one framed line; None for torn/empty/undecodable input."""
    line = line.strip()
    if not line:
        return None
    try:
        obj = json.loads(line)
    except json.JSONDecodeError:
        return None
    return obj if isinstance(obj, dict) else None


def solve_request(qid: int, query: dict, timeout_s: float,
                  seed: int = 0, trace: Optional[dict] = None) -> dict:
    """One solve frame; ``trace`` is the distributed-trace context
    (``{"id": ..., "span": ...}``) the worker echoes back in its response
    and binds around its own spans — how a host-solver leg joins the
    request's merged trace tree."""
    req = {"op": "solve", "qid": int(qid), "timeout_s": float(timeout_s),
           "seed": int(seed), "query": query}
    if trace:
        req["trace"] = dict(trace)
    return req


def result_ce(resp: dict):
    """Counterexample pair from a response (None when absent)."""
    import numpy as np

    ce = resp.get("ce")
    if not ce:
        return None
    return (np.asarray(ce[0], dtype=np.int64),
            np.asarray(ce[1], dtype=np.int64))
