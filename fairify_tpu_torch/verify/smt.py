"""SMT encodings of the pair property: SMT-LIB2 export + gated Z3 backend.

Port of ``fairify_tpu/verify/smt.py``.  The reference's decision procedure
is a Z3 query over the pruned network (``src/GC/Verify-GC.py:128-214``).
``z3-solver`` is not part of this environment, so the module has two
faces:

* :func:`to_smtlib` — a pure-Python SMT-LIB2 emitter (exact dyadic-rational
  weight literals, QF_LIRA) that needs no solver; its text is the JAX
  package's byte for byte on the same net and box (the header comment
  included), and :func:`build_query` wraps it for the worker pool
  (:mod:`fairify_tpu_torch.smt`), whose brute backend decides it exactly.
* :func:`decide_box_smt` — a live in-process Z3 second opinion, import-gated
  on :data:`HAVE_Z3` exactly as in the JAX package: without ``z3-solver``
  it raises the same ``RuntimeError``.

Everything here runs on the host, on the numpy parameters of the net
(:func:`fairify_tpu_torch.models.mlp.excise`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

try:  # pragma: no cover - exercised only where z3-solver is installed
    import z3  # type: ignore

    HAVE_Z3 = True
except ImportError:
    z3 = None
    HAVE_Z3 = False

from fairify_tpu_torch import obs
from fairify_tpu_torch.models.mlp import MLP, excise
from fairify_tpu_torch.verify.property import PairEncoding


def _require_z3():
    if not HAVE_Z3:
        raise RuntimeError("z3-solver is not installed; use the native engine "
                           "(fairify_tpu_torch.verify.engine.decide_box)")


def _z3_net(x, weights, biases):
    """Depth-generic symbolic forward: ToReal input, ReLU hidden, linear out
    (one encoder replaces the reference's 53 per-model files).

    Weight literals are built with :class:`fractions.Fraction` so z3 reasons
    about the *exact dyadic value* of each f32 weight — the same formula
    :func:`to_smtlib` exports (feeding raw Python floats would let z3 coerce
    via decimal repr, e.g. 0.1 → 1/10, a different network).
    """
    from fractions import Fraction

    h = [z3.ToReal(v) if isinstance(v, z3.ArithRef) and v.is_int() else v for v in x]
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        w = np.asarray(w, dtype=np.float64)
        bb = np.asarray(b, dtype=np.float64)
        z = [
            sum(z3.RealVal(Fraction(float(w[t, j]))) * h[t]
                for t in range(w.shape[0])) + z3.RealVal(Fraction(float(bb[j])))
            for j in range(w.shape[1])
        ]
        h = z if i == n - 1 else [z3.If(v >= 0, v, 0) for v in z]
    return h[0]


def _unknown_reason(reason_str: str) -> str:
    """Map z3's ``reason_unknown`` to the degradation taxonomy's codes.

    ``timeout`` (budget ran out — escalating the timeout may decide it),
    ``memout`` (memory/resource exhaustion — re-running at a BIGGER time
    budget only OOMs harder, so the escalation ladder must skip it; the
    worker pool instead retries once on a higher-RSS-cap worker), or
    ``solver-error`` (the query itself defeated the solver — more time
    rarely helps).  All are sound: UNKNOWN is always a legal answer.
    """
    from fairify_tpu_torch.smt import protocol as smt_protocol

    return smt_protocol.unknown_reason(reason_str)


def decide_box_smt(
    net: MLP,
    enc: PairEncoding,
    lo: np.ndarray,
    hi: np.ndarray,
    soft_timeout_s: float = 100.0,
    retry_timeouts_s: Tuple[float, ...] = (),
) -> Tuple[str, Optional[Tuple[np.ndarray, np.ndarray]], Optional[str]]:
    """Z3 verdict for one partition box (masked net is excised first).

    Returns ``(verdict, counterexample, reason)``: ``reason`` is ``None``
    for decided verdicts and a machine-readable code for UNKNOWN —
    ``"timeout"`` / ``"solver-error"`` (a deterministic solver failure) /
    ``"transient"`` (a retryable runtime fault exhausted the ladder) /
    ``"injected"``.  Z3 exceptions are
    mapped to UNKNOWN instead of propagating (the reference's soundness
    contract: a partition may be answered UNKNOWN but never wrongly, and
    never crash the sweep, ``src/GC/Verify-GC.py:225-254``).

    ``retry_timeouts_s`` is the escalating-timeout ladder for the
    UNKNOWN-retry path (``SweepConfig.smt_retry_timeouts_s``): each entry
    re-checks the same solver state with a larger per-attempt budget, so
    a timeout at 100 s can fall upward to 300 s / 900 s before the box is
    finally conceded as UNKNOWN.
    """
    _require_z3()
    weights, biases = excise(net).numpy_params()
    d = len(lo)
    x = [z3.Int(f"x{i}") for i in range(d)]
    xp = [z3.Int(f"x_{i}") for i in range(d)]
    s = z3.Solver()

    pa = set(int(i) for i in enc.pa_idx)
    ra = set(int(i) for i in enc.ra_idx)
    for i in range(d):
        s.add(x[i] >= int(lo[i]), x[i] <= int(hi[i]))
        if i in pa:
            s.add(xp[i] >= int(lo[i]), xp[i] <= int(hi[i]))
            s.add(x[i] != xp[i])
        elif i in ra:
            diff = x[i] - xp[i]
            s.add(z3.If(diff >= 0, diff, -diff) <= enc.eps)
        else:
            s.add(x[i] == xp[i])
    y = _z3_net(x, weights, biases)
    yp = _z3_net(xp, weights, biases)
    s.add(z3.Or(z3.And(y < 0, yp > 0), z3.And(y > 0, yp < 0)))

    reason: Optional[str] = None
    for attempt, t in enumerate((soft_timeout_s,) + tuple(retry_timeouts_s)):
        s.set("timeout", int(t * 1000))
        with obs.span("smt.z3_query", timeout_s=t, dims=d,
                      attempt=attempt) as sp:
            try:
                from fairify_tpu_torch.resilience import faults

                faults.check("smt.query")
                res = s.check()
            except BaseException as exc:
                from fairify_tpu_torch.resilience.faults import InjectedFault
                from fairify_tpu_torch.resilience.supervisor import classify

                cls = classify(exc)
                if cls == "propagate":
                    raise
                reason = "injected" if isinstance(exc, InjectedFault) \
                    else ("transient" if cls == "transient"
                          else "solver-error")
                sp.set(verdict="unknown", reason=reason,
                       error=type(exc).__name__)
                obs.registry().counter("smt_queries").inc(verdict="unknown",
                                                          reason=reason)
                if cls == "transient":
                    continue  # plausibly succeeds at the next tier
                break  # a deterministic solver error repeats at any budget
            if res == z3.sat:
                verdict = "sat"
                m = s.model()

                def val(v):
                    return int(m.eval(v, model_completion=True).as_long())

                ce = (np.array([val(v) for v in x], dtype=np.int64),
                      np.array([val(v) for v in xp], dtype=np.int64))
            elif res == z3.unsat:
                verdict, ce = "unsat", None
            else:
                verdict, ce = "unknown", None
                reason = _unknown_reason(s.reason_unknown())
            sp.set(verdict=verdict, **({"reason": reason}
                                       if verdict == "unknown" else {}))
        if verdict == "unknown":
            obs.registry().counter("smt_queries").inc(verdict="unknown",
                                                      reason=reason)
            if reason == "timeout":
                continue  # escalate to the next timeout tier
            break  # solver-error/memout: more time never helps (a memout
            # re-run at a bigger budget only OOMs harder — the pool's
            # higher-RSS-cap retry is the sanctioned second attempt)
        obs.registry().counter("smt_queries").inc(verdict=verdict)
        return verdict, ce, None
    return "unknown", None, reason


def build_query(net: MLP, enc: PairEncoding, lo: np.ndarray, hi: np.ndarray,
                name: str = "partition") -> dict:
    """Wire-format query for the out-of-process worker pool
    (:mod:`fairify_tpu_torch.smt`): the :func:`to_smtlib` serialization plus the
    box/property metadata a backend needs to bound enumeration and to name
    the witness variables (``x{i}``/``xp{i}``) when extracting a model.

    This is the ONLY serialization the pool ships to workers — a worker
    never receives Python objects, so a solver crash can corrupt nothing
    but its own process.
    """
    return {
        "smtlib": to_smtlib(net, enc, lo, hi, name=name),
        "meta": {
            "dims": int(len(lo)),
            "lo": [int(v) for v in lo],
            "hi": [int(v) for v in hi],
            "pa": [int(i) for i in enc.pa_idx],
            "ra": [int(i) for i in enc.ra_idx],
            "eps": int(enc.eps),
            "name": name,
        },
    }


# ---------------------------------------------------------------------------
# SMT-LIB2 export (no solver required)
# ---------------------------------------------------------------------------


def _rat(v: float) -> str:
    """Exact SMT-LIB Real literal for a float (floats are dyadic rationals)."""
    from fractions import Fraction

    f = Fraction(float(v))
    if f.denominator == 1:
        body = f"{abs(f.numerator)}.0"
    else:
        body = f"(/ {abs(f.numerator)} {f.denominator})"
    return body if f >= 0 else f"(- {body})"


def to_smtlib(net: MLP, enc: PairEncoding, lo: np.ndarray, hi: np.ndarray,
              name: str = "partition", get_model: bool = False) -> str:
    """SMT-LIB2 script deciding the pair property on one partition box.

    Semantics match :mod:`fairify_tpu_torch.verify.property` (and the reference's
    constraint builders, ``utils/verif_utils.py:631-945``): integer points;
    every PA differs and both are box-constrained on PA dims; RA dims obey
    ``|x_i − x'_i| ≤ ε`` with x' *not* box-constrained (the reference
    comments that constraint out); all other dims equal; violation = strict
    logit sign flip.  Weights enter as exact dyadic rationals, so ``sat`` /
    ``unsat`` from any sound solver is ground truth for the f32 network —
    the same quantity the native engine's exact leaf checks reason about.
    """
    weights, biases = excise(net).numpy_params()
    d = len(lo)
    pa = set(int(i) for i in enc.pa_idx)
    ra = set(int(i) for i in enc.ra_idx)
    # Strict SMT-LIB ordering: options precede set-logic; (get-model) is
    # only legal after a sat answer, so it is opt-in (expected-sat exports).
    out = [f"; fairify_tpu pair property — {name}"]
    if get_model:
        out.append("(set-option :produce-models true)")
    out.append("(set-logic QF_LIRA)")
    for i in range(d):
        out.append(f"(declare-const x{i} Int)")
        out.append(f"(declare-const xp{i} Int)")
    for i in range(d):
        out.append(f"(assert (and (>= x{i} {int(lo[i])}) (<= x{i} {int(hi[i])})))")
        if i in pa:
            out.append(
                f"(assert (and (>= xp{i} {int(lo[i])}) (<= xp{i} {int(hi[i])})))")
            out.append(f"(assert (distinct x{i} xp{i}))")
        elif i in ra and enc.eps:
            out.append(f"(assert (let ((dd (- x{i} xp{i})))"
                       f" (<= (ite (>= dd 0) dd (- dd)) {int(enc.eps)})))")
        else:
            out.append(f"(assert (= xp{i} x{i}))")

    def emit_net(prefix: str, var: str):
        prev = [f"(to_real {var}{i})" for i in range(d)]
        n = len(weights)
        for li, (w, b) in enumerate(zip(weights, biases)):
            cur = []
            for j in range(w.shape[1]):
                terms = [f"(* {_rat(w[t, j])} {prev[t]})" for t in range(w.shape[0])]
                terms.append(_rat(b[j]))
                z = f"(+ {' '.join(terms)})" if len(terms) > 1 else terms[0]
                zname = f"{prefix}z{li}_{j}"
                out.append(f"(define-fun {zname} () Real {z})")
                if li < n - 1:
                    hname = f"{prefix}h{li}_{j}"
                    out.append(f"(define-fun {hname} () Real"
                               f" (ite (>= {zname} 0.0) {zname} 0.0))")
                    cur.append(hname)
                else:
                    cur.append(zname)
            prev = cur
        return prev[0]

    y = emit_net("a_", "x")
    yp = emit_net("b_", "xp")
    out.append(f"(assert (or (and (< {y} 0.0) (> {yp} 0.0))"
               f" (and (> {y} 0.0) (< {yp} 0.0))))")
    out.append("(check-sat)")
    if get_model:
        out.append("(get-model)")
    return "\n".join(out) + "\n"
