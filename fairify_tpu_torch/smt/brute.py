"""Exact brute-force backend: a tiny decision procedure for the emitted
SMT-LIB subset, solver-free.

Copy of ``fairify_tpu/smt/brute.py`` (stdlib only): the same parser, the
same enumeration order and the same ``DEFAULT_PAIR_CAP``, so its verdicts
and witnesses equal the JAX package's on the same script.

``to_smtlib`` serializes every query over a FINITE integer box, so the
formula is decidable by enumeration: walk the integer assignments the
box/PA/RA constraints admit, evaluate the emitted script's define-funs in
exact :class:`fractions.Fraction` arithmetic (floats are dyadic rationals
— no rounding anywhere), and check every ``assert``.  Any satisfying
assignment is a ground-truth witness; exhausting the space is a
ground-truth UNSAT.

This is NOT a z3 replacement for production grids (a GC partition has
~10^5+ pairs per box and real sweeps hand the pool much bigger boxes) —
``pair_cap`` concedes ``unknown/"solver-error"`` past a fixed enumeration
budget, exactly like a solver conceding incompleteness.  What it buys:

* worker subprocesses give REAL verdicts in environments without
  ``z3-solver`` (this repo's CI), so the pool's containment, parity, and
  throughput contracts are pinned against genuine solving, not mocks;
* a second, independent decision procedure: where z3 IS installed, the
  agreement suite can cross-check both backends against the native
  engine on small boxes.

The evaluator supports exactly the operator set ``to_smtlib`` emits
(mirroring the JAX package's pinned interpreter); an
unsupported operator is a ``solver-error``, never a wrong verdict.
"""
from __future__ import annotations

import time
from fractions import Fraction
from itertools import product
from typing import Dict, List, Optional, Tuple

#: Enumeration budget: queries whose admissible-pair count exceeds this
#: are conceded unknown (deterministically) instead of ground to dust.
DEFAULT_PAIR_CAP = 200_000


def _tokenize(text: str):
    for line in text.splitlines():
        line = line.split(";", 1)[0]
        for tok in line.replace("(", " ( ").replace(")", " ) ").split():
            yield tok


def parse_script(text: str) -> List:
    """All top-level s-expressions of an SMT-LIB script."""
    toks = list(_tokenize(text))
    pos = 0

    def parse():
        nonlocal pos
        tok = toks[pos]
        pos += 1
        if tok == "(":
            items = []
            while toks[pos] != ")":
                items.append(parse())
            pos += 1
            return items
        return tok

    forms = []
    while pos < len(toks):
        forms.append(parse())
    return forms


class UnsupportedForm(ValueError):
    """The script uses a form outside the emitted subset."""


def _ev(e, env: Dict[str, object]):
    if isinstance(e, str):
        if e in env:
            return env[e]
        if e == "true":
            return True
        if e == "false":
            return False
        return Fraction(e)
    op = e[0]
    if op == "+":
        return sum((_ev(a, env) for a in e[1:]), Fraction(0))
    if op == "*":
        r = Fraction(1)
        for a in e[1:]:
            r *= _ev(a, env)
        return r
    if op == "-":
        if len(e) == 2:
            return -_ev(e[1], env)
        return _ev(e[1], env) - _ev(e[2], env)
    if op == "/":
        return _ev(e[1], env) / _ev(e[2], env)
    if op == "to_real":
        return _ev(e[1], env)
    if op == "ite":
        return _ev(e[2], env) if _ev(e[1], env) else _ev(e[3], env)
    if op == ">=":
        return _ev(e[1], env) >= _ev(e[2], env)
    if op == "<=":
        return _ev(e[1], env) <= _ev(e[2], env)
    if op == ">":
        return _ev(e[1], env) > _ev(e[2], env)
    if op == "<":
        return _ev(e[1], env) < _ev(e[2], env)
    if op == "=":
        return _ev(e[1], env) == _ev(e[2], env)
    if op == "distinct":
        return _ev(e[1], env) != _ev(e[2], env)
    if op == "and":
        return all(_ev(a, env) for a in e[1:])
    if op == "or":
        return any(_ev(a, env) for a in e[1:])
    if op == "not":
        return not _ev(e[1], env)
    if op == "let":
        inner = dict(env)
        for name, expr in e[1]:
            inner[name] = _ev(expr, env)
        return _ev(e[2], inner)
    raise UnsupportedForm(f"unhandled op {op!r}")


def _pair_count(meta: dict) -> int:
    """Admissible (x, x') assignments under the box/PA/RA constraints."""
    lo, hi = meta["lo"], meta["hi"]
    pa, ra, eps = set(meta["pa"]), set(meta["ra"]), int(meta["eps"])
    n = 1
    for i in range(len(lo)):
        size = int(hi[i]) - int(lo[i]) + 1
        n *= size
        if i in pa:
            n *= max(size - 1, 0)
        elif i in ra:
            n *= 2 * eps + 1
    return n


def _partner_choices(meta: dict) -> List[Tuple[int, str]]:
    """Per-dim partner rule: ('pa'|'ra'|'eq') in dim order."""
    pa, ra = set(meta["pa"]), set(meta["ra"])
    out = []
    for i in range(len(meta["lo"])):
        out.append((i, "pa" if i in pa else ("ra" if i in ra else "eq")))
    return out


def solve(smtlib: str, meta: dict, timeout_s: float = 60.0,
          pair_cap: int = DEFAULT_PAIR_CAP):
    """Decide one emitted script by exact enumeration.

    Returns ``(verdict, ce, reason)`` with the same contract as
    :func:`verify.smt.decide_box_smt`: ``ce`` is an int-list pair for
    ``sat``; ``reason`` is ``None`` / ``"timeout"`` / ``"solver-error"``.
    """
    lo = [int(v) for v in meta["lo"]]
    hi = [int(v) for v in meta["hi"]]
    eps = int(meta["eps"])
    d = len(lo)
    if _pair_count(meta) > pair_cap:
        return "unknown", None, "solver-error"
    try:
        forms = parse_script(smtlib)
    except (IndexError, ValueError):
        return "unknown", None, "solver-error"
    defs = [f for f in forms if f and f[0] == "define-fun"]
    asserts = [f[1] for f in forms if f and f[0] == "assert"]
    # Split the straight-line network into its two role halves: a_* funs
    # read only x-vars, b_* only xp-vars — evaluating the x half once per
    # x instead of once per pair is the whole enumeration speedup.
    a_defs = [f for f in defs if f[1].startswith("a_")]
    b_defs = [f for f in defs if f[1].startswith("b_")]
    other = [f for f in defs if not (f[1].startswith(("a_", "b_")))]
    if other:
        return "unknown", None, "solver-error"
    rules = _partner_choices(meta)
    deadline = time.monotonic() + max(float(timeout_s), 1e-3)
    checked = 0
    try:
        for x in product(*(range(lo[i], hi[i] + 1) for i in range(d))):
            env_x: Dict[str, object] = {f"x{i}": Fraction(x[i])
                                        for i in range(d)}
            for f in a_defs:
                env_x[f[1]] = _ev(f[4], env_x)
            partner_axes = []
            for i, kind in rules:
                if kind == "pa":
                    partner_axes.append([v for v in range(lo[i], hi[i] + 1)
                                         if v != x[i]])
                elif kind == "ra":
                    # x' is NOT box-constrained on RA dims (the emitted
                    # formula drops that constraint, like the reference).
                    partner_axes.append(list(range(x[i] - eps,
                                                   x[i] + eps + 1)))
                else:
                    partner_axes.append([x[i]])
            for xp in product(*partner_axes):
                checked += 1
                if checked % 512 == 0 and time.monotonic() > deadline:
                    return "unknown", None, "timeout"
                env = dict(env_x)
                env.update({f"xp{i}": Fraction(xp[i]) for i in range(d)})
                for f in b_defs:
                    env[f[1]] = _ev(f[4], env)
                if all(_ev(a, env) for a in asserts):
                    return "sat", [list(map(int, x)), list(map(int, xp))], None
    except UnsupportedForm:
        return "unknown", None, "solver-error"
    return "unsat", None, None
