"""Independent exact confirmation of UNSAT verdicts — no solver dependency.

Copy of ``fairify_tpu/verify/exact_check.py`` (``Fraction``, numpy and
scipy only).  A **complete, exact-rational-arithmetic check** of the pair
property over a partition box, sharing *no code or numerics* with the
engine that produced the certificates (no CROWN, no f32, no HiGHS):

* all arithmetic is ``fractions.Fraction`` over the exact dyadic values of
  the f32 weights — the semantics an SMT solver would use;
* ReLU phase patterns are enumerated depth-first; interval bounds with the
  fixed phases (computed in exact rationals) prune dead directions;
* a fully-fixed pattern's region is a rational polyhedron; feasibility of
  {region ∧ f_a ≥ 0 ∧ f_b ≤ 0} is decided by an exact phase-1 simplex
  (Bland's rule — terminating, no tolerances).

Semantics: the check runs over the **continuous** box, a superset of the
integer lattice the property quantifies over, so

* every direction infeasible      → UNSAT **confirmed** (exact, continuous
  ⇒ lattice);
* a feasible point whose rounding validates as an exact lattice flip
  → the certificate is **refuted**;
* a feasible region with no lattice witness found → **inconclusive** (the
  flip slab may contain no integer point — consistent with lattice-UNSAT,
  but this checker cannot confirm it).

The sweep's sampled integrity recheck (``verify.sweep._sampled_recheck``)
escalates the first certified partition of each rechecked chunk here
(:func:`decide_pair_box_exact`).  Z3 in the reference
(``src/GC/Verify-GC.py:145-214``) is the decision procedure this module
stands in for.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np

ZERO = Fraction(0)


# ---------------------------------------------------------------------------
# Exact phase-1 simplex (feasibility of A·x ≤ b over box-bounded x)
# ---------------------------------------------------------------------------


def _feasible(A: List[List[Fraction]], b: List[Fraction],
              lo: List[Fraction], hi: List[Fraction]):
    """Exact feasibility of {lo ≤ x ≤ hi, A·x ≤ b}.

    Returns ``('feasible', point)``, ``('infeasible', None)`` — proven by a
    phase-1 optimum with positive artificials — or ``('unknown', None)``
    when the pivot cap was hit before optimality: budget exhaustion must
    never masquerade as a proof of emptiness.

    Shifts to y = x − lo ≥ 0, folds upper bounds into rows, adds slacks and
    artificials, and runs phase-1 simplex with Bland's anti-cycling rule on
    a dense Fraction tableau.  Small systems only (tens of vars/rows) — the
    audit's polyhedra, not a general-purpose LP.
    """
    n = len(lo)
    rows: List[List[Fraction]] = []
    rhs: List[Fraction] = []
    for Ai, bi in zip(A, b):
        rows.append(list(Ai))
        rhs.append(bi - sum(a * l for a, l in zip(Ai, lo)))
    for j in range(n):
        if hi[j] == lo[j]:
            continue  # width-0 dims are constants; y_j ≤ 0 via hi row below
        r = [ZERO] * n
        r[j] = Fraction(1)
        rows.append(r)
        rhs.append(hi[j] - lo[j])
    for j in range(n):
        if hi[j] == lo[j]:
            r = [ZERO] * n
            r[j] = Fraction(1)
            rows.append(r)
            rhs.append(ZERO)  # y_j ≤ 0 and y_j ≥ 0 (nonneg) pin it

    m = len(rows)
    # Normalize to rhs ≥ 0 by multiplying rows by −1 (turns ≤ into ≥; such
    # rows get a surplus −1 and an artificial +1, others a slack +1).
    n_slack = m
    tab = []
    art_cols = []
    total = n + n_slack + m  # worst case one artificial per row
    n_art = 0
    for i in range(m):
        row = list(rows[i])
        r = rhs[i]
        if r < 0:
            row = [-a for a in row]
            r = -r
            slack = Fraction(-1)
        else:
            slack = Fraction(1)
        line = row + [ZERO] * n_slack + [ZERO] * m
        line[n + i] = slack
        if slack < 0:
            line[n + n_slack + n_art] = Fraction(1)
            art_cols.append(n + n_slack + n_art)
            basis_col = n + n_slack + n_art
            n_art += 1
        else:
            basis_col = n + i
        tab.append((line, r, basis_col))

    ncols = n + n_slack + n_art
    T = [line[:ncols] + [r] for (line, r, _) in tab]
    basis = [bc for (_, _, bc) in tab]
    art_set = set(art_cols)
    if not art_set:
        # Origin y=0 is feasible for all rows (rhs ≥ 0 with + slacks).
        return "feasible", [lo[j] for j in range(n)]

    # Phase-1 objective: minimize sum of artificials.
    cost = [ZERO] * (ncols + 1)
    for i, bcol in enumerate(basis):
        if bcol in art_set:
            for k in range(ncols + 1):
                cost[k] += T[i][k]

    max_pivots = 200 * (ncols + 1)
    proven_optimal = False
    for _ in range(max_pivots):
        enter = -1
        for j in range(ncols):
            if j not in art_set and cost[j] > 0:
                enter = j  # Bland: smallest index with positive reduced cost
                break
        if enter < 0:
            proven_optimal = True
            break
        leave, best = -1, None
        for i in range(len(T)):
            if T[i][enter] > 0:
                ratio = T[i][ncols] / T[i][enter]
                if best is None or ratio < best or (
                        ratio == best and basis[i] < basis[leave]):
                    best, leave = ratio, i
        if leave < 0:
            break  # unbounded phase-1 direction (cannot happen; bail safe)
        piv = T[leave][enter]
        T[leave] = [v / piv for v in T[leave]]
        for i in range(len(T)):
            if i != leave and T[i][enter] != 0:
                f = T[i][enter]
                T[i] = [a - f * b2 for a, b2 in zip(T[i], T[leave])]
        f = cost[enter]
        if f != 0:
            cost = [a - f * b2 for a, b2 in zip(cost, T[leave])]
        basis[leave] = enter

    art_total = sum((T[i][ncols] if basis[i] in art_set else ZERO)
                    for i in range(len(T)))
    if art_total != 0:
        # Artificials positive: proof of emptiness ONLY at phase-1 optimum.
        return ("infeasible" if proven_optimal else "unknown"), None
    y = [ZERO] * ncols
    for i, bcol in enumerate(basis):
        y[bcol] = T[i][ncols]
    return "feasible", [y[j] + lo[j] for j in range(n)]


# ---------------------------------------------------------------------------
# Exact network forms
# ---------------------------------------------------------------------------


def _frac_weights(weights, biases):
    """f32 weights/biases as exact Fractions (f32 values are dyadic)."""
    W = [[[Fraction(float(w[i, j])) for j in range(w.shape[1])]
          for i in range(w.shape[0])] for w in (np.asarray(x, np.float64) for x in weights)]
    B = [[Fraction(float(b[j])) for j in range(b.shape[0])]
         for b in (np.asarray(x, np.float64) for x in biases)]
    return W, B


@dataclass
class _Tower:
    """One role's affine view: input map x = M·s + t (s = shared vars)."""
    M: List[List[Fraction]]  # (n_vars → in_dim)
    t: List[Fraction]


def _interval_forward(W, B, tower: _Tower, phases: List[List[int]],
                      s_lo: List[Fraction], s_hi: List[Fraction]):
    """Exact interval bounds through fixed/auto ReLU phases.

    Returns ``(ok, unstable, out_iv, pre_bounds)``: ``ok=False`` when a
    forced phase contradicts the interval (empty region); ``unstable`` =
    first (layer, neuron) unstable-unfixed or None; ``out_iv`` = (lb, ub)
    of the logit; ``pre_bounds`` = per hidden layer (lb, ub) pairs feeding
    the CROWN backward pass.
    """
    nh = len(W) - 1
    iv = []
    for i in range(len(tower.M)):
        lbv = tower.t[i] + sum((a * (s_lo[k] if a > 0 else s_hi[k]))
                               for k, a in enumerate(tower.M[i]))
        ubv = tower.t[i] + sum((a * (s_hi[k] if a > 0 else s_lo[k]))
                               for k, a in enumerate(tower.M[i]))
        iv.append((lbv, ubv))
    pre_bounds: List[List[Tuple[Fraction, Fraction]]] = []
    unstable_first = None
    for k in range(len(W)):
        niv = []
        for j in range(len(B[k])):
            lb2 = B[k][j] + sum(
                W[k][i][j] * (ivl if W[k][i][j] > 0 else ivu)
                for i, (ivl, ivu) in enumerate(iv))
            ub2 = B[k][j] + sum(
                W[k][i][j] * (ivu if W[k][i][j] > 0 else ivl)
                for i, (ivl, ivu) in enumerate(iv))
            niv.append((lb2, ub2))
        if k == nh:
            return True, unstable_first, niv[0], pre_bounds
        pre_bounds.append(niv)
        piv = []
        for j in range(len(B[k])):
            ph = phases[k][j]
            lbj, ubj = niv[j]
            if ph == 0 and lbj >= 0:
                ph = 1  # provably active over the node's box superset
            if ph == 0 and ubj <= 0:
                ph = -1  # provably inactive
            if ph == 1:
                if ubj < 0:
                    return False, None, None, pre_bounds
                piv.append((max(lbj, ZERO), max(ubj, ZERO)))
            elif ph == -1:
                if lbj > 0:
                    return False, None, None, pre_bounds
                piv.append((ZERO, ZERO))
            else:
                if unstable_first is None:
                    unstable_first = (k, j)
                piv.append((ZERO, max(ubj, ZERO)))
        iv = piv
    raise AssertionError("unreachable")


def _crown_out_form(W, B, tower: _Tower, phases, s_lo, s_hi,
                    pre_bounds, upper: bool):
    """Exact-rational CROWN linear form of the output logit over s.

    One backward pass with the triangle upper / adaptive lower ReLU
    relaxations, phase-fixed neurons crossed exactly — the rational twin of
    ``ops.crown`` used purely for DFS pruning (the audit's *decisions* come
    from the exact leaf LPs; a loose bound here costs nodes, never
    soundness).  Returns ``(gs, const)`` with f ≤ gs·s + const over the
    region when ``upper``, else f ≥ gs·s + const.  Keeping the *form*
    (not just the concretized bound) lets the caller bound the tied pair
    difference f_a − f_b with the shared coefficients cancelling — the
    exact twin of the engine's decisive stage-0 certificate
    (``engine._tied_diff_ub``).  ``pre_bounds``: per hidden layer (lb, ub)
    from the interval pass with the same phases.
    """
    nh = len(W) - 1
    sgn = Fraction(1) if upper else Fraction(-1)
    g = [sgn * W[nh][i][0] for i in range(len(W[nh]))]
    const = sgn * B[nh][0]
    for k in range(nh - 1, -1, -1):
        ng = []
        for j, gj in enumerate(g):
            if gj == 0:
                ng.append(ZERO)
                continue
            lb, ub = pre_bounds[k][j]
            ph = phases[k][j]
            if ph == 0 and lb >= 0:
                ph = 1
            if ph == 0 and ub <= 0:
                ph = -1
            if ph == 1:
                ng.append(gj)  # h = z exactly
            elif ph == -1:
                ng.append(ZERO)  # h = 0
            elif gj > 0:
                # Need h's upper relaxation: h ≤ s·(z − l).
                s = ub / (ub - lb)
                ng.append(gj * s)
                const += gj * (-s * lb)
            else:
                # Need h's lower relaxation: h ≥ α·z, α ∈ {0, 1} adaptive.
                alpha = Fraction(1) if ub > -lb else ZERO
                ng.append(gj * alpha)
        n_in = len(W[k])
        g = [sum(W[k][i][j] * ng[j] for j in range(len(ng))) for i in range(n_in)]
        const += sum(B[k][j] * ng[j] for j in range(len(ng)))
    nv = len(s_lo)
    gs = [sum(g[i] * tower.M[i][v] for i in range(len(g))) for v in range(nv)]
    const += sum(g[i] * tower.t[i] for i in range(len(g)))
    if not upper:
        gs = [-a for a in gs]
        const = -const
    return gs, const


def _concretize_ub(gs, const, s_lo, s_hi) -> Fraction:
    """sup of gs·s + const over the box."""
    return const + sum((a * (s_hi[v] if a > 0 else s_lo[v]))
                       for v, a in enumerate(gs))


def _exact_logit_sign_frac(W, B, x: Sequence[int]) -> int:
    """Exact sign of the logit at an integer point (pure Fractions)."""
    h = [Fraction(int(v)) for v in x]
    nh = len(W) - 1
    for k in range(len(W)):
        z = [B[k][j] + sum(W[k][i][j] * h[i] for i in range(len(h)))
             for j in range(len(B[k]))]
        if k < nh:
            h = [v if v > 0 else ZERO for v in z]
        else:
            v = z[0]
            return 0 if v == 0 else (1 if v > 0 else -1)
    raise AssertionError


def decide_pair_box_exact(
    weights, biases, enc, lo, hi, max_nodes: int = 60000,
) -> dict:
    """Exact, lattice-complete check of the pair property for one partition.

    The independent twin of the engine's input-split BaB, in exact
    rationals: recursively split the box; at each sub-box kill flip
    directions with exact-CROWN role bounds and the exact tied-difference
    bound (shared coefficients cancelling, ``engine._tied_diff_ub``'s
    rational twin); a box whose splittable dims have all collapsed is a
    lattice *point* — its finitely many assignment/δ pairs are evaluated in
    exact arithmetic.  No phase branching, no continuous relaxation at the
    leaves, hence no 'inconclusive': verdicts are 'unsat_confirmed',
    'refuted' (with an exact lattice witness), or 'budget'.

    ``enc`` is a :class:`fairify_tpu_torch.verify.property.PairEncoding`.
    """
    W, B = _frac_weights(weights, biases)
    d = len(lo)
    pa_idx = list(enc.pa_idx)
    ra_idx = list(enc.ra_idx)
    eps = int(enc.eps)
    n_ra = len(ra_idx) if eps else 0
    npa = len(pa_idx)

    # Variable layout (free-PA form, used for every V): s = all d dims
    # (PA slots carry role a's value) + RA deltas + role b's PA values.
    nv = d + n_ra + npa
    base_lo = [Fraction(int(v)) for v in lo] + [Fraction(-eps)] * n_ra \
        + [Fraction(int(lo[i])) for i in pa_idx]
    base_hi = [Fraction(int(v)) for v in hi] + [Fraction(eps)] * n_ra \
        + [Fraction(int(hi[i])) for i in pa_idx]

    def tower(role_b: bool) -> _Tower:
        M = [[ZERO] * nv for _ in range(d)]
        t = [ZERO] * d
        for i in range(d):
            if i in pa_idx:
                M[i][(d + n_ra + pa_idx.index(i)) if role_b else i] = Fraction(1)
            else:
                M[i][i] = Fraction(1)
                if role_b and eps and i in ra_idx:
                    M[i][d + ra_idx.index(i)] = Fraction(1)
        return _Tower(M, t)

    ta, tb = tower(False), tower(True)
    zero_phases = [[0] * len(b) for b in B[:-1]]
    split_vars = [i for i in range(d)] + list(range(d + n_ra, nv))
    wnp = [np.asarray(w) for w in weights]
    bnp = [np.asarray(bb) for bb in biases]
    deltas = None
    if n_ra:
        import itertools as it

        deltas = list(it.product(range(-eps, eps + 1), repeat=n_ra))

    def leaf_point(s_lo):
        """All splittable dims collapsed: decide the lattice point exactly."""
        shared = [int(s_lo[i]) for i in range(d)]
        pa_a = [int(s_lo[i]) for i in pa_idx]
        pa_b = [int(s_lo[d + n_ra + k]) for k in range(npa)]
        # valid_pair semantics: EVERY PA attribute must differ
        # (property.encode builds the conjunction of neq per coordinate).
        if any(pa_a[k] == pa_b[k] for k in range(npa)):
            return None
        x = np.array(shared, dtype=np.int64)
        xp = np.array(shared, dtype=np.int64)
        for k, i in enumerate(pa_idx):
            x[i] = pa_a[k]
            xp[i] = pa_b[k]
        sx = _exact_logit_sign_frac(W, B, x)
        if sx == 0:
            return None
        for dl in (deltas or [()]):
            xq = xp.copy()
            for k, dv in enumerate(dl):
                xq[ra_idx[k]] += dv
            sp = _exact_logit_sign_frac(W, B, xq)
            if (sx > 0 and sp < 0) or (sx < 0 and sp > 0):
                return x, xq
        return None

    budget = {"n": 0}

    def sweep(pos_t, neg_t):
        """Input-split sweep for one flip direction: f_pos > 0 ∧ f_neg < 0.

        Returns ('refuted', witness) | ('unsat', None) | ('budget', None).
        """
        stack = [(base_lo, base_hi)]
        while stack:
            if budget["n"] >= max_nodes:
                return "budget", None
            s_lo, s_hi = stack.pop()
            budget["n"] += 1
            ok_p, _, iv_p, pre_p = _interval_forward(
                W, B, pos_t, zero_phases, s_lo, s_hi)
            ok_n, _, iv_n, pre_n = _interval_forward(
                W, B, neg_t, zero_phases, s_lo, s_hi)
            if not ok_p or not ok_n:
                continue
            dead = False
            if iv_p[1] <= 0 or iv_n[0] >= 0:
                dead = True
            if not dead:
                gs_p, c_p = _crown_out_form(W, B, pos_t, zero_phases,
                                            s_lo, s_hi, pre_p, upper=True)
                if _concretize_ub(gs_p, c_p, s_lo, s_hi) <= 0:
                    dead = True
            if not dead:
                gs_n, c_n = _crown_out_form(W, B, neg_t, zero_phases,
                                            s_lo, s_hi, pre_n, upper=False)
                lb_n = -_concretize_ub([-a for a in gs_n], -c_n, s_lo, s_hi)
                if lb_n >= 0:
                    dead = True
            if not dead:
                diff = [gp - gn for gp, gn in zip(gs_p, gs_n)]
                if _concretize_ub(diff, c_p - c_n, s_lo, s_hi) <= 0:
                    dead = True  # flip needs f_pos − f_neg > 0 somewhere
            if dead:
                continue
            v = max(split_vars, key=lambda i: s_hi[i] - s_lo[i])
            if s_hi[v] - s_lo[v] <= 0:
                wit = leaf_point(s_lo)
                if wit is not None:
                    return "refuted", wit
                continue
            import math

            mid = Fraction(math.floor((s_lo[v] + s_hi[v]) / 2))
            left_hi = list(s_hi)
            left_hi[v] = mid
            right_lo = list(s_lo)
            right_lo[v] = mid + 1
            stack.append((list(s_lo), left_hi))
            stack.append((right_lo, list(s_hi)))
        return "unsat", None

    # Direction 1: f_a > 0 ∧ f_b < 0 over all free-PA values.  With no RA
    # relaxation the towers differ only in which PA vars they read, so the
    # pa_a ↔ pa_b swap makes direction 2 the SAME problem and one sweep is
    # complete.  With an RA shift the symmetry breaks (only role b is
    # shifted; the mirrored witness may need a shared point outside the
    # box), so direction 2 gets its own sweep with the roles' sign
    # requirements swapped.
    directions = [(ta, tb)] if n_ra == 0 else [(ta, tb), (tb, ta)]
    for pos_t, neg_t in directions:
        status, wit = sweep(pos_t, neg_t)
        if status == "refuted":
            return {"verdict": "refuted", "nodes": budget["n"],
                    "witness": (wit[0].tolist(), wit[1].tolist())}
        if status == "budget":
            return {"verdict": "budget", "nodes": budget["n"]}
    return {"verdict": "unsat_confirmed", "nodes": budget["n"]}


# ---------------------------------------------------------------------------
# Float-search / exact-verify sign certification (the AC-7-class audit)
# ---------------------------------------------------------------------------


def _dyadic_down(x: Fraction, bits: int = 30) -> Fraction:
    import math

    return Fraction(math.floor(x * (1 << bits)), 1 << bits)


def _dyadic_up(x: Fraction, bits: int = 30) -> Fraction:
    import math

    return Fraction(math.ceil(x * (1 << bits)), 1 << bits)


def _exact_layer_bounds(W, B, tower: _Tower, s_lo, s_hi):
    """Exact CROWN pre-activation bounds for every layer (root, no phases).

    Per layer, one rational backward pass per bound side using the bounds
    of the shallower layers — the exact twin of ``ops.crown.crown_bounds``.
    Interval-intersected, so never looser than plain IBP.  The cost (a few
    seconds on the zoo's deepest nets) is paid once per audited box; the
    resulting bounds make the audit's triangle relaxation engine-grade
    tight *and* exactly valid.
    """
    nv = len(s_lo)
    nh = len(W) - 1
    bounds: List[List[Tuple[Fraction, Fraction]]] = []

    def backward(k: int, j: int, upper: bool) -> Fraction:
        sgn = Fraction(1) if upper else Fraction(-1)
        g = [sgn * W[k][i][j] for i in range(len(W[k]))]
        const = sgn * B[k][j]
        for kk in range(k - 1, -1, -1):
            ng = []
            for jj, gj in enumerate(g):
                if gj == 0:
                    ng.append(ZERO)
                    continue
                lb, ub = bounds[kk][jj]
                if lb >= 0:
                    ng.append(gj)
                elif ub <= 0:
                    ng.append(ZERO)
                elif gj > 0:
                    s = ub / (ub - lb)
                    ng.append(gj * s)
                    const += gj * (-s * lb)
                else:
                    ng.append(gj if ub > -lb else ZERO)
            g = [sum(W[kk][i][jj] * ng[jj] for jj in range(len(ng)))
                 for i in range(len(W[kk]))]
            const += sum(B[kk][jj] * ng[jj] for jj in range(len(ng)))
        gs = [sum(g[i] * tower.M[i][v] for i in range(len(g))) for v in range(nv)]
        const += sum(g[i] * tower.t[i] for i in range(len(g)))
        total = const + sum((a * (s_hi[v] if a > 0 else s_lo[v]))
                            for v, a in enumerate(gs))
        return total if upper else -total

    # Interval pass for the cheap baseline to intersect with.
    iv = []
    for i in range(len(tower.M)):
        lbv = tower.t[i] + sum((a * (s_lo[v] if a > 0 else s_hi[v]))
                               for v, a in enumerate(tower.M[i]))
        ubv = tower.t[i] + sum((a * (s_hi[v] if a > 0 else s_lo[v]))
                               for v, a in enumerate(tower.M[i]))
        iv.append((lbv, ubv))
    for k in range(nh):
        layer = []
        n_out = len(B[k])
        for j in range(n_out):
            lb_i = B[k][j] + sum(
                W[k][i][j] * (l if W[k][i][j] > 0 else u)
                for i, (l, u) in enumerate(iv))
            ub_i = B[k][j] + sum(
                W[k][i][j] * (u if W[k][i][j] > 0 else l)
                for i, (l, u) in enumerate(iv))
            if k == 0:
                lb_f, ub_f = lb_i, ub_i  # exact affine over the box
            else:
                lb_c = backward(k, j, upper=False)
                ub_c = backward(k, j, upper=True)
                lb_f, ub_f = max(lb_i, lb_c), min(ub_i, ub_c)
            # Outward dyadic rounding (2⁻³⁰): deeper backward passes and the
            # triangle rows built from these bounds would otherwise drag
            # thousand-bit rationals through every product — bounds stay
            # exactly valid, coefficients stay small.
            layer.append((_dyadic_down(lb_f), _dyadic_up(ub_f)))
        bounds.append(layer)
        iv = [(max(l, ZERO), max(u, ZERO)) for (l, u) in layer]
    return bounds


def _exact_dual_bound(c, A_ub, b_ub, A_eq, b_eq, lb_v, ub_v, y_ub, y_eq) -> Fraction:
    """Exact weak-duality lower bound of min cᵀx over the polyhedron.

    For ANY y_ub ≥ 0 and free y_eq (here: HiGHS duals rounded to exact
    rationals, negatives clipped), every feasible x satisfies

      cᵀx ≥ −y_ubᵀb_ub − y_eqᵀb_eq + min_{x∈[lb,ub]} (c + A_ubᵀy_ub + A_eqᵀy_eq)ᵀx

    so the right-hand side — evaluated in Fractions — is a sound bound no
    matter how approximate the float solve was.  Float work *searches*,
    exact work *certifies*: the same division of labour as the engine's
    SAT witnesses.
    """
    n = len(c)
    r = list(c)
    acc = ZERO
    for yi, row, bi in zip(y_ub, A_ub, b_ub):
        if yi <= 0:
            continue
        acc -= yi * bi
        for v in range(n):
            if row[v] != 0:
                r[v] += yi * row[v]
    for yi, row, bi in zip(y_eq, A_eq, b_eq):
        if yi == 0:
            continue
        acc -= yi * bi
        for v in range(n):
            if row[v] != 0:
                r[v] += yi * row[v]
    for v in range(n):
        if r[v] > 0:
            acc += r[v] * lb_v[v]
        elif r[v] < 0:
            acc += r[v] * ub_v[v]
    return acc


def _exact_infeasibility(A_ub, b_ub, A_eq, b_eq, lb_v, ub_v) -> bool:
    """Exactly confirm a region is empty via a slack LP's verified dual.

    Minimise s ≥ 0 over {A_ub·x ≤ b_ub + s, |A_eq·x − b_eq| ≤ s, x ∈ box}:
    the float solve *finds* near-optimal duals, :func:`_exact_dual_bound`
    turns them into a rigorous rational lower bound of min s — positive ⇒
    the original region is empty.  False means "could not confirm" (the
    region may or may not be empty), never an unsound claim.
    """
    from scipy.optimize import linprog

    n = len(lb_v)
    c = [ZERO] * n + [Fraction(1)]
    A2, b2 = [], []
    for row, bi in zip(A_ub, b_ub):
        A2.append(list(row) + [Fraction(-1)])
        b2.append(bi)
    for row, bi in zip(A_eq, b_eq):
        A2.append(list(row) + [Fraction(-1)])
        b2.append(bi)
        A2.append([-v for v in row] + [Fraction(-1)])
        b2.append(-bi)
    lb2 = list(lb_v) + [ZERO]
    ub2 = list(ub_v) + [Fraction(10**9)]
    res = linprog(
        [float(v) for v in c],
        A_ub=np.array([[float(v) for v in r] for r in A2]),
        b_ub=np.array([float(v) for v in b2]),
        bounds=[(float(l), float(u)) for l, u in zip(lb2, ub2)],
        method="highs")
    if res.status != 0 or res.fun is None or res.fun <= 0:
        return False
    y = [Fraction(max(float(-m), 0.0))
         for m in np.atleast_1d(res.ineqlin.marginals)]
    bound = _exact_dual_bound(c, A2, b2, [], [], lb2, ub2, y, [])
    return bound > 0


def confirm_sign_certificate(
    weights, biases, lo, hi, want_positive: bool,
    max_nodes: int = 2000,
    trace: bool = False,
) -> dict:
    """Independent exact confirmation of a uniform-sign certificate.

    Float LP (scipy/HiGHS) finds candidate discharges over the *exact*
    triangle relaxation (rows built in Fractions from exact root CROWN
    intermediate bounds, floatified only for the solver); every discharge
    is then verified by :func:`_exact_dual_bound` in rationals, and
    fully-resolved regions fall back to the exact simplex.  Verdicts:
    'confirmed' | 'not_confirmed' | 'budget'.
    """
    from scipy.optimize import linprog

    W, B = _frac_weights(weights, biases)
    if not want_positive:
        # Negate the output layer: one minimisation path serves both signs.
        W = W[:-1] + [[[-w for w in row] for row in W[-1]]]
        B = B[:-1] + [[-b for b in B[-1]]]
    d = len(lo)
    M = [[ZERO] * d for _ in range(d)]
    for i in range(d):
        M[i][i] = Fraction(1)
    tower = _Tower(M, [ZERO] * d)
    s_lo = [Fraction(int(v)) for v in lo]
    s_hi = [Fraction(int(v)) for v in hi]
    root_bounds = _exact_layer_bounds(W, B, tower, s_lo, s_hi)
    nh = len(W) - 1
    sizes = [len(b) for b in B[:-1]]

    def build_rows(phases):
        """Exact triangle LP rows for a phase pattern.

        Vars: x (d) then h per hidden layer.  Returns None on an interval
        contradiction, else (c, A_ub, b_ub, A_eq, b_eq, lb_v, ub_v, meta)
        with meta = free unstable (layer, neuron, hvar) list.
        """
        off = [d]
        for s in sizes[:-1]:
            off.append(off[-1] + s)
        nvar = d + sum(sizes)
        lb_v = list(s_lo) + [ZERO] * sum(sizes)
        ub_v = list(s_hi) + [ZERO] * sum(sizes)
        A_ub, b_ub, A_eq, b_eq = [], [], [], []
        meta = []
        prev_off, prev_n = 0, d
        for k in range(nh):
            for j in range(sizes[k]):
                hv = off[k] + j
                l, u = root_bounds[k][j]
                ph = phases[k][j]
                if ph == 0 and l >= 0:
                    ph = 1
                if ph == 0 and u <= 0:
                    ph = -1
                if ph == -1:
                    if l > 0:
                        return None
                    lb_v[hv] = ub_v[hv] = ZERO
                    if u > 0:  # force z ≤ 0
                        row = [ZERO] * nvar
                        for i in range(prev_n):
                            row[prev_off + i] = W[k][i][j]
                        A_ub.append(row)
                        b_ub.append(-B[k][j])
                    continue
                if ph == 1:
                    if u < 0:
                        return None
                    row = [ZERO] * nvar
                    for i in range(prev_n):
                        row[prev_off + i] = W[k][i][j]
                    row[hv] = Fraction(-1)
                    A_eq.append(row)
                    b_eq.append(-B[k][j])
                    lb_v[hv] = max(l, ZERO)
                    ub_v[hv] = max(u, ZERO)
                    continue
                # Free unstable: triangle.
                lb_v[hv] = ZERO
                ub_v[hv] = max(u, ZERO)
                row = [ZERO] * nvar     # z − h ≤ 0
                for i in range(prev_n):
                    row[prev_off + i] = W[k][i][j]
                row[hv] = Fraction(-1)
                A_ub.append(row)
                b_ub.append(-B[k][j])
                s = u / (u - l)
                row = [ZERO] * nvar     # h − s·z ≤ −s·l
                for i in range(prev_n):
                    row[prev_off + i] = -s * W[k][i][j]
                row[hv] = Fraction(1)
                A_ub.append(row)
                b_ub.append(s * B[k][j] - s * l)
                meta.append((k, j, hv))
            prev_off, prev_n = off[k], sizes[k]
        c = [ZERO] * nvar
        for i in range(prev_n):
            c[prev_off + i] = W[nh][i][0]
        return c, A_ub, b_ub, A_eq, b_eq, lb_v, ub_v, meta, B[nh][0]

    stack = [[[0] * n for n in sizes]]
    nodes = 0
    while stack:
        if nodes >= max_nodes:
            return {"verdict": "budget", "nodes": nodes}
        phases = stack.pop()
        nodes += 1
        built = build_rows(phases)
        if built is None:
            continue  # exact interval contradiction: empty region
        c, A_ub, b_ub, A_eq, b_eq, lb_v, ub_v, meta, out_b = built
        res = linprog(
            [float(v) for v in c],
            A_ub=np.array([[float(v) for v in row] for row in A_ub]) if A_ub else None,
            b_ub=np.array([float(v) for v in b_ub]) if b_ub else None,
            A_eq=np.array([[float(v) for v in row] for row in A_eq]) if A_eq else None,
            b_eq=np.array([float(v) for v in b_eq]) if b_eq else None,
            bounds=[(float(l), float(u)) for l, u in zip(lb_v, ub_v)],
            method="highs")
        discharged = False
        if res.status == 2:
            # Float claims the branch region is empty; confirm exactly via
            # the slack LP before discharging (an unconfirmed empty claim
            # falls through to branching — sound either way).
            if _exact_infeasibility(A_ub, b_ub, A_eq, b_eq, lb_v, ub_v):
                if trace:
                    print(f"node {nodes}: infeasible (exactly confirmed)")
                continue
        if res.status == 0 and res.fun is not None:
            y_ub = [Fraction(max(float(m), 0.0)) for m in
                    (np.atleast_1d(-res.ineqlin.marginals) if A_ub else [])]
            y_eq = [Fraction(float(m)) for m in
                    (np.atleast_1d(-res.eqlin.marginals) if A_eq else [])]
            bound = _exact_dual_bound(c, A_ub, b_ub, A_eq, b_eq,
                                      lb_v, ub_v, y_ub, y_eq) + out_b
            if trace:
                nfix = sum(1 for l in phases for p in l if p != 0)
                print(f"node {nodes}: fixed={nfix} lp={res.fun + float(out_b):.4f} "
                      f"exact_bound={float(bound):.4f} free={len(meta)}")
            if bound > 0:
                discharged = True
        if discharged:
            continue
        if not meta:
            # Fully resolved affine region, bound could not clear zero:
            # decide exactly — eliminate h (affine in x) via the equalities
            # is already encoded; run the exact simplex on {region ∧ f ≤ 0}.
            A2 = [list(r) for r in A_ub] + [list(r) for r in A_eq] \
                + [[-v for v in r] for r in A_eq]
            b2 = list(b_ub) + list(b_eq) + [-v for v in b_eq]
            A2.append(list(c))
            b2.append(-out_b)  # f = c·x + out_b ≤ 0
            st, _ = _feasible(A2, b2, lb_v, ub_v)
            if st != "infeasible":
                # 'feasible' (sign claim fails here) or 'unknown' (pivot
                # cap): either way the certificate is not confirmed —
                # budget exhaustion must not silently discharge.
                return {"verdict": "not_confirmed", "nodes": nodes}
            continue
        # Branch on the most triangle-violating free neuron (from the LP
        # point when available; else — no usable float point — the free
        # neuron with the largest triangle area, a static proxy).
        pick = max(meta, key=lambda t: float(
            root_bounds[t[0]][t[1]][1] * -root_bounds[t[0]][t[1]][0]))[:2]
        if res.status == 0 and res.x is not None:
            best = -1.0
            x = res.x
            off0 = d
            offs = [d]
            for s_ in sizes[:-1]:
                offs.append(offs[-1] + s_)
            for (k, j, hv) in meta:
                po = 0 if k == 0 else offs[k - 1]
                pn = d if k == 0 else sizes[k - 1]
                z = float(B[k][j]) + sum(
                    float(W[k][i][j]) * x[po + i] for i in range(pn))
                v = abs(x[hv] - max(0.0, z))
                if v > best:
                    best, pick = v, (k, j)
        if trace:
            print(f"  branch pick={pick}")
        k, j = pick
        for ph in (1, -1):
            child = [list(l) for l in phases]
            child[k][j] = ph
            stack.append(child)
    return {"verdict": "confirmed", "nodes": nodes}


def pair_is_legal(enc, lo, hi, x, xp) -> bool:
    """Well-formedness of a counterexample pair, independent of its signs.

    The replay audit must establish more than a strict flip: the pair has
    to be a *legal* fairness pair — every PA coordinate differs
    (``property.encode``'s conjunction of neq), non-PA coordinates are tied
    (RA dims within ±ε), and the x role lies inside the partition box (the
    x' role may leave it on RA dims only, ``property.role_boxes``).
    """
    x = np.asarray(x, dtype=np.int64)
    xp = np.asarray(xp, dtype=np.int64)
    pa = set(int(i) for i in enc.pa_idx)
    ra = set(int(i) for i in enc.ra_idx) if enc.eps else set()
    for i in range(len(x)):
        if i in pa:
            if x[i] == xp[i]:
                return False
            if not (lo[i] <= x[i] <= hi[i] and lo[i] <= xp[i] <= hi[i]):
                return False
        else:
            if not (lo[i] <= x[i] <= hi[i]):
                return False
            if i in ra:
                if abs(int(xp[i]) - int(x[i])) > enc.eps:
                    return False
            elif x[i] != xp[i]:
                return False
    return True
