"""Planet-style triangle-relaxation LP and the complete BaBs built on it.

Port (a copy: numpy and scipy's HiGHS, no device work) of
``fairify_tpu/ops/lp.py``.  Every unstable ReLU is relaxed by its triangle
(Ehlers 2017, "Planet"), one small LP is solved per branch, and the BaB
splits the neuron whose LP point most violates the exact ReLU:

* :func:`sign_bab_lp` — a uniform output sign over a box (Phase L, inside
  the uniform-sign BaB);
* :func:`pair_bab_lp` — one flip direction of one assignment pair over the
  tied pair network (Phase P);
* :func:`clip_box_with_form` — the exact f64 mirror of the device BaB's
  domain clip.

The pre-activation bounds come from the device (``verify.engine``'s
``inter_bounds``, CROWN with outward widening); the LPs run on the host.
Evidence class: f64 LP with a scale-aware margin, like
``verify.engine.leaf_sign_lp`` — not exact rational arithmetic.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _lp_margin(obj_scale: float) -> float:
    """Certification margin against f64 accumulation + HiGHS tolerances.

    ``obj_scale`` must bound the *objective magnitude range* (Σ|w_out|·|h|
    over the variable bounds, plus |b_out|), not just the coefficient sums:
    HiGHS feasibility/duality tolerances act on the solved system's scale,
    so on wide integer domains (variables ~10⁶) the optimum can be off by
    ~tol × scale — a margin blind to the variable magnitudes would certify
    through that noise.
    """
    return 1e-5 + 1e-6 * max(obj_scale, 1.0)


class TriangleLP:
    """Reusable triangle-relaxation tableau for one box of one network.

    Variables: input x (d) then post-activations h_k per hidden layer.
    Pre-activations are eliminated (z_k = W_k·h_{k-1} + b_k substituted into
    every constraint).  Stable/forced neurons contribute equalities or fixed
    bounds; unstable free neurons contribute the triangle:

        h ≥ 0,  h ≥ z,  h ≤ u·(z − l)/(u − l).

    Forcing a neuron active adds ``h = z ∧ z ≥ 0``; inactive adds
    ``h = 0 ∧ z ≤ 0`` — exactly the sign-split semantics of
    ``crown.sign_constrained_output_bounds``, but solved to LP optimality
    instead of iterated to a β-ascent fixed point.
    """

    def __init__(self, weights, biases, masks, lo, hi, pre_lb, pre_ub):
        self.d = len(lo)
        self.nh = len(weights) - 1
        self.sizes = [int(w.shape[1]) for w in weights[: self.nh]]
        self.W = [np.asarray(w, np.float64) for w in weights]
        self.b = [np.asarray(b, np.float64) for b in biases]
        self.alive = [np.asarray(m, np.float64) > 0.5 for m in masks[: self.nh]]
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)
        self.pre_lb = [np.asarray(p, np.float64) for p in pre_lb]
        self.pre_ub = [np.asarray(p, np.float64) for p in pre_ub]
        self.off = [self.d]
        for s in self.sizes[:-1]:
            self.off.append(self.off[-1] + s)
        self.nvar = self.d + sum(self.sizes)
        self.out_w = np.asarray(weights[self.nh], np.float64)[:, 0]
        self.out_b = float(np.asarray(biases[self.nh], np.float64)[0])

    def _prev_span(self, k: int) -> Tuple[int, int]:
        return (0, self.d) if k == 0 else (self.off[k - 1], self.sizes[k - 1])

    def solve_min(self, forced: Sequence[np.ndarray]):
        """Minimise the output logit subject to the relaxation + forcings.

        Returns ``(status, value, x)``: status 'ok' | 'infeasible' | 'error';
        on 'ok', ``value`` is the LP optimum (a sound lower bound of the
        region minimum) and ``x`` the full variable vector for branching.
        """
        from scipy.optimize import linprog

        lb_v = np.empty(self.nvar)
        ub_v = np.empty(self.nvar)
        lb_v[: self.d] = self.lo
        ub_v[: self.d] = self.hi
        A_ub: List[np.ndarray] = []
        b_ub: List[float] = []
        A_eq: List[np.ndarray] = []
        b_eq: List[float] = []
        for k in range(self.nh):
            W, bb = self.W[k], self.b[k]
            l, u = self.pre_lb[k], self.pre_ub[k]
            po, pn = self._prev_span(k)
            o = self.off[k]
            f = forced[k]
            for j in range(self.sizes[k]):
                hv = o + j
                if not self.alive[k][j] or u[j] <= 0.0 or f[j] == -1:
                    lb_v[hv] = ub_v[hv] = 0.0
                    if f[j] == -1 and u[j] > 0.0:  # z ≤ 0
                        row = np.zeros(self.nvar)
                        row[po: po + pn] = W[:, j]
                        A_ub.append(row)
                        b_ub.append(-bb[j])
                    continue
                if l[j] >= 0.0 or f[j] == 1:  # h = z (≥ 0 via var bound)
                    row = np.zeros(self.nvar)
                    row[po: po + pn] = W[:, j]
                    row[hv] = -1.0
                    A_eq.append(row)
                    b_eq.append(-bb[j])
                    lb_v[hv] = max(float(l[j]), 0.0)
                    ub_v[hv] = max(float(u[j]), 0.0)
                    continue
                # Unstable, free: the triangle.
                lb_v[hv] = 0.0
                ub_v[hv] = float(u[j])
                row = np.zeros(self.nvar)  # z − h ≤ 0
                row[po: po + pn] = W[:, j]
                row[hv] = -1.0
                A_ub.append(row)
                b_ub.append(-bb[j])
                s = float(u[j] / (u[j] - l[j]))
                row = np.zeros(self.nvar)  # h − s·z ≤ −s·l
                row[po: po + pn] = -s * W[:, j]
                row[hv] = 1.0
                A_ub.append(row)
                b_ub.append(s * bb[j] - s * float(l[j]))
        c = np.zeros(self.nvar)
        oo, on = self._prev_span(self.nh)
        c[oo: oo + on] = self.out_w
        res = linprog(
            c,
            A_ub=np.stack(A_ub) if A_ub else None,
            b_ub=np.asarray(b_ub) if b_ub else None,
            A_eq=np.stack(A_eq) if A_eq else None,
            b_eq=np.asarray(b_eq) if b_eq else None,
            bounds=np.stack([lb_v, ub_v], axis=1),
            method="highs",
        )
        if res.status == 2:
            return "infeasible", None, None
        if res.status != 0 or res.fun is None:
            return "error", None, None
        return "ok", float(res.fun) + self.out_b, res.x

    def branch_neuron(self, x: np.ndarray, forced) -> Optional[Tuple[int, int]]:
        """Free unstable neuron whose LP point most violates exact ReLU."""
        best, pick = 0.0, None
        for k in range(self.nh):
            l, u = self.pre_lb[k], self.pre_ub[k]
            po, pn = self._prev_span(k)
            prev = x[po: po + pn]
            for j in range(self.sizes[k]):
                if forced[k][j] != 0 or not self.alive[k][j]:
                    continue
                if not (l[j] < 0.0 < u[j]):
                    continue
                z = float(self.W[k][:, j] @ prev + self.b[k][j])
                v = abs(float(x[self.off[k] + j]) - max(0.0, z))
                if v > best:
                    best, pick = v, (k, j)
        return pick

    def margin(self) -> float:
        # Objective magnitude over the relaxation: last-hidden post-activation
        # bounds are [0, max(u, 0)] (post-ReLU), so Σ|w_out|·u⁺ + |b_out|
        # bounds |objective| over the entire feasible set.
        k = self.nh - 1
        h_hi = np.maximum(self.pre_ub[k], 0.0)
        scale = float(np.abs(self.out_w) @ h_hi) + abs(self.out_b)
        return _lp_margin(scale)


def sign_bab_lp(
    weights,
    biases,
    masks,
    lo,
    hi,
    pre_lb,
    pre_ub,
    want_positive: bool,
    max_nodes: int = 4000,
    deadline_s: float = 30.0,
) -> Tuple[str, int]:
    """Complete LP branch-and-bound for a uniform output sign over a box.

    Proves ``min f > margin`` (``want_positive``) or ``max f < −margin``
    over the triangle relaxation, branching on ReLU-violating neurons until
    every branch is certified or refuted.  Returns ``(outcome, nodes)``:

    * ``'certified'`` — every branch cleared the margin: uniform sign proved;
    * ``'refuted'``   — a fully-resolved affine region's true optimum lands
      at or inside the margin band: the conjecture fails (or is too marginal
      for the f64+margin evidence class) and NO sign method can certify it —
      the caller should hand the root to the pair BaB, not retry;
    * ``'budget'``    — node/deadline budget exhausted before closure.

    For ``want_positive=False`` the network is negated (out_w, out_b ↦ −)
    so one minimisation path serves both signs.
    """
    t0 = time.perf_counter()
    lp = TriangleLP(weights, biases, masks, lo, hi, pre_lb, pre_ub)
    if not want_positive:
        lp.out_w = -lp.out_w
        lp.out_b = -lp.out_b
    margin = lp.margin()
    root = [np.zeros(s, dtype=np.int8) for s in lp.sizes]
    stack = [root]
    nodes = 0
    while stack:
        if nodes >= max_nodes or (time.perf_counter() - t0) > deadline_s:
            return "budget", nodes
        forced = stack.pop()
        nodes += 1
        st, val, x = lp.solve_min(forced)
        if st == "infeasible":
            continue  # empty branch region: discharged
        if st == "error":
            return "budget", nodes
        if val > margin:
            continue  # branch certified
        pick = lp.branch_neuron(x, forced)
        if pick is None:
            return "refuted", nodes
        k, j = pick
        for sign in (1, -1):
            child = [f.copy() for f in forced]
            child[k][j] = sign
            stack.append(child)
    return "certified", nodes


class PairTriangleLP:
    """Triangle-relaxation LP of the *pair* network over tied coordinates.

    NOTE: the per-neuron stable/forced/triangle row emission, the
    max-violation branch pick, and the margin posture deliberately mirror
    :class:`TriangleLP` — any change to the relaxation or margin rule must
    be applied to BOTH classes (they are audited in lockstep by the
    certificate-attack harness).

    Two towers of the same net share the free (non-PA) input coordinates;
    tower b's RA dims are shifted by bounded deltas and each tower's PA
    dims are pinned to its assignment.  The flip query for one direction —
    ∃ tied inputs with f_a > 0 ∧ f_b < 0 — becomes emptiness of one
    polyhedron once every unstable ReLU is relaxed by its triangle.  This
    is the *relational* certificate the separate-role and uniform-sign
    paths lack: the shared coordinates tie the towers, so boxes where both
    logits straddle zero but track each other (the relaxed-AC-7 residue)
    still die.

    Variables: s (free dims) + r (RA deltas) + h per hidden layer per
    tower.  Emptiness is certified through the slack LP ``min t`` s.t.
    every row relaxed by t: a minimum above the scale-aware margin is an
    f64+margin proof that the region (with t = 0) is empty — no reliance
    on a float solver's infeasibility status.
    """

    def __init__(self, weights, biases, masks, enc, lo, hi,
                 assign_a, assign_b,
                 pre_lb_a, pre_ub_a, pre_lb_b, pre_ub_b):
        self.nh = len(weights) - 1
        self.sizes = [int(w.shape[1]) for w in weights[: self.nh]]
        self.W = [np.asarray(w, np.float64) for w in weights]
        self.b = [np.asarray(b, np.float64) for b in biases]
        self.alive = [np.asarray(m, np.float64) > 0.5 for m in masks[: self.nh]]
        d = len(lo)
        pa = list(enc.pa_idx)
        ra = list(enc.ra_idx) if enc.eps else []
        self.free = [i for i in range(d) if i not in pa]
        self.n_free = len(self.free)
        self.n_ra = len(ra)
        self.eps = int(enc.eps)
        # Input maps: per tower, x = M·[s, r] + t (rows = input dims).
        nv_in = self.n_free + self.n_ra
        self.maps = []
        for assign, shifted in ((assign_a, False), (assign_b, True)):
            M = np.zeros((d, nv_in))
            t = np.zeros(d)
            for k, i in enumerate(self.free):
                M[i, k] = 1.0
            for k, i in enumerate(pa):
                t[i] = float(assign[k])
            if shifted:
                for k, i in enumerate(ra):
                    M[i, self.n_free + k] = 1.0
            self.maps.append((M, t))
        self.s_lo = np.asarray([lo[i] for i in self.free], np.float64)
        self.s_hi = np.asarray([hi[i] for i in self.free], np.float64)
        self.pre = [(pre_lb_a, pre_ub_a), (pre_lb_b, pre_ub_b)]
        self.nvar = nv_in + 2 * sum(self.sizes)
        self.h_off = []
        o = nv_in
        for tower in range(2):
            offs = []
            for s_ in self.sizes:
                offs.append(o)
                o += s_
            self.h_off.append(offs)
        self.out_w = np.asarray(weights[self.nh], np.float64)[:, 0]
        self.out_b = float(np.asarray(biases[self.nh], np.float64)[0])

    def _margin(self) -> float:
        scale = 0.0
        for tower in range(2):
            h_hi = np.maximum(np.asarray(self.pre[tower][1][self.nh - 1],
                                         np.float64), 0.0)
            scale = max(scale, float(np.abs(self.out_w) @ h_hi) + abs(self.out_b))
        return _lp_margin(scale)

    def solve_direction(self, forced_a, forced_b, flip: bool = False):
        """Slack LP of {towers' triangles ∧ sign constraints}.

        ``flip=False``: f_a ≥ 0 ∧ f_b ≤ 0; ``flip=True``: f_a ≤ 0 ∧
        f_b ≥ 0.  Both are needed when an RA shift is present — the shift
        stays attached to tower b, so swapping the assignment pair does
        NOT mirror the direction (the mirrored witness may live in the
        out-of-box ε band only tower b can reach).

        Returns ``(t_min, margin, x, viol)``: ``t_min > margin`` certifies
        the region empty; otherwise ``x`` is the LP point and ``viol`` the
        max-ReLU-violating free neuron as (tower, layer, neuron), or None
        when fully resolved.  ``(None, ...)`` on solver failure.
        """
        from scipy.optimize import linprog

        nv_in = self.n_free + self.n_ra
        lb_v = np.empty(self.nvar + 1)
        ub_v = np.empty(self.nvar + 1)
        lb_v[: self.n_free] = self.s_lo
        ub_v[: self.n_free] = self.s_hi
        lb_v[self.n_free: nv_in] = -float(self.eps)
        ub_v[self.n_free: nv_in] = float(self.eps)
        lb_v[self.nvar] = 0.0
        ub_v[self.nvar] = np.inf
        A_rows, b_rows = [], []
        forced = (forced_a, forced_b)

        def add(row, rhs, slack=True):
            r = np.zeros(self.nvar + 1)
            r[: len(row)] = row[: len(row)]
            if slack:
                r[self.nvar] = -1.0
            A_rows.append(r)
            b_rows.append(rhs)

        for tower in range(2):
            M, t = self.maps[tower]
            pre_lb, pre_ub = self.pre[tower]
            for k in range(self.nh):
                Wk = self.W[k]
                bk = self.b[k]
                l = np.asarray(pre_lb[k], np.float64)
                u = np.asarray(pre_ub[k], np.float64)
                for j in range(self.sizes[k]):
                    hv = self.h_off[tower][k] + j
                    f = forced[tower][k][j]
                    # Row of z_j over the LP vars.
                    zrow = np.zeros(self.nvar + 1)
                    if k == 0:
                        zin = M.T @ Wk[:, j]  # (nv_in,)
                        zrow[:nv_in] = zin
                        zc = float(t @ Wk[:, j]) + bk[j]
                    else:
                        po = self.h_off[tower][k - 1]
                        zrow[po: po + self.sizes[k - 1]] = Wk[:, j]
                        zc = bk[j]
                    if not self.alive[k][j] or u[j] <= 0.0 or f == -1:
                        lb_v[hv] = ub_v[hv] = 0.0
                        if f == -1 and u[j] > 0.0:
                            add(zrow, -zc)          # z ≤ 0
                        continue
                    if l[j] >= 0.0 or f == 1:
                        r = zrow.copy()
                        r[hv] -= 1.0
                        add(r, -zc)                 # z − h ≤ 0
                        r2 = -zrow
                        r2[hv] += 1.0
                        add(r2, zc)                 # h − z ≤ 0 (equality)
                        lb_v[hv] = max(float(l[j]), 0.0)
                        ub_v[hv] = max(float(u[j]), 0.0)
                        continue
                    lb_v[hv] = 0.0
                    ub_v[hv] = float(u[j])
                    r = zrow.copy()
                    r[hv] -= 1.0
                    add(r, -zc)                     # z − h ≤ 0
                    sl = float(u[j] / (u[j] - l[j]))
                    r2 = -sl * zrow
                    r2[hv] += 1.0
                    add(r2, sl * zc - sl * float(l[j]))  # h ≤ s(z−l)
            # Output sign constraint for this tower (flipped per direction).
            oo = self.h_off[tower][self.nh - 1]
            orow = np.zeros(self.nvar + 1)
            orow[oo: oo + self.sizes[-1]] = self.out_w
            want_pos = (tower == 0) != flip
            if want_pos:
                add(-orow, self.out_b)              # −f ≤ 0  (f ≥ 0)
            else:
                add(orow, -self.out_b)              # f ≤ 0
        c = np.zeros(self.nvar + 1)
        c[self.nvar] = 1.0
        res = linprog(c, A_ub=np.stack(A_rows), b_ub=np.asarray(b_rows),
                      bounds=np.stack([lb_v, ub_v], axis=1), method="highs")
        if res.status != 0 or res.fun is None:
            return None, self._margin(), None, None
        x = res.x
        # Max ReLU violation among free unstable neurons of both towers.
        best, pick = 0.0, None
        for tower in range(2):
            M, t = self.maps[tower]
            pre_lb, pre_ub = self.pre[tower]
            for k in range(self.nh):
                l = np.asarray(pre_lb[k], np.float64)
                u = np.asarray(pre_ub[k], np.float64)
                for j in range(self.sizes[k]):
                    if forced[tower][k][j] != 0 or not self.alive[k][j]:
                        continue
                    if not (l[j] < 0.0 < u[j]):
                        continue
                    if k == 0:
                        zin = M.T @ self.W[0][:, j]
                        z = float(zin @ x[: self.n_free + self.n_ra]
                                  + t @ self.W[0][:, j] + self.b[0][j])
                    else:
                        po = self.h_off[tower][k - 1]
                        z = float(self.W[k][:, j]
                                  @ x[po: po + self.sizes[k - 1]]
                                  + self.b[k][j])
                    v = abs(float(x[self.h_off[tower][k] + j]) - max(0.0, z))
                    if v > best:
                        best, pick = v, (tower, k, j)
        return float(res.fun), self._margin(), x, pick


def pair_bab_lp(
    weights, biases, masks, enc, lo, hi,
    assign_a, assign_b,
    pre_bounds_a, pre_bounds_b,
    max_nodes: int = 2000,
    deadline_s: float = 30.0,
    flip: bool = False,
) -> Tuple[str, int, Optional[Tuple[np.ndarray, np.ndarray]]]:
    """Relational LP BaB for one flip direction of one assignment pair.

    Branches on joint (tower, layer, neuron) ReLU violations until every
    region's slack LP clears the margin ('killed'), a fully-resolved
    feasible region yields an exact-validated lattice witness ('sat'), or
    the budget runs out ('open' — the caller keeps the root undecided).
    ``pre_bounds_*``: per-layer (lb, ub) pre-activation bound lists for
    each tower's role box (CROWN, outward-widened f32 — the usual
    engine evidence class).
    """
    import time as _time

    t0 = _time.perf_counter()
    lp = PairTriangleLP(weights, biases, masks, enc, lo, hi,
                        assign_a, assign_b,
                        pre_bounds_a[0], pre_bounds_a[1],
                        pre_bounds_b[0], pre_bounds_b[1])
    root = ([np.zeros(s, dtype=np.int8) for s in lp.sizes],
            [np.zeros(s, dtype=np.int8) for s in lp.sizes])
    stack = [root]
    nodes = 0
    d = len(lo)
    pa = list(enc.pa_idx)
    ra = list(enc.ra_idx) if enc.eps else []
    while stack:
        if nodes >= max_nodes or (_time.perf_counter() - t0) > deadline_s:
            return "open", nodes, None
        fa, fb = stack.pop()
        nodes += 1
        t_min, margin, x, pick = lp.solve_direction(fa, fb, flip=flip)
        if t_min is None:
            return "open", nodes, None
        if t_min > margin:
            continue  # region certified empty
        if pick is None:
            # Fully resolved, feasible: try an exact lattice witness.
            if x is not None:
                s_vals = np.round(x[: lp.n_free]).astype(np.int64)
                s_vals = np.clip(s_vals, lp.s_lo.astype(np.int64),
                                 lp.s_hi.astype(np.int64))
                xa = np.zeros(d, dtype=np.int64)
                xb = np.zeros(d, dtype=np.int64)
                for k, i in enumerate(lp.free):
                    xa[i] = s_vals[k]
                    xb[i] = s_vals[k]
                for k, i in enumerate(pa):
                    xa[i] = int(assign_a[k])
                    xb[i] = int(assign_b[k])
                for k, i in enumerate(ra):
                    dv = int(round(float(x[lp.n_free + k])))
                    xb[i] += int(np.clip(dv, -lp.eps, lp.eps))
                from fairify_tpu_torch.verify.engine import validate_pair

                wnp = [np.asarray(w) for w in weights]
                bnp = [np.asarray(bb) for bb in biases]
                if validate_pair(wnp, bnp, xa, xb):
                    return "sat", nodes, (xa, xb)
            return "open", nodes, None  # continuous-feasible, no witness
        tower, k, j = pick
        for sign in (1, -1):
            ca = [f.copy() for f in fa]
            cb = [f.copy() for f in fb]
            (ca if tower == 0 else cb)[k][j] = sign
            stack.append((ca, cb))
    return "killed", nodes, None


def clip_box_with_form(D: np.ndarray, c: float, lo: np.ndarray,
                       hi: np.ndarray) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Clip an integer box to where the linear form ``D·s + c`` can be > 0.

    f64 host mirror of the device-BaB domain-clip rule
    (``verify.engine.tied_diff_ub_keep``): the form's maximum over the box is
    attained at the corner ``s*_j = hi_j if D_j > 0 else lo_j`` with value
    ``w = Σ max(D_j·hi_j, D_j·lo_j) + c``; moving coordinate ``j`` a
    distance ``t`` off that corner lowers the form by ``|D_j|·t``, so any
    point with the form positive must satisfy ``s_j > hi_j − w/|D_j|``
    (``D_j > 0``) resp. ``s_j < lo_j + w/|D_j|`` (``D_j < 0``).  The
    device kernel inflates ``w`` and the shift with the sound slack before
    applying this rule; the mirror is the EXACT f64 version, so the device
    keep hull must always contain this one.

    Returns ``(new_lo, new_hi, empty)`` with the keep interval rounded
    INWARD to the lattice (``ceil``/``floor`` — exact, since only strictly
    impossible points are discarded); ``empty=True`` iff ``w ≤ 0`` (no
    point of the box can make the form positive) or the rounded interval
    inverted, in which case the returned box is the untouched input.
    """
    D = np.asarray(D, dtype=np.float64)
    lo64 = np.asarray(lo, dtype=np.float64)
    hi64 = np.asarray(hi, dtype=np.float64)
    w = float(np.sum(np.maximum(D * hi64, D * lo64)) + float(c))
    if w <= 0.0:
        return np.array(lo), np.array(hi), True
    shift = w / np.maximum(np.abs(D), 1e-300)
    keep_lo = np.where(D > 0.0, hi64 - shift, lo64)
    keep_hi = np.where(D < 0.0, lo64 + shift, hi64)
    new_lo = np.maximum(np.asarray(lo), np.ceil(keep_lo).astype(np.int64))
    new_hi = np.minimum(np.asarray(hi), np.floor(keep_hi).astype(np.int64))
    if np.any(new_lo > new_hi):
        return np.array(lo), np.array(hi), True
    return new_lo, new_hi, False
