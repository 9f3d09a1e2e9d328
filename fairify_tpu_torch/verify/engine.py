"""Stage-0 decision engine: certificate, attack, and the exact host checks.

Port of the stage-0 subset of ``fairify_tpu/verify/engine.py``:

* the combined certificate :func:`certify_impl` (``_certify_impl`` at
  ``alpha_iters=0``): CROWN role bounds give the separate-bound kills, the
  output linear forms the tied pair-difference kills
  (:func:`tied_diff_ub`); the per-box certified margin rides along;
* the sampling attack: host-drawn integer candidates
  (:func:`build_attack_candidates`, numpy, the JAX package's exact RNG
  stream), their logits, strict-sign flip detection with a first-hit
  witness (:func:`find_flips_impl`) and the best flip gap
  (:func:`attack_gap_impl`);
* exact witness validation on the host (:func:`validate_pair`).

Two device kernels carry it: KB :func:`stage0_certify`
(``csrc/stage0_certify.cu``) and KC :func:`attack_flips`
(``csrc/attack_flips.cu``), each beside its plain PyTorch version, which
the CPU tests run.
"""
from __future__ import annotations

import ctypes
from fractions import Fraction

import numpy as np
import torch

from fairify_tpu_torch.models.mlp import forward_np
from fairify_tpu_torch.obs import funnel as funnel_mod
from fairify_tpu_torch.ops import crown as crown_ops
from fairify_tpu_torch.ops.interval import SOUND_SLACK_ABS, SOUND_SLACK_REL
from fairify_tpu_torch.utils import cuda_build
from fairify_tpu_torch.verify.property import PairEncoding

F32_MAX = float(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# Certificate (KB)
# ---------------------------------------------------------------------------


def tied_diff_ub(A_pos, c_pos, A_neg, c_neg, lo, hi, shared_mask):
    """Upper bounds of (pos-form − neg-form) over tied shared coordinates.

    ``A_pos``/``c_pos``: (B, Vp, d)/(B, Vp) upper form of the role that must
    be positive; ``A_neg``/``c_neg``: lower form of the role that must be
    negative; ``lo``/``hi``: (B, d) shared box.  Returns the (B, Vp, Vn)
    bound matrix and its (B, Vp, Vn) magnitude (the concretized terms plus
    both forms' coefficient magnitudes, against which the outward slack is
    scaled).  The Vp axis is looped so (B, V, V, d) is never materialised.
    """
    absbox = torch.maximum(lo.abs(), hi.abs())
    neg_coef_mag = (A_neg.abs() * absbox[:, None, :]).sum(-1)  # (B, Vn)
    rows, mags = [], []
    for a in range(A_pos.shape[1]):
        au, cu = A_pos[:, a], c_pos[:, a]
        D = (au[:, None, :] - A_neg) * shared_mask
        m = torch.where(D > 0, D * hi[:, None, :], D * lo[:, None, :])
        rows.append(m.sum(-1) + cu[:, None] - c_neg)
        pos_coef_mag = (au.abs() * absbox).sum(-1)  # (B,)
        mags.append((D.abs() * absbox[:, None, :]).sum(-1)
                    + pos_coef_mag[:, None] + neg_coef_mag
                    + cu.abs()[:, None] + c_neg.abs())
    return torch.stack(rows, 1), torch.stack(mags, 1)


def certify_impl(net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals, pa_mask,
                 ra_mask, eps, valid, valid_pair, alpha_iters: int = 0,
                 with_scale: bool = False):
    """Plain PyTorch version of KB: ``(certified (B,), margin (B,))``.

    A box is certified iff every valid assignment pair has both flip
    directions killed, by a role bound or by the tied difference bound
    (each form set widened with its own magnitude).  ``margin >= 0`` iff
    certified; boxes without a valid pair get +FLT_MAX.  (The JAX version
    also returns a branching score, an input of the not-yet-ported BaB.)

    ``with_scale`` also returns each box's largest tied-bound magnitude over
    its valid pairs — the scale the outward slack is taken against, and so
    the scale on which two f32 evaluations of the margin may differ.
    """
    sets_x, lb_x, ub_x = crown_ops.crown_output_form_sets(net, x_lo, x_hi, alpha_iters)
    sets_p, lb_p, ub_p = crown_ops.crown_output_form_sets(net, xp_lo, xp_hi, alpha_iters)
    t1_dead = (ub_x[..., :, None] <= 0.0) | (lb_p[..., None, :] >= 0.0)
    t2_dead = (lb_x[..., :, None] >= 0.0) | (ub_p[..., None, :] <= 0.0)
    shared = 1.0 - pa_mask
    pa_dot = lambda A: (A * assign_vals[None, :, :]).sum(-1)
    ra_abs = lambda A: eps * (A.abs() * ra_mask).sum(-1)
    widen = lambda u, g: u + SOUND_SLACK_REL * g + SOUND_SLACK_ABS
    ub1 = ub2 = mag = None
    for (Alx, clx, Aux, cux), (Alp, clp, Aup, cup) in zip(sets_x, sets_p):
        # Direction x⁺/x'⁻: needs f(x_a) − f(x'_b) > 0.
        m1, g1 = tied_diff_ub(Aux, cux + pa_dot(Aux),
                              Alp, clp + pa_dot(Alp) - ra_abs(Alp), lo, hi, shared)
        # Direction x⁻/x'⁺: needs f(x'_b) − f(x_a) > 0 (matrix built [b, a]).
        m2, g2 = tied_diff_ub(Aup, cup + pa_dot(Aup) + ra_abs(Aup),
                              Alx, clx + pa_dot(Alx), lo, hi, shared)
        w1 = widen(m1, g1)
        w2 = widen(m2, g2).transpose(-1, -2)
        ub1 = w1 if ub1 is None else torch.minimum(ub1, w1)
        ub2 = w2 if ub2 is None else torch.minimum(ub2, w2)
        g = torch.maximum(g1, g2.transpose(-1, -2))
        mag = g if mag is None else torch.maximum(mag, g)
    t1_dead = t1_dead | (ub1 <= 0.0)
    t2_dead = t2_dead | (ub2 <= 0.0)
    pair_ok = valid_pair[None] & valid[..., :, None] & valid[..., None, :]
    possible = pair_ok & ~(t1_dead & t2_dead)
    m1 = torch.maximum(torch.maximum(-ub_x[..., :, None], lb_p[..., None, :]), -ub1)
    m2 = torch.maximum(torch.maximum(lb_x[..., :, None], -ub_p[..., None, :]), -ub2)
    big = torch.full_like(m1, F32_MAX)
    margin = torch.where(pair_ok, torch.minimum(m1, m2), big).amin(dim=(-2, -1))
    cert = ~possible.any(dim=-1).any(dim=-1)
    if with_scale:
        scale = torch.where(pair_ok, mag, torch.zeros_like(mag)).amax(dim=(-2, -1))
        return cert, margin, scale
    return cert, margin


def stage0_certify(net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals, pa_mask,
                   ra_mask, eps: float, valid, valid_pair):
    """KB: the stage-0 certificate of N boxes, one launch.

    Role boxes (N, V, d), partition boxes (N, d), encoding tensors
    ``assign_vals`` (V, d), ``pa_mask``/``ra_mask`` (d,), ``valid`` (N, V)
    and ``valid_pair`` (V, V) bool.  Returns ``(cert (N,) bool, margin (N,)
    float32)``.  CPU tensors take :func:`certify_impl`; CUDA tensors launch
    ``csrc/stage0_certify.cu``.
    """
    if lo.device.type == "cpu":
        return certify_impl(net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals,
                            pa_mask, ra_mask, eps, valid, valid_pair)
    if net.layer_sizes[-1] != 1:
        raise ValueError("stage0_certify: the net must have one output logit")
    params, dims = cuda_build.pack_net(net)
    u8 = lambda t: t.to(torch.uint8).contiguous()
    ins = [t.contiguous() for t in (x_lo, x_hi, xp_lo, xp_hi, lo, hi,
                                    assign_vals, pa_mask, ra_mask)]
    vb, vp = u8(valid), u8(valid_pair)
    cuda_build.require_cuda(params, *ins, vb, vp)
    N, V = valid.shape
    cert = torch.empty(N, dtype=torch.uint8, device=lo.device)
    margin = torch.empty(N, dtype=torch.float32, device=lo.device)
    cuda_build.call("stage0_certify", "kb_stage0_certify",
                    cuda_build.ptr(params), dims, ctypes.c_int(net.depth),
                    *(cuda_build.ptr(t) for t in ins), ctypes.c_float(eps),
                    cuda_build.ptr(vb), cuda_build.ptr(vp), ctypes.c_int(N),
                    ctypes.c_int(V), cuda_build.ptr(cert), cuda_build.ptr(margin),
                    cuda_build.stream())
    stage0_certify.launches += 1
    return cert.bool(), margin


stage0_certify.launches = 0


# ---------------------------------------------------------------------------
# Attack (KC)
# ---------------------------------------------------------------------------


def attack_logits(net, x_roles, xp_roles):
    """Forward logits of attack candidates: (..., V, d) → (..., V)."""
    return net(x_roles), net(xp_roles)


def find_flips_impl(lx, lp, valid, valid_pair):
    """Strict-flip detection: ``(found (B,), wit (B, 3) int32)``.

    ``lx``/``lp``: (B, S, V) logits; a flip is x positive and x' negative
    (or the reverse) on a valid ordered pair; the witness ``(s, a, b)`` is
    the first hit in flat order (0 when there is none).
    """
    va = valid[:, None, :]
    pos_x, neg_x = (lx > 0.0) & va, (lx < 0.0) & va
    pos_p, neg_p = (lp > 0.0) & va, (lp < 0.0) & va
    flips = (pos_x[..., :, None] & neg_p[..., None, :]) | (
        neg_x[..., :, None] & pos_p[..., None, :])
    flips = flips & valid_pair[None, None, :, :]
    B, S, V, _ = flips.shape
    flat = flips.reshape(B, -1)
    found = flat.any(dim=1)
    # argmax of a bool is the FIRST True; torch's argmax on ties is not
    # documented to be first-hit, so take the minimum hit index instead.
    pos = torch.arange(flat.shape[1], device=flat.device)
    idx = torch.where(flat, pos, flat.shape[1]).amin(dim=1)
    idx = torch.where(found, idx, 0).to(torch.int32)
    s, rem = idx // (V * V), idx % (V * V)
    return found, torch.stack([s, rem // V, rem % V], dim=1)


def attack_gap_impl(lx, lp, valid, valid_pair):
    """Best strict-flip gap over (sample, pair); ``gap > 0`` iff a flip;
    masked-out triples count as -FLT_MAX."""
    pair = (valid[:, None, :, None] & valid[:, None, None, :]
            & valid_pair[None, None])
    g1 = torch.minimum(lx[..., :, None], -lp[..., None, :])
    g2 = torch.minimum(-lx[..., :, None], lp[..., None, :])
    neg = torch.full_like(g1, -F32_MAX)
    return torch.where(pair, torch.maximum(g1, g2), neg).amax(dim=(-3, -2, -1))


def chunk_stats(margin, gap, ok):
    """(2, N_BUCKETS) int32 histogram increment, ``idx = Σ (v >= edge)``;
    rows outside ``ok`` (padding, canary) are not counted."""
    edges = torch.as_tensor(funnel_mod.EDGES, device=margin.device)

    def h(v):
        idx = (v[:, None] >= edges[None, :]).sum(dim=1)
        onehot = (idx[:, None] == torch.arange(funnel_mod.N_BUCKETS,
                                               device=v.device)[None, :]) & ok[:, None]
        return onehot.sum(dim=0).to(torch.int32)

    return torch.stack([h(margin), h(gap)])


def fold_int32(*bufs) -> int:
    """Wraparound-int32 sum over buffers (the kernels' transfer checksum;
    ``resilience.integrity.fold_host`` is its host mirror).  torch sums
    int32 into int64, so reduce there and map back to signed 32 bits."""
    total = sum(int(b.to(torch.int64).sum()) for b in bufs) & 0xFFFFFFFF
    return total - (1 << 32) if total >= 1 << 31 else total


def attack_flips_plain(net, xr, pr, valid, valid_pair, cert, margin, ok):
    """Plain PyTorch version of KC.

    ``xr``/``pr``: (N, S, V, d) candidates; ``cert``/``margin``: KB's
    outputs; ``ok`` (N,) rows counted in the histogram.  Returns ``(wit
    (N, 3) int32, reason (N,) int8, gap (N,) float32, stats (2, 14) int32,
    fold int)``.
    """
    lx, lp = attack_logits(net, xr, pr)
    found, wit = find_flips_impl(lx, lp, valid, valid_pair)
    gap = attack_gap_impl(lx, lp, valid, valid_pair)
    reason = (cert.to(torch.int8) + 2 * found.to(torch.int8))
    stats = chunk_stats(margin, gap, ok)
    return wit, reason, gap, stats, fold_int32(cert, wit, reason, stats)


def attack_flips(net, xr, pr, valid, valid_pair, cert, margin, ok):
    """KC: the stage-0 attack of N boxes, one launch (see
    :func:`attack_flips_plain` for the contract).  CUDA tensors launch
    ``csrc/attack_flips.cu``; the histogram and fold accumulate with
    device atomics."""
    if xr.device.type == "cpu":
        return attack_flips_plain(net, xr, pr, valid, valid_pair, cert, margin, ok)
    if net.layer_sizes[-1] != 1:
        raise ValueError("attack_flips: the net must have one output logit")
    params, dims = cuda_build.pack_net(net)
    u8 = lambda t: t.to(torch.uint8).contiguous()
    xr, pr, margin = xr.contiguous(), pr.contiguous(), margin.contiguous()
    vb, vp, cb, okb = u8(valid), u8(valid_pair), u8(cert), u8(ok)
    edges = torch.as_tensor(funnel_mod.EDGES, device=xr.device)
    cuda_build.require_cuda(params, xr, pr, vb, vp, cb, margin, okb, edges)
    N, S, V, _ = xr.shape
    dev = xr.device
    wit = torch.empty((N, 3), dtype=torch.int32, device=dev)
    reason = torch.empty(N, dtype=torch.int8, device=dev)
    gap = torch.empty(N, dtype=torch.float32, device=dev)
    stats = torch.zeros((2, funnel_mod.N_BUCKETS), dtype=torch.int32, device=dev)
    fold = torch.zeros(1, dtype=torch.int32, device=dev)
    cuda_build.call("attack_flips", "kc_attack_flips",
                    cuda_build.ptr(params), dims, ctypes.c_int(net.depth),
                    cuda_build.ptr(xr), cuda_build.ptr(pr), cuda_build.ptr(vb),
                    cuda_build.ptr(vp), cuda_build.ptr(cb), cuda_build.ptr(margin),
                    cuda_build.ptr(okb), cuda_build.ptr(edges), ctypes.c_int(N),
                    ctypes.c_int(S), ctypes.c_int(V), cuda_build.ptr(wit),
                    cuda_build.ptr(reason), cuda_build.ptr(gap),
                    cuda_build.ptr(stats), cuda_build.ptr(fold), cuda_build.stream())
    attack_flips.launches += 1
    return wit, reason, gap, stats, int(fold.item())


attack_flips.launches = 0


# ---------------------------------------------------------------------------
# Host-side helpers: encoding tensors, attack candidates, exact checks
# ---------------------------------------------------------------------------


def build_attack_candidates(enc: PairEncoding, rng: np.random.Generator,
                            lo: np.ndarray, hi: np.ndarray, n_samples: int):
    """Integer attack samples for a batch of boxes: ``(x_roles, xp_roles)``
    of shape (B, S, V, d) — shared coordinates uniform per box, PA dims set
    to each assignment, RA dims of x' shifted by a uniform delta in [-ε, ε].
    Same numpy draws, in the same order, as the JAX package."""
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    B, d = lo.shape
    V = enc.n_assign
    shared = rng.integers(lo[:, None, :], hi[:, None, :] + 1, size=(B, n_samples, d))
    x_roles = np.repeat(shared[:, :, None, :], V, axis=2).astype(np.float32)
    if len(enc.pa_idx):
        x_roles[..., enc.pa_idx] = enc.assignments.astype(np.float32)
    xp_roles = x_roles.copy()
    if len(enc.ra_idx) and enc.eps:
        delta = rng.integers(-enc.eps, enc.eps + 1,
                             size=(B, n_samples, 1, len(enc.ra_idx)))
        xp_roles[..., enc.ra_idx] = xp_roles[..., enc.ra_idx] + delta.astype(np.float32)
    return x_roles, xp_roles


def enc_tensors(enc: PairEncoding, d: int):
    """Dense scatter tensors of an encoding: ``assign_vals`` (V, d) and the
    PA / RA indicator vectors (d,)."""
    assign_vals = np.zeros((enc.n_assign, d), dtype=np.float32)
    pa_mask = np.zeros(d, dtype=np.float32)
    ra_mask = np.zeros(d, dtype=np.float32)
    if len(enc.pa_idx):
        assign_vals[:, enc.pa_idx] = enc.assignments.astype(np.float32)
        pa_mask[enc.pa_idx] = 1.0
    if len(enc.ra_idx):
        ra_mask[enc.ra_idx] = 1.0
    return assign_vals, pa_mask, ra_mask


def extract_witnesses(found, wit, x_cand, xp_cand, weights, biases, limit=None) -> dict:
    """Exact-validated witness dict ``{box: (x, x')}`` from flip output."""
    witnesses = {}
    for i in np.where(found)[0]:
        if limit is not None and i >= limit:
            continue
        s, a, b = wit[i]
        x = x_cand[i, s, a].astype(np.int64)
        xp = xp_cand[i, s, b].astype(np.int64)
        if validate_pair(weights, biases, x, xp):
            witnesses[int(i)] = (x, xp)
    return witnesses


def exact_logit_sign(weights, biases, x: np.ndarray) -> int:
    """Sign of the logit at integer point x, exact when ambiguous.

    Float64 forward first; within 1e-6 of zero, re-evaluate in rational
    arithmetic (f32 weights are dyadic rationals, so this is the true sign).
    """
    v = float(forward_np(weights, biases, np.asarray(x, dtype=np.float64)))
    if abs(v) > 1e-6:
        return 1 if v > 0 else -1
    hf = [Fraction(int(t)) for t in np.asarray(x, dtype=np.int64)]
    for i, (w, b) in enumerate(zip(weights, biases)):
        wf = np.asarray(w, dtype=np.float64)
        bf = np.asarray(b, dtype=np.float64)
        nxt = []
        for j in range(wf.shape[1]):
            acc = Fraction(float(bf[j]))
            for t in range(wf.shape[0]):
                acc += Fraction(float(wf[t, j])) * hf[t]
            if i < len(weights) - 1 and acc < 0:
                acc = Fraction(0)
            nxt.append(acc)
        hf = nxt
    v = hf[0]
    return 0 if v == 0 else (1 if v > 0 else -1)


def validate_pair(weights, biases, x: np.ndarray, xp: np.ndarray) -> bool:
    """Exact strict-flip check for a candidate counterexample pair."""
    sx = exact_logit_sign(weights, biases, x)
    sp = exact_logit_sign(weights, biases, xp)
    return (sx > 0 and sp < 0) or (sx < 0 and sp > 0)
