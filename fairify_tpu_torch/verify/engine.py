"""The decision engine: stage 0, the refinement tail, and the exact host
checks.

Port of ``fairify_tpu/verify/engine.py`` for the phases the port runs:

* the combined certificate :func:`certify_impl` (``_certify_impl``):
  CROWN (α-CROWN with ``alpha_iters > 0``) role bounds give the
  separate-bound kills, the output linear forms the tied pair-difference
  kills (:func:`tied_diff_ub`); the branching score and the per-box
  certified margin ride along; :func:`certify_attack` fuses it with the
  attack (``_certify_attack_kernel``), for one net or a stacked family;
* the sampling attack: host-drawn integer candidates
  (:func:`build_attack_candidates`, numpy, the JAX package's exact RNG
  stream), their logits, strict-sign flip detection with a first-hit
  witness (:func:`find_flips_impl`) and the best flip gap
  (:func:`attack_gap_impl`);
* the gradient attack (:func:`pgd_attack`, Phase A and the sweep's
  ``stage0_pgd``) and the exact flip-slab search (:func:`slab_search`);
* Phase S, the uniform-sign neuron-split BaB (:func:`uniform_sign_bab`:
  the sign conjecture from sampled role logits, β-CROWN bounds under sign
  splits, the exact-region leaf LP :func:`leaf_sign_lp`), with Phase L,
  the host triangle-LP BaB (``ops.lp.sign_bab_lp``) fed by CROWN
  pre-activation bounds, inside it;
* the device-resident branch-and-bound: one segment of rounds over a
  slot queue (:func:`bab_segment`; certificate with domain clipping,
  :func:`certify_clip_impl`, α-CROWN after segment 0), driven by
  :func:`device_bab_phase`, with exact leaves (:func:`decide_leaf`);
* Phase P, the relational pair LP BaB (:func:`pair_lp_phase`,
  ``ops.lp.pair_bab_lp``);
* Phases E0 and E, the exhaustive lattice enumeration
  (``ops.lattice.decide_box_exhaustive``: K9a–c, ``csrc/lattice_scan.cu``),
  E0 before the device BaB on the cheap roots, E (:func:`lattice_phase`)
  after Phase P;
* the host-frontier branch-and-bound (:func:`host_frontier_phase`,
  ``device_bab=False``): one :func:`certify_attack` per frontier batch
  (certificate with the branching score, α-CROWN after a fifth of the
  deadline, the attack), multi-way ``score·width`` splits on the host;
* the IBP path (``use_crown=False``, the JAX package's K10 group): the
  role-logit bounds of both roles (:func:`role_logit_bounds`, rows 13
  and 8) and the attack logits (:func:`attack_logits`, rows 17 and 9) on
  the card, the certificate (:func:`no_flip_certified`), its margin
  (:func:`role_bound_margin`), the flips and the gap on the host
  (:func:`split_certify_attack_decode`); the host frontier's non-fused branch,
  which splits the widest dims;
* the mesh branches (``parallel.mesh``): stage 0's certificate alone
  (:func:`role_certify`, rows 14 and 6) sharded over a mesh's ``parts``
  axis before the attack forward (:func:`split_certify_attack_submit`), Phase
  S's K8 batches sharded, and :func:`decide_many`'s BaB the host
  frontier's non-fused branch with its batches sharded;
* :func:`decide_many` / :func:`decide_box`;
* exact witness validation on the host (:func:`validate_pair`: float64
  first, then the native exact core, ``ops.exact_native``, or
  ``Fraction`` arithmetic).

Eight device kernels carry it: KB :func:`stage0_certify`
(``csrc/stage0_certify.cu``, with a model axis for stacked families, an
α-CROWN mode and the score output; launched alone as
:func:`role_certify`), KC :func:`attack_flips`
(``csrc/attack_flips.cu``, with a model axis), K5 :func:`pgd_attack_kernel`
(``csrc/pgd_attack.cu``), K6 :func:`bab_segment`
(``csrc/bab_segment.cu``), K8a :func:`sign_bound`
(``csrc/sign_bound.cu``), K8b :func:`inter_bounds`
(``csrc/inter_bounds.cu``), K10's role bounds :func:`role_logit_bounds`
(``csrc/role_bounds.cu``) and the masked forward of
``csrc/attack_logits.cu``, launched as K10's attack forward
:func:`attack_logits` and as Phase S's :func:`sample_role_logits`, each
beside its
plain PyTorch version, which the CPU tests run; Phases E0/E run the three
lattice kernels of ``ops/lattice.py``.

Launches follow the runtime contracts of ``parallel.pipeline``: Phase A's
K5 chunks ride a pipeline at ``pipeline_depth`` with a supervisor
(:func:`attack_phase`; the shared RNG stream is consumed at submit time),
the device BaB's K6 segments a depth-1 supervised pipeline
(:func:`device_bab_phase`), both on the ``launch.submit`` /
``launch.decode`` fault sites; each phase of :func:`decide_many` runs in
an ``engine.*`` span (``engine.attack``, ``engine.sign_bab``,
``engine.lattice_first``, ``engine.device_bab``, ``engine.bab``,
``engine.pair_lp``, ``engine.lattice``), as in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch

from fairify_tpu_torch import obs
from fairify_tpu_torch.models.mlp import StackedMLP, forward_np, local_affine_np
from fairify_tpu_torch.obs import funnel as funnel_mod
from fairify_tpu_torch.obs import launches
from fairify_tpu_torch.ops import crown as crown_ops
from fairify_tpu_torch.ops import exact_native
from fairify_tpu_torch.ops import interval as interval_ops
from fairify_tpu_torch.ops import lattice as lattice_ops
from fairify_tpu_torch.ops import lp as lp_ops
from fairify_tpu_torch.ops.interval import SOUND_SLACK_ABS, SOUND_SLACK_REL
from fairify_tpu_torch.parallel import mesh as mesh_mod
from fairify_tpu_torch.parallel.pipeline import LaunchPipeline, fetch, stage
from fairify_tpu_torch.resilience import integrity as integrity_mod
from fairify_tpu_torch.utils import cuda_build, prng
from fairify_tpu_torch.verify.config import EngineConfig
from fairify_tpu_torch.verify.property import (PairEncoding, role_boxes,
                                               shared_dims, valid_assignments)

F32_MAX = float(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# Certificate (KB)
# ---------------------------------------------------------------------------


def tied_diff_ub(A_pos, c_pos, A_neg, c_neg, lo, hi, shared_mask):
    """Upper bounds of (pos-form − neg-form) over tied shared coordinates.

    ``A_pos``/``c_pos``: (B, Vp, d)/(B, Vp) upper form of the role that must
    be positive; ``A_neg``/``c_neg``: lower form of the role that must be
    negative; ``lo``/``hi``: (B, d) shared box.  Returns the (B, Vp, Vn)
    bound matrix, the (B, d) largest coefficient magnitude |A_pos − A_neg|
    per shared dim over all pairs (the branching score) and the (B, Vp,
    Vn) magnitude (the concretized terms plus both forms' coefficient
    magnitudes, against which the outward slack is scaled);
    :func:`tied_diff_ub_keep` computes them.
    """
    alive = torch.zeros(A_pos.shape[:2] + A_neg.shape[1:2], dtype=torch.bool,
                        device=lo.device)
    M, coef, mag, _, _ = tied_diff_ub_keep(A_pos, c_pos, A_neg, c_neg, lo, hi,
                                           shared_mask, alive)
    return M, coef, mag


def certify_impl(net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals, pa_mask,
                 ra_mask, eps, valid, valid_pair, alpha_iters: int = 0,
                 with_scale: bool = False):
    """Plain PyTorch version of KB: ``(certified (B,), score (B, d), margin
    (B,))``, the JAX package's ``_certify_impl``.

    A box is certified iff every valid assignment pair has both flip
    directions killed, by a role bound or by the tied difference bound
    (each form set widened with its own magnitude); with ``alpha_iters >
    0`` the role bounds and a second form set are α-CROWN's.  ``score``
    is, per shared dim, the largest difference-form coefficient magnitude
    over every form set, direction and assignment pair (the host
    frontier's branching score).  ``margin >= 0`` iff certified; boxes
    without a valid pair get +FLT_MAX.

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
    score = torch.zeros_like(lo)
    for (Alx, clx, Aux, cux), (Alp, clp, Aup, cup) in zip(sets_x, sets_p):
        # Direction x⁺/x'⁻: needs f(x_a) − f(x'_b) > 0.
        m1, s1, g1 = tied_diff_ub(Aux, cux + pa_dot(Aux),
                                  Alp, clp + pa_dot(Alp) - ra_abs(Alp), lo, hi, shared)
        # Direction x⁻/x'⁺: needs f(x'_b) − f(x_a) > 0 (matrix built [b, a]).
        m2, s2, g2 = tied_diff_ub(Aup, cup + pa_dot(Aup) + ra_abs(Aup),
                                  Alx, clx + pa_dot(Alx), lo, hi, shared)
        w1 = widen(m1, g1)
        w2 = widen(m2, g2).transpose(-1, -2)
        ub1 = w1 if ub1 is None else torch.minimum(ub1, w1)
        ub2 = w2 if ub2 is None else torch.minimum(ub2, w2)
        score = torch.maximum(score, torch.maximum(s1, s2))
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
        return cert, score, margin, scale
    return cert, score, margin


def each_model(net, fn):
    """``fn(net)`` for a single net; for a ``StackedMLP``, ``fn`` of every
    model with each output tensor stacked on a leading model axis (the
    plain versions' model loop)."""
    if not isinstance(net, StackedMLP):
        return fn(net)
    return tuple(torch.stack(o) for o in zip(*(fn(m) for m in net.unstack())))


def stage0_certify(net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals, pa_mask,
                   ra_mask, eps: float, valid, valid_pair, alpha_iters: int = 0, live=None):
    """KB: the certificate of N boxes, one launch.

    Role boxes (N, V, d), partition boxes (N, d), encoding tensors
    ``assign_vals`` (V, d), ``pa_mask``/``ra_mask`` (d,), ``valid`` (N, V)
    and ``valid_pair`` (V, V) bool.  Returns ``(cert (N,) bool, score (N,
    d) float32, margin (N,) float32)`` (:func:`certify_impl`); for a
    ``StackedMLP`` of M models every output gains a leading M axis (the
    kernel's ``blockIdx.y``).  ``alpha_iters > 0`` runs α-CROWN.  ``live``
    (default N): boxes ``>= live`` get box ``live - 1``'s outputs
    (:func:`fill_past`).  CPU tensors take :func:`certify_impl` on every
    box and the same fill; CUDA tensors launch ``csrc/stage0_certify.cu``
    over the live boxes.
    """
    return _kb(stage0_certify, net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals,
               pa_mask, ra_mask, eps, valid, valid_pair, alpha_iters, live)


def role_certify(net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals, pa_mask,
                 ra_mask, eps: float, valid, valid_pair, alpha_iters: int = 0):
    """Rows 14 and 6: the certificate alone, ``(cert, score, margin)`` —
    the JAX package's ``_role_certify_kernel`` (``_certify_impl``) and,
    for a ``StackedMLP``, ``_family_certify_kernel`` (the same vmapped over
    the models), which run where the certificate and the attack are two
    launches: the mesh branches of stage 0 and of the host frontier.  The
    body is KB's (:func:`stage0_certify`'s inputs and outputs), launched
    and counted here."""
    return _kb(role_certify, net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals,
               pa_mask, ra_mask, eps, valid, valid_pair, alpha_iters)


def _kb(counter, net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals, pa_mask, ra_mask,
        eps: float, valid, valid_pair, alpha_iters: int, live=None):
    """KB's body for the wrapper ``counter``: :func:`certify_impl` on CPU
    tensors (and :func:`fill_past` past ``live``), else one launch of
    ``kb_stage0_certify`` over the live boxes, counted on ``counter``."""
    live = live_rows(counter.__name__, lo.shape[0], live)
    if lo.device.type == "cpu":
        out = each_model(net, lambda m: certify_impl(
            m, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals, pa_mask, ra_mask, eps,
            valid, valid_pair, alpha_iters))
        axis = 1 if isinstance(net, StackedMLP) else 0
        return tuple(fill_past(t, live, axis) for t in out)
    if net.layer_sizes[-1] != 1:
        raise ValueError(f"{counter.__name__}: the net must have one output logit")
    sig = (lo.shape[0], valid.shape[1], int(alpha_iters), live)
    with launches.launching(counter.__name__, sig):
        out = _kb_launch(net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals, pa_mask, ra_mask,
                         eps, valid, valid_pair, alpha_iters, live=live)
    return out


def _kb_launch(net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals, pa_mask, ra_mask,
               eps: float, valid, valid_pair, alpha_iters: int, live=None,
               _geometry_force=None):
    """One launch of ``kb_stage0_certify`` on CUDA tensors over the ``live``
    first boxes (default all; the geometry from :func:`kb_geometry`);
    ``_geometry_force`` (warps a block) forces it: the card's checks that
    the certificate does not depend on it."""
    params, dims, M = cuda_build.pack_odd_models(net)
    u8 = lambda t: t.to(torch.uint8).contiguous()
    ins = [t.contiguous() for t in (x_lo, x_hi, xp_lo, xp_hi, lo, hi,
                                    assign_vals, pa_mask, ra_mask)]
    vb, vp = u8(valid), u8(valid_pair)
    cuda_build.require_cuda(params, *ins, vb, vp)
    N, V = valid.shape
    d = lo.shape[1]
    dev = lo.device
    geo = _kb_geometry(tuple(dims), V, cuda_build.SMEM_LIMIT, _geometry_force)
    cert = torch.empty((M, N), dtype=torch.uint8, device=dev)
    score = torch.empty((M, N, d), dtype=torch.float32, device=dev)
    margin = torch.empty((M, N), dtype=torch.float32, device=dev)
    cuda_build.call("stage0_certify", "kb_stage0_certify",
                    cuda_build.ptr(params), dims, ctypes.c_int(net.depth),
                    ctypes.c_longlong(params.numel() // M),
                    *(cuda_build.ptr(t) for t in ins), ctypes.c_float(eps),
                    cuda_build.ptr(vb), cuda_build.ptr(vp), ctypes.c_int(N),
                    ctypes.c_int(V), ctypes.c_int(M), ctypes.c_int(N if live is None else live),
                    ctypes.c_int(int(alpha_iters)),
                    cuda_build.ptr(cert), cuda_build.ptr(score), cuda_build.ptr(margin),
                    ctypes.c_int(geo["warps"]), ctypes.c_longlong(geo["smem"]),
                    cuda_build.stream())
    out = (cert.bool(), score, margin)
    return out if isinstance(net, StackedMLP) else tuple(t[0] for t in out)





# ---------------------------------------------------------------------------
# Attack (KC)
# ---------------------------------------------------------------------------


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


def attack_flips_plain(net, xr, pr, valid, valid_pair, cert, margin, ok, live=None):
    """Plain PyTorch version of KC.

    ``xr``/``pr``: (N, S, V, d) candidates; ``cert``/``margin``: KB's
    outputs; ``ok`` (N,) rows counted in the histogram.  Returns ``(wit
    (N, 3) int32, reason (N,) int8, gap (N,) float32, stats (2, 14) int32,
    fold)``, the fold a 0-d int32 tensor (on the card it is fetched with
    the other outputs, never synchronised on alone).  For a
    ``StackedMLP`` every model attacks the same candidates:
    ``cert``/``margin`` and every output but the fold gain a leading model
    axis, and the fold covers all models' buffers.  ``live``
    (default N): what the kernel's launch over the first ``live`` boxes
    returns — the per-box outputs past it box ``live - 1``'s
    (:func:`fill_past`), the histogram of the live rows of ``ok`` and the
    fold of the live boxes' buffers.
    """
    N = xr.shape[0]
    live = N if live is None else live
    if live < N:
        ok = ok & (torch.arange(N, device=ok.device) < live)

    def one(m, c, mg):
        lx, lp = attack_logits_plain(m, xr, pr)
        found, wit = find_flips_impl(lx, lp, valid, valid_pair)
        gap = attack_gap_impl(lx, lp, valid, valid_pair)
        reason = (c.to(torch.int8) + 2 * found.to(torch.int8))
        return wit, reason, gap, chunk_stats(mg, gap, ok)

    if isinstance(net, StackedMLP):
        outs = [one(m, c, mg) for m, c, mg in zip(net.unstack(), cert, margin)]
        wit, reason, gap, stats = (torch.stack(o) for o in zip(*outs))
    else:
        wit, reason, gap, stats = one(net, cert, margin)
    axis = 1 if isinstance(net, StackedMLP) else 0
    wit, reason, gap = (fill_past(t, live, axis) for t in (wit, reason, gap))
    head = lambda t: t.narrow(axis, 0, live)
    fold = fold_int32(head(cert), head(wit), head(reason), stats)
    return wit, reason, gap, stats, torch.tensor(fold, dtype=torch.int32)


def attack_flips(net, xr, pr, valid, valid_pair, cert, margin, ok, live=None):
    """KC: the attack of N boxes, one launch (see :func:`attack_flips_plain`
    for the contract, stacked nets included: the kernel's ``blockIdx.y``
    is the model).  ``live`` (default N): boxes ``>= live`` are not
    attacked: their per-box outputs are box ``live - 1``'s and the
    histogram and fold cover the live boxes (:func:`attack_flips_plain`).  CUDA tensors launch
    ``csrc/attack_flips.cu`` (the geometry from
    :func:`attack_flips_geometry`); the histogram and fold accumulate with
    device atomics."""
    live = live_rows("attack_flips", xr.shape[0], live)
    if xr.device.type == "cpu":
        return attack_flips_plain(net, xr, pr, valid, valid_pair, cert, margin, ok, live)
    if net.layer_sizes[-1] != 1:
        raise ValueError("attack_flips: the net must have one output logit")
    with launches.launching("attack_flips", (tuple(xr.shape), live)):
        fn, args, out = _attack_flips_prepare(net, xr, pr, valid, valid_pair, cert, margin, ok,
                                              live)
        cuda_build.check("kc_attack_flips", fn(*args, torch.cuda.current_stream().cuda_stream))
    wit, reason, gap, stats, fold = out
    return wit, reason, gap, stats, fold[0]


# kc_attack_flips(params, dims, L, xr, pr, valid, vpair, cert, margin, okrow, edges,
# N, S, V, M, live, wit, reason, gap, stats, fold, tw, warps, gw, grid, smem, stream)
_KC_ARGS = ((ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int)
            + (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,) * 5
            + (ctypes.c_int,) * 4 + (ctypes.c_longlong, ctypes.c_void_p))


def _attack_flips_prepare(net, xr, pr, valid, valid_pair, cert, margin, ok, live: int,
                          _geometry_force=None):
    """``(entry point, its arguments but the stream, (wit, reason, gap,
    stats, fold) tensors)`` of one ``kc_attack_flips`` launch over the
    ``live`` first boxes: the padded pack of every model, the geometry from
    :func:`attack_flips_geometry`; ``_geometry_force`` (``(tw, warps,
    gw)``) forces it: the card's checks that the outputs do not depend on
    it."""
    params, dims, M = cuda_build.pack_padded(net)
    xr, pr, margin = xr.contiguous(), pr.contiguous(), margin.contiguous()
    vb, vp, cb, okb = (_bytes(t) for t in (valid, valid_pair, cert, ok))
    dev = xr.device
    edges = _edges(dev)
    cuda_build.require_cuda(params, xr, pr, vb, vp, cb, margin, okb, edges)
    N, S, V, _ = xr.shape
    geo = _attack_flips_geometry(tuple(dims), S, V, live, M, cuda_build.sm_count(dev),
                                 cuda_build.SMEM_LIMIT, _geometry_force)
    lead = (M,) if isinstance(net, StackedMLP) else ()
    wit = torch.empty(lead + (N, 3), dtype=torch.int32, device=dev)
    reason = torch.empty(lead + (N,), dtype=torch.int8, device=dev)
    gap = torch.empty(lead + (N,), dtype=torch.float32, device=dev)
    counts = torch.zeros(M * 2 * funnel_mod.N_BUCKETS + 1, dtype=torch.int32, device=dev)
    stats = counts[:-1].view(lead + (2, funnel_mod.N_BUCKETS))
    fold = counts[-1:]
    args = (params.data_ptr(), dims, len(dims) - 1, xr.data_ptr(), pr.data_ptr(),
            vb.data_ptr(), vp.data_ptr(), cb.data_ptr(), margin.data_ptr(), okb.data_ptr(),
            edges.data_ptr(), N, S, V, M, live, wit.data_ptr(), reason.data_ptr(),
            gap.data_ptr(), stats.data_ptr(), fold.data_ptr(), geo["tw"], geo["warps"],
            geo["gw"], geo["grid"], geo["smem"])
    return (cuda_build.entry("attack_flips", "kc_attack_flips", _KC_ARGS), args,
            (wit, reason, gap, stats, fold))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A bool or uint8 tensor as contiguous uint8 (a bool tensor's bytes
    viewed, not copied)."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t.to(torch.uint8)


_edges_on = {}


def _edges(dev) -> torch.Tensor:
    """The funnel's histogram edges on ``dev``, copied there once."""
    t = _edges_on.get(dev)
    if t is None:
        t = _edges_on[dev] = stage(funnel_mod.EDGES, dev)
    return t




def certify_attack(net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals, pa_mask,
                   ra_mask, eps: float, valid, valid_pair, xr, pr,
                   alpha_iters: int = 0, live=None):
    """Certificate + attack + flip detection of B boxes: the JAX package's
    ``_certify_attack_kernel`` (row 15; vmapped over a stacked family,
    ``_family_stage0_kernel``, row 7).  One KB launch
    (:func:`stage0_certify`, α-CROWN when ``alpha_iters > 0``) and one KC
    launch (:func:`attack_flips`, no histogram rows) on the card, their
    plain versions on the CPU.  ``live`` (default B): both cover the first
    ``live`` boxes and the rest get box ``live - 1``'s outputs
    (:func:`fill_past`).  Returns ``(cert (B,) bool, score (B, d) f32,
    found (B,) bool, wit (B, 3) int32, margin (B,) f32, gap (B,) f32)``,
    each with a leading model axis for a ``StackedMLP``."""
    cert, score, margin = stage0_certify(net, x_lo, x_hi, xp_lo, xp_hi, lo, hi,
                                         assign_vals, pa_mask, ra_mask, eps, valid,
                                         valid_pair, alpha_iters, live=live)
    no_rows = torch.zeros(lo.shape[0], dtype=torch.bool, device=lo.device)
    wit, reason, gap, _stats, _fold = attack_flips(net, xr, pr, valid, valid_pair,
                                                   cert, margin, no_rows, live=live)
    return cert, score, reason >= 2, wit, margin, gap


# ---------------------------------------------------------------------------
# The IBP path (K10): role-logit bounds (rows 13 and 8) and attack logits
# (rows 17 and 9) on the card; the certificate, margin, flips and gap on
# the host
# ---------------------------------------------------------------------------


def role_logit_bounds_plain(net, x_lo, x_hi, xp_lo, xp_hi, use_crown: bool):
    """Plain PyTorch version of :func:`role_logit_bounds`: the widened
    output-logit bounds of both roles' boxes, by CROWN
    (``ops.crown.crown_output_bounds``) or by IBP
    (``ops.interval.output_bounds``)."""
    bounds = (crown_ops.crown_output_bounds if use_crown
              else interval_ops.output_bounds)
    return each_model(net, lambda m: bounds(m, x_lo, x_hi) + bounds(m, xp_lo, xp_hi))


def role_logit_bounds(net, x_lo, x_hi, xp_lo, xp_hi, use_crown: bool, live=None):
    """Rows 13 and 8: ``(lb_x, ub_x, lb_p, ub_p)`` (..., V) of the role boxes
    (..., V, d) of both roles, one launch; a ``StackedMLP`` adds a leading
    model axis (the kernel's ``blockIdx.y``).  ``use_crown`` picks the CROWN
    bounds (as ``crown_bounds(widen=True)``), else the widened interval
    image.  ``live`` (default B, the boxes of the flattened leading axes):
    boxes ``>= live`` get box ``live - 1``'s bounds — what a full call
    returns for them when they repeat that box's inputs (:func:`_pad`).
    CPU tensors take :func:`role_logit_bounds_plain` on every box and the
    same fill; CUDA tensors launch ``csrc/role_bounds.cu`` over the live
    boxes only (the geometry from :func:`role_bounds_geometry`)."""
    shape = x_lo.shape[:-1]
    V = shape[-1] if len(shape) else 1
    B = x_lo.numel() // (x_lo.shape[-1] * V) if x_lo.shape[-1] else 0
    live = live_rows("role_logit_bounds", B, live)
    lead = (net.n_models,) if isinstance(net, StackedMLP) else ()
    if x_lo.device.type == "cpu":
        out = role_logit_bounds_plain(net, x_lo, x_hi, xp_lo, xp_hi, use_crown)
        if live < B:
            out = tuple(fill_past(t.reshape(lead + (B, V)), live, len(lead)).reshape(t.shape)
                        for t in out)
        return out
    if not (x_lo.shape == x_hi.shape == xp_lo.shape == xp_hi.shape):
        raise ValueError("role_logit_bounds: the four role-box tensors need one shape")
    with launches.launching("role_bounds", (B, V, live, bool(use_crown))):
        out = _role_bounds_launch(net, (x_lo, x_hi, xp_lo, xp_hi), B, V, live, use_crown)
    return out.view(lead + (4,) + shape).unbind(len(lead))


_VP, _INT = ctypes.c_void_p, ctypes.c_int
# k10_role_bounds(params, dims, L, xlo, xhi, plo, phi, B, V, M, live, use_crown,
# out, tw, warps, grid, smem, stream)
_K10B_ARGS = ((_VP, ctypes.POINTER(_INT), _INT) + (_VP,) * 4 + (_INT,) * 5 + (_VP,)
              + (_INT,) * 3 + (ctypes.c_longlong, _VP))
# k8b_inter_bounds(params, dims, L, lo, hi, B, live, out_lb, out_ub, warps, per,
# smem, stream)
_K8B_ARGS = ((_VP, ctypes.POINTER(_INT), _INT, _VP, _VP, _INT, _INT, _VP, _VP, _INT, _INT,
              ctypes.c_longlong, _VP))


def _role_bounds_launch(net, boxes, B: int, V: int, live: int, use_crown: bool,
                        _geometry_force=None):
    """One launch of ``k10_role_bounds`` over the ``live`` first of the B
    boxes of the role boxes ``boxes`` (x_lo, x_hi, xp_lo, xp_hi): one
    (M, 2 roles, 2 (lo, hi), B·V) tensor.  ``_geometry_force`` (IBP ``(tw,
    warps)``, CROWN warps) forces the geometry: the card's checks that the
    bounds do not depend on it."""
    fn, args, out = _role_bounds_prepare(net, boxes, B, V, live, use_crown, _geometry_force)
    cuda_build.check("k10_role_bounds", fn(*args, torch.cuda.current_stream().cuda_stream))
    return out


def _role_bounds_prepare(net, boxes, B: int, V: int, live: int, use_crown: bool,
                         _geometry_force=None):
    """``(entry point, its arguments but the stream, output tensor)`` of one
    ``k10_role_bounds`` launch: IBP reads the padded pack, CROWN the
    odd-stride pack of every model, the geometry from
    :func:`role_bounds_geometry`."""
    crown = bool(use_crown)
    params, dims, M = (cuda_build.pack_odd_models if crown else cuda_build.pack_padded)(net)
    if dims[len(dims) - 1] != 1:
        raise ValueError("role_logit_bounds: the net must have one output logit")
    ins = [t.contiguous() for t in boxes]
    cuda_build.require_cuda(params, *ins)
    dev = ins[0].device
    geo = _role_bounds_geometry(tuple(dims), V, 2 * live * V, M, crown,
                                cuda_build.sm_count(dev), cuda_build.SMEM_LIMIT,
                                _geometry_force)
    out = torch.empty((M, 2, 2, B * V), dtype=torch.float32, device=dev)
    args = (params.data_ptr(), dims, len(dims) - 1, *(t.data_ptr() for t in ins), B, V, M,
            live, int(crown), out.data_ptr(), geo["tw"], geo["warps"], geo["grid"],
            geo["smem"])
    return cuda_build.entry("role_bounds", "k10_role_bounds", _K10B_ARGS), args, out




# ---------------------------------------------------------------------------
# Launch geometry of the warp-tile kernels (csrc/warp_tile.cuh): the
# attack forward (rows 17, 9, 21) and the PGD attack (K5)
# ---------------------------------------------------------------------------

AL_TW = 16  # rows of an attack-forward warp tile
AL_MAX_WARPS = 12  # csrc/attack_logits.cu
K5_MAX_ROWS = 16  # rows of a PGD warp tile, at most (TTW trajectories x 2V)
K5_MAX_WARPS = 8  # csrc/pgd_attack.cu


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _fit_warps(smem, cap: int, limit: int) -> int:
    """The most warps, at most ``cap``, whose ``smem(warps)`` fits."""
    w = cap
    while w > 0 and smem(w) > limit:
        w -= 1
    if w < 1:
        raise ValueError(f"one warp's tiles need {smem(1)} bytes of shared memory, "
                         f"more than {limit}")
    return w


def attack_logits_smem(sizes, tw: int, warps: int) -> int:
    """Bytes of dynamic shared memory of one attack-forward block
    (``attack_logits.cu:al_smem``): the mbarrier's 16, the padded net's
    forward part, per warp two input tiles and the two hidden buffers
    (hidden layer l's output in buffer l % 2)."""
    h = [0, 0]
    for l in range(len(sizes) - 2):
        h[l & 1] = max(h[l & 1], sizes[l + 1])
    fwd = cuda_build.pad_layout(sizes)["fwd"]
    return 4 * (4 + fwd + warps * (2 * sizes[0] + h[0] + h[1]) * tw)


def attack_logits_geometry(sizes, rows: int, models: int = 1, sms: int = 132,
                           smem_limit: int = cuda_build.SMEM_LIMIT, _force=None) -> dict:
    """Launch geometry of ``csrc/attack_logits.cu`` for ``rows`` candidate
    rows (both roles) of ``models`` models on a card of ``sms`` SMs: warp
    tiles of ``tw`` rows; warps per block enough to give each SM its share
    (at most AL_MAX_WARPS and what shared memory holds); blocks per model so
    that the grid fills the card (``grid``; ``blocks`` in all).  ``_force``
    (``(tw, warps)``) overrides the two choices."""
    tw = AL_TW if _force is None else int(_force[0])
    wmax = _fit_warps(lambda w: attack_logits_smem(sizes, tw, w), AL_MAX_WARPS, smem_limit)
    tiles = _ceil(rows, tw)
    if _force is None:
        warps = min(max(_ceil(tiles * models, sms), 1), wmax)
    else:
        warps = int(_force[1])
        if not 1 <= warps <= wmax:
            raise ValueError(f"attack_logits: {warps} warps of {tw} rows do not fit")
    grid = max(1, min(_ceil(tiles, warps), _ceil(sms, models)))
    return dict(tw=tw, warps=warps, threads=32 * warps, grid=grid, blocks=grid * models,
                smem=attack_logits_smem(sizes, tw, warps), tiles=tiles)


KC_TW = 16  # rows of a KC warp tile
KC_MAX_WARPS = 12  # csrc/attack_flips.cu
KC_MAX_GROUP = 8  # warps that may share one box


def attack_flips_smem(sizes, S: int, V: int, tw: int, warps: int, gw: int = 1) -> int:
    """Bytes of dynamic shared memory of one KC block
    (``attack_flips.cu:kc_smem``): the mbarrier's 16 and the block's 28
    histogram bins and fold (rounded up to 144 bytes in all), the padded
    net's forward part, per warp two input tiles and the two hidden buffers
    (:func:`attack_logits_smem`'s), and per group of ``gw`` warps one box's
    2 S V logits (rounded up to 4 floats)."""
    h = [0, 0]
    for l in range(len(sizes) - 2):
        h[l & 1] = max(h[l & 1], sizes[l + 1])
    fwd = cuda_build.pad_layout(sizes)["fwd"]
    return 4 * (36 + fwd + warps * (2 * sizes[0] + h[0] + h[1]) * tw
                + warps // gw * _r4(2 * S * V))


def attack_flips_geometry(sizes, S: int, V: int, boxes: int, models: int = 1,
                          sms: int = 132, smem_limit: int = cuda_build.SMEM_LIMIT,
                          _force=None) -> dict:
    """Launch geometry of KC for ``boxes`` live boxes of ``S`` samples and
    ``V`` assignments (``tiles`` = 2 S V / ``tw`` warp tiles a box) and
    ``models`` models on a card of ``sms`` SMs.  A box belongs to a group of
    ``gw`` warps (a power of two at most KC_MAX_GROUP and the box's tiles),
    which split its tiles; a block holds the most warps, a multiple of
    ``gw`` at most KC_MAX_WARPS, that shared memory holds.  ``gw`` is the
    one that minimises the rounds of boxes a group takes times the tiles a
    warp carries per box, ceil(boxes·models / groups on the card) ·
    ceil(tiles / gw), the smallest on a tie: two at AC-S1 widths on an AC
    segment or chunk (a group shares one strip of logits, so 12 warps fit
    a block where 11 would alone), four for the host frontier's few live
    boxes of 4 tiles, which spread a box over the card.  Then only as many groups a block as give each
    SM its share, and ``grid`` blocks a model, at most one an SM.
    ``_force`` (``(tw, warps, gw)``) overrides the choice; a geometry that
    does not fit raises."""
    tw = KC_TW if _force is None else int(_force[0])
    if tw < 4 or tw % 4 or tw > 64:
        raise ValueError(f"attack_flips: a warp tile of {tw} rows")
    tiles = _ceil(2 * S * V, tw)
    units = max(boxes * models, 1)

    def most(gw: int) -> int:  # the most warps, a multiple of gw, that fit
        w = KC_MAX_WARPS // gw * gw
        while w >= gw and attack_flips_smem(sizes, S, V, tw, w, gw) > smem_limit:
            w -= gw
        return w

    if _force is None:
        best = None
        gw = 1
        while gw <= min(KC_MAX_GROUP, tiles):
            w = most(gw)
            if w >= gw:
                cost = _ceil(units, sms * (w // gw)) * _ceil(tiles, gw)
                if best is None or cost < best[0]:
                    best = (cost, gw, w)
            gw *= 2
        if best is None:
            raise ValueError(f"attack_flips: one warp's tiles need "
                             f"{attack_flips_smem(sizes, S, V, tw, 1)} bytes of shared "
                             f"memory, more than {smem_limit}")
        _, gw, wmax = best
        warps = min(_ceil(units, sms), wmax // gw) * gw
    else:
        warps, gw = int(_force[1]), int(_force[2])
        if not (1 <= gw <= KC_MAX_GROUP and 1 <= warps <= KC_MAX_WARPS and warps % gw == 0
                and attack_flips_smem(sizes, S, V, tw, warps, gw) <= smem_limit):
            raise ValueError(f"attack_flips: {warps} warps of {tw} rows in groups of {gw} "
                             "do not fit")
    groups = warps // gw
    grid = max(1, min(_ceil(boxes, groups), _ceil(sms, models)))
    return dict(tw=tw, warps=warps, gw=gw, groups=groups, threads=32 * warps, grid=grid,
                blocks=grid * models, smem=attack_flips_smem(sizes, S, V, tw, warps, gw),
                tiles=tiles)


def pgd_smem(sizes, ttw: int, tw: int, warps: int) -> int:
    """Bytes of dynamic shared memory of one K5 block
    (``pgd_attack.cu:k5_smem``): the mbarrier's 16, the whole padded net,
    and per warp the input tile, the two activation buffers (hidden layer
    l's output in buffer l % 2, layer l's input gradients in (L - 1 - l) %
    2), the logit adjoints and logits, the ReLU' sign bits (2 words per
    lane and pass of each hidden layer's tile) and 4 x TTW x d of
    trajectory state, rounded up to 16 bytes."""
    L, d = len(sizes) - 1, sizes[0]
    h = [0, 0]
    for l in range(L):
        if l + 1 < L:
            h[l & 1] = max(h[l & 1], sizes[l + 1])
        g = (L - 1 - l) & 1
        h[g] = max(h[g], sizes[l])
    bits = sum(64 * cuda_build.tile_passes(n, tw) for n in sizes[1:-1])
    per = _ceil((d + h[0] + h[1] + 2) * tw + bits + 4 * ttw * d, 4) * 4
    return 4 * (4 + cuda_build.pad_layout(sizes)["total"] + warps * per)


def pgd_geometry(sizes, n_traj: int, V: int, sms: int = 132,
                 smem_limit: int = cuda_build.SMEM_LIMIT, _force=None) -> dict:
    """Launch geometry of K5 for ``n_traj`` trajectories (boxes x restarts)
    with V assignments on a card of ``sms`` SMs, from the work: ``ttw`` =
    clamp(ceil(n_traj / (SMs x K5_MAX_WARPS)), 1, K5_MAX_ROWS // 2V)
    trajectories per warp tile of ``tw`` (= 2V x ttw rounded up to 4) rows;
    warps per block enough to give each SM its share (at most K5_MAX_WARPS
    and what shared memory holds); then ``grid`` blocks, at most one per
    SM.  So B = 1 (96 trajectories) runs one trajectory per warp on 96
    blocks, and B = 2,048 full tiles on every SM.  ``_force`` (``(ttw,
    warps)``) overrides the two choices."""
    ttw_max = max(1, K5_MAX_ROWS // (2 * V))
    if _force is None:
        ttw = min(max(_ceil(n_traj, sms * K5_MAX_WARPS), 1), ttw_max)
    else:
        ttw = int(_force[0])
    tw = _ceil(ttw * 2 * V, 4) * 4
    wmax = _fit_warps(lambda w: pgd_smem(sizes, ttw, tw, w), K5_MAX_WARPS, smem_limit)
    tiles = _ceil(n_traj, ttw)
    if _force is None:
        warps = min(max(_ceil(tiles, sms), 1), wmax)
    else:
        warps = int(_force[1])
        if not 1 <= warps <= wmax:
            raise ValueError(f"pgd_attack: {warps} warps of {ttw} trajectories do not fit")
    grid = max(1, min(_ceil(tiles, warps), sms))
    return dict(ttw=ttw, tw=tw, warps=warps, threads=32 * warps, grid=grid,
                smem=pgd_smem(sizes, ttw, tw, warps), tiles=tiles)


K6_MAX_WARPS = 16  # csrc/bab_segment.cu
# Live slots at a segment's start up to which K6 takes its latency geometry
# (on an H100 at AC-S1 widths: 1 and 8 live roots ran 10-25% faster on
# 16 warps, one block an SM; 32 and 128 on the throughput geometry).
K6_FEW_LIVE = 16
# Warps one SM holds at the register cap of K6, K8a and KB
# (__launch_bounds__ of 512 threads: at most 128 registers a thread, 65,536
# an SM).
K6_SM_WARPS = 16


def _per_sm(smem: int, warps: int) -> int:
    """Blocks of ``smem`` bytes and ``warps`` warps one SM holds (each block
    also takes 1,024 bytes; 512-thread launch bounds)."""
    return min(cuda_build.SMEM_PER_SM // (smem + 1024), K6_SM_WARPS // warps)


def _r4(v: int) -> int:
    return _ceil(v, 4) * 4


def bab_smem(sizes, V: int, warps: int) -> int:
    """Bytes of dynamic shared memory of one K6 block
    (``bab_segment.cu:k6_layout``): the mbarrier's 16; the odd-stride net
    (``cuda_build.odd_layout``); per role box (2V) its widened bounds and
    their relaxation (5 nsum), IBP bounds (2 maxw) and box (2d); per warp
    the larger of the CROWN column pair's 8 maxw and the α side's 2 nsum +
    d + 3 maxw; the slot's two form sets (4V (2d + 10)), pair bounds
    (4V^2), box vectors (7d), probe activations (2 V maxw), validity (V), α
    best bounds (4V) and 8 flags; every part rounded up to 4 floats."""
    d, nsum, maxw = sizes[0], sum(sizes[1:]), max(sizes)
    fl = (4 + cuda_build.odd_layout(sizes)["padded"]
          + 2 * V * _r4(5 * nsum + 2 * maxw + 2 * d)
          + warps * _r4(max(8 * maxw, 2 * nsum + d + 3 * maxw))
          + _r4(4 * V * (2 * d + 10)) + _r4(4 * V * V) + _r4(7 * d)
          + 2 * _r4(V * maxw) + _r4(V) + _r4(4 * V) + 8)
    return 4 * fl


def bab_geometry(sizes, V: int, Qs: int, sms: int = 132,
                 smem_limit: int = cuda_build.SMEM_LIMIT, _force=None, live=None) -> dict:
    """Launch geometry of K6 for a Qs-slot queue with V assignments on a
    card of ``sms`` SMs: one slot a block at a time, 4V warps a block (one
    per α side of every role box; at least 4, at most K6_MAX_WARPS and what
    shared memory holds), as many blocks per SM as shared memory and the
    register cap allow, and the grid every resident block (at most Qs): a
    cooperative launch must hold all of them at once.  A segment that
    starts with at most K6_FEW_LIVE live slots (``live``) is bound by one
    slot's critical path, not by the card's throughput: it takes the most
    warps that fit, one block an SM.  ``_force`` (``(warps, blocks per
    SM)``) overrides the choice; a geometry that does not fit raises."""
    few = _force is None and live is not None and live <= K6_FEW_LIVE
    cap = K6_MAX_WARPS if _force is not None or few else min(K6_MAX_WARPS, max(4, 4 * V))
    wmax = _fit_warps(lambda w: bab_smem(sizes, V, w), cap, smem_limit)
    warps = wmax if _force is None else int(_force[0])
    if not 1 <= warps <= wmax:
        raise ValueError(f"bab_segment: {warps} warps do not fit in shared memory")
    smem = bab_smem(sizes, V, warps)
    per_max = _per_sm(smem, warps)
    per_sm = (1 if few else per_max) if _force is None else int(_force[1])
    if not 1 <= per_sm <= per_max:
        raise ValueError(f"bab_segment: {per_sm} blocks of {warps} warps per SM do not fit "
                         f"(at most {per_max})")
    return dict(warps=warps, threads=32 * warps, per_sm=per_sm,
                grid=max(1, min(Qs, per_sm * sms)), smem=smem)


KB_MAX_WARPS = 16  # csrc/stage0_certify.cu
K8A_MAX_WARPS = 16  # csrc/sign_bound.cu


def kb_smem(sizes, V: int, warps: int) -> int:
    """Bytes of dynamic shared memory of one KB block
    (``stage0_certify.cu:kb_layout``): the mbarrier's 16; the odd-stride net
    (``cuda_build.odd_layout``); per role box (2V) its widened bounds and
    their relaxation (5 nsum), IBP bounds (2 maxw) and box (2d); per warp
    the larger of the CROWN column pair's 8 maxw and the α side's 2 nsum +
    d + 3 maxw; both form sets (4V (2d + 10)), the box vectors (4d), the α
    best bounds (4V), 32 floats of reduction scratch and the flag; every
    part rounded up to 4 floats."""
    d, nsum, maxw = sizes[0], sum(sizes[1:]), max(sizes)
    fl = (4 + cuda_build.odd_layout(sizes)["padded"]
          + 2 * V * _r4(5 * nsum + 2 * maxw + 2 * d)
          + warps * _r4(max(8 * maxw, 2 * nsum + d + 3 * maxw))
          + _r4(4 * V * (2 * d + 10)) + _r4(4 * d) + _r4(4 * V) + 32 + 4)
    return 4 * fl


def kb_geometry(sizes, V: int, smem_limit: int = cuda_build.SMEM_LIMIT, _force=None) -> dict:
    """Launch geometry of KB (one block per box and model) with V
    assignments: 4V warps a block (one per α side of every role box; at
    least 4, at most KB_MAX_WARPS and what shared memory holds), and the
    blocks an SM holds (``per_sm``).  ``_force`` (warps) overrides the
    choice; a geometry that does not fit raises."""
    cap = KB_MAX_WARPS if _force is not None else min(KB_MAX_WARPS, max(4, 4 * V))
    wmax = _fit_warps(lambda w: kb_smem(sizes, V, w), cap, smem_limit)
    warps = wmax if _force is None else int(_force)
    if not 1 <= warps <= wmax:
        raise ValueError(f"stage0_certify: {warps} warps do not fit in shared memory")
    smem = kb_smem(sizes, V, warps)
    return dict(warps=warps, threads=32 * warps, smem=smem, per_sm=_per_sm(smem, warps))


def sign_bound_smem(sizes, warps: int) -> int:
    """Bytes of dynamic shared memory of one K8a block
    (``sign_bound.cu:sb_layout``): the mbarrier's 16; the odd-stride net;
    the box (2d); six per-layer vectors (6 maxw); eleven per-neuron vectors
    (bounds, relaxation, split signs, α/β: 11 nsum) and four gradient sums
    (4 nsum); the flag; the warps' workspaces, carved per layer k >= 1 for
    the warps that have a column pair there, each 4 maxw + 8 n_k + 4d (n_k
    the units of the layers before k), the most any layer needs; every part
    rounded up to 4 floats."""
    d, nsum, maxw = sizes[0], sum(sizes[1:]), max(sizes)
    ws = max([min(warps, (sizes[k + 1] + 1) // 2)
              * _r4(4 * maxw + 8 * sum(sizes[1:k + 1]) + 4 * d)
              for k in range(1, len(sizes) - 1)] or [0])
    fl = (4 + cuda_build.odd_layout(sizes)["padded"] + _r4(2 * d) + _r4(6 * maxw)
          + _r4(11 * nsum) + _r4(4 * nsum) + 4 + ws)
    return 4 * fl


def sign_bound_geometry(sizes, live=None, sms: int = 132,
                        smem_limit: int = cuda_build.SMEM_LIMIT, _force=None) -> dict:
    """Launch geometry of K8a (one block per live box): warps a block, a
    power of two at most one per column pair of the widest layer past the
    first (K8A_MAX_WARPS and what shared memory holds): the most at which
    two blocks fit an SM with at least 4 warps each, so that one box's
    narrow layers overlap another's (on an H100 at AC-S1, B = 512: 4 warps,
    two blocks an SM, 4.07 ms against 4.38 at 16 warps and 4.92 at 8, one
    block an SM), else the most that fit.  A launch of at most ``sms`` live
    boxes is one box's critical path: it takes the most warps (16 at AC-S1:
    1.18-1.31 ms against 1.34-1.48 at 8).  ``per_sm``: the blocks an SM
    holds.  ``_force`` (warps) overrides the choice; a geometry that does
    not fit raises."""
    pairs = max([(n + 1) // 2 for n in sizes[2:]] or [1])
    cap = K8A_MAX_WARPS if _force is not None else min(K8A_MAX_WARPS, pairs)
    wmax = _fit_warps(lambda w: sign_bound_smem(sizes, w), cap, smem_limit)
    if _force is None:
        per = lambda w: _per_sm(sign_bound_smem(sizes, w), w)
        pow2 = [1 << i for i in range(wmax.bit_length()) if 1 << i <= wmax]
        two = [w for w in pow2 if w >= 4 and per(w) >= 2]
        few = live is not None and live <= sms
        warps = max(two) if two and not few else max(pow2)
    else:
        warps = int(_force)
        if not 1 <= warps <= wmax:
            raise ValueError(f"sign_bound: {warps} warps do not fit in shared memory")
    smem = sign_bound_smem(sizes, warps)
    return dict(warps=warps, threads=32 * warps, smem=smem, per_sm=_per_sm(smem, warps))


K8B_MAX_WARPS = 16  # csrc/inter_bounds.cu


def inter_bounds_smem(sizes, per: int, warps: int) -> int:
    """Bytes of dynamic shared memory of one K8b block
    (``inter_bounds.cu:ib_layout``): the mbarrier's 16; the odd-stride net
    (``cuda_build.odd_layout``); per box (``per``) its widened bounds and
    their relaxation (5 nsum), IBP bounds (2 maxw) and box (2d); per warp a
    column pair's 8 maxw; every part rounded up to 4 floats."""
    d, nsum, maxw = sizes[0], sum(sizes[1:]), max(sizes)
    fl = (4 + cuda_build.odd_layout(sizes)["padded"] + per * _r4(5 * nsum + 2 * maxw + 2 * d)
          + warps * _r4(8 * maxw))
    return 4 * fl


def inter_bounds_geometry(sizes, live: int, sms: int = 132,
                          smem_limit: int = cuda_build.SMEM_LIMIT, _force=None) -> dict:
    """Launch geometry of K8b over ``live`` boxes: warps a block, boxes a
    block (``per``; the grid is ``ceil(live / per)`` blocks), shared memory
    and the blocks an SM holds (``per_sm``).  At most ``sms`` live boxes
    (Phase P's 2V role boxes, a small Phase-L block) are one box's critical
    path: one box a block and a warp per column pair of the widest layer
    past the first (at most K8B_MAX_WARPS and what shared memory holds: 16
    at AC-S1).  More boxes take half the warps an SM holds at the register
    cap (at most one per column pair), so that two blocks share an SM, and
    as many boxes a block as make the grid one wave at two blocks an SM
    while two still fit (at AC-S1, B = 512: 8 warps, 2 boxes, 256 blocks).
    ``_force`` (``(warps, per)``) overrides the choice; a geometry that
    does not fit raises."""
    pairs = max([(n + 1) // 2 for n in sizes[2:]] or [1])
    if _force is not None:
        warps, per = int(_force[0]), int(_force[1])
        if not (1 <= warps <= K8B_MAX_WARPS and per >= 1) or \
                inter_bounds_smem(sizes, per, warps) > smem_limit:
            raise ValueError(f"inter_bounds: {per} boxes and {warps} warps a block do not fit "
                             "in shared memory")
    elif live <= sms:
        per = 1
        warps = _fit_warps(lambda w: inter_bounds_smem(sizes, 1, w),
                           min(K8B_MAX_WARPS, pairs), smem_limit)
    else:
        warps = _fit_warps(lambda w: inter_bounds_smem(sizes, 1, w),
                           min(K6_SM_WARPS // 2, pairs), smem_limit)
        per, want = 1, _ceil(live, 2 * sms)
        while per < want and _per_sm(inter_bounds_smem(sizes, per + 1, warps), warps) >= 2:
            per += 1
    smem = inter_bounds_smem(sizes, per, warps)
    return dict(warps=warps, threads=32 * warps, per=per, smem=smem,
                per_sm=_per_sm(smem, warps))


K10B_MAX_WARPS = 16  # csrc/role_bounds.cu
RB_TW = (16, 8, 4)  # role boxes of a row-13 IBP warp tile, largest first
RB_SM_WARPS = 8  # warps an SM the IBP tile is chosen to keep busy


def role_bounds_smem(sizes, V: int, tw: int, warps: int, use_crown: bool = False) -> int:
    """Bytes of dynamic shared memory of one row-13 block
    (``role_bounds.cu:k10b_smem``).  IBP: the mbarrier's 16, the padded
    net's forward part (``cuda_build.pad_layout``), per warp both interval
    buffers (lo and hi) of ``tw`` role boxes — buffer 0 the widest even
    hidden layer, buffer 1 the widest of the input and the odd hidden
    layers.  CROWN: the mbarrier's 16, the odd-stride net, per role box
    (2V) its widened bounds and their relaxation (5 nsum), IBP bounds (2
    maxw) and box (2d), per warp a column pair's 8 maxw; every part rounded
    up to 4 floats."""
    if use_crown:
        d, nsum, maxw = sizes[0], sum(sizes[1:]), max(sizes)
        return 4 * (4 + cuda_build.odd_layout(sizes)["padded"]
                    + 2 * V * _r4(5 * nsum + 2 * maxw + 2 * d) + warps * _r4(8 * maxw))
    h = [0, sizes[0]]
    for l in range(len(sizes) - 2):
        h[l & 1] = max(h[l & 1], sizes[l + 1])
    return 4 * (4 + cuda_build.pad_layout(sizes)["fwd"] + warps * 2 * (h[0] + h[1]) * tw)


def role_bounds_geometry(sizes, V: int, rows: int, models: int = 1, use_crown: bool = False,
                         sms: int = 132, smem_limit: int = cuda_build.SMEM_LIMIT,
                         _force=None) -> dict:
    """Launch geometry of rows 13 and 8 over ``rows`` live role boxes (both
    roles, 2 x live boxes x V) of ``models`` models on a card of ``sms``
    SMs.  IBP: warp tiles of ``tw`` role boxes, the largest of RB_TW whose
    tiles give every SM RB_SM_WARPS warps while a block of K10B_MAX_WARPS
    of them fits (else the smallest); warps a block enough to give each SM
    its share (at most K10B_MAX_WARPS and what shared memory holds);
    ``grid`` blocks a model, at most the blocks the SMs hold.  So the host
    frontier's F = 512 (2,048 role boxes at V = 2) runs one 4-box tile a
    warp on 128 blocks of 4 warps, and a 2,048-box AC-S1 chunk (8,192 role
    boxes, one model or four) 4-box tiles on 16 warps a block.  CROWN: one block a box and model, 4V warps (one per α side, as
    KB; at least 4, at most K10B_MAX_WARPS and what fits).  ``_force``
    (IBP ``(tw, warps)``, CROWN warps) overrides the choice; a geometry
    that does not fit raises."""
    smem_of = lambda t, w: role_bounds_smem(sizes, V, t, w, use_crown)
    if use_crown:
        cap = K10B_MAX_WARPS if _force is not None else min(K10B_MAX_WARPS, max(4, 4 * V))
        wmax = _fit_warps(lambda w: smem_of(0, w), cap, smem_limit)
        warps = wmax if _force is None else int(_force)
        if not 1 <= warps <= wmax:
            raise ValueError(f"role_bounds: {warps} warps do not fit in shared memory")
        smem = smem_of(0, warps)
        return dict(tw=0, warps=warps, threads=32 * warps, smem=smem,
                    per_sm=_per_sm(smem, warps), grid=0)
    if _force is None:
        tw = next((t for t in RB_TW if _ceil(rows, t) * models >= sms * RB_SM_WARPS
                   and smem_of(t, K10B_MAX_WARPS) <= smem_limit), RB_TW[-1])
    else:
        tw = int(_force[0])
        if tw < 4 or tw % 4 or tw > 64:
            raise ValueError(f"role_bounds: a warp tile of {tw} role boxes")
    wmax = _fit_warps(lambda w: smem_of(tw, w), K10B_MAX_WARPS, smem_limit)
    tiles = _ceil(rows, tw)
    if _force is None:
        warps = min(max(_ceil(tiles * models, sms), 1), wmax)
    else:
        warps = int(_force[1])
        if not 1 <= warps <= wmax:
            raise ValueError(f"role_bounds: {warps} warps of {tw} role boxes do not fit")
    smem = smem_of(tw, warps)
    per_sm = _per_sm(smem, warps)
    grid = max(1, min(_ceil(tiles, warps), _ceil(per_sm * sms, models)))
    return dict(tw=tw, warps=warps, threads=32 * warps, smem=smem, per_sm=per_sm, grid=grid,
                tiles=tiles)


K7_MAX_WARPS = 16  # csrc/role_bounds.cu
K7_MAX_PER = K7_MAX_WARPS // 2  # boxes a K7 block whose α sides each get a warp


def k7_smem(sizes, per: int, warps: int) -> int:
    """Bytes of dynamic shared memory of one K7 block
    (``role_bounds.cu:k7_layout``): the mbarrier's 16; the odd-stride net
    (``cuda_build.odd_layout``); per box (``per``) its widened bounds and
    their relaxation (5 nsum), IBP bounds (2 maxw) and box (2d); per warp
    the larger of the CROWN column pair's 8 maxw and the α side's 2 nsum +
    d + 3 maxw; both form sets of every box (2 per (2d + 4)) and the α best
    bounds (2 per); every part rounded up to 4 floats."""
    d, nsum, maxw = sizes[0], sum(sizes[1:]), max(sizes)
    fl = (4 + cuda_build.odd_layout(sizes)["padded"] + per * _r4(5 * nsum + 2 * maxw + 2 * d)
          + warps * _r4(max(8 * maxw, 2 * nsum + d + 3 * maxw))
          + _r4(2 * per * (2 * d + 4)) + _r4(2 * per))
    return 4 * fl


def k7_geometry(sizes, B: int, sms: int = 132, smem_limit: int = cuda_build.SMEM_LIMIT,
                _force=None) -> dict:
    """Launch geometry of K7 over B boxes on a card of ``sms`` SMs: ``per``
    boxes a block, the fewest that let one wave of blocks, one an SM, cover
    B (so B = 512 takes 4 boxes a block on 128 of 132 SMs), at most
    K7_MAX_PER and what shared memory holds with a warp for each α side
    (2 per warps); and the most warps that fit, at most K7_MAX_WARPS (the
    column-pair stage spreads over all of them, the α stage over 2 per).
    ``grid`` = ceil(B / per) blocks, ``per_sm`` the blocks an SM holds.
    ``_force`` (``(per, warps)``) overrides the choice; a geometry that does
    not fit raises."""
    if _force is not None:
        per, warps = int(_force[0]), int(_force[1])
        if not (per >= 1 and 1 <= warps <= K7_MAX_WARPS) or \
                k7_smem(sizes, per, warps) > smem_limit:
            raise ValueError(f"alpha_crown_output_bounds: {per} boxes and {warps} warps a "
                             "block do not fit in shared memory")
    else:
        per = max(1, min(_ceil(B, sms), K7_MAX_PER))
        while per > 1 and k7_smem(sizes, per, 2 * per) > smem_limit:
            per -= 1
        warps = _fit_warps(lambda w: k7_smem(sizes, per, w), K7_MAX_WARPS, smem_limit)
    smem = k7_smem(sizes, per, warps)
    return dict(per=per, warps=warps, threads=32 * warps, smem=smem,
                per_sm=_per_sm(smem, warps), grid=_ceil(B, per))


# The wrappers' geometry, computed once per shape (hashable arguments; the
# returned dicts are shared and read only).
_attack_logits_geometry = functools.lru_cache(maxsize=256)(attack_logits_geometry)
_attack_flips_geometry = functools.lru_cache(maxsize=256)(attack_flips_geometry)
_pgd_geometry = functools.lru_cache(maxsize=256)(pgd_geometry)
_bab_geometry = functools.lru_cache(maxsize=256)(bab_geometry)
_kb_geometry = functools.lru_cache(maxsize=256)(kb_geometry)
_sign_bound_geometry = functools.lru_cache(maxsize=256)(sign_bound_geometry)
_inter_bounds_geometry = functools.lru_cache(maxsize=256)(inter_bounds_geometry)
_role_bounds_geometry = functools.lru_cache(maxsize=256)(role_bounds_geometry)
_k7_geometry = functools.lru_cache(maxsize=256)(k7_geometry)


def attack_logits_plain(net, x_roles, xp_roles):
    """Plain PyTorch version of :func:`attack_logits`: the forward logits of
    attack candidates, (..., V, d) → (..., V); a ``StackedMLP`` gives every
    model's logits on a leading model axis."""
    return net(x_roles), net(xp_roles)


def attack_logits(net, x_roles, xp_roles):
    """Rows 17 and 9: the masked forward logit of every attack candidate of
    both roles, (..., d) → (...), one launch; for a ``StackedMLP`` every
    model reads the same candidates and the outputs gain a leading model
    axis.  CPU tensors take :func:`attack_logits_plain`; CUDA tensors launch
    ``csrc/attack_logits.cu``."""
    if x_roles.device.type == "cpu":
        return attack_logits_plain(net, x_roles, xp_roles)
    if net.layer_sizes[-1] != 1:
        raise ValueError("attack_logits: the net must have one output logit")
    if x_roles.shape != xp_roles.shape:
        raise ValueError("attack_logits: both role tensors need one shape")
    with launches.launching("attack_logits", (tuple(x_roles.shape),)):
        out = _launch_attack_logits(net, x_roles, xp_roles, None)
    return out


def _launch_attack_logits(net, x_roles, xp_roles, models, _geometry_force=None):
    """One launch of ``k10_attack_logits`` on CUDA role tensors; ``models``
    must match the packed net's model count when given.  ``_geometry_force``
    (``(tw, warps)``) forces the launch geometry: the card's checks that
    the logits do not depend on it."""
    params, dims, M = cuda_build.pack_padded(net)
    if models is not None and M != models:
        raise ValueError(f"expected {models} model(s), got {M}")
    x, xp = x_roles.contiguous(), xp_roles.contiguous()
    cuda_build.require_cuda(params, x, xp)
    n = x.numel() // x.shape[-1]
    geo = _attack_logits_geometry(tuple(dims), 2 * n, M, cuda_build.sm_count(x.device),
                                  cuda_build.SMEM_LIMIT, _geometry_force)
    out = torch.empty((M, 2 * n), dtype=torch.float32, device=x.device)
    cuda_build.call("attack_logits", "k10_attack_logits", cuda_build.ptr(params), dims,
                    ctypes.c_int(net.depth), cuda_build.ptr(x), cuda_build.ptr(xp),
                    ctypes.c_longlong(n), ctypes.c_int(M), cuda_build.ptr(out),
                    ctypes.c_int(geo["tw"]), ctypes.c_int(geo["warps"]),
                    ctypes.c_int(geo["grid"]), ctypes.c_longlong(geo["smem"]),
                    cuda_build.stream())
    lead = (M,) if isinstance(net, StackedMLP) else ()
    shape = lead + x.shape[:-1]
    return out[:, :n].reshape(shape), out[:, n:].reshape(shape)




def no_flip_certified(lb_x, ub_x, lb_p, ub_p, valid_assign, valid_pair) -> np.ndarray:
    """Per-box certificate from role logit bounds (numpy; the JAX package's
    host ``no_flip_certified``): for a valid pair (a, b) the flip x⁺/x'⁻ is
    impossible iff ``ub_x[a] <= 0`` or ``lb_p[b] >= 0``, the flip x⁻/x'⁺ iff
    ``lb_x[a] >= 0`` or ``ub_p[b] <= 0``; certified iff both are impossible
    for every valid pair."""
    lb_x, ub_x, lb_p, ub_p = (np.asarray(v) for v in (lb_x, ub_x, lb_p, ub_p))
    valid_assign = np.asarray(valid_assign, bool)
    pair_ok = (np.asarray(valid_pair, bool) & valid_assign[..., :, None]
               & valid_assign[..., None, :])
    t1_dead = (ub_x[..., :, None] <= 0.0) | (lb_p[..., None, :] >= 0.0)
    t2_dead = (lb_x[..., :, None] >= 0.0) | (ub_p[..., None, :] <= 0.0)
    return ~(pair_ok & ~(t1_dead & t2_dead)).any(axis=(-2, -1))


def role_bound_margin(lb_x, ub_x, lb_p, ub_p, valid, valid_pair) -> np.ndarray:
    """Certified margin from role logit bounds alone (numpy, f32; the JAX
    package's host ``role_bound_margin``): ``margin >= 0`` iff
    :func:`no_flip_certified`; boxes without a valid pair get FLT_MAX."""
    lb_x, ub_x, lb_p, ub_p = (np.asarray(v, np.float32)
                              for v in (lb_x, ub_x, lb_p, ub_p))
    m1 = np.maximum(-ub_x[..., :, None], lb_p[..., None, :])
    m2 = np.maximum(lb_x[..., :, None], -ub_p[..., None, :])
    va = np.asarray(valid, bool)
    pair_ok = np.asarray(valid_pair, bool) & va[..., :, None] & va[..., None, :]
    big = np.float32(F32_MAX)
    return np.where(pair_ok, np.minimum(m1, m2), big).min(axis=(-2, -1))


def split_certify_attack_submit(net, enc: PairEncoding, x_lo, x_hi, xp_lo, xp_hi, lo, hi,
                                valid, xr, pr, use_crown: bool, mesh=None, replicas=None):
    """Launch stage 0 of N boxes in two launches, the JAX package's
    non-fused kinds of ``_stage0_block_submit`` / ``_family_block_submit``,
    without a sync: the certificate — on the CROWN path :func:`role_certify`
    (rows 14 and 6), on the IBP path :func:`role_logit_bounds` (rows 13 and
    8) — then the attack forward :func:`attack_logits` (rows 17 and 9).

    Inputs are numpy: role boxes (N, V, d), partition boxes ``lo``/``hi``
    (N, d) f32, ``valid`` (N, V), candidates (N, S, V, d).  With a ``mesh``
    (``parallel.mesh.Mesh``, ``replicas`` the net's
    ``parallel.mesh.replicated`` copies) the certificate's inputs are
    sharded over its ``parts`` axis and its outputs gathered on the mesh's
    first device, trimmed back to N rows; the attack forward runs unsharded
    there, as in JAX.  Without one everything runs on the net's device.
    Returns the payload of JAX's kinds: ``{"cert", "margin", "lx", "lp"}``
    (CROWN) or ``{"lb_x", "ub_x", "lb_p", "ub_p", "lx", "lp"}`` (IBP),
    tensors with a leading model axis for a ``StackedMLP``."""
    n = lo.shape[0]
    axis = int(isinstance(net, StackedMLP))
    if mesh is None:
        mesh, replicas = mesh_mod.placement(net)
    boxes = (x_lo, x_hi, xp_lo, xp_hi)
    trim = lambda t: t.narrow(axis, 0, n)
    if use_crown:
        cert, _score, margin = shard_certify(mesh, replicas, enc, boxes, lo, hi, valid,
                                             axis=axis)
        payload = {"cert": trim(cert), "margin": trim(margin)}
    else:
        bounds = mesh_mod.shard_launch(
            mesh, lambda m, *b: role_logit_bounds(m, *b, use_crown=False), replicas,
            *boxes, axis=axis)
        payload = dict(zip(("lb_x", "ub_x", "lb_p", "ub_p"), (trim(b) for b in bounds)))
    home = replicas[mesh.home]
    with mesh_mod.on_device(mesh.home):
        payload["lx"], payload["lp"] = attack_logits(home, stage(xr, mesh.home),
                                                     stage(pr, mesh.home))
    return payload


def split_certify_attack_decode(host, enc: PairEncoding, valid, stacked: bool) -> list:
    """Host decode of a fetched :func:`split_certify_attack_submit` payload:
    per model ``(cert (N,), margin (N,), found (N,), wit (N, 3), gap (N,))``
    (the IBP path's certificate and margin taken here from the bounds)."""
    lift = (lambda a: a) if stacked else (lambda a: a[None])
    lx, lp = lift(host["lx"]), lift(host["lp"])
    va, vp = torch.as_tensor(valid), torch.as_tensor(enc.valid_pair)
    out = []
    for m in range(lx.shape[0]):
        if "cert" in host:
            cert_m, margin_m = lift(host["cert"])[m], lift(host["margin"])[m]
        else:
            b = tuple(lift(host[k])[m] for k in ("lb_x", "ub_x", "lb_p", "ub_p"))
            cert_m = no_flip_certified(*b, valid, enc.valid_pair)
            margin_m = role_bound_margin(*b, valid, enc.valid_pair)
        lxm, lpm = torch.as_tensor(lx[m]), torch.as_tensor(lp[m])
        found, wit = find_flips_impl(lxm, lpm, va, vp)
        out.append((cert_m, margin_m, found.numpy(), wit.numpy(),
                    attack_gap_impl(lxm, lpm, va, vp).numpy()))
    return out


def shard_certify(mesh, replicas, enc: PairEncoding, boxes, lo, hi, valid,
                  alpha_iters: int = 0, axis: int = 0):
    """Launch :func:`role_certify` of numpy role boxes ``boxes`` (x_lo,
    x_hi, xp_lo, xp_hi), partition boxes and ``valid`` over ``mesh``'s
    ``parts`` shards (``replicas`` the net's copies), without a sync:
    ``(cert, score, margin)`` tensors gathered along ``axis`` (1 for a
    stacked family) on the mesh's first device, shard padding kept."""
    av, pm, rm = enc_tensors(enc, lo.shape[1])

    def certify(m, x_lo, x_hi, xp_lo, xp_hi, plo, phi, va):
        to = lambda a: stage(a, plo.device)
        return role_certify(m, x_lo, x_hi, xp_lo, xp_hi, plo, phi, to(av), to(pm), to(rm),
                            float(enc.eps), va, to(enc.valid_pair), alpha_iters=alpha_iters)

    return mesh_mod.shard_launch(mesh, certify, replicas, *boxes, lo, hi, valid, axis=axis)


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

    Float64 forward first; within 1e-6 of zero, re-evaluate exactly (f32
    weights are dyadic rationals, so this is the true sign): in the native
    exact core (``ops.exact_native.forward_signs``) when it is available,
    else in ``Fraction`` arithmetic.
    """
    v = float(forward_np(weights, biases, np.asarray(x, dtype=np.float64)))
    if abs(v) > 1e-6:
        return 1 if v > 0 else -1
    nat = exact_native.forward_signs(weights, biases,
                                     np.asarray(x, dtype=np.int64)[None, :])
    if nat is not None:
        return int(nat[0])
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


def find_flips(enc: PairEncoding, logit_x, logit_p, valid_assign):
    """Host strict-flip detection over (B, S, V) numpy logits: ``(found (B,),
    witness (B, 3) [sample, a, b])`` as numpy arrays."""
    found, wit = find_flips_impl(torch.as_tensor(np.asarray(logit_x)),
                                 torch.as_tensor(np.asarray(logit_p)),
                                 torch.as_tensor(np.asarray(valid_assign, bool)),
                                 torch.as_tensor(np.asarray(enc.valid_pair, bool)))
    return found.numpy(), wit.numpy()


def live_rows(what: str, B: int, live) -> int:
    """``live`` (None: all B rows) checked for a batch of B rows."""
    live = B if live is None else int(live)
    if not (1 <= live <= B or live == B == 0):
        raise ValueError(f"{what}: live={live} for {B} rows")
    return live


def fill_past(t: torch.Tensor, live: int, axis: int = 0) -> torch.Tensor:
    """``t`` with the entries past ``live`` on ``axis`` replaced by entry
    ``live - 1``: what the kernels' live-row launches give the padded rows."""
    n = t.shape[axis]
    if live >= n:
        return t
    shape = list(t.shape)
    shape[axis] = n - live
    return torch.cat([t.narrow(axis, 0, live), t.narrow(axis, live - 1, 1).expand(shape)],
                     dim=axis)


def _pad(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad the leading axis to ``n`` rows by repeating the last row."""
    if arr.shape[0] == n:
        return arr
    pad = np.repeat(arr[-1:], n - arr.shape[0], axis=0)
    return np.concatenate([arr, pad], axis=0)


# ---------------------------------------------------------------------------
# Gradient attack (K5)
# ---------------------------------------------------------------------------

PGD_DECAY = np.float32(0.85)


def pgd_schedule(eps: float, steps: int):
    """Per-step f32 scalars of the PGD update: the decay ``0.85**t`` (as
    XLA's f32 ``pow`` computes it) and the RA step ``(0.35·ε + 0.5)·decay``
    (its multiply-add fused, as XLA fuses it)."""
    decay = np.array([PGD_DECAY ** t for t in range(steps)], dtype=np.float32)
    r_base = np.float32(float(np.float32(0.35)) * float(np.float32(eps)) + 0.5)
    return decay, (r_base * decay).astype(np.float32)


def pgd_starts(key, lo, hi, eps: float, restarts: int):
    """Threefry starts ``(s0, r0)`` (B, R, d) of the PGD trajectories:
    ``s0 = lo + U[0,1)·(hi - lo)`` (one rounding, as XLA's fused
    multiply-add), ``r0 = U[-1,1)·ε``; bit-equal to the JAX package."""
    B, d = lo.shape
    k_s, k_r = prng.split(key)
    u_s = prng.uniform(k_s, (B, restarts, d))
    u_r = prng.uniform(k_r, (B, restarts, d), -1.0, 1.0)
    lo_b, hi_b = lo[:, None, :], hi[:, None, :]
    s0 = (lo_b.double() + u_s.double() * (hi_b - lo_b).double()).float()
    return s0, u_r * float(np.float32(eps))


def pgd_attack_plain(net, lo, hi, assign_vals, pa_mask, ra_mask, valid, eps,
                     key, steps: int, restarts: int, on_step=None):
    """Plain PyTorch version of K5 (``_pgd_attack_kernel``).

    For each box, signed-gradient ascent on ``min(max_a f(x(s,a)),
    -min_b f(x'(s,b,r)))`` over the shared coordinates ``s`` and the RA
    shift ``r`` from ``restarts`` threefry starts, ``steps`` steps, then
    rounding to the lattice.  The gradient is autograd over an objective
    built with ``torch.maximum``/``minimum``/``amax``/``amin``/``relu``,
    whose tie rules are JAX's (½ each way at a tie, equal shares among tied
    maxima, ``relu'(0) = 0``).  ``lo``/``hi`` (B, d) f32, ``valid`` (B, V)
    bool, ``key`` a (2,) threefry key.  Returns ``(fx, fp)`` (B, R, V) and
    ``(x, xp)`` (B, R, V, d).  ``on_step(x, xp, g_s, g_r)``, if given, sees
    every step's role points and gradient (a checker's view of the path).
    """
    lo_b, hi_b = lo[:, None, :], hi[:, None, :]
    width = hi_b - lo_b
    shared = 1.0 - pa_mask
    vmask = valid[:, None, :]
    neg_inf = torch.tensor(float("-inf"), device=lo.device)
    pos_inf = torch.tensor(float("inf"), device=lo.device)

    def build(s, r):
        x = s[..., None, :] * shared + assign_vals
        return x, x + (r * ra_mask)[..., None, :]

    def objective(s, r):
        x, xp = build(s, r)
        fxm = torch.where(vmask, net(x), neg_inf).amax(dim=-1)
        fpm = torch.where(vmask, net(xp), pos_inf).amin(dim=-1)
        return torch.minimum(fxm, -fpm)

    decay, r_step = pgd_schedule(eps, steps)
    s, r = pgd_starts(key, lo, hi, eps, restarts)
    a_base = torch.maximum(width * float(np.float32(0.35)),
                           torch.tensor(0.5, device=lo.device))
    e = float(np.float32(eps))
    for t in range(steps):
        s_g, r_g = s.clone().requires_grad_(True), r.clone().requires_grad_(True)
        with torch.enable_grad():
            g_s, g_r = torch.autograd.grad(objective(s_g, r_g).sum(), (s_g, r_g))
        if on_step is not None:
            on_step(*build(s, r), g_s, g_r)
        s = torch.minimum(torch.maximum(s + a_base * float(decay[t]) * torch.sign(g_s),
                                        lo_b), hi_b)
        r = torch.clamp(r + float(r_step[t]) * torch.sign(g_r), -e, e)
    s = torch.minimum(torch.maximum(torch.round(s), lo_b), hi_b)
    r = torch.round(r) * ra_mask
    x, xp = build(s, r)
    with torch.no_grad():
        return net(x), net(xp), x, xp


def pgd_attack_kernel(net, lo, hi, assign_vals, pa_mask, ra_mask, valid, eps,
                      key, steps: int, restarts: int):
    """K5: the PGD attack of B boxes in one launch (contract of
    :func:`pgd_attack_plain`).  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/pgd_attack.cu``."""
    if lo.device.type == "cpu":
        return pgd_attack_plain(net, lo, hi, assign_vals, pa_mask, ra_mask, valid,
                                eps, key, steps, restarts)
    cuda_build.require_cuda(lo)
    with launches.launching("pgd_attack", (lo.shape[0], int(steps), int(restarts))):
        out = _pgd_attack_launch(net, lo, hi, assign_vals, pa_mask, ra_mask, valid,
                                 eps, key, steps, restarts)
    return out


@functools.lru_cache(maxsize=64)
def _pgd_schedule_on(eps: float, steps: int, device) -> torch.Tensor:
    """:func:`pgd_schedule` as one (2, steps) f32 tensor on ``device``,
    copied there once per (eps, steps)."""
    return stage(np.stack(pgd_schedule(eps, steps)), device)


def _pgd_attack_launch(net, lo, hi, assign_vals, pa_mask, ra_mask, valid, eps,
                       key, steps: int, restarts: int, _geometry_force=None):
    """One K5 launch; ``_geometry_force`` (``(ttw, warps)``) forces the
    launch geometry: the card's checks that a trajectory does not depend
    on it."""
    if net.layer_sizes[-1] != 1:
        raise ValueError("pgd_attack: the net must have one output logit")
    params, dims, _ = cuda_build.pack_padded(net)
    lo, hi = lo.contiguous(), hi.contiguous()
    av, pm, rm = (t.contiguous() for t in (assign_vals, pa_mask, ra_mask))
    vb = valid.to(torch.uint8).contiguous()
    cuda_build.require_cuda(params, lo, hi, av, pm, rm, vb)
    B, d = lo.shape
    V = av.shape[0]
    geo = _pgd_geometry(tuple(dims), B * restarts, V, cuda_build.sm_count(lo.device),
                        cuda_build.SMEM_LIMIT, _geometry_force)
    sched = _pgd_schedule_on(eps, steps, lo.device)
    k32 = cuda_build.u32_keys(key.to(lo.device).reshape(1, 2))
    dev = lo.device
    fx = torch.empty((B, restarts, V), dtype=torch.float32, device=dev)
    fp = torch.empty_like(fx)
    x = torch.empty((B, restarts, V, d), dtype=torch.float32, device=dev)
    xp = torch.empty_like(x)
    cuda_build.call("pgd_attack", "k5_pgd_attack", cuda_build.ptr(params), dims,
                    ctypes.c_int(net.depth), cuda_build.ptr(lo), cuda_build.ptr(hi),
                    cuda_build.ptr(av), cuda_build.ptr(pm), cuda_build.ptr(rm),
                    cuda_build.ptr(vb), ctypes.c_float(float(np.float32(eps))),
                    cuda_build.ptr(k32), cuda_build.ptr(sched),
                    ctypes.c_int(steps), ctypes.c_int(B), ctypes.c_int(restarts),
                    ctypes.c_int(V), cuda_build.ptr(fx), cuda_build.ptr(fp),
                    cuda_build.ptr(x), cuda_build.ptr(xp), ctypes.c_int(geo["ttw"]),
                    ctypes.c_int(geo["tw"]), ctypes.c_int(geo["warps"]),
                    ctypes.c_int(geo["grid"]), ctypes.c_longlong(geo["smem"]),
                    cuda_build.stream())
    return fx, fp, x, xp




def pgd_inputs(enc: PairEncoding, lo, hi, device):
    """K5's tensor inputs for a batch of integer boxes ``lo``/``hi`` (B, d).

    The batch is padded to the next power of two (last row repeated), as in
    the JAX package.  Returns ``(args, valid)``: ``args`` = (lo, hi,
    assign_vals, pa_mask, ra_mask, valid, eps) on ``device`` (staged through
    pinned buffers on a card: no sync), as :func:`pgd_attack_kernel` takes
    them, and ``valid`` the (pad, V) numpy mask of the assignments each box
    admits.
    """
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    B, d = lo.shape
    pad_to = 1 << max(B - 1, 0).bit_length()
    lo_p, hi_p = _pad(lo, pad_to), _pad(hi, pad_to)
    assign_vals, pa_mask, ra_mask = enc_tensors(enc, d)
    if len(enc.pa_idx):
        valid = ((enc.assignments[None, :, :] >= lo_p[:, None, enc.pa_idx])
                 & (enc.assignments[None, :, :] <= hi_p[:, None, enc.pa_idx])
                 ).all(axis=-1)
    else:
        valid = np.zeros((pad_to, enc.n_assign), dtype=bool)
    on = lambda a: stage(a, device)
    args = (on(lo_p.astype(np.float32)), on(hi_p.astype(np.float32)), on(assign_vals),
            on(pa_mask), on(ra_mask), on(valid), float(enc.eps))
    return args, valid


def pgd_attack_submit(net, enc: PairEncoding, lo, hi, rng: np.random.Generator,
                      steps: int = 30, restarts: int = 32):
    """Launch one gradient attack over a batch of boxes without syncing on
    its results: one K5 launch (key ``PRNGKey(rng.integers(2**31))``, as in
    the JAX package).  Returns ``(payload, ctx)`` for
    :class:`parallel.pipeline.LaunchPipeline`: ``payload`` the kernel's
    ``(fx, fp, x, xp)``, ``ctx`` what :func:`pgd_attack_decode` needs."""
    args, valid = pgd_inputs(enc, lo, hi, net.device)
    key = stage(prng.seed_key(int(rng.integers(2**31))), net.device)
    payload = pgd_attack_kernel(net, *args, key, steps, restarts)
    return payload, {"enc": enc, "valid": valid, "B": len(lo)}


def pgd_attack_decode(host, ctx, weights, biases, return_points: bool = False):
    """Host decode of a fetched K5 launch (numpy ``host`` payload): flip
    extraction and exact checks on the net's host ``weights``/``biases``.

    Returns ``{box: (x, x')}`` of exact-validated witnesses; with
    ``return_points`` also, per box, the role point with the smallest
    |logit| among valid assignments and that |logit| (the slab search's
    seed)."""
    fx, fp, x, xp = host
    enc, valid, B = ctx["enc"], ctx["valid"], ctx["B"]
    found, wit = find_flips(enc, fx, fp, valid)
    witnesses = extract_witnesses(found, wit, x, xp, weights, biases, limit=B)
    if not return_points:
        return witnesses
    pad_to = valid.shape[0]
    fx_abs = np.abs(np.asarray(fx, dtype=np.float64))
    fx_abs = np.where(valid[:, None, :], fx_abs, np.inf)
    flat = fx_abs.reshape(pad_to, -1)
    idx = flat.argmin(axis=1)
    si, vi = np.divmod(idx, fx_abs.shape[2])
    pts = x[np.arange(pad_to), si, vi][:B]
    best_abs = flat[np.arange(pad_to), idx][:B]
    return witnesses, pts, best_abs


def pgd_attack(net, enc: PairEncoding, lo, hi, rng: np.random.Generator,
               steps: int = 30, restarts: int = 32, return_points: bool = False):
    """Gradient attack over a batch of boxes: synchronous
    :func:`pgd_attack_submit` + :func:`pgd_attack_decode` (pipelined callers
    use the split form)."""
    payload, ctx = pgd_attack_submit(net, enc, lo, hi, rng, steps=steps, restarts=restarts)
    weights, biases = net.numpy_params()
    return pgd_attack_decode(fetch(payload), ctx, weights, biases,
                             return_points=return_points)


# ---------------------------------------------------------------------------
# Exact host-side deciders
# ---------------------------------------------------------------------------


def decide_leaf(enc: PairEncoding, weights, biases, point: np.ndarray, lo, hi):
    """Exactly decide a leaf box (every shared dim collapsed to one point).

    Enumerates PA assignment pairs and, for RA dims, the delta lattice
    [-ε, ε]^|RA|.  Returns ('sat', (x, xp)), ('unsat', None), or
    ('unknown', None) when the delta lattice exceeds 10^5 points.
    """
    if len(enc.ra_idx) and enc.eps and \
            (2 * enc.eps + 1) ** len(enc.ra_idx) > 100_000:
        return "unknown", None
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    valid = valid_assignments(enc, lo, hi)
    deltas = (list(itertools.product(range(-enc.eps, enc.eps + 1),
                                     repeat=len(enc.ra_idx)))
              if (len(enc.ra_idx) and enc.eps) else [()])
    sign_x = {}
    for a in valid:
        x = np.array(point, dtype=np.int64)
        x[enc.pa_idx] = enc.assignments[a]
        sign_x[a] = exact_logit_sign(weights, biases, x)
    for a in valid:
        if sign_x[a] == 0:
            continue
        for b in valid:
            if not enc.valid_pair[a, b]:
                continue
            for dl in deltas:
                xp = np.array(point, dtype=np.int64)
                xp[enc.pa_idx] = enc.assignments[b]
                for k, dv in enumerate(dl):
                    xp[enc.ra_idx[k]] += dv
                sp = (sign_x[b] if not dl or all(v == 0 for v in dl)
                      else exact_logit_sign(weights, biases, xp))
                if (sign_x[a] > 0 and sp < 0) or (sign_x[a] < 0 and sp > 0):
                    x = np.array(point, dtype=np.int64)
                    x[enc.pa_idx] = enc.assignments[a]
                    return "sat", (x, xp)
    return "unsat", None


def slab_search(weights, biases, enc: PairEncoding, lo, hi, shared0,
                max_iters: int = 24):
    """Deterministic exact flip-slab search from a near-zero seed point.

    The logit is piecewise affine: evaluate ``(f, ∇f)`` in f64
    (:func:`models.mlp.local_affine_np`) and Newton-step one integer
    coordinate — the finest whose in-box step reaches the target — until
    ``f`` lands inside the slab ``(0, -δ)`` that the PA offset δ opens;
    the pair is then validated in exact arithmetic.  Returns ``(x, xp)``
    int64 arrays, or None.
    """
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    if not len(enc.pa_idx):
        return None
    pa_idx = np.asarray(enc.pa_idx)
    pa_set = set(int(j) for j in pa_idx)
    V = enc.n_assign
    in_box = [bool((lo[pa_idx] <= enc.assignments[v]).all()
                   and (enc.assignments[v] <= hi[pa_idx]).all()) for v in range(V)]
    shared = np.clip(np.round(np.asarray(shared0, dtype=np.float64)),
                     lo, hi).astype(np.float64)
    for a in range(V):
        for b in range(V):
            if not (enc.valid_pair[a, b] and in_box[a] and in_box[b]):
                continue
            x = shared.copy()
            x[pa_idx] = enc.assignments[a]
            for _ in range(max_iters):
                f, g = local_affine_np(weights, biases, x)
                delta = float(((enc.assignments[b] - enc.assignments[a])
                               * g[pa_idx]).sum())
                if delta == 0.0:
                    break
                t_lo, t_hi = (0.0, -delta) if delta < 0 else (-delta, 0.0)
                if t_lo < f < t_hi:
                    xp = x.copy()
                    xp[pa_idx] = enc.assignments[b]
                    if validate_pair(weights, biases, x.astype(np.int64),
                                     xp.astype(np.int64)):
                        return x.astype(np.int64), xp.astype(np.int64)
                    break  # f64 in-slab but the exact sign disagrees
                need = (t_lo + t_hi) / 2.0 - f
                best_j, best_t = -1, 0
                fb_j, fb_t, fb_reach = -1, 0, 0.0
                for j in np.argsort(np.abs(g)):
                    j = int(j)
                    if j in pa_set or g[j] == 0.0:
                        continue
                    t_unc = need / g[j]
                    if not np.isfinite(t_unc):
                        continue
                    t = int(np.clip(round(t_unc), lo[j] - x[j], hi[j] - x[j]))
                    if t == 0:
                        continue
                    if lo[j] - x[j] - 0.5 <= t_unc <= hi[j] - x[j] + 0.5:
                        best_j, best_t = j, t
                        break
                    reach = abs(g[j] * t)
                    if reach > fb_reach:
                        fb_j, fb_t, fb_reach = j, t, reach
                if best_j < 0:
                    best_j, best_t = fb_j, fb_t
                if best_j < 0:
                    break
                x[best_j] += best_t
    return None


# ---------------------------------------------------------------------------
# Device-resident BaB segment (K6)
# ---------------------------------------------------------------------------


def tied_diff_ub_keep(A_pos, c_pos, A_neg, c_neg, lo, hi, shared_mask, alive):
    """:func:`tied_diff_ub` plus the branching score and the KEEP hull.

    Same bound and magnitude per (pos, neg) pair; additionally ``coef``
    (B, d), the max over all pairs of |A_pos − A_neg| on shared dims, and,
    per shared coordinate, the hull ``(keep_lo, keep_hi)`` (B, d) outside
    which no ``alive`` pair (B, Vp, Vn) can flip in this direction: moving
    s_j a distance t off its optimal corner lowers the form by |D_j|·t, so
    ``|D_j|·t >= w`` (w the widened pair bound) rules a flip out.  The
    shift ``w/|D_j|`` carries the outward slack; a dead pair (not alive,
    or w <= 0) contributes the empty interval.  Returns ``(M, coef, mag,
    keep_lo, keep_hi)``.
    """
    absbox = torch.maximum(lo.abs(), hi.abs())
    neg_coef_mag = (A_neg.abs() * absbox[:, None, :]).sum(-1)
    big = torch.tensor(F32_MAX, dtype=lo.dtype, device=lo.device)
    tiny = 1e-12
    coef = torch.zeros_like(lo)
    keep_lo = torch.full_like(lo, F32_MAX)
    keep_hi = torch.full_like(lo, -F32_MAX)
    rows, mags = [], []
    for a in range(A_pos.shape[1]):
        au, cu = A_pos[:, a], c_pos[:, a]
        D = (au[:, None, :] - A_neg) * shared_mask
        m = torch.where(D > 0, D * hi[:, None, :], D * lo[:, None, :])
        row = m.sum(-1) + cu[:, None] - c_neg
        pos_coef_mag = (au.abs() * absbox).sum(-1)
        absD = D.abs()
        mag = ((absD * absbox[:, None, :]).sum(-1) + pos_coef_mag[:, None]
               + neg_coef_mag + cu.abs()[:, None] + c_neg.abs())
        w = row + SOUND_SLACK_REL * mag + SOUND_SLACK_ABS
        live = alive[:, a] & (w > 0.0)
        shift = w[..., None] / torch.clamp_min(absD, tiny)
        shift = shift + SOUND_SLACK_REL * shift + SOUND_SLACK_ABS
        kl = torch.where(D > tiny, hi[:, None, :] - shift, lo[:, None, :])
        kh = torch.where(D < -tiny, lo[:, None, :] + shift, hi[:, None, :])
        kl = torch.where(live[..., None], kl, big)
        kh = torch.where(live[..., None], kh, -big)
        keep_lo = torch.minimum(keep_lo, kl.amin(dim=1))
        keep_hi = torch.maximum(keep_hi, kh.amax(dim=1))
        coef = torch.maximum(coef, absD.amax(dim=1))
        rows.append(row)
        mags.append(mag)
    return torch.stack(rows, 1), coef, torch.stack(mags, 1), keep_lo, keep_hi


def certify_clip_impl(net, x_lo, x_hi, xp_lo, xp_hi, lo, hi, assign_vals,
                      pa_mask, ra_mask, eps, valid, valid_pair, alpha_iters: int):
    """The BaB certificate with domain clipping (``_certify_clip_impl``).

    Same form sets, role deadness and widen-before-min-over-sets as
    :func:`certify_impl`; each direction's tied bound runs through
    :func:`tied_diff_ub_keep` with the pairs still alive after role
    deadness.  Per set the keep hull is the union of both directions'; across
    sets the intersection.  Returns ``(cert (B,), score (B, d), keep_lo,
    keep_hi)``.
    """
    stk_x, lb_x, ub_x = crown_ops.output_form_stack(net, x_lo, x_hi, alpha_iters)
    stk_p, lb_p, ub_p = crown_ops.output_form_stack(net, xp_lo, xp_hi, alpha_iters)
    n_sets = stk_x[0].shape[0]
    t1_dead = (ub_x[..., :, None] <= 0.0) | (lb_p[..., None, :] >= 0.0)
    t2_dead = (lb_x[..., :, None] >= 0.0) | (ub_p[..., None, :] <= 0.0)
    pair_ok = valid_pair[None] & valid[..., :, None] & valid[..., None, :]
    alive1 = pair_ok & ~t1_dead
    alive2 = (pair_ok & ~t2_dead).transpose(-1, -2)
    shared = 1.0 - pa_mask
    pa_dot = lambda A: (A * assign_vals[None, :, :]).sum(-1)
    ra_abs = lambda A: eps * (A.abs() * ra_mask).sum(-1)
    widen = lambda u, g: u + SOUND_SLACK_REL * g + SOUND_SLACK_ABS
    ub1 = ub2 = keep_lo = keep_hi = None
    score = torch.zeros_like(lo)
    for i in range(n_sets):
        Alx, clx, Aux, cux = (t[i] for t in stk_x)
        Alp, clp, Aup, cup = (t[i] for t in stk_p)
        m1, s1, g1, kl1, kh1 = tied_diff_ub_keep(
            Aux, cux + pa_dot(Aux), Alp, clp + pa_dot(Alp) - ra_abs(Alp),
            lo, hi, shared, alive1)
        m2, s2, g2, kl2, kh2 = tied_diff_ub_keep(
            Aup, cup + pa_dot(Aup) + ra_abs(Aup), Alx, clx + pa_dot(Alx),
            lo, hi, shared, alive2)
        w1 = widen(m1, g1)
        w2 = widen(m2, g2).transpose(-1, -2)
        ub1 = w1 if ub1 is None else torch.minimum(ub1, w1)
        ub2 = w2 if ub2 is None else torch.minimum(ub2, w2)
        score = torch.maximum(score, torch.maximum(s1, s2))
        skl, skh = torch.minimum(kl1, kl2), torch.maximum(kh1, kh2)
        keep_lo = skl if keep_lo is None else torch.maximum(keep_lo, skl)
        keep_hi = skh if keep_hi is None else torch.minimum(keep_hi, skh)
    t1_dead = t1_dead | (ub1 <= 0.0)
    t2_dead = t2_dead | (ub2 <= 0.0)
    possible = pair_ok & ~(t1_dead & t2_dead)
    return ~possible.any(dim=-1).any(dim=-1), score, keep_lo, keep_hi


QUEUE_KEYS = ("q_lo", "q_hi", "q_root", "q_live", "found", "wit_a", "wit_b", "wit_pt")


def bab_slot_phase(net, st: dict, root_valid, assign_vals, pa_mask, ra_mask, eps,
                   valid_pair, branch_mask, alpha_iters: int):
    """The per-slot phase of one BaB round (plain PyTorch).

    Every live slot of the queue ``st`` (a dict over :data:`QUEUE_KEYS`) is
    certified with domain clipping, clipped inward to its keep hull's
    lattice rounding, probed at its integer midpoint (the first flip in a
    slot's lifetime is latched) and given its split (``score·width``,
    widest-dim fallback, first-max tie-break, PA dims barred, at
    ``⌊(lo+hi)/2⌋``).  Returns the updated queue and the per-slot split
    plan ``(can, dim, mid)``.
    """
    q_lo, q_hi, q_live = st["q_lo"], st["q_hi"], st["q_live"]
    found, wa, wb, wpt = st["found"], st["wit_a"], st["wit_b"], st["wit_pt"]
    roots = st["q_root"].long()
    shared = 1.0 - pa_mask
    x_lo = q_lo[:, None, :] * shared + assign_vals[None]
    x_hi = q_hi[:, None, :] * shared + assign_vals[None]
    valid = root_valid[roots] & q_live[:, None]
    cert, score, keep_lo, keep_hi = certify_clip_impl(
        net, x_lo, x_hi, x_lo - eps * ra_mask, x_hi + eps * ra_mask, q_lo, q_hi,
        assign_vals, pa_mask, ra_mask, eps, valid, valid_pair, alpha_iters)
    n_lo = torch.maximum(q_lo, torch.ceil(keep_lo))
    n_hi = torch.minimum(q_hi, torch.floor(keep_hi))
    keep = q_live & ~(cert | (n_lo > n_hi).any(-1))
    q_lo = torch.where(keep[:, None], n_lo, q_lo)
    q_hi = torch.where(keep[:, None], n_hi, q_hi)
    mid = torch.floor((q_lo + q_hi) * 0.5)
    lm = net(mid[:, None, :] * shared + assign_vals[None])
    found_now, wit = find_flips_impl(lm[:, None, :], lm[:, None, :],
                                     root_valid[roots] & keep[:, None], valid_pair)
    newly = found_now & ~found
    widths = (q_hi - q_lo) * branch_mask
    can = keep & (widths.amax(-1) > 0.0)
    sc = score * widths
    sc = torch.where(sc.amax(-1, keepdim=True) > 0.0, sc, widths)
    sc = torch.where(branch_mask > 0.0, sc, torch.full_like(sc, -1.0))
    dim = torch.argmax(sc, dim=-1)
    lo_d = q_lo.gather(1, dim[:, None])[:, 0]
    hi_d = q_hi.gather(1, dim[:, None])[:, 0]
    st = dict(st, q_lo=q_lo, q_hi=q_hi, q_live=keep, found=found | found_now,
              wit_a=torch.where(newly, wit[:, 1], wa),
              wit_b=torch.where(newly, wit[:, 2], wb),
              wit_pt=torch.where(newly[:, None], mid, wpt))
    return st, (can, dim, torch.floor((lo_d + hi_d) * 0.5))


def bab_compaction(st: dict, slot_ok, can, dim, mid_d):
    """The compaction phase of one BaB round: the k-th splitter (``can``,
    slot order) sends its upper half ``[mid+1, hi]`` along ``dim`` to the
    k-th free slot (not live, not latched, not the canary) and keeps the
    lower half; a splitter without a free slot overflows and keeps its
    whole box.  Returns ``(queue, fits, over)``."""
    Q, d = st["q_lo"].shape
    dev = st["q_lo"].device
    free = ~st["q_live"] & slot_ok & ~st["found"]
    rank_f = torch.cumsum(free.to(torch.int64), 0) - 1
    table = torch.full((Q,), Q, dtype=torch.int64, device=dev)
    table[rank_f[free]] = torch.arange(Q, device=dev)[free]
    rank_c = torch.cumsum(can.to(torch.int64), 0) - 1
    fits = can & (rank_c < int(free.sum()))
    dest = table[rank_c.clamp(0, Q - 1)][fits]
    oh = torch.arange(d, device=dev)[None, :] == dim[:, None]
    q_lo, q_hi = st["q_lo"].clone(), st["q_hi"]
    q_root, q_live = st["q_root"].clone(), st["q_live"].clone()
    child_lo = torch.where(oh, mid_d[:, None] + 1.0, q_lo)[fits]
    child_hi = q_hi[fits]
    q_hi = torch.where(oh & fits[:, None], mid_d[:, None], q_hi)
    q_lo[dest], q_hi[dest] = child_lo, child_hi
    q_root[dest] = q_root[fits]
    q_live[dest] = True
    return dict(st, q_lo=q_lo, q_hi=q_hi, q_root=q_root, q_live=q_live), fits, can & ~fits


def bab_segment_plain(net, q_lo, q_hi, q_root, q_live, q_found, wit_a, wit_b,
                      wit_pt, slot_ok, root_valid, assign_vals, pa_mask, ra_mask,
                      eps, valid_pair, branch_mask, rounds: int, alpha_iters: int):
    """Plain PyTorch version of K6: ``rounds`` branching rounds over a slot
    queue (``_bab_segment_impl``), each :func:`bab_slot_phase` then
    :func:`bab_compaction`, α-CROWN in the certificate when ``alpha_iters
    > 0``.

    Queue tensors (slot-major, Qs slots): ``q_lo``/``q_hi`` (Qs, d) f32,
    ``q_root`` (Qs,) int32, ``q_live``/``q_found``/``slot_ok`` (Qs,) bool,
    ``wit_a``/``wit_b`` (Qs,) int32, ``wit_pt`` (Qs, d) f32; ``root_valid``
    (G, V) bool.  Returns a dict over ``integrity.BAB_FOLD_KEYS`` (the
    updated queue and the per-root (G,) int32 ``nodes``/``splits``/
    ``overflow``) plus ``csum``, the int32 fold of those buffers (a 0-d
    int32 tensor).
    """
    G = root_valid.shape[0]
    st = dict(zip(QUEUE_KEYS, (q_lo, q_hi, q_root, q_live, q_found, wit_a, wit_b,
                               wit_pt)))
    counts = {k: torch.zeros(G, dtype=torch.int32, device=q_lo.device)
              for k in ("nodes", "splits", "overflow")}
    add = lambda k, roots, flag: counts[k].index_add_(0, roots.long(), flag.to(torch.int32))
    for _ in range(rounds):
        add("nodes", st["q_root"], st["q_live"])
        st, (can, dim, mid_d) = bab_slot_phase(
            net, st, root_valid, assign_vals, pa_mask, ra_mask, eps, valid_pair,
            branch_mask, alpha_iters)
        roots = st["q_root"]
        st, fits, over = bab_compaction(st, slot_ok, can, dim, mid_d)
        add("splits", roots, fits)
        add("overflow", roots, over)
    out = {k: st[k] for k in QUEUE_KEYS}
    out["wit_a"], out["wit_b"] = out["wit_a"].to(torch.int32), out["wit_b"].to(torch.int32)
    out.update(counts)
    out["csum"] = torch.tensor(fold_int32(*(out[k] for k in integrity_mod.BAB_FOLD_KEYS)),
                               dtype=torch.int32)
    return out


def bab_segment(net, q_lo, q_hi, q_root, q_live, q_found, wit_a, wit_b, wit_pt,
                slot_ok, root_valid, assign_vals, pa_mask, ra_mask, eps,
                valid_pair, branch_mask, rounds: int, alpha_iters: int, live_slots: int):
    """K6: one device BaB segment, one launch (contract of
    :func:`bab_segment_plain`).  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/bab_segment.cu`` cooperatively (a grid-wide sync
    between each round's per-slot phase and its compaction, the geometry
    from :func:`bab_geometry`), updating copies of the queue tensors in
    place.  ``live_slots``: the live slots of ``q_live``, which the
    geometry reads, counted by the caller on the host (the device BaB
    keeps its queue there), so the launch does not sync."""
    args = (net, q_lo, q_hi, q_root, q_live, q_found, wit_a, wit_b, wit_pt, slot_ok,
            root_valid, assign_vals, pa_mask, ra_mask, eps, valid_pair, branch_mask,
            rounds, alpha_iters)
    if q_lo.device.type == "cpu":
        return bab_segment_plain(*args)
    cuda_build.require_cuda(q_lo)
    with launches.launching("bab_segment", (q_lo.shape[0], int(rounds), int(alpha_iters))):
        out = _bab_segment_launch(*args, live_slots=live_slots)
    return out


def _bab_segment_launch(net, q_lo, q_hi, q_root, q_live, q_found, wit_a, wit_b,
                        wit_pt, slot_ok, root_valid, assign_vals, pa_mask, ra_mask,
                        eps, valid_pair, branch_mask, rounds: int, alpha_iters: int,
                        live_slots: int, _geometry_force=None):
    """One K6 launch; ``_geometry_force`` (``(warps, blocks per SM)``)
    forces the launch geometry: the card's checks that a segment does not
    depend on it."""
    if net.layer_sizes[-1] != 1:
        raise ValueError("bab_segment: the net must have one output logit")
    params, dims = cuda_build.pack_odd(net)
    u8 = lambda t: t.to(torch.uint8).contiguous()
    # The queue is updated in place on one copy of each buffer.
    copy = lambda t, dt: t.to(dt, memory_format=torch.contiguous_format, copy=True)
    out = {"q_lo": copy(q_lo, torch.float32), "q_hi": copy(q_hi, torch.float32),
           "q_root": copy(q_root, torch.int32), "q_live": copy(q_live, torch.uint8),
           "found": copy(q_found, torch.uint8), "wit_a": copy(wit_a, torch.int32),
           "wit_b": copy(wit_b, torch.int32), "wit_pt": copy(wit_pt, torch.float32)}
    ins = [u8(slot_ok), u8(root_valid), assign_vals.contiguous(),
           pa_mask.contiguous(), ra_mask.contiguous(), u8(valid_pair),
           branch_mask.contiguous()]
    cuda_build.require_cuda(params, *out.values(), *ins)
    Q, d = q_lo.shape
    G, V = root_valid.shape
    dev = q_lo.device
    # Live slots at the start, counted up to one past K6_FEW_LIVE (all the
    # geometry reads; it keeps the memoized shapes few).
    if _geometry_force is not None:
        live = None
    else:
        live = min(int(live_slots), K6_FEW_LIVE + 1)
    geo = _bab_geometry(tuple(dims), V, Q, cuda_build.sm_count(dev), cuda_build.SMEM_LIMIT,
                        _geometry_force, live)
    # One zeroed buffer: nodes, splits, overflow (G each), the fold, each
    # round's slot counter; one scratch buffer: per slot the split plan
    # (4 ints) and the compaction's free-slot table.
    zeros = torch.zeros(3 * G + 1 + max(rounds, 1), dtype=torch.int32, device=dev)
    out["nodes"], out["splits"], out["overflow"] = zeros[:3 * G].view(3, G)
    fold, nxt = zeros[3 * G:3 * G + 1], zeros[3 * G + 1:]
    scratch = torch.empty(5 * Q, dtype=torch.int32, device=dev)
    table = scratch[4 * Q:]
    cuda_build.call("bab_segment", "k6_bab_segment", cuda_build.ptr(params), dims,
                    ctypes.c_int(net.depth),
                    *(cuda_build.ptr(out[k]) for k in integrity_mod.BAB_FOLD_KEYS),
                    *(cuda_build.ptr(t) for t in ins),
                    ctypes.c_float(float(np.float32(eps))), ctypes.c_int(Q),
                    ctypes.c_int(G), ctypes.c_int(V), ctypes.c_int(rounds),
                    ctypes.c_int(alpha_iters), cuda_build.ptr(scratch), cuda_build.ptr(table),
                    cuda_build.ptr(nxt), cuda_build.ptr(fold), ctypes.c_int(geo["warps"]),
                    ctypes.c_int(geo["grid"]), ctypes.c_longlong(geo["smem"]),
                    cuda_build.stream())
    out["q_live"], out["found"] = out["q_live"].bool(), out["found"].bool()
    out["csum"] = fold[0]
    return out




# ---------------------------------------------------------------------------
# Phases S, L and P: role logits, pre-activation bounds (K8b) and
# sign-constrained bounds (K8a) on the card; the LP BaBs on the host
# ---------------------------------------------------------------------------


def sample_role_logits(net, x_roles, xp_roles):
    """Logits of the sign conjecture's sampled role points: two (..., d)
    tensors → two (...) tensors, one launch.  CPU tensors take the plain
    forward (:func:`attack_logits_plain`); CUDA tensors launch the kernel of
    :func:`attack_logits` (``csrc/attack_logits.cu``) with one model, counted
    here and not there."""
    if x_roles.device.type == "cpu":
        return attack_logits_plain(net, x_roles, xp_roles)
    if net.layer_sizes[-1] != 1:
        raise ValueError("sample_role_logits: the net must have one output logit")
    if x_roles.shape != xp_roles.shape:
        raise ValueError("sample_role_logits: both role tensors need one shape")
    with launches.launching("role_logits", (tuple(x_roles.shape),)):
        out = _launch_attack_logits(net, x_roles, xp_roles, 1)
    return out




def inter_bounds(net, lo, hi, live=None):
    """K8b: CROWN pre-activation bounds of every layer for B boxes (B, d):
    lists ``(ws_lb, ws_ub)`` of (B, n_k) tensors, widened outward.  ``live``
    (default B): rows ``>= live`` get row ``live - 1``'s bounds — what a full
    call returns for them when they repeat that row's inputs (:func:`_pad`).
    CPU tensors take :func:`ops.crown.crown_bounds` on every row and the
    same fill; CUDA tensors launch ``csrc/inter_bounds.cu`` over the live
    rows only (the geometry from :func:`inter_bounds_geometry`)."""
    B = lo.shape[0]
    live = live_rows("inter_bounds", B, live)
    if lo.device.type == "cpu":
        b = crown_ops.crown_bounds(net, lo, hi)
        return ([fill_past(t, live) for t in b.ws_lb], [fill_past(t, live) for t in b.ws_ub])
    with launches.launching("inter_bounds", (B, live)):
        out = _inter_bounds_launch(net, lo, hi, live)
    return out


def _inter_bounds_launch(net, lo, hi, live: int, _geometry_force=None):
    """One launch of ``k8b_inter_bounds`` over the ``live`` first of the B
    rows; ``_geometry_force`` (``(warps, boxes a block)``) forces the
    geometry: the card's checks that the bounds do not depend on it."""
    fn, args, out = _inter_bounds_prepare(net, lo, hi, live, _geometry_force)
    cuda_build.check("k8b_inter_bounds", fn(*args, torch.cuda.current_stream().cuda_stream))
    sizes = tuple(args[1])[1:]
    return list(out[0].split(sizes, dim=1)), list(out[1].split(sizes, dim=1))


def _inter_bounds_prepare(net, lo, hi, live: int, _geometry_force=None):
    """``(entry point, its arguments but the stream, output tensor (2, B,
    sum(n_k)): lower, upper)`` of one ``k8b_inter_bounds`` launch, the
    geometry from :func:`inter_bounds_geometry`."""
    params, dims = cuda_build.pack_odd(net)
    lo, hi = lo.contiguous(), hi.contiguous()
    cuda_build.require_cuda(params, lo, hi)
    sizes = tuple(dims)
    B, nsum = lo.shape[0], sum(sizes[1:])
    sms = cuda_build.sm_count(lo.device)
    # The geometry reads only whether live <= sms and ceil(live / 2 sms):
    # one memoized shape per class.
    key = sms if live <= sms else _ceil(live, 2 * sms) * 2 * sms
    geo = _inter_bounds_geometry(sizes, key, sms, cuda_build.SMEM_LIMIT, _geometry_force)
    out = torch.empty((2, B, nsum), dtype=torch.float32, device=lo.device)
    args = (params.data_ptr(), dims, len(sizes) - 1, lo.data_ptr(), hi.data_ptr(), B, live,
            out.data_ptr(), out.data_ptr() + 4 * B * nsum, geo["warps"], geo["per"],
            geo["smem"])
    return cuda_build.entry("inter_bounds", "k8b_inter_bounds", _K8B_ARGS), args, out




def sign_bound_plain(net, lo, hi, signs, alpha_iters: int, trace=None):
    """K8a's plain version: ``(out_lo, out_hi, feasible, scores, resolved)``
    of :func:`ops.crown.sign_constrained_output_bounds`, and the final α/β
    of every layer's optimiser per box, flattened as the kernel exports
    them (per layer k >= 1: al, au, bl, bu of the layers j < k; empty at
    ``alpha_iters`` 0).  ``trace`` is passed on."""
    finals = {}

    def hook(k, pre, al, au, bl, bu, grads):
        if trace is not None:
            trace(k, pre, al, au, bl, bu, grads)
        if grads is None and alpha_iters > 0:
            finals[k] = al + au + bl + bu

    out = crown_ops.sign_constrained_output_bounds(net, lo, hi, signs, alpha_iters,
                                                   trace=hook)
    ab = torch.cat([torch.cat(finals[k], dim=-1) for k in sorted(finals)], dim=-1) \
        if finals else lo.new_zeros(lo.shape[:-1] + (0,))
    return out, ab


def sign_bound_ab_floats(sizes, alpha_iters: int) -> int:
    """Per-box length of K8a's α/β export for layer widths ``(d, n_0, ...)``."""
    if alpha_iters <= 0:
        return 0
    hidden = list(sizes[1:-1])
    return sum(4 * sum(hidden[:k]) for k in range(1, len(sizes) - 1))


def sign_bound(net, lo, hi, signs, alpha_iters: int, with_ab: bool = False, live=None):
    """K8a: β-CROWN output bounds of B boxes (B, d) under per-hidden-layer
    sign patterns (B, n_j) in {-1, 0, +1}, one launch; see
    :func:`ops.crown.sign_constrained_output_bounds` for the outputs.
    ``with_ab`` also returns the final α/β (:func:`sign_bound_plain`'s
    layout).  ``live`` (default B): rows ``>= live`` get row ``live - 1``'s
    outputs — what a full call returns for them when they repeat that row's
    inputs (:func:`_pad`).  CUDA tensors launch ``csrc/sign_bound.cu`` over
    the live rows only; CPU tensors take the plain version on every row
    (whose results for a row may depend on the batch's size in the last
    bits) and the same fill."""
    B = lo.shape[0]
    live = live_rows("sign_bound", B, live)
    if lo.device.type == "cpu":
        out, ab = sign_bound_plain(net, lo, hi, signs, alpha_iters)
        if live < B:
            fill = lambda t: fill_past(t, live)
            out = (fill(out[0]), fill(out[1]), fill(out[2]), [fill(t) for t in out[3]],
                   [fill(t) for t in out[4]])
            ab = fill(ab)
        return out + (ab,) if with_ab else out
    if net.layer_sizes[-1] != 1:
        raise ValueError("sign_bound: the net must have one output logit")
    sig = (lo.shape[0], int(alpha_iters), bool(with_ab), live)
    with launches.launching("sign_bound", sig):
        out = _sign_bound_launch(net, lo, hi, signs, alpha_iters, with_ab, live)
    return out


def _sign_bound_launch(net, lo, hi, signs, alpha_iters: int, with_ab: bool, live: int,
                       _geometry_force=None):
    """One launch of ``k8a_sign_bound`` over the ``live`` first of the B
    rows (the geometry from :func:`sign_bound_geometry`);
    ``_geometry_force`` (warps a block) forces it: the card's checks that
    the bounds do not depend on it."""
    params, dims = cuda_build.pack_odd(net)
    sizes = [net.in_dim] + list(net.layer_sizes)
    hidden = sizes[1:-1]
    B = lo.shape[0]
    lo, hi = lo.contiguous(), hi.contiguous()
    sg = torch.cat([s.to(torch.float32) for s in signs], dim=1).contiguous() if hidden \
        else lo.new_zeros((B, 0))
    cuda_build.require_cuda(params, lo, hi, sg)
    dev = lo.device
    sms = cuda_build.sm_count(dev)
    # Live rows up to one past the SM count: all the geometry reads (it
    # keeps the memoized shapes few).
    geo = _sign_bound_geometry(tuple(sizes), min(live, sms + 1), sms, cuda_build.SMEM_LIMIT,
                               _geometry_force)
    nh = sum(hidden)
    out_lo = torch.empty(B, dtype=torch.float32, device=dev)
    out_hi = torch.empty_like(out_lo)
    feasible = torch.empty(B, dtype=torch.uint8, device=dev)
    scores = torch.empty((B, max(nh, 1)), dtype=torch.float32, device=dev)
    resolved = torch.empty((B, max(nh, 1)), dtype=torch.int8, device=dev)
    ab_stride = sign_bound_ab_floats(sizes, alpha_iters)
    ab = torch.empty((B, ab_stride), dtype=torch.float32, device=dev) if with_ab else None
    cuda_build.call("sign_bound", "k8a_sign_bound", cuda_build.ptr(params), dims,
                    ctypes.c_int(net.depth), cuda_build.ptr(lo), cuda_build.ptr(hi),
                    cuda_build.ptr(sg), ctypes.c_int(B), ctypes.c_int(live),
                    ctypes.c_int(int(alpha_iters)), cuda_build.ptr(out_lo),
                    cuda_build.ptr(out_hi), cuda_build.ptr(feasible),
                    cuda_build.ptr(scores), cuda_build.ptr(resolved),
                    ctypes.c_void_p(ab.data_ptr() if ab is not None and ab.numel()
                                    else 0),
                    ctypes.c_int(geo["warps"]), ctypes.c_longlong(geo["smem"]),
                    cuda_build.stream())
    out = (out_lo, out_hi, feasible.bool(), list(scores[:, :nh].split(hidden, dim=1)),
           list(resolved[:, :nh].split(hidden, dim=1)))
    return out + (ab,) if with_ab else out




def leaf_sign_lp(weights, biases, masks, pattern, lo, hi, want_positive: bool):
    """LP endgame for a fully-resolved sign-BaB branch (an affine region).

    With every alive neuron's sign resolved, the net is affine over
    ``{x in box : s_j·z_j(x) >= 0}``, so the region's extremum is one small
    LP (scipy's HiGHS).  Evidence class f64 with a margin: 'certified'
    needs the extremum to clear 0 by ``1e-5 + 1e-7·scale``; borderline
    extrema return 'mixed'.  Returns 'certified' | 'infeasible' (empty
    region) | 'mixed'.
    """
    from scipy.optimize import linprog

    d = len(lo)
    A = np.eye(d)
    c = np.zeros(d)
    A_cons, b_cons = [], []
    for i, (w, b) in enumerate(zip(weights, biases)):
        w = np.asarray(w, np.float64)
        b = np.asarray(b, np.float64)
        Az = A @ w
        cz = c @ w + b
        if i < len(weights) - 1:
            s = np.asarray(pattern[i])
            m = np.asarray(masks[i]) > 0.5
            if ((s == 0) & m).any():
                return "mixed"  # unresolved neuron: region not affine
            for j in np.where(m)[0]:
                sj = float(s[j])
                A_cons.append(-sj * Az[:, j])
                b_cons.append(sj * cz[j])
            act = (m & (s > 0)).astype(np.float64)
            A = Az * act[None, :]
            c = cz * act
        else:
            A, c = Az, cz
    g = A[:, 0]
    c0 = float(c[0])
    sense = 1.0 if want_positive else -1.0
    res = linprog(sense * g,
                  A_ub=np.stack(A_cons) if A_cons else None,
                  b_ub=np.asarray(b_cons) if b_cons else None,
                  bounds=list(zip(np.asarray(lo, float), np.asarray(hi, float))),
                  method="highs")
    if res.status == 2:
        return "infeasible"
    if res.status != 0 or res.fun is None:
        return "mixed"
    extremum = sense * res.fun + c0  # min f if want_positive else max f
    scale = max(abs(c0), float(np.abs(g).sum()), 1.0)
    margin = 1e-5 + 1e-7 * scale
    if want_positive and extremum > margin:
        return "certified"
    if (not want_positive) and extremum < -margin:
        return "certified"
    return "mixed"


def sign_boxes(enc: PairEncoding, lo, hi):
    """Phase S's boxes (int64): the roots with RA dims widened by ε,
    because x' may leave the box."""
    slo = np.array(lo, dtype=np.int64)
    shi = np.array(hi, dtype=np.int64)
    if len(enc.ra_idx) and enc.eps:
        slo[:, enc.ra_idx] -= enc.eps
        shi[:, enc.ra_idx] += enc.eps
    return slo, shi


def uniform_sign_bab(net, enc: PairEncoding, roots_lo, roots_hi, cfg: EngineConfig,
                     deadline_s: float, mesh=None):
    """Phase S (with Phase L inside): prove a uniform logit sign over each
    root box by neuron-split BaB.

    A uniform output sign over the RA-widened partition box forbids every
    flip pair at once.  Per root the conjectured sign comes from the role
    logits of 32 sampled points (:func:`sample_role_logits`, one launch
    for all roots, the root axis padded to a power of two); a root with a
    mixed sample is not a candidate.  Phase L: one :func:`inter_bounds`
    launch per ``frontier_size`` block of candidates, then the host LP BaB
    (:func:`ops.lp.sign_bab_lp`) on the roots with at most
    ``lp_sign_max_unstable`` unstable neurons, fewest first; 'certified'
    settles a root UNSAT, 'refuted' settles it 'mixed'.  The rest share one
    device frontier of sign patterns, ``frontier_size`` per
    :func:`sign_bound` launch (K8a; padded to ``frontier_size`` as in JAX,
    the kernel launched over the batch's rows only), with BaBSR branching,
    the exact-region leaf LP (:func:`leaf_sign_lp`) on fully resolved
    branches, the per-root ``sign_max_nodes`` cap, and a root settled only
    after the whole batch that popped its last branch (siblings may share a
    batch).

    With a ``mesh`` (``parallel.mesh.Mesh``) every K8b and K8a batch is
    sharded over its ``parts`` axis (the net replicated) and trimmed back
    to the batch, as in JAX; the sign conjecture runs unsharded.

    Returns ``(verdicts, nodes, cost_s, lp_cost_s)``: per-root 'unsat' |
    'mixed', node counts (LP and device), attributed wall time (each
    batch's time split evenly over its branches) and its Phase-L share.
    """
    mesh_mod.require_mesh(mesh)
    sharded = mesh is not None
    t0 = time.perf_counter()
    R = roots_lo.shape[0]
    n_hidden = net.depth - 1
    if n_hidden == 0 or not len(enc.pa_idx):
        return (["mixed"] * R, np.zeros(R, np.int64),
                np.zeros(R, np.float64), np.zeros(R, np.float64))
    F = cfg.frontier_size
    dev = net.device
    on = lambda a: torch.as_tensor(a, device=dev)
    host_w, host_b = net.numpy_params()
    host_m = [m.detach().cpu().numpy() for m in net.masks]
    # The K8 batches (numpy in, numpy out, padded rows kept): one launch on
    # the net's device, or one per parts shard of the mesh.
    mesh, reps = mesh_mod.placement(net, mesh)
    batched = lambda fn, *arrays: mesh_mod.shard_map(mesh, fn, reps, *arrays)

    slo, shi = sign_boxes(enc, roots_lo, roots_hi)

    # Sign conjecture: any mixed sample disqualifies the root.  The root
    # axis is padded AFTER drawing, so the draws do not depend on it.
    rng = np.random.default_rng(cfg.seed + 3)
    xr, pr = build_attack_candidates(enc, rng, roots_lo, roots_hi, 32)
    r_pad = 1 << max(xr.shape[0] - 1, 0).bit_length()
    lx, lp = sample_role_logits(net, on(_pad(xr, r_pad)), on(_pad(pr, r_pad)))
    lx, lp = lx.cpu().numpy()[:R], lp.cpu().numpy()[:R]
    va = role_boxes(enc, np.asarray(roots_lo, np.float32),
                    np.asarray(roots_hi, np.float32))[4]
    allv_min = np.concatenate([
        np.where(va[:, None, :], lx, np.inf).reshape(R, -1),
        np.where(va[:, None, :], lp, np.inf).reshape(R, -1)], axis=1)
    allv_max = np.concatenate([
        np.where(va[:, None, :], lx, -np.inf).reshape(R, -1),
        np.where(va[:, None, :], lp, -np.inf).reshape(R, -1)], axis=1)
    has_valid = va.any(axis=-1)
    want_pos = (allv_min.min(axis=1) > 0.0) & has_valid
    want_neg = (allv_max.max(axis=1) < 0.0) & has_valid
    candidate = want_pos | want_neg

    hidden_sizes = list(net.layer_sizes[:n_hidden])
    zero_signs = [np.zeros(n, dtype=np.int8) for n in hidden_sizes]
    verdicts = ["mixed"] * R
    settled = ~candidate
    nodes = np.zeros(R, dtype=np.int64)
    # Device splits only: Phase L's LP nodes do not count against
    # sign_max_nodes.
    dev_nodes = np.zeros(R, dtype=np.int64)
    cost_s = np.zeros(R, dtype=np.float64)
    lp_cost = np.zeros(R, dtype=np.float64)

    if cfg.lp_sign and candidate.any():  # Phase L
        cand = np.where(candidate)[0]
        pre_lb = [np.zeros((R, n), np.float32) for n in net.layer_sizes]
        pre_ub = [np.zeros((R, n), np.float32) for n in net.layer_sizes]
        for s in range(0, len(cand), F):
            blk = cand[s:s + F]
            # Unsharded, K8b computes the block's rows only; a mesh keeps
            # its full padded shards.
            live = None if sharded else len(blk)
            wl, wu = batched(lambda m, lo, hi: inter_bounds(m, lo, hi, live=live),
                             _pad(slo[blk].astype(np.float32), F),
                             _pad(shi[blk].astype(np.float32), F))
            for L, (a, b) in enumerate(zip(wl, wu)):
                pre_lb[L][blk] = a[:len(blk)]
                pre_ub[L][blk] = b[:len(blk)]
        unstable = np.zeros(R, dtype=np.int64)
        for L in range(n_hidden):
            alive = host_m[L] > 0.5
            unstable[cand] += ((pre_lb[L][cand] < 0.0) & (pre_ub[L][cand] > 0.0)
                               & alive[None, :]).sum(axis=1)
        for r in cand[np.argsort(unstable[cand], kind="stable")]:
            r = int(r)
            remaining = deadline_s - (time.perf_counter() - t0)
            if remaining <= 0.0 or unstable[r] > cfg.lp_sign_max_unstable:
                break  # sorted ascending: the rest are all larger
            t_r = time.perf_counter()
            outcome, n_lp = lp_ops.sign_bab_lp(
                host_w, host_b, host_m, slo[r], shi[r],
                [pre_lb[L][r] for L in range(n_hidden)],
                [pre_ub[L][r] for L in range(n_hidden)], bool(want_pos[r]),
                max_nodes=cfg.lp_sign_max_nodes,
                deadline_s=min(cfg.soft_timeout_s, remaining))
            nodes[r] += n_lp
            dt_r = time.perf_counter() - t_r
            cost_s[r] += dt_r
            lp_cost[r] += dt_r
            if outcome == "certified":
                verdicts[r] = "unsat"
                settled[r] = True
            elif outcome == "refuted":
                settled[r] = True  # verdict stays 'mixed'

    frontier = deque((r, zero_signs) for r in range(R) if not settled[r])
    open_n = (~settled).astype(np.int64)
    while frontier:
        if (time.perf_counter() - t0) > deadline_s:
            break
        t_iter = time.perf_counter()
        items = []
        while frontier and len(items) < F:
            r, sgn = frontier.popleft()
            if not settled[r]:
                items.append((r, sgn))
        if not items:
            break
        batch = len(items)
        broot = np.array([r for r, _ in items])
        bsigns = [_pad(np.stack([sgn[j] for _, sgn in items]).astype(np.float32), F)
                  for j in range(n_hidden)]
        # subtract.at, not fancy-index -=: a root's two children routinely
        # share a batch, and x[idx] -= 1 decrements duplicates only once.
        np.subtract.at(open_n, broot, 1)
        np.add.at(nodes, broot, 1)
        np.add.at(dev_nodes, broot, 1)
        # Unsharded, K8a computes the batch's rows only; a mesh keeps its
        # full padded shards.
        live = None if sharded else batch
        out_lo, out_hi, feasible, scores, resolved = batched(
            lambda m, lo, hi, *sg: sign_bound(m, lo, hi, list(sg), cfg.alpha_iters,
                                              live=live),
            _pad(slo[broot].astype(np.float32), F), _pad(shi[broot].astype(np.float32), F),
            *bsigns)
        out_lo, out_hi, feasible = out_lo[:batch], out_hi[:batch], feasible[:batch]
        scores = [s[:batch] for s in scores]
        resolved = [s[:batch] for s in resolved]
        for k, (r, sgn) in enumerate(items):
            if settled[r]:
                continue
            if not feasible[k]:
                continue  # empty branch region: discharged
            if (want_pos[r] and out_lo[k] > 0.0) or (want_neg[r] and out_hi[k] < 0.0):
                continue  # branch certified
            if dev_nodes[r] > cfg.sign_max_nodes or \
                    (want_pos[r] and out_hi[k] < 0.0) or (want_neg[r] and out_lo[k] > 0.0):
                settled[r] = True  # over budget, or the bound contradicts the
                continue           # conjecture: verdict stays 'mixed'
            best_layer, best_idx, best_val = -1, -1, 0.0
            for j, s in enumerate(scores):
                i = int(s[k].argmax())
                if s[k][i] > best_val:
                    best_layer, best_idx, best_val = j, i, float(s[k][i])
            if best_layer < 0:
                # Fully resolved: the region is affine — finish it exactly.
                outcome = leaf_sign_lp(host_w, host_b, host_m,
                                       [rv[k] for rv in resolved], slo[r], shi[r],
                                       bool(want_pos[r]))
                if outcome == "mixed":
                    settled[r] = True
                continue  # certified / infeasible: branch discharged
            for forced in (1, -1):
                child = list(sgn)
                child[best_layer] = child[best_layer].copy()
                child[best_layer][best_idx] = forced
                frontier.append((r, child))
            open_n[r] += 2
        # Settle only after the whole batch: a root's popped sibling may
        # still be in this very batch.
        for r in set(int(x) for x in broot):
            if not settled[r] and open_n[r] == 0:
                verdicts[r] = "unsat"
                settled[r] = True
        np.add.at(cost_s, broot, (time.perf_counter() - t_iter) / batch)
    return verdicts, nodes, cost_s, lp_cost


def pair_lp_phase(net, enc: PairEncoding, roots_lo, roots_hi, verdicts, ces, nodes,
                  cost_s, cfg: EngineConfig, t0: float, deadline_s: float) -> None:
    """Phase P: the relational pair LP BaB over the roots still unknown.

    Per root, while more than a second of the deadline is left: one
    :func:`inter_bounds` launch on its 2V role boxes, then one
    :func:`ops.lp.pair_bab_lp` per valid ordered assignment pair (both flip
    directions when ε > 0).  Every direction killed → UNSAT; an exact
    witness → SAT; a direction left open → the root stays unknown.
    """
    host_w, host_b = net.numpy_params()
    host_m = [m.detach().cpu().numpy() for m in net.masks]
    nh = net.depth - 1
    V = enc.n_assign
    on = lambda a: torch.as_tensor(a, device=net.device)
    directions = (False,) if not enc.eps else (False, True)
    for r in [r for r, v in enumerate(verdicts) if v == "unknown"]:
        if deadline_s - (time.perf_counter() - t0) <= 1.0:
            break
        t_r = time.perf_counter()
        lo_r = np.asarray(roots_lo[r], dtype=np.int64)
        hi_r = np.asarray(roots_hi[r], dtype=np.int64)
        x_lo, x_hi, xp_lo, xp_hi, valid = role_boxes(
            enc, lo_r[None].astype(np.float32), hi_r[None].astype(np.float32))
        wl, wu = inter_bounds(net, on(np.concatenate([x_lo[0], xp_lo[0]])),
                              on(np.concatenate([x_hi[0], xp_hi[0]])))
        wl = [w.cpu().numpy() for w in wl]
        wu = [w.cpu().numpy() for w in wu]
        bounds_of = lambda i: ([wl[k][i] for k in range(nh)], [wu[k][i] for k in range(nh)])
        outcome, witness = "unsat", None
        pairs = [(a, b) for a in range(V) if valid[0, a] for b in range(V)
                 if valid[0, b] and enc.valid_pair[a, b]]
        for (a, b), flip in itertools.product(pairs, directions):
            rem = deadline_s - (time.perf_counter() - t0)
            if rem <= 0.5:
                outcome = "open"
                break
            status, n_lp, wit = lp_ops.pair_bab_lp(
                host_w, host_b, host_m, enc, lo_r, hi_r, enc.assignments[a],
                enc.assignments[b], bounds_of(a), bounds_of(V + b),
                max_nodes=cfg.lp_pair_max_nodes,
                deadline_s=min(cfg.soft_timeout_s, rem), flip=flip)
            nodes[r] += n_lp
            if status in ("sat", "open"):
                outcome, witness = status, wit
                break
        cost_s[r] += time.perf_counter() - t_r
        if outcome == "unsat":
            verdicts[r] = "unsat"
        elif outcome == "sat":
            verdicts[r], ces[r] = "sat", witness


# ---------------------------------------------------------------------------
# The refinement engine: Phase A (PGD) and the device BaB
# ---------------------------------------------------------------------------

@dataclass
class Decision:
    verdict: str  # 'sat' | 'unsat' | 'unknown'
    counterexample: Optional[Tuple[np.ndarray, np.ndarray]] = None
    nodes: int = 0
    leaves: int = 0
    elapsed_s: float = 0.0
    stats: dict = field(default_factory=dict)
    # Why an 'unknown' root stayed unknown: 'deadline', 'budget',
    # 'frontier:overflow' (the device queue ran out of slots), or
    # 'frontier:hard' (a stall with queue room, or an exact leaf that
    # returned unknown); legacy 'frontier' for a degraded segment.
    reason: Optional[str] = None
    # The phase that decided the root: 'attack' (Phase A), 'lp' (Phase L),
    # 'sign' (Phase S's device frontier), 'lattice_first' (Phase E0),
    # 'bab', 'pair' (Phase P) or 'lattice' (Phase E).
    phase: Optional[str] = None


def _branch_dims(enc: PairEncoding, d: int) -> np.ndarray:
    """Shared dims eligible for splitting: everything except PA."""
    return shared_dims(enc, d)


def _eligible_lattice_roots(enc, roots_lo, roots_hi, cfg) -> dict:
    """root index → enumerable scan size, for roots Phases E0/E can
    decide: the single eligibility rule (``ops.lattice.enumerable_size``)
    shared by decide_many's budget reserve and :func:`lattice_phase`'s
    queue, so the two never disagree."""
    if not cfg.lattice_exhaustive:
        return {}
    sizes = {}
    for r in range(roots_lo.shape[0]):
        n = lattice_ops.enumerable_size(enc, np.asarray(roots_lo[r], dtype=np.int64),
                                        np.asarray(roots_hi[r], dtype=np.int64))
        if n is not None and n <= cfg.lattice_max:
            sizes[r] = n
    return sizes


def lattice_phase(net, enc, roots_lo, roots_hi, verdicts, ces, cost_s, cfg, t0,
                  deadline_s, lat_sizes=None) -> None:
    """Phase E: exhaustive lattice enumeration of the still-unknown roots
    (``ops.lattice.decide_box_exhaustive``: K9a, or K9c for RA queries),
    smallest lattice first, while more than a second of the deadline is
    left.  A decided root takes its verdict and witness."""
    if lat_sizes is None:
        lat_sizes = _eligible_lattice_roots(enc, roots_lo, roots_hi, cfg)
    pending = sorted((r for r, v in enumerate(verdicts) if v == "unknown" and r in lat_sizes),
                     key=lambda r: lat_sizes[r])
    for r in pending:
        remaining = deadline_s - (time.perf_counter() - t0)
        if remaining <= 1.0:
            break
        _scan_root(net, enc, roots_lo, roots_hi, r, cfg, remaining, verdicts, ces, cost_s)


def _scan_root(net, enc, roots_lo, roots_hi, r, cfg, deadline_s, verdicts, ces,
               cost_s) -> bool:
    """One root through ``decide_box_exhaustive`` under ``deadline_s``: its
    time goes to ``cost_s[r]``; True (verdict and witness set) if decided."""
    t_r = time.perf_counter()
    verdict, ce = lattice_ops.decide_box_exhaustive(
        net, enc, np.asarray(roots_lo[r], dtype=np.int64),
        np.asarray(roots_hi[r], dtype=np.int64), chunk=cfg.lattice_chunk,
        deadline_s=deadline_s)
    cost_s[r] += time.perf_counter() - t_r
    if verdict == "unknown":
        return False
    verdicts[r], ces[r] = verdict, ce
    return True


def bab_segment_submit(net, q, root_valid, consts: dict, rounds: int, alpha_iters: int):
    """Launch one device-BaB segment without a sync: the host queue ``q``
    (``q_lo, q_hi, q_root, q_live, q_found, wit_a, wit_b, wit_pt`` numpy
    arrays) staged to the net's device, the live-slot count taken on the
    host; returns :func:`bab_segment`'s output dict."""
    on = lambda a: stage(a, net.device)
    return bab_segment(net, *(on(a) for a in q), root_valid=root_valid, rounds=rounds,
                       alpha_iters=alpha_iters, live_slots=int(np.sum(q[3])), **consts)


def bab_consts(net, enc, d: int, slot_ok, branch_mask) -> dict:
    """The device BaB's per-run constant tensors, staged to the net's
    device: the slot mask, the encoding tensors and the branch mask."""
    av, pm, rm = enc_tensors(enc, d)
    on = lambda a: stage(a, net.device)
    return dict(slot_ok=on(slot_ok), assign_vals=on(av), pa_mask=on(pm), ra_mask=on(rm),
                eps=float(enc.eps), valid_pair=on(enc.valid_pair),
                branch_mask=on(branch_mask))


def device_bab_phase(net, enc, roots_lo, roots_hi, cfg, t0, deadline_s,
                     verdicts, settle, nodes, leaves, cost_s):
    """Drive the device-resident BaB over every still-undecided root.

    Roots go in groups of ``G = Q // 4`` through one slot queue (capacity
    ``Q = bab_frontier_cap``, plus a canary slot when integrity is on);
    each group runs :func:`bab_segment` segments — segment 0 plain CROWN,
    later segments α-CROWN — until every root settles, the queue stalls,
    the node budget trips or the deadline does.  Each segment is one entry
    of a depth-1 :class:`parallel.pipeline.LaunchPipeline` with a
    supervisor (the ``launch.submit`` / ``launch.decode`` sites, retries,
    ``launch.decode:corrupt``).  Between segments the host does what must
    be exact: the fold and canary checks at every decode (a tripped check
    or a failed segment degrades exactly the group's roots: the queue
    never advances on a failed fetch), exact validation of witness latches
    (smallest candidate first, so the settled counterexample is
    capacity-invariant), :func:`decide_leaf` on point leaves, UNSAT for
    roots whose boxes all closed, and slot recycling.
    """
    from fairify_tpu_torch.resilience.supervisor import ChunkFailure, Supervisor

    d = roots_lo.shape[1]
    V = enc.n_assign
    Q = max(4, int(cfg.bab_frontier_cap))
    Qs = Q + 1 if cfg.integrity else Q
    G = max(1, Q // 4)
    branch_mask = np.zeros(d, np.float32)
    bd = _branch_dims(enc, d)
    if len(bd):
        branch_mask[bd] = 1.0
    assignments = np.asarray(enc.assignments, np.int64)
    pa_idx = np.asarray(enc.pa_idx, dtype=np.int64)
    slot_ok = np.zeros(Qs, bool)
    slot_ok[:Q] = True
    weights, biases = net.numpy_params()
    consts = bab_consts(net, enc, d, slot_ok, branch_mask)
    pending = [r for r in range(roots_lo.shape[0]) if verdicts[r] is None]
    pipe = LaunchPipeline(1, gauge=False,
                          supervisor=Supervisor(max_retries=cfg.max_launch_retries,
                                                backoff_s=cfg.launch_backoff_s,
                                                seed=cfg.seed))
    for g0 in range(0, len(pending), G):
        group = pending[g0:g0 + G]
        if (time.perf_counter() - t0) > deadline_s:
            for r in pending[g0:]:
                settle(r, "unknown", reason="deadline")
            break
        g = len(group)
        q_lo = np.zeros((Qs, d), np.float32)
        q_hi = np.zeros((Qs, d), np.float32)
        q_root = np.zeros(Qs, np.int32)
        q_live = np.zeros(Qs, bool)
        q_found = np.zeros(Qs, bool)
        wit_a = np.zeros(Qs, np.int32)
        wit_b = np.zeros(Qs, np.int32)
        wit_pt = np.zeros((Qs, d), np.float32)
        root_valid = np.zeros((G, V), bool)
        for k, r in enumerate(group):
            lo_r = np.asarray(roots_lo[r], dtype=np.int64)
            hi_r = np.asarray(roots_hi[r], dtype=np.int64)
            q_lo[k], q_hi[k], q_root[k], q_live[k] = lo_r, hi_r, k, True
            root_valid[k] = ((assignments >= lo_r[pa_idx][None, :])
                             & (assignments <= hi_r[pa_idx][None, :])).all(axis=-1)
        root_valid_dev = stage(root_valid, net.device)
        overflowed = np.zeros(g, bool)
        deadline_hit = False
        seg = 0
        while True:
            if (time.perf_counter() - t0) > deadline_s:
                deadline_hit = True
                break
            if not any(q_live[i] and verdicts[group[int(q_root[i])]] is None
                       for i in range(Q)):
                break
            prev_state = (q_lo.tobytes(), q_hi.tobytes(), q_live.tobytes())
            seg_t = time.perf_counter()
            # Segment-indexed escalation: segment 0 plain CROWN, later
            # segments α-CROWN, so verdicts do not depend on host speed.
            seg_alpha = 0 if seg == 0 else int(cfg.alpha_iters)

            def fn(q=(q_lo, q_hi, q_root, q_live, q_found, wit_a, wit_b, wit_pt),
                   seg_alpha=seg_alpha):
                return bab_segment_submit(net, q, root_valid_dev, consts,
                                          int(cfg.bab_rounds_per_segment), seg_alpha), None

            items = list(pipe.submit(fn))
            items.extend(pipe.drain())
            _meta, _ctx, host = items[0]
            failure = host if isinstance(host, ChunkFailure) else None
            if failure is None and cfg.integrity:
                tripped = integrity_mod.verify_bab_segment(host)
                if tripped is not None:
                    obs.registry().counter("integrity_violations").inc(
                        1, site="launch.decode")
                    obs.event("integrity_violation", site="launch.decode",
                              detector=tripped, phase="engine.device_bab")
                    failure = ChunkFailure(
                        site="integrity.launch.decode", kind="fatal",
                        error="IntegrityViolation",
                        detail=f"{tripped} mismatch (launch.decode)", retries=0)
            if failure is not None:
                # Blast radius: exactly this segment's root group.
                obs.registry().counter("chunks_degraded").inc(1, site=failure.site)
                obs.event("degraded", **failure.to_record(),
                          phase="engine.device_bab", partitions=len(group))
                for r in group:
                    settle(r, "unknown")
                break
            q_lo = np.array(host["q_lo"], np.float32)
            q_hi = np.array(host["q_hi"], np.float32)
            q_root = np.array(host["q_root"], np.int32)
            q_live = np.array(host["q_live"], bool)
            q_found = np.array(host["found"], bool)
            wit_a = np.array(host["wit_a"], np.int32)
            wit_b = np.array(host["wit_b"], np.int32)
            wit_pt = np.array(host["wit_pt"], np.float32)
            seg_nodes = np.asarray(host["nodes"], np.int64)
            seg_over = np.asarray(host["overflow"], np.int64)
            for k, r in enumerate(group):
                nodes[r] += int(seg_nodes[k])
                if seg_over[k] > 0:
                    overflowed[k] = True
            open_rs = [r for r in group if verdicts[r] is None]
            dt = time.perf_counter() - seg_t
            for r in open_rs:
                cost_s[r] += dt / len(open_rs)
            had_latch = bool(q_found.any())
            progressed = False
            cands: dict = {}
            for i in range(Qs):
                if not (q_found[i] and slot_ok[i]):
                    continue
                k = int(q_root[i])
                if k >= g or verdicts[group[k]] is not None:
                    continue
                pt = wit_pt[i].astype(np.int64)
                cands.setdefault(k, []).append(
                    (tuple(pt.tolist()), int(wit_a[i]), int(wit_b[i]), pt))
            for k in sorted(cands):
                r = group[k]
                for _pk, a, b, pt in sorted(cands[k], key=lambda c: (c[0], c[1], c[2])):
                    if verdicts[r] is not None:
                        break
                    x, xp = pt.copy(), pt.copy()
                    if len(pa_idx):
                        x[pa_idx] = assignments[a]
                        xp[pa_idx] = assignments[b]
                    if validate_pair(weights, biases, x, xp):
                        settle(r, "sat", (x, xp))
                        progressed = True
            q_found[:] = False  # latched slots rejoin the free pool
            for i in range(Q):
                if not q_live[i]:
                    continue
                r = group[int(q_root[i])]
                if verdicts[r] is not None:
                    continue
                w = (q_hi[i] - q_lo[i]) * branch_mask
                if w.size == 0 or float(w.max()) <= 0.0:
                    leaves[r] += 1
                    l_i = q_lo[i].astype(np.int64)
                    h_i = q_hi[i].astype(np.int64)
                    verdict, ce = decide_leaf(enc, weights, biases, l_i.copy(), l_i, h_i)
                    if verdict == "sat":
                        settle(r, "sat", ce)
                        progressed = True
                    elif verdict == "unknown":
                        settle(r, "unknown", reason="frontier:hard")
                        progressed = True
                    else:
                        q_live[i] = False
            for r in group:
                if verdicts[r] is None and nodes[r] > cfg.max_nodes:
                    settle(r, "unknown", reason="budget")
                    progressed = True
            for i in range(Q):
                if q_live[i] and verdicts[group[int(q_root[i])]] is not None:
                    q_live[i] = False
            live_k = {int(q_root[i]) for i in range(Q) if q_live[i]}
            for k, r in enumerate(group):
                if verdicts[r] is None and k not in live_k:
                    settle(r, "unsat")
                    progressed = True
            if (not progressed and not had_latch
                    and (q_lo.tobytes(), q_hi.tobytes(), q_live.tobytes()) == prev_state):
                break  # stalled: no clip/split/settle progress possible
            seg += 1
        for k, r in enumerate(group):
            if verdicts[r] is None:
                if deadline_hit:
                    settle(r, "unknown", reason="deadline")
                elif overflowed[k]:
                    settle(r, "unknown", reason="frontier:overflow")
                else:
                    settle(r, "unknown", reason="frontier:hard")


def host_frontier_phase(net, enc, roots_lo, roots_hi, cfg, t0, deadline_s,
                        main_deadline, verdicts, settle, nodes, leaves, cost_s,
                        mesh=None):
    """The host-frontier input-split BaB (``decide_many``'s batch loop):
    every still-undecided root's sub-boxes share one deque, popped
    ``frontier_size`` at a time.  On the CROWN path (the fused branch) one
    :func:`certify_attack` per batch (KB + KC on the card, over the batch's
    boxes only: ``live``) with ``bab_attack_samples`` candidates per box
    from ``default_rng(cfg.seed)`` (drawn for the batch padded to
    ``frontier_size``, as the JAX package draws them), α-CROWN once a fifth
    of ``deadline_s`` is spent.  On the IBP path
    (``use_crown=False``, the non-fused branch) the batch's role-logit
    bounds (:func:`role_logit_bounds`, row 13) and
    :func:`no_flip_certified` first, then candidates drawn for the
    undecided boxes only, padded to ``frontier_size``, through
    :func:`attack_logits` (row 17) and :func:`find_flips`.  Per uncertified
    box: an exactly replayed flip settles its root SAT; more than
    ``max_nodes`` nodes settles it unknown ('budget'); a zero-width box
    goes to :func:`decide_leaf`; otherwise the box splits at the midpoints
    of its top 1–3 dims by ``score·width`` (stable order; by width where
    every score is 0 and on the IBP path, which has no score), several dims
    at once when the frontier is underfull.  A root whose
    boxes are all gone is UNSAT; at ``main_deadline`` the rest are unknown
    ('deadline').  Each batch's time is split evenly over its boxes'
    roots.

    With a ``mesh`` (``parallel.mesh.Mesh``; the JAX package's mesh
    branch) the CROWN path takes the non-fused branch too: the batch's
    certificate and score by :func:`role_certify` (row 14, α-CROWN once a
    fifth of ``deadline_s`` is spent), sharded over the mesh's ``parts``
    axis and trimmed as JAX trims (``cert[:batch]``, ``score[:F]``), then
    the undecided boxes' candidates, drawn after it, through
    :func:`attack_logits` (row 17), sharded and trimmed to ``[:F]``; the
    IBP path's two launches are sharded the same way."""
    R = roots_lo.shape[0]
    F = cfg.frontier_size
    dev = net.device
    on = lambda a: torch.as_tensor(a, device=dev)
    fused = cfg.use_crown and mesh is None
    sharded = mesh is not None
    # The non-fused branch's batches (numpy in, numpy out): one launch on
    # the net's device, or one per parts shard of the mesh.
    mesh, reps = mesh_mod.placement(net, mesh)
    rng = np.random.default_rng(cfg.seed)
    weights, biases = net.numpy_params()
    branch_dims = _branch_dims(enc, roots_lo.shape[1])
    av, pm, rm = (on(a) for a in enc_tensors(enc, roots_lo.shape[1]))
    vpair = on(enc.valid_pair)
    frontier = deque((np.asarray(roots_lo[r], dtype=np.int64),
                      np.asarray(roots_hi[r], dtype=np.int64), r)
                     for r in range(R) if verdicts[r] is None)
    open_boxes = np.ones(R, dtype=np.int64)  # root boxes still in the frontier
    while frontier:
        if (time.perf_counter() - t0) > main_deadline:
            for _, _, r in frontier:
                settle(r, "unknown", reason="deadline")
            break
        t_iter = time.perf_counter()
        # Pop a batch, dropping sub-boxes of roots that settled meanwhile.
        blo_l, bhi_l, broot_l = [], [], []
        while frontier and len(blo_l) < F:
            l, h, r = frontier.popleft()
            if verdicts[r] is not None:
                continue
            blo_l.append(l)
            bhi_l.append(h)
            broot_l.append(r)
        if not blo_l:
            break
        batch = len(blo_l)
        blo, bhi, broot = np.stack(blo_l), np.stack(bhi_l), np.array(broot_l)
        for r in broot:
            open_boxes[r] -= 1
        np.add.at(nodes, broot, 1)
        live = np.array([verdicts[r] is None for r in broot])
        plo = _pad(blo, F).astype(np.float32)
        phi = _pad(bhi, F).astype(np.float32)
        x_lo, x_hi, xp_lo, xp_hi, valid = role_boxes(enc, plo, phi)
        score = None
        use_alpha = (cfg.use_crown and cfg.alpha_iters > 0
                     and time.perf_counter() - t0 > 0.2 * deadline_s)
        alpha = cfg.alpha_iters if use_alpha else 0
        if fused:
            xr, pr = build_attack_candidates(enc, rng, _pad(blo, F), _pad(bhi, F),
                                             cfg.bab_attack_samples)
            # KB and KC launch over the batch's boxes; the padded rows
            # (the numpy draw keeps them, so the RNG stream stays JAX's)
            # take box batch - 1's outputs.
            out = certify_attack(net, on(x_lo), on(x_hi), on(xp_lo), on(xp_hi), on(plo),
                                 on(phi), av, pm, rm, float(enc.eps), on(valid), vpair,
                                 on(xr), on(pr), alpha_iters=alpha, live=batch)
            cert, score, found_all, wit_all, _margin, _gap = (t.cpu().numpy()
                                                               for t in out)
            certified = cert[:batch]
        elif cfg.use_crown:  # the mesh branch: row 14, sharded
            cert, score, _margin = fetch(shard_certify(mesh, reps, enc,
                                                       (x_lo, x_hi, xp_lo, xp_hi), plo,
                                                       phi, valid, alpha_iters=alpha))
            certified, score = cert[:batch], score[:F]
        else:  # IBP: role bounds (row 13) first, then attack the undecided
            # Unsharded, row 13 computes the batch's boxes only; a mesh
            # keeps its full padded shards.
            live_b = None if sharded else batch
            bounds = [t[:F] for t in mesh_mod.shard_map(
                mesh, lambda m, *b: role_logit_bounds(m, *b, use_crown=False, live=live_b),
                reps, x_lo, x_hi, xp_lo, xp_hi)]
            certified = no_flip_certified(*bounds, valid, enc.valid_pair)[:batch]
        undecided = np.where(~certified & live)[0]
        if undecided.size:
            if fused:
                found, wit = found_all[undecided], wit_all[undecided]
                xr_u, pr_u = xr[undecided], pr[undecided]
            else:  # candidates for the undecided boxes only, padded to F
                xr_u, pr_u = build_attack_candidates(
                    enc, rng, _pad(blo[undecided], F), _pad(bhi[undecided], F),
                    cfg.bab_attack_samples)
                lx, lp = (t[:F] for t in mesh_mod.shard_map(mesh, attack_logits, reps,
                                                            xr_u, pr_u))
                found, wit = find_flips(enc, lx, lp, _pad(valid[undecided], F))
                found = found[:undecided.size]
            for k in np.where(found)[0]:
                r = int(broot[undecided[k]])
                if verdicts[r] is not None:
                    continue
                s_, a, b = wit[k]
                x = xr_u[k, s_, a].astype(np.int64)
                xp = pr_u[k, s_, b].astype(np.int64)
                if validate_pair(weights, biases, x, xp):
                    settle(r, "sat", (x, xp))
            for k in undecided:
                r = int(broot[k])
                if verdicts[r] is not None:
                    continue
                if nodes[r] > cfg.max_nodes:
                    settle(r, "unknown", reason="budget")
                    continue
                l, h = blo[k], bhi[k]
                widths = h[branch_dims] - l[branch_dims]
                if widths.size == 0 or widths.max() == 0:
                    leaves[r] += 1
                    verdict, ce = decide_leaf(enc, weights, biases, l.copy(), l, h)
                    if verdict == "sat":
                        settle(r, "sat", ce)
                    elif verdict == "unknown":
                        settle(r, "unknown")
                    continue
                # Coefficient-aware branching: the dims whose width adds most
                # to the difference bound's slack (score·width; the widest
                # dims on the IBP path, which has no score); several at once
                # while the frontier is underfull.
                sc = widths.astype(np.float64)
                if score is not None and float((score[k][branch_dims] * widths).max()) > 0:
                    sc = score[k][branch_dims] * widths
                n_dims = 1
                if len(frontier) + 2 * undecided.size < F // 2:
                    n_dims = 3 if len(frontier) + 4 * undecided.size < F // 4 else 2
                order = np.argsort(-sc, kind="stable")
                chosen = [int(branch_dims[j]) for j in order[:n_dims]
                          if widths[j] > 0][:n_dims]
                children = [(l, h)]
                for dim in chosen:
                    nxt = []
                    for cl, ch in children:
                        mid = (cl[dim] + ch[dim]) // 2
                        left_hi = ch.copy()
                        left_hi[dim] = mid
                        right_lo = cl.copy()
                        right_lo[dim] = mid + 1
                        nxt += [(cl, left_hi), (right_lo, ch)]
                    children = nxt
                for cl, ch in children:
                    frontier.append((cl, ch, r))
                open_boxes[r] += len(children)
        np.add.at(cost_s, broot, (time.perf_counter() - t_iter) / batch)
        # Roots whose sub-tree emptied without a counterexample are fair.
        for r in set(int(x) for x in broot):
            if verdicts[r] is None and open_boxes[r] == 0:
                settle(r, "unsat")
    for r in range(R):
        if verdicts[r] is None:
            settle(r, "unsat" if open_boxes[r] == 0 else "unknown", reason="deadline")


def attack_phase(net, enc, roots_lo, roots_hi, cfg, deadline_s, verdicts, ces, decided_by,
                 attack_cost) -> None:
    """Phase A: one K5 launch per chunk of at most 1,024 roots on a
    :class:`parallel.pipeline.LaunchPipeline` at ``cfg.pipeline_depth``
    with a supervisor (chunk N+1's launch is in flight while chunk N's
    witnesses go through exact validation), within a quarter of the
    deadline.  The chunks share one RNG stream, consumed at submit time, so
    it does not depend on the depth; a supervised retry replays the stream
    state of its first dispatch.  A degraded chunk leaves its roots
    unattacked, with their full certificate and BaB path."""
    from fairify_tpu_torch.resilience.supervisor import ChunkFailure, Supervisor

    R = roots_lo.shape[0]
    t_a = time.perf_counter()
    rng_a = np.random.default_rng(cfg.seed + 17)
    CH = min(1024, 1 << max(R - 1, 0).bit_length())
    weights, biases = net.numpy_params()
    pipe = LaunchPipeline(cfg.pipeline_depth, gauge=False,
                          supervisor=Supervisor(max_retries=cfg.max_launch_retries,
                                                backoff_s=cfg.launch_backoff_s,
                                                seed=cfg.seed))

    def consume(meta, ctx, host):
        if isinstance(host, ChunkFailure):
            obs.event("degraded", **host.to_record(), phase="engine.attack")
            return
        s_blk, n_blk = meta
        for i, ce in pgd_attack_decode(host, ctx, weights, biases).items():
            if i < n_blk and verdicts[s_blk + i] is None:
                verdicts[s_blk + i] = "sat"
                ces[s_blk + i] = ce
                decided_by[s_blk + i] = "attack"

    def replayable_submit(blk):
        state = {}

        def fn():
            if "s" not in state:
                state["s"] = rng_a.bit_generator.state
                r = rng_a
            else:
                r = np.random.default_rng()
                r.bit_generator.state = state["s"]
            return pgd_attack_submit(net, enc, np.asarray(roots_lo[blk], dtype=np.int64),
                                     np.asarray(roots_hi[blk], dtype=np.int64), r,
                                     steps=cfg.pgd_steps, restarts=cfg.pgd_restarts)
        return fn

    attack_deadline = 0.25 * deadline_s
    submitted = 0
    for s in range(0, R, CH):
        # In-flight chunks drain (and decode) past any break, so the deadline
        # gates the elapsed time plus the estimated backlog.
        elapsed = time.perf_counter() - t_a
        est = elapsed / max(submitted, 1)
        if elapsed + len(pipe) * est > attack_deadline:
            break
        submitted += 1
        blk = np.arange(s, min(s + CH, R))
        for item in pipe.submit(replayable_submit(blk), meta=(s, len(blk))):
            consume(*item)
    for item in pipe.drain():
        consume(*item)
    attack_cost[:] = (time.perf_counter() - t_a) / R


def decide_many(net, enc: PairEncoding, roots_lo, roots_hi, cfg: EngineConfig,
                deadline_s: Optional[float] = None, mesh=None,
                attacked: bool = False) -> list:
    """Decide many root boxes: Phases A, S (with L), E0, the device BaB, P, E.

    Port of the JAX package's ``decide_many`` for the phases the port has,
    in its order: Phase A (one :func:`pgd_attack` launch per chunk of at
    most 1,024 roots, a quarter of the deadline; skipped when
    ``attacked``); Phase S, the uniform-sign BaB with the host LP Phase L
    inside (:func:`uniform_sign_bab`, ``sign_bab_frac`` of the deadline);
    Phase E0, the lattice scan of the roots of at most
    ``lattice_first_max`` points (``lattice_exhaustive``); the
    device-resident BaB (:func:`device_bab_phase`) — or, with
    ``device_bab=False``, ``use_crown=False`` (the IBP path) or no
    protected attribute, the host-frontier BaB (:func:`host_frontier_phase`)
    — on what is left under ``main_deadline``; Phase P, the pair LP BaB
    (:func:`pair_lp_phase`), on the roots still unknown under
    ``pair_deadline``; Phase E (:func:`lattice_phase`) on the enumerable
    roots still unknown.  With a ``mesh`` (``parallel.mesh.Mesh``; anything
    else raises ``TypeError``) Phase S shards its K8 batches and the BaB is
    the host frontier's mesh branch (no device BaB, as in JAX); the other
    phases run unsharded on the net's device.
    ``deadline_s`` defaults to
    ``soft_timeout_s × n_roots``.  Returns one :class:`Decision` per root,
    with per-root attributed ``t_attack``, ``t_sign``, ``t_lp``,
    ``t_bab``, ``t_pair`` and ``t_lattice``.
    """
    mesh_mod.require_mesh(mesh)
    t0 = time.perf_counter()
    R = roots_lo.shape[0]
    if deadline_s is None:
        deadline_s = cfg.soft_timeout_s * max(R, 1)
    verdicts: list = [None] * R
    ces: list = [None] * R
    decided_by: list = [None] * R

    attack_cost = np.zeros(R, dtype=np.float64)
    if cfg.pgd_phase and not attacked and len(enc.pa_idx) and R:
        with obs.span("engine.attack", roots=R) as sp_a:
            attack_phase(net, enc, roots_lo, roots_hi, cfg, deadline_s, verdicts, ces,
                         decided_by, attack_cost)
            sp_a.set(sat=sum(1 for v in verdicts if v == "sat"))

    # Phase S (with L inside): the uniform-sign BaB under sign_bab_frac of
    # the deadline.  Its nodes and time go into the Decisions, not into
    # the pair BaB's max_nodes budget.
    sign_nodes = np.zeros(R, dtype=np.int64)
    sign_cost = np.zeros(R, dtype=np.float64)
    sign_lp_cost = np.zeros(R, dtype=np.float64)
    open_idx = np.array([r for r in range(R) if verdicts[r] is None], dtype=np.int64)
    if cfg.sign_bab and cfg.use_crown and cfg.alpha_iters > 0 and open_idx.size:
        with obs.span("engine.sign_bab", roots=int(open_idx.size)) as sp_s:
            sv, sn, sc, slp = uniform_sign_bab(
                net, enc, np.asarray(roots_lo)[open_idx].astype(np.int64),
                np.asarray(roots_hi)[open_idx].astype(np.int64), cfg,
                deadline_s=cfg.sign_bab_frac * deadline_s, mesh=mesh)
            sign_nodes[open_idx] = sn
            sign_cost[open_idx] = sc
            sign_lp_cost[open_idx] = slp
            for k, v in enumerate(sv):
                if v == "unsat":
                    r = int(open_idx[k])
                    verdicts[r] = "unsat"
                    # Phase L settles a root before the frontier sees it.
                    decided_by[r] = "lp" if sign_cost[r] == sign_lp_cost[r] else "sign"
            sp_s.set(unsat=sum(1 for v in sv if v == "unsat"), nodes=int(np.sum(sn)))
    # Phase E0: a time-boxed exhaustive enumeration of the cheap enumerable
    # roots (lattice at most lattice_first_max points), smallest first,
    # before the device BaB; the scan exits on the first flip.  It stops
    # once 40% of the deadline is spent, each root gets at most
    # lattice_first_cap_s, and a root it leaves unknown keeps its full path.
    lat_sizes = _eligible_lattice_roots(enc, roots_lo, roots_hi, cfg)
    lat_cost = np.zeros(R, dtype=np.float64)
    if cfg.lattice_exhaustive and lat_sizes:
        cheap = sorted((r for r in range(R) if verdicts[r] is None
                        and lat_sizes.get(r, np.inf) <= cfg.lattice_first_max),
                       key=lambda r: lat_sizes[r])
        with obs.span("engine.lattice_first", roots=len(cheap)) as sp_e0:
            for r in cheap:
                spent = time.perf_counter() - t0
                if spent > 0.4 * deadline_s:
                    break
                if _scan_root(net, enc, roots_lo, roots_hi, r, cfg,
                              min(deadline_s - spent, cfg.lattice_first_cap_s), verdicts,
                              ces, lat_cost):
                    decided_by[r] = "lattice_first"
            sp_e0.set(decided=sum(1 for r in cheap if decided_by[r] == "lattice_first"))
    open_roots = [r for r in range(R) if verdicts[r] is None]

    nodes = np.zeros(R, dtype=np.int64)
    leaves = np.zeros(R, dtype=np.int64)
    cost_s = np.zeros(R, dtype=np.float64)
    n_dirs = int(enc.valid_pair.sum())
    use_pair = bool(cfg.lp_pair and len(enc.pa_idx) and 0 < n_dirs <= cfg.lp_pair_max_dirs)
    lat_sizes = {r: n for r, n in lat_sizes.items() if verdicts[r] is None}
    lat_frac = 0.0
    if lat_sizes and any(n >= cfg.lattice_reserve_min for n in lat_sizes.values()):
        est_s = 120.0 + sum(lat_sizes.values()) / 1.0e6
        lat_frac = min(cfg.lattice_frac, est_s / max(deadline_s, 1e-9))
    pair_deadline = deadline_s * (1.0 - lat_frac)
    main_deadline = pair_deadline * (1.0 - cfg.lp_pair_frac) if use_pair else pair_deadline

    unknown_reasons: dict = {}

    def settle(r: int, verdict: str, ce=None, reason: Optional[str] = None):
        if verdicts[r] is None:
            verdicts[r] = verdict
            ces[r] = ce
            if verdict == "unknown":
                unknown_reasons[r] = reason or "frontier"

    use_dev_bab = bool(open_roots and cfg.device_bab and cfg.use_crown and mesh is None
                       and len(enc.pa_idx))
    if use_dev_bab:
        with obs.span("engine.device_bab", roots=len(open_roots)) as sp_d:
            device_bab_phase(net, enc, roots_lo, roots_hi, cfg, t0, main_deadline,
                             verdicts, settle, nodes, leaves, cost_s)
            sp_d.set(decided=len(open_roots) - sum(1 for v in verdicts if v == "unknown"),
                     nodes=int(nodes.sum()))
    with obs.span("engine.bab", roots=0 if use_dev_bab else len(open_roots)) as sp_bab:
        if open_roots and not use_dev_bab:
            host_frontier_phase(net, enc, roots_lo, roots_hi, cfg, t0, deadline_s,
                                main_deadline, verdicts, settle, nodes, leaves, cost_s,
                                mesh=mesh)
            sp_bab.set(nodes=int(nodes.sum()))
    def mark(phase: str) -> None:
        for r in range(R):
            if decided_by[r] is None and verdicts[r] in ("sat", "unsat"):
                decided_by[r] = phase

    mark("bab")
    pair_cost = np.zeros(R, dtype=np.float64)
    if use_pair and any(v == "unknown" for v in verdicts):
        n_unk = sum(1 for v in verdicts if v == "unknown")
        with obs.span("engine.pair_lp", roots=n_unk) as sp_p:
            pair_lp_phase(net, enc, roots_lo, roots_hi, verdicts, ces, nodes, pair_cost,
                          cfg, t0, pair_deadline)
            sp_p.set(decided=n_unk - sum(1 for v in verdicts if v == "unknown"))
        mark("pair")
    # Phase E: the roots still unknown, smallest lattice first, while more
    # than a second of the deadline is left.
    if lat_sizes and any(v == "unknown" for v in verdicts):
        n_unk = sum(1 for v in verdicts if v == "unknown")
        with obs.span("engine.lattice", roots=n_unk) as sp_e:
            lattice_phase(net, enc, roots_lo, roots_hi, verdicts, ces, lat_cost, cfg, t0,
                          deadline_s, lat_sizes=lat_sizes)
            sp_e.set(decided=n_unk - sum(1 for v in verdicts if v == "unknown"))
        mark("lattice")
    # Per-root attribution: A = PGD, S = the sign frontier, L = its host
    # LP, bab = the device BaB, P = the pair LP, E0 + E = the lattice
    # scans; sums to elapsed_s.
    return [
        Decision(verdicts[r], ces[r], nodes=int(nodes[r] + sign_nodes[r]),
                 leaves=int(leaves[r]),
                 elapsed_s=float(attack_cost[r] + cost_s[r] + sign_cost[r]
                                 + pair_cost[r] + lat_cost[r]),
                 stats={"t_attack": float(attack_cost[r]),
                        "t_sign": float(sign_cost[r] - sign_lp_cost[r]),
                        "t_lp": float(sign_lp_cost[r]), "t_bab": float(cost_s[r]),
                        "t_pair": float(pair_cost[r]), "t_lattice": float(lat_cost[r])},
                 reason=(unknown_reasons.get(r, "frontier")
                         if verdicts[r] == "unknown" else None),
                 phase=decided_by[r])
        for r in range(R)
    ]


def decide_box(net, enc: PairEncoding, lo, hi, cfg: EngineConfig) -> Decision:
    """Complete decision for one partition box (single-root wrapper)."""
    return decide_many(net, enc, np.asarray(lo)[None, :], np.asarray(hi)[None, :],
                       cfg, deadline_s=cfg.soft_timeout_s)[0]
