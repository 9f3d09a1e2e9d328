"""Batched CROWN backward linear-relaxation bounds, with α- and β-CROWN.

Port of ``fairify_tpu/ops/crown.py``: the ReLU triangle relaxation
(:func:`relu_relaxation`), the backward pass that expresses a layer's
pre-activations as linear forms of the input, optionally with tuned lower
slopes α and the β penalties of sign-split constraints
(:func:`backward_linear`), their concretization over the input box, the
full-network CROWN bounds intersected with IBP (:func:`crown_bounds`), the
signed-gradient α/β optimiser (:func:`optimize_relaxation`), the output
bounds under per-neuron sign splits that Phase S branches on
(:func:`sign_constrained_output_bounds`), the output-logit linear forms
the tied pair certificate consumes (:func:`crown_output_form_sets`,
:func:`output_form_stack`), and the standalone α-CROWN output bounds
(:func:`alpha_crown_output_bounds`, K7: ``csrc/role_bounds.cu`` on the
card, :func:`alpha_crown_output_bounds_plain` on the CPU).

The α/β gradient follows JAX's tie rules, so the iterates are JAX's:
every positive/negative split is ``torch.maximum``/``torch.minimum``
against 0 (½ of the gradient to each side at 0, like ``jnp.maximum``),
never ``torch.clamp`` (which passes all of it).

Every function takes arbitrary leading batch axes on the box tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from fairify_tpu_torch.obs import launches
from fairify_tpu_torch.ops.interval import LayerBounds, affine_interval, widen
from fairify_tpu_torch.ops.interval import widen as _widen  # where `widen` is a flag
from fairify_tpu_torch.utils import cuda_build

def _pos(a):
    return torch.maximum(a, a.new_zeros(()))


def _neg(a):
    return torch.minimum(a, a.new_zeros(()))


def relu_relaxation(lo, hi, mask):
    """Per-neuron CROWN envelope: (upper slope, upper intercept, lower slope).

    Stable-active neurons get slope 1 / intercept 0, stable-dead (or pruned)
    0/0, unstable the triangle relaxation with the adaptive lower slope
    ``1 if hi >= -lo else 0``.
    """
    unstable = (lo < 0.0) & (hi > 0.0)
    one = torch.ones_like(lo)
    denom = torch.where(unstable, hi - lo, one)
    us = torch.where(unstable, hi / denom, (lo >= 0.0).to(lo.dtype))
    ui = torch.where(unstable, -hi * lo / denom, torch.zeros_like(lo))
    ls = torch.where(unstable, (hi >= -lo).to(lo.dtype), us)
    return us * mask, ui * mask, ls * mask


def backward_linear(net, k: int, pre_lbs, pre_ubs, batch, alphas_low=None,
                    alphas_up=None, beta_signs=None, betas_low=None, betas_up=None):
    """Linear forms of layer-k pre-activations in terms of the input.

    Returns ``(A_low, c_low, A_up, c_up)`` with ``A_*`` of shape
    ``batch + (d, n_k)`` and ``c_*`` of shape ``batch + (n_k,)`` such that
    ``x @ A_low + c_low <= z_k <= x @ A_up + c_up`` over the box the
    ``pre_*`` bounds were computed for.  ``alphas_low``/``alphas_up``:
    optional per-hidden-layer (..., n_j) lower ReLU slopes in [0, 1] for
    the unstable neurons of the lower / upper form (any value is sound);
    None keeps the adaptive slope.

    ``beta_signs``/``betas_low``/``betas_up``: per-hidden-layer (..., n_j)
    split constraints ``s_j · z_j >= 0`` (s in {-1, 0, +1}) and their
    multipliers β >= 0.  By weak duality the constraint enters as the exact
    linear penalty ``∓β·s`` on the z_j coefficients of the lower / upper
    form, so the forms bound z_k over the box points that satisfy the
    splits.
    """
    w_k = net.weights[k]
    n_k = w_k.shape[1]
    A_low = w_k.expand(*batch, *w_k.shape)
    A_up = A_low
    c_low = net.biases[k].expand(*batch, n_k)
    c_up = c_low
    for j in range(k - 1, -1, -1):
        us, ui, ls = relu_relaxation(pre_lbs[j], pre_ubs[j], net.masks[j])
        unstable = (pre_lbs[j] < 0.0) & (pre_ubs[j] > 0.0)
        m = net.masks[j]
        ls_low = ls if alphas_low is None else torch.where(unstable, alphas_low[j], ls) * m
        ls_up = ls if alphas_up is None else torch.where(unstable, alphas_up[j], ls) * m
        # Through h_j = relu(z_j): pick the relaxation per coefficient sign.
        Ap, An = _pos(A_low), _neg(A_low)
        c_low = c_low + (ui.unsqueeze(-2) @ An).squeeze(-2)
        A_low = Ap * ls_low.unsqueeze(-1) + An * us.unsqueeze(-1)
        Ap, An = _pos(A_up), _neg(A_up)
        c_up = c_up + (ui.unsqueeze(-2) @ Ap).squeeze(-2)
        A_up = Ap * us.unsqueeze(-1) + An * ls_up.unsqueeze(-1)
        if beta_signs is not None:  # the split penalties on z_j
            A_low = A_low - (betas_low[j] * beta_signs[j]).unsqueeze(-1)
            A_up = A_up + (betas_up[j] * beta_signs[j]).unsqueeze(-1)
        # Through z_j = h_{j-1} @ w_j + b_j.
        w_j, b_j = net.weights[j], net.biases[j]
        c_low = c_low + b_j @ A_low
        c_up = c_up + b_j @ A_up
        A_low = w_j @ A_low
        A_up = w_j @ A_up
    return A_low, c_low, A_up, c_up


def concretize(A_low, c_low, A_up, c_up, in_lb, in_ub):
    """Extreme values of the linear forms over the input box."""
    lb, ub = in_lb.unsqueeze(-2), in_ub.unsqueeze(-2)
    lo = (lb @ _pos(A_low)).squeeze(-2) + (ub @ _neg(A_low)).squeeze(-2) + c_low
    hi = (ub @ _pos(A_up)).squeeze(-2) + (lb @ _neg(A_up)).squeeze(-2) + c_up
    return lo, hi


def backward_bounds(net, k: int, pre_lbs, pre_ubs, in_lb, in_ub,
                    alphas_low=None, alphas_up=None, beta_signs=None,
                    betas_low=None, betas_up=None):
    """CROWN bounds ``(lo, hi)`` (..., n_k) of layer-k pre-activations."""
    forms = backward_linear(net, k, pre_lbs, pre_ubs, in_lb.shape[:-1],
                            alphas_low, alphas_up, beta_signs, betas_low, betas_up)
    return concretize(*forms, in_lb, in_ub)


def optimize_relaxation(width, init, iters: int, with_beta: bool = False,
                        lr0: float = 0.5, decay: float = 0.7, lr_b: float = 0.8,
                        trace=None):
    """Signed-gradient ascent on the α (and β) of a CROWN relaxation.

    ``width(al, au) -> (summed_width, (lo, hi))``, or ``width(al, au, bl,
    bu)`` with ``with_beta``; ``init`` the per-layer starting α (the
    adaptive slope); β starts at 0.  Per iteration: evaluate, keep the best
    (lo, hi) so far, step ``α ← clip(α − lr·sign(∂width/∂α), 0, 1)`` and
    ``β ← max(β − lr_b·sign(∂width/∂β), 0)``, ``lr ← lr·decay``; the final
    parameters are evaluated once more.  Every iterate is a valid
    relaxation, so the kept bounds are sound.  Returns ``(lo, hi, al,
    au)`` with the final α's.  The step size is carried in f32 like the
    JAX package's ``lax.fori_loop`` carry.

    ``trace(al, au, bl, bu, grads)``, when given, sees every evaluated
    iterate before its step (``grads`` the width's gradients in the order
    al, au, bl, bu; None at the final evaluation; ``bl``/``bu`` empty
    without β).
    """
    al = [a.detach() for a in init]
    au = [a.detach() for a in init]
    bl = [torch.zeros_like(a) for a in al] if with_beta else []
    bu = [torch.zeros_like(a) for a in al] if with_beta else []
    n = len(al)
    lr = np.float32(lr0)
    best_lo = best_hi = None
    for _ in range(iters):
        params = [a.clone().requires_grad_(True) for a in al + au + bl + bu]
        with torch.enable_grad():
            w, (lo, hi) = width(*_groups(params, n, with_beta))
            grads = torch.autograd.grad(w, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if trace is not None:
            trace(al, au, bl, bu, grads)
        lo, hi = lo.detach(), hi.detach()
        best_lo = lo if best_lo is None else torch.maximum(best_lo, lo)
        best_hi = hi if best_hi is None else torch.minimum(best_hi, hi)
        sa = lambda a, g: torch.clamp(a - float(lr) * torch.sign(g), 0.0, 1.0)
        sb = lambda b, g: torch.clamp(b - lr_b * torch.sign(g), min=0.0)
        al = [sa(a, g) for a, g in zip(al, grads[:n])]
        au = [sa(a, g) for a, g in zip(au, grads[n:2 * n])]
        bl = [sb(b, g) for b, g in zip(bl, grads[2 * n:3 * n])]
        bu = [sb(b, g) for b, g in zip(bu, grads[3 * n:])]
        lr = np.float32(lr * np.float32(decay))
    with torch.no_grad():
        _, (lo, hi) = width(*_groups(al + au + bl + bu, n, with_beta))
    if trace is not None:
        trace(al, au, bl, bu, None)
    best_lo = lo if best_lo is None else torch.maximum(best_lo, lo)
    best_hi = hi if best_hi is None else torch.minimum(best_hi, hi)
    return best_lo, best_hi, al, au


def _groups(params, n: int, with_beta: bool):
    """(al, au[, bl, bu]) lists out of one flat parameter list."""
    return [params[i * n:(i + 1) * n] for i in range(4 if with_beta else 2)]


def crown_bounds(net, lb, ub, widen_bounds: bool = True) -> LayerBounds:
    """Full-network CROWN pre-activation bounds, intersected with IBP and
    (``widen_bounds``) widened outward; layer 0 is the exact affine
    interval."""
    n = net.depth
    ws_lb, ws_ub, pl_lb, pl_ub = [], [], [], []
    lo_run, hi_run = lb, ub
    batch = lb.shape[:-1]
    for k in range(n):
        zlo, zhi = affine_interval(net.weights[k], net.biases[k], lo_run, hi_run)
        if k > 0:
            forms = backward_linear(net, k, ws_lb, ws_ub, batch)
            zlo_c, zhi_c = concretize(*forms, lb, ub)
            zlo = torch.maximum(zlo, zlo_c)
            zhi = torch.minimum(zhi, zhi_c)
        if widen_bounds:
            zlo, zhi = widen(zlo, zhi)
        ws_lb.append(zlo)
        ws_ub.append(zhi)
        if k == n - 1:
            plo, phi = zlo, zhi
        else:
            m = net.masks[k]
            plo, phi = torch.relu(zlo) * m, torch.relu(zhi) * m
        pl_lb.append(plo)
        pl_ub.append(phi)
        lo_run, hi_run = plo, phi
    return LayerBounds(tuple(ws_lb), tuple(ws_ub), tuple(pl_lb), tuple(pl_ub))


def crown_output_bounds(net, lb, ub, widen: bool = True):
    """CROWN bounds ``(lo, hi)`` of the output logit over a batch of boxes."""
    bounds = crown_bounds(net, lb, ub, widen_bounds=widen)
    return bounds.ws_lb[-1][..., 0], bounds.ws_ub[-1][..., 0]


def alpha_crown_output_bounds_plain(net, lb, ub, iters: int = 8, widen: bool = True):
    """Plain PyTorch version of :func:`alpha_crown_output_bounds`: plain
    CROWN bounds (``crown_bounds``, widened) fix every intermediate layer;
    the final backward pass is re-run with free lower slopes α in [0, 1]
    for the unstable neurons, separate sets for the lower and the upper
    bound, tuned by :func:`optimize_relaxation` from the adaptive slopes.
    The best bounds over every iterate (the final one included) are
    widened once (``widen``) and intersected with plain CROWN, so they are
    never looser.  With ``iters`` 0 (or no hidden layer) they are plain
    CROWN's."""
    bounds = crown_bounds(net, lb, ub)
    k = net.depth - 1
    pre_lbs, pre_ubs = bounds.ws_lb[:k], bounds.ws_ub[:k]
    lo0, hi0 = bounds.ws_lb[-1][..., 0], bounds.ws_ub[-1][..., 0]
    if k == 0 or iters <= 0:
        return lo0, hi0

    def width(al_, au_):
        lo, hi = backward_bounds(net, k, pre_lbs, pre_ubs, lb, ub, al_, au_)
        return (hi[..., 0] - lo[..., 0]).sum(), (lo[..., 0], hi[..., 0])

    init = [(pre_ubs[j] >= -pre_lbs[j]).to(lb.dtype) for j in range(k)]
    opt_lo, opt_hi, _, _ = optimize_relaxation(width, init, iters)
    if widen:
        opt_lo, opt_hi = _widen(opt_lo, opt_hi)
    return torch.maximum(opt_lo, lo0), torch.minimum(opt_hi, hi0)


def alpha_crown_output_bounds(net, lb, ub, iters: int = 8, widen: bool = True):
    """K7: α-CROWN bounds ``(lo, hi)`` of the output logit over boxes with
    any leading axes (..., d), the JAX package's
    ``ops/crown.py:alpha_crown_output_bounds`` with its full signature:
    ``widen`` False leaves the best α bounds unwidened before they are
    intersected with (widened) plain CROWN.  One launch.  CPU tensors take
    :func:`alpha_crown_output_bounds_plain`; CUDA tensors launch
    ``csrc/role_bounds.cu``'s ``k7_alpha_output_bounds`` on the boxes
    flattened to (B, d) (the geometry from ``engine.k7_geometry``)."""
    if lb.device.type == "cpu":
        return alpha_crown_output_bounds_plain(net, lb, ub, iters, widen)
    lead = lb.shape[:-1]
    with launches.launching("alpha_crown", (tuple(lb.shape), int(iters))):
        fn, args, out = _alpha_crown_prepare(net, lb.reshape(-1, lb.shape[-1]),
                                             ub.reshape(-1, ub.shape[-1]), iters, widen)
        cuda_build.check("k7_alpha_output_bounds",
                         fn(*args, torch.cuda.current_stream().cuda_stream))
    return out[0].reshape(lead), out[1].reshape(lead)


_VP, _INT = ctypes.c_void_p, ctypes.c_int
_K7_ARGS = ((_VP, ctypes.POINTER(_INT), _INT, _VP, _VP) + (_INT,) * 3 + (_VP, _VP, _INT, _INT,
            ctypes.c_longlong, _VP))


def _alpha_crown_prepare(net, lb, ub, iters: int, widen: bool, _geometry_force=None):
    """``(entry point, its arguments but the stream, output tensor (2, B):
    lower, upper)`` of one ``k7_alpha_output_bounds`` launch on (B, d) CUDA
    boxes, the geometry from ``engine.k7_geometry``; ``_geometry_force``
    (``(boxes a block, warps)``) forces it: the card's checks that the
    bounds do not depend on it."""
    from fairify_tpu_torch.verify import engine  # engine imports this module

    if net.layer_sizes[-1] != 1:
        raise ValueError("alpha_crown_output_bounds: the net must have one output logit")
    if lb.shape != ub.shape or lb.dtype != torch.float32 or ub.dtype != torch.float32:
        raise ValueError("alpha_crown_output_bounds: lb and ub must be float32 of one shape")
    params, dims = cuda_build.pack_odd(net)
    lb, ub = lb.contiguous(), ub.contiguous()
    cuda_build.require_cuda(params, lb, ub)
    sizes = tuple(dims)
    B = lb.shape[0]
    geo = engine._k7_geometry(sizes, B, cuda_build.sm_count(lb.device), cuda_build.SMEM_LIMIT,
                              _geometry_force)
    out = torch.empty((2, B), dtype=torch.float32, device=lb.device)
    args = (params.data_ptr(), dims, len(sizes) - 1, lb.data_ptr(), ub.data_ptr(), B,
            int(iters), int(bool(widen)), out.data_ptr(), out.data_ptr() + 4 * B, geo["per"],
            geo["warps"], geo["smem"])
    return cuda_build.entry("role_bounds", "k7_alpha_output_bounds", _K7_ARGS), args, out




def sign_constrained_output_bounds(net, lb, ub, signs, alpha_iters: int = 0,
                                   trace=None):
    """Output bounds under per-neuron activation-sign branch constraints.

    ``signs``: per-hidden-layer (..., n_j) tensors — +1 forces the neuron
    active (pre-activation >= 0), -1 inactive (<= 0), 0 free — the splits
    of the β-CROWN family, enforced by clamps (the constrained neuron's own
    interval is clipped at 0, stabilising its relaxation for deeper layers)
    and by β multipliers in every backward pass (the penalty that carries
    the constraint into the concretized bound).  With ``alpha_iters > 0``
    every layer k >= 1 has its own bounds α/β-optimised over its n_k
    outputs (:func:`optimize_relaxation` on the summed width, β >= 0),
    from the adaptive slopes and β = 0; with 0, one pass with β = 0.

    Returns ``(out_lo, out_hi, feasible, scores, resolved)``: the widened
    output-logit bounds (...,) over the box points that satisfy the
    pattern; ``feasible`` (...,) False when a clamp emptied an interval;
    per hidden layer the BaBSR scores ``ub·(−lb)/(ub−lb)`` of still-
    unstable alive neurons (0 elsewhere) and the int8 signs every alive
    neuron is known to have in the branch (0 = unstable).

    ``trace(k, pre, al, au, bl, bu, grads)``, when given, sees every
    relaxation layer k's bounds are taken from: each iterate of its
    optimiser (see :func:`optimize_relaxation`), or with ``alpha_iters``
    0 the one pass (the adaptive slopes as α, β = 0, ``grads`` None);
    ``pre`` holds the layer's inputs ``(ws_lb, ws_ub, sgn)``: the clamped
    bounds of the layers j < k and their β signs.
    """
    n = net.depth
    ws_lb, ws_ub, feas = [], [], None
    scores, resolved = [], []
    lo_run, hi_run = lb, ub
    sgn = None
    zero = lb.new_zeros(())
    for k in range(n):
        zlo, zhi = affine_interval(net.weights[k], net.biases[k], lo_run, hi_run)
        if k > 0:
            pre = (tuple(ws_lb), tuple(ws_ub), tuple(sgn))
            if alpha_iters <= 0:
                betas = [torch.zeros_like(s) for s in sgn]
                zlo_c, zhi_c = backward_bounds(net, k, ws_lb, ws_ub, lb, ub,
                                               beta_signs=sgn, betas_low=betas,
                                               betas_up=betas)
                if trace is not None:  # the adaptive slopes are the α init
                    init = [(ws_ub[j] >= -ws_lb[j]).to(lb.dtype) for j in range(k)]
                    trace(k, pre, init, init, betas, betas, None)
            else:
                def width(al, au, bl, bu, k=k):
                    lo_o, hi_o = backward_bounds(net, k, ws_lb, ws_ub, lb, ub, al, au,
                                                 sgn, bl, bu)
                    return (hi_o - lo_o).sum(), (lo_o, hi_o)

                init = [(ws_ub[j] >= -ws_lb[j]).to(lb.dtype) for j in range(k)]
                hook = None if trace is None else (
                    lambda *a, k=k, pre=pre: trace(k, pre, *a))
                zlo_c, zhi_c, _, _ = optimize_relaxation(width, init, alpha_iters,
                                                         with_beta=True, trace=hook)
            zlo = torch.maximum(zlo, zlo_c)
            zhi = torch.minimum(zhi, zhi_c)
        zlo, zhi = widen(zlo, zhi)
        if k < n - 1:
            s = signs[k]
            zlo = torch.where(s > 0, torch.maximum(zlo, zero), zlo)
            zhi = torch.where(s < 0, torch.minimum(zhi, zero), zhi)
            bad = (zlo > zhi).any(dim=-1)
            feas = bad if feas is None else feas | bad
            # An empty interval collapses to a point so deeper layers stay
            # finite; the feasible flag already excludes the branch.
            zhi = torch.maximum(zhi, zlo)
            m = net.masks[k]
            unstable = (zlo < 0.0) & (zhi > 0.0)
            denom = torch.where(unstable, zhi - zlo, torch.ones_like(zlo))
            scores.append(torch.where(unstable, zhi * (-zlo) / denom,
                                      torch.zeros_like(zlo)) * m)
            res = torch.where(zlo >= 0.0, 1, torch.where(zhi <= 0.0, -1, 0))
            resolved.append(res.to(torch.int8) * (m > 0.5))
            sgn = [signs[j].to(lb.dtype) * net.masks[j] for j in range(k + 1)]
        ws_lb.append(zlo)
        ws_ub.append(zhi)
        if k == n - 1:
            break
        m = net.masks[k]
        lo_run, hi_run = torch.relu(zlo) * m, torch.relu(zhi) * m
    out_lo, out_hi = ws_lb[-1][..., 0], ws_ub[-1][..., 0]
    feasible = torch.ones(out_lo.shape, dtype=torch.bool, device=lb.device) \
        if feas is None else ~feas
    return out_lo, out_hi, feasible, scores, resolved


def crown_output_form_sets(net, lb, ub, alpha_iters: int = 0):
    """Output-logit linear forms over the box, for relational certificates.

    Returns ``(form_sets, lo, hi)``: ``form_sets`` a list of one or two
    tuples ``(A_low, c_low, A_up, c_up)`` (``A_*`` (..., d), ``c_*``
    (...,)), each satisfying ``x·A_low + c_low <= f(x) <= x·A_up + c_up``
    over ``[lb, ub]``.  Set 0 is plain CROWN; with ``alpha_iters > 0`` a
    second set carries the α-optimised slopes (final iterate).  ``lo``/
    ``hi`` are the concretized, widened output bounds intersected across
    sets.  The forms are unwidened; a certificate built on them adds its
    own outward slack.
    """
    bounds = crown_bounds(net, lb, ub)
    k = net.depth - 1
    pre_lbs, pre_ubs = bounds.ws_lb[:k], bounds.ws_ub[:k]
    batch = lb.shape[:-1]
    A_l, c_l, A_u, c_u = backward_linear(net, k, pre_lbs, pre_ubs, batch)
    plain = (A_l[..., 0], c_l[..., 0], A_u[..., 0], c_u[..., 0])
    lo0, hi0 = bounds.ws_lb[-1][..., 0], bounds.ws_ub[-1][..., 0]
    if k == 0 or alpha_iters <= 0:
        return [plain], lo0, hi0

    def width(al_, au_):
        lo, hi = backward_bounds(net, k, pre_lbs, pre_ubs, lb, ub, al_, au_)
        return (hi[..., 0] - lo[..., 0]).sum(), (lo[..., 0], hi[..., 0])

    init = [(pre_ubs[j] >= -pre_lbs[j]).to(lb.dtype) for j in range(k)]
    opt_lo, opt_hi, al, au = optimize_relaxation(width, init, alpha_iters)
    A_l, c_l, A_u, c_u = backward_linear(net, k, pre_lbs, pre_ubs, batch, al, au)
    tuned = (A_l[..., 0], c_l[..., 0], A_u[..., 0], c_u[..., 0])
    lo1, hi1 = concretize(A_l, c_l, A_u, c_u, lb, ub)
    opt_lo = torch.maximum(opt_lo, lo1[..., 0])
    opt_hi = torch.minimum(opt_hi, hi1[..., 0])
    opt_lo, opt_hi = widen(opt_lo, opt_hi)
    return [plain, tuned], torch.maximum(opt_lo, lo0), torch.minimum(opt_hi, hi0)


def output_form_stack(net, lb, ub, alpha_iters: int = 0, n_sets: int = 0):
    """:func:`crown_output_form_sets` with the sets stacked on a leading
    axis of length ``n_sets`` (default: as many as computed).  A shorter
    list is padded by REPEATING its last set — every set is independently
    sound, so a duplicate changes neither a min-over-sets bound nor an
    intersect-over-sets keep hull.  Returns ``((A_low, c_low, A_up, c_up),
    lo, hi)`` with ``A_*`` (n_sets, ..., d) and ``c_*`` (n_sets, ...)."""
    sets_, lo, hi = crown_output_form_sets(net, lb, ub, alpha_iters)
    want = int(n_sets) if n_sets else len(sets_)
    if want < len(sets_):
        raise ValueError(f"n_sets={want} < {len(sets_)} computed form sets")
    sets_ = sets_ + [sets_[-1]] * (want - len(sets_))
    return tuple(torch.stack([st[i] for st in sets_]) for i in range(4)), lo, hi
