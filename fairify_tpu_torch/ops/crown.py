"""Batched CROWN backward linear-relaxation bounds, plain CROWN only.

Port of the ``alpha_iters=0`` part of ``fairify_tpu/ops/crown.py``: the
ReLU triangle relaxation (:func:`relu_relaxation`), the backward pass that
expresses a layer's pre-activations as linear forms of the input
(:func:`backward_linear`), their concretization over the input box, the
full-network CROWN bounds intersected with IBP (:func:`crown_bounds`), and
the output-logit linear forms the tied pair certificate consumes
(:func:`crown_output_form_sets`).  α/β optimisation is not ported yet
(ROADMAP queue 1, item 5).

Every function takes arbitrary leading batch axes on the box tensors.
"""
from __future__ import annotations

import torch

from fairify_tpu_torch.ops.interval import LayerBounds, affine_interval, widen

ALPHA_NOT_PORTED = ("alpha_iters > 0 (α-CROWN) is not ported yet: ROADMAP "
                    "queue 1, item 5 (the refinement tail, α/β of ops/crown.py)")


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


def backward_linear(net, k: int, pre_lbs, pre_ubs, batch):
    """Linear forms of layer-k pre-activations in terms of the input.

    Returns ``(A_low, c_low, A_up, c_up)`` with ``A_*`` of shape
    ``batch + (d, n_k)`` and ``c_*`` of shape ``batch + (n_k,)`` such that
    ``x @ A_low + c_low <= z_k <= x @ A_up + c_up`` over the box the
    ``pre_*`` bounds were computed for.
    """
    w_k = net.weights[k]
    n_k = w_k.shape[1]
    A_low = w_k.expand(*batch, *w_k.shape)
    A_up = A_low
    c_low = net.biases[k].expand(*batch, n_k)
    c_up = c_low
    for j in range(k - 1, -1, -1):
        us, ui, ls = relu_relaxation(pre_lbs[j], pre_ubs[j], net.masks[j])
        # Through h_j = relu(z_j): pick the relaxation per coefficient sign.
        Ap = torch.clamp(A_low, min=0.0)
        An = torch.clamp(A_low, max=0.0)
        c_low = c_low + (ui.unsqueeze(-2) @ An).squeeze(-2)
        A_low = Ap * ls.unsqueeze(-1) + An * us.unsqueeze(-1)
        Ap = torch.clamp(A_up, min=0.0)
        An = torch.clamp(A_up, max=0.0)
        c_up = c_up + (ui.unsqueeze(-2) @ Ap).squeeze(-2)
        A_up = Ap * us.unsqueeze(-1) + An * ls.unsqueeze(-1)
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
    lo = (lb @ torch.clamp(A_low, min=0.0)).squeeze(-2) \
        + (ub @ torch.clamp(A_low, max=0.0)).squeeze(-2) + c_low
    hi = (ub @ torch.clamp(A_up, min=0.0)).squeeze(-2) \
        + (lb @ torch.clamp(A_up, max=0.0)).squeeze(-2) + c_up
    return lo, hi


def crown_bounds(net, lb, ub) -> LayerBounds:
    """Full-network CROWN pre-activation bounds, intersected with IBP and
    widened outward (layer 0 is the exact affine interval)."""
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


def crown_output_form_sets(net, lb, ub, alpha_iters: int = 0):
    """Output-logit linear forms over the box, for relational certificates.

    Returns ``([(A_low, c_low, A_up, c_up)], lo, hi)`` with ``A_*`` of shape
    (..., d) and ``c_*`` of shape (...,): the plain-CROWN form set, and the
    concretized, widened output bounds.  The forms are unwidened; a
    certificate built on them adds its own outward slack.
    """
    if alpha_iters > 0:
        raise NotImplementedError(ALPHA_NOT_PORTED)
    bounds = crown_bounds(net, lb, ub)
    k = net.depth - 1
    A_l, c_l, A_u, c_u = backward_linear(net, k, bounds.ws_lb[:k],
                                         bounds.ws_ub[:k], lb.shape[:-1])
    plain = (A_l[..., 0], c_l[..., 0], A_u[..., 0], c_u[..., 0])
    return [plain], bounds.ws_lb[-1][..., 0], bounds.ws_ub[-1][..., 0]
