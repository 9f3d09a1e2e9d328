"""The port's Phase-S kernels' plain versions against the JAX package's, on
the CPU.

* ``sign_constrained_output_bounds`` (K8a's plain version) against JAX's at
  ``alpha_iters`` 0, 2 and 8, on nets with a masked neuron, a dead unit and
  a PA-blind layer, under sign patterns mixing +1/−1/0 and one that empties
  a clamp: ``feasible`` and ``resolved`` are equal; bounds and scores agree
  to the widening slack SOUND_SLACK_REL of their magnitude.
* The α/β optimiser with β: from the same intermediate bounds and split
  signs, every α and β iterate equals JAX's (a step-by-step eager mirror
  of ``_optimize_relaxation``'s loop supplies JAX's β; it is checked
  against the jitted JAX function: the final α equal, the best bounds to
  1e-6 relative).
* Every output bound contains the f64 re-evaluation of the same
  relaxations along the f32 α/β path (``chip_smoke.sign_bound_reference``,
  the card's check), and the card check's mutants fail.
* K8a's live-row launch (``sign_bound(..., live=k)``) on ``_pad``-ded
  inputs equals the full call on every row, for k = 1, a middle value and
  B, at the widths above: the rows past ``live`` take row ``live - 1``'s
  outputs, which the full call gives them because they repeat its inputs.
* ``inter_bounds`` (K8b's plain version) against ``_inter_bounds_kernel``
  within the slack, and its live-row call (``inter_bounds(..., live=n)``)
  on a ``_pad``-ded batch against JAX on that batch for rows < n, the rows
  past ``live`` equal to row n - 1; ``sample_role_logits`` against
  ``_sample_role_logits`` to 1e-6 of the logits' rounding scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fairify_tpu.models import mlp as jmlp
from fairify_tpu.ops import crown as jcrown
from fairify_tpu.verify import engine as jengine
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.ops import crown as tcrown
from fairify_tpu_torch.ops.interval import SOUND_SLACK_ABS, SOUND_SLACK_REL
from fairify_tpu_torch.verify import engine as tengine

SIZES = [(6, 10, 8, 1), (5, 16, 12, 8, 1)]


def _params(sizes, seed):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=0.6, size=(a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(scale=0.2, size=(b,)).astype(np.float32) for b in sizes[1:]]
    ms = [np.ones(b, np.float32) for b in sizes[1:]]
    ms[0][1] = 0.0  # a masked neuron
    ws[0][:, 2] = 0.0  # a dead unit: pre-activation exactly 0 everywhere
    bs[0][2] = 0.0
    ws[1][3, :] = 0.0  # a blind row: layer 1 ignores neuron 3 of layer 0
    ws[0][-1, :] = 0.0  # the PA column feeds nothing
    return ws, bs, ms


def _nets(ws, bs, ms):
    jn = jmlp.MLP(tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
                  tuple(map(jnp.asarray, ms)))
    return jn, tmlp.from_numpy(ws, bs, ms, device="cpu")


def _case(sizes, seed, B=16):
    """Boxes and sign patterns: free, mixed ±1 splits, and box 0 forcing
    active a neuron whose upper bound is negative (an empty clamp)."""
    ws, bs, ms = _params(sizes, seed)
    jn, tn = _nets(ws, bs, ms)
    rng = np.random.default_rng(seed + 100)
    lo = rng.integers(0, 3, size=(B, sizes[0])).astype(np.float32)
    hi = lo + rng.integers(0, 4, size=lo.shape).astype(np.float32)
    signs = [(rng.integers(-1, 2, size=(B, n)) * (rng.random((B, n)) < 0.3))
             .astype(np.float32) for n in sizes[1:-1]]
    signs[0][1] = 0.0  # box 1 is free in layer 0
    ub0 = np.asarray(jcrown.crown_bounds(jn, jnp.asarray(lo), jnp.asarray(hi)).ws_ub[0])
    dead = np.where(ub0[0] < 0)[0]
    assert len(dead)
    signs[0][0, dead[0]] = 1.0
    return jn, tn, lo, hi, signs


def _slack_close(a, b, mag):
    assert (np.abs(np.asarray(a) - np.asarray(b)) <= SOUND_SLACK_REL * mag
            + SOUND_SLACK_ABS).all()


@pytest.mark.parametrize("iters", [0, 2, 8])
@pytest.mark.parametrize("sizes", SIZES)
def test_sign_bounds_match_jax(sizes, iters):
    jn, tn, lo, hi, signs = _case(sizes, 3)
    jo = jcrown.sign_constrained_output_bounds(
        jn, jnp.asarray(lo), jnp.asarray(hi), tuple(map(jnp.asarray, signs)),
        alpha_iters=iters)
    to = tcrown.sign_constrained_output_bounds(
        tn, torch.as_tensor(lo), torch.as_tensor(hi), [torch.as_tensor(s) for s in signs],
        alpha_iters=iters)
    j_lo, j_hi = np.asarray(jo[0]), np.asarray(jo[1])
    mag = np.maximum(np.abs(j_lo), np.abs(j_hi))
    _slack_close(to[0].numpy(), j_lo, mag)
    _slack_close(to[1].numpy(), j_hi, mag)
    feas = to[2].numpy()
    np.testing.assert_array_equal(feas, np.asarray(jo[2]))
    assert not feas[0] and feas.any()  # box 0's clamp is empty
    for a, b in zip(to[4], jo[4]):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert any((a.numpy() == 0).any() and (np.abs(a.numpy()) == 1).any() for a in to[4])
    # Scores: the slack of the neuron's own bound magnitude bounds their error.
    jb = jcrown.crown_bounds(jn, jnp.asarray(lo), jnp.asarray(hi))
    for a, b, l, u in zip(to[3], jo[3], jb.ws_lb, jb.ws_ub):
        scale = np.maximum(np.abs(np.asarray(l)), np.abs(np.asarray(u)))
        _slack_close(a.numpy(), b, 4 * scale)


def _jax_mirror(width, init, iters, lr0=0.5, decay=0.7, lr_b=0.8):
    """``fairify_tpu.ops.crown._optimize_relaxation`` step by step in eager
    JAX: the same value_and_grad, best-bound and clip rules, every iterate
    recorded (the fori_loop form cannot return them)."""
    al, au = list(init), list(init)
    bl = [jnp.zeros_like(a) for a in init]
    bu = [jnp.zeros_like(a) for a in init]
    lr = jnp.asarray(lr0, jnp.float32)
    path, best_lo, best_hi = [], None, None
    vg = jax.value_and_grad(width, argnums=(0, 1, 2, 3), has_aux=True)
    for _ in range(iters):
        path.append((al, au, bl, bu))
        (_, (lo, hi)), (g_al, g_au, g_bl, g_bu) = vg(al, au, bl, bu)
        best_lo = lo if best_lo is None else jnp.maximum(best_lo, lo)
        best_hi = hi if best_hi is None else jnp.minimum(best_hi, hi)
        al = [jnp.clip(a - lr * jnp.sign(g), 0.0, 1.0) for a, g in zip(al, g_al)]
        au = [jnp.clip(a - lr * jnp.sign(g), 0.0, 1.0) for a, g in zip(au, g_au)]
        bl = [jnp.maximum(b - lr_b * jnp.sign(g), 0.0) for b, g in zip(bl, g_bl)]
        bu = [jnp.maximum(b - lr_b * jnp.sign(g), 0.0) for b, g in zip(bu, g_bu)]
        lr = lr * decay
    path.append((al, au, bl, bu))
    _, (lo, hi) = width(al, au, bl, bu)
    return path, jnp.maximum(best_lo, lo), jnp.minimum(best_hi, hi)


@pytest.mark.parametrize("iters", [2, 8])
@pytest.mark.parametrize("sizes", SIZES)
def test_alpha_beta_iterates_match_jax(sizes, iters):
    jn, tn, lo, hi, signs = _case(sizes, 4)
    k = len(sizes) - 2  # the output layer's pass: every hidden layer's α/β
    jb = jcrown.crown_bounds(jn, jnp.asarray(lo), jnp.asarray(hi))
    pl, pu = [], []
    for j in range(k):  # the clamped, collapsed bounds the function uses
        s = signs[j]
        lo_j = np.where(s > 0, np.maximum(np.asarray(jb.ws_lb[j]), 0), jb.ws_lb[j])
        hi_j = np.where(s < 0, np.minimum(np.asarray(jb.ws_ub[j]), 0), jb.ws_ub[j])
        pl.append(lo_j.astype(np.float32))
        pu.append(np.maximum(hi_j, lo_j).astype(np.float32))
    sgn = [signs[j] * np.asarray(jn.masks[j]) for j in range(k)]
    jargs = (list(map(jnp.asarray, pl)), list(map(jnp.asarray, pu)), jnp.asarray(lo),
             jnp.asarray(hi))
    targs = ([torch.as_tensor(a) for a in pl], [torch.as_tensor(a) for a in pu],
             torch.as_tensor(lo), torch.as_tensor(hi))
    jsgn, tsgn = list(map(jnp.asarray, sgn)), [torch.as_tensor(a) for a in sgn]

    def jwidth(al, au, bl, bu):
        a, b = jcrown._backward_bounds(jn, k, *jargs, alphas_low=al, alphas_up=au,
                                       beta_signs=jsgn, betas_low=bl, betas_up=bu)
        return jnp.sum(b - a), (a, b)

    def twidth(al, au, bl, bu):
        a, b = tcrown.backward_bounds(tn, k, *targs, al, au, tsgn, bl, bu)
        return (b - a).sum(), (a, b)

    init = [np.where(pu[j] >= -pl[j], 1.0, 0.0).astype(np.float32) for j in range(k)]
    path_j, best_lo_j, best_hi_j = _jax_mirror(jwidth, list(map(jnp.asarray, init)), iters)
    # The mirror is JAX's optimiser: the same final α, and the same best
    # bounds up to the ulps that jit's fusion moves.
    lo_f, hi_f, al_f, au_f = jcrown._optimize_relaxation(
        jwidth, list(map(jnp.asarray, init)), iters, with_beta=True)
    for a, b in zip(path_j[-1][0] + path_j[-1][1], list(al_f) + list(au_f)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in ((best_lo_j, lo_f), (best_hi_j, hi_f)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    path_t = []
    tcrown.optimize_relaxation(twidth, [torch.as_tensor(a) for a in init], iters,
                               with_beta=True,
                               trace=lambda al, au, bl, bu, g: path_t.append(
                                   (al, au, bl, bu)))
    assert len(path_t) == len(path_j) == iters + 1
    moved = 0
    for it, (pt, pj) in enumerate(zip(path_t, path_j)):
        for gt, gj in zip(pt, pj):
            for a, b in zip(gt, gj):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"iterate {it}")
                moved += int((np.asarray(b) > 0).sum()) if gt is pt[2] else 0
    assert moved  # β left 0 somewhere: the split penalties are exercised


@pytest.mark.parametrize("iters", [0, 2, 8])
def test_sign_bounds_contain_f64_and_card_check_mutants_fail(iters):
    _, tn, lo, hi, signs = _case(SIZES[1], 5)
    lo_t, hi_t = torch.as_tensor(lo), torch.as_tensor(hi)
    pats = [torch.as_tensor(s) for s in signs]
    ref = chip_smoke.sign_bound_reference(tn, lo_t, hi_t, pats, iters)
    (out_lo, out_hi, feas, scores, res), ab = ref[0], ref[1]
    assert ab.shape == (lo.shape[0], tengine.sign_bound_ab_floats(SIZES[1], iters))
    # The port's bounds contain the f64 bounds of the same relaxations.
    assert (out_lo.double() <= ref[3]).all() and (out_hi.double() >= ref[4]).all()
    assert torch.isfinite(ref[3]).all() and torch.isfinite(ref[4]).all()
    # The card's check passes the plain outputs (the CPU wrapper takes the
    # plain version) and rejects each mutant.
    k = tengine.sign_bound(tn, lo_t, hi_t, pats, iters, with_ab=True)
    assert chip_smoke.sign_bound_verdict(k[:5], k[5], ref) is None
    for what, mut in chip_smoke.sign_bound_mutants(k[:5], ref):
        assert chip_smoke.sign_bound_verdict(mut, k[5], ref) is not None, what
    if iters:
        ab_m = k[5].clone()
        ab_m[0, 0] = 1.0 - ab_m[0, 0]
        assert chip_smoke.sign_bound_verdict(k[:5], ab_m, ref) is not None


@pytest.mark.parametrize("iters", [0, 8])
@pytest.mark.parametrize("sizes", SIZES)
def test_live_rows_equal_the_full_call(sizes, iters):
    _, tn, lo, hi, signs = _case(sizes, 5)
    B = lo.shape[0]
    for k in (1, B // 2 + 1, B):
        pad = lambda a: torch.as_tensor(tengine._pad(a[:k], B))
        plo, phi, psg = pad(lo), pad(hi), [pad(s) for s in signs]
        full = tengine.sign_bound(tn, plo, phi, psg, iters, with_ab=True)
        part = tengine.sign_bound(tn, plo, phi, psg, iters, with_ab=True, live=k)
        flat = lambda o: list(o[:3]) + list(o[3]) + list(o[4]) + [o[5]]
        assert len(flat(part)) == len(flat(full))
        for a, b in zip(flat(part), flat(full)):
            assert a.shape == b.shape and torch.equal(a, b)
    for bad in (0, B + 1):
        with pytest.raises(ValueError):
            tengine.sign_bound(tn, torch.as_tensor(lo), torch.as_tensor(hi),
                               [torch.as_tensor(s) for s in signs], iters, live=bad)


@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("sizes", SIZES)
def test_inter_bounds_match_jax(sizes, B):
    ws, bs, ms = _params(sizes, 6)
    jn, tn = _nets(ws, bs, ms)
    rng = np.random.default_rng(B)
    lo = rng.integers(-2, 3, size=(B, sizes[0])).astype(np.float32)
    hi = lo + rng.integers(0, 5, size=lo.shape).astype(np.float32)
    wl_j, wu_j = jengine._inter_bounds_kernel(jn, jnp.asarray(lo), jnp.asarray(hi))
    wl_t, wu_t = tengine.inter_bounds(tn, torch.as_tensor(lo), torch.as_tensor(hi))
    assert len(wl_t) == len(wl_j) == len(sizes) - 1
    for a, b, c, e in zip(wl_t, wl_j, wu_t, wu_j):
        mag = np.maximum(np.abs(np.asarray(b)), np.abs(np.asarray(e)))
        _slack_close(a.numpy(), b, mag)
        _slack_close(c.numpy(), e, mag)


@pytest.mark.parametrize("sizes", SIZES)
def test_inter_bounds_live_rows_match_jax(sizes):
    """K8b's live-row call on a padded batch of 16: rows < n within the
    slack of JAX's ``_inter_bounds_kernel`` on the same padded batch, rows
    >= n equal to row n - 1 (what the card's launch over the live rows
    gives them); ``live`` of 0 and B + 1 raise."""
    ws, bs, ms = _params(sizes, 6)
    jn, tn = _nets(ws, bs, ms)
    rng = np.random.default_rng(9)
    B = 16
    lo = rng.integers(-2, 3, size=(B, sizes[0])).astype(np.float32)
    hi = lo + rng.integers(0, 5, size=lo.shape).astype(np.float32)
    for n in (1, 7, B):
        plo, phi = tengine._pad(lo[:n], B), tengine._pad(hi[:n], B)
        wl_j, wu_j = jengine._inter_bounds_kernel(jn, jnp.asarray(plo), jnp.asarray(phi))
        wl_t, wu_t = tengine.inter_bounds(tn, torch.as_tensor(plo), torch.as_tensor(phi),
                                          live=n)
        assert len(wl_t) == len(wl_j) == len(sizes) - 1
        for a, b, c, e in zip(wl_t, wl_j, wu_t, wu_j):
            a, b, c, e = a.numpy(), np.asarray(b), c.numpy(), np.asarray(e)
            assert a.shape == b.shape == (B, b.shape[1])
            mag = np.maximum(np.abs(b), np.abs(e))[:n]
            _slack_close(a[:n], b[:n], mag)
            _slack_close(c[:n], e[:n], mag)
            assert (a[n:] == a[n - 1]).all() and (c[n:] == c[n - 1]).all()
    for bad in (0, B + 1):
        with pytest.raises(ValueError):
            tengine.inter_bounds(tn, torch.as_tensor(lo), torch.as_tensor(hi), live=bad)


@pytest.mark.parametrize("sizes", SIZES)
def test_sample_role_logits_match_jax(sizes):
    ws, bs, ms = _params(sizes, 7)
    jn, tn = _nets(ws, bs, ms)
    rng = np.random.default_rng(8)
    x = rng.integers(0, 6, size=(4, 32, 2, sizes[0])).astype(np.float32)
    xp = x + rng.integers(-1, 2, size=x.shape).astype(np.float32)
    lx_j, lp_j = jengine._sample_role_logits(jn, jnp.asarray(x), jnp.asarray(xp))
    lx_t, lp_t = tengine.sample_role_logits(tn, torch.as_tensor(x), torch.as_tensor(xp))
    # f32 sums in another order: 1e-6 relative to the logit's rounding
    # scale |h| @ |W| + |b|.
    for a, b, pts in ((lx_t, lx_j, x), (lp_t, lp_j, xp)):
        assert a.shape == b.shape == x.shape[:-1]
        scale = chip_smoke.logit_scale(tn, torch.as_tensor(pts)).numpy()
        assert (np.abs(a.numpy() - np.asarray(b)) <= 1e-6 * scale).all()
