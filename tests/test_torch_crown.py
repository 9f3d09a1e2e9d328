"""The port's plain-CROWN bounds and output forms against the JAX package's.

``crown_output_form_sets`` (alpha_iters=0) feeds the tied pair certificate;
forms and bounds must agree to rel 1e-4 (f32 summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairify_tpu.models import mlp as jmlp
from fairify_tpu.ops import crown as jcrown
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.ops import crown as tcrown


def _case(sizes, seed, B=6, V=3):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=np.sqrt(2.0 / a), size=(a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(scale=0.1, size=(b,)).astype(np.float32) for b in sizes[1:]]
    lo = rng.integers(-5, 5, size=(B, V, sizes[0])).astype(np.float32)
    hi = lo + rng.integers(0, 6, size=lo.shape).astype(np.float32)
    return ws, bs, lo, hi


def _close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("sizes", [(20, 50, 1), (13, 16, 12, 8, 1), (6, 1)])
def test_output_form_sets_match_jax(sizes):
    ws, bs, lo, hi = _case(sizes, seed=len(sizes))
    sets_j, lb_j, ub_j = jax.jit(jcrown.crown_output_form_sets, static_argnums=3)(
        jmlp.from_numpy(ws, bs), jnp.asarray(lo), jnp.asarray(hi), 0)
    sets_t, lb_t, ub_t = tcrown.crown_output_form_sets(
        tmlp.from_numpy(ws, bs, device="cpu"), torch.as_tensor(lo),
        torch.as_tensor(hi), 0)
    assert len(sets_t) == len(sets_j) == 1
    for a, b in zip(sets_t[0], sets_j[0]):
        _close(a.numpy(), b)
    _close(lb_t.numpy(), lb_j)
    _close(ub_t.numpy(), ub_j)
    assert (lb_t <= ub_t).all()


def test_crown_bounds_match_jax_and_contain_samples():
    sizes = (10, 12, 12, 1)
    ws, bs, lo, hi = _case(sizes, seed=9, B=4, V=1)
    jb = jax.jit(jcrown.crown_bounds)(jmlp.from_numpy(ws, bs), jnp.asarray(lo),
                                      jnp.asarray(hi))
    tnet = tmlp.from_numpy(ws, bs, device="cpu")
    tb = tcrown.crown_bounds(tnet, torch.as_tensor(lo), torch.as_tensor(hi))
    for a, b in zip(tb.ws_lb + tb.ws_ub, jb.ws_lb + jb.ws_ub):
        _close(a.numpy(), b)
    # Soundness spot check: sampled logits lie inside the output bounds.
    rng = np.random.default_rng(1)
    x = lo + rng.random((64,) + lo.shape).astype(np.float32) * (hi - lo)
    y = tnet(torch.as_tensor(x)).numpy()
    assert (y >= tb.ws_lb[-1][..., 0].numpy() - 1e-5).all()
    assert (y <= tb.ws_ub[-1][..., 0].numpy() + 1e-5).all()


def test_alpha_crown_is_rejected_not_ignored():
    # α-CROWN runs (tests/test_torch_refine.py holds it against JAX), and so
    # do the β multipliers of Phase S (tests/test_torch_sign_bound.py): with
    # β the optimiser hands the width four parameter groups, β from 0.
    ws, bs, lo, hi = _case((4, 3, 1), seed=0)
    net = tmlp.from_numpy(ws, bs, device="cpu")
    sets, lb, ub = tcrown.crown_output_form_sets(net, torch.as_tensor(lo),
                                                 torch.as_tensor(hi), 8)
    assert len(sets) == 2 and (lb <= ub).all()
    seen = []

    def width(al, au, bl, bu):
        seen.append([float(t.detach().sum()) for t in bl + bu])
        v = bu[0].sum() - bl[0].sum() + 0.0 * (al[0].sum() + au[0].sum())
        return v, (v.detach(), v.detach())

    # ∂width/∂β_low = -1 steps β_low up by 0.8; β_up stays clipped at 0.
    tcrown.optimize_relaxation(width, [torch.ones(2)], 1, with_beta=True)
    assert seen == [[0.0, 0.0], [pytest.approx(1.6), 0.0]]
