"""The port's refinement-tail pieces against the JAX package's, on the CPU.

* ``prng.uniform`` is bit-equal to ``jax.random.uniform`` on [0, 1) and on
  [-1, 1) (the PGD starts ``s0`` and ``r0``).
* One PGD step from the same starts: the plain version's gradient signs
  equal JAX's wherever |g| exceeds 1e-4 of the trajectory's summed
  gradient magnitude (f32 sums in another order decide only the signs of
  smaller components); the nets carry a masked neuron, a dead unit and a
  PA-blind layer, so exact zeros and tied maxima occur.  Whole PGD runs
  give equal final points and equal exact-validated witness maps.
* α-CROWN output forms (``alpha_iters`` 2 and 8): the α iterates are
  JAX's exactly; the forms and bounds agree to rel 1e-4 of their scale; the
  widened bounds differ by less than the widening slack SOUND_SLACK_REL of
  their magnitude; and each contains the same relaxation's bound
  re-evaluated in float64 along the f32 α path.
* The host deciders ``slab_search``, ``decide_leaf`` and
  ``local_affine_np`` are copies: equal outputs on the same inputs.
* chip_smoke.py's K5 check still bites: JAX's PGD outputs pass
  ``pgd_verdict`` against the plain version, a point shifted by one fails.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairify_tpu.data.domains import DomainSpec as JDomainSpec
from fairify_tpu.models import mlp as jmlp
from fairify_tpu.ops import crown as jcrown
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify.property import FairnessQuery as JQuery
from fairify_tpu.verify.property import encode as jencode
from fairify_tpu_torch.data.domains import DomainSpec
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.ops import crown as tcrown
from fairify_tpu_torch.ops.interval import SOUND_SLACK_REL
from fairify_tpu_torch.utils import prng
from fairify_tpu_torch.verify import engine as tengine
from fairify_tpu_torch.verify.property import FairnessQuery, encode


def _params(sizes, seed, dead_unit=False, pa_blind=False):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=0.6, size=(a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(scale=0.2, size=(b,)).astype(np.float32) for b in sizes[1:]]
    ms = [np.ones(b, np.float32) for b in sizes[1:]]
    ms[0][1] = 0.0  # a masked neuron: its gradient is an exact zero
    if dead_unit:  # a unit whose pre-activation is exactly 0 everywhere
        ws[0][:, 2] = 0.0
        bs[0][2] = 0.0
    if pa_blind:  # the PA column feeds nothing: assignments tie exactly
        ws[0][-1, :] = 0.0
    return ws, bs, ms


def _nets(ws, bs, ms):
    jn = jmlp.MLP(tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
                  tuple(map(jnp.asarray, ms)))
    return jn, tmlp.from_numpy(ws, bs, ms, device="cpu")


def _boxes(seed, B, d):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 4, size=(B, d)).astype(np.float32)
    hi = lo + rng.integers(0, 6, size=(B, d)).astype(np.float32)
    lo[:, -1], hi[:, -1] = 0, 1
    V = 2
    av = np.zeros((V, d), np.float32)
    av[:, -1] = [0, 1]
    pm = np.zeros(d, np.float32)
    pm[-1] = 1.0
    rm = np.zeros(d, np.float32)
    rm[0] = 1.0
    valid = np.ones((B, V), bool)
    valid[1, 0] = False
    return lo, hi, av, pm, rm, valid


# --------------------------------------------------------------------------
# (a) threefry uniform


@pytest.mark.parametrize("seed", [0, 7, 12345, 2**31 - 1])
def test_uniform_bit_equal_to_jax(seed):
    ks, kr = jax.random.split(jax.random.PRNGKey(seed))
    tks, tkr = prng.split(prng.seed_key(seed))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(ks)), tks.numpy().astype(np.uint32))
    shape = (3, 5, 13)
    for (jk, tk), lo, hi in (((ks, tks), 0.0, 1.0), ((kr, tkr), -1.0, 1.0)):
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        got = prng.uniform(tk, shape, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        assert want.min() >= lo and want.max() < hi


# --------------------------------------------------------------------------
# (b) PGD


def _jax_pgd_grad(jn, lo, hi, av, pm, rm, valid, eps, key, restarts):
    """The gradient of the JAX kernel's objective at its starts
    (engine.py:_pgd_attack_kernel, first step)."""
    B, d = lo.shape
    lo_b, hi_b = jnp.asarray(lo)[:, None, :], jnp.asarray(hi)[:, None, :]

    def objective(s, r):
        x = s[..., None, :] * (1.0 - pm) + av
        xp = x + (r * rm)[..., None, :]
        fx, fp = jmlp.forward(jn, x), jmlp.forward(jn, xp)
        fxm = jnp.where(valid[:, None, :], fx, -jnp.inf).max(axis=-1)
        fpm = jnp.where(valid[:, None, :], fp, jnp.inf).min(axis=-1)
        return jnp.minimum(fxm, -fpm)

    k_s, k_r = jax.random.split(key)
    s0 = lo_b + jax.random.uniform(k_s, (B, restarts, d)) * (hi_b - lo_b)
    r0 = jax.random.uniform(k_r, (B, restarts, d), minval=-1.0, maxval=1.0) * eps
    g = jax.jit(jax.grad(lambda s, r: objective(s, r).sum(), argnums=(0, 1)))(s0, r0)
    return [np.asarray(v) for v in g]


@pytest.mark.parametrize("variant", ["plain", "dead_unit", "pa_blind"])
def test_pgd_step_gradient_signs_match_jax(variant):
    ws, bs, ms = _params((5, 12, 8, 1), 3, dead_unit=variant == "dead_unit",
                         pa_blind=variant == "pa_blind")
    jn, tn = _nets(ws, bs, ms)
    lo, hi, av, pm, rm, valid = _boxes(4, 6, 5)
    eps, R = 2.0, 8
    g_j = _jax_pgd_grad(jn, lo, hi, av, pm, rm, valid, eps, jax.random.PRNGKey(9), R)
    seen = []
    tengine.pgd_attack_plain(tn, *(torch.as_tensor(a) for a in (lo, hi, av, pm, rm, valid)),
                             eps, prng.seed_key(9), 1, R,
                             on_step=lambda x, xp, gs, gr: seen.append((gs, gr)))
    g_t = [t.numpy() for t in seen[0]]
    mag = sum(np.abs(g).sum(-1, keepdims=True) for g in g_j)
    for gj, gt in zip(g_j, g_t):
        decided = np.abs(gj) > 1e-4 * mag
        np.testing.assert_array_equal(np.sign(gt)[decided], np.sign(gj)[decided])
        # Structural zeros (PA and non-RA coordinates, masked paths) are
        # exact zeros on both sides.
        np.testing.assert_array_equal(gt == 0, gj == 0)
    assert (g_t[0] == 0).any()  # the PA coordinate: sign(0) leaves it put


@pytest.mark.parametrize("eps,steps", [(0.0, 5), (2.0, 60)])
def test_pgd_runs_match_jax(eps, steps):
    ws, bs, ms = _params((5, 12, 8, 1), 3)
    jn, tn = _nets(ws, bs, ms)
    lo, hi, av, pm, rm, valid = _boxes(3, 8, 5)
    out_j = jengine._pgd_attack_kernel(
        jn, *map(jnp.asarray, (lo, hi, av, pm, rm, valid)), eps,
        jax.random.PRNGKey(123), steps, 16)
    out_t = tengine.pgd_attack_plain(
        tn, *(torch.as_tensor(a) for a in (lo, hi, av, pm, rm, valid)), eps,
        prng.seed_key(123), steps, 16)
    for name, a, b in zip(("fx", "fp", "x", "xp"), out_j, out_t):
        a, b = np.asarray(a), b.numpy()
        if name in ("x", "xp"):
            np.testing.assert_array_equal(b, a)  # the lattice points
        else:  # logits: f32 sums in another order
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("eps,steps", [(0.0, 5), (2.0, 30)])
def test_chip_smoke_pgd_check_rejects_a_shifted_point(eps, steps):
    """chip_smoke.py's K5 check (``pgd_verdict`` over the near-threshold map
    of ``pgd_near``): JAX's ``_pgd_attack_kernel`` outputs (another
    summation order, standing in for the kernel) pass against the port's
    plain version, and the copy with one point of a trajectory that met no
    threshold shifted by one (``pgd_mutant``) fails."""
    import chip_smoke

    ws, bs, ms = _params((5, 12, 8, 1), 3)
    jn, tn = _nets(ws, bs, ms)
    lo, hi, av, pm, rm, valid = _boxes(3, 8, 5)
    R = 16
    k_out = tuple(torch.tensor(np.asarray(a)) for a in jengine._pgd_attack_kernel(
        jn, *map(jnp.asarray, (lo, hi, av, pm, rm, valid)), eps,
        jax.random.PRNGKey(123), steps, R))
    args = tuple(torch.as_tensor(a) for a in (lo, hi, av, pm, rm, valid)) + (eps,)
    p_out, near = chip_smoke.pgd_near(tn, args, prng.seed_key(123), steps, R)
    why, same = chip_smoke.pgd_verdict(tn, k_out, p_out, near, args[5])
    assert why is None and same.any()
    mutant = chip_smoke.pgd_mutant("JAX", k_out, same, near, args[3])
    assert chip_smoke.pgd_verdict(tn, mutant, p_out, near, args[5])[0] is not None


def _toy(span=2):
    names = ("a0", "a1", "a2", "p")
    ranges = {n: (0, span) for n in names}
    ranges["p"] = (0, 1)
    jq = JQuery(domain=JDomainSpec(name="toy", columns=names, ranges=ranges, label="y"),
                protected=("p",))
    tq = FairnessQuery(domain=DomainSpec(name="toy", columns=names, ranges=ranges,
                                         label="y"), protected=("p",))
    return jencode(jq), encode(tq)


@pytest.mark.parametrize("seed", range(4))
def test_pgd_attack_witness_maps_match_jax(seed):
    ws, bs, ms = _params((4, 8, 1), seed)
    ms = [np.ones_like(m) for m in ms]
    jn, tn = _nets(ws, bs, ms)
    jenc, tenc = _toy(span=4)
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 2, size=(5, 4))
    hi = lo + rng.integers(0, 3, size=(5, 4))
    lo[:, 3], hi[:, 3] = 0, 1
    want = jengine.pgd_attack(jn, jenc, lo, hi, np.random.default_rng(seed), steps=30,
                              restarts=16, return_points=True)
    got = tengine.pgd_attack(tn, tenc, lo, hi, np.random.default_rng(seed), steps=30,
                             restarts=16, return_points=True)
    assert {k: tuple(map(tuple, v)) for k, v in got[0].items()} == \
        {k: tuple(map(tuple, v)) for k, v in want[0].items()}
    np.testing.assert_array_equal(got[1], want[1])  # slab seeds
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# (c) α-CROWN


def _alpha_case(sizes, seed, B=12):
    ws, bs, ms = _params(sizes, seed)
    rng = np.random.default_rng(seed + 100)
    lo = rng.integers(0, 3, size=(B, sizes[0])).astype(np.float32)
    hi = lo + rng.integers(0, 4, size=lo.shape).astype(np.float32)
    return ws, bs, ms, lo, hi


@pytest.mark.parametrize("iters", [2, 8])
@pytest.mark.parametrize("sizes", [(6, 10, 8, 1), (5, 16, 16, 8, 1)])
def test_alpha_iterates_and_forms_match_jax(sizes, iters):
    ws, bs, ms, lo, hi = _alpha_case(sizes, iters)
    jn, tn = _nets(ws, bs, ms)
    lo_t, hi_t = torch.as_tensor(lo), torch.as_tensor(hi)
    k = len(sizes) - 2
    # The optimiser itself, from the same plain-CROWN intermediate bounds.
    jb = jcrown.crown_bounds(jn, jnp.asarray(lo), jnp.asarray(hi))
    tb = tcrown.crown_bounds(tn, lo_t, hi_t)
    pl, pu = list(jb.ws_lb[:k]), list(jb.ws_ub[:k])
    tpl = [torch.as_tensor(np.array(v)) for v in pl]
    tpu = [torch.as_tensor(np.array(v)) for v in pu]

    def jwidth(al, au, bl, bu):
        a, b = jcrown._backward_bounds(jn, k, pl, pu, jnp.asarray(lo), jnp.asarray(hi),
                                       alphas_low=al, alphas_up=au)
        return jnp.sum(b[..., 0] - a[..., 0]), (a[..., 0], b[..., 0])

    def twidth(al, au):
        a, b = tcrown.backward_bounds(tn, k, tpl, tpu, lo_t, hi_t, al, au)
        return (b[..., 0] - a[..., 0]).sum(), (a[..., 0], b[..., 0])

    init = [jnp.where(pu[j] >= -pl[j], 1.0, 0.0) for j in range(k)]
    _, _, al_j, au_j = jcrown._optimize_relaxation(jwidth, init, iters, with_beta=False)
    _, _, al_t, au_t = tcrown.optimize_relaxation(
        twidth, [torch.as_tensor(np.array(a)) for a in init], iters)
    for a, b in zip(al_t + au_t, list(al_j) + list(au_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The whole form sets: two sets, forms and bounds to rel 1e-4 of scale.
    sets_j, lb_j, ub_j = jcrown.crown_output_form_sets(jn, jnp.asarray(lo),
                                                       jnp.asarray(hi), iters)
    sets_t, lb_t, ub_t = tcrown.crown_output_form_sets(tn, lo_t, hi_t, iters)
    assert len(sets_t) == len(sets_j) == 2
    for st, sj in zip(sets_t, sets_j):
        for a, b in zip(st, sj):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                       atol=1e-4 * (np.abs(b).max() + 1.0))
    for a, b in ((lb_t, lb_j), (ub_t, ub_j)):
        b = np.asarray(b)
        mag = np.maximum(np.abs(np.asarray(lb_j)), np.abs(np.asarray(ub_j)))
        assert (np.abs(a.numpy() - b) <= SOUND_SLACK_REL * mag).all()
    assert (lb_t <= ub_t).all()
    assert (tb.ws_lb[-1][..., 0] <= lb_t).all() and (ub_t <= tb.ws_ub[-1][..., 0]).all()


@pytest.mark.parametrize("iters", [2, 8])
def test_alpha_bounds_contain_the_f64_bounds(iters):
    sizes = (6, 10, 8, 1)
    ws, bs, ms, lo, hi = _alpha_case(sizes, 11)
    _, tn = _nets(ws, bs, ms)
    lo_t, hi_t = torch.as_tensor(lo), torch.as_tensor(hi)
    k = len(sizes) - 2
    tb = tcrown.crown_bounds(tn, lo_t, hi_t)
    pl, pu = tb.ws_lb[:k], tb.ws_ub[:k]
    path = []

    def twidth(al, au):
        path.append(([a.detach().clone() for a in al], [a.detach().clone() for a in au]))
        a, b = tcrown.backward_bounds(tn, k, pl, pu, lo_t, hi_t, al, au)
        return (b[..., 0] - a[..., 0]).sum(), (a[..., 0], b[..., 0])

    init = [(pu[j] >= -pl[j]).float() for j in range(k)]
    tcrown.optimize_relaxation(twidth, init, iters)
    _, lb_t, ub_t = tcrown.crown_output_form_sets(tn, lo_t, hi_t, iters)
    # The same relaxations (f32 intermediate bounds, the f32 α path)
    # evaluated in float64: the best iterate's bounds.
    net64 = tmlp.from_numpy(ws, bs, ms, device="cpu").double()
    d64 = lambda ts: [t.double() for t in ts]
    best_lo = best_hi = None
    for al, au in path:
        a, b = tcrown.backward_bounds(net64, k, d64(pl), d64(pu), lo_t.double(),
                                      hi_t.double(), d64(al), d64(au))
        best_lo = a[..., 0] if best_lo is None else torch.maximum(best_lo, a[..., 0])
        best_hi = b[..., 0] if best_hi is None else torch.minimum(best_hi, b[..., 0])
    assert len(path) == iters + 1
    assert (lb_t.double() <= best_lo).all() and (ub_t.double() >= best_hi).all()


def test_output_form_stack_pads_by_repetition_like_jax():
    ws, bs, ms, lo, hi = _alpha_case((4, 6, 1), 0, B=1)
    jn, tn = _nets(ws, bs, ms)
    lb, ub = lo[0], hi[0]
    stk_j, _, _ = jcrown.output_form_stack(jn, jnp.asarray(lb), jnp.asarray(ub), 0, 3)
    stk_t, _, _ = tcrown.output_form_stack(tn, torch.as_tensor(lb), torch.as_tensor(ub),
                                           0, 3)
    for a, b in zip(stk_t, stk_j):
        assert a.shape[0] == 3
        for i in range(3):
            np.testing.assert_array_equal(a[i].numpy(), a[0].numpy())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tcrown.output_form_stack(tn, torch.as_tensor(lb), torch.as_tensor(ub), 4, 1)


# --------------------------------------------------------------------------
# Host deciders (copies)


@pytest.mark.parametrize("seed", range(3))
def test_host_deciders_match_jax(seed):
    ws, bs, _ = _params((4, 8, 1), seed)
    jenc, tenc = _toy(span=6)
    rng = np.random.default_rng(seed)
    lo = np.array([0, 0, 0, 0])
    hi = np.array([6, 6, 6, 1])
    for _ in range(5):
        x = rng.integers(lo, hi + 1)
        f_j, g_j = jmlp.local_affine_np(ws, bs, x)
        f_t, g_t = tmlp.local_affine_np(ws, bs, x)
        assert f_t == f_j
        np.testing.assert_array_equal(g_t, g_j)
        leaf = np.array(x)
        assert str(tengine.decide_leaf(tenc, ws, bs, leaf.copy(), leaf, leaf)) == \
            str(jengine.decide_leaf(jenc, ws, bs, leaf.copy(), leaf, leaf))
        seed_pt = rng.integers(lo, hi + 1).astype(np.float64)
        got = tengine.slab_search(ws, bs, tenc, lo, hi, seed_pt)
        want = jengine.slab_search(ws, bs, jenc, lo, hi, seed_pt)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(np.stack(got), np.stack(want))
