"""The port's ``ops/lp.py`` (a copy) against the JAX package's, on the
cases of tests/test_lp.py: given the same pre-activation bounds, the sign
LP BaB's outcome and node count, the pair LP BaB's status, node count and
witness, the tableau's infeasible-region status, and the domain clip are
equal."""
import jax.numpy as jnp
import numpy as np
import pytest

from fairify_tpu.data.domains import DomainSpec as JDomainSpec
from fairify_tpu.models import mlp as jmlp
from fairify_tpu.ops import crown as jcrown
from fairify_tpu.ops import lp as jlp
from fairify_tpu.verify import property as jprop
from fairify_tpu_torch.data.domains import DomainSpec
from fairify_tpu_torch.ops import lp as tlp
from fairify_tpu_torch.verify import property as tprop


def _net(ws, bs):
    ws = [np.asarray(w, np.float32) for w in ws]
    bs = [np.asarray(b, np.float32) for b in bs]
    return ws, bs, [np.ones(len(b), np.float32) for b in bs]


def _pre(ws, bs, lo, hi):
    b = jcrown.crown_bounds(jmlp.from_numpy(ws, bs), jnp.asarray(lo, jnp.float32)[None],
                            jnp.asarray(hi, jnp.float32)[None])
    return ([np.asarray(x)[0] for x in b.ws_lb[:-1]],
            [np.asarray(x)[0] for x in b.ws_ub[:-1]])


def _random(seed):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(size=(2, 6)) * 0.7, rng.normal(size=(6, 4)) * 0.7,
          rng.normal(size=(4, 1))]
    bs = [rng.normal(size=(6,)) * 0.3, rng.normal(size=(4,)) * 0.3,
          [float(rng.normal()) + 1.0]]
    return _net(ws, bs), np.array([-3.0, -3.0]), np.array([3.0, 3.0])


CASES = {
    "certified_at_root": (_net([[[1.0, -1.0]], [[1.0], [1.0]]], [[0, 0], [0.5]]),
                          np.array([-4.0]), np.array([4.0]), True, {}),
    "certified_after_splits": (_net([[[1.0, -1.0, 1.0]], [[-1.0], [1.0], [1.0]]],
                                    [[0, 0, 8], [-7.0]]),
                               np.array([-4.0]), np.array([4.0]), True, {}),
    "refuted": (_net([[[1.0]], [[1.0]]], [[0], [-2.0]]), np.array([0.0]),
                np.array([6.0]), True, {}),
    "budget": (_net([np.random.default_rng(0).normal(size=(2, 8)),
                     np.random.default_rng(1).normal(size=(8, 1))], [np.zeros(8), [0.0]]),
               np.array([-8.0, -8.0]), np.array([8.0, 8.0]), True, {"max_nodes": 1}),
    "negative_sign": (_net([[[1.0]], [[-1.0]]], [[0], [-1.0]]), np.array([0.0]),
                      np.array([6.0]), False, {}),
}
CASES.update({f"random_{s}": _random(s) + (True, {}) for s in range(4)})


@pytest.mark.parametrize("case", sorted(CASES))
def test_sign_bab_lp_matches_jax(case):
    (ws, bs, ms), lo, hi, want_pos, kw = CASES[case]
    pl, pu = _pre(ws, bs, lo, hi)
    got = tlp.sign_bab_lp(ws, bs, ms, lo, hi, pl, pu, want_pos, **kw)
    want = jlp.sign_bab_lp(ws, bs, ms, lo, hi, pl, pu, want_pos, **kw)
    assert got == want
    expected = {"certified_at_root": ("certified", 1), "refuted": ("refuted", None),
                "budget": ("budget", 1), "negative_sign": ("certified", None)}
    if case in expected:
        assert got[0] == expected[case][0]
        assert expected[case][1] in (None, got[1])
    if case == "certified_after_splits":
        assert got[0] == "certified" and got[1] > 1


def test_forced_inactive_region_is_infeasible_like_jax():
    ws, bs, ms = _net([[[1.0]], [[1.0]]], [[10.0], [0.5]])
    pl, pu = _pre(ws, bs, [0.0], [4.0])
    forced = [np.array([-1], dtype=np.int8)]
    for mod in (tlp, jlp):
        t = mod.TriangleLP(ws, bs, ms, np.array([0.0]), np.array([4.0]), pl, pu)
        assert t.solve_min(forced)[0] == "infeasible"


def _ra_world():
    ranges = {"a": (0, 1), "pa": (0, 1), "ra": (0, 4)}
    cols = tuple(ranges)
    jq = jprop.FairnessQuery(domain=JDomainSpec(name="toy", columns=cols, ranges=ranges,
                                                label="y"),
                             protected=("pa",), relaxed=("ra",), relax_eps=1)
    tq = tprop.FairnessQuery(domain=DomainSpec(name="toy", columns=cols, ranges=ranges,
                                               label="y"),
                             protected=("pa",), relaxed=("ra",), relax_eps=1)
    return jprop.encode(jq), tprop.encode(tq)


@pytest.mark.parametrize("flip", [False, True])
def test_pair_bab_lp_ra_shift_directions_match_jax(flip):
    # f = ra − 4.5 over ra in [0, 4], ε = 1: only the flipped direction has
    # a witness, in the out-of-box ε band of tower b.
    ws, bs, ms = _net([[[0.0], [0.0], [1.0]], [[1.0]]], [[0.0], [-4.5]])
    jenc, tenc = _ra_world()
    lo, hi = np.array([0, 0, 0], np.int64), np.array([1, 1, 4], np.int64)
    x_lo, x_hi, xp_lo, xp_hi, _ = jprop.role_boxes(jenc, lo[None].astype(np.float32),
                                                   hi[None].astype(np.float32))
    ba = _pre(ws, bs, x_lo[0, 0], x_hi[0, 0])
    bb = _pre(ws, bs, xp_lo[0, 1], xp_hi[0, 1])
    args = (lo, hi, jenc.assignments[0], jenc.assignments[1], ba, bb)
    got = tlp.pair_bab_lp(ws, bs, ms, tenc, *args, flip=flip)
    want = jlp.pair_bab_lp(ws, bs, ms, jenc, *args, flip=flip)
    assert got[:2] == want[:2]
    assert got[0] == ("sat" if flip else "killed")
    if flip:
        np.testing.assert_array_equal(np.stack(got[2]), np.stack(want[2]))
        assert got[2][1][2] == 5
    else:
        assert got[2] is None and want[2] is None


@pytest.mark.parametrize("seed", range(3))
def test_clip_box_with_form_matches_jax(seed):
    rng = np.random.default_rng(seed)
    D = rng.normal(size=5)
    c = float(rng.normal())
    lo = rng.integers(-5, 0, size=5)
    hi = lo + rng.integers(0, 9, size=5)
    got, want = tlp.clip_box_with_form(D, c, lo, hi), jlp.clip_box_with_form(D, c, lo, hi)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
