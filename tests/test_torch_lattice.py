"""The port's Phases E0 and E (``fairify_tpu_torch/ops/lattice.py``) against
the JAX package's (``fairify_tpu/ops/lattice.py``), on the CPU.

* ``signed_forward`` against ``_signed_forward``: the logit within 1e-6 of
  its f64 scale (the forward of ``|x|`` through ``|W|`` and ``|b|``: the
  two sum in other orders), the bound within 1e-5 relative, and both
  bounds contain the f64 logit.
* The plain versions of K9a/b/c against ``_lattice_scan_kernel``,
  ``_lattice_signs_kernel`` and ``_lattice_scan_kernel_ra`` on
  tests/test_lattice.py's toy and RA worlds (1-, 2- and 3-RA, ε 1-2), with
  chunk tails, a later ``start`` and the zero net (a full margin buffer):
  every output equal, or, where a point sits at the bound's edge, (a) no
  opposite certain signs, (b) both f within e of the f64 logit, (c) a
  certain-vs-0 difference only within the two versions' f and e
  differences of the bound.
* ``decide_box_exhaustive`` on every case of tests/test_lattice.py:
  verdicts and witnesses equal JAX's and the brute-force oracle's.
* ``enumerable_size`` on the first 512 partitions of stress-AC,
  relaxed-AC and relaxed3-BM; Phase E's gates through ``lattice_phase``.
* ``decide_many`` in the default configuration (Phase E0 decides) and
  with ``lattice_first_max=0, max_nodes=1`` (Phase E decides after the
  BaB and Phase P): verdict, reason, node count and witness equal JAX's,
  and ``Decision.phase`` names the lattice phase.
* ``verify_model`` on the German world of test_torch_sign_bab.py in the
  default configuration: ledger and CSV rows equal JAX's.
* A heuristic-masked net: the device pass applies the masks, the exact
  host ladder does not (the JAX package's semantics); the port's verdict
  equals JAX's.
"""
import itertools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairify_tpu.data.domains import DomainSpec as JDomainSpec
from fairify_tpu.models import mlp as jmlp
from fairify_tpu.ops import lattice as jlat
from fairify_tpu.ops import masks as jmasks
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import property as jprop
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.data.domains import DomainSpec
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.ops import lattice as tlat
from fairify_tpu_torch.ops import masks as tmasks
from fairify_tpu_torch.verify import engine as tengine
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import property as tprop
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig

from test_torch_bab import _assert_same_rows, _ce, _params, _toy
from test_torch_sign_bab import _world

# f agrees to this share of its f64 scale, e to this relative tolerance
# (the two packages sum the same products in other orders).
F_REL, E_REL = 1e-6, 1e-5


def _encs(ranges, protected=("p",), relaxed=(), eps=0):
    cols = tuple(ranges)
    kw = dict(relaxed=relaxed, relax_eps=eps) if relaxed else {}
    jd = JDomainSpec(name="toy", columns=cols, ranges=dict(ranges), label="y")
    td = DomainSpec(name="toy", columns=cols, ranges=dict(ranges), label="y")
    return (jprop.encode(jprop.FairnessQuery(domain=jd, protected=protected, **kw)),
            tprop.encode(tprop.FairnessQuery(domain=td, protected=protected, **kw)))


def _nets(ws, bs, ms=None):
    jn = jmlp.from_numpy(ws, bs)
    if ms is not None:
        jn = jmlp.MLP(jn.weights, jn.biases, tuple(jnp.asarray(m) for m in ms))
    return jn, tmlp.from_numpy(ws, bs, ms, device="cpu")


def _net(seed, sizes):
    """tests/test_lattice.py's ``_net``: normal(0.6) weights, normal(0.2) biases."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=0.6, size=(sizes[i], sizes[i + 1])).astype(np.float32)
          for i in range(len(sizes) - 1)]
    bs = [rng.normal(scale=0.2, size=(sizes[i + 1],)).astype(np.float32)
          for i in range(len(sizes) - 1)]
    return ws, bs


def _toy_ranges(span=2):
    r = {f"a{i}": (0, span) for i in range(3)}
    r["p"] = (0, 1)
    return r


RA1 = {"ra": (0, 4), "a1": (0, 2), "a2": (0, 2), "p": (0, 1)}
RA2 = {"r1": (0, 3), "r2": (0, 3), "a1": (0, 2), "p": (0, 1)}
RA3 = {"a0": (0, 2), "a1": (0, 2), "a2": (0, 2), "p": (0, 1)}


# --------------------------------------------------------------------------
# signed_forward


@pytest.mark.parametrize("seed", range(4))
def test_signed_forward_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    sizes = (5, 16, 8, 1)
    ws, bs = _net(200 + seed, sizes)
    ms = [np.ones(n, np.float32) for n in sizes[1:]]
    ms[0][3] = 0.0
    jn, tn = _nets(ws, bs, ms)
    pts = rng.integers(-50, 1000, size=(64, sizes[0])).astype(np.float32)
    jf, je = (np.asarray(v) for v in jlat._signed_forward(jn, jnp.asarray(pts)))
    tf, te = (v.numpy() for v in tlat.signed_forward(tn, torch.as_tensor(pts)))
    # The scale of f's rounding: the forward of |x| through |W|, |b| and
    # the masks (the magnitude every partial sum is bounded by).
    h, scale = pts.astype(np.float64), np.abs(pts.astype(np.float64))
    for i, (w, b, m) in enumerate(zip(ws, bs, ms)):
        scale = scale @ np.abs(w.astype(np.float64)) + np.abs(b)
        h = h @ w.astype(np.float64) + b
        if i < len(ws) - 1:
            h = np.maximum(h, 0.0) * m
            scale = scale * m
    f64, scale = h[:, 0], scale[:, 0]
    assert (np.abs(tf - jf) <= F_REL * scale).all()
    np.testing.assert_allclose(te, je, rtol=E_REL)
    assert (np.abs(tf - f64) <= te).all() and (np.abs(jf - f64) <= je).all()


# --------------------------------------------------------------------------
# The three kernels' plain versions against the obs_jit kernels


def _chunk_args(tn, tenc, lo, hi, chunk):
    plan = tlat.scan_plan(tn, tenc, lo, hi, chunk=chunk)
    assert not isinstance(plan, str) and not len(plan.peel_dims)
    valid = np.zeros(tenc.n_assign, bool)
    valid[plan.valid] = True
    strides, widths, lo_sh = plan.host_desc()
    return plan, dict(strides=strides, widths=widths, lo_shared=lo_sh,
                      bases=plan.bases(tenc, ()), valid=valid,
                      vp=plan.vp.astype(np.float32), d=len(lo))


def _edge_ok(jn, tn, a, c0, plan):
    """Checks (a)-(c) where the two packages' signs differ."""
    x = tlat.lattice_inputs(c0, a["strides"], a["widths"], a["lo_shared"],
                            torch.as_tensor(a["bases"]), plan.chunk, plan.dims_tuple, a["d"])
    tf, te = (v.numpy() for v in tlat.signed_forward(tn, x))
    jf, je = (np.asarray(v) for v in jax_forward(jn, x.numpy()))
    f64 = tengine.forward_np(*tn.numpy_params(), x.numpy().astype(np.float64))
    ts = np.where(tf > te, 1, np.where(tf < -te, -1, 0))
    js = np.where(jf > je, 1, np.where(jf < -je, -1, 0))
    assert not ((ts * js) == -1).any()                                  # (a)
    assert (np.abs(tf - f64) <= te).all() and (np.abs(jf - f64) <= je).all()  # (b)
    diff = ts != js
    assert (np.abs(np.abs(jf) - je) <= np.abs(tf - jf) + np.abs(te - je))[diff].all()  # (c)


def jax_forward(jn, x):
    flat = jnp.asarray(x.reshape(-1, x.shape[-1]))
    f, e = jlat._signed_forward(jn, flat)
    return np.asarray(f).reshape(x.shape[:-1]), np.asarray(e).reshape(x.shape[:-1])


def _compare_scan(jn, tn, jenc, tenc, lo, hi, chunk, c0):
    plan, a = _chunk_args(tn, tenc, lo, hi, chunk)
    common = (jnp.int32(c0), jnp.int32(plan.n_suf), jnp.asarray(a["strides"]),
              jnp.asarray(a["widths"]), jnp.asarray(a["lo_shared"]), jnp.asarray(a["bases"]),
              jnp.asarray(a["valid"]), jnp.asarray(a["vp"]))
    targs = (tn, c0, plan.n_suf, a["strides"], a["widths"], a["lo_shared"],
             torch.as_tensor(a["bases"]), torch.as_tensor(a["valid"]),
             torch.as_tensor(a["vp"]), plan.chunk, plan.dims_tuple, a["d"])
    if plan.ra_mode:
        want = jlat._lattice_scan_kernel_ra(jn, *common, plan.chunk, plan.dims_tuple, a["d"],
                                            plan.ra_ws, plan.eps)
        got = tlat.lattice_scan_ra(*targs, plan.ra_ws, plan.eps)
    else:
        want = jlat._lattice_scan_kernel(jn, *common, plan.chunk, plan.dims_tuple, a["d"])
        got = tlat.lattice_scan(*targs)
    jsig = np.asarray(jlat._lattice_signs_kernel(
        jn, jnp.int32(c0), common[2], common[3], common[4], common[5], plan.chunk,
        plan.dims_tuple, a["d"]))
    tsig = tlat.lattice_signs(tn, c0, a["strides"], a["widths"], a["lo_shared"],
                              torch.as_tensor(a["bases"]), plan.chunk, plan.dims_tuple,
                              a["d"]).numpy()
    same = (tsig == jsig).all() and all(
        np.array_equal(np.asarray(w), g.numpy()) for w, g in zip(want, got))
    if not same:
        _edge_ok(jn, tn, a, c0, plan)
    return plan, [np.asarray(w) for w in want], same


SCAN_WORLDS = {
    # name: (ranges, relaxed, eps, net seed, lo, hi, chunk, starts)
    "toy": (_toy_ranges(6), (), 0, 1, [0, 0, 0, 0], [6, 6, 6, 1], 64, (0, 128, 320)),
    "toy_odd_chunk": (_toy_ranges(6), (), 0, 4, [0, 0, 0, 0], [6, 6, 6, 1], 50, (0, 300)),
    "ra1_eps1": (RA1, ("ra",), 1, 2, [0, 0, 0, 0], [4, 2, 2, 1], 14, (0, 56)),
    "ra1_eps2": (RA1, ("ra",), 2, 3, [0, 0, 0, 0], [4, 2, 2, 1], 18, (0, 36, 72)),
    "ra2_eps1": (RA2, ("r1", "r2"), 1, 0, [0, 0, 0, 0], [3, 3, 2, 1], 72, (0, 72)),
    "ra2_eps2": (RA2, ("r1", "r2"), 2, 5, [0, 0, 0, 0], [3, 3, 2, 1], 128, (0, 128)),
    "ra3_eps2": (RA3, ("a0", "a1", "a2"), 2, 7, [0, 0, 0, 0], [2, 2, 2, 1], 343, (0,)),
}


@pytest.mark.parametrize("world", sorted(SCAN_WORLDS))
def test_plain_kernels_match_jax(world):
    ranges, relaxed, eps, seed, lo, hi, chunk, starts = SCAN_WORLDS[world]
    jenc, tenc = _encs(ranges, relaxed=relaxed, eps=eps)
    jn, tn = _nets(*_net(seed, (4, 8, 1)))
    lo, hi = np.array(lo, np.int64), np.array(hi, np.int64)
    tails = 0
    for c0 in starts:
        plan, want, _ = _compare_scan(jn, tn, jenc, tenc, lo, hi, chunk, c0)
        tails += plan.n_suf - c0 < plan.chunk
    assert tails >= 1 or world.startswith("ra3")  # a chunk past the lattice's end


def test_zero_net_fills_the_margin_buffer():
    jenc, tenc = _encs(_toy_ranges(12))
    ws = [np.zeros((4, 4), np.float32), np.zeros((4, 1), np.float32)]
    bs = [np.zeros(4, np.float32), np.zeros(1, np.float32)]
    jn, tn = _nets(ws, bs)
    lo, hi = np.zeros(4, np.int64), np.array([12, 12, 12, 1], np.int64)
    plan, want, same = _compare_scan(jn, tn, jenc, tenc, lo, hi, 1024, 0)
    assert same and int(want[1]) == 1024 and (want[2] == np.arange(512)).all()
    # The last chunk holds 2197 - 2048 = 149 margin points: the buffer is
    # -1-filled past them and the sign columns read index 0 there.
    plan, want, same = _compare_scan(jn, tn, jenc, tenc, lo, hi, 1024, 2048)
    assert same and int(want[1]) == 149 and (want[2][149:] == -1).all()


@pytest.mark.parametrize("world", sorted(SCAN_WORLDS))
def test_reductions_of_signs_match_jax(world):
    """``scan_from_signs`` / ``scan_ra_from_signs`` (the reductions that
    chip_smoke.py holds the kernels' outputs against, given K9b's signs)
    on JAX's sign tensor: every output equal to JAX's scan."""
    ranges, relaxed, eps, seed, lo, hi, chunk, starts = SCAN_WORLDS[world]
    jenc, tenc = _encs(ranges, relaxed=relaxed, eps=eps)
    jn, tn = _nets(*_net(seed, (4, 8, 1)))
    lo, hi = np.array(lo, np.int64), np.array(hi, np.int64)
    for c0 in starts:
        plan, a = _chunk_args(tn, tenc, lo, hi, chunk)
        common = (jnp.int32(c0), jnp.int32(plan.n_suf), jnp.asarray(a["strides"]),
                  jnp.asarray(a["widths"]), jnp.asarray(a["lo_shared"]),
                  jnp.asarray(a["bases"]), jnp.asarray(a["valid"]), jnp.asarray(a["vp"]))
        jsig = jlat._lattice_signs_kernel(jn, common[0], *common[2:6], plan.chunk,
                                          plan.dims_tuple, a["d"])
        s = torch.as_tensor(np.array(jsig))
        valid, vp = torch.as_tensor(a["valid"]), torch.as_tensor(a["vp"])
        if plan.ra_mode:
            want = jlat._lattice_scan_kernel_ra(jn, *common, plan.chunk, plan.dims_tuple,
                                                a["d"], plan.ra_ws, plan.eps)
            got = tlat.scan_ra_from_signs(s, c0, plan.n_suf, valid, vp, plan.ra_ws, plan.eps)
        else:
            want = jlat._lattice_scan_kernel(jn, *common, plan.chunk, plan.dims_tuple, a["d"])
            got = tlat.scan_from_signs(s, c0, plan.n_suf, valid, vp)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("world", ["toy", "ra1_eps2"])
def test_chip_smoke_lattice_check_rejects_mutants(world):
    """chip_smoke.py's K9 check on a chunk with a flip and margin points
    (the crossing twin's construction, here on the plain path: a net whose
    output bias sits between a certain pair): the outputs pass, and copies
    with a sign flipped, a margin index dropped, two swapped or the flip
    lost fail."""
    import chip_smoke

    ranges, relaxed, eps, seed, lo, hi, chunk, _ = SCAN_WORLDS[world]
    _, tenc = _encs(ranges, relaxed=relaxed, eps=eps)
    ws, bs = _net(seed, (4, 8, 1))
    ws[0][2] = 0.0  # copies along a2 tie, so a margin point comes with its copies
    tn = tmlp.from_numpy(ws, bs, device="cpu")
    lo, hi = np.array(lo, np.int64), np.array(hi, np.int64)
    plan, args = chip_smoke.scan_args(tn, tenc, lo, hi, 0, chunk)
    _, _, n_suf, strides, widths, lo_sh, bases, _, _, _, dims, d = args
    _, f, e = tlat.device_signs_plain(tn, 0, strides, widths, lo_sh, bases, plan.chunk, dims,
                                      d, with_fe=True)
    n_here = min(plan.chunk, n_suf)
    shifts = chip_smoke.flip_shifts(plan, f, e, n_here)
    # Each shift at a certain pair's midpoint, then at an existing logit
    # (a margin point and its copies).
    level = sorted(float(v) for v in f[torch.as_tensor(plan.valid)][:, :n_here].flatten())
    found = None
    for shift in shifts + level:
        xn = chip_smoke.crossing_twin(tn, tenc, 1.0, shift, "cpu")
        xargs = (xn,) + args[1:]
        k_scan = (tlat.lattice_scan_ra(*xargs, plan.ra_ws, plan.eps) if plan.ra_mode
                  else tlat.lattice_scan(*xargs))
        if int(k_scan[0]) >= 0 and int(k_scan[1]) >= 2:
            found = xn, xargs, k_scan
            break
    assert found is not None
    xn, xargs, k_scan = found
    sfe = tlat.device_signs_plain(xn, 0, strides, widths, lo_sh, bases, plan.chunk, dims, d,
                                  with_fe=True)
    x = tlat.lattice_inputs(0, strides, widths, lo_sh, bases, plan.chunk, dims, d)
    f64 = chip_smoke.f64_forward(xn, x)
    own = chip_smoke.scan_from_signs(plan, xargs, sfe[0])
    assert chip_smoke.lattice_verdict(k_scan, sfe, k_scan, sfe, f64, own) == ([], 0)
    chip_smoke.lattice_mutants(k_scan, sfe, k_scan, sfe, f64, own)  # fails (exits) if one passes


# --------------------------------------------------------------------------
# decide_box_exhaustive on tests/test_lattice.py's cases


def _ramp_net(coefs, bias):
    w1 = np.zeros((4, 2), np.float32)
    for k, c in coefs.items():
        w1[k, 0] = c
    return [w1, np.array([[1.0], [0.0]], np.float32)], \
        [np.zeros(2, np.float32), np.array([bias], np.float32)]


def _zero_net():
    return [np.zeros((4, 4), np.float32), np.zeros((4, 1), np.float32)], \
        [np.zeros(4, np.float32), np.zeros(1, np.float32)]


CASES = {}
for s in range(6):
    CASES[f"oracle_{s}"] = (_toy_ranges(), (), 0, _net(s, (4, 8, 1)), [0] * 4, [2, 2, 2, 1],
                            dict(chunk=8))
for s in range(4):
    CASES[f"peel_{s}"] = (_toy_ranges(), (), 0, _net(s, (4, 8, 1)), [0] * 4, [2, 2, 2, 1],
                          dict(chunk=4, int32_limit=8, pipeline_depth=3))
CASES["exact_tie"] = (_toy_ranges(), (), 0, _zero_net(), [0] * 4, [2, 2, 2, 1],
                      dict(chunk=8))
CASES["no_legal_pair"] = (_toy_ranges(), (), 0, _net(0, (4, 8, 1)), [0, 0, 0, 1],
                          [2, 2, 2, 1], dict(chunk=8))
for s, e in itertools.product(range(4), (1, 2)):
    CASES[f"ra_window_{s}_eps{e}"] = (RA1, ("ra",), e, _net(s, (4, 8, 1)), [0] * 4,
                                      [4, 2, 2, 1], dict(chunk=16))
    CASES[f"ra2_window_{s}_eps{e}"] = (RA2, ("r1", "r2"), e, _net(s, (4, 8, 1)), [0] * 4,
                                       [3, 3, 2, 1], dict(chunk=32))
CASES["ra_ring"] = (RA1, ("ra",), 2, _ramp_net({0: 1.0}, -4.5), [0] * 4, [4, 2, 2, 1],
                    dict(chunk=16))
CASES["ra2_corner"] = (RA2, ("r1", "r2"), 2, _ramp_net({0: 1.0, 1: 1.0}, -7.5), [0] * 4,
                       [3, 3, 2, 1], dict(chunk=64))
for s in (3, 7, 11):
    CASES[f"ra3_{s}"] = (RA3, ("a0", "a1", "a2"), 2, _net(s, (4, 6, 1)), [0] * 4,
                         [2, 2, 2, 1], dict(chunk=1024))
CASES["ra_peeled"] = (RA1, ("ra",), 1, _net(2, (4, 8, 1)), [0] * 4, [4, 2, 2, 1],
                      dict(chunk=8, int32_limit=32, pipeline_depth=2))
CASES["ra2_peeled"] = (RA2, ("r1", "r2"), 1, _net(5, (4, 8, 1)), [0] * 4, [3, 3, 2, 1],
                       dict(chunk=36, int32_limit=128, pipeline_depth=2))


def _oracle(tn, tenc, lo, hi):
    """tests/test_lattice.py's oracles on the port's exact host code: every
    (shared point, valid pair) with exact signs (RA-free), or decide_leaf
    at every core point (RA)."""
    weights, biases = tn.numpy_params()
    dims = [k for k in range(len(lo)) if k not in tenc.pa_idx]
    for coord in itertools.product(*[range(int(lo[k]), int(hi[k]) + 1) for k in dims]):
        pt = np.array(lo, dtype=np.int64)
        pt[dims] = coord
        if tengine.decide_leaf(tenc, weights, biases, pt, lo, hi)[0] == "sat":
            return "sat"
    return "unsat"


def _witness(res):
    return None if res[1] is None else tuple(tuple(np.asarray(c).tolist()) for c in res[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_decide_box_exhaustive_matches_jax_and_oracle(case):
    ranges, relaxed, eps, (ws, bs), lo, hi, kw = CASES[case]
    jenc, tenc = _encs(ranges, relaxed=relaxed, eps=eps)
    jn, tn = _nets(ws, bs)
    lo, hi = np.array(lo, np.int64), np.array(hi, np.int64)
    want = jlat.decide_box_exhaustive(jn, jenc, lo, hi, **kw)
    got = tlat.decide_box_exhaustive(tn, tenc, lo, hi, **kw)
    assert (got[0], _witness(got)) == (want[0], _witness(want))
    assert got[0] == _oracle(tn, tenc, lo, hi)
    if got[0] == "sat":
        assert tengine.validate_pair(*tn.numpy_params(), *got[1])


def test_coordinate_gate_matches_jax():
    big = 1 << 24
    for hi_a0, relaxed in ((big, ()), (big - 1, ("a0",))):
        ranges = {"a0": (0, hi_a0), "p": (0, 1)}
        jenc, tenc = _encs(ranges, relaxed=relaxed, eps=2 if relaxed else 0)
        lo, hi = np.array([0, 0], np.int64), np.array([hi_a0, 1], np.int64)
        assert tlat.enumerable_size(tenc, lo, hi) is None is \
            jlat.enumerable_size(jenc, lo, hi)
        jn, tn = _nets(*_net(0, (2, 4, 1)))
        assert tlat.decide_box_exhaustive(tn, tenc, lo, hi)[0] == "unknown" == \
            jlat.decide_box_exhaustive(jn, jenc, lo, hi)[0]
    jenc, tenc = _encs({"a0": (0, big), "p": (0, 1)})
    hi_ok = np.array([3, 1], np.int64)
    assert tlat.enumerable_size(tenc, np.zeros(2, np.int64), hi_ok) == 4 == \
        jlat.enumerable_size(jenc, np.zeros(2, np.int64), hi_ok)


def test_lattice_phase_gates_match_jax():
    lo, hi = np.zeros((1, 4), np.int64), np.array([[2, 2, 2, 1]], np.int64)
    jn, tn = _nets(*_net(1, (4, 6, 1)))
    worlds = [(("a0", "a1", "a2"), 24, {}), ((), 0, dict(lattice_max=4)), ((), 0, {}),
              (("a0",), 2, {}), (("a0", "a1"), 2, {}), (("a0", "a1", "a2"), 2, {})]
    got = []
    for relaxed, eps, kw in worlds:
        jenc, tenc = _encs(RA3, relaxed=relaxed, eps=eps)
        jv, tv = ["unknown"], ["unknown"]
        jengine._lattice_phase(jn, jenc, lo, hi, jv, [None], np.zeros(1),
                               jengine.EngineConfig(**kw), time.perf_counter(), 30.0)
        tengine.lattice_phase(tn, tenc, lo, hi, tv, [None], np.zeros(1), EngineConfig(**kw),
                              time.perf_counter(), 30.0)
        assert tv == jv
        got.append(tv[0])
    assert got[:2] == ["unknown", "unknown"] and "unknown" not in got[2:]


@pytest.mark.parametrize("preset", ["stress-AC", "relaxed-AC", "relaxed3-BM"])
def test_enumerable_size_matches_jax(preset):
    jcfg, tcfg = jpresets.get(preset), tpresets.get(preset)
    _, jlo, jhi = jsweep.build_partitions(jcfg)
    _, tlo, thi = tsweep.build_partitions(tcfg)
    np.testing.assert_array_equal(tlo[:512], jlo[:512])
    jenc, tenc = jprop.encode(jcfg.query()), tprop.encode(tcfg.query())
    got = [tlat.enumerable_size(tenc, tlo[i], thi[i]) for i in range(512)]
    want = [jlat.enumerable_size(jenc, jlo[i], jhi[i]) for i in range(512)]
    assert got == want
    assert any(n is not None and n <= 6.4e7 for n in got) or preset == "relaxed3-BM"


# --------------------------------------------------------------------------
# decide_many, decide_box and verify_model with the lattice phases on


# Phase E0's per-root cap (5 s by default) raised: under a loaded CPU a
# scan cut short would leave a root to the BaB in one package and not in
# the other.
CAP = dict(lattice_first_cap_s=120.0)


def _eng(**kw):
    base = dict(pgd_phase=False, attack_samples=1, bab_attack_samples=1, bab_frontier_cap=8,
                bab_rounds_per_segment=4, soft_timeout_s=120.0, alpha_iters=2, **CAP)
    base.update(kw)
    return base


def _decide(seed, sizes, span, roots=1, **kw):
    ws, bs, _ = _params(seed, sizes)
    jenc, tenc, tq = _toy(span)
    lo = np.zeros((roots, 4), np.int64)
    hi = np.repeat(np.array([[span, span, span, 1]], np.int64), roots, axis=0)
    lo[:, 0] = np.arange(roots)
    jd = jengine.decide_many(jmlp.from_numpy(ws, bs), jenc, lo, hi,
                             jengine.EngineConfig(**_eng(**kw)), deadline_s=240.0)
    tn = tmlp.from_numpy(ws, bs, device="cpu")
    td = tengine.decide_many(tn, tenc, lo, hi, EngineConfig(**_eng(**kw)), deadline_s=240.0)
    for j, t in zip(jd, td):
        assert (t.verdict, t.reason, t.nodes, _ce(t)) == (j.verdict, j.reason, j.nodes, _ce(j))
    return td, tn


@pytest.mark.parametrize("seed", range(4))
def test_decide_many_phase_e0_matches_jax(seed):
    td, tn = _decide(seed, (4, 8, 1), 6, roots=2, sign_bab=False)
    assert [t.phase for t in td] == ["lattice_first"] * 2
    for t in td:
        assert t.stats["t_lattice"] > 0.0 and t.stats["t_bab"] == 0.0
        assert t.elapsed_s == pytest.approx(sum(t.stats.values()))
        if t.verdict == "sat":
            assert tengine.validate_pair(*tn.numpy_params(), *t.counterexample)


def test_decide_many_engine_defaults_match_jax():
    """``EngineConfig()`` unchanged apart from the E0 cap: PGD, Phase S
    with L, E0 (which decides what PGD leaves), BaB, P, E."""
    ws, bs, _ = _params(3, (4, 8, 1))
    jenc, tenc, _ = _toy(6)
    lo = np.zeros((2, 4), np.int64)
    lo[1, 1] = 3
    hi = np.array([[6, 6, 6, 1]] * 2, np.int64)
    jd = jengine.decide_many(jmlp.from_numpy(ws, bs), jenc, lo, hi,
                             jengine.EngineConfig(**CAP), deadline_s=240.0)
    td = tengine.decide_many(tmlp.from_numpy(ws, bs, device="cpu"), tenc, lo, hi,
                             EngineConfig(**CAP), deadline_s=240.0)
    for j, t in zip(jd, td):
        assert (t.verdict, t.reason, t.nodes, _ce(t)) == (j.verdict, j.reason, j.nodes, _ce(j))
    assert {t.phase for t in td} <= {"attack", "lp", "sign", "lattice_first"}
    assert "unknown" not in [t.verdict for t in td]


@pytest.mark.parametrize("seed", range(4))
def test_decide_many_phase_e_after_bab_and_p_matches_jax(seed):
    td, _ = _decide(seed, (4, 8, 1), 6, lattice_first_max=0, max_nodes=1, sign_bab=False,
                    lp_sign=False)
    t = td[0]
    assert t.verdict != "unknown" and t.phase in ("bab", "pair", "lattice")
    if t.phase == "lattice":
        assert t.stats["t_lattice"] > 0.0 and t.stats["t_bab"] > 0.0


def test_decide_many_phase_e_decides_some_root():
    phases = [_decide(s, (4, 8, 1), 6, lattice_first_max=0, max_nodes=1, sign_bab=False,
                      lp_sign=False, lp_pair=False)[0][0].phase for s in range(3)]
    assert "lattice" in phases


@pytest.mark.parametrize("max_nodes", [200_000, 1], ids=["bab", "retry"])
@pytest.mark.parametrize("world", ["ladder", "phase_l"])
def test_verify_model_default_config_matches_jax(tmp_path, world, max_nodes):
    """Phase E0 settles every partition of these worlds before the BaB,
    so the heuristic retry is not reached here even at max_nodes=1 (its
    masked-net decide_box is held against JAX below)."""
    sizes, seed = ((4, 1), 3) if world == "ladder" else ((8, 4, 1), 1)
    jrep, trep, jres, tres, thr, tnet = _world(tmp_path, "d", sizes, seed,
                                               lattice_exhaustive=True, max_nodes=max_nodes,
                                               **CAP)
    assert trep.counts == jrep.counts
    assert trep.funnel["states"] == jrep.funnel["states"]
    _assert_same_rows(jres, tres)
    assert thr["engine_decided"].get("lattice_first", 0) > 0
    assert thr["phases_s"]["engine_lattice"] > 0.0
    weights, biases = tnet.numpy_params()
    for o in trep.outcomes:
        if o.verdict == "sat":
            assert tengine.validate_pair(weights, biases, *o.counterexample)


@pytest.mark.parametrize("seed", [0, 2])
def test_masked_net_matches_jax(seed):
    """The heuristic retry's masked net: the device pass applies the masks,
    the host ladder does not; both packages decide_box alike."""
    ws, bs, _ = _params(seed, (4, 8, 1))
    jenc, tenc, _ = _toy(6)
    dead = [np.zeros(8, np.float32), np.zeros(1, np.float32)]
    dead[0][[1, 4]] = 1.0
    jn = jmasks.apply_dead_masks(jmlp.from_numpy(ws, bs), dead)
    tn = tmasks.apply_dead_masks(tmlp.from_numpy(ws, bs, device="cpu"), dead)
    lo, hi = np.zeros(4, np.int64), np.array([6, 6, 6, 1], np.int64)
    cfg = _eng(max_nodes=1, sign_bab=False)
    jd = jengine.decide_box(jn, jenc, lo, hi, jengine.EngineConfig(**cfg))
    td = tengine.decide_box(tn, tenc, lo, hi, EngineConfig(**cfg))
    assert (td.verdict, td.reason, td.nodes, _ce(td)) == (jd.verdict, jd.reason, jd.nodes,
                                                          _ce(jd))
    got = tlat.decide_box_exhaustive(tn, tenc, lo, hi, chunk=1 << 18)
    want = jlat.decide_box_exhaustive(jn, jenc, lo, hi, chunk=1 << 18)
    assert (got[0], _witness(got)) == (want[0], _witness(want))
    # Phase E0 decided the box, or (a device-certain sign of the masked net
    # failing the unmasked exact check) left it to the later phases.
    assert (td.phase == "lattice_first") == (got[0] != "unknown")
    # Seed 2: the scan of the masked net meets such a sign (the box is SAT
    # on both nets; the device BaB then finds the witness).
    assert (got[0] == "unknown") == (seed == 2)
