"""The port's exact UNSAT checker (``verify.exact_check``) and the sampled
integrity recheck against the JAX package's.

* Every case of ``tests/test_exact_check.py``: the exact simplex, the dual
  bound, the pair checker (random nets, a relaxed attribute,
  the RA direction asymmetry and two protected attributes) and the sign
  certificates give the JAX package's results exactly, on the port's own
  encoding.
* ``integrity_recheck=1.0``: both packages recheck every chunk that
  drained clean, escalate each chunk's first certified partition to the
  exact oracle, and give equal outcomes and ``integrity_rechecks`` totals,
  on the mega path and on the chunk loop.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_net
from fairify_tpu.data.domains import DomainSpec as JDomainSpec
from fairify_tpu.obs import metrics as jmetrics
from fairify_tpu.verify import exact_check as jec
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import property as jprop
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.data.domains import DomainSpec
from fairify_tpu_torch.models.mlp import flagship_net
from fairify_tpu_torch.obs import metrics as tmetrics
from fairify_tpu_torch.verify import exact_check as ec
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import property as tprop
from fairify_tpu_torch.verify import sweep as tsweep


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The worlds here are tiny: torch's intra-op threads only contend with
    each other and with the other test workers.  One thread for this
    module, the count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

F = Fraction


def _encs(ranges, protected, relaxed=(), eps=0):
    """The JAX package's and the port's encodings of one toy query."""
    out = []
    for spec_cls, prop in ((JDomainSpec, jprop), (DomainSpec, tprop)):
        dom = spec_cls(name="toy", columns=tuple(ranges),
                       ranges={k: tuple(v) for k, v in ranges.items()}, label="y")
        out.append(prop.encode(prop.FairnessQuery(domain=dom, protected=protected,
                                                  relaxed=relaxed, relax_eps=eps)))
    lo = np.asarray([v[0] for v in ranges.values()], np.int64)
    hi = np.asarray([v[1] for v in ranges.values()], np.int64)
    return out[0], out[1], lo, hi


@pytest.mark.parametrize("case", ["feasible", "infeasible", "pinned"])
def test_simplex_equals_jax(case):
    A, b, lo, hi = {
        "feasible": ([[F(-1), F(-1)], [F(1), F(-1)]], [F(-3), F(1)], [F(0)] * 2, [F(10)] * 2),
        "infeasible": ([[F(-1), F(0)], [F(1), F(0)]], [F(-5), F(2)], [F(0)] * 2, [F(10)] * 2),
        "pinned": ([[F(-1), F(-1)]], [F(-6)], [F(0), F(4)], [F(10), F(4)]),
    }[case]
    got = ec._feasible(A, b, lo, hi)
    assert got == jec._feasible(A, b, lo, hi)
    assert got[0] == ("infeasible" if case == "infeasible" else "feasible")


def test_exact_dual_bound_equals_jax():
    args = ([F(1), F(1)], [[F(-1), F(-1)]], [F(-3)], [[F(1), F(-1)]], [F(1)],
            [F(0), F(0)], [F(10), F(10)])
    for y_ub, y_eq in (([F(1)], [F(0)]), ([F(0)], [F(7)])):
        got = ec._exact_dual_bound(*args, y_ub, y_eq)
        assert got == jec._exact_dual_bound(*args, y_ub, y_eq) and got <= 3


@pytest.mark.parametrize("seed", range(6))
def test_pair_checker_equals_jax(seed):
    rng = np.random.default_rng(seed)
    jenc, tenc, lo, hi = _encs({"a": (0, 4), "pa": (0, 2), "b": (0, 4)}, ("pa",))
    ws = [rng.normal(size=(3, 6)).astype(np.float32) * 0.6,
          rng.normal(size=(6, 1)).astype(np.float32)]
    bs = [(rng.normal(size=(6,)) * 0.3).astype(np.float32),
          np.array([float(rng.normal()) * 0.5], dtype=np.float32)]
    got = ec.decide_pair_box_exact(ws, bs, tenc, lo, hi, max_nodes=20000)
    assert got == jec.decide_pair_box_exact(ws, bs, jenc, lo, hi, max_nodes=20000)
    assert got["verdict"] in ("unsat_confirmed", "refuted")
    if got["verdict"] == "refuted":
        x, xp = (np.asarray(v) for v in got["witness"])
        assert ec.pair_is_legal(tenc, lo, hi, x, xp)


@pytest.mark.parametrize("case", ["relaxed", "ra_asymmetry", "multi_pa"])
def test_pair_checker_special_cases_equal_jax(case):
    if case == "relaxed":
        ws = [np.array([[0.0], [2.0], [1.0]], np.float32), np.array([[1.0]], np.float32)]
        bs = [np.array([0.0], np.float32), np.array([-2.5], np.float32)]
        encs = _encs({"a": (0, 1), "pa": (0, 1), "ra": (1, 1)}, ("pa",), ("ra",), 1)
        want = "refuted"
    elif case == "ra_asymmetry":
        ws = [np.array([[0.0], [0.0], [1.0]], np.float32), np.array([[1.0]], np.float32)]
        bs = [np.array([0.0], np.float32), np.array([-4.5], np.float32)]
        encs = _encs({"a": (0, 1), "pa": (0, 1), "ra": (0, 4)}, ("pa",), ("ra",), 1)
        want = "refuted"
    else:
        ws = [np.array([[0.0, 0.0], [1.0, -1.0], [-1.0, 1.0]], np.float32),
              np.array([[4.0], [4.0]], np.float32)]
        bs = [np.zeros(2, np.float32), np.array([-2.0], np.float32)]
        encs = _encs({"a": (0, 1), "p": (0, 1), "q": (0, 1)}, ("p", "q"))
        want = "unsat_confirmed"
    jenc, tenc, lo, hi = encs
    got = ec.decide_pair_box_exact(ws, bs, tenc, lo, hi)
    assert got == jec.decide_pair_box_exact(ws, bs, jenc, lo, hi)
    assert got["verdict"] == want


@pytest.mark.parametrize("case", ["positive", "needs_splits", "mixed", "negative"])
def test_sign_certificate_equals_jax(case):
    ws, bs, lo, hi, positive, want = {
        "positive": ([[[1.0, -1.0]], [[1.0], [1.0]]], [[0.0, 0.0], [0.5]], -4, 4, True,
                     "confirmed"),
        "needs_splits": ([[[1.0, -1.0, 1.0]], [[-1.0], [1.0], [1.0]]],
                         [[0.0, 0.0, 8.0], [-7.0]], -4, 4, True, "confirmed"),
        "mixed": ([[[1.0]], [[1.0]]], [[0.0], [-2.0]], 0, 6, True, "not_confirmed"),
        "negative": ([[[1.0]], [[-1.0]]], [[0.0], [-1.0]], 0, 6, False, "confirmed"),
    }[case]
    ws = [np.asarray(w, np.float32) for w in ws]
    bs = [np.asarray(b, np.float32) for b in bs]
    args = (ws, bs, np.array([lo]), np.array([hi]))
    got = ec.confirm_sign_certificate(*args, want_positive=positive)
    assert got == jec.confirm_sign_certificate(*args, want_positive=positive)
    assert got["verdict"] == want


def test_exact_logit_sign_frac_equals_jax():
    rng = np.random.default_rng(3)
    ws = [rng.normal(size=(2, 4)).astype(np.float32), rng.normal(size=(4, 1)).astype(np.float32)]
    bs = [rng.normal(size=(4,)).astype(np.float32), rng.normal(size=(1,)).astype(np.float32)]
    W, B = ec._frac_weights(ws, bs)
    JW, JB = jec._frac_weights(ws, bs)
    for _ in range(20):
        x = rng.integers(-5, 6, size=2)
        assert ec._exact_logit_sign_frac(W, B, x) == jec._exact_logit_sign_frac(JW, JB, x)


@pytest.mark.parametrize("mega_chunks", [8, 0], ids=["mega", "chunk"])
def test_full_recheck_equals_jax(tmp_path, mega_chunks):
    kw = dict(grid_chunk=8, mega_chunks=mega_chunks, exact_certify_masks=False,
              integrity_recheck=1.0)
    jmetrics.registry().reset()
    tmetrics.registry().reset()
    jrep = jsweep.verify_model(_flagship_net(), jpresets.get("GC").with_(
        result_dir=str(tmp_path / "jax"), **kw), resume=False, partition_span=(0, 16))
    trep = tsweep.verify_model(flagship_net(device="cpu"), tpresets.get("GC").with_(
        result_dir=str(tmp_path / "port"), **kw), resume=False, device="cpu",
        partition_span=(0, 16))
    outcomes = lambda rep: [(o.partition_id, o.verdict, o.pruned_acc) for o in rep.outcomes]
    assert outcomes(trep) == outcomes(jrep) and trep.degraded == jrep.degraded == 0
    rechecks = lambda reg: reg.counter("integrity_rechecks").snapshot()
    assert rechecks(tmetrics.registry()) == rechecks(jmetrics.registry())
    # Both chunks rechecked, each escalated to the oracle.
    assert {s["labels"]["kind"]: s["value"] for s in rechecks(tmetrics.registry())} == \
        {"chunk": 2, "exact": 2}
    assert tmetrics.registry().counter("integrity_violations").total() == 0
