"""The port's certificate phases S, L and P against the JAX package's, on
the CPU, in the slice-3 engine configuration
``EngineConfig(lattice_exhaustive=False)`` (every other field at its
default).

* ``leaf_sign_lp`` and ``uniform_sign_bab`` on tests/test_bab2.py's worlds
  (a net positive over its box, one with an obvious sign change, the
  fully-resolved leaf LP): equal outcomes, verdicts and node counts.
* ``decide_many`` on toy worlds where Phase L (the host LP inside S),
  Phase S's device sign frontier (with ``lp_sign_max_unstable=0``, K8a's
  plain version) and Phase P each decide a root: verdict, reason, node
  count and counterexample equal JAX's and the brute-force oracle's, and
  the deciding phase's time is the one attributed.
* ``verify_model`` on German-derived worlds in the slice-3 configuration
  (one where Phase L decides partitions the slice-2 configuration leaves
  unknown, and bench.py's BaB ladder), directly and through the heuristic
  retry (``max_nodes=1``): ledger rows and CSV rows equal JAX's.
* With ``lattice_exhaustive=True`` Phase S runs and Phase E0 (ported
  since) decides the root after it, as in JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

from fairify_tpu.data.domains import DomainSpec as JDomainSpec
from fairify_tpu.data.domains import get_domain
from fairify_tpu.models import mlp as jmlp
from fairify_tpu.models.train import init_mlp
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import property as jprop
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.data.domains import DomainSpec
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.verify import engine as tengine
from fairify_tpu_torch.verify import oracle
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import property as tprop
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig

from test_torch_bab import _assert_same_rows, _ce, _params, _toy

SLICE3 = dict(lattice_exhaustive=False)


def _domains(ranges):
    cols = tuple(ranges)
    return (JDomainSpec(name="toy", columns=cols, ranges=dict(ranges), label="y"),
            DomainSpec(name="toy", columns=cols, ranges=dict(ranges), label="y"))


def _encs(ranges):
    jd, td = _domains(ranges)
    return (jprop.encode(jprop.FairnessQuery(domain=jd, protected=("pa",))),
            tprop.encode(tprop.FairnessQuery(domain=td, protected=("pa",))), jd)


# --------------------------------------------------------------------------
# leaf_sign_lp and uniform_sign_bab


@pytest.mark.parametrize("want_pos", [True, False])
def test_leaf_sign_lp_matches_jax(want_pos):
    rng = np.random.default_rng(11)
    ws = [rng.normal(size=(2, 3)).astype(np.float32),
          rng.normal(size=(3, 1)).astype(np.float32)]
    bs = [rng.normal(size=(3,)).astype(np.float32), np.array([2.0], np.float32)]
    masks = [np.ones(3, np.float32), np.ones(1, np.float32)]
    lo, hi = np.zeros(2), np.full(2, 5.0)
    seen = set()
    for pattern in ([1, 1, 1], [1, -1, 1], [-1, -1, -1], [1, 0, 1], [-1, 1, -1]):
        pat = [np.array(pattern)]
        got = tengine.leaf_sign_lp(ws, bs, masks, pat, lo, hi, want_pos)
        assert got == jengine._leaf_sign_lp(ws, bs, masks, pat, lo, hi, want_pos)
        seen.add(got)
    assert "mixed" in seen and len(seen) >= 2


def _positive_net():
    rng = np.random.default_rng(7)
    ws = [rng.normal(size=(3, 6)).astype(np.float32) * 0.1,
          rng.normal(size=(6, 1)).astype(np.float32) * 0.1]
    return ws, [np.zeros(6, np.float32), np.full(1, 5.0, np.float32)]


def _mixed_net():
    # f = relu(a) - 3: mixed sign over a in [0, 6].
    return ([np.array([[1.0], [0.0], [0.0]], np.float32), np.array([[1.0]], np.float32)],
            [np.array([0.0], np.float32), np.array([-3.0], np.float32)])


@pytest.mark.parametrize("kw", [dict(), dict(lp_sign=False), dict(lp_sign_max_unstable=0)],
                         ids=["phase_l", "frontier_only", "lp_gate_0"])
@pytest.mark.parametrize("world", ["positive", "mixed"])
def test_uniform_sign_bab_matches_jax(world, kw):
    ws, bs = _positive_net() if world == "positive" else _mixed_net()
    jenc, tenc, jd = _encs({"a": (0, 6), "pa": (0, 1), "b": (0, 6)})
    lo, hi = jd.lo_hi()
    R = 2 if world == "positive" else 1
    rl = np.repeat(lo.astype(np.int64)[None], R, axis=0)
    rh = np.repeat(hi.astype(np.int64)[None], R, axis=0)
    kw = dict(kw, alpha_iters=4)
    jv, jn, _, _ = jengine.uniform_sign_bab(jmlp.from_numpy(ws, bs), jenc, rl, rh,
                                            jengine.EngineConfig(**kw), deadline_s=60.0)
    tv, tn, tc, tlp = tengine.uniform_sign_bab(tmlp.from_numpy(ws, bs, device="cpu"), tenc,
                                               rl, rh, EngineConfig(**kw), deadline_s=60.0)
    assert tv == jv == (["unsat"] * R if world == "positive" else ["mixed"])
    np.testing.assert_array_equal(tn, jn)
    if world == "positive":
        assert (tn >= 1).all() and (tc > 0).all()
        assert ((tlp > 0) == (kw.get("lp_sign", True)
                              and kw.get("lp_sign_max_unstable", 64) > 0)).all()


def test_uniform_sign_bab_rejects_a_mesh():
    # The mesh is ported: an object that is not the port's Mesh raises
    # TypeError, and a one-shard mesh gives the unsharded outcome.
    from fairify_tpu_torch.parallel.mesh import submesh

    ws, bs = _positive_net()
    _, tenc, jd = _encs({"a": (0, 6), "pa": (0, 1), "b": (0, 6)})
    lo, hi = jd.lo_hi()
    net = tmlp.from_numpy(ws, bs, device="cpu")
    args = (net, tenc, lo.astype(np.int64)[None], hi.astype(np.int64)[None],
            EngineConfig(alpha_iters=4))
    with pytest.raises(TypeError, match="Mesh"):
        tengine.uniform_sign_bab(*args, deadline_s=10.0, mesh=object())
    got = tengine.uniform_sign_bab(*args, deadline_s=60.0, mesh=submesh(["cpu"]))
    want = tengine.uniform_sign_bab(*args, deadline_s=60.0)
    assert got[0] == want[0] == ["unsat"]
    np.testing.assert_array_equal(got[1], want[1])


# --------------------------------------------------------------------------
# decide_many in the slice-3 configuration


def _eng(**kw):
    base = dict(SLICE3, pgd_phase=False, attack_samples=1, bab_attack_samples=1,
                bab_frontier_cap=8, bab_rounds_per_segment=4, soft_timeout_s=120.0,
                max_nodes=1)
    base.update(kw)
    return base


# (seed, sizes, engine overrides, the phase that decides, its verdict)
WORLDS = {
    "L_seed0": (0, (4, 8, 1), {}, "t_lp", "unsat"),
    "L_seed5": (5, (4, 8, 1), {}, "t_lp", "unsat"),
    "S_seed0": (0, (4, 8, 1), dict(lp_sign_max_unstable=0), "t_sign", "unsat"),
    "S_deep_seed4": (4, (4, 8, 8, 1), dict(lp_sign_max_unstable=0), "t_sign", "unsat"),
    "P_seed3": (3, (4, 8, 1), {}, "t_pair", "sat"),
    "P_seed4": (4, (4, 8, 1), {}, "t_pair", "sat"),
    "P_seed5_pgd": (5, (4, 8, 1), dict(pgd_phase=True, alpha_iters=2,
                                       lp_sign_max_unstable=0), "t_pair", "unsat"),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_decide_many_slice3_matches_jax(world):
    seed, sizes, kw, phase, verdict = WORLDS[world]
    ws, bs, _ = _params(seed, sizes)
    jenc, tenc, tq = _toy(6)
    lo = np.zeros((1, 4), np.int64)
    hi = np.array([[6, 6, 6, 1]], np.int64)
    jd = jengine.decide_many(jmlp.from_numpy(ws, bs), jenc, lo, hi,
                             jengine.EngineConfig(**_eng(**kw)), deadline_s=240.0)[0]
    tn = tmlp.from_numpy(ws, bs, device="cpu")
    td = tengine.decide_many(tn, tenc, lo, hi, EngineConfig(**_eng(**kw)),
                             deadline_s=240.0)[0]
    assert (td.verdict, td.reason, td.nodes, _ce(td)) == \
        (jd.verdict, jd.reason, jd.nodes, _ce(jd))
    assert td.verdict == verdict == oracle.brute_force_verdict(tn, tq, lo[0], hi[0])
    if td.verdict == "sat":
        assert tengine.validate_pair(*tn.numpy_params(), *td.counterexample)
    # The deciding phase: L settles before the frontier (t_sign 0), the
    # frontier without L (t_lp 0); P runs only on roots the BaB left open.
    assert td.stats[phase] > 0.0
    assert td.phase == {"t_lp": "lp", "t_sign": "sign", "t_pair": "pair"}[phase]
    if phase == "t_lp":
        assert td.stats["t_sign"] == 0.0 and td.stats["t_bab"] == 0.0
    if phase == "t_sign":
        assert td.stats["t_lp"] == 0.0 and td.stats["t_bab"] == 0.0
    if phase == "t_pair":
        assert td.stats["t_bab"] > 0.0
    assert td.elapsed_s == pytest.approx(sum(td.stats.values()))


def test_lattice_still_raises_k9_after_phase_s(monkeypatch):
    """Phase E0 (K9, ported since) runs after Phase S: the root that once
    raised here is now decided as in JAX."""
    calls = []
    real = tengine.uniform_sign_bab
    monkeypatch.setattr(tengine, "uniform_sign_bab",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ws, bs, _ = _params(3, (4, 6, 1))
    jenc, tenc, tq = _toy(6)
    kw = _eng(lattice_exhaustive=True, bab_frontier_cap=4, alpha_iters=2,
              lattice_first_cap_s=120.0)
    lo, hi = np.zeros((1, 4), np.int64), np.array([[6, 6, 6, 1]], np.int64)
    jd = jengine.decide_many(jmlp.from_numpy(ws, bs), jenc, lo, hi,
                             jengine.EngineConfig(**kw), deadline_s=60.0)[0]
    tn = tmlp.from_numpy(ws, bs, device="cpu")
    td = tengine.decide_many(tn, tenc, lo, hi, EngineConfig(**kw), deadline_s=60.0)[0]
    assert calls
    assert (td.verdict, td.reason, td.nodes, _ce(td)) == \
        (jd.verdict, jd.reason, jd.nodes, _ce(jd))
    assert td.verdict == oracle.brute_force_verdict(tn, tq, lo[0], hi[0])
    assert td.phase in ("lattice_first", "lp", "sign")


# --------------------------------------------------------------------------
# verify_model in the slice-3 configuration


def _world(tmp_path, tag, net_sizes, seed, **engine_kw):
    ov = {c: (0, 0) for c in get_domain("german").columns}
    ov.update(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2))
    ek = dict(SLICE3, pgd_phase=False, attack_samples=4, bab_attack_samples=4,
              bab_frontier_cap=64, bab_rounds_per_segment=8, **engine_kw)
    kw = dict(soft_timeout_s=20.0, hard_timeout_s=120.0, sim_size=16,
              exact_certify_masks=False, grid_chunk=8, domain_overrides=ov,
              partition_threshold=2)
    jcfg = jpresets.get("GC").with_(result_dir=str(tmp_path / f"j{tag}"),
                                    engine=jengine.EngineConfig(**ek), **kw)
    tcfg = tpresets.get("GC").with_(result_dir=str(tmp_path / f"t{tag}"),
                                    engine=EngineConfig(**ek), **kw)
    net = init_mlp((len(jcfg.query().columns),) + net_sizes, seed=seed)
    jrep = jsweep.verify_model(net, jcfg, model_name="m", resume=False,
                               partition_span=(0, 8))
    tnet = tmlp.from_numpy([np.asarray(w) for w in net.weights],
                           [np.asarray(b) for b in net.biases], device="cpu")
    trep = tsweep.verify_model(tnet, tcfg, model_name="m", resume=False, device="cpu",
                               partition_span=(0, 8))

    def read(cfg):
        import csv

        with open(os.path.join(cfg.result_dir, "GC-m@0-8.ledger.jsonl")) as fp:
            led = [json.loads(line) for line in fp if line.strip()]
        with open(os.path.join(cfg.result_dir, "m@0-8.csv"), newline="") as fp:
            rows = list(csv.reader(fp))
        return led, rows

    with open(os.path.join(tcfg.result_dir, "GC-m@0-8.throughput.json")) as fp:
        thr = json.load(fp)
    return jrep, trep, read(jcfg), read(tcfg), thr, tnet


@pytest.mark.parametrize("max_nodes", [200_000, 1], ids=["bab", "retry"])
@pytest.mark.parametrize("world", ["phase_l", "ladder"])
def test_verify_model_slice3_matches_jax(tmp_path, world, max_nodes):
    sizes, seed = ((8, 4, 1), 1) if world == "phase_l" else ((4, 1), 3)
    jrep, trep, jres, tres, thr, tnet = _world(tmp_path, "s", sizes, seed,
                                               max_nodes=max_nodes)
    assert trep.counts == jrep.counts
    assert trep.funnel["states"] == jrep.funnel["states"]
    _assert_same_rows(jres, tres)
    assert thr["phases_s"].get("engine_pair", 0.0) > 0.0 or max_nodes > 1
    if world == "phase_l" and max_nodes == 1:
        # Phase L decides partitions the slice-2 configuration leaves open.
        assert thr["phases_s"]["engine_lp"] > 0.0 and thr["engine_decided"]["lp"] > 0
        s2 = _world(tmp_path, "2", sizes, seed, max_nodes=1, sign_bab=False,
                    lp_sign=False, lp_pair=False)[1]
        assert trep.counts["unsat"] > s2.counts["unsat"]
    if world == "ladder" and max_nodes > 1:
        assert trep.counts == {"sat": 0, "unsat": 8, "unknown": 0}
    if max_nodes == 1:
        assert any(o.h_attempt for o in trep.outcomes)
    weights, biases = tnet.numpy_params()
    for o in trep.outcomes:
        if o.verdict == "sat":
            assert tengine.validate_pair(weights, biases, *o.counterexample)
