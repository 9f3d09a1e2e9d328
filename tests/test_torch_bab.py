"""The port's device-BaB path (K6's plain version and the engine around it) against
the JAX package's, on the CPU, in the slice's engine configuration (Phases
S, L, P, E0/E off).

* One ``bab_segment_plain`` call against ``_bab_segment_kernel`` on the
  same queue, ``alpha_iters`` 0 and 2: the queue, the latches, the per-root
  counters and the int32 fold are equal (small integer boxes: the f32
  bounds of both sides decide alike).
* ``decide_many`` on tests/test_bab.py's worlds: the verdict, reason,
  node count and counterexample of every root equal JAX's, and every
  decided verdict equals the brute-force oracle's (the port's copy).
* ``verify_model`` on bench.py's ``_bab_ladder`` world decides 8/8 with
  ledger and CSV rows equal to JAX's; with ``max_nodes=1`` every partition
  takes the heuristic-retry path and the rows still equal JAX's.
* The BaB integrity detectors: fold checksum and canary slot.
* The phases ported since (S, P, E0/E, the host frontier) run the world
  where an unported phase once raised, and equal JAX; so does the SMT tier
  on the world whose roots reach it.
"""
import csv
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairify_tpu.data.domains import DomainSpec as JDomainSpec
from fairify_tpu.data.domains import get_domain
from fairify_tpu.models import mlp as jmlp
from fairify_tpu.models.train import init_mlp
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu.verify.property import FairnessQuery as JQuery
from fairify_tpu.verify.property import encode as jencode
from fairify_tpu_torch.data.domains import DomainSpec
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.resilience import integrity
from fairify_tpu_torch.verify import engine as tengine
from fairify_tpu_torch.verify import oracle
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig
from fairify_tpu_torch.verify.property import FairnessQuery, encode

TAIL = dict(sign_bab=False, lp_sign=False, lp_pair=False, lattice_exhaustive=False)


def _params(seed, sizes, mask=False):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=0.6, size=(sizes[i], sizes[i + 1])).astype(np.float32)
          for i in range(len(sizes) - 1)]
    bs = [rng.normal(scale=0.2, size=(sizes[i + 1],)).astype(np.float32)
          for i in range(len(sizes) - 1)]
    ms = [np.ones(b, np.float32) for b in sizes[1:]]
    if mask:
        ms[0][1] = 0.0
    return ws, bs, ms


def _toy(span):
    names = ("a0", "a1", "a2", "p")
    ranges = {n: (0, span) for n in names}
    ranges["p"] = (0, 1)
    jq = JQuery(domain=JDomainSpec(name="toy", columns=names, ranges=ranges, label="y"),
                protected=("p",))
    tq = FairnessQuery(domain=DomainSpec(name="toy", columns=names, ranges=ranges,
                                         label="y"), protected=("p",))
    return jencode(jq), encode(tq), tq


# --------------------------------------------------------------------------
# (d) one segment


def _queue(d, span, Q=8, G=2, V=2):
    Qs = Q + 1
    q_lo = np.zeros((Qs, d), np.float32)
    q_hi = np.zeros((Qs, d), np.float32)
    q_root = np.zeros(Qs, np.int32)
    q_live = np.zeros(Qs, bool)
    for k in range(G):
        q_hi[k, :d - 1], q_hi[k, d - 1], q_lo[k, 0] = span, 1, k
        q_root[k], q_live[k] = k, True
    slot_ok = np.ones(Qs, bool)
    slot_ok[-1] = False  # the canary slot
    av = np.zeros((V, d), np.float32)
    av[:, d - 1] = [0, 1]
    pm = np.zeros(d, np.float32)
    pm[d - 1] = 1.0
    rm = np.zeros(d, np.float32)
    rm[0] = 1.0
    return ([q_lo, q_hi, q_root, q_live, np.zeros(Qs, bool), np.zeros(Qs, np.int32),
             np.zeros(Qs, np.int32), np.zeros((Qs, d), np.float32), slot_ok,
             np.ones((G, V), bool), av, pm, rm],
            np.array([[False, True], [True, False]]), 1.0 - pm)


@pytest.mark.parametrize("alpha", [0, 2])
@pytest.mark.parametrize("seed,sizes,eps", [(0, (4, 8, 6, 1), 0.0), (1, (5, 10, 1), 2.0),
                                            (3, (4, 8, 6, 1), 0.0)])
def test_bab_segment_matches_jax_kernel(seed, sizes, eps, alpha):
    ws, bs, ms = _params(seed, sizes, mask=True)
    jn = jmlp.MLP(tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
                  tuple(map(jnp.asarray, ms)))
    tn = tmlp.from_numpy(ws, bs, ms, device="cpu")
    args, vp, bm = _queue(sizes[0], 6)
    want = jengine._bab_segment_kernel(jn, *map(jnp.asarray, args), eps, jnp.asarray(vp),
                                       jnp.asarray(bm), rounds=4, alpha_iters=alpha)
    got = tengine.bab_segment_plain(tn, *map(torch.as_tensor, args), eps,
                                    torch.as_tensor(vp), torch.as_tensor(bm), 4, alpha)
    keys = integrity.BAB_FOLD_KEYS + ("csum",)
    for k, w in zip(keys, want):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w), err_msg=k)
    assert integrity.verify_bab_segment({k: np.asarray(got[k]) for k in keys}) is None
    assert int(np.asarray(want[8]).sum()) > 2  # the segment branched


# --------------------------------------------------------------------------
# (e) decide_many


def _jeng(**kw):
    base = dict(pgd_phase=False, attack_samples=1, bab_attack_samples=1, alpha_iters=2,
                device_bab=True, bab_frontier_cap=8, bab_rounds_per_segment=4,
                soft_timeout_s=120.0, **TAIL)
    base.update(kw)
    return base


def _decide_both(seed, sizes, span, **kw):
    ws, bs, _ = _params(seed, sizes)
    jenc, tenc, tq = _toy(span)
    lo = np.zeros((1, 4), np.int64)
    hi = np.array([[span, span, span, 1]], np.int64)
    jd = jengine.decide_many(jmlp.from_numpy(ws, bs), jenc, lo, hi,
                             jengine.EngineConfig(**_jeng(**kw)), deadline_s=240.0)[0]
    tn = tmlp.from_numpy(ws, bs, device="cpu")
    td = tengine.decide_many(tn, tenc, lo, hi, EngineConfig(**_jeng(**kw)),
                             deadline_s=240.0)[0]
    return jd, td, tn, tq, lo[0], hi[0]


def _ce(dec):
    return None if dec.counterexample is None else \
        tuple(tuple(np.asarray(c).tolist()) for c in dec.counterexample)


@pytest.mark.parametrize("pgd", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_decide_many_matches_jax_and_oracle(seed, pgd):
    jd, td, tn, tq, lo, hi = _decide_both(seed, (4, 8, 1), 2, pgd_phase=pgd)
    assert (td.verdict, td.reason, td.nodes, _ce(td)) == \
        (jd.verdict, jd.reason, jd.nodes, _ce(jd))
    assert td.verdict == oracle.brute_force_verdict(tn, tq, lo, hi)
    if td.verdict == "sat":
        assert tengine.validate_pair(*tn.numpy_params(), *td.counterexample)


@pytest.mark.parametrize("seed", (0, 2, 3, 6))
def test_decide_many_capacity_floor_matches_jax(seed):
    # Span-6 world at the floor capacity: seed 3 overflows
    # ('frontier:overflow'), the others decide through branching.
    jd, td, *_ = _decide_both(seed, (4, 6, 1), 6, bab_frontier_cap=4, alpha_iters=0,
                              bab_rounds_per_segment=1, max_nodes=100000)
    assert (td.verdict, td.reason, td.nodes, _ce(td)) == \
        (jd.verdict, jd.reason, jd.nodes, _ce(jd))
    if seed == 3:
        assert td.reason == "frontier:overflow"


# --------------------------------------------------------------------------
# (f), (g) the sweep on bench.py's _bab_ladder world


def _ladder(tmp_path, tag, **engine_kw):
    ov = {c: (0, 0) for c in get_domain("german").columns}
    ov.update(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2))
    ek = dict(pgd_phase=False, attack_samples=4, bab_attack_samples=4,
              bab_frontier_cap=64, bab_rounds_per_segment=8, **TAIL, **engine_kw)
    kw = dict(soft_timeout_s=20.0, hard_timeout_s=120.0, sim_size=16,
              exact_certify_masks=False, grid_chunk=8, domain_overrides=ov,
              partition_threshold=2)
    jcfg = jpresets.get("GC").with_(result_dir=str(tmp_path / f"j{tag}"),
                                    engine=jengine.EngineConfig(**ek), **kw)
    tcfg = tpresets.get("GC").with_(result_dir=str(tmp_path / f"t{tag}"),
                                    engine=EngineConfig(**ek), **kw)
    net = init_mlp((len(jcfg.query().columns), 4, 1), seed=3)
    jrep = jsweep.verify_model(net, jcfg, model_name="BaB-1", resume=False,
                               partition_span=(0, 8))
    tnet = tmlp.from_numpy([np.asarray(w) for w in net.weights],
                           [np.asarray(b) for b in net.biases], device="cpu")
    trep = tsweep.verify_model(tnet, tcfg, model_name="BaB-1", resume=False,
                               device="cpu", partition_span=(0, 8))

    def read(cfg):
        with open(os.path.join(cfg.result_dir, "GC-BaB-1@0-8.ledger.jsonl")) as fp:
            led = [json.loads(line) for line in fp if line.strip()]
        with open(os.path.join(cfg.result_dir, "BaB-1@0-8.csv"), newline="") as fp:
            rows = list(csv.reader(fp))
        return led, rows

    return jrep, trep, read(jcfg), read(tcfg), tnet


_CSV_COLS = ("Partition_ID", "Verification", "SAT_count", "UNSAT_count", "UNK_count",
             "h_attempt", "h_success", "B_compression", "S_compression",
             "ST_compression", "H_compression", "T_compression", "C-check",
             "V-accurate", "Pruned-acc", "C1", "C2")


def _assert_same_rows(jres, tres):
    (jled, jrows), (tled, trows) = jres, tres
    assert [(r["partition_id"], r["verdict"], r["ce"]) for r in tled] == \
        [(r["partition_id"], r["verdict"], r["ce"]) for r in jled]
    assert trows[0] == jrows[0]
    cols = [trows[0].index(c) for c in _CSV_COLS]
    assert [[r[i] for i in cols] for r in trows[1:]] == \
        [[r[i] for i in cols] for r in jrows[1:]]


def test_ladder_world_matches_jax(tmp_path):
    jrep, trep, jres, tres, tnet = _ladder(tmp_path, "l")
    assert trep.counts == jrep.counts == {"sat": 0, "unsat": 8, "unknown": 0}
    assert trep.funnel["states"] == jrep.funnel["states"] == {"certified:bab": 8}
    _assert_same_rows(jres, tres)
    weights, biases = tnet.numpy_params()
    for o in trep.outcomes:
        if o.verdict == "sat":
            assert tengine.validate_pair(weights, biases, *o.counterexample)
    with open(os.path.join(str(tmp_path / "tl"), "GC-BaB-1@0-8.throughput.json")) as fp:
        thr = json.load(fp)
    assert thr["bab_decided"] == 8 and thr["decided_fraction"] == 1.0
    assert {"stage0_pgd", "bab", "engine_bab"} <= set(thr["phases_s"])


def test_heuristic_retry_rows_match_jax(tmp_path):
    jrep, trep, jres, tres, _ = _ladder(tmp_path, "h", max_nodes=1)
    assert trep.counts == jrep.counts
    assert all(o.h_attempt == 1 for o in trep.outcomes)
    _assert_same_rows(jres, tres)
    unknown = [r for r in tres[0] if r["verdict"] == "unknown"]
    assert unknown and all(r["engine_reason"] == "budget" for r in unknown)
    assert trep.funnel["states"] == jrep.funnel["states"]


# --------------------------------------------------------------------------
# Integrity and the unported phases


def test_bab_integrity_detectors():
    rng = np.random.default_rng(7)
    qs, d = 5, 4
    payload = {"q_lo": rng.integers(0, 5, size=(qs, d)).astype(np.float32),
               "q_hi": rng.integers(5, 9, size=(qs, d)).astype(np.float32),
               "q_root": np.zeros(qs, np.int32), "q_live": np.ones(qs, bool),
               "found": np.zeros(qs, bool), "wit_a": np.zeros(qs, np.int32),
               "wit_b": np.zeros(qs, np.int32), "wit_pt": np.zeros((qs, d), np.float32),
               "nodes": np.ones(1, np.int32), "splits": np.ones(1, np.int32),
               "overflow": np.zeros(1, np.int32)}
    for k in ("q_lo", "q_hi", "q_live"):
        payload[k][-1] = 0
    payload["csum"] = integrity.fold_host(payload, keys=integrity.BAB_FOLD_KEYS)
    assert integrity.verify_bab_segment(payload) is None
    bad = dict(payload, q_lo=payload["q_lo"].copy())
    bad["q_lo"][0, 0] += 1.0
    assert integrity.verify_bab_segment(bad) == "checksum"
    forged = {k: np.array(v) for k, v in payload.items() if k != "csum"}
    forged["q_live"][-1] = True
    forged["csum"] = integrity.fold_host(forged, keys=integrity.BAB_FOLD_KEYS)
    assert integrity.verify_bab_segment(forged) == "canary"


@pytest.mark.parametrize("kw,item", [
    # Phases S, P (K8) and E0/E (K9) are ported: with them on, the root now
    # runs through Phase E0 (and S, P, E where they are on) and must equal
    # JAX.  The ids are those these cases had when the phases raised.
    pytest.param(dict(sign_bab=True, alpha_iters=2, lattice_exhaustive=True), "K9",
                 id="kw0-K8"),
    pytest.param(dict(lp_pair=True, lattice_exhaustive=True), "K9", id="kw1-K8"),
    pytest.param(dict(lattice_exhaustive=True), "K9", id="kw2-K9"),
    # The host frontier is ported too: the root now goes through it
    # (device_bab=False; E0 off, so it reaches the BaB) and must equal JAX.
    pytest.param(dict(device_bab=False), "K10", id="kw3-K10"),
])
def test_unported_phases_raise_where_they_would_run(kw, item):
    # Span-6 seed 3 at the floor capacity leaves its root open after the
    # device BaB (frontier:overflow): every phase after it is reached.
    # With the lattice phases on, Phase E0 settles the root first, as in
    # JAX; with device_bab=False the host frontier decides it.
    ws, bs, _ = _params(3, (4, 6, 1))
    jenc, tenc, tq = _toy(6)
    lo = np.zeros((1, 4), np.int64)
    hi = np.array([[6, 6, 6, 1]], np.int64)
    # (Phase E0's per-root cap raised: a loaded CPU must not cut a scan short
    # in one package and not in the other.)
    ekw = dict(_jeng(bab_frontier_cap=4, alpha_iters=0, bab_rounds_per_segment=1,
                     lattice_first_cap_s=120.0), **kw)
    tn = tmlp.from_numpy(ws, bs, device="cpu")
    jd = jengine.decide_many(jmlp.from_numpy(ws, bs), jenc, lo, hi,
                             jengine.EngineConfig(**ekw), deadline_s=60.0)[0]
    td = tengine.decide_many(tn, tenc, lo, hi, EngineConfig(**ekw), deadline_s=60.0)[0]
    assert (td.verdict, td.reason, td.nodes, _ce(td)) == \
        (jd.verdict, jd.reason, jd.nodes, _ce(jd))
    assert td.verdict == oracle.brute_force_verdict(tn, tq, lo[0], hi[0])
    if item == "K10":
        assert td.phase == "bab" and td.stats["t_bab"] > 0.0
    else:
        assert td.phase in ("lattice_first", "lp", "sign") and td.stats["t_bab"] == 0.0
    # A root the attack settles never reaches them.
    ws, bs, _ = _params(1, (4, 8, 1))
    _, tenc, _ = _toy(2)
    decided = tengine.decide_many(
        tmlp.from_numpy(ws, bs, device="cpu"), tenc, lo * 0,
        np.array([[2, 2, 2, 1]], np.int64), EngineConfig(**dict(_jeng(pgd_phase=True), **kw)),
        deadline_s=60.0)
    assert decided[0].verdict == "sat"


def test_smt_tier_raises_when_reached(tmp_path):
    # The SMT tier (ROADMAP queue 1, item 5) is ported: the world whose
    # roots reach it now runs, and its verdict map, ledger rows, CSV rows
    # and smt_reason fields equal JAX's.  The id is the one the case had
    # when it raised.
    ov = {c: (0, 0) for c in get_domain("german").columns}
    ov.update(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2))
    kw = dict(exact_certify_masks=False, sim_size=16, grid_chunk=8, domain_overrides=ov,
              partition_threshold=2, smt_retry_timeouts_s=(1.0,))
    ekw = dict(attack_samples=4, bab_frontier_cap=64, max_nodes=1, **TAIL)
    outs = []
    for pkg in ("jax", "torch"):
        rdir = tmp_path / pkg
        if pkg == "jax":
            cfg = jpresets.get("GC").with_(result_dir=str(rdir), trace_out=str(rdir / "t.jsonl"),
                                           engine=jengine.EngineConfig(**ekw), **kw)
            rep = jsweep.verify_model(init_mlp((len(cfg.query().columns), 4, 1), seed=3), cfg,
                                      model_name="m", resume=False, partition_span=(0, 8))
        else:
            cfg = tpresets.get("GC").with_(result_dir=str(rdir), trace_out=str(rdir / "t.jsonl"),
                                           engine=EngineConfig(**ekw), **kw)
            net = tmlp.init_mlp((len(cfg.query().columns), 4, 1), seed=3, device="cpu")
            rep = tsweep.verify_model(net, cfg, model_name="m", resume=False, device="cpu",
                                      partition_span=(0, 8))
        with open(rdir / "GC-m@0-8.ledger.jsonl") as fp:
            ledger = [{k: v for k, v in json.loads(line).items()
                       if k not in ("time_s", "_crc", "engine_reason")} for line in fp]
        with open(rdir / "m@0-8.csv", newline="") as fp:
            rows = list(csv.reader(fp))
        keep = [i for i, c in enumerate(rows[0])
                if c not in ("SV-time", "S-time", "HV-Time", "H-Time", "Total-Time")]
        with open(rdir / "t.jsonl") as fp:
            events = [json.loads(line) for line in fp]
        vias = {e["attrs"]["partition_id"]: (e["attrs"]["via"], e["attrs"].get("smt_reason"))
                for e in events if e.get("type") == "event" and e.get("name") == "verdict"}
        outs.append(({o.partition_id: o.verdict for o in rep.outcomes}, ledger,
                     [[r[i] for i in keep] for r in rows], vias))
    assert outs[1] == outs[0]
    # Every root reached the tier and the tier decided it.
    assert {v for v, _r in outs[1][3].values()} == {"smt"} and len(outs[1][0]) == 8
