"""The port's SMT tier against the JAX package's, on the CPU.

* ``verify.smt``: the SMT-LIB text of ``to_smtlib`` and the query of
  ``build_query`` are the JAX package's byte for byte on three seeded nets
  (plain, dead neurons masked and excised, a relaxed-attribute query), and
  ``decide_box_smt`` without ``z3-solver`` raises as it does there.
* ``smt.brute``: verdicts and witnesses equal to the JAX package's on the
  same scripts, the pair cap included.
* ``smt.pool``: real worker subprocesses decide SAT and UNSAT, and each
  containment path (crash, hang, memout, spawn, a crash-kind fault) ends as
  in the JAX package's own pool tests.  Every wall-clock bound carries a
  margin of ``MARGIN_S`` over the pool's ``grace_s``.
* The sweep's tier: a world whose stage 0, PGD, BaB and heuristic retry are
  stubbed to decide nothing (the same stubs in both packages), so every
  root reaches the tier, through a shared pool whose pair cap concedes the
  larger boxes: verdict maps, ledger rows, CSV rows and the ``smt_reason``
  of the verdict events equal JAX's; SAT witnesses replay; with
  ``integrity_recheck=1.0`` every SMT UNSAT goes to the exact oracle; an
  ``smt_defer`` run's drain converges to the blocking run, and a resume
  replays the drained ledger.
"""
import csv
import json
import os
import time

import numpy as np
import pytest
import torch

from fairify_tpu.data.domains import DomainSpec as JDomainSpec
from fairify_tpu.data.domains import get_domain
from fairify_tpu.models import mlp as jmlp
from fairify_tpu.obs import metrics as jmetrics
from fairify_tpu.obs import trace as jtrace
from fairify_tpu.resilience import faults as jfaults
from fairify_tpu.smt import brute as jbrute
from fairify_tpu.smt import pool as jpool
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import property as jprop
from fairify_tpu.verify import smt as jsmt
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.data.domains import DomainSpec
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.obs import metrics as tmetrics
from fairify_tpu_torch.obs import trace as ttrace
from fairify_tpu_torch.resilience import faults
from fairify_tpu_torch.resilience.faults import InjectedFault
from fairify_tpu_torch.smt import brute, protocol
from fairify_tpu_torch.smt.pool import PoolConfig, SmtPool, solve_box, submit_box
from fairify_tpu_torch.verify import engine as tengine
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import property as tprop
from fairify_tpu_torch.verify import smt as tsmt
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig

# Slack of every wall-clock bound below over the pool's own grace_s: a loaded
# test worker (-n 6) must not turn a containment check into a flake.
MARGIN_S = 10.0
TIME_COLUMNS = {"SV-time", "S-time", "HV-Time", "H-Time", "Total-Time"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_state():
    for trace_mod, metrics_mod, faults_mod in ((jtrace, jmetrics, jfaults),
                                               (ttrace, tmetrics, faults)):
        trace_mod.deactivate()
        metrics_mod.registry().reset()
        faults_mod.disarm()
    yield
    for trace_mod, metrics_mod, faults_mod in ((jtrace, jmetrics, jfaults),
                                               (ttrace, tmetrics, faults)):
        trace_mod.deactivate()
        metrics_mod.registry().reset()
        faults_mod.disarm()


# ---------------------------------------------------------------------------
# The emitter and the exact backend
# ---------------------------------------------------------------------------


def _query(case):
    """Both packages' encodings of one toy query: PA ``pa``; the relaxed
    case also relaxes ``r`` by eps = 1."""
    ranges = {"a": (0, 2), "pa": (0, 1), "b": (-1, 1), "r": (0, 3)}
    relaxed = dict(relaxed=("r",), relax_eps=1) if case == "relaxed" else {}
    jq = jprop.FairnessQuery(domain=JDomainSpec(name="toy", columns=tuple(ranges),
                                                ranges=ranges, label="y"),
                             protected=("pa",), **relaxed)
    tq = tprop.FairnessQuery(domain=DomainSpec(name="toy", columns=tuple(ranges),
                                               ranges=ranges, label="y"),
                             protected=("pa",), **relaxed)
    lo, hi = tq.domain.lo_hi()
    return jprop.encode(jq), tprop.encode(tq), lo.astype(np.int64), hi.astype(np.int64)


def _nets(case, seed):
    """The same seeded 4-6-5-1 net in both packages; the masked case kills
    hidden neurons 1 and 4 of the first layer and 2 of the second."""
    rng = np.random.default_rng(seed)
    sizes = (4, 6, 5, 1)
    ws = [rng.normal(scale=0.7, size=(sizes[i], sizes[i + 1])).astype(np.float32)
          for i in range(3)]
    bs = [rng.normal(scale=0.3, size=(sizes[i + 1],)).astype(np.float32) for i in range(3)]
    ms = [np.ones(s, np.float32) for s in sizes[1:]]
    if case == "masked":
        ms[0][[1, 4]] = 0.0
        ms[1][2] = 0.0
    return jmlp.from_numpy(ws, bs, ms), tmlp.from_numpy(ws, bs, ms, device="cpu")


CASES = [("plain", 0), ("masked", 1), ("relaxed", 2)]


@pytest.mark.parametrize("case,seed", CASES, ids=[c for c, _ in CASES])
def test_smtlib_text_equals_jax(case, seed):
    jnet, tnet = _nets(case, seed)
    jenc, tenc, lo, hi = _query(case)
    small = tmlp.excise(tnet)
    assert small.layer_sizes == jmlp.excise(jnet).layer_sizes
    if case == "masked":
        assert small.layer_sizes == (4, 4, 1)
    for kw in (dict(name="p7"), dict(name="box", get_model=True)):
        text = tsmt.to_smtlib(tnet, tenc, lo, hi, **kw)
        assert text == jsmt.to_smtlib(jnet, jenc, lo, hi, **kw)
        assert text.encode() == jsmt.to_smtlib(jnet, jenc, lo, hi, **kw).encode()
    assert tsmt.build_query(tnet, tenc, lo, hi, name="p3") == \
        jsmt.build_query(jnet, jenc, lo, hi, name="p3")
    # A weight enters as the exact rational of its f32 value.
    w = float(np.asarray(tnet.weights[0][0, 0]))
    assert tsmt._rat(w) in tsmt.to_smtlib(tnet, tenc, lo, hi)
    assert tsmt._rat(0.1) == jsmt._rat(0.1) == "(/ 3602879701896397 36028797018963968)"
    assert tsmt._unknown_reason("max. memory exceeded") == "memout"
    with pytest.raises(RuntimeError, match="z3-solver is not installed"):
        tsmt.decide_box_smt(tnet, tenc, lo, hi)


@pytest.mark.parametrize("case,seed", CASES + [("capped", 3)],
                         ids=[c for c, _ in CASES] + ["capped"])
def test_brute_solve_equals_jax(case, seed):
    jnet, tnet = _nets("plain" if case == "capped" else case, seed)
    jenc, tenc, lo, hi = _query("plain" if case == "capped" else case)
    cap = 50 if case == "capped" else brute.DEFAULT_PAIR_CAP
    got_all = []
    for bias in (-2.0, 0.0, 2.0):  # shift the output bias: sat and unsat boxes
        tq = tsmt.build_query(tmlp.from_numpy(
            [w.numpy() for w in tnet.weights],
            [b.numpy() for b in tnet.biases[:-1]] + [tnet.biases[-1].numpy() + bias],
            [m.numpy() for m in tnet.masks], device="cpu"), tenc, lo, hi)
        jq = jsmt.build_query(jmlp.from_numpy(
            [np.asarray(w) for w in jnet.weights],
            [np.asarray(b) for b in jnet.biases[:-1]]
            + [np.asarray(jnet.biases[-1]) + np.float32(bias)],
            [np.asarray(m) for m in jnet.masks]), jenc, lo, hi)
        assert tq == jq
        got = brute.solve(tq["smtlib"], tq["meta"], timeout_s=60.0, pair_cap=cap)
        assert got == jbrute.solve(jq["smtlib"], jq["meta"], timeout_s=60.0, pair_cap=cap)
        if got[0] == "sat":
            w, b = tnet.numpy_params()
            b[-1] = b[-1] + np.float32(bias)
            assert tengine.validate_pair(w, b, *(np.asarray(c, np.int64) for c in got[1]))
        got_all.append(got[0])
    if case == "capped":
        assert got_all == ["unknown"] * 3
        assert brute.solve(tq["smtlib"], tq["meta"], pair_cap=cap)[2] == "solver-error"
    else:
        assert "unknown" not in got_all
    assert brute.parse_script("(assert (> x0 1)) ; c\n(check-sat)") == \
        jbrute.parse_script("(assert (> x0 1)) ; c\n(check-sat)")


# ---------------------------------------------------------------------------
# The pool: real worker subprocesses
# ---------------------------------------------------------------------------


def _setup():
    ranges = {"a": (0, 3), "pa": (0, 1)}
    q = tprop.FairnessQuery(domain=DomainSpec(name="toy", columns=tuple(ranges),
                                              ranges=ranges, label="y"), protected=("pa",))
    lo, hi = q.domain.lo_hi()
    return tprop.encode(q), lo.astype(np.int64), hi.astype(np.int64)


def _flip_net():
    return tmlp.from_numpy([np.array([[0.0], [2.0]], np.float32), np.array([[1.0]], np.float32)],
                           [np.array([0.0], np.float32), np.array([-1.0], np.float32)],
                           device="cpu")


def _const_net():
    return tmlp.from_numpy([np.zeros((2, 1), np.float32)], [np.array([1.0], np.float32)],
                           device="cpu")


def _pool(**kw):
    kw.setdefault("workers", 1)
    kw.setdefault("backend", "brute")
    kw.setdefault("grace_s", 0.5)
    kw.setdefault("backoff_s", 1e-3)
    return SmtPool(PoolConfig(**kw))


@pytest.mark.parametrize("net,want", [(_flip_net, "sat"), (_const_net, "unsat")],
                         ids=["flip-sat", "const-unsat"])
def test_pool_decides_sat_and_unsat(net, want):
    enc, lo, hi = _setup()
    with _pool(workers=2) as pool:
        futs = [submit_box(pool, net(), enc, lo, hi, soft_timeout_s=10.0) for _ in range(4)]
        res = [f.result(timeout=10.0 + MARGIN_S) for f in futs]
        v, ce, reason = solve_box(pool, net(), enc, lo, hi, soft_timeout_s=10.0)
        assert pool.stats()["workers"] <= 2
    assert {r.verdict for r in res} == {v} == {want} and reason is None
    if want == "sat":
        w, b = net().numpy_params()
        assert tengine.validate_pair(w, b, *ce) and all(r.ce is not None for r in res)
    assert tmetrics.registry().counter("smt_queries").value(verdict=want) == 5
    reg = tmetrics.registry()
    assert reg.gauge("smt_pool_queue_depth").value() == 0
    assert reg.gauge("smt_pool_active").value() == 0
    assert reg.gauge("smt_pool_workers").value() == 0  # a closed pool reads 0


def test_pool_worker_is_a_fresh_interpreter_without_torch():
    """A worker imports no torch and maps no CUDA library: it lives under its
    RLIMIT_AS cap."""
    enc, lo, hi = _setup()
    with _pool(memory_cap_mb=256) as pool:
        assert solve_box(pool, _flip_net(), enc, lo, hi, soft_timeout_s=10.0)[0] == "sat"
        (proc,) = pool.live_workers()
        with open(f"/proc/{proc.pid}/maps") as fp:
            maps = fp.read()
        with open(f"/proc/{proc.pid}/cmdline") as fp:
            cmd = fp.read().split("\0")
    assert "libtorch" not in maps and "libcuda" not in maps
    assert cmd[1:3] == ["-m", "fairify_tpu_torch.smt.worker"]


def test_crash_transient_absorbed_fatal_degrades():
    enc, lo, hi = _setup()
    with _pool(max_retries=2) as pool:
        with faults.armed(["smt.worker.crash:transient:1"]):
            assert solve_box(pool, _flip_net(), enc, lo, hi, soft_timeout_s=10.0)[::2] == \
                ("sat", None)
        with faults.armed(["smt.worker.crash:fatal:1"]):
            assert solve_box(pool, _flip_net(), enc, lo, hi, soft_timeout_s=10.0)[::2] == \
                ("unknown", protocol.REASON_CRASH)
        with faults.armed(["smt.worker.crash:transient:1+"]):
            assert solve_box(pool, _flip_net(), enc, lo, hi, soft_timeout_s=10.0)[::2] == \
                ("unknown", protocol.REASON_CRASH)
    assert tmetrics.registry().counter("smt_worker_crashes").value(kind="crash") >= 4


def test_hang_is_killed_within_grace_of_deadline():
    enc, lo, hi = _setup()
    soft, grace, retries = 0.3, 0.5, 1
    with _pool(grace_s=grace, max_retries=retries) as pool:
        with faults.armed(["smt.worker.hang:transient:1+"]):
            t0 = time.monotonic()
            got = solve_box(pool, _flip_net(), enc, lo, hi, soft_timeout_s=soft)
            elapsed = time.monotonic() - t0
    assert got == ("unknown", None, protocol.REASON_HANG)
    # (retries + 1) attempts, each bounded by soft + grace.
    assert (retries + 1) * soft < elapsed < (retries + 1) * (soft + grace) + grace + MARGIN_S
    assert tmetrics.registry().counter("smt_worker_crashes").value(kind="hang") == retries + 1


def test_memout_retries_once_on_doubled_cap_then_degrades():
    enc, lo, hi = _setup()
    with _pool(memory_cap_mb=192) as pool:
        with faults.armed(["smt.worker.memout:transient:1"]):
            assert solve_box(pool, _flip_net(), enc, lo, hi, soft_timeout_s=10.0)[::2] == \
                ("sat", None)
        with faults.armed(["smt.worker.memout:transient:1+"]):
            assert solve_box(pool, _flip_net(), enc, lo, hi, soft_timeout_s=10.0,
                             retry_timeouts_s=(10.0, 10.0))[::2] == \
                ("unknown", protocol.REASON_MEMOUT)
    assert tmetrics.registry().counter("smt_memouts").total() >= 3


def test_spawn_fault_degrades_query_not_run():
    enc, lo, hi = _setup()
    with _pool() as pool:
        with faults.armed(["smt.worker.spawn:fatal:1"]):
            assert solve_box(pool, _flip_net(), enc, lo, hi, soft_timeout_s=10.0)[::2] == \
                ("unknown", protocol.REASON_SPAWN)
        assert solve_box(pool, _flip_net(), enc, lo, hi, soft_timeout_s=10.0)[::2] == \
            ("sat", None)


def test_crash_kind_fault_propagates():
    enc, lo, hi = _setup()
    with _pool() as pool:
        with faults.armed(["smt.worker.crash:crash:1"]):
            with pytest.raises(InjectedFault):
                pool._dispatch(tsmt.build_query(_flip_net(), enc, lo, hi), 5.0, seed=0)
        # The pool survives the host-side fault.
        assert solve_box(pool, _const_net(), enc, lo, hi, soft_timeout_s=10.0)[0] == "unsat"


# ---------------------------------------------------------------------------
# The sweep's tier, both packages on one world
# ---------------------------------------------------------------------------

SPAN = (0, 12)
PAIR_CAP = 8  # the world's boxes hold 8 or 16 pairs: the 16-pair ones concede


def _cfgs(tmp_path, tag, **kw):
    ov = {c: (0, 0) for c in get_domain("german").columns}
    ov.update(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2))
    base = dict(soft_timeout_s=10.0, hard_timeout_s=600.0, sim_size=16,
                exact_certify_masks=False, grid_chunk=8, launch_backoff_s=1e-4,
                domain_overrides=ov, partition_threshold=2, smt_retry_timeouts_s=(10.0,),
                smt_workers=2)
    base.update(kw)
    jcfg = jpresets.get("GC").with_(result_dir=str(tmp_path / f"jax-{tag}"),
                                    trace_out=str(tmp_path / f"jax-{tag}" / "t.jsonl"),
                                    engine=jengine.EngineConfig(max_nodes=1), **base)
    tcfg = tpresets.get("GC").with_(result_dir=str(tmp_path / f"torch-{tag}"),
                                    trace_out=str(tmp_path / f"torch-{tag}" / "t.jsonl"),
                                    engine=EngineConfig(max_nodes=1), **base)
    return jcfg, tcfg


def _dull(monkeypatch):
    """Stage 0, the PGD pass, the BaB and the heuristic retry decide nothing,
    in both packages: every root reaches the SMT tier."""
    def nothing(net, enc, lo, hi, cfg, *a, **kw):
        return np.zeros(lo.shape[0], bool), np.zeros(lo.shape[0], bool), {}

    monkeypatch.setattr(jsweep, "_stage0_certify_and_attack", nothing)
    monkeypatch.setattr(tsweep, "stage0_certify_and_attack", nothing)
    monkeypatch.setattr(jengine, "pgd_attack_decode",
                        lambda host, ctx, return_points=False: (
                            {}, None, np.full(ctx["B"], np.inf)))
    monkeypatch.setattr(tsweep, "stage0_pgd", lambda *a, **kw: ({}, True))
    for eng in (jengine, tengine):
        monkeypatch.setattr(eng, "decide_many", lambda net, enc, lo, hi, cfg, eng=eng, **kw: [
            eng.Decision("unknown", reason="deadline") for _ in range(lo.shape[0])])
        monkeypatch.setattr(eng, "decide_box",
                            lambda *a, eng=eng, **kw: eng.Decision("unknown"))


def _net():
    """A seeded 20-4-1 net whose first 12 boxes the tier splits 3 sat, 3
    unsat and 6 conceded."""
    rng = np.random.default_rng(2)
    ws = [rng.normal(scale=0.5, size=s).astype(np.float32) for s in ((20, 4), (4, 1))]
    bs = [rng.normal(scale=0.5, size=s).astype(np.float32) for s in ((4,), (1,))]
    return jmlp.from_numpy(ws, bs), tmlp.from_numpy(ws, bs, device="cpu")


def _outputs(cfg, rep, sink="m@0-12"):
    with open(os.path.join(cfg.result_dir, f"GC-{sink}.ledger.jsonl")) as fp:
        ledger = [{k: v for k, v in json.loads(line).items()
                   if k not in ("time_s", "_crc", "engine_reason")} for line in fp]
    with open(os.path.join(cfg.result_dir, f"{sink}.csv"), newline="") as fp:
        rows = list(csv.reader(fp))
    keep = [i for i, name in enumerate(rows[0]) if name not in TIME_COLUMNS]
    with open(cfg.trace_out) as fp:
        events = [json.loads(line) for line in fp]
    reasons = {e["attrs"]["partition_id"]: (e["attrs"]["via"], e["attrs"].get("smt_reason"),
                                            e["attrs"].get("failure"))
               for e in events if e.get("type") == "event" and e.get("name") == "verdict"}
    return {"map": {o.partition_id: o.verdict for o in rep.outcomes}, "ledger": ledger,
            "csv": [[r[i] for i in keep] for r in rows], "reasons": reasons}


@pytest.mark.parametrize("fault,failure", [
    (None, None),
    # The seventh answer (a SAT) has a bit flipped crossing the pool
    # boundary: its host replay fails, the root degrades.  (A flipped low
    # mantissa bit of another SAT's witness still replays: not a fault.)
    ("smt.query:corrupt:7", "integrity.smt.query:fatal"),
    # The first dispatch's worker dies and the fault is fatal: that root
    # degrades as a worker death (one worker a pool: the same root in both).
    ("smt.worker.crash:fatal:1", "smt.worker:crash"),
], ids=["clean", "corrupt-witness", "worker-fatal"])
def test_sweep_tier_equals_jax(tmp_path, monkeypatch, fault, failure):
    _dull(monkeypatch)
    jnet, tnet = _net()
    kw = dict(integrity_recheck=1.0) if fault is None else dict(inject_faults=(fault,))
    jcfg, tcfg = _cfgs(tmp_path, "block", **kw)
    workers = 2 if fault is None else 1
    with jpool.SmtPool(jpool.PoolConfig(workers=workers, pair_cap=PAIR_CAP)) as jp, \
            SmtPool(PoolConfig(workers=workers, pair_cap=PAIR_CAP)) as tp:
        jrep = jsweep.verify_model(jnet, jcfg, model_name="m", resume=False,
                                   partition_span=SPAN, smt_pool=jp)
        trep = tsweep.verify_model(tnet, tcfg, model_name="m", resume=False,
                                   partition_span=SPAN, smt_pool=tp, device="cpu")
    got, want = _outputs(tcfg, trep), _outputs(jcfg, jrep)
    assert got == want
    assert trep.degraded == jrep.degraded
    if fault is not None:
        assert [f for _v, _r, f in got["reasons"].values() if f] == [failure]
        assert trep.degraded == 1
        return
    vias = [v for v, _r, _f in got["reasons"].values()]
    # Every root went to the tier: the small boxes decided (both verdicts),
    # the 16-pair ones conceded past the pair cap.
    assert {v for v in got["map"].values()} == {"sat", "unsat", "unknown"}
    assert vias.count("smt") == sum(v != "unknown" for v in got["map"].values())
    assert {r for v, r, _f in got["reasons"].values() if v == "bab"} == {"solver-error"}
    w, b = tnet.numpy_params()
    sats = [o for o in trep.outcomes if o.verdict == "sat"]
    assert sats and all(tengine.validate_pair(w, b, *o.counterexample) for o in sats)
    # integrity_recheck=1.0: every SMT UNSAT went to the exact oracle, and
    # none was refuted.
    n_unsat = sum(v == "unsat" for v in got["map"].values())
    assert tmetrics.registry().counter("integrity_rechecks").value(kind="smt") == n_unsat
    assert tmetrics.registry().counter("integrity_violations").total() == 0
    assert tmetrics.registry().counter("smt_queries").total() == len(got["map"])


def test_sweep_deferred_drain_converges(tmp_path, monkeypatch):
    _dull(monkeypatch)
    _jnet, tnet = _net()
    _jcfg, tblock = _cfgs(tmp_path, "block")
    # The deferred run's first dispatch hangs past its first tier (1 s + the
    # pool's grace): its root is still solving when the loop reaches it.
    _jcfg, tdefer = _cfgs(tmp_path, "defer", soft_timeout_s=1.0,
                          inject_faults=("smt.worker.hang:transient:1",))
    with SmtPool(PoolConfig(workers=2, pair_cap=PAIR_CAP)) as pool:
        blocking = tsweep.verify_model(tnet, tblock, model_name="m", resume=False,
                                       partition_span=SPAN, smt_pool=pool, device="cpu")
        rep = tsweep.verify_model(tnet, tdefer, model_name="m", resume=False,
                                  partition_span=SPAN, smt_pool=pool, smt_defer=True,
                                  device="cpu")
        pending = rep.smt_pending.pending
        stats = rep.smt_pending.drain()
        assert 1 <= pending and stats["decided"] <= pending and rep.smt_pending.pending == 0
        want = {o.partition_id: o.verdict for o in blocking.outcomes}
        assert {o.partition_id: o.verdict for o in rep.outcomes} == want
        # The drained ledger is the record of truth: a resume replays it.
        resumed = tsweep.verify_model(tnet, tdefer.with_(trace_out=None), model_name="m",
                                      resume=True, partition_span=SPAN, device="cpu")
    assert {o.partition_id: o.verdict for o in resumed.outcomes} == want
    assert tmetrics.registry().counter("smt_queries").total() == 2 * len(want)
    assert tmetrics.registry().counter("smt_worker_crashes").value(kind="hang") == 1
