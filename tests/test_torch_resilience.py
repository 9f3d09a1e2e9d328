"""The port's runtime contracts against the JAX package's: fault injection,
launch supervision, graceful degradation and resume.

* Unit cases of ``tests/test_resilience.py`` run against the port's
  modules: the spec grammar, exact and probabilistic arrivals (equal to the
  JAX package's plan, draw for draw), the classification table with the
  port's CUDA rows, retries, exhaustion, the deadline, ``on_retry``, the
  journal, and the launch pipeline's FIFO order under a degraded dispatch.
* A schedule matrix through both packages' ``verify_model`` on one world
  whose partitions reach every pipelined phase (stage 0, parity,
  ``stage0_pgd``, the device BaB): equal verdict maps, failure records,
  degraded counts and counter totals, and a resume that converges to the
  fault-free map in both packages.
* The ``compile`` site on the port's ``nvcc`` build: retried, then fatal to
  the run; no arrivals on the CPU, where nothing is built.
"""
import json
import os

import numpy as np
import pytest
import torch

from fairify_tpu.data.domains import get_domain
from fairify_tpu.models.train import init_mlp
from fairify_tpu.obs import metrics as jmetrics
from fairify_tpu.obs import trace as jtrace
from fairify_tpu.resilience import faults as jfaults
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.obs import metrics as tmetrics
from fairify_tpu_torch.obs import trace as ttrace
from fairify_tpu_torch.parallel.pipeline import LaunchPipeline
from fairify_tpu_torch.resilience import faults
from fairify_tpu_torch.resilience.journal import JournalWriter
from fairify_tpu_torch.resilience.supervisor import (ChunkDegraded, ChunkFailure,
                                                     CudaLaunchError, Supervisor,
                                                     classify)
from fairify_tpu_torch.utils import cuda_build
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The worlds here are tiny: torch's intra-op threads only contend with
    each other and with the other test workers.  One thread for this
    module, the count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_state():
    """Quiescent registries, no tracer, no armed fault plan, per test."""
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


def _fast_sup(**kw):
    kw.setdefault("backoff_s", 1e-4)
    return Supervisor(**kw)


# ---------------------------------------------------------------------------
# faults: spec grammar and arrivals, equal to the JAX package's
# ---------------------------------------------------------------------------


def test_parse_spec_forms():
    s = faults.parse_spec("launch.submit:transient:3")
    assert (s.site, s.kind, s.start, s.every) == ("launch.submit", "transient", 3, False)
    s = faults.parse_spec("launch.decode:fatal:2+")
    assert s.every and s.start == 2
    s = faults.parse_spec("compile:crash:2-4")
    assert (s.start, s.stop) == (2, 4)
    s = faults.parse_spec("smt.query:transient:p0.25")
    assert s.rate == pytest.approx(0.25)
    assert faults.FAULT_SITES == jfaults.FAULT_SITES
    assert faults.FAULT_KINDS == jfaults.FAULT_KINDS


@pytest.mark.parametrize("bad", [
    "nope:transient:1",
    "launch.submit:flaky:1",
    "launch.submit:transient:x",
    "launch.submit",
    "launch.submit:transient:0",
    "launch.submit:transient:3-5+",
    "compile:corrupt:1",  # corrupt only at data-plane sites
])
def test_parse_spec_rejects(bad):
    with pytest.raises(ValueError):
        faults.parse_spec(bad)
    with pytest.raises(ValueError):
        jfaults.parse_spec(bad)


def _fired(plan_cls, specs, seed, site, n, corrupt=False):
    plan = plan_cls(specs, seed=seed)
    out = []
    for _ in range(n):
        if corrupt:
            out.append(plan.corruption(site))
            continue
        try:
            plan.check(site)
            out.append(None)
        except (faults.InjectedFault, jfaults.InjectedFault) as exc:
            out.append(exc.kind)
    return out


@pytest.mark.parametrize("specs,site,corrupt", [
    (["ledger.append:transient:2", "ledger.append:fatal:4+"], "ledger.append", False),
    (["launch.decode:transient:2-3", "launch.decode:crash:5"], "launch.decode", False),
    (["launch.decode:transient:p0.25"], "launch.decode", False),
    (["launch.decode:corrupt:p0.5", "launch.decode:transient:1+"], "launch.decode", True),
])
def test_plan_arrivals_equal_jax(specs, site, corrupt):
    for seed in (0, 7):
        got = _fired(faults.FaultPlan, specs, seed, site, 40, corrupt)
        assert got == _fired(jfaults.FaultPlan, specs, seed, site, 40, corrupt)
    if specs == ["ledger.append:transient:2", "ledger.append:fatal:4+"]:
        assert got[:6] == [None, "transient", None, "fatal", "fatal", "fatal"]


def test_armed_scope_stacks_and_counts():
    with faults.armed(["compile:transient:1"]):
        with pytest.raises(faults.InjectedFault):
            faults.check("compile")
        assert tmetrics.registry().counter("fault_injected").value(
            site="compile", kind="transient") == 1
        with faults.armed(["compile:fatal:1"]):  # inner schedule wins
            with pytest.raises(faults.InjectedFault) as ei:
                faults.check("compile")
            assert ei.value.kind == "fatal"
        faults.check("compile")  # outer plan restored; arrival 2 is clean
    faults.check("compile")  # disarmed: never raises


# ---------------------------------------------------------------------------
# supervisor: the classification table, retries, exhaustion, deadline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exc,want", [
    (faults.InjectedFault("x", "transient", 1), "transient"),
    (faults.InjectedFault("x", "fatal", 1), "fatal"),
    (faults.InjectedFault("x", "crash", 1), "propagate"),
    (OSError("disk"), "transient"),
    (TimeoutError(), "transient"),
    (KeyboardInterrupt(), "propagate"),
    (MemoryError(), "propagate"),
    (ValueError("shape"), "fatal"),
    (torch.OutOfMemoryError("CUDA out of memory"), "propagate"),
    (CudaLaunchError("kc_attack_flips", 700), "propagate"),  # illegal address
    (CudaLaunchError("k6_bab_segment", 719), "propagate"),   # launch failure
    (CudaLaunchError("kb_stage0_certify", 2), "propagate"),  # out of memory
    (CudaLaunchError("kb_stage0_certify", 9), "fatal"),      # invalid configuration
    (CudaLaunchError("k5_pgd_attack", 720), "fatal"),        # cooperative too large
    (cuda_build.KernelBuildError("nvcc failed"), "propagate"),
    (ChunkDegraded(ChunkFailure("s", "fatal", "E", "")), "fatal"),
], ids=lambda v: v if isinstance(v, str) else f"{type(v).__name__}"
                                               f"{getattr(v, 'code', '')}")
def test_classify_table(exc, want):
    assert classify(exc) == want


def test_injected_faults_classified_as_jax():
    from fairify_tpu.resilience.supervisor import classify as jclassify

    for kind in ("transient", "fatal", "crash"):
        assert (classify(faults.InjectedFault("x", kind, 1))
                == jclassify(jfaults.InjectedFault("x", kind, 1)))


def test_cuda_build_check_raises_launch_error():
    cuda_build.check("k", 0)
    with pytest.raises(CudaLaunchError) as ei:
        cuda_build.check("kc_attack_flips", 700)
    assert ei.value.code == 700 and ei.value.sticky and "CUDA error 700" in str(ei.value)


def test_supervisor_retries_transient_then_succeeds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert _fast_sup(max_retries=2).run(flaky, site="launch.submit") == "ok"
    assert calls["n"] == 3
    assert tmetrics.registry().counter("launch_retries").value(site="launch.submit") == 2


def test_supervisor_exhaustion_carries_failure_record():
    def always():
        raise OSError("still down")

    with pytest.raises(ChunkDegraded) as ei:
        _fast_sup(max_retries=2).run(always, site="launch.decode")
    f = ei.value.failure
    assert (f.site, f.kind, f.error, f.retries) == \
        ("launch.decode", "transient-exhausted", "OSError", 2)
    rec = f.to_record()
    assert rec["reason"] == "launch.decode:transient-exhausted"
    assert "still down" in rec["detail"]


@pytest.mark.parametrize("exc", [ValueError("shape mismatch"),
                                 CudaLaunchError("kb_stage0_certify", 9)])
def test_supervisor_fatal_never_retries(exc):
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise exc

    with pytest.raises(ChunkDegraded) as ei:
        _fast_sup(max_retries=5).run(bad, site="launch.submit")
    assert calls["n"] == 1 and ei.value.failure.kind == "fatal"


@pytest.mark.parametrize("exc", [KeyboardInterrupt(), CudaLaunchError("k", 700),
                                 torch.OutOfMemoryError("oom")])
def test_supervisor_propagates(exc):
    calls = {"n": 0}

    def boom():
        calls["n"] += 1
        raise exc

    with pytest.raises(type(exc)):
        _fast_sup(max_retries=5).run(boom, site="launch.submit")
    assert calls["n"] == 1


def test_supervisor_deadline_stops_retries():
    calls = {"n": 0}

    def failing():
        calls["n"] += 1
        import time as _t

        _t.sleep(0.005)
        raise OSError("x")

    sup = Supervisor(max_retries=100, backoff_s=0.0, deadline_s=0.01, sleep=lambda s: None)
    with pytest.raises(ChunkDegraded) as ei:
        sup.run(failing, site="launch.submit")
    assert ei.value.failure.kind == "deadline"
    assert calls["n"] < 100


def test_supervisor_on_retry_refreshes_state():
    seen = []
    state = {"v": "poisoned"}

    def fetch():
        seen.append(state["v"])
        if state["v"] == "poisoned":
            raise OSError("bad payload")
        return state["v"]

    out = _fast_sup(max_retries=2).run(fetch, site="launch.decode",
                                       on_retry=lambda: state.__setitem__("v", "fresh"))
    assert out == "fresh" and seen == ["poisoned", "fresh"]


def test_supervisor_jitter_is_seeded_like_jax():
    from fairify_tpu.resilience.supervisor import Supervisor as JSupervisor

    got = [Supervisor(seed=5)._backoff(a) for a in range(4)]
    assert got == [JSupervisor(seed=5)._backoff(a) for a in range(4)]


# ---------------------------------------------------------------------------
# journal: atomic append, fault site, best-effort exhaustion, CRC
# ---------------------------------------------------------------------------


def test_journal_appends_valid_jsonl(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with JournalWriter(path) as jw:
        assert jw.append({"a": 1})
        assert jw.append({"b": [1, 2]})
    with open(path) as fp:
        recs = [json.loads(line) for line in fp]
    assert recs == [{"a": 1}, {"b": [1, 2]}]


def test_journal_transient_fault_retried(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with faults.armed(["ledger.append:transient:1"]):
        jw = JournalWriter(path, fault_site="ledger.append",
                           supervisor=_fast_sup(max_retries=2))
        assert jw.append({"pid": 1})
        jw.close()
    with open(path) as fp:
        assert json.loads(fp.read()) == {"pid": 1}


def test_journal_exhaustion_is_best_effort(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with faults.armed(["ledger.append:transient:1+"]):
        jw = JournalWriter(path, fault_site="ledger.append",
                           supervisor=_fast_sup(max_retries=1))
        assert jw.append({"pid": 1}) is False  # recorded, not raised
        jw.close()
    assert os.path.getsize(path) == 0
    assert tmetrics.registry().counter("ledger_append_failures").total() == 1


def test_journal_corrupt_row_fails_its_crc(tmp_path):
    from fairify_tpu_torch.resilience import integrity

    path = str(tmp_path / "j.jsonl")
    with faults.armed(["ledger.append:corrupt:2"]):
        with JournalWriter(path, fault_site="ledger.append", crc=True) as jw:
            for pid, v in ((1, "unsat"), (2, "sat"), (3, "unknown")):
                jw.append({"partition_id": pid, "verdict": v})
    with open(path) as fp:
        recs = [json.loads(line) for line in fp]
    good, bad = integrity.verify_records(recs)
    assert bad == 1 and [r["partition_id"] for r in good] == [1, 3]
    assert recs[1]["verdict"] == "unsat"  # flipped after the CRC was sealed


# ---------------------------------------------------------------------------
# pipeline: fault sites + ChunkFailure FIFO slotting
# ---------------------------------------------------------------------------


def test_pipeline_degraded_dispatch_keeps_fifo_order():
    with faults.armed(["launch.submit:fatal:2"]):
        pipe = LaunchPipeline(depth=2, supervisor=_fast_sup(max_retries=1))
        out = []
        for i in range(3):
            for meta, _ctx, host in pipe.submit(
                    lambda i=i: ({"v": torch.tensor([i])}, None), meta=i):
                out.append((meta, host))
        for meta, _ctx, host in pipe.drain():
            out.append((meta, host))
    assert [m for m, _ in out] == [0, 1, 2]
    assert isinstance(out[1][1], ChunkFailure)
    assert int(out[0][1]["v"][0]) == 0 and int(out[2][1]["v"][0]) == 2
    assert isinstance(out[2][1]["v"], np.ndarray)


def test_pipeline_decode_retry_redispatches():
    dispatches = {"n": 0}

    def launch():
        dispatches["n"] += 1
        return {"v": torch.tensor([7])}, "ctx"

    with faults.armed(["launch.decode:transient:1"]):
        pipe = LaunchPipeline(depth=1, supervisor=_fast_sup(max_retries=2))
        pipe.submit(launch, meta=0)
        (meta, ctx, host), = list(pipe.drain())
    assert int(host["v"][0]) == 7 and ctx == "ctx"
    assert dispatches["n"] == 2  # original + one re-dispatch on retry


def test_pipeline_corrupt_flips_dict_payloads_only():
    with faults.armed(["launch.decode:corrupt:1+"]):
        pipe = LaunchPipeline(depth=1, supervisor=_fast_sup())
        pipe.submit(lambda: (torch.zeros(4, dtype=torch.int32), None))
        ((_, _, arr),) = list(pipe.drain())
        pipe.submit(lambda: ({"a": torch.zeros(4, dtype=torch.int32)}, None))
        ((_, _, dct),) = list(pipe.drain())
    assert not arr.any() and dct["a"].any()
    assert tmetrics.registry().counter("fault_injected").value(
        site="launch.decode", kind="corrupt") == 1


# ---------------------------------------------------------------------------
# The compile site: the nvcc build, retried, then fatal to the run
# ---------------------------------------------------------------------------


def _fake_build(monkeypatch):
    def compile_once(nvcc, tag):
        faults.check("compile")
        return [], {}

    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "build_info", {})
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "_compile", compile_once)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(cuda_build.os, "makedirs", lambda *a, **k: None)


def test_compile_site_retries_a_transient_build_fault(monkeypatch):
    _fake_build(monkeypatch)
    with faults.armed(["compile:transient:1"]):
        info = cuda_build.build_all(_fast_sup(max_retries=2))
    assert info["compiled"] == []
    assert tmetrics.registry().counter("launch_retries").value(site="compile") == 1


def test_compile_site_exhaustion_fails_the_build(monkeypatch):
    _fake_build(monkeypatch)
    with faults.armed(["compile:transient:1+"]):
        with pytest.raises(cuda_build.KernelBuildError) as ei:
            cuda_build.build_all(_fast_sup(max_retries=1))
    assert classify(ei.value) == "propagate" and not cuda_build._libs


# ---------------------------------------------------------------------------
# The schedule matrix through both packages' verify_model
# ---------------------------------------------------------------------------

_OV = {c: (0, 0) for c in get_domain("german").columns}
_OV.update(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2))
# bench.py's ladder world: every partition reaches stage0_pgd and the device
# BaB, in two grid chunks of one mega segment.
_ENGINE = dict(lattice_exhaustive=False, pgd_phase=False, attack_samples=4,
               bab_attack_samples=4, bab_frontier_cap=64, bab_rounds_per_segment=8)
_SWEEP = dict(soft_timeout_s=20.0, hard_timeout_s=120.0, sim_size=16,
              exact_certify_masks=False, grid_chunk=4, domain_overrides=_OV,
              partition_threshold=2, launch_backoff_s=1e-4)
SPAN = (0, 8)
NAMES = ("fault_injected", "launch_retries", "chunks_degraded", "integrity_violations")


def _jnet():
    return init_mlp((20, 4, 1), seed=3)


def _tnet():
    net = _jnet()
    return tmlp.from_numpy([np.asarray(w) for w in net.weights],
                           [np.asarray(b) for b in net.biases], device="cpu")


def world(pkg, result_dir, specs=(), resume=False, **kw):
    """One ``verify_model`` of the ladder world in ``pkg`` ("jax" or
    "torch"): (verdict map, failure records, degraded, counter totals,
    config).  Counters accumulate over a run and its resume."""
    if pkg == "jax":
        cfg = jpresets.get("GC").with_(result_dir=str(result_dir), inject_faults=specs,
                                       engine=jengine.EngineConfig(**_ENGINE),
                                       **dict(_SWEEP, **kw))
        rep = jsweep.verify_model(_jnet(), cfg, model_name="m", resume=resume,
                                  partition_span=SPAN)
        reg = jmetrics.registry()
    else:
        cfg = tpresets.get("GC").with_(result_dir=str(result_dir), inject_faults=specs,
                                       engine=EngineConfig(**_ENGINE), **dict(_SWEEP, **kw))
        rep = tsweep.verify_model(_tnet(), cfg, model_name="m", resume=resume,
                                  device="cpu", partition_span=SPAN)
        reg = tmetrics.registry()
    path = os.path.join(cfg.result_dir, f"GC-m@{SPAN[0]}-{SPAN[1]}.ledger.jsonl")
    with open(path) as fp:
        led = [json.loads(line) for line in fp if line.strip()]
    fails = sorted((r["partition_id"], tuple(r["failure"][k] for k in
                                             ("reason", "site", "kind", "retries")))
                   for r in led if r.get("failure"))
    return ({o.partition_id: o.verdict for o in rep.outcomes}, fails, rep.degraded,
            {n: reg.counter(n).total() for n in NAMES})


@pytest.fixture(scope="module")
def fault_free(tmp_path_factory):
    jmetrics.registry().reset()
    tmetrics.registry().reset()
    td = tmp_path_factory.mktemp("fault_free")
    want = world("jax", td / "j")[0]
    assert world("torch", td / "t")[0] == want
    assert set(want.values()) == {"unsat"}  # every partition decided, past stage 0
    return want


@pytest.mark.parametrize("spec", [
    "launch.submit:transient:2",
    "launch.decode:transient:1+",
    "launch.submit:fatal:2",
    "launch.submit:fatal:4",
    "launch.decode:transient:3+",
    "launch.decode:corrupt:1",
    "ledger.append:transient:1+",
    "ledger.append:corrupt:1",
    "launch.decode:transient:p0.3",
])
def test_schedule_matrix_equals_jax(tmp_path, fault_free, spec):
    got = {}
    for pkg in ("jax", "torch"):
        jmetrics.registry().reset()
        tmetrics.registry().reset()
        run = world(pkg, tmp_path / pkg, (spec,))
        resumed = world(pkg, tmp_path / pkg, resume=True)
        assert resumed[0] == fault_free, (pkg, resumed[0])
        assert resumed[2] == 0
        got[pkg] = run
    assert got["torch"] == got["jax"]
    vmap, fails, degraded, counters = got["torch"]
    assert counters["fault_injected"] >= 1
    assert len(fails) == degraded
    assert all(vmap[k] == fault_free[k] for k in vmap if vmap[k] != "unknown")


def test_crash_propagates_then_resume_converges(tmp_path, fault_free):
    for pkg in ("jax", "torch"):
        with pytest.raises((faults.InjectedFault, jfaults.InjectedFault)):
            world(pkg, tmp_path / pkg, ("launch.decode:crash:2",))
        assert world(pkg, tmp_path / pkg, resume=True)[0] == fault_free


def test_compile_site_has_no_arrivals_on_the_cpu(tmp_path, fault_free):
    vmap, fails, degraded, counters = world("torch", tmp_path, ("compile:transient:1+",))
    assert vmap == fault_free and not fails and not degraded
    assert counters["fault_injected"] == 0
