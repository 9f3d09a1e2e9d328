"""The port's observability layer against the JAX package's.

* ``trace_out``: the JAX package's ``obs.load_events`` reads the log the
  port wrote; the multiset of span names and the sequence of ``verdict``
  events equal the JAX package's for the same run (spans that name XLA
  compiles left out); the JAX package's ``obs.report.aggregate`` builds
  the same verdict, degradation, integrity and segment tables from either
  log — under a fault schedule, so the degradation table is not empty.
* ``heartbeat_s``: the port's heartbeat lines carry the JAX package's
  fields (the numbers aside), the retry/degraded suffix included.
* ``profile_dir``: a ``torch.profiler`` trace file holding the phase names.
* The metrics registry and the launch registry.

One run per package, with the event log, the heartbeat and (the port's)
profiler all on, feeds every case of the first three groups.
"""
import collections
import contextlib
import glob
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from fairify_tpu import obs as jobs
from fairify_tpu.data.domains import get_domain
from fairify_tpu.models.train import init_mlp
from fairify_tpu.obs import metrics as jmetrics
from fairify_tpu.obs import report as jreport
from fairify_tpu.obs import trace as jtrace
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.obs import heartbeat as theartbeat
from fairify_tpu_torch.obs import launches
from fairify_tpu_torch.obs import metrics as tmetrics
from fairify_tpu_torch.obs import trace as ttrace
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

_OV = {c: (0, 0) for c in get_domain("german").columns}
_OV.update(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2))
_ENGINE = dict(lattice_exhaustive=False, attack_samples=4, bab_attack_samples=4,
               bab_frontier_cap=64, bab_rounds_per_segment=8, pgd_restarts=8)
_SWEEP = dict(soft_timeout_s=20.0, hard_timeout_s=120.0, sim_size=16,
              exact_certify_masks=False, grid_chunk=2, mega_chunks=2, domain_overrides=_OV,
              partition_threshold=2, launch_backoff_s=1e-4,
              inject_faults=("launch.submit:fatal:3", "launch.decode:transient:5"))
SPAN = (0, 8)
COMPILE_SPANS = ("compile.", "execload.", "compileinfo.")


@pytest.fixture(autouse=True)
def _clean_state():
    for trace_mod, metrics_mod in ((jtrace, jmetrics), (ttrace, tmetrics)):
        trace_mod.deactivate()
        metrics_mod.registry().reset()
    yield
    for trace_mod, metrics_mod in ((jtrace, jmetrics), (ttrace, tmetrics)):
        trace_mod.deactivate()
        metrics_mod.registry().reset()


def _jnet():
    return init_mlp((20, 4, 1), seed=3)


def _tnet():
    net = _jnet()
    return tmlp.from_numpy([np.asarray(w) for w in net.weights],
                           [np.asarray(b) for b in net.biases], device="cpu")


def _run(pkg, result_dir, **kw):
    kw = dict(_SWEEP, **kw)
    if pkg == "jax":
        cfg = jpresets.get("GC").with_(result_dir=str(result_dir),
                                       engine=jengine.EngineConfig(**_ENGINE), **kw)
        return jsweep.verify_model(_jnet(), cfg, model_name="m", resume=False,
                                   partition_span=SPAN)
    cfg = tpresets.get("GC").with_(result_dir=str(result_dir), engine=EngineConfig(**_ENGINE),
                                   **kw)
    return tsweep.verify_model(_tnet(), cfg, model_name="m", resume=False, device="cpu",
                               partition_span=SPAN)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Both packages' event logs, report and heartbeat lines of one
    faulted run of the ladder world with every beat forced; the port's
    run also writes its profiler trace into ``<dir>/prof``."""
    td = tmp_path_factory.mktemp("logs")
    out = {}
    for pkg in ("jax", "torch"):
        path = str(td / f"{pkg}.jsonl")
        extra = {"profile_dir": str(td / "prof")} if pkg == "torch" else {}
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rep = _run(pkg, td / pkg, trace_out=path, heartbeat_s=1e-9, **extra)
        beats = [line for line in err.getvalue().splitlines()
                 if line.startswith("[hb m@") and " compiling " not in line]
        out[pkg] = (path, rep, beats)
    assert out["torch"][1].degraded == out["jax"][1].degraded > 0
    out["prof"] = td / "prof"
    return out


def _spans(records):
    return collections.Counter(r["name"] for r in records if r["type"] == "span"
                               and not r["name"].startswith(COMPILE_SPANS))


def test_jax_loader_reads_the_port_log(logs):
    recs, skipped = jobs.load_events(logs["torch"][0], count_skipped=True)
    assert skipped == 0
    assert recs[0]["type"] == "meta" and recs[-1]["type"] == "metrics"
    names = _spans(recs)
    for phase in ("verify_model", "stage0_prune", "prune.sim_and_bounds", "stage0_decide",
                  "stage0_parity", "stage0_pgd", "bab", "pipeline.drain",
                  "engine.device_bab", "engine.bab"):
        assert names[phase] >= 1, phase
    metrics = recs[-1]["metrics"]
    assert metrics["fault_injected"]["kind"] == "counter"
    assert metrics["fault_injected"]["series"]
    assert os.path.exists(jtrace.chrome_trace_path(logs["torch"][0]))


def test_span_multiset_and_verdict_events_equal_jax(logs):
    jrecs = jobs.load_events(logs["jax"][0])
    trecs = jobs.load_events(logs["torch"][0])
    assert _spans(trecs) == _spans(jrecs)
    verdicts = lambda recs: [(r["attrs"]["partition_id"], r["attrs"]["verdict"],
                              r["attrs"]["via"], r["attrs"].get("failure"))
                             for r in recs if r["type"] == "event" and r["name"] == "verdict"]
    assert verdicts(trecs) == verdicts(jrecs) and len(verdicts(trecs)) == SPAN[1]
    events = lambda recs, name: [{k: v for k, v in r["attrs"].items() if k != "detail"}
                                 for r in recs if r["type"] == "event" and r["name"] == name]
    for name in ("degraded", "fault_injected", "segment"):
        assert events(trecs, name) == events(jrecs, name), name


def test_jax_report_aggregates_the_port_log_alike(logs):
    jagg = jreport.aggregate([logs["jax"][0]])
    tagg = jreport.aggregate([logs["torch"][0]])
    for key in ("verdicts", "decided", "attempted", "via", "degraded", "integrity",
                "segments"):
        assert tagg[key] == jagg[key], key
    # The JAX log's extra spans are its XLA compiles.
    assert tagg["span_count"] == sum(_spans(jobs.load_events(logs["jax"][0])).values())
    assert tagg["degraded"] and tagg["funnel"]["states"] == jagg["funnel"]["states"]
    assert set(tagg["phases"]) == set(jagg["phases"]) - {
        k for k in jagg["phases"] if k.startswith(COMPILE_SPANS)}
    assert jreport.render(tagg)


def _normalize(line: str) -> str:
    return re.sub(r"\d+(\.\d+)?", "#", line)


def test_heartbeat_lines_carry_jax_fields(logs):
    lines = {pkg: logs[pkg][2] for pkg in ("jax", "torch")}
    assert lines["torch"] and lines["jax"]
    # The closing beat (forced) has the same fields, the numbers aside.
    assert _normalize(lines["torch"][-1]) == _normalize(lines["jax"][-1])
    for field in ("attempted (", "| decided ", "pps", "launches", "| retries="):
        assert field in lines["torch"][-1], field
    seg = lambda ls: sorted({_normalize(l) for l in ls if " segments " in l})
    assert seg(lines["torch"]) == seg(lines["jax"])


def test_heartbeat_suffix_and_build_flag():
    out = io.StringIO()
    hb = theartbeat.Heartbeat(1000.0, total=10, label="X", stream=out)
    hb.beat(decided=1, attempted=1, unknown=0, force=True)
    assert "retries=" not in out.getvalue()  # healthy: zero-noise
    tmetrics.registry().counter("launch_retries").inc(site="launch.submit")
    tmetrics.registry().counter("chunks_degraded").inc(n=2, site="bab")
    hb.beat(decided=2, attempted=2, unknown=0, force=True)
    assert "| retries=1 degraded=2" in out.getvalue()
    assert theartbeat.active() is hb
    theartbeat.notify_build("parity.cu")
    assert out.getvalue().splitlines()[-1] == "[hb X] building parity.cu…"
    hb.close()
    assert theartbeat.active() is None


def test_profile_dir_writes_a_trace_with_the_phase_names(logs):
    assert logs["torch"][1].partitions_total == SPAN[1]
    (path,) = glob.glob(str(logs["prof"] / "trace-*.json"))
    with open(path) as fp:
        names = {e.get("name") for e in json.load(fp)["traceEvents"]}
    for phase in ("stage0_prune", "stage0_decide", "stage0_parity", "stage0_pgd", "bab"):
        assert phase in names, phase
    assert any(n and n.startswith("stage0_decide#") for n in names)


def test_metrics_snapshot_layout_equals_jax():
    for reg in (jmetrics.registry(), tmetrics.registry()):
        reg.counter("launch_retries").inc(2, site="launch.decode")
        reg.gauge("launches_in_flight").set(3, stat="max")
        reg.histogram("partition_latency_s").observe(0.2)
    names = ("launch_retries", "launches_in_flight", "partition_latency_s")
    pick = lambda snap: {k: snap[k] for k in names}
    assert pick(tmetrics.registry().snapshot()) == pick(jmetrics.registry().snapshot())
    before = tmetrics.registry().snapshot()
    tmetrics.registry().counter("launch_retries").inc(site="launch.decode")
    delta = tmetrics.snapshot_delta(before, tmetrics.registry().snapshot())
    assert delta["launch_retries"]["series"] == [
        {"labels": {"site": "launch.decode"}, "value": 1.0}]


def test_launch_registry_counts_signatures_and_builds():
    launches.reset()
    before = launches.snapshot()
    for shape in ((4, 2), (4, 2), (8, 2)):
        with launches.launching("parity", shape):
            pass
    launches.record_build(3, 1.5)
    assert launches.counts()["parity"] == 3
    block = launches.delta(before)
    assert block["launches"] == {"parity": 3} and block["signatures"] == {"parity": 2}
    assert set(block["first_launch_s"]) == {"parity"}
    assert (block["builds"], block["build_s"]) == (3, 1.5)
    assert tmetrics.registry().counter("device_launches").total() == 3
    with pytest.raises(KeyError):
        with launches.launching("no_such_kernel"):
            pass
    launches.reset()
