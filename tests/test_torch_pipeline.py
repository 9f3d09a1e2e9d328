"""The port's launch pipeline: outputs do not depend on its depth.

``pipeline_depth`` 1, 2 and 4 give identical ledgers (less their timing
field), CSVs (less their time columns), margin histograms and counterexample
files, on the mega path and on the chunk loop, on a world whose partitions
reach every pipelined phase (stage 0, parity, ``stage0_pgd``, the device
BaB); at depth 1 they equal the JAX package's on the same world and depth.
Unit cases hold the pipeline's pieces: the FIFO drain order at each depth,
the in-flight statistics, and the fetch of nested payloads.
"""
import csv
import json
import os

import numpy as np
import pytest
import torch

from fairify_tpu.models.train import init_mlp
from fairify_tpu.parallel.pipeline import FlightStats as JFlightStats
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.data.domains import get_domain
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.parallel import pipeline
from fairify_tpu_torch.verify import presets, sweep
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
SPAN = (0, 8)
TIME_COLUMNS = {"SV-time", "S-time", "HV-Time", "H-Time", "Total-Time"}


def _run(tmp_path, tag, depth, mega_chunks, pkg="torch"):
    """One ``verify_model`` of the world in ``pkg`` ("torch" or "jax"): its
    outputs less their times, and its throughput record."""
    kw = dict(result_dir=str(tmp_path / tag), pipeline_depth=depth, mega_chunks=mega_chunks,
              soft_timeout_s=20.0, hard_timeout_s=120.0, sim_size=16,
              exact_certify_masks=False, grid_chunk=2, domain_overrides=_OV,
              partition_threshold=2)
    net = init_mlp((20, 4, 1), seed=3)
    if pkg == "jax":
        cfg = jpresets.get("GC").with_(engine=jengine.EngineConfig(**_ENGINE), **kw)
        rep = jsweep.verify_model(net, cfg, model_name="m", resume=False, partition_span=SPAN)
    else:
        cfg = presets.get("GC").with_(engine=EngineConfig(**_ENGINE), **kw)
        tnet = tmlp.from_numpy([np.asarray(w) for w in net.weights],
                               [np.asarray(b) for b in net.biases], device="cpu")
        rep = sweep.verify_model(tnet, cfg, model_name="m", resume=False, device="cpu",
                                 partition_span=SPAN)
    sink = f"m@{SPAN[0]}-{SPAN[1]}"
    with open(sweep.ledger_path(cfg, sink)) as fp:
        ledger = [{k: v for k, v in json.loads(line).items() if k not in ("time_s", "_crc")}
                  for line in fp if line.strip()]
    with open(os.path.join(cfg.result_dir, f"{sink}.csv"), newline="") as fp:
        rows = list(csv.reader(fp))
    keep = [i for i, name in enumerate(rows[0]) if name not in TIME_COLUMNS]
    table = [[row[i] for i in keep] for row in rows]
    ce_path = os.path.join(cfg.result_dir, f"{sink}-counterexamples.csv")
    ces = open(ce_path).read() if os.path.exists(ce_path) else ""
    with open(os.path.join(cfg.result_dir, f"GC-{sink}.throughput.json")) as fp:
        thr = json.load(fp)
    return {"ledger": ledger, "csv": table, "ces": ces,
            "hist": rep.funnel["margin_hist"], "funnel": rep.funnel["states"]}, thr


@pytest.fixture(scope="module", params=[8, 0], ids=["mega", "chunk"])
def depth1(request, tmp_path_factory):
    td = tmp_path_factory.mktemp("d1")
    out, thr = _run(td, "d1", 1, request.param)
    assert thr["launches_in_flight_max"] == 1 and thr["pipeline_depth"] == 1
    # The world reaches the tail: the PGD pass and the engine both ran.
    assert "stage0_pgd" in thr["phases_s"] and "bab" in thr["phases_s"]
    # The JAX package gives the same outputs on the same world and depth.
    want, _ = _run(td, "jax", 1, request.param, pkg="jax")
    assert out == want
    return request.param, out


@pytest.mark.parametrize("depth", [2, 4])
def test_outputs_do_not_depend_on_depth(tmp_path, depth1, depth):
    mega_chunks, want = depth1
    got, thr = _run(tmp_path, f"d{depth}", depth, mega_chunks)
    assert got == want
    assert thr["pipeline_depth"] == depth
    assert 1 <= thr["launches_in_flight_max"] <= depth


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_drains_in_submission_order(depth):
    pipe = pipeline.LaunchPipeline(depth=depth, gauge=False)
    seen, inflight = [], []
    for i in range(7):
        for meta, ctx, host in pipe.submit(lambda i=i: ({"v": torch.tensor([i])}, i),
                                           meta=i):
            seen.append((meta, ctx, int(host["v"][0])))
        inflight.append(len(pipe))
    seen.extend((meta, ctx, int(host["v"][0])) for meta, ctx, host in pipe.drain())
    assert seen == [(i, i, i) for i in range(7)]
    assert max(inflight) == depth and pipe.stats.max == depth


def test_flight_stats_match_jax():
    clock = iter([0.0, 1.0, 1.5, 4.0, 5.0, 7.0]).__next__
    jclock = iter([0.0, 1.0, 1.5, 4.0, 5.0, 7.0]).__next__
    ours, theirs = pipeline.FlightStats(clock=clock), JFlightStats(clock=jclock)
    for n in (0, 2, 1, 3, 0, 1):
        ours.update(n)
        theirs.update(n)
    assert ours.summary() == theirs.summary() and ours.max == 3


def test_fetch_walks_nested_payloads():
    payload = {"a": torch.arange(3), "b": (torch.ones(2, dtype=torch.bool), [torch.zeros(1)]),
               "c": 5}
    host = pipeline.fetch(payload)
    assert isinstance(host["a"], np.ndarray) and host["a"].tolist() == [0, 1, 2]
    assert host["b"][0].dtype == np.bool_ and isinstance(host["b"][1][0], np.ndarray)
    assert host["c"] == 5


def test_stage_keeps_host_arrays_on_the_cpu():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = pipeline.stage(a, "cpu")
    assert t.device.type == "cpu" and t.dtype == torch.float32
    assert np.array_equal(t.numpy(), a)
