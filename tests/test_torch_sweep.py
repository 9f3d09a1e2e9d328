"""The port's stage-0 sweep end to end against the JAX package's.

The GC-1 twin through both packages' ``verify_model`` with the bench's
configuration: the ledgers must agree row for row (partition id, verdict,
counterexample) and the CSVs on the verdict and compression columns; the
counts are the published GC-1/Age row, sat=2 unsat=199 unknown=0.  The
parity pass (KD's plain version) is held against the JAX parity kernel.
"""
import csv
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairify_tpu.models import mlp as jmlp
from fairify_tpu.utils import prng as jprng
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.resilience import integrity as tintegrity
from fairify_tpu_torch.utils import prng as tprng
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig


def _bench_cfgs(tmp_path):
    eng = dict(frontier_size=512, attack_samples=128, bab_attack_samples=16,
               soft_timeout_s=10.0)
    kw = dict(soft_timeout_s=10.0, hard_timeout_s=600.0, exact_certify_masks=False)
    jcfg = jpresets.get("GC").with_(result_dir=str(tmp_path / "jax"),
                                    engine=jengine.EngineConfig(**eng), **kw)
    tcfg = tpresets.get("GC").with_(result_dir=str(tmp_path / "torch"),
                                    engine=EngineConfig(**eng), **kw)
    return jcfg, tcfg


def _ledger(path):
    with open(path) as fp:
        return [json.loads(line) for line in fp if line.strip()]


def _csv(path):
    with open(path, newline="") as fp:
        return list(csv.reader(fp))


def test_verify_model_matches_jax_row_for_row(tmp_path):
    from __graft_entry__ import _flagship_net

    jcfg, tcfg = _bench_cfgs(tmp_path)
    jrep = jsweep.verify_model(_flagship_net(), jcfg, model_name="GC-1", resume=False)
    trep = tsweep.verify_model(tmlp.flagship_net(device="cpu"), tcfg,
                               model_name="GC-1", resume=False, device="cpu")
    assert trep.counts == jrep.counts == {"sat": 2, "unsat": 199, "unknown": 0}
    jled = _ledger(os.path.join(jcfg.result_dir, "GC-GC-1.ledger.jsonl"))
    tled = _ledger(os.path.join(tcfg.result_dir, "GC-GC-1.ledger.jsonl"))
    assert [(r["partition_id"], r["verdict"], r["ce"]) for r in tled] == \
        [(r["partition_id"], r["verdict"], r["ce"]) for r in jled]
    good, bad = tintegrity.verify_records(tled)
    assert bad == 0 and len(good) == 201 and all("_crc" in r for r in tled)
    jrows, trows = (_csv(os.path.join(c.result_dir, "GC-1.csv")) for c in (jcfg, tcfg))
    assert trows[0] == jrows[0]
    cols = [trows[0].index(c) for c in (
        "Partition_ID", "Verification", "SAT_count", "UNSAT_count", "UNK_count",
        "B_compression", "S_compression", "ST_compression", "H_compression",
        "T_compression", "C-check", "V-accurate", "Pruned-acc", "C1", "C2")]
    assert [[r[i] for i in cols] for r in trows[1:]] == \
        [[r[i] for i in cols] for r in jrows[1:]]
    jce, tce = (_csv(os.path.join(c.result_dir, "GC-1-counterexamples.csv"))
                for c in (jcfg, tcfg))
    assert tce == jce
    with open(os.path.join(tcfg.result_dir, "GC-GC-1.throughput.json")) as fp:
        thr = json.load(fp)
    assert thr["decided_fraction"] == 1.0
    # Launches are counted where a kernel launches: none on the CPU, where
    # the plain versions run (the card's count is held by chip_smoke.py).
    assert thr["launches_per_model"] == sum(thr["kernel_launches"].values()) == 0
    assert thr["funnel"] == jrep.funnel["states"]
    assert trep.funnel["margin_hist"]["margin"] == jrep.funnel["margin_hist"]["margin"]


def test_resume_replays_the_ledger(tmp_path):
    _, tcfg = _bench_cfgs(tmp_path)
    tcfg = tcfg.with_(sim_size=50)
    net = tmlp.flagship_net(device="cpu")
    first = tsweep.verify_model(net, tcfg, model_name="GC-1", resume=False, device="cpu")
    again = tsweep.verify_model(net, tcfg, model_name="GC-1", resume=True, device="cpu")
    assert again.counts == first.counts
    assert [o.counterexample is not None for o in again.outcomes] == \
        [o.verdict == "sat" for o in first.outcomes]


def test_undecided_partitions_are_ledgered_not_ported(tmp_path):
    # attack_samples=1 leaves some boxes to the (unported) refinement tail.
    ws = [np.full((20, 4), 0.05, np.float32), np.ones((4, 1), np.float32)]
    bs = [np.zeros(4, np.float32), np.full(1, -3.0, np.float32)]
    cfg = tpresets.get("GC").with_(result_dir=str(tmp_path), exact_certify_masks=False,
                                   engine=EngineConfig(attack_samples=1), sim_size=20)
    rep = tsweep.verify_model(tmlp.from_numpy(ws, bs, device="cpu"), cfg,
                              model_name="m", resume=False, device="cpu")
    led = _ledger(tsweep.ledger_path(cfg, "m"))
    unknown = [r for r in led if r["verdict"] == "unknown"]
    assert len(unknown) == rep.counts["unknown"] > 0
    assert all(r["engine_reason"] == "refinement_not_ported" for r in unknown)
    assert rep.funnel["states"]["unknown:refinement_not_ported"] == len(unknown)


@pytest.mark.parametrize("sizes,P", [((20, 50, 1), 30), ((20, 16, 8, 1), 25)])
def test_parity_matches_jax(sizes, P):
    rng = np.random.default_rng(P)
    ws = [rng.normal(scale=0.3, size=(a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(scale=0.1, size=(b,)).astype(np.float32) for b in sizes[1:]]
    _, lo, hi = jsweep.build_partitions(jpresets.get("GC"))
    lo, hi = lo[:P].astype(np.float32), hi[:P].astype(np.float32)
    alive = [(rng.random((P, n)) > 0.3).astype(np.float32) for n in sizes[1:-1]]
    want = np.asarray(jsweep._parity_grid_from_keys(
        jmlp.from_numpy(ws, bs), jprng.grid_keys(42, 7, P), jnp.asarray(lo),
        jnp.asarray(hi), tuple(jnp.asarray(a) for a in alive), 200))
    got = tsweep.parity(tmlp.from_numpy(ws, bs, device="cpu"), tprng.grid_keys(42, 7, P),
                        torch.as_tensor(lo), torch.as_tensor(hi),
                        [torch.as_tensor(a) for a in alive], 200)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 1.0).any()  # the random masks do change predictions
