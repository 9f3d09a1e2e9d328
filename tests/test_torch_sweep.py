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
from fairify_tpu_torch.verify import pruning as tpruning
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
    # bench.py's _bab_ladder world: stage 0 and the deep PGD decide none of
    # its 8 partitions.  With the default engine they pass Phase S and reach
    # Phase E0 (ported since it raised here, naming K9), which decides them
    # (the per-root E0 cap raised so a loaded CPU cannot cut a scan short).
    # In the slice-2 configuration every leftover goes through the device
    # BaB and is decided.
    from fairify_tpu_torch.data.domains import get_domain

    ov = {c: (0, 0) for c in get_domain("german").columns}
    ov.update(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2))
    cfg = tpresets.get("GC").with_(
        result_dir=str(tmp_path), exact_certify_masks=False, sim_size=16, grid_chunk=8,
        domain_overrides=ov, partition_threshold=2,
        engine=EngineConfig(attack_samples=4, bab_frontier_cap=64, lattice_first_cap_s=120.0))
    net = tmlp.init_mlp((len(cfg.query().columns), 4, 1), seed=3, device="cpu")
    rep = tsweep.verify_model(net, cfg, model_name="m", resume=False, device="cpu",
                              partition_span=(0, 8))
    assert rep.counts == {"sat": 0, "unsat": 8, "unknown": 0}
    with open(os.path.join(cfg.result_dir, "GC-m@0-8.throughput.json")) as fp:
        assert json.load(fp)["engine_decided"].get("lattice_first", 0) > 0
    tail = EngineConfig(attack_samples=4, bab_frontier_cap=64, sign_bab=False,
                        lp_sign=False, lp_pair=False, lattice_exhaustive=False)
    cfg = cfg.with_(result_dir=str(tmp_path / "tail"), engine=tail)
    rep = tsweep.verify_model(net, cfg, model_name="m", resume=False, device="cpu",
                              partition_span=(0, 8))
    led = _ledger(tsweep.ledger_path(cfg, "m@0-8"))
    assert rep.counts == {"sat": 0, "unsat": 8, "unknown": 0} and len(led) == 8
    assert not any("not_ported" in json.dumps(r) for r in led)
    assert rep.funnel["states"] == {"certified:bab": 8}
    with open(os.path.join(cfg.result_dir, "GC-m@0-8.throughput.json")) as fp:
        thr = json.load(fp)
    assert thr["bab_decided"] == 8 and "stage0_pgd" in thr["phases_s"]


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


@pytest.mark.parametrize("P,sim_size,seed,index", [(1, 1000, 42, 5), (3, 37, 42, 5),
                                                   (2, 64, 2**32 + 9, 70_000)])
def test_sim_rows_and_parity_resim_match_jax(P, sim_size, seed, index):
    """K12's row generator (its plain version), which takes the seed and
    the first global index, is bit-equal to the JAX package's ``_sim_rows``
    on ``grid_keys(seed, index + p)``, row by row; the retry's parity on
    changed masks equals ``_parity_resim`` exactly — with a seed past
    2**32 (JAX keeps its low word) and an index past 65,535 too."""
    _, lo, hi = jsweep.build_partitions(jpresets.get("GC"))
    lo, hi = lo[5:5 + P], hi[5:5 + P]
    got = tpruning.sim_rows(seed, index, lo, hi, sim_size).numpy()
    jkeys = jprng.grid_keys(seed, index, P)
    for p in range(P):
        want = np.asarray(jsweep._sim_rows(jkeys[p], jnp.asarray(lo[p], jnp.float32),
                                           jnp.asarray(hi[p], jnp.float32), sim_size))
        np.testing.assert_array_equal(got[p], want)
    rng = np.random.default_rng(P)
    sizes = (20, 16, 8, 1)
    ws = [rng.normal(scale=0.3, size=(a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(scale=0.1, size=(b,)).astype(np.float32) for b in sizes[1:]]
    dead = [rng.random(n) > 0.6 for n in sizes[1:-1]] + [np.zeros(1, bool)]
    want = jsweep._parity_resim(ws, bs, dead, jkeys[0], lo[0], hi[0], sim_size)
    got = tsweep.parity_resim(ws, bs, dead, seed, index, lo[0], hi[0], sim_size)
    assert got == want
