"""The port's stacked model families (``parallel.mesh.stack_models``,
``verify.sweep.stage0_families``, ``verify_model(stage0=...)``) against the
JAX package, on the CPU.

* ``stack_models``: the (M, in, out) layout, unstacking, per-model numpy
  parameters, the packed-buffer layout the kernels read and the
  mixed-architecture error.
* ``stage0_families`` on two AC families at ``mega_chunks`` 0, 1 and 2
  (40 partitions in chunks of 16, so the last chunk is padded): per model,
  the certified and SAT masks and the witnesses equal the JAX package's and
  each model's solo stage 0; the histograms equal the JAX mega path's and
  the port's solo ones bit for bit (the JAX chunk loop also bins its
  padding rows, ROADMAP queue 3).
* ``verify_model(stage0=...)`` with the family's forwarded ``StageStats``:
  ledger and CSV rows and funnel equal JAX's same flow and the port's solo
  run.
* A flipped bit in one model's row of a family segment trips the fold
  check and leaves the whole (family, segment) undecided.
"""
import csv
import json
import os

import numpy as np
import pytest
import torch

from fairify_tpu.models.train import init_mlp
from fairify_tpu.parallel import mesh as jmesh
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu.verify.property import encode as jencode
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.obs import funnel as tfunnel
from fairify_tpu_torch.parallel import mesh as tmesh
from fairify_tpu_torch.utils import cuda_build
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig
from fairify_tpu_torch.verify.property import encode as tencode
from test_torch_bab import _assert_same_rows


def _jnets(sizes, seeds):
    return [init_mlp(sizes, seed=s) for s in seeds]


def _tnet(jnet):
    return tmlp.from_numpy([np.asarray(w) for w in jnet.weights],
                           [np.asarray(b) for b in jnet.biases], device="cpu")


def test_stack_models_layout_and_errors():
    jnets = _jnets((5, 4, 3, 1), (0, 1, 2))
    nets = [_tnet(n) for n in jnets]
    st = tmesh.stack_models(nets)
    jst = jmesh.stack_models(jnets)
    assert (st.n_models, st.depth, st.in_dim, st.layer_sizes) == (3, 3, 5, (4, 3, 1))
    for a, b in zip(list(st.weights) + list(st.biases) + list(st.masks),
                    list(jst.weights) + list(jst.biases) + list(jst.masks)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32))
    logits = st(x)
    assert logits.shape == (3, 7)
    params, dims = cuda_build.pack_stack(st)
    assert list(dims) == [5, 4, 3, 1]
    one = [cuda_build.pack_net(n)[0] for n in nets]
    assert torch.equal(params, torch.cat(one))
    assert cuda_build.pack_models(st)[2] == 3 and cuda_build.pack_models(nets[0])[2] == 1
    for m, (net, unst) in enumerate(zip(nets, st.unstack())):
        assert torch.equal(unst(x), net(x)) and torch.equal(logits[m], net(x))
        for a, b in zip(st.numpy_params(m), net.numpy_params()):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    other = _tnet(init_mlp((5, 6, 1), seed=3))
    with pytest.raises(ValueError, match="uniform architectures"):
        tmesh.stack_models(nets + [other])
    with pytest.raises(ValueError, match="uniform architectures"):
        jmesh.stack_models(jnets + [init_mlp((5, 6, 1), seed=3)])


def _grid(preset, n):
    cfg = tpresets.get(preset).with_(grid_chunk=16, exact_certify_masks=False,
                                     engine=EngineConfig(attack_samples=32))
    _, lo, hi = tsweep.build_partitions(cfg)
    return cfg, lo[:n], hi[:n]


def _same_stage0(got, want):
    u_g, s_g, w_g = got[:3]
    u_w, s_w, w_w = want[:3]
    np.testing.assert_array_equal(u_g, np.asarray(u_w))
    np.testing.assert_array_equal(s_g, np.asarray(s_w))
    assert set(w_g) == set(w_w)
    for k in w_g:
        np.testing.assert_array_equal(w_g[k][0], w_w[k][0])
        np.testing.assert_array_equal(w_g[k][1], w_w[k][1])


@pytest.mark.parametrize("mega_chunks", [0, 1, 2])
def test_stage0_families_match_jax_and_solo(mega_chunks):
    tcfg, lo, hi = _grid("AC", 40)
    tcfg = tcfg.with_(mega_chunks=mega_chunks)
    jcfg = jpresets.get("AC").with_(grid_chunk=16, mega_chunks=mega_chunks,
                                    exact_certify_masks=False,
                                    engine=jengine.EngineConfig(attack_samples=32))
    d = lo.shape[1]
    jfams = [_jnets((d, 8, 1), (0, 1, 2)), _jnets((d, 6, 4, 1), (3, 4))]
    jstacks = [jmesh.stack_models(f) for f in jfams]
    tstacks = [tmesh.stack_models([_tnet(n) for n in f]) for f in jfams]
    want = jsweep.stage0_families(jstacks, jencode(jcfg.query()), lo, hi, jcfg,
                                  seed_offset=7)
    enc = tencode(tcfg.query())
    stats = {}
    got = tsweep.stage0_families(tstacks, enc, lo, hi, tcfg, seed_offset=7, stats=stats)
    jmega_stats = {}
    jsweep.stage0_families(jstacks, jencode(jcfg.query()), lo, hi,
                           jcfg.with_(mega_chunks=2), seed_offset=7, stats=jmega_stats)
    assert sorted(stats) == sorted(jmega_stats) == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1)]
    n_sat = 0
    for gi, (fam_g, fam_w) in enumerate(zip(got, want)):
        assert len(fam_g) == len(fam_w)
        for m, (g, w) in enumerate(zip(fam_g, fam_w)):
            _same_stage0(g, w)
            n_sat += int(g[1].sum())
            np.testing.assert_array_equal(stats[(gi, m)].hist, jmega_stats[(gi, m)].hist)
            assert stats[(gi, m)].boxes == 40
            # The model's own solo stage 0 (one net through the same path).
            solo_stats = tfunnel.StageStats()
            solo = tsweep.stage0_certify_and_attack(tstacks[gi].model(m), enc, lo, hi,
                                                    tcfg, solo_stats, {}, seed_offset=7)
            _same_stage0(g, solo)
            np.testing.assert_array_equal(stats[(gi, m)].hist, solo_stats.hist)
    assert n_sat  # witnesses were replayed on the models' own weights


def _read(cfg, sink):
    with open(os.path.join(cfg.result_dir, f"{cfg.name}-{sink}.ledger.jsonl")) as fp:
        led = [json.loads(line) for line in fp if line.strip()]
    with open(os.path.join(cfg.result_dir, f"{sink}.csv"), newline="") as fp:
        rows = list(csv.reader(fp))
    return led, rows


@pytest.mark.parametrize("mega_chunks", [0, 2])
def test_verify_model_stage0_matches_jax_and_solo(tmp_path, mega_chunks):
    eng = dict(attack_samples=32, pgd_steps=4, pgd_restarts=4, max_nodes=40,
               bab_frontier_cap=64, sign_bab=False, lp_sign=False, lp_pair=False,
               lattice_exhaustive=False)
    kw = dict(soft_timeout_s=60.0, hard_timeout_s=600.0, exact_certify_masks=False,
              grid_chunk=16, mega_chunks=mega_chunks, sim_size=64)
    jcfg = jpresets.get("AC").with_(result_dir=str(tmp_path / "j"),
                                    engine=jengine.EngineConfig(**eng), **kw)
    tcfg = tpresets.get("AC").with_(result_dir=str(tmp_path / "t"),
                                    engine=EngineConfig(**eng), **kw)
    _, lo, hi = tsweep.build_partitions(tcfg)
    lo, hi = lo[:24], hi[:24]
    jnets = _jnets((lo.shape[1], 8, 1), (0, 1))
    jstats, tstats = {}, {}
    jfam = jsweep.stage0_families([jmesh.stack_models(jnets)], jencode(jcfg.query()),
                                  lo, hi, jcfg, stats=jstats)[0]
    tnets = [_tnet(n) for n in jnets]
    tfam = tsweep.stage0_families([tmesh.stack_models(tnets)], tencode(tcfg.query()),
                                  lo, hi, tcfg, stats=tstats)[0]
    decided = 0
    for m, (jn, tn) in enumerate(zip(jnets, tnets)):
        name = f"m{m}"
        jrep = jsweep.verify_model(jn, jcfg, model_name=name, resume=False,
                                   partition_span=(0, 24),
                                   stage0=tuple(jfam[m]) + (jstats[(0, m)],))
        trep = tsweep.verify_model(tn, tcfg, model_name=name, resume=False, device="cpu",
                                   partition_span=(0, 24),
                                   stage0=tuple(tfam[m]) + (tstats[(0, m)],))
        solo_cfg = tcfg.with_(result_dir=str(tmp_path / "solo"))
        srep = tsweep.verify_model(tn, solo_cfg, model_name=name, resume=False,
                                   device="cpu", partition_span=(0, 24))
        sink = f"{name}@0-24"
        tres = _read(tcfg, sink)
        _assert_same_rows(_read(jcfg, sink), tres)
        _assert_same_rows(_read(solo_cfg, sink), tres)
        assert trep.counts == jrep.counts == srep.counts
        assert trep.funnel["states"] == jrep.funnel["states"]
        assert trep.funnel["margin_hist"] == srep.funnel["margin_hist"]
        assert trep.kernel_launches == srep.kernel_launches  # all 0 on the CPU
        decided += trep.counts["sat"] + trep.counts["unsat"]
    assert decided


def test_family_integrity_failure_leaves_segment_undecided(monkeypatch):
    cfg, lo, hi = _grid("AC", 40)
    cfg = cfg.with_(mega_chunks=2)
    enc = tencode(cfg.query())
    nets = [_tnet(n) for n in _jnets((lo.shape[1], 8, 1), (0, 1, 2))]
    stack = tmesh.stack_models(nets)
    clean = tsweep.stage0_family(stack, enc, lo, hi, cfg)
    real = tsweep.mega_segment_host

    def flipped(raw, ctx):
        host = real(raw, ctx)
        if ctx["chunks"][0][0] == 0:  # first segment: one bit of model 1's row
            host["wit"] = host["wit"].copy()
            host["wit"][(0, 1, 3, 0) if host["wit"].ndim == 4 else (0, 3, 0)] ^= 1
        return host

    monkeypatch.setattr(tsweep, "mega_segment_host", flipped)
    stats = {}
    got = tsweep.stage0_family(stack, enc, lo, hi, cfg, stats=stats)
    for (u, s, w), (uc, sc, wc) in zip(got, clean):
        assert not u[:32].any() and not s[:32].any() and all(k >= 32 for k in w)
        np.testing.assert_array_equal(u[32:], uc[32:])
        np.testing.assert_array_equal(s[32:], sc[32:])
    assert all(st.boxes == 8 for st in stats.values())  # the second segment only
    failed = {}
    unsat, sat, _ = tsweep.stage0_certify_and_attack(nets[0], enc, lo, hi, cfg,
                                                     tfunnel.StageStats(), failed)
    assert sorted(failed) == list(range(32))  # one net: its segment's rows fail
    assert failed[0]["reason"] == "integrity.launch.decode:fatal"
