"""The port's chunk loop (``mega_chunks=0``), its fused certificate + attack
(``engine.certify_attack``, the JAX package's ``_certify_attack_kernel``)
and its host-frontier BaB (``device_bab=False``) against the JAX package,
on the CPU.

* ``certify_attack`` at ``alpha_iters`` 0 and 2 on the same boxes and
  candidates: ``cert``, ``found`` and ``wit`` equal; ``margin`` and ``gap``
  within rel 1e-4 of their scale + abs 1e-5 (as in test_torch_stage0.py);
  the branching ``score`` within 1e-4 of the box's largest score + 1e-6
  (its coefficients come from CROWN backward passes that XLA and torch sum
  in different orders, so small scores differ by a few ulps of the large
  ones).
* The chunk-loop prune pass (one launch per padded chunk): masks and
  activation frequencies equal to the JAX chunk loop's and to the port's
  mega path; the samples (``keep_sim``) bit-equal to JAX's.
* ``verify_model`` at ``mega_chunks=0``: outcomes, ledger rows, CSV rows
  and funnel equal to the port's mega path (``mega_chunks=4``, histograms
  bit for bit) and to the JAX package's chunk loop.
* ``decide_many(device_bab=False)``: verdicts, reasons, node counts,
  leaves and witnesses equal to JAX's on tests/test_torch_bab.py's toy
  worlds and the brute-force oracle's verdict; the BaB ladder world's
  ledger and CSV rows equal JAX's and its device-BaB verdicts.
"""
import csv
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairify_tpu.data.domains import get_domain
from fairify_tpu.models import mlp as jmlp
from fairify_tpu.models.train import init_mlp
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import pruning as jpruning
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu.verify.property import encode as jencode
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.verify import engine as tengine
from fairify_tpu_torch.verify import oracle
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import pruning as tpruning
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig
from fairify_tpu_torch.verify.property import encode as tencode
from fairify_tpu_torch.verify.property import role_boxes
from test_torch_bab import TAIL, _assert_same_rows, _ce, _jeng, _params, _toy
from test_torch_prune import _within_slack

TOL_REL, TOL_ABS = 1e-4, 1e-5


def _net(sizes, seed):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=np.sqrt(2.0 / a), size=(a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(scale=0.1, size=(b,)).astype(np.float32) for b in sizes[1:]]
    return ws, bs


# --------------------------------------------------------------------------
# Row 15: certificate + score + attack, α-CROWN on and off


@pytest.mark.parametrize("alpha", [0, 2])
@pytest.mark.parametrize("preset,sizes", [("AC", (13, 12, 8, 1)),
                                          ("relaxed-AC", (13, 16, 8, 1))])
def test_certify_attack_matches_jax_kernel(preset, sizes, alpha):
    enc = tencode(tpresets.get(preset).query())
    jenc = jencode(jpresets.get(preset).query())
    _, lo, hi = tsweep.build_partitions(tpresets.get(preset))
    lo, hi = lo[:48], hi[:48]
    ws, bs = _net(sizes, 4)
    flo, fhi = lo.astype(np.float32), hi.astype(np.float32)
    x_lo, x_hi, xp_lo, xp_hi, valid = role_boxes(enc, flo, fhi)
    xr, pr = tengine.build_attack_candidates(enc, np.random.default_rng(5), lo, hi, 16)
    av, pm, rm = tengine.enc_tensors(enc, lo.shape[1])
    boxes = (x_lo, x_hi, xp_lo, xp_hi, flo, fhi, av, pm, rm)
    want = jengine._certify_attack_kernel(
        jmlp.from_numpy(ws, bs), *map(jnp.asarray, boxes), float(jenc.eps),
        jnp.asarray(valid), jnp.asarray(jenc.valid_pair), jnp.asarray(xr),
        jnp.asarray(pr), alpha_iters=alpha)
    T = torch.as_tensor
    tnet = tmlp.from_numpy(ws, bs, device="cpu")
    got = tengine.certify_attack(tnet, *map(T, boxes), float(enc.eps), T(valid),
                                 T(enc.valid_pair), T(xr), T(pr), alpha_iters=alpha)
    cert, score, found, wit, margin, gap = (t.numpy() for t in got)
    j_cert, j_score, j_found, j_wit, j_margin, j_gap = map(np.asarray, want)
    np.testing.assert_array_equal(cert, j_cert)
    np.testing.assert_array_equal(found, j_found)
    np.testing.assert_array_equal(wit, j_wit)
    box_scale = j_score.max(axis=1, keepdims=True)
    assert (np.abs(score - j_score) <= TOL_REL * box_scale + 1e-6).all()
    _, _, _, scale = tengine.certify_impl(tnet, *map(T, boxes), float(enc.eps), T(valid),
                                          T(enc.valid_pair), alpha, with_scale=True)
    big = np.abs(j_margin) >= 3e38
    assert (big == (np.abs(margin) >= 3e38)).all()
    tol = TOL_REL * np.maximum(np.abs(j_margin), scale.numpy()) + TOL_ABS
    assert (np.abs(margin - j_margin)[~big] <= tol[~big]).all()
    lx, lp = tengine.attack_logits(tnet, T(xr), T(pr))
    lscale = torch.maximum(lx.abs().amax(dim=(1, 2)), lp.abs().amax(dim=(1, 2))).numpy()
    assert (np.abs(gap - j_gap) <= TOL_REL * np.maximum(np.abs(j_gap), lscale)
            + TOL_ABS).all()
    assert cert.any() and (~cert).any()
    if alpha:  # α tightens: at least as many boxes certify as plain CROWN
        plain = tengine.certify_attack(tnet, *map(T, boxes), float(enc.eps), T(valid),
                                       T(enc.valid_pair), T(xr), T(pr))[0].numpy()
        assert (cert >= plain).all()


# --------------------------------------------------------------------------
# Row 1: the chunk-loop prune pass


@pytest.mark.parametrize("keep_sim", [False, True])
def test_prune_chunk_loop_matches_jax(keep_sim):
    cfg = tpresets.get("GC")
    _, lo, hi = tsweep.build_partitions(cfg)
    lo, hi = lo[:40], hi[:40]
    ws, bs = _net((20, 12, 6, 1), 7)
    kw = dict(chunk=16, index_offset=3, keep_sim=keep_sim)
    want = jpruning.sound_prune_grid(jmlp.from_numpy(ws, bs), lo, hi, 64, 5,
                                     exact_certify=False, mega_chunks=0, **kw)
    tnet = tmlp.from_numpy(ws, bs, device="cpu")
    got = tpruning.sound_prune_grid(tnet, lo, hi, 64, 5, mega_chunks=0, **kw)
    mega = tpruning.sound_prune_grid(tnet, lo, hi, 64, 5, chunk=16, mega_chunks=2,
                                     index_offset=3)
    for k in ("candidates", "surviving", "b_deads", "st_deads", "pos_prob"):
        for g, w, m in zip(getattr(got, k), getattr(want, k), getattr(mega, k)):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
            np.testing.assert_array_equal(g, m, err_msg=k)
    for g, w in zip(got.ws_lb, want.ws_lb):
        assert g.shape == np.asarray(w).shape
    _within_slack(np.concatenate(got.ws_lb, 1), np.concatenate(got.ws_ub, 1),
                  np.concatenate([np.asarray(w) for w in want.ws_lb], 1),
                  np.concatenate([np.asarray(w) for w in want.ws_ub], 1))
    np.testing.assert_allclose(got.looseness, want.looseness, rtol=1e-5)
    np.testing.assert_allclose(got.looseness, mega.looseness, rtol=1e-5)
    if keep_sim:
        np.testing.assert_array_equal(got.sim, np.asarray(want.sim))
    else:
        assert got.sim is None and want.sim is None


# --------------------------------------------------------------------------
# Stage 0 and parity through verify_model


def _read(cfg, sink):
    with open(os.path.join(cfg.result_dir, f"{cfg.name}-{sink}.ledger.jsonl")) as fp:
        led = [json.loads(line) for line in fp if line.strip()]
    with open(os.path.join(cfg.result_dir, f"{sink}.csv"), newline="") as fp:
        rows = list(csv.reader(fp))
    return led, rows


# (preset, net, span, engine) — the GC-1 twin (stage 0 decides everything)
# and a relaxed-AC net whose leftovers go through PGD and the device BaB.
SWEEPS = {
    "gc_twin": ("GC", "twin", (0, 64), dict(frontier_size=512, attack_samples=128,
                                            bab_attack_samples=16)),
    "relaxed_ac_tail": ("relaxed-AC", (13, 16, 8, 1), (5, 45),
                        dict(attack_samples=16, pgd_steps=4, pgd_restarts=4, max_nodes=40,
                             bab_frontier_cap=64, sign_bab=False, lp_sign=False,
                             lp_pair=False, lattice_exhaustive=False)),
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_verify_model_chunk_loop_matches_mega_and_jax(tmp_path, case):
    preset, sizes, span, eng = SWEEPS[case]
    if sizes == "twin":
        from __graft_entry__ import _flagship_net

        jnet = _flagship_net()
        ws, bs = [np.asarray(w) for w in jnet.weights], [np.asarray(b) for b in jnet.biases]
    else:
        ws, bs = _net(sizes, 2)
        jnet = jmlp.from_numpy(ws, bs)
    kw = dict(soft_timeout_s=60.0, hard_timeout_s=600.0, exact_certify_masks=False,
              grid_chunk=16, sim_size=64)
    sink = f"m@{span[0]}-{span[1]}"
    jcfg = jpresets.get(preset).with_(result_dir=str(tmp_path / "j0"), mega_chunks=0,
                                      engine=jengine.EngineConfig(**eng), **kw)
    jrep = jsweep.verify_model(jnet, jcfg, model_name="m", resume=False,
                               partition_span=span)
    reps, reads = {}, {}
    for mc in (0, 4):
        tcfg = tpresets.get(preset).with_(result_dir=str(tmp_path / f"t{mc}"),
                                          mega_chunks=mc, engine=EngineConfig(**eng), **kw)
        reps[mc] = tsweep.verify_model(tmlp.from_numpy(ws, bs, device="cpu"), tcfg,
                                       model_name="m", resume=False, device="cpu",
                                       partition_span=span)
        reads[mc] = _read(tcfg, sink)
    jres = _read(jcfg, sink)
    assert reps[0].counts == reps[4].counts == jrep.counts
    for mc in (0, 4):
        _assert_same_rows(jres, reads[mc])
        assert reps[mc].funnel["states"] == jrep.funnel["states"]
    # Histograms bit for bit; the looseness sums are the mega path's device
    # f32 sums and the chunk loop's host f64 sums, as in the JAX package.
    f0, f4 = dict(reps[0].funnel), dict(reps[4].funnel)
    np.testing.assert_allclose(f0.pop("looseness"), f4.pop("looseness"), rtol=1e-5)
    assert f0 == f4
    # The port bins real rows only, as the JAX package's mega path does.
    # The JAX chunk loop trims its per-box margins and gaps at the PADDED
    # chunk size (``_stage0_block_decode``'s ``ctx["n"]``), so its
    # histograms also count the last chunk's padding rows: exactly that
    # many extra boxes (ROADMAP queue 3).
    jmega = jsweep.verify_model(jnet, jcfg.with_(result_dir=str(tmp_path / "j4"),
                                                 mega_chunks=4),
                                model_name="m", resume=False, partition_span=span)
    assert reps[0].funnel["margin_hist"] == jmega.funnel["margin_hist"]
    n_pad = -(span[1] - span[0]) % 16
    for row in ("margin", "gap"):
        extra = (np.asarray(jrep.funnel["margin_hist"][row])
                 - np.asarray(jmega.funnel["margin_hist"][row]))
        assert (extra >= 0).all() and extra.sum() == n_pad
    if case == "relaxed_ac_tail":
        assert reps[0].counts["sat"] and reps[0].counts["unsat"]


# --------------------------------------------------------------------------
# The host-frontier BaB


@pytest.mark.parametrize("sizes,span,seed,kw", [
    ((4, 8, 1), 2, 0, {}), ((4, 8, 1), 2, 3, {}), ((4, 8, 1), 2, 4, {}),
    ((4, 6, 1), 6, 2, dict(alpha_iters=0)), ((4, 6, 1), 6, 3, dict(alpha_iters=0)),
    ((4, 8, 6, 1), 4, 2, {}), ((4, 8, 6, 1), 4, 3, {}),
    ((4, 6, 1), 6, 6, dict(alpha_iters=0, frontier_size=4)),
    ((4, 6, 1), 6, 3, dict(alpha_iters=0, max_nodes=5)),
])
def test_host_frontier_matches_jax(sizes, span, seed, kw):
    ws, bs, _ = _params(seed, sizes)
    jenc, tenc, tq = _toy(span)
    lo = np.zeros((1, 4), np.int64)
    hi = np.array([[span, span, span, 1]], np.int64)
    ek = _jeng(**dict(dict(device_bab=False, frontier_size=64), **kw))
    jd = jengine.decide_many(jmlp.from_numpy(ws, bs), jenc, lo, hi,
                             jengine.EngineConfig(**ek), deadline_s=240.0)[0]
    tn = tmlp.from_numpy(ws, bs, device="cpu")
    td = tengine.decide_many(tn, tenc, lo, hi, EngineConfig(**ek), deadline_s=240.0)[0]
    assert (td.verdict, td.reason, td.nodes, td.leaves, _ce(td)) == \
        (jd.verdict, jd.reason, jd.nodes, jd.leaves, _ce(jd))
    if "max_nodes" in kw:
        assert td.reason == "budget"
    elif span <= 4:
        assert td.verdict == oracle.brute_force_verdict(tn, tq, lo[0], hi[0])
    if td.verdict == "sat":
        assert tengine.validate_pair(*tn.numpy_params(), *td.counterexample)


def _ladder_cfgs(tmp_path, tag, **engine_kw):
    ov = {c: (0, 0) for c in get_domain("german").columns}
    ov.update(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2))
    ek = dict(pgd_phase=False, attack_samples=4, bab_attack_samples=4,
              bab_frontier_cap=64, bab_rounds_per_segment=8, **TAIL, **engine_kw)
    kw = dict(soft_timeout_s=20.0, hard_timeout_s=120.0, sim_size=16,
              exact_certify_masks=False, grid_chunk=4, mega_chunks=0,
              domain_overrides=ov, partition_threshold=2)
    return (jpresets.get("GC").with_(result_dir=str(tmp_path / f"j{tag}"),
                                     engine=jengine.EngineConfig(**ek), **kw),
            tpresets.get("GC").with_(result_dir=str(tmp_path / f"t{tag}"),
                                     engine=EngineConfig(**ek), **kw))


@pytest.mark.parametrize("max_nodes", [200_000, 1], ids=["bab", "retry"])
def test_ladder_world_host_frontier_and_chunk_loop_match_jax(tmp_path, max_nodes):
    # bench.py's _bab_ladder world (every partition reaches the BaB) through
    # the chunk loop (two chunks of 4) and the host frontier: ledger and CSV
    # rows equal JAX's; without a node cap the verdicts equal the device
    # BaB's (tests/test_bab.py:352 in the JAX package); with max_nodes=1
    # every partition takes the heuristic retry, whose decide_box runs the
    # host frontier again.
    jcfg, tcfg = _ladder_cfgs(tmp_path, "hf", device_bab=False, max_nodes=max_nodes)
    net = init_mlp((len(jcfg.query().columns), 4, 1), seed=3)
    jrep = jsweep.verify_model(net, jcfg, model_name="m", resume=False,
                               partition_span=(0, 8))
    ws, bs = [np.asarray(w) for w in net.weights], [np.asarray(b) for b in net.biases]
    trep = tsweep.verify_model(tmlp.from_numpy(ws, bs, device="cpu"), tcfg, model_name="m",
                               resume=False, device="cpu", partition_span=(0, 8))
    assert trep.counts == jrep.counts
    _assert_same_rows(_read(jcfg, "m@0-8"), _read(tcfg, "m@0-8"))
    assert trep.funnel["states"] == jrep.funnel["states"]
    if max_nodes == 1:
        assert all(o.h_attempt == 1 for o in trep.outcomes)
        return
    assert trep.counts == {"sat": 0, "unsat": 8, "unknown": 0}
    _, dcfg = _ladder_cfgs(tmp_path, "dev")
    drep = tsweep.verify_model(tmlp.from_numpy(ws, bs, device="cpu"), dcfg, model_name="m",
                               resume=False, device="cpu", partition_span=(0, 8))
    assert [o.verdict for o in drep.outcomes] == [o.verdict for o in trep.outcomes]
