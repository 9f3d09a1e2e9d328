"""The port's IBP path (``use_crown=False``, the JAX package's K10 group)
against the JAX package, on the CPU.

* Row 13, ``engine.role_logit_bounds`` (its plain version), against
  ``_role_logit_bounds`` at ``use_crown`` False and True, on a toy net and an
  AC-S1-width net, each with a masked neuron and an always-dead unit: IBP
  bounds within the widening slack's scale
  (``test_torch_prune._within_slack``: rel 1e-5 of max(|lb|, |ub|) + abs
  1e-5) and containing the exact rational interval bounds
  (``ops.exact.exact_network_bounds``) on a sample of role boxes; CROWN
  bounds within rel 1e-4 of the case's largest bound + abs 1e-4 (as
  test_torch_crown.py) and containing the f64 logits of sampled points.
* Row 13's live-row call (``role_logit_bounds(..., live=n)``) on a
  ``_pad``-ded batch against ``_role_logit_bounds`` on that batch for boxes
  < n, the boxes past ``live`` equal to box n - 1 (for a stacked family on
  every model); chip_smoke.py's plain-order IBP reference (the kernel's own
  fmaf order, held to it bit for bit on the card) and its library chain
  (the centre-radius image) within tolerance of JAX's bounds.
* Row 17, ``engine.attack_logits``, against ``_attack_logits``: within rel
  1e-5 of the box's largest |logit| + abs 1e-6 (f32 summation order); and
  chip_smoke.py's row-17 check passes JAX's logits and fails a moved one.
* Rows 8 and 9 (a stacked family) against ``_family_bounds_kernel`` and
  ``_family_logits_kernel``, and per model equal to the single-net rows.
* ``verify_model`` at ``use_crown=False`` (with the preset's
  ``exact_certify_masks=True``) on the GC-1 twin and a relaxed-AC span:
  counts, ledger rows, CSV rows (timing aside) and funnel states equal
  JAX's; the histograms equal JAX's except the JAX chunk loop's padding
  rows (ROADMAP queue 3), pinned to exactly those rows.
* ``stage0_families`` at ``use_crown=False`` against JAX and each model's
  solo stage 0.
* ``decide_many(use_crown=False)`` (the host frontier's non-fused branch)
  against JAX on tests/test_torch_bab.py's toy worlds: verdict, reason,
  nodes, leaves and witness equal; the split on the widest dimension is
  exercised.
"""
import csv
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairify_tpu.models import mlp as jmlp
from fairify_tpu.models.train import init_mlp
from fairify_tpu.parallel import mesh as jmesh
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu.verify.property import encode as jencode
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.models.mlp import forward_np
from fairify_tpu_torch.obs import funnel as tfunnel
from fairify_tpu_torch.ops import exact as texact
from fairify_tpu_torch.parallel import mesh as tmesh
from fairify_tpu_torch.verify import engine as tengine
from fairify_tpu_torch.verify import oracle
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig
from fairify_tpu_torch.verify.property import encode as tencode
from fairify_tpu_torch.verify.property import role_boxes
from test_torch_bab import _assert_same_rows, _ce, _jeng, _params, _toy
from test_torch_prune import _within_slack

AC_S1 = (13, 128, 64, 32, 16, 8, 1)


def _masked_net(sizes, seed):
    """Weights, biases and masks with hidden neuron 1 of layer 0 masked and
    neuron 2 of layer 0 dead on every input (a bias far below any sum)."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=np.sqrt(2.0 / a), size=(a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(scale=0.1, size=(b,)).astype(np.float32) for b in sizes[1:]]
    bs[0][2] = -1.0e6
    ms = [np.ones(b, np.float32) for b in sizes[1:]]
    ms[0][1] = 0.0
    return ws, bs, ms


def _role_case(kind):
    """(ws, bs, ms, role boxes (x_lo, x_hi, xp_lo, xp_hi) (B, V, d))."""
    if kind == "toy":
        ws, bs, ms = _masked_net((4, 8, 6, 1), 3)
        jenc, tenc, _ = _toy(6)
        rng = np.random.default_rng(1)
        lo = rng.integers(0, 4, size=(12, 4))
        hi = np.minimum(lo + rng.integers(0, 3, size=lo.shape), 6)
        lo[:, 3], hi[:, 3] = 0, 1
    else:
        ws, bs, ms = _masked_net(AC_S1, 5)
        cfg = tpresets.get("relaxed-AC")
        tenc = tencode(cfg.query())
        _, lo, hi = tsweep.build_partitions(cfg)
        lo, hi = lo[:12], hi[:12]
    boxes = role_boxes(tenc, lo.astype(np.float32), hi.astype(np.float32))
    return ws, bs, ms, boxes[:4]


@pytest.mark.parametrize("use_crown", [False, True], ids=["ibp", "crown"])
@pytest.mark.parametrize("kind", ["toy", "ac_s1"])
def test_role_logit_bounds_match_jax(kind, use_crown):
    ws, bs, ms, boxes = _role_case(kind)
    want = [np.asarray(v) for v in jengine._role_logit_bounds(
        jmlp.from_numpy(ws, bs, ms), *map(jnp.asarray, boxes), use_crown)]
    tnet = tmlp.from_numpy(ws, bs, ms, device="cpu")
    got = [t.numpy() for t in tengine.role_logit_bounds(
        tnet, *map(torch.as_tensor, boxes), use_crown)]
    assert all(g.shape == boxes[0].shape[:-1] for g in got)
    for role in (0, 2):
        if use_crown:
            scale = max(np.abs(want[role]).max(), np.abs(want[role + 1]).max())
            for g, w in zip(got[role:role + 2], want[role:role + 2]):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)
        else:
            _within_slack(got[role], got[role + 1], want[role], want[role + 1])
        assert (got[role] <= got[role + 1]).all()
    # Soundness on a sample of role boxes: the IBP bounds contain the exact
    # rational interval bounds; every bound contains sampled f64 logits.
    rng = np.random.default_rng(0)
    for b, v in [(0, 0), (5, 1), (11, 1)]:
        for role in (0, 1):
            lo, hi = boxes[2 * role][b, v], boxes[2 * role + 1][b, v]
            lb, ub = got[2 * role][b, v], got[2 * role + 1][b, v]
            if not use_crown:
                ex = texact.exact_network_bounds(ws, bs, lo.astype(np.int64),
                                                 hi.astype(np.int64), alive=ms)
                assert lb <= ex[0][-1][0] and ub >= ex[1][-1][0]
            pts = rng.integers(lo.astype(np.int64), hi.astype(np.int64) + 1,
                               size=(64, lo.shape[0]))
            f = forward_np(ws, bs, pts, dead=[1.0 - m for m in ms[:-1]])
            assert (f >= lb).all() and (f <= ub).all()


@pytest.mark.parametrize("use_crown", [False, True], ids=["ibp", "crown"])
def test_role_logit_bounds_live_rows_match_jax(use_crown):
    ws, bs, ms, boxes = _role_case("toy")
    B = boxes[0].shape[0]
    jn, tnet = jmlp.from_numpy(ws, bs, ms), tmlp.from_numpy(ws, bs, ms, device="cpu")
    tst = tmesh.stack_models([tnet, tmlp.from_numpy(*_masked_net((4, 8, 6, 1), 7),
                                                    device="cpu")])
    T = torch.as_tensor
    for n in (1, 5, B):
        pb = [tengine._pad(b[:n], B) for b in boxes]
        want = [np.asarray(v) for v in jengine._role_logit_bounds(
            jn, *map(jnp.asarray, pb), use_crown)]
        got = [t.numpy() for t in tengine.role_logit_bounds(tnet, *map(T, pb), use_crown,
                                                             live=n)]
        for role in (0, 2):
            g, w = got[role:role + 2], [x[:n] for x in want[role:role + 2]]
            if use_crown:
                scale = max(np.abs(w[0]).max(), np.abs(w[1]).max())
                for a, b in zip(g, w):
                    np.testing.assert_allclose(a[:n], b, rtol=1e-4, atol=1e-4 * scale)
            else:
                _within_slack(g[0][:n], g[1][:n], w[0], w[1])
        for g in got:
            assert g.shape == boxes[0].shape[:-1] and (g[n:] == g[n - 1]).all()
        full = tengine.role_logit_bounds(tst, *map(T, pb), use_crown)
        part = tengine.role_logit_bounds(tst, *map(T, pb), use_crown, live=n)
        for f, p in zip(full, part):
            assert torch.equal(p[:, :n], f[:, :n]) and (p[:, n:] == p[:, n - 1:n]).all()
    for bad in (0, B + 1):
        with pytest.raises(ValueError):
            tengine.role_logit_bounds(tnet, *map(T, boxes), use_crown, live=bad)


def test_chip_smoke_ibp_references_match_jax():
    """chip_smoke.py's plain-order IBP reference (``ibp_ordered``) within the
    widening slack's scale of JAX's row-13 IBP bounds, and its library chain
    (``library_interval``) within TOL_REL of the interval magnitude."""
    import chip_smoke

    ws, bs, ms, boxes = _role_case("ac_s1")
    want = [np.asarray(v) for v in jengine._role_logit_bounds(
        jmlp.from_numpy(ws, bs, ms), *map(jnp.asarray, boxes), False)]
    tnet = tmlp.from_numpy(ws, bs, ms, device="cpu")
    tb = [torch.as_tensor(b) for b in boxes]
    lib = [t.numpy().reshape(boxes[0].shape[:-1]) for t in chip_smoke.library_interval(tnet, tb)]
    d = boxes[0].shape[-1]
    for role in (0, 1):
        lo, hi = (tb[2 * role + i].reshape(-1, d) for i in (0, 1))
        got = [t.numpy().reshape(boxes[0].shape[:-1]) for t in chip_smoke.ibp_ordered(tnet, lo,
                                                                                     hi)]
        w = want[2 * role:2 * role + 2]
        _within_slack(got[0], got[1], w[0], w[1])
        mag = np.maximum(np.abs(w[0]), np.abs(w[1]))
        for a, b in zip(lib[2 * role:2 * role + 2], w):
            assert (np.abs(a - b) <= chip_smoke.TOL_REL * mag + chip_smoke.TOL_ABS).all()


def _attack_case(kind):
    """(ws, bs, ms, x candidates, x' candidates) of a row-17 case."""
    ws, bs, ms, _ = _role_case(kind)
    cfg = tpresets.get("relaxed-AC")
    enc = tencode(cfg.query())
    _, lo, hi = tsweep.build_partitions(cfg)
    if kind == "toy":
        _, enc, _ = _toy(6)
        lo = np.zeros((6, 4), np.int64)
        hi = np.array([[6, 6, 6, 1]] * 6, np.int64)
    xr, pr = tengine.build_attack_candidates(enc, np.random.default_rng(2), lo[:6],
                                             hi[:6], 16)
    return ws, bs, ms, xr, pr


@pytest.mark.parametrize("kind", ["toy", "ac_s1"])
def test_attack_logits_match_jax(kind):
    ws, bs, ms, xr, pr = _attack_case(kind)
    jlx, jlp = (np.asarray(v) for v in jengine._attack_logits(
        jmlp.from_numpy(ws, bs, ms), jnp.asarray(xr), jnp.asarray(pr)))
    lx, lp = (t.numpy() for t in tengine.attack_logits(
        tmlp.from_numpy(ws, bs, ms, device="cpu"), torch.as_tensor(xr),
        torch.as_tensor(pr)))
    for g, w in ((lx, jlx), (lp, jlp)):
        assert g.shape == w.shape == xr.shape[:-1]
        scale = np.abs(w).max(axis=(1, 2), keepdims=True)
        assert (np.abs(g - w) <= 1e-5 * scale + 1e-6).all()


@pytest.mark.parametrize("use_crown", [False, True], ids=["ibp", "crown"])
def test_family_rows_match_jax_and_single_rows(use_crown):
    ws, bs, ms, boxes = _role_case("toy")
    nets = [(ws, bs, ms)] + [_masked_net((4, 8, 6, 1), s) for s in (7, 8)]
    jst = jmesh.stack_models([jmlp.from_numpy(*n) for n in nets])
    tnets = [tmlp.from_numpy(*n, device="cpu") for n in nets]
    tst = tmesh.stack_models(tnets)
    T = torch.as_tensor
    want = [np.asarray(v) for v in jsweep._family_bounds_kernel(
        jst, *map(jnp.asarray, boxes), use_crown)]
    got = [t.numpy() for t in tengine.role_logit_bounds(tst, *map(T, boxes), use_crown)]
    _, enc, _ = _toy(6)
    xr, pr = tengine.build_attack_candidates(
        enc, np.random.default_rng(4), np.zeros((5, 4), np.int64),
        np.array([[6, 6, 6, 1]] * 5, np.int64), 8)
    wl = [np.asarray(v) for v in jsweep._family_logits_kernel(jst, jnp.asarray(xr),
                                                              jnp.asarray(pr))]
    gl = [t.numpy() for t in tengine.attack_logits(tst, T(xr), T(pr))]
    for m, net in enumerate(tnets):
        solo = [t.numpy() for t in tengine.role_logit_bounds(net, *map(T, boxes),
                                                              use_crown)]
        solo_l = [t.numpy() for t in tengine.attack_logits(net, T(xr), T(pr))]
        for g, s in zip(got + gl, solo + solo_l):
            np.testing.assert_array_equal(g[m], s)
        for role in (0, 2):
            scale = np.abs(want[role][m]).max() + np.abs(want[role + 1][m]).max()
            for g, w in zip(got[role:role + 2], want[role:role + 2]):
                np.testing.assert_allclose(g[m], w[m], rtol=1e-4, atol=1e-5 * scale)
        for g, w in zip(gl, wl):
            scale = np.abs(w[m]).max(axis=(1, 2), keepdims=True)
            assert (np.abs(g[m] - w[m]) <= 1e-5 * scale + 1e-6).all()


# --------------------------------------------------------------------------
# verify_model, stage0_families and decide_many on the IBP path


def _read(cfg, sink):
    with open(os.path.join(cfg.result_dir, f"{cfg.name}-{sink}.ledger.jsonl")) as fp:
        led = [json.loads(line) for line in fp if line.strip()]
    with open(os.path.join(cfg.result_dir, f"{sink}.csv"), newline="") as fp:
        rows = list(csv.reader(fp))
    return led, rows


# (preset, net, span, engine, chunk) — the GC-1 twin on its preset as it
# stands (exact-certify on; stage 0 and the host frontier decide every
# partition), and a relaxed-AC net whose leftovers reach PGD and the host
# frontier, in ragged chunks of 16.
IBP = dict(use_crown=False)
SWEEPS = {
    "gc_twin": ("GC", "twin", None, dict(frontier_size=512, attack_samples=128,
                                         bab_attack_samples=16, **IBP), 2048),
    "relaxed_ac": ("relaxed-AC", (13, 16, 8, 1), (5, 45),
                   dict(attack_samples=16, pgd_steps=4, pgd_restarts=4, max_nodes=40,
                        sign_bab=False, lp_sign=False, lp_pair=False,
                        lattice_exhaustive=False, frontier_size=64, **IBP), 16),
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_verify_model_ibp_matches_jax(tmp_path, case):
    preset, sizes, span, eng, chunk = SWEEPS[case]
    if sizes == "twin":
        from __graft_entry__ import _flagship_net

        jnet = _flagship_net()
        ws, bs = [np.asarray(w) for w in jnet.weights], [np.asarray(b) for b in jnet.biases]
    else:
        ws, bs, _ = _masked_net(sizes, 2)
        jnet = jmlp.from_numpy(ws, bs)
    kw = dict(soft_timeout_s=60.0, hard_timeout_s=600.0, grid_chunk=chunk)
    if case != "gc_twin":
        kw["sim_size"] = 64
    jcfg = jpresets.get(preset).with_(result_dir=str(tmp_path / "j"),
                                      engine=jengine.EngineConfig(**eng), **kw)
    tcfg = tpresets.get(preset).with_(result_dir=str(tmp_path / "t"),
                                      engine=EngineConfig(**eng), **kw)
    assert tcfg.exact_certify_masks and tcfg.mega_chunks > 0  # the preset as it is
    jrep = jsweep.verify_model(jnet, jcfg, model_name="m", resume=False,
                               partition_span=span)
    trep = tsweep.verify_model(tmlp.from_numpy(ws, bs, device="cpu"), tcfg,
                               model_name="m", resume=False, device="cpu",
                               partition_span=span)
    sink = "m" if span is None else f"m@{span[0]}-{span[1]}"
    assert trep.counts == jrep.counts
    _assert_same_rows(_read(jcfg, sink), _read(tcfg, sink))
    assert trep.funnel["states"] == jrep.funnel["states"]
    np.testing.assert_allclose(trep.funnel["looseness"], jrep.funnel["looseness"],
                               rtol=1e-5)
    # The JAX chunk loop bins its padded rows (ROADMAP queue 3): exactly the
    # last chunk's padding rows more than the port, which bins real rows.
    P = len(trep.outcomes)
    n_pad = -P % chunk if P > chunk else 0
    for row in ("margin", "gap"):
        extra = (np.asarray(jrep.funnel["margin_hist"][row])
                 - np.asarray(trep.funnel["margin_hist"][row]))
        assert (extra >= 0).all() and extra.sum() == n_pad
    with open(os.path.join(tcfg.result_dir, f"{tcfg.name}-{sink}.throughput.json")) as fp:
        thr = json.load(fp)
    assert "prune_exact_certify" in thr["phases_s"]
    if case == "gc_twin":
        assert trep.counts == {"sat": 2, "unsat": 199, "unknown": 0}
        assert trep.funnel["states"].get("certified:bab", 0) > 0  # the host frontier
    else:
        assert n_pad and trep.counts["sat"] and trep.counts["unsat"]


def test_stage0_families_ibp_match_jax_and_solo():
    cfg = tpresets.get("AC").with_(grid_chunk=16, exact_certify_masks=False,
                                   engine=EngineConfig(attack_samples=32, use_crown=False))
    _, lo, hi = tsweep.build_partitions(cfg)
    lo, hi = lo[:40], hi[:40]
    jcfg = jpresets.get("AC").with_(grid_chunk=16, exact_certify_masks=False,
                                    engine=jengine.EngineConfig(attack_samples=32,
                                                                use_crown=False))
    d = lo.shape[1]
    jfams = [[init_mlp((d, 8, 1), seed=s) for s in (0, 1, 2)],
             [init_mlp((d, 6, 4, 1), seed=s) for s in (3, 4)]]
    tfams = [[tmlp.from_numpy([np.asarray(w) for w in n.weights],
                              [np.asarray(b) for b in n.biases], device="cpu")
              for n in f] for f in jfams]
    want = jsweep.stage0_families([jmesh.stack_models(f) for f in jfams],
                                  jencode(jcfg.query()), lo, hi, jcfg, seed_offset=7)
    enc = tencode(cfg.query())
    stats = {}
    got = tsweep.stage0_families([tmesh.stack_models(f) for f in tfams], enc, lo, hi,
                                 cfg, seed_offset=7, stats=stats)
    assert stats == {}  # the IBP family branch banks no histograms, as in JAX
    n_sat = n_unsat = 0
    for fam_g, fam_w, nets in zip(got, want, tfams):
        for g, w, net in zip(fam_g, fam_w, nets):
            solo = tsweep.stage0_certify_and_attack(net, enc, lo, hi, cfg,
                                                    tfunnel.StageStats(), {},
                                                    seed_offset=7)
            for other in (w, solo):
                np.testing.assert_array_equal(g[0], np.asarray(other[0]))
                np.testing.assert_array_equal(g[1], np.asarray(other[1]))
                assert set(g[2]) == set(other[2])
                for k in g[2]:
                    for a, b in zip(g[2][k], other[2][k]):
                        np.testing.assert_array_equal(a, b)
            n_sat += int(g[1].sum())
            n_unsat += int(g[0].sum())
    assert n_sat and n_unsat


@pytest.mark.parametrize("sizes,span,seed,kw", [
    ((4, 8, 1), 2, 0, {}), ((4, 8, 1), 2, 3, {}), ((4, 8, 1), 2, 4, {}),
    ((4, 6, 1), 6, 2, {}), ((4, 6, 1), 6, 3, {}), ((4, 8, 6, 1), 4, 2, {}),
    ((4, 6, 1), 6, 6, dict(frontier_size=4)), ((4, 6, 1), 6, 3, dict(max_nodes=5)),
])
def test_host_frontier_ibp_matches_jax(sizes, span, seed, kw):
    ws, bs, _ = _params(seed, sizes)
    jenc, tenc, tq = _toy(span)
    lo = np.zeros((1, 4), np.int64)
    hi = np.array([[span, span, span, 1]], np.int64)
    ek = _jeng(**dict(dict(use_crown=False, frontier_size=64), **kw))
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
    if seed != 0:  # every root but seed 0's is split (widest dimension first)
        assert td.nodes > 1


@pytest.mark.parametrize("use_crown", [False, True], ids=["ibp", "crown"])
def test_chip_smoke_role_bounds_check_rejects_mutants(use_crown):
    """chip_smoke.py's row-13 check: JAX's bounds (another summation order,
    standing in for the kernel) pass against the port's plain version, and
    the copies with one bound moved past its float64 bound and with the
    output widening removed fail."""
    import chip_smoke

    ws, bs, ms, boxes = _role_case("ac_s1")
    k = [torch.tensor(np.asarray(v)) for v in jengine._role_logit_bounds(
        jmlp.from_numpy(ws, bs, ms), *map(jnp.asarray, boxes), use_crown)]
    tnet = tmlp.from_numpy(ws, bs, ms, device="cpu")
    tboxes = [torch.as_tensor(b) for b in boxes]
    p = tengine.role_logit_bounds_plain(tnet, *tboxes, use_crown)
    ref = chip_smoke.k10_refs(tnet, tboxes, use_crown)
    reading = chip_smoke.role_bounds_verdict(k, p, ref)
    assert not chip_smoke.role_bounds_fails(*reading), reading
    mutants = chip_smoke.role_bounds_mutants(k, ref)
    assert len(mutants) == 2
    for what, km in mutants.items():
        assert chip_smoke.role_bounds_fails(*chip_smoke.role_bounds_verdict(km, p, ref)), what


@pytest.mark.parametrize("kind", ["toy", "ac_s1"])
def test_chip_smoke_attack_logits_check_rejects_a_moved_logit(kind):
    """chip_smoke.py's row-17 and row-21 check (``logit_error``, each logit
    to TOL_REL of its rounding scale): JAX's logits (another summation
    order, standing in for the kernel) pass against the port's plain
    version, and the copy with one logit moved (``moved_logit``) fails."""
    import chip_smoke

    ws, bs, ms, xr, pr = _attack_case(kind)
    k = [torch.tensor(np.asarray(v)) for v in jengine._attack_logits(
        jmlp.from_numpy(ws, bs, ms), jnp.asarray(xr), jnp.asarray(pr))]
    tnet = tmlp.from_numpy(ws, bs, ms, device="cpu")
    x, xp = torch.as_tensor(xr), torch.as_tensor(pr)
    p = tengine.attack_logits_plain(tnet, x, xp)
    scales = (chip_smoke.logit_scale(tnet, x), chip_smoke.logit_scale(tnet, xp))
    assert chip_smoke.logit_error(k, p, scales) <= 1.0
    assert chip_smoke.logit_error(chip_smoke.moved_logit(k, scales), p, scales) > 1.0
