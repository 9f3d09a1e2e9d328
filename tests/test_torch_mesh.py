"""The port's mesh path (``parallel.mesh``, rows 14 and 6), harsh pruning
(row 3) and the standalone α-CROWN bounds (K7) against the JAX package's,
on the CPU.

The JAX side runs on conftest's 8 virtual CPU devices; the port's mesh is a
``submesh`` of the one CPU device repeated, its counterpart.

* The mesh module: ``pad_to_multiple`` equals JAX's on axes 0 and 1;
  ``make_mesh`` raises on oversubscription, warns once on truncation and
  raises without CUDA unless asked for the CPU; ``submesh`` raises on
  factoring errors and on mixed CPU/CUDA devices; ``shard_parts`` then a
  gather returns the input.
* ``verify_model`` with a mesh, on the CROWN and the IBP path, on
  tests/test_parallel.py's world (net (20, 8, 1), seed 3, GC partitions
  0-48, ``grid_chunk`` 16, exact-certify off, 8 shards) and on bench.py's
  ladder domain (18 German-derived partitions, net (20, 8, 1) seed 1,
  ``grid_chunk`` 8, 3 shards: sat, unsat and host-frontier roots): counts,
  node counts, ledger rows and CSV rows equal JAX's with a mesh; the
  histograms differ by exactly the JAX chunk loop's padding rows;
  ``partitions_per_sec_per_chip`` is divided by the mesh size.  On the
  ladder domain the port's outcomes are equal for 1, 3 and 8 shards and
  equal ``mesh=None``'s decided verdicts.
* ``stage0_families`` of three stacked nets with a mesh: per model cert,
  sat and witnesses equal JAX's with a mesh.
* ``decide_many`` (tests/test_parallel.py's world: net (20, 8, 1), seed 5,
  24 GC partitions, ``frontier_size`` 64, Phase A off; 1, 3 and 8 shards) and
  ``uniform_sign_bab`` (the tests/test_torch_sign_bab.py worlds), and
  ``verify_model`` on the ladder world (tests/test_torch_sign_bab.py's
  ``_world``, CROWN and IBP) with a mesh: verdicts, node counts, reasons
  and witnesses equal JAX's with a mesh.
* Row 14's plain version (``engine.role_certify`` on the CPU) against
  ``_role_certify_kernel`` at α = 0 and α = 8 on relaxed-AC boxes, and row
  6 (a stacked family) per model equal to row 14: ``cert`` equal, margin
  and score within the widening slack of their scale.
* ``harsh_prune_grid`` against JAX's (tests/test_prune_variants.py's
  world) and against the port's own ``sound_prune_grid(...).candidates``.
* ``alpha_crown_output_bounds`` against JAX's on tests/test_crown.py's
  worlds at ``iters=8``: within the widening slack, containing the f64
  logits of every lattice point, never looser than plain CROWN; also with
  ``widen=False`` (no looser than the widened bounds) and on boxes with
  extra leading axes.
"""
import csv
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairify_tpu.models import mlp as jmlp
from fairify_tpu.models.train import init_mlp
from fairify_tpu.ops import crown as jcrown
from fairify_tpu.parallel import mesh as jmesh
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import pruning as jpruning
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu.verify.property import encode as jencode
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.ops import crown as tcrown
from fairify_tpu_torch.ops.interval import SOUND_SLACK_ABS, SOUND_SLACK_REL
from fairify_tpu_torch.parallel import mesh as tmesh
from fairify_tpu_torch.verify import engine as tengine
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import pruning as tpruning
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig
from fairify_tpu_torch.verify.property import encode as tencode
from fairify_tpu_torch.verify.property import role_boxes
from test_torch_bab import _assert_same_rows, _ce
from test_torch_sign_bab import _encs, _mixed_net, _positive_net

CPU = torch.device("cpu")


def _cpu_mesh(n):
    return tmesh.submesh([CPU] * n)


def _tnet(jnet):
    return tmlp.from_numpy([np.asarray(w) for w in jnet.weights],
                           [np.asarray(b) for b in jnet.biases],
                           [np.asarray(m) for m in jnet.masks], device="cpu")


# --------------------------------------------------------------------------
# The mesh module


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("multiple", [1, 3, 4, 8])
def test_pad_to_multiple_matches_jax(axis, multiple):
    a = np.arange(30).reshape(5, 6)
    got, n = tmesh.pad_to_multiple(a, multiple, axis=axis)
    want, nj = jmesh.pad_to_multiple(a, multiple, axis=axis)
    assert n == nj == a.shape[axis]
    np.testing.assert_array_equal(got, want)


def test_make_mesh_counts_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    cpu = tmesh.make_mesh(device="cpu")
    assert cpu.shape == {"parts": 1, "models": 1} and cpu.home == CPU
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.make_mesh(n_parts=2, device="cpu")
    # Four visible cards: oversubscription raises, truncation warns once.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tmesh, "_TRUNCATION_WARNED", False)
    full = tmesh.make_mesh()
    assert full.shape == {"parts": 4, "models": 1}
    assert [str(d) for d in full.parts_devices] == [f"cuda:{i}" for i in range(4)]
    with pytest.raises(ValueError, match="needs 6 devices"):
        tmesh.make_mesh(n_parts=3, n_models=2)
    with pytest.warns(RuntimeWarning, match="uses 2 of 4"):
        two = tmesh.make_mesh(n_parts=1, n_models=2)
    assert two.shape == {"parts": 1, "models": 2} and two.size == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tmesh.make_mesh(n_parts=3)


def test_submesh_factoring_and_mixed_devices():
    with pytest.raises(ValueError, match="do not factor"):
        tmesh.submesh([CPU] * 3, n_models=2)
    with pytest.raises(ValueError, match="do not factor"):
        tmesh.submesh([])
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        tmesh.submesh([CPU, torch.device("cuda", 0)])
    m = tmesh.submesh([CPU] * 6, n_models=2)
    assert m.shape == {"parts": 3, "models": 2} and m.distinct == [CPU]
    with pytest.raises(TypeError):
        tmesh.require_mesh(jmesh.make_mesh())


@pytest.mark.parametrize("parts", [1, 3, 8])
def test_shard_parts_then_gather_is_the_input(parts):
    mesh = _cpu_mesh(parts)
    rng = np.random.default_rng(parts)
    a = rng.normal(size=(10, 3)).astype(np.float32)
    b = rng.integers(0, 5, size=(10, 2, 2))
    shards, n = tmesh.shard_parts(mesh, a, b)
    assert n == 10 and len(shards) == parts
    assert len({s[0].shape[0] for s in shards}) == 1
    got = tmesh.shard_map(mesh, lambda net, x, y: (x * 1.0, [y]), {CPU: None}, a, b)
    np.testing.assert_array_equal(got[0][:n], a)
    np.testing.assert_array_equal(got[1][0][:n], b)
    np.testing.assert_array_equal(got[0], tmesh.pad_to_multiple(a, parts)[0])


def test_replicated_copies_once_per_device():
    net = tmlp.seeded_net((4, 6, 1), seed=1, device="cpu")
    reps = tmesh.replicated(_cpu_mesh(8), net)
    assert list(reps) == [CPU]
    for w, r in zip(net.weights, reps[CPU].weights):
        assert torch.equal(w, r)
    stacked = tmesh.stack_models([net, net])
    assert isinstance(tmesh.replicated(_cpu_mesh(2), stacked)[CPU], tmlp.StackedMLP)


# --------------------------------------------------------------------------
# verify_model with a mesh


def _read(cfg, sink):
    with open(os.path.join(cfg.result_dir, f"{cfg.name}-{sink}.ledger.jsonl")) as fp:
        led = [json.loads(line) for line in fp if line.strip()]
    with open(os.path.join(cfg.result_dir, f"{sink}.csv"), newline="") as fp:
        rows = list(csv.reader(fp))
    return led, rows


def _german_kw():
    """bench.py's ladder domain: 18 German-derived partitions."""
    from fairify_tpu.data.domains import get_domain

    ov = {c: (0, 0) for c in get_domain("german").columns}
    ov.update(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2))
    return dict(soft_timeout_s=20.0, hard_timeout_s=120.0, sim_size=16,
                exact_certify_masks=False, grid_chunk=8, domain_overrides=ov,
                partition_threshold=2)


# (net, engine, span, parts): the world of tests/test_parallel.py (net
# (20, 8, 1), seed 3, GC partitions 0-48, grid_chunk 16) on the CROWN and
# the IBP path over 8 shards; and the ladder domain's 18 partitions with a
# net that leaves sat, unsat and host-frontier roots (grid_chunk 8: the
# last chunk padded, every chunk split into 3 shards with shard padding).
GC_KW = dict(soft_timeout_s=30.0, hard_timeout_s=600.0, sim_size=64,
             exact_certify_masks=False, grid_chunk=16)
GERMAN_ENGINE = dict(attack_samples=4, bab_attack_samples=4, max_nodes=40,
                     sign_bab=False, lp_sign=False, lp_pair=False,
                     lattice_exhaustive=False, frontier_size=64, pgd_steps=4,
                     pgd_restarts=4)
MESH_SWEEPS = {
    "gc_crown": ("parallel", dict(), (0, 48), 8),
    "gc_ibp": ("parallel", dict(use_crown=False), (0, 48), 8),
    "german_crown": ("german", GERMAN_ENGINE, None, 3),
    "german_ibp": ("german", dict(GERMAN_ENGINE, use_crown=False), None, 3),
}


def _sweep_world(world):
    if world == "parallel":
        return init_mlp((20, 8, 1), seed=3), GC_KW
    return init_mlp((20, 8, 1), seed=1, scale=0.1), _german_kw()


@pytest.mark.parametrize("case", sorted(MESH_SWEEPS))
def test_verify_model_mesh_matches_jax(tmp_path, case):
    world, eng, span, parts = MESH_SWEEPS[case]
    jnet, kw = _sweep_world(world)
    jcfg = jpresets.get("GC").with_(result_dir=str(tmp_path / "j"),
                                    engine=jengine.EngineConfig(**eng), **kw)
    tcfg = tpresets.get("GC").with_(result_dir=str(tmp_path / "t"),
                                    engine=EngineConfig(**eng), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the 3-part truncation
        jrep = jsweep.verify_model(jnet, jcfg, model_name="m", resume=False,
                                   partition_span=span,
                                   mesh=jmesh.make_mesh(n_parts=parts))
    trep = tsweep.verify_model(_tnet(jnet), tcfg, model_name="m", resume=False,
                               device="cpu", partition_span=span, mesh=_cpu_mesh(parts))
    sink = "m" if span is None else f"m@{span[0]}-{span[1]}"
    assert trep.counts == jrep.counts
    _assert_same_rows(_read(jcfg, sink), _read(tcfg, sink))
    assert trep.funnel["states"] == jrep.funnel["states"]
    assert [o.nodes for o in trep.outcomes] == [o.nodes for o in jrep.outcomes]
    # The JAX chunk loop bins its padded rows (ROADMAP queue 3): exactly the
    # last chunk's padding rows more than the port, which bins real rows.
    n_pad = -trep.partitions_total % kw["grid_chunk"]
    for row in ("margin", "gap"):
        extra = (np.asarray(jrep.funnel["margin_hist"][row])
                 - np.asarray(trep.funnel["margin_hist"][row]))
        assert (extra >= 0).all() and extra.sum() == n_pad
    with open(os.path.join(tcfg.result_dir, f"GC-{sink}.throughput.json")) as fp:
        thr = json.load(fp)
    assert thr["partitions_per_sec_per_chip"] == pytest.approx(
        thr["partitions_per_sec"] / parts, rel=1e-3, abs=1e-3)
    if world == "german":  # the host frontier's mesh branch ran
        assert n_pad and trep.counts["sat"] and trep.counts["unsat"]
        assert thr["bab_decided"]


@pytest.mark.parametrize("use_crown", [True, False], ids=["crown", "ibp"])
def test_mesh_outcomes_equal_for_1_3_8_shards(tmp_path, use_crown):
    jnet, kw = _sweep_world("german")
    cfg = tpresets.get("GC").with_(
        engine=EngineConfig(**dict(GERMAN_ENGINE, use_crown=use_crown)), **kw)
    rows = {}
    for parts in (None, 1, 3, 8):
        rep = tsweep.verify_model(_tnet(jnet), cfg.with_(result_dir=str(tmp_path / str(parts))),
                                  model_name="m", resume=False, device="cpu",
                                  mesh=None if parts is None else _cpu_mesh(parts))
        rows[parts] = [(o.partition_id, o.verdict, o.nodes,
                        _ce(o) if o.verdict == "sat" else None) for o in rep.outcomes]
    assert rows[1] == rows[3] == rows[8]
    decided = lambda r: [(p, v) for p, v, _, _ in r if v != "unknown"]
    assert decided(rows[None]) == decided(rows[1])
    assert {"sat", "unsat"} <= {v for _, v in decided(rows[1])}
    assert max(n for _, _, n, _ in rows[1]) > 1  # the host frontier split roots


def test_verify_model_mesh_rejects_what_it_cannot_take(tmp_path):
    net = tmlp.flagship_net(device="cpu")
    cfg = tpresets.get("GC").with_(result_dir=str(tmp_path), exact_certify_masks=False)
    with pytest.raises(TypeError, match="Mesh"):
        tsweep.verify_model(net, cfg, mesh=jmesh.make_mesh(), device="cpu")
    cuda_mesh = tmesh.Mesh(np.array([[torch.device("cuda", 0)]], dtype=object))
    with pytest.raises(ValueError, match="first device"):
        tsweep.verify_model(net, cfg, mesh=cuda_mesh, device="cpu")


# --------------------------------------------------------------------------
# stage0_families with a mesh


@pytest.mark.parametrize("use_crown", [True, False], ids=["crown", "ibp"])
def test_stage0_families_mesh_match_jax(use_crown):
    eng = dict(attack_samples=32, use_crown=use_crown)
    cfg = tpresets.get("AC").with_(grid_chunk=16, exact_certify_masks=False,
                                   engine=EngineConfig(**eng))
    jcfg = jpresets.get("AC").with_(grid_chunk=16, exact_certify_masks=False,
                                    engine=jengine.EngineConfig(**eng))
    _, lo, hi = tsweep.build_partitions(cfg)
    lo, hi = lo[:40], hi[:40]
    d = lo.shape[1]
    jnets = [init_mlp((d, 8, 1), seed=s) for s in (0, 1, 2)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        (want,) = jsweep.stage0_families([jmesh.stack_models(jnets)],
                                         jencode(jcfg.query()), lo, hi, jcfg,
                                         mesh=jmesh.make_mesh(n_parts=3), seed_offset=7)
    stats = {}
    (got,) = tsweep.stage0_families([tmesh.stack_models([_tnet(n) for n in jnets])],
                                    tencode(cfg.query()), lo, hi, cfg, seed_offset=7,
                                    stats=stats, mesh=_cpu_mesh(3))
    assert stats == {}  # the mesh family branches bank no histograms, as in JAX
    n_sat = n_unsat = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], np.asarray(w[0]))
        np.testing.assert_array_equal(g[1], np.asarray(w[1]))
        assert set(g[2]) == set(w[2])
        for k in g[2]:
            for a, b in zip(g[2][k], w[2][k]):
                np.testing.assert_array_equal(a, b)
        n_sat += int(g[1].sum())
        n_unsat += int(g[0].sum())
    assert n_sat and (n_unsat or not use_crown)


# --------------------------------------------------------------------------
# decide_many, uniform_sign_bab and the ladder world with a mesh


def _decisions(ds):
    return [(d.verdict, d.reason, d.nodes, d.leaves, _ce(d)) for d in ds]


def test_decide_many_mesh_matches_jax():
    jnet = init_mlp((20, 8, 1), seed=5)
    jcfg = jpresets.get("GC")
    _, lo, hi = jsweep.build_partitions(jcfg)
    lo, hi = lo[:24], hi[:24]
    # Phase A (the PGD attack) runs unsharded and, in its plain version,
    # slowly on a loaded CPU: it is off here; Phases S/L then decide.
    kw = dict(soft_timeout_s=30.0, frontier_size=64, pgd_phase=False)
    want = jengine.decide_many(jnet, jencode(jcfg.query()), lo, hi,
                               jengine.EngineConfig(**kw), mesh=jmesh.make_mesh())
    tenc = tencode(tpresets.get("GC").query())
    for parts in (1, 3, 8):
        got = tengine.decide_many(_tnet(jnet), tenc, lo, hi, EngineConfig(**kw),
                                  mesh=_cpu_mesh(parts))
        assert _decisions(got) == _decisions(want)
    plain = tengine.decide_many(_tnet(jnet), tenc, lo, hi, EngineConfig(**kw))
    assert [d.verdict for d in plain] == [d.verdict for d in got]
    assert "unknown" not in [d.verdict for d in got]


@pytest.mark.parametrize("world", ["positive", "mixed"])
def test_uniform_sign_bab_mesh_matches_jax(world):
    ws, bs = _positive_net() if world == "positive" else _mixed_net()
    jenc, tenc, jd = _encs({"a": (0, 6), "pa": (0, 1), "b": (0, 6)})
    lo, hi = jd.lo_hi()
    R = 3
    rl = np.repeat(lo.astype(np.int64)[None], R, axis=0)
    rh = np.repeat(hi.astype(np.int64)[None], R, axis=0)
    kw = dict(alpha_iters=4, lp_sign_max_unstable=0, frontier_size=4)
    jv, jn, _, _ = jengine.uniform_sign_bab(jmlp.from_numpy(ws, bs), jenc, rl, rh,
                                            jengine.EngineConfig(**kw), deadline_s=60.0,
                                            mesh=jmesh.make_mesh(n_parts=8))
    for parts in (1, 3, 8):
        tv, tn, _, _ = tengine.uniform_sign_bab(
            tmlp.from_numpy(ws, bs, device="cpu"), tenc, rl, rh, EngineConfig(**kw),
            deadline_s=60.0, mesh=_cpu_mesh(parts))
        assert tv == jv
        np.testing.assert_array_equal(tn, jn)
    assert jv == (["unsat"] * R if world == "positive" else ["mixed"] * R)


@pytest.mark.parametrize("use_crown", [True, False], ids=["crown", "ibp"])
def test_ladder_world_mesh_matches_jax(tmp_path, use_crown):
    from fairify_tpu.data.domains import get_domain

    ov = {c: (0, 0) for c in get_domain("german").columns}
    ov.update(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2))
    ek = dict(lattice_exhaustive=False, pgd_phase=False, attack_samples=4,
              bab_attack_samples=4, bab_frontier_cap=64, bab_rounds_per_segment=8,
              use_crown=use_crown)
    kw = dict(soft_timeout_s=20.0, hard_timeout_s=120.0, sim_size=16,
              exact_certify_masks=False, grid_chunk=8, domain_overrides=ov,
              partition_threshold=2)
    jcfg = jpresets.get("GC").with_(result_dir=str(tmp_path / "j"),
                                    engine=jengine.EngineConfig(**ek), **kw)
    tcfg = tpresets.get("GC").with_(result_dir=str(tmp_path / "t"),
                                    engine=EngineConfig(**ek), **kw)
    jnet = init_mlp((len(jcfg.query().columns), 4, 1), seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jrep = jsweep.verify_model(jnet, jcfg, model_name="m", resume=False,
                                   partition_span=(0, 8), mesh=jmesh.make_mesh(n_parts=3))
    trep = tsweep.verify_model(_tnet(jnet), tcfg, model_name="m", resume=False,
                               device="cpu", partition_span=(0, 8), mesh=_cpu_mesh(3))
    assert trep.counts == jrep.counts == {"sat": 0, "unsat": 8, "unknown": 0}
    _assert_same_rows(_read(jcfg, "m@0-8"), _read(tcfg, "m@0-8"))
    assert [o.nodes for o in trep.outcomes] == [o.nodes for o in jrep.outcomes]
    assert trep.funnel["states"] == jrep.funnel["states"]
    assert trep.kernel_launches["bab_segment"] == 0  # the host frontier, not K6


# --------------------------------------------------------------------------
# Row 14 (and row 6) plain against _role_certify_kernel


def _relaxed_case(B=12):
    cfg = tpresets.get("relaxed-AC")
    tenc = tencode(cfg.query())
    _, lo, hi = tsweep.build_partitions(cfg)
    lo, hi = lo[:B].astype(np.float32), hi[:B].astype(np.float32)
    x_lo, x_hi, xp_lo, xp_hi, valid = role_boxes(tenc, lo, hi)
    av, pm, rm = tengine.enc_tensors(tenc, lo.shape[1])
    args = (x_lo, x_hi, xp_lo, xp_hi, lo, hi, av, pm, rm)
    return cfg, tenc, args, valid


@pytest.mark.parametrize("alpha", [0, 8])
def test_role_certify_plain_matches_jax_kernel(alpha):
    cfg, tenc, args, valid = _relaxed_case()
    nets = [tmlp.seeded_net((13, 16, 8, 1), seed=s, device="cpu") for s in (0, 1)]
    T = torch.as_tensor
    eps = float(tenc.eps)
    stacked = tengine.role_certify(tmesh.stack_models(nets), *map(T, args), eps,
                                   T(valid), T(tenc.valid_pair), alpha_iters=alpha)
    n_cert = 0
    for m, net in enumerate(nets):
        jn = jmlp.from_numpy(*net.numpy_params())
        want = [np.asarray(v) for v in jengine._role_certify_kernel(
            jn, *map(jnp.asarray, args), eps, jnp.asarray(valid),
            jnp.asarray(tenc.valid_pair), alpha_iters=alpha)]
        cert, score, margin, scale = tengine.certify_impl(
            net, *map(T, args), eps, T(valid), T(tenc.valid_pair), alpha_iters=alpha,
            with_scale=True)
        got = tengine.role_certify(net, *map(T, args), eps, T(valid),
                                   T(tenc.valid_pair), alpha_iters=alpha)
        for g, s in zip(got, (cert, score, margin)):
            np.testing.assert_array_equal(g.numpy(), s.numpy())
        for g, s in zip(stacked, got):  # row 6 per model = row 14
            np.testing.assert_array_equal(g[m].numpy(), s.numpy())
        np.testing.assert_array_equal(cert.numpy(), want[0])
        slack = SOUND_SLACK_REL * scale.numpy() + SOUND_SLACK_ABS
        assert (np.abs(margin.numpy() - want[2]) <= slack).all()
        score_slack = SOUND_SLACK_REL * np.abs(want[1]).max() + SOUND_SLACK_ABS
        assert (np.abs(score.numpy() - want[1]) <= score_slack).all()
        n_cert += int(cert.sum())
    assert 0 < n_cert < 2 * len(valid)


# --------------------------------------------------------------------------
# Row 3: harsh pruning


def test_harsh_prune_grid_matches_jax_and_candidates():
    jnet = init_mlp([6, 12, 8, 1], seed=5)
    rng = np.random.default_rng(3)
    lo = np.zeros((5, 6), dtype=np.int64)
    hi = np.full((5, 6), 9, dtype=np.int64)
    lo[2:], hi[2:] = rng.integers(0, 4, size=(3, 6)), rng.integers(4, 9, size=(3, 6))
    want = jpruning.harsh_prune_grid(jnet, lo, hi, sim_size=128, seed=0)
    tnet = _tnet(jnet)
    got = tpruning.harsh_prune_grid(tnet, lo, hi, sim_size=128, seed=0)
    sound = tpruning.sound_prune_grid(tnet, lo, hi, 128, 0, chunk=0, mega_chunks=0)
    assert len(got) == len(want) == 3
    for g, w, c in zip(got, want, sound.candidates):
        assert g.shape == (5, w.shape[1]) and g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, c)
    assert 0 < sum(float(g.sum()) for g in got)


# --------------------------------------------------------------------------
# K7: alpha_crown_output_bounds


def _grid_points(lo, hi):
    import itertools

    axes = [np.arange(l, h + 1) for l, h in zip(lo, hi)]
    return np.array(list(itertools.product(*axes)), dtype=np.float64)


_K7_SIZES = [(3, 8, 1), (3, 6, 6, 1), (4, 10, 5, 5, 1)]


@pytest.mark.parametrize(
    "sizes,seed,mode",
    [pytest.param(z, seed, "widen", id=f"sizes{i}-{seed}")
     for seed in range(4) for i, z in enumerate(_K7_SIZES)]
    + [pytest.param(z, 0, "unwidened", id=f"sizes{i}-unwidened")
       for i, z in enumerate(_K7_SIZES)]
    + [pytest.param(z, 1, "leading axes", id=f"sizes{i}-leading-axes")
       for i, z in enumerate(_K7_SIZES)])
def test_alpha_crown_output_bounds_match_jax(sizes, seed, mode):
    rng = np.random.default_rng(100 + seed)
    ws = [rng.normal(size=(sizes[i], sizes[i + 1])).astype(np.float32)
          for i in range(len(sizes) - 1)]
    bs = [rng.normal(size=(sizes[i + 1],)).astype(np.float32)
          for i in range(len(sizes) - 1)]
    lo = np.zeros((3, sizes[0]), np.float32)
    hi = np.stack([np.full(sizes[0], 2.0), np.full(sizes[0], 1.0),
                   rng.integers(1, 3, size=sizes[0])]).astype(np.float32)
    widen = mode != "unwidened"
    jlb, jub = (np.asarray(v) for v in jcrown.alpha_crown_output_bounds(
        jmlp.from_numpy(ws, bs), jnp.asarray(lo), jnp.asarray(hi), iters=8, widen=widen))
    tnet = tmlp.from_numpy(ws, bs, device="cpu")
    T = torch.as_tensor
    if mode == "leading axes":  # (3, d) boxes as (3, 1, d): the (3, 1) bounds
        tlb, tub = tcrown.alpha_crown_output_bounds(tnet, T(lo[:, None]), T(hi[:, None]),
                                                    iters=8)
        assert tlb.shape == tub.shape == (3, 1)
        tlb, tub = tlb[:, 0], tub[:, 0]
    else:
        tlb, tub = tcrown.alpha_crown_output_bounds(tnet, T(lo), T(hi), iters=8, widen=widen)
    tlb, tub = tlb.numpy(), tub.numpy()
    clb, cub = (t.numpy() for t in tcrown.crown_output_bounds(tnet, T(lo), T(hi)))
    if not widen:  # the best α bounds unwidened: no looser than the widened ones
        wlb, wub = (t.numpy() for t in tcrown.alpha_crown_output_bounds(tnet, T(lo), T(hi),
                                                                        iters=8))
        assert (tlb >= wlb).all() and (tub <= wub).all()
    mag = np.maximum(np.abs(jlb), np.abs(jub))
    assert (np.abs(tlb - jlb) <= SOUND_SLACK_REL * mag + SOUND_SLACK_ABS).all()
    assert (np.abs(tub - jub) <= SOUND_SLACK_REL * mag + SOUND_SLACK_ABS).all()
    assert (tlb >= clb).all() and (tub <= cub).all()
    w64 = [w.astype(np.float64) for w in ws]
    for b in range(lo.shape[0]):
        f = tmlp.forward_np(w64, bs, _grid_points(lo[b], hi[b]))
        assert tlb[b] <= f.min() and tub[b] >= f.max()
    if len(sizes) > 3:  # α tightens the deeper nets somewhere
        assert ((tub - tlb) < (cub - clb)).any()
