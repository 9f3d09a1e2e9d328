"""The port's repair, localization, hybrid routing and causal audit
(``fairify_tpu_torch/analysis/{repair,localize,hybrid,causal}.py``) against
the JAX package, on the CPU, on ``tests/test_analysis.py``'s worlds.

* ``masked_repair`` (its :172 world) and ``same_label_relabel_retrain``
  (:186): weights within 1e-5 relative + 1e-6 absolute (a few hundred Adam
  steps whose per-step f32 differences are ulps, ``test_torch_train.py``),
  the histories' losses within 1e-5 relative, the frozen parameters bit
  for bit the original's.
* ``counterexample_retrain`` on the :212 and :231 worlds: weights within
  1e-5 relative + 1e-5 absolute (up to 1,200 pair steps at ``stage2_lr``
  5e-3 carry the per-step differences further; measured at most 3.8e-6
  absolute, on a bias of 39), history losses, ``val_acc`` and ``pair_inconsistency`` within
  1e-5, and ``floor_ok``, ``group_ok`` and ``selected`` equal; on :231's
  world ``repair_success`` passes on the port too.
* ``localize``, ``hybrid_predict``/``evaluate_hybrid`` and
  ``causal_discrimination``/``discrimination_search`` equal on the same
  inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairify_tpu.analysis import causal as jcausal
from fairify_tpu.analysis import experiment as jexperiment
from fairify_tpu.analysis import hybrid as jhybrid
from fairify_tpu.analysis import localize as jlocalize
from fairify_tpu.analysis import metrics as jgm
from fairify_tpu.analysis import repair as jrepair
from fairify_tpu.models import mlp as jmlp
from fairify_tpu_torch.analysis import causal as tcausal
from fairify_tpu_torch.analysis import experiment as texperiment
from fairify_tpu_torch.analysis import hybrid as thybrid
from fairify_tpu_torch.analysis import localize as tlocalize
from fairify_tpu_torch.analysis import metrics as tgm
from fairify_tpu_torch.analysis import repair as trepair
from fairify_tpu_torch.models import mlp as tmlp
from tests.test_analysis import _net_fair, _net_with_pa_neuron


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(jnet):
    return tmlp.from_numpy([np.asarray(w) for w in jnet.weights],
                           [np.asarray(b) for b in jnet.biases],
                           [np.asarray(m) for m in jnet.masks], device="cpu")


def _close_nets(tnet, jnet, rtol, atol):
    for a, b in zip(list(tnet.weights) + list(tnet.biases),
                    list(jnet.weights) + list(jnet.biases)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


def _close_history(th, jh, tol=1e-5):
    assert len(th) == len(jh)
    for a, b in zip(th, jh):
        assert a.keys() == b.keys(), (a, b)
        for k in a:
            if isinstance(a[k], float) and not isinstance(a[k], bool):
                assert a[k] == pytest.approx(b[k], rel=tol, abs=tol), (k, a, b)
            else:
                assert a[k] == b[k], (k, a, b)


def _pairs(rng, n, d=4, pa=1):
    out = []
    for _ in range(n):
        x = rng.integers(0, 4, size=d)
        xp = x.copy()
        x[pa], xp[pa] = 0, 1
        out.append((x.astype(np.float32), xp.astype(np.float32)))
    return out


def test_masked_repair_matches_jax():
    jnet = _net_with_pa_neuron()
    rng = np.random.default_rng(2)
    X = rng.integers(0, 4, size=(64, 4)).astype(np.float32)
    y = rng.integers(0, 2, size=64)
    j = jrepair.masked_repair(jnet, [(0, 3)], X, y, epochs=2, lr=1e-2)
    t = trepair.masked_repair(_port(jnet), [(0, 3)], X, y, epochs=2, lr=1e-2)
    _close_nets(t.net, j.net, 1e-5, 1e-6)
    _close_history(t.history, j.history)
    w0 = np.asarray(jnet.weights[0])
    assert np.array_equal(t.net.weights[0].numpy()[:, [0, 1, 2, 4, 5]], w0[:, [0, 1, 2, 4, 5]])
    assert np.array_equal(t.net.weights[1].numpy(), np.asarray(jnet.weights[1]))
    assert not np.array_equal(t.net.weights[0].numpy()[:, 3], w0[:, 3])


def test_same_label_relabel_retrain_matches_jax():
    jnet = _net_with_pa_neuron()
    pairs = _pairs(np.random.default_rng(5), 16)
    j = jrepair.same_label_relabel_retrain(jnet, pairs, epochs=4, lr=5e-2)
    tnet = _port(jnet)
    t = trepair.same_label_relabel_retrain(tnet, pairs, epochs=4, lr=5e-2)
    _close_nets(t.net, j.net, 1e-5, 1e-6)
    _close_history(t.history, j.history)
    assert trepair.same_label_relabel_retrain(tnet, []).net is tnet


def _floor_world():
    jnet = _net_with_pa_neuron()
    rng = np.random.default_rng(3)
    X = rng.integers(0, 4, size=(128, 4)).astype(np.float32)
    y = np.asarray(jmlp.predict(jnet, jnp.asarray(X))).astype(int)
    pairs = _pairs(rng, 8)
    return jnet, X, y, pairs, dict(stage1_epochs=1, stage2_epochs=2), None


def _success_world():
    ws = [np.array([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]], dtype=np.float32),
          np.array([[1.0], [2.5]], dtype=np.float32)]
    bs = [np.array([10.0, 10.0], dtype=np.float32), np.array([-38.5], dtype=np.float32)]
    jnet = jmlp.from_numpy(ws, bs)
    rng = np.random.default_rng(7)
    X = np.stack([rng.integers(0, 9, 600), rng.integers(0, 2, 600),
                  rng.integers(0, 5, 600)], axis=1).astype(np.float32)
    y = (X[:, 0] >= 4).astype(int)
    pairs = []
    for _ in range(400):
        x = np.array([rng.integers(0, 9), 0, rng.integers(0, 5)], np.float32)
        xp = x.copy()
        xp[1] = 1
        if jmlp.predict_np(ws, bs, x[None])[0] != jmlp.predict_np(ws, bs, xp[None])[0]:
            pairs.append((x, xp))
    return jnet, X, y, pairs, dict(stage1_epochs=2, stage2_epochs=8, protected_col=1), (
        np.array([0, 0, 0], np.int64), np.array([8, 1, 4], np.int64))


@pytest.mark.parametrize("world", [_floor_world, _success_world],
                         ids=["floor", "success-criteria"])
def test_counterexample_retrain_matches_jax(world):
    jnet, X, y, pairs, kw, box = world()
    j = jrepair.counterexample_retrain(jnet, X, y, pairs, X, y, seed=0, **kw)
    tnet = _port(jnet)
    t = trepair.counterexample_retrain(tnet, X, y, pairs, X, y, seed=0, **kw)
    _close_nets(t.net, j.net, 1e-5, 1e-5)
    _close_history(t.history, j.history)
    assert [h.get("selected") for h in t.history] == [h.get("selected") for h in j.history]
    if box is None:
        return
    prot = X[:, 1]
    metrics, rates = {}, {}
    for name, m in (("original", tnet), ("fairer", t.net)):
        pred = tmlp.predict_rows(m, X).astype(int)
        metrics[name] = tgm.group_report(X, y, pred, prot).as_dict()
        rates[name] = tcausal.causal_discrimination(
            lambda Z, n=m: tmlp.predict_rows(n, Z), box[0], box[1], 1, min_samples=200,
            max_samples=2000).rate
    success = texperiment.repair_success(metrics, rates)
    assert success["passed"], (success, metrics, rates)
    assert success == jexperiment.repair_success(metrics, rates)
    assert rates["fairer"] < 0.5 * max(rates["original"], 1e-9)
    jpred = np.asarray(jmlp.predict(j.net, jnp.asarray(X))).astype(int)
    assert np.array_equal(tmlp.predict_rows(t.net, X).astype(int), jpred)


def test_localize_matches_jax():
    jnet = _net_with_pa_neuron()
    rng = np.random.default_rng(1)
    pairs = [(p[0].astype(np.int64), p[1].astype(np.int64)) for p in _pairs(rng, 20)]
    pairs.append((np.array([0, 0, 0, 0]), np.array([1, 1, 0, 0])))  # off-PA: skipped
    j = jlocalize.localize(jnet, pairs, pa_idx=[1], top_k=5)
    t = tlocalize.localize(_port(jnet), pairs, pa_idx=[1], top_k=5)
    assert t.skipped_pairs == j.skipped_pairs == 1
    assert [r[:2] for r in t.ranked] == [r[:2] for r in j.ranked]
    np.testing.assert_allclose([r[2] for r in t.ranked], [r[2] for r in j.ranked], rtol=1e-6)
    for a, b in zip(t.scores, j.scores):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    empty = tlocalize.localize(_port(jnet), pairs[-1:], pa_idx=[1])
    assert empty.ranked == [] and [s.shape for s in empty.scores] == [(6,), (1,)]
    assert tlocalize.global_index_map([3, 2]) == jlocalize.global_index_map([3, 2])


def test_hybrid_matches_jax():
    rng = np.random.default_rng(5)
    d = 3
    jorig = jmlp.from_numpy([rng.normal(size=(d, 5)).astype(np.float32),
                             rng.normal(size=(5, 1)).astype(np.float32)],
                            [rng.normal(size=5).astype(np.float32),
                             np.zeros(1, np.float32)])
    jfair = _net_fair(d)
    lo = np.array([[0, 0, 0], [5, 0, 0], [0, 5, 0]])
    hi = np.array([[4, 9, 9], [9, 9, 9], [4, 9, 9]])
    verdicts = ["sat", "unsat", "sat"]
    X = rng.integers(0, 12, size=(200, d))
    y = rng.integers(0, 2, size=200)
    jr = jhybrid.hybrid_predict(X, jorig, jfair, lo, hi, verdicts)
    tr = thybrid.hybrid_predict(X, _port(jorig), _port(jfair), lo, hi, verdicts)
    assert np.array_equal(tr.predictions, jr.predictions)
    assert (tr.routed_fair, tr.routed_original, tr.routed_miss) == (
        jr.routed_fair, jr.routed_original, jr.routed_miss)
    assert np.array_equal(thybrid.route_points(X, lo, hi, verdicts),
                          jhybrid.route_points(X, lo, hi, verdicts))
    jm, _ = jhybrid.evaluate_hybrid(X, y, 1, jorig, jfair, lo, hi, verdicts)
    tm, _ = thybrid.evaluate_hybrid(X, y, 1, _port(jorig), _port(jfair), lo, hi, verdicts)
    assert tm == jm


def test_causal_matches_jax():
    jnet = _net_with_pa_neuron()
    tnet = _port(jnet)
    lo, hi = np.zeros(4, np.int64), np.array([3, 1, 3, 3], np.int64)
    jpred = lambda Z: np.asarray(jmlp.predict(jnet, jnp.asarray(Z, jnp.float32)))
    tpred = lambda Z: tmlp.predict_rows(tnet, Z)
    for kw in (dict(max_samples=1500), dict(max_samples=700, batch_size=128)):
        j = jcausal.causal_discrimination(jpred, lo, hi, 1, **kw)
        t = tcausal.causal_discrimination(tpred, lo, hi, 1, **kw)
        assert (t.rate, t.tested, t.discriminatory, t.interval) == (
            j.rate, j.tested, j.discriminatory, j.interval)
        assert all(np.array_equal(a, b) for a, b in zip(t.examples, j.examples))
    js = jcausal.discrimination_search(jpred, lo, [3, 1, 3, 3], [0, 1], max_samples=400)
    ts = tcausal.discrimination_search(tpred, lo, [3, 1, 3, 3], [0, 1], max_samples=400)
    assert {k: (v.rate, v.tested) for k, v in ts.items()} == {
        k: (v.rate, v.tested) for k, v in js.items()}
    with pytest.raises(ValueError, match="max_combos"):
        tcausal.causal_discrimination(tpred, lo, hi, (0, 2), max_combos=4)
    assert jgm.disparate_impact(np.array([1, 0]), np.array([1, 0])) == tgm.disparate_impact(
        np.array([1, 0]), np.array([1, 0]))
