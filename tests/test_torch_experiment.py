"""The port's experiment pipeline (``fairify_tpu_torch/analysis/experiment.py``)
against the JAX package, on the CPU, on ``tests/test_experiment.py``'s
``tinyexp`` world (a 4-attribute integer domain, 200 rows), with the
biased PA-carrier net and the fair net of ``tests/test_analysis.py``.

* The first sweep's counts and verdict rows, the counterexample pairs and
  the localization (ranking equal, scores within 1e-6 relative) are equal.
* The repaired weights, for ``repair_mode`` "masked" and "both": the
  masked repair's within 1e-5 relative + 1e-6 absolute (15 Adam steps
  whose per-step f32 differences are ulps, ``tests/test_torch_train.py``);
  "both" chains it into ``counterexample_retrain``, whose hundreds of pair
  steps carry those differences further, so 1e-5 relative + 1e-5 absolute
  (the tolerance of ``tests/test_torch_repair.py``'s retrain tests).
* Both packages re-verify and audit the same weights: the JAX package's
  repaired net, carried into the port (``experiment.audit``), gives JAX's
  ``fairer_verdicts``, ``routing``, ``metrics``, ``causal_rates`` and
  ``success`` exactly.
* The fair net: nothing to repair, the same result in both.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from fairify_tpu.analysis import experiment as jexperiment
from fairify_tpu.data import domains as jdom
from fairify_tpu.data import loaders as jloaders
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify.config import SweepConfig as JSweepConfig
from fairify_tpu_torch.analysis import experiment as texperiment
from fairify_tpu_torch.data import domains as tdom
from fairify_tpu_torch.data import loaders as tloaders
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.verify.config import EngineConfig as TEngineConfig
from fairify_tpu_torch.verify.config import SweepConfig as TSweepConfig
from tests.test_analysis import _net_fair, _net_with_pa_neuron

RANGES = {"a": (0, 3), "pa": (0, 1), "b": (0, 3), "c": (0, 3)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def tiny(monkeypatch, tmp_path):
    monkeypatch.setitem(jdom.DOMAINS, "tinyexp",
                        jdom.DomainSpec(name="tinyexp", label="y", ranges=RANGES))
    monkeypatch.setitem(tdom.DOMAINS, "tinyexp",
                        tdom.DomainSpec(name="tinyexp", label="y", ranges=RANGES))
    rng = np.random.default_rng(0)
    X = rng.integers(0, 4, size=(200, 4)).astype(np.float64)
    y = (X[:, 0] > 1).astype(int)
    df = pd.DataFrame(X, columns=list(RANGES))
    df["y"] = y
    jds = jloaders.LoadedDataset("tinyexp", df, X[:150], y[:150], X[150:], y[150:], "y")
    frame = {c: X[:, i] for i, c in enumerate(RANGES)}
    frame["y"] = y
    tds = tloaders.LoadedDataset("tinyexp", frame, X[:150], y[:150], X[150:], y[150:], "y")
    kw = dict(name="tinyexp", dataset="tinyexp", protected=("pa",), partition_threshold=4,
              sim_size=64, soft_timeout_s=20.0, hard_timeout_s=300.0)
    eng = dict(frontier_size=64, attack_samples=32, bab_attack_samples=8, soft_timeout_s=20.0)
    jcfg = JSweepConfig(result_dir=str(tmp_path / "jax"), engine=jengine.EngineConfig(**eng),
                        **kw)
    tcfg = TSweepConfig(result_dir=str(tmp_path / "port"), engine=TEngineConfig(**eng), **kw)
    return jds, jcfg, tds, tcfg, tmp_path


def _port(jnet):
    return tmlp.from_numpy([np.asarray(w) for w in jnet.weights],
                           [np.asarray(b) for b in jnet.biases],
                           [np.asarray(m) for m in jnet.masks], device="cpu")


def _rows(report):
    return [(o.partition_id, o.verdict) for o in report.outcomes]


def _same_first_sweep(t, j):
    assert t.report.counts == j.report.counts
    assert _rows(t.report) == _rows(j.report)
    assert len(t.ce_pairs) == len(j.ce_pairs)
    for (a, ap), (b, bp) in zip(t.ce_pairs, j.ce_pairs):
        assert np.array_equal(a, b) and np.array_equal(ap, bp)


def _biased_matches_jax(tiny, mode, atol):
    jds, jcfg, tds, tcfg, tmp = tiny
    jnet = _net_with_pa_neuron(d=4, h=6, pa=1, carrier=3)
    j = jexperiment.run_experiment(jnet, jcfg, "tiny-biased", dataset=jds,
                                   repair_mode=mode, causal_samples=600)
    tnet = _port(jnet)
    t = texperiment.run_experiment(tnet, tcfg, "tiny-biased", dataset=tds,
                                   repair_mode=mode, causal_samples=600, device="cpu")
    _same_first_sweep(t, j)
    assert j.report.counts["sat"] >= 1
    assert [r[:2] for r in t.localization.ranked] == [r[:2] for r in j.localization.ranked]
    assert t.localization.ranked[0][:2] == (0, 3)
    np.testing.assert_allclose([r[2] for r in t.localization.ranked],
                               [r[2] for r in j.localization.ranked], rtol=1e-6)
    assert t.fairer_net is not tnet and len(t.repair_history["masked"]) == 3
    assert ("retrain" in t.repair_history) == (mode == "both")
    for a, b in zip(list(t.fairer_net.weights) + list(t.fairer_net.biases),
                    list(j.fairer_net.weights) + list(j.fairer_net.biases)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=atol)
    # Re-verify and audit the JAX package's repaired weights in the port.
    out = texperiment.audit(tnet, _port(j.fairer_net),
                            tcfg.with_(result_dir=str(tmp / "carried")), "tiny-biased", tds,
                            t.report, causal_samples=600, device="cpu")
    assert out["fairer_verdicts"] == j.fairer_verdicts
    assert out["routing"] == j.routing
    assert out["metrics"] == j.metrics
    assert out["causal_rates"] == j.causal_rates
    assert texperiment.repair_success(out["metrics"], out["causal_rates"]) == j.success


def test_experiment_biased_matches_jax(tiny):
    _biased_matches_jax(tiny, "masked", 1e-6)


def test_experiment_both_matches_jax(tiny):
    _biased_matches_jax(tiny, "both", 1e-5)


def test_experiment_fair_matches_jax(tiny):
    jds, jcfg, tds, tcfg, _ = tiny
    jnet = _net_fair(4)
    j = jexperiment.run_experiment(jnet, jcfg, "tiny-fair", dataset=jds,
                                   repair_mode="masked", causal_samples=400)
    tnet = _port(jnet)
    t = texperiment.run_experiment(tnet, tcfg, "tiny-fair", dataset=tds,
                                   repair_mode="masked", causal_samples=400, device="cpu")
    _same_first_sweep(t, j)
    assert t.report.counts["unsat"] == t.report.partitions_total
    assert t.fairer_net is tnet and t.localization is None and t.success is None
    assert t.fairer_verdicts is None is j.fairer_verdicts
    assert (t.routing, t.metrics, t.causal_rates) == (j.routing, j.metrics, j.causal_rates)
