"""The port's ``run_sweep`` and the rest of ``verify_model``'s signature
against the JAX package's, on the CPU.

* ``data.loaders``: every loader of ``LOADERS`` on a synthetic file written
  in its format from a seed gives the JAX loader's ``X_train``, ``y_train``,
  ``X_test`` and ``y_test`` exactly (the JAX loaders read with pandas and
  encode with sklearn; the port's with numpy and ``csv``).
* ``analysis.metrics``: the consistency's neighbours equal sklearn's.
* ``models.zoo.load_matching``: a root of ``.h5`` files for JAX and their
  ``.npz`` exports for the port gives the same nets and skips the same
  mismatched one; where both formats name a net the port takes the ``.npz``.
* ``run_sweep``: a stacked two-net 20-8-1 family on a shrunk GC domain with a
  synthetic German file and ``partition_metrics`` on — reports (original
  accuracy included), ledgers, CSVs, counterexample files and metrics CSVs
  (to 1e-6) equal to JAX's.
* ``verify_model``'s and ``run_sweep``'s parameters: JAX's, in JAX's order
  and with its defaults, then ``device``.
* ``host_slice`` at host counts 1, 2 and 3; ``verify_model`` with
  ``host_index``/``host_count`` (the union of the hosts' ledgers is the whole
  run's) and ``sink_name``; ``retry_unknown`` (one CSV row per partition,
  equal to JAX's); ``n_shards`` and the argument errors.
"""
import csv
import json
import os

import h5py
import numpy as np
import pytest
import torch

from chip_smoke import write_german
from fairify_tpu.data import loaders as jloaders
from fairify_tpu.data.domains import get_domain
from fairify_tpu.models import zoo as jzoo
from fairify_tpu.parallel import multihost as jmultihost
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.data import loaders
from fairify_tpu_torch.models import ingest
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.models import zoo
from fairify_tpu_torch.parallel import multihost
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig

TIME_COLUMNS = {"SV-time", "S-time", "HV-Time", "H-Time", "Total-Time"}
TAIL = dict(sign_bab=False, lp_sign=False, lp_pair=False, lattice_exhaustive=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Synthetic data files, one writer per loader format
# ---------------------------------------------------------------------------


def _pick(rng, values, n, missing=None, share=0.05):
    out = [values[i] for i in rng.integers(len(values), size=n)]
    if missing is not None:
        for i in np.flatnonzero(rng.random(n) < share):
            out[i] = missing
    return out


_ADULT = dict(
    workclass=["Private", "Self-emp-not-inc", "Self-emp-inc", "Local-gov", "State-gov",
               "Federal-gov", "Without-pay", "Never-worked"],
    education=["Bachelors", "HS-grad", "11th", "10th", "9th", "12th", "1st-4th", "5th-6th",
               "7th-8th", "Masters", "Doctorate", "Assoc-acdm", "Assoc-voc", "Preschool",
               "Prof-school", "Some-college"],
    marital=["Married-civ-spouse", "Never-married", "Divorced", "Separated", "Widowed",
             "Married-spouse-absent", "Married-AF-spouse"],
    occupation=["Adm-clerical", "Armed-Forces", "Craft-repair", "Exec-managerial",
                "Farming-fishing", "Handlers-cleaners", "Machine-op-inspct", "Priv-house-serv",
                "Prof-specialty", "Protective-serv", "Sales", "Tech-support",
                "Transport-moving", "Other-service"],
    relationship=["Husband", "Not-in-family", "Other-relative", "Own-child", "Unmarried",
                  "Wife"],
    race=["White", "Black", "Asian-Pac-Islander", "Amer-Indian-Eskimo", "Other"],
    country=["United-States", "Mexico", "Philippines", "Germany", "India"])


def _adult_rows(rng, n, test):
    A = _ADULT
    # Capital gain: the range 0-20,000 puts bin edges on multiples of 1,000,
    # and rows on those edges exercise the discretizer's side of the edge.
    gain = rng.choice([0, 0, 0, 1000, 2000, 3000, 5178, 7688, 14084, 20000], size=n)
    loss = rng.choice([0, 0, 0, 1902, 1977, 2415, 1740, 3900], size=n)
    cols = [rng.integers(17, 90, n), _pick(rng, A["workclass"], n, "?"),
            rng.integers(20000, 900000, n), _pick(rng, A["education"], n),
            rng.integers(1, 16, n), _pick(rng, A["marital"], n),
            _pick(rng, A["occupation"], n, "?"), _pick(rng, A["relationship"], n),
            _pick(rng, A["race"], n), _pick(rng, ["Male", "Female"], n), gain, loss,
            rng.integers(1, 99, n), _pick(rng, A["country"], n, "?"),
            _pick(rng, [">50K." if test else ">50K", "<=50K." if test else "<=50K"], n)]
    return [", ".join(str(c[i]) for c in cols) for i in range(n)]


def _write_adult(root, rng):
    d = root / "adult"
    d.mkdir()
    (d / "adult.data").write_text("\n".join(_adult_rows(rng, 160, False)) + "\n\n")
    (d / "adult.test").write_text("|1x3 Cross validator\n"
                                  + "\n".join(_adult_rows(rng, 60, True)) + "\n")


def _write_csv(path, header, rows, sep=",", quote=False):
    path.parent.mkdir(exist_ok=True)
    with open(path, "w", newline="") as fp:
        wr = csv.writer(fp, delimiter=sep,
                        quoting=csv.QUOTE_NONNUMERIC if quote else csv.QUOTE_MINIMAL)
        wr.writerow(header)
        wr.writerows(rows)


def _write_bank(root, rng):
    n = 150
    jobs = ["admin.", "blue-collar", "technician", "services", "management", "retired",
            "unknown"]
    cols = {
        "age": rng.integers(18, 90, n), "job": _pick(rng, jobs, n),
        "marital": _pick(rng, ["married", "single", "divorced"], n, "unknown"),
        "education": _pick(rng, ["basic.4y", "high.school", "university.degree",
                                 "professional.course"], n, "unknown"),
        "default": _pick(rng, ["no", "yes"], n, "unknown", 0.02),
        "housing": _pick(rng, ["no", "yes"], n), "loan": _pick(rng, ["no", "yes"], n),
        "contact": _pick(rng, ["cellular", "telephone"], n),
        "month": _pick(rng, ["may", "jun", "jul", "aug", "nov"], n),
        "day_of_week": _pick(rng, ["mon", "tue", "wed", "thu", "fri"], n),
        "duration": rng.integers(0, 3000, n), "campaign": rng.integers(1, 20, n),
        "pdays": rng.choice([999, 3, 6], n), "previous": rng.integers(0, 3, n),
        "poutcome": _pick(rng, ["nonexistent", "failure", "success"], n),
        "emp.var.rate": rng.choice([1.1, 1.4, -0.1, -1.8, -2.9], n),
        "cons.price.idx": rng.choice([93.994, 94.465, 92.893], n),
        "cons.conf.idx": rng.choice([-36.4, -41.8, -46.2], n),
        "euribor3m": rng.choice([4.857, 1.313, 0.644], n),
        "nr.employed": rng.choice([5191.0, 5099.1, 5228.1], n),
        "y": _pick(rng, ["no", "yes"], n)}
    rows = [[(v[i].item() if hasattr(v[i], "item") else v[i]) for v in cols.values()]
            for i in range(n)]
    # Strings quoted, numbers bare, ';' between fields: the UCI file's layout.
    _write_csv(root / "bank" / "bank-additional.csv", list(cols), rows, sep=";", quote=True)


def _write_compass(root, rng):
    n = 140
    rows = [[int(rng.integers(2)), int(rng.integers(0, 12)), int(rng.integers(2)),
             str(_pick(rng, ["Greater than 45", "25 - 45", "Less than 25"], 1)[0]),
             str(_pick(rng, ["African-American", "Caucasian", "Hispanic", "Other"], 1)[0]),
             int(rng.integers(2)), int(rng.integers(2))] for _ in range(n)]
    _write_csv(root / "compass" / "compas_preprocessed_full.csv",
               ["Two_yr_Recidivism", "Number_of_Priors", "score_factor", "Age", "Race",
                "Female", "Misdemeanor"], rows)
    header = [f"f{i}" for i in range(12)] + ["label"]
    rows12 = rng.integers(0, 9, size=(n, 13))
    rows12[:, -1] %= 2
    _write_csv(root / "compass" / "compass.csv", header, rows12.tolist())


def _write_default(root, rng):
    n = 130
    header = (["ID", "LIMIT_BAL", "SEX", "EDUCATION", "MARRIAGE", "AGE", "PAY_0"]
              + [f"PAY_{i}" for i in range(2, 7)] + [f"BILL_AMT{i}" for i in range(1, 7)]
              + [f"PAY_AMT{i}" for i in range(1, 7)] + ["default.payment.next.month"])
    rows = []
    for i in range(n):
        pays = [int(v) for v in rng.integers(-2, 9, 6)]
        pays[-1] = 0  # a constant column: MinMaxScaler maps it to 0
        rows.append([i + 1, int(rng.integers(1, 50)) * 10000, int(rng.integers(1, 3)),
                     int(rng.integers(0, 7)), int(rng.integers(0, 4)),
                     int(rng.integers(21, 75))] + pays
                    + [int(v) for v in rng.integers(-1000, 90000, 12)] + [int(rng.integers(2))])
    _write_csv(root / "default" / "default.csv", header, rows)


def _write_lsac(root, rng):
    n = 150
    header = ["decile1b", "decile3", "lsat", "ugpa", "fulltime", "fam_inc", "male", "race1",
              "tier", "zfygpa", "pass_bar"]
    rows = []
    for _ in range(n):
        row = [float(rng.integers(1, 11)), float(rng.integers(1, 11)),
               float(rng.integers(22, 96)) / 2.0, float(rng.choice([3.15, 2.85, 3.5, 3.9, 2.05])),
               float(rng.integers(1, 3)), float(rng.integers(1, 6)), float(rng.integers(2)),
               str(_pick(rng, ["white", "black", "hisp", "asian", "other"], 1)[0]),
               float(rng.integers(1, 7)), float(rng.normal()), float(rng.integers(2))]
        if rng.random() < 0.05:
            row[int(rng.integers(0, 9))] = ""  # a missing value: the row drops
        rows.append(row)
    _write_csv(root / "lsac" / "lsac.csv", header, rows)


def _write_data(root, name, seed):
    rng = np.random.default_rng(seed)
    if name == "german":
        write_german(str(root / "german" / "german.data"), 160, seed)
    elif name in ("adult", "adult_adf", "adult_onehot"):
        _write_adult(root, rng)
    elif name == "bank":
        _write_bank(root, rng)
    elif name in ("compass", "compass12"):
        _write_compass(root, rng)
    elif name == "default":
        _write_default(root, rng)
    else:
        _write_lsac(root, rng)


@pytest.mark.parametrize("name", sorted(loaders.LOADERS))
def test_loader_equals_jax(tmp_path, name):
    assert set(loaders.LOADERS) == set(jloaders.LOADERS)
    _write_data(tmp_path, name, seed=len(name))
    got = loaders.load(name, root=str(tmp_path), cache=False)
    want = jloaders.load(name, root=str(tmp_path), cache=False)
    for key in ("X_train", "y_train", "X_test", "y_test"):
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert got.label == want.label and got.notes == want.notes
    assert got.feature_columns == [str(c) for c in want.feature_columns]
    np.testing.assert_array_equal(got.X, want.X)
    assert got.X_test.shape[0] == int(np.ceil(0.15 * got.X.shape[0]))
    if name == "adult":  # the discretized columns' bin edges are sklearn's
        for f in ("capital-gain", "capital-loss"):
            np.testing.assert_array_equal(got.encoders[f], want.encoders[f].bin_edges_[0])


def test_consistency_neighbors_equal_sklearn():
    from sklearn.neighbors import NearestNeighbors

    from fairify_tpu.analysis import metrics as jmetrics
    from fairify_tpu_torch.analysis import metrics

    rng = np.random.default_rng(0)
    X = np.concatenate([rng.integers(0, 50, size=(300, 6)),
                        rng.integers(250, 18000, size=(300, 1))], axis=1).astype(np.float64)
    idx = NearestNeighbors(n_neighbors=5).fit(X).kneighbors(X)[1]
    got = metrics.nearest_neighbors(X, 5, block=37)
    assert (np.sort(got, axis=1) == np.sort(idx, axis=1)).all() and (got[:, 0] == np.arange(300)).all()
    y = rng.integers(0, 2, 300)
    assert metrics.consistency(X, y) == jmetrics.consistency(X, y)


# ---------------------------------------------------------------------------
# The zoo
# ---------------------------------------------------------------------------


def _write_h5(path, weights, biases):
    """A Keras-style Dense-only file (the layout ``load_keras_h5`` reads)."""
    layers = [{"class_name": "Dense",
               "config": {"name": f"d{i}", "units": int(w.shape[1]),
                          "activation": "relu" if i < len(weights) - 1 else "sigmoid"}}
              for i, w in enumerate(weights)]
    cfg = {"class_name": "Sequential", "config": {"name": "s", "layers": layers}}
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg).encode()
        mw = f.create_group("model_weights")
        for i, (w, b) in enumerate(zip(weights, biases)):
            g = mw.create_group(f"d{i}").create_group(f"d{i}")
            g["kernel:0"] = w
            g["bias:0"] = b


def _params(sizes, seed):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=0.8, size=(sizes[i], sizes[i + 1])).astype(np.float32)
          for i in range(len(sizes) - 1)]
    bs = [rng.normal(scale=0.2, size=(sizes[i + 1],)).astype(np.float32)
          for i in range(len(sizes) - 1)]
    return ws, bs


def _model_root(root, nets, npz=True, h5=True):
    d = root / "german"
    d.mkdir(parents=True)
    for name, (ws, bs) in nets.items():
        if h5:
            _write_h5(d / f"{name}.h5", ws, bs)
        if npz:
            ingest.save_npz((ws, bs), d / f"{name}.npz")
    return root


def test_zoo_load_matching_equals_jax(tmp_path):
    nets = {"GC-1": _params((20, 8, 1), 1), "GC-2": _params((20, 8, 1), 2),
            "GC-10": _params((20, 6, 4, 1), 3), "GC-3": _params((12, 8, 1), 4)}
    h5_root = _model_root(tmp_path / "h5", nets, npz=False)
    npz_root = _model_root(tmp_path / "npz", nets, h5=False)
    jnets, jskipped = jzoo.load_matching("german", 20, root=str(h5_root))
    for root in (h5_root, npz_root):
        tnets, tskipped = zoo.load_matching("german", 20, root=str(root), device="cpu")
        assert list(tnets) == list(jnets) == ["GC-1", "GC-2", "GC-10"]
        assert tskipped == jskipped == ["GC-3"]
        for name in tnets:
            w, b = tnets[name].numpy_params()
            for a, c in zip(w + b, list(jnets[name].weights) + list(jnets[name].biases)):
                np.testing.assert_array_equal(a, np.asarray(c))
    sel, _ = zoo.load_matching("german", 20, models=("GC-2",), root=str(npz_root), device="cpu")
    assert list(sel) == ["GC-2"]
    # Both formats name GC-1: the .npz is taken, even when the .h5 differs.
    other = _params((20, 8, 1), 9)
    ingest.save_npz(other, h5_root / "german" / "GC-1.npz")
    assert [p.suffix for p in zoo.model_paths("german", root=str(h5_root))] == \
        [".npz", ".h5", ".h5", ".h5"]
    w, _b = zoo.load("german", "GC-1", root=str(h5_root), device="cpu").numpy_params()
    np.testing.assert_array_equal(w[0], other[0][0])


# ---------------------------------------------------------------------------
# run_sweep and verify_model's signature
# ---------------------------------------------------------------------------

SPAN_DOMAIN = dict(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2),
                   status=(0, 2), savings=(0, 1))


def _cfgs(tmp_path, tag, **kw):
    ov = {c: (0, 0) for c in get_domain("german").columns}
    ov.update(SPAN_DOMAIN)
    base = dict(soft_timeout_s=10.0, hard_timeout_s=600.0, sim_size=16,
                exact_certify_masks=False, grid_chunk=16, domain_overrides=ov,
                partition_threshold=2, partition_metrics=True)
    base.update(kw)
    ekw = dict(attack_samples=4, bab_frontier_cap=64, max_nodes=1, **TAIL)
    return (jpresets.get("GC").with_(result_dir=str(tmp_path / f"jax-{tag}"),
                                     engine=jengine.EngineConfig(**ekw), **base),
            tpresets.get("GC").with_(result_dir=str(tmp_path / f"torch-{tag}"),
                                     engine=EngineConfig(**ekw), **base))


def _sinks(cfg, rep, metrics=True):
    """A report's outputs: rows, ledger, CSV (less time columns), the
    counterexample file and the metrics CSV (as floats)."""
    d, sink = cfg.result_dir, rep.sink_name

    def read_csv(path):
        with open(path, newline="") as fp:
            return list(csv.reader(fp))

    with open(os.path.join(d, f"{cfg.name}-{sink}.ledger.jsonl")) as fp:
        ledger = [{k: v for k, v in json.loads(line).items()
                   if k not in ("time_s", "_crc", "engine_reason")} for line in fp]
    rows = read_csv(os.path.join(d, f"{sink}.csv"))
    keep = [i for i, c in enumerate(rows[0]) if c not in TIME_COLUMNS]
    ce_path = os.path.join(d, f"{sink}-counterexamples.csv")
    out = {"model": rep.model, "sink": sink, "counts": rep.counts,
           "rows": [(o.partition_id, o.verdict, None if o.counterexample is None
                     else [c.tolist() for c in o.counterexample]) for o in rep.outcomes],
           "ledger": ledger, "csv": [[r[i] for i in keep] for r in rows],
           "ce": read_csv(ce_path) if os.path.exists(ce_path) else None}
    if metrics:
        m = read_csv(os.path.join(d, f"{sink}-metrics.csv"))
        out["metrics_header"] = m[0]
        out["metrics"] = np.array([[float(v) for v in r] for r in m[1:]])
    return out


def _same(got, want):
    gm, wm = got.pop("metrics", None), want.pop("metrics", None)
    assert got == want
    if gm is not None or wm is not None:
        # A group metric may be inf or nan (an empty group) in both.
        np.testing.assert_allclose(gm, wm, rtol=0.0, atol=1e-6, equal_nan=True)


def _orig_acc_excused(jnet_params, X_test):
    """Test rows whose f64 logit lies within 1e-5 of 0: the only rows on
    which two f32 forwards may decide differently."""
    logit = tmlp.forward_np(*jnet_params, X_test)
    return np.flatnonzero(np.abs(logit) < 1e-5)


def test_run_sweep_family_equals_jax(tmp_path):
    data = tmp_path / "data"
    write_german(str(data / "german" / "german.data"), 300, seed=7)
    nets = {"GC-1": _params((20, 8, 1), 11), "GC-2": _params((20, 8, 1), 12)}
    root = _model_root(tmp_path / "models", nets)  # .h5 for JAX, .npz for the port
    jcfg, tcfg = _cfgs(tmp_path, "family")
    jreps = jsweep.run_sweep(jcfg, model_root=str(root), data_root=str(data))
    treps = tsweep.run_sweep(tcfg, model_root=str(root), data_root=str(data), device="cpu")
    assert [r.model for r in treps] == [r.model for r in jreps] == ["GC-1", "GC-2"]
    ds = loaders.load("german", root=str(data))
    for tr, jr in zip(treps, jreps):
        excused = _orig_acc_excused(nets[tr.model], ds.X_test)
        print(f"{tr.model}: orig_acc port {tr.original_acc} JAX {jr.original_acc}; "
              f"test rows within 1e-5 of logit 0: {excused.tolist()}")
        assert abs(tr.original_acc - jr.original_acc) <= len(excused) / len(ds.y_test)
        _same(_sinks(tcfg, tr), _sinks(jcfg, jr))
        assert tr.funnel["states"] == jr.funnel["states"]
    # The family's stage 0 was forwarded: a solo verify_model gives the rows.
    solo = tsweep.verify_model(tmlp.from_numpy(*nets["GC-1"], device="cpu"),
                               tcfg.with_(result_dir=str(tmp_path / "solo")), model_name="GC-1",
                               dataset=ds, resume=False, device="cpu")
    assert [(o.partition_id, o.verdict) for o in solo.outcomes] == \
        [(o.partition_id, o.verdict) for o in treps[0].outcomes]
    assert solo.original_acc == treps[0].original_acc


@pytest.mark.parametrize("name", ["verify_model", "run_sweep"])
def test_signature_is_jax_then_device(name):
    import inspect

    got = list(inspect.signature(getattr(tsweep, name)).parameters.items())
    want = list(inspect.signature(getattr(jsweep, name)).parameters.items())
    assert [k for k, _ in got] == [k for k, _ in want] + ["device"]
    assert [v.default for _, v in got[:-1]] == [v.default for _, v in want]


@pytest.mark.parametrize("count", [1, 2, 3])
def test_host_slice_equals_jax(count):
    for n in (0, 7, 18, 201):
        spans = [multihost.host_slice(n, i, count) for i in range(count)]
        assert spans == [jmultihost.host_slice(n, i, count) for i in range(count)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # No process group: this process is host 0 of 1.
    assert multihost.host_slice(18) == (0, 18)


def test_host_slices_and_sink_name(tmp_path):
    jcfg, tcfg = _cfgs(tmp_path, "hosts", partition_metrics=False)
    net = tmlp.from_numpy(*_params((20, 8, 1), 11), device="cpu")
    whole = tsweep.verify_model(net, tcfg, model_name="m", resume=False, device="cpu")
    union = {}
    for i in range(2):
        rep = tsweep.verify_model(net, tcfg, model_name="m", resume=False, device="cpu",
                                  host_index=i, host_count=2)
        start, stop = multihost.host_slice(whole.partitions_total, i, 2)
        assert rep.sink_name == f"m@{start}-{stop}"
        with open(tsweep.ledger_path(tcfg, rep.sink_name)) as fp:
            union.update({r["partition_id"]: r["verdict"] for r in map(json.loads, fp)})
    assert union == {o.partition_id: o.verdict for o in whole.outcomes}
    # More hosts than partitions: an empty but valid span.
    empty = tsweep.verify_model(net, tcfg, model_name="m", device="cpu",
                                partition_span=(5, 5))
    assert empty.partitions_total == 0 and empty.outcomes == []
    rep = tsweep.verify_model(net, tcfg, model_name="m", resume=False, device="cpu",
                              partition_span=(0, 6), sink_name="pinned")
    assert rep.sink_name == "pinned"
    assert os.path.exists(tsweep.ledger_path(tcfg, "pinned"))
    assert os.path.exists(os.path.join(tcfg.result_dir, "pinned.csv"))


def test_retry_unknown_equals_jax(tmp_path):
    from fairify_tpu.models.train import init_mlp

    data = tmp_path / "data"
    write_german(str(data / "german" / "german.data"), 200, seed=3)
    jcfg, tcfg = _cfgs(tmp_path, "retry")
    # Every root of this world stays unknown after the BaB (max_nodes=1).
    jnet = init_mlp((20, 4, 1), seed=3)
    tnet = tmlp.init_mlp((20, 4, 1), seed=3, device="cpu")
    jds, tds = (m.load("german", root=str(data), cache=False) for m in (jloaders, loaders))
    span = (0, 8)
    outs = []
    for first in (True, False):
        jr = jsweep.verify_model(jnet, jcfg, model_name="m", dataset=jds, resume=first,
                                 retry_unknown=not first, partition_span=span)
        tr = tsweep.verify_model(tnet, tcfg, model_name="m", dataset=tds, resume=first,
                                 retry_unknown=not first, partition_span=span, device="cpu")
        got, want = _sinks(tcfg, tr), _sinks(jcfg, jr)
        outs.append(got["csv"])
        _same(got, want)
    assert "unknown" in {r[1] for r in outs[0][1:]}
    # One row per partition, ascending, after the retry.
    assert [r[0] for r in outs[1][1:]] == [str(p) for p in range(1, 9)]
    with open(tsweep.ledger_path(tcfg, "m@0-8")) as fp:
        assert len(fp.readlines()) > 8  # the retried rows were appended


def test_run_sweep_errors(tmp_path):
    _jcfg, tcfg = _cfgs(tmp_path, "err")
    with pytest.raises(NotImplementedError, match="item 7"):
        tsweep.run_sweep(tcfg, n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tsweep.run_sweep(tcfg, n_shards=2, host_count=2, device="cpu")
    with pytest.raises(ValueError, match="retry_unknown"):
        tsweep.run_sweep(tcfg, n_shards=2, retry_unknown=True, device="cpu")
    for mod, cfg in ((jsweep, _jcfg), (tsweep, tcfg)):
        with pytest.raises(ValueError, match="mutually exclusive"):
            mod.run_sweep(cfg, n_shards=2, host_count=2)
    # No net of the family in the model root: no report.
    data = tmp_path / "data"
    write_german(str(data / "german" / "german.data"), 50, seed=1)
    (tmp_path / "empty").mkdir()
    assert tsweep.run_sweep(tcfg, model_root=str(tmp_path / "empty"), data_root=str(data),
                            device="cpu") == []
