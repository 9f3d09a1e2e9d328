"""The synthetic-data path (``fairify_tpu_torch/models/synth.py``, rows 29-30
in ``ops/synth_step.py``, ``models/export.py``,
``scripts/synthetic_models.py``) against the JAX package, on the CPU.

* The host generators (copula, quantizer, bootstrap, ``synthesize`` of
  "copula" and "bootstrap") and ``ARColumnModel.init`` give equal arrays.
* One step of row 29 from one carried state — θ and optax's Adam state
  (count, mu, nu) — through the JAX jitted function (rebuilt here exactly
  as ``fairify_tpu/models/synth.py:258-287`` builds it) and the port's
  plain version, on a full batch and a ragged one: θ, m, v within
  ``STEP_REL·|v| + STEP_ABS·max|v|`` and the loss within ``STEP_REL``
  (the two sum the one-hot products and the head's in other orders, and a
  gradient entry whose sum cancels carries the error of its terms' scale:
  measured 3.4e-7 of max|m|; Adam is the same f32 operations), the padded
  classes' entries bit-unchanged.
* ``fit`` over a few epochs: the loss history within ``FIT_REL`` and the
  weights within ``FIT_REL·|w| + FIT_ABS`` (the per-step differences carry
  along; measured below 7e-7 absolute).
* ``sample`` and ``synthesize("ar")``: rows equal, except rows whose first
  differing column is a near tie in JAX's own perturbed logits (the top
  two within ``TIE_REL·max(1, |top|)``: the two sum ``x·w1`` and the head
  in other orders, and their logarithms may differ by an ulp).  Such rows
  are counted, capped at ``TIE_CAP`` of the rows, and the count is
  asserted, so a change that moves it shows.
* Export files are read both ways; the small pipeline gives JAX's rows,
  predictions and records.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import write_german
from fairify_tpu.data import loaders as jloaders
from fairify_tpu.models import export as jexport
from fairify_tpu.models import ingest as jingest
from fairify_tpu.models import mlp as jmlp
from fairify_tpu.models import synth as J
from fairify_tpu.models import train as jtrain
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.data import loaders as tloaders
from fairify_tpu_torch.models import export as texport
from fairify_tpu_torch.models import ingest as tingest
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.models import synth as T
from fairify_tpu_torch.models import train as ttrain
from fairify_tpu_torch.ops import synth_step as ss
from fairify_tpu_torch.verify import presets as tpresets

STEP_REL, STEP_ABS = 1e-6, 1e-6
FIT_REL, FIT_ABS = 1e-5, 1e-5
TIE_REL, TIE_CAP = 1e-5, 0.01


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(n=400, seed=0):
    """tests/test_synth.py's correlated integer data: x1 ~ x0, x2 independent."""
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, 4, size=n)
    x1 = np.clip(x0 + rng.integers(-1, 2, size=n), 0, 4)
    x2 = rng.integers(0, 2, size=n)
    return np.stack([x0, x1, x2], axis=1)


def _wide(n=300, seed=1):
    """tests/test_synth.py's wide-column data (a credit_amount-like column)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 20000, size=n), rng.integers(0, 2, size=n)], axis=1)


def _flat(params) -> np.ndarray:
    return np.concatenate([np.asarray(params[k], np.float32).reshape(-1) for k in ss.KEYS])


# ---------------------------------------------------------------------------
# Host generators and init
# ---------------------------------------------------------------------------

def test_norm_helpers_equal():
    u = np.random.default_rng(0).random(2000)
    u[:4] = [0.0, 1e-14, 0.5, 1.0]
    np.testing.assert_array_equal(T._norm_ppf(u), J._norm_ppf(u))
    z = np.random.default_rng(1).normal(size=500) * 3
    np.testing.assert_array_equal(T._norm_cdf(z), J._norm_cdf(z))


@pytest.mark.parametrize("data", ["toy", "wide"])
def test_copula_quantizer_bootstrap_equal(data):
    X = _toy(300) if data == "toy" else _wide()
    jc, tc = J.GaussianCopula.fit(X), T.GaussianCopula.fit(X)
    np.testing.assert_array_equal(tc.chol, jc.chol)
    for a, b in zip(tc.values + tc.cum, jc.values + jc.cum):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tc.sample(400, seed=3), jc.sample(400, seed=3))
    jq, tq = J.ColumnQuantizer.fit(X, max_card=16), T.ColumnQuantizer.fit(X, max_card=16)
    np.testing.assert_array_equal(tq.card, jq.card)
    B = tq.encode(X)
    np.testing.assert_array_equal(B, jq.encode(X))
    np.testing.assert_array_equal(tq.decode(B, seed=5), jq.decode(B, seed=5))
    np.testing.assert_array_equal(T.bootstrap_rows(X, 77, seed=2), J.bootstrap_rows(X, 77, seed=2))
    lo, hi = X.min(axis=0), X.max(axis=0)
    for kind in ("copula", "bootstrap"):
        np.testing.assert_array_equal(T.synthesize(kind, X, lo, hi, 90, seed=4),
                                      J.synthesize(kind, X, lo, hi, 90, seed=4))
    with pytest.raises(ValueError, match="unknown generator"):
        T.synthesize("ctgan", X, lo, hi, 10)
    assert T.GENERATORS == J.GENERATORS


def test_init_equal():
    jm = J.ARColumnModel.init([0, 1, 0], [4, 3, 1], hidden=16, seed=7)
    tm = T.ARColumnModel.init([0, 1, 0], [4, 3, 1], hidden=16, seed=7, device="cpu")
    for k in ss.KEYS:
        np.testing.assert_array_equal(tm.params[k].numpy(), np.asarray(jm.params[k]), err_msg=k)
    for f in ("lo", "card", "offsets"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    np.testing.assert_array_equal(tm.theta.numpy(), _flat(jm.params))


def test_params_are_views_of_one_buffer():
    """The constructor packs the weights into θ; ``params`` are its views
    and ``load_params`` copies into it."""
    jm = J.ARColumnModel.init([0, 1], [2, 4], hidden=8, seed=3)
    tm = T.ARColumnModel(jm.lo, jm.card, jm.offsets,
                         {k: np.asarray(jm.params[k]).copy() for k in ss.KEYS})
    np.testing.assert_array_equal(tm.theta.numpy(), _flat(jm.params))
    assert (tm.shape.d, tm.shape.D, tm.shape.H, tm.shape.kmax, tm.shape.P) == (
        2, 7, 8, 4, tm.theta.numel())
    base = tm.theta.data_ptr()
    for k, (off, shape) in tm.shape.layout.items():
        assert tuple(tm.params[k].shape) == shape and tm.params[k].data_ptr() == base + 4 * off
    tm.load_params({k: np.full(tm.params[k].shape, i, np.float32) for i, k in enumerate(ss.KEYS)})
    assert tm.theta.data_ptr() == base
    for i, k in enumerate(ss.KEYS):
        assert bool((tm.params[k] == i).all()), k


# ---------------------------------------------------------------------------
# Row 29: one step, fit
# ---------------------------------------------------------------------------

def _jax_step(model, lr):
    """``ARColumnModel.fit``'s loss and jitted step (synth.py:262-287)."""
    d, D, kmax, col_of, class_mask = model._consts()
    causal = (col_of[None, :] < jnp.arange(d)[:, None]).astype(jnp.float32)
    neg = jnp.where(class_mask, 0.0, -1e30)

    def loss_fn(params, xb, yb):
        pref = xb[:, None, :] * causal[None, :, :]
        h = jax.nn.relu(jnp.einsum("bdi,ih->bdh", pref, params["w1"]) + params["b1"])
        h = jax.nn.relu(jnp.einsum("bdh,hk->bdk", h, params["w2"]) + params["b2"])
        logits = jnp.einsum("bdh,dhk->bdk", h, params["wh"]) + params["bh"] + neg
        logp = jax.nn.log_softmax(logits, axis=-1)
        ll = jnp.take_along_axis(logp, yb[:, :, None], axis=-1)[..., 0]
        return -ll.mean()

    opt = optax.adam(lr)

    @jax.jit
    def step(params, opt_state, xb, yb):
        l, g = jax.value_and_grad(loss_fn)(params, xb, yb)
        upd, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, upd), opt_state, l

    return opt, step


def _step_err(got, want) -> float:
    scale = float(np.abs(want).max()) or 1.0
    return float((np.abs(got - want) / (STEP_REL * np.abs(want) + STEP_ABS * scale)).max())


@pytest.mark.parametrize("B", [64, 23], ids=["full", "ragged"])
def test_one_step_equals_jax(B):
    lo, hi, H, lr, t0 = [0, 0, 1, 0], [4, 2, 7, 1], 16, 3e-3, 5
    X = np.stack([np.random.default_rng(c).integers(a, b + 1, size=120)
                  for c, (a, b) in enumerate(zip(lo, hi))], axis=1)
    jm = J.ARColumnModel.init(lo, hi, hidden=H, seed=2)
    tm = T.ARColumnModel.init(lo, hi, hidden=H, seed=2, device="cpu")
    pad = ss.padded_mask(tm.shape).numpy()
    rng = np.random.default_rng(9)
    # a carried state: moved weights, Adam's moments (0 on the padded
    # classes, as a fit keeps them) at count t0
    theta0 = _flat(jm.params) + rng.normal(scale=0.05, size=pad.size).astype(np.float32)
    theta0[pad] = _flat(jm.params)[pad]
    mu = np.where(pad, 0, rng.normal(scale=1e-3, size=pad.size)).astype(np.float32)
    nu = np.where(pad, 0, rng.random(pad.size) * 1e-5).astype(np.float32)
    views = lambda a: {k: jnp.asarray(v.numpy())
                       for k, v in ss.views(torch.from_numpy(a), tm.shape).items()}
    opt, step = _jax_step(jm, lr)
    state = opt.init(views(theta0))
    state = (state[0]._replace(count=jnp.asarray(t0, jnp.int32), mu=views(mu), nu=views(nu)),
             ) + tuple(state[1:])
    Xc = np.clip(X, jm.lo, jm.lo + jm.card - 1)
    idx = rng.permutation(len(X))[:B]
    jp, js, jl = step(views(theta0), state, jnp.asarray(jm._onehot(Xc)[idx]),
                      jnp.asarray((Xc - jm.lo)[idx].astype(np.int32)))
    th, m, v = (torch.from_numpy(a.copy()) for a in (theta0, mu, nu))
    codes = torch.from_numpy((Xc - tm.lo).astype(np.int32))
    loss = ss.synth_step(th, m, v, codes, torch.from_numpy(idx), tm.shape, t0 + 1, lr)
    errs = {name: _step_err(got.numpy(), _flat(want)) for name, got, want in (
        ("theta", th, jp), ("m", m, js[0].mu), ("v", v, js[0].nu))}
    assert max(errs.values()) <= 1.0, errs
    assert abs(loss.item() - float(jl)) <= STEP_REL * abs(float(jl))
    assert int(js[0].count) == t0 + 1
    # the padded classes: gradient 0, so θ, m, v stay bit for bit
    np.testing.assert_array_equal(th.numpy()[pad], theta0[pad])
    assert not m.numpy()[pad].any() and not v.numpy()[pad].any()
    assert pad.sum() > 0


def test_fit_equals_jax():
    X = _toy(600)
    lo, hi = [0, 0, 0], [4, 4, 1]
    jm = J.ARColumnModel.init(lo, hi, hidden=32, seed=0)
    tm = T.ARColumnModel.init(lo, hi, hidden=32, seed=0, device="cpu")
    jh = np.asarray(jm.fit(X, epochs=6, lr=5e-3, batch_size=256, seed=0))
    th = np.asarray(tm.fit(X, epochs=6, lr=5e-3, batch_size=256, seed=0))
    assert th.shape == (6,) and th[-1] < th[0]
    np.testing.assert_allclose(th, jh, rtol=FIT_REL, atol=0)
    w = _flat(jm.params)
    got = tm.theta.numpy()
    assert float((np.abs(got - w) / (FIT_REL * np.abs(w) + FIT_ABS)).max()) <= 1.0
    pad = ss.padded_mask(tm.shape).numpy()
    np.testing.assert_array_equal(got[pad], w[pad])


# ---------------------------------------------------------------------------
# Row 30: sample, synthesize("ar")
# ---------------------------------------------------------------------------

def _jax_perturbed(model, codes: np.ndarray, seed: int) -> np.ndarray:
    """JAX's perturbed logits ``logits + gumbel(sub_j)`` of every column
    along its own sampled rows ``codes`` (n, d): ``draw``'s computation
    (synth.py:310-325) with the prefixes fixed.  (n, d, kmax)."""
    d, D, kmax, _, class_mask = model._consts()
    neg = jnp.where(class_mask, 0.0, -1e30)
    p = model.params
    n = len(codes)
    oh = jnp.asarray(model._onehot(codes + model.lo[None, :]))
    slot_col = np.repeat(np.arange(d), model.card)
    key, out = jax.random.key(seed), []
    for j in range(d):
        x = oh * jnp.asarray((slot_col < j).astype(np.float32))[None, :]
        h = jax.nn.relu(x @ p["w1"] + p["b1"])
        h = jax.nn.relu(h @ p["w2"] + p["b2"])
        logits = h @ p["wh"][j] + p["bh"][j] + neg[j]
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (n, kmax), jnp.float32) + logits))
    return np.stack(out, axis=1)


def _near_tie_rows(model, got: np.ndarray, want: np.ndarray, seed: int) -> int:
    """Rows of ``got`` that differ from JAX's ``want`` (both class codes),
    each required to be a near tie in JAX's perturbed logits
    (``ops/synth_step.near_ties``).  Returns their count."""
    if np.array_equal(got, want):
        return 0
    ties, bad = ss.near_ties(got, want, _jax_perturbed(model, want, seed), model.card, TIE_REL)
    assert not bad, bad[:10]
    return ties


def _fitted_pair(X, lo, hi, hidden, epochs, seed=0):
    """The same model fitted in both packages, the port's weights set to
    JAX's (the sampling test starts from equal weights)."""
    jm = J.ARColumnModel.init(lo, hi, hidden=hidden, seed=seed)
    jm.fit(X, epochs=epochs, lr=5e-3, seed=seed)
    tm = T.ARColumnModel.init(lo, hi, hidden=hidden, seed=seed, device="cpu")
    tm.load_params({k: np.asarray(jm.params[k]).copy() for k in ss.KEYS})
    return jm, tm


# Near-tie rows measured on the CPU: 0 of 800 (toy) and 0 of 600 (wide).
@pytest.mark.parametrize("data,n", [("toy", 800), ("wide", 600)])
def test_sample_equals_jax_up_to_near_ties(data, n):
    if data == "toy":
        X, lo, hi = _toy(600), [0, 0, 0], [4, 4, 1]
    else:
        q = J.ColumnQuantizer.fit(_wide())
        X, lo, hi = q.encode(_wide()), [0, 0], list(q.card - 1)
    jm, tm = _fitted_pair(X, lo, hi, 32, 8)
    want = jm.sample(n, seed=3)
    got = tm.sample(n, seed=3)
    assert got.shape == want.shape == (n, len(lo)) and got.dtype == np.int64
    assert (got >= np.asarray(lo)).all() and (got <= np.asarray(hi)).all()
    ties = _near_tie_rows(jm, got - jm.lo, want - jm.lo, 3)
    assert ties <= TIE_CAP * n, f"{ties} near-tie rows of {n}"
    # the column keys and one column's gumbel bits are JAX's, bit for bit
    key, sub = jax.random.split(jax.random.key(3))
    _, sub2 = jax.random.split(key)
    keys = ss.column_keys(3, 2)
    np.testing.assert_array_equal(keys.numpy(), np.stack(
        [np.asarray(jax.random.key_data(k)) for k in (sub, sub2)]).astype(np.int64))
    u = ss.prng.uniform(keys[1], (n, 5), minval=ss.TINY, maxval=1.0)
    np.testing.assert_array_equal(u.numpy(), np.asarray(jax.random.uniform(
        sub2, (n, 5), jnp.float32, minval=np.finfo(np.float32).tiny, maxval=1.0)))


@pytest.mark.parametrize("data", ["toy", "wide"])
def test_synthesize_ar_equals_jax(data):
    X = _toy(300) if data == "toy" else _wide()
    lo, hi = ([0, 0, 0], [4, 4, 1]) if data == "toy" else ([0, 0], [19999, 1])
    got = T.synthesize("ar", X, lo, hi, 50, seed=0, ar_epochs=5, device="cpu")
    want = J.synthesize("ar", X, lo, hi, 50, seed=0, ar_epochs=5)
    assert got.shape == (50, len(lo))
    for j in range(len(lo)):
        assert set(np.unique(got[:, j])) <= set(np.unique(X[:, j]))
    if not np.array_equal(got, want):
        # the codes drawn differ: a near tie, which moves the decode's draws
        q = J.ColumnQuantizer.fit(X)
        jm, tm = _fitted_pair(q.encode(X), np.zeros(len(q.card), int), q.card - 1, 64, 5)
        ties = _near_tie_rows(jm, tm.sample(50, seed=1), jm.sample(50, seed=1), 1)
        assert 0 < ties <= max(1, TIE_CAP * 50)


# ---------------------------------------------------------------------------
# Export, the pipeline
# ---------------------------------------------------------------------------

def test_export_reads_both_ways(tmp_path):
    rng = np.random.default_rng(4)
    sizes = (6, 5, 3, 1)
    ws = [rng.normal(size=(a, b)).astype(np.float32) for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(size=(b,)).astype(np.float32) for b in sizes[1:]]
    texport.save_keras_h5(tmlp.from_numpy(ws, bs, device="cpu"), tmp_path / "port.h5",
                          name="synthetic")
    net = jingest.load_keras_h5(tmp_path / "port.h5")
    for a, b in zip(list(net.weights) + list(net.biases), ws + bs):
        np.testing.assert_array_equal(np.asarray(a), b)
    jexport.save_keras_h5(jmlp.from_numpy(ws, bs), tmp_path / "jax.h5")
    back = tingest.load_keras_h5(tmp_path / "jax.h5", device="cpu")
    for a, b in zip(list(back.weights) + list(back.biases), ws + bs):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    import h5py

    with h5py.File(tmp_path / "port.h5") as fp, h5py.File(tmp_path / "jax.h5") as fj:
        assert fp.attrs["backend"] == fj.attrs["backend"]
        assert list(fp["model_weights"].attrs["layer_names"]) == list(
            fj["model_weights"].attrs["layer_names"])


def test_save_net_falls_back_to_npz(tmp_path, monkeypatch):
    """Without h5py the pipeline writes an .npz export under the same key."""
    from fairify_tpu_torch.scripts import synthetic_models as script

    net = tmlp.init_mlp((4, 3, 1), seed=1, device="cpu")
    assert script.save_net(net, str(tmp_path), "GC-6").endswith("GC-6.h5")
    monkeypatch.setitem(sys.modules, "h5py", None)
    path = script.save_net(net, str(tmp_path), "GC-6")
    assert path == str(tmp_path / "GC-6.npz")
    back = tingest.load_npz(path, device="cpu")
    for a, b in zip(list(back.weights) + list(back.biases), list(net.weights) + list(net.biases)):
        assert torch.equal(a, b)


SIM = 64  # the pipeline test's simulation size (the GC preset's 1,000 cut)


def test_pipeline_equals_jax(tmp_path, monkeypatch):
    """scripts/synthetic_models.py at a small size on a synthetic German
    file: the port's module against the JAX modules called in the
    script's order (the GC preset with ``sim_size`` cut to SIM in both)."""
    from fairify_tpu_torch.scripts import synthetic_models as script

    data = tmp_path / "data"
    write_german(str(data / "german" / "german.data"), 200, 5)
    monkeypatch.setattr(tloaders, "DEFAULT_DATA_ROOT", str(data))
    get = tpresets.get
    monkeypatch.setattr(tpresets, "get", lambda name: get(name).with_(sim_size=SIM))
    rows, nets = {}, {}
    synthesize, train_mlp = T.synthesize, ttrain.train_mlp

    def rec_synth(kind, *a, **kw):
        rows[kind] = synthesize(kind, *a, **kw)
        return rows[kind]

    def rec_train(X, y, **kw):
        nets[len(nets)] = net = train_mlp(X, y, **kw)
        return net

    monkeypatch.setattr(T, "synthesize", rec_synth)
    monkeypatch.setattr(ttrain, "train_mlp", rec_train)
    args = ["--n", "200", "--ar-epochs", "3", "--epochs", "2", "--hidden", "6", "--soft", "1",
            "--hard", "60", "--out", str(tmp_path / "port"), "--device", "cpu"]
    got = script.main(args)

    # the JAX modules in the script's order (scripts/synthetic_models.py:60-105)
    cfg = dataclasses.replace(jpresets.get("GC"), soft_timeout_s=1.0, hard_timeout_s=60.0,
                              result_dir=str(tmp_path / "jax"), sim_size=SIM)
    ds = jloaders.load(cfg.dataset, root=str(data))
    lo, hi = cfg.query().domain.lo_hi()
    lo = np.concatenate([lo, [0.0]]).astype(np.int64)
    hi = np.concatenate([hi, [1.0]]).astype(np.int64)
    real = np.clip(np.concatenate([np.asarray(ds.X_train), np.asarray(ds.y_train)[:, None]],
                                  axis=1).astype(np.int64), lo[None, :], hi[None, :])
    os.makedirs(cfg.result_dir)
    want = []
    for i, (kind, name) in enumerate((("real", "GC-real"), ("copula", "GC-6"), ("ar", "GC-7"),
                                      ("bootstrap", "GC-8"))):
        if kind == "real":
            r = real
        else:
            r = J.synthesize(kind, real, lo, hi, 200, seed=42, ar_epochs=3)
            assert np.array_equal(rows[kind], r), kind  # no near tie at this size
        X, y = r[:, :-1].astype(np.float32), r[:, -1].astype(np.float32)
        jnet = jtrain.train_mlp(X, y, hidden=[6], epochs=2, seed=42)
        pred = np.asarray(jmlp.predict(jnet, jnp.asarray(ds.X_test, jnp.float32)))
        tpred = tmlp.predict_rows(nets[i], ds.X_test)
        np.testing.assert_array_equal(tpred.astype(int), pred.astype(int))
        rep = jsweep.verify_model(jnet, cfg, model_name=name, dataset=ds, resume=False)
        want.append({"generator": kind, "model": name, "rows": int(len(r)),
                     "partitions": rep.partitions_total, **rep.counts,
                     "test_acc": round(rep.original_acc, 4)})
        assert os.path.exists(got[i]["h5"]) and got[i]["h5"].endswith(f"{name}.h5")
    strip = lambda recs: [{k: v for k, v in r.items() if k not in ("h5", "total_time_s")}
                          for r in recs]
    assert strip(got) == want
    import json

    with open(tmp_path / "port" / "summary.json") as fp:
        assert strip(json.load(fp)) == want
