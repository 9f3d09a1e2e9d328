"""Rows 25-28 (``fairify_tpu_torch/ops/train_step.py``) and ``train_mlp``
(``fairify_tpu_torch/models/train.py``) against the JAX package, on the CPU.

* One step of each row from one carried state — θ, and optax's Adam state
  (count, mu, nu) carried across by ``models.mlp.carry_params`` — through
  the JAX jitted function (rebuilt here exactly as its module builds it:
  ``models/train.py:66``, ``analysis/repair.py:68``, ``:284``, ``:303``)
  and the port's plain version: θ, m, v within 1e-6 relative + 1e-7
  absolute, the loss within 1e-6 relative (the two packages sum the
  products of a layer in different orders; everything else is the same
  sequence of f32 operations, so the differences are a few ulps).  The
  batches include a ragged one (5 rows, 3 pairs); the net has a dead
  hidden neuron.
* Row 26 with a fresh state: every masked entry of θ, m and v stays bit
  for bit what it was.
* ``train_mlp`` on ``tests/test_models_io.py``'s separable world and its
  wide-scale world: weights within 1e-5 relative + 1e-6 absolute after
  120-160 Adam steps (the per-step f32 differences above carry along the
  trajectory; measured at most 2.4e-7 absolute), per-epoch losses within
  1e-5 relative, and predictions equal on every row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fairify_tpu.analysis import repair as jrepair
from fairify_tpu.models import mlp as jmlp
from fairify_tpu.models import train as jtrain
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.models import train as ttrain
from fairify_tpu_torch.ops import train_step

SIZES = (5, 7, 4, 1)
LR = 3e-3
WEIGHTS = (0.5, 4.0, 1e-2)  # label, consistency, anchor (the anchor raised to matter)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(seed=0):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=0.6, size=(a, b)).astype(np.float32)
          for a, b in zip(SIZES[:-1], SIZES[1:])]
    bs = [rng.normal(scale=0.1, size=(b,)).astype(np.float32) for b in SIZES[1:]]
    masks = [np.ones(b, np.float32) for b in SIZES[1:]]
    masks[0][2] = 0.0  # a dead hidden neuron
    X = rng.normal(size=(40, SIZES[0])).astype(np.float32)
    Xp = X.copy()
    Xp[:, 1] = rng.normal(size=40).astype(np.float32)  # the partner: PA column moved
    y = (rng.random(40) < 0.5).astype(np.float32)
    mu = ([rng.normal(scale=1e-2, size=w.shape).astype(np.float32) for w in ws],
          [rng.normal(scale=1e-2, size=b.shape).astype(np.float32) for b in bs])
    nu = ([rng.random(w.shape).astype(np.float32) * 1e-4 for w in ws],
          [rng.random(b.shape).astype(np.float32) * 1e-4 for b in bs])
    gmask = ([(rng.random(w.shape) < 0.4).astype(np.float32) for w in ws],
             [(rng.random(b.shape) < 0.4).astype(np.float32) for b in bs])
    return dict(ws=ws, bs=bs, masks=masks, X=X, Xp=Xp, y=y, mu=mu, nu=nu, gmask=gmask)


def _flat(tree):
    return np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for pair in zip(*tree) for a in pair])


def _jax_state(w, count, fresh):
    jnet = jmlp.from_numpy(w["ws"], w["bs"], w["masks"])
    params = (jnet.weights, jnet.biases)
    opt = optax.adam(LR)
    state = opt.init(params)
    if not fresh:
        tree = lambda t: (tuple(jnp.asarray(a) for a in t[0]),
                          tuple(jnp.asarray(a) for a in t[1]))
        state = (state[0]._replace(count=jnp.asarray(count, jnp.int32), mu=tree(w["mu"]),
                                   nu=tree(w["nu"])),) + tuple(state[1:])
    return jnet, params, opt, state


def _jax_step(row, w, idx, count, fresh=False):
    """One step of the JAX package's jitted function of ``row``."""
    jnet, params, opt, state = _jax_state(w, count, fresh)
    xb, xpb, yb = (jnp.asarray(w[k][idx]) for k in ("X", "Xp", "y"))
    if row == 28:
        xs, xps = jnp.asarray(w["X"]), jnp.asarray(w["Xp"])

        @jax.jit
        def inconsistency(params):
            m = jmlp.MLP(params[0], params[1], jnet.masks)
            return jnp.mean(jnp.abs(jax.nn.sigmoid(jmlp.forward(m, xs))
                                    - jax.nn.sigmoid(jmlp.forward(m, xps))))

        return None, None, float(inconsistency(params))
    anchor = params
    lw, lc, la = WEIGHTS

    def loss_fn(p):
        m = jmlp.MLP(p[0], p[1], jnet.masks)
        if row != 27:
            return jrepair.bce_loss(m, xb, yb)
        lx, lp = jmlp.forward(m, xb), jmlp.forward(m, xpb)
        bce = 0.5 * (optax.sigmoid_binary_cross_entropy(lx, yb).mean()
                     + optax.sigmoid_binary_cross_entropy(lp, yb).mean())
        cons = jnp.mean((jax.nn.sigmoid(lx) - jax.nn.sigmoid(lp)) ** 2)
        anc = sum(jnp.sum((a - a0) ** 2) for a, a0 in zip(p[0], anchor[0]))
        anc = anc + sum(jnp.sum((a - a0) ** 2) for a, a0 in zip(p[1], anchor[1]))
        return lw * bce + lc * cons + la * anc

    # The anchor is the starting θ; move θ off it so the anchor term acts.
    if row == 27:
        params = jax.tree.map(lambda a: a + 0.05, params)
    gm = (tuple(jnp.asarray(a) for a in w["gmask"][0]),
          tuple(jnp.asarray(a) for a in w["gmask"][1]))

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        if row == 26:
            grads = (tuple(g * k for g, k in zip(grads[0], gm[0])),
                     tuple(g * k for g, k in zip(grads[1], gm[1])))
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    params, state, loss = step(params, state)
    return (_flat(params), (_flat(state[0].mu), _flat(state[0].nu), int(state[0].count)),
            float(loss))


def _port_step(row, w, idx, count, fresh=False):
    adam = None if fresh else (count, w["mu"], w["nu"])
    out = tmlp.carry_params(w["ws"], w["bs"], w["masks"], adam=adam, device="cpu")
    if fresh:
        net = out
        theta = tmlp.pack_params(net)
        m, v, t = torch.zeros_like(theta), torch.zeros_like(theta), 0
    else:
        net, m, v, t = out
        theta = tmlp.pack_params(net)
    sizes = [net.in_dim] + list(net.layer_sizes)
    alive = tmlp.alive_flat(net)
    X, Xp, y = (torch.from_numpy(w[k]) for k in ("X", "Xp", "y"))
    idx_t = torch.from_numpy(np.asarray(idx, np.int64))
    if row == 28:
        return None, None, float(train_step.pair_inconsistency(theta, X, Xp, sizes, alive)[0])
    if row == 27:
        anchor = theta.clone()
        theta += 0.05
        loss = train_step.pair_adam_step(theta, m, v, anchor, X, Xp, y, idx_t, sizes, alive,
                                         t + 1, LR, *WEIGHTS)
    else:
        mask = torch.from_numpy(_flat(w["gmask"])) if row == 26 else None
        loss = train_step.bce_adam_step(theta, m, v, X, y, idx_t, sizes, alive, t + 1, LR,
                                        mask=mask,
                                        kernel="train_step" if row == 25 else "fit_step")
    return theta.numpy(), (m.numpy(), v.numpy(), t + 1), float(loss[0])


@pytest.mark.parametrize("row,batch", [(25, 16), (26, 16), (26, 5), (27, 8), (27, 3),
                                       (28, 40)],
                         ids=["25-B16", "26-B16", "26-ragged5", "27-B8", "27-ragged3", "28"])
def test_step_matches_jax(row, batch):
    w = _world(1)
    idx = np.random.default_rng(7).permutation(40)[:batch]
    jt, jstate, jloss = _jax_step(row, w, idx, count=3)
    pt, pstate, ploss = _port_step(row, w, idx, count=3)
    assert ploss == pytest.approx(jloss, rel=1e-6)
    if row == 28:
        return
    np.testing.assert_allclose(pt, jt, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pstate[0], jstate[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pstate[1], jstate[1], rtol=1e-6, atol=1e-7)
    assert pstate[2] == jstate[2] == 4


def test_masked_step_leaves_frozen_entries_bit_unchanged():
    w = _world(2)
    idx = np.arange(13)
    jt, jstate, _ = _jax_step(26, w, idx, count=0, fresh=True)
    pt, pstate, _ = _port_step(26, w, idx, count=0, fresh=True)
    frozen = _flat(w["gmask"]) == 0.0
    start = _flat((w["ws"], w["bs"]))
    assert frozen.any() and (~frozen).any()
    for got in (pt, jt):
        assert np.array_equal(got[frozen], start[frozen])
    for m, v in ((pstate[0], pstate[1]), (jstate[0], jstate[1])):
        assert not m[frozen].any() and not v[frozen].any()
    assert (pt[~frozen] != start[~frozen]).any()
    np.testing.assert_allclose(pt, jt, rtol=1e-6, atol=1e-7)


def test_params_pack_and_carry_round_trip():
    w = _world(3)
    net = tmlp.carry_params(w["ws"], w["bs"], w["masks"], device="cpu")
    theta = tmlp.pack_params(net)
    offs, P = tmlp.param_offsets(tmlp.widths(net))
    assert theta.numel() == P == len(_flat((w["ws"], w["bs"])))
    assert np.array_equal(theta.numpy(), _flat((w["ws"], w["bs"])))
    back = tmlp.unpack_params(theta, net)
    for a, b in zip(back.weights, w["ws"]):
        assert np.array_equal(a.numpy(), b)
    assert torch.equal(tmlp.alive_flat(back), torch.from_numpy(np.concatenate(w["masks"])))
    _, m, v, t = tmlp.carry_params(w["ws"], w["bs"], w["masks"],
                                   adam=(np.int32(9), w["mu"], w["nu"]), device="cpu")
    assert t == 9 and np.array_equal(m.numpy(), _flat(w["mu"]))
    assert np.array_equal(v.numpy(), _flat(w["nu"]))


def _separable():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(512, 4)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    return X, y, dict(hidden=[16], epochs=30, lr=5e-3)


def _wide():
    rng = np.random.default_rng(3)
    x_wide = rng.integers(0, 20000, size=(600, 1)).astype(np.float32)
    x_small = rng.integers(0, 3, size=(600, 1)).astype(np.float32)
    X = np.concatenate([x_wide, x_small], axis=1)
    y = (X[:, 0] > 10000).astype(np.float32)
    return X, y, dict(hidden=[8], epochs=40, lr=5e-3, seed=0)


@pytest.mark.parametrize("world", [_separable, _wide], ids=["separable", "wide-scale"])
def test_train_mlp_matches_jax(world):
    X, y, kw = world()
    jnet = jtrain.train_mlp(X, y, **kw)
    hist = []
    tnet = ttrain.train_mlp(X, y, device="cpu", history=hist, **kw)
    assert len(hist) == kw["epochs"] and all(np.isfinite(hist))
    for a, b in zip(tnet.weights, jnet.weights):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    for a, b in zip(tnet.biases, jnet.biases):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    jp = np.asarray(jmlp.predict(jnet, jnp.asarray(X)))
    tp = tmlp.predict(tnet, torch.from_numpy(X)).numpy()
    assert np.array_equal(tp, jp)
    assert (tp == y).mean() > 0.9


def test_train_history_is_the_jax_loss_trajectory():
    """Per-epoch mean batch losses of the port's ``train_mlp`` equal a JAX
    loop of the same steps (the JAX ``train_mlp`` discards its losses)."""
    X, y, kw = _separable()
    hist = []
    ttrain.train_mlp(X, y, device="cpu", history=hist, **dict(kw, epochs=6))
    mu, sd = X.mean(axis=0), X.std(axis=0)
    Xs = (X - mu) / sd
    net = jtrain.init_mlp([4, 16, 1], 0)
    params = (net.weights, net.biases)
    opt = optax.adam(kw["lr"])
    state = opt.init(params)

    @jax.jit
    def step(params, opt_state, xb, yb):
        loss, grads = jax.value_and_grad(
            lambda p: jrepair.bce_loss(jmlp.MLP(p[0], p[1], net.masks), xb, yb))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    rng = np.random.default_rng(0)
    want = []
    for _ in range(6):
        order = rng.permutation(len(X))
        losses = []
        for s in range(0, len(X) - 127, 128):
            params, state, loss = step(params, state, Xs[order[s:s + 128]],
                                       y[order[s:s + 128]])
            losses.append(float(loss))
        want.append(float(np.mean(losses)))
    np.testing.assert_allclose(hist, want, rtol=1e-5)
