"""The port's model ingest (``fairify_tpu_torch/models/ingest.py``) and the
repo's four trained nets, against the JAX package, on the CPU.

* The committed ``.npz`` exports (``fairify_tpu_torch/models/scaled/``)
  hold JAX ``load_keras_h5``'s weights and biases bit for bit (dtype, shape,
  values) for AC-S1, AC-S2, BM-S1 and BM-S2, with the source file's name
  and SHA-256; the port's ``load_keras_h5`` and ``load_npz`` give the same
  arrays, and a fresh ``export`` of each ``.h5`` reproduces them.
* ``IngestError`` (in both packages) on a non-Dense layer, a non-ReLU
  hidden layer and a two-unit output, on tiny ``.h5`` files written with
  ``h5py``.
* The port's forward logits equal JAX's to f32 rounding on 256 seeded
  points of the adult and bank domains, for every trained net.
* K7's plain version on trained AC-S1 and BM-S1 agrees with JAX
  ``alpha_crown_output_bounds`` within the widening slack on 8 boxes of the
  AC and BM grids.
"""
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairify_tpu.models import ingest as jingest
from fairify_tpu.models import mlp as jmlp
from fairify_tpu.ops import crown as jcrown
from fairify_tpu_torch.data.domains import get_domain
from fairify_tpu_torch.models import ingest
from fairify_tpu_torch.ops import crown as tcrown
from fairify_tpu_torch.ops.interval import SOUND_SLACK_ABS, SOUND_SLACK_REL
from fairify_tpu_torch.verify import presets, sweep

h5py = pytest.importorskip("h5py")

REPO = Path(__file__).resolve().parents[1]
NAMES = sorted(ingest.TRAINED)
DOMAIN = {"AC-S1": "adult", "AC-S2": "adult", "BM-S1": "bank", "BM-S2": "bank"}


def _jax_arrays(name):
    net = jingest.load_keras_h5(REPO / ingest.TRAINED[name])
    return [np.asarray(w) for w in net.weights], [np.asarray(b) for b in net.biases]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("name", NAMES)
def test_exports_equal_jax_load_keras_h5(name, tmp_path):
    jw, jb = _jax_arrays(name)
    ws, bs, source, digest = ingest.npz_arrays(ingest.SCALED_DIR / f"{name}.npz")
    _same(ws, jw)
    _same(bs, jb)
    h5 = REPO / ingest.TRAINED[name]
    assert source == h5.name
    assert digest == hashlib.sha256(h5.read_bytes()).hexdigest()
    # The port's two loaders give the same arrays.
    for net in (ingest.load_keras_h5(h5, device="cpu"), ingest.load_trained(name, "cpu")):
        _same([w.numpy() for w in net.weights], jw)
        _same([b.numpy() for b in net.biases], jb)
        assert all(bool((m == 1).all()) for m in net.masks)
    # A fresh export reproduces the committed arrays.
    out = tmp_path / f"{name}.npz"
    assert ingest.main(["export", str(h5), str(out)]) == 0
    fw, fb, fsrc, fdig = ingest.npz_arrays(out)
    _same(fw, jw)
    _same(fb, jb)
    assert (fsrc, fdig) == (source, digest)


def _write_h5(path, layers, shapes):
    """A tiny Keras-style file: ``layers`` the model_config's layer list,
    ``shapes`` the (kernel, bias) shapes of its Dense layers by name."""
    cfg = {"class_name": "Sequential", "config": {"name": "s", "layers": layers}}
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg).encode()
        mw = f.create_group("model_weights")
        for name, (ks, bs) in shapes.items():
            g = mw.create_group(name).create_group(name)
            g["kernel:0"] = rng.normal(size=ks).astype(np.float32)
            g["bias:0"] = rng.normal(size=bs).astype(np.float32)


def _dense(name, units, act):
    return {"class_name": "Dense", "config": {"name": name, "units": units, "activation": act}}


@pytest.mark.parametrize("case", ["non-dense", "non-relu hidden", "two-unit output"])
def test_ingest_error(case, tmp_path):
    path = tmp_path / "bad.h5"
    if case == "non-dense":
        layers = [_dense("d0", 4, "relu"),
                  {"class_name": "Dropout", "config": {"name": "drop", "rate": 0.5}},
                  _dense("d1", 1, "sigmoid")]
    elif case == "non-relu hidden":
        layers = [_dense("d0", 4, "tanh"), _dense("d1", 1, "sigmoid")]
    else:
        layers = [_dense("d0", 4, "relu"), _dense("d1", 2, "sigmoid")]
    out = 2 if case == "two-unit output" else 1
    _write_h5(path, layers, {"d0": ((3, 4), (4,)), "d1": ((4, out), (out,))})
    with pytest.raises(ingest.IngestError):
        ingest.load_keras_h5(path, device="cpu")
    with pytest.raises(jingest.IngestError):
        jingest.load_keras_h5(path)
    # The good file of the same shapes loads in both packages alike.
    _write_h5(path, [_dense("d0", 4, "relu"), _dense("d1", 1, "sigmoid")],
              {"d0": ((3, 4), (4,)), "d1": ((4, 1), (1,))})
    _same([w.numpy() for w in ingest.load_keras_h5(path, device="cpu").weights],
          [np.asarray(w) for w in jingest.load_keras_h5(path).weights])


@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_match_jax(name):
    lo, hi = get_domain(DOMAIN[name]).lo_hi()
    rng = np.random.default_rng(7)
    x = rng.integers(lo.astype(np.int64), hi.astype(np.int64) + 1,
                     size=(256, len(lo))).astype(np.float32)
    jnet = jingest.load_keras_h5(REPO / ingest.TRAINED[name])
    want = np.asarray(jmlp.forward(jnet, jnp.asarray(x)))
    got = ingest.load_trained(name, "cpu")(torch.as_tensor(x)).numpy()
    ws, bs, _, _ = ingest.npz_arrays(ingest.SCALED_DIR / f"{name}.npz")
    # Both within f32 rounding of the float64 logits: |h| @ |W| + |b| scale.
    h, scale = x.astype(np.float64), np.zeros(len(x))
    for i, (w, b) in enumerate(zip(ws, bs)):
        scale = np.abs(h) @ np.abs(w.astype(np.float64)) + np.abs(b)
        h = h @ w.astype(np.float64) + b
        if i < len(ws) - 1:
            h = np.maximum(h, 0.0)
    tol = 1e-5 * scale[:, 0] + 1e-6
    assert (np.abs(got - h[:, 0]) <= tol).all() and (np.abs(want - h[:, 0]) <= tol).all()
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("name,preset", [("AC-S1", "AC"), ("BM-S1", "BM")])
def test_trained_alpha_crown_matches_jax(name, preset):
    _, lo, hi = sweep.build_partitions(presets.get(preset))
    lo, hi = lo[:8].astype(np.float32), hi[:8].astype(np.float32)
    jnet = jingest.load_keras_h5(REPO / ingest.TRAINED[name])
    jit = jax.jit(jcrown.alpha_crown_output_bounds, static_argnames=("iters", "widen"))
    jlb, jub = (np.asarray(v) for v in jit(jnet, jnp.asarray(lo), jnp.asarray(hi), iters=8))
    tnet = ingest.load_trained(name, "cpu")
    T = torch.as_tensor
    tlb, tub = (t.numpy() for t in tcrown.alpha_crown_output_bounds(tnet, T(lo), T(hi)))
    clb, cub = (t.numpy() for t in tcrown.crown_output_bounds(tnet, T(lo), T(hi)))
    slack = SOUND_SLACK_REL * np.maximum(np.abs(jlb), np.abs(jub)) + SOUND_SLACK_ABS
    assert (np.abs(tlb - jlb) <= slack).all() and (np.abs(tub - jub) <= slack).all()
    assert (tlb >= clb).all() and (tub <= cub).all()
