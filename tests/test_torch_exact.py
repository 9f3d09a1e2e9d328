"""The port's exact-certify pass (``ops/exact.py``, ``ops/exact_native.py``,
``verify/pruning.py`` with ``exact_certify=True``) and its exact witness
replay against the JAX package, on the CPU.

* ``exact_network_bounds`` and ``certify_dead_masks`` equal JAX's (exact
  rationals, so equality), through the native core and through the
  ``Fraction`` fallback; the native ``bound_signs`` are the exact bounds'
  signs.
* ``certify_dead_batch`` (native, one call) equals the per-box ``Fraction``
  pass.
* ``sound_prune_grid(exact_certify=True)``: candidates, b/s/st dead masks and
  survivors equal JAX's on the mega path and the chunk loop, native and
  fallback; the net has a neuron whose exact upper bound is exactly 0, so
  the exact pass certifies what the widened f32 bound cannot (``s_deads``).
  ``sound_prune_global`` likewise.
* ``verify_model`` on the GC preset as it stands (exact-certify on, CROWN):
  counts, ledger rows and CSV rows (timing aside; the compression columns
  included) equal JAX's.
* ``exact_logit_sign`` through the native core and through ``Fraction``
  equal JAX's at points whose logit is exactly 0 or within 1e-6 of it.
* ``FAIRIFY_TORCH_NO_NATIVE=1`` forces the fallback.
"""
import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fairify_tpu.models import mlp as jmlp
from fairify_tpu.ops import exact as jexact
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import pruning as jpruning
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.ops import exact as texact
from fairify_tpu_torch.ops import exact_native
from fairify_tpu_torch.verify import engine as tengine
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import pruning as tpruning
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig
from test_torch_bab import _assert_same_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["native", "fraction"])
def route(request, monkeypatch):
    """Run the test through the native core, or with it made unavailable."""
    if request.param == "native":
        assert exact_native.available()
    else:
        monkeypatch.setattr(exact_native, "_load", lambda: None)
    return request.param


def _net(sizes, seed, zero_neuron=True):
    """Seeded weights; hidden neuron 0 of layer 0 has zero weights and bias,
    so its exact upper bound is exactly 0 on every box (certified dead)
    while the widened f32 bound is +1e-6 (not bound-dead)."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=np.sqrt(2.0 / a), size=(a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(scale=0.1, size=(b,)).astype(np.float32) for b in sizes[1:]]
    if zero_neuron:
        ws[0][:, 0] = 0.0
        bs[0][0] = 0.0
    return ws, bs


def _boxes(d, P, seed):
    rng = np.random.default_rng(seed)
    lo = rng.integers(-4, 4, size=(P, d))
    return lo, lo + rng.integers(0, 5, size=(P, d))


@pytest.mark.parametrize("sizes", [(4, 6, 5, 1), (6, 12, 8, 1)])
def test_exact_bounds_and_certify_match_jax(sizes, route):
    ws, bs = _net(sizes, len(sizes))
    lo, hi = _boxes(sizes[0], 6, 1)
    rng = np.random.default_rng(2)
    alive = [np.ones(n, np.float32) for n in sizes[1:]]
    alive[0][1] = 0.0
    for p in range(lo.shape[0]):
        got = texact.exact_network_bounds(ws, bs, lo[p], hi[p], alive=alive)
        want = jexact.exact_network_bounds(ws, bs, lo[p], hi[p], alive=alive)
        assert got == want
        signs = exact_native.bound_signs(ws, bs, lo[p], hi[p], alive=alive)
        if route == "native":  # the native bound signs are the exact bounds' signs
            sgn = lambda v: int(v > 0) - int(v < 0)
            for k in (0, 1):
                assert [a.tolist() for a in signs[k]] == [[sgn(v) for v in layer]
                                                          for layer in got[k]]
        else:
            assert signs is None
        prop = [(rng.random(n) < 0.7).astype(np.float32) for n in sizes[1:]]
        got_c = texact.certify_dead_masks(ws, bs, lo[p], hi[p], prop)
        want_c = jexact.certify_dead_masks(ws, bs, lo[p], hi[p], prop)
        assert len(got_c) == len(want_c) == len(prop)
        for g, w in zip(got_c, want_c):
            np.testing.assert_array_equal(g, w)
        assert got_c[0][0] == prop[0][0]  # the zero neuron certifies when proposed


def test_certify_dead_batch_native_equals_fraction(monkeypatch):
    sizes = (6, 12, 8, 1)
    ws, bs = _net(sizes, 3)
    lo, hi = _boxes(6, 10, 4)
    rng = np.random.default_rng(5)
    prop = [(rng.random((10, n)) < 0.6).astype(np.float32) for n in sizes[1:]]
    batched = exact_native.certify_dead_batch(ws, bs, lo, hi, prop)
    monkeypatch.setattr(exact_native, "_load", lambda: None)
    assert exact_native.certify_dead_batch(ws, bs, lo, hi, prop) is None
    for p in range(10):
        per = texact.certify_dead_masks(ws, bs, lo[p], hi[p], [c[p] for c in prop])
        frac = texact.certify_dead_fraction(ws, bs, lo[p], hi[p], [c[p] for c in prop])
        for l in range(len(sizes) - 1):
            np.testing.assert_array_equal(batched[l][p], per[l])
            np.testing.assert_array_equal(frac[l], per[l])
    assert batched[0].sum() and (batched[0] < prop[0]).any()  # certifies and vetoes


@pytest.mark.parametrize("mega_chunks", [0, 2])
def test_sound_prune_grid_exact_matches_jax(mega_chunks, route):
    cfg = tpresets.get("GC")
    _, lo, hi = tsweep.build_partitions(cfg)
    lo, hi = lo[:40], hi[:40]
    ws, bs = _net((20, 12, 6, 1), 7)
    want = jpruning.sound_prune_grid(jmlp.from_numpy(ws, bs), lo, hi, 64, 5,
                                     exact_certify=True, chunk=16, index_offset=3,
                                     keep_sim=False, mega_chunks=mega_chunks)
    got = tpruning.sound_prune_grid(tmlp.from_numpy(ws, bs, device="cpu"), lo, hi, 64, 5,
                                    chunk=16, mega_chunks=mega_chunks, index_offset=3,
                                    exact_certify=True)
    for k in ("candidates", "surviving", "b_deads", "s_deads", "st_deads"):
        for g, w in zip(getattr(got, k), getattr(want, k)):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    assert got.s_deads[0][:, 0].all()  # the zero neuron: exact-dead, not bound-dead
    assert not got.b_deads[0][:, 0].any()
    assert got.sv_time_s > 0.0


def test_sound_prune_global_matches_jax(route):
    cfg = tpresets.get("GC")
    dom = cfg.query().domain
    lo = np.array([dom.ranges[c][0] for c in dom.columns], np.int64)
    hi = np.array([dom.ranges[c][1] for c in dom.columns], np.int64)
    ws, bs = _net((len(lo), 10, 6, 1), 8)
    want = jpruning.sound_prune_global(jmlp.from_numpy(ws, bs), lo, hi, 128, 3)
    got = tpruning.sound_prune_global(tmlp.from_numpy(ws, bs, device="cpu"), lo, hi,
                                      128, 3)
    for k in ("candidates", "surviving", "b_deads", "s_deads", "st_deads"):
        for g, w in zip(getattr(got, k), getattr(want, k)):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    np.testing.assert_array_equal(got.sim, np.asarray(want.sim))
    assert got.s_deads[0][0, 0] == 1.0


def _read(cfg, sink):
    with open(os.path.join(cfg.result_dir, f"{cfg.name}-{sink}.ledger.jsonl")) as fp:
        led = [json.loads(line) for line in fp if line.strip()]
    with open(os.path.join(cfg.result_dir, f"{sink}.csv"), newline="") as fp:
        rows = list(csv.reader(fp))
    return led, rows


def test_verify_model_gc_exact_certify_matches_jax(tmp_path):
    # The GC preset as it stands: exact_certify_masks=True, the CROWN path.
    # The GC-1 twin with one first-layer neuron zeroed, so the exact pass
    # certifies beyond the IBP criterion on every partition.
    from __graft_entry__ import _flagship_net

    jnet = _flagship_net()
    ws = [np.array(w) for w in jnet.weights]
    bs = [np.array(b) for b in jnet.biases]
    ws[0][:, 0], bs[0][0] = 0.0, 0.0
    eng = dict(frontier_size=512, attack_samples=128, bab_attack_samples=16)
    kw = dict(soft_timeout_s=10.0, hard_timeout_s=600.0)
    jcfg = jpresets.get("GC").with_(result_dir=str(tmp_path / "j"),
                                    engine=jengine.EngineConfig(**eng), **kw)
    tcfg = tpresets.get("GC").with_(result_dir=str(tmp_path / "t"),
                                    engine=EngineConfig(**eng), **kw)
    assert tcfg.exact_certify_masks and jcfg.exact_certify_masks
    jrep = jsweep.verify_model(jmlp.from_numpy(ws, bs), jcfg, model_name="m", resume=False)
    trep = tsweep.verify_model(tmlp.from_numpy(ws, bs, device="cpu"), tcfg,
                               model_name="m", resume=False, device="cpu")
    assert trep.counts == jrep.counts
    assert trep.funnel["states"] == jrep.funnel["states"]
    assert trep.funnel["margin_hist"] == jrep.funnel["margin_hist"]
    jres, tres = _read(jcfg, "m"), _read(tcfg, "m")
    _assert_same_rows(jres, tres)
    s_col = tres[1][0].index("S_compression")
    assert all(float(r[s_col]) > 0.0 for r in tres[1][1:])


def _sign_net():
    """A 3-4-1 net with dyadic weights whose logit is exactly 0 on the
    plane x0 = x1 and within 2^-24 of 0 next to it."""
    w0 = np.array([[1, -1, 0.5, 0], [-1, 1, -0.5, 0], [0, 0, 0, 2.0 ** -24]],
                  np.float32)
    b0 = np.zeros(4, np.float32)
    w1 = np.array([[1], [1], [-1], [1]], np.float32)
    b1 = np.zeros(1, np.float32)
    return [w0, w1], [b0, b1]


def test_exact_logit_sign_native_and_fraction_match_jax(monkeypatch):
    ws, bs = _sign_net()
    pts = [np.array(p, np.int64) for p in ([3, 3, 0], [3, 3, 1], [0, 0, 0],
                                           [2, 2, 5], [1, 0, 0], [5, 7, 0])]
    native = [tengine.exact_logit_sign(ws, bs, x) for x in pts]
    want = [jengine.exact_logit_sign(ws, bs, x) for x in pts]
    monkeypatch.setattr(exact_native, "_load", lambda: None)
    fraction = [tengine.exact_logit_sign(ws, bs, x) for x in pts]
    assert native == fraction == want
    assert native[:4] == [0, 1, 0, 1]


def test_no_native_env_forces_the_fallback():
    code = ("from fairify_tpu_torch.ops import exact_native as e; "
            "print(e.available(), e.build_error)")
    env = dict(os.environ, PYTHONPATH=REPO, **{exact_native.NO_NATIVE_ENV: "1"})
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "False" and exact_native.NO_NATIVE_ENV in out.stdout
