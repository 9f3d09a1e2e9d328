"""The port's prune pass (KA's plain version) against the JAX package's.

Same grid, net and seed through ``fairify_tpu.verify.pruning`` (mega path)
and ``fairify_tpu_torch.verify.pruning`` on the CPU: masks and activation
frequencies must be equal; the widened f32 IBP bounds agree within the
widening slack's scale (the two libraries sum in different orders).
"""
import numpy as np
import pytest
import torch

from fairify_tpu.models import mlp as jmlp
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import pruning as jpruning
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.ops import interval as tinterval
from fairify_tpu_torch.ops import simulate as tsim
from fairify_tpu_torch.utils import prng as tprng
from fairify_tpu_torch.verify import pruning as tpruning


def _net(sizes, seed):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=np.sqrt(2.0 / a), size=(a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(scale=0.1, size=(b,)).astype(np.float32) for b in sizes[1:]]
    return ws, bs


def _twin():
    from __graft_entry__ import _flagship_net

    net = _flagship_net()
    return [np.asarray(w) for w in net.weights], [np.asarray(b) for b in net.biases]


def _within_slack(got_lb, got_ub, want_lb, want_ub):
    """Widened f32 IBP bounds agree to rel 1e-5 of the neuron's interval
    magnitude max(|lb|, |ub|) + abs 1e-5 — the scale of the widening slack.
    Relative to the bound's own value the gap can be larger where the
    sign-split sums cancel (wide GC domains: summands in the hundreds, the
    bound near zero), and both libraries round those summands differently."""
    for got, want in ((got_lb, want_lb), (got_ub, want_ub)):
        tol = 1e-5 * np.maximum(np.abs(want_lb), np.abs(want_ub)) + 1e-5
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _contains_f64_ibp(ws, bs, lo, hi, ws_lb, ws_ub):
    """Soundness: the widened f32 bounds contain the f64 interval bounds
    (f64 is exact to ~1e-12 here, far inside the 1e-5 widening)."""
    l, h = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    for k, (w, b) in enumerate(zip(ws, bs)):
        w = np.asarray(w, np.float64)
        wp, wn = np.maximum(w, 0.0), np.minimum(w, 0.0)
        zl, zh = l @ wp + h @ wn + b, h @ wp + l @ wn + b
        assert (np.asarray(ws_lb[k]) <= zl).all() and (np.asarray(ws_ub[k]) >= zh).all()
        l, h = np.maximum(zl, 0.0), np.maximum(zh, 0.0)


CASES = {
    # GC-1 twin on the whole GC grid at the preset's sim_size, one segment.
    "gc1_twin": (_twin, 201, 1000, 2048, 4),
    # A deeper net, several segments (chunk 32, 2 chunks per segment).
    "deep_20_16_8_1": (lambda: _net((20, 16, 8, 1), 3), 120, 200, 32, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sound_prune_grid_matches_jax(case):
    make, P, sim, chunk, mega = CASES[case]
    ws, bs = make()
    _, lo, hi = jsweep.build_partitions(jpresets.get("GC"))
    lo, hi = lo[:P], hi[:P]
    want = jpruning.sound_prune_grid(jmlp.from_numpy(ws, bs), lo, hi, sim, 42,
                                     exact_certify=False, chunk=chunk,
                                     keep_sim=False, mega_chunks=mega)
    got = tpruning.sound_prune_grid(tmlp.from_numpy(ws, bs, device="cpu"), lo, hi,
                                    sim, 42, chunk=chunk, mega_chunks=mega)
    for field in ("candidates", "b_deads", "st_deads", "pos_prob", "surviving"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=field)
    for gl, gu, wl, wu in zip(got.ws_lb, got.ws_ub, want.ws_lb, want.ws_ub):
        _within_slack(gl, gu, np.asarray(wl), np.asarray(wu))
    _contains_f64_ibp(ws, bs, lo, hi, got.ws_lb, got.ws_ub)
    _contains_f64_ibp(ws, bs, lo, hi, want.ws_lb, want.ws_ub)
    # Looseness is telemetry: f32 sums in another order (approximately equal).
    np.testing.assert_allclose(got.looseness, want.looseness, rtol=1e-4)


def test_activation_stats_and_ibp_match_jax():
    import jax
    import jax.numpy as jnp

    from fairify_tpu.ops import interval as jinterval
    from fairify_tpu.ops import simulate as jsim
    from fairify_tpu.utils import prng as jprng

    ws, bs = _net((20, 16, 8, 1), 5)
    _, lo, hi = jsweep.build_partitions(jpresets.get("GC"))
    lo, hi = lo[:9].astype(np.float32), hi[:9].astype(np.float32)
    jnet = jmlp.from_numpy(ws, bs)
    keys = jprng.grid_keys(3, 0, 9)
    stats, _ = jax.vmap(lambda k, l, h: jsim.simulate_and_stats(jnet, k, l, h, 300))(
        keys, jnp.asarray(lo), jnp.asarray(hi))
    tnet = tmlp.from_numpy(ws, bs, device="cpu")
    sim = tprng.simulate_boxes(tprng.grid_keys(3, 0, 9), torch.as_tensor(lo),
                               torch.as_tensor(hi), 300)
    tstats = tsim.activation_stats(tnet, sim)
    for a, b in zip(tstats.positive_prob, stats.positive_prob):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jb = jinterval.network_bounds(jnet, jnp.asarray(lo), jnp.asarray(hi))
    tb = tinterval.network_bounds(tnet, torch.as_tensor(lo), torch.as_tensor(hi))
    for gl, gu, wl, wu in zip(tb.ws_lb, tb.ws_ub, jb.ws_lb, jb.ws_ub):
        _within_slack(gl.numpy(), gu.numpy(), np.asarray(wl), np.asarray(wu))


def test_keep_one_alive_matches_jax():
    from fairify_tpu.ops import masks as jmasks
    from fairify_tpu_torch.ops import masks as tmasks

    rng = np.random.default_rng(0)
    cases = [rng.integers(0, 2, size=(5, 4)).astype(np.float32),
             np.ones((3, 4), np.float32), np.ones((4,), np.float32)]
    for d in cases:
        np.testing.assert_array_equal(tmasks.keep_one_alive([d])[0],
                                      np.asarray(jmasks.keep_one_alive([d])[0]))
