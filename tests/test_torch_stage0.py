"""The port's stage-0 segment (KB + KC plain versions) against the JAX
package's mega kernel, on the same grid, net and attack streams.

Per segment the packed buffers — ``cert``, ``wit``, ``reason`` and the
int32 ``fold`` — must be equal.  The certified margin and the attack gap are
f32 values summed in another order: they agree to rel 1e-4 of their scale
(the tied bound's magnitude for a margin, the box's largest |logit| for a
gap) + abs 1e-5.  A histogram bucket may differ only for a row whose value
lies within that tolerance of a bucket edge.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairify_tpu.models import mlp as jmlp
from fairify_tpu.obs import funnel as jfunnel
from fairify_tpu.resilience import integrity as jintegrity
from fairify_tpu.verify import engine as jengine
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu.verify.property import encode as jencode
from fairify_tpu_torch.models import mlp as tmlp
from fairify_tpu_torch.obs import funnel as tfunnel
from fairify_tpu_torch.resilience import integrity as tintegrity
from fairify_tpu_torch.verify import engine as tengine
from fairify_tpu_torch.verify import presets as tpresets
from fairify_tpu_torch.verify import sweep as tsweep
from fairify_tpu_torch.verify.config import EngineConfig
from fairify_tpu_torch.verify.property import encode as tencode

TOL_REL, TOL_ABS = 1e-4, 1e-5


def _net(sizes, seed):
    if sizes == "twin":
        from __graft_entry__ import _flagship_net

        net = _flagship_net()
        return [np.asarray(w) for w in net.weights], [np.asarray(b) for b in net.biases]
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=np.sqrt(2.0 / a), size=(a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(scale=0.1, size=(b,)).astype(np.float32) for b in sizes[1:]]
    return ws, bs


# (preset, net, partitions, grid_chunk, mega_chunks)
CASES = {
    "gc_twin": ("GC", "twin", 201, 2048, 4),
    "gc_deep_segments": ("GC", (20, 16, 8, 1), 100, 32, 2),
    "relaxed_ac_ra": ("relaxed-AC", (13, 16, 8, 1), 40, 16, 2),
}


def _within(got, want, scale):
    tol = TOL_REL * np.maximum(np.abs(want), scale) + TOL_ABS
    big = np.abs(want) >= 3e38
    assert (big == (np.abs(got) >= 3e38)).all()
    assert (np.abs(got - want)[~big] <= tol[~big]).all(), \
        float(np.abs(got - want)[~big].max())
    return tol


def _bucket_diff_ok(got, want, tol, ok):
    """Rows whose bucket differs must lie within tol of an edge; returns the
    histogram difference those rows explain."""
    bg, bw = tfunnel.bucketize(got), jfunnel.bucketize(want)
    moved = (bg != bw) & ok
    for v, t in zip(want[moved], tol[moved]):
        assert np.min(np.abs(jfunnel.EDGES - v)) <= t, (v, t)
    return (np.bincount(bg[ok], minlength=jfunnel.N_BUCKETS)
            - np.bincount(bw[ok], minlength=jfunnel.N_BUCKETS))


@pytest.mark.parametrize("case", sorted(CASES))
def test_mega_segment_matches_jax(case):
    preset, sizes, P, chunk, mega = CASES[case]
    ws, bs = _net(sizes, seed=len(case))
    eng_kw = dict(frontier_size=512, attack_samples=32, bab_attack_samples=16)
    jcfg = jpresets.get(preset).with_(
        grid_chunk=chunk, mega_chunks=mega, exact_certify_masks=False,
        engine=jengine.EngineConfig(**eng_kw))
    tcfg = tpresets.get(preset).with_(
        grid_chunk=chunk, mega_chunks=mega, exact_certify_masks=False,
        engine=EngineConfig(**eng_kw))
    _, lo, hi = jsweep.build_partitions(jcfg)
    lo, hi = lo[:P], hi[:P]
    jenc, tenc = jencode(jcfg.query()), tencode(tcfg.query())
    jnet = jmlp.from_numpy(ws, bs)
    tnet = tmlp.from_numpy(ws, bs, device="cpu")
    step, segs = jsweep._segment_spans(P, chunk, mega)
    av, pm, rm = (jnp.asarray(a) for a in jengine._enc_tensors(jenc, lo.shape[1]))
    for seg_s, seg_e, chunks in segs:
        ins = jsweep._mega_chunk_inputs(jenc, lo, hi, jcfg, chunks, step, 0,
                                        canary=True)
        (x_lo, x_hi, xp_lo, xp_hi, plo, phi, valid, xr, pr, nv) = ins
        jout = jsweep._mega_stage0_kernel(
            jnet, *(jnp.asarray(a) for a in (x_lo, x_hi, xp_lo, xp_hi, plo, phi)),
            av, pm, rm, float(jenc.eps), jnp.asarray(valid),
            jnp.asarray(jenc.valid_pair), jnp.asarray(xr), jnp.asarray(pr),
            jnp.asarray(nv), alpha_iters=0)
        jhost = dict(zip(("cert", "wit", "reason", "stats", "csum"),
                         (np.asarray(a) for a in jout)))
        thost, _ctx = tsweep.mega_segment(tnet, tenc, lo, hi, tcfg, chunks, step, 0)
        for k in ("cert", "wit", "reason"):
            np.testing.assert_array_equal(thost[k], jhost[k], err_msg=k)
        assert int(thost["csum"]) == int(jhost["csum"])
        assert tintegrity.verify_segment(thost) is None
        assert jintegrity.fold_host(thost) == int(thost["csum"])

        # Per-chunk margins and gaps, and the histogram's edge-only slack.
        tins = tsweep.mega_chunk_inputs(tenc, lo, hi, tcfg, chunks, step, 0,
                                        canary=True)
        for a, b in zip(tins, ins):
            np.testing.assert_array_equal(a, b)
        hist_diff = np.zeros((2, jfunnel.N_BUCKETS), np.int64)
        for ci in range(len(nv)):
            jc = jengine._certify_attack_kernel(
                jnet, *(jnp.asarray(a[ci]) for a in (x_lo, x_hi, xp_lo, xp_hi,
                                                     plo, phi)),
                av, pm, rm, float(jenc.eps), jnp.asarray(valid[ci]),
                jnp.asarray(jenc.valid_pair), jnp.asarray(xr[ci]),
                jnp.asarray(pr[ci]), alpha_iters=0)
            j_margin, j_gap = np.asarray(jc[4]), np.asarray(jc[5])
            T = lambda a: torch.as_tensor(a)
            cert, _score, margin, scale = tengine.certify_impl(
                tnet, *(T(a[ci]) for a in (x_lo, x_hi, xp_lo, xp_hi, plo, phi)),
                *(T(np.asarray(a)) for a in (av, pm, rm)), float(tenc.eps),
                T(valid[ci]), T(tenc.valid_pair), with_scale=True)
            ok = np.arange(valid.shape[1]) < nv[ci]
            _wit, _reason, gap, stats, _fold = tengine.attack_flips(
                tnet, T(xr[ci]), T(pr[ci]), T(valid[ci]), T(tenc.valid_pair),
                cert, margin, T(ok))
            tol_m = _within(margin.numpy(), j_margin, scale.numpy())
            lx, lp = tengine.attack_logits(tnet, T(xr[ci]), T(pr[ci]))
            lscale = torch.maximum(lx.abs().amax(dim=(1, 2)),
                                   lp.abs().amax(dim=(1, 2))).numpy()
            tol_g = _within(gap.numpy(), j_gap, lscale)
            hist_diff[0] += _bucket_diff_ok(margin.numpy(), j_margin, tol_m, ok)
            hist_diff[1] += _bucket_diff_ok(gap.numpy(), j_gap, tol_g, ok)
        np.testing.assert_array_equal(thost["stats"].astype(np.int64)
                                      - jhost["stats"].astype(np.int64), hist_diff)


def test_canary_chunk_answers_analytically():
    ws, bs = _net((20, 8, 1), 1)
    tnet = tmlp.from_numpy(ws, bs, device="cpu")
    cfg = tpresets.get("GC").with_(exact_certify_masks=False,
                                   engine=EngineConfig(attack_samples=8))
    enc = tencode(cfg.query())
    _, lo, hi = tsweep.build_partitions(cfg)
    host, _ = tsweep.mega_segment(tnet, enc, lo[:10], hi[:10], cfg, [(0, 10)], 10, 0)
    assert tintegrity.check_canary(host)
    bad = dict(host, cert=host["cert"].copy())
    bad["cert"][-1, 0] = False
    assert tintegrity.verify_segment(bad) == "checksum"


def test_fold_wraps_like_int32():
    big = torch.tensor([2**31 - 1, 1, 2**31 - 1, 2**31 - 1], dtype=torch.int32)
    for bufs in ((big[:2],), (big,), (big, big[:1])):
        want = jintegrity.fold_host({str(i): b.numpy() for i, b in enumerate(bufs)},
                                    keys=[str(i) for i in range(len(bufs))])
        assert tengine.fold_int32(*bufs) == want
    assert tengine.fold_int32(big[:2]) == -2**31


def test_funnel_copy_matches_reference():
    np.testing.assert_array_equal(tfunnel.EDGES, jfunnel.EDGES)
    assert tfunnel.N_BUCKETS == jfunnel.N_BUCKETS
    assert set(jfunnel.STATES) <= set(tfunnel.STATES)
    for args in (("unsat", "stage0"), ("sat", "stage0"), ("unknown", "bab", None, "deadline"),
                 ("unknown", "degraded", "launch.decode:fatal")):
        assert tfunnel.classify(*args) == jfunnel.classify(*args)


# --------------------------------------------------------------------------
# certify_attack over live rows (the host frontier's batches) and the
# lowest flat witness


def _frontier_case(preset, ws, bs, F, S, seed):
    """A host-frontier batch of ``F`` grid boxes of ``preset`` with ``S``
    attack candidates each (numpy ``default_rng(seed)``), as tensors for
    both packages."""
    cfg = tpresets.get(preset)
    tenc, jenc = tencode(cfg.query()), jencode(jpresets.get(preset).query())
    _, lo, hi = tsweep.build_partitions(cfg)
    lo, hi = lo[:F], hi[:F]
    flo, fhi = lo.astype(np.float32), hi.astype(np.float32)
    from fairify_tpu_torch.verify.property import role_boxes
    boxes = role_boxes(tenc, flo, fhi)  # x_lo, x_hi, xp_lo, xp_hi, valid
    xr, pr = tengine.build_attack_candidates(tenc, np.random.default_rng(seed), lo, hi, S)
    av, pm, rm = tengine.enc_tensors(tenc, lo.shape[1])
    ins = (*boxes[:4], flo, fhi, av, pm, rm)
    return tenc, jenc, ins, boxes[4], xr, pr


def _certify_attack_both(ws, bs, tenc, jenc, ins, valid, xr, pr, live=None):
    T = torch.as_tensor
    tout = tengine.certify_attack(
        tmlp.from_numpy(ws, bs, device="cpu"), *(T(a) for a in ins), float(tenc.eps),
        T(valid), T(tenc.valid_pair), T(xr), T(pr), live=live)
    jout = jengine._certify_attack_kernel(
        jmlp.from_numpy(ws, bs), *(jnp.asarray(a) for a in ins), float(jenc.eps),
        jnp.asarray(valid), jnp.asarray(jenc.valid_pair), jnp.asarray(xr),
        jnp.asarray(pr), alpha_iters=0)
    return [t.numpy() for t in tout], [np.asarray(a) for a in jout]


@pytest.mark.parametrize("live", [1, 17])
def test_certify_attack_live_rows(live):
    """``certify_attack(..., live=k)`` (the host frontier's batch of k real
    boxes in an F-row pad) equals the full call on its first k rows and
    JAX's ``_certify_attack_kernel`` there (cert, found, witness equal;
    margin, gap and score within TOL_REL of their scale + TOL_ABS); the
    rows past k are ``fill_past``'s."""
    ws, bs = _net((13, 16, 8, 1), 11)
    tenc, jenc, ins, valid, xr, pr = _frontier_case("AC", ws, bs, 32, 16, 5)
    full, jfull = _certify_attack_both(ws, bs, tenc, jenc, ins, valid, xr, pr)
    part, _ = _certify_attack_both(ws, bs, tenc, jenc, ins, valid, xr, pr, live=live)
    for f, p, j in zip(full, part, jfull):
        np.testing.assert_array_equal(p[:live], f[:live])
        np.testing.assert_array_equal(p[live:], np.repeat(f[live - 1:live], 32 - live, 0))
        np.testing.assert_array_equal(
            p, tengine.fill_past(torch.as_tensor(f), live).numpy())
    cert, score, found, wit, margin, gap = (a[:live] for a in part)
    jc, js, jf, jw, jm, jg = (a[:live] for a in jfull)
    np.testing.assert_array_equal(cert, jc)
    np.testing.assert_array_equal(found, jf)
    np.testing.assert_array_equal(wit, jw)
    _within(margin, jm, np.abs(jm))
    _within(gap, jg, np.abs(jg))
    _within(score, js, np.abs(js).max(axis=1, keepdims=True))


def test_many_flips_take_the_lowest_flat_witness():
    """A box with many strict flips returns JAX's witness, the lowest flat
    (s, a, b) index among its hits (the kernel's ballot scan and the plain
    version's minimum hit index both give it)."""
    rng = np.random.default_rng(3)
    d, pa = 13, 8
    g = rng.normal(size=d).astype(np.float32)
    g[pa] = 0.0
    # A logit 10 x_pa + g.x - c (through two ReLU units): x with the
    # protected value 1 and x' with 0 flip wherever c - 10 < g.x < c.
    z = np.concatenate([g[:, None], -g[:, None]], 1)
    z[pa] = (10.0, -10.0)
    ws = [z, np.array([[1.0], [-1.0]], np.float32)]
    tenc, jenc, ins, valid, xr, pr = _frontier_case("AC", ws, [np.zeros(2, np.float32),
                                                              np.zeros(1, np.float32)],
                                                    24, 64, 9)
    gx = (xr[..., 0, :] * g).sum(-1)  # (B, S): g.x of each sample
    c = np.float32(np.median(gx) + 5.0)
    bs = [np.array([-c, c], np.float32), np.zeros(1, np.float32)]
    tout, jout = _certify_attack_both(ws, bs, tenc, jenc, ins, valid, xr, pr)
    found, wit = tout[2], tout[3]
    np.testing.assert_array_equal(found, jout[2])
    np.testing.assert_array_equal(wit, jout[3])
    logit = lambda x: (np.maximum(x @ ws[0] + bs[0], 0) @ ws[1] + bs[1])[..., 0]
    lx, lp = logit(xr), logit(pr)  # (B, S, V)
    hits = ((lx[..., :, None] > 0) & (lp[..., None, :] < 0)) | (
        (lx[..., :, None] < 0) & (lp[..., None, :] > 0))
    hits &= valid[:, None, :, None] & valid[:, None, None, :] & tenc.valid_pair
    flat = hits.reshape(hits.shape[0], -1)
    many = flat.sum(1) >= 8
    assert many.sum() >= 4 and (wit[many, 0] > 0).any()
    first = flat.argmax(1)
    np.testing.assert_array_equal((wit[:, 0] * 2 + wit[:, 1]) * 2 + wit[:, 2],
                                  np.where(flat.any(1), first, 0))
