"""Launch geometry and packs of the warp-tile kernels, on the CPU.

``engine.attack_logits_geometry``, ``engine.pgd_geometry``,
``engine.bab_geometry``, ``engine.sign_bound_geometry``,
``engine.kb_geometry``, ``engine.inter_bounds_geometry``,
``engine.role_bounds_geometry``, ``engine.k7_geometry`` and
``lattice.lattice_geometry`` size the
launches of ``csrc/attack_logits.cu`` (rows 17, 9, 21),
``csrc/pgd_attack.cu`` (K5), ``csrc/bab_segment.cu`` (K6),
``csrc/sign_bound.cu`` (K8a), ``csrc/stage0_certify.cu`` (KB: rows 4-7, 14,
15), ``csrc/inter_bounds.cu`` (K8b), ``csrc/role_bounds.cu`` (rows 13 and
8, and K7) and the lattice signs kernel of ``csrc/lattice_scan.cu`` (K9a/b/c), and
the C entry points refuse
any other shared-memory size; so these tests hold the geometry at an
H100's 132 SMs and 227 KB (232,448 bytes) of shared memory a block, for
the nets the repo runs, without a card:

* every launch's shared memory fits, at the main path's shapes;
* K5 at B = 1, R = 96, V = 2 (the heuristic retry) spreads over at least
  96 blocks, and at B = 2,048 runs full tiles;
* a 32,768-row attack forward (the host frontier's F = 512) fills all 132
  SMs, and so does the lattice forward of a 2^18-point chunk;
* K6 keeps two slots resident per SM at AC-S1 widths, V = 2, and its
  cooperative grid is what the card holds resident;
* K8a and KB fit every net at V = 2 and 5 within an SM's shared memory
  and the 512-thread register cap, K8a keeps two boxes resident per SM at
  AC-S1 widths and takes its most warps for a launch of at most one box an
  SM, KB keeps two boxes resident per SM at AC-S1 widths, V = 2; the
  per-model odd-stride pack of a family of M = 1, 4 and 11 models is each
  model's own pack back to back;
* K8b and rows 13/8 fit every net at V = 2 and 5, their shared-memory
  sums those of the kernels' layouts; at AC-S1 K8b's many-box geometry
  keeps two blocks an SM and a grid of one wave, Phase P's 2V role boxes
  take its one-box-a-block geometry with a warp per column pair, and row
  13's IBP tiles at the host frontier's F = 512 give every warp one tile;
* K7 fits every net at B = 1, 17, 132, 133, 512 and 2,048, its
  shared-memory sum that of the kernel's layout, each α side on a warp of
  its own; up to 8 boxes an SM the blocks make one wave, and at AC-S1, B =
  512, 4 boxes a block fill 128 of the 132 SMs;
* KA, row 3 and KD (``pruning.sim_geometry``, ``csrc/sim_tile.cuh``) fit
  every net at GC-1's 201 partitions, a 2,048-row chunk, the AC segment's
  8,192 and row 3's 16,000, their shared-memory sums that of the kernels'
  layout; at GC-1 the grid covers every SM, at AC-S1 widths a block is one
  partition;
* KC (``engine.attack_flips_geometry``, ``csrc/attack_flips.cu``) fits
  every net at S = 16 and 128, V = 2 and 5, one model or four, its
  shared-memory sum that of the kernel's layout; its grid fills the card
  when the boxes do, every group of warps has a box, an AC segment or
  chunk takes one or two warps a box and the host frontier's few live
  boxes spread a box over four;
* K12 (``pruning.sim_rows_geometry``) draws one value a thread over
  ceil(S / (256 // d)) blocks a partition, and refuses what its 32-bit
  index arithmetic and its by-value boxes cannot take;
* a forced geometry that does not fit raises;
* the padded and odd-stride packs are the layouts the kernels read, and
  every pack is built once per net: a net's ``with_masks`` copy gets its
  own, equal to a fresh pack.
"""
import numpy as np
import pytest
import torch

from fairify_tpu_torch.models.mlp import flagship_net, seeded_net
from fairify_tpu_torch.ops import lattice as lattice_ops
from fairify_tpu_torch.utils import cuda_build
from fairify_tpu_torch.verify import engine, pruning

SMS = 132
LIMIT = 232448
SM_BYTES = 233472  # shared memory of one H100 SM; each resident block takes 1,024 more
QS = 513  # the device BaB's queue: frontier 512 plus the integrity canary

# Widths (d, hidden..., 1) of the nets the kernels run.  The four trained
# nets' are the layer shapes of their .h5 files:
#   models_scaled/adult/AC-S1.h5: 13x128, 128x64, 64x32, 32x16, 16x8, 8x1
#   models_scaled/adult/AC-S2.h5: 13x128, 128x64, 64x64, 64x32, 32x16, 16x8, 8x1
#   models_scaled/bank/BM-S1.h5: 16x128, 128x64, 64x32, 32x16, 16x1
#   models_scaled/bank/BM-S2.h5: 16x128, 128x64, 64x32, 32x32, 32x16, 16x8, 8x1
# The GC-1 twin is models/mlp.py:flagship_net; the CP and DF twins are
# chip_smoke.py's ZOO_FAMILIES.
NETS = {
    "AC-S1": (13, 128, 64, 32, 16, 8, 1),
    "AC-S2": (13, 128, 64, 64, 32, 16, 8, 1),
    "BM-S1": (16, 128, 64, 32, 16, 1),
    "BM-S2": (16, 128, 64, 32, 32, 16, 8, 1),
    "GC-1": (20, 50, 1),
    "CP": (6, 32, 32, 1),
    "DF": (30, 16, 16, 16, 1),
}
H5 = {"AC-S1": "models_scaled/adult/AC-S1.h5", "AC-S2": "models_scaled/adult/AC-S2.h5",
      "BM-S1": "models_scaled/bank/BM-S1.h5", "BM-S2": "models_scaled/bank/BM-S2.h5"}


def test_cited_widths_are_the_trained_nets():
    pytest.importorskip("h5py")
    from pathlib import Path

    from fairify_tpu.models.ingest import load_keras_h5

    root = Path(__file__).resolve().parents[1]
    for name, path in H5.items():
        net = load_keras_h5(root / path)
        widths = (net.weights[0].shape[0],) + tuple(w.shape[1] for w in net.weights)
        assert widths == NETS[name], name
    assert (flagship_net(device="cpu").in_dim,) + flagship_net(device="cpu").layer_sizes \
        == NETS["GC-1"]


@pytest.mark.parametrize("name", sorted(NETS))
def test_attack_logits_geometry_fits_and_fills_the_card(name):
    sizes = NETS[name]
    for rows, models in ((32768, 1), (1 << 20, 1), (1 << 20, 4), (1 << 20, 11), (1024, 1)):
        g = engine.attack_logits_geometry(sizes, rows, models, sms=SMS, smem_limit=LIMIT)
        assert g["smem"] == engine.attack_logits_smem(sizes, g["tw"], g["warps"]) <= LIMIT
        assert 1 <= g["warps"] <= engine.AL_MAX_WARPS and g["threads"] == 32 * g["warps"]
        assert g["tiles"] * g["tw"] >= rows
        # Every warp of the grid has a tile, and the grid is at most the card.
        assert (g["grid"] - 1) * g["warps"] < g["tiles"]
        assert g["blocks"] <= SMS + models - 1
    # The host frontier's batch (F = 512, 16 candidates, V = 2, both roles)
    # fills every SM.
    g = engine.attack_logits_geometry(sizes, 32768, sms=SMS, smem_limit=LIMIT)
    assert g["blocks"] >= SMS
    # A family of four on a chunk: every model's blocks together fill it.
    g = engine.attack_logits_geometry(sizes, 1 << 20, 4, sms=SMS, smem_limit=LIMIT)
    assert g["blocks"] >= SMS


@pytest.mark.parametrize("name", sorted(NETS))
def test_pgd_geometry_fits_and_follows_the_work(name):
    sizes = NETS[name]
    R = 96
    one = engine.pgd_geometry(sizes, 1 * R, 2, sms=SMS, smem_limit=LIMIT)
    assert one["ttw"] == 1 and one["tw"] == 4 and one["grid"] * one["warps"] >= R
    assert one["grid"] >= 96  # the retry's 96 trajectories on 96 blocks
    full = engine.pgd_geometry(sizes, 2048 * R, 2, sms=SMS, smem_limit=LIMIT)
    assert full["ttw"] == engine.K5_MAX_ROWS // 4  # full tiles: 4 trajectories, 16 rows
    assert full["tiles"] * full["ttw"] == 2048 * R and full["grid"] == SMS
    relaxed = engine.pgd_geometry(sizes, 64 * R, 5, sms=SMS, smem_limit=LIMIT)
    assert relaxed["ttw"] == 1 and relaxed["tw"] == 12
    for g, V in ((one, 2), (full, 2), (relaxed, 5)):
        assert g["smem"] == engine.pgd_smem(sizes, g["ttw"], g["tw"], g["warps"]) <= LIMIT
        assert 1 <= g["warps"] <= engine.K5_MAX_WARPS
        assert g["tw"] % 4 == 0 and g["tw"] >= 2 * V * g["ttw"]
        assert (g["grid"] - 1) * g["warps"] < g["tiles"]


def test_forced_geometry_is_checked():
    sizes = NETS["AC-S1"]
    g = engine.pgd_geometry(sizes, 384, 2, sms=SMS, _force=(1, 1))
    assert (g["ttw"], g["tw"], g["warps"], g["grid"]) == (1, 4, 1, SMS)
    g = engine.attack_logits_geometry(sizes, 1 << 20, sms=SMS, _force=(4, 1))
    assert (g["tw"], g["warps"], g["grid"]) == (4, 1, SMS)
    with pytest.raises(ValueError):
        engine.pgd_geometry(sizes, 384, 2, sms=SMS, _force=(4, engine.K5_MAX_WARPS + 1))
    with pytest.raises(ValueError):
        engine.attack_logits_geometry(sizes, 1024, sms=SMS, _force=(16, 13))
    wide = (13, 4096, 1)  # a net whose one warp tile exceeds shared memory
    with pytest.raises(ValueError, match="shared memory"):
        engine.pgd_geometry(wide, 96, 2, sms=SMS)


@pytest.mark.parametrize("nout,tw,want", [
    (128, 16, (8, 8)), (64, 16, (8, 4)), (32, 16, (4, 4)), (16, 16, (4, 2)),
    (8, 16, (4, 1)), (50, 16, (8, 4)), (128, 4, (4, 4)), (64, 4, (4, 2)),
    (32, 4, (4, 1)), (13, 12, (4, 2)), (1, 16, (4, 1))])
def test_tile_menu_takes_the_shortest_lane_chain(nout, tw, want):
    """csrc/warp_tile.cuh:pick_tile's rule, mirrored: the tile with the
    fewest instructions per lane and k-step over all its passes, the
    larger on a tie."""
    assert cuda_build.TILES[cuda_build.pick_tile(nout, tw)] == want


def test_padded_pack_layout():
    net = seeded_net((5, 9, 3, 1), seed=4, device="cpu")
    params, dims, M = cuda_build.pack_padded(net)
    lay = cuda_build.pad_layout(list(dims))
    assert M == 1 and list(dims) == [5, 9, 3, 1] and params.numel() == lay["total"]
    for l, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        n_in, n_out = w.shape
        ldw, ldt = lay["ldw"][l], lay["ldt"][l]
        assert ldw % 8 == 0 and ldt % 8 == 0 and lay["w"][l] % 8 == 0
        wp = params[lay["w"][l]:lay["w"][l] + n_in * ldw].view(n_in, ldw)
        assert torch.equal(wp[:, :n_out], w) and not wp[:, n_out:].any()
        assert torch.equal(params[lay["b"][l]:lay["b"][l] + n_out], b)
        assert torch.equal(params[lay["m"][l]:lay["m"][l] + n_out], m)
        wt = params[lay["wt"][l]:lay["wt"][l] + n_out * ldt].view(n_out, ldt)
        assert torch.equal(wt[:, :n_in], w.t()) and not wt[:, n_in:].any()
    from fairify_tpu_torch.parallel.mesh import stack_models

    nets = [net, seeded_net((5, 9, 3, 1), seed=5, device="cpu")]
    sp, _, SM = cuda_build.pack_padded(stack_models(nets))
    assert SM == 2 and torch.equal(sp, torch.cat([cuda_build.pack_padded(n)[0] for n in nets]))


def test_packs_are_built_once_per_net():
    net = seeded_net((6, 8, 4, 1), seed=1, device="cpu")
    for pack in (cuda_build.pack_net, cuda_build.pack_padded):
        assert pack(net)[0] is pack(net)[0]  # built once, then reused
    masks = [torch.ones_like(m) for m in net.masks]
    masks[0][3] = 0.0
    other = net.with_masks(masks)
    for pack, fresh in ((cuda_build.pack_net, cuda_build._pack_net),
                        (cuda_build.pack_padded, cuda_build._pack_padded)):
        a, b = pack(net)[0], pack(other)[0]
        assert a is not b and not torch.equal(a, b)
        assert torch.equal(a, fresh(net)[0]) and torch.equal(b, fresh(other)[0])
    np.testing.assert_array_equal(cuda_build.pack_models(net)[0].numpy(),
                                  cuda_build.pack_net(net)[0].numpy())
    # An in-place change of a parameter (which the port never makes) is seen.
    third = seeded_net((6, 8, 4, 1), seed=2, device="cpu")
    before = cuda_build.pack_net(third)[0]
    with torch.no_grad():
        third.biases[0].add_(1.0)
    after = cuda_build.pack_net(third)[0]
    assert after is not before and torch.equal(after, cuda_build._pack_net(third)[0])


@pytest.mark.parametrize("name", sorted(NETS))
def test_bab_geometry_fits_and_stays_resident(name):
    sizes = NETS[name]
    for V in (2, 5):
        g = engine.bab_geometry(sizes, V, QS, sms=SMS, smem_limit=LIMIT)
        assert g["smem"] == engine.bab_smem(sizes, V, g["warps"]) <= LIMIT
        assert 1 <= g["warps"] <= engine.K6_MAX_WARPS and g["threads"] == 32 * g["warps"]
        # One α side of every role box has a warp of its own.
        assert g["warps"] == min(engine.K6_MAX_WARPS, 4 * V)
        # The cooperative grid: every block resident at once.
        assert g["per_sm"] * (g["smem"] + 1024) <= SM_BYTES
        assert g["per_sm"] * g["warps"] <= engine.K6_SM_WARPS
        assert g["grid"] == min(QS, g["per_sm"] * SMS)
    small = engine.bab_geometry(sizes, 2, 9, sms=SMS, smem_limit=LIMIT)
    assert small["grid"] == 9  # never more blocks than slots


def test_bab_keeps_two_slots_per_sm_at_ac_s1():
    g = engine.bab_geometry(NETS["AC-S1"], 2, QS, sms=SMS, smem_limit=LIMIT)
    assert g["per_sm"] >= 2 and g["grid"] >= 2 * SMS
    assert engine.bab_geometry(NETS["AC-S1"], 2, QS, sms=SMS, smem_limit=LIMIT,
                               live=engine.K6_FEW_LIVE + 1) == g


@pytest.mark.parametrize("name", sorted(NETS))
def test_bab_few_live_slots_take_the_latency_geometry(name):
    """A segment that starts with few live slots is one slot's critical
    path: the most warps that fit, one block an SM, every SM."""
    sizes = NETS[name]
    for V in (2, 5):
        g = engine.bab_geometry(sizes, V, QS, sms=SMS, smem_limit=LIMIT,
                                live=engine.K6_FEW_LIVE)
        assert g["per_sm"] == 1 and g["grid"] == SMS
        assert g["warps"] == engine.K6_MAX_WARPS  # every repo net fits 16 warps
        assert g["smem"] == engine.bab_smem(sizes, V, g["warps"]) <= LIMIT


@pytest.mark.parametrize("name", sorted(NETS))
def test_lattice_geometry_fits_and_fills_the_card(name):
    sizes = NETS[name]
    for V in (2, 5):
        g = lattice_ops.lattice_geometry(sizes, V, 1 << 18, sms=SMS, smem_limit=LIMIT)
        assert g["smem"] == lattice_ops.lattice_smem(sizes, g["tw"], g["warps"], V) <= LIMIT
        assert 1 <= g["warps"] <= lattice_ops.LAT_MAX_WARPS and g["threads"] == 32 * g["warps"]
        assert 64 % g["tw"] == 0 and g["tiles"] * g["tw"] >= 1 << 18
        assert g["grid"] == SMS  # a 2^18-point chunk fills all 132 SMs
        assert (g["grid"] - 1) * g["warps"] < g["tiles"]
        tail = lattice_ops.lattice_geometry(sizes, V, 100, sms=SMS, smem_limit=LIMIT)
        assert tail["grid"] * tail["warps"] * tail["tw"] >= 100
        assert tail["grid"] <= -(-100 // tail["tw"])


def test_forced_k6_and_k9_geometry_is_checked():
    sizes = NETS["AC-S1"]
    g = engine.bab_geometry(sizes, 2, QS, sms=SMS, _force=(4, 1))
    assert (g["warps"], g["per_sm"], g["grid"]) == (4, 1, SMS)
    with pytest.raises(ValueError):
        engine.bab_geometry(sizes, 2, QS, sms=SMS, _force=(8, 3))  # 3 x 106 KB
    with pytest.raises(ValueError):
        engine.bab_geometry(sizes, 2, QS, sms=SMS, _force=(engine.K6_MAX_WARPS + 1, 1))
    g = lattice_ops.lattice_geometry(sizes, 2, 1 << 18, sms=SMS, _force=(4, 1))
    assert (g["tw"], g["warps"], g["grid"]) == (4, 1, SMS)
    with pytest.raises(ValueError):
        lattice_ops.lattice_geometry(sizes, 2, 1 << 18, sms=SMS, _force=(16, 8))  # > 227 KB
    with pytest.raises(ValueError):
        lattice_ops.lattice_geometry(sizes, 2, 1 << 18, sms=SMS, _force=(12, 1))  # not | 64
    wide = (13, 4096, 1)  # a net whose one warp or block exceeds shared memory
    with pytest.raises(ValueError, match="shared memory"):
        engine.bab_geometry(wide, 2, QS, sms=SMS)
    with pytest.raises(ValueError, match="shared memory"):
        lattice_ops.lattice_geometry(wide, 2, 1 << 18, sms=SMS)


def test_odd_pack_layout():
    net = seeded_net((5, 9, 4, 1), seed=4, device="cpu")
    params, dims = cuda_build.pack_odd(net)
    lay = cuda_build.odd_layout(list(dims))
    assert list(dims) == [5, 9, 4, 1] and params.numel() == lay["padded"]
    assert lay["padded"] % 4 == 0 and lay["padded"] - lay["total"] < 4
    for l, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        n_in, n_out = w.shape
        ld = lay["ldw"][l]
        assert ld % 2 == 1 and n_out <= ld <= n_out + 1
        wp = params[lay["w"][l]:lay["w"][l] + n_in * ld].view(n_in, ld)
        assert torch.equal(wp[:, :n_out], w) and not wp[:, n_out:].any()
        assert torch.equal(params[lay["b"][l]:lay["b"][l] + n_out], b)
        assert torch.equal(params[lay["m"][l]:lay["m"][l] + n_out], m)
    assert cuda_build.pack_odd(net)[0] is params  # built once per net


@pytest.mark.parametrize("name", sorted(NETS))
def test_sign_bound_geometry_fits_and_stays_resident(name):
    sizes = NETS[name]
    for live in (None, 1, SMS, SMS + 1, 512):
        g = engine.sign_bound_geometry(sizes, live=live, sms=SMS, smem_limit=LIMIT)
        assert g["smem"] == engine.sign_bound_smem(sizes, g["warps"]) <= LIMIT
        assert 1 <= g["warps"] <= engine.K8A_MAX_WARPS and g["threads"] == 32 * g["warps"]
        assert g["warps"] & (g["warps"] - 1) == 0  # a power of two
        # No more warps than the widest layer past the first has column pairs.
        assert g["warps"] <= max([(n + 1) // 2 for n in sizes[2:]] or [1])
        assert g["per_sm"] >= 1 and g["per_sm"] * (g["smem"] + 1024) <= SM_BYTES
        assert g["per_sm"] * g["warps"] <= engine.K6_SM_WARPS
    few = engine.sign_bound_geometry(sizes, live=SMS, sms=SMS, smem_limit=LIMIT)
    many = engine.sign_bound_geometry(sizes, live=SMS + 1, sms=SMS, smem_limit=LIMIT)
    assert few["warps"] >= many["warps"]
    assert many == engine.sign_bound_geometry(sizes, sms=SMS, smem_limit=LIMIT)


def test_sign_bound_keeps_two_boxes_per_sm_at_ac_s1():
    sizes = NETS["AC-S1"]
    g = engine.sign_bound_geometry(sizes, live=512, sms=SMS, smem_limit=LIMIT)
    assert (g["warps"], g["per_sm"]) == (4, 2)
    # One box an SM or fewer: one box's critical path, the most warps (the
    # workspaces are carved per layer, so 16 fit).
    g = engine.sign_bound_geometry(sizes, live=8, sms=SMS, smem_limit=LIMIT)
    assert (g["warps"], g["per_sm"]) == (16, 1)


@pytest.mark.parametrize("V", [2, 5])
@pytest.mark.parametrize("name", sorted(NETS))
def test_kb_geometry_fits_every_net(name, V):
    sizes = NETS[name]
    g = engine.kb_geometry(sizes, V, smem_limit=LIMIT)
    assert g["smem"] == engine.kb_smem(sizes, V, g["warps"]) <= LIMIT
    # One α side of every role box has a warp of its own.
    assert g["warps"] == min(engine.KB_MAX_WARPS, 4 * V) and g["threads"] == 32 * g["warps"]
    assert g["per_sm"] >= 1 and g["per_sm"] * (g["smem"] + 1024) <= SM_BYTES
    assert g["per_sm"] * g["warps"] <= engine.K6_SM_WARPS
    # A forced geometry runs only where it fits.
    for w in range(1, engine.KB_MAX_WARPS + 1):
        if engine.kb_smem(sizes, V, w) <= LIMIT:
            assert engine.kb_geometry(sizes, V, smem_limit=LIMIT, _force=w)["warps"] == w
        else:
            with pytest.raises(ValueError, match="shared memory"):
                engine.kb_geometry(sizes, V, smem_limit=LIMIT, _force=w)


def test_kb_keeps_two_boxes_per_sm_at_ac_s1():
    g = engine.kb_geometry(NETS["AC-S1"], 2, smem_limit=LIMIT)
    assert (g["warps"], g["per_sm"]) == (8, 2)


def test_forced_k8a_and_kb_geometry_is_checked():
    sizes = NETS["AC-S1"]
    for w in (1, 2, 8, 16):
        g = engine.sign_bound_geometry(sizes, live=512, sms=SMS, _force=w)
        assert g["warps"] == w and g["smem"] == engine.sign_bound_smem(sizes, w)
    with pytest.raises(ValueError):
        engine.sign_bound_geometry(NETS["AC-S2"], _force=16)  # 16 workspaces > 227 KB
    with pytest.raises(ValueError):
        engine.sign_bound_geometry(sizes, _force=engine.K8A_MAX_WARPS + 1)
    with pytest.raises(ValueError):
        engine.sign_bound_geometry(sizes, _force=0)
    with pytest.raises(ValueError):
        engine.kb_geometry(sizes, 5, _force=engine.KB_MAX_WARPS + 1)
    wide = (13, 4096, 1)  # a net whose one warp or block exceeds shared memory
    with pytest.raises(ValueError, match="shared memory"):
        engine.sign_bound_geometry(wide)
    with pytest.raises(ValueError, match="shared memory"):
        engine.kb_geometry(wide, 2)


@pytest.mark.parametrize("M", [1, 4, 11])
def test_odd_pack_of_a_family_is_each_models_pack(M):
    from fairify_tpu_torch.parallel.mesh import stack_models

    nets = [seeded_net(NETS["CP"], seed=s, device="cpu") for s in range(M)]
    lay = cuda_build.odd_layout(list(NETS["CP"]))
    params, dims, got_m = cuda_build.pack_odd_models(stack_models(nets))
    assert got_m == M and list(dims) == list(NETS["CP"])
    assert params.numel() == M * lay["padded"] and lay["padded"] % 4 == 0
    for m, net in enumerate(nets):
        own = cuda_build.pack_odd(net)[0]
        assert torch.equal(params[m * lay["padded"]:(m + 1) * lay["padded"]], own)
    single, _, one = cuda_build.pack_odd_models(nets[0])
    assert one == 1 and single is cuda_build.pack_odd(nets[0])[0]
    with pytest.raises(TypeError):
        cuda_build.pack_odd(stack_models(nets))


def _ib_smem_mirror(sizes, per, warps):
    """inter_bounds.cu:ib_layout's bytes: the mbarrier's 4 floats, the
    odd-stride net rounded up to 4 floats, per box a role workspace
    (crown_warp.cuh:role_ws_floats) and per warp 8 maxw, rounded up."""
    r4 = lambda v: (v + 3) // 4 * 4
    d, nsum, maxw = sizes[0], sum(sizes[1:]), max(sizes)
    net = sum(a * (b | 1) + 2 * b for a, b in zip(sizes[:-1], sizes[1:]))
    return 4 * (4 + r4(net) + per * r4(5 * nsum + 2 * maxw + 2 * d) + warps * r4(8 * maxw))


def _rb_smem_mirror(sizes, V, tw, warps, crown):
    """role_bounds.cu:k10b_smem's bytes: CROWN as K8b's layout with the 2V
    role boxes of a box; IBP the padded net's forward part and per warp
    two interval buffers (lo, hi) of tw role boxes: buffer 0 the widest
    even hidden layer, buffer 1 the widest of the input and odd hidden
    layers."""
    if crown:
        return _ib_smem_mirror(sizes, 2 * V, warps)
    r8 = lambda v: (v + 7) // 8 * 8
    fwd = sum(a * r8(b) + 2 * r8(b) for a, b in zip(sizes[:-1], sizes[1:]))
    hidden = sizes[1:-1]
    h0 = max(hidden[0::2] or [0])
    h1 = max([sizes[0]] + list(hidden[1::2]))
    return 4 * (4 + fwd + warps * 2 * (h0 + h1) * tw)


@pytest.mark.parametrize("V", [2, 5])
@pytest.mark.parametrize("name", sorted(NETS))
def test_inter_bounds_and_role_bounds_geometry_fit_every_net(name, V):
    sizes = NETS[name]
    pairs = max([(n + 1) // 2 for n in sizes[2:]] or [1])
    for live in (1, 2 * V, SMS, SMS + 1, 512, 2048):
        g = engine.inter_bounds_geometry(sizes, live, sms=SMS, smem_limit=LIMIT)
        assert g["smem"] == engine.inter_bounds_smem(sizes, g["per"], g["warps"]) \
            == _ib_smem_mirror(sizes, g["per"], g["warps"]) <= LIMIT
        assert 1 <= g["warps"] <= min(engine.K8B_MAX_WARPS, pairs)
        assert g["threads"] == 32 * g["warps"] and 1 <= g["per"] <= live
        assert g["per_sm"] >= 1 and g["per_sm"] * (g["smem"] + 1024) <= SM_BYTES
        assert g["per_sm"] * g["warps"] <= engine.K6_SM_WARPS
        if live <= SMS:  # one box a block, every warp on its column pairs
            assert g["per"] == 1
    for rows, models in ((2 * 512 * V, 1), (2 * 2048 * V, 1), (2 * 2048 * V, 4),
                         (2 * 2048 * V, 11), (2 * V, 1)):
        g = engine.role_bounds_geometry(sizes, V, rows, models, sms=SMS, smem_limit=LIMIT)
        assert g["smem"] == engine.role_bounds_smem(sizes, V, g["tw"], g["warps"]) \
            == _rb_smem_mirror(sizes, V, g["tw"], g["warps"], False) <= LIMIT
        assert g["tw"] in engine.RB_TW and 1 <= g["warps"] <= engine.K10B_MAX_WARPS
        assert g["tiles"] * g["tw"] >= rows and (g["grid"] - 1) * g["warps"] < g["tiles"]
        assert g["grid"] * models <= g["per_sm"] * SMS + models - 1
    g = engine.role_bounds_geometry(sizes, V, 0, 1, use_crown=True, sms=SMS, smem_limit=LIMIT)
    assert g["smem"] == _rb_smem_mirror(sizes, V, 0, g["warps"], True) <= LIMIT
    assert g["warps"] == min(engine.K10B_MAX_WARPS, 4 * V)


def test_inter_bounds_and_role_bounds_geometry_at_ac_s1():
    sizes = NETS["AC-S1"]
    # Phase L's full block: two boxes a block at two blocks an SM, one wave.
    g = engine.inter_bounds_geometry(sizes, 512, sms=SMS, smem_limit=LIMIT)
    assert (g["warps"], g["per"], g["per_sm"]) == (8, 2, 2)
    assert -(-512 // g["per"]) <= g["per_sm"] * SMS
    # Phase P's 2V = 4 role boxes: one a block, a warp per column pair of
    # the 64-unit layer (32 pairs), at most 16.
    assert engine.inter_bounds_geometry(sizes, 4, sms=SMS, smem_limit=LIMIT)["warps"] == 16
    # Row 13 at the host frontier's F = 512, V = 2: 4-box tiles, one a warp.
    g = engine.role_bounds_geometry(sizes, 2, 2048, sms=SMS, smem_limit=LIMIT)
    assert (g["tw"], g["tiles"]) == (4, 512) and g["grid"] * g["warps"] == g["tiles"]
    # The M = 4 family chunk fills the card.
    g = engine.role_bounds_geometry(sizes, 2, 8192, 4, sms=SMS, smem_limit=LIMIT)
    assert g["grid"] * 4 >= SMS


def test_forced_k8b_and_row13_geometry_is_checked():
    sizes = NETS["AC-S1"]
    for f in ((16, 1), (8, 2), (1, 1), (4, 4)):
        g = engine.inter_bounds_geometry(sizes, 512, sms=SMS, _force=f)
        assert (g["warps"], g["per"]) == f
    for bad in ((17, 1), (0, 1), (8, 0), (16, 20)):  # (16, 20): 20 boxes > 227 KB
        with pytest.raises(ValueError):
            engine.inter_bounds_geometry(sizes, 512, sms=SMS, _force=bad)
    g = engine.role_bounds_geometry(sizes, 2, 8192, sms=SMS, _force=(8, 12))
    assert (g["tw"], g["warps"]) == (8, 12)
    for bad in ((8, 16), (6, 1), (4, 17), (128, 1)):  # (8, 16): 249 KB
        with pytest.raises(ValueError):
            engine.role_bounds_geometry(sizes, 2, 8192, sms=SMS, _force=bad)
    assert engine.role_bounds_geometry(sizes, 2, 0, use_crown=True, sms=SMS,
                                       _force=16)["warps"] == 16
    with pytest.raises(ValueError, match="shared memory"):
        engine.role_bounds_geometry(NETS["AC-S2"], 5, 0, use_crown=True, sms=SMS,
                                    _force=engine.K10B_MAX_WARPS + 1)
    wide = (13, 4096, 1)  # a net whose one warp or block exceeds shared memory
    with pytest.raises(ValueError, match="shared memory"):
        engine.inter_bounds_geometry(wide, 4)
    with pytest.raises(ValueError, match="shared memory"):
        engine.role_bounds_geometry(wide, 2, 2048)


def _k7_smem_mirror(sizes, per, warps):
    """role_bounds.cu:k7_layout's bytes: K8b's layout (``_ib_smem_mirror``)
    with per warp the larger of a column pair's 8 maxw and an α side's 2
    nsum + d + 3 maxw, then both form sets of every box (2d + 4 floats
    each) and the α best bounds (2 a box), each rounded up to 4 floats."""
    r4 = lambda v: (v + 3) // 4 * 4
    d, nsum, maxw = sizes[0], sum(sizes[1:]), max(sizes)
    wws = r4(max(8 * maxw, 2 * nsum + d + 3 * maxw))
    return (_ib_smem_mirror(sizes, per, 0) + 4 * warps * wws
            + 4 * (r4(2 * per * (2 * d + 4)) + r4(2 * per)))


K7_BOXES = (1, 17, SMS, SMS + 1, 512, 2048)


@pytest.mark.parametrize("name", sorted(NETS))
def test_k7_geometry_fits_every_net(name):
    sizes = NETS[name]
    for B in K7_BOXES:
        g = engine.k7_geometry(sizes, B, sms=SMS, smem_limit=LIMIT)
        assert g["smem"] == engine.k7_smem(sizes, g["per"], g["warps"]) \
            == _k7_smem_mirror(sizes, g["per"], g["warps"]) <= LIMIT
        assert 1 <= g["per"] <= engine.K7_MAX_PER and g["threads"] == 32 * g["warps"]
        # Every α side of the block's boxes has a warp of its own.
        assert 2 * g["per"] <= g["warps"] <= engine.K7_MAX_WARPS
        assert g["grid"] == -(-B // g["per"]) and (g["grid"] - 1) * g["per"] < B
        assert g["per_sm"] >= 1 and g["per_sm"] * (g["smem"] + 1024) <= SM_BYTES
        assert g["per_sm"] * g["warps"] <= engine.K6_SM_WARPS
        if B <= SMS:  # one box a block, every warp on its column pairs
            assert g["per"] == 1
        if B <= engine.K7_MAX_PER * SMS:  # one wave of blocks, one an SM
            assert g["grid"] <= SMS


def test_k7_fills_the_card_at_ac_s1():
    sizes = NETS["AC-S1"]
    # The 512 stage-0 leftovers: 4 boxes a block on 128 of the 132 SMs, all
    # in one wave, 16 warps (8 on the α sides, all 16 on the column pairs).
    g = engine.k7_geometry(sizes, 512, sms=SMS, smem_limit=LIMIT)
    assert (g["per"], g["warps"], g["grid"], g["per_sm"]) == (4, 16, 128, 1)
    assert g["grid"] >= SMS - g["per"] and g["grid"] <= g["per_sm"] * SMS
    # One box takes one block of 16 warps.
    g = engine.k7_geometry(sizes, 1, sms=SMS, smem_limit=LIMIT)
    assert (g["per"], g["warps"], g["grid"]) == (1, 16, 1)


def test_forced_k7_geometry_is_checked():
    sizes = NETS["AC-S1"]
    for f in ((1, 1), (1, 16), (4, 8), (8, 16), (2, 3)):
        g = engine.k7_geometry(sizes, 512, sms=SMS, _force=f)
        assert (g["per"], g["warps"]) == f and g["grid"] == -(-512 // f[0])
        assert g["smem"] == _k7_smem_mirror(sizes, *f)
    for bad in ((0, 8), (4, 0), (4, engine.K7_MAX_WARPS + 1), (64, 16)):  # (64, 16): 486 KB
        with pytest.raises(ValueError, match="shared memory"):
            engine.k7_geometry(sizes, 512, sms=SMS, _force=bad)
    wide = (13, 4096, 1)  # a net whose one warp exceeds shared memory
    with pytest.raises(ValueError, match="shared memory"):
        engine.k7_geometry(wide, 512)


def _sim_smem_mirror(sizes, kind, tw, warps):
    """sim_tile.cuh:sim_smem's bytes: the mbarrier's 4 words, the padded
    net's forward part, a head (4 scalars; 2 slots of key 4, draw
    constants 3d, counts nsum or 1; KD 2 nhid alive words or KA 5 maxw
    IBP words; rounded up to 4) and per warp its tiles (d or the odd
    hidden layers' widest, the even hidden layers' widest, and for KD the
    masked net's even buffer and two logit rows)."""
    r8 = lambda v: (v + 7) // 8 * 8
    d, hidden = sizes[0], list(sizes[1:-1])
    fwd = sum(a * r8(b) + 2 * r8(b) for a, b in zip(sizes[:-1], sizes[1:]))
    counts = {"ka": sum(sizes[1:]), "stats": sum(sizes[1:]), "kd": 1}[kind]
    head = 4 + 2 * (4 + 3 * d + counts) + {"ka": 5 * max(sizes), "stats": 0,
                                           "kd": 2 * sum(hidden)}[kind]
    head = (head + 3) // 4 * 4
    even = max(hidden[0::2], default=0)
    odd = max([d] + hidden[1::2])
    per_warp = tw * (odd + even + (even + 2 if kind == "kd" else 0))
    return 4 * (4 + fwd + head + warps * per_warp)


@pytest.mark.parametrize("kind", pruning.SIM_KINDS)
@pytest.mark.parametrize("name", sorted(NETS))
def test_sim_geometry_fits_every_net(name, kind):
    sizes = NETS[name]
    for rows in (1, 201, 2048, 8192, 16000):
        for S in (1000, 37):
            g = pruning.sim_geometry(sizes, rows, S, sms=SMS, smem_limit=LIMIT, kind=kind)
            assert g["smem"] == pruning.sim_smem(sizes, kind, g["tw"], g["warps"]) \
                == _sim_smem_mirror(sizes, kind, g["tw"], g["warps"]) <= LIMIT
            assert g["tw"] in pruning.SIM_TW and 1 <= g["warps"] <= pruning.SIM_MAX_WARPS
            assert g["T"] == -(-S // g["tw"]) and 1 <= g["tpb"] <= g["T"]
            assert g["grid"] == -(-rows * g["T"] // g["tpb"])
            assert g["per_sm"] >= 1 and g["per_sm"] * (g["smem"] + 1024) <= SM_BYTES
            assert g["per_sm"] * g["warps"] <= pruning.sim_sm_warps(pruning.SIM_REGS)
            if g["tpb"] < g["T"]:  # partitions spread over at most one wave a partition row
                assert g["grid"] <= -(-rows // (g["per_sm"] * SMS)) * g["per_sm"] * SMS


def test_sim_geometry_at_gc1_and_ac_s1():
    for kind in pruning.SIM_KINDS:
        # GC-1's 201 partitions: the grid covers every SM and no wave is
        # left mostly empty.
        g = pruning.sim_geometry(NETS["GC-1"], 201, 1000, sms=SMS, smem_limit=LIMIT, kind=kind)
        assert g["grid"] >= SMS and g["tpb"] < g["T"]
        assert g["grid"] > (-(-g["grid"] // (g["per_sm"] * SMS)) - 1) * g["per_sm"] * SMS \
            + g["per_sm"] * SMS // 2
        # AC-S1: one block a partition on the segment, the chunk and row 3's grid.
        for rows in (2048, 8192, 16000):
            g = pruning.sim_geometry(NETS["AC-S1"], rows, 1000, sms=SMS, smem_limit=LIMIT,
                                     kind=kind)
            assert g["tpb"] == g["T"] and g["grid"] == rows and g["tw"] == 16


def test_sim_geometry_follows_the_register_count():
    # An SM's 65,536 registers, 256 a warp at a time, at most 64 warps.
    assert [pruning.sim_sm_warps(r) for r in (128, 127, 120, 96, 64, 32, 16, 255)] \
        == [16, 16, 17, 21, 32, 64, 64, 8]
    sizes = NETS["GC-1"]
    for regs in (64, 96, 128):
        g = pruning.sim_geometry(sizes, 201, 1000, sms=SMS, regs=regs)
        assert g["regs"] == regs and g["per_sm"] * g["warps"] <= pruning.sim_sm_warps(regs)
        assert g["grid"] >= SMS
    # Fewer registers a thread: more warps resident an SM.
    resident = lambda g: g["per_sm"] * g["warps"]
    assert resident(pruning.sim_geometry(sizes, 201, 1000, sms=SMS, regs=64)) \
        > resident(pruning.sim_geometry(sizes, 201, 1000, sms=SMS, regs=128))


def test_forced_sim_geometry_is_checked():
    sizes = NETS["AC-S1"]
    g = pruning.sim_geometry(sizes, 201, 1000, sms=SMS, _force=(32, 4, 5))
    assert (g["tw"], g["warps"], g["tpb"], g["grid"]) == (32, 4, 5, -(-201 * 32 // 5))
    assert pruning.sim_geometry(sizes, 201, 37, sms=SMS, _force=(16, 2))["tw"] == 16
    for bad in ((32, 8), (16, 15), (6, 1), (64, 1), (16, 0), (16, 17), (16, 4, 64),
                (16, 4, 0)):  # (32, 8): 254 KB; (16, 15): 241 KB; 64 > T = 63 tiles
        with pytest.raises(ValueError):
            pruning.sim_geometry(sizes, 201, 1000, sms=SMS, _force=bad)
    with pytest.raises(ValueError, match="shared memory"):
        pruning.sim_geometry((13, 4096, 1), 201, 1000, kind="kd")
    with pytest.raises(ValueError):
        pruning.sim_geometry(sizes, 201, 0)


def _kc_smem_mirror(sizes, S, V, tw, warps, gw):
    # attack_flips.cu:kc_smem: 36 floats of head (mbarrier, 28 bins, fold),
    # the padded net's forward part, per warp two input tiles of d and the
    # two hidden buffers, per group a strip of 2 S V logits (to 4 floats).
    fwd = sum(a * -(-b // 8) * 8 + 2 * -(-b // 8) * 8 for a, b in zip(sizes[:-1], sizes[1:]))
    hidden = list(sizes[1:-1])
    h0, h1 = max(hidden[0::2], default=0), max(hidden[1::2], default=0)
    return 4 * (36 + fwd + warps * (2 * sizes[0] + h0 + h1) * tw
                + warps // gw * -(-2 * S * V // 4) * 4)


@pytest.mark.parametrize("name", sorted(NETS))
def test_attack_flips_geometry_fits_and_fills_the_card(name):
    sizes = NETS[name]
    for S in (16, 128):
        for V in (2, 5):
            for M in (1, 4):
                for boxes in (1, 17, 201, 512, 2048, 10240):
                    g = engine.attack_flips_geometry(sizes, S, V, boxes, M, sms=SMS,
                                                     smem_limit=LIMIT)
                    assert g["smem"] == engine.attack_flips_smem(
                        sizes, S, V, g["tw"], g["warps"], g["gw"]) == _kc_smem_mirror(
                        sizes, S, V, g["tw"], g["warps"], g["gw"]) <= LIMIT
                    gw = g["gw"]
                    assert gw & (gw - 1) == 0 and 1 <= gw <= min(engine.KC_MAX_GROUP,
                                                                g["tiles"])
                    assert g["warps"] % gw == 0 and 1 <= g["warps"] <= engine.KC_MAX_WARPS
                    assert g["tiles"] == -(-2 * S * V // g["tw"])
                    # Every group of the grid has a box; at most one block an SM.
                    assert (g["grid"] - 1) * g["groups"] < boxes
                    assert g["grid"] <= -(-SMS // M) and g["blocks"] == g["grid"] * M
                    if boxes * M >= SMS * g["groups"]:  # enough boxes: every SM busy
                        assert g["blocks"] >= SMS


def test_attack_flips_geometry_at_the_main_path_shapes():
    ac, gc = NETS["AC-S1"], NETS["GC-1"]
    geo = lambda sizes, S, B, M=1: engine.attack_flips_geometry(sizes, S, 2, B, M, sms=SMS)
    for B, M in ((10240, 1), (10240, 4), (2048, 1), (2048, 4)):
        g = geo(ac, 128, B, M)  # the AC segment and chunk, one model or four
        assert g["blocks"] == SMS and g["warps"] >= 8
        assert g["gw"] <= (2 if M == 1 else 4)
    g = geo(ac, 16, 512)  # the host frontier's F = 512, 4 tiles a box
    assert g["blocks"] >= 128 and g["groups"] * g["blocks"] >= 512
    for live in (1, 17):  # its live rows: a box's 4 tiles on 4 warps
        g = geo(ac, 16, live)
        assert g["gw"] == 4 and g["blocks"] == live
    g = geo(gc, 128, 201)  # GC-1: 201 boxes of 32 tiles over 101 blocks
    assert g["gw"] == 4 and g["blocks"] * g["groups"] >= 201 and g["blocks"] >= 100


def test_forced_kc_geometry_is_checked():
    sizes = NETS["AC-S1"]
    g = engine.attack_flips_geometry(sizes, 128, 2, 2048, sms=SMS, _force=(8, 4, 2))
    assert (g["tw"], g["warps"], g["gw"], g["groups"]) == (8, 4, 2, 2)
    for bad in ((16, 12, 1),  # 12 warps, 12 strips of 512 logits: 245 KB
                (16, 6, 4), (16, 13, 1), (6, 4, 1), (68, 1, 1), (16, 16, 16), (16, 0, 1)):
        with pytest.raises(ValueError):
            engine.attack_flips_geometry(sizes, 128, 2, 2048, sms=SMS, _force=bad)
    with pytest.raises(ValueError, match="shared memory"):
        engine.attack_flips_geometry((13, 4096, 1), 128, 2, 2048)


def test_sim_rows_geometry_and_its_index_limit():
    g = pruning.sim_rows_geometry(13, 1000)  # AC-S1's retry row: one value a thread
    assert (g["rpp"], g["grid_x"], g["per_launch"], g["launches"]) == (19, 53, 19, 1)
    assert g["rpp"] * 13 * g["grid_x"] >= 13 * 1000 > g["rpp"] * 13 * (g["grid_x"] - 1)
    g = pruning.sim_rows_geometry(20, 1000, boxes=16)  # GC: a 16-box chunk, 12 a launch
    assert (g["rpp"], g["grid_x"], g["per_launch"], g["launches"]) == (12, 84, 12, 2)
    assert pruning.sim_rows_geometry(256, 37)["rpp"] == 1
    assert pruning.sim_rows_geometry(13, (2**31 - 1) // 13)["grid_x"] == 65535
    for d, S in ((257, 10), (0, 10), (13, 0), (13, 2**31 // 13 + 1), (1, 2**31)):
        with pytest.raises(ValueError):
            pruning.sim_rows_geometry(d, S)
