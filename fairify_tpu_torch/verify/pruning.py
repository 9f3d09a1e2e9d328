"""Per-partition sound pruning, batched over the partition grid.

Port of the mega path of ``fairify_tpu/verify/pruning.py:sound_prune_grid``
(``keep_sim=False``, ``mega_chunks > 0``): per partition, simulation
statistics (candidate dead neurons, activation frequency) and widened IBP
bounds, then bound-dead masks (candidacy required), the keep-one guard and
the per-layer bound-looseness sums.  One device launch per segment — the
hand-written kernel KA (``csrc/sim_and_bounds.cu``) on a CUDA device, its
plain PyTorch version :func:`sim_and_bounds_plain` on the CPU.

The exact-rational certify pass (``exact_certify=True``) is not ported yet
(ROADMAP queue 1); the derived masks feed only the CSV's compression and
parity columns, never a verdict.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from fairify_tpu_torch.ops import interval as interval_ops
from fairify_tpu_torch.ops import masks as mask_ops
from fairify_tpu_torch.ops.simulate import PLAIN_ROWS, activation_stats, simulate_boxes
from fairify_tpu_torch.partition.grid import segment_spans
from fairify_tpu_torch.utils import cuda_build
from fairify_tpu_torch.utils.prng import grid_keys

EXACT_CERTIFY_NOT_PORTED = (
    "exact_certify=True (the exact-rational mask pass, fairify_tpu/verify/"
    "pruning.py:272-291) is not ported yet: ROADMAP queue 1, 'exact-certify "
    "pass'")


@dataclass
class PruneResult:
    """Per-partition masks and stats (numpy arrays, leading partition axis P)."""

    candidates: List[np.ndarray]  # (P, n_l) 1 = never activated in simulation
    surviving: List[np.ndarray]  # candidates not proven dead
    b_deads: List[np.ndarray]  # bound-proven dead (IBP criterion)
    s_deads: List[np.ndarray]  # exact-pass-proven dead beyond b_deads (zeros)
    st_deads: List[np.ndarray]  # merged sound dead, keep-one guarded
    pos_prob: List[np.ndarray]  # activation frequency per neuron
    ws_lb: List[np.ndarray]
    ws_ub: List[np.ndarray]
    sim: Optional[np.ndarray]  # always None on the mega path
    sv_time_s: float
    looseness: Optional[np.ndarray] = None  # (L,) sum of (ub - lb) per layer


def sim_and_bounds_plain(net, keys, lo, hi, ok, sim_size: int):
    """Plain PyTorch version of KA (same inputs and outputs).

    ``keys`` (N, 2) int64, ``lo``/``hi`` (N, d) float32, ``ok`` (N,) bool
    rows counted in the looseness sums.  Returns ``(candidates, pos_prob,
    ws_lb, ws_ub, looseness)``: four per-layer lists of (N, n_l) float32
    tensors and an (L,) float32 tensor.  Samples are drawn
    ``PLAIN_ROWS`` partitions at a time to bound memory.
    """
    cand_p, pos_p = [], []
    for s in range(0, lo.shape[0], PLAIN_ROWS):
        e = s + PLAIN_ROWS
        sim = simulate_boxes(keys[s:e], lo[s:e], hi[s:e], sim_size)
        stats = activation_stats(net, sim)
        cand_p.append(stats.candidates)
        pos_p.append(stats.positive_prob)
    cat = lambda parts: [torch.cat([p[l] for p in parts]) for l in range(net.depth)]
    bounds = interval_ops.network_bounds(net, lo, hi)
    okf = ok.to(torch.float32)[:, None]
    loos = torch.stack([((ub - lb) * okf).sum()
                        for lb, ub in zip(bounds.ws_lb, bounds.ws_ub)])
    return cat(cand_p), cat(pos_p), list(bounds.ws_lb), list(bounds.ws_ub), loos


def sim_and_bounds(net, keys, lo, hi, ok, sim_size: int):
    """KA: simulation statistics + IBP bounds for N partitions, one launch.

    On CPU tensors this is :func:`sim_and_bounds_plain`; on CUDA tensors it
    launches ``csrc/sim_and_bounds.cu`` (and raises if it cannot).
    """
    if lo.device.type == "cpu":
        return sim_and_bounds_plain(net, keys, lo, hi, ok, sim_size)
    params, dims = cuda_build.pack_net(net)
    k32 = cuda_build.u32_keys(keys)
    lo, hi = lo.contiguous(), hi.contiguous()
    cuda_build.require_cuda(params, k32, lo, hi, ok)
    N, L, nsum = lo.shape[0], net.depth, sum(net.layer_sizes)
    out = [torch.empty((N, nsum), dtype=torch.float32, device=lo.device)
           for _ in range(4)]
    loos_rows = torch.empty((N, L), dtype=torch.float32, device=lo.device)
    cuda_build.call("sim_and_bounds", "ka_sim_and_bounds",
                    cuda_build.ptr(params), dims, ctypes.c_int(L),
                    cuda_build.ptr(k32), cuda_build.ptr(lo), cuda_build.ptr(hi),
                    ctypes.c_int(N), ctypes.c_int(sim_size),
                    *(cuda_build.ptr(t) for t in out),
                    cuda_build.ptr(loos_rows), cuda_build.stream())
    sim_and_bounds.launches += 1
    offs = np.cumsum([0] + list(net.layer_sizes))
    split = lambda t: [t[:, offs[l]:offs[l + 1]] for l in range(L)]
    cand, pos, ws_lb, ws_ub = (split(t) for t in out)
    loos = (loos_rows * ok.to(torch.float32)[:, None]).sum(0)
    return cand, pos, ws_lb, ws_ub, loos


sim_and_bounds.launches = 0


def sound_prune_grid(net, lo: np.ndarray, hi: np.ndarray, sim_size: int,
                     seed: int, chunk: int, mega_chunks: int) -> PruneResult:
    """Sound pruning for a (P, d) box grid, one KA launch per segment.

    The JAX package's mega path without the exact pass
    (``exact_certify=False, keep_sim=False``).  Segments group
    ``mega_chunks`` chunks of ``chunk`` rows, as in the JAX package
    (``partition.grid.segment_spans``); each partition's key is
    ``grid_keys(seed, global index)``, so masks are segment invariant.
    Only real rows are launched: the JAX package's row and chunk-axis
    padding exists to reuse compiled executables and never changes a real
    row's result.
    """
    if mega_chunks <= 0:
        raise NotImplementedError(
            "only the mega path (mega_chunks > 0) of sound_prune_grid is "
            "ported; the chunk loop is ROADMAP queue 2 (K10/K12)")
    dev = net.device
    P = lo.shape[0]
    _, segs = segment_spans(P, chunk, mega_chunks)
    parts = []
    loos = None
    for seg_s, seg_e, _chunks in segs:
        n = seg_e - seg_s
        keys = grid_keys(seed, seg_s, n, device=dev)
        lo_t = torch.as_tensor(np.asarray(lo[seg_s:seg_e], np.float32), device=dev)
        hi_t = torch.as_tensor(np.asarray(hi[seg_s:seg_e], np.float32), device=dev)
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        cand, pos, ws_lb, ws_ub, seg_loos = sim_and_bounds(net, keys, lo_t, hi_t,
                                                           ok, sim_size)
        parts.append([[t.cpu().numpy() for t in group]
                      for group in (cand, pos, ws_lb, ws_ub)])
        per = seg_loos.cpu().numpy().astype(np.float64)
        loos = per if loos is None else loos + per
    L = net.depth
    cat = lambda g: [np.concatenate([p[g][l] for p in parts]) for l in range(L)]
    candidates, pos_prob, ws_lb, ws_ub = cat(0), cat(1), cat(2), cat(3)

    bounds = interval_ops.LayerBounds(ws_lb=tuple(torch.as_tensor(b) for b in ws_lb),
                                      ws_ub=tuple(torch.as_tensor(b) for b in ws_ub),
                                      pl_lb=(), pl_ub=())
    ibp_dead = [d.numpy() for d in interval_ops.dead_from_ws_ub(bounds)]
    # Bound-dead requires simulation candidacy (``utils/prune.py:241-242``).
    b_deads = [c * d for c, d in zip(candidates, ibp_dead)]
    # No exact pass: nothing is proven dead beyond the IBP criterion.
    s_deads = [np.zeros_like(c) for c in candidates]
    certified = b_deads
    merged = [np.maximum(b, s) for b, s in zip(b_deads, s_deads)]
    st_deads = mask_ops.keep_one_alive(merged)
    surviving = [np.maximum(c - m, 0.0) for c, m in zip(candidates, certified)]
    return PruneResult(candidates=candidates, surviving=surviving,
                       b_deads=b_deads, s_deads=s_deads, st_deads=st_deads,
                       pos_prob=pos_prob, ws_lb=ws_lb, ws_ub=ws_ub, sim=None,
                       sv_time_s=0.0, looseness=loos)


def partition_masks(prune: PruneResult, p: int) -> list:
    """Dead masks of one partition (list of (n_l,) arrays)."""
    return [layer[p] for layer in prune.st_deads]
