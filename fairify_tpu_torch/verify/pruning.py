"""Per-partition sound pruning, batched over the partition grid.

Port of ``fairify_tpu/verify/pruning.py:sound_prune_grid``: per
partition, simulation statistics (candidate dead neurons, activation
frequency) and widened IBP bounds, then bound-dead masks (candidacy
required), the keep-one guard and the per-layer bound-looseness sums.  One
device launch per segment on the mega path, one per grid chunk on the
chunk loop — the hand-written kernel KA (``csrc/sim_and_bounds.cu``) on a
CUDA device, its plain PyTorch version :func:`sim_and_bounds_plain` on the
CPU; ``keep_sim`` regenerates the samples with K12's row generator
(:func:`sim_rows`, ``csrc/sim_rows.cu``).  :func:`harsh_prune_grid`, the
reference's unsound candidate-only pruning, runs KA's simulation half
alone (:func:`sim_stats`).

With ``exact_certify`` the host then re-derives every proposed dead
neuron in exact rational arithmetic (:mod:`fairify_tpu_torch.ops.exact`:
the native exact core over all partitions in one call, else the
``Fraction`` pass per partition), so the masks never rest on f32
round-off.  The masks feed only the CSV's compression and parity columns
and the heuristic retry, never a stage-0 verdict.
"""
from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from fairify_tpu_torch.ops import exact as exact_ops
from fairify_tpu_torch.ops import exact_native
from fairify_tpu_torch.ops import interval as interval_ops
from fairify_tpu_torch.ops import masks as mask_ops
from fairify_tpu_torch.ops.simulate import PLAIN_ROWS, activation_stats, simulate_boxes
from fairify_tpu_torch.partition.grid import chunk_spans, pad_rows, segment_spans
from fairify_tpu_torch.utils import cuda_build
from fairify_tpu_torch.utils.prng import grid_keys

@dataclass
class PruneResult:
    """Per-partition masks and stats (numpy arrays, leading partition axis P)."""

    candidates: List[np.ndarray]  # (P, n_l) 1 = never activated in simulation
    surviving: List[np.ndarray]  # candidates not proven dead
    b_deads: List[np.ndarray]  # bound-proven dead (IBP criterion)
    s_deads: List[np.ndarray]  # exact-pass-proven dead beyond b_deads
    st_deads: List[np.ndarray]  # merged sound dead, keep-one guarded
    pos_prob: List[np.ndarray]  # activation frequency per neuron
    ws_lb: List[np.ndarray]
    ws_ub: List[np.ndarray]
    sim: Optional[np.ndarray]  # (P, sim_size, d) with keep_sim, else None
    sv_time_s: float  # seconds of the exact pass (the reference's SV time)
    looseness: Optional[np.ndarray] = None  # (L,) sum of (ub - lb) per layer


def sim_and_bounds_plain(net, keys, lo, hi, ok, sim_size: int):
    """Plain PyTorch version of KA (same inputs and outputs).

    ``keys`` (N, 2) int64, ``lo``/``hi`` (N, d) float32, ``ok`` (N,) bool
    rows counted in the looseness sums.  Returns ``(candidates, pos_prob,
    ws_lb, ws_ub, looseness)``: four per-layer lists of (N, n_l) float32
    tensors and an (L,) float32 tensor.  Samples are drawn
    ``PLAIN_ROWS`` partitions at a time to bound memory.
    """
    cand, pos = sim_stats_plain(net, keys, lo, hi, sim_size)
    bounds = interval_ops.network_bounds(net, lo, hi)
    okf = ok.to(torch.float32)[:, None]
    loos = torch.stack([((ub - lb) * okf).sum()
                        for lb, ub in zip(bounds.ws_lb, bounds.ws_ub)])
    return cand, pos, list(bounds.ws_lb), list(bounds.ws_ub), loos


def sim_stats_plain(net, keys, lo, hi, sim_size: int):
    """Plain PyTorch version of :func:`sim_stats`, the simulation half of
    :func:`sim_and_bounds_plain`: per-layer (N, n_l) ``candidates`` and
    ``pos_prob``, samples drawn ``PLAIN_ROWS`` partitions at a time."""
    cand_p, pos_p = [], []
    for s in range(0, lo.shape[0], PLAIN_ROWS):
        e = s + PLAIN_ROWS
        sim = simulate_boxes(keys[s:e], lo[s:e], hi[s:e], sim_size)
        stats = activation_stats(net, sim)
        cand_p.append(stats.candidates)
        pos_p.append(stats.positive_prob)
    cat = lambda parts: [torch.cat([p[l] for p in parts]) for l in range(net.depth)]
    return cat(cand_p), cat(pos_p)


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


def sim_stats(net, keys, lo, hi, sim_size: int):
    """Row 3: simulation statistics alone (the JAX package's ``_sim_stats``)
    for N partitions, one launch — KA with its IBP half skipped, so the
    samples, counts and ``pos_prob`` are KA's bit for bit.  Returns
    per-layer (N, n_l) float32 ``(candidates, pos_prob)``.  CPU tensors
    take :func:`sim_stats_plain`; CUDA tensors launch
    ``csrc/sim_and_bounds.cu``'s ``ka_sim_stats``."""
    if lo.device.type == "cpu":
        return sim_stats_plain(net, keys, lo, hi, sim_size)
    params, dims = cuda_build.pack_net(net)
    k32 = cuda_build.u32_keys(keys)
    lo, hi = lo.contiguous(), hi.contiguous()
    cuda_build.require_cuda(params, k32, lo, hi)
    N, L, nsum = lo.shape[0], net.depth, sum(net.layer_sizes)
    cand, pos = (torch.empty((N, nsum), dtype=torch.float32, device=lo.device)
                 for _ in range(2))
    cuda_build.call("sim_and_bounds", "ka_sim_stats", cuda_build.ptr(params), dims,
                    ctypes.c_int(L), cuda_build.ptr(k32), cuda_build.ptr(lo),
                    cuda_build.ptr(hi), ctypes.c_int(N), ctypes.c_int(sim_size),
                    cuda_build.ptr(cand), cuda_build.ptr(pos), cuda_build.stream())
    sim_stats.launches += 1
    sizes = list(net.layer_sizes)
    return list(cand.split(sizes, dim=1)), list(pos.split(sizes, dim=1))


sim_stats.launches = 0


def sim_rows(keys, lo, hi, sim_size: int):
    """K12's row generator: the ``sim_size`` simulation samples (N, S, d)
    f32 of N partitions, regenerated from their keys (the rows of the
    prune pass and of KD).  CPU tensors take
    :func:`utils.prng.simulate_boxes`; CUDA tensors launch
    ``csrc/sim_rows.cu``."""
    if lo.device.type == "cpu":
        return simulate_boxes(keys, lo, hi, sim_size)
    k32 = cuda_build.u32_keys(keys)
    lo, hi = lo.contiguous(), hi.contiguous()
    cuda_build.require_cuda(k32, lo, hi)
    N, d = lo.shape
    if N > 65535:
        raise ValueError("sim_rows: at most 65,535 partitions per launch")
    out = torch.empty((N, sim_size, d), dtype=torch.float32, device=lo.device)
    cuda_build.call("sim_rows", "k12_sim_rows", cuda_build.ptr(k32), cuda_build.ptr(lo),
                    cuda_build.ptr(hi), ctypes.c_int(N), ctypes.c_int(d),
                    ctypes.c_int(sim_size), cuda_build.ptr(out), cuda_build.stream())
    sim_rows.launches += 1
    return out


sim_rows.launches = 0


def sound_prune_grid(net, lo: np.ndarray, hi: np.ndarray, sim_size: int,
                     seed: int, chunk: int, mega_chunks: int,
                     index_offset: int = 0, keep_sim: bool = False,
                     exact_certify: bool = False) -> PruneResult:
    """Sound pruning for a (P, d) box grid.

    Each partition's key is ``grid_keys(seed, global index)`` (row index
    plus ``index_offset``, the start of a partition span), so masks do not
    depend on how the grid is cut.  ``mega_chunks > 0`` (and ``keep_sim``
    False, the sweep's call): one KA launch per segment of ``mega_chunks``
    chunks of ``chunk`` rows (``_mega_sim_and_bounds``); only real rows
    are launched, since the JAX package's padding exists to reuse compiled
    executables and never changes a real row's result.  Otherwise the
    chunk loop (``_sim_and_bounds``, row 1): one KA launch per chunk,
    padded to ``chunk`` rows (last row repeated), the per-layer looseness
    summed in f64 on the host over the real rows, as the JAX package does;
    with ``keep_sim`` the samples (P, sim_size, d) are regenerated from the
    same keys by K12's row generator (:func:`sim_rows`).

    ``exact_certify`` (the sweep passes ``exact_certify_masks``; off by
    default here, on in the JAX package's signature) runs the exact pass
    of ``fairify_tpu/verify/pruning.py``: every simulation candidate is
    certified dead iff its exact pre-activation upper bound is <= 0
    (``certify_dead_batch``, or per partition ``certify_dead_masks``);
    ``s_deads`` = certified beyond ``b_deads``, and ``st_deads`` and
    ``surviving`` follow the certified masks; ``sv_time_s`` is its time.
    """
    dev = net.device
    P = lo.shape[0]
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    parts, sims = [], []
    loos = None
    if mega_chunks > 0 and not keep_sim:
        _, segs = segment_spans(P, chunk, mega_chunks)
        pad, blocks = 0, [(s, e) for s, e, _chunks in segs]
    else:
        pad, blocks = chunk_spans(P, chunk)
    for s, e in blocks:
        n, rows = e - s, max(pad, e - s)
        keys = grid_keys(seed, index_offset + s, rows, device=dev)
        lo_t, hi_t = as_dev(pad_rows(lo[s:e], rows)), as_dev(pad_rows(hi[s:e], rows))
        ok = torch.arange(rows, device=dev) < n
        cand, pos, ws_lb, ws_ub, blk_loos = sim_and_bounds(net, keys, lo_t, hi_t, ok,
                                                           sim_size)
        parts.append([[t[:n].cpu().numpy() for t in group]
                      for group in (cand, pos, ws_lb, ws_ub)])
        if pad:
            per = np.asarray([(ub.astype(np.float64) - lb.astype(np.float64)).sum()
                              for lb, ub in zip(parts[-1][2], parts[-1][3])])
        else:
            per = blk_loos.cpu().numpy().astype(np.float64)
        loos = per if loos is None else loos + per
        if keep_sim:
            sims.append(sim_rows(keys[:n], lo_t[:n], hi_t[:n], sim_size).cpu().numpy())
    L = net.depth
    cat = lambda g: [np.concatenate([p[g][l] for p in parts]) for l in range(L)]
    candidates, pos_prob, ws_lb, ws_ub = cat(0), cat(1), cat(2), cat(3)

    bounds = interval_ops.LayerBounds(ws_lb=tuple(torch.as_tensor(b) for b in ws_lb),
                                      ws_ub=tuple(torch.as_tensor(b) for b in ws_ub),
                                      pl_lb=(), pl_ub=())
    ibp_dead = [d.numpy() for d in interval_ops.dead_from_ws_ub(bounds)]
    # Bound-dead requires simulation candidacy (``utils/prune.py:241-242``).
    b_deads = [c * d for c, d in zip(candidates, ibp_dead)]
    t0 = time.perf_counter()
    s_deads = [np.zeros_like(c) for c in candidates]
    certified = b_deads
    if exact_certify:
        certified = exact_masks(net, lo, hi, candidates)
        s_deads = [np.maximum(c - b, 0.0) for c, b in zip(certified, b_deads)]
    sv_time = time.perf_counter() - t0
    merged = [np.maximum(b, s) for b, s in zip(b_deads, s_deads)]
    st_deads = mask_ops.keep_one_alive(merged)
    surviving = [np.maximum(c - m, 0.0) for c, m in zip(candidates, certified)]
    return PruneResult(candidates=candidates, surviving=surviving,
                       b_deads=b_deads, s_deads=s_deads, st_deads=st_deads,
                       pos_prob=pos_prob, ws_lb=ws_lb, ws_ub=ws_ub,
                       sim=np.concatenate(sims) if keep_sim else None,
                       sv_time_s=sv_time, looseness=loos)


def exact_masks(net, lo: np.ndarray, hi: np.ndarray, candidates) -> List[np.ndarray]:
    """Exactly certified dead masks, per layer (P, n_l) float32, of the
    proposed ``candidates`` over the integer boxes ``lo``/``hi`` (P, d):
    one native call over every partition, or the ``Fraction`` pass per
    partition without the library."""
    weights, biases = net.numpy_params()
    batched = exact_native.certify_dead_batch(weights, biases, lo, hi, candidates)
    if batched is not None:
        return batched[:len(candidates)]
    per = [exact_ops.certify_dead_masks(weights, biases, lo[p], hi[p],
                                        [c[p] for c in candidates])
           for p in range(lo.shape[0])]
    return [np.stack([per[p][l] for p in range(lo.shape[0])])
            for l in range(len(candidates))]


def sound_prune_global(net, lo: np.ndarray, hi: np.ndarray, sim_size: int, seed: int,
                       exact_certify: bool = True) -> PruneResult:
    """Whole-domain sound pruning (``sound_prune_global``,
    ``utils/prune.py:646-667``): the grid pass on the single full-range box
    (P = 1), with the JAX package's defaults (the whole grid as one chunk,
    no segments, samples kept)."""
    return sound_prune_grid(net, np.asarray(lo)[None, :], np.asarray(hi)[None, :],
                            sim_size, seed, chunk=0, mega_chunks=0, keep_sim=True,
                            exact_certify=exact_certify)


def harsh_prune_grid(net, lo: np.ndarray, hi: np.ndarray, sim_size: int,
                     seed: int) -> List[np.ndarray]:
    """Unsound candidate-only pruning (the reference's ``harsh_prune``,
    ``utils/prune.py:89-102``; ``fairify_tpu/verify/pruning.py``): the
    simulation candidates of every box, from ``grid_keys(seed, 0, P)``, in
    one :func:`sim_stats` launch over all P boxes, taken as dead directly —
    no bound, no exact pass and (faithful to the reference) no keep-one
    guard.  Returns per-layer (P, n_l) float32 dead masks on the host."""
    dev = net.device
    keys = grid_keys(seed, 0, lo.shape[0], device=dev)
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    cand, _pos = sim_stats(net, keys, as_dev(lo), as_dev(hi), sim_size)
    return [c.cpu().numpy() for c in cand]


def partition_masks(prune: PruneResult, p: int) -> list:
    """Dead masks of one partition (list of (n_l,) arrays)."""
    return [layer[p] for layer in prune.st_deads]
