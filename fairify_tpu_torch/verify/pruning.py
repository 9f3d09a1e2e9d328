"""Per-partition sound pruning, batched over the partition grid.

Port of ``fairify_tpu/verify/pruning.py:sound_prune_grid``: per
partition, simulation statistics (candidate dead neurons, activation
frequency) and widened IBP bounds, then bound-dead masks (candidacy
required), the keep-one guard and the per-layer bound-looseness sums.  One
device launch per segment on the mega path, one per grid chunk on the
chunk loop — the hand-written kernel KA (``csrc/sim_and_bounds.cu`` on
``csrc/sim_tile.cuh``'s warp tiles, its launch geometry from
:func:`sim_geometry`) on a CUDA device, its plain PyTorch version
:func:`sim_and_bounds_plain` on the CPU; ``keep_sim`` regenerates the
samples with K12's row generator (:func:`sim_rows`, ``csrc/sim_rows.cu``).
:func:`harsh_prune_grid`, the reference's unsound candidate-only pruning,
runs KA's simulation half alone (:func:`sim_stats`).

With ``exact_certify`` the host then re-derives every proposed dead
neuron in exact rational arithmetic (:mod:`fairify_tpu_torch.ops.exact`:
the native exact core over all partitions in one call, else the
``Fraction`` pass per partition), so the masks never rest on f32
round-off.  The masks feed only the CSV's compression and parity columns
and the heuristic retry, never a stage-0 verdict.
"""
from __future__ import annotations

import ctypes
import functools
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from fairify_tpu_torch import obs
from fairify_tpu_torch.obs import launches
from fairify_tpu_torch.ops import exact as exact_ops
from fairify_tpu_torch.ops import exact_native
from fairify_tpu_torch.ops import interval as interval_ops
from fairify_tpu_torch.ops import masks as mask_ops
from fairify_tpu_torch.ops.simulate import PLAIN_ROWS, activation_stats, simulate_boxes
from fairify_tpu_torch.parallel.pipeline import LaunchPipeline, stage
from fairify_tpu_torch.partition.grid import chunk_spans, pad_rows, segment_spans
from fairify_tpu_torch.utils import cuda_build, prng
from fairify_tpu_torch.utils.prng import grid_keys
from fairify_tpu_torch.verify import engine

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


def sim_and_bounds(net, keys, lo, hi, ok, sim_size: int, live=None):
    """KA: simulation statistics + IBP bounds for N partitions, one launch.

    ``live`` (default N): rows ``>= live`` get row ``live - 1``'s outputs
    (``engine.fill_past``), what a full call returns for padded rows that
    repeat that row's inputs; the looseness sums the ``ok`` rows of those
    outputs.  On CPU tensors this is :func:`sim_and_bounds_plain` on every
    row and the same fill; on CUDA tensors it launches
    ``csrc/sim_and_bounds.cu`` over the live rows only (and raises if it
    cannot), the geometry from :func:`sim_geometry`.
    """
    N, L = lo.shape[0], net.depth
    live = engine.live_rows("sim_and_bounds", N, live)
    if lo.device.type == "cpu":
        cand, pos, ws_lb, ws_ub, loos = sim_and_bounds_plain(net, keys, lo, hi, ok, sim_size)
        if live < N:
            fill = lambda ts: [engine.fill_past(t, live) for t in ts]
            cand, pos, ws_lb, ws_ub = fill(cand), fill(pos), fill(ws_lb), fill(ws_ub)
            okf = ok.to(torch.float32)[:, None]
            loos = torch.stack([((ub - lb) * okf).sum() for lb, ub in zip(ws_lb, ws_ub)])
        return cand, pos, ws_lb, ws_ub, loos
    with launches.launching("sim_and_bounds", (lo.shape[0], live, sim_size)):
        out = _sim_launch(net, keys, lo, hi, sim_size, live, "ka")
    sizes = net.layer_sizes
    views = out.split(sizes * 4 + (L,), dim=1)
    loos = (views[-1] * ok[:, None]).sum(0)
    return (list(views[:L]), list(views[L:2 * L]), list(views[2 * L:3 * L]),
            list(views[3 * L:4 * L]), loos)




def sim_stats(net, keys, lo, hi, sim_size: int, live=None):
    """Row 3: simulation statistics alone (the JAX package's ``_sim_stats``)
    for N partitions, one launch — KA with its IBP half skipped, so the
    samples, counts and ``pos_prob`` are KA's bit for bit.  Returns
    per-layer (N, n_l) float32 ``(candidates, pos_prob)``; ``live`` as
    :func:`sim_and_bounds`'s.  CPU tensors take :func:`sim_stats_plain`
    and the fill; CUDA tensors launch ``csrc/sim_and_bounds.cu``'s
    ``ka_sim_stats`` over the live rows."""
    N = lo.shape[0]
    live = engine.live_rows("sim_stats", N, live)
    if lo.device.type == "cpu":
        cand, pos = sim_stats_plain(net, keys, lo, hi, sim_size)
        return ([engine.fill_past(t, live) for t in cand],
                [engine.fill_past(t, live) for t in pos])
    with launches.launching("sim_stats", (lo.shape[0], live, sim_size)):
        out = _sim_launch(net, keys, lo, hi, sim_size, live, "stats")
    views = out.split(net.layer_sizes * 2, dim=1)
    return list(views[:net.depth]), list(views[net.depth:])




# ---------------------------------------------------------------------------
# Launch geometry and launches of KA, row 3 and KD (csrc/sim_tile.cuh)
# ---------------------------------------------------------------------------

SIM_KINDS = ("ka", "stats", "kd")  # KA, row 3 (KA's simulation half), KD
SIM_TW = (32, 16)  # rows of a warp tile, largest first
SIM_MAX_WARPS = 16  # csrc/sim_tile.cuh: 512-thread launch bounds, at most 128 registers a thread
SIM_MIN_WARPS = 8  # the larger tile only where a block of this many warps of it fits
SIM_REGS = 128  # registers a thread when the build is not asked (the launch bounds' most)
SIM_ALIGNED_WAVES = 4  # from this many waves of one-partition blocks on, a block is a partition


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def sim_smem(sizes, kind: str, tw: int, warps: int) -> int:
    """Bytes of dynamic shared memory of one KA, row-3 or KD block
    (``sim_tile.cuh:sim_smem``): the mbarrier's 16; the padded net's
    forward part (``cuda_build.pad_layout``); a head of 4 scalars and, per
    slot (2), the split key (4), the draw constants (3d) and the counts
    (nsum; KD 1), then KD's alive masks (2 nhid) or KA's IBP scratch (5
    maxw), rounded up to 4 words; per warp buffer O (the d inputs and the
    odd hidden layers), buffer E (the even hidden layers) and, for KD, a
    second E and two logit rows, ``tw`` rows each."""
    d, hidden = sizes[0], list(sizes[1:-1])
    e, o = max(hidden[0::2] or [0]), max([d] + hidden[1::2])
    counts = 1 if kind == "kd" else sum(sizes[1:])
    head = 4 + 2 * (4 + 3 * d + counts)
    head += 2 * sum(hidden) if kind == "kd" else 5 * max(sizes) if kind == "ka" else 0
    warp = (o + 2 * e + 2) * tw if kind == "kd" else (o + e) * tw
    return 4 * (4 + cuda_build.pad_layout(sizes)["fwd"] + _ceil(head, 4) * 4 + warps * warp)


def sim_sm_warps(regs: int) -> int:
    """Warps one SM holds at ``regs`` registers a thread: its 65,536
    registers, allocated 256 at a time a warp, and at most 64 warps."""
    return min(64, 65536 // (_ceil(32 * max(regs, 1), 256) * 256))


def _sim_per_sm(smem: int, warps: int, regs: int) -> int:
    """Blocks of ``smem`` bytes and ``warps`` warps of ``regs`` registers a
    thread one SM holds (each block also takes 1,024 bytes)."""
    return min(cuda_build.SMEM_PER_SM // (smem + 1024), sim_sm_warps(regs) // warps)


def sim_geometry(sizes, rows: int, S: int, sms: int = 132,
                 smem_limit: int = cuda_build.SMEM_LIMIT, kind: str = "ka",
                 _force=None, regs: int = SIM_REGS) -> dict:
    """Launch geometry of KA (``kind`` "ka"), row 3 ("stats") or KD ("kd")
    over ``rows`` live partitions of ``S`` samples on a card of ``sms`` SMs.

    ``tw``, rows a warp tile: the largest of SIM_TW at which a block of
    SIM_MIN_WARPS warps fits in shared memory.  ``warps`` a block: the most
    warps an SM then holds resident (its shared memory, and
    :func:`sim_sm_warps` of ``regs``, the kernel's registers a thread as
    built: :func:`sim_regs`), a tie to more blocks an SM (``per_sm``).  ``tpb``, tiles a block, of
    ``T = ceil(S / tw)`` tiles a partition: with at least SIM_ALIGNED_WAVES
    waves of one-partition blocks, ``T`` (one block a partition, counts in
    shared memory); with fewer, the partitions' tiles spread evenly over
    whole waves of the ``per_sm * sms`` blocks the card holds, so that the
    grid fills every SM (``tpb < T``: a partition spans
    ``blocks_per_partition`` blocks or one more, merged through device
    memory).  ``grid = ceil(rows * T / tpb)``.  ``_force`` (``(tw, warps)``
    or ``(tw, warps, tpb)``) overrides the choices; a geometry that does
    not fit raises."""
    if kind not in SIM_KINDS or S < 1 or rows < 0:
        raise ValueError(f"sim_geometry: kind {kind!r}, S={S}, rows={rows}")
    if _force is None:
        tw = next((t for t in SIM_TW if sim_smem(sizes, kind, t, SIM_MIN_WARPS) <= smem_limit),
                  SIM_TW[-1])
        best = None
        for w in range(1, SIM_MAX_WARPS + 1):
            smem = sim_smem(sizes, kind, tw, w)
            if smem > smem_limit:
                break
            n = _sim_per_sm(smem, w, regs)
            if best is None or (n * w, n) > best[0]:
                best = ((n * w, n), w)
        if best is None:
            raise ValueError(f"sim_geometry: one warp's tiles of {tw} rows need "
                             f"{sim_smem(sizes, kind, tw, 1)} bytes of shared memory, "
                             f"more than {smem_limit}")
        warps = best[1]
    else:
        tw, warps = int(_force[0]), int(_force[1])
        if tw < 4 or tw % 4 or tw > SIM_TW[0]:
            raise ValueError(f"sim_geometry: a warp tile of {tw} rows")
        if not 1 <= warps <= SIM_MAX_WARPS or sim_smem(sizes, kind, tw, warps) > smem_limit:
            raise ValueError(f"sim_geometry: {warps} warps of {tw} rows do not fit in shared "
                             "memory")
    T = _ceil(S, tw)
    smem = sim_smem(sizes, kind, tw, warps)
    per_sm = _sim_per_sm(smem, warps, regs)
    slots = per_sm * sms
    if _force is not None and len(_force) > 2:
        tpb = int(_force[2])
        if not 1 <= tpb <= T:
            raise ValueError(f"sim_geometry: {tpb} tiles a block of a partition's {T}")
    elif rows == 0 or rows >= SIM_ALIGNED_WAVES * slots:
        tpb = T
    else:
        tpb = min(T, _ceil(rows * T, _ceil(rows, slots) * slots))
    return dict(tw=tw, warps=warps, threads=32 * warps, tpb=tpb, T=T,
                grid=_ceil(rows * T, tpb), smem=smem, per_sm=per_sm,
                blocks_per_partition=_ceil(T, tpb), regs=regs)


_sim_geometry = functools.lru_cache(maxsize=256)(sim_geometry)

_VP, _INT = ctypes.c_void_p, ctypes.c_int
# ka_sim_and_bounds / ka_sim_stats(params, dims, L, keys, lo, hi, rows, live, S, out,
# ws, tw, warps, tpb, grid, smem, stream)
_KA_ARGS = ((_VP, ctypes.POINTER(_INT), _INT) + (_VP,) * 3 + (_INT,) * 3 + (_VP,) * 2
            + (_INT,) * 4 + (ctypes.c_longlong, _VP))
# kd_parity(params, dims, L, keys, lo, hi, alive, nhid, rows, live, S, out, ws, tw,
# warps, tpb, grid, smem, stream)
_KD_ARGS = ((_VP, ctypes.POINTER(_INT), _INT) + (_VP,) * 4 + (_INT,) * 4 + (_VP,) * 2
            + (_INT,) * 4 + (ctypes.c_longlong, _VP))
_ENTRY = {"ka": ("sim_and_bounds", "ka_sim_and_bounds", _KA_ARGS),
          "stats": ("sim_and_bounds", "ka_sim_stats", _KA_ARGS),
          "kd": ("parity", "kd_parity", _KD_ARGS)}
_REGS = {"ka": ("sim_and_bounds", "ka_regs", 0), "stats": ("sim_and_bounds", "ka_regs", 1),
         "kd": ("parity", "kd_regs", 0)}
_workspaces = {}


@functools.lru_cache(maxsize=None)
def sim_regs(kind: str) -> int:
    """Registers a thread of KA (``kind`` "ka"), row 3 ("stats") or KD
    ("kd") uses as built (``cudaFuncGetAttributes`` through the library's
    ``ka_regs``/``kd_regs``), which :func:`sim_geometry` turns into the
    warps an SM holds."""
    src, name, arg = _REGS[kind]
    regs = cuda_build.entry(src, name, (_INT,))(arg)
    if regs < 1:
        raise RuntimeError(f"sim_regs: {name}({arg}) returned {regs}")
    return regs


def _workspace(dev: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``n`` words on ``dev``, kept per
    device: a launch whose partitions span blocks merges its counts there
    and leaves it zeroed for the next launch on the stream."""
    ws = _workspaces.get(dev)
    if ws is None or ws.numel() < n:
        ws = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _workspaces[dev] = ws
    return ws


def _sim_prepare(net, keys, lo, hi, sim_size: int, live: int, kind: str, alive=None,
                 _geometry_force=None):
    """``(entry point, its arguments but the stream, output tensor)`` of one
    KA (``kind`` "ka"), row-3 ("stats") or KD ("kd") launch over the
    ``live`` first of the rows of ``lo``/``hi``: the padded pack, the
    geometry from :func:`sim_geometry`; the output (rows, 4 nsum + L),
    (rows, 2 nsum) or (rows,)."""
    params, dims, M = cuda_build.pack_padded(net)
    if M != 1:
        raise TypeError("KA and KD take one net, not a stacked family")
    # The kernels read each int64 key's low 32-bit word (the uint32 value).
    k64 = (keys if keys.dtype == torch.int64 else keys.to(torch.int64)).contiguous()
    lo, hi = lo.contiguous(), hi.contiguous()
    ins = (params, k64, lo, hi) + ((alive,) if alive is not None else ())
    cuda_build.require_cuda(*ins)
    dev = lo.device
    sizes = tuple(dims)
    rows, L, nsum = lo.shape[0], len(sizes) - 1, sum(sizes[1:])
    geo = _sim_geometry(sizes, live, sim_size, cuda_build.sm_count(dev),
                        cuda_build.SMEM_LIMIT, kind, _geometry_force, sim_regs(kind))
    width = {"ka": (4 * nsum + L,), "stats": (2 * nsum,), "kd": ()}[kind]
    out = torch.empty((rows,) + width, dtype=torch.float32, device=dev)
    counts = 1 if kind == "kd" else nsum
    ws = (_workspace(dev, live * (counts + 1)).data_ptr() if geo["tpb"] < geo["T"] else None)
    head = (params.data_ptr(), dims, L, k64.data_ptr(), lo.data_ptr(), hi.data_ptr())
    if kind == "kd":
        head += (alive.data_ptr(), alive.shape[1])
    args = head + (rows, live, sim_size, out.data_ptr(), ws, geo["tw"], geo["warps"],
                   geo["tpb"], geo["grid"], geo["smem"])
    src, name, types = _ENTRY[kind]
    return cuda_build.entry(src, name, types), args, out


def _sim_launch(net, keys, lo, hi, sim_size: int, live: int, kind: str, alive=None,
                _geometry_force=None):
    """One launch of KA, row 3 or KD (:func:`_sim_prepare`); its output.
    ``_geometry_force`` forces the geometry: the card's checks that the
    outputs do not depend on it."""
    fn, args, out = _sim_prepare(net, keys, lo, hi, sim_size, live, kind, alive,
                                 _geometry_force)
    cuda_build.check(fn.__name__, fn(*args, torch.cuda.current_stream().cuda_stream))
    return out


K12_THREADS = 256  # csrc/sim_rows.cu: threads of a K12 block
K12_MAX_VALUES = 256  # box values (boxes x d) one K12 launch takes by value
_K12_ARGS = ((ctypes.c_uint32,) * 3 + (_VP,) * 2 + (_INT,) * 4 + (_VP,) * 3)
_k12_buffers = {}


def sim_rows_geometry(d: int, S: int, boxes: int = 1) -> dict:
    """Launch geometry of K12 (``csrc/sim_rows.cu``) for ``boxes``
    partitions of ``S`` samples in ``d`` dimensions: a 256-thread block
    draws ``rpp = 256 // d`` rows a pass (thread t column t % d, so its
    column's draw constants are taken once), ``grid_x = ceil(S / rpp)``
    blocks a partition, one value a thread (53 blocks for AC-S1's 1,000 x
    13), and ``per_launch = K12_MAX_VALUES // d`` boxes a launch by value
    (``launches`` of them).  Raises past the kernel's limits: ``d`` above
    the block, and ``S·d >= 2**31`` (its 32-bit index arithmetic)."""
    if not 1 <= d <= K12_THREADS:
        raise ValueError(f"sim_rows: d = {d}; K12 draws at most {K12_THREADS} dimensions")
    if not 1 <= S or S * d >= 1 << 31:
        raise ValueError(f"sim_rows: S·d = {S * d} values a partition; K12's 32-bit index "
                         "arithmetic takes fewer than 2**31")
    rpp = K12_THREADS // d
    per = K12_MAX_VALUES // d
    return dict(rpp=rpp, grid_x=min(_ceil(S, rpp), 65535), threads=K12_THREADS,
                per_launch=per, launches=_ceil(boxes, per))


def sim_rows(seed: int, index: int, lo, hi, sim_size: int, device="cpu") -> torch.Tensor:
    """K12's row generator: the ``sim_size`` simulation samples (N, S, d)
    f32 of the N partitions of the boxes ``lo``/``hi`` (N, d) (host
    arrays), partition p's key ``grid_keys(seed, index + p)`` — the rows of
    the prune pass and of KD — as a host tensor.  On the CPU
    :func:`utils.prng.simulate_boxes`; on a CUDA ``device`` K12
    (:func:`sim_rows_host`, whose pinned buffer this copies)."""
    lo, hi = (np.asarray(a, np.float32).reshape(-1, np.shape(a)[-1]) for a in (lo, hi))
    if torch.device(device).type == "cpu":
        return simulate_boxes(grid_keys(seed, index, lo.shape[0]), torch.as_tensor(lo),
                              torch.as_tensor(hi), sim_size)
    return sim_rows_host(prng.key_words(seed), index, lo, hi, sim_size, device).clone()


def sim_rows_host(words, index: int, lo: np.ndarray, hi: np.ndarray, sim_size: int,
                  device) -> torch.Tensor:
    """K12 on a CUDA device for the key words ``words``
    (``prng.key_words``): the keys are derived on the card
    (``common.cuh:fold_in``), the boxes (N, d) go as a by-value argument,
    one launch per ``sim_rows_geometry``'s ``per_launch`` boxes (one for a
    retry row), each copying its rows into a persistent pinned host buffer
    on the stream; then one sync.  Returns a (N, S, d) view of that buffer,
    valid until the next call on the device."""
    N, d = lo.shape
    per = _sim_rows_geometry(d, sim_size, N)["per_launch"]
    lo_i = np.ascontiguousarray(lo, dtype=np.int32)
    hi_i = np.ascontiguousarray(hi, dtype=np.int32)
    stream = torch.cuda.current_stream(device)
    host = None
    for p0 in range(0, N, per):
        with launches.launching("sim_rows", (min(per, N - p0), d, sim_size)):
            fn, args, (_rows, host) = _sim_rows_prepare(words, index, lo_i, hi_i, sim_size,
                                                        device, first=p0,
                                                        count=min(per, N - p0))
            cuda_build.check("k12_sim_rows", fn(*args, stream.cuda_stream))
    stream.synchronize()
    return host[:N * sim_size * d].view(N, sim_size, d)


def _sim_rows_prepare(words, index: int, lo_i: np.ndarray, hi_i: np.ndarray, sim_size: int,
                      device, first: int = 0, count: Optional[int] = None, copy: bool = True):
    """``(entry point, its arguments but the stream, (device buffer, pinned
    host buffer))`` of one ``k12_sim_rows`` launch of boxes ``first`` ..
    ``first + count - 1`` of the int32 boxes ``lo_i``/``hi_i`` (N, d) into
    the device's persistent buffers, at their offset; ``copy=False`` leaves
    out the copy to the host."""
    N, d = lo_i.shape
    count = N - first if count is None else count
    geo = _sim_rows_geometry(d, sim_size, count)
    if geo["launches"] != 1:
        raise ValueError(f"sim_rows: {count} boxes of {d} values exceed one launch's "
                         f"{K12_MAX_VALUES}")
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n = N * sim_size * d
    bufs = _k12_buffers.get(dev.index)
    if bufs is None or bufs[0].numel() < n:
        bufs = (torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.float32, pin_memory=True))
        _k12_buffers[dev.index] = bufs
    cuda_build.require_cuda(bufs[0])
    off = 4 * first * sim_size * d
    u32 = lambda v: int(v) & 0xFFFFFFFF
    args = (u32(words[0]), u32(words[1]), u32(index + first), lo_i[first:].ctypes.data,
            hi_i[first:].ctypes.data, count, d, sim_size, geo["grid_x"],
            bufs[0].data_ptr() + off, bufs[1].data_ptr() + off if copy else None)
    return cuda_build.entry("sim_rows", "k12_sim_rows", _K12_ARGS), args, bufs


_sim_rows_geometry = functools.lru_cache(maxsize=64)(sim_rows_geometry)


def prune_block_submit(net, lo, hi, sim_size: int, seed: int, index: int, rows: int):
    """Launch KA over one block of the grid (global index ``index`` of its
    first row), padded to ``rows`` rows and launched over its real ones,
    without a sync: ``(cand, pos, ws_lb, ws_ub, looseness)`` tensors."""
    dev = net.device
    n = lo.shape[0]
    as_dev = lambda a: stage(np.asarray(a, np.float32), dev)
    keys = grid_keys(seed, index, rows, device=dev)
    ok = torch.arange(rows, device=dev) < n
    return sim_and_bounds(net, keys, as_dev(pad_rows(lo, rows)), as_dev(pad_rows(hi, rows)), ok,
                          sim_size, live=n)


def sound_prune_grid(net, lo: np.ndarray, hi: np.ndarray, sim_size: int,
                     seed: int, chunk: int, mega_chunks: int,
                     index_offset: int = 0, keep_sim: bool = False,
                     exact_certify: bool = False, pipeline_depth: int = 2) -> PruneResult:
    """Sound pruning for a (P, d) box grid.

    Each partition's key is ``grid_keys(seed, global index)`` (row index
    plus ``index_offset``, the start of a partition span), so masks do not
    depend on how the grid is cut.  ``mega_chunks > 0`` (and ``keep_sim``
    False, the sweep's call): one KA launch per segment of ``mega_chunks``
    chunks of ``chunk`` rows (``_mega_sim_and_bounds``); only real rows
    are launched, since the JAX package's padding exists to reuse compiled
    executables and never changes a real row's result.  Otherwise the
    chunk loop (``_sim_and_bounds``, row 1): one KA launch per chunk,
    padded to ``chunk`` rows (last row repeated) and launched over its
    real rows (``live``), the per-layer looseness summed in f64 on the
    host over the real rows, as the JAX package does;
    with ``keep_sim`` the samples (P, sim_size, d) are regenerated from the
    same keys by K12's row generator (:func:`sim_rows`: the keys from the
    seed and the global index, derived on the card).  The launches ride a
    micro-pipeline of ``pipeline_depth`` (the host slicing of one block
    overlaps the next block's launch) without a gauge and without fault
    sites: the sweep supervises the whole pass as one unit
    (``site="prune"``), so its launches consume no ``launch.submit`` /
    ``launch.decode`` arrivals.  The device passes run in a
    ``prune.sim_and_bounds`` span, the exact pass in ``prune.exact_certify``.

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
    parts, sims = [], []
    loos = None
    _, spans = chunk_spans(P, chunk)
    if mega_chunks > 0 and not keep_sim:
        _, segs = segment_spans(P, chunk, mega_chunks)
        pad, blocks = 0, [(s, e) for s, e, _chunks in segs]
    else:
        pad, blocks = chunk_spans(P, chunk)
    submit = lambda s, e: (prune_block_submit(net, lo[s:e], hi[s:e], sim_size, seed,
                                              index_offset + s, max(pad, e - s)), (s, e))

    def decode(span, host) -> None:
        nonlocal loos
        s, e = span
        cand, pos, ws_lb, ws_ub, blk_loos = host
        parts.append([[t[:e - s] for t in group] for group in (cand, pos, ws_lb, ws_ub)])
        if pad:
            per = np.asarray([(ub.astype(np.float64) - lb.astype(np.float64)).sum()
                              for lb, ub in zip(parts[-1][2], parts[-1][3])])
        else:
            per = blk_loos.astype(np.float64)
        loos = per if loos is None else loos + per
        if keep_sim:
            sims.append(sim_rows(seed, index_offset + s, lo[s:e], hi[s:e], sim_size,
                                 dev).numpy())

    with obs.span("prune.sim_and_bounds", partitions=P, chunks=len(spans)):
        pipe = LaunchPipeline(depth=pipeline_depth, gauge=False, fault_sites=False)
        for s, e in blocks:
            for _meta, span, host in pipe.submit(lambda s=s, e=e: submit(s, e)):
                decode(span, host)
        for _meta, span, host in pipe.drain():
            decode(span, host)
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
        with obs.span("prune.exact_certify", partitions=P):
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
