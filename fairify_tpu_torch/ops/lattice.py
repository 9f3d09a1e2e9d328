"""Phases E0 and E — exhaustive integer-lattice decision for finite boxes.

Port of ``fairify_tpu/ops/lattice.py``.  The reference's Z3 query ranges
over the integer lattice of the partition box, so the pair property is
decidable by finite enumeration; the engine's input-split BaB diverges on
exactly one box class (wide flip-slab boxes whose logit crosses zero
throughout), and for those boxes enumerating the lattice on the card is
cheap.

Evidence classes (the JAX package's numeric policy, unchanged):

* Device pass: a true-f32 forward with a **per-point rigorous round-off
  bound** computed beside it from the same ``|W|`` products (running-error
  analysis, 4x outward on the f32 γ constants): ``|f| > e`` ⇒ certain
  sign.  TF32 would break the bound, so the kernels use plain ``fmaf``
  loops and the plain versions run with TF32 off (``utils/num.py``).
* Margin points (``|f| <= e``) go to the host ladder ``float64 → exact
  rational``.
* Every SAT verdict is re-proved by ``engine.validate_pair`` in exact
  arithmetic.

Three device kernels, one CUDA source (``csrc/lattice_scan.cu``, its
forward in ``csrc/lattice.cuh``), each beside its plain PyTorch version:

* K9a :func:`lattice_scan` (``_lattice_scan_kernel``): signs of a chunk of
  the RA-free lattice → first certain flip, margin count, the first
  ``MARGIN_BUF`` margin indices in index order, their sign columns.
* K9b :func:`lattice_signs` (``_lattice_signs_kernel``): the full (V,
  chunk) sign tensor, the margin-overflow fallback.
* K9c :func:`lattice_scan_ra` (``_lattice_scan_kernel_ra``): K9a with the
  relaxed-attribute axes expanded ±ε and the certain signs dilated over the
  L∞ window per axis, the flip taken at core points only.

On a CUDA tensor a wrapper launches its kernel (a build or launch failure
raises); on a CPU tensor it runs the plain version.  Scope and gates are
the JAX package's: RA-free and k-RA queries whose (2ε+1)^k delta window is
at most 10⁵, coordinates below 2²⁴, scan size gated by
``EngineConfig.lattice_max`` in the engine.

Like the JAX package, the device pass applies ``net.masks`` while the
host ladder (``_host_signs``, ``validate_pair``) runs the unmasked
weights, so on a masked net a device-certain sign can fail exact
validation and the box ends ``unknown`` (``_EvidenceMismatch``).
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from fairify_tpu_torch.obs import launches
from fairify_tpu_torch.utils import cuda_build
from fairify_tpu_torch.verify.property import shared_dims, valid_assignments

# Margin-index buffer per chunk (count > MARGIN_BUF ⇒ the host pulls the
# chunk's full sign tensor through K9b).
MARGIN_BUF = 512

# The round-off recurrence's e₀ = 0 assumes every input coordinate is
# exactly representable in f32: integers with |v| < 2²⁴.
COORD_EXACT_F32 = 1 << 24

# Keep in sync with csrc/lattice.cuh: input dims and RA axes the kernels
# take, and the RA dilation's shared-memory ceiling (past it, a global
# scratch slice per block, on at most LAT_RA_BLOCKS blocks).
LAT_MAXD = 64
LAT_RA_MAXK = 16
LAT_RA_SMEM_MAX = 160 * 1024
LAT_RA_BLOCKS = 264
# csrc/lattice_scan.cu: points per warp tile of the signs kernel (at most
# LAT_TW_MAX, dividing the 64-point tiles of lat_compact) and warps a block.
LAT_TW = 8
LAT_TW_MAX = 64
LAT_MAX_WARPS = 12

# Points per block of the plain forward on the CPU.
CPU_ROWS = 16384


def _ra_strides(ra_ws: tuple) -> list:
    """Mixed-radix strides of the RA tile, aligned with ``ra_ws`` order
    (innermost axis last, stride 1).  Shared by the scan's core-mask
    decode and the host margin-resolution decode: these MUST agree or
    margin cells resolve at the wrong core points."""
    strides = []
    acc = 1
    for w in reversed(ra_ws):
        strides.append(acc)
        acc *= w
    return list(reversed(strides))


def _coords_exceed_f32(enc, lo: np.ndarray, hi: np.ndarray) -> bool:
    """True iff any ε-expanded coordinate magnitude reaches 2²⁴."""
    lo_eff = np.asarray(lo, dtype=np.int64).copy()
    hi_eff = np.asarray(hi, dtype=np.int64).copy()
    if len(enc.ra_idx) and enc.eps:
        ra = np.asarray(enc.ra_idx)
        lo_eff[ra] -= int(enc.eps)
        hi_eff[ra] += int(enc.eps)
    return bool(max(np.abs(lo_eff).max(), np.abs(hi_eff).max())
                >= COORD_EXACT_F32)


def shared_lattice_size(enc, lo: np.ndarray, hi: np.ndarray) -> int:
    """Number of shared-coordinate lattice points of the box (python int:
    stress grids overflow int64)."""
    n = 1
    for d in shared_dims(enc, len(lo)):
        n *= int(hi[d]) - int(lo[d]) + 1
    return n


def enumerable_size(enc, lo: np.ndarray, hi: np.ndarray) -> Optional[int]:
    """Scan size of the box if Phases E0/E can enumerate it, else None.

    RA-free: the shared lattice.  k RA dims with ε > 0: the lattice with
    each RA axis expanded by ±ε; None past the (2ε+1)^k ≤ 10⁵ window cap
    of the margin resolver (``engine.decide_leaf``).  Boxes whose
    ε-expanded coordinates reach 2²⁴ are None too.
    """
    if _coords_exceed_f32(enc, lo, hi):
        return None
    if len(enc.ra_idx) and enc.eps:
        if (2 * int(enc.eps) + 1) ** len(enc.ra_idx) > 100_000:
            return None
        ra_set = {int(j) for j in enc.ra_idx}
        n = 1
        for d in shared_dims(enc, len(lo)):
            w = int(hi[d]) - int(lo[d]) + 1
            if d in ra_set:
                w += 2 * int(enc.eps)
            n *= w
        return n
    return shared_lattice_size(enc, lo, hi)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's yardstick in chip_smoke.py)
# ---------------------------------------------------------------------------


def signed_forward(net, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """True-f32 forward with a running rigorous round-off bound:

        e_{l+1} = e_l·|W| + γ_l·(|h_l|·|W| + |b|),   γ_l = 4(n_in+4)·2⁻²⁴

    ReLU is 1-Lipschitz, so ``e`` passes through masked like the
    activation; integer inputs below 2²⁴ are exact in f32, so e₀ = 0.
    Three products per layer, TF32 off.  Returns ``(f, e)`` with the
    logit axis dropped.
    """
    h = x
    e = torch.zeros_like(x)
    n_layers = net.depth
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        gamma = 4.0 * (w.shape[0] + 4) * 2.0 ** -24
        aw = w.abs()
        abs_acc = h.abs() @ aw + b.abs()
        e = e @ aw + gamma * abs_acc
        z = h @ w + b
        if i < n_layers - 1:
            h = torch.relu(z) * m
            e = e * m
        else:
            h = z
    return h.squeeze(-1), e.squeeze(-1)


def lattice_inputs(start: int, strides, widths, lo_shared, bases: torch.Tensor,
                   chunk: int, dims_tuple: tuple, d: int) -> torch.Tensor:
    """(V, chunk, d) f32 inputs of flat indices ``start .. start+chunk``:
    mixed-radix decode over the shared dims in int32 (indices past the
    lattice wrap modulo the widths: in-box duplicates), PA and peeled
    columns from ``bases`` (V, d)."""
    dev = bases.device
    as_i = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    idx = int(start) + torch.arange(chunk, dtype=torch.int32, device=dev)
    coords = (torch.div(idx[:, None], as_i(strides)[None, :], rounding_mode="floor")
              % as_i(widths)[None, :]) + as_i(lo_shared)[None, :]
    x = bases[:, None, :].expand(bases.shape[0], chunk, d).clone()
    for j, k in enumerate(dims_tuple):
        x[:, :, k] = coords[:, j].to(torch.float32)
    return x


def device_signs_plain(net, start, strides, widths, lo_shared, bases, chunk: int,
                       dims_tuple: tuple, d: int, with_fe: bool = False):
    """(V, chunk) int8 signs (0 = inside the round-off bound); with
    ``with_fe`` also the f32 logits and bounds.  On the CPU the forward
    runs in blocks of CPU_ROWS points, which keeps its intermediates in
    cache (each row's products are the same either way)."""
    x = lattice_inputs(start, strides, widths, lo_shared, bases, chunk, dims_tuple, d)
    if x.is_cuda:
        f, e = signed_forward(net, x)
    else:
        flat = x.reshape(-1, d)
        parts = [signed_forward(net, flat[s:s + CPU_ROWS])
                 for s in range(0, flat.shape[0], CPU_ROWS)]
        f = torch.cat([p[0] for p in parts]).reshape(x.shape[:-1])
        e = torch.cat([p[1] for p in parts]).reshape(x.shape[:-1])
    s = torch.where(f > e, 1, torch.where(f < -e, -1, 0)).to(torch.int8)
    return (s, f, e) if with_fe else s


def _in_range(start, n_total, chunk, dev):
    return (int(start) + torch.arange(chunk, dtype=torch.int32, device=dev)) < int(n_total)


def _reductions(s, flip, is_margin, chunk):
    """JAX's outputs from a flip and a margin mask: ``first_flip`` (−1 if
    none), ``margin_count``, the first MARGIN_BUF margin indices in index
    order (−1-filled) and the sign columns at ``clip(margin_idx)`` and
    ``clip(first_flip)`` (an unfilled or absent index reads column 0)."""
    dev = s.device
    hit = torch.nonzero(flip).flatten()
    first_flip = (hit[0] if hit.numel() else torch.tensor(-1, device=dev)).to(torch.int32)
    margin_count = is_margin.sum().to(torch.int32)
    nz = torch.nonzero(is_margin).flatten()[:MARGIN_BUF].to(torch.int32)
    margin_idx = torch.full((MARGIN_BUF,), -1, dtype=torch.int32, device=dev)
    margin_idx[:nz.numel()] = nz
    take = torch.cat([margin_idx.clamp(0, chunk - 1),
                      first_flip.clamp(0, chunk - 1).reshape(1)]).long()
    return first_flip, margin_count, margin_idx, s[:, take]


def lattice_scan_plain(net, start, n_total, strides, widths, lo_shared, bases,
                       valid_mask, valid_pair_f, chunk: int, dims_tuple: tuple, d: int):
    """K9a's plain version: ``(first_flip, margin_count, margin_idx,
    sign_cols)`` of one RA-free chunk."""
    s = device_signs_plain(net, start, strides, widths, lo_shared, bases, chunk,
                           dims_tuple, d)
    return scan_from_signs(s, start, n_total, valid_mask, valid_pair_f)


def scan_from_signs(s, start, n_total, valid_mask, valid_pair_f):
    """K9a's reductions of a (V, chunk) sign tensor ``s``."""
    chunk = s.shape[1]
    in_range = _in_range(start, n_total, chunk, s.device)
    vm = valid_mask[:, None]
    posf = ((s == 1) & vm).to(torch.float32)
    negf = ((s == -1) & vm).to(torch.float32)
    # partner[a, j] > 0 ⇔ some b with valid_pair[a, b] is certainly
    # negative at point j: the exact ordered-pair semantics.
    partner = valid_pair_f @ negf
    flip = ((posf > 0) & (partner > 0)).any(dim=0) & in_range
    is_margin = ((s == 0) & vm).any(dim=0) & in_range
    return _reductions(s, flip, is_margin, chunk)


def lattice_scan_ra_plain(net, start, n_total, strides, widths, lo_shared, bases,
                          valid_mask, valid_pair_f, chunk: int, dims_tuple: tuple,
                          d: int, ra_ws: tuple, eps: int):
    """K9c's plain version: the RA axes are the innermost suffix dims, each
    expanded by ±ε; certain signs are dilated over the ±ε window per axis
    (separable L∞ window) and a CORE point flips when it is certainly
    positive (negative) for a and some window partner certainly negative
    (positive) for b, valid_pair[a, b].  ``start`` and ``chunk`` are
    multiples of the RA tile ``prod(ra_ws)``."""
    s = device_signs_plain(net, start, strides, widths, lo_shared, bases, chunk,
                           dims_tuple, d)
    return scan_ra_from_signs(s, start, n_total, valid_mask, valid_pair_f, ra_ws, eps)


def scan_ra_from_signs(s, start, n_total, valid_mask, valid_pair_f, ra_ws: tuple,
                       eps: int):
    """K9c's reductions of a (V, chunk) sign tensor ``s``."""
    dev = s.device
    V, chunk = s.shape
    in_range = _in_range(start, n_total, chunk, dev)
    tile = int(np.prod(ra_ws)) if len(ra_ws) else 1
    rem = torch.arange(chunk, dtype=torch.int32, device=dev) % tile
    core = in_range
    for w, st in zip(ra_ws, _ra_strides(ra_ws)):
        col = (rem // st) % w
        core = core & (col >= eps) & (col < w - eps)
    vm = valid_mask[:, None]
    rows = chunk // tile

    def dilate(mask):
        # Wrapped duplicates (≥ n_total) are masked before this call: a
        # wrapped cell belongs to another row and donates no partner.
        m = mask.reshape((V, rows) + tuple(ra_ws))
        for ax, w in enumerate(ra_ws):
            axis = 2 + ax
            out = torch.zeros_like(m)
            shape = [1] * m.dim()
            shape[axis] = w
            cidx = torch.arange(w, device=dev).reshape(shape)
            for dlt in range(-eps, eps + 1):
                ok = (cidx + dlt >= 0) & (cidx + dlt < w)
                out = out | (torch.roll(m, -dlt, dims=axis) & ok)
            m = out
        return m.reshape(V, chunk).to(torch.float32)

    live = vm & in_range[None, :]
    dil_neg = dilate((s == -1) & live)
    dil_pos = dilate((s == 1) & live)
    posc = (s == 1) & vm & core[None, :]
    negc = (s == -1) & vm & core[None, :]
    # Either direction: the core point may be the positive endpoint with a
    # negative window partner, or the negative one with a positive partner
    # (which may live only in the ε-expanded ring).
    flip = (posc & ((valid_pair_f @ dil_neg) > 0)).any(dim=0) \
        | (negc & ((valid_pair_f @ dil_pos) > 0)).any(dim=0)
    is_margin = ((s == 0) & vm).any(dim=0) & in_range
    return _reductions(s, flip, is_margin, chunk)


# ---------------------------------------------------------------------------
# The kernels' wrappers (CUDA C++: csrc/lattice_scan.cu)
# ---------------------------------------------------------------------------

_MODE_SIGNS, _MODE_SCAN, _MODE_RA = 0, 1, 2


def lattice_smem(sizes, tw: int, warps: int, V: int) -> int:
    """Bytes of dynamic shared memory of one signs-kernel block
    (``lattice_scan.cu:lat_smem``): the mbarrier's 16, the padded net's
    forward part, and per warp the input tile (d units), two activation and
    two bound tiles (hidden layer l's in buffer l % 2), f and e, and V x TW
    sign bytes rounded up to 16, all of TW points."""
    h = [0, 0]
    for l in range(len(sizes) - 2):
        h[l & 1] = max(h[l & 1], sizes[l + 1])
    per = (sizes[0] + 2 * (h[0] + h[1]) + 2) * tw + (V * tw // 4 + 3) // 4 * 4
    return 4 * (4 + cuda_build.pad_layout(sizes)["fwd"] + warps * per)


def lattice_geometry(sizes, V: int, points: int, sms: int = 132,
                     smem_limit: int = cuda_build.SMEM_LIMIT, _force=None) -> dict:
    """Launch geometry of the lattice signs kernel (K9a/b/c's forward) for
    a chunk of ``points`` lattice points with V assignments on a card of
    ``sms`` SMs: warp tiles of ``tw`` points, warps per block enough to give
    each SM its share (at most LAT_MAX_WARPS and what shared memory holds),
    and a persistent grid of at most one block per SM.  ``_force`` (``(tw,
    warps)``) overrides the two choices; a geometry that does not fit
    raises."""
    tw = LAT_TW if _force is None else int(_force[0])
    if not (4 <= tw <= LAT_TW_MAX and 64 % tw == 0):
        raise ValueError(f"lattice: a warp tile of {tw} points is not one the kernel takes")
    fit = lambda w: lattice_smem(sizes, tw, w, V) <= smem_limit
    wmax = max((w for w in range(1, LAT_MAX_WARPS + 1) if fit(w)), default=0)
    if wmax == 0:
        raise ValueError(f"lattice: one warp's tiles need {lattice_smem(sizes, tw, 1, V)} "
                         f"bytes of shared memory, more than {smem_limit}")
    tiles = -(-int(points) // tw)
    if _force is None:
        warps = min(max(-(-tiles // sms), 1), wmax)
    else:
        warps = int(_force[1])
        if not 1 <= warps <= wmax:
            raise ValueError(f"lattice: {warps} warps of {tw} points do not fit")
    return dict(tw=tw, warps=warps, threads=32 * warps,
                grid=max(1, min(-(-tiles // warps), sms)),
                smem=lattice_smem(sizes, tw, warps, V), tiles=tiles)


_lattice_geometry = functools.lru_cache(maxsize=256)(lattice_geometry)


def _host_desc(start, n_total, chunk, d, strides, widths, lo_shared, dims_tuple, V):
    """The chunk's decode descriptor as a host int array: ``[start,
    n_total, chunk, d, n_shared, V, strides, widths, lo_shared, col]``
    with ``col[k]`` the shared-coordinate position of input dim k or −1
    (a ``bases`` column)."""
    if d > LAT_MAXD:
        raise ValueError(f"input dimension {d} exceeds the lattice kernels' "
                         f"LAT_MAXD={LAT_MAXD}")
    col = [-1] * d
    for j, k in enumerate(dims_tuple):
        col[int(k)] = j
    vals = [int(start), int(n_total), int(chunk), int(d), len(dims_tuple), int(V)]
    vals += [int(v) for v in strides] + [int(v) for v in widths]
    vals += [int(v) for v in lo_shared] + col
    return (ctypes.c_int * len(vals))(*vals)


def _launch(mode, net, start, n_total, strides, widths, lo_shared, bases, valid_mask,
            valid_pair_f, chunk, dims_tuple, d, ra_ws=(), eps=0, with_fe=False,
            _geometry_force=None):
    """One ``k9_lattice`` call on CUDA tensors; ``_geometry_force`` (``(tw,
    warps)``) forces the signs kernel's geometry: the card's checks that
    signs, f and e do not depend on it."""
    if bases.dtype != torch.float32 or valid_pair_f.dtype != torch.float32 \
            or valid_mask.dtype != torch.bool:
        raise ValueError("bases and valid_pair_f must be float32, valid_mask bool")
    cuda_build.require_cuda(bases, valid_mask, valid_pair_f)
    dev = bases.device
    V = int(bases.shape[0])
    if tuple(bases.shape) != (V, d) or tuple(valid_pair_f.shape) != (V, V) \
            or tuple(valid_mask.shape) != (V,):
        raise ValueError("bases (V, d), valid_mask (V,) and valid_pair_f (V, V) expected")
    if net.layer_sizes[-1] != 1:
        raise ValueError("lattice: the net must have one output logit")
    params, dims, _ = cuda_build.pack_padded(net)
    cuda_build.require_cuda(params)
    desc = _host_desc(start, n_total, chunk, d, strides, widths, lo_shared, dims_tuple, V)
    geo = _lattice_geometry(tuple(dims), V, int(chunk), cuda_build.sm_count(dev),
                            cuda_build.SMEM_LIMIT, _geometry_force)
    tile = int(np.prod(ra_ws)) if len(ra_ws) else 1
    if len(ra_ws) > LAT_RA_MAXK:
        raise ValueError(f"{len(ra_ws)} RA axes exceed LAT_RA_MAXK={LAT_RA_MAXK}")
    if mode == _MODE_RA and chunk % tile:
        raise ValueError("an RA chunk must hold whole RA tiles")
    ra = [len(ra_ws), int(eps), tile] + [int(w) for w in ra_ws] \
        + [int(st) for st in _ra_strides(tuple(ra_ws))]
    ra_desc = (ctypes.c_int * len(ra))(*ra)
    signs = torch.empty((V, chunk), dtype=torch.int8, device=dev)
    fe = torch.empty((2, V, chunk), dtype=torch.float32, device=dev) if with_fe else None
    small = torch.empty(2 + MARGIN_BUF, dtype=torch.int32, device=dev)
    sign_cols = torch.empty((V, MARGIN_BUF + 1), dtype=torch.int8, device=dev)
    pflag = torch.empty(chunk if mode else 0, dtype=torch.uint8, device=dev)
    blk = torch.empty(chunk // 64 + 1 if mode else 0, dtype=torch.int32, device=dev)
    ra_bytes = 4 * V * tile
    scratch = torch.empty(min(chunk // tile, LAT_RA_BLOCKS) * ra_bytes
                          if mode == _MODE_RA and ra_bytes > LAT_RA_SMEM_MAX else 0,
                          dtype=torch.uint8, device=dev)
    null = ctypes.c_void_p(0)
    opt = lambda t: cuda_build.ptr(t) if t is not None and t.numel() else null
    cuda_build.call("lattice_scan", "k9_lattice", ctypes.c_int(mode),
                    cuda_build.ptr(params), dims, ctypes.c_int(net.depth), desc, ra_desc,
                    cuda_build.ptr(bases), cuda_build.ptr(valid_mask),
                    cuda_build.ptr(valid_pair_f), cuda_build.ptr(signs),
                    opt(fe[0] if fe is not None else None),
                    opt(fe[1] if fe is not None else None),
                    cuda_build.ptr(small), cuda_build.ptr(sign_cols), opt(pflag),
                    opt(blk), opt(scratch), ctypes.c_int(scratch.numel() // max(ra_bytes, 1)),
                    ctypes.c_int(geo["tw"]), ctypes.c_int(geo["warps"]),
                    ctypes.c_int(geo["grid"]), ctypes.c_longlong(geo["smem"]),
                    cuda_build.stream())
    if mode == _MODE_SIGNS:
        return (signs, fe[0], fe[1]) if with_fe else signs
    return small[0], small[1], small[2:], sign_cols


def lattice_scan(net, start, n_total, strides, widths, lo_shared, bases, valid_mask,
                 valid_pair_f, chunk: int, dims_tuple: tuple, d: int):
    """K9a: one RA-free chunk → ``(first_flip, margin_count, margin_idx,
    sign_cols)`` (replaces ``ops/lattice.py:_lattice_scan_kernel``).
    ``strides``/``widths``/``lo_shared`` are host int arrays; ``bases``
    (V, d) f32, ``valid_mask`` (V,) bool and ``valid_pair_f`` (V, V) f32
    lie on the device that runs it; the kernel reads the net's padded pack
    (``cuda_build.pack_padded``, built once per net)."""
    if bases.device.type == "cpu":
        return lattice_scan_plain(net, start, n_total, strides, widths, lo_shared, bases,
                                  valid_mask, valid_pair_f, chunk, dims_tuple, d)
    with launches.launching("lattice_scan", (int(n_total), int(chunk))):
        out = _launch(_MODE_SCAN, net, start, n_total, strides, widths, lo_shared, bases,
                      valid_mask, valid_pair_f, chunk, dims_tuple, d)
    return out




def lattice_signs(net, start, strides, widths, lo_shared, bases, chunk: int,
                  dims_tuple: tuple, d: int, with_fe: bool = False):
    """K9b: the full (V, chunk) int8 sign tensor of one chunk, the
    margin-overflow fallback (replaces ``_lattice_signs_kernel``); with
    ``with_fe`` also each point's f32 logit and bound."""
    if bases.device.type == "cpu":
        return device_signs_plain(net, start, strides, widths, lo_shared, bases, chunk,
                                  dims_tuple, d, with_fe=with_fe)
    V = int(bases.shape[0])
    ones = torch.ones(V, dtype=torch.bool, device=bases.device)
    with launches.launching("lattice_signs", (int(chunk), bool(with_fe))):
        out = _launch(_MODE_SIGNS, net, start, 0, strides, widths, lo_shared, bases, ones,
                      torch.zeros((V, V), dtype=torch.float32, device=bases.device), chunk,
                      dims_tuple, d, with_fe=with_fe)
    return out




def lattice_scan_ra(net, start, n_total, strides, widths, lo_shared, bases, valid_mask,
                    valid_pair_f, chunk: int, dims_tuple: tuple, d: int, ra_ws: tuple,
                    eps: int):
    """K9c: one chunk of the ε-expanded RA lattice (whole RA tiles) →
    ``(first_flip, margin_count, margin_idx, sign_cols)``, the flip at a
    core point (replaces ``_lattice_scan_kernel_ra``)."""
    if bases.device.type == "cpu":
        return lattice_scan_ra_plain(net, start, n_total, strides, widths, lo_shared,
                                     bases, valid_mask, valid_pair_f, chunk, dims_tuple,
                                     d, ra_ws, eps)
    with launches.launching("lattice_scan_ra", (int(n_total), int(chunk))):
        out = _launch(_MODE_RA, net, start, n_total, strides, widths, lo_shared, bases,
                      valid_mask, valid_pair_f, chunk, dims_tuple, d, ra_ws=ra_ws, eps=eps)
    return out




# ---------------------------------------------------------------------------
# The host side: exact ladder and the box decision
# ---------------------------------------------------------------------------


def _host_signs(weights, biases, pts: np.ndarray) -> np.ndarray:
    """Signs of margin points: vectorised f64 forward, exact rational for
    the |f64| ≤ 1e-6 residue."""
    from fairify_tpu_torch.models.mlp import forward_np
    from fairify_tpu_torch.verify.engine import exact_logit_sign

    if pts.shape[0] == 0:
        return np.zeros(0, dtype=np.int8)
    v = np.atleast_1d(forward_np(weights, biases, pts.astype(np.float64)))
    out = np.sign(v).astype(np.int8)
    near = np.abs(v) <= 1e-6
    for k in np.where(near)[0]:
        out[k] = exact_logit_sign(weights, biases, pts[k])
    return out


def _pair_flip(signs: np.ndarray, valid: list, valid_pair: np.ndarray):
    """First (a, b) valid ordered pair with signs (+1, −1), else None.
    ``signs`` is a (V,) column over ALL assignments."""
    for a in valid:
        if signs[a] != 1:
            continue
        for b in valid:
            if valid_pair[a, b] and signs[b] == -1:
                return a, b
    return None


class _EvidenceMismatch(Exception):
    """A device 'certain' sign contradicted exact arithmetic."""


class _DeadlineHit(Exception):
    """Per-point host resolution ran past the deadline."""


def _to_host(out, dev: torch.device):
    """Queue the chunk's small outputs into pinned host buffers behind one
    CUDA event (``non_blocking``); on the CPU they are already there."""
    if dev.type != "cuda":
        return out, None
    host = []
    for t in out:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        host.append(buf)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


@dataclass
class ScanPlan:
    """The device layout of one box's lattice scan: the (ε-expanded)
    shared dims in scan order (RA axes innermost), the prefix dims peeled
    to the host, the suffix decode, the chunk size and the in-box pair
    matrix."""

    ra_mode: bool
    eps: int
    ra_ws: tuple
    tile: int
    lo: np.ndarray
    lo_eff: np.ndarray
    peel_dims: np.ndarray
    suf_dims: np.ndarray
    suf_widths: np.ndarray
    suf_strides: np.ndarray
    n_suf: int
    chunk: int
    valid: list
    vp: np.ndarray

    @property
    def dims_tuple(self) -> tuple:
        return tuple(int(x) for x in self.suf_dims)

    def host_desc(self):
        """``(strides, widths, lo_shared)`` int32 host arrays of the suffix."""
        return (self.suf_strides.astype(np.int32), self.suf_widths.astype(np.int32),
                self.lo_eff[self.suf_dims].astype(np.int32))

    def bases(self, enc, prefix_vals) -> np.ndarray:
        """(V, d) f32: the box's lower corner, the peeled prefix values and
        every assignment's PA values."""
        base = np.tile(self.lo.astype(np.float32), (enc.n_assign, 1))
        if len(self.peel_dims):
            base[:, self.peel_dims] = np.asarray(prefix_vals, np.float32)
        base[:, np.asarray(enc.pa_idx)] = enc.assignments.astype(np.float32)
        return base

    def scan(self, net, c0: int, bases_dev, valid_dev, vp_dev):
        """K9a (RA-free) or K9c (RA) on the chunk starting at ``c0``."""
        strides, widths, lo_sh = self.host_desc()
        d = int(bases_dev.shape[1])
        if self.ra_mode:
            return lattice_scan_ra(net, c0, self.n_suf, strides, widths, lo_sh, bases_dev,
                                   valid_dev, vp_dev, self.chunk, self.dims_tuple, d,
                                   self.ra_ws, self.eps)
        return lattice_scan(net, c0, self.n_suf, strides, widths, lo_sh, bases_dev,
                            valid_dev, vp_dev, self.chunk, self.dims_tuple, d)

    def signs(self, net, c0: int, bases_dev, with_fe: bool = False):
        """K9b on the chunk starting at ``c0``."""
        strides, widths, lo_sh = self.host_desc()
        return lattice_signs(net, c0, strides, widths, lo_sh, bases_dev, self.chunk,
                             self.dims_tuple, int(bases_dev.shape[1]), with_fe=with_fe)


def scan_plan(net, enc, lo: np.ndarray, hi: np.ndarray, chunk: int = 1 << 21,
              int32_limit: int = 2 ** 31 - (1 << 23)):
    """The :class:`ScanPlan` of a box, or the verdict string when the box
    needs no scan (``'unsat'``: no legal pair in the box) or cannot be
    scanned (``'unknown'``: coordinates at 2²⁴, a delta window past 10⁵,
    an RA axis alone past the int32 decode, or one RA tile past the
    device memory cap)."""
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    d = int(lo.shape[0])
    if _coords_exceed_f32(enc, lo, hi):
        # e₀ = 0 in the round-off recurrence needs exact-f32 integer
        # coordinates; a wider dim would scan rounded points.
        return "unknown"
    ra_mode = bool(len(enc.ra_idx)) and int(enc.eps) > 0
    if ra_mode and (2 * int(enc.eps) + 1) ** len(enc.ra_idx) > 100_000:
        return "unknown"
    ra_dims = [int(j) for j in enc.ra_idx] if ra_mode else []
    eps = int(enc.eps) if ra_mode else 0
    lo_eff = lo.copy()
    hi_eff = hi.copy()
    for rd in ra_dims:
        lo_eff[rd] -= eps
        hi_eff[rd] += eps

    dims = shared_dims(enc, d)
    if ra_mode:
        # RA axes innermost (the last one stride 1): partner windows live
        # inside one contiguous tile and never cross a chunk boundary.
        dims = np.array([x for x in dims if x not in ra_dims] + ra_dims)
    N = 1
    for dm in dims:
        N *= int(hi_eff[dm]) - int(lo_eff[dm]) + 1
    ra_ws = tuple(int(hi_eff[rd] - lo_eff[rd] + 1) for rd in ra_dims)
    tile = 1
    for w in ra_ws:
        tile *= w

    V = enc.n_assign
    valid = valid_assignments(enc, lo, hi)
    if not any(enc.valid_pair[a, b] for a in valid for b in valid):
        return "unsat"  # no legal pair in the box: trivially fair

    # Prefix peeling: smallest shared widths first until the suffix
    # lattice fits the int32 decode; the RA axes are never peeled.
    n_suf = N
    by_width = sorted(
        (j for j in range(len(dims)) if int(dims[j]) not in ra_dims),
        key=lambda j: int(hi_eff[dims[j]]) - int(lo_eff[dims[j]]) + 1)
    peeled = []
    for j in by_width:
        if n_suf < int32_limit - chunk:
            break
        n_suf //= int(hi_eff[dims[j]]) - int(lo_eff[dims[j]]) + 1
        peeled.append(j)
    if n_suf >= int32_limit - chunk:
        return "unknown"
    peel_dims = dims[sorted(peeled)]
    suf_dims = dims[sorted(set(range(len(dims))) - set(peeled))]
    suf_widths = (hi_eff[suf_dims] - lo_eff[suf_dims] + 1).astype(np.int64)
    suf_strides = np.ones(len(suf_dims), dtype=np.int64)
    for k in range(len(suf_dims) - 2, -1, -1):
        suf_strides[k] = suf_strides[k + 1] * suf_widths[k + 1]

    # Device memory cap: V × chunk × widest-layer activations in f32.
    widest = max([d] + list(net.layer_sizes))
    max_chunk = max(1 << 12, int((1 << 28) // max(V * widest, 1)))
    chunk = int(min(chunk, max_chunk))
    if ra_mode:
        if tile > max_chunk:
            return "unknown"  # one RA tile exceeds device memory
        chunk = max(tile, chunk - chunk % tile)
        if n_suf >= int32_limit - chunk:
            return "unknown"

    valid_np = np.zeros(V, dtype=bool)
    valid_np[valid] = True
    vp = enc.valid_pair & valid_np[:, None] & valid_np[None, :]
    return ScanPlan(ra_mode=ra_mode, eps=eps, ra_ws=ra_ws, tile=tile, lo=lo, lo_eff=lo_eff,
                    peel_dims=peel_dims, suf_dims=suf_dims, suf_widths=suf_widths,
                    suf_strides=suf_strides, n_suf=n_suf, chunk=chunk, valid=valid, vp=vp)


def decide_box_exhaustive(
    net,
    enc,
    lo: np.ndarray,
    hi: np.ndarray,
    chunk: int = 1 << 21,
    deadline_s: Optional[float] = None,
    pipeline_depth: int = 32,
    int32_limit: int = 2 ** 31 - (1 << 23),
) -> Tuple[str, Optional[Tuple[np.ndarray, np.ndarray]]]:
    """Complete decision of one box by lattice enumeration.

    Returns ``('sat', (x, xp))`` with an exact-validated pair, ``('unsat',
    None)`` when no exact strict flip exists anywhere on the lattice, or
    ``('unknown', None)`` on deadline or on an evidence-ladder
    disagreement (a device "certain" sign failing exact validation).

    k RA dims: each axis expanded ±ε, laid out innermost, partners dilated
    on the card (K9c); flip candidates and margin-touched core points are
    settled exactly by ``engine.decide_leaf``.  Lattices past the int32
    decode are prefix-peeled (:func:`scan_plan`).  Chunks are launched up
    to ``pipeline_depth`` ahead and collected in order: each chunk's small
    outputs go ``non_blocking`` into pinned host buffers behind one CUDA
    event, the host waits only on the oldest, and an early exit drops the
    chunks still in flight.
    """
    from fairify_tpu_torch.verify.engine import validate_pair

    t0 = time.perf_counter()

    def time_left() -> float:
        if deadline_s is None:
            return float("inf")
        return deadline_s - (time.perf_counter() - t0)

    plan = scan_plan(net, enc, lo, hi, chunk=chunk, int32_limit=int32_limit)
    if isinstance(plan, str):
        return plan, None
    weights, biases = net.numpy_params()
    dev = net.device
    lo = plan.lo
    hi = np.asarray(hi, dtype=np.int64)
    ra_mode, eps, ra_ws, tile = plan.ra_mode, plan.eps, plan.ra_ws, plan.tile
    peel_dims, suf_dims = plan.peel_dims, plan.suf_dims
    suf_widths, suf_strides, lo_eff = plan.suf_widths, plan.suf_strides, plan.lo_eff
    n_suf, chunk, valid = plan.n_suf, plan.chunk, plan.valid
    valid_np = np.zeros(enc.n_assign, dtype=bool)
    valid_np[valid] = True
    valid_dev = torch.as_tensor(valid_np, device=dev)
    vp_dev = torch.as_tensor(plan.vp.astype(np.float32), device=dev)

    def make_decode(prefix_vals):
        def decode(idx_flat: np.ndarray) -> np.ndarray:
            pts = np.tile(lo, (len(idx_flat), 1))
            if len(peel_dims):
                pts[:, peel_dims] = np.asarray(prefix_vals, dtype=np.int64)
            pts[:, suf_dims] = (idx_flat[:, None] // suf_strides[None, :]) \
                % suf_widths[None, :] + lo_eff[suf_dims][None, :]
            return pts
        return decode

    def settle_sat(decode, idx_flat: int, a: int, b: int):
        x = decode(np.array([idx_flat]))[0]
        xp = x.copy()
        x[np.asarray(enc.pa_idx)] = enc.assignments[a]
        xp[np.asarray(enc.pa_idx)] = enc.assignments[b]
        if validate_pair(weights, biases, x, xp):
            return "sat", (x, xp)
        # A device "certain" sign failed exact validation: no device sign
        # is trustworthy for this net and box.
        raise _EvidenceMismatch

    def work_items():
        """(prefix_vals, bases_dev, c0) stream covering the full lattice."""
        spaces = [range(int(lo[dm]), int(hi[dm]) + 1) for dm in peel_dims]
        for prefix_vals in itertools.product(*spaces):
            bases_dev = torch.as_tensor(plan.bases(enc, prefix_vals), device=dev)
            for c0 in range(0, n_suf, chunk):
                yield prefix_vals, bases_dev, c0

    def leaf_core(decode, idx_flat: int) -> Optional[tuple]:
        """Exact per-point decision (RA mode) through decide_leaf."""
        from fairify_tpu_torch.verify.engine import decide_leaf

        point = decode(np.array([idx_flat]))[0]
        verdict, ce = decide_leaf(enc, weights, biases, point, lo, hi)
        if verdict == "sat":
            return "sat", ce
        return None

    def ra_core_candidates(c0, cells) -> list:
        """Core flat indices whose ±ε window touches any of ``cells``."""
        strides_ra = _ra_strides(ra_ws)
        out = set()
        for m in cells:
            m = int(m)
            rem = m % tile
            row0 = m - rem
            cols = [(rem // st) % w for w, st in zip(ra_ws, strides_ra)]
            spans = [range(max(eps, c - eps), min(w - eps - 1, c + eps) + 1)
                     for c, w in zip(cols, ra_ws)]
            for combo in itertools.product(*spans):
                out.add(c0 + row0 + sum(c * st for c, st in zip(combo, strides_ra)))
        return sorted(out)

    def resolve_ra_cells(decode, c0, cells) -> Optional[tuple]:
        for idx_flat in ra_core_candidates(c0, cells):
            if time_left() <= 0:
                raise _DeadlineHit
            out = leaf_core(decode, idx_flat)
            if out is not None:
                return out
        return None

    def process(prefix_vals, c0, bases_dev, results) -> Optional[tuple]:
        first_flip, margin_count, margin_idx, sign_cols = results
        decode = make_decode(prefix_vals)
        n_here = min(chunk, n_suf - c0)
        if 0 <= int(first_flip) < n_here:
            if ra_mode:
                out = leaf_core(decode, c0 + int(first_flip))
                if out is None:  # certain flip refuted exactly
                    raise _EvidenceMismatch
                return out
            pair = _pair_flip(sign_cols[:, -1], valid, enc.valid_pair)
            if pair is None:
                raise _EvidenceMismatch
            return settle_sat(decode, c0 + int(first_flip), *pair)
        mc = int(margin_count)
        if mc > MARGIN_BUF:
            # Margin buffer overflow: pull the chunk's full sign tensor (K9b)
            # and resolve everything on the host.
            s_full = plan.signs(net, c0, bases_dev).cpu().numpy()[:, :n_here]
            if ra_mode:
                cells = np.where((s_full[valid] == 0).any(axis=0))[0]
                return resolve_ra_cells(decode, c0, cells)
            return _resolve_signs(enc, weights, biases, decode, valid, c0, s_full,
                                  validate_pair, time_left)
        if mc > 0:
            midx = margin_idx[margin_idx >= 0]
            midx = midx[midx < n_here]
            if ra_mode:
                return resolve_ra_cells(decode, c0, midx)
            return _resolve_margin(enc, weights, biases, decode, valid, c0, midx,
                                   sign_cols[:, :MARGIN_BUF], n_here, validate_pair,
                                   time_left)
        return None

    inflight: deque = deque()
    stream = work_items()
    try:
        while True:
            while len(inflight) < pipeline_depth:
                nxt = next(stream, None)
                if nxt is None:
                    break
                if time_left() <= 0:
                    return "unknown", None
                prefix_vals, bases_dev, c0 = nxt
                out = plan.scan(net, c0, bases_dev, valid_dev, vp_dev)
                inflight.append((prefix_vals, c0, bases_dev, *_to_host(out, dev)))
            if not inflight:
                break
            if time_left() <= 0:
                return "unknown", None
            prefix_vals, c0, bases_dev, host, ev = inflight.popleft()
            if ev is not None:
                ev.synchronize()
            ff, mc, midx, cols = (t.numpy() for t in host)
            verdict = process(prefix_vals, c0, bases_dev, (int(ff), int(mc), midx, cols))
            if verdict is not None:
                return verdict
    except (_EvidenceMismatch, _DeadlineHit):
        return "unknown", None
    return "unsat", None


def _resolve_margin(enc, weights, biases, decode, valid, c0, midx, sign_cols, n_here,
                    validate_pair, time_left):
    """Exact-ladder the margin points of one chunk; SAT iff a strict exact
    flip appears once their true signs replace the device zeros."""
    for j, k in enumerate(midx):
        k = int(k)
        if k >= n_here:
            continue
        if time_left() <= 0:
            raise _DeadlineHit
        col = sign_cols[:, j].copy()
        out = _settle_column(enc, weights, biases, decode, valid, c0, k, col,
                             validate_pair)
        if out is not None:
            return out
    return None


def _resolve_signs(enc, weights, biases, decode, valid, c0, s_full, validate_pair,
                   time_left):
    """Host resolution of a full chunk sign tensor (overflow fallback)."""
    vp = enc.valid_pair
    pos = s_full == 1
    neg = s_full == -1
    flip_pts = np.zeros(s_full.shape[1], dtype=bool)
    for a in valid:
        if not pos[a].any():
            continue
        partners = [b for b in valid if vp[a, b]]
        if partners:
            flip_pts |= pos[a] & neg[partners].any(axis=0)
    margin_pts = np.where((s_full[valid] == 0).any(axis=0))[0]
    for k in np.where(flip_pts)[0].tolist() + margin_pts.tolist():
        if time_left() <= 0:
            raise _DeadlineHit
        out = _settle_column(enc, weights, biases, decode, valid, c0, int(k),
                             s_full[:, int(k)].copy(), validate_pair)
        if out is not None:
            return out
    return None


def _settle_column(enc, weights, biases, decode, valid, c0, k, col, validate_pair):
    """Resolve one lattice point: exact-ladder its margin signs, then SAT
    iff a valid ordered pair flips (exact-validated)."""
    for a in valid:
        if col[a] == 0:
            pt = decode(np.array([c0 + k]))[0]
            pt[np.asarray(enc.pa_idx)] = enc.assignments[a]
            col[a] = _host_signs(weights, biases, pt[None])[0]
    pair = _pair_flip(col, valid, enc.valid_pair)
    if pair is None:
        return None
    a, b = pair
    x = decode(np.array([c0 + k]))[0]
    xp = x.copy()
    x[np.asarray(enc.pa_idx)] = enc.assignments[a]
    xp[np.asarray(enc.pa_idx)] = enc.assignments[b]
    if validate_pair(weights, biases, x, xp):
        return "sat", (x, xp)
    # Margin entries of ``col`` were exact-laddered, so a failed validation
    # convicts a device "certain" ±1: no device sign is trustworthy.
    raise _EvidenceMismatch
