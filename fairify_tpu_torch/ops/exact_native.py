"""ctypes loader of the port's native exact-arithmetic core
(``fairify_tpu_torch/csrc/exact_core.cc``).

Port of ``fairify_tpu/ops/exact_native.py``.  The C++ library computes the
exact dyadic-rational signs of network logits and neuron interval bounds —
the same values as the ``fractions.Fraction`` paths of
:mod:`fairify_tpu_torch.ops.exact` and
:func:`fairify_tpu_torch.verify.engine.exact_logit_sign`, orders of
magnitude faster.  It is host code: ``g++ -O2 -std=c++17 -shared -fPIC``
(with ``-fopenmp`` where that compiles) builds it at first use into
``<checkout>/.build_torch/`` under a name keyed by a hash of the source and
the flags, so an edited source is rebuilt.  Each helper returns ``None``
when the library is unavailable and the callers fall back to the Fraction
path; :func:`available` says which route runs.

Set ``FAIRIFY_TORCH_NO_NATIVE=1`` to force the fallback (the tests compare
both routes).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "exact_core.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".build_torch")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
NO_NATIVE_ENV = "FAIRIFY_TORCH_NO_NATIVE"
_ABI = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None  # why the library is unavailable, if it is


def _build(out: str) -> bool:
    """Compile the source into ``out`` (with OpenMP where it compiles)."""
    global build_error
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"  # unique per process; replace is atomic
    base = ["g++", *CXX_FLAGS, "-o", tmp, SOURCE]
    for cmd in (base + ["-fopenmp"], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as exc:
            build_error = f"{' '.join(cmd)}: {exc}"
            continue
        os.replace(tmp, out)
        return True
    return False


def _library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fp:
        h.update(fp.read())
    return os.path.join(BUILD_DIR, f"libfairify_exact-{h.hexdigest()[:12]}.so")


def _declare(lib: ctypes.CDLL) -> None:
    i, f, i64, i8, u8 = (ctypes.POINTER(t) for t in (
        ctypes.c_int, ctypes.c_float, ctypes.c_int64, ctypes.c_int8, ctypes.c_uint8))
    n = ctypes.c_int
    for name, args in (("ft_forward_signs", [n, i, f, f, n, i64, i8]),
                       ("ft_certify_dead", [n, i, f, f, i64, i64, u8, u8]),
                       ("ft_certify_dead_batch", [n, i, f, f, n, i64, i64, u8, u8]),
                       ("ft_bound_signs", [n, i, f, f, i64, i64, ctypes.c_void_p, i8, i8])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get(NO_NATIVE_ENV):
            build_error = f"{NO_NATIVE_ENV} is set"
            return None
        try:
            so = _library_path()
            if not os.path.isfile(so) and not _build(so):
                return None
            lib = ctypes.CDLL(so)
            lib.ft_abi_version.argtypes, lib.ft_abi_version.restype = [], ctypes.c_int
            if lib.ft_abi_version() != _ABI:
                build_error = "ABI version mismatch"
                return None
        except OSError as exc:
            build_error = str(exc)
            return None
        _declare(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _net_args(weights, biases):
    """``(sizes, C arguments, buffers)``: the layer widths, the leading C
    arguments (layer count, sizes, flat f32 weights, flat f32 biases) and
    the arrays behind them, which the caller keeps alive for the call."""
    sizes = [np.asarray(weights[0]).shape[0]] + [np.asarray(w).shape[1] for w in weights]
    sizes_c = np.ascontiguousarray(sizes, dtype=np.int32)
    w_flat = np.ascontiguousarray(
        np.concatenate([np.asarray(w, dtype=np.float32).ravel() for w in weights]))
    b_flat = np.ascontiguousarray(
        np.concatenate([np.asarray(b, dtype=np.float32).ravel() for b in biases]))
    return sizes, (len(weights), _ptr(sizes_c, ctypes.c_int),
                   _ptr(w_flat, ctypes.c_float), _ptr(b_flat, ctypes.c_float)), \
        (sizes_c, w_flat, b_flat)


def forward_signs(weights: Sequence[np.ndarray], biases: Sequence[np.ndarray],
                  points: np.ndarray) -> Optional[np.ndarray]:
    """Exact logit signs at integer points; (N, d_in) → int8 (N,), or None."""
    lib = _load()
    if lib is None:
        return None
    sizes, args, _keep = _net_args(weights, biases)
    pts = np.ascontiguousarray(np.asarray(points, dtype=np.int64).reshape(-1, sizes[0]))
    out = np.zeros(pts.shape[0], dtype=np.int8)
    lib.ft_forward_signs(*args, pts.shape[0], _ptr(pts, ctypes.c_int64),
                         _ptr(out, ctypes.c_int8))
    return out


def _proposed(proposed_dead, hidden, P: int) -> np.ndarray:
    """(P, sum(hidden)) uint8 proposals, hidden layers side by side."""
    if not hidden:
        return np.zeros((P, 0), dtype=np.uint8)
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(proposed_dead[l], dtype=np.float64).reshape(P, -1) > 0.5
         for l in range(len(hidden))], axis=1).astype(np.uint8))


def _split(cert: np.ndarray, sizes) -> List[np.ndarray]:
    """Per-layer (P, n_l) float32 masks, the output layer all zero."""
    out, off = [], 0
    for n in sizes[1:-1]:
        out.append(cert[:, off:off + n].astype(np.float32))
        off += n
    out.append(np.zeros((cert.shape[0], sizes[-1]), dtype=np.float32))
    return out


def certify_dead_batch(weights: Sequence[np.ndarray], biases: Sequence[np.ndarray],
                       lo: np.ndarray, hi: np.ndarray,
                       proposed_dead: Sequence[np.ndarray]) -> Optional[List[np.ndarray]]:
    """Exact certification of P boxes in one native call.

    ``lo``/``hi``: (P, d_in) integer boxes; ``proposed_dead``: per weight
    layer (P, n_l) masks.  Returns per-layer (P, n_l) float32 certified
    masks (the output layer all zero), or None without the library.
    """
    lib = _load()
    if lib is None:
        return None
    sizes, args, _keep = _net_args(weights, biases)
    lo_c = np.ascontiguousarray(np.asarray(lo, dtype=np.int64).reshape(-1, sizes[0]))
    hi_c = np.ascontiguousarray(np.asarray(hi, dtype=np.int64).reshape(-1, sizes[0]))
    P = lo_c.shape[0]
    prop = _proposed(proposed_dead, sizes[1:-1], P)
    cert = np.zeros_like(prop)
    lib.ft_certify_dead_batch(*args, P, _ptr(lo_c, ctypes.c_int64),
                              _ptr(hi_c, ctypes.c_int64), _ptr(prop, ctypes.c_uint8),
                              _ptr(cert, ctypes.c_uint8))
    return _split(cert, sizes)


def certify_dead(weights: Sequence[np.ndarray], biases: Sequence[np.ndarray],
                 lo: Sequence[int], hi: Sequence[int],
                 proposed_dead: Sequence[np.ndarray]) -> Optional[List[np.ndarray]]:
    """Native twin of :func:`fairify_tpu_torch.ops.exact.certify_dead_masks`
    for one box: per-layer (n_l,) float32 masks, or None."""
    lib = _load()
    if lib is None:
        return None
    sizes, args, _keep = _net_args(weights, biases)
    lo_c = np.ascontiguousarray(np.asarray(lo, dtype=np.int64))
    hi_c = np.ascontiguousarray(np.asarray(hi, dtype=np.int64))
    prop = _proposed([np.asarray(p)[None] for p in proposed_dead[:len(sizes) - 2]],
                     sizes[1:-1], 1)
    cert = np.zeros_like(prop)
    lib.ft_certify_dead(*args, _ptr(lo_c, ctypes.c_int64), _ptr(hi_c, ctypes.c_int64),
                        _ptr(prop, ctypes.c_uint8), _ptr(cert, ctypes.c_uint8))
    return [m[0] for m in _split(cert, sizes)]


def bound_signs(weights: Sequence[np.ndarray], biases: Sequence[np.ndarray],
                lo: Sequence[int], hi: Sequence[int],
                alive: Optional[Sequence[np.ndarray]] = None,
                ) -> Optional[Tuple[List[np.ndarray], List[np.ndarray]]]:
    """Exact per-neuron pre-activation bound signs over an integer box:
    ``(ws_lb_sign, ws_ub_sign)`` per-layer int8 arrays, or None."""
    lib = _load()
    if lib is None:
        return None
    sizes, args, _keep = _net_args(weights, biases)
    lo_c = np.ascontiguousarray(np.asarray(lo, dtype=np.int64))
    hi_c = np.ascontiguousarray(np.asarray(hi, dtype=np.int64))
    total = sum(sizes[1:])
    lbs = np.zeros(total, dtype=np.int8)
    ubs = np.zeros(total, dtype=np.int8)
    alive_arr = None
    alive_ptr = ctypes.c_void_p(0)
    if alive is not None:
        alive_arr = np.ascontiguousarray(np.concatenate(
            [np.asarray(alive[l], dtype=np.float64).ravel() > 0.5
             for l in range(len(sizes) - 1)]).astype(np.uint8))
        alive_ptr = ctypes.c_void_p(alive_arr.ctypes.data)
    lib.ft_bound_signs(*args, _ptr(lo_c, ctypes.c_int64), _ptr(hi_c, ctypes.c_int64),
                       alive_ptr, _ptr(lbs, ctypes.c_int8), _ptr(ubs, ctypes.c_int8))
    out_lb, out_ub, off = [], [], 0
    for n in sizes[1:]:
        out_lb.append(lbs[off:off + n].copy())
        out_ub.append(ubs[off:off + n].copy())
        off += n
    return out_lb, out_ub
