"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Route: ``nvcc`` compiles each kernel source into its own shared library
with a plain C interface, and :mod:`ctypes` binds it — no PyTorch headers,
so a cold build takes seconds, not minutes.  The sources are compiled for
``sm_90a`` (Hopper) without ``--use_fast_math``: the certificates need IEEE
f32 division and square-free FMA arithmetic.  All sources build in
parallel, one ``nvcc`` process each, the first time any kernel is used;
the libraries land in ``<checkout>/.build_torch/`` under a name keyed by a
hash of the sources and flags, so an edited kernel is rebuilt.

Every C entry point takes its device pointers as ``void*``, the launch
stream last, and returns ``cudaGetLastError()`` right after the launch;
:func:`call` declares the argument types and turns a nonzero code into an
exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), ".build_torch")
SOURCES = ("sim_and_bounds", "stage0_certify", "attack_flips", "parity",
           "pgd_attack", "bab_segment", "sim_rows", "sign_bound", "inter_bounds",
           "lattice_scan", "role_bounds", "attack_logits")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
MAX_LAYERS = 8  # keep in sync with csrc/common.cuh

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as fp:
                h.update(fn.encode() + fp.read())
    return h.hexdigest()[:12]


def build_all() -> Dict[str, object]:
    """Compile every kernel source (in parallel) and load the libraries.

    Idempotent; returns ``build_info`` with the wall seconds of the build
    and each library's ``ptxas`` resource report.
    """
    with _lock:
        if _libs:
            return build_info
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = _digest()
        t0 = time.perf_counter()
        procs = {}
        for name in SOURCES:
            out = os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
            if os.path.isfile(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
        logs = {}
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, out)
        if failed:
            detail = "\n".join(f"--- {n} ---\n{logs[n]}" for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(os.path.join(BUILD_DIR,
                                                   f"lib{name}-{tag}.so"))
        build_info.update(seconds=time.perf_counter() - t0, tag=tag,
                          compiled=sorted(procs), ptxas=logs)
        return build_info


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source (built on first use)."""
    if not _libs:
        build_all()
    return _libs[name]


def call(src: str, name: str, *args) -> None:
    """Call C entry point ``name`` of library ``src`` with ctypes arguments
    (``c_void_p`` pointers and stream, ``c_int``/``c_float`` scalars, the
    host dims array); raise if it returns a nonzero CUDA error code."""
    fn = getattr(lib(src), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_int) if isinstance(a, ctypes.Array)
                   else type(a) for a in args]
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def require_cuda(*tensors: torch.Tensor) -> None:
    """Wrapper-side validation: CUDA, contiguous, one device — the current
    one, on which the C entry point launches (a mesh shard's launch runs
    inside ``torch.cuda.device``)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("kernel inputs must all lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"kernel inputs lie on {dev}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def pack_net(net):
    """Flat float32 parameter buffer + layer dims for the kernels.

    Layout per layer: ``W (in*out, row-major) | b (out) | m (out)``.
    Returns ``(params, dims)`` with ``dims`` a ctypes int array
    ``[d, n_0, ..., n_{L-1}]`` (host memory, read by the C launcher).
    A mesh replica (``parallel.mesh.replicated``) carries its buffer,
    built once, as ``kernel_pack``.
    """
    if getattr(net, "kernel_pack", None) is not None:
        return net.kernel_pack[:2]
    L = net.depth
    if L > MAX_LAYERS:
        raise ValueError(f"net depth {L} exceeds the kernels' MAX_LAYERS={MAX_LAYERS}")
    parts = []
    for w, b, m in zip(net.weights, net.biases, net.masks):
        parts += [w.reshape(-1), b, m]
    params = torch.cat([p.to(torch.float32) for p in parts]).contiguous()
    sizes = [net.in_dim] + list(net.layer_sizes)
    dims = (ctypes.c_int * len(sizes))(*sizes)
    return params, dims


def pack_stack(stacked):
    """:func:`pack_net` of each model of a ``StackedMLP``, back to back:
    model m's buffer starts at ``m * nd.total`` floats (``nd.total`` the
    length of one packed net).  Returns ``(params, dims)``."""
    L = stacked.depth
    if L > MAX_LAYERS:
        raise ValueError(f"net depth {L} exceeds the kernels' MAX_LAYERS={MAX_LAYERS}")
    M = stacked.n_models
    parts = []
    for w, b, m in zip(stacked.weights, stacked.biases, stacked.masks):
        parts += [w.reshape(M, -1), b, m]
    params = torch.cat([p.to(torch.float32) for p in parts], dim=1).reshape(-1).contiguous()
    sizes = [stacked.in_dim] + list(stacked.layer_sizes)
    dims = (ctypes.c_int * len(sizes))(*sizes)
    return params, dims


def pack_models(net):
    """``(params, dims, M)``: :func:`pack_stack` of a stacked net (M its
    models), :func:`pack_net` of a single one (M = 1); a mesh replica's
    ``kernel_pack`` when it carries one."""
    if getattr(net, "kernel_pack", None) is not None:
        return net.kernel_pack
    if hasattr(net, "n_models"):
        return pack_stack(net) + (net.n_models,)
    return pack_net(net) + (1,)


def u32_keys(keys: torch.Tensor) -> torch.Tensor:
    """(N, 2) int64 keys holding uint32 values → int32 with the same bits."""
    k = torch.where(keys >= 1 << 31, keys - (1 << 32), keys)
    return k.to(torch.int32).contiguous()
