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
:func:`call` declares the argument types and turns a nonzero code into a
:class:`resilience.supervisor.CudaLaunchError`, which the supervisor
classifies by its code (a sticky error propagates, any other is fatal).

The build is the ``compile`` fault site: each attempt first counts one
arrival there, a transient failure is retried by a
:class:`resilience.supervisor.Supervisor`, and a build that fails or runs
out of retries raises :class:`KernelBuildError`, which every supervisor
propagates: a kernel never falls back to its plain version.  While
``nvcc`` runs, the live heartbeat prints a "building <source>" flag, and
the launch registry (``obs.launches``) counts the sources compiled and
their seconds.
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
           "lattice_scan", "role_bounds", "attack_logits", "train_step",
           "synth_step")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
MAX_LAYERS = 8  # keep in sync with csrc/common.cuh

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_info: Dict[str, object] = {}


class KernelBuildError(RuntimeError):
    """The kernels could not be built: ``nvcc`` failed, or the ``compile``
    site's retries ran out.  Supervisors propagate it."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as fp:
                h.update(fn.encode() + fp.read())
    return h.hexdigest()[:12]


def _compile(nvcc: str, tag: str) -> tuple:
    """One build attempt: a ``compile`` fault-site arrival, then every
    missing library compiled in parallel.  Returns ``(compiled, logs)``."""
    from fairify_tpu_torch.obs import heartbeat
    from fairify_tpu_torch.resilience import faults

    faults.check("compile")
    procs = {}
    for name in SOURCES:
        out = os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
        if os.path.isfile(out):
            continue
        heartbeat.notify_build(f"{name}.cu")
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
        raise KernelBuildError(f"nvcc failed for {failed}:\n{detail}")
    return sorted(procs), logs


def build_all(supervisor=None) -> Dict[str, object]:
    """Compile every kernel source (in parallel) and load the libraries.

    Idempotent; returns ``build_info`` with the wall seconds of the build
    and each library's ``ptxas`` resource report.  ``supervisor`` (default
    :class:`resilience.supervisor.Supervisor` with its default retries)
    retries a transient failure at the ``compile`` site; exhaustion raises
    :class:`KernelBuildError`.
    """
    from fairify_tpu_torch.obs import launches
    from fairify_tpu_torch.resilience.supervisor import ChunkDegraded, Supervisor

    with _lock:
        if _libs:
            return build_info
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = _digest()
        t0 = time.perf_counter()
        sup = supervisor if supervisor is not None else Supervisor()
        try:
            compiled, logs = sup.run(lambda: _compile(nvcc, tag), site="compile")
        except ChunkDegraded as exc:
            raise KernelBuildError(f"kernel build failed: {exc}") from exc
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(os.path.join(BUILD_DIR,
                                                   f"lib{name}-{tag}.so"))
        seconds = time.perf_counter() - t0
        launches.record_build(len(compiled), seconds)
        build_info.update(seconds=seconds, tag=tag, compiled=compiled, ptxas=logs)
        return build_info


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source (built on first use)."""
    if not _libs:
        build_all()
    return _libs[name]


_entries: Dict[tuple, object] = {}


def entry(src: str, name: str, types: tuple):
    """C entry point ``name`` of library ``src`` declared with argument
    ``types`` and an ``int`` result: one function object per signature,
    declared once."""
    key = (src, name, types)
    fn = _entries.get(key)
    if fn is None:
        fn = lib(src)[name]
        fn.restype = ctypes.c_int
        fn.argtypes = list(types)
        _entries[key] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise :class:`resilience.supervisor.CudaLaunchError` if C entry point
    ``name`` returned a nonzero CUDA error code."""
    if err != 0:
        from fairify_tpu_torch.resilience.supervisor import CudaLaunchError

        raise CudaLaunchError(name, err)


def arg_types(args) -> tuple:
    """The ctypes argument types of ``args`` (``c_void_p`` pointers and
    stream, ``c_int``/``c_float`` scalars, the host dims array)."""
    return tuple(ctypes.POINTER(ctypes.c_int) if isinstance(a, ctypes.Array) else type(a)
                 for a in args)


def call(src: str, name: str, *args) -> None:
    """Call C entry point ``name`` of library ``src`` with ctypes arguments
    (:func:`arg_types`); raise if it returns a nonzero CUDA error code."""
    check(name, entry(src, name, arg_types(args))(*args))


_streamed: Dict[tuple, object] = {}


def streamed_entry(src: str, name: str, args: tuple):
    """C entry point ``name`` of library ``src`` typed for ``args`` and a
    trailing stream, looked up once per (source, name): the launch helpers
    that build their arguments every call skip the typing."""
    fn = _streamed.get((src, name))
    if fn is None:
        fn = _streamed[(src, name)] = entry(src, name, arg_types(args) + (ctypes.c_void_p,))
    return fn


_scratch: Dict[tuple, torch.Tensor] = {}


def scratch(owner: str, device, n: int) -> torch.Tensor:
    """A float32 scratch buffer of at least ``n`` floats on ``device``, one
    per ``owner`` and device (launches on one stream reuse it in turn)."""
    buf = _scratch.get((owner, device))
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1 << 16), dtype=torch.float32, device=device)
        _scratch[(owner, device)] = buf
    return buf


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


def _cached(net, kind: str, build):
    """``build(net)``, built once per net and kind and kept on the net.

    Nets are immutable (``MLP.with_masks`` builds a new one; parameters are
    frozen), so a pack stays valid while the net's parameter tensors are
    the same objects at the same storage address and version; ``Module.to``
    or an in-place op on a parameter rebuilds it."""
    params = [p for group in (net.weights, net.biases, net.masks)
              for p in group._parameters.values()]
    stamp = tuple((p._version, p.data_ptr()) for p in params)
    cache = net.__dict__.setdefault("_kernel_packs", {})
    hit = cache.get(kind)
    if (hit is not None and len(hit[0]) == len(params)
            and all(a is b for a, b in zip(hit[0], params)) and hit[1] == stamp):
        return hit[2]
    value = build(net)
    cache[kind] = (tuple(params), stamp, value)
    return value


def _dims(sizes):
    return (ctypes.c_int * len(sizes))(*sizes)


def _check_depth(L: int) -> None:
    if L > MAX_LAYERS:
        raise ValueError(f"net depth {L} exceeds the kernels' MAX_LAYERS={MAX_LAYERS}")


def _pack_net(net):
    _check_depth(net.depth)
    parts = []
    for w, b, m in zip(net.weights, net.biases, net.masks):
        parts += [w.reshape(-1), b, m]
    params = torch.cat([p.to(torch.float32) for p in parts]).contiguous()
    return params, _dims([net.in_dim] + list(net.layer_sizes))


def pack_net(net):
    """Flat float32 parameter buffer + layer dims for the kernels.

    Layout per layer: ``W (in*out, row-major) | b (out) | m (out)``.
    Returns ``(params, dims)`` with ``dims`` a ctypes int array
    ``[d, n_0, ..., n_{L-1}]`` (host memory, read by the C launcher).
    Built once per net (:func:`_cached`); a mesh replica
    (``parallel.mesh.replicated``) carries its buffer as ``kernel_pack``.
    """
    if getattr(net, "kernel_pack", None) is not None:
        return net.kernel_pack[:2]
    return _cached(net, "net", _pack_net)


def _pack_stack(stacked):
    _check_depth(stacked.depth)
    M = stacked.n_models
    parts = []
    for w, b, m in zip(stacked.weights, stacked.biases, stacked.masks):
        parts += [w.reshape(M, -1), b, m]
    params = torch.cat([p.to(torch.float32) for p in parts], dim=1).reshape(-1).contiguous()
    return params, _dims([stacked.in_dim] + list(stacked.layer_sizes))


def pack_stack(stacked):
    """:func:`pack_net` of each model of a ``StackedMLP``, back to back:
    model m's buffer starts at ``m * nd.total`` floats (``nd.total`` the
    length of one packed net).  Returns ``(params, dims)``; built once."""
    return _cached(stacked, "stack", _pack_stack)


def pack_models(net):
    """``(params, dims, M)``: :func:`pack_stack` of a stacked net (M its
    models), :func:`pack_net` of a single one (M = 1); a mesh replica's
    ``kernel_pack`` when it carries one."""
    if getattr(net, "kernel_pack", None) is not None:
        return net.kernel_pack
    if hasattr(net, "n_models"):
        return pack_stack(net) + (net.n_models,)
    return pack_net(net) + (1,)


def odd_layout(sizes) -> dict:
    """Float offsets of :func:`pack_odd`'s layout (``common.cuh:make_desc``
    with ``odd_rows``): per layer ``W`` (in x ldw, ldw = out | 1, the odd
    stride) | ``b`` (out) | ``m`` (out); ``total`` floats, and ``padded``,
    ``total`` rounded up to 4 (the staged length: a bulk copy moves 16-byte
    units)."""
    lay = {k: [] for k in ("ldw", "w", "b", "m")}
    off = 0
    for l in range(len(sizes) - 1):
        ldw = sizes[l + 1] | 1
        lay["ldw"].append(ldw)
        lay["w"].append(off)
        off += sizes[l] * ldw
        lay["b"].append(off)
        lay["m"].append(off + sizes[l + 1])
        off += 2 * sizes[l + 1]
    lay["total"] = off
    lay["padded"] = (off + 3) // 4 * 4
    return lay


def _pack_odd_models(net):
    stacked = hasattr(net, "n_models")
    M = net.n_models if stacked else 1
    sizes = [net.in_dim] + list(net.layer_sizes)
    _check_depth(len(sizes) - 1)
    lay = odd_layout(sizes)
    flat = torch.zeros((M, lay["padded"]), dtype=torch.float32, device=net.device)
    for l, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        w, b, m = (w, b, m) if stacked else (w[None], b[None], m[None])
        n_in, n_out = sizes[l], sizes[l + 1]
        o = lay["w"][l]
        flat[:, o:o + n_in * lay["ldw"][l]].view(M, n_in, lay["ldw"][l])[:, :, :n_out] = w
        flat[:, lay["b"][l]:lay["b"][l] + n_out] = b
        flat[:, lay["m"][l]:lay["m"][l] + n_out] = m
    return flat.reshape(-1), _dims(sizes), M


def pack_odd_models(net):
    """``(params, dims, M)``: :func:`pack_odd`'s layout for each model of
    a stacked net back to back, model m at ``m * odd_layout(dims)["padded"]``
    floats (16-byte aligned), or for a single net (M = 1).  KB
    (``csrc/stage0_certify.cu``) reads it.  Built once per net
    (:func:`_cached`)."""
    return _cached(net, "odd_models", _pack_odd_models)


def pack_odd(net):
    """``(params, dims)``: :func:`pack_net`'s layout with each weight row
    padded to an odd stride (:func:`odd_layout`), so a warp whose lanes read
    one column of consecutive rows hits 32 distinct banks (K6,
    ``csrc/bab_segment.cu``, and K8a, ``csrc/sign_bound.cu``).  Built once
    per net (:func:`_cached`)."""
    if hasattr(net, "n_models"):
        raise TypeError("pack_odd: one net; a stacked family takes pack_odd_models")
    return pack_odd_models(net)[:2]


# ---------------------------------------------------------------------------
# The padded pack and the tile menu of csrc/warp_tile.cuh (attack_logits.cu,
# pgd_attack.cu and lattice_scan.cu)
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448  # dynamic shared memory one block may use on sm_90
SMEM_PER_SM = 233472  # shared memory of one SM; each resident block also takes 1,024
TILES = ((8, 8), (8, 4), (4, 4), (4, 2), (4, 1))  # (rows, columns) a lane owns


def _round8(v: int) -> int:
    return (v + 7) // 8 * 8


def pad_layout(sizes) -> dict:
    """Float offsets of one model's padded pack (``warp_tile.cuh:
    make_pad_desc``): per layer ``W`` (in x ldw, ldw = out rounded up to
    8, zero columns past out) | ``b`` (ldw) | ``m`` (ldw), which end at
    ``fwd``; then per layer ``W^T`` (out x ldt, ldt = in rounded up to 8),
    which end at ``total``."""
    L = len(sizes) - 1
    lay = {k: [] for k in ("ldw", "ldt", "w", "b", "m", "wt")}
    off = 0
    for l in range(L):
        ldw = _round8(sizes[l + 1])
        lay["ldw"].append(ldw)
        lay["w"].append(off)
        off += sizes[l] * ldw
        lay["b"].append(off)
        lay["m"].append(off + ldw)
        off += 2 * ldw
    lay["fwd"] = off
    for l in range(L):
        ldt = _round8(sizes[l])
        lay["ldt"].append(ldt)
        lay["wt"].append(off)
        off += sizes[l + 1] * ldt
    lay["total"] = off
    return lay


def _pack_padded(net):
    stacked = hasattr(net, "n_models")
    M = net.n_models if stacked else 1
    sizes = [net.in_dim] + list(net.layer_sizes)
    _check_depth(len(sizes) - 1)
    lay = pad_layout(sizes)
    bufs = []
    for k in range(M):
        flat = torch.zeros(lay["total"], dtype=torch.float32, device=net.device)
        for l, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
            w, b, m = (w[k], b[k], m[k]) if stacked else (w, b, m)
            n_in, n_out = sizes[l], sizes[l + 1]
            ldw, ldt = lay["ldw"][l], lay["ldt"][l]
            o = lay["w"][l]
            flat[o:o + n_in * ldw].view(n_in, ldw)[:, :n_out] = w
            flat[lay["b"][l]:lay["b"][l] + n_out] = b
            flat[lay["m"][l]:lay["m"][l] + n_out] = m
            o = lay["wt"][l]
            flat[o:o + n_out * ldt].view(n_out, ldt)[:, :n_in] = w.t()
        bufs.append(flat)
    return torch.cat(bufs).contiguous(), _dims(sizes), M


def pack_padded(net):
    """``(params, dims, M)``: the padded pack (:func:`pad_layout`) of each
    model of a stacked net back to back (model m at ``m * total``
    floats), or of a single net (M = 1).  The kernels of ``warp_tile.cuh``
    read it: every weight row 16-byte aligned, the transposed copy for the
    PGD's backward pass.  Built once per net (:func:`_cached`)."""
    return _cached(net, "padded", _pack_padded)


def pick_tile(nout: int, tw: int) -> int:
    """Index into :data:`TILES` of the tile a layer of ``nout`` outputs
    takes in a warp tile of ``tw`` rows (``warp_tile.cuh:pick_tile``): the
    one with the fewest instructions per lane and k-step over all its
    passes (``RR·RC`` FMAs plus twice its ``RR/4 + ceil(RC/4)`` loads), the
    larger on a tie."""
    best, best_cost = -1, None
    for i, (rr, rc) in enumerate(TILES):
        if tw % rr:
            continue
        items = -(-nout // rc) * (tw // rr)
        cost = -(-items // 32) * (rr * rc + 2 * (rr // 4 + -(-rc // 4)))
        if best < 0 or cost < best_cost:
            best, best_cost = i, cost
    return best


def tile_passes(nout: int, tw: int) -> int:
    """Passes of the 32 lanes over the items of :func:`pick_tile`'s tile."""
    rr, rc = TILES[pick_tile(nout, tw)]
    return -(-(-(-nout // rc) * (tw // rr)) // 32)


_sms: Dict[int, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once per device)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def u32_keys(keys: torch.Tensor) -> torch.Tensor:
    """(N, 2) int64 keys holding uint32 values → int32 with the same bits."""
    k = torch.where(keys >= 1 << 31, keys - (1 << 32), keys)
    return k.to(torch.int32).contiguous()
