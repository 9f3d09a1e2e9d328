"""Partition-grid sharding over a grid of torch devices, and model stacking.

Port of ``fairify_tpu/parallel/mesh.py``.  In the JAX package a mesh is
placement inside one controller process: :func:`shard_parts` pads axis 0
of each array to a multiple of the ``parts`` axis (last row repeated) and
spreads it over the devices, :func:`replicated` copies the net to every
device, the jitted kernel runs on the global array and the caller trims
the output where it needs (``[:n]``, ``[:batch]``, ``[:F]``).

The port's counterpart is a single-process :class:`Mesh`: a ``(parts,
models)`` grid of ``torch.device`` s, not ``torch.distributed`` (that is
the multi-host module's, which is not ported yet).  :func:`shard_map`
launches one kernel wrapper per parts shard, each on the first device of
its row (the ``models`` axis replicates, as ``P("parts")`` does in JAX,
so a shard runs once), inside ``torch.cuda.device(d)`` so the wrapper's
ctypes launch and its stream are that device's; it synchronises once and
concatenates the shards' outputs on the host, untrimmed.  A mesh may
repeat a device (:func:`submesh`), the counterpart of the virtual host
devices XLA is given on the CPU: the CPU tests and a single card run
several shards that way.

A mesh never mixes CPU and CUDA devices, and a CUDA mesh never runs a
plain version: its wrappers see CUDA tensors and launch their kernels.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from fairify_tpu_torch.models.mlp import MLP, StackedMLP
from fairify_tpu_torch.parallel.pipeline import fetch, stage
from fairify_tpu_torch.utils import cuda_build, num
from fairify_tpu_torch.utils.num import resolve_device

# One warning per process for silent device truncation in make_mesh, as in
# the JAX package: a per-call warning would drown a sweep's output.
_TRUNCATION_WARNED = False


def canonical_device(dev) -> torch.device:
    """``torch.device`` with an explicit index for CUDA (``cuda`` is the
    current device), so equal devices compare equal."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ``(parts, models)`` grid of ``torch.device`` s.

    ``devices`` is a ``(parts, models)`` object array and ``shape`` the
    dict ``{"parts": p, "models": m}``, as in ``jax.sharding.Mesh``.  The
    devices are all CPU or all CUDA; on a CUDA mesh the numeric policy
    (TF32 off, f32 matmul precision "highest", ``utils.num``) is set and
    checked — the flags are process-wide in torch, so one check covers
    every device of the mesh.
    """

    def __init__(self, devices: np.ndarray):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError("a mesh is a non-empty (parts, models) device grid")
        kinds = {d.type for d in devices.flat}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh needs all-CPU or all-CUDA devices, got {sorted(kinds)}")
        if kinds == {"cuda"}:
            num.apply_policy()
        self.devices = devices

    @property
    def shape(self) -> dict:
        return {"parts": int(self.devices.shape[0]), "models": int(self.devices.shape[1])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def parts_devices(self) -> list:
        """The device each parts shard runs on: the first of its row."""
        return [row[0] for row in self.devices]

    @property
    def home(self) -> torch.device:
        """The first device: where the unsharded phases run."""
        return self.devices[0, 0]

    @property
    def distinct(self) -> list:
        seen = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return seen


def require_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` unchanged when it is None or a :class:`Mesh`; anything else
    (a ``jax.sharding.Mesh`` included) raises ``TypeError``."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"expected a fairify_tpu_torch Mesh, got {type(mesh).__name__}")
    return mesh


def make_mesh(n_parts: Optional[int] = None, n_models: int = 1, device=None) -> Mesh:
    """Mesh over the visible devices: ``cuda:0 .. cuda:n-1``, or one CPU
    device when the caller passes ``device="cpu"``.

    Without CUDA (and without ``"cpu"``) this raises, as
    ``utils.num.resolve_device`` does.  ``n_parts * n_models`` above the
    device count is an error; below it the mesh takes a prefix of the
    devices and warns once per process.
    """
    global _TRUNCATION_WARNED
    if device is not None and torch.device(device).type == "cpu":
        devs = [torch.device("cpu")]
    else:
        resolve_device(device)
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n_parts = n_parts or (len(devs) // n_models)
    used = n_parts * n_models
    if used > len(devs):
        raise ValueError(
            f"make_mesh: requested {n_parts}x{n_models} mesh needs {used} "
            f"devices but only {len(devs)} are visible")
    if used < len(devs) and not _TRUNCATION_WARNED:
        _TRUNCATION_WARNED = True
        warnings.warn(
            f"make_mesh: {n_parts}x{n_models} mesh uses {used} of "
            f"{len(devs)} visible devices; {len(devs) - used} idle "
            f"(pick n_parts/n_models that factor the device count)",
            RuntimeWarning, stacklevel=2)
    grid = np.empty((n_parts, n_models), dtype=object)
    for i, d in enumerate(devs[:used]):
        grid[i // n_models, i % n_models] = d
    return Mesh(grid)


def submesh(devices: Sequence, n_models: int = 1) -> Mesh:
    """``(parts, models)`` mesh over an explicit device list.

    ``len(devices)`` must be a multiple of ``n_models``; the ``parts`` axis
    takes the rest.  A device may repeat: several shards then run, one
    after the other, on one device — the port's counterpart of the virtual
    host devices XLA is given on the CPU, which lets the CPU tests and a
    single card check the pad, split and gather.
    """
    devs = [canonical_device(d) for d in devices]
    if len(devs) == 0 or len(devs) % n_models:
        raise ValueError(
            f"submesh: {len(devs)} device(s) do not factor into models={n_models}")
    grid = np.empty((len(devs) // n_models, n_models), dtype=object)
    for i, d in enumerate(devs):
        grid[i // n_models, i % n_models] = d
    return Mesh(grid)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``axis`` by repeating its last slice so its length divides
    ``multiple``.  Returns ``(padded, original_length)``; a padded row
    recomputes an existing one and is trimmed by the caller."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_block = np.repeat(np.take(arr, [-1], axis=axis), rem, axis=axis)
    return np.concatenate([arr, pad_block], axis=axis), n


def shard_parts(mesh: Mesh, *arrays: np.ndarray):
    """Pad axis 0 of every array to a multiple of the ``parts`` axis and
    split it: returns ``(shards, n)`` with ``shards[p]`` the tuple of the
    arrays' p-th pieces as tensors on shard p's device, and ``n`` the
    arrays' common original length."""
    p = mesh.shape["parts"]
    padded, lengths = zip(*(pad_to_multiple(np.asarray(a), p) for a in arrays))
    if len(set(lengths)) != 1:
        raise ValueError(f"shard_parts: arrays of unequal lengths {lengths}")
    per = padded[0].shape[0] // p
    shards = [tuple(stage(a[i * per:(i + 1) * per], dev) for a in padded)
              for i, dev in enumerate(mesh.parts_devices)]
    return shards, lengths[0]


def replicated(mesh: Mesh, net):
    """One copy of ``net`` (an ``MLP`` or ``StackedMLP``) per distinct
    device of the mesh — not per shard — as ``{device: net}``.  On a CUDA
    device the kernels' packed parameters are built once here and reused
    by every launch on that copy."""
    cls = StackedMLP if isinstance(net, StackedMLP) else MLP
    out = {}
    for dev in mesh.distinct:
        rep = cls([w.to(dev) for w in net.weights], [b.to(dev) for b in net.biases],
                  [m.to(dev) for m in net.masks])
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                rep.kernel_pack = cuda_build.pack_models(rep)
        out[dev] = rep
    return out


def placement(net, mesh: Optional[Mesh] = None):
    """``(mesh, replicas)`` for :func:`shard_map`: the given mesh with the
    net replicated over it, or without one a one-shard mesh of the net's
    own device holding the net itself."""
    if mesh is not None:
        return mesh, replicated(mesh, net)
    mesh = submesh([net.device])
    return mesh, {mesh.home: net}


def on_device(dev: torch.device):
    """``torch.cuda.device(dev)`` for a CUDA device, else a no-op."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _gather(outs, axis: int, home):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(home, non_blocking=True) for o in outs], dim=axis)
    if isinstance(first, (tuple, list)):
        return type(first)(_gather([o[i] for o in outs], axis, home)
                           for i in range(len(first)))
    raise TypeError(f"shard_map: cannot gather {type(first).__name__}")


def shard_launch(mesh: Mesh, fn, replicas: dict, *arrays, axis: int = 0):
    """``fn(net, *pieces)`` on every parts shard of the arrays (numpy,
    sharded by :func:`shard_parts`, staged through pinned buffers), each on
    its shard's device with that device's replica of the net and current
    stream; every output tensor (nested in tuples and lists as ``fn``
    returns them) concatenated over the shards along ``axis`` (1 for a
    stacked family's model-first outputs) on the mesh's first device,
    without a sync.  The result keeps the shard padding: the caller
    trims."""
    shards, _n = shard_parts(mesh, *arrays)
    outs = []
    for dev, pieces in zip(mesh.parts_devices, shards):
        with on_device(dev):
            outs.append(fn(replicas[dev], *pieces))
    with on_device(mesh.home):
        return _gather(outs, axis, mesh.home)


def shard_map(mesh: Mesh, fn, replicas: dict, *arrays, axis: int = 0):
    """:func:`shard_launch`, then one fetch: the gathered outputs as numpy
    arrays on the host (shard padding kept)."""
    return fetch(shard_launch(mesh, fn, replicas, *arrays, axis=axis))


def stack_models(nets: Sequence[MLP]) -> StackedMLP:
    """Stack same-architecture nets on a leading model axis.

    Covers the reference's sequential model loop for families with a
    uniform architecture (the CP zoo is eleven 6-32-32-1 nets, SURVEY.md
    §2.4).  Raises ``ValueError`` on mixed architectures.
    """
    first = nets[0]
    if any(n.layer_sizes != first.layer_sizes or n.in_dim != first.in_dim for n in nets):
        raise ValueError("stack_models requires uniform architectures")
    stack = lambda attr, i: torch.stack([getattr(n, attr)[i] for n in nets])
    return StackedMLP([stack("weights", i) for i in range(first.depth)],
                      [stack("biases", i) for i in range(first.depth)],
                      [stack("masks", i) for i in range(first.depth)])
