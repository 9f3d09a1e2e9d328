"""The launch registry: per kernel, its launches, shape signatures and
first launch; per run, the ``nvcc`` builds.

The JAX package's ``obs_jit`` (``fairify_tpu/obs/compile.py``) keeps a
registry of its jitted kernels: compiles, signatures, compile seconds.  The
port's kernels are built once by ``nvcc`` (``utils.cuda_build``) and
launched through ctypes, so its registry keeps what a launch has instead:

* per kernel name (:data:`KERNELS`), the launches, the distinct shape
  signatures it was launched with, and the host seconds its first launch
  took (the build included when it was the first kernel to run);
* the ``nvcc`` builds (:func:`record_build`: sources compiled, seconds), so
  that a warm run can be checked to have built nothing.

A kernel wrapper counts a launch where it launches its kernel, and nowhere
else: ``with launches.launching("attack_flips", xr.shape): ...`` around the
launch helper (on the CPU the plain version runs and counts nothing).
:func:`counts` / :func:`reset` are what ``chip_smoke.py`` and the sweep's
``ModelReport.kernel_launches`` read; :func:`snapshot` and :func:`delta`
give the throughput JSON's ``launches`` block.  Each launch also bumps the
metrics registry's ``device_launches`` counter, which the spans' automatic
``launches`` attribute and the heartbeat read.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

# Every kernel entry point of the port, in the order of the PERF.md table.
KERNELS = ("sim_and_bounds", "stage0_certify", "attack_flips", "parity", "pgd_attack",
           "bab_segment", "sim_rows", "grid_keys", "sign_bound", "inter_bounds",
           "role_logits", "lattice_scan", "lattice_signs", "lattice_scan_ra",
           "role_bounds", "attack_logits", "role_certify", "sim_stats", "alpha_crown",
           "train_step", "fit_step", "pair_step", "pair_inconsistency", "synth_step",
           "synth_draw")


class LaunchRegistry:
    """Per-kernel launch accounting; thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._launches: Dict[str, int] = {k: 0 for k in KERNELS}
            self._sigs: Dict[str, set] = {k: set() for k in KERNELS}
            self._first_s: Dict[str, float] = {}
            self._builds = 0
            self._build_s = 0.0

    def record(self, name: str, signature=(), seconds: Optional[float] = None) -> None:
        if name not in self._launches:
            raise KeyError(f"unknown kernel {name!r} (known: {KERNELS})")
        with self._lock:
            self._launches[name] += 1
            self._sigs[name].add(tuple(signature))
            if seconds is not None and name not in self._first_s:
                self._first_s[name] = seconds
        from fairify_tpu_torch.obs import metrics

        metrics.registry().counter("device_launches").inc()

    def first_pending(self, name: str) -> bool:
        return name not in self._first_s

    def record_build(self, sources: int, seconds: float) -> None:
        with self._lock:
            self._builds += int(sources)
            self._build_s += float(seconds)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._launches)

    def snapshot(self) -> dict:
        with self._lock:
            return {"launches": dict(self._launches),
                    "signatures": {k: len(v) for k, v in self._sigs.items()},
                    "first_launch_s": dict(self._first_s),
                    "builds": self._builds, "build_s": self._build_s}


_REGISTRY = LaunchRegistry()


def counts() -> Dict[str, int]:
    """Launches by kernel name since the last :func:`reset`."""
    return _REGISTRY.counts()


def reset() -> None:
    _REGISTRY.reset()


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def record_build(sources: int, seconds: float) -> None:
    _REGISTRY.record_build(sources, seconds)


@contextlib.contextmanager
def launching(name: str, signature=()):
    """Count one launch of kernel ``name`` with shape ``signature`` when the
    body (the launch helper) returns; the first one's host seconds are kept."""
    first = _REGISTRY.first_pending(name)
    t0 = time.perf_counter() if first else 0.0
    yield
    _REGISTRY.record(name, signature,
                     time.perf_counter() - t0 if first else None)


def delta(before: dict) -> dict:
    """The throughput JSON's ``launches`` block: this run's launches by
    kernel (the kernels it launched), their shape signatures (all seen so
    far in the process), first-launch seconds of the kernels first launched
    in this run, and the ``nvcc`` builds of this run."""
    now = snapshot()
    launched = {k: v - before["launches"][k] for k, v in now["launches"].items()
                if v > before["launches"][k]}
    return {"launches": launched,
            "signatures": {k: now["signatures"][k] for k in launched},
            "first_launch_s": {k: round(v, 6) for k, v in now["first_launch_s"].items()
                               if k not in before["first_launch_s"]},
            "builds": now["builds"] - before["builds"],
            "build_s": round(now["build_s"] - before["build_s"], 3)}
