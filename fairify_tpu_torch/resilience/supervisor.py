"""Launch supervision: classify, retry with backoff, degrade to UNKNOWN.

Port of ``fairify_tpu/resilience/supervisor.py``: the same
:class:`ChunkFailure` record (``to_record`` layout), :class:`ChunkDegraded`,
:class:`Supervisor` (seeded full-jitter backoff, cooperative per-chunk
``deadline_s``) and :func:`classify`, with the port's own rows for the
errors a CUDA launch raises.  Any error at a supervised site is classified:

=====================================  ==========  ==========================
error                                  class       why
=====================================  ==========  ==========================
``KeyboardInterrupt``, ``SystemExit``, propagate   control flow and resource
``MemoryError``, ``GeneratorExit``                 exhaustion (as in JAX)
``torch.OutOfMemoryError``             propagate   device memory exhaustion,
                                                   the card's ``MemoryError``
:class:`CudaLaunchError` with a        propagate   the CUDA context is
sticky code (:data:`STICKY_CODES`:                 unusable: a retry in the
700 illegal address, 719 launch                    same process cannot help;
failure, ...) or 2 (out of memory)                 the ledger's resume is the
                                                   recovery (JAX's ``crash``)
:class:`CudaLaunchError`, any other    fatal       a bad launch configuration
code                                               or argument: re-launching
                                                   the same launch fails alike
``cuda_build.KernelBuildError``        propagate   a kernel that does not
                                                   build: the run fails, no
                                                   plain version stands in
``OSError`` (``TimeoutError``,         transient   filesystem / link hiccups
``ConnectionError``)                               (as in JAX)
injected ``transient`` / ``fatal`` /   transient / exactly as in JAX
``crash``                              fatal /
                                       propagate
anything else                          fatal       a shape or type error:
                                                   re-attempting cannot help
=====================================  ==========  ==========================

``transient`` errors are retried up to ``max_retries`` times with jittered
exponential backoff, bounded by ``deadline_s``; exhaustion or a fatal error
raises :class:`ChunkDegraded` carrying the :class:`ChunkFailure` the sweep
ledgers with the chunk's partitions (``verdict=unknown`` + ``failure``) and
a later ``resume=True`` pass re-attempts.  Every retry bumps the
``launch_retries`` counter (labelled by site) under a ``resilience.retry``
span.  The deadline is cooperative: it bounds when *another* attempt may
start, not the wall time of a hung one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from fairify_tpu_torch.resilience.faults import InjectedFault

#: Exceptions no supervisor may convert into a degradation.
PROPAGATE = (KeyboardInterrupt, SystemExit, MemoryError, GeneratorExit,
             torch.OutOfMemoryError)

#: CUDA error codes that leave the context unusable (``cudaError_t``):
#: illegal address, launch timeout, device assert, hardware stack error,
#: illegal instruction, misaligned address, invalid address space, invalid
#: PC, launch failure.  A later call in the process returns the same error.
STICKY_CODES = frozenset({700, 702, 710, 714, 715, 716, 717, 718, 719})

#: ``cudaErrorMemoryAllocation``.
CUDA_OUT_OF_MEMORY = 2

#: Propagate-class exception type names matched without importing their
#: modules: the kill signal of a serving replica (the JAX package's
#: ``ReplicaKilled``) and a failed kernel build (``cuda_build``).
_PROPAGATE_NAMES = frozenset({"ReplicaKilled", "KernelBuildError"})


class CudaLaunchError(RuntimeError):
    """A C entry point returned a nonzero CUDA error code
    (``utils.cuda_build.check``)."""

    def __init__(self, name: str, code: int):
        super().__init__(f"{name}: CUDA error {code}")
        self.name = name
        self.code = int(code)

    @property
    def sticky(self) -> bool:
        return self.code in STICKY_CODES


def classify(exc: BaseException) -> str:
    """``'propagate'`` | ``'transient'`` | ``'fatal'`` for one exception (the
    module docstring's table)."""
    if isinstance(exc, InjectedFault):
        return {"transient": "transient", "fatal": "fatal"}.get(
            exc.kind, "propagate")
    if isinstance(exc, PROPAGATE) \
            or any(c.__name__ in _PROPAGATE_NAMES for c in type(exc).__mro__):
        return "propagate"
    if isinstance(exc, CudaLaunchError):
        return "propagate" if exc.sticky or exc.code == CUDA_OUT_OF_MEMORY \
            else "fatal"
    if isinstance(exc, OSError):
        # ConnectionError / TimeoutError are OSError subclasses.  Permanent
        # errno values are knowingly retried: retries are bounded and the
        # exhaustion is counted.
        return "transient"
    return "fatal"


@dataclass
class ChunkFailure:
    """Machine-readable degradation reason for one chunk of partitions."""

    site: str            # which supervised site exhausted/refused
    kind: str            # 'transient-exhausted' | 'fatal' | 'deadline'
    error: str           # exception type name
    detail: str          # str(exception), truncated
    retries: int = 0     # re-attempts actually spent
    shard: Optional[int] = None  # shard index in a shard-level fault domain

    @property
    def reason(self) -> str:
        """Compact reason code for tables/counters: ``site:kind``."""
        return f"{self.site}:{self.kind}"

    def to_record(self) -> dict:
        rec = {"reason": self.reason, "site": self.site, "kind": self.kind,
               "error": self.error, "detail": self.detail[:200],
               "retries": self.retries}
        if self.shard is not None:
            rec["shard"] = self.shard
        return rec


class ChunkDegraded(RuntimeError):
    """Raised by :meth:`Supervisor.run` when a chunk cannot be completed."""

    def __init__(self, failure: ChunkFailure):
        super().__init__(f"chunk degraded: {failure.reason} "
                         f"({failure.error}: {failure.detail[:120]})")
        self.failure = failure


class Supervisor:
    """Bounded-retry wrapper for device launches and pipeline drains.

    One instance per run (seeded, so backoff jitter is reproducible).
    ``deadline_s <= 0`` disables the per-chunk deadline.
    """

    def __init__(self, max_retries: int = 2, backoff_s: float = 0.05,
                 backoff_mult: float = 2.0, deadline_s: float = 0.0,
                 seed: int = 0, sleep: Callable[[float], None] = time.sleep):
        import numpy as np

        self.max_retries = max(0, int(max_retries))
        self.backoff_s = float(backoff_s)
        self.backoff_mult = float(backoff_mult)
        self.deadline_s = float(deadline_s)
        self._sleep = sleep
        self._rng = np.random.default_rng(seed)

    def _backoff(self, attempt: int) -> float:
        base = self.backoff_s * (self.backoff_mult ** attempt)
        return base * (1.0 + float(self._rng.random()))  # full jitter, 1-2x

    def run(self, fn: Callable, site: str,
            on_retry: Optional[Callable[[], None]] = None):
        """``fn()`` with supervision; returns its value or raises.

        ``on_retry`` runs before each re-attempt (e.g. re-dispatching a
        launch whose fetched payload a failed decode lost); an error inside
        it counts as the attempt's failure.
        """
        from fairify_tpu_torch import obs

        t0 = time.perf_counter()
        retries = 0
        while True:
            try:
                if retries and on_retry is not None:
                    on_retry()
                return fn()
            except BaseException as exc:
                cls = classify(exc)
                if cls == "propagate":
                    raise
                if cls == "fatal":
                    raise ChunkDegraded(ChunkFailure(
                        site=site, kind="fatal", error=type(exc).__name__,
                        detail=str(exc), retries=retries)) from exc
                elapsed = time.perf_counter() - t0
                if 0 < self.deadline_s <= elapsed:
                    raise ChunkDegraded(ChunkFailure(
                        site=site, kind="deadline", error=type(exc).__name__,
                        detail=str(exc), retries=retries)) from exc
                if retries >= self.max_retries:
                    raise ChunkDegraded(ChunkFailure(
                        site=site, kind="transient-exhausted",
                        error=type(exc).__name__, detail=str(exc),
                        retries=retries)) from exc
                retries += 1
                obs.registry().counter("launch_retries").inc(site=site)
                with obs.span("resilience.retry", site=site, attempt=retries,
                              error=type(exc).__name__):
                    self._sleep(self._backoff(retries - 1))
