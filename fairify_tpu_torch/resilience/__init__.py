"""Resilient sweep runtime: fault injection, launch supervision, degradation.

Port of ``fairify_tpu/resilience``.  A partition may always be answered
UNKNOWN but never answered wrongly; this package extends that contract
from solver faults to runtime faults — a launch that returns a CUDA error,
a decode that dies mid-drain, a ledger append over a flaky filesystem — so
a single transient error degrades exactly the affected partitions to
UNKNOWN-with-reason instead of killing the whole budgeted run:

* :mod:`fairify_tpu_torch.resilience.faults` — the deterministic
  fault-injection registry (sites ``launch.submit``, ``launch.decode``,
  ``compile``, ``ledger.append``; ``SweepConfig.inject_faults`` specs
  ``site:kind:nth``).
* :mod:`fairify_tpu_torch.resilience.supervisor` — error classification
  (the CUDA rows included), bounded retries with jittered backoff and a
  per-chunk deadline; exhaustion raises :class:`ChunkDegraded` carrying a
  :class:`ChunkFailure` reason that lands in the ledger.
* :mod:`fairify_tpu_torch.resilience.journal` — the atomic, fsync'd JSONL
  append behind the verdict ledger and the obs event log.
* :mod:`fairify_tpu_torch.resilience.integrity` — the fold checksum, the
  canaries, the ledger CRC, the injected bit flips and the sampled recheck.
"""
from __future__ import annotations

from fairify_tpu_torch.resilience.faults import (  # noqa: F401
    FAULT_SITES,
    InjectedFault,
    armed,
    check,
    disarm,
    parse_specs,
)
from fairify_tpu_torch.resilience.journal import JournalWriter, write_line  # noqa: F401
from fairify_tpu_torch.resilience.supervisor import (  # noqa: F401
    ChunkDegraded,
    ChunkFailure,
    CudaLaunchError,
    Supervisor,
    classify,
)
