"""Out-of-process SMT: worker pool, wire protocol, solver backends.

Port of ``fairify_tpu/smt``.  Public surface:

* :class:`fairify_tpu_torch.smt.pool.SmtPool` / :class:`PoolConfig` — the
  worker pool (hard wall-clock kills, RSS caps, crash containment,
  parallel fan-out, portfolio racing).
* :func:`fairify_tpu_torch.smt.pool.solve_box` / ``submit_box`` — the
  ``decide_box_smt``-shaped entry points the sweep uses.
* :mod:`fairify_tpu_torch.smt.worker` — the subprocess entry
  (``python -m fairify_tpu_torch.smt.worker``).
* :mod:`fairify_tpu_torch.smt.protocol` / :mod:`fairify_tpu_torch.smt.brute`
  — stdlib-only wire format and exact enumeration backend.

Exports resolve lazily (PEP 562): the worker subprocess imports this
package on every spawn and must never pay for the pool's obs/resilience
imports, let alone torch.
"""
from __future__ import annotations

_LAZY = {
    "SmtPool": ("fairify_tpu_torch.smt.pool", "SmtPool"),
    "PoolConfig": ("fairify_tpu_torch.smt.pool", "PoolConfig"),
    "SmtResult": ("fairify_tpu_torch.smt.pool", "SmtResult"),
    "WorkerDied": ("fairify_tpu_torch.smt.pool", "WorkerDied"),
    "solve_box": ("fairify_tpu_torch.smt.pool", "solve_box"),
    "submit_box": ("fairify_tpu_torch.smt.pool", "submit_box"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(entry[0]), entry[1])
