"""Observability layer: span tracing, metrics registry, heartbeat, launches.

Port of ``fairify_tpu/obs`` (its ``__init__`` and the modules below); the
event log keeps the JAX package's record layout, so its ``obs.load_events``
and ``obs.report.aggregate`` read a log the port wrote.

* :mod:`fairify_tpu_torch.obs.trace` — nested, thread-safe spans appended
  to a per-run JSONL event log, exportable as a Chrome trace.  Disabled by
  default; the off path is one global read per span.
* :mod:`fairify_tpu_torch.obs.metrics` — named counters / gauges /
  histograms with labels, resettable per run.
* :mod:`fairify_tpu_torch.obs.heartbeat` — a throttled stderr progress
  line for long sweeps (flags ``nvcc`` builds in progress).
* :mod:`fairify_tpu_torch.obs.launches` — the launch registry, in place of
  the JAX package's ``obs_jit`` compile registry.
* :mod:`fairify_tpu_torch.obs.funnel` — the verification funnel's states
  and margin histograms.

Instrumented code imports this package only (``from fairify_tpu_torch
import obs``) and uses :func:`obs.span` / :func:`obs.timed_span` /
:func:`obs.event` / :func:`obs.registry`; tracers are owned by entry points
via :func:`obs.tracing` (``verify_model`` with ``cfg.trace_out``).
"""
from __future__ import annotations

import contextlib

from fairify_tpu_torch.obs.heartbeat import Heartbeat  # noqa: F401
from fairify_tpu_torch.obs.metrics import MetricsRegistry, registry  # noqa: F401
from fairify_tpu_torch.obs.trace import (  # noqa: F401
    TraceContext,
    Tracer,
    chrome_trace_path,
    context,
    context_fields,
    current,
    current_context,
    event,
    load_events,
    maybe_tracing,
    new_trace_id,
    shard_path,
    shard_paths,
    span,
    tracing,
    write_chrome_trace,
    write_chrome_trace_merged,
)


@contextlib.contextmanager
def timed_span(timer, name: str, **attrs):
    """A span that also accumulates into a :class:`utils.timing.PhaseTimer`
    phase.

    The sweep's budget arithmetic (the hard timeout, each row's amortized
    stage-0 share) runs off ``PhaseTimer`` totals whether or not tracing is
    on; this keeps that always-on accounting and the optional event log in
    one instrumentation point.  While a ``torch.profiler`` capture is open
    (``profile_dir``, ``utils.profiling.xla_trace``) the phase is also a
    ``record_function`` range of the same name, so the profiler's kernels
    sit under the span names.
    """
    from fairify_tpu_torch.utils import profiling as _profiling

    with _profiling.annotation(name), span(name, **attrs) as sp:
        if timer is None:
            yield sp
        else:
            with timer.phase(name):
                yield sp
