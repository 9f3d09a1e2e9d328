"""Profiler hooks and the partition-throughput counter.

Port of ``fairify_tpu/utils/profiling.py``:

* :func:`xla_trace` (the JAX package's name, kept so the two are easy to
  find) opens a ``torch.profiler.profile`` capture around a region when
  ``profile_dir`` is set: CPU activities, plus CUDA activities when a card
  is there, written as a Chrome trace into ``profile_dir`` when the region
  ends (``trace-<pid>-<n>.json``).
* :func:`annotation` / :func:`annotate_step` stamp the capture with
  ``torch.profiler.record_function`` ranges named after the obs spans
  (``stage0_decide``, ``stage0_decide#3`` for the fourth segment's
  submit, ...), so the kernels of each phase sit under its name in the
  trace.  Both cost one integer check while no capture is open.
* :class:`ThroughputCounter` stays as in the JAX package; the
  ``device_launches`` counter it sat beside is bumped by the launch
  registry (``obs.launches``), once per kernel launch.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

# Nesting depth of open captures: the annotations below are emitted only
# while a capture is open, so untraced runs pay one int check.
_capture_depth = 0
_captures = itertools.count()


@contextlib.contextmanager
def xla_trace(profile_dir: Optional[str]):
    """Capture a region with ``torch.profiler`` when ``profile_dir`` is set
    (CPU activities, CUDA activities too when a card is there) and write
    its Chrome trace into ``profile_dir``; a no-op otherwise."""
    global _capture_depth
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _capture_depth += 1
        try:
            yield
        finally:
            _capture_depth -= 1
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace-{os.getpid()}-{next(_captures)}.json"))


@contextlib.contextmanager
def annotation(name: str):
    """A ``record_function`` range named after an obs span; a no-op unless
    an :func:`xla_trace` capture is open."""
    if _capture_depth <= 0:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


def annotate_step(name: str, step, fn):
    """Run ``fn()`` under a ``record_function`` range ``name#step`` (one per
    segment or chunk submit, from inside the launch pipeline's submit
    lambdas); a plain call unless a capture is open."""
    if _capture_depth <= 0:
        return fn()
    import torch

    with torch.profiler.record_function(f"{name}#{int(step)}"):
        return fn()


@dataclass
class ThroughputCounter:
    """Decided-partitions/sec accounting, per phase and per chip."""

    started_at: float = field(default_factory=time.perf_counter)
    decided: int = 0
    stage0_decided: int = 0
    bab_decided: int = 0
    unknown: int = 0
    n_devices: int = 1

    def record(self, verdict: str, via_stage0: bool) -> None:
        if verdict in ("sat", "unsat"):
            self.decided += 1
            if via_stage0:
                self.stage0_decided += 1
            else:
                self.bab_decided += 1
        else:
            self.unknown += 1
        from fairify_tpu_torch.obs import metrics

        metrics.registry().counter("decisions").inc(
            verdict=verdict, via="stage0" if via_stage0 else "bab")
