"""Per-phase wall-clock timing, keeping the reference's CSV timing schema.

The reference records five timing columns per partition — ``SV-time``
(solver), ``S-time`` (sound phase), ``HV-Time`` (heuristic solver),
``H-Time`` (heuristic phase), ``Total-Time`` (``src/GC/Verify-GC.py:272-292``)
— via ad-hoc ``time.time()`` subtraction (``compute_time``,
``utils/verif_utils.py:562-565``).  :class:`PhaseTimer` provides the same
numbers as named phases.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class PhaseTimer:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.phases: Dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - start)

    def total(self) -> float:
        return time.perf_counter() - self.t0

    def get(self, name: str) -> float:
        # Raw float: rounding happens only at serialization (e.g.
        # ``ThroughputCounter.dump``) — ``get`` used to round to 2 decimals
        # while ``dump`` rounded to 3, so sums over phases disagreed with
        # the dumped per-phase values.
        return self.phases.get(name, 0.0)
