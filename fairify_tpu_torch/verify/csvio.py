"""Result sink: the reference's 24-column per-partition CSV schema, bit-kept.

Copy of ``fairify_tpu/verify/csvio.py`` (the port imports nothing of ``fairify_tpu``).

Schema and append-per-partition behavior from ``src/GC/Verify-GC.py:272-309``
(identical across all drivers).  Keeping the schema lets verdicts be diffed
row-for-row against reference outputs.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

RES_COLS = [
    "Partition_ID", "Verification", "SAT_count", "UNSAT_count", "UNK_count",
    "h_attempt", "h_success",
    "B_compression", "S_compression", "ST_compression", "H_compression", "T_compression",
    "SV-time", "S-time", "HV-Time", "H-Time", "Total-Time",
    "C-check", "V-accurate", "Original-acc", "Pruned-acc", "Acc-dec", "C1", "C2",
]


@dataclass
class PartitionRow:
    partition_id: int
    verdict: str  # 'sat' | 'unsat' | 'unknown'
    sat_count: int
    unsat_count: int
    unk_count: int
    h_attempt: int = 0
    h_success: int = 0
    b_compression: float = 0.0
    s_compression: float = 0.0
    st_compression: float = 0.0
    h_compression: float = 0.0
    t_compression: float = 0.0
    sv_time: float = 0.0
    s_time: float = 0.0
    hv_time: float = 0.0
    h_time: float = 0.0
    total_time: float = 0.0
    c_check: int = 0
    v_accurate: int = 0
    original_acc: float = 0.0
    pruned_acc: float = 0.0
    c1: Optional[np.ndarray] = None
    c2: Optional[np.ndarray] = None
    extra: dict = field(default_factory=dict)

    def to_list(self) -> list:
        def fmt_ce(v):
            # The reference writes the str() of a float32 numpy array
            # (``src/GC/Verify-GC.py:226-227,307-308``) or '' when absent.
            return str(np.asarray(v, dtype=np.float32)) if v is not None else ""

        return [
            self.partition_id, self.verdict, self.sat_count, self.unsat_count,
            self.unk_count, self.h_attempt, self.h_success,
            round(self.b_compression, 4), round(self.s_compression, 4),
            round(self.st_compression, 4), round(self.h_compression, 4),
            round(self.t_compression, 4),
            round(self.sv_time, 4), round(self.s_time, 4), round(self.hv_time, 4),
            round(self.h_time, 4), round(self.total_time, 4),
            self.c_check, self.v_accurate,
            round(self.original_acc, 4), round(self.pruned_acc, 4), "-",
            fmt_ce(self.c1), fmt_ce(self.c2),
        ]


def append_row(path: str, row: PartitionRow) -> None:
    exists = os.path.isfile(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a", newline="") as fp:
        wr = csv.writer(fp, dialect="excel")
        if not exists:
            wr.writerow(RES_COLS)
        wr.writerow(row.to_list())


def rewrite_deduped(path: str) -> None:
    """Rewrite a partition CSV keeping the LAST row per Partition_ID, sorted,
    with the cumulative SAT/UNSAT/UNK counter columns recomputed.

    ``retry_unknown`` re-decides budget-exhausted partitions and appends
    their fresh rows; this restores the one-row-per-partition, ascending-id
    shape — and counters consistent with the final verdicts — that
    row-for-row comparisons expect (the csv module handles the multi-line
    quoted counterexample cells).
    """
    if not os.path.isfile(path):
        return
    with open(path, newline="") as fp:
        rows = list(csv.reader(fp))
    if not rows:
        return
    header, body = rows[0], rows[1:]
    last = {}
    for row in body:
        last[int(row[0])] = row
    counts = {"sat": 0, "unsat": 0, "unknown": 0}
    with open(path, "w", newline="") as fp:
        wr = csv.writer(fp)
        wr.writerow(header)
        for pid in sorted(last):
            row = last[pid]
            verdict = row[1] if row[1] in counts else "unknown"
            counts[verdict] += 1
            row[2:5] = [counts["sat"], counts["unsat"], counts["unknown"]]
            wr.writerow(row)
