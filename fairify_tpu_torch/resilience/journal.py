"""Atomic + fsync'd JSONL appends: the writer behind the verdict ledger.

Copy of ``fairify_tpu/resilience/journal.py`` without its supervisor and
fault-injection hooks (ROADMAP queue 1, item 7): one ``write`` per record
(a crash can only truncate the final line), a flush and an fsync before the
next partition, and, with ``crc=True``, a ``_crc`` field per row (CRC-32 of
the canonical JSON body, :func:`resilience.integrity.record_crc`) that a
resume verifies before trusting the row.
"""
from __future__ import annotations

import json
import os
import threading

from fairify_tpu_torch.resilience import integrity


def write_line(fp, line: str, fsync: bool = True) -> None:
    """One record, one ``write``, flushed (and fsync'd) before returning."""
    fp.write(line)
    fp.flush()
    if fsync:
        os.fsync(fp.fileno())


class JournalWriter:
    """Append-only JSONL sink with crash-safe appends."""

    def __init__(self, path: str, fsync: bool = True, crc: bool = False):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.path = path
        self._fp = open(path, "a")
        self._fsync = fsync
        self._crc = crc
        self._lock = threading.Lock()

    def append(self, rec: dict) -> None:
        if self._crc:
            rec = dict(rec)
            rec["_crc"] = integrity.record_crc(rec)
        line = json.dumps(rec) + "\n"
        with self._lock:
            write_line(self._fp, line, fsync=self._fsync)

    def close(self) -> None:
        with self._lock:
            if not self._fp.closed:
                self._fp.close()

    def __enter__(self) -> "JournalWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
