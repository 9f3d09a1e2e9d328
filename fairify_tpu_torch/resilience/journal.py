"""Atomic + fsync'd JSONL appends: the one writer behind ledger and event log.

Port of ``fairify_tpu/resilience/journal.py``:

* **Torn lines** — :func:`write_line` hands the OS exactly one ``write``
  per record, so the only possible tear is a truncated final line, which
  the ledger reader and ``obs.load_events`` tolerate (and count).
* **Lost buffers** — the verdict ledger fsyncs per append; the obs event
  log flushes only (spans are advisory, the ledger is the record of truth).
* **Flaky filesystems** — :class:`JournalWriter` routes appends through a
  :class:`resilience.supervisor.Supervisor` when given one: transient
  errors are retried with backoff; exhaustion is *recorded*
  (``ledger_append_failures`` counter + a ``degraded`` event) and reported
  to the caller as ``False``, never raised — the verdict stays in the
  in-memory report, and a later resume re-decides it.
* **Silent corruption** — with ``crc=True`` each record carries a ``_crc``
  field (CRC-32 of the canonical JSON body,
  :func:`resilience.integrity.record_crc`) that the sweep's ledger reader
  verifies on replay; a mismatched row is dropped and counted
  (``ledger_crc_mismatch``), so a resume re-decides it.

``JournalWriter`` is a named fault-injection site (``fault_site``, the
sweep's ``ledger.append``); a ``ledger.append:corrupt`` spec mutates a row
*after* its CRC is sealed, keeping it valid JSON.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional


def write_line(fp, line: str, fsync: bool = True) -> None:
    """One record, one ``write``, flushed (and fsync'd) before returning."""
    fp.write(line)
    fp.flush()
    if fsync:
        os.fsync(fp.fileno())


class JournalWriter:
    """Append-only JSONL sink with crash-safe, supervised appends."""

    def __init__(self, path: str, fsync: bool = True,
                 fault_site: Optional[str] = None, supervisor=None,
                 crc: bool = False):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.path = path
        self._fp = open(path, "a")
        self._fsync = fsync
        self._site = fault_site
        self._sup = supervisor
        self._crc = crc
        self._lock = threading.Lock()

    def _append_once(self, line: str) -> None:
        from fairify_tpu_torch.resilience import faults

        if self._site:
            faults.check(self._site)
        with self._lock:
            write_line(self._fp, line, fsync=self._fsync)

    def append(self, rec: dict) -> bool:
        """Append one record; ``False`` if supervised retries exhausted.

        Without a supervisor, errors propagate (callers that cannot
        tolerate a lost record should not pass one).
        """
        if self._crc:
            from fairify_tpu_torch.resilience import faults, integrity

            crc = integrity.record_crc(rec)
            n = faults.corruption(self._site or "ledger.append")
            if n is not None:
                # Injected SDC: mutate AFTER the CRC is sealed, keeping
                # the row valid JSON — the reader's CRC check, not its
                # parser, must be what catches it.
                rec = integrity.corrupt_record(rec, n)
            rec = dict(rec)
            rec["_crc"] = crc
        line = json.dumps(rec) + "\n"
        if self._sup is None:
            self._append_once(line)
            return True
        from fairify_tpu_torch import obs
        from fairify_tpu_torch.resilience.supervisor import ChunkDegraded

        try:
            self._sup.run(lambda: self._append_once(line),
                          site=self._site or "ledger.append")
        except ChunkDegraded as exc:
            obs.registry().counter("ledger_append_failures").inc()
            obs.event("degraded", **exc.failure.to_record(), path=self.path)
            return False
        return True

    def close(self) -> None:
        with self._lock:
            if not self._fp.closed:
                self._fp.close()

    def __enter__(self) -> "JournalWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
