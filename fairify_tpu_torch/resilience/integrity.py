"""Result-integrity detectors: fold checksum, canary, ledger-row CRC.

Copy of the detection half of ``fairify_tpu/resilience/integrity.py``: the
host mirror of the kernels' wrapping int32 fold (:func:`fold_host`), the
known-answer canary checks (:func:`check_canary` for stage-0 segments,
:func:`check_bab_canary` for device-BaB segments), their combinations
(:func:`verify_segment`, :func:`verify_bab_segment`), and the per-row ledger CRC (:func:`record_crc`,
:func:`verify_records`).  Fault injection and the sampled recheck are not
ported yet (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

import json
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# Mega-segment payload keys covered by the device fold, in fold order.
# The host mirror must walk them in the same order (int32 wraparound sums
# commute, but keeping the order pinned keeps the contract obvious).
FOLD_KEYS = ("cert", "wit", "reason", "stats")

# Device-BaB segment payload keys (``verify.engine.bab_segment`` outputs), in
# the kernel's fold order — the packed frontier queue plus the per-root
# counters.  Floats fold through the same int32 truncation on both sides
# (a C cast and torch's ``to(int32)`` both round toward zero), so equal
# buffers fold equal on any backend.
BAB_FOLD_KEYS = ("q_lo", "q_hi", "q_root", "q_live", "found",
                 "wit_a", "wit_b", "wit_pt", "nodes", "splits", "overflow")


def fold_host(payload: Dict[str, np.ndarray],
              keys: Iterable[str] = FOLD_KEYS) -> int:
    """Mirror of the device-side packed-buffer fold (wraparound int32).

    The mega kernels compute ``sum(int32(buf))`` over each packed buffer
    with int32 accumulation (two's-complement wraparound in XLA); numpy's
    ``np.sum(dtype=int32)`` has the same C semantics, so equal data folds
    equal on any backend.
    """
    total = np.int32(0)
    with np.errstate(over="ignore"):
        for k in keys:
            arr = np.asarray(payload[k])
            total = np.int32(
                total + np.sum(arr.astype(np.int32), dtype=np.int32))
    return int(total)


def check_canary(payload: Dict[str, np.ndarray]) -> bool:
    """True iff the trailing canary chunk row holds its known answer.

    The canary is an all-invalid chunk (``valid=0`` everywhere, ``nv=0``):
    the certify kernel vacuously certifies it and the attack finds
    nothing, net-independent — ``cert`` all True, ``reason`` all 1
    (certified, no flip), ``wit`` all zero.
    """
    cert = np.asarray(payload["cert"])
    wit = np.asarray(payload["wit"])
    reason = np.asarray(payload["reason"])
    return (bool(np.all(cert[-1])) and bool(np.all(reason[-1] == 1))
            and bool(np.all(wit[-1] == 0)))


def check_bab_canary(payload: Dict[str, np.ndarray]) -> bool:
    """True iff the BaB queue's trailing canary slot holds its known answer.

    The canary slot is never allocated (``slot_ok`` False): it enters the
    segment dead and all-zero, the kernel's compaction can never scatter a
    child into it, and its latch can never set — so it must come back
    exactly as it went in: not live, not found, zero box, zero witness
    point.
    """
    return (not bool(np.any(np.asarray(payload["q_live"])[-1]))
            and not bool(np.any(np.asarray(payload["found"])[-1]))
            and bool(np.all(np.asarray(payload["q_lo"])[-1] == 0))
            and bool(np.all(np.asarray(payload["q_hi"])[-1] == 0))
            and bool(np.all(np.asarray(payload["wit_pt"])[-1] == 0)))


def verify_bab_segment(payload: Dict[str, np.ndarray]) -> Optional[str]:
    """Integrity-check one fetched device-BaB segment payload: None when
    clean, else ``"checksum"`` (host fold over :data:`BAB_FOLD_KEYS` !=
    device fold) or ``"canary"`` (the never-allocated trailing slot came
    back non-zero)."""
    if "csum" in payload and \
            fold_host(payload, keys=BAB_FOLD_KEYS) != int(payload["csum"]):
        return "checksum"
    if not check_bab_canary(payload):
        return "canary"
    return None


def verify_segment(payload: Dict[str, np.ndarray]) -> Optional[str]:
    """Integrity-check one fetched mega-segment payload.

    Returns None when clean, else which detector tripped: ``"checksum"``
    (host fold != device fold) or ``"canary"`` (known-answer row wrong).
    Checksum first — it covers every buffer; the canary additionally
    catches a transfer that was corrupted *consistently* (e.g. a stuck
    line flipping the same bit in data and fold).
    """
    if "csum" in payload and fold_host(payload) != int(payload["csum"]):
        return "checksum"
    if not check_canary(payload):
        return "canary"
    return None


def record_crc(rec: dict) -> int:
    """CRC-32 of the canonical JSON body (sans ``_crc``), as written/verified.

    Canonical = ``sort_keys=True`` so writer and reader agree regardless
    of dict insertion order; JSON floats round-trip exactly through
    ``repr`` so re-serialising a parsed row reproduces the bytes.
    """
    body = {k: v for k, v in rec.items() if k != "_crc"}
    return zlib.crc32(json.dumps(body, sort_keys=True).encode("utf-8"))


def verify_records(recs: Iterable[dict]) -> Tuple[List[dict], int]:
    """Split ledger records into (trusted, n_crc_mismatch).

    Rows carrying ``_crc`` must match the recomputed CRC; mismatches are
    dropped (the pid is simply un-ledgered, so decided-wins resume
    re-attempts it — a corrupted verdict is never trusted).  Legacy rows
    without ``_crc`` pass through, keeping old ledgers resumable.  The
    ``_crc`` field is stripped from trusted rows so downstream merge /
    bit-equality comparisons see the verdict body only.
    """
    good: List[dict] = []
    bad = 0
    for rec in recs:
        if "_crc" not in rec:
            good.append(rec)
            continue
        if record_crc(rec) == rec["_crc"]:
            good.append({k: v for k, v in rec.items() if k != "_crc"})
        else:
            bad += 1
    return good, bad
