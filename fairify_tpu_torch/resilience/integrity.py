"""Result-integrity detectors and injected bit flips.

Copy of ``fairify_tpu/resilience/integrity.py``: the host mirror of the
kernels' wrapping int32 fold (:func:`fold_host`), the known-answer canary
checks (:func:`check_canary` for stage-0 segments, :func:`check_bab_canary`
for device-BaB segments), their combinations (:func:`verify_segment`,
:func:`verify_bab_segment`), and the per-row ledger CRC
(:func:`record_crc`, :func:`verify_records`); the deterministic bit flips
that ``corrupt`` fault specs inject (:func:`flip_bit`,
:func:`corrupt_host`, :func:`corrupt_record`, :func:`corrupt_witness`: the
flip is keyed on the corruption arrival number, so a schedule reproduces
the same wrong bit every run); and the hash-keyed selection of the sampled
recheck (:func:`sampled`).  Containment on any mismatch rides the
degradation contract: the affected span demotes to
``unknown:failure:integrity.*`` and is re-attempted on resume.
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


# --------------------------------------------------------------------------
# deterministic corruption (chaos injection side)

def flip_bit(arr: np.ndarray, n: int) -> np.ndarray:
    """Return a copy of ``arr`` with one deterministically-chosen bit flipped.

    ``n`` (the corruption arrival number) picks the element and the bit,
    so a chaos schedule reproduces the same flip every run.  Booleans are
    inverted wholesale (their one semantic bit); floats get their exponent
    MSB flipped (a magnitude-scale error — the classic SDC signature — so
    downstream range checks cannot accidentally absorb it); integers get
    a low-order XOR.
    """
    out = np.array(arr, copy=True)
    flat = out.reshape(-1)
    if flat.size == 0:
        return out
    i = n % flat.size
    if out.dtype == np.bool_:
        flat[i] = not flat[i]
        return out
    if np.issubdtype(out.dtype, np.floating):
        bits = flat.view(np.uint32 if out.dtype.itemsize == 4 else np.uint64)
        bits[i] ^= np.asarray(1 << (out.dtype.itemsize * 8 - 2), bits.dtype)
        return out
    nbits = out.dtype.itemsize * 8
    flat[i] = flat[i] ^ np.asarray(1 << (n % max(nbits - 1, 1)), out.dtype)
    return out


def corrupt_host(payload: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
    """Flip one bit in a fetched device payload (``launch.decode:corrupt``).

    Targets the data buffers, never the riding ``csum`` scalar — the model
    is a flipped bit in the result the host is about to *trust*; the
    checksum is the detector.  (A flipped checksum with intact data would
    also be flagged, conservatively, as a corrupt transfer.)
    """
    keys = sorted(k for k, v in payload.items()
                  if k != "csum" and isinstance(v, np.ndarray) and v.size)
    if not keys:
        return payload
    key = keys[n % len(keys)]
    out = dict(payload)
    out[key] = flip_bit(payload[key], n)
    return out


def corrupt_record(rec: dict, n: int) -> dict:
    """Mutate a ledger row (``ledger.append:corrupt``) post-CRC.

    The nastiest possible flip is chosen on purpose: a decided verdict
    inverts (``unsat`` <-> ``sat``), anything else gets its partition id
    bit-flipped.  The row stays valid JSON — this is a *corrupt* row, not
    a torn line, and must be caught by the CRC, not the JSON parser.
    """
    out = dict(rec)
    v = out.get("verdict")
    if v == "unsat":
        out["verdict"] = "sat"
    elif v == "sat":
        out["verdict"] = "unsat"
    elif isinstance(out.get("partition_id"), int):
        out["partition_id"] = out["partition_id"] ^ (1 << (n % 8))
    return out


def corrupt_witness(ce: Tuple[np.ndarray, np.ndarray],
                    n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Flip one bit in an SMT counterexample pair (``smt.query:corrupt``)."""
    x, xp = np.asarray(ce[0], dtype=np.float64), np.asarray(ce[1], np.float64)
    if n % 2 == 0:
        return flip_bit(x, n), xp
    return x, flip_bit(xp, n)


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


# --------------------------------------------------------------------------
# sampled recheck selection

def sampled(seed: int, key: str, rate: float) -> bool:
    """Deterministic Bernoulli(rate) draw keyed on ``(seed, key)``.

    Hash-based (CRC-32 of the key string), not RNG-state-based, so the
    selection is independent of arrival order, thread interleaving, and
    resume — the same chunk is rechecked in the original run and its
    resume, which is what makes recheck results comparable.
    """
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = zlib.crc32(f"{seed}:{key}".encode("utf-8"))
    return (h % 1_000_000) / 1_000_000.0 < rate
