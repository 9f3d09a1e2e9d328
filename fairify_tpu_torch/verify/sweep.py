"""The partition sweep: grid → prune → certify + attack → parity → the
refinement tail → ledger.

Port of ``fairify_tpu/verify/sweep.py:verify_model`` and of its stacked
family stage 0 (``stage0_families``), CROWN or IBP certificates
(``use_crown``), on one device or over a mesh (``parallel.mesh.Mesh``).
Each pass runs one launch per segment of ``mega_chunks`` grid chunks (the
mega path) or, with ``mega_chunks = 0``, always on the IBP path and
always with a mesh (:func:`use_mega`), one per grid chunk padded to the
chunk size (the chunk loop); both give the same verdicts, witnesses,
ledger and histograms.

* **Prune pass** — :func:`verify.pruning.sound_prune_grid`: KA
  (``csrc/sim_and_bounds.cu``), then with ``exact_certify_masks`` (the
  default) the exact-rational mask pass on the host (the native exact
  core, ``ops/exact_native.py``).  One supervised unit (``site="prune"``):
  losing it degrades no verdict, only the mask columns and the heuristic
  retry.
* **Stage 0, IBP path** — per chunk one row-13 launch (role-logit bounds,
  ``csrc/role_bounds.cu``) and one row-17 launch (attack logits,
  ``csrc/attack_logits.cu``), each with a model axis for a stacked family;
  the certificate, margin, flips and gap on the host.
* **Stage 0, CROWN path** — one KB launch (certificate, ``csrc/stage0_certify.cu``)
  and one KC launch (attack, flips, histograms, fold,
  ``csrc/attack_flips.cu``) per segment (the stacked chunks plus the
  integrity canary chunk; the host checks the fold and the canary) or per
  chunk (:func:`stage0_block_submit`; histograms binned on the host); the
  host replays every flip exactly before it counts as SAT.
* **Stage 0 with a mesh** — per chunk the certificate alone (KB as rows
  14 and 6, :func:`engine.role_certify`; row 13 on the IBP path) over the
  mesh's ``parts`` shards, then the attack forward (row 17) unsharded on
  the mesh's first device, the flips and gap on the host
  (:func:`engine.split_certify_attack_submit`).  For a stacked
  family (:func:`stage0_families`) the same launches carry a model axis:
  every model attacks the same candidates and replays its witnesses on its
  own weights; :func:`verify_model` then takes each model's result as
  ``stage0=`` and skips its own stage-0 launches.
* **Parity pass** — KD (``csrc/parity.cu``).
* **stage0_pgd** — the deep PGD attack (K5, ``csrc/pgd_attack.cu``) over
  every stage-0 leftover, one launch per grid chunk, then the exact
  flip-slab search from the near-zero seeds within a quarter of the
  remaining hard budget.
* **bab** — :func:`verify.engine.decide_many` on what is left, under
  ``min(soft_timeout × leftovers, hard budget left)``: Phase S, the
  uniform-sign BaB (role logits, ``csrc/attack_logits.cu``; β-CROWN sign
  bounds, K8a ``csrc/sign_bound.cu``) with Phase L, the host LP BaB on
  CROWN pre-activation bounds (K8b ``csrc/inter_bounds.cu``), inside it;
  Phase E0, the exhaustive lattice scan of the cheap enumerable roots
  (K9a ``lattice_scan``, K9c ``lattice_scan_ra`` for RA queries, K9b
  ``lattice_signs`` on a margin overflow: ``csrc/lattice_scan.cu``); the
  device BaB (K6, ``csrc/bab_segment.cu``; segment 0 plain CROWN, later
  segments α-CROWN) or, with ``device_bab=False`` or on the IBP path, the
  host-frontier BaB (KB with α and the branching score, and KC, per
  frontier batch; on the IBP path row 13, then row 17 on the undecided
  boxes); Phase
  P, the pair LP BaB (K8b again); Phase E, the lattice scan of the
  enumerable roots still unknown (K9 again).
* **Heuristic retry** — each still-unknown partition is re-decided on its
  heuristically pruned net (:func:`ops.heuristic.heuristic_prune`,
  :func:`verify.engine.decide_box`); a SAT must replay on the original net,
  and the partition's parity is taken again on its new masks from samples
  regenerated on the card (K12's row generator, ``csrc/sim_rows.cu``).
* **SMT tier** (``smt_retry_timeouts_s``) — after the BaB phase's last
  device sync, every root still unknown fans its SMT-LIB query
  (:func:`verify.smt.build_query`) out over the worker pool
  (:mod:`fairify_tpu_torch.smt`, worker subprocesses that never touch
  CUDA) while the reporting loop runs (:class:`_SmtTier`); a root the
  heuristic retry decides has its query cancelled, a SAT witness must
  replay on the host net, a sampled SMT UNSAT is rechecked by the exact
  oracle, and a root whose worker died degrades as ``smt.worker:*``.
  ``smt_defer`` hands the answers still in flight to an :class:`SmtDrain`.
* **Reporting** — CRC-checked JSONL ledger (unknown rows carry the
  engine's ``engine_reason``), the 24-column CSV, the counterexample CSV,
  with a ``dataset`` the original accuracy and, with
  ``partition_metrics``, the per-partition group-metrics CSV, and the
  throughput JSON with per-phase ``phases_s`` and, per engine phase, the
  partitions it decided on the first pass (``engine_decided``).
* :func:`run_sweep` — the verification scripts' outer loop over a model family
  (``models.zoo``), with its dataset (``data.loaders``): architecture
  groups share one stacked stage 0, then ``verify_model`` per model.

The runtime contracts are the JAX package's: stage 0, the parity pass and
``stage0_pgd`` share one :class:`parallel.pipeline.LaunchPipeline` of
``pipeline_depth`` launches in flight (the host decode of one launch
overlaps the next launch; its drain is the only sync point) and one
:class:`resilience.supervisor.Supervisor` (``max_launch_retries``,
``launch_backoff_s``, ``chunk_deadline_s``); a fault that exhausts it
degrades exactly its chunk or segment to UNKNOWN with a ``failure``
record, and ``resume=True`` re-attempts it.  ``inject_faults`` arms the
fault schedule (``resilience.faults``), ``integrity_recheck`` re-runs a
sampled share of the decided chunks (:func:`_sampled_recheck`),
``trace_out`` writes the span/event log, ``heartbeat_s`` the progress
line and ``profile_dir`` a ``torch.profiler`` trace.
"""
from __future__ import annotations

import csv
import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from fairify_tpu_torch import obs
from fairify_tpu_torch.data import loaders
from fairify_tpu_torch.models import zoo
from fairify_tpu_torch.models.mlp import StackedMLP, excise, predict_np
from fairify_tpu_torch.obs import funnel as funnel_mod
from fairify_tpu_torch.obs import launches
from fairify_tpu_torch.ops import heuristic as heur_ops
from fairify_tpu_torch.ops import masks as mask_ops
from fairify_tpu_torch.ops.simulate import PLAIN_ROWS, mean_scale
from fairify_tpu_torch.parallel import mesh as mesh_mod
from fairify_tpu_torch.parallel.pipeline import LaunchPipeline, fetch, stage
from fairify_tpu_torch.partition import grid as grid_mod
from fairify_tpu_torch.resilience import faults as faults_mod
from fairify_tpu_torch.resilience import integrity as integrity_mod
from fairify_tpu_torch.resilience.journal import JournalWriter
from fairify_tpu_torch.resilience.supervisor import (ChunkDegraded, ChunkFailure,
                                                     Supervisor, classify)
from fairify_tpu_torch.utils import cuda_build, prng, profiling
from fairify_tpu_torch.utils.num import resolve_device
from fairify_tpu_torch.utils.prng import grid_keys, shuffled_order, simulate_boxes
from fairify_tpu_torch.utils.timing import PhaseTimer
from fairify_tpu_torch.verify import csvio, engine, pruning
from fairify_tpu_torch.verify.config import SweepConfig
from fairify_tpu_torch.verify.property import PairEncoding, encode, role_boxes

# Every kernel entry point of the port (``obs.launches``' names).
KERNELS = launches.KERNELS

# The runtime counters whose per-run deltas the throughput JSON reports.
RUN_COUNTERS = ("fault_injected", "launch_retries", "chunks_degraded",
                "integrity_violations", "integrity_rechecks", "unknown_retries",
                "unknown_retry_success", "ledger_crc_mismatch",
                "ledger_append_failures")


@dataclass
class PartitionOutcome:
    partition_id: int
    verdict: str
    counterexample: Optional[tuple] = None
    h_attempt: int = 0
    h_success: int = 0
    nodes: int = 0
    times: Dict[str, float] = field(default_factory=dict)
    compressions: Dict[str, float] = field(default_factory=dict)
    c_check: int = 0
    v_accurate: int = 0
    pruned_acc: float = 0.0


@dataclass
class ModelReport:
    model: str
    dataset: str
    outcomes: List[PartitionOutcome]
    original_acc: float = 0.0
    total_time_s: float = 0.0
    partitions_total: int = 0
    sink_name: str = ""
    ledger_skipped_lines: int = 0
    # Partitions answered UNKNOWN because a runtime fault degraded their
    # chunk (each carries a ledger ``failure`` record; resume re-attempts).
    degraded: int = 0
    funnel: Optional[dict] = None
    # Kernel launches of this run by kernel name (0 on the CPU, where the
    # plain PyTorch versions run instead): ``obs.launches``' counts.
    kernel_launches: Dict[str, int] = field(default_factory=dict)
    # Deferred SMT answers (``smt_defer``): an :class:`SmtDrain` whose
    # ``drain()`` consumes the pool futures still in flight and patches the
    # outcomes and the ledger; None when the tier finished inline or never ran.
    smt_pending: Optional[object] = None

    @property
    def counts(self) -> Dict[str, int]:
        c = {"sat": 0, "unsat": 0, "unknown": 0}
        for o in self.outcomes:
            c[o.verdict] += 1
        return c


def build_partitions(cfg: SweepConfig):
    """Partition grid as (p_list, lo, hi) in deterministic shuffled order."""
    query = cfg.query()
    domain = query.domain
    ranges = {k: list(v) for k, v in domain.ranges.items()}
    if cfg.capped_partitions:
        p_dict = grid_mod.partition_attributes_capped(ranges, cfg.partition_threshold)
        p_list = grid_mod.partitioned_ranges_capped(
            list(domain.columns), list(query.protected), p_dict, ranges,
            max_partitions=cfg.max_partitions,
            rng=np.random.default_rng(cfg.seed))
        order = shuffled_order(len(p_list), cfg.seed)
        p_list = [p_list[i] for i in order]
        lo, hi = grid_mod.boxes_from_partitions(p_list, domain.columns)
        return p_list, lo.astype(np.int64), hi.astype(np.int64)
    p_dict = grid_mod.partition_attributes(ranges, cfg.partition_threshold)
    lo0, hi0 = grid_mod.product_boxes(domain.columns, p_dict, ranges)
    order = shuffled_order(lo0.shape[0], cfg.seed)
    lo, hi = lo0[order], hi0[order]
    return grid_mod.BoxList(lo, hi, domain.columns), lo, hi


def check_supported(cfg: SweepConfig, mesh=None) -> None:
    """Reject what the port cannot run before any work starts: a ``mesh``
    that is not a ``parallel.mesh.Mesh`` raises ``TypeError``.  Every
    setting of ``SweepConfig`` runs."""
    mesh_mod.require_mesh(mesh)


def use_mega(cfg: SweepConfig, mesh=None) -> bool:
    """Whether stage 0, the prune and the parity passes run the mega path
    (the JAX package's ``_use_mega``): only the fused CROWN body on one
    device has one, so the IBP path and a mesh take the chunk loop
    whatever ``mega_chunks`` says."""
    return cfg.mega_chunks > 0 and cfg.engine.use_crown and mesh is None


# ---------------------------------------------------------------------------
# The run's runtime pieces: supervisor, failure records, progress ticks
# ---------------------------------------------------------------------------


def _supervisor(cfg: SweepConfig) -> Supervisor:
    """The run's launch supervisor, configured from the sweep's settings."""
    return Supervisor(max_retries=cfg.max_launch_retries, backoff_s=cfg.launch_backoff_s,
                      deadline_s=cfg.chunk_deadline_s, seed=cfg.seed)


def _unretried_failure(site: str, exc: BaseException) -> ChunkFailure:
    """Failure record of a fault caught outside the supervisor's retry loop
    (the sequential engine phases): a transient-class error is
    ``transient-exhausted`` at ``retries=0``."""
    kind = "transient-exhausted" if classify(exc) == "transient" else "fatal"
    return ChunkFailure(site=site, kind=kind, error=type(exc).__name__,
                        detail=str(exc), retries=0)


def _integrity_failure(site: str, detector: str) -> ChunkFailure:
    """Record one tripped integrity detector (``integrity_violations``
    counter and event) and return the failure that contains it: its
    partitions land in ``unknown:failure:integrity.<site>``, ``kind=fatal``
    (a corrupted payload is never retried in place; a resume re-runs the
    launch)."""
    obs.registry().counter("integrity_violations").inc(site=site)
    obs.event("integrity_violation", site=site, detector=detector)
    return ChunkFailure(site=f"integrity.{site}", kind="fatal",
                        error="IntegrityViolation",
                        detail=f"{detector} mismatch ({site})", retries=0)


def _segment_tick(phase: str, done: int, total: int, partitions: int,
                  in_flight: int = 0) -> None:
    """Segment-granular progress: a ``segment`` event and a throttled
    heartbeat line (a long launch's partitions are invisible to the host
    until it drains)."""
    from fairify_tpu_torch.obs import heartbeat as hb_mod

    obs.event("segment", phase=phase, done=done, total=total, partitions=partitions)
    hb = hb_mod.active()
    if hb is not None:
        hb.segment(phase, done, total, in_flight=in_flight)


# ---------------------------------------------------------------------------
# The SMT tier: out-of-process second opinions on the roots BaB left unknown
# ---------------------------------------------------------------------------


class _SmtTier:
    """The sweep's out-of-process SMT tier (the JAX package's ``_SmtTier``).

    Created after the BaB phase's last device sync: every still-unknown
    root's SMT-LIB query fans out across the worker pool at once, and the
    reporting loop takes each answer when it reaches that partition, so
    host solving overlaps the loop's own work; no solver thread runs beside
    a CUDA call of the sweep.  The queries are built from a host copy of
    the net (:func:`models.mlp.excise`).  A partition the heuristic retry
    decides meanwhile has its query cancelled, never awaited.
    """

    def __init__(self, net, enc, lo, hi, candidates, cfg, pool=None):
        from fairify_tpu_torch.smt import pool as pool_mod

        self._owns = pool is None
        if pool is None:
            pool = pool_mod.SmtPool(pool_mod.PoolConfig(
                workers=max(int(cfg.smt_workers), 1),
                memory_cap_mb=cfg.smt_memory_cap_mb,
                portfolio=cfg.smt_portfolio, seed=cfg.seed,
                # Worker deaths spend the same retry budget as any other
                # transient fault of the run.
                max_retries=cfg.max_launch_retries,
                backoff_s=cfg.launch_backoff_s))
        self.pool = pool
        host_net = excise(net)
        self._futures = {
            p: pool_mod.submit_box(pool, host_net, enc, lo[p], hi[p],
                                   soft_timeout_s=cfg.soft_timeout_s,
                                   retry_timeouts_s=cfg.smt_retry_timeouts_s)
            for p in candidates}

    def __contains__(self, p) -> bool:
        return p in self._futures

    def done(self, p) -> bool:
        """Non-blocking: is this partition's answer already in?"""
        fut = self._futures.get(p)
        return fut is None or fut.done()

    def result(self, p):
        """Blocking ``(verdict, ce, reason)`` of one partition, bounded by
        the pool's hard per-dispatch deadlines.  Anything that escapes the
        pool's own containment, short of a propagate-class error, is one
        more worker-crash UNKNOWN."""
        from concurrent.futures import CancelledError

        from fairify_tpu_torch.smt import protocol

        fut = self._futures.pop(p)
        try:
            v, ce, reason = fut.result().triple
        except CancelledError:
            return "unknown", None, protocol.REASON_SPAWN
        except BaseException as exc:
            if classify(exc) == "propagate":
                raise
            return "unknown", None, protocol.REASON_CRASH
        n = faults_mod.corruption("smt.query")
        if n is not None and v == "sat" and ce is not None:
            # Data-plane chaos (smt.query:corrupt): one bit flipped in the
            # witness crossing the pool boundary; the host replay catches it.
            ce = integrity_mod.corrupt_witness(ce, n)
        return v, ce, reason

    def cancel(self, p) -> None:
        fut = self._futures.pop(p, None)
        if fut is not None:
            fut.cancel()

    def close(self) -> None:
        for fut in self._futures.values():
            fut.cancel()
        self._futures.clear()
        if self._owns:
            self.pool.close()


@dataclass
class SmtDrain:
    """Deferred SMT finalization (``smt_defer``; the JAX package's
    ``SmtDrain``).

    The reporting loop never blocks on a pool future: a partition whose
    query is still in flight gets a provisional UNKNOWN outcome whose
    LEDGER row is withheld (a crash before the drain leaves it unledgered,
    so ``resume=True`` re-attempts it).  :meth:`drain` blocks on the
    remaining futures, replays SAT witnesses on the host net, appends the
    final ledger records and patches the report's outcomes in place.  The
    CSV keeps the provisional UNKNOWN rows, as in the JAX package.
    """

    tier: _SmtTier
    items: List  # (local index, pid, PartitionOutcome) still in flight
    report: "ModelReport"
    cfg: SweepConfig
    weights: List
    biases: List
    ledger_path: str
    model_name: str
    sink_name: str

    @property
    def pending(self) -> int:
        return len(self.items)

    def drain(self) -> Dict[str, int]:
        """Consume every deferred answer; returns decided/degraded counts."""
        decided = degraded = 0
        ledger = JournalWriter(self.ledger_path, fault_site="ledger.append",
                               crc=self.cfg.integrity)
        try:
            with obs.span("smt.drain", queries=len(self.items)):
                for p, pid, out in self.items:
                    v, ce, reason, failure = _smt_answer(self.tier, p, self.weights,
                                                         self.biases, self.cfg)
                    fail_rec, extra = None, {}
                    if failure is not None:
                        fail_rec = failure.to_record()
                        degraded += 1
                        self.report.degraded += 1
                        obs.registry().counter("chunks_degraded").inc(site=failure.site)
                        obs.event("degraded", **fail_rec, phase="smt_drain", partitions=1)
                    if v != "unknown":
                        out.verdict = v
                        out.counterexample = ce
                        decided += 1
                        via = "smt"
                    elif fail_rec is not None:
                        extra = {"failure": fail_rec["reason"]}
                        via = "degraded"
                    else:
                        via = "bab"
                        if reason is not None:
                            extra = {"smt_reason": reason}
                    # Last record wins downstream: this verdict event
                    # supersedes the loop's provisional one, and this append
                    # is the partition's first ledger row.
                    obs.event("verdict", model=self.model_name, partition_id=pid,
                              verdict=out.verdict, via=via, **extra)
                    rec = {"partition_id": pid, "verdict": out.verdict,
                           "ce": [out.counterexample[0].tolist(),
                                  out.counterexample[1].tolist()]
                           if out.counterexample else None,
                           "time_s": round(out.times.get("total", 0.0), 4)}
                    if fail_rec is not None:
                        rec["failure"] = fail_rec
                    ledger.append(rec)
                    if out.counterexample is not None:
                        # The reporting loop writes the counterexample CSV
                        # only for rows it ledgers itself.
                        _write_ce(os.path.join(self.cfg.result_dir,
                                               f"{self.sink_name}-counterexamples.csv"),
                                  self.cfg.query().columns, pid, out.counterexample)
        finally:
            ledger.close()
            self.tier.close()
            self.items = []
        return {"decided": decided, "degraded": degraded}


def _smt_answer(tier: _SmtTier, p: int, weights, biases, cfg: SweepConfig):
    """One root's SMT answer as ``(verdict, ce, reason, failure)``.
    ``failure`` is the ChunkFailure that degrades the root: a SAT witness
    that fails its host replay (an integrity violation: a sound backend
    never gives one; reason ``invalid-witness``), or a worker death that
    exhausted the pool's retries (reason ``smt.worker:<kind>``).  A
    degraded root is re-attempted by ``resume=True``."""
    v, ce, reason = tier.result(p)
    if v == "sat" and ce is not None and not engine.validate_pair(weights, biases, *ce):
        return "unknown", None, "invalid-witness", _integrity_failure("smt.query",
                                                                      "invalid-witness")
    if v == "unknown" and reason is not None and reason.startswith("smt.worker:"):
        return v, None, reason, ChunkFailure(
            site="smt.worker", kind=reason.split(":", 1)[1], error="WorkerDied",
            detail=reason, retries=cfg.max_launch_retries)
    return v, ce, reason, None


# ---------------------------------------------------------------------------
# Stage 0: certify + attack (KB + KC), per segment or per chunk, for one
# net or a stacked family
# ---------------------------------------------------------------------------


def _model_params(net) -> list:
    """Host ``(weights, biases)`` of each model (one for a single net)."""
    if isinstance(net, StackedMLP):
        return [net.numpy_params(m) for m in range(net.n_models)]
    return [net.numpy_params()]


def mega_chunk_inputs(enc: PairEncoding, lo, hi, cfg: SweepConfig, chunks,
                      step: int, seed_offset: int, canary: bool = False):
    """Stacked per-chunk stage-0 inputs of one segment (numpy).

    Each chunk is padded to ``step`` rows (last row repeated) and draws its
    attack candidates from ``default_rng(engine.seed + seed_offset +
    chunk_start)`` on the padded rows — exactly the JAX package's streams.
    ``canary`` appends the integrity layer's known-answer chunk: all-zero
    boxes, no valid assignment, ``nv = 0`` — it certifies vacuously and
    finds nothing, whatever the net.  Returns ``(x_lo, x_hi, xp_lo, xp_hi,
    plo, phi, valid, xr, pr, nv)`` with a leading chunk axis.
    """
    bufs = [[] for _ in range(9)]
    for s, e in chunks:
        clo, chi = grid_mod.pad_rows(lo[s:e], step), grid_mod.pad_rows(hi[s:e], step)
        flo, fhi = clo.astype(np.float32), chi.astype(np.float32)
        x_lo, x_hi, xp_lo, xp_hi, valid = role_boxes(enc, flo, fhi)
        rng = np.random.default_rng(cfg.engine.seed + seed_offset + s)
        xr, pr = engine.build_attack_candidates(enc, rng, clo, chi,
                                                cfg.engine.attack_samples)
        for buf, arr in zip(bufs, (x_lo, x_hi, xp_lo, xp_hi, flo, fhi,
                                   valid, xr, pr)):
            buf.append(arr)
    n_real = [e - s for s, e in chunks]
    if canary:
        for buf in bufs:
            buf.append(np.zeros_like(buf[0]))
        n_real.append(0)
    return tuple(np.stack(b) for b in bufs) + (np.asarray(n_real, np.int32),)


def mega_segment_submit(net, enc: PairEncoding, lo, hi, cfg: SweepConfig, chunks,
                        step: int, seed_offset: int):
    """Launch one segment's stage 0 on the net's device without a sync:
    ``(payload, ctx)`` for the launch pipeline.

    ``payload`` holds the launches' outputs, flat over chunks × rows —
    ``cert``, ``wit``, ``reason``, ``stats`` and, with integrity on, the
    device fold ``csum`` (a 0-d tensor); :func:`mega_segment_host` lays
    the fetched buffers out as the JAX package's mega kernel returns them.
    For a stacked family (``_mega_family_stage0_kernel``) one KB and one
    KC launch cover chunks × models × rows and the fold covers every
    model's buffers.
    """
    dev = net.device
    (x_lo, x_hi, xp_lo, xp_hi, plo, phi, valid, xr, pr,
     nv) = mega_chunk_inputs(enc, lo, hi, cfg, chunks, step, seed_offset,
                             canary=cfg.integrity)
    C, P = valid.shape[:2]
    av, pm, rm = engine.enc_tensors(enc, lo.shape[1])
    on = lambda a: stage(a, dev)
    flat = lambda a: on(a.reshape((C * P,) + a.shape[2:]))
    ok = (np.arange(P)[None, :] < nv[:, None]).reshape(-1)
    valid_t, vpair = flat(valid), on(enc.valid_pair)
    cert, _score, margin = engine.stage0_certify(
        net, flat(x_lo), flat(x_hi), flat(xp_lo), flat(xp_hi), flat(plo),
        flat(phi), on(av), on(pm), on(rm), float(enc.eps), valid_t, vpair)
    wit, reason, _gap, stats, fold = engine.attack_flips(
        net, flat(xr), flat(pr), valid_t, vpair, cert, margin, on(ok))
    payload = {"cert": cert, "wit": wit, "reason": reason, "stats": stats}
    if cfg.integrity:
        payload["csum"] = fold
    return payload, {"chunks": chunks, "xr": xr, "pr": pr, "C": C, "P": P,
                     "stacked": isinstance(net, StackedMLP)}


def mega_segment_host(raw, ctx) -> dict:
    """A fetched :func:`mega_segment_submit` payload in the JAX package's
    layout: ``cert (C, P) bool``, ``wit (C, P, 3) int32``, ``reason (C, P)
    int8``, ``stats (2, 14) int32`` (``(C, M, P)``, ``(C, M, P, 3)``,
    ``(C, M, P)``, ``(M, 2, 14)`` for a stacked family) and ``csum``, with
    C the real chunks plus the canary."""
    C, P, stacked = ctx["C"], ctx["P"], ctx["stacked"]

    def chunk_major(a):  # (M?, C*P, ...) -> (C, M?, P, ...)
        lead = a.shape[:1] if stacked else ()
        a = a.reshape(lead + (C, P) + a.shape[len(lead) + 1:])
        return np.moveaxis(a, 0, 1) if lead else a

    host = {k: chunk_major(raw[k]) for k in ("cert", "wit", "reason")}
    host["stats"] = raw["stats"]
    if "csum" in raw:
        host["csum"] = np.int32(raw["csum"])
    return host


def mega_segment(net, enc: PairEncoding, lo, hi, cfg: SweepConfig, chunks,
                 step: int, seed_offset: int):
    """One segment's stage 0, synchronously: ``(host, ctx)`` with ``host``
    as :func:`mega_segment_host` lays it out (tests, tooling)."""
    payload, ctx = mega_segment_submit(net, enc, lo, hi, cfg, chunks, step, seed_offset)
    return mega_segment_host(fetch(payload), ctx), ctx


def decode_flips(cert, found, wit, xr, pr, weights, biases):
    """``(unsat, sat, witnesses)`` of one chunk of one model: a flip counts
    as SAT only after its exact ``validate_pair`` replay on the model's own
    weights."""
    witnesses = engine.extract_witnesses(found, wit, xr, pr, weights,
                                         biases) if found.any() else {}
    sat = np.zeros(cert.shape[0], dtype=bool)
    sat[list(witnesses)] = True
    return cert, sat, witnesses


def mega_segment_decode(host, ctx, models):
    """Per chunk, per model ``(unsat, sat, witnesses)`` (flips are
    ``reason >= 2``); ``models`` the per-model host parameters
    (:func:`_model_params`).  Rows keep the padding; callers trim."""
    cert, wit, reason = host["cert"], host["wit"], host["reason"]
    if cert.ndim == 2:  # a single net: a model axis of one
        cert, wit, reason = cert[:, None], wit[:, None], reason[:, None]
    return [[decode_flips(cert[ci, m], reason[ci, m] >= 2, wit[ci, m], ctx["xr"][ci],
                          ctx["pr"][ci], *models[m]) for m in range(len(models))]
            for ci in range(len(ctx["chunks"]))]


def stage0_block_submit(net, enc: PairEncoding, lo, hi, cfg: SweepConfig, rng_seed: int,
                        pad_to: int, mesh=None, replicas=None):
    """Launch one grid chunk's stage 0 without a sync (``_stage0_block_submit``;
    ``_family_block_submit`` for a stacked family): ``(payload, ctx)``.
    The chunk is padded to ``pad_to`` rows BEFORE the attack candidates are
    drawn from ``default_rng(rng_seed)``.  The CROWN path (the fused
    branch) is one :func:`engine.certify_attack` (one KB + one KC launch;
    payload ``cert``, ``found``, ``wit``, ``margin``, ``gap``); the IBP
    path (``use_crown=False``) and, on either path, a ``mesh``
    (``replicas`` the net's copies on it) take
    :func:`engine.split_certify_attack_submit`: the certificate alone (row
    13, or with a mesh on the CROWN path row 14 / row 6) over the mesh's
    ``parts`` shards, then the attack forward (row 17) unsharded."""
    lo, hi = grid_mod.pad_rows(lo, pad_to), grid_mod.pad_rows(hi, pad_to)
    flo, fhi = lo.astype(np.float32), hi.astype(np.float32)
    x_lo, x_hi, xp_lo, xp_hi, valid = role_boxes(enc, flo, fhi)
    xr, pr = engine.build_attack_candidates(enc, np.random.default_rng(rng_seed),
                                            lo, hi, cfg.engine.attack_samples)
    ctx = {"enc": enc, "valid": valid, "xr": xr, "pr": pr,
           "stacked": isinstance(net, StackedMLP)}
    if mesh is not None or not cfg.engine.use_crown:
        ctx["kind"] = "split"
        return engine.split_certify_attack_submit(
            net, enc, x_lo, x_hi, xp_lo, xp_hi, flo, fhi, valid, xr, pr,
            cfg.engine.use_crown, mesh=mesh, replicas=replicas), ctx
    on = lambda a: stage(a, net.device)
    av, pm, rm = engine.enc_tensors(enc, lo.shape[1])
    cert, _score, found, wit, margin, gap = engine.certify_attack(
        net, on(x_lo), on(x_hi), on(xp_lo), on(xp_hi), on(flo), on(fhi), on(av), on(pm),
        on(rm), float(enc.eps), on(valid), on(enc.valid_pair), on(xr), on(pr),
        alpha_iters=0)
    ctx["kind"] = "fused"
    return {"cert": cert, "found": found, "wit": wit, "margin": margin, "gap": gap}, ctx


def stage0_block_decode(host, ctx, models) -> list:
    """Host decode of a fetched :func:`stage0_block_submit` payload: per
    model ``(unsat, sat, witnesses, margin, gap)``, chunk padding rows
    included; ``models`` the per-model host parameters."""
    xr, pr = ctx["xr"], ctx["pr"]
    if ctx["kind"] == "split":
        per_model = engine.split_certify_attack_decode(host, ctx["enc"], ctx["valid"],
                                                       ctx["stacked"])
        return [decode_flips(cert, found, wit, xr, pr, w, b) + (margin, gap)
                for (cert, margin, found, wit, gap), (w, b) in zip(per_model, models)]
    lift = (lambda a: a) if ctx["stacked"] else (lambda a: a[None])
    cert, found, wit, margin, gap = (lift(host[k])
                                     for k in ("cert", "found", "wit", "margin", "gap"))
    return [decode_flips(cert[m], found[m], wit[m], xr, pr, w, b) + (margin[m], gap[m])
            for m, (w, b) in enumerate(models)]


def stage0_block(net, enc: PairEncoding, lo, hi, cfg: SweepConfig, rng_seed: int,
                 pad_to: int, mesh=None, replicas=None):
    """One grid chunk's stage 0, synchronously (tests, tooling, the sampled
    recheck): :func:`stage0_block_submit`, a fetch, then
    :func:`stage0_block_decode`."""
    payload, ctx = stage0_block_submit(net, enc, lo, hi, cfg, rng_seed, pad_to,
                                       mesh=mesh, replicas=replicas)
    return stage0_block_decode(fetch(payload), ctx, _model_params(net))


def _stage0(stacks, enc: PairEncoding, lo, hi, cfg: SweepConfig, seed_offset: int,
            stats, mesh, pipe, on_failure, phase: str, drained_chunks: list):
    """Stage 0 of several nets or stacked families through one launch queue
    (``_stage0_certify_and_attack`` / ``stage0_families``): one pipeline
    entry per (net, segment) on the mega path, per (net, chunk) on the
    chunk loop.  ``on_failure(s, e, failure)`` receives a degraded entry's
    rows (single-model callers); without it the degradation is counted
    (``chunks_degraded``) and logged (``degraded``) and the rows stay
    undecided.  ``drained_chunks`` receives the chunks that drained clean
    (the sampled recheck's candidates)."""
    mesh_mod.require_mesh(mesh)
    P = lo.shape[0]
    if pipe is None:
        pipe = LaunchPipeline(cfg.pipeline_depth, supervisor=_supervisor(cfg))
    n_models = [net.n_models if isinstance(net, StackedMLP) else 1 for net in stacks]
    accs = [[(np.zeros(P, bool), np.zeros(P, bool), {}) for _ in range(M)]
            for M in n_models]
    models = [_model_params(net) for net in stacks]
    bank = lambda gi, m: (stats.setdefault((gi, m), funnel_mod.StageStats())
                          if stats is not None else funnel_mod.StageStats())

    def store(gi, m, s, e, u, sa, w):
        unsat, sat, wits = accs[gi][m]
        unsat[s:e], sat[s:e] = u[: e - s], sa[: e - s]
        wits.update({s + k: v for k, v in w.items() if k < e - s})

    def degrade(s, e, failure):
        if on_failure is not None:
            on_failure(s, e, failure)
        else:
            obs.registry().counter("chunks_degraded").inc(site=failure.site)
            obs.event("degraded", **failure.to_record(), phase=phase, partitions=e - s)

    if use_mega(cfg, mesh):
        step, segs = grid_mod.segment_spans(P, cfg.grid_chunk, cfg.mega_chunks)
        total = len(segs) * len(stacks)
        done = {"n": 0}

        def consume_seg(meta, ctx, raw):
            gi, seg_s, seg_e, chunks = meta
            done["n"] += 1
            drained = 0
            host = raw
            if not isinstance(raw, ChunkFailure):
                host = mega_segment_host(raw, ctx)
                if cfg.integrity:
                    # Verify before decoding: a corrupted buffer must never
                    # reach witness extraction or the verdict arrays.
                    tripped = integrity_mod.verify_segment(host)
                    if tripped is not None:
                        host = _integrity_failure("launch.decode", tripped)
            if isinstance(host, ChunkFailure):
                degrade(seg_s, seg_e, host)
            else:
                drained = seg_e - seg_s
                seg_stats = host["stats"].reshape((-1,) + host["stats"].shape[-2:])
                for m in range(n_models[gi]):
                    bank(gi, m).add_packed(seg_stats[m])
                for (s, e), per_model in zip(chunks, mega_segment_decode(host, ctx,
                                                                         models[gi])):
                    for m, (u, sa, w) in enumerate(per_model):
                        store(gi, m, s, e, u, sa, w)
                drained_chunks.extend(chunks)
            _segment_tick(phase, done["n"], total, drained, in_flight=len(pipe))

        for gi, net in enumerate(stacks):
            for si, (seg_s, seg_e, chunks) in enumerate(segs):
                for item in pipe.submit(
                        lambda net=net, chunks=chunks, si=si: profiling.annotate_step(
                            phase, si, lambda: mega_segment_submit(
                                net, enc, lo, hi, cfg, chunks, step, seed_offset)),
                        meta=(gi, seg_s, seg_e, chunks)):
                    consume_seg(*item)
        for item in pipe.drain():
            consume_seg(*item)
        return accs

    step, spans = grid_mod.chunk_spans(P, cfg.grid_chunk)
    reps = [None if mesh is None else mesh_mod.replicated(mesh, net) for net in stacks]

    def consume(meta, ctx, host):
        gi, s, e = meta
        if isinstance(host, ChunkFailure):
            degrade(s, e, host)
            return
        banked = not isinstance(stacks[gi], StackedMLP) or (cfg.engine.use_crown
                                                            and mesh is None)
        for m, (u, sa, w, margin, gap) in enumerate(stage0_block_decode(host, ctx,
                                                                        models[gi])):
            if banked:
                bank(gi, m).add_values(margin[: e - s], gap[: e - s])
            store(gi, m, s, e, u, sa, w)
        drained_chunks.append((s, e))

    for gi, net in enumerate(stacks):
        for ci, (s, e) in enumerate(spans):
            for item in pipe.submit(
                    lambda gi=gi, net=net, s=s, e=e, ci=ci: profiling.annotate_step(
                        phase, ci, lambda: stage0_block_submit(
                            net, enc, lo[s:e], hi[s:e], cfg,
                            cfg.engine.seed + seed_offset + s, step, mesh=mesh,
                            replicas=reps[gi])),
                    meta=(gi, s, e)):
                consume(*item)
    for item in pipe.drain():
        consume(*item)
    return accs


def stage0_families(stacks, enc: PairEncoding, lo, hi, cfg: SweepConfig,
                    seed_offset: int = 0, stats=None, mesh=None, pipe=None):
    """Stage 0 of several stacked families (``stage0_families``): one
    result list per entry of ``stacks``, each holding per model ``(unsat
    (P,), sat (P,), witnesses {p: (x, x')})``.

    Every (family, segment) — (family, chunk) on the chunk loop — is one
    entry of one launch pipeline (``pipe``, or one at
    ``cfg.pipeline_depth`` with the run's supervisor), so one family's host
    decode overlaps the next launch.  ``mega_chunks > 0``: one KB + one KC
    launch per (family, segment) over chunks × models × rows; with
    integrity on, a tripped fold or canary check, like a degraded launch,
    leaves that (family, segment) undecided (counted in
    ``chunks_degraded``, logged as a ``degraded`` event).  ``mega_chunks =
    0`` or a ``mesh`` (``parallel.mesh.Mesh``: the family is replicated over
    it and each chunk's certificate sharded): one
    :func:`stage0_block_submit` per (family, chunk).  Every model attacks
    the same candidates, drawn once per chunk from
    ``default_rng(engine.seed + seed_offset + chunk_start)``, and each
    model's witnesses replay on its own weights.  ``stats`` (a dict)
    receives one ``StageStats`` per ``(family index, model index)``: the
    kernel's histograms on the mega path, host-binned margins and gaps on
    the chunk path — equal bit for bit.  The IBP path (``use_crown=False``)
    and a mesh always take the chunk loop (:func:`use_mega`) and, like the
    JAX package's IBP and mesh family branches, bank no statistics for a
    stacked family (a single net's chunks bank theirs).  A single
    (unstacked) net in ``stacks`` counts as one model.
    """
    return _stage0(stacks, enc, lo, hi, cfg, seed_offset, stats, mesh, pipe, None,
                   "stage0_family", [])


def stage0_family(stacked, enc: PairEncoding, lo, hi, cfg: SweepConfig,
                  seed_offset: int = 0, stats=None):
    """Stage 0 of one stacked family (``_stage0_family``): per model
    ``(unsat, sat, witnesses)``; ``stats`` as in :func:`stage0_families`
    (keys ``(0, m)``)."""
    return stage0_families([stacked], enc, lo, hi, cfg, seed_offset=seed_offset,
                           stats=stats)[0]


def stage0_certify_and_attack(net, enc: PairEncoding, lo, hi, cfg: SweepConfig,
                              stats, failed=None, seed_offset: int = 0, mesh=None,
                              pipe=None, on_failure=None):
    """Root certificates + attack for the whole grid of one net
    (``_stage0_certify_and_attack``): one KB + KC pair per segment (the
    mega path, :func:`use_mega`) or per grid chunk (the chunk loop), or on
    the IBP path one row-13 + row-17 pair per grid chunk; with a ``mesh``,
    per grid chunk one row-14 (row-13) launch per shard and one row-17
    launch — each one entry of the launch pipeline ``pipe`` (or one at
    ``cfg.pipeline_depth`` with the run's supervisor).

    Returns ``(unsat (P,), sat (P,), witnesses {p: (x, x')})``; ``stats``
    (an ``obs.funnel.StageStats``) accumulates the margin and gap
    histograms.  A degraded entry — retries exhausted, a fatal error, a
    tripped fold or canary check — calls ``on_failure(s, e, failure)``, or
    records the failure record of each of its rows in the dict ``failed``.
    ``seed_offset`` (a partition span's start) offsets the attack streams,
    as in the JAX package.  With ``integrity`` on and ``integrity_recheck >
    0`` a sampled share of the chunks that drained clean is rechecked
    (:func:`_sampled_recheck`).
    """
    if on_failure is None and failed is not None:
        on_failure = lambda s, e, f: failed.update({i: f.to_record() for i in range(s, e)})
    fam_stats: dict = {}
    drained: list = []
    unsat, sat, wits = _stage0([net], enc, lo, hi, cfg, seed_offset, fam_stats, mesh,
                               pipe, on_failure, "stage0_decide", drained)[0][0]
    if (0, 0) in fam_stats:
        stats.merge(fam_stats[(0, 0)])
    if cfg.integrity and cfg.integrity_recheck > 0.0 and drained:
        with obs.span("integrity.recheck", chunks=len(drained), rate=cfg.integrity_recheck):
            _sampled_recheck(net, enc, lo, hi, cfg, mesh, seed_offset, drained, unsat,
                             sat, wits, on_failure)
    return unsat, sat, wits


def _sampled_recheck(net, enc, lo, hi, cfg: SweepConfig, mesh, seed_offset, drained,
                     unsat, sat, witnesses, on_failure):
    """Re-run a deterministic sample of decided chunks; require bit-equality.

    Each selected chunk (``integrity.sampled`` keyed on ``(seed, global
    chunk start)``, so a resume rechecks the same chunks) is re-executed
    through the per-chunk path (:func:`stage0_block`, bit-equal to the mega
    decode) and its ``(unsat, sat, witnesses)`` must match the banked one
    exactly; a mismatch demotes the chunk to
    ``unknown:failure:integrity.recheck``.  Each clean recheck escalates
    the chunk's first certified partition to the exact-rational oracle
    (``verify/exact_check.py``); a refuted certificate demotes just that
    partition, an inconclusive one (``budget``) demotes nothing.
    """
    from fairify_tpu_torch.verify import exact_check

    rechecks = obs.registry().counter("integrity_rechecks")
    step, _spans = grid_mod.chunk_spans(lo.shape[0], cfg.grid_chunk)
    reps = None if mesh is None else mesh_mod.replicated(mesh, net)
    weights = biases = None
    for s, e in drained:
        if not integrity_mod.sampled(cfg.seed, f"chunk:{seed_offset + s}",
                                     cfg.integrity_recheck):
            continue
        rechecks.inc(kind="chunk")
        ((u2, s2, w2, _m, _g),) = stage0_block(net, enc, lo[s:e], hi[s:e], cfg,
                                               cfg.engine.seed + seed_offset + s, step,
                                               mesh=mesh, replicas=reps)
        n = e - s
        w2 = {k: v for k, v in w2.items() if k < n}
        have = {k - s: v for k, v in witnesses.items() if s <= k < e}
        clean = (np.array_equal(u2[:n], unsat[s:e]) and np.array_equal(s2[:n], sat[s:e])
                 and set(w2) == set(have)
                 and all(np.array_equal(w2[k][0], have[k][0])
                         and np.array_equal(w2[k][1], have[k][1]) for k in w2))
        if not clean:
            unsat[s:e] = False
            sat[s:e] = False
            for k in range(s, e):
                witnesses.pop(k, None)
            if on_failure is not None:
                on_failure(s, e, _integrity_failure("recheck", "bit-equality"))
            continue
        cert_idx = np.flatnonzero(unsat[s:e])
        if not cert_idx.size:
            continue
        if weights is None:
            weights, biases = net.numpy_params()
        p = s + int(cert_idx[0])
        rechecks.inc(kind="exact")
        res = exact_check.decide_pair_box_exact(weights, biases, enc, lo[p], hi[p],
                                                max_nodes=2000)
        if res["verdict"] == "refuted":
            unsat[p] = False
            if on_failure is not None:
                on_failure(p, p + 1, _integrity_failure("exact", "refuted-certificate"))


# ---------------------------------------------------------------------------
# Parity pass (KD)
# ---------------------------------------------------------------------------


def parity_plain(net, keys, lo, hi, alive, sim_size: int):
    """Plain PyTorch version of KD: per partition, the fraction of its
    ``sim_size`` samples on which the original and the masked net (hidden
    layers masked by ``alive``, a list of (N, n_l) tensors) predict alike."""
    out = []
    for s in range(0, lo.shape[0], PLAIN_ROWS):
        e = min(s + PLAIN_ROWS, lo.shape[0])
        sim = simulate_boxes(keys[s:e], lo[s:e], hi[s:e], sim_size)
        orig = net(sim) > 0.0
        masked_net = net.with_masks([a[s:e, None, :] for a in alive]
                                    + [net.masks[-1]])
        masked = masked_net(sim) > 0.0
        agree = (orig == masked).to(torch.float32).sum(dim=1)
        out.append(agree * mean_scale(sim_size, agree.device))
    return torch.cat(out)


def parity(net, keys, lo, hi, alive, sim_size: int, live=None):
    """KD: pruned-vs-original parity of N partitions, one launch.  ``live``
    (default N): rows ``>= live`` get row ``live - 1``'s parity
    (``engine.fill_past``).  CPU tensors take :func:`parity_plain` on every
    row and the same fill; CUDA tensors launch ``csrc/parity.cu`` over the
    live rows (the geometry from :func:`pruning.sim_geometry`)."""
    N = lo.shape[0]
    live = engine.live_rows("parity", N, live)
    if lo.device.type == "cpu":
        return engine.fill_past(parity_plain(net, keys, lo, hi, alive, sim_size), live)
    al = (torch.cat([a.to(torch.float32) for a in alive], dim=1)
          if alive else torch.zeros((N, 0), dtype=torch.float32, device=lo.device))
    with launches.launching("parity", (N, live, sim_size)):
        out = pruning._sim_launch(net, keys, lo, hi, sim_size, live, "kd", alive=al)
    return out


def parity_resim(weights, biases, dead, seed: int, index: int, lo_p, hi_p, sim_size: int,
                 device="cpu") -> float:
    """Pruned-vs-original parity of ONE partition (global ``index``) whose
    masks changed after the parity pass (the heuristic retry): its
    ``sim_size`` samples of key ``grid_keys(seed, index)`` through two
    host f64 forwards.  On a CUDA ``device`` the samples come from one K12
    launch (:func:`verify.pruning.sim_rows_host`: key derived on the card,
    box by value, one copy to pinned host memory, one sync); on the CPU
    from its plain version (:func:`verify.pruning.sim_rows`)."""
    lo_p, hi_p = (np.asarray(a, np.float32)[None] for a in (lo_p, hi_p))
    if torch.device(device).type == "cpu":
        sim = pruning.sim_rows(seed, index, lo_p, hi_p, sim_size)[0].numpy()
    else:
        sim = pruning.sim_rows_host(prng.key_words(seed), index, lo_p, hi_p, sim_size,
                                    device)[0].numpy()
    return float((predict_np(weights, biases, sim)
                  == predict_np(weights, biases, sim, dead=dead)).mean())


def parity_submit(net, prune, lo, hi, cfg: SweepConfig, s: int, e: int, rows: int,
                  index_offset: int = 0):
    """Launch KD over grid rows ``[s, e)`` padded to ``rows`` rows (alive
    masks padded like the boxes) without a sync: the (rows,) parity
    tensor."""
    dev = net.device
    pad = lambda a: grid_mod.pad_rows(np.asarray(a[s:e], np.float32), rows)
    keys = grid_keys(cfg.seed, index_offset + s, rows, device=dev)
    alive = [stage(pad(1.0 - d), dev) for d in prune.st_deads[:-1]]
    return parity(net, keys, stage(pad(lo), dev), stage(pad(hi), dev), alive, cfg.sim_size,
                  live=e - s)


def parity_pass(net, prune, lo, hi, cfg: SweepConfig, index_offset: int = 0,
                mesh=None, pipe=None, on_failure=None):
    """The grid's parity column (keys of the global partition index: row
    plus ``index_offset``): one KD launch per segment, or off the mega
    path (:func:`use_mega`; always with a ``mesh``, whose parity the JAX
    package also runs unsharded) one per grid chunk padded to the chunk
    size (``_parity_grid_from_keys``, row 10), alive masks padded like the
    boxes, launched over the chunk's real rows (``live``).  Each launch is
    one entry of ``pipe`` (or of a pipeline at ``cfg.pipeline_depth`` with
    the run's supervisor); a degraded one calls ``on_failure(s, e,
    failure)`` and leaves its rows' parity 0."""
    P = lo.shape[0]
    out = np.zeros(P, dtype=np.float32)
    if pipe is None:
        pipe = LaunchPipeline(cfg.pipeline_depth, supervisor=_supervisor(cfg))
    if use_mega(cfg, mesh):
        _, segs = grid_mod.segment_spans(P, cfg.grid_chunk, cfg.mega_chunks)
        pad, blocks = 0, [(s, e) for s, e, _chunks in segs]
    else:
        pad, blocks = grid_mod.chunk_spans(P, cfg.grid_chunk)

    submit = lambda s, e: (parity_submit(net, prune, lo, hi, cfg, s, e, max(pad, e - s),
                                         index_offset), None)

    def consume(meta, _ctx, host):
        s, e = meta
        if isinstance(host, ChunkFailure):
            if on_failure is not None:
                on_failure(s, e, host)
            return
        out[s:e] = host[: e - s]

    for s, e in blocks:
        for item in pipe.submit(lambda s=s, e=e: submit(s, e), meta=(s, e)):
            consume(*item)
    for item in pipe.drain():
        consume(*item)
    return out


# ---------------------------------------------------------------------------
# Ledger, resume and the reporting loop
# ---------------------------------------------------------------------------


def ledger_path(cfg: SweepConfig, model_name: str) -> str:
    return os.path.join(cfg.result_dir, f"{cfg.name}-{model_name}.ledger.jsonl")


def read_ledger(path: str):
    """Records of one ledger and the torn-line count.  Rows whose ``_crc``
    does not match are dropped and counted (``ledger_crc_mismatch``), so a
    resume re-decides them."""
    if not os.path.isfile(path):
        return [], 0
    recs, skipped = [], 0
    with open(path) as fp:
        for line in fp:
            if not line.strip():
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                skipped += 1
    recs, bad = integrity_mod.verify_records(recs)
    if bad:
        obs.registry().counter("ledger_crc_mismatch").inc(bad)
        obs.event("ledger_crc_mismatch", path=path, rows=bad)
    return recs, skipped


def merge_ledgers(paths) -> tuple:
    """Decided-wins merge: ``(done, degraded, skipped_lines)`` as in the JAX
    package — decided verdicts stay settled, failure records are retried."""
    done: Dict[int, dict] = {}
    degraded: Dict[int, dict] = {}
    skipped = 0
    for path in paths:
        recs, sk = read_ledger(path)
        skipped += sk
        for rec in recs:
            pid = rec["partition_id"]
            prev = done.get(pid)
            if rec["verdict"] != "unknown":
                done[pid] = rec
                degraded.pop(pid, None)
            elif prev is not None and prev["verdict"] != "unknown":
                continue
            elif rec.get("failure"):
                degraded[pid] = rec
                done.pop(pid, None)
            else:
                done[pid] = rec
                degraded.pop(pid, None)
    return done, degraded, skipped


def c_check_np(weights, biases, dead, ce) -> tuple:
    """C-check / V-accurate replay of a counterexample pair (host, f64)."""
    pts = np.stack(ce)
    orig_cls = predict_np(weights, biases, pts)
    pruned_cls = predict_np(weights, biases, pts, dead=dead)
    return int((pruned_cls == orig_cls).all()), int(orig_cls[0] != orig_cls[1])


def _write_ce(path: str, columns, pid: int, ce) -> None:
    new_file = not os.path.isfile(path)
    with open(path, "a", newline="") as fp:
        wr = csv.writer(fp)
        if new_file:
            wr.writerow(["partition_id", "role"] + list(columns))
        wr.writerow([pid, "x"] + [int(v) for v in ce[0]])
        wr.writerow([pid, "x'"] + [int(v) for v in ce[1]])


def stage0_pgd(net, enc: PairEncoding, lo, hi, cfg: SweepConfig, pending,
               span_start: int, budget_left, pipe=None, on_failure=None):
    """The deep PGD attack over the stage-0 leftovers ``pending`` (grid row
    indices), one K5 launch per ``grid_chunk`` of them (each one entry of
    ``pipe``, or of a pipeline at ``cfg.pipeline_depth`` with the run's
    supervisor: chunk N+1's launch is in flight while chunk N's witnesses
    are replayed and its slabs searched), then the exact flip-slab search
    from each box's near-zero PGD point, the box midpoint and six seeded
    lattice points — within a quarter of the remaining hard budget
    (``budget_left()`` seconds).  A degraded chunk calls
    ``on_failure(rows, failure)``.  Returns ``(witnesses {row: (x, x')},
    covered_all)``: ``covered_all`` False when the hard budget cut the
    launch loop, so the engine must not skip its own Phase A.
    """
    weights, biases = net.numpy_params()
    if pipe is None:
        pipe = LaunchPipeline(cfg.pipeline_depth, supervisor=_supervisor(cfg))
    pgd_wit: Dict[int, tuple] = {}
    slab_budget = 0.25 * max(budget_left(), 0.0)
    slab_spent = 0.0
    covered_all = True
    step = min(cfg.grid_chunk, len(pending)) if cfg.grid_chunk > 0 else len(pending)

    def consume(meta, ctx, host):
        nonlocal slab_spent
        s, blk = meta
        if isinstance(host, ChunkFailure):
            if on_failure is not None:
                on_failure(blk, host)
            return
        w, near_zero, near_abs = engine.pgd_attack_decode(host, ctx, weights, biases,
                                                          return_points=True)
        pgd_wit.update({blk[k]: v for k, v in w.items()})
        seed_rng = np.random.default_rng(cfg.engine.seed + 77 + span_start + s)
        for k, p_g in enumerate(blk):
            if slab_spent > slab_budget:
                break
            if p_g in pgd_wit or near_abs[k] > 50.0:
                continue
            seeds = [near_zero[k], (lo[p_g] + hi[p_g]) / 2.0]
            seeds += [seed_rng.integers(lo[p_g], hi[p_g] + 1) for _ in range(6)]
            t_slab = time.perf_counter()
            for seed_pt in seeds:
                ce = engine.slab_search(weights, biases, enc, lo[p_g], hi[p_g], seed_pt)
                if ce is not None:
                    pgd_wit[p_g] = ce
                    break
            slab_spent += time.perf_counter() - t_slab

    for s in range(0, len(pending), step):
        if budget_left() < 0.0:
            # Chunks already in flight drain below: they were attacked.
            covered_all = False
            break
        blk = pending[s:s + step]
        for item in pipe.submit(
                lambda s=s, blk=blk: engine.pgd_attack_submit(
                    net, enc, lo[blk], hi[blk],
                    np.random.default_rng(cfg.engine.seed + 1 + span_start + s),
                    steps=cfg.engine.pgd_steps, restarts=cfg.engine.pgd_restarts),
                meta=(s, blk)):
            consume(*item)
    for item in pipe.drain():
        consume(*item)
    return pgd_wit, covered_all


def verify_model(net, cfg: SweepConfig, model_name: str = "model",
                 dataset: Optional[loaders.LoadedDataset] = None, mesh=None,
                 resume: bool = True, retry_unknown: bool = False, stage0=None,
                 partition_span=None, host_index=None, host_count=None, sink_name=None,
                 smt_pool=None, smt_defer: bool = False, device=None) -> ModelReport:
    """Run the sweep for one model; write CSV + ledger rows.

    The JAX package's parameters, in its order, then the port's ``device``.
    ``device`` defaults to ``cuda`` (``device="cpu"`` runs the plain PyTorch
    versions of the kernels); the net is moved there.  ``dataset`` (a
    ``data.loaders.LoadedDataset``) adds the original accuracy on its test
    split (an f32 forward on ``device``) and, with ``cfg.partition_metrics``
    and a protected attribute, the per-partition group-metrics CSV
    ``<sink>-metrics.csv``.  ``mesh`` (a ``parallel.mesh.Mesh``; anything
    else raises ``TypeError``) shards stage 0's certificates and the
    engine's BaB batches over its ``parts`` axis and runs the rest on its
    first device, which ``device`` must name if given (``ValueError``
    otherwise); the throughput record's ``partitions_per_sec_per_chip`` is
    divided by the mesh's size, as in the JAX package.  ``retry_unknown``
    re-attempts the ledger's budget UNKNOWNs (decided rows stay settled)
    and then rewrites the CSV and the metrics CSV to one row per
    partition.  ``stage0``: this model's precomputed stage-0 result from
    :func:`stage0_families` — ``(unsat, sat, witnesses)`` or, with the
    family's ``StageStats`` forwarded, ``(unsat, sat, witnesses,
    stats)`` — over the same grid rows; stage 0's own launches are then
    skipped and the forwarded histograms merged.  ``partition_span``
    ``(start, stop)`` runs a contiguous slice of the shuffled grid, with
    global partition ids and keys, and sinks named ``model@start-stop``;
    ``host_index``/``host_count`` take that slice from
    :func:`parallel.multihost.host_slice`.  ``sink_name`` overrides the
    sink base name.  ``smt_pool`` shares an existing
    :class:`fairify_tpu_torch.smt.SmtPool` with the SMT tier (None: the
    run owns a pool of ``cfg.smt_workers`` when the tier has candidates);
    ``smt_defer`` returns the answers still in flight on
    ``report.smt_pending`` (an :class:`SmtDrain`) instead of waiting.

    ``cfg.trace_out`` traces the call (unless an outer scope owns a
    tracer): a ``verify_model`` span carrying the final counts, a span per
    phase, ``verdict`` and ``degraded`` events; ``cfg.inject_faults`` is
    armed for the call (seeded by ``cfg.seed``).
    """
    from fairify_tpu_torch.obs import heartbeat as hb_mod

    check_supported(cfg, mesh)
    with obs.maybe_tracing(cfg.trace_out, run_id=f"{cfg.name}-{model_name}"):
        with obs.span("verify_model", model=model_name, dataset=cfg.dataset,
                      preset=cfg.name) as sp, \
                faults_mod.armed(cfg.inject_faults, seed=cfg.seed):
            try:
                rep = _verify_model_impl(
                    net, cfg, model_name, dataset, mesh, resume, retry_unknown, stage0,
                    partition_span, host_index, host_count, sink_name, smt_pool,
                    smt_defer, device)
            except BaseException:
                # The impl registers this run's heartbeat as the live one;
                # a raise would otherwise leak it.
                hb = hb_mod.active()
                if hb is not None:
                    hb.close()
                raise
            sp.set(partitions=rep.partitions_total, **rep.counts)
            if rep.degraded:
                sp.set(degraded=rep.degraded)
            return rep


def _verify_model_impl(net, cfg: SweepConfig, model_name: str, dataset, mesh,
                       resume: bool, retry_unknown: bool, stage0, partition_span,
                       host_index, host_count, sink_override, smt_pool, smt_defer: bool,
                       device) -> ModelReport:
    if mesh is not None and device is None:
        device = mesh.home
    dev = resolve_device(device)
    if mesh is not None and mesh_mod.canonical_device(dev) != mesh.home:
        raise ValueError(f"verify_model: device {dev} is not the mesh's first "
                         f"device {mesh.home}")
    net = net.to(dev)
    timer = PhaseTimer()
    launches0 = launches.snapshot()
    counters0 = {name: obs.registry().counter(name).total() for name in RUN_COUNTERS}
    enc = encode(cfg.query())
    p_list, lo, hi = build_partitions(cfg)
    span_start, sink_name = 0, model_name
    if host_count is not None and partition_span is None:
        from fairify_tpu_torch.parallel.multihost import host_slice

        partition_span = host_slice(len(p_list), host_index, host_count)
    if partition_span is not None:
        span_start, span_stop = partition_span
        p_list = p_list[span_start:span_stop]
        lo, hi = lo[span_start:span_stop], hi[span_start:span_stop]
        sink_name = f"{model_name}@{span_start}-{span_stop}"
    if sink_override is not None:
        sink_name = sink_override
    P = len(p_list)
    if P == 0:  # e.g. more hosts than partitions: an empty but valid span
        return ModelReport(model=model_name, dataset=cfg.dataset, outcomes=[],
                           partitions_total=0, sink_name=sink_name)
    os.makedirs(cfg.result_dir, exist_ok=True)
    led_path = ledger_path(cfg, sink_name)
    done, led_skipped = {}, 0
    if resume:
        done, _degraded_prev, led_skipped = merge_ledgers([led_path])
    if retry_unknown:
        # Re-attempt the budget UNKNOWNs; decided verdicts stay settled.  The
        # re-decided rows are appended, and the decided-wins merge makes
        # the retry the record of truth on the next resume.
        done = {pid: rec for pid, rec in done.items() if rec["verdict"] != "unknown"}
    csv_path = os.path.join(cfg.result_dir, f"{sink_name}.csv")
    ce_path = os.path.join(cfg.result_dir, f"{sink_name}-counterexamples.csv")
    counter = profiling.ThroughputCounter(n_devices=1 if mesh is None else mesh.size)
    stage_stats = funnel_mod.StageStats()
    funnel = funnel_mod.FunnelCounts()
    heartbeat = (obs.Heartbeat(cfg.heartbeat_s, total=P, label=sink_name)
                 if cfg.heartbeat_s > 0 else None)
    # One launch pipeline and one supervisor for the run: stage 0, the
    # parity pass and stage0_pgd share them, so the pipeline's FlightStats
    # are the run's overlap record.  Exhaustion degrades exactly the
    # affected chunk's partitions (``failed``, ledgered below).
    sup = _supervisor(cfg)
    pipe = LaunchPipeline(cfg.pipeline_depth, supervisor=sup)
    failed: Dict[int, dict] = {}  # local partition index -> failure record

    def _degrade(idxs, failure: ChunkFailure, phase: str) -> None:
        rec = failure.to_record()
        n_new = 0
        for i in idxs:
            if 0 <= i < P and i not in failed:
                failed[i] = rec
                n_new += 1
        if n_new:  # a chunk already degraded in an earlier phase counts once
            obs.registry().counter("chunks_degraded").inc(site=failure.site)
            obs.event("degraded", **rec, phase=phase, partitions=n_new)

    if dev.type == "cuda":
        # The kernels build (or load) under the run's supervisor: the
        # ``compile`` site retries with the run's budget, and a build that
        # cannot finish fails the run.
        cuda_build.build_all(sup)
    weights, biases = net.numpy_params()
    with profiling.xla_trace(cfg.profile_dir):
        with obs.timed_span(timer, "stage0_prune", partitions=P):
            try:
                prune = sup.run(lambda: pruning.sound_prune_grid(
                    net, lo, hi, cfg.sim_size, cfg.seed, chunk=cfg.grid_chunk,
                    mega_chunks=cfg.mega_chunks if use_mega(cfg, mesh) else 0,
                    index_offset=span_start, exact_certify=cfg.exact_certify_masks),
                    site="prune")
            except ChunkDegraded as exc:
                # The masks feed only the CSV's mask columns, the parity
                # column and the heuristic retry: no verdict depends on them.
                prune = None
                obs.registry().counter("chunks_degraded").inc(site=exc.failure.site)
                obs.event("degraded", **exc.failure.to_record(), phase="stage0_prune",
                          partitions=0)
        if prune is not None and cfg.exact_certify_masks:
            timer.phases["prune_exact_certify"] = prune.sv_time_s
        with obs.timed_span(timer, "stage0_decide", partitions=P) as sp0:
            if stage0 is not None:  # precomputed by the stacked family kernels
                unsat0, sat0, witnesses = stage0[:3]
                if len(stage0) == 4:  # the family path forwarded its StageStats
                    stage_stats.merge(stage0[3])
                witnesses = dict(witnesses)
                sp0.set(precomputed=True)
            else:
                unsat0, sat0, witnesses = stage0_certify_and_attack(
                    net, enc, lo, hi, cfg, stats=stage_stats, seed_offset=span_start,
                    mesh=mesh, pipe=pipe,
                    on_failure=lambda s, e, f: _degrade(range(s, e), f, "stage0_decide"))
            unsat0, sat0 = np.array(unsat0, dtype=bool), np.array(sat0, dtype=bool)
            sp0.set(unsat=int(unsat0.sum()), sat=int(sat0.sum()))
        with obs.timed_span(timer, "stage0_parity"):
            if prune is not None:
                # A lost parity launch loses only the pruned_acc column:
                # partitions stage 0 decided keep their verdicts, the
                # undecided ones degrade (their path shares the sick device).
                parity_col = parity_pass(
                    net, prune, lo, hi, cfg, index_offset=span_start, mesh=mesh, pipe=pipe,
                    on_failure=lambda s, e, f: _degrade(
                        [i for i in range(s, e) if not sat0[i] and not unsat0[i]], f,
                        "stage0_parity"))
            else:
                parity_col = np.zeros(P, dtype=np.float32)

        # The refinement tail: every stage-0 leftover goes through the deep
        # PGD attack + slab search, then the engine's BaB.
        pending = [p for p in range(P) if (span_start + p + 1) not in done
                   and not sat0[p] and not unsat0[p] and p not in failed]
        pgd_covered_all = False
        if pending:
            with obs.timed_span(timer, "stage0_pgd", pending=len(pending)):
                pgd_wit, pgd_covered_all = stage0_pgd(
                    net, enc, lo, hi, cfg, pending, span_start,
                    lambda: cfg.hard_timeout_s - timer.total(), pipe=pipe,
                    on_failure=lambda blk, f: _degrade(blk, f, "stage0_pgd"))
            for p, ce in pgd_wit.items():
                sat0[p] = True
                witnesses[p] = ce
            pending = [p for p in pending if not sat0[p] and p not in failed]
        stage0_per_part = sum(timer.get(k) for k in (
            "stage0_prune", "stage0_decide", "stage0_parity", "stage0_pgd")) / max(P, 1)
        bab: Dict[int, engine.Decision] = {}
        engine_decided: Dict[str, int] = {}
        if pending:
            hard_left = max(cfg.hard_timeout_s - timer.total(), 1.0)
            deadline = min(cfg.soft_timeout_s * len(pending), hard_left)
            with obs.timed_span(timer, "bab", roots=len(pending),
                                deadline_s=round(deadline, 3)):
                try:
                    decisions = engine.decide_many(
                        net, enc, lo[pending], hi[pending],
                        replace(cfg.engine, pipeline_depth=cfg.pipeline_depth,
                                max_launch_retries=cfg.max_launch_retries,
                                launch_backoff_s=cfg.launch_backoff_s,
                                device_bab=cfg.device_bab and cfg.engine.device_bab,
                                integrity=cfg.integrity and cfg.engine.integrity),
                        deadline_s=deadline, mesh=mesh, attacked=pgd_covered_all)
                except BaseException as exc:
                    # A fault escaping the engine's sequential phases has no
                    # finer blast radius than the batch: degrade every
                    # pending root and keep the run alive.
                    if classify(exc) == "propagate":
                        raise
                    _degrade(pending, _unretried_failure("bab", exc), "bab")
                    decisions, pending = [], []
            bab = dict(zip(pending, decisions))
            for ph in ("t_attack", "t_sign", "t_lp", "t_bab", "t_pair", "t_lattice"):
                tot = sum(dd.stats.get(ph, 0.0) for dd in decisions)
                if tot > 0.0:
                    timer.phases[f"engine_{ph[2:]}"] = tot
            for dd in decisions:
                if dd.phase is not None:
                    engine_decided[dd.phase] = engine_decided.get(dd.phase, 0) + 1
    orig_acc = 0.0
    pm = None  # the per-partition group-metrics sink (src/CP/Verify-CP.py:398-458)
    if dataset is not None:
        # The original net's accuracy on the test split: an f32 forward on
        # the run's device (TF32 off), thresholded at logit 0 as the JAX
        # package's ``predict`` does.
        x_test = torch.as_tensor(np.asarray(dataset.X_test, np.float32), device=dev)
        with torch.no_grad():
            pred = (net(x_test) > 0.0).cpu().numpy()
        orig_acc = float((pred.astype(int) == dataset.y_test).mean())
        if cfg.partition_metrics and len(enc.pa_idx):
            from fairify_tpu_torch.analysis import metrics as gm

            pm = {"path": os.path.join(cfg.result_dir, f"{sink_name}-metrics.csv"),
                  "X": np.asarray(dataset.X_test, dtype=np.float64),
                  "y": np.asarray(dataset.y_test).astype(int),
                  # The protected column of the test matrix, privileged value
                  # 1 (src/CP/Verify-CP.py:402-417); the first PA dim.
                  "prot": np.asarray(dataset.X_test)[:, int(enc.pa_idx[0])],
                  "orig_f1": gm.f1_score(dataset.y_test, pred.astype(int)),
                  "gm": gm}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # The SMT tier fans out after the last device sync of the BaB phase:
    # the pool's lane threads only write to pipes and read from them.
    smt_tier: Optional[_SmtTier] = None
    smt_deferred_items: List = []
    smt_transfer = False
    if cfg.smt_retry_timeouts_s and timer.total() <= cfg.hard_timeout_s:
        smt_candidates = [p for p, dd in bab.items()
                          if dd.verdict == "unknown" and p not in failed]
        if smt_candidates:
            with obs.timed_span(timer, "smt_fanout", queries=len(smt_candidates)):
                smt_tier = _SmtTier(net, enc, lo, hi, smt_candidates, cfg, pool=smt_pool)
    cumulative = timer.total()

    t_report = time.perf_counter()
    outcomes: List[PartitionOutcome] = []
    counts = {"sat": 0, "unsat": 0, "unknown": 0}
    degraded = 0
    beat = lambda: heartbeat.beat(decided=counts["sat"] + counts["unsat"],
                                  attempted=len(outcomes), unknown=counts["unknown"])
    ledger = JournalWriter(led_path, fault_site="ledger.append", supervisor=sup,
                           crc=cfg.integrity)
    try:
        for p in range(P):
            pid = span_start + p + 1
            if pid in done:
                rec = done[pid]
                outcomes.append(PartitionOutcome(
                    pid, rec["verdict"], counterexample=(
                        tuple(np.asarray(c, dtype=np.int64) for c in rec["ce"])
                        if rec.get("ce") else None)))
                counts[rec["verdict"]] += 1
                obs.event("verdict", model=model_name, partition_id=pid,
                          verdict=rec["verdict"], via="ledger")
                funnel.add(funnel_mod.classify(
                    rec["verdict"], "ledger",
                    failure=(rec.get("failure") or {}).get("reason")))
                if heartbeat is not None:
                    beat()
                continue
            t_part = time.perf_counter()
            fail_rec = failed.get(p)
            dead = pruning.partition_masks(prune, p) if prune is not None else None
            h_attempt = h_success = 0
            smt_decided = smt_deferred_this = False
            smt_unknown_reason = None
            sv_time = hv_time = h_time = 0.0
            ce = None
            nodes = 0
            if fail_rec is not None:
                verdict = "unknown"
            elif sat0[p]:
                verdict, ce = "sat", witnesses[p]
            elif unsat0[p]:
                verdict = "unsat"
            else:
                dec = bab[p]
                sv_time, nodes = dec.elapsed_s, dec.nodes
                verdict, ce = dec.verdict, dec.counterexample
                if verdict == "unknown" and prune is not None \
                        and cumulative <= cfg.hard_timeout_s:
                    # Heuristic retry: kill borderline-quiet neurons and
                    # re-decide on the masked net (src/GC/Verify-GC.py:172-211).
                    h_attempt = 1
                    obs.registry().counter("unknown_retries").inc()
                    t_h = time.perf_counter()
                    try:
                        _h_dead, merged = heur_ops.heuristic_prune(
                            [l[p] for l in prune.ws_lb], [l[p] for l in prune.ws_ub],
                            [l[p] for l in prune.candidates],
                            [l[p] for l in prune.surviving], dead,
                            cfg.heuristic_threshold)
                        dec2 = engine.decide_box(
                            mask_ops.apply_dead_masks(net, merged), enc, lo[p], hi[p],
                            replace(cfg.engine, soft_timeout_s=cfg.soft_timeout_s))
                    except BaseException as exc:
                        # A fault in the retry loses only the retry.
                        if classify(exc) == "propagate":
                            raise
                        _degrade([p], _unretried_failure("bab", exc), "heuristic_retry")
                        fail_rec = failed.get(p)
                        h_time = time.perf_counter() - t_h
                    else:
                        hv_time = dec2.elapsed_s
                        h_time = time.perf_counter() - t_h
                        nodes += dec2.nodes
                        if dec2.verdict != "unknown":
                            h_success = 1
                            verdict, ce = dec2.verdict, dec2.counterexample
                            # A SAT of the pruned net counts only if it
                            # replays on the original (the V-accurate check).
                            if verdict == "sat" and not engine.validate_pair(
                                    weights, biases, *ce):
                                verdict, ce, h_success = "unknown", None, 0
                        dead = merged
                if smt_tier is not None and p in smt_tier:
                    if verdict != "unknown" or fail_rec is not None \
                            or cumulative > cfg.hard_timeout_s:
                        # The retry decided it (or its chunk degraded, or the
                        # budget tripped): cancel the query, never await it.
                        smt_tier.cancel(p)
                    elif smt_defer and not smt_tier.done(p):
                        # Still solving: a provisional UNKNOWN whose ledger
                        # row the SmtDrain writes once the answer lands.
                        smt_deferred_this = True
                    else:
                        smt_verdict, smt_ce, smt_reason, smt_fail = _smt_answer(
                            smt_tier, p, weights, biases, cfg)
                        if smt_fail is not None:
                            _degrade([p], smt_fail, "smt")
                            fail_rec = failed.get(p)
                        if smt_verdict != "unknown":
                            verdict, ce = smt_verdict, smt_ce
                            smt_decided = True
                            if verdict == "unsat" and cfg.integrity and integrity_mod.sampled(
                                    cfg.seed, f"smt:{pid}", cfg.integrity_recheck):
                                # Sampled cross-check of SMT UNSATs by the
                                # exact-rational oracle.
                                obs.registry().counter("integrity_rechecks").inc(kind="smt")
                                from fairify_tpu_torch.verify import exact_check

                                xres = exact_check.decide_pair_box_exact(
                                    weights, biases, enc, lo[p], hi[p], max_nodes=2000)
                                if xres["verdict"] == "refuted":
                                    verdict, ce, smt_decided = "unknown", None, False
                                    _degrade([p], _integrity_failure(
                                        "exact", "refuted-smt-unsat"), "smt")
                                    fail_rec = failed.get(p)
                        elif not (smt_reason or "").startswith("smt.worker:"):
                            smt_unknown_reason = smt_reason
            c_check = v_accurate = 0
            if verdict == "sat" and ce is not None and dead is not None:
                c_check, v_accurate = c_check_np(weights, biases, dead, ce)
            if h_attempt and fail_rec is None:  # masks changed after the parity pass
                pruned_acc = parity_resim(weights, biases, dead, cfg.seed, span_start + p,
                                          lo[p], hi[p], cfg.sim_size, device=dev)
            else:
                pruned_acc = float(parity_col[p])
            counts[verdict] += 1
            degraded += fail_rec is not None
            via_stage0 = bool(sat0[p] or unsat0[p])
            counter.record(verdict, via_stage0=via_stage0)
            if h_success:
                obs.registry().counter("unknown_retry_success").inc()
            extra = {"failure": fail_rec["reason"]} if fail_rec is not None else {}
            if smt_unknown_reason is not None:
                extra["smt_reason"] = smt_unknown_reason
            if verdict == "unknown" and fail_rec is None and p in bab \
                    and bab[p].reason is not None:
                extra["engine_reason"] = bab[p].reason
            via = ("degraded" if fail_rec is not None else "stage0" if via_stage0
                   else "smt" if smt_decided else "heuristic" if h_success else "bab")
            obs.event("verdict", model=model_name, partition_id=pid, verdict=verdict,
                      via=via, **extra)
            funnel.add(funnel_mod.classify(
                verdict, via, failure=fail_rec["reason"] if fail_rec else None,
                engine_reason=extra.get("engine_reason")))
            total_time = stage0_per_part + sv_time + (time.perf_counter() - t_part)
            cumulative += time.perf_counter() - t_part
            obs.registry().histogram("partition_latency_s").observe(total_time)
            if prune is not None:
                comp = {
                    "b": mask_ops.compression_ratio([l[p] for l in prune.b_deads]),
                    "s": mask_ops.compression_ratio([l[p] for l in prune.s_deads]),
                    "st": mask_ops.compression_ratio([l[p] for l in prune.st_deads]),
                    "h": mask_ops.compression_ratio(dead) if h_attempt else 0.0,
                    "t": mask_ops.compression_ratio(dead),
                }
            else:  # the prune pass degraded: no masks exist for this span
                comp = {"b": 0.0, "s": 0.0, "st": 0.0, "h": 0.0, "t": 0.0}
            out = PartitionOutcome(
                pid, verdict, ce, h_attempt, h_success, nodes,
                times={"sv": sv_time, "s": stage0_per_part + sv_time, "hv": hv_time,
                       "h": h_time, "total": total_time},
                compressions=comp, c_check=c_check, v_accurate=v_accurate,
                pruned_acc=pruned_acc)
            outcomes.append(out)
            if smt_deferred_this:
                smt_deferred_items.append((p, pid, out))
            if heartbeat is not None:
                beat()
            if pm is not None and fail_rec is None and dead is not None:
                _append_metrics_row(pm, weights, biases, dead, pid, orig_acc)
            csvio.append_row(csv_path, csvio.PartitionRow(
                partition_id=pid, verdict=verdict, sat_count=counts["sat"],
                unsat_count=counts["unsat"], unk_count=counts["unknown"],
                h_attempt=h_attempt, h_success=h_success,
                b_compression=comp["b"], s_compression=comp["s"],
                st_compression=comp["st"], h_compression=comp["h"],
                t_compression=comp["t"], sv_time=sv_time,
                s_time=stage0_per_part + sv_time, hv_time=hv_time, h_time=h_time,
                total_time=total_time, c_check=c_check, v_accurate=v_accurate,
                original_acc=orig_acc, pruned_acc=pruned_acc, c1=ce[0] if ce else None,
                c2=ce[1] if ce else None))
            led_rec = {"partition_id": pid, "verdict": verdict,
                       "ce": [ce[0].tolist(), ce[1].tolist()] if ce else None,
                       "time_s": round(total_time, 4)}
            if fail_rec is not None:
                led_rec["failure"] = fail_rec
            if "engine_reason" in extra:
                led_rec["engine_reason"] = extra["engine_reason"]
            if not smt_deferred_this:
                # A deferred partition's row is the SmtDrain's to write.
                ledger.append(led_rec)
            if ce is not None:
                _write_ce(ce_path, cfg.query().columns, pid, ce)
        smt_transfer = bool(smt_deferred_items)
    finally:
        ledger.close()
        if smt_tier is not None and not smt_transfer:
            # Unconsumed futures are cancelled and a run-owned pool's workers
            # reaped, even when the loop raised; under smt_defer a clean exit
            # hands the tier to the report's SmtDrain instead.
            smt_tier.close()
    if retry_unknown:
        # Re-decided rows were appended after their 'unknown' rows: restore
        # one row per partition in ascending order, in both CSVs.
        csvio.rewrite_deduped(csv_path)
        if pm is not None:
            _dedupe_metrics(pm["path"])

    timer.phases["report"] = time.perf_counter() - t_report
    elapsed = timer.total()
    run_launches = launches.delta(launches0)
    kernel_launches = {k: v - launches0["launches"][k]
                       for k, v in launches.counts().items()}
    funnel_payload = {
        "states": funnel.to_dict(), "total": funnel.total,
        "decided": funnel.decided, "decided_fraction": funnel.decided_fraction,
        "margin_hist": stage_stats.to_payload() if stage_stats.boxes else None,
        "looseness": (None if prune is None or prune.looseness is None
                      else [float(v) for v in prune.looseness]),
    }
    obs.event("funnel", model=model_name, **funnel_payload)
    pps = counter.decided / max(elapsed, 1e-9)
    run_counters = {name: int(obs.registry().counter(name).total() - counters0[name])
                    for name in RUN_COUNTERS}
    flight = pipe.stats.summary()
    thr = {
        "elapsed_s": round(elapsed, 3), "decided": counter.decided,
        "stage0_decided": counter.stage0_decided,
        "bab_decided": counter.bab_decided,
        "engine_decided": engine_decided,
        "unknown": counter.unknown, "partitions_per_sec": round(pps, 4),
        "partitions_per_sec_per_chip": round(pps / (1 if mesh is None else mesh.size), 4),
        "launches_per_model": sum(kernel_launches.values()),
        "kernel_launches": kernel_launches,
        "launches": run_launches,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else "cpu")},
        "decided_fraction": round(float(funnel.decided_fraction), 6),
        "funnel": funnel.to_dict(),
        "phases_s": {k: round(v, 3) for k, v in timer.phases.items()},
        "pipeline_depth": int(cfg.pipeline_depth),
        "launches_in_flight_max": int(flight["max"]),
        "launches_in_flight_mean": float(flight["mean"]),
        "counters": run_counters,
    }
    if funnel_payload["margin_hist"]:
        thr["margin_hist"] = funnel_payload["margin_hist"]
    if funnel_payload["looseness"] is not None:
        thr["looseness"] = [round(v, 3) for v in funnel_payload["looseness"]]
    resilience = {"degraded": degraded, "ledger_skipped_lines": led_skipped,
                  **{k: run_counters[k] for k in ("integrity_violations",
                                                  "integrity_rechecks",
                                                  "ledger_crc_mismatch")}}
    if any(resilience.values()):
        thr["resilience"] = resilience
    with open(os.path.join(cfg.result_dir,
                           f"{cfg.name}-{sink_name}.throughput.json"), "w") as fp:
        json.dump(thr, fp, indent=1)
    if heartbeat is not None:  # final line regardless of throttle state
        heartbeat.beat(decided=counts["sat"] + counts["unsat"], attempted=len(outcomes),
                       unknown=counts["unknown"], force=True)
        heartbeat.close()
    report = ModelReport(model=model_name, dataset=cfg.dataset, outcomes=outcomes,
                         original_acc=orig_acc, total_time_s=elapsed, partitions_total=P,
                         sink_name=sink_name, ledger_skipped_lines=led_skipped,
                         degraded=degraded, funnel=funnel_payload,
                         kernel_launches=kernel_launches)
    if smt_deferred_items:
        report.smt_pending = SmtDrain(
            tier=smt_tier, items=smt_deferred_items, report=report, cfg=cfg,
            weights=weights, biases=biases, ledger_path=led_path, model_name=model_name,
            sink_name=sink_name)
    return report


METRICS_HEADER = ["Partition ID", "Original Accuracy", "Original F1 Score", "Pruned Accuracy",
                  "Pruned F1", "DI", "SPD", "EOD", "AOD", "ERD", "CNT", "TI"]


def _append_metrics_row(pm: dict, weights, biases, dead, pid: int, orig_acc: float) -> None:
    """One row of the per-partition group-metrics CSV
    (``src/CP/Verify-CP.py:448-458``): the original and the partition's
    pruned net's test accuracy and F1, then the group metrics of the
    partition's masked net (the JAX package's deliberate delta from the
    reference, which recomputes them from the unpruned net every row)."""
    gm = pm["gm"]
    p_pred = predict_np(weights, biases, pm["X"], dead=dead)
    rep = gm.group_report(pm["X"], pm["y"], p_pred, pm["prot"], privileged_value=1)
    new_file = not os.path.isfile(pm["path"])
    with open(pm["path"], "a", newline="") as fp:
        wr = csv.writer(fp)
        if new_file:
            wr.writerow(METRICS_HEADER)
        wr.writerow([pid, round(orig_acc, 6), round(pm["orig_f1"], 6),
                     round(float((p_pred == pm["y"]).mean()), 6),
                     round(gm.f1_score(pm["y"], p_pred), 6),
                     round(rep.disparate_impact, 6),
                     round(rep.statistical_parity_difference, 6),
                     round(rep.equal_opportunity_difference, 6),
                     round(rep.average_odds_difference, 6),
                     round(rep.error_rate_difference, 6), round(rep.consistency, 6),
                     round(rep.theil_index, 6)])


def _dedupe_metrics(path: str) -> None:
    """Keep the last metrics row per partition, in ascending id order."""
    if not os.path.isfile(path):
        return
    with open(path, newline="") as fp:
        rows = list(csv.reader(fp))
    last = {r[0]: r for r in rows[1:]}
    with open(path, "w", newline="") as fp:
        wr = csv.writer(fp)
        wr.writerow(rows[0])
        for k in sorted(last, key=int):
            wr.writerow(last[k])


# ---------------------------------------------------------------------------
# run_sweep: the verification scripts' outer loop over a model family
# ---------------------------------------------------------------------------

SHARDS_NOT_PORTED = ("run_sweep: n_shards routes through the sharded runtime "
                     "(parallel.shards), which is not ported yet: ROADMAP queue 1, item 7")


def run_sweep(cfg: SweepConfig, model_root=None, data_root=None, mesh=None, stack: bool = True,
              host_index=None, host_count=None, retry_unknown: bool = False, n_shards=None,
              device=None) -> List[ModelReport]:
    """Sweep every model of the configured family (the JAX package's
    ``run_sweep``; its parameters in its order, then the port's ``device``).

    The dataset comes from ``data.loaders.load(cfg.dataset, data_root)``
    and the nets from ``models.zoo.load_matching`` (``.npz`` exports or
    Keras ``.h5`` files under ``model_root``; nets whose input width is not
    the domain's are skipped with a message on stderr).  With ``stack``,
    every architecture shared by two or more models gets its stage 0 from
    one stacked family launch per segment (:func:`stage0_families`, all
    groups through one launch pipeline), forwarded with its histograms to
    each model's ``verify_model(stage0=...)``.  ``host_count`` sweeps only
    this host's :func:`parallel.multihost.host_slice` span of every model
    (stacking off: a family's stage 0 is grid-global).  ``n_shards`` (the
    sharded runtime) raises ``NotImplementedError`` naming ROADMAP item 7,
    after the JAX package's argument checks.
    """
    if n_shards and host_count is not None:
        raise ValueError("run_sweep: n_shards and host_count are mutually "
                         "exclusive (call shards.sweep_sharded with "
                         "partition_span to shard inside a host slice)")
    if n_shards and retry_unknown:
        raise ValueError("run_sweep: retry_unknown is not supported with "
                         "n_shards yet — resume=True re-attempts degraded "
                         "partitions; budget UNKNOWNs stay settled")
    if n_shards:
        raise NotImplementedError(SHARDS_NOT_PORTED)
    with obs.maybe_tracing(cfg.trace_out, run_id=cfg.name):
        with obs.span("run_sweep", preset=cfg.name, dataset=cfg.dataset) as sp:
            reports = _run_sweep_impl(cfg, model_root, data_root, mesh, stack, host_index,
                                      host_count, retry_unknown, device)
            sp.set(models=len(reports))
            return reports


def _run_sweep_impl(cfg, model_root, data_root, mesh, stack, host_index, host_count,
                    retry_unknown, device) -> List[ModelReport]:
    import sys
    from collections import defaultdict

    if mesh is not None and device is None:
        device = mesh.home
    dev = resolve_device(device)
    dataset = loaders.load(cfg.dataset, root=data_root)
    n_attrs = len(cfg.query().columns)
    nets, skipped = zoo.load_matching(cfg.dataset, n_attrs, models=cfg.models,
                                      root=model_root, device=dev)
    for name in skipped:
        print(f"skipping {name}: input dim != domain dim {n_attrs}", file=sys.stderr)
    if not nets:
        return []
    stage0_by_model = {}
    if host_count is not None:
        stack = False  # a family's stage 0 would be grid-global
    if stack:
        groups = defaultdict(list)
        for name, net in nets.items():
            groups[(net.in_dim,) + net.layer_sizes].append(name)
        multi = [names for names in groups.values() if len(names) >= 2]
        if multi:
            if dev.type == "cuda":
                cuda_build.build_all(_supervisor(cfg))
            enc = encode(cfg.query())
            _, lo, hi = build_partitions(cfg)
            stacks = [mesh_mod.stack_models([nets[n] for n in names]) for names in multi]
            # One launch pipeline across every architecture group: the
            # device queue never drains between families.
            fam_pipe = LaunchPipeline(cfg.pipeline_depth, supervisor=_supervisor(cfg))
            fam_stats: Dict = {}
            with obs.span("stage0_family", models=sum(len(n) for n in multi),
                          groups=len(multi), partitions=int(lo.shape[0])) as sp:
                fams = stage0_families(stacks, enc, lo, hi, cfg, mesh=mesh, pipe=fam_pipe,
                                       stats=fam_stats)
                sp.set(in_flight_max=fam_pipe.stats.max,
                       in_flight_mean=round(fam_pipe.stats.mean(), 3))
            for gi, (names, fam) in enumerate(zip(multi, fams)):
                for m, (name, s0) in enumerate(zip(names, fam)):
                    # The family kernels' per-model histograms, forwarded so
                    # the model's funnel equals an unstacked run's.
                    st = fam_stats.get((gi, m))
                    stage0_by_model[name] = s0 + (st,) if st is not None else s0
    return [verify_model(net, cfg, model_name=name, dataset=dataset, mesh=mesh,
                         stage0=stage0_by_model.get(name), host_index=host_index,
                         host_count=host_count, retry_unknown=retry_unknown, device=dev)
            for name, net in nets.items()]
