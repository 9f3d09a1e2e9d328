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
  core, ``ops/exact_native.py``).
* **Stage 0, IBP path** — per chunk one row-13 launch (role-logit bounds,
  ``csrc/role_bounds.cu``) and one row-17 launch (attack logits,
  ``csrc/attack_logits.cu``), each with a model axis for a stacked family;
  the certificate, margin, flips and gap on the host.
* **Stage 0, CROWN path** — one KB launch (certificate, ``csrc/stage0_certify.cu``)
  and one KC launch (attack, flips, histograms, fold,
  ``csrc/attack_flips.cu``) per segment (the stacked chunks plus the
  integrity canary chunk; the host checks the fold and the canary) or per
  chunk (:func:`stage0_block`; histograms binned on the host); the host
  replays every flip exactly before it counts as SAT.
* **Stage 0 with a mesh** — per chunk the certificate alone (KB as rows
  14 and 6, :func:`engine.role_certify`; row 13 on the IBP path) over the
  mesh's ``parts`` shards, then the attack forward (row 17) unsharded on
  the mesh's first device, the flips and gap on the host
  (:func:`engine.split_certify_attack`).  For a stacked
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
* **Reporting** — CRC-checked JSONL ledger (unknown rows carry the
  engine's ``engine_reason``), the 24-column CSV, the counterexample CSV
  and the throughput JSON with per-phase ``phases_s`` and, per engine
  phase, the partitions it decided on the first pass (``engine_decided``).

Launches run synchronously (the async pipeline, supervisor and obs spans
are ROADMAP queue 1, item 4).  What the port does not run yet — the
runtime contracts' settings (:func:`check_supported`), the SMT tier —
raises ``NotImplementedError`` naming its ROADMAP item where it would run.
"""
from __future__ import annotations

import csv
import ctypes
import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from fairify_tpu_torch.models.mlp import StackedMLP, predict_np
from fairify_tpu_torch.obs import funnel as funnel_mod
from fairify_tpu_torch.ops import crown as crown_ops
from fairify_tpu_torch.ops import heuristic as heur_ops
from fairify_tpu_torch.ops import lattice as lattice_ops
from fairify_tpu_torch.ops import masks as mask_ops
from fairify_tpu_torch.ops.simulate import PLAIN_ROWS, mean_scale
from fairify_tpu_torch.parallel import mesh as mesh_mod
from fairify_tpu_torch.partition import grid as grid_mod
from fairify_tpu_torch.resilience import integrity as integrity_mod
from fairify_tpu_torch.resilience.journal import JournalWriter
from fairify_tpu_torch.utils import cuda_build, prng
from fairify_tpu_torch.utils.num import resolve_device
from fairify_tpu_torch.utils.prng import grid_keys, shuffled_order, simulate_boxes
from fairify_tpu_torch.verify import csvio, engine, pruning
from fairify_tpu_torch.verify.config import SweepConfig
from fairify_tpu_torch.verify.property import PairEncoding, encode, role_boxes

SMT_NOT_PORTED = ("the SMT UNKNOWN-retry tier (smt_retry_timeouts_s) is not "
                  "ported yet: ROADMAP queue 1, item 5")


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
    degraded: int = 0
    funnel: Optional[dict] = None
    # Kernel launches of this run by kernel name (0 on the CPU, where the
    # plain PyTorch versions run instead).
    kernel_launches: Dict[str, int] = field(default_factory=dict)

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


# Settings with which the JAX package writes or changes an output the port
# does not produce yet: a span trace, an XLA trace, a heartbeat line, and a
# per-chunk retry deadline that changes which chunks are retried.
OUTPUT_SETTINGS = ("trace_out", "profile_dir", "heartbeat_s", "chunk_deadline_s")
RUNTIME_NOT_PORTED = ("the runtime contracts (pipeline, supervisor, faults, "
                      "integrity recheck, obs) are not ported yet: ROADMAP queue 1, "
                      "item 4")


def check_supported(cfg: SweepConfig, mesh=None) -> None:
    """Reject every configuration the port does not run yet, naming its
    ROADMAP item: fault injection, the sampled integrity
    recheck (only with ``integrity`` on: with it off the JAX package runs
    no recheck) and a non-default value of a setting in
    :data:`OUTPUT_SETTINGS`, with which the JAX package writes or changes
    an output (item 4).

    The port accepts, and does not act on yet, ``pipeline_depth``,
    ``max_launch_retries`` and ``launch_backoff_s``: its launches run
    synchronously and see no faults, where these settings change only
    timing (the stress presets set the first two).  ``partition_metrics``
    acts in the JAX package only with a ``dataset``, which the port's
    :func:`verify_model` does not take yet (ROADMAP queue 1, item 6).
    A ``mesh`` that is not a ``parallel.mesh.Mesh`` raises ``TypeError``.
    """
    mesh_mod.require_mesh(mesh)
    if cfg.inject_faults:
        raise NotImplementedError(f"inject_faults: {RUNTIME_NOT_PORTED}")
    if cfg.integrity and cfg.integrity_recheck > 0.0:
        raise NotImplementedError(f"integrity_recheck: {RUNTIME_NOT_PORTED}")
    default = SweepConfig(name="", dataset="", protected=())
    for name in OUTPUT_SETTINGS:
        if getattr(cfg, name) != getattr(default, name):
            raise NotImplementedError(f"{name}: {RUNTIME_NOT_PORTED}")


def use_mega(cfg: SweepConfig, mesh=None) -> bool:
    """Whether stage 0, the prune and the parity passes run the mega path
    (the JAX package's ``_use_mega``): only the fused CROWN body on one
    device has one, so the IBP path and a mesh take the chunk loop
    whatever ``mega_chunks`` says."""
    return cfg.mega_chunks > 0 and cfg.engine.use_crown and mesh is None


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


def mega_segment(net, enc: PairEncoding, lo, hi, cfg: SweepConfig, chunks,
                 step: int, seed_offset: int):
    """Run one segment's stage 0 on the net's device: ``(host, ctx)``.

    ``host`` holds the packed buffers the JAX package's mega kernel returns
    — ``cert (C, P) bool``, ``wit (C, P, 3) int32``, ``reason (C, P) int8``,
    ``stats (2, 14) int32`` and, with integrity on, the device fold
    ``csum`` — with C the real chunks plus the canary.  For a stacked
    family (``_mega_family_stage0_kernel``) one KB and one KC launch cover
    chunks × models × rows: ``cert (C, M, P)``, ``wit (C, M, P, 3)``,
    ``reason (C, M, P)``, ``stats (M, 2, 14)``, and the fold covers every
    model's buffers.
    """
    dev = net.device
    (x_lo, x_hi, xp_lo, xp_hi, plo, phi, valid, xr, pr,
     nv) = mega_chunk_inputs(enc, lo, hi, cfg, chunks, step, seed_offset,
                             canary=cfg.integrity)
    C, P = valid.shape[:2]
    av, pm, rm = engine.enc_tensors(enc, lo.shape[1])
    on_dev = lambda a: torch.as_tensor(a, device=dev)
    flat = lambda a: on_dev(a.reshape((C * P,) + a.shape[2:]))
    ok = (np.arange(P)[None, :] < nv[:, None]).reshape(-1)
    valid_t, vpair = flat(valid), on_dev(enc.valid_pair)
    cert, _score, margin = engine.stage0_certify(
        net, flat(x_lo), flat(x_hi), flat(xp_lo), flat(xp_hi), flat(plo),
        flat(phi), on_dev(av), on_dev(pm), on_dev(rm), float(enc.eps),
        valid_t, vpair)
    wit, reason, _gap, stats, fold = engine.attack_flips(
        net, flat(xr), flat(pr), valid_t, vpair, cert, margin, on_dev(ok))

    def chunk_major(t):  # (M?, C*P, ...) -> (C, M?, P, ...)
        a = t.cpu().numpy()
        lead = a.shape[:1] if isinstance(net, StackedMLP) else ()
        a = a.reshape(lead + (C, P) + a.shape[len(lead) + 1:])
        return np.moveaxis(a, 0, 1) if lead else a

    host = {"cert": chunk_major(cert), "wit": chunk_major(wit),
            "reason": chunk_major(reason), "stats": stats.cpu().numpy()}
    if cfg.integrity:
        host["csum"] = np.int32(fold)
    return host, {"chunks": chunks, "xr": xr, "pr": pr}


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


def stage0_block(net, enc: PairEncoding, lo, hi, cfg: SweepConfig, rng_seed: int,
                 pad_to: int, mesh=None, replicas=None):
    """One grid chunk's stage 0 (``_stage0_block_submit`` + ``_decode``;
    ``_family_block_*`` for a stacked family): the chunk is padded to
    ``pad_to`` rows BEFORE the attack candidates are drawn from
    ``default_rng(rng_seed)``.  The CROWN path (the fused branch) is one
    :func:`engine.certify_attack` (one KB + one KC launch); the IBP path
    (``use_crown=False``) and, on either path, a ``mesh`` (``replicas``
    the net's copies on it) take :func:`engine.split_certify_attack`: the
    certificate alone (row 13, or with a mesh on the CROWN path row 14 /
    row 6) over the mesh's ``parts`` shards, then the attack forward (row
    17) unsharded, the flips and gap on the host.  Returns per model
    ``(unsat, sat, witnesses, margin, gap)``, chunk padding rows included
    (the shard padding trimmed)."""
    lo, hi = grid_mod.pad_rows(lo, pad_to), grid_mod.pad_rows(hi, pad_to)
    flo, fhi = lo.astype(np.float32), hi.astype(np.float32)
    x_lo, x_hi, xp_lo, xp_hi, valid = role_boxes(enc, flo, fhi)
    xr, pr = engine.build_attack_candidates(enc, np.random.default_rng(rng_seed),
                                            lo, hi, cfg.engine.attack_samples)
    models = _model_params(net)
    if mesh is not None or not cfg.engine.use_crown:
        out = engine.split_certify_attack(net, enc, x_lo, x_hi, xp_lo, xp_hi, flo, fhi,
                                          valid, xr, pr, cfg.engine.use_crown,
                                          mesh=mesh, replicas=replicas)
        per_model = out if isinstance(net, StackedMLP) else [out]
        return [decode_flips(cert, found, wit, xr, pr, w, b) + (margin, gap)
                for (cert, margin, found, wit, gap), (w, b) in zip(per_model, models)]
    on = lambda a: torch.as_tensor(a, device=net.device)
    av, pm, rm = engine.enc_tensors(enc, lo.shape[1])
    out = engine.certify_attack(net, on(x_lo), on(x_hi), on(xp_lo), on(xp_hi), on(flo),
                                on(fhi), on(av), on(pm), on(rm), float(enc.eps), on(valid),
                                on(enc.valid_pair), on(xr), on(pr), alpha_iters=0)
    cert, _score, found, wit, margin, gap = (t.cpu().numpy() for t in out)
    if not isinstance(net, StackedMLP):
        cert, found, wit, margin, gap = (a[None] for a in (cert, found, wit, margin, gap))
    return [decode_flips(cert[m], found[m], wit[m], xr, pr, w, b) + (margin[m], gap[m])
            for m, (w, b) in enumerate(models)]


def integrity_failure(detector: str) -> dict:
    """Failure record of a segment whose fold or canary check tripped (the
    JAX package's ``ChunkFailure.to_record`` layout): its partitions land
    in ``unknown:failure:integrity.launch.decode`` and a resume re-attempts
    them."""
    site = "integrity.launch.decode"
    return {"reason": f"{site}:fatal", "site": site, "kind": "fatal",
            "error": "IntegrityViolation",
            "detail": f"{detector} mismatch (launch.decode)", "retries": 0}


def stage0_families(stacks, enc: PairEncoding, lo, hi, cfg: SweepConfig,
                    seed_offset: int = 0, stats=None, mesh=None, failed=None):
    """Stage 0 of several stacked families (``stage0_families``): one
    result list per entry of ``stacks``, each holding per model ``(unsat
    (P,), sat (P,), witnesses {p: (x, x')})``.

    ``mega_chunks > 0``: one KB + one KC launch per (family, segment) over
    chunks × models × rows (:func:`mega_segment`); with integrity on, a
    tripped fold or canary check leaves that (family, segment) undecided
    (and, when ``failed`` is a dict, records the failure of each of its
    rows — the single-model caller's contract).  ``mega_chunks = 0`` or a
    ``mesh`` (``parallel.mesh.Mesh``: the family is replicated over it and
    each chunk's certificate sharded, :func:`stage0_block`): one
    :func:`stage0_block` per (family, chunk).  Every model attacks the same
    candidates, drawn once per chunk from ``default_rng(engine.seed +
    seed_offset + chunk_start)``, and each model's witnesses replay on its
    own weights.  ``stats`` (a dict) receives one ``StageStats`` per
    ``(family index, model index)``: the kernel's histograms on the mega
    path, host-binned margins and gaps on the chunk path — equal bit for
    bit.  The IBP path (``use_crown=False``) and a mesh always take the
    chunk loop (:func:`use_mega`) and, like the JAX package's IBP and mesh
    family branches, bank no statistics for a stacked family (a single
    net's chunks bank theirs, as ``_stage0_block_decode`` does).  A single
    (unstacked) net
    in ``stacks`` counts as one model.  Launches run synchronously.
    """
    mesh_mod.require_mesh(mesh)
    P = lo.shape[0]
    n_models = [net.n_models if isinstance(net, StackedMLP) else 1 for net in stacks]
    accs = [[(np.zeros(P, bool), np.zeros(P, bool), {}) for _ in range(M)]
            for M in n_models]
    bank = lambda gi, m: (stats.setdefault((gi, m), funnel_mod.StageStats())
                          if stats is not None else funnel_mod.StageStats())

    def store(gi, m, s, e, u, sa, w):
        unsat, sat, wits = accs[gi][m]
        unsat[s:e], sat[s:e] = u[: e - s], sa[: e - s]
        wits.update({s + k: v for k, v in w.items() if k < e - s})

    if use_mega(cfg, mesh):
        step, segs = grid_mod.segment_spans(P, cfg.grid_chunk, cfg.mega_chunks)
        for gi, net in enumerate(stacks):
            models = _model_params(net)
            for seg_s, seg_e, chunks in segs:
                host, ctx = mega_segment(net, enc, lo, hi, cfg, chunks, step, seed_offset)
                if cfg.integrity:
                    tripped = integrity_mod.verify_segment(host)
                    if tripped is not None:
                        if failed is not None:
                            rec = integrity_failure(tripped)
                            failed.update({i: rec for i in range(seg_s, seg_e)})
                        continue
                seg_stats = host["stats"].reshape((-1,) + host["stats"].shape[-2:])
                for m in range(n_models[gi]):
                    bank(gi, m).add_packed(seg_stats[m])
                for (s, e), per_model in zip(chunks, mega_segment_decode(host, ctx,
                                                                         models)):
                    for m, (u, sa, w) in enumerate(per_model):
                        store(gi, m, s, e, u, sa, w)
    else:
        step, spans = grid_mod.chunk_spans(P, cfg.grid_chunk)
        for gi, net in enumerate(stacks):
            banked = not isinstance(net, StackedMLP) or (cfg.engine.use_crown
                                                         and mesh is None)
            reps = None if mesh is None else mesh_mod.replicated(mesh, net)
            for s, e in spans:
                per_model = stage0_block(net, enc, lo[s:e], hi[s:e], cfg,
                                         cfg.engine.seed + seed_offset + s, step,
                                         mesh=mesh, replicas=reps)
                for m, (u, sa, w, margin, gap) in enumerate(per_model):
                    if banked:
                        bank(gi, m).add_values(margin[: e - s], gap[: e - s])
                    store(gi, m, s, e, u, sa, w)
    return accs


def stage0_family(stacked, enc: PairEncoding, lo, hi, cfg: SweepConfig,
                  seed_offset: int = 0, stats=None):
    """Stage 0 of one stacked family (``_stage0_family``): per model
    ``(unsat, sat, witnesses)``; ``stats`` as in :func:`stage0_families`
    (keys ``(0, m)``)."""
    return stage0_families([stacked], enc, lo, hi, cfg, seed_offset=seed_offset,
                           stats=stats)[0]


def stage0_certify_and_attack(net, enc: PairEncoding, lo, hi, cfg: SweepConfig,
                              stats, failed, seed_offset: int = 0, mesh=None):
    """Root certificates + attack for the whole grid of one net: one
    KB + KC pair per segment (the mega path, :func:`use_mega`) or per grid
    chunk (the chunk loop), or on the IBP path one row-13 + row-17 pair per
    grid chunk; with a ``mesh``, per grid chunk one row-14 (row-13) launch
    per shard and one row-17 launch; :func:`stage0_families` with one
    model.

    Returns ``(unsat (P,), sat (P,), witnesses {p: (x, x')})``; ``stats``
    (an ``obs.funnel.StageStats``) accumulates the margin and gap
    histograms; ``failed`` (dict) receives the failure record of every
    partition of a segment whose fold or canary check trips.
    ``seed_offset`` (a partition span's start) offsets the attack streams,
    as in the JAX package.
    """
    fam_stats: dict = {}
    (res,) = stage0_families([net], enc, lo, hi, cfg, seed_offset=seed_offset,
                             stats=fam_stats, failed=failed, mesh=mesh)[0]
    if (0, 0) in fam_stats:
        stats.merge(fam_stats[(0, 0)])
    return res


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
    out = pruning._sim_launch(net, keys, lo, hi, sim_size, live, "kd", alive=al)
    parity.launches += 1
    return out


parity.launches = 0


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


KERNELS = {
    "sim_and_bounds": pruning.sim_and_bounds,
    "stage0_certify": engine.stage0_certify,
    "attack_flips": engine.attack_flips,
    "parity": parity,
    "pgd_attack": engine.pgd_attack_kernel,
    "bab_segment": engine.bab_segment,
    "sim_rows": pruning.sim_rows,
    "grid_keys": grid_keys,
    "sign_bound": engine.sign_bound,
    "inter_bounds": engine.inter_bounds,
    "role_logits": engine.sample_role_logits,
    "lattice_scan": lattice_ops.lattice_scan,
    "lattice_signs": lattice_ops.lattice_signs,
    "lattice_scan_ra": lattice_ops.lattice_scan_ra,
    "role_bounds": engine.role_logit_bounds,
    "attack_logits": engine.attack_logits,
    "role_certify": engine.role_certify,
    "sim_stats": pruning.sim_stats,
    "alpha_crown": crown_ops.alpha_crown_output_bounds,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def parity_pass(net, prune, lo, hi, cfg: SweepConfig, index_offset: int = 0,
                mesh=None):
    """The grid's parity column (keys of the global partition index: row
    plus ``index_offset``): one KD launch per segment, or off the mega
    path (:func:`use_mega`; always with a ``mesh``, whose parity the JAX
    package also runs unsharded) one per grid chunk padded to the chunk
    size (``_parity_grid_from_keys``, row 10), alive masks padded like the
    boxes, launched over the chunk's real rows (``live``)."""
    P = lo.shape[0]
    dev = net.device
    out = np.zeros(P, dtype=np.float32)
    if use_mega(cfg, mesh):
        _, segs = grid_mod.segment_spans(P, cfg.grid_chunk, cfg.mega_chunks)
        pad, blocks = 0, [(s, e) for s, e, _chunks in segs]
    else:
        pad, blocks = grid_mod.chunk_spans(P, cfg.grid_chunk)
    for s, e in blocks:
        n = max(pad, e - s)
        rows = lambda a: grid_mod.pad_rows(np.asarray(a[s:e], np.float32), n)
        keys = grid_keys(cfg.seed, index_offset + s, n, device=dev)
        alive = [torch.as_tensor(rows(1.0 - d), device=dev) for d in prune.st_deads[:-1]]
        out[s:e] = parity(net, keys, torch.as_tensor(rows(lo), device=dev),
                          torch.as_tensor(rows(hi), device=dev), alive, cfg.sim_size,
                          live=e - s).cpu().numpy()[: e - s]
    return out


# ---------------------------------------------------------------------------
# Ledger, resume and the reporting loop
# ---------------------------------------------------------------------------


def ledger_path(cfg: SweepConfig, model_name: str) -> str:
    return os.path.join(cfg.result_dir, f"{cfg.name}-{model_name}.ledger.jsonl")


def read_ledger(path: str):
    """Records of one ledger (CRC-verified) and the torn-line count."""
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
    recs, _bad = integrity_mod.verify_records(recs)
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
               span_start: int, budget_left):
    """The deep PGD attack over the stage-0 leftovers ``pending`` (grid row
    indices), one K5 launch per ``grid_chunk`` of them, then the exact
    flip-slab search from each box's near-zero PGD point, the box midpoint
    and six seeded lattice points — within a quarter of the remaining hard
    budget (``budget_left()`` seconds).  Returns ``(witnesses {row: (x,
    x')}, covered_all)``: ``covered_all`` False when the hard budget cut the
    launch loop, so the engine must not skip its own Phase A.
    """
    weights, biases = net.numpy_params()
    pgd_wit: Dict[int, tuple] = {}
    slab_budget = 0.25 * max(budget_left(), 0.0)
    slab_spent = 0.0
    covered_all = True
    step = min(cfg.grid_chunk, len(pending)) if cfg.grid_chunk > 0 else len(pending)
    for s in range(0, len(pending), step):
        if budget_left() < 0.0:
            covered_all = False
            break
        blk = pending[s:s + step]
        w, near_zero, near_abs = engine.pgd_attack(
            net, enc, lo[blk], hi[blk],
            np.random.default_rng(cfg.engine.seed + 1 + span_start + s),
            steps=cfg.engine.pgd_steps, restarts=cfg.engine.pgd_restarts,
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
    return pgd_wit, covered_all


def verify_model(net, cfg: SweepConfig, model_name: str = "model",
                 resume: bool = True, mesh=None, device=None,
                 partition_span=None, stage0=None) -> ModelReport:
    """Run the sweep for one model; write CSV + ledger rows.

    ``device`` defaults to ``cuda`` (``device="cpu"`` runs the plain PyTorch
    versions of the kernels); the net is moved there.  ``mesh`` (a
    ``parallel.mesh.Mesh``; anything else raises ``TypeError``) shards
    stage 0's certificates and the engine's BaB batches over its ``parts``
    axis and runs the rest on its first device, which ``device`` must name
    if given (``ValueError`` otherwise); the throughput record's
    ``partitions_per_sec_per_chip`` is divided by the mesh's size, as in
    the JAX package.  ``partition_span``
    ``(start, stop)`` runs a contiguous slice of the shuffled grid, with
    global partition ids and keys, and sinks named ``model@start-stop``.
    ``stage0``: this model's precomputed stage-0 result from
    :func:`stage0_families` — ``(unsat, sat, witnesses)`` or, with the
    family's ``StageStats`` forwarded, ``(unsat, sat, witnesses,
    stats)`` — over the same grid rows; stage 0's own launches are then
    skipped and the forwarded histograms merged.  Configurations the port
    does not run raise ``NotImplementedError`` (:func:`check_supported`,
    and the engine where an unported phase would run).
    """
    check_supported(cfg, mesh)
    if mesh is not None and device is None:
        device = mesh.home
    dev = resolve_device(device)
    if mesh is not None and mesh_mod.canonical_device(dev) != mesh.home:
        raise ValueError(f"verify_model: device {dev} is not the mesh's first "
                         f"device {mesh.home}")
    net = net.to(dev)
    t_run = time.perf_counter()
    phases: Dict[str, float] = {}
    total = lambda: time.perf_counter() - t_run  # the hard budget's clock
    launches0 = launch_counts()
    enc = encode(cfg.query())
    p_list, lo, hi = build_partitions(cfg)
    span_start, sink_name = 0, model_name
    if partition_span is not None:
        span_start, span_stop = partition_span
        p_list = p_list[span_start:span_stop]
        lo, hi = lo[span_start:span_stop], hi[span_start:span_stop]
        sink_name = f"{model_name}@{span_start}-{span_stop}"
    P = len(p_list)
    os.makedirs(cfg.result_dir, exist_ok=True)
    led_path = ledger_path(cfg, sink_name)
    done, led_skipped = {}, 0
    if resume:
        done, _degraded_prev, led_skipped = merge_ledgers([led_path])
    csv_path = os.path.join(cfg.result_dir, f"{sink_name}.csv")
    ce_path = os.path.join(cfg.result_dir, f"{sink_name}-counterexamples.csv")
    stage_stats = funnel_mod.StageStats()
    funnel = funnel_mod.FunnelCounts()
    failed: Dict[int, dict] = {}

    t0 = time.perf_counter()
    prune = pruning.sound_prune_grid(net, lo, hi, cfg.sim_size, cfg.seed,
                                     chunk=cfg.grid_chunk,
                                     mega_chunks=cfg.mega_chunks if use_mega(cfg, mesh)
                                     else 0,
                                     index_offset=span_start,
                                     exact_certify=cfg.exact_certify_masks)
    phases["stage0_prune"] = time.perf_counter() - t0
    if cfg.exact_certify_masks:  # the host's exact mask pass, inside the prune
        phases["prune_exact_certify"] = prune.sv_time_s
    t0 = time.perf_counter()
    if stage0 is not None:  # precomputed by the stacked family kernels
        unsat0, sat0, witnesses = stage0[:3]
        if len(stage0) == 4:  # the family path forwarded its StageStats
            stage_stats.merge(stage0[3])
        witnesses = dict(witnesses)
    else:
        unsat0, sat0, witnesses = stage0_certify_and_attack(
            net, enc, lo, hi, cfg, stats=stage_stats, failed=failed,
            seed_offset=span_start, mesh=mesh)
    unsat0, sat0 = np.array(unsat0, dtype=bool), np.array(sat0, dtype=bool)
    phases["stage0_decide"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parity_col = parity_pass(net, prune, lo, hi, cfg, index_offset=span_start, mesh=mesh)
    phases["stage0_parity"] = time.perf_counter() - t0

    # The refinement tail: every stage-0 leftover goes through the deep PGD
    # attack + slab search, then the engine's BaB.
    pending = [p for p in range(P) if (span_start + p + 1) not in done
               and not sat0[p] and not unsat0[p] and p not in failed]
    pgd_covered_all = False
    if pending:
        t0 = time.perf_counter()
        pgd_wit, pgd_covered_all = stage0_pgd(
            net, enc, lo, hi, cfg, pending, span_start,
            lambda: cfg.hard_timeout_s - total())
        for p, ce in pgd_wit.items():
            sat0[p] = True
            witnesses[p] = ce
        pending = [p for p in pending if not sat0[p]]
        phases["stage0_pgd"] = time.perf_counter() - t0
    stage0_per_part = sum(phases.get(k, 0.0) for k in (
        "stage0_prune", "stage0_decide", "stage0_parity", "stage0_pgd")) / max(P, 1)
    bab: Dict[int, engine.Decision] = {}
    engine_decided: Dict[str, int] = {}
    if pending:
        hard_left = max(cfg.hard_timeout_s - total(), 1.0)
        deadline = min(cfg.soft_timeout_s * len(pending), hard_left)
        t0 = time.perf_counter()
        decisions = engine.decide_many(
            net, enc, lo[pending], hi[pending],
            replace(cfg.engine, device_bab=cfg.device_bab and cfg.engine.device_bab,
                    integrity=cfg.integrity and cfg.engine.integrity),
            deadline_s=deadline, mesh=mesh, attacked=pgd_covered_all)
        phases["bab"] = time.perf_counter() - t0
        bab = dict(zip(pending, decisions))
        for ph in ("t_attack", "t_sign", "t_lp", "t_bab", "t_pair", "t_lattice"):
            tot = sum(dd.stats.get(ph, 0.0) for dd in decisions)
            if tot > 0.0:
                phases[f"engine_{ph[2:]}"] = tot
        for dd in decisions:
            if dd.phase is not None:
                engine_decided[dd.phase] = engine_decided.get(dd.phase, 0) + 1
    if cfg.smt_retry_timeouts_s and total() <= cfg.hard_timeout_s and any(
            dd.verdict == "unknown" for dd in bab.values()):
        raise NotImplementedError(SMT_NOT_PORTED)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    cumulative = total()

    t_report = time.perf_counter()
    weights, biases = net.numpy_params()
    outcomes: List[PartitionOutcome] = []
    counts = {"sat": 0, "unsat": 0, "unknown": 0}
    counter = {"decided": 0, "stage0_decided": 0, "unknown": 0}
    ledger = JournalWriter(led_path, crc=cfg.integrity)
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
                funnel.add(funnel_mod.classify(
                    rec["verdict"], "ledger",
                    failure=(rec.get("failure") or {}).get("reason")))
                continue
            t_part = time.perf_counter()
            fail_rec = failed.get(p)
            dead = pruning.partition_masks(prune, p)
            h_attempt = h_success = 0
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
                if verdict == "unknown" and cumulative <= cfg.hard_timeout_s:
                    # Heuristic retry: kill borderline-quiet neurons and
                    # re-decide on the masked net (src/GC/Verify-GC.py:172-211).
                    h_attempt = 1
                    t_h = time.perf_counter()
                    _h_dead, merged = heur_ops.heuristic_prune(
                        [l[p] for l in prune.ws_lb], [l[p] for l in prune.ws_ub],
                        [l[p] for l in prune.candidates],
                        [l[p] for l in prune.surviving], dead,
                        cfg.heuristic_threshold)
                    dec2 = engine.decide_box(
                        mask_ops.apply_dead_masks(net, merged), enc, lo[p], hi[p],
                        replace(cfg.engine, soft_timeout_s=cfg.soft_timeout_s))
                    hv_time = dec2.elapsed_s
                    h_time = time.perf_counter() - t_h
                    nodes += dec2.nodes
                    if dec2.verdict != "unknown":
                        h_success = 1
                        verdict, ce = dec2.verdict, dec2.counterexample
                        # A SAT of the pruned net counts only if it replays
                        # on the original (the reference's V-accurate check).
                        if verdict == "sat" and not engine.validate_pair(
                                weights, biases, *ce):
                            verdict, ce, h_success = "unknown", None, 0
                    dead = merged
            c_check = v_accurate = 0
            if verdict == "sat":
                c_check, v_accurate = c_check_np(weights, biases, dead, ce)
            if h_attempt:  # masks changed after the parity pass
                pruned_acc = parity_resim(weights, biases, dead, cfg.seed, span_start + p,
                                          lo[p], hi[p], cfg.sim_size, device=dev)
            else:
                pruned_acc = float(parity_col[p])
            counts[verdict] += 1
            via_stage0 = bool(sat0[p] or unsat0[p]) and fail_rec is None
            if verdict != "unknown":
                counter["decided"] += 1
                counter["stage0_decided"] += int(via_stage0)
            else:
                counter["unknown"] += 1
            engine_reason = None
            if verdict == "unknown" and fail_rec is None and p in bab:
                engine_reason = bab[p].reason
            via = ("degraded" if fail_rec is not None else "stage0" if via_stage0
                   else "heuristic" if h_success else "bab")
            funnel.add(funnel_mod.classify(
                verdict, via, failure=fail_rec["reason"] if fail_rec else None,
                engine_reason=engine_reason))
            total_time = stage0_per_part + sv_time + (time.perf_counter() - t_part)
            cumulative += time.perf_counter() - t_part
            comp = {
                "b": mask_ops.compression_ratio([l[p] for l in prune.b_deads]),
                "s": mask_ops.compression_ratio([l[p] for l in prune.s_deads]),
                "st": mask_ops.compression_ratio([l[p] for l in prune.st_deads]),
                "h": mask_ops.compression_ratio(dead) if h_attempt else 0.0,
                "t": mask_ops.compression_ratio(dead),
            }
            outcomes.append(PartitionOutcome(
                pid, verdict, ce, h_attempt, h_success, nodes,
                times={"sv": sv_time, "s": stage0_per_part + sv_time, "hv": hv_time,
                       "h": h_time, "total": total_time},
                compressions=comp, c_check=c_check, v_accurate=v_accurate,
                pruned_acc=pruned_acc))
            csvio.append_row(csv_path, csvio.PartitionRow(
                partition_id=pid, verdict=verdict, sat_count=counts["sat"],
                unsat_count=counts["unsat"], unk_count=counts["unknown"],
                h_attempt=h_attempt, h_success=h_success,
                b_compression=comp["b"], s_compression=comp["s"],
                st_compression=comp["st"], h_compression=comp["h"],
                t_compression=comp["t"], sv_time=sv_time,
                s_time=stage0_per_part + sv_time, hv_time=hv_time, h_time=h_time,
                total_time=total_time, c_check=c_check, v_accurate=v_accurate,
                pruned_acc=pruned_acc, c1=ce[0] if ce else None,
                c2=ce[1] if ce else None))
            led_rec = {"partition_id": pid, "verdict": verdict,
                       "ce": [ce[0].tolist(), ce[1].tolist()] if ce else None,
                       "time_s": round(total_time, 4)}
            if fail_rec is not None:
                led_rec["failure"] = fail_rec
            if engine_reason is not None:
                led_rec["engine_reason"] = engine_reason
            ledger.append(led_rec)
            if ce is not None:
                _write_ce(ce_path, cfg.query().columns, pid, ce)
    finally:
        ledger.close()

    phases["report"] = time.perf_counter() - t_report
    elapsed = time.perf_counter() - t_run
    kernel_launches = {k: v - launches0[k] for k, v in launch_counts().items()}
    funnel_payload = {
        "states": funnel.to_dict(), "total": funnel.total,
        "decided": funnel.decided, "decided_fraction": funnel.decided_fraction,
        "margin_hist": stage_stats.to_payload() if stage_stats.boxes else None,
        "looseness": (None if prune.looseness is None
                      else [float(v) for v in prune.looseness]),
    }
    pps = counter["decided"] / max(elapsed, 1e-9)
    thr = {
        "elapsed_s": round(elapsed, 3), "decided": counter["decided"],
        "stage0_decided": counter["stage0_decided"],
        "bab_decided": counter["decided"] - counter["stage0_decided"],
        "engine_decided": engine_decided,
        "unknown": counter["unknown"], "partitions_per_sec": round(pps, 4),
        "partitions_per_sec_per_chip": round(pps / (1 if mesh is None else mesh.size), 4),
        "launches_per_model": sum(kernel_launches.values()),
        "kernel_launches": kernel_launches,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else "cpu")},
        "decided_fraction": round(float(funnel.decided_fraction), 6),
        "funnel": funnel.to_dict(),
        "phases_s": {k: round(v, 3) for k, v in phases.items()},
    }
    if funnel_payload["margin_hist"]:
        thr["margin_hist"] = funnel_payload["margin_hist"]
    if funnel_payload["looseness"] is not None:
        thr["looseness"] = [round(v, 3) for v in funnel_payload["looseness"]]
    degraded = sum(1 for p in failed if (span_start + p + 1) not in done)
    if degraded or led_skipped:
        thr["resilience"] = {"degraded": degraded, "ledger_skipped_lines": led_skipped}
    with open(os.path.join(cfg.result_dir,
                           f"{cfg.name}-{sink_name}.throughput.json"), "w") as fp:
        json.dump(thr, fp, indent=1)
    return ModelReport(model=model_name, dataset=cfg.dataset, outcomes=outcomes,
                       total_time_s=elapsed, partitions_total=P,
                       sink_name=sink_name, ledger_skipped_lines=led_skipped,
                       degraded=degraded, funnel=funnel_payload,
                       kernel_launches=kernel_launches)
