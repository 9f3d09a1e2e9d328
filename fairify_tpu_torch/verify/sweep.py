"""The partition sweep, stage-0 slice: grid → prune → certify + attack →
parity → ledger.

Port of the stage-0 path of ``fairify_tpu/verify/sweep.py:verify_model``
(the mega path: ``mega_chunks > 0``, CROWN certificates, no mesh):

* **Prune pass** — :func:`verify.pruning.sound_prune_grid`, one KA launch
  per segment (``csrc/sim_and_bounds.cu``).
* **Stage 0** — per segment of ``mega_chunks`` grid chunks, one KB launch
  (certificate, ``csrc/stage0_certify.cu``) and one KC launch (attack,
  flips, histograms, fold, ``csrc/attack_flips.cu``) over the stacked
  chunks plus the integrity canary chunk; the host checks the fold and the
  canary, then replays every flip exactly before it counts as SAT.
* **Parity pass** — one KD launch per segment (``csrc/parity.cu``).
* **Reporting** — CRC-checked JSONL ledger, the 24-column CSV, the
  counterexample CSV and the throughput JSON, as the JAX package writes
  them.

Launches run synchronously (the async pipeline, supervisor and obs spans
are ROADMAP queue 1, item 7).  Partitions stage 0 leaves undecided are
ledgered ``unknown`` with ``engine_reason: refinement_not_ported``: the
refinement tail (PGD, BaB, lattice, LP, SMT) is not ported yet.
"""
from __future__ import annotations

import csv
import ctypes
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from fairify_tpu_torch.models.mlp import predict_np
from fairify_tpu_torch.obs import funnel as funnel_mod
from fairify_tpu_torch.ops import masks as mask_ops
from fairify_tpu_torch.ops.simulate import PLAIN_ROWS, mean_scale
from fairify_tpu_torch.partition import grid as grid_mod
from fairify_tpu_torch.resilience import integrity as integrity_mod
from fairify_tpu_torch.resilience.journal import JournalWriter
from fairify_tpu_torch.utils import cuda_build
from fairify_tpu_torch.utils.num import resolve_device
from fairify_tpu_torch.utils.prng import grid_keys, shuffled_order, simulate_boxes
from fairify_tpu_torch.verify import csvio, engine, pruning
from fairify_tpu_torch.verify.config import SweepConfig
from fairify_tpu_torch.verify.property import PairEncoding, encode, role_boxes

NOT_PORTED_REASON = "refinement_not_ported"


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


def check_supported(cfg: SweepConfig, mesh=None) -> None:
    """Reject every configuration the stage-0 slice does not run.

    Each message names the ROADMAP item that will port it; nothing is
    silently ignored.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded sweeps are not ported yet: ROADMAP queue 1, item 8")
    if cfg.mega_chunks <= 0:
        raise NotImplementedError(
            "mega_chunks=0 (the per-chunk launch loop) is not ported yet: "
            "ROADMAP queue 2, K10")
    if not cfg.engine.use_crown:
        raise NotImplementedError(
            "use_crown=False (the IBP stage-0 path) is not ported yet: "
            "ROADMAP queue 2, K10")
    if cfg.exact_certify_masks:
        raise NotImplementedError(pruning.EXACT_CERTIFY_NOT_PORTED)
    if cfg.inject_faults:
        raise NotImplementedError(
            "fault injection is not ported yet: ROADMAP queue 1, item 7")
    if cfg.integrity_recheck > 0.0:
        raise NotImplementedError(
            "the sampled integrity recheck is not ported yet: ROADMAP queue 1, "
            "item 7")


# ---------------------------------------------------------------------------
# Stage 0: certify + attack per segment (KB + KC)
# ---------------------------------------------------------------------------


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
    ``csum`` — with C the real chunks plus the canary.
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
    cert, margin = engine.stage0_certify(
        net, flat(x_lo), flat(x_hi), flat(xp_lo), flat(xp_hi), flat(plo),
        flat(phi), on_dev(av), on_dev(pm), on_dev(rm), float(enc.eps),
        valid_t, vpair)
    wit, reason, _gap, stats, fold = engine.attack_flips(
        net, flat(xr), flat(pr), valid_t, vpair, cert, margin, on_dev(ok))
    host = {"cert": cert.reshape(C, P).cpu().numpy(),
            "wit": wit.reshape(C, P, 3).cpu().numpy(),
            "reason": reason.reshape(C, P).cpu().numpy(),
            "stats": stats.cpu().numpy()}
    if cfg.integrity:
        host["csum"] = np.int32(fold)
    return host, {"chunks": chunks, "xr": xr, "pr": pr}


def mega_segment_decode(host, ctx, weights, biases):
    """Per-chunk ``(unsat, sat, witnesses)``: flips (``reason >= 2``) count
    as SAT only after their exact ``validate_pair`` replay."""
    cert, wit, reason = host["cert"], host["wit"], host["reason"]
    out = []
    for ci in range(len(ctx["chunks"])):
        found = reason[ci] >= 2
        witnesses = engine.extract_witnesses(
            found, wit[ci], ctx["xr"][ci], ctx["pr"][ci],
            weights, biases) if found.any() else {}
        sat = np.zeros(cert.shape[1], dtype=bool)
        sat[list(witnesses)] = True
        out.append((cert[ci], sat, witnesses))
    return out


def integrity_failure(detector: str) -> dict:
    """Failure record of a segment whose fold or canary check tripped (the
    JAX package's ``ChunkFailure.to_record`` layout): its partitions land
    in ``unknown:failure:integrity.launch.decode`` and a resume re-attempts
    them."""
    site = "integrity.launch.decode"
    return {"reason": f"{site}:fatal", "site": site, "kind": "fatal",
            "error": "IntegrityViolation",
            "detail": f"{detector} mismatch (launch.decode)", "retries": 0}


def stage0_certify_and_attack(net, enc: PairEncoding, lo, hi, cfg: SweepConfig,
                              stats, failed):
    """Root certificates + attack for the whole grid, one segment at a time.

    Returns ``(unsat (P,), sat (P,), witnesses {p: (x, x')})``; ``stats``
    (an ``obs.funnel.StageStats``) accumulates the device histograms;
    ``failed`` (dict) receives the failure record of every partition of a
    segment whose fold or canary check trips.
    """
    P = lo.shape[0]
    step, segs = grid_mod.segment_spans(P, cfg.grid_chunk, cfg.mega_chunks)
    weights, biases = net.numpy_params()
    unsat = np.zeros(P, dtype=bool)
    sat = np.zeros(P, dtype=bool)
    witnesses: Dict[int, tuple] = {}
    for seg_s, seg_e, chunks in segs:
        host, ctx = mega_segment(net, enc, lo, hi, cfg, chunks, step, 0)
        if cfg.integrity:
            tripped = integrity_mod.verify_segment(host)
            if tripped is not None:
                rec = integrity_failure(tripped)
                failed.update({i: rec for i in range(seg_s, seg_e)})
                continue
        stats.add_packed(host["stats"])
        for (s, e), (u, sa, w) in zip(chunks, mega_segment_decode(host, ctx, weights,
                                                                  biases)):
            unsat[s:e], sat[s:e] = u[: e - s], sa[: e - s]
            witnesses.update({s + k: v for k, v in w.items() if k < e - s})
    return unsat, sat, witnesses


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


def parity(net, keys, lo, hi, alive, sim_size: int):
    """KD: pruned-vs-original parity of N partitions, one launch.  CPU
    tensors take :func:`parity_plain`; CUDA tensors launch
    ``csrc/parity.cu``."""
    if lo.device.type == "cpu":
        return parity_plain(net, keys, lo, hi, alive, sim_size)
    params, dims = cuda_build.pack_net(net)
    k32 = cuda_build.u32_keys(keys)
    lo, hi = lo.contiguous(), hi.contiguous()
    N = lo.shape[0]
    al = (torch.cat([a.to(torch.float32) for a in alive], dim=1).contiguous()
          if alive else torch.zeros((N, 0), dtype=torch.float32, device=lo.device))
    cuda_build.require_cuda(params, k32, lo, hi, al)
    out = torch.empty(N, dtype=torch.float32, device=lo.device)
    cuda_build.call("parity", "kd_parity", cuda_build.ptr(params), dims,
                    ctypes.c_int(net.depth), cuda_build.ptr(k32), cuda_build.ptr(lo),
                    cuda_build.ptr(hi), cuda_build.ptr(al), ctypes.c_int(al.shape[1]),
                    ctypes.c_int(N), ctypes.c_int(sim_size), cuda_build.ptr(out),
                    cuda_build.stream())
    parity.launches += 1
    return out


parity.launches = 0

KERNELS = {
    "sim_and_bounds": pruning.sim_and_bounds,
    "stage0_certify": engine.stage0_certify,
    "attack_flips": engine.attack_flips,
    "parity": parity,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def parity_pass(net, prune, lo, hi, cfg: SweepConfig):
    """The grid's parity column, one KD launch per segment."""
    P = lo.shape[0]
    dev = net.device
    out = np.zeros(P, dtype=np.float32)
    _, segs = grid_mod.segment_spans(P, cfg.grid_chunk, cfg.mega_chunks)
    for seg_s, seg_e, _chunks in segs:
        keys = grid_keys(cfg.seed, seg_s, seg_e - seg_s, device=dev)
        alive = [torch.as_tensor(1.0 - d[seg_s:seg_e], dtype=torch.float32,
                                 device=dev) for d in prune.st_deads[:-1]]
        as_f32 = lambda a: torch.as_tensor(np.asarray(a[seg_s:seg_e], np.float32),
                                           device=dev)
        out[seg_s:seg_e] = parity(net, keys, as_f32(lo), as_f32(hi), alive,
                                  cfg.sim_size).cpu().numpy()
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


def verify_model(net, cfg: SweepConfig, model_name: str = "model",
                 resume: bool = True, mesh=None, device=None) -> ModelReport:
    """Run the stage-0 sweep for one model; write CSV + ledger rows.

    ``device`` defaults to ``cuda`` (``device="cpu"`` runs the plain PyTorch
    versions of the kernels); the net is moved there.  Configurations the
    slice does not run raise ``NotImplementedError`` (:func:`check_supported`).
    """
    check_supported(cfg, mesh)
    dev = resolve_device(device)
    net = net.to(dev)
    t_run = time.perf_counter()
    phases: Dict[str, float] = {}
    launches0 = launch_counts()
    enc = encode(cfg.query())
    p_list, lo, hi = build_partitions(cfg)
    P = len(p_list)
    os.makedirs(cfg.result_dir, exist_ok=True)
    led_path = ledger_path(cfg, model_name)
    done, led_skipped = {}, 0
    if resume:
        done, _degraded_prev, led_skipped = merge_ledgers([led_path])
    csv_path = os.path.join(cfg.result_dir, f"{model_name}.csv")
    ce_path = os.path.join(cfg.result_dir, f"{model_name}-counterexamples.csv")
    stage_stats = funnel_mod.StageStats()
    funnel = funnel_mod.FunnelCounts()
    failed: Dict[int, dict] = {}

    t0 = time.perf_counter()
    prune = pruning.sound_prune_grid(net, lo, hi, cfg.sim_size, cfg.seed,
                                     chunk=cfg.grid_chunk, mega_chunks=cfg.mega_chunks)
    phases["stage0_prune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    unsat0, sat0, witnesses = stage0_certify_and_attack(
        net, enc, lo, hi, cfg, stats=stage_stats, failed=failed)
    phases["stage0_decide"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parity_col = parity_pass(net, prune, lo, hi, cfg)
    phases["stage0_parity"] = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stage0_per_part = sum(phases.values()) / max(P, 1)

    t_report = time.perf_counter()
    weights, biases = net.numpy_params()
    outcomes: List[PartitionOutcome] = []
    counts = {"sat": 0, "unsat": 0, "unknown": 0}
    counter = {"decided": 0, "stage0_decided": 0, "unknown": 0}
    ledger = JournalWriter(led_path, crc=cfg.integrity)
    try:
        for p in range(P):
            pid = p + 1
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
            ce = None
            engine_reason = None
            if fail_rec is not None:
                verdict = "unknown"
            elif sat0[p]:
                verdict, ce = "sat", witnesses[p]
            elif unsat0[p]:
                verdict = "unsat"
            else:
                verdict, engine_reason = "unknown", NOT_PORTED_REASON
            c_check = v_accurate = 0
            if verdict == "sat":
                c_check, v_accurate = c_check_np(weights, biases, dead, ce)
            counts[verdict] += 1
            via_stage0 = bool(sat0[p] or unsat0[p]) and fail_rec is None
            if verdict != "unknown":
                counter["decided"] += 1
                counter["stage0_decided"] += int(via_stage0)
            else:
                counter["unknown"] += 1
            via = "degraded" if fail_rec is not None else "stage0"
            funnel.add(funnel_mod.classify(
                verdict, via, failure=fail_rec["reason"] if fail_rec else None,
                engine_reason=engine_reason))
            total_time = stage0_per_part + (time.perf_counter() - t_part)
            comp = {
                "b": mask_ops.compression_ratio([l[p] for l in prune.b_deads]),
                "s": mask_ops.compression_ratio([l[p] for l in prune.s_deads]),
                "st": mask_ops.compression_ratio([l[p] for l in prune.st_deads]),
                "h": 0.0,
                "t": mask_ops.compression_ratio(dead),
            }
            pruned_acc = float(parity_col[p])
            outcomes.append(PartitionOutcome(
                pid, verdict, ce, times={"sv": 0.0, "s": stage0_per_part, "hv": 0.0,
                                         "h": 0.0, "total": total_time},
                compressions=comp, c_check=c_check, v_accurate=v_accurate,
                pruned_acc=pruned_acc))
            csvio.append_row(csv_path, csvio.PartitionRow(
                partition_id=pid, verdict=verdict, sat_count=counts["sat"],
                unsat_count=counts["unsat"], unk_count=counts["unknown"],
                b_compression=comp["b"], s_compression=comp["s"],
                st_compression=comp["st"], h_compression=comp["h"],
                t_compression=comp["t"], s_time=stage0_per_part,
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
        "stage0_decided": counter["stage0_decided"], "bab_decided": 0,
        "unknown": counter["unknown"], "partitions_per_sec": round(pps, 4),
        "partitions_per_sec_per_chip": round(pps, 4),
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
    degraded = sum(1 for p in failed if (p + 1) not in done)
    if degraded or led_skipped:
        thr["resilience"] = {"degraded": degraded, "ledger_skipped_lines": led_skipped}
    with open(os.path.join(cfg.result_dir,
                           f"{cfg.name}-{model_name}.throughput.json"), "w") as fp:
        json.dump(thr, fp, indent=1)
    return ModelReport(model=model_name, dataset=cfg.dataset, outcomes=outcomes,
                       total_time_s=elapsed, partitions_total=P,
                       sink_name=model_name, ledger_skipped_lines=led_skipped,
                       degraded=degraded, funnel=funnel_payload,
                       kernel_launches=kernel_launches)
