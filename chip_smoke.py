#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``fairify_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):

1. Environment and build: the card's name and power limit, the TF32-off
   numeric policy, and the nvcc build of every kernel in
   ``fairify_tpu_torch/csrc`` (build seconds, ptxas register/spill report).
2. Kernel vs plain version: each of KA (sim_and_bounds), KB
   (stage0_certify), KC (attack_flips) and KD (parity) runs on the card
   at the shapes the main path gives it — the GC grid (201 partitions,
   GC-1 twin 20-50-1) and one segment of the AC grid (16,000 partitions,
   AC-S1 widths 13-128-64-32-16-8-1, seeded weights) — and is held
   against its plain PyTorch version on the same inputs; times are CUDA
   events, bounds are reckoned from each call's flops and bytes.  One
   segment of the relaxed-AC grid (ε = 5 on age, 5 race assignments)
   covers the kernels' relaxed-attribute terms.
3. End to end: ``verify_model`` on the GC-1 twin with the GC preset and
   the bench's engine settings; requires sat=2 unsat=199 unknown=0, every
   ledger row CRC-valid, every SAT witness exact, and a launch of every
   kernel during the run.
4. Real size: the full AC grid through prune, stage 0 and parity.

The next-to-last lines are the kernel table as one JSON object and the
``nvidia-smi`` name/power line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

REPLACES = {
    "sim_and_bounds": "fairify_tpu/verify/pruning.py:76",
    "stage0_certify": "fairify_tpu/verify/sweep.py:812",
    "attack_flips": "fairify_tpu/verify/sweep.py:812",
    "parity": "fairify_tpu/verify/sweep.py:1403",
}
SOURCES = {k: f"fairify_tpu_torch/csrc/{k}.cu" for k in REPLACES}
AC_SIZES = (13, 128, 64, 32, 16, 8, 1)  # models_scaled/adult/AC-S1.h5 widths


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int):
    """(result, median ms) of ``fn()`` over ``reps`` CUDA-event-timed runs
    after one warm-up run."""
    import torch

    res = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return res, sorted(times)[len(times) // 2]


# Kernel vs plain version on the card: the two sum in different orders, so
# f32 values (bounds, margins, gaps, logits of O(1)) agree to
# TOL_REL * |v| + TOL_ABS; discrete outputs must be equal except where the
# value that decides them lies on a threshold within that tolerance.
TOL_REL, TOL_ABS = 1e-4, 1e-5


def tol_ratio(got, want, scale=None) -> float:
    """Largest |got - want| as a multiple of the tolerance
    TOL_REL * max(|want|, scale) + TOL_ABS (<= 1 passes)."""
    import torch

    if got.numel() == 0:
        return 0.0
    mag = want.abs() if scale is None else torch.maximum(want.abs(), scale)
    return float(((got - want).abs() / (TOL_REL * mag + TOL_ABS)).max())


def macs(sizes) -> int:
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def bound(flops: float, nbytes: float):
    t_ops, t_mem = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def crown_flops(sizes) -> int:
    """fp32 flops of one role box's CROWN bounds + output forms (KB), an
    FMA counted as 2.  IBP: 4 FMAs per weight.  Each step of layer k's
    backward pass through layer j, with a (rows x cols) coefficient matrix:
    the relaxation, 6 FMAs and 2 products per coefficient, and the product
    with W_j, 2 * in_j * rows * cols FMAs.  The concretization over the
    role box: 4 FMAs per (input, column)."""
    d, outs = sizes[0], sizes[1:]
    ins = sizes[:-1]
    total = sum(8 * a * b for a, b in zip(ins, outs))
    for k in range(1, len(outs)):
        cols = outs[k]
        for j in range(k - 1, -1, -1):
            rows = outs[j]
            total += 14 * rows * cols + 4 * ins[j] * rows * cols
        total += 8 * d * cols
    return total


def forward_near(net, x, masks):
    """Per layer, where the forward of ``x`` (..., d) under ``masks`` has a
    pre-activation within tolerance of 0: ``|z| <= TOL_REL * (|h| @ |W| +
    |b|) + TOL_ABS``, the scale of the sum's f32 rounding.  Only there may
    a kernel and its plain version, which sum in different orders, disagree
    on the sign of z."""
    import torch

    h, near = x, []
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases, masks)):
        z = h @ w + b
        near.append(z.abs() <= TOL_REL * (h.abs() @ w.abs() + b.abs()) + TOL_ABS)
        h = z if i == net.depth - 1 else torch.relu(z) * m
    return near


def sample_near(net, keys, lo, hi, sim_size: int, alive=None):
    """Near-zero counts over each partition's simulation samples.

    Without ``alive``: per layer, (N, n_l) counts of samples whose
    pre-activation in the net's own forward lies near 0 (KA's activation
    counts may differ by at most that).  With ``alive``: (N,) counts of
    samples on which the original or the alive-masked logit lies near 0
    (KD's agreement counts may differ by at most that)."""
    import torch

    from fairify_tpu_torch.ops.simulate import PLAIN_ROWS
    from fairify_tpu_torch.utils.prng import simulate_boxes

    parts = []
    for s in range(0, lo.shape[0], PLAIN_ROWS):
        e = s + PLAIN_ROWS
        sim = simulate_boxes(keys[s:e], lo[s:e], hi[s:e], sim_size)
        near = forward_near(net, sim, list(net.masks))
        if alive is None:
            parts.append([n.sum(dim=1) for n in near])
            continue
        masked = [a[s:e, None, :] for a in alive] + [net.masks[-1]]
        either = near[-1] | forward_near(net, sim, masked)[-1]
        parts.append(either[..., 0].sum(dim=1))
    if alive is not None:
        return torch.cat(parts)
    return [torch.cat([p[l] for p in parts]) for l in range(net.depth)]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def case_inputs(name: str, net, cfg):
    """The main path's own inputs for one prune/stage-0/parity segment."""
    import numpy as np
    import torch

    from fairify_tpu_torch.partition import grid as grid_mod
    from fairify_tpu_torch.utils.prng import grid_keys
    from fairify_tpu_torch.verify import engine, sweep
    from fairify_tpu_torch.verify.property import encode

    enc = encode(cfg.query())
    _, lo, hi = sweep.build_partitions(cfg)
    step, segs = grid_mod.segment_spans(len(lo), cfg.grid_chunk, cfg.mega_chunks)
    seg_s, seg_e, chunks = segs[0]
    dev = net.device
    n = seg_e - seg_s
    ka = dict(keys=grid_keys(cfg.seed, seg_s, n, device=dev),
              lo=torch.as_tensor(lo[seg_s:seg_e].astype(np.float32), device=dev),
              hi=torch.as_tensor(hi[seg_s:seg_e].astype(np.float32), device=dev),
              ok=torch.ones(n, dtype=torch.bool, device=dev))
    (x_lo, x_hi, xp_lo, xp_hi, plo, phi, valid, xr, pr,
     nv) = sweep.mega_chunk_inputs(enc, lo, hi, cfg, chunks, step, 0, canary=True)
    C, P = valid.shape[:2]
    flat = lambda a: torch.as_tensor(a.reshape((C * P,) + a.shape[2:]), device=dev)
    av, pm, rm = engine.enc_tensors(enc, lo.shape[1])
    on = lambda a: torch.as_tensor(a, device=dev)
    kb = dict(x_lo=flat(x_lo), x_hi=flat(x_hi), xp_lo=flat(xp_lo), xp_hi=flat(xp_hi),
              lo=flat(plo), hi=flat(phi), assign_vals=on(av), pa_mask=on(pm),
              ra_mask=on(rm), eps=float(enc.eps), valid=flat(valid),
              valid_pair=on(enc.valid_pair))
    ok = on((np.arange(P)[None, :] < nv[:, None]).reshape(-1))
    kc = dict(xr=flat(xr), pr=flat(pr), valid=kb["valid"], valid_pair=kb["valid_pair"],
              ok=ok)
    return dict(name=name, ka=ka, kb=kb, kc=kc, n_prune=n, n_boxes=C * P,
                S=cfg.engine.attack_samples, V=enc.n_assign, sim=cfg.sim_size)


def check_kernels(case, net, reps: int):
    """Run KA–KD and their plain versions on one case; returns per-kernel rows."""
    import torch

    from fairify_tpu_torch.obs import funnel as funnel_mod
    from fairify_tpu_torch.ops import masks as mask_ops
    from fairify_tpu_torch.verify import engine, pruning, sweep

    sizes = [net.in_dim] + list(net.layer_sizes)
    nsum, L, d = sum(sizes[1:]), len(sizes) - 1, sizes[0]
    pbytes = 4 * (macs(sizes) + 2 * nsum)
    rows = {}
    ka, kb, kc, S_sim = case["ka"], case["kb"], case["kc"], case["sim"]

    # --- KA
    k_out, k_ms = timed(lambda: pruning.sim_and_bounds(net, ka["keys"], ka["lo"],
                                                      ka["hi"], ka["ok"], S_sim), reps)
    p_out, p_ms = timed(lambda: pruning.sim_and_bounds_plain(
        net, ka["keys"], ka["lo"], ka["hi"], ka["ok"], S_sim), 1)
    cand_k, pos_k, lb_k, ub_k, loos_k = k_out
    cand_p, pos_p, lb_p, ub_p, loos_p = p_out
    err_pos = max(float((a - b).abs().max()) for a, b in zip(pos_k, pos_p))
    # Activation counts (pos_prob * S, exact in f32) must be equal except
    # for samples whose pre-activation lies within tolerance of 0; the
    # candidate masks must be the counts' own zeros on both sides.
    near = sample_near(net, ka["keys"], ka["lo"], ka["hi"], S_sim)
    count = lambda pos: [torch.round(p * S_sim) for p in pos]
    cnt_k, cnt_p = count(pos_k), count(pos_p)
    cnt_bad = sum(int(((a - b).abs() > n).sum()) for a, b, n in zip(cnt_k, cnt_p, near))
    cand_bad = sum(int((c != (n == 0).to(c.dtype)).sum())
                   for cs, ns in ((cand_k, cnt_k), (cand_p, cnt_p))
                   for c, n in zip(cs, ns))
    # Bounds: TOL_REL of the neuron's interval magnitude (sign-split sums
    # cancel on wide boxes; the widening slack is taken on the same scale).
    err_b = max(tol_ratio(a, b, torch.maximum(lo.abs(), hi.abs()))
                for a, b, lo, hi in zip(lb_k + ub_k, lb_p + ub_p, lb_p + lb_p,
                                        ub_p + ub_p))
    err_abs_b = max(float((a - b).abs().max()) for a, b in zip(lb_k + ub_k, lb_p + ub_p))
    if cnt_bad or cand_bad or err_b > 1.0:
        fail(f"KA {case['name']}: activation counts off by more than their "
             f"near-zero samples on {cnt_bad} neurons, candidates inconsistent "
             f"with counts on {cand_bad}, bound error {err_b} x tolerance")
    n = case["n_prune"]
    fl = 2 * n * S_sim * macs(sizes) + 8 * n * macs(sizes)
    by = n * (8 + 8 * d) + pbytes + n * (16 * nsum + 4 * L)
    rows["sim_and_bounds"] = dict(max_abs_err=max(err_pos, err_abs_b), ms=k_ms,
                                  plain_ms=p_ms, flops=fl, bytes=by,
                                  near_diffs=sum(int((a != b).sum())
                                                 for a, b in zip(cnt_k, cnt_p)))

    # --- KB
    (cert_k, margin_k), kb_ms = timed(lambda: engine.stage0_certify(net, **kb), reps)
    (cert_p, margin_p), kbp_ms = timed(lambda: engine.certify_impl(net, **kb), 1)
    # The margin is a difference of sums whose terms reach the tied bound's
    # magnitude (the scale the certificate's own slack is taken against), so
    # it agrees to TOL_REL of that magnitude, not of its own value.
    _, _, scale = engine.certify_impl(net, **kb, with_scale=True)
    big = margin_p.abs() >= 3e38
    err_m = tol_ratio(margin_k[~big], margin_p[~big], scale[~big])
    # The certificate is the sign of the margin: a disagreement is allowed
    # only where the margin sits on 0 to within the stated tolerance.
    near0 = margin_p.abs() <= TOL_REL * torch.maximum(margin_p.abs(), scale) + TOL_ABS
    cert_bad = int(((cert_k != cert_p) & ~near0).sum())
    if err_m > 1.0 or cert_bad or not torch.equal(big, margin_k.abs() >= 3e38):
        fail(f"KB {case['name']}: margin error {err_m} x tolerance, "
             f"certificate mismatches away from 0: {cert_bad}")
    nb, V = case["n_boxes"], case["V"]
    # Per box: 2V role boxes' CROWN passes, the forms' six d-long sums, and
    # the V x V pair stage (12 flops per pair and coordinate).
    fl = nb * 2 * V * (crown_flops(sizes) + 12 * d) + nb * V * V * 12 * d
    by = nb * (4 * V * d * 4 + 2 * d * 4 + V + 5) + pbytes
    rows["stage0_certify"] = dict(max_abs_err=float((margin_k - margin_p)[~big].abs().max())
                                  if (~big).any() else 0.0,
                                  ms=kb_ms, plain_ms=kbp_ms, flops=fl, bytes=by,
                                  near_diffs=int((cert_k != cert_p).sum()))

    # --- KC (fed the plain certificate so both sides see identical inputs)
    args = (kc["xr"], kc["pr"], kc["valid"], kc["valid_pair"], cert_p, margin_p, kc["ok"])
    k_res, kc_ms = timed(lambda: engine.attack_flips(net, *args), reps)
    p_res, kcp_ms = timed(lambda: engine.attack_flips_plain(net, *args), 1)
    wit_k, reason_k, gap_k, stats_k, fold_k = k_res
    wit_p, reason_p, gap_p, stats_p, fold_p = p_res
    # Gaps are logits: they agree to TOL_REL of the box's largest |logit|.
    lx, lp = engine.attack_logits(net, kc["xr"], kc["pr"])
    lscale = torch.maximum(lx.abs().amax(dim=(1, 2)), lp.abs().amax(dim=(1, 2)))
    err_g = tol_ratio(gap_k, gap_p, lscale)
    # A box's witness (and so its reason) may differ only where a logit of
    # the pair that decides it lies near 0: the earlier of the two sides'
    # first hits, where one side sees a strict flip and the other does not.
    diff = (wit_k != wit_p).any(dim=1) | (reason_k != reason_p)
    wit_bad = 0
    if diff.any():
        near_x = forward_near(net, kc["xr"], list(net.masks))[-1][..., 0]
        near_p = forward_near(net, kc["pr"], list(net.masks))[-1][..., 0]
        flat = lambda w, r: torch.where(r >= 2, (w[:, 0] * V + w[:, 1]) * V + w[:, 2],
                                        torch.iinfo(torch.int32).max)
        first = torch.where((flat(wit_k, reason_k) <= flat(wit_p, reason_p))[:, None],
                            wit_k, wit_p).long()
        rows_ = torch.arange(first.shape[0], device=first.device)
        decided_near = (near_x[rows_, first[:, 0], first[:, 1]]
                        | near_p[rows_, first[:, 0], first[:, 2]])
        wit_bad = int((diff & ~decided_near).sum())
    # The histogram is the kernel's own margins and gaps bucketed exactly;
    # it may differ from the plain one only through a gap near an edge.
    stats_own = engine.chunk_stats(margin_p, gap_k, kc["ok"])
    edges = torch.as_tensor(funnel_mod.EDGES, device=gap_p.device)
    bucket = lambda v: (v[:, None] >= edges[None, :]).sum(dim=1)
    tol_gap = TOL_REL * torch.maximum(gap_p.abs(), lscale) + TOL_ABS
    moved = (bucket(gap_k) != bucket(gap_p)) & kc["ok"]
    off_edge = (gap_p[:, None] - edges[None, :]).abs().amin(dim=1) > tol_gap
    edge_bad = int((moved & off_edge).sum())
    # The fold is the kernel's own buffers folded with wraparound.
    fold_own = engine.fold_int32(cert_p, wit_k, reason_k, stats_k)
    if (err_g > 1.0 or wit_bad or edge_bad or not torch.equal(stats_k, stats_own)
            or fold_k != fold_own):
        fail(f"KC {case['name']}: gap error {err_g} x tolerance, witness/reason "
             f"mismatches away from a zero logit {wit_bad}, buckets moved away "
             f"from an edge {edge_bad}, stats match own buckets "
             f"{torch.equal(stats_k, stats_own)}, fold {fold_k} vs own "
             f"{fold_own} vs plain {fold_p}")
    S = case["S"]
    fl = 2 * nb * 2 * S * V * macs(sizes)
    by = nb * (2 * S * V * d * 4 + V + 6 + 12 + 1 + 4) + pbytes
    rows["attack_flips"] = dict(max_abs_err=float((gap_k - gap_p).abs().max()),
                                ms=kc_ms, plain_ms=kcp_ms, flops=fl, bytes=by,
                                near_diffs=int(diff.sum()))

    # --- KD (alive masks from the KA bound-dead masks, as the sweep does)
    ibp_dead = [(u <= 0).to(torch.float32) for u in ub_p[:-1]]
    dead = mask_ops.keep_one_alive([(c * dd).cpu().numpy()
                                    for c, dd in zip(cand_p[:-1], ibp_dead)])
    alive = [torch.as_tensor(1.0 - dd, device=net.device) for dd in dead]
    par_k, kd_ms = timed(lambda: sweep.parity(net, ka["keys"], ka["lo"], ka["hi"],
                                              alive, S_sim), reps)
    par_p, kdp_ms = timed(lambda: sweep.parity_plain(net, ka["keys"], ka["lo"],
                                                     ka["hi"], alive, S_sim), 1)
    err_par = float((par_k - par_p).abs().max())
    # Agreement counts (parity * S) must be equal except for samples whose
    # original or masked logit lies within tolerance of 0.
    near_par = sample_near(net, ka["keys"], ka["lo"], ka["hi"], S_sim, alive)
    par_bad = int(((torch.round(par_k * S_sim) - torch.round(par_p * S_sim)).abs()
                   > near_par).sum())
    if par_bad:
        fail(f"KD {case['name']}: agreement counts off by more than their "
             f"near-zero logits on {par_bad} partitions (max err {err_par})")
    # Two forwards per sample that share layer 0's pre-activation.
    fl = 2 * n * S_sim * (2 * macs(sizes) - sizes[0] * sizes[1])
    by = n * (8 + 8 * d + 4 * (nsum - 1) + 4) + pbytes
    rows["parity"] = dict(max_abs_err=err_par, ms=kd_ms, plain_ms=kdp_ms,
                          flops=fl, bytes=by, near_diffs=int((par_k != par_p).sum()))
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r["flops"], r["bytes"])
        print(f"[kernel {case['name']}] {name}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, max_abs_err {r['max_abs_err']:.3g}, discrete "
              f"outputs differing near a threshold {r['near_diffs']})", flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phases 3 and 4: the sweep through the kernels
# ---------------------------------------------------------------------------


def run_sweep(net, cfg, model_name: str):
    """verify_model with every launch count zeroed just before; returns
    (report, launch counts, wall seconds)."""
    import torch

    from fairify_tpu_torch.verify import sweep

    shutil.rmtree(cfg.result_dir, ignore_errors=True)
    torch.cuda.synchronize()
    sweep.reset_launches()
    t0 = time.perf_counter()
    rep = sweep.verify_model(net, cfg, model_name=model_name, resume=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = sweep.launch_counts()
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"{model_name}: kernels never launched on the main path: {missing}")
    return rep, counts, wall


def check_outputs(rep, cfg, net, model_name: str, counts: dict) -> dict:
    """Ledger rows CRC-valid and complete; every SAT witness exact; the
    throughput record's launches those counted in ``counts``.  Returns the
    throughput record."""
    import numpy as np

    from fairify_tpu_torch.resilience import integrity
    from fairify_tpu_torch.verify import engine, sweep

    path = sweep.ledger_path(cfg, model_name)
    with open(path) as fp:
        recs = [json.loads(line) for line in fp if line.strip()]
    good, bad = integrity.verify_records(recs)
    if bad or len(good) != rep.partitions_total or any("_crc" not in r for r in recs):
        fail(f"{model_name}: ledger rows {len(recs)}, CRC-invalid {bad}")
    weights, biases = net.numpy_params()
    for o in rep.outcomes:
        if o.verdict == "sat":
            x, xp = (np.asarray(c, dtype=np.int64) for c in o.counterexample)
            if not engine.validate_pair(weights, biases, x, xp):
                fail(f"{model_name}: SAT witness of partition {o.partition_id} "
                     "fails its exact replay")
    thr = os.path.join(cfg.result_dir, f"{cfg.name}-{model_name}.throughput.json")
    with open(thr) as fp:
        t = json.load(fp)
    if (not np.isfinite(t["partitions_per_sec"]) or t["device"]["platform"] != "gpu"
            or t["kernel_launches"] != counts
            or t["launches_per_model"] != sum(counts.values())):
        fail(f"{model_name}: bad throughput record {t} (launches counted {counts})")
    return t


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from fairify_tpu_torch.models.mlp import flagship_net, seeded_net
    from fairify_tpu_torch.utils import cuda_build, num
    from fairify_tpu_torch.verify import presets
    from fairify_tpu_torch.verify.config import EngineConfig

    # --- phase 1
    smi = smi_line()
    print(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    num.check_policy()
    info = cuda_build.build_all()
    print(f"[build] {len(cuda_build.SOURCES)} libraries in {info['seconds']:.2f} s "
          f"(compiled {info['compiled']})", flush=True)
    for name, log in info["ptxas"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")

    # --- phase 2
    engine_cfg = EngineConfig(frontier_size=512, attack_samples=128,
                              bab_attack_samples=16, soft_timeout_s=10.0)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    gc_cfg = presets.get("GC").with_(result_dir=os.path.join(work, "gc"),
                                     soft_timeout_s=10.0, hard_timeout_s=600.0,
                                     exact_certify_masks=False, engine=engine_cfg)
    ac_cfg = presets.get("AC").with_(result_dir=os.path.join(work, "ac"),
                                     exact_certify_masks=False, engine=engine_cfg)
    gc_net = flagship_net(device="cuda")
    ac_net = seeded_net(AC_SIZES, seed=0, device="cuda")
    gc_rows = check_kernels(case_inputs("GC", gc_net, gc_cfg), gc_net, reps=5)
    ac_rows = check_kernels(case_inputs("AC", ac_net, ac_cfg), ac_net, reps=3)
    # Off the main path, for coverage of the kernels' ε-relaxed (RA) terms
    # and V > 2 assignment pairs: one 2-chunk segment of the relaxed-AC grid.
    rx_cfg = presets.get("relaxed-AC").with_(exact_certify_masks=False,
                                             engine=engine_cfg, grid_chunk=512,
                                             mega_chunks=2)
    check_kernels(case_inputs("relaxed-AC", ac_net, rx_cfg), ac_net, reps=1)

    # --- phase 3: the main path
    rep, gc_launch, wall = run_sweep(gc_net, gc_cfg, "GC-1")
    if rep.counts != {"sat": 2, "unsat": 199, "unknown": 0}:
        fail(f"GC-1 counts {rep.counts}, expected sat=2 unsat=199 unknown=0")
    thr = check_outputs(rep, gc_cfg, gc_net, "GC-1", gc_launch)
    print(f"[e2e GC-1] {rep.counts} in {wall:.3f} s = "
          f"{(rep.counts['sat'] + rep.counts['unsat']) / wall:.2f} partitions/s; "
          f"phases {thr['phases_s']}; launches {gc_launch}", flush=True)

    # --- phase 4: real size
    rep_ac, ac_launch, wall_ac = run_sweep(ac_net, ac_cfg, "AC-S1-twin")
    c = rep_ac.counts
    if sum(c.values()) != 16000:
        fail(f"AC grid: {sum(c.values())} partitions, expected 16000")
    thr = check_outputs(rep_ac, ac_cfg, ac_net, "AC-S1-twin", ac_launch)
    print(f"[real AC] certified {c['unsat']} flipped {c['sat']} undecided "
          f"{c['unknown']} in {wall_ac:.3f} s; phases {thr['phases_s']}; "
          f"launches {ac_launch}", flush=True)
    shutil.rmtree(work, ignore_errors=True)

    table = []
    for name in REPLACES:
        r, g = ac_rows[name], gc_rows[name]
        print(f"[summary] {name}: launches GC-1 {gc_launch[name]} / AC "
              f"{ac_launch[name]}; AC segment median {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": gc_launch[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "shape": "AC segment", "launches_ac": ac_launch[name],
            "gc": {k: g[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "max_abs_err")},
        })
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
