"""K8a's bounds against the float64 bounds of their own relaxations, over
the branches of a plain sign frontier.

``chip_smoke.py`` (phase 2c) holds K8a on 512 branches of one plain sign
frontier over the AC-S1 twin's first 512 AC stage-0 leftovers.  This
script bounds every branch such a frontier visits (a random subset when
there are more than ``--max-rows``), at each per-root node cap of
``--caps``, with K8a and with its plain version at alpha_iters 8 and 0,
and compares both with the float64 bounds of the same relaxations
(``chip_smoke.sign_bound_reference``).  It prints, per cap, the frontier's
seconds, branches and depths, ``chip_smoke.sign_bound_verdict`` of every
batch, and every branch whose kernel or plain bound misses the f64 bound:
the miss in float32 units in the last place of the bound, as a share of
the outward widening (``SOUND_SLACK_REL * |bound| + SOUND_SLACK_ABS``) and
as a share of chip_smoke's band (``sign_bound_band``).  Then it runs
chip_smoke's own K8a check on its 512 branches of the frontier at
``FRONTIER_NODES``.
Those branches go into ``<out>/misses.json``, which ``--replay`` reruns
(also on the CPU, without the kernel).

Run from the repository root:

    python probes/k8a_containment.py [--caps 16,64,256] [--out chiprun_out/k8a]
    python probes/k8a_containment.py --replay chiprun_out/k8a/misses.json \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def misses(bound_lo, bound_hi, f64_lo, f64_hi, band):
    """Per box: how far the f32 bounds miss the f64 ones (0 where they
    contain them), in float32 ulps of the bound, in shares of the outward
    widening and in shares of chip_smoke's band (``sign_bound_band``)."""
    from fairify_tpu_torch.ops.interval import SOUND_SLACK_ABS, SOUND_SLACK_REL

    lo, hi = bound_lo.double(), bound_hi.double()
    gap = torch.maximum(lo - f64_lo, f64_hi - hi).clamp(min=0.0)
    edge = torch.where(lo - f64_lo > f64_hi - hi, bound_lo, bound_hi).float().abs()
    ulp = (torch.nextafter(edge, torch.full_like(edge, float("inf"))) - edge).double()
    slack = SOUND_SLACK_REL * edge.double() + SOUND_SLACK_ABS
    return gap, gap / ulp, gap / slack, gap / band


def check_rows(net, rows, d: int, alpha: int, on_card: bool):
    """K8a (on the card) and the plain version against the f64 reference
    on one batch: (verdict, per-box kernel and plain misses, reference)."""
    from fairify_tpu_torch.verify import engine

    lo, hi, pats = cs.frontier_split(net, rows, d)
    ref = cs.sign_bound_reference(net, lo, hi, pats, alpha)
    (p_lo, p_hi, *_), p_ab, excused, f64_lo, f64_hi, _ = ref
    band = cs.sign_bound_band(p_lo, p_hi)
    plain = misses(p_lo, p_hi, f64_lo, f64_hi, band)
    if not on_card:
        return None, None, plain, ref
    k = engine.sign_bound(net, lo, hi, pats, alpha, with_ab=True)
    return cs.sign_bound_verdict(k[:5], k[5], ref), misses(k[0], k[1], f64_lo, f64_hi, band), \
        plain, ref + (k,)


def sweep_caps(args) -> dict:
    from fairify_tpu_torch.models.mlp import seeded_net
    from fairify_tpu_torch.utils import cuda_build
    from fairify_tpu_torch.verify import presets

    smi = cs.smi_line()
    print(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    info = cuda_build.build_all()
    print(f"[build] {info['seconds']:.2f} s", flush=True)
    net = seeded_net(cs.AC_SIZES, seed=0, device="cuda")
    cfg = presets.get("AC").with_(result_dir=tempfile.mkdtemp(prefix="k8a_"),
                                  exact_certify_masks=False, engine=cs.smoke_engine_cfg())
    enc, lo, hi = cs.leftovers(net, cfg, 2048, 8192)
    lo, hi = lo[:512], hi[:512]
    d = lo.shape[1]
    found, report = [], {"smi": smi, "caps": {}}
    for cap in args.caps:
        t0 = time.perf_counter()
        rows, depth = cs.frontier_rows(net, enc, lo, hi, cap)
        t_front = time.perf_counter() - t0
        R = rows.shape[0]
        take = np.arange(R) if R <= args.max_rows else np.sort(
            np.random.default_rng(0).choice(R, args.max_rows, replace=False))
        hist = np.bincount(depth, minlength=9).tolist()
        rec = {"frontier_s": t_front, "branches": int(R), "checked": int(take.size),
               "depths": hist, "alpha": {}}
        pick = rows[torch.as_tensor(take, device=rows.device)]
        for alpha in (8, 0):
            verdicts, k_n, p_n, worst_k, worst_p = [], 0, 0, 0.0, 0.0
            band_k = band_p = 0.0
            ab_diff = ab_bare = 0
            for b0 in range(0, pick.shape[0], 512):
                batch = pick[b0:b0 + 512]
                why, km, pm, ref = check_rows(net, batch, d, alpha, True)
                if why:
                    verdicts.append(why)
                k_bad, p_bad = km[0] > 0, pm[0] > 0
                k_n += int(k_bad.sum())
                p_n += int(p_bad.sum())
                ok = ~ref[2]
                if ref[1].shape[-1]:  # final α/β: kernel vs plain, and unexcused
                    diff = ~(ref[6][5] == ref[1]).all(-1)
                    ab_diff += int(diff.sum())
                    ab_bare += int((diff & ok).sum())
                top = lambda t: float(t.max()) if t.numel() else 0.0
                worst_k = max(worst_k, top(km[1][ok]))
                worst_p = max(worst_p, top(pm[1]))
                band_k = max(band_k, top(km[3][ok]))
                band_p = max(band_p, top(pm[3]))
                for i in torch.nonzero(k_bad | p_bad).flatten().tolist():
                    k = ref[6]
                    found.append(dict(
                        cap=cap, alpha_iters=alpha, depth=int((batch[i, 2 * d:] != 0).sum()),
                        row=batch[i].cpu().tolist(), kernel=[float(k[0][i]), float(k[1][i])],
                        plain=[float(ref[0][0][i]), float(ref[0][1][i])],
                        f64=[float(ref[3][i]), float(ref[4][i])],
                        feasible=bool(ref[0][2][i]), excused=bool(ref[2][i]),
                        kernel_miss=[float(v[i]) for v in km],
                        plain_miss=[float(v[i]) for v in pm]))
            rec["alpha"][alpha] = {"verdicts": verdicts, "kernel_misses": k_n,
                                   "plain_misses": p_n, "kernel_worst_ulps": worst_k,
                                   "plain_worst_ulps": worst_p, "kernel_worst_band": band_k,
                                   "plain_worst_band": band_p, "alpha_beta_differ": ab_diff,
                                   "alpha_beta_differ_unexcused": ab_bare}
            print(f"[cap {cap} alpha={alpha}] frontier {t_front:.2f} s, {R} branches "
                  f"(depths 0-8: {hist[:9]}), {take.size} checked: kernel misses {k_n} "
                  f"(worst unexcused {worst_k:.1f} ulps, {band_k:.3f} of the band), plain "
                  f"misses {p_n} (worst {worst_p:.1f} ulps, {band_p:.3f} of the band); "
                  f"final α/β differ on {ab_diff} ({ab_bare} unexcused); "
                  f"verdicts {sorted(set(verdicts))}; {smi}", flush=True)
        report["caps"][cap] = rec
    # chip_smoke's own check: its 512 branches of the frontier at
    # FRONTIER_NODES, at alpha_iters 8 and 0.
    branches = cs.frontier_patterns(net, enc, lo, hi, 512)
    again = cs.frontier_patterns(net, enc, lo, hi, 512)
    report["smoke_branches_repeat"] = all(torch.equal(a, b) for a, b in zip(
        branches[:2] + tuple(branches[2]), again[:2] + tuple(again[2])))
    print(f"[smoke branches] a second frontier at FRONTIER_NODES = {cs.FRONTIER_NODES} "
          f"gives the same 512 branches: {report['smoke_branches_repeat']}", flush=True)
    for alpha in (8, 0):
        try:
            cs.check_sign_bound("AC frontier", net, *branches[:3], alpha, reps=1)
            report[f"smoke_alpha{alpha}"] = "held"
        except SystemExit:
            report[f"smoke_alpha{alpha}"] = "failed"
        print(f"[smoke branches alpha={alpha}] {branches[3]} by depth: "
              f"{report[f'smoke_alpha{alpha}']}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "misses.json"), "w") as f:
        json.dump({"net": "ac", "layer_sizes": list(cs.AC_SIZES), "d": d,
                   "misses": found}, f)
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    for m in found[:40]:
        print(f"[miss] cap {m['cap']} alpha={m['alpha_iters']} depth {m['depth']} "
              f"feasible {m['feasible']} excused {m['excused']}: kernel {m['kernel']} "
              f"plain {m['plain']} f64 {m['f64']}; kernel miss {m['kernel_miss']} "
              f"plain miss {m['plain_miss']} (abs, ulps, widening and band shares)", flush=True)
    return report


def replay(args) -> None:
    """Rerun the branches of a misses file on ``--device``."""
    from fairify_tpu_torch.models.mlp import flagship_net, seeded_net

    with open(args.replay) as f:
        data = json.load(f)
    dev = args.device
    net = seeded_net(cs.AC_SIZES, seed=0, device=dev) if data.get("net", "ac") == "ac" \
        else flagship_net(device=dev)
    d = data["d"]
    for m in data["misses"]:
        row = torch.tensor([m["row"]], dtype=torch.float32, device=dev)
        why, km, pm, ref = check_rows(net, row, d, m["alpha_iters"], dev != "cpu")
        print(f"[replay alpha={m['alpha_iters']} depth {m['depth']}] recorded kernel "
              f"{m['kernel']} plain {m['plain']} f64 {m['f64']}; now plain "
              f"{[float(ref[0][0][0]), float(ref[0][1][0])]} f64 "
              f"{[float(ref[3][0]), float(ref[4][0])]}, plain miss "
              f"{[float(v[0]) for v in pm]}"
              + ("" if km is None else f", kernel miss {[float(v[0]) for v in km]} ({why})"),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--caps", default="16,64,256",
                    type=lambda s: [int(v) for v in s.split(",")])
    ap.add_argument("--max-rows", type=int, default=8192)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "k8a"))
    ap.add_argument("--replay")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.replay:
        replay(args)
        return 0
    if not torch.cuda.is_available():
        print("k8a_containment: no CUDA device", file=sys.stderr)
        return 2
    sweep_caps(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
