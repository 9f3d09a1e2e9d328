"""The AC grid's stage 0 and parity passes through the launch pipeline at
depths 1, 2 and 4, timed on the card, for one or more checkouts of the port.

Each ``--tree DIR:LABEL`` runs in a process of its own (the checkouts share
the package name), in the order given, so ``parent, this, this, parent``
puts two trees side by side on one card.  In each: the kernels are built
from the checkout's sources; the AC-S1 twin (seed 0) and the AC preset's
16,000 partitions; then, on the chunk loop (``mega_chunks=0``: 8 chunks of
2,048) and on the mega path (2 segments), one warm run and ``--repeats``
rounds of depths 1, 2 and 4 (one run each, depths interleaved), each run
``stage0_certify_and_attack`` then ``parity_pass``, timed on the host's
clock up to a device sync.  A checkout without ``parallel/pipeline.py``
(the port before its pipeline) runs the same passes without one: its
depth is a label only.  In a checkout with one, every run also times the
pipeline's host steps (the pinned staging of inputs, the start of the
output copies, the drain's wait, the whole dispatch, the whole drain and
the parts of a stage-0 submit).  Every run reads PyTorch's pinned-host
allocator statistics before and after, and counts the process's minor
page faults during stage 0 (``getrusage``).

Run from the repository root on a machine with a CUDA card:

    python probes/pipeline_depths.py --tree <parent checkout>:parent \\
        --tree .:this --tree .:this --tree <parent checkout>:parent

A third part of ``--tree`` sets environment variables for that checkout's
process (``.:this-env:MALLOC_MMAP_THRESHOLD_=33554432``).

It prints one line per run and a summary (median, min, max per tree, path
and depth) beside the card's name and power limit, and writes every run
to ``<out>/runs.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time

AC_SIZES = (13, 128, 64, 32, 16, 8, 1)  # models_scaled/adult/AC-S1.h5 widths
DEPTHS = (1, 2, 4)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


class HostSteps:
    """Cumulative host seconds of the pipeline's staging, fetch start and
    drain wait, of its whole dispatch (``_launch``: the submit body, its
    staging and the fetch start), of its whole drain, and of the stage-0
    submit's role boxes, candidate draws and KB + KC wrapper, by wrapping
    the functions where the port looks them up."""

    def __init__(self):
        import importlib

        self.seconds = {"stage": 0.0, "start_fetch": 0.0, "finish_fetch": 0.0}
        self._undo = []
        pipeline = importlib.import_module("fairify_tpu_torch.parallel.pipeline")
        mods = [pipeline] + [importlib.import_module(m) for m in (
            "fairify_tpu_torch.parallel.mesh", "fairify_tpu_torch.verify.engine",
            "fairify_tpu_torch.verify.sweep", "fairify_tpu_torch.verify.pruning")]
        for name in ("stage", "start_fetch", "finish_fetch"):
            real = getattr(pipeline, name)
            timed = self._wrap(name, real)
            for mod in mods:
                if getattr(mod, name, None) is real:
                    setattr(mod, name, timed)
                    self._undo.append((mod, name, real))
        cls = pipeline.LaunchPipeline
        sweep = importlib.import_module("fairify_tpu_torch.verify.sweep")
        engine = importlib.import_module("fairify_tpu_torch.verify.engine")
        # The dispatch's parts on the chunk loop: role boxes and candidate
        # draws on the host, the KB + KC wrapper.
        for owner, name in ((cls, "_launch"), (cls, "_drain_one"), (sweep, "role_boxes"),
                            (engine, "build_attack_candidates"), (engine, "certify_attack")):
            real = getattr(owner, name)
            self.seconds[name] = 0.0
            setattr(owner, name, self._wrap(name, real))
            self._undo.append((owner, name, real))

    def _wrap(self, name, real):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                self.seconds[name] += time.perf_counter() - t0
        return timed

    def close(self):
        for mod, name, real in self._undo:
            setattr(mod, name, real)


def host_stats():
    import torch

    fn = getattr(torch.cuda, "host_memory_stats", None)
    if fn is None:
        return None
    s = fn()
    keys = ("num_host_alloc", "num_host_free", "host_alloc_time.total",
            "host_free_time.total", "allocated_bytes.current", "reserved_bytes.current",
            "allocation.current", "segment.current")
    return {k: s[k] for k in keys if k in s}


def worker(root: str, label: str, repeats: int, out: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from fairify_tpu_torch.models.mlp import seeded_net
    from fairify_tpu_torch.obs import funnel as funnel_mod
    from fairify_tpu_torch.utils import cuda_build
    from fairify_tpu_torch.verify import presets, pruning, sweep
    from fairify_tpu_torch.verify.config import EngineConfig
    from fairify_tpu_torch.verify.property import encode

    try:
        from fairify_tpu_torch.parallel.pipeline import LaunchPipeline
    except ImportError:
        LaunchPipeline = None
    smi = smi_line()
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"[{label}] built in {time.perf_counter() - t0:.1f} s; pipeline "
          f"{'yes' if LaunchPipeline else 'no'}; torch {torch.__version__}; {smi}", flush=True)
    net = seeded_net(AC_SIZES, seed=0, device="cuda")
    ecfg = EngineConfig(frontier_size=512, attack_samples=128, bab_attack_samples=16,
                        soft_timeout_s=10.0)
    ac = presets.get("AC").with_(result_dir=tempfile.mkdtemp(prefix="depths_"),
                                 exact_certify_masks=False, engine=ecfg)
    enc = encode(ac.query())
    _, lo, hi = sweep.build_partitions(ac)
    prune = pruning.sound_prune_grid(net, lo, hi, ac.sim_size, ac.seed, chunk=ac.grid_chunk,
                                     mega_chunks=ac.mega_chunks)

    def run(cfg, depth):
        kw, pipe = {}, None
        if LaunchPipeline is not None:
            pipe = LaunchPipeline(depth, supervisor=sweep._supervisor(cfg))
            kw = {"pipe": pipe}
        torch.cuda.synchronize()
        f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        a = time.perf_counter()
        s0 = sweep.stage0_certify_and_attack(net, enc, lo, hi, cfg,
                                             funnel_mod.StageStats(), {}, **kw)
        b = time.perf_counter()
        f1 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        par = sweep.parity_pass(net, prune, lo, hi, cfg, **kw)
        torch.cuda.synchronize()
        c = time.perf_counter()
        flight = pipe.stats.summary() if pipe is not None else None
        return dict(t_s0=b - a, t_par=c - b, flight=flight, s0_minor_faults=f1 - f0,
                    unsat=int(s0[0].sum()), sat=int(s0[1].sum()), parity=int(par.sum()))

    with open(out, "a") as f:
        for path, cfg in (("chunk", ac.with_(mega_chunks=0)), ("mega", ac)):
            run(cfg, 1)  # warm: packs, constants, the first launches
            for rep in range(repeats):
                for depth in DEPTHS:
                    before = host_stats()
                    steps = HostSteps() if LaunchPipeline is not None else None
                    try:
                        r = run(cfg, depth)
                    finally:
                        if steps is not None:
                            steps.close()
                    r = dict(tree=label, path=path, depth=depth, rep=rep, **r,
                             host_steps=steps and steps.seconds,
                             host_alloc=[before, host_stats()])
                    f.write(json.dumps(r) + "\n")
                    print(f"[{label} {path} depth {depth} rep {rep}] stage 0 {r['t_s0']:.4f} s, "
                          f"parity {r['t_par']:.4f} s, in flight {r['flight']}, "
                          f"{r['s0_minor_faults']} minor page faults in stage 0; "
                          f"{r['unsat']} unsat / {r['sat']} sat; host steps "
                          f"{steps and {k: round(v, 4) for k, v in steps.seconds.items()}}; "
                          f"pinned allocator before / after {r['host_alloc']}", flush=True)
    return 0


def summary(out: str, smi: str) -> None:
    runs = [json.loads(line) for line in open(out)]
    groups = {}
    for r in runs:
        groups.setdefault((r["tree"], r["path"], r["depth"]), []).append(r)
    for (tree, path, depth), rs in sorted(groups.items()):
        s0 = [r["t_s0"] for r in rs]
        par = [r["t_par"] for r in rs]
        flt = [r["s0_minor_faults"] for r in rs]
        steps = {k: round(statistics.median(r["host_steps"][k] for r in rs), 4)
                 for k in (rs[0]["host_steps"] or {})}
        print(f"[summary {tree} {path} depth {depth}] stage 0 median "
              f"{statistics.median(s0):.4f} s (min {min(s0):.4f}, max {max(s0):.4f}, "
              f"n {len(s0)}); parity median {statistics.median(par):.4f} s; minor page "
              f"faults in stage 0 median {statistics.median(flt):.0f}; host steps median "
              f"{steps}; {smi}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="DIR:LABEL[:K=V,...] of a checkout, with environment variables "
                         "for its process (repeatable, run in order)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "pipeline_depths"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    runs = os.path.join(args.out, "runs.jsonl")
    if args.worker:
        root, label = args.worker.split(":")[:2]
        return worker(root, label, args.repeats, runs)
    import torch

    if not torch.cuda.is_available():
        print("pipeline_depths: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    if os.path.exists(runs):
        os.remove(runs)
    smi = smi_line()
    for tree in args.tree or [".:this"]:
        parts = tree.split(":")
        env = dict(os.environ, **dict(kv.split("=", 1) for kv in parts[2].split(","))) \
            if len(parts) > 2 else None
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                             "--repeats", str(args.repeats), "--out", args.out],
                            env=env).returncode
        if rc:
            print(f"pipeline_depths: {tree} failed ({rc})", file=sys.stderr)
            return rc
    summary(runs, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
