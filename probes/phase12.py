"""``chip_smoke.py``'s phase 12 (the SMT tier and ``run_sweep``) alone, on
the card: the quickest check of a change to the SMT tier, the loaders or
``run_sweep``.

Run from the repository root on a machine with a CUDA card:

    python probes/phase12.py

It prints whether ``z3-solver`` is installed (the pool's ``auto`` workers
then use it), the card's name and power limit, builds the kernels, runs
phase 12's CPU side (``chip_smoke.phase12_cpu``) in a subprocess of its
own, then phase 12's card side (``chip_smoke.smt_and_run_sweep``) against
it, and writes the phase's results as JSON to ``--out``.  It exits nonzero
where a check of the phase fails.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402


def main() -> int:
    import argparse

    import torch

    from fairify_tpu_torch.utils import cuda_build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "phase12.json"))
    out_path = ap.parse_args().out
    try:
        import z3

        print(f"[z3] {z3.get_version_string()}", flush=True)
    except ImportError:
        print("[z3] not installed: the workers use the brute backend", flush=True)
    smi = chip_smoke.smi_line()
    print(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    info = cuda_build.build_all()
    print(f"[build] {info['seconds']:.2f} s", flush=True)
    work = tempfile.mkdtemp(prefix="phase12_")
    out = os.path.join(work, "cpu12.json")
    code = ("import json, sys, torch; sys.path.insert(0, '.'); torch.set_num_threads(7); "
            "import chip_smoke; json.dump(chip_smoke.phase12_cpu(sys.argv[1]), "
            "open(sys.argv[2], 'w'))")
    t = time.perf_counter()
    rc = subprocess.run([sys.executable, "-c", code, os.path.join(work, "cpu12"), out]).returncode
    print(f"[cpu side] exit {rc} in {time.perf_counter() - t:.3f} s", flush=True)
    if rc != 0:
        return rc
    with open(out) as fp:
        cpu = json.load(fp)
    res = chip_smoke.smt_and_run_sweep(work, smi, cpu)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fp:
        json.dump(res, fp, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
