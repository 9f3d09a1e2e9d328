"""``chip_smoke.py``'s phase 13 (the experiment path and the training
kernels, rows 25-28) alone, on the card: the quickest check of a change to
``csrc/train_step.cu``, ``ops/train_step.py``, ``models/train.py`` or
``analysis/``.

Run from the repository root on a machine with a CUDA card:

    python probes/phase13.py

It prints the card's name and power limit, builds the kernels (with each
library's ptxas report for ``train_step``), starts phase 13's CPU side
(``chip_smoke.phase13_cpu``) in a subprocess of its own, runs 13c's card
side (``chip_smoke.experiment_card``), then the rest of the phase
(``chip_smoke.experiment_phase``: 13c's card = CPU checks, 13b, 13a), and
writes the phase's results as JSON to ``--out``.  It exits nonzero where a
check of the phase fails.
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
    ap.add_argument("--out", default=os.path.join("chiprun_out", "phase13.json"))
    out_path = ap.parse_args().out
    smi = chip_smoke.smi_line()
    print(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    info = cuda_build.build_all()
    print(f"[build] {info['seconds']:.2f} s", flush=True)
    for line in info["ptxas"].get("train_step", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas train_step] {line.strip()}", flush=True)
    work = tempfile.mkdtemp(prefix="phase13_")
    weights = os.path.join(work, "card13.npz")
    cpu_out = os.path.join(work, "cpu13.json")
    code = ("import json, sys, torch; sys.path.insert(0, '.'); torch.set_num_threads(6); "
            "import chip_smoke; json.dump(chip_smoke.phase13_cpu(sys.argv[1], sys.argv[2]), "
            "open(sys.argv[3], 'w'))")
    t = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code, os.path.join(work, "cpu13"), weights,
                             cpu_out])
    try:
        exp = chip_smoke.experiment_card(work, weights)
        rc = proc.wait(timeout=1200)
    finally:
        if proc.poll() is None:
            proc.kill()
    print(f"[cpu side] exit {rc} in {time.perf_counter() - t:.3f} s", flush=True)
    if rc != 0:
        return rc
    with open(cpu_out) as fp:
        cpu = json.load(fp)
    res = chip_smoke.experiment_phase(exp, cpu, smi)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fp:
        json.dump(dict(res, launches=exp["launch"]), fp, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
