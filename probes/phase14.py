"""``chip_smoke.py``'s phase 14 (the synthetic-data path and the
synthesizer's kernels, rows 29-30) alone, on the card: the quickest check
of a change to ``csrc/synth_step.cu``, ``ops/synth_step.py``,
``models/synth.py``, ``models/export.py`` or
``scripts/synthetic_models.py``.

Run from the repository root on a machine with a CUDA card:

    python probes/phase14.py

It prints the card's name and power limit, builds the kernels (with the
ptxas report for ``synth_step``), runs 14b's card side
(``chip_smoke.synth_card``: the pipeline script at its defaults, which
starts the CPU side in a worker process), then the rest of the phase
(``chip_smoke.synth_phase``: 14b's card = CPU checks, 14a), and writes the
phase's results as JSON to ``--out``.  It exits nonzero where a check of the
phase fails.
"""
import json
import os
import signal
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402


def main() -> int:
    import argparse

    import torch

    from fairify_tpu_torch.utils import cuda_build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "phase14.json"))
    out_path = ap.parse_args().out
    smi = chip_smoke.smi_line()
    print(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    info = cuda_build.build_all()
    print(f"[build] {info['seconds']:.2f} s", flush=True)
    for line in info["ptxas"].get("synth_step", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas synth_step] {line.strip()}", flush=True)
    work = tempfile.mkdtemp(prefix="phase14_")
    try:
        card = chip_smoke.synth_card(work)
        res = chip_smoke.synth_phase(card, smi)
    finally:
        for w in chip_smoke.EXTRA_WORKERS:
            try:
                os.killpg(w.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            w.wait()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fp:
        json.dump(dict(res, launches=card["launch"], wall_s=card["wall"],
                       records=card["records"]), fp, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
