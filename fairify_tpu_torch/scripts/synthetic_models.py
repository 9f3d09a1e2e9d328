"""Synthetic-data model pipeline (the reference's task1 analog).

Port of ``scripts/synthetic_models.py``: synthesize rows of a benchmark
dataset (from-scratch Gaussian copula / autoregressive column model /
bootstrap, ``models/synth.py``), train a fresh MLP on the synthetic rows,
persist it as a Keras-compatible ``.h5`` (the reference's generated GC-6..8
slots, ``src/GC/Verify-GC-experiment.py:88-107``), verify it with the
dataset's preset, and compare against a real-data-trained twin.  The same
flags, defaults, model names, record keys and ``summary.json``, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  Where ``h5py`` does not import, the net is written as a
``models/ingest.save_npz`` export and its path recorded under ``h5``.

Usage:
    python -m fairify_tpu_torch.scripts.synthetic_models [--preset GC]
        [--generators copula,ar,bootstrap] [--n 2000] [--hidden 50]
        [--epochs 30] [--soft 5] [--hard 300] [--out res/synthetic] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os

# The generated models keep the reference's naming convention: the first
# free slot per family (GC-6.., AC-17.., BM-14..).  Slots are keyed by
# generator *kind*, not by position in --generators, so a subset run (e.g.
# --generators ar) writes the same file a full run would — never another
# generator's slot.
SLOT_BASE = {"GC": 6, "AC": 17, "BM": 14, "CP": 12, "DF": 12}
SLOT_OFFSET = {"copula": 0, "ar": 1, "bootstrap": 2}


def save_net(net, out: str, model_name: str) -> str:
    """Write ``net`` as ``<out>/<model_name>.h5``, or, without ``h5py``, as
    ``<out>/<model_name>.npz``; returns the path written."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        from fairify_tpu_torch.models import ingest

        path = os.path.join(out, f"{model_name}.npz")
        ingest.save_npz(net, path)
        return path
    from fairify_tpu_torch.models import export

    path = os.path.join(out, f"{model_name}.h5")
    export.save_keras_h5(net, path)
    return path


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="GC")
    ap.add_argument("--generators", default="copula,ar,bootstrap")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--hidden", type=int, nargs="*", default=[50])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--ar-epochs", type=int, default=200)
    ap.add_argument("--soft", type=float, default=5.0)
    ap.add_argument("--hard", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="res/synthetic")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    import numpy as np

    from fairify_tpu_torch.data import loaders
    from fairify_tpu_torch.models import synth, train
    from fairify_tpu_torch.utils.num import resolve_device
    from fairify_tpu_torch.verify import presets, sweep

    device = resolve_device(args.device)
    cfg = presets.get(args.preset).with_(soft_timeout_s=args.soft, hard_timeout_s=args.hard,
                                         result_dir=args.out)
    ds = loaders.load(cfg.dataset)
    query = cfg.query()
    lo, hi = query.domain.lo_hi()
    lo = np.concatenate([lo, [0.0]]).astype(np.int64)   # + label column
    hi = np.concatenate([hi, [1.0]]).astype(np.int64)

    # labelled real rows on the integer lattice (features then label)
    real = np.concatenate(
        [np.asarray(ds.X_train), np.asarray(ds.y_train)[:, None]], axis=1
    ).astype(np.int64)
    real = np.clip(real, lo[None, :], hi[None, :])

    os.makedirs(args.out, exist_ok=True)
    fam = args.preset.split("-")[-1]
    records = []

    def train_and_verify(tag: str, rows: np.ndarray, model_name: str):
        X, y = rows[:, :-1].astype(np.float32), rows[:, -1].astype(np.float32)
        if len(np.unique(y)) < 2:  # degenerate sample: nothing to verify
            return {"generator": tag, "model": model_name, "skipped": "single-class sample"}
        net = train.train_mlp(X, y, hidden=list(args.hidden),
                              epochs=args.epochs, seed=args.seed, device=device)
        h5 = save_net(net, args.out, model_name)
        report = sweep.verify_model(net, cfg, model_name=model_name,
                                    dataset=ds, resume=False, device=device)
        return {
            "generator": tag, "model": model_name, "h5": h5,
            "rows": int(len(rows)),
            "partitions": report.partitions_total, **report.counts,
            "test_acc": round(report.original_acc, 4),
            "total_time_s": round(report.total_time_s, 2),
        }

    # real-data twin first: the comparison anchor (reference compares the
    # synthetic models against the equivalently-shaped real-data model)
    records.append(train_and_verify("real", real, f"{fam}-real"))
    print(json.dumps(records[-1]), flush=True)

    for kind in [g for g in args.generators.split(",") if g]:
        rows = synth.synthesize(kind, real, lo, hi, args.n, seed=args.seed,
                                ar_epochs=args.ar_epochs, device=device)
        slot = SLOT_BASE.get(fam, 90) + SLOT_OFFSET.get(kind, len(SLOT_OFFSET))
        rec = train_and_verify(kind, rows, f"{fam}-{slot}")
        records.append(rec)
        print(json.dumps(rec), flush=True)

    with open(os.path.join(args.out, "summary.json"), "w") as fp:
        json.dump(records, fp, indent=1)
    return records


if __name__ == "__main__":
    main()
