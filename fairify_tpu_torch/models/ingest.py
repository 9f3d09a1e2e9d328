"""Keras HDF5 → MLP ingestion, and the ``.npz`` exports the card loads.

Port of ``fairify_tpu/models/ingest.py``: the HDF5 file is parsed directly
with ``h5py`` (imported inside the functions, so this module imports without
it): the ``model_config`` attribute gives the layer order and activations,
``model_weights/<name>/<name>/{kernel,bias}:0`` the parameters.  The same
checks hold: Dense layers only, ReLU hidden layers, a sigmoid or linear
single output unit, consistent shapes.  The MLP computes the pre-sigmoid
logit.

A machine without ``h5py`` loads a net from an ``.npz`` export instead
(:func:`save_npz` / :func:`load_npz`, numpy only): ``w_0 … w_{L-1}`` and
``b_0 … b_{L-1}`` as float32, the source file's name (``source``) and its
SHA-256 (``sha256``).  The repo's four trained nets are exported under
``scaled/`` (:data:`TRAINED`); regenerate one with::

    python -m fairify_tpu_torch.models.ingest export models_scaled/adult/AC-S1.h5 \\
        fairify_tpu_torch/models/scaled/AC-S1.npz
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

from fairify_tpu_torch.models.mlp import MLP, from_numpy

# The exports of the repo's trained nets (models_scaled/*/<name>.h5).
SCALED_DIR = Path(__file__).resolve().parent / "scaled"
TRAINED = {"AC-S1": "models_scaled/adult/AC-S1.h5", "AC-S2": "models_scaled/adult/AC-S2.h5",
           "BM-S1": "models_scaled/bank/BM-S1.h5", "BM-S2": "models_scaled/bank/BM-S2.h5"}


class IngestError(ValueError):
    pass


def _layer_configs(cfg: dict) -> list:
    out = []
    for layer in cfg["config"]["layers"]:
        cls = layer["class_name"]
        if cls == "InputLayer":
            continue
        if cls != "Dense":
            raise IngestError(f"unsupported layer class {cls!r}")
        out.append(layer["config"])
    return out


def _weight_arrays(h5file, layer_name: str):
    import h5py

    grp = h5file["model_weights"][layer_name]
    # Keras nests one more group level named after the layer.
    while isinstance(grp, h5py.Group) and "kernel:0" not in grp:
        inner = list(grp.keys())
        if len(inner) != 1:
            raise IngestError(f"ambiguous weight group for {layer_name}: {inner}")
        grp = grp[inner[0]]
    return np.array(grp["kernel:0"]), np.array(grp["bias:0"])


def _check_shapes(path, weights, biases) -> None:
    if weights[-1].shape[1] != 1:
        raise IngestError(f"{path}: output width {weights[-1].shape[1]}, expected 1")
    for i in range(len(weights) - 1):
        if weights[i].shape[1] != weights[i + 1].shape[0]:
            raise IngestError(f"{path}: inconsistent layer shapes at {i}")
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise IngestError(f"{path}: layer {i} bias shape {b.shape} for weights {w.shape}")


def keras_h5_arrays(path):
    """``(weights, biases)`` float32 lists of a Keras Sequential/Functional
    Dense-only ``.h5`` model, after the architecture checks."""
    import h5py

    path = Path(path)
    with h5py.File(path, "r") as f:
        raw = f.attrs.get("model_config")
        if raw is None:
            raise IngestError(f"{path}: no model_config attribute")
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8")
        layer_cfgs = _layer_configs(json.loads(raw))
        if not layer_cfgs:
            raise IngestError(f"{path}: no Dense layers")
        weights, biases = [], []
        for lc in layer_cfgs:
            k, b = _weight_arrays(f, lc["name"])
            weights.append(k.astype(np.float32))
            biases.append(b.astype(np.float32))
    for i, lc in enumerate(layer_cfgs[:-1]):
        if lc.get("activation") != "relu":
            raise IngestError(f"{path}: hidden layer {i} activation "
                              f"{lc.get('activation')!r}, expected relu")
    if layer_cfgs[-1].get("activation") not in ("sigmoid", "linear"):
        raise IngestError(f"{path}: output activation {layer_cfgs[-1].get('activation')!r}")
    _check_shapes(path, weights, biases)
    return weights, biases


def load_keras_h5(path, device=None) -> MLP:
    """Load a Keras Dense-only ``.h5`` model as an :class:`MLP` on ``device``
    (default ``cuda``; the tests pass ``"cpu"``)."""
    return from_numpy(*keras_h5_arrays(path), device=device)


def save_npz(net_or_arrays, path, source=None) -> None:
    """Write an ``.npz`` export: ``w_l``/``b_l`` float32 of an :class:`MLP`
    or of ``(weights, biases)`` lists, and the name and SHA-256 of the file
    ``source`` it came from (empty when None)."""
    if isinstance(net_or_arrays, MLP):
        weights = [w.detach().cpu().numpy() for w in net_or_arrays.weights]
        biases = [b.detach().cpu().numpy() for b in net_or_arrays.biases]
    else:
        weights, biases = net_or_arrays
    arrays = {}
    for i, (w, b) in enumerate(zip(weights, biases)):
        arrays[f"w_{i}"] = np.asarray(w, dtype=np.float32)
        arrays[f"b_{i}"] = np.asarray(b, dtype=np.float32)
    name, digest = "", ""
    if source is not None:
        name = Path(source).name
        digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()
    np.savez(path, source=np.array(name), sha256=np.array(digest), **arrays)


def npz_arrays(path):
    """``(weights, biases, source, sha256)`` of an ``.npz`` export, checked
    as :func:`load_keras_h5` checks an ``.h5`` file's shapes."""
    with np.load(path, allow_pickle=False) as z:
        L = sum(1 for k in z.files if k.startswith("w_"))
        if L == 0 or any(f"w_{i}" not in z.files or f"b_{i}" not in z.files
                         for i in range(L)):
            raise IngestError(f"{path}: expected w_0..w_{{L-1}} and b_0..b_{{L-1}}")
        weights = [z[f"w_{i}"] for i in range(L)]
        biases = [z[f"b_{i}"] for i in range(L)]
        source, digest = str(z["source"]), str(z["sha256"])
    if any(a.dtype != np.float32 for a in weights + biases):
        raise IngestError(f"{path}: weights and biases must be float32")
    _check_shapes(path, weights, biases)
    return weights, biases, source, digest


def load_npz(path, device=None) -> MLP:
    """Load an ``.npz`` export as an :class:`MLP` on ``device`` (default
    ``cuda``); numpy only, no ``h5py``."""
    weights, biases, _, _ = npz_arrays(path)
    return from_numpy(weights, biases, device=device)


def load_trained(name: str, device=None) -> MLP:
    """One of the repo's trained nets (:data:`TRAINED`) from its export."""
    if name not in TRAINED:
        raise KeyError(f"unknown trained net {name!r}; known: {sorted(TRAINED)}")
    return load_npz(SCALED_DIR / f"{name}.npz", device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fairify_tpu_torch.models.ingest")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="write a Keras .h5 net's weights to an .npz export")
    ex.add_argument("h5")
    ex.add_argument("npz")
    args = ap.parse_args(argv)
    save_npz(keras_h5_arrays(args.h5), args.npz, source=args.h5)
    print(f"{args.h5} -> {args.npz}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
