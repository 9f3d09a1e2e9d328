"""Keras-compatible HDF5 export for repaired/synthetic models.

Port of ``fairify_tpu/models/export.py``: :func:`save_keras_h5` writes the
same on-disk contract the JAX package's writer does — a ``model_config``
attribute describing a Sequential stack of Dense layers (ReLU hidden,
sigmoid output), ``backend``, and ``model_weights/<name>/<name>/
{kernel,bias}:0`` datasets with their ``layer_names`` and
``weight_names`` — so ``models/ingest.load_keras_h5`` of either package
(and TF's loader) reads it.  ``h5py`` is imported inside the function, so
this module imports without it; a machine without ``h5py`` writes
``models/ingest.save_npz`` exports instead.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from fairify_tpu_torch.models.mlp import MLP


def save_keras_h5(net: MLP, path, name: str = "sequential") -> None:
    import h5py

    path = Path(path)
    weights, biases = net.numpy_params()
    n = net.depth
    layer_names = [f"dense_{i}" for i in range(n)]
    layers = [{
        "class_name": "InputLayer",
        "config": {"batch_input_shape": [None, net.in_dim], "dtype": "float32",
                   "name": "input_1"},
    }]
    for i, lname in enumerate(layer_names):
        layers.append({
            "class_name": "Dense",
            "config": {
                "name": lname,
                "units": int(weights[i].shape[1]),
                "activation": "relu" if i < n - 1 else "sigmoid",
                "use_bias": True,
                "dtype": "float32",
            },
        })
    cfg = {"class_name": "Sequential", "config": {"name": name, "layers": layers}}

    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg)
        f.attrs["backend"] = "tensorflow"
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array([s.encode() for s in layer_names])
        for i, lname in enumerate(layer_names):
            grp = mw.create_group(lname).create_group(lname)
            grp.create_dataset("kernel:0", data=np.asarray(weights[i], dtype=np.float32))
            grp.create_dataset("bias:0", data=np.asarray(biases[i], dtype=np.float32))
            mw[lname].attrs["weight_names"] = np.array(
                [f"{lname}/kernel:0".encode(), f"{lname}/bias:0".encode()]
            )
