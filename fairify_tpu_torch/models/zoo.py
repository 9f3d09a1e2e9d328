"""Registry of the benchmark model zoo (port of ``fairify_tpu/models/zoo.py``).

The reference ships pretrained Keras ``.h5`` MLPs under
``models/{adult,german,bank,compass,default}``; its scripts iterate a directory
listing (``src/GC/Verify-GC.py:78-80``).  The registry resolves the same
families from a configurable root.  A family directory may hold the nets'
``.npz`` exports (``models.ingest.save_npz``: numpy only, for machines
without ``h5py``) beside or instead of the ``.h5`` files; where both name
one net, the ``.npz`` is taken.
"""
from __future__ import annotations

import os
import re
from pathlib import Path

from fairify_tpu_torch.models.ingest import load_keras_h5, load_npz

# The reference checkout's ``models`` directory: ``$FAIRIFY_TPU_MODEL_ROOT``,
# else ``reference/models`` under the working directory.
DEFAULT_ROOT = os.environ.get("FAIRIFY_TPU_MODEL_ROOT", os.path.join("reference", "models"))

# dataset key -> (subdirectory, model-name prefix)
FAMILIES = {
    "adult": ("adult", "AC"),
    "german": ("german", "GC"),
    "bank": ("bank", "BM"),
    "compass": ("compass", "CP"),
    "compass12": ("compass", "CP"),
    "default": ("default", "DF"),
}


def _natural_key(name: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def model_paths(dataset: str, root=None) -> list:
    """One path per net of a dataset's family, in natural name order (AC-1,
    AC-2, ..., AC-10): the ``.npz`` export where there is one, else the
    ``.h5`` file."""
    sub, _ = FAMILIES[dataset]
    d = Path(root or DEFAULT_ROOT) / sub
    if not d.is_dir():
        return []
    by_stem = {p.stem: p for p in d.glob("*.h5")}
    by_stem.update({p.stem: p for p in d.glob("*.npz")})
    return [by_stem[k] for k in sorted(by_stem, key=_natural_key)]


def _load_path(path: Path, device=None):
    return load_npz(path, device=device) if path.suffix == ".npz" \
        else load_keras_h5(path, device=device)


def load(dataset: str, name: str, root=None, device=None):
    """Load one zoo net by name on ``device`` (default ``cuda``), e.g.
    ``load('german', 'GC-1')``; its ``.npz`` export if there is one."""
    sub, _ = FAMILIES[dataset]
    d = Path(root or DEFAULT_ROOT) / sub
    npz = d / f"{name}.npz"
    return _load_path(npz if npz.is_file() else d / f"{name}.h5", device=device)


def load_family(dataset: str, root=None, device=None) -> dict:
    return {p.stem: _load_path(p, device=device) for p in model_paths(dataset, root)}


def load_matching(dataset: str, n_attrs: int, models=None, root=None, device=None):
    """Zoo nets whose input width matches the verification domain.

    Returns ``(nets, skipped)``: ``nets`` maps name → net for every model
    with ``in_dim == n_attrs`` (restricted to ``models`` if given),
    ``skipped`` lists the mismatched names (e.g. the 12-input CP notebook
    models against the 6-attribute domain).
    """
    nets, skipped = {}, []
    for path in model_paths(dataset, root=root):
        if models is not None and path.stem not in models:
            continue
        net = _load_path(path, device=device)
        if net.in_dim != n_attrs:
            skipped.append(path.stem)
            continue
        nets[path.stem] = net
    return nets, skipped
