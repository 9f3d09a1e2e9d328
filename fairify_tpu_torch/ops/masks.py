"""Dead-neuron mask algebra (port of ``fairify_tpu/ops/masks.py``).

Masks are per-layer float vectors with 1 = dead: :func:`keep_one_alive`,
:func:`compression_ratio`, and the heuristic retry's :func:`alive_masks` /
:func:`apply_dead_masks`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def keep_one_alive(dead: Sequence) -> list:
    """Never prune a whole layer: if every entry of a layer's mask array is
    dead, revive index 0 (``utils/prune.py:689-691`` of the reference).

    Same array semantics as the JAX package's version: the all-dead test
    spans the whole array and the revive subtracts 1 at ``[0]`` along the
    leading axis, so a (P, n) grid mask is only touched when every neuron
    of every partition is dead.
    """
    out = []
    for d in dead:
        d = np.array(d, dtype=np.float32, copy=True)
        if np.all(d > 0.5):
            d[0] = d[0] - 1.0
        out.append(d)
    return out


def compression_ratio(dead: Sequence) -> float:
    """Fraction of neurons removed, over all layers (output layer included,
    kept identical to the reference for CSV parity)."""
    total = sum(int(np.asarray(d).size) for d in dead)
    dead_n = sum(int(np.asarray(d).sum()) for d in dead)
    return dead_n / total if total else 0.0


def alive_masks(dead: Sequence, device=None) -> list:
    """Dead masks (1 = dead) → alive masks (1 = alive), float32 tensors."""
    return [1.0 - torch.as_tensor(np.asarray(d, dtype=np.float32), device=device)
            for d in dead]


def apply_dead_masks(net, dead: Sequence):
    """``net`` with its hidden masks replaced by the alive complement of
    ``dead`` (one entry per layer, the output layer's included)."""
    return net.with_masks(alive_masks(dead, device=net.device))
