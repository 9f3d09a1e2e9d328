"""Biased-neuron localization from counterexample pairs.

Port of ``fairify_tpu/analysis/localize.py`` (``src/AC/detect_bias.py:
205-302``): for each counterexample pair (x, x') differing only in the
protected attribute, accumulate per-neuron absolute activation deltas and
rank.  One plain batched forward per role over all pairs (torch ops on the
net's device, no kernel: the JAX package's is an eager ``jnp`` forward).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from fairify_tpu_torch.models import mlp as mlp_mod


@dataclass
class BiasLocalization:
    scores: List[np.ndarray]  # per layer, (n_l,) accumulated |Δ activation|
    ranked: List[Tuple[int, int, float]]  # (layer, neuron, score), descending
    skipped_pairs: int  # pairs not differing exactly in the PA set


def _check_pair(x: np.ndarray, xp: np.ndarray, pa_idx: Sequence[int]) -> bool:
    """Pair sanity check: differs on PA, equal elsewhere
    (``src/AC/detect_bias.py:226-234`` warns and skips otherwise)."""
    pa = set(int(i) for i in pa_idx)
    for i in range(len(x)):
        if i in pa:
            if x[i] == xp[i]:
                return False
        elif x[i] != xp[i]:
            return False
    return True


def localize(
    net,
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    pa_idx: Sequence[int],
    top_k: int = 10,
) -> BiasLocalization:
    """Rank neurons by accumulated activation difference over CE pairs."""
    valid = [(x, xp) for x, xp in pairs if _check_pair(np.asarray(x), np.asarray(xp), pa_idx)]
    skipped = len(pairs) - len(valid)
    if not valid:
        return BiasLocalization(
            scores=[np.zeros(int(b.shape[0]), dtype=np.float32) for b in net.biases],
            ranked=[], skipped_pairs=skipped,
        )
    dev = net.device
    as_t = lambda a: torch.tensor(np.stack(a).astype(np.float32), device=dev)
    with torch.no_grad():
        outs_x = mlp_mod.layer_outputs(net, as_t([v[0] for v in valid]))
        outs_p = mlp_mod.layer_outputs(net, as_t([v[1] for v in valid]))
        scores = [(a - b).abs().sum(dim=0).cpu().numpy() for a, b in zip(outs_x, outs_p)]
    flat = [
        (l, j, float(scores[l][j]))
        for l in range(len(scores) - 1)  # output layer excluded from repair targets
        for j in range(scores[l].shape[0])
    ]
    flat.sort(key=lambda t: -t[2])
    return BiasLocalization(scores=scores, ranked=flat[:top_k], skipped_pairs=skipped)


def global_index_map(layer_sizes: Sequence[int]):
    """Global neuron index ↔ (layer, neuron), as ``detect_bias.py:278-302``."""
    fwd = {}
    rev = {}
    g = 0
    for l, n in enumerate(layer_sizes):
        for j in range(n):
            fwd[g] = (l, j)
            rev[(l, j)] = g
            g += 1
    return fwd, rev
