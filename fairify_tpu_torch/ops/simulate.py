"""Keyed uniform-integer simulation + activation statistics.

Port of ``fairify_tpu/ops/simulate.py``.  The samples come from the
bit-exact threefry port (:func:`fairify_tpu_torch.utils.prng.simulate_boxes`);
the statistics are one batched forward pass whose per-neuron activation
counts reduce over the sample axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fairify_tpu_torch.utils.prng import simulate_boxes  # noqa: F401  (re-export)

# Partitions per batch of the plain versions' sample draws (KA and KD's
# plain versions materialise (rows, sim_size, d) samples at a time).
PLAIN_ROWS = 256


class ActivationStats(NamedTuple):
    candidates: tuple  # per layer, (..., out) 1.0 = never activated on samples
    positive_prob: tuple  # per layer, (..., out) fraction of samples activating


def mean_scale(size: int, device=None) -> torch.Tensor:
    """The f32 factor ``1 / size`` of a mean: XLA lowers ``jnp.mean`` to
    ``sum * (1 / size)``, not ``sum / size``, and the activation
    frequencies must match it bit for bit (the kernels do the same)."""
    return torch.reciprocal(torch.tensor(float(size), dtype=torch.float32,
                                         device=device))


def activation_stats(net, x: torch.Tensor) -> ActivationStats:
    """Per-neuron activation frequency over the sample axis of ``x``
    (..., N, d); the (linear) output layer is included, as in the JAX
    package (downstream pruning skips it)."""
    n = net.depth
    inv = mean_scale(x.shape[-2], x.device)
    h = x
    candidates, pos_prob = [], []
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        z = h @ w + b
        h = z if i == n - 1 else torch.relu(z) * m
        count = (h != 0.0).sum(dim=-2).to(torch.float32)
        candidates.append((count == 0.0).to(torch.float32))
        pos_prob.append(count * inv)
    return ActivationStats(tuple(candidates), tuple(pos_prob))
