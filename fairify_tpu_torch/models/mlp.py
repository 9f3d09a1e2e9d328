"""Static-shape masked MLP — the port's network representation.

PyTorch counterpart of ``fairify_tpu/models/mlp.py``: a fully connected
ReLU network with a linear final layer, weights in the Keras ``(in, out)``
layout, and per-layer *alive* masks (1 = alive, 0 = pruned) instead of
excision, so every kernel sees static shapes.  Parameters carry no
gradients: verification never trains.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from fairify_tpu_torch.utils import num as _num  # noqa: F401  (numeric policy)
from fairify_tpu_torch.utils.num import resolve_device


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class MLP(nn.Module):
    """``weights[i]`` (in_i, out_i), ``biases[i]`` (out_i,), ``masks[i]``
    (out_i,) float32; the final layer's mask is all ones."""

    def __init__(self, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor],
                 masks: Sequence[torch.Tensor]):
        super().__init__()
        self.weights = nn.ParameterList([_frozen(w) for w in weights])
        self.biases = nn.ParameterList([_frozen(b) for b in biases])
        self.masks = nn.ParameterList([_frozen(m) for m in masks])

    @property
    def depth(self) -> int:
        return len(self.weights)

    @property
    def layer_sizes(self) -> tuple:
        return tuple(int(w.shape[1]) for w in self.weights)

    @property
    def in_dim(self) -> int:
        return int(self.weights[0].shape[0])

    @property
    def device(self) -> torch.device:
        return self.weights[0].device

    def with_masks(self, masks: Sequence[torch.Tensor]) -> "MLP":
        return MLP(list(self.weights), list(self.biases), list(masks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logit for ``(..., d)`` inputs; the size-1 logit axis is dropped."""
        h = x
        n = self.depth
        for i, (w, b, m) in enumerate(zip(self.weights, self.biases, self.masks)):
            z = h @ w + b
            h = z if i == n - 1 else torch.relu(z) * m
        return h.squeeze(-1)

    def numpy_params(self):
        """Host copies ``(weights, biases)`` for the exact replays."""
        return ([w.detach().cpu().numpy() for w in self.weights],
                [b.detach().cpu().numpy() for b in self.biases])


def from_numpy(weights, biases, masks=None, device=None) -> MLP:
    """Build an :class:`MLP` from host weight/bias lists (float32).

    ``device`` defaults to ``cuda`` (see ``utils.num.resolve_device``); the
    tests pass ``"cpu"``.
    """
    dev = resolve_device(device)
    as_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=dev)
    ws = [as_t(w) for w in weights]
    bs = [as_t(b) for b in biases]
    ms = [torch.ones_like(b) for b in bs] if masks is None else [as_t(m) for m in masks]
    return MLP(ws, bs, ms)


def flagship_net(device=None) -> MLP:
    """The seeded GC-1 twin (20-50-1): the same ``default_rng(0)`` draws,
    scales and sizes as the JAX package's synthetic flagship net."""
    rng = np.random.default_rng(0)
    sizes = (20, 50, 1)  # GC-1's architecture
    ws = [rng.normal(scale=0.3, size=(sizes[i], sizes[i + 1])).astype(np.float32)
          for i in range(len(sizes) - 1)]
    bs = [rng.normal(scale=0.1, size=(sizes[i + 1],)).astype(np.float32)
          for i in range(len(sizes) - 1)]
    return from_numpy(ws, bs, device=device)


def seeded_net(sizes, seed: int = 0, device=None) -> MLP:
    """A seeded random net of the given widths ``(d, h1, ..., 1)``.

    He-scaled normal weights (``sqrt(2 / fan_in)``) keep the hidden
    activations of deep nets in a useful range; used where a published
    architecture is run without its trained weights.
    """
    rng = np.random.default_rng(seed)
    ws = [rng.normal(scale=np.sqrt(2.0 / sizes[i]),
                     size=(sizes[i], sizes[i + 1])).astype(np.float32)
          for i in range(len(sizes) - 1)]
    bs = [rng.normal(scale=0.1, size=(sizes[i + 1],)).astype(np.float32)
          for i in range(len(sizes) - 1)]
    return from_numpy(ws, bs, device=device)


def forward_np(weights, biases, x: np.ndarray, dead=None) -> np.ndarray:
    """Host float64 logit replay; ``dead`` = per-hidden-layer dead masks."""
    h = np.asarray(x, dtype=np.float64)
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        z = h @ np.asarray(w, dtype=np.float64) + np.asarray(b, dtype=np.float64)
        if i < n - 1:
            z = np.maximum(z, 0.0)
            if dead is not None:
                z = z * (1.0 - np.asarray(dead[i], dtype=np.float64))
        h = z
    return h[..., 0]


def predict_np(weights, biases, x: np.ndarray, dead=None) -> np.ndarray:
    """Host class decision: logit > 0."""
    return forward_np(weights, biases, x, dead=dead) > 0.0
