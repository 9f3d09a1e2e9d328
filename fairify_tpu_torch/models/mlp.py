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
        *_, h = iter_layers(self.weights, self.biases, self.masks, x)
        return h.squeeze(-1)

    def numpy_params(self):
        """Host copies ``(weights, biases)`` for the exact replays."""
        return ([w.detach().cpu().numpy() for w in self.weights],
                [b.detach().cpu().numpy() for b in self.biases])


class StackedMLP(nn.Module):
    """M same-architecture nets on a leading model axis: ``weights[i]``
    (M, in_i, out_i), ``biases[i]`` and ``masks[i]`` (M, out_i) — the JAX
    package's stacked ``MLP`` pytree (``parallel.mesh.stack_models``)."""

    def __init__(self, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor],
                 masks: Sequence[torch.Tensor]):
        super().__init__()
        self.weights = nn.ParameterList([_frozen(w) for w in weights])
        self.biases = nn.ParameterList([_frozen(b) for b in biases])
        self.masks = nn.ParameterList([_frozen(m) for m in masks])

    @property
    def n_models(self) -> int:
        return int(self.weights[0].shape[0])

    @property
    def depth(self) -> int:
        return len(self.weights)

    @property
    def layer_sizes(self) -> tuple:
        return tuple(int(w.shape[2]) for w in self.weights)

    @property
    def in_dim(self) -> int:
        return int(self.weights[0].shape[1])

    @property
    def device(self) -> torch.device:
        return self.weights[0].device

    def model(self, m: int) -> MLP:
        """Model ``m`` as an :class:`MLP` (views of the stacked tensors)."""
        return MLP([w[m] for w in self.weights], [b[m] for b in self.biases],
                   [k[m] for k in self.masks])

    def unstack(self) -> list:
        return [self.model(m) for m in range(self.n_models)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits (M, ...) of every model for shared ``(..., d)`` inputs."""
        return torch.stack([net(x) for net in self.unstack()])

    def numpy_params(self, m: int):
        """Host copies ``(weights, biases)`` of model ``m``."""
        return ([w[m].detach().cpu().numpy() for w in self.weights],
                [b[m].detach().cpu().numpy() for b in self.biases])


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


def init_mlp(sizes, seed: int = 0, scale: float = 0.1, device=None) -> MLP:
    """He-scaled (``scale · sqrt(2 / fan_in)``) normal weights and zero
    biases from ``default_rng(seed)``: the same draws as the JAX package's
    ``models.train.init_mlp``."""
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for i in range(len(sizes) - 1):
        std = scale * np.sqrt(2.0 / sizes[i])
        ws.append(rng.normal(scale=std, size=(sizes[i], sizes[i + 1])).astype(np.float32))
        bs.append(np.zeros(sizes[i + 1], dtype=np.float32))
    return from_numpy(ws, bs, device=device)


def predict(net: MLP, x: torch.Tensor) -> torch.Tensor:
    """Boolean class decision ``logit > 0`` (sigmoid > 0.5), as the JAX
    package's ``predict``."""
    return net(x) > 0.0


def predict_rows(net: MLP, X) -> np.ndarray:
    """:func:`predict` of host rows (cast to f32) on the net's device, back
    as a host bool array."""
    x = torch.tensor(np.asarray(X, dtype=np.float32), device=net.device)
    with torch.no_grad():
        return predict(net, x).cpu().numpy()


def iter_layers(weights, biases, masks, x: torch.Tensor):
    """Post-activation output of each layer in turn: ``relu(z)·m`` on the
    hidden layers, the final one linear."""
    h, n = x, len(weights)
    for i, (w, b, m) in enumerate(zip(weights, biases, masks)):
        z = h @ w + b
        h = z if i == n - 1 else torch.relu(z) * m
        yield h


def layer_outputs(net: MLP, x: torch.Tensor) -> list:
    """Post-activation outputs of every layer (the final one linear), as
    the JAX package's ``layer_outputs``."""
    return list(iter_layers(net.weights, net.biases, net.masks, x))


# The flat parameter layout of the training kernels (csrc/train_step.cu):
# per layer W (in, out) row-major, then b, all layers in one f32 buffer.

def param_offsets(sizes: Sequence[int]):
    """``([(w_offset, b_offset) per layer], P)`` of the flat layout for
    widths ``(d, h1, ..., 1)``."""
    offs, off = [], 0
    for i in range(len(sizes) - 1):
        offs.append((off, off + sizes[i] * sizes[i + 1]))
        off += sizes[i] * sizes[i + 1] + sizes[i + 1]
    return offs, off


def unflatten(theta: torch.Tensor, sizes: Sequence[int]):
    """Views ``(weights, biases)`` of a flat buffer."""
    offs, _ = param_offsets(sizes)
    ws = [theta[wo:bo].view(sizes[i], sizes[i + 1]) for i, (wo, bo) in enumerate(offs)]
    bs = [theta[bo:bo + sizes[i + 1]] for i, (_, bo) in enumerate(offs)]
    return ws, bs


def widths(net: MLP) -> list:
    """``[d, h1, ..., 1]``: the widths :func:`param_offsets` takes."""
    return [net.in_dim] + list(net.layer_sizes)


def _pack(weights, biases, device) -> torch.Tensor:
    sizes = [int(weights[0].shape[0])] + [int(w.shape[1]) for w in weights]
    flat = torch.empty(param_offsets(sizes)[1], dtype=torch.float32, device=device)
    ws, bs = unflatten(flat, sizes)
    for dst, src in zip(ws + bs, list(weights) + list(biases)):
        dst.copy_(src.detach())
    return flat


def pack_params(net: MLP) -> torch.Tensor:
    """The trainable parameters as one flat f32 buffer on the net's device,
    in the layout of :func:`param_offsets`.  A copy."""
    return _pack(net.weights, net.biases, net.device)


def unpack_params(flat: torch.Tensor, net: MLP) -> MLP:
    """An :class:`MLP` with ``net``'s shape and masks and the parameters of
    ``flat`` (copied out of it)."""
    ws, bs = unflatten(flat, widths(net))
    return MLP([w.clone() for w in ws], [b.clone() for b in bs],
               [m.detach() for m in net.masks])


def alive_flat(net: MLP) -> torch.Tensor:
    """The layers' alive masks end to end, one flat f32 buffer."""
    return torch.cat([m.detach().reshape(-1) for m in net.masks]).to(torch.float32).contiguous()


def carry_params(weights, biases, masks=None, adam=None, device=None):
    """Carry a net, and optionally its Adam state, across from host arrays.

    ``weights``, ``biases`` (and ``masks``) as :func:`from_numpy` takes
    them; ``adam`` is optax's ``ScaleByAdamState`` as numpy arrays,
    ``(count, mu, nu)`` with ``mu`` and ``nu`` each ``(weights, biases)``
    leaves of the params pytree ``(net.weights, net.biases)``.  Returns the
    :class:`MLP` alone, or with ``adam`` ``(net, m, v, t)``: the flat
    first and second moments in :func:`pack_params`' layout and the step
    count.  The port keeps no optax object: this is how two runs, one per
    package, start from one state.
    """
    net = from_numpy(weights, biases, masks, device=device)
    if adam is None:
        return net
    count, mu, nu = adam
    as_t = lambda leaves: [torch.as_tensor(np.asarray(a, dtype=np.float32)) for a in leaves]
    flat = lambda tree: _pack(as_t(tree[0]), as_t(tree[1]), net.device)
    return net, flat(mu), flat(nu), int(np.asarray(count))


def excise(net: MLP) -> MLP:
    """Materialize the masks as a dense smaller network on the CPU (the JAX
    package's ``excise``): each hidden layer keeps only its alive neurons
    (mask > 0.5), with the next layer's rows cut to match.  Works on the
    numpy parameters; the result has the same dense widths as the JAX
    package's and computes what ``forward`` computes on the masked net.
    Used to feed the SMT emitter the small matrices the reference produces
    with ``prune_neurons`` (``utils/prune.py:950-977``)."""
    ws, bs = net.numpy_params()
    ms = [m.detach().cpu().numpy() for m in net.masks]
    n = len(ws)
    for i in range(n):
        keep = ms[i] > 0.5
        ws[i] = ws[i][:, keep]
        bs[i] = bs[i][keep]
        if i + 1 < n:
            ws[i + 1] = ws[i + 1][keep, :]
    return from_numpy(ws, bs, device="cpu")


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


def local_affine_np(weights, biases, x):
    """Exact local affine form of the logit at ``x``: ``(f(x), df/dx)`` in f64.

    A ReLU MLP is affine within the activation region of ``x``, so the
    gradient is the product of the weight matrices masked by the active
    units (up to f64 rounding; no autodiff).  Used by the flip-slab search
    (``verify.engine.slab_search``).
    """
    h = np.asarray(x, dtype=np.float64)
    n = len(weights)
    masks = []
    f = 0.0
    for i, (w, b) in enumerate(zip(weights, biases)):
        z = h @ np.asarray(w, dtype=np.float64) + np.asarray(b, dtype=np.float64)
        if i < n - 1:
            m = z > 0
            masks.append(m)
            h = z * m
        else:
            f = float(z[0])
    g = np.asarray(weights[-1], dtype=np.float64)[:, 0]
    for i in range(n - 2, -1, -1):
        g = np.asarray(weights[i], dtype=np.float64) @ (g * masks[i])
    return f, g


def predict_np(weights, biases, x: np.ndarray, dead=None) -> np.ndarray:
    """Host class decision: logit > 0."""
    return forward_np(weights, biases, x, dead=dead) > 0.0
