"""Rows 25-28: the training and repair steps of the experiment path.

Four plain ``jax.jit`` functions of the JAX package run on its device:

* row 25, ``fairify_tpu/models/train.py:66`` ``step`` and row 26,
  ``fairify_tpu/analysis/repair.py:68`` ``_fit.step``: one ``optax.adam``
  step on the mean BCE of an MLP batch, row 26 with the gradient times a
  0/1 mask per parameter.  Both are :func:`bce_adam_step` (C entry point
  ``bce_adam_step``), counted as ``train_step`` and ``fit_step``;
* row 27, ``repair.py:284`` ``pair_step``: one Adam step on counterexample
  pairs, ``lw·½(BCE(x) + BCE(x')) + lc·mean((σ(f(x)) − σ(f(x')))²) +
  la·Σ(θ − θ₁)²`` (:func:`pair_adam_step`, counted as ``pair_step``);
* row 28, ``repair.py:303`` ``inconsistency``: ``mean|σ(f(x)) − σ(f(x'))|``
  over all pairs (:func:`pair_inconsistency`).

On the card each is one cooperative launch of ``csrc/train_step.cu``
(design and bound in its header): blocks own tiles of ``ROWS`` batch rows
for the forward and backward and write per-tile partial gradients, then,
after a grid sync, own chunks of ``THREADS`` parameters, sum the partials
in tile order and apply the mask and Adam — deterministic, two launches on
the same inputs bit-equal.  What bounds a step on the H100: about 6·MACs·B
flops less layer 0's input gradient (the pair step twice that) plus ~15 a
parameter, over 6·4·P bytes (7·4·P with the mask or the anchor) plus the
batch rows (:func:`step_cost`): a fraction of a microsecond of either at
the AC-S1 shape, so a launch is latency.

The parameters live in one flat f32 buffer θ (``models.mlp.param_offsets``:
per layer ``W`` (in, out) row-major, then ``b``), with Adam's ``m`` and ``v``
beside it; all three are updated **in place** (the JAX functions return
new arrays).  Adam follows optax's order and rounding (:func:`adam_consts`,
:func:`adam_plain`).  The hidden layers' alive masks (``net.masks``) come
as one flat buffer too (``models.mlp.alive_flat``).

Beside each wrapper its plain version: the loss's gradient by
``torch.autograd`` and Adam written out in torch ops.  A wrapper given CPU
tensors runs its plain version and counts nothing; given CUDA tensors it
launches its kernel (``obs.launches`` counts it) or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fairify_tpu_torch.models import mlp
from fairify_tpu_torch.models.mlp import param_offsets, unflatten
from fairify_tpu_torch.obs import launches
from fairify_tpu_torch.utils import cuda_build

THREADS = 256  # csrc/train_step.cu:TS_THREADS, also the parameters of a chunk
ROWS = 8       # batch rows (pairs) of a tile
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def forward_flat(theta: torch.Tensor, sizes, alive: torch.Tensor, x: torch.Tensor):
    """The masked MLP's logit from a flat θ (the plain versions' forward,
    autograd through θ's views), size-1 axis dropped."""
    ws, bs = unflatten(theta, sizes)
    *_, h = mlp.iter_layers(ws, bs, alive.split(list(sizes[1:])), x)
    return h.squeeze(-1)


def bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``: −y·log σ(x) − (1−y)·log σ(−x)."""
    return -y * F.logsigmoid(logits) - (1.0 - y) * F.logsigmoid(-logits)


def adam_consts(t: int, b1: float = B1, b2: float = B2, eps: float = EPS) -> Dict[str, np.float32]:
    """The f32 scalars of optax's step ``t`` (its count after the update):
    ``1 − b`` rounded from the double as optax's weak-typed Python scalars
    are, and the bias corrections ``1 − b^t`` in f32."""
    f = np.float32
    return dict(b1=f(b1), omb1=f(1.0 - b1), b2=f(b2), omb2=f(1.0 - b2), eps=f(eps),
                bc1=f(f(1.0) - f(b1) ** f(t)), bc2=f(f(1.0) - f(b2) ** f(t)))


def adam_plain(theta, m, v, g, t: int, lr: float, b1: float = B1, b2: float = B2,
               eps: float = EPS) -> None:
    """``optax.adam(lr)`` on flat buffers, in place: ``mu = (1−b1)·g +
    b1·mu``, ``nu = (1−b2)·g² + b2·nu``, ``u = (mu/bc1) / (sqrt(nu/bc2) +
    eps)``, ``θ = θ + (−lr)·u``; every operation one f32 rounding."""
    c = adam_consts(t, b1, b2, eps)
    s = lambda k: torch.tensor(c[k], dtype=torch.float32, device=theta.device)
    mu = s("omb1") * g + s("b1") * m
    nu = s("omb2") * (g * g) + s("b2") * v
    u = (mu / s("bc1")) / (torch.sqrt(nu / s("bc2")) + s("eps"))
    m.copy_(mu)
    v.copy_(nu)
    theta.copy_(theta + torch.tensor(np.float32(-lr), device=theta.device) * u)


def step_cost(sizes, B: int, pair: bool = False, masked: bool = False) -> Tuple[float, float]:
    """``(flops, bytes)`` of one step as the kernel does it.  Flops a row
    (a pair is two rows): the forward and the weight gradients 2 a MAC
    each, the input gradients 2 a MAC of every layer but the first (the
    step differentiates by the parameters alone, ``csrc/train_step.cu``
    skips layer 0's); a parameter: its tile partials summed, Adam's 14
    operations, the mask's product, the anchor's 6.  Bytes: θ, m, v read
    and written, the mask or the anchor read, the batch's rows, labels and
    int64 indices, the loss."""
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    _, P = param_offsets(sizes)
    rows = 2 * B if pair else B
    per_param = -(-B // ROWS) + 14 + (1 if masked else 0) + (6 if pair else 0)
    flops = 2.0 * (2 * macs + macs - sizes[0] * sizes[1]) * rows + per_param * P
    floats = (6 + (1 if masked else 0) + (1 if pair else 0)) * P + rows * sizes[0] + B + 1
    return flops, 4.0 * floats + 8.0 * B


def inconsistency_cost(sizes, n: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of row 28: two forwards (2 flops a MAC) of ``n``
    pairs; θ and the pairs read."""
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    _, P = param_offsets(sizes)
    return 4.0 * macs * n, 4.0 * (P + 2 * n * sizes[0])


def step_smem(sizes, pair: bool, rows: int = ROWS) -> int:
    """Dynamic shared memory of one block (``csrc/train_step.cu:ts_smem``):
    a tile's inputs and pre-activations, two gradient buffers of the widest
    layer, the per-row loss terms, the reduction buffer."""
    rr = 2 * rows if pair else rows
    return 4 * (rr * sum(sizes) + 2 * rr * max(sizes) + 3 * rows + THREADS)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

_dims_cache: Dict[tuple, object] = {}


def _dims(sizes):
    key = tuple(int(s) for s in sizes)
    if key not in _dims_cache:
        cuda_build._check_depth(len(key) - 1)
        _dims_cache[key] = cuda_build._dims(key)
    return _dims_cache[key]


def _check(sizes, theta, *tensors) -> None:
    cuda_build.require_cuda(theta, *tensors)
    if sizes[-1] != 1:
        raise ValueError("train_step: the net must have one output logit")
    if theta.numel() != param_offsets(sizes)[1]:
        raise ValueError("train_step: theta does not match the layer sizes")
    for t in (theta,) + tensors:
        if t.dtype not in (torch.float32, torch.int64):
            raise ValueError(f"train_step: unexpected dtype {t.dtype}")


def _loss_slot(loss_out, device):
    return torch.empty(1, dtype=torch.float32, device=device) if loss_out is None else loss_out


def _slot(loss: torch.Tensor, loss_out):
    """A plain version's loss as the wrappers return it: a 1-element
    tensor, written into ``loss_out`` when given."""
    if loss_out is None:
        return loss.reshape(1)
    return loss_out.copy_(loss.reshape(1))


def _bce_launch(theta, m, v, X, y, idx, sizes, alive, t, lr, mask, loss):
    B = int(idx.numel())
    tiles = -(-B // ROWS)
    P = theta.numel()
    work = cuda_build.scratch("train_step", theta.device, tiles * P + 3 * tiles)
    c = adam_consts(t)
    args = (_dims(sizes), ctypes.c_int(len(sizes) - 1), cuda_build.ptr(theta),
            cuda_build.ptr(m), cuda_build.ptr(v),
            ctypes.c_void_p(None if mask is None else mask.data_ptr()), cuda_build.ptr(alive),
            cuda_build.ptr(X), cuda_build.ptr(y), cuda_build.ptr(idx), ctypes.c_int(B),
            ctypes.c_float(lr), *(ctypes.c_float(float(c[k])) for k in (
                "b1", "omb1", "b2", "omb2", "eps", "bc1", "bc2")),
            cuda_build.ptr(work), ctypes.c_void_p(work.data_ptr() + 4 * tiles * P),
            cuda_build.ptr(loss), ctypes.c_int(ROWS), ctypes.c_int(THREADS),
            ctypes.c_longlong(step_smem(sizes, False)))
    return cuda_build.streamed_entry("train_step", "bce_adam_step", args), args


def bce_adam_step(theta, m, v, X, y, idx, sizes, alive, t: int, lr: float, mask=None,
                  loss_out=None, kernel: str = "train_step"):
    """Rows 25 (``kernel="train_step"``) and 26 (``"fit_step"``): one Adam
    step (optax's count after it: ``t``) on the mean BCE of the rows
    ``idx`` of ``(X, y)``, θ, m, v updated in place.  Returns the loss, a
    1-element tensor (``loss_out`` when given: a slot of a caller's
    buffer, so a loop reads its losses once)."""
    if theta.device.type == "cpu":
        return _slot(bce_adam_step_plain(theta, m, v, X, y, idx, sizes, alive, t, lr, mask),
                     loss_out)
    extra = () if mask is None else (mask,)
    _check(sizes, theta, m, v, X, y, idx, alive, *extra)
    loss = _loss_slot(loss_out, theta.device)
    with launches.launching(kernel, (int(idx.numel()),)):
        fn, args = _bce_launch(theta, m, v, X, y, idx, sizes, alive, t, lr, mask, loss)
        cuda_build.check("bce_adam_step", fn(*args, cuda_build.stream()))
    return loss


def bce_adam_step_plain(theta, m, v, X, y, idx, sizes, alive, t: int, lr: float, mask=None):
    """Plain version of rows 25 and 26: ``torch.autograd`` of the mean BCE,
    the mask, :func:`adam_plain`."""
    xb, yb = X[idx], y[idx]
    th = theta.detach().clone().requires_grad_(True)
    loss = bce(forward_flat(th, sizes, alive, xb), yb).mean()
    (g,) = torch.autograd.grad(loss, th)
    if mask is not None:
        g = g * mask
    adam_plain(theta, m, v, g, t, lr)
    return loss.detach()


def _pair_launch(theta, m, v, anchor, Xs, Xps, y, idx, sizes, alive, t, lr, weights, loss):
    B = int(idx.numel())
    tiles = -(-B // ROWS)
    P = theta.numel()
    chunks = -(-P // THREADS)
    work = cuda_build.scratch("train_step", theta.device, tiles * P + 3 * tiles + chunks)
    c = adam_consts(t)
    base = work.data_ptr()
    args = (_dims(sizes), ctypes.c_int(len(sizes) - 1), cuda_build.ptr(theta),
            cuda_build.ptr(m), cuda_build.ptr(v), cuda_build.ptr(anchor), cuda_build.ptr(alive),
            cuda_build.ptr(Xs), cuda_build.ptr(Xps), cuda_build.ptr(y), cuda_build.ptr(idx),
            ctypes.c_int(B), ctypes.c_float(lr), *(ctypes.c_float(float(c[k])) for k in (
                "b1", "omb1", "b2", "omb2", "eps", "bc1", "bc2")),
            *(ctypes.c_float(w) for w in weights), ctypes.c_void_p(base),
            ctypes.c_void_p(base + 4 * tiles * P),
            ctypes.c_void_p(base + 4 * (tiles * P + 3 * tiles)), cuda_build.ptr(loss),
            ctypes.c_int(ROWS), ctypes.c_int(THREADS), ctypes.c_longlong(step_smem(sizes, True)))
    return cuda_build.streamed_entry("train_step", "pair_adam_step", args), args


def pair_adam_step(theta, m, v, anchor, Xs, Xps, y, idx, sizes, alive, t: int, lr: float,
                   label_weight: float, cons_weight: float, anchor_weight: float,
                   loss_out=None):
    """Row 27: one Adam step on the pair loss of the pairs ``idx`` of
    ``(Xs, Xps, y)`` with anchor ``θ₁``; θ, m, v updated in place.  Returns
    the loss as :func:`bce_adam_step` does."""
    weights = (label_weight, cons_weight, anchor_weight)
    if theta.device.type == "cpu":
        return _slot(pair_adam_step_plain(theta, m, v, anchor, Xs, Xps, y, idx, sizes, alive,
                                          t, lr, *weights), loss_out)
    _check(sizes, theta, m, v, anchor, Xs, Xps, y, idx, alive)
    loss = _loss_slot(loss_out, theta.device)
    with launches.launching("pair_step", (int(idx.numel()),)):
        fn, args = _pair_launch(theta, m, v, anchor, Xs, Xps, y, idx, sizes, alive, t, lr,
                                weights, loss)
        cuda_build.check("pair_adam_step", fn(*args, cuda_build.stream()))
    return loss


def pair_loss(theta, anchor, xb, xpb, yb, sizes, alive, label_weight, cons_weight,
              anchor_weight):
    """``pair_step``'s loss (``fairify_tpu/analysis/repair.py:286-297``)."""
    lx = forward_flat(theta, sizes, alive, xb)
    lp = forward_flat(theta, sizes, alive, xpb)
    b = 0.5 * (bce(lx, yb).mean() + bce(lp, yb).mean())
    cons = torch.mean((torch.sigmoid(lx) - torch.sigmoid(lp)) ** 2)
    anc = torch.sum((theta - anchor) ** 2)
    return label_weight * b + cons_weight * cons + anchor_weight * anc


def pair_adam_step_plain(theta, m, v, anchor, Xs, Xps, y, idx, sizes, alive, t: int, lr: float,
                         label_weight: float, cons_weight: float, anchor_weight: float):
    """Plain version of row 27: ``torch.autograd`` of :func:`pair_loss`,
    :func:`adam_plain`."""
    th = theta.detach().clone().requires_grad_(True)
    loss = pair_loss(th, anchor, Xs[idx], Xps[idx], y[idx], sizes, alive, label_weight,
                     cons_weight, anchor_weight)
    (g,) = torch.autograd.grad(loss, th)
    adam_plain(theta, m, v, g, t, lr)
    return loss.detach()


def _inc_launch(theta, Xs, Xps, sizes, alive, out):
    n = int(Xs.shape[0])
    tiles = -(-n // ROWS)
    work = cuda_build.scratch("train_step", theta.device, 3 * tiles)
    args = (_dims(sizes), ctypes.c_int(len(sizes) - 1), cuda_build.ptr(theta),
            cuda_build.ptr(alive), cuda_build.ptr(Xs), cuda_build.ptr(Xps), ctypes.c_int(n),
            cuda_build.ptr(work), cuda_build.ptr(out), ctypes.c_int(ROWS),
            ctypes.c_int(THREADS), ctypes.c_longlong(step_smem(sizes, True)))
    return cuda_build.streamed_entry("train_step", "pair_inconsistency", args), args


def pair_inconsistency(theta, Xs, Xps, sizes, alive):
    """Row 28: ``mean|σ(f(x)) − σ(f(x'))|`` over the pairs ``(Xs, Xps)``,
    a 1-element tensor."""
    if theta.device.type == "cpu":
        return pair_inconsistency_plain(theta, Xs, Xps, sizes, alive).reshape(1)
    if Xs.shape != Xps.shape or Xs.shape[0] < 1:
        raise ValueError("pair_inconsistency: needs two (n, d) tensors, n >= 1")
    _check(sizes, theta, Xs, Xps, alive)
    out = torch.empty(1, dtype=torch.float32, device=theta.device)
    with launches.launching("pair_inconsistency", (int(Xs.shape[0]),)):
        fn, args = _inc_launch(theta, Xs, Xps, sizes, alive, out)
        cuda_build.check("pair_inconsistency", fn(*args, cuda_build.stream()))
    return out


def pair_inconsistency_plain(theta, Xs, Xps, sizes, alive):
    """Plain version of row 28."""
    return torch.mean(torch.abs(torch.sigmoid(forward_flat(theta, sizes, alive, Xs))
                                - torch.sigmoid(forward_flat(theta, sizes, alive, Xps))))
