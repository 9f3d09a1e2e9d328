"""Rows 29-30: the autoregressive column synthesizer's step and draw.

Two plain ``jax.jit`` functions of ``fairify_tpu/models/synth.py`` run on
the JAX package's device:

* row 29, ``synth.py:283`` ``step``: one ``optax.adam`` step on
  ``ARColumnModel.fit``'s masked-prefix NLL (:func:`synth_step`, C entry
  point ``synth_adam_step``, counted as ``synth_step``);
* row 30, ``synth.py:315`` ``draw``: ``ARColumnModel.sample``'s d column
  steps, each the trunk, the head and ``jax.random.categorical`` on the
  column's subkey (:func:`synth_draw`, C entry point ``synth_draw``,
  counted as ``synth_draw``).

On the card each is one launch of ``csrc/synth_step.cu`` (design and bound
in its header): the step is cooperative — tiles of ``ROWS`` batch rows
carry the forward and backward of their (row, target) pairs, then, after a
grid sync, a thread sums one parameter's gradient in a fixed order and
applies Adam, so two launches on the same inputs are bit-equal; the draw
walks the columns with a block of ``DRAW_ROWS`` rows.  Both use the
one-hot prefix's structure: layer 1 of target ``j`` is a running sum of
gathered ``w1`` rows, no ``(B, d, D)`` tensor.

The parameters live in one flat f32 buffer θ (:func:`param_layout`: ``w1
b1 w2 b2 wh bh`` end to end), with Adam's ``m`` and ``v`` beside it; the
step updates all three **in place** (the JAX function returns new arrays)
with optax's order and rounding (``ops/train_step.py:adam_plain``).  The
batch is an index vector into the dataset's ``(n, d)`` int32 class codes,
so an epoch uploads its permutation once.  The model's sizes and index
tensors come in one :class:`Shape`, made once per model.

Beside each wrapper its plain version, the JAX function's formulation in
torch ops: the dense one-hot einsums with ``torch.autograd`` and Adam
written out (row 29), and ``sample``'s loop with ``utils/prng.uniform``'s
bits and ``torch.argmax`` (row 30).  A wrapper given CPU tensors runs its
plain version and counts nothing; given CUDA tensors it launches its
kernel (``obs.launches`` counts it) or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fairify_tpu_torch.obs import launches
from fairify_tpu_torch.ops.train_step import adam_consts, adam_plain
from fairify_tpu_torch.utils import cuda_build, prng

THREADS = 256     # csrc/synth_step.cu:SS_THREADS, also the parameters of a chunk
ROWS = 2          # batch rows of a step tile
DRAW_THREADS = 128  # csrc/synth_step.cu:SD_THREADS
DRAW_ROWS = 8     # rows of a draw block
NEG = -1e30       # the padded classes' logit offset (synth.py's ``neg``)
TINY = float(np.finfo(np.float32).tiny)  # jax.random.gumbel's uniform floor
KEYS = ("w1", "b1", "w2", "b2", "wh", "bh")


def param_layout(d: int, D: int, H: int, kmax: int) -> Dict[str, Tuple[int, tuple]]:
    """``{key: (offset, shape)}`` of the six parameters in θ, end to end in
    ``KEYS`` order (``csrc/synth_step.cu:make_sdesc``)."""
    shapes = {"w1": (D, H), "b1": (H,), "w2": (H, H), "b2": (H,), "wh": (d, H, kmax),
              "bh": (d, kmax)}
    out, off = {}, 0
    for k in KEYS:
        out[k] = (off, shapes[k])
        off += int(np.prod(shapes[k]))
    return out


def n_params(d: int, D: int, H: int, kmax: int) -> int:
    off, shape = param_layout(d, D, H, kmax)["bh"]
    return off + int(np.prod(shape))


class Shape:
    """One model's sizes and its cardinalities' index tensors on one
    device, made once per model (``models.synth.ARColumnModel.shape``) and
    handed to every wrapper and plain version: a launch works nothing out
    on the host, and a CUDA-graph capture of a plain version copies
    nothing from it.

    ``card`` the columns' cardinalities (host ints), ``d, D, H, kmax``,
    ``P`` θ's length and ``layout`` (:func:`param_layout`); on ``device``:
    ``offsets`` (d) the one-hot block offsets, ``col_of`` (D) each slot's
    column, ``neg`` (d, kmax) f32, 0 on the real classes and −1e30 on the
    padded ones, and ``off32``, ``card32`` (d) the offsets and
    cardinalities as the kernels read them (int32)."""

    def __init__(self, card, H: int, device):
        self.card = tuple(int(c) for c in card)
        self.d, self.D, self.H, self.kmax = len(self.card), sum(self.card), int(H), max(self.card)
        self.layout = param_layout(self.d, self.D, self.H, self.kmax)
        self.P = n_params(self.d, self.D, self.H, self.kmax)
        c = torch.tensor(self.card, dtype=torch.int64)
        off = torch.cumsum(c, 0) - c
        neg = torch.where(torch.arange(self.kmax)[None, :] < c[:, None], 0.0, NEG)
        self.offsets, self.col_of, self.neg, self.off32, self.card32 = (t.to(device) for t in (
            off, torch.repeat_interleave(torch.arange(self.d), c), neg.to(torch.float32),
            off.to(torch.int32), c.to(torch.int32)))


def views(theta: torch.Tensor, shape: Shape) -> Dict[str, torch.Tensor]:
    """The six parameters as views of θ (autograd flows through them)."""
    return {k: theta[o:o + int(np.prod(s))].view(s) for k, (o, s) in shape.layout.items()}


def padded_mask(shape: Shape) -> torch.Tensor:
    """θ's entries of the padded classes (``wh``'s and ``bh``'s columns k >=
    card[j]), a CPU bool tensor: their gradient is 0, so a step leaves them
    and their m, v bit-unchanged."""
    d, H, kmax = shape.d, shape.H, shape.kmax
    pad = torch.zeros(shape.P, dtype=torch.bool)
    over = torch.arange(kmax)[None, :] >= torch.tensor(shape.card)[:, None]
    o, _ = shape.layout["wh"]
    pad[o:o + d * H * kmax] = over[:, None, :].expand(d, H, kmax).reshape(-1)
    o, _ = shape.layout["bh"]
    pad[o:o + d * kmax] = over.reshape(-1)
    return pad


def step_cost(shape: Shape, B: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of one step at batch ``B``, the least the
    function needs.  Per row, layer 1's running sums of the gathered
    ``w1`` rows ((d − 1)·H adds: target j's prefix is target j − 1's plus
    one row); per (row, target j) layer 2's forward and its two backward
    products (3 · 2·H² flops), the head's forward, input gradient and
    weight gradient over the K_j real classes (3 · 2·H·K_j), the softmax
    (~5·K_j), the bias gradients and the suffix sums of ∂pre1 (~3·H); per
    parameter Adam's 14 operations.  Bytes: θ, m, v read and written, the
    batch's codes and indices, the loss."""
    H = shape.H
    per_row = (shape.d - 1) * H + sum(6 * H * H + 6 * H * k + 5 * k + 3 * H for k in shape.card)
    flops = float(per_row) * B + 14.0 * shape.P
    return flops, 4.0 * (6 * shape.P + B * shape.d + 1) + 8.0 * B


def draw_cost(shape: Shape, n: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of one draw of ``n`` rows.  Per row and column j:
    the running w1 sum and h1 (2·H), layer 2 (2·H²), the head over the K_j
    real classes (2·H·K_j), the perturbation and the argmax (2·K_j); the
    two logarithms of each gumbel value are counted as one operation each.
    Bytes: θ read once, the keys, offsets and cardinalities (4·d words),
    the codes written."""
    H = shape.H
    per_row = sum(2 * H + 2 * H * H + 2 * H * k + 4 * k for k in shape.card)
    return float(per_row) * n, 4.0 * (shape.P + 4 * shape.d + n * shape.d)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def synth_loss(p: Dict[str, torch.Tensor], xb: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``ARColumnModel.fit``'s ``loss_fn`` (``synth.py:269-280``) on the
    class codes ``xb`` (B, d): the one-hot prefixes, the three einsums,
    ``log_softmax`` and −mean of the targets' log-probabilities."""
    dev = xb.device
    xb = xb.to(torch.int64)
    oh = torch.zeros((xb.shape[0], shape.D), dtype=torch.float32, device=dev)
    oh.scatter_(1, xb + shape.offsets[None, :], 1.0)
    causal = (shape.col_of[None, :] < torch.arange(shape.d, device=dev)[:, None]).to(torch.float32)
    pref = oh[:, None, :] * causal[None, :, :]
    h = torch.relu(torch.einsum("bdi,ih->bdh", pref, p["w1"]) + p["b1"])
    h = torch.relu(torch.einsum("bdh,hk->bdk", h, p["w2"]) + p["b2"])
    logits = torch.einsum("bdh,dhk->bdk", h, p["wh"]) + p["bh"] + shape.neg
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.take_along_dim(logp, xb[:, :, None], dim=-1)[..., 0]
    return -ll.mean()


def synth_step_plain(theta, m, v, codes, idx, shape: Shape, t: int, lr: float) -> torch.Tensor:
    """Plain version of row 29: ``torch.autograd`` of :func:`synth_loss` on
    the rows ``idx`` of ``codes``, then :func:`ops.train_step.adam_plain`."""
    th = theta.detach().clone().requires_grad_(True)
    loss = synth_loss(views(th, shape), codes[idx], shape)
    (g,) = torch.autograd.grad(loss, th)
    adam_plain(theta, m, v, g, t, lr)
    return loss.detach()


def column_keys(seed: int, d: int) -> torch.Tensor:
    """The subkey of each column of ``draw`` (``synth.py:321``): from
    ``key(seed)``, ``key, sub = split(key)`` per column; (d, 2) int64 on
    the CPU."""
    key, subs = prng.seed_key(seed), []
    for _ in range(d):
        key, sub = prng.split(key)
        subs.append(sub)
    return torch.stack(subs)


def gumbel(key: torch.Tensor, n: int, kmax: int, device) -> torch.Tensor:
    """``jax.random.gumbel(key, (n, kmax))`` in its default mode "low":
    ``−log(−log(uniform(key, minval=tiny, maxval=1)))`` (the bits
    bit-equal, the logarithms torch's)."""
    u = prng.uniform(key.to(device), (n, kmax), minval=TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def _trunk_head(p, shape: Shape, x: torch.Tensor, j: int) -> torch.Tensor:
    """Column ``j``'s logits from the one-hot prefixes ``x`` (n, D)."""
    h = torch.relu(x @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    return h @ p["wh"][j] + p["bh"][j] + shape.neg[j]


def perturbed_logits(theta, shape: Shape, keys, codes: torch.Tensor) -> torch.Tensor:
    """The plain draw's perturbed logits ``logits + gumbel(sub_j)`` of every
    column along the rows ``codes`` ((n, d) class codes: each column's
    prefix taken from them), (n, d, kmax) on θ's device; the padded
    classes hold −1e30 + gumbel."""
    dev = theta.device
    p = views(theta, shape)
    n = codes.shape[0]
    oh = torch.zeros((n, shape.D), dtype=torch.float32, device=dev)
    oh.scatter_(1, codes.to(device=dev, dtype=torch.int64) + shape.offsets[None, :], 1.0)
    out = []
    for j in range(shape.d):
        x = oh * (shape.col_of < j).to(torch.float32)[None, :]
        out.append(gumbel(keys[j], n, shape.kmax, dev) + _trunk_head(p, shape, x, j))
    return torch.stack(out, dim=1)


def near_ties(got, want, pert, card, rel: float):
    """Rows of the draw ``got`` that differ from the reference draw ``want``
    (both (n, d) class codes), judged on the reference's perturbed logits
    ``pert`` ((n, d, kmax), :func:`perturbed_logits`): a row may differ only
    where, at its first differing column, the reference's top two real
    classes lie within ``rel·max(1, |top|)`` and ``got`` picked one of them
    (the two versions sum the logits in other orders).  Returns ``(ties,
    bad)``: the count of such rows and the list of the others."""
    got, want = np.asarray(got), np.asarray(want)
    pert = np.asarray(pert)
    cards = [int(c) for c in card]
    ties, bad = 0, []
    for r in np.nonzero((got != want).any(axis=1))[0]:
        j = int(np.argmax(got[r] != want[r]))
        q = pert[r, j, :cards[j]]
        lo2, top = np.sort(q)[-2:] if len(q) > 1 else (q[0], q[0])
        if (top - lo2 <= rel * max(1.0, abs(float(top))) and got[r, j] < cards[j]
                and q[got[r, j]] >= lo2):
            ties += 1
        else:
            bad.append(int(r))
    return ties, bad


def synth_draw_plain(theta, shape: Shape, keys, n: int) -> torch.Tensor:
    """Plain version of row 30, ``sample``'s ``draw`` as JAX writes it: the
    one-hot ``x``, the trunk, ``argmax(logits + gumbel)`` per column, the
    drawn slot set.  Returns (n, d) int64 class codes."""
    dev = theta.device
    p = views(theta, shape)
    x = torch.zeros((n, shape.D), dtype=torch.float32, device=dev)
    cols = []
    for j in range(shape.d):
        logits = _trunk_head(p, shape, x, j)
        cj = torch.argmax(gumbel(keys[j], n, shape.kmax, dev) + logits, dim=-1)
        cols.append(cj)
        x.scatter_(1, (shape.offsets[j] + cj)[:, None], 1.0)
    return torch.stack(cols, dim=1)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def step_scratch(shape: Shape, B: int) -> int:
    """Floats of one step's scratch: h1, h2, ∂pre2 and the suffix sums
    (B·d·H each), the logit gradients (B·d·kmax), the tile partials and
    loss sums."""
    H, tiles = shape.H, -(-B // ROWS)
    return B * shape.d * (4 * H + shape.kmax) + tiles * (H * H + 2 * H + 1)


def _on(shape: Shape, theta: torch.Tensor, what: str) -> None:
    if theta.numel() != shape.P or shape.off32.device != theta.device:
        raise ValueError(f"{what}: theta does not match the model's shape or device")


def _step_launch(theta, m, v, codes, idx, shape: Shape, t, lr, loss):
    d, H, kmax = shape.d, shape.H, shape.kmax
    B = int(idx.numel())
    tiles = -(-B // ROWS)
    work = cuda_build.scratch("synth_step", theta.device, step_scratch(shape, B))
    base, act, hd = work.data_ptr(), B * d * H, B * d * kmax
    ptrs = [base + 4 * o for o in (0, act, 2 * act, 2 * act + hd, 3 * act + hd,
                                   4 * act + hd, 4 * act + hd + tiles * (H * H + 2 * H))]
    c = adam_consts(t)
    args = (ctypes.c_int(d), ctypes.c_int(shape.D), ctypes.c_int(H), ctypes.c_int(kmax),
            cuda_build.ptr(theta), cuda_build.ptr(m), cuda_build.ptr(v), cuda_build.ptr(codes),
            cuda_build.ptr(idx), cuda_build.ptr(shape.off32), cuda_build.ptr(shape.card32),
            ctypes.c_int(B), ctypes.c_float(lr), *(ctypes.c_float(float(c[k])) for k in (
                "b1", "omb1", "b2", "omb2", "eps", "bc1", "bc2")),
            *(ctypes.c_void_p(q) for q in ptrs), cuda_build.ptr(loss), ctypes.c_int(ROWS),
            ctypes.c_int(THREADS))
    return cuda_build.streamed_entry("synth_step", "synth_adam_step", args), args


def synth_step(theta, m, v, codes, idx, shape: Shape, t: int, lr: float, loss_out=None):
    """Row 29: one Adam step (optax's count after it: ``t``) on the
    masked-prefix NLL of the rows ``idx`` (int64) of ``codes`` ((n, d)
    class codes; int32 on the card), θ, m, v updated in place; ``shape``
    the model's :class:`Shape` on θ's device.  Returns the loss, a
    1-element tensor (``loss_out`` when given)."""
    if theta.device.type == "cpu":
        loss = synth_step_plain(theta, m, v, codes, idx, shape, t, lr).reshape(1)
        return loss if loss_out is None else loss_out.copy_(loss)
    cuda_build.require_cuda(theta, m, v, codes, idx)
    if theta.dtype != torch.float32 or codes.dtype != torch.int32 or idx.dtype != torch.int64:
        raise ValueError("synth_step: theta f32, codes int32 and idx int64 expected")
    if codes.dim() != 2 or codes.shape[1] != shape.d or idx.numel() < 1:
        raise ValueError("synth_step: codes must be (n, d) and the batch non-empty")
    _on(shape, theta, "synth_step")
    loss = (torch.empty(1, dtype=torch.float32, device=theta.device)
            if loss_out is None else loss_out)
    with launches.launching("synth_step", (int(idx.numel()),)):
        fn, args = _step_launch(theta, m, v, codes, idx, shape, t, lr, loss)
        cuda_build.check("synth_adam_step", fn(*args, cuda_build.stream()))
    return loss


def _draw_launch(theta, shape: Shape, keys, n, out, uniforms=None, col: int = -1):
    args = (ctypes.c_int(shape.d), ctypes.c_int(shape.D), ctypes.c_int(shape.H),
            ctypes.c_int(shape.kmax), cuda_build.ptr(theta), cuda_build.ptr(shape.off32),
            cuda_build.ptr(shape.card32), cuda_build.ptr(keys), cuda_build.ptr(out),
            ctypes.c_void_p(None if uniforms is None else uniforms.data_ptr()),
            ctypes.c_int(col), ctypes.c_int(n), ctypes.c_int(DRAW_ROWS),
            ctypes.c_int(DRAW_THREADS))
    return cuda_build.streamed_entry("synth_step", "synth_draw", args), args


def synth_draw(theta, shape: Shape, keys, n: int, uniforms=None, col: int = -1) -> torch.Tensor:
    """Row 30: ``n`` rows drawn column by column from θ with the column
    subkeys ``keys`` ((d, 2) int64, :func:`column_keys`).  Returns (n, d)
    class codes: int64 from the plain version on the CPU, int32 from the
    kernel on the card.  On the card, ``uniforms`` ((n, kmax) f32) receives
    column ``col``'s uniform draws of the real classes, for the checks."""
    if theta.device.type == "cpu":
        return synth_draw_plain(theta, shape, keys, n)
    cuda_build.require_cuda(theta)
    if theta.dtype != torch.float32 or n < 1:
        raise ValueError("synth_draw: theta f32 and n >= 1 expected")
    _on(shape, theta, "synth_draw")
    k32 = cuda_build.u32_keys(keys.to(torch.int64).cpu()).to(theta.device)
    out = torch.empty((n, shape.d), dtype=torch.int32, device=theta.device)
    with launches.launching("synth_draw", (n,)):
        fn, args = _draw_launch(theta, shape, k32, n, out, uniforms, col)
        cuda_build.check("synth_draw", fn(*args, cuda_build.stream()))
    return out
