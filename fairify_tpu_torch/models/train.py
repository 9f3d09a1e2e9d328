"""From-scratch MLP training for synthetic zoo models.

Port of ``fairify_tpu/models/train.py``: a ReLU/sigmoid binary classifier
trained with Adam on the mean BCE, one epoch a ``default_rng(seed)``
permutation, the ragged last batch dropped, features standardized and the
affine folded into layer 0 afterwards.  Each step is row 25
(``ops/train_step.bce_adam_step``, counted as ``train_step``): one launch
on the card that gathers its batch by index, so the epoch's permutation is
one upload and the loop never syncs.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from fairify_tpu_torch.models.mlp import (MLP, alive_flat, from_numpy, init_mlp,
                                          pack_params, unpack_params)
from fairify_tpu_torch.ops import train_step
from fairify_tpu_torch.utils.num import resolve_device


def train_mlp(
    X,
    y,
    hidden: Sequence[int],
    epochs: int = 20,
    lr: float = 1e-3,
    batch_size: int = 128,
    seed: int = 0,
    standardize: bool = True,
    device=None,
    history: Optional[List[float]] = None,
) -> MLP:
    """Train a binary classifier MLP (ReLU hidden, logit output).

    The JAX function's parameters, then ``device`` (default ``cuda``) and
    ``history``: a list that, when given, receives each epoch's mean batch
    loss (read once an epoch).  With ``standardize`` the optimizer sees
    zero-mean/unit-variance features and the affine transform is folded
    into the first layer afterwards, so the returned network consumes the
    raw inputs.
    """
    dev = resolve_device(device)
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    if standardize:
        mu = X.mean(axis=0)
        sd = X.std(axis=0)
        sd[sd == 0] = 1.0
        X = (X - mu) / sd
    sizes = [X.shape[1], *hidden, 1]
    net = init_mlp(sizes, seed, device=dev)
    theta = pack_params(net)
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    alive = alive_flat(net)
    Xd = torch.from_numpy(np.ascontiguousarray(X)).to(dev)
    yd = torch.from_numpy(np.ascontiguousarray(y)).to(dev)
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    starts = range(0, n - batch_size + 1, batch_size)
    t = 0
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = torch.empty(len(starts), dtype=torch.float32, device=dev)
        for i, s in enumerate(starts):
            t += 1
            train_step.bce_adam_step(theta, m, v, Xd, yd, order[s:s + batch_size], sizes,
                                     alive, t, lr, loss_out=losses[i:i + 1],
                                     kernel="train_step")
        if history is not None:
            history.append(float(np.mean(losses.cpu().numpy().astype(np.float64)))
                           if len(starts) else float("nan"))
    out = unpack_params(theta, net)
    ws = [w.detach().cpu().numpy() for w in out.weights]
    bs = [b.detach().cpu().numpy() for b in out.biases]
    if standardize:
        # fold x -> (x-mu)/sd into layer 0: W' = W/sd, b' = b - (mu/sd)@W
        w0 = ws[0] / sd[:, None]
        b0 = bs[0] - (mu / sd) @ ws[0]
        ws[0] = w0.astype(np.float32)
        bs[0] = b0.astype(np.float32)
    return from_numpy(ws, bs, [mk.detach().cpu().numpy() for mk in net.masks], device=dev)
