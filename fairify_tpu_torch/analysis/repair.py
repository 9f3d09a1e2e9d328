"""Fairness repair: masked gradient repair and two-stage retraining.

Port of ``fairify_tpu/analysis/repair.py``:

* **Masked repair** (``src/AC/detect_bias.py:304-437``): only the localized
  biased neurons' incoming weights and biases train; every other
  parameter's gradient is multiplied by 0.
* **Two-stage retraining** (``src/AC/new_model.py:179-263``): stage 1
  fine-tunes on the original data; stage 2 trains on counterexample pairs
  with consensus labels, the pair-consistency loss and an anchor to the
  stage-1 weights, with guarded checkpoint selection.

The steps run on the device kernels of ``ops/train_step.py``: ``_fit``'s
step is row 26 (``fit_step``), the pair step row 27, the inconsistency
row 28.  Parameters, Adam's moments and the batches stay on the device; a
loop reads its losses once an epoch.  The eager forwards (labels,
snapshots) are plain torch, as they are eager ``jnp`` in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fairify_tpu_torch.models.mlp import (MLP, alive_flat, pack_params, predict_rows,
                                          unpack_params, widths)
from fairify_tpu_torch.ops import train_step


def bce_loss(net: MLP, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits (the reference trains sigmoid+BCE)."""
    return train_step.bce(net(x), y.to(torch.float32)).mean()


def neuron_gradient_masks(net: MLP, targets: Sequence[Tuple[int, int]]) -> MLP:
    """Masks selecting only the (layer, neuron) targets' incoming weights
    (``create_neuron_masks``, ``src/AC/detect_bias.py:320-347``): column j
    of ``weights[l]`` and ``biases[l][j]`` for each target (l, j), 0
    elsewhere; the net's own alive masks ride along."""
    wmasks = [torch.zeros_like(w) for w in net.weights]
    bmasks = [torch.zeros_like(b) for b in net.biases]
    for l, j in targets:
        wmasks[l][:, j] = 1.0
        bmasks[l][j] = 1.0
    return MLP(wmasks, bmasks, [m.detach() for m in net.masks])


@dataclass
class RepairResult:
    net: MLP
    history: List[dict]


def _device_rows(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a), dtype=np.float32)).to(device)


def _fit(net: MLP, X, y, lr: float, epochs: int, batch_size: int, seed: int,
         grad_mask: Optional[MLP] = None):
    """``epochs`` of Adam(``lr``) on the mean BCE over a ``default_rng(seed)``
    permutation an epoch, the ragged last batch kept; each step row 26.
    Returns the trained net and one ``{"epoch", "loss"}`` record an epoch
    (the mean of its batch losses)."""
    dev = net.device
    sizes = widths(net)
    Xd, yd = _device_rows(X, dev), _device_rows(y, dev)
    theta = pack_params(net)
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    alive = alive_flat(net)
    mask = None if grad_mask is None else pack_params(grad_mask)
    rng = np.random.default_rng(seed)
    n = Xd.shape[0]
    starts = range(0, n, batch_size)
    history, t = [], 0
    for epoch in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = torch.empty(len(starts), dtype=torch.float32, device=dev)
        for i, s in enumerate(starts):
            t += 1
            train_step.bce_adam_step(theta, m, v, Xd, yd, order[s:s + batch_size], sizes,
                                     alive, t, lr, mask=mask, loss_out=losses[i:i + 1],
                                     kernel="fit_step")
        history.append({"epoch": epoch,
                        "loss": float(np.mean(losses.cpu().numpy().astype(np.float64)))})
    return unpack_params(theta, net), history


def masked_repair(
    net: MLP,
    targets: Sequence[Tuple[int, int]],
    X, y,
    epochs: int = 5,
    lr: float = 1e-3,
    batch_size: int = 32,
    seed: int = 0,
) -> RepairResult:
    """Gradient-masked fine-tune updating only the biased neurons
    (``masked_train_step``, ``src/AC/detect_bias.py:350-405``)."""
    mask = neuron_gradient_masks(net, targets)
    repaired, history = _fit(net, X, y, lr, epochs, batch_size, seed, grad_mask=mask)
    return RepairResult(repaired, history)


def same_label_relabel_retrain(
    net: MLP,
    ce_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    epochs: int = 5,
    lr: float = 1e-3,
    batch_size: int = 32,
    seed: int = 0,
) -> RepairResult:
    """The reference's conservative same-label relabeling retrain
    (``src/AC/detect_bias.py:412-433``), the measured baseline arm: both
    points of each pair labeled with the *max* of the model's two
    predictions, then plain BCE on that set for ``epochs``."""
    if not ce_pairs:
        return RepairResult(net, [])
    xs = np.stack([p[0] for p in ce_pairs]).astype(np.float32)
    xps = np.stack([p[1] for p in ce_pairs]).astype(np.float32)
    px = predict_rows(net, xs).astype(np.float32)
    pp = predict_rows(net, xps).astype(np.float32)
    labels = np.maximum(px, pp)  # detect_bias.py:421 ``max(...)``
    X_ce = np.concatenate([xs, xps], axis=0)
    y_ce = np.concatenate([labels, labels], axis=0)
    repaired, history = _fit(net, X_ce, y_ce, lr, epochs, batch_size, seed)
    return RepairResult(repaired, history)


def _group_snapshot(netp: MLP, Xv: torch.Tensor, yv, prot: np.ndarray) -> dict:
    """Val accuracy + the group metrics the success criteria guard."""
    from fairify_tpu_torch.analysis import metrics as gm

    with torch.no_grad():
        pred = (netp(Xv) > 0.0).cpu().numpy().astype(int)
    yv = np.asarray(yv)
    return {
        "acc": float((pred == yv).mean()),
        "di": gm.disparate_impact(pred, prot),
        "spd": gm.statistical_parity_difference(pred, prot),
        "eod": gm.equal_opportunity_difference(yv, pred, prot),
        "aod": gm.average_odds_difference(yv, pred, prot),
    }


# Shared repair-success bar: the checkpoint guard here and the experiment's
# ``repair_success`` build on these helpers, so the two cannot diverge.
GROUP_TOL = 0.02


def derive_accuracy_floor(orig_acc: float) -> float:
    """The reference's 0.80 floor (``new_model.py:233-241``), or half a
    point under the model's own accuracy where that is below it."""
    return min(0.80, orig_acc - 0.005)


def di_not_worse(after_di: float, before_di: float, tol: float = GROUP_TOL) -> bool:
    """Disparate impact no farther from 1 (within tol)."""
    return abs(after_di - 1.0) <= abs(before_di - 1.0) + tol


def magnitude_not_worse(after: float, before: float, tol: float = GROUP_TOL) -> bool:
    """|metric| not worse (within tol) — SPD/EOD/AOD style differences."""
    return abs(after) <= abs(before) + tol


def _not_worse(after: dict, before: dict, tol: float) -> bool:
    """DI no farther from 1; |SPD|/|EOD|/|AOD| not worse (within tol)."""
    return di_not_worse(after["di"], before["di"], tol) and all(
        magnitude_not_worse(after[k], before[k], tol)
        for k in ("spd", "eod", "aod"))


def counterexample_retrain(
    net: MLP,
    X, y,
    ce_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    X_val, y_val,
    stage1_epochs: int = 0,
    stage2_epochs: int = 10,
    stage1_lr: float = 1e-3,
    stage2_lr: float = 5e-3,
    accuracy_floor: Optional[float] = None,
    batch_size: int = 64,
    seed: int = 0,
    pair_consistency_weight: float = 4.0,
    anchor_weight: float = 1e-4,
    protected_col: Optional[int] = None,
    group_tol: float = GROUP_TOL,
    stage2_steps_per_epoch: int = 150,
    label_weight: float = 0.5,
) -> RepairResult:
    """Two-stage fairness retraining (``src/AC/new_model.py:179-263``), as
    the JAX package's: consensus labels (1 iff the pair's mean sigmoid
    under the stage-1 net exceeds ½), the stage-2 loss ``λl·BCE +
    λc·mean((σ(f(x)) − σ(f(x')))²) + λa·‖θ − θ_stage1‖²`` on batches
    resampled with replacement from ``default_rng(seed + 1)`` (a fixed
    step count an epoch), and guarded checkpoint selection after each
    epoch: the accuracy floor, group metrics no worse than the original's
    (with ``protected_col``), then the lowest pair inconsistency; no
    floor-holding epoch hands back the original net."""
    dev = net.device
    sizes = widths(net)
    Xv = _device_rows(X_val, dev)
    yv = np.asarray(y_val)
    prot = np.asarray(X_val)[:, protected_col] if protected_col is not None else None
    baseline = _group_snapshot(net, Xv, yv, prot) if prot is not None else None
    if accuracy_floor is None:
        with torch.no_grad():
            orig = (net(Xv) > 0.0).cpu().numpy().astype(int)
        accuracy_floor = derive_accuracy_floor(float((orig == yv).mean()))

    stage1, hist1 = _fit(net, X, y, stage1_lr, stage1_epochs, batch_size, seed)
    history = list(hist1)
    if not ce_pairs:
        return RepairResult(stage1, history)

    xs = np.stack([p[0] for p in ce_pairs]).astype(np.float32)
    xps = np.stack([p[1] for p in ce_pairs]).astype(np.float32)
    xs_d, xps_d = _device_rows(xs, dev), _device_rows(xps, dev)
    with torch.no_grad():
        probs = 0.5 * (torch.sigmoid(stage1(xs_d)) + torch.sigmoid(stage1(xps_d)))
    y_d = (probs > 0.5).to(torch.float32).contiguous()

    alive = alive_flat(net)
    anchor = pack_params(stage1)
    theta = anchor.clone()
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    rng = np.random.default_rng(seed + 1)
    n = xs.shape[0]
    # Fixed optimizer-step count per epoch, batches resampled with
    # replacement: a small counterexample set must not starve the repair.
    steps = max(stage2_steps_per_epoch, -(-n // batch_size))
    b = min(batch_size, n)
    candidates = []  # (tier, inconsistency, −acc, epoch, θ)
    t = 0
    for epoch in range(stage2_epochs):
        idx = torch.from_numpy(np.stack([rng.integers(0, n, size=b)
                                         for _ in range(steps)])).to(dev)
        losses = torch.empty(steps, dtype=torch.float32, device=dev)
        for k in range(steps):
            t += 1
            train_step.pair_adam_step(theta, m, v, anchor, xs_d, xps_d, y_d, idx[k], sizes,
                                      alive, t, stage2_lr, label_weight,
                                      pair_consistency_weight, anchor_weight,
                                      loss_out=losses[k:k + 1])
        snap_net = unpack_params(theta, net)
        inc = float(train_step.pair_inconsistency(theta, xs_d, xps_d, sizes, alive).item())
        if prot is not None:
            snap = _group_snapshot(snap_net, Xv, yv, prot)
        else:
            with torch.no_grad():
                pred = (snap_net(Xv) > 0.0).cpu().numpy().astype(int)
            snap = {"acc": float((pred == yv).mean())}
        ok_floor = snap["acc"] >= accuracy_floor
        ok_group = baseline is None or _not_worse(snap, baseline, group_tol)
        history.append({"epoch": f"stage2-{epoch}",
                        "loss": float(np.mean(losses.cpu().numpy().astype(np.float64))),
                        "val_acc": snap["acc"], "pair_inconsistency": inc,
                        "floor_ok": ok_floor, "group_ok": ok_group})
        if ok_floor:
            candidates.append((0 if ok_group else 1, inc, -snap["acc"], epoch, theta.clone()))
        if not ok_floor:  # accuracy floor early stop, new_model.py:233-241
            break
    if candidates:
        # Qualified epochs (group guard holds) outrank unqualified; then
        # lowest pair inconsistency, then accuracy.
        candidates.sort(key=lambda c: c[:3])
        tier, inc, nacc, epoch, best = candidates[0]
        history.append({"selected": f"stage2-{epoch}", "group_ok": tier == 0,
                        "pair_inconsistency": inc, "val_acc": -nacc})
        return RepairResult(unpack_params(best, net), history)
    # No floor-holding epoch: refuse the repair and hand back the ORIGINAL net.
    history.append({"selected": "original", "group_ok": False})
    return RepairResult(net, history)
