"""The individual-fairness pair property, encoded for static-shape kernels.

Copy of ``fairify_tpu/verify/property.py`` (the port imports nothing of ``fairify_tpu``).

Reference semantics (``src/GC/Verify-GC.py:134-154`` + constraint builders in
``utils/verif_utils.py:631-945``):

* ``x`` and ``x'`` are integer points; for every protected attribute (PA)
  ``x[i] != x'[i]`` (conjunction over PA); for every relaxed attribute (RA)
  ``|x[i] - x'[i]| <= ε``; every other attribute is equal.
* Domain box: PA dims of *both* points are box-constrained; non-PA dims are
  box-constrained on ``x`` only (``in_const_domain_german``,
  ``utils/verif_utils.py:743-760`` — the ``x_`` constraint is commented out),
  so an RA-shifted ``x'`` may leave the box by up to ε.
* Violation: strict sign flip on the logits,
  ``Or(And(y<0, y_>0), And(y>0, y_<0))`` (``src/GC/Verify-GC.py:154``).

Kernel encoding: PA dims have tiny integer ranges, so instead of free variables
the engine *enumerates* all PA assignments of the full domain (a static set,
V = Π width(PA)) and expresses the pair as (shared non-PA coordinates,
assignment a for ``x``, assignment b for ``x'``) with the valid-(a,b) matrix
``a_i != b_i`` for every PA dim.  Each assignment yields two *role boxes*
per partition box — the ``x`` role (PA pinned, other dims = box) and the
``x'`` role (PA pinned, RA dims widened ±ε, unclamped) — which batch
directly into the CROWN/IBP kernels.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from fairify_tpu_torch.data.domains import DomainSpec


@dataclass(frozen=True)
class FairnessQuery:
    """One verification question: domain + protected/relaxed attributes.

    The 21 reference drivers are instances of this (plus partition policy):
    base = PA only; relaxed adds RA/ε (``relaxed/AC/Verify-AC.py:48-51``);
    targeted/targeted2 override domain ranges (``targeted/GC/Verify-GC.py:55``).
    """

    domain: DomainSpec
    protected: Tuple[str, ...]
    relaxed: Tuple[str, ...] = ()
    relax_eps: int = 0

    def __post_init__(self):
        for a in tuple(self.protected) + tuple(self.relaxed):
            if a not in self.domain.ranges:
                raise KeyError(f"{self.domain.name}: unknown attribute {a}")
        if set(self.protected) & set(self.relaxed):
            raise ValueError("an attribute cannot be both protected and relaxed")

    @property
    def columns(self) -> Tuple[str, ...]:
        return self.domain.columns

    @property
    def pa_idx(self) -> np.ndarray:
        return np.array([self.columns.index(a) for a in self.protected], dtype=np.int32)

    @property
    def ra_idx(self) -> np.ndarray:
        return np.array([self.columns.index(a) for a in self.relaxed], dtype=np.int32)

    @property
    def dim(self) -> int:
        return len(self.columns)


@dataclass(frozen=True)
class PairEncoding:
    """Static tensors encoding the property for a query.

    ``assignments``: (V, n_pa) int32 — every PA assignment in the full domain.
    ``valid_pair``: (V, V) bool — all PA attrs differ between a and b.
    ``pa_idx``/``ra_idx``: dimension indices; ``eps``: RA radius.
    """

    pa_idx: np.ndarray
    ra_idx: np.ndarray
    eps: int
    assignments: np.ndarray
    valid_pair: np.ndarray
    n_dim: int = field(default=0)

    @property
    def n_assign(self) -> int:
        return int(self.assignments.shape[0])


def encode(query: FairnessQuery, max_assignments: int = 1024) -> PairEncoding:
    """Enumerate PA assignments and the valid-pair matrix for a query."""
    pa_idx = query.pa_idx
    ranges = [query.domain.ranges[a] for a in query.protected]
    sizes = [hi - lo + 1 for lo, hi in ranges]
    total = int(np.prod(sizes)) if sizes else 1
    if total > max_assignments:
        raise ValueError(
            f"PA assignment space {total} exceeds {max_assignments}; "
            "protected attributes must have small integer ranges"
        )
    assignments = np.array(
        list(itertools.product(*(range(lo, hi + 1) for lo, hi in ranges))),
        dtype=np.int32,
    ).reshape(total, len(pa_idx))
    # (a, b) is a legal pair iff every PA coordinate differs (conjunction of
    # `neq`, matching in_const_german(..., 'neq', x_)).
    diff = assignments[:, None, :] != assignments[None, :, :]
    valid = diff.all(axis=2) if len(pa_idx) else np.zeros((total, total), dtype=bool)
    return PairEncoding(
        pa_idx=pa_idx,
        ra_idx=query.ra_idx,
        eps=int(query.relax_eps),
        assignments=assignments,
        valid_pair=valid,
        n_dim=query.dim,
    )


def role_boxes(enc: PairEncoding, lo: np.ndarray, hi: np.ndarray):
    """Role boxes for a batch of partition boxes.

    ``lo``/``hi``: (..., d) float/int arrays.  Returns
    ``(x_lo, x_hi, xp_lo, xp_hi, valid_assign)`` where the role boxes have
    shape (..., V, d) and ``valid_assign`` (..., V) marks assignments whose
    PA values lie inside the partition box (PA dims of both points are
    box-constrained, ``utils/verif_utils.py:752-754``).
    """
    lo = np.asarray(lo, dtype=np.float32)
    hi = np.asarray(hi, dtype=np.float32)
    V = enc.n_assign
    x_lo = np.repeat(lo[..., None, :], V, axis=-2).copy()
    x_hi = np.repeat(hi[..., None, :], V, axis=-2).copy()
    assign = enc.assignments.astype(np.float32)  # (V, n_pa)
    if len(enc.pa_idx):
        x_lo[..., :, enc.pa_idx] = assign
        x_hi[..., :, enc.pa_idx] = assign
        valid = (
            (assign >= lo[..., None, enc.pa_idx]) & (assign <= hi[..., None, enc.pa_idx])
        ).all(axis=-1)
    else:
        valid = np.zeros(lo.shape[:-1] + (V,), dtype=bool)
    xp_lo = x_lo.copy()
    xp_hi = x_hi.copy()
    if len(enc.ra_idx) and enc.eps:
        xp_lo[..., :, enc.ra_idx] -= enc.eps
        xp_hi[..., :, enc.ra_idx] += enc.eps
    return x_lo, x_hi, xp_lo, xp_hi, valid
