"""Model stacking for the family path.

Port of ``fairify_tpu/parallel/mesh.py:stack_models``; the rest of that
module (device meshes, sharded placement) is ROADMAP queue 1, item 7.
"""
from __future__ import annotations

from typing import Sequence

import torch

from fairify_tpu_torch.models.mlp import MLP, StackedMLP


def stack_models(nets: Sequence[MLP]) -> StackedMLP:
    """Stack same-architecture nets on a leading model axis.

    Covers the reference's sequential model loop for families with a
    uniform architecture (the CP zoo is eleven 6-32-32-1 nets, SURVEY.md
    §2.4).  Raises ``ValueError`` on mixed architectures.
    """
    first = nets[0]
    if any(n.layer_sizes != first.layer_sizes or n.in_dim != first.in_dim for n in nets):
        raise ValueError("stack_models requires uniform architectures")
    stack = lambda attr, i: torch.stack([getattr(n, attr)[i] for n in nets])
    return StackedMLP([stack("weights", i) for i in range(first.depth)],
                      [stack("biases", i) for i in range(first.depth)],
                      [stack("masks", i) for i in range(first.depth)])
