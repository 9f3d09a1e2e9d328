"""Multi-host partition split (port of ``fairify_tpu/parallel/multihost.py``,
so far only :func:`host_slice`, which ``verify_model``'s ``host_index`` /
``host_count`` use).

The JAX package takes the process index and count from ``jax.distributed``;
the port takes them from ``torch.distributed`` when a process group is
initialised, and runs as process 0 of 1 otherwise.  The rest of the module
(``initialize``, ``allgather_verdicts``, ``merge_ledgers``, ``sweep_host``)
is ROADMAP queue 1, item 7.
"""
from __future__ import annotations

from typing import Optional, Tuple


def _process_index_count() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_slice(n_partitions: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> Tuple[int, int]:
    """Contiguous ``[start, stop)`` slice of the partition grid owned by one
    host: a deterministic balanced split (the first ``n % count`` hosts take
    one more), so any host can recompute every other host's assignment.
    Missing arguments come from ``torch.distributed`` (rank, world size)
    when a process group is initialised, else 0 and 1."""
    if process_index is None or process_count is None:
        rank, world = _process_index_count()
        pi = rank if process_index is None else process_index
        pc = world if process_count is None else process_count
    else:
        pi, pc = process_index, process_count
    base, rem = divmod(n_partitions, pc)
    start = pi * base + min(pi, rem)
    stop = start + base + (1 if pi < rem else 0)
    return start, stop
