"""Input-domain partitioning (copy of ``fairify_tpu/partition/grid.py``).

Semantics match the reference engine (``utils/input_partition.py``):

* ``partition_attributes`` chunks every attribute whose inclusive integer
  range is wider than the threshold into consecutive sub-ranges
  (``utils/input_partition.py:17-46``); ``product_boxes`` takes the
  cartesian product of the chunked attributes, leaving narrow attributes
  at full range (``utils/input_partition.py:48-76``).
* the capped variant bounds combinatorial blow-up, partitioning protected
  attributes first and sampling excess combinations
  (``utils/input_partition.py:78-182``).
* ``chunk_spans`` / ``segment_spans`` / ``pad_rows`` / ``pad_chunk_axis``
  fix the chunk and segment structure every stage-0 pass shares.

The output of the grid is a pair of integer arrays ``(lo, hi)`` of shape
``(P, d)`` — the box tensor every stage-0 kernel consumes; partitions are
rows.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np

Range = Tuple[int, int]
RangeDict = Dict[str, Sequence[int]]


def partition_attributes(range_dict: RangeDict, partition_size: int) -> Dict[str, List[Range]]:
    """Chunk each attribute range wider than ``partition_size`` (inclusive width)."""
    out: Dict[str, List[Range]] = {}
    for col, (low, high) in range_dict.items():
        width = high - low + 1
        if width <= partition_size:
            continue
        parts = []
        cur = low
        while cur <= high:
            parts.append((cur, min(cur + partition_size - 1, high)))
            cur += partition_size
        out[col] = parts
    return out


def partition_attributes_capped(range_dict: RangeDict, partition_size: int) -> Dict[str, List[Range]]:
    """Capped-variant chunking: width measured exclusively (``high - low``),
    as the DF driver does (``utils/input_partition.py:91-95``)."""
    out: Dict[str, List[Range]] = {}
    for col, (low, high) in range_dict.items():
        if high - low <= partition_size:
            continue
        parts = []
        cur = low
        while cur < high:
            parts.append((cur, min(cur + partition_size - 1, high)))
            cur = parts[-1][1] + 1
        if parts:
            out[col] = parts
    return out


def partitioned_ranges_capped(
    attrs: Sequence[str],
    protected: Sequence[str],
    p_dict: Dict[str, List[Range]],
    range_dict: RangeDict,
    max_partitions: int = 100,
    rng: np.random.Generator | None = None,
) -> List[RangeDict]:
    """Capped cartesian expansion, protected attributes first.

    Mirrors ``partitioned_ranges_df`` (``utils/input_partition.py:111-182``):
    include PA chunkings unconditionally, then add other chunked attributes
    while the product stays within ``max_partitions``; attributes left out
    keep their full range; if the product still overflows, sample
    ``max_partitions`` combinations (seeded generator here, not global
    ``random``, for reproducibility).
    """
    rng = rng or np.random.default_rng(0)
    base = {a: tuple(range_dict[a]) for a in attrs if a not in p_dict}
    if not p_dict:
        return [dict(base)]

    priority = [a for a in protected if a in p_dict]
    others = [a for a in p_dict if a not in priority]

    chosen: List[str] = []
    estimated = 1
    for a in priority:
        estimated *= len(p_dict[a])
        chosen.append(a)
    for a in others:
        if estimated * len(p_dict[a]) <= max_partitions:
            estimated *= len(p_dict[a])
            chosen.append(a)
        else:
            base[a] = tuple(range_dict[a])

    if not chosen:
        return [dict(base)]

    combos = list(itertools.product(*(p_dict[a] for a in chosen)))
    if len(combos) > max_partitions:
        idx = rng.choice(len(combos), size=max_partitions, replace=False)
        combos = [combos[i] for i in sorted(idx)]

    boxes = []
    for combo in combos:
        box = dict(base)
        for attr, rngpair in zip(chosen, combo):
            box[attr] = tuple(rngpair)
        boxes.append(box)
    return boxes


def boxes_from_partitions(p_list: Sequence[RangeDict], columns: Sequence[str]):
    """Stack a partition list into ``(lo, hi)`` int32 arrays of shape (P, d)."""
    lo = np.array([[p[c][0] for c in columns] for p in p_list], dtype=np.int32)
    hi = np.array([[p[c][1] for c in columns] for p in p_list], dtype=np.int32)
    return lo, hi


def chunk_spans(n: int, chunk: int):
    """(step, [(start, stop), ...]) fixed-`chunk` spans over n rows (0 = one span).

    Stage-0 kernels iterate the partition grid in these spans so device
    memory stays bounded on huge grids; every consumer (pruning, certify/
    attack, parity) must use the same spans.
    """
    if n == 0:
        return 0, []
    step = min(chunk, n) if chunk > 0 else n
    return step, [(s, min(n, s + step)) for s in range(0, n, step)]


def pad_rows(arr: np.ndarray, step: int) -> np.ndarray:
    """Repeat the last row so axis 0 reaches ``step`` (one static jit shape)."""
    arr = np.asarray(arr)
    if arr.shape[0] == step:
        return arr
    return np.concatenate(
        [arr, np.repeat(arr[-1:], step - arr.shape[0], axis=0)], axis=0)


def segment_spans(n: int, chunk: int, mega_chunks: int):
    """``(step, [(seg_start, seg_stop, [(s, e), ...]), ...])``.

    A *segment* is the mega-loop's launch unit: ``mega_chunks`` consecutive
    grid chunks certified by ONE device-resident ``lax.scan`` launch
    (DESIGN.md §17).  Chunk boundaries — and therefore every chunk-keyed
    RNG stream — are identical to :func:`chunk_spans` (this only groups
    them), so the segment grouping changes launch COUNT, never kernel
    inputs.  Shared by the stage-0/parity loops (verify/sweep.py) and the
    prune pass (verify/pruning.py) so their launch signatures cannot
    desync.
    """
    step, spans = chunk_spans(n, chunk)
    m = max(1, int(mega_chunks))
    segs = [(spans[i][0], spans[min(i + m, len(spans)) - 1][1],
             spans[i:i + m]) for i in range(0, len(spans), m)]
    return step, segs


def pad_chunk_axis(chunks, pad_chunks: int):
    """Segment chunk list padded to the segment bucket (last chunk repeated).

    A ragged FINAL segment (``len(spans) % mega_chunks != 0``) would
    otherwise scan a shorter chunk axis — a second XLA signature per mega
    kernel per model, exactly the shape churn the ragged-ROW pad
    (:func:`pad_rows`) already prevents.  Callers request padding only
    when the grid spans more than one segment (a single-segment run has
    one signature either way and padding it would multiply device work);
    decodes iterate the REAL chunk list, so padded iterations' outputs
    are never read.
    """
    if pad_chunks and len(chunks) < pad_chunks:
        return list(chunks) + [chunks[-1]] * (pad_chunks - len(chunks))
    return list(chunks)


class BoxList:
    """Lazy sequence view over a (P, d) box tensor as per-partition dicts.

    The cartesian grids of the stress/relaxed presets reach millions of
    partitions; materializing a Python dict per box costs gigabytes.  The
    sweep only needs ``len``/slicing, so boxes live as two arrays and the
    dict form (`{attr: (lo, hi)}`) is synthesized per access for the few
    callers that want it (density/coverage helpers, tests).
    """

    def __init__(self, lo: np.ndarray, hi: np.ndarray, columns):
        self.lo, self.hi, self.columns = lo, hi, tuple(columns)

    def __len__(self):
        return self.lo.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return BoxList(self.lo[i], self.hi[i], self.columns)
        return {c: (int(self.lo[i, j]), int(self.hi[i, j]))
                for j, c in enumerate(self.columns)}

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def product_boxes(columns, p_dict: Dict[str, List[Range]], range_dict: RangeDict):
    """(lo, hi) arrays of the chunked-attribute cartesian product.

    Vectorized equivalent of ``partitioned_ranges`` +
    ``boxes_from_partitions`` with identical ordering (first chunked
    attribute slowest, matching ``itertools.product``), but O(P·d) array
    writes instead of P Python dicts.
    """
    columns = list(columns)
    chunked = list(p_dict.keys())
    sizes = [len(p_dict[a]) for a in chunked]
    P = int(np.prod(sizes)) if sizes else 1
    idx = np.indices(sizes).reshape(len(sizes), -1) if sizes else None
    lo = np.empty((P, len(columns)), dtype=np.int64)
    hi = np.empty((P, len(columns)), dtype=np.int64)
    for j, c in enumerate(columns):
        if c in p_dict:
            arr = np.asarray(p_dict[c], dtype=np.int64)
            k = chunked.index(c)
            lo[:, j] = arr[idx[k], 0]
            hi[:, j] = arr[idx[k], 1]
        else:
            lo[:, j], hi[:, j] = range_dict[c][0], range_dict[c][1]
    return lo, hi
