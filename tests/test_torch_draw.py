"""The simulation draw's hoisted constants, on the CPU and without JAX.

KA, row 3 and KD (``csrc/sim_tile.cuh``) and K12 (``csrc/sim_rows.cu``)
compute ``jax.random.randint``'s per-dimension constants once per
(partition, dimension) — ``csrc/common.cuh:draw_dim`` — and reduce each
value's two 32-bit words with them (``draw_value``).
``utils/prng.py:draw_constants`` and ``draw_offset`` mirror that rule, and
``randint_rows`` draws through them.  This test holds the mirror to the
plain per-value reduction with ``%`` (numpy uint64, mod 2^32 where the
uint32 arithmetic wraps), exactly, on every span the repo's domains and
presets produce, span 1, the powers of two and 2^31 - 1, and on numerators
0, span - 1, 2^32 - 1 and 10^5 random words.
"""
import numpy as np
import torch

from fairify_tpu_torch.data import domains
from fairify_tpu_torch.partition import grid as grid_mod
from fairify_tpu_torch.utils import prng
from fairify_tpu_torch.verify import presets

M32 = (1 << 32) - 1


def _repo_spans():
    """Every span (hi - lo + 1) of a domain's attribute ranges and of the
    partition ranges each preset cuts them into."""
    spans = set()
    for d in domains.DOMAINS.values():
        lo, hi = d.lo_hi()
        spans |= {int(h) - int(l) + 1 for l, h in zip(lo, hi)}
    for name in presets.names():
        cfg = presets.get(name)
        ranges = {k: list(v) for k, v in cfg.query().domain.ranges.items()}
        cut = (grid_mod.partition_attributes_capped if cfg.capped_partitions
               else grid_mod.partition_attributes)
        for parts in cut(ranges, cfg.partition_threshold).values():
            spans |= {int(r[1]) - int(r[0]) + 1 for r in parts}
        spans |= {int(v[1]) - int(v[0]) + 1 for v in ranges.values()}
    return spans


def _plain_offset(hb, lb, span):
    """JAX's reduction for one span, every constant recomputed: uint32
    words as numpy uint64, the multiplier (2^16 mod span)^2 mod 2^32 mod
    span, the sum wrapped to 32 bits."""
    span = np.uint64(span)
    mult = np.uint64(((65536 % int(span)) ** 2 & M32) % int(span))
    off = (((hb % span) * mult) & np.uint64(M32)) + (lb % span)
    return (off & np.uint64(M32)) % span


def test_hoisted_draw_constants_equal_plain_modulo():
    spans = sorted(_repo_spans() | {1, (1 << 31) - 1} | {1 << k for k in range(32)})
    assert len(spans) > 40 and max(spans) >= 1_000_000
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, size=100_000, dtype=np.uint64)
    for span in spans:
        nums = np.concatenate([np.array([0, span - 1, M32], dtype=np.uint64), words])
        hb, lb = nums, np.roll(nums, 1)
        minval = torch.tensor([-7, 0, 1 << 20], dtype=torch.int64)
        base, sp, mult = prng.draw_constants(minval, minval + span)
        assert torch.equal(base, minval & M32)
        assert (sp == span).all() and (mult == int(_plain_offset(
            np.array([1], np.uint64), np.array([0], np.uint64), span)[0])).all()
        got = prng.draw_offset(torch.as_tensor(hb.astype(np.int64)),
                               torch.as_tensor(lb.astype(np.int64)), sp[:1], mult[:1])
        want = _plain_offset(hb, lb, span)
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), want, err_msg=str(span))
        assert (got >= 0).all() and (got < span).all()


def test_empty_and_reversed_ranges_draw_their_minval():
    # maxval <= minval: span 1, every draw is minval (jax.random.randint's rule).
    lo = torch.tensor([5, -3, 0], dtype=torch.int64)
    base, span, mult = prng.draw_constants(lo, torch.tensor([5, -9, 0], dtype=torch.int64))
    assert (span == 1).all() and (mult == 0).all()
    off = prng.draw_offset(torch.tensor([M32, 12345, 0]), torch.tensor([7, M32, 0]), span, mult)
    assert (off == 0).all()
