"""Bit-exact port of the JAX package's keyed sampling RNG.

The JAX package derives one key per partition, ``fold_in(key(seed),
global_index)`` (``fairify_tpu/utils/prng.py:grid_keys``), and draws each
partition's simulation rows with ``jax.random.randint``
(``fairify_tpu/ops/simulate.py:simulate_box``).  The candidate dead-neuron
masks, ``pos_prob``, the parity column and therefore the CSV all depend on
those exact bits, so this module reproduces JAX's threefry2x32 algorithm
(the ``jax_threefry_partitionable`` path, JAX's default) bit for bit rather
than substituting a ``torch.Generator``:

* ``key(seed)``            → ``(seed >> 32, seed & 0xFFFFFFFF)``
* ``fold_in(k, i)``        → ``threefry2x32(k, (0, i))``
* ``split(k)``             → ``threefry2x32(k, (0, 0))``, ``threefry2x32(k, (0, 1))``
* ``random_bits(k)[n]``    → ``x0 ^ x1`` of ``threefry2x32(k, (n >> 32, n & M))``
* ``randint(k, lo, hi)``   → two draws (``higher_bits``, ``lower_bits``) from
  the split keys, reduced modulo the span with JAX's ``2**32 mod span``
  multiplier (``jax/_src/random.py:_randint``).

Everything here is plain torch on int64 tensors holding 32-bit values (torch
has no full uint32 arithmetic); every add is masked back to 32 bits.  The
CUDA kernels carry the same algorithm as a device function
(``csrc/threefry.cuh``).
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on broadcastable int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def seed_key(seed: int, device="cpu") -> torch.Tensor:
    """Raw key data of ``jax.random.key(seed)``: a (2,) int64 tensor."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def grid_keys(seed: int, index_offset: int, n: int, device="cpu") -> torch.Tensor:
    """Per-partition keys for global indices [offset, offset+n): (n, 2) int64.

    Equal to ``jax.random.key_data(fairify_tpu.utils.prng.grid_keys(...))``.
    """
    base = seed_key(seed, device)
    idx = torch.arange(index_offset, index_offset + n, dtype=torch.int64,
                       device=device) & M32
    k0, k1 = threefry2x32(base[0], base[1], torch.zeros_like(idx), idx)
    return torch.stack([k0, k1], dim=1)


def split2(keys: torch.Tensor):
    """``jax.random.split(key, 2)`` over a (..., 2) key batch → two (..., 2)."""
    k0, k1 = keys[..., 0], keys[..., 1]
    zero = torch.zeros_like(k0)
    a = threefry2x32(k0, k1, zero, zero)
    b = threefry2x32(k0, k1, zero, torch.ones_like(k0))
    return torch.stack(a, dim=-1), torch.stack(b, dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit draws: ``(..., n)`` int64 for a ``(..., 2)`` key batch."""
    cnt = torch.arange(n, dtype=torch.int64, device=keys.device)
    k0 = keys[..., 0:1]
    k1 = keys[..., 1:2]
    x0, x1 = threefry2x32(k0, k1, cnt >> 32, cnt & M32)
    return x0 ^ x1


def randint_rows(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 size: int) -> torch.Tensor:
    """``jax.random.randint(key, (size, d), lo, hi + 1)`` per row of a batch.

    ``keys``: (P, 2) int64; ``lo``/``hi``: (P, d) inclusive integer bounds
    (any numeric dtype, converted like ``astype(int32)``).  Returns (P, size, d)
    int64 samples.
    """
    P, d = lo.shape
    minval = lo.to(torch.int32).to(torch.int64)
    maxval = hi.to(torch.int32).to(torch.int64) + 1
    k_hi, k_lo = split2(keys)
    higher = random_bits(k_hi, size * d).view(P, size, d)
    lower = random_bits(k_lo, size * d).view(P, size, d)
    span = (maxval - minval) & M32
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    span, mult = span[:, None, :], mult[:, None, :]
    off = (((higher % span) * mult) & M32) + (lower % span)
    off = (off & M32) % span
    out = (minval[:, None, :] + off) & M32
    return torch.where(out >= 1 << 31, out - (1 << 32), out)


def simulate_boxes(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   size: int) -> torch.Tensor:
    """Float32 simulation samples (P, size, d) — ``simulate_box`` per row."""
    return randint_rows(keys, lo, hi, size).to(torch.float32)


def shuffled_order(n: int, seed: int) -> np.ndarray:
    """Deterministic sweep order (the JAX package's ``shuffled_order``)."""
    return np.random.default_rng(seed).permutation(n)
