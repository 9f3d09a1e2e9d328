"""Bit-exact port of the JAX package's keyed sampling RNG.

The JAX package derives one key per partition, ``fold_in(key(seed),
global_index)`` (``fairify_tpu/utils/prng.py:grid_keys``), and draws each
partition's simulation rows with ``jax.random.randint``
(``fairify_tpu/ops/simulate.py:simulate_box``).  The candidate dead-neuron
masks, ``pos_prob``, the parity column and therefore the CSV all depend on
those exact bits, so this module reproduces JAX's threefry2x32 algorithm
(the ``jax_threefry_partitionable`` path, JAX's default) bit for bit rather
than substituting a ``torch.Generator``:

* ``key(seed)``            → ``(0, seed & 0xFFFFFFFF)``: JAX in its default
  32-bit mode (``jax_enable_x64`` off, as the JAX package runs) takes the
  seed as a 32-bit integer, so a seed ``>= 2**32`` keeps its low word
* ``fold_in(k, i)``        → ``threefry2x32(k, (0, i))``; the key of
  partition ``i`` is ``fold_in(key(seed), i)`` (:func:`grid_keys`), which
  ``csrc/common.cuh:fold_in`` computes on the card from the key's two
  words and the index
* ``split(k)``             → ``threefry2x32(k, (0, 0))``, ``threefry2x32(k, (0, 1))``
* ``random_bits(k)[n]``    → ``x0 ^ x1`` of ``threefry2x32(k, (n >> 32, n & M))``
* ``randint(k, lo, hi)``   → two draws (``higher_bits``, ``lower_bits``) from
  the split keys, reduced modulo the span with JAX's ``2**32 mod span``
  multiplier (``jax/_src/random.py:_randint``).
* ``uniform(k, shape, a, b)`` → the 23 high bits of each draw as the mantissa
  of a float in [1, 2), minus 1, scaled to [a, b) (``_uniform``).

Everything here is plain torch on int64 tensors holding 32-bit values (torch
has no full uint32 arithmetic); every add is masked back to 32 bits.  The
CUDA kernels carry the same algorithm as a device function
(``csrc/common.cuh``); :func:`grid_keys` on a CUDA device is one launch of
``csrc/sim_rows.cu``'s key kernel, its torch version
(:func:`grid_keys_plain`) the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from fairify_tpu_torch.obs import launches

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


def key_words(seed: int):
    """The two 32-bit words of ``jax.random.key(seed)`` as the JAX package
    makes it (32-bit mode): ``(0, seed mod 2**32)``."""
    return 0, int(seed) & M32


def seed_key(seed: int, device="cpu") -> torch.Tensor:
    """Raw key data of ``jax.random.key(seed)`` (and of
    ``jax.random.PRNGKey(seed)``, which holds the same bits): a (2,) int64
    tensor of :func:`key_words`."""
    return torch.tensor(key_words(seed), dtype=torch.int64, device=device)


def fold_in_plain(words, index_offset: int, n: int, device="cpu") -> torch.Tensor:
    """``fold_in((k0, k1), i)`` for i in [offset, offset+n) in torch ops:
    (n, 2) int64."""
    idx = torch.arange(index_offset, index_offset + n, dtype=torch.int64,
                       device=device) & M32
    k0, k1 = threefry2x32(int(words[0]) & M32, int(words[1]) & M32, torch.zeros_like(idx),
                          idx)
    return torch.stack([k0, k1], dim=1)


def grid_keys_plain(seed: int, index_offset: int, n: int, device="cpu") -> torch.Tensor:
    """Plain torch version of :func:`grid_keys` on any device."""
    return fold_in_plain(key_words(seed), index_offset, n, device)


def grid_keys(seed: int, index_offset: int, n: int, device="cpu") -> torch.Tensor:
    """Per-partition keys for global indices [offset, offset+n): (n, 2) int64.

    Equal to ``jax.random.key_data(fairify_tpu.utils.prng.grid_keys(...))``.
    On the CPU :func:`grid_keys_plain`; on a CUDA device one launch of
    ``csrc/sim_rows.cu:k12_grid_keys`` (:func:`fold_in_launch`)."""
    if torch.device(device).type == "cpu":
        return grid_keys_plain(seed, index_offset, n, device)
    with launches.launching("grid_keys", (n,)):
        out = fold_in_launch(key_words(seed), index_offset, n, device)
    return out


def fold_in_launch(words, index_offset: int, n: int, device) -> torch.Tensor:
    """One launch of the key kernel on a CUDA device: :func:`fold_in_plain`'s
    keys, for any key words (the card's checks take a nonzero high word)."""
    import ctypes

    from fairify_tpu_torch.utils import cuda_build

    if not 0 <= n < 1 << 31 or not 0 <= index_offset < 1 << 32:
        raise ValueError(f"grid_keys: {n} keys from index {index_offset}")
    out = torch.empty((n, 2), dtype=torch.int64, device=device)
    cuda_build.require_cuda(out)
    u32 = lambda v: ctypes.c_uint32(int(v) & M32)
    cuda_build.call("sim_rows", "k12_grid_keys", u32(words[0]), u32(words[1]),
                    u32(index_offset), ctypes.c_int(n), cuda_build.ptr(out),
                    cuda_build.stream())
    return out




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


def draw_constants(minval: torch.Tensor, maxval: torch.Tensor):
    """The per-dimension constants of ``jax.random.randint``'s reduction
    over ``[minval, maxval)`` (int64 tensors of int32 values): ``(minval
    mod 2^32, span, mult)``, ``span = maxval - minval`` mod 2^32 (1 where
    ``maxval <= minval``) and ``mult = (65536 % span)^2 mod 2^32 % span``.
    They depend on the box alone, so the kernels compute them once per
    (partition, dimension): ``csrc/common.cuh:draw_dim`` is the same rule."""
    span = (maxval - minval) & M32
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    return minval & M32, span, mult


def draw_offset(higher: torch.Tensor, lower: torch.Tensor, span: torch.Tensor,
                mult: torch.Tensor) -> torch.Tensor:
    """A draw's offset in ``[0, span)`` from its two 32-bit words and its
    dimension's constants (:func:`draw_constants`), in uint32 arithmetic
    (``csrc/common.cuh:draw_value``)."""
    off = (((higher % span) * mult) & M32) + (lower % span)
    return (off & M32) % span


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
    base, span, mult = (c[:, None, :] for c in draw_constants(minval, maxval))
    out = (base + draw_offset(higher, lower, span, mult)) & M32
    return torch.where(out >= 1 << 31, out - (1 << 32), out)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of one (2,) key → (num, 2)."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    k0, k1 = threefry2x32(key[0], key[1], torch.zeros_like(idx), idx)
    return torch.stack([k0, k1], dim=1)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit-equal.

    JAX's ``floats * (maxval - minval) + minval`` is one fused multiply-add
    under XLA; it is taken in float64 here, where the product of two f32
    values is exact, and rounded to f32 once.
    """
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape)) if shape else 1
    bits = random_bits(key, n).reshape(shape)
    mant = (bits >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(minval)))
    out = (floats.to(torch.float64) * span + lo).to(torch.float32)
    return torch.clamp_min(out, lo)


def simulate_boxes(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   size: int) -> torch.Tensor:
    """Float32 simulation samples (P, size, d) — ``simulate_box`` per row."""
    return randint_rows(keys, lo, hi, size).to(torch.float32)


def shuffled_order(n: int, seed: int) -> np.ndarray:
    """Deterministic sweep order (the JAX package's ``shuffled_order``)."""
    return np.random.default_rng(seed).permutation(n)
