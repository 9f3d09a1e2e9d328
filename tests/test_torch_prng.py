"""The port's threefry sampling RNG is bit-equal to the JAX package's.

Keys (``grid_keys``) and simulation samples (``simulate_box``) feed the
candidate masks, ``pos_prob``, the parity column and the CSV, so the port
must reproduce them exactly, for every domain the sweep runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairify_tpu.ops.simulate import simulate_box
from fairify_tpu.utils import prng as jprng
from fairify_tpu.verify import presets as jpresets
from fairify_tpu.verify import sweep as jsweep
from fairify_tpu_torch.utils import prng as tprng


def _partitionable():
    # The port implements the partitionable threefry path; the JAX package
    # draws other bits with the flag off, so read it when the test runs.
    assert jax.config.jax_threefry_partitionable, \
        "jax_threefry_partitionable is off: the port's RNG would not match"


@pytest.mark.parametrize("seed,offset,n", [(42, 0, 7), (0, 1000, 5), (7, 16000, 3),
                                           (2**32 + 5, 70_000, 4), (2**40 + 123, 65_530, 9)])
def test_grid_keys_bit_equal(seed, offset, n):
    _partitionable()
    want = np.asarray(jax.random.key_data(jprng.grid_keys(seed, offset, n)))
    got = tprng.grid_keys(seed, offset, n).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _boxes(name, n=6):
    _, lo, hi = jsweep.build_partitions(jpresets.get(name))
    return np.asarray(lo[:n], np.float32), np.asarray(hi[:n], np.float32)


@pytest.mark.parametrize("name", ["GC", "AC", "BM", "DF"])
def test_simulate_box_bit_equal(name):
    _partitionable()
    lo, hi = _boxes(name)
    # Extra rows: a point dim (lo == hi), negative bounds, a wide span.
    extra_lo = lo[:1].copy()
    extra_hi = hi[:1].copy()
    extra_lo[0, 0] = extra_hi[0, 0] = 3.0
    extra_lo[0, -1], extra_hi[0, -1] = -17.0, 200000.0
    lo, hi = np.concatenate([lo, extra_lo]), np.concatenate([hi, extra_hi])
    keys = jprng.grid_keys(42, 11, lo.shape[0])
    want = np.asarray(jax.vmap(lambda k, l, h: simulate_box(k, l, h, 64))(
        keys, jnp.asarray(lo), jnp.asarray(hi)))
    got = tprng.simulate_boxes(tprng.grid_keys(42, 11, lo.shape[0]),
                               torch.as_tensor(lo), torch.as_tensor(hi), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((got.numpy() >= lo[:, None, :]) & (got.numpy() <= hi[:, None, :])).all()


def test_shuffled_order_matches():
    np.testing.assert_array_equal(tprng.shuffled_order(201, 42),
                                  jprng.shuffled_order(201, 42))


@pytest.mark.parametrize("words", [(0, 42), (1, 5), (0xDEADBEEF, 0x12345678)])
def test_fold_in_of_any_key_words(words):
    """``fold_in_plain`` (the plain version the card's key kernel is held
    against, ``csrc/common.cuh:fold_in``) equals ``jax.random.fold_in`` of
    the raw key ``words`` — a nonzero high word included — at indices past
    65,535."""
    _partitionable()
    key = jax.random.wrap_key_data(np.asarray(words, np.uint32))
    idx = np.arange(65_530, 65_545)
    want = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(key, int(i))))
                     for i in idx])
    got = tprng.fold_in_plain(words, 65_530, idx.size).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert tprng.key_words(2**32 + 5) == (0, 5)
