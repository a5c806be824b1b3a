"""Port vs JAX package: hash families, tables, label hashing, theory.

Integer outputs must agree bit for bit: coefficients, (R, K) tables,
hashed labels and inverted tables, for both families.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro_torch.core import hashing as th

FAMILIES = [
    ("carter_wegman", 7, 5, 3, 1000),
    ("carter_wegman", 32, 25, 0, 4099),
    ("mult_shift", 8, 5, 1, 1000),
    ("mult_shift", 32, 25, 0, 4099),
    ("mult_shift", 512, 20, 2, 2048),
]


@pytest.mark.parametrize("kind,b,r,seed,k", FAMILIES)
def test_tables_bit_exact(kind, b, r, seed, k):
    jf = jh.make_hash_family(b, r, seed, kind)
    tf = th.make_hash_family(b, r, seed, kind)
    assert type(tf).__name__ == type(jf).__name__
    jc, tc = jf.coeffs(), tf.coeffs()
    for a, c in zip(np.atleast_2d(jc), np.atleast_2d(tc)):
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(jf.table_np(k), tf.table_np(k))
    t = tf.table(k, device="cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (r, k)
    np.testing.assert_array_equal(np.asarray(jf.table(k)), t.numpy())


@pytest.mark.parametrize("kind,b,r,seed,k", FAMILIES)
def test_hash_labels_bit_exact(kind, b, r, seed, k):
    jf = jh.make_hash_family(b, r, seed, kind)
    tf = th.make_hash_family(b, r, seed, kind)
    labels = np.random.default_rng(seed).integers(0, k, (3, 17)).astype(np.int32)
    want = np.asarray(jf.hash_labels(jnp.asarray(labels), k))
    got = tf.hash_labels(torch.from_numpy(labels), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


def test_mult_shift_large_labels_wrap_like_uint32():
    """a·y mod 2^32 with y near 2^31: int64 + mask must equal uint32 wrap."""
    jf, tf = jh.MultShiftFamily(64, 4, 9), th.MultShiftFamily(64, 4, 9)
    labels = np.array([0, 1, 2**31 - 1, 2**31 - 2, 123456789], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jf.hash_labels(jnp.asarray(labels))),
        tf.hash_labels(torch.from_numpy(labels)).numpy())


@pytest.mark.parametrize("b,r,k,pad", [(8, 3, 200, 128), (32, 5, 3000, 16)])
def test_inverted_table_bit_exact(b, r, k, pad):
    tab = jh.CarterWegmanFamily(b, r, 1).table_np(k)
    np.testing.assert_array_equal(jh.inverted_table_np(tab, b, pad),
                                  th.inverted_table_np(tab, b, pad))


def test_family_validation_matches():
    for mod in (jh, th):
        with pytest.raises(ValueError):
            mod.MultShiftFamily(12, 3)
        with pytest.raises(ValueError):
            mod.make_hash_family(8, 3, kind="nope")
    assert th.HASH_KINDS == jh.HASH_KINDS


@pytest.mark.parametrize("k,b,r", [(105033, 32, 25), (21841, 512, 20), (1000, 2, 10)])
def test_theory_helpers_equal(k, b, r):
    assert th.r_required(k, b) == jh.r_required(k, b)
    assert th.indistinguishable_pair_bound(k, b, r) == \
        jh.indistinguishable_pair_bound(k, b, r)
    assert th.memory_reduction(k, b, r) == jh.memory_reduction(k, b, r)
