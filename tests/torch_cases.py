"""Shared decode inputs and checks for the port's tests (numpy in, so the
JAX package and the port see the same numbers)."""

import numpy as np

from repro.core import hashing as jh


def dyadic_meta(n, r, b, seed):
    """(N, R, B) probabilities that are multiples of 2^-10: sums and
    medians are exact in any order, so results must agree exactly."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1025, (n, r, b)) / 1024).astype(np.float32)


def random_meta(n, r, b, seed):
    """(N, R, B) softmax rows of random logits (float32)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, r, b))
    p = np.exp(z - z.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def mult_shift(b, r, k, seed=0):
    """(table (R, K) int32, coeffs (R,) uint32, shift) of one family."""
    fam = jh.MultShiftFamily(b, r, seed)
    return fam.table_np(k), fam.coeffs(), fam.shift


def assert_topk_close(got_v, got_i, want_v, want_i, scores, rtol=1e-6):
    """Values within rtol; indices equal except where the two picks'
    scores tie within rtol (``scores``: the reference (N, K) matrix)."""
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=rtol, atol=1e-7)
    for row in range(got_i.shape[0]):
        assert len(set(got_i[row].tolist())) == got_i.shape[1]
    diff = got_i != want_i
    if diff.any():
        rows = np.nonzero(diff)[0]
        np.testing.assert_allclose(scores[rows[:, None], got_i[rows]],
                                   want_v[rows], rtol=rtol, atol=1e-7)
