"""Port vs JAX package: the paper's estimators, meta-probabilities, loss.

Dyadic probabilities (multiples of 2^-10) make the min and median
exact in any arithmetic order, so those must agree bit for bit —
including the even-R median, which is the midpoint of the two middle
values as ``jnp.median`` computes it.  The unbiased estimator divides by
R and maps affinely; it must agree within 2 ulps (rtol 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimators as je
from repro.core import hashing as jh
from repro.core import mach as jm
from repro_torch.core import estimators as te
from repro_torch.core import mach as tm

ESTIMATORS = ("unbiased", "min", "median")


def _case(r, b, k, lead, seed=0):
    rng = np.random.default_rng(seed)
    meta = (rng.integers(0, 1025, (r,) + lead + (b,)) / 1024).astype(np.float32)
    tab = jh.CarterWegmanFamily(b, r, seed).table_np(k)
    return meta, tab


@pytest.mark.parametrize("estimator", ESTIMATORS)
@pytest.mark.parametrize("r", [4, 5])
def test_estimators_match_jax(estimator, r):
    meta, tab = _case(r, 8, 300, (3, 2))
    want = np.asarray(je.estimate_class_probs(jnp.asarray(meta),
                                              jnp.asarray(tab), estimator))
    got = te.estimate_class_probs(torch.from_numpy(meta),
                                  torch.from_numpy(tab), estimator)
    assert tuple(got.shape) == want.shape == (3, 2, 300)
    if estimator == "unbiased":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("r", [2, 4, 6])
def test_even_r_median_is_midpoint(r):
    """torch.median would return the lower middle value; the port must
    return jnp.median's midpoint."""
    meta, tab = _case(r, 4, 64, (5,), seed=r)
    g = np.array(je.gather_class_probs(jnp.asarray(meta), jnp.asarray(tab)))
    want = np.asarray(jnp.median(jnp.asarray(g), axis=0))
    got = te.median_estimator(torch.from_numpy(meta), torch.from_numpy(tab))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(
        torch.median(torch.from_numpy(g), dim=0).values.numpy(), want)


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_predict_classes_match_jax(estimator):
    meta, tab = _case(5, 8, 500, (9,), seed=3)
    want = np.asarray(je.predict_classes(jnp.asarray(meta), jnp.asarray(tab),
                                         estimator))
    got = te.predict_classes(torch.from_numpy(meta), torch.from_numpy(tab),
                             estimator)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_rejects_r_mismatch():
    meta, tab = _case(4, 8, 10, (2,))
    with pytest.raises(ValueError, match="R mismatch"):
        te.gather_class_probs(torch.from_numpy(meta), torch.from_numpy(tab[:3]))
    with pytest.raises(ValueError, match="estimator"):
        te.estimate_class_probs(torch.from_numpy(meta), torch.from_numpy(tab),
                                "mode")


def test_meta_probs_and_loss_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 5, 16)).astype(np.float32)
    labels = rng.integers(0, 16, (5, 6)).astype(np.int32)
    weights = (rng.random(6) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tm.mach_meta_probs(torch.from_numpy(logits)).numpy(),
        np.asarray(jm.mach_meta_probs(jnp.asarray(logits))),
        rtol=1e-6, atol=1e-7)
    for w in (None, weights):
        want = jm.mach_loss(jnp.asarray(logits), jnp.asarray(labels),
                            None if w is None else jnp.asarray(w))
        got = tm.mach_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_mach_config_matches_jax():
    for kw in ({}, {"hash_kind": "carter_wegman"}, {"seed": 4}):
        jc = jm.MACHConfig(300, 16, 6, **kw)
        tc = tm.MACHConfig(300, 16, 6, **kw)
        np.testing.assert_array_equal(jc.table_np(), tc.table_np())
        np.testing.assert_array_equal(np.asarray(jc.table()),
                                      tc.table("cpu").numpy())
        y = np.arange(0, 300, 7, dtype=np.int32)
        np.testing.assert_array_equal(
            np.asarray(jc.hash_labels(jnp.asarray(y))),
            tc.hash_labels(torch.from_numpy(y)).numpy())
        assert jc.indistinguishable_bound() == tc.indistinguishable_bound()
        assert jc.memory_reduction() == tc.memory_reduction()
    assert tm.MACHConfig.from_delta(1000, 32) == tm.MACHConfig(
        1000, 32, jm.MACHConfig.from_delta(1000, 32).num_repetitions)
    for bad in ({"num_buckets": 1}, {"estimator": "mode"},
                {"hash_kind": "md5"}):
        kw = {"num_classes": 10, "num_buckets": 4, "num_repetitions": 2, **bad}
        with pytest.raises(ValueError):
            tm.MACHConfig(**kw)
