"""Port's streaming top-k (``ops.mach_topk`` / ``estimators.predict_topk``,
CPU paths) vs the JAX package's TPU kernel ``mach_topk_pallas`` in
interpret mode and its oracle ``ref.mach_topk_ref``.

Dyadic inputs: against the TPU kernel, values and indices exactly equal
for all three estimators, both hash sources, odd and even R, ragged N
and K, and a tiny-B, tiny-R case where classes collide in bulk (tie
order: lowest class id first).  Against the oracle, indices exactly
and min/median values exactly; the oracle's unbiased values may sit 1
ulp from its own TPU kernel's (XLA reorders the affine map), so those
compare at rtol 1e-6.  Random inputs: rtol 1e-6, indices equal except on
near-ties.  The blocked CPU fallback must equal the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimators as je
from repro.kernels import ref as jref
from repro.kernels.mach_topk import mach_topk_pallas
from repro_torch.core import estimators as te
from repro_torch.kernels import mach_topk as tk
from repro_torch.kernels import ops
from torch_cases import assert_topk_close, dyadic_meta, mult_shift, random_meta

ESTIMATORS = ("unbiased", "min", "median")
# (n, r, b, K, k, inline)
CASES = [(7, 5, 16, 700, 10, False),     # odd R, table
         (5, 4, 8, 301, 7, True),        # even R median, inline, ragged K
         (6, 2, 2, 260, 20, False)]      # 4 bucket patterns: bulk ties


@pytest.mark.parametrize("estimator", ESTIMATORS)
@pytest.mark.parametrize("n,r,b,K,k,inline", CASES)
def test_topk_dyadic_exact(n, r, b, K, k, inline, estimator):
    meta = dyadic_meta(n, r, b, seed=K)
    tab, coeffs, shift = mult_shift(b, r, K, seed=1)
    if inline:
        jv, ji = mach_topk_pallas(jnp.asarray(meta), num_classes=K, k=k,
                                  estimator=estimator,
                                  inline_coeffs=jnp.asarray(coeffs),
                                  inline_shift=shift, interpret=True)
        tv, ti = ops.mach_topk(torch.from_numpy(meta), num_classes=K, k=k,
                               estimator=estimator,
                               inline_coeffs=torch.from_numpy(
                                   coeffs.astype(np.int64)),
                               inline_shift=shift)
    else:
        jv, ji = mach_topk_pallas(jnp.asarray(meta), jnp.asarray(tab),
                                  num_classes=K, k=k, estimator=estimator,
                                  interpret=True)
        tv, ti = ops.mach_topk(torch.from_numpy(meta), torch.from_numpy(tab),
                               num_classes=K, k=k, estimator=estimator)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    rv, ri = jref.mach_topk_ref(jnp.asarray(meta), jnp.asarray(tab), k,
                                estimator)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    if estimator == "unbiased":
        np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-6)
    else:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    # the blocked CPU fallback streams K in blocks with the same result
    bv, bi = ops._blocked_topk_fallback(torch.from_numpy(meta),
                                        torch.from_numpy(tab), k, estimator,
                                        block_k=64)
    np.testing.assert_array_equal(bv.numpy(), tv.numpy())
    np.testing.assert_array_equal(bi.numpy(), ti.numpy())


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_topk_random_close(estimator):
    n, r, b, K, k = 9, 6, 32, 1100, 16
    meta = random_meta(n, r, b, seed=3)
    tab, _, _ = mult_shift(b, r, K, seed=2)
    jv, ji = mach_topk_pallas(jnp.asarray(meta), jnp.asarray(tab),
                              num_classes=K, k=k, estimator=estimator,
                              interpret=True)
    tv, ti = ops.mach_topk(torch.from_numpy(meta), torch.from_numpy(tab),
                           num_classes=K, k=k, estimator=estimator)
    scores = np.asarray(jref.mach_estimator_scores_ref(
        jnp.asarray(meta), jnp.asarray(tab), estimator))
    assert_topk_close(tv.numpy(), ti.numpy(), jv, ji, scores)


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_predict_topk_matches_jax_oracle(estimator):
    """estimators.predict_topk takes (R, ..., B) meta like the JAX API."""
    meta = dyadic_meta(8, 5, 16, seed=11).transpose(1, 0, 2).reshape(5, 2, 4, 16)
    tab, _, _ = mult_shift(16, 5, 400, seed=3)
    v, i = te.predict_topk(torch.from_numpy(np.ascontiguousarray(meta)),
                           torch.from_numpy(tab), 5, estimator)
    assert tuple(v.shape) == tuple(i.shape) == (2, 4, 5)
    want = je.estimate_class_probs(jnp.asarray(meta), jnp.asarray(tab),
                                   estimator)
    rv, ri = jax.lax.top_k(want, 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-6)


def test_all_ties_lowest_ids_first():
    meta = np.full((2, 3, 4), 0.25, np.float32)
    tab, _, _ = mult_shift(4, 3, 90)
    for est in ESTIMATORS:
        _, i = ops.mach_topk(torch.from_numpy(meta), torch.from_numpy(tab),
                             num_classes=90, k=12, estimator=est)
        np.testing.assert_array_equal(i.numpy(), np.tile(np.arange(12), (2, 1)))


def test_large_cpu_problem_takes_blocked_path(monkeypatch):
    """Above the size threshold the CPU path streams K in blocks."""
    calls = []
    real = ops._blocked_topk_fallback
    monkeypatch.setattr(ops, "_BLOCKED_MIN", 100)
    monkeypatch.setattr(ops, "_blocked_topk_fallback",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    meta = torch.from_numpy(dyadic_meta(3, 4, 8, seed=5))
    tab, _, _ = mult_shift(8, 4, 200)
    v, i = ops.mach_topk(meta, torch.from_numpy(tab), num_classes=200, k=4,
                         estimator="median")
    assert calls == [1]
    pv, pi = tk.mach_topk_plain(meta, torch.from_numpy(tab), num_classes=200,
                                k=4, estimator="median")
    np.testing.assert_array_equal(v.numpy(), pv.numpy())
    np.testing.assert_array_equal(i.numpy(), pi.numpy())


def test_topk_argument_checks():
    meta = torch.from_numpy(dyadic_meta(2, 3, 8, seed=0))
    tab = torch.from_numpy(mult_shift(8, 3, 500)[0])
    for bad_k in (0, 501):
        with pytest.raises(ValueError, match="1 <= k"):
            ops.mach_topk(meta, tab, num_classes=500, k=bad_k)
    with pytest.raises(ValueError, match="largest k"):
        ops.mach_topk(meta, tab, num_classes=500, k=tk.MAX_K + 1)
    with pytest.raises(ValueError, match="estimator"):
        ops.mach_topk(meta, tab, num_classes=500, k=3, estimator="mean")
    with pytest.raises(ValueError, match="CUDA"):
        tk.mach_topk_cuda(meta, tab, num_classes=500, k=3)
