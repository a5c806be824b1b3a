"""Port's top-1 decode (``ops.mach_top1``, CPU plain path) vs the JAX
package's TPU kernel ``mach_decode_pallas`` in interpret mode and its
oracle ``ref.mach_decode_ref``.

Dyadic inputs: values and indices exactly equal, ties to the first
(lowest) class id — including a tiny-B, tiny-R case where most classes
collide.  Random inputs: values at rtol 1e-6, indices equal except on
near-ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mach_decode import mach_decode_pallas
from repro_torch.kernels import mach_decode as td
from repro_torch.kernels import ops
from torch_cases import assert_topk_close, dyadic_meta, mult_shift, random_meta

# (n, r, b, k): ODP-like odd R; even R; forced ties (4 bucket patterns)
SHAPES = [(9, 5, 32, 700), (5, 4, 16, 513), (6, 2, 2, 300)]


def _jax_top1(meta, tab, coeffs, shift, k, inline):
    if inline:
        return mach_decode_pallas(jnp.asarray(meta), num_classes=k,
                                  inline_coeffs=jnp.asarray(coeffs),
                                  inline_shift=shift, interpret=True)
    return mach_decode_pallas(jnp.asarray(meta), jnp.asarray(tab),
                              num_classes=k, interpret=True)


def _port_top1(meta, tab, coeffs, shift, k, inline):
    if inline:
        return ops.mach_top1(torch.from_numpy(meta), num_classes=k,
                             inline_coeffs=torch.from_numpy(
                                 coeffs.astype(np.int64)),
                             inline_shift=shift)
    return ops.mach_top1(torch.from_numpy(meta), torch.from_numpy(tab),
                         num_classes=k)


@pytest.mark.parametrize("inline", [False, True], ids=["table", "inline"])
@pytest.mark.parametrize("n,r,b,k", SHAPES)
def test_top1_dyadic_exact(n, r, b, k, inline):
    meta = dyadic_meta(n, r, b, seed=r * b)
    tab, coeffs, shift = mult_shift(b, r, k)
    jv, ji = _jax_top1(meta, tab, coeffs, shift, k, inline)
    tv, ti = _port_top1(meta, tab, coeffs, shift, k, inline)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    rv, ri = jref.mach_decode_ref(jnp.asarray(meta), jnp.asarray(tab))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))


def test_top1_forced_ties_pick_lowest_id():
    """All probabilities equal: every class ties, the answer is class 0."""
    meta = np.full((3, 3, 4), 0.25, np.float32)
    tab, _, _ = mult_shift(4, 3, 50)
    v, i = ops.mach_top1(torch.from_numpy(meta), torch.from_numpy(tab),
                         num_classes=50)
    np.testing.assert_array_equal(i.numpy(), 0)
    np.testing.assert_array_equal(v.numpy(), 0.75)


def test_top1_random_close():
    n, r, b, k = 11, 5, 32, 900
    meta = random_meta(n, r, b, seed=7)
    tab, _, _ = mult_shift(b, r, k)
    jv, ji = _jax_top1(meta, tab, None, None, k, inline=False)
    tv, ti = ops.mach_top1(torch.from_numpy(meta), torch.from_numpy(tab),
                           num_classes=k)
    scores = np.asarray(jref.mach_scores_ref(jnp.asarray(meta),
                                             jnp.asarray(tab)))
    assert_topk_close(tv.numpy()[:, None], ti.numpy()[:, None],
                      np.asarray(jv)[:, None], np.asarray(ji)[:, None], scores)


def test_top1_leading_dims_and_plain_matches_scores():
    meta = dyadic_meta(6, 3, 8, seed=1).reshape(2, 3, 3, 8)
    tab, _, _ = mult_shift(8, 3, 100)
    v, i = ops.mach_top1(torch.from_numpy(meta), torch.from_numpy(tab),
                         num_classes=100)
    assert tuple(v.shape) == tuple(i.shape) == (2, 3)
    g = ops.mach_scores(torch.from_numpy(meta), torch.from_numpy(tab))
    np.testing.assert_array_equal(v.numpy(), g.max(-1).values.numpy())


def test_decode_operand_checks():
    meta = torch.from_numpy(dyadic_meta(2, 3, 8, seed=0))
    tab, coeffs, shift = mult_shift(8, 3, 40)
    c = torch.from_numpy(coeffs.astype(np.int64))
    with pytest.raises(ValueError, match="table or"):
        ops.mach_top1(meta, num_classes=40)
    with pytest.raises(ValueError, match="table must be"):
        ops.mach_top1(meta, torch.from_numpy(tab[:, :30]), num_classes=40)
    with pytest.raises(ValueError, match="power-of-two"):
        ops.mach_top1(torch.zeros(2, 3, 6), num_classes=40, inline_coeffs=c,
                      inline_shift=shift)
    with pytest.raises(ValueError, match="outside"):
        ops.mach_top1(meta, num_classes=40, inline_coeffs=c,
                      inline_shift=shift - 1)
    with pytest.raises(ValueError, match="largest R"):
        ops.mach_top1(torch.zeros(1, td.MAX_R + 1, 2),
                      torch.zeros(td.MAX_R + 1, 5, dtype=torch.int32),
                      num_classes=5)
    with pytest.raises(ValueError, match="CUDA"):
        td.mach_decode_cuda(meta, torch.from_numpy(tab), num_classes=40)
