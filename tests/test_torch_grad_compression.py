"""Gradient compression against the JAX package's ``repro.optim``:
``topk_compress`` with error feedback, ``quantize_8bit`` and
``dequantize_8bit`` on the same numpy gradient trees.  Both packages
compute the same float32 operations in the same order, so every output
is held exactly: the kept entries (and so the mask), the residual, the
int8 payload and the scale.

Inputs that pick the edge cases: exact ties at the top-k threshold (all
kept), values at exactly .5 of a quantization step (round half to
even), an all-zero leaf (scale 1e-12 / 127), a leaf smaller than
1 / fraction (k = 1), and two rounds of error feedback.
"""

import jax
import numpy as np
import pytest
import torch

from repro import optim as jo
from repro_torch import optim as to


def _tree(seed):
    rng = np.random.default_rng(seed)
    tied = rng.uniform(-1, 1, size=(8, 16)).astype(np.float32)
    tied.reshape(-1)[[3, 40, 77, 100, 5, 9]] = [2.5] * 4 + [-2.5] * 2
    # the six largest |g|, tied
    return {"w": rng.normal(size=(32, 24)).astype(np.float32),
            "tied": tied,
            "zero": np.zeros((5, 3), np.float32),
            "tiny": rng.normal(size=(7,)).astype(np.float32),
            "nested": {"k": rng.normal(size=(3, 4, 5)).astype(np.float32)}}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _equal(got, want):
    flat_got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    flat_want = jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fraction", [0.01, 0.05, 0.5])
def test_topk_compress_two_rounds_of_error_feedback(fraction):
    g1, g2 = _tree(1), _tree(2)
    jef, tef = jo.init_error_feedback(g1), to.init_error_feedback(
        _to_torch(g1))
    _equal(tef.residual, jef.residual)
    for g in (g1, g2):
        jkept, jef = jo.topk_compress(g, jef, fraction)
        tkept, tef = to.topk_compress(_to_torch(g), tef, fraction)
        _equal(tkept, jkept)
        _equal(tef.residual, jef.residual)
        for leaf, res in zip(jax.tree.leaves(jkept),
                             jax.tree.leaves(jef.residual)):
            leaf, res = np.asarray(leaf), np.asarray(res)
            if leaf.any():
                assert (leaf != 0).sum() >= max(1, int(leaf.size * fraction))
            assert not np.any((leaf != 0) & (res != 0))


def test_topk_keeps_every_tie_at_the_threshold():
    g = _tree(3)
    kept, _ = to.topk_compress(_to_torch(g),
                               to.init_error_feedback(_to_torch(g)),
                               fraction=3 / 128)      # k = 3 of the 6 ±2.5s
    tied = kept["tied"].numpy()
    assert (tied != 0).sum() == 6 and set(np.abs(tied[tied != 0])) == {2.5}


def test_quantize_8bit_matches():
    g = _tree(4)
    half = np.arange(-6, 7, dtype=np.float32) + 0.5   # scale 1: x.5 steps
    half = np.concatenate([half, [127.0]]).astype(np.float32)
    g["half"] = half
    jq, tq = jo.quantize_8bit(g), to.quantize_8bit(_to_torch(g))
    _equal(tq.q, jq.q)
    _equal(tq.scale, jq.scale)
    assert float(tq.scale["half"]) == 1.0
    assert tq.q["half"][:13].tolist() == [-6, -4, -4, -2, -2, 0, 0, 2, 2, 4,
                                          4, 6, 6]
    assert float(tq.scale["zero"]) == np.float32(np.float32(1e-12) / 127)
    _equal(to.dequantize_8bit(tq), jo.dequantize_8bit(jq))


def test_compression_is_exported_like_jax():
    for name in ("init_error_feedback", "topk_compress", "quantize_8bit",
                 "dequantize_8bit"):
        assert name in to.__all__ and name in jo.__all__
    assert to.ErrorFeedbackState._fields == ("residual",)
    assert to.Quantized._fields == ("q", "scale")
