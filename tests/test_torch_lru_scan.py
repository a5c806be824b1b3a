"""Kernel 9 (the RG-LRU scan): the port's plain version against the TPU
kernel run in interpret mode (``lru_scan_pallas(interpret=True)``) and
the JAX oracle, on the CPU.

The plain version is a sequential float32 loop (the CUDA kernel's
arithmetic, bit for bit); the TPU kernel walks the same loop in blocks,
the JAX oracle an associative scan — so rtol 1e-5 (atol 1e-6 for values
near zero).  The port's own oracle, ``ref.lru_scan_ref``, is an
associative scan too.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.lru_scan import lru_scan_pallas
from repro_torch.kernels import lru_scan as ls
from repro_torch.kernels import ops, ref
from torch_reference import jax_reference

TOL = {"rtol": 1e-5, "atol": 1e-6}


def _inputs(b, t, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, t, d)).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return a, x, h0


@pytest.mark.parametrize("b,t,d,block_t", [(2, 32, 128, 8), (3, 37, 300, 37),
                                           (4, 1, 256, 1)])
def test_plain_matches_tpu_kernel_and_oracles(b, t, d, block_t):
    a, x, h0 = _inputs(b, t, d, seed=t)
    want = np.asarray(lru_scan_pallas(a, x, h0, block_t=block_t,
                                      interpret=True))
    got = ls.lru_scan_plain(torch.from_numpy(a), torch.from_numpy(x),
                            torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.lru_scan_ref(
        jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))), **TOL)
    mine = ref.lru_scan_ref(torch.from_numpy(a), torch.from_numpy(x),
                            torch.from_numpy(h0))
    np.testing.assert_allclose(mine.numpy(), want, **TOL)
    # the op takes the plain version on CPU tensors: the same bits
    assert torch.equal(ops.lru_scan(torch.from_numpy(a), torch.from_numpy(x),
                                    torch.from_numpy(h0)), got)


def test_plain_is_the_sequential_loop_and_keeps_x_dtype():
    a, x, h0 = (torch.from_numpy(v) for v in _inputs(2, 9, 16, seed=1))
    h = h0.clone()
    for t in range(9):
        h = a[:, t] * h + x[:, t]
    assert torch.equal(ls.lru_scan_plain(a, x, h0)[:, -1], h)
    out = ls.lru_scan_plain(a.bfloat16(), x.bfloat16(), h0)
    assert out.dtype == torch.bfloat16


def test_operands_are_checked():
    a, x, h0 = (torch.from_numpy(v) for v in _inputs(2, 5, 8, seed=2))
    with pytest.raises(ValueError, match="one \\(B, T, D\\)"):
        ops.lru_scan(a, x[:, :4], h0)
    with pytest.raises(ValueError, match="h0"):
        ops.lru_scan(a, x, h0[:1])
    with pytest.raises(ValueError, match="CUDA"):
        ls.lru_scan_cuda(a, x, h0)


def test_reference_modules_removed_after_the_block():
    """The scoped JAX reference leaves ``sys.modules`` as it found it."""
    before = {n for n in sys.modules if n == "repro" or n.startswith("repro.")}
    assert "repro.models" not in before
    with jax_reference() as ns:
        assert ns.models.LanguageModel is not None
        assert "repro.models" in sys.modules
    after = {n for n in sys.modules if n == "repro" or n.startswith("repro.")}
    assert after == before
    for name in ("repro.models", "repro.serving", "repro.configs",
                 "repro.kernels.ops", "repro.kernels.mach_fused_xent"):
        assert name not in sys.modules, name
    assert not hasattr(sys.modules["repro.kernels"], "ops")
