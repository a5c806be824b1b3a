"""Kernel 9 (the RG-LRU scan): the port's plain version against the TPU
kernel run in interpret mode (``lru_scan_pallas(interpret=True)``) and
the JAX oracle, on the CPU.

The plain version is a sequential float32 loop (the CUDA kernel's
arithmetic, bit for bit); the TPU kernel walks the same loop in blocks,
the JAX oracle an associative scan — so rtol 1e-5 (atol 1e-6 for values
near zero).  The port's own oracle, ``ref.lru_scan_ref``, is an
associative scan too.

The backward (the reverse loop ``lru_scan_bwd_plain``, which the op's
autograd Function runs on CPU tensors) is held against ``jax.vjp`` of
the JAX oracle (JAX does not differentiate the TPU kernel: it has no
backward, and ``pallas_call``'s JVP refuses its scratch) at rtol 1e-5 (atol
1e-5 of the largest entry, for entries that cancel), and against
``torch.autograd`` through the plain forward loop, bit for bit.
"""

import sys

import jax
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


def _vjp_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("b,t,d", [(2, 32, 128), (3, 37, 30), (4, 1, 16)])
def test_backward_matches_jax_vjp(b, t, d):
    """da, dx and dh0 at nonzero h0, T = 1 included (dh0 = a_0·dh_0)."""
    a, x, h0 = _inputs(b, t, d, seed=t + 7)
    dh = np.random.default_rng(t).standard_normal((b, t, d)).astype(np.float32)
    _, vjp = jax.vjp(jref.lru_scan_ref, *(jnp.asarray(z) for z in (a, x, h0)))
    want = vjp(jnp.asarray(dh))
    leaves = [torch.from_numpy(z).requires_grad_(True) for z in (a, x, h0)]
    ops.lru_scan(*leaves).backward(torch.from_numpy(dh))
    for leaf, w in zip(leaves, want):
        _vjp_close(leaf.grad, w)
    # the port's oracle: autograd through the associative scan
    for leaf, w in zip(leaves, ref.lru_scan_grad_ref(
            *(torch.from_numpy(z) for z in (a, x, h0)), torch.from_numpy(dh))):
        _vjp_close(leaf.grad, w.numpy())


def test_backward_equals_autograd_of_the_plain_loop():
    """The reverse loop computes what autograd of the forward loop does,
    with the same products and sums in the same order: bit for bit."""
    a, x, h0 = (torch.from_numpy(z) for z in _inputs(2, 9, 16, seed=8))
    dh = torch.randn(2, 9, 16, generator=torch.Generator().manual_seed(0))
    leaves = [z.clone().requires_grad_(True) for z in (a, x, h0)]
    ls.lru_scan_plain(*leaves).backward(dh)
    h = ls.lru_scan_plain(a, x, h0)
    da, dx, dh0 = ls.lru_scan_bwd_plain(a, h, h0, dh)
    for got, leaf in zip((da, dx, dh0), leaves):
        assert torch.equal(got, leaf.grad)


def test_backward_keeps_dtypes():
    """bf16 a and x: da and dx come back in bf16, dh0 in h0's dtype."""
    a, x, h0 = (torch.from_numpy(z) for z in _inputs(2, 5, 8, seed=9))
    leaves = [a.bfloat16().requires_grad_(True),
              x.bfloat16().requires_grad_(True), h0.requires_grad_(True)]
    h = ops.lru_scan(*leaves)
    assert h.dtype == torch.bfloat16
    h.float().sum().backward()
    assert [z.grad.dtype for z in leaves] == [torch.bfloat16, torch.bfloat16,
                                              torch.float32]
