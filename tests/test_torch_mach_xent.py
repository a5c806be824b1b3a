"""Kernel 3 (the R-head cross-entropy on given logits): the port's
``ops.mach_xent`` on the CPU against the TPU kernel run in interpret mode
(``mach_xent_pallas(interpret=True)``), forward and through ``jax.vjp``,
and against the JAX oracles ``ref.mach_xent_ref`` / ``mach_xent_grad_ref``.

Same numpy inputs to both.  Float32: loss and gradient at rtol 1e-6
(atol 1e-7 for gradient entries near zero; the max, exp-sum and log run
in float32 on both sides, in other orders).  bfloat16 logits: the loss
is computed in float32 from the same bf16 values, so rtol 1e-6 still; the
gradient is written in bf16, within one bf16 ulp of the TPU kernel's
(float32 results a few ulps apart may round to neighbouring bf16
values).  N is not a multiple of the TPU kernel's block (it pads N; the
port needs no padding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mach_xent import mach_xent_pallas
from repro_torch.kernels import mach_xent as mx
from repro_torch.kernels import ops, ref

RTOL, ATOL = 1e-6, 1e-7


def _inputs(n, r, b, seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((n, r, b))).astype(np.float32)
    labels = rng.integers(0, b, (n, r)).astype(np.int32)
    labels[0], labels[-1] = 0, b - 1
    g = rng.standard_normal(n).astype(np.float32)
    return logits, labels, g


def _port(logits, labels, g):
    lg = logits.clone().requires_grad_(True)
    loss = ops.mach_xent(lg, labels)
    loss.backward(g)
    return loss.detach(), lg.grad


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.ones_like(x, dtype=np.float32), e - 8)


@pytest.mark.parametrize("n,r,b,block_n", [(13, 4, 16, 8), (37, 8, 2048, 16),
                                           (5, 3, 37, 8)])
def test_float32_matches_tpu_kernel_forward_and_vjp(n, r, b, block_n):
    logits, labels, g = _inputs(n, r, b, seed=n)
    loss_j, vjp = jax.vjp(lambda x: mach_xent_pallas(x, jnp.asarray(labels),
                                                     block_n, True),
                          jnp.asarray(logits))
    (grad_j,) = vjp(jnp.asarray(g))
    loss_t, grad_t = _port(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.from_numpy(g))
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=RTOL)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=RTOL,
                               atol=ATOL)
    # and the JAX oracles, and the port's own
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(jref.mach_xent_ref(
        jnp.asarray(logits), jnp.asarray(labels))), rtol=RTOL)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(
        jref.mach_xent_grad_ref(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(g))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss_t.numpy(), ref.mach_xent_ref(
        torch.from_numpy(logits), torch.from_numpy(labels)).numpy(), rtol=RTOL)


@pytest.mark.parametrize("n,r,b", [(13, 4, 16), (37, 8, 2048)])
def test_bfloat16_logits_match_tpu_kernel(n, r, b):
    logits, labels, g = _inputs(n, r, b, seed=n + 1)
    lg16 = jnp.asarray(logits).astype(jnp.bfloat16)
    loss_j, vjp = jax.vjp(lambda x: mach_xent_pallas(x, jnp.asarray(labels),
                                                     8, True), lg16)
    (grad_j,) = vjp(jnp.asarray(g))
    assert grad_j.dtype == jnp.bfloat16
    lt = torch.from_numpy(np.array(lg16.astype(jnp.float32))).bfloat16()
    loss_t, grad_t = _port(lt, torch.from_numpy(labels), torch.from_numpy(g))
    assert loss_t.dtype == torch.float32 and grad_t.dtype == torch.bfloat16
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=RTOL)
    want = np.asarray(grad_j.astype(jnp.float32))
    assert np.all(np.abs(grad_t.float().numpy() - want) <= _bf16_ulp(want))


def test_leading_dims_flatten_like_jax():
    """(B, T, R, Bk) logits and (B, T, R) labels -> (B, T), as the LM
    loss calls it; the plain forward and backward are the Function's."""
    logits, labels, g = _inputs(2 * 7, 4, 16, seed=3)
    lg4 = torch.from_numpy(logits.reshape(2, 7, 4, 16))
    lb3 = torch.from_numpy(labels.reshape(2, 7, 4))
    loss4, grad4 = _port(lg4, lb3, torch.from_numpy(g.reshape(2, 7)))
    assert loss4.shape == (2, 7) and grad4.shape == (2, 7, 4, 16)
    loss2, grad2 = _port(torch.from_numpy(logits), torch.from_numpy(labels),
                         torch.from_numpy(g))
    assert torch.equal(loss4.reshape(-1), loss2)
    assert torch.equal(grad4.reshape(grad2.shape), grad2)
    assert torch.equal(grad2, mx.mach_xent_grad_plain(
        *(torch.from_numpy(z) for z in (logits, labels, g))))


def test_label_outside_the_buckets_picks_nothing():
    """The TPU kernel's one-hot contraction: a label outside [0, B)
    contributes lse only, and no -1 to the gradient."""
    logits, labels, g = _inputs(4, 2, 8, seed=4)
    labels[1, 0] = 8
    loss_j = mach_xent_pallas(jnp.asarray(logits), jnp.asarray(labels), 8,
                              True)
    loss_t, grad_t = _port(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.from_numpy(g))
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=RTOL)
    assert torch.all(grad_t[1, 0] * float(np.sign(g[1])) >= 0)


def test_operands_are_checked():
    logits = torch.randn(3, 2, 8)
    labels = torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        mx.check_operands(logits, labels.to(torch.int16))
    with pytest.raises(ValueError, match="labels must be"):
        ops.mach_xent(logits, labels[:2])
    with pytest.raises(ValueError, match="one of"):
        ops.mach_xent(logits.double(), labels)
    with pytest.raises(ValueError, match="CUDA"):
        mx.mach_xent_cuda_fwd(logits, labels)
    with pytest.raises(ValueError, match="CUDA"):
        mx.mach_xent_cuda_bwd(logits, labels, torch.ones(3))
