"""Kernel 10 (flash attention): the port's plain version against the TPU
kernel run in interpret mode (``flash_attention_pallas(interpret=True)``)
and against the port's materializing oracle, on the CPU, float32.

Causal, windowed, GQA and MQA cases, and the bfloat16 cast points.  The TPU kernel walks 512-wide
tiles and the plain version the CUDA kernel's 64-key tiles, so their
running maxima differ; in float32 (no rounding of e) that changes only
the order of the sums: rtol 1e-5 (atol 1e-6 for values near zero).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

TOL = {"rtol": 1e-5, "atol": 1e-6}
CASES = [
    # (B, T, H, KV, hd, causal, window, block)
    (1, 128, 4, 4, 32, True, None, 64),       # MHA, causal
    (2, 128, 4, 2, 32, True, 40, 32),         # GQA, windowed
    (1, 192, 8, 1, 64, True, 64, 64),         # MQA, windowed (recurrentgemma)
    (1, 64, 2, 1, 16, False, None, 64),       # no mask
]


def _qkv(b, t, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,t,h,kv,hd,causal,window,block", CASES)
def test_plain_matches_tpu_kernel(b, t, h, kv, hd, causal, window, block):
    q, k, v = _qkv(b, t, h, kv, hd, seed=t + h)
    want = np.asarray(flash_attention_pallas(
        q, k, v, causal=causal, window=window, block_q=block, block_k=block,
        interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the op takes the plain version on CPU tensors
    assert torch.equal(ops.flash_attention(tq, tk, tv, causal=causal,
                                           window=window), got)
    if causal:      # the oracle is the model's dense (causal) attention
        np.testing.assert_allclose(
            ref.flash_attention_ref(tq, tk, tv, window=window).numpy(), want,
            **TOL)


def test_ragged_lengths_match_the_oracle():
    """T off the 64-key tile grid, windowed GQA."""
    q, k, v = _qkv(1, 100, 4, 2, 32, seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = fa.flash_attention_plain(tq, tk, tv, window=30)
    want = ref.flash_attention_ref(tq, tk, tv, window=30)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def bf16_row_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at each (query, head) row's
    largest |value| (8 significand bits)."""
    _, e = torch.frexp(x.float().abs().amax(dim=-1, keepdim=True))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def test_bf16_cast_points_match_tpu_kernel():
    """In bfloat16, with the TPU kernel at the plain version's 64-key
    tiles, both round q·scale and e at the same points and keep q's
    dtype: outputs within 2 bf16 ulps of each (query, head) row's
    largest output (the float32 sums run in other orders, so an e may
    round to its other bf16 neighbour, which moves the row by
    p·|v|·2^-8)."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(1, 128, 4, 1, 32, seed=6))
    to_np = lambda t: t.float().numpy().astype(jnp.bfloat16)  # noqa: E731
    want = torch.from_numpy(np.asarray(flash_attention_pallas(
        to_np(q), to_np(k), to_np(v), window=48, block_q=64, block_k=64,
        interpret=True)).astype(np.float32))
    got = fa.flash_attention_plain(q, k, v, window=48)
    assert got.dtype == torch.bfloat16
    assert torch.all(torch.abs(got.float() - want) <= 2 * bf16_row_ulp(want))


def test_operands_are_checked():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 4, 2, 16, seed=1))
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 16),
                            v[:, :, :1].expand(1, 8, 3, 16))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
