"""Kernel 10 (flash attention): the port's plain version against the TPU
kernel run in interpret mode (``flash_attention_pallas(interpret=True)``)
and against the port's materializing oracle, on the CPU, float32.

Causal, windowed, GQA and MQA cases, and the bfloat16 cast points.  The TPU kernel walks 512-wide
tiles and the plain version the CUDA kernel's 64-key tiles, so their
running maxima differ; in float32 (no rounding of e) that changes only
the order of the sums: rtol 1e-5 (atol 1e-6 for values near zero).

The backward (``flash_attention_bwd_plain``, which the op's autograd
Function runs on CPU tensors) is held against ``jax.vjp`` of the JAX
oracle ``ref.flash_attention_ref`` (the model's dense attention, reached
through ``jax_reference()``): float32 at rtol 1e-5 (atol 1e-5 of the
tensor's largest entry, for entries that cancel).  bfloat16, from the
same bf16 inputs: each of dQ, dK, dV is held to the float32 gradient
(``jax.vjp`` in float32 of the same values) with at most twice the
relative L2 error of JAX's bf16 gradient, plus 2^-9 (the model's
rule), and dK and dV also within 2 bf16 ulps of each row's largest entry
of JAX's, the forward's rule.  The port rounds P to v's dtype before
dV = Pᵀ·dO (as JAX's bf16 backward does: its dV equals JAX's here) and
dS to k's dtype before dQ and dK (the bf16 operands of the tensor-core
kernels), and keeps dP in float32.  dQ is not held row by row to JAX's:
JAX's bf16 backward rounds dP to bf16 (the cotangent of its cast of p to
v's type), and dQ = Σ dS·K cancels, so that rounding moves JAX's dQ rows
by up to ~40 of their ulps.  Relative L2 errors to the float32 gradient,
port / JAX, in these cases: dQ 0.0025–0.0030 / 0.0024–0.0032, dK
0.0026–0.0034 / 0.0025–0.0032, dV equal.  A materializing computation
with the same roundings holds the plain bf16 backward's cast points
entry by entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from torch_reference import jax_reference

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


BWD_CASES = [
    # (B, T, H, KV, hd, window)
    (1, 70, 4, 4, 16, None),        # MHA, causal
    (2, 70, 4, 2, 32, 20),          # GQA, windowed
    (1, 130, 10, 1, 32, 48),        # MQA, G = 10, windowed (recurrentgemma)
]


def _jax_vjp(q, k, v, do, window):
    with jax_reference():
        from repro.kernels import ref as jref
        out, vjp = jax.vjp(
            lambda *z: jref.flash_attention_ref(*z, causal=True,
                                                window=window),
            *(jnp.asarray(z) for z in (q, k, v)))
        return out, vjp(jnp.asarray(do))


def _port_grads(q, k, v, do, window):
    leaves = [z.clone().requires_grad_(True) for z in (q, k, v)]
    ops.flash_attention(*leaves, window=window).backward(do)
    return [z.grad for z in leaves]


@pytest.mark.parametrize("b,t,h,kv,hd,window", BWD_CASES)
def test_backward_matches_jax_vjp_float32(b, t, h, kv, hd, window):
    q, k, v = _qkv(b, t, h, kv, hd, seed=t + kv)
    do = np.random.default_rng(t).standard_normal(q.shape).astype(np.float32)
    _, want = _jax_vjp(q, k, v, do, window)
    got = _port_grads(*(torch.from_numpy(z) for z in (q, k, v, do)), window)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))
    # the port's oracle: autograd through its dense attention
    for g, w in zip(got, ref.flash_attention_grad_ref(
            *(torch.from_numpy(z) for z in (q, k, v, do)), window=window)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("b,t,h,kv,hd,window", BWD_CASES)
def test_backward_matches_jax_vjp_bfloat16(b, t, h, kv, hd, window):
    q, k, v = (torch.from_numpy(z).bfloat16()
               for z in _qkv(b, t, h, kv, hd, seed=t + kv + 1))
    do = torch.from_numpy(np.random.default_rng(t + 1).standard_normal(
        q.shape).astype(np.float32)).bfloat16()
    to_np = lambda z: z.float().numpy().astype(jnp.bfloat16)  # noqa: E731
    _, want = _jax_vjp(*(to_np(z) for z in (q, k, v, do)), window)
    _, truth = _jax_vjp(*(z.float().numpy() for z in (q, k, v, do)), window)
    got = _port_grads(q, k, v, do, window)
    for name, g, w, tr in zip("qkv", got, want, truth):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        w = torch.from_numpy(np.asarray(w).astype(np.float32))
        tr = torch.from_numpy(np.array(tr))
        e_port = float((g.float() - tr).norm() / tr.norm())
        e_jax = float((w - tr).norm() / tr.norm())
        assert e_port <= 2 * e_jax + 2.0 ** -9, (name, e_port, e_jax)
        if name != "q":
            assert torch.all(torch.abs(g.float() - w) <= 2 * bf16_row_ulp(w))


def test_forward_with_lse_is_the_forward():
    """Asking for the lse changes no bit of the output; lse = m + log l
    equals the log-sum-exp of the masked scores."""
    q, k, v = (torch.from_numpy(z) for z in _qkv(1, 100, 4, 2, 32, seed=9))
    out, lse = fa.flash_attention_plain(q, k, v, window=30, return_lse=True)
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, window=30))
    s = torch.einsum("bthd,bshd->bhts", q / np.sqrt(32),
                     k.repeat_interleave(2, 2))
    rows, cols = torch.arange(100)[:, None], torch.arange(100)[None, :]
    s = s.masked_fill(~((cols <= rows) & (cols > rows - 30)), -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5,
                               atol=1e-5)


def _materialized_bwd(q, k, v, out, do, lse, window):
    """The backward on whole (T, S) score matrices, with the plain
    version's roundings: P to v's dtype before dV = Pᵀ·dO, dS to k's
    dtype before dQ = dS·K·scale and dK = dSᵀ·Qs."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    g, scale = h // kv, 1.0 / np.sqrt(hd)
    qs = (q.float() * scale).to(k.dtype).float().permute(0, 2, 1, 3)
    kf, vf = (z.float().permute(0, 2, 1, 3).repeat_interleave(g, 1)
              for z in (k, v))
    dof = do.float().permute(0, 2, 1, 3)
    d = (dof * out.float().permute(0, 2, 1, 3)).sum(-1)
    rows, cols = torch.arange(t)[:, None], torch.arange(t)[None, :]
    ok = (cols <= rows) & (cols > rows - window)
    p = torch.where(ok, torch.exp(qs @ kf.transpose(-1, -2) - lse[..., None]),
                    0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - d[..., None])
    ds, p = ds.to(k.dtype).float(), p.to(v.dtype).float()
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qs).reshape(b, kv, g, t, hd).sum(2)
    dv = (p.transpose(-1, -2) @ dof).reshape(b, kv, g, t, hd).sum(2)
    return [x.to(like.dtype).permute(0, 2, 1, 3)
            for x, like in ((dq, q), (dk, k), (dv, v))]


@pytest.mark.parametrize("b,t,h,kv,hd,window", [(1, 130, 4, 2, 32, 48),
                                                 (2, 100, 10, 1, 16, 30)])
def test_bf16_backward_cast_points(b, t, h, kv, hd, window):
    """The plain bf16 backward rounds P and dS where the tensor-core
    kernels do (their bf16 operands): against a materializing computation
    with the same roundings, each entry within one bf16 ulp of itself
    past a 2^-20 floor of the tensor's largest entry (the float32 sums
    run over 64-key tiles there and whole rows here).  Without the
    roundings entries move by hundreds of their ulps."""
    rng = np.random.default_rng(t + h)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).bfloat16() for s in ((b, t, h, hd), (b, t, kv, hd),
                                          (b, t, kv, hd), (b, t, h, hd)))
    out, lse = fa.flash_attention_plain(q, k, v, window=window,
                                        return_lse=True)
    got = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, window=window)
    want = _materialized_bwd(q, k, v, out, do, lse, window)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _, e = torch.frexp(w.float())
        ulp = torch.ldexp(torch.ones_like(w, dtype=torch.float32), e - 8)
        floor = 2.0 ** -20 * float(w.float().abs().max())
        assert torch.all((g.float() - w.float()).abs() <= ulp + floor)
