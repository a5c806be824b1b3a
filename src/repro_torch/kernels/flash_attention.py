"""Causal / windowed GQA flash attention (online softmax, f32 state).

``ops.flash_attention`` takes q (B, T, H, hd) and k, v (B, S, KV, hd)
of one dtype and returns (B, T, H, hd) in q's dtype, for contiguous
positions: query row i may see key column j iff j <= i (causal) and
j > i - window (windowed); unmasked, S may differ from T (the
encoder's and the cross-attention's calls), and both passes read S.  It runs the ``torch.autograd.Function``
``FlashAttention``.  On CUDA tensors its forward calls
``flash_attention_cuda``, which launches the hand-written kernel in
``csrc/flash_attention.cu`` (it replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``), and its
backward ``flash_attention_bwd_cuda``, the FlashAttention-2 recurrence of
``csrc/flash_attention_bwd.cu``; bfloat16 runs on the tensor cores
(``flash_mma_kernel``; ``dq_mma_kernel`` then ``dkdv_mma_kernel``),
float32 on float32 FMAs (``flash_kernel``; ``row_dot_kernel``,
``dkdv_kernel``, ``dq_kernel``).  On CPU tensors it runs
``flash_attention_plain`` and ``flash_attention_bwd_plain``.  When a
gradient is wanted the forward also returns the row log-sum-exp
(B, H, T) float32, which the backward reads; otherwise it is not formed.
On fake tensors both passes run the kernels' stand-ins (``counting``);
``work`` is their arithmetic.

The plain version computes what the TPU kernel's ``_flash_body`` does,
with the same cast points — q scaled in float32 and rounded to k's
dtype, float32 scores, masked scores at float32's most negative value,
the guarded correction of rows with no valid column yet, e rounded to
v's dtype before P·V, acc / max(l, 1e-37) with l = 0 rows set to zero —
over the kernels' 64-key tiles, so both round at the same points.  The
backward is the gradient of softmax attention from the saved lse (not
of the forward's rounding of e): P = exp(S − lse), dS = P ∘ (dP − D)
with D = rowsum(dO ∘ O), in float32; then P is rounded to v's dtype
before dV = Pᵀ·dO, and dS to k's dtype before dQ = dS·K·scale and
dK = dSᵀ·Qs (Qs is q·scale rounded to k's dtype as the forward forms
it).  Those are the bf16 operands of the tensor cores (FlashAttention-2's
cast points); in float32 the roundings change nothing.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, counting

NEG_INF = float(torch.finfo(torch.float32).min)
BLOCK_K = 64                 # key tile of the kernels (csrc kBK)
MAX_HEAD_DIM = 256           # largest hd the kernels take (csrc kMaxHd)
_DTYPES = (torch.float32, torch.bfloat16)


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, T, H, hd) and k, v (B, S, KV, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}"
                         f" (same B and hd, H a multiple of KV)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v are on different devices")


def attended_pairs(t: int, window) -> int:
    """(query, key) pairs a causal, optionally windowed self-attention of
    length t attends: sum over rows i of min(i + 1, window)."""
    w = t if window is None else min(window, t)
    return w * (w + 1) // 2 + (t - w) * w


def work(b: int, t: int, s: int, h: int, kv: int, hd: int,
         dtype: torch.dtype, causal: bool, window: Optional[int],
         backward: bool = False, lse: bool = False) -> tuple[int, int]:
    """(flops, bytes) of kernel 10 on q (B, T, H, hd) and k, v (B, S, KV,
    hd) of ``dtype``: 4·hd flops an attended (query, key) pair and head
    forward (two products), 10·hd backward (five); causal pairs by
    ``attended_pairs`` (S = T), otherwise T·S.  Bytes: q, k and v read
    and out written (with ``lse`` the (B, H, T) float32 lse too);
    backward q, k, v, out, dout and lse read, dq, dk and dv written."""
    pairs = b * h * (attended_pairs(t, window) if causal else t * s)
    q_el, kv_el = b * t * h * hd, b * s * kv * hd
    if backward:
        return (10 * hd * pairs,
                dtype.itemsize * (4 * q_el + 4 * kv_el) + 4 * b * h * t)
    return (4 * hd * pairs, dtype.itemsize * (2 * q_el + 2 * kv_el)
            + (4 * b * h * t if lse else 0))


def _work(q, k, causal, window, backward=False, lse=False):
    b, t, h, hd = q.shape
    return work(b, t, k.shape[1], h, k.shape[2], hd, q.dtype, causal,
                window, backward, lse)


def _mask(rows, cols, causal, window):
    ok = torch.ones((rows.shape[0], cols.shape[1]), dtype=torch.bool,
                    device=rows.device)
    if causal:
        ok &= cols <= rows
    if window is not None:
        ok &= cols > rows - window
    return ok


def _scaled_q(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q·scale rounded to k's dtype, as float32 (B, H, T, hd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q.to(torch.float32) * scale).to(k.dtype).to(torch.float32)
    return qs.permute(0, 2, 1, 3)


def _heads(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, S, KV, hd) -> float32 (B, H, S, hd), each kv head repeated for
    its group of query heads."""
    return x.to(torch.float32).permute(0, 2, 1, 3).repeat_interleave(group, 1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          return_lse: bool = False):
    """Plain PyTorch: the online-softmax recurrence over 64-key tiles.
    With ``return_lse`` returns (out, lse (B, H, T) float32: m + log l,
    +inf for a row with no visible column)."""
    b, t, h, hd = q.shape
    s_len, group = k.shape[1], h // k.shape[2]
    qs = _scaled_q(q, k)                                         # (B, H, T, hd)
    kf, vf = _heads(k, group), _heads(v, group)
    dev = q.device
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, t, hd), dtype=torch.float32, device=dev)
    rows = torch.arange(t, device=dev)[:, None]
    for k0 in range(0, s_len, BLOCK_K):
        k1 = min(k0 + BLOCK_K, s_len)
        ok = _mask(rows, torch.arange(k0, k1, device=dev)[None, :], causal,
                   window)
        sc = torch.where(ok, qs @ kf[:, :, k0:k1].transpose(-1, -2), NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.where(m > NEG_INF / 2, torch.exp(m - m_new), 0.0)
        e = torch.where(ok, torch.exp(sc - m_new[..., None]), 0.0)
        l = l * corr + e.sum(-1)
        pv = e.to(v.dtype).to(torch.float32) @ vf[:, :, k0:k1]
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    out = torch.where(l[..., None] > 0, out, 0.0)
    out = out.to(q.dtype).permute(0, 2, 1, 3).contiguous()
    if not return_lse:
        return out
    return out, torch.where(l > 0, m + torch.log(l), torch.inf)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True,
                              window: Optional[int] = None):
    """Plain PyTorch: the FlashAttention-2 backward over 64-key tiles,
    from the forward's output and lse, P rounded to v's dtype for dV and
    dS to k's dtype for dQ and dK.  Returns (dq, dk, dv) in q's, k's and
    v's dtypes; dk and dv summed over each kv head's query heads."""
    b, t, h, hd = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = 1.0 / math.sqrt(hd)
    qs = _scaled_q(q, k)
    kf, vf = _heads(k, group), _heads(v, group)
    do = dout.to(torch.float32).permute(0, 2, 1, 3)              # (B, H, T, hd)
    dsum = torch.sum(do * out.to(torch.float32).permute(0, 2, 1, 3), dim=-1)
    dev = q.device
    dq = torch.zeros_like(qs)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    rows = torch.arange(t, device=dev)[:, None]
    for k0 in range(0, s_len, BLOCK_K):
        k1 = min(k0 + BLOCK_K, s_len)
        ok = _mask(rows, torch.arange(k0, k1, device=dev)[None, :], causal,
                   window)
        sc = qs @ kf[:, :, k0:k1].transpose(-1, -2)
        p = torch.where(ok, torch.exp(sc - lse[..., None]), 0.0)
        dp = do @ vf[:, :, k0:k1].transpose(-1, -2)
        ds = (p * (dp - dsum[..., None])).to(k.dtype).to(torch.float32)
        p = p.to(v.dtype).to(torch.float32)
        dq += ds @ kf[:, :, k0:k1]
        dk[:, :, k0:k1] = ds.transpose(-1, -2) @ qs
        dv[:, :, k0:k1] = p.transpose(-1, -2) @ do

    def per_kv(x, like):        # (B, H, S, hd) -> (B, S, KV, hd)
        x = x.reshape(b, kv, group, s_len, hd).sum(2)
        return x.to(like.dtype).permute(0, 2, 1, 3).contiguous()

    dq = (dq * scale).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return dq, per_kv(dk, k), per_kv(dv, v)


def _check_cuda(q, k, v, window) -> None:
    check_operands(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError("the flash attention kernels need CUDA tensors")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise ValueError(f"q, k and v must share one dtype of {_DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    hd = q.shape[3]
    if hd % 16 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} is not a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    _check_aligned(q.dtype, q=q, k=k, v=v)


def _check_aligned(dtype, **tensors) -> None:
    """The bfloat16 kernels move rows in 16-byte ``cp.async`` and vector
    stores, so each base pointer must be 16-byte aligned (a contiguous
    view at an odd storage offset is not)."""
    if dtype != torch.bfloat16:
        return
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the bfloat16 kernels")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         return_lse: bool = False):
    """Launch the kernel on ``q``'s stream: bfloat16 on the tensor cores,
    float32 on FMAs.  q, k, v contiguous, one dtype (float32 or
    bfloat16), hd a multiple of 16 up to 256.  With
    ``return_lse`` returns (out, lse (B, H, T) float32).
    ``flash_attention_cuda.launches`` counts the launches."""
    _check_cuda(q, k, v, window)
    b, t, h, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, t, k.shape[1], h,
            k.shape[2], hd, 1.0 / math.sqrt(hd), int(causal),
            window if window is not None else 0,
            int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, code, "flash_attention")
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None):
    """Launch the backward kernels on ``q``'s stream (bfloat16 on the
    tensor cores, float32 on FMAs): (dq, dk, dv) from the forward's out
    and lse and the cotangent dout (contiguous, q's shape and dtype).
    ``flash_attention_bwd_cuda.launches`` counts the launches."""
    _check_cuda(q, k, v, window)
    b, t, h, hd = q.shape
    for name, x, dtype in (("out", out, q.dtype), ("dout", dout, q.dtype)):
        if x.shape != q.shape or x.dtype != dtype or x.device != q.device \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous, q's shape and dtype")
    _check_aligned(q.dtype, out=out, dout=dout)
    if tuple(lse.shape) != (b, h, t) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(b, h, t)}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dsum = torch.empty_like(lse)
    bf16 = q.dtype == torch.bfloat16
    qs = torch.empty_like(q) if bf16 else None    # Qs, from pass 1 to pass 2
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            None if qs is None else qs.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, t, k.shape[1], h, k.shape[2], hd,
            1.0 / math.sqrt(hd), int(causal),
            window if window is not None else 0, int(bf16), stream)
    _build.check(lib, code, "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


def flash_attention_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         return_lse: bool = False):
    """The forward kernel's stand-in on fake tensors: out (and lse) with
    the kernel's shapes and dtypes; nothing built or launched."""
    b, t, h, _ = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if not return_lse:
        return out
    return out, q.new_empty((b, h, t), dtype=torch.float32)


def flash_attention_bwd_fake(q, k, v, out, dout, lse, *, causal=True,
                             window=None):
    """The backward kernels' stand-in on fake tensors: dq, dk, dv."""
    return tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                 for x in (q, k, v))


class FlashAttention(torch.autograd.Function):
    """Kernel 10 and its backward kernels on CUDA tensors, the plain
    versions on CPU tensors, the stand-ins on fake tensors.  The lse is
    formed only when a gradient is wanted; then q, k, v, out and lse are
    saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if counting.is_fake(q):
            fwd = flash_attention_fake
        else:
            fwd = flash_attention_cuda if q.device.type == "cuda" \
                else flash_attention_plain
        grad = any(ctx.needs_input_grad[:3])
        with counting.launch("flash_attention",
                             _work(q, k, causal, window, lse=grad)):
            if not grad:
                return fwd(q, k, v, causal=causal, window=window)
            out, lse = fwd(q, k, v, causal=causal, window=window,
                           return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if counting.is_fake(q):
            bwd = flash_attention_bwd_fake
        else:
            bwd = flash_attention_bwd_cuda if q.device.type == "cuda" \
                else flash_attention_bwd_plain
        dout = dout.contiguous()
        with counting.launch("flash_attention_bwd",
                             _work(q, k, ctx.causal, ctx.window, True)):
            dq, dk, dv = bwd(q, k, v, out, dout, lse, causal=ctx.causal,
                             window=ctx.window)
        return dq, dk, dv, None, None

