"""Causal / windowed GQA flash attention (online softmax, f32 state).

``ops.flash_attention`` takes q (B, T, H, hd) and k, v (B, S, KV, hd) of
one dtype and returns (B, T, H, hd) in q's dtype, for contiguous
positions: query row i may see key column j iff j <= i (causal) and
j > i - window (windowed).  On a CUDA tensor it calls
``flash_attention_cuda``, which launches the hand-written kernel in
``csrc/flash_attention.cu`` (it replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``); on a CPU
tensor it runs ``flash_attention_plain``.

The plain version computes what the TPU kernel's ``_flash_body`` does,
with the same cast points — q scaled in float32 and rounded to k's
dtype, float32 scores, masked scores at float32's most negative value,
the guarded correction of rows with no valid column yet, e rounded to
v's dtype before P·V, acc / max(l, 1e-37) with l = 0 rows set to zero —
over the kernel's 64-key tiles, so both round at the same points.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = float(torch.finfo(torch.float32).min)
BLOCK_K = 64                 # key tile of the kernel (csrc kBK)
MAX_HEAD_DIM = 256           # largest hd the kernel takes (csrc kMaxHd)
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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch: the online-softmax recurrence over 64-key tiles."""
    b, t, h, hd = q.shape
    s_len, group = k.shape[1], h // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qs = (q.to(torch.float32) * scale).to(k.dtype).to(torch.float32)
    qs = qs.permute(0, 2, 1, 3)                                  # (B, H, T, hd)
    kf = k.to(torch.float32).permute(0, 2, 1, 3).repeat_interleave(group, 1)
    vf = v.to(torch.float32).permute(0, 2, 1, 3).repeat_interleave(group, 1)
    dev = q.device
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, t, hd), dtype=torch.float32, device=dev)
    rows = torch.arange(t, device=dev)[:, None]
    for k0 in range(0, s_len, BLOCK_K):
        k1 = min(k0 + BLOCK_K, s_len)
        cols = torch.arange(k0, k1, device=dev)[None, :]
        ok = torch.ones((t, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            ok &= cols <= rows
        if window is not None:
            ok &= cols > rows - window
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
    return out.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on ``q``'s stream.  q, k, v contiguous, one
    dtype (float32 or bfloat16), hd a multiple of 16 up to 256.
    ``flash_attention_cuda.launches`` counts the launches."""
    check_operands(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError("the flash attention kernel needs CUDA tensors")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise ValueError(f"q, k and v must share one dtype of {_DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, t, h, hd = q.shape
    if hd % 16 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} is not a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t,
            k.shape[1], h, k.shape[2], hd, 1.0 / math.sqrt(hd),
            int(causal), window if window is not None else 0,
            int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, code, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
