"""RG-LRU linear recurrence h_t = a_t ⊙ h_{t-1} + x_t (recurrentgemma).

``ops.lru_scan`` takes a, x (B, T, D) and h0 (B, D) and returns h
(B, T, D) in x's dtype, carried in float32.  On a CUDA tensor it calls
``lru_scan_cuda``, which launches the hand-written kernel in
``csrc/lru_scan.cu`` (it replaces the TPU kernel
``repro/kernels/lru_scan.py::lru_scan_pallas``); on a CPU tensor it runs
``lru_scan_plain``, the same sequential loop in plain PyTorch.
Both round a·h and then + x separately, so they agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


def check_operands(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"a and x must be one (B, T, D) shape, got "
                         f"{tuple(a.shape)} and {tuple(x.shape)}")
    if tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 must be (B, D)=({a.shape[0]}, {a.shape[2]}), "
                         f"got {tuple(h0.shape)}")
    if not a.device == x.device == h0.device:
        raise ValueError("a, x and h0 are on different devices")


def lru_scan_plain(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
                   ) -> torch.Tensor:
    """Plain PyTorch: the sequential float32 loop over T."""
    h = h0.to(torch.float32)
    af, xf = a.to(torch.float32), x.to(torch.float32)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    for t in range(x.shape[1]):
        h = af[:, t] * h + xf[:, t]
        out[:, t] = h.to(x.dtype)
    return out


def lru_scan_cuda(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
                  ) -> torch.Tensor:
    """Launch the kernel on ``x``'s stream.  a, x contiguous, one dtype
    (float32 or bfloat16); h0 contiguous float32.  Returns (B, T, D) in
    x's dtype.  ``lru_scan_cuda.launches`` counts the launches."""
    check_operands(a, x, h0)
    if x.device.type != "cuda":
        raise ValueError("the lru_scan kernel needs CUDA tensors")
    if a.dtype != x.dtype or x.dtype not in _DTYPES:
        raise ValueError(f"a and x must share one dtype of {_DTYPES}, got "
                         f"{a.dtype} and {x.dtype}")
    if h0.dtype != torch.float32:
        raise ValueError("h0 must be float32")
    if not (a.is_contiguous() and x.is_contiguous() and h0.is_contiguous()):
        raise ValueError("a, x and h0 must be contiguous")
    b, t, d = x.shape
    out = torch.empty_like(x)
    lib = _build.load("lru_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lru_scan_launch(a.data_ptr(), x.data_ptr(), h0.data_ptr(),
                                   out.data_ptr(), b, t, d,
                                   int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, code, "lru_scan")
    lru_scan_cuda.launches += 1
    return out


lru_scan_cuda.launches = 0
