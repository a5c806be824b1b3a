"""MACH R-head cross-entropy on given logits (the LM's training loss).

For logits (N, R, B) and hashed labels (N, R):

    loss_n = Σ_r [lse(logits[n, r]) − logits[n, r, y_nr]]        (N,) float32
    dloss/dlogits = g_n · (softmax(logits[n, r]) − onehot(y_nr))

``ops.mach_xent`` is differentiable wrt the logits: it runs the
``torch.autograd.Function`` ``MachXent``, whose forward and backward
are, on CUDA tensors, the hand-written kernels of ``csrc/mach_xent.cu``
(they replace the TPU kernel
``repro/kernels/mach_xent.py::mach_xent_pallas``); on CPU tensors the
same Function runs the plain versions, ``mach_xent_plain`` forward and
``mach_xent_grad_plain`` backward.  Logits are float32 or
bfloat16 and the arithmetic float32; the loss is float32 and the
gradient takes the logits' dtype, as the TPU kernel's backward writes
it.  Labels get no gradient.  A label outside [0, B) picks nothing (the
TPU kernel's one-hot contraction).  On fake tensors the Function runs
the kernels' stand-ins (``counting``); ``work`` is their arithmetic.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, counting

_DTYPES = (torch.float32, torch.bfloat16)


def work(n: int, r: int, b: int, dtype: torch.dtype,
         backward: bool = False) -> tuple[int, int]:
    """(flops, bytes) of kernel 3 on (N, R, B) logits of ``dtype``: four
    operations a logit each pass (max, subtract, exp, sum; backward exp,
    subtract, scale, one-hot); forward the logits and labels read and
    the (N,) loss written, backward also g read and the gradient
    written."""
    logits = n * r * b
    nbytes = (2 if backward else 1) * dtype.itemsize * logits
    return 4 * logits, nbytes + 4 * n * r + 4 * n


def check_operands(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() != 3 or min(logits.shape) < 1:
        raise ValueError(f"logits must be a non-empty (N, R, B), got "
                         f"{tuple(logits.shape)}")
    if tuple(labels.shape) != tuple(logits.shape[:2]):
        raise ValueError(f"labels must be (N, R)={tuple(logits.shape[:2])}, "
                         f"got {tuple(labels.shape)}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"logits must be one of {_DTYPES}, got {logits.dtype}")
    if labels.dtype != torch.int32:
        raise ValueError(f"labels must be int32, got {labels.dtype}")
    if logits.device != labels.device:
        raise ValueError("logits and labels are on different devices")


def _onehot(labels: torch.Tensor, b: int) -> torch.Tensor:
    iota = torch.arange(b, dtype=torch.int32, device=labels.device)
    return (iota == labels[..., None]).to(torch.float32)


def mach_xent_plain(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Plain PyTorch: per-head logsumexp minus the one-hot label pick,
    summed over R, in float32."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.sum(lg * _onehot(labels, lg.shape[-1]), dim=-1)
    return torch.sum(lse - picked, dim=-1)


def mach_xent_grad_plain(logits: torch.Tensor, labels: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: g (N,) · (softmax − onehot) in the logits' dtype."""
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    grad = g.to(torch.float32)[:, None, None] * \
        (p - _onehot(labels, logits.shape[-1]))
    return grad.to(logits.dtype)


def _launch(fn: str, device: torch.device, *args) -> None:
    lib = _build.load("mach_xent")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn)(*args, stream)
    _build.check(lib, code, fn)


def _check_cuda(logits: torch.Tensor, labels: torch.Tensor) -> None:
    check_operands(logits, labels)
    if logits.device.type != "cuda":
        raise ValueError("the mach_xent kernels need CUDA tensors")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError("logits and labels must be contiguous")


def mach_xent_cuda_fwd(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Forward kernel -> (N,) float32 loss.  ``.launches`` counts it."""
    _check_cuda(logits, labels)
    n, r, b = logits.shape
    loss = torch.empty((n,), dtype=torch.float32, device=logits.device)
    _launch("mach_xent_fwd_launch", logits.device, logits.data_ptr(),
            labels.data_ptr(), loss.data_ptr(), n, r, b,
            int(logits.dtype == torch.bfloat16))
    mach_xent_cuda_fwd.launches += 1
    return loss


def mach_xent_cuda_bwd(logits: torch.Tensor, labels: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """Backward kernel: g (N,) float32 -> the logits' gradient in their
    dtype.  ``.launches`` counts it."""
    _check_cuda(logits, labels)
    n, r, b = logits.shape
    if tuple(g.shape) != (n,) or g.dtype != torch.float32 or \
            g.device != logits.device or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous float32 ({n},) on "
                         f"{logits.device}")
    grad = torch.empty_like(logits)
    _launch("mach_xent_bwd_launch", logits.device, logits.data_ptr(),
            labels.data_ptr(), g.data_ptr(), grad.data_ptr(), n, r, b,
            int(logits.dtype == torch.bfloat16))
    mach_xent_cuda_bwd.launches += 1
    return grad


mach_xent_cuda_fwd.launches = 0
mach_xent_cuda_bwd.launches = 0


def mach_xent_fake_fwd(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """The forward kernel's stand-in on fake tensors: its (N,) float32
    loss; nothing built or launched."""
    return logits.new_empty(logits.shape[:1], dtype=torch.float32)


def mach_xent_fake_bwd(logits: torch.Tensor, labels: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """The backward kernel's stand-in on fake tensors: the gradient."""
    return torch.empty_like(logits, memory_format=torch.contiguous_format)


class MachXent(torch.autograd.Function):
    """The kernels on CUDA tensors, the plain versions on CPU tensors,
    the stand-ins on fake tensors."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        with counting.launch("mach_xent_fwd", work(*logits.shape,
                                                   logits.dtype)):
            if counting.is_fake(logits):
                return mach_xent_fake_fwd(logits, labels)
            if logits.device.type == "cuda":
                return mach_xent_cuda_fwd(logits, labels)
            return mach_xent_plain(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        with counting.launch("mach_xent_bwd", work(*logits.shape,
                                                   logits.dtype, True)):
            if counting.is_fake(logits):
                return mach_xent_fake_bwd(logits, labels, g), None
            if logits.device.type == "cuda":
                return mach_xent_cuda_bwd(logits, labels, g), None
            return mach_xent_grad_plain(logits, labels, g), None

