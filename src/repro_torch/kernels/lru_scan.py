"""RG-LRU linear recurrence h_t = a_t ⊙ h_{t-1} + x_t (recurrentgemma).

``ops.lru_scan`` takes a, x (B, T, D) and h0 (B, D) and returns h
(B, T, D) in x's dtype, carried in float32, through the
``torch.autograd.Function`` ``LruScan``.  On CUDA tensors its forward calls
``lru_scan_cuda``, which launches the hand-written kernel in
``csrc/lru_scan.cu`` (it replaces the TPU kernel
``repro/kernels/lru_scan.py::lru_scan_pallas``), and its backward
``lru_scan_bwd_cuda``, the reverse recurrence of ``csrc/lru_scan_bwd.cu``;
on CPU tensors it runs ``lru_scan_plain`` and ``lru_scan_bwd_plain``,
the same sequential loops in plain PyTorch.  Each pair rounds a product
and then a sum separately, so kernel and plain version agree bit for
bit.  The backward reads the forward's output h, not a recomputation.

Both kernels give a block to a walker group of ``CHANNELS`` channels of
one batch row: one warp walks, two fill a ring of stages in shared
memory and one drains it (``csrc/lru_ring.cuh``); ``scan_layout`` picks
the ring's depth and the width of its copies from the shape, the
operands' alignment and the card's SM count and shared memory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)

# copies of csrc/lru_ring.cuh's constants (tests read them against it)
CHANNELS = 16          # kChannels: channels a walker group owns
STEPS_LONG = 32        # kStepsLong: steps a stage holds in float32 (x2 in bf16)
STEPS_SHORT = 16       # kStepsShort: the same, when an SM holds > 2 groups
MAX_STAGES = 24        # kMaxStages: ring slots at most
UNITS = (16, 4, 2)     # Unit: bytes a copy moves


class Card(NamedTuple):
    sms: int           # streaming multiprocessors
    smem_per_sm: int   # shared memory an SM shares among its blocks
    block_reserved: int  # of it, held back by the system for each block


class ScanLayout(NamedTuple):
    unit: int          # bytes a copy or store moves
    steps_f32: int     # STEPS_LONG or STEPS_SHORT, the kernels' SF
    stages: int        # ring slots


def scan_layout(b: int, t: int, d: int, dtype: torch.dtype, backward: bool,
                aligned: int, card: Card) -> ScanLayout:
    """The kernels' launch for a (b, t, d) scan of ``dtype`` operands
    whose pointers are all ``aligned``-byte aligned, on ``card``: the
    widest copy unit (16, 4 or 2 bytes) that the pointers and a row of d
    elements allow; long stages while each SM holds at most two groups
    (all groups in one wave), short ones beyond (measured on an H100:
    long stages are the faster at the prefill's 160 groups, short ones at
    training's 320); and as many ring slots (each a stage's steps of a
    and x; backward: a, dh and h) as T has stages, MAX_STAGES and the
    shared memory of an SM split among its groups allow — at least 2 when
    T spans two stages."""
    esize = dtype.itemsize
    unit = next(u for u in UNITS
                if u >= esize and aligned % u == 0 and (d * esize) % u == 0)
    groups = b * -(-d // CHANNELS)           # walker groups (blocks)
    per_sm = -(-groups // card.sms)
    steps_f32 = STEPS_LONG if per_sm <= 2 else STEPS_SHORT
    steps = steps_f32 * 4 // esize
    slot = (3 if backward else 2) * steps * CHANNELS * esize
    fit = (card.smem_per_sm // per_sm - card.block_reserved
           - _barrier_bytes(MAX_STAGES)) // slot
    stages = min(-(-t // steps), max(2, min(MAX_STAGES, fit)))
    return ScanLayout(unit, steps_f32, stages)


def _barrier_bytes(stages: int) -> int:
    """csrc barrier_bytes: a ring's three mbarriers a slot, 16-byte
    aligned, ahead of its slots."""
    return -(-3 * 8 * stages // 16) * 16


# (b, t, d, dtype, backward, pointer bits mod 16, device) -> ScanLayout:
# a wrapper call looks its launch up here, and reads the card's
# properties only on a miss
_LAYOUTS: dict = {}


def _layout(shape, dtype: torch.dtype, backward: bool, bits: int,
            device: torch.device) -> ScanLayout:
    key = (*shape, dtype, backward, bits & 15, device)
    lay = _LAYOUTS.get(key)
    if lay is None:
        props = torch.cuda.get_device_properties(device)
        card = Card(props.multi_processor_count,
                    props.shared_memory_per_multiprocessor,
                    props.shared_memory_per_multiprocessor
                    - props.shared_memory_per_block_optin)
        aligned = next(u for u in UNITS if bits % u == 0)
        lay = _LAYOUTS[key] = scan_layout(*shape, dtype, backward, aligned,
                                          card)
    return lay


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
    lay = _layout(x.shape, x.dtype, False,
                  a.data_ptr() | x.data_ptr() | out.data_ptr(), x.device)
    lib = _build.load("lru_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.lru_scan_launch(a.data_ptr(), x.data_ptr(), h0.data_ptr(),
                                   out.data_ptr(), b, t, d,
                                   int(x.dtype == torch.bfloat16), lay.unit,
                                   lay.steps_f32, lay.stages, stream)
    _build.check(lib, code, "lru_scan")
    lru_scan_cuda.launches += 1
    return out


lru_scan_cuda.launches = 0


def lru_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                       dh: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch: the reverse float32 loop
    g_t = dh_t + a_{t+1}·g_{t+1}; dx_t = g_t; da_t = g_t·h_{t-1}
    (h_{-1} = h0); dh0 = a_0·g_0.  ``h`` is the forward's output, in x's
    dtype.  Returns (da in a's dtype, dx in h's, dh0 float32)."""
    af, hf, dhf = a.to(torch.float32), h.to(torch.float32), dh.to(torch.float32)
    h0f = h0.to(torch.float32)
    g = torch.zeros_like(h0f)
    a_next = torch.zeros_like(h0f)
    da = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    dx = torch.empty_like(h)
    for t in range(h.shape[1] - 1, -1, -1):
        g = dhf[:, t] + a_next * g
        dx[:, t] = g.to(dx.dtype)
        da[:, t] = (g * (hf[:, t - 1] if t > 0 else h0f)).to(da.dtype)
        a_next = af[:, t]
    return da, dx, a_next * g


def lru_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                      dh: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel on ``h``'s stream.  a, h (the forward's
    output) and dh contiguous, one dtype (float32 or bfloat16); h0
    contiguous float32.  Returns (da, dx, dh0 float32).
    ``lru_scan_bwd_cuda.launches`` counts the launches."""
    check_operands(a, h, h0)
    if h.device.type != "cuda" or dh.device != h.device:
        raise ValueError("the lru_scan backward kernel needs CUDA tensors")
    if not a.dtype == h.dtype == dh.dtype or h.dtype not in _DTYPES:
        raise ValueError(f"a, h and dh must share one dtype of {_DTYPES}, "
                         f"got {a.dtype}, {h.dtype}, {dh.dtype}")
    if dh.shape != h.shape:
        raise ValueError(f"dh {tuple(dh.shape)} != h {tuple(h.shape)}")
    if h0.dtype != torch.float32:
        raise ValueError("h0 must be float32")
    if not all(t.is_contiguous() for t in (a, h, h0, dh)):
        raise ValueError("a, h, h0 and dh must be contiguous")
    b, t, d = h.shape
    da, dx = torch.empty_like(a), torch.empty_like(h)
    dh0 = torch.empty_like(h0)
    lay = _layout(h.shape, h.dtype, True,
                  a.data_ptr() | h.data_ptr() | dh.data_ptr() | da.data_ptr()
                  | dx.data_ptr(), h.device)
    lib = _build.load("lru_scan_bwd")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = lib.lru_scan_bwd_launch(
            a.data_ptr(), h.data_ptr(), h0.data_ptr(), dh.data_ptr(),
            da.data_ptr(), dx.data_ptr(), dh0.data_ptr(), b, t, d,
            int(h.dtype == torch.bfloat16), lay.unit, lay.steps_f32,
            lay.stages, stream)
    _build.check(lib, code, "lru_scan_bwd")
    lru_scan_bwd_cuda.launches += 1
    return da, dx, dh0


lru_scan_bwd_cuda.launches = 0


class LruScan(torch.autograd.Function):
    """Kernel 9 and its backward kernel on CUDA tensors, the plain loops
    on CPU tensors.  Saves a, the output h and h0."""

    @staticmethod
    def forward(ctx, a, x, h0):
        cuda = x.device.type == "cuda"
        h = (lru_scan_cuda if cuda else lru_scan_plain)(a, x, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        if h.device.type == "cuda":
            da, dx, dh0 = lru_scan_bwd_cuda(a, h, h0, dh.contiguous())
        else:
            da, dx, dh0 = lru_scan_bwd_plain(a, h, h0, dh)
        return da, dx, dh0.to(h0.dtype)

