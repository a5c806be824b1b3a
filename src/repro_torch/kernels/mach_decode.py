"""Fused MACH top-1 decode (Algorithm 2's argmax).

``mach_decode`` returns, per query, the class with the largest summed
score G[n, k] = Σ_r P[n, r, h_r(k)] and that raw sum (not Eq. 2's
estimate); ties go to the lowest class id.  On a CUDA tensor it launches
the hand-written kernel in ``csrc/mach_decode.cu`` (which replaces the
TPU kernel ``repro/kernels/mach_decode.py::mach_decode_pallas``); on a
CPU tensor it runs ``mach_decode_plain``, the same arithmetic in plain
PyTorch; on a fake tensor the kernel's stand-in (``counting``).

Two hash sources, as on the TPU: the (R, K) int32 table (any
2-universal family), or inline multiply-shift coefficients (R,) with
``shift`` (B a power of two), which the kernel hashes in-register.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, counting

MAX_R = 32               # largest R the CUDA kernels take
_MAX_QUERIES = 8         # class per thread: queries a block (kMaxQueries)
_LANE_WARPS = 16         # query per lane: warps a block (kLaneThreads / 32)
_SMEM_OPTIN = 232448     # Hopper: dynamic shared memory a block may opt into
MAPPINGS = ("class_per_thread", "query_per_lane")   # csrc Mapping


def work(n: int, r: int, b: int, num_classes: int, table: bool,
         k: int = 1) -> tuple[int, int]:
    """(flops, bytes) of a streaming decode of N queries over K classes
    (kernel 1; kernel 2 with its k): one float32 operation a gathered
    value (N·K·R); the probabilities read, in table mode the (R, K)
    table, and k (value, id) pairs a query written."""
    nbytes = 4 * n * r * b + (4 * r * num_classes if table else 0) + 8 * n * k
    return n * num_classes * r, nbytes


def fake_decode(meta_probs: torch.Tensor, shape: tuple):
    """A decode kernel's stand-in on fake tensors: (val f32, idx int32)
    of ``shape``; nothing built or launched."""
    return (meta_probs.new_empty(shape, dtype=torch.float32),
            meta_probs.new_empty(shape, dtype=torch.int32))


def table_from_inline(inline_coeffs: torch.Tensor, inline_shift: int,
                      num_classes: int) -> torch.Tensor:
    """(R, K) int32 bucket table from multiply-shift coefficients: the
    plain paths' stand-in for the kernels' in-register hashing."""
    k = torch.arange(num_classes, dtype=torch.int64,
                     device=inline_coeffs.device)
    prod = (inline_coeffs.to(torch.int64)[:, None] * k[None, :]) & 0xFFFFFFFF
    return (prod >> inline_shift).to(torch.int32)


def check_decode_operands(meta_probs: torch.Tensor,
                          table: Optional[torch.Tensor], num_classes: int,
                          inline_coeffs: Optional[torch.Tensor],
                          inline_shift: Optional[int]) -> None:
    """Validate meta (N, R, B) and the hash source, as
    ``prepare_decode_operands`` does on the TPU (table or coeffs;
    power-of-two B inline), plus the shift range the kernel can take."""
    if meta_probs.dim() != 3:
        raise ValueError(f"meta_probs must be (N, R, B), got "
                         f"{tuple(meta_probs.shape)}")
    n, r, b = meta_probs.shape
    if n < 1 or num_classes < 1:
        raise ValueError(f"need N >= 1 and num_classes >= 1, got N={n}, "
                         f"num_classes={num_classes}")
    if r > MAX_R:
        raise ValueError(f"R={r} > {MAX_R}, the largest R the decode "
                         f"kernels take")
    dev = meta_probs.device
    if table is not None:
        if tuple(table.shape) != (r, num_classes):
            raise ValueError(f"table must be (R, K)=({r}, {num_classes}), "
                             f"got {tuple(table.shape)}")
        if table.device != dev:
            raise ValueError("table and meta_probs are on different devices")
        return
    if inline_coeffs is None or inline_shift is None:
        raise ValueError("need table or (inline_coeffs, inline_shift)")
    if b & (b - 1):
        raise ValueError("inline mode requires power-of-two B")
    if tuple(inline_coeffs.shape) != (r,):
        raise ValueError(f"inline_coeffs must be (R,)=({r},), got "
                         f"{tuple(inline_coeffs.shape)}")
    if inline_coeffs.device != dev:
        raise ValueError("inline_coeffs and meta_probs are on different devices")
    if not 32 - int(math.log2(b)) <= inline_shift <= 31:
        raise ValueError(f"inline_shift={inline_shift} would give buckets "
                         f"outside [0, {b})")


def check_cuda_operands(meta_probs: torch.Tensor,
                        table: Optional[torch.Tensor], num_classes: int,
                        inline_coeffs: Optional[torch.Tensor],
                        inline_shift: Optional[int]) -> None:
    """``check_decode_operands`` plus what the kernels' pointers need:
    CUDA tensors, contiguous float32 meta, contiguous int32 table or
    int64 coefficients."""
    check_decode_operands(meta_probs, table, num_classes, inline_coeffs,
                          inline_shift)
    if meta_probs.device.type != "cuda":
        raise ValueError("the decode kernels need CUDA tensors")
    if meta_probs.dtype != torch.float32 or not meta_probs.is_contiguous():
        raise ValueError("meta_probs must be contiguous float32")
    hash_arg = table if table is not None else inline_coeffs
    want = torch.int32 if table is not None else torch.int64
    if hash_arg.dtype != want or not hash_arg.is_contiguous():
        raise ValueError(f"{'table' if table is not None else 'inline_coeffs'}"
                         f" must be contiguous {want}")


def gather_rows(meta_probs: torch.Tensor, table: torch.Tensor, r: int
                ) -> torch.Tensor:
    """(N, K) values P[n, r, h_r(k)] of repetition ``r``."""
    n = meta_probs.shape[0]
    idx = table[r].long()[None, :].expand(n, -1)
    return torch.gather(meta_probs[:, r, :], 1, idx)


def summed_scores(meta_probs: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(N, K) sums over r in order r = 0..R-1 — the kernels' order, so
    sums agree bit for bit."""
    s = gather_rows(meta_probs, table, 0)
    for r in range(1, meta_probs.shape[1]):
        s = s + gather_rows(meta_probs, table, r)
    return s


def mach_decode_plain(meta_probs: torch.Tensor,
                      table: Optional[torch.Tensor] = None, *,
                      num_classes: int,
                      inline_coeffs: Optional[torch.Tensor] = None,
                      inline_shift: Optional[int] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch top-1: materialize the (N, K) sums, first maximum."""
    if table is None:
        table = table_from_inline(inline_coeffs, inline_shift, num_classes)
    scores = summed_scores(meta_probs.to(torch.float32), table)
    idx = torch.argmax(scores, dim=-1)          # first maximum on ties
    val = torch.gather(scores, 1, idx[:, None])[:, 0]
    return val, idx.to(torch.int32)


def _num_splits(num_tiles: int, num_classes: int, sms: int,
                waves: int = 2) -> int:
    """K splits per query tile: about ``waves`` waves of blocks over
    ``sms`` SMs, and at least 1024 classes a split."""
    want = -(-waves * sms // num_tiles)
    return max(1, min(want, -(-num_classes // 1024)))


class DecodeLayout(NamedTuple):
    mapping: str          # one of MAPPINGS
    queries: int          # queries a block
    splits: int           # K splits a query tile
    smem_bytes: int       # dynamic shared memory a block


def decode_layout(n: int, r: int, b: int, num_classes: int,
                  sms: int) -> DecodeLayout:
    """How the top-1 kernel covers N queries on a card of ``sms`` SMs.

    Query per lane wherever N fills a warp of queries (N >= 32) and 32
    queries' R·B values fit in shared memory transposed, with a pad
    column and a zero row: 64 queries a block (8-byte gathers) when
    N > 32 and they fit, else 32; one block an SM, K split for one wave,
    so each SM stages its tile once.  Otherwise (the LM head's N = 1 and
    4; ImageNet-21k's and the LM head's R·B) class per thread, up to 8
    queries a block, K split for two waves.  Raises if not even one
    query's R·B values fit."""
    rb = r * b
    if n >= 32:
        for q in ((64, 32) if n > 32 else (32,)):
            vec = q // 32
            smem = 4 * max((rb + 1) * (q + vec), 2 * _LANE_WARPS * q)
            if smem <= _SMEM_OPTIN:
                return DecodeLayout("query_per_lane", q,
                                    _num_splits(-(-n // q), num_classes, sms,
                                                waves=1),
                                    smem)
    qpb = min(_MAX_QUERIES, n, _SMEM_OPTIN // (4 * rb))
    if qpb < 1:
        raise ValueError(f"R*B={rb} probabilities do not fit in shared memory")
    return DecodeLayout("class_per_thread", qpb,
                        _num_splits(-(-n // qpb), num_classes, sms),
                        4 * qpb * rb)


def mach_decode_cuda(meta_probs: torch.Tensor,
                     table: Optional[torch.Tensor] = None, *,
                     num_classes: int,
                     inline_coeffs: Optional[torch.Tensor] = None,
                     inline_shift: Optional[int] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the top-1 kernel on ``meta_probs``' stream, in the mapping
    ``decode_layout`` picks.  Inputs: meta (N, R, B) f32 contiguous; table
    (R, K) int32 contiguous, or inline_coeffs (R,) int64 contiguous.
    Returns ((N,) f32, (N,) int32).  ``mach_decode_cuda.launches`` counts
    the launches, of either mapping."""
    check_cuda_operands(meta_probs, table, num_classes, inline_coeffs,
                        inline_shift)
    n, r, b = meta_probs.shape
    dev = meta_probs.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    layout = decode_layout(n, r, b, num_classes, sms)
    part_val = torch.empty((n, layout.splits), dtype=torch.float32, device=dev)
    part_idx = torch.empty((n, layout.splits), dtype=torch.int32, device=dev)
    val = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = _build.load("mach_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mach_top1_launch(
            meta_probs.data_ptr(), n, r, b, num_classes,
            table.data_ptr() if table is not None else None,
            inline_coeffs.data_ptr() if table is None else None,
            inline_shift if table is None else 0,
            MAPPINGS.index(layout.mapping), layout.queries, layout.splits,
            part_val.data_ptr(), part_idx.data_ptr(),
            val.data_ptr(), idx.data_ptr(), stream)
    _build.check(lib, code, "mach_top1")
    mach_decode_cuda.launches += 1
    return val, idx


mach_decode_cuda.launches = 0


def mach_decode(meta_probs: torch.Tensor,
                table: Optional[torch.Tensor] = None, *,
                num_classes: int,
                inline_coeffs: Optional[torch.Tensor] = None,
                inline_shift: Optional[int] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused top-1 decode.  meta_probs (N, R, B) -> (val (N,), idx (N,)).

    The kernel on a CUDA tensor, the plain version on a CPU tensor, the
    stand-in on a fake tensor.
    """
    check_decode_operands(meta_probs, table, num_classes, inline_coeffs,
                          inline_shift)
    n, r, b = meta_probs.shape
    with counting.launch("mach_decode", work(n, r, b, num_classes,
                                             table is not None)):
        if counting.is_fake(meta_probs):
            return fake_decode(meta_probs, (n,))
        kind = meta_probs.device.type
        if kind == "cuda":
            return mach_decode_cuda(meta_probs, table,
                                    num_classes=num_classes,
                                    inline_coeffs=inline_coeffs,
                                    inline_shift=inline_shift)
        if kind == "cpu":
            return mach_decode_plain(meta_probs, table,
                                     num_classes=num_classes,
                                     inline_coeffs=inline_coeffs,
                                     inline_shift=inline_shift)
    raise ValueError(f"no decode path for device {meta_probs.device}")
