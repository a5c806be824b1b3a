"""Fused streaming top-k MACH decode (the serving hot path).

``mach_topk`` returns each query's top-k classes under the unbiased
(Eq. 2), min (Eq. 7) or median (Eq. 8) estimator, ties to the lowest
class id, without the (N, K) score matrix.  On a CUDA tensor it launches
the hand-written kernel in ``csrc/mach_topk.cu`` (which replaces the TPU
kernel ``repro/kernels/mach_topk.py::mach_topk_pallas``); on a CPU
tensor it runs ``mach_topk_plain``, the same arithmetic in plain PyTorch
over the materialized scores; on a fake tensor the kernel's stand-in
(``counting``).

Unbiased selection runs on the raw sum; Eq. 2's monotone affine map
``(b/(b-1))*(val/r - 1/b)`` is applied to the k selected sums, exactly
as the TPU kernel did.  Hash sources as in ``mach_decode``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.estimators import ESTIMATORS, median_over_first
from repro_torch.kernels import _build, counting, mach_decode
from repro_torch.kernels.mach_decode import (MAPPINGS, _SMEM_OPTIN,
                                             _num_splits, check_cuda_operands,
                                             check_decode_operands,
                                             fake_decode, gather_rows,
                                             summed_scores, table_from_inline)
from repro_torch.kernels.ref import topk_lowest_id

MAX_K = 128              # largest k the CUDA kernel takes (csrc kMaxK)
_MAX_QUERIES = 4         # class per thread: queries a block (kMaxQueriesTopk)
_POOL = 512              # class per thread: a query's candidate pool
_LANE_WARPS = 16         # query per lane: warps a block (kTopkLaneWarps)
_LANE_LISTS = (1, 16, 32)   # query per lane: keys a lane keeps per query
_MERGE_MAX = 4096        # largest split-merge width (num_splits * kcap)


def work(n: int, r: int, b: int, num_classes: int, k: int,
         table: bool) -> tuple[int, int]:
    """(flops, bytes) of kernel 2: kernel 1's arithmetic
    (``mach_decode.work``) with k (value, id) pairs a query written."""
    return mach_decode.work(n, r, b, num_classes, table, k)


def check_topk_args(num_classes: int, k: int, estimator: str) -> None:
    if estimator not in ESTIMATORS:
        raise ValueError(f"estimator must be one of {ESTIMATORS}, "
                         f"got {estimator!r}")
    if not 1 <= k <= num_classes:
        raise ValueError(f"need 1 <= k <= num_classes, got k={k}, "
                         f"num_classes={num_classes}")
    if k > MAX_K:
        raise ValueError(f"k={k} > {MAX_K}, the largest k the top-k "
                         f"kernel takes")


def unbiased_affine(val: torch.Tensor, r: int, b: int) -> torch.Tensor:
    """Eq. 2 on selected raw sums (monotone, so the order is kept)."""
    return (b / (b - 1.0)) * (val / r - 1.0 / b)


def estimator_scores(meta_probs: torch.Tensor, table: torch.Tensor,
                     estimator: str) -> torch.Tensor:
    """(N, K') selection scores for the classes of ``table`` (R, K'):
    the raw sum (unbiased), the min or the median over r — the kernel's
    arithmetic, in the kernel's order."""
    if estimator == "unbiased":
        return summed_scores(meta_probs, table)
    if estimator == "min":
        s = gather_rows(meta_probs, table, 0)
        for r in range(1, meta_probs.shape[1]):
            s = torch.minimum(s, gather_rows(meta_probs, table, r))
        return s
    g = torch.stack([gather_rows(meta_probs, table, r)
                     for r in range(meta_probs.shape[1])])
    return median_over_first(g)


def mach_topk_plain(meta_probs: torch.Tensor,
                    table: Optional[torch.Tensor] = None, *,
                    num_classes: int, k: int, estimator: str = "unbiased",
                    inline_coeffs: Optional[torch.Tensor] = None,
                    inline_shift: Optional[int] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch top-k over the materialized (N, K) selection
    scores; raw sums for unbiased (the caller maps them)."""
    if table is None:
        table = table_from_inline(inline_coeffs, inline_shift, num_classes)
    scores = estimator_scores(meta_probs.to(torch.float32), table, estimator)
    return topk_lowest_id(scores, k)


def _next_pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


class TopkLayout(NamedTuple):
    mapping: str          # one of MAPPINGS (csrc Mapping)
    queries: int          # queries a block
    splits: int           # K splits a query tile
    list_len: int         # query per lane: keys a lane keeps per query;
                          # class per thread: 0 (a shared pool of _POOL)
    smem_bytes: int       # dynamic shared memory a block


def topk_layout(n: int, r: int, b: int, num_classes: int, k: int,
                sms: int, estimator: str = "unbiased",
                inline: bool = False) -> TopkLayout:
    """How the streaming top-k kernel covers N queries on a card of
    ``sms`` SMs, for ``estimator`` with the hash read from the (R, K)
    table or computed ``inline``.

    Query per lane (kernel 1's mapping, ``mach_decode.decode_layout``)
    where N fills a warp of queries (N >= 32), next_pow2(k) <= 32 and the
    tile fits in shared memory: 32 queries' R·B values transposed with a
    pad column and a pad row, or, once the walk is done, the block's 16
    warps' lists of 8-byte keys.  Each lane keeps 1, 16 or 32 keys a
    query (the shortest of those that holds next_pow2(k)); 64 queries a
    block where N > 32, the list is at most 16 keys and they fit; K split
    for one wave.  Otherwise (the LM head's N = 1 and 4, ImageNet-21k's
    R·B, k > 32, and the median in table mode, where the lane kernel runs
    its sorting network on nearly every step and the class-per-thread
    kernel was faster on an H100: 2.20 against 2.58 ms at ODP, N = 256,
    k = 10) class per thread: up to 4 queries a block with a pool of 512
    keys each, K split for two waves.  Both keep the splits' keys of a
    query within the merge kernel's 4,096.  Raises if not even one
    query's R·B values fit."""
    rb = r * b
    kcap = _next_pow2(k)
    lane_ok = inline or estimator != "median"
    if lane_ok and n >= 32 and kcap <= _LANE_LISTS[-1]:
        list_len = next(x for x in _LANE_LISTS if x >= kcap)
        for q in ((64, 32) if n > 32 and list_len <= 16 else (32,)):
            vec = q // 32
            smem = max(4 * (rb + 1) * (q + vec), 8 * q * _LANE_WARPS * list_len)
            if smem <= _SMEM_OPTIN:
                splits = min(_num_splits(-(-n // q), num_classes, sms,
                                         waves=1), _MERGE_MAX // kcap)
                return TopkLayout("query_per_lane", q, splits, list_len, smem)
    per_query = 4 * rb + 8 * _POOL
    qpb = min(_MAX_QUERIES, n, _SMEM_OPTIN // per_query)
    if qpb < 1:
        raise ValueError(f"R*B={rb} probabilities do not fit in shared memory")
    splits = min(_num_splits(-(-n // qpb), num_classes, sms),
                 _MERGE_MAX // kcap)
    return TopkLayout("class_per_thread", qpb, splits, 0, qpb * per_query)


def mach_topk_cuda(meta_probs: torch.Tensor,
                   table: Optional[torch.Tensor] = None, *,
                   num_classes: int, k: int, estimator: str = "unbiased",
                   inline_coeffs: Optional[torch.Tensor] = None,
                   inline_shift: Optional[int] = None,
                   network_runs: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the streaming top-k kernel on ``meta_probs``' stream, in the
    mapping ``topk_layout`` picks.  Inputs as ``mach_decode_cuda``.
    Returns ((N, k) f32 selection scores — raw sums for unbiased — and
    (N, k) int32 class ids).  ``network_runs``, a (1,) int64 CUDA tensor,
    if given, gains the query-per-lane median's count of sorting-network
    runs (a diagnostic).  ``mach_topk_cuda.launches`` counts the
    launches, of either mapping."""
    check_cuda_operands(meta_probs, table, num_classes, inline_coeffs,
                        inline_shift)
    check_topk_args(num_classes, k, estimator)
    n, r, b = meta_probs.shape
    dev = meta_probs.device
    if network_runs is not None and (network_runs.dtype != torch.int64 or
                                     network_runs.device != dev or
                                     network_runs.numel() != 1):
        raise ValueError("network_runs must be a (1,) int64 tensor on "
                         f"{dev}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    layout = topk_layout(n, r, b, num_classes, k, sms, estimator,
                         inline=table is None)
    kcap = _next_pow2(k)
    width = _next_pow2(layout.splits * kcap)
    part_val = torch.empty((n, layout.splits, kcap), dtype=torch.float32,
                           device=dev)
    part_idx = torch.empty((n, layout.splits, kcap), dtype=torch.int32,
                           device=dev)
    val = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    lib = _build.load("mach_topk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mach_topk_launch(
            meta_probs.data_ptr(), n, r, b, num_classes,
            table.data_ptr() if table is not None else None,
            inline_coeffs.data_ptr() if table is None else None,
            inline_shift if table is None else 0,
            ESTIMATORS.index(estimator), MAPPINGS.index(layout.mapping),
            layout.queries, layout.list_len, k, kcap, _POOL, layout.splits,
            width, part_val.data_ptr(), part_idx.data_ptr(), val.data_ptr(),
            idx.data_ptr(),
            network_runs.data_ptr() if network_runs is not None else None,
            stream)
    _build.check(lib, code, "mach_topk")
    mach_topk_cuda.launches += 1
    return val, idx


mach_topk_cuda.launches = 0


def _fake_topk(meta_probs, table=None, *, k, **_):
    """Kernel 2's stand-in on fake tensors: (val, idx) (N, k)."""
    return fake_decode(meta_probs, (meta_probs.shape[0], k))


def mach_topk(meta_probs: torch.Tensor,
              table: Optional[torch.Tensor] = None, *,
              num_classes: int, k: int, estimator: str = "unbiased",
              inline_coeffs: Optional[torch.Tensor] = None,
              inline_shift: Optional[int] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused streaming top-k.  meta_probs (N, R, B) -> (val, idx) (N, k),
    values on the estimator's scale.  The kernel on a CUDA tensor, the
    plain version on a CPU tensor, the stand-in on a fake tensor."""
    check_decode_operands(meta_probs, table, num_classes, inline_coeffs,
                          inline_shift)
    check_topk_args(num_classes, k, estimator)
    n, r, b = meta_probs.shape
    kind = meta_probs.device.type
    if counting.is_fake(meta_probs):
        fn = _fake_topk
    elif kind == "cuda":
        fn = mach_topk_cuda
    elif kind == "cpu":
        fn = mach_topk_plain
    else:
        raise ValueError(f"no decode path for device {meta_probs.device}")
    with counting.launch("mach_topk", work(n, r, b, num_classes, k,
                                           table is not None)):
        val, idx = fn(meta_probs, table, num_classes=num_classes, k=k,
                      estimator=estimator, inline_coeffs=inline_coeffs,
                      inline_shift=inline_shift)
    if estimator == "unbiased":
        val = unbiased_affine(val, r, b)
    return val, idx
