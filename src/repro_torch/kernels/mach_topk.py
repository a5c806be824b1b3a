"""Fused streaming top-k MACH decode (the serving hot path).

``mach_topk`` returns each query's top-k classes under the unbiased
(Eq. 2), min (Eq. 7) or median (Eq. 8) estimator, ties to the lowest
class id, without the (N, K) score matrix.  On a CUDA tensor it launches
the hand-written kernel in ``csrc/mach_topk.cu`` (which replaces the TPU
kernel ``repro/kernels/mach_topk.py::mach_topk_pallas``); on a CPU
tensor it runs ``mach_topk_plain``, the same arithmetic in plain PyTorch
over the materialized scores.

Unbiased selection runs on the raw sum; Eq. 2's monotone affine map
``(b/(b-1))*(val/r - 1/b)`` is applied to the k selected sums, exactly
as the TPU kernel did.  Hash sources as in ``mach_decode``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.estimators import ESTIMATORS, median_over_first
from repro_torch.kernels import _build
from repro_torch.kernels.mach_decode import (_SMEM_OPTIN, _num_splits,
                                             check_cuda_operands,
                                             check_decode_operands,
                                             gather_rows, summed_scores,
                                             table_from_inline)
from repro_torch.kernels.ref import topk_lowest_id

MAX_K = 128              # largest k the CUDA kernel takes (csrc kMaxK)
_MAX_QUERIES = 4         # queries per block (csrc kMaxQueriesTopk)
_POOL = 512              # per-query candidate pool (power of two)
_MERGE_MAX = 4096        # largest split-merge width (num_splits * kcap)


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


def mach_topk_cuda(meta_probs: torch.Tensor,
                   table: Optional[torch.Tensor] = None, *,
                   num_classes: int, k: int, estimator: str = "unbiased",
                   inline_coeffs: Optional[torch.Tensor] = None,
                   inline_shift: Optional[int] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the streaming top-k kernel on ``meta_probs``' stream.
    Inputs as ``mach_decode_cuda``.  Returns ((N, k) f32 selection
    scores — raw sums for unbiased — and (N, k) int32 class ids).
    ``mach_topk_cuda.launches`` counts the launches."""
    check_cuda_operands(meta_probs, table, num_classes, inline_coeffs,
                        inline_shift)
    check_topk_args(num_classes, k, estimator)
    n, r, b = meta_probs.shape
    kcap = _next_pow2(k)
    per_query = 4 * r * b + 8 * _POOL
    qpb = min(_MAX_QUERIES, n, _SMEM_OPTIN // per_query)
    if qpb < 1:
        raise ValueError(f"R*B={r * b} probabilities do not fit in shared memory")
    dev = meta_probs.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = min(_num_splits(-(-n // qpb), num_classes, sms),
                 _MERGE_MAX // kcap)
    width = _next_pow2(splits * kcap)
    part_val = torch.empty((n, splits, kcap), dtype=torch.float32, device=dev)
    part_idx = torch.empty((n, splits, kcap), dtype=torch.int32, device=dev)
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
            ESTIMATORS.index(estimator), qpb, k, kcap, _POOL, splits, width,
            part_val.data_ptr(), part_idx.data_ptr(), val.data_ptr(),
            idx.data_ptr(), stream)
    _build.check(lib, code, "mach_topk")
    mach_topk_cuda.launches += 1
    return val, idx


mach_topk_cuda.launches = 0


def mach_topk(meta_probs: torch.Tensor,
              table: Optional[torch.Tensor] = None, *,
              num_classes: int, k: int, estimator: str = "unbiased",
              inline_coeffs: Optional[torch.Tensor] = None,
              inline_shift: Optional[int] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused streaming top-k.  meta_probs (N, R, B) -> (val, idx) (N, k),
    values on the estimator's scale.  The kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    check_decode_operands(meta_probs, table, num_classes, inline_coeffs,
                          inline_shift)
    check_topk_args(num_classes, k, estimator)
    kind = meta_probs.device.type
    if kind == "cuda":
        fn = mach_topk_cuda
    elif kind == "cpu":
        fn = mach_topk_plain
    else:
        raise ValueError(f"no decode path for device {meta_probs.device}")
    val, idx = fn(meta_probs, table, num_classes=num_classes, k=k,
                  estimator=estimator, inline_coeffs=inline_coeffs,
                  inline_shift=inline_shift)
    if estimator == "unbiased":
        _, r, b = meta_probs.shape
        val = unbiased_affine(val, r, b)
    return val, idx
