"""Public decode ops.

Dispatch is by tensor device: CUDA tensors go to the hand-written
kernels, CPU tensors to their plain PyTorch versions (large CPU top-k
problems to a blocked streaming version with the same results).  There
are no knobs that pick a path.  Every public op names its oracle in
``kernels/ref.py`` in ``ORACLES``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.mach_decode import (check_decode_operands,
                                             mach_decode)
from repro_torch.kernels.mach_decode import table_from_inline as _table_from_inline
from repro_torch.kernels.mach_topk import (check_topk_args, estimator_scores,
                                           mach_topk as _mach_topk_kernel,
                                           unbiased_affine)

# CPU top-k problems with N·K·R above this stream K in blocks
_BLOCKED_MIN = 2 ** 24


def mach_top1(meta_probs: torch.Tensor,
              table: Optional[torch.Tensor] = None, *,
              num_classes: int,
              inline_coeffs: Optional[torch.Tensor] = None,
              inline_shift: Optional[int] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 class under the summed-score rule (≡ unbiased-estimator argmax).

    meta_probs: (..., R, B) — leading dims flattened internally.
    Returns (values (...,) f32 raw sums, indices (...,) int32).
    """
    lead = meta_probs.shape[:-2]
    r, b = meta_probs.shape[-2:]
    flat = meta_probs.reshape((-1, r, b)).to(torch.float32).contiguous()
    val, idx = mach_decode(flat, table, num_classes=num_classes,
                           inline_coeffs=inline_coeffs,
                           inline_shift=inline_shift)
    return val.reshape(lead), idx.reshape(lead)


def _blocked_topk_fallback(flat: torch.Tensor, table: torch.Tensor, k: int,
                           estimator: str, block_k: int = 8192
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming CPU top-k: score K in blocks of ``block_k`` classes and
    merge each block's top-k into a running top-k with a stable,
    running-set-first sort (ties keep the lowest class id, as the
    kernel's key order does).  Memory O(N·(R·block_k + k)).  Values on
    the estimator's scale."""
    n, r, b = flat.shape
    num_classes = table.shape[1]
    run_val = torch.full((n, 0), -torch.inf, dtype=torch.float32)
    run_idx = torch.zeros((n, 0), dtype=torch.int32)
    for base in range(0, num_classes, block_k):
        scores = estimator_scores(flat, table[:, base:base + block_k],
                                  estimator)
        bv, bi = ref.topk_lowest_id(scores, k)
        cat_val = torch.cat([run_val, bv], dim=-1)
        cat_idx = torch.cat([run_idx, bi + base], dim=-1)
        run_val, order = ref.topk_lowest_id(cat_val, k)
        run_idx = torch.gather(cat_idx, 1, order.long())
    if estimator == "unbiased":
        run_val = unbiased_affine(run_val, r, b)
    return run_val, run_idx


def mach_topk(meta_probs: torch.Tensor,
              table: Optional[torch.Tensor] = None, *,
              num_classes: int,
              k: int,
              estimator: str = "unbiased",
              inline_coeffs: Optional[torch.Tensor] = None,
              inline_shift: Optional[int] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k classes under any paper estimator (unbiased | min | median).

    meta_probs: (..., R, B) — leading dims flattened internally.
    Returns (values (..., k) f32, indices (..., k) int32) on the
    estimator's scale, equal to ``estimate_class_probs`` + a top-k with
    ties to the lowest class id.  The CUDA kernel streams K and never
    materializes the (batch, K) scores; on the CPU, small problems
    materialize them and large ones stream K in blocks.
    """
    check_topk_args(num_classes, k, estimator)
    lead = meta_probs.shape[:-2]
    r, b = meta_probs.shape[-2:]
    flat = meta_probs.reshape((-1, r, b)).to(torch.float32).contiguous()
    if flat.device.type == "cpu" and flat.shape[0] * num_classes * r > _BLOCKED_MIN:
        check_decode_operands(flat, table, num_classes, inline_coeffs,
                              inline_shift)
        if table is None:
            table = _table_from_inline(inline_coeffs, inline_shift,
                                       num_classes)
        val, idx = _blocked_topk_fallback(flat, table, k, estimator)
    else:
        val, idx = _mach_topk_kernel(flat, table, num_classes=num_classes,
                                     k=k, estimator=estimator,
                                     inline_coeffs=inline_coeffs,
                                     inline_shift=inline_shift)
    return val.reshape(lead + (k,)), idx.reshape(lead + (k,))


def mach_scores(meta_probs: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Full (…, K) score matrix — reference path (never on the decode
    path; the yardstick materializes it)."""
    lead = meta_probs.shape[:-2]
    r, b = meta_probs.shape[-2:]
    g = ref.mach_scores_ref(meta_probs.reshape((-1, r, b)), table)
    return g.reshape(lead + (table.shape[1],))


# public op -> its oracle in kernels/ref.py
ORACLES: dict = {
    "mach_top1": "mach_decode_ref",
    "mach_topk": "mach_topk_ref",
    "mach_scores": "mach_scores_ref",
}
