"""MACH probability estimators (paper Eq. 2, 7, 8).

Given the R meta-class probability vectors ``meta_probs`` with shape
(R, ..., B) and the hash table (R, K), each estimator recovers per-class
probability estimates of shape (..., K):

  unbiased  p̂_i = B/(B−1) · [ mean_j P^j_{h_j(i)} − 1/B ]      (Eq. 2)
  min       p̂_i = min_j    P^j_{h_j(i)}                        (Eq. 7)
  median    p̂_i = median_j P^j_{h_j(i)}                        (Eq. 8)

The median is ``jnp.median``'s: at even R the mean of the two middle
values, ``(lo + hi) * 0.5`` (``torch.median`` returns the lower one).

The gathered tensor (R, ..., K) is materialized here — this module is
the reference path; ``predict_topk`` routes to the streaming decode
kernel or the candidate-filtered one, which never materialize it.
"""

from __future__ import annotations

from typing import Optional

import torch

ESTIMATORS = ("unbiased", "min", "median")


def gather_class_probs(meta_probs: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """(R, ..., B), (R, K) -> (R, ..., K): P^j_{h_j(i)} for every class i."""
    if meta_probs.shape[0] != table.shape[0]:
        raise ValueError(
            f"R mismatch: meta_probs {tuple(meta_probs.shape)} vs table "
            f"{tuple(table.shape)}")
    idx = table.long().reshape(
        table.shape[:1] + (1,) * (meta_probs.dim() - 2) + table.shape[1:])
    idx = idx.expand(meta_probs.shape[:-1] + table.shape[1:])
    return torch.gather(meta_probs, -1, idx)


def median_over_first(g: torch.Tensor) -> torch.Tensor:
    """``jnp.median(g, axis=0)``: midpoint of the two middle order
    statistics (equal at odd R)."""
    r = g.shape[0]
    s = torch.sort(g, dim=0).values
    return (s[(r - 1) // 2] + s[r // 2]) * 0.5


def unbiased_estimator(meta_probs: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 2 — unbiased estimate of Pr(y=i|x); shape (..., K)."""
    b = meta_probs.shape[-1]
    g = gather_class_probs(meta_probs, table)
    return (b / (b - 1.0)) * (g.mean(dim=0) - 1.0 / b)


def min_estimator(meta_probs: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 7 — count-min sketch estimate; shape (..., K)."""
    return gather_class_probs(meta_probs, table).amin(dim=0)


def median_estimator(meta_probs: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 8 — count-median sketch estimate; shape (..., K)."""
    return median_over_first(gather_class_probs(meta_probs, table))


_FNS = {
    "unbiased": unbiased_estimator,
    "min": min_estimator,
    "median": median_estimator,
}


def estimate_class_probs(meta_probs: torch.Tensor, table: torch.Tensor,
                         estimator: str = "unbiased") -> torch.Tensor:
    """Dispatch over the three paper estimators."""
    try:
        fn = _FNS[estimator]
    except KeyError:
        raise ValueError(
            f"estimator must be one of {ESTIMATORS}, got {estimator!r}") from None
    return fn(meta_probs, table)


def predict_classes(meta_probs: torch.Tensor, table: torch.Tensor,
                    estimator: str = "unbiased") -> torch.Tensor:
    """argmax_i p̂_i (first maximum) — the paper's rule; shape (...,)."""
    return torch.argmax(estimate_class_probs(meta_probs, table, estimator),
                        dim=-1)


def predict_topk(meta_probs: torch.Tensor, table: torch.Tensor, k: int,
                 estimator: str = "unbiased", *,
                 candidate_mode=None,
                 inverted: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k (p̂ values, class ids) under the chosen estimator.

    meta_probs: (R, ..., B) — same layout as the other estimators here.
    Routes to ``ops.mach_topk``: the streaming CUDA kernel for CUDA
    tensors (never materializes the (..., K) scores), the plain version
    on the CPU.  Returns ((..., k) f32, (..., k) int32); ties go to the
    lowest class id.

    ``candidate_mode``: None | "exact" stream all K classes; an (m, t)
    tuple routes through the count-min candidate filter (requires
    ``inverted``, the (R·B, L) table from ``hashing.inverted_table``) —
    cost independent of K, top-k approximate (see ``ops.mach_topk``).
    """
    from repro_torch.kernels import ops  # deferred: kernels sit above core
    return ops.mach_topk(meta_probs.movedim(0, -2), table,
                         num_classes=table.shape[-1], k=k,
                         estimator=estimator, candidate_mode=candidate_mode,
                         inverted=inverted)
