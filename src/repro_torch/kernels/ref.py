"""Pure-PyTorch oracles for the decode ops (the paper-faithful
computations, which materialize what the kernels never do).

``mach_scores_ref`` materializes the full N×K global score matrix G of
Algorithm 2 with a one-hot contraction; ``mach_topk_ref`` ranks the
materialized estimator scores.  Tie order everywhere is
``jax.lax.top_k``'s: equal values resolve to the lowest class id (a
stable descending sort — ``torch.topk`` promises no tie order).
"""

from __future__ import annotations

import torch


def topk_lowest_id(scores: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties to the lowest index."""
    val, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k].to(torch.int32)


def mach_scores_ref(meta_probs: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Global score matrix G[n, k] = sum_r P[n, r, h_r(k)].

    meta_probs: (N, R, B); table: (R, K) -> G: (N, K) float32, through
    the one-hot contraction S_r[b,k] = 1[h_r(k) = b]; G = sum_r P_r @ S_r.
    """
    b = meta_probs.shape[-1]
    onehot = torch.nn.functional.one_hot(table.long(), b).to(torch.float32)
    return torch.einsum("nrb,rkb->nk", meta_probs.to(torch.float32), onehot)


def mach_decode_ref(meta_probs: torch.Tensor, table: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 (value, index) of the summed scores — argmax of the
    unbiased estimator (its affine map is monotone in the sum).

    Returns (values (N,) float32, indices (N,) int32).
    """
    g = mach_scores_ref(meta_probs, table)
    idx = torch.argmax(g, dim=-1)
    val = torch.gather(g, -1, idx[:, None])[:, 0]
    return val.to(torch.float32), idx.to(torch.int32)


def mach_estimator_scores_ref(meta_probs: torch.Tensor, table: torch.Tensor,
                              estimator: str = "unbiased") -> torch.Tensor:
    """Estimator score matrix (N, K) — Eq. 2 / 7 / 8 via the explicit
    (R, N, K) gather of ``core.estimators``.  meta_probs: (N, R, B)."""
    from repro_torch.core.estimators import estimate_class_probs
    return estimate_class_probs(
        meta_probs.to(torch.float32).movedim(1, 0), table, estimator)


def mach_topk_ref(meta_probs: torch.Tensor, table: torch.Tensor, k: int,
                  estimator: str = "unbiased"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k (values, class ids) of the estimator scores — the oracle
    for the streaming top-k op.  Returns ((N, k) f32, (N, k) int32)."""
    scores = mach_estimator_scores_ref(meta_probs, table, estimator)
    return topk_lowest_id(scores, k)


def csr_densify_ref(indptr: torch.Tensor, indices: torch.Tensor,
                    values: torch.Tensor, num_features: int) -> torch.Tensor:
    """CSR (indptr (N+1,), indices (nnz,), values (nnz,)) -> dense
    (N, d).  Duplicate indices within a row scatter-ADD."""
    n = indptr.shape[0] - 1
    out = torch.zeros((n, num_features), dtype=values.dtype,
                      device=values.device)
    if indices.shape[0] == 0:
        return out
    rows = torch.repeat_interleave(
        torch.arange(n, device=indptr.device), torch.diff(indptr.long()))
    return out.index_put_((rows, indices.long()), values, accumulate=True)
