"""Pure-PyTorch oracles for the decode, training-loss and LM-substrate
ops (the paper-faithful computations, which materialize what the kernels
never do: the (N, K) scores, the (N, R·B) logits, the dense (N, d)
batch, the (T, S) attention scores).

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


def mach_candidate_topk_ref(meta_probs: torch.Tensor, table: torch.Tensor,
                            k: int, m: int, t: int = 1,
                            estimator: str = "unbiased"
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force candidate-filtered top-k — the oracle for
    ``mach_topk_candidates``.

    A class is a candidate iff its bucket value is >= the m-th largest
    bucket value (its bucket is in the top-m) in at least t of the R
    repetitions; candidates rank by the estimator score.  Filtered slots
    are (-inf, -1); a row with no count>=t candidate backfills slot 0
    with its best count>=1 candidate.  Materializes the (N, K)
    membership and scores by design — the decode paths never do.
    """
    meta = meta_probs.to(torch.float32)
    scores = mach_estimator_scores_ref(meta, table, estimator)      # (N, K)
    tau = torch.topk(meta, m, dim=-1).values.amin(-1)               # (N, R)
    n, r, _ = meta.shape
    g = torch.gather(meta, 2, table.long()[None].expand(n, r, -1))  # (N, R, K)
    count = (g >= tau[:, :, None]).sum(1)                           # (N, K)
    val, idx = topk_lowest_id(torch.where(count >= t, scores, -torch.inf), k)
    if t > 1:
        s1 = torch.where(count >= 1, scores, -torch.inf)
        i1 = torch.argmax(s1, dim=-1)
        v1 = torch.gather(s1, 1, i1[:, None])[:, 0]
        fill = (val[:, 0] == -torch.inf) & (v1 > -torch.inf)
        val[:, 0] = torch.where(fill, v1, val[:, 0])
        idx[:, 0] = torch.where(fill, i1.to(torch.int32), idx[:, 0])
    idx = torch.where(val == -torch.inf, -1, idx)
    return val, idx


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


# ---------------------------------------------------------------------------
# MACH fused cross-entropy (the training loss, Algorithm 1).
# ---------------------------------------------------------------------------

def mach_xent_ref(logits: torch.Tensor, hashed_labels: torch.Tensor
                  ) -> torch.Tensor:
    """Per-example summed R-head cross-entropy.

    logits (N, R, B); hashed_labels (N, R) int bucket ids -> (N,) f32,
    loss_n = sum_r [lse(logits[n, r]) - logits[n, r, y_nr]].
    """
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, hashed_labels.long()[..., None])[..., 0]
    return (lse - picked).sum(dim=-1)


def mach_xent_grad_ref(logits: torch.Tensor, hashed_labels: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """d loss / d logits = g · (softmax(logits) − onehot(labels)) in the
    logits' dtype; (N, R, B)."""
    lg = logits.to(torch.float32)
    oh = torch.nn.functional.one_hot(hashed_labels.long(), lg.shape[-1])
    grad = g.to(torch.float32)[:, None, None] * (torch.softmax(lg, dim=-1) - oh)
    return grad.to(logits.dtype)


def mach_fused_xent_ref(h2: torch.Tensor, w: torch.Tensor,
                        hashed_labels: torch.Tensor, num_buckets: int,
                        bias: torch.Tensor = None) -> torch.Tensor:
    """Logit-materializing oracle for the fused projection + CE: h2
    (N, d), w (d, R·B), hashed_labels (N, R), optional bias (R·B,)
    broadcast-added to every logits row -> (N,) f32.  Forms the full
    (N, R·B) f32 logits the kernels never write."""
    n, r = hashed_labels.shape
    logits = h2.to(torch.float32) @ w.to(torch.float32)
    if bias is not None:
        logits = logits + bias.to(torch.float32)[None, :]
    return mach_xent_ref(logits.reshape(n, r, num_buckets), hashed_labels)


def mach_fused_xent_csr_ref(indptr: torch.Tensor, indices: torch.Tensor,
                            values: torch.Tensor, w: torch.Tensor,
                            hashed_labels: torch.Tensor, num_buckets: int,
                            bias: torch.Tensor = None) -> torch.Tensor:
    """Densifying oracle for the sparse fused projection + CE: the CSR
    batch is scattered into a dense f32 (N, d) activation (duplicate ids
    sum), then reduced by ``mach_fused_xent_ref``."""
    x = csr_densify_ref(indptr, indices, values.to(torch.float32), w.shape[0])
    return mach_fused_xent_ref(x, w, hashed_labels, num_buckets, bias=bias)


# ---------------------------------------------------------------------------
# Dynamic bucket selection (the training-time cut of the C axis).
# ---------------------------------------------------------------------------

def proxy_logits(xbar: torch.Tensor, w: torch.Tensor, num_buckets: int,
                 bias: torch.Tensor = None) -> torch.Tensor:
    """The logits of one activation ``xbar`` (d,) in float32, (R, B)."""
    scores = xbar @ w.to(torch.float32)
    if bias is not None:
        scores = scores + bias.to(torch.float32)
    return scores.reshape(w.shape[1] // num_buckets, num_buckets)


def mach_bucket_proxy_ref(h2: torch.Tensor, w: torch.Tensor, num_buckets: int,
                          bias: torch.Tensor = None) -> torch.Tensor:
    """Per-repetition bucket proxy scores of a dense batch: the logits of
    the batch-mean activation, ``mean_n(h) @ W + bias`` in float32,
    reshaped (R, B).  One d·R·B matvec, 1/N of the full projection."""
    return proxy_logits(h2.to(torch.float32).mean(dim=0), w, num_buckets,
                        bias)


def mach_bucket_proxy_csr_ref(indptr: torch.Tensor, indices: torch.Tensor,
                              values: torch.Tensor, w: torch.Tensor,
                              num_buckets: int,
                              bias: torch.Tensor = None) -> torch.Tensor:
    """CSR counterpart of ``mach_bucket_proxy_ref``: the batch-mean
    activation is a scatter-add of values / N, never a densified batch."""
    n = indptr.shape[0] - 1
    xbar = torch.zeros((w.shape[0],), dtype=torch.float32, device=w.device)
    xbar = xbar.index_add(0, indices.long(), values.to(torch.float32))
    return proxy_logits(xbar / max(n, 1), w, num_buckets, bias)


def mach_select_buckets_ref(proxy_scores: torch.Tensor,
                            hashed_labels: torch.Tensor,
                            num_buckets: int, c_sel: int) -> torch.Tensor:
    """Top-``c_sel`` bucket columns per repetition by proxy score, every
    bucket a batch label hits force-included: proxy (R, B), labels (N, R)
    -> (R, c_sel) int32, ascending per row.  The boost ``span = max − min
    + 1`` (float32) lifts every label bucket above every other while
    keeping proxy order within each group; ties go to the lower bucket id,
    as ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    proxy = proxy_scores.to(torch.float32)
    present = bucket_presence(hashed_labels, *proxy.shape)
    span = proxy.max() - proxy.min() + 1.0
    return select_boosted(proxy, present, span, c_sel)


def bucket_presence(hashed_labels: torch.Tensor, r: int, b: int
                    ) -> torch.Tensor:
    """(R, B) float32: 1 at every bucket a label of (N, R) hits."""
    rows = torch.arange(r, device=hashed_labels.device).expand(
        hashed_labels.shape)
    present = torch.zeros((r, b), dtype=torch.float32,
                          device=hashed_labels.device)
    present[rows, hashed_labels.long()] = 1.0
    return present


def select_boosted(proxy: torch.Tensor, present: torch.Tensor,
                   span: torch.Tensor, c_sel: int) -> torch.Tensor:
    """Each row's top ``c_sel`` of ``proxy + present * span`` (float32),
    ties to the lower id, ascending -> (R, c_sel) int32."""
    if not 1 <= c_sel <= proxy.shape[1]:
        raise ValueError(f"need 1 <= c_sel <= num_buckets, got "
                         f"c_sel={c_sel}, num_buckets={proxy.shape[1]}")
    _, idx = topk_lowest_id(proxy + present * span, c_sel)
    return torch.sort(idx, dim=-1).values


def label_positions(selected: torch.Tensor, hashed_labels: torch.Tensor
                    ) -> torch.Tensor:
    """Each label's position inside its repetition's selection: selected
    (R, c_sel), labels (N, R) -> (N, R) int32, the first match.  A label
    outside the selection maps to position 0 (the JAX package's argmax
    over an all-false row)."""
    hit = selected[None, :, :] == hashed_labels[:, :, None].to(selected.dtype)
    return torch.argmax(hit.to(torch.uint8), dim=-1).to(torch.int32)


def _selected_logits(h2, w, hashed_labels, selected, num_buckets, bias):
    """(full (N, R, B) float32 logits, selected (N, R, c_sel) ones)."""
    n, r = hashed_labels.shape
    logits = h2.to(torch.float32) @ w.to(torch.float32)
    if bias is not None:
        logits = logits + bias.to(torch.float32)[None, :]
    logits3 = logits.reshape(n, r, num_buckets)
    index = selected.long()[None].expand(n, -1, -1)
    return logits3, torch.gather(logits3, 2, index)


def mach_fused_xent_selected_ref(h2: torch.Tensor, w: torch.Tensor,
                                 hashed_labels: torch.Tensor,
                                 selected: torch.Tensor, num_buckets: int,
                                 bias: torch.Tensor = None) -> torch.Tensor:
    """Materializing oracle for the selected-bucket fused loss: the full
    (N, R, B) logits, the selected columns of each head, each label
    remapped to its position in the selection, then ``mach_xent_ref``.
    A label outside the selection aliases to position 0."""
    _, sel = _selected_logits(h2, w, hashed_labels, selected, num_buckets,
                              bias)
    return mach_xent_ref(sel, label_positions(selected, hashed_labels))


def mach_fused_xent_csr_selected_ref(indptr: torch.Tensor,
                                     indices: torch.Tensor,
                                     values: torch.Tensor, w: torch.Tensor,
                                     hashed_labels: torch.Tensor,
                                     selected: torch.Tensor,
                                     num_buckets: int,
                                     bias: torch.Tensor = None
                                     ) -> torch.Tensor:
    """CSR oracle for the selected-bucket fused loss: densify, then
    ``mach_fused_xent_selected_ref``."""
    x = csr_densify_ref(indptr, indices, values.to(torch.float32), w.shape[0])
    return mach_fused_xent_selected_ref(x, w, hashed_labels, selected,
                                        num_buckets, bias=bias)


def mach_selected_bias_bound_ref(h2: torch.Tensor, w: torch.Tensor,
                                 hashed_labels: torch.Tensor,
                                 selected: torch.Tensor, num_buckets: int,
                                 bias: torch.Tensor = None) -> torch.Tensor:
    """Per-example upper bound on the one-sided selection bias, (N,)
    float32.  With every label bucket selected, full − selected loss =
    Σ_r (lse_full − lse_sel), and each head's gap lies in [0, log1p((B −
    c_sel)·exp(m_exc − lse_sel))], m_exc that head's largest excluded
    logit.  Materializes the full logits: a test helper."""
    r, c_sel = selected.shape
    logits3, sel = _selected_logits(h2, w, hashed_labels, selected,
                                    num_buckets, bias)
    lse_sel = torch.logsumexp(sel, dim=-1)                       # (N, R)
    mask = torch.zeros((r, num_buckets), dtype=torch.bool,
                       device=logits3.device)
    mask[torch.arange(r, device=mask.device)[:, None], selected.long()] = True
    m_exc = torch.where(mask[None], -torch.inf, logits3).amax(dim=-1)
    gap = torch.log1p((num_buckets - c_sel) * torch.exp(m_exc - lse_sel))
    return torch.where(torch.isfinite(m_exc), gap, 0.0).sum(dim=-1)


# ---------------------------------------------------------------------------
# LM substrate: the RG-LRU recurrence and attention.
# ---------------------------------------------------------------------------

def lru_scan_ref(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
                 ) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t by an associative scan (Hillis-Steele
    doubling over the product-sum composition (a2·a1, a2·b1 + b2)), in
    float32.  a, x (B, T, D); h0 (B, D) -> (B, T, D) in x's dtype."""
    acc_a = a.to(torch.float32)
    acc_b = x.to(torch.float32)
    first = acc_b[:, :1] + acc_a[:, :1] * h0.to(torch.float32)[:, None]
    acc_b = torch.cat([first, acc_b[:, 1:]], dim=1)
    shift = 1
    while shift < acc_a.shape[1]:       # out of place: autograd runs through
        acc_b = torch.cat([acc_b[:, :shift],
                           acc_a[:, shift:] * acc_b[:, :-shift]
                           + acc_b[:, shift:]], dim=1)
        acc_a = torch.cat([acc_a[:, :shift],
                           acc_a[:, shift:] * acc_a[:, :-shift]], dim=1)
        shift *= 2
    return acc_b.to(x.dtype)


def lru_scan_grad_ref(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor,
                      dh: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(da, dx, dh0): the vector-Jacobian product of ``lru_scan_ref`` with
    the cotangent dh, by autograd through the associative scan."""
    leaves = [t.detach().requires_grad_(True) for t in (a, x, h0)]
    h = lru_scan_ref(*leaves)
    return torch.autograd.grad(h, leaves, dh.to(h.dtype))


def flash_attention_grad_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True, window=None):
    """(dq, dk, dv): the vector-Jacobian product of
    ``flash_attention_ref`` with the cotangent dout, by autograd through
    the dense attention."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_ref(*leaves, causal=causal, window=window)
    return torch.autograd.grad(out, leaves, dout.to(out.dtype))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window=None) -> torch.Tensor:
    """Materializing oracle for ``ops.flash_attention``: the dense
    attention of ``models/attention.py`` over the full (T, S) scores at
    contiguous positions."""
    from repro_torch.models import attention  # deferred: models import kernels
    b, t = q.shape[:2]
    s_len = k.shape[1]
    q_pos = torch.arange(t, device=q.device).expand(b, t)
    k_pos = torch.arange(s_len, device=q.device).expand(b, s_len)
    return attention.attend(q, k, v, q_pos, k_pos, causal=causal,
                            window=window, flash_threshold=1 << 62)
