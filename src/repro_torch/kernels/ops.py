"""Public decode, training-loss and LM-substrate ops.

Dispatch is by tensor device: CUDA tensors go to the hand-written
kernels, CPU tensors to their plain PyTorch versions (large CPU top-k
problems to a blocked streaming version with the same results), fake
tensors to the kernels' stand-ins (``counting``).  There
are no knobs that pick a device path.  The algorithm knobs are
``sparse_impl`` (a sparse kernel family), ``bucket_select`` (dynamic
bucket selection) and ``candidate_mode`` (the count-min candidate
filter).  Every public op names its oracle in ``kernels/ref.py`` in
``ORACLES``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import counting
from repro_torch.kernels import mach_fused_xent as mfx
from repro_torch.kernels import mach_xent as _mx
from repro_torch.kernels import mach_topk as _mtk
from repro_torch.kernels import ref
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lru_scan as _ls
from repro_torch.kernels.mach_candidates import mach_candidate_topk
from repro_torch.kernels.mach_decode import (check_decode_operands,
                                             mach_decode)
from repro_torch.kernels.mach_decode import table_from_inline as _table_from_inline
from repro_torch.kernels.mach_topk import (check_topk_args, estimator_scores,
                                           mach_topk as _mach_topk_kernel,
                                           unbiased_affine)

# CPU top-k problems with N·K·R above this stream K in blocks
_BLOCKED_MIN = 2 ** 24
# candidate_mode value that streams all K classes
CANDIDATE_EXACT = "exact"


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
              inline_shift: Optional[int] = None,
              candidate_mode=None,
              inverted: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k classes under any paper estimator (unbiased | min | median).

    meta_probs: (..., R, B) — leading dims flattened internally.
    Returns (values (..., k) f32, indices (..., k) int32) on the
    estimator's scale, equal to ``estimate_class_probs`` + a top-k with
    ties to the lowest class id.  The CUDA kernel streams K and never
    materializes the (batch, K) scores; on the CPU, small problems
    materialize them and large ones stream K in blocks.

    ``candidate_mode``: None or "exact" stream all K classes; an (m, t)
    tuple routes through the count-min candidate filter
    (``mach_topk_candidates``, which needs ``inverted``), whose cost is
    independent of K and whose top-k is approximate (filtered slots
    come back as (-inf, -1)).
    """
    if candidate_mode is not None and candidate_mode != CANDIDATE_EXACT:
        if isinstance(candidate_mode, str) or len(candidate_mode) != 2:
            raise ValueError(f"candidate_mode must be None, "
                             f"{CANDIDATE_EXACT!r} or (m, t), got "
                             f"{candidate_mode!r}")
        if inverted is None:
            raise ValueError("candidate_mode=(m, t) needs the inverted table")
        m, t = candidate_mode
        return mach_topk_candidates(
            meta_probs, table, inverted=inverted, num_classes=num_classes,
            k=k, m=m, t=t, estimator=estimator, inline_coeffs=inline_coeffs,
            inline_shift=inline_shift)
    check_topk_args(num_classes, k, estimator)
    lead = meta_probs.shape[:-2]
    r, b = meta_probs.shape[-2:]
    flat = meta_probs.reshape((-1, r, b)).to(torch.float32).contiguous()
    if (flat.device.type == "cpu" and not counting.is_fake(flat)
            and flat.shape[0] * num_classes * r > _BLOCKED_MIN):
        check_decode_operands(flat, table, num_classes, inline_coeffs,
                              inline_shift)
        work = _mtk.work(flat.shape[0], r, b, num_classes, k,
                         table is not None)
        if table is None:
            table = _table_from_inline(inline_coeffs, inline_shift,
                                       num_classes)
        with counting.launch("mach_topk", work):
            val, idx = _blocked_topk_fallback(flat, table, k, estimator)
    else:
        val, idx = _mach_topk_kernel(flat, table, num_classes=num_classes,
                                     k=k, estimator=estimator,
                                     inline_coeffs=inline_coeffs,
                                     inline_shift=inline_shift)
    return val.reshape(lead + (k,)), idx.reshape(lead + (k,))


def mach_topk_candidates(meta_probs: torch.Tensor,
                         table: Optional[torch.Tensor] = None, *,
                         inverted: torch.Tensor,
                         num_classes: int,
                         k: int,
                         m: int,
                         t: int = 1,
                         estimator: str = "unbiased",
                         inline_coeffs: Optional[torch.Tensor] = None,
                         inline_shift: Optional[int] = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate-filtered top-k: count-min filter over the per-repetition
    bucket top-m, then gather + score only the candidates.

    meta_probs: (..., R, B) — leading dims flattened internally;
    ``inverted`` is the (R·B, L) table from ``hashing.inverted_table``.
    Returns (values, indices) shaped (..., k); slots beyond the
    surviving candidates are (-inf, -1), and a row with no count>=t
    candidate backfills slot 0 with its best count>=1 candidate.  With
    m = B and t = R the result equals the streaming ``mach_topk``
    exactly.  Both hash sources run on both devices (kernels 7 and 8 on
    CUDA tensors, their plain versions on CPU tensors).  The JAX
    package's ``compact_cap`` has no counterpart: the whole pool is
    scored, as the TPU kernel and the oracle do.
    """
    lead = meta_probs.shape[:-2]
    r, b = meta_probs.shape[-2:]
    flat = meta_probs.reshape((-1, r, b)).to(torch.float32).contiguous()
    val, idx = mach_candidate_topk(
        flat, inverted, table, num_classes=num_classes, k=k, m=m, t=t,
        estimator=estimator, inline_coeffs=inline_coeffs,
        inline_shift=inline_shift)
    return val.reshape(lead + (k,)), idx.reshape(lead + (k,))


def mach_scores(meta_probs: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Full (…, K) score matrix — reference path (never on the decode
    path; the yardstick materializes it)."""
    lead = meta_probs.shape[:-2]
    r, b = meta_probs.shape[-2:]
    g = ref.mach_scores_ref(meta_probs.reshape((-1, r, b)), table)
    return g.reshape(lead + (table.shape[1],))


def _check_device(x: torch.Tensor, what: str) -> str:
    """The device kind of an op with a kernel and a plain version (a fake
    tensor's too: the kernel's wrapper stands in for it there)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no {what} path for device {x.device}")
    return x.device.type


def mach_xent(logits: torch.Tensor, hashed_labels: torch.Tensor
              ) -> torch.Tensor:
    """Per-example summed R-head CE on given logits, with its backward.

    logits (..., R, B) float32 | bfloat16; hashed_labels (..., R) ->
    (...,) float32.  Kernel 3 forward and backward on CUDA tensors, its
    plain versions on CPU tensors; the gradient takes the logits' dtype.
    """
    lead = logits.shape[:-2]
    r, b = logits.shape[-2:]
    flat = logits.reshape((-1, r, b)).contiguous()
    labels = hashed_labels.reshape((-1, r)).to(torch.int32).contiguous()
    _mx.check_operands(flat, labels)
    _check_device(flat, "mach_xent")
    return _mx.MachXent.apply(flat, labels).reshape(lead)


def csr_to_ell(indptr: torch.Tensor, indices: torch.Tensor,
               values: torch.Tensor, nnz_max: int, num_features: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """CSR -> padded ELL (cols (N, nnz_max) int32, vals (N, nnz_max)).

    Row n's entries land in slots [0, len_n); padded slots carry col id
    ``num_features`` and val 0 (the kernels skip ids outside [0, d), so
    that id is never read).  An ``nnz_max`` below the longest row would
    silently truncate it, so it is rejected on every call: that check
    reads max(diff(indptr)) back to the host, one device-to-host copy
    (and synchronisation) per call on a CUDA batch.  Differentiable wrt
    ``values`` (a gather).
    """
    n = indptr.shape[0] - 1
    nnz = indices.shape[0]
    if n > 0:
        longest = int(torch.diff(indptr.long()).max())
        if longest > nnz_max:
            raise ValueError(
                f"nnz_max={nnz_max} < longest CSR row ({longest}): the "
                f"kernel would silently truncate it")
    dev = indptr.device
    if nnz == 0:
        return (torch.full((n, nnz_max), num_features, dtype=torch.int32,
                           device=dev),
                torch.zeros((n, nnz_max), dtype=values.dtype, device=dev))
    start = indptr.long()
    pos = start[:-1, None] + torch.arange(nnz_max, device=dev)[None, :]
    valid = pos < start[1:, None]
    posc = torch.clamp(pos, max=nnz - 1)
    cols = torch.where(valid, indices[posc].to(torch.int32), num_features)
    vals = torch.where(valid, values[posc], torch.zeros((), dtype=values.dtype,
                                                        device=dev))
    return cols.to(torch.int32), vals


def mach_fused_xent(h: torch.Tensor, w: torch.Tensor,
                    hashed_labels: torch.Tensor, *, num_buckets: int,
                    bias: Optional[torch.Tensor] = None,
                    bucket_select: Optional[tuple] = None,
                    bucket_proxy: Optional[torch.Tensor] = None,
                    split=None) -> torch.Tensor:
    """Logit-free fused projection + R-head CE on dense inputs.

    h (..., d), w (d, R·B) and optional bias (R·B,), all float32 or all
    bfloat16; hashed_labels (..., R) bucket ids -> (...,) float32
    per-example loss.  On CUDA the dense kernel runs both passes on the
    tensor cores and the (…, R·B) logits never exist in device memory;
    on the CPU the plain version runs (bf16 operands upcast to float32
    before the product, as the JAX kernel does).  Differentiable wrt h,
    w and bias, gradients in the inputs' dtype.  The kernels choose their
    own tiles: the TPU knobs ``block_n/block_c/block_d`` have no
    counterpart.

    ``bucket_select=(c_sel, refresh_every)`` turns on dynamic bucket
    selection where c_sel < num_buckets: a proxy scores all R·B bucket
    columns, the top c_sel of each repetition are kept (the batch's label
    buckets force-included, so the bias is one-sided and bounded by
    ``ref.mach_selected_bias_bound_ref``), and the fused loss runs over
    the gathered (d, R·c_sel) columns.  ``bucket_proxy`` passes cached
    (R, B) proxy scores (``train.Trainer`` refreshes them every
    ``refresh_every`` steps); without it the proxy is computed here from
    the batch mean.  Selection itself runs on every call.  With c_sel >=
    num_buckets, or ``bucket_select=None``, this is the unselected path.

    ``split`` (a ``sharding.RangeSplit``: a sharded step's head on this
    rank) makes the selection the global batch's: w and the labels are
    then the rank's repetitions, h the rows it computes them on, and the
    proxy and the label buckets reduce over the other ranks
    (``mach_bucket_proxy`` / ``mach_select_buckets`` with ``split``), so
    the rank's (R_local, c_sel) selection is its rows of one device's.
    A cached ``bucket_proxy`` (computed on whole params outside the
    step) is refused there.
    """
    if bucket_select is not None and bucket_select[0] < num_buckets:
        if split is not None and bucket_proxy is not None:
            raise ValueError("a cached bucket_proxy under a mesh: the "
                             "in-loss proxy is the global batch's; a "
                             "cached one is not ported (ROADMAP.md §1)")
        proxy = bucket_proxy if bucket_proxy is not None else \
            mach_bucket_proxy(h, w, num_buckets=num_buckets, bias=bias,
                              split=split)
        selected = mach_select_buckets(proxy, hashed_labels,
                                       num_buckets=num_buckets,
                                       c_sel=bucket_select[0], split=split)
        return mach_fused_xent_selected(h, w, hashed_labels, selected,
                                        num_buckets=num_buckets, bias=bias)
    lead, d = h.shape[:-1], h.shape[-1]
    r = hashed_labels.shape[-1]
    loss, _ = mfx.mach_fused_xent_dense(
        h.reshape(-1, d), w, bias,
        hashed_labels.reshape(-1, r).to(torch.int32), num_buckets)
    return loss.reshape(lead)


def mach_fused_xent_csr(indptr: torch.Tensor, indices: torch.Tensor,
                        values: torch.Tensor, w: torch.Tensor,
                        hashed_labels: torch.Tensor, *, num_buckets: int,
                        nnz_max: int, bias: Optional[torch.Tensor] = None,
                        sparse_impl: Optional[str] = None,
                        bucket_select: Optional[tuple] = None,
                        bucket_proxy: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Sparse-feature fused projection + R-head CE (the ODP d=422k
    training path).

    indptr (N+1,), indices (nnz,), values (nnz,) — a CSR batch over d
    features; w (d, R·B); hashed_labels (N, R); optional bias (R·B,) ->
    (N,) f32.  The batch is re-laid-out as padded ELL (``csr_to_ell``);
    neither a dense (N, d) activation nor the (N, R·B) logits exist in
    device memory on CUDA.  ``sparse_impl`` picks the family: "densify"
    (the ELL row-tile family, which replaces the TPU's densifying
    kernel; it keeps that knob value's name but densifies nothing),
    "gather" (one row a block), or None: gather at ``nnz_max >=
    GATHER_NNZ_THRESHOLD``, else the ELL row-tile family.  The port routes
    by that threshold alone (the TPU's extra switch on a VMEM budget has
    no meaning on this card).  Differentiable wrt w and bias; ``values``
    get no gradient on either device (features are data).
    ``bucket_select`` / ``bucket_proxy`` as on ``mach_fused_xent``; the
    proxy's batch mean is a scatter-add of the CSR values.
    """
    d = w.shape[0]
    r = hashed_labels.shape[-1]
    if w.dim() != 2 or w.shape[1] != r * num_buckets:
        raise ValueError(f"w {tuple(w.shape)} != (d, {r}*{num_buckets})")
    if bucket_select is not None and bucket_select[0] < num_buckets:
        proxy = bucket_proxy if bucket_proxy is not None else \
            mach_bucket_proxy(w=w, num_buckets=num_buckets, bias=bias,
                              csr=(indptr, indices, values))
        selected = mach_select_buckets(proxy, hashed_labels,
                                       num_buckets=num_buckets,
                                       c_sel=bucket_select[0])
        return mach_fused_xent_csr_selected(
            indptr, indices, values, w, hashed_labels, selected,
            num_buckets=num_buckets, nnz_max=nnz_max, bias=bias,
            sparse_impl=sparse_impl)
    if sparse_impl not in (None, "densify", "gather"):
        raise ValueError(f"sparse_impl must be 'densify', 'gather' or None, "
                         f"got {sparse_impl!r}")
    impl = sparse_impl or ("gather" if nnz_max >= mfx.GATHER_NNZ_THRESHOLD
                           else "densify")
    family = mfx.mach_fused_xent_gather if impl == "gather" \
        else mfx.mach_fused_xent_ell
    cols, vals = csr_to_ell(indptr, indices, values.detach(), nnz_max, d)
    loss, _ = family(cols, vals, w, bias, hashed_labels.to(torch.int32),
                     num_buckets)
    return loss


# ---------------------------------------------------------------------------
# Dynamic bucket selection (the training-time cut of the C axis).  Plain
# PyTorch on both devices, as the JAX package computes it outside any
# kernel; the loss it feeds runs kernels 4-6 at B' = c_sel.
# ---------------------------------------------------------------------------

def mach_bucket_proxy(h: Optional[torch.Tensor] = None,
                      w: Optional[torch.Tensor] = None, *, num_buckets: int,
                      bias: Optional[torch.Tensor] = None,
                      csr: Optional[tuple] = None,
                      split=None) -> torch.Tensor:
    """(R, B) float32 bucket proxy scores: the logits of the batch-mean
    activation.  Dense: ``h`` (..., d); sparse: ``csr=(indptr, indices,
    values)`` in its place (the mean is a scatter-add, never a densified
    batch).  No gradient flows through it: the proxy only ranks buckets.
    With ``split`` (dense only): h's float32 row sum and row count summed
    over ``split.reduced`` (the ranks of the batch's other rows), then
    divided, projected onto the rank's columns w (d, R_local·B); where
    those ranks are this one alone, the batch mean as on one device."""
    with torch.no_grad():
        if csr is not None:
            if split is not None:
                raise ValueError("a CSR bucket proxy under a mesh is not "
                                 "ported")
            return ref.mach_bucket_proxy_csr_ref(*csr, w, num_buckets,
                                                 bias=bias)
        h2 = h.reshape(-1, h.shape[-1])
        if split is None or not split.moves(split.reduced):
            return ref.mach_bucket_proxy_ref(h2, w, num_buckets, bias=bias)
        h2 = h2.to(torch.float32)
        total = split.sum_rows(torch.cat([h2.sum(dim=0),
                                          h2.new_tensor([h2.shape[0]])]))
        return ref.proxy_logits(total[:-1] / total[-1], w, num_buckets,
                                bias)


def mach_select_buckets(proxy_scores: torch.Tensor,
                        hashed_labels: torch.Tensor, *, num_buckets: int,
                        c_sel: int, split=None) -> torch.Tensor:
    """Top-``c_sel`` bucket columns per repetition by proxy score, the
    batch's label buckets force-included -> (R, c_sel) int32, ascending;
    ties to the lower bucket id, as ``jax.lax.top_k`` breaks them.  With
    ``split``, proxy and labels hold the rank's repetitions: the label
    buckets are marked over ``split.reduced`` (the batch's other rows)
    and the boost ``max − min + 1`` is taken over ``split.dims`` (every
    repetition, as one device takes it), so each rank selects its rows
    of one device's selection."""
    lbl = hashed_labels.reshape(-1, hashed_labels.shape[-1]).to(torch.int32)
    if split is None:
        return ref.mach_select_buckets_ref(proxy_scores, lbl, num_buckets,
                                           c_sel)
    proxy = proxy_scores.to(torch.float32)
    present = split.max_rows(ref.bucket_presence(lbl, *proxy.shape))
    top = split.max_split(torch.stack([proxy.max(), -proxy.min()]))
    return ref.select_boosted(proxy, present, top[0] + top[1] + 1.0, c_sel)


def _apply_bucket_selection(w, bias, lbl, selected, num_buckets):
    """The selected W columns (d, R·c_sel) and bias entries, gathered in
    one ``index_select`` (its backward writes gradients into the selected
    columns only: every other column's is exactly zero), and each label's
    position inside its selection (position 0 if it is not in it)."""
    r = selected.shape[0]
    flat = (torch.arange(r, device=selected.device)[:, None] * num_buckets
            + selected.long()).reshape(-1)
    wsel = w.index_select(1, flat)
    bsel = None if bias is None else bias.index_select(0, flat)
    return wsel, bsel, ref.label_positions(selected, lbl)


def mach_fused_xent_selected(h: torch.Tensor, w: torch.Tensor,
                             hashed_labels: torch.Tensor,
                             selected: torch.Tensor, *, num_buckets: int,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The fused projection + R-head CE over a selected bucket subset:
    ``selected`` (R, c_sel) from ``mach_select_buckets``, which
    force-includes every label bucket (a label outside its head's
    selection silently takes position 0, as in the JAX package).  Runs
    ``mach_fused_xent`` at B' = c_sel on the gathered columns: kernel 4
    on CUDA tensors.  A lower bound on the full loss."""
    r, c_sel = selected.shape
    lbl = hashed_labels.reshape(-1, r).to(torch.int32)
    wsel, bsel, pos = _apply_bucket_selection(w, bias, lbl, selected,
                                              num_buckets)
    return mach_fused_xent(h, wsel, pos.reshape(hashed_labels.shape),
                           num_buckets=c_sel, bias=bsel)


def mach_fused_xent_csr_selected(indptr: torch.Tensor, indices: torch.Tensor,
                                 values: torch.Tensor, w: torch.Tensor,
                                 hashed_labels: torch.Tensor,
                                 selected: torch.Tensor, *, num_buckets: int,
                                 nnz_max: int,
                                 bias: Optional[torch.Tensor] = None,
                                 sparse_impl: Optional[str] = None
                                 ) -> torch.Tensor:
    """CSR counterpart of ``mach_fused_xent_selected``: runs
    ``mach_fused_xent_csr`` at B' = c_sel on the gathered columns
    (kernel 5 below ``GATHER_NNZ_THRESHOLD``, kernel 6 from it)."""
    r, c_sel = selected.shape
    lbl = hashed_labels.reshape(-1, r).to(torch.int32)
    wsel, bsel, pos = _apply_bucket_selection(w, bias, lbl, selected,
                                              num_buckets)
    return mach_fused_xent_csr(indptr, indices, values, wsel, pos,
                               num_buckets=c_sel, nnz_max=nnz_max, bias=bsel,
                               sparse_impl=sparse_impl)


def lru_scan(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
             ) -> torch.Tensor:
    """Diagonal linear recurrence h_t = a_t·h_{t-1} + x_t (the RG-LRU).

    a, x (B, T, D); h0 (B, D) -> h (B, T, D) in x's dtype, carried in
    float32: kernel 9 on CUDA tensors, its plain sequential loop on CPU
    tensors (bit for bit the same).  Differentiable wrt a, x and h0 (the
    backward kernel's reverse loop, or its plain version)."""
    _ls.check_operands(a, x, h0)
    if _check_device(x, "lru_scan") == "cuda":
        a, x = a.contiguous(), x.contiguous()
        h0 = h0.to(torch.float32).contiguous()
    return _ls.LruScan.apply(a, x, h0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """Causal / windowed GQA attention for contiguous positions 0..T-1
    (queries) and 0..S-1 (keys): q (B, T, H, hd), k/v (B, S, KV, hd) ->
    (B, T, H, hd); S may differ from T (non-causal cross-attention reads
    every key).  Kernel 10 on CUDA tensors (the scores never leave
    the chip), its plain online-softmax version on CPU tensors.
    Differentiable wrt q, k and v (the backward kernels, or their plain
    version)."""
    _fa.check_operands(q, k, v, window)
    if _check_device(q, "flash attention") == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _fa.FlashAttention.apply(q, k, v, causal, window)


# public op -> its oracle in kernels/ref.py
ORACLES: dict = {
    "mach_top1": "mach_decode_ref",
    "mach_topk": "mach_topk_ref",
    "mach_topk_candidates": "mach_candidate_topk_ref",
    "mach_scores": "mach_scores_ref",
    "mach_xent": "mach_xent_ref",
    "mach_fused_xent": "mach_fused_xent_ref",
    "mach_fused_xent_csr": "mach_fused_xent_csr_ref",
    "mach_bucket_proxy": "mach_bucket_proxy_ref",
    "mach_select_buckets": "mach_select_buckets_ref",
    "mach_fused_xent_selected": "mach_fused_xent_selected_ref",
    "mach_fused_xent_csr_selected": "mach_fused_xent_csr_selected_ref",
    "csr_to_ell": "csr_densify_ref",
    "lru_scan": "lru_scan_ref",
    "flash_attention": "flash_attention_ref",
}
