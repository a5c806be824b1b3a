"""Fused projection + MACH R-head cross-entropy (the logit-free training loss).

One function, three input families.  For activations a (N, d), head
weights W (d, R·B), an optional bias (R·B,) and hashed labels y (N, R):

    logits = a @ W + bias,  loss_n = Σ_r [lse(logits[n, r]) − logits[n, r, y_nr]]

* ``mach_fused_xent_dense``  — a is a dense (N, d) tensor; kernel
  ``csrc/mach_fused_xent_dense.cu`` on the tensor cores (replaces
  ``repro/kernels/mach_fused_xent.py::mach_fused_xent_pallas``).
* ``mach_fused_xent_ell``    — a is a padded-ELL batch cols/vals (N, J),
  padded slots carrying col id d and val 0; kernel
  ``csrc/mach_fused_xent_ell.cu``, blocks of (row tile, 32 logits
  columns) that stage W's column slice in shared memory where it fits
  (replaces ``mach_fused_xent_sparse_pallas``, the default below
  ``GATHER_NNZ_THRESHOLD`` nonzeros a row).
* ``mach_fused_xent_gather`` — the same ELL function, one row a block
  (replaces ``mach_fused_xent_gather_pallas``, for nnz at or above the
  threshold).

Both sparse backwards put the batch in column order (for each feature,
its (row, val) pairs; one shared launch) and write each dW element once
from the dlogits, with no float atomics: the same bits from run to run.

Each returns (loss (N,), lse (N, R)).  On CUDA tensors it runs a
``torch.autograd.Function`` whose forward and backward are the kernels:
the forward keeps the per-head logsumexp as its residual and the
backward uses it, forming dlogits = g·(softmax − onehot(y)) from one
recomputation of each logits tile.  The (N, R·B) logits never reach
device memory (the sparse backwards write the (N, R·B) dlogits).  On
CPU tensors the family's plain PyTorch version runs and autograd
differentiates it; the gather family's CPU backward is
``gather_bwd_plain``, the plain versions of the three steps both sparse
kernels' backwards take.
Gradients flow to W, the bias and (dense family) a; ELL ``vals`` are
data and get none on either device.

Dense inputs h, W (and the bias) are all float32 or all bfloat16, as the
JAX kernel takes them: products are formed from float32 values (bf16
upcast, exactly), loss and lse are float32, and the gradients come back
in the inputs' dtype.  The ELL and gather families take float32.  Other
dtypes raise ``ValueError``; labels are int32.  The kernels choose their
own tiles; there are no block-size knobs.  On fake tensors the Functions
run the kernels' stand-ins (``counting``); ``work`` is the three
families' arithmetic.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, counting

GATHER_NNZ_THRESHOLD = 512    # nnz_max at which CSR batches take the gather family
DENSE_DTYPES = (torch.float32, torch.bfloat16)
# logits columns a dense block owns (csrc Lay<T>)
_DENSE_COLS = {torch.float32: 128, torch.bfloat16: 256}

_ELL_COLS = 32                # logits columns an ELL block owns (csrc kTileCols)
_HEAVY_TERMS = 64             # pairs over which a block shares a dW row
#                               (csrc mach_xent_dw.cuh kHeavyTerms)


def work(family: str, n: int, d: int, r: int, b: int,
         dtype: torch.dtype = torch.float32, *, backward: bool = False,
         need_dh: bool = False, bias: bool = True, j: int = 0,
         nnz: Optional[int] = None, unique: Optional[int] = None
         ) -> tuple[int, int]:
    """(flops, bytes) of kernels 4 (``family`` "dense": h (N, d) of
    ``dtype``) and 5-6 ("ell" / "gather": an (N, J) ELL batch, float32)
    on W (d, R·B).  Dense: 2·N·d·R·B operations forward, 4·N·d·R·B
    backward (the logits again, then dW; 6 with dh); h, W, the bias and
    the labels read, loss and lse written; backward also lse and g read
    and dW, dbias (and dh) written.  Sparse: 2·nnz·R·B forward and
    4·nnz·R·B backward over the ``nnz`` valid slots (without it the N·J
    slots), the ``unique`` W rows the batch touches read once (without
    it min(d, nnz)) and the ELL batch read; dW written whole."""
    c = r * b
    cb = c if bias else 0
    if family == "dense":
        es = dtype.itemsize
        read = es * (n * d + d * c + cb)
        if backward:
            return ((6 if need_dh else 4) * n * d * c,
                    read + 4 * (2 * n * r + n)
                    + es * (d * c + cb + (n * d if need_dh else 0)))
        return 2 * n * d * c, read + 4 * n * r + 4 * (n + n * r)
    nnz = n * j if nnz is None else nnz
    unique = min(d, nnz) if unique is None else unique
    read = 4 * unique * c + 8 * n * j + 4 * cb
    if backward:
        return 4 * nnz * c, read + 4 * (2 * n * r + n) + 4 * (d * c + cb)
    return 2 * nnz * c, read + 4 * n * r + 4 * (n + n * r)


def _kind(x: torch.Tensor) -> str:
    """The path a tensor takes: "fake" (the stand-ins) or its device."""
    return "fake" if counting.is_fake(x) else x.device.type


# ---------------------------------------------------------------------------
# operand checks
# ---------------------------------------------------------------------------

def _check_head(w, bias, labels, num_buckets, n, d, device):
    if labels.dim() != 2 or labels.shape[0] != n:
        raise ValueError(f"labels must be (N, R) with N={n}, got "
                         f"{tuple(labels.shape)}")
    r = labels.shape[1]
    if n < 1 or r < 1 or num_buckets < 1:
        raise ValueError(f"need N, R, B >= 1, got N={n}, R={r}, "
                         f"B={num_buckets}")
    if tuple(w.shape) != (d, r * num_buckets):
        raise ValueError(f"w {tuple(w.shape)} != ({d}, {r}*{num_buckets})")
    if bias is not None and tuple(bias.shape) != (r * num_buckets,):
        raise ValueError(f"bias {tuple(bias.shape)} != ({r}*{num_buckets},)")
    if labels.dtype != torch.int32:
        raise ValueError(f"labels must be int32, got {labels.dtype}")
    for t in (w, bias, labels):
        if t is not None and t.device != device:
            raise ValueError("fused xent operands are on different devices")


def check_dense(h, w, bias, labels, num_buckets):
    if h.dim() != 2:
        raise ValueError(f"h must be (N, d), got {tuple(h.shape)}")
    if h.dtype not in DENSE_DTYPES:
        raise ValueError(f"h must be float32 or bfloat16, got {h.dtype}")
    for name, t in (("w", w), ("bias", bias)):
        if t is not None and t.dtype != h.dtype:
            raise ValueError(f"h and {name} must share a dtype (float32 or "
                             f"bfloat16), got {h.dtype} and {t.dtype}")
    _check_head(w, bias, labels, num_buckets, h.shape[0], h.shape[1], h.device)


def check_ell(cols, vals, w, bias, labels, num_buckets):
    if cols.dim() != 2 or tuple(vals.shape) != tuple(cols.shape):
        raise ValueError(f"cols/vals must both be (N, J), got "
                         f"{tuple(cols.shape)} and {tuple(vals.shape)}")
    if cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32, got {cols.dtype}")
    for name, t in (("vals", vals), ("w", w), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if vals.device != cols.device or cols.shape[1] < 1:
        raise ValueError("cols/vals must share a device and have J >= 1")
    _check_head(w, bias, labels, num_buckets, cols.shape[0], w.shape[0],
                cols.device)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def _xent_plain(logits, labels, num_buckets):
    lg = logits.reshape(logits.shape[0], -1, num_buckets)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return (lse - picked).sum(dim=-1), lse.detach()


def fused_xent_dense_plain(h, w, bias, labels, num_buckets):
    """Plain PyTorch: materialize the (N, R·B) logits from operands upcast
    to at least float32 (bf16 as ``ref.mach_fused_xent_ref`` does; float64
    stays float64, the exact yardstick of the tests), then the CE; autograd
    casts the gradients back to the inputs' dtypes."""
    up = torch.promote_types(h.dtype, torch.float32)
    logits = h.to(up) @ w.to(up)
    if bias is not None:
        logits = logits + bias.to(up)
    return _xent_plain(logits, labels, num_buckets)


def fused_xent_ell_plain(cols, vals, w, bias, labels, num_buckets):
    """Plain PyTorch: gather the (N, J, R·B) rows W[cols] (padded slots
    masked out), contract with vals, then the CE.  ``vals`` is detached;
    duplicate ids sum in the contraction and in W's gradient."""
    valid = (cols >= 0) & (cols < w.shape[0])
    rows = w[torch.where(valid, cols, 0).long()]
    v = torch.where(valid, vals, 0.0).detach()
    logits = torch.bmm(v[:, None, :], rows)[:, 0]
    if bias is not None:
        logits = logits + bias
    return _xent_plain(logits, labels, num_buckets)


def ell_span(num_buckets: int) -> int:
    """Most 32-column tiles one head of B buckets can touch: the ELL
    forward's per-(row, head) partial slots."""
    return (num_buckets + _ELL_COLS - 2) // _ELL_COLS + 1


def gather_dlogits_plain(cols, vals, w, bias, labels, lse, g, num_buckets):
    """Plain PyTorch: dlogits = g·(softmax − onehot(y)) (N, R·B) float32
    of the ELL logits, from the forward's lse — both sparse backwards'
    first step."""
    valid = (cols >= 0) & (cols < w.shape[0])
    rows = w[torch.where(valid, cols, 0).long()]
    logits = torch.bmm(torch.where(valid, vals, 0.0)[:, None, :], rows)[:, 0]
    if bias is not None:
        logits = logits + bias
    n, r = labels.shape
    lg = logits.reshape(n, r, num_buckets)
    onehot = torch.nn.functional.one_hot(labels.long(), num_buckets)
    soft = torch.exp(lg - lse[..., None])
    return (g[:, None, None] * (soft - onehot)).reshape(n, -1)


def gather_column_order_plain(cols, vals, d):
    """Plain PyTorch: the ELL batch (N, J) in column order — colptr
    (d + 1,) int32 and, for each feature f in turn, its pairs'
    example rows (int32) and vals at positions [colptr[f], colptr[f+1]),
    in ascending (row, slot) order; duplicate ids kept, padding (ids
    outside [0, d)) dropped."""
    j = cols.shape[1]
    key = torch.where((cols >= 0) & (cols < d), cols, d).reshape(-1).long()
    slots = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=d + 1)[:d]
    colptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    slots = slots[:int(colptr[-1])]
    return (colptr.to(torch.int32), (slots // j).to(torch.int32),
            vals.reshape(-1)[slots])


def gather_dw_plain(colptr, term_row, term_val, dlogits):
    """Plain PyTorch: dW (d, R·B) with row f = Σ over f's pairs of
    val·dlogits[row] (rows the batch does not touch are zero), and dbias,
    the column sums of dlogits — what both sparse backwards' dW launch
    writes."""
    d = colptr.shape[0] - 1
    feature = torch.repeat_interleave(
        torch.arange(d, device=dlogits.device), torch.diff(colptr.long()))
    dw = torch.zeros((d, dlogits.shape[1]), dtype=dlogits.dtype,
                     device=dlogits.device)
    dw.index_add_(0, feature, term_val[:, None] * dlogits[term_row.long()])
    return dw, dlogits.sum(dim=0)


def gather_bwd_plain(cols, vals, w, bias, labels, lse, g, num_buckets):
    """Plain PyTorch: the sparse families' backward in their kernels'
    three steps (dlogits, column order, dW feature by feature) -> (dW,
    dbias or None)."""
    dlogits = gather_dlogits_plain(cols, vals, w, bias, labels, lse, g,
                                   num_buckets)
    dw, db = gather_dw_plain(*gather_column_order_plain(cols, vals,
                                                        w.shape[0]), dlogits)
    return dw, (None if bias is None else db)


# ---------------------------------------------------------------------------
# CUDA wrappers: one per launch function, each with a launch counter
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(source: str, fn: str, device: torch.device, *args) -> None:
    lib = _build.load(source)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn)(*args, stream)
    _build.check(lib, code, fn)


def _forward_outputs(n, r, device):
    lse = torch.empty((n, r), dtype=torch.float32, device=device)
    return lse, torch.empty_like(lse), torch.empty((n,), dtype=torch.float32,
                                                    device=device)


def _heavy_scratch(d, m, device):
    """The dW row launch's scratch: the heavy-row count, then the list (a
    heavy row has more than _HEAVY_TERMS of the at most m pairs)."""
    return torch.empty((2 + min(d, m // (_HEAVY_TERMS + 1)),),
                       dtype=torch.int32, device=device)


def dense_span(num_buckets: int, dtype: torch.dtype) -> int:
    """Most column tiles one head of B buckets can touch: the forward's
    per-(row, head) partial slots."""
    cols = _DENSE_COLS[dtype]
    return (num_buckets + cols - 2) // cols + 1


def dense_fwd_cuda(h, w, bias, labels, num_buckets):
    """Forward kernel on contiguous CUDA operands -> (loss, lse)."""
    (n, d), r = h.shape, labels.shape[1]
    lse, nll, loss = _forward_outputs(n, r, h.device)
    span = dense_span(num_buckets, h.dtype)
    part = torch.empty((3, n * r * span), dtype=torch.float32, device=h.device)
    _launch("mach_fused_xent_dense", "fused_xent_dense_fwd_launch", h.device,
            h.data_ptr(), w.data_ptr(), _ptr(bias), labels.data_ptr(), n, d, r,
            num_buckets, int(h.dtype == torch.bfloat16), span, part.data_ptr(),
            lse.data_ptr(), nll.data_ptr(), loss.data_ptr())
    dense_fwd_cuda.launches += 1
    return loss, lse


def dense_bwd_cuda(h, w, bias, labels, lse, g, num_buckets, need_dh=True):
    """Backward kernel -> (dh or None, dW, dbias or None) in the inputs'
    dtype, from the saved lse and the (N,) cotangent g.  The kernel adds
    into zero-filled float32 accumulators; for bfloat16 inputs those are
    scratch, cast into the outputs at the end."""
    (n, d), r = h.shape, labels.shape[1]
    f32 = dict(dtype=torch.float32, device=h.device)
    dh = torch.zeros((n, d), **f32) if need_dh else None
    dw = torch.zeros(tuple(w.shape), **f32)
    db = None if bias is None else torch.zeros(tuple(bias.shape), **f32)
    is_bf16 = h.dtype == torch.bfloat16
    outs = [None if t is None else (torch.empty_like(t, dtype=torch.bfloat16)
                                    if is_bf16 else t) for t in (dh, dw, db)]
    _launch("mach_fused_xent_dense", "fused_xent_dense_bwd_launch", h.device,
            h.data_ptr(), w.data_ptr(), _ptr(bias), labels.data_ptr(),
            lse.data_ptr(), g.data_ptr(), n, d, r, num_buckets, int(is_bf16),
            _ptr(dh), dw.data_ptr(), _ptr(db),
            *[_ptr(t) if is_bf16 else None for t in outs])
    dense_bwd_cuda.launches += 1
    return tuple(outs)


def ell_fwd_cuda(cols, vals, w, bias, labels, num_buckets):
    """Forward launch on contiguous CUDA operands -> (loss, lse): the
    logits tiles' per-(row, head) partials, merged, the heads summed."""
    (n, j), d, r = cols.shape, w.shape[0], labels.shape[1]
    lse, nll, loss = _forward_outputs(n, r, cols.device)
    span = ell_span(num_buckets)
    part = torch.empty((3, n * r * span), dtype=torch.float32,
                       device=cols.device)
    _launch("mach_fused_xent_ell", "fused_xent_ell_fwd_launch", cols.device,
            cols.data_ptr(), vals.data_ptr(), w.data_ptr(), _ptr(bias),
            labels.data_ptr(), n, j, d, r, num_buckets, span, part.data_ptr(),
            lse.data_ptr(), nll.data_ptr(), loss.data_ptr())
    ell_fwd_cuda.launches += 1
    return loss, lse


def ell_dlogits_cuda(cols, vals, w, bias, labels, lse, g, num_buckets):
    """The ELL backward's first launch -> (dlogits (N, R·B) float32, the
    slots' sort keys (N·J,) int32: col id, d for padding)."""
    (n, j), d, r = cols.shape, w.shape[0], labels.shape[1]
    dlogits = torch.empty((n, r * num_buckets), dtype=torch.float32,
                          device=cols.device)
    keys = torch.empty((n * j,), dtype=torch.int32, device=cols.device)
    _launch("mach_fused_xent_ell", "fused_xent_ell_dlogits_launch",
            cols.device, cols.data_ptr(), vals.data_ptr(), w.data_ptr(),
            _ptr(bias), labels.data_ptr(), lse.data_ptr(), g.data_ptr(), n, j,
            d, r, num_buckets, dlogits.data_ptr(), keys.data_ptr())
    ell_dlogits_cuda.launches += 1
    return dlogits, keys


def ell_dw_cuda(colptr, term_row, term_val, dlogits, with_bias):
    """The ELL backward's dW launch -> (dW (d, R·B), every element written
    once from the column order and the dlogits, and dbias or None)."""
    d, (n, c), m = colptr.shape[0] - 1, dlogits.shape, term_row.shape[0]
    f32 = dict(dtype=torch.float32, device=dlogits.device)
    dw = torch.empty((d, c), **f32)
    db = torch.empty((c,), **f32) if with_bias else None
    heavy = _heavy_scratch(d, m, dlogits.device)
    _launch("mach_fused_xent_ell", "fused_xent_ell_dw_launch", dlogits.device,
            colptr.data_ptr(), term_row.data_ptr(), term_val.data_ptr(),
            dlogits.data_ptr(), n, m, d, c, dw.data_ptr(), _ptr(db),
            heavy.data_ptr())
    ell_dw_cuda.launches += 1
    return dw, db


def ell_bwd_cuda(cols, vals, w, bias, labels, lse, g, num_buckets):
    """The ELL backward on the card -> (dW, dbias or None), the same bits
    from run to run: dlogits, the column order (the gather family's
    launch), dW.  Its counter counts these composed calls; each launching
    wrapper counts its own launches."""
    if cols.shape[0] * cols.shape[1] >= 2 ** 31:
        raise ValueError("the ELL backward takes fewer than 2^31 slots")
    dlogits, keys = ell_dlogits_cuda(cols, vals, w, bias, labels, lse, g,
                                     num_buckets)
    order = gather_column_order_cuda(keys, vals, w.shape[0])
    dw, db = ell_dw_cuda(*order, dlogits, bias is not None)
    ell_bwd_cuda.launches += 1
    return dw, db


def gather_fwd_cuda(cols, vals, w, bias, labels, num_buckets):
    (n, j), d, r = cols.shape, w.shape[0], labels.shape[1]
    lse, nll, loss = _forward_outputs(n, r, cols.device)
    _launch("mach_fused_xent_gather", "fused_xent_gather_fwd_launch",
            cols.device, cols.data_ptr(), vals.data_ptr(), w.data_ptr(),
            _ptr(bias), labels.data_ptr(), n, j, d, r, num_buckets,
            lse.data_ptr(), nll.data_ptr(), loss.data_ptr())
    gather_fwd_cuda.launches += 1
    return loss, lse


def gather_dlogits_cuda(cols, vals, w, bias, labels, lse, g, num_buckets):
    """The backward's first launch -> (dlogits (N, R·B) float32, the
    slots' sort keys (N·J,) int32: col id, d for padding, dbias or None)."""
    (n, j), d, r = cols.shape, w.shape[0], labels.shape[1]
    f32 = dict(dtype=torch.float32, device=cols.device)
    dlogits = torch.empty((n, r * num_buckets), **f32)
    keys = torch.empty((n * j,), dtype=torch.int32, device=cols.device)
    db = None if bias is None else torch.empty(tuple(bias.shape), **f32)
    _launch("mach_fused_xent_gather", "fused_xent_gather_dlogits_launch",
            cols.device, cols.data_ptr(), vals.data_ptr(), w.data_ptr(),
            _ptr(bias), labels.data_ptr(), lse.data_ptr(), g.data_ptr(), n, j,
            d, r, num_buckets, dlogits.data_ptr(), keys.data_ptr(), _ptr(db))
    gather_dlogits_cuda.launches += 1
    return dlogits, keys, db


def gather_column_order_cuda(keys, vals, d):
    """The backward's column order on the card: the keys sorted stably
    (``torch.sort``, index bookkeeping), then one launch -> (colptr
    (d + 1,) int32, term_row, term_val) as ``gather_column_order_plain``
    returns them, but padded to N·J entries (the first colptr[d] valid)."""
    m, j = keys.shape[0], vals.shape[1]
    sorted_keys, slots = torch.sort(keys, stable=True)
    colptr = torch.empty((d + 1,), dtype=torch.int32, device=keys.device)
    term_row = torch.empty((m,), dtype=torch.int32, device=keys.device)
    term_val = torch.empty((m,), dtype=torch.float32, device=keys.device)
    _launch("mach_fused_xent_gather", "fused_xent_gather_order_launch",
            keys.device, sorted_keys.data_ptr(), slots.data_ptr(),
            vals.data_ptr(), m, j, d, colptr.data_ptr(), term_row.data_ptr(),
            term_val.data_ptr())
    gather_column_order_cuda.launches += 1
    return colptr, term_row, term_val


def gather_dw_cuda(colptr, term_row, term_val, dlogits):
    """The backward's dW launch: every row of dW (d, R·B) written once,
    from the column order and the dlogits."""
    d, c = colptr.shape[0] - 1, dlogits.shape[1]
    dw = torch.empty((d, c), dtype=torch.float32, device=dlogits.device)
    heavy = _heavy_scratch(d, term_row.shape[0], dlogits.device)
    _launch("mach_fused_xent_gather", "fused_xent_gather_dw_launch",
            dlogits.device, colptr.data_ptr(), term_row.data_ptr(),
            term_val.data_ptr(), dlogits.data_ptr(), d, c, int(c % 4 == 0),
            dw.data_ptr(), heavy[1:].data_ptr(), heavy.data_ptr())
    gather_dw_cuda.launches += 1
    return dw


def gather_bwd_cuda(cols, vals, w, bias, labels, lse, g, num_buckets):
    """The gather backward on the card -> (dW, dbias or None), the same
    bits from run to run: dlogits, the column order, dW row by row.
    Its counter counts these composed calls; each of the three launching
    wrappers counts its own launches."""
    if cols.shape[0] * cols.shape[1] >= 2 ** 31:
        raise ValueError("the gather backward takes fewer than 2^31 slots")
    dlogits, keys, db = gather_dlogits_cuda(cols, vals, w, bias, labels, lse,
                                            g, num_buckets)
    dw = gather_dw_cuda(*gather_column_order_cuda(keys, vals, w.shape[0]),
                        dlogits)
    gather_bwd_cuda.launches += 1
    return dw, db


CUDA_WRAPPERS = (dense_fwd_cuda, dense_bwd_cuda, ell_fwd_cuda, ell_bwd_cuda,
                 ell_dlogits_cuda, ell_dw_cuda, gather_fwd_cuda,
                 gather_bwd_cuda, gather_dlogits_cuda,
                 gather_column_order_cuda, gather_dw_cuda)
for _fn in CUDA_WRAPPERS:
    _fn.launches = 0


def _forward_fake(x, *operands):
    """The forward kernels' stand-in on fake tensors (operands as the
    family's forward kernel takes them: labels next to last): loss (N,)
    and lse (N, R) float32; nothing built or launched."""
    n, r = operands[-2].shape
    return (x.new_empty((n,), dtype=torch.float32),
            x.new_empty((n, r), dtype=torch.float32))


def dense_bwd_fake(h, w, bias, labels, lse, g, num_buckets, need_dh=True):
    """The dense backward's stand-in: (dh or None, dW, dbias or None) in
    the inputs' dtype."""
    return tuple(None if t is None else torch.empty_like(
        t, memory_format=torch.contiguous_format)
        for t in (h if need_dh else None, w, bias))


def sparse_bwd_fake(cols, vals, w, bias, labels, lse, g, num_buckets):
    """The sparse backwards' stand-in: (dW, dbias or None) float32."""
    return tuple(None if t is None else torch.empty_like(
        t, dtype=torch.float32, memory_format=torch.contiguous_format)
        for t in (w, bias))


# path -> (forward, backward) of ``_DenseXent``
_DENSE_PATHS = {"cuda": (dense_fwd_cuda, dense_bwd_cuda),
                "fake": (_forward_fake, dense_bwd_fake)}


def _dense_work(h, w, bias, labels, backward=False, need_dh=False):
    (n, d), r = h.shape, labels.shape[1]
    return work("dense", n, d, r, w.shape[1] // r, h.dtype,
                backward=backward, need_dh=need_dh, bias=bias is not None)


class _DenseXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, bias, labels, num_buckets):
        fwd, _ = _DENSE_PATHS[_kind(h)]
        with counting.launch("dense_fwd", _dense_work(h, w, bias, labels)):
            loss, lse = fwd(h, w, bias, labels, num_buckets)
        ctx.save_for_backward(h, w, bias, labels, lse)
        ctx.num_buckets = num_buckets
        ctx.mark_non_differentiable(lse)
        return loss, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        h, w, bias, labels, lse = ctx.saved_tensors
        _, bwd = _DENSE_PATHS[_kind(h)]
        g = g.to(torch.float32).contiguous()
        need_dh = ctx.needs_input_grad[0]
        with counting.launch("dense_bwd", _dense_work(h, w, bias, labels,
                                                      True, need_dh)):
            dh, dw, db = bwd(h, w, bias, labels, lse, g, ctx.num_buckets,
                             need_dh=need_dh)
        return dh, dw, db, None, None


# (family, path) -> (forward, backward) of ``_SparseXent``: the kernels
# on the card, their stand-ins on fake tensors; on the CPU the gather
# family's plain versions (the ELL family's CPU path is autograd through
# its plain version)
_SPARSE_PATHS = {("ell", "cuda"): (ell_fwd_cuda, ell_bwd_cuda),
                 ("gather", "cuda"): (gather_fwd_cuda, gather_bwd_cuda),
                 ("gather", "cpu"): (fused_xent_ell_plain, gather_bwd_plain),
                 ("ell", "fake"): (_forward_fake, sparse_bwd_fake),
                 ("gather", "fake"): (_forward_fake, sparse_bwd_fake)}


def _sparse_work(family, cols, w, bias, labels, backward=False):
    (n, j), r = cols.shape, labels.shape[1]
    return work(family, n, w.shape[0], r, w.shape[1] // r, j=j,
                backward=backward, bias=bias is not None)


class _SparseXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cols, vals, w, bias, labels, num_buckets, family):
        fwd, _ = _SPARSE_PATHS[family, _kind(cols)]
        with counting.launch(f"{family}_fwd",
                             _sparse_work(family, cols, w, bias, labels)):
            loss, lse = fwd(cols, vals, w, bias, labels, num_buckets)
        ctx.save_for_backward(cols, vals, w, bias, labels, lse)
        ctx.num_buckets, ctx.family = num_buckets, family
        ctx.mark_non_differentiable(lse)
        return loss, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        cols, vals, w, bias, labels, lse = ctx.saved_tensors
        _, bwd = _SPARSE_PATHS[ctx.family, _kind(cols)]
        g = g.to(torch.float32).contiguous()
        with counting.launch(f"{ctx.family}_bwd", _sparse_work(
                ctx.family, cols, w, bias, labels, True)):
            dw, db = bwd(cols, vals, w, bias, labels, lse, g,
                         ctx.num_buckets)
        return None, None, dw, db, None, None, None


def _contig(*ts):
    return [None if t is None else t.contiguous() for t in ts]


def _no_path(device):
    return ValueError(f"no fused xent path for device {device}")


# ---------------------------------------------------------------------------
# the three families
# ---------------------------------------------------------------------------

def mach_fused_xent_dense(h: torch.Tensor, w: torch.Tensor,
                          bias: Optional[torch.Tensor], labels: torch.Tensor,
                          num_buckets: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """h (N, d), w (d, R·B), bias (R·B,) or None — all float32 or all
    bfloat16 — and labels (N, R) int32 -> (loss (N,), lse (N, R)) float32.
    Differentiable wrt h, w and bias; gradients in the inputs' dtype."""
    check_dense(h, w, bias, labels, num_buckets)
    if _kind(h) in _DENSE_PATHS:
        return _DenseXent.apply(*_contig(h, w, bias, labels), num_buckets)
    if h.device.type == "cpu":
        with counting.launch("dense_fwd", _dense_work(h, w, bias, labels)):
            return fused_xent_dense_plain(h, w, bias, labels, num_buckets)
    raise _no_path(h.device)


def _sparse(family, cols, vals, w, bias, labels, num_buckets):
    check_ell(cols, vals, w, bias, labels, num_buckets)
    if (family, _kind(cols)) in _SPARSE_PATHS:
        return _SparseXent.apply(*_contig(cols, vals.detach(), w, bias, labels),
                                 num_buckets, family)
    if cols.device.type == "cpu":
        with counting.launch(f"{family}_fwd",
                             _sparse_work(family, cols, w, bias, labels)):
            return fused_xent_ell_plain(cols, vals, w, bias, labels,
                                        num_buckets)
    raise _no_path(cols.device)


def mach_fused_xent_ell(cols: torch.Tensor, vals: torch.Tensor,
                        w: torch.Tensor, bias: Optional[torch.Tensor],
                        labels: torch.Tensor, num_buckets: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded-ELL cols (N, J) int32 / vals (N, J) f32 -> (loss, lse)
    through row-tile blocks (the low-nnz family).  Differentiable wrt w
    and bias; vals get no gradient."""
    return _sparse("ell", cols, vals, w, bias, labels, num_buckets)


def mach_fused_xent_gather(cols: torch.Tensor, vals: torch.Tensor,
                           w: torch.Tensor, bias: Optional[torch.Tensor],
                           labels: torch.Tensor, num_buckets: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function as ``mach_fused_xent_ell``, one example row a
    block (the high-nnz family)."""
    return _sparse("gather", cols, vals, w, bias, labels, num_buckets)
