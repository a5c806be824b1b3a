"""The port's fused projection + R-head CE (``kernels/mach_fused_xent.py``
and ``ops.mach_fused_xent(_csr)``) on the CPU against the JAX package's
oracles ``repro.kernels.ref.mach_fused_xent_ref`` /
``mach_fused_xent_csr_ref`` and ``jax.grad`` of them (the Pallas module
``repro.kernels.mach_fused_xent`` does not import under jax 0.9.0).

Same numpy inputs to both; loss and gradients agree at rtol 1e-5 (atol
1e-6 for gradient entries near zero: f32 sums in another order).  Cases
mirror the JAX suite's: bias and none, a head wider than a kernel tile,
B not a multiple of 32, duplicate ids, ragged and empty rows, nnz on
both sides of GATHER_NNZ_THRESHOLD.  The gather family's backward is
also held step by step: its column order (the batch's pairs for each
feature in (row, slot) order) against a numpy walk, exactly, and the dW
and dbias it sums from the dlogits against ``jax.grad``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import mach_fused_xent as mfx
from repro_torch.kernels import ops, ref

RTOL, ATOL = 1e-5, 1e-6


def _head(rng, d, r, b, bias):
    w = (rng.normal(size=(d, r * b)) / np.sqrt(d)).astype(np.float32)
    bb = (0.1 * rng.normal(size=(r * b,))).astype(np.float32) if bias else None
    return w, bb


def _labels(rng, n, r, b):
    return rng.integers(0, b, size=(n, r)).astype(np.int32)


def _csr(rng, n, d, nnz_max, empty_row=True):
    """Ragged CSR: row 0 at exactly nnz_max with duplicate ids, a short
    row, an empty row (if asked), the rest random lengths."""
    lengths = rng.integers(1, nnz_max + 1, size=n)
    lengths[0] = nnz_max
    lengths[1] = min(2, nnz_max)
    if empty_row:
        lengths[2] = 0
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    indices = rng.integers(0, d, size=int(indptr[-1])).astype(np.int32)
    indices[1:4] = indices[0]                       # duplicates in row 0
    values = rng.uniform(0.05, 1.0, size=indices.shape).astype(np.float32)
    return indptr, indices, values


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,d,r,b", [(13, 40, 5, 16),    # several heads a tile
                                     (7, 24, 2, 300),    # head wider than a tile
                                     (9, 33, 3, 37)])    # B not a multiple of 32
def test_dense_loss_and_grads_match_ref(n, d, r, b, bias):
    rng = np.random.default_rng(n * d + b)
    h = rng.normal(size=(n, d)).astype(np.float32)
    w, bb = _head(rng, d, r, b, bias)
    y = _labels(rng, n, r, b)
    g = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)

    def jloss(h_, w_, b_):
        return jnp.sum(jref.mach_fused_xent_ref(h_, w_, jnp.asarray(y), b, b_)
                       * g)

    jh, jw, jb = _j(h, w, bb)
    want = jref.mach_fused_xent_ref(jh, jw, jnp.asarray(y), b, jb)
    argnums = (0, 1, 2) if bias else (0, 1)
    jgrads = jax.grad(jloss, argnums=argnums)(jh, jw, jb)

    th, tw, tb = _t(h, w, bb)
    leaves = [th, tw] + ([tb] if bias else [])
    for t in leaves:
        t.requires_grad_(True)
    got = ops.mach_fused_xent(th, tw, torch.from_numpy(y), num_buckets=b,
                              bias=tb)
    _close(got, want)
    tgrads = torch.autograd.grad((got * torch.from_numpy(g)).sum(), leaves)
    for tg, jg in zip(tgrads, jgrads):
        _close(tg, jg)
    # the port's own oracle agrees with the JAX one
    _close(ref.mach_fused_xent_ref(th, tw, torch.from_numpy(y), b, tb), want)


def test_dense_family_returns_lse_and_keeps_leading_dims():
    rng = np.random.default_rng(1)
    h = rng.normal(size=(2, 3, 16)).astype(np.float32)
    w, _ = _head(rng, 16, 4, 8, False)
    y = _labels(rng, 6, 4, 8)
    th, tw = _t(h, w)
    loss = ops.mach_fused_xent(th, tw, torch.from_numpy(y.reshape(2, 3, 4)),
                               num_buckets=8)
    assert tuple(loss.shape) == (2, 3)
    flat, lse = mfx.mach_fused_xent_dense(th.reshape(6, 16), tw, None,
                                          torch.from_numpy(y), 8)
    logits = jnp.asarray(h.reshape(6, 16)) @ jnp.asarray(w)
    want_lse = jax.nn.logsumexp(logits.reshape(6, 4, 8), axis=-1)
    _close(lse, want_lse)
    assert not lse.requires_grad
    np.testing.assert_array_equal(flat.numpy(), loss.reshape(6).numpy())


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("impl", ["densify", "gather"])
@pytest.mark.parametrize("n,d,r,b,nnz_max", [(12, 300, 4, 32, 24),
                                             (5, 2000, 3, 37, 600)])
def test_csr_loss_and_grads_match_ref(n, d, r, b, nnz_max, impl, bias):
    rng = np.random.default_rng(n + d + nnz_max)
    indptr, indices, values = _csr(rng, n, d, nnz_max)
    w, bb = _head(rng, d, r, b, bias)
    y = _labels(rng, n, r, b)
    g = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)
    jip, jix, jv, jw, jb = _j(indptr, indices, values, w, bb)

    def jloss(w_, b_):
        return jnp.sum(jref.mach_fused_xent_csr_ref(
            jip, jix, jv, w_, jnp.asarray(y), b, b_) * g)

    want = jref.mach_fused_xent_csr_ref(jip, jix, jv, jw, jnp.asarray(y), b, jb)
    jgrads = jax.grad(jloss, argnums=(0, 1) if bias else (0,))(jw, jb)

    tip, tix, tv, tw, tb = _t(indptr, indices, values, w, bb)
    tv.requires_grad_(True)
    leaves = [tw] + ([tb] if bias else [])
    for t in leaves:
        t.requires_grad_(True)
    got = ops.mach_fused_xent_csr(tip, tix, tv, tw, torch.from_numpy(y),
                                  num_buckets=b, nnz_max=nnz_max, bias=tb,
                                  sparse_impl=impl)
    _close(got, want)
    tgrads = torch.autograd.grad((got * torch.from_numpy(g)).sum(), leaves)
    for tg, jg in zip(tgrads, jgrads):
        _close(tg, jg)
    # values are data: no gradient reaches them
    assert tv.grad is None
    _close(ref.mach_fused_xent_csr_ref(tip, tix, tv, tw, torch.from_numpy(y),
                                       b, tb), want)


def test_values_get_no_gradient():
    rng = np.random.default_rng(3)
    indptr, indices, values = _csr(rng, 6, 50, 8)
    w, _ = _head(rng, 50, 2, 8, False)
    tip, tix, tv, tw = _t(indptr, indices, values, w)
    tv.requires_grad_(True)
    tw.requires_grad_(True)
    loss = ops.mach_fused_xent_csr(tip, tix, tv, tw,
                                   torch.from_numpy(_labels(rng, 6, 2, 8)),
                                   num_buckets=8, nnz_max=8).sum()
    loss.backward()
    assert tv.grad is None and tw.grad is not None


def test_csr_to_ell_pads_and_densifies_like_the_oracle():
    rng = np.random.default_rng(4)
    indptr, indices, values = _csr(rng, 7, 30, 6)
    tip, tix, tv = _t(indptr, indices, values)
    cols, vals = ops.csr_to_ell(tip, tix, tv, 9, 30)
    assert cols.dtype == torch.int32 and tuple(cols.shape) == (7, 9)
    lengths = np.diff(indptr)
    for row, length in enumerate(lengths):
        assert (cols[row, length:] == 30).all() and (vals[row, length:] == 0).all()
    dense = torch.zeros(7, 31).scatter_add_(1, cols.long(), vals)[:, :30]
    want = jref.csr_densify_ref(*_j(indptr, indices, values), 30)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=1e-6)
    empty_cols, empty_vals = ops.csr_to_ell(
        torch.zeros(4, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0), 5, 30)
    assert (empty_cols == 30).all() and not empty_vals.any()


def test_undersized_nnz_max_raises():
    rng = np.random.default_rng(5)
    indptr, indices, values = _csr(rng, 4, 40, 10)
    tip, tix, tv = _t(indptr, indices, values)
    with pytest.raises(ValueError, match="nnz_max=9 < longest CSR row"):
        ops.csr_to_ell(tip, tix, tv, 9, 40)
    w, _ = _head(rng, 40, 2, 8, False)
    with pytest.raises(ValueError, match="longest CSR row"):
        ops.mach_fused_xent_csr(tip, tix, tv, torch.from_numpy(w),
                                torch.from_numpy(_labels(rng, 4, 2, 8)),
                                num_buckets=8, nnz_max=9)


@pytest.mark.parametrize("nnz_max,impl,want", [
    (mfx.GATHER_NNZ_THRESHOLD - 1, None, "ell"),
    (mfx.GATHER_NNZ_THRESHOLD, None, "gather"),
    (mfx.GATHER_NNZ_THRESHOLD, "densify", "ell"),
    (8, "gather", "gather")])
def test_sparse_impl_routing(monkeypatch, nnz_max, impl, want):
    calls = {"ell": 0, "gather": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(mfx, "mach_fused_xent_ell",
                        counting("ell", mfx.mach_fused_xent_ell))
    monkeypatch.setattr(mfx, "mach_fused_xent_gather",
                        counting("gather", mfx.mach_fused_xent_gather))
    rng = np.random.default_rng(6)
    indptr, indices, values = _csr(rng, 3, 700, 8)
    w, _ = _head(rng, 700, 2, 4, False)
    ops.mach_fused_xent_csr(*_t(indptr, indices, values, w),
                            torch.from_numpy(_labels(rng, 3, 2, 4)),
                            num_buckets=4, nnz_max=nnz_max, sparse_impl=impl)
    assert calls == {"ell": int(want == "ell"), "gather": int(want == "gather")}
    with pytest.raises(ValueError, match="sparse_impl"):
        ops.mach_fused_xent_csr(*_t(indptr, indices, values, w),
                                torch.from_numpy(_labels(rng, 3, 2, 4)),
                                num_buckets=4, nnz_max=8, sparse_impl="onehot")


def test_bad_operands_and_unported_knobs_raise():
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    w = torch.from_numpy(_head(rng, 8, 2, 4, False)[0])
    y = torch.from_numpy(_labels(rng, 3, 2, 4))
    with pytest.raises(ValueError, match="float32"):
        ops.mach_fused_xent(h.double(), w.double(), y, num_buckets=4)
    with pytest.raises(ValueError, match=r"w \(8, 8\) != \(8, 2\*3\)"):
        ops.mach_fused_xent(h, w, y, num_buckets=3)
    with pytest.raises(ValueError, match="bias"):
        ops.mach_fused_xent(h, w, y, num_buckets=4, bias=torch.zeros(3))
    # bucket_select is ported: a c_sel below 1 is refused, as the JAX
    # package's mach_select_buckets_ref refuses it
    with pytest.raises(ValueError, match="c_sel"):
        ops.mach_fused_xent(h, w, y, num_buckets=4, bucket_select=(0, 1))
    with pytest.raises(ValueError, match="c_sel"):
        ops.mach_fused_xent_csr(torch.tensor([0, 1], dtype=torch.int32),
                                torch.tensor([0], dtype=torch.int32),
                                torch.ones(1), w, y[:1], num_buckets=4,
                                nnz_max=1, bucket_select=(0, 1),
                                bucket_proxy=torch.zeros(2, 4))


def test_padded_slots_are_never_read():
    """A padded slot's col id d lies outside W: the plain family masks it
    (as the kernels skip it) instead of indexing W[d]."""
    rng = np.random.default_rng(8)
    w, bb = _head(rng, 10, 2, 4, True)
    cols = torch.tensor([[3, 10, 10], [10, 10, 10]], dtype=torch.int32)
    vals = torch.tensor([[0.5, 0.0, 0.0], [0.0, 0.0, 0.0]])
    y = torch.from_numpy(_labels(rng, 2, 2, 4))
    loss, _ = mfx.mach_fused_xent_ell(cols, vals, *_t(w, bb), y, 4)
    dense = torch.zeros(2, 10)
    dense[0, 3] = 0.5
    want = ref.mach_fused_xent_ref(dense, *_t(w), y, 4, torch.from_numpy(bb))
    np.testing.assert_allclose(loss.numpy(), want.numpy(), rtol=RTOL)


# ---------------------------------------------------------------------------
# bfloat16 operands: the JAX kernel upcasts h, W and bias to float32 before
# the product, sums in float32 and casts the gradients back; so do the
# port's plain version and its kernel.  Both sides here sum the same exact
# bf16 products in float32: loss and lse at rtol 1e-5, and each gradient
# entry, rounded from float32 sums a few ulps apart, within one bf16 ulp.
# ---------------------------------------------------------------------------

def _bf16(*arrays):
    """Round float32 numpy arrays to bf16 once: torch tensors, and the same
    values as jnp bfloat16 arrays."""
    ts = [None if a is None else torch.from_numpy(a).to(torch.bfloat16)
          for a in arrays]
    js = [None if t is None else jnp.asarray(t.float().numpy(), jnp.bfloat16)
          for t in ts]
    return ts, js


def _bf16_ulp(x):
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _within_one_bf16_ulp(got, want):
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(np.array(want, np.float32))
    assert torch.all((got.float() - want).abs() <= _bf16_ulp(want))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,d,r,b", [(13, 40, 5, 16), (7, 24, 2, 300),
                                     (9, 33, 3, 37)])
def test_dense_bf16_loss_and_grads_match_ref(n, d, r, b, bias):
    rng = np.random.default_rng(n * d + b + 1)
    h = rng.normal(size=(n, d)).astype(np.float32)
    w, bb = _head(rng, d, r, b, bias)
    y = _labels(rng, n, r, b)
    g = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)
    (th, tw, tb), (jh, jw, jb) = _bf16(h, w, bb)

    def jloss(h_, w_, b_):
        return jnp.sum(jref.mach_fused_xent_ref(h_, w_, jnp.asarray(y), b, b_)
                       * g)

    want = jref.mach_fused_xent_ref(jh, jw, jnp.asarray(y), b, jb)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2) if bias else (0, 1))(jh, jw, jb)
    leaves = [th, tw] + ([tb] if bias else [])
    for t in leaves:
        t.requires_grad_(True)
    for fn in (lambda: ops.mach_fused_xent(th, tw, torch.from_numpy(y),
                                           num_buckets=b, bias=tb),
               lambda: mfx.fused_xent_dense_plain(th, tw, tb,
                                                  torch.from_numpy(y), b)[0]):
        got = fn()
        assert got.dtype == torch.float32
        _close(got, want)
        tgrads = torch.autograd.grad((got * torch.from_numpy(g)).sum(), leaves)
        for tg, jg in zip(tgrads, jgrads):
            _within_one_bf16_ulp(tg, jg.astype(jnp.float32))
    _, lse = mfx.mach_fused_xent_dense(th, tw, tb, torch.from_numpy(y), b)
    logits = jh.astype(jnp.float32) @ jw.astype(jnp.float32)
    if bias:
        logits = logits + jb.astype(jnp.float32)
    _close(lse, jax.nn.logsumexp(logits.reshape(n, r, b), axis=-1))


def test_dense_bf16_upcasts_before_the_product():
    """At d = 1024 logits formed in bf16 miss the float32 reference by more
    than 10x rtol 1e-5; the port's upcast product does not."""
    rng = np.random.default_rng(11)
    n, d, r, b = 16, 1024, 4, 64
    h = rng.normal(size=(n, d)).astype(np.float32)
    w, bb = _head(rng, d, r, b, True)
    y = _labels(rng, n, r, b)
    (th, tw, tb), (jh, jw, jb) = _bf16(h, w, bb)
    want = np.asarray(jref.mach_fused_xent_ref(jh, jw, jnp.asarray(y), b, jb))
    ty = torch.from_numpy(y)
    got = ops.mach_fused_xent(th, tw, ty, num_buckets=b, bias=tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    bf16_logits = (th @ tw + tb).float()          # what the upcast avoids
    lg = bf16_logits.reshape(n, r, b)
    missed = (torch.logsumexp(lg, -1) - torch.gather(
        lg, -1, ty.long()[..., None])[..., 0]).sum(-1)
    assert np.max(np.abs(missed.numpy() - want) / np.abs(want)) > 10 * RTOL


@pytest.mark.parametrize("dtypes", [
    (torch.float16, torch.float16, torch.float16),      # float16
    (torch.bfloat16, torch.float32, None),             # h bf16, W f32
    (torch.float32, torch.bfloat16, None),             # h f32, W bf16
    (torch.bfloat16, torch.bfloat16, torch.float32)])  # bias f32
def test_dense_float16_and_mixed_dtypes_raise(dtypes):
    rng = np.random.default_rng(12)
    h = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    w, bb = _t(*_head(rng, 8, 2, 4, True))
    y = torch.from_numpy(_labels(rng, 3, 2, 4))
    hd, wd, bd = dtypes
    bias = None if bd is None else bb.to(bd)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.mach_fused_xent(h.to(hd), w.to(wd), y, num_buckets=4, bias=bias)


# ---------------------------------------------------------------------------
# the gather family's backward in its kernel's three steps (plain versions,
# which its CPU path runs): dlogits, the batch in column order, dW row by
# row from the dlogits
# ---------------------------------------------------------------------------

def _column_walk(cols, vals, d):
    """Numpy: for each feature f in turn, its (row, val) pairs in
    ascending (row, slot) order; ids outside [0, d) dropped."""
    colptr, rows, out = [0], [], []
    for f in range(d):
        for n in range(cols.shape[0]):
            for t in range(cols.shape[1]):
                if cols[n, t] == f:
                    rows.append(n)
                    out.append(vals[n, t])
        colptr.append(len(rows))
    return (np.array(colptr, np.int32), np.array(rows, np.int32),
            np.array(out, np.float32))


@pytest.mark.parametrize("n,d,j", [(7, 12, 9), (5, 40, 30), (1, 3, 4)])
def test_column_order_matches_a_numpy_walk(n, d, j):
    """Duplicate ids in a row, ragged and empty rows, padding (id d, and
    a negative id), a column touched by every row and columns by one."""
    rng = np.random.default_rng(n * d + j)
    cols = rng.integers(0, d, size=(n, j)).astype(np.int32)
    vals = rng.uniform(0.05, 1.0, size=(n, j)).astype(np.float32)
    lengths = rng.integers(0, j + 1, size=n)
    lengths[0] = j
    if n > 2:
        lengths[1], lengths[2] = 0, 1
    cols[:, 0] = 0                                 # touched by every row
    cols[0, 1:3] = cols[0, 0]                      # duplicates in row 0
    pad = np.arange(j)[None, :] >= lengths[:, None]
    cols[pad], vals[pad] = d, 0.0
    if n > 3:
        cols[3, 0] = -1                            # outside [0, d): padding
    colptr, rows, tvals = mfx.gather_column_order_plain(*_t(cols, vals), d)
    want = _column_walk(cols, vals, d)
    np.testing.assert_array_equal(colptr.numpy(), want[0])
    np.testing.assert_array_equal(rows.numpy(), want[1])
    np.testing.assert_array_equal(tvals.numpy(), want[2])
    assert colptr.dtype == rows.dtype == torch.int32


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("nnz_max", [mfx.GATHER_NNZ_THRESHOLD - 488,
                                     mfx.GATHER_NNZ_THRESHOLD + 88])
def test_column_ordered_dw_matches_jax_grad(nnz_max, bias):
    """dW and dbias from the dlogits through the column order, against
    jax.grad of the JAX oracle on the same numpy inputs, for nnz on both
    sides of GATHER_NNZ_THRESHOLD; and gather_bwd_plain, which composes
    the three steps, returns the same."""
    n, d, r, b = 9, 700, 3, 37
    rng = np.random.default_rng(nnz_max + int(bias))
    indptr, indices, values = _csr(rng, n, d, nnz_max)
    w, bb = _head(rng, d, r, b, bias)
    y = _labels(rng, n, r, b)
    g = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)
    jip, jix, jv, jw, jb = _j(indptr, indices, values, w, bb)

    def jloss(w_, b_):
        return jnp.sum(jref.mach_fused_xent_csr_ref(
            jip, jix, jv, w_, jnp.asarray(y), b, b_) * g)

    jgrads = jax.grad(jloss, argnums=(0, 1) if bias else (0,))(jw, jb)
    tip, tix, tv, tw, tb = _t(indptr, indices, values, w, bb)
    cols, vals = ops.csr_to_ell(tip, tix, tv, nnz_max, d)
    ty, tg = torch.from_numpy(y), torch.from_numpy(g)
    _, lse = mfx.fused_xent_ell_plain(cols, vals, tw, tb, ty, b)
    dlogits = mfx.gather_dlogits_plain(cols, vals, tw, tb, ty, lse, tg, b)
    dw, db = mfx.gather_dw_plain(*mfx.gather_column_order_plain(cols, vals, d),
                                 dlogits)
    _close(dw, jgrads[0])
    if bias:
        _close(db, jgrads[1])
    composed = mfx.gather_bwd_plain(cols, vals, tw, tb, ty, lse, tg, b)
    assert torch.equal(composed[0], dw)
    assert (composed[1] is None) == (not bias)


def test_python_constants_match_csrc():
    """The gather wrapper sizes its heavy-row list from kHeavyTerms."""
    src = (Path(mfx.__file__).resolve().parent / "csrc"
           / "mach_fused_xent_gather.cu").read_text()
    want = int(re.search(r"constexpr int kHeavyTerms = (\d+);", src).group(1))
    assert mfx._HEAVY_TERMS == want
