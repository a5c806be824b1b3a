"""The CUDA kernels (decode, both mappings of the top-1 kernel; candidate
decode, every path of bucket top-m; fused projection + CE,
forward and backward; the R-head CE on given logits, forward and
backward; the RG-LRU scan and flash attention, forward and backward)
against their plain versions, on the card, and one full-width
recurrentgemma-2b request through the serving engine.  Gradients at
rtol 1e-4 / atol 1e-6: the dense and ELL kernels reduce dW, dh and dbias
with float atomics, in another order than the plain version (and from
run to run); the gather backward sums each dW row and dbias in a fixed
order of its own, so two runs return the same bits, and rows the batch
does not touch are written as zeros (dW comes from torch.empty).  The
dense kernel's float32 case is held to the plain version run in float64
(at N(0, 1) features cuBLAS's float32 plain version is itself outside
atol 1e-6); its bf16 case keeps loss and lse at rtol 1e-5 and
holds each gradient tensor's largest error to 2^-7 of its largest entry
and its relative L2 error to 2^-8 (the kernel rounds dlogits to bf16
before its products).  The RG-LRU scan
equals its plain version bit for bit (forward and backward, at the
prefill's and training's full widths, ragged T and D, every copy unit of
its layout, both stage lengths); flash attention matches at rtol
1e-5 / atol 1e-6 in float32 and, in bfloat16, within 2 bf16 ulps of
each (query, head) row's largest output: the scores' float32 sums run
in another order, so an e may round to the other bf16 neighbour, which
moves the whole row by p·|v|·2^-8.  The R-head CE: loss and float32
gradient at rtol 1e-5, a bf16 gradient within one bf16 ulp (float32
results a few ulps apart may round to neighbouring bf16 values).  The
scan's backward equals its plain reverse loop bit for bit; flash
attention's backward matches its plain version at rtol 1e-4 / atol 1e-5
in float32 (P recomputed from the saved lse, sums in other orders) and
in bfloat16 within 2 bf16 ulps of each row's largest entry plus 2^-20 of
the tensor's largest entry: a query row that sees one key has P = 1 and
an exact dQ of zero, and what both compute there is float32 rounding
noise of dP − D (1e-8 against entries of 0.1), which no row scale bounds.

Marked ``cuda``: skips without a GPU.  Needs neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core.hashing import MultShiftFamily, inverted_table
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lru_scan as ls
from repro_torch.kernels import mach_candidates as mc
from repro_torch.kernels import mach_decode as md
from repro_torch.kernels import mach_fused_xent as mfx
from repro_torch.kernels import mach_topk as mt
from repro_torch.kernels import mach_xent as mx
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _dyadic(n, r, b, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 1025, (n, r, b), generator=gen,
                         device=dev).float() / 1024


@pytest.mark.parametrize("estimator", ["unbiased", "min", "median"])
@pytest.mark.parametrize("r,b,n,num_classes", [(25, 32, 11, 20011),
                                               (6, 4, 3, 3001)])
def test_topk_kernel_equals_plain(dev, r, b, n, num_classes, estimator):
    meta = _dyadic(n, r, b, dev, seed=r)
    fam = MultShiftFamily(b, r, 3)
    for hash_kw in ({"table": fam.table(num_classes, dev)},
                    {"inline_coeffs": fam.coeffs_tensor(dev),
                     "inline_shift": fam.shift}):
        before = mt.mach_topk_cuda.launches
        kv, ki = mt.mach_topk_cuda(meta, num_classes=num_classes, k=33,
                                   estimator=estimator, **hash_kw)
        pv, pi = mt.mach_topk_plain(meta, num_classes=num_classes, k=33,
                                    estimator=estimator, **hash_kw)
        assert mt.mach_topk_cuda.launches == before + 1
        assert torch.equal(kv, pv) and torch.equal(ki, pi)


def test_top1_kernel_equals_plain_and_ops_dispatch(dev):
    meta = _dyadic(13, 5, 8, dev, seed=4)
    fam = MultShiftFamily(8, 5, 1)
    table = fam.table(777, dev)
    kv, ki = md.mach_decode_cuda(meta, table, num_classes=777)
    pv, pi = md.mach_decode_plain(meta, table, num_classes=777)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    before = md.mach_decode_cuda.launches
    v, i = ops.mach_top1(meta, table, num_classes=777)
    assert md.mach_decode_cuda.launches == before + 1
    assert torch.equal(i, pi) and i.device.type == "cuda"


def test_wrappers_reject_bad_operands(dev):
    meta = _dyadic(2, 3, 8, dev)
    table = MultShiftFamily(8, 3).table(50, dev)
    with pytest.raises(ValueError, match="float32"):
        md.mach_decode_cuda(meta.double(), table, num_classes=50)
    with pytest.raises(ValueError, match="contiguous"):
        mt.mach_topk_cuda(meta.transpose(0, 1).contiguous().transpose(0, 1),
                          table, num_classes=50, k=3)
    with pytest.raises(ValueError, match="int32"):
        mt.mach_topk_cuda(meta, table.long(), num_classes=50, k=3)
    with pytest.raises(ValueError, match="different devices"):
        md.mach_decode_cuda(meta, table.cpu(), num_classes=50)


@pytest.mark.parametrize("m", [1, 3, 64])
def test_bucket_topm_kernel_equals_plain(dev, m):
    meta = (_dyadic(9, 7, 64, dev, seed=m) * 8).floor() / 8     # bulk ties
    before = mc.bucket_topm_cuda.launches
    kt, ki = mc.bucket_topm_cuda(meta, m)
    assert mc.bucket_topm_cuda.launches == before + 1
    pt, pi = mc.bucket_topm(meta, m)
    assert torch.equal(kt, pt) and torch.equal(ki, pi)


ODP_R, ODP_B, ODP_K = 25, 32, 105033


def _odp_hashes(dev):
    fam = MultShiftFamily(ODP_B, ODP_R, 1)
    table = fam.table(ODP_K, dev)
    return table, {"table": {"table": table},
                   "inline": {"inline_coeffs": fam.coeffs_tensor(dev),
                              "inline_shift": fam.shift}}


@pytest.mark.parametrize("mode", ["table", "inline"])
@pytest.mark.parametrize("n", [256, 64, 37, 33, 31, 1])
def test_top1_mappings_equal_plain(dev, n, mode):
    """Both mappings of kernel 1 (query per lane from N = 32, class per
    thread below) at ODP's shape: dyadic inputs exactly, random ones at
    rtol 1e-6 with indices equal except on near-ties."""
    table, hashes = _odp_hashes(dev)
    gen = torch.Generator(device=dev).manual_seed(n)
    random = torch.softmax(torch.randn((n, ODP_R, ODP_B), generator=gen,
                                       device=dev), -1)
    for meta in (_dyadic(n, ODP_R, ODP_B, dev, seed=n), random):
        before = md.mach_decode_cuda.launches
        kv, ki = md.mach_decode_cuda(meta, num_classes=ODP_K, **hashes[mode])
        assert md.mach_decode_cuda.launches == before + 1
        pv, pi = md.mach_decode_plain(meta, num_classes=ODP_K, **hashes[mode])
        if meta is not random:
            assert torch.equal(kv, pv) and torch.equal(ki, pi)
            continue
        torch.testing.assert_close(kv, pv, rtol=1e-6, atol=1e-7)
        at_kernel = md.summed_scores(meta, table).gather(1, ki.long()[:, None])
        torch.testing.assert_close(at_kernel[:, 0], pv, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [256, 31])
def test_top1_tie_across_splits_goes_to_lowest_id(dev, n):
    """Each row's maximum is shared by a class in an early K-split and
    one in the last ones (four query tiles at N = 256)."""
    table, hashes = _odp_hashes(dev)
    q = torch.arange(n, device=dev)
    low, high = 1000 + 211 * q, ODP_K - 1 - 97 * q
    meta = torch.zeros((n, ODP_R, ODP_B), device=dev)
    for k in (low, high):
        meta[q[:, None], torch.arange(ODP_R, device=dev)[None, :],
             table[:, k].T.long()] = 0.5
    for hash_kw in hashes.values():
        kv, ki = md.mach_decode_cuda(meta, num_classes=ODP_K, **hash_kw)
        assert torch.equal(ki.long(), low)
        assert torch.equal(kv, torch.full_like(kv, 0.5 * ODP_R))


TOPM_CASES = [(b, m) for b in (4, 32, 37, 512, 1000, 2048, 8192)
              for m in sorted({m for m in (1, 2, 3, 12, 16, 32, 33) if m <= b}
                              | {max(1, b - 1), b})]


def _topm_rows(dev, b):
    """Dyadic rows (ties in bulk), all-equal rows, and rows of dyadic
    values >= 0.75 among -0.0 and +0.0 (equal to the plain sort)."""
    dyadic = _dyadic(37, 3, b, dev, seed=b)
    gen = torch.Generator(device=dev).manual_seed(b)
    neg = torch.rand(dyadic.shape, generator=gen, device=dev) < 0.5
    zero = torch.where(neg, torch.full_like(dyadic, -0.0),
                       torch.zeros_like(dyadic))
    return (dyadic, torch.full_like(dyadic, 0.25),
            torch.where(dyadic >= 0.75, dyadic, zero))


@pytest.mark.parametrize("b,m", TOPM_CASES, ids=str)
def test_bucket_topm_paths_equal_plain(dev, b, m):
    """Every path of kernel 7 against the plain version on a host copy:
    tau bit for bit, ids equal."""
    for meta in _topm_rows(dev, b):
        before = mc.bucket_topm_cuda.launches
        kt, ki = mc.bucket_topm_cuda(meta, m)
        assert mc.bucket_topm_cuda.launches == before + 1
        pt, pi = mc.bucket_topm(meta.cpu(), m)
        assert torch.equal(kt.cpu().view(torch.int32), pt.view(torch.int32))
        assert torch.equal(ki.cpu(), pi)


@pytest.mark.parametrize("estimator", ["unbiased", "min", "median"])
@pytest.mark.parametrize("r,b,n,num_classes", [(25, 32, 5, 20011),
                                               (4, 4, 3, 3001)])
def test_candidate_kernel_equals_plain(dev, r, b, n, num_classes, estimator):
    meta = _dyadic(n, r, b, dev, seed=r + b)
    fam = MultShiftFamily(b, r, 2)
    table = fam.table(num_classes, dev)
    inv = inverted_table(table, b, device=dev)
    for m, t in ((1, 1), (2, 2), (b, r)):
        tau, ids = mc.bucket_topm(meta, m)
        for hash_kw in ({"table": table},
                        {"inline_coeffs": fam.coeffs_tensor(dev),
                         "inline_shift": fam.shift}):
            before = mc.mach_candidate_topk_cuda.launches
            got = mc.mach_candidate_topk_cuda(meta, tau, ids, inv,
                                              num_classes=num_classes, k=33,
                                              t=t, estimator=estimator,
                                              **hash_kw)
            assert mc.mach_candidate_topk_cuda.launches == before + 1
            want = mc.mach_candidate_topk_plain(meta, tau, ids, inv,
                                                num_classes=num_classes, k=33,
                                                t=t, estimator=estimator,
                                                **hash_kw)
            for a, c in zip(got, want):
                assert torch.equal(a, c)


def test_candidate_exact_mode_equals_streaming_kernel(dev):
    meta = _dyadic(7, 20, 512, dev, seed=5)
    fam = MultShiftFamily(512, 20, 4)
    table = fam.table(21841, dev)
    inv = inverted_table(table, 512, device=dev)
    for est in ("unbiased", "min", "median"):
        sv, si = ops.mach_topk(meta, table, num_classes=21841, k=10,
                               estimator=est)
        cv, ci = ops.mach_topk(meta, table, num_classes=21841, k=10,
                               estimator=est, candidate_mode=(512, 20),
                               inverted=inv)
        assert torch.equal(cv, sv) and torch.equal(ci, si)


# ---------------------------------------------------------------------------
# fused projection + R-head CE kernels (forward and backward)
# ---------------------------------------------------------------------------

def _xent_case(dev, n, d, r, b, bias, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((d, r * b), generator=gen, device=dev) / d ** 0.5
    bb = 0.1 * torch.randn((r * b,), generator=gen, device=dev) if bias else None
    y = torch.randint(0, b, (n, r), generator=gen, device=dev,
                      dtype=torch.int32)
    g = torch.rand((n,), generator=gen, device=dev) + 0.5
    return w, bb, y, g


def _ell(dev, n, d, j, seed=0):
    """ELL with a full row holding duplicate ids, a short row, an empty
    row and padding (col id d, val 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cols = torch.randint(0, d, (n, j), generator=gen, device=dev,
                         dtype=torch.int32)
    vals = torch.rand((n, j), generator=gen, device=dev)
    lengths = torch.randint(0, j + 1, (n,), generator=gen, device=dev)
    lengths[0], lengths[1], lengths[2] = j, 1, 0
    cols[0, 1:4] = cols[0, 0]
    pad = torch.arange(j, device=dev)[None, :] >= lengths[:, None]
    return cols.masked_fill(pad, d), vals.masked_fill(pad, 0.0)


def _grads(fn, leaves, g):
    loss, lse = fn()
    grads = torch.autograd.grad((loss * g).sum(), leaves)
    return loss, lse, grads


def _assert_xent_close(got, want):
    (gl, glse, gg), (wl, wlse, wg) = got, want
    torch.testing.assert_close(gl, wl, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(glse, wlse, rtol=1e-5, atol=1e-6)
    for a, c in zip(gg, wg):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-6)


def _assert_bf16_grads_close(got, want):
    """bf16 gradients: the kernel rounds dlogits to bf16 before its
    products (the plain version keeps them float32), so per tensor the
    largest error is at most 2^-7 of the largest entry and the relative L2
    error at most 2^-8."""
    for a, c in zip(got, want):
        assert a.dtype == c.dtype == torch.bfloat16
        err = (a.float() - c.float())
        assert float(err.abs().max()) <= 2.0 ** -7 * float(c.float().abs().max())
        assert float(err.norm()) <= 2.0 ** -8 * float(c.float().norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,d,r,b", [(70, 200, 25, 32), (9, 130, 3, 512),
                                     (33, 77, 7, 37), (29, 333, 7, 37),
                                     (130, 256, 2, 300)])
def test_dense_xent_kernel_equals_plain(dev, n, d, r, b, bias, dtype):
    """Float32 runs 3xTF32, bf16 the bf16 tensor cores; d = 77 and 333 and
    R·B = 259 and 600 put rows off 16-byte alignment (plain loads)."""
    w, bb, y, g = _xent_case(dev, n, d, r, b, bias)
    h = torch.randn((n, d), device=dev)
    h, w, bb = (None if t is None else t.to(dtype) for t in (h, w, bb))
    leaves = [t.requires_grad_(True) for t in (h, w, bb) if t is not None]
    before = (mfx.dense_fwd_cuda.launches, mfx.dense_bwd_cuda.launches)
    got = _grads(lambda: mfx.mach_fused_xent_dense(h, w, bb, y, b), leaves, g)
    assert (mfx.dense_fwd_cuda.launches, mfx.dense_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    if dtype == torch.float32:
        # the plain version in float64, rounded once: cuBLAS's float32
        # dW over N(0, 1) features is itself up to 4e-6 off (above atol
        # 1e-6 at entries that cancel), and 3xTF32 is no further off
        exact = [t.detach().double().requires_grad_(True) for t in leaves]
        want = _grads(lambda: mfx.fused_xent_dense_plain(
            *exact[:2], exact[2] if bias else None, y, b), exact, g.double())
        want = [want[0].float(), want[1].float(), [t.float() for t in want[2]]]
        _assert_xent_close(got, want)
    else:
        want = _grads(lambda: mfx.fused_xent_dense_plain(h, w, bb, y, b),
                      leaves, g)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
        _assert_bf16_grads_close(got[2], want[2])


def test_dense_xent_kernel_misaligned_view(dev):
    """A bf16 h and W at odd storage offsets (rows off 16-byte alignment)
    run the plain-load path and still equal the plain version."""
    n, d, r, b = 40, 64, 3, 48
    w, bb, y, g = _xent_case(dev, n, d, r, b, True)
    flat = torch.randn(n * d + 1, device=dev).to(torch.bfloat16)
    h = flat[1:].view(n, d)
    wflat = torch.empty(d * r * b + 1, device=dev, dtype=torch.bfloat16)
    wflat[1:].copy_(w.reshape(-1))
    w = wflat[1:].view(d, r * b)
    assert h.data_ptr() % 16 and w.data_ptr() % 16
    bb = bb.to(torch.bfloat16)
    leaves = [t.requires_grad_(True) for t in (h, w, bb)]
    got = _grads(lambda: mfx.mach_fused_xent_dense(h, w, bb, y, b), leaves, g)
    want = _grads(lambda: mfx.fused_xent_dense_plain(h, w, bb, y, b), leaves, g)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    _assert_bf16_grads_close(got[2], want[2])


@pytest.mark.parametrize("family", ["ell", "gather"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,d,r,b,j", [(37, 5000, 25, 32, 120),
                                       (6, 3000, 3, 37, 1024)])
def test_sparse_xent_kernels_equal_plain(dev, family, n, d, r, b, j, bias):
    w, bb, y, g = _xent_case(dev, n, d, r, b, bias, seed=j)
    cols, vals = _ell(dev, n, d, j, seed=j)
    leaves = [t.requires_grad_(True) for t in (w, bb) if t is not None]
    fn = getattr(mfx, f"mach_fused_xent_{family}")
    fwd, bwd = getattr(mfx, f"{family}_fwd_cuda"), getattr(mfx, f"{family}_bwd_cuda")
    before = (fwd.launches, bwd.launches)
    got = _grads(lambda: fn(cols, vals, w, bb, y, b), leaves, g)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    want = _grads(lambda: mfx.fused_xent_ell_plain(cols, vals, w, bb, y, b),
                  leaves, g)
    _assert_xent_close(got, want)


def _heavy_ell(dev, n, d, j, seed=0):
    """``_ell`` with feature 7 in a third of every row's slots (a dW row
    of hundreds of pairs, split across warps) and feature 11 in 70 of
    them (just past kHeavyTerms = 64), the rest spread over d."""
    cols, vals = _ell(dev, n, d, j, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    pick = torch.rand((n, j), generator=gen, device=dev) < 1 / 3
    cols = torch.where(pick & (cols < d), 7, cols)
    valid = torch.nonzero((cols < d) & (cols != 7))
    rows, slots = valid[:70, 0], valid[:70, 1]
    cols[rows, slots] = 11
    return cols, vals


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,d,r,b,j", [(37, 5000, 25, 32, 1024),
                                       (6, 3000, 3, 37, 600),
                                       (512, 20000, 25, 32, 1024),
                                       (1000, 3000, 3, 37, 64)])
def test_gather_backward_same_bits_twice(dev, n, d, r, b, j, bias):
    """No float atomics touch dW or dbias: two backward runs return the
    same bits, with heavy dW rows (kHeavyTerms) in the batch, at N up to
    1,000; and equal the plain version run in float64 at the sparse
    tolerance, under the mean loss's cotangent g / N (the training path's;
    a dW row of thousands of pairs carries float32 rounding of its partial
    sums)."""
    w, bb, y, g = _xent_case(dev, n, d, r, b, bias, seed=j + n)
    g = g / n
    cols, vals = _heavy_ell(dev, n, d, j, seed=j + n)
    _, lse = mfx.gather_fwd_cuda(cols, vals, w, bb, y, b)
    first = mfx.gather_bwd_cuda(cols, vals, w, bb, y, lse, g, b)
    second = mfx.gather_bwd_cuda(cols, vals, w, bb, y, lse, g, b)
    for got, again in zip(first, second):
        if got is not None:
            assert torch.equal(got, again)
    want = mfx.gather_bwd_plain(cols, vals.double(), w.double(),
                                None if bb is None else bb.double(), y,
                                lse.double(), g.double(), b)
    for got, ref in zip(first, want):
        if ref is not None:
            torch.testing.assert_close(got, ref.float(), rtol=1e-4, atol=1e-6)


def test_gather_backward_pieces_equal_plain(dev):
    """The backward's steps on the card against their plain versions:
    dlogits (rtol 1e-5: the logits' f32 sums run in another order), the
    column order exactly, and dW from the same dlogits against the plain
    version in float64 (rtol 1e-5), under the mean loss's g / N.  Each
    step's wrapper counts its own launch."""
    n, d, r, b, j = 64, 4000, 5, 32, 700
    w, bb, y, g = _xent_case(dev, n, d, r, b, True, seed=3)
    g = g / n
    cols, vals = _heavy_ell(dev, n, d, j, seed=3)
    _, lse = mfx.gather_fwd_cuda(cols, vals, w, bb, y, b)
    pieces = (mfx.gather_dlogits_cuda, mfx.gather_column_order_cuda,
              mfx.gather_dw_cuda)
    before = [fn.launches for fn in pieces]
    dlogits, keys, _ = mfx.gather_dlogits_cuda(cols, vals, w, bb, y, lse, g, b)
    torch.testing.assert_close(dlogits, mfx.gather_dlogits_plain(
        cols, vals, w, bb, y, lse, g, b), rtol=1e-5, atol=1e-6)
    colptr, rows, tvals = mfx.gather_column_order_cuda(keys, vals, d)
    want = mfx.gather_column_order_plain(cols, vals, d)
    m = int(want[0][-1])
    assert torch.equal(colptr, want[0])
    assert torch.equal(rows[:m], want[1]) and torch.equal(tvals[:m], want[2])
    dw = mfx.gather_dw_cuda(colptr, rows, tvals, dlogits)
    want_dw = mfx.gather_dw_plain(want[0], want[1], want[2].double(),
                                  dlogits.double())[0]
    torch.testing.assert_close(dw, want_dw.float(), rtol=1e-5, atol=1e-6)
    assert [fn.launches for fn in pieces] == [k + 1 for k in before]


def test_gather_backward_untouched_rows_are_zero_on_nan_memory(dev):
    """dW comes from torch.empty: rows the batch does not touch read
    exactly 0 even when the allocator hands back memory just filled with
    NaN, and the touched rows are finite."""
    n, d, r, b, j = 16, 6000, 25, 32, 600
    w, bb, y, g = _xent_case(dev, n, d, r, b, True, seed=5)
    cols, vals = _ell(dev, n, d, j, seed=5)
    _, lse = mfx.gather_fwd_cuda(cols, vals, w, bb, y, b)
    junk = torch.full((d, r * b), float("nan"), device=dev)
    junk_ptr = junk.data_ptr()
    del junk
    dw, db = mfx.gather_bwd_cuda(cols, vals, w, bb, y, lse, g, b)
    assert dw.data_ptr() == junk_ptr      # the NaN block came back as dW
    touched = torch.zeros(d, dtype=torch.bool, device=dev)
    touched[cols[cols < d].long()] = True
    assert torch.equal(dw[~touched], torch.zeros_like(dw[~touched]))
    assert bool(torch.isfinite(dw[touched]).all()) and bool(touched.any())
    assert bool(torch.isfinite(db).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d", [(1, 4096, 2560), (2, 4096, 2560),
                                   (2, 4097, 2570), (3, 37, 300),
                                   (4, 1, 2560), (2, 130, 301)])
def test_lru_scan_forward_and_backward_bit_for_bit(dev, b, t, d, dtype):
    """Kernel 9 at the prefill's and training's shapes, ragged T and D
    (every copy unit of ``scan_layout``: 16 bytes at D = 2560, 4 at 2570 in
    float32 and 300 in bf16, 2 at D = 301 in bf16) and a decode step:
    forward and backward equal their plain loops bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(t + d)
    a = (torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5).to(dtype)
    x = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
    h0 = torch.randn((b, d), generator=gen, device=dev)
    dh = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
    h = ls.lru_scan_cuda(a, x, h0)
    assert torch.equal(h, ls.lru_scan_plain(a, x, h0))
    got = ls.lru_scan_bwd_cuda(a, h, h0, dh)
    for gv, wv in zip(got, ls.lru_scan_bwd_plain(a, h, h0, dh)):
        assert gv.dtype == wv.dtype and torch.equal(gv, wv)


def test_fused_xent_wrappers_reject_bad_operands(dev):
    w, _, y, _ = _xent_case(dev, 4, 16, 2, 8, False)
    h = torch.randn((4, 16), device=dev)
    with pytest.raises(ValueError, match="float32"):
        mfx.mach_fused_xent_dense(h.half(), w, None, y, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mfx.mach_fused_xent_dense(h.bfloat16(), w, None, y, 8)
    with pytest.raises(ValueError, match="int32"):
        mfx.mach_fused_xent_dense(h, w, None, y.long(), 8)
    with pytest.raises(ValueError, match="different devices"):
        mfx.mach_fused_xent_dense(h, w.cpu(), None, y, 8)


# ---------------------------------------------------------------------------
# the LM substrate: RG-LRU scan (kernel 9), flash attention (kernel 10)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d", [(3, 37, 300), (4, 1, 2560), (1, 1000, 256)])
def test_lru_scan_kernel_equals_plain(dev, b, t, d, dtype):
    gen = torch.Generator(device=dev).manual_seed(t)
    a = (torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5).to(dtype)
    x = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
    h0 = torch.randn((b, d), generator=gen, device=dev)
    before = ls.lru_scan_cuda.launches
    got = ops.lru_scan(a, x, h0)
    assert ls.lru_scan_cuda.launches == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, ls.lru_scan_plain(a, x, h0))


def _bf16_row_ulp(x):
    """bf16 ulp at each (query, head) row's largest |value|."""
    _, e = torch.frexp(x.float().abs().amax(dim=-1, keepdim=True))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("b,t,h,kv,hd,window,dtype", [
    (1, 1024, 10, 1, 256, 512, torch.bfloat16),
    (1, 300, 10, 1, 256, None, torch.bfloat16),
    (2, 200, 8, 2, 128, None, torch.bfloat16),
    (1, 520, 32, 4, 64, None, torch.bfloat16),     # tinyllama: hd 64, G = 8
    (1, 300, 32, 32, 96, None, torch.bfloat16),    # phi3: hd 96 padded to 128
    (2, 77, 4, 1, 256, 20, torch.bfloat16),        # ragged T, windowed
    (1, 130, 4, 4, 32, 50, torch.float32),
])
def test_flash_attention_kernel_matches_plain(dev, b, t, h, kv, hd, window,
                                              dtype):
    gen = torch.Generator(device=dev).manual_seed(t)
    q = torch.randn((b, t, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, kv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, kv, hd), generator=gen, device=dev).to(dtype)
    before = fa.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, window=window)
    assert fa.flash_attention_cuda.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, window=window)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert torch.all((got.float() - want.float()).abs()
                         <= 2 * _bf16_row_ulp(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,r,b", [(13, 4, 16), (5, 3, 37), (70, 8, 2048)])
def test_mach_xent_kernels_equal_plain(dev, n, r, b, dtype):
    gen = torch.Generator(device=dev).manual_seed(n)
    logits = (torch.randn((n, r, b), generator=gen, device=dev) * 3).to(dtype)
    labels = torch.randint(0, b, (n, r), generator=gen, device=dev,
                           dtype=torch.int32)
    labels[0], labels[-1] = 0, b - 1
    g = torch.randn((n,), generator=gen, device=dev)
    before = (mx.mach_xent_cuda_fwd.launches, mx.mach_xent_cuda_bwd.launches)
    lg = logits.clone().requires_grad_(True)
    loss = ops.mach_xent(lg, labels)
    loss.backward(g)
    assert (mx.mach_xent_cuda_fwd.launches, mx.mach_xent_cuda_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(loss, mx.mach_xent_plain(logits, labels),
                               rtol=1e-5, atol=1e-5)
    want = mx.mach_xent_grad_plain(logits, labels, g)
    assert lg.grad.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(lg.grad, want, rtol=1e-5, atol=1e-7)
    else:
        assert torch.all((lg.grad.float() - want.float()).abs()
                         <= _bf16_ulp(want))


def _bf16_ulp(x):
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d", [(3, 37, 300), (4, 1, 2560), (1, 1000, 256)])
def test_lru_scan_backward_kernel_equals_plain(dev, b, t, d, dtype):
    gen = torch.Generator(device=dev).manual_seed(t + 1)
    a = (torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5).to(dtype)
    x = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
    h0 = torch.randn((b, d), generator=gen, device=dev)
    dh = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
    leaves = [z.clone().requires_grad_(True) for z in (a, x, h0)]
    before = ls.lru_scan_bwd_cuda.launches
    h = ops.lru_scan(*leaves)
    h.backward(dh)
    assert ls.lru_scan_bwd_cuda.launches == before + 1
    want = ls.lru_scan_bwd_plain(a, h.detach(), h0, dh)
    for got, w in zip((z.grad for z in leaves), want):
        assert got.dtype == w.dtype and torch.equal(got, w)


@pytest.mark.parametrize("b,t,h,kv,hd,causal,window,dtype", [
    (1, 1024, 10, 1, 256, True, 512, torch.bfloat16),
    (2, 200, 8, 2, 128, True, None, torch.bfloat16),
    (1, 260, 32, 4, 64, True, None, torch.bfloat16),     # tinyllama
    (1, 200, 32, 32, 96, True, None, torch.bfloat16),    # phi3, ragged T
    (2, 77, 10, 1, 256, True, 20, torch.bfloat16),       # ragged, windowed
    (1, 90, 2, 1, 48, False, None, torch.bfloat16),      # unmasked, hd 48
    (1, 130, 4, 4, 32, True, 50, torch.float32),
    (2, 100, 4, 2, 64, True, None, torch.float32),
    (1, 77, 10, 1, 16, True, 20, torch.float32),
    (1, 90, 2, 1, 48, False, None, torch.float32),
])
def test_flash_attention_backward_kernel_matches_plain(dev, b, t, h, kv, hd,
                                                       causal, window, dtype):
    gen = torch.Generator(device=dev).manual_seed(t + 2)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, t, h, hd), (b, t, kv, hd),
                                 (b, t, kv, hd), (b, t, h, hd)))
    out0 = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    out, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    assert torch.equal(out, out0)          # the lse output changes no bit
    _, lse_plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, return_lse=True)
    torch.testing.assert_close(lse, lse_plain, rtol=1e-5, atol=1e-5)
    leaves = [z.clone().requires_grad_(True) for z in (q, k, v)]
    before = fa.flash_attention_bwd_cuda.launches
    ops.flash_attention(*leaves, causal=causal, window=window).backward(do)
    assert fa.flash_attention_bwd_cuda.launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, causal=causal,
                                        window=window)
    for got, w in zip((z.grad for z in leaves), want):
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-5)
        else:
            tol = 2 * _bf16_row_ulp(w) + 2.0 ** -20 * w.float().abs().max()
            assert torch.all((got.float() - w.float()).abs() <= tol)


def test_lm_kernel_wrappers_reject_bad_operands(dev):
    q = torch.randn((1, 8, 2, 20), device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        fa.flash_attention_cuda(q, q[:, :, :1].contiguous(),
                                q[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_cuda(q.half(), q.half(), q.half())
    a = torch.rand((2, 4, 8), device=dev)
    with pytest.raises(ValueError, match="float32"):
        ls.lru_scan_cuda(a, a, torch.zeros((2, 8), device=dev).double())


def test_flash_attention_rejects_misaligned_bf16(dev):
    """A contiguous bfloat16 view at an odd storage offset is refused
    before the 16-byte loads of the tensor-core kernels can fault."""
    shape = (1, 64, 2, 64)
    n = 64 * 2 * 64
    flat = torch.randn(2 * n + 1, device=dev).to(torch.bfloat16)
    good = flat[:n].view(shape)
    bad = flat[1:n + 1].view(shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    launches = (fa.flash_attention_cuda.launches,
                fa.flash_attention_bwd_cuda.launches)
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_cuda(*args)
    out, lse = fa.flash_attention_cuda(good, good, good, return_lse=True)
    for o, d in ((bad, good), (out, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_bwd_cuda(good, good, good, o, d, lse)
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_bwd_cuda.launches) == \
        (launches[0] + 1, launches[1])
    torch.cuda.synchronize(dev)      # the context is still healthy


@pytest.mark.parametrize("n", [1, 4])
def test_lm_head_decode_kernels_equal_plain(dev, n):
    """Kernels 1 and 2 at recurrentgemma-2b's head (R=8, B=2048,
    K=256,000, inline multiply-shift hash): N=1 after a prefill, N=4 in
    the decode pool (3 queries a block and a ragged last block)."""
    from repro_torch.configs import get_config
    mach = get_config("recurrentgemma-2b").mach
    r, b, num_classes = mach.num_repetitions, mach.num_buckets, mach.num_classes
    meta = _dyadic(n, r, b, dev, seed=n)
    hash_kw = {"inline_coeffs": mach.family.coeffs_tensor(dev),
               "inline_shift": mach.family.shift}
    kv, ki = md.mach_decode_cuda(meta, num_classes=num_classes, **hash_kw)
    pv, pi = md.mach_decode_plain(meta, num_classes=num_classes, **hash_kw)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    for estimator in ("unbiased", "min", "median"):
        for k in (1, 50):
            kv, ki = mt.mach_topk_cuda(meta, num_classes=num_classes, k=k,
                                       estimator=estimator, **hash_kw)
            pv, pi = mt.mach_topk_plain(meta, num_classes=num_classes, k=k,
                                        estimator=estimator, **hash_kw)
            assert torch.equal(kv, pv) and torch.equal(ki, pi), (estimator, k)


def test_full_width_serve_one_request(dev):
    """recurrentgemma-2b at full width (random weights): one greedy
    request through the engine equals the direct greedy loop, and the
    path runs kernels 9 and 2 (and kernel 1 in the direct loop)."""
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    from repro_torch.kernels import mach_decode as md, mach_topk as mt

    model = LanguageModel(get_config("recurrentgemma-2b"))
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    prompt = list(range(11, 60))
    counts = (ls.lru_scan_cuda.launches, mt.mach_topk_cuda.launches)
    eng = ServingEngine(model, params, ServeConfig(max_len=128, num_slots=1,
                                                   max_new_tokens=4))
    eng.submit(Request(prompt=prompt))
    out = eng.run()[0]
    assert ls.lru_scan_cuda.launches > counts[0]
    assert mt.mach_topk_cuda.launches > counts[1]
    before = md.mach_decode_cuda.launches
    caches, h = model.prefill(params, torch.tensor([prompt], device=dev), 128)
    toks = [int(model.next_token(params, h)[0][0])]
    for pos in range(len(prompt), len(prompt) + 3):
        caches, h = model.decode_step(params, caches,
                                      torch.tensor(toks[-1:], device=dev),
                                      torch.tensor([pos], device=dev),
                                      per_slot=True)
        toks.append(int(model.next_token(params, h)[0][0]))
    assert md.mach_decode_cuda.launches > before
    assert list(out.tokens) == toks
