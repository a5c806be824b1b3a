"""The CUDA kernels (decode, both mappings of the top-1 and top-k kernels;
candidate decode, every path of bucket top-m and kernel 8's layouts;
fused projection + CE, forward and backward, also at B' = c_sel over
bucket-selected columns (unselected columns' gradients exactly zero);
the R-head CE on given logits, forward and backward; the RG-LRU scan and
flash attention, forward and backward) against their plain versions, on
the card, one full-width recurrentgemma-2b request through the serving
engine, the OAA head (``OAAClassifier`` and the smoke LM's) on the
card as on the CPU, the paged KV cache's decode attention and write on
the card against the same calls on a CPU copy (GQA, MHA, MQA; float32
at rtol 1e-5, bf16 within 2 bf16 ulps of each row's largest output),
kernel 2 at tinyllama-1.1b's MACH head (K=32,000) exactly, and the MoE
block (``models/moe.apply_moe``) against its plain sequential version
``moe_ref`` and against itself on a CPU copy: expert ids and the kept
mask equal, y and the aux losses at rtol 1e-5 in float32, to a relative
L2 of 2^-8 in bf16.  Gradients at
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
Flash attention also runs non-causal with S != T (cross-attention) and
S == T (the encoder), forward and backward, at those tolerances; the
smoke xLSTM and enc-dec models run on the card against the CPU.  The
sharded train step on an NCCL world of one equals the single-device
step bit for bit.

Marked ``cuda``: skips without a GPU.  Needs neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

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


def _assert_topk_close(meta, table, kv, ki, pv, pi, est):
    """Random inputs: values at rtol 1e-6, indices equal except where the
    plain scores tie within it."""
    torch.testing.assert_close(kv, pv, rtol=1e-6, atol=1e-7)
    scores = mt.estimator_scores(meta, table, est)
    torch.testing.assert_close(scores.gather(1, ki.long()), pv, rtol=1e-6,
                               atol=1e-7)
    for row in ki.tolist():
        assert len(set(row)) == len(row)


@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("estimator", ["unbiased", "min", "median"])
@pytest.mark.parametrize("r,n", [(25, 256), (25, 37), (3, 64), (3, 33)])
def test_topk_query_per_lane_equals_plain(dev, r, n, estimator, k):
    """Kernel 2's query-per-lane mapping (N >= 32, k <= 32) at ODP's B and
    K, R = 25 and R = 3 (neither a multiple of the 4-repetition gather
    chunk, so the pad row is gathered: +0.0 for the sum, +inf for min and
    median), both hash sources (the median in table mode runs class per
    thread): dyadic inputs exactly, random ones at rtol 1e-6 with indices
    equal except on near-ties."""
    fam = MultShiftFamily(ODP_B, r, 1)
    table = fam.table(ODP_K, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(n + r)
    random = torch.softmax(torch.randn((n, r, ODP_B), generator=gen,
                                       device=dev), -1)
    for hash_kw in ({"table": table},
                    {"inline_coeffs": fam.coeffs_tensor(dev),
                     "inline_shift": fam.shift}):
        inline = "table" not in hash_kw
        want = "class_per_thread" if (estimator, inline) == ("median", False) \
            else "query_per_lane"
        assert mt.topk_layout(n, r, ODP_B, ODP_K, k, sms, estimator,
                              inline).mapping == want
        for meta in (_dyadic(n, r, ODP_B, dev, seed=n), random):
            before = mt.mach_topk_cuda.launches
            kv, ki = mt.mach_topk_cuda(meta, num_classes=ODP_K, k=k,
                                       estimator=estimator, **hash_kw)
            assert mt.mach_topk_cuda.launches == before + 1
            pv, pi = mt.mach_topk_plain(meta, num_classes=ODP_K, k=k,
                                        estimator=estimator, **hash_kw)
            if meta is random:
                _assert_topk_close(meta, table, kv, ki, pv, pi, estimator)
            else:
                assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.parametrize("estimator", ["unbiased", "min", "median"])
def test_topk_query_per_lane_ties_go_to_lowest_id(dev, estimator):
    """Rows whose best value two classes share, one in an early K-split
    and one in the last ones: the lowest id ranks first (k = 10)."""
    table, hashes = _odp_hashes(dev)
    n = 64
    q = torch.arange(n, device=dev)
    low, high = 1000 + 211 * q, ODP_K - 1 - 97 * q
    meta = torch.zeros((n, ODP_R, ODP_B), device=dev)
    for k in (low, high):
        meta[q[:, None], torch.arange(ODP_R, device=dev)[None, :],
             table[:, k].T.long()] = 0.5
    for hash_kw in hashes.values():
        kv, ki = mt.mach_topk_cuda(meta, num_classes=ODP_K, k=10,
                                   estimator=estimator, **hash_kw)
        pv, pi = mt.mach_topk_plain(meta, num_classes=ODP_K, k=10,
                                    estimator=estimator, **hash_kw)
        assert torch.equal(ki[:, :2].long(), torch.stack([low, high], 1))
        assert torch.equal(kv, pv) and torch.equal(ki, pi)


def test_topk_median_counts_network_runs(dev):
    """The query-per-lane median adds its sorting-network runs to the
    counter it is given: at least one a warp, at most one a class and
    query slot."""
    _, hashes = _odp_hashes(dev)
    meta = _dyadic(64, ODP_R, ODP_B, dev, seed=3)
    runs = torch.zeros(1, dtype=torch.int64, device=dev)
    mt.mach_topk_cuda(meta, num_classes=ODP_K, k=10, estimator="median",
                      network_runs=runs, **hashes["inline"])
    assert 0 < int(runs) <= 2 * ODP_K


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


@pytest.mark.parametrize("estimator", ["unbiased", "min", "median"])
@pytest.mark.parametrize("r,b,n,num_classes,m", [
    (25, 32, 5, 20011, 32),      # exact: only repetition 0's chunks walk
    (25, 32, 5, 20011, 2),
    (16, 8192, 3, 300007, 12),   # probabilities from global memory
    (16, 8192, 2, 300007, 8192)])
def test_candidate_kernel_layouts_equal_plain(dev, r, b, n, num_classes, m,
                                              estimator):
    """Kernel 8 at kcap 128 (four keys a lane) and 16, with the
    probabilities in shared and in global memory, dyadic inputs, both
    hash sources: values, bands and ids equal the plain version's."""
    meta = _dyadic(n, r, b, dev, seed=r + m)
    fam = MultShiftFamily(b, r, 2)
    table = fam.table(num_classes, dev)
    inv = inverted_table(table, b, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tau, ids = mc.bucket_topm(meta, m)
    for k in (100, 10):
        lay = mc.cand_layout(n, r, b, m, inv.shape[1], k, sms)
        assert lay.lane_keys == (4 if k == 100 else 1)
        assert lay.smem_probs == (b < 8192)
        for hash_kw in ({"table": table},
                        {"inline_coeffs": fam.coeffs_tensor(dev),
                         "inline_shift": fam.shift}):
            t = 2 if estimator != "unbiased" else 1
            got = mc.mach_candidate_topk_cuda(
                meta, tau, ids, inv, num_classes=num_classes, k=k, t=t,
                estimator=estimator, **hash_kw)
            want = mc.mach_candidate_topk_plain(
                meta, tau, ids, inv, num_classes=num_classes, k=k, t=t,
                estimator=estimator, **hash_kw)
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


# ---------------------------------------------------------------------------
# dynamic bucket selection: kernels 4-6 at B' = c_sel over gathered columns
# ---------------------------------------------------------------------------

def _selected_case(dev, n, d, r, b, c_sel, seed):
    """(w, bias, labels, g, selected): labels drawn from at most c_sel
    buckets a repetition, the selection the CPU takes from a random proxy
    (ids equal to the card's)."""
    w, bb, _, g = _xent_case(dev, n, d, r, b, True, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    proxy = torch.randn((r, b), generator=gen)
    pool = torch.stack([torch.randperm(b, generator=gen)[:c_sel]
                        for _ in range(r)])
    y = pool[torch.arange(r), torch.randint(0, c_sel, (n, r), generator=gen)]
    y = y.to(torch.int32)
    selected = ops.mach_select_buckets(proxy, y, num_buckets=b, c_sel=c_sel)
    on_card = ops.mach_select_buckets(proxy.to(dev), y.to(dev),
                                      num_buckets=b, c_sel=c_sel)
    assert torch.equal(on_card.cpu(), selected)
    return w, bb, y.to(dev), g, on_card


def _unselected_zero(grad_w, grad_b, selected, d, r, b):
    keep = torch.zeros((r, b), dtype=torch.bool, device=selected.device)
    keep[torch.arange(r, device=selected.device)[:, None], selected.long()] = True
    assert torch.all(grad_w.reshape(d, r, b)[:, ~keep] == 0)
    assert torch.all(grad_b.reshape(r, b)[~keep] == 0)


# A float32 gradient entry near zero is a sum of terms as large as the
# gradient's largest entry, and float32 sums err there by a few ulps of
# that scale: at (70, 200, 25, 32, 8), over 300 draws of h, kernel 4's
# dW is off its float64 plain version by up to 2.4e-6 (largest entries
# ~20) and its dbias (float atomics) by 9.5e-7 between two runs on the
# same inputs (tools/flake_kernel4.py, which also runs the plain version
# in float32).  A flat atol of 1e-6 sits inside that spread.
F32_GRAD_SCALE = 2.0 ** -20


def f32_grad_atol(want: torch.Tensor) -> float:
    """atol for a float32 gradient held to its float64 plain version."""
    return max(1e-6, F32_GRAD_SCALE * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,r,b,c_sel", [(70, 200, 25, 32, 8),
                                           (33, 77, 3, 512, 37),   # R·c odd
                                           (64, 256, 8, 2048, 512)])
def test_selected_dense_kernel_equals_plain(dev, n, d, r, b, c_sel, dtype):
    """Kernel 4 at B' = c_sel on the (d, R·c_sel) gathered columns (R·c_sel
    = 111 is odd: unaligned rows, plain loads), against its plain version
    on the same gathered columns (float32: run in float64); unselected
    columns of dW and dbias exactly zero."""
    w, bb, y, g, selected = _selected_case(dev, n, d, r, b, c_sel, seed=n)
    h = torch.randn((n, d), device=dev)
    h, w, bb = (t.to(dtype).requires_grad_(True) for t in (h, w, bb))
    before = (mfx.dense_fwd_cuda.launches, mfx.dense_bwd_cuda.launches)
    loss = ops.mach_fused_xent_selected(h, w, y, selected, num_buckets=b,
                                        bias=bb)
    got = torch.autograd.grad((loss * g).sum(), [h, w, bb])
    assert (mfx.dense_fwd_cuda.launches, mfx.dense_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    _unselected_zero(got[1].float(), got[2].float(), selected, d, r, b)
    up = torch.float64 if dtype == torch.float32 else dtype
    leaves = [t.detach().to(up).requires_grad_(True) for t in (h, w, bb)]
    wsel, bsel, pos = ops._apply_bucket_selection(leaves[1], leaves[2], y,
                                                  selected, b)
    want_loss, _ = mfx.fused_xent_dense_plain(leaves[0], wsel, bsel, pos,
                                              c_sel)
    want = torch.autograd.grad((want_loss * g.to(want_loss.dtype)).sum(),
                               leaves)
    torch.testing.assert_close(loss, want_loss.float(), rtol=1e-5, atol=1e-6)
    if dtype == torch.float32:
        for a, c in zip(got, want):
            torch.testing.assert_close(a, c.float(), rtol=1e-4,
                                       atol=f32_grad_atol(c))
    else:
        _assert_bf16_grads_close(got, want)


def _csr_from_ell(cols, vals, d):
    keep = cols < d
    lengths = keep.sum(1)
    indptr = torch.cat([lengths.new_zeros(1), lengths.cumsum(0)]).to(torch.int32)
    return indptr, cols[keep].to(torch.int32), vals[keep]


@pytest.mark.parametrize("n,d,r,b,c_sel,j", [(37, 5000, 25, 32, 8, 120),
                                             (37, 5000, 3, 512, 37, 64),
                                             (16, 3000, 8, 4096, 512, 1024),
                                             (6, 3000, 3, 37, 11, 600)])
def test_selected_sparse_kernels_equal_plain(dev, n, d, r, b, c_sel, j):
    """Kernels 5 (nnz_max < 512) and 6 (from 512) at B' = c_sel through
    ``ops.mach_fused_xent_csr(bucket_select=...)`` with the proxy passed,
    against the same op on CPU copies (the plain versions); R·c_sel = 111
    and 33 are odd (kernel 6's dW takes its scalar path where c % 4 != 0);
    unselected columns of dW and dbias exactly zero."""
    w, bb, y, g, selected = _selected_case(dev, n, d, r, b, c_sel, seed=j)
    indptr, indices, values = _csr_from_ell(*_ell(dev, n, d, j, seed=j), d)
    family = "gather" if j >= mfx.GATHER_NNZ_THRESHOLD else "ell"
    fwd, bwd = (getattr(mfx, f"{family}_fwd_cuda"),
                getattr(mfx, f"{family}_bwd_cuda"))
    out = {}
    for where in ("cuda", "cpu"):
        leaves = [t.detach().to(where).requires_grad_(True) for t in (w, bb)]
        args = [t.to(where) for t in (indptr, indices, values)]
        before = (fwd.launches, bwd.launches)
        loss = ops.mach_fused_xent_csr_selected(
            *args, leaves[0], y.to(where), selected.to(where),
            num_buckets=b, nnz_max=j, bias=leaves[1])
        grads = torch.autograd.grad((loss * g.to(where)).sum(), leaves)
        launched = (fwd.launches - before[0], bwd.launches - before[1])
        assert launched == ((1, 1) if where == "cuda" else (0, 0))
        out[where] = (loss, grads)
    (gl, gg), (wl, wg) = out["cuda"], out["cpu"]
    torch.testing.assert_close(gl.cpu(), wl, rtol=1e-5, atol=1e-6)
    for a, c in zip(gg, wg):
        torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-6)
    _unselected_zero(*gg, selected, d, r, b)


# ---------------------------------------------------------------------------
# the OAA baseline: a matrix product and a softmax (no kernel of its own)
# ---------------------------------------------------------------------------

def test_oaa_classifier_and_lm_head_on_the_card(dev):
    """OAAClassifier's loss, gradients and predictions on the card equal
    the CPU's; the smoke recurrentgemma-2b with the OAA head (untied,
    soft-capped) trains and decodes on the card as on the CPU, and the
    engine refuses an estimator."""
    from repro_torch.configs import get_config
    from repro_torch.core import OAAClassifier
    from repro_torch.models import LanguageModel
    from repro_torch.optim import value_and_grad
    from repro_torch.models.transformer import tree_map
    from repro_torch.serving import (Request, SamplingParams, ServeConfig,
                                     ServingEngine)

    clf = OAAClassifier(1000, 64)
    params = clf.init(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((33, 64), generator=gen)
    y = torch.randint(0, 1000, (33,), generator=gen)
    cpu = value_and_grad(clf.loss, params, x, y)
    card = value_and_grad(clf.loss, {k: v.to(dev) for k, v in params.items()},
                          x.to(dev), y.to(dev))
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-5, atol=1e-6)
    for key in ("w", "b"):
        torch.testing.assert_close(card[1][key].cpu(), cpu[1][key],
                                   rtol=1e-4, atol=1e-6)
    assert torch.equal(clf.predict(params, x),
                       clf.predict({k: v.to(dev) for k, v in params.items()},
                                   x.to(dev)).cpu())
    cfg = dataclasses.replace(get_config("recurrentgemma-2b", smoke=True),
                              mach=None, tie_embeddings=False,
                              logit_softcap=30.0)
    model = LanguageModel(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, 256, (2, 25), generator=gen, dtype=torch.int32)
    (cpu_loss, _), cpu_grads = value_and_grad(model.loss, params,
                                              {"tokens": tokens}, has_aux=True)
    dparams = tree_map(lambda t: t.to(dev), params)
    (loss, _), grads = value_and_grad(model.loss, dparams,
                                      {"tokens": tokens.to(dev)}, has_aux=True)
    torch.testing.assert_close(loss.cpu(), cpu_loss, rtol=1e-4, atol=1e-5)
    scale = float(cpu_grads["lm_head"]["kernel"].abs().max())
    torch.testing.assert_close(grads["lm_head"]["kernel"].cpu(),
                               cpu_grads["lm_head"]["kernel"], rtol=1e-3,
                               atol=1e-4 * scale)
    eng = ServingEngine(model, dparams, ServeConfig(max_len=32, num_slots=2,
                                                    max_new_tokens=4))
    with pytest.raises(ValueError, match="OAA"):
        eng.submit(Request(prompt=[1], sampling=SamplingParams(
            estimator="median")))
    eng.submit(Request(prompt=[5, 6, 7]))
    out = eng.run()[0]
    caches, h = model.prefill(dparams, torch.tensor([[5, 6, 7]], device=dev),
                              32)
    assert int(model.next_token(dparams, h)[0][0]) == out.tokens[0]


# ---------------------------------------------------------------------------
# the dense decoders' serving path: the paged KV cache (plain PyTorch, as
# in the JAX package) and kernel 2 at tinyllama-1.1b's MACH head
# ---------------------------------------------------------------------------

PAGED_LENGTHS = {0: 76, 1: 17, 3: 96}     # slot -> tokens; slot 2 is free


def _paged_cpu_pool(h, kv, hd, dtype, seed):
    """(pool, q, owned pages by slot) on the CPU: 4 slots, 16 pages of 16
    tokens, tables of 6 pages, random contents, positions as prefills
    leave them (slot 3's table full), stale positions on the free pages."""
    from repro_torch.models import attention as attn_lib
    gen = torch.Generator().manual_seed(seed)
    pool = attn_lib.init_paged_cache(4, 16, 16, 6, kv, hd, dtype, "cpu")
    pool.k.copy_(torch.randn(pool.k.shape, generator=gen).to(dtype))
    pool.v.copy_(torch.randn(pool.v.shape, generator=gen).to(dtype))
    pool.positions.copy_(torch.randint(0, 96, pool.positions.shape,
                                       generator=gen))
    pages = torch.randperm(16, generator=gen)
    owned, start = {}, 0
    for slot, length in PAGED_LENGTHS.items():
        n = -(-length // 16)
        owned[slot] = pages[start:start + n]
        start += n
        pos = torch.arange(n * 16).reshape(n, 16)
        pool.positions[owned[slot]] = torch.where(pos < length, pos, -1).int()
        pool.page_table[slot, :n] = owned[slot].int()
        pool.index[slot] = length
    q = torch.randn((4, 1, h, hd), generator=gen).to(dtype)
    return pool, q, owned


def _to(pool, device):
    return type(pool)(*(t.to(device) for t in pool))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,hd", [(32, 4, 64), (32, 32, 96), (48, 1, 128)],
                         ids=["GQA 32/4", "MHA 32/32", "MQA 48/1"])
def test_paged_decode_attend_on_card_matches_cpu(dev, h, kv, hd, dtype):
    """Paged decode attention on the card against the same call on a CPU
    copy: float32 at rtol 1e-5, bf16 within 2 bf16 ulps of each (slot,
    head) row's largest output (scores summed in another order)."""
    from repro_torch.models import attention as attn_lib
    pool, q, _ = _paged_cpu_pool(h, kv, hd, dtype, seed=h + kv)
    want = attn_lib.paged_decode_attend(q, pool)
    got = attn_lib.paged_decode_attend(q.to(dev), _to(pool, dev)).cpu()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert torch.all((got.float() - want.float()).abs()
                         <= 2 * _bf16_row_ulp(want))


def test_paged_decode_update_with_free_slots_leaves_owned_pages(dev):
    """A decode write on the card with a free slot (no table, its index
    run on) and a slot whose table is full: each owning slot with room
    writes one row of its own page, no other row of any pool page
    changes, and the pool equals the same update on the CPU."""
    from repro_torch.models import attention as attn_lib
    pool, _, owned = _paged_cpu_pool(8, 2, 64, torch.bfloat16, seed=5)
    pool.index[2] = 40
    gen = torch.Generator().manual_seed(6)
    k1 = torch.randn((4, 1, 2, 64), generator=gen).to(torch.bfloat16)
    v1 = torch.randn((4, 1, 2, 64), generator=gen).to(torch.bfloat16)
    before = type(pool)(*(t.clone() for t in pool))
    card = _to(attn_lib.paged_cache_update_decode(
        _to(pool, dev), k1.to(dev), v1.to(dev)), "cpu")
    cpu = attn_lib.paged_cache_update_decode(pool, k1, v1)
    n = cpu.num_pages
    for got, want in ((card.k[:n], cpu.k[:n]), (card.v[:n], cpu.v[:n]),
                      (card.positions[:n], cpu.positions[:n]),
                      (card.page_table, cpu.page_table),
                      (card.index, cpu.index)):
        assert torch.equal(got, want)
    # slot 3's table is full and slot 2 has none: both write the spare page
    written = {(int(owned[s][PAGED_LENGTHS[s] // 16]),
                PAGED_LENGTHS[s] % 16): s for s in (0, 1)}
    for page in range(n):
        for row in range(16):
            s = written.get((page, row))
            if s is None:
                assert torch.equal(card.k[page, row], before.k[page, row])
                assert torch.equal(card.v[page, row], before.v[page, row])
                assert card.positions[page, row] == before.positions[page, row]
            else:
                assert torch.equal(card.k[page, row], k1[s, 0])
                assert torch.equal(card.v[page, row], v1[s, 0])
                assert card.positions[page, row] == PAGED_LENGTHS[s]
    assert card.index.tolist() == [77, 18, 41, 97]


@pytest.mark.parametrize("inline", [True, False], ids=["inline", "table"])
@pytest.mark.parametrize("n", [1, 4])
def test_topk_kernel_at_tinyllama_head_equals_plain(dev, n, inline):
    """Kernel 2 at tinyllama-1.1b's MACH head (R=8, B=2048, K=32,000):
    N=1 after a prefill, N=4 in the decode pool, k=50 and 1, the three
    estimators, both hash sources, dyadic inputs: values and ids equal."""
    from repro_torch.configs import get_config
    mach = get_config("tinyllama-1.1b", mach="on").mach
    r, b, num_classes = mach.num_repetitions, mach.num_buckets, mach.num_classes
    assert (r, b, num_classes) == (8, 2048, 32000)
    meta = _dyadic(n, r, b, dev, seed=n + 32)
    if inline:
        args, kw = (), {"inline_coeffs": mach.family.coeffs_tensor(dev),
                        "inline_shift": mach.family.shift}
    else:
        args, kw = (mach.family.table(num_classes, dev),), {}
    for estimator in ("unbiased", "min", "median"):
        for k in (1, 50):
            before = mt.mach_topk_cuda.launches
            kv, ki = mt.mach_topk_cuda(meta, *args, num_classes=num_classes,
                                       k=k, estimator=estimator, **kw)
            assert mt.mach_topk_cuda.launches == before + 1
            pv, pi = mt.mach_topk_plain(meta, *args, num_classes=num_classes,
                                        k=k, estimator=estimator, **kw)
            assert torch.equal(kv, pv) and torch.equal(ki, pi), (estimator, k)


MOE_CASES = {"padded group": (1, 37, 16, 8, 2, 2),
             "decode, cap 1": (4, 1, 16, 8, 2, 0),
             "whole groups": (2, 32, 16, 6, 3, 2)}


def _moe_close(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        assert torch.allclose(got, want, rtol=1e-5,
                              atol=1e-5 * float(want.abs().max()))
    else:
        err = float((got - want).norm() / want.norm().clamp(min=1e-30))
        assert err <= 2.0 ** -8, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_on_the_card_matches_ref_and_cpu(dev, case, dtype):
    from repro_torch.models import moe
    from repro_torch.models.transformer import tree_map
    b, t, group, e, k, shared = MOE_CASES[case]
    d, f = 64, 48
    params = moe.init_moe(torch.Generator(device=dev).manual_seed(1), d, f, e,
                          shared, 96, dev, "swiglu")
    params = tree_map(lambda p: p.to(dtype), params)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
    if case.startswith("decode"):
        x[1] = x[0]                      # row 1 collides with row 0
    kw = dict(num_experts=e, top_k=k, activation="swiglu",
              capacity_factor=1.25, group_size=group)
    rkw = {key: v for key, v in kw.items() if key != "activation"}
    r = moe.route(params, x, **rkw)
    y, aux = moe.apply_moe(params, x, **kw)
    ry, raux, ids, keep = moe.moe_ref(params, x, **kw)
    assert torch.equal(ids, r.experts) and torch.equal(keep, r.keep)
    if case.startswith("decode"):
        assert not bool(r.keep[0, 1].any())
    cpu = tree_map(lambda p: p.cpu(), params)
    cy, caux = moe.apply_moe(cpu, x.cpu(), **kw)
    assert torch.equal(moe.route(cpu, x.cpu(), **rkw).keep, r.keep.cpu())
    for want_y, want_aux in ((ry, raux), (cy, caux)):
        _moe_close(y, want_y, dtype)
        for key in ("load_balance", "router_z"):
            _moe_close(aux[key], want_aux[key], torch.float32)


@pytest.mark.parametrize("b,t,s,h,kv,hd,dtype", [
    (1, 300, 300, 16, 16, 64, torch.bfloat16),     # encoder self, non-causal
    (1, 200, 300, 16, 16, 64, torch.bfloat16),     # cross, S > T
    (2, 260, 100, 16, 16, 64, torch.bfloat16),     # cross, S < T
    (1, 77, 130, 8, 1, 256, torch.bfloat16),       # ragged, MQA, hd 256
    (1, 90, 130, 4, 2, 32, torch.float32),
    (2, 64, 33, 4, 4, 16, torch.float32),
])
def test_flash_attention_unmasked_s_ne_t_matches_plain(dev, b, t, s, h, kv,
                                                       hd, dtype):
    """Kernel 10 non-causal with S != T (cross-attention) and S == T (the
    encoder), forward and backward, against the plain versions at the
    tolerances of the causal cases above."""
    gen = torch.Generator(device=dev).manual_seed(t + s)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, t, h, hd), (b, s, kv, hd),
                                 (b, s, kv, hd), (b, t, h, hd)))
    leaves = [z.clone().requires_grad_(True) for z in (q, k, v)]
    before = (fa.flash_attention_cuda.launches,
              fa.flash_attention_bwd_cuda.launches)
    out = ops.flash_attention(*leaves, causal=False)
    out.backward(do)
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    want, lse = fa.flash_attention_plain(q, k, v, causal=False,
                                         return_lse=True)
    want_grads = fa.flash_attention_bwd_plain(q, k, v, out.detach(), do, lse,
                                              causal=False)
    assert out.dtype == dtype and leaves[1].grad.shape == (b, s, kv, hd)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    else:
        assert torch.all((out.float() - want.float()).abs()
                         <= 2 * _bf16_row_ulp(want))
    for got, w in zip((z.grad for z in leaves), want_grads):
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-5)
        else:
            tol = 2 * _bf16_row_ulp(w) + 2.0 ** -20 * w.float().abs().max()
            assert torch.all((got.float() - w.float()).abs() <= tol)


def _smoke_on_card_and_cpu(arch, dev, **overrides):
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel
    from repro_torch.models.transformer import tree_map
    cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    model = LanguageModel(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    return model, cpu, tree_map(lambda p: p.to(dev), cpu)


@pytest.mark.parametrize("arch", ["xlstm-350m", "seamless-m4t-large-v2"])
def test_xlstm_and_enc_dec_smoke_on_the_card_match_cpu(dev, arch):
    """The smoke xLSTM and enc-dec models (float32, the enc-dec's flash
    branch lowered so kernel 10 runs non-causal and S != T) on the card
    against the same params on the CPU: loss and hidden states at rtol
    1e-4 (cuBLAS and the CPU sum in other orders, over 4 layers and the
    chunked mLSTM), a prefill and three decode steps, and the engine's
    greedy tokens."""
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    lowered = ({"flash_threshold": 8, "chunk_q": 8}
               if arch.startswith("seamless") else {})
    model, cpu, card = _smoke_on_card_and_cpu(arch, dev, **lowered)
    cfg = model.cfg
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 25), generator=gen)
    batch = {"tokens": tokens}
    if cfg.num_encoder_layers:
        batch["enc_feats"] = torch.randn((2, 16, 1024), generator=gen)
    before = fa.flash_attention_cuda.launches
    results = []
    for params, d in ((card, dev), (cpu, torch.device("cpu"))):
        b = {k: v.to(d) for k, v in batch.items()}
        loss, _ = model.loss(params, b)
        kvs = (model.enc_kvs(params, model.encode(params, b["enc_feats"]))
               if cfg.num_encoder_layers else None)
        caches, h = model.prefill(params, b["tokens"][:, :16], 32,
                                  enc_kvs=kvs)
        hs = [h]
        for i in range(3):
            pos = torch.full((2,), 16 + i, dtype=torch.int32, device=d)
            caches, h = model.decode_step(params, caches,
                                          b["tokens"][:, 16 + i], pos,
                                          enc_kvs=kvs)
            hs.append(h)
        results.append((loss, hs))
    if cfg.num_encoder_layers:
        assert fa.flash_attention_cuda.launches > before
    (loss, hs), (closs, chs) = results
    torch.testing.assert_close(loss.cpu(), closs, rtol=1e-4, atol=1e-6)
    for h, ch in zip(hs, chs):
        torch.testing.assert_close(h.cpu(), ch, rtol=1e-4,
                                   atol=1e-4 * float(ch.abs().max()))
    feats = ({"enc_feats": batch["enc_feats"][0].numpy()}
             if cfg.num_encoder_layers else {})
    toks = []
    for params in (card, cpu):
        eng = ServingEngine(model, params, ServeConfig(
            max_len=48, num_slots=2, max_new_tokens=5))
        for n in (9, 3, 16):
            eng.submit(Request(prompt=tokens[0, :n].tolist(), **feats))
        toks.append([r.tokens for r in eng.run()])
    assert toks[0] == toks[1]


def _card_state(dev, n=1024):
    """A TrainState on the card: float32, bf16 and int32 params, AdamW
    moments after one update (nonzero), int step and count."""
    from repro_torch.optim import adamw, apply_updates
    from repro_torch.train import TrainState
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"w": torch.randn((n, n), generator=gen, device=dev),
              "emb": torch.randn((n // 2, 256), generator=gen,
                                 device=dev).to(torch.bfloat16),
              "ids": torch.arange(7, dtype=torch.int32, device=dev)}
    opt = adamw(1e-3, weight_decay=0.1)
    opt_state = opt.init(params)
    grads = {k: torch.randn(v.shape, generator=gen, device=dev).to(v.dtype)
             if v.is_floating_point() else torch.zeros_like(v)
             for k, v in params.items()}
    upd, opt_state = opt.update(grads, opt_state, params)
    return TrainState(1, apply_updates(params, upd), opt_state), opt, grads


def _same_bits(got, want):
    from repro_torch.checkpoint import tree_flatten
    pg, pw = tree_flatten(got), tree_flatten(want)
    assert [p for p, _ in pg] == [p for p, _ in pw]
    for (path, a), (_, b) in zip(pg, pw):
        if not isinstance(a, torch.Tensor):
            assert a == b and type(a) is type(b), path
            continue
        assert a.dtype == b.dtype, path
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), path


def test_checkpoint_card_to_cpu_and_back_bit_for_bit(dev, tmp_path):
    """Saved on the card, restored on the CPU (device="cpu"), saved there
    and restored on the card again: every leaf the same bits, bf16 and
    int leaves included; without device= a leaf goes to its template
    leaf's device."""
    from repro_torch.checkpoint import CheckpointManager
    state, _, _ = _card_state(dev)
    mgr = CheckpointManager(str(tmp_path / "card"))
    mgr.save(1, state)
    on_cpu, step = mgr.restore(state, device="cpu")
    assert step == 1 and on_cpu.params["w"].device.type == "cpu"
    _same_bits(on_cpu, state)
    back = CheckpointManager(str(tmp_path / "cpu"))
    back.save(1, on_cpu, blocking=False)
    on_card, _ = back.restore(on_cpu, device=dev)
    assert on_card.params["emb"].device == dev
    _same_bits(on_card, state)
    kept, _ = mgr.restore(state)
    assert kept.opt_state.mu["w"].device == dev
    _same_bits(kept, state)


def test_checkpoint_async_save_survives_an_adamw_step(dev, tmp_path):
    """An AdamW step on the card right after save(blocking=False) returns
    (the moments move in place, the params are bumped in place) leaves
    the checkpoint as the state was at the save."""
    from repro_torch.checkpoint import CheckpointManager
    state, opt, grads = _card_state(dev, n=4096)     # 64 MiB leaves
    want = _card_state(dev, n=4096)[0]               # the same, apart
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=False)
    opt.update(grads, state.opt_state, state.params)
    state.params["w"].add_(1.0)
    torch.cuda.synchronize(dev)
    assert not torch.equal(state.opt_state.mu["w"], want.opt_state.mu["w"])
    mgr.wait()
    restored, _ = mgr.restore(want)
    _same_bits(restored, want)


@pytest.mark.parametrize("nnz", [120, 1024])
def test_data_streams_same_bits_on_the_card(dev, nnz):
    """A batch is a pure function of (seed, step) on the card too: ODP's
    CSR batches at full width and an LM stream's tokens, each drawn twice
    (torch.multinomial's CUDA prefix sum rounded differently from run to
    run, so draws near an edge moved)."""
    import dataclasses
    from repro_torch.configs.odp_mach import ODP
    from repro_torch.data import LMDataConfig, SyntheticLMStream
    from repro_torch.data.extreme import SparseExtremeDataset
    data = SparseExtremeDataset(dataclasses.replace(
        ODP.sparse_data(small=False), nnz=nnz), device=dev)
    lm = SyntheticLMStream(LMDataConfig(vocab_size=32000, seq_len=2048,
                                        global_batch=2), device=dev)
    for s in range(3):
        (x0, y0), (x1, y1) = data.batch_at(s, 512), data.batch_at(s, 512)
        assert torch.equal(y0, y1)
        for f in ("indptr", "indices", "values"):
            assert torch.equal(getattr(x0, f), getattr(x1, f)), f
        assert torch.equal(lm.batch_at(s)["tokens"], lm.batch_at(s)["tokens"])


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_world1_nccl_sharded_step_same_bits(dev, tmp_path, optimizer):
    """The smoke tinyllama-1.1b (bf16) through ``Trainer(mesh=)`` on an
    NCCL world of one ((1, 1) mesh, FSDP rules) and through the
    single-device ``Trainer`` from one seed: three steps, every metric,
    param and moment the same bits; a checkpoint of the sharded state
    restores unsharded bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import CheckpointManager, tree_flatten
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import gather
    from repro_torch.train import TrainConfig, Trainer

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_config("tinyllama-1.1b", smoke=True)
        tc = TrainConfig(optimizer=optimizer, peak_lr=1e-3, warmup_steps=2,
                         total_steps=10)
        model = LanguageModel(cfg)
        sharded, single = Trainer(model, tc, mesh=mesh), Trainer(model, tc)
        gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
        st, rs = sharded.init_state(gen(), dev), single.init_state(gen(), dev)
        stream = launch_train.data_stream(cfg, 64, 4, 0, dev)
        for s in range(3):
            st, m = sharded.step_fn(st, stream.batch_at(s))
            rs, rm = single.step_fn(rs, stream.batch_at(s))
            assert {k: float(v) for k, v in m.items()} == \
                {k: float(v) for k, v in rm.items()}, s
        whole = gather(st)
        for (path, got), (_, want) in zip(tree_flatten(whole),
                                          tree_flatten(rs)):
            if isinstance(want, torch.Tensor):
                assert torch.equal(got, want), path
            else:
                assert got == want, path
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save(3, st)
        restored, _ = mgr.restore(single.init_state(gen(), dev))
        for (path, got), (_, want) in zip(tree_flatten(restored),
                                          tree_flatten(rs)):
            assert (torch.equal(got, want) if isinstance(want, torch.Tensor)
                    else got == want), path
    finally:
        dist.destroy_process_group()


def test_world1_nccl_per_period_gathering(dev, tmp_path):
    """The smoke tinyllama-1.1b (bf16) at 4 layers under ``remat="full"``
    through ``Trainer(mesh=)`` on an NCCL world of one: each period's
    params gathered inside the recomputed period, losses, params and
    moments bit for bit the single-device step's after three steps; the
    gathered bytes alive at once (``GatherCount``: at world 1 the
    gathers alias the shards, so it counts the schedule) within the
    leaves outside the stacks plus two periods, below the whole tree;
    the state placed as it is built equals a whole drawn state placed."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import tree_flatten
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LanguageModel
    from repro_torch.sharding import gather, place
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.train_state import new_train_state
    from torch_multidevice_ranks import GatherCount, gather_bounds

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                                  num_layers=4, remat="full",
                                  dtype=torch.bfloat16,
                                  param_dtype=torch.bfloat16)
        tc = TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
        model = LanguageModel(cfg)
        sharded, single = Trainer(model, tc, mesh=mesh), Trainer(model, tc)
        gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
        st, rs = sharded.init_state(gen(), dev), single.init_state(gen(), dev)
        placed = place(new_train_state(model.init(gen(), dev), sharded.opt),
                       sharded.state_shardings)
        for (path, a), (_, b) in zip(tree_flatten(st), tree_flatten(placed)):
            if isinstance(b, torch.Tensor):
                assert a.placements == b.placements, path
                assert torch.equal(a.to_local(), b.to_local()), path
        stream = launch_train.data_stream(cfg, 64, 4, 0, dev)
        count = GatherCount()
        for s in range(3):
            with count:
                st, m = sharded.step_fn(st, stream.batch_at(s))
            rs, rm = single.step_fn(rs, stream.batch_at(s))
            assert {k: float(v) for k, v in m.items()} == \
                {k: float(v) for k, v in rm.items()}, s
        for (path, got), (_, want) in zip(tree_flatten(gather(st)),
                                          tree_flatten(rs)):
            if isinstance(want, torch.Tensor):
                assert torch.equal(got, want), path
            else:
                assert got == want, path
        bounds = gather_bounds(rs.params)
        assert count.calls > 0
        assert count.peak <= bounds["bound"] < bounds["whole"], \
            (count.peak, bounds)
    finally:
        dist.destroy_process_group()


def test_head_split_per_range_equals_whole(dev):
    """The MACH head split by repetition over two ranks, as each rank
    launches kernels 3 and 4 (bf16, R = 8, B = 2,048): on each half of
    the repetitions in turn, the per-token losses summed over the halves
    equal the whole-R kernel's at float32 rtol 1e-6; kernel 3's dlogits
    are the whole kernel's columns bit for bit (one warp a head); kernel
    4's dW columns and the dh summed over the halves (in float32) hold
    by the bf16 gradient rule (its dW and dh are summed across blocks by
    float atomics, in an order that changes from run to run)."""
    n_rows, d, r, b, parts = 512, 256, 8, 2048, 2
    gen = torch.Generator(device=dev).manual_seed(29)
    logits = (torch.randn((n_rows, r, b), generator=gen, device=dev)
              * 3).to(torch.bfloat16)
    h = torch.randn((n_rows, d), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((d, r * b), generator=gen, device=dev)
         / d ** 0.5).to(torch.bfloat16)
    y = torch.randint(0, b, (n_rows, r), generator=gen, device=dev,
                      dtype=torch.int32)
    g = torch.rand((n_rows,), generator=gen, device=dev) + 0.5
    loss3 = mx.mach_xent_cuda_fwd(logits, y)
    dlogits = mx.mach_xent_cuda_bwd(logits, y, g)
    loss4, lse = mfx.dense_fwd_cuda(h, w, None, y, b)
    dh, dw, _ = mfx.dense_bwd_cuda(h, w, None, y, lse, g, b)
    sum3 = torch.zeros_like(loss3)
    sum4 = torch.zeros_like(loss4)
    dh_sum = torch.zeros((n_rows, d), dtype=torch.float32, device=dev)
    per = r // parts
    for k in range(parts):
        r0, r1 = k * per, (k + 1) * per
        part_logits = logits[:, r0:r1].contiguous()
        part_y = y[:, r0:r1].contiguous()
        sum3 += mx.mach_xent_cuda_fwd(part_logits, part_y)
        assert torch.equal(mx.mach_xent_cuda_bwd(part_logits, part_y, g),
                           dlogits[:, r0:r1])
        part_w = w[:, r0 * b:r1 * b].contiguous()
        part_loss, part_lse = mfx.dense_fwd_cuda(h, part_w, None, part_y, b)
        sum4 += part_loss
        assert torch.equal(part_lse, lse[:, r0:r1])
        part_dh, part_dw, _ = mfx.dense_bwd_cuda(h, part_w, None, part_y,
                                                 part_lse, g, b)
        _assert_bf16_grads_close([part_dw], [dw[:, r0 * b:r1 * b]])
        dh_sum += part_dh.float()
    torch.testing.assert_close(sum3, loss3, rtol=1e-6, atol=0)
    torch.testing.assert_close(sum4, loss4, rtol=1e-6, atol=0)
    _assert_bf16_grads_close([dh_sum.to(torch.bfloat16)], [dh])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_flash_attention_per_rank_heads_equals_whole(dev, n):
    """Kernel 10 as each of n ``model`` ranks of a split decoder launches
    it (tinyllama-1.1b's 32 query heads over 4 kv heads of 64, causal,
    bf16): on its query heads [k·32/n, (k+1)·32/n) and the kv heads they
    read (``sharding.kv_heads``), forward and backward.  The output, the
    lse and dq are the whole kernel's heads bit for bit (heads are
    independent); dk and dv are the whole kernel's kv heads bit for bit
    where a rank owns whole groups of 8 (n = 2, 4), and at n = 8, where
    two ranks share a kv head, their sum (in float32) holds to the whole
    kernel's by the backward rule above (2 bf16 ulps of the row scale
    plus 2^-20 of the largest entry)."""
    from repro_torch.sharding import kv_heads
    b, t, h, kv, hd = 1, 512, 32, 4, 64
    gen = torch.Generator(device=dev).manual_seed(n)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((b, t, h, hd), (b, t, kv, hd), (b, t, kv, hd),
                                 (b, t, h, hd)))
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse)
    dk_sum = torch.zeros(dk.shape, dtype=torch.float32, device=dev)
    dv_sum = torch.zeros_like(dk_sum)
    per = h // n
    for rank in range(n):
        q0, q1 = rank * per, (rank + 1) * per
        k0, k1 = kv_heads(q0, q1, h, kv)
        rq, rdo = q[:, :, q0:q1].contiguous(), do[:, :, q0:q1].contiguous()
        rk, rv = k[:, :, k0:k1].contiguous(), v[:, :, k0:k1].contiguous()
        r_out, r_lse = fa.flash_attention_cuda(rq, rk, rv, return_lse=True)
        assert torch.equal(r_out, out[:, :, q0:q1])
        assert torch.equal(r_lse, lse[:, q0:q1])
        r_dq, r_dk, r_dv = fa.flash_attention_bwd_cuda(rq, rk, rv, r_out,
                                                       rdo, r_lse)
        assert torch.equal(r_dq, dq[:, :, q0:q1])
        if per >= h // kv:
            assert torch.equal(r_dk, dk[:, :, k0:k1])
            assert torch.equal(r_dv, dv[:, :, k0:k1])
        dk_sum[:, :, k0:k1] += r_dk.float()
        dv_sum[:, :, k0:k1] += r_dv.float()
    for got, w in ((dk_sum, dk), (dv_sum, dv)):
        tol = 2 * _bf16_row_ulp(w) + 2.0 ** -20 * w.float().abs().max()
        assert torch.all((got.to(torch.bfloat16).float() - w.float()).abs()
                         <= tol)
