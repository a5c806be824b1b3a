"""The CUDA kernels (decode; fused projection + CE, forward and
backward) against their plain versions, on the card.  Gradients at rtol
1e-4 / atol 1e-6: the kernels reduce dW, dh and dbias with float
atomics, in another order than the plain version (and from run to run).

Marked ``cuda``: skips without a GPU.  Needs neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core.hashing import MultShiftFamily
from repro_torch.kernels import mach_decode as md
from repro_torch.kernels import mach_fused_xent as mfx
from repro_torch.kernels import mach_topk as mt
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


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,d,r,b", [(70, 200, 25, 32), (9, 130, 3, 512),
                                     (33, 77, 7, 37)])
def test_dense_xent_kernel_equals_plain(dev, n, d, r, b, bias):
    w, bb, y, g = _xent_case(dev, n, d, r, b, bias)
    h = torch.randn((n, d), device=dev)
    leaves = [t.requires_grad_(True) for t in (h, w, bb) if t is not None]
    before = (mfx.dense_fwd_cuda.launches, mfx.dense_bwd_cuda.launches)
    got = _grads(lambda: mfx.mach_fused_xent_dense(h, w, bb, y, b), leaves, g)
    assert (mfx.dense_fwd_cuda.launches, mfx.dense_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    want = _grads(lambda: mfx.fused_xent_dense_plain(h, w, bb, y, b), leaves, g)
    _assert_xent_close(got, want)


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


def test_fused_xent_wrappers_reject_bad_operands(dev):
    w, _, y, _ = _xent_case(dev, 4, 16, 2, 8, False)
    h = torch.randn((4, 16), device=dev)
    with pytest.raises(ValueError, match="float32"):
        mfx.mach_fused_xent_dense(h.half(), w, None, y, 8)
    with pytest.raises(ValueError, match="int32"):
        mfx.mach_fused_xent_dense(h, w, None, y.long(), 8)
    with pytest.raises(ValueError, match="different devices"):
        mfx.mach_fused_xent_dense(h, w.cpu(), None, y, 8)
