"""The CUDA decode kernels against their plain versions, on the card.

Marked ``cuda``: skips without a GPU.  Needs neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core.hashing import MultShiftFamily
from repro_torch.kernels import mach_decode as md
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
