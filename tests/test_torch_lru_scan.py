"""Kernel 9 (the RG-LRU scan): the port's plain version against the TPU
kernel run in interpret mode (``lru_scan_pallas(interpret=True)``) and
the JAX oracle, on the CPU.

The plain version is a sequential float32 loop (the CUDA kernel's
arithmetic, bit for bit); the TPU kernel walks the same loop in blocks,
the JAX oracle an associative scan — so rtol 1e-5 (atol 1e-6 for values
near zero).  The port's own oracle, ``ref.lru_scan_ref``, is an
associative scan too.

The backward (the reverse loop ``lru_scan_bwd_plain``, which the op's
autograd Function runs on CPU tensors) is held against ``jax.vjp`` of
the JAX oracle (JAX does not differentiate the TPU kernel: it has no
backward, and ``pallas_call``'s JVP refuses its scratch) at rtol 1e-5 (atol
1e-5 of the largest entry, for entries that cancel), and against
``torch.autograd`` through the plain forward loop, bit for bit.

The kernels' launch (``scan_layout``: copy unit, stage length, ring
depth) is held at the prefill, training, decode and ragged shapes, and
the wrapper's copies of ``csrc/lru_ring.cuh``'s constants against the
source; the kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.lru_scan import lru_scan_pallas
from repro_torch.kernels import lru_scan as ls
from repro_torch.kernels import ops, ref
from torch_reference import jax_reference

TOL = {"rtol": 1e-5, "atol": 1e-6}


def _inputs(b, t, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, t, d)).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return a, x, h0


@pytest.mark.parametrize("b,t,d,block_t", [(2, 32, 128, 8), (3, 37, 300, 37),
                                           (4, 1, 256, 1)])
def test_plain_matches_tpu_kernel_and_oracles(b, t, d, block_t):
    a, x, h0 = _inputs(b, t, d, seed=t)
    want = np.asarray(lru_scan_pallas(a, x, h0, block_t=block_t,
                                      interpret=True))
    got = ls.lru_scan_plain(torch.from_numpy(a), torch.from_numpy(x),
                            torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.lru_scan_ref(
        jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))), **TOL)
    mine = ref.lru_scan_ref(torch.from_numpy(a), torch.from_numpy(x),
                            torch.from_numpy(h0))
    np.testing.assert_allclose(mine.numpy(), want, **TOL)
    # the op takes the plain version on CPU tensors: the same bits
    assert torch.equal(ops.lru_scan(torch.from_numpy(a), torch.from_numpy(x),
                                    torch.from_numpy(h0)), got)


def test_plain_is_the_sequential_loop_and_keeps_x_dtype():
    a, x, h0 = (torch.from_numpy(v) for v in _inputs(2, 9, 16, seed=1))
    h = h0.clone()
    for t in range(9):
        h = a[:, t] * h + x[:, t]
    assert torch.equal(ls.lru_scan_plain(a, x, h0)[:, -1], h)
    out = ls.lru_scan_plain(a.bfloat16(), x.bfloat16(), h0)
    assert out.dtype == torch.bfloat16


def test_operands_are_checked():
    a, x, h0 = (torch.from_numpy(v) for v in _inputs(2, 5, 8, seed=2))
    with pytest.raises(ValueError, match="one \\(B, T, D\\)"):
        ops.lru_scan(a, x[:, :4], h0)
    with pytest.raises(ValueError, match="h0"):
        ops.lru_scan(a, x, h0[:1])
    with pytest.raises(ValueError, match="CUDA"):
        ls.lru_scan_cuda(a, x, h0)


def test_reference_modules_removed_after_the_block():
    """The scoped JAX reference leaves ``sys.modules`` as it found it."""
    before = {n for n in sys.modules if n == "repro" or n.startswith("repro.")}
    assert "repro.models" not in before
    with jax_reference() as ns:
        assert ns.models.LanguageModel is not None
        assert "repro.models" in sys.modules
    after = {n for n in sys.modules if n == "repro" or n.startswith("repro.")}
    assert after == before
    for name in ("repro.models", "repro.serving", "repro.configs",
                 "repro.kernels.ops", "repro.kernels.mach_fused_xent"):
        assert name not in sys.modules, name
    assert not hasattr(sys.modules["repro.kernels"], "ops")


def _vjp_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("b,t,d", [(2, 32, 128), (3, 37, 30), (4, 1, 16)])
def test_backward_matches_jax_vjp(b, t, d):
    """da, dx and dh0 at nonzero h0, T = 1 included (dh0 = a_0·dh_0)."""
    a, x, h0 = _inputs(b, t, d, seed=t + 7)
    dh = np.random.default_rng(t).standard_normal((b, t, d)).astype(np.float32)
    _, vjp = jax.vjp(jref.lru_scan_ref, *(jnp.asarray(z) for z in (a, x, h0)))
    want = vjp(jnp.asarray(dh))
    leaves = [torch.from_numpy(z).requires_grad_(True) for z in (a, x, h0)]
    ops.lru_scan(*leaves).backward(torch.from_numpy(dh))
    for leaf, w in zip(leaves, want):
        _vjp_close(leaf.grad, w)
    # the port's oracle: autograd through the associative scan
    for leaf, w in zip(leaves, ref.lru_scan_grad_ref(
            *(torch.from_numpy(z) for z in (a, x, h0)), torch.from_numpy(dh))):
        _vjp_close(leaf.grad, w.numpy())


def test_backward_equals_autograd_of_the_plain_loop():
    """The reverse loop computes what autograd of the forward loop does,
    with the same products and sums in the same order: bit for bit."""
    a, x, h0 = (torch.from_numpy(z) for z in _inputs(2, 9, 16, seed=8))
    dh = torch.randn(2, 9, 16, generator=torch.Generator().manual_seed(0))
    leaves = [z.clone().requires_grad_(True) for z in (a, x, h0)]
    ls.lru_scan_plain(*leaves).backward(dh)
    h = ls.lru_scan_plain(a, x, h0)
    da, dx, dh0 = ls.lru_scan_bwd_plain(a, h, h0, dh)
    for got, leaf in zip((da, dx, dh0), leaves):
        assert torch.equal(got, leaf.grad)


def test_backward_keeps_dtypes():
    """bf16 a and x: da and dx come back in bf16, dh0 in h0's dtype."""
    a, x, h0 = (torch.from_numpy(z) for z in _inputs(2, 5, 8, seed=9))
    leaves = [a.bfloat16().requires_grad_(True),
              x.bfloat16().requires_grad_(True), h0.requires_grad_(True)]
    h = ops.lru_scan(*leaves)
    assert h.dtype == torch.bfloat16
    h.float().sum().backward()
    assert [z.grad.dtype for z in leaves] == [torch.bfloat16, torch.bfloat16,
                                              torch.float32]


# ---------------------------------------------------------------------------
# the kernels' launch (scan_layout) and the wrapper's copies of csrc
# constants, read against csrc/lru_ring.cuh
# ---------------------------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16


# an H100 SXM: 132 SMs, 228 KB of shared memory each, 1 KB of it held
# back for each block
H100 = ls.Card(sms=132, smem_per_sm=233472, block_reserved=1024)

# (b, t, d, dtype, aligned, backward) -> (unit, steps_f32, stages) on an
# H100
LAYOUTS = {
    (1, 4096, 2560, F32, 16, False): (16, 32, 24),   # prefill
    (1, 4096, 2560, F32, 16, True): (16, 32, 18),
    (2, 4096, 2560, F32, 16, False): (16, 16, 24),   # training
    (2, 4096, 2560, F32, 16, True): (16, 16, 24),
    (4, 1, 2560, F32, 16, False): (16, 16, 1),       # decode
    (4, 1, 2560, F32, 16, True): (16, 16, 1),
    (2, 4097, 2570, F32, 16, False): (4, 16, 24),    # ragged
    (2, 4097, 2570, BF16, 16, True): (4, 16, 24),
    (3, 37, 300, F32, 16, False): (16, 32, 2),
    (3, 37, 300, BF16, 16, False): (4, 32, 1),
    (2, 130, 301, BF16, 16, True): (2, 32, 3),       # odd D
    (1, 100, 2560, BF16, 4, False): (4, 32, 2),      # pointers
    (1, 100, 2560, BF16, 2, False): (2, 32, 2),
    (1, 100, 2560, F32, 4, True): (4, 32, 4),
}


@pytest.mark.parametrize("key", sorted(LAYOUTS, key=str), ids=str)
def test_scan_layout(key):
    b, t, d, dtype, aligned, backward = key
    lay = ls.scan_layout(b, t, d, dtype, backward, aligned, H100)
    assert (lay.unit, lay.steps_f32, lay.stages) == LAYOUTS[key]
    # csrc launch_groups: ns slots of NOPS operands' S steps, behind the
    # barriers; with more than 2 slots the SM's groups fit side by side
    steps = lay.steps_f32 * 4 // dtype.itemsize
    slot = (3 if backward else 2) * steps * ls.CHANNELS * dtype.itemsize
    smem = lay.stages * slot + 16 * -(-24 * lay.stages // 16)
    per_sm = -(-b * -(-d // ls.CHANNELS) // H100.sms)
    if lay.stages > 2:
        assert per_sm * (smem + H100.block_reserved) <= H100.smem_per_sm


def test_scan_layout_every_unit_divides_the_row():
    """A copy unit holds whole elements and a row of d elements whole
    units, at every d and alignment."""
    for dtype in (F32, BF16):
        esize = dtype.itemsize
        for d in range(1, 70):
            for aligned in (2, 4, 16) if dtype == BF16 else (4, 16):
                unit = ls.scan_layout(1, 5, d, dtype, False, aligned,
                                      H100).unit
                assert unit >= esize and (d * esize) % unit == 0
                assert aligned % unit == 0


CSRC = Path(ls.__file__).resolve().parent / "csrc" / "lru_ring.cuh"


def _constexpr(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         CSRC.read_text()).group(1))


@pytest.mark.parametrize("python,name", [
    (ls.CHANNELS, "kChannels"), (ls.STEPS_LONG, "kStepsLong"),
    (ls.STEPS_SHORT, "kStepsShort"), (ls.MAX_STAGES, "kMaxStages")], ids=str)
def test_python_constants_match_csrc(python, name):
    assert python == _constexpr(name)


def test_python_units_and_barrier_bytes_match_csrc():
    text = CSRC.read_text()
    body = re.search(r"enum Unit : int \{([^}]+)\}", text).group(1)
    units = [int(item.split("=")[1]) for item in body.split(",")]
    assert tuple(units) == ls.UNITS
    assert "return (3 * 8 * ns + 15) / 16 * 16;" in text
    for ns in range(1, ls.MAX_STAGES + 1):
        assert ls._barrier_bytes(ns) == (3 * 8 * ns + 15) // 16 * 16
