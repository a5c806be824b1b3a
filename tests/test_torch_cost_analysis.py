"""The port's cost counter (``repro_torch/launch/cost_analysis.py``)
against the JAX package's ``hlo_analysis.analyze``, and the kernels'
``work()`` and fake-tensor stand-ins (``repro_torch/kernels/counting``).

Programs are those of ``tests/test_hlo_analysis.py``, written as eager
PyTorch (a ``lax.scan`` as a Python loop).  The counter's rules: a
matrix product 2·|out|·K, a pointwise op its output's elements, a
reduction its input's.  ``analyze`` counts XLA's fused module, so the
two agree within 5% (10% for the nested scans, as there) and the
products exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.launch import hlo_analysis as ha
from repro_torch.kernels import counting, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lru_scan as ls
from repro_torch.kernels import mach_candidates as mc
from repro_torch.kernels import mach_decode as md
from repro_torch.kernels import mach_fused_xent as mfx
from repro_torch.kernels import mach_topk as mt
from repro_torch.kernels import mach_xent as mx
from repro_torch.launch.cost_analysis import CostCounter, analyze

HBM, BF16, F32, TF32 = 3.35e12, 989e12, 67e12, 494.7e12


def _compile(f, *specs):
    return jax.jit(f).lower(*specs).compile()


def _fake(*shapes, dtype=torch.float32):
    return [torch.empty(s, dtype=dtype) for s in shapes]


# ------------------------------------------------- against hlo_analysis

def test_tanh_chain_matches_hlo_analysis():
    def f(x, w1, w2):
        return jnp.sum(jnp.tanh(x @ w1) @ w2)

    shapes = [(128, 256), (256, 512), (512, 64)]
    want = ha.analyze(_compile(f, *[jax.ShapeDtypeStruct(s, jnp.float32)
                                    for s in shapes]).as_text())
    with FakeTensorMode():
        x, w1, w2 = _fake(*shapes)
        got = analyze(lambda: torch.sum(torch.tanh(x @ w1) @ w2))
    assert got["flops"] == (2 * 128 * 256 * 512 + 128 * 512
                            + 2 * 128 * 512 * 64 + 128 * 64)
    assert got["transcendentals"] == 128 * 512
    assert abs(got["flops"] / want["flops"] - 1) < 0.05


@pytest.mark.parametrize("n", [4, 16])
def test_scan_as_a_loop_counts_every_iteration(n):
    def f(x, ws):
        def body(c2, w):
            return jnp.tanh(c2 @ w), None
        y, _ = jax.lax.scan(body, x, ws)
        return jnp.sum(y)

    want = ha.analyze(_compile(
        f, jax.ShapeDtypeStruct((128, 256), jnp.float32),
        jax.ShapeDtypeStruct((n, 256, 256), jnp.float32)).as_text())

    def loop(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return torch.sum(x)

    with FakeTensorMode():
        x, ws = _fake((128, 256), (n, 256, 256))
        got = analyze(loop, x, ws)
    products = n * 2 * 128 * 256 * 256
    assert got["flops"] == products + n * 128 * 256 + 128 * 256
    assert abs(got["flops"] / want["flops"] - 1) < 0.05


def test_nested_loops_multiply():
    def f(x, ws):
        def outer(c2, w):
            def inner(c3, _):
                return jnp.tanh(c3 @ w), None
            c2, _ = jax.lax.scan(inner, c2, jnp.arange(3))
            return c2, None
        y, _ = jax.lax.scan(outer, x, ws)
        return jnp.sum(y)

    want = ha.analyze(_compile(
        f, jax.ShapeDtypeStruct((64, 128), jnp.float32),
        jax.ShapeDtypeStruct((5, 128, 128), jnp.float32)).as_text())

    def loop(x, ws):
        for w in ws:
            for _ in range(3):
                x = torch.tanh(x @ w)
        return torch.sum(x)

    with FakeTensorMode():
        x, ws = _fake((64, 128), (5, 128, 128))
        got = analyze(loop, x, ws)
    assert got["flops"] == 15 * (2 * 64 * 128 * 128 + 64 * 128) + 64 * 128
    assert abs(got["flops"] / want["flops"] - 1) < 0.1


# test_hlo_analysis.py's synthetic module: twelve all-reduces in a loop
_TWELVE_ALL_REDUCES = """
HloModule test, entry_computation_layout={()->f32[]}

%body (p: (s32[], f32[128,128])) -> (s32[], f32[128,128]) {
  %p = (s32[], f32[128,128]{1,0}) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[128,128]{1,0} get-tuple-element(%p), index=1
  %one = s32[] constant(1)
  %i2 = s32[] add(%i, %one)
  %ar = f32[128,128]{1,0} all-reduce(%x), replica_groups={}, to_apply=%sum
  ROOT %t = (s32[], f32[128,128]{1,0}) tuple(%i2, %ar)
}

%cond (p2: (s32[], f32[128,128])) -> pred[] {
  %p2 = (s32[], f32[128,128]{1,0}) parameter(0)
  %i3 = s32[] get-tuple-element(%p2), index=0
  %n = s32[] constant(12)
  ROOT %lt = pred[] compare(%i3, %n), direction=LT
}

ENTRY %main () -> f32[] {
  %c = f32[128,128]{1,0} constant(0)
  %z = s32[] constant(0)
  %init = (s32[], f32[128,128]{1,0}) tuple(%z, %c)
  %w = (s32[], f32[128,128]{1,0}) while(%init), condition=%cond, body=%body
  %r = f32[128,128]{1,0} get-tuple-element(%w), index=1
  ROOT %out = f32[] constant(0)
}
"""


def test_twelve_all_reduces_on_a_fake_world():
    want = ha.analyze(_TWELVE_ALL_REDUCES)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with FakeTensorMode():
            x = torch.empty((128, 128), dtype=torch.float32)

            def twelve():
                for _ in range(12):
                    dist.all_reduce(x)

            got = analyze(twelve)
    finally:
        dist.destroy_process_group()
    assert got["collectives"]["all-reduce"]["count"] == 12
    assert got["collective_wire_bytes"] == 12 * 128 * 128 * 4
    assert got["collective_count"] == want["collective_count"]
    assert got["collective_wire_bytes"] == want["collective_wire_bytes"]


def test_views_and_allocations_move_nothing():
    with FakeTensorMode():
        x = torch.empty((64, 32))
        got = analyze(lambda: (x.reshape(32, 64).t()[:16],
                               torch.empty_like(x)))
    assert got["bytes"] == 0 and got["flops"] == 0


# ------------------------------------------------- kernels: stand-ins

def _counted(fn):
    with CostCounter() as c:
        out = fn()
    return out, c.summary()["kernels"]


def _same_meta(fake, real):
    fl = [x for x in torch.utils._pytree.tree_leaves(fake)
          if isinstance(x, torch.Tensor)]
    rl = [x for x in torch.utils._pytree.tree_leaves(real)
          if isinstance(x, torch.Tensor)]
    assert len(fl) == len(rl)
    for f, r in zip(fl, rl):
        assert counting.is_fake(f) and not counting.is_fake(r)
        assert (tuple(f.shape), f.dtype) == (tuple(r.shape), r.dtype)


def _decode_inputs(n=5, r=4, b=8, k_classes=50, seed=0):
    rng = np.random.default_rng(seed)
    meta = torch.softmax(torch.tensor(rng.standard_normal((n, r, b)),
                                      dtype=torch.float32), -1)
    table = torch.tensor(rng.integers(0, b, (r, k_classes)),
                         dtype=torch.int32)
    return meta, table


def _both(make, run):
    """``run`` on ``make()``'s real CPU tensors and on fake copies: the
    outputs (and, when ``run`` returns them, gradients) and the kernels
    each count recorded."""
    real_in, copies = make(), make()
    real_out, real_k = _counted(lambda: run(*real_in))
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        fake_in = [fm.from_tensor(x).requires_grad_(x.requires_grad)
                   if isinstance(x, torch.Tensor) else x for x in copies]
        fake_out, fake_k = _counted(lambda: run(*fake_in))
    _same_meta(fake_out, real_out)
    assert fake_k == real_k
    return fake_k


def test_decode_stand_ins():
    n, r, b, kc = 5, 4, 8, 50
    got = _both(lambda: list(_decode_inputs(n, r, b, kc)),
                lambda m, t: md.mach_decode(m, t, num_classes=kc))
    assert got == {"mach_decode": {"count": 1, "flops": n * kc * r,
                                   "bytes": 4 * n * r * b + 4 * r * kc
                                   + 8 * n}}
    got = _both(lambda: list(_decode_inputs(n, r, b, kc)),
                lambda m, t: mt.mach_topk(m, t, num_classes=kc, k=3,
                                          estimator="median"))
    assert got["mach_topk"]["bytes"] == 4 * n * r * b + 4 * r * kc + 24 * n


def test_candidate_stand_ins():
    from repro_torch.core.hashing import inverted_table
    n, r, b, kc, m = 5, 4, 8, 50, 2

    def make():
        meta, table = _decode_inputs(n, r, b, kc)
        return [meta, inverted_table(table, b, device="cpu"), table]

    got = _both(make, lambda meta, inv, table: mc.mach_candidate_topk(
        meta, inv, table, num_classes=kc, k=3, m=m, t=2))
    ell = make()[1].shape[1]
    assert got["bucket_topm"]["bytes"] == 4 * n * r * b + 4 * n * r * (1 + m)
    assert got["mach_candidate_topk"] == {
        "count": 1, "flops": n * r * m * ell * r,
        "bytes": mc.work(n, r, b, m, ell, 3, kc, True)[1]}


def _grad_of(loss, *xs):
    return torch.autograd.grad(loss.sum(), xs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mach_xent_stand_ins(dtype):
    n, r, b = 6, 3, 16

    def make():
        g = torch.Generator().manual_seed(0)
        return [torch.randn((n, r, b), generator=g).to(dtype)
                .requires_grad_(),
                torch.randint(0, b, (n, r), generator=g, dtype=torch.int32)]

    got = _both(make, lambda lg, y: _grad_of(ops.mach_xent(lg, y), lg))
    es = dtype.itemsize
    assert got == {
        "mach_xent_fwd": {"count": 1, "flops": 4 * n * r * b,
                          "bytes": es * n * r * b + 4 * n * r + 4 * n},
        "mach_xent_bwd": {"count": 1, "flops": 4 * n * r * b,
                          "bytes": 2 * es * n * r * b + 4 * n * r + 4 * n}}


def test_fused_xent_stand_ins():
    n, d, r, b = 6, 12, 3, 8

    def dense():
        g = torch.Generator().manual_seed(1)
        return [torch.randn((n, d), generator=g).requires_grad_(),
                torch.randn((d, r * b), generator=g).requires_grad_(),
                torch.randn((r * b,), generator=g).requires_grad_(),
                torch.randint(0, b, (n, r), generator=g, dtype=torch.int32)]

    # the dense family's CPU path is its plain version under autograd:
    # fake tensors take the kernels' Function, so only shapes compare
    real = dense()
    out = mfx.mach_fused_xent_dense(*real, b)
    want = _grad_of(out[0], *real[:3])
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        fake = [fm.from_tensor(x).requires_grad_(x.requires_grad)
                for x in dense()]
        got, kernels = _counted(lambda: _grad_of(
            mfx.mach_fused_xent_dense(*fake, b)[0], *fake[:3]))
    _same_meta(got, want)
    assert kernels["dense_fwd"]["flops"] == 2 * n * d * r * b
    assert kernels["dense_bwd"]["flops"] == 6 * n * d * r * b

    def ell():
        g = torch.Generator().manual_seed(2)
        j = 4
        return [torch.randint(0, d + 1, (n, j), generator=g,
                              dtype=torch.int32),
                torch.rand((n, j), generator=g),
                torch.randn((d, r * b), generator=g).requires_grad_(),
                None,
                torch.randint(0, b, (n, r), generator=g, dtype=torch.int32)]

    got = _both(ell, lambda c, v, w, bias, y: _grad_of(
        mfx.mach_fused_xent_gather(c, v, w, bias, y, b)[0], w))
    assert got["gather_fwd"] == {"count": 1, "flops": 2 * n * 4 * r * b,
                                 "bytes": mfx.work("gather", n, d, r, b, j=4,
                                                   bias=False)[1]}
    assert got["gather_bwd"]["flops"] == 4 * n * 4 * r * b


def test_lm_kernel_stand_ins():
    bsz, t, h, kv, hd = 2, 8, 4, 2, 16

    def attn():
        g = torch.Generator().manual_seed(3)
        return [torch.randn((bsz, t, h, hd), generator=g).requires_grad_(),
                torch.randn((bsz, t, kv, hd), generator=g).requires_grad_(),
                torch.randn((bsz, t, kv, hd), generator=g).requires_grad_()]

    got = _both(attn, lambda q, k, v: _grad_of(
        ops.flash_attention(q, k, v, causal=True, window=None), q, k, v))
    assert got["flash_attention"] == {
        "count": 1, "flops": 4 * hd * bsz * h * fa.attended_pairs(t, None),
        "bytes": fa.work(bsz, t, t, h, kv, hd, torch.float32, True, None,
                         lse=True)[1]}
    assert got["flash_attention_bwd"]["flops"] == \
        10 * hd * bsz * h * fa.attended_pairs(t, None)

    def scan():
        g = torch.Generator().manual_seed(4)
        return [torch.rand((2, 7, 5), generator=g).requires_grad_(),
                torch.randn((2, 7, 5), generator=g).requires_grad_(),
                torch.zeros((2, 5)).requires_grad_()]

    got = _both(scan, lambda a, x, h0: _grad_of(ops.lru_scan(a, x, h0),
                                                a, x, h0))
    assert got == {"lru_scan": {"count": 1, "flops": 2 * 70,
                                "bytes": 3 * 4 * 70 + 4 * 10},
                   "lru_scan_bwd": {"count": 1, "flops": 3 * 70,
                                    "bytes": 5 * 4 * 70 + 8 * 10}}


# ------------------------------------------------- work() = PERF.md's bounds

def _bound_ms(work, rate) -> float:
    flops, nbytes = work
    return max(flops / rate, nbytes / HBM) * 1e3


# (kernel, work at chip_smoke.py's shape, rate of its operations, the
# bound PERF.md's kernel table prints, its digits)
BOUNDS = {
    "1 ODP table": (md.work(256, 25, 32, 105033, True), F32, 0.0100, 4),
    "2 ODP k=10": (mt.work(256, 25, 32, 105033, 10, True), F32, 0.0100, 4),
    "3 fwd LM head": (mx.work(8192, 8, 2048, torch.bfloat16), F32,
                      0.0802, 4),
    "3 bwd LM head": (mx.work(8192, 8, 2048, torch.bfloat16, True), F32,
                      0.1603, 4),
    # per repetition range of the head split 4 ways (R/n = 2)
    "3 fwd per range n=4": (mx.work(8192, 2, 2048, torch.bfloat16), F32,
                            0.0201, 4),
    "3 bwd per range n=4": (mx.work(8192, 2, 2048, torch.bfloat16, True),
                            F32, 0.0401, 4),
    "4 fwd ImageNet-21k f32": (mfx.work("dense", 512, 6144, 20, 512),
                               TF32 / 3, 0.391, 3),
    "4 bwd ImageNet-21k f32": (mfx.work("dense", 512, 6144, 20, 512,
                                        backward=True), TF32 / 3, 0.781, 3),
    "4 fwd LM head bf16": (mfx.work("dense", 8192, 2560, 8, 2048,
                                    torch.bfloat16, bias=False), BF16,
                           0.695, 3),
    "4 bwd LM head bf16": (mfx.work("dense", 8192, 2560, 8, 2048,
                                    torch.bfloat16, backward=True,
                                    need_dh=True, bias=False), BF16,
                           2.085, 3),
    # ODP's check batch: 32,148 distinct features of its 61,440 slots
    "5 fwd ODP": (mfx.work("ell", 512, 422713, 25, 32, j=120,
                           unique=32148), F32, 0.0309, 4),
    "5 bwd ODP": (mfx.work("ell", 512, 422713, 25, 32, j=120, unique=32148,
                           backward=True), F32, 0.4347, 4),
    "7 ODP exact": (mc.topm_work(256, 25, 32, 32), F32, 0.00050, 5),
    "8 ODP exact (672.2 M gathers)": (mc.work(256, 25, 32, 32, 1, 10, 105033,
                                              True, gathers=672_200_000,
                                              rows=800, classes=0), F32,
                                      0.01003, 5),
    "9 fwd prefill": (ls.work(1, 4096, 2560, torch.float32), F32, 0.0376, 4),
    "9 fwd training": (ls.work(2, 4096, 2560, torch.float32), F32, 0.0751,
                       4),
    "9 bwd training": (ls.work(2, 4096, 2560, torch.float32, True), F32,
                       0.1252, 4),
    "10 fwd prefill": (fa.work(1, 4096, 4096, 10, 1, 256, torch.bfloat16,
                               True, 2048), BF16, 0.0652, 4),
    "10 bwd training": (fa.work(2, 4096, 4096, 10, 1, 256, torch.bfloat16,
                                True, 2048, backward=True), BF16, 0.3258, 4),
}


@pytest.mark.parametrize("case", sorted(BOUNDS))
def test_work_gives_the_printed_bounds(case):
    work, rate, printed, digits = BOUNDS[case]
    assert round(_bound_ms(work, rate), digits) == printed


def test_full_width_stand_ins_record_their_work():
    """At chip_smoke.py's full shapes fake tensors allocate nothing: the
    LM head's kernel 3 and tinyllama's training kernel 10 record the
    closed forms."""
    with FakeTensorMode():
        lg = torch.empty((8192, 8, 2048), dtype=torch.bfloat16,
                         requires_grad=True)
        y = torch.empty((8192, 8), dtype=torch.int32)
        q = torch.empty((2, 4096, 32, 64), dtype=torch.bfloat16,
                        requires_grad=True)
        k = torch.empty((2, 4096, 4, 64), dtype=torch.bfloat16,
                        requires_grad=True)
        _, got = _counted(lambda: (
            _grad_of(ops.mach_xent(lg, y), lg),
            _grad_of(ops.flash_attention(q, k, k, causal=True, window=None),
                     q, k)))
    pairs = 2 * 32 * fa.attended_pairs(4096, None)
    assert got["mach_xent_fwd"]["bytes"] == 2 * 8192 * 8 * 2048 + 4 * 8192 * 9
    assert got["flash_attention"]["flops"] == 4 * 64 * pairs
    assert got["flash_attention_bwd"]["flops"] == 10 * 64 * pairs
    assert math.isclose(_bound_ms((got["flash_attention_bwd"]["flops"], 0),
                                  BF16), 0.3475, abs_tol=5e-5)
