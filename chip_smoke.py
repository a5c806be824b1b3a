#!/usr/bin/env python3
"""Drive the PyTorch port of MACH serving (Algorithm 2) and training
(Algorithm 1, through the fused logit-free loss) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure exits non-zero and prints no result:

1. Device: requires CUDA, prints the card's name and power limit as
   ``nvidia-smi`` gives them, turns TF32 off.
2. Build: compiles every kernel from ``src/repro_torch/kernels/csrc``.
3. Kernels vs plain on the card: the top-1 and streaming top-k kernels
   against their plain PyTorch versions — table and inline hashing, the
   three estimators, k in {1, 10, 100}, the ODP shape (R=25, B=32), the
   ImageNet-21k shape (R=20, B=512, even-R median) and a tiny-B, tiny-R
   shape where classes collide in bulk, with ragged N and K.  Dyadic
   inputs (multiples of 2^-10) must agree exactly, values and indices;
   random inputs to rtol 1e-6, indices equal except on near-ties.
4. Main path at full ODP width: ``MACHLinear`` (K=105,033, d=422,713,
   B=32, R=25) with seeded random weights answers a 256-query CSR batch
   (nnz=120) through ``predict`` and ``estimators.predict_topk(k=10)``
   for each estimator, and ``ops.mach_top1``.  Launch counters are set
   to 0 just before and read just after; both kernels must have run.
   Then ms per answer, kernel ms, plain ms, the ``torch.topk`` yardstick
   and peak memory.
5. Fused-xent kernels vs plain on the card, forward and backward: the
   dense, ELL and gather families against their plain PyTorch versions
   (loss, lse, dW, dbias, dh) at the ODP shape (R=25, B=32), the
   ImageNet-21k shape (R=20, B=512) and an odd one (B=37, R·B=259,
   ragged N), with and without bias; CSR batches with duplicate ids, a
   row at exactly nnz_max, short and empty rows, at nnz 120 and 1,024
   through both sparse families.  Loss and lse to rtol 1e-5, gradients
   to rtol 1e-4 / atol 1e-6 (float atomics reduce them across blocks);
   each backward runs twice and the largest difference is printed.
6. Training main path at full width: ``MACHLinear(fused=True)`` with
   AdamW (lr 0.05) — ODP (K=105,033, d=422,713, B=32, R=25, CSR nnz=120,
   N=512) 5 steps through the ELL kernels; the same model 2 steps on
   nnz=1,024 batches through the gather kernels; ImageNet-21k (K=21,841,
   d=6,144, B=512, R=20, dense, N=512) 3 steps through the dense
   kernels.  Launch counters are set to 0 just before and read just
   after; all six launch functions must have run, every loss must be
   finite, and each first step's loss and gradients must equal the plain
   version's.  Then ms per step, stage times, peak memory.
7. The kernel report (one JSON line), then the device line, last.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM float32, outside the tensor cores
ESTIMATORS = ("unbiased", "min", "median")
N_MAIN, K_MAIN = 256, 10
# kernel-vs-plain shapes: (label, N, R, B, K) — ragged N and K tails
CHECK_SHAPES = [("odp", 37, 25, 32, 105033), ("imagenet21k", 37, 20, 512, 21841),
                ("collide", 5, 4, 2, 5003)]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def kernel_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, runs: int = 7, warmup: int = 2) -> float:
    """Median host time of a call that ends in a device synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(n: int, r: int, b: int, num_classes: int, k: int,
             table: bool) -> tuple[float, str]:
    """Least time for the decode on this card: bytes (probabilities,
    the table in table mode, outputs) over HBM rate vs one float32
    operation per gathered value (N·K·R) over the float32 rate."""
    nbytes = 4 * n * r * b + (4 * r * num_classes if table else 0) + 8 * n * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * num_classes * r / F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phase 3: kernels vs their plain versions
# ---------------------------------------------------------------------------

def _inputs(n, r, b, dyadic, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dyadic:
        return torch.randint(0, 1025, (n, r, b), generator=gen,
                             device=dev).float() / 1024
    return torch.softmax(torch.randn((n, r, b), generator=gen, device=dev), -1)


def _check_same(name, kv, ki, pv, pi, scores, exact) -> float:
    """Kernel (kv, ki) vs plain (pv, pi); returns max |value error|."""
    kv, ki, pv, pi = (t.reshape(t.shape[0], -1) for t in (kv, ki, pv, pi))
    if not torch.isfinite(kv).all():
        fail(f"{name}: non-finite kernel values")
    err = float((kv - pv).abs().max())
    if exact:
        if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
            bad = (ki != pi).any(-1).nonzero()[:3].flatten().tolist()
            fail(f"{name}: dyadic kernel != plain (rows {bad}, max err {err})")
        return err
    if not torch.allclose(kv, pv, rtol=1e-6, atol=1e-7):
        fail(f"{name}: values off by {err}")
    # indices may differ only where the plain scores tie within rtol
    at_kernel = torch.gather(scores, 1, ki.long())
    if not torch.allclose(at_kernel, pv, rtol=1e-6, atol=1e-7):
        fail(f"{name}: kernel indices not near-ties of the plain ones")
    for row in ki.tolist():
        if len(set(row)) != len(row):
            fail(f"{name}: duplicate class ids in a row")
    return err


def phase_kernels_vs_plain(dev) -> int:
    from repro_torch.core.hashing import MultShiftFamily
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt

    checked = 0
    for label, n, r, b, num_classes in CHECK_SHAPES:
        fam = MultShiftFamily(b, r, seed=1)
        table = fam.table(num_classes, dev)
        coeffs, shift = fam.coeffs_tensor(dev), fam.shift
        for dyadic in (True, False):
            meta = _inputs(n, r, b, dyadic, seed=r * b, dev=dev)
            sums = md.summed_scores(meta, table)
            for mode in ("table", "inline"):
                hash_kw = ({"table": table} if mode == "table" else
                           {"inline_coeffs": coeffs, "inline_shift": shift})
                tag = f"{label} n={n} {'dyadic' if dyadic else 'random'} {mode}"
                kv, ki = md.mach_decode_cuda(meta, num_classes=num_classes,
                                             **hash_kw)
                pv, pi = md.mach_decode_plain(meta, num_classes=num_classes,
                                              **hash_kw)
                torch.cuda.synchronize()
                _check_same(f"top1 {tag}", kv, ki, pv, pi, sums, dyadic)
                checked += 1
                for est in ESTIMATORS:
                    scores = mt.estimator_scores(meta, table, est)
                    for k in (1, 10, 100):
                        kv, ki = mt.mach_topk_cuda(meta, num_classes=num_classes,
                                                   k=k, estimator=est, **hash_kw)
                        pv, pi = mt.mach_topk_plain(meta, num_classes=num_classes,
                                                    k=k, estimator=est, **hash_kw)
                        torch.cuda.synchronize()
                        _check_same(f"topk {est} k={k} {tag}", kv, ki, pv, pi,
                                    scores, dyadic)
                        checked += 1
        print(f"kernels vs plain: {label} (N={n}, R={r}, B={b}, K={num_classes})"
              f" ok", flush=True)
    return checked


# ---------------------------------------------------------------------------
# phase 4: the main path at full ODP width
# ---------------------------------------------------------------------------

def phase_main_path(dev) -> list[dict]:
    from repro_torch.configs.odp_mach import ODP
    from repro_torch.core import estimators as est
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import SparseExtremeDataset
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cfg = ODP.mach()
    head = MACHLinear(cfg, ODP.dim)
    params = head.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    data = SparseExtremeDataset(ODP.sparse_data(small=False), device=dev)
    batch, _ = data.batch_at(0, N_MAIN)
    table = head.table(dev)
    fam = cfg.family
    coeffs, shift = fam.coeffs_tensor(dev), fam.shift
    K, R, B = cfg.num_classes, cfg.num_repetitions, cfg.num_buckets
    torch.cuda.synchronize()
    print(f"main path: ODP K={K} d={ODP.dim} B={B} R={R}, batch N={N_MAIN} "
          f"nnz<={batch.nnz_max}, set-up {time.perf_counter() - t0:.1f} s",
          flush=True)

    def meta_nrb():
        return head.meta_probs(params, batch).movedim(0, -2)

    answers = {f"predict[{e}]": (lambda e=e: head.predict(params, batch, e))
               for e in ESTIMATORS}
    answers.update({
        f"predict_topk[{e},k={K_MAIN}]":
            (lambda e=e: est.predict_topk(head.meta_probs(params, batch),
                                          table, K_MAIN, e))
        for e in ESTIMATORS})
    answers["predict_topk[unbiased,k=1]"] = lambda: est.predict_topk(
        head.meta_probs(params, batch), table, 1, "unbiased")
    answers["mach_top1[inline]"] = lambda: ops.mach_top1(
        meta_nrb(), num_classes=K, inline_coeffs=coeffs, inline_shift=shift)

    # the main path's run: counts from 0, read just after
    torch.cuda.reset_peak_memory_stats(dev)
    md.mach_decode_cuda.launches = 0
    mt.mach_topk_cuda.launches = 0
    out = {name: fn() for name, fn in answers.items()}
    torch.cuda.synchronize()
    launches = {"mach_decode": md.mach_decode_cuda.launches,
                "mach_topk": mt.mach_topk_cuda.launches}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"main path launches: {launches}, peak memory {peak_gib:.2f} GiB",
          flush=True)
    for name, count in launches.items():
        if count < 1:
            fail(f"kernel {name} never launched on the main path")

    # right answers: shapes, finiteness, kernel == plain on this batch,
    # and greedy agreement (top-1 = top-k(k=1) = predict, up to near-ties)
    meta = meta_nrb().contiguous()
    sums = md.summed_scores(meta, table)
    for name, res in out.items():
        vals = res if isinstance(res, torch.Tensor) else res[0]
        if not torch.isfinite(vals.float()).all():
            fail(f"{name}: non-finite output")
    errs = {"mach_decode": 0.0, "mach_topk": 0.0}
    kv, ki = md.mach_decode_cuda(meta, num_classes=K, inline_coeffs=coeffs,
                                 inline_shift=shift)
    pv, pi = md.mach_decode_plain(meta, num_classes=K, inline_coeffs=coeffs,
                                  inline_shift=shift)
    errs["mach_decode"] = _check_same("main mach_top1", kv, ki, pv, pi, sums,
                                      exact=True)
    for e in ESTIMATORS:
        kv, ki = mt.mach_topk_cuda(meta, table, num_classes=K, k=K_MAIN,
                                   estimator=e)
        pv, pi = mt.mach_topk_plain(meta, table, num_classes=K, k=K_MAIN,
                                    estimator=e)
        errs["mach_topk"] = max(errs["mach_topk"], _check_same(
            f"main topk {e}", kv, ki, pv, pi, None, exact=True))
        if tuple(out[f"predict_topk[{e},k={K_MAIN}]"][1].shape) != (N_MAIN, K_MAIN):
            fail(f"predict_topk[{e}] has the wrong shape")
    top1 = out["mach_top1[inline]"][1].long()
    for other in (out["predict_topk[unbiased,k=1]"][1][:, 0].long(),
                  out["predict[unbiased]"].long()):
        a = torch.gather(sums, 1, top1[:, None])
        c = torch.gather(sums, 1, other[:, None])
        if not torch.allclose(a, c, rtol=1e-6, atol=0):
            fail("greedy answers disagree beyond near-ties")
    n_diff = int((top1 != out["predict[unbiased]"].long()).sum())
    print(f"main path answers ok: kernels == plain exactly; greedy top-1 "
          f"agrees with predict on {N_MAIN - n_diff}/{N_MAIN} queries, the rest "
          f"near-ties", flush=True)

    for name, fn in answers.items():
        print(f"answer {name}: {wall_ms(fn):.3f} ms/batch", flush=True)
    print(f"stage meta_probs (CSR densify + f32 projection + softmax): "
          f"{wall_ms(meta_nrb):.3f} ms/batch", flush=True)

    # kernel, plain and library times on the main path's inputs
    smi = _nvidia_smi()
    rows = []
    decode_kw = {"num_classes": K, "inline_coeffs": coeffs, "inline_shift": shift}
    t_bound, by = bound_ms(N_MAIN, R, B, K, 1, table=False)
    rows.append({
        "name": "mach_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mach_decode.cu",
        "replaces": "src/repro/kernels/mach_decode.py:202",
        "launches": launches["mach_decode"],
        "max_abs_err": errs["mach_decode"],
        "ms": kernel_ms(lambda: md.mach_decode_cuda(meta, **decode_kw)),
        "plain_ms": kernel_ms(lambda: md.mach_decode_plain(meta, **decode_kw),
                              iters=5),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": kernel_ms(lambda: torch.max(sums, dim=-1)),
        "shape": f"N={N_MAIN} R={R} B={B} K={K} inline hash",
    })
    ms_est, plain_est = {}, {}
    for e in ESTIMATORS:
        ms_est[e] = kernel_ms(lambda e=e: mt.mach_topk_cuda(
            meta, table, num_classes=K, k=K_MAIN, estimator=e))
        plain_est[e] = kernel_ms(lambda e=e: mt.mach_topk_plain(
            meta, table, num_classes=K, k=K_MAIN, estimator=e), iters=5)
    ms_inline = kernel_ms(lambda: mt.mach_topk_cuda(
        meta, num_classes=K, k=K_MAIN, inline_coeffs=coeffs,
        inline_shift=shift))
    ms_k100 = kernel_ms(lambda: mt.mach_topk_cuda(
        meta, table, num_classes=K, k=100))
    t_bound, by = bound_ms(N_MAIN, R, B, K, K_MAIN, table=True)
    rows.append({
        "name": "mach_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mach_topk.cu",
        "replaces": "src/repro/kernels/mach_topk.py:132",
        "launches": launches["mach_topk"],
        "max_abs_err": errs["mach_topk"],
        "ms": ms_est["unbiased"], "plain_ms": plain_est["unbiased"],
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": kernel_ms(lambda: torch.topk(sums, K_MAIN, dim=-1)),
        "shape": f"N={N_MAIN} R={R} B={B} K={K} k={K_MAIN} table hash, unbiased",
        "ms_by_estimator": ms_est, "plain_ms_by_estimator": plain_est,
        "ms_unbiased_inline": ms_inline, "ms_unbiased_k100": ms_k100,
    })
    # yardstick with the scores' materialization: a float32 GEMM against
    # the (R·B, K) multi-hot matrix (a model constant), then torch.topk
    multihot = torch.nn.functional.one_hot(table.long(), B).permute(0, 2, 1) \
        .reshape(R * B, K).float()
    meta2d = meta.reshape(N_MAIN, R * B)
    gemm_topk = kernel_ms(lambda: torch.topk(meta2d @ multihot, K_MAIN, dim=-1))
    del multihot
    for row in rows:
        print(f"kernel {row['name']}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, torch.topk/max over materialized "
              f"scores {row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f}"
              f" ms ({row['bound_by']}), launches {row['launches']} [{smi}]",
              flush=True)
    print(f"kernel mach_topk by estimator (k={K_MAIN}, table): "
          + ", ".join(f"{e} {ms_est[e]:.4f} ms (plain {plain_est[e]:.4f})"
                      for e in ESTIMATORS)
          + f"; unbiased inline {ms_inline:.4f} ms; unbiased k=100 "
            f"{ms_k100:.4f} ms [{smi}]", flush=True)
    print(f"yardstick: multi-hot f32 GEMM + torch.topk (scores materialized) "
          f"{gemm_topk:.4f} ms [{smi}]", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 5: fused-xent kernels vs their plain versions, forward and backward
# ---------------------------------------------------------------------------

# loss and lse: rtol 1e-5 (f32 products and sums in another order than
# cuBLAS / torch.logsumexp); gradients rtol 1e-4, atol 1e-6 (the kernels
# reduce dW, dh and dbias with float atomics across blocks, in an order
# that changes from run to run).  Inputs at the model's own scales: unit
# L2 rows of features (as the data generators make them), dense W at its
# init scale 1/sqrt(d), and a N(0, 1) bias so each head's softmax is far
# from uniform; at those scales the f32 order noise of a d-long product
# stays below atol in entries that cancel to near zero.
LOSS_TOL = {"rtol": 1e-5, "atol": 1e-6}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-6}
# dense checks: (label, N, d, R, B) — ragged N; B=37 is no multiple of 32
# and R·B = 259 no multiple of the 128-column tile
XENT_DENSE_SHAPES = [("odp", 37, 2000, 25, 32),
                     ("imagenet21k", 37, 6144, 20, 512),
                     ("odd", 29, 333, 7, 37)]
# sparse checks: (label, N, d, R, B, nnz_max)
XENT_SPARSE_SHAPES = [("odp nnz=120", 37, 50000, 25, 32, 120),
                      ("odp nnz=1024", 11, 50000, 25, 32, 1024),
                      ("odd", 29, 3001, 7, 37, 50)]
N_TRAIN = 512


def _csr_check_batch(dev, n, d, nnz_max, seed):
    """A CSR batch with a row at exactly nnz_max holding duplicate ids,
    a short row, an empty row and ragged rest."""
    from repro_torch.data.extreme import SparseBatch
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(1, nnz_max + 1, (n,), generator=gen, device=dev)
    lengths[0], lengths[1], lengths[2] = nnz_max, 2, 0
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(lengths, 0)])
    total = int(indptr[-1])
    indices = torch.randint(0, d, (total,), generator=gen, device=dev)
    indices[1:4] = indices[0]
    values = torch.rand((total,), generator=gen, device=dev)
    rows = torch.repeat_interleave(torch.arange(n, device=dev), lengths)
    sq = torch.zeros(n, device=dev).index_add_(0, rows, values * values)
    values = values / torch.sqrt(sq.clamp(min=1e-12))[rows]    # unit rows
    return SparseBatch(indptr.to(torch.int32), indices.to(torch.int32), values,
                       d, nnz_max)


def _loss_and_grads(fn, leaves, g):
    """(loss, lse, grads) of fn() -> (loss, lse), under cotangent g."""
    loss, lse = fn()
    grads = torch.autograd.grad((loss * g).sum(), leaves)
    torch.cuda.synchronize()
    return loss.detach(), lse, [t.detach() for t in grads]


def _compare(tag, got, want, names) -> float:
    """Kernel (loss, lse, grads) vs plain; returns the max abs error."""
    err = 0.0
    pairs = [("loss", got[0], want[0], LOSS_TOL), ("lse", got[1], want[1], LOSS_TOL)]
    pairs += [(f"d{name}", a, b, GRAD_TOL)
              for name, a, b in zip(names, got[2], want[2])]
    for name, a, b, tol in pairs:
        if not torch.isfinite(a).all():
            fail(f"{tag}: non-finite kernel {name}")
        e = float((a - b).abs().max())
        if not torch.allclose(a, b, **tol):
            fail(f"{tag}: kernel {name} differs from plain by up to {e}")
        err = max(err, e)
    return err


def _run_to_run(fn, leaves, g) -> float:
    """Largest difference between the gradients of two backward runs."""
    a = _loss_and_grads(fn, leaves, g)[2]
    b = _loss_and_grads(fn, leaves, g)[2]
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def phase_xent_vs_plain(dev) -> dict:
    """Each family's kernels (forward + backward) against the plain
    version, with and without bias.  Returns per family the max abs
    error and the run-to-run backward difference."""
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import ops

    stats = {f: {"max_abs_err": 0.0, "run_to_run": 0.0}
             for f in ("dense", "ell", "gather")}

    def record(family, err, r2r):
        s = stats[family]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["run_to_run"] = max(s["run_to_run"], r2r)

    for label, n, d, r, b in XENT_DENSE_SHAPES:
        for bias in (True, False):
            gen = torch.Generator(device=dev).manual_seed(d + b)
            h = torch.nn.functional.normalize(
                torch.randn((n, d), generator=gen, device=dev), dim=1)
            w = torch.randn((d, r * b), generator=gen, device=dev) / d ** 0.5
            bb = torch.randn((r * b,), generator=gen, device=dev) \
                if bias else None
            y = torch.randint(0, b, (n, r), generator=gen, device=dev,
                              dtype=torch.int32)
            g = torch.rand((n,), generator=gen, device=dev) + 0.5
            leaves = [t.requires_grad_(True) for t in (h, w, bb) if t is not None]
            names = ["h", "W"] + (["bias"] if bias else [])
            kern = lambda: mfx.mach_fused_xent_dense(h, w, bb, y, b)
            err = _compare(f"dense {label} bias={bias}",
                           _loss_and_grads(kern, leaves, g),
                           _loss_and_grads(lambda: mfx.fused_xent_dense_plain(
                               h, w, bb, y, b), leaves, g), names)
            record("dense", err, _run_to_run(kern, leaves, g))
        print(f"fused xent vs plain: dense {label} (N={n}, d={d}, R={r}, "
              f"B={b}) ok, with and without bias", flush=True)

    for label, n, d, r, b, nnz_max in XENT_SPARSE_SHAPES:
        batch = _csr_check_batch(dev, n, d, nnz_max, seed=nnz_max)
        cols, vals = ops.csr_to_ell(batch.indptr, batch.indices, batch.values,
                                    nnz_max, d)
        for bias in (True, False):
            gen = torch.Generator(device=dev).manual_seed(d + b + nnz_max)
            # unit rows of W's products: logits of order 1 from the
            # product itself (dW does not scale with W)
            w = torch.randn((d, r * b), generator=gen, device=dev)
            bb = torch.randn((r * b,), generator=gen, device=dev) \
                if bias else None
            y = torch.randint(0, b, (n, r), generator=gen, device=dev,
                              dtype=torch.int32)
            g = torch.rand((n,), generator=gen, device=dev) + 0.5
            leaves = [t.requires_grad_(True) for t in (w, bb) if t is not None]
            names = ["W"] + (["bias"] if bias else [])
            want = _loss_and_grads(lambda: mfx.fused_xent_ell_plain(
                cols, vals, w, bb, y, b), leaves, g)
            for impl, family in (("densify", "ell"), ("gather", "gather")):
                kern = lambda f=family: getattr(mfx, f"mach_fused_xent_{f}")(
                    cols, vals, w, bb, y, b)
                err = _compare(f"{family} {label} bias={bias}",
                               _loss_and_grads(kern, leaves, g), want, names)
                via_ops = ops.mach_fused_xent_csr(
                    batch.indptr, batch.indices, batch.values, w, y,
                    num_buckets=b, nnz_max=nnz_max, bias=bb,
                    sparse_impl=impl).detach()
                if not torch.allclose(via_ops, want[0], **LOSS_TOL):
                    fail(f"ops.mach_fused_xent_csr(sparse_impl={impl!r}) "
                         f"{label}: loss differs from plain")
                record(family, err, _run_to_run(kern, leaves, g))
        print(f"fused xent vs plain: ell and gather {label} (N={n}, d={d}, "
              f"R={r}, B={b}, nnz_max={nnz_max}, duplicates, empty and short "
              f"rows) ok, with and without bias", flush=True)
    for family, s in stats.items():
        print(f"fused xent {family}: max abs error vs plain "
              f"{s['max_abs_err']:.3e}; largest backward difference between "
              f"two runs {s['run_to_run']:.3e} (float atomics)", flush=True)
    return stats


# ---------------------------------------------------------------------------
# phase 6: the training main path at full width
# ---------------------------------------------------------------------------

def _bound(family, n, d, r, b, nnz=0, unique=0, j=0):
    """Least time (ms) for the forward and the backward on this card, and
    what bounds each.  Dense: 2·N·d·R·B operations forward, 6·N·d·R·B
    backward (the logits again, then dW and dh).  Sparse: 2·nnz·R·B and
    4·nnz·R·B over this batch's valid slots; bytes count the W rows this
    batch touches once, the ELL batch, labels and lse, and every output
    once — the dense dW (d·R·B) included.  The dense backward is timed
    as the main path runs it, without dh (its input features need no
    gradient): 4·N·d·R·B operations."""
    c = r * b
    if family == "dense":
        ops_f, ops_b = 2 * n * d * c, 4 * n * d * c
        bytes_f = 4 * (n * d + d * c + c + n * r) + 4 * (n + n * r)
        bytes_b = 4 * (n * d + d * c + c + 2 * n * r + n) + 4 * (d * c + c)
    else:
        ops_f, ops_b = 2 * nnz * c, 4 * nnz * c
        ell = 8 * n * j
        bytes_f = 4 * unique * c + ell + 4 * (c + n * r) + 4 * (n + n * r)
        bytes_b = 4 * unique * c + ell + 4 * (c + 2 * n * r + n) + 4 * (d * c + c)
    out = []
    for ops_, bytes_ in ((ops_f, bytes_f), (ops_b, bytes_b)):
        t_ops = ops_ / F32_OPS_PER_S * 1e3
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        out.append((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"))
    return out


def _train(head, params, batch_at, steps, opt, state):
    """``steps`` AdamW steps; returns (params, state, losses, step ms,
    first step's (params before, batch, loss, grads))."""
    from repro_torch.optim import apply_updates, value_and_grad
    losses, times, first = [], [], None
    for s in range(steps):
        x, y = batch_at(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(head.loss, params, x, y)
        upd, state = opt.update(grads, state, params)
        new = apply_updates(params, upd)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if s == 0:
            first = (params, (x, y), loss, grads)
        params = new
        del upd, grads
    return params, state, losses, times, first


def phase_training(dev, checks: dict) -> list[dict]:
    import dataclasses
    from repro_torch.configs.odp_mach import IMAGENET, ODP
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import (ExtremeDataConfig, ExtremeDataset,
                                          SparseExtremeDataset)
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw

    t0 = time.perf_counter()
    odp_head = MACHLinear(ODP.mach(), ODP.dim, fused=True)
    odp_params = odp_head.init(torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    odp_data = SparseExtremeDataset(ODP.sparse_data(small=False), device=dev)
    bow_data = SparseExtremeDataset(
        dataclasses.replace(ODP.sparse_data(small=False), nnz=1024), device=dev)
    img_cfg = IMAGENET.mach()
    img_head = MACHLinear(img_cfg, IMAGENET.dim, fused=True)
    img_params = img_head.init(torch.Generator(device=dev).manual_seed(1),
                               device=dev)
    img_data = ExtremeDataset(ExtremeDataConfig(IMAGENET.num_classes,
                                                IMAGENET.dim), device=dev)
    torch.cuda.synchronize()
    print(f"training main path: set-up {time.perf_counter() - t0:.1f} s",
          flush=True)

    runs = {  # name: (head, params, batch_at, steps, family)
        "odp": (odp_head, odp_params,
                lambda s: odp_data.batch_at(s, N_TRAIN), 5, "ell"),
        "odp_bow": (odp_head, None,
                    lambda s: bow_data.batch_at(s, N_TRAIN), 2, "gather"),
        "imagenet21k": (img_head, img_params,
                        lambda s: img_data.batch_at(s, N_TRAIN), 3, "dense"),
    }
    opt = adamw(0.05)
    results = {}
    # the main path's run: counts from 0, read just after
    for fn in mfx.CUDA_WRAPPERS:
        fn.launches = 0
    odp_state = None
    for name, (head, params, batch_at, steps, family) in runs.items():
        if name == "odp_bow":        # the same ODP model, trained on
            params, state = results["odp"]["params"], odp_state
        else:
            state = opt.init(params)
        torch.cuda.reset_peak_memory_stats(dev)
        params, state, losses, times, first = _train(head, params, batch_at,
                                                     steps, opt, state)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        results[name] = {"params": params, "losses": losses, "times": times,
                         "first": first, "peak_gib": peak, "family": family,
                         "head": head, "state": state}
        if name == "odp":
            odp_state = state
        print(f"train {name}: {steps} AdamW steps through {family}, losses "
              f"{[round(v, 4) for v in losses]}, peak memory {peak:.2f} GiB",
              flush=True)
    launches = {fn.__name__: fn.launches for fn in mfx.CUDA_WRAPPERS}
    print(f"training main path launches: {launches}", flush=True)
    for fn_name, count in launches.items():
        if count < 1:
            fail(f"{fn_name} never launched on the training main path")
    for name, res in results.items():
        if not all(math.isfinite(v) for v in res["losses"]):
            fail(f"train {name}: non-finite loss {res['losses']}")
    r0 = results["odp"]["losses"][0]
    if abs(r0 - ODP.mach_r * math.log(ODP.mach_b)) > 5.0:
        fail(f"ODP first loss {r0} far from R ln B at random init")

    smi = _nvidia_smi()
    rows = []
    kernel_names = {"dense": ("mach_fused_xent_dense",
                              "src/repro/kernels/mach_fused_xent.py:724"),
                    "ell": ("mach_fused_xent_ell",
                            "src/repro/kernels/mach_fused_xent.py:848"),
                    "gather": ("mach_fused_xent_gather",
                               "src/repro/kernels/mach_fused_xent.py:983")}
    for name, res in results.items():
        head, family = res["head"], res["family"]
        params0, (x, y), loss0, grads0 = res["first"]
        c = head.cfg
        n, r, b, d = N_TRAIN, c.num_repetitions, c.num_buckets, head.dim
        w2 = params0["w"].reshape(d, -1).detach().requires_grad_(True)
        bias = params0["b"].reshape(-1).detach().requires_grad_(True)
        labels = c.hash_labels(y).movedim(0, -1).to(torch.int32).contiguous()
        g = torch.full((n,), 1.0 / n, device=dev)
        if family == "dense":
            inputs = (x.contiguous(),)
            plain = lambda: mfx.fused_xent_dense_plain(x, w2, bias, labels, b)
            fwd, bwd = mfx.dense_fwd_cuda, mfx.dense_bwd_cuda
            nnz = unique = j = 0
        else:
            cols, vals = ops.csr_to_ell(x.indptr, x.indices, x.values,
                                        x.nnz_max, d)
            inputs = (cols, vals)
            plain = lambda: mfx.fused_xent_ell_plain(cols, vals, w2, bias,
                                                     labels, b)
            fwd = getattr(mfx, f"{family}_fwd_cuda")
            bwd = getattr(mfx, f"{family}_bwd_cuda")
            valid = (cols >= 0) & (cols < d)
            nnz = int(valid.sum())
            unique = int(torch.unique(cols[valid]).numel())
            j = cols.shape[1]
        # first step == plain: the mean loss and its gradients (the
        # summed-loss scale is held by the checks above, at smaller N)
        pl, _, pgrads = _loss_and_grads(plain, [w2, bias], g)
        err = abs(float(loss0) - float(pl.sum() / n))
        if not math.isclose(float(loss0), float(pl.sum() / n), rel_tol=1e-5):
            fail(f"train {name}: first loss {float(loss0)} != plain "
                 f"{float(pl.sum() / n)}")
        for key, pg in (("w", pgrads[0]), ("b", pgrads[1])):
            kg = grads0[key].reshape(pg.shape)
            e = float((kg - pg).abs().max())
            if not torch.allclose(kg, pg, **GRAD_TOL):
                fail(f"train {name}: first-step d{key} differs from plain by {e}")
            print(f"train {name}: first-step d{key} max abs error {e:.3e} "
                  f"(largest entry {float(pg.abs().max()):.3e})", flush=True)
            err = max(err, e)
        # stage times on the first step's inputs (CUDA events)
        _, lse = fwd(*inputs, w2.detach(), bias.detach(), labels, b)
        ms_fwd = kernel_ms(lambda: fwd(*inputs, w2.detach(), bias.detach(),
                                       labels, b), iters=10)
        bwd_kw = {"need_dh": False} if family == "dense" else {}
        ms_bwd = kernel_ms(lambda: bwd(*inputs, w2.detach(), bias.detach(),
                                       labels, lse, g, b, **bwd_kw), iters=10)
        state = res["state"]
        ms_adamw = kernel_ms(lambda: opt.update(grads0, state, params0),
                             iters=5, warmup=1)
        plain_ms = kernel_ms(lambda: _loss_and_grads(plain, [w2, bias], g),
                             iters=3, warmup=1)
        library_ms = kernel_ms(
            lambda: _library_xent(family, x, w2, bias, labels, b, n, r, d),
            iters=3, warmup=1)
        step_ms = statistics.median(res["times"][1:])
        (bf, byf), (bb_, byb) = _bound(family, n, d, r, b, nnz, unique, j)
        print(f"train {name}: {step_ms:.3f} ms/step (host clock, median of "
              f"steps 2..{len(res['times'])}); stages: forward kernel "
              f"{ms_fwd:.3f} ms, backward kernel {ms_bwd:.3f} ms (dW zero-fill "
              f"included), AdamW {ms_adamw:.3f} ms; peak "
              f"{res['peak_gib']:.2f} GiB [{smi}]", flush=True)
        kname, replaces = kernel_names[family]
        row = {
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
            "replaces": replaces,
            "launches": launches[f"{family}_fwd_cuda"]
            + launches[f"{family}_bwd_cuda"],
            "launches_fwd": launches[f"{family}_fwd_cuda"],
            "launches_bwd": launches[f"{family}_bwd_cuda"],
            "max_abs_err": err,
            "ms": ms_fwd + ms_bwd, "ms_fwd": ms_fwd, "ms_bwd": ms_bwd,
            "plain_ms": plain_ms, "bound_ms": bf + bb_,
            "bound_by": byf if bf >= bb_ else byb,
            "bound_ms_fwd": bf, "bound_by_fwd": byf,
            "bound_ms_bwd": bb_, "bound_by_bwd": byb,
            "library_ms": library_ms,
            "shape": (f"{name}: N={n} d={d} R={r} B={b}"
                      + (f" ELL J={j}, {nnz} valid slots, {unique} "
                         f"distinct features" if family != "dense" else "")
                      + ", with bias; forward + backward"),
            "train_step_ms": step_ms, "adamw_ms": ms_adamw,
            "peak_gib": res["peak_gib"],
            "check_max_abs_err": checks[family]["max_abs_err"],
            "run_to_run_max_diff": checks[family]["run_to_run"]}
        if family == "dense":
            row["ms_bwd_with_dh"] = kernel_ms(lambda: bwd(
                *inputs, w2.detach(), bias.detach(), labels, lse, g, b),
                iters=10)
        rows.append(row)
        print(f"kernel {kname} ({name}): forward {ms_fwd:.4f} ms + backward "
              f"{ms_bwd:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{library_ms:.4f} ms, bound {bf:.4f} ({byf}) + {bb_:.4f} "
              f"({byb}) ms, launches {row['launches']}, first-step max abs "
              f"err {err:.3e} [{smi}]", flush=True)
        del res["params"], res["first"], res["state"]
    return rows


def _library_xent(family, x, w2, bias, labels, b, n, r, d):
    """The materializing computation in PyTorch library calls (never used
    by the port): the logits by torch.matmul (dense) or torch.sparse.mm
    on the CSR batch, F.cross_entropy on the (N·R, B) view, autograd."""
    leaves = [w2, bias]
    if family == "dense":
        logits = x @ w2
    else:
        csr = torch.sparse_csr_tensor(x.indptr.long(), x.indices.long(),
                                      x.values, size=(n, d))
        logits = torch.sparse.mm(csr, w2)
    logits = logits + bias
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(n * r, b), labels.reshape(-1).long(), reduction="sum")
    return torch.autograd.grad(loss / n, leaves)


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _nvidia_smi()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(_build.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    checked = phase_kernels_vs_plain(dev)
    print(f"kernels vs plain: {checked} comparisons ok in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rows = phase_main_path(dev)

    t0 = time.perf_counter()
    checks = phase_xent_vs_plain(dev)
    print(f"fused xent vs plain: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rows += phase_training(dev, checks)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
