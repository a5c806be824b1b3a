#!/usr/bin/env python3
"""Drive the PyTorch port of MACH serving (Algorithm 2, streaming and
count-min candidate decode), training (Algorithm 1, through the fused
logit-free loss), language-model serving (recurrentgemma-2b with the
MACH head, through the slot engine) and language-model training (the
same model through the trainer) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure exits non-zero and prints no result:

1. Device: requires CUDA, prints the card's name and power limit as
   ``nvidia-smi`` gives them, turns TF32 off.
2. Build: compiles every kernel from ``src/repro_torch/kernels/csrc``.
3. Kernels vs plain on the card: first kernel 1 (top-1) at ODP's shape
   for N in {256, 64, 37, 33, 31, 1}, so that both of its mappings (query
   per lane from N = 32, class per thread below) and the threshold
   between them run, and on rows whose maximum two classes in different
   K-splits share (the lowest id must win); then the top-1 and streaming
   top-k kernels against their plain PyTorch versions — table and inline
   hashing, the
   three estimators, k in {1, 10, 100}, the ODP shape (R=25, B=32), the
   ImageNet-21k shape (R=20, B=512, even-R median) and a tiny-B, tiny-R
   shape where classes collide in bulk, with ragged N and K.  Dyadic
   inputs (multiples of 2^-10) must agree exactly, values and indices;
   random inputs to rtol 1e-6, indices equal except on near-ties.
3b. Candidate kernels vs plain on the card: bucket top-m (kernel 7)
   exactly (tau bit for bit, ids), at B in {4, 32, 37, 512, 1,000, 2,048,
   8,192} with m in {1, 2, 3, 12, 16, 32, 33, B-1, B} up to B, on dyadic,
   random, all-equal and signed-zero rows, every path of its wrapper
   counted as launched; the candidate filter (kernel 8) at
   N <= 5, both hash sources, the three estimators, (m, t) in {(1, 1),
   (2, 2), (B, R)} and a flat-random (1, R) that exercises the backfill
   slot, k in {1, 10, 100}: values, bands and ids equal, dyadic and
   random.  Shapes: ODP (R=25, B=32), ImageNet-21k (R=20, B=512), the
   JAX gate (R=16, B=8192, K=1,048,576) and a tiny collide one (R=B=4).
4. Main path at full ODP width: ``MACHLinear`` (K=105,033, d=422,713,
   B=32, R=25) with seeded random weights answers a 256-query CSR batch
   (nnz=120) through ``predict`` and ``estimators.predict_topk(k=10)``
   for each estimator, and ``ops.mach_top1``.  Launch counters are set
   to 0 just before and read just after; both kernels must have run.
   Then ms per answer, kernel ms, plain ms, the library yardstick — the
   float32 GEMM against the (R·B, K) multi-hot matrix, then ``torch.max``
   or ``torch.topk`` (the times over materialized sums kept apart, as a
   labelled extra) — and peak memory; kernel 1 also with the table hash,
   its layout and ptxas's registers and spills.
4b. Candidate main path at full width: ODP (phase 4's model and batch)
   and ImageNet-21k (K=21,841, d=6,144, B=512, R=20, dense features,
   N=256) through ``estimators.predict_topk(candidate_mode=(m, t))`` for
   each estimator, exact (B, R) and approximate ((2|4, 1) unbiased,
   (2|4, 2) min and median), and ``predict(candidate_mode=(B, R))``.
   Launch counters from 0; both candidate kernels must have run.  Exact
   mode must equal the streaming kernel's answer bit for bit, predict
   equal ``mach_top1`` up to near-ties, the approximate answers the
   plain path's on 16 queries; recall@10 is printed.  Then answer,
   kernel, plain, ``torch.topk`` and streaming-kernel times, bounds,
   peak memory, and the JAX gate shape (N=8, m=12, planted-signal
   batch): candidate kernels vs the plain streaming top-k, recall@10.
   Kernel 7 is timed in each setting beside ``torch.topk``, and at the LM
   engine's (2048, 8) and (16, 2) and the gate's shape.
5. Fused-xent kernels vs plain on the card, forward and backward: the
   dense, ELL and gather families against their plain PyTorch versions
   (loss, lse, dW, dbias, dh) at the ODP shape (R=25, B=32), the
   ImageNet-21k shape (R=20, B=512) and an odd one (B=37, R·B=259,
   ragged N), with and without bias; CSR batches with duplicate ids, a
   row at exactly nnz_max, short and empty rows, at nnz 120 and 1,024
   through both sparse families.  Loss and lse to rtol 1e-5, gradients
   to rtol 1e-4 / atol 1e-6 (sums in another order; the dense and ELL
   kernels reduce across blocks with float atomics); each backward runs
   twice and the largest difference is printed, and the gather family's,
   which uses no float atomics, must be 0.  The
   dense kernel (3xTF32 on the tensor cores in float32) also runs each
   dense shape with bf16 operands, and the LM head's shape (N=8,192,
   d=2,560, R=8, B=2,048) in bf16 with and without bias, dh asked: loss
   and lse to rtol 1e-5, each bf16 gradient's largest error within 2^-7
   of its largest entry and its relative L2 error within 2^-8.  And at
   the float32 card test's N(0, 1) features (32 cases a shape), the dense
   kernel and cuBLAS's float32 plain version each against the plain
   version in float64 at the same tolerances: the kernel may have no
   violation; both sides' counts and largest errors are printed.
6. Training main path at full width: ``MACHLinear(fused=True)`` with
   AdamW (lr 0.05) — ODP (K=105,033, d=422,713, B=32, R=25, CSR nnz=120,
   N=512) 5 steps through the ELL kernels; the same model 2 steps on
   nnz=1,024 batches through the gather kernels; ImageNet-21k (K=21,841,
   d=6,144, B=512, R=20, dense, N=512) 3 steps through the dense
   kernels.  Launch counters are set to 0 just before and read just
   after; all six launch functions must have run, every loss must be
   finite, and each first step's loss and gradients must equal the plain
   version's.  Then ms per step, stage times (the fused-xent kernels by
   CUDA events and by CUDA-graph replay), peak memory.  Then kernel 4
   at the LM head's shape in bf16 (the fused LM loss's call, not yet on
   a path): forward and backward-with-dh ms, plain and library (bf16
   torch.matmul + F.cross_entropy) ms, peak memory of each, bound,
   ptxas registers and shared memory.
7. LM kernels vs plain on the card: the RG-LRU scan (kernel 9) equal to
   its plain sequential loop bit for bit, float32 at (1, 4096, 2560),
   (4, 1, 2560), a ragged (3, 37, 300) with nonzero h0 (and bfloat16
   there) and a ragged (2, 4097, 2570) (T and D past whole stages and
   channel tiles); flash attention (kernel 10) at (1, 4096, 10,
   256) / (1, 4096, 1, 256) bfloat16 with window 2048 and without, a
   GQA case (KV=2, H=8, hd=128, ragged T), tinyllama's width (hd 64,
   32 / 4 heads), phi3's (hd 96, padded to 128 in the kernel, 32 / 32
   heads), a ragged windowed hd-256 case and a float32 one: float32 to
   rtol 1e-5 / atol 1e-6, bfloat16 within 2 bf16 ulps of each (query,
   head) row's largest output.  Then the MACH decode kernels (1 and 2)
   at the LM head's shape (R=8, B=2048, K=256,000, inline multiply-shift
   hash; N=1 as after a prefill, N=4 as in the pooled decode, where a
   block holds 3 queries and the last block 1): top-1 and top-k (k 1 and
   50, the three estimators) against their plain versions, dyadic inputs
   exactly, random ones as in phase 3; kernel 1's time there beside its
   plain version and a sparse multi-hot product + ``torch.max``.
8. LM serving at full width: recurrentgemma-2b (26 layers, bf16, MACH
   head B=2048, R=8 over V=256,000) with seeded random weights on the
   card, served by ``ServingEngine`` (4 slots, max_len 4,160, top_k 50,
   16 new tokens): a 4,096-token prompt (the flash branch, the ring-cache
   roll, kernel 9 at T=4,096) and prompts of 5, 77 and 300 tokens, the
   77-token one sampled at temperature 0.8.  Launch counters from 0:
   kernel 10 in the long prefill, kernel 9 in every prefill and decode
   step, kernel 2 in every serve step (the engine's greedy rows take the
   top-1 of its fused top-k, so the engine launches kernel 1 no time);
   then a direct greedy prefill + decode_step + next_token loop (kernel
   1), whose tokens the greedy requests must equal.  The two runs' counts
   are reported apart.  Then the path's own outputs: kernels 1 and 2 vs
   plain on the four prompts' last hidden states (k=50, the sampled
   rows' candidates); the 4,096-token prefill against the same model on
   the dense branch (flash_threshold raised), with a decode step on the
   rolled ring caches against a dense prefill of the 4,097 tokens: the
   first attention layer's K/V and every cache's positions and index
   exactly; the last hidden states and every cache held to the model in
   float32 on the dense branch, with at most twice the bf16 dense
   branch's relative L2 error there, plus 2^-9.  Then the same requests
   through ``ServeConfig(candidate_mode=(2048, 8))`` (exact: tokens must
   equal the streaming engine's bit for bit) and ``(16, 2)``
   (approximate: greedy tokens reported), kernels 7-8 launch counts from
   0 for each.  Then prefill ms, ms per pooled decode step, tokens/s,
   peak memory, and kernel, plain, bound and library times (kernel 9's
   prefill and decode calls also by CUDA-graph replay).
9. LM training kernels vs plain on the card: kernel 3 (the R-head CE
   on given logits), forward and backward, at ragged shapes (float32 and
   bfloat16, labels at 0 and B-1) and the training path's shape (8,192,
   8, 2048) in bf16 — loss to rtol 1e-5, gradient to rtol 1e-5 in
   float32 and within one bf16 ulp in bf16; kernel 9's backward bit for
   bit against its plain reverse loop at (2, 4096, 2560), (4, 1, 2560),
   (1, 1, 16), a ragged (3, 37, 300) in float32 and bf16 and a ragged
   (2, 4097, 2570) in float32, nonzero h0;
   kernel 10's backward at the training shape ((2, 4096, 10, 256) / KV=1,
   bf16, window 2048) and at small float32 shapes (causal, windowed,
   unmasked; G = 1, 2, 10) and bf16 ones: a ragged GQA case, tinyllama's
   and phi3's widths and head counts, a ragged windowed hd-256 case and
   an unmasked hd 48: dq, dk, dv to rtol 1e-4 / atol 1e-5 in float32,
   within 2 bf16 ulps of each row's largest entry (past a 2^-20 float32
   floor) in bf16; the forward with lse equal to the forward without it,
   bit for bit.
10. LM training at full width: recurrentgemma-2b (26 layers, bf16 params,
   remat="full") with seeded random weights, trained through
   ``Trainer.step_fn`` (``make_train_step``) with launch/train.py's
   ``TrainConfig`` (AdamW, warmup 2, peak 3e-4, clip 1.0) for 6 steps on
   ``SyntheticLMStream`` batches of 2 x 4,096 tokens (global batch cut
   from the train_4k shape's 256 to one chip's memory).  First the first
   step's gradients, per group (embedding, RG-LRU blocks, attention
   blocks, MLPs, norms, head), against the same model in float32 on the
   dense branch: each group's relative L2 error at most twice the bf16
   dense branch's, plus 2^-9.  Launch counters from 0 over the 6 steps:
   kernels 3, 9 and 10 forward and backward, each at its count a step
   (remat runs 9 and 10 forward twice).  Every loss finite; batch 0's
   loss after the 6 steps below its loss at step 0.  Then ms per step,
   tokens/s, peak memory, the split into forward + backward and clip +
   AdamW + apply, and kernel, plain, bound and library times at the
   path's shapes (``F.cross_entropy`` and SDPA's backward as yardsticks;
   kernel 9 forward and backward also by CUDA-graph replay).
11. The kernel report (one JSON line), then the device line, last.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM float32, outside the tensor cores
TF32_OPS_PER_S = 494.7e12        # H100 SXM TF32 tensor cores, dense
BF16_TOPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
ESTIMATORS = ("unbiased", "min", "median")
N_MAIN, K_MAIN = 256, 10
# kernel-vs-plain shapes: (label, N, R, B, K) — ragged N and K tails
CHECK_SHAPES = [("odp", 37, 25, 32, 105033), ("imagenet21k", 37, 20, 512, 21841),
                ("collide", 5, 4, 2, 5003)]
# candidate-kernel checks: (label, N, R, B, K) — kernel 8 at small N,
# kernel 7 at N=37; the gate shape's R·B is beyond the streaming kernel
CAND_SHAPES = [("odp", 5, 25, 32, 105033), ("imagenet21k", 5, 20, 512, 21841),
               ("gate", 3, 16, 8192, 1048576), ("collide", 5, 4, 4, 5003)]
# kernel 1's two mappings at ODP's shape: N >= 32 query per lane (33 and 37
# one ragged 64-query tile, 64 and 256 full ones), 31 and 1 class per thread
TOP1_N = (256, 64, 37, 33, 31, 1)
# kernel 7 checks on 37 queries x 3 repetitions: each B with each m of
# TOPM_M up to B, and B - 1 and B, so every path of ``topm_layout`` runs
# (select: m <= 32 above B = 1,024, and below where next_pow2(m) <=
# next_pow2(B) / 32 >= 2; warp: B <= 1,024 otherwise; block: the rest)
TOPM_B = (4, 32, 37, 512, 1000, 2048, 8192)
TOPM_M = (1, 2, 3, 12, 16, 32, 33)
TOPM_ROWS = ("dyadic", "random", "all-equal", "signed zeros")
# kernel 7 timed beside torch.topk at the LM engine's settings (its 4-slot
# pool) and the JAX gate's: (label, N, R, B, m)
TOPM_TIMED = [("lm exact (2048, 8)", 4, 8, 2048, 2048),
              ("lm approx (16, 2)", 4, 8, 2048, 16),
              ("gate", 8, 16, 8192, 12)]
# the JAX benchmark's decode gate: K, R, B, N, k, m; t per estimator
GATE = {"K": 1048576, "R": 16, "B": 8192, "N": 8, "k": 10, "m": 12}
GATE_T = {"unbiased": 1, "min": 2, "median": 2}


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


def graph_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``iters`` back-to-back calls replayed from
    a CUDA graph (CUDA events around one replay): the host's dispatch
    through a Python wrapper then hides no kernel that is shorter than
    it, as it does under ``kernel_ms``."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


# how rows 1 and 7 of the kernel report are timed
TIMING = ("ms, plain_ms and library_ms by kernel_ms (CUDA events around "
          "back-to-back calls, as every row); *_graph by graph_ms (device "
          "time, CUDA-graph replay)")


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


def _top1_mappings(dev) -> dict:
    """Kernel 1 vs plain at ODP's shape (R=25, B=32, K=105,033) for each
    N of TOP1_N, both hash sources, dyadic inputs exactly and random ones
    as ``_check_same`` holds them; then rows whose maximum two classes in
    different K-splits share (256 rows in four 64-query tiles, and 31 rows
    class per thread): the lowest id must win.  Returns the comparisons
    made in each mapping."""
    from repro_torch.core.hashing import MultShiftFamily
    from repro_torch.kernels import mach_decode as md

    r, b, num_classes = 25, 32, 105033
    fam = MultShiftFamily(b, r, seed=1)
    table = fam.table(num_classes, dev)
    hashes = {"table": {"table": table},
              "inline": {"inline_coeffs": fam.coeffs_tensor(dev),
                         "inline_shift": fam.shift}}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_mapping = dict.fromkeys(md.MAPPINGS, 0)

    def check(tag, meta, exact):
        n = meta.shape[0]
        mapping = md.decode_layout(n, r, b, num_classes, sms).mapping
        sums = md.summed_scores(meta, table)
        for mode, hash_kw in hashes.items():
            before = md.mach_decode_cuda.launches
            kv, ki = md.mach_decode_cuda(meta, num_classes=num_classes,
                                         **hash_kw)
            pv, pi = md.mach_decode_plain(meta, num_classes=num_classes,
                                          **hash_kw)
            torch.cuda.synchronize()
            if md.mach_decode_cuda.launches != before + 1:
                fail("mach_decode_cuda did not count its launch")
            _check_same(f"top1 odp n={n} {tag} {mode} ({mapping})", kv, ki,
                        pv, pi, sums, exact)
            by_mapping[mapping] += 1
        return pi

    for n in TOP1_N:
        for dyadic in (True, False):
            check("dyadic" if dyadic else "random",
                  _inputs(n, r, b, dyadic, seed=n, dev=dev), dyadic)
    reps = torch.arange(r, device=dev)[None, :]
    for n in (256, 31):
        q = torch.arange(n, device=dev)
        low = 1000 + 211 * q                     # early K-splits
        high = num_classes - 1 - 97 * q          # the last ones
        meta = torch.zeros((n, r, b), device=dev)
        for k in (low, high):
            meta[q[:, None], reps, table[:, k].T.long()] = 0.5
        if not torch.equal(check("tied across K-splits", meta, True).long(),
                           low):
            fail(f"top1 n={n}: the tie does not go to the lowest class id")
    for mapping, count in by_mapping.items():
        if count < 1:
            fail(f"top1 mapping {mapping} never ran")
    print(f"top1 mappings vs plain at odp, N in {TOP1_N} and two tie "
          f"batches: {by_mapping} comparisons ok", flush=True)
    return by_mapping


def phase_kernels_vs_plain(dev) -> tuple[int, dict]:
    from repro_torch.core.hashing import MultShiftFamily
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt

    by_mapping = _top1_mappings(dev)
    checked = sum(by_mapping.values())
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
    return checked, by_mapping


# ---------------------------------------------------------------------------
# phase 3b: the candidate kernels (7 and 8) vs their plain versions
# ---------------------------------------------------------------------------

def _check_candidates(name, got, want) -> float:
    """Kernel 8's (value, band, id) top-k vs the plain version's, at
    the same k: bands equal (so dead and backfill slots sit in the same
    positions), values and ids equal (the kernel repeats the plain
    arithmetic, so this holds on random inputs too), no duplicate id.
    Returns the max abs error of the live values."""
    (kv, kb, ki), (pv, pb, pi) = got, want
    if not torch.equal(kb, pb):
        fail(f"{name}: bands differ (dead/backfill slots out of place)")
    live = kb > 0
    if not torch.isfinite(kv[live]).all():
        fail(f"{name}: non-finite kernel values")
    err = float((kv[live] - pv[live]).abs().max()) if live.any() else 0.0
    if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
        bad = (ki != pi).any(-1).nonzero()[:3].flatten().tolist()
        fail(f"{name}: kernel != plain (rows {bad}, max err {err})")
    for row, ok in zip(ki.tolist(), live.tolist()):
        ids = [i for i, o in zip(row, ok) if o]
        if len(set(ids)) != len(ids):
            fail(f"{name}: duplicate class ids in a row")
    return err


def _topm_inputs(kind, n, r, b, dev):
    """Kernel 7's rows: dyadic (ties in bulk), random softmax, all equal,
    or signed zeros — dyadic values >= 0.75 among -0.0 and +0.0, which
    the plain version's sort counts equal and orders by id."""
    if kind in ("dyadic", "random"):
        return _inputs(n, r, b, kind == "dyadic", seed=b, dev=dev)
    if kind == "all-equal":
        return torch.full((n, r, b), 0.25, device=dev)
    x = _inputs(n, r, b, True, seed=b + 1, dev=dev)
    gen = torch.Generator(device=dev).manual_seed(b)
    neg = torch.rand((n, r, b), generator=gen, device=dev) < 0.5
    zero = torch.where(neg, torch.full_like(x, -0.0), torch.zeros_like(x))
    return torch.where(x >= 0.75, x, zero)


def _topm_sweep(dev) -> dict:
    """Kernel 7 vs its plain version (on a host copy of the same rows),
    exactly — tau bit for bit, ids — at every (B, m) of TOPM_B / TOPM_M
    and each kind of TOPM_ROWS; each launch counted, and every path of
    ``topm_layout`` must run.  Returns the comparisons by path, their
    count and the largest tau error."""
    from repro_torch.kernels import mach_candidates as mc

    n, r = 37, 3
    by_path = dict.fromkeys(mc.TOPM_PATHS, 0)
    err = 0.0
    for b in TOPM_B:
        for kind in TOPM_ROWS:
            meta = _topm_inputs(kind, n, r, b, dev)
            host = meta.cpu()
            for m in sorted({m for m in TOPM_M if m <= b} | {max(1, b - 1), b}):
                path = mc.topm_layout(b, m).path
                before = mc.bucket_topm_cuda.launches
                kt, ki = mc.bucket_topm_cuda(meta, m)
                torch.cuda.synchronize()
                if mc.bucket_topm_cuda.launches != before + 1:
                    fail("bucket_topm_cuda did not count its launch")
                pt, pi = mc.bucket_topm(host, m)
                kt, ki = kt.cpu(), ki.cpu()
                if not (torch.equal(kt.view(torch.int32), pt.view(torch.int32))
                        and torch.equal(ki, pi)):
                    bad = (ki != pi).any(-1).flatten().nonzero()[:3].tolist()
                    fail(f"bucket_topm B={b} m={m} {kind} ({path}): kernel != "
                         f"plain (rows {bad})")
                err = max(err, float((kt - pt).abs().max()))
                by_path[path] += 1
    for path, count in by_path.items():
        if count < 1:
            fail(f"bucket_topm path {path} never ran")
    print(f"bucket_topm vs plain: {by_path} comparisons ok (B in {TOPM_B}, "
          f"rows {TOPM_ROWS})", flush=True)
    return {"bucket_topm": sum(by_path.values()), "topm_by_path": by_path,
            "topm_max_abs_err": err}


def phase_candidates_vs_plain(dev) -> dict:
    from repro_torch.core.hashing import MultShiftFamily, inverted_table
    from repro_torch.kernels import mach_candidates as mc

    stats = {"mach_candidate_topk": 0, "max_abs_err": 0.0, "backfill_rows": 0}
    stats.update(_topm_sweep(dev))
    for label, n, r, b, num_classes in CAND_SHAPES:
        fam = MultShiftFamily(b, r, seed=1)
        table = fam.table(num_classes, dev)
        inv = inverted_table(table, b, device=dev)
        hashes = {"table": {"table": table},
                  "inline": {"inline_coeffs": fam.coeffs_tensor(dev),
                             "inline_shift": fam.shift}}
        for dyadic in (True, False):
            kind = "dyadic" if dyadic else "random"
            meta = _inputs(n, r, b, dyadic, seed=r * b + 1, dev=dev)
            settings = [(1, 1), (2, 2), (b, r)] + ([] if dyadic else [(1, r)])
            for m, t in settings:
                tau, ids = mc.bucket_topm(meta, m)
                for mode, hash_kw in hashes.items():
                    for est in ESTIMATORS:
                        want = mc.mach_candidate_topk_plain(
                            meta, tau, ids, inv, num_classes=num_classes, k=100,
                            t=t, estimator=est, **hash_kw)
                        if (m, t) == (1, r):
                            stats["backfill_rows"] += int((want[1][:, 0] == 1).sum())
                        for k in (1, 10, 100):
                            got = mc.mach_candidate_topk_cuda(
                                meta, tau, ids, inv, num_classes=num_classes,
                                k=k, t=t, estimator=est, **hash_kw)
                            torch.cuda.synchronize()
                            err = _check_candidates(
                                f"candidates {label} {kind} {mode} {est} m={m} "
                                f"t={t} k={k}", got, [x[:, :k] for x in want])
                            stats["max_abs_err"] = max(stats["max_abs_err"], err)
                            stats["mach_candidate_topk"] += 1
        print(f"candidate kernels vs plain: {label} (N={n}, R={r}, B={b}, "
              f"K={num_classes}, L={inv.shape[1]}) ok", flush=True)
    if stats["backfill_rows"] < 1:
        fail("no flat-random row exercised the backfill slot")
    return stats


# ---------------------------------------------------------------------------
# phase 4: the main path at full ODP width
# ---------------------------------------------------------------------------

def phase_main_path(dev) -> list[dict]:
    from repro_torch.configs.odp_mach import ODP
    from repro_torch.core import estimators as est
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import SparseExtremeDataset
    from repro_torch.kernels import _build
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

    # kernel, plain and library times on the main path's inputs.  The
    # library yardstick computes the whole function: a float32 GEMM
    # against the (R·B, K) multi-hot matrix (a model constant, built
    # outside the timed call; TF32 off), then torch.max / torch.topk.
    smi = _nvidia_smi()
    rows = []
    decode_kw = {"num_classes": K, "inline_coeffs": coeffs, "inline_shift": shift}
    multihot = torch.nn.functional.one_hot(table.long(), B).permute(0, 2, 1) \
        .reshape(R * B, K).float()
    meta2d = meta.reshape(N_MAIN, R * B)
    t_bound, by = bound_ms(N_MAIN, R, B, K, 1, table=False)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows.append({
        "name": "mach_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mach_decode.cu",
        "replaces": "src/repro/kernels/mach_decode.py:202",
        "launches": launches["mach_decode"],
        "max_abs_err": errs["mach_decode"],
        "ms": kernel_ms(lambda: md.mach_decode_cuda(meta, **decode_kw)),
        "ms_graph": graph_ms(lambda: md.mach_decode_cuda(meta, **decode_kw)),
        "plain_ms": kernel_ms(lambda: md.mach_decode_plain(meta, **decode_kw),
                              iters=5),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": kernel_ms(lambda: torch.max(meta2d @ multihot, dim=-1)),
        "library_ms_graph": graph_ms(
            lambda: torch.max(meta2d @ multihot, dim=-1)),
        "library": "torch.max over meta2d @ multihot (f32 GEMM, TF32 off)",
        "library_ms_materialized": kernel_ms(lambda: torch.max(sums, dim=-1)),
        "shape": f"N={N_MAIN} R={R} B={B} K={K} inline hash",
        "timing": TIMING,
        "ms_table": kernel_ms(lambda: md.mach_decode_cuda(meta, table,
                                                          num_classes=K)),
        "ms_table_graph": graph_ms(lambda: md.mach_decode_cuda(
            meta, table, num_classes=K)),
        "layout": md.decode_layout(N_MAIN, R, B, K, sms)._asdict(),
        "ptxas": _ptxas_registers(_build.build_log("mach_decode")),
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
        "library_ms": kernel_ms(lambda: torch.topk(meta2d @ multihot, K_MAIN,
                                                   dim=-1)),
        "library": "torch.topk over meta2d @ multihot (f32 GEMM, TF32 off)",
        "library_ms_materialized": kernel_ms(
            lambda: torch.topk(sums, K_MAIN, dim=-1)),
        "shape": f"N={N_MAIN} R={R} B={B} K={K} k={K_MAIN} table hash, unbiased",
        "ms_by_estimator": ms_est, "plain_ms_by_estimator": plain_est,
        "ms_unbiased_inline": ms_inline, "ms_unbiased_k100": ms_k100,
    })
    gemm_ms = kernel_ms(lambda: meta2d @ multihot)
    del multihot
    print(f"kernel mach_decode: graph {rows[0]['ms_graph']:.4f} ms (library "
          f"{rows[0]['library_ms_graph']:.4f}), table hash "
          f"{rows[0]['ms_table']:.4f} ms (graph "
          f"{rows[0]['ms_table_graph']:.4f}); "
          f"layout {rows[0]['layout']}; ptxas {rows[0]['ptxas']} [{smi}]",
          flush=True)
    for row in rows:
        print(f"kernel {row['name']}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms "
              f"({row['library']}; over materialized sums alone "
              f"{row['library_ms_materialized']:.4f} ms), bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), launches "
              f"{row['launches']} [{smi}]", flush=True)
    print(f"kernel mach_topk by estimator (k={K_MAIN}, table): "
          + ", ".join(f"{e} {ms_est[e]:.4f} ms (plain {plain_est[e]:.4f})"
                      for e in ESTIMATORS)
          + f"; unbiased inline {ms_inline:.4f} ms; unbiased k=100 "
            f"{ms_k100:.4f} ms [{smi}]", flush=True)
    print(f"yardstick: the multi-hot f32 GEMM alone {gemm_ms:.4f} ms [{smi}]",
          flush=True)
    return rows, {"head": head, "params": params, "batch": batch,
                  "table": table}


# ---------------------------------------------------------------------------
# phase 4b: the candidate decode main path at full ODP and ImageNet-21k
# width, and the JAX package's gate shape
# ---------------------------------------------------------------------------

def _candidate_bounds(meta, ids, inv, table, n, r, b, k, num_classes,
                      gathers):
    """Least time (ms) for kernel 8 and for kernel 7 on this card, and
    what bounds each.  Kernel 8: the ``gathers`` probability values its
    early stop leaves on these inputs (``pool_gathers``), one f32
    operation each, vs the bytes of the probabilities, tau and ids, the
    distinct inverted rows this batch touches (and, in table mode, the
    table entries of the classes in them), counted once, and the
    outputs.  Kernel 7: N·R·B comparisons vs the probabilities read and
    tau and ids written."""
    from repro_torch.kernels.mach_candidates import candidate_chunks
    m, ell = ids.shape[-1], inv.shape[1]
    rows = torch.unique(candidate_chunks(ids, b))
    nbytes = 4 * n * r * b + 4 * n * r * (1 + m) + 4 * rows.numel() * ell \
        + 12 * n * k
    if table is not None:
        cls = torch.unique(inv[rows.long()])
        nbytes += 4 * r * int((cls < num_classes).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = gathers / F32_OPS_PER_S * 1e3
    k8 = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return k8, _topm_bound(n, r, b, m)


def _topm_bound(n, r, b, m) -> tuple[float, str]:
    """Least time (ms) for kernel 7: N·R·B comparisons vs the
    probabilities read and tau and ids written."""
    t_bytes = (4 * n * r * b + 4 * n * r * (1 + m)) / HBM_BYTES_PER_S * 1e3
    t_ops = n * r * b / F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _topm_timed(dev) -> dict:
    """Kernel 7 beside its plain version and ``torch.topk`` at the
    TOPM_TIMED shapes, on random softmax rows."""
    from repro_torch.kernels import mach_candidates as mc

    smi = _nvidia_smi()
    out = {}
    for label, n, r, b, m in TOPM_TIMED:
        meta = _inputs(n, r, b, False, seed=b + m, dev=dev)
        row = {"shape": f"N={n} R={r} B={b} m={m}",
               "path": mc.topm_layout(b, m).path,
               "ms": kernel_ms(lambda: mc.bucket_topm_cuda(meta, m)),
               "ms_graph": graph_ms(lambda: mc.bucket_topm_cuda(meta, m)),
               "plain_ms": kernel_ms(lambda: mc.bucket_topm(meta, m)),
               "library_ms": kernel_ms(lambda: torch.topk(meta, m, dim=-1)),
               "library_ms_graph": graph_ms(
                   lambda: torch.topk(meta, m, dim=-1))}
        row["bound_ms"], row["bound_by"] = _topm_bound(n, r, b, m)
        out[label] = row
        print(f"kernel bucket_topm {label} ({row['shape']}, {row['path']}): "
              f"{row['ms']:.4f} ms (graph {row['ms_graph']:.4f}), plain "
              f"{row['plain_ms']:.4f}, torch.topk "
              f"{row['library_ms']:.4f} (graph "
              f"{row['library_ms_graph']:.4f}), bound {row['bound_ms']:.5f} "
              f"({row['bound_by']}) [{smi}]", flush=True)
    return out


def _planted_probs(dev, n, r, b, coeffs, shift, num_classes, seed,
                   n_plant=20, lo=5.0, hi=9.0):
    """A trained-head-like batch, after the JAX benchmark's generator:
    per row, ``n_plant`` random classes get a logit boost U(lo, hi) in
    every repetition's bucket of them, over N(0, 1) noise logits."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    classes = torch.randint(0, num_classes, (n, n_plant), generator=gen,
                            device=dev)
    w = lo + (hi - lo) * torch.rand((n, n_plant), generator=gen, device=dev)
    hc = ((coeffs[None, :, None] * classes[:, None, :]) & 0xFFFFFFFF) >> shift
    noise = torch.randn((n, r, b), generator=gen, device=dev)
    boost = torch.zeros((n, r, b), device=dev).scatter_add_(
        2, hc, w[:, None, :].expand(n, r, n_plant).contiguous())
    return torch.softmax(noise + boost, -1)


def _recall(got, want) -> float:
    k = want.shape[1]
    return sum(len(set(a) & set(c)) for a, c in
               zip(got.tolist(), want.tolist())) / (k * want.shape[0])


def _check_decoded(name, kv, ki, pv, pi) -> float:
    """Decoded candidate answers vs the plain path's: (-inf, -1) slots
    in the same positions, values and ids equal."""
    dead = ki < 0
    if not torch.equal(dead, pi < 0) or not (kv[dead] == -torch.inf).all():
        fail(f"{name}: filtered slots out of place")
    if not torch.isfinite(kv[~dead]).all():
        fail(f"{name}: non-finite values")
    err = float((kv[~dead] - pv[~dead]).abs().max()) if (~dead).any() else 0.0
    if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
        fail(f"{name}: answer != plain path's (max err {err})")
    return err


def _imagenet_serving(dev):
    from repro_torch.configs.odp_mach import IMAGENET
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import ExtremeDataConfig, ExtremeDataset
    head = MACHLinear(IMAGENET.mach(), IMAGENET.dim)
    params = head.init(torch.Generator(device=dev).manual_seed(1), device=dev)
    data = ExtremeDataset(ExtremeDataConfig(IMAGENET.num_classes, IMAGENET.dim),
                          device=dev)
    x, _ = data.batch_at(0, N_MAIN)
    return {"head": head, "params": params, "batch": x,
            "table": head.table(dev)}


def phase_candidate_main_path(dev, odp: dict, checks: dict) -> list[dict]:
    from repro_torch.core import estimators as est
    from repro_torch.kernels import _build
    from repro_torch.kernels import mach_candidates as mc
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    models = {"odp": odp, "imagenet21k": _imagenet_serving(dev)}
    for ctx in models.values():
        cfg = ctx["head"].cfg
        ctx["K"], ctx["R"], ctx["B"] = (cfg.num_classes, cfg.num_repetitions,
                                        cfg.num_buckets)
        ctx["inv"] = ctx["head"].inverted_table(dev)
        ctx["meta"] = ctx["head"].meta_probs(ctx["params"], ctx["batch"])
        ctx["meta_nrb"] = ctx["meta"].movedim(0, -2).contiguous()
        ctx["exact"] = {e: (ctx["B"], ctx["R"]) for e in ESTIMATORS}
    approx_m = {"odp": 2, "imagenet21k": 4}
    for name, ctx in models.items():
        ctx["approx"] = {e: (approx_m[name], 1 if e == "unbiased" else 2)
                         for e in ESTIMATORS}
    torch.cuda.synchronize()
    print(f"candidate main path: set-up {time.perf_counter() - t0:.1f} s; "
          + "; ".join(f"{name} K={c['K']} B={c['B']} R={c['R']} L="
                      f"{c['inv'].shape[1]}" for name, c in models.items()),
          flush=True)

    def answer(ctx, e, setting):
        return est.predict_topk(ctx["meta"], ctx["table"], K_MAIN, e,
                                candidate_mode=ctx[setting][e],
                                inverted=ctx["inv"])

    # the main path's run: counts from 0, read just after
    mc.bucket_topm_cuda.launches = 0
    mc.mach_candidate_topk_cuda.launches = 0
    out, peak_gib = {}, {}
    for name, ctx in models.items():
        torch.cuda.reset_peak_memory_stats(dev)
        for e in ESTIMATORS:
            for setting in ("exact", "approx"):
                out[name, e, setting] = answer(ctx, e, setting)
        out[name, "predict"] = ctx["head"].predict(
            ctx["params"], ctx["batch"], candidate_mode=(ctx["B"], ctx["R"]))
        torch.cuda.synchronize()
        peak_gib[name] = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {"bucket_topm": mc.bucket_topm_cuda.launches,
                "mach_candidate_topk": mc.mach_candidate_topk_cuda.launches}
    smi = _nvidia_smi()
    print(f"candidate main path launches: {launches}, peak memory "
          + ", ".join(f"{name} {v:.2f} GiB" for name, v in peak_gib.items())
          + f" [{smi}]", flush=True)
    for kname, count in launches.items():
        if count < 1:
            fail(f"kernel {kname} never launched on the candidate main path")

    # right answers: exact mode == streaming bit for bit; predict ==
    # mach_top1 up to near-ties; approximate == the plain path
    err = checks["max_abs_err"]
    recall = {}
    for name, ctx in models.items():
        K = ctx["K"]
        sums = md.summed_scores(ctx["meta_nrb"], ctx["table"])
        for e in ESTIMATORS:
            cv, ci = out[name, e, "exact"]
            sv, si = est.predict_topk(ctx["meta"], ctx["table"], K_MAIN, e)
            if tuple(ci.shape) != (N_MAIN, K_MAIN) or not torch.isfinite(cv).all():
                fail(f"{name} exact {e}: wrong shape or non-finite values")
            if not (torch.equal(cv, sv) and torch.equal(ci, si)):
                fail(f"{name} {e}: exact-mode candidates != streaming kernel")
            av, ai = out[name, e, "approx"]
            m, t = ctx["approx"][e]
            sub = ctx["meta_nrb"][:16]
            tau, ids = mc.bucket_topm(sub, m)
            pv, pi = mc.finish_candidates(
                *mc.mach_candidate_topk_plain(
                    sub, tau, ids, ctx["inv"], ctx["table"], num_classes=K,
                    k=K_MAIN, t=t, estimator=e),
                ctx["R"], ctx["B"], e)
            err = max(err, _check_decoded(f"{name} approx {e} (m={m}, t={t})",
                                          av[:16], ai[:16], pv, pi))
            recall[name, e] = _recall(ai, si)
        _, top1 = ops.mach_top1(ctx["meta_nrb"], ctx["table"], num_classes=K)
        pred = out[name, "predict"].long()
        a = torch.gather(sums, 1, top1.long()[:, None])
        c = torch.gather(sums, 1, pred[:, None])
        if not torch.allclose(a, c, rtol=1e-6, atol=0):
            fail(f"{name}: candidate predict disagrees with mach_top1 beyond "
                 f"near-ties")
        n_same = int((top1.long() == pred).sum())
        print(f"candidate answers ok ({name}): exact mode == streaming kernel "
              f"bit for bit for {', '.join(ESTIMATORS)}; predict(candidate_mode="
              f"({ctx['B']}, {ctx['R']})) == mach_top1 on {n_same}/{N_MAIN}, the "
              f"rest near-ties; approximate == plain on 16 queries; recall@"
              f"{K_MAIN} vs streaming (information, random weights): "
              + ", ".join(f"{e} (m, t)={ctx['approx'][e]} "
                          f"{recall[name, e]:.3f}" for e in ESTIMATORS),
              flush=True)

    timings = {}
    for name, ctx in models.items():
        for e in ESTIMATORS:
            stream_ms = wall_ms(lambda: est.predict_topk(
                ctx["meta"], ctx["table"], K_MAIN, e))
            for setting in ("exact", "approx"):
                timings[name, e, setting] = wall_ms(
                    lambda: answer(ctx, e, setting))
            print(f"answer {name} predict_topk[{e},k={K_MAIN}] from meta: "
                  f"streaming {stream_ms:.3f} ms/batch, candidates exact "
                  f"{ctx['exact'][e]} {timings[name, e, 'exact']:.3f}, approx "
                  f"{ctx['approx'][e]} {timings[name, e, 'approx']:.3f} [{smi}]",
                  flush=True)
        full = wall_ms(lambda: ctx["head"].predict(
            ctx["params"], ctx["batch"], candidate_mode=(ctx["B"], ctx["R"])))
        print(f"answer {name} predict(candidate_mode=({ctx['B']}, {ctx['R']})) "
              f"with the projection: {full:.3f} ms/batch [{smi}]", flush=True)

    # kernel, plain, library and streaming times on the main path's inputs
    by_setting, gathers = {}, {}
    for name, ctx in models.items():
        meta, inv, table = ctx["meta_nrb"], ctx["inv"], ctx["table"]
        K, R, B = ctx["K"], ctx["R"], ctx["B"]
        for setting in ("exact", "approx"):
            for e in ESTIMATORS:
                m, t = ctx[setting][e]
                tau, ids = mc.bucket_topm_cuda(meta, m)
                kw = {"num_classes": K, "k": K_MAIN, "t": t, "estimator": e}
                fam = ctx["head"].cfg.family
                row = {
                    "m": m, "t": t,
                    "ms": kernel_ms(lambda: mc.mach_candidate_topk_cuda(
                        meta, tau, ids, inv, table, **kw), iters=5, warmup=1),
                    # the same work with the hash recomputed in-register
                    # instead of read from the (R, K) table
                    "inline_ms": kernel_ms(lambda: mc.mach_candidate_topk_cuda(
                        meta, tau, ids, inv, **kw,
                        inline_coeffs=fam.coeffs_tensor(dev),
                        inline_shift=fam.shift), iters=5, warmup=1),
                    "plain_ms": kernel_ms(lambda: mc.mach_candidate_topk_plain(
                        meta, tau, ids, inv, table, **kw), iters=2, warmup=1),
                    "streaming_ms": kernel_ms(lambda: mt.mach_topk_cuda(
                        meta, table, num_classes=K, k=K_MAIN, estimator=e)),
                    "topm_ms": kernel_ms(lambda: mc.bucket_topm_cuda(meta, m)),
                    "topm_ms_graph": graph_ms(
                        lambda: mc.bucket_topm_cuda(meta, m)),
                    "topm_plain_ms": kernel_ms(lambda: mc.bucket_topm(meta, m)),
                    "topm_library_ms": kernel_ms(
                        lambda: torch.topk(meta, m, dim=-1)),
                    "topm_library_ms_graph": graph_ms(
                        lambda: torch.topk(meta, m, dim=-1)),
                    "topm_path": mc.topm_layout(B, m).path,
                }
                if (name, m) not in gathers:
                    gathers[name, m] = mc.pool_gathers(meta, tau, ids, inv,
                                                       table, num_classes=K)
                row["gathers"] = gathers[name, m]
                (row["bound_ms"], row["bound_by"]), \
                    (row["topm_bound_ms"], row["topm_bound_by"]) = \
                    _candidate_bounds(meta, ids, inv, table, N_MAIN, R, B,
                                      K_MAIN, K, row["gathers"])
                by_setting[f"{name} {setting} {e}"] = row
                print(f"kernel mach_candidate_topk {name} {e} (m, t)=({m}, {t})"
                      f": {row['ms']:.4f} ms (inline hash {row['inline_ms']:.4f}"
                      f"), plain {row['plain_ms']:.4f} ms, "
                      f"library: none (no single PyTorch call computes the "
                      f"filter), streaming kernel 2 {row['streaming_ms']:.4f} "
                      f"ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}; "
                      f"{row['gathers']} gathers); "
                      f"bucket_topm ({row['topm_path']}) "
                      f"{row['topm_ms']:.4f} ms (graph "
                      f"{row['topm_ms_graph']:.4f}), plain "
                      f"{row['topm_plain_ms']:.4f}, torch.topk "
                      f"{row['topm_library_ms']:.4f} (graph "
                      f"{row['topm_library_ms_graph']:.4f}), bound "
                      f"{row['topm_bound_ms']:.5f} ({row['topm_bound_by']}) "
                      f"[{smi}]", flush=True)

    gate = phase_candidate_gate(dev)
    primary = by_setting["odp exact unbiased"]
    shape = (f"odp: N={N_MAIN} R={odp['R']} B={odp['B']} K={odp['K']} "
             f"L={odp['inv'].shape[1]} k={K_MAIN} table hash, unbiased, exact "
             f"mode (m, t)=({odp['B']}, {odp['R']})")
    rows = [{
        "name": "bucket_topm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mach_candidates.cu",
        "replaces": "src/repro/kernels/mach_candidates.py:140",
        "launches": launches["bucket_topm"],
        "max_abs_err": checks["topm_max_abs_err"],
        "ms": primary["topm_ms"], "plain_ms": primary["topm_plain_ms"],
        "ms_graph": primary["topm_ms_graph"],
        "library_ms_graph": primary["topm_library_ms_graph"],
        "timing": TIMING,
        "bound_ms": primary["topm_bound_ms"],
        "bound_by": primary["topm_bound_by"],
        "library_ms": primary["topm_library_ms"],
        "shape": f"N={N_MAIN} R={odp['R']} B={odp['B']} m={odp['B']} (odp "
                 f"exact mode)",
        "ms_by_setting": {key: {f: v[f] for f in ("m", "topm_path", "topm_ms",
                                                   "topm_ms_graph",
                                                   "topm_plain_ms",
                                                   "topm_library_ms",
                                                   "topm_library_ms_graph",
                                                   "topm_bound_ms")}
                          for key, v in by_setting.items()},
        "gate_ms": gate["topm_ms"], "gate_ms_graph": gate["topm_ms_graph"],
        "ms_lm_and_gate": _topm_timed(dev),
        "checks_by_path": checks["topm_by_path"],
        "ptxas": _ptxas_registers(_build.build_log("mach_candidates"),
                                  "topm_"),
    }, {
        "name": "mach_candidate_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mach_candidates.cu",
        "replaces": "src/repro/kernels/mach_candidates.py:377",
        "launches": launches["mach_candidate_topk"], "max_abs_err": err,
        "ms": primary["ms"], "plain_ms": primary["plain_ms"],
        "bound_ms": primary["bound_ms"], "bound_by": primary["bound_by"],
        "gathers": primary["gathers"],
        "library_ms": None, "streaming_ms": primary["streaming_ms"],
        "shape": shape,
        "ms_by_setting": {key: {f: v[f] for f in ("m", "t", "ms", "inline_ms",
                                                   "plain_ms", "streaming_ms",
                                                   "gathers", "bound_ms",
                                                   "bound_by")}
                          for key, v in by_setting.items()},
        "answer_ms": {" ".join(key): v for key, v in timings.items()},
        "peak_gib": peak_gib, "gate": gate,
    }]
    return rows


def phase_candidate_gate(dev) -> dict:
    """The JAX package's decode gate shape (K=1,048,576, R=16, B=8192,
    N=8, m=12, inline multiply-shift), where the streaming kernel
    refuses R·B: the candidate kernels vs the plain streaming top-k."""
    from repro_torch.core.hashing import MultShiftFamily, inverted_table
    from repro_torch.kernels import mach_candidates as mc
    from repro_torch.kernels import mach_topk as mt

    g = GATE
    fam = MultShiftFamily(g["B"], g["R"], seed=0)
    coeffs, shift = fam.coeffs_tensor(dev), fam.shift
    inv = inverted_table(fam.table_np(g["K"]), g["B"], device=dev)
    meta = _planted_probs(dev, g["N"], g["R"], g["B"], coeffs, shift, g["K"],
                          seed=7)
    flat = _inputs(g["N"], g["R"], g["B"], False, seed=9, dev=dev)
    hash_kw = {"inline_coeffs": coeffs, "inline_shift": shift}
    smi = _nvidia_smi()
    res = {"shape": f"N={g['N']} R={g['R']} B={g['B']} K={g['K']} "
                    f"L={inv.shape[1]} k={g['k']} m={g['m']} inline hash",
           "topm_ms": kernel_ms(lambda: mc.bucket_topm_cuda(meta, g["m"])),
           "topm_ms_graph": graph_ms(
               lambda: mc.bucket_topm_cuda(meta, g["m"]))}
    tau, ids = mc.bucket_topm_cuda(meta, g["m"])
    res["gathers"] = mc.pool_gathers(meta, tau, ids, inv, num_classes=g["K"],
                                     **hash_kw)
    for e in ESTIMATORS:
        t = GATE_T[e]

        def cand(p, e=e, t=t):
            return mc.mach_candidate_topk(p, inv, num_classes=g["K"], k=g["k"],
                                          m=g["m"], t=t, estimator=e, **hash_kw)

        def stream(p, e=e):
            return mt.mach_topk_plain(p, num_classes=g["K"], k=g["k"],
                                      estimator=e, **hash_kw)

        kw = {"num_classes": g["K"], "k": g["k"], "t": t, "estimator": e}
        row = {"t": t,
               "ms": kernel_ms(lambda: mc.mach_candidate_topk_cuda(
                   meta, tau, ids, inv, **kw, **hash_kw), iters=10),
               "decode_ms": kernel_ms(lambda: cand(meta), iters=10),
               "plain_streaming_ms": kernel_ms(lambda: stream(meta), iters=3),
               "recall_at_k": _recall(cand(meta)[1], stream(meta)[1]),
               "recall_at_k_flat_random": _recall(cand(flat)[1],
                                                  stream(flat)[1])}
        (row["bound_ms"], row["bound_by"]), _ = _candidate_bounds(
            meta, ids, inv, None, g["N"], g["R"], g["B"], g["k"], g["K"],
            res["gathers"])
        res[e] = row
        print(f"gate {res['shape']} {e} t={t}: kernel 8 {row['ms']:.4f} ms, "
              f"candidate decode (kernels 7 + 8 + decode) {row['decode_ms']:.4f}"
              f" ms vs plain streaming top-k {row['plain_streaming_ms']:.4f} ms "
              f"(the streaming kernel refuses R·B={g['R'] * g['B']}); bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}; {res['gathers']} "
              f"gathers); recall@{g['k']} "
              f"{row['recall_at_k']:.3f} planted, "
              f"{row['recall_at_k_flat_random']:.3f} flat-random [{smi}]",
              flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 5: fused-xent kernels vs their plain versions, forward and backward
# ---------------------------------------------------------------------------

# loss and lse: rtol 1e-5 (f32 products and sums in another order than
# cuBLAS / torch.logsumexp); gradients rtol 1e-4, atol 1e-6 (the dense and
# ELL kernels reduce dW, dh and dbias with float atomics across blocks, in
# an order that changes from run to run; the gather kernels sum each dW
# row and dbias in a fixed order of their own).  Inputs at the model's own scales: unit
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
# the dense kernel with bf16 operands: each shape above and the LM head's
# (recurrentgemma-2b's N = 2 x 4,096 tokens, d = 2,560, R = 8, B = 2,048).
# The kernel rounds dlogits to bf16 before its products (the plain version
# keeps them float32), so per gradient tensor the largest error is held to
# 2^-7 of its largest entry and the relative L2 error to 2^-8; loss and
# lse stay at LOSS_TOL (both sides sum exact bf16 products in float32).
XENT_DENSE_LM = ("lm head", 8192, 2560, 8, 2048)
BF16_GRAD_MAX, BF16_GRAD_L2 = 2.0 ** -7, 2.0 ** -8
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


def _compare_bf16(tag, got, want, names) -> float:
    """bf16 kernel (loss, lse, grads) vs plain; returns the max abs error."""
    err = 0.0
    for name, a, b in (("loss", got[0], want[0]), ("lse", got[1], want[1])):
        if not torch.isfinite(a).all():
            fail(f"{tag}: non-finite kernel {name}")
        err = max(err, float((a - b).abs().max()))
        if not torch.allclose(a, b, **LOSS_TOL):
            fail(f"{tag}: kernel {name} differs from plain by up to "
                 f"{float((a - b).abs().max())}")
    for name, a, b in zip(names, got[2], want[2]):
        if a.dtype != torch.bfloat16 or not torch.isfinite(a).all():
            fail(f"{tag}: kernel d{name} is {a.dtype}, finite "
                 f"{bool(torch.isfinite(a).all())}")
        diff = a.float() - b.float()
        e, top = float(diff.abs().max()), float(b.float().abs().max())
        rel = float(diff.norm() / b.float().norm())
        if e > BF16_GRAD_MAX * top or rel > BF16_GRAD_L2:
            fail(f"{tag}: kernel d{name} max error {e} (largest entry {top}), "
                 f"relative L2 {rel}")
        err = max(err, e)
    return err


# the float32 card test's inputs (tests/test_torch_cuda.py): N(0, 1)
# features, so dW entries of order 1 cancel to near 0 and float32 rounding
# of either side shows at atol 1e-6; 16 seeds each, with and without bias
XENT_F64_SHAPES = [(70, 200, 25, 32), (130, 256, 2, 300)]
XENT_F64_SEEDS = 16


def _dense_f64_yardstick(dev) -> dict:
    """The float32 kernel and the float32 plain version (cuBLAS) each
    against the plain version in float64, at GRAD_TOL / LOSS_TOL: the
    kernel must have no violation.  Returns both sides' violations and
    largest gradient errors."""
    from repro_torch.kernels import mach_fused_xent as mfx
    out = {"kernel_violations": 0, "plain_violations": 0,
           "kernel_max_err": 0.0, "plain_max_err": 0.0}
    for n, d, r, b in XENT_F64_SHAPES:
        for seed in range(XENT_F64_SEEDS):
            for bias in (True, False):
                gen = torch.Generator(device=dev).manual_seed(seed)
                w = torch.randn((d, r * b), generator=gen, device=dev) / d ** 0.5
                bb = 0.1 * torch.randn((r * b,), generator=gen, device=dev) \
                    if bias else None
                y = torch.randint(0, b, (n, r), generator=gen, device=dev,
                                  dtype=torch.int32)
                g = torch.rand((n,), generator=gen, device=dev) + 0.5
                h = torch.randn((n, d), generator=gen, device=dev)
                leaves = [t.requires_grad_(True) for t in (h, w, bb)
                          if t is not None]
                exact = [t.detach().double().requires_grad_(True)
                         for t in leaves]
                want = _loss_and_grads(lambda: mfx.fused_xent_dense_plain(
                    *exact[:2], exact[2] if bias else None, y, b), exact,
                    g.double())
                for side, fn in (("kernel", mfx.mach_fused_xent_dense),
                                 ("plain", mfx.fused_xent_dense_plain)):
                    got = _loss_and_grads(lambda: fn(h, w, bb, y, b), leaves, g)
                    for a, e, tol in ((got[0], want[0], LOSS_TOL),
                                      (got[1], want[1], LOSS_TOL),
                                      *((x, z, GRAD_TOL)
                                        for x, z in zip(got[2], want[2]))):
                        e = e.float()
                        out[f"{side}_violations"] += int(
                            (~torch.isclose(a, e, **tol)).sum())
                    out[f"{side}_max_err"] = max(
                        out[f"{side}_max_err"],
                        *(float((x - z.float()).abs().max())
                          for x, z in zip(got[2], want[2])))
    if out["kernel_violations"]:
        fail(f"dense float32 kernel vs the float64 plain version: "
             f"{out['kernel_violations']} entries outside tolerance")
    print(f"fused xent dense float32 against the float64 plain version at "
          f"N(0, 1) features ({len(XENT_F64_SHAPES) * XENT_F64_SEEDS * 2} "
          f"cases): kernel {out['kernel_violations']} entries outside "
          f"LOSS_TOL / GRAD_TOL, largest gradient error "
          f"{out['kernel_max_err']:.3e}; cuBLAS float32 plain "
          f"{out['plain_violations']}, {out['plain_max_err']:.3e}", flush=True)
    return out


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
             for f in ("dense", "dense_bf16", "dense_lm_bf16", "ell", "gather")}

    def record(family, err, r2r):
        s = stats[family]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["run_to_run"] = max(s["run_to_run"], r2r)

    dense_cases = [(shape, torch.float32, "dense") for shape in XENT_DENSE_SHAPES]
    dense_cases += [(shape, torch.bfloat16, "dense_bf16")
                    for shape in XENT_DENSE_SHAPES]
    dense_cases.append((XENT_DENSE_LM, torch.bfloat16, "dense_lm_bf16"))
    for (label, n, d, r, b), dtype, key in dense_cases:
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
            h, w, bb = (None if t is None else t.to(dtype) for t in (h, w, bb))
            leaves = [t.requires_grad_(True) for t in (h, w, bb) if t is not None]
            names = ["h", "W"] + (["bias"] if bias else [])
            kern = lambda: mfx.mach_fused_xent_dense(h, w, bb, y, b)
            compare = _compare if dtype == torch.float32 else _compare_bf16
            err = compare(f"dense {label} {dtype} bias={bias}",
                          _loss_and_grads(kern, leaves, g),
                          _loss_and_grads(lambda: mfx.fused_xent_dense_plain(
                              h, w, bb, y, b), leaves, g), names)
            record(key, err, _run_to_run(kern, leaves, g))
            del leaves, h, w, bb
        print(f"fused xent vs plain: dense {label} (N={n}, d={d}, R={r}, "
              f"B={b}) {dtype} ok, with and without bias", flush=True)

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
    stats["dense_f64"] = _dense_f64_yardstick(dev)
    for family, s in stats.items():
        if family == "dense_f64":
            continue
        how = ("no float atomics: must be 0" if family == "gather"
               else "float atomics")
        print(f"fused xent {family}: max abs error vs plain "
              f"{s['max_abs_err']:.3e}; largest backward difference between "
              f"two runs {s['run_to_run']:.3e} ({how})", flush=True)
    if stats["gather"]["run_to_run"] != 0.0:
        fail(f"gather backward: two runs differ by up to "
             f"{stats['gather']['run_to_run']} (it has no float atomics)")
    return stats


# ---------------------------------------------------------------------------
# phase 6: the training main path at full width
# ---------------------------------------------------------------------------

def _bound(family, n, d, r, b, nnz=0, unique=0, j=0, dtype=torch.float32,
           need_dh=False):
    """Least time (ms) for the forward and the backward on this card, and
    what bounds each.  Dense: 2·N·d·R·B operations forward, 4·N·d·R·B
    backward (the logits again, then dW; 6 with dh), on the tensor cores —
    bf16 at the bf16 rate, float32 as 3xTF32, three TF32 products an
    operation at the TF32 rate.  Sparse: 2·nnz·R·B and 4·nnz·R·B float32
    operations over this batch's valid slots.  Bytes count each input
    once (sparse: the W rows this batch touches, the ELL batch, labels and
    lse) and every output once — the dense dW (d·R·B) included.  The main
    path's dense backward runs without dh (its input features need no
    gradient)."""
    c = r * b
    if family == "dense":
        es = 2 if dtype == torch.bfloat16 else 4
        ops_f, ops_b = 2 * n * d * c, (6 if need_dh else 4) * n * d * c
        rate = BF16_TOPS_PER_S if es == 2 else TF32_OPS_PER_S / 3
        bytes_f = es * (n * d + d * c + c) + 4 * n * r + 4 * (n + n * r)
        bytes_b = (es * (n * d + d * c + c) + 4 * (2 * n * r + n)
                   + es * (d * c + c + (n * d if need_dh else 0)))
    else:
        ops_f, ops_b = 2 * nnz * c, 4 * nnz * c
        rate = F32_OPS_PER_S
        ell = 8 * n * j
        bytes_f = 4 * unique * c + ell + 4 * (c + n * r) + 4 * (n + n * r)
        bytes_b = 4 * unique * c + ell + 4 * (c + 2 * n * r + n) + 4 * (d * c + c)
    out = []
    for ops_, bytes_ in ((ops_f, bytes_f), (ops_b, bytes_b)):
        t_ops = ops_ / rate * 1e3
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
        ms_fwd_graph = graph_ms(lambda: fwd(*inputs, w2.detach(),
                                            bias.detach(), labels, b),
                                iters=10)
        ms_bwd_graph = graph_ms(lambda: bwd(*inputs, w2.detach(),
                                            bias.detach(), labels, lse, g, b,
                                            **bwd_kw), iters=10)
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
              f"{ms_fwd:.3f} ms, backward kernel {ms_bwd:.3f} ms (graph "
              f"{ms_fwd_graph:.3f} + {ms_bwd_graph:.3f}; the dense and ELL "
              f"backward's dW zero-fill included), AdamW {ms_adamw:.3f} ms; "
              f"peak "
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
            "launches_bwd_pieces": (
                {k: launches[f"gather_{k}_cuda"]
                 for k in ("dlogits", "column_order", "dw")}
                if family == "gather" else None),
            "max_abs_err": err,
            "ms": ms_fwd + ms_bwd, "ms_fwd": ms_fwd, "ms_bwd": ms_bwd,
            "ms_graph": ms_fwd_graph + ms_bwd_graph,
            "ms_fwd_graph": ms_fwd_graph, "ms_bwd_graph": ms_bwd_graph,
            "plain_ms": plain_ms, "bound_ms": bf + bb_,
            "bound_by": byf if bf >= bb_ else byb,
            "bound_ms_fwd": bf, "bound_by_fwd": byf,
            "bound_ms_bwd": bb_, "bound_by_bwd": byb,
            "library_ms": library_ms,
            "shape": (f"{name}: N={n} d={d} R={r} B={b}"
                      + (f" ELL J={j}, {nnz} valid slots, {unique} "
                         f"distinct features" if family != "dense" else "")
                      + ", with bias; forward + backward"),
            "dtype": "float32",
            "train_step_ms": step_ms, "adamw_ms": ms_adamw,
            "peak_gib": res["peak_gib"],
            "check_max_abs_err": checks[family]["max_abs_err"],
            "run_to_run_max_diff": checks[family]["run_to_run"]}
        if family == "dense":
            row["ms_bwd_with_dh"] = kernel_ms(lambda: bwd(
                *inputs, w2.detach(), bias.detach(), labels, lse, g, b),
                iters=10)
            row["vs_float64_plain"] = checks["dense_f64"]
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


def _kernel_label(mangled: str) -> str:
    """A mangled kernel entry shortened to its name and template values:
    ``top1_lane_kernel<1, 2>``, ``lru_scan_kernel<float32, 16, 32>``;
    kernel 4's as ``bwd_kernel<bf16, cp.async>`` (the dtype and whether
    tiles arrive by 16-byte cp.async or plain loads)."""
    m = re.search(r"\d+([a-z_]+_kernel)I(f|13__nv_bfloat16)Lb([01])", mangled)
    if m:
        return (f"{m[1]}<{'float32' if m[2] == 'f' else 'bf16'}, "
                f"{'cp.async' if m[3] == '1' else 'plain loads'}>")
    for m in re.finditer(r"\d+", mangled):      # <length><identifier>
        name = mangled[m.end():m.end() + int(m[0])]
        if name.endswith("_kernel"):
            rest = mangled[m.end() + len(name):]
            args = (re.findall(r"L[a-z]+(\d+)E", rest[:rest.find("Ev")])
                    if rest.startswith("I") else [])
            for code, dtype in (("If", "float32"),
                                ("I13__nv_bfloat16", "bf16")):
                if rest.startswith(code):         # a type argument first
                    args.insert(0, dtype)
            return f"{name}<{', '.join(args)}>" if args else name
    return mangled


def _ptxas_registers(log: str, prefix: str = "") -> dict:
    """Kernel entry -> 'N registers; spills' from an ``nvcc -Xptxas -v``
    log, for the entries whose label starts with ``prefix``."""
    out, entry, spill = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = _kernel_label(line.split("'")[1])
            if not entry.startswith(prefix):
                entry = None
        elif entry and "spill" in line:
            spill = line.split(":")[-1].strip()
        elif entry and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            out[entry] = f"{regs}; {spill}"
            entry = None
    return out


def _peak_mib(fn) -> float:
    """Device memory a call allocates at its peak, above what was live."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _library_dense(leaves, labels, b, n, r):
    """Yardstick (never used by the port): the bf16 logits by torch.matmul,
    F.cross_entropy on the (N·R, B) view, autograd to h, W and bias."""
    h, w, bias = leaves
    logits = h @ w + bias
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(n * r, b), labels.reshape(-1).long(), reduction="sum")
    return torch.autograd.grad(loss / n, leaves)


def phase_dense_lm_head(dev, checks: dict, launches: int, smi: str) -> dict:
    """Kernel 4 at the LM head's shape in bf16 (the fused LM loss's call:
    forward, then the backward with dh): times, plain and library times,
    peak memory of each, bound, ptxas registers and shared memory.
    ``launches`` is the main path's count (the
    ImageNet-21k training run); the LM path does not run kernel 4 yet."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mach_fused_xent as mfx

    label, n, d, r, b = XENT_DENSE_LM
    gen = torch.Generator(device=dev).manual_seed(17)
    h = torch.nn.functional.normalize(
        torch.randn((n, d), generator=gen, device=dev), dim=1).bfloat16()
    w = (torch.randn((d, r * b), generator=gen, device=dev) / d ** 0.5).bfloat16()
    bias = torch.randn((r * b,), generator=gen, device=dev).bfloat16()
    y = torch.randint(0, b, (n, r), generator=gen, device=dev, dtype=torch.int32)
    g = torch.full((n,), 1.0 / n, device=dev)
    _, lse = mfx.dense_fwd_cuda(h, w, bias, y, b)
    ms_fwd = kernel_ms(lambda: mfx.dense_fwd_cuda(h, w, bias, y, b), iters=10)
    ms_bwd = kernel_ms(lambda: mfx.dense_bwd_cuda(h, w, bias, y, lse, g, b,
                                                  need_dh=True), iters=10)
    leaves = [t.detach().requires_grad_(True) for t in (h, w, bias)]
    plain = lambda: _loss_and_grads(
        lambda: mfx.fused_xent_dense_plain(*leaves, y, b), leaves, g)
    kern = lambda: _loss_and_grads(
        lambda: mfx.mach_fused_xent_dense(*leaves, y, b), leaves, g)
    library = lambda: _library_dense(leaves, y, b, n, r)
    plain_ms = kernel_ms(plain, iters=3, warmup=1)
    library_ms = kernel_ms(library, iters=3, warmup=1)
    peaks = {"kernel": _peak_mib(kern), "plain": _peak_mib(plain),
             "library": _peak_mib(library)}
    (bf, byf), (bb_, byb) = _bound("dense", n, d, r, b, dtype=torch.bfloat16,
                                   need_dh=True)
    smem = _build.load("mach_fused_xent_dense").fused_xent_dense_smem
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    row = {
        "name": "mach_fused_xent_dense", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mach_fused_xent_dense.cu",
        "replaces": "src/repro/kernels/mach_fused_xent.py:724",
        "launches": launches, "launches_lm_path": 0,
        "max_abs_err": checks["dense_lm_bf16"]["max_abs_err"],
        "ms": ms_fwd + ms_bwd, "ms_fwd": ms_fwd, "ms_bwd_with_dh": ms_bwd,
        "plain_ms": plain_ms, "bound_ms": bf + bb_,
        "bound_by": byf if bf >= bb_ else byb,
        "bound_ms_fwd": bf, "bound_by_fwd": byf,
        "bound_ms_bwd": bb_, "bound_by_bwd": byb,
        "library_ms": library_ms, "dtype": "bfloat16",
        "shape": (f"{label}: N={n} d={d} R={r} B={b}, bf16, with bias; "
                  f"forward + backward with dh"),
        "peak_mib_kernel": peaks["kernel"], "peak_mib_plain": peaks["plain"],
        "peak_mib_library": peaks["library"],
        "smem_bytes_fwd": smem(1, 0), "smem_bytes_bwd": smem(1, 1),
        "ptxas": _ptxas_registers(_build.build_log("mach_fused_xent_dense")),
        "run_to_run_max_diff": checks["dense_lm_bf16"]["run_to_run"]}
    print(f"kernel mach_fused_xent_dense ({label}, bf16): forward "
          f"{ms_fwd:.4f} ms + backward with dh {ms_bwd:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bf:.4f} "
          f"({byf}) + {bb_:.4f} ({byb}) ms; peak MiB kernel "
          f"{peaks['kernel']:.1f}, plain {peaks['plain']:.1f}, library "
          f"{peaks['library']:.1f}; "
          f"shared memory {row['smem_bytes_fwd']} / {row['smem_bytes_bwd']} "
          f"bytes [{smi}]", flush=True)
    return row


# ---------------------------------------------------------------------------
# phase 7: the LM substrate kernels (9 and 10) vs their plain versions
# ---------------------------------------------------------------------------

LRU_SHAPES = [(1, 4096, 2560), (2, 4096, 2560), (4, 1, 2560), (3, 37, 300),
              (2, 4097, 2570)]
# flash checks: (label, B, T, H, KV, hd, window, dtype) — the prefill
# shape of recurrentgemma-2b with and without its window, GQA, float32
FLASH_SHAPES = [
    ("recurrentgemma prefill", 1, 4096, 10, 1, 256, 2048, torch.bfloat16),
    ("recurrentgemma no window", 1, 4096, 10, 1, 256, None, torch.bfloat16),
    ("GQA ragged", 2, 1000, 8, 2, 128, None, torch.bfloat16),
    ("tinyllama hd 64, 32/4 heads", 1, 2048, 32, 4, 64, None, torch.bfloat16),
    ("phi3 hd 96, 32/32 heads", 1, 1000, 32, 32, 96, None, torch.bfloat16),
    ("ragged windowed hd 256", 2, 1111, 10, 1, 256, 300, torch.bfloat16),
    ("float32 windowed", 1, 777, 4, 1, 64, 100, torch.float32),
]
FLASH_F32_TOL = {"rtol": 1e-5, "atol": 1e-6}
LM_PROMPTS = (4096, 5, 77, 300)  # the 4,096-token one hits the flash branch
LM_SAMPLED = 2                   # index of the request sampled at T = 0.8
LM_MAX_NEW, LM_SLOTS, LM_MAX_LEN, LM_TOP_K = 16, 4, 4160, 50
# the LM head's decode checks: N=1 (after a prefill) and the decode pool
LM_HEAD_N, LM_HEAD_K = (1, LM_SLOTS), (1, LM_TOP_K)
LM_CAND_APPROX = (16, 2)         # an approximate (m, t) on the LM engine


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at |x| (8 significand bits)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _bf16_row_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 ulps of each (query, head) row's
    largest output.  An output entry that cancels towards zero carries
    the error of its row's scale: e is rounded to bfloat16 from scores
    whose float32 sums ran in another order, and one e on the other side
    of a rounding boundary moves the row by p·|v|·2^-8."""
    scale = want.float().abs().amax(dim=-1, keepdim=True)
    return float(((got.float() - want.float()).abs() / _bf16_ulp(scale)).max())


def _flash_inputs(dev, b, t, h, kv, hd, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, t, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, kv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, kv, hd), generator=gen, device=dev).to(dtype)
    return q, k, v


def attended_pairs(t: int, window) -> int:
    """(query, key) pairs a causal, optionally windowed self-attention of
    length t attends: sum over rows i of min(i + 1, window)."""
    w = t if window is None else min(window, t)
    return w * (w + 1) // 2 + (t - w) * w


def phase_lm_kernels_vs_plain(dev) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls

    errs = {"lru_scan": 0.0, "flash_attention": 0.0}
    cases = 0
    for b, t, d in LRU_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(t)
        a = torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5
        x = torch.randn((b, t, d), generator=gen, device=dev)
        h0 = torch.randn((b, d), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and t > 64:
                continue
            got = ls.lru_scan_cuda(a.to(dtype), x.to(dtype), h0)
            want = ls.lru_scan_plain(a.to(dtype), x.to(dtype), h0)
            torch.cuda.synchronize()
            if got.dtype != dtype or not torch.equal(got, want):
                err = float((got.float() - want.float()).abs().max())
                fail(f"lru_scan {(b, t, d)} {dtype}: kernel != plain "
                     f"(max err {err})")
            cases += 1
    for label, b, t, h, kv, hd, window, dtype in FLASH_SHAPES:
        q, k, v = _flash_inputs(dev, b, t, h, kv, hd, dtype, seed=t + h)
        got = fa.flash_attention_cuda(q, k, v, window=window)
        want = fa.flash_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        if got.dtype != dtype or not torch.isfinite(got.float()).all():
            fail(f"flash_attention {label}: wrong dtype or non-finite output")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if dtype == torch.float32:
            ok = torch.allclose(got, want, **FLASH_F32_TOL)
        else:
            ulps = _bf16_row_ulps(got, want)
            ok = ulps <= 2.0
            print(f"flash_attention {label}: max {ulps:.2f} bf16 ulps of the "
                  f"row scale from plain (elementwise max "
                  f"{float((diff / _bf16_ulp(want)).max()):.1f})", flush=True)
        if not ok:
            fail(f"flash_attention {label}: kernel vs plain max abs err {err}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        cases += 1
    head_cases, errs["lm_head"], head_ms = _lm_head_vs_plain(dev)
    return {"cases": cases, "head_cases": head_cases, "errs": errs,
            "lm_head_top1": head_ms}


def _lm_head_vs_plain(dev) -> tuple[int, float]:
    """Kernels 1 and 2 vs their plain versions at the LM head's shape
    and hash source, on dyadic and random probabilities."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt

    mach = get_config("recurrentgemma-2b").mach
    fam = mach.family
    r, b, num_classes = mach.num_repetitions, mach.num_buckets, mach.num_classes
    table = fam.table(num_classes, dev)
    hash_kw = {"inline_coeffs": fam.coeffs_tensor(dev),
               "inline_shift": fam.shift}
    cases, err = 0, 0.0
    for n in LM_HEAD_N:
        for dyadic in (True, False):
            meta = _inputs(n, r, b, dyadic, seed=n + 7, dev=dev)
            tag = f"LM head n={n} {'dyadic' if dyadic else 'random'} inline"
            kv, ki = md.mach_decode_cuda(meta, num_classes=num_classes,
                                         **hash_kw)
            pv, pi = md.mach_decode_plain(meta, num_classes=num_classes,
                                          **hash_kw)
            torch.cuda.synchronize()
            err = max(err, _check_same(f"top1 {tag}", kv, ki, pv, pi,
                                       md.summed_scores(meta, table), dyadic))
            cases += 1
            for est in ESTIMATORS:
                scores = mt.estimator_scores(meta, table, est)
                for k in LM_HEAD_K:
                    kv, ki = mt.mach_topk_cuda(meta, num_classes=num_classes,
                                               k=k, estimator=est, **hash_kw)
                    pv, pi = mt.mach_topk_plain(meta, num_classes=num_classes,
                                                k=k, estimator=est, **hash_kw)
                    torch.cuda.synchronize()
                    err = max(err, _check_same(f"topk {est} k={k} {tag}", kv,
                                               ki, pv, pi, scores, dyadic))
                    cases += 1
    print(f"LM head decode kernels vs plain: {cases} comparisons ok (R={r}, "
          f"B={b}, K={num_classes}, N in {LM_HEAD_N}, k in {LM_HEAD_K})",
          flush=True)
    return cases, err, _lm_head_top1_times(dev, table, hash_kw, b)


def _lm_head_top1_times(dev, table, hash_kw, b) -> dict:
    """Kernel 1 at the LM head's shape, N in LM_HEAD_N: kernel, plain and
    library ms.  The library call is the multi-hot product as a sparse
    (K, R·B) CSR matrix (R ones a row; a dense one would take 16.8 GB)
    against the probabilities, then ``torch.max``."""
    from repro_torch.kernels import mach_decode as md

    r, k = table.shape
    cols = (torch.arange(r, device=dev)[:, None] * b + table.long()).T
    multihot = torch.sparse_csr_tensor(
        torch.arange(0, k * r + 1, r, device=dev), cols.reshape(-1),
        torch.ones(k * r, device=dev), size=(k, r * b))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = _nvidia_smi()
    out = {}
    for n in LM_HEAD_N:
        meta = _inputs(n, r, b, False, seed=n, dev=dev)
        meta2d_t = meta.reshape(n, r * b).T.contiguous()
        row = {"mapping": md.decode_layout(n, r, b, k, sms).mapping,
               "ms": kernel_ms(lambda: md.mach_decode_cuda(
                   meta, num_classes=k, **hash_kw)),
               "ms_graph": graph_ms(lambda: md.mach_decode_cuda(
                   meta, num_classes=k, **hash_kw)),
               "plain_ms": kernel_ms(lambda: md.mach_decode_plain(
                   meta, num_classes=k, **hash_kw), iters=5),
               "library_ms": kernel_ms(lambda: torch.max(
                   torch.sparse.mm(multihot, meta2d_t), dim=0)),
               "library_ms_graph": graph_ms(lambda: torch.max(
                   torch.sparse.mm(multihot, meta2d_t), dim=0))}
        out[f"N={n}"] = row
        print(f"kernel mach_decode at the LM head (N={n}, R={r}, B={b}, "
              f"K={k}, inline hash, {row['mapping']}): {row['ms']:.4f} ms "
              f"(graph {row['ms_graph']:.4f}), "
              f"plain {row['plain_ms']:.4f}, library {row['library_ms']:.4f} "
              f"(graph {row['library_ms_graph']:.4f}; torch.max over a "
              f"sparse multi-hot product) [{smi}]",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: full-width recurrentgemma-2b served by the slot engine
# ---------------------------------------------------------------------------

def _serve(model, params, prompts, after_first_tick=None,
           candidate_mode=None):
    """Serve the LM phase's requests on a fresh engine, one tick at a
    time.  Returns (tokens per request, ms per tick, seconds)."""
    from repro_torch.serving import (Request, SamplingParams, ServeConfig,
                                     ServingEngine)
    engine = ServingEngine(model, params, ServeConfig(
        max_len=LM_MAX_LEN, num_slots=LM_SLOTS, top_k=LM_TOP_K,
        max_new_tokens=LM_MAX_NEW, seed=0, candidate_mode=candidate_mode))
    for i, p in enumerate(prompts):
        sampling = SamplingParams(temperature=0.8) if i == LM_SAMPLED \
            else SamplingParams()
        engine.submit(Request(prompt=p[0].tolist(), sampling=sampling))
    torch.cuda.synchronize()
    results, tick_ms = [], []
    t0 = time.perf_counter()
    while engine.metrics.completed < len(prompts):
        t1 = time.perf_counter()
        results += engine.step()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t1) * 1e3)
        if after_first_tick is not None and len(tick_ms) == 1:
            after_first_tick()
    run_s = time.perf_counter() - t0
    if len(results) != len(prompts):
        fail(f"lm serve: {len(results)} of {len(prompts)} requests finished")
    return ([r.tokens for r in sorted(results, key=lambda r: r.request_id)],
            tick_ms, run_s)


def _lm_candidates(model, params, prompts, engine_tokens) -> dict:
    """The engine's candidate-filtered decode at the LM head's shape
    (R=8, B=2048, K=256,000, the model's inline hash): the same requests
    through ServeConfig(candidate_mode=(B, R)), which keeps every class a
    candidate and must give the streaming engine's tokens bit for bit,
    and through an approximate (m, t), whose greedy tokens are reported.
    Kernels 7 and 8 launch counts from 0 for each run."""
    from repro_torch.kernels import mach_candidates as mc

    mach = model.cfg.mach
    exact = (mach.num_buckets, mach.num_repetitions)
    res = {}
    for mode in (exact, LM_CAND_APPROX):
        mc.bucket_topm_cuda.launches = 0
        mc.mach_candidate_topk_cuda.launches = 0
        tokens, _, run_s = _serve(model, params, prompts, candidate_mode=mode)
        launches = {
            "bucket_topm": mc.bucket_topm_cuda.launches,
            "mach_candidate_topk": mc.mach_candidate_topk_cuda.launches}
        if min(launches.values()) < 1:
            fail(f"lm serve candidate_mode={mode}: kernels 7-8 launches "
                 f"{launches}")
        res[mode] = {"tokens": tokens, "launches": launches,
                     "run_ms": run_s * 1e3}
    if res[exact]["tokens"] != engine_tokens:
        fail(f"lm serve candidate_mode={exact}: tokens differ from the "
             f"streaming engine's")
    approx = res[LM_CAND_APPROX]["tokens"]
    same = sum(a == b for i in range(len(prompts)) if i != LM_SAMPLED
               for a, b in zip(approx[i], engine_tokens[i]))
    n_greedy = (len(prompts) - 1) * LM_MAX_NEW
    print(f"lm serve candidate_mode={exact} (exact): tokens == the streaming "
          f"engine's, bit for bit; kernels 7-8 launches "
          f"{res[exact]['launches']}, run {res[exact]['run_ms']:.1f} ms. "
          f"candidate_mode={LM_CAND_APPROX}: launches "
          f"{res[LM_CAND_APPROX]['launches']}, run "
          f"{res[LM_CAND_APPROX]['run_ms']:.1f} ms, greedy tokens "
          f"{[approx[i] for i in range(len(prompts)) if i != LM_SAMPLED]} "
          f"({same}/{n_greedy} equal to streaming's at the same step; random "
          f"weights)", flush=True)
    return {"exact_launches": res[exact]["launches"],
            "approx_launches": res[LM_CAND_APPROX]["launches"],
            "approx_greedy_same": same}


def _direct_greedy(model, params, prompts, engine_tokens, dev):
    """A greedy prefill + decode_step + next_token loop straight off the
    model API.  The requests sit in the same 4-row pool at the same slots
    as in the engine (on the card a matrix product's rows depend on the
    batch shape it runs at, not on the other rows), and the sampled row
    is fed the engine's sampled tokens."""
    pool = model.init_caches(LM_SLOTS, LM_MAX_LEN, device=dev)
    toks = []
    for i, p in enumerate(prompts):
        caches, h = model.prefill(params, p, LM_MAX_LEN)
        model.insert_cache_slot(pool, caches, i)
        toks.append([int(model.next_token(params, h)[0][0])])
    toks[LM_SAMPLED] = list(engine_tokens[LM_SAMPLED][:1])
    for step in range(1, LM_MAX_NEW):
        last = torch.tensor([t[-1] for t in toks], device=dev)
        pos = torch.tensor([p.shape[1] + step - 1 for p in prompts],
                           device=dev)
        pool, h = model.decode_step(params, pool, last, pos, per_slot=True)
        ids = model.next_token(params, h)[0].tolist()
        for i in range(LM_SLOTS):
            toks[i].append(engine_tokens[i][step] if i == LM_SAMPLED
                           else ids[i])
    return toks


def phase_lm_serve(dev, checks: dict) -> tuple[list[dict], dict]:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt
    from repro_torch.models import LanguageModel

    t0 = time.perf_counter()
    cfg = get_config("recurrentgemma-2b")
    model = LanguageModel(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    rng = np.random.default_rng(0)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                               device=dev) for n in LM_PROMPTS]
    torch.cuda.synchronize()
    print(f"lm serve: recurrentgemma-2b full width ({cfg.num_layers} layers, "
          f"d={cfg.d_model}, V={cfg.vocab_size}, MACH B={cfg.mach.num_buckets}"
          f" R={cfg.mach.num_repetitions}), {n_params:,} params "
          f"(param_count_estimate {cfg.param_count_estimate():,}) = "
          f"{n_bytes / 1e9:.3f} GB; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the main path's run: counts from 0, read just after
    kernels = {"lru_scan": ls.lru_scan_cuda,
               "flash_attention": fa.flash_attention_cuda,
               "mach_decode": md.mach_decode_cuda,
               "mach_topk": mt.mach_topk_cuda}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    after_tick0 = {}

    def first_tick():
        after_tick0.update({n: fn.launches for n, fn in kernels.items()})

    engine_tokens, tick_ms, run_s = _serve(model, params, prompts, first_tick)
    served = {n: fn.launches for n, fn in kernels.items()}
    direct = _direct_greedy(model, params, prompts, engine_tokens, dev)
    torch.cuda.synchronize()
    in_loop = {n: fn.launches - served[n] for n, fn in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"lm serve launches: engine {served} (after the admission tick "
          f"{after_tick0}); direct greedy loop {in_loop}; peak "
          f"{peak_gib:.2f} GiB", flush=True)

    # checks: every request done, greedy == the direct loop, the kernels ran
    for i, toks in enumerate(engine_tokens):
        if len(toks) != LM_MAX_NEW or not all(0 <= t < cfg.vocab_size
                                              for t in toks):
            fail(f"lm serve: request {i} gave {toks}")
        if i != LM_SAMPLED and list(toks) != direct[i]:
            fail(f"lm serve: greedy request {i} (prompt {LM_PROMPTS[i]}) "
                 f"gave {list(toks)}, the direct loop {direct[i]}")
    n_attn = cfg.layout().count("attn_local")
    n_rec = cfg.layout().count("rglru")
    decode_ticks = len(tick_ms)
    if served["flash_attention"] != n_attn:
        fail(f"flash_attention launched {served['flash_attention']} times, "
             f"expected {n_attn} (the 4,096-token prefill)")
    if after_tick0["lru_scan"] < n_rec * len(prompts) or \
            served["lru_scan"] != n_rec * (len(prompts) + decode_ticks):
        fail(f"lru_scan launches {after_tick0['lru_scan']} / "
             f"{served['lru_scan']}: not one a recurrent layer per prefill "
             f"and decode step")
    if served["mach_topk"] < 1:
        fail("the engine's serve steps did not launch mach_topk")
    if in_loop["mach_decode"] < 1:
        fail("the direct greedy loop's next_token did not launch mach_decode")
    print(f"lm serve ok: {len(engine_tokens)} requests, greedy tokens == the direct "
          f"greedy loop; request 0 (4,096-token prompt): "
          f"{list(engine_tokens[0])}", flush=True)
    head_err = _lm_head_on_path(model, params, prompts)
    _flash_vs_dense(model, params, prompts[0], rng)
    cand = _lm_candidates(model, params, prompts, engine_tokens)

    # end-to-end times (host clock, synchronized): the same requests on a
    # fresh engine again, warm; then the decode step split into the model
    # step and the MACH head + top-k
    warm_tokens, warm_ms, warm_s = _serve(model, params, prompts)
    if warm_tokens != engine_tokens:
        fail("lm serve: a second run of the same requests gave other tokens")
    tokens = sum(len(t) for t in warm_tokens)
    decode_ms = statistics.median(warm_ms[1:])
    prefill_ms = wall_ms(lambda: model.prefill(params, prompts[0], LM_MAX_LEN),
                         runs=3, warmup=1)
    pool = model.init_caches(LM_SLOTS, LM_MAX_LEN, device=dev)
    last = torch.zeros((LM_SLOTS,), dtype=torch.int64, device=dev)
    pos = torch.full((LM_SLOTS,), 100, dtype=torch.int64, device=dev)
    step_ms = wall_ms(lambda: model.decode_step(params, pool, last, pos,
                                                per_slot=True))
    hidden = torch.randn((LM_SLOTS, cfg.d_model), device=dev).to(cfg.dtype)
    head_ms = wall_ms(lambda: model.topk_candidates(params, hidden, LM_TOP_K))
    smi = _nvidia_smi()
    print(f"lm serve: prefill of the 4,096-token prompt {prefill_ms:.3f} ms "
          f"(median of 3); pooled decode step {decode_ms:.3f} ms (engine "
          f"tick, warm run, median of {len(warm_ms) - 1}); alone, the model's "
          f"decode_step {step_ms:.3f} ms and the MACH head + top-k "
          f"{head_ms:.3f} ms (medians of 7); admission tick (4 prefills + a "
          f"decode step) {warm_ms[0]:.3f} ms warm, {tick_ms[0]:.3f} ms in "
          f"the first run; {tokens} tokens in {warm_s * 1e3:.1f} ms = "
          f"{tokens / warm_s:.1f} tokens/s warm ({tokens / run_s:.1f} in the "
          f"first run); params {n_bytes / 2**30:.2f} GiB, peak "
          f"{peak_gib:.2f} GiB [{smi}]", flush=True)

    # kernel times at the main path's shapes
    rows = []
    b, t, d = 1, LM_PROMPTS[0], cfg.resolved_rnn_width
    gen = torch.Generator(device=dev).manual_seed(1)
    a = torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5
    x = torch.randn((b, t, d), generator=gen, device=dev)
    h0 = torch.zeros((b, d), device=dev)
    ms9 = kernel_ms(lambda: ls.lru_scan_cuda(a, x, h0))
    ms9_graph = graph_ms(lambda: ls.lru_scan_cuda(a, x, h0))
    a4, x4 = a[:, :1].expand(LM_SLOTS, 1, d).contiguous(), \
        x[:, :1].expand(LM_SLOTS, 1, d).contiguous()
    h04 = torch.zeros((LM_SLOTS, d), device=dev)
    ms9_decode = kernel_ms(lambda: ls.lru_scan_cuda(a4, x4, h04))
    ms9_decode_graph = graph_ms(lambda: ls.lru_scan_cuda(a4, x4, h04))
    plain9 = kernel_ms(lambda: ls.lru_scan_plain(a, x, h0), iters=3, warmup=1)
    bytes9 = 3 * b * t * d * 4 + b * d * 4
    rows.append({
        "name": "lru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lru_scan.cu",
        "replaces": "src/repro/kernels/lru_scan.py:46",
        "launches": served["lru_scan"],
        "max_abs_err": checks["errs"]["lru_scan"],
        "ms": ms9, "ms_graph": ms9_graph, "plain_ms": plain9,
        "bound_ms": bytes9 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "shape": f"prefill (B, T, D)=({b}, {t}, {d}) float32",
        "ms_decode": ms9_decode, "ms_decode_graph": ms9_decode_graph,
        "shape_decode": f"decode ({LM_SLOTS}, 1, {d}) float32",
        "ptxas": _ptxas_registers(_build.build_log("lru_scan")),
        "timing": "ms by kernel_ms (CUDA events); *_graph by graph_ms "
                  "(CUDA-graph replay, device time)"})
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    window = cfg.local_window
    q, k, v = _flash_inputs(dev, b, t, h, kv, hd, cfg.dtype, seed=2)
    ms10 = kernel_ms(lambda: fa.flash_attention_cuda(q, k, v, window=window),
                     iters=10)
    plain10 = kernel_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                         window=window),
                        iters=3, warmup=1)
    pairs = attended_pairs(t, window)
    flops = 4 * hd * h * pairs * b
    t_ops = flops / BF16_TOPS_PER_S * 1e3
    t_bytes = 2 * (2 * q.numel() + k.numel() + v.numel()) / HBM_BYTES_PER_S * 1e3
    rows_i = torch.arange(t, device=dev)[:, None]
    cols_i = torch.arange(t, device=dev)[None, :]
    mask = (cols_i <= rows_i) & (cols_i > rows_i - window)
    qh, kh, vh = (z.transpose(1, 2) for z in (q, k.expand(b, t, h, hd),
                                              v.expand(b, t, h, hd)))
    library10 = kernel_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), iters=5, warmup=2)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": served["flash_attention"],
        "max_abs_err": checks["errs"]["flash_attention"],
        "ms": ms10, "plain_ms": plain10,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library10,
        "shape": (f"prefill q ({b}, {t}, {h}, {hd}), k/v ({b}, {t}, {kv}, "
                  f"{hd}) bfloat16, causal, window {window}: {pairs:,} "
                  f"attended pairs a head, {flops / 1e9:.1f} GFLOP"),
        "tflops_per_s": flops / ms10 / 1e9})
    for row in rows:
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        print(f"kernel {row['name']}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {lib}, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), launches "
              f"{row['launches']} on the LM serve path; {row['shape']} "
              f"[{smi}]", flush=True)
    print(f"kernel lru_scan: graph {ms9_graph:.4f} ms at the prefill; at "
          f"decode ({LM_SLOTS}, 1, {d}): {ms9_decode:.4f} ms, graph "
          f"{ms9_decode_graph:.4f} ms; kernel flash_attention {rows[1]['tflops_per_s']:.1f} TFLOP/s "
          f"[{smi}]", flush=True)
    print(f"kernel lru_scan ptxas (registers; spills): {rows[0]['ptxas']}",
          flush=True)
    lm = {"launches_engine": served, "launches_direct_loop": in_loop,
          "candidates": cand, "head_err": head_err, "prefill_ms": prefill_ms,
          "decode_step_ms": decode_ms, "tokens_per_s": tokens / warm_s,
          "peak_gib": peak_gib}
    return rows, lm


def _lm_head_on_path(model, params, prompts) -> float:
    """Kernels 1 and 2 vs plain on the path's own inputs: the head's
    probabilities at the four prompts' last hidden states, k = top_k."""
    from repro_torch.kernels import mach_decode as md
    from repro_torch.kernels import mach_topk as mt

    mach = model.cfg.mach
    hidden = torch.cat([model.prefill(params, p, LM_MAX_LEN)[1]
                        for p in prompts])
    meta = torch.softmax(model.mach_logits(params, hidden).float(), dim=-1)
    fam = mach.family
    table = fam.table(mach.num_classes, meta.device)
    hash_kw = {"inline_coeffs": fam.coeffs_tensor(meta.device),
               "inline_shift": fam.shift}
    kv, ki = md.mach_decode_cuda(meta, num_classes=mach.num_classes, **hash_kw)
    pv, pi = md.mach_decode_plain(meta, num_classes=mach.num_classes,
                                  **hash_kw)
    torch.cuda.synchronize()
    err = _check_same("LM path top1", kv, ki, pv, pi,
                      md.summed_scores(meta, table), False)
    for est in ESTIMATORS:
        kv, ki = mt.mach_topk_cuda(meta, num_classes=mach.num_classes,
                                   k=LM_TOP_K, estimator=est, **hash_kw)
        pv, pi = mt.mach_topk_plain(meta, num_classes=mach.num_classes,
                                    k=LM_TOP_K, estimator=est, **hash_kw)
        torch.cuda.synchronize()
        err = max(err, _check_same(f"LM path topk {est} k={LM_TOP_K}", kv, ki,
                                   pv, pi, mt.estimator_scores(meta, table,
                                                               est), False))
    print(f"lm serve: kernels 1 and 2 == plain on the path's head "
          f"probabilities ({tuple(meta.shape)}, k={LM_TOP_K}, 3 estimators), "
          f"max abs err {err:.3e}", flush=True)
    return err


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def _flash_vs_dense(model, params, prompt, rng) -> None:
    """The long prefill through the flash branch against the same model
    on its dense branch (flash_threshold raised), then a decode step on
    the rolled ring caches against a dense prefill of one more token.

    Positions, indices, and the first attention layer's K/V (no attention
    runs before it) must be equal.  The rest is held to the model in
    float32 on the dense branch, as FlashAttention's tests hold their
    kernels: each bf16 result's relative L2 error there is at most twice
    the bf16 dense branch's, plus 2^-9 (half a bf16 ulp).  A wrong layout
    or a wrong ring offset gives errors of order one."""
    from repro_torch.models import LanguageModel
    from repro_torch.models.transformer import tree_map

    cfg, f32 = model.cfg, torch.float32
    dense = LanguageModel(dataclasses.replace(cfg, flash_threshold=1 << 30))
    truth = LanguageModel(dataclasses.replace(
        cfg, flash_threshold=1 << 30, dtype=f32, param_dtype=f32))
    params32 = tree_map(lambda x: x.float() if x.is_floating_point() else x,
                        params)
    t, dev = prompt.shape[1], prompt.device
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1,)), device=dev)
    longer = torch.cat([prompt, tok[None]], 1)
    runs = {}
    for name, m, p in (("flash", model, params), ("dense", dense, params),
                       ("float32", truth, params32)):
        caches, h = m.prefill(p, prompt, LM_MAX_LEN)
        run = {"hidden": [h]}
        for st in caches:
            for c in st:
                for field in c._fields:
                    # a copy: the decode step below writes in place
                    run.setdefault(field, []).append(getattr(c, field).clone())
        if name == "flash":   # position t overwrites ring row t mod window
            run["next"] = [model.decode_step(params, caches, tok,
                                             torch.tensor([t], device=dev),
                                             per_slot=True)[1]]
        else:
            run["next"] = [m.prefill(p, longer, LM_MAX_LEN)[1]]
        runs[name] = run
    del params32
    for field in ("positions", "index"):
        for name in ("dense", "float32"):
            if not all(torch.equal(a, b) for a, b in
                       zip(runs["flash"][field], runs[name][field])):
                fail(f"flash vs {name} prefill: cache {field} differ")
    if not (torch.equal(runs["flash"]["k"][0][0], runs["dense"]["k"][0][0]) and
            torch.equal(runs["flash"]["v"][0][0], runs["dense"]["v"][0][0])):
        fail("flash vs dense prefill: the first attention layer's K/V differ")
    report = []
    for field, got in runs["flash"].items():
        if field in ("positions", "index"):
            continue
        want = runs["float32"][field]
        e_flash = max(_rel_l2(a, b) for a, b in zip(got, want))
        e_dense = max(_rel_l2(a, b) for a, b in zip(runs["dense"][field], want))
        e_pair = max(_rel_l2(a, b) for a, b in zip(got, runs["dense"][field]))
        report.append(f"{field} {e_flash:.5f} / {e_dense:.5f} ({e_pair:.5f})")
        if not e_flash <= 2 * e_dense + 2.0 ** -9:
            fail(f"flash path vs float32 dense: {field} relative L2 "
                 f"{e_flash:.5f}, more than twice the bf16 dense branch's "
                 f"{e_dense:.5f} + 2^-9")
    print(f"lm serve: prefill of {t} tokens, flash vs dense — positions, index "
          f"and the first attention layer's K/V equal; relative L2 to float32 "
          f"dense, flash / bf16 dense (flash vs bf16 dense): "
          + "; ".join(report) + f" (next = a decode step on the rolled ring "
          f"vs a dense prefill of {t + 1} tokens); bound 2 x dense + 2^-9",
          flush=True)


# ---------------------------------------------------------------------------
# phase 9: the LM training kernels vs their plain versions
# ---------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 6
# kernel 3 checks: (N, R, B, dtype) — ragged N and B, then the path's
# shape (B·T rows of the recurrentgemma head, R=8, B=2048) in bf16
XENT_LM_SHAPES = [(13, 4, 16, torch.float32), (37, 5, 37, torch.float32),
                  (37, 5, 37, torch.bfloat16), (70, 8, 2048, torch.float32),
                  (TRAIN_BATCH * TRAIN_SEQ, 8, 2048, torch.bfloat16)]
XENT_TOL = {"rtol": 1e-5, "atol": 1e-5}
# kernel 9 backward checks: (B, T, D, dtype), nonzero h0
LRU_BWD_SHAPES = [(TRAIN_BATCH, TRAIN_SEQ, 2560, torch.float32),
                  (4, 1, 2560, torch.float32), (3, 37, 300, torch.float32),
                  (3, 37, 300, torch.bfloat16), (1, 1, 16, torch.float32),
                  (2, 4097, 2570, torch.float32)]
# kernel 10 backward checks: (label, B, T, H, KV, hd, causal, window, dtype)
FLASH_BWD_SHAPES = [
    ("recurrentgemma train", TRAIN_BATCH, TRAIN_SEQ, 10, 1, 256, True, 2048,
     torch.bfloat16),
    ("causal G=1", 1, 200, 4, 4, 64, True, None, torch.float32),
    ("windowed G=2", 2, 150, 4, 2, 32, True, 40, torch.float32),
    ("windowed G=10", 1, 300, 10, 1, 64, True, 100, torch.float32),
    ("no mask G=2", 1, 97, 4, 2, 16, False, None, torch.float32),
    ("GQA ragged", 2, 333, 8, 2, 128, True, None, torch.bfloat16),
    ("tinyllama hd 64, 32/4 heads", 1, 1024, 32, 4, 64, True, None,
     torch.bfloat16),
    ("phi3 hd 96, 32/32 heads", 1, 700, 32, 32, 96, True, None,
     torch.bfloat16),
    ("ragged windowed hd 256", 1, 333, 10, 1, 256, True, 100, torch.bfloat16),
    ("no mask hd 48", 1, 97, 4, 2, 48, False, None, torch.bfloat16),
]
FLASH_BWD_F32_TOL = {"rtol": 1e-4, "atol": 1e-5}


def _bf16_backward_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 ulps of each row's largest entry,
    after a float32 noise floor of 2^-20 of the tensor's largest entry: a
    query row that sees one key has P = 1 and an exact dQ of zero, and
    both compute float32 rounding noise of dP - D there."""
    scale = want.float().abs().amax(dim=-1, keepdim=True)
    floor = 2.0 ** -20 * float(want.float().abs().max())
    excess = ((got.float() - want.float()).abs() - floor).clamp_min(0.0)
    return float((excess / _bf16_ulp(scale)).max())


def phase_lm_train_kernels_vs_plain(dev) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.kernels import mach_xent as mx

    errs = {"mach_xent_fwd": 0.0, "mach_xent_bwd": 0.0, "lru_scan_bwd": 0.0,
            "flash_attention_bwd": 0.0}
    cases = 0
    for n, r, b, dtype in XENT_LM_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(n + b)
        logits = (torch.randn((n, r, b), generator=gen, device=dev) * 3
                  ).to(dtype)
        labels = torch.randint(0, b, (n, r), generator=gen, device=dev,
                               dtype=torch.int32)
        labels[0], labels[-1] = 0, b - 1
        g = torch.randn((n,), generator=gen, device=dev)
        loss = mx.mach_xent_cuda_fwd(logits, labels)
        grad = mx.mach_xent_cuda_bwd(logits, labels, g)
        want_loss = mx.mach_xent_plain(logits, labels)
        want_grad = mx.mach_xent_grad_plain(logits, labels, g)
        torch.cuda.synchronize()
        tag = f"mach_xent {(n, r, b)} {dtype}"
        if not torch.allclose(loss, want_loss, **XENT_TOL):
            fail(f"{tag}: loss off by {float((loss - want_loss).abs().max())}")
        if grad.dtype != dtype:
            fail(f"{tag}: gradient in {grad.dtype}")
        if dtype == torch.float32:
            ok = torch.allclose(grad, want_grad, rtol=1e-5, atol=1e-7)
        else:
            ok = bool(torch.all((grad.float() - want_grad.float()).abs()
                                <= _bf16_ulp(want_grad)))
        if not ok:
            fail(f"{tag}: gradient off by "
                 f"{float((grad.float() - want_grad.float()).abs().max())}")
        errs["mach_xent_fwd"] = max(errs["mach_xent_fwd"],
                                    float((loss - want_loss).abs().max()))
        errs["mach_xent_bwd"] = max(errs["mach_xent_bwd"], float(
            (grad.float() - want_grad.float()).abs().max()))
        cases += 2
    for b, t, d, dtype in LRU_BWD_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(t + d)
        a = (torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5
             ).to(dtype)
        x = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
        h0 = torch.randn((b, d), generator=gen, device=dev)
        dh = torch.randn((b, t, d), generator=gen, device=dev).to(dtype)
        h = ls.lru_scan_cuda(a, x, h0)
        got = ls.lru_scan_bwd_cuda(a, h, h0, dh)
        want = ls.lru_scan_bwd_plain(a, h, h0, dh)
        torch.cuda.synchronize()
        if not torch.equal(h, ls.lru_scan_plain(a, x, h0)):
            fail(f"lru_scan {(b, t, d)} {dtype}: the forward feeding the "
                 f"backward check != plain")
        for name, gv, wv in zip(("da", "dx", "dh0"), got, want):
            if gv.dtype != wv.dtype or not torch.equal(gv, wv):
                fail(f"lru_scan backward {(b, t, d)} {dtype}: {name} kernel "
                     f"!= plain (max err "
                     f"{float((gv.float() - wv.float()).abs().max())})")
        cases += 1
    for label, b, t, h, kv, hd, causal, window, dtype in FLASH_BWD_SHAPES:
        q, k, v = _flash_inputs(dev, b, t, h, kv, hd, dtype, seed=t + hd)
        gen = torch.Generator(device=dev).manual_seed(t)
        dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        plain_out = fa.flash_attention_cuda(q, k, v, causal=causal,
                                            window=window)
        out, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        got = fa.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                          causal=causal, window=window)
        want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                            causal=causal, window=window)
        torch.cuda.synchronize()
        if not torch.equal(out, plain_out):
            fail(f"flash_attention {label}: the forward with lse differs from "
                 f"the forward without it")
        report = []
        for name, gv, wv in zip(("dq", "dk", "dv"), got, want):
            if gv.dtype != dtype or not torch.isfinite(gv.float()).all():
                fail(f"flash backward {label}: {name} wrong dtype or "
                     f"non-finite")
            err = float((gv.float() - wv.float()).abs().max())
            if dtype == torch.float32:
                ok = torch.allclose(gv, wv, **FLASH_BWD_F32_TOL)
                report.append(f"{name} {err:.2e}")
            else:
                ulps = _bf16_backward_ulps(gv, wv)
                ok = ulps <= 2.0
                report.append(f"{name} {ulps:.2f} ulps")
            if not ok:
                fail(f"flash backward {label}: {name} kernel vs plain max abs "
                     f"err {err}")
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], err)
        print(f"flash_attention backward {label} {dtype}: kernel vs plain "
              + ", ".join(report) + " (bf16: of each row's largest entry, "
              "past a 2^-20 float32 floor); forward with lse == without",
              flush=True)
        cases += 1
    return {"cases": cases, "errs": errs}


# ---------------------------------------------------------------------------
# phase 10: recurrentgemma-2b trained at full width
# ---------------------------------------------------------------------------

GRAD_GROUPS = ("embedding", "rglru", "attention", "mlp", "norms", "head")


def _grad_group(path: str) -> str:
    if path.startswith("embed"):
        return "embedding"
    if path.startswith("mach_head"):
        return "head"
    for key, group in (("rglru", "rglru"), ("attn", "attention"),
                       ("mlp", "mlp")):
        if f"/{key}/" in path:
            return group
    return "norms"


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{path}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{path}{i}/")]
    return [(path, tree)]


def _group_errors(grads, truth) -> dict:
    """Relative L2 error of each parameter group's gradient to ``truth``."""
    num = dict.fromkeys(GRAD_GROUPS, 0.0)
    den = dict.fromkeys(GRAD_GROUPS, 0.0)
    for (path, g), (_, t) in zip(_named_leaves(grads), _named_leaves(truth)):
        group = _grad_group(path)
        num[group] += float((g.float() - t.float()).square().sum())
        den[group] += float(t.float().square().sum())
    return {k: math.sqrt(num[k] / max(den[k], 1e-30)) for k in GRAD_GROUPS}


def _first_step_grads_vs_float32(model, params, batch) -> dict:
    """The first step's gradients of the bf16 flash path against the same
    model in float32 on the dense branch, with the bf16 dense branch's
    error as the yardstick: each group's relative L2 error at most twice
    the bf16 dense branch's, plus 2^-9."""
    from repro_torch.models import LanguageModel
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim import value_and_grad

    cfg, f32 = model.cfg, torch.float32
    dense = LanguageModel(dataclasses.replace(cfg, flash_threshold=1 << 30))
    truth_model = LanguageModel(dataclasses.replace(
        cfg, flash_threshold=1 << 30, dtype=f32, param_dtype=f32))
    params32 = tree_map(lambda x: x.float() if x.is_floating_point() else x,
                        params)
    (loss32, _), truth = value_and_grad(truth_model.loss, params32, batch,
                                        has_aux=True)
    del params32
    errs, losses = {}, {"float32": float(loss32)}
    for name, m in (("dense", dense), ("flash", model)):
        (loss, _), grads = value_and_grad(m.loss, params, batch, has_aux=True)
        errs[name] = _group_errors(grads, truth)
        losses[name] = float(loss)
        del grads
    del truth
    for group in GRAD_GROUPS:
        e_flash, e_dense = errs["flash"][group], errs["dense"][group]
        if not e_flash <= 2 * e_dense + 2.0 ** -9:
            fail(f"lm train: {group} gradients of the bf16 flash path are "
                 f"{e_flash:.5f} from float32, more than twice the bf16 dense "
                 f"branch's {e_dense:.5f} + 2^-9")
    print("lm train: first-step gradients, relative L2 to the float32 dense "
          "model, bf16 flash path / bf16 dense branch: "
          + "; ".join(f"{g} {errs['flash'][g]:.5f} / {errs['dense'][g]:.5f}"
                      for g in GRAD_GROUPS)
          + f" (bound 2 x dense + 2^-9); loss float32 {losses['float32']:.6f}"
          f", bf16 dense {losses['dense']:.6f}, bf16 flash "
          f"{losses['flash']:.6f}", flush=True)
    return {"errs": errs, "losses": losses}


def phase_lm_train(dev, checks: dict) -> tuple[list[dict], dict]:
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataConfig, SyntheticLMStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.kernels import mach_xent as mx
    from repro_torch.models import LanguageModel
    from repro_torch.train import TrainConfig, Trainer, new_train_state

    t0 = time.perf_counter()
    cfg = get_config("recurrentgemma-2b")
    model = LanguageModel(cfg)
    # launch/train.py's TrainConfig: AdamW, warmup 2, peak 3e-4, clip 1.0
    tcfg = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=2, peak_lr=3e-4,
                       log_every=min(5, TRAIN_STEPS))
    trainer = Trainer(model, tcfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    stream = SyntheticLMStream(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=0), device=dev)
    batch0 = stream.batch_at(0)
    torch.cuda.synchronize()
    print(f"lm train: recurrentgemma-2b full width ({cfg.num_layers} layers, "
          f"{cfg.param_dtype}, remat={cfg.remat}), batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, {TRAIN_STEPS} AdamW steps (warmup 2, peak "
          f"3e-4, clip 1.0); set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    grad_check = _first_step_grads_vs_float32(model, params, batch0)
    torch.cuda.empty_cache()

    # the main path's run: counts from 0, read just after
    kernels = {"mach_xent_fwd": mx.mach_xent_cuda_fwd,
               "mach_xent_bwd": mx.mach_xent_cuda_bwd,
               "lru_scan": ls.lru_scan_cuda,
               "lru_scan_bwd": ls.lru_scan_bwd_cuda,
               "flash_attention": fa.flash_attention_cuda,
               "flash_attention_bwd": fa.flash_attention_bwd_cuda}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    state = new_train_state(params, trainer.opt)
    del params
    losses, step_ms = [], []
    for s in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        state, metrics = trainer.step_fn(state, stream.batch_at(s))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    with torch.no_grad():
        after = float(model.loss(state.params, batch0)[0])
    n_attn = cfg.layout().count("attn_local")
    n_rec = cfg.layout().count("rglru")
    # remat: each forward kernel runs again when its period is recomputed
    expected = {"mach_xent_fwd": 1, "mach_xent_bwd": 1, "lru_scan": 2 * n_rec,
                "lru_scan_bwd": n_rec, "flash_attention": 2 * n_attn,
                "flash_attention_bwd": n_attn}
    print(f"lm train: losses {losses}; batch 0 after {TRAIN_STEPS} steps "
          f"{after:.6f}; launches {launches} (a step: {expected}); peak "
          f"{peak_gib:.2f} GiB", flush=True)
    if not all(math.isfinite(v) for v in losses + [after]):
        fail(f"lm train: non-finite loss in {losses} / {after}")
    if not after < losses[0]:
        fail(f"lm train: batch 0's loss {after} after {TRAIN_STEPS} steps is "
             f"not below its loss at step 0, {losses[0]}")
    for name, per_step in expected.items():
        if launches[name] != per_step * TRAIN_STEPS:
            fail(f"lm train: {name} launched {launches[name]} times, expected "
                 f"{per_step} a step")

    # the step split: forward + backward, then clip + AdamW + apply
    from repro_torch.optim import accumulate_grads, apply_updates
    from repro_torch.optim import clip_by_global_norm
    batch = stream.batch_at(TRAIN_STEPS)
    fb_ms = wall_ms(lambda: accumulate_grads(model.loss, state.params, batch,
                                             1), runs=2, warmup=1)
    (_, _), grads = accumulate_grads(model.loss, state.params, batch, 1)

    def update():
        clipped, _ = clip_by_global_norm(grads, tcfg.clip_norm)
        upd, _ = trainer.opt.update(clipped, state.opt_state, state.params)
        return apply_updates(state.params, upd)
    opt_ms = wall_ms(update, runs=2, warmup=1)
    del grads, state
    torch.cuda.empty_cache()
    smi = _nvidia_smi()
    train_ms = statistics.median(step_ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"lm train: {train_ms:.3f} ms/step (host clock, median of steps "
          f"2..{TRAIN_STEPS}; the first {step_ms[0]:.3f} ms), "
          f"{tokens / train_ms * 1e3:.1f} tokens/s; alone, forward + backward "
          f"{fb_ms:.3f} ms and clip + AdamW + apply {opt_ms:.3f} ms (medians "
          f"of 2); peak {peak_gib:.2f} GiB [{smi}]", flush=True)

    rows = _lm_train_kernel_rows(dev, cfg, launches, checks, smi)
    train = {"launches": launches, "losses": losses, "after": after,
             "step_ms": train_ms, "peak_gib": peak_gib, "fb_ms": fb_ms,
             "opt_ms": opt_ms, "grad_check": grad_check}
    return rows, train


def _lm_train_kernel_rows(dev, cfg, launches, checks, smi) -> list[dict]:
    """Kernel times at the training path's shapes (CUDA events), beside
    their bounds, plain versions and library yardsticks."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.kernels import mach_xent as mx

    rows = []
    errs = checks["errs"]
    b, t = TRAIN_BATCH, TRAIN_SEQ
    n, r, nb = b * t, cfg.mach.num_repetitions, cfg.mach.num_buckets
    gen = torch.Generator(device=dev).manual_seed(3)
    logits = torch.randn((n, r, nb), generator=gen, device=dev).to(cfg.dtype)
    labels = torch.randint(0, nb, (n, r), generator=gen, device=dev,
                           dtype=torch.int32)
    g = torch.randn((n,), generator=gen, device=dev)
    ms_f = kernel_ms(lambda: mx.mach_xent_cuda_fwd(logits, labels))
    ms_b = kernel_ms(lambda: mx.mach_xent_cuda_bwd(logits, labels, g))
    plain_f = kernel_ms(lambda: mx.mach_xent_plain(logits, labels), iters=3,
                        warmup=1)
    plain_b = kernel_ms(lambda: mx.mach_xent_grad_plain(logits, labels, g),
                        iters=3, warmup=1)
    flat = logits.reshape(n * r, nb).detach().requires_grad_(True)
    flat_y = labels.reshape(-1).long()
    lib_f = kernel_ms(lambda: F.cross_entropy(flat, flat_y, reduction="none"))
    ce = F.cross_entropy(flat, flat_y, reduction="none")
    g_rep = g.repeat_interleave(r)
    lib_b = kernel_ms(lambda: torch.autograd.grad(ce, flat, g_rep,
                                                  retain_graph=True))
    del ce, flat
    bytes_f = n * r * nb * logits.element_size() + 4 * n * r + 4 * n
    bytes_b = 2 * n * r * nb * logits.element_size() + 4 * n * r + 4 * n
    shape3 = f"(N, R, B)=({n}, {r}, {nb}) {str(cfg.dtype).split('.')[-1]}"
    for name, ms, plain, lib, nbytes, direction in (
            ("mach_xent_fwd", ms_f, plain_f, lib_f, bytes_f, "forward"),
            ("mach_xent_bwd", ms_b, plain_b, lib_b, bytes_b, "backward")):
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mach_xent.cu",
            "replaces": "src/repro/kernels/mach_xent.py:89",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": lib,
            "shape": f"{direction}, LM head logits {shape3}",
            "library": "F.cross_entropy over the (N·R, B) view, reduction "
                       "none" + (", its backward" if direction == "backward"
                                 else "")})
    del logits, labels, g, g_rep

    d = cfg.resolved_rnn_width
    a = torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5
    x = torch.randn((b, t, d), generator=gen, device=dev)
    h0 = torch.zeros((b, d), device=dev)
    dh = torch.randn((b, t, d), generator=gen, device=dev)
    h = ls.lru_scan_cuda(a, x, h0)
    ms9 = kernel_ms(lambda: ls.lru_scan_bwd_cuda(a, h, h0, dh))
    ms9_graph = graph_ms(lambda: ls.lru_scan_bwd_cuda(a, h, h0, dh))
    ms9_fwd = kernel_ms(lambda: ls.lru_scan_cuda(a, x, h0))
    ms9_fwd_graph = graph_ms(lambda: ls.lru_scan_cuda(a, x, h0))
    plain9 = kernel_ms(lambda: ls.lru_scan_bwd_plain(a, h, h0, dh), iters=2,
                       warmup=1)
    bytes9 = 5 * b * t * d * 4 + 2 * b * d * 4
    rows.append({
        "name": "lru_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lru_scan_bwd.cu",
        "replaces": "src/repro/kernels/lru_scan.py:46",
        "launches": launches["lru_scan_bwd"],
        "max_abs_err": errs["lru_scan_bwd"],
        "ms": ms9, "ms_graph": ms9_graph, "plain_ms": plain9,
        "bound_ms": bytes9 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "shape": f"training (B, T, D)=({b}, {t}, {d}) float32",
        "ms_forward_at_this_shape": ms9_fwd,
        "ms_forward_at_this_shape_graph": ms9_fwd_graph,
        "bound_ms_forward_at_this_shape":
            (3 * b * t * d * 4 + b * d * 4) / HBM_BYTES_PER_S * 1e3,
        "ptxas": _ptxas_registers(_build.build_log("lru_scan_bwd")),
        "timing": "ms by kernel_ms (CUDA events); *_graph by graph_ms "
                  "(CUDA-graph replay, device time)"})
    del a, x, h, dh

    h_, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    window = cfg.local_window
    q, k, v = _flash_inputs(dev, b, t, h_, kv, hd, cfg.dtype, seed=4)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(cfg.dtype)
    out, lse = fa.flash_attention_cuda(q, k, v, window=window, return_lse=True)
    ms10_fwd = kernel_ms(lambda: fa.flash_attention_cuda(
        q, k, v, window=window, return_lse=True), iters=5)
    ms10 = kernel_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, out, dout, lse, window=window), iters=5)
    plain10 = kernel_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, dout, lse, window=window), iters=2, warmup=1)
    pairs = attended_pairs(t, window)
    flops = 10 * hd * h_ * pairs * b
    t_ops = flops / BF16_TOPS_PER_S * 1e3
    t_bytes = (2 * (4 * q.numel() + 2 * k.numel() + 2 * v.numel())
               + 4 * lse.numel()) / HBM_BYTES_PER_S * 1e3
    rows_i = torch.arange(t, device=dev)[:, None]
    cols_i = torch.arange(t, device=dev)[None, :]
    mask = (cols_i <= rows_i) & (cols_i > rows_i - window)
    qh, kh, vh = (z.transpose(1, 2).detach().requires_grad_(True)
                  for z in (q, k.expand(b, t, h_, hd), v.expand(b, t, h_, hd)))
    lib10_fwd = kernel_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), iters=5, warmup=2)
    sdpa = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    do_h = dout.transpose(1, 2)
    lib10 = kernel_ms(lambda: torch.autograd.grad(
        sdpa, (qh, kh, vh), do_h, retain_graph=True), iters=5, warmup=2)
    del sdpa, qh, kh, vh, mask
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": launches["flash_attention_bwd"],
        "max_abs_err": errs["flash_attention_bwd"],
        "ms": ms10, "plain_ms": plain10,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib10,
        "shape": (f"training q ({b}, {t}, {h_}, {hd}), k/v ({b}, {t}, {kv}, "
                  f"{hd}) bfloat16, causal, window {window}: {pairs:,} "
                  f"attended pairs a head, {flops / 1e9:.1f} GFLOP"),
        "library": "F.scaled_dot_product_attention backward, boolean mask, "
                   "k/v expanded to 10 heads",
        "ms_forward_with_lse_at_this_shape": ms10_fwd,
        "library_ms_forward_at_this_shape": lib10_fwd,
        "tflops_per_s": flops / ms10 / 1e9})
    for row in rows:
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        print(f"kernel {row['name']}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {lib}, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), launches "
              f"{row['launches']} on the LM train path; {row['shape']} "
              f"[{smi}]", flush=True)
    bwd = rows[-1]
    print(f"kernel lru_scan forward at ({b}, {t}, {d}): {ms9_fwd:.4f} ms "
          f"(graph {ms9_fwd_graph:.4f}), backward graph {ms9_graph:.4f} ms; "
          f"kernel flash_attention forward with lse at the training shape: "
          f"{ms10_fwd:.4f} ms (SDPA forward {lib10_fwd:.4f} ms); backward "
          f"{bwd['tflops_per_s']:.1f} TFLOP/s of its 10·hd flops a pair "
          f"[{smi}]", flush=True)
    ptxas = next(r["ptxas"] for r in rows if r["name"] == "lru_scan_bwd")
    print(f"kernel lru_scan_bwd ptxas (registers; spills): {ptxas}",
          flush=True)
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


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
    checked, top1_mappings = phase_kernels_vs_plain(dev)
    print(f"kernels vs plain: {checked} comparisons ok in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    cand_checks = phase_candidates_vs_plain(dev)
    print(f"candidate kernels vs plain: {cand_checks['bucket_topm']} bucket_topm "
          f"and {cand_checks['mach_candidate_topk']} mach_candidate_topk "
          f"comparisons ok ({cand_checks['backfill_rows']} backfill rows), max "
          f"abs err {cand_checks['max_abs_err']:.3e}, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rows, odp = phase_main_path(dev)
    rows[0]["checks_by_mapping"] = top1_mappings
    t0 = time.perf_counter()
    rows += phase_candidate_main_path(dev, odp, cand_checks)
    print(f"candidate main path: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del odp

    t0 = time.perf_counter()
    checks = phase_xent_vs_plain(dev)
    print(f"fused xent vs plain: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rows += phase_training(dev, checks)
    dense_launches = next(row["launches"] for row in rows
                          if row["name"] == "mach_fused_xent_dense")
    rows.append(phase_dense_lm_head(dev, checks, dense_launches, smi))

    t0 = time.perf_counter()
    lm_checks = phase_lm_kernels_vs_plain(dev)
    print(f"LM kernels vs plain: {lm_checks['cases']} comparisons ok "
          f"(and {lm_checks['head_cases']} of the LM head's decode) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    lm_rows, lm = phase_lm_serve(dev, lm_checks)
    print(f"lm serve: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    for row in rows:
        if row["name"] in ("mach_decode", "mach_topk"):
            row["launches_lm_serve"] = lm["launches_engine"][row["name"]]
            row["launches_lm_direct_greedy_loop"] = \
                lm["launches_direct_loop"][row["name"]]
            row["max_abs_err_lm_head"] = max(lm_checks["errs"]["lm_head"],
                                             lm["head_err"])
            if row["name"] == "mach_decode":
                row["lm_head"] = lm_checks["lm_head_top1"]
        if row["name"] in ("bucket_topm", "mach_candidate_topk"):
            row["launches_lm_serve_exact"] = \
                lm["candidates"]["exact_launches"][row["name"]]
            row["launches_lm_serve_approx"] = \
                lm["candidates"]["approx_launches"][row["name"]]
    rows += lm_rows

    t0 = time.perf_counter()
    train_checks = phase_lm_train_kernels_vs_plain(dev)
    print(f"LM training kernels vs plain: {train_checks['cases']} comparisons "
          f"ok in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    train_rows, train = phase_lm_train(dev, train_checks)
    print(f"lm train: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    for row in rows:
        if row["name"] in ("lru_scan", "flash_attention"):
            row["launches_lm_train"] = train["launches"][row["name"]]
    rows += train_rows
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
