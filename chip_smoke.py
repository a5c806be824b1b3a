#!/usr/bin/env python3
"""Drive the PyTorch port of MACH serving (Algorithm 2) on one NVIDIA GPU.

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
5. The kernel report (one JSON line), then the device line, last.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import json
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
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
