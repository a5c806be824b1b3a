"""Time the PyTorch port's kernels 6 (the gather fused xent,
``gather_fwd_cuda`` / ``gather_bwd_cuda``) and 9 (the RG-LRU scan,
``lru_scan_cuda`` / ``lru_scan_bwd_cuda``) on the card, each call by two
timers: CUDA-graph replay (device time) and back-to-back CUDA events
(which also hold the Python wrapper's dispatch), as ``chip_smoke.py``
defines them.

The port timed is the ``repro_torch`` under ``--src`` (default: this
checkout's ``src``), so that two checkouts can be held against each
other on one card in one call: unpack the other one with ``git archive``
into a directory that ``.gitignore`` lists and run, for example,

    python3 tools/time_xent_scan.py --src build/parent/src
    python3 tools/time_xent_scan.py
    python3 tools/time_xent_scan.py
    python3 tools/time_xent_scan.py --src build/parent/src

Shapes: kernel 9 forward at the 4,096-token prefill (1, 4096, 2560),
training's (2, 4096, 2560) and a decode step (4, 1, 2560), its backward
at (2, 4096, 2560), all float32 as the model calls them; kernel 6 on
ODP's training batch at nnz = 1,024 (N = 512, d = 422,713, R = 25,
B = 32; the first batch of ``chip_smoke.py``'s ODP bag-of-words run),
forward and backward, with the backward's peak memory and, once, its
library yardstick (``torch.sparse.mm`` + ``F.cross_entropy``, forward
and backward).  ``--profile`` adds the device time of each kernel of
kernel 6's backward and of the scan's calls, by name, from
``torch.profiler`` over three calls each.  ``--only decode`` times the
decode path's host side instead: one ``lru_scan_cuda`` call at the
decode shape (4, 1, 2560) by both timers and by the host clock, and the
model's pooled ``decode_step`` of recurrentgemma-2b at full width (4
slots, random weights) as ``chip_smoke.py`` times it; run it alternately
on two checkouts, for example

    python3 tools/time_xent_scan.py --only decode --src build/parent/src
    python3 tools/time_xent_scan.py --only decode

Prints one JSON object as its last line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# (label, B, T, D) of kernel 9's forward calls; its backward's shape
SCAN_FWD = [("prefill", 1, 4096, 2560), ("training", 2, 4096, 2560),
            ("decode", 4, 1, 2560)]
SCAN_BWD = ("training", 2, 4096, 2560)
N_TRAIN = 512


def _two_timers(cs, fn) -> dict:
    return {"graph_ms": cs.graph_ms(fn), "events_ms": cs.kernel_ms(fn)}


def device_times(fn, calls: int = 3) -> dict:
    """Device ms a call of each kernel (and copy or fill) that ``fn``
    launches, by name, from torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if us > 0:
            out[evt.key[:120]] = us / 1e3 / calls
    return out


def time_scan(cs, ls, dev, profile_calls: bool) -> dict:
    out = {}
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, b, t, d in SCAN_FWD:
        a = torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5
        x = torch.randn((b, t, d), generator=gen, device=dev)
        h0 = torch.zeros((b, d), device=dev)
        fn = lambda: ls.lru_scan_cuda(a, x, h0)
        out[f"forward {label} {(b, t, d)}"] = _two_timers(cs, fn)
        if profile_calls:
            out[f"forward {label} {(b, t, d)}"]["kernels"] = device_times(fn)
    label, b, t, d = SCAN_BWD
    a = torch.rand((b, t, d), generator=gen, device=dev) * 0.5 + 0.5
    x = torch.randn((b, t, d), generator=gen, device=dev)
    h0 = torch.zeros((b, d), device=dev)
    dh = torch.randn((b, t, d), generator=gen, device=dev)
    h = ls.lru_scan_cuda(a, x, h0)
    fn = lambda: ls.lru_scan_bwd_cuda(a, h, h0, dh)
    out[f"backward {label} {(b, t, d)}"] = _two_timers(cs, fn)
    if profile_calls:
        out[f"backward {label} {(b, t, d)}"]["kernels"] = device_times(fn)
    return out


def host_us(fn, calls: int = 200, batches: int = 9) -> list:
    """Host µs a call of ``fn``, for each of ``batches`` batches of
    ``calls`` back-to-back calls, each timed by the host clock up to its
    last return, with the card idle before it."""
    out = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return out


def time_decode(cs, ls, dev) -> dict:
    """The decode path's host side: the host time (``host_us``, median
    of the batches) of one decode-shape ``lru_scan_cuda`` call and of its
    parts — the C launch function called directly through ctypes, the
    wrapper's layout lookup where it has one, and an empty ctypes call
    into the same library — both timers of the call, and the model's
    pooled ``decode_step`` (median of 21 after 3 warm-ups, each ending in
    a synchronize)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import LanguageModel

    cfg = get_config("recurrentgemma-2b")
    b, d = cs.LM_SLOTS, cfg.resolved_rnn_width
    gen = torch.Generator(device=dev).manual_seed(1)
    a = torch.rand((b, 1, d), generator=gen, device=dev) * 0.5 + 0.5
    x = torch.randn((b, 1, d), generator=gen, device=dev)
    h0 = torch.zeros((b, d), device=dev)
    fn = lambda: ls.lru_scan_cuda(a, x, h0)
    out = {f"forward decode {(b, 1, d)}": _two_timers(cs, fn)}
    lib = _build.load("lru_scan")
    res = torch.empty_like(x)
    bits = a.data_ptr() | x.data_ptr() | res.data_ptr()
    layout = (lambda: ls._layout(x.shape, x.dtype, False, bits, dev)) \
        if hasattr(ls, "_layout") else None
    launch_args = (a.data_ptr(), x.data_ptr(), h0.data_ptr(), res.data_ptr(),
                   b, 1, d, 0, *(layout() if layout else ()),
                   torch.cuda.current_stream(dev).cuda_stream)
    parts = {"wrapper": fn,
             "c_launch": lambda: lib.lru_scan_launch(*launch_args),
             "empty_ctypes_call": lambda: lib.mach_error_string(0)}
    if layout:
        parts["layout_lookup"] = layout
    for name, part in parts.items():
        batches = host_us(part)
        out[f"host_us_{name}"] = statistics.median(batches)
        out[f"host_us_{name}_batches"] = batches
    model = LanguageModel(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    pool = model.init_caches(cs.LM_SLOTS, cs.LM_MAX_LEN, device=dev)
    last = torch.zeros((cs.LM_SLOTS,), dtype=torch.int64, device=dev)
    pos = torch.full((cs.LM_SLOTS,), 100, dtype=torch.int64, device=dev)
    before = ls.lru_scan_cuda.launches
    out["decode_step_ms"] = cs.wall_ms(
        lambda: model.decode_step(params, pool, last, pos, per_slot=True),
        runs=21, warmup=3)
    out["decode_step_lru_scan_launches"] = (ls.lru_scan_cuda.launches
                                            - before) // 24
    return out


def time_gather(cs, dev, library: bool, profile_calls: bool) -> dict:
    from repro_torch.configs.odp_mach import ODP
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import SparseExtremeDataset
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import ops

    head = MACHLinear(ODP.mach(), ODP.dim, fused=True)
    params = head.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    data = SparseExtremeDataset(
        dataclasses.replace(ODP.sparse_data(small=False), nnz=1024),
        device=dev)
    x, y = data.batch_at(0, N_TRAIN)
    c = head.cfg
    n, r, b, d = N_TRAIN, c.num_repetitions, c.num_buckets, head.dim
    w2 = params["w"].reshape(d, -1)
    bias = params["b"].reshape(-1)
    labels = c.hash_labels(y).movedim(0, -1).to(torch.int32).contiguous()
    g = torch.full((n,), 1.0 / n, device=dev)
    cols, vals = ops.csr_to_ell(x.indptr, x.indices, x.values, x.nnz_max, d)
    _, lse = mfx.gather_fwd_cuda(cols, vals, w2, bias, labels, b)
    fwd = lambda: mfx.gather_fwd_cuda(cols, vals, w2, bias, labels, b)
    bwd = lambda: mfx.gather_bwd_cuda(cols, vals, w2, bias, labels, lse, g, b)
    out = {"forward": _two_timers(cs, fwd), "backward": _two_timers(cs, bwd)}
    if profile_calls:
        out["backward"]["kernels"] = device_times(bwd)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    dw, _ = bwd()
    torch.cuda.synchronize()
    out["backward_peak_mib_above_inputs"] = (
        torch.cuda.max_memory_allocated(dev) - base) / 2**20
    second, _ = bwd()
    out["backward_dw_run_to_run_max_diff"] = float((dw - second).abs().max())
    del dw, second
    valid = (cols >= 0) & (cols < d)
    out["valid_slots"] = int(valid.sum())
    out["distinct_features"] = int(torch.unique(cols[valid]).numel())
    if library:
        leaves = [w2.detach().requires_grad_(True),
                  bias.detach().requires_grad_(True)]
        out["library_ms"] = cs.kernel_ms(lambda: cs._library_xent(
            "gather", x, *leaves, labels, b, n, r, d), iters=5, warmup=1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--library", action="store_true",
                    help="also time kernel 6's library yardstick")
    ap.add_argument("--profile", action="store_true",
                    help="also give each launched kernel's device time")
    ap.add_argument("--only", choices=("scan", "gather", "decode"),
                    help="time only kernel 9 (scan), kernel 6 (gather) or "
                         "the decode path's host side (decode)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_xent_scan: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import lru_scan as ls

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in (("lru_scan",) if args.only == "decode" else
                 ("lru_scan", "lru_scan_bwd", "mach_fused_xent_gather")):
        _build.load(name)
    result = {"src": os.path.relpath(Path(args.src).resolve(), ROOT),
              "device": cs._nvidia_smi()}
    if args.only == "decode":
        result["decode"] = time_decode(cs, ls, dev)
    elif args.only != "gather":
        result["lru_scan"] = time_scan(cs, ls, dev, args.profile)
    if args.only in (None, "gather"):
        result["mach_fused_xent_gather"] = time_gather(cs, dev, args.library,
                                                       args.profile)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
