"""Time the PyTorch port's kernels 1 (top-1 decode, ``mach_decode_cuda``)
and 7 (bucket top-m, ``bucket_topm_cuda``) on the card, each call by two
timers: CUDA-graph replay (device time) and back-to-back CUDA events
(which also hold the Python wrapper's dispatch), as ``chip_smoke.py``
defines them.

The port timed is the ``repro_torch`` under ``--src`` (default: this
checkout's ``src``), so that two checkouts can be held against each
other on one card in one call: unpack the other one with ``git archive``
into a directory that ``.gitignore`` lists and run, for example,

    python3 tools/time_top1_topm.py --src build/parent/src
    python3 tools/time_top1_topm.py
    python3 tools/time_top1_topm.py
    python3 tools/time_top1_topm.py --src build/parent/src

Shapes: kernel 1 at ODP (N=256, R=25, B=32, K=105,033; inline and table
hash); kernel 7 at ODP and ImageNet-21k (N=256; exact and approximate m),
the LM engine's (2048, 8) and (16, 2) at N=4, and the JAX gate's m=12.
``--sweep`` also times kernel 7's select and warp paths against each
other at every B <= 1,024 and m <= 32 (rows of ODP's N·R = 6,400; needs
a port whose ``mach_candidates`` has ``topm_layout``).  Prints one JSON
object as its last line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# (label, N, R, B, m)
TOPM_SHAPES = [("odp exact", 256, 25, 32, 32), ("odp approx", 256, 25, 32, 2),
               ("imagenet21k exact", 256, 20, 512, 512),
               ("imagenet21k approx", 256, 20, 512, 4),
               ("lm exact (2048, 8)", 4, 8, 2048, 2048),
               ("lm approx (16, 2)", 4, 8, 2048, 16),
               ("gate", 8, 16, 8192, 12)]
ODP = {"N": 256, "R": 25, "B": 32, "K": 105033}
SWEEP_B = (4, 8, 16, 32, 64, 128, 256, 512, 1024)
SWEEP_M = (1, 2, 4, 8, 12, 16, 32)


def _two_timers(cs, fn) -> dict:
    return {"graph_ms": cs.graph_ms(fn), "events_ms": cs.kernel_ms(fn)}


def time_top1(cs, md, make_hash_family, dev) -> dict:
    n, r, b, k = ODP["N"], ODP["R"], ODP["B"], ODP["K"]
    meta = cs._inputs(n, r, b, False, seed=1, dev=dev)
    fam = make_hash_family(b, r, seed=0)
    coeffs, shift = fam.coeffs_tensor(dev), fam.shift
    table = md.table_from_inline(coeffs, shift, k)
    out = {}
    for label, kw in (("inline", {"inline_coeffs": coeffs,
                                  "inline_shift": shift}),
                      ("table", {"table": table})):
        fn = (lambda kw=kw: md.mach_decode_cuda(meta, num_classes=k, **kw))
        out[f"odp N=256 {label}"] = _two_timers(cs, fn)
    return out


def time_topm(cs, mc, dev) -> dict:
    out = {}
    for label, n, r, b, m in TOPM_SHAPES:
        meta = cs._inputs(n, r, b, False, seed=b + m, dev=dev)
        row = _two_timers(cs, lambda: mc.bucket_topm_cuda(meta, m))
        lib = _two_timers(cs, lambda: torch.topk(meta, m, dim=-1))
        row["topk_graph_ms"] = lib["graph_ms"]
        row["topk_events_ms"] = lib["events_ms"]
        out[label] = row
    return out


def sweep_topm(cs, mc, dev) -> list[dict]:
    """Select against warp at each (B, m < B, m <= 32): graph_ms of each,
    the paths forced by replacing ``topm_layout`` for the call."""
    from repro_torch.kernels.mach_topk import _next_pow2

    chosen = mc.topm_layout
    out = []
    try:
        for b in SWEEP_B:
            meta = cs._inputs(ODP["N"], ODP["R"], b, False, seed=b, dev=dev)
            for m in SWEEP_M:
                if m >= b:
                    continue
                row = {"B": b, "m": m, "chosen": chosen(b, m).path}
                for path, keys in (("select", _next_pow2(m)),
                                   ("warp", max(1, _next_pow2(b) // 32))):
                    mc.topm_layout = (lambda _b, _m, p=path, k=keys:
                                      mc.TopmLayout(p, k))
                    got = mc.bucket_topm_cuda(meta, m)
                    want = mc.bucket_topm(meta, m)
                    if not all(torch.equal(x, y) for x, y in zip(got, want)):
                        raise SystemExit(f"{path} at B={b} m={m} != plain")
                    row[f"{path}_ms"] = cs.graph_ms(
                        lambda: mc.bucket_topm_cuda(meta, m))
                out.append(row)
    finally:
        mc.topm_layout = chosen
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--sweep", action="store_true",
                    help="also time kernel 7's select and warp paths")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_top1_topm: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.hashing import make_hash_family
    from repro_torch.kernels import mach_candidates as mc
    from repro_torch.kernels import mach_decode as md

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"src": os.path.relpath(Path(args.src).resolve(), ROOT),
              "device": cs._nvidia_smi(),
              "mach_decode": time_top1(cs, md, make_hash_family, dev),
              "bucket_topm": time_topm(cs, mc, dev)}
    if args.sweep:
        result["topm_sweep"] = sweep_topm(cs, mc, dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
