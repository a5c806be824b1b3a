"""Time the PyTorch port's kernels 8 (candidate filter,
``mach_candidate_topk_cuda``) and 2 (streaming top-k, ``mach_topk_cuda``)
on the card, each call by two timers: CUDA-graph replay (device time) and
back-to-back CUDA events (which also hold the Python wrapper's dispatch),
as ``chip_smoke.py`` defines them.

The port timed is the ``repro_torch`` under ``--src`` (default: this
checkout's ``src``), so that two checkouts can be held against each
other on one card in one call: unpack the other one with ``git archive``
into a directory that ``.gitignore`` lists and run, for example,

    python3 tools/time_topk_cand.py --src build/parent/src
    python3 tools/time_topk_cand.py
    python3 tools/time_topk_cand.py
    python3 tools/time_topk_cand.py --src build/parent/src

Shapes (probabilities: softmax of N(0, 1) logits, seeded; the gate's
carry a planted signal, as ``chip_smoke.py``'s): kernel 8 at ODP (N=256,
R=25, B=32, K=105,033) and ImageNet-21k (N=256, R=20, B=512, K=21,841),
exact (m, t) = (B, R) and approximate ((2, 1) and (4, 1)), table and
inline hash, k=10, unbiased (and at ODP the median, table hash, t >= 2);
the LM engine's (2048, 8) and (16, 2) at N=4 (R=8,
B=2,048, K=256,000, inline hash, k=50); the JAX gate (N=8, R=16, B=8,192,
K=1,048,576, m=12, inline hash, k=10).  Kernel 2 at ODP (N=256, k=10)
with both hashes and the three estimators, and at the LM head (N=1 and
4, k=50, inline hash, unbiased).  ``--only k8`` or ``--only k2`` times
one kernel.  Prints one JSON object as its last line.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

ESTIMATORS = ("unbiased", "min", "median")
# (label, N, R, B, K, m, t, k, hash modes)
CAND = [("odp exact", 256, 25, 32, 105033, 32, 25, 10, ("table", "inline")),
        ("odp approx (2, 1)", 256, 25, 32, 105033, 2, 1, 10,
         ("table", "inline")),
        ("imagenet21k exact", 256, 20, 512, 21841, 512, 20, 10,
         ("table", "inline")),
        ("imagenet21k approx (4, 1)", 256, 20, 512, 21841, 4, 1, 10,
         ("table", "inline")),
        ("lm exact (2048, 8)", 4, 8, 2048, 256000, 2048, 8, 50, ("inline",)),
        ("lm approx (16, 2)", 4, 8, 2048, 256000, 16, 2, 50, ("inline",)),
        ("gate", 8, 16, 8192, 1048576, 12, 1, 10, ("inline",))]
ODP = (256, 25, 32, 105033)
LM_HEAD = (8, 2048, 256000)


def _two_timers(cs, fn) -> dict:
    return {"graph_ms": cs.graph_ms(fn), "events_ms": cs.kernel_ms(fn)}


def _hashes(fam, num_classes, dev) -> dict:
    return {"table": {"table": fam.table(num_classes, dev)},
            "inline": {"inline_coeffs": fam.coeffs_tensor(dev),
                       "inline_shift": fam.shift}}


def time_candidates(cs, mc, make_hash_family, inverted_table, dev) -> dict:
    out = {}
    families = {}
    for label, n, r, b, num_classes, m, t, k, modes in CAND:
        key = (r, b, num_classes)
        if key not in families:
            fam = make_hash_family(b, r, seed=0)
            families[key] = (fam, _hashes(fam, num_classes, dev),
                             inverted_table(fam.table_np(num_classes), b,
                                            device=dev))
        fam, hashes, inv = families[key]
        if label == "gate":
            meta = cs._planted_probs(dev, n, r, b, fam.coeffs_tensor(dev),
                                     fam.shift, num_classes, seed=7)
        else:
            meta = cs._inputs(n, r, b, False, seed=b + m, dev=dev)
        tau, ids = mc.bucket_topm(meta, m)
        for mode in modes:
            fn = (lambda kw=hashes[mode]: mc.mach_candidate_topk_cuda(
                meta, tau, ids, inv, num_classes=num_classes, k=k, t=t,
                estimator="unbiased", **kw))
            out[f"{label} {mode}"] = _two_timers(cs, fn)
        if label.startswith("odp"):
            fn = (lambda: mc.mach_candidate_topk_cuda(
                meta, tau, ids, inv, num_classes=num_classes, k=k,
                t=max(t, 2), estimator="median", **hashes["table"]))
            out[f"{label} table median"] = _two_timers(cs, fn)
    return out


def time_topk(cs, mt, make_hash_family, dev) -> dict:
    out = {}
    n, r, b, num_classes = ODP
    fam = make_hash_family(b, r, seed=0)
    meta = cs._inputs(n, r, b, False, seed=1, dev=dev)
    for mode, kw in _hashes(fam, num_classes, dev).items():
        for est in ESTIMATORS:
            fn = (lambda kw=kw, est=est: mt.mach_topk_cuda(
                meta, num_classes=num_classes, k=10, estimator=est, **kw))
            out[f"odp N=256 k=10 {mode} {est}"] = _two_timers(cs, fn)
    r, b, num_classes = LM_HEAD
    fam = make_hash_family(b, r, seed=0)
    kw = _hashes(fam, num_classes, dev)["inline"]
    for n in (1, 4):
        meta = cs._inputs(n, r, b, False, seed=n, dev=dev)
        fn = (lambda meta=meta: mt.mach_topk_cuda(
            meta, num_classes=num_classes, k=50, **kw))
        out[f"lm head N={n} k=50 inline unbiased"] = _two_timers(cs, fn)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--only", choices=("k8", "k2"),
                    help="time only kernel 8 or only kernel 2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_topk_cand: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.hashing import inverted_table, make_hash_family
    from repro_torch.kernels import mach_candidates as mc
    from repro_torch.kernels import mach_topk as mt

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"src": os.path.relpath(Path(args.src).resolve(), ROOT),
              "device": cs._nvidia_smi()}
    if args.only in (None, "k8"):
        result["mach_candidate_topk"] = time_candidates(
            cs, mc, make_hash_family, inverted_table, dev)
    if args.only in (None, "k2"):
        result["mach_topk"] = time_topk(cs, mt, make_hash_family, dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
