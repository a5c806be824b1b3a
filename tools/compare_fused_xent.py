"""Save, or hold against a saved file, the outputs of the port's fused
xent kernels 4 and 6 on fixed seeded inputs, to show that a change to
their shared sources left them the same bits.

Kernel 6 (the gather family, ``gather_fwd_cuda`` / ``gather_bwd_cuda``):
loss, lse, dW and dbias on ODP's first training batch at nnz = 1,024
(N = 512, d = 422,713, R = 25, B = 32) and on a batch with heavy dW rows
(N = 37, d = 5,000, J = 1,024); its backward has no float atomics, so
its bits are the same from run to run.  Kernel 4 (``dense_fwd_cuda``):
loss and lse at (N, d, R, B) = (70, 200, 25, 32); its backward sums by
float atomics and is left out.

The port is the ``repro_torch`` under ``--src``.  Run one checkout with
``--save FILE``, then the other with ``--against FILE``, one after the
other on the same card (``build/parent`` a ``git archive`` of the other
commit):

    python3 tools/compare_fused_xent.py --src build/parent/src --save build/k46.pt
    python3 tools/compare_fused_xent.py --against build/k46.pt

Prints one JSON object as its last line; with ``--against`` it exits 1
unless every tensor has the same bits.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def outputs(dev) -> dict:
    from repro_torch.configs.odp_mach import ODP
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import SparseExtremeDataset
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import ops

    out = {}
    head = MACHLinear(ODP.mach(), ODP.dim, fused=True)
    params = head.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    data = SparseExtremeDataset(dataclasses.replace(
        ODP.sparse_data(small=False), nnz=1024), device=dev)
    x, y = data.batch_at(0, 512)
    c = head.cfg
    w = params["w"].reshape(head.dim, -1)
    bias = params["b"].reshape(-1)
    labels = c.hash_labels(y).movedim(0, -1).to(torch.int32).contiguous()
    cols, vals = ops.csr_to_ell(x.indptr, x.indices, x.values, x.nnz_max,
                                head.dim)
    g = torch.full((512,), 1.0 / 512, device=dev)
    cases = {"odp nnz=1024": (cols, vals, w, bias, labels, c.num_buckets, g)}
    gen = torch.Generator(device=dev).manual_seed(5)
    n, d, r, b, j = 37, 5000, 25, 32, 1024
    hc = torch.randint(0, d, (n, j), generator=gen, device=dev,
                       dtype=torch.int32)
    hc = torch.where(torch.rand((n, j), generator=gen, device=dev) < 1 / 3, 7,
                     hc).to(torch.int32)
    cases["heavy"] = (
        hc, torch.rand((n, j), generator=gen, device=dev),
        torch.randn((d, r * b), generator=gen, device=dev) / d ** 0.5,
        torch.randn((r * b,), generator=gen, device=dev),
        torch.randint(0, b, (n, r), generator=gen, device=dev,
                      dtype=torch.int32), b,
        torch.rand((n,), generator=gen, device=dev) + 0.5)
    for name, (cc, vv, ww, bb, yy, nb, gg) in cases.items():
        loss, lse = mfx.gather_fwd_cuda(cc, vv, ww, bb, yy, nb)
        dw, db = mfx.gather_bwd_cuda(cc, vv, ww, bb, yy, lse, gg, nb)
        out.update({f"k6 {name} loss": loss, f"k6 {name} lse": lse,
                    f"k6 {name} dW": dw, f"k6 {name} dbias": db})
    h = torch.randn((70, 200), generator=gen, device=dev)
    wd = torch.randn((200, 800), generator=gen, device=dev) / 200 ** 0.5
    bd = 0.1 * torch.randn((800,), generator=gen, device=dev)
    yd = torch.randint(0, 32, (70, 25), generator=gen, device=dev,
                       dtype=torch.int32)
    loss, lse = mfx.dense_fwd_cuda(h, wd, bd, yd, 32)
    out.update({"k4 loss": loss, "k4 lse": lse})
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch runs")
    ap.add_argument("--save", help="write the outputs to this file")
    ap.add_argument("--against", help="hold the outputs against this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_fused_xent: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    got = outputs(torch.device("cuda", 0))
    result = {"tensors": len(got)}
    if args.save:
        torch.save(got, args.save)
    if args.against:
        want = torch.load(args.against)
        differ = [k for k in want if not torch.equal(
            got[k].view(torch.int32), want[k].view(torch.int32))]
        result["differ"] = differ
        print(json.dumps(result))
        return 1 if differ else 0
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
