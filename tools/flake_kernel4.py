"""Kernel 4's float32 card test at B' = c_sel over many draws of its input.

``tests/test_torch_cuda.py::test_selected_dense_kernel_equals_plain``
draws its features ``h`` from the global CUDA generator, so the ``h`` a
run sees depends on the tests that ran before it in the process.  This
runs that test itself once for each of ``--draws`` seeds of the
generator and, on the same inputs, measures:

* the kernel's largest excess over a tolerance against its plain
  version in float64, max(|a - c| - (atol + rtol·|c|)) over each output
  (loss, dh, dW, dbias), for the flat atol of 1e-6 the test had and for
  the test's ``f32_grad_atol`` (scaled by each gradient's largest
  entry): the test fails where it is above 0;
* the kernel's run-to-run difference (two runs on the same inputs; its
  dW, dh and dbias are summed with float atomics), as the largest
  |a1 - a2| and as the same excess with a2 in place of c;
* the plain version run in float32 on the card (cuBLAS, TF32 off)
  against float64 under the flat atol: how often plain float32
  arithmetic itself is outside it.

Prints one line a draw that fails and a JSON summary, last.  Needs the
card.

    PYTHONPATH=src python tools/flake_kernel4.py [--draws 200]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import test_torch_cuda as tc  # noqa: E402
from repro_torch.kernels import mach_fused_xent as mfx  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CASE = (70, 200, 25, 32, 8)          # n, d, r, b, c_sel: the flaky case
TOL = {"loss": (1e-5, 1e-6), "dh": (1e-4, 1e-6), "dW": (1e-4, 1e-6),
       "dbias": (1e-4, 1e-6)}        # (rtol, atol), the test's flat atol


def _inputs(dev, seed):
    n, d, r, b, c_sel = CASE
    torch.manual_seed(seed)
    w, bb, y, g, selected = tc._selected_case(dev, n, d, r, b, c_sel, seed=n)
    h = torch.randn((n, d), device=dev)      # the test's draw, in its order
    return h, w, bb, y, g, selected


def _kernel(h, w, bb, y, g, selected):
    leaves = [t.detach().clone().requires_grad_(True) for t in (h, w, bb)]
    loss = ops.mach_fused_xent_selected(*leaves[:2], y, selected,
                                        num_buckets=CASE[3], bias=leaves[2])
    grads = torch.autograd.grad((loss * g).sum(), leaves)
    return dict(zip(TOL, (loss.detach(), *grads)))


def _plain(h, w, bb, y, g, selected, dtype=torch.float64):
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in (h, w, bb)]
    wsel, bsel, pos = ops._apply_bucket_selection(leaves[1], leaves[2], y,
                                                  selected, CASE[3])
    loss, _ = mfx.fused_xent_dense_plain(leaves[0], wsel, bsel, pos, CASE[4])
    grads = torch.autograd.grad((loss * g.to(dtype)).sum(), leaves)
    return dict(zip(TOL, (loss.detach(), *grads)))


def _excess(got, want, rtol, atol) -> tuple[float, float, float]:
    """(largest excess, |want| there, |got - want| there)."""
    diff = (got.double() - want.double()).abs()
    ex = diff - (atol + rtol * want.double().abs())
    i = int(ex.argmax())
    return (float(ex.flatten()[i]), float(want.double().abs().flatten()[i]),
            float(diff.flatten()[i]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flake_kernel4: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    failed = []
    worst = {k: (-1e30, 0.0, 0.0, -1) for k in TOL}
    worst_scaled = {k: -1e30 for k in TOL}
    spread = {k: (0.0, -1e30) for k in TOL}
    over = {k: 0 for k in TOL}
    over_scaled = {k: 0 for k in TOL}
    over_f32 = {k: 0 for k in TOL}
    worst_f32 = {k: 0.0 for k in TOL}
    for seed in range(args.draws):
        torch.manual_seed(seed)
        try:
            tc.test_selected_dense_kernel_equals_plain(dev, *CASE,
                                                       torch.float32)
        except AssertionError as exc:
            msg = " ".join(str(exc).split())[:400]
            failed.append({"seed": seed, "message": msg})
            print(f"draw {seed}: the test failed: {msg}", flush=True)
        inputs = _inputs(dev, seed)
        a1, a2 = _kernel(*inputs), _kernel(*inputs)
        want = _plain(*inputs)
        f32 = _plain(*inputs, dtype=torch.float32)
        for k, (rtol, atol) in TOL.items():
            ex, _, diff = _excess(f32[k], want[k], rtol, atol)
            over_f32[k] += ex > 0
            worst_f32[k] = max(worst_f32[k],
                               float((f32[k].double() - want[k]).abs().max()))
            ex, mag, diff = _excess(a1[k], want[k], rtol, atol)
            if ex > 0:
                over[k] += 1
            if ex > worst[k][0]:
                worst[k] = (ex, mag, diff, seed)
            if k != "loss":
                ex = _excess(a1[k], want[k], rtol,
                             tc.f32_grad_atol(want[k]))[0]
                over_scaled[k] += ex > 0
                worst_scaled[k] = max(worst_scaled[k], ex)
            rr = float((a1[k] - a2[k]).abs().max())
            rr_ex = _excess(a1[k], a2[k], rtol, atol)[0]
            spread[k] = (max(spread[k][0], rr), max(spread[k][1], rr_ex))
    print(json.dumps({
        "card": smi, "case": dict(zip(("n", "d", "r", "b", "c_sel"), CASE)),
        "draws": args.draws, "test_failures": failed,
        "draws_over_flat_atol": over,
        "draws_over_scaled_atol": over_scaled,
        "worst_excess_scaled_atol": worst_scaled,
        "plain_float32_draws_over_flat_atol": over_f32,
        "plain_float32_max_abs_err": worst_f32,
        "worst_excess": {k: dict(zip(("excess", "abs_want", "abs_err",
                                      "seed"), v)) for k, v in worst.items()},
        "run_to_run": {k: {"max_abs_diff": v[0], "max_excess": v[1]}
                       for k, v in spread.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
