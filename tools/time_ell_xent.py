"""Check and time the PyTorch port's kernel 5 (the ELL fused xent,
``ell_fwd_cuda`` / ``ell_bwd_cuda``) on the card at the three shapes its
main paths give it, each beside its bound, its plain version and its
library yardstick (``torch.sparse.mm`` on the CSR batch, then
``F.cross_entropy`` over the (N·R, B) view, forward and backward), as
``chip_smoke.py`` defines them:

* ODP training at nnz = 120 (N = 512, d = 422,713, R = 25, B = 32; the
  first batch of ``chip_smoke.py``'s ODP run);
* the 500k-label workload at B' = 512 of B = 4,096 (N = 512, d = 1,024,
  R = 8, nnz_max = 64; the inputs of ``chip_smoke.py``'s phase 11 check
  at (R, c_sel) = (8, 512)), over the selected columns;
* the same inputs at B = 4,096 (selection off);
* the batch phase 11 trains (``SparseExtremeDataset`` at nnz = 64 with
  16 signature features: every row 64 slots, background features Zipf,
  so a few features carry thousands of pairs), labels hashed by the
  head, at B' = 512 over the columns the head's proxy selects and at B.

At each: forward and backward ms by back-to-back CUDA events and by
CUDA-graph replay, kernel == plain (loss and lse at rtol 1e-5, dW and
dbias at rtol 1e-4 / atol 1e-6; failures printed, not raised), the
largest difference between two backward runs' dW and dbias, and the
batch's valid slots, distinct features and most pairs of one feature.
``--profile`` adds each launched kernel's device time by name
(``torch.profiler``).  ``--steps`` times instead, by CUDA-graph replay,
each step of the four 500k-label cases (the forward; the backward's
dlogits launch, its column order and its dW launch), the dW also by
kernel 6's row launch (``gather_dw_cuda``, dbias not included) on the
same order and dlogits; and, by CUDA events around calls, the trained
batch's loss forward and backward through ``ops.mach_fused_xent_csr``
with the selection on and off and the selection's own pieces.

The port timed is the ``repro_torch`` under ``--src`` (default: this
checkout's ``src``), so two checkouts can be held against each other on
one card, one after the other: unpack the other with ``git archive`` into
a directory that ``.gitignore`` lists and run, in turns,

    python3 tools/time_ell_xent.py --src build/parent/src
    python3 tools/time_ell_xent.py
    python3 tools/time_ell_xent.py
    python3 tools/time_ell_xent.py --src build/parent/src

Prints one JSON object as its last line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
N_TRAIN = 512


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


def odp_case(cs, dev) -> dict:
    from repro_torch.configs.odp_mach import ODP
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import SparseExtremeDataset

    head = MACHLinear(ODP.mach(), ODP.dim, fused=True)
    params = head.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    data = SparseExtremeDataset(ODP.sparse_data(small=False), device=dev)
    x, y = data.batch_at(0, N_TRAIN)
    c = head.cfg
    labels = c.hash_labels(y).movedim(0, -1).to(torch.int32).contiguous()
    return {"label": "odp nnz=120", "x": x, "nnz_max": x.nnz_max,
            "w": params["w"].reshape(head.dim, -1).detach(),
            "bias": params["b"].reshape(-1).detach(), "labels": labels,
            "b": c.num_buckets, "g": torch.full((N_TRAIN,), 1.0 / N_TRAIN,
                                                 device=dev)}


def select_cases(cs, dev) -> list:
    """Phase 11's check inputs at (R, c_sel) = (8, 512), drawn in its
    order: at B' over the gathered columns, and at B."""
    from repro_torch.kernels import ops

    p = cs.SELECT
    n, d, b, r, c_sel = p["N"], p["d"], p["B"], p["R"], p["c_sel"]
    gen = torch.Generator(device=dev).manual_seed(r * c_sel)
    proxy = torch.randn((r, b), generator=gen, device=dev)
    y = torch.randint(0, b, (n, r), generator=gen, device=dev,
                      dtype=torch.int32)
    selected = ops.mach_select_buckets(proxy, y, num_buckets=b, c_sel=c_sel)
    g = torch.rand((n,), generator=gen, device=dev) + 0.5
    w = torch.randn((d, r * b), generator=gen, device=dev)
    bias = torch.randn((r * b,), generator=gen, device=dev)
    x = cs._csr_check_batch(dev, n, d, 64, seed=64 + c_sel)
    wsel, bsel, pos = ops._apply_bucket_selection(w, bias, y, selected, b)
    return [{"label": f"500k B'={c_sel}", "x": x, "nnz_max": 64,
             "w": wsel.detach().contiguous(), "bias": bsel.detach(),
             "labels": pos, "b": c_sel, "g": g},
            {"label": f"500k B={b}", "x": x, "nnz_max": 64, "w": w,
             "bias": bias, "labels": y, "b": b, "g": g}]


def trained_cases(cs, dev) -> list:
    """The first batch phase 11 trains at nnz = 64 and the head it trains
    (seed 5), at B' = c_sel over the columns its proxy selects, and at B;
    g the trainer's mean."""
    from repro_torch.core.mach import MACHConfig, MACHLinear
    from repro_torch.data.extreme import (SparseExtremeDataConfig,
                                          SparseExtremeDataset)
    from repro_torch.kernels import ops

    p = cs.SELECT
    n, b, c_sel = p["N"], p["B"], p["c_sel"]
    head = MACHLinear(MACHConfig(p["K"], b, p["R"]), p["d"], fused=True)
    params = head.init(torch.Generator(device=dev).manual_seed(5), device=dev)
    data = SparseExtremeDataset(SparseExtremeDataConfig(
        num_classes=p["K"], num_features=p["d"], nnz=64, sig_features=16),
        device=dev)
    x, y = data.batch_at(0, n, format="csr")
    labels = head.cfg.hash_labels(y).movedim(0, -1).to(torch.int32)
    labels = labels.contiguous()
    w = params["w"].reshape(p["d"], -1).detach()
    bias = params["b"].reshape(-1).detach()
    proxy = head.bucket_proxy_scores(params, x)
    selected = ops.mach_select_buckets(proxy, labels, num_buckets=b,
                                       c_sel=c_sel)
    wsel, bsel, pos = ops._apply_bucket_selection(w, bias, labels, selected,
                                                  b)
    g = torch.full((n,), 1.0 / n, device=dev)
    common = {"x": x, "nnz_max": x.nnz_max, "g": g, "proxy": proxy,
              "w_full": w, "bias_full": bias, "labels_full": labels}
    return [{"label": f"500k trained B'={c_sel}", "w": wsel.contiguous(),
             "bias": bsel, "labels": pos, "b": c_sel, **common},
            {"label": f"500k trained B={b}", "w": w, "bias": bias,
             "labels": labels, "b": b, **common}]


def _most_pairs(cols, d) -> int:
    valid = (cols >= 0) & (cols < d)
    return int(torch.bincount(cols[valid].long(), minlength=d).max())


def _grads(fn, leaves, g):
    loss, lse = fn()
    grads = torch.autograd.grad((loss * g).sum(), leaves)
    torch.cuda.synchronize()
    return loss.detach(), lse, [t.detach() for t in grads]


def run_case(cs, case, dev, profile_calls: bool) -> dict:
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import ops

    x, w, bias, labels, b, g = (case[k] for k in
                                ("x", "w", "bias", "labels", "b", "g"))
    n, d, r = labels.shape[0], w.shape[0], labels.shape[1]
    cols, vals = ops.csr_to_ell(x.indptr, x.indices, x.values,
                                case["nnz_max"], d)
    valid = (cols >= 0) & (cols < d)
    nnz, unique = int(valid.sum()), int(torch.unique(cols[valid]).numel())
    out = {"shape": f"N={n} d={d} R={r} B={b} J={cols.shape[1]}",
           "valid_slots": nnz, "distinct_features": unique,
           "most_pairs_a_feature": _most_pairs(cols, d)}
    fwd = lambda: mfx.ell_fwd_cuda(cols, vals, w, bias, labels, b)
    _, lse = fwd()
    bwd = lambda: mfx.ell_bwd_cuda(cols, vals, w, bias, labels, lse, g, b)
    for key, fn in (("fwd", fwd), ("bwd", bwd)):
        out[f"ms_{key}"] = cs.kernel_ms(fn, iters=10)
        out[f"ms_{key}_graph"] = cs.graph_ms(fn, iters=10)
    out["ms"] = out["ms_fwd"] + out["ms_bwd"]
    (bf, byf), (bb, byb) = cs._bound("ell", n, d, r, b, nnz, unique,
                                     cols.shape[1])
    out.update(bound_ms_fwd=bf, bound_by_fwd=byf, bound_ms_bwd=bb,
               bound_by_bwd=byb, bound_ms=bf + bb)
    first, second = bwd(), bwd()
    out["run_to_run_max_diff"] = max(float((p - q).abs().max())
                                     for p, q in zip(first, second))
    del first, second
    leaves = [w.clone().requires_grad_(True), bias.clone().requires_grad_(True)]
    plain = lambda: mfx.fused_xent_ell_plain(cols, vals, *leaves, labels, b)
    kern = lambda: mfx.mach_fused_xent_ell(cols, vals, *leaves, labels, b)
    got, want = _grads(kern, leaves, g), _grads(plain, leaves, g)
    fails, err = [], 0.0
    for name, a, e, tol in (("loss", got[0], want[0], cs.LOSS_TOL),
                            ("lse", got[1], want[1], cs.LOSS_TOL),
                            ("dW", got[2][0], want[2][0], cs.GRAD_TOL),
                            ("dbias", got[2][1], want[2][1], cs.GRAD_TOL)):
        err = max(err, float((a - e).abs().max()))
        if not torch.allclose(a, e, **tol):
            fails.append(name)
    out.update(max_abs_err=err, differs_from_plain=fails)
    del got, want
    out["plain_ms"] = cs.kernel_ms(lambda: _grads(plain, leaves, g), iters=3,
                                   warmup=1)
    out["library_ms"] = cs.kernel_ms(lambda: cs._library_xent(
        "ell", x, *leaves, labels, b, n, r, d), iters=3, warmup=1)
    if profile_calls:
        out["fwd_kernels"] = device_times(fwd)
        out["bwd_kernels"] = device_times(bwd)
    print(f"{case['label']}: {json.dumps(out)}", flush=True)
    return out


def step_times(cs, dev) -> dict:
    """``--steps``: graph ms of each step at the 500k-label cases (the
    check batch and the trained one), the dW by both launches."""
    from repro_torch.kernels import mach_fused_xent as mfx
    from repro_torch.kernels import ops

    out = {}
    for case in select_cases(cs, dev) + trained_cases(cs, dev):
        x, w, bias, labels, b, g = (case[k] for k in
                                    ("x", "w", "bias", "labels", "b", "g"))
        d = w.shape[0]
        cols, vals = ops.csr_to_ell(x.indptr, x.indices, x.values,
                                    case["nnz_max"], d)
        fwd = lambda: mfx.ell_fwd_cuda(cols, vals, w, bias, labels, b)
        _, lse = fwd()
        dl = lambda: mfx.ell_dlogits_cuda(cols, vals, w, bias, labels, lse,
                                          g, b)
        dlogits, keys = dl()
        order_fn = lambda: mfx.gather_column_order_cuda(keys, vals, d)
        pairs = order_fn()
        dw = lambda: mfx.ell_dw_cuda(*pairs, dlogits, True)
        dw_rows = lambda: mfx.gather_dw_cuda(*pairs, dlogits)
        res = {k: cs.graph_ms(f, iters=10) for k, f in
               (("fwd", fwd), ("dlogits", dl), ("order", order_fn),
                ("dw", dw), ("dw_rows_no_dbias", dw_rows))}
        res["dw_launches_max_diff"] = float((dw()[0] - dw_rows()).abs().max())
        res.update(valid_slots=int((cols < d).sum()),
                   most_pairs_a_feature=_most_pairs(cols, d))
        out[case["label"]] = res
        print(f"{case['label']}: {json.dumps(res)}", flush=True)
    out["selection"] = selection_costs(cs, dev)
    return out


def selection_costs(cs, dev) -> dict:
    """The trained batch's loss forward and backward (to W and the bias)
    through ``ops.mach_fused_xent_csr`` with the selection on (the
    trainer's cached proxy) and off, and the selection's pieces: the
    choice of buckets, and the column gather forward and backward.  CUDA
    events around back-to-back calls, the host's gaps included."""
    from repro_torch.kernels import ops

    case = trained_cases(cs, dev)[1]
    x, w, bias, labels, g = (case[k] for k in
                             ("x", "w", "bias", "labels", "g"))
    p = cs.SELECT
    leaves = [w.clone().requires_grad_(True), bias.clone().requires_grad_(True)]

    def step(select):
        loss = ops.mach_fused_xent_csr(
            x.indptr, x.indices, x.values, leaves[0], labels,
            num_buckets=p["B"], nnz_max=x.nnz_max, bias=leaves[1],
            bucket_select=(p["c_sel"], p["refresh_every"]) if select else None,
            bucket_proxy=case["proxy"] if select else None)
        return torch.autograd.grad((loss * g).sum(), leaves)

    selected = ops.mach_select_buckets(case["proxy"], labels,
                                       num_buckets=p["B"], c_sel=p["c_sel"])

    def gather():
        wsel, bsel, _ = ops._apply_bucket_selection(*leaves, labels, selected,
                                                    p["B"])
        return torch.autograd.grad(wsel.sum() + bsel.sum(), leaves)

    res = {"loss_fwd_bwd_on": cs.kernel_ms(lambda: step(True), iters=10),
           "loss_fwd_bwd_off": cs.kernel_ms(lambda: step(False), iters=10),
           "select_buckets": cs.kernel_ms(lambda: ops.mach_select_buckets(
               case["proxy"], labels, num_buckets=p["B"], c_sel=p["c_sel"]),
               iters=10),
           "column_gather_fwd_bwd": cs.kernel_ms(gather, iters=10)}
    print(f"selection costs (trained batch): {json.dumps(res)}", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--profile", action="store_true",
                    help="also give each launched kernel's device time")
    ap.add_argument("--steps", action="store_true",
                    help="time the 500k cases' steps and the selection instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_ell_xent: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in ("mach_fused_xent_ell", "mach_fused_xent_gather"):
        _build.load(name)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    result = {"src": os.path.relpath(Path(args.src).resolve(), ROOT),
              "device": cs._nvidia_smi()}
    if args.steps:
        result["steps"] = step_times(cs, dev)
        print(json.dumps(result))
        return 0
    for case in ([odp_case(cs, dev)] + select_cases(cs, dev)
                 + trained_cases(cs, dev)):
        result[case["label"]] = run_case(cs, case, dev, args.profile)
        del case
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
