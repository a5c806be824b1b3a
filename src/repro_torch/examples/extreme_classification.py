"""Paper reproduction on the port: the ODP / ImageNet-21k
experiments at their reduced-scale stand-ins.

Mirrors the JAX package's ``examples/extreme_classification.py``: trains
``MACHLinear`` with AdamW on the synthetic dense centroid task (known
Bayes optimum) and reports accuracy under the three estimators; for the
sparse-feature task (ODP) it also trains the SAME model twice on
identical Zipf-sparse data, once through the materializing dense path
and once through the fused CSR path (``MACHLinear(fused=True)``: no
(n, R·B) logits and no dense (n, d) activation on the GPU), and gates
the two accuracies at |Δ| <= 0.02 (exit code 1 beyond it).

    python -m repro_torch.examples.extreme_classification            # cuda
    python -m repro_torch.examples.extreme_classification --device cpu --steps 3
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.odp_mach import IMAGENET, ODP
from repro_torch.core.mach import MACHLinear
from repro_torch.data.extreme import (ExtremeDataConfig, ExtremeDataset,
                                      SparseExtremeDataset)
from repro_torch.optim import adamw, apply_updates, value_and_grad

GATE = 0.02


def train(ds, model, params, steps=150, bs=512, lr=0.05, format=None):
    opt = adamw(lr)
    state = opt.init(params)
    for s in range(steps):
        x, y = (ds.batch_at(s, bs) if format is None
                else ds.batch_at(s, bs, format=format))
        _, grads = value_and_grad(model.loss, params, x, y)
        upd, state = opt.update(grads, state, params)
        params = apply_updates(params, upd)
    return params


def accuracy(ds, predict, bs=512, format=None):
    accs = []
    for s in range(4):
        x, y = (ds.batch_at(9000 + s, bs, "test") if format is None
                else ds.batch_at(9000 + s, bs, "test", format=format))
        accs.append(float((predict(x) == y).float().mean()))
    return sum(accs) / len(accs)


def _init(model, device):
    gen = torch.Generator(device=device).manual_seed(0)
    return model.init(gen, device=device)


def run_dense(task, steps, device):
    """The paper-style report on the dense centroid stand-in."""
    ds = ExtremeDataset(ExtremeDataConfig(
        num_classes=task.small_classes, dim=task.small_dim, noise=0.1,
        zipf_a=1.0), device=device)
    cfg = task.mach(small=True)
    m = MACHLinear(cfg, task.small_dim)
    t0 = time.perf_counter()
    params = train(ds, m, _init(m, device), steps=steps)
    t = time.perf_counter() - t0
    bayes = ds.bayes_accuracy(steps=2)
    print(f"    reduced-scale stand-in (K={task.small_classes}, "
          f"d={task.small_dim}, B={cfg.num_buckets}, "
          f"R={cfg.num_repetitions}; Zipf classes): "
          f"train {t:.1f}s, Bayes={bayes:.3f}")
    for est in ("unbiased", "min", "median"):
        acc = accuracy(ds, lambda x, e=est: m.predict(params, x, estimator=e))
        marker = "   <- paper Eq. 2" if est == "unbiased" else ""
        print(f"      {est:9s} estimator: acc={acc:.3f}{marker}")


def run_sparse(task, steps, device):
    """Fused-CSR vs materializing-dense training on identical sparse
    data.  Returns |Δ| of the two accuracies."""
    ds = SparseExtremeDataset(task.sparse_data(small=True), device=device)
    cfg = task.mach(small=True)
    print(f"    sparse stand-in (K={ds.cfg.num_classes}, "
          f"d={ds.cfg.num_features}, nnz={ds.cfg.nnz}, B={cfg.num_buckets}, "
          f"R={cfg.num_repetitions}; Zipf features):")
    m_dense = MACHLinear(cfg, ds.cfg.num_features)
    m_fused = MACHLinear(cfg, ds.cfg.num_features, fused=True)
    init = _init(m_dense, device)

    t0 = time.perf_counter()
    p_dense = train(ds, m_dense, init, steps=steps, format="dense")
    t_dense = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_fused = train(ds, m_fused, init, steps=steps, format="csr")
    t_fused = time.perf_counter() - t0

    acc_dense = accuracy(ds, lambda x: m_dense.predict(p_dense, x),
                         format="dense")
    acc_fused = accuracy(ds, lambda x: m_fused.predict(p_fused, x),
                         format="dense")
    delta = abs(acc_dense - acc_fused)
    print(f"      dense materializing path: acc={acc_dense:.3f} "
          f"({t_dense:.1f}s / {steps} steps)")
    print(f"      fused CSR path:           acc={acc_fused:.3f} "
          f"({t_fused:.1f}s / {steps} steps)")
    print(f"      |Δ| = {delta:.3f}  "
          f"{f'OK (<= {GATE})' if delta <= GATE else 'DIVERGED'}")
    return delta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="all",
                    choices=["all", "odp", "imagenet21k"])
    ap.add_argument("--small", action="store_true",
                    help="reduced-scale stand-in (the only mode; kept for "
                         "command lines of the JAX package's example)")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ok = True
    for task in (t for t in (ODP, IMAGENET) if args.task in ("all", t.name)):
        print(f"=== {task.name}: full scale K={task.num_classes:,} "
              f"d={task.dim:,} B={task.mach_b} R={task.mach_r}"
              f"{f' nnz~{task.nnz}' if task.sparse_features else ''} "
              f"[{device}]")
        oaa_gb = task.num_classes * task.dim * 4 / 1e9
        mach_gb = task.mach_b * task.mach_r * task.dim * 4 / 1e9
        print(f"    model size: OAA {oaa_gb:.0f} GB -> MACH {mach_gb:.2f} GB "
              f"({oaa_gb / mach_gb:.0f}x reduction)")
        run_dense(task, args.steps, device)
        if task.sparse_features:
            ok = run_sparse(task, args.steps, device) <= GATE and ok
        print()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
