"""Quickstart on the port: MACH against the one-vs-all baseline.

Mirrors the JAX package's ``examples/quickstart.py``: trains the paper's
model (R independent B-way logistic regressions over hashed labels) on a
synthetic extreme-classification task with a known Bayes optimum (K=1,024
classes, d=256), decodes with the unbiased estimator (Eq. 2), and
compares it with the one-vs-all softmax (``OAAClassifier``) at several
memory budgets.

    python -m repro_torch.examples.quickstart                  # cuda
    python -m repro_torch.examples.quickstart --device cpu --steps 3
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import MACHConfig, MACHLinear, OAAClassifier
from repro_torch.data.extreme import ExtremeDataConfig, ExtremeDataset
from repro_torch.optim import adamw, apply_updates, value_and_grad

K, D, BS = 1024, 256, 512
CONFIGS = ((32, 4), (64, 4), (64, 8))          # (B, R)


def train(ds, model, params, steps, lr=0.05):
    """``steps`` AdamW steps; returns (params, seconds to the last update)."""
    opt = adamw(lr)
    state = opt.init(params)
    t0 = time.perf_counter()
    for s in range(steps):
        x, y = ds.batch_at(s, BS)
        _, grads = value_and_grad(model.loss, params, x, y)
        upd, state = opt.update(grads, state, params)
        params = apply_updates(params, upd)
    if params["w"].device.type == "cuda":
        torch.cuda.synchronize(params["w"].device)
    return params, time.perf_counter() - t0


def accuracy(ds, predict) -> float:
    accs = []
    for s in range(4):
        x, y = ds.batch_at(5000 + s, BS, "test")
        accs.append(float((predict(x) == y).float().mean()))
    return sum(accs) / len(accs)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ds = ExtremeDataset(ExtremeDataConfig(num_classes=K, dim=D, noise=0.1,
                                          zipf_a=0.0), device=device)
    print(f"[{device.type}] task: K={K} classes, d={D}, Bayes accuracy ≈ "
          f"{ds.bayes_accuracy(steps=2):.3f}\n")

    oaa = OAAClassifier(K, D)
    po, t = train(ds, oaa, oaa.init(_generator(device, 1), device), args.steps)
    acc_o = accuracy(ds, lambda x: oaa.predict(po, x))
    print(f"OAA baseline     params={oaa.param_count():>8,}  "
          f"acc={acc_o:.3f}  ({t:.1f}s)")

    for b, r in CONFIGS:
        cfg = MACHConfig(K, b, r)
        m = MACHLinear(cfg, D)
        pm, t = train(ds, m, m.init(_generator(device, 0), device), args.steps)
        acc = accuracy(ds, lambda x: m.predict(pm, x))
        print(f"MACH B={b:3d} R={r}  params={m.param_count():>8,}  "
              f"acc={acc:.3f}  ({t:.1f}s)  "
              f"size_reduction={oaa.param_count() / m.param_count():.1f}x  "
              f"P(indistinguishable pair)<= {cfg.indistinguishable_bound():.1e}")

    print("\nAt full ODP scale (K=105,033, d=422,713) the same B=32, R=25 "
          "configuration is a 131x model-size reduction (160 GB -> 1.2 GB).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
