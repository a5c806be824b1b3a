"""End-to-end example: train a ~100M-parameter LM with a MACH head (the
JAX package's ``examples/train_lm.py``).

A scaled tinyllama-family config (~100M params, float32) trains on the
synthetic token stream with checkpoints and restart safety: a run
resumes from the latest checkpoint in ``--ckpt-dir`` when there is one.
The MACH head replaces the full-softmax unembedding: with V=32,000 and
B=512, R=8 the head is 7.8x smaller and the loss is the paper's R-head
hashed cross-entropy.

    python -m repro_torch.examples.train_lm --steps 300          # cuda
    python -m repro_torch.examples.train_lm --device cpu --steps 2 \\
        --seq-len 16 --batch 2
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.mach import MACHConfig
from repro_torch.data import LMDataConfig, SyntheticLMStream
from repro_torch.models import LanguageModel, ModelConfig
from repro_torch.train import StragglerMonitor, TrainConfig, Trainer


def model_config(vocab: int, mach: bool) -> ModelConfig:
    return ModelConfig(
        name="lm100m", family="dense",
        num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
        d_ff=2048, vocab_size=vocab,
        activation="swiglu", norm="rmsnorm",
        mach=MACHConfig(vocab, 512, 8) if mach else None,
        dtype=torch.float32, scan_layers=True, remat="none",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--oaa", action="store_true",
                    help="full-softmax baseline head instead of MACH")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = model_config(args.vocab, mach=not args.oaa)
    model = LanguageModel(cfg)
    head = (f"MACH(B={cfg.mach.num_buckets},R={cfg.mach.num_repetitions})"
            if cfg.mach else "full softmax")
    print(f"model: {cfg.param_count_estimate() / 1e6:.0f}M params, "
          f"head: {head}")
    if cfg.mach:
        full = cfg.d_model * cfg.vocab_size
        machp = cfg.d_model * cfg.mach.num_buckets * cfg.mach.num_repetitions
        print(f"head params: {machp / 1e6:.1f}M vs {full / 1e6:.1f}M "
              f"({full / machp:.1f}x smaller)")

    tcfg = TrainConfig(total_steps=args.steps, warmup_steps=20,
                       peak_lr=3e-4, checkpoint_every=100, log_every=20)
    trainer = Trainer(model, tcfg)
    stream = SyntheticLMStream(LMDataConfig(
        vocab_size=args.vocab, seq_len=args.seq_len,
        global_batch=args.batch), device=device)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    mon = StragglerMonitor()

    # restart-safe: resume from the latest checkpoint if one exists
    template = trainer.init_state(torch.Generator(device=device).manual_seed(0),
                                  device)
    try:
        state, step0 = mgr.restore(template)
        print(f"resumed from checkpoint at step {step0}")
    except FileNotFoundError:
        state = template
    del template

    steps = max(0, args.steps - state.step)
    t0 = time.perf_counter()
    state = trainer.fit(state, stream, steps, manager=mgr, monitor=mon)
    dt = time.perf_counter() - t0
    tok_s = args.batch * args.seq_len * steps / max(dt, 1e-9)
    print(f"\ndone at step {state.step}: {dt:.0f}s  ({tok_s:,.0f} tok/s on "
          f"{device}, the final checkpoint included)  stragglers flagged: "
          f"{len(mon.flagged)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
