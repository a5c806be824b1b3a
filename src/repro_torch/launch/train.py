"""Training entry point — the LM trainer on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch paligemma-3b --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --full --seq-len 4096 \
        --global-batch 2 --steps 6                         # on a GPU

Smoke config unless ``--full``; weights are random, drawn from
``--seed``, and batches come from ``SyntheticLMStream`` (seeded by
``--seed``), with encoder features of ``seq_len // 4`` frames for an
enc-dec model and patch features for a vision model, as in the JAX
driver.  Runs on ``cuda`` unless ``--device`` says otherwise.  The
mesh, multi-pod and checkpoint flags of the JAX driver come with their
slice.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import LMDataConfig, SyntheticLMStream
from repro_torch.models import LanguageModel
from repro_torch.models.frontends import AUDIO_FEATURE_DIM, VISION_FEATURE_DIM
from repro_torch.train import StragglerMonitor, TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default=ARCH_IDS[0])
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(total_steps=args.steps, warmup_steps=2,
                       peak_lr=args.lr, log_every=max(1, min(5, args.steps)))
    trainer = Trainer(LanguageModel(cfg), tcfg)
    state = trainer.init_state(
        torch.Generator(device=device).manual_seed(args.seed), device)
    stream = SyntheticLMStream(
        LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                     global_batch=args.global_batch, seed=args.seed,
                     enc_feats_dim=(AUDIO_FEATURE_DIM if cfg.num_encoder_layers
                                    else 0),
                     enc_len=max(1, args.seq_len // 4),
                     prefix_feats_dim=(VISION_FEATURE_DIM
                                       if cfg.frontend == "vision" else 0),
                     prefix_len=cfg.num_prefix_tokens),
        device=device)
    monitor = StragglerMonitor()
    t0 = time.perf_counter()
    state = trainer.fit(state, stream, args.steps, monitor=monitor)
    dt = time.perf_counter() - t0
    print(f"finished at step {state.step} on {device} in {dt:.2f} s; "
          f"stragglers: {len(monitor.flagged)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
