"""Training entry point — the LM trainer on one device, with
checkpoint-restart.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paligemma-3b --steps 4 --ckpt-dir /tmp/paligemma_ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --full --seq-len 4096 \\
        --global-batch 2 --steps 6                         # on a GPU

Smoke config unless ``--full``; weights are random, drawn from
``--seed``, and batches come from ``SyntheticLMStream`` (seeded by
``--seed``), with encoder features of ``seq_len // 4`` frames for an
enc-dec model and patch features for a vision model, as in the JAX
package's ``launch/train.py``.  Runs on ``cuda`` unless ``--device``
says otherwise.

As in the JAX package, the run goes through ``run_with_restarts``: it
resumes from the latest checkpoint in ``--ckpt-dir`` (keep 2), saves
without blocking every ``max(5, steps // 4)`` steps and blocking at the
end, and flags straggler steps.  The JAX entry point's mesh and
multi-pod flags wait for multi-device (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import LMDataConfig, SyntheticLMStream
from repro_torch.models import LanguageModel
from repro_torch.models.frontends import AUDIO_FEATURE_DIM, VISION_FEATURE_DIM
from repro_torch.train import (StragglerMonitor, TrainConfig, Trainer,
                               run_with_restarts)


def train_config(steps: int, lr: float) -> TrainConfig:
    """The entry point's schedule: warmup 2, a checkpoint every
    ``max(5, steps // 4)`` steps."""
    return TrainConfig(total_steps=steps, warmup_steps=2, peak_lr=lr,
                       checkpoint_every=max(5, steps // 4),
                       log_every=max(1, min(5, steps)))


def data_stream(cfg, seq_len: int, global_batch: int, seed: int,
                device) -> SyntheticLMStream:
    """The entry point's batches for model config ``cfg``."""
    return SyntheticLMStream(
        LMDataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                     global_batch=global_batch, seed=seed,
                     enc_feats_dim=(AUDIO_FEATURE_DIM if cfg.num_encoder_layers
                                    else 0),
                     enc_len=max(1, seq_len // 4),
                     prefix_feats_dim=(VISION_FEATURE_DIM
                                       if cfg.frontend == "vision" else 0),
                     prefix_len=cfg.num_prefix_tokens),
        device=device)


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
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_pod_ckpt"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    trainer = Trainer(LanguageModel(cfg), train_config(args.steps, args.lr))
    stream = data_stream(cfg, args.seq_len, args.global_batch, args.seed,
                         device)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    monitor = StragglerMonitor()

    def init_state():
        return trainer.init_state(
            torch.Generator(device=device).manual_seed(args.seed), device)

    def train_once(state, remaining):
        return trainer.fit(state, stream, remaining, manager=mgr,
                           monitor=monitor)

    t0 = time.perf_counter()
    state = run_with_restarts(train_once, init_state, mgr, args.steps)
    dt = time.perf_counter() - t0
    print(f"finished at step {state.step} on {device} in {dt:.2f} s; "
          f"stragglers: {len(monitor.flagged)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
