"""Training entry point — the LM trainer on one device or over a mesh,
with checkpoint-restart.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch paligemma-3b --steps 4 --ckpt-dir /tmp/paligemma_ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --full --seq-len 4096 \\
        --global-batch 2 --steps 6                         # on a GPU
    PYTHONPATH=src torchrun --standalone --nproc_per_node 2 \\
        -m repro_torch.launch.train --local-mesh --device cpu --steps 4
    PYTHONPATH=src torchrun --standalone --nproc_per_node 8 \\
        -m repro_torch.launch.train --local-mesh --full --seq-len 4096 \\
        --global-batch 8                                   # 8 GPUs

Smoke config unless ``--full``; weights are random, drawn from
``--seed``, and batches come from ``SyntheticLMStream`` (seeded by
``--seed``), with encoder features of ``seq_len // 4`` frames for an
enc-dec model and patch features for a vision model, as in the JAX
package's ``launch/train.py``.  Runs on ``cuda`` unless ``--device``
says otherwise.

As in the JAX package, the run goes through ``run_with_restarts``: it
resumes from the latest checkpoint in ``--ckpt-dir`` (keep 2), saves
without blocking every ``max(5, steps // 4)`` steps and blocking at the
end, and flags straggler steps.

``--local`` trains over a (world, 1) ``("data", "model")`` mesh of the
launched world, ``--multi-pod`` over the (2, 16, 16) production mesh,
and a launched world without either over the (16, 16) one (both need
exactly that many ranks), all with the JAX entry point's rules
(``ShardingRules(fsdp=True, sp=False)``): the state sharded FSDP-style,
every rank on its rows of the same global batches (``Trainer(mesh=)``).
The world comes from ``torchrun``'s environment (NCCL on ``cuda``, each
rank on device ``LOCAL_RANK``; gloo on the CPU), or from a process group
the caller has set up; ``--local`` with neither runs a world of one.
Without a flag and a launched world it is the single-device run.  Rank 0
prints.  ``--local-mesh`` is ``--local``: under Python 3.12.3's
``argparse`` torchrun's own parser refuses a ``--local`` after ``-m
<module>`` as an ambiguous abbreviation of its ``--local-addr``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import LMDataConfig, SyntheticLMStream
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import LanguageModel
from repro_torch.models.frontends import AUDIO_FEATURE_DIM, VISION_FEATURE_DIM
from repro_torch.sharding import ShardingRules, activate
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


@contextlib.contextmanager
def process_group(device: torch.device):
    """The launched world's default process group for the block: one the
    caller set up, else ``torchrun``'s (``RANK``, ``WORLD_SIZE``, ...;
    NCCL on ``cuda`` with this rank on ``LOCAL_RANK``, else gloo), else a
    world of one on a file store.  One it opened is closed on exit."""
    if dist.is_initialized():
        yield
        return
    kw = {"backend": "gloo"}
    if device.type == "cuda":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        kw = {"backend": "nccl", "device_id": local}
    with tempfile.TemporaryDirectory() as tmp:
        if "RANK" in os.environ:
            dist.init_process_group(**kw)
        else:
            dist.init_process_group(
                init_method=f"file://{os.path.join(tmp, 'store')}", rank=0,
                world_size=1, **kw)
        try:
            yield
        finally:
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--local", "--local-mesh", action="store_true",
                    help="a mesh over the launched world in place of the "
                         "production mesh (--local-mesh: the spelling "
                         "for torchrun's command line)")
    ap.add_argument("--multi-pod", action="store_true")
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
    if not (args.local or args.multi_pod or "RANK" in os.environ):
        return _train(args, device, None)
    with process_group(device):
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = (make_local_mesh(device=device) if args.local else
                make_production_mesh(multi_pod=args.multi_pod, device=device))
        return _train(args, device, mesh)


def _train(args, device: torch.device, mesh) -> int:
    cfg = get_config(args.arch, smoke=args.smoke)
    rules = ShardingRules(fsdp=True, sp=False)
    trainer = Trainer(LanguageModel(cfg), train_config(args.steps, args.lr),
                      mesh=mesh, rules=rules)
    stream = data_stream(cfg, args.seq_len, args.global_batch, args.seed,
                         device)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    monitor = StragglerMonitor()
    log = print if mesh is None or dist.get_rank() == 0 else None

    def init_state():
        return trainer.init_state(
            torch.Generator(device=device).manual_seed(args.seed), device)

    def train_once(state, remaining):
        return trainer.fit(state, stream, remaining, manager=mgr,
                           monitor=monitor, log=log)

    t0 = time.perf_counter()
    with (activate(mesh, rules) if mesh is not None
          else contextlib.nullcontext()):
        state = run_with_restarts(train_once, init_state, mgr, args.steps,
                                  log=log)
    dt = time.perf_counter() - t0
    if log:
        where = (f"{device}" if mesh is None else
                 f"{device} x {mesh.size()}, mesh "
                 f"{tuple(mesh.shape)} {mesh.mesh_dim_names}")
        log(f"finished at step {state.step} on {where} in {dt:.2f} s; "
            f"stragglers: {len(monitor.flagged)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
