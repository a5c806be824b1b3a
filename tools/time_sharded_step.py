"""The sharded train step against the unsharded one on the card, in turns.

tinyllama-1.1b (MACH head, bf16 params, AdamW, ``launch/train.py``'s
``train_config``) at 2 x 4,096 tokens, as ``chip_smoke.py``'s phase 17
runs it: the unsharded ``Trainer`` and ``Trainer(mesh=)`` on an NCCL
world of one ((1, 1) mesh, FSDP rules, each param gathered where the
model uses it), both states alive, stepped in rounds of ``--steps``
steps in the order unsharded, sharded, sharded, unsharded, ... for
``--pairs`` pairs.  Prints each round's ms a step (host clock around
synchronized steps) and, over all rounds but the first of each, the
medians and the sharded step's difference; and whether the two runs'
losses agree step for step.

    PYTHONPATH=src python tools/time_sharded_step.py [--steps 5] [--pairs 3]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (sets the allocator's config first)
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import LanguageModel  # noqa: E402
from repro_torch.sharding import ShardingRules  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs._nvidia_smi()
    from repro_torch.kernels import _build
    _build.build_all()
    cfg = get_config("tinyllama-1.1b", mach="on")
    total = 2 * args.pairs * args.steps
    tcfg = launch_train.train_config(total, 3e-4)
    model = LanguageModel(cfg)
    stream = launch_train.data_stream(cfg, 4096, 2, 0, dev)
    with tempfile.TemporaryDirectory(prefix="time_sharded_") as root:
        dist.init_process_group("nccl", init_method=f"file://{root}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            trainers = {
                "unsharded": Trainer(model, tcfg),
                "sharded": Trainer(model, tcfg, mesh=mesh,
                                   rules=ShardingRules(fsdp=True, sp=False))}
            states = {k: t.init_state(
                torch.Generator(device=dev).manual_seed(0), dev)
                for k, t in trainers.items()}
            steps = {k: 0 for k in trainers}
            losses = {k: [] for k in trainers}
            times = {k: [] for k in trainers}
            order = []
            for _ in range(args.pairs):
                order += ["unsharded", "sharded"]
                order += ["sharded", "unsharded"]
            order = order[:2 * args.pairs]
            for r, way in enumerate(order):
                step_ms = []
                for _ in range(args.steps):
                    batch = stream.batch_at(steps[way])
                    t0 = time.perf_counter()
                    states[way], met = trainers[way].step_fn(states[way],
                                                             batch)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    losses[way].append(float(met["loss"]))
                    steps[way] += 1
                if r >= 2:                   # each side's first round warms
                    times[way] += step_ms
                print(f"round {r}: {way} {[round(t, 3) for t in step_ms]} "
                      f"ms [{smi}]", flush=True)
        finally:
            dist.destroy_process_group()
    un, sh = (statistics.median(times[k]) for k in ("unsharded", "sharded"))
    print(f"unsharded {un:.3f} ms a step, sharded {sh:.3f} "
          f"({sh / un - 1:+.2%}); medians of {len(times['sharded'])} steps "
          f"each after the first round of each [{smi}]", flush=True)
    same = losses["unsharded"] == losses["sharded"]
    print(f"losses step for step equal: {same}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
