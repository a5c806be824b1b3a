"""How a training step slices the stacked layer params, timed on the card.

``transformer.apply_stacks`` takes each period's slices of the stacked
params with ``unstack`` (one ``unbind`` a leaf; its backward is one
``stack``).  Taking them with a ``select`` a layer (``v[li]``) computes
the same step, but each select's backward adds a zero-filled copy of
the whole stack to the gradient.  This runs tinyllama-1.1b (MACH head,
bf16 params, AdamW, ``launch/train.py``'s ``train_config``) at 2 x 4,096
tokens through the unsharded ``Trainer`` both ways, from one seed, in
turns (unbind, select, select, unbind), and prints ms a step (host
clock around synchronized steps, the median of each turn's steps after
its first), the steps' peak memory, and whether both ways' losses,
params and moments are the same bits.

    PYTHONPATH=src python tools/time_stack_slicing.py [--steps 4]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (sets the allocator's config first)
import torch  # noqa: E402

from repro_torch.checkpoint import tree_flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import LanguageModel, transformer  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402


def by_select(tree, n: int) -> list:
    return [transformer.tree_map(lambda v: v[i], tree) for i in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
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
    trainer = Trainer(LanguageModel(cfg),
                      launch_train.train_config(args.steps, 3e-4))
    stream = launch_train.data_stream(cfg, 4096, 2, 0, dev)
    unbind = transformer.unstack
    ways = {"unbind": unbind, "select": by_select}
    times = {k: [] for k in ways}
    peaks = {k: 0.0 for k in ways}
    finals = {}
    for way in ("unbind", "select", "select", "unbind"):
        transformer.unstack = ways[way]
        state = trainer.init_state(
            torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, step_ms = [], []
        for s in range(args.steps):
            t0 = time.perf_counter()
            state, met = trainer.step_fn(state, stream.batch_at(s))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
        transformer.unstack = unbind
        times[way] += step_ms[1:]
        peaks[way] = max(peaks[way], torch.cuda.max_memory_allocated(dev)
                         / 2**30)
        print(f"{way}: steps {[round(t, 3) for t in step_ms]} ms, losses "
              f"{losses} [{smi}]", flush=True)
        if way not in finals:
            finals[way] = (losses, [x.cpu() for _, x in tree_flatten(state)
                                    if isinstance(x, torch.Tensor)])
        del state
        torch.cuda.empty_cache()
    same = finals["unbind"][0] == finals["select"][0] and all(
        torch.equal(a, b) for a, b in zip(finals["unbind"][1],
                                          finals["select"][1]))
    for way in ways:
        print(f"{way}: {statistics.median(times[way]):.3f} ms a step "
              f"(median of {len(times[way])}, range {min(times[way]):.3f}-"
              f"{max(times[way]):.3f}), peak {peaks[way]:.2f} GiB [{smi}]",
              flush=True)
    print(f"unbind and select the same bits: {same}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
