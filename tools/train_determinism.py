"""Where two training runs of the port part, stage by stage, on the card.

Two copies of one seeded state take the same steps side by side: for
each step the batch is drawn twice, then each copy runs the trainer's
stages (``accumulate_grads`` -> ``clip_by_global_norm`` -> ``opt.update``
-> ``apply_updates``, as ``train.make_train_step`` does) and after each
stage the copies are compared bit for bit, leaf by leaf.  The first
stage and leaf that differ are printed with the largest difference,
then the run goes on to show how far it grows.  Setups, at full width:

* ``odp1024`` / ``odp120``: ``MACHLinear(fused=True)`` at ODP (K=105,033,
  d=422,713, B=32, R=25), AdamW, N=512 on nnz=1,024 (kernel 6) or 120
  (kernel 5) batches, as ``chip_smoke.py``'s phase 16 trains it;
* ``tinyllama``: tinyllama-1.1b (bf16 params) with ``launch/train.py``'s
  ``train_config`` on 2 x 2,048-token batches (kernel 10).

With ``--runs N`` it instead trains N runs of ``--steps`` steps from the
same state through ``Trainer.fit`` and prints, for each pair, the final
states' largest and mean absolute difference over the float leaves:
how far, and how steadily, runs part.

    PYTHONPATH=src python tools/train_determinism.py odp1024 [--steps 4]
    PYTHONPATH=src python tools/train_determinism.py odp120 --runs 4 --steps 7
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (sets the allocator's config first)
import torch  # noqa: E402

from repro_torch.optim import (accumulate_grads, apply_updates,  # noqa: E402
                               clip_by_global_norm)


def _fields(tree):
    """A batch's dataclasses (``SparseBatch``) as dicts of their fields."""
    if dataclasses.is_dataclass(tree):
        return {f.name: _fields(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _fields(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_fields(v) for v in tree)
    return tree


def _diff(a, b) -> list:
    """[(path, largest |a - b|)] over the leaves whose bits differ."""
    return cs._leaf_diffs(_fields(a), _fields(b))


def _clone_state(state):
    from repro_torch.checkpoint import tree_flatten, tree_unflatten
    return tree_unflatten(state, [x.clone() if isinstance(x, torch.Tensor)
                                  else x for _, x in tree_flatten(state)])


def _odp(dev, nnz):
    from repro_torch.configs.odp_mach import ODP
    from repro_torch.core.mach import MACHLinear
    from repro_torch.data.extreme import SparseExtremeDataset
    from repro_torch.train import TrainConfig, Trainer, new_train_state
    head = MACHLinear(ODP.mach(), ODP.dim, fused=True)
    data = SparseExtremeDataset(dataclasses.replace(
        ODP.sparse_data(small=False), nnz=nnz), device=dev)
    tcfg = TrainConfig(schedule="constant", peak_lr=0.05,
                       checkpoint_every=cs.CKPT_ODP_EVERY, log_every=10 ** 9)
    trainer = Trainer(cs._HeadTask(head, None), tcfg)
    state = new_train_state(head.init(
        torch.Generator(device=dev).manual_seed(0), device=dev), trainer.opt)
    stream = cs._Stream(lambda s: data.batch_at(s, cs.N_TRAIN))
    return trainer, tcfg, state, stream


def _tinyllama(dev):
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LanguageModel
    from repro_torch.train import Trainer
    cfg = get_config(cs.CKPT_LM_ARCH)
    tcfg = launch_train.train_config(cs.CKPT_LM_STEPS, 3e-4)
    trainer = Trainer(LanguageModel(cfg), tcfg)
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0), dev)
    stream = launch_train.data_stream(cfg, cs.CKPT_LM_SEQ, cs.CKPT_LM_BATCH,
                                      0, dev)
    return trainer, tcfg, state, stream


def _spread(trainer, state, stream, args) -> int:
    finals = []
    for _ in range(args.runs):
        finals.append(trainer.fit(_clone_state(state), stream, args.steps,
                                  log=None))
    for i in range(args.runs):
        for j in range(i + 1, args.runs):
            same, largest, mean = cs._compare_states(finals[i], finals[j])
            print(f"{args.setup} runs {i} and {j} after {args.steps} steps: "
                  f"the same bits {same}, largest difference {largest:.3e}, "
                  f"mean {mean:.3e}", flush=True)
    print(f"[{cs._nvidia_smi()}]", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("setup", choices=("odp1024", "odp120", "tinyllama"))
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--runs", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_determinism: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs._nvidia_smi(), flush=True)
    trainer, tcfg, state, stream = (
        _tinyllama(dev) if args.setup == "tinyllama"
        else _odp(dev, int(args.setup[3:])))
    if args.runs:
        return _spread(trainer, state, stream, args)
    states = [state, _clone_state(state)]
    opt = trainer.opt
    first = None
    for s in range(args.steps):
        batches = [stream.batch_at(s), stream.batch_at(s)]
        stages = {"batch": _diff(batches[0], batches[1])}
        out = []
        for st, batch in zip(states, batches):
            (loss, _), grads = accumulate_grads(trainer.loss_fn, st.params,
                                                batch, 1)
            clipped, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
            updates, opt_state = opt.update(clipped, st.opt_state, st.params)
            params = apply_updates(st.params, updates)
            out.append({"loss": loss.detach(), "grads": grads,
                        "gnorm": gnorm, "clipped": clipped,
                        "updates": updates, "params": params,
                        "opt_state": opt_state})
        for stage in ("loss", "grads", "gnorm", "clipped", "updates",
                      "params", "opt_state"):
            stages[stage] = _diff(out[0][stage], out[1][stage])
        parted = [(k, v) for k, v in stages.items() if v]
        print(f"step {s + 1}: loss {float(out[0]['loss']):.6f} / "
              f"{float(out[1]['loss']):.6f}; stages that differ: "
              f"{[(k, v[:4]) for k, v in parted] or 'none'}", flush=True)
        if parted and first is None:
            first = (s + 1, parted[0])
        states = [type(st)(st.step + 1, o["params"], o["opt_state"])
                  for st, o in zip(states, out)]
        del out, batches
    print(f"{args.setup}: first difference {first or 'none'} "
          f"in {args.steps} steps [{cs._nvidia_smi()}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
