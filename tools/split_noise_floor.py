"""How far a decoder split on ``model`` moves two float32 training steps,
beside how far one float32 ulp moves them on one device.

For the smoke tinyllama-1.1b, the same with its MACH head (unfused, and
with the fused loss), recurrentgemma-2b, qwen2-moe-a2.7b and
mixtral-8x22b (float32, ``remat="full"``, at least 4 layers, two AdamW
steps; ``tests/torch_multidevice_ranks.py``'s configs and data), it
prints the share of param entries that end more than 1e-6
of their leaf's largest entry away from the plain single-device run
(the measure of ``test_torch_multidevice.py``'s ``_hold``):
- "one ulp": one device, every block's output moved up by one float32
  ulp (``torch.nextafter``) in the forward and in remat's recompute;
- "split (1, 2)": ``Trainer(mesh=)`` on a CPU ``gloo`` world of two
  ranks, mesh (1, 2), the decoder split by heads and hidden (and the
  MoE configs' experts by expert: 3 of qwen2-moe's 6 a rank, 2 of
  mixtral's 4).
Entries whose two-step update is set by float32 noise (a gradient that
cancels to about Adam's eps once clipped) make up both shares.  No
timing: a CPU run.

    PYTHONPATH=src python tools/split_noise_floor.py
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402

import torch_multidevice_ranks as ranks  # noqa: E402

CASES = ("tinyllama-1.1b", "tinyllama-1.1b MACH", "tinyllama-1.1b MACH fused",
         "recurrentgemma-2b", "qwen2-moe-a2.7b", "mixtral-8x22b")


def _config(case):
    if "MACH" in case:
        return ranks.mach_model_config(
            mach_fused_loss=case.endswith("fused"))
    return ranks.model_config(case)


def _off_share(got, want) -> tuple[int, int]:
    from repro_torch.checkpoint import tree_flatten
    off = total = 0
    for (_, g), (_, w) in zip(tree_flatten(got), tree_flatten(want)):
        err = (g.float() - w.float()).abs()
        off += int((err > 1e-6 * float(w.float().abs().max())).sum())
        total += err.numel()
    return off, total


def one_ulp(case) -> tuple[int, int]:
    """(entries off, entries) of one device with every block's output
    one ulp up, against one device."""
    from repro_torch.models import LanguageModel, transformer
    from repro_torch.train import Trainer
    cfg = _config(case)
    data = ranks.batches(cfg, 2)

    def run():
        trainer = Trainer(LanguageModel(cfg), ranks.train_config())
        state = trainer.init_state(torch.Generator().manual_seed(0), "cpu")
        for b in data:
            state, _ = trainer.step_fn(state, b)
        return state.params

    want = run()
    block = transformer.apply_block

    def moved(*args, **kw):
        x, cache, aux = block(*args, **kw)
        return torch.nextafter(x, torch.full_like(x, float("inf"))), cache, aux

    transformer.apply_block = moved
    try:
        got = run()
    finally:
        transformer.apply_block = block
    return _off_share(got, want)


def split_shares(rank, directory):
    mesh = ranks._mesh((1, 2))
    out = []
    for case in CASES:
        cfg = _config(case)
        res = ranks.sharded_vs_one_device(cfg, ranks.train_config(), mesh,
                                          ranks.batches(cfg, 2))
        out.append(_off_share(res["params"], res["want"]))
    return out


ranks.RANK_FNS["split_noise_floor"] = split_shares


def main() -> int:
    torch.set_num_threads(ranks.THREADS)
    with tempfile.TemporaryDirectory() as directory:
        split = ranks.spawn_world(2, "split_noise_floor", directory, 600)
    for case, (s_off, total) in zip(CASES, split):
        u_off, _ = one_ulp(case)
        print(f"{case}: of {total:,} param entries after two steps, "
              f"{u_off} ({u_off / total:.4%}) one ulp moves, {s_off} "
              f"({s_off / total:.4%}) the split on (1, 2) moves past 1e-6 "
              f"of their leaf's largest entry", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
