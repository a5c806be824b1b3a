"""Bytes a sharded train step holds gathered, on CPU ``gloo`` worlds.

Spawns worlds of 2 and 4 processes (``tests/torch_multidevice_ranks.py``)
and trains the smoke tinyllama-1.1b (float32, ``remat="full"``, 4
layers) two steps through ``Trainer(mesh=)`` on meshes (2, 1), (4, 1)
and (2, 2), with one and two microbatches, beside the single-device
``Trainer``.  For each run it prints the most bytes of whole tensors
that ``partitioning.materialize`` had alive at once (``GatherCount``:
until their storage is freed), the bound the tests hold it to (the
leaves outside the layer stacks plus two periods), the whole tree, and
how many leaves were gathered.  No timing: a CPU run.

    PYTHONPATH=src python tools/fsdp_gathered_bytes.py
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import torch_multidevice_ranks as ranks  # noqa: E402

CASES = {2: [("(2, 1)", (2, 1), 1), ("(2, 1)", (2, 1), 2)],
         4: [("(4, 1)", (4, 1), 1), ("(4, 1)", (4, 1), 2),
             ("(2, 2)", (2, 2), 1)]}


def counts(rank, directory):
    world = ranks.dist.get_world_size()
    cfg = ranks.model_config("tinyllama-1.1b")
    out = []
    for name, shape, micro in CASES[world]:
        res = ranks.sharded_vs_one_device(
            cfg, ranks.train_config(num_microbatches=micro),
            ranks._mesh(shape), ranks.batches(cfg, 2, global_batch=8))
        out.append((name, micro, res["gathered"]))
    return out


ranks.RANK_FNS["gathered_bytes"] = counts


def main() -> int:
    for world in (2, 4):
        with tempfile.TemporaryDirectory() as directory:    # a fresh store
            for name, micro, g in ranks.spawn_world(
                    world, "gathered_bytes", directory, 600):
                print(f"world {world}, mesh {name}, {micro} microbatch(es): "
                      f"peak {g['peak']:,} bytes alive at once, bound "
                      f"{g['bound']:,} (outside the stacks {g['rest']:,} + "
                      f"2 x period {g['period']:,}), whole tree "
                      f"{g['whole']:,}; {g['calls']} leaves gathered",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
