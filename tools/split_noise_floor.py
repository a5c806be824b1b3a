"""How far a decoder split on ``model`` moves two float32 training steps,
beside how far one float32 ulp moves them on one device.

For the smoke configs of ``tests/torch_multidevice_ranks.py`` (float32,
``remat="full"``, at least 4 layers, two AdamW steps, its data) on the
meshes the tests split them on — tinyllama-1.1b, the same with its MACH
head (unfused, and with the fused loss), recurrentgemma-2b, qwen2-moe-a2.7b,
mixtral-8x22b and seamless-m4t-large-v2 on (1, 2); recurrentgemma-2b,
seamless-m4t-large-v2, paligemma-3b, granite-20b, phi3-mini-3.8b and
mistral-large-123b on (1, 4) — it prints the share of param entries
that end more than 1e-6 of their leaf's largest entry away from the
plain single-device run (the measure of ``test_torch_multidevice.py``'s
``_hold``):
- "one ulp": one device, every block's output, every RG-LRU block's
  output and every cross-attention's output moved up by one float32 ulp
  (``torch.nextafter``) in the forward and in remat's recompute: where
  a split sums partial outputs over its ranks;
- "split (1, n)": ``Trainer(mesh=)`` on a CPU ``gloo`` world of n ranks,
  mesh (1, n), the decoder split by heads, hidden and channels, the MoE
  configs' experts by expert, the MACH head by repetition.
Entries whose two-step update is set by float32 noise (a gradient that
cancels to about Adam's eps once clipped) make up every share, so which
entries cross, and how many, moves with any change of summation order
(the BLAS threads too: the ranks' ``THREADS`` here, as in the tests).

``--parts`` adds seamless-m4t-large-v2 on (1, 4) with one part of its
decoder split at a time (``partitioning.block_split``'s fields; the MACH
head splits by repetition in each): none, the self-attention, the MLP,
the cross-attention, all.  No timing: a CPU run.

    PYTHONPATH=src python tools/split_noise_floor.py [--parts]
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402

import torch_multidevice_ranks as ranks  # noqa: E402

CASES = {2: ("tinyllama-1.1b", "tinyllama-1.1b MACH",
             "tinyllama-1.1b MACH fused", "recurrentgemma-2b",
             "qwen2-moe-a2.7b", "mixtral-8x22b", "seamless-m4t-large-v2"),
         4: ("recurrentgemma-2b", "seamless-m4t-large-v2", "paligemma-3b",
             "granite-20b", "phi3-mini-3.8b", "mistral-large-123b")}
# BlockSplit fields each ``--parts`` run keeps (the rest run whole)
PARTS = {"none": (), "self-attention": ("attn", "kv"), "MLP": ("mlp",),
         "cross-attention": ("xattn", "xkv"),
         "all": ("attn", "kv", "mlp", "xattn", "xkv")}
PARTS_ARCH = "seamless-m4t-large-v2"


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


def _up(x):
    return torch.nextafter(x, torch.full_like(x, float("inf")))


def one_ulp(case) -> tuple[int, int]:
    """(entries off, entries) of one device with every block's, RG-LRU
    block's and cross-attention's output one ulp up, against one
    device."""
    from repro_torch.models import LanguageModel, recurrent, transformer
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
    saved = (transformer.apply_block, recurrent.apply_rglru_block,
             transformer._cross_attention)
    block, rglru, cross = saved

    def moved_block(*args, **kw):
        x, cache, aux = block(*args, **kw)
        return _up(x), cache, aux

    def moved_rglru(*args, **kw):
        y, state = rglru(*args, **kw)
        return _up(y), state

    transformer.apply_block = moved_block
    recurrent.apply_rglru_block = moved_rglru
    transformer._cross_attention = lambda *a, **kw: _up(cross(*a, **kw))
    try:
        got = run()
    finally:
        (transformer.apply_block, recurrent.apply_rglru_block,
         transformer._cross_attention) = saved
    return _off_share(got, want)


def split_shares(rank, directory):
    n = torch.distributed.get_world_size()
    mesh = ranks._mesh((1, n))
    out = []
    for case in CASES[n]:
        cfg = _config(case)
        res = ranks.sharded_vs_one_device(cfg, ranks.train_config(), mesh,
                                          ranks.batches(cfg, 2))
        out.append(_off_share(res["params"], res["want"]))
    return out


def part_shares(rank, directory):
    """``PARTS_ARCH`` on (1, 4), each ``PARTS`` entry's fields of every
    block's split kept, the rest set to None (the same in
    ``apply_stacks`` and ``enc_kvs``, which both call ``block_split``)."""
    from repro_torch.sharding import partitioning
    mesh = ranks._mesh((1, 4))
    cfg = _config(PARTS_ARCH)
    plan = partitioning.block_split
    out = []
    for keep in PARTS.values():
        def block_split(params, keep=keep):
            split = plan(params)
            if split is None:
                return None
            return dataclasses.replace(split, **{
                f: None for f in ("attn", "kv", "mlp", "xattn", "xkv")
                if f not in keep})
        partitioning.block_split = block_split
        try:
            res = ranks.sharded_vs_one_device(cfg, ranks.train_config(),
                                              mesh, ranks.batches(cfg, 2))
        finally:
            partitioning.block_split = plan
        out.append(_off_share(res["params"], res["want"]))
    return out


for _n in CASES:                # a world of each size, a store each
    ranks.RANK_FNS[f"split_noise_floor{_n}"] = split_shares
ranks.RANK_FNS["split_noise_parts"] = part_shares


def main() -> int:
    torch.set_num_threads(ranks.THREADS)
    with tempfile.TemporaryDirectory() as directory:
        split = {n: ranks.spawn_world(n, f"split_noise_floor{n}",
                                      directory, 900) for n in CASES}
        parts = (ranks.spawn_world(4, "split_noise_parts", directory, 900)
                 if "--parts" in sys.argv[1:] else None)
    floors = {}
    for n, cases in CASES.items():
        for case, (s_off, total) in zip(cases, split[n]):
            if case not in floors:
                floors[case] = one_ulp(case)[0]
            u_off = floors[case]
            print(f"{case} on (1, {n}): of {total:,} param entries after "
                  f"two steps, past 1e-6 of their leaf's largest entry: "
                  f"one ulp {u_off} ({u_off / total:.4%}), the split "
                  f"{s_off} ({s_off / total:.4%})", flush=True)
    if parts is not None:
        print(f"{PARTS_ARCH} on (1, 4), the split of one part at a time "
              f"(the MACH head by repetition in each): " + ", ".join(
                  f"{name} {off} ({off / total:.4%})"
                  for name, (off, total) in zip(PARTS, parts)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
