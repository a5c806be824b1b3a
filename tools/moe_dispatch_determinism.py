"""Whether the MoE dispatch's backward gives the same bits run to run on
the card, by the two ways of computing it, at qwen2-moe-a2.7b's widths.

One MoE block (d 2,048, 60 experts, top-4, groups of 512, bf16) routes
2 x 4,096 random tokens; the dispatch (each expert row's token gathered
into the (G, E·cap, d) expert input) is differentiated twice against
the same upstream gradient:
- "gather": autograd of ``torch.gather``, whose backward scatter-adds
  the expert rows onto the tokens (float atomics on the card);
- "dispatch": ``moe._Dispatch``, whose backward gathers each token's
  kept rows and sums them over its choices.
It prints, for each, whether the two runs' token gradients are the same
bits and their largest difference; then the whole block
(``moe.apply_moe``) forward and backward twice, every gradient compared.
Needs a GPU:

    PYTHONPATH=src python tools/moe_dispatch_determinism.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import tree_map  # noqa: E402


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = get_config("qwen2-moe-a2.7b")
    e, d, group = cfg.num_experts, cfg.d_model, cfg.moe_group_size
    gen = torch.Generator(device=dev).manual_seed(3)
    params = tree_map(lambda t: t.to(torch.bfloat16), moe.init_moe(
        gen, d, cfg.moe_d_ff, e, cfg.num_shared_experts, cfg.shared_d_ff,
        dev, cfg.activation))
    x = torch.randn((2, 4096, d), generator=gen, device=dev).to(torch.bfloat16)
    r = moe.route(params, x, num_experts=e, top_k=cfg.experts_top_k,
                  capacity_factor=cfg.capacity_factor, group_size=group)
    xg, _ = moe._group(x, group)
    g, s, _ = xg.shape
    cap = r.cap
    row = r.experts * cap + r.slot.clamp(max=cap - 1)
    owner = torch.full((g, e * cap + 1), s, dtype=torch.long, device=dev)
    owner.scatter_(1, torch.where(r.keep, row, e * cap).reshape(g, -1),
                   torch.arange(s, device=dev)[None, :, None]
                   .expand_as(row).reshape(g, -1))
    up = torch.randn((g, e * cap, d), generator=gen,
                     device=dev).to(torch.bfloat16)

    def gather_grad():
        xa = xg.detach().clone().requires_grad_(True)
        xz = torch.cat([xa, xa.new_zeros((g, 1, d))], 1)
        out = torch.gather(xz, 1, owner[:, :-1, None].expand(-1, -1, d))
        return torch.autograd.grad(out, xa, up)[0]

    def dispatch_grad():
        xa = xg.detach().clone().requires_grad_(True)
        out = moe._Dispatch.apply(xa, owner[:, :-1], row, r.keep)
        return torch.autograd.grad(out, xa, up)[0]

    print(f"qwen2-moe-a2.7b block: {g} groups of {s}, cap {cap}, top-"
          f"{cfg.experts_top_k}, bf16 [{smi}]", flush=True)
    for name, fn in (("gather", gather_grad), ("dispatch", dispatch_grad)):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        diff = float((a.float() - b.float()).abs().max())
        differ = int((a != b).sum())
        print(f"{name}: two runs' token gradients "
              f"{'the same bits' if differ == 0 else 'differ'} ({differ} of "
              f"{a.numel():,} entries, largest difference {diff:.3e})",
              flush=True)

    kw = dict(num_experts=e, top_k=cfg.experts_top_k,
              activation=cfg.activation,
              capacity_factor=cfg.capacity_factor, group_size=group)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)

    def block():
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     params)
        xa = x.detach().clone().requires_grad_(True)
        y, _ = moe.apply_moe(p, xa, **kw)
        return torch.autograd.grad(y, [xa] + _leaves(p), dy)

    first, second = block(), block()
    torch.cuda.synchronize()
    same = sum(torch.equal(a, b) for a, b in zip(first, second))
    print(f"apply_moe: of {len(first)} gradients (x and each param), {same} "
          f"the same bits in two runs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
